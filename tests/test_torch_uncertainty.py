"""Registration uncertainty in the port against ``fpcr_tpu`` on the same
numpy inputs (CPU): ``registration_covariance`` for the point and plane
models (the brute and the Morton matcher, trimmed and weighted as the
loop), a given sensor variance, and ``information_from_covariance`` with and
without the adjoint transport of a far-from-identity edge."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fpcr_tpu as f
import fpcr_tpu_torch as ft

torch.set_num_threads(2)


def _t(a):
    return torch.as_tensor(np.array(a))


def _case(seed=0):
    """A noisy saddle patch and its target, with the GT transform."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-2, 2, (600, 2))
    src = np.stack([xy[:, 0], xy[:, 1],
                    0.25 * (xy[:, 0] ** 2 - xy[:, 1] ** 2)], 1)
    gt = f.gt_transform((0.1, -0.2, 0.05), (0.05, -0.1, 0.2))
    tgt = np.array(gt.apply(jnp.asarray(src, jnp.float32)))
    tgt = tgt + rng.normal(0, 2e-3, tgt.shape)
    return (src.astype(np.float32), tgt.astype(np.float32),
            np.array(gt.rotation), np.array(gt.translation))


COV_RUNS = {
    "point": dict(),
    "point-auto-trim": dict(auto_trim=9.0, exact_distances=True),
    "plane": dict(metric="plane"),
    # the band's expansion-form distances round ~1e-6 apart in the two
    # packages, as large as these 2e-3-noise residuals' squares, so the
    # default auto-trim gate would cut its edge rows apart: off (0.0) here,
    # the sort and pairing of the Morton path under test
    "morton": dict(matcher="morton", morton_impl="xla", morton_chunk=128,
                   morton_window=256, auto_trim=0.0),
    "huber-sigma2": dict(robust_loss="huber", exact_distances=True),
}


@pytest.mark.parametrize("key", list(COV_RUNS))
def test_registration_covariance_matches_jax(key):
    """The 6x6 covariance at the GT pose within 1e-4 relative of JAX's
    (sums over 600 points, f32), symmetric; the plane model takes JAX's
    normals; ``sigma2`` replaces the measured variance."""
    kw = COV_RUNS[key]
    src, tgt, R, t = _case()
    extra = {}
    if kw.get("metric") == "plane":
        extra["target_normals"] = np.array(f.estimate_normals(
            jnp.asarray(tgt)))
    sigma2 = 1e-6 if key == "huber-sigma2" else None
    j = f.registration_covariance(
        jnp.asarray(src), jnp.asarray(tgt),
        f.RigidTransform(jnp.asarray(R), jnp.asarray(t)), f.ICPConfig(**kw),
        sigma2=sigma2, **{k: jnp.asarray(v) for k, v in extra.items()})
    c = ft.registration_covariance(
        _t(src), _t(tgt), ft.RigidTransform(_t(R), _t(t)),
        ft.ICPConfig(**kw), sigma2=sigma2,
        **{k: _t(v) for k, v in extra.items()})
    j = np.asarray(j)
    assert c.shape == (6, 6) and torch.equal(c, c.T)
    np.testing.assert_allclose(c.numpy(), j, rtol=1e-4,
                               atol=1e-4 * np.abs(j).max())
    assert (torch.linalg.eigvalsh(c.double()) > 0).all()


@pytest.mark.parametrize("far", [False, True])
def test_information_from_covariance_matches_jax(far):
    """The [θ, t] → [ρ, w] permutation, the Ad(Ẑ⁻¹) transport of a 2.5-rad
    edge (or none), the relative floor and the inverse, within 1e-4
    relative of JAX's."""
    src, tgt, R, t = _case(1)
    cov = np.asarray(f.registration_covariance(
        jnp.asarray(src), jnp.asarray(tgt),
        f.RigidTransform(jnp.asarray(R), jnp.asarray(t))))
    tf = None
    if far:
        g = f.gt_transform((0.5, -1.0, 0.3), (2.5, 0.3, -0.4))
        tf = (np.array(g.rotation), np.array(g.translation))
    j = np.asarray(f.information_from_covariance(
        jnp.asarray(cov), None if tf is None else f.RigidTransform(
            jnp.asarray(tf[0]), jnp.asarray(tf[1]))))
    info = ft.information_from_covariance(
        _t(cov), None if tf is None else ft.RigidTransform(_t(tf[0]),
                                                           _t(tf[1])))
    np.testing.assert_allclose(info.numpy(), j, rtol=1e-4,
                               atol=1e-4 * np.abs(j).max())
