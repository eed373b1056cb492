"""The port's point-to-plane solve and the plane and symmetric ICP loops
against ``fpcr_tpu`` on the same numpy inputs (CPU; the brute matcher runs
its plain version here)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fpcr_tpu as f
import fpcr_tpu_torch as ft
from fpcr_tpu.ops import solve as jsolve
from fpcr_tpu_torch.interop import points_from_numpy
from fpcr_tpu_torch.ops import solve as tsolve

torch.set_num_threads(2)

GAP = 1e-5  # transform RMSE between the two packages' results


def _plane_inputs(seed=0, n=600):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    q = (p + rng.normal(scale=0.01, size=p.shape)).astype(np.float32)
    nrm = rng.normal(size=(n, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(
        np.float32)
    w = rng.uniform(size=n).astype(np.float32)
    return p, q, nrm, w


@pytest.mark.parametrize("mask", ["none", "bool", "float"])
def test_plane_normal_equations_match_jax(mask):
    p, q, nrm, w = _plane_inputs()
    m = {"none": None, "bool": w > 0.3, "float": w}[mask]
    jC, jb = jsolve.plane_normal_equations(
        jnp.asarray(p), jnp.asarray(q), jnp.asarray(nrm),
        None if m is None else jnp.asarray(m))
    tC, tb = tsolve.plane_normal_equations(
        torch.as_tensor(p), torch.as_tensor(q), torch.as_tensor(nrm),
        None if m is None else torch.as_tensor(m))
    # float32 sums of 600 terms in two orders: ~1e-6 of the entries' scale
    np.testing.assert_allclose(tC.numpy(), np.asarray(jC), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5,
                               atol=1e-5)


def test_plane_solve_update_matches_jax():
    p, q, nrm, _ = _plane_inputs(1)
    jC, jb = jsolve.plane_normal_equations(jnp.asarray(p), jnp.asarray(q),
                                           jnp.asarray(nrm))
    C, b = np.array(jC), np.array(jb)
    for damping in (0.0, 0.5):
        jt, jx = jsolve.plane_solve_update(jnp.asarray(C), jnp.asarray(b),
                                           damping)
        tt, tx = tsolve.plane_solve_update(torch.as_tensor(C),
                                           torch.as_tensor(b), damping)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-4,
                                   atol=1e-7)
        np.testing.assert_allclose(tt.rotation.numpy(),
                                   np.asarray(jt.rotation), atol=1e-6)
        np.testing.assert_allclose(tt.translation.numpy(),
                                   np.asarray(jt.translation), atol=1e-7)
    # the float64 solution of the same floored system
    x64 = np.linalg.solve(C.astype(np.float64) + 1e-7 * np.trace(C) / 6
                          * np.eye(6), b.astype(np.float64))
    _, x = tsolve.plane_solve_update(torch.as_tensor(C), torch.as_tensor(b))
    np.testing.assert_allclose(x.numpy(), x64, rtol=1e-3, atol=1e-7)


@pytest.mark.parametrize("C", ["zero", "nan", "indefinite"])
def test_plane_solve_guards_give_the_identity(C):
    """An empty inlier set (C = 0), a non-finite C or one the factorization
    refuses give x = 0 (the identity update), with no host sync or raise."""
    mat = {"zero": np.zeros((6, 6)), "nan": np.full((6, 6), np.nan),
           "indefinite": -np.eye(6)}[C].astype(np.float32)
    b = np.ones(6, np.float32)
    tt, tx = tsolve.plane_solve_update(torch.as_tensor(mat),
                                       torch.as_tensor(b))
    assert torch.isfinite(tx).all()
    if C != "zero":  # C = 0 plus the floor solves to a finite x, as in JAX
        assert (tx == 0).all()
        np.testing.assert_array_equal(tt.rotation.numpy(), np.eye(3))
    jt, jx = jsolve.plane_solve_update(jnp.asarray(mat), jnp.asarray(b))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5)


def test_point_to_plane_transform_matches_jax():
    p, q, nrm, w = _plane_inputs(2)
    jt = jsolve.point_to_plane_transform(jnp.asarray(p), jnp.asarray(q),
                                         jnp.asarray(nrm), jnp.asarray(w),
                                         damping=0.1)
    tt = ft.point_to_plane_transform(torch.as_tensor(p), torch.as_tensor(q),
                                     torch.as_tensor(nrm),
                                     torch.as_tensor(w), damping=0.1)
    np.testing.assert_allclose(tt.rotation.numpy(), np.asarray(jt.rotation),
                               atol=1e-6)
    np.testing.assert_allclose(tt.translation.numpy(),
                               np.asarray(jt.translation), atol=1e-6)


def _rmse_between(Ra, ta, Rb, tb, probe):
    d = (probe @ Ra.T + ta) - (probe @ Rb.T + tb)
    return float(np.sqrt((d * d).sum(1).mean()))


RUNS = {  # key: (grid width, config fields)
    "plane-32": (32, dict(metric="plane", max_iterations=60)),
    "plane-exact-24": (24, dict(metric="plane", max_iterations=60,
                                exact_distances=True)),
    "plane-damped-24": (24, dict(metric="plane", max_iterations=60,
                                 damping=1e-3)),
    "symmetric-24": (24, dict(metric="symmetric", max_iterations=60)),
    "plane-trim-24": (24, dict(metric="plane", max_iterations=60,
                               auto_trim=9.0)),
}


@pytest.mark.parametrize("key", list(RUNS))
def test_plane_icp_matches_jax(key):
    """The whole loop: iteration counts within 1 (the stop test may land an
    iteration apart in float32 noise), transforms within 1e-5 RMSE of each
    other, both within 1e-4 of the ground truth."""
    width, kw = RUNS[key]
    s = f.synthetic_scene(width=width)
    src, tgt = np.array(s.source), np.array(s.target)
    gR, gt = np.array(s.ground_truth.rotation), np.array(
        s.ground_truth.translation)
    cfg = f.ICPConfig(**kw)
    j = f.run_icp(jnp.asarray(src), jnp.asarray(tgt), cfg)
    t = ft.run_icp(torch.as_tensor(src), torch.as_tensor(tgt),
                   ft.ICPConfig(**kw))
    nj, nt = int(j.num_iterations), int(t.num_iterations)
    assert abs(nj - nt) <= 1, (nj, nt)
    Rj, tj = np.asarray(j.transform.rotation), np.asarray(
        j.transform.translation)
    Rt, tt = t.transform.rotation.numpy(), t.transform.translation.numpy()
    assert _rmse_between(Rt, tt, Rj, tj, src) < GAP
    assert _rmse_between(Rt, tt, gR, gt, src) < 1e-4
    assert torch.isnan(t.errors[nt:]).all() and torch.isfinite(
        t.errors[:nt]).all()


def test_plane_entry_point_and_given_normals():
    """``icp_point_to_plane`` fixes the metric; normals handed in are used
    as they are (the JAX package's estimate, so the two runs see the same
    normals)."""
    s = f.synthetic_scene(width=24)
    src, tgt = np.array(s.source), np.array(s.target)
    nrm = np.array(f.estimate_normals(jnp.asarray(tgt)))
    j = f.icp_point_to_plane(jnp.asarray(src), jnp.asarray(tgt),
                             max_iterations=60,
                             target_normals=jnp.asarray(nrm))
    t = ft.icp_point_to_plane(torch.as_tensor(src), torch.as_tensor(tgt),
                              max_iterations=60,
                              target_normals=points_from_numpy(
                                  nrm, device="cpu"))
    assert abs(int(j.num_iterations) - int(t.num_iterations)) <= 1
    assert _rmse_between(t.transform.rotation.numpy(),
                         t.transform.translation.numpy(),
                         np.asarray(j.transform.rotation),
                         np.asarray(j.transform.translation), src) < GAP
    with pytest.raises(ValueError, match="metric is fixed"):
        ft.icp_point_to_plane(torch.as_tensor(src), torch.as_tensor(tgt),
                              metric="point")
