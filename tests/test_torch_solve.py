"""The port's Kabsch solve against ``fpcr_tpu.ops.solve`` (CPU).

Tests compare R and t, never U or V: SVD libraries pick the signs of the
singular vectors differently."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpcr_tpu.ops import solve as js
from fpcr_tpu_torch.ops import solve as ts

torch.set_num_threads(2)

# a 3x3 rotation from an f32 SVD of moments summed over ~500 points in two
# libraries: entries agree to ~1e-6, translations to ~1e-6 of the coords
ATOL = 1e-5


def _cloud_pair(seed, n=500, reflect=False):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(n, 3)).astype(np.float32) * [1.0, 0.6, 0.3]
    ang = rng.uniform(-0.5, 0.5, 3)
    R = np.asarray(js.rotation_zyx(*ang.astype(np.float32)))
    q = p @ R.T + rng.uniform(-1, 1, 3)
    if reflect:
        q = q * [1.0, 1.0, -1.0]  # no proper rotation fits: det fix matters
    q = q + rng.normal(scale=1e-3, size=q.shape)
    return p.astype(np.float32), q.astype(np.float32)


def _both(p, q, mask=None, **kw):
    t = ts.kabsch_transform(torch.as_tensor(p), torch.as_tensor(q),
                            None if mask is None else torch.as_tensor(mask),
                            **kw)
    j = js.kabsch_transform(jnp.asarray(p), jnp.asarray(q),
                            None if mask is None else jnp.asarray(mask), **kw)
    return t, j


def _assert_same(t, j):
    np.testing.assert_allclose(t.rotation.numpy(), np.asarray(j.rotation),
                               atol=ATOL)
    np.testing.assert_allclose(t.translation.numpy(),
                               np.asarray(j.translation), atol=ATOL)


@pytest.mark.parametrize("mask_kind", [None, "bool", "float"])
@pytest.mark.parametrize("solver", ["svd", "polar"])
def test_kabsch_matches_jax(mask_kind, solver):
    p, q = _cloud_pair(1)
    rng = np.random.default_rng(2)
    mask = {None: None, "bool": rng.uniform(size=len(p)) < 0.7,
            "float": rng.uniform(size=len(p)).astype(np.float32)}[mask_kind]
    t, j = _both(p, q, mask, solver=solver)
    _assert_same(t, j)
    assert abs(float(torch.linalg.det(t.rotation)) - 1.0) < 1e-5


@pytest.mark.parametrize("det_correction", [True, False])
def test_reflection_case_det_fix(det_correction):
    p, q = _cloud_pair(3, reflect=True)
    t, j = _both(p, q, det_correction=det_correction)
    _assert_same(t, j)
    det = float(torch.linalg.det(t.rotation))
    # with the fix a proper rotation; without it (strict reference math)
    # the reflection U·Vᵀ itself
    assert abs(det - (1.0 if det_correction else -1.0)) < 1e-5


def test_moments_match_jax():
    p, q = _cloud_pair(4)
    mask = np.random.default_rng(5).uniform(size=len(p)) < 0.5
    tp, tq, tm = (torch.as_tensor(x) for x in (p, q, mask))
    jp, jq, jm = (jnp.asarray(x) for x in (p, q, mask))
    for x_t, x_j in ((tp, jp), (tq, jq)):
        np.testing.assert_allclose(ts.masked_centroid(x_t, tm).numpy(),
                                   np.asarray(js.masked_centroid(x_j, jm)),
                                   atol=1e-6)
    pb, qb = ts.masked_centroid(tp, tm), ts.masked_centroid(tq, tm)
    W = ts.cross_covariance(tp, tq, pb, qb, tm)
    Wj = js.cross_covariance(jp, jq, jnp.asarray(pb.numpy()),
                             jnp.asarray(qb.numpy()), jm)
    # sums of ~250 products of O(1) terms: 1e-4 absolute on entries ~100
    np.testing.assert_allclose(W.numpy(), np.asarray(Wj), atol=1e-4)


def test_polar_rank_deficient_line_gives_identity():
    """A 1-D line cloud makes W rank 1: the polar solver's guard returns
    the identity instead of a projection."""
    s = np.linspace(-1, 1, 64, dtype=np.float32)[:, None]
    p = s * np.array([[1.0, 2.0, 3.0]], np.float32)
    q = p + np.float32(0.1)
    t, j = _both(p, q, solver="polar")
    np.testing.assert_array_equal(t.rotation.numpy(), np.eye(3))
    _assert_same(t, j)


def test_polar_equals_svd_on_nonsingular():
    p, q = _cloud_pair(6)
    a = ts.kabsch_transform(torch.as_tensor(p), torch.as_tensor(q),
                            solver="polar")
    b = ts.kabsch_transform(torch.as_tensor(p), torch.as_tensor(q))
    np.testing.assert_allclose(a.rotation.numpy(), b.rotation.numpy(),
                               atol=ATOL)


def test_unknown_solver_raises():
    p = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="solver"):
        ts.kabsch_transform(p, p, solver="qr")


def test_det3_matches_linalg():
    a = torch.as_tensor(np.random.default_rng(7).normal(size=(3, 3)),
                        dtype=torch.float32)
    assert abs(float(ts._det3(a)) - float(torch.linalg.det(a))) < 1e-5
