"""The port's closed-form 3x3 eigensolver against ``fpcr_tpu.ops.eigh3`` on
the same numpy inputs (CPU), degenerate inputs included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpcr_tpu.ops import eigh3 as jeig
from fpcr_tpu_torch.ops import eigh3 as teig

# both packages evaluate the same float32 expressions; elementwise order may
# differ by an ulp, which the arccos of the trigonometric form amplifies
# near repeated eigenvalues, so values agree to 1e-5 of the matrix scale
VAL_ATOL = 1e-5
VEC_ATOL = 1e-4  # eigenvectors, up to sign, away from repeated eigenvalues


def _spd_batch(seed, n=256):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, 3, 3)).astype(np.float32)
    return np.einsum("nij,nkj->nik", a, a).astype(np.float32)


def _degenerate_batch():
    """Isotropic, zero, rank-1, rank-2 and two-equal-eigenvalue inputs."""
    v = np.array([1.0, 2.0, -0.5], np.float32) / np.sqrt(5.25)
    u = np.array([0.0, 0.25, 1.0], np.float32)
    u = (u - v * (u @ v)) / np.linalg.norm(u - v * (u @ v))
    return np.stack([
        2.0 * np.eye(3), np.zeros((3, 3)), np.outer(v, v),
        np.outer(v, v) + np.outer(u, u), np.eye(3) + 3.0 * np.outer(v, v),
        np.diag([1.0, 1.0, 1e-6]), np.diag([0.0, 0.0, 1.0]),
    ]).astype(np.float32)


def _both(fn_name, a, **kw):
    j = getattr(jeig, fn_name)(jnp.asarray(a), **kw)
    t = getattr(teig, fn_name)(torch.as_tensor(a), **kw)
    return j, t


@pytest.mark.parametrize("batch", ["random", "degenerate"])
def test_eigvals3_matches_jax(batch):
    a = _spd_batch(1) if batch == "random" else _degenerate_batch()
    j, t = _both("eigvals3", a)
    scale = np.abs(a).max(axis=(1, 2))[:, None] + 1e-30
    np.testing.assert_allclose(t.numpy() / scale, np.asarray(j) / scale,
                               atol=VAL_ATOL)
    assert (np.diff(t.numpy(), axis=1) >= -1e-5 * scale).all()  # ascending


def test_smallest_eigenvector_matches_jax_and_numpy():
    a = _spd_batch(2)
    (jv, jl), (tv, tl) = _both("smallest_eigenvector", a)
    tv, jv = tv.numpy(), np.asarray(jv)
    np.testing.assert_allclose(np.abs((tv * jv).sum(1)), 1.0, atol=VEC_ATOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-5)
    w, v = np.linalg.eigh(a.astype(np.float64))
    gap = (w[:, 1] - w[:, 0]) / w[:, 2]
    well = gap > 1e-3  # a clear smallest eigenvalue fixes the direction
    assert well.mean() > 0.9
    np.testing.assert_allclose(np.abs((tv[well] * v[well, :, 0]).sum(1)),
                               1.0, atol=1e-3)


def test_degenerate_guards_match_jax():
    """Isotropic and zero matrices fall back to (1,1,1)/√3; a rank-1
    matrix's smallest eigenvector is perpendicular to its direction."""
    a = _degenerate_batch()
    (jv, _), (tv, _) = _both("smallest_eigenvector", a)
    tv = tv.numpy()
    fb = np.full(3, 1.0 / np.sqrt(3.0), np.float32)
    np.testing.assert_allclose(tv[0], fb, atol=1e-7)
    np.testing.assert_allclose(tv[1], fb, atol=1e-7)
    np.testing.assert_allclose(tv, np.asarray(jv), atol=1e-6)
    assert np.isfinite(tv).all()
    v = np.array([1.0, 2.0, -0.5], np.float32) / np.sqrt(5.25)
    # a double zero eigenvalue: the cross products of (A - λI)'s rows are
    # ~1e-4 of the scale, so the direction is resolved to ~1e-4
    assert abs(tv[2] @ v) < 1e-4


@pytest.mark.parametrize("batch", ["random", "degenerate"])
def test_eigh3_frame_matches_jax(batch):
    """eigh3's frame is orthonormal (the Gram–Schmidt guard included),
    reconstructs A, and equals JAX's up to the sign of each column."""
    a = _spd_batch(3) if batch == "random" else _degenerate_batch()
    (jl, jv), (tl, tv) = _both("eigh3", a)
    tv, jv, tl = tv.numpy(), np.asarray(jv), tl.numpy()
    eye = np.broadcast_to(np.eye(3), tv.shape)
    np.testing.assert_allclose(np.einsum("nji,njk->nik", tv, tv), eye,
                               atol=1e-4)
    np.testing.assert_allclose(tl, np.asarray(jl), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(np.abs(np.einsum("nji,nji->ni", tv, jv)),
                               1.0, atol=1e-3)
    if batch == "random":
        recon = np.einsum("nij,nj,nkj->nik", tv, tl, tv)
        scale = np.abs(a).max(axis=(1, 2))[:, None, None]
        np.testing.assert_allclose(recon / scale, a / scale, atol=1e-3)
