"""The port's 3x3 eigensolvers against ``fpcr_tpu.ops.eigh3`` on the same
numpy inputs (CPU), degenerate inputs included: the closed form
(``eigvals3``) equals JAX's; ``smallest_eigenvector`` and ``eigh3`` run
``eig3`` (``torch.linalg.eigh`` on the CPU) and equal JAX's closed form
where an eigenvalue is simple, and are held to float64 ``eigh`` where it is
repeated, where the closed form's choice and LAPACK's differ."""

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


def _simple(a, col):
    """Rows whose float64 eigenvalue ``col`` is apart from the others by
    more than 1e-3 of the scale: its eigenvector is unique up to sign."""
    w = np.linalg.eigvalsh(a.astype(np.float64))
    scale = np.abs(w).max(axis=1) + 1e-30
    gaps = np.abs(w - w[:, col:col + 1])
    gaps[:, col] = np.inf
    return gaps.min(axis=1) > 1e-3 * scale


def _in_eigenspace(a, vecs, vals, atol):
    """Each column of ``vecs`` is an eigenvector of ``a`` for its value of
    ``vals``, as float64 ``eigh`` holds: ``|A v − λ v| <= atol·scale``."""
    a64 = a.astype(np.float64)
    v = vecs.astype(np.float64)
    res = np.einsum("nij,njk->nik", a64, v) - v * vals[:, None, :]
    scale = np.abs(np.linalg.eigvalsh(a64)).max(axis=1) + 1e-30
    assert (np.linalg.norm(res, axis=1) <= atol * scale[:, None]).all()


def test_degenerate_guards_match_jax():
    """Isotropic and zero matrices fall back to (1,1,1)/√3; a rank-1
    matrix's smallest eigenvector is perpendicular to its direction. Where
    the smallest eigenvalue is simple the vector is JAX's up to sign; where
    it is repeated (the rank-1 rows, I + 3vvᵀ) the closed form's choice is
    not LAPACK's, and the vector is held to float64 ``eigh``: in the
    smallest eigenvalue's eigenspace."""
    a = _degenerate_batch()
    (jv, _), (tv, tl) = _both("smallest_eigenvector", a)
    tv, jv = tv.numpy(), np.asarray(jv)
    fb = np.full(3, 1.0 / np.sqrt(3.0), np.float32)
    np.testing.assert_allclose(tv[0], fb, atol=1e-7)
    np.testing.assert_allclose(tv[1], fb, atol=1e-7)
    assert np.isfinite(tv).all()
    simple = _simple(a, 0)
    assert simple.sum() == 2  # the rank-2 and diag(1, 1, 1e-6) rows
    np.testing.assert_allclose(np.abs((tv * jv).sum(1))[simple], 1.0,
                               atol=1e-6)
    w = np.linalg.eigvalsh(a.astype(np.float64))
    rest = ~simple
    rest[:2] = False  # the guards' rows, held above
    _in_eigenspace(a[rest], tv[rest][:, :, None], w[rest][:, :1], 1e-6)
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
    # the random batch's columns are JAX's up to sign; the degenerate
    # batch's are held to float64 eigh, since the closed form's frame turns
    # by up to 0.09 rad there (the rank-2 row's null vector): each column
    # in its eigenspace, a simple eigenvalue's float64's up to sign
    w64, v64 = np.linalg.eigh(a.astype(np.float64))
    ref = jv if batch == "random" else v64
    cos = np.abs(np.einsum("nji,nji->ni", tv, ref))
    simple = np.stack([_simple(a, k) for k in range(3)], axis=1)
    np.testing.assert_allclose(cos[simple], 1.0, atol=1e-3)
    if batch == "random":
        assert simple.all()
    _in_eigenspace(a, tv, w64, 1e-5)
    if batch == "random":
        recon = np.einsum("nij,nj,nkj->nik", tv, tl, tv)
        scale = np.abs(a).max(axis=(1, 2))[:, None, None]
        np.testing.assert_allclose(recon / scale, a / scale, atol=1e-3)
