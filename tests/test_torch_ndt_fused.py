"""Kernel K4's plain version (``ops.ndt.ndt_fused_moments_plain``) against
the TPU kernel ``fpcr_tpu.ops.ndt_pallas.ndt_fused_moments`` in interpret
mode and against the numpy gather-path oracle
``fpcr_tpu.ops.ndt.reference_neighborhood_moments``, on the JAX package's
own grid (CPU). The scenes are those of ``tests/test_ndt.py``: a uniform
cloud, and one with rows outside the grid, rows one cell below its min face
and a masked row, for ``direct7`` and ``direct1``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpcr_tpu.ops import ndt as jn
from fpcr_tpu.ops.ndt_pallas import ndt_fused_moments as j_fused
from fpcr_tpu.ops.ndt_pallas import prepare_fused_tables as j_tables
from fpcr_tpu_torch.interop import ndt_grid_from_numpy
from fpcr_tpu_torch.ops import ndt as tn
from fpcr_tpu_torch.ops.ndt_cuda import ndt_fused_moments_cuda

torch.set_num_threads(2)

H = 0.25
D1, D2 = jn.gauss_d1_d2(0.55, H)
D1 = abs(D1)
# The TPU kernel forms q by a bilinear expansion in h+m+l bf16 parts and w
# by exp of it; its own test holds it to the gather path at rtol 2e-3, atol
# 2e-4 of the largest moment, and so do we.
JAX_RTOL, JAX_ATOL_REL = 2e-3, 2e-4
# The plain version computes r = x′ − μ′ and q = rᵀSr directly in f32, as
# the oracle does on absolute coordinates: the two round r differently by
# ~1e-7 of |x| (~2), i.e. ~1e-6 of r at voxel scale, which exp(−d2/2·q)
# carries into w; 1e-4 relative and 1e-5 of the largest moment bound it.
ORACLE_RTOL, ORACLE_ATOL_REL = 1e-4, 1e-5


def _scene(kind):
    """``(jax grid, sorted source f32[n,3], source mask or None)``."""
    if kind == "uniform":
        rng = np.random.default_rng(23)
        pts = rng.uniform(0, 2.0, (6000, 3)).astype(np.float32)
        src = pts + rng.normal(0, 0.02, pts.shape).astype(np.float32)
        mask = None
    else:  # 'edges': out-of-grid rows, rows below the min face, a masked row
        rng = np.random.default_rng(31)
        pts = rng.uniform(0, 2.0, (4096, 3)).astype(np.float32)
        src = pts + rng.normal(0, 0.02, pts.shape).astype(np.float32)
        src[:64] -= 3.0
        src[64:128, 0] = -0.1
        mask = np.arange(src.shape[0]) != 100
    grid = jn.build_ndt_grid(jnp.asarray(pts), H)
    order = np.asarray(jn.cell_key_order(jnp.asarray(src), grid))
    return grid, src[order], mask


def _port(grid_j, src, mask, neighborhood, chunk=256, window=256):
    grid = ndt_grid_from_numpy(grid_j)
    rows, xp = tn.ndt_fused_moments(
        torch.as_tensor(src), grid, tn.prepare_fused_tables(grid),
        voxel_size=H, d1=D1, d2=D2, neighborhood=neighborhood, chunk=chunk,
        window=window, source_mask=None if mask is None
        else torch.as_tensor(mask))
    return rows.numpy(), xp.numpy()


def _wsr(rows, xp):
    """Σ w S r from the fused lanes: WS·x′ − WSμ′."""
    s = rows
    return np.stack([
        s[:, 0] * xp[:, 0] + s[:, 1] * xp[:, 1] + s[:, 2] * xp[:, 2] - s[:, 6],
        s[:, 1] * xp[:, 0] + s[:, 3] * xp[:, 1] + s[:, 4] * xp[:, 2] - s[:, 7],
        s[:, 2] * xp[:, 0] + s[:, 4] * xp[:, 1] + s[:, 5] * xp[:, 2] - s[:, 8],
    ], axis=1)


CASES = [("uniform", "direct7"), ("edges", "direct7"), ("edges", "direct1")]


@pytest.mark.parametrize("kind,neighborhood", CASES)
def test_plain_k4_matches_tpu_kernel(kind, neighborhood):
    grid_j, src, mask = _scene(kind)
    rows, xp = _port(grid_j, src, mask, neighborhood)
    rj, xj = j_fused(jnp.asarray(src), grid_j, j_tables(grid_j),
                     voxel_size=H, d1=D1, d2=D2, neighborhood=neighborhood,
                     chunk=256, window=256, interpret=True,
                     source_mask=None if mask is None
                     else jnp.asarray(mask))
    rj, xj = np.asarray(rj), np.asarray(xj)
    np.testing.assert_array_equal(rows[:, 10], rj[:, 10])  # counts
    assert rows[:, 10].max() >= (5 if neighborhood == "direct7" else 1)
    np.testing.assert_array_equal(xp, xj)  # the same anchors
    np.testing.assert_array_equal(rows[:, 12:], 0.0)
    scale = np.abs(rj[:, 0:10]).max()
    np.testing.assert_allclose(rows[:, 0:10], rj[:, 0:10], rtol=JAX_RTOL,
                               atol=JAX_ATOL_REL * scale)
    np.testing.assert_allclose(rows[:, 11], rj[:, 11], rtol=JAX_RTOL,
                               atol=1e-3 * max(rj[:, 11].max(), 1.0))
    if mask is not None:  # the masked row is a structural miss
        np.testing.assert_array_equal(rows[~mask, 0:12], 0.0)


@pytest.mark.parametrize("kind,neighborhood", CASES)
def test_plain_k4_matches_gather_oracle(kind, neighborhood):
    grid_j, src, mask = _scene(kind)
    rows, xp = _port(grid_j, src, mask, neighborhood)
    offsets = (jn.DIRECT7_OFFSETS if neighborhood == "direct7" else [None])
    WS, WSr, count, qsum = jn.reference_neighborhood_moments(
        jnp.asarray(src), grid_j, D1, D2, offsets)
    keep = np.ones(src.shape[0], bool) if mask is None else mask
    # the band covers the whole neighbourhood on these clouds
    np.testing.assert_array_equal(rows[keep, 10], count[keep])
    np.testing.assert_allclose(rows[keep, 0:6], WS[keep], rtol=ORACLE_RTOL,
                               atol=ORACLE_ATOL_REL * np.abs(WS).max())
    np.testing.assert_allclose(_wsr(rows, xp)[keep], WSr[keep],
                               rtol=ORACLE_RTOL,
                               atol=ORACLE_ATOL_REL * np.abs(WSr).max())
    np.testing.assert_allclose(rows[keep, 11], qsum[keep], rtol=ORACLE_RTOL,
                               atol=ORACLE_ATOL_REL * qsum.max())


def test_torch_oracle_matches_numpy_oracle():
    """``ops.ndt.reference_neighborhood_moments``, K4's oracle on the card,
    against the JAX package's numpy one on the same grid."""
    grid_j, src, _ = _scene("edges")
    WS, WSr, count, qsum = jn.reference_neighborhood_moments(
        jnp.asarray(src), grid_j, D1, D2)
    t = tn.reference_neighborhood_moments(
        torch.as_tensor(src), ndt_grid_from_numpy(grid_j), D1, D2)
    np.testing.assert_array_equal(t[2].numpy(), count)
    for got, want in ((t[0], WS), (t[1], WSr), (t[3], qsum)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())


def test_dispatch_and_wrapper_checks():
    """A CPU tensor takes the plain version; the CUDA wrapper refuses it."""
    grid_j, src, _ = _scene("edges")
    grid = ndt_grid_from_numpy(grid_j)
    tables = tn.prepare_fused_tables(grid)
    kw = dict(voxel_size=H, d1=D1, d2=D2, chunk=256, window=256)
    p = torch.as_tensor(src)
    a = tn.ndt_fused_moments(p, grid, tables, **kw)
    b = tn.ndt_fused_moments_plain(p, grid, tables, **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    before = ndt_fused_moments_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        ndt_fused_moments_cuda(p, grid, tables, **kw)
    assert ndt_fused_moments_cuda.launches == before
    with pytest.raises(ValueError, match="neighborhood"):
        tn.ndt_fused_moments(p, grid, tables, neighborhood="direct27", **kw)
