"""Kernels K1, K2, the min-only sweep, K3, K3p (unbatched and with a batch
axis), K4, Kernel S (the bf16 split distance on the tensor cores), the E1
distance forms, eig3 and the normals' self-kNN on the card against their
plain PyTorch versions, and the E1 forms and the min-only
sweep (``csrc/nn_forms.cu``) bit for bit against their first design
(``csrc/matching.cu``); GICP, the loop variants and the voxel
grid on the card against the port on the CPU, and no host sync in their
iterations; the sharded loops on a one-rank NCCL group against the
unsharded ones, bit for bit; the CLI on the card; check 10 of
``scripts/tpu_smoke.py`` (the wide-plane cloud through K4 at its escalated
window) and the basic example on the card.

Every test here needs a CUDA device and skips without one: a CUDA kernel
has no CPU mode. On the card (which has no JAX, so the root conftest is
not loaded):

    python -m pytest --noconftest -q tests/test_torch_gpu.py
"""

import math

import numpy as np
import pytest
import torch

from fpcr_tpu_torch.ops.matching import nn_argmin, nn_argmin_plain
from fpcr_tpu_torch.ops.matching_cuda import nn_argmin_cuda

pytestmark = pytest.mark.gpu

# kernel vs plain difference form: both round ~3 ulp of a non-negative sum
# of three squares, the kernel with FMAs, so 1e-6 relative bounds the gap
RTOL, ATOL = 1e-6, 1e-7
TIE_REL = 1e-6  # indices may differ only between picks this close


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _cloud(rng, n, scale=2.0):
    return rng.uniform(-scale, scale, size=(n, 3)).astype(np.float32)


def _check_against_plain(p, q, mask=None):
    ki, kd = nn_argmin_cuda(p, q, mask)
    oi, od = nn_argmin_plain(p, q, mask, exact=True)
    ki, kd, oi, od = (x.cpu().numpy() for x in (ki, kd, oi, od))
    assert ki.dtype == np.int32 and kd.dtype == np.float32
    assert ki.min() >= 0 and ki.max() <= q.shape[0] - 1
    np.testing.assert_array_equal(np.isinf(kd), np.isinf(od))
    fin = np.isfinite(od)
    assert (ki[~fin] == 0).all()
    np.testing.assert_allclose(kd[fin], od[fin], rtol=RTOL, atol=ATOL)
    diff = np.nonzero(ki != oi)[0]
    if diff.size:
        p64 = p.cpu().numpy().astype(np.float64)[diff]
        q64 = q.cpu().numpy().astype(np.float64)
        dk = ((p64 - q64[ki[diff]]) ** 2).sum(1)
        do = ((p64 - q64[oi[diff]]) ** 2).sum(1)
        assert (np.abs(dk - do) <= TIE_REL * np.maximum(1.0, do)).all()
    return ki


@pytest.mark.parametrize("n,m", [(1, 1), (7, 300), (300, 500), (131, 259),
                                 (513, 1025), (4096, 20000), (20000, 700)])
def test_kernel_matches_plain(cuda, n, m):
    rng = np.random.default_rng(n * 7919 + m)
    p = torch.as_tensor(_cloud(rng, n), device=cuda)
    q = torch.as_tensor(_cloud(rng, m), device=cuda)
    _check_against_plain(p, q)


@pytest.mark.parametrize("keep", [0.0, 0.01, 0.4, 1.0])
def test_kernel_masked_targets(cuda, keep):
    rng = np.random.default_rng(5)
    p = torch.as_tensor(_cloud(rng, 300), device=cuda)
    q = torch.as_tensor(_cloud(rng, 3000), device=cuda)
    mask = torch.as_tensor(rng.uniform(size=3000) < keep, device=cuda)
    ki = _check_against_plain(p, q, mask)
    if keep > 0:
        assert mask.cpu().numpy()[ki].all()


def test_kernel_uint8_mask_equals_bool_mask(cuda):
    rng = np.random.default_rng(6)
    p = torch.as_tensor(_cloud(rng, 200), device=cuda)
    q = torch.as_tensor(_cloud(rng, 900), device=cuda)
    mask = torch.as_tensor(rng.uniform(size=900) < 0.5, device=cuda)
    a = nn_argmin_cuda(p, q, mask)
    b = nn_argmin_cuda(p, q, mask.to(torch.uint8))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_kernel_ties_go_to_lowest_index(cuda):
    p = torch.zeros((1, 3), device=cuda)
    q = torch.tensor([[5, 0, 0], [1, 0, 0], [2, 0, 0], [1, 0, 0]],
                     dtype=torch.float32, device=cuda)
    assert int(nn_argmin_cuda(p, q)[0][0]) == 1
    # a tie across target slices: equal candidates far apart in index
    q = torch.full((5000, 3), 9.0, device=cuda)
    q[4000] = q[300] = q[4999] = torch.tensor([0.5, 0.0, 0.0])
    idx, d = nn_argmin_cuda(torch.zeros((600, 3), device=cuda), q)
    assert (idx == 300).all() and torch.allclose(d, torch.tensor(0.25))


def test_launch_counter_and_dispatch(cuda):
    rng = np.random.default_rng(8)
    p = torch.as_tensor(_cloud(rng, 16384), device=cuda)
    before = nn_argmin_cuda.launches
    nn_argmin(p, p)
    assert nn_argmin_cuda.launches > before


def test_wrapper_rejects_bad_inputs(cuda):
    p = torch.zeros((8, 3), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        nn_argmin_cuda(p.double(), p)
    with pytest.raises(ValueError, match="contiguous"):
        nn_argmin_cuda(torch.zeros((3, 8), device=cuda).T, p)
    with pytest.raises(ValueError, match=r"\[\*, 3\]"):
        nn_argmin_cuda(torch.zeros((8, 4), device=cuda), p)
    with pytest.raises(ValueError, match="CUDA"):
        nn_argmin_cuda(p, p.cpu())
    with pytest.raises(ValueError, match="bool or uint8"):
        nn_argmin_cuda(p, p, torch.ones(8, device=cuda))
    with pytest.raises(ValueError, match="at least one target"):
        nn_argmin_cuda(p, torch.zeros((0, 3), device=cuda))


def test_icp_on_card_matches_cpu(cuda):
    import fpcr_tpu_torch as ft

    cfg = ft.ICPConfig(max_iterations=40, exact_distances=True)
    s_cpu = ft.synthetic_scene(width=32, device="cpu")
    s_gpu = ft.synthetic_scene(width=32, device=cuda)
    r_cpu = ft.run_icp(s_cpu.source, s_cpu.target, cfg)
    before = nn_argmin_cuda.launches
    r_gpu = ft.run_icp(s_gpu.source, s_gpu.target, cfg)
    assert nn_argmin_cuda.launches - before >= int(r_gpu.num_iterations)
    it = int(r_cpu.num_iterations)
    # ±1: the stop test may land one iteration apart in float32 noise
    assert abs(int(r_gpu.num_iterations) - it) <= 1
    k = min(it, int(r_gpu.num_iterations))
    np.testing.assert_allclose(r_gpu.errors.cpu()[:k], r_cpu.errors[:k],
                               atol=1e-5)
    assert float(ft.transform_rmse(
        ft.RigidTransform(r_gpu.transform.rotation.cpu(),
                          r_gpu.transform.translation.cpu()),
        s_cpu.ground_truth, s_cpu.source)) < 1e-5


def test_cuda_timers(cuda):
    from fpcr_tpu_torch.utils.timing import cuda_time_ms, slope_ms_per_iter

    x = torch.ones(1024, device=cuda)
    t = cuda_time_ms(lambda: x * 2, repeats=3)
    assert 0 < t["min"] <= t["mean"] <= t["max"]
    s = slope_ms_per_iter(lambda k: [x * 2 for _ in range(k)], 2, 12, 2)
    assert np.isfinite(s["ms_per_iter"])


# --- kernel K3, the Morton band matcher -----------------------------------

def _band_case(cuda, n, m, seed, masked_from=None, shift=0.0):
    from fpcr_tpu_torch.ops.morton import (build_morton_table,
                                           source_morton_order)

    rng = np.random.default_rng(seed)
    q = torch.as_tensor(_cloud(rng, m), device=cuda)
    p = q[torch.as_tensor(rng.integers(0, m, n), device=cuda)]
    p = (p + 0.002 * torch.randn(p.shape, device=cuda,
                                 generator=torch.Generator(cuda)
                                 .manual_seed(seed))).contiguous()
    mask = None if masked_from is None else (
        torch.arange(m, device=cuda) < masked_from)
    table = build_morton_table(q, mask, shift=shift)
    return p[source_morton_order(p, table).long()].contiguous(), table


def _check_band_against_plain(p, table, extra, chunk, window):
    from fpcr_tpu_torch.ops.morton import morton_nn_band_plain
    from fpcr_tpu_torch.ops.morton_cuda import morton_nn_cuda

    km, kd, ki, ke = morton_nn_cuda(p, table, extra, chunk=chunk,
                                    window=window)
    om, od, oi, oe = morton_nn_band_plain(p, table, extra, chunk=chunk,
                                          window=window)
    q = table.points_sorted
    m, vc = q.shape[0], int(table.valid_count)
    assert ki.dtype == torch.int32 and int(ki.min()) >= 0
    assert int(ki.max()) <= m - 1
    assert torch.equal(km, q[ki.long()])  # bit for bit the table rows
    if extra is not None:
        assert torch.equal(ke, extra[ki.long()])
    if vc > 0:
        assert int(ki.max()) < vc  # no masked row wins
    fin = torch.isfinite(od)
    assert torch.equal(torch.isfinite(kd), fin)
    np.testing.assert_allclose(kd[fin].cpu().numpy(), od[fin].cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
    diff = torch.nonzero(ki != oi)[:, 0]
    if diff.numel():
        p64 = p[diff].double()
        dk = ((p64 - q[ki[diff].long()].double()) ** 2).sum(1)
        do = ((p64 - q[oi[diff].long()].double()) ** 2).sum(1)
        assert ((dk - do).abs() <= TIE_REL * torch.clamp(do, min=1.0)).all()
    return ki


@pytest.mark.parametrize("n,m,chunk,window,masked_from,shift", [
    (100, 3000, 256, 256, None, 0.0),      # n < chunk
    (1000, 3000, 512, 64, None, 0.0),      # n not a multiple of chunk
    (300, 500, 256, 256, None, 0.0),       # m < band
    (2500, 3000, 256, 256, 2200, 0.0),     # masked tail
    (2500, 3000, 512, 64, 2900, 0.5),      # shifted table
    (4000, 5000, 1000, 300, None, 0.0),    # a chunk in two passes
    (65536, 65536, 512, 64, None, 0.0),
])
def test_band_kernel_matches_plain(cuda, n, m, chunk, window, masked_from,
                                   shift):
    p, table = _band_case(cuda, n, m, n + m, masked_from, shift)
    extra = (table.points_sorted * 0.5 + 0.25).contiguous()
    _check_band_against_plain(p, table, extra, chunk, window)
    _check_band_against_plain(p, table, None, chunk, window)


def test_band_kernel_no_valid_target_convention(cuda):
    from fpcr_tpu_torch.ops.morton_cuda import morton_nn_cuda

    p, table = _band_case(cuda, 300, 600, 3, masked_from=0)
    km, kd, ki, _ = morton_nn_cuda(p, table, chunk=128, window=64)
    assert torch.isinf(kd).all() and (ki == 0).all()
    assert torch.equal(km, table.points_sorted[:1].expand(300, 3))


def test_band_kernel_counter_dispatch_and_checks(cuda):
    from fpcr_tpu_torch.ops.morton import morton_nn_band
    from fpcr_tpu_torch.ops.morton_cuda import morton_nn_cuda

    p, table = _band_case(cuda, 2048, 4096, 4)
    before = morton_nn_cuda.launches
    morton_nn_band(p, table, chunk=512, window=64)
    assert morton_nn_cuda.launches == before + 1
    with pytest.raises(ValueError, match="CUDA"):
        morton_nn_cuda(p.cpu(), table)
    with pytest.raises(ValueError, match=r"\[4096, 3\]"):
        morton_nn_cuda(p, table, extra=table.points_sorted[:10].contiguous())
    bad = table._replace(valid_count=table.valid_count.long())
    with pytest.raises(ValueError, match="int32"):
        morton_nn_cuda(p, bad)


def test_morton_icp_on_card_matches_cpu(cuda):
    import fpcr_tpu_torch as ft
    from fpcr_tpu_torch.ops.morton_cuda import morton_nn_cuda

    gt = ft.gt_transform((0.004, -0.002, 0.003), (0.002, -0.003, 0.002),
                         device="cpu")
    cfg = ft.ICPConfig(matcher="morton", morton_impl="pallas",
                       morton_chunk=512, morton_window=64, max_iterations=20,
                       morton_shifts=2)
    src = ft.synthetic_scene(width=64, device="cpu").source
    r_cpu = ft.run_icp(src, gt.apply(src), cfg)
    s_gpu = src.to(cuda)
    before = morton_nn_cuda.launches
    r_gpu = ft.run_icp(s_gpu, gt.apply(s_gpu.cpu()).to(cuda), cfg)
    it = int(r_gpu.num_iterations)
    assert morton_nn_cuda.launches - before >= 2 * it
    assert abs(it - int(r_cpu.num_iterations)) <= 1
    tr = ft.RigidTransform(r_gpu.transform.rotation.cpu(),
                           r_gpu.transform.translation.cpu())
    assert float(ft.transform_rmse(tr, r_cpu.transform, src)) < 1e-5


# --- kernel K4, the fused direct7 NDT moments -------------------------------

# K4 vs its plain version: r, q and the sums round with and without FMAs and
# exp(-d2/2·q) carries q's rounding into w; counts and x' are exact
K4_RTOL, K4_ATOL_REL = 1e-4, 1e-5


def _ndt_case(cuda, n, seed, h=0.25, off_grid=False, masked=False):
    from fpcr_tpu_torch.ops.ndt import build_ndt_grid, cell_key_order

    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 2.0, (n, 3)).astype(np.float32)
    src = pts + rng.normal(0, 0.02, pts.shape).astype(np.float32)
    if off_grid:
        src[:64] -= 3.0
        src[64:128, 0] = -0.1
    grid = build_ndt_grid(torch.as_tensor(pts, device=cuda), h)
    p = torch.as_tensor(src, device=cuda)
    p = p[cell_key_order(p, grid).long()].contiguous()
    mask = (torch.arange(n, device=cuda) != 100) if masked else None
    return p, grid, mask


def _check_fused_against_plain(p, grid, mask, h, chunk, window, hood):
    from fpcr_tpu_torch.ops.ndt import (gauss_d1_d2, ndt_fused_moments_plain,
                                        prepare_fused_tables)
    from fpcr_tpu_torch.ops.ndt_cuda import ndt_fused_moments_cuda

    d1, d2 = gauss_d1_d2(0.55, h)
    kw = dict(voxel_size=h, d1=abs(d1), d2=d2, neighborhood=hood,
              chunk=chunk, window=window, source_mask=mask)
    tables = prepare_fused_tables(grid)
    rk, xk = ndt_fused_moments_cuda(p, grid, tables, **kw)
    rp, xp = ndt_fused_moments_plain(p, grid, tables, **kw)
    assert torch.equal(rk[:, 10], rp[:, 10])
    assert torch.equal(xk, xp)
    assert not bool(rk[:, 12:].any())
    a, b = rk[:, :12].cpu().numpy(), rp[:, :12].cpu().numpy()
    for lanes in (slice(0, 10), slice(11, 12)):
        np.testing.assert_allclose(
            a[:, lanes], b[:, lanes], rtol=K4_RTOL,
            atol=K4_ATOL_REL * max(float(np.abs(b[:, lanes]).max()), 1e-30))
    return rk


@pytest.mark.parametrize("n,chunk,window,hood,off_grid,masked", [
    (6000, 256, 256, "direct7", False, False),
    (4096, 256, 256, "direct7", True, True),   # off the grid, a masked row
    (4096, 256, 256, "direct1", True, True),
    (100, 128, 64, "direct7", False, False),   # n < chunk, m < band
    (6000, 512, 3968, "direct7", False, False),  # the cap's band, 8,576 rows
    (6000, 128, 1, "direct7", False, False),   # a narrow band: misses
    (65536, 512, 256, "direct7", False, False),
])
def test_fused_kernel_matches_plain(cuda, n, chunk, window, hood, off_grid,
                                    masked):
    p, grid, mask = _ndt_case(cuda, n, n + chunk + window, off_grid=off_grid,
                              masked=masked)
    rk = _check_fused_against_plain(p, grid, mask, 0.25, chunk, window, hood)
    if n >= 1000:  # dense enough for valid voxels
        assert int(rk[:, 10].max()) >= 1


def test_fused_kernel_matches_gather_oracle(cuda):
    from fpcr_tpu_torch.ops.ndt import (gauss_d1_d2, ndt_fused_moments,
                                        prepare_fused_tables,
                                        reference_neighborhood_moments)

    p, grid, _ = _ndt_case(cuda, 6000, 23)
    d1, d2 = gauss_d1_d2(0.55, 0.25)
    rows, xp = ndt_fused_moments(p, grid, prepare_fused_tables(grid),
                                 voxel_size=0.25, d1=abs(d1), d2=d2,
                                 chunk=256, window=256)
    WS, _, count, qsum = reference_neighborhood_moments(p, grid, abs(d1), d2)
    assert torch.equal(rows[:, 10], count)
    np.testing.assert_allclose(rows[:, 0:6].cpu().numpy(), WS.cpu().numpy(),
                               rtol=1e-4,
                               atol=1e-5 * float(WS.abs().max()))
    np.testing.assert_allclose(rows[:, 11].cpu().numpy(),
                               qsum.cpu().numpy(), rtol=1e-4,
                               atol=1e-5 * float(qsum.max()))


def test_fused_counter_dispatch_and_checks(cuda):
    from fpcr_tpu_torch.ops.ndt import ndt_fused_moments, prepare_fused_tables
    from fpcr_tpu_torch.ops.ndt_cuda import ndt_fused_moments_cuda

    p, grid, _ = _ndt_case(cuda, 2048, 4)
    tables = prepare_fused_tables(grid)
    kw = dict(voxel_size=0.25, d1=1.0, d2=1.0, chunk=256, window=256)
    before = ndt_fused_moments_cuda.launches
    ndt_fused_moments(p, grid, tables, **kw)
    assert ndt_fused_moments_cuda.launches == before + 1
    with pytest.raises(ValueError, match="CUDA"):
        ndt_fused_moments_cuda(p.cpu(), grid, tables, **kw)
    with pytest.raises(ValueError, match="multiple of 128"):
        ndt_fused_moments_cuda(p, grid, tables, **{**kw, "chunk": 100})
    with pytest.raises(ValueError, match="tables.tab"):
        ndt_fused_moments_cuda(p, grid, tables._replace(
            tab=tables.tab.double()), **kw)


def test_ndt_on_card_matches_cpu(cuda):
    """The same registration through K4 on the card and through its plain
    version on the CPU."""
    import fpcr_tpu_torch as ft
    from fpcr_tpu_torch.ops.ndt_cuda import ndt_fused_moments_cuda

    gt = ft.gt_transform((0.02, -0.015, 0.01), (0.03, -0.02, 0.015),
                         device="cpu")
    src = ft.synthetic_scene(width=48, device="cpu").source
    cfg = ft.NDTConfig(voxel_size=0.4, max_iterations=60, lookup="banded",
                       lookup_impl="pallas", lookup_chunk=256,
                       lookup_window=256)
    r_cpu = ft.run_ndt(src, gt.apply(src), cfg)
    before = ndt_fused_moments_cuda.launches
    r_gpu = ft.run_ndt(src.to(cuda), gt.apply(src).to(cuda), cfg)
    it = int(r_gpu.num_iterations)
    assert ndt_fused_moments_cuda.launches - before >= it
    assert abs(it - int(r_cpu.num_iterations)) <= 1
    tr = ft.RigidTransform(r_gpu.transform.rotation.cpu(),
                           r_gpu.transform.translation.cpu())
    assert float(ft.transform_rmse(tr, r_cpu.transform, src)) < 1e-5


# --- kernel K2, the packed brute-force matcher, and the min-only sweep ------

def _packed_tie(idx_bits):
    """Two picks may differ only within one bucket (2^-(23-b) relative) and
    the few ulp by which the kernel's FMAs and the plain version's separate
    roundings place a distance on either side of a bucket edge."""
    return 2.0 ** -(23 - idx_bits) + 2.0 ** -20


def _check_packed_against_plain(p, q, mask=None, idx_bits=None):
    from fpcr_tpu_torch.ops.matching import (nn_argmin_packed_plain,
                                             packed_idx_bits)
    from fpcr_tpu_torch.ops.matching_cuda import nn_argmin_packed_cuda

    bits = packed_idx_bits(q.shape[0]) if idx_bits is None else idx_bits
    ki, kd = nn_argmin_packed_cuda(p, q, mask, idx_bits=bits)
    oi, od = nn_argmin_packed_plain(p, q, mask, idx_bits=bits)
    ki, kd, oi, od = (x.cpu().numpy() for x in (ki, kd, oi, od))
    assert ki.dtype == np.int32 and kd.dtype == np.float32
    assert ki.min() >= 0 and ki.max() <= q.shape[0] - 1
    np.testing.assert_array_equal(np.isinf(kd), np.isinf(od))
    fin = np.isfinite(od)
    assert (ki[~fin] == 0).all()
    p64 = p.cpu().numpy().astype(np.float64)
    q64 = q.cpu().numpy().astype(np.float64)
    dk = ((p64 - q64[ki]) ** 2).sum(1)
    np.testing.assert_allclose(kd[fin], dk[fin], rtol=RTOL, atol=ATOL)
    same = fin & (ki == oi)
    np.testing.assert_allclose(kd[same], od[same], rtol=RTOL, atol=ATOL)
    diff = fin & (ki != oi)
    if diff.any():
        do = ((p64[diff] - q64[oi[diff]]) ** 2).sum(1)
        rel = np.abs(dk[diff] - do) / np.maximum(np.minimum(dk[diff], do),
                                                 1e-30)
        assert rel.max() <= _packed_tie(bits), rel.max()
    if mask is not None and fin.any():
        assert mask.cpu().numpy()[ki[fin]].all()
    return ki


@pytest.mark.parametrize("n,m", [(1, 1), (7, 300), (300, 500), (131, 259),
                                 (513, 1025), (4096, 20000), (20000, 700),
                                 (16384, 65536)])
def test_packed_kernel_matches_plain(cuda, n, m):
    rng = np.random.default_rng(n * 7919 + m + 1)
    p = torch.as_tensor(_cloud(rng, n), device=cuda)
    q = torch.as_tensor(_cloud(rng, m), device=cuda)
    _check_packed_against_plain(p, q)


@pytest.mark.parametrize("keep", [0.0, 0.01, 0.4, 1.0])
def test_packed_kernel_masked_targets(cuda, keep):
    rng = np.random.default_rng(15)
    p = torch.as_tensor(_cloud(rng, 300), device=cuda)
    q = torch.as_tensor(_cloud(rng, 3000), device=cuda)
    mask = torch.as_tensor(rng.uniform(size=3000) < keep, device=cuda)
    _check_packed_against_plain(p, q, mask)


def test_packed_kernel_ties_gate_counter_and_checks(cuda):
    from fpcr_tpu_torch.ops.matching import nn_argmin_packed
    from fpcr_tpu_torch.ops.matching_cuda import nn_argmin_packed_cuda

    q = torch.tensor([[5, 0, 0], [1, 0, 0], [2, 0, 0], [1, 0, 0]],
                     dtype=torch.float32, device=cuda)
    assert int(nn_argmin_packed(torch.zeros((1, 3), device=cuda), q)[0][0]) \
        == 1
    # a tie across target slices: the int32 min keeps the lowest index
    q = torch.full((5000, 3), 9.0, device=cuda)
    q[4000] = q[300] = q[4999] = torch.tensor([0.5, 0.0, 0.0])
    idx, d = nn_argmin_packed(torch.zeros((600, 3), device=cuda), q)
    assert (idx == 300).all() and torch.allclose(d, torch.tensor(0.25))
    before = nn_argmin_packed_cuda.launches
    nn_argmin_packed(q, q)
    assert nn_argmin_packed_cuda.launches == before + 2  # sweep + epilogue
    with pytest.raises(ValueError, match="packed6_idx"):
        nn_argmin_packed(q, torch.zeros((70000, 3), device=cuda))
    with pytest.raises(ValueError, match="index bits"):
        nn_argmin_packed_cuda(q, q, idx_bits=12)
    with pytest.raises(ValueError, match="CUDA"):
        nn_argmin_packed_cuda(q, q.cpu(), idx_bits=13)


@pytest.mark.parametrize("n,m,keep", [(1, 1, 1.0), (300, 500, 1.0),
                                      (300, 3000, 0.4), (300, 3000, 0.0),
                                      (16384, 16384, 1.0)])
def test_min_only_kernel_matches_plain(cuda, n, m, keep):
    """The min-only sweep against its plain version (NaN and inf in the
    same rows, the rest within RTOL / ATOL) and bit for bit against its
    yardstick (``bench/kernel_checks.py::check_min_only``)."""
    from fpcr_tpu_torch.bench.kernel_checks import check_min_only
    from fpcr_tpu_torch.bench.packed_reduction import nn_min_only
    from fpcr_tpu_torch.ops.matching_cuda import nn_min_only_cuda

    rng = np.random.default_rng(n + m)
    p = torch.as_tensor(_cloud(rng, n), device=cuda)
    q = torch.as_tensor(_cloud(rng, m), device=cuda)
    mask = torch.as_tensor(rng.uniform(size=m) < keep, device=cuda)
    check_min_only(p, q, mask)
    before = nn_min_only_cuda.launches
    idx, d = nn_min_only(p, q)
    assert nn_min_only_cuda.launches > before and not bool(idx.any())


def test_packed_icp_on_card_matches_cpu(cuda):
    import fpcr_tpu_torch as ft
    from fpcr_tpu_torch.ops.matching_cuda import (nn_argmin_cuda,
                                                  nn_argmin_packed_cuda)

    cfg = ft.ICPConfig(max_iterations=40, matcher="pallas",
                       pallas_mode="packed6_idx")
    s_cpu = ft.synthetic_scene(width=32, device="cpu")
    s_gpu = ft.synthetic_scene(width=32, device=cuda)
    r_cpu = ft.run_icp(s_cpu.source, s_cpu.target, cfg)
    before = (nn_argmin_cuda.launches, nn_argmin_packed_cuda.launches)
    r_gpu = ft.run_icp(s_gpu.source, s_gpu.target, cfg)
    it = int(r_gpu.num_iterations)
    assert nn_argmin_cuda.launches == before[0]
    assert nn_argmin_packed_cuda.launches - before[1] >= 2 * it
    assert abs(it - int(r_cpu.num_iterations)) <= 1
    tr = ft.RigidTransform(r_gpu.transform.rotation.cpu(),
                           r_gpu.transform.translation.cpu())
    assert float(ft.transform_rmse(tr, r_cpu.transform, s_cpu.source)) < 1e-5


# --- kernel K3p, the packed Morton band -------------------------------------

def _check_band_packed_against_plain(p, table, extra, chunk, window):
    from fpcr_tpu_torch.ops.morton import (band_idx_bits, band_rows,
                                           morton_nn_band_packed_plain)
    from fpcr_tpu_torch.ops.morton_cuda import morton_nn_packed_cuda

    km, kd, ki, ke = morton_nn_packed_cuda(p, table, extra, chunk=chunk,
                                           window=window)
    om, od, oi, oe = morton_nn_band_packed_plain(p, table, extra, chunk=chunk,
                                                 window=window)
    q = table.points_sorted
    m, vc = q.shape[0], int(table.valid_count)
    assert ki.dtype == torch.int32 and int(ki.min()) >= 0
    assert int(ki.max()) <= m - 1
    assert torch.equal(km, q[ki.long()])  # bit for bit the table rows
    if extra is not None:
        assert torch.equal(ke, extra[ki.long()])
    if vc > 0:
        assert int(ki.max()) < vc
    fin = torch.isfinite(od)
    assert torch.equal(torch.isfinite(kd), fin)
    same = fin & (ki == oi)
    np.testing.assert_allclose(kd[same].cpu().numpy(),
                               od[same].cpu().numpy(), rtol=RTOL, atol=ATOL)
    diff = torch.nonzero(fin & (ki != oi))[:, 0]
    if diff.numel():
        band = band_rows(chunk, window)
        p64 = p[diff].double()
        dk = ((p64 - q[ki[diff].long()].double()) ** 2).sum(1)
        do = ((p64 - q[oi[diff].long()].double()) ** 2).sum(1)
        rel = (dk - do).abs() / torch.clamp(torch.minimum(dk, do), min=1e-30)
        assert float(rel.max()) <= _packed_tie(band_idx_bits(band))
    return ki


@pytest.mark.parametrize("n,m,chunk,window,masked_from,shift", [
    (100, 3000, 256, 256, None, 0.0),
    (1000, 3000, 512, 64, None, 0.0),
    (300, 500, 256, 256, None, 0.0),
    (2500, 3000, 256, 256, 2200, 0.0),
    (2500, 3000, 512, 64, 2900, 0.5),
    (4000, 5000, 1000, 300, None, 0.0),
    (65536, 65536, 512, 64, None, 0.0),
])
def test_band_packed_kernel_matches_plain(cuda, n, m, chunk, window,
                                          masked_from, shift):
    p, table = _band_case(cuda, n, m, n + m + 1, masked_from, shift)
    extra = (table.points_sorted * 0.5 + 0.25).contiguous()
    _check_band_packed_against_plain(p, table, extra, chunk, window)
    _check_band_packed_against_plain(p, table, None, chunk, window)


def test_band_packed_kernel_convention_and_counter(cuda):
    from fpcr_tpu_torch.ops.morton import morton_nn_band
    from fpcr_tpu_torch.ops.morton_cuda import (morton_nn_cuda,
                                                morton_nn_packed_cuda)

    p, table = _band_case(cuda, 300, 600, 3, masked_from=0)
    km, kd, ki, _ = morton_nn_packed_cuda(p, table, chunk=128, window=64)
    assert torch.isinf(kd).all() and (ki == 0).all()
    assert torch.equal(km, table.points_sorted[:1].expand(300, 3))
    p, table = _band_case(cuda, 2048, 4096, 4)
    before = (morton_nn_cuda.launches, morton_nn_packed_cuda.launches)
    morton_nn_band(p, table, chunk=512, window=64, mode="packed6_idx")
    assert (morton_nn_cuda.launches,
            morton_nn_packed_cuda.launches) == (before[0], before[1] + 1)
    morton_nn_band(p, table, chunk=512, window=64, mode="highest")
    assert morton_nn_cuda.launches == before[0] + 1


# --- Kernel S and the E1 forms (the studies E1, E3, E4) --------------------

SPLIT_SHAPES = [(1, 1), (5, 3), (131, 259), (300, 500), (1000, 8),
                (1000, 16), (1000, 24), (4099, 20001)]


def _split_case(cuda, n, m, terms, seed=0, scale=2.0):
    from fpcr_tpu_torch.bench.split_matmul import split_pads
    from fpcr_tpu_torch.ops.split import split_operands

    rng = np.random.default_rng(seed * 131 + n + m)
    p = torch.as_tensor(_cloud(rng, n, scale), device=cuda)
    q = torch.as_tensor(_cloud(rng, m, scale), device=cuda)
    return split_operands(p, q, terms, *split_pads(n, m))


@pytest.mark.parametrize("terms", [6, 3])
@pytest.mark.parametrize("epilogue", ["argmin", "packed14", "min", "keep"])
@pytest.mark.parametrize("n,m", SPLIT_SHAPES)
def test_split_kernel_matches_plain(cuda, terms, epilogue, n, m):
    """Kernel S against its plain version at ragged shapes: picks equal on
    0.999 of the rows, the rest and every value within the order bound
    (``bench/kernel_checks.py``)."""
    from fpcr_tpu_torch.bench.kernel_checks import check_split

    p_in, q_in = _split_case(cuda, n, m, terms)
    if epilogue == "packed14" and q_in.shape[0] > 1 << 14:
        with pytest.raises(ValueError, match="2\\^14"):  # E3's 14 bits
            check_split(p_in, q_in, n, m, epilogue)
        return
    check_split(p_in, q_in, n, m, epilogue, keep=m // 2,
                clamp=epilogue == "argmin")


# the wgmma sweep's tile (128) and slice edges: one target, a tile short,
# whole, one over; 2^14 targets in 64 slices of 256 (64 and 300 rows) and
# in three of 5,504 (16,384 rows)
SPLIT_EDGE_SHAPES = [(1, 127), (1, 128), (1, 129), (129, 257), (64, 16384),
                     (300, 16384), (16384, 16384)]


@pytest.mark.parametrize("terms", [6, 3])
@pytest.mark.parametrize("epilogue", ["argmin", "packed14", "min", "keep"])
@pytest.mark.parametrize("n,m", SPLIT_EDGE_SHAPES)
def test_split_kernel_matches_plain_at_edges(cuda, terms, epilogue, n, m):
    """The wgmma sweep against its plain version across the tile and slice
    edges (``bench/kernel_checks.py::check_split``, as at SPLIT_SHAPES)."""
    from fpcr_tpu_torch.bench.kernel_checks import check_split

    p_in, q_in = _split_case(cuda, n, m, terms, seed=1)
    check_split(p_in, q_in, n, m, epilogue, keep=m - 1,
                clamp=epilogue == "argmin")


@pytest.mark.parametrize("slice_len", [128, 384, 8192, 16384])
def test_split_kernel_equal_under_any_slice_plan(cuda, slice_len,
                                                 monkeypatch):
    """The picks and distance bits do not depend on how the targets are
    sliced: the first minimum of the kernel's own values, combined in
    slice order (another plan put in place of ``split_cuda._plan``)."""
    from fpcr_tpu_torch.ops import split_cuda
    from fpcr_tpu_torch.ops.split_cuda import split_nn_cuda

    p_in, q_in = _split_case(cuda, 700, 16384, 6, seed=2)
    for epi in ("argmin", "packed14", "min"):
        ri, rd = split_nn_cuda(p_in, q_in, 700, 16384, epi)
        with monkeypatch.context() as mp:
            mp.setattr(split_cuda, "_plan", lambda dev, n, m: (
                -(-m // slice_len), slice_len))
            ki, kd = split_nn_cuda(p_in, q_in, 700, 16384, epi)
        assert torch.equal(ri, ki), epi
        assert torch.equal(rd.view(torch.int32), kd.view(torch.int32)), epi


@pytest.mark.parametrize("terms", [6, 3])
@pytest.mark.parametrize("n,m", [(300, 500), (4099, 20001), (16384, 16384)])
def test_split_kernel_against_mma_sync(cuda, terms, n, m):
    """The wgmma sweep against the mma.sync yardstick (``csrc/split_mma.cu``)
    on the same operands: the same function summed in another order, so
    picks equal on 0.999 of the rows and the rest, and every distance,
    within the order bound. Prints the share of equal picks and the
    largest difference."""
    from fpcr_tpu_torch.bench.kernel_checks import split_bound
    from fpcr_tpu_torch.ops.split_cuda import _split_nn_mma_sync, split_nn_cuda

    p_in, q_in = _split_case(cuda, n, m, terms, seed=3)
    bound = split_bound(p_in, q_in, n, m)
    for epi in ("argmin", "min", "keep"):
        ki, kd = split_nn_cuda(p_in, q_in, n, m, epi, keep=m - 1)
        oi, od = _split_nn_mma_sync(p_in, q_in, n, m, epi, keep=m - 1)
        same = ki == oi
        diff = (kd.double() - od.double()).abs()
        print(f"x{terms} {epi} {n}x{m}: picks equal "
              f"{float(same.double().mean()):.6f}, max |d - d_mma| "
              f"{float(diff.max()):.3e}")
        assert float(same.double().mean()) >= 0.999
        assert bool((diff <= bound).all())


@pytest.mark.parametrize("terms", [6, 3])
@pytest.mark.parametrize("m", [500, 16384])
def test_split_kernel_nan_as_plain(cuda, terms, m):
    """A NaN source point (a row of NaN) and a NaN target point (a column
    of NaN), in one slice and in several: the argmin and the packed key
    never pick the NaN column and give the NaN row the plain version's
    (index 0, +inf) and initial key; ``min`` is NaN in every row, as the
    plain version's (``tests/test_torch_split_wgmma.py`` holds these
    against E3/E4)."""
    from fpcr_tpu_torch.bench.split_matmul import split_pads
    from fpcr_tpu_torch.ops.split import split_nn_plain, split_operands
    from fpcr_tpu_torch.ops.split_cuda import split_nn_cuda

    rng = np.random.default_rng(m + terms)
    p, q = _cloud(rng, 700), _cloud(rng, m)
    p[3], q[100] = np.nan, np.nan
    p_in, q_in = split_operands(torch.as_tensor(p, device=cuda),
                                torch.as_tensor(q, device=cuda), terms,
                                *split_pads(700, m))
    for epi in ("argmin", "packed14", "min"):
        if epi == "packed14" and q_in.shape[0] > 1 << 14:
            continue
        ki, kd = split_nn_cuda(p_in, q_in, 700, m, epi)
        pi, pd = split_nn_plain(p_in, q_in, 700, m, epi)
        if epi == "min":
            assert bool(kd.isnan().all()) and bool(pd.isnan().all())
            continue
        assert not bool((ki == 100).any()) and not bool((pi == 100).any())
        assert int(ki[3]) == int(pi[3])
        assert int(kd.view(torch.int32)[3]) == int(pd.view(torch.int32)[3])
        assert bool(torch.isfinite(kd[torch.arange(700, device=cuda) != 3]
                                   ).all())


def test_split_kernel_yardstick_count(cuda):
    """The yardstick counts on its own wrapper, never on split_nn_cuda's."""
    from fpcr_tpu_torch.ops.split_cuda import _split_nn_mma_sync, split_nn_cuda

    p_in, q_in = _split_case(cuda, 300, 4096, 3)
    before = dict(split_nn_cuda.launches)
    old = dict(_split_nn_mma_sync.launches)
    _split_nn_mma_sync(p_in, q_in, 300, 4096, "argmin")
    torch.cuda.synchronize()
    assert split_nn_cuda.launches == before
    assert _split_nn_mma_sync.launches["x3 argmin"] == old["x3 argmin"] + 2


@pytest.mark.parametrize("m", [8, 16, 24, 1000])
def test_split_kernel_finds_known_neighbours(cuda, m):
    """p on a shuffled lattice of spacing 0.1 and q = p shifted by a
    distinct offset under 0.01 per row: the argmin and the packed key find
    row i's own target in every row, which a wrong A or B fragment layout
    would not."""
    from fpcr_tpu_torch.ops.split import split_operands
    from fpcr_tpu_torch.ops.split_cuda import split_nn_cuda

    rng = np.random.default_rng(m)
    cell = rng.permutation(1000)[:m]
    p = (np.stack([cell % 10, cell // 10 % 10, cell // 100], 1) * 0.1
         - 0.5).astype(np.float32)
    off = (np.arange(m, dtype=np.float32) + 1)[:, None] * np.float32(1e-5)
    q = (p + off * np.array([1, -1, 1], np.float32)).astype(np.float32)
    for terms in (6, 3):
        p_in, q_in = split_operands(torch.as_tensor(p, device=cuda),
                                    torch.as_tensor(q, device=cuda), terms,
                                    m, 1024)
        for epi in ("argmin", "packed14"):
            i, _ = split_nn_cuda(p_in, q_in, m, m, epi)
            assert i.cpu().tolist() == list(range(m)), (terms, epi)


def test_split_kernel_ties_gate_counter_and_checks(cuda):
    """Duplicates across target slices go to the lowest index; packed14 at
    exactly 2^14 targets runs and past it raises without a launch; each
    launch type counts its sweep and combine (the keep column one launch);
    bad operands raise."""
    from fpcr_tpu_torch.bench.kernel_checks import check_split
    from fpcr_tpu_torch.ops.split import split_nn, split_operands
    from fpcr_tpu_torch.ops.split_cuda import split_nn_cuda

    q = torch.full((5000, 3), 9.0, device=cuda)
    q[4000] = q[300] = q[4999] = torch.tensor([0.5, 0.0, 0.0])
    p_in, q_in = split_operands(torch.zeros((600, 3), device=cuda), q, 6,
                                600, 5120)
    for epi in ("argmin", "packed14"):
        assert (split_nn_cuda(p_in, q_in, 600, 5000, epi)[0] == 300).all()
    p_in, q_in = _split_case(cuda, 300, 16384, 6)
    check_split(p_in, q_in, 300, 16384, "packed14")
    big = torch.zeros((16392, 48), dtype=torch.bfloat16, device=cuda)
    before = dict(split_nn_cuda.launches)
    with pytest.raises(ValueError, match="2\\^14"):
        split_nn_cuda(p_in, big, 300, 16385, "packed14")
    assert split_nn_cuda.launches == before
    split_nn(p_in, q_in, 300, 16384, "argmin")
    split_nn(p_in, q_in, 300, 16384, "keep", keep=5)
    assert split_nn_cuda.launches["x6 argmin"] == before["x6 argmin"] + 2
    assert split_nn_cuda.launches["x6 keep"] == before["x6 keep"] + 1
    with pytest.raises(ValueError, match="bfloat16"):
        split_nn_cuda(p_in.float(), q_in, 300, 16384, "min")
    with pytest.raises(ValueError, match="terms"):
        split_nn_cuda(p_in[:, :40].contiguous(), q_in[:, :40].contiguous(),
                      300, 16384, "min")
    with pytest.raises(ValueError, match="round_up"):
        split_nn_cuda(p_in, q_in[:100], 300, 99, "min")


@pytest.mark.parametrize("variant", ["v1", "v2", "v4", "v5", "v6"])
@pytest.mark.parametrize("n,m", [(1, 1), (131, 259), (300, 500),
                                 (4099, 20001)])
def test_form_kernel_matches_plain(cuda, variant, n, m):
    """Each E1 form against its plain version at the study's scale (±300),
    within the order bound of its sum (``bench/kernel_checks.py``)."""
    from fpcr_tpu_torch.bench.kernel_checks import check_form

    rng = np.random.default_rng(n * 3 + m)
    p = torch.as_tensor(_cloud(rng, n, 300.0), device=cuda)
    q = torch.as_tensor(_cloud(rng, m, 300.0), device=cuda)
    check_form(p, q, variant)


def test_form_kernel_ties_counter_and_study_outputs(cuda):
    """Ties go to the lowest index under every form; each launch type counts
    its launches; ``nn_e1`` keeps the script's output formulas on the
    card as on the CPU."""
    from fpcr_tpu_torch.ops.matching import nn_e1
    from fpcr_tpu_torch.ops.matching_cuda import nn_form_cuda

    q = torch.tensor([[5.0, 0, 0], [1, 0, 0], [2, 0, 0], [1, 0, 0]],
                     device=cuda)
    p = torch.zeros((1, 3), device=cuda)
    before = dict(nn_form_cuda.launches)
    for v in ("v1", "v2", "v4", "v5", "v6"):
        assert int(nn_e1(p, q, v)[0][0]) == 1, v
        assert nn_form_cuda.launches[v] > before[v]
    rng = np.random.default_rng(4)
    p = torch.as_tensor(_cloud(rng, 700, 300.0), device=cuda)
    q = torch.as_tensor(_cloud(rng, 900, 300.0), device=cuda)
    for v in ("v1", "v3", "v2", "v4", "v5", "v6"):
        gi, gd = nn_e1(p, q, v)
        ci, cd = nn_e1(p.cpu(), q.cpu(), v)
        same = (gi.cpu() == ci)
        assert float(same.double().mean()) > 0.99, v
        np.testing.assert_allclose(gd.cpu()[same].numpy(),
                                   cd[same].numpy(), rtol=1e-3, atol=0.5)


# the new sweep's slice (at most 2,048 targets) and sub-tile (32) edges
FORM_SHAPES = [(1, 1), (5, 3), (131, 259), (1025, 31), (1025, 33),
               (300, 2047), (300, 2049), (4099, 20001), (16384, 16384)]


@pytest.mark.parametrize("variant", ["v1", "v2", "v4", "v5", "v6"])
@pytest.mark.parametrize("n,m", FORM_SHAPES)
def test_form_kernel_equals_yardstick(cuda, variant, n, m):
    """``csrc/nn_forms.cu`` against its yardstick, ``csrc/matching.cu``'s
    instance, on the same lanes: picks and values bit for bit."""
    from fpcr_tpu_torch.bench.kernel_checks import check_form_yardstick

    rng = np.random.default_rng(n * 5 + m)
    p = torch.as_tensor(_cloud(rng, n, 300.0), device=cuda)
    q = torch.as_tensor(_cloud(rng, m, 300.0), device=cuda)
    check_form_yardstick(p, q, variant)


def _nan_case(cuda, case, n=700, m=3000):
    rng = np.random.default_rng(len(case))
    p, q = _cloud(rng, n, 300.0), _cloud(rng, m, 300.0)
    if case in ("target", "both"):
        q[m // 3, 2] = np.nan
    if case in ("row", "both"):
        p[9] = np.nan
    if case == "negative NaN":
        q[m // 3, 0] = -np.nan
    return torch.as_tensor(p, device=cuda), torch.as_tensor(q, device=cuda)


@pytest.mark.parametrize("variant", ["v1", "v2", "v4", "v5", "v6"])
@pytest.mark.parametrize("case", ["target", "row", "both", "negative NaN"])
def test_form_kernel_nan_as_plain(cuda, variant, case):
    """A NaN target, a NaN source row (every value of every row NaN under
    v1, v2, v4, whose lanes carry C = max|p|^2), both, and a NaN of
    negative sign: the new sweep equals its yardstick bit for bit and its
    plain version (NaN and inf rows alike, the NaN target never picked)."""
    from fpcr_tpu_torch.bench.kernel_checks import (check_form,
                                                    check_form_yardstick)
    from fpcr_tpu_torch.ops.matching import nn_e1

    p, q = _nan_case(cuda, case)
    check_form_yardstick(p, q, variant)
    check_form(p, q, variant)
    if case in ("target", "negative NaN"):
        assert not bool((nn_e1(p, q, variant)[0] == 1000).any())


@pytest.mark.parametrize("variant", ["v1", "v2", "v4", "v5", "v6"])
def test_form_kernel_negative_zero(cuda, variant):
    """Values of exactly -0.0 and +0.0 (lanes given, rows at the origin):
    the argmin's first zero (target 3, +0.0), v2's key of -0.0 (target 5),
    v4's and v5's clamp of -0.0 to +0.0 (target 3): the new sweep, its
    yardstick (the PTX max.NaN.f32 clamp) and the plain version alike."""
    from fpcr_tpu_torch.bench.kernel_checks import (check_form_yardstick,
                                                    e1_args)
    from fpcr_tpu_torch.ops.matching import E1_VARIANTS, nn_form_plain
    from fpcr_tpu_torch.ops.matching_cuda import nn_form_cuda

    n, m = 64, 300
    p = torch.zeros((n, 3), device=cuda)
    q = torch.as_tensor(np.random.default_rng(5).uniform(0.5, 1.5, (m, 3))
                        .astype(np.float32), device=cuda)
    q_w = torch.linspace(1.0, 2.0, m, device=cuda)
    q_w[3], q_w[5] = 0.0, -0.0
    lanes = (q_w, torch.full((n,), -0.0, device=cuda))
    check_form_yardstick(p, q, variant, lanes=lanes)
    qw, psq, kw = e1_args(p, q, variant, lanes=lanes)
    ki, kd = nn_form_cuda(p, q, qw, psq, **kw)
    oi, od = nn_form_plain(p, q, qw, psq, **kw)
    want = 5 if variant == "v2" else 3
    assert ki.tolist() == [want] * n and torch.equal(ki, oi)
    if E1_VARIANTS[variant][1] == "argmin":
        assert kd.view(torch.int32).tolist() == [0] * n


@pytest.mark.parametrize("case", ["target", "row", "masked target",
                                  "row, all masked"])
@pytest.mark.parametrize("m", [3000, 16384])
def test_min_only_kernel_nan_as_plain(cuda, case, m):
    """A NaN target makes every row NaN, a NaN source row its own; a masked
    NaN target counts as inf, and a NaN row with every target masked is
    inf: as the plain version, and bit for bit the yardstick."""
    from fpcr_tpu_torch.bench.kernel_checks import check_min_only

    p, q = _nan_case(cuda, "row" if case.startswith("row") else "target",
                     m=m)
    mask = None
    if case == "masked target":
        mask = torch.ones(m, dtype=torch.bool, device=cuda)
        mask[m // 3] = False
    elif case == "row, all masked":
        mask = torch.zeros(m, dtype=torch.bool, device=cuda)
    check_min_only(p, q, mask)


@pytest.mark.parametrize("slice_len", [32, 256, 2048])
def test_forms_equal_under_any_slice_plan(cuda, slice_len, monkeypatch):
    """The outputs do not depend on the slice plan (another plan put in
    place of ``matching_cuda._plan_forms``)."""
    from fpcr_tpu_torch.bench.kernel_checks import e1_args
    from fpcr_tpu_torch.ops import matching_cuda
    from fpcr_tpu_torch.ops.matching_cuda import (nn_form_cuda,
                                                  nn_min_only_cuda)

    p, q = _nan_case(cuda, "target", n=1500, m=5000)
    runs = []
    for plan in (None, slice_len):
        with monkeypatch.context() as mp:
            if plan:
                lib = matching_cuda._build.load_library()
                mp.setattr(matching_cuda, "_plan_forms", lambda p_, m_: (
                    lib, -(-m_ // plan), plan))
            out = [nn_min_only_cuda(p, q)]
            for v in ("v1", "v2", "v4", "v5", "v6"):
                q_w, psq, kw = e1_args(p, q, v)
                out += list(nn_form_cuda(p, q, q_w, psq, **kw))
            runs.append([x.view(torch.int32) if x.is_floating_point()
                         else x for x in out])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_forms_yardstick_counts(cuda):
    """Each yardstick counts on its own wrapper, never on the new one's."""
    from fpcr_tpu_torch.bench.kernel_checks import e1_args
    from fpcr_tpu_torch.ops.matching_cuda import (_nn_form_yardstick,
                                                  _nn_min_only_yardstick,
                                                  nn_form_cuda,
                                                  nn_min_only_cuda)

    p, q = _nan_case(cuda, "row", n=300, m=4096)
    new = (dict(nn_form_cuda.launches), nn_min_only_cuda.launches)
    old = (dict(_nn_form_yardstick.launches),
           _nn_min_only_yardstick.launches)
    _nn_min_only_yardstick(p, q)
    q_w, psq, kw = e1_args(p, q, "v2")
    _nn_form_yardstick(p, q, q_w, psq, **kw)
    torch.cuda.synchronize()
    assert (dict(nn_form_cuda.launches), nn_min_only_cuda.launches) == new
    assert _nn_min_only_yardstick.launches == old[1] + 2
    assert _nn_form_yardstick.launches["v2"] == old[0]["v2"] + 2


# --- K3 and K3p with their bases in the kernel and culled sub-tiles ---------

BAND_CASES = ["tail-chunk", "m<band", "masked", "no-valid-target", "shifted",
              "far-pose", "duplicates", "outside-box", "two-tiles",
              "grid-65536"]


def _culling_case(cuda, name):
    """``(p sorted along the table, table, extra, chunk, window)``."""
    import fpcr_tpu_torch as ft
    from fpcr_tpu_torch.ops.morton import (build_morton_table,
                                           source_morton_order)

    if name in ("far-pose", "grid-65536"):
        pose = (((0.3, -0.2, 0.25), (0.4, -0.3, 0.2)) if name == "far-pose"
                else ((0.004, -0.002, 0.003), (0.002, -0.003, 0.002)))
        s = ft.transformed_scene(ft.surface_grid(256, device=cuda), *pose)
        p, q, chunk, window = s.source, s.target, 512, 64
        table = build_morton_table(q)
        p = p[source_morton_order(p, table).long()].contiguous()
    elif name in ("duplicates", "outside-box"):
        rng = np.random.default_rng(17)
        q = rng.uniform(-2, 2, (3000, 3)).astype(np.float32)
        if name == "duplicates":  # equal distances across the seed sub-tile
            dup = q[rng.integers(0, 3000, 8)]
            q = np.concatenate([q, np.repeat(dup, 70, axis=0)])
            p = np.concatenate([np.repeat(dup, 40, axis=0)
                                + rng.normal(scale=0.01, size=(320, 3)),
                                q[rng.integers(0, 3000, 900)]])
            chunk, window = 256, 256
        else:  # probes quantize past the table's box
            p = q[rng.integers(0, 3000, 2500)] + np.array([3.0, 0.0, -2.5])
            chunk, window = 512, 64
        q = torch.as_tensor(q, device=cuda)
        p = torch.as_tensor(p.astype(np.float32), device=cuda)
        table = build_morton_table(q)
        p = p[source_morton_order(p, table).long()].contiguous()
    else:
        n, m, chunk, window, masked_from, shift = {
            "tail-chunk": (1000, 3000, 512, 64, None, 0.0),
            "m<band": (300, 500, 256, 256, None, 0.0),
            "masked": (2500, 3000, 256, 256, 2200, 0.0),
            "no-valid-target": (300, 600, 128, 64, 0, 0.0),
            "shifted": (2500, 3000, 512, 64, 2900, 0.5),
            "two-tiles": (4000, 5000, 1000, 300, None, 0.0),
        }[name]
        p, table = _band_case(cuda, n, m, n + m + 2, masked_from, shift)
    extra = (table.points_sorted * 0.5 + 0.25).contiguous()
    return p, table, extra, chunk, window


@pytest.mark.parametrize("packed", [False, True], ids=["K3", "K3p"])
@pytest.mark.parametrize("name", BAND_CASES)
def test_band_kernel_bases_equal_band_bases(cuda, name, packed):
    """The bases the kernel's prologue computes equal ``band_bases`` and
    its scalar mirror ``prologue_bases``, bit for bit."""
    from fpcr_tpu_torch.ops.morton import band_bases, prologue_bases
    from fpcr_tpu_torch.ops.morton_cuda import (morton_nn_cuda,
                                                morton_nn_packed_cuda)

    p, table, _, chunk, window = _culling_case(cuda, name)
    kernel = morton_nn_packed_cuda if packed else morton_nn_cuda
    stats = {}
    kernel(p, table, chunk=chunk, window=window, _stats=stats)
    band, want = band_bases(p, table, chunk, window)
    assert stats["band"] == band and stats["bases"].dtype == torch.int32
    assert torch.equal(stats["bases"], want)
    np.testing.assert_array_equal(
        stats["bases"].cpu().numpy(),
        prologue_bases(p, table, chunk, window)[1])


@pytest.mark.parametrize("packed", [False, True], ids=["K3", "K3p"])
@pytest.mark.parametrize("name", BAND_CASES)
def test_band_kernel_culled_equals_unculled(cuda, name, packed):
    """Culling changes no output: matched, sqdist, idx and extra of the
    culled kernel equal its unculled instance's bit for bit; the unculled
    instance visits every (group, sub-tile), the culled one no more."""
    from fpcr_tpu_torch.ops.morton import band_rows
    from fpcr_tpu_torch.ops.morton_cuda import (band_visit_totals,
                                                morton_nn_cuda,
                                                morton_nn_packed_cuda)

    p, table, extra, chunk, window = _culling_case(cuda, name)
    kernel = morton_nn_packed_cuda if packed else morton_nn_cuda
    for e in (extra, None):
        culled, full = {}, {}
        a = kernel(p, table, e, chunk=chunk, window=window, _stats=culled)
        b = kernel(p, table, e, chunk=chunk, window=window, _cull=False,
                   _stats=full)
        for x, y in zip(a, b):
            assert (x is None and y is None) or torch.equal(x, y)
        total, _ = band_visit_totals(p.shape[0], chunk,
                                     band_rows(chunk, window))
        assert int(full["visits"].sum()) == total
        assert 0 <= int(culled["visits"].sum()) <= total
        if name == "grid-65536":  # near GT most sub-tiles are far
            assert int(culled["visits"].sum()) < 0.6 * total
        if name == "no-valid-target":  # empty boxes: nothing visited
            assert int(culled["visits"].sum()) == 0
            assert torch.isinf(a[1]).all() and (a[2] == 0).all()


def test_band_kernel_one_launch_per_call(cuda):
    """A K3 or K3p call launches the port's kernel and no other CUDA
    kernel, and counts one launch; ``_cull=False`` counts too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fpcr_tpu_torch.ops.morton import morton_nn_band
    from fpcr_tpu_torch.ops.morton_cuda import (morton_nn_cuda,
                                                morton_nn_packed_cuda)

    p, table, extra, chunk, window = _culling_case(cuda, "grid-65536")
    for kernel, mode in ((morton_nn_cuda, "highest"),
                         (morton_nn_packed_cuda, "packed6_idx")):
        for e in (None, extra):
            call = lambda: morton_nn_band(p, table, e, chunk=chunk,  # noqa
                                          window=window, mode=mode)
            call()
            torch.cuda.synchronize()
            before = kernel.launches
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            names = [ev.name for ev in prof.events()
                     if ev.device_type == DeviceType.CUDA]
            assert kernel.launches == before + 1
            # a session now and then reports no device event at all
            assert len(names) <= 1
            assert all("morton_band_kernel" in x for x in names), names
        before = kernel.launches
        kernel(p, table, chunk=chunk, window=window, _cull=False)
        assert kernel.launches == before + 1


def test_band_kernel_rejects_bad_tables(cuda):
    from fpcr_tpu_torch.ops.morton_cuda import morton_nn_cuda

    p, table = _band_case(cuda, 256, 1024, 6)
    for field, bad in (("codes_sorted", table.codes_sorted.long()),
                       ("lo", table.lo.double()),
                       ("inv_extent", table.inv_extent[:2].contiguous()),
                       ("codes_sorted", table.codes_sorted.cpu())):
        with pytest.raises(ValueError, match=field):
            morton_nn_cuda(p, table._replace(**{field: bad}))


# --- K3 and K3p with a batch axis (the element on blockIdx.z) -------------

def _band_batch(cuda, b, n, m, seed):
    """B clouds with their stacked table (element 1 a masked tail, element
    2 no valid target), each source sorted along its own curve, and an
    extra of the table rows."""
    from fpcr_tpu_torch.ops.morton import (build_morton_table,
                                           source_morton_order)

    rng = np.random.default_rng(seed)
    q = torch.as_tensor(rng.uniform(-2, 2, (b, m, 3)).astype(np.float32),
                        device=cuda)
    rows = torch.as_tensor(rng.integers(0, m, (b, n)), device=cuda)
    p = torch.take_along_dim(q, rows[..., None], dim=1) + torch.as_tensor(
        rng.normal(scale=0.002, size=(b, n, 3)).astype(np.float32),
        device=cuda)
    mask = torch.ones((b, m), dtype=torch.bool, device=cuda)
    if b > 1:
        mask[1, m // 2:] = False
    if b > 2:
        mask[2] = False
    table = build_morton_table(q, mask, shift=0.5 if seed % 2 else 0.0)
    order = source_morton_order(p, table).long()
    p = torch.take_along_dim(p, order[..., None], dim=1).contiguous()
    return p, table, (table.points_sorted * 0.5 + 0.25).contiguous()


@pytest.mark.parametrize("packed", [False, True], ids=["K3", "K3p"])
@pytest.mark.parametrize("b,n,m,chunk,window", [
    (1, 1000, 3000, 512, 64), (3, 2500, 3000, 256, 256),
    (4, 4000, 5000, 1000, 300), (5, 300, 500, 256, 256),
    (16, 65536, 65536, 512, 64)])
def test_batched_band_kernel_equals_unbatched_launches(cuda, packed, b, n,
                                                       m, chunk, window):
    """A batch is one launch; each element's four outputs, band bases and
    sub-tile visits equal its own unbatched launch's bit for bit; the
    culled batch equals the unculled one; every element holds against the
    plain version as an unbatched call does."""
    from fpcr_tpu_torch.ops.morton import table_element
    from fpcr_tpu_torch.ops.morton_cuda import (morton_nn_cuda,
                                                morton_nn_packed_cuda)

    kernel = morton_nn_packed_cuda if packed else morton_nn_cuda
    check = (_check_band_packed_against_plain if packed
             else _check_band_against_plain)
    p, table, extra = _band_batch(cuda, b, n, m, b * 31 + n)
    for e in (extra, None):
        stats, full = {}, {}
        before = kernel.launches
        out = kernel(p, table, e, chunk=chunk, window=window, _stats=stats)
        assert kernel.launches == before + 1
        ref = kernel(p, table, e, chunk=chunk, window=window, _cull=False,
                     _stats=full)
        for x, y in zip(out, ref):
            assert (x is None and y is None) or torch.equal(x, y)
        assert out[0].shape == (b, n, 3) and stats["bases"].shape[0] == b
        for k in range(b):
            own_stats = {}
            own = kernel(p[k], table_element(table, k),
                         None if e is None else e[k], chunk=chunk,
                         window=window, _stats=own_stats)
            for x, y in zip(out, own):
                assert (x is None and y is None) or torch.equal(x[k], y)
            for key in ("bases", "visits"):
                assert torch.equal(stats[key][k], own_stats[key])
            if k < 2 or k == b - 1:
                check(p[k], table_element(table, k),
                      None if e is None else e[k], chunk, window)
    if b > 2:  # no valid target: idx 0, inf, table row 0
        assert torch.isinf(out[1][2]).all() and (out[2][2] == 0).all()


def test_batched_band_kernel_checks_its_batch(cuda):
    """A batch past gridDim.z, a table of another batch size and an extra
    of other rows raise before any launch."""
    from fpcr_tpu_torch.ops.morton import MortonTable
    from fpcr_tpu_torch.ops.morton_cuda import morton_nn_cuda

    p, table, extra = _band_batch(cuda, 3, 300, 600, 7)
    before = morton_nn_cuda.launches
    with pytest.raises(ValueError, match="batch elements"):
        morton_nn_cuda(p[:2].contiguous(), table)
    with pytest.raises(ValueError, match="extra"):
        morton_nn_cuda(p, table, extra[:, :10].contiguous())
    with pytest.raises(ValueError, match="valid_count"):
        morton_nn_cuda(p, table._replace(
            valid_count=table.valid_count[:1].contiguous()))
    big = MortonTable(*(f[:1].expand((65536,) + tuple(f.shape[1:]))
                        .contiguous() for f in table))
    with pytest.raises(ValueError, match="gridDim.z"):
        morton_nn_cuda(p[:1].expand(65536, 300, 3).contiguous(), big)
    assert morton_nn_cuda.launches == before


@pytest.mark.parametrize("kw", [
    dict(matcher="morton", morton_chunk=512, morton_window=64),
    dict(matcher="morton", morton_chunk=512, morton_window=64,
         pallas_mode="packed6_idx", morton_shifts=2, morton_rescue=64),
    dict(metric="symmetric", matcher="pallas"),
    dict(metric="gicp", matcher="pallas"),
    dict(matcher="grid"),
    dict(metric="plane", matcher="pallas")], ids=[
        "morton", "morton-packed-shifts-rescue", "symmetric", "gicp", "grid",
        "plane"])
def test_register_batch_every_config_on_card(cuda, kw):
    """``register_batch`` on the card for every newly batched config: one
    batched band launch a shift an iteration (morton), no ``run_icp``,
    every element within one iteration of its own ``run_icp`` on the card
    and its transform within 1e-5 of it."""
    import fpcr_tpu_torch as ft
    from fpcr_tpu_torch.models import icp as mi
    from fpcr_tpu_torch.ops.morton_cuda import (morton_nn_cuda,
                                                morton_nn_packed_cuda)

    s = ft.synthetic_scene(width=64, device=cuda)
    rng = np.random.default_rng(11)
    tgts = torch.stack([ft.gt_transform(tuple(0.01 * rng.standard_normal(3)),
                                        tuple(0.02 * rng.standard_normal(3)),
                                        device=cuda).apply(s.source)
                        for _ in range(4)])
    srcs = torch.stack([s.source] * 4)
    cfg = ft.ICPConfig(max_iterations=20, **kw)
    saved = mi.run_icp
    mi.run_icp = None  # register_batch must not reach it
    try:
        before = morton_nn_cuda.launches + morton_nn_packed_cuda.launches
        res = ft.register_batch(srcs, tgts, cfg)
        torch.cuda.synchronize()
        band = (morton_nn_cuda.launches + morton_nn_packed_cuda.launches
                - before)
    finally:
        mi.run_icp = saved
    passes = -(-int(res.num_iterations.max()) // 8) * 8
    if cfg.matcher == "morton":
        assert band == cfg.morton_shifts * min(passes, 20)
    else:
        assert band == 0
    for k in range(4):
        one = ft.run_icp(srcs[k], tgts[k], cfg)
        assert abs(int(res.num_iterations[k]) - int(one.num_iterations)) <= 1
        assert float(ft.transform_rmse(
            ft.RigidTransform(res.transform.rotation[k],
                              res.transform.translation[k]),
            one.transform, s.source)) < 1e-5
        torch.testing.assert_close(res.points[k], one.points, atol=1e-4,
                                   rtol=0)


def test_register_ndt_numpy_clouds_on_card(cuda):
    """numpy clouds go to the card through ``as_points`` and register to
    the exact-ICP contract (the scene of
    ``tests/test_torch_ndt.py::test_register_ndt_large_displacement``)."""
    import fpcr_tpu_torch as ft

    scene = ft.synthetic_scene(width=48, device="cpu")
    gt = ft.gt_transform((0.25, -0.2, 0.15), (0.3, -0.25, 0.2), device="cpu")
    src, tgt = scene.source.numpy(), gt.apply(scene.source).numpy()
    res = ft.register_ndt(src, tgt, ft.ICPConfig(max_iterations=40))
    assert res.transform.rotation.device.type == "cuda"
    tr = ft.RigidTransform(res.transform.rotation.cpu(),
                           res.transform.translation.cpu())
    assert float(ft.transform_rmse(tr, gt, scene.source)) < 1e-5


# --- K1 and K2 on the tensor cores (csrc/nn_tc.cu) against their CUDA-core
# sweep, bit for bit --------------------------------------------------------

TC_CASES = ["synthetic-16384", "bunny-8171", "bunny-full-35947", "hall-16384",
            "e1-300", "duplicates", "masked", "all-masked", "200x1048576"]


def _tc_case(cuda, name):
    """``(p, q, mask)`` of one input of the tensor-core checks."""
    import fpcr_tpu_torch as ft
    from fpcr_tpu_torch.bench import match_kernels

    rng = np.random.default_rng(len(name))
    t = lambda a: torch.as_tensor(a, device=cuda)  # noqa: E731
    scenes = {"synthetic-16384": lambda: ft.synthetic_scene(width=128,
                                                            device=cuda),
              "bunny-8171": lambda: ft.bunny_scene(device=cuda),
              "bunny-full-35947": lambda: ft.bunny_scene(resampled=False,
                                                         device=cuda),
              "hall-16384": lambda: ft.hall_scene(device=cuda)}
    if name in scenes:
        s = scenes[name]()
        return s.source, s.target, None
    if name == "e1-300":
        return (*match_kernels.study_inputs(16384, cuda), None)
    if name == "duplicates":
        dup = np.repeat(_cloud(rng, 37), 27, axis=0)
        near = dup[rng.integers(0, 999, 700)] + rng.normal(
            scale=1e-3, size=(700, 3)).astype(np.float32)
        return t(near.astype(np.float32)), t(dup), None
    if name in ("masked", "all-masked"):
        keep = 0.3 if name == "masked" else 0.0
        mask = t(rng.uniform(size=3000) < keep)
        return t(_cloud(rng, 500)), t(_cloud(rng, 3000)), mask
    big = _cloud(rng, 1 << 20)
    rows = big[rng.integers(0, 1 << 20, 200)] + 1e-3
    return t(rows.astype(np.float32)), t(big), None


@pytest.mark.parametrize("packed", [False, True], ids=["K1", "K2"])
@pytest.mark.parametrize("name", TC_CASES)
def test_tc_kernel_equals_cudacore(cuda, name, packed):
    """Index and distance bits equal to the CUDA-core sweep, two launches
    a call, and no host synchronisation inside the call."""
    from fpcr_tpu_torch.ops import matching_cuda as mc
    from fpcr_tpu_torch.ops.matching import packed_idx_bits

    p, q, mask = _tc_case(cuda, name)
    m = q.shape[0]
    bits = packed_idx_bits(m) if m <= 1 << 16 else (m - 1).bit_length()
    if packed:
        wrapper, core = mc.nn_argmin_packed_cuda, mc._nn_argmin_packed_cudacore
        kw = dict(idx_bits=bits)
    else:
        wrapper, core, kw = mc.nn_argmin_cuda, mc._nn_argmin_cudacore, {}
    torch.cuda.synchronize()
    before = wrapper.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = wrapper(p, q, mask, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert wrapper.launches - before == 2
    want = core(p, q, mask, **kw)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))


def test_tc_rescued_rows_are_counted(cuda):
    """Every row of an all-masked target is rescued and counted; a clear
    nearest neighbour is not."""
    from fpcr_tpu_torch.ops import matching_cuda as mc

    p, q, mask = _tc_case(cuda, "all-masked")
    mc.reset_rescued(cuda)
    mc.nn_argmin_cuda(p, q, mask)
    mc.nn_argmin_packed_cuda(p, q, mask, idx_bits=12)
    assert mc.rescued_rows(cuda) == (p.shape[0], p.shape[0])
    mc.reset_rescued(cuda)
    q = torch.tensor([[0.0, 0.0, 0.0], [5.0, 5.0, 5.0]], device=cuda)
    idx, d = mc.nn_argmin_cuda(torch.zeros((4, 3), device=cuda) + 0.1, q)
    assert (idx == 0).all() and mc.rescued_rows(cuda)[0] == 0


@pytest.mark.parametrize("name", ["synthetic-16384", "bunny-8171",
                                  "hall-16384", "e1-300"])
def test_tc_guard_holds_on_card(cuda, name):
    """One tile of the sweep's values, as the tensor cores summed them,
    within a quarter of each pair's guard G of the float64 distance."""
    from fpcr_tpu_torch.ops import matching_cuda as mc
    from fpcr_tpu_torch.ops.matching import CERT_GUARD

    p, q, _ = _tc_case(cuda, name)
    d, centre = mc._nn_tc_tile_values(p, q)
    exact = ((p.double()[:, None, :] - q[:64].double()[None]) ** 2).sum(-1)
    pn = (p - centre).double().norm(dim=1)
    qn = (q[:64][None] - centre[:, None]).double().norm(dim=2)
    ratio = ((d.double() - exact).abs()
             / (CERT_GUARD * (pn[:, None] + qn) ** 2)).max()
    print(f"{name}: largest |d~ - d64| / G {float(ratio):.4f}")
    assert float(ratio) <= 0.25


# --- GICP, the loop variants and the voxel grid on the card against the
# port on the CPU ----------------------------------------------------------

SLICE_BAND = dict(morton_chunk=512, morton_window=64)


def _slice_inputs(name):
    """``(source, target, normals {name: [N, 3]}, config fields)`` on the
    CPU; the normals are estimated once on the CPU and handed to both runs,
    so the two devices' kNN near-ties on the regular grid cannot differ."""
    import fpcr_tpu_torch as ft

    if name.startswith("grid") or name == "gicp-morton":
        src = ft.surface_grid(64, device="cpu")
        gt = ft.gt_transform((0.004, -0.003, 0.002), (0.003, -0.002, 0.004),
                             device="cpu")
        tgt = gt.apply(src)
    elif name == "scaled":
        src = ft.data.synthetic.random_cloud(1500, seed=11, scale=2.0,
                                             device="cpu")
        gt = ft.gt_transform((0.01, -0.02, 0.015), (0.01, -0.008, 0.012),
                             device="cpu")
        tgt = 1.04 * gt.apply(src)
    else:
        s = ft.synthetic_scene(width=32, device="cpu")
        src, tgt = s.source, s.target
    kw = {"gicp": dict(metric="gicp", matcher="pallas"),
          "gicp-morton": dict(metric="gicp", matcher="morton",
                              morton_impl="pallas", max_iterations=25,
                              **SLICE_BAND),
          "aa-point": dict(matcher="pallas"),
          "aa-plane": dict(metric="plane", matcher="pallas"),
          "scaled": dict(matcher="pallas", max_iterations=60),
          "grid": dict(matcher="grid", grid_cap=16, max_iterations=30),
          "grid-gicp": dict(metric="gicp", matcher="grid", grid_cap=16,
                            max_iterations=30)}[name]
    kw.setdefault("max_iterations", 40)
    if kw["matcher"] != "morton":
        kw["exact_distances"] = True  # the plain version's difference form
    normals = {}
    if kw.get("metric") in ("gicp", "plane"):
        normals["target_normals"] = ft.estimate_normals(tgt)
    if kw.get("metric") == "gicp":
        normals["source_normals"] = ft.estimate_normals(src)
    return src, tgt, normals, kw


def _slice_run(name, src, tgt, normals, kw):
    import fpcr_tpu_torch as ft

    cfg = ft.ICPConfig(**kw)
    if name.startswith("aa"):
        return ft.run_aa_icp(src, tgt, cfg,
                             target_normals=normals.get("target_normals"))
    if name == "scaled":
        return ft.run_scaled_icp(src, tgt, cfg)
    return ft.run_icp(src, tgt, cfg, **normals)


@pytest.mark.parametrize("name", ["gicp", "gicp-morton", "aa-point",
                                  "aa-plane", "scaled", "grid", "grid-gicp"])
def test_slice_paths_on_card_match_cpu(cuda, name):
    """Each new path registered on the card (K1, K3 or the grid) and on
    the CPU (their plain versions): iteration counts within 1, transforms
    within 1e-5 RMSE of each other, errors within 1e-5."""
    import fpcr_tpu_torch as ft

    src, tgt, normals, kw = _slice_inputs(name)
    on = lambda d: {k: v.to(d) for k, v in normals.items()}  # noqa: E731
    r_c = _slice_run(name, src, tgt, on("cpu"), kw)
    r_g = _slice_run(name, src.to(cuda), tgt.to(cuda), on(cuda), kw)
    assert r_g.transform.rotation.device.type == "cuda"
    n_c, n_g = int(r_c.num_iterations), int(r_g.num_iterations)
    assert abs(n_c - n_g) <= 1, (n_c, n_g)
    tr = ft.RigidTransform(r_g.transform.rotation.cpu(),
                           r_g.transform.translation.cpu())
    assert float(ft.transform_rmse(tr, r_c.transform, src)) < 1e-5
    k = min(n_c, n_g)
    torch.testing.assert_close(r_g.errors.cpu()[:k], r_c.errors[:k],
                               rtol=0, atol=1e-5)
    if name == "scaled":
        assert abs(float(r_g.scale) - float(r_c.scale)) < 1e-6
        assert abs(float(r_g.scale) - 1.04) < 1e-3


def test_sgd_loop_on_card_matches_cpu(cuda):
    """``_sgd_loop`` fed the same batches on both devices (the generators'
    streams differ between devices), and ``run_sgd_icp``'s own draw on the
    card, reproducible per seed."""
    import fpcr_tpu_torch as ft
    from fpcr_tpu_torch.models.sgd_icp import _sgd_loop

    s = ft.synthetic_scene(width=32, device="cpu")
    rng = np.random.default_rng(0)
    draws = [torch.as_tensor(rng.integers(0, 1024, 256)) for _ in range(300)]
    cfg = ft.ICPConfig(max_iterations=300, tolerance=1e-6)
    kw = dict(batch_size=256, learning_rate=0.2, momentum=0.7, ema=0.9,
              lr_decay=0.02)
    r_c = _sgd_loop(s.source, s.target, cfg, lambda it: draws[it], **kw)
    r_g = _sgd_loop(s.source.to(cuda), s.target.to(cuda), cfg,
                    lambda it: draws[it].to(cuda), **kw)
    assert abs(int(r_c.num_iterations) - int(r_g.num_iterations)) <= 1
    tr = ft.RigidTransform(r_g.transform.rotation.cpu(),
                           r_g.transform.translation.cpu())
    assert float(ft.transform_rmse(tr, r_c.transform, s.source)) < 1e-5
    a = ft.run_sgd_icp(s.source.to(cuda), s.target.to(cuda), cfg,
                       batch_size=256, seed=3)
    b = ft.run_sgd_icp(s.source.to(cuda), s.target.to(cuda), cfg,
                       batch_size=256, seed=3)
    assert torch.equal(a.transform.rotation, b.transform.rotation)
    gt = ft.RigidTransform(s.ground_truth.rotation.to(cuda),
                           s.ground_truth.translation.to(cuda))
    assert float(ft.transform_rmse(a.transform, gt, s.source.to(cuda))) < 1e-4


@pytest.mark.parametrize("cap", [4, 16])
def test_grid_nn_equal_on_both_devices(cuda, cap):
    """The voxel table bit for bit, and ``grid_nn``'s ``idx`` and
    ``found`` equal on the card and the CPU, through several chunks, with
    a masked target, duplicates and unreachable queries."""
    from fpcr_tpu_torch.ops.grid import build_voxel_table, grid_nn

    rng = np.random.default_rng(cap)
    q = np.concatenate([rng.uniform(-2, 2, (20000, 3)),
                        np.repeat(rng.uniform(-2, 2, (40, 3)), 25, axis=0)])
    q = torch.as_tensor(q.astype(np.float32))
    mask = torch.as_tensor(rng.uniform(size=q.shape[0]) < 0.8)
    p = q[torch.as_tensor(rng.integers(0, q.shape[0], 30000))]
    p = torch.cat([p + 0.01 * torch.as_tensor(rng.normal(size=p.shape)
                                              .astype(np.float32)),
                   torch.full((7, 3), 90.0)])
    t_c = build_voxel_table(q, 0.15, q_mask=mask)
    t_g = build_voxel_table(q.to(cuda), 0.15, q_mask=mask.to(cuda))
    for a, b in zip(t_c[:5], t_g[:5]):
        assert torch.equal(a, b.cpu())
    i_c, d_c, f_c = grid_nn(p, t_c, cap=cap, chunk=8192)
    i_g, d_g, f_g = grid_nn(p.to(cuda), t_g, cap=cap, chunk=8192)
    assert torch.equal(i_g.cpu(), i_c) and torch.equal(f_g.cpu(), f_c)
    torch.testing.assert_close(d_g.cpu(), d_c, rtol=1e-6, atol=0)
    assert not f_g[-7:].any()


def test_voxel_downsample_deterministic_on_card(cuda):
    """Two card runs bit-equal (segment sums, no atomics), and equal to
    the CPU's within float32 rounding."""
    import fpcr_tpu_torch as ft

    pts = ft.surface_grid(256, device=cuda)
    mask = torch.arange(pts.shape[0], device=cuda) % 7 != 0
    a = ft.voxel_downsample(pts, 0.05, mask)
    b = ft.voxel_downsample(pts, 0.05, mask)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    c = ft.voxel_downsample(pts.cpu(), 0.05, mask.cpu())
    assert torch.equal(a[1].cpu(), c[1])
    torch.testing.assert_close(a[0].cpu(), c[0], rtol=1e-6, atol=1e-7)


def test_evaluate_registration_and_profile_on_card(cuda):
    import fpcr_tpu_torch as ft

    s = ft.synthetic_scene(width=32, device="cpu")
    far = torch.full((100, 3), 9.0)
    src = torch.cat([s.source, far])
    e_c = ft.evaluate_registration(src, s.target, s.ground_truth)
    gt = ft.RigidTransform(s.ground_truth.rotation.to(cuda),
                           s.ground_truth.translation.to(cuda))
    e_g = ft.evaluate_registration(src.to(cuda), s.target.to(cuda), gt)
    assert int(e_g["num_inliers"]) == int(e_c["num_inliers"]) == 1024
    for k in ("fitness", "inlier_rmse", "max_correspondence_dist"):
        assert e_g[k].device.type == "cuda"
        torch.testing.assert_close(e_g[k].cpu(), e_c[k], rtol=1e-5,
                                   atol=1e-6)
    timer = ft.profile_icp(s.source.to(cuda), s.target.to(cuda),
                           ft.ICPConfig(metric="plane"), iterations=3)
    assert timer.device.type == "cuda"
    assert list(timer.totals) == ["normals", "matching", "gather",
                                  "minimization", "transformation", "error"]
    assert all(v > 0 for v in timer.as_dict().values())


def _gn_loop(run):
    """The pose graph's Gauss-Newton loop of ``run`` (a partial of
    ``optimize_pose_graph``) alone, its constants prebuilt (the segment
    plans read their sizes on the host before the loop): ``run()`` ->
    ``(X, rows, iterations)``."""
    from fpcr_tpu_torch.models import pose_graph as pg
    from fpcr_tpu_torch.models.icp import drive_chunks

    X, ei, ej, Z, w = run.args
    consts = pg._gn_consts(X, ei, ej, Z, w, 1e-6, 1e6)
    n = run.keywords["iterations"]

    def loop():
        (poses,), rows = drive_chunks(pg._gn_chunk, (X,), consts, n,
                                      lambda st: False, (1,))
        return poses, rows, torch.full((), n)
    return loop


def _sync_case(cuda, name):
    """``(run, wrapper, expected launches of wrapper)`` of eight iterations
    of ``name``, normals and tables prebuilt."""
    import functools

    import fpcr_tpu_torch as ft
    from fpcr_tpu_torch.models.icp import build_matcher_state
    from fpcr_tpu_torch.ops import matching_cuda as mc
    from fpcr_tpu_torch.ops.morton_cuda import morton_nn_cuda
    from fpcr_tpu_torch.ops.ndt_cuda import ndt_fused_moments_cuda
    from fpcr_tpu_torch.ops.svd3_cuda import svd3_rotation_cuda

    if name in ("gicp", "aa-plane", "grid-gicp"):
        src, tgt, normals, kw = _slice_inputs(name)
        kw["max_iterations"] = 8
        src, tgt = src.to(cuda), tgt.to(cuda)
        normals = {k: v.to(cuda) for k, v in normals.items()}
        cfg = ft.ICPConfig(**kw)
        if name.startswith("aa"):
            run = functools.partial(ft.run_aa_icp, src, tgt, cfg, **normals)
        else:
            run = functools.partial(
                ft.run_icp, src, tgt, cfg, **normals,
                matcher_state=build_matcher_state(tgt, None, cfg))
        return run, mc.nn_argmin_cuda, {"gicp": 16, "aa-plane": 48,
                                        "grid-gicp": 0}[name]
    s = ft.synthetic_scene(width=64, device=cuda)
    eight = dict(max_iterations=8, tolerance=0.0)
    if name in ("point-k1", "point-k2"):
        packed = name == "point-k2"
        cfg = ft.ICPConfig(matcher="pallas", **eight, **(
            dict(pallas_mode="packed6_idx") if packed else {}))
        run = functools.partial(ft.run_icp, s.source, s.target, cfg)
        wrapper = mc.nn_argmin_packed_cuda if packed else mc.nn_argmin_cuda
        return run, wrapper, 16
    if name in ("scaled", "sgd", "history", "pose-graph", "ransac"):
        from fpcr_tpu_torch.ops.svd3_cuda import (svd3_rotation_cuda,
                                                  svd3_umeyama_cuda)

        run = _variant_case(cuda, {"scaled": "scaled-k1",
                                   "history": "history-k1",
                                   "pose-graph": "pose-graph-full"}.get(
                                       name, name), 0.0)
        if name == "scaled":
            return (functools.partial(
                ft.run_scaled_icp, *run.args[:2], ft.ICPConfig(
                    matcher="pallas", **eight)), svd3_umeyama_cuda, 8)
        if name == "sgd":
            return (functools.partial(
                ft.run_sgd_icp, s.source, s.target, ft.ICPConfig(**eight),
                batch_size=512, seed=0), mc.nn_argmin_cuda, 16)
        if name == "history":
            return (functools.partial(
                ft.run_icp_with_history, s.source, s.target,
                ft.ICPConfig(matcher="pallas", **eight)), mc.nn_argmin_cuda,
                16)
        if name == "pose-graph":
            return _gn_loop(run), svd3_rotation_cuda, 0
        return run, svd3_rotation_cuda, 4
    if name == "point-svd3":
        cfg = ft.ICPConfig(matcher="pallas", **eight)
        return (functools.partial(ft.run_icp, s.source, s.target, cfg),
                svd3_rotation_cuda, 8)
    if name == "morton":
        g = ft.surface_grid(128, device=cuda)
        tgt = ft.gt_transform((0.004, -0.003, 0.002), (0.003, -0.002, 0.004),
                              device=cuda).apply(g)
        cfg = ft.ICPConfig(matcher="morton", morton_chunk=512,
                           morton_window=64, **eight)
        return (functools.partial(
            ft.run_icp, g, tgt, cfg,
            matcher_state=build_matcher_state(tgt, None, cfg)),
            morton_nn_cuda, 8)
    if name == "ndt":
        from fpcr_tpu_torch.models import ndt as mn

        scan, grid, _ = _ndt_case(cuda, 65536, 3)  # voxel-key-sorted
        cfg = ft.resolve_ndt_config(ft.NDTConfig(voxel_size=0.25, **eight),
                                    grid, scan)
        assert cfg.lookup == "banded" and cfg.lookup_impl == "pallas"
        return (functools.partial(mn._ndt_loop, scan, grid, cfg),
                ndt_fused_moments_cuda, 8)
    assert name in ("batch-k1", "batch-k2")
    packed = name == "batch-k2"
    srcs = torch.stack([s.source] * 4)
    tgts = torch.stack([s.target + 0.01 * k for k in range(4)])
    cfg = ft.ICPConfig(matcher="pallas", **eight, **(
        dict(pallas_mode="packed6_idx") if packed else {}))
    wrapper = mc.nn_argmin_packed_cuda if packed else mc.nn_argmin_cuda
    return (functools.partial(ft.register_batch, srcs, tgts, cfg), wrapper,
            16)


@pytest.mark.parametrize("name", ["gicp", "aa-plane", "grid-gicp",
                                  "point-k1", "point-k2", "point-svd3",
                                  "morton", "ndt", "batch-k1", "batch-k2",
                                  "scaled", "sgd", "history", "pose-graph",
                                  "ransac"])
def test_no_host_sync_in_slice_iterations(cuda, name):
    """Eight iterations of GICP (K1), AA-ICP (K1 three times an iteration),
    grid GICP, point ICP through K1 and K2 (and svd3), Morton ICP (K3), NDT
    (K4), ``register_batch`` through K1 and K2, scaled ICP (svd3's Umeyama
    form), SGD-ICP and history (K1), normals and tables prebuilt, and the
    pose graph's 13 Gauss-Newton iterations and RANSAC (svd3 once for the
    hypotheses and once a refine round) whole, under
    ``torch.cuda.set_sync_debug_mode("error")``: nothing
    in an iteration waits for the card; the host reads ``done`` once per 8
    iterations, which 8 iterations never reach. The loops that run as
    captured graphs are captured outside the window, by a second call (the
    first of a key runs eagerly; a capture synchronises once, as a compile
    does); the counts are the third call's, one replay's."""
    run, wrapper, expected = _sync_case(cuda, name)
    run()
    run()
    torch.cuda.synchronize()
    before = wrapper.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert wrapper.launches - before == expected
    # the iterations (``_ndt_loop``'s third value), or RANSAC's inliers
    count = getattr(res, "num_iterations", None)
    assert int((res[2] if count is None else count).min()) >= 1


GRAPH_PATHS = ["point-k1", "point-k2", "plane-k1", "morton-k3",
               "morton-k3p", "gicp", "grid", "ndt", "batch-k1", "batch-k2",
               "aa-point", "aa-plane", "scaled-k1", "scaled-k2", "sgd",
               "history-k1", "history-k2", "history-morton", "pose-graph",
               "pose-graph-full", "ransac"]


def _variant_case(cuda, name, shift):
    """``run()`` of one loop variant on the card (21 iterations where the
    loop has a count), its inputs moved by ``shift``."""
    import functools

    import fpcr_tpu_torch as ft
    from fpcr_tpu_torch.models import global_reg as gr

    s = ft.synthetic_scene(width=64, device=cuda)
    src, tgt = s.source, s.target + shift
    cfg = ft.ICPConfig(max_iterations=21, matcher="pallas")
    packed = ft.ICPConfig(max_iterations=21, matcher="pallas",
                          pallas_mode="packed6_idx")
    if name.startswith("aa"):
        metric = name.split("-")[1]
        return functools.partial(ft.run_aa_icp, src, tgt, ft.ICPConfig(
            metric=metric, max_iterations=21, matcher="pallas"))
    if name.startswith("scaled"):
        rng = np.random.default_rng(11)
        vs = torch.as_tensor(rng.uniform(-2, 2, (4096, 3)).astype(
            np.float32), device=cuda)
        vt = 1.04 * ft.gt_transform((0.01, -0.02, 0.015),
                                    (0.01, -0.008, 0.012),
                                    device=cuda).apply(vs) + shift
        return functools.partial(ft.run_scaled_icp, vs, vt,
                                 packed if name.endswith("k2") else cfg)
    if name == "sgd":
        return functools.partial(ft.run_sgd_icp, src, tgt, ft.ICPConfig(
            max_iterations=21, tolerance=1e-6), batch_size=512, seed=0)
    if name == "history-morton":
        g = ft.surface_grid(128, device=cuda)
        gt = ft.gt_transform((0.004, -0.003, 0.002), (0.003, -0.002, 0.004),
                             device=cuda)
        return functools.partial(ft.run_icp_with_history, g,
                                 gt.apply(g) + shift, ft.ICPConfig(
                                     matcher="morton", morton_chunk=512,
                                     morton_window=64, max_iterations=21))
    if name.startswith("history"):
        return functools.partial(ft.run_icp_with_history, src, tgt,
                                 packed if name.endswith("k2") else cfg)
    if name.startswith("pose-graph"):
        from fpcr_tpu_torch.models import pose_graph as pg

        rng = np.random.default_rng(0)
        T = 10
        xi = torch.as_tensor(rng.normal(0, 0.1, (T, 6)).astype(np.float32),
                             device=cuda)
        X = pg.se3_exp(xi)
        ei = torch.as_tensor(list(range(T - 1)) + [0, 2], device=cuda)
        ej = torch.as_tensor(list(range(1, T)) + [T - 1, T - 3], device=cuda)
        Z = torch.matmul(pg.se3_inv(X[ei]), X[ej]) + shift
        w = (torch.eye(6, device=cuda) * 2.0).expand(len(ei), 6, 6) if (
            name.endswith("full")) else None
        return functools.partial(ft.optimize_pose_graph, X, ei, ej, Z, w,
                                 iterations=13)
    assert name == "ransac"
    rng = np.random.default_rng(1)
    p = torch.as_tensor(rng.uniform(-1, 1, (2000, 3)).astype(np.float32),
                        device=cuda)
    q = ft.gt_transform((0.3, -0.2, 0.5), (0.1, 0.2, -0.3),
                        device=cuda).apply(p) + shift
    good = torch.as_tensor(rng.uniform(size=2000) < 0.6, device=cuda)
    q = torch.where(good[:, None], q, -q)
    samples = torch.as_tensor(rng.integers(0, 2000, (1024, 3)), device=cuda)
    return functools.partial(gr._ransac, p, q, good, samples,
                             torch.tensor(0.02, device=cuda), 3)


def _graph_case(cuda, name, shift=0.0):
    """``run()`` of one registration of ``name`` on the card, its target
    moved by ``shift`` (another input of the same shapes)."""
    import functools

    import fpcr_tpu_torch as ft

    if name in GRAPH_PATHS[10:]:
        return _variant_case(cuda, name, shift)
    s = ft.synthetic_scene(width=64, device=cuda)
    src, tgt = s.source, s.target + shift
    if name in ("point-k1", "point-k2", "plane-k1", "gicp", "grid"):
        kw = {"point-k1": dict(matcher="pallas"),
              "point-k2": dict(matcher="pallas", pallas_mode="packed6_idx"),
              "plane-k1": dict(metric="plane", matcher="pallas"),
              "gicp": dict(metric="gicp", matcher="pallas"),
              "grid": dict(matcher="grid", grid_cap=16)}[name]
        return functools.partial(ft.run_icp, src, tgt,
                                 ft.ICPConfig(max_iterations=21, **kw))
    if name.startswith("morton"):
        g = ft.surface_grid(128, device=cuda)
        tgt = ft.gt_transform((0.004, -0.003, 0.002), (0.003, -0.002, 0.004),
                              device=cuda).apply(g) + shift
        kw = dict(pallas_mode="packed6_idx") if name.endswith("p") else {}
        return functools.partial(ft.run_icp, g, tgt, ft.ICPConfig(
            matcher="morton", morton_chunk=512, morton_window=64,
            max_iterations=21, **kw))
    if name == "ndt":
        scan, grid, _ = _ndt_case(cuda, 65536, 3)
        cfg = ft.resolve_ndt_config(ft.NDTConfig(voxel_size=0.25,
                                                 max_iterations=21),
                                    grid, scan)
        return functools.partial(ft.run_ndt, scan + 0.01 + shift, None, cfg,
                                 grid=grid)
    packed = name == "batch-k2"
    srcs = torch.stack([src] * 5)
    tgts = torch.stack([tgt + 0.02 * k for k in range(5)])
    return functools.partial(ft.register_batch, srcs, tgts, ft.ICPConfig(
        matcher="pallas", max_iterations=21,
        **(dict(pallas_mode="packed6_idx") if packed else {})))


def _result_bits(res):
    out = []
    for x in res:
        for t in (x if isinstance(x, tuple) else (x,)):
            t = t.contiguous()
            out.append(t.view(torch.int32) if t.dtype == torch.float32
                       else t)
    return out


def _launch_counts():
    from fpcr_tpu_torch import _build

    return [dict(f.launches) if isinstance(f.launches, dict) else f.launches
            for f in _build.COUNTED]


@pytest.mark.parametrize("name", GRAPH_PATHS)
def test_captured_loop_is_its_eager_run(cuda, name):
    """Each path of the captured loops (``utils/graphs.py``) against its
    eager run on the card: bit for bit in every field (21 iterations, so a
    chunk of 8 and a shorter last one) on the key's first call (eager,
    nothing captured), the call that captures and the call that replays,
    every kernel's launches those of the eager run on each, and a result
    held by the caller unchanged by the next calls, one on other inputs of
    the same shapes, which replays with its own inputs: its eager run's
    bits."""
    from fpcr_tpu_torch.utils import graphs

    graphs.clear()
    run = _graph_case(cuda, name)
    c0 = _launch_counts()
    with graphs.eager():
        ref = run()
    c1 = _launch_counts()
    first = run()
    c2 = _launch_counts()
    assert len(graphs.CACHE) == 0
    second = run()
    c3 = _launch_counts()
    assert len(graphs.CACHE) >= 1
    kept = [t.clone() for t in _result_bits(second)]
    again = run()
    c4 = _launch_counts()
    moved = _graph_case(cuda, name, shift=0.05)()
    with graphs.eager():
        moved_ref = _graph_case(cuda, name, shift=0.05)()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(
        _result_bits(moved), _result_bits(moved_ref)))
    for a, b, c, d, k in zip(_result_bits(ref), _result_bits(first),
                             _result_bits(second), _result_bits(again), kept):
        assert (torch.equal(a, b) and torch.equal(a, c) and torch.equal(a, d)
                and torch.equal(c, k))
    assert not all(torch.equal(a, b) for a, b in zip(
        _result_bits(moved), _result_bits(second)))

    def diff(x, y):
        return [({k: v - y[i].get(k, 0) for k, v in a.items()}
                 if isinstance(a, dict) else a - y[i])
                for i, a in enumerate(x)]
    assert (diff(c1, c0) == diff(c2, c1) == diff(c3, c2)
            == diff(c4, c3))
    # the pose graph launches no kernel of the port's
    assert name.startswith("pose-graph") or any(
        d if isinstance(d, int) else any(d.values()) for d in diff(c1, c0))


def test_captured_loop_under_debug_nans_runs_eagerly(cuda):
    """Under ``debug_nans`` the loop runs eagerly (its check reads every
    iteration's error): nothing is captured, and the result is the
    captured loop's."""
    from fpcr_tpu_torch.utils import diagnostics, graphs

    graphs.clear()
    run = _graph_case(cuda, "point-k1")
    with diagnostics.debug_nans():
        checked = run()
    assert len(graphs.CACHE) == 0
    run()  # the key's first loop, eager
    for a, b in zip(_result_bits(checked), _result_bits(run())):
        assert torch.equal(a, b)
    assert len(graphs.CACHE) >= 1


def _chunk_trajectory(chunk, state, consts, n):
    """The states before each of ``n`` eager iterations of ``chunk`` from
    ``state``, and after the last: ``[S_0, ..., S_n]``."""
    from fpcr_tpu_torch.utils import graphs

    states = [graphs.owned(state)]
    for _ in range(n):
        state, _ = chunk(graphs.owned(state), consts, 1)
        states.append(graphs.owned(state))
    return states


def _skipped_chunk_case(cuda, batch):
    """``(consts, cases)`` of point ICP through K1 (a batch of ``batch``
    where it is over 1): the chunk's constants, and ``{name: (state,
    bodies run)}`` for a state whose loop stops at a chunk's third
    iteration, one already done and a live one; the key captured."""
    import fpcr_tpu_torch as ft
    from fpcr_tpu_torch.models import batch as mb
    from fpcr_tpu_torch.models import icp as mi
    from fpcr_tpu_torch.utils import graphs

    s = ft.synthetic_scene(width=64, device=cuda)
    cfg = ft.ICPConfig(matcher="pallas", max_iterations=0)
    poses = [((0.2, -0.1, 0.15), (0.1, 0.05, -0.1)),
             ((0.1, 0.12, -0.05), (-0.05, 0.1, 0.05)),
             ((-0.15, 0.05, 0.1), (0.05, -0.1, 0.08))][:batch]
    srcs = torch.stack([ft.gt_transform(r, t, device=cuda).apply(s.source)
                        for r, t in poses]).contiguous()
    if batch == 1:
        state = mi._ICPState(srcs[0].contiguous(), None,
                             torch.eye(3, device=cuda),
                             torch.zeros(3, device=cuda),
                             torch.full((), float("inf"), device=cuda),
                             torch.zeros((), dtype=torch.bool, device=cuda),
                             torch.zeros((), dtype=torch.int32, device=cuda))
        consts = (s.target.contiguous(), None, None, None, None, cfg, None)
    else:
        state = mb._first_state(srcs, None)
        consts = (s.target.expand(batch, -1, -1).contiguous(), None, None,
                  None, None, cfg, None)
    traj = _chunk_trajectory(mi._icp_chunk, state, consts, 60)
    stop = next(j for j, st in enumerate(traj) if bool(st.done.all()))
    assert stop > 8, stop  # the live state runs every body of a chunk
    graphs.clear()
    graphs.bind(mi._icp_chunk, consts)(traj[0], 8)  # the key's first: eager
    graphs.bind(mi._icp_chunk, consts)(traj[0], 8)  # captures
    assert graphs.CACHE.captures[-1]["blocks"] == 8
    return consts, {"stops at 3": (traj[stop - 3], 3),
                    "done": (traj[stop], 0), "live": (traj[0], 8)}


def _replay_chunk(consts, start):
    """One replay of the key's chunk from ``start``, recorded: ``((state,
    rows), the call's counts)``."""
    from fpcr_tpu_torch.models import icp as mi
    from fpcr_tpu_torch.utils import graphs, timing

    with timing.recording(), timing.call("chunk") as call:
        loop = graphs.bind(mi._icp_chunk, consts)
        replays = graphs.CACHE.replays
        out = loop(start, 8)
        torch.cuda.synchronize()
        loop.finish()
    assert graphs.CACHE.replays == replays + 1
    return out, call.attrs


def _k1_events_of_replays(batch):
    """``{case: [K1 device events of each profiled replay]}``, for the cases
    of :func:`_skipped_chunk_case`: sessions padded by spin kernels,
    retaken (up to five) until one shows two a body run, since a session
    can lose events at its edges, never add any. Run in a process of its
    own: in one that has run many graphs, the profiler loses and misnames
    the kernels of conditional bodies."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    consts, cases = _skipped_chunk_case(torch.device("cuda", 0), batch)
    out = {}
    for name, (start, executed) in cases.items():
        counts = out[name] = []
        while len(counts) < 5 and (not counts or counts[-1] != 2 * executed):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                torch.cuda._sleep(1 << 20)
                _replay_chunk(consts, start)
                torch.cuda._sleep(1 << 20)
                torch.cuda.synchronize()
            counts.append(sum(1 for ev in prof.events()
                              if ev.device_type == DeviceType.CUDA
                              and "nn_tc_" in ev.name))
    return out


@pytest.mark.parametrize("batch", [1, 3])
def test_skipped_iterations_are_the_eager_chunk(cuda, batch):
    """A captured point chunk (K1) and a batched one, replayed from a state
    that stops at the chunk's third iteration, one already done and a live
    one: each replay is the eager chunk bit for bit (state and rows, NaN
    after the stop), the call's ``iterations_skipped`` is the chunk's
    iterations after the stop, of ``iterations_run`` 8, and the profiler
    (in a fresh process) shows K1 only in the bodies that ran, two events
    a body."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    from fpcr_tpu_torch.models import icp as mi
    from fpcr_tpu_torch.utils import graphs

    consts, cases = _skipped_chunk_case(cuda, batch)
    for name, (start, executed) in cases.items():
        ref_state, ref_rows = mi._icp_chunk(graphs.owned(start), consts, 8)
        (got_state, got_rows), attrs = _replay_chunk(consts, start)
        got = [t for t in (*got_state, got_rows) if t is not None]
        ref = [t for t in (*ref_state, ref_rows) if t is not None]
        assert len(got) == len(ref) == 7
        assert all(torch.equal(a, b) for a, b in zip(
            _result_bits(got), _result_bits(ref))), name
        assert torch.isnan(got_rows[executed:]).all(), name
        assert int(got_state.num_iterations.max()) == (
            int(start.num_iterations.max()) + executed), name
        assert attrs["iterations_run"] == 8, name
        assert attrs["iterations_skipped"] == 8 - executed, name
    root = Path(__file__).resolve().parents[1]
    child = subprocess.run(
        [sys.executable, "-c", "import json, sys; sys.path[:0] = "
         "['tests', '.']; import test_torch_gpu as t; print('K1', "
         f"json.dumps(t._k1_events_of_replays({batch})))"],
        cwd=root, capture_output=True, text=True, timeout=600)
    assert child.returncode == 0, child.stderr[-3000:]
    counts = json.loads(child.stdout.split("K1 ", 1)[1].splitlines()[0])
    for name, (_, executed) in cases.items():
        assert (max(counts[name]) <= 2 * executed
                and counts[name][-1] == 2 * executed), (name, counts)


def test_failed_capture_raises(cuda):
    """A function that waits for the card cannot be captured: the key's
    first loop runs it eagerly, the second raises at its capture and
    caches nothing, and the card keeps working."""
    from fpcr_tpu_torch.utils import graphs

    def body(state, consts, k):
        return state * float(consts[0].sum())

    cache = graphs.GraphCache()
    x = torch.ones(4, device=cuda)
    assert float(cache.bind(body, (x,))(x, 1).sum()) == 16.0
    with pytest.raises(RuntimeError):
        cache.bind(body, (x,))(x, 1)
    assert len(cache) == 0 and cache.nbytes() == 0
    assert float((x * 2).sum()) == 8.0


SVD3_GAP, SVD3_ATOL, SVD3_F32_REL = 1e-3, 1e-6, 1e-6  # chip_smoke.py's


@pytest.mark.parametrize("det_correction", [True, False])
@pytest.mark.parametrize("b", [1, 32, 1024])
def test_svd3_kernel_against_plain(cuda, b, det_correction):
    """Kernel svd3 against its plain version (``torch.linalg.svd``) in
    float64 and float32 on the card, where R is unique (chip_smoke.py's
    tolerances and reasons): one launch, an orthogonal R, det +1 with the
    det fix; ``rotation_from_svd`` on a CUDA tensor launches it."""
    from fpcr_tpu_torch.ops.solve import (rotation_from_svd,
                                          rotation_from_svd_plain)
    from fpcr_tpu_torch.ops.svd3_cuda import svd3_rotation_cuda

    rng = np.random.default_rng(b)
    W = torch.as_tensor(rng.normal(size=(b, 3, 3)).astype(np.float32),
                        device=cuda)
    before = svd3_rotation_cuda.launches
    got = rotation_from_svd(W, det_correction)
    assert svd3_rotation_cuda.launches == before + 1
    s = torch.linalg.svdvals(W.double())
    gap = s[:, 1] - s[:, 2]
    if not det_correction:
        gap = torch.minimum(gap, s[:, 2])
    sep = gap > SVD3_GAP * s[:, 0]
    assert bool(sep.any())
    p64 = rotation_from_svd_plain(W.double(), det_correction)
    p32 = rotation_from_svd_plain(W, det_correction)
    assert float((got.double() - p64)[sep].abs().max()) < SVD3_ATOL
    d32 = (got - p32).abs().amax(dim=(1, 2))
    assert float((d32 * gap / s[:, 0])[sep].max()) < SVD3_F32_REL
    g = got.double()
    eye = torch.eye(3, device=cuda, dtype=torch.float64)
    assert float((g.transpose(1, 2) @ g - eye).abs().max()) < SVD3_ATOL
    if det_correction:
        assert float((torch.linalg.det(g) - 1).abs().max()) < SVD3_ATOL


def test_svd3_kernel_edges_and_checks(cuda):
    """W = 0 gives the identity, a line's and a plane's W a rotation, a
    non-finite W a NaN R; the wrapper refuses float64, a non-contiguous W
    and a wrong shape without launching."""
    from fpcr_tpu_torch.ops.svd3_cuda import svd3_rotation_cuda

    line = np.outer([1.0, 2.0, -0.5], [0.3, -1.0, 0.8])
    p = np.random.default_rng(1).normal(size=(40, 3)) * [1.0, 0.5, 0.0]
    nan = np.eye(3)
    nan[2, 1] = np.nan
    W = torch.as_tensor(np.stack([np.zeros((3, 3)), line, p.T @ p, nan])
                        .astype(np.float32), device=cuda)
    R = svd3_rotation_cuda(W)
    assert torch.equal(R[0], torch.eye(3, device=cuda))
    assert float((torch.linalg.det(R[1:3].double()) - 1).abs().max()) < 1e-6
    assert bool(R[3].isnan().all())
    before = svd3_rotation_cuda.launches
    for bad in (W.double(), W.transpose(1, 2), W[:, :2]):
        with pytest.raises(ValueError):
            svd3_rotation_cuda(bad)
    assert svd3_rotation_cuda.launches == before


@pytest.mark.parametrize("b", [1, 32, 1024])
def test_svd3_umeyama_against_plain(cuda, b):
    """svd3's Umeyama form against its plain version (``torch.linalg.svd``
    and the sign and scale glue) in float64 and float32 on the card, with
    ``chip_smoke.py``'s tolerances: R as the rotation form's is held and
    bit for bit the rotation form's with the det fix, the trace within
    1e-6 of σ1 of the float64 plain version; one launch, and
    ``umeyama_from_svd`` on a CUDA tensor launches it."""
    from fpcr_tpu_torch.ops.solve import (umeyama_from_svd,
                                          umeyama_from_svd_plain)
    from fpcr_tpu_torch.ops.svd3_cuda import (svd3_rotation_cuda,
                                              svd3_umeyama_cuda)

    rng = np.random.default_rng(b)
    w = rng.normal(size=(b, 3, 3))
    w[::3, 2] *= -1.0  # reflections among them
    W = torch.as_tensor(w.astype(np.float32), device=cuda)
    before = svd3_umeyama_cuda.launches
    R, trace = umeyama_from_svd(W)
    assert svd3_umeyama_cuda.launches == before + 1
    assert torch.equal(R, svd3_rotation_cuda(W, True))
    s = torch.linalg.svdvals(W.double())
    gap = s[:, 1] - s[:, 2]
    sep = gap > SVD3_GAP * s[:, 0]
    R64, t64 = umeyama_from_svd_plain(W.double())
    R32, _ = umeyama_from_svd_plain(W)
    assert float((R.double() - R64)[sep].abs().max()) < SVD3_ATOL
    d32 = (R - R32).abs().amax(dim=(1, 2))
    assert float((d32 * gap / s[:, 0])[sep].max()) < SVD3_F32_REL
    assert float(((trace.double() - t64).abs() / s[:, 0]).max()) < SVD3_ATOL
    assert bool((t64 < s[:, 0] + s[:, 1]).any())  # some d = -1


def test_svd3_umeyama_edges_and_checks(cuda):
    """W = 0 gives the identity and 0, a line's and a plane's W a rotation
    and σ1 + σ2, a non-finite W NaN for both; the wrapper refuses float64,
    a non-contiguous W and a wrong shape without launching."""
    from fpcr_tpu_torch.ops.svd3_cuda import svd3_umeyama_cuda

    line = np.outer([1.0, 2.0, -0.5], [0.3, -1.0, 0.8])
    p = np.random.default_rng(1).normal(size=(40, 3)) * [1.0, 0.5, 0.0]
    nan = np.eye(3)
    nan[2, 1] = np.nan
    w = np.stack([np.zeros((3, 3)), line, p.T @ p, nan])
    W = torch.as_tensor(w.astype(np.float32), device=cuda)
    R, trace = svd3_umeyama_cuda(W)
    assert torch.equal(R[0], torch.eye(3, device=cuda)) and float(trace[0]) == 0
    assert float((torch.linalg.det(R[1:3].double()) - 1).abs().max()) < 1e-6
    s = np.linalg.svd(w[1:3], compute_uv=False)
    np.testing.assert_allclose(trace[1:3].cpu().numpy(), s[:, 0] + s[:, 1],
                               rtol=1e-6)
    assert bool(R[3].isnan().all()) and bool(trace[3].isnan())
    before = svd3_umeyama_cuda.launches
    for bad in (W.double(), W.transpose(1, 2), W[:, :2]):
        with pytest.raises(ValueError):
            svd3_umeyama_cuda(bad)
    assert svd3_umeyama_cuda.launches == before


def _svd3_inputs(b):
    """``[b, 3, 3]`` float32: N(0, 1), every third row's column 2 negated
    (reflections among them), and a third of them scaled by 10^U(-6, 6)."""
    rng = np.random.default_rng(b)
    w = rng.normal(size=(b, 3, 3))
    w[::3, 2] *= -1.0
    w[1::3] *= 10.0 ** rng.uniform(-6, 6, (len(w[1::3]), 1, 1))
    return w.astype(np.float32)


def _svd3_unique(W, det_correction):
    """Where R is unique (chip_smoke.py's rule), as a numpy mask."""
    s = torch.linalg.svdvals(W.double())
    gap = s[:, 1] - s[:, 2]
    if not det_correction:
        gap = torch.minimum(gap, s[:, 2])
    return (gap > SVD3_GAP * s[:, 0]).cpu().numpy()


@pytest.mark.parametrize("det_correction", [True, False])
@pytest.mark.parametrize("b", [1, 32, 1024])
def test_svd3_kernel_against_its_mirror(cuda, b, det_correction):
    """Kernel svd3 against its CPU mirror (``ops/svd3_mirror.py``, the
    design statement for statement) on the same W: within one float32 ulp
    at 1 where R is unique (the card's FMAs and rsqrtf move only the
    float32 sweeps' last bits; both polish to the same float64 R); the
    Umeyama form's trace within 2⁻²² of the mirror's, relative."""
    from fpcr_tpu_torch.ops.svd3_cuda import (svd3_rotation_cuda,
                                              svd3_umeyama_cuda)
    from fpcr_tpu_torch.ops.svd3_mirror import (svd3_rotation_mirror,
                                                svd3_umeyama_mirror)

    w = _svd3_inputs(b)
    W = torch.as_tensor(w, device=cuda)
    sep = _svd3_unique(W, det_correction)
    got = svd3_rotation_cuda(W, det_correction).cpu().numpy()
    mine = svd3_rotation_mirror(w, det_correction)
    np.testing.assert_allclose(got[sep], mine[sep], rtol=0, atol=2.0 ** -23)
    if det_correction:
        _, trace = svd3_umeyama_cuda(W)
        np.testing.assert_allclose(trace.cpu().numpy(),
                                   svd3_umeyama_mirror(w)[1], rtol=2.0 ** -22)


@pytest.mark.parametrize("det_correction", [True, False])
@pytest.mark.parametrize("b", [1, 32, 1024])
def test_svd3_yardstick_against_plain_and_kernel(cuda, b, det_correction):
    """svd3's yardstick (the first design, on no path) against the plain
    version as the kernel is held, and the kernel within 1e-6 of it where R
    is unique; each counts its own launch."""
    from fpcr_tpu_torch.ops.solve import rotation_from_svd_plain
    from fpcr_tpu_torch.ops.svd3_cuda import (_svd3_rotation_fixed,
                                              _svd3_umeyama_fixed,
                                              svd3_rotation_cuda,
                                              svd3_umeyama_cuda)

    W = torch.as_tensor(_svd3_inputs(b), device=cuda)
    before = (_svd3_rotation_fixed.launches, svd3_rotation_cuda.launches)
    fixed = _svd3_rotation_fixed(W, det_correction)
    assert (_svd3_rotation_fixed.launches,
            svd3_rotation_cuda.launches) == (before[0] + 1, before[1])
    sep = torch.as_tensor(_svd3_unique(W, det_correction), device=cuda)
    p64 = rotation_from_svd_plain(W.double(), det_correction)
    assert float((fixed.double() - p64)[sep].abs().max()) < SVD3_ATOL
    got = svd3_rotation_cuda(W, det_correction)
    assert float((got - fixed)[sep].abs().max()) < SVD3_ATOL
    if det_correction:
        Rf, tf = _svd3_umeyama_fixed(W)
        R, trace = svd3_umeyama_cuda(W)
        assert torch.equal(Rf, fixed)
        s1 = torch.linalg.svdvals(W.double())[:, 0]
        assert float(((trace - tf).double().abs() / s1).max()) < SVD3_ATOL


def test_svd3_yardstick_edges(cuda):
    """The yardstick keeps the conventions: W = 0 gives the identity (and
    trace 0), a line's and a plane's W a rotation, NaN gives NaN."""
    from fpcr_tpu_torch.ops.svd3_cuda import (_svd3_rotation_fixed,
                                              _svd3_umeyama_fixed)

    line = np.outer([1.0, 2.0, -0.5], [0.3, -1.0, 0.8])
    p = np.random.default_rng(1).normal(size=(40, 3)) * [1.0, 0.5, 0.0]
    nan = np.eye(3)
    nan[2, 1] = np.nan
    W = torch.as_tensor(np.stack([np.zeros((3, 3)), line, p.T @ p, nan])
                        .astype(np.float32), device=cuda)
    for R in (_svd3_rotation_fixed(W), _svd3_umeyama_fixed(W)[0]):
        assert torch.equal(R[0], torch.eye(3, device=cuda))
        assert float((torch.linalg.det(R[1:3].double()) - 1).abs().max()) \
            < 1e-6
        assert bool(R[3].isnan().all())
    assert float(_svd3_umeyama_fixed(W)[1][0]) == 0.0


def test_sharded_loop_over_nccl_is_captured(cuda, tmp_path):
    """A world of one NCCL rank in this process: ``distributed_icp``'s
    loop, its all-reduces included, is captured from its key's second
    call, bit for bit its eager run and ``run_icp``'s, with the eager run's
    launches and all-reduces (``_psum``'s count) on each call."""
    import torch.distributed as dist

    import fpcr_tpu_torch as ft
    from fpcr_tpu_torch.core import metrics
    from fpcr_tpu_torch.parallel.dist_icp import distributed_icp
    from fpcr_tpu_torch.utils import graphs

    s = ft.synthetic_scene(width=64, device=cuda)
    cfg = ft.ICPConfig(max_iterations=21, matcher="pallas")
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/s",
                            world_size=1, rank=0)
    try:
        graphs.clear()
        counts = []
        with graphs.eager():
            ref = distributed_icp(s.source, s.target, cfg)
        outs = []
        for _ in range(3):
            before = metrics._psum.launches
            captures = len(graphs.CACHE.captures)
            outs.append(distributed_icp(s.source, s.target, cfg))
            torch.cuda.synchronize()
            counts.append((metrics._psum.launches - before,
                           len(graphs.CACHE.captures) - captures))
        single = ft.run_icp(s.source, s.target, cfg)
    finally:
        dist.destroy_process_group()
    assert counts[0][1] == counts[2][1] == 0 and counts[1][1] >= 1
    assert counts[0][0] == counts[1][0] == counts[2][0] > 0
    for res in outs + [single]:
        for a, b in zip(_result_bits(ref), _result_bits(res)):
            assert torch.equal(a, b)


def _batch_case(cuda, b, n, m, seed, masks):
    """A batch of B random pairs with ragged masks: all valid, a third
    valid, none valid, alternating."""
    rng = np.random.default_rng(seed)
    p = torch.as_tensor(_cloud(rng, b * n).reshape(b, n, 3), device=cuda)
    q = torch.as_tensor(_cloud(rng, b * m).reshape(b, m, 3), device=cuda)
    mask = None
    if masks:
        keep = np.ones((b, m), bool)
        keep[1::3] = rng.uniform(size=keep[1::3].shape) < 0.33
        keep[2::3] = False
        mask = torch.as_tensor(keep, device=cuda)
    return p, q, mask


@pytest.mark.parametrize("packed", [False, True], ids=["K1", "K2"])
@pytest.mark.parametrize("b,n,m,masks", [(1, 4096, 4096, False),
                                         (3, 300, 500, True),
                                         (32, 4096, 4096, False),
                                         (16, 4096, 4096, True),
                                         (7, 131, 20000, True)])
def test_batched_kernel_equals_separate_calls(cuda, packed, b, n, m, masks):
    """A batched K1 / K2 call: two launches for the whole batch (one sweep,
    one finish), no host synchronisation, and every element's index and
    distance bits those of its own unbatched call, ragged masks and B = 1
    included."""
    from fpcr_tpu_torch.ops import matching_cuda as mc
    from fpcr_tpu_torch.ops.matching import packed_idx_bits

    p, q, mask = _batch_case(cuda, b, n, m, b * 31 + n, masks)
    wrapper = mc.nn_argmin_packed_cuda if packed else mc.nn_argmin_cuda
    kw = dict(idx_bits=packed_idx_bits(m)) if packed else {}
    torch.cuda.synchronize()
    before = wrapper.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        idx, dist = wrapper(p, q, mask, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert wrapper.launches - before == 2
    assert idx.shape == (b, n) and dist.dtype == torch.float32
    for k in range(b):
        ei, ed = wrapper(p[k], q[k], None if mask is None else mask[k], **kw)
        assert torch.equal(idx[k], ei)
        assert torch.equal(dist[k].view(torch.int32), ed.view(torch.int32))


def test_batched_kernel_raises_past_gridz(cuda):
    """65,536 elements exceed gridDim.z: the wrapper raises and launches
    nothing; it never splits the batch. 65,535 runs."""
    from fpcr_tpu_torch.ops import matching_cuda as mc

    p = torch.zeros((65536, 1, 3), device=cuda)
    before = mc.nn_argmin_cuda.launches
    with pytest.raises(ValueError, match="65535"):
        mc.nn_argmin_cuda(p, p)
    with pytest.raises(ValueError, match="batch elements"):
        mc.nn_argmin_cuda(p[:3].contiguous(), p[:2].contiguous())
    with pytest.raises(ValueError, match=r"\[B, \*, 3\]"):
        mc.nn_argmin_cuda(p[:3], torch.zeros((1, 3), device=cuda))
    assert mc.nn_argmin_cuda.launches == before
    idx, d = mc.nn_argmin_cuda(p[:65535].contiguous(), p[:65535].contiguous())
    assert idx.shape == (65535, 1) and (d == 0).all()


@pytest.mark.parametrize("mode", ["packed6", "packed6_idx"])
def test_no_host_sync_in_batched_iterations(cuda, mode):
    """Eight batched plane iterations (normals given) of 8 pairs: one
    batched matcher call an iteration (two launches of K1 or K2) and no
    host synchronisation; the result equals the same batch registered on
    the CPU to f32 noise."""
    import fpcr_tpu_torch as ft
    from fpcr_tpu_torch.ops import matching_cuda as mc

    s = ft.synthetic_scene(width=32, device="cpu")
    rng = np.random.default_rng(3)
    tgts = torch.stack([ft.gt_transform(tuple(0.02 * rng.standard_normal(3)),
                                        tuple(0.03 * rng.standard_normal(3)),
                                        device="cpu").apply(s.source)
                        for _ in range(8)])
    srcs = torch.stack([s.source] * 8)
    nrm = torch.stack([ft.estimate_normals(t) for t in tgts])
    cfg = ft.ICPConfig(metric="plane", matcher="pallas", pallas_mode=mode,
                       max_iterations=8)
    wrapper = (mc.nn_argmin_packed_cuda if mode == "packed6_idx"
               else mc.nn_argmin_cuda)
    args = [x.to(cuda) for x in (srcs, tgts, nrm)]
    ft.register_batch(args[0], args[1], cfg, args[2])  # eager, the first
    ft.register_batch(args[0], args[1], cfg, args[2])  # captures the loop
    torch.cuda.synchronize()
    before = wrapper.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = ft.register_batch(args[0], args[1], cfg, args[2])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert wrapper.launches - before == 2 * 8
    ref = ft.register_batch(srcs, tgts, cfg, nrm)
    assert (res.num_iterations.cpu() - ref.num_iterations).abs().max() <= 1
    torch.testing.assert_close(res.transform.rotation.cpu(),
                               ref.transform.rotation, atol=1e-5, rtol=0)


def test_batched_route_matches_per_element_run_icp_on_card(cuda):
    """``register_batch`` on the card: every element within one iteration
    of its own ``run_icp`` on the card, its transform within 1e-5."""
    import fpcr_tpu_torch as ft

    s = ft.synthetic_scene(width=64, device=cuda)
    rng = np.random.default_rng(4)
    tgts = torch.stack([ft.gt_transform(tuple(0.03 * rng.standard_normal(3)),
                                        tuple(0.05 * rng.standard_normal(3)),
                                        device=cuda).apply(s.source)
                        for _ in range(6)])
    srcs = torch.stack([s.source] * 6)
    cfg = ft.ICPConfig(matcher="pallas", max_iterations=20)
    res = ft.register_batch(srcs, tgts, cfg)
    for k in range(6):
        one = ft.run_icp(srcs[k], tgts[k], cfg)
        assert abs(int(res.num_iterations[k]) - int(one.num_iterations)) <= 1
        assert float(ft.transform_rmse(
            ft.RigidTransform(res.transform.rotation[k],
                              res.transform.translation[k]),
            one.transform, s.source)) < 1e-5


def test_pose_graph_bit_equal_across_calls(cuda):
    """``optimize_pose_graph`` on the card twice, with duplicate edges:
    bit-equal poses (the dense assembly sums each block in a fixed order,
    no atomics), and within 1e-4 of the CPU run."""
    import fpcr_tpu_torch as ft
    from fpcr_tpu_torch.models import pose_graph as tpg

    rng = np.random.default_rng(5)
    T = 10
    steps = torch.as_tensor(np.concatenate([rng.normal(0, 0.3, (T - 1, 3)),
                                            rng.normal(0, 0.1, (T - 1, 3))],
                                           1), dtype=torch.float32)
    rel = tpg.se3_exp(steps)
    poses = [torch.eye(4)]
    for r in rel:
        poses.append(poses[-1] @ r)
    poses = torch.stack(poses)
    ei = torch.tensor(list(range(T - 1)) + [0, 0, 2], dtype=torch.int32)
    ej = torch.tensor(list(range(1, T)) + [T - 1, T - 1, 7], dtype=torch.int32)
    meas = torch.cat([rel, torch.stack([
        torch.linalg.inv(poses[int(i)]) @ poses[int(j)] @ tpg.se3_exp(
            torch.as_tensor(rng.normal(0, 0.02, 6), dtype=torch.float32))
        for i, j in zip(ei[T - 1:], ej[T - 1:])])])
    w = torch.as_tensor(rng.uniform(0.5, 2.0, len(ei)), dtype=torch.float32)
    a = ft.optimize_pose_graph(poses.to(cuda), ei.to(cuda), ej.to(cuda),
                               meas.to(cuda), w.to(cuda), iterations=6)
    b = ft.optimize_pose_graph(poses.to(cuda), ei.to(cuda), ej.to(cuda),
                               meas.to(cuda), w.to(cuda), iterations=6)
    assert torch.equal(a.poses, b.poses)
    assert torch.equal(a.residual_rms, b.residual_rms)
    c = ft.optimize_pose_graph(poses, ei, ej, meas, w, iterations=6)
    torch.testing.assert_close(a.poses.cpu(), c.poses, atol=1e-4, rtol=0)


@pytest.fixture
def nccl_world_of_one(cuda, tmp_path):
    """A one-rank NCCL process group in this process (a ``file://`` store,
    no port), destroyed after the test."""
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    yield cuda
    dist.destroy_process_group()


def _same_bits(a, b):
    """Equal bits, NaN rows (the errors after the stop) included."""
    for x, y in ((a.transform.rotation, b.transform.rotation),
                 (a.transform.translation, b.transform.translation),
                 (a.errors, b.errors), (a.num_iterations, b.num_iterations),
                 (a.points, b.points)):
        if x.is_floating_point():
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y)


def test_distributed_icp_world_of_one_is_run_icp_k1(nccl_world_of_one):
    """``distributed_icp`` on one NCCL rank equals ``run_icp`` bit for bit,
    with the same K1 launches."""
    import fpcr_tpu_torch as ft
    from fpcr_tpu_torch.parallel.dist_icp import distributed_icp

    s = ft.synthetic_scene(width=64, device=nccl_world_of_one)
    cfg = ft.ICPConfig(max_iterations=40, matcher="pallas")
    before = nn_argmin_cuda.launches
    a = distributed_icp(s.source, s.target, cfg)
    mid = nn_argmin_cuda.launches
    b = ft.run_icp(s.source, s.target, cfg)
    assert mid - before == nn_argmin_cuda.launches - mid > 0
    _same_bits(a, b)


def test_distributed_ndt_world_of_one_is_run_ndt_k4(nccl_world_of_one):
    """``distributed_ndt`` banded through K4 on one NCCL rank equals
    ``run_ndt`` bit for bit, with the same K4 launches."""
    import fpcr_tpu_torch as ft
    from fpcr_tpu_torch.ops.ndt_cuda import ndt_fused_moments_cuda
    from fpcr_tpu_torch.parallel.dist_icp import distributed_ndt

    s = ft.synthetic_scene(width=128, device=nccl_world_of_one)
    gt = ft.gt_transform((0.02, -0.015, 0.01), (0.03, -0.02, 0.015),
                         device=nccl_world_of_one)
    tgt = gt.apply(s.source)
    cfg = ft.NDTConfig(voxel_size=0.2, max_iterations=30, lookup="banded",
                       lookup_impl="pallas")
    before = ndt_fused_moments_cuda.launches
    a = distributed_ndt(s.source, tgt, cfg)
    mid = ndt_fused_moments_cuda.launches
    b = ft.run_ndt(s.source, tgt, cfg)
    assert mid - before == ndt_fused_moments_cuda.launches - mid > 0
    _same_bits(a, b)


def test_cli_run_on_the_card(cuda, capsys):
    """``python -m fpcr_tpu_torch run`` without ``--cpu`` runs on the card
    and reaches the synthetic scene's 1e-5."""
    import json

    from fpcr_tpu_torch.cli import main

    assert main(["run", "--dataset", "synthetic", "--width", "64",
                 "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["platform"] == "gpu"
    assert payload["transform_rmse_vs_gt"] < 1e-5


def test_wide_plane_k4_covers_at_the_escalated_window(cuda):
    """Check 10 of ``scripts/tpu_smoke.py``: on the card the wide-plane
    cloud resolves to K4 at a window above its floor, and K4's hit counts
    there equal the gather oracle's."""
    from fpcr_tpu_torch.bench import guards
    from fpcr_tpu_torch.ops.ndt_cuda import ndt_fused_moments_cuda

    _, grid, _, _, src_sorted, cfg = guards.wide_plane_setup(cuda)
    assert cfg.lookup_impl == "pallas"
    assert cfg.lookup_window > guards.WIDE_WINDOW_FLOOR
    before = ndt_fused_moments_cuda.launches
    assert guards.fused_count_parity(src_sorted, grid, cfg)
    assert ndt_fused_moments_cuda.launches == before + 1


def test_basic_registration_example_on_card(cuda):
    from fpcr_tpu_torch.examples import basic_registration
    from fpcr_tpu_torch.ops.matching_cuda import nn_argmin_cuda

    before = nn_argmin_cuda.launches
    got = basic_registration.main([])
    assert got["gt_error"] < 1e-5
    assert nn_argmin_cuda.launches > before


# ---- kernel eig3 and point-to-plane on the hall scan ------------------------

EIG3_CASES = ["near_collinear", "lam0_near_lam1", "lam1_near_lam2",
              "isotropic", "zero", "signed"]


def _eig3_input(case):
    from test_torch_eig3 import CASES

    rng = np.random.default_rng(EIG3_CASES.index(case) + 31)
    if case == "signed":
        b = rng.normal(size=(500, 3, 3))
        return (b + b.transpose(0, 2, 1)).astype(np.float32)
    return CASES[case](rng)


@pytest.mark.parametrize("case", EIG3_CASES)
def test_eig3_kernel_against_mirror_and_float64(cuda, case):
    """Kernel eig3 against float64 ``eigh`` of the same float32 matrices
    (each column within 8·2⁻²³·max|λ| / its gap rad, or 1e-6; each value
    within 8·2⁻²³·max|λ|) and against its CPU mirror (the same, and the
    fixed frame of A ≈ qI bit for bit): one launch, through ``eigh3`` on
    a CUDA tensor."""
    from test_torch_eig3 import EPS32, _angles

    from fpcr_tpu_torch.ops.eig3_cuda import eig3_cuda
    from fpcr_tpu_torch.ops.eig3_mirror import eig3_mirror
    from fpcr_tpu_torch.ops.eigh3 import eigh3

    a = _eig3_input(case)
    before = eig3_cuda.launches
    vals, vecs = eigh3(torch.as_tensor(a, device=cuda))
    assert eig3_cuda.launches == before + 1
    vals, vecs = vals.cpu().numpy(), vecs.cpu().numpy()
    mvals, mvecs = eig3_mirror(a)
    w, v = np.linalg.eigh(a.astype(np.float64))
    top = np.abs(w).max(axis=1)
    for ref in (w, mvals):
        np.testing.assert_array_less(np.abs(vals - ref).max(axis=1),
                                     8 * EPS32 * top + 1e-30)
    if case in ("isotropic", "zero"):
        np.testing.assert_array_equal(vecs, mvecs)
        return
    for j in range(3):
        gaps = np.abs(w - w[:, j:j + 1])
        gaps[:, j] = np.inf
        bound = np.maximum(8 * EPS32 * top / gaps.min(axis=1), 1e-6)
        for ref in (v, mvecs):
            ang = _angles(vecs[:, :, j], ref[:, :, j])
            assert (ang <= bound).all(), (case, j, (ang / bound).max())


def test_eig3_kernel_edges_and_checks(cuda):
    """NaN and ±inf give NaN, zero the fixed frame, an empty batch no
    launch; a CPU, float64 or non-contiguous input, or a wrong shape, is
    refused before any launch."""
    from fpcr_tpu_torch.ops.eig3_cuda import eig3_cuda
    from fpcr_tpu_torch.ops.eigh3 import ISO_FRAME

    a = torch.zeros(4, 3, 3, device=cuda)
    a[0, 0, 1] = float("nan")
    a[1, 2, 2] = float("inf")
    a[2, 0, 0] = -float("inf")
    vals, vecs = eig3_cuda(a)
    assert bool(vals[:3].isnan().all()) and bool(vecs[:3].isnan().all())
    assert bool((vals[3] == 0).all())
    np.testing.assert_allclose(vecs[3].cpu().numpy(), np.array(ISO_FRAME),
                               atol=1e-7)
    before = eig3_cuda.launches
    v0, e0 = eig3_cuda(torch.zeros(0, 3, 3, device=cuda))
    assert v0.shape == (0, 3) and e0.shape == (0, 3, 3)
    for bad in (torch.zeros(2, 3, 3), torch.zeros(2, 3, 3, device=cuda,
                                                  dtype=torch.float64),
                torch.zeros(3, 3, 2, device=cuda).transpose(1, 2),
                torch.zeros(2, 3, 4, device=cuda)):
        with pytest.raises(ValueError):
            eig3_cuda(bad)
    assert eig3_cuda.launches == before


def _hall_plane_request(cuda, shift=0.0):
    """The OS1-16 hall scan (16,384 points) with 2 mm noise and a 2 degree,
    3 cm pose, as the cell hall-plane-seq registers it."""
    from benchmark import scenes

    cloud = scenes.ouster_hall("assets/Donut_1024x16.csv",
                               "assets/beam_intrinsics.csv")
    rng = np.random.default_rng(17)
    c, s = math.cos(math.radians(2.0)), math.sin(math.radians(2.0))
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    src = cloud.astype(np.float64) @ rot.T + [0.02, -0.01, 0.015]
    src = src + rng.normal(0, 0.002, src.shape)
    tgt = cloud + rng.normal(0, 0.002, cloud.shape) + shift
    return (torch.as_tensor(src.astype(np.float32), device=cuda),
            torch.as_tensor(tgt.astype(np.float32), device=cuda))


def test_plane_call_captured_equals_eager_without_host_reads(cuda):
    """``run_icp(metric='plane', matcher='xla')`` on the hall scan, its
    normals prepass (the self-kNN kernel, covariances, kernel eig3) in
    every call: the key's eager call, the capture and the replay bit for
    bit the ``graphs.eager()`` run with its launches; the prepass issues
    no host read (it runs under ``set_sync_debug_mode('error')``) and
    launches the kNN sweep and merge, so the call's syncs are its done
    reads and its span ``knn`` counts ``kernel`` 1."""
    import fpcr_tpu_torch as ft
    from fpcr_tpu_torch.ops.eig3_cuda import eig3_cuda
    from fpcr_tpu_torch.ops.knn_cuda import (self_knn_cuda, sm_count,
                                             sweep_blocks)
    from fpcr_tpu_torch.utils import graphs, timing

    graphs.clear()
    src, tgt = _hall_plane_request(cuda)
    cfg = ft.ICPConfig(metric="plane", matcher="xla", max_iterations=100,
                       tolerance=1e-6, k_neighbors=4)

    def run():
        return ft.run_icp(src, tgt, cfg)

    counts = [_launch_counts()]
    with graphs.eager():
        ref = run()
    counts.append(_launch_counts())
    outs = []
    for _ in range(3):  # the key's eager call, the capture, the replay
        outs.append(run())
        counts.append(_launch_counts())
    assert len(graphs.CACHE) >= 1
    for got in outs:
        assert all(torch.equal(a, b) for a, b in zip(_result_bits(ref),
                                                     _result_bits(got)))

    def diff(x, y):
        return [({k: v - y[i].get(k, 0) for k, v in a.items()}
                 if isinstance(a, dict) else a - y[i])
                for i, a in enumerate(x)]
    per_call = [diff(b, a) for a, b in zip(counts, counts[1:])]
    assert all(d == per_call[0] for d in per_call)
    before = eig3_cuda.launches
    knn_before = self_knn_cuda.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        normals = ft.estimate_normals(tgt, k=4)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert eig3_cuda.launches == before + 1 and normals.shape == tgt.shape
    assert self_knn_cuda.launches == knn_before + 2  # the sweep, the merge
    timing.clear_spans()  # what earlier tests recorded under a profiler
    with timing.recording():
        res = run()
    spans = timing.recorded_spans()
    timing.clear_spans()
    (call,) = [s for s in spans if s.name == "call"]
    reads = [s for s in spans if s.name == "done_read"]
    assert call.attrs["syncs"] == len(reads) >= 1
    (nspan,) = [s for s in spans if s.name == "normals"]
    (knn_span,) = [s for s in spans if s.name == "knn"]
    assert knn_span.attrs["kernel"] == 1
    blocks = sweep_blocks(1, 16384, 5, sm_count(cuda.index))
    assert nspan.attrs == {"rows": 16384, "k": 4, "tiles": blocks}
    assert int(res.num_iterations) == int(ref.num_iterations)


def test_plane_on_a_ring_sector_holds_the_reference_on_card(cuda):
    """The CPU test's 16-ring sector on the card, kernel eig3's normals and
    K1: the float64 reference's pose and first error within the CPU test's
    tolerances."""
    import fpcr_tpu_torch as ft
    from test_torch_eig3 import (FIRST_ERROR_TOL, ICP, POSE_TOL,
                                 _ring_request)

    from benchmark.reference import check, icp64
    from benchmark.rows import pack

    for b0 in (64, 256, 832):
        src, tgt = _ring_request(b0)
        ref = icp64.register(src, tgt, ICP, "plane", icp64.FLOAT64)
        res = ft.run_icp(src.to(cuda), tgt.to(cuda),
                         ft.ICPConfig(metric="plane", **ICP))
        g = check.gaps(pack(res)[0].cpu(), ref, src)
        assert g["iter_gap"] <= 1, (b0, g)
        assert g["pose_gap_m"] < POSE_TOL, (b0, g)
        assert g["first_error_gap_m"] < FIRST_ERROR_TOL, (b0, g)


def test_batched_normals_equal_each_elements_call_on_card(cuda):
    """``estimate_normals`` of a batch [B, M, 3] on the card: each
    element's normals its own call's bit for bit, one eig3 launch and one
    kNN sweep and merge for the batch."""
    import fpcr_tpu_torch as ft
    from fpcr_tpu_torch.ops.eig3_cuda import eig3_cuda
    from fpcr_tpu_torch.ops.knn_cuda import self_knn_cuda

    src, tgt = _hall_plane_request(cuda)
    clouds = torch.stack([tgt, src, tgt[torch.randperm(
        tgt.shape[0], generator=torch.Generator().manual_seed(0)).to(cuda)]])
    before = eig3_cuda.launches
    knn_before = self_knn_cuda.launches
    batch = ft.estimate_normals(clouds, k=4)
    assert eig3_cuda.launches == before + 1
    assert self_knn_cuda.launches == knn_before + 2
    for b in range(3):
        assert torch.equal(batch[b], ft.estimate_normals(clouds[b], k=4))


# ---- the self-kNN kernel of the normals prepass -----------------------------

KNN_CASES = ["random", "duplicates", "lattice", "nan", "masked",
             "three valid", "batch", "hall", "hall kk=9", "hall kk=16",
             "hall permuted"]


def _knn_input(cuda, case):
    """``(q, mask, kk)`` on the card for ``case``."""
    rng = np.random.default_rng(KNN_CASES.index(case) + 230)

    def cloud(m, scale=5.0):
        return rng.uniform(-scale, scale, (m, 3)).astype(np.float32)

    mask, kk = None, 5
    if case == "random":
        q = cloud(3000)
    elif case == "duplicates":
        q = cloud(2500)
        q[rng.integers(0, 2500, 900)] = q[rng.integers(0, 2500, 900)]
        q[1200:1204] = q[3]
        kk = 9
    elif case == "lattice":
        g = np.stack(np.meshgrid(*[np.arange(13)] * 3, indexing="ij"), -1)
        q = g.reshape(-1, 3).astype(np.float32)
    elif case == "nan":
        q = cloud(2000)
        q[[0, 777, 1999]] = np.nan
        q[5, 2] = np.inf
    elif case == "masked":
        q = cloud(3000)
        mask = rng.random(3000) < 0.6
        kk = 16
    elif case == "three valid":
        q = cloud(700)
        mask = np.isin(np.arange(700), [2, 350, 699])
    elif case == "batch":
        q = np.stack([cloud(2048), cloud(2048, 0.01), cloud(2048)])
        q[2, 1000:1500] = q[2, 0]
        mask = rng.random((3, 2048)) < np.array([[1.0], [0.9], [0.5]])
        kk = 9
    else:
        q = _hall_plane_request(cuda)[1].cpu().numpy()
        kk = {"hall kk=9": 9, "hall kk=16": 16}.get(case, 5)
        if case == "hall permuted":
            q = q[rng.permutation(q.shape[0])]
    return (torch.as_tensor(q, device=cuda),
            None if mask is None else torch.as_tensor(mask, device=cuda), kk)


@pytest.mark.parametrize("case", KNN_CASES)
def test_knn_kernel_equals_plain_and_mirror(cuda, case):
    """The self-kNN kernel bit for bit the plain exact search (indices and
    distance bits), with and without its seed, and its CPU mirror up to
    3,000 points and on the hall's 16,384; a sweep and a merge a call
    where the plan has slices."""
    from fpcr_tpu_torch.ops import normals as tn
    from fpcr_tpu_torch.ops.knn_cuda import (_self_knn_unseeded, plan_knn,
                                             self_knn_cuda, sm_count)
    from fpcr_tpu_torch.ops.knn_mirror import self_knn_mirror

    q, mask, kk = _knn_input(cuda, case)
    want = tn.knn(q, q, kk, mask, exact=True)
    before = self_knn_cuda.launches
    got = self_knn_cuda(q, kk, mask)
    slices, _ = plan_knn(q.shape[0] if q.ndim == 3 else 1, q.shape[-2], kk,
                         sm_count(cuda.index))
    assert self_knn_cuda.launches == before + (2 if slices > 1 else 1)
    outs = [got, _self_knn_unseeded(q, kk, mask)]
    if q.shape[-2] <= 3000 or case == "hall":
        mi, md = self_knn_mirror(q.cpu().numpy(), kk,
                                 None if mask is None else mask.cpu().numpy())
        outs.append((torch.as_tensor(mi, device=cuda),
                     torch.as_tensor(md, device=cuda)))
    for idx, d in outs:
        assert idx.dtype == torch.int32 and d.dtype == torch.float32
        assert torch.equal(idx, want[0])
        assert torch.equal(d.view(torch.int32), want[1].view(torch.int32))


def test_knn_kernel_checks(cuda):
    """A CPU, float64 or non-contiguous cloud, a ``kk`` outside 1 to
    ``K_MAX``, or a mask of the wrong shape or type is refused before any
    launch; an empty cloud launches nothing."""
    from fpcr_tpu_torch.ops.knn_cuda import K_MAX, self_knn_cuda

    q = torch.zeros(100, 3, device=cuda)
    before = self_knn_cuda.launches
    for args in ((q.cpu(), 5), (q.double(), 5), (q.t().contiguous().t(), 5),
                 (q, 0), (q, K_MAX + 1), (q, 5, torch.ones(99, device=cuda,
                                                           dtype=torch.bool)),
                 (q, 5, torch.ones(100, device=cuda))):
        with pytest.raises(ValueError):
            self_knn_cuda(*args)
    idx, d = self_knn_cuda(torch.zeros(0, 3, device=cuda), 5)
    assert idx.shape == (0, 5) and d.shape == (0, 5)
    assert self_knn_cuda.launches == before


@pytest.mark.parametrize("scene", ["hall", "random"])
def test_normals_on_the_kernel_route_hold_float64(cuda, scene):
    """``estimate_normals`` on the card (the kernel's route): bit for bit
    the plain exact route's normals (the streaming search forced by a
    banded threshold of 0); its k + 1 neighbours float64's wherever the
    float64 distances of ranks k + 1 and k + 2 lie further apart than
    float32 rounding (1e-5 relative), on at least 99% of the rows; the
    normals within eig3's bound of float64 ``eigh`` of their covariances."""
    from test_torch_eig3 import EPS32, _angles

    import fpcr_tpu_torch as ft
    from fpcr_tpu_torch.ops import normals as tn
    from fpcr_tpu_torch.ops.knn_cuda import self_knn_cuda

    if scene == "hall":
        q = _hall_plane_request(cuda)[1]
    else:
        rng = np.random.default_rng(5)
        q = torch.as_tensor(rng.uniform(-20, 20, (8192, 3)).astype(
            np.float32), device=cuda)
    before = self_knn_cuda.launches
    normals = ft.estimate_normals(q, k=4)
    assert self_knn_cuda.launches > before
    plain = ft.estimate_normals(q, k=4, exact=True, banded_threshold=0)
    assert torch.equal(normals, plain)

    idx, _ = self_knn_cuda(q, 5)
    q64 = q.double()
    d64 = torch.cat([torch.cdist(q64[s:s + 2048], q64) ** 2
                     for s in range(0, q.shape[0], 2048)])
    near = torch.topk(d64, 6, dim=-1, largest=False)
    sep = near.values[:, 5] - near.values[:, 4] > 1e-5 * near.values[:, 5]
    assert float(sep.double().mean()) >= 0.99
    mine = torch.sort(idx.long(), dim=-1).values
    theirs = torch.sort(near.indices[:, :5], dim=-1).values
    assert torch.equal(mine[sep], theirs[sep])

    cov = tn._neighbour_covariance(q, idx[:, 1:]).double()
    w, v = torch.linalg.eigh(cov)
    w, v = w.cpu().numpy(), v.cpu().numpy()
    top = np.abs(w).max(axis=1)
    bound = np.maximum(8 * EPS32 * top / np.maximum(w[:, 1] - w[:, 0],
                                                    1e-300), 1e-6)
    ang = _angles(normals.cpu().numpy(), v[:, :, 0])
    ok = (w[:, 1] - w[:, 0]) > 8 * EPS32 * top  # a determined eigenvector
    assert (ang[ok] <= bound[ok]).all()
