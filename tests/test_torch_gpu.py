"""Kernels K1 and K3 on the card against their plain PyTorch versions.

Every test here needs a CUDA device and skips without one: a CUDA kernel
has no CPU mode. On the card (which has no JAX, so the root conftest is
not loaded):

    python -m pytest --noconftest -q tests/test_torch_gpu.py
"""

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
    s_cpu = ft.synthetic_scene(width=32)
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

    gt = ft.gt_transform((0.004, -0.002, 0.003), (0.002, -0.003, 0.002))
    cfg = ft.ICPConfig(matcher="morton", morton_impl="pallas",
                       morton_chunk=512, morton_window=64, max_iterations=20,
                       morton_shifts=2)
    src = ft.synthetic_scene(width=64).source
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
