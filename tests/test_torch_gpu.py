"""Kernel K1 on the card against its plain PyTorch version.

Every test here needs a CUDA device and skips without one: the CUDA kernel
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
        pytest.skip("needs a CUDA device: kernel K1 has no CPU mode")
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
