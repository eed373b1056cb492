"""The port's matcher on the CPU (the plain version of kernel K1) against
``fpcr_tpu``'s Pallas kernel in interpret mode, its XLA matcher and numpy;
and the CUDA wrapper's host-side contract, which needs no card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpcr_tpu.ops.matching import nn_argmin as j_nn_argmin
from fpcr_tpu.ops.matching import pairwise_sqdist as j_pairwise_sqdist
from fpcr_tpu.ops.matching_pallas import nn_argmin_pallas
from fpcr_tpu_torch.ops import matching_cuda
from fpcr_tpu_torch.ops.matching import (gather_correspondences, nn_argmin,
                                         nn_argmin_plain, pairwise_sqdist,
                                         pairwise_sqdist_exact)
from fpcr_tpu_torch.ops.matching_cuda import (SLICE_QUANTUM, nn_argmin_cuda,
                                              plan_slices)

from helpers import np_nn

torch.set_num_threads(2)

# f32 squared distances of points within [-2, 2]³ (values up to ~48): the
# expansion form cancels, so the forms agree to ~1e-5 absolute
SQDIST_ATOL = 1e-5


def _case(name):
    if name == "random-300x500":
        rng = np.random.default_rng(77)
        return (rng.uniform(-2, 2, (300, 3)).astype(np.float32),
                rng.uniform(-2, 2, (500, 3)).astype(np.float32), None)
    if name == "masked-300x500":
        p, q, _ = _case("random-300x500")
        mask = np.ones(500, bool)
        mask[200:] = False
        return p, q, mask
    if name == "odd-131x259":
        rng = np.random.default_rng(78)
        return (rng.uniform(-1, 1, (131, 3)).astype(np.float32),
                rng.uniform(-1, 1, (259, 3)).astype(np.float32), None)
    if name == "tie-1x4":
        return (np.zeros((1, 3), np.float32),
                np.array([[5, 0, 0], [1, 0, 0], [2, 0, 0], [1, 0, 0]],
                         np.float32), None)
    p, q, _ = _case("random-300x500")  # all masked
    return p, q, np.zeros(500, bool)


CASES = ["random-300x500", "masked-300x500", "odd-131x259", "tie-1x4",
         "all-masked-300x500"]


@pytest.fixture(scope="module")
def jax_results():
    """Each case through every JAX matcher once (interpret-mode Pallas
    compiles per shape, so the results are shared by the parametrized
    tests below)."""
    out = {}
    for name in CASES:
        p, q, mask = _case(name)
        jm = None if mask is None else jnp.asarray(mask)
        jp, jq = jnp.asarray(p), jnp.asarray(q)
        res = {mode: nn_argmin_pallas(jp, jq, jm, block_n=64, block_m=128,
                                      mode=mode)
               for mode in ("highest", "packed6")}
        res["xla"] = j_nn_argmin(jp, jq, jm)
        out[name] = {k: (np.asarray(i), np.asarray(d))
                     for k, (i, d) in res.items()}
    return out


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("name", CASES)
def test_plain_matcher_matches_jax_and_numpy(jax_results, name, exact):
    p, q, mask = _case(name)
    idx, d = nn_argmin(torch.as_tensor(p), torch.as_tensor(q),
                       None if mask is None else torch.as_tensor(mask),
                       exact=exact)
    idx, d = idx.numpy(), d.numpy()
    assert idx.dtype == np.int32 and d.dtype == np.float32
    for ref_name, (ri, rd) in jax_results[name].items():
        np.testing.assert_array_equal(idx, ri, err_msg=ref_name)
        np.testing.assert_allclose(d, rd, atol=SQDIST_ATOL, err_msg=ref_name)
    if mask is not None and not mask.any():
        assert np.isinf(d).all() and (idx == 0).all()
        return
    keep = np.nonzero(mask)[0] if mask is not None else np.arange(len(q))
    ni, nd = np_nn(p, q[keep])
    np.testing.assert_array_equal(idx, keep[ni])
    np.testing.assert_allclose(d, nd, atol=SQDIST_ATOL)
    if name == "tie-1x4":
        assert idx[0] == 1  # the first of two equal minima


@pytest.mark.parametrize("chunk,tile", [(8, 8), (64, 128), (7, 13),
                                        (2048, 2048)])
def test_streaming_tiles_do_not_change_result(chunk, tile):
    """Ties across tile borders keep the first minimum: duplicated targets
    put equal candidates in different tiles."""
    rng = np.random.default_rng(9)
    q = rng.uniform(-1, 1, (100, 3)).astype(np.float32)
    q = np.concatenate([q, q, q])  # every minimum appears three times
    p = rng.uniform(-1, 1, (50, 3)).astype(np.float32)
    idx, _ = nn_argmin_plain(torch.as_tensor(p), torch.as_tensor(q),
                             source_chunk=chunk, target_tile=tile,
                             exact=True)
    ref, _ = np_nn(p, q[:100])
    np.testing.assert_array_equal(idx.numpy(), ref)


def test_pairwise_sqdist_forms_match_jax():
    rng = np.random.default_rng(10)
    p = rng.uniform(-2, 2, (40, 3)).astype(np.float32)
    q = rng.uniform(-2, 2, (70, 3)).astype(np.float32)
    a = pairwise_sqdist(torch.as_tensor(p), torch.as_tensor(q)).numpy()
    b = pairwise_sqdist_exact(torch.as_tensor(p), torch.as_tensor(q)).numpy()
    ref = ((p[:, None].astype(np.float64) - q[None]) ** 2).sum(-1)
    np.testing.assert_allclose(a, np.asarray(j_pairwise_sqdist(
        jnp.asarray(p), jnp.asarray(q))), atol=SQDIST_ATOL)
    np.testing.assert_allclose(a, ref, atol=SQDIST_ATOL)
    np.testing.assert_allclose(b, ref, rtol=1e-6)
    assert (a >= 0).all()


def test_gather_correspondences():
    q = torch.arange(30, dtype=torch.float32).reshape(10, 3)
    idx = torch.tensor([3, 0, 9, 3], dtype=torch.int32)
    np.testing.assert_array_equal(gather_correspondences(q, idx).numpy(),
                                  q.numpy()[[3, 0, 9, 3]])


@pytest.mark.parametrize("n,m", [(1, 1), (300, 500), (8171, 8171),
                                 (16384, 16384), (35947, 35947), (5, 70000),
                                 (100000, 300)])
@pytest.mark.parametrize("sms", [1, 132])
def test_plan_slices_covers_targets(n, m, sms):
    slices, slice_len = plan_slices(n, m, 512, sms)
    assert slice_len % SLICE_QUANTUM == 0 and slice_len >= SLICE_QUANTUM
    assert slices * slice_len >= m > (slices - 1) * slice_len  # none empty
    assert slices <= 65535  # gridDim.y
    if n >= 512 * 4 * sms:
        assert slices == 1  # enough row blocks: no combine pass


def test_cuda_wrapper_refuses_cpu_tensors():
    p = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="CUDA"):
        nn_argmin_cuda(p, p)
    with pytest.raises(TypeError):
        nn_argmin_cuda(np.zeros((4, 3), np.float32), p)
    assert matching_cuda.nn_argmin_cuda.launches == 0  # nothing launched


def test_dispatch_takes_plain_version_on_cpu():
    rng = np.random.default_rng(11)
    p = torch.as_tensor(rng.uniform(-1, 1, (20, 3)).astype(np.float32))
    a = nn_argmin(p, p)
    b = nn_argmin_plain(p, p)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(a[0], torch.arange(20, dtype=torch.int32))
