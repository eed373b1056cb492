"""The bf16 split distance of the brute matcher's tensor-core studies.

Counterpart of ``fpcr_tpu/ops/matching_pallas.py::_augment``, ``split3_f32``
and ``_split3``, and of the K-packing of ``scripts/exp_split_matmul.py``
(E4) and ``scripts/exp_reduction2.py`` (E3). The squared distance is one
dot product of augmented rows, p̂ = [−2p, 1, |p|², 0, 0, 0] against
q̂ = [q, |q|², 1, 0, 0, 0]. Each f32 lane splits exactly into three bf16
parts x = h + m + l, and six products of parts, (h,h′)(h,m′)(m,h′)(h,l′)
(l,h′)(m,m′), laid out along K, give a K=48 bf16 product of f32 grade;
``terms=3`` keeps the first three (K=24, ~2⁻¹⁶ of |p|² + |q|²).

:func:`split_nn` reduces the [N, M] split distance by one of four
epilogues: ``'argmin'`` (first minimum, the distance unclamped unless
``clamp``), ``'packed14'`` (E3's int32 min over ``(bits(max(d, 0)) &
~0x3FFF) | col``, returned as the index and the key read as f32),
``'min'`` and ``'keep'`` (the distance to one column). A CUDA tensor
launches Kernel S (``ops/split_cuda.py``); a CPU tensor takes
:func:`split_nn_plain`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils.precision import pin_f32_precision
from .matching import sq_norm
from .split_cuda import (PACKED14_BITS, PACKED14_KEY_INIT, check_split_args,
                         split_nn_cuda)

LANES = 8  # augmented lanes: 5 used, padded to 8
INVALID_SURROGATE = 1e30  # the |q|² lane of a padded target
# the kept (p part, q part) pairs of the K packing, largest first; parts
# are 0 = h, 1 = m, 2 = l
PAIRS = ((0, 0), (0, 1), (1, 0), (0, 2), (2, 0), (1, 1))


def augment_norm(p: torch.Tensor, q: torch.Tensor, n_pad: int,
                 m_pad: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """p̂ f32[n_pad, 8] = [−2p, 1, |p|², 0, 0, 0] (padded rows 0) and the
    target rows q̂ f32[m_pad, 8] = [q, |q|², 1, 0, 0, 0], target-major:
    the transpose of the TPU's [8, m_pad]. A padded target has 1e30 in its
    |q|² lane and zeros elsewhere, so it never wins."""
    p = p.to(torch.float32)
    q = q.to(torch.float32)
    n, m = p.shape[0], q.shape[0]
    if n_pad < n or m_pad < m:
        raise ValueError(f"pads ({n_pad}, {m_pad}) below the sizes ({n}, "
                         f"{m})")
    p_hat = torch.zeros((n_pad, LANES), dtype=torch.float32, device=p.device)
    p_hat[:n, :3] = -2.0 * p
    p_hat[:n, 3] = 1.0
    p_hat[:n, 4] = sq_norm(p)
    q_hat = torch.zeros((m_pad, LANES), dtype=torch.float32, device=q.device)
    q_hat[:m, :3] = q
    q_hat[:m, 3] = sq_norm(q)
    q_hat[:m, 4] = 1.0
    q_hat[m:, 3] = INVALID_SURROGATE
    return p_hat, q_hat


def split3_f32(x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The triple-bf16 split kept in f32, x = h + m + l exactly: each part
    is the remainder rounded to nearest even through ``torch.bfloat16``.
    It equals the JAX package's ``split3_f32`` bit for bit except where a
    remainder is subnormal, which XLA on the CPU flushes to zero."""
    h = x.to(torch.bfloat16).to(torch.float32)
    r = x - h
    m = r.to(torch.bfloat16).to(torch.float32)
    lo = (r - m).to(torch.bfloat16).to(torch.float32)
    return h, m, lo


def split_operands(p: torch.Tensor, q: torch.Tensor, terms: int, n_pad: int,
                   m_pad: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The K-packed bf16 operands of the split distance: ``p_in``
    bf16[n_pad, 8·terms] and ``q_in`` bf16[m_pad, 8·terms], target-major
    (a target's K values are contiguous), so that ``p_in.float() @
    q_in.float().T`` is the split distance. ``terms`` in [1, 6] keeps the
    first ``terms`` pairs of :data:`PAIRS`."""
    if not 1 <= terms <= len(PAIRS):
        raise ValueError(f"terms must lie in [1, {len(PAIRS)}], got {terms}")
    p_hat, q_hat = augment_norm(p, q, n_pad, m_pad)
    ps = [x.to(torch.bfloat16) for x in split3_f32(p_hat)]
    qs = [x.to(torch.bfloat16) for x in split3_f32(q_hat)]
    pairs = PAIRS[:terms]
    return (torch.cat([ps[a] for a, _ in pairs], dim=1).contiguous(),
            torch.cat([qs[b] for _, b in pairs], dim=1).contiguous())


def tc_split_operands(p: torch.Tensor, q: torch.Tensor,
                      q_mask: Optional[torch.Tensor] = None,
                      centre: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 24 used K slots of the tensor-core K1/K2 sweep
    (``csrc/nn_tc.cu``) of one block of source rows, centred on ``centre``
    f32[3] (default the rows' mean, as the sweep takes it), each the f32
    value of a bf16 part: ``A`` f32[N, 24] and ``B`` f32[M, 24] with ``A @
    B.T`` the norm form |p'|² + |q'|² − 2p'·q' (p' = p − c,
    q' = q − c) less the dropped products of parts. Per coordinate the pairs
    :data:`PAIRS` of ``split3_f32(-2p')`` and ``split3_f32(q')``, then
    |p'|²'s three parts against ones and ones against |q'|²'s. A masked
    target has zero coordinates and the surrogate 1e30 for |q'|²."""
    p = p.to(torch.float32)
    q = q.to(torch.float32)
    c = p.mean(dim=0) if centre is None else centre.to(torch.float32)
    p, q = p - c, q - c
    if q_mask is not None:
        keep = q_mask.to(torch.bool)
        q = torch.where(keep[:, None], q, torch.zeros_like(q))
        q_sq = torch.where(keep, sq_norm(q),
                           torch.full_like(q[:, 0], INVALID_SURROGATE))
    else:
        q_sq = sq_norm(q)
    ps = split3_f32(-2.0 * p)
    qs = split3_f32(q)
    a = [ps[i][:, k] for k in range(3) for i, _ in PAIRS]
    b = [qs[j][:, k] for k in range(3) for _, j in PAIRS]
    one_p, one_q = torch.ones_like(p[:, 0]), torch.ones_like(q[:, 0])
    a += list(split3_f32(sq_norm(p))) + [one_p] * 3
    b += [one_q] * 3 + list(split3_f32(q_sq))
    return torch.stack(a, dim=1), torch.stack(b, dim=1)


def split_nn_plain(
    p_in: torch.Tensor,
    q_in: torch.Tensor,
    n: int,
    m: int,
    epilogue: str,
    *,
    keep: Optional[int] = None,
    clamp: bool = False,
    target_tile: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of Kernel S, on any device: the f32 product
    ``p_in[:n].float() @ q_in.float().T`` over target tiles of the first
    ``m`` targets, then the epilogue. It is the split distance because
    every bf16×bf16 product is exact in f32; only the order of the sums
    differs from the kernel's. Returns ``(idx int32[n], d f32[n])``."""
    check_split_args(p_in, q_in, n, m, epilogue, keep)
    a = p_in[:n].to(torch.float32)
    dev = a.device
    idx = torch.zeros(n, dtype=torch.int32, device=dev)
    if epilogue == "keep":
        d = (a @ q_in[keep:keep + 1].to(torch.float32).T)[:, 0]
        return idx, d.contiguous()
    best = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    key = torch.full((n,), PACKED14_KEY_INIT, dtype=torch.int32, device=dev)
    low = (1 << PACKED14_BITS) - 1
    for t0 in range(0, m, target_tile):
        d = a @ q_in[t0:min(m, t0 + target_tile)].to(torch.float32).T
        if epilogue == "argmin":
            arg = torch.argmin(d, dim=1)  # first minimum in the tile
            dmin = torch.gather(d, 1, arg[:, None])[:, 0]
            better = dmin < best  # strict: the earlier tile wins ties
            best = torch.where(better, dmin, best)
            idx = torch.where(better, (arg + t0).to(torch.int32), idx)
        elif epilogue == "min":
            best = torch.minimum(best, d.amin(dim=1))
        else:
            cols = torch.arange(t0, t0 + d.shape[1], dtype=torch.int32,
                                device=dev)
            bits = torch.clamp_min(d, 0.0).contiguous().view(torch.int32)
            k = (bits & ~low) | cols[None, :]
            key = torch.minimum(key, k.amin(dim=1))
    if epilogue == "packed14":
        return key & low, key.view(torch.float32)
    if clamp:
        best = torch.clamp_min(best, 0.0)
    return idx, best


def split_nn(
    p_in: torch.Tensor,
    q_in: torch.Tensor,
    n: int,
    m: int,
    epilogue: str,
    *,
    keep: Optional[int] = None,
    clamp: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split-distance reduction of the first ``n`` source rows over the
    first ``m`` targets: ``(idx int32[n], d f32[n])``. Kernel S on a CUDA
    tensor, :func:`split_nn_plain` on a CPU tensor, a raise otherwise."""
    pin_f32_precision()
    if p_in.device.type == "cuda":
        return split_nn_cuda(p_in, q_in, n, m, epilogue, keep=keep,
                             clamp=clamp)
    if p_in.device.type != "cpu":
        raise ValueError(f"split_nn runs on CPU or CUDA tensors, got "
                         f"{p_in.device}")
    return split_nn_plain(p_in, q_in, n, m, epilogue, keep=keep, clamp=clamp)
