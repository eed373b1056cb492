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
from .split_cuda import (PACKED14_BITS, PACKED14_KEY_INIT, TILE,
                         check_split_args, split_nn_cuda)

LANES = 8  # augmented lanes: 5 used, padded to 8
INVALID_SURROGATE = 1e30  # the |q|² lane of a padded target
INF_BITS = 0x7F800000  # the bits of +inf: above every finite key bucket
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
    ``m`` targets, then the epilogue (:func:`split_reduce_plain`). It is
    the split distance because every bf16×bf16 product is exact in f32;
    only the order of the sums differs from the kernel's. Returns ``(idx
    int32[n], d f32[n])``."""
    check_split_args(p_in, q_in, n, m, epilogue, keep)
    a = p_in[:n].to(torch.float32)
    if epilogue == "keep":
        d = (a @ q_in[keep:keep + 1].to(torch.float32).T)[:, 0]
        return (torch.zeros(n, dtype=torch.int32, device=a.device),
                d.contiguous())

    def tile(t0, rows):
        q = q_in[t0:min(m, t0 + target_tile)].to(torch.float32)
        return (a if rows is None else a[rows]) @ q.T

    return _reduce_tiles(tile, m, target_tile, n, epilogue, clamp, a.device)


def split_reduce_plain(values: torch.Tensor, epilogue: str, *,
                       keep: Optional[int] = None, clamp: bool = False,
                       target_tile: int = 2048
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`split_nn_plain`'s reduction of given values f32[n, m]: the
    epilogue over target tiles of ``target_tile`` columns."""
    n, m = values.shape
    if epilogue == "keep":
        return (torch.zeros(n, dtype=torch.int32, device=values.device),
                values[:, keep].contiguous())

    def tile(t0, rows):
        return (values if rows is None else values[rows])[
            :, t0:t0 + target_tile]

    return _reduce_tiles(tile, m, target_tile, n, epilogue, clamp,
                         values.device)


def _reduce_tiles(tile, m: int, target_tile: int, n: int, epilogue: str,
                  clamp: bool, dev) -> Tuple[torch.Tensor, torch.Tensor]:
    """The argmin (first minimum), ``packed14`` key or least value of the
    values ``tile(t0, rows)`` [rows, width] of the columns from ``t0`` on
    (every row where ``rows`` is None), over tiles of ``target_tile`` in
    column order. A NaN is never the argmin: the rows in which a tile's
    first minimum was a NaN are searched again at the end, a NaN read as
    +inf (one host read a call). It keys above every finite value and
    makes the least value NaN; -0 keys as +0, as E3's ``max(d, 0)`` gives
    it."""
    inf = float("inf")
    idx = torch.zeros(n, dtype=torch.int32, device=dev)
    best = torch.full((n,), inf, dtype=torch.float32, device=dev)
    key = torch.full((n,), PACKED14_KEY_INIT, dtype=torch.int32, device=dev)
    nan = torch.zeros(n, dtype=torch.bool, device=dev)
    low = (1 << PACKED14_BITS) - 1
    for t0 in range(0, m, target_tile):
        d = tile(t0, None)
        if epilogue == "argmin":
            arg = torch.argmin(d, dim=1)  # first minimum (or NaN) in the tile
            dmin = torch.gather(d, 1, arg[:, None])[:, 0]
            nan |= dmin.isnan()
            better = dmin < best  # strict: the earlier tile wins ties
            best = torch.where(better, dmin, best)
            idx = torch.where(better, (arg + t0).to(torch.int32), idx)
        elif epilogue == "min":
            best = torch.minimum(best, d.amin(dim=1))
        else:
            cols = torch.arange(t0, t0 + d.shape[1], dtype=torch.int32,
                                device=dev)
            # max(d, 0) keeps a NaN and -0: without the sign bit -0 keys
            # as +0, and a NaN of either sign above +inf
            bits = torch.clamp_min(d, 0.0).contiguous().view(torch.int32)
            k = (bits & (0x7FFFFFFF & ~low)) | cols[None, :]
            key = torch.minimum(key, k.amin(dim=1))
    if epilogue == "argmin":
        rows = torch.nonzero(nan)[:, 0]
        if len(rows):
            def no_nan(t0, _rows):
                v = tile(t0, rows)
                return torch.where(v.isnan(), inf, v)

            idx[rows], best[rows] = _reduce_tiles(
                no_nan, m, target_tile, len(rows), "argmin", False, dev)
    if epilogue == "packed14":
        return key & low, key.view(torch.float32)
    if clamp:
        best = torch.clamp_min(best, 0.0)
    return idx, best


def split_wgmma_mirror(values: torch.Tensor, epilogue: str, *,
                       slice_len: int, m: Optional[int] = None,
                       keep: Optional[int] = None, clamp: bool = False,
                       tile: int = TILE) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reduction of ``csrc/split_wgmma.cu`` in its own order, in plain
    torch, over the kernel's values f32[n, >= m] (the CPU tests' mirror of
    the kernel, which runs on the card only): the first ``m`` columns
    (default all) are the targets; a tile reads the columns past them as
    the kernel does (the operand's padded rows, then the zeros of a copy
    past its end) and masks them.

    Per target slice of ``slice_len`` columns and 128-column tile, columns
    at or past the slice's end read +inf. Thread ``t`` of a row's quad
    holds columns 8c + 2t + e (slot 2c + e) of each tile. Per tile, each
    thread's least value (the int32 min of the bits where no sign bit is
    set, else the float min; a NaN never wins) and the quad's least of
    those; where that is strictly below the row's best (``packed14``: its
    bucket, max(bits, 0) & ~0x3FFF, strictly below the best bucket) the
    quad keeps the tile's values. After the slice each thread takes its
    first kept column equal to the best (``packed14``: in the best bucket)
    and the quad the least column; ``min`` keeps a running min a thread
    and whether the int32 max of a tile's bits lay above +inf's (a NaN),
    and takes the quad's at the end, NaN where any thread saw one. The
    slices combine in order (strict ``<``), by an int32 min of keys, or by
    a min that keeps a NaN (the card's NaN, 0x7FFFFFFF)."""
    n, width = values.shape
    m = width if m is None else m
    dev = values.device
    inf = float("inf")
    idx = torch.zeros(n, dtype=torch.int32, device=dev)
    if epilogue == "keep":
        return idx, values[:, keep].contiguous()
    low = (1 << PACKED14_BITS) - 1
    slot_col = torch.tensor([[8 * (k >> 1) + 2 * t + (k & 1)
                              for k in range(32)] for t in range(4)],
                            device=dev)  # [thread, slot] -> column
    big = torch.iinfo(torch.int32).max
    nan = torch.tensor(0x7FFFFFFF, dtype=torch.int32,
                       device=dev).view(torch.float32)  # the card's NaN
    best_d = torch.full((n,), inf, dtype=torch.float32, device=dev)
    best_i = torch.zeros(n, dtype=torch.int32, device=dev)
    best_key = torch.full((n,), PACKED14_KEY_INIT, dtype=torch.int32,
                          device=dev)
    for j_begin in range(0, m, slice_len):
        j_end = min(m, j_begin + slice_len)
        run = torch.full((n,), inf, dtype=torch.float32, device=dev)
        run_t = torch.full((n, 4), inf, dtype=torch.float32, device=dev)
        bucket = torch.full((n,), INF_BITS, dtype=torch.int32, device=dev)
        kept = torch.zeros((n, 4, 32), dtype=torch.float32, device=dev)
        kept_t0 = torch.full((n,), -1, dtype=torch.int64, device=dev)
        nan_t = torch.zeros((n, 4), dtype=torch.bool, device=dev)
        for t0 in range(j_begin, j_end, tile):
            cols = t0 + slot_col  # [4, 32]
            v = torch.zeros((n, 4, 32), dtype=torch.float32, device=dev)
            read = cols < width
            v[:, read] = values[:, cols[read]]
            v = torch.where(cols < j_end, v, inf)  # past the slice's end
            bits = v.view(torch.int32)
            lo = bits.amin(dim=2)  # [n, 4]
            if epilogue == "packed14":
                b = lo.clamp_min(0).amin(dim=1) & ~low  # the quad's bucket
                better = b < bucket
                bucket = torch.where(better, b, bucket)
            else:
                no_nan = torch.where(v.isnan(), inf, v)
                m_t = torch.where(lo >= 0, lo.view(torch.float32),
                                  no_nan.amin(dim=2))
                m_t = torch.where(m_t.isnan(), inf, m_t)
                if epilogue == "min":
                    run_t = torch.minimum(run_t, m_t)
                    nan_t |= bits.amax(dim=2) > INF_BITS
                    continue
                quad = m_t.amin(dim=1)
                better = quad < run
                run = torch.where(better, quad, run)
            kept = torch.where(better[:, None, None], v, kept)
            kept_t0 = torch.where(better, t0, kept_t0)
        found = kept_t0 >= 0
        if epilogue == "min":  # the quad's least; a NaN kept, as combined
            part = torch.where(nan_t.any(dim=1), nan, run_t.amin(dim=1))
            best_d = torch.where(part.isnan() | best_d.isnan(), nan,
                                 torch.minimum(best_d, part))
            continue
        if epilogue == "argmin":
            hit = kept <= run[:, None, None]
        else:
            edge = (bucket | low)[:, None, None]
            hit = kept.view(torch.int32).clamp_min(0) <= edge
        first = torch.where(hit, slot_col[None], big).amin(dim=2)  # [n, 4]
        col = first.amin(dim=1)  # the quad's least column
        c = col.clamp_max(tile - 1).long()
        thread = (c & 7) >> 1
        slot_k = 2 * (c >> 3) + (c & 1)
        val = kept[torch.arange(n, device=dev), thread, slot_k]
        j = (kept_t0 + col).to(torch.int32)
        if epilogue == "argmin":
            d = torch.where(found, val, inf)
            j = torch.where(found, j, 0)
            better = d < best_d  # strict: the earlier slice wins ties
            best_d = torch.where(better, d, best_d)
            best_i = torch.where(better, j, best_i)
        else:
            key = torch.where(found, bucket | j, PACKED14_KEY_INIT)
            best_key = torch.minimum(best_key, key)
    if epilogue == "packed14":
        return best_key & low, best_key.view(torch.float32)
    if epilogue == "min":
        return idx, best_d
    if clamp:
        best_d = torch.clamp_min(best_d, 0.0)
    return best_i, best_d


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
