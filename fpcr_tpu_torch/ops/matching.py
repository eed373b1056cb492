"""Brute-force nearest-neighbour correspondence search.

Counterpart of ``fpcr_tpu/ops/matching.py``. :func:`nn_argmin` is the one
dispatch point of the matcher: a CPU tensor takes the plain PyTorch version
:func:`nn_argmin_plain`, a CUDA tensor launches kernel K1
(``ops/matching_cuda.py``). There is no fallback between the two.

The plain version streams over source chunks and target tiles, so the
``[N, M]`` distance matrix never exists whole. ``exact=False`` computes the
expansion ``|p|² - 2 p·q + |q|²`` (one matmul per tile, clamped at 0);
``exact=True`` the difference form ``Σ (p - q)²``, the reference CUDA
kernel's arithmetic and the kernel's own. Ties keep the first minimum: the
argmin inside a tile returns the first occurrence and tiles are combined in
index order with a strict ``<``. A row with no valid target gets index 0
and distance ``inf``.

:func:`nn_argmin_packed` is the packed (value|index) reduction, the JAX
package's ``nn_argmin_pallas(mode='packed6_idx')``: one int32 min over keys
``(bits(d_ij) & ~(2^b - 1)) | j``, so picks are quantized to the distance
with its low ``b`` mantissa bits dropped and ties within a bucket go to the
lowest index; the returned distance is the exact one of the pick. A CPU
tensor takes :func:`nn_argmin_packed_plain`, a CUDA tensor launches kernel
K2.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.cloud import round_up
from ..utils.precision import pin_f32_precision
from .matching_cuda import (check_idx_bits, nn_argmin_cuda,
                            nn_argmin_packed_cuda)

PACKED_KEY_INIT = 0x7F7FFFFF  # bits of the largest finite float: a packed
# key that stays at it found no valid target (a masked target's key, from
# +inf's bits 0x7F800000, never gets below it)
PACKED_IDX_MAX_BITS = 16  # the JAX package's gate: m_pad <= 2^16


def pairwise_sqdist(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Squared distances ``[n, m]`` by the expansion, clamped at 0 (f32
    cancellation can leave tiny negatives on near-zero distances)."""
    p_sq = torch.sum(p * p, dim=-1, keepdim=True)
    q_sq = torch.sum(q * q, dim=-1)
    cross = torch.matmul(p, q.T)
    return torch.clamp(p_sq - 2.0 * cross + q_sq[None, :], min=0.0)


def pairwise_sqdist_exact(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Difference-form squared distances ``[n, m]``."""
    diff = p[:, None, :] - q[None, :, :]
    return torch.sum(diff * diff, dim=-1)


def nn_argmin_plain(
    p: torch.Tensor,
    q: torch.Tensor,
    q_mask: Optional[torch.Tensor] = None,
    *,
    source_chunk: int = 2048,
    target_tile: int = 2048,
    exact: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of K1, on any device:
    ``(idx int32[N], sqdist f32[N])``."""
    p = p.to(torch.float32)
    q = q.to(torch.float32)
    dist_fn = pairwise_sqdist_exact if exact else pairwise_sqdist
    n, m = p.shape[0], q.shape[0]
    best_d = torch.full((n,), float("inf"), dtype=torch.float32,
                        device=p.device)
    best_i = torch.zeros((n,), dtype=torch.int32, device=p.device)
    for s0 in range(0, n, source_chunk):
        p_c = p[s0:s0 + source_chunk]
        bd, bi = best_d[s0:s0 + source_chunk], best_i[s0:s0 + source_chunk]
        for t0 in range(0, m, target_tile):
            d = dist_fn(p_c, q[t0:t0 + target_tile])
            if q_mask is not None:
                valid = q_mask[t0:t0 + target_tile].to(torch.bool)
                d = torch.where(valid[None, :], d,
                                torch.full_like(d, float("inf")))
            arg = torch.argmin(d, dim=1)  # first minimum in the tile
            dmin = torch.gather(d, 1, arg[:, None])[:, 0]
            better = dmin < bd  # strict: the earlier tile wins ties
            bd.copy_(torch.where(better, dmin, bd))
            bi.copy_(torch.where(better, (arg + t0).to(torch.int32), bi))
    return best_i, best_d


def nn_argmin(
    p: torch.Tensor,
    q: torch.Tensor,
    q_mask: Optional[torch.Tensor] = None,
    *,
    source_chunk: int = 2048,
    target_tile: int = 2048,
    exact: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """For every source point, the index of its nearest target point and the
    squared distance: ``(idx int32[N], sqdist f32[N])``.

    On a CUDA tensor this launches kernel K1, which always computes the
    difference form; ``source_chunk``, ``target_tile`` and ``exact`` shape
    only the plain version that a CPU tensor takes.
    """
    pin_f32_precision()
    if p.device.type == "cuda":
        return nn_argmin_cuda(p, q, q_mask)
    if p.device.type != "cpu":
        raise ValueError(f"nn_argmin runs on CPU or CUDA tensors, got "
                         f"{p.device}")
    return nn_argmin_plain(p, q, q_mask, source_chunk=source_chunk,
                           target_tile=target_tile, exact=exact)


def packed_idx_bits(m: int, block_m: int = 8192) -> int:
    """The index bits of K2's keys for ``m`` targets: the JAX package's
    ``bit_length(m_pad - 1)`` with ``m_pad = round_up(m, min(block_m,
    round_up(m, 128)))`` (14 at 16,384 targets, 13 at 8,171, 16 at 35,947).
    Raises ``ValueError`` past ``m_pad = 2^16``, where the index would eat
    too much of the mantissa."""
    m_pad = round_up(m, min(block_m, round_up(m, 128)))
    if m_pad > (1 << PACKED_IDX_MAX_BITS):
        raise ValueError(
            f"pallas_mode='packed6_idx' supports m_pad <= 2^16 (got "
            f"{m_pad}): use the morton matcher at that scale")
    return max(1, (m_pad - 1).bit_length())


def packed_keys(d: torch.Tensor, rows: torch.Tensor,
                idx_bits: int) -> torch.Tensor:
    """int32 keys ``(bits(d) & ~(2^idx_bits - 1)) | rows`` of non-negative
    (or ``+inf``) distances ``d``: they order by the distance with its low
    ``idx_bits`` mantissa bits dropped, then by the row."""
    return (d.contiguous().view(torch.int32) & -(1 << idx_bits)) | rows


def nn_argmin_packed_plain(
    p: torch.Tensor,
    q: torch.Tensor,
    q_mask: Optional[torch.Tensor] = None,
    *,
    idx_bits: int,
    source_chunk: int = 2048,
    target_tile: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of K2, on any device: the tiled difference
    form, keys by :func:`packed_keys`, their ``amin``, and the exact
    distance to the pick. ``(idx int32[N], sqdist f32[N])``."""
    p = p.to(torch.float32)
    q = q.to(torch.float32)
    n, m = p.shape[0], q.shape[0]
    check_idx_bits(m, idx_bits)
    key = torch.full((n,), PACKED_KEY_INIT, dtype=torch.int32,
                     device=p.device)
    cols = torch.arange(m, dtype=torch.int32, device=p.device)
    for s0 in range(0, n, source_chunk):
        p_c = p[s0:s0 + source_chunk]
        for t0 in range(0, m, target_tile):
            d = pairwise_sqdist_exact(p_c, q[t0:t0 + target_tile])
            if q_mask is not None:
                valid = q_mask[t0:t0 + target_tile].to(torch.bool)
                d = torch.where(valid[None, :], d,
                                torch.full_like(d, float("inf")))
            k = packed_keys(d, cols[t0:t0 + target_tile][None, :], idx_bits)
            key[s0:s0 + source_chunk] = torch.minimum(
                key[s0:s0 + source_chunk], k.amin(dim=1))
    none = key == PACKED_KEY_INIT
    idx = torch.where(none, torch.zeros_like(key),
                      torch.clamp(key & ((1 << idx_bits) - 1), max=m - 1))
    diff = p - q[idx.long()]
    dist = torch.where(none, torch.full_like(p[:, 0], float("inf")),
                       torch.sum(diff * diff, dim=1))
    return idx, dist


def nn_argmin_packed(
    p: torch.Tensor,
    q: torch.Tensor,
    q_mask: Optional[torch.Tensor] = None,
    *,
    idx_bits: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest valid target by the packed (value|index) reduction: ``(idx
    int32[N], sqdist f32[N])``, the JAX package's
    ``nn_argmin_pallas(mode='packed6_idx')``. ``idx_bits`` defaults to
    :func:`packed_idx_bits` of the target count, which raises past its
    2^16 gate. On a CUDA tensor this launches kernel K2; a CPU tensor takes
    :func:`nn_argmin_packed_plain`."""
    pin_f32_precision()
    if idx_bits is None:
        idx_bits = packed_idx_bits(q.shape[0])
    if p.device.type == "cuda":
        return nn_argmin_packed_cuda(p, q, q_mask, idx_bits=idx_bits)
    if p.device.type != "cpu":
        raise ValueError(f"nn_argmin_packed runs on CPU or CUDA tensors, got "
                         f"{p.device}")
    return nn_argmin_packed_plain(p, q, q_mask, idx_bits=idx_bits)


def gather_correspondences(q: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Matched target points in source order (the reference's ``Q_index``)."""
    return torch.index_select(q, 0, idx)
