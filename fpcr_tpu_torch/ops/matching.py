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
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils.precision import pin_f32_precision
from .matching_cuda import nn_argmin_cuda


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


def gather_correspondences(q: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Matched target points in source order (the reference's ``Q_index``)."""
    return torch.index_select(q, 0, idx)
