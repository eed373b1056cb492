"""Voxel-hash grid: fixed-radius nearest neighbours, voxel downsampling and
cell sizing from a cloud's point spacing.

Counterpart of ``fpcr_tpu/ops/grid.py``, in plain torch throughout (the JAX
package computes all of it in XLA, outside its Pallas kernels):

* :func:`build_voxel_table` (once per target): cells ``floor(q/h)``, the
  73856093/19349663/83492791 prime XOR hash into ``2^table_bits`` buckets,
  points sorted by bucket (a stable argsort, as ``jnp.argsort``) and dense
  ``starts``/``counts``;
* :func:`grid_nn`: each query reads up to ``cap`` candidates of each of
  its 27 neighbouring buckets and keeps the first minimum. Collisions only
  add candidates; candidates beyond ``cap`` in a bucket are dropped, and
  ``found`` is False where no candidate was in range. The queries run in
  chunks, which bound memory and change no result;
* :func:`voxel_downsample`: one centroid per occupied voxel by an exact
  lexicographic sort of the cells and sums over the sorted runs
  (``torch.segment_reduce``, deterministic on the card, where
  ``index_add_`` would add with atomics in a varying order).

The hash is computed in int64 and masked to ``table_bits``: the low bits of
a product and of an XOR depend only on the low bits of their operands, so
the buckets equal JAX's wrapping int32 hash, negative cells included.

Guarantee: for clouds whose true NN lies within one cell (``dist <= h``) and
buckets under ``cap`` occupancy, :func:`grid_nn` equals brute force.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.cloud import as_points
from .normals import knn

_P1, _P2, _P3 = 73856093, 19349663, 83492791

# grid_nn refuses a query of more than this many candidate rows (N x 27 x
# cap). The JAX package's 120,000,000 was set by a TPU worker crash at 1M
# points; here the rows go through in chunks of CHUNK queries, so memory
# does not grow with N. On an NVIDIA H100 80GB HBM3 (700 W) grid_nn ran at
# cap 8 for 262,144 and 1,048,576 queries (56.6M and 226.5M rows) in 5.5
# and 21.0 ms a call (chip_smoke.py), so the default admits 1M points at
# cap 8; larger sizes are untested.
MAX_CANDIDATE_GATHERS = 1 << 28
CHUNK = 65536  # queries per chunk: [65536, 216, 3] f32 candidates, 170 MB


def _hash_cells(cells: torch.Tensor, table_bits: int) -> torch.Tensor:
    """Spatial hash of integer cells ``[..., 3]`` → int32 bucket id."""
    c = cells.to(torch.int64)
    h = (c[..., 0] * _P1) ^ (c[..., 1] * _P2) ^ (c[..., 2] * _P3)
    return (h & ((1 << table_bits) - 1)).to(torch.int32)


def _cells(points: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Integer cells int32 ``floor(points / h)``; ``h`` a tensor on the
    points' device (on the card a division by a CPU scalar becomes a
    multiplication by its reciprocal, which moves cell boundaries)."""
    return torch.floor(points / h).to(torch.int32)


class VoxelTable(NamedTuple):
    points_sorted: torch.Tensor  # [M, 3] bucket-sorted target points
    orig_index: torch.Tensor  # [M] int32 sorted row -> original index
    starts: torch.Tensor  # [H] int32 first sorted row of each bucket
    counts: torch.Tensor  # [H] int32 bucket occupancy
    cell_size: torch.Tensor  # 0-d f32 on the table's device
    table_bits: int


def build_voxel_table(q, cell_size, table_bits: int = 20,
                      q_mask: Optional[torch.Tensor] = None) -> VoxelTable:
    """Hash-bucket the target cloud on its device (one sort). Masked rows
    go to an overflow bucket past the table."""
    q = as_points(q)
    dev = q.device
    h = torch.as_tensor(cell_size, dtype=torch.float32, device=dev).reshape(())
    n_buckets = 1 << table_bits
    key = _hash_cells(_cells(q, h), table_bits)
    if q_mask is not None:
        key = torch.where(q_mask.to(device=dev, dtype=torch.bool), key,
                          torch.full_like(key, n_buckets))
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key.to(torch.int64),
                            minlength=n_buckets + 1).to(torch.int32)
    starts = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    return VoxelTable(points_sorted=q[order].contiguous(),
                      orig_index=order.to(torch.int32),
                      starts=starts[:n_buckets], counts=counts[:n_buckets],
                      cell_size=h, table_bits=table_bits)


def _neighbor_offsets(device) -> torch.Tensor:
    """The 27 cell offsets int32 ``[27, 3]`` in ``meshgrid(indexing='ij')``
    order, made on the device (a copy from the host would synchronise)."""
    k = torch.arange(27, dtype=torch.int32, device=device)
    return torch.stack([k // 9, (k // 3) % 3, k % 3], dim=1) - 1


def grid_nn(p: torch.Tensor, table: VoxelTable, cap: int = 8,
            chunk: int = CHUNK,
            max_candidate_gathers: int = MAX_CANDIDATE_GATHERS
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-radius NN through the voxel table: ``(idx int32[N], sqdist
    f32[N], found bool[N])``, ``idx`` into the original target order, idx 0
    and ``inf`` where nothing was found. Raises ``ValueError`` above
    ``max_candidate_gathers`` candidate rows (N x 27 x cap)."""
    n = p.shape[0]
    budget = n * 27 * cap
    if budget > max_candidate_gathers:
        raise ValueError(
            f"grid_nn candidate budget {budget:,} (N={n:,} x 27 x cap={cap}) "
            f"exceeds the limit {max_candidate_gathers:,}, the largest "
            "measured; use ICPConfig(matcher='morton') for larger clouds, "
            "or lower cap / raise max_candidate_gathers explicitly")
    p = p.to(torch.float32)
    dev = p.device
    offsets = _neighbor_offsets(dev)
    m = table.points_sorted.shape[0]
    lane = torch.arange(cap, dtype=torch.int32, device=dev)
    idx, dmin, found = [], [], []
    for s0 in range(0, n, chunk):
        pc = p[s0:s0 + chunk]
        rows = pc.shape[0]
        nbr = _cells(pc, table.cell_size)[:, None, :] + offsets[None]
        keys = _hash_cells(nbr, table.table_bits).to(torch.int64)  # [r, 27]
        start = table.starts[keys]
        count = table.counts[keys]
        cand = torch.clamp(start[:, :, None] + lane, 0, m - 1)
        cand = cand.reshape(rows, 27 * cap).to(torch.int64)
        valid = (lane < torch.clamp(count[:, :, None], max=cap)).reshape(
            rows, 27 * cap)
        diff = table.points_sorted[cand] - pc[:, None, :]  # [r, K, 3]
        d = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
             + diff[..., 2] * diff[..., 2])
        d = torch.where(valid, d, torch.full_like(d, float("inf")))
        best = torch.argmin(d, dim=1, keepdim=True)  # the first minimum
        d_c = torch.gather(d, 1, best)[:, 0]
        orig = table.orig_index[torch.gather(cand, 1, best)[:, 0]]
        f_c = torch.isfinite(d_c)
        idx.append(torch.where(f_c, orig, torch.zeros_like(orig)))
        dmin.append(d_c)
        found.append(f_c)
    if not idx:
        return (torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros(0, dtype=torch.float32, device=dev),
                torch.zeros(0, dtype=torch.bool, device=dev))
    return torch.cat(idx), torch.cat(dmin), torch.cat(found)


def suggest_cell_size(q: torch.Tensor, sample: int = 2048,
                      scale: float = 2.0) -> torch.Tensor:
    """≈ ``scale`` × the median nearest-neighbour spacing of a sample, as a
    0-d float32 tensor on ``q``'s device.

    The slice is centred, zero-distance neighbours (duplicates) are left out
    of the median, and a cloud too degenerate to measure falls back to an
    extent-based size, 0 only when the cloud has no extent. The 2-NN
    distances are the difference form: in the expansion form a duplicate's
    distance can round to ~1e-7 instead of 0 and then sets the size."""
    q = q.to(torch.float32)
    q_slice = q[: min(q.shape[0], 65536)]
    q_slice = q_slice - q_slice.mean(dim=0)
    step = max(1, q_slice.shape[0] // sample)
    sub = q_slice[::step][:sample]
    # 2-NN against the slice holding sub: slot 0 is the point itself
    _, d = knn(sub, q_slice, 2, exact=True)
    d1 = torch.clamp(d[:, 1], min=0.0)
    pos = d1 > 0
    n_pos = pos.sum()
    # lower median of the positive spacings (duplicates sort to +inf)
    sorted_d = torch.sort(torch.where(pos, d1, torch.full_like(d1, np.inf)))
    med = torch.sqrt(sorted_d.values[torch.clamp(n_pos - 1, min=0) // 2])
    ext = torch.linalg.vector_norm(q_slice.amax(dim=0) - q_slice.amin(dim=0))
    fallback = ext / float(np.cbrt(np.float32(max(q_slice.shape[0], 1))))
    med = torch.where((n_pos > 0) & torch.isfinite(med) & (med > 0), med,
                      fallback)
    return (scale * med).to(torch.float32)


def voxel_downsample(points, voxel_size,
                     mask: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One centroid per occupied voxel: ``(centroids [N, 3], valid [N]
    bool)``, the fixed-size padded convention every loop here accepts
    through masks, the valid centroids first, in the order of the cells'
    lexicographic sort. Rows with ``mask`` False are sorted last and add
    nothing."""
    pts = as_points(points)
    n, dev = pts.shape[0], pts.device
    h = torch.as_tensor(voxel_size, dtype=torch.float32, device=dev)
    cells = _cells(pts, h)
    invalid = (torch.zeros(n, dtype=torch.int32, device=dev) if mask is None
               else (~mask.to(device=dev, dtype=torch.bool)).to(torch.int32))
    # lexsort((c2, c1, c0, invalid)): stable sorts, least significant first
    order = torch.arange(n, device=dev)
    for key in (cells[:, 2], cells[:, 1], cells[:, 0], invalid):
        order = order[torch.argsort(key[order], stable=True)]
    cells_s, pts_s = cells[order], pts[order]
    w = (torch.ones(n, dtype=torch.float32, device=dev) if mask is None
         else mask.to(device=dev, dtype=torch.float32)[order])
    changed = (cells_s[1:] != cells_s[:-1]).any(dim=1).to(torch.int64)
    seg_id = torch.cumsum(torch.cat([changed.new_ones(min(n, 1)), changed]),
                          0) - 1
    lengths = torch.bincount(seg_id, minlength=n)
    sums = torch.segment_reduce(torch.cat([pts_s * w[:, None], w[:, None]],
                                          dim=1), "sum", lengths=lengths,
                                axis=0)
    counts = sums[:, 3]
    return sums[:, :3] / torch.clamp(counts, min=1.0)[:, None], counts > 0
