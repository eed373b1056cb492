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

:func:`suggest_cell_size`, :func:`build_voxel_table` and :func:`grid_nn`
take a batch as well, the JAX package's ``vmap`` over its registration loop
(``models/batch.py``): targets ``[B, M, 3]`` with one cell size each give a
stacked table (every tensor field with a leading B), and queries ``[B, N,
3]`` are matched against their own element's table, each element's result
bit for bit its own call's.
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
    multiplication by its reciprocal, which moves cell boundaries), 0-d or
    one size an element of ``points`` [B, N, 3]."""
    return torch.floor(points / h[..., None, None]).to(torch.int32)


class VoxelTable(NamedTuple):
    """A target's hash table; a stacked table (a batch of B targets) has
    every tensor field with a leading B."""

    points_sorted: torch.Tensor  # [M, 3] bucket-sorted target points
    orig_index: torch.Tensor  # [M] int32 sorted row -> original index
    starts: torch.Tensor  # [H] int32 first sorted row of each bucket
    counts: torch.Tensor  # [H] int32 bucket occupancy
    cell_size: torch.Tensor  # 0-d f32 on the table's device
    table_bits: int


def build_voxel_table(q, cell_size, table_bits: int = 20,
                      q_mask: Optional[torch.Tensor] = None) -> VoxelTable:
    """Hash-bucket the target cloud on its device (one sort). Masked rows
    go to an overflow bucket past the table. Targets ``[B, M, 3]`` (mask
    ``[B, M]``) with a cell size each (``[B]``, or one for all) give the
    stacked table of the B elements' own builds."""
    if not (isinstance(q, torch.Tensor) and q.ndim == 3):
        q = as_points(q)
    dev, lead = q.device, q.shape[:-2]
    h = torch.as_tensor(cell_size, dtype=torch.float32, device=dev)
    h = h.expand(lead) if h.ndim == 0 else h.reshape(lead)
    n_buckets = 1 << table_bits
    key = _hash_cells(_cells(q, h), table_bits)
    if q_mask is not None:
        key = torch.where(q_mask.to(device=dev, dtype=torch.bool), key,
                          torch.full_like(key, n_buckets))
    order = torch.argsort(key, dim=-1, stable=True)
    # each element's buckets counted over its own range, by an integer
    # scatter-add into a table of known size (a bincount would read its
    # size from the device), exact in any order
    batch = key.reshape(-1, key.shape[-1]).shape[0]
    flat = (key.reshape(batch, -1).to(torch.int64) + (n_buckets + 1)
            * torch.arange(batch, device=dev)[:, None]).reshape(-1)
    counts = torch.zeros(batch * (n_buckets + 1), dtype=torch.int32,
                         device=dev).index_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32)).reshape(
            lead + (n_buckets + 1,))
    starts = torch.cumsum(counts, -1, dtype=torch.int32) - counts
    return VoxelTable(points_sorted=torch.take_along_dim(
                          q, order[..., None], dim=-2).contiguous(),
                      orig_index=order.to(torch.int32),
                      starts=starts[..., :n_buckets].contiguous(),
                      counts=counts[..., :n_buckets].contiguous(),
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
    ``max_candidate_gathers`` candidate rows (N x 27 x cap). A batch ``p``
    [B, N, 3] against a stacked table gives ``[B, N]``, the limit applying
    to each element; a chunk then holds ``chunk // B`` queries of each
    element."""
    lead, n = p.shape[:-2], p.shape[-2]
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
    m = table.points_sorted.shape[-2]
    n_buckets = table.starts.shape[-1]
    batch = p.reshape(-1, n, 3).shape[0]
    # each element's first row in the flattened table and bucket arrays
    elem = torch.arange(batch, device=dev).reshape(lead + (1, 1))
    q_flat = table.points_sorted.reshape(-1, 3)
    starts, counts = table.starts.reshape(-1), table.counts.reshape(-1)
    orig_index = table.orig_index.reshape(-1)
    lane = torch.arange(cap, dtype=torch.int32, device=dev)
    idx, dmin, found = [], [], []
    step = max(1, chunk // batch)
    for s0 in range(0, n, step):
        pc = p[..., s0:s0 + step, :]
        rows = pc.shape[-2]
        nbr = (_cells(pc, table.cell_size)[..., :, None, :]
               + offsets)  # [..., r, 27, 3]
        keys = (_hash_cells(nbr, table.table_bits).to(torch.int64)
                + elem * n_buckets)  # [..., r, 27]
        start = starts[keys]
        count = counts[keys]
        cand = torch.clamp(start[..., None] + lane, 0, m - 1)
        cand = cand.reshape(lead + (rows, 27 * cap)).to(torch.int64)
        valid = (lane < torch.clamp(count[..., None], max=cap)).reshape(
            lead + (rows, 27 * cap))
        cand = cand + elem * m  # rows of the flattened table
        diff = q_flat[cand] - pc[..., :, None, :]  # [..., r, K, 3]
        d = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
             + diff[..., 2] * diff[..., 2])
        d = torch.where(valid, d, torch.full_like(d, float("inf")))
        best = torch.argmin(d, dim=-1, keepdim=True)  # the first minimum
        d_c = torch.gather(d, -1, best)[..., 0]
        orig = orig_index[torch.gather(cand, -1, best)[..., 0]]
        f_c = torch.isfinite(d_c)
        idx.append(torch.where(f_c, orig, torch.zeros_like(orig)))
        dmin.append(d_c)
        found.append(f_c)
    if not idx:
        return (torch.zeros(lead + (0,), dtype=torch.int32, device=dev),
                torch.zeros(lead + (0,), dtype=torch.float32, device=dev),
                torch.zeros(lead + (0,), dtype=torch.bool, device=dev))
    return (torch.cat(idx, dim=-1), torch.cat(dmin, dim=-1),
            torch.cat(found, dim=-1))


def suggest_cell_size(q: torch.Tensor, sample: int = 2048,
                      scale: float = 2.0) -> torch.Tensor:
    """≈ ``scale`` × the median nearest-neighbour spacing of a sample, as a
    0-d float32 tensor on ``q``'s device; ``[B]`` for clouds ``[B, M, 3]``,
    each element's its own call's.

    The slice is centred, zero-distance neighbours (duplicates) are left out
    of the median, and a cloud too degenerate to measure falls back to an
    extent-based size, 0 only when the cloud has no extent. The 2-NN
    distances are the difference form: in the expansion form a duplicate's
    distance can round to ~1e-7 instead of 0 and then sets the size."""
    q = q.to(torch.float32)
    q_slice = q[..., : min(q.shape[-2], 65536), :]
    q_slice = q_slice - q_slice.mean(dim=-2, keepdim=True)
    step = max(1, q_slice.shape[-2] // sample)
    sub = q_slice[..., ::step, :][..., :sample, :]
    # 2-NN against the slice holding sub: slot 0 is the point itself
    _, d = knn(sub, q_slice, 2, exact=True)
    d1 = torch.clamp(d[..., 1], min=0.0)
    pos = d1 > 0
    n_pos = pos.sum(dim=-1, keepdim=True)
    # lower median of the positive spacings (duplicates sort to +inf),
    # gathered on the device: no host read
    sorted_d = torch.sort(torch.where(pos, d1, torch.full_like(d1, np.inf)),
                          dim=-1)
    med = torch.sqrt(torch.take_along_dim(
        sorted_d.values, torch.clamp(n_pos - 1, min=0) // 2, dim=-1))[..., 0]
    n_pos = n_pos[..., 0]
    ext = torch.linalg.vector_norm(q_slice.amax(dim=-2)
                                   - q_slice.amin(dim=-2), dim=-1)
    fallback = ext / float(np.cbrt(np.float32(max(q_slice.shape[-2], 1))))
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
