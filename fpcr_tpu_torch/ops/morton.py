"""Morton-order band matching: the large-N matcher.

Counterpart of ``fpcr_tpu/ops/morton.py``. The target is quantized to 30-bit
Morton codes (10 bits an axis) and sorted along the curve once per
registration; the source is sorted along the same frame once. Every
iteration, each chunk of ``chunk`` consecutive sorted source rows finds its
probe rank in the sorted target (one ``searchsorted``) and is matched by
brute force against the contiguous band of target rows around that rank.
The work is O(N · band), and a true neighbour outside the band is missed;
ICP absorbs the misses (``auto_trim`` defaults on for this matcher).

Two band geometries exist, as in the JAX package:

* :func:`morton_nn` is the XLA geometry: ``band = chunk + 2·window`` rows
  from ``clip(rank - band/2)``, expansion-form distances. It is plain
  PyTorch on every device.
* :func:`morton_nn_band` is kernel K3's geometry (``morton_nn_pallas``):
  ``band = round_up(chunk + 2·window + 128, 128)``, the base aligned down to
  128 and clipped to ``m_pad - band`` with ``m_pad = round_up(m, 128) +
  band`` (:func:`band_bases`; K3 computes them in its block prologue, whose
  scalar mirror is :func:`prologue_bases`). A CUDA tensor launches K3
  (``ops/morton_cuda.py``); a CPU tensor
  takes its plain version :func:`morton_nn_band_plain`. Its ``mode=
  'packed6_idx'`` is K3's packed (value|index) reduction, kernel K3p, whose
  plain version is :func:`morton_nn_band_packed_plain`.

Both process the ``[chunks, chunk, band]`` distance blocks in groups of at
most ``PAIR_BUDGET`` pairs, so memory stays bounded at 1M points. Argsorts
are stable (``jnp.argsort`` is): duplicate codes are common at 1M points.

Everything up to the matchers takes a batch, the JAX package's ``vmap``
over its registration loop (``models/batch.py``): targets ``[B, M, 3]``
give a stacked table (:func:`build_morton_table`; every field with a
leading B, ``valid_count`` int32[B]), each element's fields bit for bit
its own build's, and sources ``[B, N, 3]`` their orders, probe ranks and
bases ``[B, ...]`` against it. The matchers take ``[B, N, 3]`` against a
stacked table: on the card one launch of K3 or K3p for the whole batch,
and the plain versions run the chunks of every element as one sequence,
each element's outputs bit for bit those of its own call.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.cloud import round_up
from .matching import (PACKED_KEY_INIT, gather_correspondences, nn_argmin,
                       nn_argmin_plain, packed_keys)
from .normals import smallest_k

_BITS = 10  # 10 bits an axis -> 30-bit codes, int32-safe
_MASKED_CODE = 2 ** 31 - 1  # masked target rows sort to the end
BAND_ALIGN = 128  # K3's band bases are aligned down to this many rows
PAIR_BUDGET = 2 ** 23  # (source, target) pairs per distance block group
# the JAX package's band kernel modes: 'packed6_idx' is K3p, every other
# (bf16x6, HIGHEST and the TPU pipeline schedules) computes K3's function
BAND_MODES = ("packed6", "highest", "packed6_idx", "packed6_pipe",
              "packed6_seq", "packed6_pipe2", "packed6_pipe3")


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of int32 ``x`` two zero bits apart."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_codes(points: torch.Tensor, lo: torch.Tensor,
                 inv_extent: torch.Tensor) -> torch.Tensor:
    """30-bit Morton codes int32[N] of ``[N, 3]`` points given the bounds
    ``lo`` and ``1/extent``, with the JAX package's float expression order;
    ``[..., N, 3]`` points with bounds ``[..., 3]`` give ``[..., N]``."""
    u = torch.clamp(((points - lo.unsqueeze(-2)) * inv_extent.unsqueeze(-2)
                     * (1 << _BITS)).to(torch.int32), 0, (1 << _BITS) - 1)
    return ((_part1by2(u[..., 0]) << 2) | (_part1by2(u[..., 1]) << 1)
            | _part1by2(u[..., 2]))


class MortonTable(NamedTuple):
    """A target sorted along the curve; a stacked table (a batch of B
    targets) has every field with a leading B."""

    points_sorted: torch.Tensor  # [M, 3] target along the curve
    codes_sorted: torch.Tensor  # [M] int32, masked rows at the end
    orig_index: torch.Tensor  # [M] int32: sorted position -> target index
    lo: torch.Tensor  # [3] quantization bounds
    inv_extent: torch.Tensor  # [3]
    valid_count: torch.Tensor  # int32 scalar on the device: rows beyond
    # it are masked


def table_element(table: MortonTable, b: int) -> MortonTable:
    """Element ``b`` of a stacked table: the table of its own target."""
    return MortonTable(*(field[b] for field in table))


def build_morton_table(q: torch.Tensor, q_mask: Optional[torch.Tensor] = None,
                       shift: float = 0.0) -> MortonTable:
    """Sort the target along the Morton curve. ``shift`` (in cells, e.g.
    0.5) offsets the quantization grid: a half-cell-shifted second table
    covers the first curve's seams. Targets ``[B, M, 3]`` (mask ``[B, M]``)
    give the stacked table of the B elements' own builds."""
    q = q.to(torch.float32)
    m = q.shape[-2]
    if q_mask is not None:
        mask = q_mask.to(torch.bool)
        inf = torch.full_like(q, float("inf"))
        lo = torch.where(mask[..., None], q, inf).amin(dim=-2)
        hi = torch.where(mask[..., None], q, -inf).amax(dim=-2)
        valid_count = mask.sum(dim=-1, dtype=torch.int32)
    else:
        lo, hi = q.amin(dim=-2), q.amax(dim=-2)
        # a fill on the device: torch.tensor would copy from the host
        valid_count = torch.full(q.shape[:-2], m, dtype=torch.int32,
                                 device=q.device)
    inv_extent = 1.0 / torch.clamp(hi - lo, min=1e-12)
    if shift:
        lo = lo - shift * (1.0 / inv_extent) / (1 << _BITS)
    codes = morton_codes(q, lo, inv_extent)
    if q_mask is not None:
        codes = torch.where(mask, codes, torch.full_like(codes, _MASKED_CODE))
    order = torch.argsort(codes, dim=-1, stable=True)
    return MortonTable(points_sorted=gather_correspondences(q, order)
                       .contiguous(),
                       codes_sorted=torch.take_along_dim(codes, order, -1)
                       .contiguous(),
                       orig_index=order.to(torch.int32), lo=lo,
                       inv_extent=inv_extent, valid_count=valid_count)


def source_morton_order(p: torch.Tensor, table: MortonTable) -> torch.Tensor:
    """Stable Morton sort order int32[N] of the source in the target's
    frame, applied once before the ICP loop: the solve and the error do not
    depend on the row order, and rigid iterates keep consecutive rows
    spatially coherent. ``[B, N, 3]`` against a stacked table gives each
    element's order, ``[B, N]``."""
    codes = morton_codes(p.to(torch.float32), table.lo, table.inv_extent)
    return torch.argsort(codes, dim=-1, stable=True).to(torch.int32)


def probe_ranks(p: torch.Tensor, table: MortonTable,
                chunk: int) -> torch.Tensor:
    """Rank int64[chunks] in the sorted target of each chunk's middle row
    (``[B, chunks]`` for a batch against a stacked table). The tail chunk is
    padded with the last real row, never with zeros: a zero probe would
    quantize to the origin cell and put the band anywhere."""
    n = p.shape[-2]
    rows = torch.clamp(
        torch.arange(math.ceil(n / chunk), device=p.device) * chunk
        + chunk // 2, max=n - 1)
    codes = morton_codes(p[..., rows, :].to(torch.float32), table.lo,
                         table.inv_extent)
    return torch.searchsorted(table.codes_sorted, codes)


def band_rows(chunk: int, window: int) -> int:
    """K3's band height: ``round_up(chunk + 2·window + 128, 128)``."""
    return round_up(chunk + 2 * window + BAND_ALIGN, BAND_ALIGN)


def band_bases(p: torch.Tensor, table: MortonTable, chunk: int,
               window: int) -> Tuple[int, torch.Tensor]:
    """K3's band geometry: ``(band, bases int32[chunks])``, or ``[B,
    chunks]`` for a batch."""
    band = band_rows(chunk, window)
    m_pad = round_up(table.points_sorted.shape[-2], BAND_ALIGN) + band
    bases = torch.clamp(probe_ranks(p, table, chunk) - band // 2, 0,
                        m_pad - band)
    return band, (bases & ~(BAND_ALIGN - 1)).to(torch.int32).contiguous()


def _float2int_rz(u: np.float32) -> int:
    """CUDA's ``__float2int_rz``, which torch's CUDA float-to-int32 cast
    compiles to: truncation, saturating at the int32 range, NaN to 0."""
    if np.isnan(u):
        return 0
    if u >= 2.0 ** 31:
        return 2 ** 31 - 1
    if u <= -2.0 ** 31:
        return -2 ** 31
    return int(u)


def _part1by2_int(x: int) -> int:
    x &= 0x3FF
    for shift, mask in ((16, 0x030000FF), (8, 0x0300F00F), (4, 0x030C30C3),
                        (2, 0x09249249)):
        x = (x | (x << shift)) & mask
    return x


def _lower_bound_32(codes: np.ndarray, code: int) -> int:
    """The first ``i`` with ``codes[i] >= code``, by the kernel's 32-ary
    warp search: lane ``j`` tests row ``lo + (j + 1)·step - 1`` a round."""
    lo, hi = 0, codes.shape[0]
    while lo < hi:
        step = (hi - lo + 31) // 32
        ge = [pos >= hi or int(codes[pos]) >= code
              for pos in (lo + (j + 1) * step - 1 for j in range(32))]
        if not any(ge):
            lo = hi
        else:
            f = ge.index(True)
            hi = min(lo + (f + 1) * step - 1, hi)
            lo += f * step
    return lo


def prologue_bases(p: torch.Tensor, table: MortonTable, chunk: int,
                   window: int) -> Tuple[int, np.ndarray]:
    """The scalar mirror of kernels K3/K3p's block prologue
    (``csrc/morton.cu``): ``(band, bases int32[chunks])``, each chunk's
    probe row ``min(c·chunk + chunk/2, n-1)`` quantized in float32 in
    :func:`morton_codes`' operation order, its rank by the kernel's 32-ary
    lower-bound search, then clip and align as :func:`band_bases`. Equals
    :func:`band_bases` wherever torch's cast does not overflow. A batch
    gives each element's bases, ``[B, chunks]``."""
    if p.ndim == 3:
        band = band_rows(chunk, window)
        return band, np.stack([
            prologue_bases(p[b], table_element(table, b), chunk, window)[1]
            for b in range(p.shape[0])]).reshape(p.shape[0], -1)
    band = band_rows(chunk, window)
    pts = p.detach().to(torch.float32).cpu().numpy()
    lo = table.lo.detach().cpu().numpy().astype(np.float32)
    inv = table.inv_extent.detach().cpu().numpy().astype(np.float32)
    codes = table.codes_sorted.detach().cpu().numpy()
    n, top = pts.shape[0], round_up(codes.shape[0], BAND_ALIGN)
    bases = np.empty(math.ceil(n / chunk), np.int32)
    with np.errstate(over="ignore", invalid="ignore"):
        for c in range(bases.shape[0]):
            row = min(c * chunk + chunk // 2, n - 1)
            code = 0
            for a in range(3):
                u = (pts[row, a] - lo[a]) * inv[a] * np.float32(1 << _BITS)
                cell = min(max(_float2int_rz(u), 0), (1 << _BITS) - 1)
                code |= _part1by2_int(cell) << (2 - a)
            rank = _lower_bound_32(codes, code)
            bases[c] = min(max(rank - band // 2, 0), top) & ~(BAND_ALIGN - 1)
    return band, bases


def _band_blocks(p: torch.Tensor, q_sorted: torch.Tensor,
                 valid_count: torch.Tensor, bases: torch.Tensor, chunk: int,
                 band: int, exact: bool):
    """Yield ``(c0, rows, d)`` for groups of chunks: the chunk range start,
    the band's table rows int64[G, band] and the distances f32[G, chunk,
    band], +inf at rows that are masked or past the table. Source rows past
    ``n`` repeat the last row and are the caller's to drop. A batch (``p``
    [B, N, 3], ``q_sorted`` [B, M, 3], ``valid_count`` [B], ``bases`` [B,
    C]) yields the chunks of every element as one sequence, element-major:
    chunk ``c0`` is chunk ``c0 % C`` of element ``c0 // C``, and its rows
    index its own element's table."""
    n, m = p.shape[-2], q_sorted.shape[-2]
    num_chunks = bases.shape[-1]
    p = p.reshape(-1, n, 3)
    batch = p.shape[0]
    pad = num_chunks * chunk - n
    if pad:
        p = torch.cat([p, p[:, -1:].expand(batch, pad, 3)], dim=1)
    p = p.reshape(batch * num_chunks * chunk, 3)
    q_flat = q_sorted.reshape(batch * m, 3)
    bases = bases.reshape(batch * num_chunks)
    # each chunk's element: its first table row and its valid count
    elem = torch.arange(batch * num_chunks, device=p.device) // num_chunks
    first = elem * m
    count = valid_count.reshape(batch)[elem]
    offs = torch.arange(band, device=p.device)
    group = max(1, PAIR_BUDGET // (chunk * band))
    for c0 in range(0, batch * num_chunks, group):
        b = bases[c0:c0 + group].to(torch.int64)
        g = b.shape[0]
        rows = b[:, None] + offs  # [G, band]
        valid = (rows < count[c0:c0 + g, None]) & (rows < m)
        tb = q_flat[torch.clamp(rows, max=m - 1)
                    + first[c0:c0 + g, None]]  # [G, band, 3]
        pc = p[c0 * chunk:(c0 + g) * chunk].view(g, chunk, 3)
        if exact:  # difference form, K3's arithmetic
            d = None
            for a in range(3):
                da = pc[:, :, None, a] - tb[:, None, :, a]
                d = da * da if d is None else d + da * da
        else:  # expansion form, as ops.matching.pairwise_sqdist
            p_sq = torch.sum(pc * pc, dim=-1, keepdim=True)
            q_sq = torch.sum(tb * tb, dim=-1)
            cross = torch.bmm(pc, tb.transpose(1, 2))
            d = torch.clamp(p_sq - 2.0 * cross + q_sq[:, None, :], min=0.0)
        d = torch.where(valid[:, None, :], d,
                        torch.full_like(d, float("inf")))
        yield c0, rows, d


def band_idx_bits(band: int) -> int:
    """K3p's index bits: ``bit_length(band - 1)``, as the JAX package sets
    them from the band height (10 at chunk 512 / window 64)."""
    return max(1, (band - 1).bit_length())


def _band_nn(p: torch.Tensor, table: MortonTable, extra, bases, chunk: int,
             band: int, exact: bool, no_valid_to_zero: bool,
             packed: bool = False):
    """Band NN over the chunks' bases: ``(matched, sqdist, idx_sorted,
    matched_extra)``, with the leading batch axis of ``p`` and the table
    when they have one. The first minimum of the band wins; ``packed``: the
    least key of :func:`~.matching.packed_keys` over the band rows wins and
    the distance is recomputed exactly from the matched row."""
    n, m = p.shape[-2], table.points_sorted.shape[-2]
    lead = p.shape[:-2]
    total = bases.numel() * chunk
    best_d = torch.empty(total, dtype=torch.float32, device=p.device)
    best_i = torch.empty(total, dtype=torch.int64, device=p.device)
    if packed:
        idx_bits = band_idx_bits(band)
        row_ids = torch.arange(band, dtype=torch.int32, device=p.device)
    for c0, rows, d in _band_blocks(p, table.points_sorted,
                                    table.valid_count, bases, chunk, band,
                                    exact):
        if packed:
            key = torch.clamp(packed_keys(d, row_ids, idx_bits).amin(dim=2),
                              max=PACKED_KEY_INIT)
            # a band with no valid row keeps PACKED_KEY_INIT, whose index
            # bits may pass the band: inf marks it, and the distance of
            # every other row is recomputed below
            dmin = torch.where(key == PACKED_KEY_INIT, float("inf"), 0.0)
            arg = torch.clamp(key & ((1 << idx_bits) - 1), max=band - 1).long()
        else:
            dmin, arg = torch.min(d, dim=2)  # first minimum
        idx = torch.gather(rows, 1, arg)
        sl = slice(c0 * chunk, c0 * chunk + dmin.numel())
        best_d[sl] = dmin.reshape(-1)
        best_i[sl] = idx.reshape(-1)
    best_d = best_d.view(lead + (-1,))[..., :n]
    best_i = best_i.view(lead + (-1,))[..., :n]
    if no_valid_to_zero:
        best_i = torch.where(torch.isinf(best_d), torch.zeros_like(best_i),
                             best_i)
    idx = torch.clamp(best_i, 0, m - 1)
    matched = gather_correspondences(table.points_sorted, idx)
    matched_extra = (None if extra is None else gather_correspondences(
        extra.to(torch.float32), idx))
    if packed:
        diff = p - matched
        best_d = torch.where(torch.isinf(best_d), best_d,
                             torch.sum(diff * diff, dim=-1))
    return matched, best_d, idx.to(torch.int32), matched_extra


def morton_nn(p: torch.Tensor, table: MortonTable,
              extra: Optional[torch.Tensor] = None, chunk: int = 256,
              window: int = 1024):
    """Band NN against the Morton table with the XLA geometry and
    expansion-form distances (``fpcr_tpu.ops.morton.morton_nn``).

    ``p`` rows must be spatially coherent (sorted with
    :func:`source_morton_order`); ``extra`` (e.g. target normals) is in table
    order. Returns ``(matched f32[N,3], sqdist f32[N], idx_sorted int32[N],
    matched_extra)``; a batch ``p`` [B, N, 3] against a stacked table and
    ``extra`` [B, M, 3] gives them with the leading B."""
    p = p.to(torch.float32)
    band = chunk + 2 * window
    m_pad = max(round_up(table.points_sorted.shape[-2], 8), band)
    bases = torch.clamp(probe_ranks(p, table, chunk) - band // 2, 0,
                        m_pad - band)
    return _band_nn(p, table, extra, bases, chunk, band, exact=False,
                    no_valid_to_zero=False)


def morton_nn_band_plain(p: torch.Tensor, table: MortonTable,
                         extra: Optional[torch.Tensor] = None,
                         chunk: int = 256, window: int = 256):
    """The plain PyTorch version of kernel K3, on any device: K3's band
    geometry (:func:`band_bases`) and its difference-form distances. A row
    whose band holds no valid target gets ``idx_sorted`` 0 and ``inf``, and
    its matched point and extra are table row 0 (the K1 convention; the TPU
    kernel returns a ~1e30 surrogate distance there). A batch as
    :func:`morton_nn` takes it, each element bit for bit its own call."""
    p = p.to(torch.float32)
    band, bases = band_bases(p, table, chunk, window)
    return _band_nn(p, table, extra, bases, chunk, band, exact=True,
                    no_valid_to_zero=True)


def morton_nn_band_packed_plain(p: torch.Tensor, table: MortonTable,
                                extra: Optional[torch.Tensor] = None,
                                chunk: int = 256, window: int = 256):
    """The plain PyTorch version of kernel K3p, on any device: K3's band
    geometry and difference-form distances, the per-row (min, argmin)
    replaced by the least key ``(bits(d) & ~(2^b - 1)) | band_row`` with
    ``b`` = :func:`band_idx_bits`, so ties within a bucket go to the first
    band row. The index is clipped to [0, m-1], matched point and extra are
    the table rows at it, and the distance is recomputed exactly from the
    matched point. A row whose band holds no valid target gets
    ``idx_sorted`` 0, ``inf`` and table row 0, K3's convention (the TPU
    kernel keeps its ~1e30 surrogate distance there). A batch as
    :func:`morton_nn` takes it, each element bit for bit its own call."""
    p = p.to(torch.float32)
    band, bases = band_bases(p, table, chunk, window)
    return _band_nn(p, table, extra, bases, chunk, band, exact=True,
                    no_valid_to_zero=True, packed=True)


def morton_nn_band(p: torch.Tensor, table: MortonTable,
                   extra: Optional[torch.Tensor] = None, chunk: int = 256,
                   window: int = 256, mode: str = "packed6"):
    """Band NN with K3's geometry: kernel K3 (K3p for ``mode=
    'packed6_idx'``) on a CUDA tensor, its plain version on a CPU tensor,
    with no fallback between the two. ``mode`` takes the JAX package's
    band kernel modes (:data:`BAND_MODES`). A batch ``p`` [B, N, 3] against
    a stacked table is one launch on the card."""
    if mode not in BAND_MODES:
        raise ValueError(f"unknown mode {mode!r}")
    packed = mode == "packed6_idx"
    if p.device.type == "cuda":
        from .morton_cuda import morton_nn_cuda, morton_nn_packed_cuda

        kernel = morton_nn_packed_cuda if packed else morton_nn_cuda
        return kernel(p, table, extra, chunk=chunk, window=window)
    if p.device.type != "cpu":
        raise ValueError(f"morton_nn_band runs on CPU or CUDA tensors, got "
                         f"{p.device}")
    plain = morton_nn_band_packed_plain if packed else morton_nn_band_plain
    return plain(p, table, extra, chunk=chunk, window=window)


def knn_morton(q: torch.Tensor, k: int, q_mask: Optional[torch.Tensor] = None,
               chunk: int = 256, window: int = 256
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Self-kNN through Morton bands, the O(M·band) replacement for the
    streaming O(M²) ``normals.knn`` at large M: ``(idx int32[M, k], sqdist
    f32[M, k])`` ascending, indices into the original order, self in slot
    0, ties to the lower band row. Approximate near curve seams."""
    q = q.to(torch.float32)
    m = q.shape[0]
    table = build_morton_table(q, q_mask)
    band = chunk + 2 * window
    m_pad = max(round_up(m, 8), band)
    num_chunks = math.ceil(m / chunk)
    # chunk c of the sorted cloud sits at rank c*chunk by construction
    bases = torch.clamp(torch.arange(num_chunks, device=q.device) * chunk
                        - window, 0, m_pad - band)
    idx_s = torch.empty((num_chunks * chunk, k), dtype=torch.int64,
                        device=q.device)
    dist = torch.empty((num_chunks * chunk, k), dtype=torch.float32,
                       device=q.device)
    for c0, rows, d in _band_blocks(table.points_sorted, table.points_sorted,
                                    table.valid_count, bases, chunk, band,
                                    exact=False):
        vals, pos = smallest_k(d, k)  # [G, chunk, k]
        g = rows.shape[0]
        sl = slice(c0 * chunk, (c0 + g) * chunk)
        idx_s[sl] = torch.gather(
            rows[:, None, :].expand(g, chunk, band), 2, pos).reshape(-1, k)
        dist[sl] = vals.reshape(-1, k)
    idx_s = torch.clamp(idx_s[:m], 0, m - 1)
    # sorted position -> original index, then un-sort the row order
    order = table.orig_index.to(torch.int64)
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(m, device=q.device)
    return order[idx_s][inverse].to(torch.int32), dist[:m][inverse]


def miss_floors(p_np: np.ndarray) -> Tuple[float, float]:
    """``(noise, damaging)``: the scale-aware floors a banded distance must
    exceed the exact one by to count as a miss and as a damaging miss. f32
    expansion-form noise scales with the coordinates' |p|², what damages
    the solve with the geometry's extent."""
    abs2 = float(np.mean(np.sum(p_np ** 2, axis=1)))
    extent2 = float(np.mean(np.sum((p_np - p_np.mean(axis=0)) ** 2, axis=1)))
    noise = max(1e-6 * max(extent2, 1e-12), 4e-6 * abs2)
    return noise, max(1e-4 * max(extent2, 1e-12), 4.0 * noise)


def _strided_rows(n: int, sample: int, device) -> torch.Tensor:
    # ceil stride: the sample spans the whole sorted cloud, tail included
    stride = max(1, -(-n // sample))
    return torch.clamp(torch.arange(sample, device=device) * stride, 0, n - 1)


def band_quality_probe(p: torch.Tensor, table: MortonTable, chunk: int = 512,
                       window: int = 64, sample: int = 2048) -> dict:
    """Banded match quality at a (chunk, window) candidate: ``miss_rate``,
    ``damaging_rate`` and ``mean_excess_rel`` of a strided sample against
    the exact NN, with the scale-aware floors of ``tune_morton``. ``p`` is
    in source-coherent order."""
    p = p.to(torch.float32)
    _, d_band, _, _ = morton_nn(p, table, None, chunk=chunk, window=window)
    rows = _strided_rows(p.shape[0], sample, p.device)
    q = table.points_sorted
    valid = torch.arange(q.shape[0], device=q.device) < table.valid_count
    _, d_exact = nn_argmin(p[rows].contiguous(), q, valid, exact=True)
    d_exact = torch.clamp(d_exact, min=0.0).cpu().numpy()
    excess = d_band[rows].cpu().numpy() - d_exact
    noise, damage = miss_floors(p[rows].cpu().numpy().astype(np.float64))
    miss = excess > np.maximum(noise, 1e-4 * d_exact)
    return {
        "chunk": chunk,
        "window": window,
        "band_ratio": (chunk + 2 * window + BAND_ALIGN) / chunk,
        "miss_rate": float(miss.mean()),
        "damaging_rate": float((excess > damage).mean()),
        "mean_excess_rel": float(np.clip(excess, 0, None).mean()
                                 / max(d_exact.mean(), 1e-30)),
    }


def seam_miss_rate(p: torch.Tensor, table: MortonTable, sample: int = 1024,
                   chunk: int = 256, window: int = 256,
                   rel_tol: float = 1e-4) -> torch.Tensor:
    """Fraction of a strided sample whose banded squared distance exceeds
    the exact one (expansion form, valid rows only) by more than
    ``rel_tol`` relative: 0 means the window is lossless on this cloud."""
    p = p.to(torch.float32)
    _, d_band, _, _ = morton_nn(p, table, None, chunk=chunk, window=window)
    rows = _strided_rows(p.shape[0], sample, p.device)
    q = table.points_sorted
    valid = torch.arange(q.shape[0], device=q.device) < table.valid_count
    _, d_exact = nn_argmin_plain(p[rows], q, valid, exact=False)
    miss = d_band[rows] > d_exact * (1.0 + rel_tol) + 1e-12
    return miss.to(torch.float32).mean()
