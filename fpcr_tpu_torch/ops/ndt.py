"""NDT voxel Gaussian grid: per-voxel (mean, inverse covariance) tables.

Counterpart of ``fpcr_tpu/ops/ndt.py``. The target is voxelized once: voxel
cells pack into a 30-bit key (10 bits an axis from the cloud's min corner),
rows are sorted by key (a stable argsort, as ``jnp.argsort``), and the count,
mean and second moment of each voxel are sums over the sorted segments, with
the static bound of ``N`` segments: the grid keeps ``N`` rows and a validity
mask. The segment sums are ``torch.segment_reduce`` over the sorted rows,
deterministic on the card (``index_add_`` would add with atomics, in an order
that changes from run to run), and accumulate about the grid origin ``lo``.
Near-planar voxels are regularized by clamping the eigenvalues to
``eig_ratio · λ_max`` (closed-form ``ops/eigh3``), and the inverse covariance
is rebuilt in the eigenbasis.

Lookups:

* :func:`ndt_lookup`: one ``searchsorted`` over the ascending keys and one
  row gather of the fused ``[N, 16]`` table;
* :func:`ndt_lookup_banded`: the XLA per-offset band geometry (each chunk of
  voxel-key-sorted queries reads a band of ``chunk + 2·window`` table rows
  around its probe rank; a key outside the band is a miss);
* :func:`ndt_fused_moments`: kernel K4's band geometry, the whole direct7
  neighbourhood's Gauss-Newton moments per query in one pass. A CUDA tensor
  launches K4 (``ops/ndt_cuda.py``, ``csrc/ndt.cu``), a CPU tensor takes its
  plain version :func:`ndt_fused_moments_plain`.

Band membership is decided by a key's rank in the whole table: a query's
neighbour hits where its key is in the table and its rank lies in the
chunk's band, which is what the TPU's one-hot band extraction selects, since
real keys are unique.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..core.cloud import as_points, round_up
from .eigh3 import eigh3

_AXIS_BITS = 10  # 1024 cells an axis
_KEY_PAD = 2 ** 31 - 1  # padding key; sorts after every real key
# cells are clamped to this before the int32 conversion: every cell outside
# [0, 1024) is a miss anyway, and c ± 1 then cannot overflow
_CELL_CLAMP = float(2 ** 30)
FUSED_ALIGN = 128  # K4's band bases and band length are multiples of this
_MASKED_CELL = -(1 << 11)  # K4's query cell of a masked row: no neighbours


class NDTGrid(NamedTuple):
    """Fixed-shape voxel Gaussian table (rows ≤ N voxels, mask-padded)."""

    keys: torch.Tensor  # [N] int32 ascending unique voxel keys (pad=MAX)
    mu: torch.Tensor  # [N, 3] voxel means
    sinv: torch.Tensor  # [N, 3, 3] regularized inverse covariances
    valid: torch.Tensor  # [N] bool — voxel exists and has >= min_points
    lo: torch.Tensor  # [3] grid origin (min corner)
    voxel_size: torch.Tensor  # 0-d f32 on the grid's device
    # lanes [mu(3) | sinv upper triangle(6) | valid | key_hi | key_lo |
    # pad(4)]; the 30-bit key is split 15/15, both halves exact in f32
    table: torch.Tensor  # [N, 16] f32


def _cells_raw(points: torch.Tensor, lo: torch.Tensor, h) -> torch.Tensor:
    """Integer voxel coordinates int32[N, 3], not clipped to the grid.
    ``h`` is a tensor: on the card a division by a CPU scalar is taken as a
    multiplication by its reciprocal, which moves cell boundaries."""
    c = torch.floor((points - lo) / h)
    return torch.clamp(c, -_CELL_CLAMP, _CELL_CLAMP).to(torch.int32)


def _in_range(cells: torch.Tensor) -> torch.Tensor:
    """[N] bool — all three coordinates inside the addressable grid. Cells
    outside are misses, never clipped into boundary voxels."""
    return ((cells >= 0) & (cells < (1 << _AXIS_BITS))).all(dim=-1)


def _pack(cells: torch.Tensor) -> torch.Tensor:
    """Packed 30-bit key from ``[N, 3]`` voxel coordinates."""
    return ((cells[..., 0] << (2 * _AXIS_BITS))
            | (cells[..., 1] << _AXIS_BITS) | cells[..., 2])


def _cell_keys(points: torch.Tensor, lo: torch.Tensor, h) -> torch.Tensor:
    """Packed key per point; points outside the 10-bit grid get the pad key."""
    c = _cells_raw(points, lo, h)
    return torch.where(_in_range(c), _pack(c),
                       torch.full_like(c[:, 0], _KEY_PAD))


def _clipped_keys(cells: torch.Tensor) -> torch.Tensor:
    return _pack(torch.clamp(cells, 0, (1 << _AXIS_BITS) - 1))


def build_ndt_grid(target, voxel_size, mask: Optional[torch.Tensor] = None,
                   *, min_points: int = 4, eig_ratio: float = 0.01) -> NDTGrid:
    """Voxelize ``target`` ``[N, 3]`` into per-voxel Gaussians (one-time
    prepass) on its device. ``mask`` marks the valid rows of a padded cloud;
    voxels with fewer than ``min_points`` points are invalid."""
    pts = as_points(target)
    n, dev = pts.shape[0], pts.device
    h = torch.as_tensor(voxel_size, dtype=torch.float32,
                        device=dev).reshape(())
    w_in = (torch.ones(n, dtype=torch.float32, device=dev) if mask is None
            else mask.to(device=dev, dtype=torch.float32))
    inf = torch.full_like(pts, float("inf"))
    lo = torch.where(w_in[:, None] > 0, pts, inf).amin(dim=0)

    pad = torch.full((n,), _KEY_PAD, dtype=torch.int32, device=dev)
    keys = torch.where(w_in > 0, _cell_keys(pts, lo, h), pad)
    order = torch.argsort(keys, stable=True)
    keys_s, pts_s, w_s = keys[order], pts[order], w_in[order]

    changed = (keys_s[1:] != keys_s[:-1]).to(torch.int64)
    seg_id = torch.cumsum(torch.cat([changed.new_ones(1), changed]), 0) - 1
    lengths = torch.bincount(seg_id, minlength=n)
    # accumulate about ``lo``: E[xxᵀ] − μμᵀ on absolute coordinates cancels
    # catastrophically in f32 at |x|~500; local coordinates keep the digits
    loc_s = pts_s - lo
    xx = loc_s[:, :, None] * loc_s[:, None, :] * w_s[:, None, None]
    data = torch.cat([w_s[:, None], loc_s * w_s[:, None], xx.reshape(n, 9)],
                     dim=1)
    sums = torch.segment_reduce(data, "sum", lengths=lengths, axis=0)
    counts, moments = sums[:, 0], sums[:, 4:13].reshape(n, 3, 3)
    seg_keys = pad.clone().scatter_(0, seg_id, keys_s)  # equal per segment

    c_safe = torch.clamp(counts, min=1.0)
    mu_loc = sums[:, 1:4] / c_safe[:, None]
    cov = (moments / c_safe[:, None, None]
           - mu_loc[:, None, :] * mu_loc[:, :, None])
    mu = mu_loc + torch.where(torch.isfinite(lo), lo, torch.zeros_like(lo))
    seg_keys = torch.where((seg_keys >= 0) & (counts > 0), seg_keys, pad)
    valid = (counts >= float(min_points)) & (seg_keys != _KEY_PAD)

    # Magnusson §6.2.3 eigenvalue clamp, then invert in the eigenbasis
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    lams, vecs = eigh3(torch.where(valid[:, None, None], cov, eye))
    lam_max = torch.clamp(lams[:, 2], min=1e-12)
    lam_c = torch.maximum(lams, eig_ratio * lam_max[:, None])
    sinv = torch.matmul(vecs * (1.0 / lam_c)[:, None, :],
                        vecs.transpose(1, 2))
    sinv = torch.where(valid[:, None, None], sinv, torch.zeros_like(sinv))

    table = torch.cat([
        mu,
        sinv[:, 0, 0:3], sinv[:, 1, 1:3], sinv[:, 2, 2:3],
        valid[:, None].to(torch.float32),
        (seg_keys >> 15).to(torch.float32)[:, None],
        (seg_keys & 0x7FFF).to(torch.float32)[:, None],
        torch.zeros((n, 4), dtype=torch.float32, device=dev),
    ], dim=1)
    return NDTGrid(keys=seg_keys, mu=mu, sinv=sinv, valid=valid, lo=lo,
                   voxel_size=h, table=table)


def _query_keys(points: torch.Tensor, grid: NDTGrid, cell_offset
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(key int32[N] or -1 off the grid, in-range bool[N])`` of each
    point's voxel shifted by ``cell_offset``."""
    c = _cells_raw(points.to(torch.float32), grid.lo, grid.voxel_size)
    if cell_offset is not None:
        # a column at a time: a tensor of the offset would be a copy from
        # the host, which a captured loop cannot take
        c = torch.stack([c[:, a] + int(o) for a, o in enumerate(cell_offset)],
                        dim=1)
    inb = _in_range(c)
    k = torch.where(inb, _clipped_keys(c), torch.full_like(c[:, 0], -1))
    return k, inb


def ndt_lookup(points: torch.Tensor, grid: NDTGrid, cell_offset=None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-point voxel stats ``(mu [N,3], sinv [N,3,3], valid [N])``: one
    ``searchsorted`` over the ascending keys and one row gather.
    ``cell_offset`` ([3] ints) queries a neighbouring voxel. A point whose
    queried voxel is unoccupied or under-populated gets ``valid=False`` and
    zero ``sinv``."""
    k, inb = _query_keys(points, grid, cell_offset)
    pos = torch.clamp(torch.searchsorted(grid.keys, k),
                      max=grid.keys.shape[0] - 1)
    row = grid.table[pos]
    key_match = ((row[:, 10] == (k >> 15).to(torch.float32))
                 & (row[:, 11] == (k & 0x7FFF).to(torch.float32)))
    hit = key_match & (row[:, 9] > 0.5) & inb
    return _unpack_rows(row, hit)


def take_cols(x: torch.Tensor, cols) -> torch.Tensor:
    """``x[:, cols]`` for a static tuple of columns, as one stack of views:
    an index list would be copied to the device on every call."""
    return torch.stack([x[:, c] for c in cols], dim=1)


def sym_matrix(s: torch.Tensor) -> torch.Tensor:
    """[N, 3, 3] symmetric matrices from [N, 6] upper triangles (00, 01, 02,
    11, 12, 22)."""
    return take_cols(s, (0, 1, 2, 1, 3, 4, 2, 4, 5)).reshape(-1, 3, 3)


def sym_upper(a: torch.Tensor) -> torch.Tensor:
    """[N, 6] upper triangles (00, 01, 02, 11, 12, 22) of [N, 3, 3]."""
    return take_cols(a.reshape(-1, 9), (0, 1, 2, 4, 5, 8))


def _unpack_rows(row: torch.Tensor, hit: torch.Tensor):
    """Decode fused-table rows (lanes [mu(3)|sinv(6)|valid|key_hi|key_lo|
    pad]) to ``(mu, sinv, hit)``."""
    sinv = sym_matrix(row[:, 3:9])
    sinv = torch.where(hit[:, None, None], sinv, torch.zeros_like(sinv))
    return row[:, 0:3], sinv, hit


def _band_rows(keys: torch.Tensor, query: torch.Tensor, base: torch.Tensor,
               end: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(row int64[N], found bool[N])``: the table row holding each query
    key when that row lies in ``[base, end)``; a key of -1 is never found."""
    m = keys.shape[0]
    r = torch.searchsorted(keys, query)
    row = torch.clamp(r, max=m - 1)
    found = (r >= base) & (r < end) & (keys[row] == query)
    return row, found


def ndt_lookup_banded(points: torch.Tensor, grid: NDTGrid, cell_offset=None,
                      chunk: int = 512, window: int = 512):
    """``ndt_lookup`` with the XLA band geometry: each chunk of ``chunk``
    consecutive (voxel-key-sorted, :func:`cell_key_order`) points probes the
    table at its largest valid key and reads the ``chunk + 2·window`` rows
    around that rank; a key outside the band is a miss."""
    n, m = points.shape[0], grid.keys.shape[0]
    k, inb = _query_keys(points, grid, cell_offset)
    num_chunks = max(1, math.ceil(n / chunk))
    k_pad = torch.nn.functional.pad(k, (0, num_chunks * chunk - n), value=-1)
    probe = k_pad.reshape(num_chunks, chunk).amax(dim=1)
    band = chunk + 2 * window
    m_pad = max(round_up(m, 8), band)
    bases = torch.clamp(torch.searchsorted(grid.keys, probe) - band // 2, 0,
                        m_pad - band)
    base = bases.repeat_interleave(chunk)[:n]
    pos, found = _band_rows(grid.keys, k, base, base + band)
    row = grid.table[pos]
    row = torch.where(found[:, None], row, torch.zeros_like(row))
    hit = found & (row[:, 9] > 0.5) & inb
    return _unpack_rows(row, hit)


def cell_key_order(points: torch.Tensor, grid: NDTGrid) -> torch.Tensor:
    """Stable sort order int32[N] of ``points`` by their clipped voxel key in
    ``grid``'s frame: the coherence prep of the banded lookups, applied once
    before the loop (the solve does not depend on the row order)."""
    c = _cells_raw(points.to(torch.float32), grid.lo, grid.voxel_size)
    return torch.argsort(_clipped_keys(c), stable=True).to(torch.int32)


def gauss_d1_d2(outlier_ratio: float,
                resolution: float) -> Tuple[float, float]:
    """Magnusson thesis eq. 6.8: the mixture constants of the robust NDT
    score ``-d1 exp(-d2/2 · rᵀSr)`` (Python floats)."""
    c1 = 10.0 * (1.0 - outlier_ratio)
    c2 = outlier_ratio / (resolution ** 3)
    d3 = -math.log(c2)
    d1 = -math.log(c1 + c2) - d3
    d2 = -2.0 * math.log((-math.log(c1 * math.exp(-0.5) + c2) - d3) / d1)
    return d1, d2


# the direct7 neighbour field: the point's own voxel + its 6 face neighbours
# (Magnusson 2009 §6.3; None = no cell offset)
DIRECT7_OFFSETS = (None, (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
                   (0, 0, 1), (0, 0, -1))
# the same field in ascending key order, which is band order: K4 and its
# plain version sum the neighbours in this order
DIRECT7_KEY_ORDER = ((-1, 0, 0), (0, -1, 0), (0, 0, -1), (0, 0, 0),
                     (0, 0, 1), (0, 1, 0), (1, 0, 0))


def _sym_apply(s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``S·v`` for ``s`` [N, 6] (00, 01, 02, 11, 12, 22) and ``v`` [N, 3]."""
    return torch.stack([
        s[:, 0] * v[:, 0] + s[:, 1] * v[:, 1] + s[:, 2] * v[:, 2],
        s[:, 1] * v[:, 0] + s[:, 3] * v[:, 1] + s[:, 4] * v[:, 2],
        s[:, 2] * v[:, 0] + s[:, 4] * v[:, 1] + s[:, 5] * v[:, 2],
    ], dim=1)


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def reference_neighborhood_moments(src, grid: NDTGrid, d1: float, d2: float,
                                   offsets=DIRECT7_OFFSETS):
    """K4's oracle on the gather path: explicit per-offset accumulation of
    ``WS = Σ w·S`` [n, 6] (00, 01, 02, 11, 12, 22), ``WSr = Σ w·S·r`` [n, 3],
    the neighbour hit ``count`` [n] and ``qsum = Σ q`` [n], float32 on the
    device of ``src``."""
    src = src.to(torch.float32)
    n = src.shape[0]
    WS = src.new_zeros((n, 6))
    WSr = src.new_zeros((n, 3))
    count = src.new_zeros(n)
    qsum = src.new_zeros(n)
    for off in offsets:
        mu, sinv, hit = ndt_lookup(src, grid, cell_offset=off)
        s = sym_upper(sinv)
        r = src - mu
        sr = _sym_apply(s, r)
        q = _dot3(r, sr)
        w = d1 * d2 * torch.exp(torch.clamp(-0.5 * d2 * q, -60.0, 0.0))
        w = torch.where(hit, w, torch.zeros_like(w))
        WS += w[:, None] * s
        WSr += w[:, None] * sr
        count += hit.to(torch.float32)
        qsum += torch.where(hit, q, torch.zeros_like(q))
    return WS, WSr, count, qsum


# ---------------------------------------------------------------------------
# kernel K4: the fused direct7 moments, its tables, geometry and plain version


class FusedNDTTables(NamedTuple):
    """K4's per-grid operands, built once per registration."""

    keys: torch.Tensor  # [N] int32, the grid's ascending keys
    # [N, 16] f32 rows: [mu − lo (3) | S (6) | valid | 0 (6)]; mu − lo is 0
    # on pad rows. Row-major: a hit reads its 64-byte row whole
    tab: torch.Tensor


def prepare_fused_tables(grid: NDTGrid) -> FusedNDTTables:
    """K4's table, laid out for the card: one row of 16 floats per voxel
    (the TPU kernel's ``[16, m_pad]`` lane-major table, transposed), the
    means re-anchored to the grid origin so that the kernel's chunk
    anchoring works in small coordinates."""
    real = (grid.keys != _KEY_PAD)[:, None]
    mu_rel = grid.table[:, 0:3] - grid.lo
    tab = torch.cat([
        torch.where(real, mu_rel, torch.zeros_like(mu_rel)),
        grid.table[:, 3:10],
        torch.zeros_like(grid.table[:, 10:16]),
    ], dim=1)
    return FusedNDTTables(keys=grid.keys.contiguous(), tab=tab.contiguous())


class FusedGeometry(NamedTuple):
    points: torch.Tensor  # [n, 3] f32 contiguous
    cells: torch.Tensor  # [n, 3] int32 query cells; masked rows at -2048
    bases: torch.Tensor  # [chunks] int32 first band row of each chunk
    anchors: torch.Tensor  # [chunks, 3] f32 probe voxel centre − lo
    band: int


def fused_geometry(points: torch.Tensor, grid: NDTGrid, voxel_size: float,
                   chunk: int, window: int,
                   source_mask: Optional[torch.Tensor] = None
                   ) -> FusedGeometry:
    """K4's band geometry, formula for formula the TPU kernel's
    (``ndt_pallas.py:571-641``): each chunk probes the table at its largest
    valid clipped key; ``bases = clip(rank − band//2, 0, m_pad − band) &
    ~127`` with ``m_pad = round_up(m, 128)``, widened to ``band`` on tiny
    grids; the anchor is the probe voxel's centre."""
    x = points.to(torch.float32).contiguous()
    n, m = x.shape[0], grid.keys.shape[0]
    h = torch.full((), float(voxel_size), dtype=torch.float32,
                   device=x.device)
    c = _cells_raw(x, grid.lo, h)
    ok = _in_range(c)
    cells = c
    if source_mask is not None:
        sm = source_mask.to(device=x.device, dtype=torch.bool)
        ok = ok & sm
        cells = torch.where(sm[:, None], c, torch.full_like(c, _MASKED_CELL))
    k = torch.where(ok, _clipped_keys(c), torch.full_like(c[:, 0], -1))
    num_chunks = max(1, math.ceil(n / chunk))
    k_pad = torch.nn.functional.pad(k, (0, num_chunks * chunk - n), value=-1)
    probe = k_pad.reshape(num_chunks, chunk).amax(dim=1)
    ranks = torch.searchsorted(grid.keys, probe)
    band = round_up(chunk + 2 * window + FUSED_ALIGN, FUSED_ALIGN)
    m_pad = max(round_up(m, FUSED_ALIGN), band)
    bases = (torch.clamp(ranks - band // 2, 0, m_pad - band)
             & ~(FUSED_ALIGN - 1)).to(torch.int32)
    pk = torch.clamp(probe, min=0)
    axis = (1 << _AXIS_BITS) - 1
    acell = torch.stack([(pk >> (2 * _AXIS_BITS)) & axis,
                         (pk >> _AXIS_BITS) & axis, pk & axis], dim=1)
    anchors = (acell.to(torch.float32) + 0.5) * h
    return FusedGeometry(x, cells.contiguous(), bases.contiguous(),
                         anchors.contiguous(), band)


def _check_neighborhood(neighborhood: str) -> None:
    if neighborhood not in ("direct1", "direct7"):
        raise ValueError(f"unknown neighborhood {neighborhood!r}")


def ndt_fused_moments_plain(points: torch.Tensor, grid: NDTGrid,
                            tables: FusedNDTTables, *, voxel_size: float,
                            d1: float, d2: float,
                            neighborhood: str = "direct7", chunk: int = 512,
                            window: int = 256,
                            source_mask: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of kernel K4, on any device.

    Returns ``(rows [n, 16], xprime [n, 3])``. ``rows`` lanes: ``WS`` (6,
    upper triangle 00 01 02 11 12 22), ``WSμ′`` (3), ``Σ w·μ′ᵀSμ′``, the
    neighbour count, ``Σ q``, zeros; summed over the query's direct7 (or
    direct1) voxels that are valid and whose table row lies in its chunk's
    band, in ascending key order. ``xprime = x − lo − anchor``, with the
    means anchored alike (``μ′ = μ − lo − anchor``), so ``Σ w S r = WS·x′ −
    WSμ′``. ``q = rᵀSr`` with ``r = x′ − μ′`` directly and ``w = d1·d2·
    exp(min(−d2/2·q, 0))``. ``points`` rows must be voxel-key-sorted
    (:func:`cell_key_order`)."""
    _check_neighborhood(neighborhood)
    geo = fused_geometry(points, grid, voxel_size, chunk, window, source_mask)
    x, n, m = geo.points, geo.points.shape[0], tables.keys.shape[0]
    chunk_of = torch.arange(n, device=x.device) // chunk
    base = geo.bases.to(torch.int64)[chunk_of]
    end = torch.clamp(base + geo.band, max=m)
    a = geo.anchors[chunk_of]
    xp = (x - grid.lo) - a
    nh = -0.5 * d2
    d1d2 = abs(d1) * d2
    offsets = (DIRECT7_KEY_ORDER if neighborhood == "direct7"
               else ((0, 0, 0),))
    out = x.new_zeros((n, 16))
    zero = x.new_zeros(())
    for off in offsets:
        nc = geo.cells + torch.as_tensor(off, dtype=torch.int32,
                                         device=x.device)
        nk = torch.where(_in_range(nc), _clipped_keys(nc),
                         torch.full_like(nc[:, 0], -1))
        row, found = _band_rows(tables.keys, nk, base, end)
        t = tables.tab[row]
        hit = found & (t[:, 9] > 0.5)
        mu = t[:, 0:3] - a
        s = t[:, 3:9]
        r = xp - mu
        q = _dot3(r, _sym_apply(s, r))
        if d1d2 > 0.0:
            w = d1d2 * torch.exp(torch.clamp(nh * q, max=0.0))
        else:  # degenerate mixture constants: every weight is zero
            w = torch.zeros_like(q)
        sm = _sym_apply(s, mu)
        contrib = torch.cat([w[:, None] * s, w[:, None] * sm,
                             (w * _dot3(mu, sm))[:, None],
                             torch.ones_like(q)[:, None], q[:, None]], dim=1)
        out[:, 0:12] += torch.where(hit[:, None], contrib, zero)
    return out, xp


def ndt_fused_moments(points: torch.Tensor, grid: NDTGrid,
                      tables: FusedNDTTables, *, voxel_size: float, d1: float,
                      d2: float, neighborhood: str = "direct7",
                      chunk: int = 512, window: int = 256,
                      source_mask: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query direct7 GN moments in one pass
    (:func:`ndt_fused_moments_plain` says what is computed): kernel K4 on a
    CUDA tensor, its plain version on a CPU tensor, with no fallback between
    the two."""
    kw = dict(voxel_size=voxel_size, d1=d1, d2=d2, neighborhood=neighborhood,
              chunk=chunk, window=window, source_mask=source_mask)
    if points.device.type == "cuda":
        from .ndt_cuda import ndt_fused_moments_cuda

        return ndt_fused_moments_cuda(points, grid, tables, **kw)
    if points.device.type != "cpu":
        raise ValueError(f"ndt_fused_moments runs on CPU or CUDA tensors, "
                         f"got {points.device}")
    return ndt_fused_moments_plain(points, grid, tables, **kw)
