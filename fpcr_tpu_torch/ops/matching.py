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

Both brute-force matchers take a batch as well: ``p`` [B, N, 3], ``q``
[B, M, 3] and ``q_mask`` [B, M] give ``[B, N]`` outputs, each element
matched against its own targets (the JAX package's ``vmap`` over the
matcher, ``fpcr_tpu/models/batch.py``). A CUDA batch is one launch pair of
K1 or K2 for all B elements; the plain versions run element by element.

:func:`nn_argmin_features` is the feature-space search of global
registration (33-D FPFH descriptors): JAX computes it in XLA, outside any
Pallas kernel, so it is the plain streaming expansion on both devices.

:func:`nn_argmin_packed` is the packed (value|index) reduction, the JAX
package's ``nn_argmin_pallas(mode='packed6_idx')``: one int32 min over keys
``(bits(d_ij) & ~(2^b - 1)) | j``, so picks are quantized to the distance
with its low ``b`` mantissa bits dropped and ties within a bucket go to the
lowest index; the returned distance is the exact one of the pick. A CPU
tensor takes :func:`nn_argmin_packed_plain`, a CUDA tensor launches kernel
K2.

:func:`nn_e1` runs the variants of the distance-form study
``scripts/exp_match_kernels.py`` (E1), each with the script's output
formula, through :func:`nn_form`: the biased form ``|q|² + C − 2p·q``
(C = max|p|²), the expansion ``(|q|² − 2p·q) + |p|²`` and the 5-lane sum
p̂·q̂, with an argmin or a packed reduction. A CPU tensor takes
:func:`nn_form_plain`, a CUDA tensor launches ``csrc/nn_forms.cu``'s sweep,
whose reduction :func:`nn_forms_mirror` mirrors on the CPU. A NaN value is
never picked: the argmin passes over the NaN pair only, a NaN's key lies
above every finite key, and a row whose every value is NaN gets index 0 and
``inf``; the clamp of v4 and v5 keys ``-0.0`` as ``+0.0``, as the script's
``jnp.maximum`` gives it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.cloud import round_up
from ..utils.precision import pin_f32_precision
from .matching_cuda import (FORM_LAUNCHES, check_idx_bits, nn_argmin_cuda,
                            nn_argmin_packed_cuda, nn_form_cuda)

PACKED_KEY_INIT = 0x7F7FFFFF  # bits of the largest finite float: a packed
# key that stays at it found no valid target (a masked target's key, from
# +inf's bits 0x7F800000, never gets below it)
PACKED_IDX_MAX_BITS = 16  # the JAX package's gate: m_pad <= 2^16
CARD_NAN_BITS = 0x7FFFFFFF  # the NaN the card's arithmetic gives
FORMS_SUB = 32  # targets a sub-tile of csrc/nn_forms.cu's reduction


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


def _per_element(fn, p, q, q_mask, **kw):
    """A batch ``[B, N, D]`` against ``[B, M, D]`` (mask ``[B, M]``) by one
    call of ``fn`` an element, outputs stacked to ``[B, N]``."""
    outs = [fn(p[b], q[b], None if q_mask is None else q_mask[b], **kw)
            for b in range(p.shape[0])]
    return (torch.stack([o[0] for o in outs]) if outs else
            torch.empty(p.shape[:-1], dtype=torch.int32, device=p.device),
            torch.stack([o[1] for o in outs]) if outs else
            torch.empty(p.shape[:-1], dtype=torch.float32, device=p.device))


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
    ``(idx int32[N], sqdist f32[N])``, or ``[B, N]`` for a batch."""
    if p.ndim == 3:
        return _per_element(nn_argmin_plain, p, q, q_mask,
                            source_chunk=source_chunk,
                            target_tile=target_tile, exact=exact)
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
    squared distance: ``(idx int32[N], sqdist f32[N])``; a batch ``p`` [B,
    N, 3], ``q`` [B, M, 3] gives ``[B, N]``.

    On a CUDA tensor this launches kernel K1 (one launch pair for a whole
    batch), which always computes the difference form; ``source_chunk``,
    ``target_tile`` and ``exact`` shape only the plain version that a CPU
    tensor takes.
    """
    pin_f32_precision()
    if p.device.type == "cuda":
        return nn_argmin_cuda(p, q, q_mask)
    if p.device.type != "cpu":
        raise ValueError(f"nn_argmin runs on CPU or CUDA tensors, got "
                         f"{p.device}")
    return nn_argmin_plain(p, q, q_mask, source_chunk=source_chunk,
                           target_tile=target_tile, exact=exact)


def nn_argmin_features(
    p: torch.Tensor,
    q: torch.Tensor,
    q_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest neighbour of every row of ``p`` [N, D] among the rows of
    ``q`` [M, D], for any width D (FPFH's 33): ``(idx int32[N], sqdist
    f32[N])``, what the JAX package's XLA ``nn_argmin(exact=False)``
    computes. The streaming expansion ``|p|² − 2p·q + |q|²`` in tiles of
    2,048 rows and targets, float32 with TF32 off, first minimum, on the
    inputs' device: the TPU computed it outside any Pallas kernel, so it
    has no kernel here either. :func:`nn_argmin` keeps to width 3."""
    pin_f32_precision()
    if p.ndim != 2 or q.ndim != 2 or p.shape[1] != q.shape[1]:
        raise ValueError(f"nn_argmin_features takes [N, D] and [M, D], got "
                         f"{tuple(p.shape)} and {tuple(q.shape)}")
    if q.shape[0] == 0:
        raise ValueError("nn_argmin_features needs at least one target")
    return nn_argmin_plain(p, q, q_mask, exact=False)


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
    distance to the pick. ``(idx int32[N], sqdist f32[N])``, or ``[B, N]``
    for a batch."""
    if p.ndim == 3:
        return _per_element(nn_argmin_packed_plain, p, q, q_mask,
                            idx_bits=idx_bits, source_chunk=source_chunk,
                            target_tile=target_tile)
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
    ``nn_argmin_pallas(mode='packed6_idx')``; a batch as :func:`nn_argmin`
    takes it. ``idx_bits`` defaults to :func:`packed_idx_bits` of the
    target count, which raises past its 2^16 gate. On a CUDA tensor this
    launches kernel K2; a CPU tensor takes :func:`nn_argmin_packed_plain`."""
    pin_f32_precision()
    if idx_bits is None:
        idx_bits = packed_idx_bits(q.shape[-2])
    if p.device.type == "cuda":
        return nn_argmin_packed_cuda(p, q, q_mask, idx_bits=idx_bits)
    if p.device.type != "cpu":
        raise ValueError(f"nn_argmin_packed runs on CPU or CUDA tensors, got "
                         f"{p.device}")
    return nn_argmin_packed_plain(p, q, q_mask, idx_bits=idx_bits)


# The certified finish of the tensor-core K1 and K2 (csrc/nn_tc.cu). The
# sweep centres each block of TC_BLOCK_ROWS source rows on their mean c and
# keeps, per row, the least norm-form value of each tile of TC_TILE
# targets; a masked target carries CERT_SURROGATE. Its value for the pair
# (i, j) lies within CERT_GUARD (|p_i - c| + |q_j - c|)^2 of the difference
# form (the derivation is in nn_tc.cu's header).
TC_BLOCK_ROWS = 128
TC_TILE = 128
CERT_GUARD = 24.0 * 2.0 ** -23
CERT_SURROGATE = 1e30
_INT_MAX = 0x7FFFFFFF


def tc_centres(p: torch.Tensor) -> torch.Tensor:
    """Each source row's centre f32[N, 3]: the mean of its block of
    ``TC_BLOCK_ROWS`` rows, as the sweep takes it (up to the order of the
    f32 sum)."""
    p = p.to(torch.float32)
    block = torch.arange(p.shape[0], device=p.device) // TC_BLOCK_ROWS
    sums = torch.zeros((int(block.max()) + 1 if p.shape[0] else 0, 3),
                       dtype=torch.float32, device=p.device)
    sums.index_add_(0, block, p)
    counts = torch.bincount(block).to(torch.float32)
    return (sums / counts[:, None])[block]


def pair_guard(p: torch.Tensor, q: torch.Tensor,
               centres: Optional[torch.Tensor] = None) -> torch.Tensor:
    """G f64[N, M]: the bound ``CERT_GUARD (|p_i - c_i| + |q_j - c_i|)^2``
    that the sweep's value of each pair keeps to."""
    p = p.to(torch.float32)
    c = tc_centres(p) if centres is None else centres
    pn = (p - c).double().norm(dim=1)
    qn = (q.to(torch.float32)[None, :, :] - c[:, None, :]).double().norm(
        dim=2)
    return CERT_GUARD * (pn[:, None] + qn) ** 2


def nn_certified_plain(
    p: torch.Tensor,
    q: torch.Tensor,
    q_mask: Optional[torch.Tensor],
    d_approx: torch.Tensor,
    guard: float = CERT_GUARD,
    *,
    centres: Optional[torch.Tensor] = None,
    rule: str = "argmin",
    idx_bits: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain mirror of the tensor-core K1 (``rule='argmin'``) and K2
    (``'packed'``) from any approximate distance matrix ``d_approx`` [N, M]
    that keeps to :func:`pair_guard` with coefficient ``guard``.

    Per row, as the sweep: the least value (its float bits as an int) of
    each tile of ``TC_TILE`` targets, the tile t1 of the least, and b2, the
    least of every other tile. As the finish: the exact pick inside tile t1
    (K1's first minimum, or K2's least key), with exact distance d. The pick
    is certified where b2 - G > t, t = d (K1) or the upper edge of d's
    bucket (K2), G = guard (2|p - c| + sqrt(t))^2: a target outside t1 that
    reached t would lie within sqrt(t) of p, so its value would be below
    t + G. Every other row takes the exact plain version. Returns ``(idx
    int32[N], sqdist f32[N], rescued bool[N])``; the first two equal
    :func:`nn_argmin_plain` (``exact=True``) or :func:`nn_argmin_packed_plain`
    wherever the approximation keeps to its guard."""
    if rule not in ("argmin", "packed"):
        raise ValueError(f"rule must be 'argmin' or 'packed', got {rule!r}")
    p = p.to(torch.float32)
    q = q.to(torch.float32)
    n, m = p.shape[0], q.shape[0]
    if rule == "packed":
        check_idx_bits(m, idx_bits)
    valid = (torch.ones(m, dtype=torch.bool, device=p.device)
             if q_mask is None else q_mask.to(torch.bool))
    e = torch.where(valid[None, :], d_approx.to(torch.float32),
                    torch.full_like(d_approx, CERT_SURROGATE,
                                    dtype=torch.float32))
    tiles = -(-m // TC_TILE)
    value = torch.full((n, tiles * TC_TILE), _INT_MAX, dtype=torch.int32,
                       device=p.device)
    value[:, :m] = e.contiguous().view(torch.int32)
    tile_min = value.view(n, tiles, TC_TILE).amin(dim=2)
    t1 = torch.argmin(tile_min, dim=1)  # the lower tile on a tie
    b2 = tile_min.scatter(1, t1[:, None], _INT_MAX).amin(dim=1)
    # the exact pick inside tile t1
    cols = t1[:, None] * TC_TILE + torch.arange(TC_TILE, device=p.device)
    inside = cols < m
    cols = torch.clamp(cols, max=m - 1)
    diff = p[:, None, :] - q[cols]
    d = torch.sum(diff * diff, dim=-1)
    d = torch.where(inside & valid[cols], d, torch.full_like(d, float("inf")))
    if rule == "packed":
        step = 1 << idx_bits
        key = torch.clamp(packed_keys(d, cols.to(torch.int32),
                                      idx_bits).amin(dim=1),
                          max=PACKED_KEY_INIT)  # a masked key stays above
        idx = torch.clamp(key & (step - 1), max=m - 1)
        diff = p - q[idx.long()]
        dist = torch.sum(diff * diff, dim=1)
        found = key != PACKED_KEY_INIT
        t = ((dist.view(torch.int32) & -step) + step).view(torch.float32)
    else:
        arg = torch.argmin(d, dim=1)  # the first minimum in the tile
        idx = torch.gather(cols, 1, arg[:, None])[:, 0].to(torch.int32)
        dist = torch.gather(d, 1, arg[:, None])[:, 0]
        found = torch.isfinite(dist)
        t = dist
    t = t.double()
    c = tc_centres(p) if centres is None else centres
    r = 2.0 * (p - c).double().norm(dim=1) + (t * (1.0 + 2.0 ** -20)).sqrt()
    lo = torch.where(b2 == _INT_MAX, torch.full_like(t, float("inf")),
                     b2.view(torch.float32).double())
    certified = (b2 >= 0) & found & (lo - guard * r * r > t)
    idx, dist = idx.to(torch.int32).clone(), dist.clone()
    rows = torch.nonzero(~certified).flatten()
    if rows.numel():
        sub = p[rows].contiguous()
        if rule == "packed":
            ri, rd = nn_argmin_packed_plain(sub, q, q_mask, idx_bits=idx_bits)
        else:
            ri, rd = nn_argmin_plain(sub, q, q_mask, exact=True)
        idx[rows], dist[rows] = ri, rd
    return idx, dist, ~certified


def sq_norm(x: torch.Tensor) -> torch.Tensor:
    """|x|² of each row of x f32[N,3], summed left to right as XLA reduces
    the three lanes of ``jnp.sum(x * x, axis=1)``."""
    return x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1] + x[:, 2] * x[:, 2]


def form_lanes(p: torch.Tensor, q: torch.Tensor, form: str):
    """``(q_w f32[M], p_sq f32[N], C)`` of an E1 form, as
    ``scripts/exp_match_kernels.py::augment_v1`` / ``augment5`` build them,
    on the inputs' device: C = max|p|², and the staged lane ``q_w`` is
    |q|² + C (``'biased'``), (|q|² + C) − C (``'expand'``, v4's lane) or
    |q|² (``'expand5'``)."""
    p_sq = sq_norm(p)
    c_bias = p_sq.max()
    q_sq = sq_norm(q)
    if form == "biased":
        q_w = q_sq + c_bias
    elif form == "expand":
        q_w = (q_sq + c_bias) - c_bias
    elif form == "expand5":
        q_w = q_sq
    else:
        raise ValueError(f"unknown form {form!r}")
    return q_w.contiguous(), p_sq.contiguous(), c_bias


def form_values(p: torch.Tensor, q: torch.Tensor, q_w: torch.Tensor,
                p_sq: torch.Tensor, form: str) -> torch.Tensor:
    """The raw values ``[n, m]`` of an E1 form, summed in the kernel's
    order (its FMAs rounded as separate products and sums here)."""
    ax, ay, az = (-2.0 * p[:, k:k + 1] for k in range(3))
    qx, qy, qz = (q[None, :, k] for k in range(3))
    w = q_w[None, :]
    if form == "expand5":
        w = w + p_sq[:, None]
    d = ((w + ax * qx) + ay * qy) + az * qz
    return d + p_sq[:, None] if form == "expand" else d


def nn_form_plain(
    p: torch.Tensor,
    q: torch.Tensor,
    q_w: torch.Tensor,
    p_sq: Optional[torch.Tensor],
    *,
    form: str,
    reduce: str,
    idx_bits: Optional[int] = None,
    source_chunk: int = 2048,
    target_tile: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of ``nn_form_cuda``, on any device:
    ``'argmin'`` gives ``(idx, the raw value of the first minimum)``, a NaN
    value passed over (``(0, inf)`` where every value is NaN); ``'packed'``
    the keys of the raw value (``'biased'``) or of the value clamped at
    +0.0 (:func:`form_key_bits`), their ``amin``, and ``(idx, the exact
    distance to the pick)``, ``(0, inf)`` where no key lies below
    ``PACKED_KEY_INIT``."""
    if (form, reduce) not in FORM_LAUNCHES:
        raise ValueError(f"(form, reduce) must be one of "
                         f"{sorted(FORM_LAUNCHES)}, got {(form, reduce)}")
    p = p.to(torch.float32)
    q = q.to(torch.float32)
    n, m = p.shape[0], q.shape[0]
    if reduce == "packed":
        check_idx_bits(m, idx_bits)
    if p_sq is None:
        p_sq = torch.zeros(n, dtype=torch.float32, device=p.device)
    best_d = torch.full((n,), float("inf"), dtype=torch.float32,
                        device=p.device)
    best_i = torch.zeros((n,), dtype=torch.int32, device=p.device)
    key = torch.full((n,), PACKED_KEY_INIT, dtype=torch.int32,
                     device=p.device)
    cols = torch.arange(m, dtype=torch.int32, device=p.device)
    for s0 in range(0, n, source_chunk):
        sl = slice(s0, s0 + source_chunk)
        for t0 in range(0, m, target_tile):
            tl = slice(t0, t0 + target_tile)
            d = form_values(p[sl], q[tl], q_w[tl], p_sq[sl], form)
            if reduce == "argmin":
                # a NaN is never the first minimum: only its pair is passed
                d = torch.where(d.isnan(), float("inf"), d)
                arg = torch.argmin(d, dim=1)  # first minimum in the tile
                dmin = torch.gather(d, 1, arg[:, None])[:, 0]
                better = dmin < best_d[sl]  # strict: the earlier tile wins
                best_d[sl] = torch.where(better, dmin, best_d[sl])
                best_i[sl] = torch.where(better, (arg + t0).to(torch.int32),
                                         best_i[sl])
            else:
                k = form_key_bits(d, form != "biased") & -(1 << idx_bits)
                k = k | cols[tl][None, :]
                key[sl] = torch.minimum(key[sl], k.amin(dim=1))
    if reduce == "argmin":
        return best_i, best_d
    return _unpack_form_keys(p, q, key, idx_bits)


def form_key_bits(d: torch.Tensor, clamp: bool) -> torch.Tensor:
    """The int32 bits by which an E1 form's packed key orders the values
    ``d``: a NaN as the card's NaN (``CARD_NAN_BITS``, above every finite
    value's bits), and with ``clamp`` (v4, v5) the bits clamped at 0, so a
    negative value and ``-0.0`` key as ``+0.0`` (the script's ``jnp.maximum(d,
    0.0)``; ``torch.clamp_min`` would keep ``-0.0``, whose key wins every
    row)."""
    bits = torch.where(d.isnan(), CARD_NAN_BITS, d.contiguous().view(
        torch.int32))
    return bits.clamp_min(0) if clamp else bits


def _unpack_form_keys(p, q, key, idx_bits):
    """K2's epilogue of the E1 keys: ``(idx, the exact distance to the
    pick)``, idx 0 and ``inf`` where the key stayed at
    ``PACKED_KEY_INIT``."""
    none = key == PACKED_KEY_INIT
    idx = torch.clamp(key & ((1 << idx_bits) - 1), max=q.shape[0] - 1)
    idx = torch.where(none, 0, idx).to(torch.int32)
    diff = p - q[idx.long()]
    d = torch.sum(diff * diff, dim=1)
    return idx, torch.where(none, float("inf"), d)


def nn_forms_mirror(values: torch.Tensor, reduce: str, *, slice_len: int,
                    idx_bits: Optional[int] = None, clamp: bool = False,
                    sub: int = FORMS_SUB) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """The reduction of ``csrc/nn_forms.cu`` in its own order, in plain
    torch, over the kernel's values f32[n, m] (the CPU tests' mirror of the
    kernel, which runs on the card only).

    The sweep, per target slice of ``slice_len`` columns padded with
    ``+inf`` to whole sub-tiles of ``sub``: ``'argmin'`` takes fminf over
    each sub-tile (a NaN is passed over; an all-NaN sub-tile gives NaN) and
    records the first sub-tile whose minimum lies strictly below the row's
    best; the slice's partial is (its least value, that sub-tile), or
    (``inf``, none). ``'packed'`` takes the int32 min of each sub-tile's
    bits (a NaN as ``CARD_NAN_BITS``), clamped at 0 with ``clamp``, and its
    bucket (``& ~(2^idx_bits - 1)``), records the first strictly lower
    bucket, and writes bucket | sub-tile. The finish takes the least
    partial (argmin: the lower value, then the lower sub-tile; packed: the
    int32 min) and rescans that sub-tile for the first column equal to the
    least value (returning ``(column, its value)``, ``(0, inf)`` where no
    sub-tile was recorded) or in the least bucket (returning ``(idx,
    key)``, key = ``min(bucket | column, PACKED_KEY_INIT)``, idx 0 where the
    key is ``PACKED_KEY_INIT``, else the key's low bits). ``'min'`` returns
    ``(zeros, the least value, NaN where a slice's values hold one)``.
    """
    if slice_len % sub:
        raise ValueError(f"a slice of {slice_len} is not whole sub-tiles of "
                         f"{sub}")
    n, m = values.shape
    dev = values.device
    inf = float("inf")
    keep = -(1 << idx_bits) if reduce == "packed" else 0
    idx = torch.zeros(n, dtype=torch.int32, device=dev)
    subs_all = -(-m // sub)
    padded = torch.cat([values, torch.full((n, subs_all * sub - m), inf,
                                           device=dev)], dim=1)
    out_d = torch.full((n,), inf, dtype=torch.float32, device=dev)
    best_sub = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_part = torch.full((n,), CARD_NAN_BITS, dtype=torch.int32,
                           device=dev)  # packed: bucket | sub-tile
    for j0 in range(0, m, slice_len):
        count = min(slice_len, m - j0)
        subs = -(-count // sub)
        v = values[:, j0:j0 + count]
        pad = torch.full((n, subs * sub - count), inf, dtype=torch.float32,
                         device=dev)
        v = torch.cat([v, pad], dim=1).reshape(n, subs, sub)
        if reduce == "min":
            out_d = torch.minimum(out_d, v.amin(dim=(1, 2)))  # keeps a NaN
            continue
        best_f = torch.full((n,), inf, dtype=torch.float32, device=dev)
        best_b = torch.full((n,), CARD_NAN_BITS, dtype=torch.int32,
                            device=dev)
        rec = torch.full((n,), -1, dtype=torch.int64, device=dev)
        for s in range(subs):
            vs = v[:, s]
            if reduce == "argmin":
                nan = vs.isnan()
                run = torch.where(nan, inf, vs).amin(dim=1)
                run = torch.where(nan.all(dim=1), float("nan"), run)
                better = run < best_f
                best_f = torch.where(better, run, best_f)
            else:
                run = form_key_bits(vs, False).amin(dim=1)
                b = (run.clamp_min(0) if clamp else run) & keep
                better = b < best_b
                best_b = torch.where(better, b, best_b)
            rec = torch.where(better, s, rec)
        got = rec >= 0
        glob = torch.where(got, j0 // sub + rec, -1)
        if reduce == "argmin":  # the lower value, then the lower sub-tile
            better = (best_f < out_d) | ((best_f == out_d) & got
                                         & ((best_sub < 0) | (glob <
                                                              best_sub)))
            out_d = torch.where(better, best_f, out_d)
            best_sub = torch.where(better, glob, best_sub)
        else:
            part = torch.where(got, best_b | glob.to(torch.int32),
                               CARD_NAN_BITS)
            best_part = torch.minimum(best_part, part)
    if reduce == "min":
        return idx, out_d
    if reduce == "packed":
        found = best_part != CARD_NAN_BITS
        best_sub = torch.where(found, (best_part & ~keep).to(torch.int64),
                               -1)
    found = best_sub >= 0
    rows = torch.arange(n, device=dev)
    sv = padded[rows[:, None], best_sub.clamp_min(0)[:, None] * sub
                + torch.arange(sub, device=dev)]  # [n, sub]
    if reduce == "argmin":
        hit = (sv == out_d[:, None]) & found[:, None]
    else:
        hit = ((form_key_bits(sv, clamp) & keep)
               == (best_part & keep)[:, None]) & found[:, None]
    t = torch.argmax(hit.to(torch.int8), dim=1)  # the first hit
    col = (best_sub.clamp_min(0) * sub + t).to(torch.int32)
    got = hit.any(dim=1)
    if reduce == "argmin":
        return (torch.where(got, col, 0),
                torch.where(got, sv[rows, t], inf))
    key = torch.where(got, torch.minimum(
        (best_part & keep) | col,
        torch.tensor(PACKED_KEY_INIT, device=dev)), PACKED_KEY_INIT)
    low = (1 << idx_bits) - 1
    idx = torch.where(key == PACKED_KEY_INIT, 0,
                      torch.clamp(key & low, max=m - 1)).to(torch.int32)
    return idx, key


def nn_form(
    p: torch.Tensor,
    q: torch.Tensor,
    q_w: torch.Tensor,
    p_sq: Optional[torch.Tensor],
    *,
    form: str,
    reduce: str,
    idx_bits: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """An E1 form's brute-force NN: ``csrc/nn_forms.cu`` on a CUDA tensor,
    :func:`nn_form_plain` on a CPU tensor, a raise otherwise."""
    pin_f32_precision()
    if p.device.type == "cuda":
        return nn_form_cuda(p, q, q_w, p_sq, form=form, reduce=reduce,
                            idx_bits=idx_bits)
    if p.device.type != "cpu":
        raise ValueError(f"nn_form runs on CPU or CUDA tensors, got "
                         f"{p.device}")
    return nn_form_plain(p, q, q_w, p_sq, form=form, reduce=reduce,
                         idx_bits=idx_bits)


# E1's variants (v3 is v1's function): their form and reduction
E1_VARIANTS = {v: pair for pair, v in FORM_LAUNCHES.items()}


def e1_idx_bits(m: int, block_m: int = 8192) -> int:
    """The index bits of E1's packed variants: ``bit_length(round_up(m,
    block_m) - 1)`` (14 at 16,384 targets with the study's 8,192)."""
    return max(1, (round_up(m, block_m) - 1).bit_length())


def nn_e1(p: torch.Tensor, q: torch.Tensor, variant: str,
          block_m: int = 8192) -> Tuple[torch.Tensor, torch.Tensor]:
    """One variant of ``scripts/exp_match_kernels.py``, with the script's
    output formula: ``(idx int32[N], d f32[N])``.

    * ``'v1'`` (and ``'v3'``, the same function): the biased argmin, ``d =
      best − C + |p|²``, unclamped;
    * ``'v2'``: the packed key of the biased, unclamped value (a negative
      rounding wins, as on the TPU; the bucket is 2^−(23−b) of the biased
      value C − |p|² + d), the exact distance to the pick;
    * ``'v4'``, ``'v5'``: the packed key of the expansion or the 5-lane sum
      clamped at 0, the exact distance to the pick;
    * ``'v6'``: the 5-lane argmin, ``d = max(best, 0)``.

    The packed variants take ``b = e1_idx_bits(m, block_m)``."""
    form, reduce = E1_VARIANTS["v1" if variant == "v3" else variant]
    q_w, p_sq, c_bias = form_lanes(p, q, form)
    bits = e1_idx_bits(q.shape[0], block_m) if reduce == "packed" else None
    idx, d = nn_form(p, q, q_w, None if form == "biased" else p_sq,
                     form=form, reduce=reduce, idx_bits=bits)
    if variant in ("v1", "v3"):
        d = d - c_bias + p_sq
    elif variant == "v6":
        d = torch.clamp_min(d, 0.0)
    return idx, d


def gather_correspondences(q: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Matched target points in source order (the reference's ``Q_index``):
    ``q`` [M, D] at ``idx`` [N], or a batch, ``q`` [B, M, D] at ``idx``
    [B, N]."""
    if idx.ndim == 2:
        return torch.gather(q, 1, idx.long()[..., None].expand(
            -1, -1, q.shape[-1]))
    return torch.index_select(q, 0, idx)
