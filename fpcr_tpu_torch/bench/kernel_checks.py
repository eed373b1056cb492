"""Kernel S, the E1 forms and the min-only sweep held against their plain
versions on the same inputs on the card, and the E1 forms and the min-only
sweep against their first design, the yardstick, bit for bit
(``chip_smoke.py`` and ``tests/test_torch_gpu.py``).

Tolerance. The kernel and its plain version sum the same products in
another order: Kernel S the exact bf16 x bf16 products in the tensor
cores' f32 accumulation, its plain version in an f32 matmul; the E1 forms
three FMAs against separate roundings. So a value differs by a few ulp of
the sum of its addends' magnitudes, which for row i is at most Σ_k |a_ik|
max_j |b_jk|. ``ORDER_ULPS`` of that bounds it. Picks must be equal on at
least ``MIN_EQUAL_SHARE`` of the rows; where they differ, the two
candidates' exact (float64) values lie within the bound (argmin) or in the
same or neighbouring buckets of the key plus the bound (packed). NaN and
``inf`` must lie in the same rows on both sides. The min-only sweep and its
plain version sum the same three squares, the kernel with FMAs: within
``MIN_RTOL`` and ``MIN_ATOL``. Each check raises ``AssertionError`` on a
breach and returns its statistics.
"""

from __future__ import annotations

import torch

from ..ops.matching import (E1_VARIANTS, e1_idx_bits, form_lanes,
                            nn_form_plain)
from ..ops.matching_cuda import (_nn_form_yardstick, _nn_min_only_yardstick,
                                 nn_form_cuda, nn_min_only_cuda)
from ..ops.split import split_nn_plain
from ..ops.split_cuda import PACKED14_BITS, split_nn_cuda

ORDER_ULPS = 8
ULP = 2.0 ** -23  # an ulp of x is at most ULP * |x|
MIN_EQUAL_SHARE = 0.999
MIN_RTOL, MIN_ATOL = 1e-6, 1e-7  # min-only: ~3 ulp of a sum of squares


def _fail(label: str, what: str) -> None:
    raise AssertionError(f"{label}: {what}")


def _pick_stats(label, ki, oi, vk, vo, kd, od, bound, within):
    """Equal picks on MIN_EQUAL_SHARE of the rows, the differing ones
    within ``within`` of each other (float64 values vk, vo of the two
    picks), and the outputs of equal picks within ``bound``."""
    for what in ("isnan", "isinf"):
        if not torch.equal(getattr(kd, what)(), getattr(od, what)()):
            _fail(label, f"the rows where {what[2:]} differ")
    same = ki == oi
    n = ki.numel()
    if bool((~same).any()) and not bool(
            ((vk - vo).abs() <= within)[~same].all()):
        _fail(label, "picks differ beyond the tolerance")
    if n and float(same.double().mean()) < MIN_EQUAL_SHARE:
        _fail(label, f"picks equal on {int(same.sum())}/{n} rows only")
    fin = same & torch.isfinite(od)  # NaN and inf rows matched above
    err = (kd.double() - od.double()).abs()[fin]
    if bool((err > bound[fin]).any()):
        _fail(label, f"values of equal picks differ by {float(err.max())}")
    return {"rows": n, "equal": int(same.sum()),
            "max_abs_err": float(err.max()) if err.numel() else 0.0}


def split_bound(p_in, q_in, n: int, m: int) -> torch.Tensor:
    """ORDER_ULPS of each row's addend magnitudes, float64 [n]."""
    mag = p_in[:n].double().abs() @ q_in[:m].double().abs().amax(0)
    return ORDER_ULPS * ULP * mag


def check_split(p_in, q_in, n: int, m: int, epilogue: str, *, keep=None,
                clamp: bool = False, label: str = "Kernel S") -> dict:
    """Kernel S against ``split_nn_plain`` on the same operands."""
    ki, kd = split_nn_cuda(p_in, q_in, n, m, epilogue, keep=keep,
                           clamp=clamp)
    torch.cuda.synchronize()
    oi, od = split_nn_plain(p_in, q_in, n, m, epilogue, keep=keep,
                            clamp=clamp)
    if ki.dtype != torch.int32 or kd.dtype != torch.float32 or (
            ki.shape != (n,) or kd.shape != (n,)):
        _fail(label, "outputs are not int32[n], float32[n]")
    bound = split_bound(p_in, q_in, n, m)
    if epilogue in ("min", "keep"):
        if bool(ki.any()):
            _fail(label, "the index is not zeros")
        return _pick_stats(label, oi, oi, None, None, kd, od, bound, None)
    if n and (int(ki.min()) < 0 or int(ki.max()) > m - 1):
        _fail(label, f"an index outside [0, {m - 1}]")
    a = p_in[:n].double()

    def exact(idx):  # the float64 split distance of each row's pick
        return (a * q_in[idx.long()].double()).sum(1)

    vk, vo = exact(ki), exact(oi)
    if epilogue == "argmin":
        if clamp and bool((kd < 0).any()):
            _fail(label, "a clamped distance is negative")
        return _pick_stats(label, ki, oi, vk, vo, kd, od, bound, bound)
    if not torch.equal(ki, kd.view(torch.int32) & ((1 << PACKED14_BITS) - 1)):
        _fail(label, "the index is not the key's low 14 bits")
    bucket = 2.0 ** -(23 - PACKED14_BITS) * vo.clamp_min(0.0)
    return _pick_stats(label, ki, oi, vk.clamp_min(0.0), vo.clamp_min(0.0),
                       kd, od, bucket + bound, 2 * bucket + bound)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def same_bits(label: str, new, old) -> None:
    """Equal outputs bit for bit (floats as int32 views, so NaN rows
    compare too)."""
    for a, b in zip(new, old):
        if a.shape != b.shape or not torch.equal(_bits(a), _bits(b)):
            _fail(label, "the new sweep and the yardstick differ")


def e1_args(p, q, variant: str, block_m: int = 8192, lanes=None):
    """``(q_w, p_sq or None, kwargs)`` of the E1 launch type ``variant``
    on its lanes (``form_lanes``, or ``lanes`` = (q_w, p_sq) given)."""
    form, reduce = E1_VARIANTS[variant]
    q_w, p_sq = form_lanes(p, q, form)[:2] if lanes is None else lanes
    bits = e1_idx_bits(q.shape[0], block_m) if reduce == "packed" else None
    return (q_w, None if form == "biased" else p_sq,
            dict(form=form, reduce=reduce, idx_bits=bits))


def check_form_yardstick(p, q, variant: str, *, block_m: int = 8192,
                         lanes=None, label: str = "E1") -> dict:
    """``nn_form_cuda`` (``csrc/nn_forms.cu``) against its yardstick
    ``_nn_form_yardstick`` (``csrc/matching.cu``) on the same lanes: picks
    and values bit for bit."""
    q_w, psq, kw = e1_args(p, q, variant, block_m, lanes)
    new = nn_form_cuda(p, q, q_w, psq, **kw)
    old = _nn_form_yardstick(p, q, q_w, psq, **kw)
    torch.cuda.synchronize()
    same_bits(label, new, old)
    return {"rows": p.shape[0], "nan_rows": int(new[1].isnan().sum()),
            "inf_rows": int(new[1].isinf().sum())}


def check_min_only(p, q, q_mask=None, *, label: str = "min-only") -> float:
    """``nn_min_only_cuda`` against ``nn_min_only_plain`` (NaN and ``inf``
    in the same rows, the rest within MIN_RTOL / MIN_ATOL) and bit for bit
    against its yardstick ``_nn_min_only_yardstick``; the largest error."""
    from .packed_reduction import nn_min_only_plain

    kd = nn_min_only_cuda(p, q, q_mask)
    yd = _nn_min_only_yardstick(p, q, q_mask)
    torch.cuda.synchronize()
    same_bits(label, (kd,), (yd,))
    od = nn_min_only_plain(p, q, q_mask)
    for what in ("isnan", "isinf"):
        if not torch.equal(getattr(kd, what)(), getattr(od, what)()):
            _fail(label, f"the rows where {what[2:]} differ")
    fin = torch.isfinite(od)
    err = (kd[fin].double() - od[fin].double()).abs()
    if bool((err > MIN_ATOL + MIN_RTOL * od[fin].double().abs()).any()):
        _fail(label, f"a distance differs by {float(err.max())}")
    return float(err.max()) if err.numel() else 0.0


def check_form(p, q, variant: str, *, block_m: int = 8192,
               label: str = "E1") -> dict:
    """The E1 form of ``variant`` (v1, v2, v4, v5, v6) by ``nn_form_cuda``
    against ``nn_form_plain`` on the same lanes: the raw form values of
    the argmin, or the packed picks and their exact distances."""
    form, reduce = E1_VARIANTS[variant]
    q_w, p_sq, _ = form_lanes(p, q, form)
    psq = None if form == "biased" else p_sq
    bits = e1_idx_bits(q.shape[0], block_m) if reduce == "packed" else None
    ki, kd = nn_form_cuda(p, q, q_w, psq, form=form, reduce=reduce,
                          idx_bits=bits)
    torch.cuda.synchronize()
    oi, od = nn_form_plain(p, q, q_w, psq, form=form, reduce=reduce,
                           idx_bits=bits)
    m = q.shape[0]
    if p.shape[0] and (int(ki.min()) < 0 or int(ki.max()) > m - 1):
        _fail(label, f"an index outside [0, {m - 1}]")
    p64, q64 = p.double(), q.double()
    sq = p_sq.double() if form != "biased" else torch.zeros_like(p64[:, 0])
    mag = (q_w.double().abs().nan_to_num(0.0).max() + sq
           + 2 * p64.abs() @ q64.abs().nan_to_num(0.0).amax(0))
    bound = ORDER_ULPS * ULP * mag

    def value(idx):  # the float64 form value of each row's pick
        j = idx.long()
        return q_w.double()[j] + sq - 2 * (p64 * q64[j]).sum(1)

    vk, vo = value(ki), value(oi)
    if reduce == "argmin":
        return _pick_stats(label, ki, oi, vk, vo, kd, od, bound, bound)
    if form != "biased":
        vk, vo = vk.clamp_min(0.0), vo.clamp_min(0.0)
    bucket = 2.0 ** -(23 - bits) * vo.abs()
    exact = ((p64 - q64[ki.long()]) ** 2).sum(1)
    off = (kd.double() - exact).abs() > 4 * ULP * exact + 1e-30
    if bool((off & ~kd.isinf()).any()):  # inf: no key below the initial
        _fail(label, "a packed pick's distance is not its exact distance")
    return _pick_stats(label, ki, oi, vk, vo, kd, od, 4 * ULP * exact,
                       2 * bucket + bound)
