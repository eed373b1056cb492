"""The plain reference of the registrations the benchmark times.

Plain PyTorch, in float64 (the precision :data:`FLOAT64`), on whatever
device its inputs are on, one registration at a time and in blocks of rows.
It imports nothing of the program: it re-derives from the request's own
source and target everything the program derives (normals, the Morton
order and tables, the band geometry, each iteration's matches and
increments). The semantics are the program's documented ones:

* one iteration: match every source point, gate the matches (the band
  matcher's auto-trim: ``d <= 9 x`` a thrice re-trimmed mean, ``+ 1e-12``),
  solve the increment (Kabsch by SVD with the det(R) = +1 fix; or the 6x6
  point-to-plane normal equations with their ``1e-7 tr(C)/6`` diagonal
  floor, and ``Rz Ry Rx`` of the solution's angles), apply it, and take the
  point RMSE between the moved source and its matches;
* stop when ``E < tol`` or ``|E - E_prev| < tol`` (``E_prev`` starts at
  infinity), or at the iteration cap;
* the exact matcher takes the nearest target, the first one on a tie; the
  band matcher is kernel K3's geometry: the target sorted along 30-bit
  Morton codes quantized in float32 (10 bits an axis, bounds of the target),
  the source sorted once along the same frame, and each chunk of ``chunk``
  consecutive source rows searched against the ``round_up(chunk + 2 window
  + 128, 128)`` table rows from its middle row's rank, less half the band,
  clipped and aligned down to 128; the quantization stays float32, as it is
  part of the geometry, while every distance is float64;
* normals: the PCA normal of each target point's ``k`` nearest other
  points (the smallest eigenvector of their centred, unnormalised
  covariance); its sign is free, and point-to-plane does not depend on it.

``Precision`` says in what the arithmetic runs: :data:`FLOAT64` is the
reference; :data:`TF32` is the control, float32 with TF32 matrix products,
the step below the float32 (TF32 off) that the configurations state.
Matrix products (distances by the norm form, the covariances, the moved
points) go through :func:`mm`, the one place where the two differ.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..roofline import band_rows

BITS = 10
ALIGN = 128


class Precision(NamedTuple):
    name: str
    dtype: torch.dtype
    tf32: bool


FLOAT64 = Precision("float64", torch.float64, False)
TF32 = Precision("tf32", torch.float32, True)


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32's 10 mantissa bits, to nearest even, as the
    tensor cores read their operands."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, prec: Precision) -> torch.Tensor:
    """``a @ b`` in ``prec``: float64, or float32 with TF32 products (the
    card's TF32 path; on the CPU its operands rounded to TF32)."""
    if not prec.tf32:
        return torch.matmul(a, b)
    if a.device.type != "cuda":
        return torch.matmul(_round_tf32(a), _round_tf32(b))
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _block_rows(m: int) -> int:
    return max(1, (1 << 25) // max(m, 1))


def sqdist(p: torch.Tensor, q: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Squared distances ``[..., n, m]`` by the norm form, clamped at 0."""
    cross = mm(p, q.transpose(-1, -2), prec)
    return torch.clamp((p * p).sum(-1)[..., :, None] - 2.0 * cross
                       + (q * q).sum(-1)[..., None, :], min=0.0)


def nearest(p: torch.Tensor, q: torch.Tensor, prec: Precision):
    """The nearest target of every source row: ``(idx, sqdist)``, the
    first minimum on a tie; the distance in difference form."""
    idx = torch.empty(p.shape[0], dtype=torch.int64, device=p.device)
    step = _block_rows(q.shape[0])
    for s in range(0, p.shape[0], step):
        idx[s:s + step] = torch.argmin(sqdist(p[s:s + step], q, prec), dim=1)
    diff = p - q[idx]
    return idx, (diff * diff).sum(-1)


def normals(q: torch.Tensor, k: int, prec: Precision) -> torch.Tensor:
    """PCA normals of ``q`` from each point's ``k`` nearest other points
    (the ``k + 1`` nearest, the first, the point itself, left out)."""
    out = torch.empty_like(q)
    step = _block_rows(q.shape[0])
    for s in range(0, q.shape[0], step):
        d = sqdist(q[s:s + step], q, prec)
        nbr = torch.topk(d, k + 1, dim=1, largest=False).indices[:, 1:]
        pts = q[nbr]  # [rows, k, 3]
        dev = pts - pts.mean(dim=1, keepdim=True)
        cov = mm(dev.transpose(1, 2), dev, prec)
        out[s:s + step] = torch.linalg.eigh(cov.double()).eigenvectors[
            ..., 0].to(q.dtype)
    return out


# ---- kernel K3's band geometry -------------------------------------------

def _spread(x: torch.Tensor) -> torch.Tensor:
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


def morton_codes(points: torch.Tensor, lo: torch.Tensor,
                 inv_extent: torch.Tensor) -> torch.Tensor:
    """30-bit codes of float32 points: ``((x - lo) * inv * 1024)``
    truncated, clamped to [0, 1023], interleaved x, y, z from the top."""
    u = torch.clamp(((points.float() - lo) * inv_extent * float(1 << BITS))
                    .to(torch.int32), 0, (1 << BITS) - 1)
    return (_spread(u[:, 0]) << 2) | (_spread(u[:, 1]) << 1) | _spread(u[:, 2])


class BandTable(NamedTuple):
    points: torch.Tensor  # the target along the curve, in ``prec``
    codes: torch.Tensor  # int32, ascending
    lo: torch.Tensor  # float32 [3]
    inv_extent: torch.Tensor  # float32 [3]


def band_table(target32: torch.Tensor, prec: Precision) -> BandTable:
    lo, hi = target32.amin(dim=0), target32.amax(dim=0)
    inv = 1.0 / torch.clamp(hi - lo, min=1e-12)
    codes = morton_codes(target32, lo, inv)
    order = torch.argsort(codes, stable=True)
    return BandTable(target32[order].to(prec.dtype), codes[order], lo, inv)


def band_nearest(p: torch.Tensor, table: BandTable, chunk: int, window: int,
                 prec: Precision):
    """Each row's nearest target among its chunk's band rows: ``(matched,
    sqdist)``, the first minimum in band order on a tie."""
    n, m = p.shape[0], table.points.shape[0]
    band = band_rows(chunk, window)
    chunks = math.ceil(n / chunk)
    probe = torch.clamp(torch.arange(chunks, device=p.device) * chunk
                        + chunk // 2, max=n - 1)
    rank = torch.searchsorted(table.codes,
                              morton_codes(p[probe], table.lo,
                                           table.inv_extent))
    m_pad = -(-m // ALIGN) * ALIGN + band
    base = torch.clamp(rank - band // 2, 0, m_pad - band) & ~(ALIGN - 1)
    pad = chunks * chunk - n
    pp = torch.cat([p, p[-1:].expand(pad, 3)]) if pad else p
    pp = pp.view(chunks, chunk, 3)
    offs = torch.arange(band, device=p.device)
    matched = torch.empty_like(pp)
    best = torch.empty(pp.shape[:2], dtype=p.dtype, device=p.device)
    step = max(1, (1 << 25) // (chunk * band))
    for c in range(0, chunks, step):
        rows = base[c:c + step, None] + offs  # [G, band]
        valid = rows < m
        tb = table.points[torch.clamp(rows, max=m - 1)]  # [G, band, 3]
        d = sqdist(pp[c:c + step], tb, prec)
        d = torch.where(valid[:, None, :], d, torch.full_like(d, math.inf))
        arg = torch.argmin(d, dim=2)  # [G, chunk]
        q = torch.gather(tb, 1, arg[..., None].expand(-1, -1, 3))
        diff = pp[c:c + step] - q
        matched[c:c + step] = q
        best[c:c + step] = (diff * diff).sum(-1)
    return matched.view(-1, 3)[:n], best.view(-1)[:n]


# ---- solves ----------------------------------------------------------------

def _trimmed_mean(d: torch.Tensor, keep: torch.Tensor, passes: int):
    t = d[keep].mean() if keep.any() else d.new_zeros(())
    for _ in range(passes):
        sel = keep & (d <= t)
        t = d[sel].mean() if sel.any() else d.new_zeros(())
    return t


def auto_trim(d: torch.Tensor, factor: float) -> torch.Tensor:
    finite = torch.isfinite(d)
    d = torch.clamp(d, min=0.0)
    return finite & (d <= factor * _trimmed_mean(d, finite, 3) + 1e-12)


def kabsch(p, q, mask, prec: Precision):
    """``(R, t)`` minimising ``sum_i w_i |R p_i + t - q_i|^2``."""
    w = (torch.ones(p.shape[0], dtype=p.dtype, device=p.device)
         if mask is None else mask.to(p.dtype))
    sw = torch.clamp(w.sum(), min=1.0)
    p_bar = (p * w[:, None]).sum(0) / sw
    q_bar = (q * w[:, None]).sum(0) / sw
    W = mm((q - q_bar).T, (p - p_bar) * w[:, None], prec)
    U, _, Vt = torch.linalg.svd(W.double())
    d = torch.sign(torch.linalg.det(U @ Vt))
    U[:, 2] *= torch.where(d == 0, torch.ones_like(d), d)
    R = (U @ Vt).to(p.dtype)
    return R, q_bar - R @ p_bar


def euler_zyx(x: torch.Tensor) -> torch.Tensor:
    cx, cy, cz = torch.cos(x)
    sx, sy, sz = torch.sin(x)
    return torch.stack([
        torch.stack([cy * cz, cz * sx * sy - cx * sz, cx * cz * sy + sx * sz]),
        torch.stack([cy * sz, cx * cz + sx * sy * sz, cx * sy * sz - cz * sx]),
        torch.stack([-sy, cy * sx, cx * cy])])


def plane(p, q, n, mask, prec: Precision):
    """One linearised point-to-plane solve: ``(R, t)``."""
    J = torch.cat([torch.linalg.cross(p, n), n], dim=1)
    r = ((p - q) * n).sum(1)
    w = (torch.ones(p.shape[0], dtype=p.dtype, device=p.device)
         if mask is None else mask.to(p.dtype))
    Jw = J * w[:, None]
    C = mm(Jw.T, J, prec)
    b = -(Jw * r[:, None]).sum(0)
    C = C + (1e-7 * torch.trace(C) / 6.0 + 1e-30) * torch.eye(
        6, dtype=C.dtype, device=C.device)
    L, info = torch.linalg.cholesky_ex(C)
    x = torch.cholesky_solve(b[:, None], L)[:, 0]
    if int(info) != 0 or not bool(torch.isfinite(x).all()):
        x = torch.zeros_like(x)
    return euler_zyx(x[:3]), x[3:]


# ---- the loop --------------------------------------------------------------

class Registration(NamedTuple):
    rotation: torch.Tensor  # [3, 3] float64
    translation: torch.Tensor  # [3] float64
    iterations: int
    errors: list  # the point RMSE of each iteration run


def register(source32: torch.Tensor, target32: torch.Tensor, icp: dict,
             metric: str, prec: Precision = FLOAT64) -> Registration:
    """Register ``source32`` onto ``target32`` (float32 ``[N, 3]``, ``[M,
    3]``, as the program got them) by the configuration's ``icp`` settings
    (``matcher`` 'xla' exact or 'morton' band; ``max_iterations``,
    ``tolerance``, ``k_neighbors``, ``morton_chunk``, ``morton_window``)
    with the ``metric`` 'point' or 'plane', in ``prec``."""
    dt = prec.dtype
    tgt = target32.to(dt)
    band = icp["matcher"] == "morton"
    nrm = normals(tgt, icp["k_neighbors"], prec) if metric == "plane" else None
    if band:
        if metric != "point":
            raise ValueError("the band reference is point-to-point only")
        table = band_table(target32, prec)
        src32 = source32[torch.argsort(
            morton_codes(source32, table.lo, table.inv_extent), stable=True)]
    else:
        src32 = source32
    pts = src32.to(dt)
    R = torch.eye(3, dtype=dt, device=pts.device)
    t = torch.zeros(3, dtype=dt, device=pts.device)
    prev, errors = math.inf, []
    tol = icp["tolerance"]
    for _ in range(icp["max_iterations"]):
        mask = None
        if band:
            q_m, d = band_nearest(pts, table, icp["morton_chunk"],
                                  icp["morton_window"], prec)
            mask = auto_trim(d, 9.0)
        else:
            idx, d = nearest(pts, tgt, prec)
            q_m = tgt[idx]
        if metric == "point":
            dR, dt_ = kabsch(pts, q_m, mask, prec)
        else:
            dR, dt_ = plane(pts, q_m, nrm[idx], mask, prec)
        pts = mm(pts, dR.T, prec) + dt_
        diff = pts - q_m
        sq = (diff * diff).sum(1)
        err = float(torch.sqrt(sq.sum() / sq.shape[0] if mask is None else
                               (sq * mask).sum()
                               / torch.clamp(mask.sum(), min=1)))
        errors.append(err)
        R, t = dR @ R, dR @ t + dt_
        if err < tol or abs(err - prev) < tol:
            break
        prev = err
    return Registration(R.double(), t.double(), len(errors), errors)
