"""Pose-graph optimization: SE(3) Gauss-Newton over a trajectory.

Counterpart of ``fpcr_tpu/models/pose_graph.py``. Poses ``X_t`` ∈ SE(3)
(frame t → frame 0), edges ``(i, j, Z_ij)`` with ``Z_ij`` the measured
j → i relative transform (what pairwise ICP returns). Gauss-Newton
minimises ``Σ_e ‖L_eᵀ log(Z_e⁻¹ · X_i⁻¹ · X_j)‖²`` with right-multiplicative
updates ``X ← X·exp(δ)``: with ``A = X_i⁻¹X_j`` and ``r = log(Z⁻¹A)``, to
first order ``J_j = I + ½·ad(r)`` and ``J_i = −J_j·Ad(A⁻¹)``. The tangent
ordering is ``[ρ, w]``, translation first.

The SE(3) maps take leading batch axes, so all E edges' residuals and
Jacobians are built at once. The dense 6T × 6T normal matrix is assembled
deterministically: every edge contributes four 6x6 blocks, keyed by their
cell ``a·T + b`` of the ``[T·T, 6, 6]`` block grid; the contributions are
stably sorted by key once (the keys do not change between iterations) and
summed per cell by ``torch.segment_reduce``, in the order the JAX package's
four scatter-adds apply them, where an ``index_add_`` would add with atomics
in a varying order on the card. The gauge is fixed by a prior of
``anchor_weight`` on pose 0 with a Levenberg floor ``damping`` elsewhere; at
f32 that puts the matrix at a condition number of 1e12 or more, so a failed
or non-finite ``cholesky_ex`` solve holds the trajectory (δ = 0), JAX's
never-NaN guard. cuSOLVER and LAPACK do not agree digit for digit at that
condition; the tests bound the port's gap to JAX by JAX's own f32-vs-f64
gap on the same graph.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.transforms import rotation_exp, skew
from ..utils.device import resolve_device
from ..utils.precision import pin_f32_precision
from .icp import drive_chunks


# --------------------------------------------------------------- SE(3) core
def _homogeneous(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``[..., 4, 4]`` from rotations ``[..., 3, 3]`` and translations
    ``[..., 3]``."""
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=top.dtype,
                         device=top.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def _so3_exp_V(w: torch.Tensor):
    """``(exp([w]×), V(w))`` for rotation vectors ``[..., 3]``: the rotation
    and the SE(3) translation mixer ``V = I + b·K + c·K²`` with Taylor-safe
    b, c."""
    th2 = torch.sum(w * w, dim=-1)[..., None, None]
    th = torch.sqrt(th2)
    one = torch.ones_like(th)
    small = th < 1e-6
    a = torch.where(small, 1.0 - th2 / 6.0,
                    torch.sin(th) / torch.where(th > 0, th, one))
    b = torch.where(small, 0.5 - th2 / 24.0,
                    (1.0 - torch.cos(th)) / torch.where(th2 > 0, th2, one))
    c = torch.where(small, 1.0 / 6.0 - th2 / 120.0,
                    (1.0 - a) / torch.where(th2 > 0, th2, one))
    K = skew(w)
    V = (torch.eye(3, dtype=w.dtype, device=w.device) + b * K
         + c * torch.matmul(K, K))
    return rotation_exp(w), V


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """``xi = [ρ, w]`` ``[..., 6]`` → homogeneous ``[..., 4, 4]``."""
    R, V = _so3_exp_V(xi[..., 3:6])
    t = torch.matmul(V, xi[..., 0:3, None])[..., 0]
    return _homogeneous(R, t)


def _so3_log(R: torch.Tensor) -> torch.Tensor:
    """SO(3) log over the whole group, θ → π included: near π (θ > 2.9)
    the axis comes from the symmetric part ``aaᵀ = (S − cosθ·I)/(1−cosθ)``,
    ``S = (R+Rᵀ)/2``, read off its strongest row, with the sign of the skew
    part; below, ``v·θ/sin θ`` of the skew part ``v``."""
    trace = R.diagonal(dim1=-2, dim2=-1).sum(dim=-1)
    cos_t = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    th = torch.arccos(cos_t)
    v = 0.5 * torch.stack([R[..., 2, 1] - R[..., 1, 2],
                           R[..., 0, 2] - R[..., 2, 0],
                           R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    sin = torch.sin(th)
    s = torch.where(th < 1e-6, 1.0 + th * th / 6.0,
                    th / torch.where(sin != 0.0, sin, torch.ones_like(sin)))
    w_skew = v * s[..., None]
    # near π: the axis from the symmetric part
    one_minus = torch.clamp(1.0 - cos_t, min=1e-12)
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    aaT = ((0.5 * (R + R.transpose(-1, -2)) - cos_t[..., None, None] * eye)
           / one_minus[..., None, None])
    diag = torch.clamp(aaT.diagonal(dim1=-2, dim2=-1), min=0.0)
    k = torch.argmax(diag, dim=-1, keepdim=True)  # the first maximum
    ak = torch.sqrt(torch.clamp(torch.gather(diag, -1, k), min=1e-12))
    a = torch.gather(aaT, -2, k[..., None].expand(k.shape[:-1] + (1, 3)))
    a = a[..., 0, :] / ak
    a = a / torch.clamp(torch.linalg.vector_norm(a, dim=-1, keepdim=True),
                        min=1e-12)
    # the sign of the skew part; at exactly π both signs are the same R
    a = torch.where(torch.sum(a * v, dim=-1, keepdim=True) < 0.0, -a, a)
    return torch.where((th > 2.9)[..., None], a * th[..., None], w_skew)


def se3_log(M: torch.Tensor) -> torch.Tensor:
    """Homogeneous ``[..., 4, 4]`` → ``xi = [ρ, w]`` ``[..., 6]`` with
    ``se3_exp(se3_log(M)) = M``."""
    w = _so3_log(M[..., :3, :3])
    _, V = _so3_exp_V(w)
    # solve_ex: the status stays on the device (``solve`` checks it on the
    # host); V is invertible for every θ the log returns
    rho = torch.linalg.solve_ex(V, M[..., :3, 3:4])[0][..., 0]
    return torch.cat([rho, w], dim=-1)


def se3_inv(M: torch.Tensor) -> torch.Tensor:
    Rt = M[..., :3, :3].transpose(-1, -2)
    return _homogeneous(Rt, -torch.matmul(Rt, M[..., :3, 3:4])[..., 0])


def se3_adjoint(M: torch.Tensor) -> torch.Tensor:
    """Ad(M) ``[..., 6, 6]`` for the [ρ, w] ordering: δ' = Ad(M) δ with
    ``M·exp(δ)·M⁻¹ = exp(δ')``."""
    R = M[..., :3, :3]
    top = torch.cat([R, torch.matmul(skew(M[..., :3, 3]), R)], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _ad_small(r: torch.Tensor) -> torch.Tensor:
    """ad(r) ``[..., 6, 6]`` (the algebra adjoint) for [ρ, w]:
    ``[[w×, ρ×], [0, w×]]``."""
    wx = skew(r[..., 3:6])
    top = torch.cat([wx, skew(r[..., 0:3])], dim=-1)
    bot = torch.cat([torch.zeros_like(wx), wx], dim=-1)
    return torch.cat([top, bot], dim=-2)


# ----------------------------------------------------- deterministic scatter
class _SegmentSum(NamedTuple):
    """A fixed sum of rows into ``size`` cells by ``keys``, as tensors: row
    ``k`` of ``gather`` holds, for each cell that any row reaches
    (``cells``), the index of its ``k``-th row in stable key order, or
    ``len(keys)``, a zero row, past its last one. Summing term by term from
    0 adds each cell's rows one after the other in row order, as
    ``torch.segment_reduce`` does on the CPU, with no host read and no
    atomics: a CUDA graph captures it (``segment_reduce`` checks its
    lengths on the host)."""

    gather: torch.Tensor  # int64 [max rows a cell, cells]
    cells: torch.Tensor  # int64 [cells]
    size: int

    @staticmethod
    def plan(keys: torch.Tensor, size: int) -> "_SegmentSum":
        """The plan of ``keys`` (read on the host once, before the loop)."""
        order = torch.argsort(keys, stable=True)
        cells, lengths = torch.unique_consecutive(keys[order],
                                                  return_counts=True)
        n = keys.shape[0]
        terms = int(lengths.max()) if n else 0
        starts = torch.cumsum(lengths, 0) - lengths
        k = torch.arange(terms, device=keys.device)[:, None]
        pos = torch.clamp(starts[None, :] + k, max=max(n - 1, 0))
        gather = torch.where(k < lengths[None, :], order[pos],
                             torch.full_like(pos, n))
        return _SegmentSum(gather, cells, size)

    def __call__(self, values: torch.Tensor) -> torch.Tensor:
        """``[size, ...]``: each cell the sum of its rows of ``values``,
        added in row order."""
        flat = values.flatten(1)
        flat = torch.cat([flat, flat.new_zeros((1, flat.shape[1]))])
        sums = torch.zeros((self.cells.shape[0], flat.shape[1]),
                           dtype=values.dtype, device=values.device)
        for row in self.gather:
            sums = sums + torch.index_select(flat, 0, row)
        out = torch.zeros((self.size, flat.shape[1]), dtype=values.dtype,
                          device=values.device)
        out = out.index_copy(0, self.cells, sums)
        return out.reshape((self.size,) + values.shape[1:])


# --------------------------------------------------------------- the solver
class _GNConsts(NamedTuple):
    """What no Gauss-Newton iteration changes."""

    ei: torch.Tensor  # int64 [E]
    ej: torch.Tensor
    meas_inv: torch.Tensor  # [E, 4, 4] Z⁻¹
    whiten: torch.Tensor  # [E] √w, or [E, 6, 6] L of Λ = L·Lᵀ
    H_sum: _SegmentSum
    g_sum: _SegmentSum
    prior: torch.Tensor  # [6T, 6T] the gauge prior and Levenberg floor


def _gn_chunk(state, c: _GNConsts, k: int):
    """``k`` Gauss-Newton iterations of :func:`optimize_pose_graph` from
    the poses ``state = (X [T, 4, 4],)``: ``((X,), rows [k, 1])``, a row an
    iteration holding the edge-residual RMS at its start. A pure function
    of its tensors: on the card one CUDA graph a ``k``
    (``models/icp.py::drive_chunks``)."""
    (X,) = state
    T = X.shape[0]
    eye6 = torch.eye(6, device=X.device)
    full_info = c.whiten.ndim == 3
    rows = []
    for _ in range(k):
        A = torch.matmul(se3_inv(X[c.ei]), X[c.ej])
        r = se3_log(torch.matmul(c.meas_inv, A))
        Jj = eye6 + 0.5 * _ad_small(r)  # Jr⁻¹(r) to first order
        Ji = -torch.matmul(Jj, se3_adjoint(se3_inv(A)))
        if full_info:  # whiten: JᵀΛJ = (LᵀJ)ᵀ(LᵀJ)
            Lt = c.whiten.transpose(-1, -2)
            Ji, Jj = torch.matmul(Lt, Ji), torch.matmul(Lt, Jj)
            rw = torch.matmul(Lt, r[..., None])[..., 0]
        else:
            Ji = Ji * c.whiten[:, None, None]
            Jj = Jj * c.whiten[:, None, None]
            rw = r * c.whiten[:, None]
        JiT = Ji.transpose(-1, -2)
        JiTJj = torch.matmul(JiT, Jj)
        H = c.H_sum(torch.cat([torch.matmul(JiT, Ji), JiTJj,
                               JiTJj.transpose(-1, -2),
                               torch.matmul(Jj.transpose(-1, -2), Jj)]))
        g = c.g_sum(torch.cat([torch.matmul(JiT, rw[..., None])[..., 0],
                               torch.matmul(Jj.transpose(-1, -2),
                                            rw[..., None])[..., 0]]))
        Hf = H.reshape(T, T, 6, 6).permute(0, 2, 1, 3).reshape(6 * T, 6 * T)
        L, info = torch.linalg.cholesky_ex(Hf + c.prior)
        delta = -torch.cholesky_solve(g.reshape(6 * T, 1), L)[:, 0]
        # never NaN: a pose no edge reaches, or a NaN measurement, can make
        # the f32 factor fail or the solve non-finite; hold the trajectory
        good = (info == 0) & torch.isfinite(delta).all()
        delta = torch.where(good, delta, torch.zeros_like(delta))
        X = torch.matmul(X, se3_exp(delta.reshape(T, 6)))
        rows.append(torch.sqrt(torch.mean(torch.sum(r * r, dim=1)))[None])
    return (X,), torch.stack(rows)


def _gn_consts(X, edges_i, edges_j, measurements, weights, damping,
               anchor_weight) -> _GNConsts:
    """The Gauss-Newton loop's constants on the poses' device: the edges,
    Z⁻¹, the whitening of the information, the segment plans (which read
    their sizes on the host, once, before the loop) and the prior."""
    device = X.device
    T = X.shape[0]
    ei = torch.as_tensor(edges_i, device=device).long()
    ej = torch.as_tensor(edges_j, device=device).long()
    E = ei.shape[0]
    meas_inv = se3_inv(torch.as_tensor(measurements, dtype=torch.float32,
                                       device=device))
    w = (torch.ones(E, device=device) if weights is None else
         torch.as_tensor(weights, dtype=torch.float32, device=device))
    full_info = w.ndim == 3
    eye6 = torch.eye(6, device=device)
    if full_info:
        # Λ = L·Lᵀ, constant across the iterations: factored once; a failed
        # factor is NaN, as JAX's
        floor = 1e-9 * (w.diagonal(dim1=-2, dim2=-1).sum(-1) / 6.0) + 1e-30
        L, info = torch.linalg.cholesky_ex(w + floor[:, None, None] * eye6)
        whiten = torch.where((info == 0)[:, None, None], L,
                             torch.full_like(L, float("nan")))
    else:
        whiten = torch.sqrt(w)

    # the four blocks of every edge in the JAX package's scatter order:
    # (i, i), (i, j), (j, i), (j, j); then g's (i) and (j)
    H_sum = _SegmentSum.plan(torch.cat([ei * T + ei, ei * T + ej,
                                        ej * T + ei, ej * T + ej]), T * T)
    g_sum = _SegmentSum.plan(torch.cat([ei, ej]), T)
    diag = torch.cat([torch.full((6,), anchor_weight, device=device),
                      torch.full((6 * (T - 1),), damping, device=device)])
    prior = torch.diag(diag) + 1e-8 * torch.eye(6 * T, device=device)
    return _GNConsts(ei, ej, meas_inv, whiten, H_sum, g_sum, prior)


class PoseGraphResult(NamedTuple):
    poses: torch.Tensor           # [T, 4, 4] optimized frame→frame-0 poses
    residual_rms: torch.Tensor    # [iters] edge-residual RMS per GN iteration
    num_iterations: torch.Tensor  # int32


def optimize_pose_graph(poses, edges_i, edges_j, measurements,
                        weights=None, *, iterations: int = 10,
                        damping: float = 1e-6,
                        anchor_weight: float = 1e6) -> PoseGraphResult:
    """Gauss-Newton pose-graph optimization on the poses' device.

    Args:
      poses: ``[T, 4, 4]`` initial poses (e.g. ``OdometryResult.poses``).
      edges_i / edges_j: ``[E]`` integer endpoint indices.
      measurements: ``[E, 4, 4]`` measured ``Z_ij`` = (frame j → frame i)
        relative transforms (``X_i · Z_ij ≈ X_j``).
      weights: per-edge information, ``[E]`` scalars (Λ = w·I, default 1)
        or full ``[E, 6, 6]`` matrices in the ``[ρ, w]`` ordering (e.g.
        ``models/uncertainty.information_from_covariance``).
      iterations: fixed GN iteration count.
      anchor_weight: prior stiffness pinning pose 0 (the gauge).
    """
    pin_f32_precision()
    X = torch.as_tensor(poses, dtype=torch.float32, device=(
        None if isinstance(poses, torch.Tensor) else resolve_device()))
    device = X.device
    consts = _gn_consts(X, edges_i, edges_j, measurements, weights, damping,
                        anchor_weight)
    X, rows = drive_chunks(_gn_chunk, (X,), consts, iterations,
                           lambda st: False, (1,))
    return PoseGraphResult(poses=X[0], residual_rms=rows[:, 0].contiguous(),
                           num_iterations=torch.full(
                               (), iterations, dtype=torch.int32,
                               device=device))


def close_loops(odometry, loop_edges_i, loop_edges_j, loop_measurements,
                loop_weights=None, *, iterations: int = 10,
                odometry_weight: float = 1.0) -> PoseGraphResult:
    """Fuse an ``OdometryResult`` with loop-closure edges: the odometry's
    own T−1 consecutive relative measurements (weight ``odometry_weight``)
    plus the closures, then :func:`optimize_pose_graph`.
    ``loop_measurements[e]`` maps frame ``j_e`` into frame ``i_e``: the
    ``ICPResult.transform`` of registering ``frames[j]`` onto
    ``frames[i]``."""
    poses = odometry.poses
    device = poses.device
    T = poses.shape[0]
    rel = odometry.relative.transform  # frame t+1 -> frame t, [T-1]
    odo_meas = _homogeneous(rel.rotation, rel.translation)
    ei = torch.cat([torch.arange(T - 1, device=device),
                    torch.as_tensor(loop_edges_i, device=device).long()])
    ej = torch.cat([torch.arange(1, T, device=device),
                    torch.as_tensor(loop_edges_j, device=device).long()])
    loop = torch.as_tensor(loop_measurements, dtype=torch.float32,
                           device=device)
    meas = torch.cat([odo_meas.to(torch.float32), loop])
    lw = (torch.ones(loop.shape[0], device=device) if loop_weights is None
          else torch.as_tensor(loop_weights, dtype=torch.float32,
                               device=device))
    if lw.ndim == 3:  # full-information closures: the odometry's as w·I
        odo_w = (odometry_weight * torch.eye(6, device=device)).expand(
            T - 1, 6, 6)
    else:
        odo_w = torch.full((T - 1,), odometry_weight, device=device)
    return optimize_pose_graph(poses, ei, ej, meas, torch.cat([odo_w, lw]),
                               iterations=iterations)


def detect_loop_closures(frames, odometry, *, radius: float = 0.5,
                         min_separation: int = 3, max_pairs: int = 16,
                         max_error: float = 1e-3, config=None):
    """Find and verify loop-closure candidates in a scan sequence.

    Candidates are frame pairs whose odometry positions lie within
    ``radius`` and at least ``min_separation`` steps apart (a host-side
    O(T²) scan), largest separation first, then closest, capped at
    ``max_pairs`` and padded to ``max_pairs`` by repetition. All of them are
    verified in one :func:`models.batch.register_batch` (one batched loop
    whatever ``config``, one matcher call an iteration for the whole
    batch), each pair pre-transformed by the
    odometry's prediction ``A = X_i⁻¹X_j`` so that ICP recovers only the
    drift. Pairs whose final RMSE exceeds ``max_error`` are rejected.

    Returns ``(edges_i [K] int32, edges_j [K] int32, measurements [K, 4,
    4], weights [K])`` on the frames' device, weights ``1/final_rmse²``
    normalized to mean 1; empty if nothing verifies.
    """
    from .batch import _as_batch, register_batch
    from .icp import ICPConfig

    frames = _as_batch(frames, "frames")
    device = frames.device

    def _empty():
        z = torch.zeros((0,), dtype=torch.int32, device=device)
        return (z, z, torch.zeros((0, 4, 4), device=device),
                torch.zeros((0,), device=device))

    config = config or ICPConfig(max_iterations=40, auto_trim=9.0)
    poses = odometry.poses.detach().cpu().numpy()
    T = poses.shape[0]
    pos = poses[:, :3, 3]
    cand = []
    for i in range(T):
        for j in range(i + min_separation, T):
            d = float(np.linalg.norm(pos[i] - pos[j]))
            if d < radius:
                cand.append((i, j, d))
    if not cand:
        return _empty()
    # loop value: the largest step separation first, then proximity
    cand.sort(key=lambda c: (-(c[1] - c[0]), c[2]))
    n_real = min(len(cand), max_pairs)
    cand = cand[:max_pairs]
    while len(cand) < max_pairs:  # one batch shape for any count
        cand.append(cand[0])
    ii = np.array([c[0] for c in cand])
    jj = np.array([c[1] for c in cand])
    # the odometry's prediction A_k = X_i^-1 X_j, in the JAX package's
    # float32 numpy arithmetic: the verification starts from it
    A = np.stack([np.linalg.inv(poses[i]) @ poses[j]
                  for i, j in zip(ii, jj)]).astype(np.float32)
    fj = frames.detach().cpu().numpy()[jj]
    fj_pred = np.einsum("kab,knb->kna", A[:, :3, :3], fj) + A[:, None, :3, 3]
    res = register_batch(torch.as_tensor(fj_pred, device=device),
                         frames[torch.as_tensor(ii, device=device)], config)
    errs = res.errors.cpu().numpy()
    ni = res.num_iterations.cpu().numpy()
    final = np.array([errs[k, max(int(ni[k]) - 1, 0)]
                      for k in range(len(cand))])
    keep = np.isfinite(final) & (final < max_error)
    keep[n_real:] = False  # padded repeats never emit edges
    if not keep.any():
        return _empty()
    # the measured closure Z = dZ · A, dZ the registered residual
    dZ = np.tile(np.eye(4, dtype=np.float32), (len(cand), 1, 1))
    dZ[:, :3, :3] = res.transform.rotation.cpu().numpy()
    dZ[:, :3, 3] = res.transform.translation.cpu().numpy()
    Z = np.einsum("kab,kbc->kac", dZ, A)[keep]
    w = 1.0 / np.maximum(final[keep], 1e-12) ** 2
    w = w / w.mean()
    return (torch.as_tensor(ii[keep], dtype=torch.int32, device=device),
            torch.as_tensor(jj[keep], dtype=torch.int32, device=device),
            torch.as_tensor(Z, device=device),
            torch.as_tensor(w, dtype=torch.float32, device=device))
