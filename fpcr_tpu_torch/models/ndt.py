"""NDT registration: Gauss-Newton on the voxel Gaussian field.

Counterpart of ``fpcr_tpu/models/ndt.py``. ``run_ndt`` registers a source
cloud against the NDT grid of the target (``ops/ndt.py``): each iteration
transforms the source, finds every point's direct7 (or direct1) voxel
Gaussians, weights the residuals by the robust Magnusson mixture score, and
takes a damped Gauss-Newton step on the 6-dof pose:

    r_i = T(p_i) − μ_v(i)                    voxel residual
    w_i = d1 d2 exp(−d2/2 · r_iᵀ S_i r_i)    robust score curvature weight
    J_i = [I | −[T(p_i) − c]×]               linearized about the centroid c
    H   = Σ w_i J_iᵀ S_i J_i,  g = Σ w_i J_iᵀ S_i r_i  →  H δ = −g

Misses carry w = 0. Three lookups: ``'gather'`` (``ndt_lookup``), the XLA
per-offset band (``lookup='banded'``, ``lookup_impl='xla'``) and kernel K4's
fused band (``lookup_impl='pallas'``: K4 on a CUDA tensor, its plain version
on a CPU tensor). ``lookup_impl='auto'`` is K4 on a CUDA tensor and the XLA
band on a CPU tensor, as the JAX package takes Pallas on the TPU and XLA
elsewhere.

The JAX loop is one ``lax.while_loop`` under ``jit``. Here the state
(pose, step norm, matched fraction, iteration count) stays on the device and
every update is masked by the device condition ``step norm > tolerance``;
on the card every ``DONE_CHECK_EVERY`` iterations are one replay of a CUDA
graph, and the host reads the condition once a replay. The per-point
Gauss-Newton pieces of every iteration go through one stacked reduction.

The sharded loop (``parallel/dist_icp.py::distributed_ndt``) runs
:func:`_ndt_loop` on a rank's shard with its ``source_mask`` and ``group``,
as JAX's takes ``source_mask`` and ``axis_name``: an iteration all-reduces
the linearisation centroid's sum, then H, g, the error's two sums and the
hit count in one call, two all-reduces in all. Not ported: the traced-grid
branches, which serve ``jit``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.cloud import as_points
from ..core.metrics import _psum, _psum_all
from ..core.transforms import RigidTransform, rotation_exp
from ..ops.ndt import (DIRECT7_OFFSETS, _AXIS_BITS, _KEY_PAD, NDTGrid,
                       _cells_raw, _clipped_keys, _dot3, _sym_apply,
                       build_ndt_grid, cell_key_order, gauss_d1_d2,
                       ndt_fused_moments, ndt_lookup, ndt_lookup_banded,
                       prepare_fused_tables, sym_upper)
from ..utils import diagnostics
from ..utils.precision import pin_f32_precision
from .icp import drive_chunks


@dataclasses.dataclass(frozen=True)
class NDTConfig:
    """The same fields and validation as ``fpcr_tpu.NDTConfig``, so configs
    carry over (``interop.ndt_config_from_dict``)."""

    # grid resolution; None = suggest_cell_size × 6 of the target
    voxel_size: Optional[float] = None
    max_iterations: int = 50
    # stop when the GN step norm drops below this (|δθ| absolute; |δt|
    # relative to 1 + |source centroid|)
    tolerance: float = 1e-6
    outlier_ratio: float = 0.55  # Magnusson mixture weight (PCL default)
    min_points: int = 4  # voxel occupancy floor
    eig_ratio: float = 0.01  # covariance eigenvalue clamp
    damping: float = 1e-6  # Levenberg diagonal added to H
    step_scale: float = 1.0  # fixed step length on δ (1 = full GN)
    neighborhood: str = "direct7"  # 'direct1' | 'direct7'
    # 'gather' | 'banded' (the source sorted by voxel key, band reads) |
    # 'auto' = banded at >= lookup_threshold points
    lookup: str = "auto"
    lookup_threshold: int = 65536
    lookup_chunk: int = 512  # source rows per band
    # table rows each side of the probe rank; None = sized to the measured
    # coverage requirement for K4 (floor 256, cap _FUSED_WINDOW_CAP), 512 for
    # the XLA band
    lookup_window: Optional[int] = None
    # 'pallas' (K4's fused band) | 'xla' (per-offset bands) | 'auto'
    lookup_impl: str = "auto"
    # set by resolve_ndt_config: every auto policy is pinned, and run_ndt
    # skips the host-side coverage probe
    lookup_resolved: bool = False

    def __post_init__(self):
        if self.voxel_size is not None and self.voxel_size <= 0:
            raise ValueError("voxel_size must be positive")
        if not (0.0 < self.outlier_ratio < 1.0):
            raise ValueError("outlier_ratio must be in (0, 1)")
        if self.neighborhood not in ("direct1", "direct7"):
            raise ValueError(f"unknown neighborhood {self.neighborhood!r}")
        if self.lookup not in ("auto", "gather", "banded"):
            raise ValueError(f"unknown lookup {self.lookup!r}")
        if self.lookup_impl not in ("auto", "xla", "pallas"):
            raise ValueError(f"unknown lookup_impl {self.lookup_impl!r}")
        if self.lookup_chunk <= 0:
            raise ValueError("lookup_chunk must be positive")
        if self.lookup_chunk % 128:
            # K4 runs 128 queries a block
            raise ValueError("lookup_chunk must be a multiple of 128 "
                             f"(got {self.lookup_chunk})")
        if self.lookup_window is not None and self.lookup_window <= 0:
            raise ValueError("lookup_window must be positive (or None "
                             "for the auto-sized coverage window)")


def resolve_voxel_size(config: NDTConfig, target) -> NDTConfig:
    """Fill ``voxel_size=None`` from the target's median point spacing
    (``suggest_cell_size`` × 6)."""
    if config.voxel_size is not None:
        return config
    from ..ops.grid import suggest_cell_size

    vs = float(suggest_cell_size(as_points(target), scale=6.0))
    if not (vs > 0.0) or not np.isfinite(vs):
        raise ValueError(
            "auto voxel_size failed: the target cloud has no measurable "
            "point spacing (all-duplicate or single-point); pass an "
            "explicit NDTConfig(voxel_size=...)")
    return dataclasses.replace(config, voxel_size=vs)


def _resolve_lookup(config: NDTConfig, n: int) -> NDTConfig:
    """Pin ``lookup='auto'`` for this cloud size."""
    if config.lookup != "auto":
        return config
    mode = "banded" if n >= config.lookup_threshold else "gather"
    return dataclasses.replace(config, lookup=mode)


# The JAX package's cap, a TPU VMEM bound (band <= ~8.2k rows), kept so that
# both packages resolve the same window. K4 streams its band and takes any
# length; the cap is to be re-set by measurement on the card (ROADMAP.md).
_FUSED_WINDOW_CAP = 3968


def resolve_ndt_config(config: NDTConfig, grid: NDTGrid,
                       source) -> NDTConfig:
    """Pin every auto policy (lookup, K4's window, impl) once for a (grid,
    representative scan) pair and mark the config resolved, so streaming
    callers skip the host-side coverage probe in ``run_ndt``::

        grid = build_ndt_grid(map_cloud, 0.2)
        cfg = resolve_ndt_config(NDTConfig(voxel_size=0.2), grid, scan0)
        for scan in stream:
            run_ndt(scan, map_cloud, cfg, grid=grid)
    """
    source = as_points(source)
    config = _resolve_lookup(config, int(source.shape[0]))
    config = _resolve_fused(config, grid, source)
    return dataclasses.replace(config, lookup_resolved=True)


def _resolve_fused(config: NDTConfig, grid: NDTGrid,
                   source: Optional[torch.Tensor] = None) -> NDTConfig:
    """Pin ``lookup_impl`` and ``lookup_window`` for this grid (host-side,
    once per registration).

    K4 reads one band per chunk, centred on the chunk's probe rank, so a
    query's face neighbour must sit inside it or it reads as a miss. The
    neighbour rank distance ``D`` is computed exactly from the keys, and the
    per-chunk query rank spread ``S`` from the source's sorted keys; coverage
    needs ``window >= D + 2·S + 128 − chunk/2``. An auto window is sized to
    that (rounded to 128, floor 256); an explicit one is escalated when it
    falls short; past ``_FUSED_WINDOW_CAP`` the per-offset XLA band, which
    re-centres each band, takes over unless K4 was asked for."""
    if config.lookup_resolved:
        if (config.lookup == "banded"
                and (config.lookup_impl == "auto"
                     or config.lookup_window is None)):
            raise ValueError(
                "lookup_resolved=True needs concrete lookup_impl and "
                "lookup_window — obtain the config from resolve_ndt_config "
                "instead of setting the flag directly")
        return config
    if config.lookup != "banded" or config.lookup_impl == "xla":
        return dataclasses.replace(
            config,
            lookup_impl=("xla" if config.lookup_impl == "auto"
                         else config.lookup_impl),
            lookup_window=(512 if config.lookup_window is None
                           else config.lookup_window))
    keys = grid.keys.cpu().numpy()
    keys = keys[keys != _KEY_PAD]
    # for every query cell k with a present face neighbour v = k + o, the
    # band centred near insrank(k) must reach rank(v); enumerating k as
    # cell(v) − o over the present voxels covers every such query
    d_max = 0
    if keys.size:
        ranks = np.arange(keys.size)
        hi = (1 << _AXIS_BITS) - 1
        cxyz = np.stack([(keys >> (2 * _AXIS_BITS)) & hi,
                         (keys >> _AXIS_BITS) & hi, keys & hi], axis=1)
        for off in ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
                    (0, 0, 1), (0, 0, -1)):
            q = cxyz - np.asarray(off)
            ok = ((q >= 0) & (q <= hi)).all(axis=1)
            if not ok.any():
                continue
            qk = ((q[ok, 0] << (2 * _AXIS_BITS))
                  | (q[ok, 1] << _AXIS_BITS) | q[ok, 2])
            ins = np.searchsorted(keys, qk)
            d_max = max(d_max, int(np.abs(ins - ranks[ok]).max()))
    spread = 0
    device = grid.keys.device
    if source is not None and source.shape[0] > 0:
        device = source.device
        c = _cells_raw(source.to(torch.float32), grid.lo, grid.voxel_size)
        sk = np.sort(_clipped_keys(c).cpu().numpy())
        ranks = np.searchsorted(keys, sk)
        ch = config.lookup_chunk
        n_full = (ranks.shape[0] // ch) * ch
        if n_full:
            r2 = ranks[:n_full].reshape(-1, ch)
            spread = int((r2[:, -1] - r2[:, 0]).max())
        if ranks.shape[0] > n_full:
            spread = max(spread, int(ranks[-1] - ranks[n_full]))
    needed = max(d_max + 2 * spread + 128 - config.lookup_chunk // 2, 0)
    auto_w = config.lookup_window is None
    window = 512 if auto_w else config.lookup_window
    if auto_w and needed <= _FUSED_WINDOW_CAP:
        impl = "pallas"
        window = min(max(-(-needed // 128) * 128, 256), _FUSED_WINDOW_CAP)
    elif needed <= window:
        impl = "pallas"
    elif needed <= _FUSED_WINDOW_CAP:
        impl = "pallas"
        window = -(-needed // 128) * 128
    elif config.lookup_impl == "pallas":
        # explicit K4: best effort at the cap (the banded miss semantics
        # apply to whatever the cap cannot cover)
        impl = "pallas"
        window = _FUSED_WINDOW_CAP
    else:
        impl = "xla"
    if config.lookup_impl == "auto" and device.type != "cuda":
        impl = "xla"
    return dataclasses.replace(config, lookup_impl=impl,
                               lookup_window=window)


def _gn_map() -> np.ndarray:
    """``T`` [42, 9, 10]: per point, ``H`` (36, row-major) and ``g`` (6) of
    ``J = [I | −K]``, ``K = [y]×``, are ``T · (f ⊗ m)`` for the features
    ``f = [s (00 01 02 11 12 22), sr]`` and the monomials ``m = [1, y0, y1,
    y2, y0y0, y0y1, y0y2, y1y1, y1y2, y2y2]``: ``A = S``, ``B = −SK``,
    ``C = KᵀSK``, ``g = [Sr, y × Sr]``, with ``K = Σ_b y_b [e_b]×``."""
    eye = np.eye(3)
    skew = [np.cross(eye[b], -eye) for b in range(3)]  # [e_b]×, row-major
    sym = []
    for i, j in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)):
        a = np.zeros((3, 3))
        a[i, j] = a[j, i] = 1.0
        sym.append(a)
    pairs = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
    T = np.zeros((42, 9, 10))
    for a in range(6):
        H = np.zeros((6, 6, 10))
        H[:3, :3, 0] = sym[a]
        for b in range(3):
            B = -sym[a] @ skew[b]
            H[:3, 3:, 1 + b] = B
            H[3:, :3, 1 + b] = B.T
        for m, (b, c) in enumerate(pairs):
            C = skew[b].T @ sym[a] @ skew[c]
            H[3:, 3:, 4 + m] = C if b == c else C + C.T
        T[:36, a, :] = H.reshape(36, 10)
    for a in range(3):
        T[36 + a, 6 + a, 0] = 1.0
        for b in range(3):
            T[39:42, 6 + a, 1 + b] = np.cross(eye[b], eye[a])
    return T


def _assemble_Hg(s: torch.Tensor, sr: torch.Tensor, y: torch.Tensor,
                 extra: torch.Tensor, gn_map: torch.Tensor, group=None):
    """The Gauss-Newton system ``H = Σ JᵀSJ``, ``g = Σ JᵀSr`` for ``J =
    [I | −[y]×]`` from the weighted per-point ``s = Σ w S`` [N, 6] (00 01 02
    11 12 22) and ``sr = Σ w S r`` [N, 3]. Every per-point product of a
    feature with a monomial of ``y``, and the ``extra`` [N, E] columns, is
    summed by one ``[9 + E, N] × [N, 10]`` matmul; ``gn_map`` (``_gn_map``
    on the device) turns the moments into ``H`` and ``g``. Returns ``(H
    [6,6], g [6], sums of extra [E])``, all-reduced over ``group`` in one
    call."""
    y0, y1, y2 = y[:, 0], y[:, 1], y[:, 2]
    mono = torch.stack([torch.ones_like(y0), y0, y1, y2, y0 * y0, y0 * y1,
                        y0 * y2, y1 * y1, y1 * y2, y2 * y2], dim=1)
    moments = torch.matmul(torch.cat([s, sr, extra], dim=1).T, mono)
    hg = torch.matmul(gn_map, moments[:9].reshape(90))
    hg, sums = _psum_all((hg, moments[9:, 0]), group)
    return hg[:36].reshape(6, 6), hg[36:], sums


class NDTResult(NamedTuple):
    transform: RigidTransform
    errors: torch.Tensor  # [max_iterations] mean Mahalanobis², NaN after stop
    num_iterations: torch.Tensor  # int32
    converged: torch.Tensor  # bool
    points: torch.Tensor  # final transformed source, input row order
    matched_fraction: torch.Tensor  # source points with a neighbour voxel


def _moments_impl(config: NDTConfig, source: torch.Tensor) -> str:
    """The band's implementation: ``'pallas'`` (K4) or ``'xla'``."""
    impl = config.lookup_impl
    if impl == "auto":
        impl = "pallas" if source.device.type == "cuda" else "xla"
    return impl


def _moments_fn(source: torch.Tensor, grid: NDTGrid, config: NDTConfig,
                source_mask: Optional[torch.Tensor] = None, tables=None):
    """``x -> (s [N,6], sr [N,3], qsum [N], count [N])``: the per-point
    weighted neighbourhood moments of the configured lookup, summed over the
    offsets (the assembly is linear in them); rows off ``source_mask`` hit
    nothing. K4's ``tables`` are built from ``grid`` unless given."""
    d1f, d2f = gauss_d1_d2(config.outlier_ratio, config.voxel_size)
    d1f = abs(d1f)  # d1 < 0 in the score convention; the weight uses |d1|
    impl = _moments_impl(config, source)
    win = 512 if config.lookup_window is None else config.lookup_window

    if config.lookup == "banded" and impl == "pallas":
        if tables is None:
            tables = prepare_fused_tables(grid)

        def fused(x):
            rows, xp = ndt_fused_moments(
                x, grid, tables, voxel_size=float(config.voxel_size),
                d1=d1f, d2=d2f, neighborhood=config.neighborhood,
                chunk=config.lookup_chunk, window=win,
                source_mask=source_mask)
            s = rows[:, 0:6]
            # Σ w S r = WS·x′ − WSμ′ (x′ and μ′ share the chunk's anchor)
            return s, _sym_apply(s, xp) - rows[:, 6:9], rows[:, 11], \
                rows[:, 10]
        return fused

    if config.lookup == "banded":
        def lookup(x, off):
            return ndt_lookup_banded(x, grid, off, chunk=config.lookup_chunk,
                                     window=win)
    else:  # 'gather'
        def lookup(x, off):
            return ndt_lookup(x, grid, off)
    offsets = (DIRECT7_OFFSETS if config.neighborhood == "direct7"
               else (None,))
    # the weight's constants as the JAX loop has them: float32 d1·d2, −d2/2
    d1d2 = float(np.float32(d1f) * np.float32(d2f))
    nh = -0.5 * float(np.float32(d2f))

    def per_offset(x):
        n = x.shape[0]
        s_sum, sr_sum = x.new_zeros((n, 6)), x.new_zeros((n, 3))
        qsum, count = x.new_zeros(n), x.new_zeros(n)
        for off in offsets:
            mu, sinv, hit = lookup(x, off)
            if source_mask is not None:
                hit = hit & source_mask
            s = sym_upper(sinv)
            r = x - mu
            sr = _sym_apply(s, r)
            q = _dot3(r, sr)
            w = d1d2 * torch.exp(torch.clamp(nh * q, -60.0, 0.0))
            w = torch.where(hit, w, torch.zeros_like(w))
            s_sum = s_sum + w[:, None] * s
            sr_sum = sr_sum + w[:, None] * sr
            qsum = qsum + torch.where(hit, q, torch.zeros_like(q))
            count = count + hit.to(torch.float32)
        return s_sum, sr_sum, qsum, count
    return per_offset


class _NDTState(NamedTuple):
    """The loop state, every field on the device."""

    R: torch.Tensor
    t: torch.Tensor
    delta_norm: torch.Tensor  # the last step's norm; inf before the first
    frac: torch.Tensor  # matched fraction of the last iteration
    iterations: torch.Tensor


def _ndt_chunk(state: _NDTState, consts, k: int):
    """``k`` masked Gauss-Newton iterations from ``state``: ``(state,
    errors [k])``, NaN where the loop had stopped. ``consts`` is ``(source,
    grid, tables, source_mask, w_c, n_valid, gn_map, config, group)``
    (``tables`` K4's, or None). A pure function of its tensors: on the card
    one CUDA graph a ``k`` (``models/icp.py::drive_chunks``)."""
    (source, grid, tables, source_mask, w_c, n_valid, gn_map, config,
     group) = consts
    dev = source.device
    moments = _moments_fn(source, grid, config, source_mask, tables)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    nan = torch.full((), float("nan"), device=dev)
    R, t, delta_norm, frac, iterations = state
    errors = []
    for _ in range(k):
        active = delta_norm > config.tolerance  # the while loop's cond
        x = torch.matmul(source, R.T) + t
        # linearize about the centroid: the rotation block of H then scales
        # with the cloud's extent, not with |x|²
        c = _psum(x.sum(dim=0) if w_c is None else
                  torch.matmul(w_c, x), group) / n_valid
        y = x - c
        s, sr, qsum, count = moments(x)
        extra = torch.stack([qsum, count, (count > 0).to(torch.float32)], 1)
        H, g, (err_num, err_den, n_hit) = _assemble_Hg(s, sr, y, extra,
                                                       gn_map, group)

        floor = config.damping + 1e-7 * (torch.trace(H) / 6.0) + 1e-30
        L, info = torch.linalg.cholesky_ex(H + floor * eye6)
        delta = -config.step_scale * torch.cholesky_solve(g[:, None], L)[:, 0]
        # a failed or non-finite solve holds the pose and reports
        # delta_norm = inf, as the JAX loop's non-finite branch does
        finite = (info == 0) & torch.isfinite(delta).all()
        delta = torch.where(finite, delta, torch.zeros_like(delta))

        # centroid-anchored update: x_new = R_inc (x − c) + c + δt
        R_inc = rotation_exp(delta[3:6])
        R_new = torch.matmul(R_inc, R)
        t_new = torch.matmul(R_inc, t - c) + c + delta[0:3]
        err = err_num / torch.clamp(err_den, min=1.0)
        # |δt| relative to 1 + |c|: the f32 floor of the translation grows
        # with the coordinates' magnitude; the rotation step is not scaled
        dn = torch.sqrt(torch.sum(delta[0:3] ** 2)
                        / (1.0 + torch.linalg.vector_norm(c)) ** 2
                        + torch.sum(delta[3:6] ** 2))
        dn = torch.where(finite, dn, torch.full_like(dn, float("inf")))

        R = torch.where(active, R_new, R)
        t = torch.where(active, t_new, t)
        errors.append(torch.where(active, err, nan))
        frac = torch.where(active, n_hit / n_valid, frac)
        iterations = iterations + active.to(torch.int32)
        delta_norm = torch.where(active, dn, delta_norm)
    return _NDTState(R, t, delta_norm, frac, iterations), torch.stack(errors)


def _to_device(a: np.ndarray, dev) -> torch.Tensor:
    """A host array on ``dev``; to the card through pinned memory, a copy
    that does not wait for the card."""
    t = torch.from_numpy(a)
    if torch.device(dev).type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def _ndt_loop(source: torch.Tensor, grid: NDTGrid, config: NDTConfig,
              source_mask: Optional[torch.Tensor] = None, group=None):
    """The Gauss-Newton loop on ``source`` (voxel-key-sorted for the banded
    lookups): ``(R, t, iterations, errors, converged, matched_fraction)``.
    ``source`` may be one rank's shard of ``group`` and ``source_mask`` its
    valid rows: the centroid, H, g and the counts are all-reduced.

    On the card the loop runs as CUDA graphs of ``DONE_CHECK_EVERY``
    iterations (``models/icp.py::drive_chunks``), the counterpart of the
    JAX loop's one ``jit``, from the second call of its shapes and config
    on. It runs eagerly on the first such call, on the CPU, for a sharded
    loop (``group`` set) and under ``debug_nans``."""
    dev = source.device
    n = source.shape[0]
    if source_mask is None:
        w_c = None
        # equal shards: the valid rows are known on the host
        world = 1
        if group is not None:
            import torch.distributed as dist

            world = dist.get_world_size(group)
        n_valid = float(max(n * world, 1))
    else:
        w_c = source_mask.to(torch.float32)
        n_valid = torch.clamp(_psum(w_c.sum(), group), min=1.0)
    gn_map = _to_device(_gn_map().reshape(42, 90).astype(np.float32), dev)
    state = _NDTState(
        torch.eye(3, dtype=torch.float32, device=dev),
        torch.zeros(3, dtype=torch.float32, device=dev),
        torch.full((), float("inf"), device=dev),
        torch.zeros((), dtype=torch.float32, device=dev),
        torch.zeros((), dtype=torch.int32, device=dev))
    fused = (config.lookup == "banded"
             and _moments_impl(config, source) == "pallas")
    consts = (source, grid, prepare_fused_tables(grid) if fused else None,
              source_mask, w_c, n_valid, gn_map,
              dataclasses.replace(config, max_iterations=0), group)
    check = None
    if diagnostics.nans_checked():
        def check(before, rows, start):
            diagnostics.check_iteration(
                rows[0], before.delta_norm > config.tolerance, start,
                "run_ndt")
    state, errs = drive_chunks(
        _ndt_chunk, state, consts, config.max_iterations,
        lambda st: not bool(st.delta_norm > config.tolerance), (),
        sharded=group is not None, check=check)
    # zero hits also give δ = 0: a failure (disjoint clouds), not convergence
    converged = (state.delta_norm <= config.tolerance) & (state.frac > 0.0)
    return (state.R, state.t, state.iterations, errs, converged, state.frac)


def run_ndt(source, target, config: Optional[NDTConfig] = None, *,
            grid: Optional[NDTGrid] = None,
            target_mask: Optional[torch.Tensor] = None) -> NDTResult:
    """Register ``source`` onto ``target`` with NDT, on ``source``'s device.

    Pass a prebuilt ``grid`` to reuse the voxelization across scans (the
    map-tracking pattern); its voxel size is authoritative, and a differing
    explicit ``config.voxel_size`` raises."""
    config = config or NDTConfig()
    pin_f32_precision()
    src = as_points(source).contiguous()
    if grid is not None:
        gvs = float(grid.voxel_size)
        if (config.voxel_size is not None
                and abs(config.voxel_size - gvs) > 1e-6 * max(gvs, 1.0)):
            raise ValueError(
                f"config.voxel_size={config.voxel_size} disagrees with "
                f"the prebuilt grid's voxel_size={gvs}; pass "
                "voxel_size=None (it is taken from the grid) or rebuild "
                "the grid")
        config = dataclasses.replace(config, voxel_size=gvs)
    else:  # the target is read only to build the grid
        target = as_points(target, device=src.device)
        config = resolve_voxel_size(config, target)
        grid = build_ndt_grid(target, config.voxel_size, target_mask,
                              min_points=config.min_points,
                              eig_ratio=config.eig_ratio)
    config = _resolve_lookup(config, src.shape[0])
    config = _resolve_fused(config, grid, src)
    src_run = src
    if config.lookup == "banded":
        # band reads need voxel-key-coherent rows; the solve does not depend
        # on the row order and the points come back in the input order
        src_run = src[cell_key_order(src, grid).long()].contiguous()
    R, t, it, errs, converged, frac = _ndt_loop(src_run, grid, config)
    tf = RigidTransform(rotation=R, translation=t)
    return NDTResult(transform=tf, errors=errs, num_iterations=it,
                     converged=converged, points=tf.apply(src),
                     matched_fraction=frac)


def register_ndt(source, target, icp_config=None,
                 ndt_config: Optional[NDTConfig] = None, *,
                 coarse_scale: float = 3.0, ndt_points: int = 16384):
    """NDT initialization + ICP refinement (the wide-basin pipeline).

    Two NDT stages (voxels ``coarse_scale``× the fine size, then the fine
    size) pull the pose into ICP's basin, and ``run_icp`` polishes it. The
    returned ``ICPResult.transform`` is the composed source→target estimate.
    Clouds above ``ndt_points`` are strided down for the NDT stages only.
    Array-likes go to the card, the target to the source's device, as in
    :func:`run_ndt`."""
    from .icp import ICPConfig, run_icp

    source = as_points(source)
    target = as_points(target, device=source.device)
    icp_config = icp_config or ICPConfig()
    ndt_config = resolve_voxel_size(ndt_config or NDTConfig(), target)
    src_i = source
    if ndt_points and source.shape[0] > ndt_points:
        stride = -(-source.shape[0] // ndt_points)
        src_i = source[::stride]
    coarse = dataclasses.replace(
        ndt_config, voxel_size=coarse_scale * ndt_config.voxel_size)
    res_c = run_ndt(src_i, target, coarse)
    res_f = run_ndt(res_c.points, target, ndt_config)
    init = res_f.transform.compose(res_c.transform)
    res = run_icp(init.apply(source), target, icp_config)
    return res._replace(transform=res.transform.compose(init))
