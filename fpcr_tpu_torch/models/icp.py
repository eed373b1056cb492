"""The ICP registration loop, state kept on the device.

Counterpart of ``fpcr_tpu/models/icp.py``. One iteration is the
reference's: match → solve → apply → error, with the error measured
between the newly transformed source and the correspondences found at the
start of the iteration (the point RMSE for every metric, as in the
reference). The loop stops when ``E < tol`` or ``|E - E_prev| < tol``
(``E_prev`` starts at ``inf``), or at ``max_iterations``.

Metrics: ``point`` (Kabsch), ``plane`` (6x6 solve on PCA target normals),
``symmetric`` (the plane solve on ``n_p + sign·n_q``) and ``gicp``
(Generalized-ICP, ``ops/gicp.py``); the last two carry the source normals
and re-rotate them every iteration at full float32. Matchers: ``xla`` and
``pallas`` are the brute matcher ``nn_argmin`` (kernel K1 on a CUDA
tensor), except that ``pallas`` with ``pallas_mode='packed6_idx'`` takes
the packed (value|index) reduction ``nn_argmin_packed`` (kernel K2);
``grid`` is the voxel-hash matcher ``ops/grid.py::grid_nn`` (plain torch,
no kernel), whose unmatched rows leave the solve; ``morton`` is the band
matcher, whose ``morton_impl`` picks the geometry:
``'pallas'`` is kernel K3's (K3, or K3p for ``'packed6_idx'``, on CUDA;
their plain versions on the CPU), ``'xla'`` the XLA geometry ``morton_nn``
everywhere, and ``'auto'`` K3's on a CUDA tensor and ``morton_nn`` on a CPU
tensor, as the JAX package takes Pallas on the TPU and XLA elsewhere. The
exact rescue of the morton path always takes ``nn_argmin``. The morton path
sorts the source along the target's curve once and unsorts the result at
the end.

The JAX loop is one ``lax.while_loop`` with no host sync until the result.
Here the loop state (points, carried normals, transform, previous error,
done flag, iteration count) stays on the device and every update is masked
by the device ``done`` flag, so an iteration that runs after the stop
changes nothing; on the card, in a captured chunk, such an iteration runs
none of its kernels (``utils/graphs.py::skip_if_all``). The host reads
``done`` only every ``DONE_CHECK_EVERY`` iterations, never per iteration;
the results equal those of a per-iteration check.

Every sum over points takes ``group``, a ``torch.distributed`` process group
over which the source rows are sharded (``parallel/dist_icp.py``), as the
JAX loop takes ``axis_name``: the trimmed means, the IRLS scale, the matched
fraction, the solver's moments and the error are all-reduced, so every rank
solves the same system and the loop state stays replicated. Sums that do not
depend on each other share one all-reduce; an iteration makes three (point:
centroids, cross-covariance, error) or two (plane, symmetric, GICP: the 6x6
system, error), one more for the matched fraction where a mask enters the
solve, and one for each trimmed-mean pass (four with the morton matcher's
auto-trim, two with IRLS). ``done`` follows from the replicated error, so
reading it needs no collective. ``group=None`` is the single-process loop.
:func:`utils.diagnostics.debug_nans` makes the loop raise at the first
non-finite error.

``matcher='grid'`` degrades to ``'morton'`` (:func:`resolve_matcher`) above
``ops.grid.MAX_CANDIDATE_GATHERS`` candidate rows, as in the JAX package;
the port's limit is set by the card and admits 1M points at cap 8, where
the JAX package's degrades.

The set-up, the iteration and the chunk take a leading batch axis as well
(``models/batch.py::register_batch``, the JAX package's ``vmap`` of this
loop): clouds ``[B, N, 3]``, a stacked matcher state, transforms ``[B, 3,
3]`` and ``[B, 3]``, and ``[B]`` errors and flags, each element computed on
its own, with one matcher call an iteration for the whole batch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.cloud import as_points
from ..core.metrics import _psum_all, rmse
from ..core.transforms import RigidTransform
from ..ops import grid, matching_cuda
from ..ops.gicp import gicp_transform
from ..ops.matching import (gather_correspondences, nn_argmin,
                             nn_argmin_packed)
from ..ops.morton import (build_morton_table, miss_floors, morton_nn,
                          morton_nn_band, source_morton_order)
from ..ops.normals import estimate_normals
from ..ops.solve import kabsch_transform, point_to_plane_transform
from ..utils import diagnostics, graphs, timing
from ..utils.precision import pin_f32_precision

# The host reads the device `done` flag once per this many iterations: a
# stop is seen at most 7 iterations late, and those iterations are masked
# (skipped on the device in a captured chunk).
DONE_CHECK_EVERY = 8


@dataclasses.dataclass(frozen=True)
class ICPConfig:
    """The same fields and validation as ``fpcr_tpu.ICPConfig``, so configs
    carry over (``interop.config_from_dict``)."""

    metric: str = "point"  # 'point' | 'plane' | 'symmetric' | 'gicp'
    max_iterations: int = 40
    tolerance: float = 1e-6
    k_neighbors: int = 4
    normals_banded_threshold: int = 100_000
    solver: str = "svd"  # 'svd' | 'polar' (point metric)
    det_correction: bool = True
    strict_reference: bool = False  # exact reference math (no det fix)
    damping: float = 0.0
    max_correspondence_dist: Optional[float] = None  # trimmed ICP
    # gate matches with sqdist > factor x (iteratively re-trimmed mean
    # sqdist); None = off, or 9.0 for matcher='morton'
    auto_trim: Optional[float] = None
    robust_loss: Optional[str] = None  # None | 'huber' | 'tukey' (IRLS)
    gicp_epsilon: float = 1e-3
    # tile sizes of the plain matcher that CPU tensors take
    source_chunk: int = 2048
    target_tile: int = 2048
    # 'xla' and 'pallas' both mean the brute matcher nn_argmin (kernel K1
    # on a CUDA tensor), but 'pallas' with pallas_mode='packed6_idx' is
    # nn_argmin_packed (K2); 'grid' the voxel-hash matcher; 'morton' the
    # band matcher
    matcher: str = "xla"
    exact_distances: bool = False  # plain matcher: difference form
    grid_cell_size: Optional[float] = None  # None: suggest_cell_size
    grid_cap: int = 8
    grid_table_bits: int = 20
    morton_chunk: int = 256
    morton_window: int = 256
    # the TPU band kernel's loop unroll: accepted and ignored
    morton_unroll: int = 16
    morton_impl: str = "auto"  # 'auto' | 'pallas' (K3's geometry) | 'xla'
    # 'packed6', 'highest' and the 'packed6_pipe*'/'packed6_seq' schedule
    # pins all mean the one FP32 kernel of each matcher (K1, K3); the pins
    # are TPU knobs, accepted and ignored; 'packed6_idx' is the packed
    # (value|index) reduction of matcher 'pallas' (K2) and of the morton
    # band with K3's geometry (K3p)
    pallas_mode: str = "packed6"
    morton_shifts: int = 1
    morton_rescue: int = 0

    def __post_init__(self):
        if self.metric not in ("point", "plane", "symmetric", "gicp"):
            raise ValueError(f"unknown metric {self.metric!r}")
        if self.solver not in ("svd", "polar"):
            raise ValueError(f"unknown solver {self.solver!r}")
        if self.matcher not in ("xla", "pallas", "grid", "morton"):
            raise ValueError(f"unknown matcher {self.matcher!r}")
        if self.robust_loss not in (None, "huber", "tukey"):
            raise ValueError(f"unknown robust_loss {self.robust_loss!r}")
        if self.pallas_mode not in ("packed6", "highest", "packed6_idx",
                                    "packed6_pipe", "packed6_seq",
                                    "packed6_pipe2", "packed6_pipe3"):
            raise ValueError(f"unknown pallas_mode {self.pallas_mode!r}")
        if self.morton_rescue < 0:
            raise ValueError("morton_rescue must be >= 0")
        if not (0.0 < self.gicp_epsilon <= 1.0):
            raise ValueError("gicp_epsilon must be in (0, 1]")


class ICPResult(NamedTuple):
    transform: RigidTransform  # accumulated source→target estimate
    errors: torch.Tensor  # [max_iterations] RMSE per iteration, NaN after stop
    num_iterations: torch.Tensor  # int32 — iterations executed
    converged: torch.Tensor  # bool
    points: torch.Tensor  # final transformed source cloud, input row order
    matched_fraction: torch.Tensor  # [max_iterations], NaN after stop
    delta_t: torch.Tensor  # [max_iterations] ‖Δt‖ of the increment
    delta_rot: torch.Tensor  # [max_iterations] ∠ΔR (radians) of it


class IterationAux(NamedTuple):
    """Per-iteration diagnostics emitted by ``icp_iteration``."""

    matched_fraction: torch.Tensor  # scalar — inliers entering the solve / N


def rotation_angle(rotation: torch.Tensor) -> torch.Tensor:
    """Rotation angle (radians) of a 3×3 rotation, or of each of a batch:
    θ = arccos((tr R − 1)/2)."""
    trace = rotation.diagonal(dim1=-2, dim2=-1).sum(dim=-1)
    return torch.arccos(torch.clamp(0.5 * (trace - 1.0), -1.0, 1.0))


def resolve_matcher(config: ICPConfig, n_source: int) -> ICPConfig:
    """``matcher='grid'`` above ``ops.grid.MAX_CANDIDATE_GATHERS`` candidate
    rows (``n_source x 27 x grid_cap``) becomes ``'morton'``, with a
    warning, rather than raising from inside the loop; every other config is
    returned as given. Callers who know their card takes more call
    ``grid_nn`` with an explicit ``max_candidate_gathers``."""
    if config.matcher != "grid":
        return config
    budget = n_source * 27 * config.grid_cap
    if budget <= grid.MAX_CANDIDATE_GATHERS:
        return config
    warnings.warn(
        f"matcher='grid' candidate budget {budget:,} (N={n_source:,} x 27 "
        f"x cap={config.grid_cap}) exceeds the limit "
        f"{grid.MAX_CANDIDATE_GATHERS:,}, the largest measured; falling "
        "back to matcher='morton', the large-N path. Lower grid_cap or "
        "split the source to stay on the grid matcher.", stacklevel=2)
    return dataclasses.replace(config, matcher="morton")


def build_matcher_state(target: torch.Tensor,
                        target_mask: Optional[torch.Tensor],
                        config: ICPConfig,
                        target_normals: Optional[torch.Tensor] = None):
    """Per-target matcher structures, built once and reused every
    iteration: for ``matcher='grid'`` the ``VoxelTable``, for
    ``matcher='morton'`` one ``(MortonTable, normals in table order)`` per
    shift (the normals are K3's ``extra``); None otherwise. Targets ``[B, M,
    3]`` give the stacked tables of the B elements' own builds, the grid's
    cell size suggested for each element."""
    if config.matcher not in ("grid", "morton"):
        return None
    span = timing.begin("table")
    if config.matcher == "grid":
        cell = (grid.suggest_cell_size(target)
                if config.grid_cell_size is None else config.grid_cell_size)
        state = grid.build_voxel_table(target, cell,
                                       table_bits=config.grid_table_bits,
                                       q_mask=target_mask)
    else:
        states = []
        for s_idx in range(max(1, config.morton_shifts)):
            table = build_morton_table(target, target_mask,
                                       shift=0.5 * s_idx)
            normals_sorted = (None if target_normals is None else
                              gather_correspondences(target_normals,
                                                     table.orig_index)
                              .contiguous())
            states.append((table, normals_sorted))
        state = tuple(states)
    if span:
        span.end()
    return state


def _exact_rescue(points, target, target_mask, target_normals, q_m, n_m,
                  dmin, config: ICPConfig, source_mask):
    """Re-match the ``config.morton_rescue`` rows of largest banded
    distance exactly against the whole target (``nn_argmin``: kernel K1 on
    a CUDA tensor) and keep the closer match. Seam misses have unbounded
    banded distance, so the damaging rows separate cleanly by ``dmin``. A
    batch rescues each element's own rows: one batched K1 call."""
    k = min(config.morton_rescue, points.shape[-2])
    if k <= 0:
        return q_m, n_m, dmin
    score = dmin
    if source_mask is not None:  # padded rows must not take rescue slots
        score = torch.where(source_mask, score,
                            torch.full_like(score, -float("inf")))
    # stable descending sort: among equal scores the lower row comes first,
    # as lax.top_k orders them
    sel = torch.sort(score, dim=-1, descending=True,
                     stable=True).indices[..., :k]
    idx_e, d_e = nn_argmin(
        gather_correspondences(points, sel).contiguous(), target,
        target_mask,
        source_chunk=min(config.source_chunk, max(k, 8)),
        target_tile=config.target_tile, exact=config.exact_distances)
    d_old = torch.take_along_dim(dmin, sel, dim=-1)
    better = d_e < d_old
    rows = sel[..., None].expand(sel.shape + (3,))
    q_m = q_m.scatter(-2, rows, torch.where(
        better[..., None], gather_correspondences(target, idx_e),
        gather_correspondences(q_m, sel)))
    dmin = dmin.scatter(-1, sel, torch.where(better, d_e, d_old))
    if n_m is not None and target_normals is not None:
        n_m = n_m.scatter(-2, rows, torch.where(
            better[..., None],
            gather_correspondences(target_normals, idx_e),
            gather_correspondences(n_m, sel)))
    return q_m, n_m, dmin


def _match(points, target, target_mask, config: ICPConfig,
           matcher_state=None):
    """The configured exhaustive or grid matcher: ``(idx, sqdist, found)``,
    ``found`` None but for the fixed-radius grid matcher."""
    if config.matcher == "grid":
        return grid.grid_nn(points, matcher_state, cap=config.grid_cap)
    if config.matcher == "pallas" and config.pallas_mode == "packed6_idx":
        idx, dmin = nn_argmin_packed(points, target, target_mask)
    else:  # 'xla' keeps the exact matcher whatever pallas_mode is
        idx, dmin = nn_argmin(points, target, target_mask,
                              source_chunk=config.source_chunk,
                              target_tile=config.target_tile,
                              exact=config.exact_distances)
    return idx, dmin, None


def _correspondences(points, target, target_mask, target_normals,
                     config: ICPConfig, matcher_state, source_mask=None):
    """Find the correspondences: ``(q_matched, n_matched, dmin, found)``.
    For ``matcher='morton'`` the matched points and normals come from the
    band matcher, which reads them from the sorted table."""
    if config.matcher == "morton":
        impl = config.morton_impl
        if impl == "auto":
            impl = "pallas" if points.device.type == "cuda" else "xla"
        # pallas_mode maps 1:1 onto K3's geometry, as in the JAX package
        kw = {"mode": config.pallas_mode} if impl == "pallas" else {}
        nn_fn = morton_nn_band if impl == "pallas" else morton_nn
        q_m = n_m = dmin = None
        for table, normals_sorted in matcher_state:
            q_c, d_c, _, n_c = nn_fn(
                points, table, normals_sorted, chunk=config.morton_chunk,
                window=config.morton_window, **kw)
            if dmin is None:
                q_m, dmin, n_m = q_c, d_c, n_c
            else:  # keep the closer match of the shifted curve
                better = (d_c < dmin)[..., None]
                q_m = torch.where(better, q_c, q_m)
                if n_m is not None:
                    n_m = torch.where(better, n_c, n_m)
                dmin = torch.minimum(d_c, dmin)
        if config.morton_rescue > 0:
            q_m, n_m, dmin = _exact_rescue(
                points, target, target_mask, target_normals, q_m, n_m, dmin,
                config, source_mask)
        return q_m, n_m, dmin, None
    idx, dmin, found = _match(points, target, target_mask, config,
                              matcher_state)
    q_m = gather_correspondences(target, idx)
    n_m = (None if target_normals is None
           else gather_correspondences(target_normals, idx))
    return q_m, n_m, dmin, found


def _trimmed_mean(dmin: torch.Tensor, base: torch.Tensor, passes: int,
                  group=None) -> torch.Tensor:
    """Mean of ``dmin`` over ``base`` along its last axis (each batch
    element on its own), then ``passes`` times the mean over the entries at
    or below the previous mean; the last axis kept, of length 1. Each pass
    depends on the last, so each takes its own all-reduce over ``group``."""
    zero = torch.zeros_like(dmin)

    def mean(keep):
        total, count = _psum_all(
            (torch.where(keep, dmin, zero).sum(dim=-1, keepdim=True),
             keep.to(dmin.dtype).sum(dim=-1, keepdim=True)), group)
        return total / torch.clamp(count, min=1.0)

    t = mean(base)
    for _ in range(passes):
        t = mean((dmin <= t) & base)
    return t


def _robust_weights(dmin: torch.Tensor, mask: Optional[torch.Tensor],
                    loss: str, group=None) -> torch.Tensor:
    """IRLS weights from squared match distances. Scale = sqrt of the
    trimmed mean squared distance. Huber: w = min(1, k·s/r); Tukey
    biweight: w = (1 - (r/(k·s))²)² inside, 0 outside."""
    dmin = torch.clamp(dmin, min=0.0)
    finite = torch.isfinite(dmin)
    base = finite if mask is None else (
        (mask if mask.dtype == torch.bool else mask > 0) & finite)
    s = torch.sqrt(torch.clamp(_trimmed_mean(dmin, base, 1, group),
                               min=1e-30))
    r = torch.sqrt(dmin)
    if loss == "huber":
        k = 1.345 * s
        w = torch.clamp(k / torch.clamp(r, min=1e-30), max=1.0)
    else:  # tukey biweight
        k = 4.685 * s
        u = torch.clamp(r / k, 0.0, 1.0)
        w = (1.0 - u * u) ** 2
    return torch.where(base, w, torch.zeros_like(w))


def _auto_trim_gate(dmin: torch.Tensor, mask: Optional[torch.Tensor],
                    factor: float, group=None) -> torch.Tensor:
    """Outlier gate: iteratively re-trimmed mean of the squared match
    distances (3 passes) scaled by ``factor``."""
    finite = torch.isfinite(dmin)
    base = finite if mask is None else (mask & finite)
    dmin = torch.clamp(dmin, min=0.0)  # guard f32 cancellation noise
    gate = dmin <= factor * _trimmed_mean(dmin, base, 3, group) + 1e-12
    return gate if mask is None else (mask & gate)


def correspondence_weights(dmin: torch.Tensor, found: Optional[torch.Tensor],
                           config: ICPConfig,
                           source_mask: Optional[torch.Tensor] = None,
                           group=None):
    """The grid matcher's ``found`` → distance gate → auto-trim → IRLS
    weights, shared by :func:`icp_iteration`, AA-ICP's safeguard and the
    batched loop (``dmin`` [B, N]: the trimmed means and IRLS scales of
    each element on its own). Returns the solve mask: None, bool, or float
    weights. ``auto_trim`` defaults to 9.0 for the morton matcher, whose
    rare band misses have unbounded distance."""
    mask = source_mask
    if found is not None:  # grid matcher: unmatched rows leave the solve
        mask = found if mask is None else (mask & found)
    if config.max_correspondence_dist is not None:
        gate = dmin <= (config.max_correspondence_dist ** 2)
        mask = gate if mask is None else (mask & gate)
    auto_trim = config.auto_trim
    if auto_trim is None and config.matcher == "morton":
        auto_trim = 9.0
    if auto_trim:
        mask = _auto_trim_gate(dmin, mask, auto_trim, group)
    if config.robust_loss is not None:
        weights = _robust_weights(dmin, mask, config.robust_loss, group)
        mask = weights if mask is None else mask.to(torch.float32) * weights
    return mask


def _matched_fraction(mask, source_mask, n_rows: int, device,
                      group=None) -> torch.Tensor:
    """Fraction of (valid) source points entering the solve, one value a
    batch element; both counts over ``group``'s ranks in one all-reduce."""
    if mask is None:
        return torch.ones((), dtype=torch.float32, device=device)
    if source_mask is not None:
        denom = source_mask.to(torch.float32).sum(dim=-1)
    else:
        denom = torch.full((), float(n_rows), device=device)
    inliers, denom = _psum_all(
        ((mask > 0).to(torch.float32).sum(dim=-1), denom), group)
    return inliers / torch.clamp(denom, min=1.0)


def icp_iteration(points: torch.Tensor, target: torch.Tensor,
                  config: ICPConfig,
                  source_mask: Optional[torch.Tensor] = None,
                  target_mask: Optional[torch.Tensor] = None,
                  target_normals: Optional[torch.Tensor] = None,
                  group=None,
                  matcher_state=None,
                  source_normals: Optional[torch.Tensor] = None):
    """One ICP iteration: returns ``(new_points, incremental_transform,
    error, IterationAux)``. ``target_normals`` are needed by the plane,
    symmetric and gicp metrics, ``source_normals`` (rotated to the current
    pose) by the last two, and the grid and morton matchers their
    ``matcher_state`` (:func:`build_matcher_state`). ``points`` and
    ``source_mask`` may be a rank's shard of ``group`` (the JAX package's
    ``axis_name`` slot); ``target`` is whole."""
    q_matched, n_matched, dmin, found = _correspondences(
        points, target, target_mask, target_normals, config, matcher_state,
        source_mask=source_mask)
    mask = correspondence_weights(dmin, found, config, source_mask, group)
    aux = IterationAux(matched_fraction=_matched_fraction(
        mask, source_mask, points.shape[-2], points.device, group))
    if config.metric == "point":
        inc = kabsch_transform(
            points, q_matched, mask, solver=config.solver,
            det_correction=config.det_correction
            and not config.strict_reference, group=group)
    elif n_matched is None:
        raise ValueError(f"metric={config.metric!r} needs target_normals")
    elif config.metric == "symmetric":
        # symmetric point-to-plane (Rusinkiewicz 2019): residual
        # (p - q)·(n_p + n_q); unoriented normals could cancel, so n_q is
        # sign-aligned to n_p first
        if source_normals is None:
            raise ValueError("metric='symmetric' needs source_normals")
        sgn = torch.sign(torch.sum(source_normals * n_matched, dim=-1,
                                   keepdim=True))
        sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
        inc = point_to_plane_transform(
            points, q_matched, source_normals + sgn * n_matched, mask,
            damping=config.damping, group=group)
    elif config.metric == "gicp":
        # Generalized-ICP (Segal et al. 2009): the anisotropic Mahalanobis
        # residual of both clouds' surface covariances
        if source_normals is None:
            raise ValueError("metric='gicp' needs source_normals")
        inc = gicp_transform(points, q_matched, source_normals, n_matched,
                             mask, epsilon=config.gicp_epsilon,
                             damping=config.damping, group=group)
    else:
        inc = point_to_plane_transform(points, q_matched, n_matched, mask,
                                       damping=config.damping, group=group)
    new_points = inc.apply(points)
    error = rmse(new_points, q_matched, mask, group)
    return new_points, inc, error, aux


def _nan_padded(values, length: int, device) -> torch.Tensor:
    out = torch.full((length,), float("nan"), dtype=torch.float32,
                     device=device)
    if values:
        out[:len(values)] = torch.stack(values)
    return out


def _normals_prepass(cloud, mask, config: ICPConfig) -> torch.Tensor:
    """The normals of ``cloud`` [M, 3], or of each cloud of a batch [B, M,
    3] in one pass (``estimate_normals`` records the span ``normals``)."""
    return estimate_normals(
        cloud, k=config.k_neighbors, mask=mask, chunk=config.source_chunk,
        tile=config.target_tile,
        banded_threshold=config.normals_banded_threshold)


class _Prepared(NamedTuple):
    """What a registration loop starts from: :func:`_prepare`'s result."""

    source: torch.Tensor  # in Morton order on the morton matcher
    target: torch.Tensor
    source_mask: Optional[torch.Tensor]
    target_mask: Optional[torch.Tensor]
    target_normals: Optional[torch.Tensor]
    source_normals: Optional[torch.Tensor]  # symmetric and gicp only
    matcher_state: object
    unsort: Optional[torch.Tensor]  # rows back to the caller's order
    config: ICPConfig  # after resolve_matcher


def _prepare(source, target, config: ICPConfig,
             source_mask: Optional[torch.Tensor] = None,
             target_mask: Optional[torch.Tensor] = None,
             target_normals: Optional[torch.Tensor] = None,
             source_normals: Optional[torch.Tensor] = None,
             matcher_state=None, batched: bool = False) -> _Prepared:
    """The set-up that ``run_icp``, ``run_aa_icp`` and ``register_batch``
    share: contiguous float32 clouds on the source's device, the normals
    prepass of the metrics that need normals, the matcher resolved for the
    source's size and its state built (a prebuilt grid table above the
    limit is rebuilt for morton), and on the morton matcher the source
    sorted along the target's curve once: the solve and the error do not
    depend on the row order, and the loop then reads bands only.
    ``batched``: the clouds are ``[B, N, 3]`` float32 tensors on one device
    (``register_batch`` checks them), each element prepared on its own,
    its normals and tables in one pass for the batch."""
    # the kernels take contiguous f32 rows; views are copied once here
    if batched:
        device = source.device
        points = lambda x: x.to(device)  # noqa: E731
    else:
        source = as_points(source)
        device = source.device
        points = lambda x: as_points(x, device=device)  # noqa: E731
    source = source.contiguous()
    target = points(target).contiguous()
    if target_mask is not None:
        target_mask = target_mask.to(device).contiguous()
    if source_mask is not None:
        source_mask = source_mask.to(device)

    carries_normals = config.metric in ("symmetric", "gicp")
    if config.metric in ("plane", "symmetric", "gicp"):
        target_normals = (_normals_prepass(target, target_mask, config)
                          if target_normals is None else
                          points(target_normals))
        target_normals = target_normals.contiguous()
    if carries_normals:
        source_normals = (_normals_prepass(source, source_mask, config)
                          if source_normals is None else
                          points(source_normals))
    resolved = resolve_matcher(config, source.shape[-2])
    if matcher_state is None or resolved.matcher != config.matcher:
        matcher_state = build_matcher_state(target, target_mask, resolved,
                                            target_normals)

    unsort = None
    if resolved.matcher == "morton":
        span = timing.begin("source_order")
        order = source_morton_order(source, matcher_state[0][0]).long()
        source = gather_correspondences(source, order).contiguous()
        if source_mask is not None:
            source_mask = torch.take_along_dim(source_mask, order, dim=-1)
        if carries_normals:
            source_normals = gather_correspondences(source_normals, order)
        unsort = torch.empty_like(order).scatter_(
            -1, order, torch.arange(order.shape[-1], device=device)
            .expand_as(order))
        if span:
            span.end()
    return _Prepared(source, target, source_mask, target_mask, target_normals,
                     source_normals if carries_normals else None,
                     matcher_state, unsort, resolved)


def run_icp(source, target, config: ICPConfig = ICPConfig(),
            source_mask: Optional[torch.Tensor] = None,
            target_mask: Optional[torch.Tensor] = None,
            target_normals: Optional[torch.Tensor] = None,
            group=None,
            source_normals: Optional[torch.Tensor] = None,
            matcher_state=None) -> ICPResult:
    """Register ``source`` onto ``target`` on their device.

    ``target_normals`` (and ``source_normals`` for the symmetric and gicp
    metrics) are estimated when not given; ``matcher_state`` takes a
    prebuilt :func:`build_matcher_state` to reuse the target's voxel or
    Morton tables. A grid config above the candidate limit degrades to the
    morton matcher (:func:`resolve_matcher`), a prebuilt grid table
    included, which is then rebuilt for the morton matcher. ``group`` (a
    ``torch.distributed`` process group, in the JAX package's ``axis_name``
    slot, so that a call in its positional order binds alike) makes
    ``source`` one rank's shard, every sum all-reduced over the group, as
    :func:`fpcr_tpu_torch.parallel.distributed_icp` drives it."""
    return _run_icp(source, target, config, source_mask, target_mask,
                    target_normals, source_normals, matcher_state,
                    group=group)


class _ICPState(NamedTuple):
    """The loop state, every field on the device."""

    points: torch.Tensor
    normals: Optional[torch.Tensor]  # carried source normals, or None
    rotation: torch.Tensor
    translation: torch.Tensor
    prev_error: torch.Tensor
    done: torch.Tensor
    num_iterations: torch.Tensor


def _icp_chunk(state: _ICPState, consts, k: int):
    """``k`` masked iterations of :func:`run_icp` from ``state``: ``(state,
    rows [k, 4])``, a row an iteration holding its error, matched
    fraction, ‖Δt‖ and ∠ΔR, NaN where the loop had stopped. ``consts`` is
    ``(target, source_mask, target_mask, target_normals, matcher_state,
    config, group)``. A pure function of its tensors but for ``state``,
    which it updates in place and returns: on the card one CUDA graph a
    ``k`` (:func:`drive_chunks`). A batch state (``[B, N, 3]`` points,
    ``[B]`` flags) gives rows ``[k, 4, B]``, each element masked by its own
    flag (``register_batch``).

    Each iteration is a ``graphs.skip_if_all(done)`` block: in a captured
    chunk, an iteration that starts with every element done runs none of
    its kernels, and leaves the state and its row (NaN) as its masked run
    would. A sharded loop (``group``) runs every iteration, its collectives
    outside any conditional node."""
    (target, source_mask, target_mask, target_normals, matcher_state,
     config, group) = consts
    points, normals, rotation, translation, prev_error, done, n_it = state
    nan = torch.full((), float("nan"), device=points.device)
    rows = torch.full((k, 4) + tuple(done.shape), float("nan"),
                      device=points.device)
    for i in range(k):
        with (graphs.skip_if_all(done) if group is None
              else contextlib.nullcontext()):
            new_points, inc, error, aux = icp_iteration(
                points, target, config, source_mask, target_mask,
                target_normals, group, matcher_state, normals)
            active = ~done
            a1, a2 = active[..., None], active[..., None, None]
            torch.where(active, torch.stack([
                error, torch.broadcast_to(aux.matched_fraction, error.shape),
                torch.linalg.vector_norm(inc.translation, dim=-1),
                rotation_angle(inc.rotation)]), nan, out=rows[i])
            converged = (error < config.tolerance) | (
                torch.abs(error - prev_error) < config.tolerance)
            composed = inc.compose(RigidTransform(rotation, translation))
            torch.where(a2, new_points, points, out=points)
            if normals is not None:  # full f32 rotation of carried normals
                torch.where(a2, torch.matmul(
                    normals, inc.rotation.transpose(-1, -2)), normals,
                    out=normals)
            torch.where(a2, composed.rotation, rotation, out=rotation)
            torch.where(a1, composed.translation, translation,
                        out=translation)
            torch.where(active, error, prev_error, out=prev_error)
            n_it.add_(active.to(torch.int32))
            done.logical_or_(active & converged)
    return state, rows


def _graph_counts() -> tuple:
    return graphs.CACHE.replays, len(graphs.CACHE.captures)


def _chunk_route(before: tuple) -> str:
    """How the chunk run since ``before = _graph_counts()`` ran."""
    replays, captures = _graph_counts()
    if replays != before[0]:
        return "replay"
    return "capture" if captures != before[1] else "eager"


def drive_chunks(body, state, consts, iterations: int, stopped,
                 row_shape: tuple, *, group=None, check=None):
    """Run ``body(state, consts, k) -> (state, rows [k, *row_shape])`` for
    ``iterations`` iterations in chunks of ``k = DONE_CHECK_EVERY`` (the
    last one shorter), reading ``stopped(state)`` on the host before every
    chunk but the first, where the loops read their done flag; a chunk
    after the stop would change nothing. Returns the last state and the
    rows of the chunks run, NaN-padded to ``[iterations, *row_shape]``.

    On the card the chunks run by ``utils/graphs.py::bind``: the first
    loop of a key (``body``, the shapes of ``consts``, the config) runs
    eagerly, and every later one replays a CUDA graph a chunk length, so
    nothing in an iteration waits for the host. A sharded loop (its sums
    all-reduced over ``group``) is captured with its collectives when the
    group's backend is NCCL. The chunks run eagerly on the CPU, under
    ``graphs.eager()``, for a gloo ``group`` (its collectives run on the
    host: ``graphs.capturable``) and under
    :func:`utils.diagnostics.debug_nans`, whose ``check(state, rows,
    start)`` reads each iteration's error: there a chunk is one
    iteration. Each route is chosen here, before the loop; a capture that
    fails raises.

    ``body`` may update the state it is handed in place: an eager chunk is
    handed a copy of its state, a replayed one the graph's static buffers.

    Recorded (``utils/timing.py``), the set-up before the first chunk is
    the span ``bind`` (its route, ``eager`` or ``graphs``, and the bytes of
    ``consts`` copied into the graphs' static buffers, which count on the
    call), each ``stopped`` read is the span ``done_read`` and counts one
    host sync on the call, and each chunk is the span ``chunk`` (``k``, and
    its route: ``eager``, ``capture`` or ``replay``) and counts on the call
    by its route. A loop whose replayed chunks hold ``skip_if_all`` blocks
    counts ``iterations_run`` and, after its last chunk,
    ``iterations_skipped`` on the call (``graphs.Loop.finish``)."""
    every = 1 if check is not None else DONE_CHECK_EVERY
    device = state[0].device
    span = timing.begin("bind")
    if span:
        bound = graphs.CACHE.loops["graphs"]
    # every route computes on the layouts the graphs hold: contiguous
    consts = graphs.contiguous(consts)
    if (graphs.captured(device) and graphs.capturable(group)
            and check is None):
        step = graphs.bind(body, consts)
    else:
        step = graphs.Loop(body, consts)
    out = torch.full((iterations,) + tuple(row_shape), float("nan"),
                     device=device)
    if span:
        graphed = graphs.CACHE.loops["graphs"] != bound
        nbytes = graphs.tensor_bytes(consts) if graphed else 0
        span.end(route="graphs" if graphed else "eager", bytes=nbytes)
        timing.count("bytes_copied", nbytes)
    for start in range(0, iterations, every):
        if start and start % DONE_CHECK_EVERY == 0:
            span = timing.begin("done_read")
            stop = stopped(state)
            if span:
                span.end()
                timing.count("syncs")
            if stop:
                break
        k = min(every, iterations - start)
        span = timing.begin("chunk")
        if span:
            before = _graph_counts()
        new_state, rows = step(state, k)
        if check is not None:
            check(state, rows, start)
        state = new_state
        out[start:start + k] = rows
        if span:
            route = _chunk_route(before)
            span.end(k=k, route=route)
            timing.count("chunks_" + route)
    step.finish()
    return state, out


def rescued_mark(call, device) -> Optional[torch.Tensor]:
    """Where ``call`` is recorded, a mark of K1's rescued-row counter on
    ``device`` (``ops/matching_cuda.py::rescued_mark``: a copy on the
    device, nothing read), taken before the call's first K1 launch; else
    None, and nothing done."""
    return matching_cuda.rescued_mark(device) if call else None


def count_k1_rescued(call, device, mark) -> None:
    """Add to a recorded ``call`` ``k1_rescued``: the rows that K1's finish
    rescanned exactly on ``device`` since ``mark``, read from its counter
    after the loop's last wait for the device. Left out where K1 and K2
    have not run there (on the CPU)."""
    if not call:
        return
    rescued = matching_cuda.k1_rescued_since(device, mark)
    if rescued is not None:
        call.attrs["k1_rescued"] = rescued


def _run_icp(source, target, config: ICPConfig,
             source_mask: Optional[torch.Tensor] = None,
             target_mask: Optional[torch.Tensor] = None,
             target_normals: Optional[torch.Tensor] = None,
             source_normals: Optional[torch.Tensor] = None,
             matcher_state=None, group=None) -> ICPResult:
    """:func:`run_icp` on one rank's shard of the source when ``group`` is
    set: the shard is Morton-sorted on its own (morton matcher), every sum
    is all-reduced over ``group``, and ``points`` is the shard's, in its
    input row order.

    On the card the loop runs as CUDA graphs of ``DONE_CHECK_EVERY``
    iterations (:func:`drive_chunks`), the counterpart of the JAX loop's
    one ``jit``, from the second call of its shapes and config on, a
    sharded loop over NCCL included. It runs eagerly, one launch at a time,
    on the first such call, on the CPU, with a gloo ``group`` and under
    ``debug_nans``.

    Recorded (``utils/timing.py``), a call is the root span ``call`` over
    the spans ``prepare`` (:func:`_prepare` and the loop's first state),
    :func:`drive_chunks`' and ``result`` (from the loop's end to the
    returned ``ICPResult``), and counts ``k1_rescued``
    (:func:`count_k1_rescued`)."""
    with timing.call("run_icp") as call:
        span = timing.begin("prepare")
        pin_f32_precision()
        (source, target, source_mask, target_mask, target_normals,
         source_normals, matcher_state, unsort, config) = _prepare(
            source, target, config, source_mask, target_mask,
            target_normals, source_normals, matcher_state)
        check = None
        if diagnostics.nans_checked():
            def check(before, rows, start):
                diagnostics.check_iteration(rows[0, 0], ~before.done, start,
                                            "run_icp")
        # the chunk never reads max_iterations: one graph serves every
        # length
        consts = (target, source_mask, target_mask, target_normals,
                  matcher_state,
                  dataclasses.replace(config, max_iterations=0), group)
        device = source.device
        mark = rescued_mark(call, device)
        identity = RigidTransform.identity(device=device)
        state = _ICPState(source, source_normals, identity.rotation,
                          identity.translation,
                          torch.full((), float("inf"), device=device),
                          torch.zeros((), dtype=torch.bool, device=device),
                          torch.zeros((), dtype=torch.int32, device=device))
        if span:
            span.end()
        if call:
            call.attrs.update(B=1, N=source.shape[-2], M=target.shape[-2],
                              metric=config.metric, matcher=config.matcher)
        state, rows = drive_chunks(_icp_chunk, state, consts,
                                   config.max_iterations,
                                   lambda st: bool(st.done), (4,),
                                   group=group, check=check)
        count_k1_rescued(call, device, mark)
        span = timing.begin("result")
        errors, fractions, delta_t, delta_rot = rows.T.contiguous()
        result = ICPResult(
            transform=RigidTransform(state.rotation, state.translation),
            errors=errors,
            num_iterations=state.num_iterations,
            converged=state.done,
            points=(state.points if unsort is None
                    else gather_correspondences(state.points, unsort)),
            matched_fraction=fractions,
            delta_t=delta_t,
            delta_rot=delta_rot,
        )
        if span:
            span.end()
        return result


def tune_morton(source, target, config: Optional[ICPConfig] = None, *,
                target_miss: float = 0.02, sample: int = 2048,
                target_mask: Optional[torch.Tensor] = None) -> ICPConfig:
    """A morton config whose band matcher misses fewer than ``target_miss``
    of the true nearest neighbours on this cloud pair, measured by probing
    a strided sample against the exact NN. The ladder: the config as given;
    then ``morton_shifts=2``; then ``morton_rescue=K``, K sized to cover
    every damaging probed miss by its banded distance."""
    config = config or ICPConfig(matcher="morton")
    if config.matcher != "morton":
        config = dataclasses.replace(config, matcher="morton")
    pin_f32_precision()
    src = as_points(source).contiguous()
    tgt = as_points(target, device=src.device).contiguous()
    if target_mask is not None:
        target_mask = target_mask.to(src.device).contiguous()

    def probe(cfg):
        state = build_matcher_state(tgt, target_mask, cfg)
        order = source_morton_order(src, state[0][0]).long()
        p = src[order].contiguous()
        _, _, dmin, _ = _correspondences(
            p, tgt, target_mask, None,
            dataclasses.replace(cfg, morton_rescue=0), state)
        stride = max(1, -(-p.shape[0] // sample))
        rows = torch.arange(0, p.shape[0], stride, device=p.device)[:sample]
        _, d_e = nn_argmin(p[rows].contiguous(), tgt, target_mask)
        d_b = dmin[rows].cpu().numpy()
        d_e_np = d_e.cpu().numpy()
        excess = d_b - d_e_np
        noise, damage = miss_floors(p.cpu().numpy().astype(np.float64))
        miss = excess > np.maximum(noise, 1e-4 * d_e_np)
        damaging = excess > damage
        # rescue K: every damaging miss covered by its banded distance,
        # mild misses only down to half of target_miss
        thresh = np.inf
        if damaging.any():
            thresh = float(d_b[damaging].min())
        mild = miss & ~damaging
        n_mild = int(mild.sum())
        allow = int(0.5 * target_miss * miss.shape[0])
        if n_mild > allow:
            md = np.sort(d_b[mild])[::-1]
            thresh = min(thresh, float(md[n_mild - allow - 1]))
        k_cover = (int((dmin >= thresh).sum()) if np.isfinite(thresh)
                   else 0)
        return float(miss.mean()), k_cover

    miss0, _ = probe(config)
    if miss0 <= target_miss:
        return config
    cfg2 = dataclasses.replace(config,
                               morton_shifts=max(config.morton_shifts, 2))
    miss2, k2 = probe(cfg2)
    if miss2 <= target_miss:
        return cfg2
    k = min(int(math.ceil(1.25 * max(k2, 1) / 256.0)) * 256, src.shape[0])
    return dataclasses.replace(cfg2, morton_rescue=k)


def _metric_wrapper(metric: str, source, target, kwargs) -> ICPResult:
    config = kwargs.pop("config", None)
    if config is None:
        fields = {k: kwargs.pop(k) for k in list(kwargs)
                  if k in ICPConfig.__dataclass_fields__}
        if fields.pop("metric", metric) != metric:
            raise ValueError(
                f"metric is fixed to {metric!r} by this entry point; use "
                "run_icp(config=...) to pick the metric explicitly")
        config = ICPConfig(metric=metric, **fields)
    return run_icp(source, target, config, **kwargs)


def icp_point_to_point(source, target, **kwargs) -> ICPResult:
    """Point-to-point ICP. Takes ``config=ICPConfig(...)`` or its fields as
    keywords, plus the keywords of :func:`run_icp`."""
    return _metric_wrapper("point", source, target, kwargs)


def icp_point_to_plane(source, target, **kwargs) -> ICPResult:
    """Point-to-plane ICP (PCA target normals, 6x6 solve), called as
    :func:`icp_point_to_point`."""
    return _metric_wrapper("plane", source, target, kwargs)


def icp_generalized(source, target, **kwargs) -> ICPResult:
    """Generalized-ICP (plane-to-plane, Segal et al. 2009), called as
    :func:`icp_point_to_point`."""
    return _metric_wrapper("gicp", source, target, kwargs)
