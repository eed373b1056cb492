"""The ICP registration loop, point-to-point metric, state kept on the device.

Counterpart of ``fpcr_tpu/models/icp.py``. One iteration is the
reference's: match → gather → Kabsch → apply → error, with the error
measured between the newly transformed source and the correspondences found
at the start of the iteration. The loop stops when ``E < tol`` or
``|E - E_prev| < tol`` (``E_prev`` starts at ``inf``), or at
``max_iterations``.

The JAX loop is one ``lax.while_loop`` with no host sync until the result.
Here the loop state (points, transform, previous error, done flag,
iteration count) stays on the device and every update is masked by the
device ``done`` flag, so an iteration that runs after the stop changes
nothing. The host reads ``done`` only every ``DONE_CHECK_EVERY``
iterations, never per iteration; the results equal those of a
per-iteration check.

Config values outside this slice (other metrics and matchers, the packed
index kernel) construct, since the validation accepts them, and raise
``NotImplementedError`` at :func:`run_icp`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..core.cloud import as_points
from ..core.metrics import rmse
from ..core.transforms import RigidTransform
from ..ops.matching import gather_correspondences, nn_argmin
from ..ops.solve import kabsch_transform
from ..utils.precision import pin_f32_precision

# The host reads the device `done` flag once per this many iterations: a
# stop is seen at most 7 iterations late, and those iterations are masked.
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
    # sqdist); None = off
    auto_trim: Optional[float] = None
    robust_loss: Optional[str] = None  # None | 'huber' | 'tukey' (IRLS)
    gicp_epsilon: float = 1e-3
    # tile sizes of the plain matcher that CPU tensors take
    source_chunk: int = 2048
    target_tile: int = 2048
    # 'xla' and 'pallas' both mean the brute matcher nn_argmin (kernel K1
    # on a CUDA tensor); 'grid' and 'morton' are not ported yet
    matcher: str = "xla"
    exact_distances: bool = False  # plain matcher: difference form
    grid_cell_size: Optional[float] = None
    grid_cap: int = 8
    grid_table_bits: int = 20
    morton_chunk: int = 256
    morton_window: int = 256
    morton_unroll: int = 16
    morton_impl: str = "auto"
    # 'packed6', 'highest' and the 'packed6_pipe*'/'packed6_seq' aliases all
    # mean the one FP32 kernel K1; 'packed6_idx' (K2) is not ported yet
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


def check_supported(config: ICPConfig) -> None:
    """Raise ``NotImplementedError`` for config values outside this slice,
    naming the ROADMAP.md item that ports them."""
    if config.metric != "point":
        raise NotImplementedError(
            f"metric={config.metric!r} is not ported yet (ROADMAP.md, "
            "'Modules to port': normals and the plane solve, GICP)")
    if config.matcher in ("grid", "morton"):
        raise NotImplementedError(
            f"matcher={config.matcher!r} is not ported yet (ROADMAP.md, "
            "'Modules to port': the Morton band matcher and kernel K3, "
            "ops/grid.py)")
    if config.matcher == "pallas" and config.pallas_mode == "packed6_idx":
        raise NotImplementedError(
            "pallas_mode='packed6_idx' is kernel K2, not ported yet "
            "(ROADMAP.md, 'TPU kernels to port': K2)")


class ICPResult(NamedTuple):
    transform: RigidTransform  # accumulated source→target estimate
    errors: torch.Tensor  # [max_iterations] RMSE per iteration, NaN after stop
    num_iterations: torch.Tensor  # int32 — iterations executed
    converged: torch.Tensor  # bool
    points: torch.Tensor  # final transformed source cloud
    matched_fraction: torch.Tensor  # [max_iterations], NaN after stop
    delta_t: torch.Tensor  # [max_iterations] ‖Δt‖ of the increment
    delta_rot: torch.Tensor  # [max_iterations] ∠ΔR (radians) of it


class IterationAux(NamedTuple):
    """Per-iteration diagnostics emitted by ``icp_iteration``."""

    matched_fraction: torch.Tensor  # scalar — inliers entering the solve / N


def rotation_angle(rotation: torch.Tensor) -> torch.Tensor:
    """Rotation angle (radians) of a 3×3 rotation: θ = arccos((tr R − 1)/2)."""
    return torch.arccos(torch.clamp(0.5 * (torch.trace(rotation) - 1.0),
                                    -1.0, 1.0))


def _trimmed_mean(dmin: torch.Tensor, base: torch.Tensor,
                  passes: int) -> torch.Tensor:
    """Mean of ``dmin`` over ``base``, then ``passes`` times the mean over
    the entries at or below the previous mean."""
    zero = torch.zeros_like(dmin)
    t = (torch.where(base, dmin, zero).sum()
         / torch.clamp(base.to(dmin.dtype).sum(), min=1.0))
    for _ in range(passes):
        keep = (dmin <= t) & base
        t = (torch.where(keep, dmin, zero).sum()
             / torch.clamp(keep.to(dmin.dtype).sum(), min=1.0))
    return t


def _robust_weights(dmin: torch.Tensor, mask: Optional[torch.Tensor],
                    loss: str) -> torch.Tensor:
    """IRLS weights from squared match distances. Scale = sqrt of the
    trimmed mean squared distance. Huber: w = min(1, k·s/r); Tukey
    biweight: w = (1 - (r/(k·s))²)² inside, 0 outside."""
    dmin = torch.clamp(dmin, min=0.0)
    finite = torch.isfinite(dmin)
    base = finite if mask is None else (
        (mask if mask.dtype == torch.bool else mask > 0) & finite)
    s = torch.sqrt(torch.clamp(_trimmed_mean(dmin, base, 1), min=1e-30))
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
                    factor: float) -> torch.Tensor:
    """Outlier gate: iteratively re-trimmed mean of the squared match
    distances (3 passes) scaled by ``factor``."""
    finite = torch.isfinite(dmin)
    base = finite if mask is None else (mask & finite)
    dmin = torch.clamp(dmin, min=0.0)  # guard f32 cancellation noise
    gate = dmin <= factor * _trimmed_mean(dmin, base, 3) + 1e-12
    return gate if mask is None else (mask & gate)


def correspondence_weights(dmin: torch.Tensor, config: ICPConfig,
                           source_mask: Optional[torch.Tensor] = None):
    """Distance gate → auto-trim → IRLS weights. Returns the solve mask:
    None, bool, or float weights."""
    mask = source_mask
    if config.max_correspondence_dist is not None:
        gate = dmin <= (config.max_correspondence_dist ** 2)
        mask = gate if mask is None else (mask & gate)
    if config.auto_trim:
        mask = _auto_trim_gate(dmin, mask, config.auto_trim)
    if config.robust_loss is not None:
        weights = _robust_weights(dmin, mask, config.robust_loss)
        mask = weights if mask is None else mask.to(torch.float32) * weights
    return mask


def _matched_fraction(mask, source_mask, n_rows: int,
                      device) -> torch.Tensor:
    """Fraction of (valid) source points entering the solve."""
    if mask is None:
        return torch.ones((), dtype=torch.float32, device=device)
    if source_mask is not None:
        denom = source_mask.to(torch.float32).sum()
    else:
        denom = torch.tensor(float(n_rows), device=device)
    inliers = (mask > 0).to(torch.float32).sum()
    return inliers / torch.clamp(denom, min=1.0)


def icp_iteration(points: torch.Tensor, target: torch.Tensor,
                  config: ICPConfig,
                  source_mask: Optional[torch.Tensor] = None,
                  target_mask: Optional[torch.Tensor] = None):
    """One point-to-point iteration: returns
    ``(new_points, incremental_transform, error, IterationAux)``."""
    idx, dmin = nn_argmin(points, target, target_mask,
                          source_chunk=config.source_chunk,
                          target_tile=config.target_tile,
                          exact=config.exact_distances)
    q_matched = gather_correspondences(target, idx)
    mask = correspondence_weights(dmin, config, source_mask)
    aux = IterationAux(matched_fraction=_matched_fraction(
        mask, source_mask, points.shape[0], points.device))
    inc = kabsch_transform(
        points, q_matched, mask, solver=config.solver,
        det_correction=config.det_correction and not config.strict_reference)
    new_points = inc.apply(points)
    error = rmse(new_points, q_matched, mask)
    return new_points, inc, error, aux


def _nan_padded(values, length: int, device) -> torch.Tensor:
    out = torch.full((length,), float("nan"), dtype=torch.float32,
                     device=device)
    if values:
        out[:len(values)] = torch.stack(values)
    return out


def run_icp(source, target, config: ICPConfig = ICPConfig(),
            source_mask: Optional[torch.Tensor] = None,
            target_mask: Optional[torch.Tensor] = None) -> ICPResult:
    """Register ``source`` onto ``target`` on their device."""
    check_supported(config)
    pin_f32_precision()
    # the kernel takes contiguous f32 rows; views are copied once here
    source = as_points(source).contiguous()
    target = as_points(target, device=source.device).contiguous()
    if target_mask is not None:
        target_mask = target_mask.contiguous()
    device = source.device
    nan = torch.tensor(float("nan"), device=device)

    points = source
    transform = RigidTransform.identity(device=device)
    prev_error = torch.tensor(float("inf"), device=device)
    done = torch.zeros((), dtype=torch.bool, device=device)
    num_iterations = torch.zeros((), dtype=torch.int32, device=device)
    errors, fractions, delta_t, delta_rot = [], [], [], []
    for it in range(config.max_iterations):
        if it and it % DONE_CHECK_EVERY == 0 and bool(done):
            break
        new_points, inc, error, aux = icp_iteration(
            points, target, config, source_mask, target_mask)
        active = ~done
        errors.append(torch.where(active, error, nan))
        fractions.append(torch.where(active, aux.matched_fraction, nan))
        delta_t.append(torch.where(active, torch.linalg.vector_norm(
            inc.translation), nan))
        delta_rot.append(torch.where(active, rotation_angle(inc.rotation),
                                     nan))
        converged = (error < config.tolerance) | (
            torch.abs(error - prev_error) < config.tolerance)
        composed = inc.compose(transform)
        points = torch.where(active, new_points, points)
        transform = RigidTransform(
            torch.where(active, composed.rotation, transform.rotation),
            torch.where(active, composed.translation, transform.translation))
        prev_error = torch.where(active, error, prev_error)
        num_iterations = num_iterations + active.to(torch.int32)
        done = done | (active & converged)

    n = config.max_iterations
    return ICPResult(
        transform=transform,
        errors=_nan_padded(errors, n, device),
        num_iterations=num_iterations,
        converged=done,
        points=points,
        matched_fraction=_nan_padded(fractions, n, device),
        delta_t=_nan_padded(delta_t, n, device),
        delta_rot=_nan_padded(delta_rot, n, device),
    )


def icp_point_to_point(source, target, **kwargs) -> ICPResult:
    """Point-to-point ICP. Takes ``config=ICPConfig(...)`` or its fields as
    keywords, plus ``source_mask``/``target_mask``."""
    config = kwargs.pop("config", None)
    if config is None:
        fields = {k: kwargs.pop(k) for k in list(kwargs)
                  if k in ICPConfig.__dataclass_fields__}
        if fields.pop("metric", "point") != "point":
            raise ValueError(
                "metric is fixed to 'point' by this entry point; use "
                "run_icp(config=...) to pick the metric explicitly")
        config = ICPConfig(metric="point", **fields)
    return run_icp(source, target, config, **kwargs)
