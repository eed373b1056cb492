"""Timing on the card with CUDA events.

* :func:`cuda_time_ms` — min/mean/max of a call over ``repeats`` runs, each
  timed by a pair of CUDA events (min-of-k is the headline, the reference's
  min-of-10 policy);
* :func:`slope_ms_per_iter` — per-iteration milliseconds of a loop by the
  slope method that ``bench.py`` uses: ``(T(k_hi) - T(k_lo)) / (k_hi -
  k_lo)``, each leg the minimum over ``repeats``, so fixed per-call costs
  (allocation, set-up, the final copy) cancel;
* :class:`PhaseTimer` and :func:`profile_icp` — the reference's per-stage
  breakdown (matching / minimisation / transformation / error, %-of-total),
  each phase timed by a pair of CUDA events on the card and synchronised at
  its end, by the host clock on the CPU;
* :func:`profiler_trace` — a ``torch.profiler`` trace for TensorBoard.

Events measure the device timeline between two points of the stream, which
includes any time the device waits on the host. There is no CPU fallback: a
timing that finds no CUDA device raises.
"""

from __future__ import annotations

import contextlib
import time
from collections import OrderedDict
from typing import Callable, Dict, Optional

import torch

from .device import resolve_device


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA-event timing needs a CUDA device")


def _event_ms(fn: Callable[[], object]) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def cuda_time_ms(fn: Callable[[], object], repeats: int = 10,
                 warmup: int = 1) -> Dict[str, float]:
    """Time ``fn()`` on the current stream: ``{"min", "mean", "max"}`` in
    milliseconds over ``repeats`` runs, after ``warmup`` untimed runs."""
    _require_cuda()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = [_event_ms(fn) for _ in range(repeats)]
    return {"min": min(times), "mean": sum(times) / len(times),
            "max": max(times), "repeats": repeats}


def slope_ms_per_iter(run: Callable[[int], object], k_lo: int = 10,
                      k_hi: int = 60, repeats: int = 5) -> Dict[str, float]:
    """Per-iteration ms of ``run(k)``, a loop of exactly ``k`` iterations,
    by the slope of the minimum times of the two legs."""
    if k_hi <= k_lo:
        raise ValueError("need k_hi > k_lo")
    _require_cuda()
    run(k_lo)  # warm both legs: first-call costs stay out of the timing
    run(k_hi)
    torch.cuda.synchronize()
    lo = min(_event_ms(lambda: run(k_lo)) for _ in range(repeats))
    hi = min(_event_ms(lambda: run(k_hi)) for _ in range(repeats))
    return {"ms_per_iter": (hi - lo) / (k_hi - k_lo), "lo_ms": lo,
            "hi_ms": hi, "k_lo": k_lo, "k_hi": k_hi, "repeats": repeats}


class PhaseTimer:
    """Accumulate time per named phase and report each phase's share of the
    total, like the reference. On ``device`` (the card by default) a phase
    is a pair of CUDA events, synchronised at the phase's end, which blocks
    as ``block_until_ready`` does; on the CPU it is the host clock."""

    def __init__(self, device=None) -> None:
        self.device = torch.device(resolve_device(device))
        self.totals: "OrderedDict[str, float]" = OrderedDict()
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        cuda = self.device.type == "cuda"
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            t0 = time.perf_counter()
        try:
            yield
        finally:
            if cuda:
                end.record()
                end.synchronize()
                dt = start.elapsed_time(end) / 1e3
            else:
                dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        total = sum(self.totals.values()) or 1.0
        lines = [f"{'phase':<16}{'total ms':>12}{'calls':>8}{'%':>8}"]
        for name, t in self.totals.items():
            lines.append(f"{name:<16}{t * 1e3:>12.3f}{self.counts[name]:>8}"
                         f"{100.0 * t / total:>7.1f}%")
        lines.append(f"{'TOTAL':<16}{total * 1e3:>12.3f}")
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, float]:
        return {k: v * 1e3 for k, v in self.totals.items()}  # ms


def profile_icp(source, target, config, iterations: int = 5,
                target_normals: Optional[torch.Tensor] = None) -> PhaseTimer:
    """Stepwise ICP with a timed phase per stage: the reference's matching
    (``nn_argmin``, kernel K1 on a CUDA tensor), gather, minimisation,
    transformation and error, on the clouds' device. Only the reference's
    point and plane metrics with the brute matcher ``'xla'``: profiling
    another algorithm than the one configured would mislead."""
    if config.metric not in ("point", "plane"):
        raise ValueError(
            f"profile_icp breaks down the point/plane pipelines; "
            f"metric={config.metric!r} has a different solve structure; "
            "time it end to end with slope_ms_per_iter instead")
    if config.matcher not in ("xla",):
        raise ValueError(
            f"profile_icp times the brute streaming matcher; "
            f"matcher={config.matcher!r} is not represented in this "
            "breakdown; time the matcher's kernel alone with cuda_time_ms")
    from ..core.cloud import as_points
    from ..core.metrics import rmse
    from ..ops.matching import gather_correspondences, nn_argmin
    from ..ops.normals import estimate_normals
    from ..ops.solve import kabsch_transform, point_to_plane_transform
    from .precision import pin_f32_precision

    pin_f32_precision()
    p = as_points(source).contiguous()
    target = as_points(target, device=p.device).contiguous()
    timer = PhaseTimer(p.device)
    if config.metric == "plane" and target_normals is None:
        with timer.phase("normals"):
            target_normals = estimate_normals(target, k=config.k_neighbors)
    for _ in range(iterations):
        with timer.phase("matching"):
            idx, _ = nn_argmin(p, target, source_chunk=config.source_chunk,
                               target_tile=config.target_tile)
        with timer.phase("gather"):
            q_m = gather_correspondences(target, idx)
        with timer.phase("minimization"):
            if config.metric == "plane":
                inc = point_to_plane_transform(
                    p, q_m, gather_correspondences(target_normals, idx))
            else:
                inc = kabsch_transform(
                    p, q_m, solver=config.solver,
                    det_correction=config.det_correction
                    and not config.strict_reference)
        with timer.phase("transformation"):
            p = inc.apply(p)
        with timer.phase("error"):
            rmse(p, q_m)
    return timer


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str] = None):
    """A ``torch.profiler`` trace of the block (CPU, and CUDA where there is
    a card), written for TensorBoard into ``log_dir``; None traces
    nothing."""
    if log_dir is None:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
