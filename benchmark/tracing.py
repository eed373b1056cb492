"""The traced run's readings: CUDA-event spans and a profiled stretch.

:class:`Spans` times named stages of every call of the window by pairs of
CUDA events on the current stream (read once the window has closed, so
recording them makes the host wait for nothing) and marks each stage for
the profiler with ``record_function('bench.<name>')``, so that an idle gap
of the device can be put down to the stage the host was in. Off, it does
nothing.

:func:`profile_stretch` traces a stretch of consecutive calls of the window
under ``torch.profiler``, between two ``torch.cuda._sleep`` spin kernels
that mark its ends on the device and are left out of the result. Sessions
now and then lose events at their edges or report none at all: a session
that saw no device event of the stretch is retaken on the next calls, up
to five times (as the port's card smoke test does). The stretch is the
interval from the end of the first spin kernel to the start of the last.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

PAD_CYCLES = 100_000  # ~50 us of spin at the H100's clock
RETAKES = 5
NAME_CHARS = 100  # kernel names in the breakdown are cut to this length


class Spans:
    def __init__(self, enabled: bool) -> None:
        self.enabled = enabled
        self._events: Dict[str, List[Tuple[object, object]]] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.enabled:
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.profiler.record_function(f"bench.{name}"):
            start.record()
            try:
                yield
            finally:
                end.record()
        self._events.setdefault(name, []).append((start, end))

    def ms(self) -> Dict[str, List[float]]:
        """Each span's milliseconds, in call order (synchronises)."""
        torch.cuda.synchronize()
        return {name: [s.elapsed_time(e) for s, e in pairs]
                for name, pairs in self._events.items()}


class Trace(NamedTuple):
    device: List[Tuple[str, float, float]]  # (name, start us, end us)
    host: List[Tuple[str, float, float]]  # the bench.* spans
    start_us: float  # the stretch
    end_us: float


def _session(run_calls: Callable[[], None]):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(PAD_CYCLES)
        run_calls()
        torch.cuda._sleep(PAD_CYCLES)
        torch.cuda.synchronize()
    device, host, spins = [], [], []
    for e in prof.events():
        rng = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.name.startswith("bench."):
            # a span's device-side twin (a user annotation) is no work
            if e.device_type != DeviceType.CUDA:
                host.append(rng)
        elif e.device_type == DeviceType.CUDA:
            (spins if "spin_kernel" in e.name else device).append(rng)
    return device, host, sorted(spins, key=lambda r: r[1])


def warm_profiler() -> None:
    """One empty session, so that the profiler's start-up falls in
    set-up."""
    _session(lambda: None)


def profile_stretch(run_calls: Callable[[], None]) -> Optional[Trace]:
    """Trace ``run_calls()``, which runs calls of the window, between spin
    kernels; None if every session came back empty."""
    for _ in range(RETAKES):
        device, host, spins = _session(run_calls)
        if not device:
            continue
        if len(spins) >= 2:
            start, end = spins[0][2], spins[-1][1]
        else:
            start = min(d[1] for d in device)
            end = max(d[2] for d in device)
        device = [d for d in device if d[2] > start and d[1] < end]
        return Trace(device, host, start, end)
    return None


def union(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The union of ``intervals`` (``(name, start, end)``) clipped to
    ``[lo, hi]``, as sorted disjoint ``(start, end)`` pairs."""
    out: List[List[float]] = []
    for _, s, e in sorted(intervals, key=lambda r: r[1]):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_us(trace: Trace) -> float:
    return sum(e - s for s, e in union(trace.device, trace.start_us,
                                       trace.end_us))


def idle_gaps(trace: Trace) -> List[Tuple[float, float]]:
    busy = union(trace.device, trace.start_us, trace.end_us)
    edges = [trace.start_us] + [x for se in busy for x in se] + [trace.end_us]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def _host_stage(trace: Trace, t: float) -> str:
    """The innermost bench span the host was in at ``t``."""
    inside = [h for h in trace.host if h[1] <= t < h[2]]
    if not inside:
        return "bench.between_calls"
    return min(inside, key=lambda h: h[2] - h[1])[0]


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps'
    seconds by the host's stage, each in seconds, the largest first."""
    ops: Dict[str, float] = {}
    for name, s, e in trace.device:
        key = name[:NAME_CHARS]
        ops[key] = ops.get(key, 0.0) + (e - s) * 1e-6
    gaps: Dict[str, float] = {}
    for s, e in idle_gaps(trace):
        stage = _host_stage(trace, 0.5 * (s + e))
        gaps[stage] = gaps.get(stage, 0.0) + (e - s) * 1e-6
    rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa
    return {"device_ops": [[k, v] for k, v in rank(ops)],
            "idle_gaps": [[k, v] for k, v in rank(gaps)]}
