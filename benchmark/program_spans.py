"""The program's own spans of the traced stretch, on the profiler's clock.

The port records spans inside ``run_icp`` and ``register_batch``
(``fpcr_tpu_torch/utils/timing.py``) while a profiler session is active,
so the last calls it recorded are the stretch's: as many as the stretch
holds ``bench.entry`` host spans (a retaken session recorded calls before
them). A span outside any call, such as a Morton table its caller builds
before ``run_icp``, belongs to the next call the program recorded. The program's host clock is put on the profiler's by one offset,
the median over the stretch of (``bench.entry`` start − ``call`` start).

Each idle gap of the device (``tracing.idle_gaps``) is charged to the
innermost program span the host was in at the gap's midpoint, the rule by
which ``tracing.breakdown`` charges it to a bench span; a gap outside every
program span is charged to none.

Where the run has no trace, or the program records no spans (a version
without them), :func:`read` returns None, and so does every metric read
from it.
"""

from __future__ import annotations

import bisect
import statistics
from typing import Dict, NamedTuple, Optional

from benchmark import tracing

# the spans of the entry's set-up, and of the loop and its graphs
SETUP = ("prepare", "normals", "table", "source_order", "bind")
LOOP = ("chunk", "copy_in", "replay", "copy_out", "done_read", "result")


class Stretch(NamedTuple):
    calls: list  # the stretch's ``call`` spans, oldest first
    spans: list  # (span, start us, end us) of its calls, profiler clock
    idle_us: Dict[str, float]  # idle microseconds by program span name


def _recorded() -> Optional[list]:
    try:
        from fpcr_tpu_torch.utils import timing
    except ImportError:
        return None
    read = getattr(timing, "recorded_spans", None)
    return None if read is None else read()


def _charge(gaps, spans) -> Dict[str, float]:
    """Each gap's microseconds to the name of the shortest span of
    ``spans`` that holds its midpoint (start ≤ t < end)."""
    events = []  # (time, order, ...): at one time ends, starts, midpoints
    for i, (_, s, e) in enumerate(spans):
        events.append((s, 1, i))
        events.append((e, 0, i))
    for s, e in gaps:
        events.append((0.5 * (s + e), 2, e - s))
    events.sort(key=lambda ev: (ev[0], ev[1]))
    open_: set = set()
    out: Dict[str, float] = {}
    for t, kind, x in events:
        if kind == 1:
            open_.add(x)
        elif kind == 0:
            open_.discard(x)
        elif open_:
            i = min(open_, key=lambda j: spans[j][2] - spans[j][1])
            name = spans[i][0].name
            out[name] = out.get(name, 0.0) + x
    return out


def read(run) -> Optional[Stretch]:
    """The stretch's calls and spans, and its idle by program span; None
    without a trace, a record, or as many recorded calls as the stretch
    has."""
    tr = run.trace
    if tr is None:
        return None
    recorded = _recorded()
    if not recorded:
        return None
    entries = sorted(h[1] for h in tr.host if h[0] == "bench.entry")
    calls = sorted((s for s in recorded if s.name == "call"),
                   key=lambda s: s.start_ns)
    if not entries or len(calls) < len(entries):
        return None
    first = len(calls) - len(entries)
    ours = {c.id for c in calls[first:]}
    starts = [c.start_ns for c in calls]
    # a span outside any call goes with the next call recorded
    owner = {}
    for s in recorded:
        if s.call is None:
            i = bisect.bisect_left(starts, s.end_ns)
            owner[s.id] = calls[i].id if i < len(calls) else None
    mine = [s for s in recorded
            if (s.call if s.call is not None else owner.get(s.id)) in ours]
    offset = statistics.median(
        e - c.start_ns * 1e-3 for e, c in zip(entries, calls[first:]))
    spans = [(s, s.start_ns * 1e-3 + offset, s.end_ns * 1e-3 + offset)
             for s in mine]
    return Stretch(calls[first:], spans, _charge(tracing.idle_gaps(tr),
                                                 spans))


def idle_ms_per_call(run, names) -> Optional[float]:
    """The device's idle milliseconds a call while the host was in one of
    the spans ``names``."""
    st = read(run)
    if st is None:
        return None
    return sum(st.idle_us.get(n, 0.0) for n in names) * 1e-3 / len(st.calls)
