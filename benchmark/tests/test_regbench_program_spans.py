"""The readers of the program's spans (``benchmark/program_spans.py``) on
made-up records and traces: the program's clock put on the profiler's by
``bench.entry``, each idle gap charged to the innermost span at its
midpoint, a table built before a call counted on it, a retaken session's
calls dropped."""

import pytest

from benchmark import program_spans, tracing
from benchmark.run import Run
from benchmark.spec import load_cell, load_module
from fpcr_tpu_torch.utils import timing

CELL = load_cell("grid1m-morton-seq")
# the program's clock runs 7 s ahead of the profiler's, in nanoseconds
AHEAD_NS = 7_000_000_000


class _Record:
    """Spans laid out in microseconds of the profiler's clock."""

    def __init__(self) -> None:
        self.spans = []
        self._id = 0

    def add(self, name, start_us, end_us, parent=None, call=None, **attrs):
        self._id += 1
        ns = lambda us: int(us * 1000) + AHEAD_NS  # noqa: E731
        span = timing.Span(name, ns(start_us), ns(end_us), self._id,
                           parent.id if parent else None,
                           self._id if name == "call" else
                           (call.id if call else None), attrs)
        self.spans.append(span)
        return span

    def call(self, start_us, chunks, table_before=False, syncs=None):
        """A morton call at ``start_us``: prepare 0-20, bind 20-30, then
        chunks of 40 us (copy_in 5, replay 5, copy_out 5) and done reads of
        10 us, result 10 us; a table span of 10 us just before it, outside
        any call, if asked."""
        if table_before:
            self.add("table", start_us - 12, start_us - 2)
        end = start_us + 30 + 50 * chunks + 10
        root = self.add("call", start_us, end, entry="run_icp",
                        syncs=chunks - 1 if syncs is None else syncs)
        prep = self.add("prepare", start_us, start_us + 20, root, root)
        self.add("source_order", start_us + 10, start_us + 20, prep, root)
        self.add("bind", start_us + 20, start_us + 30, root, root,
                 route="graphs")
        t = start_us + 30
        for i in range(chunks):
            if i:
                self.add("done_read", t, t + 10, root, root)
                t += 10
            chunk = self.add("chunk", t, t + 40, root, root, k=8,
                             route="replay")
            for j, part in enumerate(("copy_in", "replay", "copy_out")):
                self.add(part, t + 5 * j, t + 5 * j + 5, chunk, root)
            t += 40
        self.add("result", t, t + 10, root, root)
        return root


def _run(record, entries, gaps, monkeypatch, stretch=(0.0, 10_000.0)):
    """A traced run whose stretch holds the ``bench.entry`` host spans
    ``entries`` and device work everywhere but ``gaps``."""
    lo, hi = stretch
    edges = [lo] + [x for g in sorted(gaps) for x in g] + [hi]
    device = [("kernel", edges[i], edges[i + 1])
              for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    host = [("bench.entry", s, e) for s, e in entries]
    trace = tracing.Trace(device, host, lo, hi)
    monkeypatch.setattr(program_spans, "_recorded",
                        lambda: list(record.spans))
    return Run(CELL, 10.0, 1.0, [0.01] * len(entries),
               [[5]] * len(entries), {}, trace, None, {})


def _read(name, run):
    return load_module(CELL, "metrics", name).read(run)


def test_aligned_by_entry_and_charged_to_the_innermost_span(monkeypatch):
    rec = _Record()
    rec.call(1000.0, chunks=2)
    entries = [(1000.0, 1150.0)]
    gaps = [(1012.0, 1016.0),  # source_order, inside prepare
            (1022.0, 1026.0),  # bind
            (1036.0, 1038.0),  # the first chunk's replay, inside chunk
            (1071.0, 1079.0),  # the done read
            (1002.0, 1004.0),  # prepare alone
            (1122.0, 1124.0),  # result
            (1131.0, 1133.0)]  # the call itself: neither
    run = _run(rec, entries, gaps, monkeypatch)
    st = program_spans.read(run)
    assert st.idle_us == pytest.approx({
        "source_order": 4.0, "bind": 4.0, "replay": 2.0, "done_read": 8.0,
        "prepare": 2.0, "result": 2.0, "call": 2.0})
    assert _read("idle_setup_ms", run) == pytest.approx(10.0e-3)
    assert _read("idle_loop_ms", run) == pytest.approx(12.0e-3)
    assert _read("host_syncs_per_call", run) == 1.0
    assert _read("chunk_issue_us", run) == pytest.approx(40.0)


def test_the_offset_is_the_median_over_the_calls(monkeypatch):
    rec = _Record()
    for start in (1000.0, 2000.0, 3000.0):
        rec.call(start, chunks=1)
    # one entry seen 50 us late: the median keeps the others' offset
    entries = [(1000.0, 1100.0), (2050.0, 2100.0), (3000.0, 3100.0)]
    # 2 us of idle in each call's bind (20-30 us into it), which an
    # offset off by 50 us would put in the chunk or the call
    gaps = [(1021.0, 1023.0), (2021.0, 2023.0), (3021.0, 3023.0)]
    run = _run(rec, entries, gaps, monkeypatch)
    assert program_spans.read(run).idle_us == pytest.approx({"bind": 6.0})


def test_a_table_before_the_call_counts_on_it(monkeypatch):
    rec = _Record()
    rec.call(1000.0, chunks=1, table_before=True)
    rec.call(2000.0, chunks=1, table_before=True)
    entries = [(1000.0, 1100.0), (2000.0, 2100.0)]
    gaps = [(990.0, 996.0), (1990.0, 1994.0)]  # inside each table span
    run = _run(rec, entries, gaps, monkeypatch)
    st = program_spans.read(run)
    assert st.idle_us == pytest.approx({"table": 10.0})
    assert _read("idle_setup_ms", run) == pytest.approx(5.0e-3)
    assert _read("idle_loop_ms", run) == 0.0


def test_a_retaken_sessions_calls_are_dropped(monkeypatch):
    rec = _Record()
    # two calls of a session that was retaken, then the stretch's two
    rec.call(-5000.0, chunks=4, table_before=True, syncs=9)
    rec.call(-4000.0, chunks=4, table_before=True, syncs=9)
    rec.call(1000.0, chunks=1, table_before=True)
    rec.call(2000.0, chunks=3, table_before=True)
    entries = [(1000.0, 1100.0), (2000.0, 2200.0)]
    run = _run(rec, entries, [(2071.0, 2079.0)], monkeypatch)
    st = program_spans.read(run)
    assert [c.attrs["syncs"] for c in st.calls] == [0, 2]
    assert {s.name for s, _, _ in st.spans if s.call is None} == {"table"}
    assert len([1 for s, _, _ in st.spans if s.name == "table"]) == 2
    assert _read("host_syncs_per_call", run) == pytest.approx(1.0)
    assert _read("idle_loop_ms", run) == pytest.approx(4.0e-3)


@pytest.mark.parametrize("name", ["host_syncs_per_call", "idle_setup_ms",
                                  "idle_loop_ms", "chunk_issue_us"])
def test_none_without_a_trace_or_a_record(name, monkeypatch):
    rec = _Record()
    rec.call(1000.0, chunks=2)
    run = _run(rec, [(1000.0, 1150.0)], [(1036.0, 1038.0)], monkeypatch)
    assert _read(name, run) is not None
    assert _read(name, run._replace(trace=None)) is None
    # a program that records nothing, or keeps no record at all
    monkeypatch.setattr(program_spans, "_recorded", lambda: [])
    assert _read(name, run) is None
    monkeypatch.setattr(program_spans, "_recorded", lambda: None)
    assert _read(name, run) is None
    # fewer calls recorded than the stretch has
    monkeypatch.setattr(program_spans, "_recorded", lambda: rec.spans)
    two = run.trace._replace(host=run.trace.host + [("bench.entry", 5.0,
                                                     9.0)])
    assert _read(name, run._replace(trace=two)) is None


def test_a_program_without_spans_reads_none(monkeypatch):
    monkeypatch.delattr(timing, "recorded_spans")
    assert program_spans._recorded() is None
