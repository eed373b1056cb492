"""``skipped_iter_share`` on made-up records: the share of the replayed
iterations whose kernels did not run, from the counts the program keeps on
each call's root span, and None where the calls carry none."""

import pytest

from benchmark import program_spans, tracing
from benchmark.run import Run
from benchmark.spec import load_cell, load_module
from fpcr_tpu_torch.utils import timing

CELL = load_cell("hall-point-seq")


def _call(i, start_us, **counts):
    """The root span of the ``i``-th call, 100 us long, with ``counts``."""
    ns = int(start_us * 1000)
    return timing.Span("call", ns, ns + 100_000, i, None, i,
                       dict(entry="run_icp", syncs=1, **counts))


def _run(calls, monkeypatch):
    monkeypatch.setattr(program_spans, "_recorded", lambda: list(calls))
    host = [("bench.entry", c.start_ns * 1e-3, c.end_ns * 1e-3)
            for c in calls]
    trace = tracing.Trace([("kernel", 0.0, 10_000.0)], host, 0.0, 10_000.0)
    return Run(CELL, 10.0, 1.0, [0.01] * len(calls), [[5]] * len(calls), {},
               trace, None, {})


def _read(run):
    return load_module(CELL, "metrics", "skipped_iter_share").read(run)


@pytest.mark.parametrize("counts, share", [
    ([(16, 3), (8, 3), (24, 0)], 100.0 * 6 / 48),
    ([(8, 0), (8, 0)], 0.0),
    ([(8, 7)], 87.5),
    # a call whose chunks all ran eagerly or whole carries no counts
    ([(16, 4), None], 25.0),
])
def test_share_from_known_counts(counts, share, monkeypatch):
    calls = [_call(i + 1, 1000.0 * (i + 1)) if c is None else
             _call(i + 1, 1000.0 * (i + 1), iterations_run=c[0],
                   iterations_skipped=c[1])
             for i, c in enumerate(counts)]
    assert _read(_run(calls, monkeypatch)) == pytest.approx(share)


def test_none_without_the_counts(monkeypatch):
    calls = [_call(1, 1000.0), _call(2, 2000.0)]  # a program without them
    run = _run(calls, monkeypatch)
    assert program_spans.read(run) is not None
    assert _read(run) is None
    assert _read(run._replace(trace=None)) is None
    monkeypatch.setattr(program_spans, "_recorded", lambda: None)
    assert _read(run) is None
