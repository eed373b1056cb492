"""The cell hall-plane-seq (point-to-plane ICP on the OS1-16 hall scan):
it loads from its files, its traffic draws its pool, a tiny CPU rehearsal
of it is ``correct``, its three metric readers read made-up runs and read
nothing from a program without what they read, and the control (the
reference in TF32) fails its limits at a tiny size."""

import json

import numpy as np
import pytest
import torch

from benchmark import program_spans, scenes, tracing, traffic
from benchmark import run as bench_run
from benchmark.control import as_row
from benchmark.reference import check, icp64
from benchmark.run import Run
from benchmark.spec import ROOT, load_cell, load_module
from benchmark.tests.conftest import TINY_GRID, _edit
from fpcr_tpu_torch.utils import timing

CELL = "hall-plane-seq"
METRICS = ["normals_ms", "eig3_roofline", "idle_normals_ms"]


def _json(kind, name):
    return json.loads((ROOT / "benchmark" / kind / f"{name}.json")
                      .read_text())


def test_the_cell_loads_and_differs_from_hall_point_seq_in_the_metric():
    cell = load_cell(CELL)
    point = load_cell("hall-point-seq")
    assert cell.chips == 1 and cell.per_layer == METRICS
    assert set(cell.end_to_end) == set(point.end_to_end)
    assert cell.config["scene"] == point.config["scene"]
    assert cell.config["icp"] == point.config["icp"]
    assert cell.config["reduced"] == []
    assert cell.traffic["metric"] == "plane"
    assert {k: v for k, v in cell.traffic.items()
            if k not in ("metric", "trace_calls")} == {
        k: v for k, v in point.traffic.items()
        if k not in ("metric", "trace_calls")}
    assert set(cell.limits) <= set(check.NAMES)
    readings = _json("limits", CELL)["readings"]
    for name, limit in cell.limits.items():
        lower, upper = readings[name]
        assert lower < limit < upper
    # what is read and not held: the control reads lower than the program
    for name in set(check.NAMES) - set(cell.limits) - {"iter_gap"}:
        lower, upper = readings[f"{name} (read, not held)"]
        assert upper <= lower


def test_its_traffic_draws_its_pool():
    cell = load_cell(CELL)
    tr = dict(cell.traffic, pool=4)
    cloud = scenes.make_cloud(cell.config["scene"])
    assert cloud.shape == (16384, 3)
    pool = traffic.make_pool(cloud, tr, "cpu")
    again = traffic.make_pool(cloud, tr, "cpu")
    assert pool.sources.shape == (4, 16384, 3) and len(pool) == 4
    assert torch.equal(pool.sources, again.sources)
    assert torch.equal(pool.target(3), again.target(3))
    assert not torch.equal(pool.target(0), pool.target(1))


@pytest.fixture
def tiny_plane(tiny_root):
    """``tiny_root`` with the cell cut to the CPU as the others are: the
    400-point noisy grid, 30 iterations at most, a pool of 4."""
    b = tiny_root / "benchmark"
    cfg = b / "configs" / "os1-16-hall-plane.json"
    icp = json.loads(cfg.read_text())["icp"]
    _edit(cfg, scene=TINY_GRID, icp=dict(icp, max_iterations=30))
    _edit(b / "traffic" / "scan-plane-seq.json", pool=4,
          translation={"kind": "ball", "radius": 0.1})
    return tiny_root


def test_rehearsal_is_correct(tiny_plane):
    out = bench_run.run_cell(load_cell(CELL, tiny_plane), 3_000_000_019,
                             0.5, False, "cpu")
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"reg_per_s", "latency_p50_ms",
                                   "latency_p95_ms", "setup_s"}


def _trace_run(record, entries, device, monkeypatch):
    trace = tracing.Trace(device, [("bench.entry", s, e)
                                   for s, e in entries], 0.0, 10_000.0)
    monkeypatch.setattr(program_spans, "_recorded", lambda: list(record))
    return Run(load_cell(CELL), 10.0, 1.0, [0.01] * len(entries),
               [[5]] * len(entries), {"normals": [4.0, 6.0]}, trace, None,
               {"batch": 1, "source_rows": 16384, "target_rows": 16384,
                "chunk": 512, "window": 64})


def _span(name, start_us, end_us, id_, parent=None, call=None, **attrs):
    ns = lambda us: int(us * 1000)  # noqa: E731
    return timing.Span(name, ns(start_us), ns(end_us), id_, parent, call,
                       attrs)


def _record():
    """Two calls, each after its prepass outside it: normals 0-100 us
    before the call (knn 0-60, eig3 60-100), the call 110-300."""
    out, i = [], 0
    for t in (1000.0, 2000.0):
        out += [_span("normals", t - 110, t - 10, i + 1, rows=16384, k=4,
                      tiles=64),
                _span("knn", t - 110, t - 50, i + 2, i + 1),
                _span("eig3", t - 50, t - 10, i + 3, i + 1),
                _span("call", t, t + 190, i + 4, None, i + 4,
                      entry="run_icp", syncs=2)]
        i += 4
    return out


def _read(name, run):
    return load_module(run.cell, "metrics", name).read(run)


def test_the_readers_read_made_up_runs(monkeypatch):
    # the device busy everywhere but 5 us in each knn, 3 in each eig3 and
    # 2 in each call; two eig3 kernels of 20 and 30 us
    gaps = [(t + d, t + d + w) for t in (1000.0, 2000.0)
            for d, w in ((-100.0, 5.0), (-40.0, 3.0), (50.0, 2.0))]
    edges = [0.0] + [x for g in gaps for x in g] + [10_000.0]
    device = [("kernel", edges[j], edges[j + 1])
              for j in range(0, len(edges), 2)]
    device += [("eig3_kernel", 930.0, 950.0), ("eig3_kernel", 1930.0,
                                               1960.0)]
    run = _trace_run(_record(), [(1000.0, 1190.0), (2000.0, 2190.0)],
                     device, monkeypatch)
    assert _read("normals_ms", run) == pytest.approx(5.0)
    assert _read("idle_normals_ms", run) == pytest.approx(8.0e-3)
    roof = load_module(run.cell, "metrics", "eig3_roofline")
    # 16,384 matrices of 84 bytes at 3.35 TB/s over the mean 25 us
    bound_us = 16384 * 84 / 3.35e12 * 1e6
    assert roof.bound_ms(16384) * 1e3 == pytest.approx(bound_us)
    assert _read("eig3_roofline", run) == pytest.approx(
        100.0 * bound_us / 25.0)


def test_the_readers_read_nothing_from_a_program_without_them(
        monkeypatch):
    """A parent without kernel eig3 or the spans knn and eig3 (its
    ``normals`` span only inside ``run_icp``) reads None, not 0."""
    rec = [s for s in _record() if s.name not in ("knn", "eig3")]
    run = _trace_run(rec, [(1000.0, 1190.0), (2000.0, 2190.0)],
                     [("kernel", 0.0, 10_000.0)], monkeypatch)
    assert _read("eig3_roofline", run) is None
    assert _read("idle_normals_ms", run) is None
    assert _read("idle_normals_ms", run._replace(trace=None)) is None
    assert _read("normals_ms", run._replace(spans_ms={})) is None


def test_control_fails_the_cells_limits():
    """The control, TF32 products in the reference's place, read against
    the float64 reference at a tiny size, fails the cell's own limits: the
    tiny grid set 12 m out, where the hall's walls are, since TF32's 10
    bits of a coordinate are what the control loses."""
    c = load_cell(CELL)
    icp = dict(c.config["icp"], max_iterations=30)
    tr = dict(c.traffic, request_seed=13, pool=2)
    cloud = scenes.make_cloud(TINY_GRID) + np.float32([12.0, -5.0, 2.0])
    pool = traffic.make_pool(cloud, tr, "cpu")
    for i in range(2):
        ref = icp64.register(pool.sources[i], pool.target(i), icp, "plane")
        ctl = icp64.register(pool.sources[i], pool.target(i), icp, "plane",
                             icp64.TF32)
        g = check.gaps(as_row(ctl, 30), ref, pool.sources[i])
        assert any(g[name] > limit for name, limit in c.limits.items()), g
