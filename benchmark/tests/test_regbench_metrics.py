"""The metrics' arithmetic on made-up runs: a rate over the whole window,
percentiles over all requests, the roofline counts from shapes."""

import numpy as np
import pytest

from benchmark import roofline, tracing
from benchmark.run import Run
from benchmark.spec import ROOT, Cell, load_cell, load_module

CELL = load_cell("hall-point-batch32")


def _read(name, run):
    return load_module(CELL, "metrics", name).read(run)


def _run(latencies, iterations, window_s=2.0, spans=None, trace=None,
         shapes=None, memory=None):
    return Run(CELL, 12.5, window_s, latencies, iterations, spans or {},
               trace, memory, shapes or {"batch": 1, "source_rows": 16384,
                                         "target_rows": 16384, "chunk": 512,
                                         "window": 64})


def test_rate_is_over_the_whole_window():
    run = _run([0.1] * 6 + [0.5] * 2, [[3]] * 8, window_s=4.0)
    assert _read("reg_per_s", run) == pytest.approx(2.0)
    assert _read("setup_s", run) == 12.5


def test_percentiles_over_every_request():
    lat = list(np.linspace(0.001, 0.100, 100))
    run = _run(lat, [[1]] * 100)
    assert _read("latency_p50_ms", run) == pytest.approx(50.5)
    assert _read("latency_p95_ms", run) == pytest.approx(95.05)
    # a batch's requests each count: 32 of 1 ms and 32 of 9 ms
    run = _run([0.001] * 32 + [0.009] * 32, [[1] * 32, [2] * 32])
    assert _read("latency_p95_ms", run) == pytest.approx(9.0)


def test_memory_and_counts():
    run = _run([0.01] * 4, [[10, 4], [6, 6]], memory=3 * 2 ** 30,
               spans={"entry": [5.0, 3.0], "normals": [2.0, 4.0]})
    assert _read("device_mem_peak_mib", run) == 3072
    assert _read("iterations_per_reg", run) == pytest.approx(6.5)
    # 26 element-iterations of 2 x (10 + 6) slots
    assert _read("batch_iter_waste", run) == pytest.approx(100 * (1 - 26 / 32))
    assert _read("loop_ms_per_iter", run) == pytest.approx(8.0 / 16)
    assert _read("normals_ms", run) == pytest.approx(3.0)
    assert _read("table_ms", run) is None
    assert _read("batch_iter_waste", _run([0.01], [[5]])) is None


def test_roofline_counts_from_shapes():
    assert roofline.brute_bound_ms(1, 16384, 16384) == pytest.approx(
        0.02404, abs=5e-5)
    assert roofline.band_rows(512, 64) == 768
    assert roofline.band_bound_ms(1, 1 << 20, 1 << 20, 512, 64) == \
        pytest.approx(0.07212, abs=5e-5)
    assert roofline.brute_bound_ms(32, 16384, 16384) == pytest.approx(
        32 * roofline.brute_bound_ms(1, 16384, 16384))


def _trace(device, start=0.0, end=100.0):
    """A stretch of ``start..end`` microseconds."""
    return tracing.Trace(device, [("bench.entry", 0.0, 60.0)], start, end)


def test_roofline_share_by_mean_kernel_time():
    # two calls; the second lost its finish event: the mean keeps the time
    ev = [("void nn_tc_sweep_kernel<0>", 0.0, 60.0),
          ("void nn_tc_finish_kernel<false, false>", 60.0, 80.0),
          ("void nn_tc_sweep_kernel<0>", 100.0, 160.0)]
    run = _run([0.01], [[1]], trace=_trace(ev))
    share = _read("k1_roofline", run)
    assert share == pytest.approx(100 * 0.02404 / 0.08, rel=2e-3)
    assert _read("k3_roofline", run) is None
    band = [("void morton_band_kernel<false, true, false>", 0.0, 200.0)]
    run = _run([0.01], [[1]], trace=_trace(band),
               shapes={"batch": 1, "source_rows": 1 << 20,
                       "target_rows": 1 << 20, "chunk": 512, "window": 64})
    assert _read("k3_roofline", run) == pytest.approx(100 * 0.07212 / 0.2,
                                                      rel=2e-3)


def test_idle_share_and_breakdown():
    ev = [("k_a", 10.0, 30.0), ("k_b", 20.0, 40.0), ("Memcpy DtoH", 70.0,
                                                     80.0)]
    run = _run([0.01], [[1]], trace=_trace(ev))
    # busy 10..40 and 70..80 of 0..100
    assert _read("device_idle_share", run) == pytest.approx(60.0)
    br = tracing.breakdown(run.trace)
    assert br["device_ops"][0] == ["k_a", pytest.approx(20e-6)]
    gaps = dict(br["idle_gaps"])
    # the gaps 0..10 and 40..70 fall to the span the host was in at their
    # middle, bench.entry (0..60); 80..100 to none
    assert gaps["bench.entry"] == pytest.approx(40e-6)
    assert gaps["bench.between_calls"] == pytest.approx(20e-6)
    assert _read("device_idle_share", _run([0.01], [[1]])) is None


def test_every_listed_metric_has_a_reader():
    import json

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        reader = load_module(CELL, "metrics", m["name"])
        assert reader.UNIT == m["unit"]
    assert isinstance(CELL, Cell)
