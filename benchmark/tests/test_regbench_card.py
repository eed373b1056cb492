"""On the GPU (skipped elsewhere): each cell runs ``correct`` at its own
size, its traced run reads every per-layer metric listed for it, and the
control (the reference in TF32 in the program's place) fails the cell's
limits while the program's own registrations pass them. Run on the card
with ``python -m pytest -q --confcutdir=benchmark/tests benchmark/tests``
(the root conftest, which imports JAX, is then not loaded)."""

import pytest

from benchmark import control
from benchmark import run as bench_run
from benchmark.spec import load_cell

CELLS = ["hall-point-seq", "grid1m-morton-seq", "hall-point-batch32"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_card(cuda, cell):
    c = load_cell(cell)
    out = bench_run.run_cell(c, 2_500_000_033, 2.0, False, cuda)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == set(c.end_to_end)
    traced = bench_run.run_cell(c, 2_500_000_034, 2.0, True, cuda)
    assert traced["correct"], traced["checks"]
    assert set(traced["metrics"]) == set(c.per_layer)
    for name, m in traced["metrics"].items():
        if name.endswith("_roofline"):
            assert 0 < m["value"] <= 100, (name, m)
    assert 0 < traced["device"]["busy_s"] <= traced["device"]["window_s"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(cuda, cell):
    c = load_cell(cell)
    line = control.readings(c, 2_500_000_035, True, cuda)
    assert all(line["program"][n] <= lim for n, lim in c.limits.items())
    assert any(line["control"][n] > lim for n, lim in c.limits.items())
