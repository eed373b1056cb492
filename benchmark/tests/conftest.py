"""Fixtures of the benchmark's own tests: a tiny copy of the benchmark's
tree for CPU rehearsals, and the GPU check of the card tests."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# tiny stand-ins for the cells' clouds: noisy clouds of a few hundred
# points, so that no kNN or nearest-neighbour choice is a tie
TINY_GRID = {"kind": "surface_grid", "width": 20, "xy_range": [-2.0, 2.0]}
TINY_BAND = {"kind": "surface_grid", "width": 48, "xy_range": [-2.0, 2.0]}
# limits at the tiny sizes, where the noise-free grid meets float32's floor
# (~4e-7 m of RMSE) in one iteration: float32 against float64 reads under a
# tenth of these there (the cells' own limits are set at their own sizes)
TINY_LIMITS = {"pose_gap_m": 1e-5, "error_gap_m": 1e-5,
               "first_error_gap_m": 1e-5}


def _edit(path: Path, **changes) -> None:
    data = json.loads(path.read_text())
    data.update(changes)
    path.write_text(json.dumps(data))


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    """A copy of ``BENCHMARK.json`` and ``benchmark/`` whose configurations
    and traffic are cut to CPU sizes: the hall cells on a 400-point noisy
    grid with 30 iterations at most, the 1M grid at 2,304 points, pools of
    4 (batches of 2), and :data:`TINY_LIMITS`."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__",
                                                  ".triton_cache"))
    b = tmp_path / "benchmark"
    hall = b / "configs" / "os1-16-hall.json"
    icp = json.loads(hall.read_text())["icp"]
    _edit(hall, scene=TINY_GRID, icp=dict(icp, max_iterations=30))
    _edit(b / "configs" / "synthgrid-1m.json", scene=TINY_BAND)
    for name in ("scan-point-seq", "scan-point-batch32"):
        _edit(b / "traffic" / f"{name}.json", pool=4,
              translation={"kind": "ball", "radius": 0.1})
    _edit(b / "traffic" / "scan-point-batch32.json", batch=2,
          check_requests=4)
    _edit(b / "traffic" / "near-point-seq.json", pool=2, check_requests=2)
    for path in (b / "limits").glob("*.json"):
        _edit(path, limits=TINY_LIMITS)
    return tmp_path


@pytest.fixture
def cuda():
    """Skip where there is no GPU: decided here, when the test runs."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
