"""A run rehearsed on the CPU at tiny sizes (``tiny_root``): both drivers
end ``correct``, each fault that a cell can have planted under the timed
path ends not ``correct``, a new cell, traffic mix, driver and metric are
found by adding files alone, and a run without a GPU prints no result."""

import hashlib
import json
import shutil
import subprocess
import sys

import pytest
import torch

import fpcr_tpu_torch as ft
from benchmark import run as bench_run
from benchmark.spec import ROOT, load_cell

SECONDS = 0.5


def _run(root, cell, seed=3_000_000_017):
    return bench_run.run_cell(load_cell(cell, root), seed, SECONDS, False,
                              "cpu")


@pytest.mark.parametrize("cell", ["hall-point-seq", "hall-point-batch32",
                                  "grid1m-morton-seq"])
def test_rehearsal_is_correct(tiny_root, cell):
    out = _run(tiny_root, cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"reg_per_s", "latency_p50_ms",
                                   "latency_p95_ms", "setup_s"}
    assert list(out)[-1] == "checks"


def _identity_like(t):
    eye = torch.eye(3, dtype=t.rotation.dtype).expand_as(t.rotation)
    return t._replace(rotation=eye.clone(),
                      translation=torch.zeros_like(t.translation))


def _unchanged_state(real):
    """Every step hands back the state it got: the pose never moves."""
    def fake(*a, **kw):
        res = real(*a, **kw)
        return res._replace(transform=_identity_like(res.transform))
    return fake


def _answer_altered(real):
    def fake(*a, **kw):
        res = real(*a, **kw)
        t = res.transform
        return res._replace(transform=t._replace(
            translation=t.translation + 1e-3))
    return fake


def _half_batch_left_out(real):
    """Only the batch's first half registered; the rest come back with the
    pose they were sent with."""
    def fake(sources, targets, config, *a, **kw):
        h = sources.shape[0] // 2
        res = real(sources[:h], targets[:h], config, *a, **kw)
        rest = _identity_like(type(res.transform)(
            res.transform.rotation[:1].expand(sources.shape[0] - h, 3, 3),
            res.transform.translation[:1].expand(sources.shape[0] - h, 3)))
        t = res.transform
        return res._replace(
            transform=t._replace(
                rotation=torch.cat([t.rotation, rest.rotation]),
                translation=torch.cat([t.translation, rest.translation])),
            num_iterations=torch.cat([res.num_iterations,
                                      res.num_iterations[:1].expand(
                                          sources.shape[0] - h)]),
            errors=torch.cat([res.errors, res.errors[:1].expand(
                sources.shape[0] - h, -1)]))
    return fake


@pytest.mark.parametrize("cell,entry,fault", [
    ("hall-point-seq", "run_icp", _unchanged_state),
    ("hall-point-seq", "run_icp", _answer_altered),
    ("grid1m-morton-seq", "run_icp", _answer_altered),
    ("hall-point-batch32", "register_batch", _half_batch_left_out),
    ("hall-point-batch32", "register_batch", _answer_altered),
])
def test_fault_is_not_correct(tiny_root, monkeypatch, cell, entry, fault):
    monkeypatch.setattr(ft, entry, fault(getattr(ft, entry)))
    out = _run(tiny_root, cell)
    assert not out["correct"], out["checks"]


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "benchmark").rglob("*") if p.is_file()}


def test_new_parts_found_by_name(tiny_root):
    """A cell, a traffic mix, a driver and a metric added as new files and
    new entries of BENCHMARK.json: no file that was there changes."""
    before = _digest(tiny_root)
    b = tiny_root / "benchmark"
    shutil.copy(b / "traffic" / "scan-point-seq.json",
                b / "traffic" / "scan-point-twice.json")
    tr = json.loads((b / "traffic" / "scan-point-twice.json").read_text())
    (b / "traffic" / "scan-point-twice.json").write_text(
        json.dumps(dict(tr, driver="twice")))
    (b / "drivers" / "twice.py").write_text(
        "from benchmark.drivers import sequential\n\n\n"
        "def make(ft, config, traffic, pool, spans):\n"
        "    inner = sequential.make(ft, config, traffic, pool, spans)\n\n"
        "    def call(ids):\n"
        "        inner(ids)\n"
        "        return inner(ids)\n"
        "    call.per_call = 1\n"
        "    return call\n")
    (b / "metrics" / "calls_made.py").write_text(
        "UNIT = 'calls'\n\n\ndef read(run):\n"
        "    return float(len(run.iterations))\n")
    shutil.copy(b / "limits" / "hall-point-seq.json",
                b / "limits" / "hall-point-twice.json")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "hall-point-twice",
                               "config": "os1-16-hall",
                               "traffic": "scan-point-twice", "chips": 1,
                               "why": "a test cell"})
    bench["end_to_end"].append({"name": "calls_made", "unit": "calls",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["hall-point-twice"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = _run(tiny_root, "hall-point-twice")
    assert out["correct"]
    assert out["metrics"]["calls_made"]["value"] == out["attempted"]
    after = _digest(tiny_root)
    assert all(after[p] == h for p, h in before.items())
    assert "calls_made" not in _run(tiny_root, "hall-point-seq")["metrics"]


def test_no_gpu_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "hall-point-seq", "--seed", "2147483659", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_setup_clock_starts_with_the_process():
    """``setup_s`` counts from the process's start: a child that sleeps
    before it imports the harness reads that sleep in its start."""
    code = ("import time; time.sleep(0.6); t = time.perf_counter(); "
            "import benchmark.run as r; print(t - r.T_START)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert 0.6 <= float(out.stdout) < 30.0
