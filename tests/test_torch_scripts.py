"""The port's scripts (``fpcr_tpu_torch/bench/``) run small on the CPU:
the headline bench's JSON record, ``bench_large`` and ``bench_ndt`` (its
CSV) at one small size, the two-process gloo dry run to GT recovery, and
the sharded large-N smoke's parity and falling error; without ``--cpu``
and without a card, each raises."""

import csv
import json
import os
import subprocess
import sys

import pytest
import torch

from fpcr_tpu_torch.bench import (bench_large, bench_ndt, fuzz_configs,
                                  guards, headline, sharded_large)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(*args, timeout=300):
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "2"}
    return subprocess.run([sys.executable, "-m", *args], capture_output=True,
                          text=True, timeout=timeout, env=env, cwd=ROOT)


def test_headline_record():
    proc = _run("fpcr_tpu_torch.bench.headline", "--cpu", "--width", "16",
                "--lo", "2", "--hi", "4")
    assert proc.returncode == 0, proc.stderr
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline", "device",
                        "power_limit_w", "matcher"}
    assert rec["metric"] == "icp_point_to_point_ms_per_iter_n256"
    assert rec["unit"] == "ms" and rec["matcher"] == "xla"
    assert rec["value"] > 0
    assert rec["vs_baseline"] == pytest.approx(rec["value"] / 6.4944)
    assert rec["device"] == "cpu (host clock)"
    assert rec["power_limit_w"] is None
    details = json.loads(proc.stderr.strip().splitlines()[-1])
    assert details["point_k1"]["ms_per_iter"] == rec["value"]
    for key, base in (("point_k2", 6.4944), ("plane_k1", 7.1085)):
        d = details[key]
        assert d["ms_per_iter"] > 0
        assert d["vs_baseline"] == pytest.approx(d["ms_per_iter"] / base)


@pytest.mark.parametrize("row", bench_large.select("all", [16384]),
                         ids=lambda r: r.matcher)
def test_bench_large_small_rows(row):
    rec = bench_large.bench_row(row, torch.device("cpu"), lo=2, hi=4,
                                repeats=1)
    assert (rec["n"], rec["matcher"]) == (16384, row.matcher)
    assert rec["ms_per_iter"] == pytest.approx(
        (rec["hi_ms"] - rec["lo_ms"]) / 2)
    assert rec["gt_rmse"] < 1e-4
    assert rec["device"] == "cpu (host clock)"


def test_bench_large_main_prints_its_records(monkeypatch, capsys):
    """``main`` runs the selected rows on the device it names, at the
    script's legs, and prints each record as one JSON line."""
    calls = []

    def fake_row(row, device):
        calls.append((row.n, row.matcher, device.type))
        return {"n": row.n, "matcher": row.matcher}

    monkeypatch.setattr(bench_large, "bench_row", fake_row)
    recs = bench_large.main(["all", "--sizes", "16384", "--cpu"])
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert printed == recs
    assert calls == [(16384, "morton", "cpu"), (16384, "grid", "cpu")]
    monkeypatch.undo()
    assert bench_large.bench_row.__defaults__[:3] == (5, 25, 3)


def test_bench_large_rows_are_the_scripts():
    rows = [(r.n, r.matcher, r.chunk, r.window)
            for r in bench_large.select("all")]
    assert rows == [(16384, "morton", 256, 512), (262144, "morton", 512, 64),
                    (1048576, "morton", 512, 64),
                    (1048576, "morton", 512, 128),
                    (1048576, "morton", 256, 256),
                    (16384, "grid", 256, 512), (262144, "grid", 256, 512)]
    assert [r.n for r in bench_large.select("morton", [262144])] == [262144]


def test_bench_ndt_csv(tmp_path):
    path = tmp_path / "ndt.csv"
    recs = bench_ndt.main(["4096", "--cpu", "--csv", str(path)])
    with open(path) as fh:
        rows = list(csv.reader(fh))
    assert rows[0] == ["n", "lookup", "impl", "ms_per_iter"]
    assert [tuple(r[:3]) for r in rows[1:]] == [
        ("4096", "gather", "auto"), ("4096", "banded", "xla"),
        ("4096", "banded", "pallas")]
    for r, rec in zip(rows[1:], recs):
        assert float(r[3]) == pytest.approx(rec["ms_per_iter"], abs=1e-3)
        assert rec["err0"] == pytest.approx(recs[0]["err0"], rel=1e-5)


def test_multihost_dryrun():
    proc = _run("fpcr_tpu_torch.bench.multihost_dryrun")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("MULTIHOST OK") == 2
    assert "local rows [0:256)" in proc.stdout
    assert "local rows [256:512)" in proc.stdout
    assert "[parent] multihost dryrun PASSED" in proc.stdout


def test_sharded_large_cpu():
    proc = _run("fpcr_tpu_torch.bench.sharded_large", "--cpu", "--n", "65536",
                "--iters", "2")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("sharded large smoke PASSED") == 4
    assert "stage2 65,536 pts sharded x4" in proc.stdout


@pytest.mark.parametrize("module,argv", [
    (headline, []), (bench_large, ["morton", "--sizes", "16384"]),
    (bench_ndt, ["4096"]), (fuzz_configs, ["0"]), (guards, []),
    (sharded_large, [])])
def test_scripts_need_a_card_without_cpu(monkeypatch, module, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        module.main(argv)
