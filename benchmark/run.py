"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA GPU. The run:

1. set-up (``setup_s``, from the process's start to the first timed
   call): the interpreter starts, the program is imported and its kernels
   built or loaded (``fpcr_tpu_torch/_build/``), the configuration's cloud
   made, the pool
   of requests drawn from the seed on the card (``traffic.py``), and every
   request run twice by the cell's driver, which runs each shape's first
   loop eagerly and captures and replays the chunk graphs of the rest;
2. the window: one client calls the driver in a closed loop for
   ``--seconds`` seconds and to the end of that pass over the pool, each
   call on the next pool ids of the order drawn from the seed, timed by the
   host clock from the call to its result on the host.
   With ``--trace 1`` every call's stages are timed by CUDA events and one
   stretch of ``trace_calls`` calls, from ``trace_after`` of the window on,
   is traced by ``torch.profiler``;
3. the check: the device's peak memory is read, the program's graphs and
   buffers freed, and a seeded sample of the window's registrations is
   registered again by the float64 reference (``reference/``); each number
   compared is printed beside its limit;
4. the result: one JSON line on standard output, the cell's end-to-end
   metrics (``--trace 0``) or per-layer ones (``--trace 1``), each read by
   ``metrics/<name>.py``.

A run that finds no GPU, or fewer than the cell asks for, exits 2 and
prints no result; so does one whose process has loaded JAX or the JAX
package. Nothing is written but the program's kernel build and a Triton
cache directory inside the checkout.
"""

from __future__ import annotations

import time


def _process_age_s() -> float:
    """Seconds since this process started (Linux's ``/proc``, to a clock
    tick), so that ``setup_s`` counts the interpreter's start and the
    imports before this line; 0 where ``/proc`` is not there."""
    import os

    try:
        with open("/proc/self/stat") as f:
            started = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 0.0
    return max(0.0, uptime - started / os.sysconf("SC_CLK_TCK"))


T_START = time.perf_counter() - _process_age_s()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import NamedTuple, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# compared by the top-level name, whole: the port's name starts with the
# JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "fpcr_tpu")


class Run(NamedTuple):
    """What the metric readers read (``metrics/<name>.py::read(run)``)."""

    cell: object  # spec.Cell
    setup_s: float
    window_s: float
    latencies_s: list  # one a registration, in call order
    iterations: list  # a list a call: each registration's iterations
    spans_ms: dict  # span name -> ms a call (traced runs)
    trace: object  # tracing.Trace of the profiled stretch, or None
    memory_peak_bytes: Optional[int]
    shapes: dict  # batch, source_rows, target_rows, chunk, window


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def warm_up(driver, pool_size: int) -> dict:
    """Every call of a pass, twice: the first loop of a shape runs eagerly,
    the second captures its chunks, so that the window only replays.
    Returns each request's row of the second pass."""
    import numpy as np

    rows = {}
    for _ in range(2):
        for ids in np.arange(pool_size).reshape(-1, driver.per_call):
            rows.update(zip(ids.tolist(), driver(ids)))
    return rows


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float = T_START) -> dict:
    """Run ``cell`` once on ``device`` and return its result object."""
    import torch

    import fpcr_tpu_torch as ft
    from fpcr_tpu_torch.utils import graphs

    from benchmark import scenes, tracing
    from benchmark import traffic as traffic_mod
    from benchmark.reference import check
    from benchmark.spec import load_module

    cuda = torch.device(device).type == "cuda"
    tr = cell.traffic
    if trace and not cuda:
        raise RuntimeError("a traced run needs the GPU")
    pool = traffic_mod.make_pool(scenes.make_cloud(cell.config["scene"]), tr,
                                 device)
    config = ft.ICPConfig(metric=tr["metric"], **cell.config["icp"])
    spans = tracing.Spans(False)
    driver = load_module(cell, "drivers", tr["driver"]).make(
        ft, config, tr, pool, spans)
    per = driver.per_call
    warm_up(driver, len(pool))
    if cuda:
        torch.cuda.synchronize()
    if trace:
        tracing.warm_profiler()
        spans.enabled = True
    setup_s = time.perf_counter() - t_start

    order = traffic_mod.calls(tr, seed, per)
    rows, latencies, iterations = {}, [], []
    failed = 0

    def call():
        nonlocal failed
        ids = next(order)
        t0 = time.perf_counter()
        out = driver(ids)
        dt = time.perf_counter() - t0
        latencies.extend([dt] * len(ids))
        finite = torch.isfinite(out[:, :13]).all(dim=1)
        failed += int((~finite).sum())
        for i, row in zip(ids.tolist(), out):
            rows[i] = row
        iterations.append(torch.where(finite, out[:, 12], 0.0).int()
                          .tolist())

    def traced_calls():
        for _ in range(tr["trace_calls"]):
            call()

    # the window ends with the pass over the pool in which its seconds run
    # out, so that every run times whole passes: the same requests, in
    # another order
    per_pass = len(pool) // per
    stretch = None
    gc.collect()
    gc.freeze()
    start = time.perf_counter()
    trace_at = start + tr["trace_after"] * seconds
    now = start
    while now - start < seconds or len(iterations) % per_pass:
        if trace and stretch is None and now >= trace_at:
            stretch = tracing.profile_stretch(traced_calls) or False
        else:
            call()
        now = time.perf_counter()
    window_s = now - start
    gc.unfreeze()

    memory = None
    if cuda:
        torch.cuda.synchronize()
        memory = torch.cuda.max_memory_reserved()
    run = Run(cell, setup_s, window_s, latencies, iterations,
              spans.ms() if trace else {}, stretch or None, memory,
              {"batch": per, "source_rows": pool.sources.shape[1],
               "target_rows": pool.target(0).shape[-2],
               "chunk": config.morton_chunk, "window": config.morton_window})
    metrics = {}
    for name in (cell.per_layer if trace else cell.end_to_end):
        reader = load_module(cell, "metrics", name)
        value = reader.read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": reader.UNIT}

    del driver
    graphs.clear()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    sample = check.sample(rows, tr["check_requests"], seed)
    numbers = check.compare(cell, pool, rows, sample)
    checks = {name: {"value": numbers[name], "limit": limit}
              for name, limit in cell.limits.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())

    out = {"correct": bool(ok and failed == 0), "attempted": len(latencies),
           "failed": failed, "metrics": metrics,
           "device": _device(torch, device, memory, stretch)}
    if trace and stretch:
        out["breakdown"] = tracing.breakdown(stretch)
    out["checks"] = checks
    return out


def _device(torch, device, memory, stretch) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": None}
    from benchmark import tracing

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(),
           "count": 1, "memory_peak_bytes": memory}
    if stretch:
        out["busy_s"] = tracing.busy_us(stretch) * 1e-6
        out["window_s"] = (stretch.end_us - stretch.start_us) * 1e-6
    try:
        out["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        out["power_limit"] = None
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # a fixed cache inside the checkout, set before anything imports triton
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "benchmark" / ".triton_cache")
    import torch

    from benchmark.spec import load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("benchmark: no CUDA device; nothing measured", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} GPUs, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = run_cell(cell, args.seed % (1 << 64), args.seconds,
                      bool(args.trace), "cuda")
    found = forbidden_modules()
    if found:
        print(f"benchmark: the process loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
