"""Benchmark sweeps of the reference's performance studies.

Counterpart of ``fpcr_tpu/bench/sweeps.py``:

* :func:`time_complexity_sweep` — ICP iterations per cloud size over a
  width range (the reference's time-complexity harness: widths 3..128, one
  iteration, an ``N,ms`` CSV), point or plane;
* :func:`matching_benchmark` — the matcher microbenchmark at N = M, under
  the JAX package's variant names, so a CSV from either package reads the
  same: ``xla`` and ``xla_exact`` are the port's ``nn_argmin`` routes (the
  expansion and difference forms of the plain matcher on a CPU tensor),
  ``pallas``, ``pallas_highest`` and ``pallas_packed6`` kernel K1,
  ``pallas_packedidx`` kernel K2 and ``morton`` kernel K3 (their plain
  versions on a CPU tensor).

On the card a time is a pair of CUDA events (``utils/timing.py::
cuda_time_ms``), the minimum over the repeats after a warm-up; on the CPU
it is the host clock. Both return rows and write the reference-format CSVs
of ``utils/csvout.py`` when asked.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import torch

from ..data.synthetic import synthetic_scene
from ..models.icp import ICPConfig, run_icp
from ..utils.csvout import write_rows
from ..utils.device import resolve_device
from ..utils.timing import cuda_time_ms

# the reference's sweep bounds: WIDTH 3..128
DEFAULT_WIDTHS = tuple(range(3, 129))
# extra iterations of the slope's long leg
SLOPE_DELTA = 400
VARIANTS = ("xla", "xla_exact", "pallas_highest", "pallas_packed6",
            "pallas_packedidx", "morton")


def _time_ms(fn: Callable[[], object], repeats: int,
             device: torch.device) -> Tuple[float, float]:
    """``(min, max)`` ms of ``fn()`` over ``repeats`` runs after one
    warm-up: CUDA events on the card, the host clock on the CPU."""
    if device.type == "cuda":
        t = cuda_time_ms(fn, repeats=repeats, warmup=1)
        return t["min"], t["max"]
    fn()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return min(times), max(times)


def time_complexity_sweep(
    metric: str = "point",
    widths: Sequence[int] = DEFAULT_WIDTHS,
    iterations: int = 1,
    repeats: int = 3,
    matcher: str = "xla",
    csv_path: Optional[str] = None,
    slope: bool = False,
    device=None,
) -> List[Tuple[int, float, int]]:
    """Time ``iterations`` ICP iterations (the stop test off) at each
    width; returns ``[(n_points, ms_per_iter, below_noise_floor), ...]``,
    the minimum over the repeats. ``slope=True`` times ``iterations`` and
    ``iterations + 400`` iterations and reports the difference / 400 (the
    slope of ``utils.timing.slope_ms_per_iter``), which cancels the fixed
    costs of a call (set-up, the plane metric's normals); the flag is 1
    where the difference is below twice the two legs' spread over the
    repeats, so the row is an estimate within the noise, and such a row
    that comes out at or below zero reports the long leg's time a
    iteration, an upper bound. The clouds land on ``device`` (the card by
    default)."""
    device = torch.device(resolve_device(device))
    rows: List[Tuple[int, float, int]] = []
    for width in widths:
        scene = synthetic_scene(width=width, device=device)

        def timed(iters):
            config = ICPConfig(metric=metric, max_iterations=iters,
                               tolerance=0.0, matcher=matcher)
            best, worst = _time_ms(
                lambda: run_icp(scene.source, scene.target, config), repeats,
                device)
            return best, worst - best

        below_floor = 0
        if slope:
            lo, spread_lo = timed(iterations)
            hi, spread_hi = timed(iterations + SLOPE_DELTA)
            ms = (hi - lo) / SLOPE_DELTA
            if hi - lo < 2.0 * (spread_lo + spread_hi):
                below_floor = 1
            if ms <= 0.0:
                ms = hi / (iterations + SLOPE_DELTA)
        else:
            ms = timed(iterations)[0] / iterations
        rows.append((width * width, ms, below_floor))
    if csv_path:
        write_rows(csv_path, rows, header=("n", "ms", "below_noise_floor"))
    return rows


def matching_benchmark(
    n: int = 16384,
    repeats: int = 10,
    variants: Iterable[str] = VARIANTS,
    csv_path: Optional[str] = None,
    device=None,
) -> dict:
    """Minimum-of-``repeats`` matcher times (ms) at N = M = ``n`` (the
    synthetic scene of width ``isqrt(n)``) for each variant:
    ``{"n": N, variant: ms}``. Unknown variants raise before anything is
    timed."""
    from ..ops.matching import nn_argmin, nn_argmin_packed
    from ..ops.morton import (build_morton_table, morton_nn_band,
                              source_morton_order)

    variants = list(variants)
    device = torch.device(resolve_device(device))
    scene = synthetic_scene(width=int(math.isqrt(n)), device=device)
    p, q = scene.source.contiguous(), scene.target.contiguous()
    table = build_morton_table(q)
    p_sorted = p[source_morton_order(p, table).long()].contiguous()
    impls = {
        "xla": lambda: nn_argmin(p, q),
        "xla_exact": lambda: nn_argmin(p, q, exact=True),
        # 'pallas' stays the alias of the default mode (K1)
        "pallas": lambda: nn_argmin(p, q, exact=True),
        "pallas_highest": lambda: nn_argmin(p, q, exact=True),
        "pallas_packed6": lambda: nn_argmin(p, q, exact=True),
        "pallas_packedidx": lambda: nn_argmin_packed(p, q),
        "morton": lambda: morton_nn_band(p_sorted, table),
    }
    unknown = [v for v in variants if v not in impls]
    if unknown:
        raise ValueError(f"unknown matching variants {unknown}; "
                         f"valid: {sorted(impls)}")
    results = {"n": p.shape[0]}
    for name in variants:
        results[name] = _time_ms(impls[name], repeats, device)[0]
    if csv_path:
        write_rows(csv_path, [(v, results["n"], results[v])
                              for v in variants],
                   header=["variant", "n", "ms"])
    return results
