"""Timing on the card with CUDA events.

* :func:`cuda_time_ms` — min/mean/max of a call over ``repeats`` runs, each
  timed by a pair of CUDA events (min-of-k is the headline, the reference's
  min-of-10 policy);
* :func:`slope_ms_per_iter` — per-iteration milliseconds of a loop by the
  slope method that ``bench.py`` uses: ``(T(k_hi) - T(k_lo)) / (k_hi -
  k_lo)``, each leg the minimum over ``repeats``, so fixed per-call costs
  (allocation, set-up, the final copy) cancel.

Events measure the device timeline between two points of the stream, which
includes any time the device waits on the host. There is no CPU fallback: a
timing that finds no CUDA device raises.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA-event timing needs a CUDA device")


def _event_ms(fn: Callable[[], object]) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def cuda_time_ms(fn: Callable[[], object], repeats: int = 10,
                 warmup: int = 1) -> Dict[str, float]:
    """Time ``fn()`` on the current stream: ``{"min", "mean", "max"}`` in
    milliseconds over ``repeats`` runs, after ``warmup`` untimed runs."""
    _require_cuda()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = [_event_ms(fn) for _ in range(repeats)]
    return {"min": min(times), "mean": sum(times) / len(times),
            "max": max(times), "repeats": repeats}


def slope_ms_per_iter(run: Callable[[int], object], k_lo: int = 10,
                      k_hi: int = 60, repeats: int = 5) -> Dict[str, float]:
    """Per-iteration ms of ``run(k)``, a loop of exactly ``k`` iterations,
    by the slope of the minimum times of the two legs."""
    if k_hi <= k_lo:
        raise ValueError("need k_hi > k_lo")
    _require_cuda()
    run(k_lo)  # warm both legs: first-call costs stay out of the timing
    run(k_hi)
    torch.cuda.synchronize()
    lo = min(_event_ms(lambda: run(k_lo)) for _ in range(repeats))
    hi = min(_event_ms(lambda: run(k_hi)) for _ in range(repeats))
    return {"ms_per_iter": (hi - lo) / (k_hi - k_lo), "lo_ms": lo,
            "hi_ms": hi, "k_lo": k_lo, "k_hi": k_hi, "repeats": repeats}
