"""The port's headline number: point-to-point ICP ms/iter on the reference's
synthetic scene (16,384 points at the default width), against the reference
CUDA code's 6.4944 ms on an RTX 2060 (BASELINE.md).

The workload is the JAX package's ``bench.py::measure``: the synthetic
scene at its GT pose, ``tolerance=0`` so a run is exactly its iterations,
and ms/iter as the slope of the minimum times of two run lengths
(``utils/timing.py::slope_ms_per_iter``: CUDA events on the card, the host
clock with ``--cpu``, which the record's ``device`` says). The exact brute
matcher is ``matcher='xla'`` (kernel K1 on the card). The last line of
standard output is one JSON record::

    {"metric": "icp_point_to_point_ms_per_iter_n16384", "value": ...,
     "unit": "ms", "vs_baseline": value / 6.4944, "device": ...,
     "power_limit_w": ..., "matcher": "xla"}

A line on standard error before it holds the details: both legs, the same
slope through kernel K2 (``matcher='pallas', pallas_mode='packed6_idx'``)
and point-to-plane through K1 against the reference's 7.1085 ms.

Run:  python -m fpcr_tpu_torch.bench.headline [--cpu] [--width 128]
      [--lo 10] [--hi 60] [--repeats 5]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

import fpcr_tpu_torch as ft
from fpcr_tpu_torch.bench.card import card_fields
from fpcr_tpu_torch.utils.device import resolve_device
from fpcr_tpu_torch.utils.timing import slope_ms_per_iter

# the reference CUDA code on an RTX 2060 at N = 16,384 (BASELINE.md,
# GPU_ICP_point_to_point_TimeComp.csv / GPU_ICP_point_to_plane_TimeComp.csv)
BASELINE_MS_PER_ITER_16384 = 6.4944
BASELINE_PLANE_MS_PER_ITER_16384 = 7.1085


def slope(scene, lo: int, hi: int, repeats: int, device, **fields) -> dict:
    """ms/iter of ``run_icp`` on the scene with ``fields``, the stop test
    off; a slope at or below zero (noise of a tiny workload) reports the
    long leg's time an iteration, an upper bound."""
    last = {}

    def run(iters):
        cfg = ft.ICPConfig(max_iterations=iters, tolerance=0.0, **fields)
        last["res"] = ft.run_icp(scene.source, scene.target, cfg)
        return last["res"]

    t = slope_ms_per_iter(run, k_lo=lo, k_hi=hi, repeats=repeats,
                          device=device)
    ms = t["ms_per_iter"]
    if ms <= 0:
        ms = t["hi_ms"] / hi
    return {"ms_per_iter": ms, "lo_ms": t["lo_ms"], "hi_ms": t["hi_ms"],
            "final_error": float(last["res"].errors[hi - 1]),
            "gt_rmse": float(ft.transform_rmse(
                last["res"].transform, scene.ground_truth, scene.source))}


def measure(width: int = 128, lo: int = 10, hi: int = 60, repeats: int = 5,
            device=None) -> tuple:
    """``(record, details)``: the headline record and the details line."""
    device = torch.device(resolve_device(device))
    scene = ft.synthetic_scene(width=width, device=device)
    n = width * width
    card = card_fields(device)
    point = slope(scene, lo, hi, repeats, device, matcher="xla")
    packed = slope(scene, lo, hi, repeats, device, matcher="pallas",
                   pallas_mode="packed6_idx")
    plane = slope(scene, lo, hi, repeats, device, metric="plane",
                  matcher="xla")
    details = {
        "n_points": n, "lo_iters": lo, "hi_iters": hi, "repeats": repeats,
        "point_k1": point,
        "point_k2": dict(packed, vs_baseline=packed["ms_per_iter"]
                         / BASELINE_MS_PER_ITER_16384),
        "plane_k1": dict(plane, vs_baseline=plane["ms_per_iter"]
                         / BASELINE_PLANE_MS_PER_ITER_16384),
        "baseline": {"point_ms_per_iter": BASELINE_MS_PER_ITER_16384,
                     "plane_ms_per_iter": BASELINE_PLANE_MS_PER_ITER_16384,
                     "hardware": "RTX 2060", "n_points": 16384,
                     "source": "BASELINE.md"},
        **card}
    record = {"metric": f"icp_point_to_point_ms_per_iter_n{n}",
              "value": point["ms_per_iter"], "unit": "ms",
              "vs_baseline": point["ms_per_iter"]
              / BASELINE_MS_PER_ITER_16384,
              **card, "matcher": "xla"}
    return record, details


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU, timed by the host clock")
    parser.add_argument("--width", type=int, default=128)
    parser.add_argument("--lo", type=int, default=10)
    parser.add_argument("--hi", type=int, default=60)
    parser.add_argument("--repeats", type=int, default=5)
    args = parser.parse_args(argv)
    if args.width < 2 or args.repeats < 1 or args.hi <= args.lo:
        parser.error("need width>=2, repeats>=1, hi>lo")
    record, details = measure(args.width, args.lo, args.hi, args.repeats,
                              "cpu" if args.cpu else None)
    print(json.dumps(details), file=sys.stderr, flush=True)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main(sys.argv[1:])
