"""NDT ms/iter: the gather lookup against the banded one, the band by the
per-offset plain band (``lookup_impl='xla'``) and through kernel K4
(``'pallas'``; its plain version on the CPU).

Counterpart of ``scripts/bench_ndt.py``: the same saddle-like cloud
(z = x² - y² + noise, so voxel occupancy resembles a scan), a small GT
motion, the grid prebuilt (the one-time voxelization is the same for every
strategy and stays out of the timing), the full direct7 Gauss-Newton loop
slope-timed (``utils/timing.py::slope_ms_per_iter``, 4 and 128 / 64 / 32
iterations by size, min of 3, the stop test off). One JSON line per (n,
lookup, impl) with the device and its power limit; ``--csv PATH`` also
writes ``n,lookup,impl,ms_per_iter`` rows. The gather runs up to 262,144
points, as in the JAX script.

Run:  python -m fpcr_tpu_torch.bench.bench_ndt [sizes...] [--csv PATH]
      [--cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List

import numpy as np
import torch

import fpcr_tpu_torch as ft
from fpcr_tpu_torch.bench.card import card_fields
from fpcr_tpu_torch.models.ndt import NDTConfig, run_ndt
from fpcr_tpu_torch.utils.device import resolve_device
from fpcr_tpu_torch.utils.timing import slope_ms_per_iter

NEAR_GT = ((0.004, -0.002, 0.003), (0.002, -0.003, 0.002))
VOXEL = 0.12
STRATEGIES = (("gather", "auto"), ("banded", "xla"), ("banded", "pallas"))


def saddle_cloud(n: int, device) -> torch.Tensor:
    """The JAX script's cloud, drawn by the same numpy calls."""
    rng = np.random.default_rng(0)
    w = int(np.ceil(np.sqrt(n)))  # w*w >= n so the slice is exactly n rows
    ax = np.linspace(-2, 2, w, dtype=np.float32)
    xs, ys = np.meshgrid(ax, ax, indexing="ij")
    pts = np.stack([xs.ravel(), ys.ravel(), (xs * xs - ys * ys).ravel()], 1)
    pts = pts[:n] + rng.normal(0, 0.002, (n, 3)).astype(np.float32)
    return torch.as_tensor(np.asarray(pts, np.float32), device=device)


def long_leg(n: int) -> int:
    """The JAX script's long leg: wide enough to resolve a fast loop."""
    return 128 if n <= 65536 else (64 if n <= 262144 else 32)


def bench(n: int, lookup: str, impl: str, device, lo: int = 4,
          hi: int = None, repeats: int = 3, chunk: int = 512) -> dict:
    hi = hi or long_leg(n)
    src = saddle_cloud(n, device)
    gt = ft.gt_transform(*NEAR_GT, device=device)
    tgt = gt.apply(src)
    grid = ft.build_ndt_grid(tgt, VOXEL)
    last = {}

    def run(iters):
        cfg = NDTConfig(voxel_size=VOXEL, max_iterations=iters,
                        tolerance=0.0, lookup=lookup, lookup_chunk=chunk,
                        lookup_impl=impl)
        last["res"] = run_ndt(src, tgt, cfg, grid=grid)
        return last["res"]

    t = slope_ms_per_iter(run, k_lo=lo, k_hi=hi, repeats=repeats,
                          device=device)
    res = last["res"]
    return {"n": n, "lookup": lookup, "impl": impl,
            "ms_per_iter": t["ms_per_iter"], "lo_ms": t["lo_ms"],
            "hi_ms": t["hi_ms"], "k_lo": lo, "k_hi": hi, "repeats": repeats,
            "matched_fraction": float(res.matched_fraction),
            "err0": float(res.errors[0]),
            "gt_rmse": float(ft.transform_rmse(res.transform, gt, src)),
            **card_fields(device)}


def main(argv=None) -> List[dict]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("sizes", type=int, nargs="*",
                        default=[16384, 262144])
    parser.add_argument("--csv", default=None, metavar="PATH",
                        help="also write n,lookup,impl,ms_per_iter rows")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU, timed by the host clock")
    args = parser.parse_args(argv)
    device = torch.device(resolve_device("cpu" if args.cpu else None))
    if args.csv:
        with open(args.csv, "w") as fh:
            fh.write("n,lookup,impl,ms_per_iter\n")
    out = []
    for n in args.sizes:
        for lookup, impl in STRATEGIES:
            if lookup == "gather" and n > 262144:
                continue
            rec = bench(n, lookup, impl, device)
            print(json.dumps(rec), flush=True)
            out.append(rec)
            if args.csv:
                with open(args.csv, "a") as fh:
                    fh.write(f"{n},{lookup},{impl},{rec['ms_per_iter']:.3f}\n")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
