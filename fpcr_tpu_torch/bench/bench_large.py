"""Large-N scaling benchmark: ICP ms/iter of the Morton band matcher (kernel
K3 on the card) and the voxel-hash grid matcher at up to 1,048,576 points.

Counterpart of ``scripts/bench_large.py``, with its sizes and geometries:
Morton at 16,384 (chunk 256 / window 512), 262,144 (chunk 512 / window 64)
and 1,048,576 (c512/w64, c512/w128, c256/w256); grid at 16,384 and
262,144. Each row is slope-timed (``utils/timing.py::slope_ms_per_iter``,
5 and 25 iterations, the stop test off) in the near-registered regime (a
small GT motion of the synthetic scene) and printed as one JSON line with
the device and its power limit. The JAX script's ``morton_unroll`` is the
TPU kernel's static unroll, which K3 does not have.

Run:  python -m fpcr_tpu_torch.bench.bench_large [morton|grid|all]
      [--sizes N ...] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, NamedTuple

import torch

import fpcr_tpu_torch as ft
from fpcr_tpu_torch.bench.card import card_fields
from fpcr_tpu_torch.utils.device import resolve_device
from fpcr_tpu_torch.utils.timing import slope_ms_per_iter

NEAR_GT = ((0.004, -0.002, 0.003), (0.002, -0.003, 0.002))


class Row(NamedTuple):
    width: int
    matcher: str
    window: int = 512
    chunk: int = 256

    @property
    def n(self) -> int:
        return self.width * self.width


ROWS = {
    "morton": [Row(128, "morton"),                        # 16,384
               Row(512, "morton", window=64, chunk=512),  # 262,144
               Row(1024, "morton", window=64, chunk=512),
               Row(1024, "morton", window=128, chunk=512),
               Row(1024, "morton", window=256)],
    "grid": [Row(128, "grid"), Row(512, "grid")],
}


def bench_row(row: Row, device, lo: int = 5, hi: int = 25, repeats: int = 3,
              cap: int = 12) -> dict:
    """Slope-time one row; return its record."""
    scene = ft.synthetic_scene(width=row.width, device=device)
    gt = ft.gt_transform(*NEAR_GT, device=device)
    src = scene.source
    tgt = gt.apply(src)
    last = {}

    def run(iters):
        cfg = ft.ICPConfig(matcher=row.matcher, max_iterations=iters,
                           tolerance=0.0, grid_cap=cap,
                           morton_window=row.window, morton_chunk=row.chunk,
                           source_chunk=65536 if row.matcher == "grid"
                           else 2048)
        last["res"] = ft.run_icp(src, tgt, cfg)
        return last["res"]

    t = slope_ms_per_iter(run, k_lo=lo, k_hi=hi, repeats=repeats,
                          device=device)
    res = last["res"]  # the long leg's last run
    return {"n": row.n, "matcher": row.matcher, "morton_window": row.window,
            "morton_chunk": row.chunk, "ms_per_iter": t["ms_per_iter"],
            "lo_ms": t["lo_ms"], "hi_ms": t["hi_ms"], "k_lo": lo, "k_hi": hi,
            "repeats": repeats, "final_err": float(res.errors[hi - 1]),
            "gt_rmse": float(ft.transform_rmse(res.transform, gt, src)),
            **card_fields(device)}


def select(which: str, sizes=None) -> List[Row]:
    rows = ROWS["morton"] + ROWS["grid"] if which == "all" else ROWS[which]
    return [r for r in rows if not sizes or r.n in sizes]


def main(argv=None) -> List[dict]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("which", nargs="?", default="morton",
                        choices=("morton", "grid", "all"))
    parser.add_argument("--sizes", type=int, nargs="+", default=None,
                        help="point counts of the rows to run (all rows "
                             "when absent)")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU, timed by the host clock")
    args = parser.parse_args(argv)
    device = torch.device(resolve_device("cpu" if args.cpu else None))
    rows = select(args.which, args.sizes)
    if not rows:
        parser.error(f"no {args.which} row has a size in {args.sizes}")
    out = []
    for row in rows:
        rec = bench_row(row, device)
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
