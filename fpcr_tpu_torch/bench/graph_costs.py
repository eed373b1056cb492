"""What the captured loops cost a caller, tree against tree.

Two measurements on the card, each in fresh processes, the trees in turns
(A, B, ..., B, A), every tree's kernels built before the first timing:

* one-shot calls (``oneshot``): the wall time of a process that registers
  one shape once or a few times, the CLI's ``run --dataset bunny`` and each
  example of ``fpcr_tpu_torch/examples`` at its default size, start-up and
  imports included, and where the tree has them the loops that ran eagerly
  as their key's first and those that ran by graphs
  (``utils/graphs.py::CACHE.loops``);
* repeated calls (``slopes``): ms/iter by
  ``utils/timing.py::slope_ms_per_iter`` (5 and 25 iterations, min of 3,
  three times in one process) of Morton ICP through K3 and NDT through K4
  at 1,048,576 points, on chip_smoke.py's scenes, each loop as its tree
  runs it by default.

Each tree is a checkout of the repo (its root holds ``chip_smoke.py`` and
``fpcr_tpu_torch/``). One JSON line per process goes to standard output and
to ``--out``.

Run:  python -m fpcr_tpu_torch.bench.graph_costs --trees PARENT . \\
          [--only oneshot|slopes] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

EXAMPLES = ("basic_registration", "lidar_plane_icp", "global_registration",
            "large_scale_pipeline", "ndt_map_tracking", "odometry_slam")

# runs a module as ``python -m`` would, then prints the graphs' loop counts
RUNNER = r'''
import json, runpy, sys
module = sys.argv[1]
sys.argv = [module] + sys.argv[2:]
try:
    runpy.run_module(module, run_name="__main__", alter_sys=True)
except SystemExit as e:
    if e.code not in (None, 0):
        raise
try:
    from fpcr_tpu_torch.utils import graphs
except ImportError:  # a tree from before the graphs
    graphs = None
cache = getattr(graphs, "CACHE", None)
print("GRAPH_LOOPS " + json.dumps(dict(getattr(cache, "loops", {}))))
'''

ONESHOT = [("cli run --dataset bunny",
            ["-c", RUNNER, "fpcr_tpu_torch.cli", "run", "--dataset", "bunny"])
           ] + [(f"example {name}",
                 ["-c", RUNNER, f"fpcr_tpu_torch.examples.{name}"])
                for name in EXAMPLES]

BUILD = ("from fpcr_tpu_torch import _build; "
         "print(_build.build().seconds)")

SLOPES = r'''
import dataclasses as dc, json, sys
sys.path.insert(0, ".")
import numpy as np
import torch
import chip_smoke as cs
import fpcr_tpu_torch as ft
from fpcr_tpu_torch.utils.timing import slope_ms_per_iter

dev = torch.device("cuda")
w = cs.LARGE_WIDTHS[-1]
g = cs.build_scene(ft, f"grid-{len(cs.LARGE_WIDTHS) - 1}", dev)
mcfg = ft.ICPConfig(tolerance=0.0, matcher="morton", **cs.BAND)
ns = cs.ndt_scene(torch, np, ft, w, dev)
grid = ft.build_ndt_grid(ns.target, cs.NDT_VOXEL)
ncfg = ft.resolve_ndt_config(ft.NDTConfig(voxel_size=cs.NDT_VOXEL), grid,
                             ns.source)
runs = {
    f"morton K3 {w * w}": lambda n: ft.run_icp(
        g.source, g.target, dc.replace(mcfg, max_iterations=n)),
    f"NDT K4 {w * w}": lambda n: ft.run_ndt(
        ns.source, ns.target, dc.replace(ncfg, max_iterations=n,
                                         tolerance=0.0), grid=grid)}
out = {}
for label, run in runs.items():
    out[label] = [slope_ms_per_iter(run, 5, 25, repeats=3)["ms_per_iter"]
                  for _ in range(3)]
out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
print(json.dumps(out))
'''


def _run(tree: Path, args, timeout: float) -> dict:
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, *args], cwd=tree,
                          capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t
    return {"rc": proc.returncode, "wall_s": wall,
            "stdout_tail": proc.stdout[-400:],
            "stderr_tail": proc.stderr[-400:] if proc.returncode else ""}


def turns(trees):
    """A, B, ..., B, A: each tree's runs bracket the others'."""
    return list(trees) + list(reversed(trees))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--trees", nargs="+", required=True,
                   help="checkouts of the repo, in the order to run them")
    p.add_argument("--only", choices=["oneshot", "slopes"], default=None)
    p.add_argument("--out", default=None, help="also append the lines here")
    p.add_argument("--timeout", type=float, default=300.0,
                   help="seconds a process may take")
    args = p.parse_args(argv)
    trees = [Path(t).resolve() for t in args.trees]
    out = open(args.out, "a") if args.out else None

    def emit(record):
        line = json.dumps(record)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    failed = 0
    for tree in trees:
        emit(dict(_run(tree, ["-c", BUILD], args.timeout), tree=str(tree),
                  what="build"))
    sets = []
    if args.only in (None, "oneshot"):
        sets += ONESHOT
    if args.only in (None, "slopes"):
        sets.append(("slopes", ["-c", SLOPES]))
    for what, cmd in sets:
        for tree in turns(trees):
            rec = dict(_run(tree, cmd, args.timeout), tree=str(tree),
                       what=what)
            last = rec["stdout_tail"].strip().splitlines()[-1:] or [""]
            if what == "slopes" and rec["rc"] == 0:
                rec["slopes"] = json.loads(last[0])
                del rec["stdout_tail"]
            elif last[0].startswith("GRAPH_LOOPS "):
                rec["loops"] = json.loads(last[0].split(" ", 1)[1])
            failed += rec["rc"] != 0
            emit(rec)
    if out:
        out.close()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
