"""Sharded large-N smoke: the sharded Morton ICP loop
(``parallel/dist_icp.py::distributed_icp``) in two stages.

Counterpart of ``scripts/sharded_large_smoke.py``:

1. parity — on an 8,192-point cloud the sharded loop's transform equals
   ``run_icp``'s within 1e-5 and recovers the GT motion;
2. scale — ``--n`` points (1,048,576 by default) of a U(±10) cloud run
   sharded for ``--iters`` iterations (the stop test off): the error is
   finite and falls, and every iteration keeps over a quarter of the
   matches (the Morton matcher's auto-trim keeps ~45% of a uniform cloud).

The Morton geometry is the package default (``morton_impl='auto'``):
kernel K3 on the card, the plain band on the CPU. On the card it runs
under torchrun (NCCL, one process a card), or as a world of one when
started alone; with ``--cpu`` the parent starts a gloo world of
``--world`` CPU processes (4 by default; the JAX script uses 8 virtual
devices).

Run:  python -m fpcr_tpu_torch.bench.sharded_large [--n 1048576]
      [--iters 3]
      torchrun --nproc-per-node 4 -m fpcr_tpu_torch.bench.sharded_large
      python -m fpcr_tpu_torch.bench.sharded_large --cpu [--world 4]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

import fpcr_tpu_torch as ft
from fpcr_tpu_torch.parallel.dist_icp import distributed_icp, make_mesh
from fpcr_tpu_torch.parallel.multihost import initialize_multihost
from fpcr_tpu_torch.utils.device import resolve_device, to_numpy

PARITY_TOL = 1e-5


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def parity(device, mesh) -> dict:
    """Stage 1: sharded against one process on the same small cloud."""
    rng = np.random.default_rng(11)
    src = torch.as_tensor(rng.uniform(-2, 2, (8192, 3)), dtype=torch.float32,
                          device=device)
    gt = ft.gt_transform((0.004, -0.003, 0.002), (0.002, -0.003, 0.002),
                         device=device)
    tgt = gt.apply(src)
    cfg = ft.ICPConfig(matcher="morton", max_iterations=12)
    single = ft.run_icp(src, tgt, cfg)
    dist = distributed_icp(src, tgt, cfg, mesh=mesh)
    dr = float((single.transform.rotation
                - dist.transform.rotation).abs().max())
    dt = float((single.transform.translation
                - dist.transform.translation).abs().max())
    gt_err = float(ft.transform_rmse(dist.transform, gt, src))
    print(f"stage1 parity: max|dR|={dr:.2e} max|dt|={dt:.2e} "
          f"(single {int(single.num_iterations)} iters, sharded "
          f"{int(dist.num_iterations)}), GT err {gt_err:.2e}", flush=True)
    if not (dr < PARITY_TOL and dt < PARITY_TOL):
        raise AssertionError(f"sharded against one process: {dr}, {dt}")
    if not gt_err < 1e-4:
        raise AssertionError(f"stage 1 GT error {gt_err}")
    return {"max_dR": dr, "max_dt": dt, "gt_err": gt_err,
            "iterations": (int(single.num_iterations),
                           int(dist.num_iterations))}


def scale(device, mesh, n: int, iters: int) -> dict:
    """Stage 2: the large cloud sharded for a few iterations."""
    rng = np.random.default_rng(7)
    big = torch.as_tensor(rng.uniform(-10, 10, (n, 3)), dtype=torch.float32,
                          device=device)
    gt = ft.gt_transform((0.02, -0.015, 0.01), (0.004, -0.006, 0.004),
                         device=device)
    tgt = gt.apply(big)
    cfg = ft.ICPConfig(matcher="morton", max_iterations=iters,
                       tolerance=0.0)
    _sync(device)
    t0 = time.perf_counter()
    res = distributed_icp(big, tgt, cfg, mesh=mesh)
    _sync(device)
    wall = time.perf_counter() - t0
    it = int(res.num_iterations)
    errs = to_numpy(res.errors)[:it]
    frac = to_numpy(res.matched_fraction)[:it]
    gt_err = float(ft.transform_rmse(res.transform, gt, big))
    print(f"stage2 {n:,} pts sharded x{mesh.size}: wall {wall:.2f} s "
          f"errors {errs} matched_fraction {frac} GT err {gt_err:.2e}",
          flush=True)
    if not np.isfinite(errs).all():
        raise AssertionError(f"non-finite errors {errs}")
    if not (len(errs) < 2 or errs[-1] < errs[0]):
        raise AssertionError(f"the error did not fall: {errs}")
    if not (frac > 0.25).all():
        raise AssertionError(f"matched fraction {frac}")
    return {"n": n, "world": mesh.size, "wall_s": wall,
            "errors": errs.tolist(), "matched_fraction": frac.tolist(),
            "gt_err": gt_err}


def run(device, n: int, iters: int) -> dict:
    """Both stages on the world this process belongs to."""
    mesh = make_mesh()
    print(f"mesh: {mesh.size} rank(s), {device.type}", flush=True)
    out = {"parity": parity(device, mesh), "scale": scale(device, mesh, n,
                                                          iters)}
    print("sharded large smoke PASSED", flush=True)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=1_048_576)
    parser.add_argument("--iters", type=int, default=3)
    parser.add_argument("--cpu", action="store_true",
                        help="start a gloo world of CPU processes")
    parser.add_argument("--world", type=int, default=4,
                        help="CPU processes with --cpu")
    parser.add_argument("--rank", type=int, default=None,
                        help=argparse.SUPPRESS)  # set by the parent
    parser.add_argument("--port", type=int, default=0,
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank is not None:  # one rank of the --cpu world
        torch.set_num_threads(1)
        initialize_multihost(f"localhost:{args.port}", args.world,
                             args.rank, cpu=True)
        run(torch.device("cpu"), args.n, args.iters)
        torch.distributed.destroy_process_group()
        return 0
    if args.cpu:
        from fpcr_tpu_torch.bench._spawn import run_ranks

        ok = run_ranks("fpcr_tpu_torch.bench.sharded_large", args.world,
                       ["--n", str(args.n), "--iters", str(args.iters)],
                       "sharded large smoke PASSED")
        print("[parent] sharded large", "PASSED" if ok else "FAILED")
        return 0 if ok else 1
    device = torch.device(resolve_device(None))
    # torchrun's world, else a world of one; a group joined here is left
    joined = (not torch.distributed.is_initialized()
              and initialize_multihost())
    try:
        run(device, args.n, args.iters)
    finally:
        if joined:
            torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
