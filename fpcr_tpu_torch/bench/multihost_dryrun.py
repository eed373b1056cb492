"""A two-process ``torch.distributed`` dry run of the multi-process path,
on the CPU: it needs no card.

Counterpart of ``scripts/multihost_dryrun.py``. The parent starts two OS
processes; each joins a gloo group on a free localhost port through
``parallel/multihost.py::initialize_multihost(..., cpu=True)``, checks its
row range (``local_shard_bounds``), and runs the sharded ICP loop
(``parallel/dist_icp.py::distributed_icp``) over both to ground-truth
recovery. The parent exits 1 if either process fails.

Run:  python -m fpcr_tpu_torch.bench.multihost_dryrun
"""

from __future__ import annotations

import argparse
import sys

N_PROCESSES = 2
N_POINTS = 512


def child(rank: int, world: int, port: int) -> None:
    import numpy as np
    import torch

    import fpcr_tpu_torch as ft
    from fpcr_tpu_torch.parallel.dist_icp import distributed_icp, make_mesh
    from fpcr_tpu_torch.parallel.multihost import (initialize_multihost,
                                                   is_multihost,
                                                   local_shard_bounds)

    torch.set_num_threads(1)
    ok = initialize_multihost(f"localhost:{port}", world, rank, cpu=True)
    if not (ok and is_multihost()):
        raise RuntimeError("initialize_multihost formed no process group "
                           "with explicit arguments")
    mesh = make_mesh()  # the whole world
    rng = np.random.default_rng(0)  # the same data in every process
    src = torch.as_tensor(rng.uniform(-1.0, 1.0, (N_POINTS, 3)),
                          dtype=torch.float32)
    gt = ft.gt_transform((0.02, -0.01, 0.03), (0.03, -0.02, 0.01),
                         device="cpu")
    tgt = gt.apply(src)

    lo, hi = local_shard_bounds(N_POINTS)
    per = -(-N_POINTS // world)
    if (lo, hi) != (rank * per, min((rank + 1) * per, N_POINTS)):
        raise AssertionError(f"rank {rank}: shard bounds [{lo}:{hi})")
    print(f"[rank {rank}] {world} processes (gloo), mesh of {mesh.size}, "
          f"local rows [{lo}:{hi})", flush=True)

    res = distributed_icp(src, tgt, ft.ICPConfig(max_iterations=20),
                          mesh=mesh)
    err = float(ft.transform_rmse(res.transform, gt, src))
    print(f"[rank {rank}] converged={bool(res.converged)} GT err {err:.2e}",
          flush=True)
    if not err < 1e-4:
        raise AssertionError(f"rank {rank}: GT error {err}")
    print(f"[rank {rank}] MULTIHOST OK", flush=True)
    torch.distributed.destroy_process_group()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rank", type=int, default=None,
                        help=argparse.SUPPRESS)  # set by the parent
    parser.add_argument("--world", type=int, default=N_PROCESSES,
                        help=argparse.SUPPRESS)
    parser.add_argument("--port", type=int, default=0,
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank is not None:
        child(args.rank, args.world, args.port)
        return 0
    from fpcr_tpu_torch.bench._spawn import run_ranks

    ok = run_ranks("fpcr_tpu_torch.bench.multihost_dryrun", N_PROCESSES, [],
                   "MULTIHOST OK")
    print("[parent] multihost dryrun", "PASSED" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
