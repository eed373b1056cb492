"""Example 3 — beyond the reference: million-point registration with the
coarse-to-fine pipeline (brute subset ICP -> Morton-banded full-res ICP),
plus the sharded variant when it runs in a process group of more than one
process (started by torchrun: NCCL on the cards, gloo with --cpu).

Run:  python -m fpcr_tpu_torch.examples.large_scale_pipeline [--cpu]
      [--width 512] [--quick]
(--quick = --width 64, for fast smoke runs)
      torchrun --nproc-per-node 4 -m fpcr_tpu_torch.examples.large_scale_pipeline
"""

from __future__ import annotations

import sys

import torch

import fpcr_tpu_torch as ft
from fpcr_tpu_torch.parallel.multihost import initialize_multihost, is_multihost

from ._common import device_of, parser


def main(argv=None) -> dict:
    p = parser(__doc__)
    p.add_argument("--width", type=int, default=None,
                   help="grid width: 512 = 262,144 points (default), "
                        "1024 = 1,048,576")
    args = p.parse_args(argv)
    # NCCL puts a torchrun process on its own card before the card is used;
    # a group joined here is left at the end, so no rank tears it down at
    # interpreter exit
    joined = (not torch.distributed.is_initialized()
              and initialize_multihost(cpu=args.cpu))
    try:
        return _run(args)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


def _run(args) -> dict:
    device = device_of(args)
    width = args.width or (64 if args.quick else 512)

    scene = ft.synthetic_scene(width=width, device=device)
    n = scene.source.shape[0]
    print(f"{n:,} points on {scene.source.device.type}")

    res = ft.icp_coarse_to_fine(
        scene.source, scene.target,
        coarse_config=ft.ICPConfig(max_iterations=40),
        fine_config=ft.ICPConfig(matcher="morton", max_iterations=20),
        coarse_points=4096,
    )
    gt_err = float(ft.transform_rmse(res.transform, scene.ground_truth,
                                     scene.source))
    print("coarse iters:", int(res.coarse.num_iterations),
          "fine iters:", int(res.fine.num_iterations))
    print("transform RMSE vs GT:", gt_err)
    out = {"points": n, "coarse_iterations": int(res.coarse.num_iterations),
           "fine_iterations": int(res.fine.num_iterations),
           "gt_error": gt_err}

    if is_multihost():
        world = torch.distributed.get_world_size()
        from fpcr_tpu_torch.parallel.dist_icp import distributed_icp

        dist = distributed_icp(scene.source, scene.target,
                               ft.ICPConfig(max_iterations=40))
        out["distributed_gt_error"] = float(ft.transform_rmse(
            dist.transform, scene.ground_truth, scene.source))
        print(f"distributed over {world} processes:",
              out["distributed_gt_error"])
    else:
        print("ran as one process: no process group of more than one, so "
              "no distributed_icp (start it under torchrun for that)")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
