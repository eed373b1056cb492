"""Example 6 — NDT map tracking: register a scan stream against one map.

The voxel-Gaussian field (`build_ndt_grid`) is built ONCE from a map
cloud and reused for every incoming scan — the per-scan cost is just the
Gauss-Newton loop. This is the intended deployment shape for
localization: amortize the map prepass, stream the scans. The map's 4,096
points stay under ``NDTConfig.lookup_threshold`` (65,536), so the lookup
resolves to the gather, as in the JAX package; larger maps take the band
through kernel K4 on the card.

The reference (brute-force CUDA ICP) has no NDT.

Run:  python -m fpcr_tpu_torch.examples.ndt_map_tracking [--cpu] [--quick]
(--quick shrinks the scan stream for fast smoke runs)
"""

from __future__ import annotations

import sys

import numpy as np
import torch

import fpcr_tpu_torch as ft
from fpcr_tpu_torch.models.ndt import NDTConfig, run_ndt

from ._common import parse


def main(argv=None) -> dict:
    args, device = parse(__doc__, argv)
    # --quick cuts the scan stream, not the map: NDT accuracy depends on
    # points-per-voxel, so shrinking the map would change the physics
    # the "map": one saddle surface scan
    scene = ft.synthetic_scene(width=64, device=device)
    map_cloud = scene.source

    # one-time prepass: voxelize the map into per-voxel Gaussians
    grid = ft.build_ndt_grid(map_cloud, 0.3)
    print(f"map grid: {int(grid.valid.sum())} occupied voxels")

    # resolve the auto lookup/window policy ONCE against the grid — every
    # run_ndt below then skips the per-call host-side coverage probe
    cfg = ft.resolve_ndt_config(
        NDTConfig(voxel_size=0.3, max_iterations=60), grid, map_cloud)

    # a stream of scans: the map observed from drifting poses, drawn as
    # the JAX example draws them
    rng = np.random.default_rng(0)
    pose_errors, iterations = [], []
    for t in range(2 if args.quick else 5):
        gt = ft.gt_transform(
            tuple(0.01 * rng.standard_normal(3)),   # translation
            tuple(0.05 * rng.standard_normal(3)),   # rotation (rad)
            device=device)
        scan = gt.apply(map_cloud)

        # register scan -> map on the PREBUILT grid (no per-scan prepass)
        res = run_ndt(scan, map_cloud, cfg, grid=grid)
        # res.transform maps the scan back onto the map (it recovers
        # gt^-1); res.points is the aligned scan
        err = float(torch.sqrt(torch.mean(torch.sum(
            (res.points - map_cloud) ** 2, dim=1))))
        pose_errors.append(err)
        iterations.append(int(res.num_iterations))
        print(f"scan {t}: converged={bool(res.converged)} "
              f"iters={int(res.num_iterations)} pose rmse={err:.2e}")

    if not max(pose_errors) < 5e-3:
        raise AssertionError(f"a scan was lost: pose rmse {pose_errors}")
    print("all scans tracked")
    return {"iterations": iterations, "pose_errors": pose_errors,
            "lookup": cfg.lookup, "lookup_impl": cfg.lookup_impl}


if __name__ == "__main__":
    main(sys.argv[1:])
