"""Example 1 — basic point-to-point registration (the reference's
ICP_point_to_point workload: synthetic z=x²-y² grid, GT transform recovery).

Run:  python -m fpcr_tpu_torch.examples.basic_registration [--cpu] [--quick]
(--quick shrinks the scene for fast smoke runs, e.g. in CI)
"""

from __future__ import annotations

import sys

import numpy as np

import fpcr_tpu_torch as ft

from ._common import parse


def main(argv=None) -> dict:
    args, device = parse(__doc__, argv)
    # the reference's canonical scene: 128x128 grid, t=(0.8,-0.3,0.2),
    # r=(0.2,-0.2,0.05) rad
    scene = ft.synthetic_scene(width=24 if args.quick else 128, device=device)

    result = ft.icp_point_to_point(
        scene.source, scene.target,
        config=ft.ICPConfig(max_iterations=40, tolerance=1e-6),
    )

    ni = int(result.num_iterations)
    gt_err = float(ft.transform_rmse(result.transform, scene.ground_truth,
                                     scene.source))
    print(f"converged={bool(result.converged)} after {ni} iterations")
    print("error sequence:", np.round(result.errors[:ni].cpu().numpy(), 8))
    print("recovered rotation:\n", result.transform.rotation.cpu().numpy())
    print("recovered translation:",
          result.transform.translation.cpu().numpy())
    print("ground truth translation:",
          scene.ground_truth.translation.cpu().numpy())
    print("transform RMSE vs GT:", gt_err)

    # ground-truth-free quality check (what you'd use on real scan pairs)
    ev = ft.evaluate_registration(scene.source, scene.target,
                                  result.transform,
                                  max_correspondence_dist=0.05)
    print(f"evaluation: fitness={float(ev['fitness']):.4f} "
          f"inlier_rmse={float(ev['inlier_rmse']):.2e}")
    return {"iterations": ni, "converged": bool(result.converged),
            "gt_error": gt_err,
            "final_error": float(result.errors[ni - 1]),
            "fitness": float(ev["fitness"]),
            "inlier_rmse": float(ev["inlier_rmse"])}


if __name__ == "__main__":
    main(sys.argv[1:])
