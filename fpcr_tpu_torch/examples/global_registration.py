"""Example 4 — global registration: unknown initial pose.

Every reference program starts ICP from a known-small displacement; this
example registers the Stanford Bunny from a pose that traps plain ICP in a
local minimum, using FPFH features + hypothesis-parallel RANSAC for the
coarse alignment, then ICP for the final 1e-7-grade pose. RANSAC draws its
minimal sets from a ``torch.Generator`` seeded by ``seed``, so its inlier
count is not the JAX package's; the refined pose is.

Run:  python -m fpcr_tpu_torch.examples.global_registration [--cpu] [--quick]
(--quick subsamples the Bunny for fast smoke runs)
"""

from __future__ import annotations

import sys

import fpcr_tpu_torch as ft

from ._common import parse


def main(argv=None) -> dict:
    args, device = parse(__doc__, argv)
    source = ft.load_bunny(resampled=True, device=device)  # 8,171 points
    if args.quick:
        source = source[::4]
    # a large unknown pose: 1.2 rad of rotation — far outside ICP's basin
    gt = ft.gt_transform(translation=(0.1, -0.05, 0.08),
                         rotation_rad=(0.4, 1.2, -0.8), device=device)
    target = gt.apply(source)

    plain = ft.run_icp(source, target, ft.ICPConfig(max_iterations=60))
    plain_err = float(ft.transform_rmse(plain.transform, gt, source))
    print(f"plain ICP from identity: GT error {plain_err:.2e} "
          f"(trapped in a local minimum)")

    coarse = ft.global_registration(source, target)
    coarse_err = float(ft.transform_rmse(coarse.transform, gt, source))
    print(f"FPFH+RANSAC coarse: {int(coarse.num_inliers)} inliers / "
          f"{int(coarse.num_correspondences)} mutual correspondences, "
          f"GT error {coarse_err:.2e}")

    refined = ft.register_global(source, target,
                                 config=ft.ICPConfig(max_iterations=40))
    refined_err = float(ft.transform_rmse(refined.transform, gt, source))
    print(f"global + ICP refine: GT error {refined_err:.2e}")
    return {"plain_gt_error": plain_err, "inliers": int(coarse.num_inliers),
            "correspondences": int(coarse.num_correspondences),
            "coarse_gt_error": coarse_err, "gt_error": refined_err,
            "iterations": int(refined.num_iterations)}


if __name__ == "__main__":
    main(sys.argv[1:])
