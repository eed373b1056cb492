"""Example 2 — the reference's flagship pipeline: real Ouster OS1-16 hall
scan, point-to-plane ICP with on-device PCA normals
(GPU_point_to_plane_real.cu equivalent).

Run:  python -m fpcr_tpu_torch.examples.lidar_plane_icp [--cpu] [--quick]
(--quick strides the scan to ~2k points for fast smoke runs)
"""

from __future__ import annotations

import sys

import fpcr_tpu_torch as ft

from ._common import parse


def main(argv=None) -> dict:
    args, device = parse(__doc__, argv)
    # parse packets -> polar->Cartesian -> GT pair
    scene = ft.hall_scene(device=device)
    if args.quick:
        scene = ft.RegistrationScene(scene.source[::8], scene.target[::8],
                                     scene.ground_truth)
    print(f"hall scan: {scene.source.shape[0]} points")

    result = ft.icp_point_to_plane(
        scene.source, scene.target,
        config=ft.ICPConfig(metric="plane", max_iterations=100,
                            k_neighbors=4),
    )

    ni = int(result.num_iterations)
    final = float(result.errors[ni - 1])
    gt_err = float(ft.transform_rmse(result.transform, scene.ground_truth,
                                     scene.source))
    print(f"converged={bool(result.converged)} after {ni} iterations, "
          f"final error {final:.3e}")
    print("transform RMSE vs GT:", gt_err)
    return {"iterations": ni, "converged": bool(result.converged),
            "final_error": final, "gt_error": gt_err}


if __name__ == "__main__":
    main(sys.argv[1:])
