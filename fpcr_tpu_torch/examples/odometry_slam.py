"""Example 5 — odometry + loop closure: a small SLAM back-end.

A sensor sweeps a scene in T frames; ``register_sequence`` estimates the
open-loop trajectory (all T−1 pairwise ICPs in one batched loop: one
launch pair of kernel K1 an iteration on the card), ``detect_loop_closures``
finds and batch-verifies revisit pairs automatically, each closure's
uncertainty is estimated with the Censi GN covariance, and ``close_loops``
redistributes the accumulated drift over the whole trajectory with an
SE(3) pose-graph Gauss-Newton solve using full 6×6 information-weighted
edges — all on the device.

Also shows NDT (voxel Gaussian field) as the wide-basin alternative when
a frame's displacement is too large for plain ICP.

Run:  python -m fpcr_tpu_torch.examples.odometry_slam [--cpu] [--quick]
(--quick shrinks frames/trajectory for fast smoke runs)
"""

from __future__ import annotations

import sys

import numpy as np
import torch

import fpcr_tpu_torch as ft
from fpcr_tpu_torch.utils.device import to_numpy

from ._common import parse


def slam_frames(world: np.ndarray, T: int, N: int, seed: int = 0):
    """``(frames [T, N, 3] float32, poses_gt [T, 4, 4])`` drawn as the JAX
    example draws them: the sensor sweeps +x and returns to the start
    (which is what makes a 0 ↔ T-1 loop closure possible)."""
    rng = np.random.default_rng(seed)
    xs = np.concatenate([np.linspace(0, 1.2, T // 2),
                         np.linspace(1.2, 0, T - T // 2)])
    poses_gt = []
    for t in range(T):
        M = np.eye(4, dtype=np.float32)
        M[0, 3] = xs[t]
        poses_gt.append(M)
    poses_gt = np.stack(poses_gt)

    # PARTIAL-OVERLAP frames: each frame sees only the N points nearest its
    # viewpoint, with independent sensor noise. Consecutive pairs share
    # ~80% of their points, so each pairwise ICP carries an independent
    # pose error and the T-step composition random-walks into drift —
    # while the direct 0 ↔ T-1 closure carries only ONE pairwise error.
    # (With full-overlap frames the per-pair errors telescope away and
    # there is nothing to fix.)
    frames = []
    for t in range(T):
        d = np.abs(world[:, 0] - xs[t])
        crop = world[np.argsort(d)[:N]]
        local = crop - poses_gt[t][:3, 3]  # pose is a pure translation here
        local = local + rng.normal(scale=4e-3, size=local.shape)
        frames.append(local.astype(np.float32))
    return np.stack(frames), poses_gt


def main(argv=None) -> dict:
    args, device = parse(__doc__, argv)
    # 4,096 pts, x∈[-2,2]
    world = to_numpy(ft.synthetic_scene(width=64, device=device).source)
    T = 8 if args.quick else 12
    N = 512 if args.quick else 1024
    frames_np, poses_gt = slam_frames(world, T, N)
    frames = torch.as_tensor(frames_np, device=device)

    # 1) open-loop odometry: T-1 pairwise ICPs in ONE batched loop.
    # auto_trim masks the non-overlapping tails out of the solve (frames
    # share only ~80% of their points).
    odo = ft.register_sequence(frames, ft.ICPConfig(max_iterations=25,
                                                    auto_trim=9.0))
    drift = float(np.abs(to_numpy(odo.poses[T - 1]) - poses_gt[T - 1]).max())
    print(f"open-loop odometry end-pose drift: {drift:.2e}")
    its = to_numpy(odo.relative.num_iterations).tolist()
    errors = to_numpy(odo.relative.errors)
    out = {"open_loop_drift": drift, "iterations": its,
           "final_errors": [float(errors[k, it - 1])
                            for k, it in enumerate(its)]}

    # 2) AUTOMATIC loop-closure detection: pose-proximity candidates,
    # all verified at once with one batched registration
    ei, ej, Z_all, w_all = ft.detect_loop_closures(
        frames, odo, radius=0.3, min_separation=4, max_error=1e-2)
    closures = list(zip(ei.tolist(), ej.tolist()))
    print(f"detected {int(ei.shape[0])} verified loop closure(s): "
          f"{closures}")
    out["closures"] = closures
    if ei.shape[0] == 0:
        print("no verified closures — keeping the open-loop trajectory")
        return out

    # 3) estimate every closure's uncertainty (Censi GN covariance → 6×6
    # information, adjoint-transported to the edge tangent) — full
    # information-weighted edges, not scalars
    infos = []
    for k in range(int(ei.shape[0])):
        tf_k = ft.RigidTransform(Z_all[k, :3, :3], Z_all[k, :3, 3])
        cov = ft.registration_covariance(frames[int(ej[k])],
                                         frames[int(ei[k])], tf_k,
                                         ft.ICPConfig(auto_trim=9.0))
        infos.append(ft.information_from_covariance(cov, tf_k))
        if k == 0:
            print(f"first closure pose std: "
                  f"rot {float(torch.sqrt(torch.trace(cov[:3, :3]) / 3)):.1e}"
                  f" rad, trans "
                  f"{float(torch.sqrt(torch.trace(cov[3:, 3:]) / 3)):.1e}")
    infos = torch.stack(infos)
    lam = float(torch.trace(infos[0]) / 6.0)

    # 4) pose-graph optimization over ALL detected closures with 6×6
    # information edges redistributes the drift
    res = ft.close_loops(odo, ei, ej, Z_all, infos,
                         odometry_weight=lam / 20.0, iterations=6)
    err = float(np.abs(to_numpy(res.poses[T - 1]) - poses_gt[T - 1]).max())
    print(f"after loop closure + pose-graph GN:  {err:.2e} "
          f"(edge residual RMS {float(res.residual_rms[-1]):.2e})")
    out["closed_loop_error"] = err

    # 5) NDT: the wide-basin option for a big inter-frame jump
    cloud = torch.as_tensor(world[:2048], device=device)
    big = ft.gt_transform((0.3, -0.25, 0.2), (0.25, -0.2, 0.15),
                          device=device)
    moved = big.apply(cloud)
    ndt = ft.register_ndt(cloud, moved, ft.ICPConfig(max_iterations=40))
    out["ndt_gt_error"] = float(ft.transform_rmse(ndt.transform, big, cloud))
    print(f"NDT init + ICP refine on a 0.25-rad jump: GT error "
          f"{out['ndt_gt_error']:.2e}")

    # 6) fuse the optimized trajectory into one downsampled map
    pts, valid = ft.build_map(frames, res.poses, voxel_size=0.02)
    out["map_voxels"] = int(valid.sum())
    print(f"fused map: {out['map_voxels']} voxels from {T}x{N} scan points")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
