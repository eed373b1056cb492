"""Correctness guards on the device: the three checks of the JAX package's
hardware smoke (``scripts/tpu_smoke.py``) that the port's other checks do
not cover, with its inputs and thresholds.

* check 7 — ``tune_morton`` on a cloud far from the origin (|p| ~ 500,
  global-frame coordinates) stays untuned: no rescue, one shift;
* check 9 — ``eigh3`` on λI covariances (every eigenvector fallback fires)
  keeps an orthonormal frame that reconstructs I/λ, and NDT over a grid
  with duplicate clusters (isotropic voxels) converges finite to 5e-3;
* check 10 — the 259,200-point wide-plane cloud: ``resolve_ndt_config``
  escalates kernel K4's window past 256 (on the card it must pick K4),
  K4's hit counts at that window equal the gather oracle's
  (``ops/ndt.py::reference_neighborhood_moments``), and ``run_ndt``
  reaches GT < 1e-2 with a matched fraction above 0.85.

Each check returns its numbers and raises ``AssertionError`` past its
threshold. On a CPU tensor K4 is its plain version.

Run:  python -m fpcr_tpu_torch.bench.guards [--cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

import fpcr_tpu_torch as ft
from fpcr_tpu_torch.data.synthetic import wide_plane_cloud
from fpcr_tpu_torch.models.icp import tune_morton
from fpcr_tpu_torch.models.ndt import NDTConfig, resolve_ndt_config, run_ndt
from fpcr_tpu_torch.ops.eigh3 import eigh3
from fpcr_tpu_torch.ops.ndt import (cell_key_order, gauss_d1_d2,
                                    ndt_fused_moments, prepare_fused_tables,
                                    reference_neighborhood_moments)
from fpcr_tpu_torch.utils.device import resolve_device, to_numpy

WIDE_VOXEL = 0.25
WIDE_GT = ((0.004, -0.003, 0.002), (0.002, -0.002, 0.003))
WIDE_WINDOW_FLOOR = 256  # K4's floor window, which the cloud outgrows


def far_cloud_tuning(device) -> dict:
    """Check 7."""
    rng = np.random.default_rng(11)
    far = torch.as_tensor(
        (rng.uniform(-1, 1, (8192, 3)) + [500.0, -300.0, 400.0]
         ).astype(np.float32), device=device)
    tuned = tune_morton(far + 0.002, far, ft.ICPConfig(matcher="morton"))
    out = {"morton_rescue": tuned.morton_rescue,
           "morton_shifts": tuned.morton_shifts}
    if not (tuned.morton_rescue == 0 and tuned.morton_shifts == 1):
        raise AssertionError(f"tune_morton far from the origin: {out}")
    return out


def isotropic_frame(device) -> dict:
    """Check 9, the frame: V diag(1/λ) Vᵀ must reconstruct I/λ."""
    iso = np.stack([lam * np.eye(3, dtype=np.float32)
                    for lam in (1.0, 0.25, 4.0)])
    lams, vecs = eigh3(torch.as_tensor(iso, device=device))
    lams, vecs = to_numpy(lams), to_numpy(vecs)
    orth = max(float(np.abs(V.T @ V - np.eye(3)).max()) for V in vecs)
    rec = max(float(np.abs(V @ np.diag(1.0 / lv) @ V.T
                           - np.eye(3) / lv[0]).max())
              for V, lv in zip(vecs, lams))
    out = {"max_orthonormal_err": orth, "max_reconstruction_err": rec}
    if not (orth < 1e-5 and rec < 1e-4):
        raise AssertionError(f"eigh3 isotropic frame: {out}")
    return out


def duplicate_cluster_ndt(device) -> dict:
    """Check 9, end to end: NDT over a grid whose duplicate clusters
    quantize into isotropic voxels stays finite and converges (the JAX
    package reaches ~2e-3 on the CPU; the frame fault gave O(1))."""
    rng = np.random.default_rng(7)
    base = rng.uniform(0, 2.0, (4096, 3)).astype(np.float32)
    cloud_np = np.concatenate([base, np.repeat(base[:256], 4, axis=0)])
    cloud = torch.as_tensor(cloud_np.astype(np.float32), device=device)
    gt = ft.gt_transform((0.003, -0.002, 0.002), (0.001, -0.002, 0.001),
                         device=device)
    res = run_ndt(cloud, gt.apply(cloud),
                  NDTConfig(voxel_size=0.25, max_iterations=20))
    err = float(ft.transform_rmse(res.transform, gt, cloud))
    out = {"gt_rmse": err, "iterations": int(res.num_iterations)}
    if not (np.isfinite(err) and err < 5e-3):
        raise AssertionError(f"NDT with isotropic voxels: {out}")
    return out


def wide_plane_setup(device):
    """``(cloud, grid, gt, source, sorted source, resolved config)`` of
    check 10; the config is resolved once, on the host, outside any loop."""
    wp = wide_plane_cloud(device=device)  # 18 x (120x120) = 259,200 pts
    grid = ft.build_ndt_grid(wp, WIDE_VOXEL)
    gt = ft.gt_transform(*WIDE_GT, device=device)
    src = gt.inverse().apply(wp)
    src_sorted = src[cell_key_order(src, grid).long()].contiguous()
    cfg = resolve_ndt_config(NDTConfig(voxel_size=WIDE_VOXEL,
                                       lookup="banded", lookup_chunk=512),
                             grid, src_sorted)
    return wp, grid, gt, src, src_sorted, cfg


def fused_count_parity(src_sorted, grid, cfg) -> bool:
    """K4's hit counts (column 10 of its rows) at ``cfg``'s window equal
    the gather oracle's, every query."""
    d1, d2 = gauss_d1_d2(0.55, WIDE_VOXEL)
    d1 = abs(d1)
    _, _, count, _ = reference_neighborhood_moments(src_sorted, grid, d1, d2)
    rows, _ = ndt_fused_moments(src_sorted, grid, prepare_fused_tables(grid),
                                voxel_size=WIDE_VOXEL, d1=d1, d2=d2,
                                chunk=cfg.lookup_chunk,
                                window=cfg.lookup_window)
    return bool(torch.equal(rows[:, 10], count))


def wide_plane(device) -> dict:
    """Check 10."""
    wp, grid, gt, src, src_sorted, cfg = wide_plane_setup(device)
    out = {"n": int(wp.shape[0]), "lookup_impl": cfg.lookup_impl,
           "lookup_window": cfg.lookup_window}
    if device.type == "cuda" and not (cfg.lookup_impl == "pallas"
                                      and cfg.lookup_window
                                      > WIDE_WINDOW_FLOOR):
        raise AssertionError(f"wide-plane policy on the card: {out}")
    if cfg.lookup_impl == "pallas":
        out["count_parity"] = fused_count_parity(src_sorted, grid, cfg)
        if not out["count_parity"]:
            raise AssertionError(f"K4's counts at window "
                                 f"{cfg.lookup_window} miss neighbours")
    res = run_ndt(src, wp, cfg, grid=grid)
    out["gt_rmse"] = float(ft.transform_rmse(res.transform, gt, src))
    out["matched_fraction"] = float(res.matched_fraction)
    out["iterations"] = int(res.num_iterations)
    if not (np.isfinite(out["gt_rmse"]) and out["gt_rmse"] < 1e-2
            and out["matched_fraction"] > 0.85):
        raise AssertionError(f"wide-plane NDT registration: {out}")
    return out


CHECKS = {"check 7 far-cloud tune_morton": far_cloud_tuning,
          "check 9 eigh3 isotropic frame": isotropic_frame,
          "check 9 duplicate-cluster NDT": duplicate_cluster_ndt,
          "check 10 wide-plane NDT": wide_plane}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the CUDA card")
    args = parser.parse_args(argv)
    device = torch.device(resolve_device("cpu" if args.cpu else None))
    out = {}
    for name, check in CHECKS.items():
        out[name] = check(device)
        print(f"[ok] {name} {json.dumps(out[name])}", flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
