"""The port's six examples (``fpcr_tpu_torch/examples/``) at ``--cpu
--quick``: each exits 0 with the JAX example's success line
(``tests/test_examples.py``), run as a user runs it in a process that
cannot import JAX or ``fpcr_tpu``; and the numbers its ``main`` returns
against the same computation through ``fpcr_tpu`` on the CPU on the same
inputs (basic, LiDAR, pipeline, NDT tracking: iterations within 1, GT
errors to the examples' contract) or against thresholds (global
registration and SLAM, whose RANSAC draws and noise-plateau stops are not
JAX's)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import fpcr_tpu as f
from fpcr_tpu.models.ndt import NDTConfig as JNDTConfig
from fpcr_tpu.models.ndt import run_ndt as j_run_ndt
from fpcr_tpu.models.pipeline import icp_coarse_to_fine as j_coarse_to_fine

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (module, the JAX example's success line)
CASES = [
    ("basic_registration", "transform RMSE vs GT"),
    ("lidar_plane_icp", "transform RMSE vs GT"),
    ("global_registration", "global + ICP refine"),
    ("large_scale_pipeline", "transform RMSE vs GT"),
    ("ndt_map_tracking", "all scans tracked"),
    ("odometry_slam", "fused map"),
]

# run a module as __main__ in a process where JAX and fpcr_tpu cannot load
NO_JAX = ("import runpy, sys; sys.modules['jax'] = None; "
          "sys.modules['fpcr_tpu'] = None; mod = sys.argv[1]; "
          "sys.argv = sys.argv[1:]; "
          "runpy.run_module(mod, run_name='__main__', alter_sys=True)")

GT_BASIC = 1e-5  # BASELINE.md's contract for the synthetic scene
GT_LIDAR = 1e-4  # tests/test_registration_datasets.py's hall threshold
GT_GLOBAL = 1e-3
NDT_TRACK = 5e-3  # the example's own assert
# two NDT runs of the same scan: the float32 order of the moment sums
# moves a pose RMSE of ~1e-4 by far less than this
NDT_POSE_GAP = 1e-6


def _example(name):
    import importlib

    return importlib.import_module(f"fpcr_tpu_torch.examples.{name}")


@pytest.mark.parametrize("name,needle", CASES, ids=[c[0] for c in CASES])
def test_example_runs(name, needle):
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "2"}
    proc = subprocess.run(
        [sys.executable, "-c", NO_JAX, f"fpcr_tpu_torch.examples.{name}",
         "--cpu", "--quick"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, (
        f"{name} failed\nstdout:\n{proc.stdout}\nstderr:\n{proc.stderr}")
    assert needle in proc.stdout, proc.stdout
    assert "device: cpu" in proc.stdout


def test_examples_need_a_card_without_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, _ in CASES:
        with pytest.raises(RuntimeError, match="CUDA card"):
            _example(name).main(["--quick"])


def test_basic_registration_matches_jax(capsys):
    got = _example("basic_registration").main(["--cpu", "--quick"])
    assert "transform RMSE vs GT" in capsys.readouterr().out
    s = f.synthetic_scene(width=24)
    ref = f.icp_point_to_point(s.source, s.target, config=f.ICPConfig(
        max_iterations=40, tolerance=1e-6))
    ref_gt = float(f.transform_rmse(ref.transform, s.ground_truth, s.source))
    assert abs(got["iterations"] - int(ref.num_iterations)) <= 1
    assert got["gt_error"] < GT_BASIC and ref_gt < GT_BASIC
    assert got["fitness"] == 1.0


def _normals64(q, k):
    """PCA normals of ``q`` in float64: each point's ``k`` nearest other
    points by float64 distance, the smallest eigenvector of float64
    ``eigh``."""
    q = np.asarray(q, np.float64)
    d = ((q[:, None, :] - q[None, :, :]) ** 2).sum(-1)
    nbr = q[np.argsort(d, axis=1, kind="stable")[:, 1:k + 1]]
    dev = nbr - nbr.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", dev, dev)
    return np.linalg.eigh(cov)[1][:, :, 0].astype(np.float32)


def test_lidar_plane_icp_matches_jax():
    """The example against JAX's plane ICP on the same strided hall scan,
    JAX given float64 normals: on a 16-beam scan a point's nearest
    neighbours lie nearly on a line, where JAX's closed-form normals turn
    by up to ~1 rad and the port's (``eig3``) hold float64's."""
    got = _example("lidar_plane_icp").main(["--cpu", "--quick"])
    s = f.hall_scene()
    s = f.RegistrationScene(s.source[::8], s.target[::8], s.ground_truth)
    ref = f.icp_point_to_plane(s.source, s.target, config=f.ICPConfig(
        metric="plane", max_iterations=100, k_neighbors=4),
        target_normals=_normals64(s.target, 4))
    ref_gt = float(f.transform_rmse(ref.transform, s.ground_truth, s.source))
    assert abs(got["iterations"] - int(ref.num_iterations)) <= 1
    assert got["gt_error"] < GT_LIDAR and ref_gt < GT_LIDAR


def test_large_scale_pipeline_matches_jax(capsys):
    got = _example("large_scale_pipeline").main(["--cpu", "--quick"])
    assert "ran as one process" in capsys.readouterr().out
    s = f.synthetic_scene(width=64)
    ref = j_coarse_to_fine(
        s.source, s.target, coarse_config=f.ICPConfig(max_iterations=40),
        fine_config=f.ICPConfig(matcher="morton", max_iterations=20),
        coarse_points=4096)
    ref_gt = float(f.transform_rmse(ref.transform, s.ground_truth, s.source))
    assert got["points"] == 4096
    assert abs(got["coarse_iterations"]
               - int(ref.coarse.num_iterations)) <= 1
    assert abs(got["fine_iterations"] - int(ref.fine.num_iterations)) <= 1
    assert got["gt_error"] < GT_BASIC and ref_gt < GT_BASIC


def test_large_scale_pipeline_under_torchrun():
    """Two gloo processes started by torchrun: the pipeline, then
    ``distributed_icp`` over both. ``--tee`` hands each rank's lines over
    whole, prefixed with the rank."""
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "--tee", "3", "-m",
         "fpcr_tpu_torch.examples.large_scale_pipeline", "--cpu", "--quick"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    errs = {}
    for line in proc.stdout.splitlines():
        rank, _, text = line.partition("]:")
        if text.startswith("distributed over 2 processes:"):
            errs[rank] = float(text.split(":")[1])
    assert sorted(errs) == ["[default0", "[default1"], proc.stdout
    assert all(e < GT_BASIC for e in errs.values())


def test_ndt_map_tracking_matches_jax():
    got = _example("ndt_map_tracking").main(["--cpu", "--quick"])
    # the 4,096-point map stays under lookup_threshold: the gather, as JAX
    assert (got["lookup"], got["lookup_impl"]) == ("gather", "xla")
    map_cloud = f.synthetic_scene(width=64).source
    grid = f.build_ndt_grid(map_cloud, 0.3)
    cfg = f.resolve_ndt_config(JNDTConfig(voxel_size=0.3, max_iterations=60),
                               grid, map_cloud)
    rng = np.random.default_rng(0)
    for t in range(2):
        gt = f.gt_transform(tuple(0.01 * rng.standard_normal(3)),
                            tuple(0.05 * rng.standard_normal(3)))
        res = j_run_ndt(gt.apply(map_cloud), map_cloud, cfg, grid=grid)
        err = float(np.sqrt(np.mean(np.sum(
            (np.asarray(res.points) - np.asarray(map_cloud)) ** 2, axis=1))))
        assert abs(got["iterations"][t] - int(res.num_iterations)) <= 1
        assert abs(got["pose_errors"][t] - err) < NDT_POSE_GAP
    assert max(got["pose_errors"]) < NDT_TRACK


def test_global_registration_refines_to_threshold():
    got = _example("global_registration").main(["--cpu", "--quick"])
    assert got["plain_gt_error"] > 1e-2  # plain ICP stays trapped
    assert got["gt_error"] < GT_GLOBAL
    assert 0 < got["inliers"] <= got["correspondences"]


def test_odometry_slam_closes_the_loop(capsys):
    got = _example("odometry_slam").main(["--cpu", "--quick"])
    assert "fused map" in capsys.readouterr().out
    assert got["closures"]
    assert got["closed_loop_error"] <= got["open_loop_drift"]
    assert got["map_voxels"] > 0

