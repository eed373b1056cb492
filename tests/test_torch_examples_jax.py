"""``chip_smoke.py`` holds the port's examples on the card to the JAX
package's full-size runs (``EXAMPLE_JAX``, ``SLAM_EXAMPLE_JAX``), which the
card cannot compute: the same computations through ``fpcr_tpu`` on the CPU,
at the JAX examples' full sizes, give those constants."""

import os
import sys

import numpy as np
import pytest

import fpcr_tpu as f
from fpcr_tpu.models.ndt import NDTConfig as JNDTConfig
from fpcr_tpu.models.ndt import run_ndt as j_run_ndt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_basic():
    s = f.synthetic_scene(width=128)
    r = f.icp_point_to_point(s.source, s.target, config=f.ICPConfig(
        max_iterations=40, tolerance=1e-6))
    return int(r.num_iterations)


def _jax_lidar():
    s = f.hall_scene()
    r = f.icp_point_to_plane(s.source, s.target, config=f.ICPConfig(
        metric="plane", max_iterations=100, k_neighbors=4))
    return int(r.num_iterations)


def _jax_ndt_tracking():
    map_cloud = f.synthetic_scene(width=64).source
    grid = f.build_ndt_grid(map_cloud, 0.3)
    cfg = f.resolve_ndt_config(JNDTConfig(voxel_size=0.3, max_iterations=60),
                               grid, map_cloud)
    rng = np.random.default_rng(0)
    its = []
    for _ in range(5):
        gt = f.gt_transform(tuple(0.01 * rng.standard_normal(3)),
                            tuple(0.05 * rng.standard_normal(3)))
        its.append(int(j_run_ndt(gt.apply(map_cloud), map_cloud, cfg,
                                 grid=grid).num_iterations))
    return tuple(its)


def _jax_odometry():
    from fpcr_tpu_torch.examples.odometry_slam import slam_frames

    world = np.asarray(f.synthetic_scene(width=64).source)
    frames, _ = slam_frames(world, 12, 1024)
    odo = f.register_sequence(frames, f.ICPConfig(max_iterations=25,
                                                  auto_trim=9.0))
    its = np.asarray(odo.relative.num_iterations).tolist()
    errors = np.asarray(odo.relative.errors)
    return {"iterations": tuple(its),
            "final": tuple(float(errors[k, it - 1])
                           for k, it in enumerate(its))}


@pytest.mark.parametrize("name,run", [
    ("basic_registration", _jax_basic), ("lidar_plane_icp", _jax_lidar),
    ("ndt_map_tracking", _jax_ndt_tracking), ("odometry_slam", _jax_odometry)],
    ids=["basic_registration", "lidar_plane_icp", "ndt_map_tracking",
         "odometry_slam"])
def test_chip_smoke_holds_jax_full_size_examples(name, run):
    """Each example's full-size JAX run gives ``chip_smoke.py``'s
    constant: its iterations (SLAM: each pair's, and its final error)."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    got = run()
    if name == "odometry_slam":
        ref = chip_smoke.SLAM_EXAMPLE_JAX
        assert got["iterations"] == tuple(ref["iterations"])
        assert got["final"] == pytest.approx(ref["final"], rel=1e-6)
    else:
        assert got == chip_smoke.EXAMPLE_JAX[name]

