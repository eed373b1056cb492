"""The float64 reference against the program on tiny registrations, its
band geometry against the program's plain band search, and its control (the
same reference with TF32 products) failing the cells' limits."""

import json

import numpy as np
import pytest
import torch

import fpcr_tpu_torch as ft
from benchmark import scenes, traffic
from benchmark.control import as_row
from benchmark.reference import check, icp64
from benchmark.spec import ROOT, load_cell


def _json(kind, name):
    return json.loads((ROOT / "benchmark" / kind / f"{name}.json")
                      .read_text())


def _pool(scene, traffic_name, seed, **tr):
    t = dict(_json("traffic", traffic_name), request_seed=seed, **tr)
    return traffic.make_pool(scenes.make_cloud(scene), t, "cpu")


def _program_row(pool, i, icp, metric):
    res = ft.run_icp(pool.sources[i], pool.target(i),
                     ft.ICPConfig(metric=metric, **icp))
    from benchmark.rows import pack
    return pack(res)[0]


@pytest.mark.parametrize("metric", ["point", "plane"])
def test_exact_matcher_reference_agrees(metric):
    icp = dict(_json("configs", "os1-16-hall")["icp"], max_iterations=30)
    # noise of a sixth of the grid's spacing: no point's nearest
    # neighbours lie on a line, where a normal has no direction
    pool = _pool({"kind": "surface_grid", "width": 20,
                  "xy_range": [-2.0, 2.0]}, "scan-point-seq", 7, pool=2,
                 translation={"kind": "ball", "radius": 0.1},
                 source_noise=0.035, target_noise=0.035)
    for i in range(2):
        ref = icp64.register(pool.sources[i], pool.target(i), icp, metric)
        g = check.gaps(_program_row(pool, i, icp, metric), ref,
                       pool.sources[i])
        assert ref.iterations >= 2
        assert g["iter_gap"] == 0
        # point-to-plane's fixed point moves with the normals, whose float32
        # eigenvectors turn by up to ~6e-3 rad where two eigenvalues of a
        # neighbourhood lie close
        pose = 1e-5 if metric == "point" else 1e-4
        assert g["pose_gap_m"] < pose and g["error_gap_m"] < 1e-5, g


def test_band_reference_agrees():
    icp = _json("configs", "synthgrid-1m")["icp"]
    pool = _pool({"kind": "surface_grid", "width": 48,
                  "xy_range": [-2.0, 2.0]}, "near-point-seq", 3, pool=2,
                 translation={"kind": "per_axis", "max": 0.05},
                 rotation={"kind": "per_axis", "max_rad": 0.03})
    for i in range(2):
        ref = icp64.register(pool.sources[i], pool.target(i), icp, "point")
        g = check.gaps(_program_row(pool, i, icp, "point"), ref,
                       pool.sources[i])
        assert ref.iterations >= 2
        assert g["iter_gap"] == 0
        assert g["pose_gap_m"] < 1e-5 and g["error_gap_m"] < 1e-5, g


def test_band_picks_equal_the_programs_plain_band():
    from fpcr_tpu_torch.ops.morton import (build_morton_table,
                                           morton_nn_band_plain,
                                           source_morton_order)

    rng = np.random.default_rng(5)
    q = torch.as_tensor(rng.uniform(-1, 1, (3000, 3)).astype(np.float32))
    p = (q[:2500] + torch.as_tensor(
        rng.normal(0, 0.01, (2500, 3)).astype(np.float32)))
    table = build_morton_table(q)
    p_sorted = p[source_morton_order(p, table).long()].contiguous()
    mine = icp64.band_table(q, icp64.FLOAT64)
    assert torch.equal(mine.codes, table.codes_sorted)
    theirs, d_t, _, _ = morton_nn_band_plain(p_sorted, table, chunk=256,
                                             window=64)
    matched, d = icp64.band_nearest(p_sorted.double(), mine, 256, 64,
                                    icp64.FLOAT64)
    # the same band, so the same pick wherever float32 separates the two
    # nearest candidates
    same = (matched.float() == theirs).all(dim=1)
    assert same.float().mean() > 0.999
    np.testing.assert_allclose(d.numpy(), d_t.double().numpy(), rtol=1e-5,
                               atol=1e-9)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -(1.0 + 2 ** -12)])
    np.testing.assert_array_equal(icp64._round_tf32(x).numpy(),
                                  [1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -1.0])


@pytest.mark.parametrize("cell", ["hall-point-seq", "grid1m-morton-seq"])
def test_control_fails_the_cells_limits(cell):
    """The control, TF32 products in the reference's place, read against
    the float64 reference at a tiny size, fails the cell's own limits."""
    c = load_cell(cell)
    if c.config["icp"]["matcher"] == "morton":
        scene, tr = {"kind": "surface_grid", "width": 48,
                     "xy_range": [-2.0, 2.0]}, "near-point-seq"
    else:
        scene, tr = {"kind": "surface_grid", "width": 20,
                     "xy_range": [-2.0, 2.0]}, "scan-point-seq"
    icp = dict(c.config["icp"], max_iterations=30)
    pool = _pool(scene, tr, 13, pool=2)
    for i in range(2):
        ref = icp64.register(pool.sources[i], pool.target(i), icp, "point")
        ctl = icp64.register(pool.sources[i], pool.target(i), icp, "point",
                             icp64.TF32)
        g = check.gaps(as_row(ctl, 30), ref, pool.sources[i])
        assert any(g[name] > limit for name, limit in c.limits.items()), g
