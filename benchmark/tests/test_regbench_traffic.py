"""The traffic generator: the same requests for the same seed, the same
magnitudes in another order for another seed."""

import json

import numpy as np
import torch

from benchmark import scenes, traffic
from benchmark.spec import ROOT


def _traffic(name):
    return json.loads((ROOT / "benchmark" / "traffic" /
                       f"{name}.json").read_text())


def _angles(rotations):
    return np.arccos(np.clip((np.trace(rotations, axis1=1, axis2=2) - 1) / 2,
                             -1, 1))


def test_requests_follow_the_request_seed():
    cloud = scenes.surface_grid(16, -2.0, 2.0)
    tr = dict(_traffic("scan-point-seq"), pool=8)
    a = traffic.make_pool(cloud, tr, "cpu")
    b = traffic.make_pool(cloud, tr, "cpu")
    assert torch.equal(a.sources, b.sources)
    assert torch.equal(a.targets, b.targets)
    c = traffic.make_pool(cloud, dict(tr, request_seed=2 ** 33 + 6), "cpu")
    assert not torch.equal(a.sources, c.sources)


def test_poses_are_fixed_and_stratified():
    """The poses' magnitudes are the strata's midpoints of the stated
    distribution, and the sources the poses applied to the cloud."""
    cloud = scenes.surface_grid(16, -2.0, 2.0)
    for name in ("scan-point-seq", "near-point-seq"):
        tr = _traffic(name)
        a = traffic.make_pool(cloud, tr, "cpu")
        n = tr["pool"]
        mid = (np.arange(n) + 0.5) / n
        if tr["rotation"]["kind"] == "axis_angle":
            np.testing.assert_allclose(
                np.sort(_angles(a.rotations)),
                np.deg2rad(tr["rotation"]["max_deg"]) * mid, atol=1e-9)
        if tr["translation"]["kind"] == "ball":
            np.testing.assert_allclose(
                np.sort(np.linalg.norm(a.translations, axis=1)),
                tr["translation"]["radius"] * np.cbrt(mid))
        else:
            for axis in range(3):
                np.testing.assert_allclose(
                    np.sort(a.translations[:, axis]),
                    (2 * mid - 1) * tr["translation"]["max"])
        # the moved clouds are the poses applied to the cloud
        r, t = a.rotations[0], a.translations[0]
        want = cloud.astype(np.float64) @ r.T + t
        if not tr["source_noise"]:
            np.testing.assert_allclose(a.sources[0].numpy(), want,
                                       atol=1e-6)


def test_shared_target_is_the_cloud():
    cloud = scenes.surface_grid(16, -2.0, 2.0)
    pool = traffic.make_pool(cloud, _traffic("near-point-seq"), "cpu")
    assert pool.targets is None
    assert torch.equal(pool.target(5), torch.as_tensor(cloud))


def test_calls_cycle_the_pool():
    tr = dict(_traffic("scan-point-batch32"), pool=12)
    it = traffic.calls(tr, 99, 4)
    first = [next(it) for _ in range(6)]
    groups = {tuple(range(k, k + 4)) for k in (0, 4, 8)}
    assert {tuple(c) for c in first[:3]} == groups
    assert {tuple(c) for c in first[3:]} == groups
    again = traffic.calls(tr, 99, 4)
    assert all(np.array_equal(next(again), c) for c in first)
    other = traffic.calls(tr, 100, 4)
    assert any(not np.array_equal(next(other), c) for c in first)


def test_hall_scan_parse():
    cfg = json.loads((ROOT / "benchmark" / "configs" /
                      "os1-16-hall.json").read_text())
    pts = scenes.make_cloud(cfg["scene"])
    assert pts.shape == (cfg["scene"]["points"], 3)
    assert pts.dtype == np.float32
    r = np.linalg.norm(pts, axis=1)
    assert 0.0 < r.max() < 10.0
