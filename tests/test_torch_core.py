"""The port's core (transforms, clouds, metrics), config carry-over and
import hygiene, against ``fpcr_tpu`` on the same numpy inputs (CPU)."""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fpcr_tpu as f
import fpcr_tpu_torch as ft
from fpcr_tpu.core import transforms as jt
from fpcr_tpu_torch.core import transforms as tt
from fpcr_tpu_torch.core.cloud import as_points, round_up
from fpcr_tpu_torch.interop import (config_from_dict, result_to_numpy,
                                    transform_from_numpy)

torch.set_num_threads(2)

# float32 trigonometry and 3x3 products in two libraries: a few ulp of 1
ATOL = 1e-6
ROOT = Path(__file__).resolve().parents[1]

ANGLES = [0.0, 0.2, -0.2, 0.05, 1.3, -2.9]


@pytest.mark.parametrize("name", ["rotation_x", "rotation_y", "rotation_z"])
@pytest.mark.parametrize("a", ANGLES)
def test_axis_rotations_match_jax(name, a):
    np.testing.assert_allclose(getattr(tt, name)(a).numpy(),
                               np.asarray(getattr(jt, name)(a)), atol=ATOL)


@pytest.mark.parametrize("name", ["rotation_zyx", "rotation_gt"])
@pytest.mark.parametrize("angles", [(0.2, -0.2, 0.05), (0.15, -0.1, 0.05),
                                    (0.01, -0.003, 0.05), (1.0, 2.0, -3.0)])
def test_euler_rotations_match_jax(name, angles):
    np.testing.assert_allclose(getattr(tt, name)(*angles).numpy(),
                               np.asarray(getattr(jt, name)(*angles)),
                               atol=ATOL)


def test_gt_transform_matches_jax():
    a = ft.gt_transform((0.8, -0.3, 0.2), (0.2, -0.2, 0.05), device="cpu")
    b = f.gt_transform((0.8, -0.3, 0.2), (0.2, -0.2, 0.05))
    np.testing.assert_allclose(a.rotation.numpy(), np.asarray(b.rotation),
                               atol=ATOL)
    np.testing.assert_allclose(a.translation.numpy(),
                               np.asarray(b.translation), atol=ATOL)
    assert a.rotation.dtype == torch.float32


def _pair(seed):
    rng = np.random.default_rng(seed)
    ang, t = rng.uniform(-1, 1, 3), rng.uniform(-2, 2, 3)
    return ft.gt_transform(t, ang, device="cpu"), f.gt_transform(t, ang)


def test_apply_compose_inverse_match_jax():
    a1, b1 = _pair(1)
    a2, b2 = _pair(2)
    pts = np.random.default_rng(3).uniform(-3, 3, (50, 3)).astype(np.float32)
    np.testing.assert_allclose(a1.apply(torch.as_tensor(pts)).numpy(),
                               np.asarray(b1.apply(jnp.asarray(pts))),
                               atol=ATOL)
    for a, b in ((a1.compose(a2), b1.compose(b2)),
                 (a1.inverse(), b1.inverse())):
        np.testing.assert_allclose(a.rotation.numpy(), np.asarray(b.rotation),
                                   atol=ATOL)
        np.testing.assert_allclose(a.translation.numpy(),
                                   np.asarray(b.translation), atol=ATOL)
    np.testing.assert_allclose(a1.as_matrix().numpy(),
                               np.asarray(b1.as_matrix()), atol=ATOL)
    ident = a1.compose(a1.inverse())
    np.testing.assert_allclose(ident.rotation.numpy(), np.eye(3), atol=ATOL)
    np.testing.assert_allclose(ident.translation.numpy(), 0, atol=1e-6)
    i = ft.RigidTransform.identity(device="cpu")
    assert torch.equal(i.rotation, torch.eye(3))
    assert torch.equal(i.translation, torch.zeros(3))


@pytest.mark.parametrize("w", [(0.0, 0.0, 0.0), (1e-8, -2e-8, 3e-9),
                               (0.1, -0.2, 0.3), (1.0, 0.5, -0.7)])
def test_rotation_exp_log_match_jax(w):
    wt = torch.tensor(w, dtype=torch.float32)
    R = tt.rotation_exp(wt)
    np.testing.assert_allclose(
        R.numpy(), np.asarray(jt.rotation_exp(jnp.asarray(w, jnp.float32))),
        atol=ATOL)
    np.testing.assert_allclose(
        tt.rotation_log(R).numpy(),
        np.asarray(jt.rotation_log(jnp.asarray(R.numpy()))), atol=ATOL)
    np.testing.assert_allclose(tt.rotation_log(R).numpy(), w, atol=1e-5)


@pytest.mark.parametrize("mask_kind", [None, "bool", "float"])
def test_rmse_matches_jax(mask_kind):
    rng = np.random.default_rng(4)
    p = rng.normal(size=(97, 3)).astype(np.float32)
    q = rng.normal(size=(97, 3)).astype(np.float32)
    mask = {None: None, "bool": rng.uniform(size=97) < 0.6,
            "float": rng.uniform(size=97).astype(np.float32)}[mask_kind]
    got = ft.rmse(torch.as_tensor(p), torch.as_tensor(q),
                  None if mask is None else torch.as_tensor(mask))
    want = f.rmse(jnp.asarray(p), jnp.asarray(q),
                  None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(float(got), float(want), atol=ATOL)


def test_transform_rmse_matches_jax():
    a1, b1 = _pair(5)
    a2, b2 = _pair(6)
    pts = np.random.default_rng(7).uniform(-1, 1, (64, 3)).astype(np.float32)
    np.testing.assert_allclose(
        float(ft.transform_rmse(a1, a2, torch.as_tensor(pts))),
        float(f.transform_rmse(b1, b2, jnp.asarray(pts))), atol=ATOL)


def test_clouds_match_jax():
    pts = np.random.default_rng(8).normal(size=(13, 3)).astype(np.float32)
    a = ft.pad_cloud(torch.as_tensor(pts), multiple=8)
    b = f.pad_cloud(jnp.asarray(pts), multiple=8)
    np.testing.assert_array_equal(a.points.numpy(), np.asarray(b.points))
    np.testing.assert_array_equal(a.mask.numpy(), np.asarray(b.mask))
    assert a.capacity == 16 and int(a.count()) == 13
    assert ft.pad_cloud(torch.as_tensor(pts), capacity=20).capacity == 20
    with pytest.raises(ValueError):
        ft.pad_cloud(torch.as_tensor(pts), capacity=4)
    assert [round_up(x, 8) for x in (0, 1, 8, 9)] == [0, 8, 8, 16]
    with pytest.raises(ValueError):
        as_points(np.zeros((4, 2)), device="cpu")


JAX_CONFIGS = [
    {},
    {"matcher": "pallas", "pallas_mode": "highest", "max_iterations": 60},
    {"metric": "plane", "damping": 0.1, "max_correspondence_dist": 0.5},
    {"matcher": "morton", "morton_shifts": 2, "morton_rescue": 512,
     "robust_loss": "tukey", "auto_trim": 9.0},
    {"solver": "polar", "strict_reference": True, "tolerance": 0.0},
]


@pytest.mark.parametrize("kwargs", JAX_CONFIGS)
def test_config_round_trip_from_jax(kwargs):
    d = dataclasses.asdict(f.ICPConfig(**kwargs))
    cfg = config_from_dict(d)
    assert dataclasses.asdict(cfg) == d
    assert set(d) == set(ft.ICPConfig.__dataclass_fields__)


@pytest.mark.parametrize("bad", [
    {"metric": "line"}, {"solver": "qr"}, {"matcher": "kd"},
    {"robust_loss": "cauchy"}, {"pallas_mode": "fast"},
    {"morton_rescue": -1}, {"gicp_epsilon": 0.0},
])
def test_config_validation_matches_jax(bad):
    with pytest.raises(ValueError):
        f.ICPConfig(**bad)
    with pytest.raises(ValueError):
        ft.ICPConfig(**bad)


@pytest.mark.parametrize("kwargs", [
    {"metric": "gicp"}, {"metric": "gicp", "matcher": "morton"},
    {"matcher": "grid"}, {"matcher": "grid", "metric": "plane"},
])
def test_values_outside_the_slice_raise_at_run(kwargs):
    """The config values that once raised ``NotImplementedError`` (GICP
    and the grid matcher) now run, to the JAX package's iterations and
    within 1e-5 of its transform, JAX's normals handed to both."""
    s = f.synthetic_scene(width=16)
    src, tgt = np.array(s.source), np.array(s.target)
    if kwargs.get("matcher") in ("grid", "morton"):  # near the target
        src = np.array(s.ground_truth.inverse().apply(jnp.asarray(tgt))
                       + 0.003)
    normals = {}
    if kwargs.get("metric") in ("gicp", "plane"):
        normals = {k: np.array(f.estimate_normals(jnp.asarray(c)))
                   for k, c in (("source_normals", src),
                                ("target_normals", tgt))}
        if kwargs["metric"] == "plane":
            del normals["source_normals"]
    j = f.run_icp(jnp.asarray(src), jnp.asarray(tgt),
                  f.ICPConfig(max_iterations=40, **kwargs),
                  **{k: jnp.asarray(v) for k, v in normals.items()})
    t = ft.run_icp(torch.as_tensor(src), torch.as_tensor(tgt),
                   ft.ICPConfig(max_iterations=40, **kwargs),
                   **{k: torch.as_tensor(v) for k, v in normals.items()})
    assert int(t.num_iterations) == int(j.num_iterations)
    tj = ft.RigidTransform(torch.as_tensor(np.array(j.transform.rotation)),
                           torch.as_tensor(np.array(j.transform.translation)))
    assert float(ft.transform_rmse(t.transform, tj,
                                   torch.as_tensor(src))) < 1e-5


def test_interop_transform_and_result():
    b = f.gt_transform((0.1, 0.2, 0.3), (0.3, 0.2, 0.1))
    a = transform_from_numpy(np.asarray(b.rotation), np.asarray(b.translation),
                             device="cpu")
    assert a.rotation.dtype == torch.float32
    np.testing.assert_array_equal(a.rotation.numpy(), np.asarray(b.rotation))
    s = ft.synthetic_scene(width=8, device="cpu")
    out = result_to_numpy(ft.run_icp(s.source, s.target,
                                     ft.ICPConfig(max_iterations=5)))
    assert set(out) == {"rotation", "translation", "errors",
                        "num_iterations", "converged", "points",
                        "matched_fraction", "delta_t", "delta_rot"}
    assert out["errors"].shape == (5,) and out["points"].shape == (64, 3)


def test_precision_is_pinned_by_entry_points():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("medium")
    s = ft.synthetic_scene(width=4, device="cpu")
    ft.run_icp(s.source, s.target, ft.ICPConfig(max_iterations=1))
    from fpcr_tpu_torch.utils.precision import precision_settings

    assert list(precision_settings().values()) == [False, False, "highest"]


def test_package_never_imports_jax_or_fpcr_tpu():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|fpcr_tpu)(\.|\s|$)",
                         re.M)
    files = sorted((ROOT / "fpcr_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        assert not pattern.search(path.read_text()), path


def test_imports_and_registers_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['fpcr_tpu'] = None\n"
        "import fpcr_tpu_torch as ft\n"
        "s = ft.synthetic_scene(width=16, device='cpu')\n"
        "r = ft.run_icp(s.source, s.target, ft.ICPConfig(max_iterations=40))\n"
        "e = float(ft.transform_rmse(r.transform, s.ground_truth, s.source))\n"
        "assert e < 1e-4, e\n"
        "for run in (lambda: ft.icp_generalized(s.source, s.target),\n"
        "            lambda: ft.run_aa_icp(s.source, s.target),\n"
        "            lambda: ft.run_scaled_icp(s.source, s.target)):\n"
        "    g = float(ft.transform_rmse(run().transform, s.ground_truth,\n"
        "                                s.source))\n"
        "    assert g < 1e-4, g\n"
        "r = ft.run_sgd_icp(s.source, s.target, batch_size=64)\n"
        "assert bool(r.converged)\n"
        "near = s.ground_truth.inverse().apply(s.target) + 0.003\n"
        "r = ft.run_icp(near, s.target, ft.ICPConfig(matcher='grid'))\n"
        "assert float(ft.rmse(r.transform.apply(near), s.target)) < 5e-3\n"
        "c, v = ft.voxel_downsample(s.source, 0.5)\n"
        "assert 0 < int(v.sum()) < 256\n"
        "q = ft.evaluate_registration(near, s.target, r.transform)\n"
        "assert float(q['fitness']) == 1.0\n"
        "ft.profile_icp(s.source, s.target, ft.ICPConfig(), iterations=2)\n"
        "import torch\n"
        "b = ft.register_batch(torch.stack([s.source] * 2),\n"
        "                      torch.stack([s.target] * 2))\n"
        "assert tuple(b.num_iterations.shape) == (2,)\n"
        "h = ft.run_icp_with_history(s.source, s.target)\n"
        "assert abs(int(h.num_iterations) - int(b.num_iterations[0])) <= 1\n"
        "frames = torch.stack([s.source, near, s.source])\n"
        "odo = ft.register_sequence(frames)\n"
        "ei, ej, Z, w = ft.detect_loop_closures(frames, odo, min_separation=2,\n"
        "                                       max_error=1e-2)\n"
        "ft.close_loops(odo, ei, ej, Z, w, iterations=2)\n"
        "ft.build_map(frames, odo.poses, 0.2)\n"
        "ft.registration_covariance(s.source, s.target, r.transform)\n"
        "g = ft.register(s.source, s.target, method='global')\n"
        "assert g.transform.rotation.shape == (3, 3)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "               for m, v in sys.modules.items() if v is not None)\n"
        "import fpcr_tpu_torch._build as b\n"
        "assert b._lib is None  # importing and running on CPU built nothing\n"
        "print('ok', e)\n")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
