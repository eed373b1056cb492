"""The port's NDT (``fpcr_tpu_torch.ops.ndt``, ``models.ndt``) against
``fpcr_tpu``'s on the same numpy inputs (CPU): the grid build, the lookups,
the coverage resolver, ``suggest_cell_size``, the config, and whole
registrations on the gather path, the XLA band and K4's band (its plain
version here; the JAX package's runs its TPU kernel in interpret mode); and
a drive of the port's NDT with JAX unavailable."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fpcr_tpu as f
import fpcr_tpu_torch as ft
from fpcr_tpu.models import ndt as jm
from fpcr_tpu.ops import ndt as jn
from fpcr_tpu.ops.grid import suggest_cell_size as j_suggest
from fpcr_tpu_torch.interop import ndt_config_from_dict, ndt_grid_from_numpy
from fpcr_tpu_torch.models import ndt as tm
from fpcr_tpu_torch.ops import ndt as tn
from fpcr_tpu_torch.ops.grid import suggest_cell_size as t_suggest

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]

# The grid sums run in the same sorted order in both packages, so counts and
# means agree bit for bit; the 3x3 eigensolve and the Vdiag(1/λ)Vᵀ product
# round differently, ~1e-5 of a row's largest |sinv| (eigenvalues clamped at
# 1% of the largest: condition ≤ 100 on ~1e-7 rounding).
SINV_REL = 1e-4
# Transforms of the two packages' runs: the same Gauss-Newton steps in
# another summation order (one stacked reduction here, per-offset sums
# there) agree to ~2e-7 RMSE on the gather and XLA paths; K4's band adds the
# TPU kernel's bf16-split Mahalanobis expansion (~1.6e-6), so 1e-5 holds all.
GAP = 1e-5


def _pts(seed, n=4000, scale=1.0, offset=0.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, scale, (n, 3)) + offset).astype(np.float32)


def _grids(pts, h, mask=None):
    gj = jn.build_ndt_grid(jnp.asarray(pts), h,
                           None if mask is None else jnp.asarray(mask))
    gt = tn.build_ndt_grid(torch.as_tensor(pts), h,
                           None if mask is None else torch.as_tensor(mask))
    return gj, gt


@pytest.mark.parametrize("case", ["uniform", "far-500", "masked"])
def test_build_ndt_grid_matches_jax(case):
    pts, mask = _pts(0), None
    if case == "far-500":
        pts = pts + np.float32(500.0)
    if case == "masked":
        junk = np.full((200, 3), 0.123, np.float32)  # would form a voxel
        pts = np.concatenate([pts, junk])
        mask = np.arange(pts.shape[0]) < 4000
    gj, gt = _grids(pts, 0.25, mask)
    for field in ("keys", "valid", "lo", "voxel_size", "mu"):
        np.testing.assert_array_equal(getattr(gt, field).numpy(),
                                      np.asarray(getattr(gj, field)),
                                      err_msg=field)
    assert gt.keys.dtype == torch.int32 and gt.valid.dtype == torch.bool
    sj, st = np.asarray(gj.sinv), gt.sinv.numpy()
    scale = np.abs(sj).reshape(-1, 9).max(axis=1)[:, None, None] + 1e-30
    np.testing.assert_allclose(st / scale, sj / scale, atol=SINV_REL)
    tj, tt = np.asarray(gj.table), gt.table.numpy()
    np.testing.assert_array_equal(tt[:, [0, 1, 2, 9, 10, 11, 12, 13, 14, 15]],
                                  tj[:, [0, 1, 2, 9, 10, 11, 12, 13, 14, 15]])
    assert gt.valid.sum() > 20


@pytest.mark.parametrize("offset", tn.DIRECT7_OFFSETS)
def test_lookups_match_jax_per_offset(offset):
    """``ndt_lookup`` and ``ndt_lookup_banded`` on the JAX package's grid:
    hits equal, and ``mu`` and ``sinv`` bit for bit on the hits."""
    pts = _pts(21, 6000, scale=2.0)
    rng = np.random.default_rng(22)
    gj = jn.build_ndt_grid(jnp.asarray(pts), 0.25)
    src = pts + rng.normal(0, 0.02, pts.shape).astype(np.float32)
    src[:50] -= 2.5  # off the grid
    src = src[np.asarray(jn.cell_key_order(jnp.asarray(src), gj))]
    gt = ndt_grid_from_numpy(gj, device="cpu")
    o = None if offset is None else jnp.asarray(offset, jnp.int32)
    for jf, tf, kw in ((jn.ndt_lookup, tn.ndt_lookup, {}),
                       (jn.ndt_lookup_banded, tn.ndt_lookup_banded,
                        dict(chunk=256, window=64))):
        mj, sj, hj = (np.asarray(a) for a in
                      jf(jnp.asarray(src), gj, cell_offset=o, **kw))
        mt, st, ht = (a.numpy() for a in
                      tf(torch.as_tensor(src), gt, offset, **kw))
        np.testing.assert_array_equal(ht, hj)
        np.testing.assert_array_equal(mt[hj], mj[hj])
        np.testing.assert_array_equal(st, sj)  # zero on the misses
        assert hj.mean() > 0.5
    # the narrow band misses where the gather path hits, never the reverse
    _, _, h_band = tn.ndt_lookup_banded(torch.as_tensor(src), gt, offset,
                                        chunk=128, window=1)
    _, _, h_all = tn.ndt_lookup(torch.as_tensor(src), gt, offset)
    assert not (h_band & ~h_all).any()


def test_cell_key_order_and_gauss_constants_match_jax():
    pts = _pts(3, 3000, scale=2.0)
    q = np.round(pts * 8) / 8  # many equal keys: the stable sorts must agree
    gj, gt = _grids(pts, 0.25)
    np.testing.assert_array_equal(
        tn.cell_key_order(torch.as_tensor(q), gt).numpy(),
        np.asarray(jn.cell_key_order(jnp.asarray(q), gj)))
    for ratio, res in ((0.55, 0.12), (0.55, 1.0), (0.3, 0.4)):
        assert tn.gauss_d1_d2(ratio, res) == jn.gauss_d1_d2(ratio, res)


@pytest.mark.parametrize("kind", ["grid", "far", "duplicates"])
def test_suggest_cell_size_matches_jax(kind):
    """The port takes the 2-NN spacing in the difference form, the JAX
    package in the expansion form, whose float32 rounding is ~1e-7·|p|²
    (|p|² ≤ 8 here) on d² ≈ 7e-3: ~1e-4 of d², 5e-5 of the spacing, hence
    rel 2e-4. On duplicates the expansion form can leave ~1e-7 where the
    difference form gives 0, so the port needs the exact form to fall back
    to the extent-based size as the JAX package does."""
    src = np.array(f.synthetic_scene(width=48).source)
    if kind == "far":
        src = src + np.float32(500.0)
    if kind == "duplicates":
        src = np.repeat(src[:300], 3, axis=0)
    want = float(j_suggest(jnp.asarray(src), scale=6.0))
    got = float(t_suggest(torch.as_tensor(src), scale=6.0))
    assert got == pytest.approx(want, rel=2e-4)


def _sheets():
    """Dense (y, z) sheets at six x stations: x-planes of ~400 table rows
    (the escalation scene of ``tests/test_ndt.py``)."""
    rng = np.random.default_rng(7)
    ys, zs = np.meshgrid(np.linspace(0, 5.0, 40, dtype=np.float32),
                         np.linspace(0, 5.0, 40, dtype=np.float32),
                         indexing="ij")
    sheets = [np.stack([np.full(ys.size, 0.25 * xi, np.float32), ys.ravel(),
                        zs.ravel()], 1) for xi in range(6)]
    pts = np.concatenate([s + rng.normal(0, 0.01, s.shape).astype(np.float32)
                          for s in sheets])
    for _ in range(2):
        pts = np.concatenate(
            [pts, pts + rng.normal(0, 0.01, pts.shape).astype(np.float32)])
    return pts, pts[:4096] + np.float32(0.02), 0.25


def _cap_grid():
    """Two x-planes, each wider than the window cap (``tests/test_ndt.py``)."""
    m = 2 * (jm._FUSED_WINDOW_CAP + 1024)
    cx = np.repeat(np.array([3, 4], np.int64), m // 2)
    cy = np.tile(np.arange(m // 2, dtype=np.int64) // 64, 2)
    cz = np.tile(np.arange(m // 2, dtype=np.int64) % 64, 2)
    return jn.NDTGrid(keys=jnp.asarray(np.sort((cx << 20) | (cy << 10) | cz),
                                       jnp.int32),
                      mu=jnp.zeros((m, 3)), sinv=jnp.zeros((m, 3, 3)),
                      valid=jnp.ones((m,), bool), lo=jnp.zeros((3,)),
                      voxel_size=jnp.float32(0.25), table=jnp.zeros((m, 16)))


def test_narrow_band_misses_as_the_tpu_kernel():
    """The banded miss semantics of K4's plain version: a window narrower
    than the cloud's x-planes loses face neighbours, row for row as the TPU
    kernel (interpret mode) does."""
    from fpcr_tpu.ops.ndt_pallas import ndt_fused_moments as j_fused
    from fpcr_tpu.ops.ndt_pallas import prepare_fused_tables as j_tables

    pts, src, h = _sheets()
    gj = jn.build_ndt_grid(jnp.asarray(pts), h)
    src = src[np.asarray(jn.cell_key_order(jnp.asarray(src), gj))]
    d1, d2 = jn.gauss_d1_d2(0.55, h)
    kw = dict(voxel_size=h, d1=abs(d1), d2=d2, chunk=256, window=256)
    gt = ndt_grid_from_numpy(gj, device="cpu")
    rows, _ = tn.ndt_fused_moments(torch.as_tensor(src), gt,
                                   tn.prepare_fused_tables(gt), **kw)
    rj, _ = j_fused(jnp.asarray(src), gj, j_tables(gj), interpret=True, **kw)
    _, _, count, _ = jn.reference_neighborhood_moments(
        jnp.asarray(src), gj, abs(d1), d2)
    np.testing.assert_array_equal(rows[:, 10].numpy(), np.asarray(rj)[:, 10])
    assert (rows[:, 10].numpy() < count).any()


RESOLVE = {  # name: (scene, config fields)
    "escalation": ("sheets", dict(lookup="banded", lookup_impl="pallas",
                                  lookup_chunk=256, lookup_window=256)),
    "escalation-auto-window": ("sheets", dict(lookup="banded",
                                              lookup_impl="pallas")),
    "cap-fallback": ("cap", dict(lookup="banded", lookup_impl="auto")),
    "cap-explicit-pallas": ("cap", dict(lookup="banded",
                                        lookup_impl="pallas")),
    "auto-shrink": ("surface", dict(lookup="banded", lookup_impl="pallas",
                                    lookup_chunk=256)),
    "explicit-window": ("surface", dict(lookup="banded",
                                        lookup_impl="pallas",
                                        lookup_chunk=256, lookup_window=512)),
    "auto-on-cpu": ("surface", dict(lookup="banded")),
    "gather": ("surface", dict(lookup="gather")),
    "auto-lookup-small": ("surface", dict()),
}


@pytest.mark.parametrize("name", list(RESOLVE))
def test_resolver_matches_jax(name):
    scene, kw = RESOLVE[name]
    src = None
    if scene == "cap":
        gj = _cap_grid()
    elif scene == "sheets":
        pts, src, h = _sheets()
        gj = jn.build_ndt_grid(jnp.asarray(pts), h)
    else:  # coarse voxels on the saddle: small x-planes
        s = f.synthetic_scene(width=96)
        gj = jn.build_ndt_grid(s.target, 0.4)
        src = np.asarray(s.source)
    if src is not None:
        src = src[np.asarray(jn.cell_key_order(jnp.asarray(src), gj))]
    gt = ndt_grid_from_numpy(gj, device="cpu")
    if src is None:
        j = jm._resolve_fused(jm.NDTConfig(**kw), gj)
        t = tm._resolve_fused(tm.NDTConfig(**kw), gt)
    else:
        j = jm.resolve_ndt_config(jm.NDTConfig(**kw), gj, jnp.asarray(src))
        t = tm.resolve_ndt_config(tm.NDTConfig(**kw), gt,
                                  torch.as_tensor(src))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    if name == "escalation":
        assert t.lookup_window > 256
    if name == "cap-fallback":
        assert t.lookup_impl == "xla"


BAD_CONFIGS = [dict(voxel_size=-1.0), dict(outlier_ratio=1.5),
               dict(neighborhood="direct27"), dict(lookup="hash"),
               dict(lookup_impl="cuda"), dict(lookup_chunk=0),
               dict(lookup_chunk=100), dict(lookup_window=-1)]


@pytest.mark.parametrize("kw", BAD_CONFIGS)
def test_config_validation_matches_jax(kw):
    with pytest.raises(ValueError) as ej:
        jm.NDTConfig(**kw)
    with pytest.raises(ValueError) as et:
        tm.NDTConfig(**kw)
    assert str(et.value) == str(ej.value)
    good = jm.NDTConfig(voxel_size=0.3, lookup="banded")
    assert dataclasses.asdict(ndt_config_from_dict(
        dataclasses.asdict(good))) == dataclasses.asdict(good)


def _rmse_between(Ra, ta, Rb, tb, probe):
    d = (probe @ Ra.T + ta) - (probe @ Rb.T + tb)
    return float(np.sqrt((d * d).sum(1).mean()))


RUNS = {
    "gather": dict(lookup="gather"),
    "banded-xla": dict(lookup="banded", lookup_impl="xla", lookup_chunk=256,
                       lookup_window=256),
    "banded-pallas": dict(lookup="banded", lookup_impl="pallas",
                          lookup_chunk=256, lookup_window=256),
}


@pytest.mark.parametrize("key", list(RUNS))
def test_run_ndt_matches_jax(key):
    """Iterations within 1, transforms within ``GAP`` of each other and
    5e-3 of the ground truth (NDT's own contract), errors within 1e-4
    relative, the output points in the input row order."""
    scene = f.synthetic_scene(width=48)
    gt = f.gt_transform((0.02, -0.015, 0.01), (0.03, -0.02, 0.015))
    src = np.array(scene.source)
    tgt = np.array(gt.apply(scene.source))
    cfg = dict(voxel_size=0.4, max_iterations=60, **RUNS[key])
    j = jm.run_ndt(jnp.asarray(src), jnp.asarray(tgt), jm.NDTConfig(**cfg))
    t = tm.run_ndt(torch.as_tensor(src), torch.as_tensor(tgt),
                   tm.NDTConfig(**cfg))
    nj, nt = int(j.num_iterations), int(t.num_iterations)
    assert abs(nj - nt) <= 1, (nj, nt)
    assert bool(t.converged) and bool(j.converged)
    Rt, tt = t.transform.rotation.numpy(), t.transform.translation.numpy()
    assert _rmse_between(Rt, tt, np.asarray(j.transform.rotation),
                         np.asarray(j.transform.translation), src) < GAP
    assert _rmse_between(Rt, tt, np.asarray(gt.rotation),
                         np.asarray(gt.translation), src) < 5e-3
    k = min(nj, nt)
    np.testing.assert_allclose(t.errors[:k].numpy(),
                               np.asarray(j.errors)[:k], rtol=1e-4)
    assert torch.isnan(t.errors[nt:]).all()
    assert float(t.matched_fraction) == pytest.approx(
        float(j.matched_fraction), abs=1e-6)
    np.testing.assert_allclose(t.points.numpy(), src @ Rt.T + tt, atol=1e-6)


def test_prebuilt_grid_and_resolved_config_match_fresh_run():
    scene = ft.synthetic_scene(width=48, device="cpu")
    grid = ft.build_ndt_grid(scene.source, 0.3)
    base = ft.NDTConfig(voxel_size=0.3, max_iterations=25, lookup="banded",
                        lookup_impl="pallas", lookup_chunk=256)
    resolved = ft.resolve_ndt_config(base, grid, scene.source)
    assert resolved.lookup_resolved and resolved.lookup_window is not None
    gt = ft.gt_transform((0.02, -0.01, 0.015), (0.01, -0.02, 0.01),
                         device="cpu")
    scan = gt.apply(scene.source)
    a = ft.run_ndt(scan, scene.source, resolved, grid=grid)
    b = ft.run_ndt(scan, scene.source, base, grid=grid)
    assert torch.allclose(a.transform.rotation, b.transform.rotation,
                          atol=1e-6)
    assert float(ft.transform_rmse(a.transform, gt.inverse(), scan)) < 5e-3
    with pytest.raises(ValueError, match="resolve_ndt_config"):
        ft.run_ndt(scan, scene.source,
                   dataclasses.replace(base, lookup_resolved=True),
                   grid=grid)


def test_register_ndt_large_displacement():
    """NDT coarse + fine init, then ICP: the exact-ICP contract."""
    scene = ft.synthetic_scene(width=48, device="cpu")
    gt = ft.gt_transform((0.25, -0.2, 0.15), (0.3, -0.25, 0.2), device="cpu")
    tgt = gt.apply(scene.source)
    res = ft.register_ndt(scene.source, tgt, ft.ICPConfig(max_iterations=40))
    assert float(ft.transform_rmse(res.transform, gt, scene.source)) < 1e-5


def test_disjoint_clouds_not_converged():
    a = torch.as_tensor(_pts(9, 1000))
    res = ft.run_ndt(a, a + 100.0, ft.NDTConfig(voxel_size=0.25,
                                                max_iterations=10))
    assert float(res.matched_fraction) == 0.0
    assert not bool(res.converged)


def test_grid_voxel_size_mismatch_raises():
    scene = ft.synthetic_scene(width=24, device="cpu")
    grid = ft.build_ndt_grid(scene.source, 0.5)
    with pytest.raises(ValueError, match="voxel_size"):
        ft.run_ndt(scene.source, scene.source, ft.NDTConfig(voxel_size=0.3),
                   grid=grid)
    res = ft.run_ndt(scene.source, scene.source,
                     ft.NDTConfig(voxel_size=0.5, max_iterations=5),
                     grid=grid)
    assert bool(torch.isfinite(res.errors[0]))


def test_ndt_runs_without_jax():
    """What the card's machine sees: the package with JAX unavailable
    resolves a config and runs NDT on K4's band (its plain version) and the
    wide-basin ``register_ndt`` on the CPU."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['fpcr_tpu'] = None\n"
        "import fpcr_tpu_torch as ft\n"
        "s = ft.synthetic_scene(width=32, device='cpu')\n"
        "grid = ft.build_ndt_grid(s.source, 0.4)\n"
        "cfg = ft.resolve_ndt_config(ft.NDTConfig(lookup='banded',\n"
        "    lookup_impl='pallas', lookup_chunk=128), grid, s.source)\n"
        "gt = ft.gt_transform((0.02, -0.01, 0.015), (0.01, -0.02, 0.01),\n"
        "                     device='cpu')\n"
        "scan = gt.apply(s.source)\n"
        "r = ft.run_ndt(scan, s.source, cfg, grid=grid)\n"
        "e = float(ft.transform_rmse(r.transform, gt.inverse(), scan))\n"
        "assert bool(r.converged) and e < 5e-3, e\n"
        "gt = ft.gt_transform((0.25, -0.2, 0.15), (0.3, -0.25, 0.2),\n"
        "                     device='cpu')\n"
        "r = ft.register_ndt(s.source, gt.apply(s.source))\n"
        "e = float(ft.transform_rmse(r.transform, gt, s.source))\n"
        "assert e < 1e-4, e\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "               for m, v in sys.modules.items() if v is not None)\n"
        "import fpcr_tpu_torch._build as b\n"
        "assert b._lib is None  # nothing was built on the CPU\n"
        "print('ok')\n")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
