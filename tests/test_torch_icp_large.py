"""The port's large-N path against ``fpcr_tpu`` on the same numpy inputs
(CPU): ICP with the Morton band matcher (both geometries, dual shift, exact
rescue, masks, the plane and symmetric metrics), the coarse-to-fine
pipeline and ``tune_morton``; and a drive of the port with JAX unavailable.
The JAX package's 'pallas' band runs its TPU kernel in interpret mode; the
port's runs K3's plain version."""

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
from fpcr_tpu.models.icp import tune_morton as j_tune_morton
from fpcr_tpu.models.pipeline import icp_coarse_to_fine as j_c2f

from helpers import crossing_walls

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]

GAP = 1e-5  # transform RMSE between the two packages' results
NEAR = ((0.004, -0.003, 0.002), (0.002, -0.003, 0.002))  # near-registered GT


def _rmse_between(Ra, ta, Rb, tb, probe):
    d = (probe @ Ra.T + ta) - (probe @ Rb.T + tb)
    return float(np.sqrt((d * d).sum(1).mean()))


def _cloud(kind):
    if kind == "random":
        return np.random.default_rng(9).uniform(-2, 2, (2048, 3)).astype(
            np.float32)
    if kind == "walls":
        return crossing_walls(seed=7, n_half=1024)
    return np.array(f.synthetic_scene(width=int(kind)).source)


RUNS = {  # key: (cloud, config fields)
    "xla": ("random", dict()),
    "pallas": ("random", dict(morton_impl="pallas")),
    "production-band": ("random", dict(morton_impl="pallas",
                                       morton_chunk=512, morton_window=64)),
    "shifts-2": ("walls", dict(morton_shifts=2, morton_window=64)),
    "rescue": ("walls", dict(morton_rescue=256, morton_window=64)),
    "shifts-2-rescue-pallas": ("walls", dict(morton_shifts=2,
                                             morton_rescue=256,
                                             morton_impl="pallas")),
    "plane": ("32", dict(metric="plane")),
    "plane-pallas": ("32", dict(metric="plane", morton_impl="pallas")),
    "symmetric": ("32", dict(metric="symmetric", morton_impl="pallas")),
}


@pytest.mark.parametrize("key", list(RUNS))
def test_morton_icp_matches_jax(key):
    """Iteration counts within 1, transforms within 1e-5 RMSE of each
    other and 1e-4 of the ground truth, the output points in input row
    order."""
    cloud, kw = RUNS[key]
    src = _cloud(cloud)
    gt = f.gt_transform(*NEAR)
    tgt = np.array(gt.apply(jnp.asarray(src)))
    cfg = dict(matcher="morton", max_iterations=20, **kw)
    j = f.run_icp(jnp.asarray(src), jnp.asarray(tgt), f.ICPConfig(**cfg))
    t = ft.run_icp(torch.as_tensor(src), torch.as_tensor(tgt),
                   ft.ICPConfig(**cfg))
    nj, nt = int(j.num_iterations), int(t.num_iterations)
    assert abs(nj - nt) <= 1, (nj, nt)
    Rt, tt = t.transform.rotation.numpy(), t.transform.translation.numpy()
    assert _rmse_between(Rt, tt, np.asarray(j.transform.rotation),
                         np.asarray(j.transform.translation), src) < GAP
    assert _rmse_between(Rt, tt, np.asarray(gt.rotation),
                         np.asarray(gt.translation), src) < 1e-4
    np.testing.assert_allclose(t.points.numpy(), np.asarray(j.points),
                               atol=1e-5)
    # matched fractions while the error is above float32 noise: below it
    # the auto-trim gate is set by the trimmed mean of noise and cuts noise,
    # differently in each package
    k = min(nj, nt)
    signal = np.asarray(j.errors)[:k] > 1e-5
    np.testing.assert_allclose(t.matched_fraction[:k].numpy()[signal],
                               np.asarray(j.matched_fraction)[:k][signal],
                               atol=1e-3)


def test_morton_icp_with_masks_matches_jax():
    src = _cloud("random")
    gt = f.gt_transform(*NEAR)
    sp = f.pad_cloud(jnp.asarray(src), 256)
    tp = f.pad_cloud(gt.apply(jnp.asarray(src)), 384, pad_value=0.3)
    cfg = dict(matcher="morton", max_iterations=20)
    j = f.run_icp(sp.points, tp.points, f.ICPConfig(**cfg),
                  source_mask=sp.mask, target_mask=tp.mask)
    t = ft.run_icp(torch.tensor(np.array(sp.points)),
                   torch.tensor(np.array(tp.points)), ft.ICPConfig(**cfg),
                   source_mask=torch.tensor(np.array(sp.mask)),
                   target_mask=torch.tensor(np.array(tp.mask)))
    assert abs(int(j.num_iterations) - int(t.num_iterations)) <= 1
    assert _rmse_between(t.transform.rotation.numpy(),
                         t.transform.translation.numpy(),
                         np.asarray(j.transform.rotation),
                         np.asarray(j.transform.translation), src) < GAP


def test_rescue_rematches_the_worst_rows_through_nn_argmin():
    """``_exact_rescue`` replaces the band matches of the rows with the
    largest distance by exact ones and never makes a match worse."""
    from fpcr_tpu_torch.models.icp import (_correspondences,
                                           build_matcher_state)

    cloud = torch.as_tensor(crossing_walls(seed=3, n_half=1024))
    src = cloud + 0.002
    cfg = ft.ICPConfig(matcher="morton", morton_window=16)
    state = build_matcher_state(cloud, None, cfg)
    p = src[ft.source_morton_order(src, state[0][0]).long()]
    _, _, d0, _ = _correspondences(p, cloud, None, None, cfg, state)
    q1, _, d1, _ = _correspondences(
        p, cloud, None, None, ft.ICPConfig(matcher="morton", morton_window=16,
                                           morton_rescue=128), state)
    assert (d1 <= d0).all() and (d1 < d0).sum() > 0
    _, d_exact = ft.nn_argmin(p, cloud)
    worst = torch.sort(d0, descending=True, stable=True).indices[:128]
    torch.testing.assert_close(d1[worst], d_exact[worst])
    np.testing.assert_allclose(((p - q1) ** 2).sum(1).numpy(), d1.numpy(),
                               atol=1e-6)


def test_coarse_to_fine_matches_jax():
    s = f.synthetic_scene(width=40)
    src, tgt = np.array(s.source), np.array(s.target)
    kw = dict(coarse_points=512)
    coarse = dict(max_iterations=40)
    fine = dict(matcher="morton", max_iterations=20)
    j = j_c2f(jnp.asarray(src), jnp.asarray(tgt), f.ICPConfig(**coarse),
              f.ICPConfig(**fine), **kw)
    t = ft.icp_coarse_to_fine(torch.as_tensor(src), torch.as_tensor(tgt),
                              ft.ICPConfig(**coarse), ft.ICPConfig(**fine),
                              **kw)
    assert isinstance(t, ft.CoarseToFineResult)
    for a, b in ((t.coarse, j.coarse), (t.fine, j.fine)):
        assert abs(int(a.num_iterations) - int(b.num_iterations)) <= 1
    Rt, tt = t.transform.rotation.numpy(), t.transform.translation.numpy()
    assert _rmse_between(Rt, tt, np.asarray(j.transform.rotation),
                         np.asarray(j.transform.translation), src) < GAP
    assert _rmse_between(Rt, tt, np.array(s.ground_truth.rotation),
                         np.array(s.ground_truth.translation), src) < 1e-4


@pytest.mark.parametrize("cloud", ["walls", "benign"])
def test_tune_morton_matches_jax(cloud):
    """The probe ladder lands on the same config: escalated on the
    crossing walls, untouched on a uniform cloud."""
    if cloud == "walls":
        c = crossing_walls(seed=3, n_half=2048)
    else:
        c = np.random.default_rng(5).uniform(-1, 1, (4096, 3)).astype(
            np.float32)
    src = c + np.float32(0.002)
    j = j_tune_morton(jnp.asarray(src), jnp.asarray(c),
                      f.ICPConfig(matcher="morton"), sample=1024)
    t = ft.tune_morton(torch.as_tensor(src), torch.as_tensor(c),
                       ft.ICPConfig(matcher="morton"), sample=1024)
    assert (t.morton_shifts, t.morton_rescue) == (j.morton_shifts,
                                                  j.morton_rescue)
    if cloud == "walls":
        assert t.morton_shifts == 2 and t.morton_rescue > 0
    else:
        assert t == ft.ICPConfig(matcher="morton")


def test_plane_and_morton_run_without_jax():
    """What the card's machine sees: the package with JAX unavailable
    drives ``icp_point_to_plane`` and a morton registration on the CPU."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['fpcr_tpu'] = None\n"
        "import fpcr_tpu_torch as ft\n"
        "s = ft.synthetic_scene(width=24, device='cpu')\n"
        "r = ft.icp_point_to_plane(s.source, s.target, max_iterations=60)\n"
        "e = float(ft.transform_rmse(r.transform, s.ground_truth, s.source))\n"
        "assert e < 1e-4, e\n"
        "gt = ft.gt_transform((0.004, -0.002, 0.003),\n"
        "                     (0.002, -0.003, 0.002), device='cpu')\n"
        "for impl in ('auto', 'pallas'):\n"
        "    r = ft.run_icp(s.source, gt.apply(s.source), ft.ICPConfig(\n"
        "        matcher='morton', morton_impl=impl, max_iterations=20))\n"
        "    e = float(ft.transform_rmse(r.transform, gt, s.source))\n"
        "    assert e < 1e-4, e\n"
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
