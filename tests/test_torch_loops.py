"""The port's loop variants against ``fpcr_tpu``'s on the same numpy inputs
(CPU): the Umeyama solve and scaled ICP, Anderson-accelerated AA-ICP with
its safeguard's decisions, and SGD-ICP fed the JAX package's own batches."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fpcr_tpu as f
import fpcr_tpu_torch as ft
from fpcr_tpu.core import transforms as jtr
from fpcr_tpu.models import anderson as ja
from fpcr_tpu.models.sgd_icp import run_sgd_icp as j_sgd
from fpcr_tpu_torch.core import transforms as ttr
from fpcr_tpu_torch.models import anderson as ta
from fpcr_tpu_torch.models.icp import DONE_CHECK_EVERY
from fpcr_tpu_torch.models.sgd_icp import _sgd_loop

torch.set_num_threads(2)

GAP = 1e-5  # transform RMSE between the two packages' results


def _t(a):
    return torch.as_tensor(np.array(a))


def _rmse_between(a, b, probe):
    d = (probe @ np.asarray(a.rotation).T + np.asarray(a.translation)) - (
        probe @ np.asarray(b.rotation).T + np.asarray(b.translation))
    return float(np.sqrt((d * d).sum(1).mean()))


@pytest.mark.parametrize("w", [(0.0, 0.0, 0.0), (0.1, -0.2, 0.3),
                               (1e-8, 2e-8, -1e-8)])
def test_transform_vector_round_trip_matches_jax(w):
    x = np.array([*w, 0.3, -0.2, 0.1], np.float32)
    tt = ttr.vector_to_transform(_t(x))
    tj = jtr.vector_to_transform(jnp.asarray(x))
    np.testing.assert_allclose(tt.rotation.numpy(), np.asarray(tj.rotation),
                               atol=1e-6)
    np.testing.assert_allclose(ttr.transform_to_vector(tt).numpy(),
                               np.asarray(jtr.transform_to_vector(tj)),
                               atol=1e-6)
    np.testing.assert_allclose(ttr.transform_to_vector(tt).numpy(), x,
                               atol=1e-5)


def _similarity(seed, s_true, outliers=False):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(300, 3)).astype(np.float32)
    gt = f.gt_transform((0.2, -0.1, 0.3), (0.3, -0.2, 0.25))
    q = (s_true * np.asarray(gt.apply(jnp.asarray(p)))).astype(np.float32)
    mask = None
    if outliers:
        q[220:] = 100.0
        mask = np.arange(300) < 220
    return p, q, mask


@pytest.mark.parametrize("with_scale", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_umeyama_matches_jax(with_scale, masked):
    p, q, mask = _similarity(7, 1.37, outliers=masked)
    sj, tj = f.umeyama_transform(jnp.asarray(p), jnp.asarray(q),
                                 None if mask is None else jnp.asarray(mask),
                                 with_scale=with_scale)
    st, tt = ft.umeyama_transform(_t(p), _t(q),
                                  None if mask is None else _t(mask),
                                  with_scale=with_scale)
    assert st.shape == () and st.dtype == torch.float32
    np.testing.assert_allclose(float(st), float(sj), rtol=1e-6)
    np.testing.assert_allclose(tt.rotation.numpy(), np.asarray(tj.rotation),
                               atol=1e-6)
    np.testing.assert_allclose(tt.translation.numpy(),
                               np.asarray(tj.translation), atol=1e-5)
    if with_scale:
        assert abs(float(st) - 1.37) < 1e-4
    else:
        assert float(st) == 1.0


def test_umeyama_reflection_is_fixed():
    """A mirrored target: the sign fix keeps det R = +1, as JAX's."""
    p, q, _ = _similarity(8, 1.0)
    q[:, 2] = -q[:, 2]
    st, tt = ft.umeyama_transform(_t(p), _t(q))
    sj, tj = f.umeyama_transform(jnp.asarray(p), jnp.asarray(q))
    assert float(torch.linalg.det(tt.rotation)) == pytest.approx(1.0,
                                                                 abs=1e-5)
    np.testing.assert_allclose(tt.rotation.numpy(), np.asarray(tj.rotation),
                               atol=1e-5)
    np.testing.assert_allclose(float(st), float(sj), rtol=1e-5)


def _volume(n=1500, s_true=1.04):
    rng = np.random.default_rng(11)
    src = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    gt = f.gt_transform((0.01, -0.02, 0.015), (0.01, -0.008, 0.012))
    return src, np.array(s_true * gt.apply(jnp.asarray(src)))


@pytest.mark.parametrize("with_scale", [True, False])
def test_scaled_icp_matches_jax(with_scale):
    src, tgt = _volume()
    if not with_scale:
        s = f.synthetic_scene(width=24)
        src, tgt = np.array(s.source), np.array(s.target)
    cfg = dict(max_iterations=60)
    j = f.run_scaled_icp(jnp.asarray(src), jnp.asarray(tgt),
                         f.ICPConfig(**cfg), with_scale=with_scale)
    t = ft.run_scaled_icp(_t(src), _t(tgt), ft.ICPConfig(**cfg),
                          with_scale=with_scale)
    n = int(t.num_iterations)
    assert n == int(j.num_iterations) and bool(t.converged)
    np.testing.assert_allclose(float(t.scale), float(j.scale), rtol=1e-6)
    assert _rmse_between(t.transform, j.transform, src) < GAP
    np.testing.assert_allclose(t.errors.numpy()[:n],
                               np.asarray(j.errors)[:n], atol=1e-5)
    assert torch.isnan(t.errors[n:]).all()
    np.testing.assert_allclose(t.apply(_t(src)).numpy(), tgt, atol=5e-3)
    if with_scale:
        assert abs(float(t.scale) - 1.04) < 1e-3


def test_scaled_icp_masks_and_matcher_check():
    src, tgt = _volume(800)
    mask = np.arange(800) < 700
    j = f.run_scaled_icp(jnp.asarray(src), jnp.asarray(tgt),
                         f.ICPConfig(max_iterations=60),
                         source_mask=jnp.asarray(mask))
    t = ft.run_scaled_icp(_t(src), _t(tgt), ft.ICPConfig(max_iterations=60),
                          source_mask=_t(mask))
    assert int(t.num_iterations) == int(j.num_iterations)
    np.testing.assert_allclose(float(t.scale), float(j.scale), rtol=1e-6)
    for matcher in ("morton", "grid"):
        with pytest.raises(ValueError, match="exhaustive"):
            ft.run_scaled_icp(_t(src), _t(tgt), ft.ICPConfig(matcher=matcher))


def test_aa_mix_matches_jax():
    rng = np.random.default_rng(3)
    hx = rng.normal(size=(5, 6)).astype(np.float32)
    hf = (1e-2 * rng.normal(size=(5, 6))).astype(np.float32)
    x = rng.normal(size=6).astype(np.float32)
    fv = (1e-2 * rng.normal(size=6)).astype(np.float32)
    for n in range(6):
        got = ta._aa_mix(_t(hx), _t(hf), torch.tensor(n), _t(x), _t(fv),
                         1e-10)
        want = ja._aa_mix(jnp.asarray(hx), jnp.asarray(hf), jnp.int32(n),
                          jnp.asarray(x), jnp.asarray(fv), 1e-10)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)


AA_RUNS = {  # key: (scene, config fields)
    "point-32": ("synthetic-32", dict(max_iterations=60)),
    "plane-24": ("synthetic-24", dict(metric="plane", max_iterations=60)),
    # the expansion form's rounding settles grid near-ties differently in
    # the two packages (tests/test_torch_icp.py): the difference form here
    "huber-24": ("synthetic-24", dict(robust_loss="huber", max_iterations=60,
                                      exact_distances=True)),
    "rough": ("rough", dict(max_iterations=40, max_correspondence_dist=0.3)),
}


def _aa_scene(name):
    if name == "rough":  # partial overlap and noise: the safeguard rejects
        rng = np.random.default_rng(7)
        base = rng.uniform(-1.0, 1.0, size=(1200, 3)).astype(np.float32)
        gt = f.gt_transform((0.05, -0.03, 0.04), (0.05, -0.04, 0.06))
        tgt = np.array(gt.apply(jnp.asarray(base)))
        src = base[:840] + rng.normal(0.0, 5e-3, size=(840, 3)).astype(
            np.float32)
        return src, tgt, gt
    s = f.synthetic_scene(width=int(name.split("-")[1]))
    return np.array(s.source), np.array(s.target), s.ground_truth


@pytest.mark.parametrize("key", list(AA_RUNS))
def test_aa_icp_matches_jax(key):
    """The safeguard's decisions equal, iteration by iteration; equal
    iteration counts; transforms within 1e-5 of each other. The plane run
    takes JAX's target normals: on the regular grid the two packages'
    kNN settle a few near-ties apart (``tests/test_torch_normals.py``)."""
    scene, kw = AA_RUNS[key]
    src, tgt, gt = _aa_scene(scene)
    normals = None
    if kw.get("metric") == "plane":
        normals = np.array(f.estimate_normals(jnp.asarray(tgt)))
    jr, jacc = ja.run_aa_icp(
        jnp.asarray(src), jnp.asarray(tgt), f.ICPConfig(**kw),
        target_normals=None if normals is None else jnp.asarray(normals),
        return_accepted=True)
    tr, tacc = ft.run_aa_icp(
        _t(src), _t(tgt), ft.ICPConfig(**kw),
        target_normals=None if normals is None else _t(normals),
        return_accepted=True)
    n = int(tr.num_iterations)
    assert n == int(jr.num_iterations)
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    assert _rmse_between(tr.transform, jr.transform, src) < GAP
    for name in ("errors", "matched_fraction", "delta_t"):
        np.testing.assert_allclose(getattr(tr, name).numpy()[:n],
                                   np.asarray(getattr(jr, name))[:n],
                                   atol=1e-5, err_msg=name)
        assert torch.isnan(getattr(tr, name)[n:]).all()
    np.testing.assert_allclose(tr.points.numpy(), np.asarray(jr.points),
                               atol=1e-4)
    if key == "rough":
        assert not tacc[1:n].all()  # a rejection restarted the history
        assert _rmse_between(tr.transform, gt, src) < 0.01
    else:
        assert tacc[:n].any()
        assert _rmse_between(tr.transform, gt, src) < 1e-4


def test_aa_icp_fewer_iterations_than_plain():
    s = ft.synthetic_scene(width=32, device="cpu")
    cfg = ft.ICPConfig(max_iterations=60)
    plain = ft.run_icp(s.source, s.target, cfg)
    aa = ft.run_aa_icp(s.source, s.target, cfg)
    assert int(aa.num_iterations) < int(plain.num_iterations)
    assert float(ft.transform_rmse(aa.transform, s.ground_truth,
                                   s.source)) < 1e-5


def test_aa_icp_gicp_and_morton_match_jax():
    """AA-ICP over GICP with the Morton matcher (the inner step carries the
    source normals in the pre-sorted order), JAX's normals handed to both
    packages for the target."""
    src = np.array(f.synthetic_scene(width=32).source)
    gt = f.gt_transform((0.01, -0.02, 0.015), (0.02, -0.01, 0.02))
    tgt = np.array(gt.apply(jnp.asarray(src)))
    nrm = np.array(f.estimate_normals(jnp.asarray(tgt)))
    kw = dict(metric="gicp", matcher="morton", morton_impl="xla",
              max_iterations=25)
    jr = ja.run_aa_icp(jnp.asarray(src), jnp.asarray(tgt),
                       f.ICPConfig(**kw), target_normals=jnp.asarray(nrm))
    tr = ft.run_aa_icp(_t(src), _t(tgt), ft.ICPConfig(**kw),
                       target_normals=_t(nrm))
    assert abs(int(tr.num_iterations) - int(jr.num_iterations)) <= 1
    assert _rmse_between(tr.transform, jr.transform, src) < GAP
    assert _rmse_between(tr.transform, gt, src) < 1e-4
    np.testing.assert_allclose(tr.points.numpy(), np.asarray(jr.points),
                               atol=1e-4)


def _jax_draws(seed, n, batch, steps):
    """The JAX loop's batches: ``randint(fold_in(PRNGKey(seed), it))``."""
    key0 = jax.random.PRNGKey(seed)
    return [np.array(jax.random.randint(jax.random.fold_in(key0, it),
                                          (batch,), 0, n))
            for it in range(steps)]


@pytest.mark.parametrize("batch,seed", [(256, 3), (512, 0)])
def test_sgd_loop_fed_jax_draws_matches_jax(batch, seed):
    """``_sgd_loop`` fed the JAX package's ``fold_in`` batches: the moving
    average of the batch RMSE within 1e-5 of JAX's at every step, equal
    step counts and transforms within 1e-5."""
    s = f.synthetic_scene(width=32)
    src, tgt = np.array(s.source), np.array(s.target)
    cfg = dict(max_iterations=300, tolerance=1e-6)
    j = j_sgd(jnp.asarray(src), jnp.asarray(tgt), f.ICPConfig(**cfg),
              batch_size=batch, seed=seed)
    draws = _jax_draws(seed, src.shape[0], batch, cfg["max_iterations"])
    t = _sgd_loop(_t(src), _t(tgt), ft.ICPConfig(**cfg),
                  lambda it: torch.from_numpy(draws[it]).long(),
                  batch_size=batch, learning_rate=0.2, momentum=0.7,
                  ema=0.9, lr_decay=0.02)
    n = int(t.num_iterations)
    assert n == int(j.num_iterations) and bool(t.converged)
    for name in ("errors", "delta_t", "matched_fraction"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)), atol=1e-5,
                                   err_msg=name)
    assert _rmse_between(t.transform, j.transform, src) < GAP


def test_sgd_icp_recovers_ground_truth_with_the_torch_draw():
    """The torch generator's stream: deterministic per seed, advanced once
    a step, and the coarse-plus-polish pattern lands on the ground truth."""
    s = ft.synthetic_scene(width=32, device="cpu")
    cfg = ft.ICPConfig(max_iterations=300, tolerance=1e-6)
    a = ft.run_sgd_icp(s.source, s.target, cfg, batch_size=256, seed=3)
    b = ft.run_sgd_icp(s.source, s.target, cfg, batch_size=256, seed=3)
    c = ft.run_sgd_icp(s.source, s.target, cfg, batch_size=256, seed=4)
    assert torch.equal(a.transform.rotation, b.transform.rotation)
    assert not torch.equal(a.transform.rotation, c.transform.rotation)
    n = int(a.num_iterations)
    assert bool(a.converged) and n > 10 and n % DONE_CHECK_EVERY != 0
    e = a.errors[:n]
    assert torch.isfinite(e).all() and float(e[-1]) < 0.05 * float(e[0])
    assert torch.isnan(a.errors[n:]).all()
    assert float(ft.transform_rmse(a.transform, s.ground_truth,
                                   s.source)) < 1e-4
    polish = ft.run_icp(a.points, s.target, ft.ICPConfig(max_iterations=20))
    total = polish.transform.compose(a.transform)
    assert float(ft.transform_rmse(total, s.ground_truth, s.source)) < 1e-5


def jax_references():
    """The JAX package's CPU runs that set ``chip_smoke.py``'s AA-ICP,
    scaled-ICP and SGD-ICP thresholds and iteration counts (``AA_RUNS``,
    ``SCALED``, ``SGD``): its ``'xla'`` matcher, the card's scenes at full
    size."""
    s = f.synthetic_scene(128)
    for metric in ("point", "plane"):
        cfg = f.ICPConfig(metric=metric, max_iterations=60)
        r = ja.run_aa_icp(s.source, s.target, cfg)
        plain = f.run_icp(s.source, s.target, cfg)
        err = float(f.transform_rmse(r.transform, s.ground_truth, s.source))
        print(f"aa {metric}: {int(r.num_iterations)} iterations (plain "
              f"run_icp {int(plain.num_iterations)}), GT transform RMSE "
              f"{err:.3e}", flush=True)
    src = jnp.asarray(np.random.default_rng(11).uniform(-2, 2, (16384, 3)),
                      jnp.float32)
    gt = f.gt_transform((0.01, -0.02, 0.015), (0.01, -0.008, 0.012))
    tgt = 1.04 * gt.apply(src)
    r = f.run_scaled_icp(src, tgt, f.ICPConfig(max_iterations=60))
    print(f"scaled: {int(r.num_iterations)} iterations, |ds| "
          f"{abs(float(r.scale) - 1.04):.3e}, similarity RMSE "
          f"{float(f.rmse(r.apply(src), tgt)):.3e}", flush=True)
    b = f.bunny_scene()
    coarse = j_sgd(b.source, b.target,
                   f.ICPConfig(max_iterations=200, tolerance=1e-6),
                   batch_size=1024, seed=0)
    polish = f.run_icp(coarse.points, b.target,
                       f.ICPConfig(max_iterations=20))
    errs = [float(f.transform_rmse(t, b.ground_truth, b.source))
            for t in (coarse.transform,
                      polish.transform.compose(coarse.transform))]
    print(f"sgd: {int(coarse.num_iterations)} steps, GT transform RMSE "
          f"{errs[0]:.3e}, {errs[1]:.3e} after the polish", flush=True)


if __name__ == "__main__":
    jax_references()
