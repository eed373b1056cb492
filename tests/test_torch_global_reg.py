"""FPFH and global registration in the port against ``fpcr_tpu`` on the same
numpy inputs (CPU): the Darboux pair features and their histogram bins,
``fpfh_features`` on a non-grid cloud (grid clouds flip k-th near ties, see
ROADMAP §3), the feature search ``nn_argmin_features`` against the JAX
package's dimension-generic XLA ``nn_argmin``, RANSAC fed JAX's own
``categorical`` draws through the private seam ``_ransac`` (equal inlier
counts, transforms within 1e-5), and the whole pipeline on Bunny under a
1.2-rad pose, where plain ICP fails and ``register_global`` reaches 1e-6.

Run as a script, it prints the JAX package's CPU runs that set
``chip_smoke.py``'s global-registration thresholds (``GLOBAL``):

    PYTHONPATH=. python tests/test_torch_global_reg.py
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fpcr_tpu as f
import fpcr_tpu_torch as ft
from fpcr_tpu.data.bunny import load_bunny
from fpcr_tpu.models import global_reg as jgr
from fpcr_tpu.ops import fpfh as jfp
from fpcr_tpu.ops.matching import gather_correspondences as jgather
from fpcr_tpu.ops.matching import nn_argmin as j_nn
from fpcr_tpu.ops.normals import estimate_normals as j_normals
from fpcr_tpu.ops.normals import orient_normals as j_orient
from fpcr_tpu.ops.normals import self_knn as j_self_knn
from fpcr_tpu_torch.models import global_reg as tgr
from fpcr_tpu_torch.ops import fpfh as tfp
from fpcr_tpu_torch.ops.matching import nn_argmin_features

torch.set_num_threads(2)

GAP = 1e-5  # transform RMSE between the two packages' results


def _t(a):
    return torch.as_tensor(np.array(a))


def _rmse_between(ra, ta, rb, tb, probe):
    d = (probe @ np.asarray(ra).T + np.asarray(ta)) - (
        probe @ np.asarray(rb).T + np.asarray(tb))
    return float(np.sqrt((d * d).sum(1).mean()))


def _wavy(n=1500, seed=2):
    """A random (non-grid) wavy saddle: no kNN near ties."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-2, 2, (n, 2))
    z = 0.25 * (xy[:, 0] ** 2 - xy[:, 1] ** 2) + 0.1 * np.sin(3 * xy[:, 0])
    return np.stack([xy[:, 0], xy[:, 1], z], 1).astype(np.float32)


def _jittered(seed=2):
    """A 40 x 40 grid of spacing 0.1 on the wavy saddle, each point moved
    by U(±0.02): no kNN near ties, and no neighbour closer than 0.06, so
    the 1/distance weights keep the kNN's expansion-form rounding (~1e-6
    of a squared distance, in each package its own) below 3e-4 relative."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(np.arange(40), np.arange(40)), -1).reshape(
        -1, 2) * 0.1 - 2.0
    xy = g + rng.uniform(-0.02, 0.02, g.shape)
    z = 0.25 * (xy[:, 0] ** 2 - xy[:, 1] ** 2) + 0.1 * np.sin(3 * xy[:, 0])
    return np.stack([xy[:, 0], xy[:, 1], z], 1).astype(np.float32)


def _oriented(points):
    return np.asarray(j_orient(jnp.asarray(points),
                               j_normals(jnp.asarray(points), k=8)))


def _edge_points(pts, nrm, idx):
    """Points with a neighbour pair whose JAX feature lies within 1e-5 of
    a histogram bin edge (the two packages may bin it apart)."""
    f1, f2, f3, _ = jfp._pair_features(
        jnp.asarray(pts)[:, None], jnp.asarray(nrm)[:, None],
        jnp.asarray(pts)[idx], jnp.asarray(nrm)[idx])
    edge = np.zeros(idx.shape, bool)
    for a, (lo, hi) in zip((f1, f2, f3), [(-1.0, 1.0), (-1.0, 1.0),
                                          (-np.pi, np.pi)]):
        pos = (np.asarray(a) - lo) / (hi - lo) * 11
        edge |= np.abs(pos - np.round(pos)) < 1e-5 * 11
    return edge


def test_pair_features_and_bins_match_jax():
    """The Darboux features of every (point, neighbour) pair on JAX's
    neighbours within 2e-6 of JAX's, and every histogram bin equal but
    where JAX's value lies within 1e-5 of a bin edge (the two round the
    cross products and the atan2 apart)."""
    pts = _wavy()
    nrm = _oriented(pts)
    idx, _ = j_self_knn(jnp.asarray(pts), 17)
    idx = np.array(idx)[:, 1:]
    jf = jfp._pair_features(jnp.asarray(pts)[:, None], jnp.asarray(nrm)[:,
                            None], jnp.asarray(pts)[idx],
                            jnp.asarray(nrm)[idx])
    tf = tfp._pair_features(_t(pts)[:, None], _t(nrm)[:, None],
                            _t(pts)[idx], _t(nrm)[idx])
    for k, (lo, hi) in enumerate([(-1.0, 1.0), (-1.0, 1.0),
                                  (-np.pi, np.pi), (None, None)]):
        a, b = np.asarray(jf[k]), tf[k].numpy()
        np.testing.assert_allclose(b, a, atol=2e-6, rtol=0)
        if lo is None:
            continue
        pos = (a - lo) / (hi - lo) * 11
        bins_j = np.clip(pos.astype(np.int32), 0, 10)
        bins_t = np.clip(((b - lo) / (hi - lo) * 11).astype(np.int32), 0, 10)
        edge = np.abs(pos - np.round(pos)) < 1e-5 * 11
        assert (bins_j == bins_t)[~edge].all()


def test_fpfh_features_match_jax_on_a_non_grid_cloud():
    """33-D descriptors on JAX's oriented normals (the jittered grid):
    every row within 1e-5 of JAX's but those whose neighbourhood (the point
    or one of its k neighbours, through the SPFH mixing) holds a pair at a
    bin edge, and those within 1/k (a pair moving bins moves one unit of a
    sub-histogram holding k); each sub-histogram sums to 1, masked rows are
    zero."""
    pts = _jittered()
    nrm = _oriented(pts)
    a = np.asarray(jfp.fpfh_features(jnp.asarray(pts), jnp.asarray(nrm),
                                     k=16))
    b = ft.fpfh_features(_t(pts), _t(nrm), k=16).numpy()
    assert b.shape == (1600, 33)
    idx, _ = j_self_knn(jnp.asarray(pts), 17)
    idx = np.array(idx)[:, 1:]
    edge = _edge_points(pts, nrm, idx).any(1)
    touched = edge | edge[idx].any(1)
    d = np.abs(a - b).max(1)
    assert (d[~touched] <= 1e-5).all() and d.max() <= 1.0 / 16, d.max()
    assert touched.mean() < 0.1
    np.testing.assert_allclose(b.reshape(-1, 3, 11).sum(2), 1.0, atol=1e-5)
    mask = np.arange(1600) < 1500
    am = np.asarray(jfp.fpfh_features(jnp.asarray(pts), jnp.asarray(nrm),
                                      k=16, mask=jnp.asarray(mask)))
    bm = ft.fpfh_features(_t(pts), _t(nrm), k=16, mask=_t(mask)).numpy()
    assert (bm[~mask] == 0).all()
    assert np.abs(am - bm).max() <= 1.0 / 16


def test_feature_search_matches_jax_nn_argmin():
    """``nn_argmin_features`` on 33-D descriptors (JAX's, fed to both)
    against the JAX package's XLA ``nn_argmin(exact=False)``: the same
    expansion form, summed in another order by XLA's and torch's matmuls,
    so picks are equal but for near ties, whose two candidates lie within
    1e-6 (float64) of each other, at most 1% of the rows; the distances
    within 1e-6."""
    pts = _wavy()
    nrm = _oriented(pts)
    fa = np.asarray(jfp.fpfh_features(jnp.asarray(pts), jnp.asarray(nrm),
                                      k=16))
    fb = np.asarray(jfp.fpfh_features(jnp.asarray(pts[::2]),
                                      jnp.asarray(nrm[::2]), k=16))
    ji, jd = j_nn(jnp.asarray(fa), jnp.asarray(fb))
    ti, td = nn_argmin_features(_t(fa), _t(fb))
    ti, ji = ti.numpy(), np.asarray(ji)
    diff = np.nonzero(ti != ji)[0]
    assert diff.size <= 0.01 * ti.size
    f64a, f64b = fa.astype(np.float64), fb.astype(np.float64)
    d_t = ((f64a[diff] - f64b[ti[diff]]) ** 2).sum(1)
    d_j = ((f64a[diff] - f64b[ji[diff]]) ** 2).sum(1)
    assert (np.abs(d_t - d_j) <= 1e-6).all()
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)
    with pytest.raises(ValueError, match=r"\[N, D\]"):
        nn_argmin_features(_t(fa), _t(fb[:, :32]))


def _jax_correspondences(src_sel, tgt_sel):
    """The JAX package's own correspondence stage (global_reg.py:128-141)
    on the strided clouds: ``(q_corr, good)`` as numpy."""
    n_s = j_orient(src_sel, j_normals(src_sel, k=8))
    n_t = j_orient(tgt_sel, j_normals(tgt_sel, k=8))
    f_sel = jfp.fpfh_features(src_sel, n_s, k=16)
    f_t = jfp.fpfh_features(tgt_sel, n_t, k=16)
    fwd, _ = j_nn(f_sel, f_t)
    back, _ = j_nn(jgather(f_t, fwd), f_sel)
    good = back == jnp.arange(src_sel.shape[0])
    return np.asarray(jgather(tgt_sel, fwd)), np.asarray(good)


def _bunny_case():
    src = np.asarray(load_bunny(resampled=True))
    gt = f.gt_transform((0.1, -0.05, 0.08), (0.4, 1.2, -0.8))
    return src, np.array(gt.apply(jnp.asarray(src))), gt


def test_ransac_fed_jax_draws_matches_jax():
    """``_ransac`` fed the JAX package's correspondences and its own
    ``categorical`` draws (key 0, 1,024 hypotheses of 3) on Bunny under the
    1.2-rad pose: the inlier count equal to ``global_registration``'s, the
    transform within 1e-5, τ equal to f32 grade."""
    src, tgt, _ = _bunny_case()
    j = f.global_registration(jnp.asarray(src), jnp.asarray(tgt))
    src_sel, tgt_sel = src[::2], tgt  # the strides of 4,096 / 8,192
    q_corr, good = _jax_correspondences(jnp.asarray(src_sel),
                                        jnp.asarray(tgt_sel))
    assert int(good.sum()) == int(j.num_correspondences)
    samples = np.asarray(jax.random.categorical(
        jax.random.PRNGKey(0), jnp.where(jnp.asarray(good), 0.0, -1e30),
        shape=(1024, 3)))
    tau = tgr._estimate_spacing(_t(tgt_sel)) * 3.0
    np.testing.assert_allclose(float(tau), float(j.tau), rtol=1e-6)
    R, t, n_inl, rmse = tgr._ransac(_t(src_sel), _t(q_corr), _t(good),
                                    _t(samples), tau, 3)
    assert int(n_inl) == int(j.num_inliers)
    assert _rmse_between(R, t, j.transform.rotation, j.transform.translation,
                         src) < GAP
    np.testing.assert_allclose(float(rmse), float(j.inlier_rmse), rtol=1e-4)


def test_global_registration_bunny_beats_plain_icp():
    """The port's own pipeline (its FPFH, feature search and the torch
    generator's draws) on Bunny under the 1.2-rad pose: plain ``run_icp``
    stays above 1e-4, ``register_global`` reaches 1e-6; its mutual
    correspondences within 2% of JAX's count; the same seed gives the same
    result."""
    src, tgt, gt = _bunny_case()
    gt_t = ft.RigidTransform(_t(gt.rotation), _t(gt.translation))
    plain = ft.run_icp(_t(src), _t(tgt), ft.ICPConfig(max_iterations=60))
    assert float(ft.transform_rmse(plain.transform, gt_t, _t(src))) > 1e-4
    res = ft.register_global(_t(src), _t(tgt),
                             ft.ICPConfig(max_iterations=40))
    assert float(ft.transform_rmse(res.transform, gt_t, _t(src))) < 1e-6
    j = f.global_registration(jnp.asarray(src), jnp.asarray(tgt))
    a = ft.global_registration(_t(src), _t(tgt), seed=3)
    b = ft.global_registration(_t(src), _t(tgt), seed=3)
    assert torch.equal(a.transform.rotation, b.transform.rotation)
    assert abs(int(a.num_correspondences) - int(j.num_correspondences)) <= \
        0.02 * int(j.num_correspondences)
    assert a.num_inliers.dtype == torch.int32 and int(a.num_inliers) > 50


def test_global_registration_synthetic_large_pose_and_mutual_filter():
    """The synthetic saddle under a large pose (test_global_reg.py:70-79):
    the coarse pose lands in ICP's basin up to the saddle's symmetry, so
    the refined result is held by its chamfer RMSE; the mutual filter keeps
    fewer correspondences than none."""
    s = ft.synthetic_scene(width=32, device="cpu")
    gt = ft.gt_transform((2.0, 1.0, 0.5), (0.2, -0.3, 0.8), device="cpu")
    tgt = gt.apply(s.source)
    res = ft.register_global(s.source, tgt, ft.ICPConfig(max_iterations=40))
    _, d = ft.nn_argmin(res.transform.apply(s.source), tgt, exact=True)
    assert float(torch.sqrt(d.mean())) < 1e-5
    with_f = ft.global_registration(s.source, tgt, mutual=True)
    without = ft.global_registration(s.source, tgt, mutual=False)
    assert int(without.num_correspondences) == s.source.shape[0]
    assert 20 < int(with_f.num_correspondences) < int(
        without.num_correspondences)


def test_estimate_spacing_robust_to_duplicates():
    """A duplicate-heavy cloud: τ's spacing comes from positive distances,
    as the JAX package's (test_global_reg.py:117-127)."""
    rng = np.random.default_rng(17)
    base = rng.uniform(-1, 1, (128, 3)).astype(np.float32)
    dup = base[rng.integers(0, 128, 4096)]
    got = float(tgr._estimate_spacing(_t(dup)))
    assert np.isfinite(got) and got > 1e-4
    np.testing.assert_allclose(got, float(jgr._estimate_spacing(
        jnp.asarray(dup))), rtol=1e-5)


def jax_references():
    """The JAX package's CPU runs of the card's global-registration paths:
    Bunny 8,171 under the 1.2-rad pose and the 1,024- and 16,384-point
    synthetic scenes under the large pose, ``register_global`` with 40 ICP
    iterations: GT error (Bunny), chamfer RMSE in the difference form
    (synthetic), ICP iterations."""
    src, tgt, gt = _bunny_case()
    plain = f.run_icp(jnp.asarray(src), jnp.asarray(tgt),
                      f.ICPConfig(max_iterations=60))
    res = f.register_global(jnp.asarray(src), jnp.asarray(tgt),
                            config=f.ICPConfig(max_iterations=40))
    print(f"global bunny: plain run_icp GT error "
          f"{float(f.transform_rmse(plain.transform, gt, src)):.3e}, "
          f"register_global {float(f.transform_rmse(res.transform, gt, src)):.3e}"
          f" in {int(res.num_iterations)} ICP iterations", flush=True)
    g = f.gt_transform((2.0, 1.0, 0.5), (0.2, -0.3, 0.8))
    for width in (32, 128):
        s = f.synthetic_scene(width=width)
        tgt = g.apply(s.source)
        res = f.register_global(s.source, tgt,
                                config=f.ICPConfig(max_iterations=40))
        _, d = j_nn(res.transform.apply(s.source), tgt, exact=True)
        print(f"global synthetic-{width * width}: chamfer RMSE "
              f"{float(jnp.sqrt(jnp.mean(d))):.3e}, GT error "
              f"{float(f.transform_rmse(res.transform, g, s.source)):.3e} in "
              f"{int(res.num_iterations)} ICP iterations", flush=True)


if __name__ == "__main__":
    jax_references()
