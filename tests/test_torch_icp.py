"""The port's point-to-point ICP loop against ``fpcr_tpu.run_icp`` on the
same numpy inputs, against the float64 golden model
``fpcr_tpu.models.reference_impl`` and against the ground truth (CPU; the
port's matcher runs its plain version here)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fpcr_tpu as f
import fpcr_tpu_torch as ft
from fpcr_tpu.models.icp import icp_iteration as j_icp_iteration
from fpcr_tpu.models.reference_impl import icp_numpy
from fpcr_tpu_torch.models.icp import DONE_CHECK_EVERY

torch.set_num_threads(2)

# per-iteration errors and matched fractions: the two packages sum float32
# moments in different orders, which moves an RMSE of O(0.1) by ~1e-7 per
# iteration; 1e-5 leaves room for that drift over 40 iterations
ATOL = 1e-5
# the increment's angle is arccos((tr R - 1) / 2): near 1, float32 resolves
# the cosine in steps of 2^-24, so small angles come in steps of ~3.5e-4
DELTA_ROT_ATOL = 1e-3
GAP = 1e-5  # transform RMSE between the two packages' results
STOP_MARGIN = 1e-7  # an iteration count may differ only this close to tol
NOISE = 1e-5  # an RMSE below this is float32 noise of converged clouds


def _scene(name):
    """(source, target, gt_R, gt_t) as numpy, built once for both sides."""
    if name.startswith("synthetic-"):
        s = f.synthetic_scene(width=int(name.split("-")[1]))
        src = np.asarray(s.source)
    else:  # "junk-source-16": ~10% of the source far from every target
        s = f.synthetic_scene(width=16)
        junk = np.random.default_rng(17).uniform(3.0, 4.0, size=(26, 3))
        src = np.concatenate([np.asarray(s.source), junk])
    g = s.ground_truth
    return (src.astype(np.float32), np.array(s.target),
            np.array(g.rotation), np.array(g.translation))


# key: (scene, config fields, whether the per-iteration arrays are compared)
RUNS = {
    "pallas-16": ("synthetic-16", dict(matcher="pallas"), True),
    # the expansion form's rounding noise (~1e-7 on sqdist) decides
    # near-ties between grid points differently in the two packages, and
    # one such pick moves the trajectory by ~1e-4 for a few iterations: the
    # expansion-form run is held to its end point, the exact form to every
    # iteration
    "xla-32": ("synthetic-32", dict(), False),
    "exact-32": ("synthetic-32", dict(exact_distances=True), True),
    "polar-16": ("synthetic-16", dict(solver="polar"), True),
    "strict-16": ("synthetic-16", dict(strict_reference=True), True),
    "trim-junk": ("junk-source-16", dict(max_correspondence_dist=1.0,
                                         exact_distances=True), True),
    "autotrim-junk": ("junk-source-16", dict(auto_trim=9.0,
                                             exact_distances=True), True),
    "huber-16": ("synthetic-16", dict(robust_loss="huber",
                                      exact_distances=True), True),
    "tukey-junk": ("junk-source-16", dict(robust_loss="tukey",
                                          exact_distances=True), True),
}


def _np_result(res):
    return {"R": np.asarray(res.transform.rotation),
            "t": np.asarray(res.transform.translation),
            "errors": np.asarray(res.errors),
            "fraction": np.asarray(res.matched_fraction),
            "delta_t": np.asarray(res.delta_t),
            "delta_rot": np.asarray(res.delta_rot),
            "n": int(res.num_iterations), "converged": bool(res.converged),
            "points": np.asarray(res.points)}


@pytest.fixture(scope="module")
def jax_runs():
    """Every run through ``fpcr_tpu.run_icp`` once (the 'pallas' run goes
    through the Pallas kernel in interpret mode, as its own tests run it)."""
    out = {}
    for key, (scene, kw, _) in RUNS.items():
        src, tgt, _, _ = _scene(scene)
        res = f.run_icp(jnp.asarray(src), jnp.asarray(tgt),
                        f.ICPConfig(max_iterations=40, **kw))
        out[key] = _np_result(res)
    return out


def _rmse_between(Ra, ta, Rb, tb, probe):
    d = (probe @ Ra.T + ta) - (probe @ Rb.T + tb)
    return float(np.sqrt((d * d).sum(1).mean()))


def _assert_same_run(a, b, tol, per_iteration=True):
    if a["n"] != b["n"]:
        # allowed only where the stop test at the earlier stop lands within
        # STOP_MARGIN of tol in either package's float32 errors
        k = min(a["n"], b["n"]) - 1
        e = b["errors"] if b["n"] > a["n"] else a["errors"]
        margin = min(abs(e[k] - tol),
                     abs(abs(e[k] - e[k - 1]) - tol) if k else np.inf)
        assert abs(a["n"] - b["n"]) == 1 and margin < STOP_MARGIN, (
            a["n"], b["n"], margin)
    else:
        assert a["converged"] == b["converged"]
    for name in ("errors", "fraction", "delta_t", "delta_rot"):
        assert np.isnan(a[name][a["n"]:]).all(), name  # NaN after the stop
        assert np.isfinite(a[name][:a["n"]]).all(), name
    if not per_iteration:
        return
    k = min(a["n"], b["n"])
    for name, atol in (("errors", ATOL), ("delta_t", ATOL),
                       ("delta_rot", DELTA_ROT_ATOL)):
        np.testing.assert_allclose(a[name][:k], b[name][:k], atol=atol,
                                   err_msg=name)
    # matched fractions where the error is above float32 noise: below it an
    # auto-trim gate is set by the trimmed mean of noise (~1e-12 sqdist)
    # and cuts noise, differently in each package
    signal = b["errors"][:k] > NOISE
    np.testing.assert_allclose(a["fraction"][:k][signal],
                               b["fraction"][:k][signal], atol=ATOL)


@pytest.mark.parametrize("key", list(RUNS))
def test_run_icp_matches_jax(jax_runs, key):
    scene, kw, per_iteration = RUNS[key]
    src, tgt, gR, gt = _scene(scene)
    res = ft.run_icp(torch.as_tensor(src), torch.as_tensor(tgt),
                     ft.ICPConfig(max_iterations=40, **kw))
    a, b = _np_result(res), jax_runs[key]
    _assert_same_run(a, b, 1e-6, per_iteration)
    assert _rmse_between(a["R"], a["t"], b["R"], b["t"], src) < GAP
    np.testing.assert_allclose(a["points"], b["points"], atol=1e-4)
    if "strict" not in key:
        assert _rmse_between(a["R"], a["t"], gR, gt, src) < 1e-4
    if key in ("trim-junk", "tukey-junk"):
        # the junk rows leave the solve: 256 of 282 rows stay
        assert a["fraction"][a["n"] - 1] == pytest.approx(256 / 282)


@pytest.mark.parametrize("width", [16, 32])
def test_run_icp_matches_float64_golden(width):
    """The f64 golden model (the reference's CPU baseline semantics), the
    port and fpcr_tpu land on the same transform."""
    src, tgt, gR, gt = _scene(f"synthetic-{width}")
    gold = icp_numpy(src, tgt, max_iterations=40, tolerance=1e-6)
    res = ft.run_icp(torch.as_tensor(src), torch.as_tensor(tgt),
                     ft.ICPConfig(max_iterations=40))
    a = _np_result(res)
    b = _np_result(f.run_icp(jnp.asarray(src), jnp.asarray(tgt),
                             f.ICPConfig(max_iterations=40)))
    for r in (a, b):  # the port and fpcr_tpu both land on the golden
        assert _rmse_between(r["R"], r["t"], gold.rotation,
                             gold.translation, src.astype(np.float64)) < 1e-5
    assert _rmse_between(gold.rotation, gold.translation, gR, gt,
                         src.astype(np.float64)) < 1e-5
    # same trajectory while the error is large (f32 vs f64 only diverge
    # in the last iterations, near the 1e-6 stop test)
    k = min(len(gold.errors), a["n"]) // 2
    np.testing.assert_allclose(a["errors"][:k], gold.errors[:k], atol=1e-5)


def test_icp_iteration_matches_jax():
    src, tgt, _, _ = _scene("synthetic-16")
    new_p, inc, err, aux = ft.icp_iteration(
        torch.as_tensor(src), torch.as_tensor(tgt), ft.ICPConfig())
    j_p, j_inc, j_err, j_aux = j_icp_iteration(
        jnp.asarray(src), jnp.asarray(tgt), f.ICPConfig())
    np.testing.assert_allclose(new_p.numpy(), np.asarray(j_p), atol=1e-5)
    np.testing.assert_allclose(inc.rotation.numpy(),
                               np.asarray(j_inc.rotation), atol=1e-5)
    np.testing.assert_allclose(float(err), float(j_err), atol=1e-6)
    assert float(aux.matched_fraction) == float(j_aux.matched_fraction) == 1


def test_masks_match_jax():
    """Padded clouds: masked source rows leave the solve, masked targets
    are never matched."""
    src, tgt, _, _ = _scene("synthetic-16")
    sp, tp = f.pad_cloud(jnp.asarray(src), 64), f.pad_cloud(jnp.asarray(tgt),
                                                            48, pad_value=0.1)
    cfg = dict(max_iterations=40)
    b = _np_result(f.run_icp(sp.points, tp.points, f.ICPConfig(**cfg),
                             source_mask=sp.mask, target_mask=tp.mask))
    a = _np_result(ft.run_icp(
        torch.as_tensor(np.array(sp.points)),
        torch.as_tensor(np.array(tp.points)), ft.ICPConfig(**cfg),
        source_mask=torch.as_tensor(np.array(sp.mask)),
        target_mask=torch.as_tensor(np.array(tp.mask))))
    _assert_same_run(a, b, 1e-6)
    assert _rmse_between(a["R"], a["t"], b["R"], b["t"], src) < GAP


def test_masked_iterations_after_the_stop_change_nothing():
    """The host reads the done flag every DONE_CHECK_EVERY iterations; the
    iterations run after the stop must leave the result as it was."""
    src, tgt, _, _ = _scene("synthetic-16")
    s, t = torch.as_tensor(src), torch.as_tensor(tgt)
    full = ft.run_icp(s, t, ft.ICPConfig(max_iterations=40))
    n = int(full.num_iterations)
    assert bool(full.converged) and n % DONE_CHECK_EVERY != 0
    exact = ft.run_icp(s, t, ft.ICPConfig(max_iterations=n))
    assert int(exact.num_iterations) == n and bool(exact.converged)
    assert torch.equal(full.transform.rotation, exact.transform.rotation)
    assert torch.equal(full.transform.translation,
                       exact.transform.translation)
    assert torch.equal(full.points, exact.points)
    assert torch.equal(full.errors[:n], exact.errors)
    assert torch.isnan(full.errors[n:]).all()


def test_iteration_cap_without_convergence():
    src, tgt, _, _ = _scene("synthetic-16")
    res = ft.icp_point_to_point(torch.as_tensor(src), torch.as_tensor(tgt),
                                max_iterations=3, tolerance=0.0)
    assert int(res.num_iterations) == 3 and not bool(res.converged)
    assert torch.isfinite(res.errors).all() and res.errors.shape == (3,)
    with pytest.raises(ValueError, match="metric is fixed"):
        ft.icp_point_to_point(torch.as_tensor(src), torch.as_tensor(tgt),
                              metric="plane")


def test_bunny_recovers_ground_truth():
    """Reference workload: Bunny (8,171 points), 40-iteration cap."""
    s = ft.bunny_scene(device="cpu")
    res = ft.icp_point_to_point(s.source, s.target,
                                config=ft.ICPConfig(max_iterations=40))
    assert bool(res.converged)
    assert float(ft.transform_rmse(res.transform, s.ground_truth,
                                   s.source)) < 1e-5
