"""The port's ``evaluate_registration`` against ``fpcr_tpu``'s on the same
numpy inputs, and the phase profiler (``PhaseTimer``, ``profile_icp``,
``profiler_trace``) on the CPU, where a phase is timed by the host clock."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fpcr_tpu as f
import fpcr_tpu_torch as ft
from fpcr_tpu.utils import timing as jtiming
from fpcr_tpu_torch.utils import timing as ttiming

torch.set_num_threads(2)


def _t(a):
    return torch.as_tensor(np.array(a))


def _pair(kind):
    """``(source, target, JAX transform or None, target mask or None)``."""
    s = f.synthetic_scene(width=24)
    src, tgt = np.array(s.source), np.array(s.target)
    if kind == "aligned":  # the ground truth: every match an inlier
        return src, tgt, s.ground_truth, None
    if kind == "partial":  # a third of the source far away
        far = np.random.default_rng(2).uniform(5, 6, (200, 3))
        src = np.concatenate([src, far.astype(np.float32)])
        return src, tgt, s.ground_truth, None
    if kind == "masked":
        mask = np.random.default_rng(3).uniform(size=tgt.shape[0]) < 0.6
        return src, tgt, s.ground_truth, mask
    return src, tgt, None, None  # "identity": far from aligned


def _transform(tj):
    return None if tj is None else ft.RigidTransform(_t(tj.rotation),
                                                     _t(tj.translation))


@pytest.mark.parametrize("gate", [None, 0.05, 1.0])
@pytest.mark.parametrize("kind", ["aligned", "partial", "masked",
                                  "identity"])
def test_evaluate_registration_matches_jax(kind, gate):
    src, tgt, tj, mask = _pair(kind)
    kw = dict(max_correspondence_dist=gate)
    want = f.evaluate_registration(
        jnp.asarray(src), jnp.asarray(tgt), tj,
        target_mask=None if mask is None else jnp.asarray(mask), **kw)
    got = ft.evaluate_registration(
        _t(src), _t(tgt), _transform(tj),
        target_mask=None if mask is None else _t(mask), **kw)
    assert set(got) == set(want) == {"fitness", "inlier_rmse", "num_inliers",
                                     "max_correspondence_dist"}
    for k, v in got.items():
        assert isinstance(v, torch.Tensor) and v.shape == (), k
    assert got["num_inliers"].dtype == torch.int32
    assert int(got["num_inliers"]) == int(want["num_inliers"])
    np.testing.assert_allclose(float(got["fitness"]), float(want["fitness"]),
                               rtol=1e-7)
    # the automatic gate: the port's suggest_cell_size takes its 2-NN in
    # the difference form, JAX's in the expansion form (ROADMAP.md §3), a
    # few ulp apart
    np.testing.assert_allclose(float(got["max_correspondence_dist"]),
                               float(want["max_correspondence_dist"]),
                               rtol=1e-5)
    # the two packages apply the transform with differently rounded
    # products: points of magnitude ~4 land an ulp (4.8e-7) apart
    np.testing.assert_allclose(float(got["inlier_rmse"]),
                               float(want["inlier_rmse"]), rtol=1e-5,
                               atol=1e-6)
    if kind == "partial":
        assert float(got["fitness"]) == pytest.approx(576 / 776)


def test_evaluate_registration_takes_numpy_on_the_asked_device():
    """Numpy clouds go where ``as_points`` sends them: the CPU when the
    tensors are given there, the card by default."""
    s = ft.synthetic_scene(width=16, device="cpu")
    res = ft.evaluate_registration(s.source, s.target.numpy(),
                                   s.ground_truth)
    assert float(res["fitness"]) == 1.0
    assert res["fitness"].device.type == "cpu"
    assert float(res["inlier_rmse"]) < 1e-6


def test_phase_timer_accumulates_and_reports():
    timer = ft.PhaseTimer(device="cpu")
    for _ in range(3):
        with timer.phase("a"):
            sum(range(1000))
    with timer.phase("b"):
        pass
    with pytest.raises(RuntimeError):
        with timer.phase("c"):
            raise RuntimeError("the phase's time is kept")
    assert list(timer.totals) == ["a", "b", "c"]
    assert timer.counts == {"a": 3, "b": 1, "c": 1}
    ms = timer.as_dict()
    assert all(v >= 0 for v in ms.values())
    assert ms["a"] == pytest.approx(timer.totals["a"] * 1e3)
    report = timer.report().splitlines()
    assert report[0].split() == ["phase", "total", "ms", "calls", "%"]
    assert [r.split()[0] for r in report[1:]] == ["a", "b", "c", "TOTAL"]
    # the JAX package's layout, line for line
    j = jtiming.PhaseTimer()
    j.totals, j.counts = dict(timer.totals), dict(timer.counts)
    assert j.report() == timer.report()


def test_phase_timer_defaults_to_the_card():
    if torch.cuda.is_available():
        assert ft.PhaseTimer().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            ft.PhaseTimer()


@pytest.mark.parametrize("metric", ["point", "plane"])
def test_profile_icp_phases_follow_the_loop(metric):
    """The stepwise run's phases in the reference's order, each timed once
    an iteration, the plane metric's normals once before them."""
    s = ft.synthetic_scene(width=16, device="cpu")
    cfg = ft.ICPConfig(metric=metric)
    timer = ft.profile_icp(s.source, s.target, cfg, iterations=4)
    phases = ["matching", "gather", "minimization", "transformation",
              "error"]
    want = (["normals"] if metric == "plane" else []) + phases
    assert list(timer.totals) == want
    assert all(timer.counts[p] == 4 for p in phases)
    assert timer.device.type == "cpu"
    assert "TOTAL" in timer.report()


@pytest.mark.parametrize("kw", [dict(metric="symmetric"),
                                dict(metric="gicp"),
                                dict(matcher="pallas"),
                                dict(matcher="morton"), dict(matcher="grid")])
def test_profile_icp_rejects_what_it_does_not_break_down(kw):
    s = ft.synthetic_scene(width=8, device="cpu")
    with pytest.raises(ValueError, match="profile_icp"):
        ft.profile_icp(s.source, s.target, ft.ICPConfig(**kw))
    with pytest.raises(ValueError, match="profile_icp"):
        jtiming.profile_icp(jnp.asarray(s.source.numpy()),
                            jnp.asarray(s.target.numpy()), f.ICPConfig(**kw))


def test_profiler_trace_writes_a_trace(tmp_path):
    s = ft.synthetic_scene(width=8, device="cpu")
    with ttiming.profiler_trace(None):
        ft.run_icp(s.source, s.target, ft.ICPConfig(max_iterations=2))
    with ttiming.profiler_trace(str(tmp_path)):
        ft.run_icp(s.source, s.target, ft.ICPConfig(max_iterations=2))
    assert any(p.name.endswith(".json") for p in tmp_path.rglob("*"))
