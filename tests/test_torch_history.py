"""ICP history, checkpoints and resume in the port against ``fpcr_tpu`` on
the same numpy inputs (CPU): every per-iteration row of
``run_icp_with_history`` for several metrics and matchers, the rows after
the stop equal to the JAX scan's masked no-op rows, the history's transform
and iterations equal to ``run_icp``'s, and checkpoints written by either
package loaded by the other (a foreign suffix included), then resumed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fpcr_tpu as f
import fpcr_tpu_torch as ft
from fpcr_tpu_torch.interop import history_from_numpy

torch.set_num_threads(2)

GAP = 1e-5  # transform RMSE between the two packages' results
NOISE = 1e-5  # an RMSE below this is float32 noise of converged clouds


def _t(a):
    return torch.as_tensor(np.array(a))


def _rmse_between(ra, ta, rb, tb, probe):
    d = (probe @ np.asarray(ra).T + np.asarray(ta)) - (
        probe @ np.asarray(rb).T + np.asarray(tb))
    return float(np.sqrt((d * d).sum(1).mean()))


def _scene(width=16):
    s = f.synthetic_scene(width=width)
    return np.array(s.source), np.array(s.target)


# the difference form throughout: the expansion's rounding settles grid
# near-ties differently in the two packages (tests/test_torch_icp.py)
HISTORY_RUNS = {
    "point": dict(exact_distances=True),
    "plane": dict(metric="plane", exact_distances=True),
    "morton": dict(matcher="morton", morton_impl="xla", morton_chunk=64,
                   morton_window=64, exact_distances=True),
    "symmetric": dict(metric="symmetric", exact_distances=True),
}


@pytest.mark.parametrize("key", list(HISTORY_RUNS))
def test_history_matches_jax(key, monkeypatch):
    """Every row within f32 noise of JAX's fixed-trip scan, the rows after
    the stop JAX's masked no-op rows (identity increments, the frozen
    accumulated transform, the last error repeated, ``active`` false,
    ``matched_fraction`` NaN, zero deltas); equal iteration counts. Runs
    with normals take JAX's normals: the target's as an argument, the
    symmetric run's source normals through the port's prepass, since the
    port's eigensolver departs from JAX's closed form where two
    eigenvalues of a neighbourhood nearly meet."""
    kw = HISTORY_RUNS[key]
    src, tgt = _scene()
    extra = {}
    if kw.get("metric") in ("plane", "symmetric"):
        extra["target_normals"] = np.array(f.estimate_normals(
            jnp.asarray(tgt)))
    if kw.get("metric") == "symmetric":
        from fpcr_tpu_torch.models import icp as mi

        monkeypatch.setattr(mi, "estimate_normals", lambda q, **kws: _t(
            f.estimate_normals(jnp.asarray(q.numpy()), **kws)))
    cfg = dict(max_iterations=30, **kw)
    j = f.run_icp_with_history(jnp.asarray(src), jnp.asarray(tgt),
                               f.ICPConfig(**cfg),
                               **{k: jnp.asarray(v) for k, v in extra.items()})
    t = ft.run_icp_with_history(_t(src), _t(tgt), ft.ICPConfig(**cfg),
                                **{k: _t(v) for k, v in extra.items()})
    n = int(t.num_iterations)
    assert n == int(j.num_iterations) and n < 30
    assert bool(t.converged) == bool(j.converged)
    np.testing.assert_array_equal(t.active.numpy(), np.asarray(j.active))
    for name in ("incremental_rotations", "incremental_translations",
                 "accumulated_rotations", "accumulated_translations",
                 "errors", "delta_t"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)), atol=2e-5,
                                   err_msg=name)
    signal = np.asarray(j.errors)[:n] > NOISE
    np.testing.assert_allclose(t.matched_fraction[:n].numpy()[signal],
                               np.asarray(j.matched_fraction)[:n][signal],
                               atol=1e-5)
    # the rows after the stop
    assert torch.equal(t.incremental_rotations[n:],
                       torch.eye(3).expand(30 - n, 3, 3))
    assert (t.incremental_translations[n:] == 0).all()
    assert (t.accumulated_rotations[n:] == t.transform.rotation).all()
    assert (t.errors[n:] == t.errors[n - 1]).all()
    assert torch.isnan(t.matched_fraction[n:]).all()
    assert (t.delta_t[n:] == 0).all() and (t.delta_rot[n:] == 0).all()
    assert np.isnan(np.asarray(j.matched_fraction)[n:]).all()
    assert _rmse_between(t.transform.rotation, t.transform.translation,
                         j.transform.rotation, j.transform.translation,
                         src) < GAP
    np.testing.assert_allclose(t.points.numpy(), np.asarray(j.points),
                               atol=1e-4)


@pytest.mark.parametrize("key", ["point", "morton"])
def test_history_equals_run_icp(key):
    """The history's run is ``run_icp``'s: the same set-up and iteration,
    so the same transform bit for bit and the same iterations."""
    src, tgt = _scene()
    cfg = ft.ICPConfig(max_iterations=30, **HISTORY_RUNS[key])
    h = ft.run_icp_with_history(_t(src), _t(tgt), cfg)
    r = ft.run_icp(_t(src), _t(tgt), cfg)
    assert int(h.num_iterations) == int(r.num_iterations)
    assert torch.equal(h.transform.rotation, r.transform.rotation)
    assert torch.equal(h.transform.translation, r.transform.translation)
    assert torch.equal(h.points, r.points)
    n = int(h.num_iterations)
    assert torch.equal(h.errors[:n], r.errors[:n])


@pytest.mark.parametrize("name", ["run", "run.npz", "run.ckpt"])
def test_checkpoints_cross_packages(tmp_path, name):
    """A checkpoint the port writes loads in the JAX package and the other
    way round, under JAX's file names (``.npz`` appended unless present, a
    foreign suffix kept: ``run.ckpt.npz``, sidecar ``run.ckpt.config.json``);
    fields, dtypes and the config survive."""
    src, tgt = _scene()
    cfg = dict(max_iterations=12, exact_distances=True)
    t = ft.run_icp_with_history(_t(src), _t(tgt), ft.ICPConfig(**cfg))
    j = f.run_icp_with_history(jnp.asarray(src), jnp.asarray(tgt),
                               f.ICPConfig(**cfg))
    p_t = ft.save_checkpoint(tmp_path / "torch" / name, t,
                             ft.ICPConfig(**cfg))
    p_j = f.save_checkpoint(tmp_path / "jax" / name, j, f.ICPConfig(**cfg))
    assert p_t.name == p_j.name == (name if name.endswith(".npz")
                                    else name + ".npz")
    assert (tmp_path / "torch" / p_t.name.replace(
        ".npz", ".config.json")).exists()
    for (hist, config), src_hist in (
            (f.load_checkpoint(tmp_path / "torch" / name), t),
            (ft.load_checkpoint(tmp_path / "jax" / name), j)):
        assert config.max_iterations == 12 and config.exact_distances
        for field in ("errors", "active", "num_iterations", "converged",
                      "points", "matched_fraction", "delta_t", "delta_rot",
                      "incremental_rotations", "accumulated_translations"):
            want = np.asarray(getattr(src_hist, field))
            got = np.asarray(getattr(hist, field))
            assert got.dtype == want.dtype, field
            np.testing.assert_array_equal(got, want, err_msg=field)
        np.testing.assert_array_equal(np.asarray(hist.transform.rotation),
                                      np.asarray(src_hist.transform.rotation))
    loaded, _ = ft.load_checkpoint(tmp_path / "jax" / name)
    assert isinstance(loaded.errors, np.ndarray)


def test_resume_from_a_jax_run_matches_jax_resume(tmp_path):
    """A JAX run stopped early, resumed in both packages: from the JAX
    history through ``interop.history_from_numpy`` and from its checkpoint
    loaded by the port, each within 1e-5 of JAX's own ``resume_icp``; the
    total transform composes on the checkpoint's."""
    src, tgt = _scene()
    gt = f.synthetic_scene(width=16).ground_truth
    j0 = f.run_icp_with_history(jnp.asarray(src), jnp.asarray(tgt),
                                f.ICPConfig(max_iterations=2,
                                            exact_distances=True))
    cfg = dict(max_iterations=30, exact_distances=True)
    j1 = f.resume_icp(j0, jnp.asarray(tgt), f.ICPConfig(**cfg))
    f.save_checkpoint(tmp_path / "run", j0, f.ICPConfig(max_iterations=2))
    loaded, _ = ft.load_checkpoint(tmp_path / "run")
    for ck in (history_from_numpy(j0, device="cpu"), loaded):
        t1 = ft.resume_icp(ck, _t(tgt), ft.ICPConfig(**cfg))
        # the last error lands within f32 noise of the 1e-6 tolerance
        # (1.2e-6 in JAX, 7.4e-7 here): the stop may come one apart
        assert abs(int(t1.num_iterations) - int(j1.num_iterations)) <= 1
        assert _rmse_between(t1.transform.rotation, t1.transform.translation,
                             j1.transform.rotation, j1.transform.translation,
                             src) < GAP
        assert _rmse_between(t1.transform.rotation, t1.transform.translation,
                             gt.rotation, gt.translation, src) < 1e-4
