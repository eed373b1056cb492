"""The port's front door ``register()`` against ``fpcr_tpu.register`` on the
same numpy inputs (CPU): every method of ``METHODS`` on the scene of
``tests/test_registry.py``, to the JAX test's ground-truth bound and, where
both packages run the same deterministic path, to JAX's transform; the same
validation messages and defaults (SGD's and coarse-to-fine's)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fpcr_tpu as f
import fpcr_tpu_torch as ft
from fpcr_tpu_torch.models import registry as treg

torch.set_num_threads(2)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def scene():
    s = f.synthetic_scene(width=32)
    gt = f.gt_transform((0.02, -0.015, 0.01), (0.03, -0.02, 0.015))
    src = np.array(s.source)
    return src, np.array(gt.apply(s.source)), gt


def _gt_error(res, gt, src):
    tr = ft.RigidTransform(res.transform.rotation, res.transform.translation)
    ref = ft.RigidTransform(_t(gt.rotation), _t(gt.translation))
    return float(ft.transform_rmse(tr, ref, _t(src)))


def _gap(a, b, probe):
    d = (probe @ a.transform.rotation.numpy().T
         + a.transform.translation.numpy()) - (
        probe @ np.asarray(b.transform.rotation).T
        + np.asarray(b.transform.translation))
    return float(np.sqrt((d * d).sum(1).mean()))


# (method, the GT bound of tests/test_registry.py, the transform gap to the
# JAX package's result; None where the two runs differ by design: SGD's and
# RANSAC's draws are each package's own)
REGISTER_RUNS = [("point", 1e-5, 1e-5), ("plane", 1e-5, 1e-5),
                 ("symmetric", 1e-5, 1e-5), ("gicp", 1e-5, 1e-5),
                 ("ndt", 1e-5, 1e-5), ("coarse_to_fine", 1e-4, 1e-5),
                 ("aa", 1e-5, 1e-5), ("sgd", 2e-3, None)]


@pytest.mark.parametrize("method,tol,gap", REGISTER_RUNS)
def test_register_methods_match_jax(scene, method, tol, gap):
    src, tgt, gt = scene
    res = ft.register(_t(src), _t(tgt), method=method, max_iterations=60)
    assert _gt_error(res, gt, src) < tol, method
    assert res.transform.rotation.shape == (3, 3)
    if gap is not None:
        j = f.register(jnp.asarray(src), jnp.asarray(tgt), method=method,
                       max_iterations=60)
        assert _gap(res, j, src) < gap


def test_register_global_from_a_far_pose():
    """``method='global'``: FPFH + RANSAC (the torch generator's draws),
    then ICP; the saddle's symmetry allows either optimum, so the result is
    held by its chamfer RMSE, as the JAX test holds it."""
    s = ft.synthetic_scene(width=32, device="cpu")
    gt = ft.gt_transform((0.1, -0.05, 0.08), (0.3, 0.8, -0.5), device="cpu")
    tgt = gt.apply(s.source)
    res = ft.register(s.source, tgt, method="global", max_iterations=40)
    _, d = ft.nn_argmin(res.transform.apply(s.source), tgt, exact=True)
    assert float(torch.sqrt(d.mean())) < 1e-2


def test_register_validates_as_jax(scene):
    """The same messages as the JAX package's for an unknown method, both
    config forms, and a metric keyword; the metric methods set the metric
    of a given config."""
    src, tgt, _ = scene
    for kwargs in (dict(method="bogus"),
                   dict(config=ft.ICPConfig(), max_iterations=5),
                   dict(metric="plane")):
        jkw = {k: (f.ICPConfig() if k == "config" else v)
               for k, v in kwargs.items()}
        with pytest.raises(ValueError) as want:
            f.register(jnp.asarray(src), jnp.asarray(tgt), **jkw)
        with pytest.raises(ValueError) as got:
            ft.register(_t(src), _t(tgt), **kwargs)
        assert str(got.value) == str(want.value)
    assert treg.METHODS == f.METHODS
    cfg = ft.ICPConfig(metric="point", max_iterations=60)
    res = ft.register(_t(src), _t(tgt), method="plane", config=cfg)
    ref = ft.run_icp(_t(src), _t(tgt), dataclasses.replace(cfg,
                                                           metric="plane"))
    assert torch.equal(res.transform.rotation, ref.transform.rotation)


def test_register_keeps_the_defaults(scene):
    """SGD without a config keeps ``run_sgd_icp``'s own defaults (200
    steps, 1e-5), as the JAX package's; coarse-to-fine takes the morton
    matcher for its fine stage unless a matcher is asked for."""
    src, tgt, _ = scene
    calls = {}
    import fpcr_tpu_torch.models.pipeline as tp
    import fpcr_tpu_torch.models.sgd_icp as ts

    saved_sgd, saved_c2f = ts.run_sgd_icp, tp.icp_coarse_to_fine

    def sgd(source, target, config=None, **kw):
        calls["sgd"] = config
        return saved_sgd(source, target, **kw) if config is None else \
            saved_sgd(source, target, config, **kw)

    def c2f(source, target, coarse_config, fine_config, **kw):
        calls.setdefault("c2f", []).append((coarse_config.matcher,
                                            fine_config.matcher))
        return saved_c2f(source, target, coarse_config=coarse_config,
                         fine_config=fine_config, **kw)

    ts.run_sgd_icp, tp.icp_coarse_to_fine = sgd, c2f
    try:
        ft.register(_t(src), _t(tgt), method="sgd")
        ft.register(_t(src), _t(tgt), method="coarse_to_fine")
        ft.register(_t(src), _t(tgt), method="coarse_to_fine",
                    matcher="grid")
    finally:
        ts.run_sgd_icp, tp.icp_coarse_to_fine = saved_sgd, saved_c2f
    assert calls["sgd"] is None
    assert calls["c2f"] == [("xla", "morton"), ("xla", "grid")]


def jax_references():
    """The JAX package's CPU runs of ``chip_smoke.py``'s ``register()``
    path: every method on ``synthetic_scene(width=32)`` under the pose of
    ``tests/test_registry.py``, 60 iterations: GT error and iterations."""
    s = f.synthetic_scene(width=32)
    gt = f.gt_transform((0.02, -0.015, 0.01), (0.03, -0.02, 0.015))
    tgt = gt.apply(s.source)
    for method in f.METHODS:
        res = f.register(s.source, tgt, method=method, max_iterations=60)
        err = float(f.transform_rmse(res.transform, gt, s.source))
        print(f"register {method}: GT error {err:.3e}, "
              f"{int(res.num_iterations)} iterations", flush=True)


if __name__ == "__main__":
    jax_references()
