"""The port's public surface against the JAX package's (CPU).

Its subpackages re-export what the JAX package's re-export: each public
name of ``fpcr_tpu.<sub>`` is a name of ``fpcr_tpu_torch.<sub>`` too, and
the same object as in the port's submodule that defines it (the
counterpart of the JAX submodule the name comes from). Every public
function of a JAX module takes its positional parameters in the same
order in the port, so a call written for the JAX package binds each
argument to the same parameter; ``run_icp`` and ``icp_iteration`` called
so give the keyword call's result and JAX's.
"""

import importlib
import inspect
import pkgutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fpcr_tpu as f
import fpcr_tpu_torch as ft

SUBPACKAGES = ("bench", "core", "data", "models", "ops", "parallel", "utils")


def _public(mod):
    """``{name: JAX submodule}`` of the names a JAX subpackage re-exports:
    its ``__all__``, or else every public attribute that is not itself a
    submodule."""
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [k for k, v in vars(mod).items()
                 if not k.startswith("_") and not hasattr(v, "__path__")
                 and getattr(v, "__module__", None) is not None
                 and type(v).__name__ != "module"]
    return {k: getattr(mod, k).__module__ for k in names}


CASES = [(sub, name, src)
         for sub in SUBPACKAGES
         for name, src in sorted(_public(importlib.import_module(
             f"fpcr_tpu.{sub}")).items())]


def test_jax_subpackages_re_export_the_core_and_data_names():
    names = {sub: {n for s, n, _ in CASES if s == sub} for sub in SUBPACKAGES}
    assert names["core"] == {"RigidTransform", "MaskedCloud", "pad_cloud",
                             "rmse", "transform_rmse"}
    assert "load_points" in names["data"] and len(names["data"]) == 13
    assert not names["parallel"]


@pytest.mark.parametrize("sub,name,src", CASES,
                         ids=[f"{s}.{n}" for s, n, _ in CASES])
def test_port_subpackage_re_exports(sub, name, src):
    port = importlib.import_module(f"fpcr_tpu_torch.{sub}")
    assert hasattr(port, name), f"fpcr_tpu_torch.{sub} lacks {name}"
    defining = importlib.import_module(src.replace("fpcr_tpu.",
                                                   "fpcr_tpu_torch.", 1))
    assert getattr(port, name) is getattr(defining, name)


def test_port_data_all_is_jax_data_all():
    import fpcr_tpu.data as jd

    import fpcr_tpu_torch.data as td

    assert td.__all__ == jd.__all__


def test_imports_from_the_subpackages():
    from fpcr_tpu_torch.core import RigidTransform
    from fpcr_tpu_torch.data import load_points

    import fpcr_tpu_torch as ft

    assert RigidTransform is ft.RigidTransform
    assert load_points is ft.load_points


# JAX modules with no module of that name in the port, and why
NO_COUNTERPART = {
    "fpcr_tpu.models.reference_impl": "the numpy float64 golden model, "
    "which the port's tests call as it is",
    "fpcr_tpu.ops.matching_pallas": "TPU kernels K1, K2: their Hopper "
    "counterparts are csrc/nn_tc.cu and ops/matching_cuda.py",
    "fpcr_tpu.ops.morton_pallas": "TPU kernels K3, K3p: csrc/morton.cu and "
    "ops/morton_cuda.py",
    "fpcr_tpu.ops.ndt_pallas": "TPU kernel K4: csrc/ndt.cu and "
    "ops/ndt_cuda.py",
    "fpcr_tpu.utils.platform": "a TPU-only harness",
}
# public functions the port leaves out or moves (ROADMAP, "Not ported on
# purpose")
NOT_PORTED = {
    "fpcr_tpu.core.cloud.fit_unroll": "the TPU kernel's static unroll",
    "fpcr_tpu.core.cloud.padded_chunks": "the TPU kernel's static unroll",
    "fpcr_tpu.core.cloud.to_numpy": "moved: utils/device.py::to_numpy",
    "fpcr_tpu.utils.timing.benchmark": "moved: utils/timing.py::"
    "cuda_time_ms",
    "fpcr_tpu.utils.timing.slope_benchmark": "moved: utils/timing.py::"
    "slope_ms_per_iter",
}
# JAX parameter names the port renames: a mesh axis is a torch.distributed
# process group there, and RANSAC's PRNG key a seed
RENAMED = {"axis_name": "group", "key": "seed"}
# JAX parameters the port drops: the TPU kernel's static unroll (K3 takes
# any chunk count)
DROPPED = {"unroll"}
# parameters the port appends after JAX's: ``device``, where tensors are
# made (the card unless told otherwise), and ``cpu`` in
# initialize_multihost (gloo on the CPU in place of NCCL)
APPENDED = {None: ("device",), "initialize_multihost": ("cpu",)}


def _jax_functions():
    """``[(module, name)]`` of every public function defined in a JAX
    module that has a counterpart in the port, jitted ones included."""
    out = []
    for info in pkgutil.walk_packages(f.__path__, "fpcr_tpu."):
        if info.name.endswith("__main__") or info.name in NO_COUNTERPART:
            continue
        mod = importlib.import_module(info.name)
        out += [(info.name, name) for name, obj in sorted(vars(mod).items())
                if not name.startswith("_") and callable(obj)
                and not inspect.isclass(obj)
                and getattr(obj, "__module__", None) == info.name]
    return out


FUNCTIONS = _jax_functions()
SIGNATURE_CASES = [(m, n) for m, n in FUNCTIONS
                   if f"{m}.{n}" not in NOT_PORTED]


def _port_module(name):
    return importlib.import_module(name.replace("fpcr_tpu.",
                                                "fpcr_tpu_torch.", 1))


def _positional(fn):
    return [p.name for p in inspect.signature(fn).parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]


@pytest.mark.parametrize("mod,name", SIGNATURE_CASES,
                         ids=[f"{m[9:]}.{n}" for m, n in SIGNATURE_CASES])
def test_port_takes_jax_positional_order(mod, name):
    """The port's positional parameters are JAX's, in JAX's order (read
    through RENAMED, without DROPPED), then at most the APPENDED ones."""
    jax_fn = getattr(importlib.import_module(mod), name)
    port_fn = getattr(_port_module(mod), name)
    want = [RENAMED.get(n, n) for n in _positional(jax_fn)
            if n not in DROPPED]
    got = _positional(port_fn)
    assert got[:len(want)] == want
    assert tuple(got[len(want):]) in ((), APPENDED[None],
                                      APPENDED.get(name, ()))


def test_signature_cases_cover_the_package():
    """The comparison reaches the jitted entry points and every module
    with a counterpart; what the port lacks is exactly NOT_PORTED, and
    every module NO_COUNTERPART names is absent from the port."""
    assert len(SIGNATURE_CASES) >= 130
    names = {f"{m}.{n}" for m, n in SIGNATURE_CASES}
    assert {"fpcr_tpu.models.icp.run_icp", "fpcr_tpu.models.icp.icp_iteration",
            "fpcr_tpu.ops.matching.pairwise_sqdist",
            "fpcr_tpu.parallel.dist_icp.make_mesh",
            "fpcr_tpu.core.metrics.masked_count"} <= names
    missing = {f"{m}.{n}" for m, n in FUNCTIONS
               if not hasattr(_port_module(m), n)}
    assert missing == set(NOT_PORTED)
    for mod in NO_COUNTERPART:
        with pytest.raises(ModuleNotFoundError):
            _port_module(mod)


def test_pairwise_sqdist_and_make_mesh_take_jax_arguments():
    """``pairwise_sqdist`` takes JAX's ``precision`` and computes in full
    float32 whatever it is; ``make_mesh`` takes the axis name, which a
    process group does not carry, and refuses a name that is no string."""
    from fpcr_tpu.ops.matching import pairwise_sqdist as j_sqdist
    from fpcr_tpu_torch.ops.matching import pairwise_sqdist
    from fpcr_tpu_torch.parallel import dist_icp

    rng = np.random.default_rng(3)
    p, q = (rng.normal(size=(40, 3)).astype(np.float32) for _ in range(2))
    base = pairwise_sqdist(torch.as_tensor(p), torch.as_tensor(q))
    for precision in (None, jax.lax.Precision.DEFAULT, "highest"):
        got = pairwise_sqdist(torch.as_tensor(p), torch.as_tensor(q),
                              precision)
        assert torch.equal(got, base)
    np.testing.assert_allclose(
        base.numpy(), np.asarray(j_sqdist(jnp.asarray(p), jnp.asarray(q),
                                          jax.lax.Precision.DEFAULT)),
        rtol=1e-6, atol=1e-6)
    assert dist_icp.make_mesh(1, "points") == dist_icp.make_mesh()
    with pytest.raises(TypeError, match="str"):
        dist_icp.make_mesh(None, 0)


def _jax_order_scene(matcher):
    """``(src, tgt, target normals, source normals)`` as numpy, the normals
    JAX's estimates, so that both packages see the same ones."""
    if matcher == "morton":
        src = np.array(f.synthetic_scene(width=32).source)
        gt = f.gt_transform((0.004, -0.003, 0.002), (0.002, -0.003, 0.002))
        tgt = np.array(gt.apply(jnp.asarray(src)))
    else:
        s = f.synthetic_scene(width=24)
        src, tgt = np.array(s.source), np.array(s.target)
    tn = np.array(f.estimate_normals(jnp.asarray(tgt)))
    sn = np.array(f.estimate_normals(jnp.asarray(src)))
    return src, tgt, tn, sn


def _tensors(res):
    """Every tensor of a result, nested tuples (a transform) flattened."""
    out = []
    for x in res:
        out += [x] if isinstance(x, torch.Tensor) else _tensors(x)
    return out


def _rmse_between(a, b, probe):
    d = ((probe @ np.asarray(a.rotation).T + np.asarray(a.translation))
         - (probe @ np.asarray(b.rotation).T + np.asarray(b.translation)))
    return float(np.sqrt((d * d).sum(1).mean()))


@pytest.mark.parametrize("matcher", ["xla", "morton"])
def test_run_icp_in_jax_positional_order(matcher):
    """``run_icp(src, tgt, cfg, None, None, tn, None, sn)``, as the JAX
    package calls its own (``fpcr_tpu/models/batch.py:39``), symmetric
    metric: the port uses ``sn`` and gives the keyword call's result bit
    for bit, and JAX's within ``tests/test_torch_icp.py``'s tolerances
    (iterations within 1, transforms within 1e-5 RMSE, both within 1e-4
    of the other package's ground truth)."""
    src, tgt, tn, sn = _jax_order_scene(matcher)
    kw = dict(metric="symmetric", matcher=matcher, max_iterations=30)
    T = [torch.as_tensor(x) for x in (src, tgt, tn, sn)]
    pos = ft.run_icp(T[0], T[1], ft.ICPConfig(**kw), None, None, T[2], None,
                     T[3])
    key = ft.run_icp(T[0], T[1], ft.ICPConfig(**kw), target_normals=T[2],
                     source_normals=T[3])
    for a, b in zip(_tensors(pos), _tensors(key)):  # rows after the stop NaN
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    J = [jnp.asarray(x) for x in (src, tgt, tn, sn)]
    j = f.run_icp(J[0], J[1], f.ICPConfig(**kw), None, None, J[2], None,
                  J[3])
    nj, nt = int(j.num_iterations), int(pos.num_iterations)
    assert abs(nj - nt) <= 1, (nj, nt)
    assert _rmse_between(pos.transform, j.transform, src) < 1e-5
    estimated = ft.run_icp(T[0], T[1], ft.ICPConfig(**kw),
                           target_normals=T[2])
    assert not torch.equal(estimated.transform.rotation,
                           pos.transform.rotation)  # sn was used


@pytest.mark.parametrize("matcher", ["xla", "morton"])
def test_icp_iteration_in_jax_positional_order(matcher):
    """``icp_iteration(points, target, cfg, None, None, tn, None, state,
    sn)``, JAX's order: the keyword call's result bit for bit, and JAX's
    within ``tests/test_torch_icp.py``'s 1e-5."""
    from fpcr_tpu.models.icp import build_matcher_state as j_state
    from fpcr_tpu.models.icp import icp_iteration as j_iteration

    from fpcr_tpu_torch.models.icp import build_matcher_state, icp_iteration

    src, tgt, tn, sn = _jax_order_scene(matcher)
    kw = dict(metric="symmetric", matcher=matcher)
    T = [torch.as_tensor(x) for x in (src, tgt, tn, sn)]
    cfg = f.ICPConfig(**kw)
    tcfg = ft.ICPConfig(**kw)
    state = (build_matcher_state(T[1], None, tcfg, T[2])
             if matcher == "morton" else None)
    pos = icp_iteration(T[0], T[1], tcfg, None, None, T[2], None, state,
                        T[3])
    key = icp_iteration(T[0], T[1], tcfg, target_normals=T[2],
                        matcher_state=state, source_normals=T[3])
    assert torch.equal(pos[0], key[0]) and torch.equal(pos[2], key[2])
    assert torch.equal(pos[1].rotation, key[1].rotation)
    J = [jnp.asarray(x) for x in (src, tgt, tn, sn)]
    jstate = j_state(J[1], None, cfg, J[2]) if matcher == "morton" else None
    j = j_iteration(J[0], J[1], cfg, None, None, J[2], None, jstate, J[3])
    np.testing.assert_allclose(pos[0].numpy(), np.asarray(j[0]), atol=1e-5)
    np.testing.assert_allclose(pos[1].rotation.numpy(),
                               np.asarray(j[1].rotation), atol=1e-5)
    np.testing.assert_allclose(float(pos[2]), float(j[2]), atol=1e-5)
