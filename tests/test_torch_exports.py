"""The port's subpackages re-export what the JAX package's re-export (CPU):
each public name of ``fpcr_tpu.<sub>`` is a name of ``fpcr_tpu_torch.<sub>``
too, and the same object as in the port's submodule that defines it (the
counterpart of the JAX submodule the name comes from)."""

import importlib

import pytest

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
