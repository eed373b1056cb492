"""Carrying state between ``fpcr_tpu`` and this package.

A registration system has no weights: its state is the config, the
transforms and the clouds. Everything here takes or returns numpy arrays or
plain dicts, never JAX objects, so this module imports nothing of JAX:

    import dataclasses, numpy as np
    cfg = config_from_dict(dataclasses.asdict(fpcr_tpu.ICPConfig(...)))
    tr = transform_from_numpy(np.asarray(jax_tr.rotation),
                              np.asarray(jax_tr.translation), device="cuda")
    table = morton_table_from_numpy(jax_table, device="cuda")
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .core.transforms import RigidTransform
from .models.icp import ICPConfig, ICPResult
from .ops.morton import MortonTable


def config_from_dict(d: Dict[str, object]) -> ICPConfig:
    """An ``ICPConfig`` from the dict of another package's ``ICPConfig``
    (``dataclasses.asdict``); an unknown field raises ``TypeError``."""
    return ICPConfig(**d)


def transform_from_numpy(rotation, translation, device=None,
                         dtype=torch.float32) -> RigidTransform:
    return RigidTransform(
        torch.tensor(np.asarray(rotation), dtype=dtype, device=device),
        torch.tensor(np.asarray(translation), dtype=dtype, device=device))


def result_to_numpy(res: ICPResult) -> Dict[str, np.ndarray]:
    """Every field of an ``ICPResult`` as numpy, the transform as
    ``rotation`` and ``translation``."""
    out = {"rotation": res.transform.rotation,
           "translation": res.transform.translation}
    for name in ICPResult._fields[1:]:
        out[name] = getattr(res, name)
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


def points_from_numpy(x, device=None) -> torch.Tensor:
    """A cloud or its normals ``[N, 3]`` as a contiguous float32 tensor."""
    a = torch.tensor(np.asarray(x), dtype=torch.float32, device=device)
    if a.ndim != 2 or a.shape[1] != 3:
        raise ValueError(f"expected [N, 3], got {tuple(a.shape)}")
    return a


def morton_table_from_numpy(table, device=None) -> MortonTable:
    """A ``MortonTable`` from any object with the six fields of one (for
    example ``fpcr_tpu.ops.morton.MortonTable``), each read with
    ``np.asarray``; so a test can hand another package's table to the band
    matcher and check the matcher apart from the table build."""
    def f32(x):
        return torch.tensor(np.asarray(x), dtype=torch.float32,
                            device=device)

    def i32(x):
        return torch.tensor(np.asarray(x), dtype=torch.int32, device=device)

    return MortonTable(
        points_sorted=f32(table.points_sorted).contiguous(),
        codes_sorted=i32(table.codes_sorted), orig_index=i32(table.orig_index),
        lo=f32(table.lo), inv_extent=f32(table.inv_extent),
        valid_count=i32(table.valid_count).reshape(()))
