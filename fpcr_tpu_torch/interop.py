"""Carrying state between ``fpcr_tpu`` and this package.

A registration system has no weights: its state is the config, the
transforms and the clouds. Everything here takes or returns numpy arrays or
plain dicts, never JAX objects, so this module imports nothing of JAX:

    import dataclasses, numpy as np
    cfg = config_from_dict(dataclasses.asdict(fpcr_tpu.ICPConfig(...)))
    tr = transform_from_numpy(np.asarray(jax_tr.rotation),
                              np.asarray(jax_tr.translation), device="cuda")
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .core.transforms import RigidTransform
from .models.icp import ICPConfig, ICPResult


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
