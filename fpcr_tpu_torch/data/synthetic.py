"""Synthetic benchmark scenes with known ground truth.

The reference's oracle-by-construction setup: a ``z = x² - y²`` surface grid
on ``[XY_min, XY_max]²`` and a target synthesized as ``M = R_gt·D + t_gt``,
so registration is correct when it recovers ``(R_gt, t_gt)``. Clouds are
built with numpy exactly as ``fpcr_tpu.data.synthetic`` builds them, so
both packages get identical inputs, and land on the ``device`` asked for,
the card when none is named (``utils/device.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..core.transforms import RigidTransform, gt_transform
from ..utils.device import resolve_device

DEFAULT_XY_MIN = -2.0
DEFAULT_XY_MAX = 2.0
DEFAULT_TRANSLATION = (0.8, -0.3, 0.2)
DEFAULT_ROTATION = (0.2, -0.2, 0.05)


def surface_grid(width: int, xy_min: float = DEFAULT_XY_MIN,
                 xy_max: float = DEFAULT_XY_MAX, dtype=torch.float32,
                 device=None) -> torch.Tensor:
    """``width² x 3`` cloud sampling ``z = x² - y²`` on a regular grid."""
    axis = np.linspace(xy_min, xy_max, width, dtype=np.float64)
    xs, ys = np.meshgrid(axis, axis, indexing="ij")
    zs = xs * xs - ys * ys
    pts = np.stack([xs.ravel(), ys.ravel(), zs.ravel()], axis=1)
    return torch.as_tensor(pts, dtype=dtype, device=resolve_device(device))


class RegistrationScene(NamedTuple):
    source: torch.Tensor  # D — the data cloud to be registered
    target: torch.Tensor  # M = R_gt·D + t_gt — the model cloud
    ground_truth: RigidTransform


def synthetic_scene(width: int = 128,
                    translation: Sequence[float] = DEFAULT_TRANSLATION,
                    rotation_rad: Sequence[float] = DEFAULT_ROTATION,
                    xy_min: float = DEFAULT_XY_MIN,
                    xy_max: float = DEFAULT_XY_MAX,
                    dtype=torch.float32, device=None) -> RegistrationScene:
    """The reference's standard benchmark scene at a given grid width
    (width=32 → 1,024 pts; 128 → 16,384)."""
    source = surface_grid(width, xy_min, xy_max, dtype, device)
    return transformed_scene(source, translation, rotation_rad)


def transformed_scene(points: torch.Tensor, translation: Sequence[float],
                      rotation_rad: Sequence[float]) -> RegistrationScene:
    """A GT-transformed scene from an arbitrary cloud, on its device."""
    gt = gt_transform(translation, rotation_rad, points.dtype, points.device)
    return RegistrationScene(points, gt.apply(points), gt)


def random_cloud(n: int, seed: int = 0, scale: float = 1.0,
                 dtype=torch.float32, device=None) -> torch.Tensor:
    """Uniform random cloud in ``[-scale, scale]³``, drawn by
    ``numpy.random.default_rng(seed)`` as the JAX package draws it."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.uniform(-scale, scale, size=(n, 3)),
                           dtype=dtype, device=resolve_device(device))
