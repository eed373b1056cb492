"""Point-cloud containers and padding helpers.

Clouds are plain ``float32[N, 3]`` row-major tensors everywhere in this
package, as in ``fpcr_tpu``. Ragged sizes are handled by padding to a
multiple plus a validity mask.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils.device import resolve_device


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


class MaskedCloud(NamedTuple):
    """A fixed-capacity cloud: ``points[i]`` is valid iff ``mask[i]``."""

    points: torch.Tensor  # [capacity, 3]
    mask: torch.Tensor  # [capacity] bool

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    def count(self) -> torch.Tensor:
        return self.mask.to(torch.int32).sum()


def pad_cloud(
    points,
    multiple: int = 8,
    capacity: Optional[int] = None,
    pad_value: float = 0.0,
) -> MaskedCloud:
    """Pad ``[N, 3]`` points up to ``capacity`` (default: next multiple) with
    a validity mask. Padding rows get ``pad_value`` so they are finite."""
    pts = torch.as_tensor(points, dtype=torch.float32)
    n = pts.shape[0]
    cap = capacity if capacity is not None else round_up(max(n, 1), multiple)
    if cap < n:
        raise ValueError(f"capacity {cap} < number of points {n}")
    padded = torch.full((cap, 3), pad_value, dtype=torch.float32,
                        device=pts.device)
    padded[:n] = pts
    mask = torch.arange(cap, device=pts.device) < n
    return MaskedCloud(points=padded, mask=mask)


def as_points(x, dtype=torch.float32, device=None) -> torch.Tensor:
    """Coerce array-like to an ``[N, 3]`` float tensor. A tensor keeps its
    device unless ``device`` is given; anything else lands on ``device``,
    the card by default (``utils.device.resolve_device``)."""
    if device is None and not isinstance(x, torch.Tensor):
        device = resolve_device()
    arr = torch.as_tensor(x, dtype=dtype, device=device)
    if arr.ndim != 2 or arr.shape[1] != 3:
        raise ValueError(f"expected [N, 3] points, got {tuple(arr.shape)}")
    return arr
