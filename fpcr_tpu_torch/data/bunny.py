"""Stanford Bunny loaders.

Two files ship in ``assets/``: ``Bunny_res.csv`` (8,171 points,
whitespace-separated, what the reference drivers load) and ``Bunny.csv``
(35,947 points, semicolon-separated). The delimiter is sniffed so both load;
the native C++ tokenizer parses them where it builds, with numpy as the
fallback.
The Bunny scene's ground truth is the reference's t=(0.01,-0.04,0.02),
r=(0.15,-0.1,0.05). Clouds land on the ``device`` asked for, the card when
none is named.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from ..utils.device import resolve_device
from .paths import asset
from .synthetic import RegistrationScene, transformed_scene

BUNNY_GT_TRANSLATION = (0.01, -0.04, 0.02)
BUNNY_GT_ROTATION = (0.15, -0.1, 0.05)


def parse_xyz(path: Path) -> np.ndarray:
    """Tokenize an ``x y z`` file (whitespace or ';' separated) → [N,3] f32."""
    text = Path(path).read_text()
    if ";" in text[:200]:
        text = text.replace(";", " ")
    arr = np.array(text.split(), dtype=np.float32)
    if arr.size % 3 != 0:
        raise ValueError(f"{path}: token count {arr.size} not divisible by 3")
    return arr.reshape(-1, 3)


def load_xyz_csv(path: Union[str, Path], device=None) -> torch.Tensor:
    """An ``x y z`` cloud file as a ``[N, 3]`` float32 tensor: the native
    tokenizer (``utils/native.py``) where it builds, else :func:`parse_xyz`,
    as the JAX package loads it."""
    from ..utils.native import read_xyz

    try:
        pts = read_xyz(str(path))
    except Exception:
        pts = parse_xyz(Path(path))
    # a copy: the native array is a read-only view of the parser's bytes
    return torch.tensor(pts, device=resolve_device(device))


def load_bunny(resampled: bool = True,
               path: Optional[Union[str, Path]] = None,
               device=None) -> torch.Tensor:
    """The Stanford Bunny cloud (8,171 pts by default; the full 35,947 with
    ``resampled=False``)."""
    if path is None:
        path = asset("Bunny_res.csv" if resampled else "Bunny.csv")
    return load_xyz_csv(path, device=device)


def bunny_scene(resampled: bool = True, device=None) -> RegistrationScene:
    """The reference's Bunny benchmark: source = bunny, target = the
    GT-transformed bunny."""
    pts = load_bunny(resampled=resampled, device=device)
    return transformed_scene(pts, BUNNY_GT_TRANSLATION, BUNNY_GT_ROTATION)
