"""The device an entry point lands on when the caller names none.

The port runs on the card unless the caller asks for the CPU: every loader,
scene builder and ``interop.*_from_numpy`` takes ``device=None`` to mean
CUDA, and never falls back to the CPU when there is no card.
:func:`to_numpy` brings a tensor from any device back to the host.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``torch.device("cuda")``; an explicit device is returned
    as given. Raises ``RuntimeError`` for ``None`` without a CUDA device."""
    if device is not None:
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "fpcr_tpu_torch runs on the CUDA card by default and found none; "
            'pass device="cpu" to run on the CPU')
    return torch.device("cuda")


def to_numpy(x) -> np.ndarray:
    """A numpy array of a tensor on any device, or of an array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
