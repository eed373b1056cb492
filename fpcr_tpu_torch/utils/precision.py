"""The one place that pins float32 arithmetic to full precision.

Geometry in this package stays at f32 grade, as the JAX package pins
``Precision.HIGHEST`` on every matmul: TF32 keeps about three decimal digits,
which breaks the 1e-6 convergence test and argmin parity near ties
(docs/architecture.md). PyTorch runs float32 matmuls in full precision by
default but lets cuDNN use TF32, so every setting is stated here and the
public entry points call :func:`pin_f32_precision`.
"""

from __future__ import annotations

from typing import Dict

import torch


def pin_f32_precision() -> None:
    """Forbid TF32 in matmuls and convolutions (process-wide PyTorch flags)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def precision_settings() -> Dict[str, object]:
    """The three settings as they stand, for logs and checks."""
    return {
        "torch.backends.cuda.matmul.allow_tf32":
            torch.backends.cuda.matmul.allow_tf32,
        "torch.backends.cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
        "torch.get_float32_matmul_precision":
            torch.get_float32_matmul_precision(),
    }
