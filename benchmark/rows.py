"""What a call hands back to the harness: one host row a registration.

A row is the transform's rotation (9, row-major) and translation (3), the
iterations run (1) and the point RMSE of each iteration (``max_iterations``,
NaN after the stop), copied to the host in one transfer; the copy is where a
call's latency ends.
"""

from __future__ import annotations

import torch

ROT, TRANS, ITERS, ERRORS = slice(0, 9), slice(9, 12), 12, slice(13, None)


def pack(result) -> torch.Tensor:
    """The rows ``[B, 13 + max_iterations]`` of an ``ICPResult`` (one
    registration, or a batch's fields with a leading B), on the host."""
    errors = result.errors.reshape(result.num_iterations.numel(), -1)
    return torch.cat([
        result.transform.rotation.reshape(-1, 9),
        result.transform.translation.reshape(-1, 3),
        result.num_iterations.reshape(-1, 1).to(errors.dtype),
        errors], dim=1).cpu()
