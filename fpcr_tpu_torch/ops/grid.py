"""Cell sizing from a cloud's point spacing.

Counterpart of ``fpcr_tpu/ops/grid.py``, of which only
:func:`suggest_cell_size` is ported so far: NDT's automatic voxel size
(``models/ndt.py::resolve_voxel_size``) needs it. The voxel-hash matcher,
``voxel_downsample`` and the rest are ROADMAP.md item 5.
"""

from __future__ import annotations

import numpy as np
import torch

from .normals import knn


def suggest_cell_size(q: torch.Tensor, sample: int = 2048,
                      scale: float = 2.0) -> torch.Tensor:
    """≈ ``scale`` × the median nearest-neighbour spacing of a sample, as a
    0-d float32 tensor on ``q``'s device.

    The slice is centred, zero-distance neighbours (duplicates) are left out
    of the median, and a cloud too degenerate to measure falls back to an
    extent-based size, 0 only when the cloud has no extent. The 2-NN
    distances are the difference form: in the expansion form a duplicate's
    distance can round to ~1e-7 instead of 0 and then sets the size."""
    q = q.to(torch.float32)
    q_slice = q[: min(q.shape[0], 65536)]
    q_slice = q_slice - q_slice.mean(dim=0)
    step = max(1, q_slice.shape[0] // sample)
    sub = q_slice[::step][:sample]
    # 2-NN against the slice holding sub: slot 0 is the point itself
    _, d = knn(sub, q_slice, 2, exact=True)
    d1 = torch.clamp(d[:, 1], min=0.0)
    pos = d1 > 0
    n_pos = pos.sum()
    # lower median of the positive spacings (duplicates sort to +inf)
    sorted_d = torch.sort(torch.where(pos, d1, torch.full_like(d1, np.inf)))
    med = torch.sqrt(sorted_d.values[torch.clamp(n_pos - 1, min=0) // 2])
    ext = torch.linalg.vector_norm(q_slice.amax(dim=0) - q_slice.amin(dim=0))
    fallback = ext / float(np.cbrt(np.float32(max(q_slice.shape[0], 1))))
    med = torch.where((n_pos > 0) & torch.isfinite(med) & (med > 0), med,
                      fallback)
    return (scale * med).to(torch.float32)
