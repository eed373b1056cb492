"""Coarse-to-fine registration: the large-N recipe.

Counterpart of ``fpcr_tpu/models/pipeline.py``:

1. coarse: brute-force ICP on strided subsets of both clouds (a few
   thousand points), which absorbs a large initial displacement;
2. fine: the coarse transform applied, ICP with the Morton band matcher on
   the full clouds, where the residual displacement is small and the band
   search is (near) exact.

The two transforms compose into one source→target estimate.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.cloud import as_points
from ..core.transforms import RigidTransform
from .icp import ICPConfig, ICPResult, run_icp


class CoarseToFineResult(NamedTuple):
    transform: RigidTransform  # total source→target
    coarse: ICPResult
    fine: ICPResult


def _subsample(x: torch.Tensor, max_points: int) -> torch.Tensor:
    """At most ``max_points`` rows at a ceil stride, so the subset spans the
    whole cloud and never degenerates to a prefix."""
    n = x.shape[0]
    if n <= max_points:
        return x
    step = -(-n // max_points)
    return x[::step][:max_points].contiguous()


def icp_coarse_to_fine(
    source, target,
    coarse_config: ICPConfig = ICPConfig(max_iterations=30),
    fine_config: ICPConfig = ICPConfig(matcher="morton", max_iterations=20),
    coarse_points: int = 4096,
    target_normals: Optional[torch.Tensor] = None,
) -> CoarseToFineResult:
    """Register large clouds: brute-force ICP on subsets, then the fine
    stage (by default the Morton band matcher) on the full clouds."""
    source = as_points(source)
    target = as_points(target, device=source.device)
    coarse = run_icp(_subsample(source, coarse_points),
                     _subsample(target, coarse_points), coarse_config)
    fine = run_icp(coarse.transform.apply(source), target, fine_config,
                   target_normals=target_normals)
    return CoarseToFineResult(
        transform=fine.transform.compose(coarse.transform), coarse=coarse,
        fine=fine)
