"""fpcr_tpu_torch — point-cloud registration in PyTorch and CUDA.

The port of ``fpcr_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100, slice
by slice. This slice is the main path: point-to-point ICP with exact
brute-force matching. Its one kernel, the nearest-neighbour matcher K1, is
CUDA C++ for ``sm_90a`` (``csrc/matching.cu``), built with ``nvcc`` at its
first launch; a CPU tensor takes its plain PyTorch version. The layout and
the public names follow ``fpcr_tpu``, which stays the reference the port is
tested against. The package imports torch and numpy, never JAX.
"""

__version__ = "0.1.0"

from .core.cloud import MaskedCloud, pad_cloud
from .core.metrics import rmse, transform_rmse
from .core.transforms import (
    RigidTransform,
    gt_transform,
    rotation_gt,
    rotation_x,
    rotation_y,
    rotation_z,
    rotation_zyx,
)
from .data.bunny import bunny_scene, load_bunny
from .data.ouster import hall_scene, load_hall_scan
from .data.synthetic import (RegistrationScene, surface_grid, synthetic_scene,
                             transformed_scene)
from .models.icp import (ICPConfig, ICPResult, icp_iteration,
                         icp_point_to_point, run_icp)
from .ops.matching import gather_correspondences, nn_argmin, pairwise_sqdist
from .ops.solve import kabsch_transform

__all__ = [
    "bunny_scene",
    "load_bunny",
    "hall_scene",
    "load_hall_scan",
    "RigidTransform",
    "MaskedCloud",
    "ICPConfig",
    "ICPResult",
    "RegistrationScene",
    "gt_transform",
    "rotation_gt",
    "rotation_x",
    "rotation_y",
    "rotation_z",
    "rotation_zyx",
    "pad_cloud",
    "rmse",
    "transform_rmse",
    "icp_iteration",
    "icp_point_to_point",
    "run_icp",
    "nn_argmin",
    "gather_correspondences",
    "pairwise_sqdist",
    "kabsch_transform",
    "surface_grid",
    "synthetic_scene",
    "transformed_scene",
]
