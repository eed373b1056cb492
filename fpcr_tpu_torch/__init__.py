"""fpcr_tpu_torch — point-cloud registration in PyTorch and CUDA.

The port of ``fpcr_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100, slice
by slice. Ported so far: point-to-point, point-to-plane and symmetric ICP
with PCA normals, the exact brute-force matcher and the Morton band matcher
for large clouds, the coarse-to-fine pipeline, and NDT registration (the
voxel Gaussian grid, ``run_ndt``, ``register_ndt``). Three kernels carry
them, all CUDA C++ for ``sm_90a`` built with ``nvcc`` at first launch: the
brute-force nearest-neighbour matcher K1 (``csrc/matching.cu``), the Morton
band matcher K3 (``csrc/morton.cu``) and NDT's fused direct7 moments K4
(``csrc/ndt.cu``); a CPU tensor takes their plain PyTorch versions. The
layout and the public names follow ``fpcr_tpu``, which stays the reference
the port is tested against. The package imports torch and numpy, never JAX.
"""

__version__ = "0.3.0"

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
                         icp_point_to_plane, icp_point_to_point, run_icp,
                         tune_morton)
from .models.ndt import (NDTConfig, NDTResult, register_ndt,
                         resolve_ndt_config, run_ndt)
from .models.pipeline import CoarseToFineResult, icp_coarse_to_fine
from .ops.matching import gather_correspondences, nn_argmin, pairwise_sqdist
from .ops.morton import (MortonTable, build_morton_table, knn_morton,
                         morton_nn, source_morton_order)
from .ops.ndt import NDTGrid, build_ndt_grid, ndt_lookup
from .ops.normals import estimate_normals, orient_normals
from .ops.solve import kabsch_transform, point_to_plane_transform

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
    "icp_point_to_plane",
    "icp_point_to_point",
    "run_icp",
    "tune_morton",
    "icp_coarse_to_fine",
    "CoarseToFineResult",
    "NDTConfig",
    "NDTResult",
    "run_ndt",
    "register_ndt",
    "resolve_ndt_config",
    "NDTGrid",
    "build_ndt_grid",
    "ndt_lookup",
    "estimate_normals",
    "orient_normals",
    "MortonTable",
    "build_morton_table",
    "source_morton_order",
    "morton_nn",
    "knn_morton",
    "nn_argmin",
    "gather_correspondences",
    "pairwise_sqdist",
    "kabsch_transform",
    "point_to_plane_transform",
    "surface_grid",
    "synthetic_scene",
    "transformed_scene",
]
