"""fpcr_tpu_torch — point-cloud registration in PyTorch and CUDA.

The port of ``fpcr_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100, slice
by slice. Ported so far: point-to-point, point-to-plane, symmetric and
Generalized ICP with PCA normals, the exact brute-force matcher, the
voxel-hash grid matcher and the Morton band matcher for large clouds, the
loop variants (scaled ICP, Anderson-accelerated AA-ICP, stochastic
SGD-ICP), the coarse-to-fine pipeline, voxel downsampling,
``evaluate_registration`` and the per-stage profiler ``profile_icp``, NDT
registration (the voxel Gaussian grid, ``run_ndt``, ``register_ndt``), the
packed (value|index) reduction of both matchers
(``pallas_mode='packed6_idx'``), batch serving (``register_batch``: one
launch pair of K1 or K2 an iteration for a whole batch), ICP history with
checkpoint and resume, odometry (``register_sequence``, ``build_map``), the
SE(3) pose graph and loop closure, registration uncertainty, FPFH + RANSAC
global registration, the one front door ``register``, the sharded ICP and
NDT loops over ``torch.distributed`` ranks (``parallel/``), PLY/PCD file
I/O, the command line (``python -m fpcr_tpu_torch``), the JAX package's
six examples (``fpcr_tpu_torch.examples``) and its scripts: the headline
bench, the large-N and NDT benchmarks, the fuzz, the on-device guards and
the multi-process runs (``fpcr_tpu_torch.bench``). Its kernels are
all CUDA C++ for ``sm_90a`` built with ``nvcc`` at first launch: the
brute-force nearest-neighbour matcher K1 and its packed twin K2
(``csrc/nn_tc.cu``; ``csrc/matching.cu`` holds their CUDA-core sweep, the
min-only sweep of the packed-reduction study ``bench/packed_reduction.py``
and the E1 forms), the Morton band matcher K3 and its packed twin K3p
(``csrc/morton.cu``), NDT's fused direct7 moments K4 (``csrc/ndt.cu``) and
the studies' Kernel S (``csrc/split_wgmma.cu``; ``csrc/split_mma.cu`` holds
its first design, the yardstick); a CPU tensor takes their
plain PyTorch versions. Every entry point runs on the card unless the
caller asks for the CPU: loaders and scene functions take ``device="cpu"``
for that, and a function given tensors runs on their device. The layout and
the public names follow ``fpcr_tpu``, which stays the reference the port is
tested against. The package imports torch and numpy, never JAX.
"""

__version__ = "0.4.0"

from .core.cloud import MaskedCloud, pad_cloud
from .core.metrics import evaluate_registration, rmse, transform_rmse
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
from .data.pointcloud_io import (load_points, read_pcd, read_ply, write_pcd,
                                 write_ply)
from .data.ouster import hall_scene, load_hall_scan
from .data.synthetic import (RegistrationScene, surface_grid, synthetic_scene,
                             transformed_scene)
from .models.anderson import run_aa_icp
from .models.batch import register_batch
from .models.global_reg import (GlobalRegResult, global_registration,
                                register_global)
from .models.history import (ICPHistory, load_checkpoint, resume_icp,
                             run_icp_with_history, save_checkpoint)
from .models.icp import (ICPConfig, ICPResult, icp_generalized, icp_iteration,
                         icp_point_to_plane, icp_point_to_point, run_icp,
                         tune_morton)
from .models.ndt import (NDTConfig, NDTResult, register_ndt,
                         resolve_ndt_config, run_ndt)
from .models.odometry import OdometryResult, build_map, register_sequence
from .models.pipeline import CoarseToFineResult, icp_coarse_to_fine
from .models.pose_graph import (PoseGraphResult, close_loops,
                                detect_loop_closures, optimize_pose_graph)
from .models.registry import METHODS, register
from .models.scaled_icp import ScaledICPResult, run_scaled_icp
from .models.sgd_icp import run_sgd_icp
from .models.uncertainty import (information_from_covariance,
                                 registration_covariance)
from .ops.fpfh import fpfh_features
from .ops.grid import (build_voxel_table, grid_nn, suggest_cell_size,
                       voxel_downsample)
from .ops.matching import (gather_correspondences, nn_argmin,
                           nn_argmin_packed, pairwise_sqdist)
from .ops.morton import (MortonTable, build_morton_table, knn_morton,
                         morton_nn, source_morton_order)
from .ops.ndt import NDTGrid, build_ndt_grid, ndt_lookup
from .ops.normals import estimate_normals, orient_normals
from .ops.solve import (kabsch_transform, point_to_plane_transform,
                        umeyama_transform)
from .utils.timing import PhaseTimer, profile_icp

__all__ = [
    "register",
    "METHODS",
    "register_batch",
    "ICPHistory",
    "run_icp_with_history",
    "save_checkpoint",
    "load_checkpoint",
    "resume_icp",
    "OdometryResult",
    "register_sequence",
    "build_map",
    "PoseGraphResult",
    "optimize_pose_graph",
    "close_loops",
    "detect_loop_closures",
    "registration_covariance",
    "information_from_covariance",
    "fpfh_features",
    "GlobalRegResult",
    "global_registration",
    "register_global",
    "bunny_scene",
    "load_bunny",
    "load_points",
    "read_ply",
    "write_ply",
    "read_pcd",
    "write_pcd",
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
    "evaluate_registration",
    "icp_generalized",
    "icp_iteration",
    "icp_point_to_plane",
    "icp_point_to_point",
    "run_icp",
    "tune_morton",
    "run_aa_icp",
    "run_sgd_icp",
    "ScaledICPResult",
    "run_scaled_icp",
    "build_voxel_table",
    "grid_nn",
    "suggest_cell_size",
    "voxel_downsample",
    "PhaseTimer",
    "profile_icp",
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
    "nn_argmin_packed",
    "gather_correspondences",
    "pairwise_sqdist",
    "kabsch_transform",
    "umeyama_transform",
    "point_to_plane_transform",
    "surface_grid",
    "synthetic_scene",
    "transformed_scene",
]
