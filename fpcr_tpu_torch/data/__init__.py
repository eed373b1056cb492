"""Datasets: synthetic scenes, the Stanford Bunny, the Ouster hall scan,
and cloud file IO.

Convenience re-exports so ``from fpcr_tpu_torch.data import load_points``
works; the top-level ``fpcr_tpu_torch`` package re-exports the same names.
"""

from .bunny import bunny_scene, load_bunny
from .ouster import hall_scene, load_hall_scan
from .pointcloud_io import (load_points, read_pcd, read_ply, write_pcd,
                            write_ply)
from .synthetic import (RegistrationScene, surface_grid, synthetic_scene,
                        transformed_scene)

__all__ = [
    "bunny_scene",
    "load_bunny",
    "hall_scene",
    "load_hall_scan",
    "load_points",
    "read_ply",
    "write_ply",
    "read_pcd",
    "write_pcd",
    "RegistrationScene",
    "surface_grid",
    "synthetic_scene",
    "transformed_scene",
]
