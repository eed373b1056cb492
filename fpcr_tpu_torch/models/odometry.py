"""Scan-sequence odometry: a whole trajectory of clouds registered at once.

Counterpart of ``fpcr_tpu/models/odometry.py``. Given T frames of a moving
sensor, :func:`register_sequence` estimates every frame's pose in frame-0
coordinates: the T−1 consecutive-pair registrations are independent, so
they run as one :func:`models.batch.register_batch` (one batched loop for
every config, one matcher call an iteration for all pairs: on the card K1,
or K3 a shift for the morton matcher of large scans), and the poses
accumulate by a prefix product of
the 4x4 homogeneous matrices. The JAX package takes that product with
``lax.associative_scan`` (a tree of depth log T); here it is a sequential
product, T−1 small matmuls at trajectory scale, which rounds in another
order.

Convention: ``relative[t]`` maps frame t+1 coordinates into frame t (frame
t+1's cloud is registered onto frame t's), so ``pose[t] = rel[0] @ rel[1] @
... @ rel[t-1]`` maps frame t into frame 0.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..core.transforms import RigidTransform
from ..ops.grid import voxel_downsample
from ..utils.precision import pin_f32_precision
from .batch import _as_batch, register_batch
from .icp import ICPConfig, ICPResult
from .pose_graph import _homogeneous


class OdometryResult(NamedTuple):
    poses: torch.Tensor  # [T, 4, 4] homogeneous frame->frame-0 transforms
    relative: ICPResult  # the T-1 pairwise registrations (batched fields)

    def pose(self, t: int) -> RigidTransform:
        m = self.poses[t]
        return RigidTransform(m[:3, :3], m[:3, 3])


def register_sequence(frames, config: ICPConfig = ICPConfig()
                      ) -> OdometryResult:
    """Estimate the trajectory of a cloud sequence ``frames [T, N, 3]``:
    frame t+1 is registered onto frame t (all pairs in one batch), then the
    poses accumulate by a prefix product. ``poses[0]`` is the identity."""
    pin_f32_precision()
    frames = _as_batch(frames, "frames")
    if frames.shape[0] < 2:
        raise ValueError("frames must be [T>=2, N, 3]")
    rel = register_batch(frames[1:], frames[:-1], config)  # t+1 -> t
    mats = _homogeneous(rel.transform.rotation, rel.transform.translation)
    poses = [torch.eye(4, dtype=mats.dtype, device=mats.device)]
    for m in mats:
        poses.append(torch.matmul(poses[-1], m))
    return OdometryResult(poses=torch.stack(poses), relative=rel)


def build_map(frames, poses, voxel_size,
              masks: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fuse a registered scan sequence into one downsampled map: every
    frame into frame-0 coordinates by its pose (one batched matmul),
    concatenated and voxel-downsampled. Returns ``(points [T*N, 3], valid
    [T*N] bool)``, the padded convention of ``ops/grid.py::
    voxel_downsample``.

    Args:
      frames: ``[T, N, 3]`` scan sequence (the odometry input).
      poses: ``[T, 4, 4]`` frame→frame-0 poses (``OdometryResult.poses``
        or ``PoseGraphResult.poses``).
      voxel_size: map resolution.
      masks: optional ``[T, N]`` validity masks: pad rows must not fuse
        into the map as phantom geometry.
    """
    pin_f32_precision()
    frames = _as_batch(frames, "frames")
    poses = torch.as_tensor(poses, dtype=torch.float32, device=frames.device)
    if poses.ndim != 3 or tuple(poses.shape[1:]) != (4, 4) or \
            poses.shape[0] != frames.shape[0]:
        raise ValueError(f"poses must be [T={frames.shape[0]}, 4, 4], got "
                         f"{tuple(poses.shape)}")
    world = (torch.matmul(frames, poses[:, :3, :3].transpose(1, 2))
             + poses[:, None, :3, 3])
    flat_mask = None if masks is None else torch.as_tensor(
        masks, device=frames.device).reshape(-1)
    return voxel_downsample(world.reshape(-1, 3), voxel_size, flat_mask)
