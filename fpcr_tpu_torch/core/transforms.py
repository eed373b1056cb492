"""Rigid transforms and rotation conventions.

Counterpart of ``fpcr_tpu/core/transforms.py``. Clouds are row-major
``[N, 3]`` tensors and a transform is a small NamedTuple of tensors that stay
on the device of the cloud they act on. Both Euler conventions of the
reference are reproduced exactly:

* ``rotation_gt`` builds the ground-truth scene rotation (``M = R·D + t``);
* ``rotation_zyx`` is ``Rz·Ry·Rx``, the point-to-plane update convention.

Matmuls here are float32; :func:`fpcr_tpu_torch.utils.precision.pin_f32_precision`
keeps TF32 out of them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.device import resolve_device


class RigidTransform(NamedTuple):
    """SE(3) transform ``x -> R @ x + t`` acting on row-major ``[N, 3]``.
    A batch of transforms (``[B, 3, 3]``, ``[B, 3]``) applies and composes
    element by element, on ``[B, N, 3]`` points."""

    rotation: torch.Tensor  # [3, 3]
    translation: torch.Tensor  # [3]

    def apply(self, points: torch.Tensor) -> torch.Tensor:
        """Apply to ``[..., 3]`` points (``[B, ..., 3]`` for a batch)."""
        if self.rotation.ndim == 2:
            return torch.matmul(points, self.rotation.T) + self.translation
        return (torch.matmul(points, self.rotation.transpose(-1, -2))
                + self.translation.unsqueeze(-2))

    def compose(self, other: "RigidTransform") -> "RigidTransform":
        """Return ``self ∘ other`` (first ``other``, then ``self``)."""
        t = other.translation
        moved = (torch.matmul(self.rotation, t) if self.rotation.ndim == 2
                 else torch.matmul(self.rotation, t[..., None])[..., 0])
        return RigidTransform(
            rotation=torch.matmul(self.rotation, other.rotation),
            translation=moved + self.translation,
        )

    def inverse(self) -> "RigidTransform":
        rt = self.rotation.T
        return RigidTransform(rotation=rt,
                              translation=-torch.matmul(rt, self.translation))

    @staticmethod
    def identity(dtype=torch.float32, device=None) -> "RigidTransform":
        """The identity on ``device``, the card by default."""
        device = resolve_device(device)
        return RigidTransform(torch.eye(3, dtype=dtype, device=device),
                              torch.zeros(3, dtype=dtype, device=device))

    def as_matrix(self) -> torch.Tensor:
        """Return the 4x4 homogeneous matrix."""
        top = torch.cat([self.rotation, self.translation[:, None]], dim=1)
        bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=top.dtype,
                              device=top.device)
        return torch.cat([top, bottom], dim=0)


def _angle(a, dtype=torch.float32, device=None) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    return torch.as_tensor(a, dtype=dtype, device=device)


def _rows(rows) -> torch.Tensor:
    """A 3x3 from rows of scalars, or [..., 3, 3] from rows of batches."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rotation_x(a) -> torch.Tensor:
    a = _angle(a)
    c, s = torch.cos(a), torch.sin(a)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    return _rows([[one, zero, zero], [zero, c, -s], [zero, s, c]])


def rotation_y(a) -> torch.Tensor:
    a = _angle(a)
    c, s = torch.cos(a), torch.sin(a)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    return _rows([[c, zero, s], [zero, one, zero], [-s, zero, c]])


def rotation_z(a) -> torch.Tensor:
    a = _angle(a)
    c, s = torch.cos(a), torch.sin(a)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    return _rows([[c, -s, zero], [s, c, zero], [zero, zero, one]])


def rotation_zyx(rx, ry, rz) -> torch.Tensor:
    """``Rz(rz) @ Ry(ry) @ Rx(rx)`` in closed form."""
    rx, ry, rz = _angle(rx), _angle(ry), _angle(rz)
    cx, cy, cz = torch.cos(rx), torch.cos(ry), torch.cos(rz)
    sx, sy, sz = torch.sin(rx), torch.sin(ry), torch.sin(rz)
    return _rows([
        [cy * cz, cz * sx * sy - cx * sz, cx * cz * sy + sx * sz],
        [cy * sz, cx * cz + sx * sy * sz, cx * sy * sz - cz * sx],
        [-sy, cy * sx, cx * cy],
    ])


def rotation_gt(rx, ry, rz) -> torch.Tensor:
    """The reference's ground-truth scene rotation (row-major transcription
    of its column-major ``h_r`` construction)."""
    rx, ry, rz = _angle(rx), _angle(ry), _angle(rz)
    cx, cy, cz = torch.cos(rx), torch.cos(ry), torch.cos(rz)
    sx, sy, sz = torch.sin(rx), torch.sin(ry), torch.sin(rz)
    return _rows([
        [cy * cz, -cy * sz, sy],
        [cz * sx * sy + cx * sz, cx * cz - sx * sy * sz, -cy * sx],
        [-cx * cz * sy + sx * sz, cx * sy * sz + cz * sx, cx * cy],
    ])


def gt_transform(translation, rotation_rad, dtype=torch.float32,
                 device=None) -> RigidTransform:
    """The ground-truth ``RigidTransform`` the reference drivers use to
    synthesize target clouds (``M = R·D + t``), on ``device``, the card by
    default."""
    device = resolve_device(device)
    t = torch.as_tensor(translation, dtype=dtype, device=device)
    rx, ry, rz = [torch.as_tensor(a, dtype=dtype, device=device)
                  for a in rotation_rad]
    return RigidTransform(rotation_gt(rx, ry, rz).to(dtype), t)


def skew(v: torch.Tensor) -> torch.Tensor:
    """Cross-product matrices ``[..., 3, 3]`` of vectors ``[..., 3]``:
    ``skew(v) @ x = v × x``."""
    zero = torch.zeros_like(v[..., 0])
    return _rows([[zero, -v[..., 2], v[..., 1]], [v[..., 2], zero, -v[..., 0]],
                  [-v[..., 1], v[..., 0], zero]])


def rotation_exp(w: torch.Tensor) -> torch.Tensor:
    """SO(3) exponential map (Rodrigues): rotation vectors [..., 3] →
    matrices [..., 3, 3], with Taylor-safe small-angle coefficients."""
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    theta = torch.sqrt(theta2)
    one = torch.ones_like(theta)
    a = torch.where(theta < 1e-6, 1.0 - theta2 / 6.0,
                    torch.sin(theta) / torch.where(theta > 0, theta, one))
    b = torch.where(theta < 1e-6, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta))
                    / torch.where(theta2 > 0, theta2, one))
    wx = skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a * wx + b * torch.matmul(wx, wx)


def rotation_log(R: torch.Tensor) -> torch.Tensor:
    """SO(3) logarithm: rotation matrix → rotation vector [3]; stable for
    small angles, not meant for θ → π."""
    cos_theta = torch.clamp((torch.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    v = 0.5 * torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                           R[1, 0] - R[0, 1]])
    sin = torch.sin(theta)
    s = torch.where(theta < 1e-6, 1.0 + theta * theta / 6.0,
                    theta / torch.where(sin != 0, sin, torch.ones_like(sin)))
    return v * s


def transform_to_vector(t: RigidTransform) -> torch.Tensor:
    """Minimal 6-vector ``[rotation vector, translation]``."""
    return torch.cat([rotation_log(t.rotation), t.translation])


def vector_to_transform(x: torch.Tensor) -> RigidTransform:
    return RigidTransform(rotation_exp(x[:3]).to(x.dtype), x[3:6])
