"""ICP with its full per-iteration history, and checkpoint / resume.

Counterpart of ``fpcr_tpu/models/history.py``. :func:`run_icp_with_history`
records, every iteration, the incremental and accumulated transforms, the
error, whether the iteration ran, the matched fraction and the size of the
increment, for any metric and matcher: it shares ``run_icp``'s set-up
(``models/icp.py::_prepare``) and iteration (``icp_iteration``).

The JAX version is a fixed-trip ``lax.scan`` of ``max_iterations`` whose
iterations after convergence are masked no-ops. Here the loop stops at the
first ``DONE_CHECK_EVERY`` check after convergence, as ``run_icp`` does, and
the rows after the stop are JAX's masked rows: identity increments, the
frozen accumulated transform, ``errors`` repeating the last error, ``active``
false, ``matched_fraction`` NaN and ``delta_t = delta_rot = 0``.

Checkpoints use the JAX package's format and file names: ``save_checkpoint``
writes ``<path>.npz`` (the suffix appended unless it is already ``.npz``)
and a ``<stem>.config.json`` sidecar, so a checkpoint written by either
package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from ..core.transforms import RigidTransform
from ..utils.device import resolve_device
from ..utils.precision import pin_f32_precision
from .icp import (DONE_CHECK_EVERY, ICPConfig, _prepare, icp_iteration,
                  rotation_angle)


class ICPHistory(NamedTuple):
    transform: RigidTransform  # final accumulated transform
    incremental_rotations: torch.Tensor  # [T, 3, 3]
    incremental_translations: torch.Tensor  # [T, 3]
    accumulated_rotations: torch.Tensor  # [T, 3, 3]
    accumulated_translations: torch.Tensor  # [T, 3]
    errors: torch.Tensor  # [T]
    active: torch.Tensor  # [T] bool — iteration actually executed
    num_iterations: torch.Tensor
    converged: torch.Tensor
    points: torch.Tensor
    matched_fraction: torch.Tensor  # [T] post-trim inlier fraction
    delta_t: torch.Tensor  # [T] ‖Δt‖ per increment
    delta_rot: torch.Tensor  # [T] ∠ΔR (radians) per increment


def run_icp_with_history(source, target, config: ICPConfig = ICPConfig(),
                         target_normals: Optional[torch.Tensor] = None,
                         source_mask: Optional[torch.Tensor] = None,
                         target_mask: Optional[torch.Tensor] = None
                         ) -> ICPHistory:
    """Register ``source`` onto ``target`` on their device, recording every
    iteration; ``[max_iterations]``-long rows, those after the stop JAX's
    masked no-op rows."""
    pin_f32_precision()
    prep = _prepare(source, target, config, source_mask, target_mask,
                    target_normals)
    config, device = prep.config, prep.source.device
    eye = torch.eye(3, device=device)
    zero3 = torch.zeros(3, device=device)
    nan = torch.full((), float("nan"), device=device)
    points, normals = prep.source, prep.source_normals
    acc = RigidTransform(eye, zero3)
    prev_error = torch.full((), float("inf"), device=device)
    done = torch.zeros((), dtype=torch.bool, device=device)
    rows = []
    for it in range(config.max_iterations):
        if it and it % DONE_CHECK_EVERY == 0 and bool(done):
            break
        new_points, inc, error, aux = icp_iteration(
            points, prep.target, config, prep.source_mask, prep.target_mask,
            prep.target_normals, prep.matcher_state, normals)
        # a converged run's iteration is a masked no-op
        inc = RigidTransform(torch.where(done, eye, inc.rotation),
                             torch.where(done, zero3, inc.translation))
        points = torch.where(done, points, new_points)
        if normals is not None:  # full f32 rotation of the carried normals
            normals = torch.matmul(normals, inc.rotation.T)
        error = torch.where(done, prev_error, error)
        acc = inc.compose(acc)
        rows.append((inc.rotation, inc.translation, acc.rotation,
                     acc.translation, error, ~done,
                     torch.where(done, nan, aux.matched_fraction),
                     torch.linalg.vector_norm(inc.translation),
                     rotation_angle(inc.rotation)))
        done = done | (error < config.tolerance) | (
            torch.abs(error - prev_error) < config.tolerance)
        prev_error = error
    # the rows a fixed-trip loop would run after the stop: masked no-ops
    zero = torch.zeros((), device=device)
    idle = (eye, zero3, acc.rotation, acc.translation, prev_error,
            torch.zeros((), dtype=torch.bool, device=device), nan, zero, zero)
    rows += [idle] * (config.max_iterations - len(rows))
    (inc_r, inc_t, acc_r, acc_t, errors, active, fraction, delta_t,
     delta_rot) = (torch.stack(col) for col in zip(*rows))
    if prep.unsort is not None:
        points = points[prep.unsort]
    return ICPHistory(
        transform=acc, incremental_rotations=inc_r,
        incremental_translations=inc_t, accumulated_rotations=acc_r,
        accumulated_translations=acc_t, errors=errors, active=active,
        num_iterations=active.to(torch.int32).sum(), converged=done,
        points=points, matched_fraction=fraction, delta_t=delta_t,
        delta_rot=delta_rot)


def _checkpoint_paths(path: Union[str, Path]) -> tuple:
    """The JAX package's one filename convention for save and load: numpy
    appends '.npz' to a path without that suffix (a foreign suffix stays:
    'run.ckpt' → 'run.ckpt.npz'), and the config sidecar sits next to the
    npz as '<stem>.config.json'."""
    path = Path(path)
    npz = path if path.suffix == ".npz" else path.with_name(path.name + ".npz")
    sidecar = npz.with_name(npz.name[: -len(".npz")] + ".config.json")
    return npz, sidecar


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def save_checkpoint(path: Union[str, Path], history: ICPHistory,
                    config: ICPConfig) -> Path:
    """Persist a registration run (npz arrays + json config sidecar).
    Returns the npz path written ('.npz' appended if absent)."""
    npz, sidecar = _checkpoint_paths(path)
    npz.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        npz,
        **{k: _numpy(v) for k, v in history._asdict().items()
           if k != "transform"},
        rotation=_numpy(history.transform.rotation),
        translation=_numpy(history.transform.translation),
    )
    sidecar.write_text(json.dumps(dataclasses.asdict(config), indent=2))
    return npz


def load_checkpoint(path: Union[str, Path]):
    """Load a saved run → ``(ICPHistory of numpy arrays, ICPConfig or
    None)``; checkpoints without the later fields ``matched_fraction``,
    ``delta_t`` and ``delta_rot`` give None there."""
    npz, config_path = _checkpoint_paths(path)
    with np.load(npz) as data:
        fields = {k: data[k] for k in data.files}
    history = ICPHistory(
        transform=RigidTransform(fields.pop("rotation"),
                                 fields.pop("translation")),
        **{k: fields.get(k) for k in ICPHistory._fields[1:]})
    config = None
    if config_path.exists():
        config = ICPConfig(**json.loads(config_path.read_text()))
    return history, config


def resume_icp(checkpoint: ICPHistory, target, config: ICPConfig,
               **kwargs) -> ICPHistory:
    """Continue a registration from a checkpoint's transformed points (numpy
    or tensors, e.g. from :func:`load_checkpoint` or
    ``interop.history_from_numpy``) on ``target``'s device; the returned
    history composes on top of the checkpoint's transform."""
    device = (target.device if isinstance(target, torch.Tensor)
              else resolve_device())
    points = torch.as_tensor(_numpy(checkpoint.points), dtype=torch.float32,
                             device=device)
    cont = run_icp_with_history(points, target, config, **kwargs)
    dev = cont.transform.rotation.device

    def t(x):
        return torch.as_tensor(_numpy(x), dtype=torch.float32, device=dev)

    total = cont.transform.compose(RigidTransform(
        t(checkpoint.transform.rotation), t(checkpoint.transform.translation)))
    return cont._replace(transform=total)
