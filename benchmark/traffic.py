"""The one traffic generator: a pool of registration requests from a seed.

A traffic file (``benchmark/traffic/<name>.json``) gives the parameters:

* ``pool``: how many distinct requests there are; the window cycles
  through them, each pass in a new order drawn from the run's seed;
* ``rotation``: ``{"kind": "axis_angle", "max_deg": a}`` (angle uniform in
  [0, a] about a uniform axis) or ``{"kind": "per_axis", "max_rad": a}``
  (each Euler angle uniform in [-a, a], applied Rz Ry Rx);
* ``translation``: ``{"kind": "ball", "radius": r}`` (uniform in the ball)
  or ``{"kind": "per_axis", "max": a}`` (each axis uniform in [-a, a]);
* ``source_noise``, ``target_noise``: the sigma of Gaussian noise added to
  every point of each request's source and target;
* ``shared_target``: every request registers onto the configuration's cloud
  itself (a map), else onto its own noisy copy.

* ``request_seed``: the fixed seed of the requests' poses and noise.

Every run registers the same requests: a request's iterations, and so its
work, follow from its pose and its noise, so requests drawn from the run's
seed would make two seeds do different work. The pool's rotation angles,
translation radii and per-axis values are the midpoints of ``pool``
equal-probability strata of the stated distribution, paired with
directions drawn from ``request_seed``, which draws the noise as well. The
run's seed draws the order in which the window takes the requests, and the
sample that is checked.

A request registers ``source = R cloud + t (+ noise)`` onto ``target =
cloud (+ noise)``. The noise is drawn on the device by a ``torch.Generator``
in one call per cloud kind; the poses on the host in float64.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class Pool(NamedTuple):
    sources: torch.Tensor  # [P, N, 3] float32 on the device
    targets: Optional[torch.Tensor]  # [P, M, 3], or None when shared
    shared_target: Optional[torch.Tensor]  # [M, 3], or None
    rotations: np.ndarray  # [P, 3, 3] float64: the poses drawn
    translations: np.ndarray  # [P, 3]

    def __len__(self) -> int:
        return self.sources.shape[0]

    def target(self, i: int) -> torch.Tensor:
        return self.shared_target if self.targets is None else self.targets[i]

    def batch_targets(self, ids: torch.Tensor) -> torch.Tensor:
        if self.targets is None:
            return self.shared_target.expand(ids.shape[0], -1, -1)
        return self.targets.index_select(0, ids)


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, stream]))


def _strata(rng, n: int) -> np.ndarray:
    """The midpoints of ``n`` equal strata of [0, 1], in a random order."""
    return rng.permutation((np.arange(n) + 0.5) / n)


def _unit_vectors(rng, n: int) -> np.ndarray:
    v = rng.standard_normal((n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _axis_angle(axes: np.ndarray, angles: np.ndarray) -> np.ndarray:
    """Rodrigues' rotation matrices ``[n, 3, 3]``."""
    k = np.zeros((axes.shape[0], 3, 3))
    k[:, 0, 1], k[:, 0, 2] = -axes[:, 2], axes[:, 1]
    k[:, 1, 0], k[:, 1, 2] = axes[:, 2], -axes[:, 0]
    k[:, 2, 0], k[:, 2, 1] = -axes[:, 1], axes[:, 0]
    s, c = np.sin(angles)[:, None, None], np.cos(angles)[:, None, None]
    return np.eye(3) + s * k + (1.0 - c) * (k @ k)


def _euler_zyx(a: np.ndarray) -> np.ndarray:
    """``Rz(a2) Ry(a1) Rx(a0)`` for each row of ``a [n, 3]``."""
    cx, cy, cz = np.cos(a.T)
    sx, sy, sz = np.sin(a.T)
    rows = ([cy * cz, cz * sx * sy - cx * sz, cx * cz * sy + sx * sz],
            [cy * sz, cx * cz + sx * sy * sz, cx * sy * sz - cz * sx],
            [-sy, cy * sx, cx * cy])
    return np.stack([np.stack(r, -1) for r in rows], axis=1)


def _per_axis(rng, n: int, half: float) -> np.ndarray:
    """A Latin hypercube over [-half, half]^3: each axis's values the
    strata's midpoints in their own order."""
    return np.stack([(2.0 * _strata(rng, n) - 1.0) * half
                     for _ in range(3)], axis=1)


def draw_poses(traffic: dict):
    """``(rotations [P, 3, 3], translations [P, 3])`` in float64."""
    n = traffic["pool"]
    rng = _rng(traffic["request_seed"], 0)
    rot, tr = traffic["rotation"], traffic["translation"]
    if rot["kind"] == "axis_angle":
        angles = np.deg2rad(rot["max_deg"]) * _strata(rng, n)
        rotations = _axis_angle(_unit_vectors(rng, n), angles)
    elif rot["kind"] == "per_axis":
        rotations = _euler_zyx(_per_axis(rng, n, rot["max_rad"]))
    else:
        raise ValueError(f"unknown rotation kind {rot['kind']!r}")
    if tr["kind"] == "ball":
        radii = tr["radius"] * np.cbrt(_strata(rng, n))
        translations = _unit_vectors(rng, n) * radii[:, None]
    elif tr["kind"] == "per_axis":
        translations = _per_axis(rng, n, tr["max"])
    else:
        raise ValueError(f"unknown translation kind {tr['kind']!r}")
    return rotations, translations


def calls(traffic: dict, seed: int, per_call: int):
    """The pool ids of the window's calls, without end: the pool split in
    order into calls of ``per_call`` requests, every pass over them in a new
    order drawn from the run's ``seed``. A batch is always the same
    requests, so every pass asks for the same work."""
    rng = _rng(seed, 1)
    n = traffic["pool"]
    if n % per_call:
        raise ValueError(f"pool {n} is not a whole number of calls of "
                         f"{per_call}")
    groups = np.arange(n).reshape(-1, per_call)
    while True:
        yield from groups[rng.permutation(groups.shape[0])]


def make_pool(cloud: np.ndarray, traffic: dict, device) -> Pool:
    rotations, translations = draw_poses(traffic)
    n = traffic["pool"]
    base = torch.as_tensor(cloud, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([traffic["request_seed"], 2])
                        .generate_state(1, np.uint64)[0]))
    r = torch.as_tensor(rotations, device=device)
    t = torch.as_tensor(translations, device=device)
    sources = (torch.matmul(base.double(), r.transpose(1, 2))
               + t[:, None, :]).float()
    if traffic["source_noise"]:
        sources += traffic["source_noise"] * torch.randn(
            sources.shape, generator=gen, device=device)
    targets = shared = None
    if traffic["shared_target"]:
        shared = base.contiguous()
    else:
        targets = base.expand(n, -1, -1).clone()
        if traffic["target_noise"]:
            targets += traffic["target_noise"] * torch.randn(
                targets.shape, generator=gen, device=device)
    return Pool(sources.contiguous(), targets, shared, rotations,
                translations)
