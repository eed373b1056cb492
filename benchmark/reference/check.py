"""The numbers that decide ``correct``, each the worst over the sample.

For every sampled registration of the window the reference registers the
same source onto the same target in float64 (:mod:`icp64`), and the
program's answer (its row: transform, iterations, each iteration's error)
is held against it:

* ``pose_gap_m``: the RMS distance, over the request's source points,
  between where the program's transform and the reference's put them;
* ``iter_gap``: the difference in iterations run;
* ``error_gap_m``: the largest difference of an iteration's point RMSE,
  over the iterations both ran: the matches of each iteration (the
  matcher's picks, K1's or K3's; the normals, for point-to-plane) and the
  solve's increment move it. Absolute, in metres: a noise-free cloud's
  RMSE falls to float32's floor, where a ratio would only read rounding;
* ``first_error_gap_m``: the same for the first iteration alone, which
  both start from the request's own clouds.

A row that is not finite reads ``inf`` in every number. A cell's limits
file says which numbers are compared and their limits.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable

import numpy as np
import torch

from . import icp64
from ..rows import ERRORS, ITERS, ROT, TRANS

NAMES = ("pose_gap_m", "iter_gap", "error_gap_m", "first_error_gap_m")


def gaps(row: torch.Tensor, ref: icp64.Registration,
         source: torch.Tensor) -> Dict[str, float]:
    row = row.double()
    if not bool(torch.isfinite(row[:ITERS + 1]).all()):
        return {name: math.inf for name in NAMES}
    dev = ref.rotation.device
    R = row[ROT].reshape(3, 3).to(dev)
    t = row[TRANS].to(dev)
    x = source.double()
    diff = x @ (R - ref.rotation).T + (t - ref.translation)
    n_p = int(row[ITERS])
    e_p = row[ERRORS][:n_p].tolist()
    common = min(n_p, ref.iterations)
    gap = [abs(a - b) for a, b in zip(e_p[:common], ref.errors[:common])]
    return {"pose_gap_m": float(torch.sqrt((diff * diff).sum(1).mean())),
            "iter_gap": float(abs(n_p - ref.iterations)),
            "error_gap_m": max(gap) if gap else math.inf,
            "first_error_gap_m": gap[0] if gap else math.inf}


def sample(ids: Iterable[int], count: int, seed: int) -> list:
    """``count`` of the completed ``ids``, drawn from the seed."""
    ids = sorted(ids)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 3]))
    return sorted(rng.choice(ids, size=min(count, len(ids)),
                             replace=False).tolist())


def each(cell, pool, rows: dict, ids: list,
         prec: icp64.Precision = icp64.FLOAT64) -> Dict[int, dict]:
    """The numbers of each registration ``ids``, whose program rows are
    ``rows[id]``, against the reference run in ``prec``."""
    out = {}
    for i in ids:
        ref = icp64.register(pool.sources[i], pool.target(i),
                             cell.config["icp"], cell.traffic["metric"], prec)
        out[i] = gaps(rows[i], ref, pool.sources[i])
    return out


def worst(per: Dict[int, dict]) -> Dict[str, float]:
    """The worst of each number over the registrations of ``per``."""
    return {name: max([0.0] + [g[name] for g in per.values()])
            for name in NAMES}


def compare(cell, pool, rows: dict, ids: list) -> Dict[str, float]:
    """The worst of each number over the registrations ``ids``."""
    return worst(each(cell, pool, rows, ids))
