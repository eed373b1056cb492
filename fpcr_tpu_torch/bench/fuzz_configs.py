"""Randomized robustness fuzz: random clouds (uniform / surface / line /
duplicates / far from the origin) × random ``ICPConfig`` combos, then
random ``NDTConfig``s; a non-finite transform, a reflection or an exception
is a failure, and any failure makes the exit code 1.

Counterpart of ``scripts/fuzz_configs.py``: :func:`trials` draws the
script's clouds, GT motions and configs in its order from the same
``numpy.random.default_rng(seed)``, so a seed gives the JAX script's
trials (``surface_grid`` from the port, bit for bit JAX's). The fault
classes the JAX fuzz caught: NaN from the solvers on line clouds, and an
auto NDT voxel size of 0 on duplicate-heavy clouds.

Run:  python -m fpcr_tpu_torch.bench.fuzz_configs [seed] [--cpu]
      [--trials-icp 60] [--trials-ndt 20]
"""

from __future__ import annotations

import argparse
import sys
from typing import Iterator, List, NamedTuple

import numpy as np
import torch

import fpcr_tpu_torch as ft
from fpcr_tpu_torch.models.ndt import NDTConfig, run_ndt
from fpcr_tpu_torch.utils.device import resolve_device, to_numpy
from fpcr_tpu_torch.utils.diagnostics import (RegistrationError,
                                              validate_result)


class Trial(NamedTuple):
    kind: str  # 'icp' | 'ndt'
    index: int
    n: int
    shape: str
    source: np.ndarray  # [n, 3] float32
    translation: tuple
    rotation: tuple  # radians
    config: dict  # ICPConfig / NDTConfig fields


def _none_or(value, cast):
    return None if value is None else cast(value)


def _surface(n: int, min_width: int) -> np.ndarray:
    w = max(min_width, int(np.sqrt(n)))
    return to_numpy(ft.surface_grid(width=w, device="cpu"))[:n]


def trials(seed: int = 0, icp_trials: int = 60,
           ndt_trials: int = 20) -> Iterator[Trial]:
    """The script's trials at ``seed``, drawn in its order."""
    rng = np.random.default_rng(seed)
    for trial in range(icp_trials):
        n = int(rng.integers(4, 3000))
        metric = rng.choice(["point", "plane", "symmetric", "gicp"])
        matcher = rng.choice(["xla", "morton", "grid", "pallas"])
        solver = rng.choice(["svd", "polar"])
        robust = rng.choice([None, "huber", "tukey"])
        trim = rng.choice([None, float(rng.uniform(0.05, 2.0))])
        shape = str(rng.choice(["uniform", "surface", "line", "dup"]))
        if shape == "uniform":
            src = rng.uniform(-2, 2, (n, 3))
        elif shape == "surface":
            src = _surface(n, 2)
            n = src.shape[0]
        elif shape == "line":
            ts = rng.uniform(-1, 1, n)
            src = np.stack([ts, 2 * ts, -ts], 1)
            src += rng.normal(scale=1e-4, size=src.shape)
        else:
            base = rng.uniform(-1, 1, (max(n // 4, 1), 3))
            src = base[rng.integers(0, base.shape[0], n)]
        translation = tuple(0.02 * rng.standard_normal(3))
        rotation = tuple(0.03 * rng.standard_normal(3))
        cfg = dict(metric=str(metric), matcher=str(matcher),
                   solver=str(solver), robust_loss=_none_or(robust, str),
                   max_correspondence_dist=_none_or(trim, float),
                   max_iterations=int(rng.integers(1, 15)),
                   k_neighbors=int(rng.integers(3, 8)))
        yield Trial("icp", trial, n, shape, src.astype(np.float32),
                    translation, rotation, cfg)
    # NDT trials: random resolutions / lookup strategies on random
    # geometry — the never-NaN contract extends to the voxel-field solver
    for trial in range(ndt_trials):
        n = int(rng.integers(64, 4000))
        shape = str(rng.choice(["uniform", "surface", "dup", "offset"]))
        if shape == "uniform":
            src = rng.uniform(-2, 2, (n, 3))
        elif shape == "surface":
            src = _surface(n, 4)
            n = src.shape[0]
        elif shape == "dup":
            base = rng.uniform(-1, 1, (max(n // 4, 1), 3))
            src = base[rng.integers(0, base.shape[0], n)]
        else:  # global-frame coordinates
            src = rng.uniform(-1, 1, (n, 3)) + np.array([300.0, -450.0,
                                                         250.0])
        translation = tuple(0.02 * rng.standard_normal(3))
        rotation = tuple(0.02 * rng.standard_normal(3))
        cfg = dict(
            voxel_size=_none_or(rng.choice([None, float(rng.uniform(0.1,
                                                                   1.0))]),
                                float),
            max_iterations=int(rng.integers(1, 20)),
            lookup=str(rng.choice(["auto", "gather", "banded"])),
            min_points=int(rng.integers(3, 7)))
        yield Trial("ndt", trial, n, shape, src.astype(np.float32),
                    translation, rotation, cfg)


def run_trial(trial: Trial, device):
    """Register one trial on ``device``; raise ``RegistrationError`` on a
    non-finite transform or a reflection."""
    src = torch.as_tensor(trial.source, device=device)
    gt = ft.gt_transform(trial.translation, trial.rotation, device=device)
    tgt = gt.apply(src)
    if trial.kind == "icp":
        res = ft.run_icp(src, tgt, ft.ICPConfig(**trial.config))
        validate_result(res)  # raises on non-finite / reflection
        return res
    res = run_ndt(src, tgt, NDTConfig(**trial.config))
    r = to_numpy(res.transform.rotation)
    t = to_numpy(res.transform.translation)
    if not (np.isfinite(r).all() and np.isfinite(t).all()):
        raise RegistrationError("non-finite NDT transform")
    if abs(np.linalg.det(r) - 1.0) > 1e-2:
        raise RegistrationError(f"det(R)={np.linalg.det(r)}")
    return res


def fuzz(seed: int, device, icp_trials: int = 60,
         ndt_trials: int = 20) -> List[str]:
    """Run every trial of ``seed``; return the failures' lines."""
    failures = []
    for trial in trials(seed, icp_trials, ndt_trials):
        tag = "" if trial.kind == "icp" else "NDT "
        what = (f"trial {trial.index}: n={trial.n} shape={trial.shape} "
                f"cfg={trial.config}")
        try:
            run_trial(trial, device)
        except RegistrationError as e:
            failures.append(f"{tag}FAIL {what}: {e}")
        except Exception as e:  # a crash is a finding: record it, go on
            failures.append(f"{tag}CRASH {what}: {type(e).__name__} "
                            f"{str(e)[:120]}")
        else:
            continue
        print(failures[-1], flush=True)
    print(f"done: {len(failures)} failures / {icp_trials + ndt_trials} "
          f"trials", flush=True)
    return failures


def main(argv=None) -> List[str]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("seed", type=int, nargs="?", default=0)
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the CUDA card")
    parser.add_argument("--trials-icp", type=int, default=60)
    parser.add_argument("--trials-ndt", type=int, default=20)
    args = parser.parse_args(argv)
    device = torch.device(resolve_device("cpu" if args.cpu else None))
    print(f"fuzz seed {args.seed} on {device}", flush=True)
    return fuzz(args.seed, device, args.trials_icp, args.trials_ndt)


if __name__ == "__main__":
    sys.exit(1 if main(sys.argv[1:]) else 0)  # guard scripts must gate
