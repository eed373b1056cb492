"""The port's fuzz (``fpcr_tpu_torch/bench/fuzz_configs.py``): its trials
are the JAX script's (``scripts/fuzz_configs.py``) draw for draw, and the
port registers every trial of seeds 0–3 on the CPU without a non-finite
transform, a reflection or an exception."""

import numpy as np
import pytest
import torch

import fpcr_tpu as f
from fpcr_tpu_torch.bench.fuzz_configs import fuzz, trials

torch.set_num_threads(2)


def _script_draws(seed):
    """The draws of ``scripts/fuzz_configs.py``'s two loops, replayed with
    ``fpcr_tpu.surface_grid``: ``(kind, n, shape, source, translation,
    rotation, config)`` a trial."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(60):
        n = int(rng.integers(4, 3000))
        metric = rng.choice(["point", "plane", "symmetric", "gicp"])
        matcher = rng.choice(["xla", "morton", "grid", "pallas"])
        solver = rng.choice(["svd", "polar"])
        robust = rng.choice([None, "huber", "tukey"])
        trim = rng.choice([None, float(rng.uniform(0.05, 2.0))])
        shape = rng.choice(["uniform", "surface", "line", "dup"])
        if shape == "uniform":
            src = rng.uniform(-2, 2, (n, 3))
        elif shape == "surface":
            w = max(2, int(np.sqrt(n)))
            src = np.asarray(f.surface_grid(width=w))[:n]
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
        cfg = dict(metric=metric, matcher=matcher, solver=solver,
                   robust_loss=robust, max_correspondence_dist=trim,
                   max_iterations=int(rng.integers(1, 15)),
                   k_neighbors=int(rng.integers(3, 8)))
        out.append(("icp", n, shape, src.astype(np.float32), translation,
                    rotation, cfg))
    for _ in range(20):
        n = int(rng.integers(64, 4000))
        shape = rng.choice(["uniform", "surface", "dup", "offset"])
        if shape == "uniform":
            src = rng.uniform(-2, 2, (n, 3))
        elif shape == "surface":
            w = max(4, int(np.sqrt(n)))
            src = np.asarray(f.surface_grid(width=w))[:n]
            n = src.shape[0]
        elif shape == "dup":
            base = rng.uniform(-1, 1, (max(n // 4, 1), 3))
            src = base[rng.integers(0, base.shape[0], n)]
        else:
            src = rng.uniform(-1, 1, (n, 3)) + np.array([300.0, -450.0,
                                                         250.0])
        translation = tuple(0.02 * rng.standard_normal(3))
        rotation = tuple(0.02 * rng.standard_normal(3))
        cfg = dict(voxel_size=rng.choice([None, float(rng.uniform(0.1,
                                                                  1.0))]),
                   max_iterations=int(rng.integers(1, 20)),
                   lookup=rng.choice(["auto", "gather", "banded"]),
                   min_points=int(rng.integers(3, 7)))
        out.append(("ndt", n, shape, src.astype(np.float32), translation,
                    rotation, cfg))
    return out


def test_trials_are_the_scripts_draws():
    ours = list(trials(0))
    ref = _script_draws(0)
    assert len(ours) == len(ref) == 80
    shapes = set()
    for t, (kind, n, shape, src, tr, rot, cfg) in zip(ours, ref):
        assert (t.kind, t.n, t.shape) == (kind, n, shape)
        assert t.source.dtype == np.float32 and t.source.shape == (n, 3)
        np.testing.assert_array_equal(t.source, src)  # bit for bit
        assert t.translation == tr and t.rotation == rot
        assert t.config == cfg
        shapes.add((kind, shape))
    # seed 0 reaches every geometry of both loops
    assert len(shapes) == 8, shapes


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fuzz_no_failures(seed):
    assert fuzz(seed, torch.device("cpu")) == []
