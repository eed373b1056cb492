"""The port's kNN and PCA normals against ``fpcr_tpu.ops.normals`` on the
same numpy inputs (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fpcr_tpu as f
from fpcr_tpu.ops import normals as jn
from fpcr_tpu_torch.ops import normals as tn

torch.set_num_threads(2)

# the two packages' float32 distances differ by an ulp here and there (XLA
# fuses the expansion form under jit), which on the regular synthetic grid
# decides some near-ties at the k-th slot differently; a pick may differ
# only where the two candidates' exact distances agree to this relative gap
NEAR_TIE = 1e-5


def _integer_grid(seed=0):
    """A shuffled integer lattice: every distance is exact in float32 in both
    packages, and every point has many equidistant neighbours."""
    g = np.stack(np.meshgrid(np.arange(12), np.arange(10), np.arange(3),
                             indexing="ij"), -1).reshape(-1, 3)
    rng = np.random.default_rng(seed)
    return g[rng.permutation(len(g))].astype(np.float32)


@pytest.mark.parametrize("exact", [False, True])
def test_knn_ties_go_to_the_lower_index_as_in_jax(exact):
    g = _integer_grid()
    ji, jd = jn.knn(jnp.asarray(g), jnp.asarray(g), 7, chunk=100, tile=128,
                    exact=exact)
    ti, td = tn.knn(torch.as_tensor(g), torch.as_tensor(g), 7, chunk=100,
                    tile=128, exact=exact)
    assert ti.dtype == torch.int32 and td.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    # the tie rule itself: equal distances appear in ascending index order
    same = td.numpy()[:, 1:] == td.numpy()[:, :-1]
    assert same.any() and (np.diff(ti.numpy(), axis=1)[same] > 0).all()


def test_knn_masked_targets_match_jax():
    rng = np.random.default_rng(3)
    p = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    q = rng.uniform(-1, 1, (700, 3)).astype(np.float32)
    mask = rng.uniform(size=700) < 0.3
    ji, jd = jn.knn(jnp.asarray(p), jnp.asarray(q), 4, jnp.asarray(mask),
                    tile=256)
    ti, td = tn.knn(torch.as_tensor(p), torch.as_tensor(q), 4,
                    torch.as_tensor(mask), tile=256)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # expansion form: float32 rounding of |p|² - 2p·q + |q|² is ~1e-7 of
    # |p|² + |q|² (up to ~6 here), and the two packages round differently
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)
    assert mask[ti.numpy()].all()


def _grid_target(width=40):
    return np.array(f.synthetic_scene(width=width).target)


@pytest.mark.parametrize("exact", [False, True])
def test_estimate_normals_match_jax(exact):
    """On the synthetic grid the two kNN picks agree but at near-ties of the
    grid, where a different k-th neighbour turns the normal; on a random
    (tie-free) cloud every normal agrees up to sign."""
    q = _grid_target()
    jidx, _ = jn.knn(jnp.asarray(q), jnp.asarray(q), 5, exact=exact)
    tidx, _ = tn.knn(torch.as_tensor(q), torch.as_tensor(q), 5, exact=exact)
    jidx, tidx = np.asarray(jidx), tidx.numpy()
    assert (np.sort(jidx, 1) == np.sort(tidx, 1)).all(1).mean() > 0.95
    q64 = q.astype(np.float64)
    dj = ((q64[:, None] - q64[jidx]) ** 2).sum(-1)[:, -1]
    dt = ((q64[:, None] - q64[tidx]) ** 2).sum(-1)[:, -1]
    np.testing.assert_allclose(dt, dj, rtol=NEAR_TIE, atol=1e-9)

    jnrm = np.asarray(jn.estimate_normals(jnp.asarray(q), exact=exact))
    tnrm = tn.estimate_normals(torch.as_tensor(q), exact=exact).numpy()
    np.testing.assert_allclose(np.linalg.norm(tnrm, axis=1), 1.0, atol=1e-5)
    assert (np.abs((jnrm * tnrm).sum(1)) > 1 - 1e-4).mean() > 0.95

    c = np.random.default_rng(9).uniform(-1, 1, (1500, 3)).astype(np.float32)
    jnrm = np.asarray(jn.estimate_normals(jnp.asarray(c), exact=exact))
    tnrm = tn.estimate_normals(torch.as_tensor(c), exact=exact).numpy()
    np.testing.assert_allclose(np.abs((jnrm * tnrm).sum(1)), 1.0, atol=1e-4)


def test_banded_normals_match_jax():
    """Above ``banded_threshold`` the neighbours come from ``knn_morton``;
    both packages sort the same table and scan the same bands."""
    q = _grid_target(48)
    jnrm = np.asarray(jn.estimate_normals(jnp.asarray(q),
                                          banded_threshold=1000))
    tnrm = tn.estimate_normals(torch.as_tensor(q),
                               banded_threshold=1000).numpy()
    dots = np.abs((jnrm * tnrm).sum(1))
    assert (dots > 1 - 1e-4).mean() > 0.95
    # a random (tie-free) cloud: every normal agrees
    rng = np.random.default_rng(8)
    c = rng.uniform(-1, 1, (3000, 3)).astype(np.float32)
    jnrm = np.asarray(jn.estimate_normals(jnp.asarray(c),
                                          banded_threshold=1000))
    tnrm = tn.estimate_normals(torch.as_tensor(c),
                               banded_threshold=1000).numpy()
    np.testing.assert_allclose(np.abs((jnrm * tnrm).sum(1)), 1.0, atol=1e-3)


def test_orient_and_curvature_match_jax():
    rng = np.random.default_rng(4)
    c = rng.uniform(-1, 1, (800, 3)).astype(np.float32)
    jnrm, jcurv = jn.normals_with_curvature(jnp.asarray(c), k=6)
    tnrm, tcurv = tn.normals_with_curvature(torch.as_tensor(c), k=6)
    np.testing.assert_allclose(np.abs((np.asarray(jnrm) * tnrm.numpy())
                                      .sum(1)), 1.0, atol=1e-3)
    np.testing.assert_allclose(tcurv.numpy(), np.asarray(jcurv), atol=1e-5)
    for vp in (None, (0.0, 0.0, 5.0)):
        jo = np.asarray(jn.orient_normals(jnp.asarray(c), jnrm,
                                          None if vp is None
                                          else jnp.asarray(vp)))
        to = tn.orient_normals(torch.as_tensor(c),
                               torch.tensor(np.asarray(jnrm)), vp).numpy()
        np.testing.assert_array_equal(to, jo)
