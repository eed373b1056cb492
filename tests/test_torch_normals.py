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


def _held_to_jax_or_float64(q, jidx, ridx, jnrm, tnrm):
    """The port re-ranks the norm form's picks by the difference form
    (``tn.rerank``), which JAX does not, and solves by ``eigh`` where JAX
    takes the closed form. The port's neighbours ``ridx`` lie no farther
    than JAX's ``jidx`` in float64; every normal is float64 ``eigh``'s of
    the port's float32 covariance within ``8·2⁻²³·λ2 / (λ1 − λ0)`` rad (or
    1e-6), eig3's bound; and it is JAX's wherever the two pick the same
    neighbours, that bound is below 1e-3 rad and JAX's closed form
    resolves the float64 normal."""
    q64 = q.astype(np.float64)

    def farthest(idx):
        return ((q64[:, None] - q64[idx]) ** 2).sum(-1).max(1)

    assert (farthest(ridx) <= farthest(jidx) * (1 + 1e-6)).all()
    cov = tn._neighbour_covariance(torch.as_tensor(q),
                                   torch.as_tensor(ridx[:, 1:]))
    w, v = np.linalg.eigh(cov.double().numpy())
    n64 = v[..., 0]
    sin = np.linalg.norm(np.cross(n64, tnrm.astype(np.float64)), axis=1)
    gap = np.maximum(w[:, 1] - w[:, 0], 1e-300)
    bound = 8 * 2.0 ** -23 * w[:, 2] / gap
    assert (sin <= np.maximum(bound, 1e-6)).all()
    held = ((np.sort(jidx, 1) == np.sort(ridx, 1)).all(1) & (bound < 1e-3)
            & (np.abs((n64 * jnrm).sum(1)) > 1 - 1e-4))
    assert held.sum() > len(q) // 2
    assert (np.abs((jnrm * tnrm).sum(1))[held] > 1 - 1e-4).all()


@pytest.mark.parametrize("exact", [False, True])
def test_estimate_normals_match_jax(exact):
    """On the synthetic grid the two kNN picks agree but at near-ties of the
    grid, where a different k-th neighbour turns the normal; there the
    port's re-ranked normals are held to float64's. On a random (tie-free)
    cloud every normal agrees up to sign."""
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
    if exact:
        assert (np.abs((jnrm * tnrm).sum(1)) > 1 - 1e-4).mean() > 0.95
    else:
        # the port re-ranks the norm form's picks by the difference form
        # (``tn.rerank``), which JAX does not: every row's neighbours are
        # float64's, and its normal is JAX's where the two pick the same
        # neighbours, else float64's PCA normal of float64's neighbours
        tq = torch.as_tensor(q)
        ridx = tn.rerank(tq, *tn.knn(tq, tq, 5 + tn.RERANK), 5).numpy()
        d64 = ((q64[:, None] - q64[None]) ** 2).sum(-1)
        kth = np.sort(d64, 1)[:, 4]
        dr = np.take_along_axis(d64, ridx.astype(np.int64), 1)[:, -1]
        np.testing.assert_allclose(dr, kth, rtol=1e-6, atol=1e-12)
        _held_to_jax_or_float64(q, jidx, ridx, jnrm, tnrm)

    c = np.random.default_rng(9).uniform(-1, 1, (1500, 3)).astype(np.float32)
    jnrm = np.asarray(jn.estimate_normals(jnp.asarray(c), exact=exact))
    tnrm = tn.estimate_normals(torch.as_tensor(c), exact=exact).numpy()
    np.testing.assert_allclose(np.abs((jnrm * tnrm).sum(1)), 1.0, atol=1e-4)


def test_banded_normals_match_jax():
    """Above ``banded_threshold`` the neighbours come from ``knn_morton``;
    both packages sort the same table and scan the same bands; the port
    re-ranks its picks as on the streaming path."""
    q = _grid_target(48)
    jnrm = np.asarray(jn.estimate_normals(jnp.asarray(q),
                                          banded_threshold=1000))
    tnrm = tn.estimate_normals(torch.as_tensor(q),
                               banded_threshold=1000).numpy()
    tq = torch.as_tensor(q)
    jidx = np.asarray(jn.self_knn(jnp.asarray(q), 5,
                                  banded_threshold=1000)[0])
    ridx = tn.rerank(tq, *tn.self_knn(tq, 5 + tn.RERANK,
                                      banded_threshold=1000), 5).numpy()
    _held_to_jax_or_float64(q, jidx, ridx, jnrm, tnrm)
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
