"""The port's Morton band matcher against ``fpcr_tpu.ops.morton`` and the
TPU kernel K3 (``morton_nn_pallas`` in interpret mode) on the same numpy
inputs (CPU; K3's plain version runs here)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpcr_tpu.ops import morton as jm
from fpcr_tpu.ops.morton_pallas import morton_nn_pallas
from fpcr_tpu_torch.interop import morton_table_from_numpy
from fpcr_tpu_torch.ops import morton as tm
from fpcr_tpu_torch.ops.morton_cuda import morton_nn_cuda

from helpers import crossing_walls

torch.set_num_threads(2)

# the expansion form |q|² - 2p·q + |p|² rounds to ~1e-7 of |p|² + |q|² in
# float32, differently in each package (and K3 computes the difference form
# instead), so squared distances agree to this factor of the largest |p|²
DIST_ATOL_REL = 1e-6
NEAR_TIE = 1e-5  # an index may differ only between picks this close


def _clouds(seed=21, m=3000, n=2500, far=0.0):
    rng = np.random.default_rng(seed)
    q = (rng.uniform(-2, 2, (m, 3)) + far).astype(np.float32)
    p = (q[rng.permutation(m)[:n]]
         + rng.normal(scale=0.002, size=(n, 3))).astype(np.float32)
    return p, q


def _tables(q, mask=None, shift=0.0):
    jt = jm.build_morton_table(jnp.asarray(q),
                               None if mask is None else jnp.asarray(mask),
                               shift=shift)
    tt = tm.build_morton_table(torch.as_tensor(q),
                               None if mask is None else torch.as_tensor(mask),
                               shift=shift)
    return jt, tt


def _sorted_source(p, jt):
    return p[np.asarray(jm.source_morton_order(jnp.asarray(p), jt))]


def test_morton_codes_equal_jax():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-3, 3, (2000, 3)).astype(np.float32)  # some outside
    lo = np.array([-2.0, -1.5, -2.5], np.float32)
    inv = np.array([0.25, 0.3, 0.2], np.float32)
    j = np.asarray(jm.morton_codes(jnp.asarray(pts), jnp.asarray(lo),
                                   jnp.asarray(inv)))
    t = tm.morton_codes(torch.as_tensor(pts), torch.as_tensor(lo),
                        torch.as_tensor(inv))
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), j)


@pytest.mark.parametrize("case", ["plain", "masked", "shift", "duplicates"])
def test_tables_and_source_order_equal_jax(case):
    p, q = _clouds()
    mask = None
    if case == "masked":
        mask = np.ones(q.shape[0], bool)
        mask[::3] = False
    if case == "duplicates":  # equal codes: the stable sorts must agree
        q = np.round(q * 4) / 4
    jt, tt = _tables(q, mask, shift=0.5 if case == "shift" else 0.0)
    for field in jt._fields:
        np.testing.assert_array_equal(getattr(tt, field).numpy(),
                                      np.asarray(getattr(jt, field)),
                                      err_msg=field)
    np.testing.assert_array_equal(
        tm.source_morton_order(torch.as_tensor(p), tt).numpy(),
        np.asarray(jm.source_morton_order(jnp.asarray(p), jt)))


def _dist_atol(x):
    return DIST_ATOL_REL * max(1.0, float((x.astype(np.float64) ** 2)
                                          .sum(1).max()))


def _assert_near_ties(p, q_sorted, ia, ib):
    diff = np.nonzero(ia != ib)[0]
    if diff.size:
        p64 = p.astype(np.float64)[diff]
        q64 = q_sorted.astype(np.float64)
        da = ((p64 - q64[ia[diff]]) ** 2).sum(1)
        db = ((p64 - q64[ib[diff]]) ** 2).sum(1)
        np.testing.assert_allclose(da, db, rtol=NEAR_TIE, atol=1e-9)
    return diff.size


@pytest.mark.parametrize("case", ["extra", "no-extra", "masked",
                                  "tail", "far"])
def test_morton_nn_matches_jax(case):
    """The XLA geometry, expansion form in both packages."""
    p, q = _clouds(far=10.0 if case == "far" else 0.0,
                   n=2500 if case != "tail" else 800)
    mask = None
    if case == "masked":
        mask = np.ones(q.shape[0], bool)
        mask[2000:] = False
    jt, tt = _tables(q, mask)
    ps = _sorted_source(p, jt)
    extra = None if case == "no-extra" else (
        np.asarray(jt.points_sorted) * 0.5).astype(np.float32)
    j = jm.morton_nn(jnp.asarray(ps), jt,
                     None if extra is None else jnp.asarray(extra),
                     chunk=256, window=256)
    t = tm.morton_nn(torch.as_tensor(ps), tt,
                     None if extra is None else torch.as_tensor(extra),
                     chunk=256, window=256)
    q_sorted = np.asarray(jt.points_sorted)
    assert _assert_near_ties(ps, q_sorted, t[2].numpy(), np.asarray(j[2])) \
        <= 0.001 * ps.shape[0]
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]),
                               atol=_dist_atol(ps))
    np.testing.assert_array_equal(t[0].numpy(), q_sorted[t[2].numpy()])
    if extra is None:
        assert t[3] is None and j[3] is None
    else:
        np.testing.assert_array_equal(t[3].numpy(), extra[t[2].numpy()])
    if mask is not None:
        assert (t[2].numpy() < int(jt.valid_count)).all()


BAND_CASES = {  # name: (n, m, masked rows from, extra, chunk, window, shift)
    "extra": (2500, 3000, None, True, 256, 256, 0.0),
    "no-extra": (2500, 3000, None, False, 256, 256, 0.0),
    "masked-tail": (2500, 3000, 2200, True, 256, 256, 0.0),
    "n<chunk": (100, 3000, None, True, 256, 256, 0.0),
    "n%chunk": (1000, 3000, None, False, 512, 64, 0.0),
    "m<band": (300, 500, None, True, 256, 256, 0.0),
    "shift": (2500, 3000, 2900, True, 512, 64, 0.5),
}


@pytest.mark.parametrize("name", list(BAND_CASES))
def test_band_plain_matches_tpu_kernel(name):
    """``morton_nn_band_plain`` against the TPU kernel K3
    (``morton_nn_pallas(mode='highest')`` in interpret mode) on the JAX
    package's own table, handed over by ``interop``: the same band
    geometry, the same picks up to near-ties (the TPU kernel computes the
    expansion form), matched points and extras equal to the table rows."""
    n, m, masked_from, with_extra, chunk, window, shift = BAND_CASES[name]
    p, q = _clouds(seed=hash(name) % 1000, m=m, n=n)
    mask = None
    if masked_from is not None:
        mask = np.arange(m) < masked_from
    jt = jm.build_morton_table(jnp.asarray(q),
                               None if mask is None else jnp.asarray(mask),
                               shift=shift)
    ps = _sorted_source(p, jt)
    extra = (np.asarray(jt.points_sorted) * 0.5 + 0.25).astype(np.float32) \
        if with_extra else None
    j = morton_nn_pallas(jnp.asarray(ps), jt,
                         None if extra is None else jnp.asarray(extra),
                         chunk=chunk, window=window, mode="highest",
                         interpret=True)
    tt = morton_table_from_numpy(jt, device="cpu")
    before = morton_nn_cuda.launches
    t = tm.morton_nn_band(torch.as_tensor(ps), tt,
                          None if extra is None else torch.as_tensor(extra),
                          chunk=chunk, window=window)
    assert morton_nn_cuda.launches == before  # the CPU takes the plain version
    q_sorted = np.asarray(jt.points_sorted)
    ti = t[2].numpy()
    assert ti.dtype == np.int32 and ti.min() >= 0 and ti.max() <= m - 1
    assert _assert_near_ties(ps, q_sorted, ti, np.asarray(j[2])) \
        <= 0.001 * n
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]),
                               atol=_dist_atol(ps))
    np.testing.assert_array_equal(t[0].numpy(), q_sorted[ti])
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
    if extra is None:
        assert t[3] is None
    else:
        np.testing.assert_array_equal(t[3].numpy(), extra[ti])
        np.testing.assert_array_equal(t[3].numpy(), np.asarray(j[3]))
    if mask is not None:  # no masked row wins
        assert (ti < int(jt.valid_count)).all()


def test_band_plain_convention_where_no_target_is_valid():
    """Where it differs from the TPU kernel: a band with no valid row
    (valid_count 0) gives idx 0, ``inf`` and table row 0 here, the K1
    convention; the TPU kernel gives its ~1e30 surrogate distance."""
    p, q = _clouds(n=300, m=600)
    mask = np.zeros(600, bool)
    jt = jm.build_morton_table(jnp.asarray(q), jnp.asarray(mask))
    extra = np.asarray(jt.points_sorted) + 1.0
    j = morton_nn_pallas(jnp.asarray(p), jt, jnp.asarray(extra), chunk=128,
                         window=64, mode="highest", interpret=True)
    t = tm.morton_nn_band_plain(torch.as_tensor(p),
                                morton_table_from_numpy(jt, device="cpu"),
                                torch.as_tensor(extra), chunk=128, window=64)
    assert (np.asarray(j[1]) > 1e29).all() and np.isfinite(j[1]).all()
    assert torch.isinf(t[1]).all() and (t[2] == 0).all()
    np.testing.assert_array_equal(
        t[0].numpy(), np.broadcast_to(np.asarray(jt.points_sorted)[0],
                                      (300, 3)))
    np.testing.assert_array_equal(t[3].numpy(),
                                  np.broadcast_to(extra[0], (300, 3)))


def test_band_plain_on_the_port_table_equals_interop_table():
    p, q = _clouds()
    jt, tt = _tables(q)
    ps = torch.as_tensor(_sorted_source(p, jt))
    a = tm.morton_nn_band_plain(ps, tt, chunk=512, window=64)
    b = tm.morton_nn_band_plain(ps, morton_table_from_numpy(jt, device="cpu"),
                                chunk=512, window=64)
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="CUDA"):
        morton_nn_cuda(ps, tt)


def test_knn_morton_matches_jax():
    rng = np.random.default_rng(25)
    q = rng.uniform(-2, 2, (3000, 3)).astype(np.float32)
    mask = np.ones(3000, bool)
    mask[2500:] = False
    for msk in (None, mask):
        ji, jd = jm.knn_morton(jnp.asarray(q), 5,
                               None if msk is None else jnp.asarray(msk),
                               window=128)
        ti, td = tm.knn_morton(torch.as_tensor(q), 5,
                               None if msk is None else torch.as_tensor(msk),
                               window=128)
        assert ti.dtype == torch.int32 and ti.shape == (3000, 5)
        valid = np.arange(3000) if msk is None else np.nonzero(msk)[0]
        np.testing.assert_array_equal(ti.numpy()[valid, 0], valid)  # self
        same = (ti.numpy() == np.asarray(ji)).all(1)
        assert same.mean() > 0.999
        np.testing.assert_allclose(td.numpy(), np.asarray(jd),
                                   atol=_dist_atol(q))


def test_probes_match_jax():
    cloud = crossing_walls(seed=3, n_half=2048)
    jt, tt = _tables(cloud)
    src = _sorted_source(cloud + 0.002, jt)
    for w in (16, 256):
        j = float(jm.seam_miss_rate(jnp.asarray(src), jt, sample=512,
                                    window=w))
        t = float(tm.seam_miss_rate(torch.as_tensor(src), tt, sample=512,
                                    window=w))
        assert abs(t - j) <= 2 / 512, (w, t, j)  # a near-tie row or two
    jq = jm.band_quality_probe(jnp.asarray(src), jt, chunk=256, window=64,
                               sample=512)
    tq = tm.band_quality_probe(torch.as_tensor(src), tt, chunk=256,
                               window=64, sample=512)
    assert tq["band_ratio"] == jq["band_ratio"] == (256 + 128 + 128) / 256
    for key in ("miss_rate", "damaging_rate"):
        assert abs(tq[key] - jq[key]) <= 2 / 512, key
    assert tq["mean_excess_rel"] == pytest.approx(jq["mean_excess_rel"],
                                                  rel=1e-3)
