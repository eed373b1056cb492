"""The reduction of Kernel S's wgmma sweep (``csrc/split_wgmma.cu``) on the
CPU, through its plain-torch mirror ``ops/split.py::split_wgmma_mirror``
(the kernel itself runs on the card only: ``tests/test_torch_gpu.py``).

The mirror follows the kernel's order: target slices, 128-column tiles,
each thread's 32 columns of a row in the wgmma accumulator layout, the
int32 tile minimum with its float fallback, the quad's strict improvement
test and kept tile, the search for the first column, the masking of columns
past the slice, then the slice combine. Fed the same values, it must equal
``split_reduce_plain`` (``split_nn_plain``'s reduction) bit for bit, for
every epilogue at terms 6 and 3: indices equal, and distances equal in
their bits (the least value of ``'min'`` may differ only in the sign of a
zero or the bits of a NaN). Then once against E4 (``scripts/exp_split_matmul.py``) and E3
(``scripts/exp_reduction2.py``) in interpret mode at N=512, with the
tolerances of ``tests/test_torch_studies.py``: both sum the same exact
split products in another order, so values agree within ``ORDER_ULPS`` of
the addend magnitudes (``X3_JAX_ULPS`` for the JAX package's K=24 product)
and picks differ only where two candidates lie that close.
"""

import importlib.util
import math
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpcr_tpu_torch.bench import reduction2 as r2
from fpcr_tpu_torch.bench.split_matmul import split_pads
from fpcr_tpu_torch.ops import split as sp
from fpcr_tpu_torch.ops.split_cuda import SPLIT_ROWS, TILE, plan_split

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
N = 512
ORDER_ULPS = 8
X3_JAX_ULPS = 32
ULP = 2.0 ** -23
SMS = 132  # the H100's SMs: the slice plan the card takes
EPILOGUES = ("argmin", "packed14", "min", "keep")


def _values(p, q, terms, m_pad=None):
    """The split distance f32[n, m] of float32 clouds, as the plain version
    computes it (the kernel's own values differ only in the order of the
    sums)."""
    n, m = p.shape[0], q.shape[0]
    pads = split_pads(n, m)
    p_in, q_in = sp.split_operands(torch.as_tensor(p), torch.as_tensor(q),
                                   terms, pads[0], m_pad or pads[1])
    return p_in[:n].float() @ q_in[:m].float().T


def _cloud(rng, n, scale=2.0):
    return rng.uniform(-scale, scale, (n, 3)).astype(np.float32)


def _case(name, terms):
    """The values f32[n, m] of a named case."""
    rng = np.random.default_rng(zlib.crc32(f"{name} {terms}".encode()))
    if name.startswith("m="):
        m = int(name[2:])
        return _values(_cloud(rng, 37), _cloud(rng, m), terms)
    if name == "ties":  # one target at columns 5, 77 (one tile), 200, 300
        q = _cloud(rng, 420) + 9.0
        q[[5, 77, 200, 300]] = 0.5
        p = np.zeros((24, 3), np.float32)
        p[12:] = _cloud(rng, 12, 0.1)
        return _values(p, q, terms)
    if name == "duplicates":  # 37 points 27 times each, near probes
        dup = np.repeat(_cloud(rng, 37), 27, axis=0)
        near = dup[rng.integers(0, 999, 70)] + _cloud(rng, 70, 2e-3)
        return _values(near.astype(np.float32), dup, terms)
    if name == "negative":  # values below zero, ties among them
        v = torch.as_tensor(rng.normal(0, 1, (40, 700)).astype(np.float32))
        v[:, 650] = v[:, 3] = v.min() - 1.0
        v[5, 130] = -1e30
        return v
    if name == "slice inside tile":  # the last slice ends mid-tile
        return _values(_cloud(rng, 50), _cloud(rng, 1000), terms)
    if name == "inf nan zeros":  # +-inf, the tensor cores' NaN, -0 and +0
        v = torch.as_tensor(rng.uniform(0, 1, (16, 300)).astype(np.float32))
        nan = torch.tensor(0x7FFFFFFF, dtype=torch.int32).view(torch.float32)
        v[0] = nan
        v[1, :150] = nan
        v[2] = float("inf")
        v[3, 7] = float("-inf")
        v[4, 140] = -0.0
        v[4, 9] = 0.0
        v[5, 140] = 0.0
        v[5, 9] = -0.0
        v[6, ::3] = nan
        v[7, :130] = float("inf")
        return v
    raise KeyError(name)


CASES = ["m=1", "m=127", "m=128", "m=129", "m=16384", "ties", "duplicates",
         "negative", "slice inside tile", "inf nan zeros"]


def _same(a, b, epilogue):
    ai, ad = a
    bi, bd = b
    assert ai.dtype == bi.dtype == torch.int32
    assert ad.dtype == bd.dtype == torch.float32
    assert torch.equal(ai, bi), "picks differ"
    same_bits = ad.view(torch.int32) == bd.view(torch.int32)
    if epilogue == "min":  # fminf leaves the sign of a zero open, and
        # torch the bits of a NaN it passes on
        same_bits |= ((ad == 0) & (bd == 0)) | (ad.isnan() & bd.isnan())
    assert bool(same_bits.all()), "distance bits differ"


def _slice_lengths(n, m):
    """The card's plan for this shape, one slice, and one that ends
    inside a tile."""
    plan = plan_split(n, m, SPLIT_ROWS, SMS)[1]
    return sorted({plan, -(-m // TILE) * TILE, 2 * TILE})


@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("terms", [6, 3])
@pytest.mark.parametrize("case", CASES)
def test_mirror_equals_plain_bit_for_bit(case, terms, epilogue):
    v = _case(case, terms)
    n, m = v.shape
    keep = m - 1 if case != "ties" else 77
    clamp = terms == 3 and epilogue == "argmin"  # E4's clamp, E3's none
    want = sp.split_reduce_plain(v, epilogue, keep=keep, clamp=clamp)
    for sl in _slice_lengths(n, m):
        got = sp.split_wgmma_mirror(v, epilogue, slice_len=sl, keep=keep,
                                    clamp=clamp)
        _same(got, want, epilogue)


def test_mirror_picks_the_first_minimum():
    """The ties case: every probe at the origin picks column 5, the first of
    four equal targets (two in one tile, one in the next, one two tiles
    on), in one slice or in slices of 128 and 256."""
    v = _case("ties", 6)
    for sl in (128, 256, 512):
        for epi in ("argmin", "packed14"):
            i, _ = sp.split_wgmma_mirror(v, epi, slice_len=sl)
            assert (i[:12] == 5).all()


@pytest.mark.parametrize("extra", [0, 4, 84])
def test_mirror_masks_columns_past_the_slice(extra):
    """Columns past the last target whose values would win (zeros, as a TMA
    copy past the operand lands, and the surrogate's rows beside them) are
    swept with their tile and never picked: the kernel masks them."""
    v = torch.ones((8, 300))
    v[:, 10] = 0.5
    wide = torch.cat([v, torch.zeros((8, extra))], 1)
    for epi in ("argmin", "packed14", "min"):
        for sl in (128, 256, 384):
            got = sp.split_wgmma_mirror(wide, epi, slice_len=sl, m=300)
            _same(got, sp.split_reduce_plain(v, epi), epi)
            assert float(got[1].min()) > 0.0
            if epi != "min":
                assert (got[0] == 10).all()


def test_split_nn_plain_is_the_reduction_of_its_values():
    """``split_nn_plain`` equals ``split_reduce_plain`` over the values of
    its own product, so the mirror cases above hold for it too."""
    rng = np.random.default_rng(5)
    p, q = _cloud(rng, 40), _cloud(rng, 3000)
    p_in, q_in = sp.split_operands(torch.as_tensor(p), torch.as_tensor(q), 6,
                                   40, 3072)
    a = p_in.float()
    v = torch.cat([a @ q_in[t0:min(3000, t0 + 2048)].float().T
                   for t0 in range(0, 3000, 2048)], 1)
    for epi in ("argmin", "packed14", "min"):
        _same(sp.split_nn_plain(p_in, q_in, 40, 3000, epi),
              sp.split_reduce_plain(v, epi), epi)
    # the keep column is its own one-column product
    v[:, 2999:] = a @ q_in[2999:3000].float().T
    _same(sp.split_nn_plain(p_in, q_in, 40, 3000, "keep", keep=2999),
          sp.split_reduce_plain(v, "keep", keep=2999), "keep")


@pytest.mark.parametrize("n,m,sms,want", [
    (16384, 16384, 132, (3, 5504)), (300, 16384, 132, (64, 256)),
    (1, 1, 132, (1, 128)), (4099, 20001, 132, (6, 3456)),
    (16384, 16384, 256, (11, 1536)), (100000, 5, 132, (1, 128))])
def test_plan_split(n, m, sms, want):
    slices, slice_len = plan_split(n, m, SPLIT_ROWS, sms)
    assert (slices, slice_len) == want
    assert slice_len % TILE == 0 and (slices - 1) * slice_len < m


# --- once against the TPU kernels in interpret mode ------------------------

def _load(name):
    path = ROOT / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sq64(p, q, idx):
    return ((p.astype(np.float64) - q.astype(np.float64)[idx]) ** 2).sum(1)


def _norm_bound(p, q, ulps=ORDER_ULPS):
    p64, q64 = p.astype(np.float64), q.astype(np.float64)
    return 2 * ulps * ULP * ((p64 ** 2).sum(1) + (q64 ** 2).sum(1).max())


def _argmin_agrees(p, q, ia, ib, da, db, bound):
    same = ia == ib
    np.testing.assert_array_less(np.abs(da - db)[same], bound[same] + 1e-30)
    gap = np.abs(_sq64(p[~same], q, ia[~same]) - _sq64(p[~same], q, ib[~same]))
    np.testing.assert_array_less(gap, bound[~same] + 1e-30)
    return int((~same).sum())


def _mirror_run(p, q, terms, epilogue, m_pad, keep=None, clamp=False):
    v = _values(p, q, terms, m_pad)
    sl = plan_split(p.shape[0], q.shape[0], SPLIT_ROWS, SMS)[1]
    i, d = sp.split_wgmma_mirror(v, epilogue, slice_len=sl, keep=keep,
                                 clamp=clamp)
    return i.numpy(), d.numpy()


@pytest.mark.parametrize("terms", [6, 3])
def test_mirror_matches_e4(terms):
    """E4's ``nn_argmin_packed(terms, 64, 128)`` against the mirror's clamped
    argmin, as Kernel S's plain version is held to it."""
    e4 = _load("exp_split_matmul")
    rng = np.random.default_rng(7 + terms)
    q = rng.uniform(-2, 2, (500, 3)).astype(np.float32)
    p = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    ji, jd = e4.nn_argmin_packed(jnp.asarray(p), jnp.asarray(q), terms=terms,
                                 block_n=64, block_m=128)
    ti, td = _mirror_run(p, q, terms, "argmin", 512, clamp=True)
    assert (td >= 0).all()
    diff = _argmin_agrees(p, q, ti, np.asarray(ji), td, np.asarray(jd),
                          _norm_bound(p, q, ORDER_ULPS if terms == 6
                                      else X3_JAX_ULPS))
    assert diff <= 2


@pytest.mark.parametrize("variant", ["fullx", "packed", "minonly", "mmonly"])
def test_mirror_matches_e3(variant):
    """E3's ``run_variant(..., bn=64, bm=128)`` on its saddle against the
    mirror through the variant's epilogue."""
    e3 = _load("exp_reduction2")
    src, tgt = r2.study_inputs("cpu", N)
    ji, jd = e3.run_variant(jnp.asarray(src.numpy()),
                            jnp.asarray(tgt.numpy()), variant=variant, bn=64,
                            bm=128)
    ji, jd = np.asarray(ji), np.asarray(jd)
    src, tgt = src.numpy(), tgt.numpy()
    epi = r2.EPILOGUE[variant]
    ti, td = _mirror_run(src, tgt, 6, epi, 512, keep=384)
    bound = _norm_bound(src, tgt)
    if epi in ("keep", "min"):
        np.testing.assert_array_equal(ti, 0)
        np.testing.assert_array_less(np.abs(td - jd), bound)
    elif epi == "argmin":
        _argmin_agrees(src, tgt, ti, ji, td, jd, bound)
    else:
        np.testing.assert_array_equal(td.view(np.int32) & 0x3FFF, ti)
        bucket = 2.0 ** -9 * np.abs(jd)
        np.testing.assert_array_less(np.abs(td - jd), bucket + bound)
        diff = ti != ji
        gap = np.abs(_sq64(src[diff], tgt, ti[diff])
                     - _sq64(src[diff], tgt, ji[diff]))
        np.testing.assert_array_less(gap, 2 * bucket[diff] + bound[diff])
    assert math.isfinite(float(np.abs(td).max()))



@pytest.mark.parametrize("study", ["e4 argmin", "e3 fullx", "e3 packed",
                                   "e3 minonly"])
def test_nan_against_e3_e4(study):
    """What E4 and E3 do with a NaN, in interpret mode at N=512 with blocks
    of 128 targets, against the plain version (which the mirror, and so
    the kernel, equals bit for bit above): a NaN source point gives a row
    of NaN, a NaN target point a column of NaN.

    ``packed``: a NaN keys above every finite value in both, so the picks
    are equal and the NaN row keeps the initial key; -0 keys as +0, as
    JAX's ``max(-0, 0)`` is +0. ``minonly``: a NaN makes the least value
    NaN in both. The argmin: the NaN row picks nothing (index 0, +inf) in
    both, and neither picks the NaN column; JAX passes over the whole
    block of 128 columns that holds it (the block's min is NaN, which
    never compares less), which depends on its block width, so only rows
    whose pick lies outside that block are held equal."""
    e3, e4 = _load("exp_reduction2"), _load("exp_split_matmul")
    rng = np.random.default_rng(3)
    p = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    q = rng.uniform(-2, 2, (500, 3)).astype(np.float32)
    p[3], q[100] = np.nan, np.nan
    p_in, q_in = sp.split_operands(torch.as_tensor(p), torch.as_tensor(q), 6,
                                   *split_pads(N, 500))
    name, variant = study.split()
    if name == "e4":
        ji, jd = e4.nn_argmin_packed(jnp.asarray(p), jnp.asarray(q), terms=6,
                                     block_n=64, block_m=128)
    else:
        ji, jd = e3.run_variant(jnp.asarray(p), jnp.asarray(q),
                                variant=variant, bn=64, bm=128)
    ji, jd = np.asarray(ji), np.asarray(jd)
    epi = "argmin" if name == "e4" else r2.EPILOGUE[variant]
    ti, td = sp.split_nn_plain(p_in, q_in, N, 500, epi, clamp=name == "e4")
    ti, td = ti.numpy(), td.numpy()
    assert not (ti == 100).any() and not (ji == 100).any()
    if epi == "min":
        assert np.isnan(jd).all() and np.isnan(td).all()
        return
    if epi == "packed14":
        np.testing.assert_array_equal(ti, ji)
        assert ti[3] == 0x3FFF and td.view(np.int32)[3] == 0x7F7FFFFF
        assert jd.view(np.int32)[3] == 0x7F7FFFFF
        zero = jnp.maximum(jnp.float32(-0.0), 0.0).view(jnp.int32)
        assert int(zero) == 0
        return
    assert (ti[3], ji[3]) == (0, 0) and np.isinf(td[3]) and np.isinf(jd[3])
    assert not ((ji < 128) & (np.arange(N) != 3)).any()
    out = (ti >= 128) & (np.arange(N) != 3)
    assert out.sum() > N // 2
    _argmin_agrees(p[out], q, ti[out], ji[out], td[out], jd[out],
                   _norm_bound(p[out], np.delete(q, 100, 0)))
