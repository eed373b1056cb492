"""The brute matcher's last three studies in the port against ``fpcr_tpu``
on the same numpy inputs (CPU): the split distance of ``ops/split.py``
(``split3_f32``, ``augment_norm``, the K packing) against the JAX package's,
Kernel S's plain version against E4 (``scripts/exp_split_matmul.py``) and
E3 (``scripts/exp_reduction2.py``), and the E1 distance forms
(``ops/matching.py::nn_e1``) against ``scripts/exp_match_kernels.py``, the
scripts imported by their path and run in interpret mode at N=512 with
blocks of 64 x 128.

Tolerances. Both sides sum the same exact products (every bf16 x bf16
product is exact in f32, and the forms' products are f32 roundings of the
same values) in another order, so a sum differs by a few ulp of the sum of
its addends' magnitudes, |p|² + |q|² + 2 Σ|p_k q_k| ≤ 2 (|p|² + |q|²) for
the split distance, and C + |q|² + |p|² + 2 Σ|p_k q_k| for the biased forms
(C = max|p|²). ``ORDER_ULPS`` of that bounds it. One exception: the JAX
package's K=24 (terms 3) product in interpret mode on the CPU lies up to 22
ulp of the addend magnitudes from the exact sum of its split products (its
K=48 product and the port's both under 1 ulp), so E4's x3 comparison takes
``X3_JAX_ULPS``. Picks may differ only where the two candidates lie that
close (argmin), or in the same or neighbouring buckets of the packed key.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpcr_tpu.ops.matching_pallas import _augment, _split3
from fpcr_tpu.ops.matching_pallas import split3_f32 as jax_split3
from fpcr_tpu_torch.bench import match_kernels as mk
from fpcr_tpu_torch.bench import reduction2 as r2
from fpcr_tpu_torch.bench import split_matmul as sm
from fpcr_tpu_torch.ops import split as sp
from fpcr_tpu_torch.ops.matching import (E1_VARIANTS, e1_idx_bits,
                                         form_lanes, nn_e1, nn_form,
                                         nn_form_plain, sq_norm)
from fpcr_tpu_torch.ops.matching_cuda import nn_form_cuda
from fpcr_tpu_torch.ops.split_cuda import split_nn_cuda

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
N = 512
ORDER_ULPS = 8
X3_JAX_ULPS = 32
ULP = 2.0 ** -23  # an ulp of x is at most ULP * |x|


def _load(name):
    path = ROOT / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def e1():
    mod = _load("exp_match_kernels")
    mod.INTERPRET = True
    return mod


@pytest.fixture(scope="module")
def e3():
    return _load("exp_reduction2")


@pytest.fixture(scope="module")
def e4():
    return _load("exp_split_matmul")


def _clouds(seed, n=N, m=500, near=False, scale=2.0):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-scale, scale, (m, 3)).astype(np.float32)
    if near:
        p = (q[rng.integers(0, m, n)]
             + rng.normal(0, 0.01, (n, 3))).astype(np.float32)
    else:
        p = rng.uniform(-scale, scale, (n, 3)).astype(np.float32)
    return p, q


def _split_sq(p, q, idx):
    """float64 squared distances of each row's pick."""
    p64, q64 = p.astype(np.float64), q.astype(np.float64)
    return ((p64 - q64[idx]) ** 2).sum(1)


def _norm_bound(p, q, ulps=ORDER_ULPS):
    """``ulps`` of each row's addend magnitudes, 2 (|p|² + max |q|²)."""
    p64, q64 = p.astype(np.float64), q.astype(np.float64)
    return 2 * ulps * ULP * ((p64 ** 2).sum(1) + (q64 ** 2).sum(1).max())


def _assert_argmin_agrees(p, q, ia, ib, da, db, bound):
    """Equal picks but where both candidates lie within ``bound``; the
    distances of equal picks within it too."""
    same = ia == ib
    np.testing.assert_array_less(np.abs(da - db)[same], bound[same] + 1e-30)
    diff = ~same
    gap = np.abs(_split_sq(p[diff], q, ia[diff])
                 - _split_sq(p[diff], q, ib[diff]))
    np.testing.assert_array_less(gap, bound[diff] + 1e-30)
    return int(diff.sum())


# --- the split of ops/split.py ---------------------------------------------

@pytest.mark.parametrize("scale", [1e-3, 2.0, 300.0, 1e4])
def test_split3_is_bit_equal_to_jax(scale):
    """At point-cloud scale (no subnormal remainders) the round-to-nearest
    split through torch.bfloat16 equals ``reduce_precision``'s bit for bit,
    and the three parts sum back to x exactly."""
    rng = np.random.default_rng(int(scale * 10))
    x = (rng.standard_normal((4000, 8)) * scale).astype(np.float32)
    mine = sp.split3_f32(torch.as_tensor(x))
    for a, b in zip(jax_split3(jnp.asarray(x)), mine):
        np.testing.assert_array_equal(np.asarray(a).view(np.int32),
                                      b.numpy().view(np.int32))
    assert torch.equal(mine[0] + mine[1] + mine[2], torch.as_tensor(x))


@pytest.mark.parametrize("n,m,n_pad,m_pad", [(512, 500, 512, 512),
                                             (37, 129, 64, 256),
                                             (1, 1, 8, 128)])
def test_augment_norm_is_bit_equal_to_jax(n, m, n_pad, m_pad):
    """p̂ and the target rows q̂ (the TPU's q̂ᵀ transposed), padded rows
    and the 1e30 surrogate included, bit for bit."""
    p, q = _clouds(n + m, n, m, scale=300.0)
    jp, jq = _augment(jnp.asarray(p), jnp.asarray(q), None, n_pad, m_pad)
    tp, tq = sp.augment_norm(torch.as_tensor(p), torch.as_tensor(q), n_pad,
                             m_pad)
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    np.testing.assert_array_equal(np.asarray(jq).T, tq.numpy())
    np.testing.assert_array_equal(
        sq_norm(torch.as_tensor(p)).numpy(),
        np.asarray(jnp.sum(jnp.asarray(p) ** 2, axis=1)))


@pytest.mark.parametrize("terms", [6, 3, 1])
def test_split_operands_are_the_scripts(terms):
    """The K packing of E3 and E4 (pairs (h,h')(h,m')(m,h')(h,l')(l,h')
    (m,m'), the first ``terms`` kept), target-major, bit for bit."""
    p, q = _clouds(terms, 40, 70)
    jp, jq = _augment(jnp.asarray(p), jnp.asarray(q), None, 48, 128)
    ph, pm, pl = _split3(jp)
    qh, qm, ql = _split3(jq)
    pairs = [(ph, qh), (ph, qm), (pm, qh), (ph, ql), (pl, qh),
             (pm, qm)][:terms]
    p_cat = jnp.concatenate([a for a, _ in pairs], axis=1)
    q_cat = jnp.concatenate([b for _, b in pairs], axis=0)
    tp, tq = sp.split_operands(torch.as_tensor(p), torch.as_tensor(q), terms,
                               48, 128)
    assert tp.dtype == tq.dtype == torch.bfloat16
    assert tp.shape == (48, 8 * terms) and tq.shape == (128, 8 * terms)
    np.testing.assert_array_equal(
        np.asarray(p_cat.astype(jnp.float32)), tp.float().numpy())
    np.testing.assert_array_equal(
        np.asarray(q_cat.astype(jnp.float32)).T, tq.float().numpy())


# --- E4 ---------------------------------------------------------------------

@pytest.mark.parametrize("terms", [6, 3])
@pytest.mark.parametrize("near", [False, True])
def test_split_nn_plain_matches_e4(e4, terms, near):
    """``nn_argmin_split`` (Kernel S's plain version, the distance clamped
    at 0) against ``nn_argmin_packed(terms, 64, 128)``: both sum the same
    exact split products, so picks and distances agree within the order
    bound."""
    p, q = _clouds(7 + terms, near=near)
    ji, jd = e4.nn_argmin_packed(jnp.asarray(p), jnp.asarray(q), terms=terms,
                                 block_n=64, block_m=128)
    ti, td = sm.nn_argmin_split(torch.as_tensor(p), torch.as_tensor(q),
                                terms=terms, block_n=64, block_m=128)
    assert ti.dtype == torch.int32 and td.dtype == torch.float32
    assert (td >= 0).all()
    diff = _assert_argmin_agrees(p, q, ti.numpy(), np.asarray(ji),
                                 td.numpy(), np.asarray(jd),
                                 _norm_bound(p, q, ORDER_ULPS if terms == 6
                                             else X3_JAX_ULPS))
    assert diff <= 2


def test_split_pads_are_the_scripts():
    assert sm.split_pads(512, 500, 64, 128) == (512, 512)
    assert sm.split_pads(5, 1) == (8, 128)
    assert sm.split_pads(16384, 16384) == (16384, 16384)
    assert sm.split_pads(300, 8300) == (512, 16384)


# --- E3 ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def e3_outputs(e3):
    src, tgt = r2.study_inputs("cpu", N)
    js, jt = jnp.asarray(src.numpy()), jnp.asarray(tgt.numpy())
    out = {}
    for v in r2.VARIANTS:
        ji, jd = e3.run_variant(js, jt, variant=v, bn=64, bm=128)
        out[v] = (np.asarray(ji), np.asarray(jd))
    return src.numpy(), tgt.numpy(), out


@pytest.mark.parametrize("variant", r2.VARIANTS)
def test_e3_variant_matches_the_script(e3_outputs, variant):
    """Each of the seven variants through its epilogue against the script's
    ``run_variant(..., bn=64, bm=128)``: ``mmonly`` the kept column,
    ``minonly`` the least distance, the argmin variants picks and
    distances within the order bound, the packed variants the key read as
    f32 within one bucket (2⁻⁹ of the distance) plus the bound, its picks
    equal but in neighbouring buckets."""
    src, tgt, out = e3_outputs
    ji, jd = out[variant]
    ti, td = r2.run_variant(torch.as_tensor(src), torch.as_tensor(tgt),
                            variant, bm=128)
    ti, td = ti.numpy(), td.numpy()
    bound = _norm_bound(src, tgt)
    epi = r2.EPILOGUE[variant]
    if epi in ("keep", "min"):
        np.testing.assert_array_equal(ti, 0)
        np.testing.assert_array_equal(ji, 0)
        np.testing.assert_array_less(np.abs(td - jd), bound)
    elif epi == "argmin":
        _assert_argmin_agrees(src, tgt, ti, ji, td, jd, bound)
    else:
        keys = td.view(np.int32)
        np.testing.assert_array_equal(keys & 0x3FFF, ti)
        bucket = 2.0 ** -9 * np.abs(jd)
        np.testing.assert_array_less(np.abs(td - jd), bucket + bound)
        diff = ti != ji
        gap = np.abs(_split_sq(src[diff], tgt, ti[diff])
                     - _split_sq(src[diff], tgt, ji[diff]))
        np.testing.assert_array_less(gap, 2 * bucket[diff] + bound[diff])


def test_e3_keep_column_and_gates_on_the_cpu():
    """``mmonly`` keeps column (m_pad/bm − 1)·bm; the script's gates hold
    on the CPU at N=512 against K1's plain version."""
    from fpcr_tpu_torch.ops.matching import nn_argmin_plain

    src, tgt = r2.study_inputs("cpu", N)
    p_in, q_in = sp.split_operands(src, tgt, 6, N, 512)
    full = p_in.float() @ q_in.float().T
    _, d = r2.run_variant(src, tgt, "mmonly", bm=128)
    np.testing.assert_allclose(d.numpy(), full[:, 384].numpy(), rtol=0,
                               atol=float(_norm_bound(src.numpy(),
                                                      tgt.numpy()).max()))
    i_lib, _ = nn_argmin_plain(src, tgt, exact=True)
    gates = r2.check_gates(src, tgt, i_lib, bm=128)
    assert gates["packed_swaps"] <= 2


def test_packed14_guard_raises():
    """Past 2^14 padded targets the 14-bit key would corrupt silently, so
    both versions raise before computing anything, and the kernel's
    wrapper before launching."""
    p = torch.zeros((4, 3))
    q = torch.zeros((16385, 3))
    with pytest.raises(ValueError, match="2\\^14"):
        r2.run_variant(p, q, "packed")  # m_pad = 16,384 + 8,192
    p_in, q_in = sp.split_operands(p, q[:16385], 6, 4, 16392)
    for fn in (sp.split_nn, sp.split_nn_plain):
        with pytest.raises(ValueError, match="2\\^14"):
            fn(p_in, q_in, 4, 16385, "packed14")
    p_in, q_in = sp.split_operands(p, q[:16384], 6, 4, 16384)
    i, d = sp.split_nn(p_in, q_in, 4, 16384, "packed14")  # 2^14: allowed
    assert int(i.max()) < 1 << 14


@pytest.mark.parametrize("m", [8, 16, 24])
def test_split_nn_plain_finds_known_neighbours(m):
    """q = p shifted by a distinct small offset per row: every epilogue
    finds row i's own target (the check the kernel's fragment layout is
    held to on the card)."""
    rng = np.random.default_rng(m)
    p = rng.uniform(-1, 1, (m, 3)).astype(np.float32)
    off = (np.arange(m, dtype=np.float32) + 1)[:, None] * np.float32(1e-3)
    q = (p + off * np.array([1, -1, 1], np.float32)).astype(np.float32)
    p_in, q_in = sp.split_operands(torch.as_tensor(p), torch.as_tensor(q), 6,
                                   m, 128)
    i, d = sp.split_nn(p_in, q_in, m, m, "argmin")
    np.testing.assert_array_equal(i.numpy(), np.arange(m))
    i, d = sp.split_nn(p_in, q_in, m, m, "packed14")
    np.testing.assert_array_equal(i.numpy(), np.arange(m))
    _, dmin = sp.split_nn(p_in, q_in, m, m, "min")
    exact = 3 * off[:, 0].astype(np.float64) ** 2
    np.testing.assert_allclose(dmin.numpy(), exact, rtol=0,
                               atol=float(_norm_bound(p, q).max()))


def test_split_nn_ties_and_checks():
    """Duplicate targets: the argmin and the packed key pick the lowest
    index. The dispatcher and the plain version check their arguments; the
    kernel's wrapper takes CUDA tensors only and launches nothing here."""
    q = np.repeat(np.array([[1, 0, 0], [0, 1, 0]], np.float32), 5, axis=0)
    p = np.array([[0.9, 0, 0], [0, 1.1, 0]], np.float32)
    p_in, q_in = sp.split_operands(torch.as_tensor(p), torch.as_tensor(q), 6,
                                   2, 16)
    for epi in ("argmin", "packed14"):
        i, _ = sp.split_nn(p_in, q_in, 2, 10, epi)
        assert i.tolist() == [0, 5]
    before = dict(split_nn_cuda.launches)
    with pytest.raises(ValueError, match="CUDA"):
        split_nn_cuda(p_in, q_in, 2, 10, "argmin")
    for kw in (dict(epilogue="nope"), dict(epilogue="keep", keep=10),
               dict(epilogue="keep")):
        with pytest.raises(ValueError):
            sp.split_nn(p_in, q_in, 2, 10, **kw)
    with pytest.raises(ValueError):
        sp.split_nn(p_in, q_in, 3, 10, "min")
    assert split_nn_cuda.launches == before
    with pytest.raises(ValueError):
        sp.split_operands(torch.as_tensor(p), torch.as_tensor(q), 7, 2, 16)


# --- E1 ---------------------------------------------------------------------

MAKERS = {"v1": lambda m: m.make_v1(64, 128, "v1"),
          "v3": lambda m: m.make_v1(64, 128, "v3"),
          "v2": lambda m: m.make_v2(64, 128),
          "v4": lambda m: m.make_v4(64, 128),
          "v5": lambda m: m.make_v5(64, 128),
          "v6": lambda m: m.make_v6(64, 128)}


@pytest.mark.parametrize("variant", list(MAKERS))
def test_e1_variant_matches_the_script(e1, variant):
    """Each ``make_v*(64, 128)`` (interpret mode) against ``nn_e1(...,
    block_m=128)`` on the script's inputs at N=512: picks equal but where
    the two candidates lie within the order bound of the biased sum
    (argmin; ~0.03 an ulp of C ≈ 2.7e5 at ±300) or in neighbouring buckets
    of the key (packed: 2^−(23−9) of the keyed value, which for v2 is the
    biased one); the argmin distances within the bound, the packed ones
    recomputed by the difference form within 4 ulp of themselves."""
    p, q = mk.study_inputs(N, "cpu")
    ji, jd = MAKERS[variant](e1)(jnp.asarray(p.numpy()),
                                 jnp.asarray(q.numpy()))
    ji, jd = np.asarray(ji), np.asarray(jd)
    ti, td = nn_e1(p, q, variant, block_m=128)
    assert ti.dtype == torch.int32 and td.dtype == torch.float32
    ti, td = ti.numpy(), td.numpy()
    pn, qn = p.numpy(), q.numpy()
    form, reduce = E1_VARIANTS["v1" if variant == "v3" else variant]
    _, p_sq, c = form_lanes(p, q, form)
    big = (float(c) + 2 * (qn.astype(np.float64) ** 2).sum(1).max()
           + 2 * p_sq.numpy().astype(np.float64))
    bound = ORDER_ULPS * ULP * big
    if reduce == "argmin":
        _assert_argmin_agrees(pn, qn, ti, ji, td, jd, bound)
        if variant == "v6":
            assert (td >= 0).all()
        return
    keyed = _split_sq(pn, qn, ji)  # the biased value is C − |p|² + d
    if form == "biased":
        keyed = keyed + float(c) - p_sq.numpy().astype(np.float64)
    bucket = 2.0 ** -(23 - e1_idx_bits(N, 128)) * np.abs(keyed)
    same = ti == ji
    np.testing.assert_allclose(td[same], jd[same], rtol=4 * ULP, atol=0)
    gap = np.abs(_split_sq(pn[~same], qn, ti[~same])
                 - _split_sq(pn[~same], qn, ji[~same]))
    np.testing.assert_array_less(gap, 2 * bucket[~same] + bound[~same])
    np.testing.assert_allclose(td, _split_sq(pn, qn, ti), rtol=4 * ULP)


def test_e1_index_bits_and_lanes():
    """b = bit_length(round_up(m, bm) − 1): 9 at 512 with bm 128, 14 at
    16,384 with the study's 8,192; the staged lanes of each form."""
    assert e1_idx_bits(512, 128) == 9
    assert e1_idx_bits(16384, 8192) == 14
    assert e1_idx_bits(1, 8192) == 13
    p, q = mk.study_inputs(64, "cpu")
    psq, qsq = sq_norm(p), sq_norm(q)
    c = psq.max()
    w, s, cc = form_lanes(p, q, "biased")
    assert torch.equal(w, qsq + c) and torch.equal(s, psq) and cc == c
    assert torch.equal(form_lanes(p, q, "expand")[0], (qsq + c) - c)
    assert torch.equal(form_lanes(p, q, "expand5")[0], qsq)


def test_e1_forms_against_float64():
    """Each form's argmin and packed pick against the float64 oracle on the
    study's inputs at N=512: index parity 1 and the exact distance."""
    p, q = mk.study_inputs(N, "cpu")
    exact_idx, exact_d = mk.exact_oracle(p, q)
    for v in ("v1", "v2", "v4", "v5", "v6"):
        parity, rel = mk.check_correct(lambda: nn_e1(p, q, v, 128), p, q,
                                       exact_idx, exact_d, v)
        assert parity > 0.99 and rel < 1e-2, (v, parity, rel)


def test_e1_ties_and_checks():
    """Duplicate targets go to the lowest index under every form; the
    wrapper takes CUDA tensors only; an unknown pair raises."""
    q = torch.tensor([[5.0, 0, 0], [1, 0, 0], [2, 0, 0], [1, 0, 0]])
    p = torch.zeros((1, 3))
    for v in ("v1", "v2", "v4", "v5", "v6"):
        i, _ = nn_e1(p, q, v)
        assert i.tolist() == [1], v
    q_w, p_sq, _ = form_lanes(p, q, "biased")
    before = dict(nn_form_cuda.launches)
    with pytest.raises(ValueError, match="CUDA"):
        nn_form_cuda(p, q, q_w, None, form="biased", reduce="argmin")
    for fn in (nn_form, nn_form_plain):
        with pytest.raises(ValueError):
            fn(p, q, q_w, p_sq, form="expand", reduce="argmin")
    with pytest.raises(ValueError):
        nn_form_plain(p, q, q_w, p_sq, form="biased", reduce="packed",
                      idx_bits=1)
    assert nn_form_cuda.launches == before


@pytest.mark.parametrize("main", [sm.main, r2.main, mk.main],
                         ids=["split_matmul", "reduction2", "match_kernels"])
def test_study_main_raises_without_a_card(main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main()
