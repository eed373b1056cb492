"""The E1 distance forms' and E2's min-only NaN rules in the port against
the JAX scripts, and the CPU mirror of ``csrc/nn_forms.cu``'s reduction
(``ops/matching.py::nn_forms_mirror``) bit for bit against the plain
versions (``nn_form_plain``, ``nn_min_only_plain``).

The scripts (``scripts/exp_match_kernels.py`` with ``INTERPRET = True``,
``scripts/exp_packed_reduction.py``) are imported by their path and run in
interpret mode at 512 source rows, blocks of 8 x 128, against 300 targets
of the study's inputs, with a NaN in one target or one source row.

The NaN rules (the kernel's and the plain version's): a NaN value is never
picked. The argmin passes over the NaN pair only; a NaN's packed key lies
above every finite key; a row whose every value is NaN gets index 0 and
``inf``; a NaN among a row's values makes its minimum NaN. The scripts
agree but in two places: their tile argmin passes over the whole block
that holds a NaN, so their picks depend on the block width ``bm``; and
where every value of a row is NaN their packed key compares the NaN's own
bits and picks a target.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpcr_tpu_torch.bench import match_kernels as mk
from fpcr_tpu_torch.bench import packed_reduction as pr
from fpcr_tpu_torch.ops.matching import (E1_VARIANTS, PACKED_KEY_INIT,
                                         e1_idx_bits, form_key_bits,
                                         form_lanes, form_values, nn_e1,
                                         nn_form_plain, nn_forms_mirror,
                                         pairwise_sqdist_exact)

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
N, M = 512, 300
ULP = 2.0 ** -23


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
def e2():
    return _load("exp_packed_reduction")


def _study(case, study=mk):
    """A study's inputs (512 rows, 300 targets; E1's by default) with a NaN
    coordinate in target 5 or in source row 5."""
    p, q = study.study_inputs(N, "cpu")
    p, q = p.clone(), q[:M].clone()
    if case == "NaN target":
        q[5, 1] = float("nan")
    else:
        p[5] = float("nan")
    return p, q


def _script(e1, variant, bm=128):
    maker = {"v1": lambda: e1.make_v1(8, bm), "v2": lambda: e1.make_v2(8, bm),
             "v4": lambda: e1.make_v4(8, bm), "v5": lambda: e1.make_v5(8, bm),
             "v6": lambda: e1.make_v6(8, bm)}[variant]()
    return maker


def _run_script(e1, variant, p, q, bm=128):
    i, d = _script(e1, variant, bm)(jnp.asarray(p.numpy()),
                                    jnp.asarray(q.numpy()))
    return np.asarray(i), np.asarray(d)


@pytest.mark.parametrize("variant", ["v2", "v4", "v5"])
def test_packed_forms_never_pick_a_nan_target(e1, variant):
    """A NaN target: the script and the plain version pick the same target
    in every row, never the NaN one, and the same exact distance (summed
    in another order: within 4 ulp)."""
    p, q = _study("NaN target")
    ji, jd = _run_script(e1, variant, p, q)
    ti, td = nn_e1(p, q, variant, block_m=128)
    np.testing.assert_array_equal(ti.numpy(), ji)
    assert not (ji == 5).any()
    np.testing.assert_allclose(td.numpy(), jd, rtol=4 * ULP, atol=0)


@pytest.mark.parametrize("variant", ["v2", "v4", "v5"])
def test_packed_forms_with_a_nan_source_row(e1, variant):
    """A NaN source row: every value of that row is NaN (of every row for
    v2 and v4, whose lanes carry C = max|p|^2). The plain version keeps
    the kernel's convention there, index 0 and ``inf``; the script's key
    compares the NaN's bits (v4 and v5 clamp it to one NaN and pick target
    0; v2's raw NaNs pick by their payloads), and it recomputes the
    distance to its pick. Rows with a finite value pick as the script."""
    p, q = _study("NaN source row")
    ji, jd = _run_script(e1, variant, p, q)
    ti, td = nn_e1(p, q, variant, block_m=128)
    ti, td = ti.numpy(), td.numpy()
    q_w, p_sq, _ = form_lanes(p, q, E1_VARIANTS[variant][0])
    all_nan = np.ones(N, bool) if variant != "v5" else np.isnan(
        p_sq.numpy())
    assert (ti[all_nan] == 0).all() and np.isinf(td[all_nan]).all()
    np.testing.assert_array_equal(ti[~all_nan], ji[~all_nan])
    if variant != "v2":
        assert (ji[all_nan] == 0).all()
    assert np.isnan(jd[5]) and np.isinf(td[5])


@pytest.mark.parametrize("variant", ["v1", "v6"])
def test_argmin_forms_pass_over_the_nan_pair_only(e1, variant):
    """A NaN target: the plain version passes over that pair only, so it
    picks what it picks when the NaN target lies far away; the script
    passes over the whole block of ``bm`` targets that holds it in every
    row, so its picks change between ``bm`` = 128 and 256 and never fall in
    the first block."""
    p, q = _study("NaN target")
    far = q.clone()
    far[5] = 1e6
    ti, td = nn_e1(p, q, variant, block_m=128)
    fi, fd = nn_e1(p, far, variant, block_m=128)
    assert torch.equal(ti, fi) and not bool((ti == 5).any())
    np.testing.assert_array_equal(td.numpy(), fd.numpy())
    j128, _ = _run_script(e1, variant, p, q, 128)
    j256, _ = _run_script(e1, variant, p, q, 256)
    assert j128.min() >= 128 and j256.min() >= 256
    assert (j128 != j256).sum() > N // 4
    assert int((ti < 128).sum()) > N // 4


@pytest.mark.parametrize("variant", ["v1", "v6"])
def test_argmin_forms_with_a_nan_source_row(e1, variant):
    """A NaN source row: index 0 there on both sides (the script's block
    minimum is NaN and never improves on ``inf``); v1's output formula
    makes the distance NaN, v6's clamp leaves ``inf``."""
    p, q = _study("NaN source row")
    ji, jd = _run_script(e1, variant, p, q)
    ti, td = nn_e1(p, q, variant, block_m=128)
    assert ti[5] == 0 and ji[5] == 0
    assert np.array_equal(np.isnan(td.numpy()), np.isnan(jd))
    assert np.array_equal(np.isinf(td.numpy()), np.isinf(jd))


@pytest.mark.parametrize("case", ["NaN target", "NaN source row"])
def test_min_only_propagates_a_nan_as_the_script(e2, case):
    """``make_minonly(8, 128)`` against ``nn_min_only_plain``: a NaN
    target makes every row NaN, a NaN source row its own row; the other
    rows within the script's f32-grade tolerance (as
    ``tests/test_torch_packed.py`` holds them, on E2's inputs)."""
    p, q = _study(case, pr)
    _, jd = e2.make_minonly(8, 128)(jnp.asarray(p.numpy()),
                                    jnp.asarray(q.numpy()))
    jd = np.asarray(jd)
    td = pr.nn_min_only_plain(p, q).numpy()
    np.testing.assert_array_equal(np.isnan(td), np.isnan(jd))
    assert np.isnan(td).sum() == (N if case == "NaN target" else 1)
    fin = ~np.isnan(td)
    np.testing.assert_allclose(td[fin], jd[fin], rtol=1e-5, atol=4e-5)


def test_clamp_keys_negative_zero_as_the_script():
    """v4's and v5's clamp keys ``-0.0`` as ``+0.0``, as the script's
    ``jnp.maximum(d, 0.0)`` gives it (``torch.clamp_min`` keeps ``-0.0``,
    whose key 0x80000000 would win every row); a NaN keys as the card's
    NaN, above every finite value; v2 keeps the raw bits."""
    d = torch.tensor([-0.0, 0.0, -1.5, 2.0, float("nan"), float("inf")])
    clamped = form_key_bits(d, True)
    jax_bits = np.asarray(jnp.maximum(jnp.asarray(d.numpy()), 0.0)).view(
        np.int32)
    np.testing.assert_array_equal(clamped[:4].numpy(), jax_bits[:4])
    assert clamped.tolist()[:2] == [0, 0] and clamped[4] == 0x7FFFFFFF
    assert torch.clamp_min(d, 0.0).view(torch.int32)[0] == -(1 << 31)
    raw = form_key_bits(d, False)
    assert raw[0] == -(1 << 31) and raw[4] == 0x7FFFFFFF
    assert raw[5] == 0x7F800000


def _zero_lanes():
    """Rows at the origin against positive targets, the staged lane +0.0
    on target 3 and -0.0 on target 5, |p|^2 lanes -0.0: the values of
    targets 3 and 5 are exactly +0.0 and -0.0 under every form."""
    n, m = 16, 40
    p = torch.zeros((n, 3))
    q = torch.rand((m, 3), generator=torch.Generator().manual_seed(5)) + 0.5
    q_w = torch.linspace(1.0, 2.0, m)
    q_w[3], q_w[5] = 0.0, -0.0
    return p, q, q_w, torch.full((n,), -0.0)


@pytest.mark.parametrize("variant", ["v1", "v2", "v4", "v5", "v6"])
def test_negative_zero_picks(variant):
    """The argmin takes the first of the tied zeros (target 3, +0.0); v2's
    raw key of -0.0 is the least (target 5); v4's and v5's clamp ties them
    and the lower index wins (target 3). The mirror agrees bit for bit."""
    form, reduce = E1_VARIANTS[variant]
    p, q, q_w, p_sq = _zero_lanes()
    psq = None if form == "biased" else p_sq
    bits = 6 if reduce == "packed" else None
    ti, td = nn_form_plain(p, q, q_w, psq, form=form, reduce=reduce,
                           idx_bits=bits)
    want = 5 if variant == "v2" else 3
    assert ti.tolist() == [want] * p.shape[0]
    if reduce == "argmin":
        assert td.view(torch.int32).tolist() == [0] * p.shape[0]
    vals = form_values(p, q, q_w, p_sq, form)
    assert int(vals[0, 5].view(torch.int32)) == -(1 << 31)
    mi, md = nn_forms_mirror(vals, reduce, slice_len=32, idx_bits=bits,
                             clamp=form != "biased", sub=4)
    assert torch.equal(mi, ti)


# --- the mirror of csrc/nn_forms.cu's reduction ------------------------------

def _mirror_case(case):
    """``(p, q)`` of a mirror case: the study's ±300 inputs at ragged sizes,
    duplicated targets (ties across sub-tiles and slices), a NaN target, a
    NaN source row, a single target."""
    rng = np.random.default_rng(len(case) * 7)
    n, m = {"m=1": (50, 1), "m=37": (60, 37), "m=300": (70, 300),
            "m=1000": (40, 1000), "ties": (64, 700), "NaN target": (64, 500),
            "NaN source row": (64, 500)}[case]
    p = rng.uniform(-300, 300, (n, 3)).astype(np.float32)
    q = rng.uniform(-300, 300, (m, 3)).astype(np.float32)
    if case == "ties":
        q = np.repeat(q[:35], 20, axis=0)
        p = (q[rng.integers(0, 700, n)] + 0.5).astype(np.float32)
    elif case == "NaN target":
        q[77, 2] = np.nan
    elif case == "NaN source row":
        p[9, 0] = np.nan
    return torch.as_tensor(p), torch.as_tensor(q)


MIRROR_CASES = ["m=1", "m=37", "m=300", "m=1000", "ties", "NaN target",
                "NaN source row"]


@pytest.mark.parametrize("slice_len", [64, 256, 2048])
@pytest.mark.parametrize("case", MIRROR_CASES)
@pytest.mark.parametrize("variant", ["v1", "v2", "v4", "v5", "v6"])
def test_mirror_equals_plain(variant, case, slice_len):
    """The sub-tile fminf and rescan (argmin), the sub-tile int32 min of
    the bits and rescan (packed), over slices of ``slice_len`` combined as
    the kernel's partials: the picks, and the argmin's value bits, of
    ``nn_form_plain`` on the same values; the packed keys at their initial
    value exactly where the plain version gives ``inf``."""
    form, reduce = E1_VARIANTS[variant]
    p, q = _mirror_case(case)
    q_w, p_sq, _ = form_lanes(p, q, form)
    psq = None if form == "biased" else p_sq
    bits = e1_idx_bits(q.shape[0], 128) if reduce == "packed" else None
    ti, td = nn_form_plain(p, q, q_w, psq, form=form, reduce=reduce,
                           idx_bits=bits)
    vals = form_values(p, q, q_w, p_sq, form)
    mi, md = nn_forms_mirror(vals, reduce, slice_len=slice_len,
                             idx_bits=bits, clamp=form != "biased")
    assert torch.equal(mi, ti)
    if reduce == "argmin":
        assert torch.equal(md.view(torch.int32), td.view(torch.int32))
    else:
        assert torch.equal(md == PACKED_KEY_INIT, td.isinf())
    if case == "NaN target":
        assert not bool((ti == 77).any())


@pytest.mark.parametrize("slice_len", [64, 256, 2048])
@pytest.mark.parametrize("case", MIRROR_CASES + ["masked"])
def test_mirror_min_equals_plain(case, slice_len):
    """The min-only reduction in the kernel's order against
    ``nn_min_only_plain``: equal values and equal NaN rows (a masked
    target's value is ``inf``)."""
    p, q = _mirror_case("NaN target" if case == "masked" else case)
    mask = None
    vals = pairwise_sqdist_exact(p, q)
    if case == "masked":
        mask = torch.ones(q.shape[0], dtype=torch.bool)
        mask[77] = False
        vals = torch.where(mask[None, :], vals, float("inf"))
    od = pr.nn_min_only_plain(p, q, mask)
    _, md = nn_forms_mirror(vals, "min", slice_len=slice_len)
    assert torch.equal(md.isnan(), od.isnan())
    fin = ~od.isnan()
    assert torch.equal(md[fin], od[fin])
    assert bool(od.isnan().any()) == (case in ("NaN target",
                                               "NaN source row"))


def test_mirror_ties_go_to_the_lowest_index_across_sub_tiles():
    """Equal values in two sub-tiles and two slices: the argmin and the
    packed key keep the first; a strictly lower value later wins."""
    vals = torch.full((3, 200), 5.0)
    vals[0, [40, 90, 150]] = 1.0
    vals[1, [40, 150]] = 1.0
    vals[1, 170] = 0.5
    vals[2, 7] = float("nan")
    vals[2, 8] = 2.0
    for reduce in ("argmin", "packed"):
        i, _ = nn_forms_mirror(vals, reduce, slice_len=64, idx_bits=8)
        assert i.tolist() == [40, 170, 8], reduce
