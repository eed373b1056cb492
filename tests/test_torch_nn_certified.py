"""The certified finish of the tensor-core K1 and K2 (``csrc/nn_tc.cu``),
on the CPU through its plain mirror ``ops.matching.nn_certified_plain``.

The mirror takes any approximate distance matrix, keeps the sweep's best
and runner-up key values, certifies a pick where the runner-up clears it by
the guard G, and rescans every other row exactly. Whatever the
approximation, as long as it lies within G of the difference form, its
output must equal the exact plain versions bit for bit:
``nn_argmin_plain(exact=True)`` (K1) and ``nn_argmin_packed_plain`` (K2),
and JAX's ``nn_argmin(exact=True)``. With G = 0 it must not. The bf16
split of the sweep (``ops.split.tc_split_operands``) must stay within G/4
of the float64 distance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fpcr_tpu as f
import fpcr_tpu_torch as ft
from fpcr_tpu_torch.ops.matching import (CERT_GUARD, TC_TILE,
                                         nn_argmin_packed_plain,
                                         nn_argmin_plain, nn_certified_plain,
                                         pair_guard, tc_centres)
from fpcr_tpu_torch.ops.split import tc_split_operands

SCALES = ["unit", "300", "hall"]


def _cloud(scale, seed, n=300, m=1200):
    """``(p, q)`` f32 numpy: uniform in ±1 or ±300, or a slice of the hall
    scan with the source a slightly moved copy of its points."""
    rng = np.random.default_rng(seed)
    if scale == "hall":
        hall = ft.load_hall_scan(device="cpu").numpy()
        q = hall[rng.choice(hall.shape[0], m, replace=False)]
        p = q[rng.choice(m, n, replace=False)] + rng.normal(
            scale=0.01, size=(n, 3))
        return p.astype(np.float32), q.astype(np.float32)
    r = 1.0 if scale == "unit" else 300.0
    q = rng.uniform(-r, r, (m, 3)).astype(np.float32)
    p = rng.uniform(-r, r, (n, 3)).astype(np.float32)
    return p, q


def _d64(p, q):
    p64, q64 = p.astype(np.float64), q.astype(np.float64)
    return ((p64[:, None, :] - q64[None, :, :]) ** 2).sum(-1)


def _noisy(d64, g, kind, seed=0):
    """The approximation: ``d64`` itself, uniform noise within ±G/2 of
    each pair's guard ``g``, or each row's best lifted and every other
    column lowered by G/2."""
    if kind == "exact":
        return d64
    if kind == "uniform":
        rng = np.random.default_rng(seed)
        return d64 + rng.uniform(-0.5, 0.5, d64.shape) * g
    rows = np.arange(d64.shape[0])
    best = d64.argmin(1)
    noise = -0.5 * g
    noise[rows, best] = 0.5 * g[rows, best]
    return d64 + noise


def _run(p, q, mask, d_approx, rule, bits=None, guard=CERT_GUARD):
    t = torch.as_tensor
    return nn_certified_plain(t(p), t(q), None if mask is None else t(mask),
                              t(d_approx.astype(np.float32)), guard,
                              rule=rule, idx_bits=bits)


def _plain(p, q, mask, rule, bits=None):
    t = torch.as_tensor
    tm = None if mask is None else t(mask)
    if rule == "packed":
        return nn_argmin_packed_plain(t(p), t(q), tm, idx_bits=bits)
    return nn_argmin_plain(t(p), t(q), tm, exact=True)


def _assert_bit_equal(got, want):
    gi, gd = got[0].numpy(), got[1].numpy()
    wi, wd = want[0].numpy(), want[1].numpy()
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gd.view(np.int32), wd.view(np.int32))


def _guard(p, q):
    """Each pair's guard f64[N, M], about the sweep's centres."""
    return pair_guard(torch.as_tensor(p), torch.as_tensor(q)).numpy()


@pytest.mark.parametrize("rule,bits", [("argmin", None), ("packed", 11),
                                       ("packed", 16)])
@pytest.mark.parametrize("kind", ["exact", "uniform", "adversarial"])
@pytest.mark.parametrize("scale", SCALES)
def test_certified_equals_exact_plain(scale, kind, rule, bits):
    p, q = _cloud(scale, seed=len(kind) + 7 * SCALES.index(scale))
    g = _guard(p, q)
    d = _noisy(_d64(p, q), g, kind)
    got = _run(p, q, None, d, rule, bits)
    _assert_bit_equal(got[:2], _plain(p, q, None, rule, bits))
    # the guard is not so wide that every row goes to the exact rescan
    assert float(got[2].float().mean()) < 0.9


@pytest.mark.parametrize("bits", [8, 10, 12, 14, 16])
def test_packed_index_bits(bits):
    p, q = _cloud("unit", seed=bits, n=200, m=min(1 << bits, 1000) - 3)
    g = _guard(p, q)
    d = _noisy(_d64(p, q), g, "adversarial")
    got = _run(p, q, None, d, "packed", bits)
    _assert_bit_equal(got[:2], _plain(p, q, None, "packed", bits))


def _duplicates(seed=3):
    """Targets with exact duplicates and near-duplicates, sources on and
    near them: exact ties and near ties everywhere."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-1, 1, (60, 3)).astype(np.float32)
    q = np.concatenate([base, base, base + 1e-5, base[::-1]])
    p = np.concatenate([base[:40], base[:40] + rng.normal(
        scale=1e-4, size=(40, 3)).astype(np.float32)])
    return p.astype(np.float32), q.astype(np.float32)


@pytest.mark.parametrize("rule,bits", [("argmin", None), ("packed", 9)])
@pytest.mark.parametrize("kind", ["exact", "uniform", "adversarial"])
def test_duplicates_and_ties(kind, rule, bits):
    p, q = _duplicates()
    g = _guard(p, q)
    got = _run(p, q, None, _noisy(_d64(p, q), g, kind), rule, bits)
    _assert_bit_equal(got[:2], _plain(p, q, None, rule, bits))
    assert bool(got[2][:40].all())  # a source on duplicates never certifies


@pytest.mark.parametrize("rule,bits", [("argmin", None), ("packed", 11)])
@pytest.mark.parametrize("keep", [0.0, 0.01, 0.5])
def test_masked_targets(keep, rule, bits):
    p, q = _cloud("unit", seed=11)
    mask = np.random.default_rng(12).uniform(size=q.shape[0]) < keep
    g = _guard(p, q)
    d = _noisy(_d64(p, q), g, "adversarial")
    got = _run(p, q, mask, d, rule, bits)
    want = _plain(p, q, mask, rule, bits)
    _assert_bit_equal(got[:2], want)
    if keep == 0.0:  # no valid target: idx 0 and inf, every row rescued
        assert (got[0] == 0).all() and torch.isinf(got[1]).all()
        assert bool(got[2].all())
    else:
        assert mask[got[0].numpy()].all()


@pytest.mark.parametrize("rule,bits", [("argmin", None), ("packed", 11)])
def test_negative_approximations(rule, bits):
    """Sources on targets: the approximation of a zero distance is
    negative, and so are some runners-up; keys of negative values order
    below every positive one and such rows never certify wrongly."""
    p, q = _cloud("unit", seed=21)
    p = np.concatenate([q[:150], p[:150]])
    g = _guard(p, q)
    d = _d64(p, q) - 0.5 * g
    assert (d < 0).any()
    got = _run(p, q, None, d, rule, bits)
    _assert_bit_equal(got[:2], _plain(p, q, None, rule, bits))


@pytest.mark.parametrize("rule,bits", [("argmin", None), ("packed", 11)])
def test_guard_zero_mutation_fails(rule, bits):
    """With the guard set to 0, the adversarial approximation makes the
    certificate accept a wrong pick: the guard is what keeps it exact."""
    # targets in near-identical pairs, sources a little off them: two
    # candidates within G/2 at distances well above G, which the
    # adversarial noise swaps
    rng = np.random.default_rng(4)
    base = rng.uniform(-1, 1, (200, 3))
    q = np.concatenate([base, base[:100] + rng.normal(scale=1e-6,
                                                      size=(100, 3))])
    p = base[:100] + rng.normal(scale=0.03, size=(100, 3))
    p, q = p.astype(np.float32), q.astype(np.float32)
    g = _guard(p, q)
    d = _noisy(_d64(p, q), g, "adversarial")
    want = _plain(p, q, None, rule, bits)
    good = _run(p, q, None, d, rule, bits)
    _assert_bit_equal(good[:2], want)
    bad = _run(p, q, None, d, rule, bits, guard=0.0)
    assert not torch.equal(bad[0], want[0])


@pytest.mark.parametrize("scale", SCALES)
def test_split_truncation_within_quarter_guard(scale):
    """The sweep's 24 bf16 slots, their products summed in float64 (what
    the tensor cores would give without their own rounding), stay within
    G/4 of the float64 distance."""
    p, q = _cloud(scale, seed=31, n=128)  # one block of the sweep
    a, b = tc_split_operands(torch.as_tensor(p), torch.as_tensor(q))
    approx = a.double() @ b.double().T
    err = np.abs(approx.numpy() - _d64(p, q))
    g = _guard(p, q)
    assert (err <= g / 4).all(), float((err / g).max())


def test_split_surrogate_masks_a_target():
    p, q = _cloud("unit", seed=41, n=20, m=50)
    mask = np.ones(50, bool)
    mask[::3] = False
    a, b = tc_split_operands(torch.as_tensor(p), torch.as_tensor(q),
                             torch.as_tensor(mask))
    approx = (a.double() @ b.double().T).numpy()
    assert (approx[:, ~mask] > 1e29).all()
    assert np.isfinite(approx).all()


def test_certified_split_matches_jax_exact():
    """The mirror fed the sweep's own split approximation (rounded to f32
    as the tensor cores' sum is) against JAX's exact matcher on the same
    numpy inputs."""
    p, q = _cloud("unit", seed=51, n=128, m=700)
    a, b = tc_split_operands(torch.as_tensor(p), torch.as_tensor(q))
    d = (a.double() @ b.double().T).numpy()
    ti, td, rescued = _run(p, q, None, d, "argmin")
    ji, jd = f.ops.matching.nn_argmin(jnp.asarray(p), jnp.asarray(q),
                                      exact=True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-7)
    assert float(rescued.float().mean()) < 0.1


def test_key_and_rule_checks():
    p, q = _cloud("unit", seed=61, n=4, m=8)
    d = torch.as_tensor(_d64(p, q).astype(np.float32))
    with pytest.raises(ValueError, match="rule"):
        nn_certified_plain(torch.as_tensor(p), torch.as_tensor(q), None, d,
                           0.0, rule="min")
    with pytest.raises(ValueError, match="index bits"):
        nn_certified_plain(torch.as_tensor(p), torch.as_tensor(q), None, d,
                           0.0, rule="packed", idx_bits=2)
    assert TC_TILE == 128


def test_centres_are_block_means():
    p = torch.as_tensor(np.random.default_rng(71).uniform(
        -1, 1, (300, 3)).astype(np.float32))
    c = tc_centres(p)
    assert torch.allclose(c[0], p[:128].mean(0), atol=1e-6)
    assert torch.allclose(c[299], p[256:].mean(0), atol=1e-6)
    assert torch.equal(c[128], c[255])
