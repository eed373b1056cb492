"""The batched pieces of ``register_batch`` against ``fpcr_tpu`` and against
their own per-element calls, on the same seeded numpy inputs (CPU):

* the stacked Morton table, the sources' orders and band bases against
  per-element builds and the JAX package's ``vmap``;
* the batched plain versions of kernels K3 and K3p against
  ``jax.vmap(morton_nn_pallas)`` in interpret mode (B = 3, mixed
  ``valid_count``, one element whose band holds no valid target), and bit
  for bit against B unbatched calls, the XLA geometry too;
* the batched normals prepass, the grid (cell sizes, voxel tables,
  ``grid_nn``), the morton rescue and GICP's normal equations and solve
  against their per-element calls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpcr_tpu.ops import morton as jm
from fpcr_tpu.ops import normals as jn
from fpcr_tpu.ops.morton_pallas import morton_nn_pallas
import fpcr_tpu_torch as ft
from fpcr_tpu_torch.models import icp as ticp
from fpcr_tpu_torch.ops import gicp as tg
from fpcr_tpu_torch.ops import grid as tgrid
from fpcr_tpu_torch.ops import morton as tm
from fpcr_tpu_torch.ops import normals as tn
from fpcr_tpu_torch.ops.morton_cuda import (morton_nn_cuda,
                                            morton_nn_packed_cuda)

torch.set_num_threads(2)

B = 3
NEAR_TIE = 1e-5  # an index may differ only between picks this close


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _clouds(seed, n=512, m=700):
    """B targets ~ U(-2, 2)^3 and sources near them, each element its own
    draw; masks: all valid, a valid head of 450 rows, none valid."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(-2, 2, (B, m, 3)).astype(np.float32)
    p = np.stack([q[b, rng.permutation(m)[:n]] for b in range(B)])
    p = (p + rng.normal(scale=0.003, size=p.shape)).astype(np.float32)
    mask = np.ones((B, m), bool)
    mask[1, 450:] = False
    mask[2] = False
    return p, q, mask


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _assert_same(got, want, what):
    assert (got is None) == (want is None), what
    if got is not None:
        assert got.shape == want.shape and got.dtype == want.dtype, what
        assert torch.equal(_bits(got), _bits(want)), what


def _jax_tables(q, mask, shift):
    return jax.vmap(lambda a, b: jm.build_morton_table(a, b, shift=shift))(
        jnp.asarray(q), jnp.asarray(mask))


@pytest.mark.parametrize("shift", [0.0, 0.5])
@pytest.mark.parametrize("masked", [False, True])
def test_stacked_table_equals_per_element_builds(masked, shift):
    """``build_morton_table`` of ``[B, M, 3]``: every field of element b bit
    for bit its own build's, ``valid_count`` int32[B]; the codes, order and
    bounds equal ``jax.vmap(build_morton_table)``'s (the bounds where an
    element has a valid row)."""
    _, q, mask = _clouds(1)
    tmask = _t(mask) if masked else None
    stacked = tm.build_morton_table(_t(q), tmask, shift=shift)
    assert stacked.valid_count.shape == (B,)
    assert stacked.valid_count.dtype == torch.int32
    for b in range(B):
        own = tm.build_morton_table(_t(q[b]), None if tmask is None
                                    else tmask[b], shift=shift)
        for name, got, want in zip(tm.MortonTable._fields,
                                   tm.table_element(stacked, b), own):
            _assert_same(got, want, f"{name}[{b}]")
    jt = _jax_tables(q, mask if masked else np.ones_like(mask), shift)
    for name in ("codes_sorted", "orig_index", "valid_count"):
        np.testing.assert_array_equal(getattr(stacked, name).numpy(),
                                      np.asarray(getattr(jt, name)), name)
    # the bounds of an element with no valid row are inf here and NaN in
    # the JAX package; no band row of it is ever valid in either
    some = mask.any(1) if masked else np.ones(B, bool)
    for name in ("points_sorted", "lo", "inv_extent"):
        np.testing.assert_array_equal(getattr(stacked, name).numpy()[some],
                                      np.asarray(getattr(jt, name))[some],
                                      name)


def test_batched_orders_and_bases_equal_per_element():
    """``source_morton_order``, ``probe_ranks``, ``band_bases`` and the
    prologue's mirror ``prologue_bases`` of a batch: each element its own
    call's, the orders equal JAX's ``vmap``."""
    p, q, mask = _clouds(2)
    table = tm.build_morton_table(_t(q), _t(mask))
    order = tm.source_morton_order(_t(p), table)
    jt = _jax_tables(q, mask, 0.0)
    np.testing.assert_array_equal(order.numpy(), np.asarray(
        jax.vmap(jm.source_morton_order)(jnp.asarray(p), jt)))
    ps = torch.take_along_dim(_t(p), order.long()[..., None], dim=1)
    band, bases = tm.band_bases(ps, table, 64, 64)
    _, mirror = tm.prologue_bases(ps, table, 64, 64)
    np.testing.assert_array_equal(mirror, bases.numpy())
    for b in range(B):
        own = tm.table_element(table, b)
        assert torch.equal(order[b], tm.source_morton_order(_t(p[b]), own))
        assert torch.equal(tm.probe_ranks(ps, table, 64)[b],
                           tm.probe_ranks(ps[b], own, 64))
        assert torch.equal(bases[b], tm.band_bases(ps[b], own, 64, 64)[1])
    assert band == tm.band_rows(64, 64)


def _sorted_batch(seed, shift=0.0):
    p, q, mask = _clouds(seed)
    table = tm.build_morton_table(_t(q), _t(mask), shift=shift)
    order = tm.source_morton_order(_t(p), table).long()
    ps = torch.take_along_dim(_t(p), order[..., None], dim=1).contiguous()
    extra = (table.points_sorted * 0.5 + 0.25).contiguous()
    return ps, table, extra, mask


@pytest.mark.parametrize("mode", ["highest", "packed6_idx"])
def test_batched_band_plain_matches_vmapped_tpu_kernel(mode):
    """``morton_nn_band`` on a CPU batch (K3's or K3p's plain version)
    against ``jax.vmap(morton_nn_pallas)`` in interpret mode on the JAX
    package's stacked table, chunk 64 / window 64 at 512 points: the same
    picks up to near-ties (K3; the TPU kernel's expansion form) or >= 99%
    of them (K3p), matched points and extras the table rows, masked rows
    never picked; the element whose band holds no valid target gets idx
    0, ``inf`` and table row 0, where the TPU kernel keeps its ~1e30
    surrogate."""
    p, q, mask = _clouds(3)
    jt = _jax_tables(q, mask, 0.0)
    ps = np.take_along_axis(p, np.asarray(jax.vmap(jm.source_morton_order)(
        jnp.asarray(p), jt))[..., None], axis=1)
    extra = (np.asarray(jt.points_sorted) * 0.5 + 0.25).astype(np.float32)
    j = jax.vmap(lambda a, t, e: morton_nn_pallas(
        a, t, e, chunk=64, window=64, mode=mode, interpret=True))(
            jnp.asarray(ps), jt, jnp.asarray(extra))
    table = tm.build_morton_table(_t(q), _t(mask))
    before = (morton_nn_cuda.launches, morton_nn_packed_cuda.launches)
    t = tm.morton_nn_band(_t(ps), table, _t(extra), chunk=64, window=64,
                          mode=mode)
    assert (morton_nn_cuda.launches,
            morton_nn_packed_cuda.launches) == before  # the plain version
    assert t[0].shape == (B, 512, 3) and t[2].dtype == torch.int32
    q_sorted = np.asarray(jt.points_sorted)
    for b in range(B):
        ti, jd = t[2][b].numpy(), np.asarray(j[1])[b]
        np.testing.assert_array_equal(t[0][b].numpy(), q_sorted[b][ti])
        np.testing.assert_array_equal(t[3][b].numpy(), extra[b][ti])
        if not mask[b].any():
            assert torch.isinf(t[1][b]).all() and (ti == 0).all()
            assert (jd > 1e29).all()
            continue
        assert (ti < mask[b].sum()).all()
        ji = np.asarray(j[2])[b]
        if mode == "packed6_idx":
            assert (ti == ji).mean() >= 0.99
            np.testing.assert_allclose(t[1][b].numpy(), jd, rtol=3e-4,
                                       atol=2e-5)
            continue
        diff = np.nonzero(ti != ji)[0]
        p64 = ps[b].astype(np.float64)[diff]
        q64 = q_sorted[b].astype(np.float64)
        np.testing.assert_allclose(((p64 - q64[ti[diff]]) ** 2).sum(1),
                                   ((p64 - q64[ji[diff]]) ** 2).sum(1),
                                   rtol=NEAR_TIE, atol=1e-9)
        assert diff.size <= 0.01 * ti.size
        np.testing.assert_allclose(t[1][b].numpy(), jd, atol=2e-5)


@pytest.mark.parametrize("extra", [False, True])
@pytest.mark.parametrize("fn", ["morton_nn_band_plain",
                                "morton_nn_band_packed_plain", "morton_nn"])
def test_batched_band_equals_per_element_calls(fn, extra):
    """Each element of a batched call (K3's and K3p's plain versions, the
    XLA geometry) equals its own call on its own table, all four outputs
    bit for bit, on a half-cell-shifted table, B = 1 included."""
    ps, table, ex, _ = _sorted_batch(4, shift=0.5)
    call = getattr(tm, fn)
    for sel in (slice(0, 1), slice(0, B)):
        sub = tm.MortonTable(*(f[sel] for f in table))
        out = call(ps[sel], sub, ex[sel] if extra else None, chunk=64,
                   window=64)
        for b in range(sub.valid_count.shape[0]):
            own = call(ps[sel][b], tm.table_element(sub, b),
                       ex[sel][b] if extra else None, chunk=64, window=64)
            for k, (got, want) in enumerate(zip(out, own)):
                _assert_same(None if got is None else got[b], want,
                             f"{fn} output {k} element {b}")


def test_batched_rescue_equals_per_element():
    """The morton rescue of a batch (one batched exact NN call) re-matches
    each element's own worst rows, bit for bit its own call's."""
    ps, table, _, mask = _sorted_batch(5)
    targets = torch.take_along_dim(table.points_sorted, torch.argsort(
        table.orig_index.long(), dim=1)[..., None], dim=1)
    cfg = ft.ICPConfig(matcher="morton", morton_rescue=40,
                       exact_distances=True)
    tmask = _t(mask)
    q_m, d, _, n_m = tm.morton_nn_band_plain(ps, table, targets, chunk=64,
                                             window=64)
    out = ticp._exact_rescue(ps, targets, tmask, targets, q_m, n_m, d, cfg,
                             None)
    for b in range(B):
        own = ticp._exact_rescue(ps[b], targets[b], tmask[b], targets[b],
                                 q_m[b], n_m[b], d[b], cfg, None)
        for k, (got, want) in enumerate(zip(out, own)):
            _assert_same(got[b], want, f"rescue output {k} element {b}")
    assert (out[2][0] <= d[0]).all()


@pytest.mark.parametrize("case", ["streaming", "exact", "masked", "banded"])
def test_batched_normals_equal_per_element(case):
    """``estimate_normals`` of ``[B, M, 3]``: one pass of the same tiles,
    each element's normals bit for bit its own call's (the banded search
    above ``banded_threshold`` element by element); the streaming ones
    within float32 grade of the JAX package's ``vmap``."""
    rng = np.random.default_rng(6)
    xy = rng.uniform(-1, 1, (B, 900, 2))
    q = np.concatenate([xy, 0.3 * np.sin(2 * xy[..., :1]) * xy[..., 1:]],
                       -1).astype(np.float32)
    mask = np.ones((B, 900), bool)
    mask[1, ::4] = False
    kw = dict(chunk=256, tile=300, exact=case == "exact")
    tmask = _t(mask) if case == "masked" else None
    if case == "banded":
        kw["banded_threshold"] = 500
    got = tn.estimate_normals(_t(q), 5, tmask, **kw)
    assert got.shape == (B, 900, 3)
    for b in range(B):
        want = tn.estimate_normals(_t(q[b]), 5, None if tmask is None
                                   else tmask[b], **kw)
        _assert_same(got[b], want, f"normals element {b}")
    if case == "streaming":
        jnrm = np.asarray(jax.vmap(lambda c: jn.estimate_normals(c, k=5))(
            jnp.asarray(q)))
        dots = np.abs((got.numpy() * jnrm).sum(-1))
        assert (dots > 1 - 1e-4).mean() >= 0.99


def test_batched_grid_equals_per_element():
    """``suggest_cell_size``, ``build_voxel_table`` and ``grid_nn`` of a
    batch: each element's cell size, table and matches bit for bit its own
    calls', a chunk holding a few queries of every element."""
    p, q, mask = _clouds(7)
    cell = tgrid.suggest_cell_size(_t(q))
    assert cell.shape == (B,)
    table = tgrid.build_voxel_table(_t(q), cell, table_bits=12,
                                    q_mask=_t(mask))
    out = tgrid.grid_nn(_t(p), table, cap=8, chunk=300)
    for b in range(B):
        h = tgrid.suggest_cell_size(_t(q[b]))
        _assert_same(cell[b], h, f"cell size {b}")
        own = tgrid.build_voxel_table(_t(q[b]), h, table_bits=12,
                                      q_mask=_t(mask[b]))
        for name, got, want in zip(tgrid.VoxelTable._fields, table, own):
            if name != "table_bits":
                _assert_same(got[b], want, f"{name}[{b}]")
        for k, (got, want) in enumerate(zip(out, tgrid.grid_nn(
                _t(p[b]), own, cap=8))):
            _assert_same(got[b], want, f"grid_nn output {k} element {b}")
    assert not out[2][2].any()  # no valid target in element 2


def test_batched_gicp_equals_per_element():
    """GICP's Woodbury normal equations and 6x6 solve along the batch axis:
    each element's H and g within float32 noise of its own call's, and its
    update within 1e-6."""
    rng = np.random.default_rng(8)
    p = _t(rng.normal(size=(B, 400, 3)).astype(np.float32))
    q = p + _t(0.02 * rng.normal(size=(B, 400, 3)).astype(np.float32))
    na = torch.nn.functional.normalize(
        _t(rng.normal(size=(B, 400, 3)).astype(np.float32)), dim=-1)
    nb = torch.nn.functional.normalize(
        na + _t(0.1 * rng.normal(size=(B, 400, 3)).astype(np.float32)),
        dim=-1)
    w = _t(rng.uniform(size=(B, 400)).astype(np.float32))
    for mask in (None, w, w > 0.3):
        H, g = tg.gicp_normal_equations(p, q, na, nb, mask, epsilon=1e-3)
        inc = tg.gicp_transform(p, q, na, nb, mask, epsilon=1e-3)
        assert H.shape == (B, 6, 6) and g.shape == (B, 6)
        for b in range(B):
            m_b = None if mask is None else mask[b]
            Hb, gb = tg.gicp_normal_equations(p[b], q[b], na[b], nb[b], m_b,
                                              epsilon=1e-3)
            torch.testing.assert_close(H[b], Hb, rtol=1e-5, atol=1e-4)
            torch.testing.assert_close(g[b], gb, rtol=1e-5, atol=1e-5)
            own = tg.gicp_transform(p[b], q[b], na[b], nb[b], m_b,
                                    epsilon=1e-3)
            torch.testing.assert_close(inc.rotation[b], own.rotation,
                                       rtol=0, atol=1e-6)
            torch.testing.assert_close(inc.translation[b], own.translation,
                                       rtol=0, atol=1e-6)
