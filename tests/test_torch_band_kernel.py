"""What kernels K3 and K3p (``csrc/morton.cu``) compute in Python, on the
CPU, against ``band_bases``, the plain band scans and the JAX package.

* The prologue: ``ops.morton.prologue_bases``, the scalar mirror of the
  block prologue (probe code, 32-ary lower-bound search, clip, align),
  equals ``band_bases`` and the bases the JAX package computes before its
  kernel (``fpcr_tpu/ops/morton_pallas.py:415-420``).
* The cull rule: a mirror of the kernel's culled scan (32-row source
  groups, a seed sub-tile per staged tile, the running bound, the box-gap
  lower bound with no margin, K3p's bucket compare) picks exactly what
  ``morton_nn_band_plain`` and ``morton_nn_band_packed_plain`` pick.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fpcr_tpu_torch as ft
from fpcr_tpu.ops import morton as jm
from fpcr_tpu_torch.ops import morton as tm
from fpcr_tpu_torch.ops.matching import PACKED_KEY_INIT
from fpcr_tpu_torch.ops.morton_cuda import (BAND_SUB, BAND_TILE,
                                            band_visit_totals)

torch.set_num_threads(2)

NEAR_GT = ((0.004, -0.002, 0.003), (0.002, -0.003, 0.002))
HALL_NEAR_GT = ((0.002, -0.003, 0.001), (0.001, -0.002, 0.002))


def _uniform(seed, m=3000, n=2500):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-2, 2, (m, 3)).astype(np.float32)
    p = (q[rng.integers(0, m, n)]
         + rng.normal(scale=0.002, size=(n, 3))).astype(np.float32)
    return p, q


def _duplicates(seed):
    """Eight targets repeated 70 times each (sorted together, so equal
    distances span three 32-row sub-tiles, the seed's among them) in a
    uniform cloud, and sources near them and elsewhere."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(-2, 2, (3000, 3)).astype(np.float32)
    dup = q[rng.integers(0, 3000, 8)]
    q = np.concatenate([q, np.repeat(dup, 70, axis=0)])
    p = np.concatenate([np.repeat(dup, 40, axis=0)
                        + rng.normal(scale=0.01, size=(320, 3)),
                        q[rng.integers(0, 3000, 900)]]).astype(np.float32)
    return p, q


def _case(name):
    """``(p f32[n,3] numpy, q f32[m,3] numpy, mask or None, shift, chunk,
    window)``."""
    if name == "grid-near-gt":
        s = ft.transformed_scene(ft.surface_grid(96, device="cpu"), *NEAR_GT)
        return s.source.numpy(), s.target.numpy(), None, 0.0, 512, 64
    if name == "hall-near-gt":
        s = ft.transformed_scene(ft.load_hall_scan(device="cpu"),
                                 *HALL_NEAR_GT)
        return s.source.numpy(), s.target.numpy(), None, 0.0, 512, 64
    if name == "far-pose":
        s = ft.transformed_scene(ft.surface_grid(64, device="cpu"),
                                 (0.3, -0.2, 0.25), (0.4, -0.3, 0.2))
        return s.source.numpy(), s.target.numpy(), None, 0.0, 512, 64
    if name == "duplicates":
        return (*_duplicates(5), None, 0.0, 256, 256)
    if name == "masked":
        p, q = _uniform(6)
        return p, q, np.arange(3000) < 2200, 0.0, 256, 256
    if name == "shifted":
        p, q = _uniform(7)
        return p, q, None, 0.5, 512, 64
    if name == "tail-chunk":
        p, q = _uniform(8, n=1000)
        return p, q, None, 0.0, 512, 64
    if name == "m<band":
        p, q = _uniform(9, m=500, n=300)
        return p, q, None, 0.0, 256, 256
    if name == "probe-outside-box":
        p, q = _uniform(10)
        return ((p + np.float32([3.0, 0.0, -2.5])).astype(np.float32), q,
                None, 0.0, 512, 64)
    if name == "two-tiles":  # band 1,792: two staged tiles
        p, q = _uniform(11, m=5000, n=4000)
        return p, q, None, 0.0, 1000, 300
    raise KeyError(name)


def _tables(p, q, mask, shift):
    """The port's table and the sorted source, and the JAX package's table
    of the same target."""
    tt = tm.build_morton_table(torch.as_tensor(q),
                               None if mask is None else torch.as_tensor(mask),
                               shift=shift)
    jt = jm.build_morton_table(jnp.asarray(q),
                               None if mask is None else jnp.asarray(mask),
                               shift=shift)
    ps = torch.as_tensor(p)
    return ps[tm.source_morton_order(ps, tt).long()].contiguous(), tt, jt


def _jax_bases(p, jt, chunk, window):
    """The bases as ``morton_nn_pallas`` computes them
    (``fpcr_tpu/ops/morton_pallas.py:415-420``)."""
    band = tm.band_rows(chunk, window)
    n, m = p.shape[0], jt.points_sorted.shape[0]
    chunks = math.ceil(n / chunk)
    padded = np.concatenate([p, np.repeat(p[-1:], chunks * chunk - n, 0)])
    probe = jnp.asarray(padded.reshape(chunks, chunk, 3)[:, chunk // 2])
    codes = jm.morton_codes(probe, jt.lo, jt.inv_extent)
    ranks = jnp.searchsorted(jt.codes_sorted, codes).astype(jnp.int32)
    m_pad = tm.round_up(m, tm.BAND_ALIGN) + band
    return np.asarray(jnp.clip(ranks - band // 2, 0, m_pad - band)
                      & ~jnp.int32(tm.BAND_ALIGN - 1))


@pytest.mark.parametrize("name", ["grid-near-gt", "tail-chunk", "masked",
                                  "shifted", "m<band", "probe-outside-box",
                                  "two-tiles"])
def test_prologue_mirror_equals_band_bases_and_jax(name):
    p, q, mask, shift, chunk, window = _case(name)
    ps, tt, jt = _tables(p, q, mask, shift)
    band, bases = tm.band_bases(ps, tt, chunk, window)
    band_m, mirror = tm.prologue_bases(ps, tt, chunk, window)
    assert band_m == band and mirror.dtype == np.int32
    np.testing.assert_array_equal(mirror, bases.numpy())
    np.testing.assert_array_equal(mirror, _jax_bases(ps.numpy(), jt, chunk,
                                                     window))
    assert (mirror % tm.BAND_ALIGN == 0).all()
    assert (mirror <= tm.round_up(q.shape[0], tm.BAND_ALIGN)).all()


@pytest.mark.parametrize("m", [1, 2, 31, 32, 33, 1000, 1024, 1025])
def test_lower_bound_32_equals_searchsorted(m):
    rng = np.random.default_rng(m)
    codes = np.sort(rng.integers(0, 50, m)).astype(np.int32)
    for code in range(-1, 52):
        want = int(np.searchsorted(codes, code, side="left"))
        assert tm._lower_bound_32(codes, code) == want


def _sqdist(pg, qs, valid):
    """``_band_blocks``' exact-form distances [g, 32, s], +inf where the
    band row is not valid."""
    d = None
    for a in range(3):
        da = pg[:, :, None, a] - qs[:, None, :, a]
        d = da * da if d is None else d + da * da
    return torch.where(valid[:, None, :], d, torch.full_like(d, math.inf))


def _bits(x):
    return x.contiguous().view(torch.int32)


def _culled_scan(p, table, chunk, window, packed):
    """The kernel's culled scan in plain torch: ``(idx int32[n], sqdist
    f32[n] or None for K3p, visits)``."""
    band, bases = tm.band_bases(p, table, chunk, window)
    ranks = tm.probe_ranks(p, table, chunk)
    q = table.points_sorted
    n, m = p.shape[0], q.shape[0]
    valid_end = min(int(table.valid_count), m)
    starts = [(c, s) for c in range(bases.shape[0])
              for s in range(c * chunk, min(n, (c + 1) * chunk), BAND_SUB)]
    g_chunk = torch.tensor([c for c, _ in starts])
    g_start = torch.tensor([s for _, s in starts])
    row_end = torch.clamp((g_chunk + 1) * chunk, max=n)
    rows = torch.minimum(g_start[:, None] + torch.arange(BAND_SUB),
                         row_end[:, None] - 1)
    pg = p[rows]  # [G, 32, 3]; rows past the chunk repeat its last row
    glo, ghi = pg.amin(1), pg.amax(1)
    brow = bases.long()[:, None] + torch.arange(band)
    valid = brow < valid_end
    qb = q[torch.clamp(brow, max=m - 1)]  # [C, band, 3]
    keep = -(1 << tm.band_idx_bits(band)) if packed else -1
    inf = torch.full((len(starts), BAND_SUB), math.inf)
    best_d, seed = inf.clone(), inf.clone()
    best_s = torch.full((len(starts), BAND_SUB),
                        PACKED_KEY_INIT if packed else -1, dtype=torch.int32)
    # the expected band row of each group's middle row
    expect = ((ranks - bases.long() - chunk // 2)[g_chunk]
              + g_start - g_chunk * chunk + BAND_SUB // 2)
    visits = 0
    for t0 in range(0, band, BAND_TILE):
        count = min(BAND_TILE, band - t0)
        s0 = t0 + torch.clamp(expect - t0, 0, count - 1) // BAND_SUB * BAND_SUB
        sr = s0[:, None] + torch.arange(BAND_SUB)
        inside = sr < t0 + count
        sr = torch.clamp(sr, max=band - 1)
        d = _sqdist(pg, qb[g_chunk[:, None], sr],
                    valid[g_chunk[:, None], sr] & inside)
        seed = torch.minimum(seed, d.amin(-1))
        for a in range(t0, t0 + count, BAND_SUB):
            b = min(a + BAND_SUB, t0 + count)
            qt, vt = qb[:, a:b], valid[:, a:b]
            t_lo = torch.where(vt[..., None], qt, math.inf).amin(1)[g_chunk]
            t_hi = torch.where(vt[..., None], qt, -math.inf).amax(1)[g_chunk]
            gap = torch.clamp(torch.maximum(glo - t_hi, t_lo - ghi), min=0.0)
            lb = gap[:, 0] * gap[:, 0] + gap[:, 1] * gap[:, 1] \
                + gap[:, 2] * gap[:, 2]
            own = (torch.minimum(_bits(seed), best_s) if packed
                   else _bits(torch.minimum(seed, best_d)))
            bound = own.amax(1) & keep
            skip = ~vt.any(1)[g_chunk] | ((_bits(lb) & keep) > bound)
            gi = torch.nonzero(~skip)[:, 0]
            visits += gi.numel()
            if not gi.numel():
                continue
            d = _sqdist(pg[gi], qt[g_chunk[gi]], vt[g_chunk[gi]])
            if packed:
                key = (_bits(d) & keep) | torch.arange(a, b,
                                                       dtype=torch.int32)
                best_s[gi] = torch.minimum(best_s[gi], key.amin(-1))
            else:
                dmin, arg = torch.min(d, dim=-1)  # first minimum
                better = dmin < best_d[gi]  # strict: the first stays
                best_d[gi] = torch.where(better, dmin, best_d[gi])
                best_s[gi] = torch.where(better, (a + arg).to(torch.int32),
                                         best_s[gi])
    base = bases.long()[g_chunk][:, None]
    if packed:
        none = best_s == PACKED_KEY_INIT
        j = torch.clamp(base + (best_s & ~keep).long(), max=m - 1)
    else:
        none = best_s < 0
        j = base + best_s.long()
    j = torch.where(none, 0, j)
    own_row = g_start[:, None] + torch.arange(BAND_SUB) < row_end[:, None]
    out_rows = (g_start[:, None] + torch.arange(BAND_SUB))[own_row]
    idx = torch.empty(n, dtype=torch.int32)
    idx[out_rows] = j[own_row].to(torch.int32)
    if packed:
        return idx, None, visits
    dist = torch.empty(n)
    dist[out_rows] = best_d[own_row]
    return idx, dist, visits


@pytest.mark.parametrize("packed", [False, True], ids=["K3", "K3p"])
@pytest.mark.parametrize("name", ["grid-near-gt", "hall-near-gt", "far-pose",
                                  "duplicates", "masked", "shifted",
                                  "tail-chunk", "probe-outside-box",
                                  "two-tiles"])
def test_cull_rule_keeps_every_pick(name, packed):
    p, q, mask, shift, chunk, window = _case(name)
    ps, tt, _ = _tables(p, q, mask, shift)
    plain = (tm.morton_nn_band_packed_plain if packed
             else tm.morton_nn_band_plain)
    _, od, oi, _ = plain(ps, tt, chunk=chunk, window=window)
    idx, dist, visits = _culled_scan(ps, tt, chunk, window, packed)
    assert torch.equal(idx, oi)
    if not packed:
        assert torch.equal(dist, od)
    total, _ = band_visit_totals(ps.shape[0], chunk,
                                 tm.band_rows(chunk, window))
    assert 0 < visits <= total
    if name in ("grid-near-gt", "hall-near-gt"):
        assert visits / total < 0.7, visits / total  # the culling works
    if name == "duplicates":
        # picks whose equal copies reach into a later sub-tile: the first
        # copy must win over a seed bound taken at an equal distance
        qs = tt.points_sorted
        same = (qs[oi.long()][:, None, :] == qs[None]).all(-1)
        last = torch.where(same, torch.arange(qs.shape[0]), -1).amax(1)
        assert int((last // BAND_SUB > oi.long() // BAND_SUB).sum()) > 100


@pytest.mark.parametrize("n,chunk,band,want", [
    (1000, 512, 768, (32 * 24, 32)),  # a tail chunk of 488 rows: 16 groups
    (100, 256, 896, (4 * 28, 4)),
    (4000, 1000, 1792, (128 * 56, 128 * 2)),  # two tiles: two seeds a group
])
def test_band_visit_totals(n, chunk, band, want):
    assert band_visit_totals(n, chunk, band) == want


if __name__ == "__main__":  # the mirror's culled share on every case
    for case in ("grid-near-gt", "hall-near-gt", "far-pose", "duplicates",
                 "masked", "shifted", "tail-chunk", "probe-outside-box",
                 "two-tiles"):
        p, q, mask, shift, chunk, window = _case(case)
        ps, tt, _ = _tables(p, q, mask, shift)
        total, _ = band_visit_totals(ps.shape[0], chunk,
                                     tm.band_rows(chunk, window))
        shares = [1 - _culled_scan(ps, tt, chunk, window, k)[2] / total
                  for k in (False, True)]
        print(f"{case} c{chunk}/w{window}: (group, sub-tile) visits culled "
              f"K3 {shares[0]:.3f}, K3p {shares[1]:.3f}")
