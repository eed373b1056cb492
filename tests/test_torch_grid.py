"""The port's voxel-hash grid (``fpcr_tpu_torch/ops/grid.py`` and
``matcher='grid'``) against ``fpcr_tpu``'s on the same numpy inputs (CPU):
the table, the fixed-radius matcher bit for bit, voxel downsampling, grid
ICP, and the candidate limit, where the port and the JAX package differ."""

import collections
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fpcr_tpu as f
import fpcr_tpu_torch as ft
from fpcr_tpu.models.icp import resolve_matcher as j_resolve
from fpcr_tpu.ops import grid as jgrid
from fpcr_tpu_torch.models.icp import build_matcher_state, resolve_matcher
from fpcr_tpu_torch.ops import grid as tgrid

torch.set_num_threads(2)

GAP = 1e-5  # transform RMSE between the two packages' results


def _t(a):
    return torch.as_tensor(np.array(a))


def _cloud(kind):
    """``(points f32[N, 3], cell size, target mask or None)``."""
    rng = np.random.default_rng(len(kind))
    if kind == "uniform":
        return rng.uniform(-2, 2, (3000, 3)).astype(np.float32), 0.15, None
    if kind == "negative":  # every cell negative
        return rng.uniform(-9, -1, (3000, 3)).astype(np.float32), 0.4, None
    if kind == "large":  # cells ~1e5-1e6: the int32 hash products wrap
        pts = rng.uniform(-1, 1, (3000, 3)) + np.array([3e3, -7e3, 5e3])
        return pts.astype(np.float32), 0.01, None
    if kind == "masked":
        mask = rng.uniform(size=3000) < 0.7
        return rng.uniform(-2, 2, (3000, 3)).astype(np.float32), 0.15, mask
    dup = np.repeat(rng.uniform(-1, 1, (50, 3)), 20, axis=0)  # duplicates
    return dup.astype(np.float32), 0.1, None


CLOUDS = ["uniform", "negative", "large", "masked", "duplicates"]


@pytest.mark.parametrize("bits", [8, 20])
@pytest.mark.parametrize("kind", CLOUDS)
def test_build_voxel_table_matches_jax(kind, bits):
    q, h, mask = _cloud(kind)
    tj = jgrid.build_voxel_table(jnp.asarray(q), h, table_bits=bits,
                                 q_mask=None if mask is None
                                 else jnp.asarray(mask))
    tt = tgrid.build_voxel_table(_t(q), h, table_bits=bits,
                                 q_mask=None if mask is None else _t(mask))
    for name in ("orig_index", "starts", "counts", "points_sorted"):
        got, want = getattr(tt, name).numpy(), np.asarray(getattr(tj, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert float(tt.cell_size) == float(tj.cell_size)
    assert tt.table_bits == bits


@pytest.mark.parametrize("bits", [6, 20])
def test_hash_equals_jax_on_wrapping_cells(bits):
    """The int64 hash masked to ``table_bits`` equals JAX's wrapping int32
    hash, negative cells and products past 2^31 included."""
    rng = np.random.default_rng(9)
    cells = rng.integers(-2 ** 30, 2 ** 30, (4000, 3)).astype(np.int32)
    big = 2 ** 31 - 1
    cells[:8] = [[-1, -1, -1], [0, 0, 0], [big, 0, -big - 1], [1, 1, 1],
                 [-big - 1] * 3, [29, -30, 31], [-7, 0, 7], [big] * 3]
    np.testing.assert_array_equal(
        tgrid._hash_cells(_t(cells), bits).numpy(),
        np.asarray(jgrid._hash_cells(jnp.asarray(cells), bits)))


def _queries(kind, q):
    rng = np.random.default_rng(7)
    p = q[rng.integers(0, q.shape[0], 1500)]
    p = p + rng.normal(scale=0.01 if kind != "large" else 1e-3,
                       size=p.shape)
    far = np.full((10, 3), 100.0)  # nothing within reach: found is False
    return np.concatenate([p, far]).astype(np.float32)


@pytest.mark.parametrize("cap", [4, 16])
@pytest.mark.parametrize("kind", CLOUDS)
def test_grid_nn_matches_jax(kind, cap):
    """``idx`` and ``found`` bit for bit, ``dmin`` at rtol 1e-6, through
    several chunks."""
    q, h, mask = _cloud(kind)
    p = _queries(kind, q)
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else _t(mask)
    ij, dj, fj = jgrid.grid_nn(jnp.asarray(p),
                               jgrid.build_voxel_table(jnp.asarray(q), h,
                                                       q_mask=jm),
                               cap=cap, chunk=512)
    it, dt, ft_ = tgrid.grid_nn(_t(p), tgrid.build_voxel_table(_t(q), h,
                                                               q_mask=tm),
                                cap=cap, chunk=512)
    assert it.dtype == torch.int32 and ft_.dtype == torch.bool
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(ft_.numpy(), np.asarray(fj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6)
    assert not ft_[-10:].any() and torch.isinf(dt[-10:]).all()
    if mask is not None:
        assert mask[it.numpy()[ft_.numpy()]].all()


def test_grid_nn_chunks_change_nothing():
    q, h, _ = _cloud("uniform")
    p = _t(_queries("uniform", q))
    table = tgrid.build_voxel_table(_t(q), h)
    a = tgrid.grid_nn(p, table, chunk=128)
    b = tgrid.grid_nn(p, table)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_grid_nn_candidate_limit():
    """The guard raises before any work, names the morton matcher, and
    ``max_candidate_gathers`` overrides it both ways."""
    table = tgrid.build_voxel_table(_t(_cloud("uniform")[0][:256]), 0.2)
    big = torch.zeros((tgrid.MAX_CANDIDATE_GATHERS // (27 * 8) + 1, 3))
    with pytest.raises(ValueError, match="morton"):
        tgrid.grid_nn(big, table, cap=8)
    with pytest.raises(ValueError, match="morton"):
        tgrid.grid_nn(big[:64], table, cap=8, max_candidate_gathers=10_000)
    idx, _, _ = tgrid.grid_nn(big[:64], table, cap=8,
                              max_candidate_gathers=20_000)
    assert idx.shape == (64,)


@pytest.mark.parametrize("masked", [False, True])
def test_voxel_downsample_matches_jax(masked):
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (3000, 3)).astype(np.float32)
    pts[::7] -= 3.0  # negative cells too
    mask = rng.uniform(size=3000) < 0.8 if masked else None
    cj, vj = jgrid.voxel_downsample(jnp.asarray(pts), 0.25,
                                    None if mask is None
                                    else jnp.asarray(mask))
    ct, vt = tgrid.voxel_downsample(_t(pts), 0.25,
                                    None if mask is None else _t(mask))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-6,
                               atol=1e-7)


def test_voxel_downsample_matches_dict_oracle():
    """One centroid per occupied voxel, the valid rows first, as the
    hash-map formulation gives them."""
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1, 1, (3000, 3)).astype(np.float32)
    c, valid = tgrid.voxel_downsample(_t(pts), 0.25)
    cells = collections.defaultdict(list)
    for p, key in zip(pts, map(tuple, np.floor(pts / np.float32(0.25))
                               .astype(int))):
        cells[key].append(p.astype(np.float64))
    k = int(valid.sum())
    assert k == len(cells) and bool(valid[:k].all())
    got = sorted(map(tuple, np.round(c[:k].numpy(), 5)))
    want = sorted(tuple(np.round(np.mean(v, axis=0), 5))
                  for v in cells.values())
    np.testing.assert_allclose(got, want, atol=2e-5)


def _rmse_between(a, b, probe):
    d = (probe @ np.asarray(a.rotation).T + np.asarray(a.translation)) - (
        probe @ np.asarray(b.rotation).T + np.asarray(b.translation))
    return float(np.sqrt((d * d).sum(1).mean()))


def _near_pair(n=3000):
    q = np.random.default_rng(55).uniform(-2, 2, (4000, 3)).astype(
        np.float32)[:n]
    gt = f.gt_transform((0.004, -0.003, 0.002), (0.003, -0.002, 0.004))
    return q, np.array(gt.apply(jnp.asarray(q))), gt


@pytest.mark.parametrize("kw", [dict(grid_cap=16),
                                dict(grid_cap=4, grid_cell_size=0.12,
                                     metric="plane")])
def test_grid_icp_matches_jax(kw):
    """Grid ICP: equal iteration counts, transforms within 1e-5 of each
    other and 1e-4 of the ground truth."""
    src, tgt, gt = _near_pair()
    cfg = dict(matcher="grid", max_iterations=30, **kw)
    j = f.run_icp(jnp.asarray(src), jnp.asarray(tgt), f.ICPConfig(**cfg))
    t = ft.run_icp(_t(src), _t(tgt), ft.ICPConfig(**cfg))
    assert int(t.num_iterations) == int(j.num_iterations)
    np.testing.assert_allclose(t.matched_fraction.numpy(),
                               np.asarray(j.matched_fraction), atol=1e-6)
    assert _rmse_between(t.transform, j.transform, src) < GAP
    assert _rmse_between(t.transform, gt, src) < 1e-4


def test_grid_unmatched_rows_leave_the_solve():
    """Rows far from every target are not found and leave the solve mask,
    as the JAX package's ``correspondence_weights`` folds ``found`` in."""
    src, tgt, _ = _near_pair(1000)
    src = np.concatenate([src, np.full((40, 3), 50.0, np.float32)])
    cfg = dict(matcher="grid", max_iterations=30, grid_cap=16)
    j = f.run_icp(jnp.asarray(src), jnp.asarray(tgt), f.ICPConfig(**cfg))
    t = ft.run_icp(_t(src), _t(tgt), ft.ICPConfig(**cfg))
    n = int(t.num_iterations)
    assert n == int(j.num_iterations)
    assert float(t.matched_fraction[0]) == pytest.approx(1000 / 1040)
    assert _rmse_between(t.transform, j.transform, src[:1000]) < GAP


def test_resolve_matcher_with_a_patched_limit(monkeypatch):
    """Below the limit a grid config is returned as given, above it the
    morton matcher with a warning; both packages agree under one limit,
    and a prebuilt grid table above it is rebuilt for morton."""
    cfg = ft.ICPConfig(matcher="grid", max_iterations=30, grid_cap=16)
    monkeypatch.setattr(tgrid, "MAX_CANDIDATE_GATHERS", 1_000)
    monkeypatch.setattr(jgrid, "MAX_CANDIDATE_GATHERS", 1_000)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert resolve_matcher(cfg, 2) is cfg  # 2 x 27 x 16 = 864
        assert resolve_matcher(ft.ICPConfig(), 10 ** 9).matcher == "xla"
    with pytest.warns(UserWarning, match="morton"):
        assert resolve_matcher(cfg, 3).matcher == "morton"
    with pytest.warns(UserWarning, match="morton"):
        assert j_resolve(f.ICPConfig(matcher="grid", grid_cap=16),
                         3).matcher == "morton"
    src, tgt, gt = _near_pair(3100)
    state = build_matcher_state(_t(tgt), None, cfg)  # a grid table
    assert isinstance(state, tgrid.VoxelTable)
    for kwargs in ({}, {"matcher_state": state}):
        with pytest.warns(UserWarning, match="morton"):
            res = ft.run_icp(_t(src), _t(tgt), cfg, **kwargs)
        assert _rmse_between(res.transform, gt, src) < 1e-4


def test_aa_icp_resolves_the_matcher_as_run_icp(monkeypatch):
    """``run_aa_icp`` shares ``run_icp``'s set-up: a grid config above the
    limit degrades to morton with the warning, and both register."""
    cfg = ft.ICPConfig(matcher="grid", max_iterations=30, grid_cap=16)
    monkeypatch.setattr(tgrid, "MAX_CANDIDATE_GATHERS", 1_000)
    src, tgt, gt = _near_pair(3100)
    for run in (ft.run_icp, ft.run_aa_icp):
        with pytest.warns(UserWarning, match="morton"):
            res = run(_t(src), _t(tgt), cfg)
        assert _rmse_between(res.transform, gt, src) < 1e-4
        # the morton path sorts the source; the result is in the caller's
        # row order
        np.testing.assert_allclose(
            res.points.numpy(), res.transform.apply(_t(src)).numpy(),
            atol=1e-6)


def test_resolve_matcher_differs_from_jax_at_1m():
    """A difference to know: at 1,048,576 points and cap 8 (226,492,416
    candidate rows) the JAX package's TPU limit degrades grid to morton,
    while the port's limit, measured on the H100, keeps the grid matcher.
    ``resolve_matcher`` is a pure function of ``(config, n)``."""
    n = 1_048_576
    with pytest.warns(UserWarning, match="morton"):
        assert j_resolve(f.ICPConfig(matcher="grid"), n).matcher == "morton"
    cfg = ft.ICPConfig(matcher="grid")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert resolve_matcher(cfg, n) is cfg
    assert jgrid.MAX_CANDIDATE_GATHERS < n * 27 * 8 <= (
        tgrid.MAX_CANDIDATE_GATHERS)
    with pytest.warns(UserWarning, match="morton"):
        assert resolve_matcher(cfg, 2 * n).matcher == "morton"


def jax_references():
    """The JAX package's CPU runs that set ``chip_smoke.py``'s grid and
    voxel thresholds and iteration counts (``GRID_SCENES``, ``VOXEL``) and
    the fitness of ``evaluate_registration`` at 262,144. The 1M grid run
    needs JAX's TPU limit lifted: this patches the module attributes that
    ``run_icp`` reads, in this process only."""
    import functools

    from fpcr_tpu.ops import grid as g

    g.MAX_CANDIDATE_GATHERS = 10 ** 10
    g.grid_nn = functools.partial(g.grid_nn, max_candidate_gathers=10 ** 10)
    near = ((0.004, -0.002, 0.003), (0.002, -0.003, 0.002))
    for w in (512, 1024):
        s = f.transformed_scene(f.surface_grid(w), *near)
        r = f.run_icp(s.source, s.target,
                      f.ICPConfig(matcher="grid", max_iterations=30))
        err = float(f.transform_rmse(r.transform, s.ground_truth, s.source))
        print(f"grid synthetic-{w * w}: {int(r.num_iterations)} iterations,"
              f" GT transform RMSE {err:.3e}", flush=True)
        if w == 512:
            q = f.evaluate_registration(s.source, s.target, r.transform)
            print(f"  evaluate_registration fitness {float(q['fitness'])}",
                  flush=True)
    s = f.synthetic_scene(1024)
    cs, ms = g.voxel_downsample(s.source, 0.05)
    ct, mt = g.voxel_downsample(s.target, 0.05)
    cs, ct = np.asarray(cs)[np.asarray(ms)], np.asarray(ct)[np.asarray(mt)]
    r = f.run_icp(jnp.asarray(cs), jnp.asarray(ct),
                  f.ICPConfig(max_iterations=60))
    err = float(f.transform_rmse(r.transform, s.ground_truth, s.source))
    print(f"voxel 0.05: {cs.shape[0]} / {ct.shape[0]} centroids, run_icp "
          f"{int(r.num_iterations)} iterations, GT transform RMSE "
          f"{err:.3e}", flush=True)


if __name__ == "__main__":
    jax_references()
