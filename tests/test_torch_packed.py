"""The packed (value|index) reduction of the port against ``fpcr_tpu`` on the
same numpy inputs (CPU): the plain versions of kernel K2
(``nn_argmin_packed``) and of K3's packed mode K3p
(``morton_nn_band_packed_plain``) against the TPU kernels in interpret
mode, ICP with ``pallas_mode='packed6_idx'`` in both packages, the
packed-reduction study (``scripts/exp_packed_reduction.py``) and the
device default of the port's entry points.

Run as a script, it measures the JAX package's GT error on the CPU for the
packed Morton ICP runs that ``chip_smoke.py`` drives on the card, which set
their thresholds:

    PYTHONPATH=. python tests/test_torch_packed.py
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fpcr_tpu as f
import fpcr_tpu_torch as ft
from fpcr_tpu.ops import morton as jm
from fpcr_tpu.ops.matching_pallas import nn_argmin_pallas
from fpcr_tpu.ops.morton_pallas import morton_nn_pallas
from fpcr_tpu_torch.bench import packed_reduction as pr
from fpcr_tpu_torch.core.cloud import as_points
from fpcr_tpu_torch.interop import (morton_table_from_numpy,
                                    ndt_grid_from_numpy, points_from_numpy,
                                    transform_from_numpy)
from fpcr_tpu_torch.ops import morton as tm
from fpcr_tpu_torch.ops.matching import (nn_argmin_packed,
                                         nn_argmin_packed_plain,
                                         nn_argmin_plain, packed_idx_bits)
from fpcr_tpu_torch.ops.matching_cuda import (nn_argmin_packed_cuda,
                                              nn_min_only_cuda)
from fpcr_tpu_torch.ops.morton_cuda import (morton_nn_cuda,
                                            morton_nn_packed_cuda)
from fpcr_tpu_torch.utils.device import resolve_device

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]

# picks may differ only where both picks' exact distances lie within four
# buckets of each other: the JAX kernel quantizes its bf16x6 expansion-form
# distance and the port its difference-form one, so a distance on a bucket
# edge may fall on either side
BUCKETS = 4
GAP = 1e-5  # transform RMSE between the two packages' ICP results
NEAR = ((0.004, -0.003, 0.002), (0.002, -0.003, 0.002))  # near-registered GT


def _near_tie_rel(idx_bits):
    return BUCKETS * 2.0 ** -(23 - idx_bits)


def _assert_picks_agree(p, q, ia, ib, idx_bits):
    """Indices equal except where the two picks' exact (float64) distances
    lie within :func:`_near_tie_rel` of each other; returns the count of
    differing rows."""
    diff = np.nonzero(ia != ib)[0]
    if diff.size:
        p64 = p.astype(np.float64)[diff]
        q64 = q.astype(np.float64)
        da = ((p64 - q64[ia[diff]]) ** 2).sum(1)
        db = ((p64 - q64[ib[diff]]) ** 2).sum(1)
        rel = np.abs(da - db) / np.maximum(np.minimum(da, db), 1e-12)
        assert rel.max() < _near_tie_rel(idx_bits), rel.max()
    return diff.size


def _exact_sqdist(p, q, idx):
    return ((p.astype(np.float64) - q.astype(np.float64)[idx]) ** 2).sum(1)


# --- K2: the packed brute-force matcher -----------------------------------

def _brute_case(name):
    rng = np.random.default_rng(41)
    m = 500 if name.endswith("500") else 512
    p = rng.uniform(-2, 2, (512, 3)).astype(np.float32)
    q = rng.uniform(-2, 2, (m, 3)).astype(np.float32)
    mask = None
    if name.startswith("masked"):
        mask = np.ones(m, bool)
        mask[200:] = False
    if name.startswith("all-masked"):
        mask = np.zeros(m, bool)
    return p, q, mask


@pytest.mark.parametrize("name", ["512x512", "512x500", "masked-512x512",
                                  "all-masked-512x500"])
def test_packed_plain_matches_tpu_kernel(name):
    """``nn_argmin_packed`` on the CPU (K2's plain version) against
    ``nn_argmin_pallas(mode='packed6_idx')`` in interpret mode: the same
    9 index bits, picks equal up to bucket-edge near-ties, the distance the
    exact one of the pick, masked targets never picked, and a row with no
    valid target idx 0 and ``inf`` (the TPU kernel's index may pass m-1
    there)."""
    p, q, mask = _brute_case(name)
    m = q.shape[0]
    jm_ = None if mask is None else jnp.asarray(mask)
    ji, jd = nn_argmin_pallas(jnp.asarray(p), jnp.asarray(q), jm_,
                              block_n=64, block_m=128, mode="packed6_idx")
    ji, jd = np.asarray(ji), np.asarray(jd)
    bits = packed_idx_bits(m)
    assert bits == 9
    before = nn_argmin_packed_cuda.launches
    ti, td = nn_argmin_packed(torch.as_tensor(p), torch.as_tensor(q),
                              None if mask is None else torch.as_tensor(mask))
    assert nn_argmin_packed_cuda.launches == before  # the plain version ran
    ti, td = ti.numpy(), td.numpy()
    assert ti.dtype == np.int32 and td.dtype == np.float32
    assert ti.min() >= 0 and ti.max() <= m - 1
    if name.startswith("all-masked"):
        assert np.isinf(jd).all()
        assert np.isinf(td).all() and (ti == 0).all()
        return
    assert _assert_picks_agree(p, q, ti, ji, bits) <= 0.02 * p.shape[0]
    np.testing.assert_allclose(td, _exact_sqdist(p, q, ti), rtol=1e-6,
                               atol=1e-7)
    if mask is not None:
        assert mask[ti].all()


def test_packed_plain_against_exact_matcher():
    """K2's plain version against the exact matcher: picks differ only in
    the quantization class (2^-(23-b) relative), the first index wins a
    bucket, and explicit index bits hold the target count."""
    rng = np.random.default_rng(42)
    p = torch.as_tensor(rng.uniform(-2, 2, (700, 3)).astype(np.float32))
    q = torch.as_tensor(rng.uniform(-2, 2, (3000, 3)).astype(np.float32))
    bits = packed_idx_bits(3000)
    assert bits == 12  # m_pad 3,072
    ki, kd = nn_argmin_packed_plain(p, q, idx_bits=bits, target_tile=512)
    ei, ed = nn_argmin_plain(p, q, exact=True)
    n_diff = _assert_picks_agree(p.numpy(), q.numpy(), ki.numpy(),
                                 ei.numpy(), bits)
    assert n_diff <= 0.05 * 700
    # tiling does not change the result: the int32 min is order-free
    ki2, kd2 = nn_argmin_packed_plain(p, q, idx_bits=bits)
    assert torch.equal(ki, ki2) and torch.equal(kd, kd2)
    # equal distances: the lowest index wins
    qt = torch.tensor([[5, 0, 0], [1, 0, 0], [2, 0, 0], [1, 0, 0]],
                      dtype=torch.float32)
    assert int(nn_argmin_packed(torch.zeros((1, 3)), qt)[0][0]) == 1
    with pytest.raises(ValueError, match="index bits"):
        nn_argmin_packed(p, q, idx_bits=11)
    with pytest.raises(ValueError, match=r"\[1, 23\]"):
        nn_argmin_packed(p, q, idx_bits=24)


@pytest.mark.parametrize("m,bits", [(16384, 14), (8171, 13), (35947, 16),
                                    (128, 7), (1, 7), (65536, 16)])
def test_packed_idx_bits_follow_the_jax_bucket(m, bits):
    assert packed_idx_bits(m) == bits


def test_packed_gate_raises_past_two_to_the_sixteen():
    p = jnp.zeros((8, 3), jnp.float32)
    q = jnp.zeros((70000, 3), jnp.float32)
    with pytest.raises(ValueError, match="packed6_idx"):
        nn_argmin_pallas(p, q, mode="packed6_idx")
    with pytest.raises(ValueError, match="packed6_idx"):
        nn_argmin_packed(torch.zeros((8, 3)), torch.zeros((70000, 3)))
    with pytest.raises(ValueError, match="CUDA"):
        nn_argmin_packed_cuda(torch.zeros((8, 3)), torch.zeros((8, 3)),
                              idx_bits=4)


# --- K3p: the packed Morton band ------------------------------------------

def _band_scene(masked_from=None, valid=True):
    """The 4,096-point scene of ``tests/test_morton.py``'s packed test:
    q ~ U(-2, 2)^3, p = q + N(0, 0.002), the JAX table, the sorted source
    and an extra of half the table rows."""
    rng = np.random.default_rng(23)
    q = rng.uniform(-2, 2, (4096, 3)).astype(np.float32)
    p = (q + rng.normal(scale=0.002, size=q.shape)).astype(np.float32)
    mask = None
    if masked_from is not None:
        mask = jnp.asarray(np.arange(4096) < masked_from)
    if not valid:
        mask = jnp.zeros(4096, bool)
    jt = jm.build_morton_table(jnp.asarray(q), mask)
    ps = p[np.asarray(jm.source_morton_order(jnp.asarray(p), jt))]
    extra = (np.asarray(jt.points_sorted) * 0.5).astype(np.float32)
    return ps, jt, extra


@pytest.mark.parametrize("chunk,window,masked_from", [
    (256, 256, None), (512, 64, None), (256, 256, 3500), (512, 64, 3900)])
def test_band_packed_plain_matches_tpu_kernel(chunk, window, masked_from):
    """``morton_nn_band_packed_plain`` against ``morton_nn_pallas(mode=
    'packed6_idx')`` in interpret mode on the JAX table: >= 99% of picks
    the same, distances within rtol 3e-4 (the TPU kernel's own bound
    against packed6), matched points and extras the table rows at the
    index, masked rows (valid_count < m) never picked."""
    ps, jt, extra = _band_scene(masked_from)
    j = morton_nn_pallas(jnp.asarray(ps), jt, jnp.asarray(extra),
                         chunk=chunk, window=window, mode="packed6_idx",
                         interpret=True)
    tt = morton_table_from_numpy(jt, device="cpu")
    before = morton_nn_packed_cuda.launches
    t = tm.morton_nn_band(torch.as_tensor(ps), tt, torch.as_tensor(extra),
                          chunk=chunk, window=window, mode="packed6_idx")
    assert morton_nn_packed_cuda.launches == before  # the plain version ran
    q_sorted = np.asarray(jt.points_sorted)
    ti = t[2].numpy()
    assert ti.dtype == np.int32 and ti.min() >= 0 and ti.max() <= 4095
    assert (ti == np.asarray(j[2])).mean() >= 0.99
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), rtol=3e-4,
                               atol=2e-5)
    np.testing.assert_array_equal(t[0].numpy(), q_sorted[ti])
    np.testing.assert_array_equal(t[3].numpy(), extra[ti])
    np.testing.assert_allclose(t[1].numpy(), _exact_sqdist(ps, q_sorted, ti),
                               rtol=1e-6, atol=1e-9)
    assert (ti < int(jt.valid_count)).all()


def test_band_packed_against_k3_plain():
    """K3p's plain version against K3's on the port's own table: picks
    differ only inside a 10-bit bucket (band 768), and the dispatcher takes
    every other JAX mode name to K3."""
    ps, jt, extra = _band_scene()
    tt = morton_table_from_numpy(jt, device="cpu")
    p = torch.as_tensor(ps)
    a = tm.morton_nn_band_packed_plain(p, tt, chunk=512, window=64)
    b = tm.morton_nn_band_plain(p, tt, chunk=512, window=64)
    assert tm.band_idx_bits(768) == 10
    _assert_picks_agree(ps, np.asarray(jt.points_sorted), a[2].numpy(),
                        b[2].numpy(), 10)
    for mode in tm.BAND_MODES:
        if mode != "packed6_idx":
            c = tm.morton_nn_band(p, tt, chunk=512, window=64, mode=mode)
            assert torch.equal(c[2], b[2])
    with pytest.raises(ValueError, match="mode"):
        tm.morton_nn_band(p, tt, mode="fast")


def test_band_packed_convention_where_no_target_is_valid():
    """Where K3p differs from the TPU kernel: a band with no valid row
    (valid_count 0) gives idx 0, ``inf`` and table row 0, K3's convention;
    the TPU kernel keeps its ~1e30 surrogate distance."""
    ps, jt, extra = _band_scene(valid=False)
    j = morton_nn_pallas(jnp.asarray(ps), jt, jnp.asarray(extra), chunk=128,
                         window=64, mode="packed6_idx", interpret=True)
    t = tm.morton_nn_band_packed_plain(
        torch.as_tensor(ps), morton_table_from_numpy(jt, device="cpu"),
        torch.as_tensor(extra), chunk=128, window=64)
    assert (np.asarray(j[1]) > 1e29).all() and np.isfinite(j[1]).all()
    assert torch.isinf(t[1]).all() and (t[2] == 0).all()
    np.testing.assert_array_equal(
        t[0].numpy(), np.broadcast_to(np.asarray(jt.points_sorted)[0],
                                      ps.shape))
    np.testing.assert_array_equal(t[3].numpy(),
                                  np.broadcast_to(extra[0], ps.shape))


# --- ICP with pallas_mode='packed6_idx' ------------------------------------

def _rmse_between(ta, tb, probe):
    ra, rb = ta.rotation, tb.rotation
    d = ((probe @ np.asarray(ra).T + np.asarray(ta.translation))
         - (probe @ np.asarray(rb).T + np.asarray(tb.translation)))
    return float(np.sqrt((d * d).sum(1).mean()))


ICP_RUNS = {  # key: (scene width, config fields)
    "pallas-16": (16, dict(matcher="pallas", max_iterations=60)),
    "pallas-24": (24, dict(matcher="pallas", max_iterations=60)),
    "morton-40": (40, dict(matcher="morton", morton_impl="pallas",
                           max_iterations=30)),
    "morton-40-band": (40, dict(matcher="morton", morton_impl="pallas",
                                morton_chunk=512, morton_window=64,
                                max_iterations=30)),
}


@pytest.mark.parametrize("key", list(ICP_RUNS))
def test_packed_icp_matches_jax(key):
    """``run_icp`` of both packages with ``pallas_mode='packed6_idx'``:
    transforms within 1e-5 RMSE of each other, iterations within 1, and
    the port's run launched no kernel."""
    width, kw = ICP_RUNS[key]
    s = f.synthetic_scene(width=width)
    src = np.array(s.source)
    tgt = np.array(s.target) if kw["matcher"] == "pallas" else np.array(
        f.gt_transform(*NEAR).apply(jnp.asarray(src)))
    cfg = dict(pallas_mode="packed6_idx", **kw)
    j = f.run_icp(jnp.asarray(src), jnp.asarray(tgt), f.ICPConfig(**cfg))
    before = (nn_argmin_packed_cuda.launches, morton_nn_packed_cuda.launches)
    t = ft.run_icp(torch.as_tensor(src), torch.as_tensor(tgt),
                   ft.ICPConfig(**cfg))
    assert (nn_argmin_packed_cuda.launches,
            morton_nn_packed_cuda.launches) == before
    nj, nt = int(j.num_iterations), int(t.num_iterations)
    assert abs(nj - nt) <= 1, (nj, nt)
    assert _rmse_between(t.transform, j.transform, src) < GAP


def test_packed_mode_routes_as_the_jax_package(monkeypatch):
    """``matcher='pallas'`` with ``packed6_idx`` takes ``nn_argmin_packed``;
    ``matcher='xla'`` keeps the exact ``nn_argmin`` whatever the mode; the
    morton matcher passes the mode to K3's geometry only ('pallas'); the
    exact rescue keeps ``nn_argmin``."""
    from fpcr_tpu_torch.models import icp

    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append((name, k.get("mode")))
            return fn(*a, **k)
        monkeypatch.setattr(icp, name, wrapped)

    for name in ("nn_argmin", "nn_argmin_packed", "morton_nn_band",
                 "morton_nn"):
        spy(name, getattr(icp, name))
    s = ft.synthetic_scene(width=16, device="cpu")

    def run(**kw):
        calls.clear()
        ft.run_icp(s.source, s.target, ft.ICPConfig(
            pallas_mode="packed6_idx", max_iterations=2, tolerance=0.0,
            **kw))
        return sorted(set(calls))

    assert run(matcher="pallas") == [("nn_argmin_packed", None)]
    assert run(matcher="xla") == [("nn_argmin", None)]
    assert run(matcher="morton", morton_impl="pallas") == [
        ("morton_nn_band", "packed6_idx")]
    assert run(matcher="morton") == [("morton_nn", None)]  # 'auto' on CPU
    assert run(matcher="morton", morton_impl="pallas",
               morton_rescue=64) == [("morton_nn_band", "packed6_idx"),
                                     ("nn_argmin", None)]


# --- E2: the packed-reduction study ----------------------------------------

@pytest.fixture(scope="module")
def e2():
    """``scripts/exp_packed_reduction.py``, imported by its path."""
    path = ROOT / "scripts" / "exp_packed_reduction.py"
    spec = importlib.util.spec_from_file_location("exp_packed_reduction",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_pint_matches_the_study_kernel(e2):
    """``nn_argmin_pint`` (K2 with the study's index bits, 9 at 512 with
    block 128) against ``make_pint(64, 128)`` on the study's inputs."""
    p, q = pr.study_inputs(512, "cpu")
    ji, jd = e2.make_pint(64, 128)(jnp.asarray(p.numpy()),
                                   jnp.asarray(q.numpy()))
    assert pr.pint_idx_bits(512, 128) == 9
    assert pr.pint_idx_bits(16384, 8192) == pr.pint_idx_bits(16384, 4096) \
        == 14
    ti, td = pr.nn_argmin_pint(p, q, block_m=128)
    pn, qn = p.numpy(), q.numpy()
    assert _assert_picks_agree(pn, qn, ti.numpy(), np.asarray(ji), 9) \
        <= 0.02 * 512
    np.testing.assert_allclose(td.numpy(), _exact_sqdist(pn, qn, ti.numpy()),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(jd),
                               _exact_sqdist(pn, qn, np.asarray(ji)),
                               rtol=1e-5, atol=1e-6)


def test_min_only_matches_the_study_kernel(e2):
    """``nn_min_only`` against ``make_minonly(64, 128)``: an index of zeros
    and the least distance (the study's bf16x6 expansion form is f32-grade:
    ~1e-6 of |p|^2 + |q|^2, which reaches ~40 here)."""
    p, q = pr.study_inputs(512, "cpu")
    ji, jd = e2.make_minonly(64, 128)(jnp.asarray(p.numpy()),
                                      jnp.asarray(q.numpy()))
    before = nn_min_only_cuda.launches
    ti, td = pr.nn_min_only(p, q)
    assert nn_min_only_cuda.launches == before
    assert ti.dtype == torch.int32 and not ti.any()
    np.testing.assert_array_equal(np.asarray(ji), 0)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=4e-5)
    _, ed = nn_argmin_plain(p, q, exact=True)
    np.testing.assert_array_equal(td.numpy(), ed.numpy())
    mask = torch.arange(512) < 100
    np.testing.assert_array_equal(
        pr.nn_min_only_plain(p, q, mask).numpy(),
        nn_argmin_plain(p, q, mask, exact=True)[1].numpy())
    with pytest.raises(RuntimeError, match="CUDA"):
        pr.main(64)


# --- the device default ----------------------------------------------------

LOADERS = {
    "synthetic_scene": lambda **k: ft.synthetic_scene(width=4, **k),
    "surface_grid": lambda **k: ft.surface_grid(4, **k),
    "random_cloud": lambda **k: __import__(
        "fpcr_tpu_torch.data.synthetic", fromlist=["x"]).random_cloud(8, **k),
    "load_bunny": lambda **k: ft.load_bunny(**k),
    "bunny_scene": lambda **k: ft.bunny_scene(**k),
    "load_hall_scan": lambda **k: ft.load_hall_scan(**k),
    "hall_scene": lambda **k: ft.hall_scene(**k),
    "gt_transform": lambda **k: ft.gt_transform((0.1, 0, 0), (0, 0.1, 0),
                                                **k),
    "identity": lambda **k: ft.RigidTransform.identity(**k),
    "points_from_numpy": lambda **k: points_from_numpy(np.zeros((2, 3)),
                                                       **k),
    "transform_from_numpy": lambda **k: transform_from_numpy(
        np.eye(3), np.zeros(3), **k),
    "morton_table_from_numpy": lambda **k: morton_table_from_numpy(
        jm.build_morton_table(jnp.zeros((4, 3))), **k),
    "ndt_grid_from_numpy": lambda **k: ndt_grid_from_numpy(
        __import__("fpcr_tpu.ops.ndt", fromlist=["x"]).build_ndt_grid(
            jnp.asarray(np.random.default_rng(0).uniform(0, 1, (64, 3)),
                        jnp.float32), 0.5), **k),
    "as_points": lambda **k: as_points(np.zeros((2, 3)), **k),
}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for v in x for t in _tensors(v)] if isinstance(x, tuple) else []


@pytest.mark.parametrize("name", list(LOADERS))
def test_entry_points_default_to_the_card(name, monkeypatch):
    """Called without ``device`` on a machine without a card, every loader,
    scene builder and ``interop.*_from_numpy`` raises and says to pass
    ``device="cpu"``; with it, every tensor lands on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        LOADERS[name]()
    out = _tensors(LOADERS[name](device="cpu"))
    assert out and all(t.device.type == "cpu" for t in out)


def test_tensors_keep_their_device_and_none_means_cuda(monkeypatch):
    """A function given tensors runs on their device; ``resolve_device``
    returns an explicit device as given and maps None to CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = ft.synthetic_scene(width=4, device="cpu")
    assert as_points(s.source).device.type == "cpu"
    r = ft.run_icp(s.source, s.target, ft.ICPConfig(max_iterations=2))
    assert r.transform.rotation.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        ft.run_icp(s.source.numpy(), s.target.numpy())
    assert resolve_device("cpu") == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")


# --- the JAX package's reach on the CPU, for chip_smoke.py ----------------

def jax_reach(widths=(512, 1024), iterations=30):
    """GT transform RMSE and iterations of the JAX package's packed Morton
    point ICP on the CPU (its TPU kernel in interpret mode) for the runs of
    ``chip_smoke.py``: the ``width``² synthetic grid, near GT, chunk 512,
    window 64, cap 30."""
    gt = ((0.004, -0.002, 0.003), (0.002, -0.003, 0.002))
    for w in widths:
        s = f.transformed_scene(f.surface_grid(w), *gt)
        r = f.run_icp(s.source, s.target, f.ICPConfig(
            matcher="morton", morton_impl="pallas", pallas_mode="packed6_idx",
            morton_chunk=512, morton_window=64, max_iterations=iterations))
        err = float(f.transform_rmse(r.transform, s.ground_truth, s.source))
        print(f"JAX packed Morton point ICP, {w * w} points: "
              f"{int(r.num_iterations)} iterations, GT transform RMSE "
              f"{err:.4g}", flush=True)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax_reach()
