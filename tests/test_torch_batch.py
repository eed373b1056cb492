"""Batch serving in the port against ``fpcr_tpu`` on the same numpy inputs
(CPU): the batched plain versions of kernels K1 and K2 against
``jax.vmap(nn_argmin_pallas)`` in interpret mode, the batched solvers and
trimming against their per-element calls, and ``register_batch`` against
the JAX package's ``register_batch`` for every metric and matcher (the
morton band with K3's and the XLA geometry, K3p, two shifts and the rescue,
the grid, symmetric, GICP, plane with and without given normals) and the
options, with elements that converge at different iterations.

Run as a script, it prints the JAX package's CPU runs that set
``chip_smoke.py``'s serving thresholds (``SERVING``):

    PYTHONPATH=. python tests/test_torch_batch.py
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fpcr_tpu as f
import fpcr_tpu_torch as ft
from fpcr_tpu.ops.matching_pallas import nn_argmin_pallas
from fpcr_tpu_torch.models import icp as ticp
from fpcr_tpu_torch.ops import solve as ts
from fpcr_tpu_torch.ops.matching import (nn_argmin, nn_argmin_packed,
                                         nn_argmin_packed_plain,
                                         nn_argmin_plain, packed_idx_bits)
from fpcr_tpu_torch.ops.matching_cuda import (nn_argmin_cuda,
                                              nn_argmin_packed_cuda,
                                              plan_slices)

torch.set_num_threads(2)

GAP = 1e-5  # transform RMSE between the two packages' results


def _t(a):
    return torch.as_tensor(np.array(a))


def _rmse_between(ra, ta, rb, tb_, probe):
    d = (probe @ np.asarray(ra).T + np.asarray(ta)) - (
        probe @ np.asarray(rb).T + np.asarray(tb_))
    return float(np.sqrt((d * d).sum(1).mean()))


def _clouds(seed, b=3, n=256, m=300):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-2, 2, (b, n, 3)).astype(np.float32)
    q = rng.uniform(-2, 2, (b, m, 3)).astype(np.float32)
    # ragged masks: all valid, a third valid, none valid past row 40
    mask = np.ones((b, m), bool)
    mask[1] = rng.uniform(size=m) < 0.33
    mask[2, 40:] = False
    return p, q, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("mode", ["packed6", "packed6_idx"])
def test_batched_plain_matches_vmapped_tpu_kernel(mode, masked):
    """``nn_argmin`` / ``nn_argmin_packed`` on a CPU batch (the plain
    versions, element by element) against ``jax.vmap(nn_argmin_pallas)`` in
    interpret mode, B = 3, N = 256, M = 300: every pick equal, the packed
    distances within the f32 grade of the norm form that both compute (the
    plain version in f32, the TPU kernel by its bf16x6 split), masked
    targets never picked."""
    p, q, mask = _clouds(3 if masked else 4)
    jm = jnp.asarray(mask) if masked else None

    def one(pp, qq, mm):
        return nn_argmin_pallas(pp, qq, mm, block_n=64, block_m=128,
                                interpret=True, mode=mode)

    if masked:
        ji, jd = jax.vmap(one)(jnp.asarray(p), jnp.asarray(q), jm)
    else:
        ji, jd = jax.vmap(lambda a, b: one(a, b, None))(jnp.asarray(p),
                                                        jnp.asarray(q))
    ji, jd = np.asarray(ji), np.asarray(jd)
    tm = _t(mask) if masked else None
    k1, k2 = nn_argmin_cuda.launches, nn_argmin_packed_cuda.launches
    if mode == "packed6":
        ti, td = nn_argmin(_t(p), _t(q), tm)
    else:
        ti, td = nn_argmin_packed(_t(p), _t(q), tm)
    assert (nn_argmin_cuda.launches, nn_argmin_packed_cuda.launches) == (
        k1, k2)  # the plain versions ran
    assert ti.shape == (3, 256) and ti.dtype == torch.int32
    ti, td = ti.numpy(), td.numpy()
    none = ~mask.any(1) if masked else np.zeros(3, bool)
    for b in range(3):
        if none[b]:
            assert (ti[b] == 0).all() and np.isinf(td[b]).all()
            continue
        np.testing.assert_array_equal(ti[b], ji[b])
        # both are the norm form |p|^2 - 2p.q + |q|^2 in f32 grade, |p|^2
        # and |q|^2 up to 12 here: a few ulp of 12 apart
        np.testing.assert_allclose(td[b], jd[b], rtol=0, atol=5e-6)
        if masked:
            assert mask[b][ti[b]].all()


@pytest.mark.parametrize("packed", [False, True])
def test_batched_plain_equals_per_element_calls(packed):
    """Every element of a batched call equals its own call, bit for bit,
    B = 1 included; the batch takes ``[B, M]`` masks."""
    p, q, mask = _clouds(5)
    for b_sel in (slice(0, 1), slice(0, 3)):
        pb, qb, mb = _t(p[b_sel]), _t(q[b_sel]), _t(mask[b_sel])
        if packed:
            bits = packed_idx_bits(300)
            bi, bd = nn_argmin_packed_plain(pb, qb, mb, idx_bits=bits)
        else:
            bi, bd = nn_argmin_plain(pb, qb, mb, exact=True)
        for k in range(pb.shape[0]):
            if packed:
                ei, ed = nn_argmin_packed_plain(pb[k], qb[k], mb[k],
                                               idx_bits=bits)
            else:
                ei, ed = nn_argmin_plain(pb[k], qb[k], mb[k], exact=True)
            assert torch.equal(bi[k], ei)
            assert torch.equal(bd[k].view(torch.int32), ed.view(torch.int32))


def test_plan_slices_fills_the_card_with_the_batch():
    """A batch of B elements counts B times the row blocks: fewer target
    slices, never fewer than one, each a multiple of 256."""
    one = plan_slices(4096, 4096, 128, 132)
    many = plan_slices(4096, 4096, 128, 132, batch=32)
    assert one[0] > many[0] == 1
    for slices, length in (one, many):
        assert slices * length >= 4096 and length % 256 == 0


def test_batched_solvers_equal_per_element_solves():
    """Kabsch (SVD with the det fix, and polar), the plane 6x6 solve, the
    trimmed means and IRLS weights and the masked RMSE take a leading batch
    axis: each element as its own call, to f32 noise."""
    rng = np.random.default_rng(9)
    p = _t(rng.normal(size=(4, 200, 3)).astype(np.float32))
    q = p + _t(0.05 * rng.normal(size=(4, 200, 3)).astype(np.float32))
    q[2] = -q[2]  # a reflection: the det fix must act on element 2 alone
    nrm = torch.nn.functional.normalize(_t(rng.normal(size=(4, 200, 3)))
                                        .float(), dim=-1)
    w = _t(rng.uniform(size=(4, 200)).astype(np.float32))
    for solver in ("svd", "polar"):
        got = ts.kabsch_transform(p, q, w, solver=solver)
        for k in range(4):
            want = ts.kabsch_transform(p[k], q[k], w[k], solver=solver)
            torch.testing.assert_close(got.rotation[k], want.rotation,
                                       atol=2e-6, rtol=0)
            torch.testing.assert_close(got.translation[k], want.translation,
                                       atol=2e-6, rtol=0)
    got = ts.point_to_plane_transform(p, q, nrm, w)
    for k in range(4):
        want = ts.point_to_plane_transform(p[k], q[k], nrm[k], w[k])
        torch.testing.assert_close(got.rotation[k], want.rotation, atol=2e-6,
                                   rtol=0)
    d = _t(rng.exponential(size=(4, 200)).astype(np.float32))
    d[1, :50] = float("inf")
    for cfg in (ft.ICPConfig(auto_trim=9.0), ft.ICPConfig(robust_loss="huber"),
                ft.ICPConfig(robust_loss="tukey", max_correspondence_dist=1.5)):
        got = ticp.correspondence_weights(d, None, cfg)
        for k in range(4):
            want = ticp.correspondence_weights(d[k], None, cfg)
            assert torch.equal(got[k], want)
    err = ft.rmse(p, q, w)
    assert err.shape == (4,)
    for k in range(4):
        torch.testing.assert_close(err[k], ft.rmse(p[k], q[k], w[k]))


def _serving_case(b=4, n=512, seed=0, far=False):
    """B random saddle patches (no grid ties), each under its own pose."""
    rng = np.random.default_rng(seed)
    src, tgt, gts = [], [], []
    for k in range(b):
        xy = rng.uniform(-2, 2, (n, 2))
        pts = np.stack([xy[:, 0], xy[:, 1], 0.25 * (xy[:, 0] ** 2
                                                    - xy[:, 1] ** 2)], 1)
        s = 0.06 if far else 0.02
        gt = f.gt_transform(tuple(s * rng.standard_normal(3)),
                            tuple((1 + k) * s * rng.standard_normal(3)))
        src.append(pts.astype(np.float32))
        tgt.append(np.array(gt.apply(jnp.asarray(pts, jnp.float32))))
        gts.append(gt)
    return np.stack(src), np.stack(tgt), gts


NOISE = 1e-5  # an RMSE below this is float32 noise of converged clouds
MORTON = dict(matcher="morton", morton_chunk=64, morton_window=64)
# the gated runs take the difference form: the expansion's ~1e-7 sqdist
# rounding moves rows across a gate set by distances of that size
BATCH_CONFIGS = {
    "point": dict(),
    "point-polar": dict(solver="polar"),
    "point-strict": dict(strict_reference=True),
    "point-trim": dict(max_correspondence_dist=0.3, max_iterations=50,
                       exact_distances=True),
    "point-auto-trim-huber": dict(auto_trim=9.0, robust_loss="huber",
                                  exact_distances=True),
    "point-tukey": dict(robust_loss="tukey", exact_distances=True),
    "point-pallas": dict(matcher="pallas"),
    "point-packed6_idx": dict(matcher="pallas", pallas_mode="packed6_idx"),
    "plane": dict(metric="plane"),
    "plane-auto-trim": dict(metric="plane", auto_trim=9.0,
                            exact_distances=True),
    # the band matcher at chunk 64 / window 64 on 512 points, gated by its
    # default auto-trim; 'pallas' is K3's geometry (the card's route), whose
    # distances are the difference form, and runs the JAX package's vmapped
    # TPU kernel in interpret mode. The XLA geometry has only the expansion
    # form, whose rounding moves rows across the auto-trim gate (errors
    # ~6e-5 apart on the fourth element, per-element runs alike): it runs
    # ungated
    "morton-xla": dict(MORTON, morton_impl="xla", auto_trim=0.0),
    "morton-pallas": dict(MORTON, morton_impl="pallas"),
    "morton-packed6_idx": dict(MORTON, morton_impl="pallas",
                               pallas_mode="packed6_idx"),
    "morton-shifts2": dict(MORTON, morton_impl="pallas", morton_shifts=2),
    "morton-rescue8": dict(MORTON, morton_impl="pallas", morton_rescue=8),
    # the configs whose normals each package estimates itself take 8
    # neighbours: a 4-neighbour covariance on these patches can have two
    # near-equal small eigenvalues, whose eigenvector each package rounds
    # its own way (normals 0.56 apart in cosine, per-element runs alike)
    "symmetric": dict(metric="symmetric", k_neighbors=8),
    "gicp": dict(metric="gicp", k_neighbors=8),
    "grid": dict(matcher="grid"),
    "plane-no-normals": dict(metric="plane", k_neighbors=8),
}
# the configs whose normals each package estimates itself
OWN_NORMALS = ("plane-no-normals",)


@pytest.mark.parametrize("key", list(BATCH_CONFIGS))
def test_register_batch_matches_jax(key):
    """``register_batch`` on a CPU batch B = 4 x 512 against the JAX
    package's: each element's iterations within 1 of JAX's (the stop test
    may land one apart where |E - E_prev| sits within f32 noise of the
    tolerance) and its transform within 1e-5, the errors within 1e-5 while
    both run, NaN after its own stop; the elements stop at different
    iterations. The plane runs take JAX's target normals but
    ``plane-no-normals``, where each package estimates its own, as the
    symmetric and GICP runs do for both clouds. The JAX package runs
    ``matcher='pallas'`` and ``morton_impl='pallas'`` through its TPU kernels
    in interpret mode."""
    kw = BATCH_CONFIGS[key]
    src, tgt, _ = _serving_case(far=key == "point-trim")
    normals = None
    if kw.get("metric") == "plane" and key not in OWN_NORMALS:
        normals = np.stack([np.array(f.estimate_normals(jnp.asarray(t)))
                            for t in tgt])
    j = f.register_batch(jnp.asarray(src), jnp.asarray(tgt),
                         f.ICPConfig(**kw),
                         None if normals is None else jnp.asarray(normals))
    t = ft.register_batch(_t(src), _t(tgt), ft.ICPConfig(**kw),
                          None if normals is None else _t(normals))
    assert t.transform.rotation.shape == (4, 3, 3)
    assert t.errors.shape == (4, ft.ICPConfig(**kw).max_iterations)
    iters = t.num_iterations.numpy()
    assert np.abs(iters - np.asarray(j.num_iterations)).max() <= 1
    for k in range(4):
        assert _rmse_between(t.transform.rotation[k],
                             t.transform.translation[k],
                             j.transform.rotation[k],
                             j.transform.translation[k], src[k]) < GAP
        n = min(iters[k], int(j.num_iterations[k]))
        for name in ("errors", "delta_t"):
            np.testing.assert_allclose(
                getattr(t, name)[k, :n].numpy(),
                np.asarray(getattr(j, name))[k, :n], atol=1e-5,
                err_msg=f"{name}[{k}]")
        # matched fractions where the error is above float32 noise: below
        # it a gate set by the trimmed mean of noise cuts noise
        signal = np.asarray(j.errors)[k, :n] > NOISE
        np.testing.assert_allclose(t.matched_fraction[k, :n].numpy()[signal],
                                   np.asarray(j.matched_fraction)[k, :n][
                                       signal], atol=1e-5)
        for name in ("errors", "matched_fraction", "delta_t", "delta_rot"):
            assert torch.isnan(getattr(t, name)[k, iters[k]:]).all()
    np.testing.assert_allclose(t.points.numpy(), np.asarray(j.points),
                               atol=1e-4)
    assert np.array_equal(t.converged.numpy(), np.asarray(j.converged))
    if key in ("point", "plane"):
        assert len(set(iters.tolist())) > 1  # independent convergence


def test_register_batch_routes_by_config():
    """Every config takes the batched loop: one batched matcher call an
    iteration for the whole batch (one a shift for the morton band, and one
    batched exact call for its rescue), never ``run_icp``; each element
    within one iteration and 1e-5 of its own ``run_icp``."""
    src, tgt, _ = _serving_case(b=2, n=300, seed=4)
    routes = {  # config: {matcher function in models/icp.py: calls a pass}
        "point": (dict(), {"nn_argmin": 1}),
        "plane-pallas": (dict(matcher="pallas", metric="plane"),
                         {"nn_argmin": 1}),
        "morton": (dict(MORTON, morton_rescue=8), {"morton_nn": 1,
                                                   "nn_argmin": 1}),
        "morton-pallas": (dict(MORTON, morton_impl="pallas",
                               morton_shifts=2), {"morton_nn_band": 2}),
        "grid": (dict(matcher="grid"), {"grid_nn": 1}),
        "symmetric": (dict(metric="symmetric"), {"nn_argmin": 1}),
        "gicp": (dict(metric="gicp"), {"nn_argmin": 1}),
    }
    saved = {name: getattr(ticp, name) for name in ("nn_argmin", "morton_nn",
                                                    "morton_nn_band",
                                                    "run_icp")}
    saved_grid = ticp.grid.grid_nn
    calls = []

    def counting(name, fn):
        def call(p, *a, **k):
            calls.append((name, tuple(p.shape[:-1])))
            return fn(p, *a, **k)
        return call

    def refuse(*a, **k):
        raise AssertionError("register_batch called run_icp")

    for key, (kw, per_pass) in routes.items():
        cfg = ft.ICPConfig(max_iterations=6, **kw)
        calls.clear()
        for name in ("nn_argmin", "morton_nn", "morton_nn_band"):
            setattr(ticp, name, counting(name, saved[name]))
        ticp.grid.grid_nn = counting("grid_nn", saved_grid)
        ticp.run_icp = refuse
        try:
            got = ft.register_batch(_t(src), _t(tgt), cfg)
        finally:
            for name, fn in saved.items():
                setattr(ticp, name, fn)
            ticp.grid.grid_nn = saved_grid
        # the normals prepass matches no source rows: only the loop counts
        want = sorted((name, (2, 8 if key.startswith("morton")
                              and name == "nn_argmin" else 300))
                      for name, n in per_pass.items() for _ in range(6 * n))
        assert sorted(calls) == want, key
        for k in range(2):
            one = ft.run_icp(_t(src[k]), _t(tgt[k]), cfg)
            assert abs(int(got.num_iterations[k])
                       - int(one.num_iterations)) <= 1, key
            assert _rmse_between(got.transform.rotation[k],
                                 got.transform.translation[k],
                                 one.transform.rotation,
                                 one.transform.translation, src[k]) < GAP, key


def test_register_batch_checks_shapes_and_matches_jax_state_shapes():
    src, tgt, _ = _serving_case(b=2, n=64, seed=1)
    with pytest.raises(ValueError, match=r"\[B, N, 3\]"):
        ft.register_batch(_t(src[0]), _t(tgt))
    with pytest.raises(ValueError, match="2 sources but 1 targets"):
        ft.register_batch(_t(src), _t(tgt[:1]))
    cfg = ft.ICPConfig(max_iterations=12)
    t = ft.register_batch(_t(src), _t(tgt), cfg)
    j = f.register_batch(jnp.asarray(src), jnp.asarray(tgt),
                         f.ICPConfig(**dataclasses.asdict(cfg)))
    for name in ("errors", "num_iterations", "converged", "points",
                 "matched_fraction", "delta_t", "delta_rot"):
        assert tuple(getattr(t, name).shape) == np.asarray(
            getattr(j, name)).shape, name


def jax_references():
    """The JAX package's CPU runs behind ``chip_smoke.py``'s serving path:
    B = 32 ``synthetic_scene(width=64)`` elements (4,096 points) under
    their own GT poses (seed 0), 20 iterations, each element's iterations
    and GT error (``run_icp`` per element: ``register_batch``'s elements
    are its runs), with the exact matcher and with ``packed6_idx``; then
    its ``register_batch`` on ``chip_smoke.py``'s ``BATCH_CONFIG_RUNS``
    (the morton batch through the XLA geometry)."""
    import sys

    sys.path.insert(0, ".")
    import chip_smoke

    s = f.synthetic_scene(width=64)
    poses = chip_smoke.serving_poses()
    its, errs = [], []
    for t_k, r_k in poses:
        gt = f.gt_transform(t_k, r_k)
        r = f.run_icp(s.source, gt.apply(s.source),
                      f.ICPConfig(max_iterations=20))
        its.append(int(r.num_iterations))
        errs.append(float(f.transform_rmse(r.transform, gt, s.source)))
    print(f"serving: iterations {its}, largest GT error {max(errs):.3e}",
          flush=True)
    its, errs = [], []
    for t_k, r_k in poses:  # K2's mode, the TPU kernel in interpret mode
        gt = f.gt_transform(t_k, r_k)
        r = f.run_icp(s.source, gt.apply(s.source),
                      f.ICPConfig(max_iterations=20, matcher="pallas",
                                  pallas_mode="packed6_idx"))
        its.append(int(r.num_iterations))
        errs.append(float(f.transform_rmse(r.transform, gt, s.source)))
    print(f"serving packed6_idx: iterations {its}, largest GT error "
          f"{max(errs):.3e}", flush=True)
    # the configs that register_batch batches beyond point and plane, on
    # chip_smoke.py's batches (the torch batches made on the CPU, handed
    # over as numpy): JAX's register_batch, each element's GT error
    paths = chip_smoke.batch_config_paths(ft, torch.device("cpu"))
    for label, cfg, srcs, tgts, gts, _ in paths:
        fields = dataclasses.asdict(cfg)
        if fields["matcher"] == "morton":
            fields["morton_impl"] = "xla"  # the TPU kernel is the card's
        r = f.register_batch(jnp.asarray(srcs.numpy()),
                             jnp.asarray(tgts.numpy()),
                             f.ICPConfig(**fields))
        errs = [float(ft.transform_rmse(ft.RigidTransform(
            _t(r.transform.rotation[k]), _t(r.transform.translation[k])), g,
            srcs[k])) for k, g in enumerate(gts)]
        print(f"{label}: iterations {np.asarray(r.num_iterations).tolist()}"
              f", largest GT error {max(errs):.3e}", flush=True)
    frames, xs = chip_smoke.odometry_frames(ft, torch.device("cpu"))
    cfg = dict(chip_smoke.ODOMETRY_MORTON["config"], morton_impl="xla")
    odo = f.register_sequence(jnp.asarray(frames.numpy()),
                              f.ICPConfig(**cfg))
    poses = np.asarray(odo.poses, np.float64)
    off = max(np.abs(poses[:, 1:3, 3]).max(),
              np.abs(poses[:, :3, :3] - np.eye(3)).max())
    print(f"register_sequence morton {tuple(frames.shape)}: pair iterations "
          f"{np.asarray(odo.relative.num_iterations).tolist()}, largest x "
          f"drift {np.abs(poses[:, 0, 3] - xs).max():.3e}, other entries "
          f"off the GT {off:.3e}", flush=True)


if __name__ == "__main__":
    jax_references()
