"""Odometry and the pose graph in the port against ``fpcr_tpu`` on the same
numpy inputs (CPU): the SE(3) maps (near π included), ``optimize_pose_graph``
with scalar and full-information edges and a NaN measurement, against a
float64 run of the same Gauss-Newton iteration that sets the tolerance,
``register_sequence`` (a batched registration of the pairs and a prefix
product), ``detect_loop_closures`` (equal edges), ``close_loops`` on the
JAX package's odometry carried over by ``interop.odometry_from_numpy``, and
``build_map``.

Run as a script, it prints the JAX package's CPU run of the SLAM pipeline
that sets ``chip_smoke.py``'s thresholds (``SLAM``), and the port's CPU run
of the same odometry pairs:

    PYTHONPATH=. python tests/test_torch_odometry_pose_graph.py
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fpcr_tpu as f
import fpcr_tpu_torch as ft
from fpcr_tpu.models import pose_graph as jpg
from fpcr_tpu_torch.interop import odometry_from_numpy
from fpcr_tpu_torch.models import pose_graph as tpg

torch.set_num_threads(2)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("fn", ["se3_exp", "se3_log", "se3_inv",
                                "se3_adjoint"])
def test_se3_maps_match_jax(fn):
    """Each map on a batch at once against JAX's one element at a time,
    within f32 noise: random tangents, and rotations of 3.0, π − 1e-3,
    π − 1e-5 and exactly π about one axis (``se3_log``'s near-π branch)."""
    rng = np.random.default_rng(0)
    xi = rng.normal(size=(8, 6)).astype(np.float32)
    axis = np.array([1.0, 2.0, -0.5]) / np.linalg.norm([1.0, 2.0, -0.5])
    near_pi = [np.concatenate([[0.1, -0.2, 0.3], th * axis])
               for th in (3.0, np.pi - 1e-3, np.pi - 1e-5, np.pi)]
    xi = np.concatenate([xi, np.asarray(near_pi, np.float32)])
    mats = np.stack([np.asarray(jpg.se3_exp(jnp.asarray(x))) for x in xi])
    arg = xi if fn == "se3_exp" else mats
    want = np.stack([np.asarray(getattr(jpg, fn)(jnp.asarray(a)))
                     for a in arg])
    got = getattr(tpg, fn)(_t(arg)).numpy()
    np.testing.assert_allclose(got, want, atol=3e-7, rtol=0)
    if fn == "se3_log":  # the round trip, near π too
        back = tpg.se3_exp(_t(got)).numpy()
        # near π the axis is read off the symmetric part: f32 keeps about
        # sqrt(eps) of it, in JAX as here
        want = np.stack([np.asarray(jpg.se3_exp(jpg.se3_log(jnp.asarray(m))))
                         for m in mats])
        np.testing.assert_allclose(back, want, atol=3e-7, rtol=0)
        np.testing.assert_allclose(back[:8], mats[:8], atol=2e-6, rtol=0)


def _graph(seed=0, T=8, nan_edge=False):
    """A noisy odometry chain with two loop closures: ``(X0 [T,4,4],
    ei, ej, Z [E,4,4], w_scalar [E], w_full [E,6,6])`` as numpy."""
    rng = np.random.default_rng(seed)
    gt = [np.eye(4, dtype=np.float32)]
    for _ in range(T - 1):
        step = np.concatenate([rng.normal(0, 0.3, 3), rng.normal(0, 0.1, 3)])
        gt.append(gt[-1] @ np.asarray(jpg.se3_exp(jnp.asarray(
            step.astype(np.float32)))))
    gt = np.stack(gt)
    ei = np.array(list(range(T - 1)) + [0, 1], np.int32)
    ej = np.array(list(range(1, T)) + [T - 1, T - 2], np.int32)
    Z = []
    for i, j in zip(ei, ej):
        rel = np.linalg.inv(gt[i]) @ gt[j]
        noise = np.asarray(jpg.se3_exp(jnp.asarray(
            rng.normal(0, 0.02, 6).astype(np.float32))))
        Z.append(rel @ noise)
    Z = np.stack(Z).astype(np.float32)
    if nan_edge:
        Z[3, 0, 0] = np.nan
    X0 = [np.eye(4, dtype=np.float32)]  # open-loop odometry
    for k in range(T - 1):
        X0.append(X0[-1] @ Z[k])
    X0 = np.nan_to_num(np.stack(X0).astype(np.float32), nan=0.0)
    A = rng.normal(size=(len(ei), 6, 6))
    w_full = (A @ A.transpose(0, 2, 1) + 6 * np.eye(6)).astype(np.float32)
    w_scalar = rng.uniform(0.5, 2.0, len(ei)).astype(np.float32)
    return X0, ei, ej, Z, w_scalar, w_full


def _gn_float64(X, ei, ej, Z, w, iterations, damping=1e-6, anchor=1e6):
    """The same Gauss-Newton iteration in float64 with the port's SE(3)
    maps and a dense assembly by loops: the reference the f32 runs are held
    to."""
    X = torch.as_tensor(X, dtype=torch.float64)
    Z = torch.as_tensor(Z, dtype=torch.float64)
    w = torch.as_tensor(w, dtype=torch.float64)
    T = X.shape[0]
    full = w.ndim == 3
    L = torch.linalg.cholesky(w + (1e-9 * torch.diagonal(
        w, dim1=-2, dim2=-1).sum(-1) / 6 + 1e-30)[:, None, None]
        * torch.eye(6, dtype=torch.float64)) if full else torch.sqrt(w)
    for _ in range(iterations):
        H = torch.zeros(6 * T, 6 * T, dtype=torch.float64)
        g = torch.zeros(6 * T, dtype=torch.float64)
        for e, (i, j) in enumerate(zip(ei, ej)):
            A = tpg.se3_inv(X[i]) @ X[j]
            r = tpg.se3_log(tpg.se3_inv(Z[e]) @ A)
            Jj = torch.eye(6, dtype=torch.float64) + 0.5 * tpg._ad_small(r)
            Ji = -Jj @ tpg.se3_adjoint(tpg.se3_inv(A))
            if full:
                Ji, Jj, r = L[e].T @ Ji, L[e].T @ Jj, L[e].T @ r
            else:
                Ji, Jj, r = Ji * L[e], Jj * L[e], r * L[e]
            si, sj = slice(6 * i, 6 * i + 6), slice(6 * j, 6 * j + 6)
            H[si, si] += Ji.T @ Ji
            H[si, sj] += Ji.T @ Jj
            H[sj, si] += Jj.T @ Ji
            H[sj, sj] += Jj.T @ Jj
            g[si] += Ji.T @ r
            g[sj] += Jj.T @ r
        diag = torch.cat([torch.full((6,), anchor, dtype=torch.float64),
                          torch.full((6 * (T - 1),), damping,
                                     dtype=torch.float64)])
        H = H + torch.diag(diag) + 1e-8 * torch.eye(6 * T,
                                                    dtype=torch.float64)
        delta = -torch.linalg.solve(H, g)
        X = X @ tpg.se3_exp(delta.reshape(T, 6))
    return X.numpy()


@pytest.mark.parametrize("weights", ["none", "scalar", "full"])
def test_optimize_pose_graph_matches_jax(weights):
    """Poses within the f32 grade the problem allows: the bound is 4x JAX's
    own gap to the float64 iteration (at the 1e6 anchor and 1e-6 damping
    the matrix sits at a condition number >= 1e12, so LAPACK's and the
    port's f32 Cholesky round apart), and never above 1e-3; residual RMS
    per iteration within 1e-5 relative; the loop closures pull the chain
    below the open loop's residual."""
    X0, ei, ej, Z, ws, wf = _graph()
    w = {"none": None, "scalar": ws, "full": wf}[weights]
    j = jpg.optimize_pose_graph(jnp.asarray(X0), jnp.asarray(ei),
                                jnp.asarray(ej), jnp.asarray(Z),
                                None if w is None else jnp.asarray(w),
                                iterations=6)
    t = ft.optimize_pose_graph(_t(X0), _t(ei), _t(ej), _t(Z),
                               None if w is None else _t(w), iterations=6)
    ref = _gn_float64(X0, ei, ej, Z, np.ones(len(ei)) if w is None else w, 6)
    jax_gap = np.abs(np.asarray(j.poses) - ref).max()
    gap = np.abs(t.poses.numpy() - np.asarray(j.poses)).max()
    assert gap <= min(1e-3, max(4 * jax_gap, 1e-5)), (gap, jax_gap)
    assert np.abs(t.poses.numpy() - ref).max() <= min(1e-3, 4 * jax_gap
                                                     + 1e-5)
    np.testing.assert_allclose(t.residual_rms.numpy(),
                               np.asarray(j.residual_rms), rtol=1e-5)
    assert int(t.num_iterations) == 6
    assert float(t.residual_rms[-1]) < float(t.residual_rms[0])


def test_optimize_pose_graph_never_nan():
    """A NaN measurement makes the solve non-finite in both packages: the
    trajectory is held (δ = 0), never poisoned; the residual RMS is NaN as
    in JAX."""
    X0, ei, ej, Z, ws, _ = _graph(nan_edge=True)
    j = jpg.optimize_pose_graph(jnp.asarray(X0), jnp.asarray(ei),
                                jnp.asarray(ej), jnp.asarray(Z),
                                jnp.asarray(ws), iterations=3)
    t = ft.optimize_pose_graph(_t(X0), _t(ei), _t(ej), _t(Z), _t(ws),
                               iterations=3)
    assert np.isfinite(t.poses.numpy()).all()
    np.testing.assert_array_equal(t.poses.numpy(), np.asarray(j.poses))
    np.testing.assert_array_equal(t.poses.numpy(), X0)
    assert np.isnan(t.residual_rms.numpy()).all() == np.isnan(
        np.asarray(j.residual_rms)).all()


def _frames(T=6, N=400, seed=0):
    """The SLAM example's construction (``examples/odometry_slam.py:36-63``)
    at a small size: a sweep along +x and back over
    ``synthetic_scene(width=32)``, each frame the N points nearest its
    viewpoint, in its own coordinates, with N(0, 4e-3) noise."""
    rng = np.random.default_rng(seed)
    world = np.asarray(f.synthetic_scene(width=32).source)
    xs = np.concatenate([np.linspace(0, 1.2, T // 2),
                         np.linspace(1.2, 0, T - T // 2)])
    frames = []
    for t in range(T):
        crop = world[np.argsort(np.abs(world[:, 0] - xs[t]))[:N]]
        local = crop - np.array([xs[t], 0.0, 0.0])
        frames.append((local + rng.normal(scale=4e-3, size=local.shape))
                      .astype(np.float32))
    return np.stack(frames)


ODO_CFG = dict(max_iterations=25, auto_trim=9.0, exact_distances=True)


@pytest.fixture(scope="module")
def odometry():
    frames = _frames()
    j = f.register_sequence(jnp.asarray(frames), f.ICPConfig(**ODO_CFG))
    t = ft.register_sequence(_t(frames), ft.ICPConfig(**ODO_CFG))
    return frames, j, t


def test_register_sequence_matches_jax(odometry):
    """The batched pairwise registrations, each within 1 iteration of
    JAX's, and the poses: the sequential prefix product rounds in another
    order than JAX's associative scan, so poses agree to 1e-5 (the pairs'
    1e-5 transform gaps compounded over 5 steps)."""
    frames, j, t = odometry
    assert t.poses.shape == (6, 4, 4)
    assert torch.equal(t.poses[0], torch.eye(4))
    assert np.abs(t.relative.num_iterations.numpy()
                  - np.asarray(j.relative.num_iterations)).max() <= 1
    np.testing.assert_allclose(t.poses.numpy(), np.asarray(j.poses),
                               atol=1e-5)
    pose = t.pose(3)
    np.testing.assert_array_equal(pose.rotation.numpy(),
                                  t.poses[3, :3, :3].numpy())
    with pytest.raises(ValueError, match=r"T>=2"):
        ft.register_sequence(_t(frames[:1]))


def test_detect_loop_closures_gives_equal_edges(odometry):
    """The same candidate scan and verification: equal edges (on the JAX
    package's odometry and on the port's own) and padding to ``max_pairs``
    by repetition emitting no duplicate edge. The verifications are 40
    auto-trimmed iterations on frames with 4e-3 sensor noise that have not
    settled to 1e-6: once the two packages' poses part by f32 noise the
    gate decides its edge rows apart, so the measurements agree to 5e-4 and
    the weights (1/rmse², rmse near 4e-3) to 1e-2 relative."""
    frames, j, t = odometry
    kw = dict(radius=0.3, min_separation=2, max_error=1e-2, max_pairs=8)
    je = f.detect_loop_closures(jnp.asarray(frames), j, **kw)
    for odo in (odometry_from_numpy(j, device="cpu"), t):
        te = ft.detect_loop_closures(_t(frames), odo, **kw)
        assert te[0].dtype == torch.int32 and te[2].shape[1:] == (4, 4)
        np.testing.assert_array_equal(te[0].numpy(), np.asarray(je[0]))
        np.testing.assert_array_equal(te[1].numpy(), np.asarray(je[1]))
        assert len(te[0]) >= 2
        np.testing.assert_allclose(te[2].numpy(), np.asarray(je[2]),
                                   atol=5e-4)
        np.testing.assert_allclose(te[3].numpy(), np.asarray(je[3]),
                                   rtol=1e-2)
    pairs = set(zip(te[0].tolist(), te[1].tolist()))
    assert len(pairs) == len(te[0])
    empty = ft.detect_loop_closures(_t(frames), t, radius=1e-6)
    assert [tuple(x.shape) for x in empty] == [(0,), (0,), (0, 4, 4), (0,)]


def test_close_loops_on_jax_odometry_matches_jax(odometry):
    """``close_loops`` on the JAX package's odometry (carried over by
    ``interop.odometry_from_numpy``) with its closures and full 6x6
    information from the port's covariance: poses within 1e-4 of JAX's run
    on the same inputs, and the end pose no worse than the open loop's."""
    frames, j, _ = odometry
    ei, ej, Z, _ = f.detect_loop_closures(jnp.asarray(frames), j,
                                          radius=0.3, min_separation=2,
                                          max_error=1e-2, max_pairs=8)
    infos = []
    for k in range(len(ei)):
        tf_k = ft.RigidTransform(_t(Z[k, :3, :3]), _t(Z[k, :3, 3]))
        cov = ft.registration_covariance(
            _t(frames[int(ej[k])]), _t(frames[int(ei[k])]), tf_k,
            ft.ICPConfig(auto_trim=9.0))
        infos.append(ft.information_from_covariance(cov, tf_k))
    infos = torch.stack(infos)
    lam = float(torch.diagonal(infos[0]).sum() / 6.0)
    odo = odometry_from_numpy(j, device="cpu")
    t = ft.close_loops(odo, _t(ei), _t(ej), _t(Z), infos,
                       odometry_weight=lam / 20.0, iterations=6)
    jr = f.close_loops(j, ei, ej, Z, jnp.asarray(infos.numpy()),
                       odometry_weight=lam / 20.0, iterations=6)
    np.testing.assert_allclose(t.poses.numpy(), np.asarray(jr.poses),
                               atol=1e-4)
    # the sweep returns to its start: frame 5's pose is the identity
    end = np.abs(t.poses[5].numpy() - np.eye(4)).max()
    assert end <= np.abs(np.asarray(j.poses[5]) - np.eye(4)).max() + 1e-6
    # scalar closures take the scalar odometry weights
    s = ft.close_loops(odo, _t(ei), _t(ej), _t(Z), iterations=2)
    js = f.close_loops(j, ei, ej, Z, iterations=2)
    np.testing.assert_allclose(s.poses.numpy(), np.asarray(js.poses),
                               atol=1e-4)


def test_build_map_matches_jax(odometry):
    """One batched transform, then ``voxel_downsample``: the same occupied
    voxels and centroids within f32 noise; masked rows add nothing."""
    frames, j, t = odometry
    masks = np.ones(frames.shape[:2], bool)
    masks[:, -50:] = False
    for m in (None, masks):
        jp, jv = f.build_map(jnp.asarray(frames), j.poses, 0.05,
                             None if m is None else jnp.asarray(m))
        tp, tv = ft.build_map(_t(frames), _t(np.asarray(j.poses)), 0.05,
                              None if m is None else _t(m))
        assert tv.shape == (frames.shape[0] * frames.shape[1],)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_allclose(tp.numpy()[tv.numpy()],
                                   np.asarray(jp)[np.asarray(jv)], atol=1e-5)
    with pytest.raises(ValueError, match="poses must be"):
        ft.build_map(_t(frames), t.poses[:2], 0.05)


def jax_references():
    """The JAX package's CPU run of the card's SLAM path (``chip_smoke.py``
    ``slam_frames``: T = 12 x 4,096 points cropped from
    ``synthetic_scene(width=128)``, ``auto_trim=9.0``, 25 iterations): the
    pairs' iterations and final errors, the closures, the open-loop and
    closed-loop end-pose errors; then the port's CPU run of the pairs."""
    import sys

    sys.path.insert(0, ".")
    import chip_smoke

    frames, gt = chip_smoke.slam_frames(
        np, np.asarray(f.synthetic_scene(width=128).source))
    cfg = f.ICPConfig(max_iterations=25, auto_trim=9.0)
    odo = f.register_sequence(jnp.asarray(frames), cfg)
    T = frames.shape[0]
    drift = float(np.abs(np.asarray(odo.poses[T - 1]) - gt[T - 1]).max())
    ei, ej, Z, w = f.detect_loop_closures(jnp.asarray(frames), odo,
                                          **chip_smoke.SLAM["detect"])
    infos = []
    for k in range(int(ei.shape[0])):
        tf_k = f.RigidTransform(Z[k, :3, :3], Z[k, :3, 3])
        cov = f.registration_covariance(frames[int(ej[k])],
                                        frames[int(ei[k])], tf_k,
                                        f.ICPConfig(auto_trim=9.0))
        infos.append(f.information_from_covariance(cov, tf_k))
    infos = jnp.stack(infos)
    lam = float(jnp.trace(infos[0]) / 6.0)
    res = f.close_loops(odo, ei, ej, Z, infos, odometry_weight=lam / 20.0,
                        iterations=6)
    err = float(np.abs(np.asarray(res.poses[T - 1]) - gt[T - 1]).max())
    pts, valid = f.build_map(frames, res.poses, voxel_size=0.02)
    its = np.asarray(odo.relative.num_iterations)
    errors = np.asarray(odo.relative.errors)
    final = [f"{errors[k, it - 1]:.6e}" for k, it in enumerate(its)]
    print(f"slam: pair iterations {its.tolist()}, final errors {final}, "
          f"closures "
          f"{list(zip(np.asarray(ei).tolist(), np.asarray(ej).tolist()))}, "
          f"open-loop end-pose error {drift:.3e}, closed {err:.3e}, map "
          f"{int(valid.sum())} voxels", flush=True)
    # the port's own CPU run of the same pairs (the plain matcher, JAX's
    # float form): where its stop test lands beside JAX's
    pt = ft.register_sequence(_t(frames), ft.ICPConfig(max_iterations=25,
                                                       auto_trim=9.0))
    its = pt.relative.num_iterations.numpy()
    errors = pt.relative.errors.numpy()
    final = [f"{errors[k, it - 1]:.6e}" for k, it in enumerate(its)]
    drift = float(np.abs(pt.poses[T - 1].numpy() - gt[T - 1]).max())
    print(f"slam, the port on the CPU: pair iterations {its.tolist()}, "
          f"final errors {final}, open-loop end-pose error {drift:.3e}",
          flush=True)


if __name__ == "__main__":
    jax_references()
