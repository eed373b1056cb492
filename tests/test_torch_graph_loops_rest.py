"""The loops that run as CUDA graphs besides ``run_icp``, NDT and the batch,
on the CPU: AA-ICP, scaled ICP, SGD-ICP, ICP with history, the pose graph's
Gauss-Newton loop and RANSAC, each a chunk body driven by
``models/icp.py::drive_chunks``.

On the card each chunk is one replay of a CUDA graph (``utils/graphs.py``);
here the same chunk bodies run eagerly and must give the loops as they ran
before the chunks bit for bit (``_per_iteration_*`` below, kept here as the
reference: one iteration at a time, the done flag read every
``DONE_CHECK_EVERY`` iterations), with ``max_iterations`` a multiple of 8
and not, stopping early and not. The chunked loops also stay within the
JAX package's tolerances on the same seeded numpy inputs (stated at each
test). A rehearsal of the captured route (``graphs.bind`` swapped for a
recorder) shows that every loop takes the graphs and that two calls with
equal shapes give the same loop key: a chunk body or constant that is new
at every call (a closure) would never repeat its key and never capture.
A sharded loop takes the graphs over NCCL and runs eagerly over gloo.
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fpcr_tpu as f
import fpcr_tpu_torch as ft
from fpcr_tpu.models import anderson as ja
from fpcr_tpu.models import pose_graph as jpg
from fpcr_tpu.ops.fpfh import fpfh_features as j_fpfh
from fpcr_tpu.ops.matching import gather_correspondences as j_gather
from fpcr_tpu.ops.matching import nn_argmin as j_nn
from fpcr_tpu.ops.normals import estimate_normals as j_normals
from fpcr_tpu.ops.normals import orient_normals as j_orient
from fpcr_tpu_torch.core.metrics import rmse
from fpcr_tpu_torch.core.transforms import (RigidTransform, rotation_exp,
                                            transform_to_vector,
                                            vector_to_transform)
from fpcr_tpu_torch.models import anderson as ta
from fpcr_tpu_torch.models import global_reg as tg
from fpcr_tpu_torch.models import history as th
from fpcr_tpu_torch.models import icp as mi
from fpcr_tpu_torch.models import ndt as mn
from fpcr_tpu_torch.models import pose_graph as tp
from fpcr_tpu_torch.models import scaled_icp as tsc
from fpcr_tpu_torch.models import sgd_icp as tsg
from fpcr_tpu_torch.models.icp import DONE_CHECK_EVERY
from fpcr_tpu_torch.ops import solve as tso
from fpcr_tpu_torch.ops.matching import gather_correspondences, nn_argmin
from fpcr_tpu_torch.utils import graphs

torch.set_num_threads(2)

ATOL = 1e-5  # per-iteration errors against JAX (tests/test_torch_icp.py)
GAP = 1e-5  # transform RMSE between the two packages' results


# ---- the loops as they ran before the chunks -----------------------------

def _per_iteration_scaled(source, target, config, with_scale=True):
    device = source.device
    nan = torch.full((), float("nan"), device=device)
    points = source
    scale = torch.ones((), dtype=torch.float32, device=device)
    rotation = torch.eye(3, dtype=torch.float32, device=device)
    translation = torch.zeros(3, dtype=torch.float32, device=device)
    prev_error = torch.full((), float("inf"), device=device)
    done = torch.zeros((), dtype=torch.bool, device=device)
    num_iterations = torch.zeros((), dtype=torch.int32, device=device)
    errors = []
    for it in range(config.max_iterations):
        if it and it % DONE_CHECK_EVERY == 0 and bool(done):
            break
        q_m, _, dmin, found = mi._correspondences(points, target, None,
                                                  None, config, None)
        mask = mi.correspondence_weights(dmin, found, config, None)
        s_inc, inc = tso.umeyama_transform(points, q_m, mask,
                                           with_scale=with_scale)
        new_points = (s_inc * torch.matmul(points, inc.rotation.T)
                      + inc.translation)
        error = rmse(new_points, q_m, mask)
        active = ~done
        errors.append(torch.where(active, error, nan))
        converged = (error < config.tolerance) | (
            torch.abs(error - prev_error) < config.tolerance)
        points = torch.where(active, new_points, points)
        translation = torch.where(
            active, s_inc * torch.matmul(inc.rotation, translation)
            + inc.translation, translation)
        rotation = torch.where(active, torch.matmul(inc.rotation, rotation),
                               rotation)
        scale = torch.where(active, s_inc * scale, scale)
        prev_error = torch.where(active, error, prev_error)
        num_iterations = num_iterations + active.to(torch.int32)
        done = done | (active & converged)
    return tsc.ScaledICPResult(
        scale=scale, transform=RigidTransform(rotation, translation),
        errors=mi._nan_padded(errors, config.max_iterations, device),
        num_iterations=num_iterations, converged=done, points=points)


def _per_iteration_aa(source, target, config, history=5,
                      target_normals=None):
    (source, target, _, target_mask, target_normals, normals0, matcher_state,
     unsort, config) = mi._prepare(source, target, config,
                                   target_normals=target_normals)
    device = source.device

    def eval_error(xvec):
        points = vector_to_transform(xvec).apply(source)
        q_m, _, dmin, found = mi._correspondences(
            points, target, target_mask, target_normals, config,
            matcher_state)
        return rmse(points, q_m,
                    mi.correspondence_weights(dmin, found, config))

    def plain_step(xvec):
        pose = vector_to_transform(xvec)
        normals = (None if normals0 is None
                   else torch.matmul(normals0, pose.rotation.T))
        _, inc, _, aux = mi.icp_iteration(
            pose.apply(source), target, config, target_mask=target_mask,
            target_normals=target_normals, matcher_state=matcher_state,
            source_normals=normals)
        return transform_to_vector(inc.compose(pose)), aux

    f32 = dict(dtype=torch.float32, device=device)
    nan = torch.full((), float("nan"), **f32)
    x = torch.zeros(6, **f32)
    hist_x = torch.zeros((history, 6), **f32)
    hist_f = torch.zeros((history, 6), **f32)
    hist_len = torch.zeros((), dtype=torch.int32, device=device)
    prev_error = torch.full((), float("inf"), **f32)
    done = torch.zeros((), dtype=torch.bool, device=device)
    num_iterations = torch.zeros((), dtype=torch.int32, device=device)
    errors, fractions, delta_t, delta_rot, accepted = [], [], [], [], []
    for it in range(config.max_iterations):
        if it and it % DONE_CHECK_EVERY == 0 and bool(done):
            break
        gx, aux = plain_step(x)
        f_ = gx - x
        x_acc = ta._aa_mix(hist_x, hist_f, hist_len, x, f_, reg=1e-10)
        err_acc = eval_error(x_acc)
        err_plain = eval_error(gx)
        use_acc = (hist_len > 0) & (err_acc < err_plain)
        x_next = torch.where(use_acc, x_acc, gx)
        err = torch.where(use_acc, err_acc, err_plain)
        rel = vector_to_transform(x_next).compose(
            vector_to_transform(x).inverse())
        converged = (err < config.tolerance) | (
            torch.abs(err - prev_error) < config.tolerance)
        active = ~done
        errors.append(torch.where(active, err, nan))
        fractions.append(torch.where(active, aux.matched_fraction, nan))
        delta_t.append(torch.where(active, torch.linalg.vector_norm(
            rel.translation), nan))
        delta_rot.append(torch.where(active, mi.rotation_angle(rel.rotation),
                                     nan))
        accepted.append(active & use_acc)
        hist_x = torch.where(active, torch.cat([x[None], hist_x[:-1]]),
                             hist_x)
        hist_f = torch.where(active, torch.cat([f_[None], hist_f[:-1]]),
                             hist_f)
        hist_len = torch.where(
            active, torch.where(use_acc, torch.clamp(hist_len + 1,
                                                     max=history),
                                torch.ones_like(hist_len)), hist_len)
        x = torch.where(active, x_next, x)
        prev_error = torch.where(active, err, prev_error)
        num_iterations = num_iterations + active.to(torch.int32)
        done = done | (active & converged)
    n = config.max_iterations
    transform = vector_to_transform(x)
    points = transform.apply(source)
    result = mi.ICPResult(
        transform=transform, errors=mi._nan_padded(errors, n, device),
        num_iterations=num_iterations, converged=done,
        points=points if unsort is None else points[unsort],
        matched_fraction=mi._nan_padded(fractions, n, device),
        delta_t=mi._nan_padded(delta_t, n, device),
        delta_rot=mi._nan_padded(delta_rot, n, device))
    flags = torch.zeros(n, dtype=torch.bool, device=device)
    if accepted:
        flags[:len(accepted)] = torch.stack(accepted)
    return result, flags


def _per_iteration_sgd(source, target, config, draw, *, batch_size,
                       learning_rate=0.2, momentum=0.7, ema=0.9,
                       lr_decay=0.02):
    device = source.device
    f32 = dict(dtype=torch.float32, device=device)
    nan = torch.full((), float("nan"), **f32)
    centroid = source.mean(dim=0)
    rotation = torch.eye(3, **f32)
    translation = torch.zeros(3, **f32)
    velocity = torch.zeros(6, **f32)
    ema_error = torch.full((), float("inf"), **f32)
    done = torch.zeros((), dtype=torch.bool, device=device)
    num_iterations = torch.zeros((), dtype=torch.int32, device=device)
    errors, delta_t, delta_rot = [], [], []
    for it in range(config.max_iterations):
        if it and it % DONE_CHECK_EVERY == 0 and bool(done):
            break
        x = torch.matmul(source[draw(it)], rotation.T) + translation
        q_idx, _ = nn_argmin(x, target, None,
                             source_chunk=min(batch_size, 2048),
                             target_tile=config.target_tile)
        r = x - gather_correspondences(target, q_idx)
        xc = x - centroid
        g_t = 2.0 * r.mean(dim=0)
        g_w = 2.0 * torch.linalg.cross(xc, r).mean(dim=0)
        s_w = 2.0 * torch.sum(xc * xc, dim=1).mean() + 1e-12
        grad = torch.cat([g_w / s_w, g_t / 2.0])
        lr_t = float(np.float32(learning_rate) / (
            np.float32(1.0) + np.float32(lr_decay) * np.float32(it)))
        vel = momentum * velocity - lr_t * grad
        d_rot = rotation_exp(vel[:3])
        new_r = torch.matmul(d_rot, rotation)
        new_t = (torch.matmul(d_rot, translation - centroid) + centroid
                 + vel[3:])
        batch_rmse = torch.sqrt(torch.sum(r * r, dim=1).mean())
        ema_new = (batch_rmse if it == 0
                   else ema * ema_error + (1.0 - ema) * batch_rmse)
        converged = (torch.zeros((), dtype=torch.bool, device=device)
                     if it <= 10 else
                     (ema_new < config.tolerance)
                     | (torch.abs(ema_new - ema_error) < config.tolerance))
        active = ~done
        errors.append(torch.where(active, ema_new, nan))
        delta_t.append(torch.where(active, torch.linalg.vector_norm(vel[3:]),
                                   nan))
        delta_rot.append(torch.where(active, mi.rotation_angle(d_rot), nan))
        rotation = torch.where(active, new_r, rotation)
        translation = torch.where(active, new_t, translation)
        velocity = torch.where(active, vel, velocity)
        ema_error = torch.where(active, ema_new, ema_error)
        num_iterations = num_iterations + active.to(torch.int32)
        done = done | (active & converged)
    n = config.max_iterations
    transform = RigidTransform(rotation, translation)
    errs = mi._nan_padded(errors, n, device)
    return mi.ICPResult(
        transform=transform, errors=errs, num_iterations=num_iterations,
        converged=done, points=transform.apply(source),
        matched_fraction=torch.where(torch.isnan(errs), errs,
                                     torch.ones_like(errs)),
        delta_t=mi._nan_padded(delta_t, n, device),
        delta_rot=mi._nan_padded(delta_rot, n, device))


def _per_iteration_history(source, target, config, target_normals=None):
    prep = mi._prepare(source, target, config, None, None, target_normals)
    config, device = prep.config, prep.source.device
    eye = torch.eye(3, device=device)
    zero3 = torch.zeros(3, device=device)
    nan = torch.full((), float("nan"), device=device)
    points, normals = prep.source, prep.source_normals
    acc = RigidTransform(eye, zero3)
    prev_error = torch.full((), float("inf"), device=device)
    done = torch.zeros((), dtype=torch.bool, device=device)
    rows = []
    for it in range(config.max_iterations):
        if it and it % DONE_CHECK_EVERY == 0 and bool(done):
            break
        new_points, inc, error, aux = mi.icp_iteration(
            points, prep.target, config, prep.source_mask, prep.target_mask,
            prep.target_normals, None, prep.matcher_state, normals)
        inc = RigidTransform(torch.where(done, eye, inc.rotation),
                             torch.where(done, zero3, inc.translation))
        points = torch.where(done, points, new_points)
        if normals is not None:
            normals = torch.matmul(normals, inc.rotation.T)
        error = torch.where(done, prev_error, error)
        acc = inc.compose(acc)
        rows.append((inc.rotation, inc.translation, acc.rotation,
                     acc.translation, error, ~done,
                     torch.where(done, nan, aux.matched_fraction),
                     torch.linalg.vector_norm(inc.translation),
                     mi.rotation_angle(inc.rotation)))
        done = done | (error < config.tolerance) | (
            torch.abs(error - prev_error) < config.tolerance)
        prev_error = error
    zero = torch.zeros((), device=device)
    idle = (eye, zero3, acc.rotation, acc.translation, prev_error,
            torch.zeros((), dtype=torch.bool, device=device), nan, zero, zero)
    rows += [idle] * (config.max_iterations - len(rows))
    (inc_r, inc_t, acc_r, acc_t, errors, active, fraction, delta_t,
     delta_rot) = (torch.stack(col) for col in zip(*rows))
    if prep.unsort is not None:
        points = points[prep.unsort]
    return th.ICPHistory(
        transform=acc, incremental_rotations=inc_r,
        incremental_translations=inc_t, accumulated_rotations=acc_r,
        accumulated_translations=acc_t, errors=errors, active=active,
        num_iterations=active.to(torch.int32).sum(), converged=done,
        points=points, matched_fraction=fraction, delta_t=delta_t,
        delta_rot=delta_rot)


def _segment_sum_reduce(keys, size):
    """The earlier ``_SegmentSum``: ``torch.segment_reduce`` over the rows
    in stable key order, scattered into the cells."""
    order = torch.argsort(keys, stable=True)
    cells, lengths = torch.unique_consecutive(keys[order],
                                              return_counts=True)

    def call(values):
        flat = values.reshape(values.shape[0], -1)[order]
        sums = torch.segment_reduce(flat, "sum", lengths=lengths, axis=0)
        out = torch.zeros((size, flat.shape[1]), dtype=values.dtype)
        out[cells] = sums
        return out.reshape((size,) + values.shape[1:])
    return call


def _se3_log_solve(M):
    """``se3_log`` with ``torch.linalg.solve``, as before ``solve_ex``."""
    w = tp._so3_log(M[..., :3, :3])
    _, V = tp._so3_exp_V(w)
    rho = torch.linalg.solve(V, M[..., :3, 3:4])[..., 0]
    return torch.cat([rho, w], dim=-1)


def _per_iteration_pose_graph(X, ei, ej, measurements, weights,
                              iterations, damping=1e-6, anchor_weight=1e6):
    T, E = X.shape[0], ei.shape[0]
    meas_inv = tp.se3_inv(measurements)
    w = torch.ones(E) if weights is None else weights
    full_info = w.ndim == 3
    eye6 = torch.eye(6)
    if full_info:
        floor = 1e-9 * (w.diagonal(dim1=-2, dim2=-1).sum(-1) / 6.0) + 1e-30
        L, info = torch.linalg.cholesky_ex(w + floor[:, None, None] * eye6)
        whiten = torch.where((info == 0)[:, None, None], L,
                             torch.full_like(L, float("nan")))
    else:
        whiten = torch.sqrt(w)
    H_sum = _segment_sum_reduce(torch.cat([ei * T + ei, ei * T + ej,
                                           ej * T + ei, ej * T + ej]), T * T)
    g_sum = _segment_sum_reduce(torch.cat([ei, ej]), T)
    diag = torch.cat([torch.full((6,), anchor_weight),
                      torch.full((6 * (T - 1),), damping)])
    prior = torch.diag(diag) + 1e-8 * torch.eye(6 * T)
    rms_hist = torch.full((iterations,), float("nan"))
    for it in range(iterations):
        A = torch.matmul(tp.se3_inv(X[ei]), X[ej])
        r = _se3_log_solve(torch.matmul(meas_inv, A))
        Jj = eye6 + 0.5 * tp._ad_small(r)
        Ji = -torch.matmul(Jj, tp.se3_adjoint(tp.se3_inv(A)))
        if full_info:
            Lt = whiten.transpose(-1, -2)
            Ji, Jj = torch.matmul(Lt, Ji), torch.matmul(Lt, Jj)
            rw = torch.matmul(Lt, r[..., None])[..., 0]
        else:
            Ji = Ji * whiten[:, None, None]
            Jj = Jj * whiten[:, None, None]
            rw = r * whiten[:, None]
        JiT = Ji.transpose(-1, -2)
        JiTJj = torch.matmul(JiT, Jj)
        H = H_sum(torch.cat([torch.matmul(JiT, Ji), JiTJj,
                             JiTJj.transpose(-1, -2),
                             torch.matmul(Jj.transpose(-1, -2), Jj)]))
        g = g_sum(torch.cat([torch.matmul(JiT, rw[..., None])[..., 0],
                             torch.matmul(Jj.transpose(-1, -2),
                                          rw[..., None])[..., 0]]))
        Hf = H.reshape(T, T, 6, 6).permute(0, 2, 1, 3).reshape(6 * T, 6 * T)
        L, info = torch.linalg.cholesky_ex(Hf + prior)
        delta = -torch.cholesky_solve(g.reshape(6 * T, 1), L)[:, 0]
        good = (info == 0) & torch.isfinite(delta).all()
        delta = torch.where(good, delta, torch.zeros_like(delta))
        X = torch.matmul(X, tp.se3_exp(delta.reshape(T, 6)))
        rms_hist[it] = torch.sqrt(torch.mean(torch.sum(r * r, dim=1)))
    return tp.PoseGraphResult(poses=X, residual_rms=rms_hist,
                              num_iterations=torch.full(
                                  (), iterations, dtype=torch.int32))


def _per_iteration_ransac(src_sel, q_corr, good, samples, tau,
                          refine_rounds):
    samples = samples.long()
    hyp = tso.kabsch_transform(src_sel[samples], q_corr[samples])
    proj = (torch.matmul(src_sel, hyp.rotation.transpose(1, 2))
            + hyp.translation[:, None, :])
    resid2 = torch.sum((proj - q_corr[None]) ** 2, dim=-1)
    scores = ((resid2 < tau * tau) & good[None]).sum(dim=1)
    best = torch.argmax(scores)
    R, t = hyp.rotation[best], hyp.translation[best]
    for _ in range(refine_rounds):
        _, inl = tg._inliers(R, t, src_sel, q_corr, good, tau)
        R, t = tso.kabsch_transform(src_sel, q_corr, inl)
    r2, inl = tg._inliers(R, t, src_sel, q_corr, good, tau)
    n_inl = inl.sum()
    err = torch.sqrt(torch.where(inl, r2, torch.zeros_like(r2)).sum()
                     / torch.clamp(n_inl, min=1))
    return R, t, n_inl.to(torch.int32), err


# ---- helpers ---------------------------------------------------------------

def _bits(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for item in tree for leaf in _leaves(item)]


def _same(a, b, what=""):
    """Every tensor of two results equal bit for bit (NaNs included)."""
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb), what
    for k, (x, y) in enumerate(zip(la, lb)):
        assert x.shape == y.shape and x.dtype == y.dtype, (what, k)
        assert torch.equal(_bits(x), _bits(y)), (what, k)


def _t(a):
    return torch.as_tensor(np.array(a))


def _rmse_between(ra, ta_, rb, tb, probe):
    d = (probe @ np.asarray(ra).T + np.asarray(ta_)) - (
        probe @ np.asarray(rb).T + np.asarray(tb))
    return float(np.sqrt((d * d).sum(1).mean()))


def _scene(width=16):
    s = ft.synthetic_scene(width=width, device="cpu")
    return s.source, s.target


def _volume(n=600, s_true=1.04, seed=11):
    """A volumetric cloud and its similarity image (numpy, float32)."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    gt = f.gt_transform((0.01, -0.02, 0.015), (0.01, -0.008, 0.012))
    return src, np.array(s_true * gt.apply(jnp.asarray(src)))


def _graph(seed=0, T=8):
    """A noisy odometry chain with two loop closures (numpy): ``(X0, ei,
    ej, Z, w_scalar, w_full)``."""
    rng = np.random.default_rng(seed)
    gt = [np.eye(4, dtype=np.float32)]
    for _ in range(T - 1):
        step = np.concatenate([rng.normal(0, 0.3, 3), rng.normal(0, 0.1, 3)])
        gt.append(gt[-1] @ tp.se3_exp(torch.as_tensor(
            step.astype(np.float32))).numpy())
    gt = np.stack(gt)
    ei = np.array(list(range(T - 1)) + [0, 1], np.int64)
    ej = np.array(list(range(1, T)) + [T - 1, T - 2], np.int64)
    Z = []
    for i, j in zip(ei, ej):
        noise = tp.se3_exp(torch.as_tensor(
            rng.normal(0, 0.02, 6).astype(np.float32))).numpy()
        Z.append(np.linalg.inv(gt[i]) @ gt[j] @ noise)
    Z = np.stack(Z).astype(np.float32)
    X0 = [np.eye(4, dtype=np.float32)]
    for k in range(T - 1):
        X0.append(X0[-1] @ Z[k])
    X0 = np.stack(X0).astype(np.float32)
    A = rng.normal(size=(len(ei), 6, 6))
    w_full = (A @ A.transpose(0, 2, 1) + 6 * np.eye(6)).astype(np.float32)
    w_scalar = rng.uniform(0.5, 2.0, len(ei)).astype(np.float32)
    return X0, ei, ej, Z, w_scalar, w_full


# ---- the chunked loops against the per-iteration loops, bit for bit -------

SCALED_RUNS = {"K1": dict(matcher="pallas"),
               "K2": dict(matcher="pallas", pallas_mode="packed6_idx"),
               "rigid": dict(exact_distances=True)}


@pytest.mark.parametrize("iterations", [5, 8, 13, 40])
@pytest.mark.parametrize("name", list(SCALED_RUNS))
def test_chunked_scaled_equals_per_iteration_loop(name, iterations):
    """``run_scaled_icp`` in chunks equals the per-iteration loop bit for
    bit (scale, transform, errors, iterations, done, points); the runs of
    40 stop early."""
    src, tgt = (_t(a) for a in _volume())
    cfg = ft.ICPConfig(max_iterations=iterations, **SCALED_RUNS[name])
    with_scale = name != "rigid"
    got = ft.run_scaled_icp(src, tgt, cfg, with_scale=with_scale)
    _same(got, _per_iteration_scaled(src, tgt, cfg, with_scale), name)
    if iterations == 40:
        assert bool(got.converged) and int(got.num_iterations) < 33


AA_RUNS = {"point": dict(), "plane": dict(metric="plane"),
           "trimmed": dict(max_correspondence_dist=0.3,
                           exact_distances=True),
           "morton": dict(matcher="morton", morton_impl="pallas",
                          morton_chunk=128, morton_window=64)}


def _aa_inputs(name):
    if name == "trimmed":  # partial overlap and noise: rejections happen
        rng = np.random.default_rng(7)
        base = rng.uniform(-1.0, 1.0, size=(600, 3)).astype(np.float32)
        gt = ft.gt_transform((0.05, -0.03, 0.04), (0.05, -0.04, 0.06),
                             device="cpu")
        tgt = gt.apply(torch.as_tensor(base))
        src = torch.as_tensor(base[:420] + rng.normal(
            0.0, 5e-3, size=(420, 3)).astype(np.float32))
        return src, tgt, None
    src, tgt = _scene(24 if name == "plane" else 16)
    normals = ft.estimate_normals(tgt) if name == "plane" else None
    return src, tgt, normals


@pytest.mark.parametrize("iterations", [5, 8, 13, 40])
@pytest.mark.parametrize("name", list(AA_RUNS))
def test_chunked_aa_equals_per_iteration_loop(name, iterations):
    """``run_aa_icp`` in chunks equals the per-iteration loop bit for bit,
    the safeguard's decisions included; the runs of 40 stop early."""
    src, tgt, normals = _aa_inputs(name)
    cfg = ft.ICPConfig(max_iterations=iterations, **AA_RUNS[name])
    got, acc = ft.run_aa_icp(src, tgt, cfg, target_normals=normals,
                             return_accepted=True)
    ref, ref_acc = _per_iteration_aa(src, tgt, cfg, target_normals=normals)
    _same(got, ref, name)
    assert torch.equal(acc, ref_acc)
    if iterations == 40:
        assert bool(got.converged) and int(got.num_iterations) < 33
        if name == "trimmed":
            n = int(got.num_iterations)
            assert not acc[1:n].all()  # a rejection restarted the history


@pytest.mark.parametrize("iterations", [5, 8, 13, 80])
@pytest.mark.parametrize("seed", [0, 3])
def test_chunked_sgd_equals_per_iteration_loop(seed, iterations):
    """``_sgd_loop`` in chunks (the batch rows drawn into a table before
    the loop, the step size and warm-up from a device step counter) equals
    the per-iteration loop bit for bit with the same draws; ``run_sgd_icp``
    with its own generator too; the runs of 80 stop early."""
    src, tgt = _scene(24)
    cfg = ft.ICPConfig(max_iterations=iterations, tolerance=1e-3)
    gen = torch.Generator().manual_seed(seed)
    draws = [torch.randint(0, src.shape[0], (128,), generator=gen)
             for _ in range(iterations)]
    got = tsg._sgd_loop(src, tgt, cfg, lambda it: draws[it], batch_size=128,
                        learning_rate=0.2, momentum=0.7, ema=0.9,
                        lr_decay=0.02)
    ref = _per_iteration_sgd(src, tgt, cfg, lambda it: draws[it],
                             batch_size=128)
    _same(got, ref, "fed")
    own = ft.run_sgd_icp(src, tgt, cfg, batch_size=128, seed=seed)
    gen = torch.Generator().manual_seed(seed)
    _same(own, _per_iteration_sgd(
        src, tgt, cfg, lambda it: torch.randint(
            0, src.shape[0], (128,), generator=gen), batch_size=128), "own")
    if iterations == 80:
        n = int(got.num_iterations)
        assert bool(got.converged) and 10 < n < 73


HISTORY_RUNS = {"point": dict(),
                "plane": dict(metric="plane"),
                "morton": dict(matcher="morton", morton_impl="pallas",
                               morton_chunk=128, morton_window=64),
                "symmetric": dict(metric="symmetric", exact_distances=True)}


@pytest.mark.parametrize("iterations", [5, 8, 13, 40])
@pytest.mark.parametrize("name", list(HISTORY_RUNS))
def test_chunked_history_equals_per_iteration_loop(name, iterations):
    """``run_icp_with_history`` in chunks equals the per-iteration loop bit
    for bit in every row, the masked no-op rows after the stop included;
    the runs of 40 stop early."""
    src, tgt = _scene()
    normals = ft.estimate_normals(tgt) if name == "plane" else None
    cfg = ft.ICPConfig(max_iterations=iterations, **HISTORY_RUNS[name])
    got = ft.run_icp_with_history(src, tgt, cfg, target_normals=normals)
    _same(got, _per_iteration_history(src, tgt, cfg, normals), name)
    if iterations == 40:
        n = int(got.num_iterations)
        assert bool(got.converged) and n < 33
        assert not bool(got.active[n:].any())
        assert torch.isnan(got.matched_fraction[n:]).all()


@pytest.mark.parametrize("iterations", [3, 8, 13])
@pytest.mark.parametrize("weights", ["none", "scalar", "full"])
def test_chunked_pose_graph_equals_per_iteration_loop(weights, iterations):
    """``optimize_pose_graph`` in chunks (a fixed trip: no done flag is
    read) equals the per-iteration loop with ``segment_reduce`` and
    ``torch.linalg.solve`` bit for bit."""
    X0, ei, ej, Z, ws, wf = _graph()
    w = {"none": None, "scalar": _t(ws), "full": _t(wf)}[weights]
    got = ft.optimize_pose_graph(_t(X0), _t(ei), _t(ej), _t(Z), w,
                                 iterations=iterations)
    ref = _per_iteration_pose_graph(_t(X0), _t(ei), _t(ej), _t(Z), w,
                                    iterations)
    _same(got, ref, weights)
    assert float(got.residual_rms[-1]) < float(got.residual_rms[0])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segment_sum_equals_segment_reduce(seed):
    """The gather-table ``_SegmentSum`` equals the earlier
    ``segment_reduce`` bit for bit: each cell's rows added one after the
    other in row order, empty cells 0, one row, many rows, no keys."""
    rng = np.random.default_rng(seed)
    for n, size in ((200, 37), (1, 5), (64, 64), (0, 4)):
        keys = torch.as_tensor(rng.integers(0, size, n))
        values = torch.as_tensor(rng.normal(size=(n, 6, 6)).astype(
            np.float32) * 10.0 ** rng.uniform(-4, 4, (n, 1, 1)).astype(
                np.float32))
        got = tp._SegmentSum.plan(keys, size)(values)
        want = (_segment_sum_reduce(keys, size)(values) if n else
                torch.zeros((size, 6, 6)))
        assert torch.equal(_bits(got), _bits(want))


def test_se3_log_solve_ex_equals_solve():
    """``se3_log`` by ``solve_ex`` is ``solve``'s function bit for bit on
    the CPU, near the identity, at moderate angles and near π."""
    rng = np.random.default_rng(4)
    xi = rng.normal(size=(64, 6)).astype(np.float32)
    xi[:16, 3:] *= 1e-7
    xi[16:32, 3:] *= 3.1 / np.linalg.norm(xi[16:32, 3:], axis=1,
                                          keepdims=True)
    M = tp.se3_exp(torch.as_tensor(xi))
    assert torch.equal(_bits(tp.se3_log(M)), _bits(_se3_log_solve(M)))


@pytest.mark.parametrize("rounds", [0, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_ransac_equals_per_iteration(seed, rounds):
    """``_ransac`` as one chunk equals the loop with the host's ``[best]``
    bit for bit, on correspondences with 40% outliers."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    gt = ft.gt_transform((0.3, -0.2, 0.5), (0.1, 0.2, -0.3), device="cpu")
    q = gt.apply(torch.as_tensor(src))
    bad = rng.uniform(size=300) < 0.4
    q[torch.as_tensor(bad)] = torch.as_tensor(
        rng.uniform(-1, 1, (int(bad.sum()), 3)).astype(np.float32))
    good = torch.as_tensor(rng.uniform(size=300) < 0.9)
    samples = torch.as_tensor(rng.integers(0, 300, (128, 3)))
    tau = torch.tensor(0.02)
    args = (torch.as_tensor(src), q, good, samples, tau, rounds)
    got = tg._ransac(*args)
    _same(got, _per_iteration_ransac(*args))
    assert int(got[2]) > 100


# ---- the chunked loops against the JAX package -----------------------------

def test_chunked_scaled_within_jax_tolerance():
    """Scaled ICP in chunks (13 iterations, not a multiple of 8) against
    ``fpcr_tpu.run_scaled_icp``: equal iterations, scales within 1e-6
    relative, errors within 1e-5, transforms within 1e-5 RMSE."""
    src, tgt = _volume(1500)
    j = f.run_scaled_icp(jnp.asarray(src), jnp.asarray(tgt),
                         f.ICPConfig(max_iterations=13))
    t = ft.run_scaled_icp(_t(src), _t(tgt), ft.ICPConfig(max_iterations=13))
    n = int(t.num_iterations)
    assert n == int(j.num_iterations)
    np.testing.assert_allclose(float(t.scale), float(j.scale), rtol=1e-6)
    np.testing.assert_allclose(t.errors.numpy()[:n],
                               np.asarray(j.errors)[:n], atol=ATOL)
    assert _rmse_between(t.transform.rotation, t.transform.translation,
                         j.transform.rotation, j.transform.translation,
                         src) < GAP


@pytest.mark.parametrize("iterations", [13, 21])
def test_chunked_aa_within_jax_tolerance(iterations):
    """AA-ICP in chunks against ``fpcr_tpu.run_aa_icp`` at lengths that are
    not a multiple of 8: equal iterations and safeguard decisions, errors
    within 1e-5, transforms within 1e-5 RMSE."""
    s = f.synthetic_scene(width=16)
    src, tgt = np.array(s.source), np.array(s.target)
    jr, jacc = ja.run_aa_icp(jnp.asarray(src), jnp.asarray(tgt),
                             f.ICPConfig(max_iterations=iterations),
                             return_accepted=True)
    tr, tacc = ft.run_aa_icp(_t(src), _t(tgt),
                             ft.ICPConfig(max_iterations=iterations),
                             return_accepted=True)
    n = int(tr.num_iterations)
    assert n == int(jr.num_iterations)
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    np.testing.assert_allclose(tr.errors.numpy()[:n],
                               np.asarray(jr.errors)[:n], atol=ATOL)
    assert _rmse_between(tr.transform.rotation, tr.transform.translation,
                         jr.transform.rotation, jr.transform.translation,
                         src) < GAP


def test_chunked_history_within_jax_tolerance():
    """History in chunks (13 iterations) against
    ``fpcr_tpu.run_icp_with_history``: equal active rows, errors within
    1e-5, every accumulated transform within 1e-5 RMSE."""
    s = f.synthetic_scene(width=16)
    src, tgt = np.array(s.source), np.array(s.target)
    j = f.run_icp_with_history(jnp.asarray(src), jnp.asarray(tgt),
                               f.ICPConfig(max_iterations=13))
    t = ft.run_icp_with_history(_t(src), _t(tgt),
                                ft.ICPConfig(max_iterations=13))
    np.testing.assert_array_equal(t.active.numpy(), np.asarray(j.active))
    np.testing.assert_allclose(t.errors.numpy(), np.asarray(j.errors),
                               atol=ATOL)
    for k in range(13):
        assert _rmse_between(t.accumulated_rotations[k],
                             t.accumulated_translations[k],
                             j.accumulated_rotations[k],
                             j.accumulated_translations[k], src) < GAP


def _gn_float64(X, ei, ej, Z, w, iterations, damping=1e-6, anchor=1e6):
    """The same Gauss-Newton iteration in float64, assembled densely by
    loops (``tests/test_torch_odometry_pose_graph.py``'s reference)."""
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
            A = tp.se3_inv(X[i]) @ X[j]
            r = tp.se3_log(tp.se3_inv(Z[e]) @ A)
            Jj = torch.eye(6, dtype=torch.float64) + 0.5 * tp._ad_small(r)
            Ji = -Jj @ tp.se3_adjoint(tp.se3_inv(A))
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
        X = X @ tp.se3_exp((-torch.linalg.solve(H, g)).reshape(T, 6))
    return X.numpy()


def _odometry(pkg, X0, Z, T):
    """An ``OdometryResult``-like object of either package: the poses and
    the T−1 consecutive relative transforms."""
    arr = jnp.asarray if pkg is f else _t
    rel = pkg.RigidTransform(arr(Z[:T - 1, :3, :3]), arr(Z[:T - 1, :3, 3]))
    return types.SimpleNamespace(poses=arr(X0), relative=types.SimpleNamespace(
        transform=rel))


@pytest.mark.parametrize("weights", ["scalar", "full"])
def test_chunked_pose_graph_within_jax_tolerance(weights):
    """``optimize_pose_graph`` (13 iterations: a chunk of 8 and one of 5)
    and ``close_loops`` against the JAX package's: poses within 4x JAX's
    own gap to a float64 Gauss-Newton (at least 1e-5, at most 1e-3; the
    f32 Cholesky at the 1e6 anchor rounds apart in the two libraries,
    ``tests/test_torch_odometry_pose_graph.py``), residual RMS within 1e-5
    relative an iteration."""
    X0, ei, ej, Z, ws, wf = _graph(seed=1)
    w = ws if weights == "scalar" else wf
    j = jpg.optimize_pose_graph(jnp.asarray(X0), jnp.asarray(ei),
                                jnp.asarray(ej), jnp.asarray(Z),
                                jnp.asarray(w), iterations=13)
    t = ft.optimize_pose_graph(_t(X0), _t(ei), _t(ej), _t(Z), _t(w),
                               iterations=13)
    ref = _gn_float64(X0, ei, ej, Z, w, 13)
    jax_gap = np.abs(np.asarray(j.poses) - ref).max()
    gap = np.abs(t.poses.numpy() - np.asarray(j.poses)).max()
    assert gap <= min(1e-3, max(4 * jax_gap, 1e-5)), (gap, jax_gap)
    np.testing.assert_allclose(t.residual_rms.numpy(),
                               np.asarray(j.residual_rms), rtol=1e-5)
    T = X0.shape[0]
    lw = w[T - 1:]
    jc = jpg.close_loops(_odometry(f, X0, Z, T), jnp.asarray(ei[T - 1:]),
                         jnp.asarray(ej[T - 1:]), jnp.asarray(Z[T - 1:]),
                         jnp.asarray(lw), iterations=13)
    tc = ft.close_loops(_odometry(ft, X0, Z, T), _t(ei[T - 1:]),
                        _t(ej[T - 1:]), _t(Z[T - 1:]), _t(lw), iterations=13)
    odo_w = (np.ones(T - 1, np.float32) if weights == "scalar" else
             np.broadcast_to(np.eye(6, dtype=np.float32), (T - 1, 6, 6)))
    ref = _gn_float64(X0, ei, ej, Z, np.concatenate([odo_w, lw]), 13)
    jax_gap = np.abs(np.asarray(jc.poses) - ref).max()
    gap = np.abs(tc.poses.numpy() - np.asarray(jc.poses)).max()
    assert gap <= min(1e-3, max(4 * jax_gap, 1e-5)), (gap, jax_gap)
    np.testing.assert_allclose(tc.residual_rms.numpy(),
                               np.asarray(jc.residual_rms), rtol=1e-5)


def _wavy(n=1200, seed=2):
    """A random (non-grid) wavy saddle: no kNN near ties."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-2, 2, (n, 2))
    z = 0.25 * (xy[:, 0] ** 2 - xy[:, 1] ** 2) + 0.1 * np.sin(3 * xy[:, 0])
    return np.stack([xy[:, 0], xy[:, 1], z], 1).astype(np.float32)


def test_ransac_fed_jax_samples_within_jax_tolerance():
    """``_ransac`` as one chunk, fed the JAX package's correspondences and
    its ``categorical`` draws (key 0, 256 hypotheses of 3, τ = 0.05), on a
    wavy saddle under a 0.9-rad pose: the inlier count equal to
    ``fpcr_tpu.global_registration``'s, the transform within 1e-5 RMSE,
    the inlier RMSE within 1e-4 relative."""
    src = _wavy()
    gt = f.gt_transform((0.1, -0.05, 0.08), (0.3, 0.9, -0.4))
    tgt = np.array(gt.apply(jnp.asarray(src)))
    j = f.global_registration(jnp.asarray(src), jnp.asarray(tgt),
                              n_hypotheses=256, tau=0.05)
    s_j, t_j = jnp.asarray(src), jnp.asarray(tgt)
    n_s = j_orient(s_j, j_normals(s_j, k=8))
    n_t = j_orient(t_j, j_normals(t_j, k=8))
    f_s, f_t = j_fpfh(s_j, n_s, k=16), j_fpfh(t_j, n_t, k=16)
    fwd, _ = j_nn(f_s, f_t)
    back, _ = j_nn(j_gather(f_t, fwd), f_s)
    good = np.asarray(back == jnp.arange(src.shape[0]))
    q_corr = np.asarray(j_gather(t_j, fwd))
    samples = np.asarray(jax.random.categorical(
        jax.random.PRNGKey(0), jnp.where(jnp.asarray(good), 0.0, -1e30),
        shape=(256, 3)))
    R, t, n_inl, err = tg._ransac(_t(src), _t(q_corr), _t(good),
                                  _t(samples), torch.tensor(0.05), 3)
    assert int(n_inl) == int(j.num_inliers) > 100
    assert _rmse_between(R, t, j.transform.rotation, j.transform.translation,
                         src) < GAP
    np.testing.assert_allclose(float(err), float(j.inlier_rmse), rtol=1e-4)


def _umeyama_case(name):
    """Point sets whose normalised cross-covariance is random, a
    reflection (a mirrored target) or rank 2 (a plane cloud)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    p = rng.normal(size=(200, 3)).astype(np.float32)
    if name == "rank 2":
        p[:, 2] = 0.0
    gt = f.gt_transform((0.3, -0.2, 0.4), (0.2, -0.1, 0.3))
    q = 1.3 * np.array(gt.apply(jnp.asarray(p))) + rng.normal(
        0, 1e-3, p.shape).astype(np.float32)
    if name == "reflection":
        q[:, 1] = -q[:, 1]
    return p, q.astype(np.float32)


@pytest.mark.parametrize("name", ["random", "reflection", "rank 2"])
def test_umeyama_from_svd_plain_matches_jax(name):
    """The plain version of svd3's Umeyama form against
    ``fpcr_tpu.umeyama_transform`` on the same normalised cross-covariance:
    R within 1e-5, det R = +1, the scale (its trace over the source
    variance) within 1e-5 relative; reflections and rank 2 included."""
    p, q = _umeyama_case(name)
    sj, tj = f.umeyama_transform(jnp.asarray(p), jnp.asarray(q))
    dp = p.astype(np.float64) - p.mean(0)
    dq = q.astype(np.float64) - q.mean(0)
    W = torch.as_tensor((dq.T @ dp / len(p)).astype(np.float32))
    R, trace = tso.umeyama_from_svd_plain(W)
    np.testing.assert_allclose(R.numpy(), np.asarray(tj.rotation),
                               atol=1e-5)
    assert abs(float(torch.linalg.det(R.double())) - 1.0) < 1e-6
    var = float((dp * dp).sum(1).mean())
    np.testing.assert_allclose(float(trace) / var, float(sj), rtol=1e-5)
    # and the whole solve, which takes it on the CPU
    st, tt = ft.umeyama_transform(_t(p), _t(q))
    np.testing.assert_allclose(float(st), float(sj), rtol=1e-6)
    np.testing.assert_allclose(tt.rotation.numpy(), np.asarray(tj.rotation),
                               atol=1e-5)


def test_umeyama_from_svd_picks_the_plain_version_on_the_cpu():
    """On a CPU tensor ``umeyama_from_svd`` is its plain version, batched
    along leading axes, and launches nothing."""
    from fpcr_tpu_torch.ops.svd3_cuda import svd3_umeyama_cuda

    W = torch.as_tensor(np.random.default_rng(0).normal(
        size=(4, 3, 3)).astype(np.float32))
    before = svd3_umeyama_cuda.launches
    R, trace = tso.umeyama_from_svd(W)
    assert svd3_umeyama_cuda.launches == before
    for k in range(4):
        Rk, tk = tso.umeyama_from_svd_plain(W[k])
        np.testing.assert_allclose(R[k].numpy(), Rk.numpy(), atol=1e-6)
        np.testing.assert_allclose(float(trace[k]), float(tk), rtol=1e-6)
    with pytest.raises(ValueError, match="CUDA"):
        svd3_umeyama_cuda(W)


# ---- the captured route, rehearsed on the CPU ------------------------------

class _Recorder:
    """In place of ``graphs.bind``: records each chunk's keys, ``(the
    loop's key, the graph's key, k)``, and runs the chunk eagerly, as a
    replay would compute it: on a copy of the state, as a replay on its
    static buffers (a chunk may update its state in place)."""

    def __init__(self):
        self.keys = []

    def __call__(self, fn, consts):
        loop_key, _ = graphs.cache_key(fn, (consts,))

        def step(state, k):
            self.keys.append((loop_key, graphs.cache_key(fn, (state, k))[0],
                              k))
            return fn(graphs.owned(state), consts, k)
        step.finish = lambda: None  # nothing replayed, nothing to count
        return step


@contextlib.contextmanager
def _eager_route():
    """The loops' eager route inside a rehearsal: the CPU's."""
    saved = graphs.captured
    graphs.captured = lambda device: False
    try:
        yield
    finally:
        graphs.captured = saved


def _host_values(key):
    """The host values (``("V", type, value)``) of a cache key."""
    if isinstance(key, tuple):
        if len(key) == 3 and key[0] == "V":
            return [key[2]]
        return [v for item in key for v in _host_values(item)]
    return []


@pytest.fixture
def rehearse(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(graphs, "bind", rec)
    monkeypatch.setattr(graphs, "captured", lambda device: True)
    return rec


def _loop_runs():
    """``{name: (chunk function, run(shift))}``: each loop on fresh inputs
    of the same shapes (the target moved by ``shift``)."""
    src, tgt = _scene()
    vs, vt = (_t(a) for a in _volume(300))
    X0, ei, ej, Z, ws, _ = _graph()
    rng = np.random.default_rng(0)
    corr = torch.as_tensor(rng.uniform(-1, 1, (200, 3)).astype(np.float32))
    samples = torch.as_tensor(rng.integers(0, 200, (64, 3)))
    good = torch.ones(200, dtype=torch.bool)
    cfg = ft.ICPConfig(max_iterations=13, tolerance=0.0)
    return {
        "scaled": (tsc._scaled_chunk, lambda d: ft.run_scaled_icp(
            vs, vt + d, cfg)),
        "aa": (ta._aa_chunk, lambda d: ft.run_aa_icp(src, tgt + d, cfg)),
        "sgd": (tsg._sgd_chunk, lambda d: ft.run_sgd_icp(
            src, tgt + d, cfg, batch_size=64)),
        "history": (th._history_chunk, lambda d: ft.run_icp_with_history(
            src, tgt + d, cfg)),
        "pose graph": (tp._gn_chunk, lambda d: ft.optimize_pose_graph(
            _t(X0), _t(ei), _t(ej), _t(Z) + d, _t(ws), iterations=13)),
        "ransac": (tg._ransac_chunk, lambda d: tg._ransac(
            corr, corr + d, good, samples, torch.tensor(0.05), 3)),
    }


@pytest.mark.parametrize("name", list(_loop_runs()))
def test_loop_takes_the_graphs_and_repeats_its_key(rehearse, name):
    """Each loop runs by ``graphs.bind`` in chunks of 8 and a shorter last
    one (RANSAC in one chunk), and two calls on inputs of equal shapes give
    the same loop key and graph keys, so the second call's loop would
    capture and the third replay: no chunk body or constant is made anew
    at each call. The rehearsed run is the eager run bit for bit."""
    chunk, run = _loop_runs()[name]
    first = run(0.0)
    calls = len(rehearse.keys)
    second = run(0.01)
    keys = rehearse.keys
    assert calls and len(keys) == 2 * calls
    assert all(k[0][0] is chunk for k in keys)
    assert keys[:calls] == keys[calls:]
    assert [k[2] for k in keys[:calls]] == ([1] if name == "ransac"
                                            else [8, 5])
    assert len({k[0] for k in keys}) == 1
    with _eager_route():
        ref = run(0.0)
    _same(first, ref, name)
    assert not all(torch.equal(_bits(a), _bits(b)) for a, b in zip(
        _leaves(first), _leaves(second)))


def test_a_different_config_keys_another_graph(rehearse):
    """Another ``max_iterations`` keys the same AA-ICP loop (its chunk
    never reads it); another tolerance keys another loop, and another
    history length (a state of another shape) another graph of it."""
    src, tgt = _scene()
    for cfg in (ft.ICPConfig(max_iterations=8, tolerance=0.0),
                ft.ICPConfig(max_iterations=16, tolerance=0.0)):
        ft.run_aa_icp(src, tgt, cfg)
    assert len({k[:2] for k in rehearse.keys}) == 1
    ft.run_aa_icp(src, tgt, ft.ICPConfig(max_iterations=8, tolerance=1e-9))
    assert len({k[0] for k in rehearse.keys}) == 2
    ft.run_aa_icp(src, tgt, ft.ICPConfig(max_iterations=8, tolerance=0.0),
                  history=3)
    assert len({k[0] for k in rehearse.keys}) == 2
    assert len({k[:2] for k in rehearse.keys}) == 3


def _ndt_scene():
    """A scan of the 1,024-point synthetic cloud under a small pose, and
    the cloud (tests/test_torch_graph_loop.py's NDT scene)."""
    src, _ = _scene(32)
    gt = ft.gt_transform((0.004, -0.002, 0.003), (0.002, -0.003, 0.002),
                         device="cpu")
    return gt.apply(src), src


@pytest.fixture
def gloo_group(tmp_path):
    """A one-rank gloo process group in this process."""
    import torch.distributed as dist

    own = not dist.is_initialized()
    if own:
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                                rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        if own:
            dist.destroy_process_group()


def test_gloo_sharded_loops_run_eagerly(rehearse, gloo_group):
    """A gloo group's collectives run on the host: a sharded loop over it
    (``distributed_icp``, ``distributed_ndt``, a sharded history) never
    takes ``graphs.bind``, chosen by the backend before the loop, and a
    world of one stays ``run_icp`` / ``run_ndt`` bit for bit."""
    from fpcr_tpu_torch.parallel import dist_icp

    src, tgt = _scene()
    cfg = ft.ICPConfig(max_iterations=13)
    mesh = dist_icp.make_mesh()
    res = dist_icp.distributed_icp(src, tgt, cfg, mesh=mesh)
    hist = ft.run_icp_with_history(src, tgt, cfg, group=gloo_group)
    scan, cloud = _ndt_scene()
    ncfg = ft.NDTConfig(voxel_size=0.3, max_iterations=13, lookup="gather")
    ndt = dist_icp.distributed_ndt(scan, cloud, ncfg, mesh=mesh)
    assert rehearse.keys == []
    assert int(ndt.num_iterations) > 1
    with _eager_route():
        _same(res, ft.run_icp(src, tgt, cfg))
        _same(hist, ft.run_icp_with_history(src, tgt, cfg))
        _same(ndt, ft.run_ndt(scan, cloud, ncfg))


def test_nccl_sharded_loops_take_the_graphs(rehearse, gloo_group,
                                            monkeypatch):
    """A group whose backend is NCCL (the name patched; the collectives
    still run over gloo here) takes ``graphs.bind`` with its ``group`` in
    the loop's key: the sharded point loop, NDT's and the sharded
    history, in chunks of 8 and 5, each bit for bit the unsharded loop."""
    import torch.distributed as dist

    src, tgt = _scene()
    cfg = ft.ICPConfig(max_iterations=13, tolerance=0.0)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    res = mi._run_icp(src, tgt, cfg, group=gloo_group)
    hist = ft.run_icp_with_history(src, tgt, cfg, group=gloo_group)
    scan, cloud = _ndt_scene()
    grid = ft.build_ndt_grid(cloud, 0.3)
    ncfg = ft.NDTConfig(voxel_size=0.3, max_iterations=13, tolerance=0.0,
                        lookup="gather")
    ndt = mn._ndt_loop(scan, grid, ncfg, group=gloo_group)
    fns = [k[0][0] for k in rehearse.keys]
    assert fns == ([mi._icp_chunk] * 2 + [th._history_chunk] * 2
                   + [mn._ndt_chunk] * 2)
    assert [k[2] for k in rehearse.keys] == [8, 5] * 3
    assert all(any(v is gloo_group for v in _host_values(k[0]))
               for k in rehearse.keys)
    with _eager_route():
        _same(res, ft.run_icp(src, tgt, cfg))
        _same(hist, ft.run_icp_with_history(src, tgt, cfg))
        _same(ndt, mn._ndt_loop(scan, grid, ncfg))
