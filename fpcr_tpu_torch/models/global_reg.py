"""Global registration: FPFH correspondences and batched RANSAC, from any
initial pose, then ICP.

Counterpart of ``fpcr_tpu/models/global_reg.py``: oriented normals → FPFH
(33-D) on strided subsets of both clouds → feature nearest neighbours,
mutually filtered (``ops/matching.py::nn_argmin_features``, the streaming
expansion JAX computes in XLA) → ``n_hypotheses`` minimal samples solved by
one batched Kabsch (a batched 3x3 SVD) and scored against every good
correspondence in one ``[hypotheses, C]`` residual matrix → masked-Kabsch
refinement over the best hypothesis' inliers, all of RANSAC one CUDA graph
on the card from the second call of its shapes on. :func:`register_global`
then refines with ``run_icp`` (kernel K1 on the card).

The RANSAC draws: the JAX package samples with ``jax.random.categorical``
over the good correspondences, which torch cannot reproduce. Here they come
from a ``torch.Generator`` on the cloud's device seeded by ``seed`` (uniform
among the good correspondences, with replacement, as the categorical), so a
seed gives other samples than JAX's key, and other ones on the CPU and the
card. The private :func:`_ransac` takes the ``[n_hypotheses, sample_size]``
samples, so the tests feed JAX's draws through it.

As in the JAX package, scenes with a symmetry have several correct answers:
the synthetic saddle maps onto itself under a 180° turn about (1,1,0)/√2.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.cloud import as_points
from ..core.transforms import RigidTransform
from ..ops.fpfh import fpfh_features
from ..ops.grid import suggest_cell_size
from ..ops.matching import gather_correspondences, nn_argmin_features
from ..ops.normals import estimate_normals, orient_normals
from ..ops.solve import kabsch_transform
from ..utils.precision import pin_f32_precision
from .icp import drive_chunks


class GlobalRegResult(NamedTuple):
    transform: RigidTransform  # source -> target estimate
    num_inliers: torch.Tensor  # int32: inliers of the refined hypothesis
    num_correspondences: torch.Tensor  # int32: mutual matches kept
    inlier_rmse: torch.Tensor  # RMSE over the final inlier set
    tau: torch.Tensor  # the distance threshold used


def _estimate_spacing(cloud: torch.Tensor, sample: int = 1024
                      ) -> torch.Tensor:
    """The median nearest-neighbour spacing of a subsample (without
    zero-distance duplicates, ``ops.grid.suggest_cell_size``), the scale of
    the RANSAC inlier threshold."""
    return torch.clamp(suggest_cell_size(cloud, sample=sample, scale=1.0),
                       min=1e-12)


def _correspondences(src_sel, tgt_sel, k_normals: int, k_feature: int,
                     mutual: bool):
    """FPFH on both subsets and their feature nearest neighbours:
    ``(q_corr [C, 3], good [C] bool)``."""
    n_s = orient_normals(src_sel, estimate_normals(src_sel, k=k_normals))
    n_t = orient_normals(tgt_sel, estimate_normals(tgt_sel, k=k_normals))
    f_sel = fpfh_features(src_sel, n_s, k=k_feature)
    f_t = fpfh_features(tgt_sel, n_t, k=k_feature)
    fwd, _ = nn_argmin_features(f_sel, f_t)
    q_corr = gather_correspondences(tgt_sel, fwd)
    if not mutual:
        return q_corr, torch.ones(src_sel.shape[0], dtype=torch.bool,
                                  device=src_sel.device)
    # a mutual pair: each other's nearest feature
    back, _ = nn_argmin_features(gather_correspondences(f_t, fwd), f_sel)
    return q_corr, back == torch.arange(src_sel.shape[0], dtype=back.dtype,
                                        device=back.device)


def _inliers(R, t, src_sel, q_corr, good, tau):
    r2 = torch.sum((torch.matmul(src_sel, R.T) + t - q_corr) ** 2, dim=-1)
    return r2, (r2 < tau * tau) & good


def _ransac_chunk(state, consts, k: int):
    """:func:`_ransac` as one chunk of ``models/icp.py::drive_chunks``:
    ``consts`` is ``(src_sel, q_corr, good, samples, tau,
    refine_rounds)``; the result ``(R, t, num_inliers, inlier_rmse)`` is
    the chunk's state (the one passed in is not read), its rows ``[k,
    0]``. A pure function of its tensors, with no host read: on the card
    one CUDA graph."""
    src_sel, q_corr, good, samples, tau, refine_rounds = consts
    samples = samples.long()
    hyp = kabsch_transform(src_sel[samples], q_corr[samples])  # batched
    proj = (torch.matmul(src_sel, hyp.rotation.transpose(1, 2))
            + hyp.translation[:, None, :])  # [H, C, 3]
    resid2 = torch.sum((proj - q_corr[None]) ** 2, dim=-1)
    scores = ((resid2 < tau * tau) & good[None]).sum(dim=1)
    # the first maximum, gathered on the device: ``[best]`` with a 0-d
    # tensor would read it on the host
    best = torch.argmax(scores).reshape(1)
    R = torch.index_select(hyp.rotation, 0, best)[0]
    t = torch.index_select(hyp.translation, 0, best)[0]
    for _ in range(refine_rounds):
        _, inl = _inliers(R, t, src_sel, q_corr, good, tau)
        R, t = kabsch_transform(src_sel, q_corr, inl)
    r2, inl = _inliers(R, t, src_sel, q_corr, good, tau)
    n_inl = inl.sum()
    rmse = torch.sqrt(torch.where(inl, r2, torch.zeros_like(r2)).sum()
                      / torch.clamp(n_inl, min=1))
    return ((R, t, n_inl.to(torch.int32), rmse),
            torch.zeros((k, 0), device=src_sel.device))


def _ransac(src_sel: torch.Tensor, q_corr: torch.Tensor, good: torch.Tensor,
            samples: torch.Tensor, tau: torch.Tensor, refine_rounds: int):
    """Score the minimal-sample hypotheses ``samples`` [H, s] (indices into
    the correspondences), keep the best (the first of the most inliers),
    refine it ``refine_rounds`` times by Kabsch over its inliers:
    ``(R, t, num_inliers, inlier_rmse)``. On the card, from the second
    call of its shapes on, it runs as one CUDA graph
    (``models/icp.py::drive_chunks``, one chunk), with no host read."""
    device = src_sel.device
    result = (torch.eye(3, device=device), torch.zeros(3, device=device),
              torch.zeros((), dtype=torch.int32, device=device),
              torch.zeros((), device=device))
    consts = (src_sel, q_corr, good, samples, tau, int(refine_rounds))
    result, _ = drive_chunks(_ransac_chunk, result, consts, 1,
                             lambda st: False, (0,))
    return result


def global_registration(source, target, *, seed: int = 0,
                        k_normals: int = 8, k_feature: int = 16,
                        n_hypotheses: int = 1024, sample_size: int = 3,
                        max_correspondences: int = 4096,
                        tau: Optional[float] = None, refine_rounds: int = 3,
                        mutual: bool = True) -> GlobalRegResult:
    """Estimate the source → target rigid transform with no initial guess,
    on the source's device (the card unless the caller passes CPU tensors).

    Both clouds are strided first (the source to ``max_correspondences``
    rows, the target to twice that), then described; ``tau`` (the inlier
    distance) defaults to 3× the strided target's median spacing. Refine
    the result with ``run_icp`` (:func:`register_global`)."""
    pin_f32_precision()
    source = as_points(source).contiguous()
    target = as_points(target, device=source.device).contiguous()
    src_sel, q_corr, good, samples, tau_val = _ransac_inputs(
        source, target, seed, k_normals, k_feature, n_hypotheses,
        sample_size, max_correspondences, tau, mutual)
    R, t, n_inl, rmse = _ransac(src_sel, q_corr, good, samples, tau_val,
                                refine_rounds)
    return GlobalRegResult(transform=RigidTransform(R, t), num_inliers=n_inl,
                           num_correspondences=good.sum().to(torch.int32),
                           inlier_rmse=rmse, tau=tau_val)


def _ransac_inputs(source, target, seed: int, k_normals: int,
                   k_feature: int, n_hypotheses: int, sample_size: int,
                   max_correspondences: int, tau: Optional[float],
                   mutual: bool):
    """:func:`global_registration`'s feature stage, eager: both clouds
    strided, described and matched, and the hypotheses drawn: ``(src_sel,
    q_corr, good, samples, tau)``."""
    stride = max(1, -(-source.shape[0] // max_correspondences))
    src_sel = source[::stride].contiguous()
    t_stride = max(1, -(-target.shape[0] // (2 * max_correspondences)))
    tgt_sel = target[::t_stride].contiguous()
    tau_val = (3.0 * _estimate_spacing(tgt_sel) if tau is None else
               torch.full((), float(tau), device=source.device))
    q_corr, good = _correspondences(src_sel, tgt_sel, k_normals, k_feature,
                                    mutual)
    # the categorical over `good`: uniform among the good correspondences,
    # over all of them where none is good
    gen = torch.Generator(device=source.device)
    gen.manual_seed(seed)
    weights = torch.where(good.any(), good.to(torch.float32),
                          torch.ones_like(good, dtype=torch.float32))
    samples = torch.multinomial(weights, n_hypotheses * sample_size,
                                replacement=True, generator=gen).reshape(
                                    n_hypotheses, sample_size)
    return src_sel, q_corr, good, samples, tau_val


def register_global(source, target, config=None, **kwargs):
    """Global registration, then ICP refinement: the unknown-initial-pose
    workflow. Returns the refined ``ICPResult`` whose transform is the
    composition (ICP increment ∘ RANSAC estimate); ``kwargs`` go to
    :func:`global_registration`."""
    from .icp import ICPConfig, run_icp

    source = as_points(source)
    coarse = global_registration(source, target, **kwargs)
    res = run_icp(coarse.transform.apply(source), target,
                  config or ICPConfig())
    return res._replace(transform=res.transform.compose(coarse.transform))
