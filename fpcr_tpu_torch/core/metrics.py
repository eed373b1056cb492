"""Registration error metrics.

The reference's per-iteration error is the Frobenius RMS of the residual
between the transformed source and its matched target points,
``E = ||p - q_idx||_F / sqrt(N)``. Every metric is mask-aware; a mask may
be boolean (valid/invalid) or float (IRLS weights).

Sums over points take ``group``, a ``torch.distributed`` process group over
which the rows are sharded (``parallel/dist_icp.py``): :func:`_psum` and
:func:`_psum_all` all-reduce the local sums over it, where the JAX package
``psum``s over a mesh axis. ``group=None`` reduces nothing and leaves every
result as it was, bit for bit.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .. import _build


def _all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` in place over ``group``'s ranks; every all-reduce adds one
    to ``_psum.launches``."""
    import torch.distributed as dist

    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    _psum.launches += 1
    return x


def _psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (a copy; ``x`` is left as
    it is), or ``x`` itself for ``group=None``."""
    return x if group is None else _all_reduce_(x.clone(), group)


_build.counted(_psum)  # all-reduces made through it


def _psum_all(xs: Sequence[torch.Tensor], group=None
              ) -> Tuple[torch.Tensor, ...]:
    """Sums that do not depend on each other, reduced by one all-reduce of
    their concatenation (elementwise the same SUM as one ``_psum`` each);
    the tensors come back in their shapes. ``group=None``: ``xs`` as given."""
    if group is None:
        return tuple(xs)
    flat = _all_reduce_(torch.cat([x.reshape(-1) for x in xs]), group)
    out, at = [], 0
    for x in xs:
        out.append(flat[at:at + x.numel()].reshape(x.shape))
        at += x.numel()
    return tuple(out)


def masked_count(mask: Optional[torch.Tensor], n: int, dtype,
                 device=None, group=None) -> torch.Tensor:
    if mask is None:
        # a fill on the device: torch.tensor would copy from the host and
        # synchronise
        count = torch.full((), float(n), dtype=dtype, device=device)
    else:
        count = mask.to(dtype).sum(dim=-1)
    return _psum(count, group)


def rmse(p: torch.Tensor, q: torch.Tensor,
         mask: Optional[torch.Tensor] = None, group=None) -> torch.Tensor:
    """``sqrt(sum_i w_i ||p_i - q_i||^2 / sum_i w_i)`` over ``[N, 3]`` pairs —
    the reference's ``Snrm2 / sqrt(N)`` when ``mask`` is None; ``[B, N,
    3]`` pairs with a ``[B, N]`` mask give one value an element. Both sums
    are taken over ``group``'s ranks in one all-reduce."""
    diff = p - q
    sq = torch.sum(diff * diff, dim=-1)
    if mask is not None:
        sq = sq * mask.to(sq.dtype)
    total, count = _psum_all(
        (sq.sum(dim=-1), masked_count(mask, p.shape[-2], p.dtype, p.device)),
        group)
    return torch.sqrt(total / torch.clamp(count, min=1.0))


def transform_rmse(t_est, t_ref, probe_points: torch.Tensor) -> torch.Tensor:
    """RMS discrepancy of two transforms measured on probe points (the
    parity measure of BASELINE.md: 1e-5 on Bunny and the hall scan)."""
    return rmse(t_est.apply(probe_points), t_ref.apply(probe_points))


def evaluate_registration(source, target, transform=None, *,
                          max_correspondence_dist=None,
                          target_mask: Optional[torch.Tensor] = None,
                          source_chunk: int = 2048, target_tile: int = 2048):
    """Post-hoc quality of an alignment, the PCL/Open3D convention: apply
    ``transform`` (None = identity), match every source point to its nearest
    target point (``nn_argmin(exact=True)``: kernel K1 on a CUDA tensor) and
    report over the matches within ``max_correspondence_dist`` (None = 2x
    the target's median point spacing, ``ops.grid.suggest_cell_size``):

    * ``fitness``: inlier matches / N;
    * ``inlier_rmse``: RMS Euclidean distance over the inliers;
    * ``num_inliers``: the inlier count (int32);
    * ``max_correspondence_dist``: the gate used.

    Metric-independent, so it checks any result. Returns a dict of 0-d
    tensors on the source's device."""
    from ..core.cloud import as_points
    from ..ops.grid import suggest_cell_size
    from ..ops.matching import nn_argmin
    from ..utils.precision import pin_f32_precision

    pin_f32_precision()  # the transform's matmul too
    source = as_points(source)
    target = as_points(target, device=source.device)
    if max_correspondence_dist is None:
        max_correspondence_dist = suggest_cell_size(target, scale=2.0)
    gate = torch.as_tensor(max_correspondence_dist, dtype=torch.float32,
                           device=source.device)
    pts = source if transform is None else transform.apply(source)
    # the difference form: the expansion's ~1e-7 rounding in squared units
    # would floor the reported RMSE at ~3e-4
    _, dmin = nn_argmin(pts.contiguous(), target.contiguous(), target_mask,
                        exact=True, source_chunk=source_chunk,
                        target_tile=target_tile)
    inlier = dmin <= gate * gate
    num = inlier.sum(dtype=torch.int32)
    mse = (torch.where(inlier, torch.clamp(dmin, min=0.0),
                       torch.zeros_like(dmin)).sum()
           / torch.clamp(num, min=1).to(torch.float32))
    return {"fitness": num.to(torch.float32) / pts.shape[0],
            "inlier_rmse": torch.sqrt(mse), "num_inliers": num,
            "max_correspondence_dist": gate}
