"""Sharded ICP and NDT: the source rows split over the ranks of a
``torch.distributed`` process group, the per-iteration sums all-reduced.

Counterpart of ``fpcr_tpu/parallel/dist_icp.py``. One process runs per GPU,
and the JAX mesh axis ``points`` becomes a process group: NCCL for CUDA
tensors, gloo for CPU tensors.

* Every rank holds the whole source and target, as JAX's ``in_specs``
  replicate them, and takes its own rows of the source, padded with zero
  rows to a multiple of the world size; the padded rows are masked out of
  every sum.
* The target is whole on every rank, so each rank's matches are global
  target indices.
* The loop is the single-process one (``models/icp.py::_run_icp``,
  ``models/ndt.py::_ndt_loop``) with ``group`` set: every sum over points
  is all-reduced, so every rank solves the same 3x3 or 6x6 system, and the
  loop state stays replicated by construction.
* Target normals, source normals (symmetric and GICP, on the whole source
  before sharding, since a shard's kNN would miss its neighbours across
  the cut), the matcher's Morton or voxel tables and the NDT grid are built
  on every rank from the same inputs. The operations that build them are
  deterministic (stable sorts, ``segment_reduce``, gathers; no atomics), so
  every rank holds the same bits: the tests and ``chip_smoke.py`` hold every
  rank's result bit-equal. Nothing is broadcast.
* The result is replicated on every rank; its ``points`` are all-gathered,
  unpadded, in the caller's row order.

A world of one rank equals ``run_icp`` / ``run_ndt`` bit for bit. Where the
source divides evenly, no mask is made, as for ``run_icp``.

The default group is the world group. NCCL needs CUDA tensors and gloo
reduces CPU tensors; a call on CUDA tensors with a gloo group is accepted
only when the caller passes that mesh, never by default. Numpy inputs land
on the card, as everywhere in the package. Without a process group
(``torch.distributed`` not initialised), :func:`make_mesh` gives a world of
one, which reduces nothing.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.cloud import as_points, round_up
from ..core.transforms import RigidTransform
from ..models.icp import (ICPConfig, ICPResult, _normals_prepass, _run_icp,
                          build_matcher_state, resolve_matcher)
from ..utils.precision import pin_f32_precision

AXIS = "points"  # the JAX mesh axis a mesh's process group stands for


class Mesh(NamedTuple):
    """A 1-D mesh of ranks along :data:`AXIS`: ``group`` (None for a
    world of one process without a process group), its ``size`` and this
    process's ``rank`` in it (-1 when the process is not a member)."""

    group: object
    size: int
    rank: int


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` ranks of the world (all by
    default). Past the world size it raises, as the JAX package's does past
    its device count. A sub-mesh makes a new process group, which every
    rank of the world must call for, in the same order (make it once and
    pass it); the ranks outside it get ``rank = -1``."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        if n_devices not in (None, 1):
            raise ValueError(f"requested {n_devices} ranks, have 1 (no "
                             "torch.distributed process group)")
        return Mesh(None, 1, 0)
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"requested {n} ranks, have {world}")
    group = (dist.group.WORLD if n == world
             else dist.new_group(ranks=list(range(n))))
    rank = dist.get_rank()
    return Mesh(group, n, rank if rank < n else -1)


def _pad_shardable(points: torch.Tensor, shards: int):
    """Pad to a multiple of ``shards`` with zero rows and return
    ``(padded, mask)``."""
    n = points.shape[0]
    cap = round_up(n, shards)
    if cap != n:
        points = torch.cat([points, points.new_zeros((cap - n,)
                                                     + points.shape[1:])])
    mask = torch.arange(cap, device=points.device) < n
    return points, mask


def _check_mesh(mesh: Mesh, device: torch.device, given: bool) -> Mesh:
    """``mesh`` checked against its tensors' device: NCCL reduces CUDA
    tensors, gloo CPU tensors, and gloo takes CUDA tensors only from a mesh
    the caller passed."""
    if mesh.rank < 0:
        raise ValueError("this process is not a rank of the mesh")
    if mesh.group is None:
        return mesh
    import torch.distributed as dist

    backend = str(dist.get_backend(mesh.group))
    if device.type == "cuda" and "nccl" not in backend and not given:
        raise ValueError(
            f"CUDA tensors and the default group's backend {backend!r}: "
            "initialise the process group with NCCL, or pass a mesh over a "
            "gloo group explicitly to reduce CUDA tensors through the host")
    if device.type == "cpu" and "gloo" not in backend:
        raise ValueError(f"CPU tensors cannot be reduced by {backend!r}; "
                         "use a gloo group for the CPU")
    return mesh


def _inputs(source, target, mesh: Optional[Mesh]):
    """Contiguous float32 clouds on the source's device and the checked
    mesh, the world by default."""
    source = as_points(source).contiguous()
    target = as_points(target, device=source.device).contiguous()
    given = mesh is not None
    return source, target, _check_mesh(mesh if given else make_mesh(),
                                       source.device, given)


def _shard(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    per = x.shape[0] // mesh.size
    return x[mesh.rank * per:(mesh.rank + 1) * per].contiguous()


def _all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ranks' equal-sized row blocks, concatenated in rank order on
    every rank: NCCL gathers on the card; gloo, which gathers no CUDA
    tensor, through the host."""
    if mesh.group is None or mesh.size == 1:
        return x
    import torch.distributed as dist

    x = x.contiguous()
    if x.device.type == "cuda" and "nccl" in str(
            dist.get_backend(mesh.group)):
        out = x.new_empty((mesh.size * x.shape[0],) + x.shape[1:])
        dist.all_gather_into_tensor(out, x, group=mesh.group)
        return out
    host = x.cpu()
    parts = [torch.empty_like(host) for _ in range(mesh.size)]
    dist.all_gather(parts, host, group=mesh.group)
    return torch.cat(parts).to(x.device)


def distributed_icp(source, target, config: ICPConfig = ICPConfig(),
                    mesh: Optional[Mesh] = None,
                    target_normals: Optional[torch.Tensor] = None,
                    target_mask: Optional[torch.Tensor] = None) -> ICPResult:
    """Run the convergence-gated ICP loop with the source sharded over the
    mesh's ranks (the world by default). Every rank of the mesh calls it
    with the same inputs and gets the same replicated ``ICPResult``, whose
    ``points`` are the whole transformed source in the input row order.
    Equal to ``run_icp`` up to the order of the sums (bit for bit on one
    rank)."""
    pin_f32_precision()
    source, target, mesh = _inputs(source, target, mesh)
    device = source.device
    n = source.shape[0]
    padded, mask = _pad_shardable(source, mesh.size)
    # the matcher is resolved for a shard's rows, before its tables are
    # built, so the tables match the matcher the loop runs
    config = resolve_matcher(config, padded.shape[0] // mesh.size)
    if target_mask is not None:
        target_mask = target_mask.to(device).contiguous()
    if config.metric in ("plane", "symmetric", "gicp"):
        target_normals = (_normals_prepass(target, target_mask, config)
                          if target_normals is None else
                          as_points(target_normals, device=device))
        target_normals = target_normals.contiguous()
    source_normals = None
    if config.metric in ("symmetric", "gicp"):
        source_normals = _shard(_pad_shardable(
            _normals_prepass(source, None, config), mesh.size)[0], mesh)
    matcher_state = (build_matcher_state(target, target_mask, config,
                                         target_normals)
                     if config.matcher in ("grid", "morton") else None)
    res = _run_icp(_shard(padded, mesh), target, config,
                   source_mask=None if padded.shape[0] == n
                   else _shard(mask, mesh),
                   target_mask=target_mask, target_normals=target_normals,
                   source_normals=source_normals,
                   matcher_state=matcher_state, group=mesh.group)
    return res._replace(points=_all_gather_rows(res.points, mesh)[:n])


def distributed_ndt(source, target, config=None, mesh: Optional[Mesh] = None,
                    target_mask: Optional[torch.Tensor] = None):
    """NDT registration with the source sharded over the mesh's ranks. The
    voxel Gaussian grid is built on every rank from the whole target; for
    the banded lookups the source is sorted by voxel key before it is
    sharded, so each shard holds a coherent block; H, g and the counters
    are all-reduced every iteration. Returns a replicated ``NDTResult``
    whose ``points`` are in the input row order; one rank equals
    ``run_ndt`` bit for bit."""
    from ..models.ndt import (NDTConfig, NDTResult, _ndt_loop,
                              _resolve_fused, _resolve_lookup,
                              resolve_voxel_size)
    from ..ops.ndt import build_ndt_grid, cell_key_order

    pin_f32_precision()
    source, target, mesh = _inputs(source, target, mesh)
    if target_mask is not None:
        target_mask = target_mask.to(source.device)
    config = resolve_voxel_size(config or NDTConfig(), target)
    grid = build_ndt_grid(target, config.voxel_size, target_mask,
                          min_points=config.min_points,
                          eig_ratio=config.eig_ratio)
    n = source.shape[0]
    config = _resolve_lookup(config, n)
    config = _resolve_fused(config, grid, source)
    src = source
    if config.lookup == "banded":
        # the global voxel-key sort comes before the sharding: each shard
        # is then a contiguous coherent block, as the band reads need
        src = source[cell_key_order(source, grid).long()].contiguous()
    padded, mask = _pad_shardable(src, mesh.size)
    R, t, it, errs, converged, frac = _ndt_loop(
        _shard(padded, mesh), grid, config,
        source_mask=None if padded.shape[0] == n else _shard(mask, mesh),
        group=mesh.group)
    tf = RigidTransform(rotation=R, translation=t)
    # every rank holds the whole source: its transformed rows are the
    # gathered, unsorted shards, in the input order
    return NDTResult(transform=tf, errors=errs, num_iterations=it,
                     converged=converged, points=tf.apply(source),
                     matched_fraction=frac)
