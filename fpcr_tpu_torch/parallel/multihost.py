"""Multi-process initialisation from a launcher's environment.

Counterpart of ``fpcr_tpu/parallel/multihost.py``. Where the JAX package
reads ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
``JAX_PROCESS_ID`` and calls ``jax.distributed.initialize``, this module
reads what ``torchrun`` sets for every process (``MASTER_ADDR`` /
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``) and calls
``torch.distributed.init_process_group``: NCCL with the process on
``cuda:LOCAL_RANK``, or gloo when the caller asks for the CPU. Then
``parallel.dist_icp`` runs unchanged: ``make_mesh()`` spans the world, and
the per-iteration all-reduces carry a few hundred bytes.

One process (the CLI without a launcher, the tests' single-process calls)
needs none of this; every function is a no-op or a guard there.
"""

from __future__ import annotations

import os
from typing import Optional

import torch


def _launcher_env(coordinator_address: Optional[str],
                  num_processes: Optional[int],
                  process_id: Optional[int]) -> Optional[dict]:
    """``{init_method, world_size, rank, local_rank}`` from the arguments,
    else the launcher's variables; None without a coordinator address."""
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if coordinator_address is None:
        return None
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(env.get("RANK", "0"))
    return {"init_method": f"tcp://{coordinator_address}",
            "world_size": num_processes, "rank": process_id,
            "local_rank": int(env.get("LOCAL_RANK", "0"))}


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *,
                         cpu: bool = False) -> bool:
    """Initialise ``torch.distributed`` from the arguments or the launcher's
    environment. Returns True if a process group is in force (one already
    initialised included), False for a single process. NCCL puts this
    process on ``cuda:LOCAL_RANK``; ``cpu=True`` takes gloo instead."""
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    cfg = _launcher_env(coordinator_address, num_processes, process_id)
    if cfg is None:
        return False  # single-process
    if cpu:
        backend = "gloo"
    else:
        backend = "nccl"
        torch.cuda.set_device(cfg["local_rank"])
    dist.init_process_group(backend, init_method=cfg["init_method"],
                            world_size=cfg["world_size"], rank=cfg["rank"])
    return True


def _world() -> tuple:
    """``(process count, this process's index)``; ``(1, 0)`` alone."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def is_multihost() -> bool:
    return _world()[0] > 1


def local_shard_bounds(n: int) -> tuple:
    """Row range of the global source cloud this process should load, so no
    process materialises the whole cloud: ``ceil(n / processes)`` rows a
    process, the last one short."""
    pc, pid = _world()
    per = (n + pc - 1) // pc
    lo = pid * per
    return lo, min(lo + per, n)
