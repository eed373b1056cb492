"""The packed-reduction study on the card, the counterpart of
``scripts/exp_packed_reduction.py``:

    python -m fpcr_tpu_torch.bench.packed_reduction [n]

On the same inputs (``numpy.random.default_rng(0)``: q uniform in (-2, 2),
p = q + N(0, 0.3), N = M = n, 16,384 by default) it times, by CUDA events,
the three reductions of the brute-force NN sweep:

* the current kernel, K1 (``make_current``): min and argmin, on the CUDA
  cores (``_nn_argmin_cudacore``, the yardstick of the study's ratios), and
  the tensor-core K1 beside it;
* ``pint`` (``make_pint``): the packed (value|index) int32 min, which is
  kernel K2 with the index bits :func:`pint_idx_bits` takes from
  ``round_up(m, block_m)``. At 16,384 both of the script's block widths,
  8,192 and 4,096, give 14 bits and so the same launch, which is timed once
  (its source-block variants only tile the TPU grid and have no
  counterpart here);
* ``minonly`` (``make_minonly``): the least distance alone, the floor of
  the two, by the min-only sweep (``csrc/matching.cu``).

It prints each time and the share of rows whose index equals the CUDA-core
K1's.
"""

from __future__ import annotations

import sys
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.cloud import round_up
from ..ops.matching import nn_argmin_packed, pairwise_sqdist_exact
from ..ops.matching_cuda import (_nn_argmin_cudacore, nn_argmin_cuda,
                                 nn_min_only_cuda)
from ..utils.precision import pin_f32_precision
from ..utils.timing import cuda_time_ms


def pint_idx_bits(m: int, block_m: int = 8192) -> int:
    """``make_pint``'s index bits: ``bit_length(round_up(m, block_m) - 1)``."""
    return max(1, (round_up(m, block_m) - 1).bit_length())


def nn_argmin_pint(p: torch.Tensor, q: torch.Tensor,
                   block_m: int = 8192) -> Tuple[torch.Tensor, torch.Tensor]:
    """``make_pint``'s function (``_kern_pint``): K2's without a mask, with
    the index bits of :func:`pint_idx_bits`. ``(idx int32[N], the exact
    sqdist of the pick f32[N])``; K2 on a CUDA tensor, its plain version on
    a CPU tensor."""
    return nn_argmin_packed(p, q, idx_bits=pint_idx_bits(q.shape[0], block_m))


def nn_min_only_plain(p: torch.Tensor, q: torch.Tensor,
                      q_mask: Optional[torch.Tensor] = None, *,
                      source_chunk: int = 2048,
                      target_tile: int = 2048) -> torch.Tensor:
    """The plain PyTorch version of the min-only sweep, on any device: the
    least difference-form squared distance f32[N] to a valid target
    (``inf`` where none is valid), streamed over tiles."""
    p = p.to(torch.float32)
    q = q.to(torch.float32)
    best = torch.full((p.shape[0],), float("inf"), dtype=torch.float32,
                      device=p.device)
    for s0 in range(0, p.shape[0], source_chunk):
        for t0 in range(0, q.shape[0], target_tile):
            d = pairwise_sqdist_exact(p[s0:s0 + source_chunk],
                                      q[t0:t0 + target_tile])
            if q_mask is not None:
                valid = q_mask[t0:t0 + target_tile].to(torch.bool)
                d = torch.where(valid[None, :], d,
                                torch.full_like(d, float("inf")))
            best[s0:s0 + source_chunk] = torch.minimum(
                best[s0:s0 + source_chunk], d.amin(dim=1))
    return best


def nn_min_only(p: torch.Tensor,
                q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``make_minonly``'s function (``_kern_min``): an index of zeros and
    the least squared distance of every row, ``(int32[N], f32[N])``. The
    min-only sweep on a CUDA tensor, its plain version on a CPU tensor."""
    pin_f32_precision()
    if p.device.type == "cuda":
        d = nn_min_only_cuda(p, q)
    elif p.device.type == "cpu":
        d = nn_min_only_plain(p, q)
    else:
        raise ValueError(f"nn_min_only runs on CPU or CUDA tensors, got "
                         f"{p.device}")
    return torch.zeros(p.shape[0], dtype=torch.int32, device=p.device), d


def study_inputs(n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The script's inputs: q ~ U(-2, 2)^3, p = q + N(0, 0.3), float32."""
    rng = np.random.default_rng(0)
    q = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    p = (q + rng.normal(scale=0.3, size=(n, 3))).astype(np.float32)
    return (torch.as_tensor(p, device=device),
            torch.as_tensor(q, device=device))


def main(n: int = 16384) -> dict:
    """Time K1 on the CUDA cores (the study's yardstick) and on the tensor
    cores, pint (block width 8,192) and min-only at N = M = ``n`` on the
    card; print and return ``{variant: (ms, index agreement with K1)}``
    (agreement -1 for min-only, as the script)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the packed-reduction study needs a CUDA device")
    pin_f32_precision()
    dev = torch.device("cuda", 0)
    p, q = study_inputs(n, dev)
    idx_ref, _ = _nn_argmin_cudacore(p, q)
    variants = {
        "current(argmin+min) K1 CUDA-core": lambda: _nn_argmin_cudacore(p, q),
        "K1 tensor-core": lambda: nn_argmin_cuda(p, q),
        "pint K2": lambda: nn_argmin_pint(p, q),
        "minonly": lambda: nn_min_only(p, q),
    }
    out = {}
    card = torch.cuda.get_device_name(0)
    for name, fn in variants.items():
        idx, _ = fn()
        agree = (-1.0 if name == "minonly"
                 else float((idx == idx_ref).to(torch.float32).mean()))
        ms = cuda_time_ms(fn, repeats=20, warmup=3)["min"]
        print(f"{name}: {ms:.4f} ms  idx-agree {agree:.5f}  (N=M={n}, "
              f"min of 20 by CUDA events, {card})", flush=True)
        out[name] = (ms, agree)
    return out


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 16384)
