"""The split-distance study on the card (E4), the counterpart of
``scripts/exp_split_matmul.py``:

    python -m fpcr_tpu_torch.bench.split_matmul

The brute-force NN over the K-packed multi-bf16 distance of
``ops/split.py``: ``terms=6`` (K=48, f32 grade) and ``terms=3`` (K=24,
~2⁻¹⁶ of |p|² + |q|²), reduced by Kernel S (``csrc/split_mma.cu``) on the
tensor cores, against K1. On the script's inputs, the width-128 synthetic
scene, "far" = the source and "near" = the source after 12 iterations of
``run_icp``, it prints for each split the mismatches against K1, the
largest extra squared distance of its picks and the largest |d err|, then
times K1 on the CUDA cores (``ref K1 CUDA-core``, the study's
yardstick) and x6 / x3 by CUDA events, min of 20. The script's
``block_n`` sweep tiles the TPU grid and has no counterpart here.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.cloud import round_up
from ..data.synthetic import synthetic_scene
from ..models.icp import ICPConfig, run_icp
from ..ops.matching import gather_correspondences
from ..ops.matching_cuda import _nn_argmin_cudacore
from ..ops.split import split_nn, split_operands
from ..utils.precision import pin_f32_precision
from ..utils.timing import cuda_time_ms


def split_pads(n: int, m: int, block_n: int = 256,
               block_m: int = 8192) -> Tuple[int, int]:
    """The script's pads: ``round_up(n, min(block_n, round_up(n, 8)))``
    and ``round_up(m, min(block_m, round_up(m, 128)))``."""
    bn = min(block_n, round_up(n, 8))
    bm = min(block_m, round_up(m, 128))
    return round_up(n, bn), round_up(m, bm)


def nn_argmin_split(p: torch.Tensor, q: torch.Tensor, terms: int = 6,
                    block_n: int = 256,
                    block_m: int = 8192) -> Tuple[torch.Tensor, torch.Tensor]:
    """``nn_argmin_packed``'s function: the first-minimum argmin over the
    ``terms``-term split distance, the distance clamped at 0. ``(idx
    int32[N], d f32[N])``; Kernel S on a CUDA tensor, its plain version on
    a CPU tensor, a raise otherwise."""
    n, m = p.shape[0], q.shape[0]
    p_in, q_in = split_operands(p, q, terms, *split_pads(n, m, block_n,
                                                        block_m))
    return split_nn(p_in, q_in, n, m, "argmin", clamp=True)


def main() -> dict:
    """Run the study on the card; print and return ``{"x6 far": (mism, max
    extra sqdist, max |d err|), ..., "ref K1 CUDA-core": ms, "x6": ms,
    "x3": ms}``."""
    if not torch.cuda.is_available():
        raise RuntimeError("the split-distance study needs a CUDA device")
    pin_f32_precision()
    dev = torch.device("cuda", 0)
    scene = synthetic_scene(width=128, device=dev)
    src, tgt = scene.source, scene.target
    near = run_icp(src, tgt, ICPConfig(max_iterations=12)).points.contiguous()
    card = torch.cuda.get_device_name(0)
    out = {}
    for terms in (6, 3):
        for tag, p in (("far", src), ("near", near)):
            i_ref, d_ref = _nn_argmin_cudacore(p, tgt)
            i_sp, d_sp = nn_argmin_split(p, tgt, terms=terms)
            mism = int((i_ref != i_sp).sum())
            q_ref = gather_correspondences(tgt, i_ref)
            q_sp = gather_correspondences(tgt, i_sp)
            worse = float(((p - q_sp) ** 2).sum(1).sub(
                ((p - q_ref) ** 2).sum(1)).max())
            err = float((d_sp - d_ref).abs().max())
            print(f"x{terms} {tag}: mism {mism}/{p.shape[0]}, max extra "
                  f"sqdist {worse:.3e}, max |d err| {err:.3e}", flush=True)
            out[f"x{terms} {tag}"] = (mism, worse, err)
    runs = {"ref K1 CUDA-core": lambda: _nn_argmin_cudacore(src, tgt),
            "x6": lambda: nn_argmin_split(src, tgt, terms=6),
            "x3": lambda: nn_argmin_split(src, tgt, terms=3)}
    for name, fn in runs.items():
        ms = cuda_time_ms(fn, repeats=20, warmup=3)["min"]
        print(f"{name}: {ms:.4f} ms (N=M={src.shape[0]}, min of 20 by CUDA "
              f"events, {card})", flush=True)
        out[name] = ms
    return out


if __name__ == "__main__":
    main()
