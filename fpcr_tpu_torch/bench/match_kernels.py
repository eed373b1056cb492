"""The distance-form study on the card (E1), the counterpart of
``scripts/exp_match_kernels.py``:

    python -m fpcr_tpu_torch.bench.match_kernels [n]

The brute-force NN under the script's distance forms, on the CUDA cores as
the script computed them (HIGHEST f32), each with its output formula
(``ops/matching.py::nn_e1``): v0, kernel K1's function on the CUDA cores
(the difference form, ``_nn_argmin_cudacore``, the yardstick of the
studies' ratios since the tensor-core K1 took its place); v1 and
v3 (one function), the biased form ``|q|² + C − 2p·q`` with an argmin; v2
its packed key; v4 the expansion ``(|q|² − 2p·q) + |p|²`` packed; v5 and
v6 the 5-lane sum p̂·q̂, packed and argmin. On the script's inputs
(``numpy.random.default_rng(0)``: p, then q, uniform in ±300, N = M = n,
16,384 by default) it prints for each the index parity with the float64
oracle and the largest relative error of the picked distance, and times
each function once by CUDA events, min of 20. A failing variant raises.
The script's (bn, bm) sweep tiles the TPU grid and has no counterpart,
except that ``block_m`` sets the packed variants' index bits.
"""

from __future__ import annotations

import sys
from typing import Callable, Tuple

import numpy as np
import torch

from ..ops.matching import nn_e1
from ..ops.matching_cuda import _nn_argmin_cudacore
from ..utils.precision import pin_f32_precision
from ..utils.timing import cuda_time_ms

VARIANTS = ("v0", "v1", "v2", "v3", "v4", "v5", "v6")


def study_inputs(n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The script's inputs: p and then q uniform in (−300, 300)³, f32."""
    rng = np.random.default_rng(0)
    p = rng.uniform(-300, 300, (n, 3)).astype(np.float32)
    q = rng.uniform(-300, 300, (n, 3)).astype(np.float32)
    return (torch.as_tensor(p, device=device),
            torch.as_tensor(q, device=device))


def exact_oracle(p: torch.Tensor, q: torch.Tensor,
                 chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """The float64 difference-form NN ``(idx int64[N], d float64[N])``,
    in source chunks, on the inputs' device."""
    p64, q64 = p.double(), q.double()
    idx = torch.empty(p.shape[0], dtype=torch.int64, device=p.device)
    d = torch.empty(p.shape[0], dtype=torch.float64, device=p.device)
    for s in range(0, p.shape[0], chunk):
        blk = ((p64[s:s + chunk, None, :] - q64[None]) ** 2).sum(-1)
        d[s:s + chunk], idx[s:s + chunk] = blk.min(1)
    return idx, d


def check_correct(fn: Callable, p, q, exact_idx, exact_d,
                  name: str) -> Tuple[float, float]:
    """The script's ``check_correct``: index parity with the oracle and the
    largest relative error of the picked target's float64 distance."""
    idx, _ = fn()
    idx = idx.long()
    parity = float((idx == exact_idx).double().mean())
    d_chosen = ((p.double() - q.double()[idx]) ** 2).sum(1)
    rel = float(((d_chosen - exact_d).abs()
                 / exact_d.clamp_min(1e-12)).max())
    print(f"  [{name}] idx parity {parity:.6f}, max rel dist err "
          f"{rel:.3e}", flush=True)
    return parity, rel


def main(n: int = 16384, block_m: int = 8192) -> dict:
    """Run the study on the card; print and return ``{variant: (parity,
    max rel err, ms)}``; v3 is timed as v1, the same launch."""
    if not torch.cuda.is_available():
        raise RuntimeError("the distance-form study needs a CUDA device")
    pin_f32_precision()
    p, q = study_inputs(n, torch.device("cuda", 0))
    exact_idx, exact_d = exact_oracle(p, q)
    card = torch.cuda.get_device_name(0)
    out, timed = {}, {}
    for name in VARIANTS:
        fn = ((lambda: _nn_argmin_cudacore(p, q)) if name == "v0"
              else (lambda name=name: nn_e1(p, q, name, block_m)))
        parity, rel = check_correct(fn, p, q, exact_idx, exact_d, name)
        key = "v1" if name == "v3" else name
        if key not in timed:
            timed[key] = cuda_time_ms(fn, repeats=20, warmup=3)["min"]
        print(f"  [{name}] {timed[key]:.4f} ms (N=M={n}, min of 20 by CUDA "
              f"events, {card})", flush=True)
        out[name] = (parity, rel, timed[key])
    return out


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 16384)
