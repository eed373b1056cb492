"""The reduction study of the split distance on the card (E3), the
counterpart of ``scripts/exp_reduction2.py``:

    python -m fpcr_tpu_torch.bench.reduction2

Seven reductions of the K=48 bf16x6 split distance (``ops/split.py``), each
through Kernel S (``csrc/split_wgmma.cu``) with the epilogue its function
needs. On the TPU they were seven ablated kernels; here variants that
compute one function share one launch:

* ``fullx``, ``hier``, ``ts``: the first-minimum argmin (epilogue
  ``'argmin'``), the distance unclamped;
* ``packed``, ``packed_ts``: the int32 min of ``(bits(max(d, 0)) &
  ~0x3FFF) | col``, returned as the index and the key read as f32
  (``'packed14'``; it raises past 2^14 padded targets);
* ``minonly``: the least distance, an index of zeros (``'min'``);
* ``mmonly``: the distance to column ``(m_pad/bm − 1)·bm``, the one the
  script's last grid step leaves, an index of zeros (``'keep'``): every
  product issued, one column read.

``main`` runs the script's inputs (the 128² saddle grid and ``tgt = src +
0.01``) and its gates (:func:`check_gates`, where a tie within the split's
precision counts as agreeing with K1's exact pick), raising when one fails,
then times K1 on the CUDA cores (``full_lib K1 CUDA-core``) and each
function once by CUDA events, min of 20, printed under every name that
computes it. The script's ``blocks`` sweep tiles the TPU grid and has
no counterpart here.
"""

from __future__ import annotations

import json
from typing import Tuple

import numpy as np
import torch

from ..core.cloud import round_up
from ..ops.matching_cuda import _nn_argmin_cudacore
from ..ops.split import split_nn, split_operands
from ..utils.precision import pin_f32_precision
from ..utils.timing import cuda_time_ms

VARIANTS = ("mmonly", "minonly", "hier", "fullx", "packed", "ts",
            "packed_ts")
EPILOGUE = {"fullx": "argmin", "hier": "argmin", "ts": "argmin",
            "packed": "packed14", "packed_ts": "packed14", "minonly": "min",
            "mmonly": "keep"}


def run_variant(p: torch.Tensor, q: torch.Tensor, variant: str = "fullx",
                bm: int = 8192) -> Tuple[torch.Tensor, torch.Tensor]:
    """One variant of the script's ``run_variant``: ``(idx int32[N], d
    f32[N])``. ``bm`` sets ``m_pad = round_up(M, bm)``, and with it
    ``mmonly``'s kept column and the packed key's 2^14 gate. Kernel S on a
    CUDA tensor, its plain version on a CPU tensor."""
    n, m = p.shape[0], q.shape[0]
    m_pad = round_up(m, bm)
    p_in, q_in = split_operands(p, q, 6, n, m_pad)
    return split_nn(p_in, q_in, n, m, EPILOGUE[variant],
                    keep=(m_pad // bm - 1) * bm)


def study_inputs(device, n: int = 16384) -> Tuple[torch.Tensor, torch.Tensor]:
    """The script's inputs: the saddle z = x² − y² on a ⌈√n⌉² grid over
    [−1, 1]², its first n points, and the target ``src + 0.01``."""
    w = int(np.ceil(np.sqrt(n)))
    ax = np.linspace(-1, 1, w, dtype=np.float32)
    xs, ys = np.meshgrid(ax, ax, indexing="ij")
    pts = np.stack([xs.ravel(), ys.ravel(), (xs * xs - ys * ys).ravel()], 1)
    src = torch.as_tensor(pts[:n], device=device)
    return src, src + 0.01


def _sqdist64(p, q, idx):
    return ((p.double() - q.double()[idx.long()]) ** 2).sum(1)


def check_gates(src, tgt, i_lib, bm: int = 8192) -> dict:
    """The script's gates, raising where one fails: ``fullx``, ``hier`` and
    ``ts`` pick as K1 on more than 0.999 of the rows; ``packed`` equals
    ``packed_ts``; ``packed`` swaps fewer than 5e-3 of the rows against K1
    and its extra squared distance stays under 1e-5.

    On the TPU, K1 computed this same split distance; the port's K1
    computes the exact difference form, so a row may also pick otherwise
    where its two candidates tie within the split's f32 grade, 8 ulp of
    2 (|p|² + max |q|²) (``bench/kernel_checks.py``). Such a tie counts as
    agreeing; any other difference fails the gate. Both shares print."""
    tol = 8 * 2.0 ** -23 * 2 * ((src.double() ** 2).sum(1)
                                + (tgt.double() ** 2).sum(1).max())
    gates = {}
    for v in ("fullx", "hier", "ts"):
        i_v, _ = run_variant(src, tgt, v, bm)
        same = i_v == i_lib
        gap = (_sqdist64(src, tgt, i_v) - _sqdist64(src, tgt, i_lib)).abs()
        tied = ~same & (gap <= tol)
        if bool((~same & ~tied).any()):
            raise AssertionError(f"E3 {v}: a pick differs from K1's beyond "
                                 "a tie of the split's precision")
        share = float((same | tied).double().mean())
        gates[f"{v}_agree"] = float(same.double().mean())
        gates[f"{v}_agree_or_tied"] = share
        if not share > 0.999:
            raise AssertionError(f"E3 {v}: agrees with K1 on {share} of rows")
    i_pk, d_pk = run_variant(src, tgt, "packed", bm)
    i_pt, d_pt = run_variant(src, tgt, "packed_ts", bm)
    if not (torch.equal(i_pk, i_pt) and torch.equal(d_pk, d_pt)):
        raise AssertionError("E3: packed and packed_ts differ")
    diff = i_pk != i_lib
    extra = 0.0
    if bool(diff.any()):
        extra = float((_sqdist64(src, tgt, i_pk)
                       - _sqdist64(src, tgt, i_lib))[diff].max())
    gates.update(packed_swaps=int(diff.sum()),
                 packed_max_extra_sqdist=extra)
    print(json.dumps(gates), flush=True)
    share = float(diff.to(torch.float32).mean())
    if not (share < 5e-3 and extra < 1e-5):
        raise AssertionError(f"E3 packed: swaps on {share} of rows, extra "
                             f"sqdist {extra}")
    return gates


def main(bm: int = 8192) -> dict:
    """Run the gates and the times on the card; print and return ``{"gates":
    ..., "times": {name: ms}}``."""
    if not torch.cuda.is_available():
        raise RuntimeError("the reduction study needs a CUDA device")
    pin_f32_precision()
    src, tgt = study_inputs(torch.device("cuda", 0))
    i_lib, _ = _nn_argmin_cudacore(src, tgt)
    gates = check_gates(src, tgt, i_lib, bm)
    card = torch.cuda.get_device_name(0)
    times = {"full_lib K1 CUDA-core": cuda_time_ms(
        lambda: _nn_argmin_cudacore(src, tgt), repeats=20, warmup=3)["min"]}
    by_epilogue = {}
    for v in VARIANTS:
        e = EPILOGUE[v]
        if e not in by_epilogue:
            by_epilogue[e] = cuda_time_ms(
                lambda v=v: run_variant(src, tgt, v, bm), repeats=20,
                warmup=3)["min"]
        times[v] = by_epilogue[e]
    for name, ms in times.items():
        how = ("K1 on the CUDA cores" if name.startswith("full_lib")
               else f"Kernel S '{EPILOGUE[name]}'")
        print(f"{name}: {ms:.4f} ms ({how}, N=M={src.shape[0]}, min of 20 "
              f"by CUDA events, {card})", flush=True)
    return {"gates": gates, "times": times}


if __name__ == "__main__":
    main()
