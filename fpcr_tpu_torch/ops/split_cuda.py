"""Kernel S on Hopper: the brute-force NN over the K-packed bf16 split
distance on the tensor cores, CUDA C++.

:func:`split_nn_cuda` replaces the TPU kernels of E4
(``scripts/exp_split_matmul.py::nn_argmin_packed``) and E3
(``scripts/exp_reduction2.py::run_variant``) with the wgmma sweep of
``csrc/split_wgmma.cu``; the operands come from ``ops/split.py::
split_operands``, the plain version is ``ops/split.py::split_nn_plain`` and
the dispatcher ``ops/split.py::split_nn``. It checks the inputs, plans the
launch, allocates the outputs and scratch with ``torch.empty``, launches on
PyTorch's current stream, raises when a launch is refused, and counts its
launches per launch type, ``"x<terms> <epilogue>"``, in
``split_nn_cuda.launches``. It takes CUDA tensors only.

:func:`_split_nn_mma_sync` runs the same function on the first design,
``csrc/split_mma.cu`` (``mma.sync`` m16n8k16), and counts in its own
``_split_nn_mma_sync.launches``: the yardstick the new kernel is timed
against, on no path of the package.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from .. import _build
from ..core.cloud import round_up
from .matching_cuda import _raise_on, plan_slices

# 'argmin': first minimum; 'packed14': E3's (value|index) key; 'min': the
# least distance; 'keep': the distance to one column
EPILOGUES = ("argmin", "packed14", "min", "keep")
TERMS = (6, 3)  # the split terms Kernel S is built for: K = 48 and K = 24
TILE = 128  # targets a tile of the wgmma sweep (its n)
SPLIT_ROWS = 192  # source rows a block of the wgmma sweep (three warpgroups)
PACKED14_BITS = 14  # E3's fixed index bits
PACKED14_KEY_INIT = 0x7F7FFFFF  # bits of the largest finite float


def check_split_args(p_in, q_in, n: int, m: int, epilogue: str,
                     keep: Optional[int]) -> None:
    """The arguments both versions of the split reduction take. E3's key
    holds the column in a fixed 14 bits: past 2^14 padded targets a column
    would spill into the distance bits and corrupt the key silently, so
    ``'packed14'`` raises there."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue must be one of {EPILOGUES}, got "
                         f"{epilogue!r}")
    if p_in.ndim != 2 or q_in.ndim != 2 or p_in.shape[1] != q_in.shape[1]:
        raise ValueError(f"operands [n_pad, K] and [m_pad, K] expected, got "
                         f"{tuple(p_in.shape)} and {tuple(q_in.shape)}")
    if not (0 <= n <= p_in.shape[0] and 1 <= m <= q_in.shape[0]):
        raise ValueError(f"n={n}, m={m} outside the operands "
                         f"{tuple(p_in.shape)}, {tuple(q_in.shape)}")
    if epilogue == "keep" and (keep is None or not 0 <= keep < m):
        raise ValueError(f"epilogue 'keep' needs a column in [0, {m}), got "
                         f"{keep}")
    if epilogue == "packed14" and q_in.shape[0] > 1 << PACKED14_BITS:
        raise ValueError(f"the packed14 epilogue holds 2^{PACKED14_BITS} "
                         f"columns, got m_pad = {q_in.shape[0]}")


def _check_operand(name: str, x, device) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if x.device.type != "cuda":
        raise ValueError(f"Kernel S takes CUDA tensors; {name} lies on "
                         f"{x.device}")
    if x.device != device:
        raise ValueError(f"{name} lies on {x.device}, p_in on {device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{name} must be bfloat16, got {x.dtype}")
    if x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous [rows, K] matrix")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"{name} is too large for int32 offsets")


def _checked(p_in, q_in, n: int, m: int, epilogue: str,
             keep: Optional[int]) -> int:
    """Check a launch of either design of Kernel S; returns the terms."""
    _check_operand("p_in", p_in, getattr(p_in, "device", None))
    _check_operand("q_in", q_in, p_in.device)
    check_split_args(p_in, q_in, n, m, epilogue, keep)
    k = p_in.shape[1]
    if k % 8 or k // 8 not in TERMS:
        raise ValueError(f"Kernel S takes K = 8 * terms for terms in {TERMS}, "
                         f"got {k}")
    if round_up(m, 8) > q_in.shape[0]:
        raise ValueError(f"Kernel S sweeps whole n8 tiles: q_in needs "
                         f"round_up(m, 8) = {round_up(m, 8)} rows, got "
                         f"{q_in.shape[0]}")
    return k // 8


def plan_split(n: int, m: int, rows_per_block: int,
               sm_count: int) -> Tuple[int, int]:
    """``(slices, slice_len)`` of the wgmma sweep, which runs one block an
    SM: the targets are sliced over ``blockIdx.y`` into the fewest slices
    (each a multiple of :data:`TILE`) whose waves of ``sm_count`` blocks
    come within 2% of the least time, a wave's time taken as its slice's
    length. Fewer slices mean fewer improving tiles (a quad keeps its
    values only there), and one slice needs no combine launch."""
    row_blocks = max(1, math.ceil(n / rows_per_block))
    most = max(1, min(math.ceil(m / TILE),
                      math.ceil(4 * sm_count / row_blocks)))

    def cost(s):
        return math.ceil(row_blocks * s / sm_count) / s

    least = min(cost(s) for s in range(1, most + 1))
    slices = next(s for s in range(1, most + 1) if cost(s) <= 1.02 * least)
    slice_len = round_up(math.ceil(m / slices), TILE)
    return math.ceil(m / slice_len), slice_len


def split_nn_cuda(
    p_in: torch.Tensor,
    q_in: torch.Tensor,
    n: int,
    m: int,
    epilogue: str,
    *,
    keep: Optional[int] = None,
    clamp: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split-distance reduction of source rows [0, n) over targets
    [0, m), computed by the wgmma sweep of ``csrc/split_wgmma.cu``.

    ``p_in`` bf16[n_pad, K] and ``q_in`` bf16[m_pad, K] from
    ``split_operands``, K = 48 (terms 6) or 24 (terms 3), with ``m_pad >=
    round_up(m, 8)``. ``epilogue`` one of :data:`EPILOGUES`; ``keep`` the
    column of ``'keep'``; ``clamp`` clamps the argmin's distance at 0.
    Returns ``(idx int32[n], d f32[n])``; ``'min'`` and ``'keep'`` give an
    index of zeros. One launch where the plan (:func:`plan_split`) has one
    target slice (and for ``'keep'``), else two (sweep and combine).
    """
    terms = _checked(p_in, q_in, n, m, epilogue, keep)
    code = EPILOGUES.index(epilogue)
    name = f"x{terms} {epilogue}"
    dev = p_in.device
    slices, slice_len = _plan(dev, n, m) if n else (1, TILE)
    direct = slices == 1 or epilogue == "keep"
    # the combine writes every index; the sweep writes none for these
    zero_idx = epilogue == "keep" or (epilogue == "min" and direct)
    idx = (torch.zeros if zero_idx else torch.empty)(
        n, dtype=torch.int32, device=dev)
    dist = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return idx, dist
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        part_d = dist if direct else (None if epilogue == "packed14" else
                                      torch.empty((slices, n),
                                                  dtype=torch.float32,
                                                  device=dev))
        part_i = idx if direct else (None if epilogue == "min" else
                                     torch.empty((slices, n),
                                                 dtype=torch.int32,
                                                 device=dev))
        rc = lib.fpcr_split_wgmma(p_in.data_ptr(), q_in.data_ptr(),
                                  q_in.shape[0], terms, code, n,
                                  p_in.shape[0], m, slice_len,
                                  keep if epilogue == "keep" else -1,
                                  int(clamp), _ptr(part_d), _ptr(part_i),
                                  stream)
        _raise_on_wgmma(lib, rc, f"split_wgmma {name}")
        split_nn_cuda.launches[name] += 1
        if direct:
            return idx, dist
        rc = lib.fpcr_split_wgmma_combine(_ptr(part_d), _ptr(part_i), code, n,
                                          slices, int(clamp),
                                          dist.data_ptr(), idx.data_ptr(),
                                          stream)
        _raise_on(lib, rc, f"split_wgmma_combine {name}")
        split_nn_cuda.launches[name] += 1
    return idx, dist


def _plan(dev: torch.device, n: int, m: int) -> Tuple[int, int]:
    """The wgmma sweep's ``(slices, slice_len)`` on ``dev``."""
    return plan_split(n, m, SPLIT_ROWS, _sm_count(dev.index))


@functools.lru_cache(maxsize=None)
def _sm_count(index: Optional[int]) -> int:
    if _build.load_library().fpcr_split_wgmma_rows_per_block() != SPLIT_ROWS:
        raise RuntimeError("csrc/split_wgmma.cu's rows a block differ from "
                           "SPLIT_ROWS")
    return torch.cuda.get_device_properties(
        torch.device("cuda", index)).multi_processor_count


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _raise_on_wgmma(lib, rc: int, what: str) -> None:
    if rc >= 1000:  # the TMA descriptor was refused: 1000 + the CUresult
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled returned "
                           f"CUresult {rc - 1000}")
    _raise_on(lib, rc, what)


def _split_nn_mma_sync(
    p_in: torch.Tensor,
    q_in: torch.Tensor,
    n: int,
    m: int,
    epilogue: str,
    *,
    keep: Optional[int] = None,
    clamp: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`split_nn_cuda`'s function on the first design of Kernel S,
    ``csrc/split_mma.cu`` (``mma.sync`` m16n8k16 bf16): the yardstick,
    on no path. Two launches (sweep and combine), one for ``'keep'``,
    counted in ``_split_nn_mma_sync.launches``."""
    terms = _checked(p_in, q_in, n, m, epilogue, keep)
    code = EPILOGUES.index(epilogue)
    name = f"x{terms} {epilogue}"
    dev = p_in.device
    idx = (torch.zeros if epilogue == "keep" else torch.empty)(
        n, dtype=torch.int32, device=dev)
    dist = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return idx, dist
    lib = _build.load_library()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    slices, slice_len = plan_slices(n, m, lib.fpcr_split_rows_per_block(),
                                    sms)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if epilogue == "keep":
            rc = lib.fpcr_split_partial(p_in.data_ptr(), q_in.data_ptr(),
                                        terms, code, n, p_in.shape[0], m,
                                        slice_len, keep, dist.data_ptr(),
                                        None, stream)
            _raise_on(lib, rc, f"split_partial {name}")
            _split_nn_mma_sync.launches[name] += 1
            return idx, dist
        part_d = (None if epilogue == "packed14" else torch.empty(
            (slices, n), dtype=torch.float32, device=dev))
        part_i = (None if epilogue == "min" else torch.empty(
            (slices, n), dtype=torch.int32, device=dev))
        rc = lib.fpcr_split_partial(p_in.data_ptr(), q_in.data_ptr(), terms,
                                    code, n, p_in.shape[0], m, slice_len, -1,
                                    _ptr(part_d), _ptr(part_i), stream)
        _raise_on(lib, rc, f"split_partial {name}")
        _split_nn_mma_sync.launches[name] += 1
        rc = lib.fpcr_split_combine(_ptr(part_d), _ptr(part_i), code, n,
                                    slices, int(clamp), dist.data_ptr(),
                                    idx.data_ptr(), stream)
        _raise_on(lib, rc, f"split_combine {name}")
        _split_nn_mma_sync.launches[name] += 1
    return idx, dist


# kernel launches made by each wrapper, per launch type
_build.counted(split_nn_cuda,
               {f"x{t} {e}": 0 for t in TERMS for e in EPILOGUES})
_build.counted(_split_nn_mma_sync, dict(split_nn_cuda.launches))
