"""Kernels K1, K2, the min-only sweep and the E1 forms on Hopper:
brute-force nearest neighbour, CUDA C++ (``csrc/nn_tc.cu``,
``csrc/nn_forms.cu``, ``csrc/matching.cu``).

* :func:`nn_argmin_cuda` launches K1, exact NN, which replaces the TPU
  kernel ``fpcr_tpu/ops/matching_pallas.py::nn_argmin_pallas``: the
  tensor-core candidate sweep and the certified finish of ``nn_tc.cu``,
  one pair of clouds or a batch of B pairs in the same two launches (the
  element on ``blockIdx.z``, the counterpart of ``vmap`` over the TPU
  kernel); plain version ``ops.matching.nn_argmin_plain``, dispatcher
  ``ops.matching.nn_argmin``, the finish's CPU mirror
  ``ops.matching.nn_certified_plain``;
* :func:`nn_argmin_packed_cuda` launches K2, the packed (value|index)
  reduction of the same function's mode ``'packed6_idx'``, through the
  same sweep and K2's finish; plain version
  ``ops.matching.nn_argmin_packed_plain``, dispatcher
  ``ops.matching.nn_argmin_packed``;
* ``_nn_argmin_cudacore`` and ``_nn_argmin_packed_cudacore`` launch the
  same two functions on the CUDA cores (``matching.cu``'s sweep): the
  yardstick of the studies and of the card's checks, on no path;
  :func:`rescued_rows` reads how many rows the finish rescanned exactly;
* :func:`nn_min_only_cuda` launches the min-only sweep of
  ``scripts/exp_packed_reduction.py::make_minonly``
  (``csrc/nn_forms.cu``); plain version and dispatcher in
  ``bench/packed_reduction.py``;
* :func:`nn_form_cuda` launches the E1 distance forms of
  ``scripts/exp_match_kernels.py`` (``make_v1``–``make_v6``) with an
  argmin or a packed reduction (``csrc/nn_forms.cu``); plain version
  ``ops.matching.nn_form_plain``, dispatcher ``ops.matching.nn_form``, the
  script's variants ``ops.matching.nn_e1``, the new reduction's CPU mirror
  ``ops.matching.nn_forms_mirror``;
* ``_nn_min_only_yardstick`` and ``_nn_form_yardstick`` launch the same two
  functions by their first design (``matching.cu``'s sweep): the
  yardsticks the new sweep is held to bit for bit and timed against, on no
  path, with launch counters of their own; ``_nn_forms_only`` launches the
  new sweep's ablations.

Each wrapper checks the inputs, plans the launch, allocates the outputs and
scratch with ``torch.empty``, launches on PyTorch's current stream, raises
when a launch is refused, and counts its launches in its own ``.launches``.
They take CUDA tensors only. :func:`nn_form_cuda` and its yardstick count
per launch type, keyed by the E1 variant (``"v1"``, ``"v2"``, ``"v4"``,
``"v5"``, ``"v6"``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .. import _build
from ..core.cloud import round_up

SLICE_QUANTUM = 256  # a target slice is a multiple of this many targets
BLOCKS_PER_SM = 4  # the launch aims at this many blocks per SM
TC_MAX_SLICE = 4096  # targets a sweep block holds in shared memory
MAX_BATCH = 65535  # batch elements a launch takes: gridDim.z's limit
# the sweep's modes (csrc/nn_tc.cu): the sweep, the sweep that also writes
# one tile's values, and the ablations without the reduction, without
# restaging, or without either
TC_MODES = {"sweep": 0, "dump": 1, "no reduce": 2, "no staging": 3,
            "skeleton": 4}


def plan_slices(n: int, m: int, rows_per_block: int,
                sm_count: int, batch: int = 1) -> Tuple[int, int]:
    """``(slices, slice_len)``: split the M targets into slices over
    ``blockIdx.y`` so that ``batch * ceil(n / rows_per_block) * slices``
    blocks fill the card, with every slice a multiple of ``SLICE_QUANTUM``
    and none empty. One slice means no combine pass."""
    row_blocks = batch * max(1, math.ceil(n / rows_per_block))
    want = math.ceil(BLOCKS_PER_SM * sm_count / row_blocks)
    slices = max(1, min(want, math.ceil(m / SLICE_QUANTUM)))
    slice_len = round_up(math.ceil(m / slices), SLICE_QUANTUM)
    return math.ceil(m / slice_len), slice_len


def _check_points(name: str, x: torch.Tensor, device, ndim: int = 2) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors; {name} lies "
                         f"on {x.device}")
    if x.device != device:
        raise ValueError(f"{name} lies on {x.device}, p on {device}")
    if x.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {x.dtype}")
    if x.ndim != ndim or x.shape[-1] != 3:
        shape = "[*, 3]" if ndim == 2 else "[B, *, 3]"
        raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if 3 * x.shape[-2] >= 2 ** 31:
        raise ValueError(f"{name} has too many rows for int32 offsets")


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.fpcr_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def _check_inputs(what: str, p, q, q_mask,
                  batched: bool = False) -> Optional[int]:
    """Check the points and the mask of a brute-force launch, ``p`` [N, 3],
    ``q`` [M, 3] and ``q_mask`` [M], or with ``batched`` a batch of them,
    [B, N, 3], [B, M, 3] and [B, M] with 1 <= B <= ``MAX_BATCH``; returns
    the mask's pointer (None for no mask)."""
    ndim = 3 if batched and getattr(p, "ndim", 2) == 3 else 2
    _check_points("p", p, getattr(p, "device", None), ndim)
    _check_points("q", q, p.device, ndim)
    m = q.shape[-2]
    if m == 0:
        raise ValueError(f"{what} needs at least one target")
    if ndim == 3:
        if q.shape[0] != p.shape[0]:
            raise ValueError(f"p holds {p.shape[0]} batch elements, q "
                             f"{q.shape[0]}")
        if not 1 <= p.shape[0] <= MAX_BATCH:
            raise ValueError(f"a batched launch takes 1 to {MAX_BATCH} "
                             f"elements (gridDim.z), got {p.shape[0]}")
    mask_ptr = None
    if q_mask is not None:
        if q_mask.device != p.device:
            raise ValueError(f"q_mask lies on {q_mask.device}, p on "
                             f"{p.device}")
        if q_mask.dtype not in (torch.bool, torch.uint8):
            raise ValueError(f"q_mask must be bool or uint8, got "
                             f"{q_mask.dtype}")
        if q_mask.shape != q.shape[:-1]:
            raise ValueError(f"q_mask must be {list(q.shape[:-1])}, got "
                             f"{list(q_mask.shape)}")
        if not q_mask.is_contiguous():
            raise ValueError("q_mask must be contiguous")
        mask_ptr = q_mask.data_ptr()
    return mask_ptr


def _plan(p: torch.Tensor, m: int, tensor_cores: bool = False):
    """``(lib, slices, slice_len)`` of a brute-force launch over ``p``
    ([N, 3], or [B, N, 3] for the tensor-core sweep): the CUDA-core sweep's
    rows per block, or the tensor-core sweep's."""
    lib = _build.load_library()
    sms = torch.cuda.get_device_properties(p.device).multi_processor_count
    rows = (lib.fpcr_nn_tc_rows_per_block() if tensor_cores
            else lib.fpcr_nn_rows_per_block())
    batch = p.shape[0] if p.ndim == 3 else 1
    slices, slice_len = plan_slices(p.shape[-2], m, rows, sms, batch)
    if tensor_cores and slice_len > TC_MAX_SLICE:  # a slice fits in smem
        slices = math.ceil(m / TC_MAX_SLICE)
        slice_len = round_up(math.ceil(m / slices), SLICE_QUANTUM)
    return lib, slices, slice_len


_RESCUED = {}  # per device: int64[2], rows rescued by K1's and K2's finish


def _rescue_counter(device) -> torch.Tensor:
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    counter = _RESCUED.get(device)
    if counter is None:
        counter = _RESCUED[device] = torch.zeros(2, dtype=torch.int64,
                                                 device=device)
    return counter


def rescued_rows(device) -> Tuple[int, int]:
    """``(K1, K2)``: the rows that the finish of :func:`nn_argmin_cuda` and
    of :func:`nn_argmin_packed_cuda` rescanned exactly on ``device`` since
    the last :func:`reset_rescued`. Reading it waits for the card."""
    k1, k2 = _rescue_counter(device).tolist()
    return k1, k2


def reset_rescued(device) -> None:
    _rescue_counter(device).zero_()


def _sweep(lib, p, q, mask_ptr, slice_len: int, mode: str, stream,
           dump: Optional[torch.Tensor] = None):
    """Launch the tensor-core sweep over ``p`` [N, 3] or [B, N, 3]; returns
    its partials int32[B, 3, slices, N] and the row blocks' centres
    f32[B, blocks, 4] (B = 1 unbatched)."""
    batch = p.shape[0] if p.ndim == 3 else 1
    n, m = p.shape[-2], q.shape[-2]
    slices = math.ceil(m / slice_len)
    part = torch.empty((batch, 3, slices, n), dtype=torch.int32,
                       device=p.device)
    centres = torch.empty(
        (batch, math.ceil(n / lib.fpcr_nn_tc_rows_per_block()), 4),
        dtype=torch.float32, device=p.device)
    rc = lib.fpcr_nn_tc_sweep(
        p.data_ptr(), q.data_ptr(), mask_ptr, batch, n, m, slice_len,
        TC_MODES[mode], part.data_ptr(), centres.data_ptr(),
        None if dump is None else dump.data_ptr(), stream)
    _raise_on(lib, rc, f"nn_tc_sweep ({mode})")
    return part, centres


def _nn_tc(fn, p, q, q_mask, idx_bits: Optional[int]):
    """Launch the tensor-core sweep and the certified finish of K1
    (``idx_bits`` None) or K2 over one pair or a batch of pairs, counting
    both launches on ``fn``."""
    packed = idx_bits is not None
    mask_ptr = _check_inputs(fn.__name__, p, q, q_mask, batched=True)
    batch = p.shape[0] if p.ndim == 3 else 1
    n, m = p.shape[-2], q.shape[-2]
    if packed:
        check_idx_bits(m, idx_bits)
    idx = torch.empty(p.shape[:-1], dtype=torch.int32, device=p.device)
    dist = torch.empty(p.shape[:-1], dtype=torch.float32, device=p.device)
    if n == 0:
        return idx, dist
    lib, slices, slice_len = _plan(p, m, tensor_cores=True)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        part, centres = _sweep(lib, p, q, mask_ptr, slice_len, "sweep",
                               stream)
        fn.launches += 1
        rc = lib.fpcr_nn_tc_finish(
            p.data_ptr(), q.data_ptr(), mask_ptr, part.data_ptr(),
            centres.data_ptr(), lib.fpcr_nn_tc_rows_per_block(), batch, n,
            m, slices, int(packed), idx_bits or 0, dist.data_ptr(),
            idx.data_ptr(),
            _rescue_counter(p.device).data_ptr() + 8 * int(packed), stream)
        _raise_on(lib, rc, "nn_tc_finish")
        fn.launches += 1
    return idx, dist


def nn_argmin_cuda(
    p: torch.Tensor,
    q: torch.Tensor,
    q_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """For every source point, the index of its nearest valid target and
    the squared distance, computed by kernel K1 on the card: the
    tensor-core candidate sweep and the certified finish of
    ``csrc/nn_tc.cu``, bit for bit the CUDA-core sweep's output.

    ``p`` f32[N,3] and ``q`` f32[M,3] (M >= 1), contiguous, on one CUDA
    device; ``q_mask`` optional bool/uint8[M]. Returns ``(idx int32[N],
    sqdist f32[N])``: ties go to the lowest index; a row with no valid
    target gets idx 0 and ``inf``. A batch ``p`` f32[B,N,3], ``q``
    f32[B,M,3], ``q_mask`` [B,M] (1 <= B <= 65,535; more raises, the batch
    is never split) gives ``idx`` int32[B,N] and ``sqdist`` f32[B,N], each
    element's bits those of its own call. Two launches, batched or not: the
    sweep and the finish.
    """
    return _nn_tc(nn_argmin_cuda, p, q, q_mask, None)


_build.counted(nn_argmin_cuda)  # kernel launches made by this wrapper


def nn_argmin_packed_cuda(
    p: torch.Tensor,
    q: torch.Tensor,
    q_mask: Optional[torch.Tensor] = None,
    *,
    idx_bits: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest valid target by the packed (value|index) reduction, computed
    by kernel K2 on the card (``csrc/nn_tc.cu``'s sweep and K2's certified
    finish): the int32 min over j of ``(bits(d_ij) & ~(2^idx_bits - 1)) |
    j``, then the exact distance to the pick.

    Inputs as :func:`nn_argmin_cuda`, a batch included, and ``idx_bits``
    in [1, 23] with ``M <= 2^idx_bits``. Returns ``(idx int32[N], sqdist
    f32[N])`` ([B, N] for a batch): ties within a bucket go to the lowest
    index; the distance is the exact one of the selected target; a row with
    no valid target gets idx 0 and ``inf``. Two launches: the sweep and the
    finish.
    """
    return _nn_tc(nn_argmin_packed_cuda, p, q, q_mask, idx_bits)


_build.counted(nn_argmin_packed_cuda)  # kernel launches made by this wrapper


def _nn_tc_tile_values(p: torch.Tensor, q: torch.Tensor,
                       q_mask: Optional[torch.Tensor] = None):
    """The sweep's norm-form values d~ f32[N, 64] of every source row
    against targets [0, 64) as the tensor cores sum them (a test-only
    instance of the sweep; column j >= M holds the masked surrogate), and
    each row's centre f32[N, 3]."""
    mask_ptr = _check_inputs("_nn_tc_tile_values", p, q, q_mask)
    lib = _build.load_library()
    out = torch.empty((p.shape[0], 64), dtype=torch.float32,
                      device=p.device)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        _, centres = _sweep(lib, p, q, mask_ptr,
                            min(round_up(q.shape[0], 128), TC_MAX_SLICE),
                            "dump", stream, dump=out)
    rows = (torch.arange(p.shape[0], device=p.device)
            // lib.fpcr_nn_tc_rows_per_block())
    return out, centres[0, rows, :3]


def _nn_tc_sweep_only(p: torch.Tensor, q: torch.Tensor,
                      mode: str = "sweep") -> None:
    """Launch the sweep alone, as ``nn_argmin_cuda`` plans it, in ``mode``
    (``'sweep'``, ``'no reduce'``, ``'no staging'`` or ``'skeleton'``):
    the ablations that split its kernel time. Its outputs are dropped."""
    mask_ptr = _check_inputs("_nn_tc_sweep_only", p, q, None)
    lib, _, slice_len = _plan(p, q.shape[0], tensor_cores=True)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        _sweep(lib, p, q, mask_ptr, slice_len, mode, stream)


def _nn_argmin_cudacore(
    p: torch.Tensor,
    q: torch.Tensor,
    q_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's function on the CUDA cores (``csrc/matching.cu``'s
    ``nn_partial_kernel<kDiff, kArgmin>`` and its slice combine): the
    yardstick that the studies time against and that the new K1 is held
    to bit for bit. No path of the package calls it."""
    mask_ptr = _check_inputs("_nn_argmin_cudacore", p, q, q_mask)
    n, m = p.shape[0], q.shape[0]
    idx = torch.empty(n, dtype=torch.int32, device=p.device)
    dist = torch.empty(n, dtype=torch.float32, device=p.device)
    if n == 0:
        return idx, dist
    lib, slices, slice_len = _plan(p, m)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        if slices == 1:
            rc = lib.fpcr_nn_partial(p.data_ptr(), q.data_ptr(), mask_ptr, n,
                                     m, slice_len, dist.data_ptr(),
                                     idx.data_ptr(), stream)
            _raise_on(lib, rc, "nn_partial")
            _nn_argmin_cudacore.launches += 1
            return idx, dist
        part_d = torch.empty((slices, n), dtype=torch.float32,
                             device=p.device)
        part_i = torch.empty((slices, n), dtype=torch.int32, device=p.device)
        rc = lib.fpcr_nn_partial(p.data_ptr(), q.data_ptr(), mask_ptr, n, m,
                                 slice_len, part_d.data_ptr(),
                                 part_i.data_ptr(), stream)
        _raise_on(lib, rc, "nn_partial")
        _nn_argmin_cudacore.launches += 1
        rc = lib.fpcr_nn_combine(part_d.data_ptr(), part_i.data_ptr(), n,
                                 slices, dist.data_ptr(), idx.data_ptr(),
                                 stream)
        _raise_on(lib, rc, "nn_combine")
        _nn_argmin_cudacore.launches += 1
    return idx, dist


_build.counted(_nn_argmin_cudacore)  # kernel launches made by this wrapper


def _nn_argmin_packed_cudacore(
    p: torch.Tensor,
    q: torch.Tensor,
    q_mask: Optional[torch.Tensor] = None,
    *,
    idx_bits: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's function on the CUDA cores (``nn_partial_kernel<kDiff,
    kPacked>`` and its epilogue): the yardstick of the new K2. No path of
    the package calls it."""
    mask_ptr = _check_inputs("_nn_argmin_packed_cudacore", p, q, q_mask)
    n, m = p.shape[0], q.shape[0]
    check_idx_bits(m, idx_bits)
    idx = torch.empty(n, dtype=torch.int32, device=p.device)
    dist = torch.empty(n, dtype=torch.float32, device=p.device)
    if n == 0:
        return idx, dist
    lib, slices, slice_len = _plan(p, m)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        keys = torch.empty((slices, n), dtype=torch.int32, device=p.device)
        rc = lib.fpcr_nn_packed_partial(p.data_ptr(), q.data_ptr(), mask_ptr,
                                        n, m, slice_len, idx_bits,
                                        keys.data_ptr(), stream)
        _raise_on(lib, rc, "nn_packed_partial")
        _nn_argmin_packed_cudacore.launches += 1
        rc = lib.fpcr_nn_packed_epilogue(p.data_ptr(), q.data_ptr(),
                                         keys.data_ptr(), n, m, slices,
                                         idx_bits, dist.data_ptr(),
                                         idx.data_ptr(), stream)
        _raise_on(lib, rc, "nn_packed_epilogue")
        _nn_argmin_packed_cudacore.launches += 1
    return idx, dist


_build.counted(_nn_argmin_packed_cudacore)


def check_idx_bits(m: int, idx_bits: int) -> None:
    """A packed key holds the target index in its low ``idx_bits`` bits and
    keeps at least the distance's exponent and 0 mantissa bits above."""
    if not 1 <= idx_bits <= 23:
        raise ValueError(f"idx_bits must lie in [1, 23], got {idx_bits}")
    if m > (1 << idx_bits):
        raise ValueError(f"{m} targets do not fit in {idx_bits} index bits")


# the new sweep's launch modes (csrc/nn_forms.cu): the sweep, and the
# ablations without the reduction and without the staging as well
FORMS_MODES = {"sweep": 0, "no reduce": 1, "sums only": 2}


def _plan_forms(p: torch.Tensor, m: int):
    """``(lib, slices, slice_len)`` of a ``csrc/nn_forms.cu`` launch over
    ``p`` [N, 3], each slice held whole in a block's shared memory (32
    slices of 512 at 16,384²)."""
    lib = _build.load_library()
    sms = torch.cuda.get_device_properties(p.device).multi_processor_count
    slices, slice_len = plan_slices(p.shape[0], m,
                                    lib.fpcr_nn_forms_rows_per_block(), sms)
    most = lib.fpcr_nn_forms_max_slice()
    if slice_len > most:
        slices = math.ceil(m / most)
        slice_len = round_up(math.ceil(m / slices), SLICE_QUANTUM)
    return lib, slices, slice_len


def _forms_sweep(lib, p, q, q_w, p_sq, mask_ptr, form: int, reduce: int,
                 mode: str, slice_len: int, idx_bits: int, part_d, part_i,
                 stream) -> None:
    rc = lib.fpcr_nn_forms_partial(
        p.data_ptr(), q.data_ptr(), None if q_w is None else q_w.data_ptr(),
        None if p_sq is None else p_sq.data_ptr(), mask_ptr, form, reduce,
        FORMS_MODES[mode], p.shape[0], q.shape[0], slice_len, idx_bits,
        part_d, part_i, stream)
    _raise_on(lib, rc, f"nn_forms_partial ({form}, {reduce}, {mode})")


def nn_min_only_cuda(
    p: torch.Tensor,
    q: torch.Tensor,
    q_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The least squared distance f32[N] of every source point to a valid
    target (``inf`` where none is valid), by the min-only sweep on the
    card (``csrc/nn_forms.cu``). Inputs as :func:`nn_argmin_cuda`. A NaN
    among a row's values (a NaN coordinate in the row or a valid target)
    makes its minimum NaN; a masked target counts as ``inf``, whatever its
    coordinates."""
    mask_ptr = _check_inputs("nn_min_only_cuda", p, q, q_mask)
    n, m = p.shape[0], q.shape[0]
    dist = torch.empty(n, dtype=torch.float32, device=p.device)
    if n == 0:
        return dist
    lib, slices, slice_len = _plan_forms(p, m)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        part = dist if slices == 1 else torch.empty(
            (slices, n), dtype=torch.float32, device=p.device)
        _forms_sweep(lib, p, q, None, None, mask_ptr, 0, 2, "sweep",
                     slice_len, 0, part.data_ptr(), None, stream)
        nn_min_only_cuda.launches += 1
        if slices > 1:
            rc = lib.fpcr_nn_min_combine(part.data_ptr(), n, slices,
                                         dist.data_ptr(), stream)
            _raise_on(lib, rc, "nn_min_combine")
            nn_min_only_cuda.launches += 1
    return dist


_build.counted(nn_min_only_cuda)  # kernel launches made by this wrapper


def _nn_min_only_yardstick(
    p: torch.Tensor,
    q: torch.Tensor,
    q_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """:func:`nn_min_only_cuda`'s function by its first design,
    ``csrc/matching.cu``'s ``nn_partial_kernel<kDiff, kMin>``: the
    yardstick the new sweep is held to bit for bit and timed against. No
    path of the package calls it."""
    mask_ptr = _check_inputs("_nn_min_only_yardstick", p, q, q_mask)
    n, m = p.shape[0], q.shape[0]
    dist = torch.empty(n, dtype=torch.float32, device=p.device)
    if n == 0:
        return dist
    lib, slices, slice_len = _plan(p, m)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        part = dist if slices == 1 else torch.empty(
            (slices, n), dtype=torch.float32, device=p.device)
        rc = lib.fpcr_nn_min_partial(p.data_ptr(), q.data_ptr(), mask_ptr, n,
                                     m, slice_len, part.data_ptr(), stream)
        _raise_on(lib, rc, "nn_min_partial")
        _nn_min_only_yardstick.launches += 1
        if slices > 1:
            rc = lib.fpcr_nn_min_combine(part.data_ptr(), n, slices,
                                         dist.data_ptr(), stream)
            _raise_on(lib, rc, "nn_min_combine")
            _nn_min_only_yardstick.launches += 1
    return dist


_build.counted(_nn_min_only_yardstick)  # kernel launches made by this wrapper


FORMS = ("biased", "expand", "expand5")  # the kernels' Form 1, 2, 3
REDUCES = ("argmin", "packed")
# the (form, reduction) of each of E1's launch types, by its variant
FORM_LAUNCHES = {("biased", "argmin"): "v1", ("biased", "packed"): "v2",
                 ("expand", "packed"): "v4", ("expand5", "packed"): "v5",
                 ("expand5", "argmin"): "v6"}


def _check_lane(name: str, x, rows: int, device) -> None:
    if not isinstance(x, torch.Tensor) or x.device != device:
        raise ValueError(f"{name} must be a tensor on {device}")
    if x.dtype != torch.float32 or x.shape != (rows,):
        raise ValueError(f"{name} must be float32[{rows}], got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_form(what: str, p, q, q_w, p_sq, form: str, reduce: str,
                idx_bits: Optional[int]) -> str:
    """Check an E1 launch's inputs; returns its launch type (``"v1"``...)."""
    _check_inputs(what, p, q, None)
    if (form, reduce) not in FORM_LAUNCHES:
        raise ValueError(f"(form, reduce) must be one of "
                         f"{sorted(FORM_LAUNCHES)}, got {(form, reduce)}")
    _check_lane("q_w", q_w, q.shape[0], p.device)
    if form != "biased":
        _check_lane("p_sq", p_sq, p.shape[0], p.device)
    if reduce == "packed":
        check_idx_bits(q.shape[0], idx_bits)
    return FORM_LAUNCHES[(form, reduce)]


def nn_form_cuda(
    p: torch.Tensor,
    q: torch.Tensor,
    q_w: torch.Tensor,
    p_sq: Optional[torch.Tensor],
    *,
    form: str,
    reduce: str,
    idx_bits: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The brute-force NN under one of E1's distance forms, computed on the
    card by ``csrc/nn_forms.cu``'s register-tiled sweep.

    ``p`` f32[N,3] and ``q`` f32[M,3] (M >= 1) as :func:`nn_argmin_cuda`
    takes them, without a mask; ``q_w`` f32[M] the staged lane and ``p_sq``
    f32[N] |p|² (None for ``'biased'``), from
    ``ops.matching.form_lanes``. ``(form, reduce)`` is one of
    :data:`FORM_LAUNCHES`. ``'argmin'`` returns ``(idx, the raw form value
    of the first minimum)``, a NaN never picked (idx 0 and ``inf`` where
    every value is NaN); ``'packed'`` the int32 min over ``(bits(v) &
    ~(2^idx_bits - 1)) | j`` of the raw value (``'biased'``) or of the value
    clamped at +0.0 (a NaN keys above every finite value), then ``(idx,
    the exact distance to the pick)`` as K2's epilogue computes it (idx 0
    and ``inf`` where no key lies below the initial one). Two launches: the
    sweep and the finish.
    """
    name = _check_form("nn_form_cuda", p, q, q_w, p_sq, form, reduce,
                       idx_bits)
    n, m = p.shape[0], q.shape[0]
    idx = torch.empty(n, dtype=torch.int32, device=p.device)
    dist = torch.empty(n, dtype=torch.float32, device=p.device)
    if n == 0:
        return idx, dist
    lib, slices, slice_len = _plan_forms(p, m)
    psq = None if form == "biased" else p_sq
    f, r = FORMS.index(form) + 1, REDUCES.index(reduce)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        part_i = torch.empty((slices, n), dtype=torch.int32, device=p.device)
        part_d = torch.empty((slices, n) if reduce == "argmin" else 0,
                             dtype=torch.float32, device=p.device)
        _forms_sweep(lib, p, q, q_w, psq, None, f, r, "sweep", slice_len,
                     idx_bits or 0, part_d.data_ptr(), part_i.data_ptr(),
                     stream)
        nn_form_cuda.launches[name] += 1
        rc = lib.fpcr_nn_forms_finish(
            p.data_ptr(), q.data_ptr(), q_w.data_ptr(),
            None if psq is None else psq.data_ptr(), f, r, n, m, slices,
            idx_bits or 0, part_d.data_ptr(), part_i.data_ptr(),
            dist.data_ptr(), idx.data_ptr(), stream)
        _raise_on(lib, rc, f"nn_forms_finish {name}")
        nn_form_cuda.launches[name] += 1
    return idx, dist


# kernel launches made by this wrapper, per E1 launch type
_build.counted(nn_form_cuda, dict.fromkeys(FORM_LAUNCHES.values(), 0))


def _nn_form_yardstick(
    p: torch.Tensor,
    q: torch.Tensor,
    q_w: torch.Tensor,
    p_sq: Optional[torch.Tensor],
    *,
    form: str,
    reduce: str,
    idx_bits: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`nn_form_cuda`'s function by its first design,
    ``csrc/matching.cu``'s ``nn_partial_kernel<Form, Reduce>`` and its
    combine (argmin over several slices) or K2's epilogue (packed): the
    yardstick the new sweep is held to bit for bit and timed against. No
    path of the package calls it."""
    name = _check_form("_nn_form_yardstick", p, q, q_w, p_sq, form, reduce,
                       idx_bits)
    n, m = p.shape[0], q.shape[0]
    idx = torch.empty(n, dtype=torch.int32, device=p.device)
    dist = torch.empty(n, dtype=torch.float32, device=p.device)
    if n == 0:
        return idx, dist
    lib, slices, slice_len = _plan(p, m)
    psq_ptr = None if form == "biased" else p_sq.data_ptr()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream

        def sweep(part_d, part_i):
            rc = lib.fpcr_nn_form_partial(
                p.data_ptr(), q.data_ptr(), q_w.data_ptr(), psq_ptr,
                FORMS.index(form) + 1, REDUCES.index(reduce), n, m,
                slice_len, idx_bits or 0, part_d, part_i, stream)
            _raise_on(lib, rc, f"nn_form_partial {name}")
            _nn_form_yardstick.launches[name] += 1

        if reduce == "argmin" and slices == 1:
            sweep(dist.data_ptr(), idx.data_ptr())
            return idx, dist
        part_i = torch.empty((slices, n), dtype=torch.int32, device=p.device)
        if reduce == "packed":
            sweep(None, part_i.data_ptr())
            rc = lib.fpcr_nn_packed_epilogue(
                p.data_ptr(), q.data_ptr(), part_i.data_ptr(), n, m, slices,
                idx_bits, dist.data_ptr(), idx.data_ptr(), stream)
            _raise_on(lib, rc, f"nn_packed_epilogue {name}")
        else:
            part_d = torch.empty((slices, n), dtype=torch.float32,
                                 device=p.device)
            sweep(part_d.data_ptr(), part_i.data_ptr())
            rc = lib.fpcr_nn_combine(part_d.data_ptr(), part_i.data_ptr(), n,
                                     slices, dist.data_ptr(), idx.data_ptr(),
                                     stream)
            _raise_on(lib, rc, f"nn_combine {name}")
        _nn_form_yardstick.launches[name] += 1
    return idx, dist


_build.counted(_nn_form_yardstick, dict.fromkeys(FORM_LAUNCHES.values(), 0))


def _nn_forms_only(p: torch.Tensor, q: torch.Tensor,
                   q_w: Optional[torch.Tensor], p_sq: Optional[torch.Tensor],
                   *, form: str, reduce: str, mode: str,
                   idx_bits: Optional[int] = None) -> None:
    """Launch ``csrc/nn_forms.cu``'s sweep alone, planned as the wrappers
    plan it, in ``mode`` (:data:`FORMS_MODES`): the ablations that split its
    kernel time. ``(form, reduce)`` is one of :data:`FORM_LAUNCHES` or
    ``('diff', 'min')``, the min-only sweep (no mask). The outputs, the
    sweep's partials or the ablations' words, are dropped."""
    _check_inputs("_nn_forms_only", p, q, None)
    n, m = p.shape[0], q.shape[0]
    lib, slices, slice_len = _plan_forms(p, m)
    if (form, reduce) == ("diff", "min"):
        f, r = 0, 2
    else:
        f, r = FORMS.index(form) + 1, REDUCES.index(reduce)
    part = torch.empty((2, slices, n), dtype=torch.float32, device=p.device)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        _forms_sweep(lib, p, q, q_w, None if form == "biased" else p_sq,
                     None, f, r, mode, slice_len, idx_bits or 0,
                     part[0].data_ptr(), part[1].data_ptr(), stream)
