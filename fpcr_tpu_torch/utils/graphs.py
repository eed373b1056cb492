"""CUDA graphs of the registration loops: the port's counterpart of ``jit``.

The JAX package runs a whole registration as one compiled device program
(a ``lax.while_loop`` under ``jit``). Here a loop runs in chunks of
``DONE_CHECK_EVERY`` masked iterations (``models/icp.py::drive_chunks``),
and on the card each chunk is captured once as a ``torch.cuda.CUDAGraph``
and then replayed: the host issues one replay and reads the done flag once
per chunk, and no kernel of the chunk waits for the host.

:func:`bind` gives a loop its chunk runner: ``bind(fn, consts)`` returns
``step(state, k)``, which computes ``fn(state, consts, k)``. ``consts`` are
the loop's inputs that no iteration changes (the target, its tables, the
frozen config); ``state`` is what a chunk carries to the next. PyTorch's
capture rules are followed:

* the key is ``fn`` and ``consts``' structure: every tensor's shape, dtype
  and device (tensors are made contiguous), which optional inputs are
  None, and every host value (the frozen configs, a table's bit widths).
  Every host integer baked into a launch (slice plans, band and window
  sizes, ``idx_bits``) follows from those, as under ``jit``. A graph of the
  key is further keyed by ``state``'s structure and ``k``;
* the first loop of a key runs eagerly, one launch at a time, each chunk
  on a copy of its state (a chunk may update its state in place), and
  captures nothing: a shape that is registered once pays no capture. The
  next loop of the key captures, and the loops after it replay;
* a loop that captures or replays copies ``consts`` once into the key's
  static buffers, which every graph of the key shares; each chunk copies
  its ``state`` into its graph's own static buffers;
* the first chunk of each length is warmed up on a side stream (cuBLAS
  workspaces, the kernels' first-use build, K1/K2's rescue counter): the
  warm-up computes the chunk, and its result is the chunk's. The chunk is
  then captured on that stream into a private memory pool, and every later
  chunk of that length replays it and returns its outputs cloned out of
  the pool, so the next replay cannot overwrite what a caller holds;
* the kernels' launch counters (``_build.COUNTED``, each registered where
  its wrapper is defined) move on the host while ``fn`` runs, so during
  the capture too, which launches nothing: each counter's change over the
  capture is recorded, the counter set back, and the change added once per
  replay. The warm-up counts as the eager chunk it is, so a run counts the
  launches of its iterations as the eager loop does;
* :data:`CACHE` keeps at most ``MAX_KEYS`` keys and ``MAX_BYTES`` of their
  static buffers and pools, the least recently used key dropped first with
  its graphs. :func:`clear` drops them all and forgets the keys seen. It
  counts the loops bound by route (``loops``), the captures (``captures``,
  one record each) and the chunks replayed (``replays``);
* while the program's spans are recorded (``utils/timing.py``), a
  replayed chunk is the spans ``copy_in``, ``replay`` and ``copy_out``,
  and the bytes of its state copied into static buffers count on the call.

A chunk may stop doing work part way: a block of it under
:func:`skip_if_all` (``models/icp.py::_icp_chunk`` puts each iteration
under one) runs only while some flag of its ``done`` tensor is clear. Off
a capture the block simply runs. The warm-up tells :meth:`GraphCache.bind`
that the chunk has such blocks; it is then captured in parts
(``csrc/graph_if.cu``):

* every block, and each stretch of the chunk between them, is captured on
  the side stream as a graph of its own, all of a key's parts into one
  memory pool: they run one after another, so a part reuses the memory the
  parts before it freed, as the iterations of one captured chunk do;
* the chunk's graph, captured by the CUDA runtime on a stream of its own,
  holds those parts in order, each block as a conditional IF node whose
  condition a one-thread kernel sets just before it from ``done`` as it
  stands then: a block whose flags are all set runs none of its kernels;
* such a block must leave, when skipped, what it would have left had it
  run: it writes its results in place into tensors that exist before it
  (the chunk's state, which the graph holds in its static buffers, and
  its rows), it keeps ``done`` in place, and it draws no random numbers;
* the kernel that sets a condition also counts, on the device, the blocks
  it lets run, in one counter a key. While the spans are recorded, a loop
  adds to its call ``iterations_run`` (the blocks of the chunks replayed)
  and, at its end (:meth:`Loop.finish`), ``iterations_skipped`` (those
  whose kernels did not run): one host read
  after the loop's last chunk, not counted as a sync; an unrecorded loop
  reads nothing;
* a replay adds to the launch counters every launch its capture made,
  those of the blocks it skips included.

A chunk without such blocks (a sharded loop's, whose NCCL collectives are
not put in a conditional node, and every other loop's) is captured whole.

A graph replays the functions it captured: a module attribute patched
later (a kernel wrapper swapped for another) is not seen until
:func:`clear`, as a jitted function does not see it until it is traced
again. A capture that fails raises; nothing falls back to the eager loop.
:func:`eager` makes the loops run eagerly on the card, the reference that
the captured loops are held to bit for bit.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import threading
import time
import warnings
from typing import Callable, Dict, List, NamedTuple, Optional

import torch

from .. import _build
from . import timing

# the keys the cache keeps, and the device memory of their static buffers
# and pools: a loop's key holds two graphs (a chunk and the shorter last
# one); at 1,048,576 points an NDT key holds about 0.5 GB
MAX_KEYS = 8
MAX_BYTES = 4 << 30
# the keys remembered as seen once (so that their next loop captures)
MAX_SEEN = 1024


def _read_counts(fns) -> list:
    return [dict(f.launches) if isinstance(f.launches, dict) else f.launches
            for f in fns]


def _counts_delta(after, before):
    if isinstance(after, dict):
        return {k: v - before.get(k, 0) for k, v in after.items()}
    return after - before


def _add_counts(fn, delta) -> None:
    if isinstance(delta, dict):
        for k, v in delta.items():
            fn.launches[k] = fn.launches.get(k, 0) + v
    else:
        fn.launches += delta


# ---- args as a tree: tuples, lists and NamedTuples of leaves ------------

def _flatten(tree, tensors: list):
    """The key of ``tree``'s structure; its tensors appended to
    ``tensors`` (made contiguous)."""
    if isinstance(tree, torch.Tensor):
        t = tree.contiguous()
        tensors.append(t)
        return ("T", tuple(t.shape), t.dtype, t.device)
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(_flatten(x, tensors) for x in tree))
    hash(tree)  # a host value keys the graph: it must be hashable
    return ("V", type(tree), tree)


def _unflatten(key, tensors):
    """``tree`` rebuilt from its key, its tensors taken from the iterator
    ``tensors`` in order."""
    if key[0] == "T":
        return next(tensors)
    if key[0] == "V":
        return key[2]
    kind, children = key
    items = [_unflatten(c, tensors) for c in children]
    if kind in (tuple, list):
        return kind(items)
    return kind(*items)  # a NamedTuple


def cache_key(fn: Callable, args: tuple):
    """``(key, tensors)``: the cache key of ``fn`` over ``args`` and the
    tensors of ``args`` in order, each made contiguous."""
    tensors: list = []
    return (fn, _flatten(args, tensors)), tensors


def contiguous(tree):
    """``tree`` with every tensor made contiguous, as :func:`bind` holds
    it in its static buffers: an eager loop that computes on the same
    layouts as its captured twin launches the same kernels (a library
    picks its kernel, and so its rounding, by the operands' strides; a
    batched factor such as ``cholesky_ex``'s comes out column-major)."""
    key, tensors = cache_key(None, (tree,))
    return _unflatten(key[1], iter(tensors))[0]


def owned(tree):
    """``tree`` with every tensor copied into a contiguous tensor of its
    own: what an eager loop hands a chunk, which may update its state in
    place (:class:`Loop`)."""
    key, tensors = cache_key(None, (tree,))
    return _unflatten(key[1], iter([t.clone() for t in tensors]))[0]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def tensor_bytes(tree) -> int:
    """The bytes of ``tree``'s tensors: what a bind of ``tree`` as a loop's
    constants copies into static buffers."""
    return _nbytes(cache_key(None, (tree,))[1])


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_clone(x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone(x) for x in tree)
    return tree


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.fpcr_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


class _Graph(NamedTuple):
    graph: object  # a torch.cuda.CUDAGraph, or an _Executable
    inputs: List[torch.Tensor]  # the static state buffers
    outputs: object  # the static outputs, in the graph's pool
    deltas: list  # [(counted wrapper, launches a replay)]
    nbytes: int  # the state buffers and the pool
    blocks: int  # its skip_if_all blocks (IF nodes); 0 for a whole capture


class _Executable:
    """A chunk captured in parts (:class:`_Parts`): the runtime's
    executable graph, launched on the current stream, and the parts' torch
    graphs, whose pool holds the memory its nodes use."""

    def __init__(self, lib, handle: int, device, parts: list) -> None:
        self.lib, self.handle, self.device = lib, handle, device
        self.parts = parts

    def replay(self) -> None:
        stream = torch.cuda.current_stream(self.device).cuda_stream
        _check(self.lib, self.lib.fpcr_graph_launch(self.handle, stream),
               "graph launch")

    def __del__(self) -> None:
        if self.handle:
            self.lib.fpcr_graph_destroy(self.handle)
            self.handle = None


class _Parts:
    """A chunk being captured in parts: each part a torch graph of its own,
    captured on the current (side) stream into the key's ``pool`` and
    appended, as a child graph, to the graph that the runtime captures on
    ``outer``; a :func:`skip_if_all` block's inside an IF node, after the
    kernel that sets its condition and counts it in ``bodies``."""

    def __init__(self, lib, outer, pool, bodies: torch.Tensor) -> None:
        self.lib, self.outer, self.pool, self.bodies = lib, outer, pool, bodies
        self.graphs: list = []  # every part, kept with the chunk's graph
        self.current: Optional[torch.cuda.CUDAGraph] = None
        self.flag: Optional[torch.Tensor] = None  # the open block's done
        self.blocks = 0

    def open(self) -> None:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        self.current = graph

    def _close(self) -> int:
        graph, self.current = self.current, None
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # a stretch may be empty
            graph.capture_end()
        self.graphs.append(graph)
        return graph.raw_cuda_graph()

    def begin_block(self, done: torch.Tensor) -> None:
        if self.flag is not None:
            raise RuntimeError("skip_if_all blocks do not nest")
        _check(self.lib, self.lib.fpcr_graph_add_child(
            self.outer.cuda_stream, self._close()), "capture")
        self.flag = done
        self.open()

    def end_block(self) -> None:
        body, flag, self.flag = self._close(), self.flag, None
        _check(self.lib, self.lib.fpcr_graph_add_if(
            self.outer.cuda_stream, flag.data_ptr(), flag.numel(), body,
            self.bodies.data_ptr()), "capture")
        self.blocks += 1
        self.open()

    def close(self) -> None:
        """End the last part and append it, unless it is a block's (the
        capture failed inside one)."""
        if self.current is not None:
            body = self._close()
            if self.flag is None:
                _check(self.lib, self.lib.fpcr_graph_add_child(
                    self.outer.cuda_stream, body), "capture")


class _Capturing(threading.local):
    """What :func:`skip_if_all` sees in this thread: the parts of a chunk
    being captured, or whether a warm-up runs and has met a block."""

    parts: Optional[_Parts] = None
    warming = False
    met_block = False


_capturing = _Capturing()


class _Key:
    """A key's static ``consts`` buffers and its graphs, keyed by the
    state's structure and the chunk length; for chunks captured in parts,
    their pool and the device count of the blocks that ran."""

    def __init__(self, tensors) -> None:
        self.consts = [t.clone() for t in tensors]
        self.graphs: Dict[tuple, _Graph] = {}
        self.pool = None
        self.bodies: Optional[torch.Tensor] = None

    def nbytes(self) -> int:
        return _nbytes(self.consts) + sum(g.nbytes
                                          for g in self.graphs.values())


class Loop:
    """One loop's chunk runner: ``step(state, k)`` computes ``fn(state,
    consts, k)``; :meth:`finish` after the loop's last chunk. Without a
    cache entry (a key's first loop, and every eager loop), each chunk runs
    eagerly on a copy of its state, which it may update in place; else by
    the entry's graphs (:meth:`GraphCache.bind`)."""

    def __init__(self, fn: Callable, consts, cache=None, key=None,
                 entry: Optional[_Key] = None) -> None:
        self.fn, self.consts = fn, consts
        self.cache, self.key, self.entry = cache, key, entry
        # while recording: the blocks of this loop's replayed chunks, and
        # the key's count of blocks run set to 0 for it
        self.counting = entry is not None and timing.RECORDER.on()
        self.blocks_run = 0
        if self.counting and entry.bodies is not None:
            entry.bodies.zero_()

    def __call__(self, state, k: int):
        if self.entry is None:
            return self.fn(owned(state), self.consts, k)
        return self.cache._step(self, state, k)

    def finish(self) -> None:
        """While recording, add to the call ``iterations_skipped``: the
        blocks of this loop's replayed chunks whose kernels did not run.
        One host read of the key's count, not counted as a sync: after the
        done read that stopped the loop, or, where the loop ran to its
        cap, after its last chunk."""
        if self.counting and self.blocks_run:
            timing.count("iterations_skipped",
                         self.blocks_run - int(self.entry.bodies))


class GraphCache:
    """A bounded cache of captured graphs, least recently used key dropped
    first; :meth:`bind` gives a loop its chunk runner."""

    def __init__(self, max_keys: int = MAX_KEYS,
                 max_bytes: int = MAX_BYTES) -> None:
        self.max_keys = max_keys
        self.max_bytes = max_bytes
        self._keys: "collections.OrderedDict[tuple, _Key]" = (
            collections.OrderedDict())
        self._seen: "collections.OrderedDict[tuple, None]" = (
            collections.OrderedDict())
        # per device: the side stream (warm-ups, whole captures and parts)
        # and the stream the runtime captures a chunk in parts on
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}
        self._outer: Dict[torch.device, torch.cuda.Stream] = {}
        self._lock = threading.RLock()
        # one record a capture: the function, its seconds (warm-up and
        # capture) and the device memory its pool reserved
        self.captures: List[dict] = []
        # loops bound, by route: "eager" (a key's first), "graphs"
        self.loops: "collections.Counter[str]" = collections.Counter()
        # chunks replayed
        self.replays = 0

    def clear(self) -> None:
        with self._lock:
            self._keys.clear()
            self._seen.clear()

    def __len__(self) -> int:
        """The graphs held."""
        return sum(len(k.graphs) for k in self._keys.values())

    def nbytes(self) -> int:
        """The device memory of the static buffers and pools held."""
        return sum(k.nbytes() for k in self._keys.values())

    def bind(self, fn: Callable, consts) -> Loop:
        """The loop's chunk runner ``step(state, k)``, computing ``fn(state,
        consts, k)``: eager on the first loop of the key, else by the key's
        graphs."""
        key, tensors = cache_key(fn, (consts,))
        with self._lock:
            entry = self._keys.get(key)
            if entry is None and key not in self._seen:
                self._seen[key] = None
                while len(self._seen) > MAX_SEEN:
                    self._seen.popitem(last=False)
                self.loops["eager"] += 1
                return Loop(fn, consts)
            if not tensors or tensors[0].device.type != "cuda":
                raise ValueError("a captured loop takes CUDA tensors")
            self.loops["graphs"] += 1
            if entry is None:
                self._seen.pop(key, None)
                entry = self._keys[key] = _Key(tensors)
            else:
                self._keys.move_to_end(key)
                for dst, src in zip(entry.consts, tensors):
                    dst.copy_(src)
            self._trim()
        static_consts = _unflatten(key[1], iter(entry.consts))[0]
        return Loop(fn, static_consts, self, key, entry)

    def _step(self, loop: Loop, state, k):
        """One chunk: its state copied in, its graph replayed and its
        outputs cloned out (the spans ``copy_in``, ``replay`` and
        ``copy_out``), or, the first time, captured."""
        entry, fn = loop.entry, loop.fn
        span = timing.begin("copy_in")
        skey, tensors = cache_key(fn, (state, k))
        with self._lock:
            g = entry.graphs.get(skey[1])
            if g is None:
                if span:
                    span.end()
                return self._capture(loop.key, entry, fn, loop.consts, skey,
                                     tensors)
            for dst, src in zip(g.inputs, tensors):
                dst.copy_(src)
            if span:
                nbytes = _nbytes(tensors)
                span.end(bytes=nbytes)
                timing.count("bytes_copied", nbytes)
                span = timing.begin("replay")
            g.graph.replay()
            self.replays += 1
            for wrapper, delta in g.deltas:
                _add_counts(wrapper, delta)
            if loop.counting and g.blocks:
                loop.blocks_run += g.blocks
                timing.count("iterations_run", g.blocks)
            if span:
                span.end()
                span = timing.begin("copy_out")
            out = _clone(g.outputs)
            if span:
                span.end()
            return out

    @staticmethod
    def _stream(streams: dict, device) -> torch.cuda.Stream:
        stream = streams.get(device)
        if stream is None:
            stream = streams[device] = torch.cuda.Stream(device)
        return stream

    def _capture(self, key, entry: _Key, fn, consts, skey, tensors):
        device = entry.consts[0].device
        t0 = time.perf_counter()
        inputs = [t.clone() for t in tensors]
        state, k = _unflatten(skey[1], iter(inputs))
        side = self._stream(self._streams, device)
        current = torch.cuda.current_stream(device)
        counted = list(_build.COUNTED)
        side.wait_stream(current)
        _capturing.warming, _capturing.met_block = True, False
        try:
            with torch.cuda.device(device), torch.cuda.stream(side):
                warm = fn(state, consts, k)  # this chunk's result
        finally:
            _capturing.warming = False
        in_parts = _capturing.met_block
        current.wait_stream(side)
        result = _clone(warm)  # on the current stream, apart from inputs
        del warm
        torch.cuda.synchronize(device)
        before = _read_counts(counted)
        reserved = torch.cuda.memory_reserved(device)
        blocks = 0
        try:
            if in_parts:
                graph, outputs, blocks = self._capture_parts(
                    entry, device, side, fn, state, consts, k)
            else:
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.device(device), torch.cuda.stream(side):
                    graph.capture_begin(capture_error_mode="thread_local")
                    try:
                        outputs = fn(state, consts, k)
                    finally:
                        graph.capture_end()
            current.wait_stream(side)
            after = _read_counts(counted)
        except BaseException:
            self._keys.pop(key, None)
            raise
        finally:
            # the capture launched nothing: its counts are a replay's
            for wrapper, count in zip(counted, before):
                wrapper.launches = count
        pool_bytes = torch.cuda.memory_reserved(device) - reserved
        deltas = []
        for wrapper, a, b in zip(counted, after, before):
            delta = _counts_delta(a, b)
            if any(delta.values()) if isinstance(delta, dict) else delta:
                deltas.append((wrapper, delta))
        entry.graphs[skey[1]] = _Graph(graph, inputs, outputs, deltas,
                                       pool_bytes + _nbytes(inputs), blocks)
        self.captures.append({"fn": getattr(fn, "__qualname__", repr(fn)),
                              "capture_s": time.perf_counter() - t0,
                              "pool_bytes": pool_bytes, "blocks": blocks})
        self._trim()
        return result

    def _capture_parts(self, entry: _Key, device, side, fn, state, consts,
                       k):
        """Capture ``fn(state, consts, k)`` in parts (:class:`_Parts`):
        ``(graph, outputs, blocks)``."""
        lib = _build.load_library()
        if entry.pool is None:
            entry.pool = torch.cuda.graph_pool_handle()
            entry.bodies = torch.zeros((), dtype=torch.int64, device=device)
        outer = self._stream(self._outer, device)
        parts = _Parts(lib, outer, entry.pool, entry.bodies)
        _check(lib, lib.fpcr_graph_capture_begin(outer.cuda_stream),
               "capture")
        handle = ctypes.c_void_p()
        whole = False
        try:
            with torch.cuda.device(device), torch.cuda.stream(side):
                parts.open()
                _capturing.parts = parts
                try:
                    outputs = fn(state, consts, k)
                finally:
                    _capturing.parts = None
                    parts.close()
            whole = True
        finally:
            rc = lib.fpcr_graph_capture_end(outer.cuda_stream, int(whole),
                                            ctypes.byref(handle))
        _check(lib, rc, "capture")
        return (_Executable(lib, handle.value, device, parts.graphs),
                outputs, parts.blocks)

    def _trim(self) -> None:
        """Drop the least recently used keys, never the newest, while the
        cache holds more than ``max_keys`` or ``max_bytes``."""
        while len(self._keys) > 1 and (
                len(self._keys) > self.max_keys
                or self.nbytes() > self.max_bytes):
            self._keys.popitem(last=False)


CACHE = GraphCache()
_eager = threading.local()


def bind(fn: Callable, consts) -> Loop:
    """One loop's chunk runner ``step(state, k)``, computing ``fn(state,
    consts, k)`` by the graphs of :data:`CACHE` (see the module's notes)."""
    return CACHE.bind(fn, consts)


@contextlib.contextmanager
def skip_if_all(done: torch.Tensor):
    """Run the block; in a chunk that :func:`bind` captures, the block is
    an IF node that runs only while some flag of ``done`` (a contiguous
    bool tensor on the card, which the block updates in place) is clear,
    as it stands when the replay reaches the block (see the module's
    notes). Elsewhere, on the CPU, in an eager loop and in the warm-up, it
    runs the block and changes nothing."""
    parts = _capturing.parts
    if parts is None:
        if _capturing.warming:
            _capturing.met_block = True
        yield
        return
    if (done.dtype != torch.bool or not done.is_contiguous()
            or done.device.type != "cuda"):
        raise ValueError("skip_if_all takes a contiguous bool CUDA tensor")
    parts.begin_block(done)
    try:
        yield
    finally:
        parts.end_block()


def clear() -> None:
    """Drop every cached graph and its pool, and forget the keys seen."""
    CACHE.clear()


def capturable(group) -> bool:
    """Whether a loop whose sums are all-reduced over ``group`` can run by
    :func:`bind`: without a group, or over NCCL, whose collectives are
    kernels on the card that a graph captures (its communicator made by
    the warm-up chunk, outside the capture). gloo's run on the host and
    cannot be captured: a gloo loop runs eagerly. Decided by the group's
    backend, before the loop."""
    if group is None:
        return True
    import torch.distributed as dist

    return "nccl" in str(dist.get_backend(group)).lower()


def captured(device) -> bool:
    """Whether a loop on ``device`` runs by :func:`bind`: on a CUDA
    device, outside :func:`eager`."""
    return (torch.device(device).type == "cuda"
            and not getattr(_eager, "on", False))


@contextlib.contextmanager
def eager(enable: bool = True):
    """While in force (in this thread), the loops run eagerly on the card,
    one launch at a time: the reference of the captured loops."""
    prev = getattr(_eager, "on", False)
    _eager.on = prev or enable
    try:
        yield
    finally:
        _eager.on = prev
