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
* the first loop of a key runs eagerly, one launch at a time, and captures
  nothing: a shape that is registered once pays no capture. The next loop
  of the key captures, and the loops after it replay;
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
  its graphs. :func:`clear` drops them all and forgets the keys seen.

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
import threading
import time
from typing import Callable, Dict, List, NamedTuple

import torch

from .. import _build

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


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_clone(x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone(x) for x in tree)
    return tree


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: List[torch.Tensor]  # the static state buffers
    outputs: object  # the static outputs, in the graph's pool
    deltas: list  # [(counted wrapper, launches a replay)]
    nbytes: int  # the state buffers and the pool


class _Key:
    """A key's static ``consts`` buffers and its graphs, keyed by the
    state's structure and the chunk length."""

    def __init__(self, tensors) -> None:
        self.consts = [t.clone() for t in tensors]
        self.graphs: Dict[tuple, _Graph] = {}

    def nbytes(self) -> int:
        return _nbytes(self.consts) + sum(g.nbytes
                                          for g in self.graphs.values())


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
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}
        self._lock = threading.RLock()
        # one record a capture: the function, its seconds (warm-up and
        # capture) and the device memory its pool reserved
        self.captures: List[dict] = []
        # loops bound, by route: "eager" (a key's first), "graphs"
        self.loops: "collections.Counter[str]" = collections.Counter()

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

    def bind(self, fn: Callable, consts):
        """``step(state, k)``, computing ``fn(state, consts, k)``: eager on
        the first loop of the key, else by the key's graphs."""
        key, tensors = cache_key(fn, (consts,))
        with self._lock:
            entry = self._keys.get(key)
            if entry is None and key not in self._seen:
                self._seen[key] = None
                while len(self._seen) > MAX_SEEN:
                    self._seen.popitem(last=False)
                self.loops["eager"] += 1
                return lambda state, k: fn(state, consts, k)
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
        return lambda state, k: self._step(key, entry, fn, static_consts,
                                           state, k)

    def _step(self, key, entry: _Key, fn, consts, state, k):
        skey, tensors = cache_key(fn, (state, k))
        with self._lock:
            g = entry.graphs.get(skey[1])
            if g is None:
                return self._capture(key, entry, fn, consts, skey, tensors)
            for dst, src in zip(g.inputs, tensors):
                dst.copy_(src)
            g.graph.replay()
            for wrapper, delta in g.deltas:
                _add_counts(wrapper, delta)
            return _clone(g.outputs)

    def _capture(self, key, entry: _Key, fn, consts, skey, tensors):
        from ..ops.matching_cuda import _rescue_counter

        device = entry.consts[0].device
        t0 = time.perf_counter()
        inputs = [t.clone() for t in tensors]
        state, k = _unflatten(skey[1], iter(inputs))
        side = self._streams.get(device)
        if side is None:
            side = self._streams[device] = torch.cuda.Stream(device)
        current = torch.cuda.current_stream(device)
        counted = list(_build.COUNTED)
        side.wait_stream(current)
        with torch.cuda.device(device), torch.cuda.stream(side):
            # first-use allocations must not fall inside the capture
            _rescue_counter(device)
            warm = fn(state, consts, k)  # this chunk's result
        current.wait_stream(side)
        result = _clone(warm)  # on the current stream, apart from inputs
        del warm
        torch.cuda.synchronize(device)
        before = _read_counts(counted)
        reserved = torch.cuda.memory_reserved(device)
        graph = torch.cuda.CUDAGraph()
        try:
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
                                       pool_bytes + _nbytes(inputs))
        self.captures.append({"fn": getattr(fn, "__qualname__", repr(fn)),
                              "capture_s": time.perf_counter() - t0,
                              "pool_bytes": pool_bytes})
        self._trim()
        return result

    def _trim(self) -> None:
        """Drop the least recently used keys, never the newest, while the
        cache holds more than ``max_keys`` or ``max_bytes``."""
        while len(self._keys) > 1 and (
                len(self._keys) > self.max_keys
                or self.nbytes() > self.max_bytes):
            self._keys.popitem(last=False)


CACHE = GraphCache()
_eager = threading.local()


def bind(fn: Callable, consts):
    """One loop's chunk runner ``step(state, k)``, computing ``fn(state,
    consts, k)`` by the graphs of :data:`CACHE` (see the module's notes)."""
    return CACHE.bind(fn, consts)


def clear() -> None:
    """Drop every cached graph and its pool, and forget the keys seen."""
    CACHE.clear()


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
