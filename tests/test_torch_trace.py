"""The program's own spans of its host path (``utils/timing.py``): what
``run_icp`` and ``register_batch`` record, and what they do not.

Off (no profiler session, no ``recording()`` block) a call records
nothing and reads no clock. On, under ``recording()`` or a CPU
``torch.profiler`` session, one call is one tree: the root ``call``
(entry, B, N, M, metric, matcher and the call's counts) over ``prepare``
(``normals``, with ``knn`` and ``eig3`` inside it, ``table`` and
``source_order`` inside it where the config builds them), ``bind``, the chunks, a ``done_read`` before every chunk but
the first and after the last unless the loop ran to its cap, and
``result``; every span carries the call's id, and a child lies inside its
parent in time.
The host syncs counted are the done reads. The buffer keeps its bound.
The recorder's switch is torch's private profiler flag, pinned here, so
that a torch that moves it fails a test.

The last test needs the card and skips without one: over a 16,384-point
``run_icp`` call replayed as CUDA graphs, the syncs counted equal those
``torch.cuda.set_sync_debug_mode`` reports, and a profiler's device events
hold no program span:

    python -m pytest --noconftest -q tests/test_torch_trace.py
"""

import dataclasses
import math
import warnings

import pytest
import torch

import fpcr_tpu_torch as ft
from fpcr_tpu_torch.data.synthetic import synthetic_scene
from fpcr_tpu_torch.models import icp as mi
from fpcr_tpu_torch.models.icp import DONE_CHECK_EVERY, build_matcher_state
from fpcr_tpu_torch.utils import graphs, timing

POINT = ft.ICPConfig()
# a morton plane registration run to its cap: three chunks, two done reads
MORTON = ft.ICPConfig(matcher="morton", metric="plane", morton_chunk=64,
                      morton_window=64, tolerance=0.0, max_iterations=20)
SPAN_NAMES = {"call", "prepare", "normals", "knn", "eig3", "table",
              "source_order", "bind",
              "chunk", "copy_in", "replay", "copy_out", "done_read",
              "result"}


@pytest.fixture
def scene():
    return synthetic_scene(width=16, device="cpu")  # 256 points


@pytest.fixture(autouse=True)
def _empty_record():
    timing.clear_spans()
    yield
    timing.clear_spans()


def _batch(scene):
    return (torch.stack([scene.source, scene.source]),
            torch.stack([scene.target, scene.target + 0.01]))


def _tree(spans):
    """``{span id: span}`` and the spans by name."""
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    return {s.id: s for s in spans}, by_name


def _check_tree(spans, entry, b, n, m, metric, matcher, children):
    """One call's spans: one root with the call's attributes, every span
    under it by id and in time, the names below the root ``children``."""
    ids, by_name = _tree(spans)
    (root,) = by_name.pop("call")
    assert root.parent is None and root.call == root.id
    assert {k: root.attrs[k] for k in ("entry", "B", "N", "M", "metric",
                                       "matcher")} == {
        "entry": entry, "B": b, "N": n, "M": m, "metric": metric,
        "matcher": matcher}
    assert set(by_name) == children
    for s in spans:
        assert s.call == root.id
        assert s.start_ns <= s.end_ns
        if s is not root:
            parent = ids[s.parent]
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    return root, by_name


def _check_loop(root, by_name, iterations, cap):
    """The loop's spans and counts: chunks of ``DONE_CHECK_EVERY`` up to
    the iterations run, a done read before each but the first and after
    the last unless the chunks reached ``cap``, each one sync; on the CPU
    every chunk runs eagerly."""
    chunks = by_name["chunk"]
    ks = [c.attrs["k"] for c in chunks]
    assert len(chunks) == math.ceil(iterations / DONE_CHECK_EVERY)
    assert ks[:-1] == [DONE_CHECK_EVERY] * (len(chunks) - 1)
    assert {c.attrs["route"] for c in chunks} == {"eager"}
    assert root.attrs["chunks_eager"] == len(chunks)
    reads = len(chunks) - (sum(ks) == cap)
    done = by_name.get("done_read", [])
    assert len(done) == root.attrs.get("syncs", 0) == reads
    for name in ("prepare", "bind", "result"):
        assert len(by_name[name]) == 1 and by_name[name][0].parent == root.id
    assert by_name["bind"][0].attrs == {"route": "eager", "bytes": 0}
    # in time: prepare, bind, then chunks and done reads alternating, then
    # result
    order = sorted((s for s in root_children(by_name, root)),
                   key=lambda s: s.start_ns)
    names = [s.name for s in order]
    assert names[:2] == ["prepare", "bind"] and names[-1] == "result"
    assert names[2:-1] == (["chunk", "done_read"] * reads + ["chunk"])[
        :len(chunks) + reads]
    assert root.attrs["kernel_launches"] == 0  # no CUDA kernel on the CPU


def root_children(by_name, root):
    return [s for group in by_name.values() for s in group
            if s.parent == root.id]


def test_off_records_nothing_and_reads_no_clock(scene, monkeypatch):
    def clock():
        raise AssertionError("the recorder read its clock while off")

    monkeypatch.setattr(timing, "_clock", clock)
    assert not torch.autograd.profiler._is_profiler_enabled
    ft.run_icp(scene.source, scene.target, POINT)
    ft.run_icp(scene.source, scene.target, MORTON)
    ft.register_batch(*_batch(scene), POINT)
    assert timing.recorded_spans() == []


@pytest.mark.parametrize("switch", ["recording", "profiler"])
def test_one_point_call_is_one_tree(scene, switch):
    if switch == "recording":
        on = timing.recording()
    else:
        on = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU])
    with on:
        res = ft.run_icp(scene.source, scene.target, POINT)
    spans = timing.recorded_spans()
    iterations = int(res.num_iterations)
    assert iterations > DONE_CHECK_EVERY  # at least one done read
    root, by_name = _check_tree(spans, "run_icp", 1, 256, 256, "point",
                                "xla", {"prepare", "bind", "chunk",
                                        "done_read", "result"})
    _check_loop(root, by_name, iterations, POINT.max_iterations)


def test_a_morton_call_records_its_table_and_source_order(scene):
    with timing.recording():
        res = ft.run_icp(scene.source, scene.target, MORTON)
    spans = timing.recorded_spans()
    root, by_name = _check_tree(
        spans, "run_icp", 1, 256, 256, "plane", "morton",
        {"prepare", "normals", "knn", "eig3", "table", "source_order",
         "bind", "chunk", "done_read", "result"})
    _check_loop(root, by_name, int(res.num_iterations), 20)
    assert int(res.num_iterations) == 20 and root.attrs["syncs"] == 2
    (prepare,) = by_name["prepare"]
    for name in ("normals", "table", "source_order"):
        (s,) = by_name[name]
        assert s.parent == prepare.id
    (normals,) = by_name["normals"]
    for name in ("knn", "eig3"):
        (s,) = by_name[name]
        assert s.parent == normals.id
    # 256 rows, one chunk of 2,048 by one tile of 2,048
    assert normals.attrs == {"rows": 256, "k": 4, "tiles": 1}


def test_a_batch_call_records_its_batch(scene):
    with timing.recording():
        res = ft.register_batch(*_batch(scene), POINT)
    root, by_name = _check_tree(timing.recorded_spans(), "register_batch",
                                2, 256, 256, "point", "xla",
                                {"prepare", "bind", "chunk", "done_read",
                                 "result"})
    _check_loop(root, by_name, int(res.num_iterations.max()),
                POINT.max_iterations)


def test_a_table_built_before_the_call_has_no_root(scene):
    cfg = dataclasses.replace(MORTON, metric="point")
    with timing.recording():
        state = build_matcher_state(scene.target, None, cfg)
        ft.run_icp(scene.source, scene.target, cfg, matcher_state=state)
    spans = sorted(timing.recorded_spans(), key=lambda s: s.start_ns)
    assert spans[0].name == "table"
    assert spans[0].parent is None and spans[0].call is None
    # the call reuses it: no table of its own
    assert [s.name for s in spans].count("table") == 1
    calls = [s for s in spans if s.name == "call"]
    assert len(calls) == 1 and spans[0].end_ns <= calls[0].start_ns


def test_calls_have_their_own_ids_and_counts(scene):
    with timing.recording():
        ft.run_icp(scene.source, scene.target, POINT)
        ft.run_icp(scene.source, scene.target, MORTON)
    spans = timing.recorded_spans()
    calls = [s for s in spans if s.name == "call"]
    assert len(calls) == 2 and calls[0].id != calls[1].id
    for c in calls:
        mine = [s for s in spans if s.call == c.id]
        assert c.attrs["syncs"] == sum(s.name == "done_read" for s in mine)
        assert all(c.start_ns <= s.start_ns and s.end_ns <= c.end_ns
                   for s in mine)
    assert len({s.id for s in spans}) == len(spans)


def test_an_exception_leaves_no_span_open(scene, monkeypatch):
    def fail(*args):
        raise RuntimeError("no order")

    with timing.recording():
        with monkeypatch.context() as m:
            m.setattr(mi, "source_morton_order", fail)
            with pytest.raises(RuntimeError, match="no order"):
                ft.run_icp(scene.source, scene.target, MORTON)
        assert timing.RECORDER._stack() == []
        ft.run_icp(scene.source, scene.target, POINT)
    spans = timing.recorded_spans()
    calls = [s for s in spans if s.name == "call"]
    # the failed call is recorded, its open prepare and source_order not
    assert len(calls) == 2 and calls[1].parent is None
    assert [s.name for s in spans if s.call == calls[0].id] == [
        "knn", "eig3", "normals", "table", "call"]
    assert timing.RECORDER._stack() == []


def test_the_eager_bind_is_recorded(scene, monkeypatch):
    """On the graphs' route a loop's first bind of its key runs eagerly,
    and records so: nothing copied."""
    monkeypatch.setattr(graphs, "captured", lambda device: True)
    graphs.clear()
    try:
        with timing.recording():
            ft.run_icp(scene.source, scene.target, POINT)
    finally:
        graphs.clear()
    (bind,) = [s for s in timing.recorded_spans() if s.name == "bind"]
    assert bind.attrs == {"route": "eager", "bytes": 0}


def test_the_buffer_keeps_its_bound():
    rec = timing.SpanRecorder(max_spans=10)
    with rec.recording():
        for i in range(25):
            with rec.call("run_icp") as call:
                rec.begin("prepare").end(i=i)
                rec.count("syncs", 2)
            assert call.attrs["syncs"] == 2
    spans = rec.spans()
    assert len(spans) == 10
    assert spans[-1].name == "call" and spans[-2].attrs == {"i": 24}
    rec.clear()
    assert rec.spans() == []


def test_the_switch_is_the_profilers_flag():
    """``torch.autograd.profiler._is_profiler_enabled``, private: a torch
    that moves or renames it turns the spans off silently but for this."""
    flag = lambda: torch.autograd.profiler._is_profiler_enabled  # noqa
    assert flag() is False and not timing.RECORDER.on()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert flag() is True and timing.RECORDER.on()
    with torch.autograd.profiler.profile():
        assert flag() is True
    assert flag() is False and not timing.RECORDER.on()
    with timing.recording():
        assert timing.RECORDER.on()
    assert not timing.RECORDER.on()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs and the syncs counted "
                    "are the card's")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_card_syncs_counted_and_no_device_span(cuda):
    sc = synthetic_scene(width=128, device=cuda)  # 16,384 points
    cfg = ft.ICPConfig(tolerance=0.0, max_iterations=20)
    graphs.clear()
    for _ in range(2):  # eager, then captured: the next call replays
        ft.run_icp(sc.source, sc.target, cfg)
    torch.cuda.synchronize()
    # set first: the mode's first setting in a process warns once itself
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with timing.recording():
                res = ft.run_icp(sc.source, sc.target, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    synced = [w for w in caught if "synchroniz" in str(w.message)]
    assert int(res.num_iterations) == 20
    spans = timing.recorded_spans()
    (call,) = [s for s in spans if s.name == "call"]
    assert call.attrs["syncs"] == len(synced) == 2
    assert call.attrs["chunks_replay"] == 3
    assert call.attrs["kernel_launches"] > 0
    (bind,) = [s for s in spans if s.name == "bind"]
    assert bind.attrs["route"] == "graphs"
    # the target bound once, the state copied into each chunk's graph
    assert 0 < bind.attrs["bytes"] < call.attrs["bytes_copied"]

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    timing.clear_spans()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ft.run_icp(sc.source, sc.target, cfg)
        torch.cuda.synchronize()
    names = {s.name for s in timing.recorded_spans()}
    assert {"call", "bind", "copy_in", "replay", "copy_out"} <= names
    device = {e.name for e in prof.events()
              if e.device_type == DeviceType.CUDA}
    assert device and not device & SPAN_NAMES
    graphs.clear()
