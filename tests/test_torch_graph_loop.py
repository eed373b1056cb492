"""The registration loops in chunks (``models/icp.py::drive_chunks``), on
the CPU, against the loops as they ran before the chunks: one iteration at
a time, the done flag read every ``DONE_CHECK_EVERY`` iterations
(``_per_iteration_*`` below, kept here as the reference).

On the card each chunk is one replay of a CUDA graph (``utils/graphs.py``);
here the same chunk bodies run eagerly and must give the per-iteration
loops' results bit for bit: point (K1's and K2's plain versions), plane,
Morton (K3's plain version), NDT (K4's) and the batched loop, with
``max_iterations`` a multiple of 8 and not, stopping early and not. The
chunked loops also stay within the JAX package's tolerances
(``tests/test_torch_icp.py``, ``test_torch_ndt.py``), and the graph cache
key separates what must not share a graph. A rehearsal of the captured
route (``graphs.bind`` swapped for a recorder that runs the chunk eagerly)
shows which chunks a loop would capture and replay, and the cache's own
bookkeeping is held to what runs on the CPU: the first loop of a key runs
eagerly, and every launch counter is registered.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fpcr_tpu as f
import fpcr_tpu_torch as ft
from fpcr_tpu_torch.core.transforms import RigidTransform
from fpcr_tpu_torch.models import batch as mb
from fpcr_tpu_torch.models import icp as mi
from fpcr_tpu_torch.models import ndt as mn
from fpcr_tpu_torch.models.icp import DONE_CHECK_EVERY, _prepare
from fpcr_tpu_torch.utils import diagnostics, graphs

torch.set_num_threads(2)

ATOL = 1e-5  # tests/test_torch_icp.py: per-iteration errors against JAX
GAP = 1e-5  # transform RMSE between the two packages' results


# ---- the loops as they ran before the chunks -----------------------------

def _per_iteration_icp(source, target, config, target_normals=None,
                       source_normals=None):
    (source, target, source_mask, target_mask, target_normals,
     source_normals, matcher_state, unsort, config) = _prepare(
        source, target, config, None, None, target_normals, source_normals,
        None)
    device = source.device
    carries_normals = source_normals is not None
    nan = torch.full((), float("nan"), device=device)
    points, normals = source, source_normals
    transform = RigidTransform.identity(device=device)
    prev_error = torch.full((), float("inf"), device=device)
    done = torch.zeros((), dtype=torch.bool, device=device)
    num_iterations = torch.zeros((), dtype=torch.int32, device=device)
    errors, fractions, delta_t, delta_rot = [], [], [], []
    for it in range(config.max_iterations):
        if it and it % DONE_CHECK_EVERY == 0 and bool(done):
            break
        new_points, inc, error, aux = mi.icp_iteration(
            points, target, config, source_mask, target_mask,
            target_normals, None, matcher_state, normals)
        active = ~done
        errors.append(torch.where(active, error, nan))
        fractions.append(torch.where(active, aux.matched_fraction, nan))
        delta_t.append(torch.where(active, torch.linalg.vector_norm(
            inc.translation), nan))
        delta_rot.append(torch.where(active, mi.rotation_angle(inc.rotation),
                                     nan))
        converged = (error < config.tolerance) | (
            torch.abs(error - prev_error) < config.tolerance)
        composed = inc.compose(transform)
        points = torch.where(active, new_points, points)
        if carries_normals:
            normals = torch.where(active,
                                  torch.matmul(normals, inc.rotation.T),
                                  normals)
        transform = RigidTransform(
            torch.where(active, composed.rotation, transform.rotation),
            torch.where(active, composed.translation, transform.translation))
        prev_error = torch.where(active, error, prev_error)
        num_iterations = num_iterations + active.to(torch.int32)
        done = done | (active & converged)
    n = config.max_iterations
    return mi.ICPResult(
        transform=transform, errors=mi._nan_padded(errors, n, device),
        num_iterations=num_iterations, converged=done,
        points=points if unsort is None else points[unsort],
        matched_fraction=mi._nan_padded(fractions, n, device),
        delta_t=mi._nan_padded(delta_t, n, device),
        delta_rot=mi._nan_padded(delta_rot, n, device))


def _per_iteration_ndt(source, grid, config):
    dev = source.device
    n = source.shape[0]
    moments = mn._moments_fn(source, grid, config, None)
    n_valid = float(max(n, 1))
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    gn_map = torch.tensor(mn._gn_map().reshape(42, 90), dtype=torch.float32,
                          device=dev)
    nan = torch.tensor(float("nan"), device=dev)
    R = torch.eye(3, dtype=torch.float32, device=dev)
    t = torch.zeros(3, dtype=torch.float32, device=dev)
    delta_norm = torch.tensor(float("inf"), device=dev)
    frac = torch.zeros((), dtype=torch.float32, device=dev)
    iterations = torch.zeros((), dtype=torch.int32, device=dev)
    errors = []
    for it in range(config.max_iterations):
        active = delta_norm > config.tolerance
        if it and it % DONE_CHECK_EVERY == 0 and not bool(active):
            break
        x = torch.matmul(source, R.T) + t
        c = x.sum(dim=0) / n_valid
        y = x - c
        s, sr, qsum, count = moments(x)
        extra = torch.stack([qsum, count, (count > 0).to(torch.float32)], 1)
        H, g, (err_num, err_den, n_hit) = mn._assemble_Hg(s, sr, y, extra,
                                                          gn_map, None)
        floor = config.damping + 1e-7 * (torch.trace(H) / 6.0) + 1e-30
        L, info = torch.linalg.cholesky_ex(H + floor * eye6)
        delta = -config.step_scale * torch.cholesky_solve(g[:, None], L)[:, 0]
        finite = (info == 0) & torch.isfinite(delta).all()
        delta = torch.where(finite, delta, torch.zeros_like(delta))
        R_inc = mn.rotation_exp(delta[3:6])
        R_new = torch.matmul(R_inc, R)
        t_new = torch.matmul(R_inc, t - c) + c + delta[0:3]
        err = err_num / torch.clamp(err_den, min=1.0)
        dn = torch.sqrt(torch.sum(delta[0:3] ** 2)
                        / (1.0 + torch.linalg.vector_norm(c)) ** 2
                        + torch.sum(delta[3:6] ** 2))
        dn = torch.where(finite, dn, torch.full_like(dn, float("inf")))
        R = torch.where(active, R_new, R)
        t = torch.where(active, t_new, t)
        errors.append(torch.where(active, err, nan))
        frac = torch.where(active, n_hit / n_valid, frac)
        iterations = iterations + active.to(torch.int32)
        delta_norm = torch.where(active, dn, delta_norm)
    errs = torch.full((config.max_iterations,), float("nan"),
                      dtype=torch.float32, device=dev)
    if errors:
        errs[:len(errors)] = torch.stack(errors)
    converged = (delta_norm <= config.tolerance) & (frac > 0.0)
    return R, t, iterations, errs, converged, frac


def _per_iteration_batch(sources, targets, normals, config):
    b, device = sources.shape[0], sources.device
    nan = torch.full((), float("nan"), device=device)
    points = sources
    rot = torch.eye(3, device=device).expand(b, 3, 3).contiguous()
    trans = torch.zeros((b, 3), device=device)
    prev_error = torch.full((b,), float("inf"), device=device)
    done = torch.zeros(b, dtype=torch.bool, device=device)
    num_iterations = torch.zeros(b, dtype=torch.int32, device=device)
    errors, fractions, delta_t, delta_rot = [], [], [], []
    for it in range(config.max_iterations):
        if it and it % DONE_CHECK_EVERY == 0 and bool(done.all()):
            break
        new_points, inc, error, aux = mi.icp_iteration(
            points, targets, config, target_normals=normals)
        frac = aux.matched_fraction
        active = ~done
        errors.append(torch.where(active, error, nan))
        fractions.append(torch.where(active, frac, nan))
        delta_t.append(torch.where(active, torch.linalg.vector_norm(
            inc.translation, dim=-1), nan))
        delta_rot.append(torch.where(active, mi.rotation_angle(inc.rotation),
                                     nan))
        converged = (error < config.tolerance) | (
            torch.abs(error - prev_error) < config.tolerance)
        a3 = active[:, None, None]
        points = torch.where(a3, new_points, points)
        trans = torch.where(active[:, None], torch.matmul(
            inc.rotation, trans[:, :, None])[:, :, 0] + inc.translation,
            trans)
        rot = torch.where(a3, torch.matmul(inc.rotation, rot), rot)
        prev_error = torch.where(active, error, prev_error)
        num_iterations = num_iterations + active.to(torch.int32)
        done = done | (active & converged)

    def rows(values):
        out = torch.full((b, config.max_iterations), float("nan"),
                         device=device)
        if values:
            out[:, :len(values)] = torch.stack(values, dim=1)
        return out

    return mi.ICPResult(transform=RigidTransform(rot, trans),
                        errors=rows(errors), num_iterations=num_iterations,
                        converged=done, points=points,
                        matched_fraction=rows(fractions),
                        delta_t=rows(delta_t), delta_rot=rows(delta_rot))


# ---- helpers ---------------------------------------------------------------

def _bits(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    if x.dtype == torch.float32:
        return x.view(torch.int32)
    return x


def _same(a, b, what=""):
    """Every tensor of two results equal bit for bit (NaNs included)."""
    la = [a] if isinstance(a, torch.Tensor) else list(a)
    lb = [b] if isinstance(b, torch.Tensor) else list(b)
    assert len(la) == len(lb)
    for k, (x, y) in enumerate(zip(la, lb)):
        if isinstance(x, RigidTransform):
            _same(tuple(x), tuple(y), f"{what}[{k}]")
            continue
        assert x.shape == y.shape and x.dtype == y.dtype, (what, k)
        assert torch.equal(_bits(x), _bits(y)), (what, k)


def _scene(width=16):
    s = ft.synthetic_scene(width=width, device="cpu")
    return s.source, s.target, s


ICP_RUNS = {
    "point K1": dict(matcher="pallas"),
    "point K2": dict(matcher="pallas", pallas_mode="packed6_idx"),
    "point exact": dict(exact_distances=True),
    "point polar": dict(solver="polar"),
    "point trimmed": dict(max_correspondence_dist=1.0, auto_trim=9.0,
                          exact_distances=True),
    "plane K1": dict(metric="plane", matcher="pallas"),
    "symmetric": dict(metric="symmetric", exact_distances=True),
    "gicp": dict(metric="gicp", exact_distances=True),
    "morton K3": dict(matcher="morton", morton_impl="pallas",
                      morton_chunk=128, morton_window=64),
    "morton K3p": dict(matcher="morton", morton_impl="pallas",
                       morton_chunk=128, morton_window=64,
                       pallas_mode="packed6_idx"),
    "morton xla rescue": dict(matcher="morton", morton_shifts=2,
                              morton_rescue=64),
    "grid": dict(matcher="grid", grid_cap=16),
}


@pytest.mark.parametrize("iterations", [5, 8, 13, 40])
@pytest.mark.parametrize("name", list(ICP_RUNS))
def test_chunked_icp_equals_per_iteration_loop(name, iterations):
    """``run_icp`` in chunks equals the per-iteration loop bit for bit:
    transform, every per-iteration row, iterations, done, points."""
    src, tgt, _ = _scene()
    cfg = ft.ICPConfig(max_iterations=iterations, **ICP_RUNS[name])
    ref = _per_iteration_icp(src, tgt, cfg)
    got = ft.run_icp(src, tgt, cfg)
    _same(tuple(got), tuple(ref), name)
    if iterations == 40:  # the scenes converge well before 40
        assert int(got.num_iterations) < 33 and bool(got.converged)


@pytest.mark.parametrize("iterations", [3, 8, 13, 21])
@pytest.mark.parametrize("lookup", ["gather", "banded-xla", "banded-k4"])
def test_chunked_ndt_equals_per_iteration_loop(lookup, iterations):
    """``_ndt_loop`` in chunks equals the per-iteration loop bit for bit,
    through the gather lookup, the XLA band and K4's plain version."""
    src, _, s = _scene(32)
    gt = ft.gt_transform((0.004, -0.002, 0.003), (0.002, -0.003, 0.002),
                         device="cpu")
    scan = gt.apply(src)
    grid = ft.build_ndt_grid(src, 0.3)
    kw = {"gather": dict(lookup="gather"),
          "banded-xla": dict(lookup="banded", lookup_impl="xla"),
          "banded-k4": dict(lookup="banded", lookup_impl="pallas",
                            lookup_chunk=128)}[lookup]
    cfg = ft.resolve_ndt_config(
        ft.NDTConfig(voxel_size=0.3, max_iterations=iterations, **kw), grid,
        scan)
    if lookup != "gather":
        scan = scan[mn.cell_key_order(scan, grid).long()].contiguous()
    _same(mn._ndt_loop(scan, grid, cfg),
          _per_iteration_ndt(scan, grid, cfg), lookup)


@pytest.mark.parametrize("iterations", [6, 8, 13, 30])
@pytest.mark.parametrize("name", ["point K1", "point K2", "plane K1"])
def test_chunked_batch_equals_per_iteration_loop(name, iterations):
    """``register_batch``'s batched loop in chunks equals the per-iteration
    loop bit for bit; the elements stop at different iterations."""
    src, _, _ = _scene()
    rng = np.random.default_rng(5)
    tgts = torch.stack([ft.gt_transform(
        tuple(0.02 * rng.standard_normal(3)),
        tuple(0.04 * (k + 1) * rng.standard_normal(3)),
        device="cpu").apply(src) for k in range(4)])
    srcs = torch.stack([src] * 4)
    kw = {"point K1": dict(matcher="pallas"),
          "point K2": dict(matcher="pallas", pallas_mode="packed6_idx"),
          "plane K1": dict(metric="plane", matcher="pallas")}[name]
    cfg = ft.ICPConfig(max_iterations=iterations, **kw)
    normals = (torch.stack([ft.estimate_normals(t) for t in tgts])
               if cfg.metric == "plane" else None)
    ref = _per_iteration_batch(srcs, tgts, normals, cfg)
    got = mb._batched_loop(srcs, tgts, normals, cfg)
    _same(tuple(got), tuple(ref), name)
    if iterations == 30:
        n_it = got.num_iterations
        assert bool(got.converged.all()) and int(n_it.max()) < 24
        assert int(n_it.min()) < int(n_it.max())  # a ragged stop


def _jax_scene(width=16):
    s = f.synthetic_scene(width=width)
    return np.array(s.source), np.array(s.target)


@pytest.mark.parametrize("iterations", [13, 21])
@pytest.mark.parametrize("kw", [dict(matcher="pallas",
                                     exact_distances=True),
                                dict(metric="plane", exact_distances=True)],
                         ids=["point", "plane"])
def test_chunked_icp_within_jax_tolerance(kw, iterations):
    """The chunked loop against ``fpcr_tpu.run_icp`` at lengths that are
    not a multiple of 8: errors within 1e-5 an iteration, iterations within
    1, the transforms within 1e-5 RMSE."""
    src, tgt = _jax_scene()
    # the plane metric takes JAX's normals on both sides: the two packages'
    # PCA normals differ at float32 noise, enough to move the plane runs
    nrm = np.array(f.estimate_normals(jnp.asarray(tgt)))
    jcfg = f.ICPConfig(max_iterations=iterations, **kw)
    jr = f.run_icp(jnp.asarray(src), jnp.asarray(tgt), jcfg,
                   target_normals=jnp.asarray(nrm))
    tr = ft.run_icp(torch.as_tensor(src), torch.as_tensor(tgt),
                    ft.ICPConfig(max_iterations=iterations, **kw),
                    target_normals=torch.as_tensor(nrm))
    nj, nt = int(jr.num_iterations), int(tr.num_iterations)
    assert abs(nj - nt) <= 1
    k = min(nj, nt)
    np.testing.assert_allclose(tr.errors.numpy()[:k],
                               np.asarray(jr.errors)[:k], rtol=0, atol=ATOL)
    t_j = ft.RigidTransform(torch.as_tensor(np.array(jr.transform.rotation)),
                            torch.as_tensor(
                                np.array(jr.transform.translation)))
    assert float(ft.transform_rmse(tr.transform, t_j,
                                   torch.as_tensor(src))) < GAP


def test_chunked_ndt_within_jax_tolerance():
    """NDT in chunks (13 iterations, not a multiple of 8) against
    ``fpcr_tpu.run_ndt``: equal iterations, transforms within 1e-5."""
    src, _ = _jax_scene(32)
    g = f.gt_transform((0.004, -0.002, 0.003), (0.002, -0.003, 0.002))
    scan = np.array(g.apply(jnp.asarray(src)))
    jr = f.run_ndt(jnp.asarray(scan), jnp.asarray(src),
                   f.NDTConfig(voxel_size=0.3, max_iterations=13))
    tr = ft.run_ndt(torch.as_tensor(scan), torch.as_tensor(src),
                    ft.NDTConfig(voxel_size=0.3, max_iterations=13))
    assert abs(int(jr.num_iterations) - int(tr.num_iterations)) <= 1
    t_j = ft.RigidTransform(torch.as_tensor(np.array(jr.transform.rotation)),
                            torch.as_tensor(
                                np.array(jr.transform.translation)))
    assert float(ft.transform_rmse(tr.transform, t_j,
                                   torch.as_tensor(scan))) < GAP


# ---- one chunk, in place, against masked iterations ------------------------

def _masked_iteration(state, consts):
    """One iteration of the chunk as it ran before it updated its state in
    place: new tensors, each masked by ``done``. ``(state, row [4, ...])``."""
    (target, source_mask, target_mask, target_normals, matcher_state,
     config, group) = consts
    points, normals, rotation, translation, prev_error, done, n_it = state
    nan = torch.full((), float("nan"), device=points.device)
    new_points, inc, error, aux = mi.icp_iteration(
        points, target, config, source_mask, target_mask, target_normals,
        group, matcher_state, normals)
    active = ~done
    a1, a2 = active[..., None], active[..., None, None]
    row = torch.where(active, torch.stack([
        error, torch.broadcast_to(aux.matched_fraction, error.shape),
        torch.linalg.vector_norm(inc.translation, dim=-1),
        mi.rotation_angle(inc.rotation)]), nan)
    converged = (error < config.tolerance) | (
        torch.abs(error - prev_error) < config.tolerance)
    composed = inc.compose(RigidTransform(rotation, translation))
    return mi._ICPState(
        torch.where(a2, new_points, points), normals,
        torch.where(a2, composed.rotation, rotation),
        torch.where(a1, composed.translation, translation),
        torch.where(active, error, prev_error), done | (active & converged),
        n_it + active.to(torch.int32)), row


def _chunk_case(name, tolerance=1e-6):
    """``(state, consts)`` of the chunk ``name`` at its loop's start:
    point (K1's plain version), Morton (K3's) or a batch of three."""
    src, tgt, _ = _scene()
    kw = {"point K1": dict(matcher="pallas"),
          "morton K3": dict(matcher="morton", morton_impl="pallas",
                            morton_chunk=128, morton_window=64),
          "batch K1": dict(matcher="pallas")}[name]
    cfg = ft.ICPConfig(max_iterations=0, tolerance=tolerance, **kw)
    if name.startswith("batch"):
        poses = [((0.05, -0.02, 0.03), (0.02, 0.01, -0.02)),
                 ((0.01, 0.02, -0.01), (-0.01, 0.02, 0.01)),
                 ((-0.03, 0.01, 0.02), (0.01, -0.02, 0.02))]
        srcs = torch.stack([ft.gt_transform(r, t, device="cpu").apply(src)
                            for r, t in poses])
        tgts = torch.stack([tgt] * 3)
        prep = _prepare(srcs, tgts, cfg, batched=True)
        state = mb._first_state(prep.source, None)
    else:
        prep = _prepare(src, tgt, cfg)
        state = mi._ICPState(
            prep.source, None, torch.eye(3), torch.zeros(3),
            torch.full((), float("inf")), torch.zeros((), dtype=torch.bool),
            torch.zeros((), dtype=torch.int32))
    consts = (prep.target, prep.source_mask, prep.target_mask,
              prep.target_normals, prep.matcher_state, prep.config, None)
    return state, graphs.contiguous(consts)


@pytest.mark.parametrize("stop", ["inside", "last", "never"])
@pytest.mark.parametrize("name", ["point K1", "morton K3", "batch K1"])
def test_in_place_chunk_equals_masked_iterations(name, stop):
    """The chunk, which updates its state in place, equals eight masked
    iterations bit for bit, state and rows, from a state whose loop stops
    inside the chunk (at its third iteration), at its last iteration, or
    never (no tolerance: the cap ends the loop); rows after the stop are
    NaN, and the state before the chunk, a copy, is left as it was."""
    state, consts = _chunk_case(name, 0.0 if stop == "never" else 1e-6)
    trajectory = [state]
    for _ in range(40):
        trajectory.append(_masked_iteration(trajectory[-1], consts)[0])
    done_at = next((j for j, st in enumerate(trajectory)
                    if bool(st.done.all())), None)
    assert (done_at is None) == (stop == "never")
    assert stop == "never" or done_at >= 8, done_at
    start = {"inside": lambda: trajectory[done_at - 3],
             "last": lambda: trajectory[done_at - 8],
             "never": lambda: trajectory[4]}[stop]()
    ref, rows = start, []
    for _ in range(8):
        ref, row = _masked_iteration(ref, consts)
        rows.append(row)
    kept = graphs.owned(start)
    given = graphs.owned(start)
    got, got_rows = mi._icp_chunk(given, consts, 8)
    assert got is given  # updated in place
    _same([t for t in (*got, got_rows) if t is not None],
          [t for t in (*ref, torch.stack(rows)) if t is not None], name)
    ran = {"inside": 3, "last": 8, "never": 8}[stop]
    assert torch.isnan(got_rows[ran:]).all()
    assert not torch.isnan(got_rows[:ran]).all(dim=tuple(
        range(1, got_rows.ndim))).any()
    _same([t for t in start if t is not None],
          [t for t in kept if t is not None])


def test_skip_if_all_is_a_no_op_off_a_capture():
    """Off a capture (the CPU, an eager loop) ``skip_if_all`` runs its
    block whatever ``done`` holds and changes nothing; in a warm-up it only
    notes that the chunk has a block."""
    ran = []
    for done in (torch.zeros(3, dtype=torch.bool),
                 torch.ones(3, dtype=torch.bool), torch.ones((), dtype=bool)):
        before = done.clone()
        with graphs.skip_if_all(done):
            ran.append(True)
        assert torch.equal(done, before)
    assert ran == [True] * 3
    assert graphs._capturing.parts is None
    assert not graphs._capturing.met_block
    graphs._capturing.warming = True
    try:
        with graphs.skip_if_all(torch.ones((), dtype=torch.bool)):
            ran.append(True)
        assert graphs._capturing.met_block and len(ran) == 4
    finally:
        graphs._capturing.warming = False
        graphs._capturing.met_block = False


@pytest.mark.parametrize("route", ["eager", "rehearsed"])
def test_a_loop_leaves_the_callers_tensors(route, monkeypatch):
    """The chunk updates its state in place, never the caller's tensors:
    the eager route and a replay (rehearsed) each work on a copy."""
    if route == "rehearsed":
        monkeypatch.setattr(graphs, "bind", _Recorder())
        monkeypatch.setattr(graphs, "captured", lambda device: True)
    src, tgt, _ = _scene()
    srcs = torch.stack([src, src + 0.01])
    kept = (src.clone(), srcs.clone())
    ft.run_icp(src, tgt, ft.ICPConfig(max_iterations=13))
    mb._batched_loop(srcs, torch.stack([tgt] * 2), None,
                     ft.ICPConfig(max_iterations=13))
    assert torch.equal(src, kept[0]) and torch.equal(srcs, kept[1])


# ---- the captured route, rehearsed on the CPU ------------------------------

class _Recorder:
    """In place of ``graphs.bind``: records each chunk's keys, ``(the
    loop's key, the graph's key, k)``, and runs the chunk eagerly, as a
    replay would compute it: on a copy of the state, as a replay on its
    static buffers (a chunk may update its state in place)."""

    def __init__(self):
        self.keys = []

    def __call__(self, fn, consts):
        loop_key, _ = graphs.cache_key(fn, (consts,))

        def step(state, k):
            self.keys.append((loop_key, graphs.cache_key(fn, (state, k))[0],
                              k))
            return fn(graphs.owned(state), consts, k)
        step.finish = lambda: None  # nothing replayed, nothing to count
        return step


@pytest.fixture
def rehearse(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(graphs, "bind", rec)
    monkeypatch.setattr(graphs, "captured", lambda device: True)
    return rec


@pytest.mark.parametrize("iterations,chunks", [(8, [8]), (13, [8, 5]),
                                               (20, [8, 8, 4])])
def test_captured_route_chunks_and_keys(rehearse, iterations, chunks):
    """The captured route runs ``DONE_CHECK_EVERY``-iteration chunks and a
    shorter last one (two graphs: every full chunk shares one key), and
    gives the eager route's bits."""
    src, tgt, _ = _scene()
    cfg = ft.ICPConfig(max_iterations=iterations, tolerance=0.0)
    got = ft.run_icp(src, tgt, cfg)
    assert [k[2] for k in rehearse.keys] == chunks
    assert len(set(rehearse.keys)) == len(set(chunks))
    ref = _per_iteration_icp(src, tgt, cfg)
    _same(tuple(got), tuple(ref))


@pytest.mark.parametrize("matcher", ["xla", "morton"])
def test_jax_ordered_call_reaches_the_keyword_calls_graphs(rehearse,
                                                            matcher):
    """``run_icp`` called in the JAX package's positional order
    ``(src, tgt, cfg, None, None, tn, None, sn)`` keys the same graphs, a
    chunk for a chunk, as the keyword call, and gives its bits."""
    src, tgt, _ = _scene()
    tn, sn = ft.estimate_normals(tgt), ft.estimate_normals(src)
    cfg = ft.ICPConfig(metric="symmetric", matcher=matcher,
                       max_iterations=13, tolerance=0.0)
    pos = ft.run_icp(src, tgt, cfg, None, None, tn, None, sn)
    keys = list(rehearse.keys)
    rehearse.keys.clear()
    key = ft.run_icp(src, tgt, cfg, target_normals=tn, source_normals=sn)
    assert keys == rehearse.keys and [k[2] for k in keys] == [8, 5]
    _same(tuple(pos), tuple(key))


def test_captured_route_reads_done_once_a_chunk(rehearse):
    """A run that converges early stops at the next chunk boundary: one
    chunk per ``DONE_CHECK_EVERY`` iterations run, none after the stop."""
    src, tgt, _ = _scene()
    res = ft.run_icp(src, tgt, ft.ICPConfig(max_iterations=60))
    n_it = int(res.num_iterations)
    assert len(rehearse.keys) == -(-n_it // DONE_CHECK_EVERY)


def test_eager_routes_do_not_capture(rehearse):
    """Under ``debug_nans`` the loops run eagerly, one iteration a chunk:
    nothing reaches the graph runner."""
    src, tgt, _ = _scene()
    with diagnostics.debug_nans():
        res = ft.run_icp(src, tgt, ft.ICPConfig(max_iterations=13))
    assert rehearse.keys == []
    _same(tuple(res), tuple(_per_iteration_icp(
        src, tgt, ft.ICPConfig(max_iterations=13))))


def test_debug_nans_raises_at_the_first_non_finite_iteration():
    """The eager route's check still names the first non-finite
    iteration."""
    src, tgt, _ = _scene()
    bad = src.clone()
    bad[3] = float("nan")
    with diagnostics.debug_nans(), pytest.raises(
            FloatingPointError, match="iteration 0"):
        ft.run_icp(bad, tgt, ft.ICPConfig(max_iterations=13, solver="polar",
                                          exact_distances=True))


def test_max_iterations_share_a_graph(rehearse):
    """Runs that differ only in ``max_iterations`` key the same chunk (the
    chunk never reads it); another tolerance keys another graph."""
    src, tgt, _ = _scene()
    for n in (16, 24):
        ft.run_icp(src, tgt, ft.ICPConfig(max_iterations=n, tolerance=0.0))
    assert len(set(rehearse.keys)) == 1
    ft.run_icp(src, tgt, ft.ICPConfig(max_iterations=8, tolerance=1e-9))
    assert len(set(rehearse.keys)) == 2


def test_ndt_and_batch_take_the_captured_route(rehearse):
    """NDT and the batched loop go through the graph runner chunk by
    chunk, 8 then 5 iterations, with their own chunk functions."""
    src, _, _ = _scene(32)
    grid = ft.build_ndt_grid(src, 0.3)
    mn._ndt_loop(src, grid, ft.NDTConfig(voxel_size=0.3, lookup="gather",
                                         lookup_impl="xla",
                                         max_iterations=13, tolerance=0.0))
    srcs = torch.stack([src[:256]] * 2)
    mb._batched_loop(srcs, srcs + 0.01, None,
                     ft.ICPConfig(max_iterations=13, tolerance=0.0))
    fns = [k[0][0] for k in rehearse.keys]
    assert fns == [mn._ndt_chunk] * 2 + [mi._icp_chunk] * 2


def _key(*args, fn=mi._icp_chunk):
    return graphs.cache_key(fn, args)[0]


def test_cache_key_separates_what_must_not_share_a_graph():
    """Shapes, dtypes, a missing optional input, configs, chunk lengths and
    functions each key their own graph; equal inputs share one; the
    tensors come back in order, contiguous."""
    x = torch.zeros(16, 3)
    cfg = ft.ICPConfig()
    base = _key(x, None, cfg, 8)
    assert base == _key(torch.ones(16, 3), None, cfg, 8)
    assert base == _key(torch.ones(16, 3).T.contiguous().T.contiguous(),
                        None, cfg, 8)
    others = [_key(torch.zeros(17, 3), None, cfg, 8),
              _key(torch.zeros(16, 3, dtype=torch.float64), None, cfg, 8),
              _key(x, torch.zeros(16, 3), cfg, 8),
              _key(x, None, dataclasses.replace(cfg, metric="plane"), 8),
              _key(x, None, dataclasses.replace(cfg, morton_window=64), 8),
              _key(x, None, cfg, 5),
              _key((x,), None, cfg, 8),
              _key(x, None, cfg, 8, fn=mn._ndt_chunk)]
    assert len(set(others + [base])) == len(others) + 1
    t = torch.arange(12.0).reshape(3, 4).T
    key, tensors = graphs.cache_key(mi._icp_chunk, (t, [t, None]))
    assert len(tensors) == 2 and all(u.is_contiguous() for u in tensors)
    assert torch.equal(tensors[0], t)
    rebuilt = graphs._unflatten(key[1], iter(tensors))
    assert isinstance(rebuilt[1], list) and rebuilt[1][1] is None


def test_cache_key_rebuilds_named_tuples():
    """A NamedTuple state comes back as its own type, its host fields kept
    (the voxel table's ``table_bits``)."""
    src, tgt, _ = _scene()
    table = mi.build_matcher_state(tgt, None, ft.ICPConfig(matcher="grid"))
    state = mi._ICPState(src, None, torch.eye(3), torch.zeros(3),
                         torch.zeros(()), torch.zeros((), dtype=torch.bool),
                         torch.zeros((), dtype=torch.int32))
    key, tensors = graphs.cache_key(mi._icp_chunk, (state, table))
    st, tb = graphs._unflatten(key[1], iter(tensors))
    assert type(st) is mi._ICPState and st.normals is None
    assert type(tb) is type(table) and tb.table_bits == table.table_bits
    assert graphs._clone(st)._fields == st._fields
    with pytest.raises(TypeError):  # a host value must be hashable
        graphs.cache_key(mi._icp_chunk, (state, {"a": 1}))


def test_first_loop_of_a_key_runs_eagerly():
    """A key's first loop runs its chunks eagerly and holds nothing; its
    second loop goes to the graphs (which take CUDA tensors only); another
    config is another key, and ``clear`` forgets the keys seen."""
    cache = graphs.GraphCache()
    x = torch.arange(6.0).reshape(2, 3)

    def body(state, consts, k):
        return state + consts[0] * k

    step = cache.bind(body, (x, ft.ICPConfig()))
    assert torch.equal(step(torch.ones(2, 3), 2), 1 + 2 * x)
    assert len(cache) == 0 and cache.nbytes() == 0
    with pytest.raises(ValueError, match="CUDA"):
        cache.bind(body, (x.clone(), ft.ICPConfig()))
    other = (x, ft.ICPConfig(tolerance=1e-3))
    assert torch.equal(cache.bind(body, other)(x, 1), 2 * x)
    cache.clear()
    assert torch.equal(cache.bind(body, (x, ft.ICPConfig()))(x, 0), x)
    assert cache.loops == {"eager": 3}


def test_every_launch_counter_is_registered():
    """Every wrapper of the ops modules that counts its launches is in
    ``_build.COUNTED``, the registry the graphs read and add a replay's
    launches to."""
    import importlib
    import pkgutil

    import fpcr_tpu_torch.ops as ops
    from fpcr_tpu_torch import _build
    from fpcr_tpu_torch.core import metrics

    found = [metrics._psum]
    for info in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(f"fpcr_tpu_torch.ops.{info.name}")
        found += [obj for obj in vars(mod).values() if callable(obj)
                  and isinstance(getattr(obj, "launches", None), (int, dict))]
    assert len(found) >= 12
    assert all(any(fn is c for c in _build.COUNTED) for fn in found)


@pytest.mark.parametrize("sites, counted, mode, agree", [
    ({"cudaGraphLaunch": 72}, 72, "captured", True),
    ({"cudaLaunchKernel": 72}, 72, "eager", True),
    ({"cudaLaunchKernel": 69}, 72, "eager", False),  # records lost
    ({"cudaGraphLaunch": 72}, 72, "eager", False),
    ({"cudaGraphLaunch": 70, "cudaLaunchKernel": 2}, 72, "captured", False),
    ({"cudaGraphLaunch": 71, "no runtime call": 1}, 72, "captured", False),
    ({"cudaLaunchKernel": 73}, 72, "eager", False),  # an uncounted launch
    ({}, 0, "eager", False),
])
def test_trace_check_needs_every_counted_launch(sites, counted, mode, agree):
    """``chip_smoke.py``'s check of the launch counters against a traced
    run: a session agrees only where every counted launch shows as a device
    event under the runtime call of its route; the check retakes a session
    that lost records and fails where none agrees."""
    import sys

    sys.path.insert(0, ".")
    import chip_smoke

    assert chip_smoke.sites_agree(sites, counted, mode) is agree
    assert chip_smoke.SITE_TAKES > 1


@pytest.mark.parametrize("sites, counted, ran, agree", [
    ({"cudaGraphLaunch": 45}, 72, (24, 9), True),
    ({"cudaGraphLaunch": 72}, 72, (24, 0), True),
    ({"cudaGraphLaunch": 72}, 72, (24, 9), False),  # skipped ones ran
    ({"cudaGraphLaunch": 44}, 72, (24, 9), False),  # records lost
    # a conditional body's kernel, launched by the device
    ({"cudaGraphLaunch": 44, "no runtime call": 1}, 72, (24, 9), True),
    ({"no runtime call": 45}, 72, (24, 9), True),
    ({"cudaGraphLaunch": 44, "cudaLaunchKernel": 1}, 72, (24, 9), False),
    ({}, 0, (0, 0), False),
])
def test_trace_check_takes_out_skipped_iterations(sites, counted, ran,
                                                   agree):
    """``chip_smoke.py``'s check of a captured run whose iterations sit in
    conditional nodes: the replays count the launches of the skipped
    iterations, the trace shows only those of the iterations that ran, each
    under the graph's launch or, launched by the device, under none."""
    import sys

    sys.path.insert(0, ".")
    import chip_smoke

    assert chip_smoke.sites_agree(sites, counted, "captured", ran) is agree


def test_loop_finish_counts_the_skipped_blocks():
    """While recording, a loop's runner zeroes its key's count of blocks
    run when bound and, at its end, adds to the call the blocks of its
    replayed chunks that did not run; unrecorded, it adds nothing."""
    from fpcr_tpu_torch.utils import timing

    entry = graphs._Key([torch.zeros(1)])
    entry.bodies = torch.full((), 7, dtype=torch.int64)
    loop = graphs.Loop(mi._icp_chunk, (), entry=entry)
    assert not loop.counting and int(entry.bodies) == 7
    with timing.recording(), timing.call("test") as call:
        loop = graphs.Loop(mi._icp_chunk, (), entry=entry)
        assert loop.counting and int(entry.bodies) == 0
        loop.blocks_run = 16  # two replayed chunks of 8 blocks
        entry.bodies.fill_(11)  # as the device counts the blocks run
        loop.finish()
    assert call.attrs["iterations_skipped"] == 5
