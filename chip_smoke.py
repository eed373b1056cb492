#!/usr/bin/env python3
"""Drive the PyTorch port (``fpcr_tpu_torch``) on one CUDA card, end to end.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:

1. device — the card's name, ``nvidia-smi``'s name and power limit, the
   torch and CUDA versions, and the float32 precision settings;
2. build — kernels K1, K2 and the min-only sweep
   (``fpcr_tpu_torch/csrc/matching.cu``), K3 and K3p (``csrc/morton.cu``)
   and K4 (``csrc/ndt.cu``) with one nvcc per source, started together,
   into one library; ptxas' registers and spills of each kernel;
3. kernel vs plain — K1, K2, the min-only sweep, K3, K3p and K4 against
   their plain PyTorch versions on the card, at the test shapes and the
   main path's shapes, K2's 2^16 gate, and K4 against the 7-offset gather
   oracle at 262,144 points;
4. main path — each path driven with the launch counters set to 0 just
   before it and read just after, every scene to its ground-truth
   threshold: point-to-point ICP (``matcher='pallas'``, K1) on the
   synthetic scene, Bunny, the full Bunny and the hall scan, and the same
   four with ``pallas_mode='packed6_idx'`` through K2; point-to-plane
   ICP through K1 on the reference's plane workloads; Morton band ICP
   (``matcher='morton'``, K3, chunk 512, window 64) at 262,144 and
   1,048,576 points and on the hall scan, and its ``packed6_idx`` twin
   through K3p at 262,144 and 1,048,576 points; the coarse-to-fine pipeline
   on the full Bunny (K1 coarse, K3 fine); NDT through K4 (``run_ndt`` on
   prebuilt grids at 262,144 and 1,048,576 points, and map tracking: three
   scans against one grid and one resolved config) and ``register_ndt`` on
   the hall scan (gather NDT stages, then plane ICP through K1); then small
   scenes registered on the card and on the CPU must agree, for each
   matcher, the packed brute runs step by step within a bound derived from
   the drift of their points and matches, where the first picks that
   differ must be swaps at a bucket's edge;
5. times — ms/iter by the slope method (point ICP at 16,384 through K1 and
   K2, plane ICP at 16,384, Morton ICP through K3 and K3p and NDT at
   262,144 and 1,048,576), K1, K2, the min-only sweep, K3, K3p and K4 alone
   against their plain versions, the packed-reduction study
   (``fpcr_tpu_torch.bench.packed_reduction.main``), normals, the plane
   solve, the NDT grid build and the share of each stage of a point
   iteration, each printed beside the card's name and power limit.

The line before the last is a JSON object describing each kernel: its
launches on the main path, its largest difference from its plain version,
its time and its plain version's, and its bound, the least time the card
could take for the same work (the larger of its bytes over the HBM rate and
its float32 operations over the float32 peak, from this run's inputs). The
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device the
script exits 1 and prints no result.
"""

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

CASE_TOL = dict(rtol=1e-6, atol=1e-7)  # kernel vs plain sqdist
TIE_REL = 1e-6  # an index may differ only where the two picks tie this close
# the H100 SXM's published peaks (NVIDIA's data sheet, at 700 W): HBM bytes
# per second and float32 operations per second outside the tensor cores
HBM_BPS, FP32_FLOPS = 3.35e12, 67e12
# float32 operations a (source, target) pair needs, counted in the norm
# form d = |p|^2 - 2 p.q + |q|^2 that the TPU kernels use, with |q|^2
# precomputed: an argmin or a min over targets needs |q|^2 - 2 p.q alone,
# 3 FMAs (|p|^2 is one add a row), while a packed key buckets the full
# distance, one add more. The port's kernels compute the difference form
# (3 sub, 3 FMA) for accuracy; DESIGN_PAIR_FLOPS is that design's cost,
# logged beside the bound but not the bound
ARGMIN_PAIR_FLOPS, PACKED_PAIR_FLOPS, DESIGN_PAIR_FLOPS = 6, 7, 9
# K4's float32 operations per hit neighbour (r, S r, q, w, S mu', the 12
# sums; csrc/ndt.cu) and per query (x')
K4_HIT_FLOPS, K4_QUERY_FLOPS = 71, 6
SCENES = [  # (name, scene kind, max_iterations, GT transform-RMSE threshold)
    ("synthetic-16384", "synthetic", 40, 1e-5),
    ("bunny-8171", "bunny", 40, 1e-5),
    ("bunny-full-35947", "bunny_full", 40, 1e-5),
    ("hall-16384", "hall", 100, 1e-4),
]
# the reference's plane workloads, brute matcher K1; the synthetic
# threshold is 10x what the JAX package reaches on the CPU (2.7e-7),
# rounded up to a decade
PLANE_SCENES = [
    ("plane synthetic-16384", "synthetic", 50, 1e-5),
    ("plane bunny-8171", "bunny", 40, 1e-5),
    ("plane hall-16384", "hall", 100, 1e-4),
]
# near-registered ground truths: the large-N report's
# (scripts/tpu_report.py) and the hall morton test's
# (tests/test_registration_datasets.py)
NEAR_GT = ((0.004, -0.002, 0.003), (0.002, -0.003, 0.002))
HALL_NEAR_GT = ((0.002, -0.003, 0.001), (0.001, -0.002, 0.002))
LARGE_WIDTHS = (512, 1024)  # 262,144 and 1,048,576 points
BAND = dict(morton_chunk=512, morton_window=64)  # the production geometry
# Morton band ICP through K3; the large-N thresholds are 10x what the JAX
# package reaches on the CPU for the same runs (5.4e-7, 8.9e-7, 1.7e-7),
# rounded up to a decade
MORTON_SCENES = [  # (name, scene kind, metric, max_iterations, threshold)
    ("morton point synthetic-262144", "grid-0", "point", 30, 1e-5),
    ("morton point synthetic-1048576", "grid-1", "point", 30, 1e-5),
    ("morton plane synthetic-262144", "grid-0", "plane", 30, 1e-5),
    ("morton plane hall-16384", "hall_near", "plane", 50, 1e-4),
]
# the packed reduction (pallas_mode='packed6_idx'): K2 on K1's scenes to
# their thresholds; K3p at 262k/1M to 10x what the JAX package reaches on
# the CPU for the same runs (7.721e-7 in 5 iterations, 1.823e-6 in 14; its
# TPU kernel in interpret mode, tests/test_torch_packed.py run as a
# script), rounded up to a decade
PACKED = dict(pallas_mode="packed6_idx")
PACKED_SCENES = [(f"packed {name}", kind, iters, thr)
                 for name, kind, iters, thr in SCENES]
PACKED_MORTON_SCENES = [
    ("morton packed point synthetic-262144", "grid-0", "point", 30, 1e-5),
    ("morton packed point synthetic-1048576", "grid-1", "point", 30, 1e-4),
]


# NDT: the saddle of scripts/tpu_report.py:154-173 with N(0, 0.002) noise,
# voxel 0.12, near GT; the thresholds are 10x what the JAX package reaches
# on the CPU for the same runs, rounded up to a decade, and its iteration
# counts, which the card's must match within 1 (PERF.md §2 gives the runs)
NDT_VOXEL = 0.12
NDT_SCENES = [  # (name, width, threshold, JAX iterations)
    ("ndt synthetic-262144", 512, 1e-3, 9),  # JAX: 1.138e-5
    ("ndt synthetic-1048576", 1024, 1e-4, 9),  # JAX: 7.710e-6
]
# map tracking, three scans: (threshold, JAX iterations per scan); JAX:
# 1.239e-5, 1.193e-5, 1.211e-5
NDT_TRACK = (1e-3, (12, 22, 15))
# K4 vs its plain version: the two round r, q and the sums with and without
# FMAs, and exp(-d2/2·q) carries q's rounding into w, so the moments agree
# to ~1e-6 relative; counts, which are integers, and x', the same float
# subtractions, agree exactly
K4_RTOL, K4_ATOL_REL = 1e-4, 1e-5
# K4 vs the 7-offset gather oracle, which forms r = x - mu on absolute
# coordinates (|x| up to 4 on the saddle): r rounds ~2.4e-7 apart, so q of a
# stiff voxel (|S| ~ 1e4, |r| ~ 0.06) moves by ~2|Sr|·2.4e-7 ~ 3e-4, and w
# by d2/2 of that (d2 ~ 1 at voxel 0.12): 1e-3 relative bounds it
ORACLE_RTOL, ORACLE_ATOL_REL = 1e-3, 1e-5


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def build_scene(ft, kind, device):
    if kind.startswith("grid-"):  # a large grid, near-registered
        width = LARGE_WIDTHS[int(kind[5:])]
        return ft.transformed_scene(ft.surface_grid(width, device=device),
                                    *NEAR_GT)
    if kind == "hall_near":
        return ft.transformed_scene(ft.load_hall_scan(device=device),
                                    *HALL_NEAR_GT)
    if kind == "synthetic":
        return ft.synthetic_scene(width=128, device=device)
    if kind == "bunny":
        return ft.bunny_scene(device=device)
    if kind == "bunny_full":
        return ft.bunny_scene(resampled=False, device=device)
    return ft.hall_scene(device=device)


def phase_device(torch):
    from fpcr_tpu_torch.utils.precision import (pin_f32_precision,
                                                precision_settings)

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("device", f"torch.cuda.get_device_name(0) = {name}; "
                  f"device_count = {torch.cuda.device_count()}")
    log("device", f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
                  f"python {sys.version.split()[0]}")
    pin_f32_precision()
    for k, v in precision_settings().items():
        log("device", f"{k} = {v}")
    return name, smi


def phase_build():
    from fpcr_tpu_torch import _build

    res = _build.build()
    log("build", f"{'cached' if res.cached else 'built'} {res.path.name} "
                 f"in {res.seconds:.2f} s")
    for line in res.log.splitlines():
        if any(w in line for w in ("registers", "spill", "entry function",
                                   "error", "warning")):
            log("build", "ptxas: " + line.strip())
    _build.load_library()


def kernel_cases(torch, np, ft, dev):
    rng = np.random.default_rng(77)
    p = rng.uniform(-2, 2, size=(300, 3)).astype(np.float32)
    q = rng.uniform(-2, 2, size=(500, 3)).astype(np.float32)
    mask = np.ones(500, bool)
    mask[200:] = False
    rng = np.random.default_rng(78)
    po = rng.uniform(-1, 1, size=(131, 3)).astype(np.float32)
    qo = rng.uniform(-1, 1, size=(259, 3)).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    cases = [
        ("300x500", t(p), t(q), None),
        ("300x500-masked", t(p), t(q), t(mask)),
        ("131x259", t(po), t(qo), None),
        ("tie-1x4", t(np.zeros((1, 3), np.float32)),
         t(np.array([[5, 0, 0], [1, 0, 0], [2, 0, 0], [1, 0, 0]],
                    np.float32)), None),
        ("300x500-all-masked", t(p), t(q), t(np.zeros(500, bool))),
    ]
    for name, kind in (("synthetic-16384^2", "synthetic"),
                       ("bunny-8171^2", "bunny"),
                       ("bunny-full-35947^2", "bunny_full")):
        s = build_scene(ft, kind, dev)
        cases.append((name, s.source, s.target, None))
    return cases


def _tie_rows(name, p, q, ki, oi, within):
    """The rows where two picks differ; raises unless at each of them
    ``within(d_kernel, d_plain)`` holds for the picks' exact (float64)
    squared distances."""
    diff = np.nonzero(ki != oi)[0]
    if diff.size:
        p64 = p.cpu().numpy().astype(np.float64)[diff]
        q64 = q.cpu().numpy().astype(np.float64)
        dk = ((p64 - q64[ki[diff]]) ** 2).sum(1)
        do = ((p64 - q64[oi[diff]]) ** 2).sum(1)
        if not within(dk, do).all():
            raise AssertionError(f"{name}: index differs beyond a tie")
    return diff


def packed_tie(idx_bits):
    """Two packed picks may differ only within one bucket, 2^-(23-b) of the
    smaller distance, and the few ulp by which the kernel's FMAs and the
    plain version's separate roundings put a distance on either side of a
    bucket edge."""
    bound = 2.0 ** -(23 - idx_bits) + 2.0 ** -20
    return lambda dk, do: (np.abs(dk - do)
                           <= bound * np.minimum(dk, do) + 1e-30)


def _check_k1(name, p, q, mask):
    from fpcr_tpu_torch.ops.matching import nn_argmin_plain
    from fpcr_tpu_torch.ops.matching_cuda import nn_argmin_cuda

    ki, kd = nn_argmin_cuda(p, q, mask)
    torch.cuda.synchronize()
    oi, od = nn_argmin_plain(p, q, mask, exact=True)
    ki, kd, oi, od = (x.cpu().numpy() for x in (ki, kd, oi, od))
    m = q.shape[0]
    if ki.min() < 0 or ki.max() > m - 1:
        raise AssertionError(f"{name}: index outside [0, {m - 1}]")
    none_valid = np.isinf(od)
    if not np.array_equal(np.isinf(kd), none_valid):
        raise AssertionError(f"{name}: inf rows differ")
    if (ki[none_valid] != 0).any():
        raise AssertionError(f"{name}: a row with no valid target "
                             "did not get index 0")
    fin = ~none_valid
    np.testing.assert_allclose(kd[fin], od[fin], **CASE_TOL,
                               err_msg=f"{name}: sqdist")
    err = float(np.abs(kd[fin] - od[fin]).max()) if fin.any() else 0.0
    diff = _tie_rows(name, p, q, ki, oi, lambda dk, do: np.abs(dk - do)
                     <= TIE_REL * np.maximum(1.0, do))
    if (diff.size and mask is not None
            and not mask.cpu().numpy()[ki[diff]].all()):
        raise AssertionError(f"{name}: picked a masked target")
    if name == "tie-1x4" and ki[0] != 1:
        raise AssertionError(f"tie case picked {ki[0]}, expected 1")
    log("kernel", f"{name}: idx equal on {p.shape[0] - diff.size}/"
                  f"{p.shape[0]} rows, near-ties {diff.size}, "
                  f"max |sqdist err| {err:.3e}, no-valid rows "
                  f"{int(none_valid.sum())} -> ok")
    return err


def _check_k2(name, p, q, mask):
    """K2 against ``nn_argmin_packed_plain`` with the default index bits:
    indices in [0, m-1], idx 0 and inf where no target is valid, equal
    picks except within one bucket, the exact distance of each pick, and
    the distances of equal picks within CASE_TOL."""
    from fpcr_tpu_torch.ops.matching import (nn_argmin_packed_plain,
                                             packed_idx_bits)
    from fpcr_tpu_torch.ops.matching_cuda import nn_argmin_packed_cuda

    bits = packed_idx_bits(q.shape[0])
    ki, kd = nn_argmin_packed_cuda(p, q, mask, idx_bits=bits)
    torch.cuda.synchronize()
    oi, od = nn_argmin_packed_plain(p, q, mask, idx_bits=bits)
    ki, kd, oi, od = (x.cpu().numpy() for x in (ki, kd, oi, od))
    m = q.shape[0]
    if ki.min() < 0 or ki.max() > m - 1:
        raise AssertionError(f"K2 {name}: index outside [0, {m - 1}]")
    none_valid = np.isinf(od)
    if not np.array_equal(np.isinf(kd), none_valid) or (
            ki[none_valid] != 0).any():
        raise AssertionError(f"K2 {name}: rows with no valid target differ")
    fin = ~none_valid
    exact = ((p.cpu().numpy().astype(np.float64)
              - q.cpu().numpy().astype(np.float64)[ki]) ** 2).sum(1)
    np.testing.assert_allclose(kd[fin], exact[fin], **CASE_TOL,
                               err_msg=f"K2 {name}: exact sqdist")
    same = fin & (ki == oi)
    np.testing.assert_allclose(kd[same], od[same], **CASE_TOL,
                               err_msg=f"K2 {name}: sqdist")
    err = float(np.abs(kd[same] - od[same]).max()) if same.any() else 0.0
    diff = _tie_rows(f"K2 {name}", p, q, ki, oi, packed_tie(bits))
    if mask is not None and not mask.cpu().numpy()[ki[fin]].all():
        raise AssertionError(f"K2 {name}: picked a masked target")
    if name == "tie-1x4" and ki[0] != 1:
        raise AssertionError(f"K2 tie case picked {ki[0]}, expected 1")
    log("kernel", f"K2 {name} ({bits} index bits): idx equal on "
                  f"{p.shape[0] - diff.size}/{p.shape[0]} rows, in-bucket "
                  f"swaps {diff.size}, max |sqdist err| {err:.3e} on equal "
                  f"picks, no-valid rows {int(none_valid.sum())} -> ok")
    return err


def _check_min_only(name, p, q, mask):
    from fpcr_tpu_torch.bench.packed_reduction import nn_min_only_plain
    from fpcr_tpu_torch.ops.matching_cuda import nn_min_only_cuda

    kd = nn_min_only_cuda(p, q, mask)
    torch.cuda.synchronize()
    od = nn_min_only_plain(p, q, mask)
    kd, od = kd.cpu().numpy(), od.cpu().numpy()
    if not np.array_equal(np.isinf(kd), np.isinf(od)):
        raise AssertionError(f"min-only {name}: inf rows differ")
    fin = np.isfinite(od)
    np.testing.assert_allclose(kd[fin], od[fin], **CASE_TOL,
                               err_msg=f"min-only {name}")
    err = float(np.abs(kd[fin] - od[fin]).max()) if fin.any() else 0.0
    log("kernel", f"min-only {name}: max |sqdist err| {err:.3e} -> ok")
    return err


def phase_kernel_vs_plain(torch, np, ft, dev):
    """K1, K2 and the min-only sweep against their plain versions on the
    same inputs, and K2's 2^16 gate; the largest error of each."""
    from fpcr_tpu_torch.ops.matching import nn_argmin_packed
    from fpcr_tpu_torch.ops.matching_cuda import nn_argmin_packed_cuda

    worst = {"nn_argmin": 0.0, "nn_argmin_packed": 0.0, "nn_min_only": 0.0}
    for name, p, q, mask in kernel_cases(torch, np, ft, dev):
        for key, check in (("nn_argmin", _check_k1),
                           ("nn_argmin_packed", _check_k2),
                           ("nn_min_only", _check_min_only)):
            worst[key] = max(worst[key], check(name, p, q, mask))
    before = nn_argmin_packed_cuda.launches
    q = torch.zeros((70000, 3), device=dev)
    try:
        nn_argmin_packed(q[:8].contiguous(), q)
    except ValueError as e:
        if "packed6_idx" not in str(e):
            raise
        log("kernel", f"K2 at 70,000 targets raises: {e} -> ok")
    else:
        raise AssertionError("K2's 2^16 gate did not raise")
    if nn_argmin_packed_cuda.launches != before:
        raise AssertionError("K2 launched past its 2^16 gate")
    return worst


def band_cases(torch, np, ft, dev):
    """K3's cases: ``(name, p sorted along the table, table, extra, chunk,
    window)``. Small ones first, then the main path's shapes at the
    production geometry (512/64) and the defaults (256/256)."""
    from fpcr_tpu_torch.ops.morton import (build_morton_table,
                                           source_morton_order)

    def case(name, q, p, mask=None, shift=0.0, extra=True, geoms=((256,
                                                                     256),)):
        table = build_morton_table(q, mask, shift=shift)
        ps = p[source_morton_order(p, table).long()].contiguous()
        e = ((table.points_sorted * 0.5 + 0.25).contiguous() if extra
             else None)
        return [(f"{name} c{c}/w{w}", ps, table, e, c, w) for c, w in geoms]

    rng = np.random.default_rng(79)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    q = t(rng.uniform(-2, 2, size=(3000, 3)).astype(np.float32))
    near = lambda x, n: (x[:n] + 0.002 * t(rng.normal(  # noqa: E731
        size=(n, 3)).astype(np.float32))).contiguous()
    out = []
    out += case("n<chunk 100x3000", q, near(q, 100))
    out += case("n%chunk 1000x3000", q, near(q, 1000), extra=False,
                geoms=((512, 64),))
    out += case("m<band 300x500", q[:500].contiguous(), near(q, 300))
    out += case("masked-tail 2500x3000", q, near(q, 2500),
                mask=torch.arange(3000, device=dev) < 2200)
    out += case("no-extra 2500x3000", q, near(q, 2500), extra=False)
    out += case("shift-0.5 2500x3000", q, near(q, 2500), shift=0.5,
                geoms=((512, 64),))
    both = ((512, 64), (256, 256))
    for w in LARGE_WIDTHS:
        s = build_scene(ft, f"grid-{LARGE_WIDTHS.index(w)}", dev)
        out += case(f"synthetic-{w * w}", s.target, s.source, geoms=both)
    s = build_scene(ft, "hall_near", dev)
    out += case("hall-16384", s.target, s.source, geoms=both)
    s = build_scene(ft, "bunny_full", dev)
    out += case("bunny-full-35947", s.target, s.source, geoms=both)
    return out


def _check_band(name, p, table, extra, chunk, window, packed):
    """K3 (``packed`` False) or K3p against its plain version: indices in
    [0, m-1] and below valid_count, matched points and extras bit-equal to
    the table rows, every row finite, picks equal except at ties (K3) or
    within one bucket (K3p), distances of equal picks within CASE_TOL.
    Returns the largest |sqdist err| over equal picks."""
    from fpcr_tpu_torch.ops.morton import (band_idx_bits, band_rows,
                                           morton_nn_band_packed_plain,
                                           morton_nn_band_plain)
    from fpcr_tpu_torch.ops.morton_cuda import (morton_nn_cuda,
                                                morton_nn_packed_cuda)

    label = "K3p" if packed else "K3"
    kernel = morton_nn_packed_cuda if packed else morton_nn_cuda
    km, kd, ki, ke = kernel(p, table, extra, chunk=chunk, window=window)
    torch.cuda.synchronize()
    plain = morton_nn_band_packed_plain if packed else morton_nn_band_plain
    om, od, oi, oe = plain(p, table, extra, chunk=chunk, window=window)
    q = table.points_sorted
    m, vc = q.shape[0], int(table.valid_count)
    kil = ki.long()
    if int(ki.min()) < 0 or int(ki.max()) > m - 1:
        raise AssertionError(f"{label} {name}: index outside [0, {m - 1}]")
    if int(ki.max()) >= vc:
        raise AssertionError(f"{label} {name}: picked a masked row")
    if not torch.equal(km, q[kil]):
        raise AssertionError(f"{label} {name}: matched points differ from "
                             "the table rows")
    if extra is not None and not torch.equal(ke, extra[kil]):
        raise AssertionError(f"{label} {name}: matched extra differs from "
                             "the table rows")
    kd, od, ki_np, oi_np = (x.cpu().numpy() for x in (kd, od, ki, oi))
    if not np.isfinite(kd).all() or not np.isfinite(od).all():
        raise AssertionError(f"{label} {name}: a row found no valid target")
    same = ki_np == oi_np
    np.testing.assert_allclose(kd[same], od[same], **CASE_TOL,
                               err_msg=f"{label} {name}: sqdist")
    err = float(np.abs(kd[same] - od[same]).max())
    if packed:
        within = packed_tie(band_idx_bits(band_rows(chunk, window)))
    else:
        within = lambda dk, do: (np.abs(dk - do)  # noqa: E731
                                 <= TIE_REL * np.maximum(1.0, do))
    diff = _tie_rows(f"{label} {name}", p, q, ki_np, oi_np, within)
    swaps = "in-bucket swaps" if packed else "near-ties"
    log("kernel", f"{label} {name}: idx equal on {p.shape[0] - diff.size}/"
                  f"{p.shape[0]} rows, {swaps} {diff.size}, max |sqdist "
                  f"err| {err:.3e}, matched"
                  f"{'' if extra is None else ' and extra'} bit-equal to the "
                  "table rows -> ok")
    return err


def phase_band_vs_plain(torch, np, ft, dev):
    """K3 against ``morton_nn_band_plain`` and K3p against
    ``morton_nn_band_packed_plain`` on the same inputs; the largest error
    of each."""
    worst = {"morton_nn": 0.0, "morton_nn_packed": 0.0}
    for name, p, table, extra, chunk, window in band_cases(torch, np, ft,
                                                            dev):
        for key, packed in (("morton_nn", False), ("morton_nn_packed", True)):
            worst[key] = max(worst[key], _check_band(
                name, p, table, extra, chunk, window, packed))
    return worst


def ndt_scene(torch, np, ft, width, dev):
    """The NDT scene: a ``width``² saddle with N(0, 0.002) noise drawn by
    ``numpy.random.default_rng(0)``, and its near-GT target."""
    rng = np.random.default_rng(0)
    ax = np.linspace(-2, 2, width, dtype=np.float32)
    xs, ys = np.meshgrid(ax, ax, indexing="ij")
    pts = np.stack([xs.ravel(), ys.ravel(), (xs * xs - ys * ys).ravel()], 1)
    pts = pts + rng.normal(0, 0.002, pts.shape).astype(np.float32)
    return ft.transformed_scene(
        torch.as_tensor(pts.astype(np.float32), device=dev), *NEAR_GT)


def fused_cases(torch, np, ft, dev):
    """K4's cases: ``(name, sorted source, grid, voxel, chunk, window,
    neighborhood, source mask, hold against the gather oracle)``. The scenes
    of the CPU tests (uniform; rows off the grid, one cell below its min
    face and a masked row; x-planes wider than the band), then the main
    path's grids at 262,144 and 1,048,576 points with the resolved window
    and with 1024 (a band of two shared-memory tiles)."""
    from fpcr_tpu_torch.ops.ndt import cell_key_order

    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    out = []

    def add(name, pts, src, h, geoms, mask=None, hoods=("direct7",)):
        grid = ft.build_ndt_grid(t(pts), h)
        src = t(src)
        src = src[cell_key_order(src, grid).long()].contiguous()
        for hood in hoods:
            for c, w in geoms:
                out.append((f"{name} {hood} c{c}/w{w}", src, grid, h, c, w,
                            hood, mask, False))

    rng = np.random.default_rng(23)
    pts = rng.uniform(0, 2.0, (6000, 3)).astype(np.float32)
    add("uniform-6000", pts,
        pts + rng.normal(0, 0.02, pts.shape).astype(np.float32), 0.25,
        ((256, 256), (512, 64)))
    rng = np.random.default_rng(31)
    pts = rng.uniform(0, 2.0, (4096, 3)).astype(np.float32)
    src = pts + rng.normal(0, 0.02, pts.shape).astype(np.float32)
    src[:64] -= 3.0
    src[64:128, 0] = -0.1
    add("edges-4096", pts, src, 0.25, ((256, 256),),
        mask=t(np.arange(4096) != 100), hoods=("direct7", "direct1"))
    rng = np.random.default_rng(7)
    ys, zs = np.meshgrid(np.linspace(0, 5.0, 40, dtype=np.float32),
                         np.linspace(0, 5.0, 40, dtype=np.float32),
                         indexing="ij")
    pts = np.concatenate([np.stack([np.full(ys.size, 0.25 * xi, np.float32),
                                    ys.ravel(), zs.ravel()], 1)
                          for xi in range(6)])
    pts = pts + rng.normal(0, 0.01, pts.shape).astype(np.float32)
    add("sheets-9600", pts, pts + np.float32(0.02), 0.25,
        ((256, 256), (512, 3968)))  # 3968: the window cap, band 8,576
    for w in LARGE_WIDTHS:
        s = ndt_scene(torch, np, ft, w, dev)
        grid = ft.build_ndt_grid(s.target, NDT_VOXEL)
        cfg = ft.resolve_ndt_config(ft.NDTConfig(voxel_size=NDT_VOXEL),
                                    grid, s.source)
        src = s.source[cell_key_order(s.source, grid).long()].contiguous()
        for win in (cfg.lookup_window, 1024):
            out.append((f"ndt-{w * w} direct7 c512/w{win}", src, grid,
                        NDT_VOXEL, 512, win, "direct7", None,
                        w == LARGE_WIDTHS[0] and win == cfg.lookup_window))
    return out


def phase_fused_vs_plain(torch, np, ft, dev):
    """K4 against ``ndt_fused_moments_plain`` on the same inputs, and at
    262,144 points against the 7-offset gather oracle. Returns the largest
    |kernel - plain| over the moment and sum lanes."""
    from fpcr_tpu_torch.ops.ndt import (gauss_d1_d2, ndt_fused_moments_plain,
                                        prepare_fused_tables,
                                        reference_neighborhood_moments)
    from fpcr_tpu_torch.ops.ndt_cuda import ndt_fused_moments_cuda

    worst = 0.0
    for name, src, grid, h, chunk, window, hood, mask, oracle in fused_cases(
            torch, np, ft, dev):
        d1, d2 = gauss_d1_d2(0.55, h)
        kw = dict(voxel_size=h, d1=abs(d1), d2=d2, neighborhood=hood,
                  chunk=chunk, window=window, source_mask=mask)
        tables = prepare_fused_tables(grid)
        rk, xk = ndt_fused_moments_cuda(src, grid, tables, **kw)
        torch.cuda.synchronize()
        rp, xp = ndt_fused_moments_plain(src, grid, tables, **kw)
        if not torch.equal(rk[:, 10], rp[:, 10]):
            raise AssertionError(f"K4 {name}: neighbour counts differ on "
                                 f"{int((rk[:, 10] != rp[:, 10]).sum())} "
                                 "rows")
        if not torch.equal(xk, xp):
            raise AssertionError(f"K4 {name}: x' differs")
        if bool((rk[:, 12:] != 0).any()) or not bool(
                torch.isfinite(rk).all()):
            raise AssertionError(f"K4 {name}: non-finite or nonzero pad "
                                 "lanes")
        a, b = rk[:, :12].cpu().numpy(), rp[:, :12].cpu().numpy()
        for lanes in (slice(0, 10), slice(11, 12)):
            np.testing.assert_allclose(
                a[:, lanes], b[:, lanes], rtol=K4_RTOL,
                atol=K4_ATOL_REL * max(float(np.abs(b[:, lanes]).max()),
                                       1e-30), err_msg=f"K4 {name}")
        err = float(np.abs(a - b).max())
        rel = float((np.abs(a - b) / (np.abs(b) + 1e-30))[
            np.abs(b) > 1e-6 * np.abs(b).max()].max())
        worst = max(worst, err)
        log("kernel", f"K4 {name}: counts and x' equal on {src.shape[0]} "
                      f"rows (max count {int(rk[:, 10].max())}), max |err| "
                      f"{err:.3e}, max rel err {rel:.3e} -> ok")
        if oracle:
            WS, WSr, count, qsum = reference_neighborhood_moments(
                src, grid, abs(d1), d2)
            if bool((rk[:, 10] > count).any()):
                raise AssertionError("K4 found a neighbour the gather "
                                     "oracle does not")
            same = rk[:, 10] == count
            share = float(same.to(torch.float32).mean())
            s = rk[same]
            x = xk[same]
            wsr = torch.stack([
                s[:, 0] * x[:, 0] + s[:, 1] * x[:, 1] + s[:, 2] * x[:, 2]
                - s[:, 6],
                s[:, 1] * x[:, 0] + s[:, 3] * x[:, 1] + s[:, 4] * x[:, 2]
                - s[:, 7],
                s[:, 2] * x[:, 0] + s[:, 4] * x[:, 1] + s[:, 5] * x[:, 2]
                - s[:, 8]], dim=1)
            for label, got, want in (("WS", s[:, 0:6], WS[same]),
                                     ("qsum", s[:, 11], qsum[same])):
                want = want.cpu().numpy()
                np.testing.assert_allclose(
                    got.cpu().numpy(), want, rtol=ORACLE_RTOL,
                    atol=ORACLE_ATOL_REL * float(np.abs(want).max()),
                    err_msg=f"K4 vs gather oracle {name} {label}")
            # Σ w S r: K4 forms r from x − lo and the oracle from x, each
            # rounded to ~2⁻²⁴ of its magnitude, which S (|S| up to ~1e3)
            # multiplies, and K4's WS·x' − WSμ' cancels; the error scales
            # with |WS|·max(|x|, |x − lo|) + |WSμ'|, not with the result
            xs = src[same]
            reach = torch.maximum(xs.abs(), (xs - grid.lo).abs()).amax(1)
            cancel = (s[:, 0:6].abs().sum(1) * reach
                      + s[:, 6:9].abs().sum(1))[:, None]
            if bool(((wsr - WSr[same]).abs() > ORACLE_RTOL * WSr[same].abs()
                     + 1e-6 * cancel).any()):
                raise AssertionError(f"K4 vs gather oracle {name}: WSr")
            log("kernel", f"K4 {name} vs the 7-offset gather oracle: counts "
                          f"equal on {share:.6f} of the rows (the band "
                          f"covers), moments within rtol {ORACLE_RTOL:g} "
                          "there -> ok")
            if share < 0.999:
                raise AssertionError("the resolved band missed neighbours "
                                     f"on {1 - share:.4%} of the rows")
    return worst


def _wrappers():
    from fpcr_tpu_torch.ops.matching_cuda import (nn_argmin_cuda,
                                                  nn_argmin_packed_cuda,
                                                  nn_min_only_cuda)
    from fpcr_tpu_torch.ops.morton_cuda import (morton_nn_cuda,
                                                morton_nn_packed_cuda)
    from fpcr_tpu_torch.ops.ndt_cuda import ndt_fused_moments_cuda

    return {"nn_argmin": nn_argmin_cuda,
            "nn_argmin_packed": nn_argmin_packed_cuda,
            "nn_min_only": nn_min_only_cuda,
            "morton_nn": morton_nn_cuda,
            "morton_nn_packed": morton_nn_packed_cuda,
            "ndt_fused_moments": ndt_fused_moments_cuda}


def drive(torch, path, fn):
    """Run one path of the main path with every launch counter set to 0
    just before it, and return the counts read just after."""
    wrappers = _wrappers()
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    counts = {k: w.launches for k, w in wrappers.items()}
    log("main", f"path '{path}' done in {time.perf_counter() - t0:.2f} s, "
                f"launches {counts}")
    return counts


def register(torch, ft, name, s, run, thr, kernel, per_iteration=1):
    """Register one scene with ``run(source, target)``, check the result
    against its ground truth and the kernel's launches against the
    iterations, and log the outcome."""
    w = _wrappers()[kernel]
    before = w.launches
    t0 = time.perf_counter()
    res = run(s.source, s.target)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    grown = w.launches - before
    fine = getattr(res, "fine", res)
    it = int(fine.num_iterations)
    gt = float(ft.transform_rmse(res.transform, s.ground_truth, s.source))
    err = fine.errors.cpu()
    ok_shape = (tuple(fine.points.shape) == tuple(s.source.shape)
                and bool(torch.isfinite(fine.points).all())
                and bool(torch.isfinite(err[:it]).all())
                and bool(torch.isnan(err[it:]).all()))
    log("main", f"{name}: iterations {it}, converged "
                f"{bool(fine.converged)}, final error "
                f"{float(err[it - 1]):.6e}, GT transform RMSE {gt:.3e} "
                f"(< {thr:g}), wall {wall:.3f} s, {kernel} launches "
                f"+{grown}")
    if not ok_shape:
        raise AssertionError(f"{name}: non-finite or misshapen result")
    if grown < per_iteration * it:
        raise AssertionError(f"{name}: {kernel} launched {grown} times in "
                             f"{it} iterations")
    if not gt < thr:
        raise AssertionError(f"{name}: GT transform RMSE {gt} >= {thr}")
    return res


def phase_main_path(torch, ft, dev):
    """Every path of the slice, each driven between counter reads; returns
    the launches of each kernel summed over the paths, and the
    packed-reduction study's ``{variant: (ms, index agreement)}``."""
    def brute(metric, scenes, kernel="nn_argmin", **mode):
        # K2 launches its sweep and its epilogue every iteration
        per_iteration = 2 if kernel == "nn_argmin_packed" else 1

        def fn():
            for name, kind, iters, thr in scenes:
                s = build_scene(ft, kind, dev)
                cfg = ft.ICPConfig(metric=metric, max_iterations=iters,
                                   matcher="pallas", **mode)
                register(torch, ft, name, s,
                         lambda a, b: ft.run_icp(a, b, cfg), thr, kernel,
                         per_iteration=per_iteration)
        return fn

    def morton(scenes=MORTON_SCENES, kernel="morton_nn", **mode):
        def fn():
            for name, kind, metric, iters, thr in scenes:
                s = build_scene(ft, kind, dev)
                cfg = ft.ICPConfig(metric=metric, matcher="morton",
                                   max_iterations=iters, **BAND, **mode)
                register(torch, ft, name, s,
                         lambda a, b: ft.run_icp(a, b, cfg), thr, kernel,
                         per_iteration=cfg.morton_shifts)
        return fn

    def coarse_to_fine():
        s = build_scene(ft, "bunny_full", dev)
        run = lambda a, b: ft.icp_coarse_to_fine(  # noqa: E731
            a, b, coarse_config=ft.ICPConfig(max_iterations=40),
            fine_config=ft.ICPConfig(matcher="morton", max_iterations=20),
            coarse_points=2048)
        k1 = _wrappers()["nn_argmin"].launches
        register(torch, ft, "coarse-to-fine bunny-full-35947", s, run, 1e-4,
                 "morton_nn")
        if _wrappers()["nn_argmin"].launches == k1:
            raise AssertionError("the coarse stage never launched K1")

    import numpy as np

    def check_iterations(name, res, jax_iters):
        it = int(res.num_iterations)
        log("main", f"{name}: the JAX package took {jax_iters} iterations on "
                    f"the CPU, the card {it}")
        if abs(it - jax_iters) > 1:
            raise AssertionError(f"{name}: {it} iterations, JAX {jax_iters}")

    def ndt_runs():
        for name, width, thr, jax_iters in NDT_SCENES:
            s = ndt_scene(torch, np, ft, width, dev)
            grid = ft.build_ndt_grid(s.target, NDT_VOXEL)
            cfg = ft.NDTConfig(voxel_size=NDT_VOXEL, max_iterations=50)
            res = register(torch, ft, name, s,
                           lambda a, b: ft.run_ndt(a, b, cfg, grid=grid),
                           thr, "ndt_fused_moments")
            check_iterations(name, res, jax_iters)

    def map_tracking():
        from fpcr_tpu_torch.models import ndt as ndt_model

        map_cloud = ndt_scene(torch, np, ft, LARGE_WIDTHS[0], dev).source
        grid = ft.build_ndt_grid(map_cloud, NDT_VOXEL)
        cfg = ft.resolve_ndt_config(
            ft.NDTConfig(voxel_size=NDT_VOXEL, max_iterations=50), grid,
            map_cloud)
        log("main", f"map tracking: resolved lookup={cfg.lookup} "
                    f"impl={cfg.lookup_impl} window={cfg.lookup_window}")
        if cfg.lookup_impl != "pallas" or not cfg.lookup_resolved:
            raise AssertionError("the resolved config does not run K4")
        probes = []
        resolve = ndt_model._resolve_fused

        def spy(config, grid, source=None):  # counts coverage probes
            if not config.lookup_resolved:
                probes.append(source)
            return resolve(config, grid, source)

        ndt_model._resolve_fused = spy
        try:
            rng = np.random.default_rng(0)
            thr, jax_iters = NDT_TRACK
            for k in range(3):
                gt = ft.gt_transform(tuple(0.01 * rng.standard_normal(3)),
                                     tuple(0.05 * rng.standard_normal(3)),
                                     device=dev)
                scan = gt.apply(map_cloud)
                s = ft.RegistrationScene(scan, map_cloud, gt.inverse())
                res = register(torch, ft, f"map tracking scan {k}", s,
                               lambda a, b: ft.run_ndt(a, b, cfg, grid=grid),
                               thr, "ndt_fused_moments")
                check_iterations(f"map tracking scan {k}", res, jax_iters[k])
        finally:
            ndt_model._resolve_fused = resolve
        if probes:
            raise AssertionError(f"{len(probes)} scans ran a coverage probe")

    def register_ndt_hall():
        s = build_scene(ft, "hall", dev)
        run = lambda a, b: ft.register_ndt(  # noqa: E731
            a, b, ft.ICPConfig(metric="plane", max_iterations=40,
                               matcher="pallas"))
        register(torch, ft, "register_ndt hall-16384 (plane ICP refine)", s,
                 run, 1e-5, "nn_argmin")

    study_out = {}

    def study():  # E2: K1, K2 with the study's index bits, min-only
        from fpcr_tpu_torch.bench import packed_reduction

        study_out.update(packed_reduction.main(16384))

    # (path, run, the kernel it must launch, the kernels it must not)
    packed_not = ("nn_argmin", "morton_nn", "nn_min_only")
    paths = [("point ICP, K1", brute("point", SCENES), "nn_argmin", ()),
             ("point ICP packed6_idx, K2",
              brute("point", PACKED_SCENES, "nn_argmin_packed", **PACKED),
              "nn_argmin_packed", packed_not + ("morton_nn_packed",)),
             ("plane ICP, K1", brute("plane", PLANE_SCENES), "nn_argmin", ()),
             ("morton ICP, K3", morton(), "morton_nn", ()),
             ("morton ICP packed6_idx, K3p",
              morton(PACKED_MORTON_SCENES, "morton_nn_packed", **PACKED),
              "morton_nn_packed", packed_not + ("nn_argmin_packed",)),
             ("coarse-to-fine, K1 + K3", coarse_to_fine, "morton_nn", ()),
             ("NDT run_ndt, K4", ndt_runs, "ndt_fused_moments", ()),
             ("NDT map tracking, K4", map_tracking, "ndt_fused_moments", ()),
             ("register_ndt, gather NDT + K1", register_ndt_hall,
              "nn_argmin", ()),
             ("packed-reduction study, K1 + K2 + min-only", study,
              "nn_min_only", ("morton_nn", "morton_nn_packed"))]
    totals = {k: 0 for k in _wrappers()}
    for path, fn, kernel, absent in paths:
        counts = drive(torch, path, fn)
        if counts[kernel] == 0:
            raise AssertionError(f"path '{path}' never launched {kernel}")
        ran = [k for k in absent if counts[k]]
        if ran:
            raise AssertionError(f"path '{path}' launched {ran}")
        for k, v in counts.items():
            totals[k] += v
    return totals, study_out


def _replay(ft, cfg, s, steps):
    """Brute-force ICP from ``s``, one ``icp_iteration`` at a time, as
    ``run_icp`` runs it: per step the points it starts from, their matched
    target points (``nn_argmin_packed``, what the step matches with) and
    its error, on the host."""
    from fpcr_tpu_torch.models.icp import icp_iteration
    from fpcr_tpu_torch.ops.matching import (gather_correspondences,
                                             nn_argmin_packed)

    pts, out = s.source.contiguous(), []
    for _ in range(steps):
        idx, _ = nn_argmin_packed(pts, s.target)
        new, _, err, _ = icp_iteration(pts, s.target, cfg)
        out.append((pts.cpu(), gather_correspondences(s.target, idx).cpu(),
                    float(err)))
        pts = new
    return out


def _check_packed_gaps(torch, ft, label, cfg, s_gpu, s_cpu, e_g, e_c):
    """Hold the per-iteration errors of a card and a CPU packed brute run
    (K2 and its plain version) to a bound derived step by step.

    The two runs start from the same points, but the card's solve rounds
    differently, so their points drift ~1e-6 apart; a pick whose two
    candidates lie within a bucket (2^(b-23) of the distance) can then
    swap. The error of a step is the RMSE of the Kabsch optimum, which is
    1-Lipschitz in the points and in the matched points under the RMS norm,
    so |E_card - E_cpu| <= RMS(dp) + RMS(dq) + 1e-5, the last the float32
    noise the exact matcher's runs are held to. At the first step whose
    picks differ, every differing row must be a bucket-edge swap: on each
    run's points the two picks' distances d_a, d_b lie within one bucket
    plus the drift, |d_a - d_b| <= (2^(b-23) + 2^-21) max(d) + 2 nu, with
    nu = 2 |dp| sqrt(max(d)) + |dp|^2 (2^-21 covers the rounding of the
    two distances). On the card's points of every step, the plain version
    must pick what K2 picks but for such swaps (nu = 0)."""
    from fpcr_tpu_torch.ops.matching import (gather_correspondences,
                                             nn_argmin_packed,
                                             packed_idx_bits)

    bucket = 2.0 ** (packed_idx_bits(s_cpu.target.shape[0]) - 23)
    steps = len(e_c)
    rows_g = _replay(ft, cfg, s_gpu, steps)
    rows_c = _replay(ft, cfg, s_cpu, steps)
    rms = lambda x: float(x.double().pow(2).sum(1).mean().sqrt())  # noqa

    def check_swap(k, i, side, p, qa, qb, dp):
        d = (p.double() - torch.stack([qa, qb]).double()).pow(2).sum(1)
        dmax = float(d.max())
        nu = 2 * dp * dmax ** 0.5 + dp * dp
        lim = (bucket + 2.0 ** -21) * dmax + 2 * nu
        spread = float((d[0] - d[1]).abs())
        log("reference", f"  row {i}, on the {side}: card's pick at "
                         f"{float(d[0]):.9e}, the other at {float(d[1]):.9e}"
                         f", apart {spread:.3e} <= {lim:.3e} (one bucket "
                         f"{bucket * dmax:.3e} + drift)")
        if spread > lim:
            raise AssertionError(f"{label}: step {k} row {i} is not a "
                                 "bucket-edge swap")

    first, worst, lockstep = None, 0.0, 0
    for k, ((p_g, q_g, r_g), (p_c, q_c, r_c)) in enumerate(zip(rows_g,
                                                                rows_c)):
        for r, e in ((r_g, float(e_g[k])), (r_c, float(e_c[k]))):
            if abs(r - e) > 1e-6 * max(1.0, abs(e)):
                raise AssertionError(f"{label}: the replay of step {k} gave "
                                     f"error {r}, the run {e}")
        gap = abs(r_g - r_c)
        limit = 1e-5 + rms(p_g - p_c) + rms(q_g - q_c)
        worst = max(worst, gap / limit)
        if gap > limit:
            raise AssertionError(f"{label}: step {k} error gap {gap:.3e} > "
                                 f"{limit:.3e}")
        # the plain version on the card's points of this step
        idx_l, _ = nn_argmin_packed(p_g, s_cpu.target)
        q_l = gather_correspondences(s_cpu.target, idx_l)
        for i in (q_l != q_g).any(1).nonzero().flatten().tolist():
            lockstep += 1
            check_swap(k, i, "card run's points, plain version", p_g[i],
                       q_g[i], q_l[i], 0.0)
        moved = (q_g != q_c).any(1).nonzero().flatten()
        if first is not None or moved.numel() == 0:
            continue
        first = k
        apart = float((p_g - p_c).abs().max())
        log("reference", f"{label}: the picks first differ at step {k}, on "
                         f"{moved.numel()} rows, the points {apart:.3e} "
                         f"apart; error gap {gap:.3e} <= {limit:.3e}")
        for i in moved.tolist():
            dp = float((p_g[i] - p_c[i]).double().norm())
            for side, p in (("card run's points", p_g[i]),
                            ("CPU run's points", p_c[i])):
                check_swap(k, i, side, p, q_g[i], q_c[i], dp)
    log("reference", f"{label}: every step's error gap within its bound "
                     f"(largest gap/bound {worst:.3f}); the runs' picks "
                     + ("never differ" if first is None else
                        f"first differ at step {first}, by bucket-edge swaps")
                     + f"; on the card's points of all {steps} steps the "
                     f"plain version differs from K2 on {lockstep} rows")


def _compare_runs(torch, ft, label, cfg, s_gpu, s_cpu):
    r_gpu = ft.run_icp(s_gpu.source, s_gpu.target, cfg)
    r_cpu = ft.run_icp(s_cpu.source, s_cpu.target, cfg)
    it_g, it_c = int(r_gpu.num_iterations), int(r_cpu.num_iterations)
    it = min(it_g, it_c)
    e_g, e_c = r_gpu.errors.cpu()[:it], r_cpu.errors[:it]
    tr = ft.RigidTransform(r_gpu.transform.rotation.cpu(),
                           r_gpu.transform.translation.cpu())
    gap = float(ft.transform_rmse(tr, r_cpu.transform, s_cpu.source))
    err_gap = float((e_g - e_c).abs().max())
    log("reference", f"{label} card vs CPU: iterations {it_g} vs {it_c}, "
                     f"max |error gap| {err_gap:.3e}, transform RMSE gap "
                     f"{gap:.3e}")
    # the stop test may land one iteration apart where |E - E_prev| sits
    # within float32 noise of the tolerance
    if abs(it_g - it_c) > 1 or not gap < 1e-5:
        raise AssertionError(f"{label}: card and CPU runs disagree")
    if cfg.matcher == "pallas" and cfg.pallas_mode == "packed6_idx":
        _check_packed_gaps(torch, ft, label, cfg, s_gpu, s_cpu, e_g, e_c)
    elif not err_gap < 1e-5:
        raise AssertionError(f"{label}: card and CPU errors disagree")


def phase_reference(torch, ft, dev):
    """The card's runs against the port's plain CPU runs on the same small
    scenes: the brute matcher (K1 and K2 against their plain versions) and
    the Morton band matcher with K3's geometry (K3 and K3p against
    theirs)."""
    for label, mode in (("", {}), (" packed6_idx", PACKED)):
        s_cpu = ft.synthetic_scene(width=32, device="cpu")
        s_gpu = ft.RegistrationScene(s_cpu.source.to(dev),
                                     s_cpu.target.to(dev), None)
        _compare_runs(torch, ft, f"synthetic-1024 point{label}",
                      ft.ICPConfig(max_iterations=40, exact_distances=True,
                                   matcher="pallas", **mode), s_gpu, s_cpu)
        src = ft.surface_grid(64, device="cpu")
        _compare_runs(torch, ft,
                      f"synthetic-4096 morton point, 2 shifts{label}",
                      ft.ICPConfig(matcher="morton", morton_impl="pallas",
                                   morton_shifts=2, max_iterations=30,
                                   **BAND, **mode),
                      ft.transformed_scene(src.to(dev), *NEAR_GT),
                      ft.transformed_scene(src, *NEAR_GT))


OUR_KERNELS = ("nn_partial_kernel", "nn_combine_kernel",
               "nn_packed_epilogue_kernel", "nn_min_combine_kernel",
               "morton_band_kernel", "ndt_moments_kernel")


def kernel_ms(fn, repeats=10):
    """Device time per call of the port's own kernels that ``fn`` launches
    (``torch.profiler``'s CUDA kernel events over ``repeats`` calls, the
    wrapper's torch glue left out), in ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and any(k in e.name for k in OUR_KERNELS))
    return us / repeats / 1e3


def phase_times(torch, ft, dev, smi, study):
    from fpcr_tpu_torch.bench.packed_reduction import nn_min_only_plain
    from fpcr_tpu_torch.models.icp import icp_iteration
    from fpcr_tpu_torch.ops.matching import (gather_correspondences,
                                             nn_argmin_packed_plain,
                                             nn_argmin_plain, packed_idx_bits)
    from fpcr_tpu_torch.ops.matching_cuda import (nn_argmin_cuda,
                                                  nn_argmin_packed_cuda,
                                                  nn_min_only_cuda)
    from fpcr_tpu_torch.ops.solve import (cross_covariance, kabsch_transform,
                                          masked_centroid, rotation_from_svd)
    from fpcr_tpu_torch.utils.timing import cuda_time_ms, slope_ms_per_iter

    card = f"[card: {smi}]"
    s = ft.synthetic_scene(width=128, device=dev)
    p, q = s.source, s.target

    def run(k):
        cfg = ft.ICPConfig(max_iterations=k, tolerance=0.0, matcher="pallas")
        return ft.run_icp(p, q, cfg)

    def run_packed(k):
        cfg = ft.ICPConfig(max_iterations=k, tolerance=0.0, matcher="pallas",
                           **PACKED)
        return ft.run_icp(p, q, cfg)

    # K1, K2, K2, K1: the host-bound iteration drifts within a call, and
    # the twins' legs bracket each other
    slopes = {}
    for label, fn in (("point ICP N=16384", run),
                      ("packed point ICP N=16384 (K2)", run_packed),
                      ("packed point ICP N=16384 (K2) again", run_packed),
                      ("point ICP N=16384 again", run)):
        r = slope_ms_per_iter(fn, k_lo=10, k_hi=60, repeats=5)
        log("times", f"{label}: {r['ms_per_iter']:.4f} ms/iter (slope of "
                     f"min-of-5, {r['k_lo']} and {r['k_hi']} iterations: "
                     f"{r['lo_ms']:.3f} / {r['hi_ms']:.3f} ms) {card}")
        slopes[label] = r["ms_per_iter"]
    slope = {"ms_per_iter": slopes["point ICP N=16384"]}

    k1 = cuda_time_ms(lambda: nn_argmin_cuda(p, q), repeats=20, warmup=3)
    plain_exact = cuda_time_ms(lambda: nn_argmin_plain(p, q, exact=True),
                               repeats=10, warmup=2)
    plain_expand = cuda_time_ms(lambda: nn_argmin_plain(p, q, exact=False),
                                repeats=10, warmup=2)
    log("times", f"K1 nn_argmin_cuda N=M=16384: min {k1['min']:.4f} ms, "
                 f"mean {k1['mean']:.4f} ms {card}")
    log("times", f"plain nn_argmin exact=True N=M=16384: min "
                 f"{plain_exact['min']:.4f} ms {card}")
    log("times", f"plain nn_argmin exact=False N=M=16384: min "
                 f"{plain_expand['min']:.4f} ms {card}")
    bits = packed_idx_bits(q.shape[0])
    k2 = cuda_time_ms(lambda: nn_argmin_packed_cuda(p, q, idx_bits=bits),
                      repeats=20, warmup=3)
    k2_plain = cuda_time_ms(lambda: nn_argmin_packed_plain(
        p, q, idx_bits=bits), repeats=10, warmup=2)
    k1_again = cuda_time_ms(lambda: nn_argmin_cuda(p, q), repeats=20,
                            warmup=3)
    mo = cuda_time_ms(lambda: nn_min_only_cuda(p, q), repeats=20, warmup=3)
    mo_plain = cuda_time_ms(lambda: nn_min_only_plain(p, q), repeats=10,
                            warmup=2)
    kern = {"K1": kernel_ms(lambda: nn_argmin_cuda(p, q)),
            "K2": kernel_ms(lambda: nn_argmin_packed_cuda(p, q,
                                                          idx_bits=bits)),
            "min-only": kernel_ms(lambda: nn_min_only_cuda(p, q))}
    log("times", "kernel time per call at N=M=16384 (profiler, the port's "
                 "kernels only): " + ", ".join(f"{k} {v:.4f} ms"
                                               for k, v in kern.items())
        + f" {card}")
    log("times", f"K2 nn_argmin_packed_cuda N=M=16384 ({bits} index bits): "
                 f"min {k2['min']:.4f} ms, mean {k2['mean']:.4f} ms; K1 "
                 f"again min {k1_again['min']:.4f} ms; plain "
                 f"nn_argmin_packed_plain min {k2_plain['min']:.4f} ms "
                 f"{card}")
    log("times", f"min-only nn_min_only_cuda N=M=16384: min "
                 f"{mo['min']:.4f} ms, mean {mo['mean']:.4f} ms; plain "
                 f"nn_min_only_plain min {mo_plain['min']:.4f} ms {card}")
    for name, (ms, agree) in study.items():
        log("times", f"packed-reduction study N=M=16384 {name}: {ms:.4f} "
                     f"ms, idx agreement with K1 {agree:.5f} {card}")

    # one iteration's stages at N=16384, each alone, min of 20
    idx, d = nn_argmin_cuda(p, q)
    qm = gather_correspondences(q, idx)
    p_bar, q_bar = masked_centroid(p), masked_centroid(qm)
    W = cross_covariance(p, qm, p_bar, q_bar)
    inc = kabsch_transform(p, qm)
    stages = {
        "match (K1)": lambda: nn_argmin_cuda(p, q),
        "gather": lambda: gather_correspondences(q, idx),
        "centroids + covariance": lambda: cross_covariance(
            p, qm, masked_centroid(p), masked_centroid(qm)),
        "svd + det fix": lambda: rotation_from_svd(W),
        "torch.linalg.svd alone": lambda: torch.linalg.svd(
            W, full_matrices=False),
        "kabsch_transform": lambda: kabsch_transform(p, qm),
        "apply": lambda: inc.apply(p),
        "icp_iteration": lambda: icp_iteration(
            p, q, ft.ICPConfig(matcher="pallas")),
    }
    stage_ms = {k: cuda_time_ms(f, repeats=20, warmup=3)["min"]
                for k, f in stages.items()}
    per_iter = slope["ms_per_iter"]
    for k, v in stage_ms.items():
        log("times", f"stage {k}: {v:.4f} ms = {100 * v / per_iter:.1f}% "
                     f"of {per_iter:.4f} ms/iter {card}")
    return {"k1_ms": k1["min"], "plain_ms": plain_exact["min"],
            "k2_ms": k2["min"], "k2_plain_ms": k2_plain["min"],
            "min_only_ms": mo["min"], "min_only_plain_ms": mo_plain["min"],
            "n": p.shape[0], "m": q.shape[0],
            "plain_expand_ms": plain_expand["min"], "ms_per_iter": per_iter,
            "svd_ms": stage_ms["svd + det fix"]}


def phase_times_slice2(torch, ft, dev, smi):
    """Times of the plane and large-N paths: plane and Morton ICP ms/iter,
    K3 alone against its plain version, normals and the plane solve."""
    from fpcr_tpu_torch.ops.morton import (build_morton_table,
                                           morton_nn_band_packed_plain,
                                           morton_nn_band_plain,
                                           source_morton_order)
    from fpcr_tpu_torch.ops.morton_cuda import (morton_nn_cuda,
                                                morton_nn_packed_cuda)
    from fpcr_tpu_torch.ops.solve import (plane_normal_equations,
                                          plane_solve_update)
    from fpcr_tpu_torch.utils.timing import cuda_time_ms, slope_ms_per_iter

    card = f"[card: {smi}]"
    out = {}

    def slope(label, scene, k_lo, k_hi, repeats, **cfg):
        def run(k):
            return ft.run_icp(scene.source, scene.target, ft.ICPConfig(
                max_iterations=k, tolerance=0.0, **cfg))

        r = slope_ms_per_iter(run, k_lo=k_lo, k_hi=k_hi, repeats=repeats)
        log("times", f"{label}: {r['ms_per_iter']:.4f} ms/iter (slope of "
                     f"min-of-{repeats}, {k_lo} and {k_hi} iterations: "
                     f"{r['lo_ms']:.3f} / {r['hi_ms']:.3f} ms) {card}")
        out[label] = r["ms_per_iter"]

    s16 = ft.synthetic_scene(width=128, device=dev)
    slope("plane ICP N=16384", s16, 10, 60, 5, metric="plane",
          matcher="pallas")
    for i, w in enumerate(LARGE_WIDTHS):
        s = build_scene(ft, f"grid-{i}", dev)
        # K3, K3p, K3p, K3, as the brute twins
        for again in ("", " again"):
            legs = [(f"morton point ICP N={w * w}{again}", {}),
                    (f"morton packed point ICP N={w * w} (K3p){again}",
                     PACKED)]
            for label, mode in (legs[::-1] if again else legs):
                slope(label, s, 5, 25, 3, matcher="morton", **BAND, **mode)
        if i == 0:
            slope(f"morton plane ICP N={w * w}", s, 5, 25, 3,
                  metric="plane", matcher="morton", **BAND)
        # K3 alone, at the inputs of the first iteration
        table = build_morton_table(s.target)
        ps = s.source[source_morton_order(s.source, table).long()]
        ps = ps.contiguous()
        nrm = ft.estimate_normals(s.target)[table.orig_index.long()]
        nrm = nrm.contiguous()
        for label, extra in (("", None), (" + normals", nrm)):
            k3 = cuda_time_ms(lambda: morton_nn_cuda(ps, table, extra,
                                                     chunk=512, window=64),
                              repeats=20, warmup=3)
            plain = cuda_time_ms(lambda: morton_nn_band_plain(
                ps, table, extra, chunk=512, window=64), repeats=3,
                warmup=1)
            log("times", f"K3 morton_nn_cuda{label} N=M={w * w} c512/w64: "
                         f"min {k3['min']:.4f} ms, mean {k3['mean']:.4f} ms; "
                         f"plain morton_nn_band_plain min "
                         f"{plain['min']:.4f} ms {card}")
            out[f"k3{label} {w * w}"] = (k3["min"], plain["min"])
        k3p = cuda_time_ms(lambda: morton_nn_packed_cuda(
            ps, table, chunk=512, window=64), repeats=20, warmup=3)
        plain = cuda_time_ms(lambda: morton_nn_band_packed_plain(
            ps, table, chunk=512, window=64), repeats=3, warmup=1)
        kern = {"K3": kernel_ms(lambda: morton_nn_cuda(ps, table, chunk=512,
                                                       window=64)),
                "K3p": kernel_ms(lambda: morton_nn_packed_cuda(
                    ps, table, chunk=512, window=64))}
        log("times", f"kernel time per call at N=M={w * w} c512/w64 "
                     "(profiler, the port's kernels only): "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in kern.items())
            + f" {card}")
        log("times", f"K3p morton_nn_packed_cuda N=M={w * w} c512/w64: min "
                     f"{k3p['min']:.4f} ms, mean {k3p['mean']:.4f} ms; plain "
                     f"morton_nn_band_packed_plain min {plain['min']:.4f} ms "
                     f"{card}")
        out[f"k3p {w * w}"] = (k3p["min"], plain["min"])
    for w in (128, LARGE_WIDTHS[-1]):
        cloud = ft.surface_grid(w, device=dev)
        t = cuda_time_ms(lambda: ft.estimate_normals(cloud), repeats=3,
                         warmup=1)
        log("times", f"estimate_normals N={w * w}: min {t['min']:.3f} ms "
                     f"({'streaming' if w * w <= 100_000 else 'Morton'} "
                     f"kNN + eigh3) {card}")
    for w in (128, LARGE_WIDTHS[-1]):
        src = ft.surface_grid(w, device=dev)
        tgt = ft.transformed_scene(src, *NEAR_GT).target
        nrm = ft.estimate_normals(tgt)
        C, b = plane_normal_equations(src, tgt, nrm)
        t_eq = cuda_time_ms(lambda: plane_normal_equations(src, tgt, nrm),
                            repeats=20, warmup=3)
        t_sol = cuda_time_ms(lambda: plane_solve_update(C, b), repeats=20,
                             warmup=3)
        log("times", f"plane solve N={w * w}: normal equations min "
                     f"{t_eq['min']:.4f} ms, 6x6 Cholesky solve + update "
                     f"min {t_sol['min']:.4f} ms {card}")
    return out


def phase_times_ndt(torch, np, ft, dev, smi):
    """NDT ms/iter by the slope method, K4 alone against its plain version,
    and the grid build, at 262,144 and 1,048,576 points."""
    from fpcr_tpu_torch.ops.ndt import (cell_key_order, gauss_d1_d2,
                                        ndt_fused_moments_plain,
                                        prepare_fused_tables)
    from fpcr_tpu_torch.ops.ndt_cuda import ndt_fused_moments_cuda
    from fpcr_tpu_torch.utils.timing import cuda_time_ms, slope_ms_per_iter

    card = f"[card: {smi}]"
    out = {}
    d1, d2 = gauss_d1_d2(0.55, NDT_VOXEL)
    for w in LARGE_WIDTHS:
        n = w * w
        s = ndt_scene(torch, np, ft, w, dev)
        build = cuda_time_ms(lambda: ft.build_ndt_grid(s.target, NDT_VOXEL),
                             repeats=3, warmup=1)
        grid = ft.build_ndt_grid(s.target, NDT_VOXEL)
        again = ft.build_ndt_grid(s.target, NDT_VOXEL)
        same = all(torch.equal(a, b) for a, b in zip(grid, again))
        log("times", f"build_ndt_grid N={n}: min {build['min']:.3f} ms, "
                     f"{int(grid.valid.sum())} valid voxels, two builds "
                     f"bit-equal: {same} {card}")
        if not same:
            raise AssertionError("build_ndt_grid is not deterministic")
        cfg = ft.resolve_ndt_config(ft.NDTConfig(voxel_size=NDT_VOXEL), grid,
                                    s.source)

        def run(k):
            c = dataclasses.replace(cfg, max_iterations=k, tolerance=0.0)
            return ft.run_ndt(s.source, s.target, c, grid=grid)

        r = slope_ms_per_iter(run, k_lo=5, k_hi=25, repeats=3)
        log("times", f"NDT N={n} (K4, window {cfg.lookup_window}): "
                     f"{r['ms_per_iter']:.4f} ms/iter (slope of min-of-3, 5 "
                     f"and 25 iterations: {r['lo_ms']:.3f} / "
                     f"{r['hi_ms']:.3f} ms) {card}")
        src = s.source[cell_key_order(s.source, grid).long()].contiguous()
        tables = prepare_fused_tables(grid)
        kw = dict(voxel_size=NDT_VOXEL, d1=abs(d1), d2=d2, chunk=512,
                  window=cfg.lookup_window)
        k4 = cuda_time_ms(lambda: ndt_fused_moments_cuda(src, grid, tables,
                                                         **kw),
                          repeats=20, warmup=3)
        plain = cuda_time_ms(lambda: ndt_fused_moments_plain(
            src, grid, tables, **kw), repeats=3, warmup=1)
        k4_kernel = kernel_ms(lambda: ndt_fused_moments_cuda(src, grid,
                                                             tables, **kw))
        log("times", f"K4 kernel time per call N={n} (profiler, the port's "
                     f"kernel only): {k4_kernel:.4f} ms {card}")
        log("times", f"K4 ndt_fused_moments_cuda N={n} c512/w"
                     f"{cfg.lookup_window}: min {k4['min']:.4f} ms, mean "
                     f"{k4['mean']:.4f} ms; plain ndt_fused_moments_plain "
                     f"min {plain['min']:.4f} ms {card}")
        rows, _ = ndt_fused_moments_cuda(src, grid, tables, **kw)
        out[n] = {"hits": float(rows[:, 10].sum()),
                  "table_rows": tables.keys.shape[0],
                  "ms_per_iter": r["ms_per_iter"], "k4_ms": k4["min"],
                  "plain_ms": plain["min"], "build_ms": build["min"]}
    return out


def bound(nbytes, flops):
    """``(bound_ms, bound_by)``: the least time the card could take for
    ``nbytes`` of device-memory traffic (each input read once, each output
    written once) and ``flops`` float32 operations at the published
    peaks."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_entry(name, source, replaces, launches, err, ms, plain_ms, nbytes,
                 flops):
    bound_ms, bound_by = bound(nbytes, flops)
    # no single PyTorch call computes an argmin NN, a band NN or K4's
    # moments, so there is no library yardstick
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def kernels_line(launches, errs, times, times2, times3):
    """The ``kernels`` JSON object, the bounds from this run's inputs: the
    brute-force kernels at the synthetic scene's N = M = 16,384, the band
    kernels at 1,048,576 points (chunk 512, window 64, no extra), K4 at
    1,048,576 points with its hit neighbours counted."""
    from fpcr_tpu_torch.ops.morton import band_rows

    n, m = times["n"], times["m"]
    nb = LARGE_WIDTHS[-1] ** 2
    band = band_rows(512, 64)
    band_bytes = 12 * nb + 12 * nb + 4 * -(-nb // 512) + 4 + 20 * nb
    k4 = times3[nb]
    k4_bytes = nb * (12 + 12 + 64 + 12) + k4["table_rows"] * (4 + 64)
    k4_flops = K4_HIT_FLOPS * k4["hits"] + K4_QUERY_FLOPS * nb
    for label, pairs in ((f"brute N=M={n}", n * m),
                         (f"band N={nb} x {band} rows", nb * band)):
        log("bound", f"{label}: {pairs} pairs, float32 bound "
                     f"{ARGMIN_PAIR_FLOPS * pairs / FP32_FLOPS * 1e3:.6f} ms "
                     f"(argmin, min-only) / "
                     f"{PACKED_PAIR_FLOPS * pairs / FP32_FLOPS * 1e3:.6f} ms "
                     f"(packed key); the difference form's "
                     f"{DESIGN_PAIR_FLOPS} flops a pair would take "
                     f"{DESIGN_PAIR_FLOPS * pairs / FP32_FLOPS * 1e3:.6f} ms")
    matching = "fpcr_tpu_torch/csrc/matching.cu"
    morton = "fpcr_tpu_torch/csrc/morton.cu"
    return {"kernels": [
        kernel_entry("nn_argmin", matching,
                     "fpcr_tpu/ops/matching_pallas.py:196",
                     launches["nn_argmin"], errs["nn_argmin"],
                     times["k1_ms"], times["plain_ms"],
                     12 * n + 12 * m + 8 * n, ARGMIN_PAIR_FLOPS * n * m),
        kernel_entry("nn_argmin_packed", matching,
                     "fpcr_tpu/ops/matching_pallas.py:273",
                     launches["nn_argmin_packed"],
                     errs["nn_argmin_packed"], times["k2_ms"],
                     times["k2_plain_ms"], 12 * n + 12 * m + 8 * n,
                     PACKED_PAIR_FLOPS * n * m),
        kernel_entry("nn_min_only", matching,
                     "scripts/exp_packed_reduction.py:113",
                     launches["nn_min_only"], errs["nn_min_only"],
                     times["min_only_ms"], times["min_only_plain_ms"],
                     12 * n + 12 * m + 4 * n, ARGMIN_PAIR_FLOPS * n * m),
        kernel_entry("morton_nn", morton,
                     "fpcr_tpu/ops/morton_pallas.py:328",
                     launches["morton_nn"], errs["morton_nn"],
                     *times2[f"k3 {nb}"], band_bytes,
                     ARGMIN_PAIR_FLOPS * nb * band),
        kernel_entry("morton_nn_packed", morton,
                     "fpcr_tpu/ops/morton_pallas.py:261",
                     launches["morton_nn_packed"], errs["morton_nn_packed"],
                     *times2[f"k3p {nb}"], band_bytes,
                     PACKED_PAIR_FLOPS * nb * band),
        kernel_entry("ndt_fused_moments", "fpcr_tpu_torch/csrc/ndt.cu",
                     "fpcr_tpu/ops/ndt_pallas.py:512",
                     launches["ndt_fused_moments"], errs["ndt_fused_moments"],
                     k4["k4_ms"], k4["plain_ms"], k4_bytes, k4_flops),
    ]}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import fpcr_tpu_torch as ft

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    name, smi = phase_device(torch)
    phase_build()
    errs = phase_kernel_vs_plain(torch, np, ft, dev)
    errs.update(phase_band_vs_plain(torch, np, ft, dev))
    errs["ndt_fused_moments"] = phase_fused_vs_plain(torch, np, ft, dev)
    launches, study = phase_main_path(torch, ft, dev)
    phase_reference(torch, ft, dev)
    times = phase_times(torch, ft, dev, smi, study)
    times2 = phase_times_slice2(torch, ft, dev, smi)
    times3 = phase_times_ndt(torch, np, ft, dev, smi)
    log("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels_line(launches, errs, times, times2, times3)),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
