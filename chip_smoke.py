#!/usr/bin/env python3
"""Drive the PyTorch port (``fpcr_tpu_torch``) on one CUDA card, end to end.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:

1. device — the card's name, ``nvidia-smi``'s name and power limit, the
   torch and CUDA versions, and the float32 precision settings;
2. build — kernels K1 (``fpcr_tpu_torch/csrc/matching.cu``), K3
   (``csrc/morton.cu``) and K4 (``csrc/ndt.cu``) with one nvcc per source,
   started together, into one library; ptxas' registers and spills of each
   kernel;
3. kernel vs plain — K1, K3 and K4 against their plain PyTorch versions on
   the card, at the test shapes and the main path's shapes, and K4 against
   the 7-offset gather oracle at 262,144 points;
4. main path — each path driven with the launch counters set to 0 just
   before it and read just after, every scene to its ground-truth
   threshold: point-to-point ICP (``matcher='pallas'``, K1) on the
   synthetic scene, Bunny, the full Bunny and the hall scan; point-to-plane
   ICP through K1 on the reference's plane workloads; Morton band ICP
   (``matcher='morton'``, K3, chunk 512, window 64) at 262,144 and
   1,048,576 points and on the hall scan; and the coarse-to-fine pipeline
   on the full Bunny (K1 coarse, K3 fine); NDT through K4 (``run_ndt`` on
   prebuilt grids at 262,144 and 1,048,576 points, and map tracking: three
   scans against one grid and one resolved config) and ``register_ndt`` on
   the hall scan (gather NDT stages, then plane ICP through K1); then small
   scenes registered on the card and on the CPU must agree, for each
   matcher;
5. times — ms/iter by the slope method (point and plane ICP at 16,384,
   Morton ICP and NDT at 262,144 and 1,048,576), K1, K3 and K4 alone
   against their plain versions, normals, the plane solve, the NDT grid
   build and the share of each stage of a point iteration, each printed
   beside the card's name and power limit.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA device the script
exits 1 and prints no result.
"""

import dataclasses
import json
import subprocess
import sys
import time

CASE_TOL = dict(rtol=1e-6, atol=1e-7)  # kernel vs plain sqdist
TIE_REL = 1e-6  # an index may differ only where the two picks tie this close
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


def phase_kernel_vs_plain(torch, np, ft, dev):
    from fpcr_tpu_torch.ops.matching import nn_argmin_plain
    from fpcr_tpu_torch.ops.matching_cuda import nn_argmin_cuda

    worst = 0.0
    for name, p, q, mask in kernel_cases(torch, np, ft, dev):
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
        worst = max(worst, err)
        diff = np.nonzero(ki != oi)[0]
        if diff.size:
            p64 = p.cpu().numpy().astype(np.float64)[diff]
            q64 = q.cpu().numpy().astype(np.float64)
            dk = ((p64 - q64[ki[diff]]) ** 2).sum(1)
            do = ((p64 - q64[oi[diff]]) ** 2).sum(1)
            if (np.abs(dk - do) > TIE_REL * np.maximum(1.0, do)).any():
                raise AssertionError(f"{name}: index differs beyond a tie")
            if mask is not None and not mask.cpu().numpy()[ki[diff]].all():
                raise AssertionError(f"{name}: picked a masked target")
        if name == "tie-1x4" and ki[0] != 1:
            raise AssertionError(f"tie case picked {ki[0]}, expected 1")
        log("kernel", f"{name}: idx equal on {p.shape[0] - diff.size}/"
                      f"{p.shape[0]} rows, near-ties {diff.size}, "
                      f"max |sqdist err| {err:.3e}, no-valid rows "
                      f"{int(none_valid.sum())} -> ok")
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


def phase_band_vs_plain(torch, np, ft, dev):
    """K3 against ``morton_nn_band_plain`` on the same inputs."""
    from fpcr_tpu_torch.ops.morton import morton_nn_band_plain
    from fpcr_tpu_torch.ops.morton_cuda import morton_nn_cuda

    worst = 0.0
    for name, p, table, extra, chunk, window in band_cases(torch, np, ft,
                                                            dev):
        km, kd, ki, ke = morton_nn_cuda(p, table, extra, chunk=chunk,
                                        window=window)
        torch.cuda.synchronize()
        om, od, oi, oe = morton_nn_band_plain(p, table, extra, chunk=chunk,
                                              window=window)
        q = table.points_sorted
        m, vc = q.shape[0], int(table.valid_count)
        kil = ki.long()
        if int(ki.min()) < 0 or int(ki.max()) > m - 1:
            raise AssertionError(f"{name}: index outside [0, {m - 1}]")
        if int(ki.max()) >= vc:
            raise AssertionError(f"{name}: picked a masked row")
        if not torch.equal(km, q[kil]):
            raise AssertionError(f"{name}: matched points differ from the "
                                 "table rows")
        if extra is not None and not torch.equal(ke, extra[kil]):
            raise AssertionError(f"{name}: matched extra differs from the "
                                 "table rows")
        kd, od, ki_np, oi_np = (x.cpu().numpy() for x in (kd, od, ki, oi))
        if not np.isfinite(kd).all() or not np.isfinite(od).all():
            raise AssertionError(f"{name}: a row found no valid target")
        np.testing.assert_allclose(kd, od, **CASE_TOL,
                                   err_msg=f"{name}: sqdist")
        err = float(np.abs(kd - od).max())
        worst = max(worst, err)
        diff = np.nonzero(ki_np != oi_np)[0]
        if diff.size:
            p64 = p.cpu().numpy().astype(np.float64)[diff]
            q64 = q.cpu().numpy().astype(np.float64)
            dk = ((p64 - q64[ki_np[diff]]) ** 2).sum(1)
            do = ((p64 - q64[oi_np[diff]]) ** 2).sum(1)
            if (np.abs(dk - do) > TIE_REL * np.maximum(1.0, do)).any():
                raise AssertionError(f"{name}: index differs beyond a tie")
        log("kernel", f"K3 {name}: idx equal on {p.shape[0] - diff.size}/"
                      f"{p.shape[0]} rows, near-ties {diff.size}, max "
                      f"|sqdist err| {err:.3e}, matched"
                      f"{'' if extra is None else ' and extra'} bit-equal "
                      "to the table rows -> ok")
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
    from fpcr_tpu_torch.ops.matching_cuda import nn_argmin_cuda
    from fpcr_tpu_torch.ops.morton_cuda import morton_nn_cuda
    from fpcr_tpu_torch.ops.ndt_cuda import ndt_fused_moments_cuda

    return {"nn_argmin": nn_argmin_cuda, "morton_nn": morton_nn_cuda,
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
    the launches of each kernel summed over the paths."""
    def brute(metric, scenes):
        def fn():
            for name, kind, iters, thr in scenes:
                s = build_scene(ft, kind, dev)
                cfg = ft.ICPConfig(metric=metric, max_iterations=iters,
                                   matcher="pallas")
                register(torch, ft, name, s,
                         lambda a, b: ft.run_icp(a, b, cfg), thr,
                         "nn_argmin")
        return fn

    def morton():
        for name, kind, metric, iters, thr in MORTON_SCENES:
            s = build_scene(ft, kind, dev)
            cfg = ft.ICPConfig(metric=metric, matcher="morton",
                               max_iterations=iters, **BAND)
            register(torch, ft, name, s, lambda a, b: ft.run_icp(a, b, cfg),
                     thr, "morton_nn", per_iteration=cfg.morton_shifts)

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

    paths = [("point ICP, K1", brute("point", SCENES), "nn_argmin"),
             ("plane ICP, K1", brute("plane", PLANE_SCENES), "nn_argmin"),
             ("morton ICP, K3", morton, "morton_nn"),
             ("coarse-to-fine, K1 + K3", coarse_to_fine, "morton_nn"),
             ("NDT run_ndt, K4", ndt_runs, "ndt_fused_moments"),
             ("NDT map tracking, K4", map_tracking, "ndt_fused_moments"),
             ("register_ndt, gather NDT + K1", register_ndt_hall,
              "nn_argmin")]
    totals = {k: 0 for k in _wrappers()}
    for path, fn, kernel in paths:
        counts = drive(torch, path, fn)
        if counts[kernel] == 0:
            raise AssertionError(f"path '{path}' never launched {kernel}")
        for k, v in counts.items():
            totals[k] += v
    return totals


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
    if abs(it_g - it_c) > 1 or not err_gap < 1e-5 or not gap < 1e-5:
        raise AssertionError(f"{label}: card and CPU runs disagree")


def phase_reference(torch, ft, dev):
    """The card's runs against the port's plain CPU runs on small scenes:
    the brute matcher (K1 against its plain version) and the Morton band
    matcher with K3's geometry (K3 against its plain version)."""
    _compare_runs(torch, ft, "synthetic-1024 point",
                  ft.ICPConfig(max_iterations=40, exact_distances=True),
                  ft.synthetic_scene(width=32, device=dev),
                  ft.synthetic_scene(width=32))
    src = ft.surface_grid(64)
    _compare_runs(torch, ft, "synthetic-4096 morton point, 2 shifts",
                  ft.ICPConfig(matcher="morton", morton_impl="pallas",
                               morton_shifts=2, max_iterations=30, **BAND),
                  ft.transformed_scene(src.to(dev), *NEAR_GT),
                  ft.transformed_scene(src, *NEAR_GT))


def phase_times(torch, ft, dev, smi):
    from fpcr_tpu_torch.models.icp import icp_iteration
    from fpcr_tpu_torch.ops.matching import (gather_correspondences,
                                             nn_argmin_plain)
    from fpcr_tpu_torch.ops.matching_cuda import nn_argmin_cuda
    from fpcr_tpu_torch.ops.solve import (cross_covariance, kabsch_transform,
                                          masked_centroid, rotation_from_svd)
    from fpcr_tpu_torch.utils.timing import cuda_time_ms, slope_ms_per_iter

    card = f"[card: {smi}]"
    s = ft.synthetic_scene(width=128, device=dev)
    p, q = s.source, s.target

    def run(k):
        cfg = ft.ICPConfig(max_iterations=k, tolerance=0.0, matcher="pallas")
        return ft.run_icp(p, q, cfg)

    slope = slope_ms_per_iter(run, k_lo=10, k_hi=60, repeats=5)
    log("times", f"point ICP N=16384: {slope['ms_per_iter']:.4f} ms/iter "
                 f"(slope of min-of-5, {slope['k_lo']} and {slope['k_hi']} "
                 f"iterations: {slope['lo_ms']:.3f} / {slope['hi_ms']:.3f} "
                 f"ms) {card}")

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
            "plain_expand_ms": plain_expand["min"], "ms_per_iter": per_iter,
            "svd_ms": stage_ms["svd + det fix"]}


def phase_times_slice2(torch, ft, dev, smi):
    """Times of the plane and large-N paths: plane and Morton ICP ms/iter,
    K3 alone against its plain version, normals and the plane solve."""
    from fpcr_tpu_torch.ops.morton import (build_morton_table,
                                           morton_nn_band_plain,
                                           source_morton_order)
    from fpcr_tpu_torch.ops.morton_cuda import morton_nn_cuda
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
        slope(f"morton point ICP N={w * w}", s, 5, 25, 3, matcher="morton",
              **BAND)
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
        log("times", f"K4 ndt_fused_moments_cuda N={n} c512/w"
                     f"{cfg.lookup_window}: min {k4['min']:.4f} ms, mean "
                     f"{k4['mean']:.4f} ms; plain ndt_fused_moments_plain "
                     f"min {plain['min']:.4f} ms {card}")
        out[n] = {"ms_per_iter": r["ms_per_iter"], "k4_ms": k4["min"],
                  "plain_ms": plain["min"], "build_ms": build["min"]}
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import numpy as np

    import fpcr_tpu_torch as ft

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    name, smi = phase_device(torch)
    phase_build()
    max_err = phase_kernel_vs_plain(torch, np, ft, dev)
    max_err_k3 = phase_band_vs_plain(torch, np, ft, dev)
    max_err_k4 = phase_fused_vs_plain(torch, np, ft, dev)
    launches = phase_main_path(torch, ft, dev)
    phase_reference(torch, ft, dev)
    times = phase_times(torch, ft, dev, smi)
    times2 = phase_times_slice2(torch, ft, dev, smi)
    times3 = phase_times_ndt(torch, np, ft, dev, smi)
    log("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    k3_ms, k3_plain_ms = times2[f"k3 {LARGE_WIDTHS[-1] ** 2}"]
    print(json.dumps({"kernels": [{
        "name": "nn_argmin",
        "route": "cuda",
        "source": "fpcr_tpu_torch/csrc/matching.cu",
        "replaces": "fpcr_tpu/ops/matching_pallas.py:196",
        "launches": launches["nn_argmin"],
        "max_abs_err": max_err,
        "ms": times["k1_ms"],
        "plain_ms": times["plain_ms"],
    }, {
        "name": "morton_nn",
        "route": "cuda",
        "source": "fpcr_tpu_torch/csrc/morton.cu",
        "replaces": "fpcr_tpu/ops/morton_pallas.py:328",
        "launches": launches["morton_nn"],
        "max_abs_err": max_err_k3,
        "ms": k3_ms,
        "plain_ms": k3_plain_ms,
    }, {
        "name": "ndt_fused_moments",
        "route": "cuda",
        "source": "fpcr_tpu_torch/csrc/ndt.cu",
        "replaces": "fpcr_tpu/ops/ndt_pallas.py:512",
        "launches": launches["ndt_fused_moments"],
        "max_abs_err": max_err_k4,
        "ms": times3[LARGE_WIDTHS[-1] ** 2]["k4_ms"],
        "plain_ms": times3[LARGE_WIDTHS[-1] ** 2]["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
