#!/usr/bin/env python3
"""Drive the PyTorch port (``fpcr_tpu_torch``) on one CUDA card, end to end.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:

1. device — the card's name, ``nvidia-smi``'s name and power limit, the
   torch and CUDA versions, and the float32 precision settings;
2. build — kernels K1 (``fpcr_tpu_torch/csrc/matching.cu``) and K3
   (``csrc/morton.cu``) with one nvcc per source, started together, into
   one library; ptxas' registers and spills of each kernel;
3. kernel vs plain — K1 and K3 against their plain PyTorch versions
   (difference form) on the card, at the test shapes and the main path's
   shapes;
4. main path — each path driven with the launch counters set to 0 just
   before it and read just after, every scene to its ground-truth
   threshold: point-to-point ICP (``matcher='pallas'``, K1) on the
   synthetic scene, Bunny, the full Bunny and the hall scan; point-to-plane
   ICP through K1 on the reference's plane workloads; Morton band ICP
   (``matcher='morton'``, K3, chunk 512, window 64) at 262,144 and
   1,048,576 points and on the hall scan; and the coarse-to-fine pipeline
   on the full Bunny (K1 coarse, K3 fine); then small scenes registered on
   the card and on the CPU must agree, for each matcher;
5. times — ms/iter by the slope method (point and plane ICP at 16,384,
   Morton ICP at 262,144 and 1,048,576), K1 and K3 alone against their
   plain versions, normals, the plane solve and the share of each stage of
   a point iteration, each printed beside the card's name and power limit.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA device the script
exits 1 and prints no result.
"""

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


def _wrappers():
    from fpcr_tpu_torch.ops.matching_cuda import nn_argmin_cuda
    from fpcr_tpu_torch.ops.morton_cuda import morton_nn_cuda

    return {"nn_argmin": nn_argmin_cuda, "morton_nn": morton_nn_cuda}


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

    paths = [("point ICP, K1", brute("point", SCENES), "nn_argmin"),
             ("plane ICP, K1", brute("plane", PLANE_SCENES), "nn_argmin"),
             ("morton ICP, K3", morton, "morton_nn"),
             ("coarse-to-fine, K1 + K3", coarse_to_fine, "morton_nn")]
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
    launches = phase_main_path(torch, ft, dev)
    phase_reference(torch, ft, dev)
    times = phase_times(torch, ft, dev, smi)
    times2 = phase_times_slice2(torch, ft, dev, smi)
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
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
