#!/usr/bin/env python3
"""Drive the PyTorch port (``fpcr_tpu_torch``) on one CUDA card, end to end.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:

1. device — the card's name, ``nvidia-smi``'s name and power limit, the
   torch and CUDA versions, and the float32 precision settings;
2. build — kernel K1 (``fpcr_tpu_torch/csrc/matching.cu``) with nvcc;
3. kernel vs plain — K1 against its plain PyTorch version (difference
   form) on the card, at the test shapes and the main path's shapes;
4. main path — point-to-point ICP (``matcher='pallas'``) on the synthetic
   scene, Bunny, the full Bunny and the Ouster hall scan, each to its
   ground-truth threshold, with K1's launch counter read around the runs;
   then a small scene registered on the card and on the CPU must agree;
5. times — ICP ms/iter by the slope method, K1 alone against the plain
   version, and the share of each stage (the 3x3 SVD among them) in an
   iteration, each printed beside the card's name and power limit.

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


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def build_scene(ft, kind, device):
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
        if any(w in line for w in ("registers", "spill", "Function properties",
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


def phase_main_path(torch, ft, dev):
    from fpcr_tpu_torch.ops.matching_cuda import nn_argmin_cuda

    scenes = [(name, build_scene(ft, kind, dev), iters, thr)
              for name, kind, iters, thr in SCENES]
    torch.cuda.synchronize()
    nn_argmin_cuda.launches = 0
    for name, s, iters, thr in scenes:
        before = nn_argmin_cuda.launches
        t0 = time.perf_counter()
        res = ft.icp_point_to_point(
            s.source, s.target,
            config=ft.ICPConfig(max_iterations=iters, matcher="pallas"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        it = int(res.num_iterations)
        grown = nn_argmin_cuda.launches - before
        gt = float(ft.transform_rmse(res.transform, s.ground_truth,
                                     s.source))
        err = res.errors.cpu()
        ok_shape = (tuple(res.points.shape) == tuple(s.source.shape)
                    and bool(torch.isfinite(res.points).all())
                    and bool(torch.isfinite(err[:it]).all())
                    and bool(torch.isnan(err[it:]).all()))
        log("main", f"{name}: iterations {it}, converged "
                    f"{bool(res.converged)}, final error "
                    f"{float(err[it - 1]):.6e}, GT transform RMSE {gt:.3e} "
                    f"(< {thr:g}), wall {wall:.3f} s, K1 launches +{grown}")
        if not ok_shape:
            raise AssertionError(f"{name}: non-finite or misshapen result")
        if grown < it:
            raise AssertionError(f"{name}: K1 launched {grown} times in "
                                 f"{it} iterations")
        if not gt < thr:
            raise AssertionError(f"{name}: GT transform RMSE {gt} >= {thr}")
    return nn_argmin_cuda.launches


def phase_reference(torch, ft, dev):
    """The card's run against the port's plain CPU run on a small scene."""
    cfg = ft.ICPConfig(max_iterations=40, exact_distances=True)
    s_gpu = ft.synthetic_scene(width=32, device=dev)
    s_cpu = ft.synthetic_scene(width=32)
    r_gpu = ft.run_icp(s_gpu.source, s_gpu.target, cfg)
    r_cpu = ft.run_icp(s_cpu.source, s_cpu.target, cfg)
    it_g, it_c = int(r_gpu.num_iterations), int(r_cpu.num_iterations)
    it = min(it_g, it_c)
    e_g, e_c = r_gpu.errors.cpu()[:it], r_cpu.errors[:it]
    tr = ft.RigidTransform(r_gpu.transform.rotation.cpu(),
                           r_gpu.transform.translation.cpu())
    gap = float(ft.transform_rmse(tr, r_cpu.transform, s_cpu.source))
    err_gap = float((e_g - e_c).abs().max())
    log("reference", f"synthetic-1024 card vs CPU: iterations {it_g} vs "
                     f"{it_c}, max |error gap| {err_gap:.3e}, transform "
                     f"RMSE gap {gap:.3e}")
    # the stop test may land one iteration apart where |E - E_prev| sits
    # within float32 noise of the tolerance
    if abs(it_g - it_c) > 1 or not err_gap < 1e-5 or not gap < 1e-5:
        raise AssertionError("card and CPU runs disagree")


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
    launches = phase_main_path(torch, ft, dev)
    phase_reference(torch, ft, dev)
    times = phase_times(torch, ft, dev, smi)
    log("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "nn_argmin",
        "route": "cuda",
        "source": "fpcr_tpu_torch/csrc/matching.cu",
        "replaces": "fpcr_tpu/ops/matching_pallas.py:196",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": times["k1_ms"],
        "plain_ms": times["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
