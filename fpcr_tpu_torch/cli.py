"""Command-line interface of the PyTorch port: one configurable program in
place of the reference's per-variant executables, with the JAX package's
subcommands and flags (``fpcr_tpu/cli.py``).

Everything runs on the CUDA card unless ``--cpu`` is given, which runs every
call on the CPU instead; without ``--cpu`` and without a card, a command
raises. ``run --distributed`` shards the source over the ranks that
``parallel.multihost.initialize_multihost`` finds (``torchrun`` sets them),
or runs a world of one.

Examples:
    python -m fpcr_tpu_torch run --dataset synthetic --width 128 --metric point
    python -m fpcr_tpu_torch run --dataset bunny --metric plane --profile
    torchrun --nproc-per-node=4 -m fpcr_tpu_torch run --distributed
    python -m fpcr_tpu_torch sweep --metric point --widths 3:128 --csv out.csv
    python -m fpcr_tpu_torch match-bench --n 16384
    python -m fpcr_tpu_torch info
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import replace as dataclasses_replace


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the CUDA card")


def _device(args):
    """``"cpu"`` for ``--cpu``; otherwise the card (raises without one)."""
    import torch

    from .utils.device import resolve_device

    return torch.device(resolve_device(
        "cpu" if getattr(args, "cpu", False) else None))


def _platform(device) -> str:
    return "gpu" if device.type == "cuda" else device.type


def _cmd_run(args) -> int:
    """``run``; with ``--distributed``, inside the process group of the
    launcher's world, which it joins before any tensor is made (NCCL puts
    this process on ``cuda:LOCAL_RANK``) and leaves at the end."""
    import torch.distributed as dist

    from .parallel.multihost import initialize_multihost

    joined = (args.distributed and not dist.is_initialized()
              and initialize_multihost(cpu=args.cpu))
    try:
        return _run(args)
    finally:
        if joined:
            dist.destroy_process_group()


def _run(args) -> int:
    import fpcr_tpu_torch as f

    dev = _device(args)
    if args.dataset == "synthetic":
        scene = f.synthetic_scene(width=args.width, device=dev)
    elif args.dataset == "bunny":
        scene = f.bunny_scene(resampled=True, device=dev)
    elif args.dataset == "bunny-full":
        scene = f.bunny_scene(resampled=False, device=dev)
    elif args.dataset == "hall":
        # strict=True (default) = the reference's op order (GT RyT applied
        # pre-scale); --hall-legacy keeps the harder r1/r2 variant
        scene = f.hall_scene(strict=not args.hall_legacy, device=dev)
    elif args.dataset == "files":
        # user-supplied clouds (PLY / PCD / delimited text); no ground truth
        if not args.source or not args.target:
            print("error: --dataset files needs --source and --target",
                  file=sys.stderr)
            return 2
        from .core.cloud import as_points
        from .data.pointcloud_io import load_points

        scene = f.RegistrationScene(
            source=as_points(load_points(args.source), device=dev),
            target=as_points(load_points(args.target), device=dev),
            ground_truth=None,
        )
    else:  # pragma: no cover
        raise SystemExit(f"unknown dataset {args.dataset}")

    matcher = args.matcher or ("morton" if args.tune_morton else "xla")
    config = f.ICPConfig(
        metric=args.metric,
        max_iterations=args.max_iter,
        tolerance=args.tol,
        k_neighbors=args.k,
        solver=args.solver,
        matcher=matcher,
        strict_reference=args.strict_reference,
        max_correspondence_dist=args.trim_dist,
        robust_loss=args.robust,
        grid_cell_size=args.grid_cell_size,
        grid_cap=args.grid_cap,
        morton_window=args.morton_window,
        morton_impl=args.morton_impl,
        morton_rescue=args.morton_rescue,
    )
    if args.tune_morton:
        # tune_morton's contract is a morton config; refuse the silent
        # override of an explicitly different matcher choice
        if args.matcher not in (None, "morton"):
            print(f"error: --tune-morton tunes the morton matcher and "
                  f"cannot be combined with --matcher {args.matcher}",
                  file=sys.stderr)
            return 2
        config = f.tune_morton(scene.source, scene.target, config)
        print(f"# tune_morton: shifts={config.morton_shifts} "
              f"rescue={config.morton_rescue}", file=sys.stderr)

    if args.profile:
        from .utils.timing import profile_icp

        try:
            timer = profile_icp(scene.source, scene.target, config,
                                iterations=args.profile_iters)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        print(timer.report())
        return 0

    if args.anderson:
        from .models.anderson import run_aa_icp

        t0 = time.perf_counter()
        res = run_aa_icp(scene.source, scene.target, config)
    elif args.sgd:
        from .models.sgd_icp import run_sgd_icp

        t0 = time.perf_counter()
        res = run_sgd_icp(scene.source, scene.target, config,
                          batch_size=args.sgd_batch)
    elif args.coarse_to_fine:
        from .models.pipeline import icp_coarse_to_fine

        fine = dataclasses_replace(config, matcher="morton")
        t0 = time.perf_counter()
        c2f = icp_coarse_to_fine(
            scene.source, scene.target,
            coarse_config=dataclasses_replace(config, matcher="xla"),
            fine_config=fine, coarse_points=args.coarse_points,
        )
        res = c2f.fine._replace(transform=c2f.transform)
    elif args.distributed:
        from .parallel.dist_icp import distributed_icp

        t0 = time.perf_counter()
        res = distributed_icp(scene.source, scene.target, config)
        if _rank() != 0:  # every rank holds the same result; one reports
            return 0
    elif args.global_init:
        from .models.global_reg import register_global

        t0 = time.perf_counter()
        res = register_global(scene.source, scene.target, config)
    elif args.ndt_init:
        from .models.ndt import NDTConfig, register_ndt

        t0 = time.perf_counter()
        res = register_ndt(scene.source, scene.target, config,
                           NDTConfig(voxel_size=args.ndt_voxel))
    else:
        t0 = time.perf_counter()
        res = f.run_icp(scene.source, scene.target, config)
    # reading the count on the host waits for the device, so the wall time
    # includes its work
    ni = int(res.num_iterations)
    wall = time.perf_counter() - t0

    errors = res.errors.cpu().numpy()[:ni]
    rmse_gt = (None if scene.ground_truth is None else
               float(f.transform_rmse(res.transform, scene.ground_truth,
                                      scene.source)))

    pipeline = next((name for name, on in [
        ("anderson", args.anderson), ("sgd", args.sgd),
        ("coarse_to_fine", args.coarse_to_fine),
        ("distributed", args.distributed), ("global_init", args.global_init),
        ("ndt_init", args.ndt_init)] if on), "icp")
    payload = {
        "dataset": args.dataset,
        "metric": args.metric,
        "pipeline": pipeline,
        "n_source": int(scene.source.shape[0]),
        "iterations": ni,
        "converged": bool(res.converged),
        "errors": [float(e) for e in errors],
        "final_error": float(errors[-1]) if ni else None,
        "transform_rmse_vs_gt": rmse_gt,
        "rotation": res.transform.rotation.cpu().numpy().tolist(),
        "translation": res.transform.translation.cpu().numpy().tolist(),
        "wall_seconds": wall,
        "platform": _platform(dev),
    }
    if args.eval_dist is not None:
        ev = f.evaluate_registration(
            scene.source, scene.target, res.transform,
            max_correspondence_dist=args.eval_dist)
        payload["evaluation"] = {
            "max_correspondence_dist": args.eval_dist,
            "fitness": float(ev["fitness"]),
            "inlier_rmse": float(ev["inlier_rmse"]),
            "num_inliers": int(ev["num_inliers"]),
        }
    from .utils.csvout import iteration_metrics

    payload["iteration_metrics"] = iteration_metrics(res)
    if args.json:
        print(json.dumps(payload, indent=2))
    else:
        print(f"dataset={args.dataset} metric={args.metric} "
              f"N={payload['n_source']} platform={payload['platform']}")
        print(f"iterations={ni} converged={payload['converged']} "
              f"wall={wall:.3f}s")
        print("error sequence:")
        for i, e in enumerate(errors):
            print(f"  iter {i:3d}: {e:.6e}")
        if rmse_gt is not None:
            print(f"transform RMSE vs ground truth: {rmse_gt:.3e}")
        if "evaluation" in payload:
            ev = payload["evaluation"]
            print(f"evaluation @ {ev['max_correspondence_dist']}: "
                  f"fitness={ev['fitness']:.4f} "
                  f"inlier_rmse={ev['inlier_rmse']:.3e}")
    if args.output:
        from .utils.csvout import write_json

        write_json(args.output, payload)
    if args.save_aligned:
        from .data.pointcloud_io import write_pcd, write_ply

        if args.save_aligned.lower().endswith(".pcd"):
            write_pcd(args.save_aligned, res.points)
        else:
            write_ply(args.save_aligned, res.points,
                      comment="fpcr_tpu registered source cloud")
        print(f"aligned cloud -> {args.save_aligned}",
              file=sys.stderr)
    return 0


def _rank() -> int:
    from .parallel.multihost import _world

    return _world()[1]


def _cmd_sweep(args) -> int:
    from .bench.sweeps import time_complexity_sweep

    try:
        lo, hi = (int(x) for x in args.widths.split(":"))
        if lo < 2 or hi < lo:
            raise ValueError
    except ValueError:
        print(f"error: --widths wants 'lo:hi' with 2 <= lo <= hi "
              f"(got {args.widths!r})", file=sys.stderr)
        return 2
    rows = time_complexity_sweep(
        metric=args.metric,
        widths=range(lo, hi + 1),
        iterations=args.iters,
        repeats=args.repeats,
        matcher=args.matcher,
        csv_path=args.csv,
        slope=args.slope,
        device=_device(args),
    )
    # same machine-parsable schema as the CSV artifact: n,ms,below_noise_floor
    for n, ms, below_floor in rows:
        print(f"{n},{ms:.6f},{int(below_floor)}")
    return 0


def _cmd_match_bench(args) -> int:
    from .bench.sweeps import matching_benchmark

    results = matching_benchmark(n=args.n, repeats=args.repeats,
                                 csv_path=args.csv, device=_device(args))
    print(json.dumps(results, indent=2))
    return 0


def _cmd_convert(args) -> int:
    """Cloud format conversion: any readable format -> .ply/.pcd/.csv/.xyz
    (host-side IO only, no device)."""
    import numpy as np

    from .data.pointcloud_io import load_points, write_pcd, write_ply

    pts = load_points(args.input)
    out = args.output.lower()
    if out.endswith(".ply"):
        write_ply(args.output, pts, binary=not args.ascii)
    elif out.endswith(".pcd"):
        write_pcd(args.output, pts, binary=not args.ascii)
    elif out.endswith((".csv", ".xyz", ".txt")):
        np.savetxt(args.output, pts,
                   delimiter="," if out.endswith(".csv") else " ",
                   fmt="%.9g")
    else:
        print(f"error: unsupported output format {args.output!r} "
              "(.ply/.pcd/.csv/.xyz/.txt)", file=sys.stderr)
        return 2
    print(f"{pts.shape[0]} points: {args.input} -> {args.output}",
          file=sys.stderr)
    return 0


def _cmd_info(args) -> int:
    import torch

    dev = _device(args)
    print(f"platform: {_platform(dev)}")
    if dev.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(dev)}")
        print(f"device count: {torch.cuda.device_count()}")
    else:
        print("device: cpu")
        print("device count: 1")
    print(f"torch: {torch.__version__}")
    print(f"cuda: {torch.version.cuda}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="fpcr_tpu_torch",
                                     description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="command", required=True)

    run = sub.add_parser(
        "run", help="register a dataset and print the error sequence")
    run.add_argument("--dataset", default="synthetic",
                     choices=["synthetic", "bunny", "bunny-full", "hall",
                              "files"])
    run.add_argument("--width", type=int, default=128,
                     help="synthetic grid width (N=width²)")
    run.add_argument("--source", default=None,
                     help="--dataset files: source cloud path "
                          "(.ply/.pcd/.csv/.xyz)")
    run.add_argument("--target", default=None,
                     help="--dataset files: target cloud path")
    run.add_argument("--save-aligned", default=None, dest="save_aligned",
                     help="write the registered (transformed) source cloud "
                          "to this path (.ply or .pcd)")
    run.add_argument("--eval-dist", type=float, default=None,
                     dest="eval_dist",
                     help="post-hoc evaluation: fitness + inlier RMSE over "
                          "NN matches within this distance (useful with "
                          "--dataset files, where no ground truth exists)")
    run.add_argument("--metric", default="point",
                     choices=["point", "plane", "symmetric", "gicp"])
    run.add_argument("--max-iter", type=int, default=40)
    run.add_argument("--tol", type=float, default=1e-6)
    run.add_argument("--k", type=int, default=4, help="normals kNN size")
    run.add_argument("--solver", default="svd", choices=["svd", "polar"])
    run.add_argument("--matcher", default=None,
                     choices=["xla", "pallas", "grid", "morton"],
                     help="default: xla (morton when --tune-morton)")
    run.add_argument("--strict-reference", action="store_true",
                     help="exact reference math (no det(R) correction)")
    run.add_argument("--trim-dist", type=float, default=None,
                     help="max correspondence distance (robust/trimmed ICP)")
    run.add_argument("--robust", default=None, choices=["huber", "tukey"],
                     help="IRLS robust loss reweighting")
    pipe = run.add_mutually_exclusive_group()
    pipe.add_argument("--sgd", action="store_true",
                      help="SGD-ICP: stochastic mini-batch registration "
                           "(arXiv:1907.09133); see also --sgd-batch")
    run.add_argument("--sgd-batch", type=int, default=1024, dest="sgd_batch")
    pipe.add_argument("--anderson", action="store_true",
                      help="AA-ICP: Anderson-accelerated iteration "
                           "(fewer iterations, safeguarded)")
    pipe.add_argument("--coarse-to-fine", action="store_true",
                      help="coarse brute-force ICP on subsets, then fine "
                           "grid-matched ICP on the full clouds "
                           "(large-N path)")
    run.add_argument("--coarse-points", type=int, default=4096)
    run.add_argument("--grid-cell-size", type=float, default=None)
    run.add_argument("--grid-cap", type=int, default=8)
    run.add_argument("--morton-window", type=int, default=256)
    run.add_argument("--morton-rescue", type=int, default=0,
                     help="exact re-match of the K worst rows/iteration "
                          "(seam-heavy geometry; see tune_morton)")
    run.add_argument("--tune-morton", action="store_true", dest="tune_morton",
                     help="probe-driven Morton quality tuning before the "
                          "run (auto dual-shift + rescue sizing)")
    run.add_argument("--hall-legacy", action="store_true", dest="hall_legacy",
                     help="hall scene with the legacy meters-space GT "
                          "translation (default is strict reference order)")
    run.add_argument("--morton-impl", default="auto",
                     choices=["auto", "xla", "pallas"])
    pipe.add_argument("--distributed", action="store_true",
                      help="shard source points over the ranks of the "
                           "launcher's world (torchrun), or a world of one")
    pipe.add_argument("--global-init", action="store_true", dest="global_init",
                      help="FPFH + RANSAC global registration first, then "
                           "ICP refinement (no initial-pose assumption)")
    pipe.add_argument("--ndt-init", action="store_true", dest="ndt_init",
                      help="NDT (voxel Gaussian field) coarse+fine "
                           "initialization, then ICP refinement — the "
                           "wide-basin pipeline without feature matching")
    run.add_argument("--ndt-voxel", type=float, default=None,
                     help="NDT voxel size (default: auto from target spacing)")
    run.add_argument("--profile", action="store_true",
                     help="per-phase timing breakdown instead of a result")
    run.add_argument("--profile-iters", type=int, default=5)
    run.add_argument("--json", action="store_true")
    run.add_argument("--output", default=None, help="write result JSON here")
    _add_common(run)
    run.set_defaults(fn=_cmd_run)

    sweep = sub.add_parser(
        "sweep", help="time-complexity sweep (the reference's harness)")
    sweep.add_argument("--metric", default="point", choices=["point", "plane"])
    sweep.add_argument("--widths", default="3:128", help="lo:hi grid widths")
    sweep.add_argument("--iters", type=int, default=1)
    sweep.add_argument("--repeats", type=int, default=3)
    sweep.add_argument("--matcher", default="xla", choices=["xla", "pallas"])
    sweep.add_argument("--csv", default=None)
    sweep.add_argument("--slope", action="store_true",
                       help="slope timing (cancels dispatch overhead and "
                            "the plane normals prepass; the committed-"
                            "artifact method)")
    _add_common(sweep)
    sweep.set_defaults(fn=_cmd_sweep)

    mb = sub.add_parser("match-bench", help="matching-kernel microbenchmark")
    mb.add_argument("--n", type=int, default=16384)
    mb.add_argument("--repeats", type=int, default=10)
    mb.add_argument("--csv", default=None)
    _add_common(mb)
    mb.set_defaults(fn=_cmd_match_bench)

    conv = sub.add_parser("convert",
                          help="convert cloud files between formats "
                               "(ply/pcd/csv/xyz)")
    conv.add_argument("--input", required=True)
    conv.add_argument("--output", required=True)
    conv.add_argument("--ascii", action="store_true",
                      help="write ascii instead of binary (ply/pcd)")
    conv.set_defaults(fn=_cmd_convert)

    info = sub.add_parser("info", help="device, torch and CUDA versions")
    _add_common(info)
    info.set_defaults(fn=_cmd_info)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
