#!/usr/bin/env python3
"""Drive the PyTorch port (``fpcr_tpu_torch``) on one CUDA card, end to end.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:

1. device — the card's name, ``nvidia-smi``'s name and power limit, the
   torch and CUDA versions, and the float32 precision settings;
2. build — kernels K1 and K2 (the tensor-core sweep and the certified
   finish, ``fpcr_tpu_torch/csrc/nn_tc.cu``), the min-only sweep and the
   E1 forms (the register-tiled sweep ``csrc/nn_forms.cu``, 18 instances:
   SASS opcode counts of each, FFMA, FADD, FMNMX, LOP3, IMNMX, VIMNMX3,
   ..., and ptxas' spills, logged), their first design and K1/K2's
   CUDA-core sweep (``csrc/matching.cu``, the yardsticks), K3 and K3p
   (``csrc/morton.cu``), K4 (``csrc/ndt.cu``) and Kernel S (the wgmma
   sweep ``csrc/split_wgmma.cu``, and its first design, the mma.sync
   yardstick ``csrc/split_mma.cu``) with one nvcc per source, started
   together, into one library; ptxas' registers and spills of each kernel,
   the HGMMA (wgmma) of each instance of the K1/K2 sweep and of the Kernel
   S sweep (none may also issue HMMA) and the bf16 HMMA of each yardstick
   instance in the library's SASS (``cuobjdump``; none fails), no spill in
   the K1/K2 kernels or the Kernel S sweep, and no C7514 or C7512 (wgmma
   serialised) in ptxas' log of ``split_wgmma.cu``;
3. kernel vs plain — the tensor-core K1 and K2 against their CUDA-core
   sweep bit for bit (index and distance bits) on the kernel cases, the
   hall scan, E1's ±300 cloud, duplicates and 200 x 1,048,576, each call
   two launches and no host synchronisation, with the rescued share of
   each input, and the guard: one tile of the sweep's values within a
   quarter of each pair's G of the float64 distance; K1, K2, the min-only
   sweep, K3, K3p and K4 against
   their plain PyTorch versions on the card, at the test shapes and the
   main path's shapes (K1 also at those of the GICP, loop-variant and grid
   paths: 262,144², a 1,024-row SGD batch against Bunny, the 1M scene's
   voxel centroids), K2's 2^16 gate, and K4 against the 7-offset gather
   oracle at 262,144 points; K3's and K3p's band bases, computed in the
   kernel, equal to ``band_bases``, their culled and unculled instances
   bit-equal in all four outputs, and the share of band sub-tiles culled,
   on every band case (tail chunk, m < band, masked and shifted tables, a
   far pose, duplicates across the seed sub-tile, probes outside the
   table's box, two staged tiles, the main path's grids), and one CUDA
   kernel per call; Kernel S (terms 6 and 3, every epilogue) and
   the five E1 launches against theirs at 16,384² and ragged shapes (m = 1,
   m = 2^14 for the packed14 key, a cloud of duplicates), with the share of
   Kernel S's picks equal to the mma.sync yardstick's; the E1 launches and
   the min-only sweep also bit for bit their ``matching.cu`` yardstick (NaN
   rows as integer views) on every case, a NaN target, a NaN source row,
   both, masked NaN targets (min-only) and values of exactly -0.0 (lanes
   given), NaN and inf in the same rows as the plain version; batched K1 and K2
   (the element on ``blockIdx.z``) at the serving batch (32 x 4,096²), the
   odometry pairs (11 x 4,096²), the closure batch with ragged masks (16 x
   4,096²) and B = 1: two launches a batched call, no host sync, every
   element bit for bit its own unbatched call and held against the plain
   version, and a raise without a launch past gridDim.z;
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
   differ must be swaps at a bucket's edge; the studies E4, E3 (its gates)
   and E1 (``fpcr_tpu_torch.bench.split_matmul``, ``reduction2``,
   ``match_kernels``), each of which must launch its own kernels; GICP
   through K1 on the synthetic scene, Bunny and the hall scan and through
   K3 at 1,048,576 points, AA-ICP (point and plane, three K1 calls a loop
   pass, fewer iterations than ``run_icp``, the accepted share), scaled
   ICP on a U(±2) volume (the scale to 1e-3), SGD-ICP on Bunny then a
   ``run_icp`` polish, grid ICP at 262,144 and 1,048,576 points (no kernel:
   neither K1 nor K3 may launch), ``voxel_downsample`` of the 1M scene then
   ``run_icp`` through K1, ``evaluate_registration`` on the GICP and grid
   results (fitness, and its values equal to the same call on the plain
   route) and ``profile_icp``'s phase table, each to the JAX package's CPU
   iteration counts within 1 (SGD's draws are not JAX's: its polish must
   converge) and 10x its GT error; then serving,
   ``register_batch`` of 32 synthetic 4,096-point scenes under their own
   poses through batched K1 and, with ``packed6_idx``, batched K2 (one
   batched call a loop pass, each element within 1 iteration of JAX's and of
   its own ``run_icp`` on the card, or later only where it had converged by
   then), the SLAM example's pipeline at T = 12 x 4,096 (each pair within 1
   iteration of JAX's or within 5% of JAX's final error, where the stop
   test fires at random on a noise plateau; ``register_sequence``,
   ``detect_loop_closures``'s 16-pair batch,
   the covariance and information of each closure, ``close_loops``, which
   must lower the open loop's end-pose error, ``build_map``), ICP history
   on the synthetic scene (``run_icp``'s transform and iterations, then a
   checkpoint saved, loaded and resumed), global registration (Bunny under
   a 1.2-rad pose to 1e-6 where plain ICP stays above 1e-4; the synthetic
   scene under a large pose by chamfer) and ``register()``'s nine methods;
   then every ICP path
   through K1 or K2 again on the CUDA-core sweep, to the same iterations,
   final error and GT error;
5. graphs — the loops as captured CUDA graphs (``utils/graphs.py``) and
   kernel svd3 (``csrc/svd3.cu``): svd3 against its plain version
   (``torch.linalg.svd``) in float64 and float32 at the main path's
   batches (1, 32, 1,024) and on W = 0, a line, a plane, a reflection, NaN
   and inf, against its yardstick (the first design, 8 float64 sweeps) and
   its CPU mirror (``ops/svd3_mirror.py``, within one float32 ulp), with
   its kernel and call times in legs against the yardstick's (yardstick,
   new, new, yardstick, yardstick, new), the parts of its design alone,
   the plain version's and ``torch.linalg.svd``'s times, and captured
   point ICP through K1 at 16,384 by the slope with either svd3 in legs;
   every captured path (point ICP through K1 and K2 on the four scenes,
   plane through K1, Morton through K3 and K3p at 262,144 and 1,048,576,
   NDT through K4 at both sizes, ``register_batch`` of 32 x 4,096 through
   K1 and K2) bit for bit its eager run (``graphs.eager()``) on the key's
   first call (eager), the call that captures and the one that replays,
   with the eager run's launches and to its ground truth, with each call's
   wall time and each capture's seconds and pool; the host's syncs in 24
   iterations of each path, captured and eager
   (``torch.cuda.set_sync_debug_mode('warn')``: only the done reads at 8
   and 16, and ``run_ndt``'s read of the grid's voxel size); captured
   against eager ms/iter (``register_batch`` ms a batch) six times each in
   turns; one traced run of point and plane ICP through K1 each way, and
   one more that finds the port's kernels in the trace, in the counted
   numbers, under ``cudaGraphLaunch`` when captured. The loop variants
   likewise: svd3's Umeyama form against its plain version and its
   yardstick on the same batches and edge cases, with its times in legs;
   kernel eig3 on the hall scan's 16,384 normals covariances against
   float64 ``eigh`` and its plain version under eig3's bounds (the
   isotropic rows on the fixed frame), one launch a call and no host read,
   with its kernel, call, plain and closed-form times and its bound; AA-ICP point and plane,
   scaled ICP through K1 and K2, SGD-ICP on Bunny (B = 1,024, 200 steps),
   history through K1 and K2 on the four scenes and K3 at 1,048,576, the
   SLAM example's pose graph (unit weights and the closures'
   informations) and ``global_registration`` on Bunny, each bit for bit
   its eager run on the three calls, with its launches and to its ground
   truth; their syncs in 24 iterations (the pose graph and RANSAC: none
   in the loop); captured against eager six times in turns; then
   ``register_batch`` for every config the JAX package ``vmap``s:
   batched K3 and K3p at 16 x 65,536 points (chunk 512, window 64, with
   and without an extra): one launch a call, culled equal to unculled,
   the bases equal to ``band_bases``, each element's outputs, bases and
   visits bit for bit its unbatched launch's and held against the batched
   plain version, timed in legs against 16 unbatched launches (16,
   batched, batched, 16, 16, batched); each config driven between counter
   reads, the morton batch through K3 and K3p at 16 x 65,536 (one launch
   a shift a pass), symmetric, GICP, grid and plane with its normals
   estimated at 32 x 4,096, every element to its threshold and within 1
   iteration of its own ``run_icp`` (``STOP_NOISE``), and
   ``register_sequence`` through K3 on 17 frames of 65,536 points to its
   drift bound; each path captured bit for bit its eager run with equal
   launches; the host's syncs in 24 iterations (the done reads only); ms
   a batch in legs against the parent's element-by-element route
   (``parent_register_batch``);
6. times — ms/iter by the slope method (point ICP at 16,384 through K1 and
   K2, plane ICP at 16,384, Morton ICP through K3 and K3p and NDT at
   262,144 and 1,048,576), K1 and K2 against their CUDA-core sweep in legs
   (call and kernel time) with the sweep's ablations, K1, K2, the min-only
   sweep, K3, K3p and K4 alone against their plain versions (K3 and K3p
   with and without an extra, and
   their unculled instances' kernel times), the kernels, device busy time
   and idle share of a Morton point iteration at 1,048,576 (traced), the
   packed-reduction study
   (``fpcr_tpu_torch.bench.packed_reduction.main``), normals, the plane
   solve, the NDT grid build and the share of each stage of a point
   iteration, Kernel S's five launch types (in legs against the mma.sync
   yardstick: yardstick, wgmma, wgmma, yardstick, yardstick, wgmma, the
   least call and the median profiler kernel time a side; with the
   sweep's ablations and slice plans), the E1 forms and the min-only sweep
   in the same legs against their ``matching.cu`` yardstick and alone
   against their plain versions, with the new sweep's ablations (the sums
   alone, + the staging, + the reduction, + the finish), GICP (16,384
   through K1, 1M through K3), AA-ICP, grid ICP (262k, 1M) and an SGD step
   by the slope method, and ``build_voxel_table``, ``grid_nn``,
   ``voxel_downsample`` and ``evaluate_registration`` by events;
   ``register_batch``'s wall time a batch and registrations/s against 32
   sequential ``run_icp`` calls (K1, K2, K2, K1), batched K1 and K2 alone
   against 32 unbatched calls and the plain version, the SLAM pipeline's
   stages and ``global_registration``'s (normals + FPFH, feature search,
   RANSAC), each printed beside the card's name and power limit;
7. parallel — the sharded paths (``fpcr_tpu_torch/parallel/dist_icp.py``)
   on a one-rank NCCL group in this process: ``distributed_icp`` point
   through K1 and K2 on the synthetic scene and the hall scan, plane
   through K1, Morton through K3 at 1,048,576 points and
   ``distributed_ndt`` banded through K4 at 1,048,576, each driven between
   counter reads and bit for bit its unsharded run with the same launches,
   with the all-reduces an iteration and ms/iter against ``run_icp`` by the
   slope; NCCL's answer to two ranks on one card (logged); the same paths
   on two ranks sharing this card over gloo (spawned processes), each
   within 1e-5 of the single card, its iterations within 1, to its GT
   threshold, every rank's transform bit-equal and each rank's kernels
   launched on its half of the rows; and the CLI as a user starts it, as
   subprocesses: ``python -m fpcr_tpu_torch info``, ``run --dataset
   bunny`` to 1e-5 and ``match-bench`` at 16,384; and the world-1 NCCL
   loops captured with their all-reduces (``distributed_icp`` point at
   16,384 and Morton at 1,048,576, ``distributed_ndt`` at 1,048,576), bit
   for bit their eager runs, syncs and slopes as in phase 5;
8. examples, guards, fuzz and scripts — the six examples
   (``fpcr_tpu_torch/examples/``) as processes of their own on the card at
   their full sizes, the pipeline at 1,048,576 points (K1 coarse, K3
   fine), each to exit 0, its JAX example's success line, its GT
   threshold, the JAX package's CPU iterations within 1 (SLAM's pairs by
   the noise-plateau rule) and its kernels' launches; beside them, checks
   7, 9 and 10 of ``scripts/tpu_smoke.py`` (``bench/guards.py``: the
   far-cloud ``tune_morton``, eigh3 on λI and NDT over duplicate clusters,
   the 259,200-point wide-plane cloud through K4 at its escalated window
   with K4's counts equal to the gather oracle's) and the fuzz
   (``bench/fuzz_configs.py``) at seeds 0–3, 0 failures; then the scripts:
   the headline (``bench/headline.py``, point ICP at 16,384 through K1,
   with K2 and plane in its details), ``bench_large``'s Morton rows at
   262,144 and 1,048,576 (c512/w64) and its grid row at 262,144,
   ``bench_ndt`` at 262,144 (gather, the plain band, K4) and
   ``sharded_large`` at 1,048,576 on one NCCL rank, each record beside the
   card's name and power limit, and each phase's seconds.

The line before the last is a JSON object describing each kernel: its
launches on the main path (the world-1 sharded paths and phase 8's runs
included, the examples' counted in their own processes), its largest
difference from its plain version, its time and its plain version's (K1's
and K2's entries also hold their batched call at 32 x 4,096², ``batched``),
and its bound, the least time the card could take for the same work (the
larger of its bytes over the HBM rate and its float32 operations over the
float32 peak, from this run's inputs: the band kernels' over the pairs they
evaluated after culling; Kernel S's the largest of its bytes, its bf16
tensor-core products over the bf16 peak and its reduction's CUDA-core
instructions over their rate; the E1 forms' and the min-only sweep's their
form's FP32 instructions and the comparison a pair needs (one float min,
or half a three-input integer min for a packed key) over the CUDA cores'
rate, FORM_PAIR_INSTR; svd3's its 72 bytes a matrix and the float32
operations a 3x3 Kabsch rotation needs over the float32 peak, at run_icp's
batch of one, the other batches under ``batches``, with
``torch.linalg.svd`` as its library call and, in ``latency_ms``, the
device time of an empty kernel, which bounds it in practice; svd3's
Umeyama form's its 76 bytes a matrix and the operations of Umeyama's
rotation and trace, at scaled ICP's batch of one, its ``max_abs_err`` R's
and ``trace_rel_err`` the trace's over σ1;
K3's and K3p's batch axis as entries of their own,
``morton_nn batched`` and ``morton_nn_packed batched``: their launches on
the batched paths, the batched call at 16 x 65,536 against the batched
plain version, the bound over the pairs the culled batch evaluated, and
the 16 unbatched launches' call and kernel times beside them;
the entries of Kernel S, the E1 forms, the min-only sweep and svd3's two
forms also carry the legs' call and kernel times of both sides, svd3's
rotation form also its design's parts alone, ``ablation``, and the
captured point ICP slopes with either svd3, ``point_k1_ms_per_iter``). The last line is ``{"ok": true, "device":
{...}}``. Without a CUDA device the script exits 1 and prints no result.
"""

import contextlib
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

CASE_TOL = dict(rtol=1e-6, atol=1e-7)  # kernel vs plain sqdist
TIE_REL = 1e-6  # an index may differ only where the two picks tie this close
# the plain version's source chunk and target tile at the main path's large
# K1 shapes (262,144^2): 8192 x 8192 difference rows are 0.8 GB a step
PLAIN_CHUNK = 8192
# evaluate_registration's inlier RMSE against the plain route's: a sum of
# distances each within CASE_TOL of the plain version's
EVAL_RTOL = 1e-5
# the H100 SXM's published peaks (NVIDIA's data sheet, at 700 W): HBM bytes
# per second and float32 operations per second outside the tensor cores
HBM_BPS, FP32_FLOPS = 3.35e12, 67e12
# and bf16 tensor-core operations per second (dense), and CUDA-core
# instructions per second (132 SMs x 128 lanes at the FP32 peak's clock)
BF16_FLOPS, CORE_IPS = 989e12, 33.5e12
# Kernel S's reduction: CUDA-core instructions a pair that its functions
# need at most, one comparison (an argmin, a least key or a least value;
# the keep column needs one select a row), whatever a design executes
SPLIT_REDUCE_INSTR = 1
# float32 operations a (source, target) pair needs, counted in the norm
# form d = |p|^2 - 2 p.q + |q|^2 that the TPU kernels use, with |q|^2
# precomputed: an argmin or a min over targets needs |q|^2 - 2 p.q alone,
# 3 FMAs (|p|^2 is one add a row), while a packed key buckets the full
# distance, one add more. The port's kernels compute the difference form
# (3 sub, 3 FMA) for accuracy; DESIGN_PAIR_FLOPS is that design's cost,
# logged beside the bound but not the bound
ARGMIN_PAIR_FLOPS, PACKED_PAIR_FLOPS, DESIGN_PAIR_FLOPS = 6, 7, 9
# The E1 forms and the min-only sweep on the CUDA cores, where the form's
# arithmetic and the reduction issue on the same lanes: the form's own FP32
# instructions a pair (3 FMA, plus v4's, v5's and v6's add; the difference
# form's 3 subtractions and 3 FMA) and the comparison the function needs,
# over CORE_IPS (as SPLIT_REDUCE_INSTR counts Kernel S's reduction): one
# float min a pair for an argmin or a least value (the card has no
# three-input float min), half a three-input integer min (VIMNMX3) for a
# packed key, whose bits order as int32
FORM_PAIR_INSTR = {"e1 v1": 4, "e1 v2": 3.5, "e1 v4": 4.5, "e1 v5": 4.5,
                   "e1 v6": 5, "nn_min_only": 7}
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

# GICP, the loop variants and the voxel grid: each threshold is 10x what
# the JAX package reaches on the CPU for the same run (its 'xla' matcher),
# rounded up to a decade, and JAX's iteration counts, which the card's must
# match within 1 (PERF.md §2 gives the runs)
GICP_SCENES = [  # (name, scene kind, max_iterations, threshold, JAX iters)
    ("gicp synthetic-16384", "synthetic", 40, 1e-5, 5),  # JAX: 1.964e-7
    ("gicp bunny-8171", "bunny", 40, 1e-5, 5),  # JAX: 1.127e-8
    ("gicp hall-16384", "hall", 40, 1e-5, 3),  # JAX: 6.076e-7
    ("gicp morton synthetic-1048576", "grid-1", 25, 1e-5, 3),  # 1.962e-7
]
# AA-ICP on the synthetic scene: (metric, threshold, JAX iterations, JAX's
# plain run_icp iterations); JAX: 4.237e-7 and 2.079e-7
AA_RUNS = [("point", 1e-5, 10, 28), ("plane", 1e-5, 4, 5)]
# scaled ICP on a U(±2) cloud of 16,384 points (seed 11), s = 1.04 and the
# pose of tests/test_scaled_icp.py:65: JAX reaches |Δs| 1.750e-6 and a
# similarity RMSE of 3.158e-6 in 5 iterations
SCALED = dict(scale=1.04, scale_tol=1e-3, rmse=1e-4, jax_iterations=5)
# SGD-ICP on Bunny, B = 1024, 200 steps, then run_icp: JAX's coarse GT
# error 2.284e-3, 5.940e-8 after the polish; its draws are not torch's, so
# no step count is compared
SGD = dict(steps=200, batch=1024, coarse=1e-1, polished=1e-5)
# grid ICP on the near-GT grids (JAX's 1M run with its TPU limit lifted):
# (name, scene kind, max_iterations, threshold, JAX iterations); JAX:
# 2.679e-5 and 4.325e-5
GRID_SCENES = [("grid synthetic-262144", "grid-0", 30, 1e-3, 5),
               ("grid synthetic-1048576", "grid-1", 30, 1e-3, 12)]
# voxel_downsample of the 1M synthetic scene at 0.05, then run_icp through
# K1 on the 30,066 / 30,326 centroids: JAX reaches 1.781e-3 in 43
# iterations. The scene has the reference's displacement: near GT, the
# centroids' own offset between the two clouds, up to a voxel, is as large
# as the displacement
VOXEL = dict(size=0.05, iterations=60, threshold=1e-1, jax_iterations=43,
             centroids=(30066, 30326))


# The batch paths: batch serving, odometry and the pose graph, ICP history,
# global registration and register(). Each threshold is 10x what the JAX
# package reaches on the CPU for the same run, rounded up to a decade, and
# the card's iterations must be within 1 of JAX's (PERF.md §2; the test
# files tests/test_torch_{batch,odometry_pose_graph,global_reg,registry}.py
# run as scripts print those runs)
# serving: JAX's largest GT error over the 32 elements 3.164e-6 (exact
# matcher) and 2.614e-6 (packed6_idx, its TPU kernel in interpret mode)
SERVING = dict(batch=32, width=64, iterations=20, seed=0, threshold=1e-4,
               jax_iterations=(11, 5, 4, 12, 14, 10, 12, 10, 13, 8, 10, 13,
                               7, 8, 5, 11, 7, 10, 13, 13, 11, 10, 4, 4, 11,
                               11, 10, 11, 12, 6, 10, 6),
               jax_packed_iterations=(11, 5, 4, 12, 14, 9, 13, 10, 13, 9,
                                      10, 13, 6, 8, 5, 11, 7, 9, 13, 13, 11,
                                      11, 5, 4, 11, 11, 10, 10, 12, 6, 10,
                                      6))
# Iteration counts may land further apart than 1 only where the run had
# converged by the earlier stop: its error there below this, 10x the
# tolerance. The converged error of the serving scenes, ~0.5-1.5e-6,
# straddles the 1e-6 tolerance, so E < tol or |E - E_prev| < tol holds at
# one iteration or the next by rounding (the batch's sums and a single
# run's differ in their last bits; their SVDs are bit-equal)
STOP_NOISE = 1e-5
# SLAM, JAX: the pairs' iterations (25 is the cap) and final errors, the
# closures (0, 11) (1, 10) (2, 9) (3, 8) of the 16-pair batch, end-pose
# error 6.194e-3 open-loop and 6.844e-4 closed. The pairs that stop before
# the cap stop on |E - E_prev| < 1e-6 while their trimmed error, ~1e-2,
# moves by up to ~5e-6 an iteration: the stop falls at random on that
# plateau. The port's CPU run of the same pairs (plain matcher, JAX's float
# form) stops 4 iterations from JAX's on two pairs and 3 on a third, its
# final errors within 2.1% of JAX's, its open-loop error 1.076e-2. So a
# pair more than one iteration from JAX's must end within SLAM_FINAL_RTOL of
# JAX's final error
SLAM_FINAL_RTOL = 0.05
SLAM = dict(frames=12, points=4096, iterations=25, voxel=0.02, gn=6,
            detect=dict(radius=0.3, min_separation=4, max_error=1e-2,
                        max_pairs=16),
            jax_iterations=(25, 22, 25, 25, 18, 14, 20, 25, 25, 25, 25),
            jax_final=(2.095512e-2, 2.839386e-2, 2.672613e-2, 2.495243e-2,
                       1.689006e-2, 7.731006e-3, 1.614800e-2, 2.463255e-2,
                       2.490392e-2, 2.666826e-2, 2.293426e-2),
            closures=((0, 11), (1, 10), (2, 9), (3, 8)), open=1e-1,
            closed=1e-2)
HISTORY = dict(iterations=40, threshold=1e-5)
# global registration: JAX's Bunny run 4.375e-8 in 2 ICP iterations (plain
# run_icp 2.784e-3); under the large pose the synthetic scene at width 32
# (1,024 points, tests/test_global_reg.py:70-79) reaches a chamfer RMSE of
# 9.522e-7, but at width 128 JAX's own pipeline fails (0.7299: the clouds
# are strided 4 and 2 along the grid's rows, so their FPFH differ), so that
# run's bound, 10x JAX's, only says the card's run completes
GLOBAL = dict(bunny_pose=((0.1, -0.05, 0.08), (0.4, 1.2, -0.8)),
              bunny=1e-6, plain=1e-4,
              synthetic_pose=((2.0, 1.0, 0.5), (0.2, -0.3, 0.8)),
              chamfer={32: 1e-5, 128: 10.0})
# register() on synthetic_scene(width=32) under tests/test_registry.py's
# pose, 60 iterations: {method: (threshold, JAX iterations)}. JAX: point
# 9.204e-7, plane 5.933e-7, symmetric 3.484e-7, gicp 1.448e-7, ndt
# 8.912e-7, global 5.023e-7, coarse_to_fine 6.441e-7, aa 5.066e-7 (the ICP
# or fine stage's iterations); RANSAC's and SGD's draws are not JAX's:
# global is held by its chamfer RMSE (the saddle's symmetry gives a second
# exact optimum) and its iterations are not compared, SGD by the JAX test's
# 2e-3 (JAX 7.862e-7 in its 60 steps)
REGISTER_POSE = ((0.02, -0.015, 0.01), (0.03, -0.02, 0.015))
REGISTER_RUNS = {"point": (1e-5, 2), "plane": (1e-5, 2),
                 "symmetric": (1e-5, 2), "gicp": (1e-5, 2), "ndt": (1e-5, 1),
                 "global": (1e-5, None), "coarse_to_fine": (1e-5, 1),
                 "aa": (1e-5, 2), "sgd": (2e-3, None)}


# register_batch for every config. The Morton batch: 16 scans of
# 65,536 points (an Ouster OS1-64 scan's size) under near-registered
# ground truths, translation U(±0.01) and rotation U(±0.004) rad, at
# docs/serving.md's one-shot config, through K3 and K3p; the other configs
# at the serving batch (32 x 4,096). Each element must reach its
# threshold, 10x the largest GT error of the JAX package's register_batch
# on the CPU for the same batch rounded up to a decade (the morton batch
# through its XLA geometry; tests/test_torch_batch.py run as a script
# prints them), and its own run_icp's iterations on the card (within 1, or
# later once converged: STOP_NOISE)
MORTON_BATCH = dict(batch=16, width=256, seed=1, pose=(0.01, 0.004))
MORTON_SERVING = dict(matcher="morton", max_iterations=20, auto_trim=9.0)
BATCH_CONFIG_RUNS = [  # (label, config fields, batch, threshold)
    ("morton K3 16x65536", MORTON_SERVING, "morton", 1e-4),  # 2.191e-6
    ("morton K3p 16x65536", dict(MORTON_SERVING, **PACKED), "morton",
     1e-4),  # 2.191e-6
    ("symmetric K1 32x4096", dict(metric="symmetric", matcher="pallas",
                                  max_iterations=20), "serving",
     1e-5),  # 9.580e-7
    ("gicp K1 32x4096", dict(metric="gicp", matcher="pallas",
                             max_iterations=20), "serving", 1e-5),  # 8.737e-7
    ("grid 32x4096", dict(matcher="grid", max_iterations=20), "near",
     1e-2),  # 3.796e-4
    ("plane K1 32x4096, normals estimated", dict(
        metric="plane", matcher="pallas", max_iterations=20), "serving",
     1e-5),  # 9.245e-7
]
# the grid matcher finds neighbours within a cell (twice the spacing): its
# batch is the serving source under near-registered ground truths,
# translation U(±0.02) and rotation U(±0.01) rad
NEAR_SERVING = dict(seed=2, pose=(0.02, 0.01))
# odometry through K3: 17 frames of 65,536 points, 16 pairs of one batch,
# the sensor 0.005 along +x a frame over surface_grid(512) (0.64 of the
# grid's spacing: near-registered pairs, as the config is for), N(0, 1e-3)
# noise; every pose's x within ODOMETRY_MORTON["drift"] of the GT and its
# other translation and rotation entries too: 10x the JAX package's
# largest on the CPU for the same frames, rounded up to a decade
# (tests/test_torch_batch.py run as a script)
ODOMETRY_MORTON = dict(frames=17, points=65536, step=0.005, noise=1e-3,
                       seed=3, drift=1e-3, config=MORTON_SERVING)


def serving_poses(batch=32, seed=0):
    """The serving batch's ground truths: B (translation, rotation) pairs,
    U(±0.15) and U(±0.08) rad, from ``seed``: 4-14 iterations each."""
    rng = np.random.default_rng(seed)
    return [(tuple(rng.uniform(-0.15, 0.15, 3).tolist()),
             tuple(rng.uniform(-0.08, 0.08, 3).tolist()))
            for _ in range(batch)]


def slam_frames(np, world, frames=12, points=4096, seed=0):
    """The SLAM example's sequence (``examples/odometry_slam.py:36-63``) at
    N = ``points``: a sensor sweeps +x over ``world`` (the 16,384-point
    synthetic scene) and back, each frame the N points nearest its
    viewpoint, in its own coordinates, with N(0, 4e-3) noise; consecutive
    frames share ~75% of their points. Returns ``(frames [T, N, 3],
    ground-truth poses [T, 4, 4])`` as numpy."""
    rng = np.random.default_rng(seed)
    xs = np.concatenate([np.linspace(0, 1.2, frames // 2),
                         np.linspace(1.2, 0, frames - frames // 2)])
    gt = np.tile(np.eye(4, dtype=np.float32), (frames, 1, 1))
    gt[:, 0, 3] = xs
    out = []
    for t in range(frames):
        crop = world[np.argsort(np.abs(world[:, 0] - xs[t]))[:points]]
        local = crop - gt[t, :3, 3]
        out.append((local + rng.normal(scale=4e-3, size=local.shape))
                   .astype(np.float32))
    return np.stack(out), gt


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
    from fpcr_tpu_torch.bench.card import smi_line
    from fpcr_tpu_torch.utils.precision import (pin_f32_precision,
                                                precision_settings)

    name = torch.cuda.get_device_name(0)
    smi = smi_line(0)
    if smi is None:
        raise RuntimeError("nvidia-smi gave no name and power limit")
    print(smi, flush=True)
    log("device", f"torch.cuda.get_device_name(0) = {name}; "
                  f"device_count = {torch.cuda.device_count()}")
    log("device", f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
                  f"python {sys.version.split()[0]}")
    pin_f32_precision()
    for k, v in precision_settings().items():
        log("device", f"{k} = {v}")
    return name, smi


def sass_counts(path):
    """``({kernel: {"HMMA": n, "HGMMA": n, "FFMA": n}}`` of every Kernel S
    instance (the wgmma sweep and the mma.sync yardstick) and every
    instance of the tensor-core K1/K2 sweep, ``{kernel: {opcode: n}}`` of
    every instance of the E1 / min-only sweeps (``nn_forms_kernel`` and the
    yardstick's ``nn_partial_kernel``, FORM_OPS)) in the library's SASS,
    read with the toolkit's ``cuobjdump``."""
    from pathlib import Path

    from fpcr_tpu_torch import _build

    tool = str(Path(_build.find_nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, forms, name, form = {}, {}, None, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            form = name if any(k in name for k in (
                "nn_forms_kernel", "nn_partial_kernel")) else None
            if form:
                forms[form] = dict.fromkeys(FORM_OPS, 0)
            if not any(k in name for k in ("split_partial_kernel",
                                            "split_wgmma_kernel",
                                            "nn_tc_sweep_kernel")):
                name = None
            else:
                counts[name] = {"HMMA": 0, "HGMMA": 0, "FFMA": 0}
        elif name:
            for op in ("HMMA", "HGMMA", "FFMA"):
                counts[name][op] += f" {op}." in line or f" {op} " in line
        elif form and "*/" in line:
            words = line.split("*/", 1)[1].split()
            if words and words[0].startswith("@"):
                words = words[1:]
            op = words[0].split(".")[0] if words else ""
            if op in forms[form]:
                forms[form][op] += 1
    return counts, forms


# the opcodes counted in the E1 / min-only sweeps' SASS
FORM_OPS = ("FFMA", "FADD", "FMNMX", "LOP3", "IMNMX", "VIMNMX3", "VIMNMX",
            "ISETP", "FSETP", "SEL", "FSEL", "LDS")
# pairs of the new sweep's unrolled sub-tile body: 32 targets x 8 rows
FORMS_BODY_PAIRS = 256


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
    counts, forms = sass_counts(res.path)
    for name, c in sorted(forms.items()):
        per = {k: v for k, v in c.items() if v}
        est = ("" if "nn_forms_kernel" not in name else
               f"; per pair of the unrolled sub-tile (prologue and rescan "
               f"included): " + ", ".join(
                   f"{k} {v / FORMS_BODY_PAIRS:.2f}" for k, v in per.items()
                   if k != "LDS"))
        log("build", f"SASS {name}: {per}{est}")
    if len([k for k in forms if "nn_forms_kernel" in k]) != 18:
        raise AssertionError("csrc/nn_forms.cu does not hold its 18 "
                             "instances")
    log("build", f"ptxas spills of the E1 / min-only sweep: "
                 f"{tc_spills(res.log, 'nn_forms_kernel')}")
    for name, c in counts.items():
        log("build", f"SASS {name}: {c['HMMA']} HMMA (bf16 mma.sync), "
                     f"{c['HGMMA']} HGMMA (wgmma), {c['FFMA']} FFMA")
    split = [c for k, c in counts.items() if "split_partial_kernel" in k]
    if len(split) != 8 or not all(c["HMMA"] for c in split):
        raise AssertionError("a Kernel S yardstick instance issues no bf16 "
                             "HMMA")
    # the wgmma sweep: terms 6 and 3 x four epilogues, and x two ablations
    wgmma = [c for k, c in counts.items() if "split_wgmma_kernel" in k]
    if len(wgmma) != 12 or not all(c["HGMMA"] and not c["HMMA"]
                                   for c in wgmma):
        raise AssertionError("a Kernel S wgmma instance issues no HGMMA, or "
                             "HMMA")
    split_spills = tc_spills(res.log, "split_wgmma_kernel")
    log("build", f"ptxas spills of the Kernel S sweep: {split_spills}")
    if len(split_spills) != 12 or any(split_spills.values()):
        raise AssertionError("a Kernel S wgmma instance spills")
    # C7514 and C7512: ptxas serialises the wgmma (the pipeline's form,
    # or too few registers)
    serialised = [line.strip() for line in nvcc_section(res.log,
                                                        "split_wgmma.cu")
                  if "C7514" in line or "C7512" in line]
    if serialised:
        raise AssertionError(f"ptxas serialises Kernel S's wgmma: "
                             f"{serialised}")
    sweeps = [c for k, c in counts.items() if "nn_tc_sweep_kernel" in k]
    if not sweeps or not all(c["HGMMA"] for c in sweeps):
        raise AssertionError("a tensor-core K1/K2 sweep issues no HGMMA")
    spills = tc_spills(res.log)
    log("build", f"ptxas spills of the tensor-core K1/K2 kernels: {spills}")
    # the finish of K1 and of K2, each with and without the batch offsets
    finishes = [k for k in spills if "nn_tc_finish_kernel" in k]
    if (len(finishes) != 4 or len(spills) != len(sweeps) + len(finishes)
            or any(spills.values())):
        raise AssertionError("a tensor-core K1/K2 kernel spills")


def tc_spills(log_text, key="nn_tc"):
    """``{kernel: spill bytes}`` of every kernel whose name holds ``key`` in
    ptxas' log (the stores and loads of its "Function properties" line)."""
    import re

    spills, name = {}, None
    for line in log_text.splitlines():
        found = re.search(r"Function properties for (\S+)", line)
        if found:
            name = found.group(1) if key in found.group(1) else None
        elif name and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill", line)
            spills[name] = int(st) + int(ld)
            name = None
    return spills


def nvcc_section(log_text, source):
    """The lines of the build log that the nvcc command compiling
    ``source`` printed (the log holds each command after a ``$ ``)."""
    lines, inside = [], False
    for line in log_text.splitlines():
        if line.startswith("$ "):
            inside = source in line and " -c " in line
        elif inside:
            lines.append(line)
    return lines


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


def path_k1_cases(torch, ft, dev):
    """K1's inputs on the GICP, loop-variant and grid paths at shapes that
    ``kernel_cases`` does not reach: ``evaluate_registration`` on the
    262,144-point grid at its pose (64 target slices, indices past 2^16),
    run_sgd_icp's first batch (seed 0) of 1,024 Bunny rows against its
    8,171 targets, and the voxel centroids of the 1M scene as run_icp first
    matches them. K1 only: K2's keys hold at most 2^16 targets."""
    s = build_scene(ft, "grid-0", dev)
    cases = [("evaluate grid-0 262144^2",
              s.ground_truth.apply(s.source).contiguous(), s.target)]
    s = build_scene(ft, "bunny", dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = torch.randint(0, s.source.shape[0], (SGD["batch"],),
                         generator=gen, device=dev)
    cases.append((f"sgd batch {SGD['batch']}x8171",
                  s.source[rows].contiguous(), s.target))
    s = ft.synthetic_scene(width=LARGE_WIDTHS[-1], device=dev)
    cs, ms = ft.voxel_downsample(s.source, VOXEL["size"])
    ct, mt = ft.voxel_downsample(s.target, VOXEL["size"])
    cases.append((f"voxel centroids {'x'.join(map(str, VOXEL['centroids']))}",
                  cs[ms].contiguous(), ct[mt].contiguous()))
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


def _check_k1(name, p, q, mask, chunk=2048):
    from fpcr_tpu_torch.ops.matching import nn_argmin_plain
    from fpcr_tpu_torch.ops.matching_cuda import nn_argmin_cuda

    ki, kd = nn_argmin_cuda(p, q, mask)
    torch.cuda.synchronize()
    oi, od = nn_argmin_plain(p, q, mask, exact=True, source_chunk=chunk,
                             target_tile=chunk)
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
    """The min-only sweep (``csrc/nn_forms.cu``) against its plain version
    (NaN and inf in the same rows, the rest within kernel_checks'
    MIN_RTOL / MIN_ATOL, CASE_TOL's values) and bit for bit against its
    yardstick (``csrc/matching.cu``)."""
    from fpcr_tpu_torch.bench.kernel_checks import check_min_only

    err = check_min_only(p, q, mask, label=f"min-only {name}")
    log("kernel", f"min-only {name}: max |sqdist err| {err:.3e}, bit for "
                  f"bit the yardstick's -> ok")
    return err


def min_only_nan_cases(torch, np, dev):
    """NaN inputs of the min-only sweep: a NaN target (every row NaN), a
    NaN source row, a masked NaN target (no NaN anywhere), a NaN source
    row whose targets are all masked (inf), at 300 x 3,000 (one slice or
    two) and 2,000 x 16,384 (several)."""
    rng = np.random.default_rng(81)
    out = []
    for n, m in ((300, 3000), (2000, 16384)):
        p = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
        q = rng.uniform(-2, 2, (m, 3)).astype(np.float32)
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        qn, pn = q.copy(), p.copy()
        qn[m // 3, 1] = np.nan
        pn[7] = np.nan
        mask = np.ones(m, bool)
        mask[m // 3] = False
        out += [(f"{n}x{m} NaN target", t(p), t(qn), None),
                (f"{n}x{m} NaN source row", t(pn), t(q), None),
                (f"{n}x{m} masked NaN target", t(p), t(qn), t(mask)),
                (f"{n}x{m} NaN row, all masked", t(pn), t(q),
                 t(np.zeros(m, bool)))]
    return out


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
    for name, p, q in path_k1_cases(torch, ft, dev):
        worst["nn_argmin"] = max(worst["nn_argmin"], _check_k1(
            name, p, q, None, chunk=PLAIN_CHUNK))
    from fpcr_tpu_torch.bench import packed_reduction

    for name, p, q, mask in ([("E2 study 16384^2",
                               *packed_reduction.study_inputs(16384, dev),
                               None)]
                             + min_only_nan_cases(torch, np, dev)):
        worst["nn_min_only"] = max(worst["nn_min_only"],
                                   _check_min_only(name, p, q, mask))
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


def tc_cases(torch, np, ft, dev):
    """The inputs on which the tensor-core K1 and K2 must equal their
    CUDA-core instances: the kernel cases (masks, ties, an all-masked
    target, 8,171^2, 16,384^2, 35,947^2), the hall scan, E1's +-300 cloud,
    a cloud of duplicates and 200 rows against 1,048,576 targets."""
    from fpcr_tpu_torch.bench import match_kernels

    rng = np.random.default_rng(81)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    cases = kernel_cases(torch, np, ft, dev)
    s = build_scene(ft, "hall", dev)
    cases.append(("hall-16384^2", s.source, s.target, None))
    cases.append(("E1 +-300 16384^2", *match_kernels.study_inputs(16384, dev),
                  None))
    dup = np.repeat(rng.uniform(-2, 2, (37, 3)), 27, axis=0)
    near = dup[rng.integers(0, 999, 700)] + rng.normal(scale=1e-3,
                                                       size=(700, 3))
    cases.append(("duplicates 700x999", t(near.astype(np.float32)),
                  t(dup.astype(np.float32)), None))
    big = rng.uniform(-2, 2, (1 << 20, 3)).astype(np.float32)
    rows = big[rng.integers(0, 1 << 20, 200)] + rng.normal(
        scale=1e-3, size=(200, 3)).astype(np.float32)
    cases.append(("200x1048576", t(rows), t(big), None))
    return cases


def phase_tc_vs_cudacore(torch, np, ft, dev, smi):
    """The tensor-core K1 and K2 against the CUDA-core sweep of the same
    functions (``_nn_argmin_cudacore``, ``_nn_argmin_packed_cudacore``),
    bit for bit in index and distance, on every input of ``tc_cases``; two
    launches a call, none of them a host synchronisation; the rescued share
    of each input; and the guard: on the synthetic scene, E1's +-300 cloud,
    the hall scan and Bunny, every value of one tile of the sweep
    (``_nn_tc_tile_values``) within a quarter of its pair's G of the float64
    distance. Returns ``({input: (K1 share, K2 share)}, largest ratio)``."""
    from fpcr_tpu_torch.ops import matching_cuda as mc
    from fpcr_tpu_torch.ops.matching import CERT_GUARD, packed_idx_bits

    shares = {}
    for name, p, q, mask in tc_cases(torch, np, ft, dev):
        m = q.shape[0]
        bits = packed_idx_bits(m) if m <= 1 << 16 else (m - 1).bit_length()
        calls = (("K1", lambda: mc.nn_argmin_cuda(p, q, mask),
                  lambda: mc._nn_argmin_cudacore(p, q, mask),
                  mc.nn_argmin_cuda),
                 ("K2", lambda: mc.nn_argmin_packed_cuda(p, q, mask,
                                                         idx_bits=bits),
                  lambda: mc._nn_argmin_packed_cudacore(p, q, mask,
                                                        idx_bits=bits),
                  mc.nn_argmin_packed_cuda))
        row = []
        for k, (label, new, core, wrapper) in enumerate(calls):
            mc.reset_rescued(dev)
            torch.cuda.synchronize()
            before = wrapper.launches
            torch.cuda.set_sync_debug_mode("error")  # a sync in a call raises
            try:
                a = new()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            if wrapper.launches - before != 2:
                raise AssertionError(f"{label} {name}: "
                                     f"{wrapper.launches - before} launches")
            b = core()
            torch.cuda.synchronize()
            same = (torch.equal(a[0], b[0]) and torch.equal(
                a[1].view(torch.int32), b[1].view(torch.int32)))
            rescued = mc.rescued_rows(dev)[k]
            row.append(rescued / p.shape[0])
            log("tc", f"{label} {name}: idx and distance bits equal to the "
                      f"CUDA-core sweep: {same}; rescued rows {rescued}/"
                      f"{p.shape[0]} ({rescued / p.shape[0]:.4f}) "
                      f"[card: {smi}]")
            if not same:
                raise AssertionError(f"{label} {name}: the tensor-core "
                                     "kernel differs from the CUDA-core one")
        shares[name] = tuple(row)

    from fpcr_tpu_torch.bench import match_kernels

    worst = 0.0
    guard_inputs = [("synthetic", build_scene(ft, "synthetic", dev)),
                    ("hall", build_scene(ft, "hall", dev)),
                    ("bunny", build_scene(ft, "bunny", dev))]
    guard_inputs = [(k, s.source, s.target) for k, s in guard_inputs]
    guard_inputs.append(("E1 +-300", *match_kernels.study_inputs(16384,
                                                                  dev)))
    for name, p, q in guard_inputs:
        d, centre = mc._nn_tc_tile_values(p, q)
        torch.cuda.synchronize()
        cols = min(64, q.shape[0])
        qt = q[:cols].double()
        exact = ((p.double()[:, None, :] - qt[None]) ** 2).sum(-1)
        pn = (p - centre).double().norm(dim=1)
        qn = (q[:cols][None] - centre[:, None]).double().norm(dim=2)
        g = CERT_GUARD * (pn[:, None] + qn) ** 2
        ratio = float(((d[:, :cols].double() - exact).abs() / g).max())
        worst = max(worst, ratio)
        log("tc", f"guard on {name}: largest |d~ - d64| / G over "
                  f"{p.shape[0]} x {cols} pairs {ratio:.4f} (<= 0.25) "
                  f"[card: {smi}]")
    if worst > 0.25:
        raise AssertionError(f"the sweep's values strayed {worst:.3f} G")
    return shares, worst


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
    out += case("outside-box 2500x3000", q, (near(q, 2500) + t(np.float32(
        [3.0, 0.0, -2.5]))).contiguous(), geoms=((512, 64),))
    # eight targets 70 times each: equal distances span three 32-row
    # sub-tiles, the seed sub-tile among them
    dup = q[t(rng.integers(0, 3000, 8))].repeat_interleave(70, 0)
    pd = torch.cat([dup[::70].repeat_interleave(40, 0) + 0.01 * t(
        rng.normal(size=(320, 3)).astype(np.float32)), near(q, 900)])
    out += case("duplicates 1220x3560", torch.cat([q, dup]), pd, geoms=both)
    q5 = t(rng.uniform(-2, 2, size=(5000, 3)).astype(np.float32))
    out += case("two-tiles 4000x5000", q5, near(q5, 4000),
                geoms=((1000, 300),))  # band 1,792, two passes a chunk
    s = ft.transformed_scene(ft.surface_grid(256, device=dev),
                             (0.3, -0.2, 0.25), (0.4, -0.3, 0.2))
    out += case("far-pose 65536", s.target, s.source, geoms=((512, 64),))
    for w in LARGE_WIDTHS:
        s = build_scene(ft, f"grid-{LARGE_WIDTHS.index(w)}", dev)
        out += case(f"synthetic-{w * w}", s.target, s.source, geoms=both)
    s = build_scene(ft, "hall_near", dev)
    out += case("hall-16384", s.target, s.source, geoms=both)
    s = build_scene(ft, "bunny_full", dev)
    out += case("bunny-full-35947", s.target, s.source, geoms=both)
    return out


def _check_culling(label, p, table, extra, chunk, window, kernel, out,
                   stats):
    """The kernel's band bases against ``band_bases`` bit for bit, and its
    culled outputs ``out`` against its unculled instance's, all four bit
    for bit; returns the share of (group, sub-tile) visits culled."""
    from fpcr_tpu_torch.ops.morton import band_bases
    from fpcr_tpu_torch.ops.morton_cuda import band_visit_totals

    full = {}
    ref = kernel(p, table, extra, chunk=chunk, window=window, _cull=False,
                 _stats=full)
    torch.cuda.synchronize()
    _, bases = band_bases(p, table, chunk, window)
    for run in (stats, full):
        if not torch.equal(run["bases"], bases):
            raise AssertionError(f"{label}: the kernel's band bases differ "
                                 "from band_bases on "
                                 f"{int((run['bases'] != bases).sum())} "
                                 "chunks")
    for what, a, b in zip(("matched", "sqdist", "idx", "extra"), out, ref):
        if (a is None) != (b is None) or (a is not None
                                          and not torch.equal(a, b)):
            raise AssertionError(f"{label}: culled and unculled {what} "
                                 "differ")
    total, _ = band_visit_totals(p.shape[0], chunk, stats["band"])
    visits = int(stats["visits"].sum())
    if int(full["visits"].sum()) != total or not 0 <= visits <= total:
        raise AssertionError(f"{label}: visits {visits} / "
                             f"{int(full['visits'].sum())} of {total}")
    return 1.0 - visits / total


def _check_band(name, p, table, extra, chunk, window, packed):
    """K3 (``packed`` False) or K3p against its plain version: indices in
    [0, m-1] and below valid_count, matched points and extras bit-equal to
    the table rows, every row finite, picks equal except at ties (K3) or
    within one bucket (K3p), distances of equal picks within CASE_TOL; and
    :func:`_check_culling`. Returns the largest |sqdist err| over equal
    picks."""
    from fpcr_tpu_torch.ops.morton import (band_idx_bits, band_rows,
                                           morton_nn_band_packed_plain,
                                           morton_nn_band_plain)
    from fpcr_tpu_torch.ops.morton_cuda import (morton_nn_cuda,
                                                morton_nn_packed_cuda)

    label = "K3p" if packed else "K3"
    kernel = morton_nn_packed_cuda if packed else morton_nn_cuda
    stats = {}
    out = kernel(p, table, extra, chunk=chunk, window=window, _stats=stats)
    km, kd, ki, ke = out
    torch.cuda.synchronize()
    culled = _check_culling(f"{label} {name}", p, table, extra, chunk,
                            window, kernel, out, stats)
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
                  "table rows; bases equal to band_bases, culled and "
                  "unculled bit-equal, sub-tile visits culled "
                  f"{culled:.4f} -> ok")
    return err


# cycles of torch.cuda._sleep's spin kernel on each side of a profiled run
# (~50 us at the H100's clock)
PAD_CYCLES = 100_000


def device_events(fn, required=True):
    """The device events of one run of ``fn`` under ``torch.profiler``,
    after a warm-up run. Sessions lose a few events at their edges (one or
    two of 10-20 in most short sessions) and now and then report none at
    all, so the run sits between two spin kernels that are left out of the
    result, and a session that reports no event of ``fn`` is retaken, up
    to five times. After that an empty list is returned, or, where
    ``required``, an error raised."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(PAD_CYCLES)
            fn()
            torch.cuda._sleep(PAD_CYCLES)
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and "spin_kernel" not in e.name]
        if events:
            return events
        PROFILER_EMPTY.append(attempt)
    if required:
        raise AssertionError("the profiler saw no device event")
    return []


# device_events sessions that reported no event of the profiled run
PROFILER_EMPTY = []


def phase_band_vs_plain(torch, np, ft, dev):
    """K3 against ``morton_nn_band_plain`` and K3p against
    ``morton_nn_band_packed_plain`` on the same inputs, the bases and the
    culled instances on every case, and one CUDA kernel per call; the
    largest error of each."""
    from fpcr_tpu_torch.ops.morton_cuda import (morton_nn_cuda,
                                                morton_nn_packed_cuda)

    worst = {"morton_nn": 0.0, "morton_nn_packed": 0.0}
    for name, p, table, extra, chunk, window in band_cases(torch, np, ft,
                                                            dev):
        for key, packed in (("morton_nn", False), ("morton_nn_packed", True)):
            worst[key] = max(worst[key], _check_band(
                name, p, table, extra, chunk, window, packed))
    for kernel in (morton_nn_cuda, morton_nn_packed_cuda):
        for e in (None, extra):
            names = [ev.name for ev in device_events(
                lambda: kernel(p, table, e, chunk=chunk, window=window))]
            if len(names) != 1 or "morton_band_kernel" not in names[0]:
                raise AssertionError(f"{kernel.__name__} launched {names}")
            log("kernel", f"{kernel.__name__} ({name}, extra "
                          f"{e is not None}): one CUDA kernel a call, "
                          f"{names[0]} -> ok")
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


def study_cases(torch, np, ft, dev):
    """``(split cases, E1 cases)``, each ``(name, p, q)``: the studies'
    inputs at 16,384² (E4's synthetic scene, E3's saddle, E1's ±300
    cloud), then ragged shapes off every tile (m = 1, m = 2^14 exactly,
    the packed14 key's most) and a cloud of duplicates for ties."""
    from fpcr_tpu_torch.bench import match_kernels, reduction2

    rng = np.random.default_rng(80)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731

    def cloud(n, scale):
        return t(rng.uniform(-scale, scale, (n, 3)).astype(np.float32))

    def ragged(scale):
        dup = np.repeat(rng.uniform(-scale, scale, (37, 3)), 27, axis=0)
        dup = t(dup.astype(np.float32))
        near = (dup[t(rng.integers(0, 999, 700))]
                + cloud(700, scale * 1e-3)).contiguous()
        return [("131x259", cloud(131, scale), cloud(259, scale)),
                ("1000x1", cloud(1000, scale), cloud(1, scale)),
                ("5x3", cloud(5, scale), cloud(3, scale)),
                ("300x16384", cloud(300, scale), cloud(16384, scale)),
                ("duplicates 700x999", near, dup)]

    s = build_scene(ft, "synthetic", dev)
    split = ([("synthetic-16384^2", s.source, s.target),
              ("saddle-16384^2", *reduction2.study_inputs(dev))]
             + ragged(2.0))
    p, q = match_kernels.study_inputs(16384, dev)
    qn, pn = q.clone(), p.clone()
    qn[5, 1] = float("nan")
    pn[3] = float("nan")
    e1 = ([("study-16384^2", p, q)] + ragged(300.0)
          + [("NaN target 16384^2", p, qn),
             ("NaN source row 2000x16384", pn[:2000].contiguous(), q),
             ("NaN target and row 700x999", pn[:700].contiguous(),
              qn[:999].contiguous())])
    return split, e1


def e1_zero_case(torch, dev):
    """Lanes that make a value exactly -0.0: source rows at the origin
    (a = -2p = -0.0) against targets with positive coordinates, the staged
    lane +0.0 on target 3 and -0.0 on target 5 (|p|^2 lanes -0.0), the rest
    positive. The argmin's first minimum is target 3 with +0.0 (v1, v6: -0.0
    ties it); v2's key of -0.0 (bits 0x80000000) is the least, so target 5;
    v4's and v5's clamp keys -0.0 as +0.0 (``jnp.maximum``), so target 3
    wins the shared bucket as the lower index."""
    n, m = 64, 300
    p = torch.zeros((n, 3), device=dev)
    q = torch.rand((m, 3), generator=torch.Generator().manual_seed(5)).to(
        dev) + 0.5
    q_w = torch.linspace(1.0, 2.0, m, device=dev)
    q_w[3], q_w[5] = 0.0, -0.0
    p_sq = torch.full((n,), -0.0, device=dev)
    return p, q, q_w, p_sq


def phase_studies_vs_plain(torch, np, ft, dev):
    """Kernel S (terms 6 and 3, every epilogue) and the five E1 launches
    against their plain versions (``bench/kernel_checks.py``: picks equal
    on 0.999 of the rows, the rest and every value within the order bound
    of the sum); the largest error of each launch type. Kernel S's wgmma
    sweep is also held against its mma.sync yardstick on every case: the
    share of equal picks and the largest difference are logged, and
    differing picks or values must lie within the same bound."""
    from fpcr_tpu_torch.bench.kernel_checks import (check_form,
                                                    check_form_yardstick,
                                                    check_split, e1_args,
                                                    split_bound)
    from fpcr_tpu_torch.bench.split_matmul import split_pads
    from fpcr_tpu_torch.ops.matching import E1_VARIANTS, nn_form_plain
    from fpcr_tpu_torch.ops.matching_cuda import nn_form_cuda
    from fpcr_tpu_torch.ops.split import split_operands
    from fpcr_tpu_torch.ops.split_cuda import (EPILOGUES, _split_nn_mma_sync,
                                               split_nn_cuda)

    worst = {}
    split, e1 = study_cases(torch, np, ft, dev)
    for name, p, q in split:
        n, m = p.shape[0], q.shape[0]
        for terms in (6, 3):
            p_in, q_in = split_operands(p, q, terms, *split_pads(n, m))
            for epi in EPILOGUES:
                label = f"Kernel S x{terms} {epi} {name}"
                st = check_split(p_in, q_in, n, m, epi, keep=m - 1,
                                 clamp=terms == 3 and epi == "argmin",
                                 label=label)
                key = f"split x{terms} {epi}"
                worst[key] = max(worst.get(key, 0.0), st["max_abs_err"])
                log("kernel", f"{label}: picks equal on {st['equal']}/"
                              f"{st['rows']} rows, max |err| "
                              f"{st['max_abs_err']:.3e} -> ok")
                if epi == "packed14" and q_in.shape[0] > 1 << 14:
                    continue
                kw = dict(keep=m - 1, clamp=terms == 3 and epi == "argmin")
                ki, kd = split_nn_cuda(p_in, q_in, n, m, epi, **kw)
                oi, od = _split_nn_mma_sync(p_in, q_in, n, m, epi, **kw)
                same = ki == oi
                diff = (kd.double() - od.double()).abs()
                bound = split_bound(p_in, q_in, n, m)
                if epi == "packed14":  # one bucket more where picks differ
                    bound = bound + 2.0 ** -9 * od.double().abs()
                share = float(same.double().mean())
                log("kernel", f"{label} against the mma.sync yardstick: "
                              f"picks equal on {share:.6f} of the rows, max "
                              f"|d - d_mma| {float(diff.max()):.3e}")
                if share < 0.999 or bool((diff > bound).any()):
                    raise AssertionError(f"{label}: the wgmma sweep and the "
                                         f"mma.sync yardstick disagree")
    for name, p, q in e1:
        for v in E1_VARIANTS:
            label = f"E1 {v} {E1_VARIANTS[v]} {name}"
            st = check_form(p, q, v, label=label)
            worst[f"e1 {v}"] = max(worst.get(f"e1 {v}", 0.0),
                                   st["max_abs_err"])
            ys = check_form_yardstick(p, q, v, label=label)
            log("kernel", f"{label}: picks equal on {st['equal']}/"
                          f"{st['rows']} rows, max |err| "
                          f"{st['max_abs_err']:.3e}; bit for bit the "
                          f"yardstick's ({ys['nan_rows']} NaN, "
                          f"{ys['inf_rows']} inf rows) -> ok")
    p, q, q_w, p_sq = e1_zero_case(torch, dev)
    for v, (form, reduce) in E1_VARIANTS.items():
        label = f"E1 {v} -0.0 lanes"
        lanes = (q_w, p_sq)
        check_form_yardstick(p, q, v, lanes=lanes, label=label)
        qw, psq, kw = e1_args(p, q, v, lanes=lanes)
        ki, kd = nn_form_cuda(p, q, qw, psq, **kw)
        oi, od = nn_form_plain(p, q, qw, psq, **kw)
        want = 5 if form == "biased" and reduce == "packed" else 3
        bits_ok = reduce == "packed" or torch.equal(kd.view(torch.int32),
                                                    od.view(torch.int32))
        if not (bool((ki == want).all()) and torch.equal(ki, oi)
                and bits_ok):
            raise AssertionError(f"{label}: picked {ki[:4].tolist()}, plain "
                                 f"{oi[:4].tolist()}, expected {want}")
        log("kernel", f"{label}: every row picks target {want}, value bits "
                      f"{hex(int(kd.view(torch.int32)[0]) & 0xFFFFFFFF)}, "
                      f"as the plain version and the yardstick -> ok")
    return worst


def _wrappers():
    from fpcr_tpu_torch.ops.matching_cuda import (_nn_argmin_cudacore,
                                                  _nn_argmin_packed_cudacore,
                                                  _nn_min_only_yardstick,
                                                  nn_argmin_cuda,
                                                  nn_argmin_packed_cuda,
                                                  nn_min_only_cuda)
    from fpcr_tpu_torch.ops.eig3_cuda import eig3_cuda
    from fpcr_tpu_torch.ops.morton_cuda import (morton_nn_cuda,
                                                morton_nn_packed_cuda)
    from fpcr_tpu_torch.ops.ndt_cuda import ndt_fused_moments_cuda
    from fpcr_tpu_torch.ops.svd3_cuda import (_svd3_rotation_fixed,
                                              _svd3_umeyama_fixed,
                                              svd3_rotation_cuda,
                                              svd3_umeyama_cuda)

    return {"nn_argmin": nn_argmin_cuda,
            "nn_argmin_packed": nn_argmin_packed_cuda,
            "nn_min_only": nn_min_only_cuda,
            "morton_nn": morton_nn_cuda,
            "morton_nn_packed": morton_nn_packed_cuda,
            "ndt_fused_moments": ndt_fused_moments_cuda,
            "svd3_rotation": svd3_rotation_cuda,
            "svd3_umeyama": svd3_umeyama_cuda,
            "eig3": eig3_cuda,
            "nn_argmin_cudacore": _nn_argmin_cudacore,
            "nn_argmin_packed_cudacore": _nn_argmin_packed_cudacore,
            "nn_min_only_yardstick": _nn_min_only_yardstick,
            "svd3_fixed_rotation": _svd3_rotation_fixed,
            "svd3_fixed_umeyama": _svd3_umeyama_fixed}


# the CUDA-core sweep of K1 and K2: the yardstick, on no path of the package
CUDACORE = ("nn_argmin_cudacore", "nn_argmin_packed_cudacore")
# Kernel S's mma.sync yardstick, on no path either: its launch types
SPLIT_MMA = tuple(f"split mma x{t} {e}" for t in (6, 3)
                  for e in ("argmin", "packed14", "min", "keep"))
# the E1 forms' and the min-only sweep's first design (csrc/matching.cu),
# on no path: the yardstick of csrc/nn_forms.cu
FORM_YARDSTICKS = tuple(f"e1 yardstick {v}"
                        for v in ("v1", "v2", "v4", "v5", "v6")) + (
    "nn_min_only_yardstick",)
# svd3's first design and the parts of the new one, on no path
SVD3_NO_PATH = ("svd3_fixed_rotation", "svd3_fixed_umeyama") + tuple(
    f"svd3 ablation {part}" for part in ("full", "float32 sweeps only",
                                         "float64 sweeps only", "no sweeps"))
# while the ICP paths rerun on the CUDA-core sweep: the wrapper that counts
# a kernel's launches in its place
KERNEL_ALIAS = {}
# the printed digits of each registration: {name: (iterations, final error,
# GT transform RMSE)}
RECORDS = {}


def _keyed_wrappers():
    """Wrappers that count per launch type, in a dict: Kernel S's
    ``"x<terms> <epilogue>"`` and the E1 forms' ``"v<k>"`` (the new sweep
    and its yardstick), and svd3's ablations by the part of the design
    they run."""
    from fpcr_tpu_torch.ops.matching_cuda import (_nn_form_yardstick,
                                                  nn_form_cuda)
    from fpcr_tpu_torch.ops.split_cuda import _split_nn_mma_sync, split_nn_cuda
    from fpcr_tpu_torch.ops.svd3_cuda import _svd3_ablation

    return {"split": split_nn_cuda, "split mma": _split_nn_mma_sync,
            "e1": nn_form_cuda, "e1 yardstick": _nn_form_yardstick,
            "svd3 ablation": _svd3_ablation}


def counters():
    """Every launch count, keyed by kernel (and launch type)."""
    out = {k: w.launches for k, w in _wrappers().items()}
    for prefix, w in _keyed_wrappers().items():
        out.update({f"{prefix} {k}": v for k, v in w.launches.items()})
    return out


def drive(torch, path, fn):
    """Run one path of the main path with every launch counter set to 0
    just before it, and return the counts read just after."""
    torch.cuda.synchronize()
    for w in _wrappers().values():
        w.launches = 0
    for w in _keyed_wrappers().values():
        w.launches = dict.fromkeys(w.launches, 0)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    counts = counters()
    log("main", f"path '{path}' done in {time.perf_counter() - t0:.2f} s, "
                f"launches { {k: v for k, v in counts.items() if v} }")
    return counts


def register(torch, ft, name, s, run, thr, kernel, per_iteration=1):
    """Register one scene with ``run(source, target)``, check the result
    against its ground truth and the kernel's launches against the
    iterations (``kernel`` None: a path of no kernel), and log the
    outcome."""
    w = _wrappers()[KERNEL_ALIAS.get(kernel, kernel)] if kernel else None
    before = w.launches if w else 0
    t0 = time.perf_counter()
    res = run(s.source, s.target)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    grown = w.launches - before if w else 0
    fine = getattr(res, "fine", res)
    it = int(fine.num_iterations)
    gt = float(ft.transform_rmse(res.transform, s.ground_truth, s.source))
    err = fine.errors.cpu()
    ok_shape = (tuple(fine.points.shape) == tuple(s.source.shape)
                and bool(torch.isfinite(fine.points).all())
                and bool(torch.isfinite(err[:it]).all())
                and bool(torch.isnan(err[it:]).all()))
    RECORDS[name] = (it, f"{float(err[it - 1]):.6e}", f"{gt:.3e}")
    log("main", f"{name}: iterations {it}, converged "
                f"{bool(fine.converged)}, final error "
                f"{float(err[it - 1]):.6e}, GT transform RMSE {gt:.3e} "
                f"(< {thr:g}), wall {wall:.3f} s, "
                f"{KERNEL_ALIAS.get(kernel, kernel) or 'no kernel:'} "
                f"launches +{grown}")
    if not ok_shape:
        raise AssertionError(f"{name}: non-finite or misshapen result")
    if grown < per_iteration * it:
        raise AssertionError(f"{name}: {kernel} launched {grown} times in "
                             f"{it} iterations")
    if not gt < thr:
        raise AssertionError(f"{name}: GT transform RMSE {gt} >= {thr}")
    return res


def check_iterations(name, res, jax_iters):
    it = int(res.num_iterations)
    log("main", f"{name}: the JAX package took {jax_iters} iterations on "
                f"the CPU, the card {it}")
    if abs(it - jax_iters) > 1:
        raise AssertionError(f"{name}: {it} iterations, JAX {jax_iters}")


def loop_passes(iterations, max_iterations, every=8):
    """Passes a loop that reads its done flag once per ``every`` passes
    runs for a stop after ``iterations``: the masked passes included."""
    return min(max_iterations, -(-iterations // every) * every)


def slice3_paths(torch, np, ft, dev):
    """The paths of GICP, the loop variants and the grid: ``[(path, run,
    the kernels it must launch, the kernels it must not)]``. GICP and
    grid ICP keep their 16,384- and 262,144-point results for the
    ``evaluate_registration`` path."""
    from fpcr_tpu_torch.models.icp import resolve_matcher
    from fpcr_tpu_torch.ops.matching_cuda import nn_argmin_cuda

    kept = {}

    def gicp(scenes):
        def fn():
            for name, kind, iters, thr, jax_iters in scenes:
                s = build_scene(ft, kind, dev)
                extra = BAND if kind.startswith("grid") else {}
                cfg = ft.ICPConfig(metric="gicp", max_iterations=iters,
                                   matcher="morton" if extra else "pallas",
                                   **extra)
                res = register(torch, ft, name, s,
                               lambda a, b: ft.run_icp(a, b, cfg), thr,
                               "morton_nn" if extra else "nn_argmin")
                check_iterations(name, res, jax_iters)
                if kind == "synthetic":
                    kept["gicp synthetic-16384"] = (s, res.transform)
        return fn

    def aa():
        s = build_scene(ft, "synthetic", dev)
        for metric, thr, jax_iters, jax_plain in AA_RUNS:
            cfg = ft.ICPConfig(metric=metric, max_iterations=60,
                               matcher="pallas")
            accepted = []

            def run(a, b):
                res, acc = ft.run_aa_icp(a, b, cfg, return_accepted=True)
                accepted.append(acc)
                return res

            name = f"aa {metric} synthetic-16384"
            before = nn_argmin_cuda.launches
            res = register(torch, ft, name, s, run, thr, "nn_argmin")
            calls = (nn_argmin_cuda.launches - before) // 2  # 2 a call
            acc = accepted[0].cpu()
            it = int(res.num_iterations)
            passes = loop_passes(it, cfg.max_iterations)
            check_iterations(name, res, jax_iters)
            plain = int(ft.run_icp(s.source, s.target, cfg).num_iterations)
            share = float(acc[:it].float().mean())
            log("main", f"{name}: accepted the Anderson candidate in "
                        f"{int(acc[:it].sum())} of {it} iterations "
                        f"({share:.3f}); K1 {calls} calls in {passes} loop "
                        f"passes (3 a pass); plain run_icp {plain} "
                        f"iterations (JAX {jax_plain})")
            if calls != 3 * passes:
                raise AssertionError(f"{name}: {calls} K1 calls in {passes} "
                                     "passes, not 3 a pass")
            if it > plain or (metric == "point" and it >= plain):
                raise AssertionError(f"{name}: {it} iterations, plain "
                                     f"run_icp {plain}")

    def scaled():
        src = ft.data.synthetic.random_cloud(16384, seed=11, scale=2.0,
                                             device=dev)
        gt = ft.gt_transform((0.01, -0.02, 0.015), (0.01, -0.008, 0.012),
                             device=dev)
        tgt = SCALED["scale"] * gt.apply(src)
        before = nn_argmin_cuda.launches
        res = ft.run_scaled_icp(src, tgt, ft.ICPConfig(max_iterations=60,
                                                       matcher="pallas"))
        torch.cuda.synchronize()
        it = int(res.num_iterations)
        ds = abs(float(res.scale) - SCALED["scale"])
        err = float(ft.rmse(res.apply(src), tgt))
        log("main", f"scaled ICP volume-16384: iterations {it}, converged "
                    f"{bool(res.converged)}, scale {float(res.scale):.7f} "
                    f"(|ds| {ds:.3e} < {SCALED['scale_tol']:g}), similarity "
                    f"RMSE {err:.3e} (< {SCALED['rmse']:g}), K1 launches "
                    f"+{nn_argmin_cuda.launches - before}")
        check_iterations("scaled ICP volume-16384", res,
                         SCALED["jax_iterations"])
        if not (ds < SCALED["scale_tol"] and err < SCALED["rmse"]
                and bool(res.converged)):
            raise AssertionError("scaled ICP missed its thresholds")

    def sgd():
        s = build_scene(ft, "bunny", dev)
        cfg = ft.ICPConfig(max_iterations=SGD["steps"], tolerance=1e-6)
        coarse = register(
            torch, ft, "sgd bunny-8171", s,
            lambda a, b: ft.run_sgd_icp(a, b, cfg, batch_size=SGD["batch"],
                                        seed=0), SGD["coarse"], "nn_argmin")
        polish = ft.run_icp(coarse.points, s.target,
                            ft.ICPConfig(max_iterations=20, matcher="pallas"))
        total = polish.transform.compose(coarse.transform)
        gt = float(ft.transform_rmse(total, s.ground_truth, s.source))
        log("main", f"sgd bunny-8171 + run_icp polish: "
                    f"{int(polish.num_iterations)} iterations, converged "
                    f"{bool(polish.converged)}, GT transform RMSE {gt:.3e} "
                    f"(< {SGD['polished']:g})")
        if not (gt < SGD["polished"] and bool(polish.converged)):
            raise AssertionError(f"sgd polish: GT transform RMSE {gt}, "
                                 f"converged {bool(polish.converged)}")

    def grid_runs():
        for name, kind, iters, thr, jax_iters in GRID_SCENES:
            s = build_scene(ft, kind, dev)
            cfg = ft.ICPConfig(matcher="grid", max_iterations=iters)
            if resolve_matcher(cfg, s.source.shape[0]).matcher != "grid":
                raise AssertionError(f"{name}: the port's limit degrades "
                                     "the grid matcher")
            res = register(torch, ft, name, s,
                           lambda a, b: ft.run_icp(a, b, cfg), thr, None, 0)
            check_iterations(name, res, jax_iters)
            if kind == "grid-0":
                kept[name] = (s, res.transform)

    def voxel():
        s = ft.synthetic_scene(width=LARGE_WIDTHS[-1], device=dev)
        cs, ms = ft.voxel_downsample(s.source, VOXEL["size"])
        ct, mt = ft.voxel_downsample(s.target, VOXEL["size"])
        counts = (int(ms.sum()), int(mt.sum()))
        log("main", f"voxel_downsample {VOXEL['size']} of 2 x "
                    f"{s.source.shape[0]} points: {counts} centroids (JAX "
                    f"{VOXEL['centroids']})")
        if counts != VOXEL["centroids"]:
            raise AssertionError("voxel_downsample: the centroid counts "
                                 "differ from JAX's")
        small = ft.RegistrationScene(cs[ms], ct[mt], s.ground_truth)
        cfg = ft.ICPConfig(max_iterations=VOXEL["iterations"],
                           matcher="pallas")
        name = "voxel 0.05 synthetic-1048576, run_icp"
        res = register(torch, ft, name, small,
                       lambda a, b: ft.run_icp(a, b, cfg),
                       VOXEL["threshold"], "nn_argmin")
        check_iterations(name, res, VOXEL["jax_iterations"])

    def evaluate():
        """Fitness at least 0.99 at the found pose, and the same call on
        the plain route (``ops.matching``'s K1 wrapper swapped for the
        plain version, which launches nothing) must give the same values:
        ``num_inliers`` equal but for rows whose plain distance lies within
        K1's CASE_TOL of the gate, ``inlier_rmse`` within EVAL_RTOL."""
        from fpcr_tpu_torch.ops import matching as om

        for name, (s, transform) in kept.items():
            q = ft.evaluate_registration(s.source, s.target, transform)
            vals = {k: float(v) for k, v in q.items()}
            plain_d = []

            def plain(p, t, m):
                out = om.nn_argmin_plain(p, t, m, exact=True,
                                         source_chunk=PLAIN_CHUNK,
                                         target_tile=PLAIN_CHUNK)
                plain_d.append(out[1])
                return out

            saved, om.nn_argmin_cuda = om.nn_argmin_cuda, plain
            try:
                ref = ft.evaluate_registration(s.source, s.target, transform)
            finally:
                om.nn_argmin_cuda = saved
            ref = {k: float(v) for k, v in ref.items()}
            gate2 = q["max_correspondence_dist"] ** 2
            od = plain_d[-1]
            near = int((torch.abs(od - gate2) <= CASE_TOL["atol"]
                        + CASE_TOL["rtol"] * od).sum())
            d_in = abs(int(vals["num_inliers"]) - int(ref["num_inliers"]))
            rel = (abs(vals["inlier_rmse"] - ref["inlier_rmse"])
                   / max(ref["inlier_rmse"], 1e-30))
            log("main", f"evaluate_registration on the {name} result: "
                        f"{json.dumps(vals)} (JAX: fitness 1.0); plain "
                        f"route {json.dumps(ref)}: num_inliers differ by "
                        f"{d_in} (rows within tolerance of the gate "
                        f"{near}), inlier_rmse by {rel:.3e} relative "
                        f"(< {EVAL_RTOL:g})")
            if not vals["fitness"] >= 0.99:
                raise AssertionError(f"{name}: fitness {vals['fitness']}")
            if d_in > near or not rel < EVAL_RTOL or (
                    vals["max_correspondence_dist"]
                    != ref["max_correspondence_dist"]):
                raise AssertionError(f"{name}: evaluate_registration "
                                     "differs from the plain route")

    def profile():
        s = build_scene(ft, "synthetic", dev)
        for metric in ("point", "plane"):
            timer = ft.profile_icp(s.source, s.target,
                                   ft.ICPConfig(metric=metric), iterations=5)
            log("main", f"profile_icp {metric} synthetic-16384, 5 "
                        "iterations, CUDA events per phase:\n"
                        + timer.report())

    k1_not = CUDACORE + ("morton_nn",)
    return [("GICP, K1", gicp(GICP_SCENES[:3]), "nn_argmin", k1_not),
            ("GICP Morton, K3", gicp(GICP_SCENES[3:]), "morton_nn",
             CUDACORE + ("nn_argmin",)),
            ("AA-ICP, K1", aa, "nn_argmin", k1_not),
            ("scaled ICP, K1 + svd3 Umeyama", scaled,
             ("nn_argmin", "svd3_umeyama"), k1_not),
            ("SGD-ICP, K1", sgd, "nn_argmin", k1_not),
            ("grid ICP, no kernel", grid_runs, (),
             CUDACORE + ("nn_argmin", "morton_nn")),
            ("voxel_downsample + run_icp, K1", voxel, "nn_argmin", k1_not),
            ("evaluate_registration, K1", evaluate, "nn_argmin", k1_not),
            ("profile_icp, K1", profile, "nn_argmin", k1_not)]


def serving_batch(ft, dev):
    """The serving batch: B copies of ``synthetic_scene(width=64)``'s source
    (4,096 points) and each one's target under its own ground truth
    (``serving_poses``). Returns ``(sources [B,N,3], targets [B,N,3],
    ground truths)``."""
    src = ft.synthetic_scene(width=SERVING["width"], device=dev).source
    gts = [ft.gt_transform(t, r, device=dev)
           for t, r in serving_poses(SERVING["batch"], SERVING["seed"])]
    return (torch.stack([src] * len(gts)),
            torch.stack([g.apply(src) for g in gts]).contiguous(), gts)


def slam_inputs(ft, dev):
    world = ft.synthetic_scene(width=128, device="cpu").source.numpy()
    frames, gt = slam_frames(np, world, SLAM["frames"], SLAM["points"])
    return torch.as_tensor(frames, device=dev), gt


def batched_cases(torch, np, ft, dev):
    """Batched K1 / K2 inputs ``(name, p [B,N,3], q [B,M,3], mask)``: the
    serving batch (32 x 4,096²), the odometry pairs (11 x 4,096²), the
    closure verification's shape with ragged masks (16 x 4,096², every
    third element a third valid, every third none valid) and B = 1."""
    srcs, tgts, _ = serving_batch(ft, dev)
    frames, _ = slam_inputs(ft, dev)
    rng = np.random.default_rng(9)
    keep = np.ones((16, SLAM["points"]), bool)
    keep[1::3] = rng.uniform(size=keep[1::3].shape) < 0.33
    keep[2::3] = False
    pick = torch.as_tensor(rng.integers(0, SLAM["frames"], 16), device=dev)
    return [("serving 32x4096^2", srcs, tgts, None),
            ("odometry 11x4096^2", frames[1:].contiguous(),
             frames[:-1].contiguous(), None),
            ("closures 16x4096^2, ragged masks", frames[pick].contiguous(),
             frames[pick.flip(0)].contiguous(),
             torch.as_tensor(keep, device=dev)),
            ("B=1 4096^2", srcs[:1].contiguous(), tgts[:1].contiguous(),
             None)]


def phase_batched_vs_plain(torch, np, ft, dev):
    """Batched K1 and K2 at the paths' shapes: two launches a batched call
    and no host synchronisation in it; every element's index and distance
    bits equal to its own unbatched call; every element against the plain
    version (K1 as ``_check_k1`` holds it, K2 as ``_check_k2``); the
    gridDim.z limit raises without a launch. Returns the largest error of
    each against its plain version."""
    from fpcr_tpu_torch.ops import matching_cuda as mc
    from fpcr_tpu_torch.ops.matching import packed_idx_bits

    worst = {"nn_argmin": 0.0, "nn_argmin_packed": 0.0}
    for name, p, q, mask in batched_cases(torch, np, ft, dev):
        for key, wrapper, check in (
                ("nn_argmin", mc.nn_argmin_cuda, _check_k1),
                ("nn_argmin_packed", mc.nn_argmin_packed_cuda, _check_k2)):
            kw = ({"idx_bits": packed_idx_bits(q.shape[1])}
                  if key == "nn_argmin_packed" else {})
            torch.cuda.synchronize()
            before = wrapper.launches
            torch.cuda.set_sync_debug_mode("error")
            try:
                idx, dist = wrapper(p, q, mask, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            if wrapper.launches - before != 2:
                raise AssertionError(f"{key} {name}: {wrapper.launches - before}"
                                     " launches, not 2")
            for k in range(p.shape[0]):
                m_k = None if mask is None else mask[k]
                ei, ed = wrapper(p[k], q[k], m_k, **kw)
                if not (torch.equal(idx[k], ei) and torch.equal(
                        dist[k].view(torch.int32), ed.view(torch.int32))):
                    raise AssertionError(f"{key} {name}: element {k} differs "
                                         "from its unbatched call")
                if k in (0, p.shape[0] - 1) or mask is not None:
                    worst[key] = max(worst[key], check(
                        f"{name} element {k}", p[k], q[k], m_k))
            log("kernel", f"batched {key} {name}: 2 launches, no sync, every "
                          f"element bit for bit its unbatched call -> ok")
    big = torch.zeros((mc.MAX_BATCH + 1, 1, 3), device=dev)
    before = mc.nn_argmin_cuda.launches
    try:
        mc.nn_argmin_cuda(big, big)
    except ValueError as e:
        log("kernel", f"batched K1 at {mc.MAX_BATCH + 1} elements raises: {e}"
                      " -> ok")
    else:
        raise AssertionError("a batch past gridDim.z did not raise")
    if mc.nn_argmin_cuda.launches != before:
        raise AssertionError("K1 launched past gridDim.z")
    return worst


def _check_gt(ft, name, res, gt, probe, thr, jax_iters=None):
    """Log a registration's iterations and GT error; raise past ``thr`` or
    more than one iteration from JAX's."""
    err = float(ft.transform_rmse(res.transform, gt, probe))
    it = int(res.num_iterations)
    log("main", f"{name}: iterations {it}"
                + ("" if jax_iters is None else f" (JAX {jax_iters})")
                + f", GT transform RMSE {err:.3e} (< {thr:g})")
    if not err < thr:
        raise AssertionError(f"{name}: GT transform RMSE {err} >= {thr}")
    if jax_iters is not None and not stopped_on_noise(it, jax_iters,
                                                      res.errors.cpu()):
        raise AssertionError(f"{name}: {it} iterations, JAX {jax_iters}")
    return err


def stopped_on_noise(it, ref, errors):
    """Whether a run that stopped after ``it`` iterations agrees with a
    reference that stopped after ``ref``: within 1, or later and already
    converged (its error below ``STOP_NOISE``) at the reference's stop, so
    that only the stop test's landing on rounding parts them."""
    return abs(it - ref) <= 1 or (it > ref
                                  and float(errors[ref - 1]) < STOP_NOISE)


def run_slam(torch, ft, dev):
    """The SLAM example's pipeline on the card (``examples/odometry_slam.py``
    at N = 4,096): ``register_sequence``, ``detect_loop_closures`` (one
    16-pair batch), ``registration_covariance`` → ``information_from_
    covariance`` per closure, ``close_loops`` (6 GN iterations) and
    ``build_map``, each stage's wall time (synchronised) recorded."""
    stages = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = round(time.perf_counter() - t0, 4)
        return out

    frames, gt, odo, (ei, ej, Z), infos, odo_w = slam_graph(torch, ft, dev,
                                                            timed)
    T = frames.shape[0]
    pairs = [list(p) for p in zip(ei.tolist(), ej.tolist())]
    res = timed("close_loops", lambda: ft.close_loops(
        odo, ei, ej, Z, infos, odometry_weight=odo_w,
        iterations=SLAM["gn"]))
    _, valid = timed("build_map", lambda: ft.build_map(frames, res.poses,
                                                       SLAM["voxel"]))
    its = odo.relative.num_iterations.cpu().tolist()
    errors = odo.relative.errors.cpu()
    return {"iterations": its,
            "final": [float(errors[k, it - 1]) for k, it in enumerate(its)],
            "closures": pairs, "stages": stages, "map": int(valid.sum()),
            "open": float(np.abs(odo.poses[T - 1].cpu().numpy()
                                 - gt[T - 1]).max()),
            "closed": float(np.abs(res.poses[T - 1].cpu().numpy()
                                   - gt[T - 1]).max()),
            "rms": [round(x, 6) for x in res.residual_rms.cpu().tolist()]}


def slice4_paths(torch, np, ft, dev):
    """The batch paths: ``[(path, run, the kernels it must launch, the
    kernels it must not)]``: serving through batched K1 and K2, the SLAM
    pipeline, ICP history with a checkpoint round trip, global
    registration and ``register()``'s nine methods."""
    from fpcr_tpu_torch.ops import matching_cuda as mc

    def serving(mode):
        packed = bool(mode)
        wrapper = mc.nn_argmin_packed_cuda if packed else mc.nn_argmin_cuda

        def fn():
            srcs, tgts, gts = serving_batch(ft, dev)
            cfg = ft.ICPConfig(max_iterations=SERVING["iterations"],
                               matcher="pallas", **mode)
            before = wrapper.launches
            t0 = time.perf_counter()
            res = ft.register_batch(srcs, tgts, cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            calls = (wrapper.launches - before) // 2
            its = res.num_iterations.cpu().tolist()
            passes = loop_passes(max(its), cfg.max_iterations)
            label = "serving packed6_idx (K2)" if packed else "serving (K1)"
            jax_its = SERVING["jax_packed_iterations" if packed
                              else "jax_iterations"]
            errs = [float(ft.transform_rmse(
                ft.RigidTransform(res.transform.rotation[k],
                                  res.transform.translation[k]), g,
                srcs[k])) for k, g in enumerate(gts)]
            singles = [ft.run_icp(srcs[k], tgts[k], cfg)
                       for k in range(len(gts))]
            own = [int(r.num_iterations) for r in singles]
            log("main", f"{label} register_batch B={len(gts)} x "
                        f"{srcs.shape[1]}: wall {wall:.3f} s, iterations "
                        f"{its} (JAX {list(jax_its)}, "
                        f"run_icp on the card {own}), largest GT transform "
                        f"RMSE {max(errs):.3e} (< {SERVING['threshold']:g}), "
                        f"{calls} batched calls in {passes} loop passes")
            if calls != passes:
                raise AssertionError(f"{label}: {calls} batched calls in "
                                     f"{passes} passes, not one a pass")
            if not max(errs) < SERVING["threshold"]:
                raise AssertionError(f"{label}: GT error {max(errs)}")
            errors = res.errors.cpu()
            for k, it in enumerate(its):
                single = singles[k].errors.cpu()
                if abs(it - jax_its[k]) <= 1 and abs(it - own[k]) <= 1:
                    continue
                log("main", f"{label}: element {k} stopped at {it}, JAX "
                            f"at {jax_its[k]}, its run_icp at {own[k]}; its "
                            f"errors {errors[k, :it].tolist()}, run_icp's "
                            f"{single[:own[k]].tolist()}")
                if not (stopped_on_noise(it, jax_its[k], errors[k])
                        and (stopped_on_noise(it, own[k], errors[k])
                             or stopped_on_noise(own[k], it, single))):
                    raise AssertionError(f"{label}: element {k} took {it} "
                                         "iterations")
        return fn

    def slam():
        out = run_slam(torch, ft, dev)
        its, pairs = out["iterations"], out["closures"]
        log("main", f"SLAM T={SLAM['frames']} x {SLAM['points']}: pair "
                    f"iterations {its} (JAX {list(SLAM['jax_iterations'])}), "
                    f"closures {pairs} (JAX {SLAM['closures']}), open-loop "
                    f"end-pose error {out['open']:.3e}, closed "
                    f"{out['closed']:.3e}, residual RMS {out['rms']}, map "
                    f"{out['map']} voxels; stage walls (s) "
                    f"{json.dumps(out['stages'])}")
        for k, (it, ref, final, ref_final) in enumerate(zip(
                its, SLAM["jax_iterations"], out["final"],
                SLAM["jax_final"])):
            gap = abs(final - ref_final) / ref_final
            if abs(it - ref) > 1:
                log("main", f"SLAM pair {k}: {it} iterations, JAX {ref}; "
                            f"final error {final:.6e}, JAX {ref_final:.6e} "
                            f"({gap:.4f} apart, < {SLAM_FINAL_RTOL:g})")
                if not gap < SLAM_FINAL_RTOL:
                    raise AssertionError(f"SLAM pair {k}: {it} iterations "
                                         f"and final error {final}")
        if pairs != [list(p) for p in SLAM["closures"]]:
            raise AssertionError("SLAM: closures differ from JAX's")
        if not (out["closed"] < out["open"] < SLAM["open"] and out["map"] > 0
                and out["closed"] < SLAM["closed"]):
            raise AssertionError("SLAM: an end-pose error missed its bound, "
                                 "or closing the loops did not lower it")

    def history():
        import tempfile
        from pathlib import Path

        s = build_scene(ft, "synthetic", dev)
        cfg = ft.ICPConfig(max_iterations=HISTORY["iterations"],
                           matcher="pallas")
        h = ft.run_icp_with_history(s.source, s.target, cfg)
        r = ft.run_icp(s.source, s.target, cfg)
        n = int(h.num_iterations)
        same = (n == int(r.num_iterations)
                and torch.equal(h.transform.rotation, r.transform.rotation)
                and torch.equal(h.transform.translation,
                                r.transform.translation))
        err = _check_gt(ft, "history synthetic-16384 (K1)", h, s.ground_truth,
                        s.source, HISTORY["threshold"])
        idle = bool((h.incremental_translations[n:] == 0).all()
                    and torch.isnan(h.matched_fraction[n:]).all()
                    and (h.errors[n:] == h.errors[n - 1]).all()
                    and not h.active[n:].any())
        with tempfile.TemporaryDirectory() as d:
            early = ft.run_icp_with_history(
                s.source, s.target, ft.ICPConfig(max_iterations=2,
                                                 matcher="pallas"))
            path = ft.save_checkpoint(Path(d) / "run.ckpt", early, cfg)
            loaded, cfg2 = ft.load_checkpoint(path)
            resumed = ft.resume_icp(loaded, s.target, cfg2)
        r_err = float(ft.transform_rmse(resumed.transform, s.ground_truth,
                                        s.source))
        log("main", f"history: equal to run_icp's transform and iterations "
                    f"{same}, rows after the stop masked no-ops {idle}; "
                    f"checkpoint {path.name} after 2 iterations, resumed "
                    f"{int(resumed.num_iterations)} more, GT transform RMSE "
                    f"{r_err:.3e} (< {HISTORY['threshold']:g})")
        if not (same and idle and r_err < HISTORY["threshold"] and err):
            raise AssertionError("history: the run, its rows or the resume "
                                 "failed")

    def global_reg():
        src = ft.load_bunny(device=dev)
        gt = ft.gt_transform(*GLOBAL["bunny_pose"], device=dev)
        tgt = gt.apply(src)
        cfg = ft.ICPConfig(max_iterations=40, matcher="pallas")
        plain = float(ft.transform_rmse(ft.run_icp(
            src, tgt, ft.ICPConfig(max_iterations=60, matcher="pallas"))
            .transform, gt, src))
        res = ft.register_global(src, tgt, cfg)
        err = float(ft.transform_rmse(res.transform, gt, src))
        log("main", f"global Bunny-8171 at 1.2 rad: plain run_icp GT error "
                    f"{plain:.3e} (> {GLOBAL['plain']:g}), register_global "
                    f"{err:.3e} (< {GLOBAL['bunny']:g}) in "
                    f"{int(res.num_iterations)} ICP iterations (JAX 2)")
        if not (plain > GLOBAL["plain"] and err < GLOBAL["bunny"]):
            raise AssertionError("global registration on Bunny missed a "
                                 "threshold")
        g2 = ft.gt_transform(*GLOBAL["synthetic_pose"], device=dev)
        for width, thr in GLOBAL["chamfer"].items():
            s = ft.synthetic_scene(width=width, device=dev)
            tgt2 = g2.apply(s.source)
            res2 = ft.register_global(s.source, tgt2, cfg)
            _, d = ft.nn_argmin(res2.transform.apply(s.source).contiguous(),
                                tgt2, exact=True)
            chamfer = float(torch.sqrt(d.mean()))
            log("main", f"global synthetic-{width * width} at the large "
                        f"pose: chamfer RMSE {chamfer:.3e} (< {thr:g}), GT "
                        f"error {float(ft.transform_rmse(res2.transform, g2, s.source)):.3e}"
                        " (the saddle's symmetry allows either optimum)")
            if not chamfer < thr:
                raise AssertionError(f"global synthetic-{width * width}: "
                                     f"chamfer RMSE {chamfer}")

    def registry():
        s = ft.synthetic_scene(width=32, device=dev)
        gt = ft.gt_transform(*REGISTER_POSE, device=dev)
        tgt = gt.apply(s.source)
        for method in ft.METHODS:
            thr, jax_iters = REGISTER_RUNS[method]
            res = ft.register(s.source, tgt, method=method, max_iterations=60)
            if method == "global":  # either optimum of the saddle
                _, d = ft.nn_argmin(res.transform.apply(s.source)
                                    .contiguous(), tgt, exact=True)
                chamfer = float(torch.sqrt(d.mean()))
                log("main", f"register global synthetic-1024: chamfer RMSE "
                            f"{chamfer:.3e} (< {thr:g}), "
                            f"{int(res.num_iterations)} ICP iterations")
                if not chamfer < thr:
                    raise AssertionError("register global: chamfer RMSE")
                continue
            _check_gt(ft, f"register {method} synthetic-1024", res, gt,
                      s.source, thr, jax_iters)

    k1_not = CUDACORE + ("nn_argmin_packed",)
    return [("serving register_batch, batched K1", serving({}), "nn_argmin",
             k1_not),
            ("serving register_batch packed6_idx, batched K2",
             serving(PACKED), "nn_argmin_packed",
             CUDACORE + ("nn_argmin",)),
            ("SLAM: odometry, closures, covariance, pose graph, map, K1",
             slam, "nn_argmin", k1_not),
            ("ICP history + checkpoint + resume, K1", history, "nn_argmin",
             k1_not),
            ("global registration (FPFH + RANSAC) + ICP, K1", global_reg,
             "nn_argmin", k1_not),
            ("register() x 9 methods, K1 + K3", registry,
             ("nn_argmin", "morton_nn"), CUDACORE)]



def phase_times_slice4(torch, ft, dev, smi):
    """The batch paths' times, each beside the card: ``register_batch``'s wall time a
    batch and registrations/s against 32 sequential ``run_icp`` calls in the
    same call (B = 32 x 4,096, 20 iterations, the stop test off), through K1
    then K2; batched K1 and K2 alone (call by events, kernel by the
    profiler) against 32 unbatched calls and the plain version, with the
    bound; the SLAM pipeline's stages (a second, warm run); and
    ``global_registration``'s stages on Bunny (normals + FPFH, the feature
    search, RANSAC), by events. Returns K1's and K2's batched entries for
    the ``kernels`` line."""
    from fpcr_tpu_torch.models import global_reg as tgr
    from fpcr_tpu_torch.ops import matching_cuda as mc
    from fpcr_tpu_torch.ops.matching import (nn_argmin_features,
                                             nn_argmin_packed_plain,
                                             nn_argmin_plain, packed_idx_bits)
    from fpcr_tpu_torch.utils.timing import cuda_time_ms

    card = f"[card: {smi}]"
    srcs, tgts, _ = serving_batch(ft, dev)
    b, n, m = srcs.shape[0], srcs.shape[1], tgts.shape[1]
    for label, mode in (("K1", {}), ("K2", PACKED), ("K2", PACKED),
                        ("K1", {})):
        cfg = ft.ICPConfig(max_iterations=SERVING["iterations"],
                           tolerance=0.0, matcher="pallas", **mode)
        batch = cuda_time_ms(lambda: ft.register_batch(srcs, tgts, cfg),
                             repeats=3, warmup=1)["min"]
        seq = cuda_time_ms(lambda: [ft.run_icp(srcs[k], tgts[k], cfg)
                                    for k in range(b)], repeats=2,
                           warmup=1)["min"]
        log("times", f"serving B={b} x {n}, 20 iterations ({label}): "
                     f"register_batch {batch:.3f} ms a batch = "
                     f"{b / batch * 1e3:.1f} registrations/s; {b} sequential"
                     f" run_icp {seq:.3f} ms = {b / seq * 1e3:.1f} "
                     f"registrations/s; {seq / batch:.2f}x {card}")
    out = {}
    bits = packed_idx_bits(m)
    for key, wrapper, plain, kw, flops in (
            ("nn_argmin", mc.nn_argmin_cuda,
             lambda: nn_argmin_plain(srcs, tgts, exact=True), {},
             ARGMIN_PAIR_FLOPS),
            ("nn_argmin_packed", mc.nn_argmin_packed_cuda,
             lambda: nn_argmin_packed_plain(srcs, tgts, idx_bits=bits),
             {"idx_bits": bits}, PACKED_PAIR_FLOPS)):
        def one_by_one():
            return [wrapper(srcs[k], tgts[k], **kw) for k in range(b)]

        call = cuda_time_ms(lambda: wrapper(srcs, tgts, **kw), repeats=20,
                            warmup=3)["min"]
        seq = cuda_time_ms(one_by_one, repeats=5, warmup=1)["min"]
        kern = kernel_ms(lambda: wrapper(srcs, tgts, **kw))
        seq_kern = kernel_ms(one_by_one, repeats=3)
        plain_ms = cuda_time_ms(plain, repeats=2, warmup=1)["min"]
        bound_ms, bound_by = bound(b * (12 * n + 12 * m + 8 * n),
                                   flops * b * n * m)
        out[key] = {"batch": b, "n": n, "m": m, "ms": call,
                    "kernel_ms": kern, "unbatched_ms": seq,
                    "unbatched_kernel_ms": seq_kern, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by}
        log("times", f"batched {key} B={b} x {n}x{m}: call {call:.4f} ms, "
                     f"kernel {kern:.4f} ms (profiler; bound {bound_ms:.4f} "
                     f"ms by {bound_by}, {kern / bound_ms:.2f}x); {b} "
                     f"unbatched calls {seq:.4f} ms, kernel {seq_kern:.4f} "
                     f"ms; plain {plain_ms:.2f} ms {card}")
    out_slam = run_slam(torch, ft, dev)
    log("times", f"SLAM T={SLAM['frames']} x {SLAM['points']}, warm run: "
                 f"stage walls (s) {json.dumps(out_slam['stages'])}, total "
                 f"{sum(out_slam['stages'].values()):.4f} s {card}")
    src = ft.load_bunny(device=dev)
    tgt = ft.gt_transform(*GLOBAL["bunny_pose"], device=dev).apply(src)
    src_sel, tgt_sel = src[::2].contiguous(), tgt.contiguous()

    def describe():
        feats = []
        for c in (src_sel, tgt_sel):
            nrm = ft.orient_normals(c, ft.estimate_normals(c, k=8))
            feats.append(ft.fpfh_features(c, nrm, k=16))
        return feats

    f_sel, f_t = describe()

    def search():
        fwd, _ = nn_argmin_features(f_sel, f_t)
        return nn_argmin_features(f_t[fwd.long()], f_sel)

    q_corr, good = tgr._correspondences(src_sel, tgt_sel, 8, 16, True)
    tau = 3.0 * tgr._estimate_spacing(tgt_sel)

    def ransac():
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        samples = torch.multinomial(good.to(torch.float32), 3 * 1024,
                                    replacement=True,
                                    generator=gen).reshape(1024, 3)
        return tgr._ransac(src_sel, q_corr, good, samples, tau, 3)

    stages = {k: cuda_time_ms(fn, repeats=3, warmup=1)["min"]
              for k, fn in (("normals + FPFH", describe),
                            ("feature search", search), ("RANSAC", ransac),
                            ("global_registration", lambda:
                             ft.global_registration(src, tgt)))}
    log("times", "global_registration on Bunny-8171 (4,086 x 8,171 points) "
                 "by stage (events, ms): "
                 + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
                 + f" {card}")
    return out


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
        k1_wrapper = _wrappers()[KERNEL_ALIAS.get("nn_argmin", "nn_argmin")]
        k1 = k1_wrapper.launches
        register(torch, ft, "coarse-to-fine bunny-full-35947", s, run, 1e-4,
                 "morton_nn")
        if k1_wrapper.launches == k1:
            raise AssertionError("the coarse stage never launched K1")

    import numpy as np

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

    study_out, studies = {}, {}

    def study():  # E2: K1, K2 with the study's index bits, min-only
        from fpcr_tpu_torch.bench import packed_reduction

        study_out.update(packed_reduction.main(16384))

    def e4():  # the split distance, Kernel S x6 and x3 against K1
        from fpcr_tpu_torch.bench import split_matmul

        studies["E4"] = split_matmul.main()

    def e3():  # the reductions of the split distance, E3's gates
        from fpcr_tpu_torch.bench import reduction2

        studies["E3"] = reduction2.main()

    def e1():  # the distance forms against the float64 oracle
        from fpcr_tpu_torch.bench import match_kernels

        studies["E1"] = match_kernels.main(16384)

    # (path, run, the kernel it must launch, the kernels it must not)
    packed_not = ("nn_argmin", "morton_nn", "nn_min_only") + CUDACORE
    k1_paths = [("point ICP, K1", brute("point", SCENES),
                 ("nn_argmin", "svd3_rotation"), CUDACORE),
                ("point ICP packed6_idx, K2",
                 brute("point", PACKED_SCENES, "nn_argmin_packed", **PACKED),
                 ("nn_argmin_packed", "svd3_rotation"),
                 packed_not + ("morton_nn_packed",)),
                ("plane ICP, K1", brute("plane", PLANE_SCENES),
                 ("nn_argmin", "eig3"), CUDACORE),
                ("coarse-to-fine, K1 + K3", coarse_to_fine, "morton_nn",
                 CUDACORE),
                ("register_ndt, gather NDT + K1", register_ndt_hall,
                 "nn_argmin", CUDACORE)]
    paths = k1_paths[:3] + [
             ("morton ICP, K3", morton(), ("morton_nn", "svd3_rotation"),
              CUDACORE),
             ("morton ICP packed6_idx, K3p",
              morton(PACKED_MORTON_SCENES, "morton_nn_packed", **PACKED),
              "morton_nn_packed", packed_not + ("nn_argmin_packed",)),
             k1_paths[3],
             ("NDT run_ndt, K4", ndt_runs, "ndt_fused_moments", CUDACORE),
             ("NDT map tracking, K4", map_tracking, "ndt_fused_moments",
              CUDACORE),
             k1_paths[4],
             ("packed-reduction study, K1 + K2 + min-only", study,
              "nn_min_only",
              ("morton_nn", "morton_nn_packed") + FORM_YARDSTICKS),
             ("split-distance study E4, Kernel S", e4,
              ("split x6 argmin", "split x3 argmin"),
              ("nn_argmin_packed",) + SPLIT_MMA),
             ("reduction study E3, Kernel S", e3,
              ("split x6 argmin", "split x6 packed14", "split x6 min",
               "split x6 keep"), ("split x3 argmin",) + SPLIT_MMA),
             ("distance-form study E1", e1,
              ("e1 v1", "e1 v2", "e1 v4", "e1 v5", "e1 v6"),
              ("nn_argmin_packed",) + FORM_YARDSTICKS)] + slice3_paths(torch, np, ft, dev) \
        + slice4_paths(torch, np, ft, dev)
    totals = dict.fromkeys(counters(), 0)
    for path, fn, kernels, absent in paths:
        counts = drive(torch, path, fn)
        for kernel in (kernels,) if isinstance(kernels, str) else kernels:
            if counts[kernel] == 0:
                raise AssertionError(f"path '{path}' never launched "
                                     f"{kernel}")
        ran = [k for k in absent if counts[k]]
        if ran:
            raise AssertionError(f"path '{path}' launched {ran}")
        for k, v in counts.items():
            totals[k] += v
    ran = [k for k in SVD3_NO_PATH if totals[k]]
    if ran:
        raise AssertionError(f"the main path launched svd3's {ran}")
    same_on_cudacore(torch, k1_paths)
    return totals, study_out, studies


def same_on_cudacore(torch, k1_paths):
    """Run every ICP path through K1 or K2 again with the CUDA-core sweep
    in the tensor-core kernels' place (``ops.matching``'s names patched):
    each registration must end with the same iterations, final error and
    GT error to the printed digits."""
    from fpcr_tpu_torch.ops import matching as om
    from fpcr_tpu_torch.ops import matching_cuda as mc
    from fpcr_tpu_torch.utils import graphs

    first = dict(RECORDS)
    RECORDS.clear()
    saved = om.nn_argmin_cuda, om.nn_argmin_packed_cuda
    om.nn_argmin_cuda = mc._nn_argmin_cudacore
    om.nn_argmin_packed_cuda = mc._nn_argmin_packed_cudacore
    KERNEL_ALIAS.update(nn_argmin="nn_argmin_cudacore",
                        nn_argmin_packed="nn_argmin_packed_cudacore")
    # a captured loop replays the wrapper it captured: capture anew
    graphs.clear()
    try:
        for path, fn, _, _ in k1_paths:
            counts = drive(torch, f"{path}, on the CUDA-core sweep", fn)
            if counts["nn_argmin"] or counts["nn_argmin_packed"]:
                raise AssertionError(f"{path}: the tensor-core kernels ran")
    finally:
        om.nn_argmin_cuda, om.nn_argmin_packed_cuda = saved
        KERNEL_ALIAS.clear()
        graphs.clear()
    for name, digits in RECORDS.items():
        log("main", f"{name}: tensor-core {first[name]}, CUDA-core {digits}"
                    f" -> {'equal' if first[name] == digits else 'DIFFER'}")
        if first[name] != digits:
            raise AssertionError(f"{name}: the runs differ under the two "
                                 "instances")


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


OUR_KERNELS = ("nn_tc_sweep_kernel", "nn_tc_finish_kernel",
               "nn_forms_kernel", "nn_forms_finish_kernel",
               "nn_partial_kernel", "nn_combine_kernel",
               "nn_packed_epilogue_kernel", "nn_min_combine_kernel",
               "morton_band_kernel", "ndt_moments_kernel",
               "split_partial_kernel", "split_combine_kernel",
               "split_wgmma_kernel", "split_wgmma_combine_kernel",
               "svd3_rotation_kernel", "svd3_umeyama_kernel",
               "svd3_fixed_rotation_kernel", "svd3_fixed_umeyama_kernel",
               "svd3_ablation_kernel")


def kernel_ms(fn, repeats=10, fallback=True):
    """Device time per call of the port's own kernels that ``fn`` launches
    (``torch.profiler``'s CUDA kernel events over ``repeats`` calls, the
    wrapper's torch glue left out), in ms. A session may lose some events
    (a count short of a whole number a call), so a call's time is each
    kernel's mean event time times its launches a call. Where five
    sessions in a row report no device event, the call is timed whole with
    CUDA events instead (the wrapper's glue included) and logged, or,
    without ``fallback``, None is returned."""
    from fpcr_tpu_torch.utils.timing import cuda_time_ms

    events = device_events(lambda: [fn() for _ in range(repeats)],
                           required=False)
    if not events and not fallback:
        return None
    if not events:
        ms = cuda_time_ms(fn, repeats=repeats)["min"]
        PROFILER_FALLBACKS.append(round(ms, 4))
        log("times", f"the profiler saw no device event in 5 sessions: "
                     f"{ms:.4f} ms from CUDA events, glue included")
        return ms
    ours = {}
    for e in events:
        if any(k in e.name for k in OUR_KERNELS):
            ours.setdefault(e.name, []).append(e.time_range.elapsed_us())
    if not ours:
        raise AssertionError("the profiler saw none of the port's kernels")
    per_call = {k: max(1, round(len(v) / repeats)) for k, v in ours.items()}
    seen = sum(len(v) for v in ours.values())
    if seen != repeats * sum(per_call.values()):
        PROFILER_LOSSES.append((seen, repeats * sum(per_call.values())))
    return sum(sum(v) / len(v) * per_call[k] for k, v in ours.items()) / 1e3


# kernel_ms sessions that lost events: (events seen, events launched)
PROFILER_LOSSES = []
# kernel_ms calls timed with CUDA events because the profiler saw nothing
PROFILER_FALLBACKS = []


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
    legs, ablation, share = tc_legs(p, q, card)

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
            "n": p.shape[0], "m": q.shape[0],
            "plain_expand_ms": plain_expand["min"], "ms_per_iter": per_iter,
            "svd_ms": stage_ms["svd + det fix"], "legs": legs,
            "ablation": ablation, "share": share}


def tc_legs(p, q, card):
    """The tensor-core K1 and K2 against their CUDA-core sweep on the same
    inputs, in legs (CUDA-core, tensor-core, tensor-core, CUDA-core): the
    call time (CUDA events, min of 20) and the kernel time (profiler) of
    each leg; the sweep's kernel time alone and in its ablations; and the
    rescued share of each kernel here."""
    from fpcr_tpu_torch.ops import matching_cuda as mc
    from fpcr_tpu_torch.ops.matching import packed_idx_bits
    from fpcr_tpu_torch.utils.timing import cuda_time_ms

    bits = packed_idx_bits(q.shape[0])
    calls = {"K1 CUDA-core": lambda: mc._nn_argmin_cudacore(p, q),
             "K1": lambda: mc.nn_argmin_cuda(p, q),
             "K2 CUDA-core": lambda: mc._nn_argmin_packed_cudacore(
                 p, q, idx_bits=bits),
             "K2": lambda: mc.nn_argmin_packed_cuda(p, q, idx_bits=bits)}
    legs = {}
    for k in ("K1 CUDA-core", "K1", "K1", "K1 CUDA-core",
              "K2 CUDA-core", "K2", "K2", "K2 CUDA-core"):
        call = cuda_time_ms(calls[k], repeats=20, warmup=3)["min"]
        kern = kernel_ms(calls[k])
        legs.setdefault(k, []).append((call, kern))
        log("times", f"leg {k} N=M={p.shape[0]}: call {call:.4f} ms, kernel "
                     f"{kern:.4f} ms {card}")
    ablation = {}
    for mode in ("sweep", "no reduce", "no staging", "skeleton"):
        ablation[mode] = kernel_ms(lambda: mc._nn_tc_sweep_only(p, q, mode))
        log("times", f"tensor-core sweep alone, {mode}: kernel "
                     f"{ablation[mode]:.4f} ms (profiler) {card}")
    mc.reset_rescued(p.device)
    calls["K1"]()
    calls["K2"]()
    share = [r / p.shape[0] for r in mc.rescued_rows(p.device)]
    log("times", f"rescued share N=M={p.shape[0]}: K1 {share[0]:.4f}, K2 "
                 f"{share[1]:.4f}")
    return legs, ablation, share


def traced_iteration(run, k_lo=2, k_hi=12):
    """Per iteration of ``run(k)`` (k iterations), by the slope of two
    traced runs: device kernels (events other than memcpy and memset),
    other device events, device busy ms (the union of the events' spans)
    and traced wall ms, and the idle share 1 - busy / wall."""
    def one(k):
        wall = []

        def timed():
            t0 = time.perf_counter()
            run(k)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)

        events = device_events(timed)
        busy, end = 0.0, -float("inf")
        for a, b in sorted((e.time_range.start, e.time_range.end)
                           for e in events):
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
        kernels = sum(not e.name.startswith(("Memcpy", "Memset"))
                      for e in events)
        return kernels, len(events) - kernels, busy / 1e3, wall[-1]

    lo, hi = one(k_lo), one(k_hi)
    per = [(b - a) / (k_hi - k_lo) for a, b in zip(lo, hi)]
    return {"kernels": per[0], "other": per[1], "busy_ms": per[2],
            "wall_ms": per[3], "idle": 1.0 - per[2] / per[3]}


def phase_times_slice2(torch, ft, dev, smi):
    """Times of the plane and large-N paths: plane and Morton ICP ms/iter,
    K3 alone against its plain version, normals and the plane solve."""
    from fpcr_tpu_torch.ops.morton import (build_morton_table,
                                           morton_nn_band_packed_plain,
                                           morton_nn_band_plain,
                                           source_morton_order)
    from fpcr_tpu_torch.ops.morton_cuda import (BAND_SUB, band_visit_totals,
                                                morton_nn_cuda,
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
        else:
            tr = traced_iteration(lambda k: ft.run_icp(
                s.source, s.target, ft.ICPConfig(
                    max_iterations=k, tolerance=0.0, matcher="morton",
                    **BAND)))
            log("times", f"morton point ICP N={w * w} traced, per iteration "
                         f"(slope of 2 and 12 iterations): {tr['kernels']:.1f}"
                         f" kernels, {tr['other']:.1f} other device events "
                         f"(memcpy, memset), device busy {tr['busy_ms']:.4f} "
                         f"ms of {tr['wall_ms']:.4f} ms traced, idle "
                         f"{tr['idle']:.1%} {card}")
            out["trace"] = tr
        # K3 alone, at the inputs of the first iteration
        table = build_morton_table(s.target)
        ps = s.source[source_morton_order(s.source, table).long()]
        ps = ps.contiguous()
        nrm = ft.estimate_normals(s.target)[table.orig_index.long()]
        nrm = nrm.contiguous()
        kernels = (("K3", "k3", morton_nn_cuda, morton_nn_band_plain),
                   ("K3p", "k3p", morton_nn_packed_cuda,
                    morton_nn_band_packed_plain))
        for name, key, kernel, plain_fn in kernels:
            for label, extra in (("", None), (" + normals", nrm)):
                call = lambda **kw: kernel(  # noqa: E731
                    ps, table, extra, chunk=512, window=64, **kw)
                wrapper = cuda_time_ms(call, repeats=20, warmup=3)
                plain = cuda_time_ms(lambda: plain_fn(
                    ps, table, extra, chunk=512, window=64), repeats=3,
                    warmup=1)
                kern = kernel_ms(call)
                full = kernel_ms(lambda: call(_cull=False))
                log("times", f"{name} {kernel.__name__}{label} N=M={w * w} "
                             f"c512/w64: min {wrapper['min']:.4f} ms, mean "
                             f"{wrapper['mean']:.4f} ms; kernel {kern:.4f} "
                             f"ms, unculled instance {full:.4f} ms "
                             f"({kern / full:.3f}x; profiler); plain "
                             f"{plain_fn.__name__} min {plain['min']:.4f} ms "
                             f"{card}")
                out[f"{key}{label} {w * w}"] = (wrapper["min"], plain["min"])
                out[f"{key}{label} kernel {w * w}"] = (kern, full)
            stats = {}
            kernel(ps, table, chunk=512, window=64, _stats=stats)
            total, seeds = band_visit_totals(w * w, 512, stats["band"])
            visits = int(stats["visits"].sum())
            out[f"{key} pairs {w * w}"] = (visits + seeds) * BAND_SUB ** 2
            log("times", f"{name} N=M={w * w} c512/w64: (32-row group, "
                         f"sub-tile) visits {visits} of {total} "
                         f"({1 - visits / total:.4f} culled), {seeds} seed "
                         f"sub-tiles: {out[f'{key} pairs {w * w}']} pairs "
                         f"evaluated of {w * w * stats['band']} {card}")
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


def phase_times_slice3(torch, ft, dev, smi):
    """By the slope method, ms/iter of GICP through K1 at 16,384 and K3 at
    1,048,576, AA-ICP at 16,384, grid ICP at 262,144 and 1,048,576 and one
    SGD step; by events, ``build_voxel_table`` and ``grid_nn`` at both
    sizes, ``voxel_downsample`` at 1,048,576 and
    ``evaluate_registration`` at 262,144. Normals and voxel tables are
    built once, outside the timed runs."""
    from fpcr_tpu_torch.ops.grid import (build_voxel_table, grid_nn,
                                         suggest_cell_size)
    from fpcr_tpu_torch.utils.timing import cuda_time_ms, slope_ms_per_iter

    card = f"[card: {smi}]"
    out = {}

    def slope(label, run, k_lo, k_hi, repeats):
        r = slope_ms_per_iter(run, k_lo=k_lo, k_hi=k_hi, repeats=repeats)
        log("times", f"{label}: {r['ms_per_iter']:.4f} ms/iter (slope of "
                     f"min-of-{repeats}, {k_lo} and {k_hi} iterations: "
                     f"{r['lo_ms']:.3f} / {r['hi_ms']:.3f} ms) {card}")
        out[label] = r["ms_per_iter"]

    def events(label, fn):
        t = cuda_time_ms(fn, repeats=5, warmup=1)
        log("times", f"{label}: min {t['min']:.3f} ms, mean {t['mean']:.3f} "
                     f"ms (events) {card}")
        out[label] = t["min"]

    def normals(s):
        return {"source_normals": ft.estimate_normals(s.source),
                "target_normals": ft.estimate_normals(s.target)}

    def cfg(k, **kw):
        return ft.ICPConfig(max_iterations=k, tolerance=0.0, **kw)

    s16 = build_scene(ft, "synthetic", dev)
    n16 = normals(s16)
    slope("GICP N=16384 (K1)", lambda k: ft.run_icp(
        s16.source, s16.target, cfg(k, metric="gicp", matcher="pallas"),
        **n16), 10, 60, 5)
    slope("AA-ICP point N=16384 (K1, 3 calls an iteration)",
          lambda k: ft.run_aa_icp(s16.source, s16.target,
                                  cfg(k, matcher="pallas")), 10, 60, 3)
    bunny = build_scene(ft, "bunny", dev)
    slope("SGD-ICP step, B=1024, Bunny-8171 (K1)", lambda k: ft.run_sgd_icp(
        bunny.source, bunny.target, cfg(k), batch_size=1024), 10, 60, 5)
    for i, w in enumerate(LARGE_WIDTHS):
        n = w * w
        s = build_scene(ft, f"grid-{i}", dev)
        cell = suggest_cell_size(s.target)
        events(f"build_voxel_table N={n}",
               lambda: build_voxel_table(s.target, cell))
        table = build_voxel_table(s.target, cell)
        events(f"grid_nn N={n}, cap 8 ({n * 27 * 8} candidate rows)",
               lambda: grid_nn(s.source, table))
        slope(f"grid ICP N={n}", lambda k: ft.run_icp(
            s.source, s.target, cfg(k, matcher="grid"),
            matcher_state=table), 5, 25, 3)
        if i == 0:
            events(f"evaluate_registration N={n} (K1, automatic gate)",
                   lambda: ft.evaluate_registration(s.source, s.target,
                                                    s.ground_truth))
            continue
        nrm = normals(s)
        slope(f"GICP N={n} (K3, c512/w64)", lambda k: ft.run_icp(
            s.source, s.target, cfg(k, metric="gicp", matcher="morton",
                                    **BAND), **nrm), 5, 25, 3)
        events(f"voxel_downsample N={n}, voxel {VOXEL['size']}",
               lambda: ft.voxel_downsample(s.source, VOXEL["size"]))
    return out


# The sharded paths (parallel/dist_icp.py), each driven at a world of one
# rank on NCCL and against its unsharded run: (name, scene kind, loop,
# config fields, kernel, GT threshold). A world-1 run must equal its
# unsharded run bit for bit and make the same launches; a world-2 run on
# one card (gloo) must come within PARALLEL_TOL of the single-card
# transform, within 1 iteration, and reach its threshold
PARALLEL_PATHS = [
    ("dist point synthetic-16384, K1", "synthetic", "icp",
     dict(max_iterations=40, matcher="pallas"), "nn_argmin", 1e-5),
    ("dist point hall-16384, K1", "hall", "icp",
     dict(max_iterations=100, matcher="pallas"), "nn_argmin", 1e-4),
    ("dist point synthetic-16384 packed6_idx, K2", "synthetic", "icp",
     dict(max_iterations=40, matcher="pallas", **PACKED),
     "nn_argmin_packed", 1e-5),
    ("dist point hall-16384 packed6_idx, K2", "hall", "icp",
     dict(max_iterations=100, matcher="pallas", **PACKED),
     "nn_argmin_packed", 1e-4),
    ("dist plane synthetic-16384, K1", "synthetic", "icp",
     dict(metric="plane", max_iterations=50, matcher="pallas"), "nn_argmin",
     1e-5),
    ("dist morton point synthetic-1048576, K3", "grid-1", "icp",
     dict(matcher="morton", max_iterations=30, **BAND), "morton_nn", 1e-5),
    ("dist ndt synthetic-1048576 banded, K4", "ndt-1024", "ndt",
     dict(voxel_size=NDT_VOXEL, max_iterations=50, lookup="banded",
          lookup_impl="pallas"), "ndt_fused_moments", 1e-4),
]
PARALLEL_TOL = 1e-5  # world 2 against the single card: transform entries
PARALLEL_WORLD = 2
# the CLI's run on Bunny: BASELINE.md's 1e-5
CLI_BUNNY_GT = 1e-5


def parallel_scene(torch, np, ft, kind, dev):
    if kind.startswith("ndt-"):
        return ndt_scene(torch, np, ft, int(kind[4:]), dev)
    return build_scene(ft, kind, dev)


def parallel_run(ft, loop, fields, sharded, mesh=None):
    """``run(source, target)`` of one sharded path or its unsharded twin."""
    from fpcr_tpu_torch.parallel.dist_icp import (distributed_icp,
                                                  distributed_ndt)

    if loop == "icp":
        cfg = ft.ICPConfig(**fields)
        if sharded:
            return lambda a, b: distributed_icp(a, b, cfg, mesh=mesh)
        return lambda a, b: ft.run_icp(a, b, cfg)
    cfg = ft.NDTConfig(**fields)
    if sharded:
        return lambda a, b: distributed_ndt(a, b, cfg, mesh=mesh)
    return lambda a, b: ft.run_ndt(a, b, cfg)


def _bits(res):
    """A result's tensors as integers, so NaN rows compare by their bits."""
    return [x.contiguous().view(torch.int32) if x.is_floating_point() else x
            for x in (res.transform.rotation, res.transform.translation,
                      res.errors, res.num_iterations, res.points)]


def _rows_spy():
    """Patch the kernels' wrappers where the package looks them up with
    spies that record the rows of each launch: ``{kernel: [rows, ...]}``."""
    from fpcr_tpu_torch.ops import matching, morton_cuda, ndt_cuda

    rows = {}

    class Spy:
        """Records the rows, calls the wrapper; its launch count is the
        wrapper's (a wrapper counts through its module's name for itself,
        which is now the spy)."""

        def __init__(self, real, key):
            self.real, self.key = real, key

        def __call__(self, p, *a, **k):
            rows.setdefault(self.key, []).append(int(p.shape[-2]))
            return self.real(p, *a, **k)

        @property
        def launches(self):
            return self.real.launches

        @launches.setter
        def launches(self, n):
            self.real.launches = n

    def spy(module, attr, key):
        setattr(module, attr, Spy(getattr(module, attr), key))

    spy(matching, "nn_argmin_cuda", "nn_argmin")
    spy(matching, "nn_argmin_packed_cuda", "nn_argmin_packed")
    spy(morton_cuda, "morton_nn_cuda", "morton_nn")
    spy(ndt_cuda, "ndt_fused_moments_cuda", "ndt_fused_moments")
    return rows


def _parallel_rank(rank, world, store, out_path):
    """One rank of the world-2 run on one card: a gloo group over CUDA
    tensors (the caller passes the mesh, which the package requires for
    gloo on CUDA tensors), every sharded path, the rows each kernel launch
    saw, and rank 0's ms/iter of the point path by the slope."""
    import torch.distributed as dist

    import fpcr_tpu_torch as ft
    from fpcr_tpu_torch.parallel.dist_icp import distributed_icp, make_mesh
    from fpcr_tpu_torch.utils.timing import slope_ms_per_iter

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    dev = torch.device("cuda", 0)
    mesh = make_mesh()
    wrappers = _wrappers()  # the counting wrappers, before the spies
    rows = _rows_spy()
    out = {}
    for name, kind, loop, fields, kernel, thr in PARALLEL_PATHS:
        s = parallel_scene(torch, np, ft, kind, dev)
        wrapper = wrappers[kernel]
        before, rows[kernel] = wrapper.launches, []
        res = parallel_run(ft, loop, fields, True, mesh)(s.source, s.target)
        torch.cuda.synchronize()
        out[name] = {
            "rotation": res.transform.rotation.cpu(),
            "translation": res.transform.translation.cpu(),
            "iterations": int(res.num_iterations),
            "gt": float(ft.transform_rmse(res.transform, s.ground_truth,
                                          s.source)),
            "launches": wrapper.launches - before,
            "rows": sorted(set(rows[kernel])), "n": s.source.shape[0],
            "points_ok": bool(torch.allclose(
                res.points, res.transform.apply(s.source), atol=1e-4))}
    # what each rank builds from the whole clouds, nothing broadcast: the
    # normals, the Morton table and the NDT grid, compared across ranks
    s = build_scene(ft, "synthetic", dev)
    big = build_scene(ft, "grid-1", dev)
    out["tables"] = {
        "target normals": ft.estimate_normals(s.target).cpu(),
        "morton table": ft.build_morton_table(big.target).points_sorted.cpu(),
        "ndt grid": ft.build_ndt_grid(big.target, NDT_VOXEL).table.cpu()}
    out["slope"] = slope_ms_per_iter(lambda k: distributed_icp(
        s.source, s.target, ft.ICPConfig(max_iterations=k, tolerance=0.0,
                                         matcher="pallas"), mesh=mesh),
        k_lo=5, k_hi=25, repeats=3)
    torch.save(out, f"{out_path}.{rank}")
    dist.barrier()
    dist.destroy_process_group()


NCCL_TWO_ON_ONE = """
import sys, torch, torch.distributed as dist
rank = int(sys.argv[1])
torch.cuda.set_device(0)
dist.init_process_group("nccl", init_method="file://" + sys.argv[2],
                        world_size=2, rank=rank)
try:
    x = torch.ones(1, device="cuda")
    dist.all_reduce(x)
    torch.cuda.synchronize()
    print("NCCL accepted two ranks on one device: sum", float(x))
except Exception as e:
    print("NCCL refused:", type(e).__name__, str(e).splitlines()[0][:300])
"""


def _start_side_runs(cmds):
    """``{label: argv}`` started at once as subprocesses from the repo's
    root, with it on ``PYTHONPATH``: ``{label: Popen}``."""
    import os
    from pathlib import Path

    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return {k: subprocess.Popen(c, cwd=root, env=env, text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE)
            for k, c in cmds.items()}


def _finish_side_runs(procs, timeout=240):
    """Wait for the side runs (killing any that outlive ``timeout``) and
    return ``{label: (returncode, stdout, stderr)}``."""
    out = {}
    t_end = time.perf_counter() + timeout
    for label, p in procs.items():
        try:
            so, se = p.communicate(timeout=max(1.0, t_end
                                               - time.perf_counter()))
        except subprocess.TimeoutExpired:
            p.kill()
            so, se = p.communicate()
            so += f"\n(killed after {timeout} s)"
        out[label] = (p.returncode, so, se)
    return out


def sharded_graphs(torch, np, ft, dev, card):
    """The world-1 NCCL loops as CUDA graphs, their all-reduces captured:
    each of ``sharded_graph_paths`` bit for bit its eager run with equal
    launches (all-reduces included, ``_psum``'s count), to its ground
    truth; 24 iterations of ``distributed_icp`` waiting for the card only
    at the done reads after 8 and 16 (and its mesh's set-up); its ms/iter
    captured against eager, six times in turns."""
    import dataclasses as dc
    import functools

    from fpcr_tpu_torch.parallel.dist_icp import distributed_icp
    from fpcr_tpu_torch.utils import graphs
    from fpcr_tpu_torch.utils.timing import slope_ms_per_iter

    t0 = time.perf_counter()
    records = check_captured(torch, ft, sharded_graph_paths(
        torch, np, ft, dev), card)
    pools = sorted(r["pool_bytes"] for r in records)
    log("graphs", f"sharded: {len(records)} captures, pools "
                  f"{pools[0] / 2**20:.1f}-{pools[-1] / 2**20:.1f} MiB {card}")
    s = build_scene(ft, "synthetic", dev)
    cfg = ft.ICPConfig(max_iterations=24, tolerance=0.0, matcher="pallas")
    run = functools.partial(distributed_icp, s.source, s.target, cfg)
    run()
    run()
    for mode in ("captured", "eager"):
        with graphs.eager(mode == "eager"):
            _check_sync_sites("distributed_icp point K1 (NCCL world 1)",
                              mode, sync_sites(torch, run), 2, card)
    _turns(torch, "distributed_icp point K1 16384 (NCCL world 1)",
           "ms/iter (slope of 10/60, min of 3)",
           lambda: slope_ms_per_iter(lambda n: distributed_icp(
               s.source, s.target, dc.replace(cfg, max_iterations=n)),
               10, 60, repeats=3)["ms_per_iter"], card)
    log("graphs", f"sharded graphs done in {time.perf_counter() - t0:.1f} s")


def phase_parallel(torch, ft, dev, smi):
    """The sharded paths on the card. A world of one rank on NCCL, in this
    process (a ``file://`` store in a temporary directory): each path
    against its unsharded run, bit for bit, with the same launches; the
    collectives an iteration; ms/iter of ``distributed_icp`` against
    ``run_icp`` by the slope (their difference is the all-reduces' cost).
    Then a world of two ranks on this one card over gloo (NCCL refuses two
    ranks on one device, which is confirmed and logged): every path within
    ``PARALLEL_TOL`` of the single card, each rank launching its kernels on
    half of the rows, every rank's transform bit-equal. And the CLI as a
    user starts it: ``info``, ``run --dataset bunny`` to its GT threshold
    and ``match-bench`` at 16,384. Returns the world-1 launches, summed
    over the paths."""
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from fpcr_tpu_torch.core import metrics
    from fpcr_tpu_torch.parallel.dist_icp import distributed_icp
    from fpcr_tpu_torch.utils.timing import slope_ms_per_iter

    card = f"[card: {smi}]"
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="fpcr_parallel_")
    # NCCL's answer to two ranks on one card, beside the world-1 paths
    nccl_procs = _start_side_runs({f"nccl rank {r}": [
        sys.executable, "-c", NCCL_TWO_ON_ONE, str(r), f"{tmp}/nccl_store"]
        for r in range(2)})
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store1",
                            world_size=1, rank=0)
    totals = dict.fromkeys(counters(), 0)
    single = {}
    try:
        for name, kind, loop, fields, kernel, thr in PARALLEL_PATHS:
            s = parallel_scene(torch, np, ft, kind, dev)
            # K2 launches its sweep and its epilogue every iteration
            per_iteration = 2 if kernel == "nn_argmin_packed" else 1
            got = {}
            for sharded in (True, False):
                label = name if sharded else f"{name} (unsharded)"

                def fn():
                    got[sharded] = register(
                        torch, ft, label, s,
                        parallel_run(ft, loop, fields, sharded), thr, kernel,
                        per_iteration=per_iteration)
                reads = metrics._psum.launches
                counts = drive(torch, label, fn)
                reads = metrics._psum.launches - reads
                if counts[kernel] == 0:
                    raise AssertionError(f"'{label}' never launched {kernel}")
                got[(sharded, "counts")] = counts
                if sharded:
                    # the loop runs masked passes up to its next done read
                    passes = loop_passes(int(got[True].num_iterations),
                                         fields["max_iterations"])
                    log("parallel", f"{name}: {reads} all-reduces in "
                                    f"{passes} loop passes, "
                                    f"{reads / passes:.2f} an iteration "
                                    "(NCCL, world of 1)")
                    for k, v in counts.items():
                        totals[k] += v
            if got[(True, "counts")] != got[(False, "counts")]:
                raise AssertionError(f"{name}: launches "
                                     f"{got[(True, 'counts')]} against "
                                     f"{got[(False, 'counts')]}")
            for field, a, b in zip(("rotation", "translation", "errors",
                                    "iterations", "points"),
                                   _bits(got[True]), _bits(got[False])):
                if not torch.equal(a, b):
                    raise AssertionError(f"{name}: world 1's {field} differ "
                                         "from the unsharded run's")
            log("parallel", f"{name}: world 1 equals the unsharded run bit "
                            "for bit, same launches")
            single[name] = got[False]
        # the timings below have the card to themselves
        nccl = _finish_side_runs(nccl_procs)
        sharded_graphs(torch, np, ft, dev, card)
        # one all-reduce of 8 floats alone: host time a call, and the time
        # to the device's completion
        x = torch.ones(8, device=dev)
        for _ in range(20):
            metrics._psum(x, dist.group.WORLD)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            metrics._psum(x, dist.group.WORLD)
        host = (time.perf_counter() - t0) * 2.0  # ms a call, 500 calls
        torch.cuda.synchronize()
        done = (time.perf_counter() - t0) * 2.0
        log("times", f"one all-reduce of 8 floats (NCCL, world of 1, the "
                     f"clone included): {host:.4f} ms of host time a call, "
                     f"{done:.4f} ms to the device's completion {card}")
        # the all-reduces' cost: world-1 distributed_icp against run_icp in
        # this call, legs run, dist, dist, run
        s = build_scene(ft, "synthetic", dev)

        def cfg(k):
            return ft.ICPConfig(max_iterations=k, tolerance=0.0,
                                matcher="pallas")
        legs = {}
        for label, fn in (("run_icp", ft.run_icp),
                          ("distributed_icp world 1", distributed_icp),
                          ("distributed_icp world 1 again", distributed_icp),
                          ("run_icp again", ft.run_icp)):
            r = slope_ms_per_iter(lambda k: fn(s.source, s.target, cfg(k)),
                                  k_lo=10, k_hi=60, repeats=5)
            legs[label] = r["ms_per_iter"]
            log("times", f"point ICP N=16384 (K1), {label}: "
                         f"{r['ms_per_iter']:.4f} ms/iter (slope of min-of-5"
                         f", 10 and 60 iterations: {r['lo_ms']:.3f} / "
                         f"{r['hi_ms']:.3f} ms) {card}")
    finally:
        for p in nccl_procs.values():  # stopped, where a phase failed
            if p.poll() is None:
                p.kill()
                p.wait()
        dist.destroy_process_group()
    cost = (legs["distributed_icp world 1"] - legs["run_icp"],
            legs["distributed_icp world 1 again"] - legs["run_icp again"])
    log("times", "all-reduces' cost at world 1, point ICP N=16384: "
                 f"{cost[0]:.4f} / {cost[1]:.4f} ms/iter {card}")

    for r in range(2):
        rc, so, se = nccl[f"nccl rank {r}"]
        last = (so.strip() or se.strip() or "(no output)").splitlines()[-1]
        log("parallel", f"NCCL, two ranks on one card, rank {r}: exit {rc}: "
                        f"{last}")

    mp.spawn(_parallel_rank, args=(PARALLEL_WORLD, f"{tmp}/store2",
                                   f"{tmp}/world2"),
             nprocs=PARALLEL_WORLD, join=True)
    ranks = [torch.load(f"{tmp}/world2.{r}", weights_only=False)
             for r in range(PARALLEL_WORLD)]
    for name, kind, loop, fields, kernel, thr in PARALLEL_PATHS:
        ref = single[name]
        for r, rec in enumerate(ranks):
            got = rec[name]
            dr = float((got["rotation"] - ref.transform.rotation.cpu())
                       .abs().max())
            dt = float((got["translation"]
                        - ref.transform.translation.cpu()).abs().max())
            di = abs(got["iterations"] - int(ref.num_iterations))
            half = got["n"] // PARALLEL_WORLD
            log("parallel", f"{name}, world 2 (gloo, one card), rank {r}: "
                            f"{got['iterations']} iterations (single card "
                            f"{int(ref.num_iterations)}), |dR| {dr:.2e}, "
                            f"|dt| {dt:.2e}, GT {got['gt']:.3e} (< {thr:g}),"
                            f" {kernel} launches {got['launches']} on "
                            f"{got['rows']} rows")
            if max(dr, dt) > PARALLEL_TOL or di > 1 or not got["gt"] < thr:
                raise AssertionError(f"{name}: world 2 rank {r} off the "
                                     "single-card run")
            if got["rows"] != [half] or not got["points_ok"]:
                raise AssertionError(f"{name}: rank {r} launched on rows "
                                     f"{got['rows']}, not its half {half}")
            if not (torch.equal(got["rotation"], ranks[0][name]["rotation"])
                    and torch.equal(got["translation"],
                                    ranks[0][name]["translation"])):
                raise AssertionError(f"{name}: ranks disagree")
    for key, ref in ranks[0]["tables"].items():
        for r, rec in enumerate(ranks[1:], 1):
            if not torch.equal(rec["tables"][key].view(torch.int32),
                               ref.view(torch.int32)):
                raise AssertionError(f"rank {r}'s {key} differs from rank 0's")
    log("parallel", "world 2: each rank's normals, Morton table and NDT grid"
                    " (built from the whole clouds, nothing broadcast) are "
                    "bit-equal to rank 0's")
    sl = ranks[0]["slope"]
    log("times", f"point ICP N=16384 (K1), world 2 on one card over gloo "
                 f"(the record only): {sl['ms_per_iter']:.4f} ms/iter (slope"
                 f" of min-of-3, 5 and 25 iterations: {sl['lo_ms']:.3f} / "
                 f"{sl['hi_ms']:.3f} ms) {card}")

    # the CLI as a user starts it: info and a run together, then the
    # microbenchmark alone on the card
    cli = [sys.executable, "-m", "fpcr_tpu_torch"]
    side = _finish_side_runs(_start_side_runs({
        "cli info": cli + ["info"],
        "cli run bunny": cli + ["run", "--dataset", "bunny", "--json"]}))
    side.update(_finish_side_runs(_start_side_runs({
        "cli match-bench": cli + ["match-bench", "--n", "16384",
                                  "--repeats", "3"]})))
    for label in ("cli info", "cli run bunny", "cli match-bench"):
        rc, so, se = side[label]
        log("cli", f"python -m fpcr_tpu_torch {label[4:]}: exit {rc}; "
                   + " | ".join(so.strip().splitlines()[:6]))
        if rc != 0:
            raise AssertionError(f"{label} failed: {se[-2000:]}")
    info = side["cli info"][1]
    if "platform: gpu" not in info or "device count:" not in info:
        raise AssertionError("cli info did not report the card")
    bunny = json.loads(side["cli run bunny"][1])
    log("cli", f"run bunny: {bunny['iterations']} iterations, GT transform "
               f"RMSE {bunny['transform_rmse_vs_gt']:.3e} (< "
               f"{CLI_BUNNY_GT:g}), platform {bunny['platform']}, wall "
               f"{bunny['wall_seconds']:.3f} s {card}")
    if not (bunny["platform"] == "gpu"
            and bunny["transform_rmse_vs_gt"] < CLI_BUNNY_GT):
        raise AssertionError("cli run bunny missed its threshold")
    bench = json.loads(side["cli match-bench"][1])
    log("cli", f"match-bench N={bench['n']}: "
               + ", ".join(f"{k} {v:.4f} ms" for k, v in bench.items()
                           if k != "n") + f" (events) {card}")
    log("parallel", f"phase done in {time.perf_counter() - t_phase:.1f} s")
    return totals


# ---- phase 8: the examples, the guards, the fuzz and the scripts --------

# (module, arguments, success line of the JAX example) — full sizes, on the
# card (no --cpu); the pipeline at 1,048,576 points (K1 coarse, K3 fine)
EXAMPLES = [
    ("basic_registration", [], "transform RMSE vs GT"),
    ("lidar_plane_icp", [], "transform RMSE vs GT"),
    ("global_registration", [], "global + ICP refine"),
    ("large_scale_pipeline", ["--width", "1024"], "transform RMSE vs GT"),
    ("ndt_map_tracking", [], "all scans tracked"),
    ("odometry_slam", [], "fused map"),
]
# the kernels each example must launch on the card (the NDT map's 4,096
# points stay under lookup_threshold: the gather, no kernel)
EXAMPLE_KERNELS = {"basic_registration": ("nn_argmin",),
                   "lidar_plane_icp": ("nn_argmin",),
                   "global_registration": ("nn_argmin",),
                   "large_scale_pipeline": ("nn_argmin", "morton_nn"),
                   "ndt_map_tracking": (),
                   "odometry_slam": ("nn_argmin",)}
# the examples' GT thresholds (tests/test_torch_examples.py) and the JAX
# package's CPU runs of the full-size examples, which
# tests/test_torch_examples_jax.py recomputes through fpcr_tpu (the card
# has no JAX): basic 28 iterations
# (1.257e-6), LiDAR 4 (1.760e-7), NDT tracking 9, 11, 8, 10, 9 (pose RMSE
# 8.97e-5 to 9.01e-5), SLAM's eleven pairs below (the port's CPU run stops
# pair 5 at 7 where JAX stops at 12, final error 7.401e-3 against 7.431e-3:
# the noise plateau of SLAM_FINAL_RTOL)
EXAMPLE_GT = {"basic_registration": 1e-5, "lidar_plane_icp": 1e-4,
              "global_registration": 1e-3, "large_scale_pipeline": 1e-5,
              "ndt_map_tracking": 5e-3}
EXAMPLE_JAX = {"basic_registration": 28, "lidar_plane_icp": 4,
               "ndt_map_tracking": (9, 11, 8, 10, 9)}
SLAM_EXAMPLE_JAX = dict(
    iterations=(25, 25, 25, 25, 10, 12, 12, 21, 15, 25, 25),
    final=(2.805766e-2, 3.223349e-2, 2.895771e-2, 2.614549e-2, 2.589706e-2,
           7.431255e-3, 2.495046e-2, 2.486851e-2, 2.831730e-2, 2.915010e-2,
           2.688668e-2))
# a child process: run one example's main on the card and print what it
# returned and every launch count of the run
EXAMPLE_CHILD = """
import importlib, json, sys
import chip_smoke
mod = importlib.import_module("fpcr_tpu_torch.examples." + sys.argv[1])
out = mod.main(sys.argv[2:])
print("EXAMPLE_RESULT " + json.dumps({"out": out,
                                      "launches": chip_smoke.counters()}))
"""
FUZZ_SEEDS = (0, 1, 2, 3)


def _add(totals, counts):
    for key, n in counts.items():
        totals[key] = totals.get(key, 0) + n


def start_examples():
    """Start the six examples at once, each a process on the card:
    ``(start time, {name: Popen})``."""
    return time.perf_counter(), _start_side_runs(
        {name: [sys.executable, "-c", EXAMPLE_CHILD, name, *args]
         for name, args, _ in EXAMPLES})


def finish_examples(started, smi):
    """Hold each example to rc 0, its success line, its GT threshold, the
    JAX package's iterations and its kernels; return the launches, summed
    over the six."""
    t0, procs = started
    runs = _finish_side_runs(procs, timeout=600)
    totals = {}
    for name, _, needle in EXAMPLES:
        rc, so, se = runs[name]
        if rc != 0 or needle not in so or "device: cuda" not in so:
            raise AssertionError(f"example {name}: exit {rc}, stdout "
                                 f"{so[-2000:]}\nstderr {se[-4000:]}")
        rec = json.loads(so.split("EXAMPLE_RESULT ", 1)[1].splitlines()[0])
        out, counts = rec["out"], rec["launches"]
        _add(totals, counts)
        missing = [k for k in EXAMPLE_KERNELS[name] if not counts.get(k)]
        if missing:
            raise AssertionError(f"example {name} launched no {missing}")
        if name == "ndt_map_tracking":
            err, its = max(out["pose_errors"]), tuple(out["iterations"])
            if any(abs(a - b) > 1
                   for a, b in zip(its, EXAMPLE_JAX[name])):
                raise AssertionError(f"{name}: iterations {its}, JAX "
                                     f"{EXAMPLE_JAX[name]}")
        elif name == "odometry_slam":
            err = out["closed_loop_error"]
            for k, (it, fin) in enumerate(zip(out["iterations"],
                                              out["final_errors"])):
                ref_it = SLAM_EXAMPLE_JAX["iterations"][k]
                ref_fin = SLAM_EXAMPLE_JAX["final"][k]
                if (abs(it - ref_it) > 1 and abs(fin - ref_fin) / ref_fin
                        >= SLAM_FINAL_RTOL):
                    raise AssertionError(f"{name} pair {k}: {it} iterations,"
                                         f" final {fin} (JAX {ref_it}, "
                                         f"{ref_fin})")
            if not (out["closures"] and err <= out["open_loop_drift"]
                    and out["map_voxels"] > 0):
                raise AssertionError(f"{name}: the loop did not close: {out}")
        else:
            err = out["gt_error"]
            if name in EXAMPLE_JAX and abs(out["iterations"]
                                           - EXAMPLE_JAX[name]) > 1:
                raise AssertionError(f"{name}: {out['iterations']} "
                                     f"iterations, JAX {EXAMPLE_JAX[name]}")
        thr = EXAMPLE_GT.get(name)
        if thr is not None and not err < thr:
            raise AssertionError(f"{name}: error {err} >= {thr}")
        log("examples", f"fpcr_tpu_torch.examples.{name}: exit 0, "
                        f"'{needle}', {json.dumps(out)}, launches "
                        f"{ {k: v for k, v in counts.items() if v} } "
                        f"[card: {smi}]")
    log("examples", f"phase done in {time.perf_counter() - t0:.1f} s (the "
                    "six at once, beside the guards and the fuzz)")
    return totals


def phase_guards(torch, dev, smi):
    """Checks 7, 9 and 10 of ``scripts/tpu_smoke.py`` on the card
    (``fpcr_tpu_torch/bench/guards.py``), each driven between counter
    reads; check 10 must resolve to K4 at a window above 256, hold K4's
    counts to the gather oracle's there and register the wide-plane cloud
    to GT < 1e-2 with a matched fraction above 0.85."""
    from fpcr_tpu_torch.bench import guards

    t0 = time.perf_counter()
    totals = {}
    for name, check in guards.CHECKS.items():
        got = {}
        counts = drive(torch, name, lambda: got.update(check(dev)))
        _add(totals, counts)
        log("guards", f"{name}: {json.dumps(got)} [card: {smi}]")
        if name.startswith("check 10") and not (
                got["lookup_impl"] == "pallas" and got["count_parity"]
                and counts["ndt_fused_moments"] > 0):
            raise AssertionError(f"{name} did not run through K4: {got}")
        if name.startswith("check 7") and not (counts["morton_nn"]
                                               and counts["nn_argmin"]):
            raise AssertionError(f"{name} launched neither K3 nor K1")
    log("guards", f"phase done in {time.perf_counter() - t0:.1f} s")
    return totals


def phase_fuzz(torch, dev, smi):
    """The fuzz (``fpcr_tpu_torch/bench/fuzz_configs.py``) at seeds 0–3 on
    the card: 80 trials a seed, 0 failures."""
    from fpcr_tpu_torch.bench.fuzz_configs import fuzz

    t0 = time.perf_counter()
    totals = {}
    for seed in FUZZ_SEEDS:
        failures = []
        _add(totals, drive(torch, f"fuzz seed {seed}",
                           lambda: failures.extend(fuzz(seed, dev))))
        if failures:
            raise AssertionError(f"fuzz seed {seed}: {failures}")
    for key in ("nn_argmin", "morton_nn", "ndt_fused_moments"):
        if not totals.get(key):
            raise AssertionError(f"the fuzz never launched {key}")
    log("fuzz", f"seeds {list(FUZZ_SEEDS)}: 0 failures in "
                f"{80 * len(FUZZ_SEEDS)} trials, launches "
                f"{ {k: v for k, v in totals.items() if v} } [card: {smi}]")
    log("fuzz", f"phase done in {time.perf_counter() - t0:.1f} s")
    return totals


# the synthetic scene's contract (BASELINE.md), for the headline's three
# slopes' last runs (60 iterations from the scene's start, K1 and K2 point,
# K1 plane)
HEADLINE_GT = 1e-5
HEADLINE_TRACE_ITERS = 60


def _profiled_trace(torch, run, k):
    """One run of ``run`` (``k`` iterations) under ``torch.profiler``:
    device events and host launch calls (of a kernel or of a captured
    graph) an iteration, the host time in
    those calls, the device span, busy time (the union of the events) and
    idle share, and the gaps between device events; None if the profiler
    saw no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.events()
    dev_iv = sorted((e.time_range.start, e.time_range.end)
                    for e in events if e.device_type == DeviceType.CUDA)
    if not dev_iv:
        return None
    calls = [e.time_range.elapsed_us() for e in events
             if e.device_type == DeviceType.CPU
             and e.name.startswith(("cudaLaunch", "cuLaunch",
                                    "cudaGraphLaunch"))]
    busy, gaps, end = 0.0, [], dev_iv[0][0]
    for a, b in dev_iv:
        if a > end:
            gaps.append(a - end)
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    span = end - dev_iv[0][0]
    gaps = sorted(gaps) or [0.0]
    return {"device_events_per_iter": len(dev_iv) / k,
            "launch_calls_per_iter": len(calls) / k,
            "launch_call_ms_per_iter": sum(calls) / 1e3 / k,
            "span_ms_per_iter": span / 1e3 / k,
            "busy_ms_per_iter": busy / 1e3 / k,
            "idle": 1 - busy / span, "gaps": len(gaps),
            "gap_median_us": gaps[len(gaps) // 2],
            "gap_p90_us": gaps[int(0.9 * len(gaps))],
            "gap_max_us": gaps[-1],
            "gaps_over_100us_ms_per_iter": sum(
                g for g in gaps if g > 100) / 1e3 / k}


def headline_trace(torch, dev, card):
    """Why the headline's ms/iter moves between calls. The host's time for
    one launch of a one-element kernel (2,000 launches, synchronised at the
    end, min of 3) and its load average; the headline CLI twice, each in a
    fresh process that has run no profiler; then in this process, for
    point and plane ICP through K1 at 16,384, the slope three times over,
    one traced run of ``HEADLINE_TRACE_ITERS`` iterations under
    ``torch.profiler`` (``_profiled_trace``), and the slope three times
    over after it."""
    import os

    import fpcr_tpu_torch as ft
    from fpcr_tpu_torch.bench import headline

    x = torch.zeros(1, device=dev)
    launch_us = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(2000):
            x.add_(1)
        torch.cuda.synchronize()
        launch_us.append((time.perf_counter() - t) / 2000 * 1e6)
    log("scripts", f"headline trace: {os.cpu_count()} host cores, load "
                   f"average {os.getloadavg()}; one launch of a one-element "
                   f"kernel {min(launch_us):.2f} us of host time (min of 3 "
                   f"x 2,000; all {launch_us}) {card}")
    for rep in range(2):
        runs = _finish_side_runs(_start_side_runs({"headline": [
            sys.executable, "-m", "fpcr_tpu_torch.bench.headline"]}))
        rc, so, se = runs["headline"]
        if rc != 0:
            raise AssertionError(f"headline CLI: exit {rc}\n{se[-4000:]}")
        record = json.loads(so.strip().splitlines()[-1])
        more = json.loads(se.strip().splitlines()[-1])
        log("scripts", f"headline trace: CLI in a fresh process ({rep + 1} "
                       f"of 2): point K1 {record['value']}, point K2 "
                       f"{more['point_k2']['ms_per_iter']}, plane K1 "
                       f"{more['plane_k1']['ms_per_iter']} ms/iter; legs "
                       f"(lo, hi ms) K1 {more['point_k1']['lo_ms']}, "
                       f"{more['point_k1']['hi_ms']}, plane "
                       f"{more['plane_k1']['lo_ms']}, "
                       f"{more['plane_k1']['hi_ms']}; load average "
                       f"{os.getloadavg()} {card}")
    scene = ft.synthetic_scene(width=128, device=dev)
    k = HEADLINE_TRACE_ITERS
    for label, fields in (("point via K1", {"matcher": "xla"}),
                          ("plane via K1", {"metric": "plane",
                                            "matcher": "xla"})):
        cfg = ft.ICPConfig(max_iterations=k, tolerance=0.0, **fields)

        def run():
            return ft.run_icp(scene.source, scene.target, cfg)

        def slopes():
            return [headline.slope(scene, 10, 60, 5, dev, **fields)
                    for _ in range(3)]

        before = slopes()
        run()
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
        traced = _profiled_trace(torch, run, k)
        after = slopes()

        def legs(ds):
            return [(d["ms_per_iter"], d["lo_ms"], d["hi_ms"]) for d in ds]

        log("scripts", f"headline trace {label}, 16,384, in this process: "
                       "slopes (10/60, min of 5; ms/iter, lo ms, hi ms) "
                       f"before the trace {legs(before)}, after it "
                       f"{legs(after)}; untraced wall of one {k}-iteration "
                       f"run {wall_ms / k:.4f} ms/iter; traced {k} "
                       f"iterations: "
                       f"{json.dumps(traced)}; load average "
                       f"{os.getloadavg()} {card}")


def phase_scripts(torch, dev, smi):
    """The port's scripts on the card, each result on a line beside the
    card's name and power limit: the headline at 16,384 (full size),
    ``bench_large``'s Morton rows at 262,144 and 1,048,576 (c512/w64) and
    its grid row at 262,144, ``bench_ndt`` at 262,144 (gather, the plain
    band, K4) and ``sharded_large`` at 1,048,576 on one NCCL rank."""
    import tempfile

    import torch.distributed as dist

    from fpcr_tpu_torch.bench import (bench_large, bench_ndt, headline,
                                      sharded_large)

    t0 = time.perf_counter()
    totals = {}
    card = f"[card: {smi}]"
    head, details = {}, {}

    def run_headline():
        record, more = headline.measure(128, 10, 60, 5, dev)
        head.update(record)
        details.update(more)

    _add(totals, drive(torch, "headline", run_headline))
    log("scripts", f"headline: {json.dumps(head)} {card}")
    log("scripts", f"headline details: {json.dumps(details)} {card}")
    if not (head["metric"] == "icp_point_to_point_ms_per_iter_n16384"
            and head["value"] > 0):
        raise AssertionError(f"headline: {head}")
    for key in ("point_k1", "point_k2", "plane_k1"):
        if not (details[key]["ms_per_iter"] > 0
                and details[key]["gt_rmse"] < HEADLINE_GT):
            raise AssertionError(f"headline {key}: {details[key]}")
    headline_trace(torch, dev, card)
    rows = [r for r in bench_large.select("all", [262144, 1048576])
            if r.window == 64 or r.matcher == "grid"]
    for row in rows:
        got = {}
        _add(totals, drive(torch, f"bench_large {row.matcher} {row.n}",
                           lambda: got.update(bench_large.bench_row(row,
                                                                    dev))))
        log("scripts", f"bench_large: {json.dumps(got)} {card}")
        if not (got["gt_rmse"] < 1e-4 and got["ms_per_iter"] > 0):
            raise AssertionError(f"bench_large {row}: {got}")
    ndt = []  # the three strategies start from the same first error
    for lookup, impl in bench_ndt.STRATEGIES:
        got = {}
        _add(totals, drive(torch, f"bench_ndt {lookup} {impl}",
                           lambda: got.update(bench_ndt.bench(
                               262144, lookup, impl, dev))))
        log("scripts", f"bench_ndt: {json.dumps(got)} {card}")
        ndt.append(got)
        if not (got["ms_per_iter"] > 0 and got["gt_rmse"] < 1e-4
                and abs(got["err0"] - ndt[0]["err0"])
                <= 1e-5 * ndt[0]["err0"]):
            raise AssertionError(f"bench_ndt {lookup} {impl}: {got} (the "
                                 f"gather's first error {ndt[0]['err0']})")
    tmp = tempfile.mkdtemp(prefix="fpcr_sharded_")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                            world_size=1, rank=0)
    try:
        got = {}
        _add(totals, drive(torch, "sharded_large 1,048,576 (NCCL, world 1)",
                           lambda: got.update(sharded_large.run(
                               dev, 1_048_576, 3))))
    finally:
        dist.destroy_process_group()
    log("scripts", f"sharded_large: {json.dumps(got)} {card}")
    for key in ("nn_argmin", "nn_argmin_packed", "morton_nn",
                "ndt_fused_moments"):
        if not totals.get(key):
            raise AssertionError(f"the scripts never launched {key}")
    log("scripts", f"phase done in {time.perf_counter() - t0:.1f} s")
    return totals


# ---- phase_graphs: the loops as captured CUDA graphs, and kernel svd3 ----

# svd3's batches on the main path: run_icp, register_batch, RANSAC
SVD3_BATCHES = (1, 32, 1024)
# svd3 against its plain version on the same W, where R is unique (σ2 − σ3
# > SVD3_GAP·σ1): within SVD3_ATOL of the plain version in float64 (the
# kernel's float64 R rounded to float32 is half an ulp, 6e-8, from it), and
# of the plain version in float32, whose own R is off by about float32's
# epsilon times σ1 over the gap, within SVD3_F32_REL·σ1/gap (8 epsilons;
# tests/test_torch_svd3.py holds JAX's float32 R alike)
SVD3_GAP, SVD3_ATOL, SVD3_F32_REL = 1e-3, 1e-6, 1e-6
# svd3 against its CPU mirror (ops/svd3_mirror.py) on the same W where R is
# unique: one float32 ulp at 1. Both converge to the same float64 R, which
# each rounds to float32; the card's FMAs and its rsqrtf move only its last
# bits
SVD3_MIRROR_ATOL = 2.0 ** -23
# float32 operations that one 3x3 Kabsch rotation needs: Golub and Van
# Loan's count of an SVD with U and V (the R-SVD's 4m²n + 8mn² + 9n³ at
# m = n = 3, 567), R = U·Vᵀ (27 products, 18 sums) and the det fix (a 3x3
# determinant, 17, and a column's sign, 3). The kernel's own work (8 sweeps
# in float64) is its design's, not the function's
SVD3_FLOPS = 632
# the same for Umeyama's form: the SVD (567), R = U·diag(1, 1, d)·Vᵀ (45),
# d from det U and det Vᵀ (two 3x3 determinants, 34, their product and the
# column's sign, 4) and the trace σ1 + σ2 + d·σ3 (3)
SVD3_UMEYAMA_FLOPS = 653
GRAPH_REPEATS = 6  # slopes of each path, captured and eager in turns
GRAPH_TRACE_ITERS = 24


def svd3_inputs(np, batch, seed=0):
    """``[batch, 3, 3]`` float32: half N(0, 1) matrices, a quarter the
    cross-covariances of noisy rigid pairs of anisotropic clouds (the
    solve's own W), a quarter N(0, 1) scaled by 10^U(-6, 6)."""
    rng = np.random.default_rng(seed + batch)
    w = rng.normal(size=(batch, 3, 3))
    k = batch // 4
    for i in range(k):
        p = rng.normal(size=(64, 3)) * [1.0, 0.6, 0.3]
        q_, r_ = np.linalg.qr(rng.normal(size=(3, 3)))
        q = p @ (q_ * np.sign(np.diag(r_))).T + rng.normal(0, 1e-3, (64, 3))
        dp, dq = p - p.mean(0), q - q.mean(0)
        w[i] = dq.T @ dp
    w[k:2 * k] *= 10.0 ** rng.uniform(-6, 6, (k, 1, 1))
    return w.astype(np.float32)


def svd3_edges(np):
    """W = 0, rank 1 (a line), rank 2 (a plane), a reflection, NaN, inf."""
    rng = np.random.default_rng(7)
    u = rng.normal(size=3)
    line = np.outer(u, rng.normal(size=3))
    p = rng.normal(size=(50, 3)) * [1.0, 0.5, 0.0]
    plane = p.T @ p
    refl = np.diag([3.0, 2.0, -0.5])
    nan = rng.normal(size=(3, 3))
    nan[1, 2] = np.nan
    inf = rng.normal(size=(3, 3))
    inf[0, 0] = np.inf
    return np.stack([np.zeros((3, 3)), line, plane, refl, nan,
                     inf]).astype(np.float32)


def svd3_check_batch(torch, np, b, det, got, p32, p64, W, label):
    """The checks of an R from svd3 (either form) at one batch against its
    plain version in float32 and float64, where R is unique; returns
    ``(sep, max |R - plain f32| where unique)``."""
    s = torch.linalg.svdvals(W.double())
    gap = s[:, 1] - s[:, 2]
    if not det:  # u3's sign follows W·v3: σ3 must be apart from 0
        gap = torch.minimum(gap, s[:, 2])
    sep = gap > SVD3_GAP * s[:, 0]
    e64 = float((got.double() - p64)[sep].abs().max())
    d32 = (got - p32).abs().amax(dim=(1, 2))[sep]
    e32 = float(d32.max())
    r32 = float((d32 * gap[sep] / s[sep, 0]).max())
    eye = torch.eye(3, device=W.device, dtype=torch.float64)
    g64 = got.double()
    ortho = float((g64.transpose(1, 2) @ g64 - eye).abs().max())
    dets = torch.linalg.det(g64)
    log("graphs", f"{label} B={b} det_correction={det}: {int(sep.sum())}"
                  f" of {b} with R unique; max |R - plain f64| "
                  f"{e64:.3e} (< {SVD3_ATOL:g}), max |R - plain f32| "
                  f"{e32:.3e}, times gap/σ1 {r32:.3e} (< "
                  f"{SVD3_F32_REL:g}), |RᵀR - I| "
                  f"{ortho:.3e}, det in [{float(dets.min()):.7f}, "
                  f"{float(dets.max()):.7f}]")
    if not (e64 < SVD3_ATOL and r32 < SVD3_F32_REL and ortho < SVD3_ATOL):
        raise AssertionError(f"{label} B={b}: off its plain version")
    if det and float((dets - 1).abs().max()) > SVD3_ATOL:
        raise AssertionError(f"{label} B={b}: det R is not +1")
    return sep, e32


def svd3_against_mirror(np, W, got, sep, det):
    """svd3 against its CPU mirror (``ops/svd3_mirror.py``) on the same W,
    where R is unique: the largest difference, which must stay within
    SVD3_MIRROR_ATOL (one float32 ulp at 1); and the mirror's sweeps as a
    histogram ``{"f32/f64": matrices}``."""
    from fpcr_tpu_torch.ops.svd3_mirror import (svd3_rotation_mirror,
                                                svd3_sweeps)

    w = W.cpu().numpy()
    mine = svd3_rotation_mirror(w, det)
    err = float(np.abs(got.cpu().numpy() - mine)[sep.cpu().numpy()].max())
    hist = {}
    for sw in svd3_sweeps(w):
        key = f"{sw.f32}/{sw.f64}"
        hist[key] = hist.get(key, 0) + 1
    return err, dict(sorted(hist.items()))


def time_legs(phase, label, new, old, card, repeats=10):
    """(call, kernel) ms of each leg: yardstick, new, new, yardstick,
    yardstick, new. The kernel time is the profiler's alone: a leg whose
    sessions saw no device event is retaken twice, then kept as None."""
    from fpcr_tpu_torch.utils.timing import cuda_time_ms

    rec = {"yardstick": [], "new": [], "retaken": 0}
    for leg in ("yardstick", "new", "new", "yardstick", "yardstick", "new"):
        fn = new if leg == "new" else old
        call = cuda_time_ms(fn, repeats=20, warmup=3)["min"]
        kern = kernel_ms(fn, repeats=repeats, fallback=False)
        for _ in range(2):
            if kern is not None:
                break
            rec["retaken"] += 1
            kern = kernel_ms(fn, repeats=repeats, fallback=False)
        rec[leg].append((call, kern))
        log(phase, f"leg {label} {leg}: call {call:.4f} ms, kernel {kern} "
                   f"ms {card}")
    return rec


def svd3_times(torch, label, W, new, old, plain, nbytes, flops, card):
    """One form of svd3 on the batch ``W``: ``new()`` against the
    yardstick ``old()`` in legs, the plain version's and
    ``torch.linalg.svd``'s call times, and the bound; the batch's fields
    of the kernels line."""
    from fpcr_tpu_torch.utils.timing import cuda_time_ms

    b = W.shape[0]
    rec = time_legs("graphs", f"{label} B={b}", new, old, card, repeats=20)
    legs = leg_fields(rec)
    plain_ms = cuda_time_ms(plain, repeats=10)["min"]
    library = cuda_time_ms(lambda: torch.linalg.svd(W), repeats=10)["min"]
    bound_ms, bound_by = bound(nbytes * b, flops * b)
    # a side whose every leg saw no profiler event: its kernel time by
    # CUDA events, the wrapper's glue included (logged by kernel_ms)
    ms = (legs["kernel_ms"] if legs["kernel_ms"] is not None
          else kernel_ms(new, repeats=20))
    out = dict(plain_ms=plain_ms, library_ms=library, bound_ms=bound_ms,
               bound_by=bound_by, **legs, ms=ms)
    ratio = (None if legs["yardstick_kernel_ms"] is None
             else round(ms / legs["yardstick_kernel_ms"], 3))
    log("graphs", f"{label} B={b}: three legs a side (least call, median "
                  f"kernel) ms {json.dumps(legs)} ({rec['retaken']} legs "
                  f"retaken); the new kernel {ratio}x "
                  f"the yardstick's; plain version {plain_ms:.4f} ms, "
                  f"torch.linalg.svd {library:.4f} ms (min of 10, events),"
                  f" bound {bound_ms:.7f} ms ({bound_by}: {nbytes * b} "
                  f"bytes, {flops * b} float32 operations) {card}")
    return out


def phase_svd3(torch, np, dev, card):
    """svd3 against its plain version (``rotation_from_svd_plain`` in float32
    and float64) on the main path's batches and the edge cases, against
    its yardstick (the first design) and its CPU mirror; its kernel time
    in legs against the yardstick's, the parts of its design alone, the
    plain version's, ``torch.linalg.svd``'s and its bound at each batch;
    returns the kernels line's fields, the batches' in ``batches``."""
    from fpcr_tpu_torch.ops.solve import rotation_from_svd_plain
    from fpcr_tpu_torch.ops.svd3_cuda import (ABLATIONS, _svd3_ablation,
                                              _svd3_rotation_fixed,
                                              svd3_rotation_cuda)
    from fpcr_tpu_torch.utils.timing import cuda_time_ms

    worst, batches = 0.0, {}
    for det in (True, False):
        for b in SVD3_BATCHES:
            W = torch.as_tensor(svd3_inputs(np, b), device=dev)
            got = svd3_rotation_cuda(W, det)
            p32 = rotation_from_svd_plain(W, det)
            p64 = rotation_from_svd_plain(W.double(), det)
            sep, e32 = svd3_check_batch(torch, np, b, det, got, p32, p64, W,
                                        "svd3")
            fixed = _svd3_rotation_fixed(W, det)
            svd3_check_batch(torch, np, b, det, fixed, p32, p64, W,
                             "svd3 yardstick")
            e_fixed = float((got - fixed)[sep].abs().max())
            e_mirror, hist = svd3_against_mirror(np, W, got, sep, det)
            log("graphs", f"svd3 B={b} det_correction={det}: max |R - "
                          f"yardstick's R| {e_fixed:.3e}, max |R - CPU "
                          f"mirror's R| {e_mirror:.3e} (< "
                          f"{SVD3_MIRROR_ATOL:.3e}) where R is unique; the "
                          f"mirror's sweeps (float32/float64 that rotated: "
                          f"matrices) {json.dumps(hist)}")
            if not (e_fixed < SVD3_ATOL and e_mirror <= SVD3_MIRROR_ATOL):
                raise AssertionError(f"svd3 B={b}: off its yardstick or its "
                                     "mirror")
            worst = max(worst, e32)
    edges = svd3_rotation_cuda(torch.as_tensor(svd3_edges(np), device=dev))
    e = edges.double()
    log("graphs", f"svd3 edges: W = 0 -> {edges[0].tolist()}; det of the "
                  f"line's, the plane's, the reflection's R "
                  f"{torch.linalg.det(e[1:4]).tolist()}; NaN W -> all NaN "
                  f"{bool(edges[4].isnan().all())}, inf W -> all NaN "
                  f"{bool(edges[5].isnan().all())}")
    if not (torch.equal(edges[0], torch.eye(3, device=dev))
            and float((torch.linalg.det(e[1:4]) - 1).abs().max()) < SVD3_ATOL
            and bool(edges[4:].isnan().all())):
        raise AssertionError("svd3: an edge case breaks the conventions")
    # an empty kernel (one element's add): its device time, the floor of
    # any one launch, and its call time, measured as svd3's are
    x = torch.zeros(1, device=dev)
    empty = device_events(lambda: [x.add_(1) for _ in range(20)])
    latency = sum(e.time_range.elapsed_us() for e in empty) / len(empty) / 1e3
    empty_call = cuda_time_ms(lambda: x.add_(1), repeats=20)["min"]
    for b in SVD3_BATCHES:
        W = torch.as_tensor(svd3_inputs(np, b), device=dev)
        batches[b] = svd3_times(
            torch, "svd3", W, lambda: svd3_rotation_cuda(W),
            lambda: _svd3_rotation_fixed(W),
            lambda: rotation_from_svd_plain(W), 72, SVD3_FLOPS, card)
        # the parts of the design alone, each the median of three
        ablation = {part: sorted(kernel_ms(lambda: _svd3_ablation(W, part),
                                           repeats=20)
                                 for _ in range(3))[1] for part in ABLATIONS}
        batches[b].update(latency_ms=latency, empty_call_ms=empty_call,
                          ablation=ablation)
        log("graphs", f"svd3 B={b}: the new design's parts alone, kernel "
                      f"ms (profiler, median of 3): {json.dumps(ablation)};"
                      f" an empty kernel {latency:.4f} ms on the device "
                      f"(mean of {len(empty)} events), its call "
                      f"{empty_call:.4f} ms {card}")
    return dict(batches[1], max_abs_err=worst, batches=batches)


def phase_svd3_umeyama(torch, np, dev, card):
    """svd3's Umeyama form against its plain version
    (``umeyama_from_svd_plain``, ``torch.linalg.svd`` and the sign and scale
    glue, in float64 and float32) on the rotation form's batches and edge
    cases: R where it is unique as the rotation form's R is held, R bit for
    bit the rotation form's with the det fix, and the trace σ1 + σ2 + d·σ3
    within SVD3_ATOL·σ1 of the float64 plain version everywhere (where σ3
    is 0 d·σ3 is rounding noise whatever d), and of the yardstick's; then
    the kernel's time in legs against the yardstick's, the plain
    version's and ``torch.linalg.svd``'s at each batch. Returns the
    kernels line's fields."""
    from fpcr_tpu_torch.ops.solve import umeyama_from_svd_plain
    from fpcr_tpu_torch.ops.svd3_cuda import (_svd3_umeyama_fixed,
                                              svd3_rotation_cuda,
                                              svd3_umeyama_cuda)

    worst, trace_rel, batches = 0.0, 0.0, {}
    for b in SVD3_BATCHES:
        W = torch.as_tensor(svd3_inputs(np, b), device=dev)
        R, trace = svd3_umeyama_cuda(W)
        R64, t64 = umeyama_from_svd_plain(W.double())
        R32, t32 = umeyama_from_svd_plain(W)
        s = torch.linalg.svdvals(W.double())
        gap = s[:, 1] - s[:, 2]
        sep = gap > SVD3_GAP * s[:, 0]
        e64 = float((R.double() - R64)[sep].abs().max())
        d32 = (R - R32).abs().amax(dim=(1, 2))[sep]
        r32 = float((d32 * gap[sep] / s[sep, 0]).max())
        et = float(((trace.double() - t64).abs() / s[:, 0]).max())
        et32 = float(((trace - t32).double().abs() / s[:, 0]).max())
        same = torch.equal(R, svd3_rotation_cuda(W, True))
        flips = int((t64 < s[:, 0] + s[:, 1] - 0.5 * s[:, 2]).sum())
        Rf, tf = _svd3_umeyama_fixed(W)
        ef = float((R - Rf)[sep].abs().max())
        etf = float(((trace - tf).double().abs() / s[:, 0]).max())
        log("graphs", f"svd3 Umeyama B={b}: {int(sep.sum())} of {b} with R "
                      f"unique; max |R - plain f64| {e64:.3e} (< "
                      f"{SVD3_ATOL:g}), |R - plain f32| times gap/σ1 "
                      f"{r32:.3e} (< {SVD3_F32_REL:g}); R the rotation "
                      f"form's with the det fix bit for bit {same}; max "
                      f"|trace - plain f64| / σ1 {et:.3e} (< "
                      f"{SVD3_ATOL:g}), against plain f32 {et32:.3e}; "
                      f"{flips} with d = -1; against the yardstick: max "
                      f"|R - R'| {ef:.3e} where unique, |trace - trace'| / "
                      f"σ1 {etf:.3e}")
        if not (e64 < SVD3_ATOL and r32 < SVD3_F32_REL and et < SVD3_ATOL
                and same and ef < SVD3_ATOL and etf < SVD3_ATOL):
            raise AssertionError(f"svd3 Umeyama B={b}: off its plain version"
                                 " or its yardstick")
        worst = max(worst, float((R - R32)[sep].abs().max()))
        trace_rel = max(trace_rel, et32)
    W = torch.as_tensor(svd3_edges(np), device=dev)
    R, trace = svd3_umeyama_cuda(W)
    _, t64 = umeyama_from_svd_plain(W[:4].double())
    s1 = torch.linalg.svdvals(W[:4].double())[:, 0]
    et = ((trace[:4].double() - t64).abs() / torch.clamp(s1, min=1e-30))
    log("graphs", f"svd3 Umeyama edges: W = 0 -> R {R[0].tolist()}, trace "
                  f"{float(trace[0])}; det of the line's, the plane's, the "
                  f"reflection's R {torch.linalg.det(R[1:4].double()).tolist()}"
                  f"; their |trace - plain f64| / σ1 {et[1:].tolist()}; NaN "
                  f"and inf W -> all NaN {bool(R[4:].isnan().all())}, "
                  f"{bool(trace[4:].isnan().all())}")
    if not (torch.equal(R[0], torch.eye(3, device=dev))
            and float(trace[0]) == 0.0
            and float((torch.linalg.det(R[1:4].double()) - 1).abs().max())
            < SVD3_ATOL and float(et[1:].max()) < SVD3_ATOL
            and bool(R[4:].isnan().all()) and bool(trace[4:].isnan().all())):
        raise AssertionError("svd3 Umeyama: an edge case breaks the "
                             "conventions")
    for b in SVD3_BATCHES:
        W = torch.as_tensor(svd3_inputs(np, b), device=dev)
        batches[b] = svd3_times(
            torch, "svd3 Umeyama", W, lambda: svd3_umeyama_cuda(W),
            lambda: _svd3_umeyama_fixed(W),
            lambda: umeyama_from_svd_plain(W), 76, SVD3_UMEYAMA_FLOPS, card)
    return dict(batches[1], max_abs_err=worst, trace_rel_err=trace_rel,
                batches=batches)


# kernel eig3 (csrc/svd3.cu, ops/eig3_cuda.py): the normals' eigensolver
# on the covariances of the hall scan's 16,384 points, the main path's
# batch, each point's 4 nearest other points as the prepass picks them.
# Eigenvalues within EIG3_VAL_ULPS float32 epsilons of λ2 of float64's, and
# the smallest eigenvector within EIG3_VEC_ULPS·2⁻²³·λ2 / (λ1 − λ0) rad of
# float64's (or 1e-6 rad), for the kernel and its plain version alike
EIG3_VAL_ULPS, EIG3_VEC_ULPS = 8, 8
EIG3_BYTES = 36 + 48  # a matrix read, its eigenvalues and vectors written
EIG3_FLOPS = 3 * 65  # one Jacobi sweep (benchmark/metrics/eig3_roofline.py)


def eig3_covariances(torch, ft, dev):
    """The hall scan's normals covariances ``[16384, 3, 3]`` on the card,
    from the prepass's own search and re-rank."""
    from fpcr_tpu_torch.ops import normals as tn

    q = build_scene(ft, "hall", dev).target
    idx, d = tn.self_knn(q, 5 + tn.RERANK)
    return tn._neighbour_covariance(q, tn.rerank(q, idx, d, 5)[:, 1:])


def eig3_held(torch, A, vals, vecs, label):
    """The worst ratio of ``(vals, vecs)``'s error to eig3's bounds against
    float64 ``eigh`` of the same float32 ``A``, and the rows where A ≈ qI;
    raises where a row is off its bound or an isotropic row off the fixed
    frame."""
    from fpcr_tpu_torch.ops.eigh3 import ISO_FRAME, ISO_TOL

    a64 = A.double()
    w, v = torch.linalg.eigh(a64)
    eps = 2.0 ** -23
    top = w.abs().amax(-1)
    q = a64.diagonal(dim1=-2, dim2=-1).sum(-1) / 3.0
    dev_ = a64 - q[:, None, None] * torch.eye(3, dtype=a64.dtype,
                                               device=A.device)
    iso = ((dev_ * dev_).sum((-2, -1))
           <= ISO_TOL ** 2 * (a64 * a64).sum((-2, -1)))
    frame = torch.tensor(ISO_FRAME, dtype=A.dtype, device=A.device)
    if not torch.equal(vecs[iso], frame.expand(int(iso.sum()), 3, 3)):
        raise AssertionError(f"{label}: an isotropic row is off the frame")
    val_r = ((vals.double() - w).abs().amax(-1)
             / (EIG3_VAL_ULPS * eps * top).clamp_min(1e-300))
    sin = torch.linalg.cross(vecs[..., :, 0].double(), v[..., :, 0]).norm(
        dim=-1)
    bound = (EIG3_VEC_ULPS * eps * w[:, 2]
             / (w[:, 1] - w[:, 0]).clamp_min(1e-300)).clamp_min(1e-6)
    vec_r = sin / bound
    worst = (float(val_r[~iso].max()), float(vec_r[~iso].max()))
    if not (worst[0] <= 1.0 and worst[1] <= 1.0):
        raise AssertionError(f"{label}: off float64 eigh by {worst} of its "
                             "bounds (eigenvalues, smallest eigenvector)")
    return worst, int(iso.sum())


def phase_eig3(torch, np, ft, dev, card):
    """Kernel eig3 on the hall scan's 16,384 normals covariances: against
    float64 ``eigh`` and its plain version (``eig3_plain``) under eig3's
    bounds, the isotropic rows (the rangeless returns' zero covariances) on
    the fixed frame, one launch a call and no host read; its kernel time
    (profiler events), call time, the plain version's and the closed
    form's (``eigvals3`` and ``_unit_eigenvector``, the prepass's first
    design) and its bound; returns the kernels line's fields."""
    from fpcr_tpu_torch.ops.eig3_cuda import eig3_cuda
    from fpcr_tpu_torch.ops.eigh3 import (_unit_eigenvector, eig3_plain,
                                          eigvals3)
    from fpcr_tpu_torch.utils.timing import cuda_time_ms

    A = eig3_covariances(torch, ft, dev).contiguous()
    b = A.shape[0]
    before = eig3_cuda.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        vals, vecs = eig3_cuda(A)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if eig3_cuda.launches - before != 1:
        raise AssertionError("eig3: not one launch a call")
    worst, iso = eig3_held(torch, A, vals, vecs, "eig3")
    p_vals, p_vecs = eig3_plain(A)
    plain_worst, _ = eig3_held(torch, A, p_vals, p_vecs, "eig3 plain")
    err = float((vals - p_vals).abs().max())

    def closed():
        return _unit_eigenvector(A, eigvals3(A)[..., 0], 1e-20)

    events = [e for e in device_events(
        lambda: [eig3_cuda(A) for _ in range(20)])
        if "eig3_kernel" in e.name]
    if not events:
        raise AssertionError("eig3: the profiler saw no eig3_kernel event")
    ms = sum(e.time_range.elapsed_us() for e in events) / len(events) / 1e3
    call_ms = cuda_time_ms(lambda: eig3_cuda(A), repeats=20)["min"]
    plain_ms = cuda_time_ms(lambda: eig3_plain(A), repeats=10)["min"]
    closed_ms = cuda_time_ms(closed, repeats=10)["min"]
    bound_ms, bound_by = bound(EIG3_BYTES * b, EIG3_FLOPS * b)
    log("graphs", f"eig3 B={b} (hall covariances): worst error / bound "
                  f"(eigenvalues, smallest eigenvector) {worst[0]:.3e}, "
                  f"{worst[1]:.3e}; the plain version's {plain_worst[0]:.3e},"
                  f" {plain_worst[1]:.3e}; {iso} rows A ≈ qI on the fixed "
                  f"frame; max |λ - plain λ| {err:.3e}; kernel {ms:.5f} ms "
                  f"({len(events)} events), call {call_ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, closed form {closed_ms:.4f} ms, bound "
                  f"{bound_ms:.7f} ms ({bound_by}) {card}")
    return {"max_abs_err": err, "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "closed_form_ms": closed_ms,
            "worst_over_bound": worst, "plain_worst_over_bound": plain_worst,
            "isotropic_rows": iso, "batch": b}


def svd3_slopes(torch, ft, dev, card):
    """Captured point ICP through K1 at 16,384 points, ms/iter by the slope
    (10/60 iterations, min of 3), with run_icp's svd3 the yardstick or the
    new kernel, in legs (yardstick, new, new, yardstick, yardstick, new);
    the captured graphs are dropped at each switch, since a graph replays
    the kernel it captured. Returns ``{side: [ms]}``."""
    import dataclasses as dc

    from fpcr_tpu_torch.ops import svd3_cuda
    from fpcr_tpu_torch.utils import graphs
    from fpcr_tpu_torch.utils.timing import slope_ms_per_iter

    s = build_scene(ft, "synthetic", dev)
    base = ft.ICPConfig(tolerance=0.0, matcher="pallas")

    def run(n):
        return ft.run_icp(s.source, s.target,
                          dc.replace(base, max_iterations=n))

    new = svd3_cuda.svd3_rotation_cuda
    out = {"yardstick": [], "new": []}
    try:
        for leg in ("yardstick", "new", "new", "yardstick", "yardstick",
                    "new"):
            svd3_cuda.svd3_rotation_cuda = (
                new if leg == "new" else svd3_cuda._svd3_rotation_fixed)
            graphs.clear()
            out[leg].append(slope_ms_per_iter(run, 10, 60,
                                              repeats=3)["ms_per_iter"])
    finally:
        svd3_cuda.svd3_rotation_cuda = new
        graphs.clear()
    summary = []
    for side, v in out.items():
        med = sorted(v)[len(v) // 2]
        summary.append(f"{side} median {med:.4f} spread "
                       f"{(max(v) - min(v)) / med:.3f} all "
                       f"{[round(x, 4) for x in v]}")
    log("graphs", "captured point K1 16384 ms/iter (slope of 10/60, min of "
                  "3), svd3 by its yardstick or the new kernel: "
                  + "; ".join(summary) + f" {card}")
    return out


def _result_bits(res):
    """Every tensor of a result (an ICPResult, NDTResult, ICPHistory,
    ScaledICPResult, PoseGraphResult, GlobalRegResult or a tuple of
    tensors), floats as integers."""
    out = []
    for x in res:
        for t in (tuple(x) if not isinstance(x, torch.Tensor) else (x,)):
            t = t.contiguous()
            out.append(t.view(torch.int32) if t.dtype == torch.float32
                       else t)
    return out


def _bits_equal(a, b):
    return all(torch.equal(x, y)
               for x, y in zip(_result_bits(a), _result_bits(b)))


def graph_paths(torch, np, ft, dev):
    """``[(label, run, scene, threshold)]``: the paths of the captured
    loops, each ``run()`` one registration (captured, or eager under
    ``graphs.eager()``); ``scene`` None for the batch, whose ``run``
    checks its own ground truths."""
    import functools

    out = []
    for name, kind, iters, thr in SCENES:
        s = build_scene(ft, kind, dev)
        for label, mode in (("point K1", {}), ("point K2", PACKED)):
            cfg = ft.ICPConfig(max_iterations=iters, matcher="pallas", **mode)
            out.append((f"{label} {name}", functools.partial(
                ft.run_icp, s.source, s.target, cfg), s, thr))
    for name, kind, iters, thr in PLANE_SCENES:
        s = build_scene(ft, kind, dev)
        cfg = ft.ICPConfig(metric="plane", max_iterations=iters,
                           matcher="pallas")
        out.append((f"plane K1 {name[6:]}", functools.partial(
            ft.run_icp, s.source, s.target, cfg), s, thr))
    for scenes, mode, label in ((MORTON_SCENES[:2], {}, "K3"),
                                (PACKED_MORTON_SCENES, PACKED, "K3p")):
        for name, kind, metric, iters, thr in scenes:
            s = build_scene(ft, kind, dev)
            cfg = ft.ICPConfig(metric=metric, matcher="morton",
                               max_iterations=iters, **BAND, **mode)
            out.append((f"morton {label} {name.split()[-1]}",
                        functools.partial(ft.run_icp, s.source, s.target,
                                          cfg), s, thr))
    for name, width, thr, _ in NDT_SCENES:
        s = ndt_scene(torch, np, ft, width, dev)
        grid = ft.build_ndt_grid(s.target, NDT_VOXEL)
        cfg = ft.resolve_ndt_config(
            ft.NDTConfig(voxel_size=NDT_VOXEL, max_iterations=50), grid,
            s.source)
        out.append((f"NDT K4 {name.split()[-1]}", functools.partial(
            ft.run_ndt, s.source, s.target, cfg, grid=grid), s, thr))
    srcs, tgts, gts = serving_batch(ft, dev)
    for label, mode in (("K1", {}), ("K2", PACKED)):
        cfg = ft.ICPConfig(max_iterations=SERVING["iterations"],
                           matcher="pallas", **mode)
        out.append((f"register_batch {label} 32x4096", functools.partial(
            ft.register_batch, srcs, tgts, cfg), (srcs, gts),
            SERVING["threshold"]))
    return out


def _gt_error(ft, res, scene):
    if callable(scene):  # a path's own check: ``scene(result) -> error``
        return scene(res)
    if not hasattr(scene, "ground_truth"):  # the batch: the worst element
        srcs, gts = scene
        return max(float(ft.transform_rmse(ft.RigidTransform(
            res.transform.rotation[k], res.transform.translation[k]), g,
            srcs[k])) for k, g in enumerate(gts))
    return float(ft.transform_rmse(res.transform, scene.ground_truth,
                                   scene.source))


def _nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def _counted_run(torch, run):
    torch.cuda.synchronize()
    before = counters()
    res = run()
    torch.cuda.synchronize()
    after = counters()
    return res, _nonzero({k: after[k] - before[k] for k in after})


def check_captured(torch, ft, paths, card):
    """Each path eager, then three calls of the loops' own choosing: the
    key's first call (eager, nothing captured, so that a one-shot call
    costs what the eager loop does), the call that captures and the call
    that replays: bit for bit the eager run, the captured result unchanged
    by the replay, the launches of each call the eager run's, and the
    ground truth's threshold. The wall time of each call is logged beside
    the eager run's; returns the captures' records."""
    from fpcr_tpu_torch.utils import graphs

    graphs.clear()  # the main path's calls have seen some of these keys
    records = []
    for label, run, scene, thr in paths:
        with graphs.eager():
            t = time.perf_counter()
            ref, n_ref = _counted_run(torch, run)
            eager_s = time.perf_counter() - t
        calls = []
        for _ in range(3):
            since = len(graphs.CACHE.captures)
            t = time.perf_counter()
            res, n = _counted_run(torch, run)
            calls.append((res, n, time.perf_counter() - t,
                          graphs.CACHE.captures[since:]))
        (first, n_first, first_s, caps0), (second, n_second, second_s,
                                           caps), (third, n_third,
                                                   third_s, caps2) = calls
        same = all(_bits_equal(ref, c[0]) for c in calls)
        gt = _gt_error(ft, second, scene)
        its = getattr(second, "num_iterations", None)
        log("graphs", f"{label}: captured == eager bit for bit {same}, "
                      f"iterations {'-' if its is None else int(its.max())}, "
                      f"GT {gt:.3e} (< {thr:g}), launches eager {n_ref}, "
                      f"first / capturing / replaying call {n_first} / "
                      f"{n_second} / {n_third}; wall s eager {eager_s:.4f}, "
                      f"first call {first_s:.4f} ({len(caps0)} captures), "
                      f"capturing call {second_s:.4f}, replaying call "
                      f"{third_s:.4f}; {len(caps)} captures "
                      + ", ".join(f"{c['fn']} {c['capture_s']:.3f} s "
                                  f"{c['pool_bytes'] / 2**20:.1f} MiB"
                                  for c in caps) + f" {card}")
        if not same:
            raise AssertionError(f"{label}: the captured loop differs from "
                                 "the eager one")
        if caps0 or caps2:
            raise AssertionError(f"{label}: a first or replaying call "
                                 "captured")
        if not n_ref == n_first == n_second == n_third:
            raise AssertionError(f"{label}: launches differ, eager {n_ref}, "
                                 f"captured {n_first} / {n_second} / "
                                 f"{n_third}")
        if not gt < thr:
            raise AssertionError(f"{label}: GT transform RMSE {gt} >= {thr}")
        records += [dict(c, path=label) for c in caps]
    return records


def sync_sites(torch, run):
    """``{source line: syncs}`` of one ``run()`` under
    ``torch.cuda.set_sync_debug_mode('warn')``."""
    import linecache
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = {}
    for w in caught:
        line = linecache.getline(w.filename, w.lineno).strip()
        if "synchroniz" not in str(w.message) or "sync_debug_mode" in line:
            # the mode's own notices, and a sync that the first switch of
            # the mode in a process reports as its own (outside the run)
            continue
        key = f"{w.filename.split('fpcr_tpu_torch/')[-1]}:{w.lineno} {line}"
        sites[key] = sites.get(key, 0) + 1
    return sites


# the set-up lines that read the host before a loop starts, which a
# sync check accepts: the pose graph's segment plans (their sizes), and
# ``run_ndt``'s read of its grid's voxel size
SETUP_SYNCS = ("unique_consecutive", "lengths.max()",
               "float(grid.voxel_size)")


def _check_sync_sites(label, mode, sites, reads, card):
    """The host waited only at ``reads`` done reads (``bool(st.``) and at
    set-up lines (``SETUP_SYNCS``)."""
    got = sum(v for key, v in sites.items() if "bool(st." in key)
    other = {key: v for key, v in sites.items() if "bool(st." not in key
             and not any(k in key for k in SETUP_SYNCS)}
    log("graphs", f"syncs of 24 {mode} iterations, {label}: "
                  f"{sites or 'none'} {card}")
    if got != reads or other:
        raise AssertionError(f"{label} ({mode}): the host waited for the "
                             f"card at {sites}")


def _turns(torch, label, unit, measure, card):
    """``measure()`` (ms) ``GRAPH_REPEATS`` times each way, captured and
    eager in turns (captured first in even repeats), logged with each
    way's median and spread; returns ``{mode: [ms]}``."""
    from fpcr_tpu_torch.utils import graphs

    legs = {"captured": [], "eager": []}
    for rep in range(GRAPH_REPEATS):
        order = ("captured", "eager") if rep % 2 == 0 else ("eager",
                                                            "captured")
        for mode in order:
            with graphs.eager(mode == "eager"):
                legs[mode].append(measure())
    summary = []
    for mode, v in legs.items():
        med = sorted(v)[len(v) // 2]
        summary.append(f"{mode} median {med:.4f} spread "
                       f"{(max(v) - min(v)) / med:.3f} all "
                       f"{[round(x, 4) for x in v]}")
    log("graphs", f"{label} {unit}: " + "; ".join(summary) + f" {card}")
    return legs


def check_syncs(torch, np, ft, dev, card):
    """24 iterations of each path (stop test off), eager and captured
    (after a call that captured), normals and tables prebuilt: the host
    waits for the card only where it reads the done flag, after 8 and 16
    iterations (and ``run_ndt`` once before its loop, reading the grid's
    voxel size)."""
    import functools

    from fpcr_tpu_torch.models.icp import build_matcher_state
    from fpcr_tpu_torch.utils import graphs

    s = build_scene(ft, "synthetic", dev)
    nrm = ft.estimate_normals(s.target)
    big = build_scene(ft, "grid-0", dev)
    ns = ndt_scene(torch, np, ft, LARGE_WIDTHS[0], dev)
    grid = ft.build_ndt_grid(ns.target, NDT_VOXEL)
    ncfg = ft.resolve_ndt_config(ft.NDTConfig(
        voxel_size=NDT_VOXEL, max_iterations=24, tolerance=0.0), grid,
        ns.source)
    srcs, tgts, _ = serving_batch(ft, dev)
    k = dict(max_iterations=24, tolerance=0.0)
    mcfg = ft.ICPConfig(matcher="morton", **BAND, **k)
    icp = ft.run_icp
    runs = {
        "point K1": functools.partial(icp, s.source, s.target, ft.ICPConfig(
            matcher="pallas", **k)),
        "point K2": functools.partial(icp, s.source, s.target, ft.ICPConfig(
            matcher="pallas", **PACKED, **k)),
        "plane K1": functools.partial(icp, s.source, s.target, ft.ICPConfig(
            metric="plane", matcher="pallas", **k), target_normals=nrm),
        "morton K3 262144": functools.partial(
            icp, big.source, big.target, mcfg,
            matcher_state=build_matcher_state(big.target, None, mcfg)),
        "NDT K4 262144": functools.partial(ft.run_ndt, ns.source, ns.target,
                                           ncfg, grid=grid),
        "register_batch K1": functools.partial(
            ft.register_batch, srcs, tgts, ft.ICPConfig(matcher="pallas",
                                                        **k)),
        "register_batch K2": functools.partial(
            ft.register_batch, srcs, tgts, ft.ICPConfig(
                matcher="pallas", **PACKED, **k))}
    for label, run in runs.items():
        run()  # the key's first call, eager
        run()  # captures
        for mode in ("captured", "eager"):
            with graphs.eager(mode == "eager"):
                _check_sync_sites(label, mode, sync_sites(torch, run), 2,
                                  card)


def graph_slopes(torch, np, ft, dev, card):
    """ms/iter by the slope, captured against eager, ``GRAPH_REPEATS``
    times each in turns (captured first in even repeats), and
    ``register_batch``'s ms a batch; returns ``{path: {mode: [ms]}}``."""
    import dataclasses as dc

    from fpcr_tpu_torch.utils.timing import cuda_time_ms, slope_ms_per_iter

    def icp_run(s, normals=None, **fields):
        base = ft.ICPConfig(tolerance=0.0, **fields)
        return lambda n: ft.run_icp(s.source, s.target, dc.replace(
            base, max_iterations=n), target_normals=normals)

    s = build_scene(ft, "synthetic", dev)
    # the plane loop alone: its normals prepass, eager, would add its host
    # time's noise to both legs
    nrm = ft.estimate_normals(s.target)
    cases = [("point K1 16384", icp_run(s, matcher="pallas"), 10, 60),
             ("point K2 16384", icp_run(s, matcher="pallas", **PACKED), 10,
              60),
             ("plane K1 16384", icp_run(s, nrm, metric="plane",
                                        matcher="pallas"), 10, 60)]
    for w in LARGE_WIDTHS:
        g = build_scene(ft, f"grid-{LARGE_WIDTHS.index(w)}", dev)
        cases.append((f"morton K3 {w * w}", icp_run(g, matcher="morton",
                                                    **BAND), 5, 25))
    for w in LARGE_WIDTHS:
        ns = ndt_scene(torch, np, ft, w, dev)
        grid = ft.build_ndt_grid(ns.target, NDT_VOXEL)
        cfg = ft.resolve_ndt_config(ft.NDTConfig(voxel_size=NDT_VOXEL),
                                    grid, ns.source)
        cases.append((f"NDT K4 {w * w}", lambda n, ns=ns, grid=grid, cfg=cfg:
                      ft.run_ndt(ns.source, ns.target, dc.replace(
                          cfg, max_iterations=n, tolerance=0.0), grid=grid),
                      5, 25))
    srcs, tgts, _ = serving_batch(ft, dev)
    bcfg = ft.ICPConfig(max_iterations=SERVING["iterations"], tolerance=0.0,
                        matcher="pallas")
    out = {}
    for label, run, lo, hi in cases:
        out[label] = _turns(torch, label, f"ms/iter (slope of {lo}/{hi}, "
                            "min of 3)", lambda: slope_ms_per_iter(
                                run, lo, hi, repeats=3)["ms_per_iter"], card)
    label = "register_batch K1 32x4096"
    out[label] = _turns(torch, label, "ms a batch (20 iterations, min of 3)",
                        lambda: cuda_time_ms(lambda: ft.register_batch(
                            srcs, tgts, bcfg), repeats=3, warmup=1)["min"],
                        card)
    return out


def scaled_volume(ft, dev):
    """Scaled ICP's volume: 16,384 uniform points and their image under a
    similarity of scale ``SCALED["scale"]``."""
    src = ft.data.synthetic.random_cloud(16384, seed=11, scale=2.0,
                                         device=dev)
    gt = ft.gt_transform((0.01, -0.02, 0.015), (0.01, -0.008, 0.012),
                         device=dev)
    return src, SCALED["scale"] * gt.apply(src)


def slam_graph(torch, ft, dev, timed=lambda name, fn: fn()):
    """The SLAM example's stages before its pose graph, each through
    ``timed(name, fn)``: ``(frames, ground-truth poses, odometry, closures
    (ei, ej, Z), the closures' informations, the odometry's weight)``."""
    frames, gt = slam_inputs(ft, dev)
    cfg = ft.ICPConfig(max_iterations=SLAM["iterations"], auto_trim=9.0)
    odo = timed("register_sequence", lambda: ft.register_sequence(frames,
                                                                  cfg))
    ei, ej, Z, _ = timed("detect_loop_closures",
                         lambda: ft.detect_loop_closures(frames, odo,
                                                         **SLAM["detect"]))

    def infos_fn():
        out = []
        for k, (i, j) in enumerate(zip(ei.tolist(), ej.tolist())):
            tf_k = ft.RigidTransform(Z[k, :3, :3], Z[k, :3, 3])
            cov = ft.registration_covariance(frames[j], frames[i], tf_k,
                                             ft.ICPConfig(auto_trim=9.0))
            out.append(ft.information_from_covariance(cov, tf_k))
        return torch.stack(out)

    infos = timed("covariance + information", infos_fn)
    lam = float(torch.diagonal(infos[0]).sum() / 6.0)
    return frames, gt, odo, (ei, ej, Z), infos, lam / 20.0


def ransac_inputs(torch, ft, dev):
    """``global_registration``'s RANSAC inputs on Bunny under the 1.2-rad
    pose (4,086 x 8,171 after the strides, 1,024 hypotheses of 3, seed 0):
    ``(src_sel, q_corr, good, samples, tau)``."""
    from fpcr_tpu_torch.models import global_reg as gr

    src = ft.load_bunny(device=dev)
    tgt = ft.gt_transform(*GLOBAL["bunny_pose"], device=dev).apply(src)
    return gr._ransac_inputs(src, tgt, 0, 8, 16, 1024, 3, 4096, None, True)


# global registration on Bunny: the RANSAC estimate before ICP, the 1.2-rad
# pose recovered to within a spacing (3 refine rounds over its inliers)
GLOBAL_RANSAC = 1e-2


def variant_paths(torch, np, ft, dev):
    """``[(label, run, scene, threshold)]``: the loops captured beside
    ``run_icp``, NDT and the batch, at this script's sizes: AA-ICP point
    and plane through K1 (synthetic 16,384, 60 iterations), scaled ICP
    through K1 and K2 (the 16,384-point volume), SGD-ICP (Bunny, B =
    1,024, 200 steps), history through K1 and K2 on the four scenes and
    through K3 at 1,048,576, the SLAM example's pose graph (unit weights,
    and ``close_loops`` with the closures' informations), and
    ``global_registration`` on Bunny. ``scene`` is a scene with a ground
    truth or ``check(result) -> error``."""
    import functools

    out = []
    s = build_scene(ft, "synthetic", dev)
    for metric, thr, _, _ in AA_RUNS:
        cfg = ft.ICPConfig(metric=metric, max_iterations=60,
                           matcher="pallas")
        out.append((f"AA-ICP {metric} K1 synthetic-16384", functools.partial(
            ft.run_aa_icp, s.source, s.target, cfg), s, thr))
    vs, vt = scaled_volume(ft, dev)
    for label, mode in (("K1", {}), ("K2", PACKED)):
        cfg = ft.ICPConfig(max_iterations=60, matcher="pallas", **mode)
        out.append((f"scaled ICP {label} volume-16384", functools.partial(
            ft.run_scaled_icp, vs, vt, cfg),
            lambda res: float(ft.rmse(res.apply(vs), vt)), SCALED["rmse"]))
    b = build_scene(ft, "bunny", dev)
    out.append(("SGD-ICP K1 bunny-8171 B=1024", functools.partial(
        ft.run_sgd_icp, b.source, b.target,
        ft.ICPConfig(max_iterations=SGD["steps"], tolerance=1e-6),
        batch_size=SGD["batch"], seed=0), b, SGD["coarse"]))
    for name, kind, iters, thr in SCENES:
        sc = build_scene(ft, kind, dev)
        for label, mode in (("K1", {}), ("K2", PACKED)):
            cfg = ft.ICPConfig(max_iterations=iters, matcher="pallas", **mode)
            out.append((f"history {label} {name}", functools.partial(
                ft.run_icp_with_history, sc.source, sc.target, cfg), sc,
                thr))
    name, kind, metric, iters, thr = MORTON_SCENES[1]
    g = build_scene(ft, kind, dev)
    cfg = ft.ICPConfig(metric=metric, matcher="morton", max_iterations=iters,
                       **BAND)
    out.append((f"history K3 {name.split()[-1]}", functools.partial(
        ft.run_icp_with_history, g.source, g.target, cfg), g, thr))
    _, gt, odo, closures, infos, odo_w = slam_graph(torch, ft, dev)
    T = SLAM["frames"]
    out.append((f"pose graph SLAM {T} frames, unit weights", functools.partial(
        ft.close_loops, odo, *closures, iterations=SLAM["gn"]),
        lambda res: float(res.residual_rms[-1] / res.residual_rms[0]), 1.0))
    end = torch.as_tensor(gt[T - 1], device=dev)
    out.append((f"close_loops SLAM {T} frames", functools.partial(
        ft.close_loops, odo, *closures, infos, odometry_weight=odo_w,
        iterations=SLAM["gn"]),
        lambda res: float((res.poses[T - 1] - end).abs().max()),
        SLAM["closed"]))
    src = ft.load_bunny(device=dev)
    pose = ft.gt_transform(*GLOBAL["bunny_pose"], device=dev)
    out.append(("global_registration bunny 4086x8171, 1,024 hypotheses",
                functools.partial(ft.global_registration, src,
                                  pose.apply(src)),
                ft.RegistrationScene(src, pose.apply(src), pose),
                GLOBAL_RANSAC))
    return out


def variant_syncs(torch, np, ft, dev, card):
    """24 iterations of each loop variant (stop test off), eager and
    captured (after a call that captured): the host waits only at the done
    reads after 8 and 16 iterations; the pose graph (24 Gauss-Newton
    iterations) and RANSAC (1,024 hypotheses, 3 refine rounds, inputs
    prepared) not until the result, past the segment plans' sizes. Then
    ``global_registration``'s syncs, its feature stage's, listed."""
    import functools

    from fpcr_tpu_torch.models import global_reg as gr
    from fpcr_tpu_torch.models.sgd_icp import _sgd_loop
    from fpcr_tpu_torch.utils import graphs

    s = build_scene(ft, "synthetic", dev)
    vs, vt = scaled_volume(ft, dev)
    b = build_scene(ft, "bunny", dev)
    k = dict(max_iterations=24, tolerance=0.0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    draws = torch.randint(0, b.source.shape[0], (24, SGD["batch"]),
                          generator=gen, device=dev)
    _, _, odo, closures, infos, odo_w = slam_graph(torch, ft, dev)
    ransac = ransac_inputs(torch, ft, dev)
    runs = {
        "AA-ICP point K1": (functools.partial(
            ft.run_aa_icp, s.source, s.target, ft.ICPConfig(
                matcher="pallas", **k)), 2),
        "scaled ICP K1": (functools.partial(
            ft.run_scaled_icp, vs, vt, ft.ICPConfig(matcher="pallas", **k)),
            2),
        "SGD-ICP K1 B=1024": (functools.partial(
            _sgd_loop, b.source, b.target, ft.ICPConfig(**k),
            lambda it: draws[it], batch_size=SGD["batch"],
            learning_rate=0.2, momentum=0.7, ema=0.9, lr_decay=0.02), 2),
        "history K1": (functools.partial(
            ft.run_icp_with_history, s.source, s.target, ft.ICPConfig(
                matcher="pallas", **k)), 2),
        "close_loops SLAM": (functools.partial(
            ft.close_loops, odo, *closures, infos, odometry_weight=odo_w,
            iterations=24), 0),
        "RANSAC bunny": (functools.partial(gr._ransac, *ransac, 3), 0)}
    for label, (run, reads) in runs.items():
        run()  # the key's first call, eager
        run()  # captures
        for mode in ("captured", "eager"):
            with graphs.eager(mode == "eager"):
                _check_sync_sites(label, mode, sync_sites(torch, run), reads,
                                  card)
    src = ft.load_bunny(device=dev)
    tgt = ft.gt_transform(*GLOBAL["bunny_pose"], device=dev).apply(src)
    run = functools.partial(ft.global_registration, src, tgt)
    run()
    run()
    sites = sync_sites(torch, run)
    log("graphs", f"global_registration bunny, RANSAC captured: "
                  f"{sum(sites.values())} syncs, all in the feature stage "
                  f"and the draws' set-up: {sites} {card}")
    if any("_ransac" in key or "drive_chunks" in key for key in sites):
        raise AssertionError("global_registration: RANSAC read the host")


def variant_slopes(torch, np, ft, dev, card):
    """Captured against eager, six times each in turns: ms/iter by the
    slope of AA-ICP point, scaled ICP, history (K1, 16,384) and SGD-ICP
    (Bunny, B = 1,024); ms a call of the SLAM pose graph (``close_loops``,
    6 Gauss-Newton iterations) and of RANSAC on Bunny (its inputs
    prepared). Returns ``{path: {mode: [ms]}}``."""
    import dataclasses as dc

    from fpcr_tpu_torch.models import global_reg as gr
    from fpcr_tpu_torch.utils.timing import cuda_time_ms, slope_ms_per_iter

    s = build_scene(ft, "synthetic", dev)
    vs, vt = scaled_volume(ft, dev)
    b = build_scene(ft, "bunny", dev)
    base = ft.ICPConfig(tolerance=0.0, matcher="pallas")

    def loop(fn, *args, **kw):
        return lambda n: fn(*args, dc.replace(base, max_iterations=n), **kw)

    cases = [("AA-ICP point K1 16384", loop(ft.run_aa_icp, s.source,
                                             s.target), 4, 12),
             ("scaled ICP K1 volume-16384", loop(ft.run_scaled_icp, vs, vt),
              4, 20),
             ("history K1 16384", loop(ft.run_icp_with_history, s.source,
                                       s.target), 4, 20),
             ("SGD-ICP bunny-8171 B=1024", loop(
                 ft.run_sgd_icp, b.source, b.target,
                 batch_size=SGD["batch"]), 8, 40)]
    out = {}
    for label, run, lo, hi in cases:
        out[label] = _turns(torch, label, f"ms/iter (slope of {lo}/{hi}, "
                            "min of 3)", lambda: slope_ms_per_iter(
                                run, lo, hi, repeats=3)["ms_per_iter"], card)
    _, _, odo, closures, infos, odo_w = slam_graph(torch, ft, dev)
    ransac = ransac_inputs(torch, ft, dev)
    for label, call in (
            ("close_loops SLAM 12 frames, 6 GN iterations", lambda:
             ft.close_loops(odo, *closures, infos, odometry_weight=odo_w,
                            iterations=SLAM["gn"])),
            ("RANSAC bunny 1,024 hypotheses, 3 refine rounds",
             lambda: gr._ransac(*ransac, 3))):
        out[label] = _turns(torch, label, "ms a call (min of 5)",
                            lambda: cuda_time_ms(call, repeats=5,
                                                 warmup=2)["min"], card)
    return out


def sharded_graph_paths(torch, np, ft, dev):
    """The world-1 NCCL paths that run captured (the process group made by
    ``phase_parallel``): ``distributed_icp`` point through K1 at 16,384 and
    Morton through K3 at 1,048,576, ``distributed_ndt`` through K4 at
    1,048,576; ``[(label, run, scene, threshold)]``."""
    import functools

    from fpcr_tpu_torch.parallel.dist_icp import (distributed_icp,
                                                  distributed_ndt)

    out = []
    for name, kind, loop, fields, _, thr in PARALLEL_PATHS:
        if name.split(",")[0] not in ("dist point synthetic-16384",
                                      "dist morton point synthetic-1048576",
                                      "dist ndt synthetic-1048576 banded"):
            continue
        s = parallel_scene(torch, np, ft, kind, dev)
        run = (functools.partial(distributed_icp, s.source, s.target,
                                 ft.ICPConfig(**fields)) if loop == "icp"
               else functools.partial(distributed_ndt, s.source, s.target,
                                      ft.NDTConfig(**fields)))
        out.append((f"{name} (NCCL world 1)", run, s, thr))
    return out


def kernel_sites(torch, run):
    """``(sites, counted, seen, added)`` of one ``run()`` under
    ``torch.profiler``, padded by spin kernels (a session loses events at
    its edges, see ``device_events``): ``sites`` maps each runtime call
    that launched the port's kernels (by the trace's correlation ids) to
    their device events under it, ``counted`` is what the wrappers' launch
    counters added meanwhile, ``seen`` the device events by kernel name and
    ``added`` the counters' additions by counter."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    before = counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(PAD_CYCLES)
        run()
        torch.cuda._sleep(PAD_CYCLES)
        torch.cuda.synchronize()
    after = counters()
    from torch.autograd import DeviceType

    # the runtime and driver calls (``cudaLaunchKernel``,
    # ``cudaGraphLaunch``, ...) share their correlation ids with the device
    # work they started; the host's operators carry ids of their own
    events = prof.profiler.kineto_results.events()
    calls = {e.correlation_id(): e.name() for e in events
             if e.device_type() == DeviceType.CPU
             and e.name().startswith("cu")}
    sites, seen = {}, {}
    for e in events:
        name = next((k for k in OUR_KERNELS if k in e.name()), None)
        if e.device_type() == DeviceType.CUDA and name:
            call = calls.get(e.correlation_id(), "no runtime call")
            sites[call] = sites.get(call, 0) + 1
            seen[name] = seen.get(name, 0) + 1
    added = {k: after[k] - before[k] for k in after
             if after[k] != before[k]}
    return sites, sum(added.values()), seen, added


# a child process: ``_graph_traces_here`` on a fresh CUDA context
GRAPH_TRACES_CHILD = """
import sys, torch
import chip_smoke
import fpcr_tpu_torch as ft
chip_smoke._graph_traces_here(torch, ft, torch.device("cuda", 0), sys.argv[1])
print("GRAPH_TRACES_OK")
"""


def graph_traces(torch, ft, dev, card):
    """:func:`_graph_traces_here` in a process of its own: in a process
    that has captured, replayed and destroyed many graphs (this one, by
    now), the profiler names the kernels of conditional bodies wrongly (a
    point run's K1 events seen as ``morton_band_kernel`` on an H100), while
    a fresh process names them right."""
    runs = _finish_side_runs(_start_side_runs(
        {"traces": [sys.executable, "-c", GRAPH_TRACES_CHILD, card]}),
        timeout=900)
    rc, so, se = runs["traces"]
    print(so, end="", flush=True)
    if rc != 0 or "GRAPH_TRACES_OK" not in so:
        raise AssertionError(f"graph_traces: exit {rc}\nstderr "
                             f"{se[-4000:]}")


def _graph_traces_here(torch, ft, dev, card):
    """One traced run of ``GRAPH_TRACE_ITERS`` iterations of point and
    plane ICP through K1 at 16,384 (the plane's normals given), captured
    (after the key's first call and the call that captures) and eager:
    device events, host launch calls (kernel and graph launches) and busy
    time an iteration, and the device's idle share. A second traced run
    each way holds the launch counters to the trace: the port's kernels
    appear as device events in the counted numbers, under graph launches
    when captured (or under no launching call, from a conditional body)
    and under kernel launches when eager. A captured point run that stops
    inside a chunk holds them to the trace with the launches of its
    skipped iterations taken out (the call's ``iterations_run`` and
    ``iterations_skipped``)."""
    from fpcr_tpu_torch.utils import graphs

    s = build_scene(ft, "synthetic", dev)
    nrm = ft.estimate_normals(s.target)  # the loop alone, as in the slopes
    k = GRAPH_TRACE_ITERS
    out = {}
    runs = [("point K1", {"matcher": "pallas"}, 0.0),
            ("plane K1", {"metric": "plane", "matcher": "pallas"}, 0.0),
            ("point K1 stopping", {"matcher": "pallas"},
             _stop_inside_a_chunk(ft, s, k))]
    for label, fields, tolerance in runs:
        cfg = ft.ICPConfig(max_iterations=k, tolerance=tolerance, **fields)
        normals = nrm if cfg.metric == "plane" else None
        for mode in ("captured", "eager"):
            with graphs.eager(mode == "eager"):
                def run():
                    return ft.run_icp(s.source, s.target, cfg,
                                      target_normals=normals)
                run()
                run()
                torch.cuda.synchronize()
                traced = _profiled_trace(torch, run, k)
                takes = []
                for _ in range(SITE_TAKES):
                    sites, counted, seen, added = kernel_sites(torch, run)
                    ran = (_last_call_counts("iterations_run"),
                           _last_call_counts("iterations_skipped"))
                    takes.append((sites, counted, seen, added))
                    if sites_agree(sites, counted, mode, ran):
                        break
            out[(label, mode)] = traced
            log("graphs", f"traced {k} iterations, {label} 16,384, {mode}: "
                          f"{json.dumps(traced)}; the port's kernels by "
                          f"launching call {sites}, launches counted "
                          f"{counted}, iterations of replayed chunks run / "
                          f"skipped {ran} {card}")
            for n, (t_sites, t_counted, t_seen, t_added) in enumerate(
                    takes[:-1]):
                log("graphs", f"{label} ({mode}): session {n + 1} of the "
                              f"counters' check lost records: kernels by "
                              f"launching call {t_sites}, by name {t_seen}; "
                              f"counted {t_counted}, by counter {t_added}; "
                              f"retaken")
            if not sites_agree(sites, counted, mode, ran):
                raise AssertionError(f"{label} ({mode}): in {len(takes)} "
                                     f"sessions the trace never showed the "
                                     f"port's kernels as counted; the last "
                                     f"shows them under {sites} (by name "
                                     f"{seen}), the counters {counted} "
                                     f"({added}), iterations run / skipped "
                                     f"{ran}")
            # every captured iteration sits in a conditional node, and the
            # stopping run skips some
            if mode == "captured" and (
                    not ran[0] or (label.endswith("stopping") and not ran[1])):
                raise AssertionError(f"{label} ({mode}): iterations run / "
                                     f"skipped {ran}")
    return out


def _stop_inside_a_chunk(ft, s, k):
    """A tolerance at which point ICP on ``s`` stops inside a chunk before
    ``k`` iterations, so that its last chunk skips iterations."""
    from fpcr_tpu_torch.models.icp import DONE_CHECK_EVERY

    for tolerance in (1e-3, 3e-4, 1e-4, 3e-5, 1e-5, 3e-6, 1e-6):
        n = int(ft.run_icp(s.source, s.target, ft.ICPConfig(
            max_iterations=k, tolerance=tolerance,
            matcher="pallas")).num_iterations)
        if n < k and n % DONE_CHECK_EVERY:
            return tolerance
    raise AssertionError(f"no tolerance stops point ICP inside a chunk "
                         f"before {k} iterations")


# traced sessions of the counters' check in ``graph_traces``: a session can
# lose records (``device_events``), never add any, so a count that agrees
# once is the count; one that never agrees fails the run
SITE_TAKES = 5


def sites_agree(sites, counted, mode, ran=None):
    """Whether one traced session (``kernel_sites``) shows the port's
    kernels as counted: as many device events as counted launches, each
    matched to the call that launched it, under ``cudaGraphLaunch`` when
    ``mode`` is "captured" and under none when eager. ``ran = (run,
    skipped)`` are the iterations of the replayed chunks that sit in
    conditional nodes (``utils/graphs.py::skip_if_all``) and those of them
    skipped. A replay counts every launch its capture made, the skipped
    iterations' included (``_build.counted``), so the events are then
    ``counted × (run − skipped) / run``; and a kernel of a conditional
    body is launched by the device, which CUPTI reports under the graph's
    launch in one session and under no launching call in another, so
    there a captured event may come with none (never with a kernel
    launch)."""
    run, skipped = ran if ran is not None else (0, 0)
    expected = counted * (run - skipped) / run if run else counted
    if mode == "captured":
        allowed = {"cudaGraphLaunch"} | ({"no runtime call"} if run else set())
        routed = bool(sites) and set(sites) <= allowed
    else:
        routed = (set(sites) != {"cudaGraphLaunch"}
                  and "no runtime call" not in sites)
    return counted > 0 and sum(sites.values()) == expected and routed


def _last_call_counts(name):
    """The count ``name`` of the last call the program recorded."""
    from fpcr_tpu_torch.utils import timing

    calls = [s for s in timing.recorded_spans() if s.name == "call"]
    return calls[-1].attrs.get(name, 0) if calls else 0


def phase_graphs(torch, np, ft, dev, smi):
    """The loops as captured CUDA graphs (``utils/graphs.py``) and kernel
    svd3: svd3 against its plain version; every path of the captured loops
    bit for bit its eager run, to its ground truth, with the eager run's
    launches; the host's syncs in 24 iterations of each; captured against
    eager ms/iter in turns, six times; one traced run of point and plane
    ICP each way; kernel eig3 (:func:`phase_eig3`). Returns svd3's, its
    Umeyama form's and eig3's kernels-line fields."""
    t0 = time.perf_counter()
    card = f"[card: {smi}]"
    svd3 = phase_svd3(torch, np, dev, card)
    umeyama = phase_svd3_umeyama(torch, np, dev, card)
    eig3 = phase_eig3(torch, np, ft, dev, card)
    records = check_captured(torch, ft, graph_paths(torch, np, ft, dev), card)
    t1 = time.perf_counter()
    records += check_captured(torch, ft, variant_paths(torch, np, ft, dev),
                              card)
    pools = sorted(r["pool_bytes"] for r in records)
    secs = sorted(r["capture_s"] for r in records)
    log("graphs", f"{len(records)} captures: seconds {secs[0]:.3f}-"
                  f"{secs[-1]:.3f} (median {secs[len(secs) // 2]:.3f}), "
                  f"pools {pools[0] / 2**20:.1f}-{pools[-1] / 2**20:.1f} MiB,"
                  f" peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
                  f"{card}")
    t2 = time.perf_counter()
    check_syncs(torch, np, ft, dev, card)
    t3 = time.perf_counter()
    variant_syncs(torch, np, ft, dev, card)
    t4 = time.perf_counter()
    graph_slopes(torch, np, ft, dev, card)
    svd3["slopes"] = svd3_slopes(torch, ft, dev, card)
    t5 = time.perf_counter()
    variant_slopes(torch, np, ft, dev, card)
    t6 = time.perf_counter()
    graph_traces(torch, ft, dev, card)
    log("graphs", f"phase done in {time.perf_counter() - t0:.1f} s; the "
                  f"loop variants' part (captured paths, syncs, slopes) "
                  f"{(t2 - t1) + (t4 - t3) + (t6 - t5):.1f} s")
    return svd3, umeyama, eig3


# ---- register_batch for every config (K3 and K3p with a batch axis) -------

def batch_poses(batch, seed, t_max, r_max):
    """B ground truths, translation U(±t_max) and rotation U(±r_max) rad
    an axis, from ``seed``."""
    rng = np.random.default_rng(seed)
    return [(tuple(rng.uniform(-t_max, t_max, 3).tolist()),
             tuple(rng.uniform(-r_max, r_max, 3).tolist()))
            for _ in range(batch)]


def morton_batch(ft, dev):
    """The Morton batch: ``surface_grid(256)`` (65,536 points, an Ouster
    OS1-64 scan's size) under B near-registered ground truths
    (``MORTON_BATCH``). Returns ``(sources [B,N,3], targets, ground
    truths)``."""
    src = ft.surface_grid(MORTON_BATCH["width"], device=dev)
    gts = [ft.gt_transform(t, r, device=dev) for t, r in batch_poses(
        MORTON_BATCH["batch"], MORTON_BATCH["seed"], *MORTON_BATCH["pose"])]
    return (torch.stack([src] * len(gts)),
            torch.stack([g.apply(src) for g in gts]).contiguous(), gts)


def odometry_frames(ft, dev):
    """``ODOMETRY_MORTON``'s scan sequence: the sensor moves ``step`` along
    +x over ``surface_grid(512)`` each frame; frame t is the ``points``
    points nearest its viewpoint's x, in its own coordinates, with N(0,
    ``noise``) noise. The pair (t+1 -> t) is a translation of ``step``.
    Returns ``(frames [T, N, 3], the frames' x positions)``."""
    cfg = ODOMETRY_MORTON
    world = ft.surface_grid(512, device="cpu").numpy()
    rng = np.random.default_rng(cfg["seed"])
    xs = cfg["step"] * np.arange(cfg["frames"])
    out = []
    for x in xs:
        crop = world[np.argsort(np.abs(world[:, 0] - x),
                                kind="stable")[:cfg["points"]]]
        local = crop - np.array([x, 0.0, 0.0], np.float32)
        out.append((local + rng.normal(scale=cfg["noise"], size=local.shape))
                   .astype(np.float32))
    return torch.as_tensor(np.stack(out), device=dev), xs


def parent_register_batch(ft, sources, targets, config):
    """The parent commit's route for the configs that it did not batch, kept
    here as the yardstick of the batched loop: the morton and grid
    matchers and the symmetric and gicp metrics one ``run_icp`` an element,
    stacked; the plane metric's normals estimated one target at a time,
    then the batched loop."""
    from fpcr_tpu_torch.models import batch as mb
    from fpcr_tpu_torch.models.icp import _normals_prepass

    if config.metric == "plane" and config.matcher in ("xla", "pallas"):
        normals = torch.stack([_normals_prepass(t, None, config)
                               for t in targets]).contiguous()
        return mb._batched_loop(sources, targets, normals, config)
    res = [ft.run_icp(sources[k], targets[k], config)
           for k in range(sources.shape[0])]
    return ft.ICPResult(
        transform=ft.RigidTransform(
            torch.stack([r.transform.rotation for r in res]),
            torch.stack([r.transform.translation for r in res])),
        **{name: torch.stack([getattr(r, name) for r in res])
           for name in ft.ICPResult._fields[1:]})


def batch_config_paths(ft, dev):
    """``[(label, config, sources, targets, ground truths, threshold)]``:
    every config that ``register_batch`` now batches
    (``BATCH_CONFIG_RUNS``)."""
    out = []
    serving = serving_batch(ft, dev)
    src = serving[0][0]
    gts = [ft.gt_transform(t, r, device=dev) for t, r in batch_poses(
        SERVING["batch"], NEAR_SERVING["seed"], *NEAR_SERVING["pose"])]
    batches = {"serving": serving, "morton": morton_batch(ft, dev),
               "near": (serving[0], torch.stack([g.apply(src) for g in gts])
                        .contiguous(), gts)}
    for label, fields, kind, thr in BATCH_CONFIG_RUNS:
        srcs, tgts, gts = batches[kind]
        out.append((label, ft.ICPConfig(**fields), srcs, tgts, gts, thr))
    return out


def _check_batch_elements(ft, label, res, srcs, tgts, gts, cfg, thr):
    """Each element to its ground truth and within one iteration of its
    own ``run_icp`` on the card (later only where it had converged by the
    earlier stop, ``STOP_NOISE``); returns the worst GT error of the batch
    and of the elements' own runs."""
    worst, own_worst = 0.0, 0.0
    its, own_its = [], []
    for k, g in enumerate(gts):
        t_k = ft.RigidTransform(res.transform.rotation[k],
                                res.transform.translation[k])
        gt = float(ft.transform_rmse(t_k, g, srcs[k]))
        one = ft.run_icp(srcs[k], tgts[k], cfg)
        own = float(ft.transform_rmse(one.transform, g, srcs[k]))
        it, ref = int(res.num_iterations[k]), int(one.num_iterations)
        its.append(it)
        own_its.append(ref)
        worst, own_worst = max(worst, gt), max(own_worst, own)
        if not stopped_on_noise(it, ref, res.errors[k].cpu().numpy()):
            raise AssertionError(f"{label}: element {k} took {it} "
                                 f"iterations, its own run_icp {ref}")
        if not (gt < thr and torch.isfinite(res.points[k]).all()):
            raise AssertionError(f"{label}: element {k} GT transform RMSE "
                                 f"{gt} >= {thr}")
    log("batch", f"{label}: iterations {its}, own run_icp {own_its}; worst "
                 f"GT transform RMSE {worst:.3e} (< {thr:g}), own runs' "
                 f"{own_worst:.3e}")
    return worst, own_worst


def _check_band_batch(label, p, table, extra, chunk, window, packed, card):
    """Batched K3 (``packed`` False) or K3p: one launch; culled equal to
    unculled and the bases to ``band_bases``; each element's outputs,
    bases and visits bit for bit its unbatched call's; each element held
    against the batched plain version as ``_check_band`` holds an
    unbatched call. Returns ``(largest |sqdist err| over equal picks, the
    stats of the culled call)``."""
    from fpcr_tpu_torch.ops.morton import (band_bases, band_idx_bits,
                                           band_rows, table_element)
    from fpcr_tpu_torch.ops import morton as tm
    from fpcr_tpu_torch.ops.morton_cuda import (morton_nn_cuda,
                                                morton_nn_packed_cuda)

    kernel = morton_nn_packed_cuda if packed else morton_nn_cuda
    plain = (tm.morton_nn_band_packed_plain if packed
             else tm.morton_nn_band_plain)
    name = f"{'K3p' if packed else 'K3'} batched {label}"
    torch.cuda.synchronize()
    before = kernel.launches
    stats, full = {}, {}
    out = kernel(p, table, extra, chunk=chunk, window=window, _stats=stats)
    if kernel.launches - before != 1:
        raise AssertionError(f"{name}: {kernel.launches - before} launches")
    ref = kernel(p, table, extra, chunk=chunk, window=window, _cull=False,
                 _stats=full)
    for x, y in zip(out, ref):
        if (x is None) != (y is None) or (x is not None
                                          and not torch.equal(x, y)):
            raise AssertionError(f"{name}: culled and unculled differ")
    _, bases = band_bases(p, table, chunk, window)
    if not (torch.equal(stats["bases"], bases)
            and torch.equal(full["bases"], bases)):
        raise AssertionError(f"{name}: bases differ from band_bases")
    o = plain(p, table, extra, chunk=chunk, window=window)
    within = (packed_tie(band_idx_bits(band_rows(chunk, window))) if packed
              else lambda dk, do: np.abs(dk - do)
              <= TIE_REL * np.maximum(1.0, do))
    err, swaps = 0.0, 0
    for k in range(p.shape[0]):
        t_k = table_element(table, k)
        e_k = None if extra is None else extra[k]
        own_stats = {}
        own = kernel(p[k], t_k, e_k, chunk=chunk, window=window,
                     _stats=own_stats)
        for x, y in zip(out, own):
            if x is not None and not torch.equal(x[k], y):
                raise AssertionError(f"{name}: element {k} differs from its "
                                     "unbatched call")
        for key in ("bases", "visits"):
            if not torch.equal(stats[key][k], own_stats[key]):
                raise AssertionError(f"{name}: element {k}'s {key} differ")
        q = t_k.points_sorted
        ki, oi = out[2][k].cpu().numpy(), o[2][k].cpu().numpy()
        kd, od = out[1][k].cpu().numpy(), o[1][k].cpu().numpy()
        if not (np.isfinite(kd).all() and np.isfinite(od).all()):
            raise AssertionError(f"{name}: element {k} found no target")
        same = ki == oi
        np.testing.assert_allclose(kd[same], od[same], **CASE_TOL,
                                   err_msg=f"{name}: element {k} sqdist")
        err = max(err, float(np.abs(kd[same] - od[same]).max()))
        swaps += _tie_rows(f"{name} element {k}", p[k], q, ki, oi,
                           within).size
        if not torch.equal(out[0][k], q[out[2][k].long()]):
            raise AssertionError(f"{name}: matched rows differ from the "
                                 "table")
    culled = 1.0 - int(stats["visits"].sum()) / int(full["visits"].sum())
    log("batch", f"{name}: one launch, culled == unculled, bases == "
                 f"band_bases, every element bit for bit its unbatched call "
                 f"(outputs, bases, visits), {'in-bucket swaps' if packed else 'near-ties'}"
                 f" against the plain version {swaps}, max |sqdist err| "
                 f"{err:.3e}, visits culled {culled:.4f} -> ok {card}")
    return err, stats


def batched_band_kernels(torch, np, ft, dev, card):
    """Batched K3 and K3p at 16 x 65,536 points, chunk 512 / window 64,
    with and without an extra (the targets' normals in table order):
    checked by :func:`_check_band_batch`, then timed in legs against 16
    unbatched calls (call by events, kernel by the profiler), with the
    batched plain version's time and the bound over the pairs the culled
    batch evaluated. Returns ``{key: entry fields}``."""
    from fpcr_tpu_torch.ops import morton as tm
    from fpcr_tpu_torch.ops.matching import gather_correspondences
    from fpcr_tpu_torch.ops.morton_cuda import (BAND_SUB, band_visit_totals,
                                                morton_nn_cuda,
                                                morton_nn_packed_cuda)
    from fpcr_tpu_torch.utils.timing import cuda_time_ms

    srcs, tgts, _ = morton_batch(ft, dev)
    b, n = srcs.shape[0], srcs.shape[1]
    table = tm.build_morton_table(tgts)
    order = tm.source_morton_order(srcs, table).long()
    p = torch.take_along_dim(srcs, order[..., None], dim=1).contiguous()
    nrm = gather_correspondences(ft.estimate_normals(tgts),
                                 table.orig_index)
    nrm = nrm.contiguous()
    elems = [tm.table_element(table, k) for k in range(b)]
    out = {}
    for key, packed, kernel, plain, flops in (
            ("morton_nn", False, morton_nn_cuda, tm.morton_nn_band_plain,
             ARGMIN_PAIR_FLOPS),
            ("morton_nn_packed", True, morton_nn_packed_cuda,
             tm.morton_nn_band_packed_plain, PACKED_PAIR_FLOPS)):
        err = 0.0
        for label, extra in (("16x65536 c512/w64", None),
                             ("16x65536 c512/w64 + normals", nrm)):
            e, stats = _check_band_batch(label, p, table, extra, 512, 64,
                                         packed, card)
            err = max(err, e)
        total, seeds = band_visit_totals(n, 512, stats["band"])
        visits = int(stats["visits"].sum())
        pairs = (visits + b * seeds) * BAND_SUB ** 2
        legs = time_legs("batch", f"{key} 16x65536", lambda: kernel(
            p, table, chunk=512, window=64), lambda: [
                kernel(p[k], elems[k], chunk=512, window=64)
                for k in range(b)], card)
        plain_ms = cuda_time_ms(lambda: plain(p, table, chunk=512, window=64),
                                repeats=2, warmup=1)["min"]
        nbytes = b * (12 * n + 12 * n + 4 * n + 24 + 4 + 20 * n)
        bound_ms, bound_by = bound(nbytes, flops * pairs)
        fields = leg_fields(legs)
        out[key] = dict(call_ms=fields["call_ms"],
                        kernel_ms=fields["kernel_ms"],
                        unbatched_call_ms=fields["yardstick_call_ms"],
                        unbatched_kernel_ms=fields["yardstick_kernel_ms"],
                        batch=b, n=n, pairs=pairs,
                        visits_culled=1.0 - visits / (b * total),
                        max_abs_err=err, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by)
        log("times", f"batched {key} B={b} x {n} c512/w64: {json.dumps(out[key])}"
                     f" {card}")
    return out


def phase_batched_configs(torch, np, ft, dev, smi):
    """``register_batch`` for every config the JAX package ``vmap``s, and
    K3 / K3p with a batch axis: the kernels checked and timed
    (:func:`batched_band_kernels`); each config's path driven between
    counter reads (one band launch a shift an iteration, no ``run_icp``),
    every element to its ground truth and its own ``run_icp``'s iterations;
    ``register_sequence`` through K3 on 17 frames of 65,536 points, with
    its drift; each path captured bit for bit its eager run with equal
    launches; 24 iterations reading the host only at the done reads; ms a
    batch in legs against the parent's element-by-element route. Returns
    ``(launches summed over the paths, the batched band launches,
    the kernels' entries)``."""
    import dataclasses as dc
    import functools

    from fpcr_tpu_torch.utils import graphs
    from fpcr_tpu_torch.utils.timing import cuda_time_ms

    t0 = time.perf_counter()
    card = f"[card: {smi}]"
    entries = batched_band_kernels(torch, np, ft, dev, card)
    paths = batch_config_paths(ft, dev)
    launches, band = {}, {"morton_nn": 0, "morton_nn_packed": 0}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    graphs.clear()
    for label, cfg, srcs, tgts, gts, thr in paths:
        box = {}

        def run(srcs=srcs, tgts=tgts, cfg=cfg):
            box["res"] = ft.register_batch(srcs, tgts, cfg)

        counts = drive(torch, f"register_batch {label}", run)
        res = box["res"]
        passes = loop_passes(int(res.num_iterations.max()),
                             cfg.max_iterations)
        kernel = {"morton": "morton_nn_packed" if cfg.pallas_mode ==
                  "packed6_idx" else "morton_nn"}.get(cfg.matcher)
        if kernel is not None:
            if counts[kernel] != cfg.morton_shifts * passes:
                raise AssertionError(f"{label}: {counts[kernel]} {kernel} "
                                     f"launches in {passes} passes")
            band[kernel] += counts[kernel]
        elif counts["morton_nn"] or counts["morton_nn_packed"]:
            raise AssertionError(f"{label}: a band kernel launched")
        want_k1 = 2 * passes if cfg.matcher == "pallas" else 0
        if counts["nn_argmin"] != want_k1:
            raise AssertionError(f"{label}: {counts['nn_argmin']} K1 "
                                 f"launches in {passes} passes")
        add(counts)
        _check_batch_elements(ft, label, res, srcs, tgts, gts, cfg, thr)

    frames, xs = odometry_frames(ft, dev)
    ocfg = ft.ICPConfig(**ODOMETRY_MORTON["config"])
    box = {}
    counts = drive(torch, "register_sequence morton 17x65536",
                   lambda: box.update(odo=ft.register_sequence(frames, ocfg)))
    odo = box["odo"]
    passes = loop_passes(int(odo.relative.num_iterations.max()),
                         ocfg.max_iterations)
    if counts["morton_nn"] != passes:
        raise AssertionError(f"register_sequence: {counts['morton_nn']} K3 "
                             f"launches in {passes} passes")
    band["morton_nn"] += counts["morton_nn"]
    add(counts)
    poses = odo.poses.cpu().numpy().astype(np.float64)
    drift = np.abs(poses[:, 0, 3] - xs).max()
    off = max(np.abs(poses[:, 1:3, 3]).max(),
              np.abs(poses[:, :3, :3] - np.eye(3)).max())
    log("batch", f"register_sequence morton {frames.shape[0]} x "
                 f"{frames.shape[1]}: pair iterations "
                 f"{odo.relative.num_iterations.tolist()}, end-pose x "
                 f"{poses[-1, 0, 3]:.6f} (GT {xs[-1]:.6f}), largest x drift "
                 f"{drift:.3e}, largest y/z/rotation entry off the GT "
                 f"{off:.3e} (< {ODOMETRY_MORTON['drift']:g}) {card}")
    if not (drift < ODOMETRY_MORTON["drift"]
            and off < ODOMETRY_MORTON["drift"]):
        raise AssertionError("register_sequence morton: drift "
                             f"{max(drift, off)}")

    captured = [(f"register_batch {label}", functools.partial(
        ft.register_batch, srcs, tgts, cfg), (srcs, gts), thr)
        for label, cfg, srcs, tgts, gts, thr in paths]
    check_captured(torch, ft, captured, card)

    for label, cfg, srcs, tgts, _, _ in paths:
        run = functools.partial(ft.register_batch, srcs, tgts, dc.replace(
            cfg, max_iterations=24, tolerance=0.0))
        run()  # the key's first call, eager
        run()  # captures
        for mode in ("captured", "eager"):
            with graphs.eager(mode == "eager"):
                _check_sync_sites(f"register_batch {label}", mode,
                                  sync_sites(torch, run), 2, card)

    times = {}
    for label, cfg, srcs, tgts, _, _ in paths:
        legs = {"parent": [], "batched": []}
        for leg in ("parent", "batched", "batched", "parent", "parent",
                    "batched"):
            fn = (functools.partial(ft.register_batch, srcs, tgts, cfg)
                  if leg == "batched" else functools.partial(
                      parent_register_batch, ft, srcs, tgts, cfg))
            legs[leg].append(cuda_time_ms(fn, repeats=2, warmup=1)["min"])
        best = {k: min(v) for k, v in legs.items()}
        times[label] = legs
        log("times", f"register_batch {label}, ms a batch in legs (parent's "
                     f"element-by-element route, batched, batched, parent, "
                     f"parent, batched): parent {legs['parent']}, batched "
                     f"{legs['batched']}; least {best['batched']:.3f} "
                     f"against {best['parent']:.3f} "
                     f"({best['parent'] / best['batched']:.2f}x) {card}")
    log("batch", f"phase done in {time.perf_counter() - t0:.1f} s")
    return launches, band, entries


def bound(nbytes, flops, ops_ms=0.0):
    """``(bound_ms, bound_by)``: the least time the card could take for
    ``nbytes`` of device-memory traffic (each input read once, each output
    written once) and ``flops`` float32 operations at the published
    peaks, or ``ops_ms`` of other operations where that is longer."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = max(flops / FP32_FLOPS * 1e3, ops_ms)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def split_ops_ms(n, m, k):
    """Kernel S's operation time: the larger of its bf16 products, 2 K_pad
    N M over the tensor cores' dense peak (K padded to 16), and the
    reduction's needed instructions over the CUDA cores' rate (the
    products at K >= 24)."""
    k_pad = -(-k // 16) * 16
    return max(2 * k_pad * n * m / BF16_FLOPS,
               SPLIT_REDUCE_INSTR * n * m / CORE_IPS) * 1e3


def kernel_entry(name, source, replaces, launches, err, ms, plain_ms, nbytes,
                 flops, ops_ms=0.0):
    bound_ms, bound_by = bound(nbytes, flops, ops_ms)
    # no single PyTorch call computes an argmin NN, a band NN, K4's
    # moments, a packed or min reduction of the split distance, or E1's
    # form values (the keep column reads a product of bf16 operands in f32,
    # which no single call returns), so there is no library yardstick
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def kernels_line(launches, errs, times, times2, times3, times5, svd3,
                 umeyama, eig3, batched_launches, batched):
    """The ``kernels`` JSON object, the bounds from this run's inputs: the
    brute-force kernels at the synthetic scene's N = M = 16,384, the band
    kernels at 1,048,576 points (chunk 512, window 64, no extra; bytes with
    the codes the bases are searched in, float32 operations over the pairs
    the culled kernel evaluated, seed sub-tiles included), K4 at
    1,048,576 points with its hit neighbours counted, Kernel S at E3's
    N = M = 16,384 and the E1 forms at E1's."""
    from fpcr_tpu_torch.ops.morton import band_rows

    n, m = times["n"], times["m"]
    nb = LARGE_WIDTHS[-1] ** 2
    band = band_rows(512, 64)
    band_bytes = 12 * nb + 12 * nb + 4 * nb + 24 + 4 + 20 * nb
    k4 = times3[nb]
    k4_bytes = nb * (12 + 12 + 64 + 12) + k4["table_rows"] * (4 + 64)
    k4_flops = K4_HIT_FLOPS * k4["hits"] + K4_QUERY_FLOPS * nb
    for label, pairs in ((f"brute N=M={n}", n * m),
                         (f"band N={nb} x {band} rows", nb * band),
                         (f"K3 band N={nb}, pairs evaluated",
                          times2[f"k3 pairs {nb}"]),
                         (f"K3p band N={nb}, pairs evaluated",
                          times2[f"k3p pairs {nb}"])):
        log("bound", f"{label}: {pairs} pairs, float32 bound "
                     f"{ARGMIN_PAIR_FLOPS * pairs / FP32_FLOPS * 1e3:.6f} ms "
                     f"(argmin, min-only) / "
                     f"{PACKED_PAIR_FLOPS * pairs / FP32_FLOPS * 1e3:.6f} ms "
                     f"(packed key); the difference form's "
                     f"{DESIGN_PAIR_FLOPS} flops a pair would take "
                     f"{DESIGN_PAIR_FLOPS * pairs / FP32_FLOPS * 1e3:.6f} ms")
    nn_tc = "fpcr_tpu_torch/csrc/nn_tc.cu"
    morton = "fpcr_tpu_torch/csrc/morton.cu"
    k1, k2 = (dict(kernel_entry(key, nn_tc,
                                f"fpcr_tpu/ops/matching_pallas.py:{line}",
                                launches[key], errs[key], times[ms],
                                times[plain], 12 * n + 12 * m + 8 * n,
                                flops * n * m),
                   batched=times["batched"][key])
              for key, line, ms, plain, flops in (
                  ("nn_argmin", 196, "k1_ms", "plain_ms", ARGMIN_PAIR_FLOPS),
                  ("nn_argmin_packed", 273, "k2_ms", "k2_plain_ms",
                   PACKED_PAIR_FLOPS)))
    return {"kernels": [k1, k2,
        form_entry("nn_min_only", "scripts/exp_packed_reduction.py:113",
                   launches, errs, times5["nn_min_only"]),
        kernel_entry("morton_nn", morton,
                     "fpcr_tpu/ops/morton_pallas.py:328",
                     launches["morton_nn"], errs["morton_nn"],
                     *times2[f"k3 {nb}"], band_bytes,
                     ARGMIN_PAIR_FLOPS * times2[f"k3 pairs {nb}"]),
        kernel_entry("morton_nn_packed", morton,
                     "fpcr_tpu/ops/morton_pallas.py:261",
                     launches["morton_nn_packed"], errs["morton_nn_packed"],
                     *times2[f"k3p {nb}"], band_bytes,
                     PACKED_PAIR_FLOPS * times2[f"k3p pairs {nb}"]),
    ] + [batched_band_entry(key, line, batched_launches[key], batched[key])
         for key, line in (("morton_nn", 328), ("morton_nn_packed", 261))
         ] + [
        kernel_entry("ndt_fused_moments", "fpcr_tpu_torch/csrc/ndt.cu",
                     "fpcr_tpu/ops/ndt_pallas.py:512",
                     launches["ndt_fused_moments"], errs["ndt_fused_moments"],
                     k4["k4_ms"], k4["plain_ms"], k4_bytes, k4_flops),
    ] + study_entries(launches, errs, times5) + [
        svd3_entry(launches, svd3), umeyama_entry(launches, umeyama),
        eig3_entry(launches, eig3)]}


def batched_band_entry(key, line, launches, fields):
    """K3's or K3p's batch axis as an entry of its own: its launches on the
    batched paths (``register_batch`` and ``register_sequence`` through the
    morton matcher), its batched call at 16 x 65,536 (kernel time by the
    profiler, the legs' median; the call's where no leg saw an event)
    against its batched plain version, bound over the pairs it evaluated,
    and the 16 unbatched calls' times beside it."""
    ms = fields["kernel_ms"]
    return dict(fields, name=f"{key} batched", route="cuda",
                source="fpcr_tpu_torch/csrc/morton.cu",
                replaces=f"fpcr_tpu/ops/morton_pallas.py:{line}",
                launches=launches,
                ms=fields["call_ms"] if ms is None else ms,
                library_ms=None)


def svd3_entry(launches, svd3):
    """svd3's ``kernels`` entry at run_icp's batch of one (the other
    batches under ``batches``): its bound the larger of 72 bytes a matrix
    over the HBM rate and the float32 operations the rotation needs over
    the float32 peak, ``torch.linalg.svd``'s call as the library's time,
    and an empty kernel's device time and call time beside them."""
    entry = kernel_entry("svd3_rotation", "fpcr_tpu_torch/csrc/svd3.cu",
                         "fpcr_tpu/ops/solve.py:84", launches["svd3_rotation"],
                         svd3["max_abs_err"], svd3["ms"], svd3["plain_ms"],
                         72, SVD3_FLOPS)
    for key in ("library_ms", "call_ms", "kernel_ms", "yardstick_call_ms",
                "yardstick_kernel_ms", "latency_ms", "empty_call_ms",
                "ablation"):
        entry[key] = svd3[key]
    entry["batches"] = {str(b): v for b, v in svd3["batches"].items()}
    entry["point_k1_ms_per_iter"] = svd3["slopes"]
    return entry


def eig3_entry(launches, eig3):
    """eig3's ``kernels`` entry at the main path's batch, the hall scan's
    16,384 covariances: its bound the larger of 84 bytes a matrix over the
    HBM rate and one Jacobi sweep's float32 operations over the float32
    peak, the closed form's call time beside the plain version's."""
    entry = kernel_entry("eig3", "fpcr_tpu_torch/csrc/svd3.cu",
                         "fpcr_tpu/ops/eigh3.py:86", launches["eig3"],
                         eig3["max_abs_err"], eig3["ms"], eig3["plain_ms"],
                         EIG3_BYTES * eig3["batch"],
                         EIG3_FLOPS * eig3["batch"])
    for key in ("call_ms", "closed_form_ms", "worst_over_bound",
                "plain_worst_over_bound", "isotropic_rows", "batch"):
        entry[key] = eig3[key]
    return entry


def umeyama_entry(launches, umeyama):
    """svd3's Umeyama form's ``kernels`` entry at scaled ICP's batch of one
    (the other batches under ``batches``): ``max_abs_err`` R's against the
    float32 plain version where R is unique, ``trace_rel_err`` the trace's
    over σ1 (its scale is W's, up to 1e6 here); its bound the larger of 76 bytes
    a matrix (W read, R and the trace written) over the HBM rate and the
    float32 operations Umeyama's rotation and trace need over the float32
    peak, ``torch.linalg.svd``'s call as the library's time (the plain
    version adds the sign and scale glue)."""
    entry = kernel_entry("svd3_umeyama", "fpcr_tpu_torch/csrc/svd3.cu",
                         "fpcr_tpu/ops/solve.py:183", launches["svd3_umeyama"],
                         umeyama["max_abs_err"], umeyama["ms"],
                         umeyama["plain_ms"], 76, SVD3_UMEYAMA_FLOPS)
    for key in ("library_ms", "call_ms", "kernel_ms", "yardstick_call_ms",
                "yardstick_kernel_ms", "trace_rel_err"):
        entry[key] = umeyama[key]
    entry["batches"] = {str(b): v for b, v in umeyama["batches"].items()}
    return entry


def study_entries(launches, errs, times5):
    """The ``kernels`` entries of Kernel S's five launch types (bytes: the
    bf16 operands read once, idx and d written once; with the wgmma
    sweep's and the mma.sync yardstick's kernel times from the legs) and
    the five E1 forms
    (bytes: p, q, the staged lane and |p|² read, idx and d written; 6 flops
    a pair for an argmin, 7 for a packed key, as K1 and K2)."""
    return [dict(kernel_entry(
        key, "fpcr_tpu_torch/csrc/split_wgmma.cu", SPLIT_REPLACES[key],
        launches[key], errs[key], t["ms"], t["plain_ms"],
        2 * t["k"] * (t["n"] + t["m"]) + 8 * t["n"], 0,
        split_ops_ms(t["n"], t["m"], t["k"])),
        **leg_fields(t["legs"]))
        for key, t in times5.items() if key.startswith("split")
    ] + [form_entry(key, E1_REPLACES[key], launches, errs, t)
         for key, t in times5.items() if key.startswith("e1")]


def form_entry(key, replaces, launches, errs, t):
    """The ``kernels`` entry of an E1 launch type or of the min-only sweep
    (``csrc/nn_forms.cu``): bytes p, q, the staged lane and |p|^2 read (E1),
    idx and d written; operations FORM_PAIR_INSTR a pair over CORE_IPS;
    the legs' call and kernel times of the new sweep and the yardstick."""
    n, m = t["n"], t["m"]
    nbytes = (12 * n + 12 * m + 4 * n if key == "nn_min_only" else
              12 * n + 12 * m + 4 * m + 4 * n + 8 * n)
    ops_ms = FORM_PAIR_INSTR[key] * n * m / CORE_IPS * 1e3
    flops = (ARGMIN_PAIR_FLOPS if key in ("e1 v1", "e1 v6", "nn_min_only")
             else PACKED_PAIR_FLOPS)
    log("bound", f"{key} N={n} M={m}: {FORM_PAIR_INSTR[key]} instructions "
                 f"a pair over CORE_IPS, {ops_ms:.6f} ms; the earlier "
                 f"{flops} flops a pair over FP32_FLOPS "
                 f"{flops * n * m / FP32_FLOPS * 1e3:.6f} ms")
    return dict(kernel_entry(key, "fpcr_tpu_torch/csrc/nn_forms.cu",
                             replaces, launches[key], errs[key], t["ms"],
                             t["plain_ms"], nbytes, 0, ops_ms),
                **leg_fields(t["legs"]))


def leg_fields(legs):
    """The legs' least call time and median kernel time (three legs a
    side: a profiler session now and then reads a kernel at half its time,
    PERF.md section 7) of the new kernel and of its yardstick; a kernel
    time is a profiler kernel time or null (every leg of that side saw no
    profiler event)."""
    def least(side, i):
        got = [leg[i] for leg in legs[side] if leg[i] is not None]
        return min(got) if got else None

    def median(side, i):
        got = sorted(leg[i] for leg in legs[side] if leg[i] is not None)
        return got[(len(got) - 1) // 2] if got else None

    return dict(call_ms=least("new", 0), kernel_ms=median("new", 1),
                yardstick_call_ms=least("yardstick", 0),
                yardstick_kernel_ms=median("yardstick", 1))


# the TPU kernel each new launch type replaces
SPLIT_REPLACES = {"split x6 argmin": "scripts/exp_split_matmul.py:72",
                  "split x3 argmin": "scripts/exp_split_matmul.py:72",
                  "split x6 packed14": "scripts/exp_reduction2.py:155",
                  "split x6 min": "scripts/exp_reduction2.py:155",
                  "split x6 keep": "scripts/exp_reduction2.py:155"}
E1_REPLACES = {"e1 v1": "scripts/exp_match_kernels.py:297",
               "e1 v2": "scripts/exp_match_kernels.py:332",
               "e1 v4": "scripts/exp_match_kernels.py:361",
               "e1 v5": "scripts/exp_match_kernels.py:137",
               "e1 v6": "scripts/exp_match_kernels.py:166"}


@contextlib.contextmanager
def split_plan(slice_len):
    """``split_nn_cuda`` with its target slices of ``slice_len`` in place of
    ``ops/split_cuda.py::plan_split``'s, to time other plans."""
    from fpcr_tpu_torch.ops import split_cuda

    saved = split_cuda._plan
    split_cuda._plan = lambda dev, n, m: (-(-m // slice_len), slice_len)
    try:
        yield
    finally:
        split_cuda._plan = saved


def phase_times_studies(torch, dev, smi, studies):
    """Kernel S's five launch types at E3's N = M = 16,384 (the E3
    decomposition: keep column, min, argmin and packed key on the same
    operands, and x3's argmin), each in legs against the mma.sync yardstick
    (yardstick, wgmma, wgmma, yardstick, yardstick, wgmma: the call's
    CUDA-event time and the profiler's kernel time a leg) and alone
    against its plain version;
    the wgmma sweep's ablations (without the reduction; without the
    reduction and the staging) and slice plans; then the five E1 launch
    types at E1's inputs and the min-only sweep at E2's, each in the same
    legs against its ``csrc/matching.cu`` yardstick and alone against its
    plain version, with the new sweep's ablations (the sums alone; the
    sums and the staging; the sweep without the finish; each the median of
    three sessions) and K1's kernel time on E1's inputs; then the three
    studies' results."""
    from fpcr_tpu_torch.bench import (match_kernels, packed_reduction,
                                      reduction2)
    from fpcr_tpu_torch.bench.kernel_checks import e1_args
    from fpcr_tpu_torch.ops.matching import E1_VARIANTS, nn_form_plain
    from fpcr_tpu_torch.ops.matching_cuda import (_nn_argmin_cudacore,
                                                  _nn_form_yardstick,
                                                  _nn_forms_only,
                                                  _nn_min_only_yardstick,
                                                  nn_argmin_cuda, nn_form_cuda,
                                                  nn_min_only_cuda)
    from fpcr_tpu_torch.ops.split import split_nn_plain, split_operands
    from fpcr_tpu_torch.ops.split_cuda import (WGMMA_MODES, _split_nn_mma_sync,
                                               _split_wgmma_only,
                                               split_nn_cuda)
    from fpcr_tpu_torch.utils.timing import cuda_time_ms

    card = f"[card: {smi}]"
    out = {}

    def measure(key, call, plain, n, m, **extra):
        ms = cuda_time_ms(call, repeats=20, warmup=3)
        plain_ms = cuda_time_ms(plain, repeats=5, warmup=1)["min"]
        kern = kernel_ms(call)
        out[key] = dict(ms=ms["min"], plain_ms=plain_ms, kernel_ms=kern,
                        n=n, m=m, **extra)
        log("times", f"{key} N=M={n}: min {ms['min']:.4f} ms, mean "
                     f"{ms['mean']:.4f} ms; kernel {kern:.4f} ms "
                     f"(profiler); plain min {plain_ms:.4f} ms {card}")

    def legs(key, new, old):
        return time_legs("times", f"{key} N=M={n}", new, old, card)

    src, tgt = reduction2.study_inputs(dev)
    n = m = src.shape[0]
    keep = (m // 8192 - 1) * 8192
    for terms, epis in ((6, ("keep", "min", "argmin", "packed14")),
                        (3, ("argmin",))):
        p_in, q_in = split_operands(src, tgt, terms, n, m)
        for epi in epis:
            key = f"split x{terms} {epi}"
            new = lambda: split_nn_cuda(p_in, q_in, n, m, epi,  # noqa: E731
                                        keep=keep)
            measure(key, new,
                    lambda: split_nn_plain(p_in, q_in, n, m, epi, keep=keep),
                    n, m, k=8 * terms)
            rec = legs(key, new, lambda: _split_nn_mma_sync(
                p_in, q_in, n, m, epi, keep=keep))
            out[key]["legs"] = rec
            log("times", f"{key}, three legs a side (least call, median "
                         f"kernel) ms: {json.dumps(leg_fields(rec))} "
                         f"({rec['retaken']} legs retaken) {card}")
        ablation = {"sweep": leg_fields(out[
            f"split x{terms} {'min' if terms == 6 else 'argmin'}"][
            "legs"])["kernel_ms"]}
        for mode in WGMMA_MODES:
            ablation[mode] = kernel_ms(lambda: _split_wgmma_only(
                p_in, q_in, n, m, mode))
        out[f"ablation x{terms}"] = ablation
        log("times", f"Kernel S wgmma sweep x{terms} N=M={n}, kernel ms "
                     f"(profiler; 'sweep' = the "
                     f"{'min' if terms == 6 else 'argmin'} epilogue): "
                     f"{json.dumps(ablation)} {card}")
        plans = {}
        for sl in (m, m // 2, m // 4):
            with split_plan(sl):
                plans[sl] = kernel_ms(lambda: split_nn_cuda(
                    p_in, q_in, n, m, "argmin"))
        out[f"slices x{terms}"] = plans
        log("times", f"Kernel S wgmma x{terms} argmin by slice length at "
                     f"N=M={n}: " + ", ".join(f"{k} targets {v:.4f} ms"
                                              for k, v in plans.items())
            + f" (profiler) {card}")
        # the same argmin over the targets in a random order: the study's
        # raster grids improve a row's best in about half of its tiles,
        # shuffled targets in under a tenth (each improving tile costs a
        # vote, two shuffles and a copy of the row's values)
        perm = torch.randperm(m, generator=torch.Generator().manual_seed(0))
        q_shuf = q_in[perm.to(dev)].contiguous()
        shuffled = {k: kernel_ms(lambda: f(p_in, q_shuf, n, m, "argmin"))
                    for k, f in (("wgmma", split_nn_cuda),
                                 ("mma.sync", _split_nn_mma_sync))}
        out[f"shuffled x{terms}"] = shuffled
        log("times", f"Kernel S x{terms} argmin, targets shuffled, N=M={n}: "
                     + ", ".join(f"{k} {v:.4f} ms" for k, v in
                                 shuffled.items()) + f" (profiler) {card}")
        if terms == 6:  # every product issued: time grows with M
            grow = {mm: kernel_ms(lambda: split_nn_cuda(
                p_in, q_in, n, mm, "keep", keep=mm - 1))
                for mm in (4096, 8192, m)}
            log("times", "split x6 keep kernel time by M at N=16384: "
                + ", ".join(f"M={k} {v:.4f} ms" for k, v in grow.items())
                + f" (profiler) {card}")
            out["keep by M"] = grow
    p, q = match_kernels.study_inputs(16384, dev)
    # the forms' ratios stay against K1's CUDA-core sweep, the yardstick
    # they were first measured against
    k1 = kernel_ms(lambda: _nn_argmin_cudacore(p, q))
    k1_tc = kernel_ms(lambda: nn_argmin_cuda(p, q))
    log("times", f"K1 at E1's inputs (±300) N=M=16384: kernel {k1:.4f} ms "
                 f"on the CUDA cores, {k1_tc:.4f} ms on the tensor cores "
                 f"(profiler) {card}")

    def form_legs(key, new, old, plain, sweep, pq):
        n_, m_ = pq[0].shape[0], pq[1].shape[0]
        measure(key, new, plain, n_, m_)
        rec = legs(key, new, old)
        out[key]["legs"] = rec
        ablation = {mode: sorted(kernel_ms(lambda: sweep(mode))
                                 for _ in range(3))[1]  # the median
                    for mode in ("sums only", "no reduce", "sweep")}
        ablation["call"] = leg_fields(rec)["kernel_ms"]
        out[key]["ablation"] = ablation
        log("times", f"{key}, three legs a side (least call, median kernel) "
                     f"ms: {json.dumps(leg_fields(rec))} ({rec['retaken']} "
                     f"legs retaken); new sweep's kernel ms: the sums alone "
                     f"{ablation['sums only']:.4f}, + staging "
                     f"{ablation['no reduce']:.4f}, + reduction "
                     f"{ablation['sweep']:.4f}, + finish "
                     f"{ablation['call']} (profiler) {card}")

    for v, (form, reduce) in E1_VARIANTS.items():
        q_w, psq, kw = e1_args(p, q, v)
        form_legs(f"e1 {v}", lambda: nn_form_cuda(p, q, q_w, psq, **kw),
                  lambda: _nn_form_yardstick(p, q, q_w, psq, **kw),
                  lambda: nn_form_plain(p, q, q_w, psq, **kw),
                  lambda mode: _nn_forms_only(p, q, q_w, psq, mode=mode,
                                              **kw), (p, q))
        log("times", f"e1 {v} ({form}, {reduce}): kernel "
                     f"{out[f'e1 {v}']['kernel_ms'] / k1:.3f}x the CUDA-core "
                     f"K1's {card}")
    src, tgt = packed_reduction.study_inputs(16384, dev)
    form_legs("nn_min_only", lambda: nn_min_only_cuda(src, tgt),
              lambda: _nn_min_only_yardstick(src, tgt),
              lambda: packed_reduction.nn_min_only_plain(src, tgt),
              lambda mode: _nn_forms_only(src, tgt, None, None, form="diff",
                                          reduce="min", mode=mode),
              (src, tgt))
    for name, res in studies.items():
        log("times", f"study {name}: {json.dumps(res)} {card}")
    return out


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
    shares, guard = phase_tc_vs_cudacore(torch, np, ft, dev, smi)
    errs.update(phase_band_vs_plain(torch, np, ft, dev))
    errs["ndt_fused_moments"] = phase_fused_vs_plain(torch, np, ft, dev)
    errs.update(phase_studies_vs_plain(torch, np, ft, dev))
    for key, err in phase_batched_vs_plain(torch, np, ft, dev).items():
        errs[key] = max(errs[key], err)
    launches, study, studies = phase_main_path(torch, ft, dev)
    phase_reference(torch, ft, dev)
    svd3, umeyama, eig3 = phase_graphs(torch, np, ft, dev, smi)
    counts, batched_launches, batched = phase_batched_configs(
        torch, np, ft, dev, smi)
    for key, n in counts.items():
        launches[key] = launches.get(key, 0) + n
    times = phase_times(torch, ft, dev, smi, study)
    times2 = phase_times_slice2(torch, ft, dev, smi)
    times3 = phase_times_ndt(torch, np, ft, dev, smi)
    times5 = phase_times_studies(torch, dev, smi, studies)
    phase_times_slice3(torch, ft, dev, smi)
    times["batched"] = phase_times_slice4(torch, ft, dev, smi)
    for key, n in phase_parallel(torch, ft, dev, smi).items():
        launches[key] += n
    # the six examples run as processes of their own beside the guards and
    # the fuzz; the scripts' timings then have the card to themselves
    examples = start_examples()
    try:
        extra = [phase_guards(torch, dev, smi), phase_fuzz(torch, dev, smi)]
    except BaseException:
        for p in examples[1].values():
            if p.poll() is None:
                p.kill()
                p.wait()
        raise
    extra.append(finish_examples(examples, smi))
    extra.append(phase_scripts(torch, dev, smi))
    for counts in extra:
        for key in launches:
            launches[key] += counts.get(key, 0)
    log("times", f"kernel_ms: {len(PROFILER_LOSSES)} profiler sessions lost "
                 f"events (seen, launched): {PROFILER_LOSSES}; "
                 f"{len(PROFILER_EMPTY)} sessions saw no device event "
                 f"(attempt numbers {PROFILER_EMPTY}); kernel_ms fell back "
                 f"to CUDA events {len(PROFILER_FALLBACKS)} times (ms "
                 f"{PROFILER_FALLBACKS})")
    legs = times["legs"]
    log("tc", "K1 / K2 at N=M=16384, (call, kernel) ms per leg, CUDA-core "
              f"then tensor-core: {json.dumps(legs)}; sweep ablations "
              f"{json.dumps(times['ablation'])}; rescued shares (K1, K2) "
              f"{json.dumps(shares)}; guard's largest measured ratio "
              f"{guard:.4f} [card: {smi}]")
    log("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels_line(launches, errs, times, times2, times3,
                                  times5, svd3, umeyama, eig3,
                                  batched_launches, batched)),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
