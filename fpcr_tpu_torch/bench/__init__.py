"""Studies of the port's kernels on the card (counterparts of the JAX
package's ``bench/`` and of the kernel studies under ``scripts/``), and the
port's counterparts of the JAX package's scripts: the headline bench
(``headline``, the workload of the root ``bench.py``), the large-N and NDT
benchmarks (``bench_large``, ``bench_ndt``), the multi-process dry run
(``multihost_dryrun``), the sharded large-N smoke (``sharded_large``), the
fuzz (``fuzz_configs``) and the on-device guards (``guards``, checks 7, 9
and 10 of ``scripts/tpu_smoke.py``), each run as ``python -m
fpcr_tpu_torch.bench.<name>``."""
