"""The benchmark of ``fpcr_tpu_torch``: registrations/s and latency of its
registration entry points on the GPU, driven by the data under this
directory and ``BENCHMARK.json``; run one cell with ``python3 -m
benchmark.run``. It imports the program only to drive it, and never JAX
or the JAX package."""
