"""Annotated entry points of the port, one module per example of the JAX
package's ``examples/``, with the same sizes, configs and printed lines.

Run one as ``python -m fpcr_tpu_torch.examples.<name> [--cpu] [--quick]``:
without ``--cpu`` it runs on the CUDA card and raises if there is none;
``--quick`` shrinks the scene for fast smoke runs. Each module's
``main(argv=None)`` returns the numbers it prints.
"""
