"""Studies of the port's kernels on the card (counterparts of the JAX
package's ``bench/`` and of the kernel studies under ``scripts/``)."""
