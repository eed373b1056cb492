"""Failure detection and numerical diagnostics.

Counterpart of ``fpcr_tpu/utils/diagnostics.py``: :func:`validate_result`
checks a result for a non-finite or improper transform and a non-finite
error sequence, and :func:`debug_nans` is the scoped NaN check.

JAX's ``debug_nans`` sets ``jax_debug_nans``, which raises at the operation
that made the first NaN. PyTorch has no such switch for forward operations,
so here the flag is read by the registration loops (``models/icp.py::
run_icp`` and ``models/ndt.py::run_ndt``, the sharded loops included): while
it is set, a loop raises ``FloatingPointError`` at the first iteration whose
error is not finite. It catches at the granularity of an iteration, not of
an operation, and a NaN that a loop's own guard absorbs (a failed Cholesky
gives the identity update) is not reported. Each checked iteration reads its
error on the host, one synchronisation an iteration, and only while the flag
is set.
"""

from __future__ import annotations

import contextlib
from typing import List

import numpy as np
import torch

from .device import to_numpy


class RegistrationError(RuntimeError):
    """Raised when a registration result fails validation."""


def validate_result(result, *, require_converged: bool = False,
                    context: str = "icp") -> List[str]:
    """Check an ICPResult/ICPHistory/NDTResult for failures. Returns a list
    of issue strings; raises RegistrationError if any are fatal (a
    non-finite transform or error sequence, a reflection)."""
    issues: List[str] = []
    rot = to_numpy(result.transform.rotation)
    tra = to_numpy(result.transform.translation)
    if not np.isfinite(rot).all() or not np.isfinite(tra).all():
        issues.append("non-finite transform")
    else:
        ortho = np.abs(rot @ rot.T - np.eye(3)).max()
        if ortho > 1e-3:
            issues.append(f"rotation not orthogonal (|RRᵀ-I|={ortho:.2e})")
        det = float(np.linalg.det(rot))
        if det < 0:
            issues.append(f"reflection (det={det:.3f})")
    errors = to_numpy(result.errors)
    ni = int(result.num_iterations)
    if ni and not np.isfinite(errors[:ni]).all():
        issues.append("non-finite error sequence")
    if require_converged and not bool(result.converged):
        issues.append(f"did not converge in {ni} iterations")

    fatal = [i for i in issues if "non-finite" in i or "reflection" in i]
    if fatal:
        raise RegistrationError(f"{context}: " + "; ".join(issues))
    return issues


_debug_nans = False


def nans_checked() -> bool:
    """Whether :func:`debug_nans` is in force."""
    return _debug_nans


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """While in force, ``run_icp`` and ``run_ndt`` raise
    ``FloatingPointError`` at the first iteration whose error is not
    finite (see the module's notes for how this differs from JAX's)."""
    global _debug_nans
    prev = _debug_nans
    _debug_nans = prev or enable
    try:
        yield
    finally:
        _debug_nans = prev


def check_iteration(error: torch.Tensor, active: torch.Tensor,
                    iteration: int, context: str) -> None:
    """Raise ``FloatingPointError`` when an iteration that ran gave a
    non-finite error; a no-op unless :func:`debug_nans` is in force."""
    if _debug_nans and bool(active & ~torch.isfinite(error)):
        raise FloatingPointError(
            f"{context}: non-finite error at iteration {iteration}")
