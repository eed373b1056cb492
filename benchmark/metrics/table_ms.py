"""The Morton tables a registration (CUDA events around
``build_matcher_state``, which the traced run calls as ``run_icp``'s set-up
would), the mean over the window's calls."""

UNIT = "ms"


def read(run):
    ms = run.spans_ms.get("table")
    return sum(ms) / len(ms) if ms else None
