"""The target-normals prepass a registration (CUDA events around
``estimate_normals``, which the traced run calls as ``run_icp``'s set-up
would), the mean over the window's calls."""

UNIT = "ms"


def read(run):
    ms = run.spans_ms.get("normals")
    return sum(ms) / len(ms) if ms else None
