"""The entry's device time an iteration: CUDA events around each
``run_icp`` / ``register_batch`` call, summed over the window, over the
iterations the calls ran (a batch: its largest element's)."""

UNIT = "ms"


def read(run):
    ms = run.spans_ms.get("entry")
    iters = sum(max(its) for its in run.iterations[:len(ms or [])])
    return sum(ms) / iters if ms and iters else None
