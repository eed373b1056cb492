"""The share of the profiled stretch in which no kernel, copy or fill ran
on the device: 1 - (union of the device events' intervals) / (the stretch
between its two spin kernels), in percent."""

from benchmark import tracing

UNIT = "%"


def read(run):
    tr = run.trace
    if tr is None or tr.end_us <= tr.start_us:
        return None
    return 100.0 * (1.0 - tracing.busy_us(tr) / (tr.end_us - tr.start_us))
