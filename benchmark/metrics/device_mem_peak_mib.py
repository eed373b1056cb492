"""``torch.cuda.max_memory_reserved()`` once the window has closed, over
the whole process: set-up, the graphs' pools and the window."""

UNIT = "MiB"


def read(run):
    if run.memory_peak_bytes is None:
        return None
    return run.memory_peak_bytes / 2 ** 20
