"""Seconds from the process's start to the window's first call: the
interpreter's start, imports, the kernels' build or load, the clouds, the
request pool, the warm-up and the graph captures."""

UNIT = "s"


def read(run):
    return run.setup_s
