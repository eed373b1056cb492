"""Registrations completed in the window over the window's seconds; a
batch counts each of its requests."""

UNIT = "reg/s"


def read(run):
    return len(run.latencies_s) / run.window_s if run.window_s > 0 else None
