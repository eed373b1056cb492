"""The device's idle milliseconds a call of the traced stretch while the
host was in the entry's set-up: the program's spans ``prepare``,
``normals``, ``table`` (a table built before the call counts on it),
``source_order`` and ``bind``, each gap charged at its midpoint to the
innermost span (``benchmark/program_spans.py``)."""

from benchmark import program_spans

UNIT = "ms"


def read(run):
    return program_spans.idle_ms_per_call(run, program_spans.SETUP)
