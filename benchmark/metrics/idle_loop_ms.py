"""The device's idle milliseconds a call of the traced stretch while the
host was in the loop: the program's spans ``chunk`` (and its ``copy_in``,
``replay`` and ``copy_out``), ``done_read`` and ``result``, each gap
charged at its midpoint to the innermost span
(``benchmark/program_spans.py``)."""

from benchmark import program_spans

UNIT = "ms"


def read(run):
    return program_spans.idle_ms_per_call(run, program_spans.LOOP)
