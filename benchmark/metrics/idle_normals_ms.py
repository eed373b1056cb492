"""The device's idle milliseconds a call of the traced stretch while the
host was in the normals prepass: the program's spans ``normals``, ``knn``
(the self-kNN) and ``eig3`` (the covariances and the eigensolve), which
``estimate_normals`` records (the traced run calls it before ``run_icp``,
so its spans go with the next call), each gap charged at its midpoint to
the innermost span (``benchmark/program_spans.py``). None where the
program records no ``knn`` or ``eig3`` span (a version without them)."""

from benchmark import program_spans

UNIT = "ms"
NAMES = ("normals", "knn", "eig3")


def read(run):
    st = program_spans.read(run)
    if st is None or not any(s.name in NAMES[1:] for s, _, _ in st.spans):
        return None
    return program_spans.idle_ms_per_call(run, NAMES)
