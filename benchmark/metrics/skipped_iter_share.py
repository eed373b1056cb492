"""The share of the iterations replayed in captured chunks whose kernels
did not run, the loop having stopped: 100 × Σ ``iterations_skipped`` / Σ
``iterations_run`` over the traced stretch's calls, the counts the program
keeps on each call's root span (a chunk of 8 iterations, each in a
conditional node that runs while some element is not done). None where
the calls carry no such counts (a program without them)."""

from benchmark import program_spans

UNIT = "%"


def read(run):
    st = program_spans.read(run)
    if st is None:
        return None
    ran = sum(c.attrs.get("iterations_run", 0) for c in st.calls)
    if not ran:
        return None
    skipped = sum(c.attrs.get("iterations_skipped", 0) for c in st.calls)
    return 100.0 * skipped / ran
