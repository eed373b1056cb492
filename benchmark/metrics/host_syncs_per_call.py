"""The host's reads of device values a call, inside ``run_icp`` /
``register_batch``: the mean over the traced stretch's calls of the
``syncs`` count the program keeps on each call's root span (a done read
before every chunk but the first, and any other read on the path)."""

from benchmark import program_spans

UNIT = "syncs"


def read(run):
    st = program_spans.read(run)
    if st is None:
        return None
    return sum(c.attrs.get("syncs", 0) for c in st.calls) / len(st.calls)
