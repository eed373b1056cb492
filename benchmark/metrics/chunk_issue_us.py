"""The host's microseconds to issue one replayed chunk: the mean duration
of the program's ``chunk`` spans whose route is ``replay`` (its state
copied in, its graph replayed, its outputs cloned out) over the traced
stretch's calls."""

from benchmark import program_spans

UNIT = "us"


def read(run):
    st = program_spans.read(run)
    if st is None:
        return None
    us = [e - s for span, s, e in st.spans
          if span.name == "chunk" and span.attrs.get("route") == "replay"]
    return sum(us) / len(us) if us else None
