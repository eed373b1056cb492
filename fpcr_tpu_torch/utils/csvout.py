"""CSV and JSON result emitters.

Counterpart of ``fpcr_tpu/utils/csvout.py``: the sweeps' CSV files keep the
reference's ``NUM_POINTS,TIME`` layout, so a curve of either package and of
the reference plot together, and :func:`iteration_metrics` turns a result's
per-iteration tensors (on any device) into the JAX package's records."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable, Mapping, Optional, Sequence, Union

from .device import to_numpy


def write_rows(
    path: Union[str, Path],
    rows: Iterable[Sequence],
    header: Optional[Sequence[str]] = None,
) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w") as fh:
        if header:
            fh.write(",".join(str(h) for h in header) + "\n")
        for row in rows:
            fh.write(",".join(_fmt(v) for v in row) + "\n")
    return path


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.6f}"
    return str(v)


def write_json(path: Union[str, Path], payload: Mapping) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(payload, indent=2, default=float) + "\n")
    return path


def iteration_metrics(result) -> list:
    """Per-iteration records of an ICPResult/ICPHistory/NDTResult: the
    error, its change, and where the result has them the matched fraction
    and the increment's size."""
    errors = to_numpy(result.errors)
    ni = int(result.num_iterations)

    def _series(name):  # NDT's matched fraction is one value: no series
        v = getattr(result, name, None)
        v = None if v is None else to_numpy(v)
        return None if v is None or v.ndim == 0 else v

    frac = _series("matched_fraction")
    d_t = _series("delta_t")
    d_rot = _series("delta_rot")

    records = []
    prev = None
    for i in range(ni):
        e = float(errors[i])
        rec = {
            "iteration": i,
            "rmse": e,
            "delta_rmse": None if prev is None else e - prev,
        }
        if frac is not None:
            rec["matched_fraction"] = float(frac[i])
        if d_t is not None:
            rec["delta_t"] = float(d_t[i])
        if d_rot is not None:
            rec["delta_rot"] = float(d_rot[i])
        records.append(rec)
        prev = e
    return records


_METRIC_COLUMNS = ("iteration", "rmse", "delta_rmse", "matched_fraction",
                   "delta_t", "delta_rot")


def write_iteration_metrics(path, result) -> "Path":
    recs = iteration_metrics(result)
    cols = [c for c in _METRIC_COLUMNS if not recs or c in recs[0]]
    return write_rows(
        path,
        [tuple("" if r.get(c) is None else r.get(c) for c in cols)
         for r in recs],
        header=cols,
    )
