"""Point-cloud file IO: PLY and PCD readers and writers, and a
suffix-dispatching ``load_points``.

Counterpart of ``fpcr_tpu/data/pointcloud_io.py``, numpy only: readers give
host arrays (``float32 [N, 3]``), which ``core.cloud.as_points`` puts on a
device, and writers take numpy arrays or tensors on any device. The files a
writer makes are byte for byte the JAX package's for the same arrays.

Supported:
  * PLY: ``ascii`` and ``binary_little_endian``/``binary_big_endian`` 1.0;
    all scalar vertex properties are returned, ``x/y/z`` required. Non-vertex
    elements (faces, edges) are skipped, binary list properties included
    when they precede the vertex element.
  * PCD: v0.5-0.7 header, ``ascii`` and ``binary`` data (``binary_compressed``
    is rejected with a clear error), arbitrary FIELDS with COUNT>=1;
    ``x/y/z`` required. NaN rows (PCD's invalid-point convention) are
    dropped with ``drop_invalid=True`` (default).
  * CSV/XYZ/TXT via ``load_points``: delimiter auto-detected among
    ``,`` / ``;`` / whitespace, an optional header row skipped.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from ..utils.device import to_numpy

__all__ = [
    "read_ply",
    "write_ply",
    "read_pcd",
    "write_pcd",
    "load_points",
]

# PLY scalar property name -> numpy dtype character (little-endian applied
# per file format line)
_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def _ply_parse_header(fh) -> Tuple[str, list]:
    """Returns (fmt, elements) where elements is a list of
    (name, count, [(prop_name, dtype_str) or ('list', idx_dt, val_dt, name)]).
    """
    magic = fh.readline().strip()
    if magic != b"ply":
        raise ValueError("not a PLY file (missing 'ply' magic)")
    fmt = None
    elements = []  # (name, count, props)
    while True:
        line = fh.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        tokens = line.decode("ascii", "replace").strip().split()
        if not tokens or tokens[0] == "comment" or tokens[0] == "obj_info":
            continue
        if tokens[0] == "format":
            if len(tokens) < 3 or tokens[2] != "1.0":
                raise ValueError(f"unsupported PLY format line: {tokens}")
            fmt = tokens[1]
            if fmt not in ("ascii", "binary_little_endian",
                           "binary_big_endian"):
                raise ValueError(f"unsupported PLY format {fmt!r}")
        elif tokens[0] == "element":
            elements.append((tokens[1], int(tokens[2]), []))
        elif tokens[0] == "property":
            if not elements:
                raise ValueError("PLY property before any element")
            if tokens[1] == "list":
                # property list <index-type> <value-type> <name>
                elements[-1][2].append(
                    ("list", _PLY_DTYPES[tokens[2]], _PLY_DTYPES[tokens[3]],
                     tokens[4]))
            else:
                elements[-1][2].append((tokens[-1], _PLY_DTYPES[tokens[1]]))
        elif tokens[0] == "end_header":
            break
        else:
            raise ValueError(f"unrecognized PLY header line: {tokens}")
    if fmt is None:
        raise ValueError("PLY header has no format line")
    return fmt, elements


def _ply_skip_binary_element(fh, count, props, endian):
    """Advance past a non-vertex binary element (may hold list properties)."""
    scalar = all(p[0] != "list" for p in props)
    if scalar:
        row = sum(np.dtype(p[1]).itemsize for p in props)
        fh.seek(count * row, os.SEEK_CUR)
        return
    for _ in range(count):
        for p in props:
            if p[0] == "list":
                _, idx_dt, val_dt, _name = p
                n = int(np.frombuffer(fh.read(np.dtype(idx_dt).itemsize),
                                      dtype=endian + idx_dt)[0])
                fh.seek(n * np.dtype(val_dt).itemsize, os.SEEK_CUR)
            else:
                fh.seek(np.dtype(p[1]).itemsize, os.SEEK_CUR)


def read_ply(path, *, dtype=np.float32
             ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Read a PLY file. Returns ``(points [N,3] dtype, extras)`` where
    ``extras`` maps every additional scalar vertex property (``nx``,
    ``red``, ``intensity``, ...) to its ``[N]`` array."""
    with open(path, "rb") as fh:
        fmt, elements = _ply_parse_header(fh)
        endian = {"ascii": "=", "binary_little_endian": "<",
                  "binary_big_endian": ">"}[fmt]
        vertex = None
        for name, count, props in elements:
            if name == "vertex":
                if any(p[0] == "list" for p in props):
                    raise ValueError("list properties on the vertex element "
                                     "are not supported")
                vertex = (count, props)
                break
            # vertex not yet reached: skip this element's data region
            if fmt == "ascii":
                for _ in range(count):
                    fh.readline()
            else:
                _ply_skip_binary_element(fh, count, props, endian)
        if vertex is None:
            raise ValueError("PLY file has no vertex element")
        count, props = vertex
        rec = np.dtype([(n, endian + dt) for n, dt in props])
        if fmt == "ascii":
            rows = np.loadtxt(
                (fh.readline() for _ in range(count)),
                dtype=np.float64, ndmin=2)
            if rows.shape != (count, len(props)):
                raise ValueError(
                    f"PLY vertex data shape {rows.shape} != "
                    f"({count}, {len(props)})")
            data = {n: rows[:, i].astype(dt)
                    for i, (n, dt) in enumerate(props)}
        else:
            raw = fh.read(count * rec.itemsize)
            if len(raw) != count * rec.itemsize:
                raise ValueError("PLY vertex data truncated")
            arr = np.frombuffer(raw, dtype=rec)
            data = {n: np.ascontiguousarray(arr[n]) for n, _ in props}
    for axis in ("x", "y", "z"):
        if axis not in data:
            raise ValueError(f"PLY vertex element lacks property {axis!r}")
    points = np.stack([data.pop("x"), data.pop("y"), data.pop("z")],
                      axis=1).astype(dtype)
    return points, data


def _extras_columns(extras, n) -> list:
    """Validate an extras dict ({name: [N] scalar array}) into
    [(name, float32 column)] — float lanes keep read→write round-trips
    (intensity, colors, normals-as-extras) lossless for f32 data."""
    cols = []
    for name, arr in (extras or {}).items():
        a = to_numpy(arr)
        if a.shape != (n,):
            raise ValueError(
                f"extra property {name!r} must be [N]={n}, got {a.shape}")
        cols.append((str(name), a.astype(np.float32)))
    return cols


def write_ply(path, points, *, normals=None, extras=None,
              binary: bool = True, comment: Optional[str] = None) -> None:
    """Write ``points [N,3]`` (optional ``normals [N,3]`` and ``extras``
    — a dict of per-point scalar properties, e.g. from ``read_ply``) as
    PLY float properties."""
    pts = to_numpy(points).astype(np.float32, copy=False)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"points must be [N,3], got {pts.shape}")
    norms = None
    if normals is not None:
        norms = to_numpy(normals).astype(np.float32, copy=False)
        if norms.shape != pts.shape:
            raise ValueError("normals must match points shape")
    extra_cols = _extras_columns(extras, pts.shape[0])
    names = (["x", "y", "z"]
             + (["nx", "ny", "nz"] if norms is not None else [])
             + [n for n, _ in extra_cols])
    header = ["ply",
              "format binary_little_endian 1.0" if binary
              else "format ascii 1.0"]
    if comment:
        header.append(f"comment {comment}")
    header.append(f"element vertex {pts.shape[0]}")
    header += [f"property float {n}" for n in names]
    header.append("end_header")
    parts = [pts]
    if norms is not None:
        parts.append(norms)
    parts += [c[:, None] for _, c in extra_cols]
    table = np.concatenate(parts, axis=1) if len(parts) > 1 else pts
    with open(path, "wb") as fh:
        fh.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            fh.write(np.ascontiguousarray(table, dtype="<f4").tobytes())
        else:
            np.savetxt(fh, table, fmt="%.9g")


_PCD_TYPE = {("F", 4): "f4", ("F", 8): "f8",
             ("I", 1): "i1", ("I", 2): "i2", ("I", 4): "i4",
             ("U", 1): "u1", ("U", 2): "u2", ("U", 4): "u4"}


def read_pcd(path, *, dtype=np.float32, drop_invalid: bool = True
             ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Read a PCD file. Returns ``(points [N,3] dtype, extras)``; NaN rows
    (PCL's invalid-point marker in organized clouds) are dropped unless
    ``drop_invalid=False``."""
    header: Dict[str, list] = {}
    with open(path, "rb") as fh:
        while True:
            line = fh.readline()
            if not line:
                raise ValueError("unterminated PCD header (no DATA line)")
            text = line.decode("ascii", "replace").strip()
            if not text or text.startswith("#"):
                continue
            key, *vals = text.split()
            header[key.upper()] = vals
            if key.upper() == "DATA":
                break
        for req in ("FIELDS", "SIZE", "TYPE", "DATA"):
            if req not in header:
                raise ValueError(f"PCD header lacks {req}")
        fields = header["FIELDS"]
        sizes = [int(s) for s in header["SIZE"]]
        types = header["TYPE"]
        counts = [int(c) for c in header.get("COUNT", ["1"] * len(fields))]
        if not (len(fields) == len(sizes) == len(types) == len(counts)):
            raise ValueError("PCD FIELDS/SIZE/TYPE/COUNT lengths disagree")
        if "POINTS" in header:
            n = int(header["POINTS"][0])
        else:
            n = (int(header["WIDTH"][0]) * int(header.get("HEIGHT", ["1"])[0])
                 if "WIDTH" in header else -1)
        mode = header["DATA"][0].lower()
        # expand COUNT>1 fields into name_0, name_1, ...
        cols = []  # (name, dtype)
        for f, s, t, c in zip(fields, sizes, types, counts):
            dt = _PCD_TYPE.get((t, s))
            if dt is None:
                raise ValueError(f"unsupported PCD field type {t}{s}")
            if c == 1:
                cols.append((f, dt))
            else:
                cols += [(f"{f}_{i}", dt) for i in range(c)]
        if mode == "ascii":
            rows = np.loadtxt(fh, dtype=np.float64, ndmin=2)
            if n >= 0 and rows.shape[0] != n:
                raise ValueError(f"PCD POINTS={n} but {rows.shape[0]} rows")
            if rows.shape[1] != len(cols):
                raise ValueError(
                    f"PCD row width {rows.shape[1]} != {len(cols)} fields")
            data = {name: rows[:, i].astype(dt)
                    for i, (name, dt) in enumerate(cols)}
        elif mode == "binary":
            rec = np.dtype([(name, "<" + dt) for name, dt in cols])
            if n < 0:
                raise ValueError("binary PCD needs POINTS or WIDTH/HEIGHT")
            raw = fh.read(n * rec.itemsize)
            if len(raw) != n * rec.itemsize:
                raise ValueError("PCD binary data truncated")
            arr = np.frombuffer(raw, dtype=rec)
            data = {name: np.ascontiguousarray(arr[name])
                    for name, _ in cols}
        elif mode == "binary_compressed":
            raise ValueError(
                "binary_compressed PCD (LZF) is not supported; re-save the "
                "file as ascii or binary (e.g. "
                "`pcl_convert_pcd_ascii_binary`)")
        else:
            raise ValueError(f"unknown PCD DATA mode {mode!r}")
    for axis in ("x", "y", "z"):
        if axis not in data:
            raise ValueError(f"PCD lacks field {axis!r}")
    points = np.stack([data.pop("x"), data.pop("y"), data.pop("z")],
                      axis=1).astype(dtype)
    if drop_invalid:
        keep = np.isfinite(points).all(axis=1)
        if not keep.all():
            points = points[keep]
            data = {k: v[keep] for k, v in data.items()}
    return points, data


def write_pcd(path, points, *, extras=None, binary: bool = True) -> None:
    """Write ``points [N,3]`` (plus optional ``extras`` scalar fields) as a
    PCD v0.7 file (unorganized)."""
    pts = to_numpy(points).astype(np.float32, copy=False)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"points must be [N,3], got {pts.shape}")
    n = pts.shape[0]
    extra_cols = _extras_columns(extras, n)
    fields = ["x", "y", "z"] + [name for name, _ in extra_cols]
    k = len(fields)
    header = "\n".join([
        "# .PCD v0.7 - Point Cloud Data file format",
        "VERSION 0.7",
        f"FIELDS {' '.join(fields)}",
        f"SIZE {' '.join(['4'] * k)}",
        f"TYPE {' '.join(['F'] * k)}",
        f"COUNT {' '.join(['1'] * k)}",
        f"WIDTH {n}",
        "HEIGHT 1",
        "VIEWPOINT 0 0 0 1 0 0 0",
        f"POINTS {n}",
        f"DATA {'binary' if binary else 'ascii'}",
    ]) + "\n"
    table = (np.concatenate([pts] + [c[:, None] for _, c in extra_cols],
                            axis=1) if extra_cols else pts)
    with open(path, "wb") as fh:
        fh.write(header.encode("ascii"))
        if binary:
            fh.write(np.ascontiguousarray(table, dtype="<f4").tobytes())
        else:
            np.savetxt(fh, table, fmt="%.9g")


def _read_delimited(path, dtype) -> np.ndarray:
    """CSV / XYZ / TXT: delimiter auto-detected (``,`` / ``;`` /
    whitespace), an optional non-numeric header row skipped — covers both
    reference CSV dialects (Bunny.csv ``x;y;z``, Bunny_res.csv spaces)."""
    with open(path, "r", encoding="utf-8", errors="replace") as fh:
        first = fh.readline()
        second = fh.readline()
    probe = second or first
    delim = None
    if ";" in probe:
        delim = ";"
    elif "," in probe:
        delim = ","
    skip = 0
    try:
        [float(tok) for tok in
         (first.replace(delim, " ") if delim else first).split()]
    except ValueError:
        skip = 1
    rows = np.loadtxt(path, delimiter=delim, skiprows=skip, ndmin=2)
    if rows.shape[1] < 3:
        raise ValueError(f"{path}: expected >=3 columns, got {rows.shape[1]}")
    return rows[:, :3].astype(dtype)


def load_points(path, *, dtype=np.float32) -> np.ndarray:
    """Load ``[N,3]`` points from a file, dispatching on the suffix:
    ``.ply`` / ``.pcd`` / anything else as delimited text (csv/xyz/txt)."""
    suffix = os.path.splitext(str(path))[1].lower()
    if suffix == ".ply":
        return read_ply(path, dtype=dtype)[0]
    if suffix == ".pcd":
        return read_pcd(path, dtype=dtype)[0]
    return _read_delimited(path, dtype)
