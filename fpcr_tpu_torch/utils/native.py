"""Loader of the native C++ tokenizers (``csrc/fpcr_io.cc``), built at
first use.

Counterpart of ``fpcr_tpu/utils/native.py``. The extension is a CPython
module, not a CUDA source: the host C++ compiler (``$CXX``, else ``g++``)
builds it once into ``fpcr_tpu_torch/_build/`` (listed in ``.gitignore``),
where the kernels' library also lands; ``_build.py`` compiles the ``*.cu``
sources only, so ``nvcc`` never sees this one. Importing the module builds
nothing.

Callers (``data/bunny.py``, ``data/ouster.py``) fall back to numpy parsing
on any failure, as in the JAX package, so the package never needs the
toolchain; the parsers raise rather than return a truncated result, so the
native path never diverges from the fallback silently. The compile writes
to a temporary name and renames on success (a killed compiler leaves no
corrupt library), and the first build and import hold a lock.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sysconfig
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
_BUILD_DIR = _PKG / "_build"
_SOURCE = _PKG / "csrc" / "fpcr_io.cc"

_module = None
_build_attempted = False
_lock = threading.Lock()


def _so_path() -> Path:
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return _BUILD_DIR / f"_fpcr_io{suffix}"


def _build() -> Optional[Path]:
    so = _so_path()
    if not _SOURCE.exists():
        # an installation shipping only the built extension: use it
        return so if so.exists() else None
    if so.exists() and so.stat().st_mtime >= _SOURCE.stat().st_mtime:
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(so.name + f".tmp{os.getpid()}")
    cmd = [os.environ.get("CXX", "g++"), "-O2", "-shared", "-fPIC",
           "-std=c++17", f"-I{sysconfig.get_paths()['include']}",
           str(_SOURCE), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)  # atomic: never a half-linked library at `so`
    finally:
        if tmp.exists():
            tmp.unlink()
    return so


def _load():
    global _module, _build_attempted
    if _module is not None or _build_attempted:
        return _module
    with _lock:
        if _module is not None or _build_attempted:
            return _module
        _build_attempted = True
        try:
            so = _build()
            if so is None:
                return None
            # import by file path, with no change to sys.path
            spec = importlib.util.spec_from_file_location("_fpcr_io", so)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _module = mod
        except Exception:
            _module = None
        return _module


def available() -> bool:
    return _load() is not None


def read_xyz(path: str) -> np.ndarray:
    """Parse an ``x y z`` cloud file (whitespace, ';' or ',' separated)
    into a read-only ``[N, 3]`` float32 array. Raises on any failure
    (callers fall back to numpy)."""
    mod = _load()
    if mod is None:
        raise RuntimeError("native IO extension unavailable")
    arr = np.frombuffer(mod.parse_floats(str(path)), dtype="<f4")
    if arr.size % 3 != 0:
        raise ValueError(f"{path}: token count {arr.size} not divisible by 3")
    return arr.reshape(-1, 3)


def read_int_lines(path: str) -> np.ndarray:
    """Parse every integer token (the Ouster packet byte dump) into an
    int64 array."""
    mod = _load()
    if mod is None:
        raise RuntimeError("native IO extension unavailable")
    return np.frombuffer(mod.parse_ints(str(path)), dtype="<i8")
