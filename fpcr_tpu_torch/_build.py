"""Build the package's CUDA kernels at first use and load them with ctypes.

The sources under ``csrc/`` have a plain C interface and include no PyTorch
header, so ``nvcc`` compiles each in seconds. One ``nvcc`` per source runs
at the same time, and a last one links the objects into one library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler \
         -fPIC -Xptxas -v -c csrc/<name>.cu -o <name>.o       (each source)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o \
         _build/libfpcr_kernels_<key>.so *.o

The library lands in ``fpcr_tpu_torch/_build/`` (listed in ``.gitignore``)
under a name keyed by a hash of the sources and flags, so an edited source
is rebuilt and an unchanged one is loaded as it is. Importing the package
builds nothing; :func:`load_library` builds on its first call. ``nvcc`` is
found through ``CUDA_HOME``/``CUDA_PATH``, then ``PATH``, then
``/usr/local/cuda``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple, Optional

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]


class BuildResult(NamedTuple):
    path: Path
    seconds: float  # nvcc wall time; 0 when the library was already built
    cached: bool
    log: str  # nvcc's output, with ptxas' registers and spills per kernel


_lib: Optional[ctypes.CDLL] = None

# every launch counter of the package, registered where its wrapper is
# defined (:func:`counted`): ``utils/graphs.py`` reads them over a capture
# and adds a captured graph's launches to them at each replay
COUNTED: list = []


def counted(fn, launches=0):
    """Give the wrapper ``fn`` its launch counter ``fn.launches`` (an int,
    or a dict of ints keyed by launch type) and register it in
    :data:`COUNTED`; ``fn`` adds to the counter where it launches. A replay
    of a captured graph adds the launches its capture made, those of the
    conditional blocks that the replay skips included
    (``utils/graphs.py::skip_if_all``): a counter counts launches issued,
    which the device runs unless their block is skipped."""
    fn.launches = launches
    COUNTED.append(fn)
    return fn


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def build_key() -> str:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _run_all(cmds) -> list:
    """Run the commands at the same time; ``[(cmd, returncode, output)]``."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    results = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        results.append((cmd, proc.returncode, out))
    return results


def build() -> BuildResult:
    """Compile ``csrc/*.cu`` unless a library with the same key exists."""
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    key = build_key()
    out = BUILD_DIR / f"libfpcr_kernels_{key}.so"
    log_path = BUILD_DIR / f"libfpcr_kernels_{key}.log"
    if out.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return BuildResult(out, 0.0, True, log)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    # objects and the library go to temporary names and the library is
    # renamed at the end: a reader never sees half a library, and two
    # processes building at once both end with a whole one
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in srcs]
        steps = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                          for src, obj in zip(srcs, objs)])
        lib_tmp = Path(tmp) / "lib.so"
        if all(rc == 0 for _, rc, _ in steps):
            steps += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o",
                                str(lib_tmp), *map(str, objs)]])
        log = "".join(f"$ {' '.join(cmd)}\n{text}" for cmd, _, text in steps)
        failed = [(cmd, rc) for cmd, rc, _ in steps if rc != 0]
        if failed:
            raise RuntimeError(f"nvcc failed ({failed[0][1]}): "
                               f"{' '.join(failed[0][0])}\n{log}")
        log_path.write_text(log)
        os.replace(lib_tmp, out)
    return BuildResult(out, time.perf_counter() - t0, False, log)


def load_library() -> ctypes.CDLL:
    """Build if needed, load once, and declare every C function's types."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build().path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fpcr_nn_rows_per_block.argtypes = []
    lib.fpcr_nn_rows_per_block.restype = i32
    lib.fpcr_nn_partial.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr, ptr,
                                    ptr]
    lib.fpcr_nn_partial.restype = i32
    lib.fpcr_nn_combine.argtypes = [ptr, ptr, i32, i32, ptr, ptr, ptr]
    lib.fpcr_nn_combine.restype = i32
    lib.fpcr_nn_packed_partial.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32,
                                           ptr, ptr]
    lib.fpcr_nn_packed_partial.restype = i32
    lib.fpcr_nn_packed_epilogue.argtypes = [ptr, ptr, ptr, i32, i32, i32,
                                            i32, ptr, ptr, ptr]
    lib.fpcr_nn_packed_epilogue.restype = i32
    lib.fpcr_nn_min_partial.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr,
                                        ptr]
    lib.fpcr_nn_min_partial.restype = i32
    lib.fpcr_nn_min_combine.argtypes = [ptr, i32, i32, ptr, ptr]
    lib.fpcr_nn_min_combine.restype = i32
    lib.fpcr_nn_tc_rows_per_block.argtypes = []
    lib.fpcr_nn_tc_rows_per_block.restype = i32
    lib.fpcr_nn_tc_sweep.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, i32,
                                     ptr, ptr, ptr, ptr]
    lib.fpcr_nn_tc_sweep.restype = i32
    lib.fpcr_nn_tc_finish.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                                      i32, i32, i32, i32, ptr, ptr, ptr, ptr]
    lib.fpcr_nn_tc_finish.restype = i32
    for name in ("fpcr_morton_nn", "fpcr_morton_nn_packed",
                 "fpcr_morton_nn_unculled", "fpcr_morton_nn_packed_unculled"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, i32, i32, ptr, i32, ptr, ptr, ptr, ptr, ptr, i32,
                       i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr]
        fn.restype = i32
    lib.fpcr_nn_form_partial.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32,
                                         i32, i32, i32, ptr, ptr, ptr]
    lib.fpcr_nn_form_partial.restype = i32
    lib.fpcr_nn_forms_rows_per_block.argtypes = []
    lib.fpcr_nn_forms_rows_per_block.restype = i32
    lib.fpcr_nn_forms_max_slice.argtypes = []
    lib.fpcr_nn_forms_max_slice.restype = i32
    lib.fpcr_nn_forms_partial.argtypes = [ptr] * 5 + [i32] * 7 + [ptr] * 3
    lib.fpcr_nn_forms_partial.restype = i32
    lib.fpcr_nn_forms_finish.argtypes = [ptr] * 4 + [i32] * 6 + [ptr] * 5
    lib.fpcr_nn_forms_finish.restype = i32
    lib.fpcr_split_rows_per_block.argtypes = []
    lib.fpcr_split_rows_per_block.restype = i32
    lib.fpcr_split_partial.argtypes = [ptr, ptr, i32, i32, i32, i32, i32,
                                       i32, i32, ptr, ptr, ptr]
    lib.fpcr_split_partial.restype = i32
    lib.fpcr_split_combine.argtypes = [ptr, ptr, i32, i32, i32, i32, ptr,
                                       ptr, ptr]
    lib.fpcr_split_combine.restype = i32
    lib.fpcr_split_wgmma_rows_per_block.argtypes = []
    lib.fpcr_split_wgmma_rows_per_block.restype = i32
    lib.fpcr_split_wgmma.argtypes = [ptr, ptr] + [i32] * 10 + [ptr, ptr, ptr]
    lib.fpcr_split_wgmma.restype = i32
    lib.fpcr_split_wgmma_combine.argtypes = [ptr, ptr, i32, i32, i32, i32,
                                             ptr, ptr, ptr]
    lib.fpcr_split_wgmma_combine.restype = i32
    f32 = ctypes.c_float
    lib.fpcr_ndt_moments.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, ptr, ptr,
                                     i32, i32, i32, i32, i32, f32, f32, ptr,
                                     ptr, ptr]
    lib.fpcr_ndt_moments.restype = i32
    lib.fpcr_svd3_rotation.argtypes = [ptr, i32, i32, ptr, ptr]
    lib.fpcr_svd3_rotation.restype = i32
    lib.fpcr_svd3_umeyama.argtypes = [ptr, i32, ptr, ptr, ptr]
    lib.fpcr_svd3_umeyama.restype = i32
    lib.fpcr_svd3_fixed_rotation.argtypes = [ptr, i32, i32, ptr, ptr]
    lib.fpcr_svd3_fixed_rotation.restype = i32
    lib.fpcr_svd3_fixed_umeyama.argtypes = [ptr, i32, ptr, ptr, ptr]
    lib.fpcr_svd3_fixed_umeyama.restype = i32
    lib.fpcr_svd3_ablation.argtypes = [ptr, i32, i32, ptr, ptr]
    lib.fpcr_svd3_ablation.restype = i32
    lib.fpcr_eig3.argtypes = [ptr, i32, ptr, ptr, ptr]
    lib.fpcr_eig3.restype = i32
    lib.fpcr_graph_add_if.argtypes = [ptr, ptr, i32, ptr, ptr]
    lib.fpcr_graph_add_if.restype = i32
    lib.fpcr_graph_add_child.argtypes = [ptr, ptr]
    lib.fpcr_graph_add_child.restype = i32
    lib.fpcr_graph_capture_begin.argtypes = [ptr]
    lib.fpcr_graph_capture_begin.restype = i32
    lib.fpcr_graph_capture_end.argtypes = [ptr, i32,
                                           ctypes.POINTER(ctypes.c_void_p)]
    lib.fpcr_graph_capture_end.restype = i32
    lib.fpcr_graph_launch.argtypes = [ptr, ptr]
    lib.fpcr_graph_launch.restype = i32
    lib.fpcr_graph_destroy.argtypes = [ptr]
    lib.fpcr_graph_destroy.restype = i32
    lib.fpcr_cuda_error_string.argtypes = [i32]
    lib.fpcr_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib
