"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program: top-level module names compared
whole (the port's name starts with the JAX package's)."""

import ast
import subprocess
import sys

from benchmark.run import FORBIDDEN
from benchmark.spec import ROOT

BENCH = ROOT / "benchmark"


def _imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_no_jax():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not _imported(path) & set(FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        assert not _imported(path) & {"fpcr_tpu_torch", *FORBIDDEN}, path


def _modules_after(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in "
                          "sys.modules}))"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_process_loads_no_jax():
    mods = _modules_after(
        "import benchmark.run, benchmark.control, fpcr_tpu_torch\n"
        "from benchmark.spec import load_cell, load_module\n"
        "import fpcr_tpu_torch.models.icp, fpcr_tpu_torch.utils.graphs\n"
        "for cell in ('hall-point-seq', 'hall-point-batch32'):\n"
        "    c = load_cell(cell)\n"
        "    load_module(c, 'drivers', c.traffic['driver'])\n"
        "    [load_module(c, 'metrics', m) for m in c.end_to_end "
        "+ c.per_layer]\n")
    assert "fpcr_tpu_torch" in mods
    assert not mods & set(FORBIDDEN)


def test_reference_process_loads_no_program():
    mods = _modules_after("import benchmark.reference.check")
    assert not mods & {"fpcr_tpu_torch", *FORBIDDEN}
