"""The port's file I/O (``data/pointcloud_io.py``), native tokenizers
(``utils/native.py``, ``csrc/fpcr_io.cc``), output and diagnostics
(``utils/csvout.py``, ``utils/diagnostics.py``), sweeps
(``bench/sweeps.py``) and CLI (``cli.py``) against the JAX package's, on
the CPU.

Tolerances, test by test: written files byte for byte the JAX package's;
readers, the native tokenizers and the numpy fallback equal arrays (bit for
bit: the same parse of the same text); ``iteration_metrics`` and
``validate_result`` equal records and issues for the same result numbers;
the CLI's error sequence within 1e-5 (absolute) of JAX's CLI with the same
arguments, the bound of ``tests/test_torch_icp.py``'s per-iteration
errors, and its iteration count equal, or one apart where the later run had
converged to float32 noise (error below 1e-5, ``chip_smoke.py``'s
``STOP_NOISE``) at the earlier stop: the stop test then lands on noise
(ROADMAP.md §3; the point run here stops at 9 against JAX's 10, both at
~1e-6). The plane metric is left out of the 1e-5 comparison: on the regular
synthetic grid the two packages' kNN decide a few near-ties differently and
those points get another normal (``tests/test_torch_normals.py``), which
moves the error by ~1e-2 for a few iterations; its run is held to its
ground truth.
"""

import json

import numpy as np
import pytest
import torch

import fpcr_tpu_torch as ft
from fpcr_tpu.data import pointcloud_io as jio
from fpcr_tpu_torch.data import pointcloud_io as tio

torch.set_num_threads(2)

ATOL = 1e-5
NOISE = 1e-5


@pytest.fixture(scope="module")
def cloud():
    return np.random.default_rng(3).normal(size=(57, 3)).astype(np.float32)


# --- file I/O --------------------------------------------------------------

WRITES = [
    ("ply", dict(binary=True)),
    ("ply", dict(binary=False)),
    ("ply", dict(binary=True, normals=True, extras=True,
                 comment="fpcr_tpu registered source cloud")),
    ("ply", dict(binary=False, normals=True, extras=True)),
    ("pcd", dict(binary=True)),
    ("pcd", dict(binary=False)),
    ("pcd", dict(binary=True, extras=True)),
    ("pcd", dict(binary=False, extras=True)),
]


@pytest.mark.parametrize("fmt,kw", WRITES)
def test_writers_write_the_jax_packages_bytes(tmp_path, cloud, fmt, kw):
    """Byte-equal files for the same arrays; the port's writer also takes a
    tensor."""
    kw = dict(kw)
    rng = np.random.default_rng(5)
    if kw.pop("normals", False):
        kw["normals"] = rng.normal(size=cloud.shape).astype(np.float32)
    if kw.pop("extras", False):
        kw["extras"] = {"intensity": rng.uniform(size=cloud.shape[0]),
                        "ring": np.arange(cloud.shape[0])}
    writer = {"ply": (tio.write_ply, jio.write_ply),
              "pcd": (tio.write_pcd, jio.write_pcd)}[fmt]
    ours, theirs = tmp_path / f"a.{fmt}", tmp_path / f"b.{fmt}"
    writer[0](ours, torch.as_tensor(cloud), **kw)
    writer[1](theirs, cloud, **kw)
    assert ours.read_bytes() == theirs.read_bytes()


def _special_files(tmp_path, cloud):
    """Files of every reader's branches: (path, reader name)."""
    paths = []
    for i, (fmt, kw) in enumerate(WRITES):
        p = tmp_path / f"w{i}.{fmt}"
        kw = {k: v for k, v in kw.items() if k in ("binary", "comment")}
        (jio.write_ply if fmt == "ply" else jio.write_pcd)(p, cloud, **kw)
        paths.append(p)
    rec = np.dtype([("x", ">f8"), ("y", ">f8"), ("z", ">f8"),
                    ("red", ">u1")])
    arr = np.zeros(2, dtype=rec)
    arr["x"], arr["y"], arr["z"], arr["red"] = (1.0, 4.0), (2.0, 5.0), \
        (3.0, 6.0), (7, 9)
    p = tmp_path / "be.ply"
    p.write_bytes(b"ply\nformat binary_big_endian 1.0\nelement vertex 2\n"
                  b"property double x\nproperty double y\nproperty double "
                  b"z\nproperty uchar red\nend_header\n" + arr.tobytes())
    paths.append(p)
    p = tmp_path / "fb.ply"
    p.write_bytes(b"ply\nformat binary_little_endian 1.0\nelement face 1\n"
                  b"property list uchar int vertex_indices\n"
                  b"element vertex 2\nproperty float x\nproperty float y\n"
                  b"property float z\nend_header\n" + b"\x03"
                  + np.array([0, 1, 2], "<i4").tobytes()
                  + np.array([[1, 2, 3], [4, 5, 6]], "<f4").tobytes())
    paths.append(p)
    p = tmp_path / "nan.pcd"
    pts = np.array([[1, 2, 3], [np.nan, 0, 0], [4, 5, 6]], np.float32)
    p.write_text("# c\nVERSION 0.7\nFIELDS x y z pair\nSIZE 4 4 4 4\n"
                 "TYPE F F F F\nCOUNT 1 1 1 2\nWIDTH 3\nHEIGHT 1\nPOINTS 3\n"
                 "DATA ascii\n" + "\n".join(
                     " ".join(str(v) for v in row) + " 8 9" for row in pts)
                 + "\n")
    paths.append(p)
    for name, delim, header in (("c.csv", ",", "x,y,z\n"), ("s.csv", ";", ""),
                                ("w.xyz", " ", ""), ("t.txt", "\t", "")):
        p = tmp_path / name
        p.write_text(header + "\n".join(delim.join(f"{v:.9g}" for v in row)
                                        for row in cloud) + "\n")
        paths.append(p)
    return paths


def test_readers_return_the_jax_packages_arrays(tmp_path, cloud):
    for path in _special_files(tmp_path, cloud):
        np.testing.assert_array_equal(tio.load_points(path),
                                      jio.load_points(path), err_msg=path)
        if path.suffix in (".ply", ".pcd"):
            read = {".ply": (tio.read_ply, jio.read_ply),
                    ".pcd": (tio.read_pcd, jio.read_pcd)}[path.suffix]
            (a, ea), (b, eb) = read[0](path), read[1](path)
            np.testing.assert_array_equal(a, b)
            assert ea.keys() == eb.keys()
            for k in ea:
                np.testing.assert_array_equal(ea[k], eb[k], err_msg=k)
    nan_pcd = tmp_path / "nan.pcd"
    np.testing.assert_array_equal(
        tio.read_pcd(nan_pcd, drop_invalid=False)[0],
        jio.read_pcd(nan_pcd, drop_invalid=False)[0])


@pytest.mark.parametrize("text,error", [
    ("ply\nformat ascii 2.0\nend_header\n", ValueError),
    ("ply\nformat ascii 1.0\nelement vertex 1\nproperty float x\n"
     "end_header\n1\n", ValueError),
    ("notply\n", ValueError),
])
def test_reader_errors_as_jax(tmp_path, text, error):
    p = tmp_path / "bad.ply"
    p.write_text(text)
    for read in (tio.read_ply, jio.read_ply):
        with pytest.raises(error):
            read(p)


def test_compressed_pcd_is_refused(tmp_path):
    p = tmp_path / "lzf.pcd"
    p.write_text("FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nPOINTS 1\n"
                 "DATA binary_compressed\n")
    for read in (tio.read_pcd, jio.read_pcd):
        with pytest.raises(ValueError, match="binary_compressed"):
            read(p)


# --- the native tokenizers -------------------------------------------------

@pytest.fixture(scope="module")
def natives():
    from fpcr_tpu.utils import native as jn
    from fpcr_tpu_torch.utils import native as tn

    if not (tn.available() and jn.available()):
        pytest.skip("a C++ compiler is needed to build the tokenizers")
    return tn, jn


@pytest.mark.parametrize("name", ["Bunny_res.csv", "Bunny.csv"])
def test_native_xyz_equals_fallback_and_jax(natives, name):
    from fpcr_tpu_torch.data.bunny import parse_xyz
    from fpcr_tpu_torch.data.paths import asset

    tn, jn = natives
    ours = tn.read_xyz(str(asset(name)))
    np.testing.assert_array_equal(ours, parse_xyz(asset(name)))
    np.testing.assert_array_equal(ours, jn.read_xyz(str(asset(name))))
    np.testing.assert_array_equal(ft.load_bunny(
        resampled=name == "Bunny_res.csv", device="cpu").numpy(), ours)


def test_native_ints_equal_fallback_and_jax(natives):
    from fpcr_tpu_torch.data.paths import asset

    tn, jn = natives
    path = asset("Donut_1024x16.csv")
    ours = tn.read_int_lines(str(path))
    np.testing.assert_array_equal(
        ours, np.array(path.read_text().split(), dtype=np.int64))
    np.testing.assert_array_equal(ours, jn.read_int_lines(str(path)))


def test_native_separators_and_errors(natives, tmp_path):
    tn, jn = natives
    p = tmp_path / "mixed.csv"
    p.write_text("1.5;-2.25,3\n0.125 4 -8.5e-3\n")
    np.testing.assert_array_equal(tn.read_xyz(str(p)), jn.read_xyz(str(p)))
    bad = tmp_path / "bad.csv"
    bad.write_text("1 2 3\n4 x 6\n")
    huge = tmp_path / "huge.csv"
    huge.write_text("1 2 1e99\n")
    for mod in (tn, jn):
        with pytest.raises(ValueError, match="unparsable"):
            mod.read_xyz(str(bad))
        with pytest.raises(ValueError, match="out of range"):
            mod.read_xyz(str(huge))
        with pytest.raises(FileNotFoundError):
            mod.read_xyz(str(tmp_path / "missing.csv"))


def test_native_builds_apart_from_the_kernels():
    """nvcc compiles the ``*.cu`` sources only: the tokenizer's ``.cc``
    never reaches it."""
    from fpcr_tpu_torch import _build

    assert all(p.suffix == ".cu" for p in _build.sources())
    assert (_build.CSRC / "fpcr_io.cc").exists()


# --- output and diagnostics ------------------------------------------------

@pytest.fixture(scope="module")
def icp_pair():
    """JAX's run_icp result and the port's ``ICPResult`` of the same
    numbers."""
    import jax.numpy as jnp

    import fpcr_tpu as f

    s = f.synthetic_scene(width=16)
    res = f.run_icp(s.source, s.target, f.ICPConfig(max_iterations=20))
    t = {k: torch.tensor(np.asarray(v)) for k, v in res._asdict().items()
         if k != "transform"}
    ours = ft.ICPResult(transform=ft.RigidTransform(
        torch.tensor(np.asarray(res.transform.rotation)),
        torch.tensor(np.asarray(res.transform.translation))), **t)
    assert isinstance(res.errors, jnp.ndarray)
    return res, ours


def test_iteration_metrics_equal_jax(icp_pair, tmp_path):
    from fpcr_tpu.utils import csvout as jc
    from fpcr_tpu_torch.utils import csvout as tc

    jres, ours = icp_pair
    assert tc.iteration_metrics(ours) == jc.iteration_metrics(jres)
    a = tc.write_iteration_metrics(tmp_path / "a.csv", ours)
    b = jc.write_iteration_metrics(tmp_path / "b.csv", jres)
    assert a.read_bytes() == b.read_bytes()
    rows = [(9, 0.5, 0), (16, 1.25, 1)]
    assert (tc.write_rows(tmp_path / "r1.csv", rows, ("n", "ms", "f"))
            .read_bytes() == jc.write_rows(tmp_path / "r2.csv", rows,
                                           ("n", "ms", "f")).read_bytes())
    payload = {"a": 1, "b": [0.5, 2.0], "c": np.float32(0.25)}
    assert (tc.write_json(tmp_path / "j1.json", payload).read_bytes()
            == jc.write_json(tmp_path / "j2.json", payload).read_bytes())


def test_iteration_metrics_of_ndt_skip_its_scalar_fraction():
    from fpcr_tpu_torch.utils.csvout import iteration_metrics

    s = ft.synthetic_scene(width=16, device="cpu")
    res = ft.run_ndt(s.source, s.target, ft.NDTConfig(voxel_size=0.5))
    recs = iteration_metrics(res)
    assert len(recs) == int(res.num_iterations)
    assert "matched_fraction" not in recs[0]


def _fake(rotation, errors, converged=True):
    class R:  # the fields validate_result reads
        pass

    r = R()
    r.transform = ft.RigidTransform(
        torch.as_tensor(rotation, dtype=torch.float32), torch.zeros(3))
    r.errors = torch.as_tensor(errors, dtype=torch.float32)
    r.num_iterations = torch.tensor(len(errors))
    r.converged = torch.tensor(converged)
    return r


VALIDATE = {
    "good": (np.eye(3), [0.1, 0.01], True, {}),
    "not_converged": (np.eye(3), [0.1, 0.01], False,
                      {"require_converged": True}),
    "not_orthogonal": (np.diag([1.0, 1.0, 1.01]), [0.1], True, {}),
    "reflection": (np.diag([1.0, 1.0, -1.0]), [0.1], True, {}),
    "nan_errors": (np.eye(3), [0.1, np.nan], True, {}),
    "nan_transform": (np.full((3, 3), np.nan), [0.1], True,
                      {"context": "ndt"}),
}


@pytest.mark.parametrize("case", list(VALIDATE))
def test_validate_result_reports_jax_issues(case):
    from fpcr_tpu.core.transforms import RigidTransform as JT
    from fpcr_tpu.utils import diagnostics as jd
    from fpcr_tpu_torch.utils import diagnostics as td

    rot, errors, conv, kw = VALIDATE[case]
    ours = _fake(rot, errors, conv)
    theirs = _fake(rot, errors, conv)
    theirs.transform = JT(np.asarray(rot, np.float32), np.zeros(3, np.float32))
    outcomes = []
    for mod, res in ((td, ours), (jd, theirs)):
        try:
            outcomes.append(("ok", mod.validate_result(res, **kw)))
        except mod.RegistrationError as e:
            outcomes.append(("raised", str(e)))
    assert outcomes[0] == outcomes[1]


def test_debug_nans_raises_at_the_first_nonfinite_iteration():
    from fpcr_tpu_torch.utils import diagnostics

    s = ft.synthetic_scene(width=8, device="cpu")
    bad = s.source.clone()
    bad[3] = float("nan")
    # the plane solve absorbs the NaN (identity step); the error shows it
    cfg = ft.ICPConfig(metric="plane", max_iterations=5)
    res = ft.run_icp(bad, s.target, cfg)  # off: the NaN error is returned
    assert not np.isfinite(res.errors[0].item())
    with diagnostics.debug_nans():
        assert diagnostics.nans_checked()
        with pytest.raises(FloatingPointError, match="iteration 0"):
            ft.run_icp(bad, s.target, cfg)
        ft.run_icp(s.source, s.target, cfg)  # a finite run is untouched
    assert not diagnostics.nans_checked()
    with diagnostics.debug_nans(False):
        assert not diagnostics.nans_checked()


def test_run_ndt_checks_every_iteration(monkeypatch):
    """Under ``debug_nans`` ``run_ndt`` hands every iteration's error to
    the check (the loop runs eagerly then, one iteration a chunk; without
    it the check would read nothing and the loop does not call it); the
    check raises for an iteration that ran with a non-finite error, and
    not for one masked after the stop."""
    from fpcr_tpu_torch.utils import diagnostics

    check = diagnostics.check_iteration
    seen = []
    monkeypatch.setattr(diagnostics, "check_iteration",
                        lambda err, active, it, ctx: seen.append((it, ctx)))
    s = ft.synthetic_scene(width=16, device="cpu")
    with diagnostics.debug_nans():
        ft.run_ndt(s.source, s.target, ft.NDTConfig(voxel_size=0.5,
                                                    max_iterations=3))
    assert seen == [(i, "run_ndt") for i in range(3)]
    nan = torch.tensor(float("nan"))
    check(nan, torch.tensor(True), 4, "run_ndt")  # off: no check
    with diagnostics.debug_nans():
        with pytest.raises(FloatingPointError, match="run_ndt"):
            check(nan, torch.tensor(True), 4, "run_ndt")
        check(nan, torch.tensor(False), 5, "run_ndt")


# --- the CLI -----------------------------------------------------------------

def _run_both(capsys, argv):
    from fpcr_tpu.cli import main as jmain
    from fpcr_tpu_torch.cli import main as tmain

    assert tmain(argv) == 0
    ours = capsys.readouterr().out
    assert jmain(argv) == 0
    return ours, capsys.readouterr().out


CLI_RUNS = {
    "point": [],
    "exact_trimmed": ["--trim-dist", "0.5", "--robust", "huber"],
    "distributed": ["--distributed"],
    "anderson": ["--anderson"],
}


@pytest.mark.parametrize("name", list(CLI_RUNS))
def test_cli_run_follows_jax(capsys, name):
    argv = ["run", "--cpu", "--dataset", "synthetic", "--width", "16",
            "--max-iter", "30", "--json"] + CLI_RUNS[name]
    ours, theirs = (json.loads(o) for o in _run_both(capsys, argv))
    k = min(ours["iterations"], theirs["iterations"])
    if ours["iterations"] != theirs["iterations"]:
        longer = max(ours, theirs, key=lambda r: r["iterations"])
        assert abs(ours["iterations"] - theirs["iterations"]) == 1
        assert max(longer["errors"][k - 1:]) < NOISE
    np.testing.assert_allclose(ours["errors"][:k], theirs["errors"][:k],
                               rtol=0, atol=ATOL)
    assert ours["transform_rmse_vs_gt"] < 1e-4
    assert ours["platform"] == "cpu"
    assert ({k for k in ours if k not in ("wall_seconds",)}
            == {k for k in theirs if k not in ("wall_seconds",)})
    assert len(ours["iteration_metrics"]) == ours["iterations"]
    assert (sorted(ours["iteration_metrics"][0])
            == sorted(theirs["iteration_metrics"][0]))


def test_cli_run_plane_reaches_its_ground_truth(capsys):
    from fpcr_tpu_torch.cli import main

    assert main(["run", "--cpu", "--width", "16", "--metric", "plane",
                 "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["converged"] and payload["transform_rmse_vs_gt"] < 1e-4


def test_cli_run_human_output_and_files(capsys, tmp_path):
    from fpcr_tpu_torch.cli import main

    out_json, ply = tmp_path / "res.json", tmp_path / "aligned.ply"
    assert main(["run", "--cpu", "--dataset", "synthetic", "--width", "12",
                 "--max-iter", "10", "--output", str(out_json),
                 "--save-aligned", str(ply), "--eval-dist", "0.1"]) == 0
    out = capsys.readouterr().out
    assert "error sequence:" in out and "transform RMSE" in out
    assert "evaluation @ 0.1" in out
    saved = json.loads(out_json.read_text())
    assert saved["n_source"] == 144
    assert tio.read_ply(ply)[0].shape == (144, 3)


def test_cli_files_dataset_and_convert(capsys, tmp_path, cloud):
    from fpcr_tpu.cli import main as jmain
    from fpcr_tpu_torch.cli import main

    src, tgt = tmp_path / "s.ply", tmp_path / "t.pcd"
    tio.write_ply(src, cloud)
    tio.write_pcd(tgt, cloud + np.float32(0.01))
    assert main(["run", "--cpu", "--dataset", "files", "--source", str(src),
                 "--target", str(tgt), "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["transform_rmse_vs_gt"] is None
    np.testing.assert_allclose(payload["translation"], [0.01] * 3, atol=1e-5)
    assert main(["run", "--cpu", "--dataset", "files"]) == 2
    for out in ("c.pcd", "c.ply", "c.csv", "c.xyz"):
        for fn, prefix in ((main, "a"), (jmain, "b")):
            assert fn(["convert", "--input", str(src), "--output",
                       str(tmp_path / f"{prefix}{out}")]) == 0
        assert ((tmp_path / f"a{out}").read_bytes()
                == (tmp_path / f"b{out}").read_bytes())
    assert main(["convert", "--input", str(src), "--output",
                 str(tmp_path / "x.obj")]) == 2


def test_cli_sweep_prints_jaxs_rows(capsys, tmp_path):
    argv = ["sweep", "--cpu", "--widths", "3:5", "--repeats", "1"]
    ours, theirs = _run_both(capsys, argv)
    assert ([r.split(",")[0] for r in ours.split()]
            == [r.split(",")[0] for r in theirs.split()] == ["9", "16", "25"])
    from fpcr_tpu_torch.cli import main

    csv = tmp_path / "s.csv"
    assert main(argv + ["--slope", "--csv", str(csv), "--widths",
                        "3:3"]) == 0
    assert csv.read_text().splitlines()[0] == "n,ms,below_noise_floor"
    assert main(["sweep", "--cpu", "--widths", "5:3"]) == 2


def test_cli_match_bench_prints_jaxs_variant_names(capsys, tmp_path):
    import inspect

    from fpcr_tpu.bench.sweeps import matching_benchmark as jbench
    from fpcr_tpu_torch.cli import main

    csv = tmp_path / "m.csv"
    assert main(["match-bench", "--cpu", "--n", "256", "--repeats", "1",
                 "--csv", str(csv)]) == 0
    res = json.loads(capsys.readouterr().out)
    names = inspect.signature(jbench).parameters["variants"].default
    assert list(res) == ["n"] + list(names)
    assert res["n"] == 256 and all(res[v] > 0 for v in names)
    assert [r.split(",")[0] for r in csv.read_text().split()] == \
        ["variant"] + list(names)
    with pytest.raises(ValueError, match="unknown matching variants"):
        from fpcr_tpu_torch.bench.sweeps import matching_benchmark

        matching_benchmark(n=64, variants=("nope",), device="cpu")


def test_cli_info_and_the_default_device(capsys):
    from fpcr_tpu_torch.cli import main

    assert main(["info", "--cpu"]) == 0
    out = capsys.readouterr().out
    assert "platform: cpu" in out and f"torch: {torch.__version__}" in out
    if not torch.cuda.is_available():  # without --cpu the card, or a raise
        for argv in (["info"], ["run", "--dataset", "synthetic"]):
            with pytest.raises(RuntimeError, match='device="cpu"'):
                main(argv)


def test_python_m_runs_without_jax(tmp_path):
    """``python -m fpcr_tpu_torch`` in a process where JAX and the JAX
    package cannot be imported."""
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    code = ("import sys, runpy; sys.modules['jax'] = None; "
            "sys.modules['fpcr_tpu'] = None; sys.argv = ['fpcr_tpu_torch', "
            "'run', '--cpu', '--width', '12', '--json']; "
            "runpy.run_module('fpcr_tpu_torch', run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)["transform_rmse_vs_gt"] < 1e-4
