"""The port's datasets against ``fpcr_tpu``'s on the same files (CPU)."""

import numpy as np
import pytest
import torch

import fpcr_tpu as f
import fpcr_tpu_torch as ft
from fpcr_tpu.data import ouster as jo
from fpcr_tpu.data.synthetic import random_cloud as j_random_cloud
from fpcr_tpu_torch.data import ouster as to
from fpcr_tpu_torch.data.bunny import parse_xyz
from fpcr_tpu_torch.data.paths import asset
from fpcr_tpu_torch.data.synthetic import random_cloud

torch.set_num_threads(2)


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("width", [2, 16, 32])
def test_synthetic_scene_matches_jax(width):
    a = ft.synthetic_scene(width=width, device="cpu")
    b = f.synthetic_scene(width=width)
    # the grid is built in numpy by both: identical
    np.testing.assert_array_equal(a.source.numpy(), _np(b.source))
    # the target is one float32 3x3 product + translation per point, by two
    # libraries: coordinates up to ~5, so a few ulp is ~1e-6 absolute
    np.testing.assert_allclose(a.target.numpy(), _np(b.target), atol=1e-6)
    np.testing.assert_allclose(a.ground_truth.rotation.numpy(),
                               _np(b.ground_truth.rotation), atol=1e-6)
    np.testing.assert_allclose(a.ground_truth.translation.numpy(),
                               _np(b.ground_truth.translation), atol=1e-6)
    assert a.source.shape == (width * width, 3)


def test_surface_grid_and_random_cloud_match_jax():
    np.testing.assert_array_equal(
        ft.surface_grid(9, -1.0, 3.0, device="cpu").numpy(),
        _np(f.surface_grid(9, -1.0, 3.0)))
    for seed in (0, 1, 123):
        np.testing.assert_array_equal(
            random_cloud(257, seed=seed, scale=2.5, device="cpu").numpy(),
            _np(j_random_cloud(257, seed=seed, scale=2.5)))


@pytest.mark.parametrize("resampled,n", [(True, 8171), (False, 35947)])
def test_bunny_matches_jax(resampled, n):
    a = ft.load_bunny(resampled=resampled, device="cpu")
    b = f.load_bunny(resampled=resampled)
    assert a.shape == (n, 3) and a.dtype == torch.float32
    # two float parsers (numpy here, possibly a C++ strtof there)
    np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-6)


def test_bunny_scene_ground_truth():
    a, b = ft.bunny_scene(device="cpu"), f.bunny_scene()
    np.testing.assert_allclose(a.ground_truth.rotation.numpy(),
                               _np(b.ground_truth.rotation), atol=1e-6)
    np.testing.assert_allclose(a.target.numpy(), _np(b.target), atol=1e-6)


@pytest.mark.parametrize("delim", [" ", ";", "\t"])
def test_xyz_tokenizer_delimiters(tmp_path, delim):
    pts = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
    path = tmp_path / "c.csv"
    path.write_text("\n".join(delim.join(repr(float(v)) for v in row)
                              for row in pts) + "\n")
    np.testing.assert_array_equal(parse_xyz(path), pts)
    path.write_text("1 2 3 4\n")
    with pytest.raises(ValueError, match="divisible by 3"):
        parse_xyz(path)


def test_asset_override_and_missing(monkeypatch, tmp_path):
    assert asset("Bunny_res.csv").name == "Bunny_res.csv"
    monkeypatch.setenv("FPCR_DATA_DIR", str(tmp_path))
    (tmp_path / "x.csv").write_text("0 0 0\n")
    assert asset("x.csv") == tmp_path / "x.csv"
    with pytest.raises(FileNotFoundError, match="FPCR_DATA_DIR"):
        asset("Bunny_res.csv")


@pytest.fixture(scope="module")
def frames():
    return to.parse_packets(), jo.parse_packets()


def test_hall_packets_identical(frames):
    a, b = frames
    assert a.encoder_start == b.encoder_start
    np.testing.assert_array_equal(a.ranges, b.ranges)
    np.testing.assert_array_equal(a.altitude_deg, b.altitude_deg)
    np.testing.assert_array_equal(a.azimuth_deg, b.azimuth_deg)
    assert a.ranges.shape == (16384,)


def test_hall_points_match_jax(frames):
    a, _ = frames
    pts = to.polar_to_cartesian(torch.as_tensor(a.ranges), a.encoder_start,
                                torch.as_tensor(a.altitude_deg),
                                torch.as_tensor(a.azimuth_deg))
    ref = _np(f.load_hall_scan(meters=False))
    # two float32 trigonometry libraries on angles up to 2π: 1e-5 relative,
    # and 1 µm absolute for coordinates near zero
    np.testing.assert_allclose(pts.numpy(), ref, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(ft.load_hall_scan(device="cpu").numpy(),
                               _np(f.load_hall_scan()), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("meters,strict", [(True, True), (True, False),
                                           (False, True)])
def test_hall_scene_ground_truth(meters, strict):
    a = ft.hall_scene(meters=meters, strict=strict, device="cpu")
    b = f.hall_scene(meters=meters, strict=strict)
    np.testing.assert_allclose(a.ground_truth.translation.numpy(),
                               _np(b.ground_truth.translation), rtol=1e-6)
    np.testing.assert_allclose(a.ground_truth.rotation.numpy(),
                               _np(b.ground_truth.rotation), atol=1e-6)
    want_t = np.array(jo.HALL_GT_TRANSLATION) * (
        1e-3 if meters and strict else 1.0)
    np.testing.assert_allclose(a.ground_truth.translation.numpy(), want_t,
                               rtol=1e-6)
    scale = 1.0 if meters else 1e3  # hall coordinates: ~10 m or ~1e4 mm
    np.testing.assert_allclose(a.target.numpy(), _np(b.target), rtol=1e-5,
                               atol=1e-5 * scale)
