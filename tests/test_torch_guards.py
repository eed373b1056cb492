"""The guards of ``fpcr_tpu_torch/bench/guards.py`` (checks 7, 9 and 10 of
``scripts/tpu_smoke.py``) on the CPU: the wide-plane cloud bit for bit the
JAX package's, its resolved K4 window equal to JAX's, K4's plain version
covering every neighbour at that window, and each check to its
thresholds."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fpcr_tpu as f
from fpcr_tpu.data.synthetic import wide_plane_cloud as j_wide_plane_cloud
from fpcr_tpu.models.ndt import NDTConfig as JNDTConfig
from fpcr_tpu.models.ndt import resolve_ndt_config as j_resolve
from fpcr_tpu.ops.ndt import cell_key_order as j_cell_key_order
from fpcr_tpu_torch.bench import guards
from fpcr_tpu_torch.data.synthetic import wide_plane_cloud
from fpcr_tpu_torch.models.ndt import NDTConfig, resolve_ndt_config

torch.set_num_threads(2)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def wide():
    return guards.wide_plane_setup(CPU)


def test_wide_plane_cloud_is_jax_bit_for_bit():
    ours = wide_plane_cloud(device="cpu").numpy()
    ref = np.asarray(j_wide_plane_cloud())
    assert ours.shape == ref.shape == (259200, 3)
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)
    small = wide_plane_cloud(sheets=3, grid=7, seed=3, device="cpu").numpy()
    np.testing.assert_array_equal(
        small, np.asarray(j_wide_plane_cloud(sheets=3, grid=7, seed=3)))


def test_wide_plane_resolves_jax_window(wide):
    _, _, _, _, src_sorted, cfg = wide
    wp = j_wide_plane_cloud()
    grid = f.build_ndt_grid(wp, guards.WIDE_VOXEL)
    gt = f.gt_transform(*guards.WIDE_GT)
    src = gt.inverse().apply(wp)
    ref = j_resolve(JNDTConfig(voxel_size=guards.WIDE_VOXEL, lookup="banded",
                               lookup_chunk=512), grid,
                    jnp.take(src, j_cell_key_order(src, grid), axis=0))
    assert cfg.lookup_window == ref.lookup_window == 384
    assert cfg.lookup_window > guards.WIDE_WINDOW_FLOOR
    # the CPU takes the per-offset band, as JAX's CPU does; asked for K4,
    # the policy keeps the escalated window the card's auto picks
    assert cfg.lookup_impl == ref.lookup_impl == "xla"
    _, grid_t, _, _, _, _ = wide
    k4 = resolve_ndt_config(NDTConfig(
        voxel_size=guards.WIDE_VOXEL, lookup="banded", lookup_chunk=512,
        lookup_impl="pallas"), grid_t, src_sorted)
    assert (k4.lookup_impl, k4.lookup_window) == ("pallas", 384)


def test_escalated_window_covers(wide):
    _, grid, _, _, src_sorted, cfg = wide
    k4 = dataclasses.replace(cfg, lookup_impl="pallas")
    assert guards.fused_count_parity(src_sorted, grid, k4)


@pytest.mark.parametrize("check", ["far_cloud_tuning", "isotropic_frame",
                                   "duplicate_cluster_ndt", "wide_plane"])
def test_guard_on_cpu(check):
    out = getattr(guards, check)(CPU)  # raises past its threshold
    assert out
