"""``register_ndt`` takes array-likes, as the JAX package's does: numpy
clouds go through ``as_points`` to the card (CPU: the device default's
error), and tensors keep their device."""

import numpy as np
import pytest
import torch

import fpcr_tpu_torch as ft


def _clouds():
    scene = ft.synthetic_scene(width=24, device="cpu")
    gt = ft.gt_transform((0.02, -0.01, 0.015), (0.01, -0.02, 0.01),
                         device="cpu")
    return scene.source, gt.apply(scene.source), gt


@pytest.mark.parametrize("numpy_side", ["source", "target", "both"])
def test_register_ndt_numpy_clouds_name_the_device(numpy_side, monkeypatch):
    """Without a card, a numpy cloud raises the device default's
    ``RuntimeError`` (naming ``device="cpu"``), never a ``TypeError`` from
    ``torch.matmul`` on an ndarray."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src, tgt, _ = _clouds()
    if numpy_side in ("source", "both"):
        src = src.numpy()
    if numpy_side in ("target", "both"):
        tgt = tgt.numpy()
    if numpy_side == "target":
        # a tensor source keeps its device: the target follows it
        res = ft.register_ndt(src, tgt, ft.ICPConfig(max_iterations=5),
                              ft.NDTConfig(voxel_size=0.4, max_iterations=5))
        assert res.transform.rotation.device.type == "cpu"
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ft.register_ndt(src, tgt)


def test_register_ndt_numpy_clouds_on_the_default_device(monkeypatch):
    """With the default device pointed at the CPU (as the card is on the
    card's machine), numpy clouds register as their tensors do: the ICP
    stage gets a tensor, not the ndarray ``torch.matmul`` refuses."""
    import fpcr_tpu_torch.core.cloud as cloud

    monkeypatch.setattr(cloud, "resolve_device",
                        lambda device=None: torch.device("cpu"))
    src, tgt, gt = _clouds()
    cfg, ndt = ft.ICPConfig(max_iterations=30), ft.NDTConfig(voxel_size=0.4)
    a = ft.register_ndt(src, tgt, cfg, ndt)
    b = ft.register_ndt(src.numpy(), tgt.numpy(), cfg, ndt)
    assert torch.equal(a.transform.rotation, b.transform.rotation)
    assert torch.equal(a.transform.translation, b.transform.translation)
    assert float(ft.transform_rmse(b.transform, gt, src)) < 1e-5


def test_register_ndt_list_target_follows_tensor_source():
    """A nested-list target lands on the source's device and registers as
    the tensor does, bit for bit."""
    src, tgt, gt = _clouds()
    cfg = ft.ICPConfig(max_iterations=30)
    ndt = ft.NDTConfig(voxel_size=0.4)
    a = ft.register_ndt(src, tgt, cfg, ndt)
    b = ft.register_ndt(src, tgt.numpy().tolist(), cfg, ndt)
    assert torch.equal(a.transform.rotation, b.transform.rotation)
    assert torch.equal(a.transform.translation, b.transform.translation)
    assert float(ft.transform_rmse(a.transform, gt, src)) < 1e-5
    assert np.isfinite(a.errors.numpy()[:int(a.num_iterations)]).all()
