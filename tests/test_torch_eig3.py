"""The symmetric 3x3 eigensolver of the normals prepass and of NDT's voxel
frames (``ops/eigh3.py::eigh3``) on the CPU: its plain path
(``torch.linalg.eigh`` in float32 with the kernel's guards) and the numpy
mirror of kernel eig3 (``ops/eig3_mirror.py``) against float64 ``eigh`` of
the same float32 matrices, and point-to-plane ``run_icp`` on 16-ring
sectors of the OS1-16 hall scan against the benchmark's float64 reference.

The accuracy held (kernel svd3's rule, written for eigenvalues): the
smallest eigenvector within ``8·2⁻²³·λ2 / (λ1 − λ0)`` rad of float64's, or
1e-6 rad if that is larger, and each eigenvalue within ``8·2⁻²³·λ2``, λ2
the largest |λ|: what a float32 input itself leaves of them."""

import math

import numpy as np
import pytest
import torch

import fpcr_tpu_torch as ft
from fpcr_tpu_torch.ops.eig3_mirror import eig3_mirror
from fpcr_tpu_torch.ops.eigh3 import ISO_FRAME, eig3_plain, eigh3

EPS32 = 2.0 ** -23
FALLBACK = np.full(3, 1.0 / math.sqrt(3.0))


def _plain(a):
    vals, vecs = eigh3(torch.as_tensor(a))
    return vals.numpy(), vecs.numpy()


SOLVERS = {"plain": _plain, "mirror": eig3_mirror}


def _rotations(rng, n):
    q, r = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    return q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]


def _spectra(rng, lams):
    """Symmetric float32 matrices ``Q diag(λ) Qᵀ`` of random rotations."""
    q = _rotations(rng, len(lams))
    return np.einsum("nij,nj,nkj->nik", q, np.asarray(lams, np.float64),
                     q).astype(np.float32)


def near_collinear(rng, n=400):
    """Covariances of 4 neighbours on one ring of a LiDAR scan: points 2–8
    cm apart along a line 3–30 m from the sensor, 2 mm noise on each, the
    reference's unnormalised covariance in float32."""
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    c = rng.normal(size=(n, 3))
    c *= rng.uniform(3, 30, (n, 1)) / np.linalg.norm(c, axis=1,
                                                     keepdims=True)
    step = rng.uniform(0.02, 0.08, (n, 1, 1))
    pts = (c[:, None, :] + np.arange(4)[None, :, None] * step * d[:, None, :]
           + rng.normal(0, 0.002, (n, 4, 3))).astype(np.float32)
    dev = pts - pts.mean(axis=1, keepdims=True)
    return np.einsum("nki,nkj->nij", dev, dev).astype(np.float32)


def lam01_close(rng):
    """λ0 ≈ λ1, relative gaps down to below float32's epsilon."""
    return _spectra(rng, [[1.0, 1.0 + d, 10.0]
                          for d in (1e-9, 1e-7, 1e-6, 1e-5, 1e-4, 1e-3)
                          for _ in range(20)])


def lam12_close(rng):
    """λ1 ≈ λ2: the smallest is simple, its eigenvector well defined."""
    return _spectra(rng, [[1e-3, 10.0, 10.0 * (1.0 + d)]
                          for d in (0.0, 1e-9, 1e-7, 1e-5, 1e-3)
                          for _ in range(20)])


def isotropic(rng):
    """A ≈ qI: exact multiples of I and ones perturbed far below float32's
    epsilon."""
    q = rng.uniform(0.1, 100.0, 40)
    exact = q[:20, None, None] * np.eye(3)
    e = rng.normal(size=(20, 3, 3)) * 1e-10
    near = q[20:, None, None] * (np.eye(3) + e + e.transpose(0, 2, 1))
    return np.concatenate([exact, near]).astype(np.float32)


def zero(rng):
    return np.zeros((3, 3, 3), np.float32)


CASES = {"near_collinear": near_collinear, "lam0_near_lam1": lam01_close,
         "lam1_near_lam2": lam12_close, "isotropic": isotropic,
         "zero": zero}


def _angles(u, v):
    """Angles between unoriented lines, stable near 0."""
    u, v = u.astype(np.float64), v.astype(np.float64)
    return np.arctan2(np.linalg.norm(np.cross(u, v), axis=-1),
                      np.abs((u * v).sum(-1)))


@pytest.mark.parametrize("solver", list(SOLVERS))
@pytest.mark.parametrize("case", list(CASES))
def test_eig3_holds_float64_eigh(case, solver):
    rng = np.random.default_rng(sorted(CASES).index(case) + 11)
    a = CASES[case](rng)
    vals, vecs = SOLVERS[solver](a)
    assert vals.dtype == np.float32 and vecs.dtype == np.float32
    w, v = np.linalg.eigh(a.astype(np.float64))
    top = np.abs(w).max(axis=1)
    np.testing.assert_array_less(np.abs(vals - w).max(axis=1),
                                 8 * EPS32 * top + 1e-30)
    a64 = a.astype(np.float64)
    q = np.trace(a64, axis1=1, axis2=2)[:, None, None] / 3.0
    dev = a64 - q * np.eye(3)
    # |A − qI| against |A|: surely inside the guard, or far outside it
    ratio = np.linalg.norm(dev, axis=(1, 2)) / np.maximum(
        np.linalg.norm(a64, axis=(1, 2)), 1e-300)
    iso = ratio <= 2.0 ** -23
    assert iso.all() == (case in ("isotropic", "zero"))
    assert (iso | (ratio > 2.0 ** -20)).all()
    np.testing.assert_allclose(vecs[iso][:, :, 0],
                               np.broadcast_to(FALLBACK, (iso.sum(), 3)),
                               atol=1e-7)
    gap = np.maximum(w[:, 1] - w[:, 0], 1e-300)
    bound = np.maximum(8 * EPS32 * top / gap, 1e-6)
    ang = _angles(vecs[:, :, 0], v[:, :, 0])
    assert (ang[~iso] <= bound[~iso]).all(), (ang / bound).max()
    # orthonormal frames, every column an eigenvector of its value
    eye = np.broadcast_to(np.eye(3), vecs.shape)
    np.testing.assert_allclose(np.einsum("nji,njk->nik", vecs, vecs), eye,
                               atol=2e-6)
    res = (np.einsum("nij,njk->nik", a.astype(np.float64), vecs)
           - vecs * vals[:, None, :].astype(np.float64))
    assert (np.linalg.norm(res, axis=1) <= 1e-5 * top[:, None]
            + 1e-30).all()


def test_near_collinear_is_where_the_closed_form_fails():
    """The seeded near-collinear covariances reach the closed form's fault
    (``eigvals3`` and ``_unit_eigenvector``, the JAX package's), which
    ``eigh3`` repairs: it turns by far more than the bound there."""
    from fpcr_tpu_torch.ops.eigh3 import _unit_eigenvector, eigvals3

    a = near_collinear(np.random.default_rng(5))
    at = torch.as_tensor(a)
    closed = _unit_eigenvector(at, eigvals3(at)[..., 0], 1e-20).numpy()
    w, v = np.linalg.eigh(a.astype(np.float64))
    ratio = (w[:, 1] - w[:, 0]) / w[:, 2]
    assert (ratio < 1e-4).sum() >= 10
    bound = np.maximum(8 * EPS32 * w[:, 2] / (w[:, 1] - w[:, 0]), 1e-6)
    assert (_angles(closed, v[:, :, 0]) / bound).max() > 10.0


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_eig3_signed_spectra(solver):
    """Indefinite matrices, an eigenvalue pair λ, −λ included (one-sided
    Jacobi on A alone cannot separate it): ascending values, eigenvectors
    float64's where the values are apart."""
    rng = np.random.default_rng(3)
    pairs = _spectra(rng, [[-2.0, 0.5, 2.0], [-1.0, 1.0, 3.0],
                           [-5.0, -1.0, 5.0], [-3.0, -3.0, 1.0]])
    b = rng.normal(size=(200, 3, 3))
    a = np.concatenate([pairs, (b + b.transpose(0, 2, 1)).astype(
        np.float32)])
    vals, vecs = SOLVERS[solver](a)
    w, v = np.linalg.eigh(a.astype(np.float64))
    top = np.abs(w).max(axis=1)
    np.testing.assert_array_less(np.abs(vals - w).max(axis=1),
                                 8 * EPS32 * top)
    for j in range(3):
        gaps = np.abs(w - w[:, j:j + 1])
        gaps[:, j] = np.inf
        gap = gaps.min(axis=1)
        bound = np.maximum(8 * EPS32 * top / gap, 1e-6)
        assert (_angles(vecs[:, :, j], v[:, :, j]) <= bound).all()


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_eig3_non_finite_is_nan(solver):
    a = np.stack([np.eye(3), np.eye(3), 2 * np.eye(3)]).astype(np.float32)
    a[0, 1, 2] = np.nan
    a[1, 0, 0] = np.inf
    vals, vecs = SOLVERS[solver](a)
    assert np.isnan(vals[:2]).all() and np.isnan(vecs[:2]).all()
    np.testing.assert_allclose(vals[2], [2.0, 2.0, 2.0])


def test_isotropic_frame_and_dispatch():
    """The fixed frame of A ≈ qI is right-handed and orthonormal; on the
    CPU ``eigh3`` (NDT's frames, the normals) is the plain path; the
    mirror gives the same frame."""
    f = np.array(ISO_FRAME)
    np.testing.assert_allclose(f.T @ f, np.eye(3), atol=1e-15)
    assert np.linalg.det(f) == pytest.approx(1.0)
    a = torch.as_tensor(np.stack([0.25 * np.eye(3), np.zeros((3, 3)),
                                  np.diag([1.0, 2.0, 3.0])]).astype(
                                      np.float32))
    vals, vecs = eigh3(a)
    pv, pvec = eig3_plain(a)
    assert torch.equal(vals, pv) and torch.equal(vecs, pvec)
    np.testing.assert_allclose(vecs[:2].numpy(), np.stack([f, f]), atol=1e-7)
    np.testing.assert_allclose(eig3_mirror(a.numpy())[1][:2], np.stack(
        [f, f]), atol=1e-7)
    np.testing.assert_allclose(vals[2].numpy(), [1.0, 2.0, 3.0])


def test_batched_normals_equal_each_elements_call():
    rng = np.random.default_rng(2)
    clouds = torch.as_tensor(rng.normal(size=(3, 300, 3)).astype(
        np.float32))
    batch = ft.estimate_normals(clouds)
    for b in range(3):
        assert torch.equal(batch[b], ft.estimate_normals(clouds[b]))


# ---- point-to-plane on 16-ring sectors of the OS1-16 hall scan --------------

ICP = {"matcher": "xla", "max_iterations": 100, "tolerance": 1e-6,
       "k_neighbors": 4}
# sectors of 128 azimuth blocks (45 degrees, 2,048 points, no rangeless
# return): a point's 4 nearest neighbours lie on its own ring, 0.35 degrees
# apart against the beams' 2.2, so most neighbourhoods are near-collinear
SECTORS = (64, 256, 832)
# K1 computes the difference form on the card; its plain version on the CPU
# ranks by the norm form unless ``exact_distances``, whose float32 picks on
# points ~10 m out differ from float64's at near-ties and alone moved these
# gaps to 4.7e-6 and 2.4e-5 (pose) and 1.5e-5 (first error). With the card's
# form and the normals' difference-form re-rank the gaps read 1.0e-7 to
# 3.2e-7 (pose) and 9.6e-9 to 1.6e-8 (first error). The normals of the norm
# form's picks read 6.5e-6 / 1.1e-6 on the second sector and 3.2e-6 /
# 3.2e-6 on the third, the closed form's 1.8e-6 of pose on the first and
# 1.6e-4 of first error on the second
POSE_TOL = 1e-6
FIRST_ERROR_TOL = 2e-7


def _ring_request(b0):
    from benchmark import scenes

    cloud = scenes.ouster_hall("assets/Donut_1024x16.csv",
                               "assets/beam_intrinsics.csv")
    tgt0 = cloud[b0 * 16:(b0 + 128) * 16].astype(np.float64)
    assert (np.abs(tgt0).sum(axis=1) > 0).all()
    rng = np.random.default_rng(b0 + 1)
    ax = rng.normal(size=3)
    ax /= np.linalg.norm(ax)
    k = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]],
                  [-ax[1], ax[0], 0]])
    ang = math.radians(2.0)
    rot = np.eye(3) + math.sin(ang) * k + (1 - math.cos(ang)) * k @ k
    src = tgt0 @ rot.T + [0.02, -0.01, 0.015]
    src = src + rng.normal(0, 0.002, src.shape)
    tgt = tgt0 + rng.normal(0, 0.002, tgt0.shape)
    return (torch.as_tensor(src.astype(np.float32)),
            torch.as_tensor(tgt.astype(np.float32)))


@pytest.mark.parametrize("b0", SECTORS)
def test_plane_icp_on_a_ring_sector_holds_the_reference(b0):
    from benchmark.reference import check, icp64
    from benchmark.rows import pack

    src, tgt = _ring_request(b0)
    ref = icp64.register(src, tgt, ICP, "plane", icp64.FLOAT64)
    res = ft.run_icp(src, tgt, ft.ICPConfig(metric="plane",
                                            exact_distances=True, **ICP))
    g = check.gaps(pack(res)[0], ref, src)
    assert 3 <= ref.iterations < 20
    assert g["iter_gap"] <= 1, g
    assert g["pose_gap_m"] < POSE_TOL, g
    assert g["first_error_gap_m"] < FIRST_ERROR_TOL, g
