"""Kernel svd3's arithmetic (``fpcr_tpu_torch/csrc/svd3.cu``) on the CPU.

The kernel runs only on the card. Here a float64 numpy mirror of its
one-sided Jacobi SVD, statement for statement, is held against JAX's
``fpcr_tpu.ops.solve.rotation_from_svd`` and the port's plain version
(``torch.linalg.svd`` on a CPU tensor) on random matrices, rank 2 and rank 1
(a plane and a line cloud), reflections, repeated singular values, ``W = 0``
and NaN; ``tests/test_torch_gpu.py`` holds the kernel itself to both.

Tolerance: 1e-6 absolute on R where σ2 − σ3 > 1e-3·σ1 (without the det fix
also σ3 > 1e-3·σ1), and RᵀR = I within 1e-6 everywhere, det R = +1 with the
det fix. Why: R = U·Vᵀ is unique where the smallest
singular value is separated from the next (the det fix flips the third
column of U, whose direction is then defined); both references take a
float32 SVD, whose R is off by about float32's epsilon times σ1 over the
gaps, under 1e-6 at the gaps of these cases, while the mirror's float64 R
is exact before its final rounding (half an ulp, 6e-8). Where the gap is
smaller, or σ2 = σ3 = 0 (a line), R is not unique and the libraries pick
different ones: only that R is a rotation is checked.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpcr_tpu.ops import solve as js
from fpcr_tpu_torch.ops import solve as ts
from fpcr_tpu_torch.ops.svd3_cuda import svd3_rotation_cuda

SWEEPS = 8  # csrc/svd3.cu: kSweeps
RANK_TOL = 1e-13  # csrc/svd3.cu: kRankTol
ATOL = 1e-6
GAP = 1e-3


def _jacobi_pair(a, v, p, q):
    alpha = a[0, p] * a[0, p] + a[1, p] * a[1, p] + a[2, p] * a[2, p]
    beta = a[0, q] * a[0, q] + a[1, q] * a[1, q] + a[2, q] * a[2, q]
    gamma = a[0, p] * a[0, q] + a[1, p] * a[1, q] + a[2, p] * a[2, q]
    if gamma == 0.0:
        return
    zeta = (beta - alpha) / (2.0 * gamma)
    t = np.copysign(1.0, zeta) / (abs(zeta) + np.sqrt(1.0 + zeta * zeta))
    c = 1.0 / np.sqrt(1.0 + t * t)
    s = c * t
    for m in (a, v):
        x, y = m[:, p].copy(), m[:, q].copy()
        m[:, p] = c * x - s * y
        m[:, q] = s * x + c * y


def _reject(x, u):
    x -= np.dot(u, x) * u
    return np.sqrt(np.dot(x, x))


def _mirror_one(w, det_correction, umeyama=False):
    """The kernel's R of one matrix; with ``umeyama`` (Umeyama's form, the
    det fix on) ``(R, trace)``."""
    if not np.isfinite(w).all():
        nan = np.full((3, 3), np.nan, np.float32)
        return (nan, np.float32(np.nan)) if umeyama else nan
    a = w.astype(np.float64)
    v = np.eye(3)
    for _ in range(SWEEPS):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            _jacobi_pair(a, v, p, q)
    sig = np.sqrt((a * a).sum(axis=0))
    for p, q in ((0, 1), (1, 2), (0, 1)):  # descending σ
        if sig[p] < sig[q]:
            a[:, [p, q]] = a[:, [q, p]]
            v[:, [p, q]] = v[:, [q, p]]
            sig[[p, q]] = sig[[q, p]]
    vc = v.T.copy()  # rows: the right singular vectors
    det_v = np.linalg.det(vc)
    tol = RANK_TOL * sig[0]
    if not sig[0] > 0.0:
        u = vc.copy()
    else:
        u = np.empty((3, 3))
        u[0] = a[:, 0] / sig[0]
        u[1] = a[:, 1]
        n = _reject(u[1], u[0])
        if not n > tol:  # rank 1
            u[1] = vc[1]
            n = _reject(u[1], u[0])
            if not n > 1e-3:
                u[1] = np.eye(3)[int(np.argmin(np.abs(u[0])))]
                n = _reject(u[1], u[0])
        u[1] /= n
        u[2] = det_v * np.cross(u[0], u[1])
        if not det_correction and sig[2] > tol and np.dot(u[2], a[:, 2]) < 0:
            u[2] = -u[2]
    R = (u.T @ vc).astype(np.float32)
    if not umeyama:
        return R
    d = -1.0 if (sig[0] > 0.0 and sig[2] > tol
                 and np.dot(u[2], a[:, 2]) < 0.0) else 1.0
    return R, np.float32(sig[0] + sig[1] + d * sig[2])


def svd3_mirror(W, det_correction=True):
    """The kernel's R for each 3x3 of ``W`` [..., 3, 3] (float32)."""
    W = np.asarray(W, np.float32)
    out = np.empty(W.shape, np.float32)
    for idx in np.ndindex(W.shape[:-2]):
        out[idx] = _mirror_one(W[idx], det_correction)
    return out


def umeyama_mirror(W):
    """The kernel's Umeyama form for each 3x3 of ``W`` [..., 3, 3]:
    ``(R, trace)``."""
    W = np.asarray(W, np.float32)
    R = np.empty(W.shape, np.float32)
    trace = np.empty(W.shape[:-2], np.float32)
    for idx in np.ndindex(W.shape[:-2]):
        R[idx], trace[idx] = _mirror_one(W[idx], True, umeyama=True)
    return R, trace


def _rot(rng):
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    return q if np.linalg.det(q) > 0 else -q


def _with_sigma(rng, sig, det_sign=1.0):
    d = np.diag(np.asarray(sig, np.float64))
    d[2, 2] *= det_sign
    return (_rot(rng) @ d @ _rot(rng)).astype(np.float32)


def _cross_cov(p, q):
    dp, dq = p - p.mean(0), q - q.mean(0)
    return (dq.T @ dp).astype(np.float32)


def _case(name):
    """``[B, 3, 3]`` float32 inputs of one case, made from a seed."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "random":
        return rng.normal(size=(64, 3, 3)).astype(np.float32)
    if name == "random scaled":  # float32 moments of large and small clouds
        w = rng.normal(size=(16, 3, 3)) * 10.0 ** rng.uniform(-6, 6, (16, 1, 1))
        return w.astype(np.float32)
    if name == "kabsch":  # cross-covariances of noisy rigid pairs
        out = []
        for _ in range(16):
            p = rng.normal(size=(300, 3)) * [1.0, 0.6, 0.3]
            q = p @ _rot(rng).T + rng.normal(scale=1e-3, size=p.shape)
            out.append(_cross_cov(p, q))
        return np.stack(out)
    if name == "rank 2":  # a plane cloud
        out = []
        for _ in range(8):
            p = rng.normal(size=(300, 3)) * [1.0, 0.5, 0.0]
            out.append(_cross_cov(p, p @ _rot(rng).T))
        out += [_with_sigma(rng, (2.0, 0.7, 0.0)) for _ in range(8)]
        return np.stack(out)
    if name == "rank 1":  # a line cloud
        out = []
        for _ in range(8):
            p = rng.normal(size=(300, 1)) * rng.normal(size=(1, 3))
            out.append(_cross_cov(p, p @ _rot(rng).T))
        out += [_with_sigma(rng, (1.5, 0.0, 0.0)) for _ in range(8)]
        return np.stack(out)
    if name == "reflection":  # det W < 0: the det fix flips u3
        return np.stack([_with_sigma(rng, (3.0, 2.0, 0.5), -1.0)
                         for _ in range(16)])
    if name == "repeated":  # σ2 = σ3, σ1 = σ2, all equal, either det sign
        sigs = [(3.0, 1.0, 1.0), (2.0, 2.0, 0.5), (1.0, 1.0, 1.0)]
        return np.stack([_with_sigma(rng, s, d) for s in sigs
                         for d in (1.0, -1.0) for _ in range(3)])
    if name == "identity":
        return np.stack([np.eye(3, dtype=np.float32),
                         np.diag([2.0, 1.0, 0.5]).astype(np.float32)])
    if name == "zero":
        return np.zeros((2, 3, 3), np.float32)
    raise KeyError(name)


CASES = ["random", "random scaled", "kabsch", "rank 2", "rank 1",
         "reflection", "repeated", "identity", "zero"]


def _jax(W, det_correction):
    f = jax.vmap(lambda w: js.rotation_from_svd(w, det_correction))
    return np.asarray(f(jnp.asarray(W)))


def _plain(W, det_correction):
    return ts.rotation_from_svd_plain(torch.as_tensor(W),
                                      det_correction).numpy()


def _separated(W, det_correction):
    """Where R is unique: σ3 apart from σ2, and without the det fix σ3 also
    apart from 0 (the sign of u3 then follows W·v3, not rounding noise)."""
    s = np.linalg.svd(W.astype(np.float64), compute_uv=False)
    sep = (s[..., 1] - s[..., 2]) > GAP * s[..., 0]
    return sep if det_correction else sep & (s[..., 2] > GAP * s[..., 0])


def _check_rotation(R, proper=True):
    R = R.astype(np.float64)
    eye = np.broadcast_to(np.eye(3), R.shape)
    assert np.abs(np.swapaxes(R, -1, -2) @ R - eye).max() < ATOL
    if proper:
        assert np.abs(np.linalg.det(R) - 1.0).max() < ATOL


@pytest.mark.parametrize("det_correction", [True, False])
@pytest.mark.parametrize("name", CASES)
def test_mirror_against_jax_and_plain(name, det_correction):
    W = _case(name)
    mine = svd3_mirror(W, det_correction)
    _check_rotation(mine, proper=det_correction)
    sep = _separated(W, det_correction)
    if name in ("reflection", "kabsch", "random") or (
            name == "rank 2" and det_correction):
        assert sep.any()  # the case reaches the full check
    for ref in (_jax(W, det_correction), _plain(W, det_correction)):
        np.testing.assert_allclose(mine[sep], ref[sep], rtol=0, atol=ATOL)


def test_mirror_zero_is_identity():
    """W = 0 gives the identity in the mirror, JAX and the plain version."""
    W = _case("zero")
    for R in (svd3_mirror(W), _jax(W, True), _plain(W, True)):
        np.testing.assert_array_equal(R, np.broadcast_to(np.eye(3), W.shape))


def test_mirror_rank_deficient_is_proper():
    """A line or plane cloud's W gives a rotation with det +1, and without
    the det fix an orthogonal R."""
    for name in ("rank 1", "rank 2"):
        W = _case(name)
        _check_rotation(svd3_mirror(W, True))
        _check_rotation(svd3_mirror(W, False), proper=False)


@pytest.mark.parametrize("where", [(0, 0), (1, 2), (2, 1)])
@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf])
def test_mirror_non_finite_gives_nan(where, value):
    """A non-finite entry gives a NaN R, as JAX gives for NaN; the plain
    version (LAPACK) raises on NaN instead."""
    W = _case("random")[:3].copy()
    W[1][where] = value
    R = svd3_mirror(W)
    assert np.isnan(R[1]).all()
    assert np.isfinite(R[[0, 2]]).all()
    if np.isnan(value):
        assert np.isnan(_jax(W, True)[1]).all()
        with pytest.raises(Exception):
            _plain(W, True)


def test_mirror_converges_within_the_sweeps():
    """The fixed sweep count is enough: one sweep more moves no entry of the
    rounded R by more than one float32 ulp (the float64 R moves by ~1e-16,
    which can cross a rounding boundary)."""
    global SWEEPS
    W = np.concatenate([_case(name) for name in CASES])
    base = svd3_mirror(W)
    SWEEPS += 1
    try:
        more = svd3_mirror(W)
    finally:
        SWEEPS -= 1
    np.testing.assert_allclose(base, more, rtol=0, atol=2.0 ** -23)


def test_wrapper_takes_cuda_tensors_only():
    """The kernel's wrapper refuses a CPU tensor; ``rotation_from_svd`` on
    a CPU tensor runs the plain version, launching nothing."""
    W = torch.as_tensor(_case("random")[:4])
    before = svd3_rotation_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        svd3_rotation_cuda(W)
    R = ts.rotation_from_svd(W)
    assert svd3_rotation_cuda.launches == before
    np.testing.assert_allclose(R.numpy(), svd3_mirror(W.numpy()), rtol=0,
                               atol=ATOL)


def _jax_umeyama(W):
    """JAX's Umeyama rotation and trace (``fpcr_tpu/ops/solve.py:183``'s
    SVD glue) of each W."""
    def one(w):
        U, D, Vt = jnp.linalg.svd(w, full_matrices=False)
        d = jnp.sign(jnp.linalg.det(U) * jnp.linalg.det(Vt))
        d = jnp.where(d == 0, 1.0, d)
        R = jnp.matmul(U.at[:, 2].multiply(d), Vt,
                       precision=jax.lax.Precision.HIGHEST)
        return R, D[0] + D[1] + d * D[2]
    R, trace = jax.vmap(one)(jnp.asarray(W))
    return np.asarray(R), np.asarray(trace)


@pytest.mark.parametrize("name", CASES)
def test_umeyama_mirror_against_jax_and_plain(name):
    """svd3's Umeyama form: its R is the rotation form's with the det fix,
    bit for bit, and within 1e-6 of JAX's and the plain version's where R
    is unique; its trace σ1 + σ2 + d·σ3 within 1e-6 of σ1 of both
    everywhere (at rank 2 and below d·σ3 is rounding noise whatever d
    is), reflections (d = -1) included."""
    W = _case(name)
    R, trace = umeyama_mirror(W)
    np.testing.assert_array_equal(R, svd3_mirror(W, True))
    sep = _separated(W, True)
    Rp, tp_ = ts.umeyama_from_svd_plain(torch.as_tensor(W))
    Rj, tj = _jax_umeyama(W)
    s1 = np.linalg.svd(W.astype(np.float64), compute_uv=False)[..., 0]
    for ref_R, ref_t in ((Rp.numpy(), tp_.numpy()), (Rj, tj)):
        np.testing.assert_allclose(R[sep], ref_R[sep], rtol=0, atol=ATOL)
        assert (np.abs(trace - ref_t) <= ATOL * np.maximum(s1, 1e-30)).all()
    if name == "reflection":
        s = np.linalg.svd(W.astype(np.float64), compute_uv=False)
        np.testing.assert_allclose(trace, s[:, 0] + s[:, 1] - s[:, 2],
                                   rtol=1e-6)


def test_umeyama_mirror_conventions():
    """W = 0 gives the identity and a zero trace, a non-finite W NaN for
    both; the wrapper refuses a CPU tensor."""
    from fpcr_tpu_torch.ops.svd3_cuda import svd3_umeyama_cuda

    R, trace = umeyama_mirror(_case("zero"))
    np.testing.assert_array_equal(R, np.broadcast_to(np.eye(3), R.shape))
    assert (trace == 0).all()
    W = _case("random")[:2].copy()
    W[1, 2, 0] = np.inf
    R, trace = umeyama_mirror(W)
    assert np.isnan(R[1]).all() and np.isnan(trace[1])
    assert np.isfinite(R[0]).all() and np.isfinite(trace[0])
    with pytest.raises(ValueError, match="CUDA"):
        svd3_umeyama_cuda(torch.as_tensor(W))
