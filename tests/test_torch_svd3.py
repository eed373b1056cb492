"""Kernel svd3's arithmetic (``fpcr_tpu_torch/csrc/svd3.cu``) on the CPU.

The kernel runs only on the card. Here its two designs are mirrored in
numpy, statement for statement: the first design, the yardstick now
(``svd3_fixed_one``: 8 float64 sweeps), by this file's ``svd3_mirror`` and
``umeyama_mirror``; the kernel's design (``svd3_one``: float32 sweeps to a
stop test, a float64 polish to its own) by ``ops/svd3_mirror.py``, which
the card's tests also hold the kernel to. Both are held against JAX's
``fpcr_tpu.ops.solve.rotation_from_svd`` and the port's plain version
(``torch.linalg.svd`` on a CPU tensor) on random matrices, rank 2 and rank 1
(a plane and a line cloud), reflections, repeated singular values, ``W = 0``
and NaN; ``tests/test_torch_gpu.py`` holds the kernels themselves to both.

Tolerance: 1e-6 absolute on R where σ2 − σ3 > 1e-3·σ1 (without the det fix
also σ3 > 1e-3·σ1), and RᵀR = I within 1e-6 everywhere, det R = +1 with the
det fix. Why: R = U·Vᵀ is unique where the smallest
singular value is separated from the next (the det fix flips the third
column of U, whose direction is then defined); both references take a
float32 SVD, whose R is off by about float32's epsilon times σ1 over the
gaps, under 1e-6 at the gaps of these cases, while the mirrors' float64 R
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
from fpcr_tpu_torch.ops import svd3_mirror as sm
from fpcr_tpu_torch.ops.svd3_cuda import svd3_rotation_cuda

SWEEPS = 8  # csrc/svd3.cu: kSweeps, the yardstick's fixed count
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
    """The yardstick's R of one matrix; with ``umeyama`` (Umeyama's form,
    the det fix on) ``(R, trace)``."""
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
    """The yardstick's R for each 3x3 of ``W`` [..., 3, 3] (float32)."""
    W = np.asarray(W, np.float32)
    out = np.empty(W.shape, np.float32)
    for idx in np.ndindex(W.shape[:-2]):
        out[idx] = _mirror_one(W[idx], det_correction)
    return out


def umeyama_mirror(W):
    """The yardstick's Umeyama form for each 3x3 of ``W`` [..., 3, 3]:
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


def _against_jax_and_plain(mirror, name, det_correction):
    W = _case(name)
    mine = mirror(W, det_correction)
    _check_rotation(mine, proper=det_correction)
    sep = _separated(W, det_correction)
    if name in ("reflection", "kabsch", "random") or (
            name == "rank 2" and det_correction):
        assert sep.any()  # the case reaches the full check
    for ref in (_jax(W, det_correction), _plain(W, det_correction)):
        np.testing.assert_allclose(mine[sep], ref[sep], rtol=0, atol=ATOL)
    return mine, sep


@pytest.mark.parametrize("det_correction", [True, False])
@pytest.mark.parametrize("name", CASES)
def test_mirror_against_jax_and_plain(name, det_correction):
    _against_jax_and_plain(svd3_mirror, name, det_correction)


def _zero_is_identity(mirror):
    W = _case("zero")
    for R in (mirror(W), _jax(W, True), _plain(W, True)):
        np.testing.assert_array_equal(R, np.broadcast_to(np.eye(3), W.shape))


def test_mirror_zero_is_identity():
    """W = 0 gives the identity in the mirror, JAX and the plain version."""
    _zero_is_identity(svd3_mirror)


def _rank_deficient_is_proper(mirror):
    for name in ("rank 1", "rank 2"):
        W = _case(name)
        _check_rotation(mirror(W, True))
        _check_rotation(mirror(W, False), proper=False)


def test_mirror_rank_deficient_is_proper():
    """A line or plane cloud's W gives a rotation with det +1, and without
    the det fix an orthogonal R."""
    _rank_deficient_is_proper(svd3_mirror)


def _non_finite_gives_nan(mirror, where, value):
    W = _case("random")[:3].copy()
    W[1][where] = value
    R = mirror(W)
    assert np.isnan(R[1]).all()
    assert np.isfinite(R[[0, 2]]).all()
    if np.isnan(value):
        assert np.isnan(_jax(W, True)[1]).all()
        with pytest.raises(Exception):
            _plain(W, True)


@pytest.mark.parametrize("where", [(0, 0), (1, 2), (2, 1)])
@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf])
def test_mirror_non_finite_gives_nan(where, value):
    """A non-finite entry gives a NaN R, as JAX gives for NaN; the plain
    version (LAPACK) raises on NaN instead."""
    _non_finite_gives_nan(svd3_mirror, where, value)


def test_mirror_converges_within_the_sweeps():
    """The yardstick's fixed sweep count is enough: one sweep more moves no
    entry of the rounded R by more than one float32 ulp (the float64 R
    moves by ~1e-16, which can cross a rounding boundary)."""
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


def _umeyama_against_jax_and_plain(umeyama, rotation, name):
    W = _case(name)
    R, trace = umeyama(W)
    np.testing.assert_array_equal(R, rotation(W, True))
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
    return trace


@pytest.mark.parametrize("name", CASES)
def test_umeyama_mirror_against_jax_and_plain(name):
    """svd3's Umeyama form: its R is the rotation form's with the det fix,
    bit for bit, and within 1e-6 of JAX's and the plain version's where R
    is unique; its trace σ1 + σ2 + d·σ3 within 1e-6 of σ1 of both
    everywhere (at rank 2 and below d·σ3 is rounding noise whatever d
    is), reflections (d = -1) included."""
    _umeyama_against_jax_and_plain(umeyama_mirror, svd3_mirror, name)


def _umeyama_conventions(umeyama):
    from fpcr_tpu_torch.ops.svd3_cuda import svd3_umeyama_cuda

    R, trace = umeyama(_case("zero"))
    np.testing.assert_array_equal(R, np.broadcast_to(np.eye(3), R.shape))
    assert (trace == 0).all()
    W = _case("random")[:2].copy()
    W[1, 2, 0] = np.inf
    R, trace = umeyama(W)
    assert np.isnan(R[1]).all() and np.isnan(trace[1])
    assert np.isfinite(R[0]).all() and np.isfinite(trace[0])
    with pytest.raises(ValueError, match="CUDA"):
        svd3_umeyama_cuda(torch.as_tensor(W))


def test_umeyama_mirror_conventions():
    """W = 0 gives the identity and a zero trace, a non-finite W NaN for
    both; the wrapper refuses a CPU tensor."""
    _umeyama_conventions(umeyama_mirror)


# ---- the kernel's design (ops/svd3_mirror.py): float32 sweeps to a stop
# test, then a float64 polish to its own ----

ULP = 2.0 ** -23  # one float32 ulp at 1, R's largest entries


@pytest.mark.parametrize("det_correction", [True, False])
@pytest.mark.parametrize("name", CASES)
def test_design_mirror_against_jax_and_plain(name, det_correction):
    """The kernel's design: within 1e-6 of JAX's R and the plain version's
    where R is unique, a rotation everywhere, and where R is unique within
    one float32 ulp of the yardstick's R (both polish to the same float64
    R before rounding)."""
    mine, sep = _against_jax_and_plain(sm.svd3_rotation_mirror, name,
                                       det_correction)
    np.testing.assert_allclose(mine[sep],
                               svd3_mirror(_case(name), det_correction)[sep],
                               rtol=0, atol=ULP)


def test_design_mirror_zero_is_identity():
    """W = 0 gives the identity, as in JAX and the plain version."""
    _zero_is_identity(sm.svd3_rotation_mirror)


def test_design_mirror_rank_deficient_is_proper():
    """A line or plane cloud's W gives a rotation with det +1, and without
    the det fix an orthogonal R."""
    _rank_deficient_is_proper(sm.svd3_rotation_mirror)


@pytest.mark.parametrize("where", [(0, 0), (1, 2), (2, 1)])
@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf])
def test_design_mirror_non_finite_gives_nan(where, value):
    """A non-finite entry gives a NaN R, as JAX gives for NaN."""
    _non_finite_gives_nan(sm.svd3_rotation_mirror, where, value)


@pytest.mark.parametrize("name", CASES)
def test_design_umeyama_mirror_against_jax_and_plain(name):
    """The kernel's Umeyama form: R bit for bit its rotation form's with
    the det fix, R and the trace held to JAX's and the plain version's as
    the yardstick's are, and the trace within 1e-6 of σ1 of the
    yardstick's."""
    trace = _umeyama_against_jax_and_plain(sm.svd3_umeyama_mirror,
                                           sm.svd3_rotation_mirror, name)
    W = _case(name)
    s1 = np.linalg.svd(W.astype(np.float64), compute_uv=False)[..., 0]
    assert (np.abs(trace - umeyama_mirror(W)[1])
            <= ATOL * np.maximum(s1, 1e-30)).all()


def test_design_umeyama_mirror_conventions():
    """W = 0 gives the identity and a zero trace, a non-finite W NaN for
    both."""
    _umeyama_conventions(sm.svd3_umeyama_mirror)


def _zeta_overflow():
    """W whose first two columns are orthogonal but for a γ with |ζ| =
    |β − α| / 2|γ| = 2.5e19: ζ² overflows float32, and a rotation that
    forms it finds t = 0 and never rotates the pair."""
    return np.array([[[1.0, 2e-20, 0.0], [0.0, 1e-14, 0.0],
                      [0.0, 0.0, 0.5]]], np.float32)


def test_design_rotation_takes_a_large_zeta_without_overflow():
    """The float32 rotation of a pair with |ζ| > 1e19 is finite, is not
    skipped, and makes the pair orthogonal with sin θ = 1/(2ζ),
    Rutishauser's large-ζ tangent; the whole matrix then gives JAX's and
    the plain version's R."""
    W = _zeta_overflow()
    a = (W[0].astype(np.float64) * 0.5).astype(np.float32)  # scaled by 2^-1
    col = a.astype(np.float64)
    zeta = ((col[:, 1] @ col[:, 1] - col[:, 0] @ col[:, 0])
            / (2.0 * (col[:, 0] @ col[:, 1])))
    assert abs(zeta) > 1e19
    with np.errstate(over="ignore"):
        assert np.isinf(np.float32(zeta) * np.float32(zeta))
    v = np.eye(3, dtype=np.float32)
    assert sm.rotate(a, v, 0, 1, sm.TOL32)
    assert np.isfinite(a).all() and np.isfinite(v).all()
    np.testing.assert_allclose(v[0, 1], 1.0 / (2.0 * zeta), rtol=1e-6)
    assert not sm.rotate(a, v, 0, 1, sm.TOL32)  # orthogonal now
    sweeps = sm.svd3_sweeps(W)[0]
    assert sweeps.f32_converged and sweeps.f64_converged
    R = sm.svd3_rotation_mirror(W)
    for ref in (_jax(W, True), _plain(W, True)):
        np.testing.assert_allclose(R, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("det_correction", [True, False])
def test_design_stop_rule_leaves_nothing_to_rotate(det_correction):
    """Where the polish stops, one more float64 sweep, every pair rotated
    unless γ = 0, moves no entry of the rounded R by more than one float32
    ulp (the float64 R moves by ~1e-16, which can cross a rounding
    boundary)."""
    W = np.concatenate([_case(name) for name in CASES] + [_zeta_overflow()])
    base = sm.svd3_rotation_mirror(W, det_correction)
    more = sm.svd3_rotation_mirror(W, det_correction, extra_sweeps=1)
    np.testing.assert_allclose(base, more, rtol=0, atol=ULP)


def test_design_sweeps_stop_before_the_cap():
    """The sweeps the design takes on this file's cases, logged as a
    histogram ``{"float32/float64 sweeps that rotated": matrices}``: every
    float64 polish ends on a sweep that rotates nothing, before the
    cap."""
    every = []
    for name in CASES + ["zeta overflow"]:
        W = _zeta_overflow() if name == "zeta overflow" else _case(name)
        got = sm.svd3_sweeps(W)
        hist = {}
        for sw in got:
            key = f"{sw.f32}/{sw.f64}"
            hist[key] = hist.get(key, 0) + 1
        print(f"svd3 sweeps, {name}: {dict(sorted(hist.items()))}")
        every += got
    assert all(sw.f64_converged and sw.f64 < sm.SWEEPS for sw in every)
    assert max(sw.f64 for sw in every) <= 3
