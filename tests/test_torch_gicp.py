"""The port's Generalized-ICP (``fpcr_tpu_torch/ops/gicp.py`` and
``metric='gicp'``) against ``fpcr_tpu``'s on the same numpy inputs (CPU):
the covariances, the dense inverse, the Woodbury normal equations, the
solve's degenerate guard and whole registrations."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fpcr_tpu as f
import fpcr_tpu_torch as ft
from fpcr_tpu.ops import gicp as jg
from fpcr_tpu_torch.ops import gicp as tg

torch.set_num_threads(2)

GAP = 1e-5  # transform RMSE between the two packages' results
# H and g: float32 sums of N products in two libraries' orders
REL = 1e-4


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _unit(v):
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _inputs(seed, n=300):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(n, 3)).astype(np.float32)
    q = (p + 0.01 * rng.normal(size=(n, 3))).astype(np.float32)
    return (p, q, _unit(rng.normal(size=(n, 3))),
            _unit(rng.normal(size=(n, 3))), rng.random(n) > 0.2)


@pytest.mark.parametrize("eps", [1e-3, 0.3, 1.0])
def test_normal_covariances_match_jax(eps):
    n = _inputs(0)[2]
    got = tg.normal_covariances(_t(n), eps).numpy()
    np.testing.assert_allclose(got, np.asarray(jg.normal_covariances(
        jnp.asarray(n), eps)), atol=1e-7)
    w = np.linalg.eigvalsh(got[0].astype(np.float64))
    np.testing.assert_allclose(np.sort(w), [eps, 1.0, 1.0], atol=1e-6)


@pytest.mark.parametrize("kind", ["spd", "singular"])
def test_inv3x3_sym_matches_jax(kind):
    rng = np.random.default_rng(1)
    B = rng.normal(size=(64, 3, 3))
    A = B @ np.swapaxes(B, 1, 2) + 0.5 * np.eye(3)
    if kind == "singular":  # rank 1: the determinant guard binds
        v = rng.normal(size=(64, 3, 1))
        A = v @ np.swapaxes(v, 1, 2)
    A = A.astype(np.float32)
    got = tg.inv3x3_sym(_t(A)).numpy()
    want = np.asarray(jg.inv3x3_sym(jnp.asarray(A)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    if kind == "spd":
        np.testing.assert_allclose(got, np.linalg.inv(A), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("eps", [1e-3, 1.0])
def test_normal_equations_match_jax(masked, eps):
    p, q, n_p, n_q, mask = _inputs(3)
    m = mask if masked else None
    H, g = tg.gicp_normal_equations(_t(p), _t(q), _t(n_p), _t(n_q),
                                    None if m is None else _t(m),
                                    epsilon=eps)
    Hj, gj = jg.gicp_normal_equations(
        jnp.asarray(p), jnp.asarray(q), jnp.asarray(n_p), jnp.asarray(n_q),
        None if m is None else jnp.asarray(m), epsilon=eps)
    Hj, gj = np.asarray(Hj), np.asarray(gj)
    np.testing.assert_allclose(H.numpy(), Hj, rtol=REL,
                               atol=REL * np.abs(Hj).max())
    np.testing.assert_allclose(g.numpy(), gj, rtol=REL,
                               atol=REL * np.abs(gj).max())


def test_woodbury_equals_dense_assembly():
    """The Woodbury form against the dense assembly of every point's
    ``J_iᵀ M_i J_i`` with ``M_i = inv3x3_sym(C_p + C_q)``, in float64."""
    p, q, n_p, n_q, mask = _inputs(4, n=120)
    eps = 1e-3
    t64 = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    C = (tg.normal_covariances(t64(n_p), eps)
         + tg.normal_covariances(t64(n_q), eps))
    M = tg.inv3x3_sym(C)
    eye = torch.eye(3, dtype=torch.float64).expand(len(p), 3, 3)
    J = torch.cat([-tg._skew(t64(p)), eye], dim=2)  # r(x) = r0 + J (w, t)
    w = t64(mask)[:, None, None]
    H_dense = (w * J.transpose(1, 2) @ M @ J).sum(0)
    g_dense = (w[:, :, 0] * (J.transpose(1, 2) @ M @ t64(p - q)[:, :, None]
                             )[:, :, 0]).sum(0)
    H, g = tg.gicp_normal_equations(_t(p), _t(q), _t(n_p), _t(n_q),
                                    _t(mask), epsilon=eps)
    np.testing.assert_allclose(H.numpy(), H_dense.numpy(), rtol=REL,
                               atol=REL * float(H_dense.abs().max()))
    np.testing.assert_allclose(g.numpy(), g_dense.numpy(), rtol=REL,
                               atol=REL * float(g_dense.abs().max()))


def test_solve_update_is_identity_on_a_line_cloud():
    """A 1-D line cloud makes every normal pair parallel and H singular:
    the update is the identity, never NaN, as in the JAX package; a tiny
    epsilon stays finite through the determinant floor."""
    x = np.linspace(-1, 1, 64, dtype=np.float32)
    p = np.stack([x, np.zeros_like(x), np.zeros_like(x)], 1)
    n = np.tile(np.float32([0, 0, 1]), (64, 1))
    H, g = tg.gicp_normal_equations(_t(p), _t(p + 0.01), _t(n), _t(n),
                                    epsilon=1e-9)
    assert torch.isfinite(H).all() and torch.isfinite(g).all()
    for Hm in (H, torch.zeros((6, 6)), torch.full((6, 6), float("nan"))):
        tr, xvec = tg.gicp_solve_update(Hm, g)
        assert torch.isfinite(xvec).all()
        if not torch.isfinite(Hm).all() or not Hm.any():
            assert torch.equal(xvec, torch.zeros(6))
            assert torch.equal(tr.rotation, torch.eye(3))
    Hj, gj = jg.gicp_normal_equations(jnp.asarray(p), jnp.asarray(p + 0.01),
                                      jnp.asarray(n), jnp.asarray(n),
                                      epsilon=1e-9)
    _, xj = jg.gicp_solve_update(Hj, gj)
    _, xt = tg.gicp_solve_update(H, g)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-5)


def test_solve_update_matches_jax():
    p, q, n_p, n_q, mask = _inputs(5)
    H, g = tg.gicp_normal_equations(_t(p), _t(q), _t(n_p), _t(n_q), _t(mask))
    tr, x = tg.gicp_solve_update(H, g, damping=1e-3)
    trj, xj = jg.gicp_solve_update(jnp.asarray(H.numpy()),
                                   jnp.asarray(g.numpy()), damping=1e-3)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(tr.rotation.numpy(), np.asarray(trj.rotation),
                               atol=1e-6)


def _rmse_between(a, b, probe):
    Ra, ta = (np.asarray(x) for x in a)
    Rb, tb = (np.asarray(x) for x in b)
    d = (probe @ Ra.T + ta) - (probe @ Rb.T + tb)
    return float(np.sqrt((d * d).sum(1).mean()))


def _scene(name):
    """``(source, target, (R, t) of the ground truth)`` as numpy."""
    if name == "bunny":
        s = f.bunny_scene()
    elif name.startswith("morton"):
        src = f.synthetic_scene(width=48).source
        gt = f.gt_transform((0.01, -0.02, 0.015), (0.02, -0.01, 0.02))
        s = f.RegistrationScene(src, gt.apply(src), gt)
    else:
        s = f.synthetic_scene(width=int(name.split("-")[1]))
    g = s.ground_truth
    return (np.array(s.source), np.array(s.target),
            (np.array(g.rotation), np.array(g.translation)))


RUNS = {  # key: (scene, config fields, whether JAX's normals are handed in)
    "synthetic-24": ("synthetic-24", dict(exact_distances=True), False),
    "synthetic-32": ("synthetic-32", dict(), True),
    "synthetic-32-damped": ("synthetic-32", dict(damping=1e-3,
                                                 gicp_epsilon=0.05), True),
    "bunny": ("bunny", dict(), True),
    "morton-48": ("morton-48", dict(matcher="morton", morton_impl="xla",
                                    max_iterations=25), True),
}


@pytest.mark.parametrize("key", list(RUNS))
def test_gicp_run_matches_jax(key):
    """Whole GICP registrations: equal iteration counts, transforms within
    1e-5 RMSE of each other and of the ground truth (1e-4 on the Morton
    run, the JAX test's bound there)."""
    scene, kw, given = RUNS[key]
    src, tgt, gt = _scene(scene)
    kw = dict(dict(metric="gicp", max_iterations=40), **kw)
    normals = {}
    if given:
        normals = {k: np.array(f.estimate_normals(jnp.asarray(c)))
                   for k, c in (("source_normals", src),
                                ("target_normals", tgt))}
    j = f.run_icp(jnp.asarray(src), jnp.asarray(tgt), f.ICPConfig(**kw),
                  **{k: jnp.asarray(v) for k, v in normals.items()})
    t = ft.run_icp(torch.as_tensor(src), torch.as_tensor(tgt),
                   ft.ICPConfig(**kw),
                   **{k: torch.as_tensor(v) for k, v in normals.items()})
    nj, nt = int(j.num_iterations), int(t.num_iterations)
    assert nj == nt, (nj, nt)
    assert bool(t.converged) == bool(j.converged)
    assert torch.isnan(t.errors[nt:]).all()
    assert torch.isfinite(t.errors[:nt]).all()
    tr = (t.transform.rotation, t.transform.translation)
    assert _rmse_between(tr, (j.transform.rotation, j.transform.translation),
                         src) < GAP
    assert _rmse_between(tr, gt, src) < (1e-4 if "morton" in key else 1e-5)


def test_icp_generalized_fixes_the_metric():
    s = ft.synthetic_scene(width=16, device="cpu")
    a = ft.icp_generalized(s.source, s.target, max_iterations=40)
    b = ft.run_icp(s.source, s.target, ft.ICPConfig(metric="gicp"))
    assert torch.equal(a.transform.rotation, b.transform.rotation)
    with pytest.raises(ValueError, match="metric is fixed"):
        ft.icp_generalized(s.source, s.target, metric="plane")


def jax_references():
    """The JAX package's CPU runs that set ``chip_smoke.py``'s GICP
    thresholds and iteration counts (``GICP_SCENES``) and the fitness of
    ``evaluate_registration`` at 16,384: its ``'xla'`` matcher, the card's
    scenes at full size."""
    near = ((0.004, -0.002, 0.003), (0.002, -0.003, 0.002))
    scenes = [("synthetic-16384", f.synthetic_scene(128), {}),
              ("bunny-8171", f.bunny_scene(), {}),
              ("hall-16384", f.hall_scene(), {}),
              ("morton synthetic-1048576",
               f.transformed_scene(f.surface_grid(1024), *near),
               dict(matcher="morton", morton_chunk=512, morton_window=64,
                    max_iterations=25))]
    for name, s, kw in scenes:
        cfg = f.ICPConfig(**dict(dict(metric="gicp", max_iterations=40),
                                 **kw))
        r = f.run_icp(s.source, s.target, cfg)
        err = float(f.transform_rmse(r.transform, s.ground_truth, s.source))
        print(f"gicp {name}: {int(r.num_iterations)} iterations, GT "
              f"transform RMSE {err:.3e}", flush=True)
        if name == "synthetic-16384":
            q = f.evaluate_registration(s.source, s.target, r.transform)
            print(f"  evaluate_registration fitness {float(q['fitness'])}",
                  flush=True)


if __name__ == "__main__":
    jax_references()
