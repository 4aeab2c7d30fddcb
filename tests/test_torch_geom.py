"""Geometry of the PyTorch port against the JAX package, on the CPU:
SE(3) maps (round trips at tests/test_geom.py's 1e-3 / 1e-4, equal to
JAX at rtol / atol 1e-6), one dense and one track-form LM step from the
same state (the normal equations at rtol 1e-4 of each block's largest
entry, the step's parameters and rmse at rtol 1e-4 / atol 1e-5),
ba_solve and the track form on test_geom.py's problems at its
thresholds (rmse < 0.45 from > 2 px, dense and tracks within 0.02),
the checkpoint round trip (both packages read each other's), the
deterministic segment sum, and the pose graph at
test_posegraph_closes_noise's thresholds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hesaff_tpu.geom import ba as jba
from hesaff_tpu.geom import posegraph as jpg
from hesaff_tpu.geom import se3 as jse3
from hesaff_tpu_torch.geom import ba, posegraph, se3
from _torch_parity import n, t
from _torch_scenes import ba_problem
from tests.test_geom import make_ba_problem


def _angles(seed, count):
    rng = np.random.RandomState(seed)
    w = rng.randn(count, 3).astype(np.float32)
    # log returns the principal branch: |w| < pi; a few near identity
    w *= (0.95 * np.pi * rng.rand(count, 1)
          / np.linalg.norm(w, axis=1, keepdims=True)).astype(np.float32)
    w[:4] *= 1e-4
    return w


def test_so3_roundtrip_and_jax_equality():
    w = _angles(0, 64)
    R = se3.so3_exp(t(w))
    np.testing.assert_allclose(n(se3.so3_log(R)), w, rtol=1e-3, atol=1e-4)
    RtR = torch.einsum("nij,nik->njk", R, R)
    np.testing.assert_allclose(n(RtR), np.broadcast_to(np.eye(3), RtR.shape),
                               atol=1e-5)
    Rj = np.asarray(jse3.so3_exp(jnp.asarray(w)))
    np.testing.assert_allclose(n(R), Rj, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(n(se3.so3_log(t(Rj))),
                               np.asarray(jse3.so3_log(jnp.asarray(Rj))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(n(se3.hat(t(w))),
                                  np.asarray(jse3.hat(jnp.asarray(w))))


def test_se3_roundtrip_and_jax_equality():
    xi = np.random.RandomState(1).randn(32, 6).astype(np.float32)
    xi[:3, 3:] *= 1e-4
    R, tv = se3.se3_exp(t(xi))
    np.testing.assert_allclose(n(se3.se3_log(R, tv)), xi, rtol=1e-3,
                               atol=1e-4)
    Rj, tj = jse3.se3_exp(jnp.asarray(xi))
    np.testing.assert_allclose(n(R), np.asarray(Rj), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(n(tv), np.asarray(tj), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        n(se3.se3_log(t(Rj), t(tj))), np.asarray(jse3.se3_log(Rj, tj)),
        rtol=1e-6, atol=1e-6)


def _problems(seed=3, init_seed=7, noise=0.3):
    """The same perturbed BA problem for both packages."""
    (rv, tv, X, f, cx, cy, ci, pi, uv) = make_ba_problem(noise=noise,
                                                         seed=seed)
    rng = np.random.RandomState(init_seed)
    arrs = [(rv + rng.randn(*rv.shape) * 0.02).astype(np.float32),
            (tv + rng.randn(*tv.shape) * 0.05).astype(np.float32),
            (X + rng.randn(*X.shape) * 0.05).astype(np.float32)]
    w = np.ones(len(ci), np.float32)
    pj = jba.BAProblem(*map(jnp.asarray, arrs), f, cx, cy, jnp.asarray(ci),
                       jnp.asarray(pi), jnp.asarray(uv), jnp.asarray(w))
    pt = ba.BAProblem(*map(t, arrs), f, cx, cy, t(ci), t(pi), t(uv), t(w))
    return pj, pt


@pytest.fixture(scope="module")
def problems():
    return _problems()


def _assert_params(new_j, new_t):
    for k in ("cam_rvec", "cam_tvec", "points"):
        np.testing.assert_allclose(n(getattr(new_t, k)),
                                   np.asarray(getattr(new_j, k)),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_lm_step_matches_jax(problems):
    pj, pt = problems
    for a, b in zip(jba._build_system(pj), ba._build_system(pt)):
        a = np.asarray(a)
        np.testing.assert_allclose(n(b), a, rtol=1e-4,
                                   atol=1e-4 * np.abs(a).max())
    # lam 0.1: the reduced system is well enough conditioned that float32
    # rounding stays under the tolerance (at 1e-3 from this far out it
    # amplifies the normal equations' 1e-5 differences by ~1e3)
    new_j, err_j = jba._lm_step(pj, 0.1)
    new_t, err_t = ba._lm_step(pt, 0.1)
    _assert_params(new_j, new_t)
    np.testing.assert_allclose(float(err_t), float(err_j), rtol=1e-4)


def test_tracks_lm_step_matches_jax(problems):
    pj, pt = problems
    trj, dj = jba.problem_to_tracks(pj)
    trt, dt = ba.problem_to_tracks(pt)
    assert dj == dt == 0
    for k in ("cam_t", "uv_t", "w_t", "points"):
        np.testing.assert_array_equal(n(getattr(trt, k)),
                                      np.asarray(getattr(trj, k)))
    new_j, err_j = jba._tracks_lm_step(trj, 0.1, True)
    new_t, err_t = ba._tracks_lm_step(trt, 0.1, True)
    _assert_params(new_j, new_t)
    np.testing.assert_allclose(float(err_t), float(err_j), rtol=1e-4)


def test_lm_steps_match_jax_at_solver_damping(problems):
    """Both LM steps at ba_solve's lam0 (1e-3), from JAX's state after 8
    iterations (rmse ~0.36 px): near the optimum the reduced system is
    well conditioned and the steps agree at rtol 1e-4 / atol 1e-5 (from
    the perturbed start the damping is too weak to bound float32
    rounding; see test_lm_step_matches_jax)."""
    pj, pt = problems
    sj, _ = jba.ba_solve(pj, iterations=8)
    arrs = [np.asarray(getattr(sj, k))
            for k in ("cam_rvec", "cam_tvec", "points")]
    st = pt._replace(cam_rvec=t(arrs[0]), cam_tvec=t(arrs[1]),
                     points=t(arrs[2]))
    new_j, err_j = jba._lm_step(sj, 1e-3)
    new_t, err_t = ba._lm_step(st, 1e-3)
    _assert_params(new_j, new_t)
    np.testing.assert_allclose(float(err_t), float(err_j), rtol=1e-4)
    new_j, err_j = jba._tracks_lm_step(jba.problem_to_tracks(sj)[0], 1e-3,
                                       True)
    new_t, err_t = ba._tracks_lm_step(ba.problem_to_tracks(st)[0], 1e-3,
                                      True)
    _assert_params(new_j, new_t)
    np.testing.assert_allclose(float(err_t), float(err_j), rtol=1e-4)


def test_shared_ba_problem_matches_jax_builder(problems):
    """tests/_torch_scenes.ba_problem (the JAX-free copy the card-only
    tests use) builds tests/test_geom.py's perturbed problem."""
    _, pt = problems
    got = ba_problem("cpu")
    for k in ("cam_idx", "pt_idx", "w"):
        np.testing.assert_array_equal(n(getattr(got, k)),
                                      n(getattr(pt, k)), err_msg=k)
    for k in ("cam_rvec", "cam_tvec", "points", "uv"):
        np.testing.assert_allclose(n(getattr(got, k)), n(getattr(pt, k)),
                                   rtol=1e-5, atol=1e-4, err_msg=k)
    assert (got.f, got.cx, got.cy) == (pt.f, pt.cx, pt.cy)


def test_ba_converges_from_perturbed_init():
    (rv, tv, X, f, cx, cy, ci, pi, uv) = make_ba_problem(noise=0.3)
    rng = np.random.RandomState(5)
    p = ba.BAProblem(
        cam_rvec=t(rv + rng.randn(*rv.shape) * 0.02, torch.float32),
        cam_tvec=t(tv + rng.randn(*tv.shape) * 0.05, torch.float32),
        points=t(X + rng.randn(*X.shape) * 0.05, torch.float32),
        f=f, cx=cx, cy=cy, cam_idx=t(ci), pt_idx=t(pi), uv=t(uv),
        w=torch.ones(len(ci)))
    err0 = float(ba.reprojection_rmse(p))
    sol, err = ba.ba_solve(p, iterations=15)
    assert err0 > 2.0          # perturbation really hurt
    assert err < 0.45          # recovered to the noise floor (0.3 px)


def test_ba_tracks_match_dense(problems):
    _, pt = problems
    sol_d, err_d = ba.ba_solve(pt, iterations=12)
    sol_t, err_t = ba.ba_solve_sharded(pt, iterations=12)
    assert err_d < 0.45 and err_t < 0.45
    assert abs(err_t - err_d) < 0.02
    np.testing.assert_allclose(n(sol_t.cam_rvec), n(sol_d.cam_rvec),
                               atol=8e-3)
    np.testing.assert_allclose(n(sol_t.points), n(sol_d.points), atol=6e-2)
    with pytest.raises(ValueError, match="mesh=None"):
        ba.ba_solve_sharded(pt, mesh=object())


def test_checkpoint_roundtrip(tmp_path, problems):
    pj, pt = problems
    path = str(tmp_path / "ba.npz")
    ba.save_checkpoint(path, pt, lam=0.25, iteration=7)
    q, lam, it = ba.load_checkpoint(path, device="cpu")
    assert (lam, it) == (0.25, 7)
    for k in ba.BAProblem._fields:
        a, b = getattr(q, k), getattr(pt, k)
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), k
        else:
            assert a == b, k
    # the JAX package reads the port's checkpoint and the port the JAX one
    qj, lam_j, it_j = jba.load_checkpoint(path)
    np.testing.assert_array_equal(np.asarray(qj.points), n(pt.points))
    path_j = str(tmp_path / "ba_j.npz")
    jba.save_checkpoint(path_j, pj, lam=0.5, iteration=3)
    qt, lam_t, it_t = ba.load_checkpoint(path_j, device="cpu")
    assert (lam_t, it_t) == (0.5, 3)
    np.testing.assert_array_equal(n(qt.uv), np.asarray(pj.uv))


def test_segment_sum_is_exact_and_order_free():
    """Integer-valued rows sum exactly in any order: the segment sum
    equals index_add_ there, for runs of every length up to 37."""
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 9, 200)
    idx[:37] = 4
    vals = rng.integers(-50, 50, (200, 3, 2)).astype(np.float32)
    seg = ba.Segments(t(idx), 11)
    want = torch.zeros(11, 3, 2).index_add_(0, t(idx).long(), t(vals))
    assert torch.equal(seg.sum(t(vals)), want)
    assert len(seg.steps) == 6           # ceil(log2(longest run))


def _pose_graph():
    rng = np.random.RandomState(2)
    N = 12
    rv_gt = np.stack([np.array([0.0, 0.25 * i, 0.0]) for i in range(N)])
    tv_gt = np.stack([np.array([0.8 * i, 0.0, 0.1 * i]) for i in range(N)])

    def rel(i, j):
        Ri = n(se3.so3_exp(t(rv_gt[i], torch.float32)))
        Rj = n(se3.so3_exp(t(rv_gt[j], torch.float32)))
        Rij = Rj @ Ri.T
        return Rij, tv_gt[j] - Rij @ tv_gt[i]

    edges = [(i, i + 1) for i in range(N - 1)] + [(0, N - 1), (0, N // 2)]
    rel_rv, rel_tv = [], []
    for i, j in edges:
        Rij, tij = rel(i, j)
        rel_rv.append(n(se3.so3_log(t(Rij, torch.float32))))
        rel_tv.append(tij)
    rv0 = rv_gt + rng.randn(N, 3) * 0.03
    tv0 = tv_gt + rng.randn(N, 3) * 0.1
    rv0[0], tv0[0] = rv_gt[0], tv_gt[0]  # anchor
    arrs = [rv0.astype(np.float32), tv0.astype(np.float32),
            np.asarray([e[0] for e in edges], np.int32),
            np.asarray([e[1] for e in edges], np.int32),
            np.stack(rel_rv).astype(np.float32),
            np.stack(rel_tv).astype(np.float32),
            np.ones(len(edges), np.float32)]
    return arrs, rv_gt, tv_gt


def test_posegraph_closes_noise():
    arrs, rv_gt, tv_gt = _pose_graph()
    g = posegraph.PoseGraph(*map(t, arrs))
    sol, err = posegraph.pose_graph_solve(g, iterations=15)
    assert err < 1e-3
    np.testing.assert_allclose(n(sol.rvec), rv_gt, atol=5e-3)
    np.testing.assert_allclose(n(sol.tvec), tv_gt, atol=2e-2)
    # one Gauss-Newton step from the same state as the JAX package's
    gj = jpg.PoseGraph(*map(jnp.asarray, arrs))
    new_j, err_j = jpg._gn_step(gj, 1e-4)
    new_t, err_t = posegraph._gn_step(g, 1e-4)
    np.testing.assert_allclose(n(new_t.rvec), np.asarray(new_j.rvec),
                               atol=1e-4)
    np.testing.assert_allclose(n(new_t.tvec), np.asarray(new_j.tvec),
                               atol=1e-4)
    np.testing.assert_allclose(
        n(posegraph.pose_graph_residuals(g)),
        np.asarray(jpg.pose_graph_residuals(gj)), rtol=1e-5, atol=1e-6)
