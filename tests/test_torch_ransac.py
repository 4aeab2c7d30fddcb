"""The port's batched RANSAC on the CPU, on the synthetic scenes of
tests/test_ransac.py, held to that file's own outcome thresholds and to
the JAX package's outcomes on the same points.

The port draws its minimal sets from a torch.Generator, JAX from its
PRNG keys, so the two are compared on outcomes: the inlier counts
within 1% of N.  The refit, which is deterministic, is compared on
values: with the inlier mask fixed, H / H[2,2] within 1e-4 (rtol and
atol) of JAX's, both in float32 through the 9x9 normal matrix.  The
plain Sampson distance (the K8 kernel's twin) equals the benchmark's
plain reference bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmark.reference import pairs
from hesaff_tpu import ransac as jransac
from hesaff_tpu_torch import ransac
from hesaff_tpu_torch.ops import cuda_ransac
from tests.test_ransac import make_homography_data, make_two_view_data
from _torch_parity import n


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_homography_outcomes(seed):
    p1, p2, H, n_out = make_homography_data()
    res = ransac.ransac_homography(p1, p2, threshold=9.0,
                                   num_hypotheses=512, seed=seed,
                                   device="cpu")
    inl = n(res.inliers)
    assert res.model.shape == (3, 3) and inl.dtype == bool
    assert int(res.num_inliers) == inl.sum()
    assert res.num_inliers.dtype == torch.int32
    assert inl[n_out:].mean() > 0.97
    assert inl[:n_out].mean() < 0.05
    Hm = n(res.model).astype(np.float64)
    np.testing.assert_allclose(Hm / Hm[2, 2], H / H[2, 2], rtol=0.05,
                               atol=0.05)
    ref = jransac.ransac_homography(p1, p2, threshold=9.0,
                                    num_hypotheses=512, seed=seed)
    assert abs(int(res.num_inliers) - int(ref.num_inliers)) <= 0.01 * len(p1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fundamental_and_pose_outcomes(seed):
    p1, p2, K, R, t, n_out = make_two_view_data()
    res = ransac.ransac_fundamental(p1, p2, threshold=3.0,
                                    num_hypotheses=1024, seed=seed,
                                    device="cpu")
    inl = n(res.inliers)
    assert inl[n_out:].mean() > 0.95
    assert inl[:n_out].mean() < 0.1
    ref = jransac.ransac_fundamental(p1, p2, threshold=3.0,
                                     num_hypotheses=1024, seed=seed)
    assert abs(int(res.num_inliers) - int(ref.num_inliers)) <= 0.01 * len(p1)

    E = ransac.essential_from_fundamental(res.model, K, K)
    Kinv = np.linalg.inv(K)
    sel = np.nonzero(inl)[0]
    h1 = np.concatenate([p1[sel], np.ones((len(sel), 1))], 1) @ Kinv.T
    h2 = np.concatenate([p2[sel], np.ones((len(sel), 1))], 1) @ Kinv.T
    Rm, tm = ransac.decompose_essential(E, h1[:, :2], h2[:, :2])
    Rm, tm = n(Rm).astype(np.float64), n(tm).astype(np.float64)
    ang = np.degrees(np.arccos(np.clip((np.trace(Rm.T @ R) - 1) / 2, -1, 1)))
    assert ang < 1.0
    cos = abs(tm @ t / (np.linalg.norm(tm) * np.linalg.norm(t)))
    assert cos > 0.98


@pytest.mark.parametrize("model", ["homography", "fundamental"])
def test_refit_kept_only_where_it_keeps_inliers(monkeypatch, model):
    """A refit round whose model keeps fewer inliers than the model it
    refits is dropped: with a refit that returns NaN (no inliers), the
    result is the best hypothesis and its inliers."""
    if model == "homography":
        p1, p2, _, _ = make_homography_data()
        run, k, thr = ransac.ransac_homography, 4, 9.0
    else:
        p1, p2, _, _, _, _ = make_two_view_data()
        run, k, thr = ransac.ransac_fundamental, 8, 3.0
    solve, resid, refit = ransac._MODELS[model]
    monkeypatch.setitem(ransac._MODELS, model, (
        solve, resid, lambda *a: torch.full((3, 3), float("nan"))))
    res = run(p1, p2, threshold=thr, num_hypotheses=256, seed=0,
              device="cpu")
    g = torch.Generator().manual_seed(0)
    sel = ransac.draw_minimal_sets(len(p1), 256, k, g)
    q1, q2 = (torch.as_tensor(p, dtype=torch.float32) for p in (p1, p2))
    models = solve(q1[sel], q2[sel])
    counts = (resid(models, q1, q2) < thr).sum(1)
    best = models[counts.argmax()]
    torch.testing.assert_close(res.model, best, rtol=0, atol=0)
    assert int(res.num_inliers) == int(counts.max()) > len(p1) // 2
    assert torch.equal(res.inliers, resid(best, q1, q2) < thr)


def test_essential_and_pose_equal_jax():
    """E from the same F, and the pose from E, against JAX's (the SVD's
    signs are arbitrary: E up to sign, R exactly chosen by cheirality)."""
    p1, p2, K, R, t, n_out = make_two_view_data()
    F = np.array(jransac.ransac_fundamental(p1, p2).model)
    E = n(ransac.essential_from_fundamental(F, K, K, device="cpu"))
    Ej = np.array(jransac.essential_from_fundamental(F, K, K))
    sign = np.sign((E * Ej).sum())
    np.testing.assert_allclose(E * sign, Ej, atol=1e-4)
    Kinv = np.linalg.inv(K)
    h1 = (np.concatenate([p1[n_out:], np.ones((len(p1) - n_out, 1))], 1)
          @ Kinv.T)[:, :2]
    h2 = (np.concatenate([p2[n_out:], np.ones((len(p2) - n_out, 1))], 1)
          @ Kinv.T)[:, :2]
    Rm, tm = ransac.decompose_essential(Ej, h1, h2, device="cpu")
    Rj, tj = jransac.decompose_essential(jnp.asarray(Ej), h1, h2)
    np.testing.assert_allclose(n(Rm), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(n(tm), np.asarray(tj), atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_refit_h_equals_jax(seed):
    """A planted exact set: 80 points through the scene's H, 30% of them
    moved off it and masked out; the refit H equals JAX's."""
    H = make_homography_data()[2]
    rng = np.random.default_rng(seed)
    q1 = rng.random((80, 2)) * 500
    ph = np.concatenate([q1, np.ones((80, 1))], 1) @ H.T
    q2 = ph[:, :2] / ph[:, 2:]
    w = (rng.random(80) < 0.7).astype(np.float32)
    q2[w == 0] += rng.random((int((w == 0).sum()), 2)) * 100
    f32 = lambda a: np.asarray(a, np.float32)
    ref = np.asarray(jransac._refit_h(jnp.asarray(f32(q1)),
                                      jnp.asarray(f32(q2)), jnp.asarray(w)))
    out = n(ransac._refit_h(torch.from_numpy(f32(q1)),
                            torch.from_numpy(f32(q2)), torch.from_numpy(w)))
    np.testing.assert_allclose(out / out[2, 2], ref / ref[2, 2], rtol=1e-4,
                               atol=1e-4)


def _unit(F):
    """F at unit Frobenius norm, its largest entry positive (a null
    vector's sign is arbitrary)."""
    F = np.asarray(F, np.float64) / np.linalg.norm(F)
    return F * np.sign(F.flat[np.argmax(np.abs(F))])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_refit_f_equals_jax(seed):
    """A planted exact two-view set (make_two_view_data's cameras, no
    noise), 30% of it moved off and masked out.  Through the float32 9x9
    normal matrix each package's F lands within ~2e-3 of the true F
    (unit norm); they agree within 5e-3 and each is within 3e-3 of it."""
    rng = np.random.default_rng(seed)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    a = 0.15
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]])
    t = np.array([0.5, 0.05, 0.1])
    X = rng.random((100, 3)) * [4, 3, 4] + [-2, -1.5, 4]
    q1 = ((X / X[:, 2:3]) @ K.T)[:, :2]
    X2 = X @ R.T + t
    q2 = ((X2 / X2[:, 2:3]) @ K.T)[:, :2]
    w = (rng.random(100) < 0.7).astype(np.float32)
    q2[w == 0] += rng.random((int((w == 0).sum()), 2)) * 100
    f32 = lambda a: np.asarray(a, np.float32)
    ref = _unit(jransac._refit_f(jnp.asarray(f32(q1)), jnp.asarray(f32(q2)),
                                 jnp.asarray(w)))
    out = _unit(n(ransac._refit_f(torch.from_numpy(f32(q1)),
                                  torch.from_numpy(f32(q2)),
                                  torch.from_numpy(w))))
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    Kinv = np.linalg.inv(K)
    true = _unit(Kinv.T @ tx @ R @ Kinv)
    np.testing.assert_allclose(out, ref, atol=5e-3)
    np.testing.assert_allclose(out, true, atol=3e-3)
    np.testing.assert_allclose(ref, true, atol=3e-3)


def test_minimal_sets_are_distinct_and_seeded():
    g = torch.Generator().manual_seed(5)
    sel = ransac.draw_minimal_sets(9, 256, 8, g)
    assert sel.shape == (256, 8) and int(sel.max()) < 9
    assert all(len(set(r.tolist())) == 8 for r in sel)
    again = ransac.draw_minimal_sets(9, 256, 8,
                                     torch.Generator().manual_seed(5))
    assert torch.equal(sel, again)


@pytest.mark.parametrize("fn,k", [(ransac.ransac_homography, 4),
                                  (ransac.ransac_fundamental, 8)])
def test_too_few_points_raise(fn, k):
    """Fewer points than the minimal set raise, as jax.random.choice
    without replacement does."""
    pts = np.zeros((k - 1, 2))
    with pytest.raises(ValueError, match="without replacement"):
        fn(pts, pts, device="cpu")


@pytest.mark.parametrize("scene", ["homography", "two_view"])
def test_cuda_test_scenes_are_test_ransacs(scene):
    """tests/test_torch_cuda.py, which runs without JAX, keeps its own
    copies of make_homography_data and make_two_view_data; they make
    the same scenes."""
    import test_torch_cuda

    mine, ref = {"homography": (test_torch_cuda.homography_scene,
                                make_homography_data),
                 "two_view": (test_torch_cuda.two_view_scene,
                              make_two_view_data)}[scene]
    for a, b in zip(mine(), ref()):
        np.testing.assert_array_equal(a, b)


def _hypotheses(seed, h):
    """h F hypotheses of make_two_view_data's scene (its points as float32
    tensors), the first three replaced by a NaN model, a model whose
    denominator falls under 1e-12 everywhere and the zero model."""
    p1, p2 = (torch.as_tensor(p, dtype=torch.float32)
              for p in make_two_view_data(seed=seed)[:2])
    g = torch.Generator().manual_seed(seed)
    sel = ransac.draw_minimal_sets(len(p1), h, 8, g)
    models = ransac._solve_f_8pt(p1[sel], p2[sel])
    models[0] = float("nan")
    models[1] = models[4] * 1e-9
    models[2] = 0.0
    return models, p1, p2


@pytest.mark.parametrize("seed,h", [(0, 64), (1, 300), (2, 1024)])
def test_f_residuals_equal_reference_sampson(seed, h):
    """ransac._f_residuals, the K8 kernel's plain twin, gives
    benchmark/reference/pairs.sampson's float32 values bit for bit (NaN
    where the model is NaN, the clamp where the denominator underflows),
    for a batch of models and for one, and so the same counts."""
    models, p1, p2 = _hypotheses(seed, h)
    mine, ref = ransac._f_residuals(models, p1, p2), pairs.sampson(
        models, p1, p2)
    assert mine.shape == (h, len(p1)) and mine.dtype == torch.float32
    torch.testing.assert_close(mine, ref, rtol=0, atol=0, equal_nan=True)
    assert bool(mine[0].isnan().all()) and not bool(mine[3:].isnan().any())
    assert bool((mine[2] == 0).all())
    for k in (1, 3):
        torch.testing.assert_close(ransac._f_residuals(models[k], p1, p2),
                                   ref[k], rtol=0, atol=0, equal_nan=True)
    for thr in (3.0, float(ref[3, 5])):
        assert torch.equal((mine < thr).sum(1), (ref < thr).sum(1))


@pytest.mark.parametrize("h,n,n_sm", [(10000, 51000, 132), (10000, 1400, 132),
                                      (1024, 300, 132), (513, 257, 132),
                                      (1, 8, 1), (20000, 10**6, 114)])
def test_score_plan_covers_the_matches(h, n, n_sm):
    """The K8 grid's chunks of matches are whole tiles, none empty, and
    together hold every match; with enough tiles the grid gives each SM
    about CTAS_PER_SM CTAs."""
    chunk, chunks = cuda_ransac.plan(h, n, n_sm)
    assert chunk % cuda_ransac.TILE == 0 and 1 <= chunks <= 65535
    assert (chunks - 1) * chunk < n <= chunks * chunk
    ctas = -(-h // cuda_ransac.HYPS) * chunks
    if chunks * chunk >= cuda_ransac.CTAS_PER_SM * n_sm * cuda_ransac.TILE:
        assert cuda_ransac.CTAS_PER_SM * n_sm <= ctas
    assert ctas <= 2 * cuda_ransac.CTAS_PER_SM * n_sm or chunks == 1


def test_fundamental_on_the_cpu_keeps_the_plain_scoring():
    """Points on the CPU are scored by the plain version: K8 does not
    launch, and its wrapper refuses CPU tensors."""
    models, p1, p2 = _hypotheses(0, 16)
    before = cuda_ransac.LAUNCHES
    ransac.ransac_fundamental(p1, p2, threshold=3.0, num_hypotheses=64,
                              device="cpu")
    assert cuda_ransac.LAUNCHES == before
    with pytest.raises(ValueError, match="float32 CUDA tensor"):
        cuda_ransac.sampson_counts(models, p1, p2, 3.0)
