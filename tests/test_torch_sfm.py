"""SfM of the PyTorch port, on the CPU: build_tracks equal to the JAX
package's; triangulate_nview, triangulate_two_view and pnp_dlt equal to
JAX's at rtol / atol 1e-4; pnp_ransac and incremental_sfm on
tests/test_sfm.py's scenes at its thresholds (rotation within 5e-3,
translation within 2e-2, > 95% of the true inliers; every frame
registered, ATE < 0.15, normalized rmse < 2e-3); and `cli sfm` with
extraction stubbed as tests/test_sfm.py stubs it (ATE < 0.2).  The
port's minimal sets come from a torch.Generator, so RANSAC is held on
outcomes."""

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (two torch threads a worker)
from hesaff_tpu import sfm as jsfm
from hesaff_tpu_torch import sfm
from hesaff_tpu_torch.geom.se3 import so3_exp
from hesaff_tpu_torch.pipeline import Features
from tests.test_sfm import make_scene
from _torch_scenes import sfm_scene


def _rot(rv):
    return so3_exp(torch.as_tensor(rv, dtype=torch.float32)).numpy()


def test_build_tracks_matches_jax():
    rng = np.random.default_rng(0)
    kps = [rng.random((30, 2)) * 100 for _ in range(4)]
    matches = {}
    for i, j in ((0, 1), (1, 2), (0, 2), (2, 3), (1, 3)):
        a = rng.permutation(30)[:18]
        b = rng.permutation(30)[:18]
        matches[(i, j)] = (a, b)
    want = jsfm.build_tracks(kps, matches)
    got = sfm.build_tracks(kps, matches)
    assert len(got) == len(want) > 3
    for tg, tw in zip(got, want):
        assert [f for f, _ in tg] == [f for f, _ in tw]
        for (_, a), (_, b) in zip(tg, tw):
            np.testing.assert_array_equal(a, b)
    small = [np.array([[0.0, 0], [1, 1], [2, 2]]),
             np.array([[10.0, 0], [11, 1]]), np.array([[20.0, 0], [21, 1]])]
    m = {(0, 1): (np.array([0, 1]), np.array([0, 1])),
         (1, 2): (np.array([0]), np.array([0]))}
    assert sorted(len(tr) for tr in sfm.build_tracks(small, m)) == [2, 3]


def test_triangulation_and_dlt_match_jax():
    rng = np.random.RandomState(2)
    X = np.array([0.5, -0.2, 6.0])
    rvs, tvs, uvns = [], [], []
    for f in range(4):
        rv = np.array([0.0, 0.1 * f, 0.0])
        tv = np.array([-0.8 * f, 0.0, 0.0])
        Xc = _rot(rv) @ X + tv
        rvs.append(rv)
        tvs.append(tv)
        uvns.append(Xc[:2] / Xc[2])
    args = (np.array(rvs), np.array(tvs), np.array(uvns))
    Xe = sfm.triangulate_nview(*args, device="cpu").numpy()
    np.testing.assert_allclose(Xe, X, atol=1e-3)
    np.testing.assert_allclose(Xe, np.asarray(jsfm.triangulate_nview(*args)),
                               rtol=1e-4, atol=1e-4)

    P = rng.rand(40, 3) * 4 + [-2, -2, 5]
    rv_gt = np.array([0.1, -0.2, 0.05])
    tv_gt = np.array([0.3, -0.1, 0.4])
    Xc = P @ _rot(rv_gt).T + tv_gt
    uvn = Xc[:, :2] / Xc[:, 2:3] + rng.randn(40, 2) * 5e-4
    w = (rng.rand(40) > 0.2).astype(np.float32)
    for ww in (None, w):
        rv, tv = sfm.pnp_dlt(P, uvn, None if ww is None else torch.as_tensor(
            ww), device="cpu")
        jrv, jtv = jsfm.pnp_dlt(P, uvn, ww)
        np.testing.assert_allclose(rv.numpy(), np.asarray(jrv), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jtv), rtol=1e-4,
                                   atol=1e-4)

    # two-view: the seed's triangulation in cam1's frame
    import jax.numpy as jnp

    R = _rot(np.array([0.0, 0.15, 0.02]))
    t = np.array([-0.9, 0.05, 0.1], np.float32)
    Xs = rng.rand(25, 3) * [4, 3, 2] + [-2, -1.5, 6]
    X2 = Xs @ R.T + t
    p1, p2 = Xs[:, :2] / Xs[:, 2:], X2[:, :2] / X2[:, 2:]
    got = sfm.triangulate_two_view(*(torch.as_tensor(a, dtype=torch.float32)
                                     for a in (R, t, p1, p2))).numpy()
    want = np.asarray(jsfm.triangulate_two_view(
        jnp.asarray(R, jnp.float32), jnp.asarray(t), p1.astype(np.float32),
        p2.astype(np.float32)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, Xs, atol=1e-3)


def test_pnp_ransac():
    rng = np.random.RandomState(1)
    X = rng.rand(80, 3) * 4 + [-2, -2, 5]
    rv_gt = np.array([0.1, -0.2, 0.05])
    tv_gt = np.array([0.3, -0.1, 0.4])
    Xc = X @ _rot(rv_gt).T + tv_gt
    uvn = Xc[:, :2] / Xc[:, 2:3] + rng.randn(80, 2) * 5e-4
    uvn[:15] = rng.rand(15, 2) - 0.5  # outliers
    rv, tv, inl = sfm.pnp_ransac(X, uvn, threshold_n=4e-3, device="cpu")
    assert inl.numpy()[15:].mean() > 0.95
    np.testing.assert_allclose(rv.numpy(), rv_gt, atol=5e-3)
    np.testing.assert_allclose(tv.numpy(), tv_gt, atol=2e-2)


def test_incremental_sfm_ate():
    tracks, K, rv_gt, tv_gt, X = make_scene()
    rec = sfm.incremental_sfm(tracks, K, ba_every=3, device="cpu")
    assert len(rec.cam_rvec) == len(rv_gt)   # every frame registered
    np.testing.assert_array_equal(rec.frame_ids, np.arange(len(rv_gt)))
    ate = sfm.absolute_trajectory_error(rec.cam_rvec, rec.cam_tvec,
                                        rv_gt, tv_gt)
    assert ate < 0.15, ate
    assert rec.rmse < 2e-3  # normalized-coordinate reprojection rmse
    assert len(rec.points) > 100


def test_shared_scene_matches_make_scene():
    """tests/_torch_scenes.sfm_scene (the JAX-free copy the card-only
    tests and chip_smoke.py use) builds test_sfm.make_scene's scene."""
    tracks, K, rv_gt, tv_gt, _ = make_scene()
    got, K2, rv2, tv2 = sfm_scene()
    np.testing.assert_array_equal(K2, K)
    np.testing.assert_array_equal(rv2, rv_gt)
    np.testing.assert_allclose(tv2, tv_gt, rtol=1e-6, atol=1e-6)
    assert [[f for f, _ in tr] for tr in got] == \
        [[f for f, _ in tr] for tr in tracks]
    np.testing.assert_allclose(
        np.concatenate([np.stack([uv for _, uv in tr]) for tr in got]),
        np.concatenate([np.stack([uv for _, uv in tr]) for tr in tracks]),
        rtol=1e-6, atol=1e-4)


def test_ate_matches_jax():
    rng = np.random.RandomState(4)
    rv, tv = rng.randn(6, 3) * 0.2, rng.randn(6, 3)
    rv2, tv2 = rv + rng.randn(6, 3) * 0.01, tv * 1.7 + 0.3
    assert sfm.absolute_trajectory_error(rv2, tv2, rv, tv) == pytest.approx(
        jsfm.absolute_trajectory_error(rv2, tv2, rv, tv), rel=1e-5, abs=1e-7)


def test_cli_sfm_smoke(monkeypatch, tmp_path):
    """`cli sfm` wiring: frames -> sequential matching -> tracks ->
    incremental SfM -> npz + report, with the grouped extraction step
    and image loading stubbed by a rendered synthetic scene."""
    rng = np.random.RandomState(3)
    F, P = 4, 150
    K = np.array([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]])
    X = rng.rand(P, 3) * [6, 4, 3] + [-3, -2, 7]
    base_desc = rng.randint(0, 255, (P, 128)).astype(np.uint8)
    rv_gt, tv_gt, feats = [], [], []
    for f in range(F):
        rv = np.array([0.0, 0.15 * f, 0.0])
        C = np.array([1.0 * f - 1.5, 0.1 * f, 0.2 * np.sin(f)])
        R = _rot(rv)
        tv = -R @ C
        rv_gt.append(rv)
        tv_gt.append(tv)
        Xc = X @ R.T + tv
        uv = np.stack([
            K[0, 0] * Xc[:, 0] / Xc[:, 2] + K[0, 2],
            K[1, 1] * Xc[:, 1] / Xc[:, 2] + K[1, 2],
        ], 1) + rng.randn(P, 2) * 0.3
        vis = ((Xc[:, 2] > 1.0) & (uv[:, 0] > 0) & (uv[:, 0] < 640)
               & (uv[:, 1] > 0) & (uv[:, 1] < 480))
        idx = np.nonzero(vis)[0]
        k = len(idx)
        feats.append(Features(
            x=uv[idx, 0].astype(np.float32), y=uv[idx, 1].astype(np.float32),
            s=np.full(k, 2.0, np.float32), a11=np.ones(k, np.float32),
            a12=np.zeros(k, np.float32), a21=np.zeros(k, np.float32),
            a22=np.ones(k, np.float32), response=np.ones(k, np.float32),
            type=np.zeros(k, np.int32), desc=base_desc[idx]))

    import hesaff_tpu_torch.dist as dist
    import hesaff_tpu_torch.sift_io as sift_io

    def dense(f):
        """f as the grouped step's DenseFeatures of one image."""
        k = f.n
        return dist.DenseFeatures(
            valid=torch.ones(k, dtype=torch.bool),
            img_idx=torch.zeros(k, dtype=torch.int32),
            **{name: torch.as_tensor(getattr(f, name)) for name in (
                "x", "y", "s", "a11", "a12", "a21", "a22", "response",
                "type", "desc")},
            overflow=torch.zeros((), dtype=torch.int64))

    it = iter(feats)
    monkeypatch.setattr(sift_io, "load_image_gray",
                        lambda p: np.zeros((480, 640), np.float32))
    monkeypatch.setattr(dist, "extraction_step_grouped",
                        lambda images, cfg, groups, **kw: dense(next(it)))

    from hesaff_tpu_torch.cli import main

    out = tmp_path / "recon.npz"
    rc = main(["sfm"] + [f"frame{i}.png" for i in range(F)]
              + ["-o", str(out), "--focal", "600", "--device", "cpu"])
    assert rc == 0
    d = np.load(out)
    assert d["cam_rvec"].shape == (F, 3)
    assert len(d["points"]) > 50
    ate = sfm.absolute_trajectory_error(d["cam_rvec"], d["cam_tvec"],
                                        np.array(rv_gt), np.array(tv_gt))
    assert ate < 0.2, ate
