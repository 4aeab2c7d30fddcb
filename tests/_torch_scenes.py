"""Synthetic geometry scenes for the PyTorch port, built without JAX.

tests/test_sfm.py's make_scene and tests/test_geom.py's BA problems
rebuilt on the port's so3_exp (those files import the JAX package), so
that the card-only tests and chip_smoke.py share one copy.  numpy draws
the same numbers as the JAX tests' builders for the same seeds.
"""

import numpy as np
import torch

from hesaff_tpu_torch.geom import ba
from hesaff_tpu_torch.geom.se3 import so3_exp


def _rotation(rv) -> np.ndarray:
    return so3_exp(torch.as_tensor(np.asarray(rv), dtype=torch.float32)
                   ).numpy()


def sfm_scene(F=8, P=220, noise=0.4, seed=0):
    """tests/test_sfm.py's make_scene: F cameras orbiting a point cloud.
    Returns tracks, K and the true rotation vectors and translations."""
    rng = np.random.RandomState(seed)
    K = np.array([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]])
    X = rng.rand(P, 3) * [6, 4, 3] + [-3, -2, 7]
    rv_gt, tv_gt, obs = [], [], [[] for _ in range(P)]
    for f in range(F):
        rv = np.array([0.0, 0.12 * f, 0.0]) + rng.randn(3) * 0.005
        C = np.array([1.1 * f - 3.5, 0.15 * f, 0.3 * np.sin(f)])
        R = _rotation(rv)
        tv = -R @ C
        rv_gt.append(rv)
        tv_gt.append(tv)
        Xc = X @ R.T + tv
        uv = np.stack([K[0, 0] * Xc[:, 0] / Xc[:, 2] + K[0, 2],
                       K[1, 1] * Xc[:, 1] / Xc[:, 2] + K[1, 2]], 1) \
            + rng.randn(P, 2) * noise
        vis = ((Xc[:, 2] > 1.0) & (uv[:, 0] > 0) & (uv[:, 0] < 640)
               & (uv[:, 1] > 0) & (uv[:, 1] < 480))
        for p in range(P):
            if vis[p]:
                obs[p].append((f, uv[p]))
    tracks = [tr for tr in obs if len(tr) >= 2]
    return tracks, K, np.array(rv_gt), np.array(tv_gt)


def _on(dev):
    return lambda a, dt=torch.float32: torch.as_tensor(
        np.asarray(a), dtype=dt, device=dev)


def ba_problem(dev, seed=3, init_seed=7, noise=0.3) -> ba.BAProblem:
    """tests/test_geom.py's make_ba_problem (6 cameras, 150 points)
    with its poses and points perturbed from `init_seed`, on `dev`."""
    rng = np.random.RandomState(seed)
    C, P, f, cx, cy = 6, 150, 500.0, 320.0, 240.0
    X = rng.rand(P, 3) * [6, 4, 3] + [-3, -2, 6]
    rvecs, tvecs, obs = [], [], []
    for c in range(C):
        rv = np.array([0.02, 0.3, 0.01]) * c + rng.randn(3) * 0.01
        tv = np.array([-1.2 * c + 2.5, 0.05 * c, 0.2 * c]) * 0.4
        rvecs.append(rv)
        tvecs.append(tv)
        Xc = X @ _rotation(rv).T + tv
        uv = np.stack([f * Xc[:, 0] / Xc[:, 2] + cx,
                       f * Xc[:, 1] / Xc[:, 2] + cy], 1)
        for pi in range(P):
            if Xc[pi, 2] > 0.5:
                obs.append((c, pi, uv[pi] + rng.randn(2) * noise))
    rng = np.random.RandomState(init_seed)
    t = _on(dev)
    rv, tv = np.asarray(rvecs), np.asarray(tvecs)
    return ba.BAProblem(
        cam_rvec=t(rv + rng.randn(*rv.shape) * 0.02),
        cam_tvec=t(tv + rng.randn(*tv.shape) * 0.05),
        points=t(X + rng.randn(*X.shape) * 0.05), f=f, cx=cx, cy=cy,
        cam_idx=t([o[0] for o in obs], torch.int32),
        pt_idx=t([o[1] for o in obs], torch.int32),
        uv=t([o[2] for o in obs]),
        w=torch.ones(len(obs), dtype=torch.float32, device=dev))


def ba_line_scene(P: int, dev, C: int = 50, seed: int = 11) -> ba.BAProblem:
    """tests/test_geom.py's test_ba_sharded_scales_past_dense_memory
    scene with P points: C cameras along a line, each point seen by 4
    neighbouring cameras (0.3 px noise), perturbed poses and points.
    Returns the BAProblem on `dev`."""
    rng = np.random.RandomState(seed)
    f, cx, cy = 500.0, 320.0, 240.0
    owner = rng.randint(0, C - 3, P)
    X = np.stack([owner * 0.8 + rng.rand(P) * 4 - 2, rng.rand(P) * 4 - 2,
                  rng.rand(P) * 3 + 6], 1).astype(np.float32)
    rv_gt = np.stack([[0.0, 0.004 * c, 0.0] for c in range(C)]
                     ).astype(np.float32)
    tv_gt = np.stack([[-0.8 * c, 0.0, 0.0] for c in range(C)]
                     ).astype(np.float32)
    obs_c, obs_p, obs_uv = [], [], []
    for dc in range(4):
        c = owner + dc
        R = so3_exp(torch.as_tensor(rv_gt[c])).numpy()
        Xc = np.einsum("pij,pj->pi", R, X) + tv_gt[c]
        uv = np.stack([f * Xc[:, 0] / Xc[:, 2] + cx,
                       f * Xc[:, 1] / Xc[:, 2] + cy], 1)
        good = Xc[:, 2] > 0.5
        obs_c.append(c[good])
        obs_p.append(np.flatnonzero(good))
        obs_uv.append(uv[good] + rng.randn(good.sum(), 2) * 0.3)
    t = _on(dev)
    ci = np.concatenate(obs_c)
    return ba.BAProblem(
        cam_rvec=t(rv_gt + rng.randn(C, 3).astype(np.float32) * 0.005),
        cam_tvec=t(tv_gt + rng.randn(C, 3).astype(np.float32) * 0.02),
        points=t(X + rng.randn(P, 3).astype(np.float32) * 0.02),
        f=f, cx=cx, cy=cy, cam_idx=t(ci, torch.int32),
        pt_idx=t(np.concatenate(obs_p), torch.int32),
        uv=t(np.concatenate(obs_uv)),
        w=torch.ones(len(ci), dtype=torch.float32, device=dev))
