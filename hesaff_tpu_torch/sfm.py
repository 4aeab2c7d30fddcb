"""Small-scene incremental structure-from-motion.

Port of ``hesaff_tpu/sfm.py``.  Pipeline: two-view seed (RANSAC F -> E
-> R, t and triangulation), incremental PnP registration, periodic and
final Schur bundle adjustment.  Tracks are built on the host by
union-find over pairwise descriptor matches (small data); RANSAC,
triangulation, PnP hypothesis scoring and BA run batched on the run's
device (the GPU unless device="cpu"), in float32 with TF32 off.

The front end for a stream of frames is ``SequentialMatcher`` (COLMAP's
sequential matcher): each pushed frame is extracted on the grouped
serving path, matched against the frames of a window before it on the
device and every pair verified by F-RANSAC; ``cli sfm`` runs its frames
through it.

``pnp_ransac`` draws its minimal sets from a ``torch.Generator`` on the
run's device (``ransac.draw_minimal_sets``), which cannot reproduce
``jax.random.choice``: the port is held to the JAX package on outcomes.
"""

from __future__ import annotations

from collections import defaultdict, deque
from typing import NamedTuple

import numpy as np
import torch

from hesaff_tpu_torch.config import HesaffConfig
from hesaff_tpu_torch.geom.ba import BAProblem, ba_solve
from hesaff_tpu_torch.geom.se3 import so3_exp, so3_log
from hesaff_tpu_torch.match import full_f32, knn2, ratio_mutual
from hesaff_tpu_torch.pipeline import Features, resolve_device
from hesaff_tpu_torch.ransac import (_f32, _homog, decompose_essential,
                                     draw_minimal_sets,
                                     essential_from_fundamental,
                                     ransac_fundamental)
from hesaff_tpu_torch.utils.profiling import counted, span

_GEOMETRY = ("x", "y", "s", "a11", "a12", "a21", "a22", "response")


class Reconstruction(NamedTuple):
    cam_rvec: np.ndarray   # (C, 3) world->cam
    cam_tvec: np.ndarray   # (C, 3)
    points: np.ndarray     # (P, 3)
    track_ids: np.ndarray  # (P,) original track indices
    rmse: float
    frame_ids: np.ndarray = np.zeros(0, np.int32)  # (C,) registered frames


class UnionFind:
    def __init__(self):
        self.parent = {}

    def find(self, a):
        p = self.parent.setdefault(a, a)
        while p != self.parent[p]:
            self.parent[p] = self.parent[self.parent[p]]
            p = self.parent[p]
        self.parent[a] = p
        return p

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def build_tracks(keypoints_per_frame, matches_per_pair):
    """Union-find track building.

    keypoints_per_frame: list of (N_f, 2) keypoint coordinate arrays.
    matches_per_pair: dict {(f1, f2): (idx1, idx2)}.
    Returns a list of tracks, each a list of (frame, uv) with at most one
    observation per frame (tracks that merge two keypoints of one frame
    are dropped, the standard consistency filter).
    """
    uf = UnionFind()
    for (f1, f2), (i1, i2) in matches_per_pair.items():
        for a, b in zip(np.asarray(i1), np.asarray(i2)):
            uf.union((f1, int(a)), (f2, int(b)))
    groups = defaultdict(list)
    for f, kps in enumerate(keypoints_per_frame):
        for k in range(len(kps)):
            node = (f, k)
            if node in uf.parent:
                groups[uf.find(node)].append(node)
    tracks = []
    for nodes in groups.values():
        if len(nodes) < 2:
            continue
        frames = [n[0] for n in nodes]
        if len(set(frames)) != len(frames):
            continue
        tracks.append(
            sorted((f, np.asarray(keypoints_per_frame[f][k], np.float64))
                   for f, k in nodes))
    return tracks


class PairMatches(NamedTuple):
    """One verified pair of a SequentialMatcher: an earlier frame of
    the window and the frame just pushed."""

    older: int              # frame id of the earlier frame
    newer: int              # frame id of the pushed frame
    idx_older: np.ndarray   # (T,) int32 tentative matches: rows of
    idx_newer: np.ndarray   # (T,) int32   each frame's features
    inliers: np.ndarray     # (T,) bool, F-RANSAC's verdict
    model: np.ndarray       # (3, 3) float32 F, x_newer^T F x_older = 0
    #                         (NaN where the pair has under 8 matches)
    seed: int               # the pair's RANSAC seed (pair_seed)


class FrameMatches(NamedTuple):
    """What SequentialMatcher.push gives back for one frame."""

    frame: int              # its frame id (the pushes before it)
    features: Features      # its described keypoints, on the host
    overflow: int           # keypoints its extraction dropped
    pairs: tuple            # PairMatches against each earlier frame of
    #                         the window, the oldest first


def pair_seed(seed: int, older: int, newer: int) -> int:
    """The RANSAC seed of the pair (older, newer) of a run seeded with
    `seed`: 32 bits of numpy's SeedSequence of the three."""
    return int(np.random.SeedSequence(
        [seed % 2**64, older, newer]).generate_state(1)[0])


def frame_groups(height: int, width: int, cfg: HesaffConfig):
    """The group table a lone frame of this size is extracted with:
    default_group_spec at one slot every 128 px and at least 4,096
    (190,512 at 6048 x 4032, where the ETH3D benchmark configurations
    measured 163,840 and 188,416).  Keypoints in the groups to 641, the
    most of 3 frames of the benchmark's synthetic imagery against the
    slots: 800 x 640 1,125 / 509 / 134 / 24 / 1 of 5,184 / 2,464 / 640 /
    192 / 32; 1024 x 768 1,740 / 828 / 195 / 35 / 4 of 7,744 / 3,712 /
    928 / 288 / 64; the 200 x 160 golden frame 45 / 9 / 1 of 5,184 /
    2,464 / 640; none overflowed.  What a frame drops is its
    FrameMatches.overflow."""
    from hesaff_tpu_torch.dist import default_group_spec

    return default_group_spec(height, width, cfg,
                              max(4096, -(-height * width // 128)), 1)


class _Entry(NamedTuple):
    frame: int
    desc: torch.Tensor      # (N, D) uint8 on the device, contiguous
    xy: torch.Tensor        # (N, 2) float32 on the device


class SequentialMatcher:
    """Sequential matching of a stream of frames (COLMAP's
    sequential_matcher): each pushed frame is extracted, matched
    against the frames of a window before it and each pair verified by
    F-RANSAC.

    push(frame) extracts one (H, W) host frame (or tensor) through
    dist.extraction_step_grouped as a batch of one, with `groups` (or,
    where None, frame_groups of the frame's size), and keeps its
    descriptors and positions on the device in a ring of the last
    `window` frames.  Against each frame of the ring, oldest first, it
    takes the 2-NN both ways (match.knn2: the K7 kernel for uint8 rows
    on the card), keeps a match where dist < ratio^2 * dist2 in float32
    and the newer frame's nearest row maps back to it (match.ratio_mutual,
    match_descriptors' tests, on the device: ties keep the first row),
    and verifies the pair's tentative matches with
    ransac_fundamental at the Sampson threshold sampson_px^2, seeded
    with pair_seed(seed, older, newer).  Returns a FrameMatches of host
    arrays.

    Spans: "frame: features" (the frame's valid rows, compacted on the
    device and copied to the host), "pair: knn2" (every 2-NN of the
    window), "pair: ratio" (the two tests and one copy of every pair's
    index pairs to the host), ransac's own, "pair: results" (the
    verdicts and models to the host).  While tracing, the counters
    pair_queries (query rows x database rows over the 2-NN calls) and
    pair_tentative (tentative matches) grow.
    """

    def __init__(self, cfg: HesaffConfig, groups=None, window: int = 10,
                 ratio: float = 0.8, hypotheses: int = 10000,
                 sampson_px: float = 4.0, seed: int = 0, device=None):
        if window < 1:
            raise ValueError(f"window {window}: at least 1")
        self.cfg, self.groups, self.window = cfg, groups, window
        self.ratio, self.hypotheses = ratio, hypotheses
        self.threshold = sampson_px * sampson_px
        self.seed, self.device = seed, device
        self.ring: deque = deque(maxlen=window)
        self.pushed = 0

    def push(self, frame) -> FrameMatches:
        from hesaff_tpu_torch import dist

        dev = resolve_device(frame, self.device)
        h, w = np.shape(frame)[-2:]
        groups = self.groups or frame_groups(h, w, self.cfg)
        out = dist.extraction_step_grouped(frame[None], self.cfg, groups,
                                           device=dev)
        with span("frame: features"):
            rows = out.valid.nonzero()[:, 0]
            geo = torch.stack([getattr(out, k) for k in _GEOMETRY])[:, rows]
            new = _Entry(self.pushed, out.desc[rows].contiguous(),
                         geo[:2].t().contiguous())
            host = geo.cpu().numpy()
            feats = Features(
                *host, type=out.type[rows].cpu().numpy(),
                desc=new.desc.cpu().numpy())
            overflow = int(out.overflow)
        pairs = self._pairs(new)
        self.ring.append(new)
        self.pushed += 1
        return FrameMatches(new.frame, feats, overflow, pairs)

    def _pairs(self, new: _Entry) -> tuple:
        ring = list(self.ring)
        if not ring:
            return ()
        dev = new.desc.device
        with span("pair: knn2"):
            nn = [(knn2(e.desc, new.desc), knn2(new.desc, e.desc).idx)
                  if len(e.desc) and len(new.desc) else None for e in ring]
            queries = counted("pair_queries", dev)
            if queries is not None:
                queries += 2 * len(new.desc) * sum(len(e.desc) for e in ring)
        with span("pair: ratio"):
            keep, near = [], []
            for e, m in zip(ring, nn):
                if m is None:
                    keep.append(torch.zeros(len(e.desc), dtype=torch.bool,
                                            device=dev))
                    near.append(torch.zeros(len(e.desc), dtype=torch.long,
                                            device=dev))
                    continue
                keep.append(ratio_mutual(m[0], m[1], self.ratio))
                near.append(m[0].idx.long())
            flat = torch.cat(keep).nonzero()[:, 0]
            nearest = torch.cat(near)[flat]
            host = torch.stack([flat, nearest]).cpu().numpy()
            tentative = counted("pair_tentative", dev)
            if tentative is not None:
                tentative += host.shape[1]
        starts = np.cumsum([0] + [len(e.desc) for e in ring])
        cut = np.searchsorted(host[0], starts)
        seeds = [pair_seed(self.seed, e.frame, new.frame) for e in ring]
        verdicts = []
        for k, e in enumerate(ring):
            lo, hi = int(cut[k]), int(cut[k + 1])
            if hi - lo >= 8:
                res = ransac_fundamental(
                    e.xy[flat[lo:hi] - int(starts[k])], new.xy[nearest[lo:hi]],
                    threshold=self.threshold,
                    num_hypotheses=self.hypotheses, seed=seeds[k],
                    device=dev)
                verdicts.append((res.inliers, res.model))
            else:
                verdicts.append((torch.zeros(hi - lo, dtype=torch.bool,
                                             device=dev),
                                 torch.full((3, 3), float("nan"),
                                            device=dev)))
        with span("pair: results"):
            inliers = torch.cat([v[0] for v in verdicts]).cpu().numpy()
            models = torch.stack([v[1] for v in verdicts]).cpu().numpy()
        return tuple(
            PairMatches(e.frame, new.frame,
                        (host[0, cut[k]:cut[k + 1]] - starts[k]
                         ).astype(np.int32),
                        host[1, cut[k]:cut[k + 1]].astype(np.int32),
                        inliers[cut[k]:cut[k + 1]], models[k], seeds[k])
            for k, e in enumerate(ring))


def triangulate_two_view(R, t, p1n, p2n):
    """Linear triangulation in cam1's frame from normalized points: for
    each point z1 a = R^T (z2 b - t), solved as the 3x2 least-squares
    system [R a, -b] (z1, z2) = -t.  R, t, p1n, p2n: tensors on one
    device; returns (N, 3)."""
    with full_f32():
        a, b = _homog(p1n), _homog(p2n)
        A = torch.stack([a @ R.T, -b], -1)                     # (N, 3, 2)
        rhs = (-t).expand(A.shape[:-1])[..., None]
        sol = torch.linalg.lstsq(A, rhs, driver="gels").solution[..., 0]
        return sol[:, :1] * a


def triangulate_nview(rvecs, tvecs, uvns, device=None):
    """DLT triangulation of one point from n >= 2 views.

    rvecs / tvecs: (n, 3) world->cam; uvns: (n, 2) normalized coords.
    Least-squares solution of the stacked cross-product constraints (the
    right singular vector of the smallest singular value).
    """
    dev = resolve_device(rvecs, device)
    rvecs, tvecs, uvns = (_f32(a, dev) for a in (rvecs, tvecs, uvns))
    with full_f32():
        R = so3_exp(rvecs)                                     # (n, 3, 3)
        P = torch.cat([R, tvecs[:, :, None]], dim=2)           # (n, 3, 4)
        x, y = uvns[:, 0], uvns[:, 1]
        r1 = x[:, None] * P[:, 2] - P[:, 0]
        r2 = y[:, None] * P[:, 2] - P[:, 1]
        A = torch.cat([r1, r2], dim=0)                         # (2n, 4)
        Xh = torch.linalg.svd(A, full_matrices=True)[2][-1]
        return Xh[:3] / Xh[3]


def pnp_dlt(X, uvn, w=None, device=None):
    """DLT pose from >= 6 normalized 2D - 3D correspondences.

    X: (..., n, 3), uvn: (..., n, 2); leading dimensions are a batch of
    independent problems.  Optional weights w (..., n) (0 masks a
    correspondence) give fixed-shape inlier refits.  Returns (rvec,
    tvec), each (..., 3), with R projected onto SO(3), the scale fixed
    by det(R) = 1 and the sign chosen to put the point mean in front.
    """
    dev = resolve_device(X, device)
    X, uvn = _f32(X, dev), _f32(uvn, dev)
    with full_f32():
        Xh = _homog(X)                                         # (..., n, 4)
        z = torch.zeros_like(Xh)
        x, y = uvn[..., 0:1], uvn[..., 1:2]
        r1 = torch.cat([Xh, z, -x * Xh], dim=-1)
        r2 = torch.cat([z, Xh, -y * Xh], dim=-1)
        A = torch.cat([r1, r2], dim=-2)                        # (..., 2n, 12)
        if w is not None:
            w = _f32(w, dev)
            A = A * torch.cat([w, w], dim=-1)[..., None]
        vt = torch.linalg.svd(A, full_matrices=True)[2]
        P = vt[..., -1, :].reshape(vt.shape[:-2] + (3, 4))
        # scale and handedness
        det = torch.linalg.det(P[..., :3])
        P = P * torch.sign(det)[..., None, None]
        scale = (torch.abs(det) ** (1.0 / 3.0))[..., None]
        M = P[..., :3] / scale[..., None]
        t = P[..., 3] / scale
        u, _, vtr = torch.linalg.svd(M)
        R = u @ vtr
        R = R * torch.sign(torch.linalg.det(R))[..., None, None]
        # cheirality: flip if the point mean lands behind the camera
        zmean = torch.mean((X @ R.transpose(-1, -2))[..., 2]
                           + t[..., 2:3], dim=-1)
        flip = (zmean < 0)[..., None]
        R = torch.where(flip[..., None], -R, R)
        t = torch.where(flip, -t, t)
        return so3_log(R), t


def _reproj_err(rvec, tvec, X, uvn):
    """Squared normalized reprojection error of X (N, 3) under each pose
    (..., 3); inf behind the camera.  Returns (..., N)."""
    R = so3_exp(rvec)
    Xc = X @ R.transpose(-1, -2) + tvec[..., None, :]
    zc = Xc[..., 2]
    z = torch.where(torch.abs(zc) < 1e-9, torch.full_like(zc, 1e-9), zc)
    pr = Xc[..., :2] / z[..., None]
    err = torch.sum((pr - uvn) ** 2, dim=-1)
    return torch.where(zc > 0, err, torch.full_like(err, float("inf")))


def pnp_ransac(X, uvn, threshold_n: float = 5e-3,
               num_hypotheses: int = 256, seed: int = 0, device=None):
    """Parallel-hypothesis PnP: 6-point DLT models from minimal sets
    drawn on the run's device, scored on all points at once; the best
    (first on ties) is refit on its inliers.  Returns (rvec, tvec,
    inliers) tensors on the run's device."""
    dev = resolve_device(X, device)
    X, uvn = _f32(X, dev), _f32(uvn, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    sel = draw_minimal_sets(X.shape[0], num_hypotheses, 6, g)
    thr = threshold_n ** 2
    with full_f32():
        rvs, tvs = pnp_dlt(X[sel], uvn[sel])
        counts = (_reproj_err(rvs, tvs, X, uvn) < thr).sum(-1)
        best = torch.argmax(counts)
        inl = _reproj_err(rvs[best], tvs[best], X, uvn) < thr
        # weighted refit on the inliers (fixed shape)
        rv, tv = pnp_dlt(X, uvn, inl.to(torch.float32))
        inl = _reproj_err(rv, tv, X, uvn) < thr
    return rv, tv, inl


def incremental_sfm(tracks, K, ba_every: int = 5,
                    min_track_views: int = 2, verbose: bool = False,
                    device=None):
    """Incremental SfM over tracks: [(frame, uv), ...] lists.

    Frames must be 0..F-1 with frames 0 and 1 sharing enough tracks to
    seed.  Runs on `device` (the GPU unless "cpu" is asked for).
    Returns a Reconstruction (poses world->cam, points) of host arrays.
    """
    dev = resolve_device(None, device)
    K = np.asarray(K, np.float64)
    Kinv = np.linalg.inv(K)
    F = 1 + max(f for tr in tracks for f, _ in tr)
    host = lambda t: t.detach().cpu().numpy().astype(np.float64)

    def norm_pt(uv):
        v = Kinv @ np.array([uv[0], uv[1], 1.0])
        return v[:2] / v[2]

    obs = defaultdict(dict)  # track -> frame -> uvn
    for ti, tr in enumerate(tracks):
        for f, uv in tr:
            obs[ti][f] = norm_pt(uv)

    # ---- seed from frames 0, 1
    seed_tracks = [ti for ti in obs if 0 in obs[ti] and 1 in obs[ti]]
    p1 = np.array([obs[ti][0] for ti in seed_tracks])
    p2 = np.array([obs[ti][1] for ti in seed_tracks])
    # RANSAC on normalized coordinates: E is F of normalized points
    res = ransac_fundamental(p1, p2, threshold=2e-5, num_hypotheses=1024,
                             device=dev)
    E = essential_from_fundamental(res.model, np.eye(3), np.eye(3),
                                   device=dev)
    inl = res.inliers.cpu().numpy()
    R, t = decompose_essential(E, p1[inl], p2[inl], device=dev)

    poses = {0: (np.zeros(3), np.zeros(3)), 1: (host(so3_log(R)), host(t))}

    X3d = {}
    pts = host(triangulate_two_view(R, t, _f32(p1[inl], dev),
                                    _f32(p2[inl], dev)))
    for ti, X in zip(np.asarray(seed_tracks)[inl], pts):
        if X[2] > 0.01:
            X3d[int(ti)] = X

    def run_ba(n_iters=10):
        cam_ids = sorted(poses)
        pt_ids = sorted(X3d)
        cmap = {c: i for i, c in enumerate(cam_ids)}
        pmap = {p: i for i, p in enumerate(pt_ids)}
        ci, pi, uv = [], [], []
        for ti in pt_ids:
            for f, uvn in obs[ti].items():
                if f in poses:
                    ci.append(cmap[f])
                    pi.append(pmap[ti])
                    uv.append(uvn)
        arr = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt,
                                            device=dev)
        prob = BAProblem(
            cam_rvec=arr([poses[c][0] for c in cam_ids], torch.float32),
            cam_tvec=arr([poses[c][1] for c in cam_ids], torch.float32),
            points=arr([X3d[p] for p in pt_ids], torch.float32),
            f=1.0, cx=0.0, cy=0.0,
            cam_idx=arr(ci, torch.int32), pt_idx=arr(pi, torch.int32),
            uv=arr(uv, torch.float32),
            w=torch.ones(len(ci), dtype=torch.float32, device=dev))
        sol, err = ba_solve(prob, iterations=n_iters)
        rv, tv, ps = host(sol.cam_rvec), host(sol.cam_tvec), host(sol.points)
        for c in cam_ids:
            poses[c] = (rv[cmap[c]], tv[cmap[c]])
        for p in pt_ids:
            X3d[p] = ps[pmap[p]]
        return err

    run_ba(8)

    # ---- register the remaining frames
    for f in range(2, F):
        seen = [ti for ti in obs if f in obs[ti] and ti in X3d]
        if len(seen) < 8:
            continue
        Xs = np.array([X3d[ti] for ti in seen])
        uvs = np.array([obs[ti][f] for ti in seen])
        rv, tv, _ = pnp_ransac(Xs, uvs, device=dev)
        poses[f] = (host(rv), host(tv))

        # triangulate new tracks now seen from >= 2 registered frames
        for ti in obs:
            if ti in X3d or f not in obs[ti]:
                continue
            regs = [g for g in obs[ti] if g in poses]
            if len(regs) >= min_track_views:
                rvs = np.array([poses[g][0] for g in regs])
                tvs = np.array([poses[g][1] for g in regs])
                uvns = np.array([obs[ti][g] for g in regs])
                X = host(triangulate_nview(rvs, tvs, uvns, device=dev))
                # accept only points in front of all views
                Rl = host(so3_exp(_f32(rvs, dev)))
                zs = np.einsum("nij,j->ni", Rl, X)[:, 2] + tvs[:, 2]
                if np.all(zs > 0.01):
                    X3d[ti] = X
        if (f % ba_every) == 0:
            run_ba(6)
        if verbose:
            print(f"frame {f}: {len(X3d)} points, {len(poses)} cams")

    err = run_ba(12)

    cam_ids = sorted(poses)
    pt_ids = sorted(X3d)
    return Reconstruction(
        cam_rvec=np.array([poses[c][0] for c in cam_ids]),
        cam_tvec=np.array([poses[c][1] for c in cam_ids]),
        points=np.array([X3d[p] for p in pt_ids]),
        track_ids=np.array(pt_ids),
        rmse=float(err),
        frame_ids=np.array(cam_ids, np.int32),
    )


def umeyama_align(src, dst, with_scale=True):
    """Similarity transform (s, R, t) minimizing |s R src + t - dst|."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = dc.T @ sc / len(src)
    u, d, vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        S[2, 2] = -1
    R = u @ S @ vt
    var = (sc**2).sum() / len(src)
    s = (d * np.diag(S)).sum() / var if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def absolute_trajectory_error(est_rvec, est_tvec, gt_rvec, gt_tvec):
    """ATE RMSE after similarity (Sim3) alignment of camera centers (on
    the host)."""
    def centers(rv, tv):
        R = so3_exp(torch.as_tensor(np.asarray(rv),
                                    dtype=torch.float32)).numpy()
        return -np.einsum("nji,nj->ni", R, tv)  # C = -R^T t

    c_est = centers(est_rvec, est_tvec)
    c_gt = centers(gt_rvec, gt_tvec)
    s, R, t = umeyama_align(c_est, c_gt)
    aligned = (s * (R @ c_est.T)).T + t
    return float(np.sqrt(((aligned - c_gt) ** 2).sum(1).mean()))
