"""Plain sequential-pair matching and F-RANSAC: the reference of the
sequential-matching cell.

What COLMAP's sequential matcher does with two frames' features,
written out plainly in PyTorch (float32, TF32 off unless the control's
precision asks for it; reference/precision.py):

- ``tentative``: the exact 2-NN both ways (reference/knn2.two_nn); a
  row of the earlier frame keeps its nearest row of the later one where
  dist < ratio^2 * dist2, taken in float32 on the host, and that row's
  own nearest row is it (cross-check).  Ties keep the first row.
- ``pair_seed``: the seed a pair's RANSAC draws from, 32 bits of
  numpy's SeedSequence of (run seed, earlier frame, later frame).
- ``f_ransac``: RANSAC for the fundamental matrix with every hypothesis
  drawn at once: each hypothesis' 8 points are the 8 smallest of N
  uniform keys drawn from a ``torch.Generator`` on the device seeded
  with the pair's seed (the draws of the program, which a judge has to
  replay); the normalized 8-point solve (Hartley's normalisation, the
  right singular vector of the smallest singular value, rank 2 by
  zeroing the third singular value); every hypothesis scored by its
  Sampson distance at every point, inliers under the threshold; the
  hypothesis with the most inliers (the first on ties); two refits
  over its inliers (the same 8-point system over every inlier, Hartley
  normalised over the inliers, solved as the eigenvector of the
  smallest eigenvalue of A^T A), each kept only where its model has at
  least as many inliers as the model it refits (LO-RANSAC's rule), and
  the inliers of the model kept.

Departures from the published method (COLMAP's two-view geometry
estimation): only F is estimated (COLMAP estimates E, F and H and
chooses between them), all 10,000 hypotheses are drawn at once (COLMAP
stops adaptively, at a confidence of 0.999), no ``max_distance`` or
``max_num_matches`` cap, and the local optimisation is two plain
least-squares refits, each kept where it loses no inlier (COLMAP's
LO-RANSAC iterates a weighted refit inside each improvement).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import knn2
from benchmark.reference.precision import stored

# database rows of a 2-NN block: the block's (N, BLOCK) float32
# distances and their temporaries stay under ~12 GB at 90 k rows
BLOCK = 1 << 13
# hypotheses scored at once (their (chunk, N) residual planes)
CHUNK = 1024


def pair_seed(seed: int, older: int, newer: int) -> int:
    return int(np.random.SeedSequence(
        [seed % 2**64, older, newer]).generate_state(1)[0])


def tentative(desc_older: torch.Tensor, desc_newer: torch.Tensor,
              ratio: float):
    """(rows of the earlier frame, rows of the later) of the ratio- and
    cross-checked matches, int64 numpy, the earlier rows ascending."""
    if len(desc_older) == 0 or len(desc_newer) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    idx, d1, d2 = (t.cpu().numpy()
                   for t in knn2.two_nn(desc_older, desc_newer, BLOCK))
    back = knn2.two_nn(desc_newer, desc_older, BLOCK)[0].cpu().numpy()
    keep = d1 < np.float32(ratio * ratio) * d2
    keep &= back[idx] == np.arange(len(idx))
    rows = np.nonzero(keep)[0]
    return rows, idx[rows]


def _normalising(pts: torch.Tensor, w: torch.Tensor | None = None):
    """Hartley's similarity T of each (..., n, 2) set (over the points
    of weight w where given): the centroid to the origin, the mean
    distance to it sqrt(2)."""
    if w is None:
        c = pts.mean(-2)
        d = (pts - c[..., None, :]).norm(dim=-1).mean(-1)
    else:
        ws = w.sum().clamp_min(1e-9)
        c = (pts * w[:, None]).sum(0) / ws
        d = ((pts - c).norm(dim=-1) * w).sum() / ws
    s = math.sqrt(2.0) / d.clamp_min(1e-12)
    T = torch.zeros(s.shape + (3, 3), dtype=pts.dtype, device=pts.device)
    T[..., 0, 0] = s
    T[..., 1, 1] = s
    T[..., 0, 2] = -c[..., 0] * s
    T[..., 1, 2] = -c[..., 1] * s
    T[..., 2, 2] = 1.0
    return T


def _apply(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """The similarity T applied to (..., n, 2) points."""
    scale = T[..., 0, 0][..., None, None]
    shift = torch.stack([T[..., 0, 2], T[..., 1, 2]], -1)[..., None, :]
    return pts * scale + shift


def _system(n1: torch.Tensor, n2: torch.Tensor) -> torch.Tensor:
    """Rows [u x, u y, u, v x, v y, v, x, y, 1] of x2^T F x1 = 0."""
    x, y = n1[..., 0], n1[..., 1]
    u, v = n2[..., 0], n2[..., 1]
    return torch.stack([u * x, u * y, u, v * x, v * y, v, x, y,
                        torch.ones_like(x)], -1)


def _rank2(F: torch.Tensor) -> torch.Tensor:
    u, s, vh = torch.linalg.svd(F)
    s = torch.stack([s[..., 0], s[..., 1], torch.zeros_like(s[..., 2])], -1)
    return u @ torch.diag_embed(s) @ vh


def eight_point(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) F of each (..., 8, 2) minimal set."""
    T1, T2 = _normalising(p1), _normalising(p2)
    A = _system(_apply(T1, p1), _apply(T2, p2))
    F = torch.linalg.svd(A, full_matrices=True)[2][..., -1, :]
    F = _rank2(F.reshape(F.shape[:-1] + (3, 3)))
    return T2.transpose(-1, -2) @ F @ T1


def refit(p1: torch.Tensor, p2: torch.Tensor, w: torch.Tensor):
    """F over the points of weight w (least squares, normalised)."""
    T1, T2 = _normalising(p1, w), _normalising(p2, w)
    A = _system(_apply(T1, p1), _apply(T2, p2)) * w[:, None]
    F = torch.linalg.eigh(A.t() @ A)[1][:, 0].reshape(3, 3)
    return T2.t() @ _rank2(F) @ T1


def sampson(F: torch.Tensor, p1: torch.Tensor,
            p2: torch.Tensor) -> torch.Tensor:
    """(..., N) Sampson distances (px^2) of each (..., 3, 3) F at every
    correspondence, in the reference's current precision."""
    F, p1, p2 = stored(F), stored(p1), stored(p2)
    x, y = p1[:, 0], p1[:, 1]
    u, v = p2[:, 0], p2[:, 1]
    f = lambda i, j: F[..., i, j, None]
    a = f(0, 0) * x + f(0, 1) * y + f(0, 2)      # F x1
    b = f(1, 0) * x + f(1, 1) * y + f(1, 2)
    c = f(2, 0) * x + f(2, 1) * y + f(2, 2)
    at = f(0, 0) * u + f(1, 0) * v + f(2, 0)     # F^T x2
    bt = f(0, 1) * u + f(1, 1) * v + f(2, 1)
    num = (u * a + v * b + c) ** 2
    return num / (a * a + b * b + at * at + bt * bt).clamp_min(1e-12)


def hypotheses_scored(p1: torch.Tensor, p2: torch.Tensor, threshold: float,
                      hypotheses: int, seed: int):
    """(models (H, 3, 3), inlier counts (H,)) of every hypothesis of one
    pair, drawn as the program draws them."""
    n, dev = p1.shape[0], p1.device
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    keys = torch.rand(hypotheses, n, generator=g, device=dev)
    sel = keys.topk(8, dim=1, largest=False).indices
    del keys
    models = eight_point(p1[sel], p2[sel])
    counts = torch.cat([(sampson(models[h:h + CHUNK], p1, p2) < threshold)
                        .sum(1) for h in range(0, hypotheses, CHUNK)])
    return models, counts


def f_ransac(p1: torch.Tensor, p2: torch.Tensor, threshold: float,
             hypotheses: int, seed: int):
    """(F (3, 3), inliers (N,) bool) of one pair, on p1's device."""
    models, counts = hypotheses_scored(p1, p2, threshold, hypotheses, seed)
    F = models[counts.argmax()]
    inl = sampson(F, p1, p2) < threshold
    for _ in range(2):
        G = refit(p1, p2, inl.float())
        inl_g = sampson(G, p1, p2) < threshold
        if inl_g.sum() >= inl.sum():
            F, inl = G, inl_g
    return F, inl
