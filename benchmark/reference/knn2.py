"""Plain exact 2-NN, vote histogram and ranking of a retrieval query.

The semantics of ``hesaff_tpu_torch.retrieval.rank_images`` written out
plainly: each query row's nearest database row (squared L2; a tie keeps
the lower row) votes for its image when its distance is below ratio^2
times the second-nearest's; images rank by votes, ties by image id, and
images with no vote are left out.  For uint8 rows every squared
distance is an integer below 2^24, so float32 products give it exactly
in any order, with or without TF32 (whose 10-bit mantissa holds any
uint8 value).
"""

from __future__ import annotations

import numpy as np
import torch


def two_nn(q: torch.Tensor, db: torch.Tensor, block: int = 1 << 18):
    """(idx, d1, d2) of each row of q (N, D) in db (M, D), both uint8 or
    float32 tensors on one device; blocks of `block` database rows."""
    qf = q.to(torch.float32)
    qn = (qf * qf).sum(1, keepdim=True)
    N = qf.shape[0]
    best_i = torch.zeros(N, dtype=torch.int64, device=q.device)
    best_d = torch.full((N,), float("inf"), device=q.device)
    second = torch.full((N,), float("inf"), device=q.device)
    for b0 in range(0, db.shape[0], block):
        d = db[b0:b0 + block].to(torch.float32)
        dist = qn + (d * d).sum(1)[None, :] - 2.0 * (qf @ d.T)
        i1 = dist.argmin(1)                       # first of equal minima
        d1 = dist.gather(1, i1[:, None])[:, 0]
        dist.scatter_(1, i1[:, None], float("inf"))
        d2 = dist.amin(1)
        new = d1 < best_d                         # a tie keeps the earlier
        second = torch.where(new, torch.minimum(best_d, d2),
                             torch.minimum(second, d1))
        best_i = torch.where(new, i1 + b0, best_i)
        best_d = torch.where(new, d1, best_d)
    return best_i, best_d, second


def votes_and_matches(q, db, image_id: np.ndarray, n_images: int,
                      ratio: float):
    """(votes (n_images,) int64, matches (N,) db row or -1) of a query."""
    if q.shape[0] == 0 or db.shape[0] == 0:
        return np.zeros(n_images, np.int64), np.full(q.shape[0], -1)
    idx, d1, d2 = (t.cpu().numpy() for t in two_nn(q, db))
    keep = d1 < np.float32(ratio * ratio) * d2
    votes = np.bincount(image_id[idx[keep]], minlength=n_images)
    return votes, np.where(keep, idx, -1)


def ranked(votes: np.ndarray, top_k: int) -> list:
    """[(image, votes)] of the top_k images by votes, ties by image id,
    images without a vote left out."""
    order = np.argsort(-votes, kind="stable")[:top_k]
    return [(int(i), int(votes[i])) for i in order if votes[i] > 0]
