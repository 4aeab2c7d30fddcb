"""Descriptor matching: exact blocked 2-NN, Lowe-ratio matching and the
ring 2-NN over a process group.

Port of ``hesaff_tpu/match.py``.  Distances use the factorized form
||a-b||^2 = |a|^2 + |b|^2 - 2 a.b, so the O(N*M*128) term is one
float32 matrix product per column block (``torch.addmm_``, TF32 off for
the call); the running (best, second-best) merge over blocks never
materialises the N x M matrix.  One block is N x 4096 float32 and is
the only large buffer: the product is added into it in place and the
best column masked in place (``scatter_``).

For uint8 descriptors held as float32 every term is an integer below
2^24 (128 * 255^2 = 8,323,200; |q|^2 + |d|^2 <= 16,646,400), so the
distances are exact in any summation order and ``idx`` / ``dist`` /
``dist2`` equal the JAX package's bit for bit, on the CPU and on the
card.  Ties keep the first index: ``argmin`` within a block and a
strict ``<`` across blocks.  The last block is padded with rows of 1e6
as JAX pads it; only with a single database row does a padded row's
distance (not an integer, so not exact) reach ``dist2``.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from hesaff_tpu_torch import comm
from hesaff_tpu_torch.pipeline import resolve_device


class Matches(NamedTuple):
    idx: torch.Tensor     # (N,) int32 — best database index per query
    dist: torch.Tensor    # (N,) float32 — best squared L2 distance
    dist2: torch.Tensor   # (N,) float32 — second-best squared L2 distance


@contextlib.contextmanager
def full_f32():
    """Float32 matrix products in full float32 (no TF32) inside."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _topk2_block(q, db, base: int):
    """Best and second-best squared-L2 for q (n,128) against db (m,128)."""
    qn = (q * q).sum(1, keepdim=True)
    dn = (db * db).sum(1)[None, :]
    d = qn + dn
    d.addmm_(q, db.t(), alpha=-2.0)          # qn + dn - 2 q.db^T
    i1 = d.argmin(1)
    d1 = d.gather(1, i1[:, None])[:, 0]
    d.scatter_(1, i1[:, None], float("inf"))
    d2 = d.amin(1)
    return i1.to(torch.int32) + base, d1, d2


def knn2(query, db, block: int = 4096, device=None) -> Matches:
    """Exact 2-NN of each query descriptor in db (squared L2).

    query: (N, D); db: (M, D), numpy or tensors, computed in float32 on
    `device` (default: the query tensor's device, or the GPU).  Returns
    Matches of tensors on that device.
    """
    dev = resolve_device(query, device)
    q = torch.as_tensor(query, device=dev).to(torch.float32)
    d = torch.as_tensor(db, device=dev).to(torch.float32)
    N, M = q.shape[0], d.shape[0]
    nblk = max(1, -(-M // block))
    bi = torch.zeros(N, dtype=torch.int32, device=dev)
    bd1 = torch.full((N,), float("inf"), device=dev)
    bd2 = torch.full((N,), float("inf"), device=dev)
    with full_f32():
        for b in range(nblk):
            dbs = d[b * block:(b + 1) * block]
            if dbs.shape[0] < block:
                dbs = torch.cat([dbs, dbs.new_full(
                    (block - dbs.shape[0], d.shape[1]), 1e6)])
            bi, bd1, bd2 = _merge(bi, bd1, bd2,
                                  *_topk2_block(q, dbs, b * block))
    return Matches(idx=bi, dist=bd1, dist2=bd2)


def _merge(bi, bd1, bd2, i1, d1, d2):
    """Merge two (best, second) summaries; a strict < keeps the first."""
    new_best = d1 < bd1
    bd2 = torch.where(new_best, torch.minimum(bd1, d2),
                      torch.minimum(bd2, d1))
    return (torch.where(new_best, i1, bi), torch.where(new_best, d1, bd1),
            bd2)


def ring_knn2(query_local, db_local, group, device=None) -> Matches:
    """2-NN where both the queries and the database are sharded over a
    process group (the JAX package's ring_knn2 under shard_map).

    Every rank holds a query shard and a database shard of one size
    (the caller pads, as sharded_query_votes does).  In n steps the
    database shards go around the ring: at step k rank r compares its
    queries with the shard of rank (r - k) mod n (its own first), whose
    rows start at owner * shard, over the whole shard at once, merges
    the running (best, second) with a strict < (the first shard visited
    wins a tie, as in JAX's ring; dense knn2 keeps the lowest index),
    and passes the shard on to rank r + 1 (comm.ring_shift).  Runs on
    `device` (default: the query tensor's, or the GPU).  Returns the
    rank's Matches, indices into the whole database.
    """
    dev = resolve_device(query_local, device)
    q = torch.as_tensor(query_local, device=dev).to(torch.float32)
    db = torch.as_tensor(db_local, device=dev).to(torch.float32)
    r, n = comm.rank_and_size(group)
    shard = db.shape[0]
    bi = torch.zeros(q.shape[0], dtype=torch.int32, device=dev)
    bd1 = torch.full((q.shape[0],), float("inf"), device=dev)
    bd2 = torch.full((q.shape[0],), float("inf"), device=dev)
    with full_f32():
        for k in range(n):
            owner = (r - k) % n
            bi, bd1, bd2 = _merge(bi, bd1, bd2,
                                  *_topk2_block(q, db, owner * shard))
            if k < n - 1:
                db = comm.ring_shift(db, group)
    return Matches(idx=bi, dist=bd1, dist2=bd2)


def _host(m: Matches):
    return (m.idx.cpu().numpy(), m.dist.cpu().numpy(),
            m.dist2.cpu().numpy())


def match_descriptors(desc1, desc2, ratio: float = 0.8,
                      cross_check: bool = True, device=None):
    """Lowe-ratio (+ optional mutual) matching of uint8 SIFT descriptors.

    Runs the 2-NN on `device` (default: desc1's device if a tensor,
    else the GPU).  Returns (idx1, idx2) numpy int32 arrays of matched
    pairs.  The ratio test, dist < (ratio*ratio) * dist2, is taken in
    float32 on the host as the JAX package takes it.
    """
    dev = resolve_device(desc1, device)
    d1, d2 = (torch.as_tensor(d if isinstance(d, torch.Tensor)
                              else np.asarray(d), device=dev).to(torch.float32)
              for d in (desc1, desc2))
    if d1.shape[0] == 0 or d2.shape[0] == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    idx, dist, dist2 = _host(knn2(d1, d2))
    keep = dist < (ratio * ratio) * dist2
    i1 = np.nonzero(keep)[0]
    i2 = idx[i1]
    if cross_check and len(i1):
        bidx = _host(knn2(d2, d1))[0]
        mutual = bidx[i2] == i1
        i1, i2 = i1[mutual], i2[mutual]
    return i1.astype(np.int32), i2.astype(np.int32)
