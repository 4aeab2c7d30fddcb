"""Image retrieval over a pooled descriptor database.

Port of ``hesaff_tpu/retrieval.py``.  Oxford5k-style protocol: pool all
database descriptors with an image-id map, and answer a query by kNN
voting — each query descriptor votes for the image owning its nearest
database descriptor when it passes the Lowe ratio test against the
second; images rank by votes.  The 2-NN is the port's ``match.knn2`` on
`device`, or over a process group ``match.ring_knn2``
(``sharded_query_votes``); the votes are counted on the host as the JAX
package counts them, so they are equal to its votes.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from hesaff_tpu_torch import comm
from hesaff_tpu_torch.match import knn2, ring_knn2
from hesaff_tpu_torch.pipeline import resolve_device


class DescriptorIndex(NamedTuple):
    desc: np.ndarray      # (M, 128) float32 (uint8 promoted)
    image_id: np.ndarray  # (M,) int32 owner image per descriptor
    n_images: int


def build_index(desc_per_image: Sequence[np.ndarray]) -> DescriptorIndex:
    """Pool per-image descriptor arrays into one flat index."""
    descs = []
    ids = []
    for i, d in enumerate(desc_per_image):
        if len(d):
            descs.append(np.asarray(d, np.float32))
            ids.append(np.full(len(d), i, np.int32))
    if not descs:
        return DescriptorIndex(np.zeros((0, 128), np.float32),
                               np.zeros(0, np.int32), len(desc_per_image))
    return DescriptorIndex(
        np.concatenate(descs), np.concatenate(ids), len(desc_per_image)
    )


def query_votes(index: DescriptorIndex, query_desc, ratio: float = 0.9,
                device=None):
    """Vote histogram over database images for one query image.

    Each query descriptor's nearest database neighbour votes for its
    image when it passes the Lowe ratio test against the second
    neighbour.  The 2-NN runs on `device` (default: the query tensor's
    device, or the GPU).  Returns
    (votes (n_images,), matches (Nq,) db row or -1), numpy int32.
    """
    dev = resolve_device(query_desc, device)
    if len(query_desc) == 0 or len(index.desc) == 0:
        return np.zeros(index.n_images, np.int32), np.full(0, -1, np.int32)
    if not isinstance(query_desc, torch.Tensor):
        query_desc = np.asarray(query_desc, np.float32)
    m = knn2(query_desc, index.desc, device=dev)
    idx = m.idx.cpu().numpy()
    keep = m.dist.cpu().numpy() < (ratio * ratio) * m.dist2.cpu().numpy()
    votes = np.zeros(index.n_images, np.int64)
    np.add.at(votes, index.image_id[idx[keep]], 1)
    matches = np.where(keep, idx, -1).astype(np.int32)
    return votes.astype(np.int32), matches


def rank_images(index: DescriptorIndex, query_desc, ratio: float = 0.9,
                top_k: int = 10, device=None):
    """Ranked (image_id, votes) list for a query descriptor set."""
    votes, _ = query_votes(index, query_desc, ratio, device=device)
    order = np.argsort(-votes, kind="stable")[:top_k]
    return [(int(i), int(votes[i])) for i in order if votes[i] > 0]


def sharded_query_votes(mesh, index: DescriptorIndex, query_desc,
                        ratio: float = 0.9, device=None):
    """query_votes' histogram with the database sharded over a process
    group (mesh, from dist.make_mesh).

    Every rank calls it with the whole index and query.  The database is
    padded with rows of 1e6 and the queries with zero rows to a multiple
    of the group's size, as the JAX package pads them; rank r takes the
    r-th shard of each and runs the ring (match.ring_knn2) on `device`
    (default: the query tensor's, or the GPU).  The ranks' matches are
    gathered to every rank and the votes counted on the host: equal to
    query_votes'.  Returns votes (n_images,) int32.
    """
    dev = resolve_device(query_desc, device)
    r, n = comm.rank_and_size(mesh)
    q = np.asarray(query_desc.cpu() if isinstance(query_desc, torch.Tensor)
                   else query_desc, np.float32)
    M, Q, D = len(index.desc), len(q), index.desc.shape[1]
    db = np.concatenate([index.desc, np.full(((-M) % n, D), 1e6,
                                             np.float32)])
    q = np.concatenate([q.reshape(Q, D), np.zeros(((-Q) % n, D),
                                                  np.float32)])
    qs, ds = len(q) // n, len(db) // n
    m = ring_knn2(q[r * qs:(r + 1) * qs], db[r * ds:(r + 1) * ds], mesh,
                  device=dev)
    idx, dist, dist2 = (comm.all_gather_cat(t, mesh).cpu().numpy()[:Q]
                        for t in m)
    # padded rows (1e6) cannot win against a real row
    keep = (dist < (ratio * ratio) * dist2) & (idx < M)
    votes = np.zeros(index.n_images, np.int64)
    np.add.at(votes, index.image_id[idx[keep]], 1)
    return votes.astype(np.int32)
