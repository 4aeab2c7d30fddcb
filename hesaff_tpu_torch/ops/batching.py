"""Fixed-capacity stream compaction (plain PyTorch).

The JAX package compacts with cumsum compare-counts because a sort is
slow on the TPU.  Here ``torch.nonzero`` gives the same row-major
order.  The capacity stays, and what does not fit is counted.  The
``nonzero`` and each boolean-mask index wait for the device to learn
their sizes: each runs in a "sync: compact" span of its own.
"""

from __future__ import annotations

import torch

from hesaff_tpu_torch.utils.profiling import span


def compact_rows(mask: torch.Tensor, capacity: int):
    """Per-row compaction of a (B, N) mask to `capacity` slots.

    Returns (idx (B, capacity) int64, valid (B, capacity) bool,
    overflow (B,) int64): idx[b, j] is the j-th set position of row b in
    ascending order (0 in unused slots).
    """
    B, _ = mask.shape
    counts = mask.sum(dim=1)
    with span("sync: compact"):
        rows, cols = mask.nonzero(as_tuple=True)
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(rows.numel(), device=mask.device) - start[rows]
    fit = rank < capacity
    kept = []
    for t in (rows, rank, cols):
        with span("sync: compact"):
            kept.append(t[fit])
    idx = torch.zeros((B, capacity), dtype=torch.int64, device=mask.device)
    idx[kept[0], kept[1]] = kept[2]
    slots = torch.arange(capacity, device=mask.device)
    valid = slots[None, :] < counts[:, None]
    overflow = torch.clamp_min(counts - capacity, 0)
    return idx, valid, overflow


def compact_indices(mask: torch.Tensor, capacity: int):
    """Row-major indices of set elements, padded to `capacity`.

    Returns (idx, valid, overflow); idx indexes mask.reshape(-1).
    """
    idx, valid, overflow = compact_rows(mask.reshape(1, -1), capacity)
    return idx[0], valid[0], overflow[0]
