"""Fixed-capacity stream compaction (plain PyTorch, no host sync).

The JAX package compacts with cumsum compare-counts because a sort is
slow on the TPU.  Here one running count of the set elements (a scan of
the flat mask) and a binary search of each slot's target in it give
the same row-major order at fixed shapes, so nothing waits for the
device.  The capacity stays, and what does not fit is counted.
"""

from __future__ import annotations

import torch


def compact_rows(mask: torch.Tensor, capacity: int):
    """Per-row compaction of a (B, N) mask to `capacity` slots.

    Returns (idx (B, capacity) int64, valid (B, capacity) bool,
    overflow (B,) int64): idx[b, j] is the j-th set position of row b in
    ascending order (0 in unused slots).
    """
    B, N = mask.shape
    dev = mask.device
    slots = torch.arange(capacity, device=dev)
    if N == 0:
        none = torch.zeros(B, dtype=torch.int64, device=dev)
        return (torch.zeros((B, capacity), dtype=torch.int64, device=dev),
                slots[None, :] < none[:, None], none)
    # the running count over the flat mask, rows one after another (one
    # device-wide scan): the (j+1)-th set element of row b is where it
    # first reaches the count before row b plus j + 1
    dt = torch.int32 if mask.numel() < 2**31 else torch.int64
    run = torch.cumsum(mask.reshape(-1), 0, dtype=dt)
    ends = run.view(B, N)[:, -1]
    before = torch.cat([ends.new_zeros(1), ends[:-1]])
    counts = (ends - before).long()
    target = before[:, None] + (slots + 1).to(dt)
    pos = torch.searchsorted(run, target.reshape(-1)).view(B, capacity)
    valid = slots[None, :] < counts[:, None]
    rowbase = torch.arange(B, device=dev)[:, None] * N
    idx = torch.where(valid, pos - rowbase, 0)
    return idx, valid, torch.clamp_min(counts - capacity, 0)


def compact_indices(mask: torch.Tensor, capacity: int):
    """Row-major indices of set elements, padded to `capacity`.

    Returns (idx, valid, overflow); idx indexes mask.reshape(-1).
    """
    idx, valid, overflow = compact_rows(mask.reshape(1, -1), capacity)
    return idx[0], valid[0], overflow[0]
