"""Exact 2-NN of uint8 rows on the card: the K7 kernel.

The kernel (csrc/knn2_u8.cu) replaces no TPU kernel: the JAX package's
knn2 is a blocked float32 loop, which ``match.knn2`` keeps as the plain
version for every other input (CPU tensors, float32 indexes, other
widths, a one-row database).  ``match.knn2`` calls ``knn2`` here when
query and database are uint8 rows of 128 on the card and the database
has at least 2 rows; the result equals the plain version's bit for bit.
A call is three launches on the current stream and no host sync: the
index rows' keys (|d|^2 + 2^23), the strips (int8 tensor-core products,
the running best and second kept on chip) and the merge of each query
row's strips.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from hesaff_tpu_torch.ops import cuda_build

# kernel launches in this process (three a call)
LAUNCHES = 0

# query rows a CTA holds and index rows a tile holds (the kernel's
# QROWS and DROWS), and the row width it takes
QROWS, DROWS, DIM = 128, 256, 128
# a work item's fixed cost in tiles (loading its query tile, filling the
# ring, writing its partials), for plan's cost model
ITEM_COST_TILES = 2

_vp, _i = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_vp, _i, _vp, ctypes.c_longlong, _i, _i, _i] + [_vp] * 6


def plan(nq: int, m: int, n_sm: int) -> tuple[int, int]:
    """(strips, CTAs) of a call: the index's ceil(m / 256) tiles cut into
    `strips` runs of whole tiles, one work item a (query tile, strip),
    walked by min(items, n_sm) persistent CTAs.  The strip count
    minimises the rounds of items times an item's length in tiles (plus
    its fixed cost), so that the SMs finish together: for ~2,750 query
    rows (22 tiles) against 16.33 M rows on 132 SMs, 6 strips and 132
    items, one an SM."""
    qt, dt = -(-nq // QROWS), -(-m // DROWS)
    s = np.arange(1, min(dt, 4 * n_sm) + 1)
    cost = -(-(qt * s) // n_sm) * (-(-dt // s) + ITEM_COST_TILES)
    strips = int(s[np.argmin(cost)])
    return strips, min(qt * strips, n_sm)


def knn2(q: torch.Tensor, db: torch.Tensor):
    """(idx (Nq,) int32, dist, dist2 (Nq,) float32) of each row of q
    (Nq, 128) in db (M, 128), M >= 2: both uint8, contiguous, 16-byte
    aligned, on one CUDA device.  Raises on anything else."""
    global LAUNCHES
    for name, t in (("query", q), ("database", db)):
        if t.device.type != "cuda" or t.dtype != torch.uint8:
            raise ValueError(f"knn2_u8: the {name} must be a uint8 CUDA "
                             f"tensor, not {t.dtype} on {t.device}")
        if t.dim() != 2 or t.shape[1] != DIM:
            raise ValueError(f"knn2_u8: the {name} must be (N, {DIM}), not "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"knn2_u8: the {name} must be contiguous and "
                             "16-byte aligned")
    if q.device != db.device:
        raise ValueError("knn2_u8: query and database on two devices")
    nq, m = q.shape[0], db.shape[0]
    if m < 2:
        raise ValueError("knn2_u8: needs a database of at least 2 rows")
    dev = q.device
    idx = torch.empty(nq, dtype=torch.int32, device=dev)
    dist = torch.empty(nq, dtype=torch.float32, device=dev)
    dist2 = torch.empty(nq, dtype=torch.float32, device=dev)
    if nq == 0:
        return idx, dist, dist2
    n_sm = cuda_build.sm_count(dev)
    strips, ctas = plan(nq, m, n_sm)
    keys = torch.empty(-(-m // DROWS) * DROWS, dtype=torch.int32,
                       device=dev)
    part = torch.empty(3 * strips * nq, dtype=torch.int32, device=dev)
    fn = cuda_build.entry("knn2_u8", "hesaff_knn2_u8", _ARGTYPES)
    p = cuda_build.ptr
    with torch.cuda.device(dev):
        err = fn(p(q), nq, p(db), m, strips, ctas, n_sm, p(keys), p(part),
                 p(idx), p(dist), p(dist2), cuda_build.stream(dev))
    cuda_build.check(err, "knn2_u8")
    LAUNCHES += 3
    return idx, dist, dist2
