"""Every F-RANSAC hypothesis' inlier count on the card: the K8 kernel.

The kernel (csrc/ransac_score.cu) replaces no TPU kernel: the JAX
package scores its hypotheses with batched products under XLA.
``ransac._ransac`` calls ``sampson_counts`` here for the fundamental
model when the points lie on the card; everywhere else it keeps the
plain version, ``ransac._f_residuals`` compared with the threshold and
summed, whose counts the kernel's equal bit for bit (the same float32
operations in the same order).  A call packs the matches once as float4
(x, y, u, v), then makes one launch on the current stream (after a
memset of the counts) and no host sync; no (H, N) value is stored.
"""

from __future__ import annotations

import ctypes

import torch

from hesaff_tpu_torch.ops import cuda_build

# kernel launches in this process (one a call)
LAUNCHES = 0

# hypotheses a CTA holds (the kernel's THREADS x PER_THREAD), matches a
# tile holds (TILE), and the CTAs an SM should get
HYPS, TILE = 128 * 4, 256
CTAS_PER_SM = 16

_vp, _i = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_vp, _i, _vp, _i, ctypes.c_float, _i, _i, _vp, _vp]


def plan(h: int, n: int, n_sm: int) -> tuple[int, int]:
    """(chunk, chunks) of a call: the n matches cut into `chunks` runs of
    `chunk` (a multiple of TILE), the grid's second dimension, so that
    the ceil(h / HYPS) CTAs of hypotheses times the chunks give about
    CTAS_PER_SM CTAs an SM, and no chunk is empty.  At 10,000 hypotheses
    and 51,000 matches on 132 SMs: 20 x 100 CTAs of 512 matches."""
    tiles = -(-n // TILE)
    want = -(-CTAS_PER_SM * n_sm // -(-h // HYPS))
    per = -(-tiles // max(1, min(want, tiles)))
    return per * TILE, -(-tiles // per)


def sampson_counts(models: torch.Tensor, p1: torch.Tensor,
                   p2: torch.Tensor, threshold: float) -> torch.Tensor:
    """(H,) int32: for each of the (H, 3, 3) float32 models, the matches
    (p1[n], p2[n]) whose Sampson distance is under `threshold` (in
    float32).  p1, p2: (N, 2) float32.  All contiguous on one CUDA
    device; raises on anything else."""
    global LAUNCHES
    for name, t, shape in (("models", models, (3, 3)), ("p1", p1, (2,)),
                           ("p2", p2, (2,))):
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise ValueError(f"ransac_score: {name} must be a float32 CUDA "
                             f"tensor, not {t.dtype} on {t.device}")
        if t.dim() != 1 + len(shape) or tuple(t.shape[1:]) != shape:
            raise ValueError(f"ransac_score: {name} must be (*, "
                             f"{', '.join(map(str, shape))}), not "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"ransac_score: {name} must be contiguous")
    if not models.device == p1.device == p2.device:
        raise ValueError("ransac_score: models and points on two devices")
    if p1.shape[0] != p2.shape[0]:
        raise ValueError(f"ransac_score: {p1.shape[0]} points against "
                         f"{p2.shape[0]}")
    h, n, dev = models.shape[0], p1.shape[0], p1.device
    if h == 0 or n == 0:
        return torch.zeros(h, dtype=torch.int32, device=dev)
    if n >= 2**31 - TILE:
        raise ValueError(f"ransac_score: {n} points, over the kernel's "
                         "int32 range")
    matches = torch.cat([p1, p2], 1)
    counts = torch.empty(h, dtype=torch.int32, device=dev)
    chunk, chunks = plan(h, n, cuda_build.sm_count(dev))
    fn = cuda_build.entry("ransac_score", "hesaff_ransac_score", _ARGTYPES)
    p = cuda_build.ptr
    with torch.cuda.device(dev):
        err = fn(p(models), h, p(matches), n, threshold, chunk, chunks,
                 p(counts), cuda_build.stream(dev))
    cuda_build.check(err, "ransac_score")
    LAUNCHES += 1
    return counts
