"""k6_roofline.batch16: K6 (ops/cuda_sift.describe_masked, SIFT of
every valid slot, zero rows elsewhere) against its roofline over the
traced calls, in percent.

Device time: the kernels named sift_kernel (the warp64 instance the
default configuration takes).  Work of a call, from the keypoints it
described (never from the program's slots): each patch (P x P float32)
read once, its valid flag read and its uint8 row written; ~30 float32 operations a pixel (normalisation, gradients,
magnitude, atan2, the two-bin orientation split), then the row binning
(a multiply-add of each of a pixel's 2 orientation values into each
non-zero spatial bin of its row, on the circular mask's support) and
the column binning (sb x ob sums into each column's non-zero bins).
Bound by float32 operations or bytes, whichever is larger.
"""

from benchmark import features, peaks
from benchmark.reference.hesaff_plain.ops import masks

KERNELS = ("sift_kernel",)


def call_bound_s(w: dict, cfg) -> float:
    P, sb, ob = cfg.patch_size, cfg.spatial_bins, cfg.orientation_bins
    n = w["described"]
    nz = (masks.sift_spatial_bins(P, sb) != 0).sum(axis=1)
    support = masks.circular_gauss_mask(P) > 0
    ops = n * (30 * P * P + 2 * 2 * int((support * nz[:, None]).sum())
               + 2 * sb * ob * int(nz.sum()))
    nbytes = n * (P * P * 4 + 1 + sb * sb * ob)
    return peaks.bound_s(nbytes, ops, peaks.F32_OPS)


def read(run):
    t = run.trace
    if t is None:
        return None
    cfg = features.reference_config(run.config)
    bound = sum(call_bound_s(w, cfg) for w in t.work if w)
    return peaks.share(bound, t.device_us(KERNELS) / 1e6)
