"""k5_roofline.batch16: K5 (ops/cuda_patches, the fused warp, blur and
subsample of each group's keypoints) against its roofline over the
traced calls, in percent.

Device time: the kernels named patches_kernel (every tile geometry).
The work is counted from the keypoints the call described (the slots
K5 filled; those it rejected at a border are left out, so the count can
only be low), never from the program's slots: each keypoint falls in
the group of the configuration's own table (the reference's
default_group_spec) that its workspace fits.  Bytes of a call: the (B,
H, W) images read once, each pyramid level that a tail group with
keypoints warps from read once, and for every keypoint its eight words, its KMAX blur taps and
active flag read and its P x P patch and bad flag written.  Operations:
~10 a bilinear sample of the ws x ws workspace, then WS.R^T and R.T over
the band of R that its own taps give (non-zero taps + 1).  Bound by
float32 operations or bytes, whichever is larger.
"""

import numpy as np

from benchmark import features, peaks
from benchmark.reference.hesaff_plain import dist, pyramid
from benchmark.reference.hesaff_plain.patches import _max_ksize_for_bucket

KERNELS = ("patches_kernel",)


def call_bound_s(w: dict, cfg, per_image_cap: int) -> float:
    B, H, W = w["batch"], w["height"], w["width"]
    groups = dist.default_group_spec(H, W, cfg, per_image_cap, B)
    P, f = cfg.patch_size, cfg.patch_smooth_factor
    base_pd = 0.5 if cfg.upscale_input else 1.0
    shapes = pyramid.octave_shapes(H, W, cfg)
    nbytes = 4.0 * B * H * W
    levels = set()
    S = 2 * np.ceil(np.asarray(w["s"], np.float64) * cfg.mr_size) + 1
    ws = S + 2
    ops, prev = 0.0, 0
    for bsize, _ in groups:
        m = (ws > prev) & (ws <= bsize)
        its = S[m] / P
        if bsize <= dist.FULL_RES_GROUP_MAX:
            src_ws, sigma, kmax = ws[m], f * its, _max_ksize_for_bucket(
                bsize, P, f)
        else:
            ps, octave, bucket_src = dist.tail_source_plan(bsize, base_pd)
            if m.any() and octave not in levels and octave < len(shapes):
                levels.add(octave)
                h, wd, _ = shapes[octave]
                nbytes += 4.0 * B * h * wd
            src_ws = 2 * np.ceil(S[m] / (2 * ps)) + 3
            sigma = np.sqrt(np.maximum((f * its / ps) ** 2
                                       - cfg.initial_sigma ** 2, 1e-4))
            kmax = _max_ksize_for_bucket(bucket_src, P, f)
        ksz = (6.0 * sigma + 1.0).astype(np.int64)
        ksz = ksz + 1 - ksz % 2
        band = np.minimum(np.minimum(ksz, kmax) + 1, src_ws)
        ops += float((10 * src_ws ** 2 + 2 * P * src_ws * band
                      + 2 * P * P * band).sum())
        nbytes += int(m.sum()) * (8 * 4 + 4 * kmax + 1 + 4 * P * P + 1)
        prev = bsize
    return peaks.bound_s(nbytes, ops, peaks.F32_OPS)


def read(run):
    t = run.trace
    if t is None:
        return None
    cfg = features.reference_config(run.config)
    cap = run.config["per_image_cap"]
    bound = sum(call_bound_s(w, cfg, cap) for w in t.work if w)
    return peaks.share(bound, t.device_us(KERNELS) / 1e6)
