"""k3_roofline.batch2: K3 (ops/cuda_detect.detect_maps, the NMS and
localisation maps of one detection level of a sparse octave) against
its roofline over the traced calls, in percent.

Device time: the kernels named detect_maps_kernel.  Work of a call,
from its shapes, in each octave of pyramid.octave_shapes of 2^23 pixels
or more (the octaves that take the sparse path), for each of its
num_scales detection levels and each pixel: the three response planes
of the level and its neighbours read (12 bytes), the maps [b0, b1, b2,
val] (16 bytes) and the nan, edge and mask flags (1 byte each) written;
30 float32 operations for the NMS and the 3x3 solve, as
k2_roofline.batch16 counts them.
"""

from benchmark import features, peaks
from benchmark.reference.hesaff_plain import pyramid

KERNELS = ("detect_maps_kernel",)
SPARSE_PATH_PIXELS = 1 << 23
BYTES_A_PIXEL = 3 * 4 + 4 * 4 + 3
OPS_A_PIXEL = 30


def call_work(B: int, H: int, W: int, cfg) -> tuple[float, float]:
    """(bytes, float32 operations) of K3 in one call of B H x W images."""
    px = sum(B * h * w * cfg.num_scales
             for h, w, _ in pyramid.octave_shapes(H, W, cfg)
             if h * w >= SPARSE_PATH_PIXELS)
    return float(px * BYTES_A_PIXEL), float(px * OPS_A_PIXEL)


def read(run):
    t = run.trace
    if t is None:
        return None
    cfg = features.reference_config(run.config)
    bound = sum(peaks.bound_s(*call_work(w["batch"], w["height"],
                                         w["width"], cfg), peaks.F32_OPS)
                for w in t.work if w)
    return peaks.share(bound, t.device_us(KERNELS) / 1e6)
