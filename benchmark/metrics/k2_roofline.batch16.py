"""k2_roofline.batch16: K2 (ops/cuda_detect.detect_walk_octave, NMS,
localisation and the walk of every detection level of a dense octave)
against its roofline over the traced calls, in percent.

Device time: the kernels named detect_walk_kernel.  Work of a call,
from its shapes, in each octave of pyramid.octave_shapes under 2^23
pixels: the num_scales + 2 response planes and num_scales blur planes
read, and for each of the num_scales levels the ok (1 byte), cell (4),
table (5 x 4) and candidate (1) planes written; 30 float32 operations
a pixel of each level for the NMS and the 3x3 solve.  The walk's
operations a candidate depend on the data and are left out: at these
sizes they are under a tenth of the bytes' time.
"""

from benchmark import features, peaks
from benchmark.reference.hesaff_plain import pyramid

KERNELS = ("detect_walk_kernel",)
SPARSE_PATH_PIXELS = 1 << 23


def call_bound_s(B: int, H: int, W: int, cfg) -> float:
    nl = cfg.num_scales
    nbytes = ops = 0.0
    for h, w, _ in pyramid.octave_shapes(H, W, cfg):
        if h * w >= SPARSE_PATH_PIXELS:
            continue
        px = B * h * w
        nbytes += px * ((nl + 2) * 4 + nl * 4 + nl * (1 + 4 + 20 + 1))
        ops += 30 * nl * px
    return peaks.bound_s(nbytes, ops, peaks.F32_OPS)


def read(run):
    t = run.trace
    if t is None:
        return None
    cfg = features.reference_config(run.config)
    bound = sum(call_bound_s(w["batch"], w["height"], w["width"], cfg)
                for w in t.work if w)
    return peaks.share(bound, t.device_us(KERNELS) / 1e6)
