"""k1_roofline.batch16: K1 (ops/cuda_blur, blur + DoH of each ladder
level) against its roofline over the traced calls, in percent.

Device time: the kernels named blur_doh_kernel (every instance).  Work
of a call, from its shapes: the initial blur of the (B, H, W) input
(one plane read, one written, 2 float32 operations a tap in each of its
two passes), then in each octave of pyramid.octave_shapes five levels,
each one plane read and two written (blur and response), 4 operations a
tap and 13 for the DoH a pixel; level 0 takes the identity tap.  Bound
by float32 operations or bytes, whichever is larger.
"""

from benchmark import features, peaks
from benchmark.reference.hesaff_plain import pyramid

KERNELS = ("blur_doh_kernel",)


def call_bound_s(B: int, H: int, W: int, cfg) -> float:
    nbytes = ops = 0.0
    shapes = pyramid.octave_shapes(H, W, cfg)
    first = pyramid.first_level_taps(cfg)
    if first is not None:
        h, w, _ = shapes[0]
        nbytes += 2 * 4 * B * h * w
        ops += 4 * len(first) * B * h * w
    taps = [1] + [len(t) for t in pyramid.ladder_taps(cfg)]
    for h, w, _ in shapes:
        px = B * h * w
        nbytes += len(taps) * 3 * 4 * px
        ops += sum(4 * k + 13 for k in taps) * px
    return peaks.bound_s(nbytes, ops, peaks.F32_OPS)


def read(run):
    t = run.trace
    if t is None:
        return None
    cfg = features.reference_config(run.config)
    bound = sum(call_bound_s(w["batch"], w["height"], w["width"], cfg)
                for w in t.work if w)
    return peaks.share(bound, t.device_us(KERNELS) / 1e6)
