"""k4_roofline.batch16: K4 (ops/cuda_affine, the Baumberg loop of every
octave's keypoints) against its roofline over the traced calls, in
percent.

Device time: the kernels named affine_kernel.  Work: the Baumberg
steps the keypoints ran, which only the program knows: its counter
``k4_steps`` (hesaff_tpu_torch.utils.profiling.counters(), read after
the window; it grows only while the profiler records, so it covers the
traced calls).  A step samples the G x G grid (smm_window_size) at ~40
float32 operations a sample (coordinates, floors and tests, the
four-tap lerp, gradients and the three masked products), so the bound
is steps x G^2 x 40 operations at the float32 peak; its bytes, a grid's
pixels from the cache, are far below that.  Nothing is read where the
program has no such counter.
"""

from benchmark import features, peaks

KERNELS = ("affine_kernel",)
OPS_A_SAMPLE = 40


def steps_run():
    """The program's k4_steps total, or None where it keeps none."""
    try:
        from hesaff_tpu_torch.utils import profiling
        return profiling.counters().get("k4_steps")
    except (ImportError, AttributeError):
        return None


def read(run):
    t = run.trace
    if t is None:
        return None
    steps = steps_run()
    if not steps:
        return None
    G = features.reference_config(run.config).smm_window_size
    ops = steps * G * G * OPS_A_SAMPLE
    return peaks.share(ops / peaks.F32_OPS, t.device_us(KERNELS) / 1e6)
