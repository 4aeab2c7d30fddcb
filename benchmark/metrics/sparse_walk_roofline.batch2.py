"""sparse_walk_roofline.batch2: the sparse path's localisation walk
against its roofline over the traced calls, in percent.

Work: the candidates walked, which only the program knows: its counter
``sparse_candidates`` (hesaff_tpu_torch.utils.profiling.counters(),
read after the window; it grows only while the profiler records, so it
covers the traced calls).  Each candidate reads its (2R + 1) x (2R + 3)
window (R = localize_iterations - 1) of the level's maps (16 bytes a
pixel), nan and edge flags (1 byte each) and blur plane (4 bytes): 22
bytes a window pixel, at HBM's bandwidth.  The count is the same
whatever implements the walk.  Device time: the device's busy time
inside the program's "sparse: walk" spans.  Nothing is read where the
program has no such counter or span.
"""

from benchmark import features, peaks

SPAN = "sparse: walk"
BYTES_A_WINDOW_PIXEL = 16 + 1 + 1 + 4


def candidates_walked():
    """The program's sparse_candidates total, or None where it keeps
    none."""
    try:
        from hesaff_tpu_torch.utils import profiling
        return profiling.counters().get("sparse_candidates")
    except (ImportError, AttributeError):
        return None


def walk_bytes(candidates: int, cfg) -> float:
    R = cfg.localize_iterations - 1
    return float(candidates * (2 * R + 1) * (2 * R + 3)
                 * BYTES_A_WINDOW_PIXEL)


def read(run):
    t = run.trace
    if t is None:
        return None
    n = candidates_walked()
    if not n:
        return None
    cfg = features.reference_config(run.config)
    bound = peaks.bound_s(walk_bytes(n, cfg), 0.0, peaks.F32_OPS)
    return peaks.share(bound, t.busy_in_spans_us(SPAN) / 1e6)
