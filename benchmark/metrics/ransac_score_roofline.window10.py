"""ransac_score_roofline.window10: F-RANSAC's scoring (the Sampson
distance of every hypothesis at every tentative match, its count under
the threshold and the best count) against its roofline over the traced
calls, in percent.

Work: the program's counter ``ransac_residuals`` (hypotheses x matches
scored, summed over the pairs; it grows only while the profiler
records), SAMPSON_OPS float32 operations each: F x1 (x1 = (x, y, 1):
3 rows of 2 multiplies and 2 adds, 12), the first two rows of F^T x2
(8), x2^T F x1 from F x1 (2 multiplies, 2 adds) and its square (5), the
denominator's four squares and three adds (7), the division, the
comparison and the count (3).  Bytes: each scored pair's inputs and
outputs read or written once: its hypotheses' models (9 float32), its
matches' two positions (4 float32) and a count a hypothesis (4 bytes),
from the driver's record of the traced calls' pairs.  Device time: the
device's busy time inside the program's "ransac: score" spans, each of
which ends when the host reads the best hypothesis (so it holds its
kernels).  Nothing is read where the program has no such counter or
span.
"""

from benchmark import peaks

SPAN = "ransac: score"
SAMPSON_OPS = 35
MIN_SET = 8


def pair_bytes(hypotheses: int, matches: int) -> float:
    return hypotheses * (9 * 4 + 4) + matches * 4 * 4


def residuals():
    try:
        from hesaff_tpu_torch.utils import profiling
        return profiling.counters().get("ransac_residuals")
    except (ImportError, AttributeError):
        return None


def read(run):
    t = run.trace
    if t is None:
        return None
    n = residuals()
    if not n:
        return None
    nbytes = sum(pair_bytes(w["hypotheses"], m) for w in t.work if w
                 for _, _, m in w["pairs"] if m >= MIN_SET)
    bound = peaks.bound_s(nbytes, float(n) * SAMPSON_OPS, peaks.F32_OPS)
    return peaks.share(bound, t.busy_in_spans_us(SPAN) / 1e6)
