"""affine_host_ms.batch16: host milliseconds of the program's "A:
affine" spans (phase A's adaptation of each octave: its inputs, K4 and
the rectified frames), summed a call and averaged over the traced
calls."""

SPAN = "A: affine"


def read(run):
    t = run.trace
    if t is None or not any(n == SPAN for n, _, _ in t.spans):
        return None
    return sum(b - a for n, a, b in t.spans if n == SPAN) / 1e3 / t.calls
