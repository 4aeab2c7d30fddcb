"""detect_host_ms.batch16: host milliseconds of the program's "A:
detect" spans (phase A's detect_octave_batch of each octave: K2 or K3,
compaction, dedup and the fields), summed a call and averaged over the
traced calls."""

SPAN = "A: detect"


def read(run):
    t = run.trace
    if t is None or not any(n == SPAN for n, _, _ in t.spans):
        return None
    return sum(b - a for n, a, b in t.spans if n == SPAN) / 1e3 / t.calls
