"""sparse_walk_host_ms.batch2: host milliseconds of the program's
"sparse: walk" spans (detect.detect_level's raster compaction of a
sparse level's candidates and their localisation walks, its "sync:
compact" waits included), summed a call and averaged over the traced
calls."""

SPAN = "sparse: walk"


def read(run):
    t = run.trace
    if t is None or not any(n == SPAN for n, _, _ in t.spans):
        return None
    return sum(b - a for n, a, b in t.spans if n == SPAN) / 1e3 / t.calls
