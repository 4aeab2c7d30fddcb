"""ladder_host_ms.batch16: host milliseconds of the program's "A:
ladder" spans (phase A's blur + DoH ladder, the K1 launches: the
initial blur and each octave's build_octave), summed a call and
averaged over the traced calls."""

SPAN = "A: ladder"


def read(run):
    t = run.trace
    if t is None or not any(n == SPAN for n, _, _ in t.spans):
        return None
    return sum(b - a for n, a, b in t.spans if n == SPAN) / 1e3 / t.calls
