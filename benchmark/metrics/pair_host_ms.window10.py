"""pair_host_ms.window10: host milliseconds a call inside the program's
pair-stage spans, "pair: ..." (the 2-NN of the window, the ratio and
cross-check tests with the copy of the index pairs to the host, the
verdicts' copy) and "ransac: ..." (each pair's draw, solve, scoring and
refits), summed a call and averaged over the traced calls.  Nothing is
read where the program opens no such span."""

PREFIXES = ("pair: ", "ransac: ")


def read(run):
    t = run.trace
    if t is None or not any(n.startswith(PREFIXES) for n, _, _ in t.spans):
        return None
    return t.span_total_us(PREFIXES) / 1e3 / t.calls
