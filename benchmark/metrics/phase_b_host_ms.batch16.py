"""phase_b_host_ms.batch16: host milliseconds of the program's phase B
spans ("group N: select" and "group N: patches" of
dist.group_selections / group_patches, and "SIFT" of
dist.describe_valid), summed a call and averaged over the traced calls."""

SPANS = ("group ", "SIFT")


def read(run):
    t = run.trace
    if t is None or not any(n.startswith(SPANS) for n, _, _ in t.spans):
        return None
    return t.span_total_us(SPANS) / 1e3 / t.calls
