"""sync_wait_ms.batch16: host milliseconds inside the program's "sync:
..." spans, each around one call that waits for the device (a nonzero,
a boolean-mask index, a copy to or from the host), summed a call and
averaged over the traced calls."""

PREFIX = "sync: "


def read(run):
    t = run.trace
    if t is None or not any(n.startswith(PREFIX) for n, _, _ in t.spans):
        return None
    return t.span_total_us([PREFIX]) / 1e3 / t.calls
