"""phase_a_host_ms.batch16: host milliseconds of the program's
"phase A" span (dist.phase_a: batch.detect_affine_batch, the ladder,
detection and affine adaptation), averaged over the traced calls."""


def read(run):
    t = run.trace
    if t is None or not any(n == "phase A" for n, _, _ in t.spans):
        return None
    return t.span_total_us(["phase A"]) / 1e3 / t.calls
