"""call_ms_p95: the 95th percentile of the time of every call in the
window, from handing over host images to results on the host (host
clock, milliseconds)."""

from benchmark.harness import quantile


def read(run):
    return 1e3 * quantile([c.t1 - c.t0 for c in run.calls], 0.95)
