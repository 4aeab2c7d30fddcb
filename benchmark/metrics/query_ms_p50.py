"""query_ms_p50: the median time of every query completed in the
window, from the query image on the host to the ranked list on the host
(host clock, milliseconds)."""

from benchmark.harness import quantile


def read(run):
    return 1e3 * quantile([c.t1 - c.t0 for c in run.calls], 0.5)
