"""extract_ms.query: host milliseconds of the benchmark's "bench:
extract" span around a query's extraction_step_grouped (it ends in a
synchronise), averaged over the traced queries."""


def read(run):
    t = run.trace
    spans = [b - a for n, a, b in (t.spans if t else [])
             if n == "bench: extract"]
    return sum(spans) / 1e3 / len(spans) if spans else None
