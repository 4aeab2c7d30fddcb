"""knn2_idle_share.query: the share of the program's "knn2: blocks"
spans (match.knn2's loop over the index's blocks) in which the device
ran nothing, over the traced queries, in percent: 1 - the device's busy
time inside the spans over their length."""

SPAN = "knn2: blocks"


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    length = sum(b - a for n, a, b in t.spans if n == SPAN)
    if length <= 0:
        return None
    return 100.0 * (1.0 - t.busy_in_spans_us(SPAN) / length)
