"""knn2_roofline.query: the 2-NN of a query against the index (match
under retrieval.rank_images) against its roofline over the traced
queries, in percent.

Device time: every device interval inside the benchmark's "bench:
knn2" span around rank_images (which ends with the votes on the host),
as the union of the intervals.  Work of a query: 2 x Nq x M x D
multiply-adds of uint8 values, exact in int32, so bounded by the int8
tensor cores' peak; bytes: the uint8 index read once, the Nq uint8
query rows read once and each row's index and two distances written.
"""

from benchmark import peaks


def call_bound_s(w: dict) -> float:
    nq, m, d = w["query_rows"], w["index_rows"], w["dim"]
    return peaks.bound_s(m * d + nq * d + nq * 12, 2.0 * nq * m * d,
                         peaks.INT8_OPS)


def read(run):
    t = run.trace
    if t is None:
        return None
    bound = sum(call_bound_s(w) for w in t.work if w)
    return peaks.share(bound, t.busy_in_spans_us("bench: knn2") / 1e6)
