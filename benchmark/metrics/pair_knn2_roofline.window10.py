"""pair_knn2_roofline.window10: the pair stage's 2-NN (each pushed
frame's rows against each earlier frame of the window, both ways: the
K7 kernel) against its roofline over the traced calls, in percent.

Work: the program's counter ``pair_queries`` (query rows x database
rows summed over its 2-NN calls; hesaff_tpu_torch.utils.profiling.
counters(), read after the window: it grows only while the profiler
records), 2 x 128 int8 multiply-adds each, exact in int32, so bounded
by the int8 tensor cores' peak.  Bytes: each pair's uint8 rows read
once each way and each query row's index and two distances written
(12 bytes), from the driver's record of the traced calls' pairs.
Device time: K7's own, its three kernels' (``knn2_`` in their names):
the pair stage launches them inside its "pair: knn2" spans without
waiting for them, so they run on after the span has closed, and in this
cell nothing else launches them.  Nothing is read where the program has
no such counter or the trace no such kernel.
"""

from benchmark import peaks

KERNELS = ("knn2_",)
DIM = 128


def pair_bytes(n_older: int, n_newer: int) -> float:
    """Both directions of one pair: the rows of each frame read once as
    queries and once as the database, a 12-byte result a query row."""
    return 2.0 * (n_older + n_newer) * DIM + 12.0 * (n_older + n_newer)


def queries():
    try:
        from hesaff_tpu_torch.utils import profiling
        return profiling.counters().get("pair_queries")
    except (ImportError, AttributeError):
        return None


def read(run):
    t = run.trace
    if t is None:
        return None
    q = queries()
    if not q:
        return None
    nbytes = sum(pair_bytes(a, b) for w in t.work if w
                 for a, b, _ in w["pairs"])
    bound = peaks.bound_s(nbytes, 2.0 * q * DIM, peaks.INT8_OPS)
    return peaks.share(bound, t.device_us(KERNELS) / 1e6)
