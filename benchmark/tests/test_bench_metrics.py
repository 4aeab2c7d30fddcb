"""The metric arithmetic: intervals, quantiles, rooflines from shapes,
and which metrics a cell reports."""

import numpy as np
import pytest

from benchmark import features, harness, peaks
from benchmark import run as bench_run
from benchmark.reference.hesaff_plain import dist as plain_dist
from benchmark.reference.hesaff_plain.ops import masks
from benchmark.reference.hesaff_plain.patches import _max_ksize_for_bucket

METRICS = harness.HERE / "metrics"


def reader(name):
    return harness.load_module(METRICS / f"{name}.py",
                               "m_" + name.replace(".", "_"))


def trace(device, spans=(), wall_s=1.0, work=({},), calls=1):
    return harness.Trace(calls=calls, wall_s=wall_s, device=list(device),
                         spans=list(spans), work=list(work))


class FakeRun:
    def __init__(self, calls=(), window_s=1.0, setup_s=0.0, trace=None,
                 config=None):
        self.calls, self.window_s, self.setup_s = list(calls), window_s, setup_s
        self.trace, self.config = trace, config or {}


def test_union_of_overlapping_intervals():
    assert harness.union_us([(0, 10), (5, 15), (20, 30), (25, 26)]) == 25
    assert harness.union_us([]) == 0
    assert harness.union_us([(3, 3), (4, 2)]) == 0


def test_idle_share_and_busy_in_a_span():
    t = trace([("k", 0, 100_000), ("c", 50_000, 250_000),
               ("k", 600_000, 700_000)],
              spans=[("s", 400_000, 800_000)], wall_s=1.0)
    assert t.busy_us() == 350_000
    assert t.busy_in_spans_us("s") == 100_000
    share = reader("idle_share.batch16").read(FakeRun(trace=t))
    assert share == pytest.approx(65.0)
    # a gap is labelled by the innermost span open at its midpoint
    gaps = dict(harness.idle_gaps(t))
    assert gaps == {"s": pytest.approx(0.35)}


def test_tail_and_median_over_every_call():
    calls = [harness.Call(0.0, d / 1e3, 16) for d in range(1, 101)]
    run = FakeRun(calls, window_s=2.0)
    assert reader("call_ms_p95").read(run) == pytest.approx(
        np.percentile(np.arange(1, 101), 95))
    assert reader("query_ms_p50").read(run) == pytest.approx(50.5)
    assert reader("img_per_s").read(run) == pytest.approx(800.0)


def test_reservoir_is_seeded_and_uniform_in_size():
    a, b = harness.Reservoir(3, 5), harness.Reservoir(3, 5)
    for i in range(100):
        a.offer(i)
        b.offer(i)
    assert a.items == b.items and len(a.items) == 3


def cfg800():
    cfg = harness.load_json(harness.HERE / "configs" /
                            "oxford_affine_800x640.json")
    return cfg, features.reference_config(cfg)


def test_k1_work_from_shapes():
    _, cfg = cfg800()
    m = reader("k1_roofline.batch16")
    # 6 octaves of 640x800 halving; 1 initial blur + 5 levels an octave
    px = sum(16 * (640 >> o) * (800 >> o) for o in range(6))
    nbytes = 2 * 4 * 16 * 640 * 800 + 5 * 3 * 4 * px
    assert m.call_bound_s(16, 640, 800, cfg) == pytest.approx(
        nbytes / peaks.HBM_BYTES)


def test_k2_work_from_shapes():
    _, cfg = cfg800()
    px = sum(16 * (640 >> o) * (800 >> o) for o in range(6))
    assert reader("k2_roofline.batch16").call_bound_s(
        16, 640, 800, cfg) == pytest.approx(110 * px / peaks.HBM_BYTES)


def test_k5_and_k6_work_from_shapes():
    """Counted from the described keypoints and the configuration's own
    group table, never from the program's slots."""
    raw, cfg = cfg800()
    groups = plain_dist.default_group_spec(640, 800, cfg, 1024, 16)
    w = {"batch": 16, "height": 640, "width": 800,
         "s": np.full(100, 2.0), "described": 100}
    # s = 2: S = 2 ceil(2 * 5.196) + 1 = 23, ws 25: group 49
    P = 41
    kmax = {b: _max_ksize_for_bucket(b, P, 1.5) for b, _ in groups}
    its = 23 / P
    ksz = int(6 * 1.5 * its + 1)
    ksz += 1 - ksz % 2
    band = min(min(ksz, kmax[49]) + 1, 25)
    ops = 100 * (10 * 25 ** 2 + 2 * P * 25 * band + 2 * P * P * band)
    # no keypoint in a tail group: no pyramid level is read
    nbytes = 4 * 16 * 640 * 800 + 100 * (32 + 4 * kmax[49] + 2 + 4 * P * P)
    got = reader("k5_roofline.batch16").call_bound_s(w, cfg, 1024)
    assert got == pytest.approx(max(nbytes / peaks.HBM_BYTES,
                                    ops / peaks.F32_OPS))
    # a keypoint of the 641 group adds its own bytes and its level's
    w2 = dict(w, s=np.append(w["s"], 50.0), described=101)
    ps, octave, src = plain_dist.tail_source_plan(641, 1.0)
    lvl = 16 * (640 >> octave) * (800 >> octave) * 4
    extra = 32 + 4 * _max_ksize_for_bucket(src, P, 1.5) + 2 + 4 * P * P
    got2 = reader("k5_roofline.batch16").call_bound_s(w2, cfg, 1024)
    assert got2 >= (nbytes + lvl + extra) / peaks.HBM_BYTES * (1 - 1e-9)
    # the bound does not follow the program's capacities
    assert got == reader("k5_roofline.batch16").call_bound_s(w, cfg, 4096)
    nz = (masks.sift_spatial_bins(P, 4) != 0).sum(axis=1)
    support = masks.circular_gauss_mask(P) > 0
    ops6 = 100 * (30 * P * P + 4 * int((support * nz[:, None]).sum())
                  + 2 * 4 * 8 * int(nz.sum()))
    nbytes6 = 100 * (P * P * 4 + 1 + 128)
    assert reader("k6_roofline.batch16").call_bound_s(w, cfg) == \
        pytest.approx(max(nbytes6 / peaks.HBM_BYTES, ops6 / peaks.F32_OPS))


def test_knn2_bound_is_int8_operations():
    m = reader("knn2_roofline.query")
    w = {"query_rows": 2600, "index_rows": 16_334_970, "dim": 128}
    assert m.call_bound_s(w) == pytest.approx(
        2 * 2600 * 16_334_970 * 128 / peaks.INT8_OPS)
    t = trace([("gemm", 0, 5_000), ("x", 9_000_000, 9_100_000)],
              spans=[("bench: knn2", 0, 10_000)], work=[w])
    assert m.read(FakeRun(trace=t)) == pytest.approx(
        100 * m.call_bound_s(w) / 5e-3)


def test_roofline_readers_find_nothing_without_their_kernels():
    raw, _ = cfg800()
    t = trace([("other", 0, 10)], work=[{
        "batch": 1, "height": 64, "width": 64,
        "s": np.zeros(0), "described": 0}])
    for name in ("k1_roofline.batch16", "k2_roofline.batch16",
                 "k5_roofline.batch16", "k6_roofline.batch16"):
        assert reader(name).read(FakeRun(trace=t, config=raw)) is None
    assert reader("phase_a_host_ms.batch16").read(FakeRun(trace=t)) is None


def test_cell_metrics_follow_benchmark_json():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    names = lambda w, tr: {m["name"] for m in
                           bench_run.cell_metrics(bench, w, tr)}
    assert names("oxford_affine_800x640.batch16", False) == {
        "img_per_s", "call_ms_p95", "setup_s"}
    assert names("oxford5k_1024x768.query", False) == {
        "query_ms_p50", "setup_s"}
    assert "knn2_roofline.query" in names("oxford5k_1024x768.query", True)
    assert "k1_roofline.batch16" not in names("oxford5k_1024x768.query",
                                              True)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (METRICS / f"{m['name']}.py").exists(), m["name"]
