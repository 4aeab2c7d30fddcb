"""The sequential-matching cell (eth3d_seq_6048x4032.window10) on the
CPU at a small size: end to end, the control, planted faults, and the
counts of the pair stage's rooflines.

The small size is this file's own: 320x240 frames of the rendered orbit
with tiles of 64x48 and f scaled with the width, a window of 3, 256
hypotheses, capacities that drop nothing.
"""

import numpy as np
import pytest

from benchmark import control, harness, peaks
from benchmark import run as bench_run
from test_bench_faults import broken_call
from test_bench_metrics import FakeRun, reader, trace

SEQ = "eth3d_seq_6048x4032.window10"
SEED = 2**31 + 53
SMALL = {"image": {"width": 320, "height": 240},
         "tile": {"width": 64, "height": 48},
         "camera": {"focal_px": 3400.0 * 320 / 6048},
         "hesaff": {"candidate_cap_div": 16, "affine_cap_div": 32},
         "per_image_cap": 4096, "matching": {"window": 3},
         "ransac": {"hypotheses": 256},
         "traffic": {"pool": 6, "tiles": 32, "warmup_calls": 4,
                     "sample_calls": 2, "traced_calls": 2}}


def limits():
    return harness.load_json(harness.HERE / "workloads" /
                             f"{SEQ}.json")["limits"]


def test_cell_end_to_end():
    result, checks = bench_run.execute(SEQ, SEED, 1.0, False, device="cpu",
                                       overrides=SMALL)
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["metrics"]) == {"img_per_s", "call_ms_p95", "setup_s"}
    assert set(result["checks"]) == set(limits())
    assert all(v <= lim for _, v, lim in checks)


def test_sequential_cell_traced():
    result, _ = bench_run.execute(SEQ, SEED, 0.5, True, device="cpu",
                                  overrides=SMALL)
    assert result["correct"] is True and result["most_tentative"] > 0
    # the CPU has no device trace: the span's metric reads, no roofline
    assert set(result["metrics"]) == {"pair_host_ms.window10"}
    assert result["metrics"]["pair_host_ms.window10"]["value"] > 0


def test_control_fails_and_program_passes():
    r = control.readings(SEQ, SEED, None, True, device="cpu",
                         overrides=SMALL)
    lim = limits()
    assert all(r["program"][k] <= v for k, v in lim.items())
    assert any(v > lim[k] for k, v in r["control"].items())


def _pairs(transform):
    def fault(driver, answer):
        return dict(answer, pairs=tuple(transform(p)
                                        for p in answer["pairs"]))
    return fault


def first_pair_left_out(driver, answer):
    return dict(answer, pairs=answer["pairs"][1:])


match_moved = _pairs(lambda p: p._replace(idx_newer=(p.idx_newer + 1)
                                          % max(1, p.idx_newer.max())))
inliers_flipped = _pairs(lambda p: p._replace(
    inliers=p.inliers ^ (np.arange(len(p.inliers)) % 5 == 0)))
model_moved = _pairs(lambda p: p._replace(
    model=p.model + 1e-3 * np.abs(p.model).max()))


def _oldest_pair(transform):
    def fault(driver, answer):
        first, *rest = answer["pairs"]
        return dict(answer, pairs=(transform(first), *rest))
    return fault


# the oldest pair of the window alone broken: a model that keeps none
# of the matches (its epipoles swapped for a pure translation's along
# y), or no inliers left
oldest_model_wrong = _oldest_pair(lambda p: p._replace(
    model=np.array([[0, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32)))
oldest_inliers_dropped = _oldest_pair(lambda p: p._replace(
    inliers=np.zeros_like(p.inliers)))


@pytest.mark.parametrize("hook", [
    first_pair_left_out, match_moved, inliers_flipped, model_moved,
    oldest_model_wrong, oldest_inliers_dropped])
def test_fault_fails(hook):
    result, _ = bench_run.execute(SEQ, SEED, 0.3, False, device="cpu",
                                  overrides=SMALL,
                                  driver_hook=broken_call(hook))
    assert result["correct"] is False


def test_pair_rooflines_count_by_hand(monkeypatch):
    knn = reader("pair_knn2_roofline.window10")
    score = reader("ransac_score_roofline.window10")
    work = [{"pairs": [(1000, 2000, 300), (1500, 2000, 5)],
             "hypotheses": 100}]
    # K7 runs on after its span closes: its own kernels' time counts
    t = trace([("knn2_strips_kernel", 5, 15), ("ransac", 20, 40)],
              spans=[("pair: knn2", 0, 10), ("ransac: score", 20, 40)],
              work=work)
    q = 2 * (1000 * 2000 + 1500 * 2000)
    monkeypatch.setattr(knn, "queries", lambda: q)
    nbytes = 2.0 * 6500 * 128 + 12.0 * 6500
    want = peaks.bound_s(nbytes, 2.0 * q * 128, peaks.INT8_OPS) / 10e-6
    assert knn.read(FakeRun(trace=t)) == pytest.approx(100 * want)
    monkeypatch.setattr(score, "residuals", lambda: 100 * 300)
    want = peaks.bound_s(100 * 40 + 300 * 16, 100 * 300 * 35.0,
                         peaks.F32_OPS) / 20e-6
    assert score.read(FakeRun(trace=t)) == pytest.approx(100 * want)
    monkeypatch.setattr(score, "residuals", lambda: None)
    assert score.read(FakeRun(trace=t)) is None
    host = reader("pair_host_ms.window10")
    assert host.read(FakeRun(trace=t)) == pytest.approx(0.03)
    assert host.read(FakeRun(trace=trace([], spans=[("A: detect", 0, 9)]))
                     ) is None


def test_cells_listed():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    names = lambda w, tr: {m["name"] for m in
                           bench_run.cell_metrics(bench, w, tr)}
    e2e = {"img_per_s", "call_ms_p95", "setup_s"}
    assert names(SEQ, False) == e2e
    assert names(SEQ, True) == {"pair_host_ms.window10",
                                "pair_knn2_roofline.window10",
                                "ransac_score_roofline.window10"}
