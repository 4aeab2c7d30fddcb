"""The ETH3D high-res cell (eth3d_6048x4032.batch2) on the CPU at a
small size, its planted faults, and the counts of its two rooflines.

The small size is this file's own: 2 frames of 256x192 a call, mosaics
of 128x96 tiles, at capacities that drop nothing on them; the octaves of
2^14 px or more take the sparse path in both the program and the
reference, so that the sparse path's spans and counter run.
"""

import pytest

from benchmark import harness, peaks
from benchmark import run as bench_run
from benchmark.reference.hesaff_plain.config import HesaffConfig
from test_bench_metrics import FakeRun, reader, trace

CELL = "eth3d_6048x4032.batch2"
SEED = 2**31 + 41
SMALL = {"image": {"width": 256, "height": 192},
         "tile": {"width": 128, "height": 96},
         "hesaff": {"candidate_cap_div": 16, "affine_cap_div": 32},
         "per_image_cap": 2048,
         "traffic": {"pool": 4, "tiles": 4, "warmup_calls": 1,
                     "sample_calls": 2, "traced_calls": 2}}


@pytest.fixture(autouse=True)
def sparse_at_small_sizes(monkeypatch):
    from benchmark.reference.hesaff_plain import detect as plain_detect
    from hesaff_tpu_torch import detect

    monkeypatch.setattr(detect, "SPARSE_PATH_PIXELS", 1 << 14)
    monkeypatch.setattr(plain_detect, "SPARSE_PATH_PIXELS", 1 << 14)


def test_cell_end_to_end():
    result, checks = bench_run.execute(CELL, SEED, 1.0, False, device="cpu",
                                       overrides=SMALL)
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["metrics"]) == {"img_per_s", "call_ms_p95", "setup_s"}
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert set(result["checks"]) == {"kp_unmatched", "shape_p995", "desc_l1",
                                     "overflow_gap", "overflow"}
    assert all(v <= lim for _, v, lim in checks)


def test_cell_traced():
    result, _ = bench_run.execute(CELL, SEED, 0.5, True, device="cpu",
                                  overrides=SMALL)
    assert result["correct"] is True
    # the CPU has no device trace: the span's metric reads, no roofline
    assert set(result["metrics"]) == {"sparse_walk_host_ms.batch2"}
    assert result["metrics"]["sparse_walk_host_ms.batch2"]["value"] > 0


def table_cut_back(driver):
    """The program's table cut back below the largest workspace the
    call has (the parent's table at 6048x4032 stops at 1,025): the
    program counts the keypoints above it as overflow."""
    driver.groups = driver.groups[:-2]


def capacities_shrunk(driver):
    driver.groups = tuple((b, max(8, c // 256)) for b, c in driver.groups)


@pytest.mark.parametrize("hook", [table_cut_back, capacities_shrunk])
def test_fault_fails(hook):
    result, checks = bench_run.execute(CELL, SEED, 0.5, False, device="cpu",
                                       overrides=SMALL, driver_hook=hook)
    assert result["failed"] == 0 and result["correct"] is False
    assert "overflow" in {k for k, v, lim in checks if v > lim}


def test_k3_count_by_hand():
    """2 images of 2048x4096: octave 0 (2^23 px) takes the sparse path,
    octave 1 (2^21 px) does not."""
    cfg = HesaffConfig()
    k3 = reader("k3_roofline.batch2")
    nbytes, ops = k3.call_work(2, 2048, 4096, cfg)
    assert nbytes == 2 * 2**23 * 3 * (12 + 16 + 3)
    assert ops == 2 * 2**23 * 3 * 30
    assert k3.call_work(2, 2047, 4096, cfg) == (0.0, 0.0)
    bound = nbytes / peaks.HBM_BYTES
    t = trace([("detect_maps_kernel(float const*)", 0, 2 * 1e6 * bound)],
              work=[{"batch": 2, "height": 2048, "width": 4096}])
    assert k3.read(FakeRun(trace=t)) == pytest.approx(50.0)


def test_sparse_walk_count_by_hand(monkeypatch):
    """1,000 candidates, each a 9 x 11 window of 22 bytes a pixel, over
    the device's busy time inside the "sparse: walk" spans."""
    walk = reader("sparse_walk_roofline.batch2")
    cfg = HesaffConfig()
    assert walk.walk_bytes(1000, cfg) == 1000 * 9 * 11 * 22
    monkeypatch.setattr(walk, "candidates_walked", lambda: 1000)
    bound_us = 1e6 * 1000 * 9 * 11 * 22 / peaks.HBM_BYTES
    t = trace([("k", 0, 2 * bound_us), ("k", 10_000, 10_001)],
              spans=[("sparse: walk", 0, 5_000), ("A: detect", 0, 20_000)])
    assert walk.read(FakeRun(trace=t)) == pytest.approx(50.0)
    monkeypatch.setattr(walk, "candidates_walked", lambda: None)
    assert walk.read(FakeRun(trace=t)) is None
    host = reader("sparse_walk_host_ms.batch2")
    assert host.read(FakeRun(trace=t)) == pytest.approx(5.0)
    assert host.read(FakeRun(trace=trace([], spans=[("A: detect", 0, 9)]))
                     ) is None


def test_cell_listed():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    want = {"img_per_s", "call_ms_p95", "setup_s"}
    assert {m["name"] for m in bench_run.cell_metrics(bench, CELL, False)
            } == want
    assert {m["name"] for m in bench_run.cell_metrics(bench, CELL, True)} == {
        "k3_roofline.batch2", "sparse_walk_host_ms.batch2",
        "sparse_walk_roofline.batch2"}
