"""The readers of the program's inner spans and K4 step counter, on
synthetic traces: what each reads, and that each reads nothing where
its spans (or the counter) are absent, as on a program without them."""

import pytest

from benchmark import features, harness, peaks

METRICS = harness.HERE / "metrics"
BATCH_READERS = ("ladder_host_ms.batch16", "detect_host_ms.batch16",
                 "affine_host_ms.batch16", "sync_wait_ms.batch16",
                 "syncs_per_call.batch16")


def reader(name):
    return harness.load_module(METRICS / f"{name}.py",
                               "m_" + name.replace(".", "_"))


class FakeRun:
    def __init__(self, trace, config=None):
        self.trace, self.config = trace, config or {}
        self.calls, self.window_s, self.setup_s = [], 1.0, 0.0


def trace(spans, device=(), calls=2):
    return harness.Trace(calls=calls, wall_s=1.0, device=list(device),
                         spans=list(spans), work=[{}] * calls)


def cfg800():
    return harness.load_json(harness.HERE / "configs" /
                             "oxford_affine_800x640.json")


def test_phase_a_stage_and_sync_readers():
    spans = [("phase A", 0, 10_000),
             ("A: ladder", 0, 1_000), ("A: detect", 1_000, 4_000),
             ("sync: compact", 2_000, 2_500), ("sync: compact", 3_000, 3_100),
             ("A: affine", 4_000, 6_000),
             ("A: ladder", 6_000, 6_500), ("A: detect", 6_500, 8_000),
             ("sync: compact", 7_000, 7_400), ("A: affine", 8_000, 10_000),
             ("group 49: select", 10_000, 12_000),
             ("sync: compact", 10_500, 11_000),
             ("sync: input", 20_000, 21_000)]
    run = FakeRun(trace(spans, calls=2))
    got = {n: reader(n).read(run) for n in BATCH_READERS}
    assert got == pytest.approx({
        "ladder_host_ms.batch16": 0.75, "detect_host_ms.batch16": 2.25,
        "affine_host_ms.batch16": 2.0, "sync_wait_ms.batch16": 1.25,
        "syncs_per_call.batch16": 2.5})
    # the existing phase-A reader still reads only the "phase A" span
    assert reader("phase_a_host_ms.batch16").read(run) == pytest.approx(5.0)
    # and phase B's only the group and SIFT spans
    assert reader("phase_b_host_ms.batch16").read(run) == pytest.approx(1.0)


@pytest.mark.parametrize("name", BATCH_READERS + ("knn2_idle_share.query",))
def test_readers_find_nothing_without_their_spans(name):
    old = [("phase A", 0, 5_000), ("group 49: select", 5_000, 6_000),
           ("SIFT", 6_000, 7_000), ("bench: knn2", 7_000, 9_000)]
    dev = [("k", 100, 200)]
    assert reader(name).read(FakeRun(trace(old, dev))) is None
    assert reader(name).read(FakeRun(None)) is None


def test_knn2_idle_share_inside_the_block_spans():
    m = reader("knn2_idle_share.query")
    spans = [("bench: knn2", 0, 30_000), ("knn2: widen", 0, 1_000),
             ("knn2: blocks", 1_000, 11_000),
             ("knn2: blocks", 20_000, 30_000)]
    dev = [("widen", 0, 1_000), ("gemm", 2_000, 5_000),
           ("argmin", 4_000, 6_000), ("gemm", 25_000, 26_000)]
    # busy 4,000 + 1,000 of 20,000 us of spans
    got = m.read(FakeRun(trace(spans, dev)))
    assert got == pytest.approx(75.0)
    # no device events (a CPU run): nothing to read
    assert m.read(FakeRun(trace(spans))) is None


def test_k4_roofline_from_the_program_counter(monkeypatch):
    m = reader("k4_roofline.batch16")
    G = features.reference_config(cfg800()).smm_window_size
    t = trace([], [("void affine_kernel<19>(...)", 0, 400),
                   ("void affine_kernel<19>(...)", 1_000, 1_100),
                   ("other", 0, 5_000)])
    monkeypatch.setattr(m, "steps_run", lambda: 500_000)
    want = 100 * 500_000 * G * G * 40 / peaks.F32_OPS / 500e-6
    assert m.read(FakeRun(t, cfg800())) == pytest.approx(want)
    assert 0 < want < 100
    # no counter (a program without it), or no K4 in the trace
    monkeypatch.setattr(m, "steps_run", lambda: None)
    assert m.read(FakeRun(t, cfg800())) is None
    monkeypatch.setattr(m, "steps_run", lambda: 500_000)
    assert m.read(FakeRun(trace([], [("other", 0, 5)]), cfg800())) is None
    assert m.read(FakeRun(None, cfg800())) is None


def test_k4_steps_read_from_the_program(monkeypatch):
    from hesaff_tpu_torch.utils import profiling

    m = reader("k4_roofline.batch16")
    monkeypatch.setattr(profiling, "counters", lambda: {"k4_steps": 7})
    assert m.steps_run() == 7
    monkeypatch.setattr(profiling, "counters", lambda: {})
    assert m.steps_run() is None
    # a program whose profiling module has no counters
    monkeypatch.delattr(profiling, "counters")
    assert m.steps_run() is None


def test_new_metrics_are_declared_for_their_cells():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    per = {m["name"]: m for m in bench["per_layer"]}
    for name in BATCH_READERS + ("k4_roofline.batch16",):
        assert per[name]["workloads"] == ["oxford_affine_800x640.batch16"]
        assert per[name]["moves"] == "img_per_s"
    assert per["knn2_idle_share.query"]["workloads"] == [
        "oxford5k_1024x768.query"]
    assert per["knn2_idle_share.query"]["moves"] == "query_ms_p50"
