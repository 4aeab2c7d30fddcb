"""Phase A's graph policy (utils/graphs), on the CPU.

Plain Python with a stand-in for the CUDA graph: capture runs the stage
once; replay runs it again on the captured inputs and writes the result
into the captured outputs (undoing the launch counts the Python adds,
as a CUDA graph adds none), so a replayed output is right only if the
call's inputs were copied into the graph's buffers.  A key's first call
runs eager, its second captures, later ones replay; the key holds
whether valid_hw is given, not tracing(): traced calls replay the same
graphs and add what the graph counted to k4_steps, untraced ones add
nothing; the least recently used key is dropped; threads that share
keys each get their own results; a key keeps what its capturing call
named in `holds` while it keeps its graphs.  Phase A through the
stand-in equals eager phase A bit for bit (dense octaves, a sparse
octave run eager between two graphs, padded sizes), and what a call
returned stays as it was after later calls.
On a CPU tensor phase A never captures.  No JAX: small shapes only.
"""

import contextlib
import gc
import os
import sys
import threading
import time
import weakref

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._pytree import tree_flatten

import _torch_parity  # noqa: F401  (two torch threads a worker)
from hesaff_tpu_torch import batch, detect
from hesaff_tpu_torch.config import HesaffConfig
from hesaff_tpu_torch.ops import cuda_blur
from hesaff_tpu_torch.pyramid import octave_shapes
from hesaff_tpu_torch.utils import graphs, profiling

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "golden"))
import gen_images  # noqa: E402

CFG = HesaffConfig()


class RerunGraph:
    """A CUDA graph's stand-in on the CPU."""

    captures = 0
    replays = 0

    def __init__(self, pool, device):
        self.fn = self.args = self.out = None

    def capture(self, fn, *args):
        RerunGraph.captures += 1
        self.fn, self.args = fn, args
        self.out = fn(*args)
        return self.out

    def replay(self):
        RerunGraph.replays += 1
        counted = batch.PHASE_A.launches
        before = graphs.read_launches(counted)
        new = self.fn(*self.args)
        graphs.add_launches(counted, [b - a for a, b in zip(
            graphs.read_launches(counted), before)])
        for o, n in zip(tree_flatten(self.out)[0], tree_flatten(new)[0]):
            o.copy_(n)


def stand_in(bound=graphs.LRU_KEYS):
    return graphs.Graphs(bound, launches=batch.PHASE_A.launches,
                         new_graph=RerunGraph,
                         new_pool=lambda device: None,
                         capturable=lambda device: True)


def double(x):
    """A stage that counts one K1 launch (and lets other threads run)."""
    cuda_blur.LAUNCHES += 1
    time.sleep(0)
    return {"y": x * 2}


def run_call(g, key, x):
    with g.call(key, "cpu") as run:
        y = run.stage("stage", double, x)["y"]
        return run.mode, run.result(y)


@pytest.fixture
def counters(monkeypatch):
    for name in ("SEGMENTS_CAPTURED", "SEGMENTS_REPLAYED", "SEGMENTS_EAGER"):
        monkeypatch.setattr(graphs, name, 0)
    monkeypatch.setattr(cuda_blur, "LAUNCHES", 0)
    monkeypatch.setattr(RerunGraph, "captures", 0)
    monkeypatch.setattr(RerunGraph, "replays", 0)


def test_first_call_eager_then_capture_then_replay(counters):
    g = stand_in()
    modes, launches = [], []
    for i in range(4):
        x = torch.arange(3.0) + i
        mode, y = run_call(g, "k", x)
        modes.append(mode)
        launches.append(cuda_blur.LAUNCHES)
        assert torch.equal(y, x * 2)
    assert modes == ["eager", "capture", "replay", "replay"]
    # the launches count per call, replayed or not
    assert launches == [1, 2, 3, 4]
    assert graphs.segment_counts() == {"captured": 1, "replayed": 2,
                                       "eager": 1}
    assert (RerunGraph.captures, RerunGraph.replays) == (1, 3)


def test_result_outlives_later_replays(counters):
    g = stand_in()
    outs = [run_call(g, "k", torch.full((4,), float(i)))[1]
            for i in range(4)]
    for i, y in enumerate(outs):
        assert torch.equal(y, torch.full((4,), 2.0 * i))


def steps(x):
    """A stage that counts k4_steps as K4 does (x.numel() steps)."""
    count = profiling.counted("k4_steps", x.device)
    if count is not None:
        count.add_(x.numel())
    return {"y": x + 1}


def test_traced_calls_replay_and_count(counters):
    """tracing() is no part of the key: traced and untraced calls replay
    the same graphs, and k4_steps grows in traced calls only, by what
    each call ran."""
    g = stand_in()
    total = lambda: profiling.counters().get("k4_steps", 0)
    grown = []
    for traced in (False, True, False, True, True, False):
        before = total()
        prof = (profile(activities=[ProfilerActivity.CPU]) if traced
                else contextlib.nullcontext())
        with prof, g.call("k", "cpu") as run:
            y = run.result(run.stage("stage", steps, torch.ones(5))["y"])
            mode = run.mode
        assert torch.equal(y, torch.full((5,), 2.0))
        grown.append((mode, traced, total() - before))
    assert grown == [("eager", False, 0), ("capture", True, 5),
                     ("replay", False, 0), ("replay", True, 5),
                     ("replay", True, 5), ("replay", False, 0)]
    assert len(g.held()) == 1


def test_lru_drops_the_oldest_key(counters):
    g = stand_in(bound=2)
    for key in ("a", "a", "b", "b"):
        run_call(g, key, torch.ones(2))
    assert [k[1] for k in g.held()] == ["a", "b"]
    assert run_call(g, "a", torch.ones(2))[0] == "replay"   # a is newest
    run_call(g, "c", torch.ones(2))
    assert [k[1] for k in g.held()] == ["a", "c"]
    assert run_call(g, "b", torch.ones(2))[0] == "eager"    # b was dropped


def test_a_capture_keeps_what_its_graphs_read(counters):
    """What a call names in `holds` (a table its graphs read by address)
    lives while its key keeps the graphs captured with it: an eager call
    keeps nothing, a capturing call keeps it until the key is dropped."""
    def holding(g, table):
        with g.call("k", "cpu", holds=table) as run:
            run.stage("stage", double, torch.ones(2))
            return run.mode

    g = stand_in(bound=1)
    tables = [torch.ones(3), torch.ones(3)]
    refs = [weakref.ref(t) for t in tables]
    assert [holding(g, tables.pop(0)) for _ in range(2)] == ["eager",
                                                            "capture"]
    gc.collect()
    assert refs[0]() is None and refs[1]() is not None
    assert run_call(g, "k", torch.ones(2))[0] == "replay"
    assert refs[1]() is not None
    run_call(g, "other", torch.ones(2))           # drops "k"
    gc.collect()
    assert refs[1]() is None


def test_no_collection_while_capturing(counters):
    """The cyclic garbage collector is off while a stage is captured
    (a collection could destroy another key's graphs mid-capture), on
    again after, and left off where it was off."""
    seen = []

    def stage(x):
        seen.append(gc.isenabled())
        return {"y": x * 2}

    g = stand_in()
    assert gc.isenabled()
    for _ in range(3):
        with g.call("k", "cpu") as run:
            run.stage("stage", stage, torch.ones(2))
    # eager; captured, then replayed at once; replayed
    assert seen == [True, False, True, True] and gc.isenabled()
    gc.disable()
    try:
        for _ in range(2):
            with g.call("off", "cpu") as run:
                run.stage("stage", stage, torch.ones(2))
        assert not gc.isenabled()
    finally:
        gc.enable()


def test_failed_capture_keeps_no_segment(counters):
    g = stand_in()
    run_call(g, "k", torch.ones(2))

    def broken(x):
        raise RuntimeError("stage failed")

    with pytest.raises(RuntimeError, match="stage failed"):
        with g.call("k", "cpu") as run:
            run.stage("stage", double, torch.ones(2))
            run.stage("stage", broken, torch.ones(2))
    assert run_call(g, "k", torch.ones(2))[0] == "capture"
    assert run_call(g, "k", torch.ones(2))[0] == "replay"


def test_threads_share_the_keys(counters):
    """Eight threads call three keys through a bound of two (keys are
    dropped and taken again) with the interpreter switching threads every
    microsecond: every call returns its own input doubled."""
    g = stand_in(bound=2)
    wrong, done = [], []

    def worker(t):
        for i in range(40):
            x = torch.full((64,), float(1000 * t + i))
            _, y = run_call(g, "abc"[(t + i) % 3], x)
            if not torch.equal(y, x * 2):
                wrong.append((t, i))
        done.append(t)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(th.is_alive() for th in threads)
    assert sorted(done) == list(range(8)) and not wrong
    assert len(g.held()) == 2


def test_cpu_phase_a_never_captures(counters):
    imgs = torch.as_tensor(images(2, 48, 56, seed=0))
    for _ in range(3):
        batch.detect_affine_batch(imgs, CFG)
    assert graphs.SEGMENTS_CAPTURED == 0 and graphs.SEGMENTS_REPLAYED == 0
    assert graphs.SEGMENTS_EAGER > 0
    assert not any(k[0].type == "cpu" for k in batch.PHASE_A.held())


def test_phase_a_key_holds_valid_hw(counters, monkeypatch):
    g = stand_in()
    monkeypatch.setattr(batch, "PHASE_A", g)
    imgs = torch.as_tensor(images(1, 48, 56, seed=0))
    for vhw in (None, None, [[48, 50]]):
        batch.detect_affine_batch(imgs, CFG, vhw)
    assert [k[1][3] for k in g.held()] == [False, True]
    # three stages an octave: eager, captured, then eager again
    n = 3 * len(octave_shapes(48, 56, CFG))
    assert graphs.segment_counts() == {"captured": n, "replayed": 0,
                                       "eager": 2 * n}


def test_phase_a_key_holds_the_sparse_octaves(counters, monkeypatch):
    """Which octaves run their detection eager between graphs is part
    of the key: a shape seen with a dense octave 0 and then with a
    sparse one (SPARSE_PATH_PIXELS lowered) is two keys, each captured
    with its own stages."""
    monkeypatch.setattr(batch, "PHASE_A", stand_in())
    imgs = torch.as_tensor(images(1, 72, 88, seed=0))
    for sparse_from in (1 << 23, 72 * 88):
        monkeypatch.setattr(detect, "SPARSE_PATH_PIXELS", sparse_from)
        eager = batch.detect_affine_batch(imgs, CFG)
        for _ in range(2):                  # capture, replay
            assert_equal_fields(batch.detect_affine_batch(imgs, CFG), eager)
    n = len(octave_shapes(72, 88, CFG))
    assert [k[1][4] for k in batch.PHASE_A.held()] == [
        (False,) * n, (True,) + (False,) * (n - 1)]
    assert graphs.SEGMENTS_CAPTURED == 3 * n + 3 * n - 1


def images(B, H, W, seed):
    return np.stack([gen_images.synth_image(W, H, seed=seed + b)
                     .astype(np.float32).mean(-1) for b in range(B)])


def assert_equal_fields(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if k == "next_firsts":
            assert len(a[k]) == len(b[k])
            for x, y in zip(a[k], b[k]):
                assert torch.equal(x, y)
        else:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("case", ["dense", "sparse", "valid_hw"])
def test_phase_a_through_stand_in_equals_eager(counters, monkeypatch, case):
    B, H, W = 2, 72, 88
    vhw = None
    if case == "sparse":
        # octave 0 (72 x 88) takes the sparse path, eager between graphs
        monkeypatch.setattr(detect, "SPARSE_PATH_PIXELS", 72 * 88)
    if case == "valid_hw":
        vhw = np.array([[72, 88], [60, 70]], np.int32)
    inputs = [torch.as_tensor(images(B, H, W, seed=10 * i))
              for i in range(3)]
    eager = [batch.detect_affine_batch(x, CFG, vhw) for x in inputs]
    monkeypatch.setattr(batch, "PHASE_A", stand_in())
    got = [batch.detect_affine_batch(x, CFG, vhw) for x in inputs]
    snapshot = {k: (v.clone() if k != "next_firsts"
                    else [t.clone() for t in v]) for k, v in got[0].items()}
    for g, e in zip(got, eager):
        assert_equal_fields(g, e)
    assert_equal_fields(got[0], snapshot)
    n_oct = len(eager[0]["next_firsts"])
    graphed = 3 * n_oct - (case == "sparse")
    assert graphs.SEGMENTS_CAPTURED == graphed
    assert graphs.SEGMENTS_REPLAYED == graphed
    assert RerunGraph.replays == 2 * graphed
