"""Phase A's CUDA graphs (utils/graphs) against eager phase A, on a GPU.

Marked `cuda`: each test skips where torch.cuda.is_available() is
false.  No JAX, so on a GPU host they run as

    python -m pytest tests/test_torch_graphs_cuda.py --noconftest -q

Each test gives phase A a `graphs.Graphs` of its own (the eager run one
that never captures), so what earlier tests held does not matter.  Over
four calls with other images each (eager, capture, replay, replay) at
the cells' shapes (16 x 640 x 800, 1 x 768 x 1024, a sparse octave 0 at
1 x 2900 x 2900, and 4 padded images with valid_hw), phase A's flat
fields, next first levels and overflow equal the eager run's bit for
bit; what call 1 returned is unchanged after the later calls; the
launch counters advance per call exactly as eagerly.  Under torch.profiler
a call replays the graphs an untraced call captured (instantiated with
the profiler off), counts k4_steps and sparse_candidates as the eager
call does, and its trace names every K1 / K2 / K3 / K4 launch the eager
trace names; an untraced replay counts nothing.  Capture and replay of
a grouped step of images on the card do not sync the host.  A bound of
one key drops the older key's graphs and frees their memory.  Replays
stay bit-equal after the tables K4 reads leave params.tables' cache,
and a capture holds while another key's graphs fall to the cyclic
garbage collector.
"""

import dataclasses
import gc
import weakref

import pytest
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from hesaff_tpu_torch import batch, detect, dist, params
from hesaff_tpu_torch.config import HesaffConfig
from hesaff_tpu_torch.pyramid import octave_shapes
from hesaff_tpu_torch.utils import graphs, profiling

pytestmark = pytest.mark.cuda
CFG = HesaffConfig()
KERNELS = ("blur_doh_kernel", "detect_walk_kernel", "detect_maps_kernel",
           "affine_kernel")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda", 0)


def card_images(B, H, W, seed, dev):
    """Seeded textures made on the card: uniform noise at three cell
    sizes, upsampled bicubically and summed (blobs at every octave)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    out = torch.zeros((B, 1, H, W), device=dev)
    for cell, amp in ((6, 60.0), (24, 80.0), (96, 60.0)):
        n = torch.rand((B, 1, H // cell + 3, W // cell + 3), generator=g,
                       device=dev)
        out += amp * F.interpolate(n, size=(H, W), mode="bicubic",
                                   align_corners=False)
    return out[:, 0].contiguous()


def eager_only():
    return graphs.Graphs(capturable=lambda device: False)


def graphed():
    return graphs.Graphs(launches=batch.PHASE_A.launches)


def calls(monkeypatch, phase_graphs, inputs, vhw):
    """phase_a of each input through `phase_graphs`: the outputs, the
    launches and the segment counts each call added."""
    monkeypatch.setattr(batch, "PHASE_A", phase_graphs)
    counted = batch.PHASE_A.launches
    outs, launches, segments = [], [], []
    for x in inputs:
        l0 = graphs.read_launches(counted)
        s0 = graphs.segment_counts()
        outs.append(batch.phase_a(x, CFG, vhw))
        launches.append([b - a for a, b in
                         zip(l0, graphs.read_launches(counted))])
        s1 = graphs.segment_counts()
        segments.append({k: s1[k] - s0[k] for k in s1})
    return outs, launches, segments


def flat_tensors(out):
    flat, levels, overflow, ncap = out
    return [*(flat[k] for k in sorted(flat)), *levels, overflow]


def assert_same(a, b):
    ta, tb = flat_tensors(a), flat_tensors(b)
    assert a[3] == b[3] and len(ta) == len(tb)
    for x, y in zip(ta, tb):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)


CASES = {"batch16": ((16, 640, 800), None),
         "query": ((1, 768, 1024), None),
         "sparse": ((1, 2900, 2900), None),
         "padded": ((4, 640, 800),
                    [[640, 800], [600, 700], [512, 640], [480, 777]])}


@pytest.mark.parametrize("case", list(CASES))
def test_graphed_phase_a_equals_eager(dev, monkeypatch, case):
    (B, H, W), vhw = CASES[case]
    if vhw is not None:
        vhw = torch.tensor(vhw, dtype=torch.int32, device=dev)
    inputs = [card_images(B, H, W, seed=100 * i + B, dev=dev)
              for i in range(4)]
    eager, eager_launches, _ = calls(monkeypatch, eager_only(), inputs, vhw)
    got, got_launches, segments = calls(monkeypatch, graphed(),
                                        inputs, vhw)
    first = [t.clone() for t in flat_tensors(got[0])]
    for g, e in zip(got, eager):
        assert_same(g, e)
    for x, y in zip(flat_tensors(got[0]), first):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)
    assert got_launches == eager_launches
    assert int(got[0][0]["ok"].sum()) > 0
    n = 3 * len(got[0][1])
    sparse = int(detect.sparse_octave(H, W))
    assert segments == [
        {"captured": 0, "replayed": 0, "eager": n},
        {"captured": n - sparse, "replayed": 0, "eager": sparse},
        {"captured": 0, "replayed": n - sparse, "eager": sparse},
        {"captured": 0, "replayed": n - sparse, "eager": sparse}]


def traced(x, what):
    """phase_a of x under torch.profiler: each counter's growth and the
    kernel launches by name.  A few small kernels run first, so the
    profiler is recording the device before phase A launches."""
    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            torch.ones(1, device=x.device).add_(1)
        torch.cuda.synchronize()
        batch.phase_a(x, CFG)
        torch.cuda.synchronize()
    after = profiling.counters()
    grown = {k: after[k] - before.get(k, 0) for k in after}
    names = {}
    for e in prof.profiler.kineto_results.events():
        for k in KERNELS:
            if e.device_type() == DeviceType.CUDA and k in e.name():
                names[k] = names.get(k, 0) + 1
    return grown, names, what


@pytest.mark.parametrize("case", ["query", "sparse"])
def test_traced_replay_counts_like_eager(dev, monkeypatch, case):
    (B, H, W), _ = CASES[case]
    x = card_images(B, H, W, seed=7, dev=dev)
    monkeypatch.setattr(batch, "PHASE_A", eager_only())
    eager = traced(x, "eager")
    g = graphed()
    monkeypatch.setattr(batch, "PHASE_A", g)
    for _ in range(2):
        batch.phase_a(x, CFG)               # untraced: eager, capture
    s0 = graphs.segment_counts()
    replays = [traced(x, "replay"), traced(x, "replay")]
    s1 = graphs.segment_counts()
    stages = 3 * len(octave_shapes(H, W, CFG))
    sparse = int(detect.sparse_octave(H, W))
    assert s1["captured"] == s0["captured"]
    assert s1["replayed"] - s0["replayed"] == 2 * (stages - sparse)
    assert len(g.held()) == 1
    # the untraced graphs count nothing
    before = profiling.counters()
    batch.phase_a(x, CFG)
    assert profiling.counters() == before
    for run in replays:
        assert run[0]["k4_steps"] == eager[0]["k4_steps"] > 0
        if case == "sparse":
            assert (run[0]["sparse_candidates"]
                    == eager[0]["sparse_candidates"] > 0)
        assert run[1] == eager[1]
    assert eager[1]["affine_kernel"] == len(octave_shapes(H, W, CFG))


@pytest.mark.parametrize("path", ["dense", "sparse"])
def test_capture_and_replay_do_not_sync(dev, monkeypatch, path):
    if path == "sparse":
        monkeypatch.setattr(detect, "SPARSE_PATH_PIXELS", 1 << 16)
    monkeypatch.setattr(batch, "PHASE_A", graphed())
    B, H, W = 2, 240, 320
    groups = dist.default_group_spec(H, W, CFG, per_image_cap=512, batch=B)
    imgs = [card_images(B, H, W, seed=s, dev=dev) for s in range(3)]
    outs = [dist.extraction_step_grouped(imgs[0], CFG, groups)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for x in imgs[1:]:
            outs.append(dist.extraction_step_grouped(x, CFG, groups))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    monkeypatch.setattr(batch, "PHASE_A", eager_only())
    for x, o in zip(imgs, outs):
        ref = dist.extraction_step_grouped(x, CFG, groups)
        for a, b in zip(o, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def test_lru_bound_frees_the_oldest_key(dev, monkeypatch):
    g = graphs.Graphs(bound=1, launches=batch.PHASE_A.launches)
    monkeypatch.setattr(batch, "PHASE_A", g)
    a = card_images(2, 480, 640, seed=1, dev=dev)
    b = card_images(1, 240, 320, seed=2, dev=dev)
    for _ in range(2):
        batch.phase_a(a, CFG)                # eager, then capture
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    batch.phase_a(b, CFG)                    # a new key: drops a's
    torch.cuda.synchronize()
    assert [k[1][0] for k in g.held()] == [(1, 240, 320)]
    # a's ladder alone held two (2, 5, 480, 640) float32 stacks
    assert torch.cuda.memory_allocated(dev) < held - 2 * 2 * 5 * 480 * 640 * 4
    s0 = graphs.segment_counts()
    batch.phase_a(a, CFG)                    # a's key again: eager
    assert graphs.segment_counts()["eager"] - s0["eager"] == 3 * len(
        octave_shapes(480, 640, CFG))


def test_replay_outlives_the_table_cache(dev, monkeypatch):
    """K4 reads the mask of params.tables, a cache of 16 (configuration,
    device) pairs, by address.  After a capture, 16 other pairs push the
    key's tables out of the cache and tensors of garbage take up freed
    memory of the mask's size: replays still equal eager phase A bit
    for bit, as the key keeps the tables its graphs read."""
    monkeypatch.setattr(batch, "PHASE_A", graphed())
    B, H, W = 1, 480, 640
    xs = [card_images(B, H, W, seed=20 + i, dev=dev) for i in range(4)]
    got = [batch.phase_a(x, CFG) for x in xs[:2]]     # eager, capture
    mask = params.tables(CFG, str(dev))["smm_mask"]
    size = mask.numel()
    del mask
    for i in range(16):
        other = dataclasses.replace(CFG, smm_window_size=CFG.smm_window_size
                                    + 2 * (i + 1))
        params.tables(other, str(dev))
    torch.cuda.synchronize()
    junk = [torch.full((size,), 1e30, device=dev) for _ in range(256)]
    got += [batch.phase_a(x, CFG) for x in xs[2:]]    # replay, replay
    del junk
    monkeypatch.setattr(batch, "PHASE_A", eager_only())
    for g, x in zip(got, xs):
        assert_same(g, batch.phase_a(x, CFG))


def test_capture_outlives_a_collection_of_dropped_graphs(dev):
    """A dropped key that a reference cycle holds (as an exception's
    traceback holds a failed call's) is freed whenever the cyclic
    collector runs.  Here its graphs fall to garbage inside another
    key's capture, with a collection due at every allocation of every
    generation: the capture holds (no collection runs in it), and the
    old graphs are freed after it."""
    x = torch.arange(4.0, device=dev)
    double = lambda t: {"y": t * 2}
    thresholds = gc.get_threshold()
    gc.disable()                    # the old key's objects stay young
    try:
        old = graphs.Graphs()
        for _ in range(2):          # eager, capture
            with old.call("old", dev) as run:
                run.stage("stage", double, x)
        old.cycle = old
        ref = weakref.ref(old)
        held = [old]
        del old, run

        def dropping(t):
            held.clear()            # the old key: garbage in a cycle
            gc.set_threshold(1, 1, 1)
            junk = [[[] for _ in range(8)] for _ in range(200)]
            return {"y": t * 2 + 0 * len(junk)}

        g = graphs.Graphs()
        ys = []
        for i, fn in enumerate((double, dropping, double)):
            if i == 1:
                gc.enable()
            with g.call("new", dev) as run:
                ys.append((run.mode, run.result(run.stage("stage", fn,
                                                          x)["y"])))
    finally:
        gc.set_threshold(*thresholds)
        gc.enable()
    gc.collect()
    assert ref() is None
    assert [m for m, _ in ys] == ["eager", "capture", "replay"]
    for _, y in ys:
        torch.testing.assert_close(y, x * 2, rtol=0, atol=0)
