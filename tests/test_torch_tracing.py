"""The port's profiler spans and counters, on the CPU.

One grouped step of the 200x160 golden under torch.profiler opens
"input copy" (holding "sync: input": the images come from the host,
the step's one wait on the device), "phase A" with one "A: ladder" /
"A: detect" / "A: affine" an octave inside it, the group spans,
"assemble" and "SIFT"; no compaction, sigma or corner offset waits on
the device (trace_to's written trace names none); knn2 and query_votes
open "knn2: widen", one "knn2: blocks", "votes" and one "sync: votes" a
host copy.  No new name starts with a prefix that the benchmark's
readers match ("phase A", "group ", "SIFT", "bench:").  Off the
profiler span() is a shared null context and no record_function is
made.  The K4 step counter equals the plain loop's steps on phase A's
real keypoints, and stays at zero off the profiler.
"""

import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import _torch_parity  # noqa: F401  (two torch threads a worker)
from hesaff_tpu_torch import dist, retrieval
from hesaff_tpu_torch.config import HesaffConfig
from hesaff_tpu_torch.match import knn2
from hesaff_tpu_torch.utils import profiling

CFG = HesaffConfig()
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "data", "synth_200x160.npz")
# the names the grouped path had before its inner spans; the benchmark's
# readers match these by prefix
READ_PREFIXES = ("phase A", "group ", "SIFT", "bench:")


def spans(prof):
    """(name, start_ns, end_ns) of every user span of a finished
    profile, in start order."""
    out = [(e.name(), e.start_ns(), e.end_ns())
           for e in prof.profiler.kineto_results.events()
           if e.is_user_annotation()]
    return sorted(out, key=lambda s: s[1])


def inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, spans(prof)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)["gray"][None].astype(np.float32)


@pytest.fixture(scope="module")
def grouped(golden):
    B, H, W = golden.shape
    groups = dist.default_group_spec(H, W, CFG, 512, B)
    step = lambda: dist.extraction_step_grouped(golden, CFG, groups,
                                                device="cpu")
    plain = step()
    out, sp = traced(step)
    return plain, out, sp, groups


def test_grouped_step_spans(grouped):
    plain, out, sp, groups = grouped
    names = [n for n, _, _ in sp]
    (phase_a,) = [s for s in sp if s[0] == "phase A"]
    (copy,) = [s for s in sp if s[0] == "input copy"]
    assert copy[2] <= phase_a[1]
    stages = {k: [s for s in sp if s[0] == k]
              for k in ("A: ladder", "A: detect", "A: affine")}
    n_oct = len(stages["A: ladder"])
    assert n_oct >= 2 and all(len(v) == n_oct for v in stages.values())
    assert all(inside(s, phase_a) for v in stages.values() for s in v)
    # octave by octave: ladder, detect, affine
    for o in range(n_oct):
        lad, det, aff = (stages[k][o] for k in stages)
        assert lad[2] <= det[1] and det[2] <= aff[1]
    for bsize, _ in groups:
        assert names.count(f"group {bsize}: select") == 1
        assert f"group {bsize}: patches" in names
    (sift,) = [s for s in sp if s[0] == "SIFT"]
    assembles = [s for s in sp if s[0] == "assemble"]
    assert assembles and not any(inside(sift, a) for a in assembles)
    before = {"phase A", "SIFT"} | {f"group {b}: {k}" for b, _ in groups
                                      for k in ("select", "patches")}
    new = set(names) - before
    # the compactions, the sigmas and the corner offsets stay on the
    # device: the input copy is the one sync
    assert new == {"input copy", "sync: input", "assemble", *stages}
    (sync_in,) = [s for s in sp if s[0] == "sync: input"]
    assert inside(sync_in, copy)
    assert not any(n.startswith(READ_PREFIXES) for n in new)
    # the spans change nothing
    for a, b in zip(plain, out):
        assert torch.equal(a, b)


def test_tracing_flag_and_null_span(golden, monkeypatch):
    assert not profiling.tracing()
    assert profiling.span("a") is profiling.span("b")
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.tracing()
        s = profiling.span("A: ladder")
        assert isinstance(s, torch.autograd.profiler.record_function)
    assert not profiling.tracing()

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) off the profiler")

    monkeypatch.setattr(profiling, "record_function", refuse)
    B, H, W = golden.shape
    dist.extraction_step_grouped(golden, CFG,
                                 dist.default_group_spec(H, W, CFG, 512, B),
                                 device="cpu")


def test_grouped_step_no_device_waits(golden, tmp_path):
    """A grouped step under trace_to: its written trace holds the input
    copy's sync span and none of compaction, sigmas or corners."""
    import json

    B, H, W = golden.shape
    groups = dist.default_group_spec(H, W, CFG, 512, B)
    with profiling.trace_to(str(tmp_path)):
        dist.extraction_step_grouped(golden, CFG, groups, device="cpu")
    (path,) = tmp_path.iterdir()
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    assert {"phase A", "sync: input"} <= names
    assert not names & {"sync: compact", "sync: sigmas", "sync: corners"}
    assert [n for n in names if str(n).startswith("sync: ")] == [
        "sync: input"]


def test_knn2_and_votes_spans():
    rng = np.random.default_rng(3)
    db = rng.integers(0, 256, (9000, 128)).astype(np.uint8)
    q = torch.as_tensor(db[:50])
    index = retrieval.DescriptorIndex(torch.as_tensor(db),
                                      np.arange(9000, dtype=np.int32) // 100,
                                      n_images=90)
    plain = retrieval.query_votes(index, q, 0.9, device="cpu")
    (votes, matches), sp = traced(
        lambda: retrieval.query_votes(index, q, 0.9, device="cpu"))
    assert np.array_equal(votes, plain[0])
    assert np.array_equal(matches, plain[1])
    names = [n for n, _, _ in sp]
    assert names.count("knn2: widen") == 1
    assert names.count("knn2: blocks") == 1      # one span, three blocks
    (v,) = [s for s in sp if s[0] == "votes"]
    syncs = [s for s in sp if s[0] == "sync: votes"]
    assert len(syncs) == 3 and all(inside(s, v) for s in syncs)
    (blocks,) = [s for s in sp if s[0] == "knn2: blocks"]
    assert blocks[2] <= v[1]
    _, sp = traced(lambda: knn2(q, db, device="cpu"))
    assert [n for n, _, _ in sp] == ["knn2: widen", "knn2: blocks"]


def test_k4_steps_counter(golden):
    """k4_steps over phase A's octaves equals the plain loop's steps on
    the same keypoints, and the results do not change with tracing."""
    from hesaff_tpu_torch import detect, pyramid
    from hesaff_tpu_torch.affine_shape import adapt_args
    from hesaff_tpu_torch.batch import detect_affine_batch, octave_affine_inputs
    from hesaff_tpu_torch.ops import cuda_affine

    img = torch.as_tensor(golden)
    steps = lambda: profiling.counters().get("k4_steps", 0)
    before = steps()
    plain = detect_affine_batch(img, CFG)
    assert steps() == before
    out, _ = traced(lambda: detect_affine_batch(img, CFG))
    total = steps() - before
    for k in plain:
        if k != "next_firsts":
            assert torch.equal(plain[k], out[k]), k

    sig = pyramid.level_sigmas(CFG)
    cur, pd = pyramid.prepare_first_level(img, CFG)
    want, octave = 0, 0
    while min(cur.shape[-2:]) > CFG.min_octave_size:
        o = pyramid.build_octave(cur, pd, CFG)
        comp = detect.detect_octave_batch(o.resps, o.blurs, sig, pd, CFG,
                                          octave=octave)
        kargs = adapt_args(*octave_affine_inputs(comp, o.blurs, pd, CFG))
        _, steps = cuda_affine.adapt_plain(*kargs, return_steps=True)
        want += int(steps.sum())
        cur, pd, octave = o.next_first, pd * 2.0, octave + 1
    assert octave >= 2 and want > 0
    assert total == want
