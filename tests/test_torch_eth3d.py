"""The grouped path at the ETH3D high-res frame size (6048x4032), on the
CPU at small sizes, and one full-size frame on the card.

default_group_spec: the JAX package's table wherever the short side is
under 1,024 px; past it, the JAX table as a prefix and doubled bounds
up to the border limit min(H, W) + 2, equal to the benchmark
reference's copy of the rule (benchmark/reference/group_table.py).  The
port's grouped step on the CPU equals the benchmark's frozen plain
reference (benchmark/reference/hesaff_plain) with that table, bit for
bit: on seeded mosaics with the sparse detection path forced in both,
and on a 1152x1120 image whose phase A is replaced by hand-placed
keypoints in the 2,049 group.  Under torch.profiler the sparse path
opens "sparse: maps", "sparse: walk" and "sparse: dedup" inside "A:
detect", and the counter sparse_candidates grows by the candidates
walked.  One 6048x4032 frame on the card: tests/test_torch_cuda.py.
"""

import itertools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import _torch_parity  # noqa: F401  (two torch threads a worker)
from benchmark import mosaic
from benchmark.reference import group_table
from benchmark.reference.hesaff_plain import detect as plain_detect
from benchmark.reference.hesaff_plain import dist as plain_dist
from benchmark.reference.hesaff_plain.config import (
    HesaffConfig as PlainConfig)
from hesaff_tpu import dist as jdist
from hesaff_tpu.config import HesaffConfig as JaxConfig
from hesaff_tpu_torch import detect, dist
from hesaff_tpu_torch.config import HesaffConfig
from hesaff_tpu_torch.ops import cuda_patches
from hesaff_tpu_torch.utils import profiling

CFG = HesaffConfig()
PCFG = PlainConfig()


@pytest.mark.parametrize("cap,B", [(512, 1), (1024, 16), (2560, 1),
                                   (81920, 2)])
def test_table_unchanged_below_1024(cap, B):
    sides = (13, 49, 160, 480, 640, 768, 1000, 1021, 1022, 1023)
    for h, w in itertools.product(sides, (13, 200, 800, 1023, 6048)):
        want = jdist.default_group_spec(h, w, JaxConfig(), cap, B)
        assert dist.default_group_spec(h, w, CFG, cap, B) == want
        assert dist.default_group_spec(w, h, CFG, cap, B) == (
            jdist.default_group_spec(w, h, JaxConfig(), cap, B))
        assert group_table.default_group_spec(h, w, PCFG, cap, B) == want


@pytest.mark.parametrize("H,W,last", [(1024, 1024, 2049), (1056, 1088, 2049),
                                      (2047, 3000, 2049),
                                      (2048, 3000, 4097),
                                      (4032, 6048, 4097),
                                      (8190, 9000, 8193),
                                      (8192, 9000, 16385)])
def test_table_reaches_the_border_limit(H, W, last):
    spec = dist.default_group_spec(H, W, CFG, 81920, 2)
    head = jdist.default_group_spec(H, W, JaxConfig(), 81920, 2)
    assert spec[:len(head)] == head and head[-1][0] == 1025
    bounds = [b for b, _ in spec[len(head):]]
    assert bounds == [2 * b - 1 for b in [1025] + bounds[:-1]]
    assert bounds[-1] == last and last >= min(H, W) + 2 > (last + 1) // 2
    assert all(c >= 32 and c % 32 == 0 for _, c in spec)
    assert spec == group_table.default_group_spec(H, W, PCFG, 81920, 2)
    for bsize in bounds:
        ps, octave, src = dist.tail_source_plan(bsize, 1.0)
        assert src <= dist.FULL_RES_GROUP_MAX and 2 ** octave == ps


def _assert_equal(a, b):
    for k in dist.DenseFeatures._fields:
        assert torch.equal(getattr(a, k), getattr(b, k)), k


def _force_sparse(monkeypatch, pixels):
    monkeypatch.setattr(detect, "SPARSE_PATH_PIXELS", pixels)
    monkeypatch.setattr(plain_detect, "SPARSE_PATH_PIXELS", pixels)


def test_grouped_equals_plain_with_sparse_octaves(monkeypatch):
    """Two seeded 192x256 mosaics of 96x128 tiles, octaves 0 and 1 on
    the sparse path (2^13 px or more) in both packages, at capacities
    that drop nothing (the small tiles are dense)."""
    _force_sparse(monkeypatch, 1 << 13)
    caps = dict(candidate_cap_div=16, affine_cap_div=32)
    cfg, pcfg = HesaffConfig(**caps), PlainConfig(**caps)
    imgs = mosaic.frames(256, 192, 128, 96, 2, 4, 2**31 + 5, "cpu")
    groups = dist.default_group_spec(192, 256, cfg, 2048, 2)
    assert groups == group_table.default_group_spec(192, 256, pcfg, 2048, 2)
    n_sparse = []
    inner = detect.detect_octave_sparse

    def sparse(resps, *a, **k):
        n_sparse.append(resps.shape[-2:])
        return inner(resps, *a, **k)

    monkeypatch.setattr(detect, "detect_octave_sparse", sparse)
    out = dist.extraction_step_grouped(imgs, cfg, groups, device="cpu")
    ref = plain_dist.extraction_step_grouped(imgs, pcfg, groups,
                                             device="cpu")
    assert n_sparse == [(192, 256), (96, 128)]
    assert int(out.overflow) == 0 and int(out.valid.sum()) > 300
    _assert_equal(out, ref)


def _hand_placed(ncap):
    """Flat phase-A fields of one image: four keypoints in the 2,049
    group (ws 1,027 to 1,033; one too near the border for its patch),
    two in the 49 group, one above the 2,049 group (ws 2,187), the
    other slots empty."""
    kps = [  # x, y, s, a11, a12, a21, a22
        (576.0, 560.0, 98.5, 1.0, 0.0, 0.0, 1.0),
        (575.25, 559.5, 98.8, 1.01, 0.0, 0.02, 1.0 / 1.01),
        (577.5, 561.75, 99.0, 0.995, 0.0, -0.01, 1.0 / 0.995),
        (800.0, 560.0, 98.5, 1.0, 0.0, 0.0, 1.0),
        (300.0, 200.0, 2.1, 1.0, 0.0, 0.1, 1.0),
        (800.0, 900.0, 3.3, 0.9, 0.0, -0.2, 1.0 / 0.9),
        (576.0, 560.0, 210.0, 1.0, 0.0, 0.0, 1.0),
    ]
    flat = {k: torch.zeros(ncap) for k in
            ("x", "y", "s", "a11", "a12", "a21", "a22", "response")}
    flat["ok"] = torch.zeros(ncap, dtype=torch.bool)
    flat["det_ok"] = torch.zeros(ncap, dtype=torch.bool)
    flat["type"] = torch.zeros(ncap, dtype=torch.int32)
    for j, kp in enumerate(kps):
        slot = 5 + 7 * j
        for k, v in zip(("x", "y", "s", "a11", "a12", "a21", "a22"), kp):
            flat[k][slot] = v
        flat["response"][slot] = 300.0 + j
        flat["ok"][slot] = flat["det_ok"][slot] = True
    return flat


def test_tail_group_2049_equals_plain(monkeypatch):
    """A 1152x1120 mosaic (border limit 1,122: the 2,049 group's
    keypoints warp from octave 3, ps 8, through a 133 px source
    workspace) with hand-placed keypoints in place of phase A."""
    H, W, ncap = 1120, 1152, 64
    img = mosaic.frames(W, H, 128, 96, 1, 4, 2**31 + 9, "cpu")
    flat = _hand_placed(ncap)

    def phase_a(images, cfg, valid_hw=None):
        return ({k: v.clone() for k, v in flat.items()}, [],
                torch.zeros((), dtype=torch.int64), ncap)

    monkeypatch.setattr(dist, "phase_a", phase_a)
    monkeypatch.setattr(plain_dist, "phase_a", phase_a)
    groups = dist.default_group_spec(H, W, CFG, 512, 1)
    assert groups[-1][0] == 2049 and len(groups) == 7
    assert dist.tail_source_plan(2049, 1.0) == (8.0, 3, 259)
    out = dist.extraction_step_grouped(img, CFG, groups, device="cpu")
    ref = plain_dist.extraction_step_grouped(
        img, PCFG, group_table.default_group_spec(H, W, PCFG, 512, 1),
        device="cpu")
    # the keypoint above the border limit is no overflow in the port;
    # the frozen reference counts it, and under the judge's table it
    # rejects it at the border check instead
    assert int(out.overflow) == 0 and int(ref.overflow) == 1
    _assert_equal(out, ref._replace(overflow=out.overflow))
    judged = group_table.judged_table(H, W, PCFG, 512, 1)
    assert judged[:len(groups)] == groups and judged[-1][0] == 2049 * 2 - 1
    jref = plain_dist.extraction_step_grouped(img, PCFG, judged,
                                              device="cpu")
    assert int(jref.overflow) == 0
    for k in dist.DenseFeatures._fields[1:-1]:
        assert torch.equal(getattr(out, k)[out.valid],
                           getattr(jref, k)[jref.valid]), k
    _, ws, _ = cuda_patches.patch_geometry(flat["s"], CFG)
    assert sorted(ws[flat["ok"]].tolist()) == [25, 39, 1027, 1027, 1031,
                                               1033, 2187]
    big = out.valid & (out.s > 50)
    assert int(big.sum()) == 3          # the fourth fails the border check
    assert int((out.valid & (out.s < 50)).sum()) == 2
    assert torch.all(out.desc[big].sum(1) > 0)
    # the JAX package's table stops at 1,025: it counts the five above it
    short = dist.extraction_step_grouped(img, CFG, groups[:-1],
                                         device="cpu")
    assert int(short.overflow) == 5 and int(short.valid.sum()) == 2


def _spans(prof):
    return sorted(((e.name(), e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.is_user_annotation()), key=lambda s: s[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_sparse_spans_and_counter(golden_small, monkeypatch):
    """Every octave of the 200x160 golden on the sparse path: three
    "sparse: maps" and "sparse: walk" spans and one "sparse: dedup" an
    octave inside its "A: detect", no sync span (the compactions wait on
    nothing), and sparse_candidates grown by the candidates walked (the
    level capacities' valid slots), with unchanged results."""
    _force_sparse(monkeypatch, 1)
    img = torch.as_tensor(golden_small["gray"][None].astype(np.float32))
    groups = dist.default_group_spec(160, 200, CFG, 512, 1)
    step = lambda: dist.extraction_step_grouped(img, CFG, groups,
                                                device="cpu")
    plain = step()
    walked = []
    inner = detect.detect_level

    def detect_level(*a, **k):
        lk = inner(*a, **k)
        walked.append(int((lk.n_cand - lk.overflow).sum()))
        return lk

    monkeypatch.setattr(detect, "detect_level", detect_level)
    count = lambda: profiling.counters().get("sparse_candidates", 0)
    before = count()
    step()
    assert count() == before            # nothing counted off the profiler
    walked.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = step()
    _assert_equal(plain, out)
    assert count() - before == sum(walked) > 0
    sp = _spans(prof)
    det = [s for s in sp if s[0] == "A: detect"]
    n_oct = len(det)
    assert n_oct >= 2 and len(walked) == 3 * n_oct
    for name, each in (("sparse: maps", 3), ("sparse: walk", 3),
                       ("sparse: dedup", 1)):
        mine = [s for s in sp if s[0] == name]
        assert len(mine) == each * n_oct, name
        for d in det:
            assert sum(_inside(s, d) for s in mine) == each, name
    walks = [s for s in sp if s[0] == "sparse: walk"]
    dedups = [s for s in sp if s[0] == "sparse: dedup"]
    # the compactions in them wait on nothing (nor does anything else:
    # the image is already on the step's device)
    assert walks and dedups
    assert not [s for s in sp if s[0].startswith("sync: ")]
    # the dense path opens none of them
    monkeypatch.setattr(detect, "SPARSE_PATH_PIXELS", 1 << 23)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
    assert not any(n.startswith("sparse: ") for n, _, _ in _spans(prof))
