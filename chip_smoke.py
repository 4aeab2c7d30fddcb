#!/usr/bin/env python3
"""Smoke run of the PyTorch port (hesaff_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from hesaff_tpu_torch/csrc (phase 1), holds each
of the six against its plain PyTorch version at the main path's shapes
(phase 2; K1 bit-equal at the ladder's largest taps, at k=1, written
into a stack slot and blur-only, with the octave-0 ladder timed as a
whole; K2 in one launch over octave 0's detection levels, K4 on every
octave's keypoints, K5 on every group of the serving path, K6 on the
real patches and through its masked uint8 entry on the serving slots,
K3 on the octave-0 planes of phase 6's images), runs extract() on the
200x160 oracle golden (phase 3), and
drives both batch entry points on 16 synthetic 800x640 images (the
bench imagery of bench.py): extract_batch (phase 4) and the grouped
serving path dist.extraction_step_grouped with bench.py's group table
(phase 5), each checked against a CPU run of the plain versions on
image 0.  Phase 5 also times 7 more batches and profiles one
(torch.profiler): the device's busy and idle share of the batch, device
ms by kernel and of torch.cat's kernels, and the host ms of each
stage's span in dist.py.  Phase 6 runs extract_batch on two 4032x3024
images, the full frame of a 12 MP camera, whose octave 0 (2^23 px or
more) takes the sparse detection path through K3, and gates image 0
against a CPU run.  Phase 7 runs the path after the descriptors on
the card: extract() of bench image 0 cropped by 64 px multiples,
match_descriptors against phase 5's image 0 (knn2 bit-equal to a CPU
run), ransac_homography (the crop's translation within 1 px at its
corners, inliers within 2% of a CPU run), repeatability under that
translation (within 0.02 of the CPU extraction's), write_sift_file of
phase 5's 27,774 features from CUDA tensors (read back; native and
Python writers byte-equal), and rank_images of images 0-3 over the 16
images (each first, votes equal to a CPU run), and times knn2 at
27,774 x 27,774 against its bound, RANSAC and the file write.  Phase
2 also holds K2 and K3 with per-image (per-plane) start-pixel limits,
the padded mode's window, against their plain versions and times them
beside the unlimited calls.  Phase 8 runs the fleet on the card:
utils/fleet.extract_fleet over 16 files of four true sizes (seeds
2000-2015), a 4000x3000 frame (octave 0 padded takes the sparse path
and K3) and a truncated file, in padded mode; each file against its
unpadded extract_batch with tests/test_dist.py's padded-mode
tolerance, the lone images against a CPU fleet run with bench.py's
gate, a resume that launches nothing, `cli fleet` in a subprocess
(exit 1 on the truncated file) and `cli retrieve` over the output
(the query's file first); the 4000x3000 frame's candidates, padded
against unpadded, are held equal wherever the padded ladder's DoH
agrees (edge_witness); it logs images/s and the host ms of each
chunk.  Phase 9 runs geometry on the card against CPU runs:
incremental_sfm on tests/test_sfm.py's scene (every frame, ATE < 0.15,
rmse < 2e-3), ba_solve on 50 cameras x 5,000 points and the track form
on 50 x 10,000 (each converging, within 0.02 px of the CPU, an LM step
bit-equal on two runs, its ms timed).  Phase 10 runs the multi-device
slice on the one card: dist.extraction_step_staged (every bucket at full
resolution) on the 16 bench images with bench.py's bucket table, image
0 gated against a CPU run and phase 5's grouped output held against it
with bench.py's verify thresholds; PipelinedExtractor with both stages
on the card (a stream each) equal to the staged step; a one-rank NCCL
group (sharded_extraction_step, ring_knn2 on phase 5's 27,774
descriptors and ba_solve_sharded bit-equal to their one-device forms);
two gloo ranks sharing the card (spawned: the sharded step image by
image, ring_knn2 bit-equal to knn2 off ties, sharded_query_votes,
ba_solve_sharded against mesh=None and itself) and the drop-host
protocol (rank 0 exits 17 after its barrier's timeout, the union of the
rounds equal to a dense run).  Exits non-zero on any failed phase; on
success the last line of standard output is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

and the line before it holds the per-kernel record: launches in one
phase-6 call (every kernel runs there) and in phases 4, 5, 6, 7, 8 and 10
(checked: K1 once a ladder level plus the initial blur, K6 once), max
abs error against the plain version, the kernel's and the plain
version's ms (one pair of CUDA events around back-to-back launches, 20
of the kernel and 3 of the plain version, after a warm-up; for K3 and
K4 the kernel's device time from torch.profiler over 20 calls, since a
K4 call on a small octave is shorter than its host's enqueue), and the
bound: the larger of the bytes it must move over 3.35 TB/s and the
float32 operations its function needs over 67 TFLOP/s (H100 SXM data
sheet), both counted from this run's inputs (K4's operations from the
steps each keypoint ran in the plain loop).  No single PyTorch call
computes any of the six functions, so library_ms is null.  There is no
CPU mode: without a CUDA device the script exits with an error.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import multiprocessing
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.join(ROOT, "tests")
GOLDEN = os.path.join(TESTS, "golden")
BATCH, HEIGHT, WIDTH = 16, 640, 800
# phase 6: 12 MP frames, each a mosaic of TILES_Y x TILES_X bench-sized
# tiles cropped to LARGE_H x LARGE_W, seeds from LARGE_SEED on
LARGE_BATCH, LARGE_H, LARGE_W = 2, 3024, 4032
TILES_Y, TILES_X, LARGE_SEED = 5, 6, 1000
# phase 7: bench image 0 cropped by multiples of 64 px on each axis
# ((y0, y1), (x0, x1)), so every octave's sampling grid stays aligned and
# the crop's homography to image 0 is an exact translation
CROP = ((64, 576), (64, 736))
# phase 8: a fleet of 16 files at mixed true sizes (width x height), four
# of each, seeds FLEET_SEED + k (k = 0..15, size k // 4), unused by
# bench.py and phase 6, in FLEET_ORDER: chunk 1 holds seven images of
# the 832x640 shape bucket (800x640 and 777x601) and one 640x430 alone,
# chunk 2 four 1000x750, three 640x430 and one 777x601 alone (the lone
# ones take extract_batch, the others the grouped path); then phase 6's
# first mosaic cut to 4000x3000 (octave 0 padded to 4032x3008 takes the
# sparse path and K3) and a truncated file
FLEET_SIZES = ((800, 640), (777, 601), (1000, 750), (640, 430))
FLEET_SEED = 2000
FLEET_ORDER = (0, 1, 2, 3, 4, 5, 6, 12, 8, 9, 10, 11, 13, 14, 15, 7)
FLEET_ALONE = (12, 7)       # extract_batch singletons, gated against CPU
FLEET_BIG = (3000, 4000)
# phase 9: points of the dense-E and the track-form BA scenes (50
# cameras, 4 observations a point)
BA_POINTS = (5000, 10000)

KERNELS = (
    # name, source, TPU kernel it replaces
    ("blur_doh", "hesaff_tpu_torch/csrc/blur_doh.cu",
     "hesaff_tpu/ops/pallas_blur.py:196"),
    ("detect_walk", "hesaff_tpu_torch/csrc/detect_walk.cu",
     "hesaff_tpu/ops/pallas_detect.py:324"),
    ("detect_maps", "hesaff_tpu_torch/csrc/detect_walk.cu",
     "hesaff_tpu/ops/pallas_detect.py:139"),
    ("affine_adapt", "hesaff_tpu_torch/csrc/affine_adapt.cu",
     "hesaff_tpu/ops/pallas_affine.py:474"),
    ("patches_group", "hesaff_tpu_torch/csrc/patches_group.cu",
     "hesaff_tpu/ops/pallas_patches.py:521"),
    ("sift_desc", "hesaff_tpu_torch/csrc/sift_desc.cu",
     "hesaff_tpu/ops/pallas_sift.py:171"),
)
# the device kernel of K4's wrapper (torch.profiler's name)
K4_KERNELS = ("affine_kernel",)
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 flop/s
# outside the tensor cores
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12

failures: list[str] = []
# times that a later phase prints beside its own (knn2_ms of phase 7,
# track_step_ms of phase 9)
notes: dict[str, float] = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        failures.append(what)
        log(f"FAIL: {what}")


def timed(fn, reps: int = 20) -> float:
    """Milliseconds of one fn() on the current stream: after a warm-up,
    one pair of CUDA events around `reps` back-to-back calls, so the
    host's enqueue gaps between calls hide behind the device's work."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, names, reps: int = 20) -> float:
    """Device milliseconds of one fn() in the kernels whose names contain
    one of `names`: torch.profiler over `reps` calls after a warm-up.
    Unlike timed(), this leaves out the host's time between launches,
    which is the larger where a call's kernels are short."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and any(n in e.name for n in names))
    return us / 1e3 / reps


def bound(nbytes: float, flops: float) -> dict:
    """Least time for the work: the larger of bytes and operations
    over the card's peaks."""
    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    return dict(bound_ms=max(tb, tf),
                bound_by="bytes" if tb >= tf else "operations",
                library_ms=None)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _counters() -> dict:
    """Each kernel's launch counter: (wrapper module, attribute)."""
    from hesaff_tpu_torch.ops import (cuda_affine, cuda_blur, cuda_detect,
                                      cuda_patches, cuda_sift)

    return {"blur_doh": (cuda_blur, "LAUNCHES"),
            "detect_walk": (cuda_detect, "LAUNCHES"),
            "detect_maps": (cuda_detect, "MAPS_LAUNCHES"),
            "affine_adapt": (cuda_affine, "LAUNCHES"),
            "patches_group": (cuda_patches, "LAUNCHES"),
            "sift_desc": (cuda_sift, "LAUNCHES")}


def reset_counts() -> None:
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {k: getattr(mod, attr) for k, (mod, attr) in _counters().items()}


def dense_octaves(H: int, W: int, cfg) -> int:
    """Octaves of an H x W input that take the dense walk: K2 launches
    once for each."""
    from hesaff_tpu_torch import detect

    return sum((H >> o) * (W >> o) < detect.SPARSE_PATH_PIXELS
               for o in range(cfg.num_octaves(H, W)))


def check_k1_k6_launches(launches: dict, H: int, W: int, cfg,
                         what: str) -> None:
    """K1 launches once a ladder level (num_scales + 2 an octave, level 0
    included) and once for the initial blur; K6 once a call."""
    from hesaff_tpu_torch import pyramid

    n = ((cfg.num_scales + 2) * cfg.num_octaves(H, W)
         + (pyramid.first_level_taps(cfg) is not None))
    check(launches["blur_doh"] == n, f"{what}: K1 launched "
          f"{launches['blur_doh']} times, not {n}")
    check(launches["sift_desc"] == 1, f"{what}: K6 launched "
          f"{launches['sift_desc']} times, not once")


def check_dense_launches(launches: dict, cfg, what: str, H: int = HEIGHT,
                         W: int = WIDTH) -> None:
    """An H x W input (800x640 by default) whose octaves are all under
    2^23 px runs every kernel but K3: each octave takes the dense walk,
    one K2 launch each."""
    for k, v in launches.items():
        if k == "detect_maps":
            check(v == 0, f"{what}: K3 launched {v} times on the dense path")
        else:
            check(v > 0, f"{what}: kernel {k} never launched on the path")
    n = dense_octaves(H, W, cfg)
    check(launches["detect_walk"] == n, f"{what}: K2 launched "
          f"{launches['detect_walk']} times, not once per octave ({n})")
    check_k1_k6_launches(launches, H, W, cfg, what)


def bench_config():
    """HesaffConfig with bench.py's capacities: nothing overflows on its
    imagery."""
    from hesaff_tpu_torch import HesaffConfig

    return dataclasses.replace(HesaffConfig(), candidate_cap_max=8192,
                               affine_cap_max=8192, candidate_cap_div=128,
                               affine_cap_div=256)


def _synth(seed: int) -> np.ndarray:
    sys.path.insert(0, GOLDEN)
    import gen_images

    return (gen_images.synth_image(WIDTH, HEIGHT, seed=seed)
            .astype(np.float32).mean(axis=-1))


def _synth_rgb(width: int, height: int, seed: int) -> np.ndarray:
    sys.path.insert(0, GOLDEN)
    import gen_images

    return gen_images.synth_image(width, height, seed=seed)


def start_images(ex):
    """Futures of the imagery, made in worker processes: bench.py's 16
    800x640 images (seeds 0..15, channel-mean gray), the tiles of
    phase 6's mosaics (seeds LARGE_SEED on, unused by bench.py) and
    phase 8's 16 RGB images (seeds FLEET_SEED on)."""
    n_tiles = LARGE_BATCH * TILES_Y * TILES_X
    return ([ex.submit(_synth, s) for s in range(BATCH)],
            [ex.submit(_synth, LARGE_SEED + k) for k in range(n_tiles)],
            [ex.submit(_synth_rgb, *FLEET_SIZES[k // 4], FLEET_SEED + k)
             for k in range(16)])


def mosaic(tiles: np.ndarray) -> np.ndarray:
    """(LARGE_BATCH * TILES_Y * TILES_X, HEIGHT, WIDTH) tiles, row-major
    in each frame, to the (LARGE_BATCH, LARGE_H, LARGE_W) frames."""
    large = tiles.reshape(LARGE_BATCH, TILES_Y, TILES_X, HEIGHT, WIDTH)
    large = large.transpose(0, 1, 3, 2, 4).reshape(
        LARGE_BATCH, TILES_Y * HEIGHT, TILES_X * WIDTH)
    return np.ascontiguousarray(large[:, :LARGE_H, :LARGE_W])


def gather_images(futures):
    bench, tiles, fleet = futures
    return (np.stack([f.result() for f in bench]),
            mosaic(np.stack([f.result() for f in tiles])),
            [f.result() for f in fleet])


def card_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_build() -> None:
    from hesaff_tpu_torch.ops import cuda_build

    sources = sorted({os.path.basename(k[1])[:-3] for k in KERNELS})
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as ex:
        list(ex.map(cuda_build.library, sources))
    log(f"phase 1 build: {time.perf_counter() - t0:.2f} s wall for "
        f"{len(sources)} sources, {len(KERNELS)} kernels (sm_90a, "
        "--fmad=false)")
    for name in sources:
        info = cuda_build.BUILD_INFO[name]
        log(f"  {name}: nvcc {info['seconds']:.2f} s; "
            + " | ".join(s.strip() for s in info["ptxas"].splitlines()))


def phase_kernels(images, cfg, card: str) -> dict:
    """Each kernel against its plain version at the main path's shapes:
    octave 0 of the 16-image batch, and K4 on every octave."""
    import torch

    from hesaff_tpu_torch import detect, pyramid
    from hesaff_tpu_torch.ops import cuda_blur, cuda_detect
    from hesaff_tpu_torch.ops.blur import separable_blur
    from hesaff_tpu_torch.ops.hessian import hessian_response, norm2_of

    rec = {}
    first, pd = pyramid.prepare_first_level(images, cfg)
    sig = pyramid.level_sigmas(cfg)

    # K1 at the ladder's largest taps (level 3 -> 4)
    taps = pyramid.ladder_taps(cfg)[-1]
    norm2 = norm2_of(sig[-1] ** 2)
    kb, kr = cuda_blur.blur_doh(first, taps, norm2)
    pb, pr = cuda_blur.blur_doh_plain(first, taps, norm2)
    eb = float((kb - pb).abs().max())
    er = float((kr - pr).abs().max())
    check(eb <= 1e-4, f"blur_doh blur max err {eb} > 1e-4")
    check(er <= 0.1, f"blur_doh resp max err {er} > 0.1")
    check(bool(torch.equal(kb, pb) and torch.equal(kr, pr)),
          f"blur_doh k={len(taps)}: not bit-equal to its plain version")
    del kb, kr, pb, pr
    # k=1 (level 0: a copy and its DoH) and a ladder level read from and
    # written into slots of preallocated stacks, as build_octave runs them
    L = cfg.num_scales + 2
    blurs = first.new_empty(first.shape[:1] + (L,) + first.shape[1:])
    resps = torch.full_like(blurs, -1.0)
    cuda_blur.blur_doh(first, [1.0], norm2_of(sig[0] ** 2),
                       out=blurs[:, 0], resp_out=resps[:, 0])
    check(bool(torch.equal(blurs[:, 0], first) and torch.equal(
        resps[:, 0], hessian_response(first, sig[0] ** 2))),
        "blur_doh k=1: not a copy and the plain DoH of level 0")
    t1 = pyramid.ladder_taps(cfg)[0]
    cuda_blur.blur_doh(blurs[:, 0], t1, norm2_of(sig[1] ** 2),
                       out=blurs[:, 1], resp_out=resps[:, 1])
    sb_, sr_ = cuda_blur.blur_doh_plain(first, t1, norm2_of(sig[1] ** 2))
    check(bool(torch.equal(blurs[:, 1], sb_) and torch.equal(resps[:, 1], sr_)
               and bool((resps[:, 2:] == -1.0).all())),
          f"blur_doh k={len(t1)} into a stack slot: not bit-equal, or "
          "another slot written")
    del blurs, resps, sb_, sr_
    # blur-only: prepare_first_level's initial blur
    ft = pyramid.first_level_taps(cfg)
    check(bool(torch.equal(first, separable_blur(images, ft))),
          f"blur (blur-only, k={len(ft)}): not bit-equal to separable_blur")
    ms = timed(lambda: cuda_blur.blur_doh(first, taps, norm2))
    pms = timed(lambda: cuda_blur.blur_doh_plain(first, taps, norm2), 3)
    # the octave-0 ladder as phase A builds it: initial blur, level 0,
    # four levels, each one K1 launch into its stack slot
    lms = timed(lambda: pyramid.build_octave(
        *pyramid.prepare_first_level(images, cfg), cfg))
    log(f"phase 2 blur_doh {tuple(first.shape)} k={len(taps)}: blur err "
        f"{eb:.3g} (atol 1e-4), resp err {er:.3g} (atol 0.1), bit-equal; "
        f"k=1, k={len(t1)} into a stack slot and blur-only k={len(ft)} "
        f"bit-equal; kernel {ms:.3f} ms, plain {pms:.3f} ms; octave-0 ladder "
        f"(prepare_first_level + build_octave, {1 + L} launches) {lms:.3f} ms")
    # one read, two writes; a 2-pass blur (2 flops a tap) and the DoH
    rec["blur_doh"] = dict(max_abs_err=er, ms=ms, plain_ms=pms,
                           octave0_ladder_ms=lms, **bound(
        3 * nbytes(first), first.numel() * (4 * len(taps) + 13)))

    # K2 on the real octave-0 ladders: one launch over every detection
    # level, as detect_octave_dense calls it
    o = pyramid.build_octave(first, pd, cfg)
    nl = cfg.num_scales
    ok, cell, tab, cand = cuda_detect.detect_walk_octave(o.resps, o.blurs,
                                                         cfg)
    pok, pcell, ptab, pcand = cuda_detect.detect_walk_octave_plain(
        o.resps, o.blurs, cfg)
    e2 = 0.0
    for l in range(nl):
        check(bool(torch.equal(ok[:, l], pok[:, l])),
              f"detect_walk ok plane, level {l + 1}")
        check(bool(torch.equal(cand[:, l], pcand[:, l])),
              f"detect_walk cand, level {l + 1}")
        check(bool(torch.equal(cell[:, l], pcell[:, l])),
              f"detect_walk cells, level {l + 1}")
        # the table at every pixel: detect_octave_dense gathers it at the
        # walks' final cells, wherever they end
        d = (tab[:, l] - ptab[:, l]).abs()
        check(bool((d <= 1e-5 + 1e-6 * ptab[:, l].abs()).all()),
              f"detect_walk tab, level {l + 1}")
        e2 = max(e2, float(d.max()))
        del d
    ms = timed(lambda: cuda_detect.detect_walk_octave(o.resps, o.blurs, cfg))
    pms = timed(lambda: cuda_detect.detect_walk_octave_plain(
        o.resps, o.blurs, cfg), 3)
    # the whole dense detection of the octave around it (K2, compaction
    # with its host sync, final-cell fetch, dedup): host clock around a
    # synchronised call, median of 5 after a warm-up
    walls = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        detect.detect_octave_dense(o.resps, o.blurs, sig, pd, cfg)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    log(f"phase 2 detect_walk_octave {tuple(o.resps.shape)}: ok/cand/cells "
        f"equal at {nl} levels, tab max err {e2:.3g} at every pixel (rtol "
        f"1e-6, atol 1e-5); kernel {ms:.3f} ms, plain {pms:.3f} ms (one "
        f"launch); detect_octave_dense wall {np.median(walls[1:]):.3f} ms "
        f"(median of {[round(w, 3) for w in walls[1:]]})")
    # reads the nl + 2 response planes and blurs 1..nl once, writes ok,
    # cell, tab and cand of every level; 26-neighbour NMS a pixel and
    # <= 5 steps of a 3x3 solve a candidate
    rec["detect_walk"] = dict(max_abs_err=e2, ms=ms, plain_ms=pms, **bound(
        nbytes(o.resps[:, :nl + 2], o.blurs[:, 1:nl + 1], ok, cell, tab,
               cand),
        30 * o.resps[:, 1:nl + 1].numel() + 300 * int(cand.sum())))
    del ok, cell, pok, pcell, ptab, pcand
    rec["detect_walk"].update(walk_limits(o, tab, cand, cfg))
    del tab, cand, o
    phase_affine(images, cfg, rec, card)
    return rec


def walk_limits(o, tab, cand, cfg) -> dict:
    """K2 with per-image start-pixel limits (padded mode) on the same
    ladders, each image a different true size: ok / cand / cells equal
    to the plain version with the same limits, the table bit-equal to
    the unlimited call's, cand the unlimited one's inside the window.
    Times with and without limits in turns (none, limits, limits, none),
    CUDA events around 20 launches each."""
    import torch

    from hesaff_tpu_torch.ops import cuda_detect

    B, _, H, W = o.resps.shape
    lim = torch.as_tensor([[H - 7 * b, W - 13 * b] for b in range(B)],
                          dtype=torch.int32, device=o.resps.device)
    ok, cell, ltab, lcand = cuda_detect.detect_walk_octave(o.resps, o.blurs,
                                                           cfg, lim)
    pok, pcell, _, pcand = cuda_detect.detect_walk_octave_plain(
        o.resps, o.blurs, cfg, lim)
    check(bool(torch.equal(ok, pok) and torch.equal(lcand, pcand)),
          "detect_walk with limits: ok / cand differ from the plain version")
    check(bool(torch.equal(cell, pcell)),
          "detect_walk with limits: cells differ from the plain version")
    check(bool(torch.equal(ltab, tab)),
          "detect_walk with limits: table differs from the unlimited call's")
    rr = torch.arange(H, device=lim.device)[:, None]
    cc = torch.arange(W, device=lim.device)[None, :]
    win = ((rr < lim[:, 0, None, None] - cfg.border)
           & (cc < lim[:, 1, None, None] - cfg.border))[:, None]
    check(bool(torch.equal(lcand, cand & win)),
          "detect_walk with limits: cand is not the window's")
    narrowed = int(cand.sum()) - int(lcand.sum())
    del ok, cell, ltab, lcand, pok, pcell, pcand
    run = lambda v: timed(lambda: cuda_detect.detect_walk_octave(
        o.resps, o.blurs, cfg, v))
    t = [run(None), run(lim), run(lim), run(None)]
    log(f"phase 2 detect_walk_octave with per-image limits "
        f"({lim[-1].tolist()} for image {B - 1}): equal to the plain "
        f"version, table bit-equal, {narrowed} candidates outside the "
        f"windows; kernel ms in turns none / limits / limits / none: "
        f"{' / '.join(f'{v:.3f}' for v in t)}")
    return dict(limits_ms=(t[1] + t[2]) / 2, no_limits_ms=(t[0] + t[3]) / 2)


def octave_adapt_args(images, cfg) -> list:
    """cuda_affine.adapt's arguments for every octave of an image batch,
    as phase A makes them (batch.detect_affine_batch's loop)."""
    from hesaff_tpu_torch import detect, pyramid
    from hesaff_tpu_torch.affine_shape import adapt_args
    from hesaff_tpu_torch.batch import octave_affine_inputs

    sig = pyramid.level_sigmas(cfg)
    cur, pd = pyramid.prepare_first_level(images, cfg)
    out, octave = [], 0
    while min(cur.shape[-2:]) > cfg.min_octave_size:
        o = pyramid.build_octave(cur, pd, cfg)
        comp = detect.detect_octave_batch(o.resps, o.blurs, sig, pd, cfg,
                                          octave=octave)
        out.append(adapt_args(*octave_affine_inputs(comp, o.blurs, pd, cfg)))
        cur, pd, octave = o.next_first, pd * 2.0, octave + 1
    return out


def phase_affine(images, cfg, rec, card: str) -> None:
    """K4 against its plain version on every octave's real keypoints,
    one launch an octave as phase A makes them."""
    from hesaff_tpu_torch.ops import cuda_affine

    G = cfg.smm_window_size
    e4, ms, call_ms, pms, b4, f4 = 0.0, 0.0, 0.0, 0.0, 0, 0
    n_both, rows = 0, []
    for oc, kargs in enumerate(octave_adapt_args(images, cfg)):
        act = kargs[6]
        kr_ = cuda_affine.adapt(*kargs)
        pr_, steps = cuda_affine.adapt_plain(*kargs, return_steps=True)
        n_act = int(act.sum())
        ro, po = pr_.ok & act, kr_.ok & act
        allow = max(1, int(np.ceil(0.02 * n_act)))
        flips = int((ro != po).sum())
        both = ro & po
        it_flips = int((kr_.iters[both] != pr_.iters[both]).sum())
        same = both & (kr_.iters == pr_.iters)
        for f in ("u11", "u12", "u21", "u22"):
            a, b = getattr(kr_, f)[same], getattr(pr_, f)[same]
            d = (a - b).abs()
            e4 = max(e4, float(d.max()) if d.numel() else 0.0)
            check(bool((d <= 5e-5 + 1e-4 * b.abs()).all()),
                  f"affine {f}, octave {oc}")
        check(flips <= allow, f"affine ok flips {flips} > {allow}, octave {oc}")
        check(it_flips <= allow,
              f"affine iteration flips {it_flips} > {allow}, octave {oc}")
        n_both += int(both.sum())
        kms = device_ms(lambda: cuda_affine.adapt(*kargs), K4_KERNELS)
        cms = timed(lambda: cuda_affine.adapt(*kargs))
        kpms = timed(lambda: cuda_affine.adapt_plain(*kargs), 3)
        ms, call_ms, pms = ms + kms, call_ms + cms, pms + kpms
        # bytes: the pixels under each active keypoint's sampling grid,
        # about ((G - 1) ratio + 2)^2 (capped at the stack), the
        # per-keypoint arrays and the outputs.  Operations: the steps
        # each keypoint ran (the plain loop's count) times G^2 samples of
        # ~40 operations (coordinates, floors and tests, four-tap lerp,
        # gradients and the three masked products)
        grid = ((G - 1) * kargs[5][act].double() + 2) ** 2
        b4 += (min(nbytes(kargs[0]), 4 * int(grid.sum()))
               + nbytes(*kargs[1:7], kr_.ok, kr_.u11, kr_.u12, kr_.u21,
                        kr_.u22, kr_.iters))
        n_steps = int(steps.sum())
        f4 += n_steps * G * G * 40
        longest = int(steps.max()) if steps.numel() else 0
        rows.append(dict(octave=oc, active=n_act, slots=act.numel(),
                         steps=n_steps, longest=longest, ms=kms,
                         call_ms=cms, plain_ms=kpms, flips=flips,
                         iteration_flips=it_flips))
        log(f"phase 2 affine_adapt octave {oc}: {n_act} active of "
            f"{act.numel()} slots, {n_steps} steps, longest chain {longest}; "
            f"ok flips {flips}, iteration flips {it_flips} (budget {allow}); "
            f"kernel {kms:.4f} device ms ({cms:.4f} ms a call back to back), "
            f"plain {kpms:.3f} ms")
    check(n_both >= 10, "affine: too few accepted keypoints")
    log(f"phase 2 affine_adapt, {len(rows)} octaves on {card}: U max err "
        f"{e4:.3g} (rtol 1e-4, atol 5e-5); kernel {ms:.4f} device ms "
        f"({call_ms:.4f} ms a call back to back), plain {pms:.3f} ms (sums "
        "of one call an octave)")
    rec["affine_adapt"] = dict(max_abs_err=e4, ms=ms, call_ms=call_ms,
                               plain_ms=pms, octaves=rows, **bound(b4, f4))


def phase_group_kernels(images, cfg, rec) -> None:
    """K5 on the real keypoints of every group of the serving path
    (full resolution and both pyramid-tail groups, from phase A's first
    levels) and K6 on the patches it accepts, each against its plain
    version."""
    import torch

    from hesaff_tpu_torch import dist, sift
    from hesaff_tpu_torch.ops import cuda_patches, cuda_sift

    flat, levels_a, _, ncap = dist.phase_a(images, cfg)
    groups = dist.default_group_spec(HEIGHT, WIDTH, cfg, per_image_cap=1024,
                                     batch=BATCH)
    e5, ms, pms, b5, f5, kept = 0.0, 0.0, 0.0, 0, 0.0, []
    slots, slot_ok = [], []
    for bsize, _, gi, a, valid, _ in dist.group_selections(flat, cfg, groups,
                                                           ncap):
        kp = (gi, *(a[k] for k in ("x", "y", "s", "a11", "a21", "a22")))
        if bsize <= dist.FULL_RES_GROUP_MAX:
            args, cbad = cuda_patches.group_args(images, bsize, *kp, cfg,
                                                 valid)
            what = f"group {bsize}"
        else:
            ps, octave, bsrc = dist.tail_source_plan(bsize, 1.0)
            src = levels_a[octave - 1].contiguous()
            args, cbad = cuda_patches.group_args(
                src, bsrc, *kp, cfg, valid, ps=ps, orig_hw=(HEIGHT, WIDTH))
            what = (f"tail group {bsize} (ps {ps:g}, octave {octave}, "
                    f"bucket_src {bsrc})")
        pk, bad = cuda_patches.patches_group(*args)
        pp, pbad = cuda_patches.patches_group_plain(*args)
        ok, pok = valid & ~cbad & ~bad, valid & ~cbad & ~pbad
        check(bool(torch.equal(ok, pok)), f"patches_group ok, {what}")
        good = ~pbad
        err = float((pk - pp)[good].abs().max()) if bool(good.any()) else 0.0
        check(err <= 1e-3, f"patches_group {what}: max err {err} > 1e-3")
        e5 = max(e5, err)
        kms = timed(lambda: cuda_patches.patches_group(*args))
        kpms = timed(lambda: cuda_patches.patches_group_plain(*args), 3)
        ms, pms = ms + kms, pms + kpms
        # source: the workspaces' pixels (capped at the level), read once;
        # the per-keypoint arrays and the patches.  Operations of each
        # active keypoint: ~10 per bilinear sample (the row coordinate's
        # multiply-add, two fractions, three lerps), then WS.R^T and R.T
        # over the band of R its own taps give (non-zero taps + 1)
        P = cfg.patch_size
        src, ws = args[0], args[7][valid].double()
        band = torch.minimum((args[9][valid] != 0).sum(1).double() + 1, ws)
        b5 += (min(nbytes(src), 4 * int((ws * ws).sum()))
               + nbytes(*args[1:11], pk, bad))
        f5 += float((10 * ws * ws + 2 * P * ws * band
                     + 2 * P * P * band).sum())
        kept.append(pk[ok])
        slots.append(pk)
        slot_ok.append(ok)
        log(f"phase 2 patches_group {what}: {int(valid.sum())} keypoints "
            f"in {valid.numel()} slots, ok {int(ok.sum())} (equal), max "
            f"err {err:.3g} (atol 1e-3); kernel {kms:.3f} ms, plain "
            f"{kpms:.3f} ms")
    rec["patches_group"] = dict(max_abs_err=e5, ms=ms, plain_ms=pms,
                                **bound(b5, f5))

    pt = torch.cat(kept).contiguous()
    d = cuda_sift.sift_descriptors(pt, cfg)
    r = sift.sift_descriptors(pt, cfg)
    diff = (d - r).abs()
    e6 = float(diff.max())
    exact = float((diff == 0).float().mean())
    check(e6 <= 1, f"sift_desc: max step {e6} > 1")
    check(exact >= 0.99, f"sift_desc: exact share {exact} < 0.99")
    # the serving path's form: one masked uint8 launch over every slot
    # of the groups, as dist.describe_valid makes it
    slots, slot_ok = torch.cat(slots), torch.cat(slot_ok)
    m = cuda_sift.describe_masked(slots, slot_ok, cfg)
    check(not bool(m[~slot_ok].any()), "describe_masked: a row of an "
          "invalid slot is not zero")
    check(bool(torch.equal(m[slot_ok], d.to(torch.uint8))),
          "describe_masked: valid rows differ from the float entry's")
    mdiff = (m[slot_ok].float() - r).abs()
    check(float(mdiff.max()) <= 1 and float((mdiff == 0).float().mean())
          >= 0.99, "describe_masked: valid rows off the plain version")
    fms = timed(lambda: cuda_sift.sift_descriptors(pt, cfg))
    ms = timed(lambda: cuda_sift.describe_masked(slots, slot_ok, cfg))
    pms = timed(lambda: cuda_sift.describe_masked_plain(slots, slot_ok, cfg),
                3)
    # what the function needs a patch: ~30 flops a pixel (normalise,
    # gradients, magnitude, atan2, the two-bin orientation split); the
    # row binning adds a pixel's 2 orientation values into its row's
    # non-zero spatial bins, on the mask's support (a multiply-add each);
    # the column binning adds the (row bin, orientation, column) sums
    # into each column's non-zero bins
    from hesaff_tpu_torch.ops import masks

    K, P = pt.shape[0], cfg.patch_size
    nb, no = cfg.spatial_bins, cfg.orientation_bins
    nz = (masks.sift_spatial_bins(P, nb) != 0).sum(axis=1)
    support = masks.circular_gauss_mask(P) > 0
    flops = K * (30 * P * P + 2 * 2 * int((support * nz[:, None]).sum())
                 + 2 * nb * no * int(nz.sum()))
    # bytes: the valid patches read once, the valid flags and the uint8
    # rows of every slot
    rec["sift_desc"] = dict(max_abs_err=e6, ms=ms, plain_ms=pms,
                            float_entry_ms=fms,
                            **bound(nbytes(pt, slot_ok, m), flops))
    log(f"phase 2 sift_desc on {K} real patches: max step {e6:g} (<= 1), "
        f"exact {exact:.4f} (>= 0.99), float entry {fms:.3f} ms; masked "
        f"uint8 entry on the {slots.shape[0]} serving slots: invalid rows "
        f"zero, valid rows = float entry, exact vs plain "
        f"{float((mdiff == 0).float().mean()):.4f}; kernel {ms:.3f} ms, "
        f"plain {pms:.3f} ms")


def phase_maps_kernel(large, cfg, rec) -> None:
    """K3 against its plain version on octave 0 of phase 6's images,
    every detection level (the sparse path's shapes)."""
    import torch

    from hesaff_tpu_torch import pyramid
    from hesaff_tpu_torch.ops import cuda_detect

    first, pd = pyramid.prepare_first_level(large, cfg)
    o = pyramid.build_octave(first, pd, cfg)
    del first
    e3, ms, pms, lms, b3, f3, bit_equal = 0.0, 0.0, 0.0, 0.0, 0, 0, True
    for l in range(1, cfg.num_scales + 1):
        args = (o.resps[:, l - 1], o.resps[:, l], o.resps[:, l + 1])
        maps, nan_flag, edge, mask = cuda_detect.detect_maps(*args, cfg)
        pmaps, pnan, pedge, pmask = cuda_detect.detect_maps_plain(*args, cfg)
        check(bool(torch.equal(mask, pmask)), f"detect_maps mask, level {l}")
        check(bool(torch.equal(nan_flag, pnan)), f"detect_maps nan, level {l}")
        check(bool(torch.equal(edge, pedge)), f"detect_maps edge, level {l}")
        d = (maps[pmask] - pmaps[pmask]).abs()
        close = d <= 1e-5 + 1e-6 * pmaps[pmask].abs()
        check(bool(close.all()), f"detect_maps maps where mask, level {l}")
        e3 = max(e3, float(d.max()) if d.numel() else 0.0)
        bit_equal &= bool(torch.equal(maps, pmaps))
        # read three planes, write the maps and three byte flags; per
        # pixel ~140 operations: 52 NMS compares, 30 for the differences,
        # ~35 for the pivoted solve, ~20 for val, the edge score and flags
        b3 += nbytes(*args, maps, nan_flag, edge, mask)
        f3 += 140 * o.resps[:, l].numel()
        del maps, nan_flag, edge, mask, pmaps, pnan, pedge, pmask, d, close
        ms += device_ms(lambda: cuda_detect.detect_maps(*args, cfg),
                        ("detect_maps_kernel",))
        pms += timed(lambda: cuda_detect.detect_maps_plain(*args, cfg), 3)
        # per-plane limits (padded mode): the mask the plain version's,
        # everything else the unlimited call's; device ms with limits
        B, H, W = args[1].shape
        lim = torch.as_tensor([[H - 24 * b - 5, W - 32 * b - 3]
                               for b in range(B)], dtype=torch.int32,
                              device=args[1].device)
        lm = cuda_detect.detect_maps(*args, cfg, lim)
        full = cuda_detect.detect_maps(*args, cfg)
        plm = cuda_detect.detect_maps_plain(*args, cfg, lim)[3]
        check(bool(torch.equal(lm[3], plm)) and all(
            bool(torch.equal(a, b)) for a, b in zip(lm[:3], full[:3])),
            f"detect_maps with limits, level {l}")
        del lm, full, plm
        lms += device_ms(lambda: cuda_detect.detect_maps(*args, cfg, lim),
                         ("detect_maps_kernel",))
    log(f"phase 2 detect_maps 3 x {tuple(o.resps[:, 1].shape)}: mask/nan/"
        f"edge equal, maps max err where mask {e3:.3g} (rtol 1e-6, atol "
        f"1e-5), all maps bit-equal: {bit_equal}; kernel {ms:.3f} device "
        f"ms, plain {pms:.3f} ms (3 levels); with per-plane limits: mask "
        f"equal to the plain version, maps and flags bit-equal to the "
        f"unlimited call's, {lms:.3f} device ms")
    rec["detect_maps"] = dict(max_abs_err=e3, ms=ms, plain_ms=pms,
                              limits_ms=lms, all_maps_bit_equal=bit_equal,
                              **bound(b3, f3))


def _ellipse(f, mr_size):
    a11, a12, a21, a22 = (np.asarray(v, np.float64)
                          for v in (f.a11, f.a12, f.a21, f.a22))
    sc2 = (mr_size * np.asarray(f.s, np.float64)) ** 2
    m00 = a11 * a11 + a12 * a12
    m01 = a11 * a21 + a12 * a22
    m11 = a21 * a21 + a22 * a22
    det = m00 * m11 - m01 * m01
    return m11 / (det * sc2), -m01 / (det * sc2), m00 / (det * sc2)


def phase_golden(dev) -> None:
    """extract() on the 200x160 oracle golden, test_pipeline's asserts."""
    from hesaff_tpu_torch import HesaffConfig, extract

    cfg = HesaffConfig()
    d = np.load(os.path.join(GOLDEN, "data", "synth_200x160.npz"))
    toks = bytes(d["sift_file"]).decode().split()
    dim, cnt = int(toks[0]), int(toks[1])
    body = np.asarray(toks[2:], np.float64).reshape(cnt, 5 + dim)
    gu, gv, ge, gdesc = body[:, 0], body[:, 1], body[:, 2:5], body[:, 5:]
    feats, stats = extract(d["gray"], cfg, device=dev, return_stats=True)
    e00, e01, e11 = _ellipse(feats, cfg.mr_size)
    matched, worst_rel, worst_l1 = 0, 0.0, 0.0
    for i in range(cnt):
        dd = np.hypot(feats.x - gu[i], feats.y - gv[i])
        j = int(dd.argmin())
        if dd[j] < 0.5:
            matched += 1
            ell = np.array([e00[j], e01[j], e11[j]])
            worst_rel = max(worst_rel, np.abs(ell - ge[i]).max()
                            / max(np.abs(ge[i]).max(), 1e-12))
            worst_l1 = max(worst_l1, np.abs(feats.desc[j].astype(np.int32)
                                            - gdesc[i]).mean())
    check(stats.candidate_overflow == 0 and stats.bucket_overflow == 0,
          "golden: overflow")
    check(matched >= 0.97 * cnt, f"golden: matched {matched}/{cnt} < 97%")
    check(worst_rel < 0.02, f"golden: ellipse rel {worst_rel} >= 0.02")
    check(worst_l1 < 0.5, f"golden: descriptor L1 {worst_l1} >= 0.5")
    check(abs(feats.n - cnt) <= max(2, 0.02 * cnt),
          f"golden: count {feats.n} vs oracle {cnt}")
    log(f"phase 3 oracle golden 200x160 on {dev}: matched {matched}/{cnt}, "
        f"count {feats.n}, worst ellipse rel {worst_rel:.4f} (< 0.02), "
        f"worst desc L1 {worst_l1:.3f} (< 0.5)")


def _gate(gpu, cpu, label: str) -> None:
    """bench.py's on-chip parity gate, GPU result against the CPU run."""
    n_g, n_c = gpu.n, cpu.n
    check(abs(n_g - n_c) <= 0.01 * max(n_c, 1),
          f"gate: count gpu {n_g} cpu {n_c}")
    key = lambda f: {(round(float(x), 2), round(float(y), 2),
                      round(float(s), 2)): i
                     for i, (x, y, s) in enumerate(zip(f.x, f.y, f.s))}
    kg, kc = key(gpu), key(cpu)
    common = sorted(set(kg) & set(kc))
    check(len(common) >= 0.99 * max(n_c, 1),
          f"gate: geometry match {len(common)}/{n_c} below 99%")
    ig = np.asarray([kg[k] for k in common], np.int64)
    ic = np.asarray([kc[k] for k in common], np.int64)
    p995 = 0.0
    for f in ("a11", "a12", "a21", "a22"):
        d = np.abs(getattr(gpu, f)[ig] - getattr(cpu, f)[ic])
        p995 = max(p995, float(np.quantile(d, 0.995)) if d.size else 0.0)
    dd = np.abs(gpu.desc[ig].astype(np.int32) - cpu.desc[ic].astype(np.int32))
    dmean = float(dd.mean()) if dd.size else 0.0
    frac = float((dd.max(axis=1) > 2).mean()) if dd.size else 0.0
    check(p995 <= 0.02, f"gate: U p99.5 {p995} > 0.02")
    check(dmean <= 0.05, f"gate: desc mean L1 {dmean} > 0.05")
    check(frac <= 0.012, f"gate: kp with a bin off by > 2: {frac} > 0.012")
    log(f"{label} gate image 0, GPU vs CPU plain: matched {len(common)}/"
        f"{n_c} (gpu {n_g}), U p99.5 {p995:.4f} (<= 0.02), desc mean L1 "
        f"{dmean:.4f} (<= 0.05), kp max>2 frac {frac:.4f} (<= 0.012)")


def phase_batch(images_np, cfg, dev) -> dict:
    import torch

    from hesaff_tpu_torch import extract_batch

    images = torch.as_tensor(images_np, device=dev)
    extract_batch(images, cfg)                        # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    feats, stats = extract_batch(images, cfg, return_stats=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    n_desc = sum(f.n for f in feats)
    finite = all(np.isfinite(np.stack([f.x, f.y, f.s, f.a11, f.a12, f.a21,
                                       f.a22, f.response])).all()
                 for f in feats)
    check(finite, "batch: non-finite keypoint fields")
    check(all(f.desc.dtype == np.uint8 and f.desc.shape == (f.n, 128)
              for f in feats), "batch: descriptor shape/type")
    check(n_desc > 0, "batch: no descriptors")
    check_dense_launches(launches, cfg, "batch")
    log(f"phase 4 batch {BATCH}x{HEIGHT}x{WIDTH}: {n_desc} descriptors, "
        f"wall {wall * 1000:.1f} ms/batch after one warm-up; funnel: "
        f"candidates {stats.num_candidates}, keypoints "
        f"{stats.num_keypoints}, affine {stats.num_affine}, described "
        f"{stats.num_described}; overflow: candidate "
        f"{stats.candidate_overflow}, bucket {stats.bucket_overflow}; "
        f"launches {launches}")

    t0 = time.perf_counter()
    cpu = extract_batch(torch.as_tensor(images_np[:1]), cfg)[0]
    log(f"  CPU plain run of image 0: {time.perf_counter() - t0:.1f} s")
    _gate(feats[0], cpu, "phase 4")
    return launches


def _image_features(d, b: int):
    """Image b's valid slots of DenseFeatures as host Features."""
    from hesaff_tpu_torch import Features

    m = (d.valid & (d.img_idx == b)).cpu().numpy()
    g = lambda k: getattr(d, k).cpu().numpy()[m]
    return Features(**{k: g(k) for k in Features._fields})


def phase_grouped(images_np, cfg, dev):
    """The serving path: dist.extraction_step_grouped with bench.py's
    group table (per-image cap 1024, batch 16).  Returns the launches,
    the card's DenseFeatures and the CPU run's of image 0."""
    import torch

    from hesaff_tpu_torch import dist

    groups = dist.default_group_spec(HEIGHT, WIDTH, cfg, per_image_cap=1024,
                                     batch=BATCH)
    images = torch.as_tensor(images_np, device=dev)
    dist.extraction_step_grouped(images, cfg, groups)     # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = dist.extraction_step_grouped(images, cfg, groups)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    n_valid = int(out.valid.sum())
    overflow = int(out.overflow)
    v = out.valid
    finite = all(bool(torch.isfinite(getattr(out, k)[v]).all())
                 for k in ("x", "y", "s", "a11", "a12", "a21", "a22"))
    check(finite, "grouped: non-finite keypoint fields")
    check(out.desc.dtype == torch.uint8 and tuple(out.desc.shape)
          == (v.numel(), 128), "grouped: descriptor shape/type")
    check(n_valid > 0, "grouped: no descriptors")
    check(overflow == 0, f"grouped: overflow {overflow}")
    check_dense_launches(launches, cfg, "grouped")
    log(f"phase 5 grouped {BATCH}x{HEIGHT}x{WIDTH}, groups {groups}: "
        f"{n_valid} valid descriptors in {v.numel()} slots, overflow "
        f"{overflow}, wall {wall * 1000:.1f} ms/batch after one warm-up, "
        f"{n_valid / wall:.0f} desc/s; launches {launches}")

    walls = []
    for _ in range(7):
        t0 = time.perf_counter()
        dist.extraction_step_grouped(images, cfg, groups)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    med = float(np.median(walls))
    log(f"  7 more batches: wall ms {[round(w, 3) for w in walls]}, median "
        f"{med:.3f} -> {n_valid / med * 1e3:.0f} desc/s")
    profile_grouped(images, cfg, groups)

    t0 = time.perf_counter()
    cpu = dist.extraction_step_grouped(torch.as_tensor(images_np[:1]), cfg,
                                       groups)
    log(f"  CPU plain grouped run of image 0: "
        f"{time.perf_counter() - t0:.1f} s")
    _gate(_image_features(out, 0), _image_features(cpu, 0), "phase 5")
    return launches, out, cpu


def phase_large(large_np, cfg, dev) -> dict:
    """extract_batch on two 12 MP frames: octave 0 takes the sparse
    path (K3 once per detection level for the whole batch), octaves 1
    and up the dense walk (K2).  Overflow of the capacities is counted
    and printed; image 0 is gated against a CPU run of the plain
    versions, with equal candidate and overflow counts."""
    import torch

    from hesaff_tpu_torch import extract_batch

    B, H, W = large_np.shape
    images = torch.as_tensor(large_np, device=dev)
    extract_batch(images, cfg)                        # warm-up
    torch.cuda.synchronize()
    walls, counts = [], []
    for _ in range(3):
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        feats, stats = extract_batch(images, cfg, return_stats=True)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        counts.append(read_counts())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = counts[0]
    check(all(c == launches for c in counts),
          f"large: launches differ between calls {counts}")
    for k, v in launches.items():
        check(v > 0, f"large: kernel {k} never launched on the path")
    check(launches["detect_maps"] == cfg.num_scales,
          f"large: K3 launched {launches['detect_maps']} times, not once "
          "per level of octave 0")
    n_dense = dense_octaves(H, W, cfg)
    check(launches["detect_walk"] == n_dense,
          f"large: K2 launched {launches['detect_walk']} times, not once "
          f"per dense octave ({n_dense})")
    check_k1_k6_launches(launches, H, W, cfg, "large")
    finite = all(np.isfinite(np.stack([f.x, f.y, f.s, f.a11, f.a12, f.a21,
                                       f.a22, f.response])).all()
                 for f in feats)
    check(finite, "large: non-finite keypoint fields")
    check(all(f.desc.dtype == np.uint8 and f.desc.shape == (f.n, 128)
              and f.n > 0 for f in feats), "large: descriptor shape/type")
    log(f"phase 6 large {B}x{H}x{W}: {sum(f.n for f in feats)} descriptors, "
        f"wall ms {[round(w, 3) for w in walls]}, median "
        f"{float(np.median(walls)):.3f} after one warm-up; peak allocated "
        f"{peak:.3f} GiB; funnel: candidates {stats.num_candidates}, "
        f"keypoints {stats.num_keypoints}, affine {stats.num_affine}, "
        f"described {stats.num_described}; overflow: candidate "
        f"{stats.candidate_overflow}, bucket {stats.bucket_overflow}; "
        f"launches per call {launches}")

    per_image = []
    for b in range(B):
        torch.cuda.reset_peak_memory_stats()
        fb, sb = extract_batch(images[b:b + 1], cfg, return_stats=True)
        check(fb[0].n == feats[b].n,
              f"large: image {b} alone {fb[0].n} != in batch {feats[b].n}")
        per_image.append(sb)
        log(f"  image {b} alone: {fb[0].n} descriptors, n_cand "
            f"{sb.num_candidates}, candidate_overflow "
            f"{sb.candidate_overflow}, bucket_overflow {sb.bucket_overflow}, "
            f"peak allocated "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    del images

    t0 = time.perf_counter()
    cpu, cs = extract_batch(large_np[:1], cfg, return_stats=True,
                            device="cpu")
    log(f"  CPU plain run of image 0: {time.perf_counter() - t0:.1f} s; "
        f"n_cand {cs.num_candidates}, candidate_overflow "
        f"{cs.candidate_overflow}, bucket_overflow {cs.bucket_overflow}")
    s0 = per_image[0]
    check(s0.num_candidates == cs.num_candidates,
          f"large: n_cand gpu {s0.num_candidates} cpu {cs.num_candidates}")
    check(s0.candidate_overflow == cs.candidate_overflow,
          f"large: candidate_overflow gpu {s0.candidate_overflow} cpu "
          f"{cs.candidate_overflow}")
    _gate(feats[0], cpu[0], "phase 6")
    return launches


def phase_after(images_np, dense, dense_cpu0, cfg, dev, card: str) -> dict:
    """Phase 7, after the descriptors: the path a user runs from an
    image to a verified match, a repeatability score, an Oxford file and
    a ranked list, on the card.  It uses phase 5's features of the 16
    bench images and one more image, bench image 0 cropped by CROP,
    whose homography to image 0 is an exact translation.  The path
    (extract() of the crop, match_descriptors, ransac_homography,
    repeatability, write_sift_file of every feature of phase 5, and
    rank_images of images 0-3 over the 16 images' index) runs once with
    the launch counts set to 0 just before it and read just after, then
    once more for its warm step times; each step's result is held
    against a CPU run, and knn2 at 27,774 x 27,774, RANSAC and the file
    write are timed."""
    import torch

    from hesaff_tpu_torch import extract, native
    from hesaff_tpu_torch.evaluate import features_to_ellipses, repeatability
    from hesaff_tpu_torch.match import knn2, match_descriptors
    from hesaff_tpu_torch.ransac import ransac_homography
    from hesaff_tpu_torch.retrieval import build_index, query_votes, rank_images
    from hesaff_tpu_torch.sift_io import (ellipse_abc, read_sift_file,
                                          write_sift_file, write_sift_python)

    (y0, y1), (x0, x1) = CROP
    crop = np.ascontiguousarray(images_np[0, y0:y1, x0:x1])
    Hc = np.array([[1.0, 0.0, -x0], [0.0, 1.0, -y0], [0.0, 0.0, 1.0]])
    feats = [_image_features(dense, b) for b in range(BATCH)]
    f0 = feats[0]
    v = dense.valid
    geo = [getattr(dense, k)[v] for k in ("x", "y", "s", "a11", "a12",
                                          "a21", "a22", "desc")]
    out_dir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "phase7.hesaff.sift")
    pts = lambda f, i: np.stack([f.x[i], f.y[i]], 1)
    ell = lambda f: features_to_ellipses(f, cfg.mr_size)

    def run_path():
        """The path once: its outputs and each step's host ms, the card
        synchronised around every step."""
        ms, out = {}, {}

        def step(name, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[name] = fn()
            torch.cuda.synchronize()
            ms[name] = (time.perf_counter() - t0) * 1e3
            return out[name]

        fc = step("extract", lambda: extract(crop, cfg, device=dev))
        i1, i2 = step("match", lambda: match_descriptors(f0.desc, fc.desc,
                                                         device=dev))
        step("ransac", lambda: ransac_homography(pts(f0, i1), pts(fc, i2),
                                                 device=dev))
        step("repeatability", lambda: repeatability(
            ell(f0), ell(fc), Hc, crop.shape, f0.desc, fc.desc,
            shape1=images_np[0].shape, device=dev))
        step("write", lambda: write_sift_file(path, *geo, cfg.mr_size))
        index = step("index", lambda: build_index([f.desc for f in feats]))
        step("rank", lambda: [rank_images(index, feats[q].desc, device=dev)
                              for q in range(4)])
        return out, ms

    reset_counts()
    out, cold = run_path()
    launches = read_counts()
    _, warm = run_path()
    fc, (i1, i2), res, rep = (out[k] for k in ("extract", "match", "ransac",
                                               "repeatability"))
    index, ranked = out["index"], out["rank"]
    H, W = crop.shape
    check_dense_launches(launches, cfg, "after", H, W)
    fmt = lambda d: ", ".join(f"{k} {v:.1f}" for k, v in d.items())
    log(f"phase 7 after the descriptors, image 0 ({f0.n}) and its crop "
        f"{CROP} ({H}x{W}, {fc.n} features): launches {launches}; the path "
        f"on {card}, host ms a step (synchronised), first run: {fmt(cold)} "
        f"(sum {sum(cold.values()):.1f}); second run: {fmt(warm)} (sum "
        f"{sum(warm.values()):.1f})")

    # knn2 of the match: bit-equal to a CPU run on the same descriptors
    same = True
    for a, b in ((f0.desc, fc.desc), (fc.desc, f0.desc)):
        g, c = knn2(a, b, device=dev), knn2(a, b, device="cpu")
        same &= all(bool(torch.equal(x.cpu(), y)) for x, y in zip(g, c))
    check(same, "after: knn2 on the card not bit-equal to the CPU run")
    c1, c2 = match_descriptors(f0.desc, fc.desc, device="cpu")
    check(np.array_equal(i1, c1) and np.array_equal(i2, c2),
          "after: match pairs differ from the CPU run")
    exact = int((np.abs(pts(f0, i1) - np.array([x0, y0])
                        - pts(fc, i2)).max(1) < 1e-3).sum())
    log(f"  match_descriptors: {len(i1)} tentative matches ({exact} at the "
        f"crop's offset within 1e-3 px); knn2 idx/dist/dist2 both ways "
        f"bit-equal to the CPU run: {same}; pairs equal: "
        f"{np.array_equal(i1, c1) and np.array_equal(i2, c2)}")

    # RANSAC: the translation at the crop's corners, and the CPU's count
    Hm = res.model.double().cpu().numpy()
    corners = np.array([[x0, y0, 1.0], [x1, y0, 1.0], [x0, y1, 1.0],
                        [x1, y1, 1.0]])
    proj = corners @ Hm.T
    err = float(np.abs(proj[:, :2] / proj[:, 2:] - corners[:, :2]
                       + np.array([x0, y0])).max())
    cpu_res = ransac_homography(pts(f0, i1), pts(fc, i2), device="cpu")
    n_g, n_c = int(res.num_inliers), int(cpu_res.num_inliers)
    check(err < 1.0, f"after: RANSAC translation off by {err} px at a "
          "corner")
    check(abs(n_g - n_c) <= max(1, 0.02 * n_c),
          f"after: RANSAC inliers card {n_g} CPU {n_c}")
    check(n_g >= 0.5 * len(i1), f"after: RANSAC kept {n_g} of {len(i1)}")
    log(f"  ransac_homography (1024 hypotheses): {n_g} inliers of "
        f"{len(i1)} (CPU run {n_c}); corner error {err:.4g} px (< 1)")

    # repeatability: the CPU extraction's value within 0.02
    f0c = _image_features(dense_cpu0, 0)
    fcc = extract(crop, cfg, device="cpu")
    rep_c = repeatability(ell(f0c), ell(fcc), Hc, crop.shape, f0c.desc,
                          fcc.desc, shape1=images_np[0].shape, device="cpu")
    check(abs(rep.repeatability - rep_c.repeatability) <= 0.02,
          f"after: repeatability card {rep.repeatability} CPU "
          f"{rep_c.repeatability}")
    log(f"  repeatability under the translation: card {rep.repeatability:.4f}"
        f" ({rep.num_correspondences} of n1 {rep.n1} / n2 {rep.n2}), "
        f"matching score {rep.matching_score:.4f} ({rep.num_matches}); CPU "
        f"extraction {rep_c.repeatability:.4f} ({rep_c.num_correspondences}"
        f"), matching score {rep_c.matching_score:.4f} (within 0.02)")

    # the Oxford file of the card's features: read back; the native and
    # Python writers byte-equal where the native library built
    n_valid = int(v.sum())
    back = read_sift_file(path)
    host = [t.cpu().numpy() for t in geo]
    check(len(back["u"]) == n_valid and np.array_equal(back["desc"],
                                                       host[-1]),
          "after: the file does not read back")
    check(np.abs(back["u"] - host[0]).max() <= 1e-3,
          "after: the file's u differ from x")
    e = ellipse_abc(*(np.asarray(a, np.float64)
                      for a in (host[3], host[4], host[5], host[6],
                                host[2])), cfg.mr_size)
    py = os.path.join(out_dir, "phase7_python.hesaff.sift")
    t0 = time.perf_counter()
    write_sift_python(py, host[0], host[1], *e, host[-1])
    py_ms = (time.perf_counter() - t0) * 1e3
    writer = "native" if native.available() else "Python (no native build)"
    with open(path, "rb") as fa, open(py, "rb") as fb:
        equal = fa.read() == fb.read()
    if native.available():
        check(equal, "after: native and Python writers differ")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        write_sift_file(path, *geo, cfg.mr_size)
        walls.append((time.perf_counter() - t0) * 1e3)
    write_ms = float(np.median(walls))
    log(f"  write_sift_file of {n_valid} card features ({writer} writer, "
        f"from CUDA tensors): {os.path.getsize(path)} bytes, read back; "
        f"native == Python bytes: {equal}; {write_ms:.3f} ms (host clock, "
        f"median of {[round(w, 3) for w in walls]}); Python writer "
        f"{py_ms:.1f} ms; {card}")

    # retrieval: each query ranks itself first, votes equal to the CPU's
    for q in range(4):
        votes_c = query_votes(index, feats[q].desc, device="cpu")[0]
        votes_g = query_votes(index, feats[q].desc, device=dev)[0]
        check(bool(ranked[q]) and ranked[q][0][0] == q,
              f"after: query {q} ranks {ranked[q][:1]} first")
        check(np.array_equal(votes_g, votes_c),
              f"after: query {q} votes differ from the CPU run")
    log(f"  rank_images over {index.n_images} images ({len(index.desc)} "
        f"descriptors), queries 0-3: tops {[r[:2] for r in ranked]}; votes "
        "equal to the CPU run")

    # times on the card
    allq = geo[-1].to(torch.float32)
    N = allq.shape[0]
    kms = notes["knn2_ms"] = timed(lambda: knn2(allq, allq, device=dev), 5)
    # query and database read once, idx / dist / dist2 written once
    flops = 2.0 * N * N * 128
    kb = bound(2 * nbytes(allq) + 3 * 4 * N, flops)
    p1t = torch.as_tensor(pts(f0, i1), dtype=torch.float32, device=dev)
    p2t = torch.as_tensor(pts(fc, i2), dtype=torch.float32, device=dev)
    rms = timed(lambda: ransac_homography(p1t, p2t), 5)
    log(f"  knn2 {N} x {N} on {card}: {kms:.3f} ms (CUDA events, 5 calls "
        f"after a warm-up); bound 2*N*M*128 = {flops:.3g} f32 operations "
        f"over 67 TFLOP/s = {kb['bound_ms']:.3f} ms ({kb['bound_by']}), "
        f"{kb['bound_ms'] / kms:.3f} of it")
    log(f"  ransac_homography, 1024 hypotheses, {len(i1)} points on {card}: "
        f"{rms:.3f} ms (CUDA events, 5 calls after a warm-up)")
    log(f"  write_sift_file, {n_valid} features on {card}: {write_ms:.3f} ms "
        "(host clock)")
    return launches


def _features_npz(path):
    from hesaff_tpu_torch import Features

    d = np.load(path)
    return Features(**{k: d[k] for k in Features._fields})


def _padded_agree(ref, got, what: str, dev) -> float:
    """tests/test_dist.py's padded-mode tolerance, got (padded run)
    against ref (unpadded): count within max(2, 3%), >= 97% of ref's
    keypoints within 0.25 px of one of got's, each of those with s
    within 5% (+ 1e-3).  Returns the matched share."""
    import torch

    check(abs(got.n - ref.n) <= max(2, 0.03 * ref.n),
          f"{what}: count padded {got.n} unpadded {ref.n}")
    if ref.n == 0:
        return 1.0
    a = torch.as_tensor(np.stack([ref.x, ref.y], 1), device=dev)
    b = torch.as_tensor(np.stack([got.x, got.y], 1), device=dev)
    d, j = [], []
    for s0 in range(0, a.shape[0], 4096):
        dist = torch.cdist(a[s0:s0 + 4096], b,
                           compute_mode="donot_use_mm_for_euclid_dist")
        v, i = dist.min(1)
        d.append(v)
        j.append(i)
    d = torch.cat(d).cpu().numpy()
    j = torch.cat(j).cpu().numpy()
    m = d < 0.25
    s_bad = int((np.abs(got.s[j[m]] - ref.s[m])
                 >= 0.05 * ref.s[m] + 1e-3).sum())
    check(m.sum() >= 0.97 * ref.n,
          f"{what}: matched {int(m.sum())} of {ref.n} < 97%")
    check(s_bad == 0, f"{what}: {s_bad} matched keypoints with s off > 5%")
    return float(m.mean())


def edge_witness(img, padded, hw, cfg, dev, stats_p, stats_u) -> str:
    """Where the padded run's candidates may differ from the unpadded
    run's, and a check that they differ nowhere else.

    Rebuilds both ladders octave by octave (the path's own K1) and takes
    each detection level's candidate mask from the path's own kernel (K3
    on octaves of 2^23 px or more, K2 below), the padded one with its
    true size, each held bit for bit against candidate_mask (the plain
    version, whose window tests/test_torch_padded.py holds against the
    JAX package's) on the same ladder.  The padded ladder blurs its padding where the unpadded
    one clamps at the true edge, so the DoH of the two differs near that
    edge.  Checks, per octave and level: the padded mask is empty outside
    the true window; the two masks are equal at every pixel whose 3x3x3
    DoH neighbourhood is bit-equal in both ladders; those pixels lie
    within 2 * (the ladder's tap radii) + 4 px of the true edge (the
    blurs' reach, carried to the next octave halved, plus the DoH and
    NMS stencils).  Over the octaves: each run's masks sum to its
    num_candidates, and the candidate overflow of the two runs differs by
    no more than the candidates (of either run) within a walk's reach
    (5 cells) of such a pixel or of a differing blur, where the walk,
    the level compaction and the dedup may go another way.  Returns the
    log line with the counts.
    """
    import torch
    import torch.nn.functional as F

    from hesaff_tpu_torch.batch import as_valid_hw
    from hesaff_tpu_torch.detect import SPARSE_PATH_PIXELS, candidate_mask
    from hesaff_tpu_torch.ops import cuda_detect
    from hesaff_tpu_torch.pyramid import (build_octave, ladder_taps,
                                          prepare_first_level)

    def differs(a, b):
        return (a != b) & ~(a.isnan() & b.isnan())

    def dilate(m, r):
        return F.max_pool2d(m.float()[:, None], 2 * r + 1, 1,
                            r)[:, 0] > 0

    def masks(o, vhw, what):
        levels = range(1, cfg.num_scales + 1)
        r = o.resps
        if r.shape[-2] * r.shape[-1] >= SPARSE_PATH_PIXELS:
            got = torch.stack([cuda_detect.detect_maps(
                r[:, l - 1], r[:, l], r[:, l + 1], cfg, vhw)[3]
                for l in levels], 1)
        else:
            got = cuda_detect.detect_walk_octave(r, o.blurs, cfg, vhw)[3]
        ref = torch.stack([candidate_mask(r[:, l - 1], r[:, l], r[:, l + 1],
                                          cfg, vhw) for l in levels], 1)
        check(torch.equal(got, ref), f"edge witness octave {octave}: the "
              f"kernel's {what} candidates differ from candidate_mask's")
        return got

    t = lambda a: torch.as_tensor(a[None], dtype=torch.float32, device=dev)
    cur_u, pd = prepare_first_level(t(img), cfg)
    cur_p, _ = prepare_first_level(t(padded), cfg)
    vhw = as_valid_hw([hw], dev) * (2 if cfg.upscale_input else 1)
    b = cfg.border
    reach_px = 2 * sum(len(k) // 2 for k in ladder_taps(cfg)) + 4
    n_p = n_u = zone_px = zone_p = zone_u = near = 0
    deepest = -1
    octave = 0
    fits = lambda x: (x.shape[-2] > cfg.min_octave_size
                      and x.shape[-1] > cfg.min_octave_size)
    while fits(cur_p) and fits(cur_u):
        ou, op = build_octave(cur_u, pd, cfg), build_octave(cur_p, pd, cfg)
        H, W = ou.resps.shape[-2:]
        h, w = (int(v) for v in vhw[0])
        check((H, W) == (h, w), f"edge witness octave {octave}: unpadded "
              f"{H}x{W}, true size {h}x{w}")
        mu, mp = masks(ou, None, "unpadded"), masks(op, vhw, "padded")
        rows = torch.arange(mp.shape[-2], device=dev)[:, None]
        cols = torch.arange(mp.shape[-1], device=dev)[None, :]
        outside = (rows >= h - b) | (cols >= w - b)
        check(not bool((mp & outside).any()),
              f"edge witness octave {octave}: padded candidates outside "
              "the true window")
        n_p += int(mp.sum())
        n_u += int(mu.sum())
        rd = differs(op.resps[..., :H, :W], ou.resps)
        bd = differs(op.blurs[..., :H, :W], ou.blurs)
        for l in range(1, cfg.num_scales + 1):
            nd = dilate(rd[:, l - 1] | rd[:, l] | rd[:, l + 1], 1)
            lp, lu = mp[:, l - 1, :H, :W], mu[:, l - 1]
            bad = int((differs(lp, lu) & ~nd).sum())
            check(bad == 0, f"edge witness octave {octave} level {l}: "
                  f"{bad} candidates differ where the DoH agrees")
            r, c = torch.nonzero(nd[0], as_tuple=True)
            if r.numel():
                deepest = max(deepest, int(torch.minimum(
                    h - 1 - r, w - 1 - c).max()))
            zone_px += int(nd.sum())
            zone_p += int((lp & nd).sum())
            zone_u += int((lu & nd).sum())
            walk = dilate(nd | dilate(bd[:, l], 1), 5)
            near += int((lp & walk).sum()) + int((lu & walk).sum())
        cur_u, cur_p = ou.next_first, op.next_first
        vhw = vhw // 2
        pd *= 2.0
        octave += 1
        del ou, op, mu, mp, rd, bd
    check(not fits(cur_p) and not fits(cur_u),
          f"edge witness: the octave counts differ after octave {octave}")
    check(deepest <= reach_px, f"edge witness: the DoH differs "
          f"{deepest} px inside the true edge, past {reach_px}")
    check((n_p, n_u) == (stats_p.num_candidates, stats_u.num_candidates),
          f"edge witness: masks sum to {n_p} / {n_u}, the runs counted "
          f"{stats_p.num_candidates} / {stats_u.num_candidates}")
    gap = abs(stats_p.candidate_overflow - stats_u.candidate_overflow)
    check(gap <= near, f"edge witness: candidate overflow differs by "
          f"{gap}, more than the {near} candidates within reach")
    return (f"DoH differs at {zone_px} px over {octave} octaves x "
            f"{cfg.num_scales} levels, at most {deepest} px inside the true "
            f"edge (bound {reach_px}); candidates there padded {zone_p}, "
            f"unpadded {zone_u}; equal elsewhere; candidates within a "
            f"walk's reach {near}, candidate overflow gap {gap}")


def _write_pgm(path: str, gray: np.ndarray) -> None:
    h, w = gray.shape
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (w, h))
        f.write(gray.tobytes())


def phase_fleet(fleet_rgb, large_np, cfg, dev, card: str) -> dict:
    """Phase 8, the fleet on the card: utils/fleet.extract_fleet over
    16 files of four true sizes, a 4000x3000 frame and a truncated file
    (batch_size 8, bench_config).  Returns its launches.  Checks: every
    kernel launched; the truncated file alone in `failed`; each file's
    .npz against its unpadded extract_batch on the card with the
    padded-mode tolerance; the 4000x3000 frame padded and unpadded,
    their candidates equal except where the padded ladder's DoH
    differs next to the true edge (edge_witness); the two lone images
    against a CPU fleet run with bench.py's gate; a resume that launches no
    kernel; `cli fleet` in a subprocess exiting 1 on the truncated
    file; `cli retrieve` over the output ranking the query's own file
    first.  Logs images/s and the host ms of each chunk's submit and
    drain."""
    import contextlib
    import io
    import shutil

    import torch

    from hesaff_tpu_torch import cli, extract_batch
    from hesaff_tpu_torch.sift_io import load_image_gray
    from hesaff_tpu_torch.utils import fleet

    sys.path.insert(0, GOLDEN)
    import gen_images

    root = os.path.join(ROOT, "build", "chip_smoke", "fleet")
    shutil.rmtree(root, ignore_errors=True)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir)
    paths = []
    for k, rgb in enumerate(fleet_rgb):
        h, w = rgb.shape[:2]
        paths.append(os.path.join(img_dir, f"f{k:02d}_{w}x{h}.ppm"))
        gen_images.write_ppm(paths[-1], rgb)
    big = os.path.join(img_dir, "big_4000x3000.pgm")
    rows, cols = FLEET_BIG
    _write_pgm(big, np.clip(np.rint(large_np[0, :rows, :cols]), 0, 255)
               .astype(np.uint8))
    bad = os.path.join(img_dir, "truncated.ppm")
    with open(bad, "wb") as f:
        f.write(b"P6\n10 10\n255\nshort")
    order = [paths[k] for k in FLEET_ORDER] + [big, bad]
    out = os.path.join(root, "out")
    base = lambda p: os.path.splitext(os.path.basename(p))[0]

    # host ms of each chunk's submit (phase A and the groups' launches,
    # with phase A's host syncs) and drain (copy out, or the overflow
    # rerun), through the module's own functions
    spans = []
    submit, drain = fleet._submit_chunk, fleet._drain_chunk

    def timed_submit(imgs, *a, **k):
        t0 = time.perf_counter()
        tok = submit(imgs, *a, **k)
        spans.append((f"submit {imgs.shape}", time.perf_counter() - t0))
        return tok

    def timed_drain(tok, *a, **k):
        # a grouped chunk whose capacities overflowed reruns through
        # extract_batch inside the drain
        over = int(tok[1].overflow) if tok[0] == "grouped" else 0
        t0 = time.perf_counter()
        feats = drain(tok, *a, **k)
        spans.append((f"drain {tok[0]}" + (f" (overflow {over}: rerun)"
                                           if over else ""),
                      time.perf_counter() - t0))
        return feats

    fleet._submit_chunk, fleet._drain_chunk = timed_submit, timed_drain
    try:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        cursor = fleet.extract_fleet(order, out, cfg, batch_size=8, log=log)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
    finally:
        fleet._submit_chunk, fleet._drain_chunk = submit, drain
    done = len(order) - 1
    check(sorted(cursor["done"]) == sorted(order[:-1]),
          f"fleet: done {len(cursor['done'])} of {done}")
    check(list(cursor["failed"]) == [bad],
          f"fleet: failed {list(cursor['failed'])}, not the truncated file")
    for k, v in launches.items():
        check(v > 0, f"fleet: kernel {k} never launched")
    log(f"phase 8 fleet of {done} images + 1 truncated on {card}: "
        f"{done / wall:.2f} images/s ({wall * 1e3:.1f} ms wall, batch_size "
        f"8, extract_batch for the lone images); failed "
        f"{[base(p) for p in cursor['failed']]}; launches {launches}; host "
        f"ms: " + "; ".join(f"{n} {v * 1e3:.1f}" for n, v in spans))

    # each file against its unpadded extract_batch on the card
    shares = []
    for size in range(len(FLEET_SIZES)):
        ks = [k for k in range(16) if k // 4 == size]
        imgs = np.stack([load_image_gray(paths[k]) for k in ks])
        ref = extract_batch(imgs, cfg, device=dev)
        for k, r in zip(ks, ref):
            got = _features_npz(os.path.join(out, base(paths[k]) + ".npz"))
            shares.append(_padded_agree(r, got, f"fleet {base(paths[k])}",
                                        dev))
    big_img = load_image_gray(big)
    padded, hw = fleet.pad_to_bucket(big_img)
    ru, su = extract_batch(big_img[None], cfg, return_stats=True, device=dev)
    rp, sp = extract_batch(padded[None], cfg, return_stats=True,
                           valid_hw=np.asarray([hw], np.int32), device=dev)
    got = _features_npz(os.path.join(out, base(big) + ".npz"))
    shares.append(_padded_agree(ru[0], got, "fleet 4000x3000", dev))
    check(got.n == rp[0].n, f"fleet 4000x3000: file {got.n}, padded run "
          f"{rp[0].n}")
    # the funnel: padded and unpadded candidates differ only where the
    # padded ladder's DoH differs, next to the true edge
    witness = edge_witness(big_img, padded, hw, cfg, dev, sp, su)
    torch.cuda.empty_cache()
    log(f"  each file against its unpadded extract_batch: matched share "
        f"min {min(shares):.4f}, mean {np.mean(shares):.4f} (>= 0.97); "
        f"4000x3000 padded to {padded.shape}: {got.n} features, candidates "
        f"{sp.num_candidates} (unpadded {su.num_candidates}), candidate "
        f"overflow {sp.candidate_overflow} ({su.candidate_overflow}); "
        f"edge witness: {witness}")

    # the lone images against a CPU fleet run of the same files
    cpu_dir = os.path.join(root, "out_cpu")
    t0 = time.perf_counter()
    alone = [paths[k] for k in FLEET_ALONE]
    cc = fleet.extract_fleet(alone, cpu_dir, cfg, batch_size=8, log=log,
                             device="cpu")
    check(sorted(cc["done"]) == sorted(alone), "fleet: CPU run incomplete")
    log(f"  CPU fleet run of {[base(p) for p in alone]}: "
        f"{time.perf_counter() - t0:.1f} s")
    for p in alone:
        _gate(_features_npz(os.path.join(out, base(p) + ".npz")),
              _features_npz(os.path.join(cpu_dir, base(p) + ".npz")),
              f"phase 8 {base(p)}")

    # resume: nothing to do, no kernel launched
    reset_counts()
    again = fleet.extract_fleet(order, out, cfg, batch_size=8, log=log)
    relaunch = read_counts()
    check(not any(relaunch.values()), f"fleet resume launched {relaunch}")
    check(sorted(again["done"]) == sorted(cursor["done"])
          and again["failed"] == cursor["failed"],
          "fleet resume changed the cursor")

    # cli fleet in a subprocess: exits 1 on the truncated file
    cli_out = os.path.join(root, "out_cli")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "hesaff_tpu_torch.cli", "fleet", paths[13],
         paths[14], bad, "--out-dir", cli_out], capture_output=True,
        text=True, timeout=600, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT))
    last = (r.stdout.strip().splitlines() or [""])[-1]
    check(r.returncode == 1 and last == "done=2 failed=1",
          f"cli fleet: rc {r.returncode}, {last!r}, {r.stderr[-500:]}")
    cli_s = time.perf_counter() - t0

    # cli retrieve over the fleet's output: the query's own file first
    q = paths[2]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["retrieve", q, "--db", out])
    top = buf.getvalue().split()
    check(rc == 0 and top[:1] == [base(q)],
          f"cli retrieve: rc {rc}, top {top[:2]}, not {base(q)}")
    log(f"  resume: launches {relaunch}, cursor unchanged; cli fleet "
        f"(subprocess, 2 images + the truncated file): rc "
        f"{r.returncode}, {last!r}, {cli_s:.1f} s; cli retrieve "
        f"{base(q)} over {done} files: top {top[:2]}")
    return launches


def phase_geometry(dev, card: str) -> None:
    """Phase 9, geometry on the card, each held against a CPU run:
    incremental_sfm on tests/test_sfm.py's scene (every frame registered,
    ATE < 0.15, rmse < 2e-3, the same frames as the CPU's); ba_solve
    (dense E) on 50 cameras and 5,000 points; the track form past 30,000
    observations (test_geom.py's 50 x 10,000 scene).  Each BA converges
    (rmse from > 1.5 to < 0.5 px, within 0.02 of the CPU's) and one LM
    step gives the same bits twice.  LM-step ms from CUDA events.  No
    kernel of the port runs here."""
    import torch

    from hesaff_tpu_torch import sfm
    from hesaff_tpu_torch.geom import ba

    sys.path.insert(0, TESTS)
    from _torch_scenes import ba_line_scene, sfm_scene

    reset_counts()
    tracks, K, rv_gt, tv_gt = sfm_scene()
    recs = {}
    for d in (dev, "cpu"):
        t0 = time.perf_counter()
        rec = sfm.incremental_sfm(tracks, K, ba_every=3, device=d)
        wall = time.perf_counter() - t0
        ate = sfm.absolute_trajectory_error(rec.cam_rvec, rec.cam_tvec,
                                            rv_gt, tv_gt)
        recs[str(d)] = (rec, ate, wall)
        check(len(rec.cam_rvec) == len(rv_gt),
              f"sfm on {d}: {len(rec.cam_rvec)} of {len(rv_gt)} frames")
        check(ate < 0.15 and rec.rmse < 2e-3,
              f"sfm on {d}: ATE {ate}, rmse {rec.rmse}")
    (g, ate_g, wg), (c, ate_c, wc) = recs[str(dev)], recs["cpu"]
    check(np.array_equal(g.frame_ids, c.frame_ids),
          f"sfm: frames {g.frame_ids} on the card, {c.frame_ids} on the CPU")
    log(f"phase 9 incremental_sfm, {len(tracks)} tracks over "
        f"{len(rv_gt)} frames on {card}: {len(g.cam_rvec)} registered, "
        f"{len(g.points)} points, ATE {ate_g:.5f} (< 0.15), rmse "
        f"{g.rmse:.3e} (< 2e-3), {wg:.2f} s; CPU run: {len(c.points)} "
        f"points, ATE {ate_c:.5f}, rmse {c.rmse:.3e}, {wc:.2f} s")

    for label, P, solve in (
            ("ba_solve (dense E)", BA_POINTS[0], ba.ba_solve),
            ("ba_solve_sharded (tracks, one device)", BA_POINTS[1],
             ba.ba_solve_sharded)):
        p, q = ba_line_scene(P, dev), ba_line_scene(P, "cpu")
        err0 = float(ba.reprojection_rmse(p))
        if solve is ba.ba_solve_sharded:
            tr = ba.problem_to_tracks(p)[0]
            segs = ba.tracks_segments(tr)
            one = lambda: ba._tracks_lm_step(tr, 1e-3, True, segs)
        else:
            segs = ba.problem_segments(p)
            one = lambda: ba._lm_step(p, 1e-3, True, segs)
        a, b = one(), one()
        same = all(bool(torch.equal(getattr(a[0], k), getattr(b[0], k)))
                   for k in ("cam_rvec", "cam_tvec", "points"))
        check(same and bool(torch.equal(a[1], b[1])),
              f"{label}: an LM step differs between two runs")
        step_ms = timed(one, 5)
        if solve is ba.ba_solve_sharded:
            notes["track_step_ms"] = step_ms
        t0 = time.perf_counter()
        _, err_g = solve(p, iterations=8)
        wall_g = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, err_c = solve(q, iterations=8)
        wall_c = time.perf_counter() - t0
        check(err0 > 1.5 and err_g < 0.5 and abs(err_g - err_c) < 0.02,
              f"{label}: rmse {err0} -> {err_g} (CPU {err_c})")
        log(f"  {label}, 50 cameras, {P} points, {p.cam_idx.numel()} "
            f"observations on {card}: rmse {err0:.4f} -> {err_g:.5f} px in "
            f"8 LM iterations ({wall_g:.2f} s), CPU {err_c:.5f} "
            f"({wall_c:.2f} s); one LM step {step_ms:.3f} ms (CUDA events, "
            f"5 steps after a warm-up), bit-equal on two runs: {same}")
    launches = read_counts()
    check(not any(launches.values()), f"geometry launched {launches}")


# phase 10: the pipeline's microbatch and a gloo rank's share of the bench
# batch; the drop-host barrier's timeout
PIPE_BATCH = 8
DROP_TIMEOUT_S = 10.0
_FEATURE_FIELDS = ("x", "y", "s", "a11", "a12", "a21", "a22", "response")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _verify(out, ref, label: str) -> None:
    """bench.py's on-chip parity gate (_verify_on_chip) between two
    DenseFeatures of one batch, over every image: count within 1%, >= 99%
    of ref's keypoints matched by (image, x, y, s) rounded to 0.01; for
    each of a11..a22 the matched keypoints' p99.5 <= 0.02 and at most
    0.2% of them off by more than 0.02; descriptor mean L1 <= 0.05 and
    <= 1.2% of keypoints with a bin off by more than 2."""
    pv, rv = out.valid.cpu().numpy(), ref.valid.cpu().numpy()
    h = lambda d, k, v: getattr(d, k).cpu().numpy()[v]
    n_p, n_r = int(pv.sum()), int(rv.sum())
    check(abs(n_p - n_r) <= 0.01 * max(n_r, 1),
          f"{label}: count {n_p} against {n_r}")
    keyed = lambda d, v: {
        (int(i), round(float(x), 2), round(float(y), 2), round(float(s), 2)): j
        for j, (i, x, y, s) in enumerate(zip(
            *(h(d, k, v) for k in ("img_idx", "x", "y", "s"))))}
    kp, kr = keyed(out, pv), keyed(ref, rv)
    common = sorted(set(kp) & set(kr))
    check(len(common) >= 0.99 * max(n_r, 1),
          f"{label}: geometry match {len(common)}/{n_r} below 99%")
    ip = np.asarray([kp[k] for k in common], np.int64)
    ir = np.asarray([kr[k] for k in common], np.int64)
    p995_max, loose_max = 0.0, 0.0
    for f in ("a11", "a12", "a21", "a22"):
        d = np.abs(h(out, f, pv)[ip] - h(ref, f, rv)[ir])
        p995 = float(np.quantile(d, 0.995)) if d.size else 0.0
        loose = float((d > 0.02).mean()) if d.size else 0.0
        check(p995 <= 0.02 and loose <= 0.002,
              f"{label}: {f} p99.5 {p995}, share off by > 0.02 {loose}")
        p995_max, loose_max = max(p995_max, p995), max(loose_max, loose)
    dd = np.abs(h(out, "desc", pv)[ip].astype(np.int32)
                - h(ref, "desc", rv)[ir].astype(np.int32))
    dmean = float(dd.mean()) if dd.size else 0.0
    frac = float((dd.max(axis=1) > 2).mean()) if dd.size else 0.0
    check(dmean <= 0.05 and frac <= 0.012,
          f"{label}: desc mean L1 {dmean}, kp with a bin off by > 2 {frac}")
    log(f"{label} (bench.py's verify, all images): count {n_p} against "
        f"{n_r} (within 1%), matched {len(common)}/{n_r} (>= 99%), a-field "
        f"p99.5 {p995_max:.4f} (<= 0.02), largest share off by > 0.02 "
        f"{loose_max:.4f} (<= 0.002), desc mean L1 {dmean:.4f} (<= 0.05), "
        f"kp with a bin off by > 2 {frac:.4f} (<= 0.012)")


def _phase10_rank(rank: int, port: int, in_path: str, out_path: str) -> None:
    """One of phase 10's two gloo ranks, both on cuda:0 (a spawned
    process): the sharded bucket step on its 8 bench images, ring_knn2 on
    its halves of phase 5's descriptors, sharded_query_votes of queries
    0-3, ba_solve_sharded twice on the 50 x 10,000 track scene, and the
    times of each (the ranks aligned by a barrier first)."""
    import torch

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, ROOT)
    sys.path.insert(0, TESTS)
    from hesaff_tpu_torch import dist
    from hesaff_tpu_torch.geom import ba
    from hesaff_tpu_torch.match import ring_knn2
    from hesaff_tpu_torch.retrieval import build_index, sharded_query_votes
    from _torch_scenes import ba_line_scene

    dev = torch.device("cuda", 0)
    inp = np.load(in_path)
    cfg = bench_config()
    dist.init_multihost(f"localhost:{port}", 2, rank, backend="gloo")
    group = dist.make_mesh()

    def align():
        torch.cuda.synchronize()
        torch.distributed.barrier(group)

    out = {}
    buckets = dist.default_bucket_spec(HEIGHT, WIDTH, cfg,
                                       per_image_cap=1024, batch=BATCH)
    step = dist.sharded_extraction_step(group, cfg, buckets)
    imgs = torch.as_tensor(inp["images"][rank * PIPE_BATCH:
                                         (rank + 1) * PIPE_BATCH], device=dev)
    step(imgs)                                        # warm-up
    align()
    t0 = time.perf_counter()
    feats = step(imgs)
    torch.cuda.synchronize()
    out["ext_ms"] = (time.perf_counter() - t0) * 1e3
    out.update({f"ext_{k}": v.cpu().numpy()
                for k, v in feats._asdict().items()})

    desc = inp["desc"].astype(np.float32)
    pad = (-len(desc)) % 2
    db = np.concatenate([desc, np.full((pad, 128), 1e6, np.float32)])
    q = np.concatenate([desc, np.zeros((pad, 128), np.float32)])
    half = len(db) // 2
    qs, ds = (torch.as_tensor(a[rank * half:(rank + 1) * half], device=dev)
              for a in (q, db))
    ring = lambda: ring_knn2(qs, ds, group)
    out["ring_ms"] = timed(ring, 3)
    m = ring()
    out.update({f"ring_{k}": v.cpu().numpy() for k, v in m._asdict().items()})

    per_image = [inp["desc"][inp["img_id"] == b] for b in range(BATCH)]
    index = build_index(per_image)
    out["votes"] = np.stack([sharded_query_votes(group, index, per_image[b],
                                                 device=dev)
                             for b in range(4)])

    p = ba_line_scene(BA_POINTS[1], dev)
    for run in range(2):
        sol, err = ba.ba_solve_sharded(p, mesh=group, iterations=8)
        out.update({f"ba{run}_rvec": sol.cam_rvec.cpu().numpy(),
                    f"ba{run}_tvec": sol.cam_tvec.cpu().numpy(),
                    f"ba{run}_points": sol.points.cpu().numpy(),
                    f"ba{run}_err": np.float64(err)})
    tracks = ba.problem_to_tracks(p, pad_points_multiple=2)[0]
    pl = tracks.points.shape[0] // 2
    mine = slice(rank * pl, (rank + 1) * pl)
    local = tracks._replace(points=tracks.points[mine],
                            cam_t=tracks.cam_t[mine],
                            uv_t=tracks.uv_t[mine], w_t=tracks.w_t[mine])
    segs = ba.tracks_segments(local)
    align()
    out["lm_step_ms"] = timed(
        lambda: ba._tracks_lm_step(local, 1e-3, True, segs, group), 5)
    np.savez(out_path, **out)
    torch.distributed.destroy_process_group()


def _join(procs, timeout_s: float) -> list:
    """Exit codes of spawned processes after at most timeout_s each; one
    still running is killed (its code is then negative)."""
    codes = []
    for p in procs:
        p.join(timeout_s)
        if p.is_alive():
            p.kill()
            p.join(30)
        codes.append(p.exitcode)
    return codes


def phase_multidevice(images_np, dense, cfg, dev, card: str) -> dict:
    """Phase 10, the multi-device slice at full width on one card.

    (a) extraction_step_staged on the 16 bench images with bench.py's
    bucket table (per-image cap 1024, batch 16): launches counted, image
    0 gated against a CPU run, and phase 5's grouped output held against
    it with bench.py's verify thresholds.  (b) PipelinedExtractor with
    both stages on this card (a stream each) over two microbatches of 8,
    each equal to the staged step of its microbatch; walls of the
    pipeline and of two sequential staged calls.  (c) a one-rank NCCL
    group in this process: sharded_extraction_step, ring_knn2 on phase
    5's descriptors and ba_solve_sharded on the 50 x 10,000 track scene
    bit-equal to their single-device forms.  (d) two gloo ranks sharing
    the card (spawned): the sharded step image by image against (a),
    ring_knn2 against knn2 (bit-equal but at ties), sharded_query_votes
    against query_votes, ba_solve_sharded against mesh=None and itself;
    then the drop-host protocol (tests/_torch_drophost_worker.py): rank
    1 wedges at round 1 of 3, rank 0 exits 17 after its barrier's
    timeout, the missing rounds are recomputed with knn2 and the union
    equals a dense run.  NCCL between separate cards is not run: one
    card takes one NCCL rank.  Returns (a)'s launches.
    """
    import torch

    from hesaff_tpu_torch import dist
    from hesaff_tpu_torch.geom import ba
    from hesaff_tpu_torch.match import knn2, ring_knn2
    from hesaff_tpu_torch.utils.fleet import host_barrier

    sys.path.insert(0, TESTS)
    import _torch_drophost_worker as dw
    from _torch_scenes import ba_line_scene

    # (a) the staged bucket step
    buckets = dist.default_bucket_spec(HEIGHT, WIDTH, cfg,
                                       per_image_cap=1024, batch=BATCH)
    images = torch.as_tensor(images_np, device=dev)
    dist.extraction_step_staged(images, cfg, buckets)     # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    staged = dist.extraction_step_staged(images, cfg, buckets)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    v = staged.valid
    n_valid, overflow = int(v.sum()), int(staged.overflow)
    check_dense_launches(launches, cfg, "staged")
    check(launches["patches_group"] == len(buckets),
          f"staged: K5 launched {launches['patches_group']} times, not once "
          f"a bucket ({len(buckets)})")
    check(all(bool(torch.isfinite(getattr(staged, k)[v]).all())
              for k in _FEATURE_FIELDS), "staged: non-finite fields")
    check(staged.desc.dtype == torch.uint8
          and tuple(staged.desc.shape) == (v.numel(), 128),
          "staged: descriptor shape/type")
    log(f"phase 10 staged bucket step {BATCH}x{HEIGHT}x{WIDTH}, "
        f"{len(buckets)} buckets up to {buckets[-1][0]} at full resolution: "
        f"{n_valid} valid descriptors in {v.numel()} slots, overflow "
        f"{overflow}, wall {wall * 1e3:.1f} ms after one warm-up on {card}; "
        f"launches {launches}")
    cpu_buckets = dist.default_bucket_spec(HEIGHT, WIDTH, cfg,
                                           per_image_cap=1024, batch=1)
    t0 = time.perf_counter()
    cpu = dist.extraction_step_staged(images_np[:1], cfg, cpu_buckets,
                                      device="cpu")
    log(f"  CPU plain staged run of image 0: {time.perf_counter() - t0:.1f}"
        f" s, overflow {int(cpu.overflow)}")
    check(overflow == int(cpu.overflow),
          f"staged: overflow {overflow}, CPU run {int(cpu.overflow)}")
    _gate(_image_features(staged, 0), _image_features(cpu, 0),
          "phase 10 staged")
    _verify(dense, staged, "phase 10 grouped (phase 5) against staged")

    # (b) the pipeline, both stages on this card
    b8 = dist.default_bucket_spec(HEIGHT, WIDTH, cfg, per_image_cap=1024,
                                  batch=PIPE_BATCH)
    mbs = [images_np[:PIPE_BATCH], images_np[PIPE_BATCH:]]
    pipe = dist.PipelinedExtractor(cfg, b8, devices=[dev, dev])
    list(pipe(mbs))                                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = list(pipe(mbs))
    torch.cuda.synchronize()
    wall_pipe = time.perf_counter() - t0
    t0 = time.perf_counter()
    refs = [dist.extraction_step_staged(mb, cfg, b8, device=dev)
            for mb in mbs]
    torch.cuda.synchronize()
    wall_seq = time.perf_counter() - t0
    for k, (out, ref) in enumerate(zip(outs, refs)):
        rv = ref.valid
        err = max(float((getattr(out, f)[rv] - getattr(ref, f)[rv]).abs()
                        .max()) for f in _FEATURE_FIELDS)
        check(bool(torch.equal(out.valid, rv)) and err <= 1e-5
              and bool(torch.equal(out.desc[rv], ref.desc[rv]))
              and int(out.overflow) == int(ref.overflow),
              f"pipeline: microbatch {k} differs from the staged step "
              f"(field error {err})")
    log(f"  PipelinedExtractor, stages A and B on {dev} (a stream each), 2 "
        f"microbatches of {PIPE_BATCH}: equal to the staged step (valid, "
        f"fields within 1e-5, descriptors, overflow); wall "
        f"{wall_pipe * 1e3:.1f} ms, two sequential staged calls "
        f"{wall_seq * 1e3:.1f} ms (host clock, after a warm-up; a record)")

    # (c) a one-rank NCCL group in this process
    descs = dense.desc[dense.valid].to(torch.float32)
    dense_nn = knn2(descs, descs)
    scene = ba_line_scene(BA_POINTS[1], dev)
    sol0, err0 = ba.ba_solve_sharded(scene, iterations=8)
    dist.init_multihost(f"localhost:{_free_port()}", 1, 0)
    try:
        group = dist.make_mesh()
        sh = dist.sharded_extraction_step(group, cfg, buckets)(images)
        same_ext = all(bool(torch.equal(a, b)) for a, b in zip(sh, staged))
        same_ring = all(bool(torch.equal(a, b))
                        for a, b in zip(ring_knn2(descs, descs, group),
                                        dense_nn))
        sol1, err1 = ba.ba_solve_sharded(scene, mesh=group, iterations=8)
        same_ba = err1 == err0 and all(
            bool(torch.equal(getattr(sol1, k), getattr(sol0, k)))
            for k in ("cam_rvec", "cam_tvec", "points"))
        backend = torch.distributed.get_backend(group)
        host_barrier("phase 10 nccl", timeout_s=DROP_TIMEOUT_S)
    finally:
        torch.distributed.destroy_process_group()
    check(same_ext, "NCCL: the sharded step differs from the unsharded one")
    check(same_ring, "NCCL: ring_knn2 differs from knn2")
    check(same_ba, "NCCL: ba_solve_sharded differs from mesh=None")
    log(f"  one-rank {backend} group on {dev}: sharded_extraction_step equal "
        f"to the staged step: {same_ext}; ring_knn2 {len(descs)}^2 bit-equal "
        f"to knn2: {same_ring}; ba_solve_sharded 50 x {BA_POINTS[1]} "
        f"bit-equal to mesh=None: {same_ba} (rmse {err1:.5f}); "
        f"host_barrier on its gloo side group passed")

    # (d) two gloo ranks sharing the card
    out_dir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    in_path = os.path.join(out_dir, "phase10_in.npz")
    vv = dense.valid.cpu().numpy()
    np.savez(in_path, images=images_np, desc=dense.desc.cpu().numpy()[vv],
             img_id=dense.img_idx.cpu().numpy()[vv])
    paths = [os.path.join(out_dir, f"phase10_rank{r}.npz") for r in range(2)]
    for path in paths:
        if os.path.exists(path):
            os.remove(path)
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_phase10_rank, args=(r, port, in_path,
                                                     paths[r]))
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    codes = _join(procs, 300)
    log(f"  two gloo ranks on {dev}: exit codes {codes}, "
        f"{time.perf_counter() - t0:.1f} s with their start-up")
    check(codes == [0, 0], f"gloo ranks exited {codes}")
    if codes == [0, 0]:
        _check_gloo_ranks([dict(np.load(path)) for path in paths], staged,
                          descs, dense_nn, sol0, err0, in_path, dev)

    ddir = os.path.join(out_dir, "drophost")
    os.makedirs(ddir, exist_ok=True)
    for f in os.listdir(ddir):
        os.remove(os.path.join(ddir, f))
    port = _free_port()
    procs = [ctx.Process(target=dw.run, args=(r, 2, port, ddir, 3, 1,
                                               "cuda:0", DROP_TIMEOUT_S))
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    code0 = _join(procs[:1], 120)[0]
    detect_s = time.perf_counter() - t0
    procs[1].kill()                                # the wedged host
    code1 = _join(procs[1:], 30)[0]
    check(code0 == 17, f"drop-host: rank 0 exited {code0}, not 17")
    cursor = {}
    if os.path.exists(os.path.join(ddir, "cursor_0.json")):
        with open(os.path.join(ddir, "cursor_0.json")) as f:
            cursor = json.load(f)
    check(cursor == {"completed": 1, "detected_drop_at": 1},
          f"drop-host: cursor {cursor}")
    same = True
    for r in range(3):
        q, db = dw.round_data(r, 2)
        want = knn2(q, db, device=dev).idx.cpu().numpy()
        if r < cursor.get("completed", 0):
            got = np.concatenate([np.load(os.path.join(
                ddir, f"round{r}_shard{k}.npy")) for k in range(2)])
        else:                                      # the restarted job
            got = knn2(q, db, device=dev).idx.cpu().numpy()
        same &= bool(np.array_equal(got, want))
    check(same, "drop-host: the restarted union differs from a dense run")
    log(f"  drop-host, 3 rounds of ring_knn2 on {dev}, rank 1 wedged at "
        f"round 1: rank 0 exit {code0} after {detect_s:.1f} s (start-up "
        f"and a {DROP_TIMEOUT_S:.0f} s barrier), rank 1 killed ({code1}); "
        f"cursor {cursor}; restarted union equal to dense knn2: {same}")
    return launches


def _check_gloo_ranks(res, staged, descs, dense_nn, sol0, err0, in_path,
                      dev) -> None:
    """Phase 10 (d)'s results of the two gloo ranks against the
    single-rank forms."""
    import torch

    from hesaff_tpu_torch.retrieval import build_index, query_votes

    keys = [k for k in res[0] if not k.endswith("_ms")]
    check(all(np.array_equal(res[1][k], res[0][k]) for k in keys
              if k.startswith(("ext_", "votes", "ba"))),
          "gloo: the ranks' gathered results differ")
    r0 = res[0]
    ref = {k: getattr(staged, k).cpu().numpy() for k in staged._fields}
    worst, same_img = 0.0, True
    for b in range(BATCH):
        mg = r0["ext_valid"] & (r0["ext_img_idx"] == b)
        mr = ref["valid"] & (ref["img_idx"] == b)
        if mg.sum() != mr.sum():
            same_img = False
            continue
        for f in _FEATURE_FIELDS:
            worst = max(worst, float(np.abs(r0[f"ext_{f}"][mg]
                                            - ref[f][mr]).max(initial=0)))
        same_img &= bool(np.array_equal(r0["ext_desc"][mg], ref["desc"][mr])
                         and np.array_equal(r0["ext_type"][mg],
                                            ref["type"][mr]))
    check(same_img and worst <= 1e-5,
          f"gloo: the sharded step differs from (a) (field error {worst})")
    check(int(r0["ext_overflow"]) == int(ref["overflow"]),
          f"gloo: overflow {int(r0['ext_overflow'])} against "
          f"{int(ref['overflow'])}")
    log(f"  sharded_extraction_step, {PIPE_BATCH} images a rank: every "
        f"image's keypoints equal to (a)'s (count, descriptors, type; "
        f"fields within {worst:g} <= 1e-5): {same_img}; overflow summed "
        f"{int(r0['ext_overflow'])}; wall {r0['ext_ms']:.1f} / "
        f"{res[1]['ext_ms']:.1f} ms (ranks 0 / 1)")

    M = len(descs)
    got = [np.concatenate([r[f"ring_{k}"] for r in res])[:M]
           for k in ("idx", "dist", "dist2")]
    want = [t.cpu().numpy() for t in dense_nn]
    ties = want[1] == want[2]
    same_d = all(np.array_equal(g, w) for g, w in zip(got[1:], want[1:]))
    same_i = bool(np.array_equal(got[0][~ties], want[0][~ties]))
    check(same_d and same_i, "gloo: ring_knn2 differs from knn2 off ties")
    log(f"  ring_knn2 {M} x {M} over 2 ranks: dist / dist2 bit-equal to "
        f"knn2: {same_d}; idx equal off ties: {same_i}; {int(ties.sum())} "
        f"ties (dist == dist2), {int((got[0] != want[0])[ties].sum())} of "
        f"them answered by another equal row (the ring keeps the shard it "
        f"visits first)")

    inp = np.load(in_path)
    per_image = [inp["desc"][inp["img_id"] == b] for b in range(BATCH)]
    index = build_index(per_image)
    want_v = np.stack([query_votes(index, per_image[b], device=dev)[0]
                       for b in range(4)])
    check(np.array_equal(r0["votes"], want_v),
          "gloo: sharded_query_votes differ from query_votes")
    log(f"  sharded_query_votes of images 0-3 over {BATCH} images: equal to "
        f"query_votes: {np.array_equal(r0['votes'], want_v)}")

    h = lambda t: t.cpu().numpy()
    twice = all(np.array_equal(r0[f"ba0_{k}"], r0[f"ba1_{k}"])
                for k in ("rvec", "tvec", "points", "err"))
    off = lambda k, f: float(np.abs(r0[f"ba0_{k}"]
                                    - h(getattr(sol0, f))).max())
    e_rot, e_tr = off("rvec", "cam_rvec"), off("tvec", "cam_tvec")
    e_pts = off("points", "points")
    err = float(r0["ba0_err"])
    check(twice, "gloo: two sharded BA runs differ")
    # tests/test_geom.py's bounds: rotations within 8e-3, points 6e-2
    check(abs(err - err0) <= 0.02 and e_rot <= 8e-3 and e_pts <= 6e-2,
          f"gloo: sharded BA rmse {err} (mesh=None {err0}), rotations off "
          f"by {e_rot}, points by {e_pts}")
    log(f"  ba_solve_sharded 50 x {BA_POINTS[1]} over 2 ranks: rmse "
        f"{err:.5f} (mesh=None {err0:.5f}, within 0.02), rotations within "
        f"{e_rot:.2e} (<= 8e-3), points within {e_pts:.2e} (<= 6e-2), "
        f"translations within {e_tr:.2e}; two runs bit-equal: {twice}")
    log(f"  times, host-staged through gloo on one card: ring pass "
        f"{M}^2 {r0['ring_ms']:.3f} / {res[1]['ring_ms']:.3f} ms (ranks 0 / "
        f"1, CUDA events, 3 passes) against knn2 {notes.get('knn2_ms', 0):.3f}"
        f" ms (phase 7); sharded LM step {r0['lm_step_ms']:.3f} ms against "
        f"{notes.get('track_step_ms', 0):.3f} ms on one rank (phase 9); "
        f"sharded extraction wall {r0['ext_ms']:.1f} ms")


_SPANS = ("phase A", "group ", "direct branch", "SIFT")


def profile_grouped(images, cfg, groups) -> None:
    """One batch of the serving path under torch.profiler: the device's
    busy time (the union of its kernel and copy intervals) and idle share
    of the batch's wall, device ms by kernel, and the host ms of each
    stage span of dist.py.  The profiler links a kernel to the PyTorch op
    that launched it, and the port's own kernels are launched outside
    any op, so device time is read by kernel, not by span."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from hesaff_tpu_torch import dist

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dist.extraction_step_grouped(images, cfg, groups)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    span = lambda e: (getattr(e, "is_user_annotation", False)
                      or e.name.startswith(_SPANS))
    work = [e for e in events
            if e.device_type == DeviceType.CUDA and not span(e)]
    busy, end = 0.0, None
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in work):
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    busy /= 1e3
    log(f"  profiled batch: wall {wall:.3f} ms, device busy {busy:.3f} ms, "
        f"idle share {1.0 - busy / wall:.3f}")
    spans = [(e.name, e.time_range.elapsed_us() / 1e3) for e in events
             if e.device_type == DeviceType.CPU and e.name.startswith(_SPANS)]
    log(f"  host ms by span (sum {sum(ms for _, ms in spans):.3f}): "
        + "; ".join(f"{name} {ms:.3f}" for name, ms in spans))
    per_kernel = {}
    for e in work:
        per_kernel[e.name] = (per_kernel.get(e.name, 0.0)
                              + e.time_range.elapsed_us() / 1e3)
    log("  device ms by kernel (top 10): " + "; ".join(
        f"{k[:60]} {v:.3f}"
        for k, v in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]))
    cat = {k: v for k, v in per_kernel.items() if "CatArray" in k}
    log(f"  device ms of torch.cat's kernels: {sum(cat.values()):.3f} "
        f"({len(cat)} kernel names)")
    # the port's kernels, each summed over its template instances (K5
    # has one a tile geometry)
    ours = (("K1", ("blur_doh_kernel",)), ("K2", ("detect_walk_kernel",)),
            ("K4", K4_KERNELS), ("K5", ("patches_kernel",)),
            ("K6", ("sift_kernel",)))
    of = lambda syms: sum(v for n, v in per_kernel.items()
                          if any(s in n for s in syms))
    log("  device ms of the port's kernels: " + ", ".join(
        f"{k} {of(syms):.3f}" for k, syms in ours))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    card = card_name_and_limit()
    log(f"phase 1 device: {card}")

    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            os.cpu_count() or 1, mp_context=ctx) as ex:
        futures = start_images(ex)            # made while nvcc builds
        try:
            phase_build()
            images_np, large_np, fleet_rgb = gather_images(futures)
        except BaseException:
            ex.shutdown(cancel_futures=True)
            raise
    check(images_np.shape == (BATCH, HEIGHT, WIDTH),
          f"bench imagery shape {images_np.shape}")
    check(large_np.shape == (LARGE_BATCH, LARGE_H, LARGE_W),
          f"large imagery shape {large_np.shape}")
    log(f"  imagery: bench {images_np.shape}, large {large_np.shape} "
        f"({LARGE_BATCH * TILES_Y * TILES_X} tiles) in "
        f"{time.perf_counter() - t0:.1f} s with the build")
    cfg = bench_config()
    walls = {}

    def run(phase: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[phase] = time.perf_counter() - t0
        log(f"  phase {phase} wall {walls[phase]:.1f} s")
        return out

    images = torch.as_tensor(images_np, device=dev)
    rec = run("2a", phase_kernels, images, cfg, card)
    run("2b", phase_group_kernels, images, cfg, rec)
    del images
    large = torch.as_tensor(large_np, device=dev)
    run("2c", phase_maps_kernel, large, cfg, rec)
    del large
    torch.cuda.empty_cache()
    run("3", phase_golden, dev)
    launches = {"4": run("4", phase_batch, images_np, cfg, dev)}
    launches["5"], dense, dense_cpu0 = run("5", phase_grouped, images_np,
                                           cfg, dev)
    launches["6"] = run("6", phase_large, large_np, cfg, dev)
    launches["7"] = run("7", phase_after, images_np, dense, dense_cpu0, cfg,
                        dev, card)
    del dense_cpu0
    launches["8"] = run("8", phase_fleet, fleet_rgb, large_np, cfg, dev,
                        card)
    run("9", phase_geometry, dev, card)
    launches["10"] = run("10", phase_multidevice, images_np, dense, cfg, dev,
                         card)
    del dense
    log("  phase walls (s): "
        + json.dumps({k: round(v, 1) for k, v in walls.items()}))
    if failures:
        log(f"chip_smoke: {len(failures)} check(s) failed")
        return 1
    log(card)
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches["6"][name],
                    **{f"launches_phase{p}": c[name]
                       for p, c in launches.items()}, **rec[name])
               for name, src, rep in KERNELS]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
