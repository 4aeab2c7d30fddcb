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
27,774 x 27,774 against its bound, RANSAC and the file write.  Exits
non-zero on any failed phase; on success the last line of standard
output is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

and the line before it holds the per-kernel record: launches in one
phase-6 call (every kernel runs there) and in phases 4, 5, 6 and 7
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
GOLDEN = os.path.join(ROOT, "tests", "golden")
BATCH, HEIGHT, WIDTH = 16, 640, 800
# phase 6: 12 MP frames, each a mosaic of TILES_Y x TILES_X bench-sized
# tiles cropped to LARGE_H x LARGE_W, seeds from LARGE_SEED on
LARGE_BATCH, LARGE_H, LARGE_W = 2, 3024, 4032
TILES_Y, TILES_X, LARGE_SEED = 5, 6, 1000
# phase 7: bench image 0 cropped by multiples of 64 px on each axis
# ((y0, y1), (x0, x1)), so every octave's sampling grid stays aligned and
# the crop's homography to image 0 is an exact translation
CROP = ((64, 576), (64, 736))

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


def start_images(ex):
    """Futures of the imagery, made in worker processes: bench.py's 16
    800x640 images (seeds 0..15, channel-mean gray) and the tiles of
    phase 6's mosaics (seeds LARGE_SEED on, unused by bench.py)."""
    n_tiles = LARGE_BATCH * TILES_Y * TILES_X
    return ([ex.submit(_synth, s) for s in range(BATCH)],
            [ex.submit(_synth, LARGE_SEED + k) for k in range(n_tiles)])


def mosaic(tiles: np.ndarray) -> np.ndarray:
    """(LARGE_BATCH * TILES_Y * TILES_X, HEIGHT, WIDTH) tiles, row-major
    in each frame, to the (LARGE_BATCH, LARGE_H, LARGE_W) frames."""
    large = tiles.reshape(LARGE_BATCH, TILES_Y, TILES_X, HEIGHT, WIDTH)
    large = large.transpose(0, 1, 3, 2, 4).reshape(
        LARGE_BATCH, TILES_Y * HEIGHT, TILES_X * WIDTH)
    return np.ascontiguousarray(large[:, :LARGE_H, :LARGE_W])


def gather_images(futures):
    bench, tiles = futures
    return (np.stack([f.result() for f in bench]),
            mosaic(np.stack([f.result() for f in tiles])))


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
    del ok, cell, tab, cand, pok, pcell, ptab, pcand, o
    phase_affine(images, cfg, rec, card)
    return rec


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
    e3, ms, pms, b3, f3, bit_equal = 0.0, 0.0, 0.0, 0, 0, True
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
    log(f"phase 2 detect_maps 3 x {tuple(o.resps[:, 1].shape)}: mask/nan/"
        f"edge equal, maps max err where mask {e3:.3g} (rtol 1e-6, atol "
        f"1e-5), all maps bit-equal: {bit_equal}; kernel {ms:.3f} device "
        f"ms, plain {pms:.3f} ms (3 levels)")
    rec["detect_maps"] = dict(max_abs_err=e3, ms=ms, plain_ms=pms,
                              all_maps_bit_equal=bit_equal, **bound(b3, f3))


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
    kms = timed(lambda: knn2(allq, allq, device=dev), 5)
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
            images_np, large_np = gather_images(futures)
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
    images = torch.as_tensor(images_np, device=dev)
    rec = phase_kernels(images, cfg, card)
    phase_group_kernels(images, cfg, rec)
    del images
    large = torch.as_tensor(large_np, device=dev)
    phase_maps_kernel(large, cfg, rec)
    del large
    torch.cuda.empty_cache()
    phase_golden(dev)
    launches = {"4": phase_batch(images_np, cfg, dev)}
    launches["5"], dense, dense_cpu0 = phase_grouped(images_np, cfg, dev)
    launches["6"] = phase_large(large_np, cfg, dev)
    launches["7"] = phase_after(images_np, dense, dense_cpu0, cfg, dev, card)
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
