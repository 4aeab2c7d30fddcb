#!/usr/bin/env python3
"""A/B timing of the PyTorch port's kernels and stages on one GPU.

    python tools/torch_ab.py DIR [DIR ...]

Each DIR is the root of a checkout of the port (``hesaff_tpu_torch/``
beside ``tests/golden/gen_images.py``).  bench.py's 16 800x640 images
(seeds 0-15, channel mean) are made once; then, for each DIR in the
order given, a fresh process imports that checkout's package, builds
its kernels, and times after a warm-up, with one pair of CUDA events
around 20 calls, or where a device time is named, from torch.profiler
over 20 calls (chip_smoke.device_ms):

- ``ladder_ms``: pyramid.prepare_first_level + pyramid.build_octave of
  octave 0 (the blur ladder and DoH stacks as phase A builds them);
- ``k1_ms``: the blur + DoH kernel at the ladder's largest taps on the
  first level;
- ``k2_ms``: the walk kernel's device time in
  cuda_detect.detect_walk_octave over octave 0's three detection levels;
- ``sift_stage_ms``: dist.describe_valid over every slot of the grouped
  serving path (chip_smoke.py's configuration), its SIFT stage;
- ``k6_ms``: cuda_sift.sift_descriptors on the valid patches alone;
- ``k4_ms``: the affine kernel's device time in cuda_affine.adapt on
  every octave's keypoints as phase A makes them, one call an octave,
  summed (``k4_octave_ms`` lists them);
- ``k3_ms``: the maps kernel's device time in cuda_detect.detect_maps
  on the three detection levels of octave 0 of two 4032x3024 frames,
  mosaics of the 16 images (chip_smoke.py's phase 6 shape), summed;

and prints one JSON line with the DIR, the card's name and power limit,
and the times.  Give two checkouts in turns (A B B A) to see the spread
beside the difference.  Needs a CUDA device; there is no CPU mode.
"""

from __future__ import annotations

import concurrent.futures
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    """This checkout's chip_smoke.py, by path: its imagery, configuration
    and octave loop, run against whichever package is on sys.path."""
    spec = importlib.util.spec_from_file_location(
        "torch_ab_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _synth(seed: int) -> np.ndarray:
    return _smoke()._synth(seed)


def run_one(root: str, images_path: str) -> dict:
    """Times of one checkout; imports its package from `root`."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from hesaff_tpu_torch import dist, pyramid
    from hesaff_tpu_torch.ops import (cuda_affine, cuda_blur, cuda_detect,
                                      cuda_sift)
    from hesaff_tpu_torch.ops.hessian import norm2_of

    if not torch.cuda.is_available():
        raise SystemExit("torch_ab: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke = _smoke()
    timed = smoke.timed
    BATCH, HEIGHT, WIDTH = smoke.BATCH, smoke.HEIGHT, smoke.WIDTH
    cfg = smoke.bench_config()
    images_np = np.load(images_path)
    images = torch.as_tensor(images_np, device="cuda")
    out = {"root": root}
    out["ladder_ms"] = timed(lambda: pyramid.build_octave(
        *pyramid.prepare_first_level(images, cfg), cfg))
    first, pd = pyramid.prepare_first_level(images, cfg)
    taps = pyramid.ladder_taps(cfg)[-1]
    norm2 = norm2_of(pyramid.level_sigmas(cfg)[-1] ** 2)
    out["k1_ms"] = timed(lambda: cuda_blur.blur_doh(first, taps, norm2))
    o = pyramid.build_octave(first, pd, cfg)
    out["k2_ms"] = smoke.device_ms(lambda: cuda_detect.detect_walk_octave(
        o.resps, o.blurs, cfg), ("detect_walk_kernel",))
    del first, o

    groups = dist.default_group_spec(HEIGHT, WIDTH, cfg, per_image_cap=1024,
                                     batch=BATCH)
    flat, levels_a, _, ncap = dist.phase_a(images, cfg)
    cache, patches, valid = {}, [], []
    for bsize, prev, gi, a, v, _ in dist.group_selections(flat, cfg, groups,
                                                          ncap):
        pk, pok = dist.group_patches(images, cfg, bsize, prev, gi, a, v,
                                     levels_a, cache)
        patches.append(pk)
        valid.append(pok)
    patches, valid = torch.cat(patches), torch.cat(valid)
    out["slots"], out["valid"] = patches.shape[0], int(valid.sum())
    out["sift_stage_ms"] = timed(
        lambda: dist.describe_valid(patches, valid, cfg))
    pt = patches[valid].contiguous()
    out["k6_ms"] = timed(lambda: cuda_sift.sift_descriptors(pt, cfg))
    del patches, valid, pt, cache

    k4 = [smoke.device_ms(lambda: cuda_affine.adapt(*kargs),
                          smoke.K4_KERNELS)
          for kargs in smoke.octave_adapt_args(images, cfg)]
    out["k4_octave_ms"], out["k4_ms"] = k4, sum(k4)

    n_tiles = smoke.LARGE_BATCH * smoke.TILES_Y * smoke.TILES_X
    large = torch.as_tensor(smoke.mosaic(images_np[np.arange(n_tiles)
                                                   % BATCH]), device="cuda")
    o = pyramid.build_octave(*pyramid.prepare_first_level(large, cfg), cfg)
    r = o.resps
    out["k3_ms"] = sum(smoke.device_ms(lambda: cuda_detect.detect_maps(
        r[:, l - 1], r[:, l], r[:, l + 1], cfg), ("detect_maps_kernel",))
        for l in range(1, cfg.num_scales + 1))
    out["card"] = smoke.card_name_and_limit()
    return out


def main(argv) -> int:
    if len(argv) == 4 and argv[1] == "--one":
        print(json.dumps(run_one(argv[2], argv[3])), flush=True)
        return 0
    roots = argv[1:]
    if not roots:
        raise SystemExit(__doc__)
    smoke = _smoke()
    with concurrent.futures.ProcessPoolExecutor(os.cpu_count() or 1) as ex:
        images = np.stack(list(ex.map(_synth, range(smoke.BATCH))))
    path = os.path.join(HERE, "build", "torch_ab_images.npy")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.save(path, images)
    rc = 0
    for root in roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", root, path])
        rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv))
