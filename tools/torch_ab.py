#!/usr/bin/env python3
"""A/B timing of the PyTorch port's octave-0 ladder and SIFT stage on one GPU.

    python tools/torch_ab.py DIR [DIR ...]

Each DIR is the root of a checkout of the port (``hesaff_tpu_torch/``
beside ``tests/golden/gen_images.py``).  bench.py's 16 800x640 images
(seeds 0-15, channel mean) are made once; then, for each DIR in the
order given, a fresh process imports that checkout's package, builds
its kernels, and times after a warm-up, with one pair of CUDA events
around 20 calls:

- ``ladder_ms``: pyramid.prepare_first_level + pyramid.build_octave of
  octave 0 (the blur ladder and DoH stacks as phase A builds them);
- ``k1_ms``: the blur + DoH kernel at the ladder's largest taps on the
  first level;
- ``sift_stage_ms``: dist.describe_valid over every slot of the grouped
  serving path (chip_smoke.py's configuration), its SIFT stage;
- ``k6_ms``: cuda_sift.sift_descriptors on the valid patches alone;

and prints one JSON line with the DIR, the card's name and power limit,
and the times.  Give two checkouts in turns (A B B A) to see the spread
beside the difference.  Needs a CUDA device; there is no CPU mode.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np

BATCH, HEIGHT, WIDTH, REPS = 16, 640, 800, 20


def _synth(root: str, seed: int) -> np.ndarray:
    sys.path.insert(0, os.path.join(root, "tests", "golden"))
    import gen_images

    return (gen_images.synth_image(WIDTH, HEIGHT, seed=seed)
            .astype(np.float32).mean(axis=-1))


def _timed(fn) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(REPS):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / REPS


def run_one(root: str, images_path: str) -> dict:
    """Times of one checkout; imports its package from `root`."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from hesaff_tpu_torch import HesaffConfig, dist, pyramid
    from hesaff_tpu_torch.ops import cuda_blur, cuda_sift
    from hesaff_tpu_torch.ops.hessian import norm2_of

    if not torch.cuda.is_available():
        raise SystemExit("torch_ab: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(HesaffConfig(), candidate_cap_max=8192,
                              affine_cap_max=8192, candidate_cap_div=128,
                              affine_cap_div=256)
    images = torch.as_tensor(np.load(images_path), device="cuda")
    out = {"root": root}
    out["ladder_ms"] = _timed(lambda: pyramid.build_octave(
        *pyramid.prepare_first_level(images, cfg), cfg))
    first, _ = pyramid.prepare_first_level(images, cfg)
    taps = pyramid.ladder_taps(cfg)[-1]
    norm2 = norm2_of(pyramid.level_sigmas(cfg)[-1] ** 2)
    out["k1_ms"] = _timed(lambda: cuda_blur.blur_doh(first, taps, norm2))
    del first

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
    out["sift_stage_ms"] = _timed(
        lambda: dist.describe_valid(patches, valid, cfg))
    pt = patches[valid].contiguous()
    out["k6_ms"] = _timed(lambda: cuda_sift.sift_descriptors(pt, cfg))
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return out


def main(argv) -> int:
    if len(argv) == 4 and argv[1] == "--one":
        print(json.dumps(run_one(argv[2], argv[3])), flush=True)
        return 0
    roots = argv[1:]
    if not roots:
        raise SystemExit(__doc__)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with concurrent.futures.ProcessPoolExecutor(os.cpu_count() or 1) as ex:
        images = np.stack(list(ex.map(_synth, [here] * BATCH, range(BATCH))))
    path = os.path.join(here, "build", "torch_ab_images.npy")
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
