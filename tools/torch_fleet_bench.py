"""Fleet end-to-end benchmark of the PyTorch port: decode -> extract ->
export img/s.

Counterpart of tools/fleet_bench.py for hesaff_tpu_torch: the number a
user gets from `python -m hesaff_tpu_torch.cli fleet`.  A mixed-size
corpus of 8-bit gray PNGs on disk (tests/golden/gen_images.py, seeds
0..n-1, half at 800x640 and half at 640x512, shape-major), the native
prefetch loader (C++ decode + pad thread pool) feeding the checkpointed
extraction loop (utils/fleet.extract_fleet: the grouped path on a GPU,
extract_batch on the CPU), features written as .npz.  Reports img/s,
desc/s and the loader overlap (pure-decode time over the fleet's wall).

Differences from the JAX tool: the PNGs are written by a zlib + struct
writer (`write_png_gray`, no PIL), the corpus is made in a process pool
over os.cpu_count() workers and timed apart (`corpus_s`), `compile_s`
becomes `warmup_s` (one chunk of each shape bucket, the kernels' build
included), times are read after a synchronise of the device, and the
card's name and power limit are in the JSON.  `run` does the work over
a list of files that already exist.

Usage: python tools/torch_fleet_bench.py [--n 64] [--batch 8]
       [--device cpu] [--keep]
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import os
import shutil
import struct
import sys
import tempfile
import time
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests", "golden"))

import gen_images  # noqa: E402
from chip_smoke import Clock, card_name_and_limit  # noqa: E402

SIZES = ((800, 640), (640, 512))    # (width, height)


def write_png_gray(path: str, gray: np.ndarray) -> None:
    """An 8-bit gray (color type 0), non-interlaced PNG of a uint8
    (H, W) array: each row filter 0, one zlib stream in one IDAT."""
    gray = np.ascontiguousarray(gray, np.uint8)
    h, w = gray.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), gray], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))


def _corpus_file(path: str, width: int, height: int, seed: int) -> str:
    img = (gen_images.synth_image(width, height, seed=seed)
           .astype(np.float32).mean(axis=-1))
    write_png_gray(path, np.clip(np.round(img), 0, 255).astype(np.uint8))
    return path


def make_corpus(n: int, out_dir: str) -> list:
    """Write the n PNGs under out_dir in a spawned process pool; the
    paths, shape-major (all of one size first, as a real fleet orders
    them so that chunks stay shape-homogeneous)."""
    jobs = []
    for i in range(n):
        w, h = SIZES[i * len(SIZES) // n]
        jobs.append((os.path.join(out_dir, f"img_{i:04d}.png"), w, h, i))
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            os.cpu_count() or 1, mp_context=ctx) as ex:
        return list(ex.map(_corpus_file, *zip(*jobs)))


def run(paths, out_dir: str, batch: int, device, cfg=None,
        corpus_s: float = 0.0) -> dict:
    """The benchmark over existing image files: pure decode, one warm-up
    chunk of each padded shape, then extract_fleet(paths, out_dir)
    timed.  Returns the JSON record."""
    import torch

    from hesaff_tpu_torch import HesaffConfig, native
    from hesaff_tpu_torch.sift_io import load_image_gray
    from hesaff_tpu_torch.utils.fleet import (_extract_chunk, extract_fleet,
                                              pad_to_bucket)

    device = torch.device(device)
    cfg = cfg or HesaffConfig()
    clock = Clock(device)

    # pure-decode time (native loader, no device work)
    t0 = time.perf_counter()
    firsts = {}
    if native.available():
        with native.PrefetchLoader(paths) as loader:
            for p, img, _ in loader:
                if img is not None:
                    firsts.setdefault(img.shape, p)
    t_decode = time.perf_counter() - t0

    # one warm-up chunk of each padded shape: the path the fleet routes
    # through (_extract_chunk), so the timed run measures steady state
    if not firsts:
        for p in paths:
            firsts.setdefault(pad_to_bucket(load_image_gray(p))[0].shape, p)
    t0 = clock()
    for p in firsts.values():
        pad, hw = pad_to_bucket(load_image_gray(p))
        _extract_chunk(np.broadcast_to(pad, (batch,) + pad.shape).copy(),
                       np.asarray([hw] * batch, np.int32), cfg, device=device)
    warmup_s = clock() - t0

    t0 = clock()
    cursor = extract_fleet(paths, out_dir, cfg=cfg, batch_size=batch,
                           log=lambda m: None, prefetch=True, device=device)
    t_fleet = clock() - t0

    n_done = len(cursor["done"])
    n_desc = 0
    for p in cursor["done"]:
        base = os.path.splitext(os.path.basename(p))[0]
        with np.load(os.path.join(out_dir, base + ".npz")) as d:
            n_desc += len(d["x"])
    return {
        "metric": "fleet_end_to_end",
        "images": n_done,
        "failed": len(cursor["failed"]),
        "descriptors": n_desc,
        "img_per_s": n_done / t_fleet,
        "desc_per_s": n_desc / t_fleet,
        "fleet_wall_s": t_fleet,
        "pure_decode_s": t_decode,
        "decode_overlap_pct": 100.0 * min(1.0, t_decode / max(t_fleet, 1e-9)),
        "warmup_s": warmup_s,
        "corpus_s": corpus_s,
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "device": (card_name_and_limit() if device.type == "cuda"
                   else "cpu"),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="where to run (default: the GPU)")
    ap.add_argument("--keep", action="store_true",
                    help="keep the corpus/output dirs (debug)")
    args = ap.parse_args(argv)

    from hesaff_tpu_torch.pipeline import resolve_device

    device = resolve_device(None, args.device)
    tmp = tempfile.mkdtemp(prefix="torch_fleet_bench_")
    try:
        corpus = os.path.join(tmp, "corpus")
        os.makedirs(corpus)
        t0 = time.perf_counter()
        paths = make_corpus(args.n, corpus)
        corpus_s = time.perf_counter() - t0
        rec = run(paths, os.path.join(tmp, "out"), args.batch, device,
                  corpus_s=corpus_s)
    finally:
        if not args.keep:
            shutil.rmtree(tmp)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
