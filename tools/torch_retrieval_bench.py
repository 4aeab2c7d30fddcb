"""Oxford5k-style retrieval benchmark of the PyTorch port (BASELINE config 4).

Counterpart of tools/retrieval_bench.py for hesaff_tpu_torch.  It
extracts features for a synthetic corpus (tests/golden/gen_images.py,
seeds 0..n-1, channel-mean gray), builds the descriptor index, runs
vote-ranked queries (each a rotation-warped corpus image, angle drawn
in [-0.15, 0.15] rad; its source must rank first among rank_images'
top 5) and prints one JSON line: corpus size, extraction throughput,
query latency, top-1 accuracy and the capacity overflow.  On a GPU the
batches take the grouped serving path (dist.extraction_step_grouped,
default_group_spec); on the CPU the bucket step
(dist.extraction_step_staged, default_bucket_spec), as the JAX tool
picks its path by backend.

It differs from the JAX tool in four ways:

  * the corpus, and the warped queries, are made before any timed
    window, in a process pool over os.cpu_count() workers, and
    `corpus_s` is reported apart from `extract_s` (the JAX tool
    synthesises each image inside its timed loops, ~0.08 s a 256x208
    image on one core, which bounds its img/s);
  * the index stays on the device (DescriptorIndex.desc is a float32
    tensor there), so knn2 does not copy it to the card every query;
  * times are read after a synchronise of the device; the card's name
    and power limit are in the JSON, and `compile_s` becomes
    `warmup_s`, the first batch with the kernels' build;
  * a query image is extracted alone, as a batch of one, not as
    `batch` copies (the JAX tool's fixed compiled shape).

Usage:  python tools/torch_retrieval_bench.py [--n 1024] [--queries 32]
        [--batch 32] [--width 256 --height 208] [--cap 256]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests", "golden"))

import gen_images  # noqa: E402
from chip_smoke import Clock, card_name_and_limit  # noqa: E402

QUERY_PAD = 256       # queries padded to a multiple of this many rows
SENTINEL = 1e6        # padding rows: d1 ~ d2, so the ratio test drops them


def corpus_image(i: int, width: int, height: int) -> np.ndarray:
    return (gen_images.synth_image(width, height, seed=int(i))
            .astype(np.float32).mean(axis=-1))


def make_corpus(n: int, width: int, height: int) -> np.ndarray:
    """(n, height, width) float32 corpus, made in a spawned process
    pool."""
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            os.cpu_count() or 1, mp_context=ctx) as ex:
        return np.stack(list(ex.map(corpus_image, range(n),
                                    [width] * n, [height] * n)))


def warp_query(img: np.ndarray, angle: float) -> np.ndarray:
    """img rotated by `angle` about its centre, bilinear (the JAX tool's
    query warp)."""
    H, W = img.shape
    c, s = np.cos(angle), np.sin(angle)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    cx, cy = W / 2, H / 2
    sx = c * (xx - cx) - s * (yy - cy) + cx
    sy = s * (xx - cx) + c * (yy - cy) + cy
    x0 = np.clip(sx.astype(np.int32), 0, W - 2)
    y0 = np.clip(sy.astype(np.int32), 0, H - 2)
    fx = np.clip(sx - x0, 0, 1)
    fy = np.clip(sy - y0, 0, 1)
    return ((1 - fy) * ((1 - fx) * img[y0, x0] + fx * img[y0, x0 + 1])
            + fy * ((1 - fx) * img[y0 + 1, x0] + fx * img[y0 + 1, x0 + 1])
            ).astype(np.float32)


def query_plan(n: int, queries: int):
    """[(source image, angle)] of the JAX tool's seeded protocol."""
    rng = np.random.default_rng(0)
    qids = rng.choice(n, size=queries, replace=False)
    return [(int(qi), float(rng.uniform(-0.15, 0.15))) for qi in qids]


def extraction_step(height: int, width: int, batch: int, cap: int, cfg,
                    device):
    """The per-batch extraction of the benchmark on `device`."""
    from hesaff_tpu_torch import dist

    if device.type == "cuda":
        groups = dist.default_group_spec(height, width, cfg,
                                         per_image_cap=cap, batch=batch)
        return lambda im: dist.extraction_step_grouped(im, cfg, groups)
    buckets = dist.default_bucket_spec(height, width, cfg,
                                       per_image_cap=cap, batch=batch)
    return lambda im: dist.extraction_step_staged(im, cfg, buckets)


def query_descriptors(out):
    """Image 0's valid descriptors of a step's output as float32 on its
    device, padded with SENTINEL rows to a multiple of QUERY_PAD."""
    import torch

    q = out.desc[out.valid & (out.img_idx == 0)].to(torch.float32)
    pad = (-q.shape[0]) % QUERY_PAD
    if pad:
        q = torch.cat([q, q.new_full((pad, q.shape[1]), SENTINEL)])
    return q


def run(corpus: np.ndarray, plan, batch: int, cap: int, device, cfg=None,
        corpus_s: float = 0.0):
    """The benchmark over a made corpus.

    corpus: (n, H, W) float32 with n a multiple of `batch`; plan:
    [(source, warped query image)].  Returns (the JSON record, details:
    `batch0` the first batch's DenseFeatures, `index` the
    DescriptorIndex, `ranked` each query's (source, rank_images list)).
    """
    import torch

    from hesaff_tpu_torch import HesaffConfig
    from hesaff_tpu_torch.retrieval import DescriptorIndex, rank_images

    device = torch.device(device)
    cfg = cfg or HesaffConfig()
    n, H, W = corpus.shape
    if n % batch:
        raise ValueError(f"corpus of {n} images is not a multiple of the "
                         f"batch {batch}")
    step = extraction_step(H, W, batch, cap, cfg, device)
    clock = Clock(device)
    as_batch = lambda a: torch.as_tensor(a, device=device)

    t0 = clock()
    batch0 = step(as_batch(corpus[:batch]))
    warmup_s = clock() - t0

    # fixed-capacity contract: overflow is counted and reported, never
    # silent (it would drop keypoints from the index)
    descs, owners = [], []
    n_overflow = 0
    t0 = clock()
    for b0 in range(0, n, batch):
        out = step(as_batch(corpus[b0:b0 + batch]))
        descs.append(out.desc[out.valid])
        owners.append(b0 + out.img_idx[out.valid].cpu().numpy())
        n_overflow += int(out.overflow)
    index = DescriptorIndex(desc=torch.cat(descs).to(torch.float32),
                            image_id=np.concatenate(owners).astype(np.int32),
                            n_images=n)
    extract_s = clock() - t0
    n_desc = int(index.desc.shape[0])

    ranked = []
    hits = 0
    t0 = clock()
    for qi, img in plan:
        out = step(as_batch(img[None]))
        n_overflow += int(out.overflow)
        r = rank_images(index, query_descriptors(out), top_k=5,
                        device=device)
        ranked.append((qi, r))
        hits += bool(r) and r[0][0] == qi
    query_s = (clock() - t0) / max(1, len(plan))

    rec = {
        "metric": "retrieval_bench",
        "corpus": n,
        "descriptors": n_desc,
        "extract_img_per_s": n / extract_s,
        "extract_desc_per_s": n_desc / extract_s,
        "query_latency_s": query_s,
        "top1_accuracy": hits / max(1, len(plan)),
        "overflow": n_overflow,
        "warmup_s": warmup_s,
        "corpus_s": corpus_s,
        "extract_s": extract_s,
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "device": (card_name_and_limit() if device.type == "cuda"
                   else "cpu"),
    }
    return rec, {"batch0": batch0, "index": index, "ranked": ranked}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--queries", type=int, default=32)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=208)
    ap.add_argument("--cap", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="where to run (default: the GPU)")
    args = ap.parse_args(argv)

    from hesaff_tpu_torch.pipeline import resolve_device

    device = resolve_device(None, args.device)
    n = (args.n + args.batch - 1) // args.batch * args.batch
    t0 = time.perf_counter()
    corpus = make_corpus(n, args.width, args.height)
    plan = [(qi, warp_query(corpus[qi], ang))
            for qi, ang in query_plan(n, args.queries)]
    corpus_s = time.perf_counter() - t0
    rec, _ = run(corpus, plan, args.batch, args.cap, device,
                 corpus_s=corpus_s)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
