"""The port's collection tools on the CPU, at a small size.

tools/torch_retrieval_bench.py's run at `--n 16 --queries 2 --batch 8
--width 128 --height 104 --cap 64 --device cpu`: the record has the
JAX tool's keys (compile_s renamed warmup_s, plus corpus_s, extract_s
and device), every query's source first, no overflow, and the
descriptor count of a direct run of the bucket step on the same corpus
(tests/test_torch_import.py runs the tool's main, JSON line included,
in a subprocess).  tools/torch_fleet_bench.py's run over
four 200x160 goldens (the oracle image and its three flips) written
as PNG: its JSON keys, no failure, and each file's .npz equal to a
direct padded extract_batch of the decoded images.  The tool's PNG
writer: its files decode, through native and sift_io.load_image_gray,
to the array written.
"""

import os
import sys

import numpy as np
import pytest

from hesaff_tpu_torch import HesaffConfig, dist, extract_batch, native
from hesaff_tpu_torch.sift_io import load_image_gray
from hesaff_tpu_torch.utils.fleet import pad_to_bucket

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import torch_fleet_bench  # noqa: E402
import torch_retrieval_bench  # noqa: E402

JAX_RETRIEVAL_KEYS = {"metric", "corpus", "descriptors", "extract_img_per_s",
                      "extract_desc_per_s", "query_latency_s",
                      "top1_accuracy", "overflow", "platform"}
JAX_FLEET_KEYS = {"metric", "images", "failed", "descriptors", "img_per_s",
                  "desc_per_s", "fleet_wall_s", "pure_decode_s",
                  "decode_overlap_pct", "platform"}
ADDED_KEYS = {"warmup_s", "corpus_s", "device"}


def test_retrieval_tool_end_to_end():
    n, H, W, B = 16, 104, 128, 8
    corpus = np.stack([torch_retrieval_bench.corpus_image(i, W, H)
                       for i in range(n)])
    plan = [(qi, torch_retrieval_bench.warp_query(corpus[qi], ang))
            for qi, ang in torch_retrieval_bench.query_plan(n, 2)]
    rec, det = torch_retrieval_bench.run(corpus, plan, B, 64, "cpu")
    assert set(rec) == JAX_RETRIEVAL_KEYS | ADDED_KEYS | {"extract_s"}
    assert rec["metric"] == "retrieval_bench" and rec["corpus"] == n
    assert rec["platform"] == "cpu" and rec["device"] == "cpu"
    assert rec["top1_accuracy"] == 1.0 and rec["overflow"] == 0
    assert [r[0][0] for _, r in det["ranked"]] == [qi for qi, _ in plan]
    assert min(rec[k] for k in ("warmup_s", "extract_s",
                                "query_latency_s")) > 0

    cfg = HesaffConfig()
    buckets = dist.default_bucket_spec(H, W, cfg, per_image_cap=64, batch=B)
    direct = [dist.extraction_step_staged(corpus[b:b + B], cfg, buckets,
                                          device="cpu") for b in (0, B)]
    assert rec["descriptors"] == sum(int(d.valid.sum()) for d in direct) > 0
    np.testing.assert_array_equal(det["batch0"].desc, direct[0].desc)


def test_query_protocol_is_the_jax_tools():
    """The seeded draws of tools/retrieval_bench.py: query ids without
    replacement, then one angle in [-0.15, 0.15] a query, in order."""
    rng = np.random.default_rng(0)
    qids = rng.choice(1024, size=32, replace=False)
    angles = [rng.uniform(-0.15, 0.15) for _ in qids]
    plan = torch_retrieval_bench.query_plan(1024, 32)
    assert [q for q, _ in plan] == list(qids)
    assert [a for _, a in plan] == angles
    img = torch_retrieval_bench.corpus_image(3, 64, 52)
    np.testing.assert_array_equal(torch_retrieval_bench.warp_query(img, 0.0),
                                  img)


def _golden_pngs(golden, tmp_path):
    g = np.clip(np.round(golden["gray"]), 0, 255).astype(np.uint8)
    paths = []
    for k, img in enumerate((g, g[:, ::-1], g[::-1], g[::-1, ::-1])):
        paths.append(str(tmp_path / f"golden_{k}.png"))
        torch_fleet_bench.write_png_gray(paths[-1], img)
    return paths, g


def test_png_writer_decodes_to_the_array(tmp_path, golden_small):
    paths, g = _golden_pngs(golden_small, tmp_path)
    with open(paths[1], "rb") as f:
        data = f.read()
    np.testing.assert_array_equal(native.decode_png_gray(data),
                                  g[:, ::-1].astype(np.float32))
    np.testing.assert_array_equal(load_image_gray(paths[1]),
                                  g[:, ::-1].astype(np.float32))
    edge = np.arange(256, dtype=np.uint8).reshape(4, 64)
    torch_fleet_bench.write_png_gray(str(tmp_path / "ramp.png"), edge)
    np.testing.assert_array_equal(load_image_gray(str(tmp_path / "ramp.png")),
                                  edge.astype(np.float32))


def test_fleet_tool_run(tmp_path, golden_small):
    paths, _ = _golden_pngs(golden_small, tmp_path)
    out = str(tmp_path / "out")
    rec = torch_fleet_bench.run(paths, out, batch=4, device="cpu")
    assert set(rec) == JAX_FLEET_KEYS | ADDED_KEYS
    assert rec["metric"] == "fleet_end_to_end" and rec["platform"] == "cpu"
    assert rec["images"] == 4 and rec["failed"] == 0

    padded = [pad_to_bucket(load_image_gray(p)) for p in paths]
    direct = extract_batch(np.stack([im for im, _ in padded]),
                           HesaffConfig(),
                           valid_hw=np.asarray([hw for _, hw in padded],
                                               np.int32), device="cpu")
    assert rec["descriptors"] == sum(f.n for f in direct) > 0
    for p, f in zip(paths, direct):
        base = os.path.splitext(os.path.basename(p))[0]
        with np.load(os.path.join(out, base + ".npz")) as d:
            np.testing.assert_array_equal(d["desc"], f.desc)
            np.testing.assert_array_equal(d["x"], f.x)


def test_tools_need_a_gpu_without_device():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for tool in (torch_retrieval_bench, torch_fleet_bench):
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            tool.main(["--n", "1"])
