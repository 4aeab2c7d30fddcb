"""The port's grouped serving path against the JAX package's.

default_group_spec and tail_source_plan equal JAX's; the port's
extraction_step_grouped on the CPU against JAX extraction_step_grouped
(its Pallas kernels in interpret mode) on test_pallas.py's B = 2
160x128 synthetic batch: equal valid counts, overflow 0 in both, equal
(x, y, s)-keyed sets and descriptors within one step (test_pallas.py's
grouped tolerances).  The key matches within 0.01 px and 1e-3 of s, the
agreement of the port's phase A with JAX's (test_torch_pipeline.py):
the two packages' float32 sums round differently, which moves a
keypoint by up to ~2e-3 px.  Under upscale_input the direct-warp branch
runs; there the port is held against JAX's XLA staged path, which
describes direct-branch keypoints the same way.
"""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from hesaff_tpu import dist as jdist
from hesaff_tpu.config import HesaffConfig
from hesaff_tpu_torch import dist
from _torch_parity import assert_same_features, n, port_cfg

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "golden"))
import gen_images  # noqa: E402

CFG = HesaffConfig()


def _synth(B, H, W):
    return np.stack([
        gen_images.synth_image(W, H, seed=s).astype(np.float32).mean(-1)
        for s in range(B)])


@pytest.mark.parametrize("H,W,cap,B", [
    (640, 800, 1024, 16), (160, 128, 512, 2), (480, 640, 512, 4),
    (2000, 3000, 512, 2), (13, 13, 512, 1)])
def test_group_spec_and_tail_plan_match_jax(H, W, cap, B):
    spec = dist.default_group_spec(H, W, port_cfg(CFG), cap, B)
    assert spec == jdist.default_group_spec(H, W, CFG, cap, B)
    for bsize, _ in spec:
        for base_pd in (1.0, 0.5):
            if bsize > dist.FULL_RES_GROUP_MAX:
                assert (dist.tail_source_plan(bsize, base_pd)
                        == jdist.tail_source_plan(bsize, base_pd))


def test_tail_plan_at_bench_size():
    assert dist.FULL_RES_GROUP_MAX == jdist._PALLAS_GROUP_MAX
    spec = dist.default_group_spec(640, 800, port_cfg(CFG), 1024, 16)
    assert [b for b, _ in spec] == [49, 97, 193, 385, 641, 1025]
    assert dist.tail_source_plan(641, 1.0) == (2.0, 1, 323)
    assert dist.tail_source_plan(1025, 1.0) == (4.0, 2, 259)


@pytest.fixture(scope="module")
def grouped_pair():
    B, H, W = 2, 160, 128
    imgs = _synth(B, H, W)
    groups = jdist.default_group_spec(H, W, CFG, per_image_cap=512, batch=B)
    ref = jdist.extraction_step_grouped(jnp.asarray(imgs), CFG, groups,
                                        interpret=True)
    out = dist.extraction_step_grouped(imgs, port_cfg(CFG), groups,
                                       device="cpu")
    return ref, out


def test_grouped_matches_jax(grouped_pair):
    assert_same_features(*grouped_pair)


def test_grouped_slot_layout_matches_jax(grouped_pair):
    """Same slots in the same order: per-group compaction, |a21| sort."""
    ref, out = grouped_pair
    assert out.valid.shape == ref.valid.shape
    np.testing.assert_array_equal(n(out.valid), n(ref.valid))
    np.testing.assert_array_equal(n(out.img_idx), n(ref.img_idx))
    v = n(ref.valid).astype(bool)
    np.testing.assert_array_equal(n(out.type)[v], n(ref.type)[v])
    for k in ("x", "y"):
        np.testing.assert_allclose(n(getattr(out, k))[v],
                                   n(getattr(ref, k))[v], atol=0.01)


def test_grouped_upscale_direct_branch_matches_jax_staged():
    cfg = dataclasses.replace(CFG, upscale_input=True)
    B, H, W = 2, 64, 72
    imgs = _synth(B, H, W)
    buckets = jdist.default_bucket_spec(H, W, cfg, per_image_cap=512,
                                        batch=B)
    groups = jdist.default_group_spec(H, W, cfg, per_image_cap=512, batch=B)
    ref = jdist.extraction_step_staged(jnp.asarray(imgs), cfg, buckets)
    out = dist.extraction_step_grouped(imgs, port_cfg(cfg), groups,
                                       device="cpu")
    ov = n(out.valid).astype(bool)
    S = 2 * np.ceil(n(out.s)[ov] * cfg.mr_size).astype(np.int32) + 1
    assert (S / cfg.patch_size <= cfg.oversample_cutoff).any()
    assert_same_features(ref, out)
