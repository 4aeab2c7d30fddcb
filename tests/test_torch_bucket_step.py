"""The port's bucket step (dist.extraction_step, also named
extraction_step_staged) against the JAX package's extraction_step_staged.

On test_pallas.py's B = 2 160x128 synthetic batch, and under
upscale_input (where the direct-warp branch runs inside the buckets) on
2 x 64x72: the same slot layout (per-bucket row-major compaction: equal
valid, img_idx and type, x and y within 0.01 px) and
test_torch_dist.py's feature bounds (one-to-one within 0.01 px, s within
1e-3 relative, descriptors within 1, overflow 0 in both).  The 0.01 px is
the agreement of the port's phase A with JAX's
(test_torch_pipeline.py).
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
CASES = {"plain": (CFG, 160, 128),
         "upscale": (dataclasses.replace(CFG, upscale_input=True), 64, 72)}


@pytest.fixture(scope="module", params=sorted(CASES))
def step_pair(request):
    cfg, H, W = CASES[request.param]
    imgs = np.stack([
        gen_images.synth_image(W, H, seed=s).astype(np.float32).mean(-1)
        for s in range(2)])
    buckets = jdist.default_bucket_spec(H, W, cfg, per_image_cap=512,
                                        batch=2)
    ref = jdist.extraction_step_staged(jnp.asarray(imgs), cfg, buckets)
    out = dist.extraction_step(imgs, port_cfg(cfg), buckets, device="cpu")
    return request.param, cfg, ref, out


def test_bucket_step_matches_jax(step_pair):
    name, cfg, ref, out = step_pair
    assert_same_features(ref, out)
    if name == "upscale":
        ov = n(out.valid).astype(bool)
        S = 2 * np.ceil(n(out.s)[ov] * cfg.mr_size).astype(np.int32) + 1
        assert (S / cfg.patch_size <= cfg.oversample_cutoff).any()


def test_bucket_step_slot_layout_matches_jax(step_pair):
    """Same slots in the same order: bucket after bucket, row-major."""
    _, _, ref, out = step_pair
    assert out.valid.shape == ref.valid.shape
    np.testing.assert_array_equal(n(out.valid), n(ref.valid))
    np.testing.assert_array_equal(n(out.img_idx), n(ref.img_idx))
    v = n(ref.valid).astype(bool)
    np.testing.assert_array_equal(n(out.type)[v], n(ref.type)[v])
    for k in ("x", "y"):
        np.testing.assert_allclose(n(getattr(out, k))[v],
                                   n(getattr(ref, k))[v], atol=0.01)


def test_staged_is_the_step():
    assert dist.extraction_step_staged is dist.extraction_step
