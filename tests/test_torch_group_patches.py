"""The fused patch pipeline's plain version against the JAX package.

extract_group against the JAX Pallas wrapper extract_group_pallas (run
in interpret mode) and against the XLA bucket path
extract_bucket_batch, on test_pallas.py's inputs plus two keypoints
whose patches touch the image border; extract_group_scaled against
extract_group_pallas_scaled (interpret) on test_pallas.py's 480x640
pyramid-tail inputs.  The port's extract_bucket_batch (its one route:
K5's plain version beside the direct warp) and the grouped path's
full-resolution tail group (tail_from_pyramid off) against JAX's
extract_bucket_batch.  Tolerances are the JAX tests': ok flags equal,
patches atol 1e-3.  scaled_first_level against JAX at atol 3e-4.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from hesaff_tpu import patches as jpat
from hesaff_tpu import pyramid as jpyr
from hesaff_tpu.config import HesaffConfig
from hesaff_tpu.ops import pallas_patches as jpp
from hesaff_tpu_torch import pyramid
from hesaff_tpu_torch.ops import cuda_patches
from _torch_parity import n, port_cfg, smooth_stacks, t

CFG = HesaffConfig()
PCFG = port_cfg(CFG)
_FIELDS = ("img_idx", "x", "y", "s", "a11", "a21", "a22", "active")


@pytest.fixture(scope="module")
def group_cases():
    """Per bucket: inputs, the JAX kernel's and bucket path's results."""
    rng = np.random.default_rng(3)
    B, H, W = 2, 240, 320
    images = smooth_stacks(rng, 1, B, H, W)[0]
    cases = {}
    for bucket, smin, smax, shear in ((49, 1.6, 4.2, 0.35),
                                      (97, 4.5, 8.8, 1.9)):
        K = 24
        kp = dict(
            img_idx=rng.integers(0, B, K).astype(np.int32),
            x=rng.uniform(40, W - 40, K).astype(np.float32),
            y=rng.uniform(40, H - 40, K).astype(np.float32),
            s=rng.uniform(smin, smax, K).astype(np.float32),
            a21=rng.normal(0, shear, K).astype(np.float32))
        d = np.exp(rng.normal(0, 0.25, K)).astype(np.float32)
        kp["a11"], kp["a22"] = d, (1.0 / d).astype(np.float32)
        kp["active"] = rng.uniform(size=K) > 0.2
        kp["x"][:2] = [3.0, W - 4.0]        # boundary-touching patches
        kp["active"][:2] = True
        j = {k: jnp.asarray(v) for k, v in kp.items()}
        jk = jpp.extract_group_pallas(
            jnp.asarray(images), bucket, j["img_idx"], j["x"], j["y"],
            j["s"], j["a11"], j["a21"], j["a22"], CFG, active=j["active"],
            interpret=True)
        jb = jpat.extract_bucket_batch(
            jnp.asarray(images), bucket, j["img_idx"], j["x"], j["y"],
            j["s"], j["a11"], jnp.zeros(K), j["a21"], j["a22"], CFG,
            active=j["active"])
        mine = cuda_patches.extract_group(
            t(images), bucket, *(t(kp[k]) for k in _FIELDS[:-1]), PCFG,
            t(kp["active"]))
        cases[bucket] = dict(kernel=jk, bucket=jb, mine=mine,
                             active=kp["active"])
    return cases


@pytest.mark.parametrize("bucket", [49, 97])
@pytest.mark.parametrize("ref", ["kernel", "bucket"])
def test_extract_group_matches_jax(group_cases, bucket, ref):
    c = group_cases[bucket]
    pk_ref, ok_ref = (n(a) for a in c[ref])
    pk, ok = (n(a) for a in c["mine"])
    ok_ref = ok_ref & c["active"]
    np.testing.assert_array_equal(ok, ok_ref)
    assert ok_ref.sum() >= 8 and not ok[:2].any()
    np.testing.assert_allclose(pk[ok], pk_ref[ok], atol=1e-3)


@pytest.fixture(scope="module")
def tail_images():
    rng = np.random.default_rng(11)
    return rng, smooth_stacks(rng, 1, 2, 480, 640)[0]


@pytest.mark.parametrize("octave", [1, 2])
def test_scaled_first_level_matches_jax(tail_images, octave):
    images = tail_images[1]
    ref = n(jpyr.scaled_first_level(jnp.asarray(images), CFG, octave))
    out = n(pyramid.scaled_first_level(t(images), PCFG, octave))
    assert out.shape == ref.shape == (2, 480 >> octave, 640 >> octave)
    np.testing.assert_allclose(out, ref, atol=3e-4)


def test_extract_group_scaled_matches_jax_kernel(tail_images):
    rng, images = tail_images
    B, H, W = images.shape
    half = n(jpyr.scaled_first_level(jnp.asarray(images), CFG, 1))
    K = 16
    kp = dict(
        img_idx=rng.integers(0, B, K).astype(np.int32),
        x=rng.uniform(250, W - 250, K).astype(np.float32),
        y=rng.uniform(220, H - 220, K).astype(np.float32),
        s=rng.uniform(19.0, 41.0, K).astype(np.float32),   # ws 200-430
        a21=rng.normal(0, 0.3, K).astype(np.float32))
    d = np.exp(rng.normal(0, 0.2, K)).astype(np.float32)
    kp["a11"], kp["a22"] = d, (1.0 / d).astype(np.float32)
    kp["active"] = np.ones(K, bool)
    kp["active"][-1] = False
    j = {k: jnp.asarray(v) for k, v in kp.items()}
    pk_ref, ok_ref = jpp.extract_group_pallas_scaled(
        jnp.asarray(half), 2.0, 323, j["img_idx"], j["x"], j["y"], j["s"],
        j["a11"], j["a21"], j["a22"], CFG, active=j["active"],
        orig_hw=(H, W), interpret=True)
    pk, ok = cuda_patches.extract_group_scaled(
        t(half), 2.0, 323, *(t(kp[k]) for k in _FIELDS[:-1]), PCFG,
        t(kp["active"]), orig_hw=(H, W))
    ok, ok_ref = n(ok), n(ok_ref)
    np.testing.assert_array_equal(ok, ok_ref)
    assert ok.sum() >= 8 and not ok[-1]
    np.testing.assert_allclose(n(pk)[ok], n(pk_ref)[ok], atol=1e-3)


@pytest.mark.parametrize("bucket,smin,smax,mr_size", [
    (49, 1.6, 4.2, CFG.mr_size),
    # a small measurement region mixes direct-warp keypoints in
    (25, 1.6, 2.9, 3.0)])
def test_bucket_routing_on_the_card_matches_plain_bucket_path(
        bucket, smin, smax, mr_size):
    """extract_bucket_batch's one route (blur branch through the fused
    patch pipeline, direct branch through direct_patches), run here on
    CPU tensors, against JAX's bucket path."""
    from hesaff_tpu_torch import patches
    from hesaff_tpu_torch.ops.cuda_patches import (direct_possible,
                                                   patch_geometry,
                                                   takes_direct)

    jcfg = dataclasses.replace(CFG, mr_size=mr_size)
    cfg = port_cfg(jcfg)
    rng = np.random.default_rng(7)
    B, H, W = 2, 240, 320
    images = smooth_stacks(rng, B, H, W)
    K = 32
    d = np.exp(rng.normal(0, 0.25, K)).astype(np.float32)
    kp = (rng.integers(0, B, K).astype(np.int32),
          rng.uniform(20, W - 20, K).astype(np.float32),
          rng.uniform(20, H - 20, K).astype(np.float32),
          rng.uniform(smin, smax, K).astype(np.float32), d,
          np.zeros(K, np.float32),
          rng.normal(0, 0.3, K).astype(np.float32),
          (1.0 / d).astype(np.float32))
    active = rng.uniform(size=K) > 0.2
    i = patches.BUCKET_SIZES.index(bucket)
    prev = patches.BUCKET_SIZES[i - 1] if i else 0
    ref_pk, ref_ok = (np.asarray(a) for a in jpat.extract_bucket_batch(
        jnp.asarray(images), bucket, *(jnp.asarray(a) for a in kp), jcfg,
        active=jnp.asarray(active), prev_bucket=prev))
    pk, ok = patches.extract_bucket_batch(
        t(images), bucket, *(t(a) for a in kp), cfg, active=t(active),
        prev_bucket=prev)
    mixed = direct_possible(cfg, prev)
    direct = n(takes_direct(patch_geometry(t(kp[3]), cfg)[2], cfg))
    assert direct.any() == mixed == (mr_size == 3.0)
    ref_ok = ref_ok & active
    np.testing.assert_array_equal(n(ok), ref_ok)
    assert ref_ok.sum() >= 8 and (not mixed or (ref_ok & direct).any())
    np.testing.assert_allclose(n(pk)[ref_ok], ref_pk[ref_ok], atol=1e-3)


def test_full_resolution_tail_group_matches_jax_bucket_path(tail_images):
    """With tail_from_pyramid off, dist.group_patches sends a group above
    FULL_RES_GROUP_MAX (641) through the full-resolution bucket path:
    against JAX's extract_bucket_batch on the same keypoints (equal ok,
    atol 1e-3), two of them too near the border for their patch."""
    from hesaff_tpu_torch import dist

    rng, images = tail_images
    B, H, W = images.shape
    K = 8
    d = np.exp(rng.normal(0, 0.05, K)).astype(np.float32)
    kp = dict(
        img_idx=rng.integers(0, B, K).astype(np.int32),
        x=rng.uniform(W / 2 - 60, W / 2 + 60, K).astype(np.float32),
        y=rng.uniform(H / 2 - 10, H / 2 + 10, K).astype(np.float32),
        s=rng.uniform(36.9, 39.0, K).astype(np.float32),  # ws 389-409
        a11=d, a12=np.zeros(K, np.float32),
        a21=rng.normal(0, 0.05, K).astype(np.float32),
        a22=(1.0 / d).astype(np.float32))
    kp["x"][:2] = [150.0, W - 150.0]        # patches over the border
    active = np.ones(K, bool)
    active[-1] = False
    jcfg = dataclasses.replace(CFG, tail_from_pyramid=False)
    cfg = port_cfg(jcfg)
    names = ("img_idx", "x", "y", "s", "a11", "a12", "a21", "a22")
    ref_pk, ref_ok = (np.asarray(a) for a in jpat.extract_bucket_batch(
        jnp.asarray(images), 641, *(jnp.asarray(kp[k]) for k in names),
        jcfg, active=jnp.asarray(active), prev_bucket=385))
    a = {k: t(kp[k]) for k in names[1:]}
    pk, ok = dist.group_patches(t(images), cfg, 641, 385, t(kp["img_idx"]),
                                a, t(active), [], {})
    ref_ok = ref_ok & active
    np.testing.assert_array_equal(n(ok), ref_ok)
    assert ref_ok.sum() >= 4 and not ref_ok[:2].any()
    np.testing.assert_allclose(n(pk)[ref_ok], ref_pk[ref_ok], atol=1e-3)
