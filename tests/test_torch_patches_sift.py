"""Patch extraction and SIFT of the PyTorch port against the JAX package.

Patches: extract_bucket_batch against JAX at atol 1e-3 with equal ok
flags (test_pallas.py's patch tolerance).  SIFT: within one
quantisation step of the oracle on its own patches with >= 99.9% exact
(test_sift.py), and within one step of JAX on random patches with > 99%
exact (test_pallas.py's SIFT tolerance).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hesaff_tpu import patches as jpat
from hesaff_tpu import sift as jsift
from hesaff_tpu.config import HesaffConfig
from hesaff_tpu_torch import patches, sift
from hesaff_tpu_torch.ops import cuda_patches
from _torch_parity import n, port_cfg, smooth_stacks, t

CFG = HesaffConfig()
PCFG = port_cfg(CFG)


@pytest.mark.parametrize("bucket,smin,smax,shear,cfg", [
    (49, 1.6, 4.2, 0.35, CFG),
    (97, 4.5, 8.8, 1.9, CFG),
    # a small measurement region puts keypoints under the oversample
    # cutoff: the direct-warp branch, per keypoint inside a mixed bucket
    (25, 1.6, 2.9, 0.3, dataclasses.replace(CFG, mr_size=3.0)),
])
def test_extract_bucket_batch_matches_jax(bucket, smin, smax, shear, cfg):
    rng = np.random.default_rng(3)
    B, H, W = 2, 240, 320
    images = smooth_stacks(rng, B, H, W)
    K = 24
    img_idx = rng.integers(0, B, K).astype(np.int32)
    x = rng.uniform(60, W - 60, K).astype(np.float32)
    y = rng.uniform(60, H - 60, K).astype(np.float32)
    x[:2] = [3.0, W - 4.0]                  # boundary-touching patches
    s = rng.uniform(smin, smax, K).astype(np.float32)
    a21 = rng.normal(0, shear, K).astype(np.float32)
    a11 = np.exp(rng.normal(0, 0.25, K)).astype(np.float32)
    a22 = (1.0 / a11).astype(np.float32)
    a12 = np.zeros(K, np.float32)
    active = rng.uniform(size=K) > 0.2
    ws = n(cuda_patches.patch_geometry(t(s), port_cfg(cfg))[1])
    assert ws.max() <= bucket
    args = (img_idx, x, y, s, a11, a12, a21, a22)
    pk_ref, ok_ref = jpat.extract_bucket_batch(
        jnp.asarray(images), bucket, *(jnp.asarray(a) for a in args), cfg,
        active=jnp.asarray(active))
    pk, ok = patches.extract_bucket_batch(
        t(images), bucket, *(t(a) for a in args), port_cfg(cfg),
        active=t(active))
    ro = n(ok_ref) & active
    np.testing.assert_array_equal(n(ok), ro)
    assert ro.sum() >= 8
    np.testing.assert_allclose(n(pk)[ro], n(pk_ref)[ro], atol=1e-3)


def test_bucket_helpers_match_jax():
    """The port's patch geometry (ops/cuda_patches) against JAX's
    patch_image_size, bucket_for, _min_workspace and _device_gauss_taps;
    the bucket of a workspace as extract_batch picks it
    (torch.bucketize over BUCKET_SIZES, past the last: above every
    bucket)."""
    s = np.linspace(0.5, 300.0, 97).astype(np.float32)
    S, ws, its = cuda_patches.patch_geometry(t(s), PCFG)
    ref = np.asarray(jpat.patch_image_size(s, CFG.mr_size))
    np.testing.assert_array_equal(n(S), ref)
    np.testing.assert_array_equal(n(ws), ref + 2)
    np.testing.assert_array_equal(
        n(its), (ref.astype(np.float32) / np.float32(CFG.patch_size)))
    w = t(np.int32([3, 25, 26, 2049, 2050]))
    which = n(torch.bucketize(w, t(np.int32(patches.BUCKET_SIZES))))
    got = [patches.BUCKET_SIZES[i] if i < len(patches.BUCKET_SIZES) else -1
           for i in which]
    assert got == [jpat.bucket_for(int(v)) for v in n(w)]
    assert cuda_patches.min_workspace(PCFG) == jpat._min_workspace(CFG)
    sig = t(np.float32([0.7, 2.2, 9.1]))
    ks = t(np.int32([5, 15, 55]))
    np.testing.assert_allclose(
        n(cuda_patches._device_gauss_taps(sig, ks, 61)),
        np.stack([n(jpat._device_gauss_taps(jnp.float32(a), jnp.int32(b),
                                            61))
                  for a, b in zip(n(sig), n(ks))]), rtol=1e-6, atol=1e-7)


def test_sift_on_golden_patches(golden_small):
    gp = golden_small["patches"].reshape(-1, 41, 41)
    mine = n(sift.sift_descriptors(t(gp), PCFG))
    diff = np.abs(mine - golden_small["descriptors"])
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.999


def test_sift_matches_jax_on_random_patches():
    rng = np.random.default_rng(5)
    p = np.clip(smooth_stacks(rng, 150, 41, 41), 0, 255).astype(np.float32)
    p[0] = 55.0                              # flat: photometric no-op
    ref = np.asarray(jsift.sift_descriptors(jnp.asarray(p), CFG))
    out = n(sift.sift_descriptors(t(p), PCFG))
    fin = np.isfinite(ref).all(axis=1)
    np.testing.assert_array_equal(np.isfinite(out).all(axis=1), fin)
    diff = np.abs(ref[fin] - out[fin])
    assert diff.max() <= 1
    assert (diff == 0).mean() > 0.99
