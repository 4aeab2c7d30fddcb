"""Affine patch normalisation: warp, anti-alias blur, P x P subsample.

Port of ``hesaff_tpu/patches.py`` (AffineShape::normalizeAffine of the
reference).  Keypoints are grouped by workspace size into static
buckets.  One route on every device: extract_bucket_batch sends a
bucket's blur-branch keypoints through ops/cuda_patches.extract_group
(the fused patch kernel K5 on a CUDA tensor, its plain twin on a CPU
tensor: the clamped ws x ws workspace warp, then the OpenCV anti-alias
blur and the bilinear subsample at (ws >> 1) + i * imageToPatchScale
folded into one operator) and its direct-branch keypoints
(imageToPatchScale <= oversample_cutoff) through direct_patches, a
P x P warp with no smoothing.  A keypoint's patch geometry (S, ws,
imageToPatchScale) and the direct-branch rule live in ops/cuda_patches
(patch_geometry, direct_possible, takes_direct).

Padded mode: with valid_hw, the (B, 2) true sizes of edge-padded
images, the corner pre-check uses each keypoint's image's true size;
the warp's own out-of-source flag keeps the padded dimensions, as in
the JAX package (``hesaff_tpu/patches.py:240-255``).
"""

from __future__ import annotations

import torch

from hesaff_tpu_torch.config import HesaffConfig
from hesaff_tpu_torch.ops.cuda_patches import (direct_possible,
                                               extract_group, patch_geometry,
                                               takes_direct)
from hesaff_tpu_torch.ops.warp import check_borders, clamped_warp, true_dims

BUCKET_SIZES = (
    25, 33, 41, 49, 65, 81, 97, 129, 161, 193, 257, 321, 385, 513,
    641, 769, 1025, 1281, 1537, 2049,
)

# elements of one chunk's (chunk, P, P) direct warp
_CHUNK_ELEMS = 1 << 22


def extract_bucket_batch(images: torch.Tensor, bucket: int, img_idx,
                         x, y, s, a11, a12, a21, a22, cfg: HesaffConfig,
                         active=None, prev_bucket: int = 0, valid_hw=None):
    """Patches for keypoints assigned to one workspace bucket.

    images: (B, H, W); the other arguments (K,) per keypoint (images may
    differ).  active: (K,) bool, real slots (others are not computed).
    prev_bucket: the next smaller bucket size, which bounds whether this
    bucket can hold direct-branch keypoints.  The frame must be
    rectified (a12 == 0).  valid_hw: None, or (B, 2) true sizes of
    edge-padded images, for the corner pre-check.  Returns (patches (K,
    P, P), ok (K,)) with ok = False where the patch touches the image
    boundary.  A blur-branch bucket raises ValueError at an even patch
    side, on any device.
    """
    P = cfg.patch_size
    if active is None:
        active = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    if takes_direct((bucket - 2) / P, cfg):     # even the bucket's largest
        return direct_patches(images, img_idx, x, y, s, a11, a21, a22, cfg,
                              active, valid_hw)
    if P % 2 == 0:
        raise ValueError(
            f"patch_size {P} is even: the bucket path's blur branch "
            f"subsamples P + 1 points a side (i in [-P/2, P/2]); use an "
            f"odd patch_size, or dist.extraction_step_grouped")
    direct = torch.zeros_like(active)
    if direct_possible(cfg, prev_bucket):
        direct = takes_direct(patch_geometry(s, cfg)[2], cfg)
    pk, ok = extract_group(images, bucket, img_idx, x, y, s, a11, a21, a22,
                           cfg, active & ~direct, valid_hw)
    if bool((active & direct).any()):
        dp, dok = direct_patches(images, img_idx, x, y, s, a11, a21, a22,
                                 cfg, active & direct, valid_hw)
        pk = torch.where(direct[:, None, None], dp, pk)
        ok = torch.where(direct, dok, ok)
    return pk, ok


def extract_bucket(image: torch.Tensor, bucket: int, x, y, s, a11, a12,
                   a21, a22, cfg: HesaffConfig):
    """Patches of one image's keypoints in one bucket: image (H, W), the
    rest (K,) (single-image form of extract_bucket_batch).  Returns
    (patches (K, P, P), ok (K,))."""
    idx = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    return extract_bucket_batch(image[None], bucket, idx, x, y, s, a11, a12,
                                a21, a22, cfg)


def direct_patches(images: torch.Tensor, img_idx, x, y, s, a11, a21, a22,
                   cfg: HesaffConfig, active, valid_hw=None):
    """Direct-warp branch: a P x P warp with A * imageToPatchScale and no
    smoothing, for keypoints with imageToPatchScale <= oversample_cutoff.

    Arguments as extract_bucket_batch's (rectified frame).  Returns
    (patches (K, P, P), ok (K,)).
    """
    P = cfg.patch_size
    B, H, W = images.shape
    S, _, its = patch_geometry(s, cfg)
    corner_bad = check_borders(*true_dims(valid_hw, img_idx, H, W), P, P, x,
                               y, a11 * its, 0.0, a21 * its, a22 * its)
    K = x.shape[0]
    patches = torch.zeros((K, P, P), dtype=torch.float32, device=x.device)
    touched = torch.zeros(K, dtype=torch.bool, device=x.device)
    sel = active.nonzero(as_tuple=True)[0]
    chunk = max(1, _CHUNK_ELEMS // (P * P))
    for start in range(0, sel.numel(), chunk):
        ii = sel[start:start + chunk]
        itss = its[ii]
        patches[ii], touched[ii] = clamped_warp(
            images, img_idx[ii], P, x[ii], y[ii], a11[ii] * itss,
            a21[ii] * itss, a22[ii] * itss, torch.full_like(S[ii], P))
    return patches, active & ~corner_bad & ~touched
