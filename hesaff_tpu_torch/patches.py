"""Affine patch normalisation: warp, anti-alias blur, 41x41 subsample.

Port of ``hesaff_tpu/patches.py`` (AffineShape::normalizeAffine of the
reference).  Keypoints are grouped by workspace size into static
buckets; for each keypoint the bucket x bucket workspace warp clamps its
output index to the true workspace extent ws = patchImageSize + 2 (so
the blur's edge replication reproduces BORDER_REPLICATE on the true
workspace), the workspace is blurred with per-keypoint OpenCV taps
masked to a static maximum width, and the patch is a bilinear subsample
at (ws >> 1) + i * imageToPatchScale.  Keypoints with
imageToPatchScale <= oversample_cutoff take the direct warp instead.

The JAX package samples with one-hot matmuls (slow gathers on a TPU);
here every sample is a direct 4-tap gather, and the keypoints of a
bucket run in chunks that bound chunk * bucket^2.  Only active slots
are computed.

Padded mode: with valid_hw, the (B, 2) true sizes of edge-padded
images, the corner pre-check uses each keypoint's image's true size;
the warp's own out-of-source flag keeps the padded dimensions, as in
the JAX package (``hesaff_tpu/patches.py:240-255``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from hesaff_tpu_torch.config import HesaffConfig
from hesaff_tpu_torch.ops.linalg import fdiv
from hesaff_tpu_torch.ops.warp import check_borders

BUCKET_SIZES = (
    25, 33, 41, 49, 65, 81, 97, 129, 161, 193, 257, 321, 385, 513,
    641, 769, 1025, 1281, 1537, 2049,
)

# elements of one chunk's (chunk, bucket, bucket) workspace
_CHUNK_ELEMS = 1 << 22


def patch_image_size(s: np.ndarray, mr_size: float) -> np.ndarray:
    """patchImageSize = 2*int(ceil(s*mrSize))+1 (host, numpy)."""
    mr_scale = np.ceil(np.asarray(s, np.float32) * np.float32(mr_size))
    return (2 * mr_scale.astype(np.int64) + 1).astype(np.int32)


def bucket_for(ws: int) -> int:
    """Smallest bucket size >= ws; -1 when ws exceeds every bucket."""
    for b in BUCKET_SIZES:
        if b >= ws:
            return b
    return -1


def _max_ksize_for_bucket(bucket: int, patch_size: int,
                          smooth_factor: float) -> int:
    """Upper bound on the OpenCV blur kernel width in this bucket."""
    its_max = (bucket - 2) / patch_size
    size = int(2.0 * 3.0 * smooth_factor * its_max + 1.0)
    if size % 2 == 0:
        size += 1
    return size


def _device_gauss_taps(sigma, ksize, kmax: int):
    """Per-keypoint sampled Gaussian taps masked to ksize, normalised.

    sigma, ksize: (K,) tensors; kmax: static odd width.  Returns (K, kmax).
    """
    rmax = kmax // 2
    off = torch.arange(-rmax, rmax + 1, dtype=torch.float32,
                       device=sigma.device)
    r_true = (ksize // 2).float()[:, None]
    sg = sigma[:, None]
    w = torch.exp(-(off * off) / (2.0 * sg * sg))
    w = torch.where(off.abs() <= r_true, w, 0.0)
    return w / w.sum(dim=1, keepdim=True)


def true_dims(valid_hw, img_idx, H: int, W: int):
    """(h, w) of the corner pre-check: the padded H, W, or each
    keypoint's image's true size from valid_hw (B, 2)."""
    if valid_hw is None:
        return H, W
    vhw = valid_hw.to(img_idx.device)[img_idx.long()]
    return vhw[:, 0], vhw[:, 1]


def _min_workspace(cfg: HesaffConfig) -> int:
    """Lower bound on any keypoint's workspace side ws = S + 2."""
    pd_min = 0.5 if cfg.upscale_input else 1.0
    s_min = (cfg.initial_sigma * cfg.sigma_step
             * 2.0 ** (-cfg.final_shift_limit / cfg.num_scales) * pd_min)
    return 2 * int(math.ceil(s_min * cfg.mr_size)) + 3


def _warp(images, img_idx, n: int, x, y, a11, a21, a22, ws):
    """Clamped-index n x n warp of the rectified (a12 == 0) frame.

    Output index q in [0, n) reads grid offset min(q, ws-1) - (ws >> 1),
    so q >= ws replicates the last true row/column.  Returns
    (out (K, n, n), touched (K,)) where touched means some sample fell
    outside the image (it then reads 0).
    """
    B, H, W = images.shape
    q = torch.arange(n, device=x.device)
    half = (ws >> 1).float()[:, None]
    eff = torch.minimum(q[None, :], (ws - 1)[:, None]).float() - half
    wx = x[:, None] + eff * a11[:, None]                     # (K, n) cols
    wy = ((y[:, None, None] + eff[:, None, :] * a21[:, None, None])
          + eff[:, :, None] * a22[:, None, None])             # (K, n, n)
    x0f = torch.floor(wx)
    fx = (wx - x0f)[:, None, :]
    y0f = torch.floor(wy)
    fy = wy - y0f
    valid = (((x0f >= 0) & (x0f < W - 1))[:, None, :]
             & (y0f >= 0) & (y0f < H - 1))
    x0 = x0f.clamp(0, W - 2).long()[:, None, :]
    y0 = y0f.clamp(0, H - 2).long()
    flat = images.reshape(-1)
    base = img_idx.long()[:, None, None] * (H * W) + y0 * W + x0
    xa = (1.0 - fx) * flat[base] + fx * flat[base + 1]
    xb = (1.0 - fx) * flat[base + W] + fx * flat[base + W + 1]
    val = (1.0 - fy) * xa + fy * xb
    out = torch.where(valid, val, 0.0)
    return out, (~valid).flatten(1).any(dim=1)


def _blur(ws_img, taps):
    """Per-keypoint separable shift-and-add blur, replicate border.

    ws_img: (K, n, n); taps: (K, kmax).  Rows first, taps in index order.
    """
    K, n, _ = ws_img.shape
    kmax = taps.shape[1]
    r = kmax // 2
    idx = torch.arange(-r, n + r, device=ws_img.device).clamp_(0, n - 1)
    p = ws_img.index_select(1, idx)
    acc = taps[:, 0, None, None] * p[:, 0:n, :]
    for i in range(1, kmax):
        acc = acc + taps[:, i, None, None] * p[:, i:i + n, :]
    p = acc.index_select(2, idx)
    out = taps[:, 0, None, None] * p[:, :, 0:n]
    for i in range(1, kmax):
        out = out + taps[:, i, None, None] * p[:, :, i:i + n]
    return out


def _subsample(ws_img, ws, its, patch_size: int):
    """P x P bilinear subsample at (ws >> 1) + i * its, i in [-P/2, P/2].

    A neighbour index at or beyond the workspace contributes nothing
    (the one-hot selection matrix of the JAX version has no column
    there).
    """
    K, n, _ = ws_img.shape
    half = patch_size >> 1
    i = torch.arange(-half, half + 1, dtype=torch.float32,
                     device=ws_img.device)
    p = (ws >> 1).float()[:, None] + i[None, :] * its[:, None]  # (K, P)
    p0f = torch.floor(p)
    f = p - p0f
    p0 = p0f.long().clamp(0, n - 1)
    p1 = (p0f.long() + 1).clamp(0, n - 1)
    w1 = torch.where(p0f + 1 < n, f, 0.0)
    w0 = 1.0 - f
    rows0 = ws_img.gather(1, p0[:, :, None].expand(K, patch_size, n))
    rows1 = ws_img.gather(1, p1[:, :, None].expand(K, patch_size, n))
    t = w0[:, :, None] * rows0 + w1[:, :, None] * rows1      # (K, P, n)
    c0 = t.gather(2, p0[:, None, :].expand(K, patch_size, patch_size))
    c1 = t.gather(2, p1[:, None, :].expand(K, patch_size, patch_size))
    return w0[:, None, :] * c0 + w1[:, None, :] * c1


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
    boundary.

    On a CUDA tensor the blur-branch keypoints go through the fused
    patch kernel (ops/cuda_patches) and only direct-branch keypoints
    take the plain direct warp.
    """
    P = cfg.patch_size
    B, H, W = images.shape
    K = x.shape[0]
    dev = x.device
    if active is None:
        active = torch.ones(K, dtype=torch.bool, device=dev)
    use_blur = (bucket - 2) / P > cfg.oversample_cutoff
    smallest_ws = max(prev_bucket + 1, _min_workspace(cfg))
    mixed = use_blur and smallest_ws <= cfg.oversample_cutoff * P + 2
    if images.device.type == "cuda":
        return _bucket_on_card(images, bucket, img_idx, x, y, s, a11, a21,
                               a22, cfg, active, use_blur, mixed, valid_hw)

    S = 2 * torch.ceil(s * cfg.mr_size).to(torch.int32) + 1
    its = fdiv(S.float(), P)
    ws = S + 2
    corner_bad = check_borders(*true_dims(valid_hw, img_idx, H, W), P, P, x,
                               y, a11 * its, a12 * its, a21 * its, a22 * its)
    kmax = _max_ksize_for_bucket(bucket, P, cfg.patch_smooth_factor)

    patches = torch.zeros((K, P, P), dtype=torch.float32, device=dev)
    touched = torch.zeros(K, dtype=torch.bool, device=dev)
    sel = active.nonzero(as_tuple=True)[0]
    side = bucket if use_blur else P
    chunk = max(1, _CHUNK_ELEMS // (side * side))
    for start in range(0, sel.numel(), chunk):
        ii = sel[start:start + chunk]
        g = lambda t: t[ii]
        xx, yy, b11, b21, b22 = map(g, (x, y, a11, a21, a22))
        itss, wss, im = its[ii], ws[ii], img_idx[ii]
        full_p = torch.full_like(wss, P)
        if use_blur:
            wsp, tch = _warp(images, im, bucket, xx, yy, b11, b21, b22, wss)
            sigma = cfg.patch_smooth_factor * itss
            ksz = (2.0 * 3.0 * sigma + 1.0).to(torch.int32)
            ksz = ksz + 1 - ksz % 2
            blurred = _blur(wsp, _device_gauss_taps(sigma, ksz, kmax))
            patch = _subsample(blurred, wss, itss, P)
            if mixed:
                dp, dt = _warp(images, im, P, xx, yy, b11 * itss,
                               b21 * itss, b22 * itss, full_p)
                direct = itss <= cfg.oversample_cutoff
                patch = torch.where(direct[:, None, None], dp, patch)
                tch = torch.where(direct, dt, tch)
        else:
            patch, tch = _warp(images, im, P, xx, yy, b11 * itss,
                               b21 * itss, b22 * itss, full_p)
        patches[ii] = patch
        touched[ii] = tch
    return patches, active & ~corner_bad & ~touched


def direct_patches(images: torch.Tensor, img_idx, x, y, s, a11, a21, a22,
                   cfg: HesaffConfig, active, valid_hw=None):
    """Direct-warp branch: a P x P warp with A * imageToPatchScale and no
    smoothing, for keypoints with imageToPatchScale <= oversample_cutoff.

    Arguments as extract_bucket_batch's (rectified frame).  Returns
    (patches (K, P, P), ok (K,)).
    """
    P = cfg.patch_size
    B, H, W = images.shape
    S = 2 * torch.ceil(s * cfg.mr_size).to(torch.int32) + 1
    its = fdiv(S.float(), P)
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
        patches[ii], touched[ii] = _warp(
            images, img_idx[ii], P, x[ii], y[ii], a11[ii] * itss,
            a21[ii] * itss, a22[ii] * itss, torch.full_like(S[ii], P))
    return patches, active & ~corner_bad & ~touched


def _bucket_on_card(images, bucket: int, img_idx, x, y, s, a11, a21, a22,
                    cfg: HesaffConfig, active, use_blur: bool, mixed: bool,
                    valid_hw=None):
    """extract_bucket_batch on a GPU: blur-branch keypoints through the
    fused patch kernel, direct-branch keypoints through the direct
    warp."""
    from hesaff_tpu_torch.ops.cuda_patches import extract_group

    if not use_blur:
        return direct_patches(images, img_idx, x, y, s, a11, a21, a22, cfg,
                              active, valid_hw)
    direct = torch.zeros_like(active)
    if mixed:
        S = 2 * torch.ceil(s * cfg.mr_size).to(torch.int32) + 1
        direct = fdiv(S.float(), cfg.patch_size) <= cfg.oversample_cutoff
    pk, ok = extract_group(images, bucket, img_idx, x, y, s, a11, a21, a22,
                           cfg, active & ~direct, valid_hw)
    if bool((active & direct).any()):
        dp, dok = direct_patches(images, img_idx, x, y, s, a11, a21, a22,
                                 cfg, active & direct, valid_hw)
        pk = torch.where(direct[:, None, None], dp, pk)
        ok = torch.where(direct, dok, ok)
    return pk, ok
