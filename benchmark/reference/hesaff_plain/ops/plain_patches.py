"""Fused patch pipeline of a keypoint group: CUDA kernel and plain version.

The kernel (csrc/patches_group.cu) replaces the TPU kernel
``hesaff_tpu/ops/pallas_patches.py`` patches_pallas, entered through
extract_group_pallas and extract_group_pallas_scaled.  Per keypoint it
warps the ws x ws workspace (a sample whose floor lies outside the
source reads 0 and marks the keypoint bad), and applies the OpenCV
anti-alias blur and the 41 x 41 bilinear subsample folded into one
operator R = S . B (P x ws), so that

    patch = R . WS . R^T

R's row p is a band of KMAX + 1 columns that starts at
floor(pos_p) - KMAX // 2, pos_p = (ws >> 1) + (p - P // 2) * its:
band entry m holds taps[m] * (1 - f) + taps[m - 1] * f with
f = pos_p - floor(pos_p); columns outside [0, ws - 1] are dropped and
the blur's replicate-border mass is added at columns 0 and ws - 1.
``fold_operator`` builds it; kernel and plain version use the same
arithmetic.

Frozen copy of the plain half of
``hesaff_tpu_torch/ops/cuda_patches.py`` (K5's plain version, which
multiplies with ``torch.bmm``); the kernel launch and its tile
geometries are left out.  Plain PyTorch on every device.
"""

from __future__ import annotations

import torch

from benchmark.reference.hesaff_plain.ops.linalg import fdiv
from benchmark.reference.hesaff_plain.ops.warp import check_borders
from benchmark.reference.hesaff_plain.patches import (_device_gauss_taps,
                                      _max_ksize_for_bucket, _warp, true_dims)


# elements of one chunk's (chunk, n, n) workspace in the plain version
_CHUNK_ELEMS = 1 << 22


def fold_operator(ws, its, taps, n: int, patch_size: int):
    """Dense (K, P, n) blur-and-subsample operator R of each keypoint.

    ws: (K,) int workspace sides (<= n); its: (K,) subsample steps;
    taps: (K, KMAX) normalised blur taps.  Columns >= ws are zero.
    """
    K, kmax = taps.shape
    r = kmax // 2
    dev = taps.device
    k = (torch.arange(patch_size, device=dev, dtype=torch.float32)
         - (patch_size >> 1))
    pos = (ws >> 1).float()[:, None] + k[None, :] * its[:, None]  # (K, P)
    p0f = torch.floor(pos)
    f = pos - p0f
    p0 = p0f.long()
    zero = torch.zeros((K, 1), dtype=torch.float32, device=dev)
    # pre[j] = sum_{t < j} taps[t]; suf[j] = sum_{t >= j} taps[t]
    pre = torch.cat([zero, torch.cumsum(taps, 1)], 1)
    suf = torch.cat([torch.cumsum(taps.flip(1), 1).flip(1), zero], 1)
    wsl = ws.long()[:, None]
    at = lambda tab, j: tab.gather(1, j.clamp(0, kmax))
    # replicate-border mass: blurred column c reads sources c + t - r
    # below 0 (CL) or above ws - 1 (CR); hat-weighted at p0 and p0 + 1
    corr_l = (1.0 - f) * at(pre, r - p0) + f * at(pre, r - p0 - 1)
    corr_r = ((1.0 - f) * at(suf, wsl - p0 + r)
              + f * at(suf, wsl - p0 - 1 + r))
    c = torch.arange(n, device=dev)
    m = c[None, None, :] - (p0 - r)[:, :, None]                  # (K, P, n)
    tp = torch.cat([zero, taps, zero], 1)                        # index m+1
    flat = lambda j: tp.gather(1, (j + 1).clamp(0, kmax + 1).reshape(K, -1)
                               ).reshape(j.shape)
    main = flat(m) * (1.0 - f)[:, :, None] + flat(m - 1) * f[:, :, None]
    inband = (m >= 0) & (m <= kmax) & (c[None, None, :] < wsl[:, :, None])
    R = torch.where(inband, main, 0.0)
    R = R + torch.where(c == 0, corr_l[:, :, None], 0.0)
    R = R + torch.where(c[None, None, :] == (wsl - 1)[:, :, None],
                        corr_r[:, :, None], 0.0)
    return R


def patches_group_plain(src, img_idx, x, y, a11, a21, a22, ws, its, taps,
                        active, patch_size: int = 41):
    """Plain PyTorch version of the kernel: same arguments and results.

    Per keypoint: R (fold_operator), the clamped workspace warp WS, then
    T = WS . R^T and patch = R . T, in chunks of keypoints.
    """
    P = patch_size
    K = x.shape[0]
    dev = x.device
    out = torch.zeros((K, P, P), dtype=torch.float32, device=dev)
    bad = torch.ones(K, dtype=torch.bool, device=dev)
    sel = active.nonzero(as_tuple=True)[0]
    if sel.numel() == 0:
        return out, bad
    n = int(ws[sel].max())
    chunk = max(1, _CHUNK_ELEMS // (n * n))
    for start in range(0, sel.numel(), chunk):
        ii = sel[start:start + chunk]
        wsi = ws[ii].int()
        WS, touched = _warp(src, img_idx[ii], n, x[ii], y[ii], a11[ii],
                            a21[ii], a22[ii], wsi)
        R = fold_operator(wsi, its[ii], taps[ii], n, P)
        T = torch.bmm(WS, R.transpose(1, 2))
        out[ii] = torch.bmm(R, T)
        bad[ii] = touched
    return out, bad


def patches_group(src, img_idx, x, y, a11, a21, a22, ws, its, taps, active,
                  patch_size: int = 41):
    """Patches of K keypoints sampled from src (B, Hs, Ws) float32.

    img_idx, ws: (K,) int; x, y, a11, a21, a22, its: (K,) float32 in
    source pixels (the rectified frame, a12 == 0); taps: (K, KMAX)
    float32; active: (K,) bool.  Returns (patches (K, P, P) float32,
    bad (K,) bool): bad where a workspace sample fell outside the
    source, and in every inactive slot (whose patch is zero).
    """
    return patches_group_plain(src, img_idx, x, y, a11, a21, a22, ws, its,
                               taps, active, patch_size)


def group_args(images, bucket: int, img_idx, x, y, s, a11, a21, a22, cfg,
               active, ps: float = 1.0, orig_hw=None, valid_hw=None):
    """patches_group's arguments for one group, and the corner check.

    images: (B, H, W) full resolution (ps == 1) or, for the pyramid
    tail, the first level of the octave whose pixels are ps original
    pixels; bucket: the workspace bound in source pixels, which sets
    KMAX; the per-keypoint (K,) tensors are in original pixels, in the
    rectified frame.  At full resolution ws = S + 2, its = S / P and the
    anti-alias sigma is f * its.  From a downsampled level the warp
    runs in source pixels (x/ps, y/ps, step its/ps over a workspace
    2*ceil(S/(2 ps))+3) and the sigma drops the blur the level already
    carries: sqrt(max((f its/ps)^2 - sigma0^2, 1e-4)).  The boundary
    pre-check stays in original coordinates and dims (orig_hw, default
    the source's), or, for edge-padded images, each keypoint's image's
    true size in original pixels (valid_hw, (B, 2)); K5's own bad flag
    keeps the source's padded dimensions.  Returns (args, corner_bad).
    """
    P = cfg.patch_size
    kmax = _max_ksize_for_bucket(bucket, P, cfg.patch_smooth_factor)
    S = 2 * torch.ceil(s * cfg.mr_size).to(torch.int32) + 1
    its = fdiv(S.float(), P)
    H, W = orig_hw if orig_hw is not None else images.shape[-2:]
    corner_bad = check_borders(*true_dims(valid_hw, img_idx, H, W), P, P, x,
                               y, a11 * its, 0.0, a21 * its, a22 * its)
    if ps == 1.0:
        ws, sigma = S + 2, cfg.patch_smooth_factor * its
    else:
        its = its / ps
        ws = 2 * torch.ceil(S.float() / (2.0 * ps)).to(torch.int32) + 3
        sigma0 = cfg.initial_sigma
        sigma = torch.sqrt(torch.clamp_min(
            (cfg.patch_smooth_factor * its) ** 2 - sigma0 * sigma0, 1e-4))
        x, y = x / ps, y / ps
    ksz = (2.0 * 3.0 * sigma + 1.0).to(torch.int32)
    ksz = ksz + 1 - ksz % 2
    taps = _device_gauss_taps(sigma, ksz, kmax)
    args = (images, img_idx, x, y, a11, a21, a22, ws, its, taps, active, P)
    return args, corner_bad


def extract_group(images, bucket: int, img_idx, x, y, s, a11, a21, a22,
                  cfg, active, valid_hw=None):
    """Blur-branch patches of one group at full resolution.

    images: (B, H, W); per keypoint (K,) tensors; the frame is rectified
    (a12 == 0); valid_hw: None or (B, 2) true sizes of edge-padded
    images.  Mirrors patches.extract_bucket_batch for the blur branch
    (direct-branch keypoints go elsewhere).  Returns (patches (K, P, P),
    ok (K,)).
    """
    args, corner_bad = group_args(images, bucket, img_idx, x, y, s, a11,
                                  a21, a22, cfg, active, valid_hw=valid_hw)
    pk, bad = patches_group(*args)
    return pk, active & ~corner_bad & ~bad


def extract_group_scaled(images_src, ps: float, bucket: int, img_idx, x, y,
                         s, a11, a21, a22, cfg, active, orig_hw,
                         valid_hw=None):
    """Patches of large keypoints warped from a downsampled level.

    images_src: (B, H/ps, W/ps), the first level of the pyramid octave
    whose pixels are ps original pixels (sigma0-blurred in its own
    pixels); bucket: the source workspace bound (see group_args).
    Returns (patches (K, P, P), ok (K,)).
    """
    args, corner_bad = group_args(images_src, bucket, img_idx, x, y, s, a11,
                                  a21, a22, cfg, active, ps=ps,
                                  orig_hw=orig_hw, valid_hw=valid_hw)
    pk, bad = patches_group(*args)
    return pk, active & ~corner_bad & ~bad
