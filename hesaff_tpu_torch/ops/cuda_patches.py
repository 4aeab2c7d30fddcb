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

The kernel picks a tile geometry by (KMAX, P) (``geometry``): four
for patches of up to 64 px, and a generic one, whose patch accumulates
in shared memory, for larger patches; a patch whose block would need
more than the card's 232,448 bytes of shared memory raises.

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches
the kernel or raises.  Either way it is the one blur-branch patch
arithmetic of the port: patches.extract_bucket_batch and the grouped
step both come here.

A keypoint's patch geometry is decided here for the whole port:
patch_geometry gives (S, ws, its) for a batch of scales, and the
direct-branch rule (min_workspace, direct_possible, takes_direct) says
which keypoints skip the blur and take patches.direct_patches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from hesaff_tpu_torch.ops import cuda_build
from hesaff_tpu_torch.ops.linalg import fdiv
from hesaff_tpu_torch.ops.warp import check_borders, clamped_warp, true_dims

# launches of the CUDA kernel in this process, and of its generic
# geometry (patches of more than 64 px) alone
LAUNCHES = 0
GENERIC_LAUNCHES = 0
# the generic geometry's index in csrc/patches_group.cu's kGeoms
GENERIC_GEOMETRY = 4

# elements of one chunk's (chunk, n, n) workspace in the plain version
_CHUNK_ELEMS = 1 << 22


def patch_geometry(s, cfg, ps: float = 1.0):
    """(S, ws, its) of keypoints of scales s (K,), the one place that
    decides a keypoint's patch geometry.

    S = 2 * ceil(s * mr_size) + 1 (int32), the patch image side; ws
    (int32), the workspace side in source pixels: S + 2 at full
    resolution, 2 * ceil(S / (2 ps)) + 3 from a level whose pixels are
    ps original pixels; its = S / P (float32, one division by a 0-d
    tensor), the subsample step in original pixels.
    """
    S = 2 * torch.ceil(s * cfg.mr_size).to(torch.int32) + 1
    its = fdiv(S.float(), cfg.patch_size)
    if ps == 1.0:
        return S, S + 2, its
    return S, 2 * torch.ceil(S.float() / (2.0 * ps)).to(torch.int32) + 3, its


def min_workspace(cfg) -> int:
    """Lower bound on any keypoint's workspace side ws = S + 2."""
    pd_min = 0.5 if cfg.upscale_input else 1.0
    s_min = (cfg.initial_sigma * cfg.sigma_step
             * 2.0 ** (-cfg.final_shift_limit / cfg.num_scales) * pd_min)
    return 2 * int(math.ceil(s_min * cfg.mr_size)) + 3


def direct_possible(cfg, above: int = 0) -> bool:
    """Whether a keypoint whose workspace side is above `above` can take
    the direct warp (imageToPatchScale <= oversample_cutoff, i.e. ws <=
    oversample_cutoff * P + 2).  Under the default configuration none
    can: its smallest workspace is above that."""
    return (max(above + 1, min_workspace(cfg))
            <= cfg.oversample_cutoff * cfg.patch_size + 2)


def takes_direct(its, cfg):
    """Per keypoint, from patch_geometry's its: the direct warp, with no
    anti-alias blur, in place of the blur branch."""
    return its <= cfg.oversample_cutoff


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
        WS, touched = clamped_warp(src, img_idx[ii], n, x[ii], y[ii], a11[ii],
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
    if x.device.type == "cpu":
        return patches_group_plain(src, img_idx, x, y, a11, a21, a22, ws,
                                   its, taps, active, patch_size)
    if x.device.type != "cuda":
        raise ValueError(f"patches_group: unsupported device {x.device}")
    return _launch(src, img_idx, x, y, a11, a21, a22, ws, its, taps, active,
                   patch_size)


@functools.lru_cache(maxsize=256)
def geometry(kmax: int, patch_size: int):
    """(index of the kernel's tile geometry, or -1 where none fits; bytes
    of shared memory its block needs) for a group's KMAX and patch side
    (builds the kernel's library; cached, as the pair decides it)."""
    fn = cuda_build.entry("patches_group", "hesaff_patches_geometry",
                          [ctypes.c_int, ctypes.c_int,
                           ctypes.POINTER(ctypes.c_longlong)])
    shmem = ctypes.c_longlong(0)
    g = fn(kmax, patch_size, ctypes.byref(shmem))
    return g, shmem.value


def _launch(src, img_idx, x, y, a11, a21, a22, ws, its, taps, active, P):
    global LAUNCHES, GENERIC_LAUNCHES
    if (src.dtype != torch.float32 or src.ndim != 3
            or not src.is_contiguous() or src.device != x.device):
        raise ValueError("patches_group: needs a contiguous float32 "
                         "(B, H, W) source on the keypoints' device")
    B, H, W = src.shape
    dev = x.device
    K = x.shape[0]
    kmax = taps.shape[1]
    out = torch.empty((K, P, P), dtype=torch.float32, device=dev)
    bad = torch.empty(K, dtype=torch.int32, device=dev)
    if K == 0:
        return out, bad.bool()
    geom, shmem = geometry(kmax, P)
    if geom < 0:
        raise ValueError(
            f"patches_group: a {P} px patch with KMAX {kmax} needs {shmem} "
            "bytes of shared memory a block, over the card's 232448")
    i32 = lambda t: t.to(device=dev, dtype=torch.int32).contiguous()
    f32 = lambda t: t.to(device=dev, dtype=torch.float32).contiguous()
    args = (i32(img_idx), *(f32(t) for t in (x, y, a11, a21, a22)),
            i32(ws), f32(its), f32(taps),
            active.to(device=dev, dtype=torch.uint8).contiguous())
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn = cuda_build.entry("patches_group", "hesaff_patches_group",
                          [vp, i, i, i] + [vp] * 10 + [i, i, i, vp, vp, vp])
    with torch.cuda.device(dev):
        err = fn(cuda_build.ptr(src), B, H, W,
                 *(cuda_build.ptr(t) for t in args), kmax, K, P,
                 cuda_build.ptr(out), cuda_build.ptr(bad),
                 cuda_build.stream(dev))
    cuda_build.check(err, "patches_group")
    LAUNCHES += 1
    GENERIC_LAUNCHES += geom == GENERIC_GEOMETRY
    return out, bad.bool()


def group_args(images, bucket: int, img_idx, x, y, s, a11, a21, a22, cfg,
               active, ps: float = 1.0, orig_hw=None, valid_hw=None):
    """patches_group's arguments for one group, and the corner check.

    images: (B, H, W) full resolution (ps == 1) or, for the pyramid
    tail, the first level of the octave whose pixels are ps original
    pixels; bucket: the workspace bound in source pixels, which sets
    KMAX; the per-keypoint (K,) tensors are in original pixels, in the
    rectified frame.  ws and its come from patch_geometry.  At full
    resolution the anti-alias sigma is f * its.  From a downsampled
    level the warp runs in source pixels (x/ps, y/ps, step its/ps over
    the source workspace) and the sigma drops the blur the level already
    carries: sqrt(max((f its/ps)^2 - sigma0^2, 1e-4)).  The boundary
    pre-check stays in original coordinates and dims (orig_hw, default
    the source's), or, for edge-padded images, each keypoint's image's
    true size in original pixels (valid_hw, (B, 2)); K5's own bad flag
    keeps the source's padded dimensions.  Returns (args, corner_bad).
    """
    P = cfg.patch_size
    kmax = _max_ksize_for_bucket(bucket, P, cfg.patch_smooth_factor)
    _, ws, its = patch_geometry(s, cfg, ps)
    H, W = orig_hw if orig_hw is not None else images.shape[-2:]
    corner_bad = check_borders(*true_dims(valid_hw, img_idx, H, W), P, P, x,
                               y, a11 * its, 0.0, a21 * its, a22 * its)
    if ps == 1.0:
        sigma = cfg.patch_smooth_factor * its
    else:
        its = its / ps
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
    images.  The blur branch of patches.extract_bucket_batch
    (direct-branch keypoints go to patches.direct_patches).  Returns
    (patches (K, P, P), ok (K,)).
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
