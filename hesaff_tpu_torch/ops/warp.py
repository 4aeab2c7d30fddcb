"""Affine grids and bilinear sampling (plain PyTorch, direct gathers).

Same semantics as ``hesaff_tpu.ops.warp``.  The JAX package samples with
one-hot matmuls because gathers are slow on a TPU; on the GPU a direct
4-tap gather computes the same value:

    val = (1-fy) * ((1-fx) v00 + fx v01) + fy * ((1-fx) v10 + fx v11)

The x blend comes first, as in the JAX twin's quantize_x form.  A
sample whose floor lies outside [0, W-2] x [0, H-2] reads 0 and raises
the "touched" flag.  The patch stage's clamped workspace warp
(clamped_warp) and the dims of its corner pre-check (true_dims) live
here too.
"""

from __future__ import annotations

import torch


def affine_grid(out_h: int, out_w: int, ofsx, ofsy, a11, a12, a21, a22):
    """Coordinates of a centred out_h x out_w affine grid.

    Scalars or (K,) tensors for the affine parameters; returns (wx, wy)
    of shape (..., out_h, out_w).
    """
    ref = next(v for v in (ofsx, ofsy, a11, a12, a21, a22)
               if isinstance(v, torch.Tensor))
    jj = (torch.arange(out_h, device=ref.device, dtype=torch.float32)
          - (out_h >> 1))
    ii = (torch.arange(out_w, device=ref.device, dtype=torch.float32)
          - (out_w >> 1))
    ex = lambda v: v[..., None, None] if isinstance(v, torch.Tensor) else v
    j = jj[:, None]
    i = ii[None, :]
    wx = ex(ofsx) + i * ex(a11) + j * ex(a12)
    wy = ex(ofsy) + i * ex(a21) + j * ex(a22)
    return wx, wy


def _bilinear(planes, plane_idx, wx, wy, H: int, W: int):
    x0f = torch.floor(wx)
    y0f = torch.floor(wy)
    valid = (x0f >= 0) & (y0f >= 0) & (x0f < W - 1) & (y0f < H - 1)
    x0 = x0f.clamp(0, W - 2).long()
    y0 = y0f.clamp(0, H - 2).long()
    fx = wx - x0f
    fy = wy - y0f
    flat = planes.reshape(-1)
    base = plane_idx * (H * W) + y0 * W + x0
    v00 = flat[base]
    v01 = flat[base + 1]
    v10 = flat[base + W]
    v11 = flat[base + W + 1]
    val = ((1.0 - fy) * ((1.0 - fx) * v00 + fx * v01)
           + fy * ((1.0 - fx) * v10 + fx * v11))
    return torch.where(valid, val, 0.0), valid


def bilinear_sample(img: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor):
    """Sample img (H, W) at float coords; returns (values, touched)."""
    H, W = img.shape
    val, valid = _bilinear(img, 0, wx, wy, H, W)
    return val, bool((~valid).any())


def bilinear_sample_from(stack: torch.Tensor, idx, wx: torch.Tensor,
                         wy: torch.Tensor):
    """Like bilinear_sample but against plane(s) idx of a (N, H, W) stack.

    idx broadcasts against wx (e.g. (K, 1, 1) for a batch of grids).
    Returns (values, valid) with the per-sample validity mask.
    """
    H, W = stack.shape[-2], stack.shape[-1]
    return _bilinear(stack, idx, wx, wy, H, W)


def affine_sample(img: torch.Tensor, out_h: int, out_w: int,
                  ofsx, ofsy, a11, a12, a21, a22):
    """Warp img (H, W): a centred out_h x out_w affine grid, bilinearly
    sampled.  Returns (out, touched)."""
    wx, wy = affine_grid(out_h, out_w, ofsx, ofsy, a11, a12, a21, a22)
    return bilinear_sample(img, wx, wy)


def check_borders(h, w, out_h: int, out_w: int,
                  ofsx, ofsy, a11, a12, a21, a22):
    """Corner-only boundary pre-check; True means "touches boundary".

    interpolateCheckBorders semantics: the four corners of the centred
    grid against the (w-2, h-2) inner window with floor/ceil.  All
    arguments broadcast (per-keypoint (K,) tensors).
    """
    ref = next(v for v in (ofsx, ofsy, a11, a12, a21, a22)
               if isinstance(v, torch.Tensor))
    width = w - 2
    height = h - 2
    half_w = out_w >> 1
    half_h = out_h >> 1
    # the corners' offsets as a 2 x 2 grid (x down, y across), made on
    # the card (a copy from the host would wait for the stream)
    xs = torch.linspace(-half_w, half_w, 2, dtype=torch.float32,
                        device=ref.device)[:, None]
    ys = torch.linspace(-half_h, half_h, 2, dtype=torch.float32,
                        device=ref.device)
    ex = lambda v: v[..., None, None] if isinstance(v, torch.Tensor) else v
    imx = ex(ofsx) + xs * ex(a11) + ys * ex(a12)
    imy = ex(ofsy) + xs * ex(a21) + ys * ex(a22)
    bad = ((torch.floor(imx) <= 0) | (torch.floor(imy) <= 0)
           | (torch.ceil(imx) >= ex(width)) | (torch.ceil(imy) >= ex(height)))
    return bad.flatten(-2).any(dim=-1)


def true_dims(valid_hw, img_idx, H: int, W: int):
    """(h, w) of the corner pre-check: the padded H, W, or each
    keypoint's image's true size from valid_hw (B, 2)."""
    if valid_hw is None:
        return H, W
    vhw = valid_hw.to(img_idx.device)[img_idx.long()]
    return vhw[:, 0], vhw[:, 1]


def clamped_warp(images, img_idx, n: int, x, y, a11, a21, a22, ws):
    """Clamped-index n x n warp of the rectified (a12 == 0) frame.

    images: (B, H, W); the rest (K,) per keypoint.  Output index q in
    [0, n) reads grid offset min(q, ws-1) - (ws >> 1), so q >= ws
    replicates the last true row/column.  Returns (out (K, n, n),
    touched (K,)) where touched means some sample fell outside the image
    (it then reads 0).
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
