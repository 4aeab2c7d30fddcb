"""OpenCV-compatible separable Gaussian blur (plain PyTorch).

Same semantics as ``hesaff_tpu.ops.blur``: kernel size odd(int(6*sigma+1)),
sampled and normalised taps, replicate border.  The blur is a
shift-and-add over the taps in index order, the row pass (along H)
first, so the float32 sums round exactly as the JAX version's do.
"""

from __future__ import annotations

import numpy as np
import torch


def opencv_ksize(sigma: float) -> int:
    """Kernel size rule of OpenCV's gaussianBlur: odd(int(6*sigma + 1))."""
    size = int(2.0 * 3.0 * sigma + 1.0)
    if size % 2 == 0:
        size += 1
    return size


def gaussian_taps(sigma: float, ksize: int | None = None) -> np.ndarray:
    """Sampled, normalised Gaussian taps (getGaussianKernel semantics)."""
    if ksize is None:
        ksize = opencv_ksize(sigma)
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * float(sigma) * float(sigma)))
    return (k / k.sum()).astype(np.float32)


def separable_blur(img: torch.Tensor, taps) -> torch.Tensor:
    """Separable correlation of (..., H, W) with replicate padding.

    taps: 1-D float32 sequence (numpy array or tensor).  Rows first,
    then columns; each pass sums taps[0]*x_0 + taps[1]*x_1 + ... in
    index order.
    """
    taps = [float(t) for t in np.asarray(taps, np.float32)]
    k = len(taps)
    r = k // 2
    H, W = img.shape[-2], img.shape[-1]
    idx = torch.arange(-r, H + r, device=img.device).clamp_(0, H - 1)
    p = img.index_select(-2, idx)
    acc = taps[0] * p[..., 0:H, :]
    for i in range(1, k):
        acc = acc + taps[i] * p[..., i:i + H, :]
    idx = torch.arange(-r, W + r, device=img.device).clamp_(0, W - 1)
    p = acc.index_select(-1, idx)
    out = taps[0] * p[..., 0:W]
    for i in range(1, k):
        out = out + taps[i] * p[..., i:i + W]
    return out


