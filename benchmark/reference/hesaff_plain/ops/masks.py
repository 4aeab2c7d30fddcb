"""Gaussian weighting masks of the path (host-side numpy constants).

A frozen copy of the port's copy of the three mask functions of
``hesaff_tpu/ops/masks.py``: the second-moment-matrix mask, the circular
SIFT mask and the SIFT spatial bin weights.
"""

from __future__ import annotations

import numpy as np


def smm_gauss_mask(size: int) -> np.ndarray:
    """Square second-moment-matrix mask with truncation-fold correction:
    sigma = halfSize/3, unnormalised separable exp, with the tail mass
    beyond the window folded back onto the outermost rows and columns.
    """
    half = size >> 1
    scale = half / 3.0
    scale2 = -2.0 * scale * scale
    tmp = np.exp(np.arange(half + 1, dtype=np.float64) ** 2 / scale2).astype(
        np.float32
    )
    end = int(np.ceil(scale * 5.0) - half)
    for i in range(1, end):
        tmp[half - i] += np.float32(np.exp((i + half) ** 2 / scale2))
    mask = np.zeros((size, size), np.float32)
    for i in range(half + 1):
        for j in range(half + 1):
            v = tmp[i] * tmp[j]
            mask[half + i, half - j] = v
            mask[half - i, half + j] = v
            mask[half + i, half + j] = v
            mask[half - i, half - j] = v
    return mask


def circular_gauss_mask(size: int) -> np.ndarray:
    """Circular SIFT weighting mask: sigma^2 = 0.9 r^2, zero outside the
    radius.  Its support (mask > 0) is also the photometric
    normalisation's support."""
    half = size >> 1
    r2 = float(half * half)
    sigma2 = 0.9 * r2
    yy, xx = np.mgrid[0:size, 0:size]
    disq = (yy - half) ** 2.0 + (xx - half) ** 2.0
    return np.where(disq < r2, np.exp(-disq / sigma2), 0.0).astype(np.float32)


def sift_spatial_bins(patch_size: int, spatial_bins: int):
    """Dense (patch_size, spatial_bins) weight matrix W: W[i, b] is the
    total weight of pixel i in spatial bin b (linear interpolation
    between the two neighbouring bins)."""
    half = patch_size >> 1
    step = (spatial_bins + 1) / (2 * half)
    W = np.zeros((patch_size, spatial_bins), np.float32)
    for i in range(patch_size):
        x = step * i
        xi = int(x)
        b0, b1 = xi - 1, xi
        w1 = np.float32(x - xi)
        w0 = np.float32(1.0 - w1)
        if 0 <= b0 < spatial_bins:
            W[i, b0] += w0
        if 0 <= b1 < spatial_bins:
            W[i, b1] += w1
    return W
