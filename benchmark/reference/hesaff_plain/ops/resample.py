"""Pyramid resampling: strided half-size and midpoint bilinear double-size.

Same semantics as ``hesaff_tpu.ops.resample``: half_image takes every
second pixel with no prefilter; double_image replicates the last
row/column where the midpoint would read past the edge.
"""

from __future__ import annotations

import torch


def half_image(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., H//2, W//2) by taking even-index pixels."""
    H, W = img.shape[-2], img.shape[-1]
    return img[..., 0:(H // 2) * 2:2, 0:(W // 2) * 2:2].contiguous()


def double_image(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., 2H, 2W) midpoint bilinear upsample."""
    H, W = img.shape[-2], img.shape[-1]
    right = torch.cat([img[..., :, 1:], img[..., :, -1:]], dim=-1)
    down = torch.cat([img[..., 1:, :], img[..., -1:, :]], dim=-2)
    down_right = torch.cat([down[..., :, 1:], down[..., :, -1:]], dim=-1)
    out = img.new_zeros(img.shape[:-2] + (2 * H, 2 * W))
    out[..., 0::2, 0::2] = img
    out[..., 1::2, 0::2] = 0.5 * (img + down)
    out[..., 0::2, 1::2] = 0.5 * (img + right)
    out[..., 1::2, 1::2] = 0.25 * (img + right + down + down_right)
    return out
