"""Scale-normalised Determinant-of-Hessian response (plain PyTorch).

Same stencil as ``hesaff_tpu.ops.hessian``: Lxx and Lyy are second
central differences, Lxy = (I[r-1,c+1] - I[r-1,c-1] + I[r+1,c-1]
- I[r+1,c+1]) / 4 (the reference's sign convention), and the output is
(Lxx*Lyy - Lxy^2) * sigma^4 with the 1-px frame set to zero.
"""

from __future__ import annotations

import numpy as np
import torch


def norm2_of(norm: float) -> float:
    """sigma^4 from norm = sigma^2, squared in float32 as the JAX op does."""
    n = np.float32(norm)
    return float(n * n)


def doh(img: torch.Tensor, norm2: float) -> torch.Tensor:
    """DoH of (..., H, W) scaled by norm2 (= sigma^4); zero 1-px frame."""
    c = img[..., 1:-1, 1:-1]
    lxx = img[..., 1:-1, :-2] - 2.0 * c + img[..., 1:-1, 2:]
    lyy = img[..., :-2, 1:-1] - 2.0 * c + img[..., 2:, 1:-1]
    lxy = (img[..., :-2, 2:] - img[..., :-2, :-2]
           + img[..., 2:, :-2] - img[..., 2:, 2:]) * 0.25
    out = torch.zeros_like(img)
    out[..., 1:-1, 1:-1] = (lxx * lyy - lxy * lxy) * norm2
    return out


