"""Blur + DoH of one ladder level, plain PyTorch on every device.

Frozen copy of the plain half of ``hesaff_tpu_torch/ops/cuda_blur.py``
(K1's plain version); the kernel launch is left out.  Its outputs pass
through precision.stored, which rounds them to bfloat16 when the
benchmark's control asks for the precision below float32.
"""

from __future__ import annotations

import torch

from benchmark.reference.hesaff_plain.ops.blur import separable_blur
from benchmark.reference.hesaff_plain.ops.hessian import doh
from benchmark.reference.precision import stored


def blur_doh_plain(img: torch.Tensor, taps, norm2: float):
    """Blur (rows, then columns, replicate border) and its DoH * norm2."""
    b = stored(separable_blur(img, taps))
    return b, stored(doh(b, norm2))


def blur_doh(img: torch.Tensor, taps, norm2: float, out=None,
             resp_out=None):
    """(..., H, W) float32 -> (blurred, response), both (..., H, W).

    taps: odd-length float32 Gaussian taps ([1.0] copies the input and
    gives its DoH); norm2: sigma^4 of the level the blur produces.
    out, resp_out: optional (..., H, W) destinations, written in place
    and returned; give both or neither.
    """
    if (out is None) != (resp_out is None):
        raise ValueError("blur_doh: give both out and resp_out, or neither")
    b, r = blur_doh_plain(img, taps, norm2)
    if out is None:
        return b, r
    out.copy_(b)
    resp_out.copy_(r)
    return out, resp_out


def blur(img: torch.Tensor, taps):
    """The blur of blur_doh alone."""
    return stored(separable_blur(img, taps))
