"""Fused blur + DoH for one ladder level: CUDA kernel and plain version.

The kernel (csrc/blur_doh.cu) replaces the TPU kernels
``hesaff_tpu/ops/pallas_blur.py`` blur_doh and blur_doh_tiled.  A CPU
tensor takes the plain PyTorch version; a CUDA tensor launches the
kernel or raises.  The kernel reads and writes (..., H, W) planes at a
uniform plane stride, so blur_doh reads a ladder level from, and writes
the next into, a slot of a (..., L, H, W) stack.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from hesaff_tpu_torch.ops import cuda_build
from hesaff_tpu_torch.ops.blur import separable_blur
from hesaff_tpu_torch.ops.hessian import doh

MAX_TAPS = 31
# launches of the CUDA kernel in this process (both entries)
LAUNCHES = 0


def blur_doh_plain(img: torch.Tensor, taps, norm2: float):
    """Blur (rows, then columns, replicate border) and its DoH * norm2."""
    b = separable_blur(img, taps)
    return b, doh(b, norm2)


def blur_doh(img: torch.Tensor, taps, norm2: float, out=None,
             resp_out=None):
    """(..., H, W) float32 -> (blurred, response), both (..., H, W).

    taps: odd-length float32 Gaussian taps ([1.0] copies the input and
    gives its DoH); norm2: sigma^4 of the level the blur produces.
    out, resp_out: optional (..., H, W) destinations (e.g. a level slot
    of a ladder stack, not overlapping img), written in place and
    returned; give both or neither.
    """
    if (out is None) != (resp_out is None):
        raise ValueError("blur_doh: give both out and resp_out, or neither")
    if img.device.type == "cpu":
        b, r = blur_doh_plain(img, taps, norm2)
        if out is None:
            return b, r
        out.copy_(b)
        resp_out.copy_(r)
        return out, resp_out
    if img.device.type != "cuda":
        raise ValueError(f"blur_doh: unsupported device {img.device}")
    if out is None:
        out, resp_out = torch.empty_like(img), torch.empty_like(img)
    _launch(img, taps, norm2, out, resp_out)
    return out, resp_out


def blur(img: torch.Tensor, taps):
    """The blur of blur_doh alone (the kernel's blur-only mode on a CUDA
    tensor, separable_blur on a CPU tensor)."""
    if img.device.type == "cpu":
        return separable_blur(img, taps)
    if img.device.type != "cuda":
        raise ValueError(f"blur: unsupported device {img.device}")
    out = torch.empty_like(img)
    _launch(img, taps, 0.0, out, None)
    return out


def _planes(t: torch.Tensor, what: str):
    """(number of planes, plane stride) of a (..., H, W) float32 tensor
    whose planes are contiguous and evenly spaced."""
    if t.dtype != torch.float32 or t.ndim < 2:
        raise ValueError(f"blur_doh: {what} must be float32 (..., H, W)")
    H, W = t.shape[-2], t.shape[-1]
    if t.stride(-1) != 1 or (H > 1 and t.stride(-2) != W):
        raise ValueError(f"blur_doh: {what} planes must be contiguous")
    n = t.numel() // (H * W) if H * W else 0
    if t.ndim == 2:
        return n, H * W
    for d in range(t.ndim - 3):
        if t.shape[d] > 1 and t.stride(d) != t.stride(d + 1) * t.shape[d + 1]:
            raise ValueError(f"blur_doh: {what} planes must be evenly "
                             "spaced")
    return n, t.stride(-3)


def _launch(img, taps, norm2: float, out, resp_out):
    global LAUNCHES
    taps = np.asarray(taps, np.float32)
    k = taps.shape[0]
    if k % 2 == 0 or k > MAX_TAPS:
        raise ValueError(f"blur_doh: {k} taps (odd, <= {MAX_TAPS})")
    n, in_stride = _planes(img, "input")
    outs = [out] if resp_out is None else [out, resp_out]
    for o in outs:
        if o.shape != img.shape or o.device != img.device:
            raise ValueError("blur_doh: outputs must match the input's "
                             "shape and device")
    out_stride = _planes(out, "out")[1]
    if resp_out is not None and _planes(resp_out, "resp_out")[1] != out_stride:
        raise ValueError("blur_doh: out and resp_out need one plane stride")
    if n == 0:
        return
    H, W = img.shape[-2], img.shape[-1]
    fn = cuda_build.library("blur_doh").hesaff_blur_doh
    fn.restype = ctypes.c_int
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [vp, ll, vp, vp, ll, i, i, i, vp, i, ctypes.c_float, vp]
    host_taps = (ctypes.c_float * k)(*taps.tolist())
    with torch.cuda.device(img.device):
        err = fn(cuda_build.ptr(img), in_stride, cuda_build.ptr(out),
                 None if resp_out is None else cuda_build.ptr(resp_out),
                 out_stride, n, H, W, host_taps, k, norm2,
                 cuda_build.stream(img.device))
    cuda_build.check(err, "blur_doh")
    LAUNCHES += 1
