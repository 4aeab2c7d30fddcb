"""SIFT descriptors of normalised patches: CUDA kernel and plain version.

The kernel (csrc/sift_desc.cu) replaces the TPU kernel
``hesaff_tpu/ops/pallas_sift.py`` sift_descriptors_pallas, one block
per patch.  A CPU tensor takes the plain PyTorch version
(``sift.sift_descriptors``); a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from hesaff_tpu_torch import params
from hesaff_tpu_torch.ops import cuda_build
from hesaff_tpu_torch.sift import sift_descriptors as sift_plain

# launches of the CUDA kernel in this process
LAUNCHES = 0


def sift_descriptors(patches: torch.Tensor, cfg):
    """(K, P, P) float32 patches -> (K, 128) float32 quantised values."""
    if patches.device.type == "cpu":
        return sift_plain(patches, cfg)
    if patches.device.type != "cuda":
        raise ValueError(f"sift_descriptors: unsupported device "
                         f"{patches.device}")
    return _launch(patches, cfg)


def _launch(patches: torch.Tensor, cfg):
    global LAUNCHES
    K, P, P2 = patches.shape
    if patches.dtype != torch.float32 or P != P2 or P != cfg.patch_size:
        raise ValueError("sift_descriptors: needs float32 (K, P, P) "
                         "patches of the configured patch size")
    dev = patches.device
    patches = patches.contiguous()
    sb, ob = cfg.spatial_bins, cfg.orientation_bins
    out = torch.empty((K, sb * sb * ob), dtype=torch.float32, device=dev)
    if K == 0:
        return out
    tb = params.tables(cfg, str(dev))
    circ, spatial = tb["circ_mask"], tb["spatial_bins"]
    n_support = float((circ > 0).sum())
    fn = cuda_build.library("sift_desc").hesaff_sift_desc
    fn.restype = ctypes.c_int
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [vp, i, i, vp, vp, i, i, f, f, vp, vp]
    with torch.cuda.device(dev):
        err = fn(cuda_build.ptr(patches), K, P, cuda_build.ptr(circ),
                 cuda_build.ptr(spatial), sb, ob, n_support,
                 cfg.max_bin_value, cuda_build.ptr(out), cuda_build.stream())
    cuda_build.check(err, "sift_desc")
    LAUNCHES += 1
    return out
