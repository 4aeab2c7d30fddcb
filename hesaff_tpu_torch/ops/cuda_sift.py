"""SIFT descriptors of normalised patches: CUDA kernel and plain version.

The kernel (csrc/sift_desc.cu) replaces the TPU kernel
``hesaff_tpu/ops/pallas_sift.py`` sift_descriptors_pallas, one warp per
patch, in two instances picked by shape (``instance``): "warp64" for
patches of up to 64 px with sb * ob dividing 32 and ob >= 2 (the
reference's 41 px and 4 x 4 x 8 bins), "generic" for any other patch
side and bin layout whose block fits the card's shared memory.  A CPU
tensor takes the plain PyTorch version (``sift.sift_descriptors``); a
CUDA tensor launches a kernel or raises.  Two entries:
``sift_descriptors`` (float32 values of every patch) and
``describe_masked`` (uint8 rows of the valid slots, zero rows
elsewhere: the serving path's form, with no gather, scatter or host
sync).  Rows are sb * sb * ob wide.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from hesaff_tpu_torch import params
from hesaff_tpu_torch.ops import cuda_build, masks
from hesaff_tpu_torch.sift import sift_descriptors as sift_plain

# launches of the CUDA kernel in this process (both entries, both
# instances), and of the generic instance alone
LAUNCHES = 0
GENERIC_LAUNCHES = 0


@functools.lru_cache(maxsize=64)
def instance(patch_size: int, sb: int, ob: int) -> str:
    """The kernel instance a (patch_size, sb, ob) launches: "warp64" or
    "generic" (the kernel's own choice; builds its library); raises
    where no instance fits the card's shared memory."""
    fn = cuda_build.entry("sift_desc", "hesaff_sift_instance",
                          [ctypes.c_int] * 3
                          + [ctypes.POINTER(ctypes.c_longlong)])
    shmem = ctypes.c_longlong(0)
    i = fn(patch_size, sb, ob, ctypes.byref(shmem))
    if i < 0:
        raise ValueError(
            f"sift_descriptors: a {patch_size} px patch with {sb} x {sb} x "
            f"{ob} bins needs {shmem.value} bytes of shared memory a warp, "
            "over the card's 232448")
    return ("warp64", "generic")[i]


def sift_descriptors(patches: torch.Tensor, cfg):
    """(K, P, P) float32 patches -> (K, sb * sb * ob) float32 quantised
    values."""
    if patches.device.type == "cpu":
        return sift_plain(patches, cfg)
    if patches.device.type != "cuda":
        raise ValueError(f"sift_descriptors: unsupported device "
                         f"{patches.device}")
    return _launch(patches, None, cfg)


def describe_masked_plain(patches: torch.Tensor, valid: torch.Tensor, cfg):
    """uint8 descriptors of the valid slots, zero rows elsewhere."""
    nb = cfg.spatial_bins ** 2 * cfg.orientation_bins
    desc = torch.zeros((patches.shape[0], nb), dtype=torch.uint8,
                       device=patches.device)
    sel = valid.nonzero(as_tuple=True)[0]
    if sel.numel():
        desc[sel] = sift_plain(patches[sel], cfg).to(torch.uint8)
    return desc


def describe_masked(patches: torch.Tensor, valid: torch.Tensor, cfg):
    """(K, P, P) float32 patches, (K,) bool -> (K, sb * sb * ob) uint8:
    each valid slot's descriptor, zero rows where valid is false."""
    if patches.device.type == "cpu":
        return describe_masked_plain(patches, valid, cfg)
    if patches.device.type != "cuda":
        raise ValueError(f"describe_masked: unsupported device "
                         f"{patches.device}")
    if (valid.dtype != torch.bool or valid.shape != patches.shape[:1]
            or valid.device != patches.device):
        raise ValueError("describe_masked: valid must be a (K,) bool "
                         "tensor on the patches' device")
    return _launch(patches, valid.contiguous(), cfg)


@functools.lru_cache(maxsize=8)
def _n_support(patch_size: int) -> float:
    """Pixels of the circular mask's support (host-side, no sync)."""
    return float((masks.circular_gauss_mask(patch_size) > 0).sum())


def _launch(patches: torch.Tensor, valid, cfg):
    global LAUNCHES, GENERIC_LAUNCHES
    K, P, P2 = patches.shape
    if patches.dtype != torch.float32 or P != P2 or P != cfg.patch_size:
        raise ValueError("sift_descriptors: needs float32 (K, P, P) "
                         "patches of the configured patch size")
    dev = patches.device
    patches = patches.contiguous()
    sb, ob = cfg.spatial_bins, cfg.orientation_bins
    generic = instance(P, sb, ob) == "generic"
    u8 = valid is not None
    out = torch.empty((K, sb * sb * ob),
                      dtype=torch.uint8 if u8 else torch.float32, device=dev)
    if K == 0:
        return out
    tb = params.tables(cfg, str(dev))
    circ, spatial = tb["circ_mask"], tb["spatial_bins"]
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = cuda_build.entry("sift_desc", "hesaff_sift_desc",
                          [vp, vp, i, i, vp, vp, i, i, f, f, i, vp, vp])
    with torch.cuda.device(dev):
        err = fn(cuda_build.ptr(patches),
                 cuda_build.ptr(valid) if u8 else None, K, P,
                 cuda_build.ptr(circ), cuda_build.ptr(spatial), sb, ob,
                 _n_support(P), cfg.max_bin_value, int(u8),
                 cuda_build.ptr(out), cuda_build.stream(dev))
    cuda_build.check(err, "sift_desc")
    LAUNCHES += 1
    GENERIC_LAUNCHES += generic
    return out
