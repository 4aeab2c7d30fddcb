"""Affine shape adaptation loop: CUDA kernel and plain version.

The kernel (csrc/affine_adapt.cu) replaces the TPU kernel
``hesaff_tpu/ops/pallas_affine.py`` (_call_kernel via
adapt_flat_pallas): up to max_iterations Baumberg steps per keypoint,
one warp per keypoint, on a persistent grid whose warps take slots from
a device-side counter.  A CPU tensor takes the plain PyTorch version
(``affine_shape.adapt_batch_plain``); a CUDA tensor launches the kernel
or raises.  Unlike the TPU kernel it takes the window side as an
argument, so one kernel serves every octave, including the small ones
whose window is clamped to the octave size.  The grid side G
(smm_window_size) picks the instance (``instance``): "g19" for the
configuration's 19, "generic" for any other G whose grid and mask fit
the card's shared memory (G <= 107).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from hesaff_tpu_torch.ops import cuda_build
from hesaff_tpu_torch.utils import profiling

# launches of the CUDA kernel in this process, and of its generic
# instance alone
LAUNCHES = 0
GENERIC_LAUNCHES = 0

_vp, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = ([_vp, ctypes.c_longlong, ctypes.c_longlong, _i, _i] + [_vp] * 6
             + [_i, _vp] + [_i] * 3 + [_f, _f] + [_vp] * 6)


@functools.lru_cache(maxsize=16)
def instance(G: int) -> str:
    """The kernel instance grid side G launches: "g19" or "generic" (the
    kernel's own choice; builds its library); raises where the grid and
    mask of a block of four warps do not fit the shared memory."""
    fn = cuda_build.entry("affine_adapt", "hesaff_affine_instance",
                          [_i, ctypes.POINTER(ctypes.c_longlong)])
    shmem = ctypes.c_longlong(0)
    i = fn(G, ctypes.byref(shmem))
    if i < 0:
        raise ValueError(f"adapt: a {G} x {G} grid needs {shmem.value} "
                         "bytes of shared memory a block, over the card's "
                         "232448")
    return ("g19", "generic")[i]


def adapt_plain(stack, img_idx, src, lx, ly, ratio, active, win, cfg,
                return_steps: bool = False):
    """Plain version of adapt; with return_steps also each keypoint's
    count of steps run (affine_shape.adapt_batch_plain)."""
    from hesaff_tpu_torch import params
    from hesaff_tpu_torch.affine_shape import adapt_batch_plain

    mask = params.tables(cfg, str(lx.device))["smm_mask"]
    return adapt_batch_plain(stack, img_idx, src, lx, ly, ratio, active,
                             win, cfg, mask, return_steps)


def adapt(stack, img_idx, src, lx, ly, ratio, active, win: int, cfg):
    """stack: (B, L, H, W) float32 blur levels (rows contiguous);
    img_idx, src: (K,) int; lx, ly, ratio: (K,) float32 octave
    coordinates and s / (initial_sigma * pd); active: (K,) bool.

    Returns an affine_shape.AffineResult of (K,) tensors.  The
    Baumberg steps run are added to ``profiling.counted("k4_steps")``
    where it is not None (the counter while torch.profiler records, a
    CUDA graph's own tensor while one is captured), on either path.
    """
    if lx.device.type == "cpu":
        count = profiling.counted("k4_steps", lx.device)
        if count is None:
            return adapt_plain(stack, img_idx, src, lx, ly, ratio, active,
                               win, cfg)
        res, steps = adapt_plain(stack, img_idx, src, lx, ly, ratio, active,
                                 win, cfg, return_steps=True)
        count.add_(steps.sum())
        return res
    if lx.device.type != "cuda":
        raise ValueError(f"adapt: unsupported device {lx.device}")
    return _launch(stack, img_idx, src, lx, ly, ratio, active, win, cfg)


def _launch(stack, img_idx, src, lx, ly, ratio, active, win, cfg):
    global LAUNCHES, GENERIC_LAUNCHES
    from hesaff_tpu_torch import params
    from hesaff_tpu_torch.affine_shape import AffineResult

    B, L, H, W = stack.shape
    if (stack.dtype != torch.float32 or stack.device != lx.device
            or stack.stride(-1) != 1 or stack.stride(-2) != W):
        raise ValueError("adapt: needs float32 (B, L, H, W) with contiguous "
                         "rows on the keypoints' device")
    dev = lx.device
    K = lx.shape[0]
    i32 = lambda t: t.to(device=dev, dtype=torch.int32).contiguous()
    f32 = lambda t: t.to(device=dev, dtype=torch.float32).contiguous()
    img_idx, src = i32(img_idx), i32(src)
    lx, ly, ratio = f32(lx), f32(ly), f32(ratio)
    act = active.to(device=dev, dtype=torch.uint8).contiguous()
    mask = params.tables(cfg, str(dev))["smm_mask"]
    G = cfg.smm_window_size
    generic = instance(G) == "generic"
    ok = torch.empty(K, dtype=torch.int32, device=dev)
    u = torch.empty((K, 4), dtype=torch.float32, device=dev)
    iters = torch.empty(K, dtype=torch.int32, device=dev)
    # the kernel's slot counter, zeroed by the entry point on the stream
    counter = torch.empty(1, dtype=torch.int32, device=dev)
    count = profiling.counted("k4_steps", dev)
    steps = None if count is None else cuda_build.ptr(count)
    fn = cuda_build.entry("affine_adapt", "hesaff_affine_adapt", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(cuda_build.ptr(stack), stack.stride(0), stack.stride(1),
                 H, W, *(cuda_build.ptr(t) for t in
                         (img_idx, src, lx, ly, ratio, act)),
                 K, cuda_build.ptr(mask), G, win, cfg.max_iterations,
                 cfg.convergence_threshold, cfg.anisotropy_max,
                 *(cuda_build.ptr(t) for t in (ok, u, iters, counter)),
                 steps, cuda_build.stream(dev))
    cuda_build.check(err, "affine_adapt")
    LAUNCHES += 1
    GENERIC_LAUNCHES += generic
    return AffineResult(ok=ok.bool(), u11=u[:, 0], u12=u[:, 1],
                        u21=u[:, 2], u22=u[:, 3], iters=iters)
