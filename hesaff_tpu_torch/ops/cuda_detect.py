"""Detection levels: CUDA kernels and their plain versions.

Two kernels of csrc/detect_walk.cu, each replacing a TPU kernel of
``hesaff_tpu/ops/pallas_detect.py``:

- ``detect_walk_octave`` (K2, detect_walk_pallas): for every detection
  level of an octave in one launch, strict 3x3x3 NMS, the dense 3x3
  localisation solve, the edge and NaN tests and the bounded walk from
  every pixel; the dense detection path.
- ``detect_maps`` (K3, detect_maps_pallas): the same NMS and maps of one
  level without the walk; the sparse detection path and
  ``detect_level``.

A CPU tensor takes the plain PyTorch version (``detect.candidate_mask``
+ ``_localization_maps``, then ``_walk_dense`` for K2, level by level);
a CUDA tensor launches the kernel or raises.

Padded mode: both take an optional ``valid_hw``, (B, 2) int32 rows and
columns of each image (for K3 each plane) when a batch is edge-padded
to a shape bucket.  Start pixels (the NMS candidates, and so ``ok``)
then lie in [border, h - border) x [border, w - border); everything
else keeps the padded H x W, as the JAX package ANDs the window onto
the kernel's ok / cand outside it (``hesaff_tpu/detect.py:603-623``).
The kernels take the limits by pointer and apply them where they build
the window.
"""

from __future__ import annotations

import ctypes

import torch

from hesaff_tpu_torch.ops import cuda_build

# launches of the CUDA kernels in this process: K2, K3
LAUNCHES = 0
MAPS_LAUNCHES = 0

_vp, _i, _f, _ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                    ctypes.c_longlong)
_MAPS_ARGTYPES = [_vp] * 3 + [_ll] * 3 + [_vp] * 5 + [_i] * 4 + [_f] * 3 + [
    _vp]
_WALK_ARGTYPES = [_vp] * 2 + [_ll] * 4 + [_vp] * 5 + [_i] * 5 + [
    _f, _f, _f, _f, _i, _i, _f, _f, _vp]


def detect_maps_plain(low, cur, high, cfg, valid_hw=None):
    """Plain PyTorch version of detect_maps (same outputs)."""
    from hesaff_tpu_torch import detect

    mask = detect.candidate_mask(low, cur, high, cfg, valid_hw)
    maps, edge = detect._localization_maps(low, cur, high, cfg)
    nan_flag = maps[..., :3].isnan().any(dim=-1)
    return torch.nan_to_num(maps), nan_flag, edge, mask


def detect_walk_plain(low, cur, high, blur, cfg, valid_hw=None):
    """Plain PyTorch walk of one detection level: low/cur/high (N, H, W)
    DoH planes of levels l-1, l, l+1, blur (N, H, W) of level l;
    valid_hw: None or (N, 2) true sizes (the start-pixel window).

    Returns (ok (N,H,W) bool, cell (N,H,W) int32 final cell r*W+c of each
    start pixel's walk, tab (N,H,W,5) float32 = [b0, b1, b2, val, Lxx],
    cand (N,H,W) bool NMS candidates inside the border window).
    """
    from hesaff_tpu_torch import detect

    clean, nan_flag, edge_bad, cand = detect_maps_plain(low, cur, high, cfg,
                                                        valid_hw)
    ok, cell = detect._walk_dense(clean, nan_flag, edge_bad, cand, cfg)
    lxx = (detect._shift_rep(blur, 0, -1) - 2.0 * blur
           + detect._shift_rep(blur, 0, 1))
    tab = torch.cat([clean, lxx[..., None]], dim=-1)
    return ok, cell, tab, cand


def detect_walk_octave_plain(resps, blurs, cfg, valid_hw=None):
    """Plain PyTorch version of detect_walk_octave (same outputs): the
    per-level walk of every detection level, stacked."""
    levels = [detect_walk_plain(resps[:, l - 1], resps[:, l],
                                resps[:, l + 1], blurs[:, l], cfg, valid_hw)
              for l in range(1, cfg.num_scales + 1)]
    ok, cell, tab, cand = (torch.stack(v, dim=1) for v in zip(*levels))
    return ok, cell, tab.permute(0, 1, 4, 2, 3).contiguous(), cand


def detect_walk_octave(resps, blurs, cfg, valid_hw=None):
    """Every detection level of an octave.

    resps: (B, L, H, W) DoH ladder with L >= num_scales + 2; blurs: (B,
    L', H, W) blur ladder with L' >= num_scales + 1.  Rows must be
    contiguous; images and levels may be strided.  Detection level l
    (1-based) reads resps l-1, l, l+1 and blur l.  valid_hw: None, or
    (B, 2) int32 true sizes of edge-padded images (the start-pixel
    window).

    Returns, for nl = num_scales levels: ok (B,nl,H,W) bool, cell
    (B,nl,H,W) int32 final cell r*W+c of each start pixel's walk, tab
    (B,nl,5,H,W) float32 planes [b0, b1, b2, val, Lxx], cand (B,nl,H,W)
    bool NMS candidates inside the border window.
    """
    if resps.device.type == "cpu":
        return detect_walk_octave_plain(resps, blurs, cfg, valid_hw)
    if resps.device.type != "cuda":
        raise ValueError(
            f"detect_walk_octave: unsupported device {resps.device}")
    return _launch(resps, blurs, cfg, valid_hw)


def detect_maps(low, cur, high, cfg, valid_hw=None):
    """low/cur/high: (N, H, W) DoH planes of levels l-1, l, l+1, rows
    contiguous; planes may be strided views.  valid_hw: None, or (N, 2)
    int32 true sizes of edge-padded planes (the mask's window).

    Returns (maps (N,H,W,4) float32 = [b0, b1, b2, val] with NaN -> 0
    and +-inf -> the largest finite float, nan (N,H,W) bool where any of
    b0, b1, b2 is NaN, edge (N,H,W) bool edge_score >= thr or < 0, mask
    (N,H,W) bool strict NMS candidates inside the border window).
    """
    if cur.device.type == "cpu":
        return detect_maps_plain(low, cur, high, cfg, valid_hw)
    if cur.device.type != "cuda":
        raise ValueError(f"detect_maps: unsupported device {cur.device}")
    return _launch_maps(low, cur, high, cfg, valid_hw)


def _limits(valid_hw, n: int, device):
    """The kernels' limits argument: NULL, or a pointer to valid_hw,
    checked to be (n, 2) contiguous int32 sizes on `device`."""
    if valid_hw is None:
        return ctypes.c_void_p(None)
    if (valid_hw.dtype != torch.int32 or tuple(valid_hw.shape) != (n, 2)
            or valid_hw.device != device or not valid_hw.is_contiguous()):
        raise ValueError(f"valid_hw: needs contiguous int32 ({n}, 2) sizes "
                         f"on {device}")
    return cuda_build.ptr(valid_hw)


def _check_planes(planes, what):
    cur = planes[1]
    for t in planes:
        if (t.dtype != torch.float32 or t.shape != cur.shape
                or t.device != cur.device or t.stride(-1) != 1
                or t.stride(-2) != cur.shape[-1]):
            raise ValueError(f"{what}: needs float32 (N, H, W) planes "
                             "with contiguous rows on one device")


def _launch_maps(low, cur, high, cfg, valid_hw):
    global MAPS_LAUNCHES
    _check_planes((low, cur, high), "detect_maps")
    N, H, W = cur.shape
    dev = cur.device
    vhw_ptr = _limits(valid_hw, N, dev)
    maps = torch.empty((N, H, W, 4), dtype=torch.float32, device=dev)
    flags = [torch.empty((N, H, W), dtype=torch.bool, device=dev)
             for _ in range(3)]
    if N == 0 or H == 0 or W == 0:
        return (maps, *flags)
    fn = cuda_build.entry("detect_walk", "hesaff_detect_maps", _MAPS_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(*(cuda_build.ptr(t) for t in (low, cur, high)),
                 *(t.stride(0) for t in (low, cur, high)),
                 *(cuda_build.ptr(t) for t in (maps, *flags)), vhw_ptr,
                 N, H, W, cfg.border, cfg.positive_threshold,
                 cfg.negative_threshold, cfg.edge_score_threshold,
                 cuda_build.stream(dev))
    cuda_build.check(err, "detect_maps")
    MAPS_LAUNCHES += 1
    return (maps, *flags)


def _launch(resps, blurs, cfg, valid_hw):
    global LAUNCHES
    nl = cfg.num_scales
    B, _, H, W = resps.shape
    for t, need in ((resps, nl + 2), (blurs, nl + 1)):
        if (t.dtype != torch.float32 or t.ndim != 4 or t.shape[0] != B
                or t.shape[1] < need or t.shape[2:] != (H, W)
                or t.device != resps.device or t.stride(-1) != 1
                or t.stride(-2) != W):
            raise ValueError("detect_walk_octave: needs float32 (B, L, H, "
                             "W) ladders with contiguous rows on one "
                             "device")
    dev = resps.device
    vhw_ptr = _limits(valid_hw, B, dev)
    ok = torch.empty((B, nl, H, W), dtype=torch.uint8, device=dev)
    cell = torch.empty((B, nl, H, W), dtype=torch.int32, device=dev)
    tab = torch.empty((B, nl, 5, H, W), dtype=torch.float32, device=dev)
    cand = torch.empty((B, nl, H, W), dtype=torch.uint8, device=dev)
    if B == 0 or H == 0 or W == 0:
        return ok.bool(), cell, tab, cand.bool()
    fn = cuda_build.entry("detect_walk", "hesaff_detect_walk_octave",
                          _WALK_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(cuda_build.ptr(resps), cuda_build.ptr(blurs),
                 resps.stride(0), resps.stride(1), blurs.stride(0),
                 blurs.stride(1),
                 *(cuda_build.ptr(t) for t in (ok, cell, tab, cand)),
                 vhw_ptr, B, nl, H, W, cfg.border, cfg.positive_threshold,
                 cfg.negative_threshold, cfg.edge_score_threshold,
                 cfg.max_subpixel_shift, cfg.point_safety_border,
                 cfg.localize_iterations, cfg.final_shift_limit,
                 cfg.final_threshold, cuda_build.stream(dev))
    cuda_build.check(err, "detect_walk_octave")
    LAUNCHES += 1
    return ok.bool(), cell, tab, cand.bool()
