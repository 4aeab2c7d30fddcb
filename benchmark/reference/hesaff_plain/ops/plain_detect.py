"""Detection levels, plain PyTorch on every device.

Frozen copy of the plain half of ``hesaff_tpu_torch/ops/cuda_detect.py``:
K2's plain version (``detect_walk_octave``: strict 3x3x3 NMS, the dense
3x3 localisation solve, the edge and NaN tests and the bounded walk
from every pixel of every detection level of an octave) and K3's
(``detect_maps``); the kernel launches are left out.  valid_hw: None,
or (B, 2) int32 true sizes of edge-padded images (the start-pixel
window).
"""

from __future__ import annotations

import torch


def detect_maps_plain(low, cur, high, cfg, valid_hw=None):
    """Plain PyTorch version of detect_maps (same outputs)."""
    from benchmark.reference.hesaff_plain import detect

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
    from benchmark.reference.hesaff_plain import detect

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
    return detect_walk_octave_plain(resps, blurs, cfg, valid_hw)


def detect_maps(low, cur, high, cfg, valid_hw=None):
    """low/cur/high: (N, H, W) DoH planes of levels l-1, l, l+1, rows
    contiguous; planes may be strided views.  valid_hw: None, or (N, 2)
    int32 true sizes of edge-padded planes (the mask's window).

    Returns (maps (N,H,W,4) float32 = [b0, b1, b2, val] with NaN -> 0
    and +-inf -> the largest finite float, nan (N,H,W) bool where any of
    b0, b1, b2 is NaN, edge (N,H,W) bool edge_score >= thr or < 0, mask
    (N,H,W) bool strict NMS candidates inside the border window).
    """
    return detect_maps_plain(low, cur, high, cfg, valid_hw)


