"""DoH extrema detection: NMS, localisation walk, dedup.

Port of ``hesaff_tpu/detect.py``.  ``detect_octave_batch`` takes one of
two paths per octave, by the JAX package's rule:

- dense (octaves under 2^23 px, detect_octave_dense): one launch of the
  fused kernel K2 (ops/cuda_detect.detect_walk_octave) gives, for every
  pixel of every detection level, whether a keypoint starting there is
  accepted and the final cell of its localisation walk.  Then one per-image
  compaction over the (3, H, W) accepted mask in level-major raster
  order (the reference's scan order) to the octave's affine capacity, a
  fetch of (b0, b1, b2, val, Lxx) at the final cells, and the octaveMap
  dedup: accepted keypoints that share a final cell keep only the
  earliest in scan order.
- sparse (octaves of 2^23 px or more): per level the maps kernel K3
  (ops/cuda_detect.detect_maps) gives the NMS mask and the localisation
  maps; the candidates are compacted in raster order to the level
  capacity and each walks through its window of the maps
  (``detect_level``).  Then the octaveMap dedup over the three levels
  and one compaction to the affine capacity (detect_octave_sparse).
  The capacities differ from the dense path's, so when they overflow
  the results differ too: the port reproduces each path as the JAX
  package runs it.

Padded mode: every entry takes an optional ``valid_hw``, (B, 2) int32
true sizes of the octave's images when a batch is edge-padded to a
shape bucket.  It narrows the start pixels only (r < h - border,
c < w - border; n_cand counts the narrowed window); the 3x3x3
neighbourhoods, the solve and the walk's safety border keep the padded
dimensions, as in the JAX package (``hesaff_tpu/detect.py:603-623``).
The kernels take it by pointer.

Overflow of any capacity is counted, never silent.
``candidate_mask``, ``_localization_maps`` and ``_walk_dense`` are the
plain versions of the kernels, operation for operation the JAX twin's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from hesaff_tpu_torch.config import HesaffConfig
from hesaff_tpu_torch.ops import cuda_detect
from hesaff_tpu_torch.ops.batching import compact_rows
from hesaff_tpu_torch.ops.linalg import fdiv, solve3x3_parts

HESSIAN_DARK = 0
HESSIAN_BRIGHT = 1
HESSIAN_SADDLE = 2

# octaves at or beyond this many pixels take the sparse walk (the JAX
# package's rule: its packed dense walk is exact only below 2^23 px)
SPARSE_PATH_PIXELS = 1 << 23


class LevelKeypoints(NamedTuple):
    """Fixed-capacity localised keypoints of one detection level, for a
    batch: (B, K) fields, (B,) counts."""

    ok: torch.Tensor        # accepted (pre- or post-dedup)
    x: torch.Tensor         # image coordinates (already * pixel distance)
    y: torch.Tensor
    s: torch.Tensor         # scale (already * pixel distance)
    response: torch.Tensor  # peak DoH value
    type: torch.Tensor      # int32 point type
    r_final: torch.Tensor   # final row on the octave grid (for dedup)
    c_final: torch.Tensor   # final column
    overflow: torch.Tensor  # (B,) candidates dropped by the capacity
    n_cand: torch.Tensor    # (B,) NMS candidates before localisation


def _f32(v: float) -> float:
    return float(np.float32(v))


def _shift_rep(a: torch.Tensor, dr: int, dc: int) -> torch.Tensor:
    """a sampled at (r+dr, c+dc) with edge replication."""
    H, W = a.shape[-2], a.shape[-1]
    ri = (torch.arange(H, device=a.device) + dr).clamp_(0, H - 1)
    ci = (torch.arange(W, device=a.device) + dc).clamp_(0, W - 1)
    return a.index_select(-2, ri).index_select(-1, ci)


def _frame(shape, device):
    H, W = shape[-2], shape[-1]
    rows = torch.arange(H, device=device)[:, None]
    cols = torch.arange(W, device=device)[None, :]
    return rows, cols


def candidate_mask(low, cur, high, cfg: HesaffConfig,
                   valid_hw=None) -> torch.Tensor:
    """Thresholded strict 3x3x3 NMS (ties survive) inside the border.

    valid_hw: None, or (N, 2) true sizes of the N planes; the window
    [border, dim - border) then uses them."""
    mx = cur
    mn = cur
    for lvl in (low, cur, high):
        for dr in (-1, 0, 1):
            for dc in (-1, 0, 1):
                if lvl is cur and dr == 0 and dc == 0:
                    continue
                v = _shift_rep(lvl, dr, dc)
                mx = torch.maximum(mx, v)
                mn = torch.minimum(mn, v)
    pos = (cur > _f32(cfg.positive_threshold)) & (cur >= mx)
    neg = (cur < _f32(cfg.negative_threshold)) & (cur <= mn)
    rows, cols = _frame(cur.shape, cur.device)
    b = cfg.border
    H, W = cur.shape[-2], cur.shape[-1]
    keep = (rows >= b) & (rows < H - b) & (cols >= b) & (cols < W - b)
    if valid_hw is not None:
        vhw = valid_hw.to(cur.device)
        keep = (keep & (rows < vhw[:, 0, None, None] - b)
                & (cols < vhw[:, 1, None, None] - b))
    return (pos | neg) & keep


def _localization_maps(low, cur, high, cfg: HesaffConfig):
    """Dense per-pixel 3x3 quadratic fit.

    Returns (maps (..., H, W, 4) = [b0, b1, b2, val] with NaN/Inf where
    the solve is singular, edge_bad (..., H, W) bool).
    """
    sh = _shift_rep
    c = cur
    dxx = sh(c, 0, -1) - 2.0 * c + sh(c, 0, 1)
    dyy = sh(c, -1, 0) - 2.0 * c + sh(c, 1, 0)
    dss = low - 2.0 * c + high
    dxy = 0.25 * (sh(c, 1, 1) - sh(c, 1, -1) - sh(c, -1, 1) + sh(c, -1, -1))
    dxs = 0.25 * (sh(high, 0, 1) - sh(high, 0, -1)
                  - sh(low, 0, 1) + sh(low, 0, -1))
    dys = 0.25 * (sh(high, 1, 0) - sh(high, -1, 0)
                  - sh(low, 1, 0) + sh(low, -1, 0))
    dx = 0.5 * (sh(c, 0, 1) - sh(c, 0, -1))
    dy = 0.5 * (sh(c, 1, 0) - sh(c, -1, 0))
    ds = 0.5 * (high - low)

    b0, b1, b2 = solve3x3_parts(
        [[dxx, dxy, dxs], [dxy, dyy, dys], [dxs, dys, dss]],
        [-dx, -dy, -ds])
    val = c + 0.5 * (dx * b0 + dy * b1 + ds * b2)

    edge_den = dxx * dyy - dxy * dxy
    edge_score = (dxx + dyy) * (dxx + dyy) / edge_den
    edge_bad = ((edge_score >= _f32(cfg.edge_score_threshold))
                | (edge_score < 0))
    return torch.stack([b0, b1, b2, val], dim=-1), edge_bad


def _walk_dense(maps, nan_flag, edge_bad, cand, cfg: HesaffConfig):
    """Localisation walk from every pixel.

    maps: (N, H, W, 4) sanitised [b0, b1, b2, val]; nan_flag, edge_bad,
    cand: (N, H, W) bool.  Each start pixel walks at most
    localize_iterations-1 steps of +-1 px, stopping where the cell says
    stop (NaN solve, move blocked by the safety border, or no move
    wanted).  Returns (ok (N, H, W) bool = cand & ~edge_bad(start) &
    stop_ok(final), cell (N, H, W) int32 final r*W+c).
    """
    N, H, W = cand.shape
    b0, b1, b2, val = maps.unbind(-1)
    rows, cols = _frame(cand.shape, cand.device)
    ms = _f32(cfg.max_subpixel_shift)
    safety = cfg.point_safety_border
    move_px = b0 > ms
    move_nx = b0 < -ms
    move_py = b1 > ms
    move_ny = b1 < -ms
    border_bad = ((move_px & ~(cols < W - safety))
                  | (move_nx & ~(cols > safety))
                  | (move_py & ~(rows < H - safety))
                  | (move_ny & ~(rows > safety)))
    sc = move_px.long() - move_nx.long()
    sr = move_py.long() - move_ny.long()
    moved = (sc != 0) | (sr != 0)
    stop = nan_flag | border_bad | ~moved
    lim = _f32(cfg.final_shift_limit)
    shift_bad = (b0.abs() > lim) | (b1.abs() > lim) | (b2.abs() > lim)
    weak = val.abs() < _f32(cfg.final_threshold)
    stop_ok = ~nan_flag & ~border_bad & ~shift_bad & ~weak

    flat = lambda t: t.reshape(N, H * W)
    stop_f, sr_f, sc_f, stop_ok_f = map(flat, (stop, sr, sc, stop_ok))
    q = torch.arange(H * W, device=cand.device).expand(N, H * W)
    for _ in range(cfg.localize_iterations - 1):
        qr = (q // W + sr_f.gather(1, q)).clamp_(0, H - 1)
        qc = (q % W + sc_f.gather(1, q)).clamp_(0, W - 1)
        q = torch.where(stop_f.gather(1, q), q, qr * W + qc)
    okbit = stop_ok_f.gather(1, q).reshape(N, H, W)
    ok = cand & ~edge_bad & okbit
    return ok, q.reshape(N, H, W).to(torch.int32)


def _dedup_compacted(cell, valid, big: int):
    """First-come-first-marked dedup over compacted slots (rows in scan
    order): a valid slot survives unless an earlier valid slot of its
    row has the same cell."""
    key = torch.where(valid, cell, big)
    sorted_key, perm = torch.sort(key, dim=-1, stable=True)
    first = torch.ones_like(valid)
    first[..., 1:] = sorted_key[..., 1:] != sorted_key[..., :-1]
    keep_sorted = first & (sorted_key != big)
    return torch.zeros_like(valid).scatter(-1, perm, keep_sorted)


def compact_candidates(mask: torch.Tensor, capacity: int):
    """Raster-order (row, col) of the set pixels of each (H, W) plane of
    a (B, H, W) mask, padded to `capacity` (the dedup depends on the
    order).  Returns (rows, cols, valid, overflow (B,))."""
    B, H, W = mask.shape
    idx, valid, overflow = compact_rows(mask.reshape(B, H * W), capacity)
    return idx // W, idx % W, valid, overflow


def _walk_window(maps, nan_flag, edge, blur, r0, c0, cur_scale: float,
                 pd: float, cfg: HesaffConfig):
    """The bounded localisation walk of every candidate at once.

    maps: (B, H, W, 4) sanitised; nan_flag, edge: (B, H, W) bool; blur:
    (B, H, W); r0, c0: (B, K) start cells.  Decision logic of JAX's
    _walk_window, step for step.  Each candidate reads the planes only
    inside its (2R+1) x (2R+3) window (R = localize_iterations - 1) at
    the JAX package's clamped start (_window_starts): a read outside it
    gives 0 in every channel, as JAX's one-hot window read does.
    Returns (ok, x, y, s, val, type, r_final, c_final), each (B, K).
    """
    B, H, W = blur.shape
    R = cfg.localize_iterations - 1
    WR, WC = 2 * R + 1, 2 * R + 3
    sr0 = torch.clamp(r0 - R, 0, H - WR)
    sc0 = torch.clamp(c0 - (R + 1), 0, W - WC)
    base = torch.arange(B, device=r0.device)[:, None] * (H * W)
    planes = (maps.reshape(-1, 4), nan_flag.reshape(-1), edge.reshape(-1),
              blur.reshape(-1))

    def at(dr, dc, chans):
        r, c = r0 + dr, c0 + dc
        inwin = (r >= sr0) & (r < sr0 + WR) & (c >= sc0) & (c < sc0 + WC)
        g = base + r.clamp(0, H - 1) * W + c.clamp(0, W - 1)
        out = []
        for k in chans:
            v = planes[k][g]
            out.append(torch.where(inwin[..., None] if v.dim() == 3
                                   else inwin, v, torch.zeros_like(v)))
        return out

    zero = torch.zeros_like(r0)
    dr, dc = zero, zero
    b = torch.zeros(r0.shape + (3,), dtype=torch.float32, device=r0.device)
    val = torch.zeros(r0.shape, dtype=torch.float32, device=r0.device)
    (edge0,) = at(dr, dc, (2,))
    alive = ~edge0
    rejected = ~alive
    ms = _f32(cfg.max_subpixel_shift)
    safety = cfg.point_safety_border
    for it in range(cfg.localize_iterations):
        v, nan_bad = at(dr, dc, (0, 1))
        sol = v[..., :3]
        rejected = rejected | (alive & nan_bad)
        alive = alive & ~nan_bad
        b = torch.where(alive[..., None], sol, b)
        val = torch.where(alive, v[..., 3], val)

        r, c = r0 + dr, c0 + dc
        move_px = sol[..., 0] > ms
        move_nx = sol[..., 0] < -ms
        move_py = sol[..., 1] > ms
        move_ny = sol[..., 1] < -ms
        border_bad = ((move_px & ~(c < W - safety))
                      | (move_nx & ~(c > safety))
                      | (move_py & ~(r < H - safety))
                      | (move_ny & ~(r > safety)))
        rejected = rejected | (alive & border_bad)
        alive = alive & ~border_bad
        sc = move_px.long() - move_nx.long()
        sr = move_py.long() - move_ny.long()
        alive = alive & ((sc != 0) | (sr != 0))
        if it < cfg.localize_iterations - 1:
            dc = torch.where(alive, dc + sc, dc)
            dr = torch.where(alive, dr + sr, dr)

    lim = _f32(cfg.final_shift_limit)
    shift_bad = (b.abs() > lim).any(dim=-1)
    weak = val.abs() < _f32(cfg.final_threshold)
    ok = ~rejected & ~shift_bad & ~weak

    scale = (torch.tensor(cur_scale, dtype=torch.float32, device=r0.device)
             * torch.exp2(fdiv(b[..., 2], cfg.num_scales)))
    (bl,), (bc,), (br,) = (at(dr, dc + k, (3,)) for k in (-1, 0, 1))
    lxx = bl - 2.0 * bc + br
    ptype = torch.where(
        val < 0, HESSIAN_SADDLE,
        torch.where(lxx < 0, HESSIAN_DARK, HESSIAN_BRIGHT)).to(torch.int32)
    r, c = r0 + dr, c0 + dc
    x = pd * (c.float() + b[..., 0])
    y = pd * (r.float() + b[..., 1])
    return ok, x, y, pd * scale, val, ptype, r, c


def detect_level(low, cur, high, blur, cur_scale: float, pd: float,
                 capacity: int, cfg: HesaffConfig,
                 valid_hw=None) -> LevelKeypoints:
    """Candidates and their localisation walks for one detection level.

    low/cur/high/blur: (B, H, W) planes (rows contiguous).  The maps come
    dense from K3; the candidates, compacted in raster order to
    `capacity` (overflow counted), walk through their windows of them.
    """
    maps, nan_flag, edge, mask = cuda_detect.detect_maps(low, cur, high,
                                                         cfg, valid_hw)
    rows, cols, valid, overflow = compact_candidates(mask, capacity)
    ok, x, y, s, val, ptype, r_f, c_f = _walk_window(
        maps, nan_flag, edge, blur, rows, cols, cur_scale, pd, cfg)
    return LevelKeypoints(
        ok=ok & valid, x=x, y=y, s=s, response=val, type=ptype,
        r_final=r_f, c_final=c_f, overflow=overflow,
        n_cand=mask.reshape(mask.shape[0], -1).sum(dim=1))


def dedup_octave(levels: list[LevelKeypoints], H: int, W: int):
    """octaveMap dedup across an octave's levels: accepted keypoints
    that share a final cell keep only the earliest in (level, raster)
    scan order.  Returns the levels with `ok` updated."""
    cell = torch.cat([lk.r_final * W + lk.c_final for lk in levels], dim=1)
    ok = torch.cat([lk.ok for lk in levels], dim=1)
    keep = _dedup_compacted(cell, ok, H * W + 1)
    sizes = [lk.ok.shape[1] for lk in levels]
    return [lk._replace(ok=k) for lk, k in
            zip(levels, torch.split(keep, sizes, dim=1))]


def compact_levels(levels: list[LevelKeypoints], capacity: int) -> dict:
    """The accepted keypoints of an octave's levels compacted to one
    (B, capacity) set in emission order (level-major, then raster).
    Returns ok, level (1-based detection level), x, y, s, response,
    type and the (B,) overflow of this compaction."""
    ok = torch.cat([lk.ok for lk in levels], dim=1)
    idx, valid, overflow = compact_rows(ok, capacity)
    cat = lambda f: torch.cat([getattr(lk, f) for lk in levels],
                              dim=1).gather(1, idx)
    level = torch.cat([torch.full_like(lk.type, i + 1)
                       for i, lk in enumerate(levels)], dim=1).gather(1, idx)
    return dict(ok=valid, level=level, x=cat("x"), y=cat("y"), s=cat("s"),
                response=cat("response"), type=cat("type"),
                overflow=overflow)


def detect_octave_sparse(resps, blurs, sig, pd: float, cfg: HesaffConfig,
                         octave: int = 0, valid_hw=None) -> dict:
    """Octave detection through detect_level: three levels, dedup, one
    compaction to the affine capacity.  Only one level's maps are alive
    at a time.  overflow counts the level capacities' and the affine
    capacity's drops."""
    H, W = resps.shape[-2], resps.shape[-1]
    cap = cfg.level_capacity(H, W, octave)
    levels = [detect_level(resps[:, l - 1], resps[:, l], resps[:, l + 1],
                           blurs[:, l], sig[l], pd, cap, cfg, valid_hw)
              for l in range(1, cfg.num_scales + 1)]
    levels = dedup_octave(levels, H, W)
    comp = compact_levels(levels, cfg.affine_capacity(H, W, octave))
    comp["overflow"] = comp["overflow"] + sum(lk.overflow for lk in levels)
    comp["n_cand"] = sum(lk.n_cand for lk in levels)
    return comp


def detect_octave_batch(resps, blurs, sig, pd: float, cfg: HesaffConfig,
                        octave: int = 0, valid_hw=None):
    """Whole-batch octave detection.

    resps, blurs: (B, L, H, W) with L = num_scales + 2; sig: per-level
    sigmas.  Octaves of SPARSE_PATH_PIXELS or more take the sparse path,
    smaller ones the dense walk.  valid_hw: None, or (B, 2) int32 true
    sizes of the octave's edge-padded images.  Returns a dict of (B,
    acap) fields ok / level / x / y / s / response / type, plus (B,)
    overflow and n_cand.
    """
    H, W = resps.shape[-2], resps.shape[-1]
    if H * W >= SPARSE_PATH_PIXELS:
        return detect_octave_sparse(resps, blurs, sig, pd, cfg, octave,
                                    valid_hw)
    return detect_octave_dense(resps, blurs, sig, pd, cfg, octave, valid_hw)


def detect_octave_dense(resps, blurs, sig, pd: float, cfg: HesaffConfig,
                        octave: int = 0, valid_hw=None) -> dict:
    """Whole-batch octave detection via the dense walk (K2)."""
    B = resps.shape[0]
    H, W = resps.shape[-2], resps.shape[-1]
    HW = H * W
    nl = cfg.num_scales
    acap = cfg.affine_capacity(H, W, octave)

    ok, cell, tab, cand = cuda_detect.detect_walk_octave(resps, blurs, cfg,
                                                         valid_hw)
    n_cand = cand.reshape(B, -1).sum(dim=1)
    idx, valid, overflow = compact_rows(ok.reshape(B, nl * HW), acap)
    level0 = idx // HW
    cellk = cell.reshape(B, nl * HW).gather(1, idx).long()
    # the table's five planes of level0 at the final cell
    chan = torch.arange(5, device=idx.device) * HW
    at = ((level0 * (5 * HW) + cellk)[..., None] + chan).reshape(B, -1)
    rec = tab.reshape(B, nl * 5 * HW).gather(1, at).reshape(B, acap, 5)
    b0k, b1k, b2k, valk, lxxk = rec.unbind(-1)
    rf = cellk // W
    cf = cellk - rf * W
    x = pd * (cf.float() + b0k)
    y = pd * (rf.float() + b1k)
    sig_v = torch.tensor(sig, dtype=torch.float32, device=resps.device)
    sk = pd * (sig_v[level0 + 1] * torch.exp2(fdiv(b2k, cfg.num_scales)))
    ptype = torch.where(
        valk < 0, HESSIAN_SADDLE,
        torch.where(lxxk < 0, HESSIAN_DARK, HESSIAN_BRIGHT)).to(torch.int32)
    keep = _dedup_compacted(cellk, valid, HW + 1)
    return dict(
        ok=keep, level=torch.where(valid, level0 + 1, 1).to(torch.int32),
        x=x, y=y, s=sk, response=valk, type=ptype,
        overflow=overflow, n_cand=n_cand,
    )
