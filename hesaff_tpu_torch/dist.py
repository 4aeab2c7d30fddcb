"""The grouped serving path: phase A, grouped patch extraction, SIFT.

Port of ``hesaff_tpu/dist.py``'s extraction_step_grouped (the step
bench.py, the fleet runner and the retrieval bench serve with), padded
(valid_hw) mode included, without torch.distributed.  The JAX package
splits the step into separately compiled stages; here one Python
function loops over the groups and every result stays on the device.

Phase A is batch.detect_affine_batch.  Phase B selects the accepted
keypoints of each workspace group (default_group_spec) into its fixed
capacity, sorted by |a21| within the group, and extracts their patches
with the fused patch kernel (ops/cuda_patches): at full resolution up
to FULL_RES_GROUP_MAX, and above it from the downsampled pyramid level
that tail_source_plan picks (the "pyramid tail").  Keypoints that
overflow a group's capacity, or whose workspace exceeds the last group,
are counted.  One masked SIFT pass (ops/cuda_sift) describes the slots
whose patch is valid.

Each stage runs inside a torch.profiler span ("phase A", "group N:
select", "group N: patches", "direct branch", "SIFT"), so a profile of
one call attributes host time to the stages; without an active
profiler a span is one host-side call on entry and one on exit.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch
from torch.profiler import record_function

from hesaff_tpu_torch.batch import as_valid_hw, detect_affine_batch
from hesaff_tpu_torch.config import DEFAULT_CONFIG, HesaffConfig
from hesaff_tpu_torch.ops.batching import compact_indices
from hesaff_tpu_torch.ops.cuda_patches import (extract_group,
                                               extract_group_scaled)
from hesaff_tpu_torch.ops.cuda_sift import describe_masked
from hesaff_tpu_torch.patches import (_min_workspace, direct_patches,
                                      extract_bucket_batch)
from hesaff_tpu_torch.pipeline import resolve_device
from hesaff_tpu_torch.pyramid import scaled_first_level

# Largest group extracted from the full-resolution image; larger groups
# warp from a downsampled level.  The JAX package chose 384 because its
# fused TPU kernel stops fitting the 16 MB VMEM budget above it; the
# port keeps the value because it decides which keypoints are warped
# from a downsampled level, and so changes results.
FULL_RES_GROUP_MAX = 384

_FIELDS = ("x", "y", "s", "a11", "a12", "a21", "a22", "response")


class DenseFeatures(NamedTuple):
    """Fixed-capacity output of the grouped path (masked by `valid`)."""

    valid: torch.Tensor     # (K,) bool
    img_idx: torch.Tensor   # (K,) int32 index into the image batch
    x: torch.Tensor         # (K,)
    y: torch.Tensor
    s: torch.Tensor
    a11: torch.Tensor
    a12: torch.Tensor
    a21: torch.Tensor
    a22: torch.Tensor
    response: torch.Tensor
    type: torch.Tensor      # (K,) int32
    desc: torch.Tensor      # (K, 128) uint8; zero where not valid
    overflow: torch.Tensor  # () int64: keypoints dropped by capacity


def default_group_spec(height: int, width: int,
                       cfg: HesaffConfig = DEFAULT_CONFIG,
                       per_image_cap: int = 512, batch: int = 1):
    """Static (group bound, capacity) pairs for an image size.

    Capacities follow the keypoint distribution measured on dense
    synthetic 800x640 imagery at batch 16 (occupancy 18228 / 8601 /
    2101 / 643 / 92 / 4 of 16384 slots) plus ~13% headroom, pooled
    across the batch, rounded up to 32.  Groups above min(H, W) + 2
    cannot pass the border check and are left out.
    """
    limit = min(height, width) + 2
    total = per_image_cap * batch
    sizes = (49, 97, 193, 385, 641, 1025)
    fracs = (1.26, 0.6, 0.15, 0.046, 0.0075, 0.002)
    spec = []
    for bsize, frac in zip(sizes, fracs):
        cap = max(32, int(total * frac))
        cap = ((cap + 31) // 32) * 32
        spec.append((bsize, cap))
        if bsize >= limit:
            break
    return tuple(spec)


def tail_source_plan(bsize: int, base_pd: float):
    """(ps, octave, bucket_src) for a pyramid-tail group.

    ps: the smallest power-of-two downsample whose source workspace
    2*ceil((bsize-2)/(2 ps))+3 fits FULL_RES_GROUP_MAX; octave: the
    pyramid octave whose first level has that pixel distance (relative
    to base_pd, 0.5 under upscale_input); bucket_src: the source
    workspace bound.
    """
    ps = 2.0
    while (2 * ((bsize - 2 + 2 * ps - 1) // (2 * ps)) + 3
           > FULL_RES_GROUP_MAX):
        ps *= 2.0
    octave = int(round(math.log2(ps / base_pd)))
    bucket_src = int(2 * -(-(bsize - 2) // (2 * ps)) + 3)
    return ps, octave, bucket_src


def tail_source_level(images, cfg: HesaffConfig, octave: int, levels_a,
                      cache: dict):
    """Octave `octave`'s first level: phase A's by-product where phase A
    reached that octave (levels_a[octave - 1]), else computed once and
    kept in `cache`."""
    if octave not in cache:
        cache[octave] = (
            levels_a[octave - 1] if 0 <= octave - 1 < len(levels_a)
            else scaled_first_level(images, cfg, octave))
    return cache[octave]


def _workspace(flat, cfg: HesaffConfig):
    """(ws, its) of every flat slot: ws = S + 2, its = S / P."""
    S = 2 * torch.ceil(flat["s"] * cfg.mr_size).to(torch.int32) + 1
    its = S.float() / torch.full((), cfg.patch_size, dtype=torch.float32,
                                 device=S.device)
    return S + 2, its


def _gather(flat, idx, valid, ncap: int, sort: bool):
    """Keypoint fields of compacted slots; with `sort`, valid slots are
    ordered by |a21| (stable), padding last, as the JAX package orders
    each group's slots."""
    if sort:
        key = torch.where(valid, flat["a21"][idx].abs(), math.inf)
        order = torch.sort(key, stable=True).indices
        idx, valid = idx[order], valid[order]
    gi = (idx // ncap).to(torch.int32)
    a = {k: flat[k][idx] for k in _FIELDS}
    a["type"] = flat["type"][idx].to(torch.int32)
    return gi, a, valid


def describe_valid(patches, valid, cfg: HesaffConfig):
    """uint8 descriptors of the valid slots; zero rows elsewhere (one
    masked SIFT launch over every slot on the card)."""
    with record_function("SIFT"):
        return describe_masked(patches, valid, cfg)


def phase_a(images: torch.Tensor, cfg: HesaffConfig, valid_hw=None):
    """Phase A with flat per-slot fields; valid_hw: None or (B, 2) int32
    true sizes of edge-padded images.

    Returns (flat fields (B * N_cap,), next_firsts, candidate overflow,
    slots per image)."""
    with record_function("phase A"):
        out = detect_affine_batch(images, cfg, valid_hw)
    levels_a = out.pop("next_firsts")
    flat = {k: v.reshape(-1) for k, v in out.items()
            if k not in ("overflow", "n_cand")}
    return flat, levels_a, out["overflow"].sum(), out["ok"].shape[1]


def _mixed(cfg: HesaffConfig) -> bool:
    """Whether any keypoint can take the direct warp; under the default
    configuration none can (its smallest workspace is above
    oversample_cutoff * P + 2)."""
    return _min_workspace(cfg) <= cfg.oversample_cutoff * cfg.patch_size + 2


def group_selections(flat, cfg: HesaffConfig, groups: Sequence[tuple],
                     ncap: int):
    """Per group, in order: (bound, previous bound, img_idx, fields,
    valid, overflow) of the accepted keypoints with ws in (previous,
    bound], compacted into the group's capacity.  Direct-branch
    keypoints are left out of the full-resolution groups when the
    configuration has any."""
    ws, its = _workspace(flat, cfg)
    skip = (its <= cfg.oversample_cutoff) if _mixed(cfg) else None
    prev = 0
    for bsize, bcap in groups:
        with record_function(f"group {bsize}: select"):
            m = flat["ok"] & (ws > prev) & (ws <= bsize)
            full = bsize <= FULL_RES_GROUP_MAX
            if full and skip is not None:
                m = m & ~skip
            idx, valid, over = compact_indices(m, bcap)
            gi, a, valid = _gather(flat, idx, valid, ncap,
                                   sort=full or cfg.tail_from_pyramid)
        yield bsize, prev, gi, a, valid, over
        prev = bsize


def group_patches(images, cfg: HesaffConfig, bsize: int, prev: int, gi, a,
                  valid, levels_a, cache: dict, valid_hw=None):
    """Patches and ok flags of one group's selection: at full
    resolution up to FULL_RES_GROUP_MAX, above it from the pyramid level
    tail_source_plan picks (or, with tail_from_pyramid off, through the
    reference's full-resolution bucket path, slots unsorted).  valid_hw:
    the true sizes of edge-padded images, for the corner check."""
    kp = (gi, *(a[k] for k in ("x", "y", "s", "a11")))
    with record_function(f"group {bsize}: patches"):
        if bsize <= FULL_RES_GROUP_MAX:
            return extract_group(images, bsize, *kp, a["a21"], a["a22"],
                                 cfg, valid, valid_hw)
        if cfg.tail_from_pyramid:
            ps, octave, bucket_src = tail_source_plan(
                bsize, 0.5 if cfg.upscale_input else 1.0)
            src = tail_source_level(images, cfg, octave, levels_a, cache)
            return extract_group_scaled(
                src.contiguous(), ps, bucket_src, *kp, a["a21"], a["a22"],
                cfg, valid, orig_hw=tuple(images.shape[-2:]),
                valid_hw=valid_hw)
        return extract_bucket_batch(images, bsize, *kp, a["a12"], a["a21"],
                                    a["a22"], cfg, active=valid,
                                    prev_bucket=prev, valid_hw=valid_hw)


def extraction_step_grouped(images, cfg: HesaffConfig,
                            groups: Sequence[tuple], valid_hw=None,
                            device=None) -> DenseFeatures:
    """Phase A, grouped patch extraction and masked SIFT for a batch.

    images: (B, H, W) float32 array or tensor; groups: ((bound,
    capacity), ...) from default_group_spec; valid_hw: optional (B, 2)
    int32 true sizes when the batch is edge-padded to a shape bucket
    (the detection window and every group's corner check use them, as
    in extract_batch); device: where to run (default: the tensor's
    device, or the GPU for numpy input; pass "cpu" to run on the CPU).
    Returns DenseFeatures of tensors on the device.
    """
    images = torch.as_tensor(images, dtype=torch.float32,
                             device=resolve_device(images, device))
    images = images.contiguous()
    valid_hw = as_valid_hw(valid_hw, images.device)
    flat, levels_a, overflow, ncap = phase_a(images, cfg, valid_hw)
    levels = {}
    pieces = []
    for bsize, prev, gi, a, valid, over in group_selections(flat, cfg, groups,
                                                           ncap):
        pk, pok = group_patches(images, cfg, bsize, prev, gi, a, valid,
                                levels_a, levels, valid_hw)
        pieces.append((pk, pok, gi, a))
        overflow = overflow + over
    ws, its = _workspace(flat, cfg)
    overflow = overflow + (flat["ok"] & (ws > groups[-1][0])).sum()
    if _mixed(cfg):
        with record_function("direct branch"):
            dcap = max(64, groups[0][1] // 4)
            idx, valid, over = compact_indices(
                flat["ok"] & (its <= cfg.oversample_cutoff), dcap)
            gi, a, valid = _gather(flat, idx, valid, ncap, sort=False)
            pk, pok = direct_patches(images, gi, a["x"], a["y"], a["s"],
                                     a["a11"], a["a21"], a["a22"], cfg,
                                     valid, valid_hw)
        pieces.append((pk, pok, gi, a))
        overflow = overflow + over

    patches = torch.cat([p[0] for p in pieces])
    pvalid = torch.cat([p[1] for p in pieces])
    fields = {k: torch.cat([p[3][k] for p in pieces])
              for k in (*_FIELDS, "type")}
    return DenseFeatures(
        valid=pvalid, img_idx=torch.cat([p[2] for p in pieces]),
        **fields, desc=describe_valid(patches, pvalid, cfg),
        overflow=overflow)
