"""Batched multi-image extraction: phase A, the bucket phase B, and
extract_batch.

Port of ``hesaff_tpu/batch.py``, padded (valid_hw) mode included: a
batch edge-padded to a shape bucket (utils/fleet.pad_to_bucket) carries
each image's true size, which the detection window and the patch
corner check use, so padding adds no keypoints.  Near-edge blur and
affine windows read the replicated padding where the unpadded run reads
its replicate border or zeros: the documented tolerance of the mode.

Phase A (device): for every octave, the blur + DoH ladder, the
detection walk (dense, or sparse for octaves of 2^23 px or more), and
the affine adaptation of the cross-image flattened
keypoints; then the rectified frames.  Each octave's three stages run
in profiler spans "A: ladder", "A: detect" and "A: affine"
(utils/profiling.span); on the card each is a CUDA graph, captured at
a shape's second call and replayed after it (PHASE_A, utils/graphs),
but for a sparse octave's detection.

The bucket phase B (bucket_phase_b), shared by extract_batch and the
bucket step of dist.py: per BUCKET_SIZES bucket of a table, the
accepted keypoints with a workspace in the bucket, compacted in
row-major slot order into the bucket's capacity (a "bucket N" span),
their patches through patches.extract_bucket_batch, then one masked
SIFT pass ("assemble", "SIFT").  The slot gathering and assembly are
shared with the grouped serving path (dist.extraction_step_grouped).
extract_batch reads the per-bucket counts of accepted keypoints once
and gives them as the capacities, so no capacity drops a keypoint.
"""

from __future__ import annotations

import functools
import math
from collections import defaultdict
from typing import NamedTuple, Sequence

import numpy as np
import torch

from hesaff_tpu_torch import detect, params
from hesaff_tpu_torch.affine_shape import adapt_flat
from hesaff_tpu_torch.config import DEFAULT_CONFIG, HesaffConfig
from hesaff_tpu_torch.detect import detect_octave_sparse
from hesaff_tpu_torch.ops import cuda_affine, cuda_blur, cuda_detect
from hesaff_tpu_torch.ops.batching import compact_indices
from hesaff_tpu_torch.ops.cuda_patches import patch_geometry
from hesaff_tpu_torch.ops.cuda_sift import describe_masked
from hesaff_tpu_torch.ops.linalg import rectify_up_is_up
from hesaff_tpu_torch.patches import BUCKET_SIZES, extract_bucket_batch
from hesaff_tpu_torch.pipeline import ExtractStats, Features, resolve_device
from hesaff_tpu_torch.pyramid import (build_octave, level_sigmas,
                                      octave_shapes, prepare_first_level)
from hesaff_tpu_torch.utils import graphs
from hesaff_tpu_torch.utils.profiling import span


def _detect_one_octave(resps, blurs, sig, pd: float, cfg: HesaffConfig,
                       octave: int = 0, valid_hw=None) -> dict:
    """Per-image detection of one octave through detect_level, the
    reference form of the oracle tests (JAX's batch._detect_one_octave).

    resps, blurs: (L, H, W); valid_hw: None or the (2,) true size.
    Returns the compacted keypoint dict of (affine capacity,) fields,
    overflow and n_cand.
    """
    comp = detect_octave_sparse(resps[None], blurs[None], sig, pd, cfg,
                                octave, as_valid_hw(valid_hw, resps.device))
    return {k: v[0] for k, v in comp.items()}


def octave_affine_inputs(comp: dict, blurs: torch.Tensor, pd: float,
                         cfg: HesaffConfig):
    """adapt_flat's arguments for one octave's compacted keypoints.

    comp: detect_octave_batch's (B, cap) fields; blurs: the octave's
    (B, L, H, W) ladder.  Keypoints sample the level below their
    detection level (the prevBlur quirk); inactive slots get
    coordinates that are safe to sample.
    """
    B, cap = comp["ok"].shape
    H, W = blurs.shape[-2], blurs.shape[-1]
    ok = comp["ok"].reshape(-1)
    safe = lambda k, d: torch.where(ok, comp[k].reshape(-1), d)
    img_idx = torch.arange(B, dtype=torch.int32,
                           device=ok.device).repeat_interleave(cap)
    return (blurs[:, :cfg.num_scales], img_idx,
            comp["level"].reshape(-1) - 1, safe("x", (W // 2) * pd),
            safe("y", (H // 2) * pd), safe("s", 2.0 * pd), pd, cfg, ok)


def as_valid_hw(valid_hw, device):
    """valid_hw as the kernels take it: None, or (B, 2) contiguous
    int32 true sizes on `device`."""
    if valid_hw is None:
        return None
    return torch.as_tensor(valid_hw, dtype=torch.int32,
                           device=device).reshape(-1, 2).contiguous()


# phase A's CUDA graphs by key; a replay adds to these launch counters
# what the kernels of its capture added
PHASE_A = graphs.Graphs(launches=(
    (cuda_blur, "LAUNCHES"), (cuda_blur, "GENERIC_LAUNCHES"),
    (cuda_detect, "LAUNCHES"), (cuda_detect, "MAPS_LAUNCHES"),
    (cuda_affine, "LAUNCHES"), (cuda_affine, "GENERIC_LAUNCHES")))


def _ladder_stage(cur: torch.Tensor, pd: float, cfg: HesaffConfig,
                  first: bool):
    """One octave's ladder from its first level (octave 0's from the
    images, through the initial blur)."""
    if first:
        cur, _ = prepare_first_level(cur, cfg)
    o = build_octave(cur, pd, cfg)
    return {"blurs": o.blurs, "resps": o.resps, "next_first": o.next_first}


def _detect_stage(resps, blurs, vhw, sig, pd: float, cfg: HesaffConfig,
                  octave: int):
    """One octave's detection (detect.detect_octave_batch)."""
    return detect.detect_octave_batch(resps, blurs, sig, pd, cfg, octave, vhw)


def _affine_stage(blurs, comp: dict, pd: float, cfg: HesaffConfig):
    """One octave's adaptation and rectified frames: its fields of
    detect_affine_batch, (B, acap) each ((B, 1) overflow and n_cand)."""
    ar = adapt_flat(*octave_affine_inputs(comp, blurs, pd, cfg))
    r11, r12, r21, r22 = rectify_up_is_up(ar.u11, ar.u12, ar.u21, ar.u22)
    shp = comp["ok"].shape
    out = {"ok": comp["ok"] & ar.ok.reshape(shp), "det_ok": comp["ok"]}
    for k in ("x", "y", "s", "response", "type"):
        out[k] = comp[k]
    for k, v in (("a11", r11), ("a12", r12), ("a21", r21), ("a22", r22)):
        out[k] = v.reshape(shp)
    out["overflow"] = comp["overflow"][:, None]
    out["n_cand"] = comp["n_cand"][:, None]
    return out


def detect_affine_batch(images: torch.Tensor, cfg: HesaffConfig,
                        valid_hw=None) -> dict:
    """Phase A over an image batch: (B, H, W) -> dict of (B, N_cap).

    valid_hw: None, or (B, 2) int32 true sizes of edge-padded images
    (doubled under upscale_input, floor-halved after each octave as the
    pyramid halves).

    Fields: ok (detected and adapted), det_ok (detected), x, y, s,
    response, type, a11..a22 (rectified frame), (B, octaves) overflow
    and n_cand, and next_firsts: the list of the octaves' next first
    levels (next_firsts[o - 1] is octave o's first level, a by-product
    of the ladder that the grouped path's pyramid tail samples).

    Each octave's stages run in the spans "A: ladder" (octave 0's with
    the initial blur), "A: detect" and "A: affine".  On the card they
    are CUDA graphs from a shape's second call on (PHASE_A),
    but for the detection of a sparse octave, which runs eager between
    two graphs; the fields returned are copies the caller may keep.
    """
    B, H, W = images.shape
    sig = level_sigmas(cfg)
    vhw = as_valid_hw(valid_hw, images.device)
    if vhw is not None and cfg.upscale_input:
        vhw = vhw * 2
    shapes = octave_shapes(H, W, cfg)
    # which octaves' detection runs eager between graphs
    sparse = tuple(detect.sparse_octave(h, w) for h, w, _ in shapes)
    key = (tuple(images.shape), images.dtype, cfg, vhw is not None, sparse)
    fields = defaultdict(list)
    next_firsts = []
    # K4 reads the mask of params.tables (a bounded cache) by address
    tables = params.tables(cfg, str(images.device))
    with PHASE_A.call(key, images.device, holds=tables) as run:
        cur = images
        for octave, (h, w, pd) in enumerate(shapes):
            o = run.stage("A: ladder", functools.partial(
                _ladder_stage, pd=pd, cfg=cfg, first=octave == 0), cur)
            stage = run.eager if sparse[octave] else run.stage
            comp = stage("A: detect", functools.partial(
                _detect_stage, sig=sig, pd=pd, cfg=cfg, octave=octave),
                o["resps"], o["blurs"], vhw)
            if vhw is not None:
                # the pyramid floor-halves the true size too
                vhw = vhw // 2
            f = run.stage("A: affine", functools.partial(
                _affine_stage, pd=pd, cfg=cfg), o["blurs"], comp)
            for k, v in f.items():
                fields[k].append(v)
            next_firsts.append(run.result(o["next_first"]))
            cur = o["next_first"]
        if not fields:
            z = lambda dt: torch.zeros((B, 0), dtype=dt,
                                       device=images.device)
            out = {k: z(dt) for k, dt in (
                ("ok", torch.bool), ("det_ok", torch.bool),
                ("x", torch.float32), ("y", torch.float32),
                ("s", torch.float32), ("response", torch.float32),
                ("type", torch.int32), ("a11", torch.float32),
                ("a12", torch.float32), ("a21", torch.float32),
                ("a22", torch.float32), ("overflow", torch.int64),
                ("n_cand", torch.int64))}
        else:
            # new tensors: the graphs' own outputs stay in their pool
            out = {k: torch.cat(v, dim=1) for k, v in fields.items()}
    out["next_firsts"] = next_firsts
    return out


_FIELDS = ("x", "y", "s", "a11", "a12", "a21", "a22", "response")


class DenseFeatures(NamedTuple):
    """Fixed-capacity output of phase B (masked by `valid`)."""

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


def phase_a(images: torch.Tensor, cfg: HesaffConfig, valid_hw=None):
    """Phase A with flat per-slot fields; valid_hw: None or (B, 2) int32
    true sizes of edge-padded images.

    Returns (flat fields (B * N_cap,), next_firsts, candidate overflow,
    slots per image)."""
    with span("phase A"):
        out = detect_affine_batch(images, cfg, valid_hw)
    levels_a = out.pop("next_firsts")
    flat = {k: v.reshape(-1) for k, v in out.items()
            if k not in ("overflow", "n_cand")}
    return flat, levels_a, out["overflow"].sum(), out["ok"].shape[1]


def gather_slots(flat, idx, valid, ncap: int, sort: bool):
    """Keypoint fields of compacted slots; with `sort`, valid slots are
    ordered by |a21| (stable), padding last, as the JAX package orders
    each group's slots.  Returns (img_idx, fields, valid)."""
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
    with span("SIFT"):
        return describe_masked(patches, valid, cfg)


def assemble(pieces, overflow, cfg: HesaffConfig) -> DenseFeatures:
    """DenseFeatures of (patches, ok, img_idx, fields) pieces, slots in
    piece order, described by one masked SIFT pass."""
    with span("assemble"):
        patches = torch.cat([p[0] for p in pieces])
        pvalid = torch.cat([p[1] for p in pieces])
        fields = {k: torch.cat([p[3][k] for p in pieces])
                  for k in (*_FIELDS, "type")}
        img_idx = torch.cat([p[2] for p in pieces])
    return DenseFeatures(valid=pvalid, img_idx=img_idx, **fields,
                         desc=describe_valid(patches, pvalid, cfg),
                         overflow=overflow)


def bucket_phase_b(images, flat, ncap: int, overflow, cfg: HesaffConfig,
                   buckets: Sequence[tuple], valid_hw=None):
    """Phase B of the bucket step from phase A's flat fields.

    Per bucket of `buckets` ((size, capacity), ...), in order (JAX
    dist.py _bucket_select_stage): the accepted keypoints with ws in
    (previous size, size] compacted into the bucket's capacity in
    row-major slot order, their patches at full resolution
    (patches.extract_bucket_batch); then one masked SIFT pass over every
    slot.  overflow: phase A's count, to which the keypoints over a
    capacity and those above the last bucket are added.  valid_hw: None
    or the (B, 2) true sizes of edge-padded images, for the corner
    check.  Returns (DenseFeatures, slots): slots, per bucket, the
    (capacity,) int64 index of each of its output slots into the flat
    fields (0 in padding slots).
    """
    _, ws, _ = patch_geometry(flat["s"], cfg)
    pieces, slots = [], []
    prev = 0
    for bsize, bcap in buckets:
        with span(f"bucket {bsize}"):
            m = flat["ok"] & (ws > prev) & (ws <= bsize)
            idx, valid, over = compact_indices(m, bcap)
            gi, a, valid = gather_slots(flat, idx, valid, ncap, sort=False)
            pk, pok = extract_bucket_batch(
                images, bsize, gi,
                *(a[k] for k in ("x", "y", "s", "a11", "a12", "a21", "a22")),
                cfg, active=valid, prev_bucket=prev, valid_hw=valid_hw)
        pieces.append((pk, pok, gi, a))
        slots.append(idx)
        overflow = overflow + over
        prev = bsize
    overflow = overflow + (flat["ok"] & (ws > buckets[-1][0])).sum()
    return assemble(pieces, overflow, cfg), slots


def extract_batch(images, cfg: HesaffConfig = DEFAULT_CONFIG,
                  return_stats: bool = False, valid_hw=None, device=None):
    """Extract features from a batch of same-size images.

    images: (B, H, W) float32 array or tensor; device: where to run
    (default: the tensor's device, or the GPU for numpy input; pass
    "cpu" to run on the CPU).  Returns a list of B Features (and an
    ExtractStats for the batch when return_stats is set).  On a GPU the
    patch and SIFT stages run the fused patch and SIFT kernels.

    valid_hw: optional (B, 2) int32 true sizes when the batch is
    edge-padded to a shape bucket (utils/fleet.pad_to_bucket): the
    detection window and the patch corner check use them, so padding
    adds no keypoints (near-edge affine windows may read replicated
    padding instead of the unpadded run's zeros: the documented
    tolerance of the mode).

    Phase A, one host read of the funnel's counts and of the accepted
    keypoints in each BUCKET_SIZES bucket, then bucket_phase_b with
    those counts as capacities; keypoints above the last bucket are
    counted in bucket_overflow.  Each Features holds its image's
    described keypoints in emission order (ascending phase-A slot); its
    desc is (n, sb*sb*ob) uint8, an image with no descriptor included
    (0, sb*sb*ob).  Here the port departs from the JAX package, whose
    empty batch gives (0, 128) at any bin layout.
    """
    images = torch.as_tensor(images, dtype=torch.float32,
                             device=resolve_device(images, device))
    images = images.contiguous()
    dev = images.device
    B = images.shape[0]
    valid_hw = as_valid_hw(valid_hw, dev)
    bounds = torch.tensor(BUCKET_SIZES, dtype=torch.int32, device=dev)
    out = detect_affine_batch(images, cfg, valid_hw)
    ncap = out["ok"].shape[1]
    flat = {k: v.reshape(-1) for k, v in out.items()
            if k not in ("overflow", "n_cand", "next_firsts")}

    # per bucket, and above the last one, the accepted keypoints
    _, ws, _ = patch_geometry(flat["s"], cfg)
    which = torch.bucketize(ws, bounds)
    in_bucket = (which == torch.arange(len(BUCKET_SIZES) + 1,
                                       device=dev)[:, None]) & flat["ok"]
    counts = torch.cat([torch.stack([out["n_cand"].sum(),
                                     flat["det_ok"].sum(),
                                     out["overflow"].sum()]),
                        in_bucket.sum(1)]).tolist()
    num_cand, num_kp, cand_overflow, *per_bucket = counts
    buckets = tuple((b, c) for b, c in zip(BUCKET_SIZES, per_bucket) if c)

    nd = cfg.spatial_bins ** 2 * cfg.orientation_bins
    cols = {k: np.zeros(0, np.float32) for k in _FIELDS}
    cols["type"] = np.zeros(0, np.int32)
    cols["desc"] = np.zeros((0, nd), np.uint8)
    img = np.zeros(0, np.int32)
    if buckets:
        dense, slots = bucket_phase_b(images, flat, ncap, 0, cfg, buckets,
                                      valid_hw)
        keep = dense.valid.cpu().numpy()
        order = np.argsort(torch.cat(slots).cpu().numpy()[keep])
        host = lambda t: t.cpu().numpy()[keep][order]
        cols = {k: host(getattr(dense, k)) for k in cols}
        img = host(dense.img_idx)
    ends = np.searchsorted(img, np.arange(B + 1))
    feats_out = [Features(**{k: v[lo:hi] for k, v in cols.items()})
                 for lo, hi in zip(ends[:-1], ends[1:])]
    stats = ExtractStats(
        num_candidates=num_cand, num_keypoints=num_kp,
        num_affine=sum(per_bucket), num_described=len(img),
        candidate_overflow=cand_overflow, bucket_overflow=per_bucket[-1],
    )
    return (feats_out, stats) if return_stats else feats_out
