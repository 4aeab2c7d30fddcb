"""Batched multi-image extraction: the port's main path.

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
(utils/profiling.span).  Phase B: the keypoint arrays go
to the host, accepted keypoints of the whole batch are grouped by patch
workspace bucket, each bucket's patches are extracted on the device
(through the fused patch kernel on a GPU), and one SIFT pass (the SIFT
kernel on a GPU) describes them all.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from hesaff_tpu_torch.affine_shape import adapt_flat
from hesaff_tpu_torch.config import DEFAULT_CONFIG, HesaffConfig
from hesaff_tpu_torch.detect import detect_octave_batch, detect_octave_sparse
from hesaff_tpu_torch.ops.cuda_sift import sift_descriptors
from hesaff_tpu_torch.ops.linalg import rectify_up_is_up
from hesaff_tpu_torch.patches import (BUCKET_SIZES, bucket_for,
                                      extract_bucket_batch, patch_image_size)
from hesaff_tpu_torch.pipeline import ExtractStats, Features, resolve_device
from hesaff_tpu_torch.pyramid import (build_octave, level_sigmas,
                                      prepare_first_level)
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


def _ladder(images: torch.Tensor, cfg: HesaffConfig):
    """(octave, pixel distance) of each octave of the ladder down to
    min_octave_size, each built inside an "A: ladder" span (octave 0's
    with the initial blur)."""
    fits = lambda t: min(t.shape[-2:]) > cfg.min_octave_size
    with span("A: ladder"):
        cur, pd = prepare_first_level(images, cfg)
        o = build_octave(cur, pd, cfg) if fits(cur) else None
    while o is not None:
        yield o, pd
        cur, pd = o.next_first, pd * 2.0
        if not fits(cur):
            return
        with span("A: ladder"):
            o = build_octave(cur, pd, cfg)


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
    """
    B = images.shape[0]
    sig = level_sigmas(cfg)
    vhw = as_valid_hw(valid_hw, images.device)
    if vhw is not None and cfg.upscale_input:
        vhw = vhw * 2
    fields = defaultdict(list)
    next_firsts = []
    for octave, (o, pd) in enumerate(_ladder(images, cfg)):
        with span("A: detect"):
            comp = detect_octave_batch(o.resps, o.blurs, sig, pd, cfg,
                                       octave=octave, valid_hw=vhw)
        if vhw is not None:
            # the pyramid floor-halves the true size too
            vhw = vhw // 2
        with span("A: affine"):
            ar = adapt_flat(*octave_affine_inputs(comp, o.blurs, pd, cfg))
            r11, r12, r21, r22 = rectify_up_is_up(ar.u11, ar.u12, ar.u21,
                                                  ar.u22)
            shp = comp["ok"].shape
            fields["ok"].append(comp["ok"] & ar.ok.reshape(shp))
            fields["det_ok"].append(comp["ok"])
            for k in ("x", "y", "s", "response", "type"):
                fields[k].append(comp[k])
            for k, v in (("a11", r11), ("a12", r12), ("a21", r21),
                         ("a22", r22)):
                fields[k].append(v.reshape(shp))
            fields["overflow"].append(comp["overflow"][:, None])
            fields["n_cand"].append(comp["n_cand"][:, None])
        next_firsts.append(o.next_first)
    if not fields:
        z = lambda dt: torch.zeros((B, 0), dtype=dt, device=images.device)
        out = {k: z(dt) for k, dt in (
            ("ok", torch.bool), ("det_ok", torch.bool),
            ("x", torch.float32), ("y", torch.float32),
            ("s", torch.float32), ("response", torch.float32),
            ("type", torch.int32), ("a11", torch.float32),
            ("a12", torch.float32), ("a21", torch.float32),
            ("a22", torch.float32), ("overflow", torch.int64),
            ("n_cand", torch.int64))}
    else:
        out = {k: torch.cat(v, dim=1) for k, v in fields.items()}
    out["next_firsts"] = next_firsts
    return out


def _pad_to(n: int, minimum: int = 64) -> int:
    return max(minimum, 1 << (n - 1).bit_length()) if n else minimum


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

    Each Features.desc is (n, sb*sb*ob) uint8, an image with no
    descriptor included (0, sb*sb*ob).  Here the port departs from the
    JAX package, whose empty batch gives (0, 128) at any bin layout.
    """
    images = torch.as_tensor(images, dtype=torch.float32,
                             device=resolve_device(images, device))
    images = images.contiguous()
    B = images.shape[0]
    valid_hw = as_valid_hw(valid_hw, images.device)
    out = detect_affine_batch(images, cfg, valid_hw)
    out.pop("next_firsts")
    out = {k: v.cpu().numpy() for k, v in out.items()}

    ok = out["ok"]
    num_kp = int(out["det_ok"].sum())
    num_cand = int(out["n_cand"].sum())
    cand_overflow = int(out["overflow"].sum())

    img_idx, slot = np.nonzero(ok)
    fields = {k: out[k][img_idx, slot]
              for k in ("x", "y", "s", "response", "type",
                        "a11", "a12", "a21", "a22")}
    n_aff = len(img_idx)

    patches = torch.zeros((n_aff, cfg.patch_size, cfg.patch_size),
                          dtype=torch.float32, device=images.device)
    patch_ok = np.zeros(n_aff, bool)
    bucket_overflow = 0
    if n_aff:
        S = patch_image_size(fields["s"], cfg.mr_size)
        groups = defaultdict(list)
        for i, w in enumerate(S + 2):
            b = bucket_for(int(w))
            if b < 0:
                bucket_overflow += 1
                continue
            groups[b].append(i)
        dev = images.device
        for b, idx in sorted(groups.items()):
            idx = np.asarray(idx)
            npad = _pad_to(len(idx))
            sel = np.zeros(npad, np.int64)
            sel[: len(idx)] = idx
            bi = BUCKET_SIZES.index(b)
            arg = lambda a: torch.as_tensor(a[sel], device=dev)
            pk, pok = extract_bucket_batch(
                images, b, arg(img_idx.astype(np.int32)),
                *(arg(fields[k]) for k in
                  ("x", "y", "s", "a11", "a12", "a21", "a22")),
                cfg, active=torch.arange(npad, device=dev) < len(idx),
                prev_bucket=BUCKET_SIZES[bi - 1] if bi else 0,
                valid_hw=valid_hw,
            )
            patches[torch.as_tensor(idx, device=dev)] = pk[: len(idx)]
            patch_ok[idx] = pok[: len(idx)].cpu().numpy()

    described = np.nonzero(patch_ok)[0]
    n_desc = len(described)
    if n_desc:
        pin = patches[torch.as_tensor(described, device=images.device)]
        descs = sift_descriptors(pin, cfg).cpu().numpy().astype(np.uint8)
    else:
        descs = np.zeros((0, cfg.spatial_bins ** 2 * cfg.orientation_bins),
                         np.uint8)

    feats_out = []
    di = img_idx[described]
    for bimg in range(B):
        m = di == bimg
        rows = described[m]
        feats_out.append(Features(
            x=fields["x"][rows], y=fields["y"][rows], s=fields["s"][rows],
            a11=fields["a11"][rows], a12=fields["a12"][rows],
            a21=fields["a21"][rows], a22=fields["a22"][rows],
            response=fields["response"][rows],
            type=fields["type"][rows].astype(np.int32),
            desc=descs[m],
        ))
    stats = ExtractStats(
        num_candidates=num_cand, num_keypoints=num_kp, num_affine=n_aff,
        num_described=n_desc, candidate_overflow=cand_overflow,
        bucket_overflow=bucket_overflow,
    )
    return (feats_out, stats) if return_stats else feats_out
