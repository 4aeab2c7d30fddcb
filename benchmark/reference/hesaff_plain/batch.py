"""Phase A of a batch, plain PyTorch on every device.

Frozen copy of ``detect_affine_batch`` and its helpers from
``hesaff_tpu_torch/batch.py``: for every octave, the blur + DoH ladder,
the detection walk (dense, or sparse for octaves of 2^23 px or more),
and the affine adaptation of the cross-image flattened keypoints; then
the rectified frames.
"""

from __future__ import annotations

from collections import defaultdict

import torch

from benchmark.reference.hesaff_plain.affine_shape import adapt_flat
from benchmark.reference.hesaff_plain.config import HesaffConfig
from benchmark.reference.hesaff_plain.detect import detect_octave_batch
from benchmark.reference.hesaff_plain.ops.linalg import rectify_up_is_up
from benchmark.reference.hesaff_plain.pyramid import (build_octave, level_sigmas,
                                      prepare_first_level)


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
    cur, pd = prepare_first_level(images, cfg)
    vhw = as_valid_hw(valid_hw, images.device)
    if vhw is not None and cfg.upscale_input:
        vhw = vhw * 2
    fields = defaultdict(list)
    next_firsts = []
    octave = 0
    while (cur.shape[-2] > cfg.min_octave_size
           and cur.shape[-1] > cfg.min_octave_size):
        o = build_octave(cur, pd, cfg)
        comp = detect_octave_batch(o.resps, o.blurs, sig, pd, cfg,
                                   octave=octave, valid_hw=vhw)
        if vhw is not None:
            # the pyramid floor-halves the true size too
            vhw = vhw // 2
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
        cur = o.next_first
        pd *= 2.0
        octave += 1
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


