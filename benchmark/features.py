"""What the extraction cells hand to the program and take back.

A configuration file's ``hesaff`` object holds the HesaffConfig fields
that differ from the default; ``program_config`` makes the port's
config of it and ``reference_config`` the frozen reference's.
``host_features`` brings a DenseFeatures' valid keypoints to the host,
as a user of the serving path takes them: one copy of the geometry, one
of the descriptors, one of the image indices and the overflow count.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

GEOMETRY = ("x", "y", "s", "a11", "a12", "a21", "a22")


def _replace(cls, fields: dict):
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(fields) - known
    if unknown:
        raise ValueError(f"unknown HesaffConfig fields {sorted(unknown)}")
    return cls(**fields)


def program_config(config: dict):
    from hesaff_tpu_torch.config import HesaffConfig

    return _replace(HesaffConfig, config.get("hesaff", {}))


def reference_config(config: dict):
    from benchmark.reference.hesaff_plain.config import HesaffConfig

    return _replace(HesaffConfig, config.get("hesaff", {}))


def host_features(out, img_offset: int = 0) -> dict:
    """Valid keypoints of a DenseFeatures on the host: img (N,) int64
    (the call's image index + img_offset), the GEOMETRY fields (N,)
    float32, desc (N, D) uint8, overflow (int)."""
    v = out.valid
    geo = torch.stack([getattr(out, k) for k in GEOMETRY])[:, v].cpu()
    feats = {k: geo[j].numpy() for j, k in enumerate(GEOMETRY)}
    feats["img"] = out.img_idx[v].cpu().numpy().astype(np.int64) + img_offset
    feats["desc"] = out.desc[v].cpu().numpy()
    feats["overflow"] = int(out.overflow)
    return feats


def concat(parts: list) -> dict:
    """One feature dict of several, images numbered as given, overflow
    summed."""
    out = {k: np.concatenate([p[k] for p in parts])
           for k in (*GEOMETRY, "img", "desc")}
    out["overflow"] = sum(p["overflow"] for p in parts)
    return out
