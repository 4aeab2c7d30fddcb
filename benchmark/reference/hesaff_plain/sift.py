"""128-D SIFT descriptors of normalised patches (plain PyTorch).

Port of ``hesaff_tpu/sift.py`` (computeSiftDescriptor of the
reference): photometric normalisation inside the circular support
(mean -> 128, sigma -> 50, clamp [0, 255]), unhalved central-difference
gradients (one-sided at the edges), trilinear 4x4x8 binning written as
two float32 contractions with the spatial weight matrix, L2 normalise,
clip at 0.2, conditional renormalise, quantise min(int(512 v), 255).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.hesaff_plain import params
from benchmark.reference.hesaff_plain.config import HesaffConfig
from benchmark.reference.hesaff_plain.ops.linalg import fdiv, rdiv


def photometric_normalize(patches: torch.Tensor, support: torch.Tensor):
    """Normalise (K, P, P) to mean 128 / sigma 50 over the bool support.

    Patches with sigma < 1e-4 stay unchanged.
    """
    n = support.sum()
    msk = support[None]
    mean = (patches * msk).sum(dim=(1, 2), keepdim=True) / n
    var = torch.sqrt(torch.where(msk, (mean - patches) ** 2, 0.0)
                     .sum(dim=(1, 2), keepdim=True) / n)
    fac = rdiv(50.0, var)
    out = torch.clamp(128.0 + fac * (patches - mean), 0.0, 255.0)
    return torch.where(var < 0.0001, patches, out)


def patch_gradients(patches: torch.Tensor):
    """(K, P, P) -> (magnitude, orientation); unhalved differences."""
    gx = torch.cat([patches[:, :, 1:2] - patches[:, :, 0:1],
                    patches[:, :, 2:] - patches[:, :, :-2],
                    patches[:, :, -1:] - patches[:, :, -2:-1]], dim=2)
    gy = torch.cat([patches[:, 1:2, :] - patches[:, 0:1, :],
                    patches[:, 2:, :] - patches[:, :-2, :],
                    patches[:, -1:, :] - patches[:, -2:-1, :]], dim=1)
    return torch.sqrt(gx * gx + gy * gy), torch.atan2(gy, gx)


def _orientation_split(ori, val, n_bins: int):
    """Split val over the two neighbouring orientation bins: (K,P,P,n)."""
    o = fdiv(n_bins * (ori + 2.0 * math.pi), 2.0 * math.pi)
    bo0 = torch.floor(o)
    w1 = o - bo0
    b0 = bo0.long() % n_bins
    b1 = (b0 + 1) % n_bins
    oh0 = torch.nn.functional.one_hot(b0, n_bins).to(val.dtype)
    oh1 = torch.nn.functional.one_hot(b1, n_bins).to(val.dtype)
    return val[..., None] * ((1.0 - w1)[..., None] * oh0
                             + w1[..., None] * oh1)


def sift_descriptors(patches: torch.Tensor, cfg: HesaffConfig):
    """(K, P, P) float32 patches -> (K, 128) float32 quantised values."""
    tb = params.tables(cfg, str(patches.device))
    circ = tb["circ_mask"]
    spatial = tb["spatial_bins"]                     # (P, sb)
    sb = cfg.spatial_bins
    ob = cfg.orientation_bins

    patches = photometric_normalize(patches, circ > 0)
    mag, ori = patch_gradients(patches)
    w = _orientation_split(ori, circ[None] * mag, ob)  # (K, P, P, ob)
    t = torch.einsum("rb,krco->kbco", spatial, w)
    desc = torch.einsum("cd,kbco->kbdo", spatial, t)
    desc = desc.reshape(desc.shape[0], sb * sb * ob)

    norm = torch.sqrt((desc * desc).sum(dim=1, keepdim=True))
    desc = desc / norm
    clipped = torch.clamp_max(desc, cfg.max_bin_value)
    changed = (desc > cfg.max_bin_value).any(dim=1, keepdim=True)
    norm2 = torch.sqrt((clipped * clipped).sum(dim=1, keepdim=True))
    desc = torch.where(changed, clipped / norm2, clipped)
    return torch.clamp_max(torch.floor(512.0 * desc), 255.0)
