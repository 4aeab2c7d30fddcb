"""SIFT descriptors of normalised patches, plain PyTorch on every device.

Frozen copy of the plain half of ``hesaff_tpu_torch/ops/cuda_sift.py``
(K6's plain version, ``sift.sift_descriptors``); the kernel launch is
left out.  Rows are sb * sb * ob wide.
"""

from __future__ import annotations

import torch

from benchmark.reference.hesaff_plain.sift import sift_descriptors as sift_plain


def sift_descriptors(patches: torch.Tensor, cfg):
    """(K, P, P) float32 patches -> (K, sb * sb * ob) float32 quantised
    values."""
    return sift_plain(patches, cfg)


def describe_masked(patches: torch.Tensor, valid: torch.Tensor, cfg):
    """(K, P, P) float32 patches, (K,) bool -> (K, sb * sb * ob) uint8:
    each valid slot's descriptor, zero rows where valid is false."""
    nb = cfg.spatial_bins ** 2 * cfg.orientation_bins
    desc = torch.zeros((patches.shape[0], nb), dtype=torch.uint8,
                       device=patches.device)
    sel = valid.nonzero(as_tuple=True)[0]
    if sel.numel():
        desc[sel] = sift_plain(patches[sel], cfg).to(torch.uint8)
    return desc
