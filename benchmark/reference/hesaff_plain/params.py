"""Constant tables of the extraction path, as tensors on a device.

The system has no learned weights; what a run reads besides its images
is the configuration and these tables derived from it: the SMM
Gaussian mask, the circular SIFT mask and the spatial bin weights (from
``ops/masks.py``), and the Gaussian ladder taps (from ``gaussian_taps``
and ``level_sigmas``).
"""

from __future__ import annotations

import functools

import torch

from benchmark.reference.hesaff_plain.config import HesaffConfig
from benchmark.reference.hesaff_plain.ops import masks
from benchmark.reference.hesaff_plain.pyramid import first_level_taps, ladder_taps


@functools.lru_cache(maxsize=16)
def tables(cfg: HesaffConfig, device) -> dict:
    """Every constant table the path reads, on `device`.

    Keys: smm_mask (G, G), circ_mask (P, P), spatial_bins (P, bins),
    first_taps (k,) (the initial blur, or None), ladder_taps (list of
    (k,) tensors, level i -> i+1).  The tensors are shared between
    callers and must not be written to.
    """
    dev = torch.device(device)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    first = first_level_taps(cfg)
    return dict(
        smm_mask=t(masks.smm_gauss_mask(cfg.smm_window_size)),
        circ_mask=t(masks.circular_gauss_mask(cfg.patch_size)),
        spatial_bins=t(masks.sift_spatial_bins(cfg.patch_size,
                                               cfg.spatial_bins)),
        first_taps=None if first is None else t(first),
        ladder_taps=[t(k) for k in ladder_taps(cfg)],
    )
