"""Affine shape adaptation loop, plain PyTorch on every device.

Frozen copy of the plain half of ``hesaff_tpu_torch/ops/cuda_affine.py``
(K4's plain version, ``affine_shape.adapt_batch_plain``); the kernel
launch is left out.
"""

from __future__ import annotations


def adapt_plain(stack, img_idx, src, lx, ly, ratio, active, win, cfg,
                return_steps: bool = False):
    """Plain version of adapt; with return_steps also each keypoint's
    count of steps run (affine_shape.adapt_batch_plain)."""
    from benchmark.reference.hesaff_plain import params
    from benchmark.reference.hesaff_plain.affine_shape import adapt_batch_plain

    mask = params.tables(cfg, str(lx.device))["smm_mask"]
    return adapt_batch_plain(stack, img_idx, src, lx, ly, ratio, active,
                             win, cfg, mask, return_steps)


def adapt(stack, img_idx, src, lx, ly, ratio, active, win: int, cfg):
    """stack: (B, L, H, W) float32 blur levels; img_idx, src: (K,) int;
    lx, ly, ratio: (K,) float32 octave coordinates and s /
    (initial_sigma * pd); active: (K,) bool.

    Returns an affine_shape.AffineResult of (K,) tensors.
    """
    return adapt_plain(stack, img_idx, src, lx, ly, ratio, active, win, cfg)
