"""Batched Baumberg-Lindeberg affine shape adaptation.

Port of ``hesaff_tpu/affine_shape.py``.  Each keypoint iterates at most
max_iterations times: warp a smm_window^2 grid from the blur level
below its detection level (the prevBlur quirk), take the masked
second-moment matrix, apply its det-normalised inverse square root to
U, and check the reference's rules:

  * complex eigenvalues of U          -> drop
  * anisotropy l1/l2 > 6 either way   -> drop
  * 1 - l2/l1 < 0.05 twice in a row   -> converged
  * max_iterations without converging -> drop

The loop runs in the CUDA kernel (ops/plain_affine) for CUDA tensors;
``adapt_batch_plain`` below is its plain version, a batched port of
the JAX package's ``_adapt_one``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from benchmark.reference.hesaff_plain.config import HesaffConfig
from benchmark.reference.hesaff_plain.ops import plain_affine
from benchmark.reference.hesaff_plain.ops.linalg import eigenvalues_2x2, fdiv, inv_sqrt_2x2
from benchmark.reference.hesaff_plain.ops.warp import affine_grid, bilinear_sample_from


class AffineResult(NamedTuple):
    ok: torch.Tensor     # (K,) bool — converged (and never out of window)
    u11: torch.Tensor    # (K,) shape matrix U (det == 1)
    u12: torch.Tensor
    u21: torch.Tensor
    u22: torch.Tensor
    iters: torch.Tensor  # (K,) int32 — iteration index at convergence


def unclamped_window_size(cfg: HesaffConfig) -> int:
    """Sampling-window side before clamping to the octave size."""
    half = cfg.smm_window_size >> 1
    ratio_max = cfg.sigma_step**cfg.num_scales * math.sqrt(2.0)
    rownorm = math.sqrt(2.0) * cfg.anisotropy_max**0.25
    radius = int(math.ceil(half * ratio_max * rownorm)) + 2
    return ((2 * radius + 7) // 8) * 8


def sample_window_size(cfg: HesaffConfig, height: int, width: int) -> int:
    """Sampling-window side of one octave (covers the grid of every
    surviving keypoint; clamped to the octave size)."""
    return max(8, min(unclamped_window_size(cfg), height, width))


def _window_gradient(img: torch.Tensor):
    """Unhalved central differences, one-sided at the grid edges."""
    gx = torch.cat([img[..., :, 1:2] - img[..., :, 0:1],
                    img[..., :, 2:] - img[..., :, :-2],
                    img[..., :, -1:] - img[..., :, -2:-1]], dim=-1)
    gy = torch.cat([img[..., 1:2, :] - img[..., 0:1, :],
                    img[..., 2:, :] - img[..., :-2, :],
                    img[..., -1:, :] - img[..., -2:-1, :]], dim=-2)
    return gx, gy


def _warp_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the kernel's order: 32 lanes take
    every 32nd element in turn, then a butterfly (xor 16, 8, 4, 2, 1)
    adds the lanes; so the plain version and the kernel round alike."""
    K, N = x.shape
    pad = (-N) % 32
    if pad:
        x = torch.cat([x, x.new_zeros(K, pad)], dim=1)
    x = x.reshape(K, -1, 32)
    acc = x[:, 0]
    for s in range(1, x.shape[1]):
        acc = acc + x[:, s]
    lane = torch.arange(32, device=x.device)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[:, lane ^ o]
    return acc[:, 0]


def adapt_batch_plain(stack, img_idx, src, lx, ly, ratio, active,
                      win: int, cfg: HesaffConfig, mask: torch.Tensor,
                      return_steps: bool = False):
    """Plain version of the adaptation kernel.

    stack: (B, L, H, W) blur levels; img_idx, src: (K,) plane of each
    keypoint (image, level); lx, ly: (K,) octave coordinates; ratio:
    (K,) s / (initial_sigma * pd); active: (K,) bool; win: sampling
    window side; mask: (G, G) SMM mask.

    Returns an AffineResult, and with return_steps also the (K,) int32
    count of Baumberg steps each keypoint ran (until it converged,
    turned anisotropic or reached max_iterations; 0 where inactive).
    """
    B, L, H, W = stack.shape
    G = cfg.smm_window_size
    npx = float(G * G)
    planes = stack.reshape(B * L, H, W)
    plane = (img_idx.long() * L + src.long())[:, None, None]
    r0 = torch.clamp(ly.to(torch.int32) - win // 2, 0, H - win).float()
    c0 = torch.clamp(lx.to(torch.int32) - win // 2, 0, W - win).float()
    r0, c0 = r0[:, None, None], c0[:, None, None]

    K = lx.shape[0]
    dev = lx.device
    one = torch.ones(K, device=dev)
    u11, u12, u21, u22 = one, one * 0, one * 0, one
    ratio_bef = torch.zeros(K, device=dev)
    alive = active.clone()
    converged = torch.zeros(K, dtype=torch.bool, device=dev)
    violated = torch.zeros(K, dtype=torch.bool, device=dev)
    conv_iter = torch.zeros(K, dtype=torch.int32, device=dev)
    steps = torch.zeros(K, dtype=torch.int32, device=dev)

    for it in range(cfg.max_iterations):
        if not bool(alive.any()):
            break
        steps += alive
        wx, wy = affine_grid(G, G, lx, ly, u11 * ratio, u12 * ratio,
                             u21 * ratio, u22 * ratio)
        img, valid = bilinear_sample_from(planes, plane, wx, wy)
        y0f = torch.floor(wy)
        x0f = torch.floor(wx)
        oow = valid & ((y0f - r0 < 0) | (y0f - r0 > win - 2)
                       | (x0f - c0 < 0) | (x0f - c0 > win - 2))
        violated = violated | (alive & oow.flatten(1).any(dim=1))
        gx, gy = _window_gradient(img)
        a = fdiv(_warp_sum((gx * gx * mask).flatten(1)), npx)
        b = fdiv(_warp_sum((gx * gy * mask).flatten(1)), npx)
        c = fdiv(_warp_sum((gy * gy * mask).flatten(1)), npx)

        ia, ib, ic, il1, il2 = inv_sqrt_2x2(a, b, c)
        ratio_act = 1.0 - il2 / il1
        n11 = ia * u11 + ib * u21
        n12 = ia * u12 + ib * u22
        n21 = ib * u11 + ic * u21
        n22 = ib * u12 + ic * u22

        l1, l2, is_real = eigenvalues_2x2(n11, n12, n21, n22)
        aniso_bad = (~is_real) | (l1 / l2 > cfg.anisotropy_max) | (
            l2 / l1 > cfg.anisotropy_max)
        just_conv = ((ratio_act < cfg.convergence_threshold)
                     & (ratio_bef < cfg.convergence_threshold) & ~aniso_bad)

        u11 = torch.where(alive, n11, u11)
        u12 = torch.where(alive, n12, u12)
        u21 = torch.where(alive, n21, u21)
        u22 = torch.where(alive, n22, u22)
        ratio_bef = torch.where(alive, ratio_act, ratio_bef)
        conv_iter = torch.where(alive & just_conv, it, conv_iter)
        converged = converged | (alive & just_conv)
        alive = alive & ~aniso_bad & ~just_conv

    idle = ~active
    res = AffineResult(
        ok=converged & ~violated & active,
        u11=torch.where(idle, 1.0, u11), u12=torch.where(idle, 0.0, u12),
        u21=torch.where(idle, 0.0, u21), u22=torch.where(idle, 1.0, u22),
        iters=torch.where(idle, 0, conv_iter),
    )
    return (res, steps) if return_steps else res


def adapt_args(blur_stacks: torch.Tensor, img_idx, src_level, x, y, s,
               pixel_distance: float, cfg: HesaffConfig, active=None):
    """The arguments of ops.plain_affine.adapt for image-pixel keypoints:
    octave coordinates, scale ratio and the octave's window side."""
    H, W = blur_stacks.shape[-2], blur_stacks.shape[-1]
    pd = float(pixel_distance)
    if active is None:
        active = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    return (blur_stacks, img_idx, src_level, fdiv(x, pd), fdiv(y, pd),
            fdiv(s, cfg.initial_sigma * pd), active,
            sample_window_size(cfg, H, W), cfg)


def adapt_flat(blur_stacks: torch.Tensor, img_idx, src_level, x, y, s,
               pixel_distance: float, cfg: HesaffConfig,
               active=None) -> AffineResult:
    """Adaptation of cross-image flattened keypoints.

    blur_stacks: (B, L, H, W) blur levels of the image batch (rows
    contiguous; may be a view); img_idx / src_level: (K,) each
    keypoint's image and sampling level (detection level minus one);
    x, y, s: (K,) image-pixel coordinates and scale.
    """
    return plain_affine.adapt(*adapt_args(blur_stacks, img_idx, src_level,
                                         x, y, s, pixel_distance, cfg,
                                         active))


