"""Gaussian scale-space ladder and DoH response stacks.

Port of ``hesaff_tpu/pyramid.py``: each octave gives a
(num_scales+2, H, W) blur stack and the matching DoH stack; the next
octave seeds from the level at sigma = 2 * initial_sigma by unfiltered
2x subsampling.  Every level, and the initial blur, comes from the fused
blur + DoH kernel (ops/plain_blur), which writes each level straight
into its slot of the two stacks: level 0 by the identity tap [1.0]
(a copy of the first level and its DoH), the initial blur and the
pyramid-tail seeds by its blur-only mode.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from benchmark.reference.hesaff_plain.config import HesaffConfig
from benchmark.reference.hesaff_plain.ops import plain_blur
from benchmark.reference.hesaff_plain.ops.blur import gaussian_taps
from benchmark.reference.hesaff_plain.ops.hessian import norm2_of
from benchmark.reference.hesaff_plain.ops.resample import double_image, half_image


class Octave(NamedTuple):
    blurs: torch.Tensor       # (..., num_scales+2, H, W) blur ladder
    resps: torch.Tensor       # (..., num_scales+2, H, W) DoH responses
    sigmas: tuple             # per-level sigma
    pixel_distance: float     # image pixels per octave pixel
    next_first: torch.Tensor  # seed of the next octave (..., H//2, W//2)


def level_sigmas(cfg: HesaffConfig) -> list[float]:
    step = cfg.sigma_step
    return [cfg.initial_sigma * step**k for k in range(cfg.num_scales + 2)]


def first_level_taps(cfg: HesaffConfig):
    """Taps of the initial blur (None when none is needed): from the
    assumed input sigma 0.5 (1.0 after 2x upscaling) to initial_sigma."""
    cur_sigma = 1.0 if cfg.upscale_input else 0.5
    if cfg.initial_sigma > cur_sigma:
        return gaussian_taps(math.sqrt(cfg.initial_sigma**2 - cur_sigma**2))
    return None


def ladder_taps(cfg: HesaffConfig) -> list:
    """Increment taps from level i to level i+1, i = 0..num_scales."""
    sig = level_sigmas(cfg)
    step = cfg.sigma_step
    return [gaussian_taps(sig[i] * math.sqrt(step * step - 1.0))
            for i in range(cfg.num_scales + 1)]


def prepare_first_level(image: torch.Tensor, cfg: HesaffConfig):
    """Initial blur to initial_sigma from an assumed input sigma of 0.5.

    Returns (first_level, pixel_distance).
    """
    pd = 1.0
    first = image
    if cfg.upscale_input:
        first = double_image(first)
        pd *= 0.5
    taps = first_level_taps(cfg)
    if taps is not None:
        first = plain_blur.blur(first.contiguous(), taps)
    return first, pd


def scaled_first_level(images: torch.Tensor, cfg: HesaffConfig,
                       octave: int) -> torch.Tensor:
    """First level of pyramid octave `octave` for a batch (..., H, W).

    Rebuilds the seed chain of the ladder without DoH responses (the
    grouped path's pyramid-tail source for octaves deeper than phase A
    reached).  The result carries blur sigma0 in its own pixels.
    """
    cur, _ = prepare_first_level(images, cfg)
    for _ in range(octave):
        for taps in ladder_taps(cfg)[:cfg.num_scales]:
            cur = plain_blur.blur(cur, taps)
        cur = half_image(cur)
    return cur


def build_octave(first_level: torch.Tensor, pixel_distance: float,
                 cfg: HesaffConfig) -> Octave:
    """One octave's blur and DoH stacks for (..., H, W) first levels.

    The stacks are allocated once; each level is one blur + DoH launch
    into its slot (level 0 with the identity tap), so no level is
    copied again.
    """
    sigmas = level_sigmas(cfg)
    first_level = first_level.contiguous()
    L = cfg.num_scales + 2
    shape = first_level.shape[:-2] + (L,) + first_level.shape[-2:]
    blurs = first_level.new_empty(shape)
    resps = first_level.new_empty(shape)
    plain_blur.blur_doh(first_level, [1.0], norm2_of(sigmas[0] ** 2),
                       out=blurs[..., 0, :, :], resp_out=resps[..., 0, :, :])
    for i, taps in enumerate(ladder_taps(cfg)):
        plain_blur.blur_doh(blurs[..., i, :, :], taps,
                           norm2_of(sigmas[i + 1] ** 2),
                           out=blurs[..., i + 1, :, :],
                           resp_out=resps[..., i + 1, :, :])
    return Octave(
        blurs=blurs,
        resps=resps,
        sigmas=tuple(sigmas),
        pixel_distance=pixel_distance,
        next_first=half_image(blurs[..., cfg.num_scales, :, :]),
    )


def octave_shapes(height: int, width: int, cfg: HesaffConfig):
    """Static (H, W, pixel_distance) schedule for an input image size:
    the octaves the ladder builds, down to min_octave_size."""
    if cfg.upscale_input:
        height, width = height * 2, width * 2
        pd = 0.5
    else:
        pd = 1.0
    out = []
    while height > cfg.min_octave_size and width > cfg.min_octave_size:
        out.append((height, width, pd))
        height //= 2
        width //= 2
        pd *= 2.0
    return out
