"""The reference's group tables for every image size.

hesaff_plain/dist.default_group_spec is the frozen table of the groups
up to 1,025 px.  Past it the grouped path's rule goes on
(default_group_spec here): the bounds double (2,049, 4,097, ...) until
one reaches the border limit min(H, W) + 2, so that every keypoint that
can pass the border check has a group.  Each new group's capacity is
FRACS_PAST_1025's fraction of the batch's per_image_cap * batch slots
(the last fraction for every later group), rounded as the frozen table
rounds: at least 32 slots, up to a multiple of 32.  Where the short side
is under 1,024 px the table is the frozen one.

A keypoint whose workspace lies above the border limit cannot pass the
border check: the reference binary rejects it there.  The frozen plain
path counts every keypoint above its table's last group as overflow, so
the table the judge hands it (judged_table) goes on doubling past the
limit up to the largest workspace the pyramid can give, and the plain
path checks those keypoints' borders and rejects them.
"""

from __future__ import annotations

import math

from benchmark.reference.hesaff_plain import dist as plain
from benchmark.reference.hesaff_plain import pyramid

# the 2,049 and 4,097 groups' fractions
FRACS_PAST_1025 = (0.00072, 0.000066)


def _capacity(total: int, frac: float) -> int:
    cap = max(32, int(total * frac))
    return ((cap + 31) // 32) * 32


def default_group_spec(height: int, width: int, cfg, per_image_cap: int,
                       batch: int) -> tuple:
    """The grouped path's table: the frozen one, then doubled bounds up
    to the first at or above the border limit."""
    spec = list(plain.default_group_spec(height, width, cfg, per_image_cap,
                                         batch))
    limit = min(height, width) + 2
    total = per_image_cap * batch
    k = 0
    while spec[-1][0] < limit:
        frac = FRACS_PAST_1025[min(k, len(FRACS_PAST_1025) - 1)]
        spec.append((2 * spec[-1][0] - 1, _capacity(total, frac)))
        k += 1
    return tuple(spec)


def largest_workspace(height: int, width: int, cfg) -> int:
    """A bound on any keypoint's workspace at this image size: the top
    detection level's sigma in the last octave, scaled by the largest
    scale shift the localisation accepts (2^(final_shift_limit /
    num_scales)), with 1% to spare for float32 rounding."""
    pd = pyramid.octave_shapes(height, width, cfg)[-1][2]
    s = (pd * cfg.initial_sigma * cfg.sigma_step ** cfg.num_scales
         * 2.0 ** (cfg.final_shift_limit / cfg.num_scales))
    return 2 * math.ceil(1.01 * s * cfg.mr_size) + 3


def judged_table(height: int, width: int, cfg, per_image_cap: int,
                 batch: int) -> tuple:
    """The table the judge hands the plain reference: default_group_spec's
    and, where it goes past 1,025, doubled bounds on to the largest
    workspace, each with the last group's capacity."""
    spec = list(default_group_spec(height, width, cfg, per_image_cap,
                                   batch))
    if spec[-1][0] > plain.default_group_spec(
            height, width, cfg, per_image_cap, batch)[-1][0]:
        top = largest_workspace(height, width, cfg)
        while spec[-1][0] < top:
            spec.append((2 * spec[-1][0] - 1, spec[-1][1]))
    return tuple(spec)
