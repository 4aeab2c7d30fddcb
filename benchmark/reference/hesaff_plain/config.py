"""Frozen configuration of the port.

The system has no learned weights: its whole state is this frozen
``HesaffConfig`` dataclass.  Its fields, defaults and derived values are
those of ``hesaff_tpu/config.py`` (the reference's PyramidParams,
AffineShapeParams and SIFTDescriptorParams, plus the fixed-capacity
knobs), so that ``dataclasses.asdict`` carries a setting from one
package to the other one to one.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class HesaffConfig:
    # --- detection ---
    threshold: float = 16.0 / 3.0          # DoH threshold (pre-square)
    edge_eigenvalue_ratio: float = 10.0    # edge rejection ratio
    border: int = 5                        # pixels ignored at image border
    num_scales: int = 3                    # scales per octave
    initial_sigma: float = 1.6             # blur of first level of each octave
    upscale_input: bool = False            # 2x upscale before pyramid

    # --- affine adaptation ---
    max_iterations: int = 16               # Baumberg iteration cap
    convergence_threshold: float = 0.05    # 1 - l2/l1 isotropy deviation
    smm_window_size: int = 19              # second-moment-matrix window
    anisotropy_max: float = 6.0            # abort when l1/l2 exceeds this

    # --- description ---
    patch_size: int = 41                   # normalized patch side
    mr_size: float = 3.0 * math.sqrt(3.0)  # measurement region scale multiple
    spatial_bins: int = 4
    orientation_bins: int = 8
    max_bin_value: float = 0.2             # SIFT clip value
    oversample_cutoff: float = 0.4         # imageToPatchScale branch point
    patch_smooth_factor: float = 1.5       # anti-alias blur sigma multiplier

    # --- localization constants ---
    max_subpixel_shift: float = 0.6
    point_safety_border: int = 3
    localize_iterations: int = 5
    final_shift_limit: float = 1.5         # reject if any |b| exceeds this

    # --- fixed capacities (no reference equivalent) ---
    # per-(octave, level) candidate capacity:
    # min(cap_max, max(cap_min, H*W // cap_div))
    candidate_cap_min: int = 64
    candidate_cap_max: int = 2048
    candidate_cap_div: int = 128
    # the JAX package's switch for its TPU kernels; the port ignores it
    # (a CUDA tensor always runs the port's kernels)
    use_pallas: bool = True
    # warp large patches (workspace above the grouped path's full-
    # resolution limit) from a downsampled sigma0-blurred pyramid level
    # with a blur-composition-corrected anti-alias sigma; off, they are
    # warped from the full-resolution image like the reference does
    tail_from_pyramid: bool = True
    # per-octave capacity of the compacted keypoint set that the affine
    # stage runs on; levels share this budget
    affine_cap_min: int = 128
    affine_cap_max: int = 4096
    affine_cap_div: int = 256
    # the JAX package's compute type; the port ignores it (float32)
    dtype: str = "float32"

    # --- derived ---
    @property
    def final_threshold(self) -> float:
        return self.threshold * self.threshold

    @property
    def positive_threshold(self) -> float:
        return 0.8 * self.final_threshold

    @property
    def negative_threshold(self) -> float:
        return -self.positive_threshold

    @property
    def edge_score_threshold(self) -> float:
        r = self.edge_eigenvalue_ratio
        return (r + 1.0) * (r + 1.0) / r

    @property
    def sigma_step(self) -> float:
        return 2.0 ** (1.0 / self.num_scales)

    @property
    def min_octave_size(self) -> int:
        return 2 * self.border + 2

    def num_octaves(self, height: int, width: int) -> int:
        """Number of octaves the pyramid builds for an input size."""
        if self.upscale_input:
            height, width = height * 2, width * 2
        n = 0
        while height > self.min_octave_size and width > self.min_octave_size:
            n += 1
            height //= 2
            width //= 2
        return n

    def level_capacity(self, height: int, width: int,
                       octave: int = 0) -> int:
        """Fixed candidate capacity for one detection level of an octave.

        The divisor halves per octave (floor 32): candidate density per
        pixel roughly quadruples per octave on textured imagery.
        """
        div = max(self.candidate_cap_div >> octave, 32)
        cap = max(self.candidate_cap_min, (height * width) // div)
        return min(self.candidate_cap_max, cap)

    def octave_candidate_capacity(self, height: int, width: int) -> int:
        """Pre-localization candidate capacity for a whole octave."""
        cap = max(256, (height * width) // 96)
        return min(2 * self.candidate_cap_max, cap)

    def affine_capacity(self, height: int, width: int,
                        octave: int = 0) -> int:
        """Compacted per-octave keypoint capacity for affine adaptation,
        octave-scaled like level_capacity."""
        div = max(self.affine_cap_div >> octave, 48)
        cap = max(self.affine_cap_min, (height * width) // div)
        return min(self.affine_cap_max, cap)


DEFAULT_CONFIG = HesaffConfig()

# Documented fast mode (not the default): a looser convergence
# threshold and a tighter iteration cap cut affine iterations.
FAST_CONFIG = HesaffConfig(max_iterations=10,
                           convergence_threshold=0.10)

__all__ = ["DEFAULT_CONFIG", "FAST_CONFIG", "HesaffConfig"]
