"""Closed-loop extraction of large mosaic frames through the grouped
serving path.

batch_extract's loop at another image size: each call hands ``batch``
distinct H x W float32 gray frames, held on the host, to
``hesaff_tpu_torch.dist.extraction_step_grouped`` with the program's
``default_group_spec(H, W, cfg, per_image_cap, batch)``, and ends when
the batch's valid descriptors, geometry and image indices are on the
host.  The frames are a pool of ``pool`` seeded mosaics of the
configuration's tiles (benchmark/mosaic.py), made at set-up and cycled
batch by batch.

Judgement: as batch_extract's, but the reference extracts each frame
of a sampled call alone, with the call's group table from
reference/group_table.py (judged_table: every group to the border
limit, and on to the largest workspace, so that the plain path rejects
what lies above the limit at the border check); and one more number,
``overflow``: the program's own capacity overflow summed over the
sampled calls, so that a program that drops keypoints fails whatever
the reference drops.
"""

from __future__ import annotations

import torch

from benchmark import features, mosaic
from benchmark.drivers import batch_extract
from benchmark.reference import compare, group_table
from benchmark.reference.precision import computing_in


class Driver(batch_extract.Driver):
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        super().__init__(config, traffic, seed, device)
        self.tile_w = config["tile"]["width"]
        self.tile_h = config["tile"]["height"]
        self.n_tiles = traffic["tiles"]

    def setup(self) -> None:
        from hesaff_tpu_torch import dist

        self.dist = dist
        self.cfg = features.program_config(self.config)
        self.groups = dist.default_group_spec(
            self.H, self.W, self.cfg, self.config["per_image_cap"], self.B)
        self.pool = mosaic.frames(self.W, self.H, self.tile_w, self.tile_h,
                                  self.n_pool, self.n_tiles, self.seed,
                                  self.device)
        for i in range(self.traffic["warmup_calls"]):
            self.call(i)

    def _reference(self, i: int, precision: str) -> dict:
        """The plain reference's features of call i, each frame extracted
        alone with the call's table: the plain SIFT holds several
        (K, P, P, ob) float32 planes of its K valid keypoints at once,
        ~9 GB each for the ~170 k of two frames, which outgrow the card."""
        from benchmark.reference.hesaff_plain import dist as plain

        cfg = features.reference_config(self.config)
        groups = group_table.judged_table(
            self.H, self.W, cfg, self.config["per_image_cap"], self.B)
        parts = []
        with computing_in(precision):
            for b, frame in enumerate(self.batch(i)):
                out = plain.extraction_step_grouped(
                    torch.as_tensor(frame[None], device=self.device), cfg,
                    groups, device=self.device)
                parts.append(features.host_features(out, img_offset=b))
                del out
                if self.device.type == "cuda":
                    torch.cuda.empty_cache()
        return features.concat(parts)

    def judge(self, sample: list, control: bool = False) -> dict:
        cand, ref = [], []
        for i, answer in sample:
            cand.append(self._reference(i, "lower") if control else answer)
            ref.append(self._reference(i, "float32"))
        gap = compare.features_gap(cand, ref)
        gap["overflow"] = float(sum(int(c["overflow"]) for c in cand))
        return gap
