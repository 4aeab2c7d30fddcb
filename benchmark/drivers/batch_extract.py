"""Closed-loop batch extraction through the grouped serving path.

One caller.  Each call hands ``batch`` distinct H x W float32 grayscale
images, held on the host, to ``hesaff_tpu_torch.dist.
extraction_step_grouped`` with ``default_group_spec(H, W, cfg,
per_image_cap, batch)``, and ends when the batch's valid descriptors,
geometry and image indices are on the host.  The images are a pool of
``pool`` seeded images made at set-up on the device and cycled batch by
batch.

Judgement: the plain reference (reference/hesaff_plain, its own copy of
the grouped path, with its own group table made from the configuration)
extracts the sampled calls' images again, on the device, and
reference/compare.py's numbers hold the program's features to its.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import features, imagery
from benchmark.reference import compare
from benchmark.reference.precision import computing_in


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.W, self.H = config["image"]["width"], config["image"]["height"]
        self.B = traffic["batch"]
        self.n_pool = traffic["pool"]
        if self.n_pool % self.B:
            raise ValueError("pool is not a multiple of the batch")

    def setup(self) -> None:
        from hesaff_tpu_torch import dist

        self.dist = dist
        self.cfg = features.program_config(self.config)
        self.groups = dist.default_group_spec(
            self.H, self.W, self.cfg, self.config["per_image_cap"], self.B)
        seeds = imagery.image_seeds(self.seed, self.n_pool)
        self.pool = imagery.pool(self.W, self.H, seeds,
                                 self.device).cpu().numpy()
        for i in range(self.traffic["warmup_calls"]):
            self.call(i)

    def batch(self, i: int) -> np.ndarray:
        b = i % (self.n_pool // self.B)
        return self.pool[b * self.B:(b + 1) * self.B]

    def call(self, i: int):
        out = self.dist.extraction_step_grouped(self.batch(i), self.cfg,
                                                self.groups,
                                                device=self.device)
        return self.B, features.host_features(out)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def work(self, i: int, answer: dict) -> dict:
        """What a traced call did, for the roofline readers."""
        return {"batch": self.B, "height": self.H, "width": self.W,
                "s": answer["s"], "described": len(answer["s"])}

    def finding(self, calls: int) -> dict:
        return {}

    def _reference(self, i: int, precision: str) -> dict:
        from benchmark.reference.hesaff_plain import dist as plain

        cfg = features.reference_config(self.config)
        groups = plain.default_group_spec(self.H, self.W, cfg,
                                          self.config["per_image_cap"],
                                          self.B)
        with computing_in(precision):
            out = plain.extraction_step_grouped(
                torch.as_tensor(self.batch(i), device=self.device), cfg,
                groups, device=self.device)
            return features.host_features(out)

    def judge(self, sample: list, control: bool = False) -> dict:
        """The compared numbers of the sampled calls ((index, answer)
        pairs): the program's answers against the float32 reference,
        or with `control` the reference in the precision below put in their place."""
        cand, ref = [], []
        for i, answer in sample:
            cand.append(self._reference(i, "lower") if control else answer)
            ref.append(self._reference(i, "float32"))
        return compare.features_gap(cand, ref)
