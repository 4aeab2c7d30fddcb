"""Closed-loop sequential matching of 24 MP frames: COLMAP's sequential
matcher on a stream of DSLR frames.

One caller.  The frames are ``pool`` stations of a closed orbit around
a rendered building (benchmark/scene.py: a seeded piecewise-planar
scene, each pixel from the nearest plane its ray meets), ``step``
degrees apart, made at set-up on the device and held on the host as
float32; the calls cycle through them with no break (the orbit
closes).  Each call pushes the next frame into the program's
``hesaff_tpu_torch.sfm.SequentialMatcher`` (the entry point ``cli sfm``
uses): the frame is extracted through ``dist.extraction_step_grouped``
as a batch of one, with ``default_group_spec(H, W, cfg, per_image_cap,
1)``, its 2-NN taken both ways against each of the ``window`` frames
before it (the K7 kernel on the card), the ratio and cross-check kept,
and every pair verified by F-RANSAC; the call ends when the frame's
features and every pair's tentative matches, inlier flags and model are
on the host.  The warm-up fills the window and captures the batch-1
graphs.

Judgement of each sampled call:

- the frame's extraction against the plain reference, as the ETH3D
  extraction cell judges a frame (the frame extracted alone with the
  call's table; kp_unmatched, shape_p995, desc_l1, overflow_gap and the
  program's own overflow);
- ``pair_match_diff``: each pair's tentative matches recomputed by
  reference/pairs.py from the program's own features of both frames
  (exact: uint8 distances are integers), the matches either side has
  and the other lacks, summed; a pair of the window the program did not
  report counts the reference's matches of it, plus one;
- F-RANSAC replayed by reference/pairs.py on the program's tentative
  matches, with the pair's seed derived as the program documents it:
  the same draws, the 8-point solves and every hypothesis scored in
  float32.  Each pair is judged alone and the worst pair of the
  sampled calls counts (a pair 10 stations apart keeps a few dozen
  inliers of ~1,400 matches, an adjacent pair ~50,000: pooled, the
  adjacent pairs would hide a far pair's fault).
  ``ransac_support_loss``: one less the matches the program's model
  keeps (its Sampson distance under the threshold, counted by the
  reference) over the matches the best hypothesis of the replay keeps.
  Both sides pick that hypothesis and then refit only where a refit
  loses no inlier, so a sound model keeps at least as many; where the
  few inliers of a far pair leave the refit free to land on another
  model of as many or more inliers, the two sides' refits may part
  (with every refit kept, a replayed pair's flags differed from the
  program's by up to five times its inliers on an H100), so the
  refits' ends are not compared.
  ``ransac_inlier_diff``: a pair's flags that differ from the
  reference's verdict on the program's own model, over the matches it
  keeps.  The judgement also gives ``by_pair``, one [station gap,
  tentative, the best hypothesis' inliers, flags that differ, the
  model's inliers] a judged pair, for the readings.

With ``control`` the reference in the precision below float32 takes
the program's place: its extraction, its 2-NN (unmoved: the distances
are exact) and its F-RANSAC (scored in bfloat16, solved with TF32
products) on the program's tentative matches.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from benchmark import features, scene
from benchmark.reference import compare, group_table, pairs
from benchmark.reference.precision import computing_in


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.W, self.H = config["image"]["width"], config["image"]["height"]
        self.n_pool = traffic["pool"]
        m, r = config["matching"], config["ransac"]
        self.window, self.ratio = m["window"], m["ratio"]
        self.hypotheses = r["hypotheses"]
        self.threshold = r["sampson_px"] ** 2

    def setup(self) -> None:
        from hesaff_tpu_torch import dist
        from hesaff_tpu_torch.sfm import SequentialMatcher

        self.cfg = features.program_config(self.config)
        self.groups = dist.default_group_spec(
            self.H, self.W, self.cfg, self.config["per_image_cap"], 1)
        cam = self.config["camera"]
        self.pool = scene.orbit_frames(
            self.W, self.H, self.config["tile"]["width"],
            self.config["tile"]["height"], self.n_pool,
            self.traffic["tiles"], self.seed, self.device, cam["focal_px"],
            cam["step_deg"])
        r = self.config["ransac"]
        self.matcher = SequentialMatcher(
            self.cfg, self.groups, window=self.window, ratio=self.ratio,
            hypotheses=self.hypotheses, sampson_px=r["sampson_px"],
            seed=self.seed, device=self.device)
        # (frame id, host features) of the frames the window holds
        self.recent = deque(maxlen=self.window)
        self.most_tentative = 0
        for i in range(self.traffic["warmup_calls"]):
            self.call(i)

    def call(self, i: int):
        k = i % self.n_pool
        got = self.matcher.push(self.pool[k])
        f = got.features
        feats = {g: getattr(f, g) for g in features.GEOMETRY}
        feats.update(img=np.zeros(f.n, np.int64), desc=f.desc,
                     overflow=got.overflow)
        earlier = tuple(self.recent)
        self.recent.append((got.frame, feats))
        self.most_tentative = max([self.most_tentative]
                                  + [len(p.idx_older) for p in got.pairs])
        return 1, {"station": k, "frame": got.frame, "feats": feats,
                   "earlier": earlier, "pairs": got.pairs}

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def work(self, i: int, answer: dict) -> dict:
        """What a traced call did, for the roofline readers: each pair's
        rows (earlier frame, pushed frame) and tentative matches, and the
        extraction's shape (a batch of one frame)."""
        rows = {fid: len(f["x"]) for fid, f in answer["earlier"]}
        n = len(answer["feats"]["x"])
        return {"pairs": [(rows.get(p.older, 0), n, len(p.idx_older))
                          for p in answer["pairs"]],
                "hypotheses": self.hypotheses,
                "batch": 1, "height": self.H, "width": self.W}

    def finding(self, calls: int) -> dict:
        """The most tentative matches of a pair in the run (COLMAP caps
        a pair at 32,768; this deployment does not)."""
        return {"most_tentative": self.most_tentative}

    # -- judgement ----------------------------------------------------------

    def _reference(self, station: int, precision: str) -> dict:
        from benchmark.reference.hesaff_plain import dist as plain

        cfg = features.reference_config(self.config)
        groups = group_table.judged_table(
            self.H, self.W, cfg, self.config["per_image_cap"], 1)
        with computing_in(precision):
            out = plain.extraction_step_grouped(
                torch.as_tensor(self.pool[station][None],
                                device=self.device), cfg, groups,
                device=self.device)
            f = features.host_features(out)
        del out
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return f

    def _on_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _xy(self, f: dict, rows: np.ndarray) -> torch.Tensor:
        return self._on_device(np.stack([f["x"][rows], f["y"][rows]], 1))

    def _pair_readings(self, a: dict, control: bool) -> tuple[int, list]:
        """(pair_match_diff of the call, by_pair rows of its verified
        pairs)."""
        new = a["feats"]
        got = {p.older: p for p in a["pairs"]}
        match_diff, rows = 0, []
        for older, old in a["earlier"]:
            with computing_in("float32"):
                r1, r2 = pairs.tentative(self._on_device(old["desc"]),
                                         self._on_device(new["desc"]),
                                         self.ratio)
            p = got.get(older)
            if p is None:
                match_diff += len(r1) + 1
                continue
            ref_set = set(zip(r1.tolist(), r2.tolist()))
            prog_set = set(zip(p.idx_older.tolist(), p.idx_newer.tolist()))
            match_diff += len(ref_set ^ prog_set)
            if len(p.idx_older) < 8:
                continue
            p1, p2 = self._xy(old, p.idx_older), self._xy(new, p.idx_newer)
            seed = pairs.pair_seed(self.seed, older, a["frame"])
            with computing_in("float32"):
                best = int(pairs.hypotheses_scored(
                    p1, p2, self.threshold, self.hypotheses, seed)[1].max())
            if control:
                with computing_in("lower"):
                    F, inl = pairs.f_ransac(p1, p2, self.threshold,
                                            self.hypotheses, seed)
            else:
                F = self._on_device(p.model).to(torch.float32)
                inl = self._on_device(p.inliers)
            with computing_in("float32"):
                verdict = pairs.sampson(F, p1, p2) < self.threshold
            rows.append([a["frame"] - older, len(p.idx_older), best,
                         int((inl != verdict).sum()), int(verdict.sum())])
        return match_diff, rows

    def judge(self, sample: list, control: bool = False) -> dict:
        cand, ref, match_diff, by_pair = [], [], 0, []
        for i, a in sample:
            cand.append(self._reference(a["station"], "lower") if control
                        else a["feats"])
            ref.append(self._reference(a["station"], "float32"))
            diff, rows = self._pair_readings(a, control)
            match_diff += diff
            by_pair += rows
        gap = compare.features_gap(cand, ref)
        gap["overflow"] = float(sum(int(c["overflow"]) for c in cand))
        gap["pair_match_diff"] = float(match_diff)
        gap["ransac_inlier_diff"] = max(
            [diff / max(1, kept) for _, _, _, diff, kept in by_pair],
            default=0.0)
        gap["ransac_support_loss"] = max(
            [max(0.0, 1.0 - kept / best)
             for _, _, best, _, kept in by_pair if best],
            default=0.0)
        gap["by_pair"] = by_pair
        return gap
