"""Closed-loop retrieval queries against a full-size index on the card.

One client.  The index is a ``hesaff_tpu_torch.retrieval.
DescriptorIndex`` whose ``desc`` is a uint8 (M, 128) tensor on the
device and whose ``image_id`` is int32 on the host.  Its rows: the
program's own descriptors of ``sources`` seeded images, extracted at
set-up one image a call, then seeded SIFT-like filler rows
(imagery.filler_rows) for the other image ids, in equal blocks.

The queries: each source rotated by ``angles`` angles in [-max_angle,
max_angle] rad (imagery.warp_query), held on the host.  The sources and
angles are drawn from the traffic's fixed ``image_seed``, so that every
run seed gets the same queries, whose sizes (their rows) set a query's
2-NN work; the run's seed draws the filler and the order, in rounds
that each ask every source once, at one angle, in a seeded order.  A call extracts one query alone (a batch of
one through ``dist.extraction_step_grouped``) and answers it with
``retrieval.rank_images(index, query_desc, ratio, top_k)``; it ends
when the ranked list is on the host.  Each half runs in a span of the
benchmark's ("bench: extract", which ends in a synchronise, and
"bench: knn2").

Judgement: the reference extracts the sources and the sampled queries
again (reference/compare.py's numbers); its 2-NN, votes and ranking
(reference/knn2.py) run over the benchmark's own uint8 rows and image
ids, the ones it handed to the program's index (whose layout is the
program's to choose), and over each sampled query's rows as the program
extracted them, so they are held exactly: those rows were checked as the
extraction.  The timed ranked list is held to the reference's; after the
window the program's public ``retrieval.query_votes`` is asked for each
sampled query's votes and matches, which are held to the reference's.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import features, imagery
from benchmark.reference import compare, knn2
from benchmark.reference.precision import computing_in


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.W, self.H = config["image"]["width"], config["image"]["height"]
        ix = config["index"]
        self.n_src, self.n_images = ix["sources"], ix["images"]
        self.n_filler = ix["filler_rows"]
        self.ratio = config["retrieval"]["ratio"]
        self.top_k = config["retrieval"]["top_k"]

    # -- set-up ---------------------------------------------------------

    def setup(self) -> None:
        from hesaff_tpu_torch import dist, retrieval

        self.dist, self.retrieval = dist, retrieval
        self.cfg = features.program_config(self.config)
        self.groups = dist.default_group_spec(
            self.H, self.W, self.cfg, self.config["per_image_cap"], 1)
        seeds = imagery.image_seeds(self.traffic["image_seed"],
                                    self.n_src + 1)
        sources = imagery.pool(self.W, self.H, seeds[:self.n_src],
                               self.device)
        amax, na = self.traffic["max_angle"], self.traffic["angles"]
        angles = np.random.default_rng(seeds[-1]).uniform(
            -amax, amax, (na, self.n_src))
        self.plan = [(k, float(angles[r, k])) for r in range(na)
                     for k in range(self.n_src)]
        rng = np.random.default_rng(self.seed)
        self.order = np.concatenate([r * self.n_src
                                     + rng.permutation(self.n_src)
                                     for r in range(na)])
        self.queries = np.stack([
            imagery.warp_query(sources[k], a).cpu().numpy()
            for k, a in self.plan])
        self.sources = sources.cpu().numpy()
        del sources
        # the index: the program's rows of each source, then the filler
        self.src_feats = [self._extract(self.sources[k][None])[0]
                          for k in range(self.n_src)]
        self.desc, self.ids = self._index(
            [self._on_device(f["desc"]) for f in self.src_feats])
        self.index = retrieval.DescriptorIndex(self.desc, self.ids.copy(),
                                               n_images=self.n_images)
        self.hits = 0
        for i in range(self.traffic["warmup_calls"]):
            self.call(i)
        self.hits = 0

    def _on_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _index(self, src_rows: list) -> tuple:
        """(desc, image_id) of an index: the source rows on the device,
        then the seeded filler."""
        n_rows = [len(r) for r in src_rows]
        n_src_rows = sum(n_rows)
        desc = torch.empty((n_src_rows + self.n_filler, 128),
                           dtype=torch.uint8, device=self.device)
        if n_src_rows:
            torch.cat(src_rows, out=desc[:n_src_rows])
        desc[n_src_rows:] = imagery.filler_rows(self.n_filler, self.seed,
                                                self.device)
        n_fill_img = self.n_images - self.n_src
        ids = np.concatenate(
            [np.full(n, k, np.int32) for k, n in enumerate(n_rows)]
            + [(self.n_src + np.arange(self.n_filler, dtype=np.int64)
                * n_fill_img // self.n_filler).astype(np.int32)])
        return desc, ids

    def _extract(self, image: np.ndarray):
        """(host features, query rows on the device) of one image."""
        with record_function("bench: extract"):
            out = self.dist.extraction_step_grouped(
                image, self.cfg, self.groups, device=self.device)
            q = out.desc[out.valid]
            self.sync()
        return features.host_features(out), q

    # -- the window -------------------------------------------------------

    def call(self, i: int):
        k = int(self.order[i % len(self.order)])
        feats, q = self._extract(self.queries[k][None])
        with record_function("bench: knn2"):
            ranked = self.retrieval.rank_images(self.index, q,
                                                ratio=self.ratio,
                                                top_k=self.top_k)
        src = self.plan[k][0]
        self.hits += bool(ranked) and ranked[0][0] == src
        return 1, {"query": k, "feats": feats, "ranked": ranked}

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def work(self, i: int, answer: dict) -> dict:
        return {"query_rows": len(answer["feats"]["desc"]),
                "index_rows": int(self.desc.shape[0]),
                "dim": int(self.desc.shape[1])}

    def finding(self, calls: int) -> dict:
        """Queries of the window whose source ranked first (a finding,
        not a gate)."""
        return {"source_first": f"{self.hits}/{calls}"}

    # -- judgement ----------------------------------------------------------

    def _plain(self, images: np.ndarray, precision: str) -> list:
        """The reference's features of each image (one batch)."""
        from benchmark.reference.hesaff_plain import dist as plain

        cfg = features.reference_config(self.config)
        groups = plain.default_group_spec(self.H, self.W, cfg,
                                          self.config["per_image_cap"],
                                          len(images))
        with computing_in(precision):
            out = plain.extraction_step_grouped(
                torch.as_tensor(images, device=self.device), cfg, groups,
                device=self.device)
            f = features.host_features(out)
        return f

    def judge(self, sample: list, control: bool = False) -> dict:
        """The compared numbers: the extraction of the sources and of
        the sampled queries against the float32 reference; then each
        sampled query's ranked list, and the votes and matches that the
        program's query_votes gives for its rows, against the
        reference's 2-NN over the benchmark's own index rows (exact).
        With `control`, the reference in the precision below takes the
        extraction's place (precision cannot move the exact 2-NN of
        uint8 rows, so the control stops at the extraction)."""
        imgs = np.concatenate([self.sources,
                               self.queries[[a["query"] for _, a in sample]]])
        ref = self._plain(imgs, "float32")
        if control:
            cand = self._plain(imgs, "lower")
            return compare.features_gap([cand], [ref])
        cand = features.concat(
            [dict(f, img=np.full(len(f["x"]), j, np.int64))
             for j, f in enumerate(self.src_feats)]
            + [dict(a["feats"], img=np.full(len(a["feats"]["x"]),
                                            self.n_src + j, np.int64))
               for j, (_, a) in enumerate(sample)])
        out = compare.features_gap([cand], [ref])
        match_diff = votes_diff = rank_diff = 0
        for _, a in sample:
            q = self._on_device(a["feats"]["desc"])
            with computing_in("float32"):
                votes, matches = knn2.votes_and_matches(
                    q, self.desc, self.ids, self.n_images, self.ratio)
            pv, pm = self.retrieval.query_votes(self.index, q, self.ratio)
            match_diff += (int((np.asarray(pm) != matches).sum())
                           if len(pm) == len(matches) else len(matches))
            votes_diff += (int((np.asarray(pv) != votes).sum())
                           if len(pv) == len(votes) else self.n_images)
            rank_diff += a["ranked"] != knn2.ranked(votes, self.top_k)
        out.update(match_diff=float(match_diff), votes_diff=float(votes_diff),
                   rank_diff=float(rank_diff))
        return out
