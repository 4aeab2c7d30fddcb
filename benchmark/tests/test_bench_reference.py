"""The frozen reference against the port's plain path, which it copies.

The port is imported here only to hold the copy equal to it; the
reference itself imports nothing of the port (test_bench_imports.py).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import features
from benchmark.reference import knn2
from benchmark.reference.hesaff_plain import dist as plain_dist
from benchmark.reference.hesaff_plain.config import HesaffConfig as PlainCfg
from benchmark.reference.precision import computing_in

GOLDEN = Path(__file__).resolve().parents[2] / "tests" / "golden" / "data"


def test_grouped_path_equals_the_ports_plain_path_on_the_golden():
    from hesaff_tpu_torch import HesaffConfig, dist

    gray = np.load(GOLDEN / "synth_200x160.npz")["gray"].astype(np.float32)
    imgs = np.stack([gray, gray[::-1].copy()])
    groups = dist.default_group_spec(160, 200, HesaffConfig(), 1024, 2)
    assert groups == plain_dist.default_group_spec(160, 200, PlainCfg(),
                                                   1024, 2)
    want = dist.extraction_step_grouped(imgs, HesaffConfig(), groups,
                                        device="cpu")
    with computing_in("float32"):
        got = plain_dist.extraction_step_grouped(imgs, PlainCfg(), groups,
                                                 device="cpu")
    assert int(want.valid.sum()) > 100
    for k in want._fields:
        assert torch.equal(getattr(want, k), getattr(got, k)), k


def test_lower_precision_changes_the_reference():
    gray = np.load(GOLDEN / "synth_200x160.npz")["gray"].astype(np.float32)
    groups = plain_dist.default_group_spec(160, 200, PlainCfg(), 1024, 1)
    outs = []
    for p in ("float32", "lower"):
        with computing_in(p):
            outs.append(features.host_features(
                plain_dist.extraction_step_grouped(gray[None], PlainCfg(),
                                                   groups, device="cpu")))
    assert not np.array_equal(outs[0]["x"], outs[1]["x"])
    assert not torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("block", [7, 1 << 18])
def test_two_nn_votes_and_ranking_equal_the_ports(block):
    from hesaff_tpu_torch.match import knn2 as port_knn2
    from hesaff_tpu_torch.retrieval import (DescriptorIndex, query_votes,
                                            rank_images)

    g = torch.Generator().manual_seed(3)
    db = torch.randint(0, 6, (300, 128), generator=g, dtype=torch.uint8)
    q = torch.cat([db[:40], torch.randint(0, 6, (20, 128), generator=g,
                                          dtype=torch.uint8)])
    db = torch.cat([db, db[:10]])          # exact ties: the lower row wins
    idx, d1, d2 = knn2.two_nn(q, db, block=block)
    m = port_knn2(q, db, device="cpu")
    assert torch.equal(idx.to(torch.int32), m.idx)
    assert torch.equal(d1, m.dist) and torch.equal(d2, m.dist2)
    ids = np.repeat(np.arange(31, dtype=np.int32), 10)
    votes, matches = knn2.votes_and_matches(q, db, ids, 31, 0.9)
    pv, pm = query_votes(DescriptorIndex(db, ids, 31), q, 0.9, device="cpu")
    np.testing.assert_array_equal(votes, pv)
    np.testing.assert_array_equal(matches, pm)
    assert knn2.ranked(votes, 10) == rank_images(
        DescriptorIndex(db, ids, 31), q, 0.9, 10, device="cpu")
