"""sfm.SequentialMatcher on the card at the benchmark's ETH3D sequence
configuration, against the plain reference of sequential matching.

Marked `cuda`: skips where torch.cuda.is_available() is false.  It needs
neither JAX nor the golden fixtures, so on a GPU host it runs as

    python -m pytest tests/test_torch_seqmatch_cuda.py --noconftest -q

Two adjacent 6048x4032 stations of the benchmark's rendered orbit
(benchmark/scene.py) pushed through the matcher with the configuration
eth3d_seq_6048x4032's capacities, group table and matching parameters
(10,000 hypotheses, 4 px): no overflow; one K8 launch for the pair; the
pair's tentative matches (the K7 kernel both ways, the ratio and
cross-check on the card) equal benchmark/reference/pairs.py's float32
2-NN of the same rows; its
F-RANSAC replayed by the reference, with the pair's seed, within the
benchmark cell's limits of the program's (inlier flags that differ,
over the replay's inliers; the share of the replay's support that the
program's model loses).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda
ROOT = Path(__file__).resolve().parent.parent
CELL = "eth3d_seq_6048x4032.window10"
SEED = 2**31 + 23


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def test_pair_at_24mp_equals_plain_reference(dev):
    from benchmark import features, scene
    from benchmark.reference import pairs
    from hesaff_tpu_torch import dist, sfm
    from hesaff_tpu_torch.ops import cuda_ransac

    cell = json.loads((ROOT / "benchmark" / "workloads"
                       / f"{CELL}.json").read_text())
    config = json.loads((ROOT / "benchmark" / "configs"
                         / f"{cell['config']}.json").read_text())
    W, H = config["image"]["width"], config["image"]["height"]
    cam, r = config["camera"], config["ransac"]
    frames = scene.orbit_frames(
        W, H, config["tile"]["width"], config["tile"]["height"], 2,
        cell["traffic"]["tiles"], SEED, dev, cam["focal_px"],
        cam["step_deg"])
    cfg = features.program_config(config)
    groups = dist.default_group_spec(H, W, cfg, config["per_image_cap"], 1)
    m = sfm.SequentialMatcher(cfg, groups, window=10,
                              ratio=config["matching"]["ratio"],
                              hypotheses=r["hypotheses"],
                              sampson_px=r["sampson_px"], seed=SEED,
                              device=dev)
    before = cuda_ransac.LAUNCHES
    a, b = m.push(frames[0]), m.push(frames[1])
    assert a.overflow == 0 and b.overflow == 0
    assert cuda_ransac.LAUNCHES == before + len(b.pairs) == before + 1
    (p,) = b.pairs
    on = lambda x: torch.as_tensor(x, device=dev)
    r1, r2 = pairs.tentative(on(a.features.desc), on(b.features.desc),
                             config["matching"]["ratio"])
    np.testing.assert_array_equal(p.idx_older, r1)
    np.testing.assert_array_equal(p.idx_newer, r2)
    assert len(r1) > 10000

    xy = lambda f, rows: on(np.stack([f.x[rows], f.y[rows]], 1))
    p1, p2 = xy(a.features, p.idx_older), xy(b.features, p.idx_newer)
    F, inl = pairs.f_ransac(p1, p2, r["sampson_px"] ** 2, r["hypotheses"],
                            pairs.pair_seed(SEED, 0, 1))
    limits = cell["limits"]
    flips = int((on(p.inliers) != inl).sum())
    assert flips / max(1, int(inl.sum())) <= limits["ransac_inlier_diff"]
    support = int((pairs.sampson(on(p.model), p1, p2)
                   < r["sampson_px"] ** 2).sum())
    assert 1.0 - support / int(inl.sum()) <= limits["ransac_support_loss"]
    assert p.inliers.sum() > 0.5 * len(p.idx_older)
