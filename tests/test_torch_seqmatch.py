"""sfm.SequentialMatcher on the CPU, against the benchmark's plain
reference of sequential matching (benchmark/reference/pairs.py).

Five 320x240 frames of the benchmark's rendered orbit
(benchmark/scene.py, tiles of 64x48, stations 7.5 degrees apart) are
pushed through a matcher with a window of 3 and 256 hypotheses a pair.
Each pair's tentative matches equal the reference's 2-NN with the ratio
and cross-check (and match.match_descriptors'); the reference's
F-RANSAC, replayed on the program's tentative matches with the pair's
seed, gives the same inliers and a model whose Sampson distance at
each of them is within 0.01 px of the program's model's (the refits'
float32 rounding moves it up to ~2e-3 px here); the inliers lie on
the scene's true epipolar geometry.  The ring holds the last `window`
frames in push order.  Under torch.profiler a push opens the pair
stage's spans and the counters pair_queries, pair_tentative and
ransac_residuals grow by the work done; untraced they do not move.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import _torch_parity  # noqa: F401  (two torch threads a worker)
from benchmark import scene
from benchmark.reference import pairs
from hesaff_tpu_torch import match, sfm
from hesaff_tpu_torch.config import HesaffConfig
from hesaff_tpu_torch.utils import profiling

W, H, TW, TH = 320, 240, 64, 48
FOCAL = 3400.0 * W / 6048
STEP, N_FRAMES, WINDOW, HYP = 7.5, 5, 3, 256
SEED = 2**31 + 7
THRESHOLD = 16.0
CFG = HesaffConfig(candidate_cap_div=16, affine_cap_div=32)


def _matcher():
    return sfm.SequentialMatcher(CFG, window=WINDOW, ratio=0.8,
                                 hypotheses=HYP, sampson_px=4.0, seed=SEED,
                                 device="cpu")


@pytest.fixture(scope="module")
def run():
    frames = scene.orbit_frames(W, H, TW, TH, N_FRAMES, 32, SEED, "cpu",
                                FOCAL, STEP)
    m = _matcher()
    return frames, m, [m.push(f) for f in frames]


def _xy(f, rows):
    return torch.as_tensor(np.stack([f.x[rows], f.y[rows]], 1))


def test_frames_extract_without_overflow(run):
    _, _, out = run
    assert [o.frame for o in out] == list(range(N_FRAMES))
    assert all(o.overflow == 0 and o.features.n > 200 for o in out)


def test_ring_evicts_in_order(run):
    _, m, out = run
    assert [e.frame for e in m.ring] == list(range(N_FRAMES - WINDOW,
                                                   N_FRAMES))
    for o in out:
        assert [p.older for p in o.pairs] == list(
            range(max(0, o.frame - WINDOW), o.frame))
        assert all(p.newer == o.frame for p in o.pairs)


def test_tentative_equal_reference_and_match_descriptors(run):
    _, _, out = run
    for o in out:
        for p in o.pairs:
            old = out[p.older].features
            r1, r2 = pairs.tentative(torch.as_tensor(old.desc),
                                     torch.as_tensor(o.features.desc), 0.8)
            np.testing.assert_array_equal(p.idx_older, r1)
            np.testing.assert_array_equal(p.idx_newer, r2)
            i1, i2 = match.match_descriptors(old.desc, o.features.desc,
                                             ratio=0.8, device="cpu")
            np.testing.assert_array_equal(p.idx_older, i1)
            np.testing.assert_array_equal(p.idx_newer, i2)


def test_ransac_equal_reference(run):
    _, _, out = run
    n_pairs = 0
    for o in out:
        for p in o.pairs:
            assert p.seed == pairs.pair_seed(SEED, p.older, p.newer)
            if len(p.idx_older) < 8:
                continue
            n_pairs += 1
            old = out[p.older].features
            F, inl = pairs.f_ransac(_xy(old, p.idx_older),
                                    _xy(o.features, p.idx_newer),
                                    THRESHOLD, HYP, p.seed)
            np.testing.assert_array_equal(p.inliers, inl.numpy())
            p1 = _xy(old, p.idx_older[p.inliers])
            p2 = _xy(o.features, p.idx_newer[p.inliers])
            gap = (pairs.sampson(torch.as_tensor(p.model), p1, p2).sqrt()
                   - pairs.sampson(F, p1, p2).sqrt()).abs()
            assert float(gap.max()) < 0.01
    assert n_pairs == sum(len(o.pairs) for o in out)


def test_inliers_on_the_true_geometry(run):
    """Adjacent stations share many inliers, all on the scene's own F:
    the imagery is a real two-view problem."""
    _, _, out = run
    cams = [scene.camera(k, N_FRAMES, STEP, FOCAL, W, H)
            for k in range(N_FRAMES)]
    for o in out[1:]:
        p = o.pairs[-1]
        K, R1, C1 = cams[p.older]
        _, R2, C2 = cams[p.newer]
        F = torch.as_tensor(scene.fundamental(K, R1, C1, R2, C2),
                            dtype=torch.float32)
        keep = p.inliers
        assert keep.sum() >= 100
        d = pairs.sampson(F, _xy(out[p.older].features,
                                 p.idx_older[keep]),
                          _xy(o.features, p.idx_newer[keep]))
        assert float(d.median()) < 1.0


@pytest.mark.parametrize("seed,ratio", [(0, 0.8), (1, 0.6), (2, 0.95)])
def test_pair_tests_equal_reference_on_ties(seed, ratio):
    """Rows of few distinct values and repeated rows (equal distances
    everywhere): the pair's ratio and cross-check (match.ratio_mutual)
    keep what the plain reference keeps, ties to the first row."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 3, (300, 128)).astype(np.uint8)
    b = rng.integers(0, 3, (250, 128)).astype(np.uint8)
    b[::7] = a[:36]
    a[50:60] = a[40:50]
    m = sfm.SequentialMatcher(CFG, window=2, ratio=ratio, device="cpu")
    xy = lambda n: torch.zeros((n, 2))
    m.ring.append(sfm._Entry(0, torch.as_tensor(a), xy(len(a))))
    (p,) = m._pairs(sfm._Entry(1, torch.as_tensor(b), xy(len(b))))
    r1, r2 = pairs.tentative(torch.as_tensor(a), torch.as_tensor(b), ratio)
    assert len(r1) > 0
    np.testing.assert_array_equal(p.idx_older, r1)
    np.testing.assert_array_equal(p.idx_newer, r2)


def _entry(frame, f):
    """A ring entry of a frame's host features."""
    return sfm._Entry(frame, torch.as_tensor(f.desc),
                      torch.as_tensor(np.stack([f.x, f.y], 1)))


def test_spans_and_counters_only_while_tracing(run):
    frames, _, out = run
    m = _matcher()
    m.ring.append(_entry(0, out[0].features))
    m.pushed = 1
    rows = {e.frame: len(e.desc) for e in m.ring}
    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = m.push(frames[1])
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"frame: features", "pair: knn2", "pair: ratio", "pair: results",
            "ransac: draw", "ransac: solve", "ransac: score",
            "ransac: refit"} <= names
    after = profiling.counters()
    grew = {k: after[k] - before.get(k, 0) for k in after}
    n = got.features.n
    assert grew["pair_queries"] == sum(2 * rows[p.older] * n
                                       for p in got.pairs)
    assert grew["pair_tentative"] == sum(len(p.idx_older)
                                         for p in got.pairs)
    assert grew["ransac_residuals"] == sum(HYP * len(p.idx_older)
                                           for p in got.pairs
                                           if len(p.idx_older) >= 8)
    m._pairs(_entry(2, out[2].features))
    assert profiling.counters() == after
