"""The port's Oxford repeatability (hesaff_tpu_torch.evaluate) and
retrieval (hesaff_tpu_torch.retrieval) against the JAX package's, on
the CPU: every field of the result equal.

The geometry is numpy in both packages; the descriptor matching and the
retrieval votes go through each package's exact 2-NN, equal bit for bit
on uint8 descriptors (tests/test_torch_match.py).
"""

import numpy as np
import pytest

import _torch_parity  # noqa: F401  (two torch threads a worker)
from hesaff_tpu import evaluate as jevaluate
from hesaff_tpu import retrieval as jretrieval
from hesaff_tpu_torch import evaluate, retrieval
from hesaff_tpu_torch.pipeline import Features

MR = 3.0 * 3.0 ** 0.5


def golden_feats(golden):
    a = golden["affine_shapes"]
    desc = golden["descriptors"].astype(np.uint8)
    k = len(desc)
    col = lambda i: a[:k, i].astype(np.float32)
    return Features(x=col(0), y=col(1), s=col(2), a11=col(4), a12=col(5),
                    a21=col(6), a22=col(7), response=col(9), type=col(8),
                    desc=desc)


def rotation_about_center(h, w, deg):
    c, s = np.cos(np.radians(deg)), np.sin(np.radians(deg))
    return (np.array([[1, 0, w / 2], [0, 1, h / 2], [0, 0, 1]])
            @ np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
            @ np.array([[1, 0, -w / 2], [0, 1, -h / 2], [0, 0, 1]]))


def test_features_to_ellipses_equal(golden_small):
    f = golden_feats(golden_small)
    np.testing.assert_array_equal(evaluate.features_to_ellipses(f, MR),
                                  jevaluate.features_to_ellipses(f, MR))


@pytest.mark.parametrize("warp", ["identity", "rotation"])
@pytest.mark.parametrize("golden", ["golden_small", "golden_mid"])
def test_repeatability_equal(request, golden, warp):
    """Image 2's ellipses are image 1's mapped through H, with seeded
    noise on centres and shapes, shuffled, with noisy descriptors."""
    g = request.getfixturevalue(golden)
    f = golden_feats(g)
    h, w = g["gray"].shape
    H = np.eye(3) if warp == "identity" else rotation_about_center(h, w, 10)
    ell1 = jevaluate.features_to_ellipses(f, MR)
    rng = np.random.default_rng(len(ell1))
    ell2 = jevaluate._project_ellipses(ell1, H)
    desc2 = f.desc.copy()
    if warp == "rotation":
        ell2[:, :2] += rng.normal(0, 0.3, (len(ell2), 2))
        ell2[:, 2:] *= 1 + rng.normal(0, 0.02, (len(ell2), 1))
        perm = rng.permutation(len(ell2))
        ell2 = ell2[perm]
        desc2 = np.clip(desc2[perm].astype(np.int32)
                        + rng.integers(-2, 3, desc2.shape), 0, 255
                        ).astype(np.uint8)
    ref = jevaluate.repeatability(ell1, ell2, H, (h, w), f.desc, desc2,
                                  shape1=(h, w))
    out = evaluate.repeatability(ell1, ell2, H, (h, w), f.desc, desc2,
                                 shape1=(h, w), device="cpu")
    assert type(out).__name__ == "RepeatabilityResult"
    assert out._fields == ref._fields
    assert tuple(out) == tuple(ref)
    assert out.num_correspondences > 0.5 * len(ell1)
    assert out.num_matches > 0
    # without descriptors no matching runs
    bare = evaluate.repeatability(ell1, ell2, H, (h, w))
    assert tuple(bare) == tuple(jevaluate.repeatability(ell1, ell2, H,
                                                        (h, w)))


def make_corpus(n_images=12, per_image=60, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 255, (per_image, 128)).astype(np.uint8)
            for _ in range(n_images)]


@pytest.mark.parametrize("which,ratio", [(7, 0.9), (3, 0.8), (0, 1.0)])
def test_retrieval_equal(which, ratio):
    corpus = make_corpus()
    corpus[5] = corpus[5][:0]            # an image with no descriptors
    corpus[9][:10] = corpus[which][:10]  # shared rows: ties across images
    index, ref_index = retrieval.build_index(corpus), \
        jretrieval.build_index(corpus)
    for a, b in zip(index, ref_index):
        np.testing.assert_array_equal(a, b)
    rng = np.random.RandomState(which)
    q = np.clip(corpus[which][:40].astype(np.int32)
                + rng.randint(-3, 4, (40, 128)), 0, 255).astype(np.uint8)
    votes, matches = retrieval.query_votes(index, q, ratio, device="cpu")
    rvotes, rmatches = jretrieval.query_votes(ref_index, q, ratio)
    assert votes.dtype == np.int32 and matches.dtype == np.int32
    np.testing.assert_array_equal(votes, rvotes)
    np.testing.assert_array_equal(matches, rmatches)
    ranked = retrieval.rank_images(index, q, ratio, top_k=5, device="cpu")
    assert ranked == jretrieval.rank_images(ref_index, q, ratio, top_k=5)
    assert ranked[0][0] == which


def test_retrieval_empty():
    index = retrieval.build_index(make_corpus())
    ref = jretrieval.build_index(make_corpus())
    empty = np.zeros((0, 128), np.uint8)
    for mine, theirs in zip(retrieval.query_votes(index, empty,
                                                  device="cpu"),
                            jretrieval.query_votes(ref, empty)):
        np.testing.assert_array_equal(mine, theirs)
        assert mine.dtype == theirs.dtype
    assert retrieval.rank_images(index, empty, device="cpu") == []
    none = retrieval.build_index([empty, empty])
    rnone = jretrieval.build_index([empty, empty])
    assert none.n_images == rnone.n_images == 2
    assert none.desc.shape == rnone.desc.shape == (0, 128)
    q = make_corpus(1)[0]
    np.testing.assert_array_equal(
        retrieval.query_votes(none, q, device="cpu")[0],
        jretrieval.query_votes(rnone, q)[0])
