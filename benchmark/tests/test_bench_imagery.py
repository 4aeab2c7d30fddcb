"""The imagery copy, the query warp and the filler rows."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import imagery

GOLDEN = Path(__file__).resolve().parents[2] / "tests" / "golden"


@pytest.mark.parametrize("w,h,seed", [(64, 48, 0), (64, 48, 9),
                                      (96, 64, 2**31 + 11)])
def test_synth_gray_equals_gen_images(w, h, seed):
    sys.path.insert(0, str(GOLDEN))
    import gen_images

    want = gen_images.synth_image(w, h, seed=seed % 2**32).astype(
        np.float32).mean(axis=-1)
    got = imagery.synth_gray(w, h, seed % 2**32).numpy()
    assert got.dtype == np.float32 and got.shape == (h, w)
    np.testing.assert_array_equal(got, want)


def test_pool_is_seeded():
    seeds = imagery.image_seeds(2**31 + 3, 3)
    a = imagery.pool(64, 48, seeds, "cpu")
    b = imagery.pool(64, 48, seeds, "cpu")
    c = imagery.pool(64, 48, imagery.image_seeds(4, 3), "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (3, 48, 64) and float(a.min()) >= 0 and float(
        a.max()) <= 255


def test_warp_query_zero_angle_is_identity():
    img = imagery.synth_gray(64, 48, 1)
    out = imagery.warp_query(img, 0.0)
    # the last row and column interpolate against a clamped neighbour
    assert torch.equal(out[:-1, :-1], img[:-1, :-1])


def test_filler_rows_are_sift_like_and_seeded():
    a = imagery.filler_rows(5000, 7, "cpu", chunk=1024)
    b = imagery.filler_rows(5000, 7, "cpu", chunk=1024)
    assert torch.equal(a, b) and a.dtype == torch.uint8
    v = a.double() / 512.0
    norm = v.norm(dim=1)
    # renormalised after the clip, then floored: the norm is under 1, and
    # the floor takes most from rows of many small bins
    assert float(norm.max()) <= 1.0 and float(norm.min()) > 0.7
    zero = float((a == 0).double().mean())
    assert 0.35 < zero < 0.7
