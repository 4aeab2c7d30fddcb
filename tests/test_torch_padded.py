"""Padded (valid_hw) mode of the PyTorch port, on the CPU.

A batch edge-padded to a shape bucket carries each image's true size.
Held: the port's padded run against its unpadded run with
tests/test_dist.py's padded-mode tolerances (extract_batch: count
within max(2, 3%), >= 97% of keypoints within 0.25 px with s within
5%; the grouped path: equal keypoint sets, equal counts, no overflow,
descriptors within 2 steps on >= 95% of keypoints and mean max step
<= 0.3); the port's padded extract_batch against the JAX package's on
the same padded image with test_torch_pipeline.py's tolerances (equal
funnel counts, >= 99% of keypoints within 0.01 px, descriptors within 2
steps on >= 98.8%); and the plain start-pixel window of K2 and K3
against JAX's candidate mask and walk with valid_hw, bit for bit, for
several sizes and under upscale_input.
"""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hesaff_tpu import batch as jbatch
from hesaff_tpu import detect as jdetect
from hesaff_tpu.config import HesaffConfig
from hesaff_tpu.utils.fleet import pad_to_bucket as jpad_to_bucket
from hesaff_tpu_torch import batch, dist
from hesaff_tpu_torch.ops import cuda_detect
from hesaff_tpu_torch.utils.fleet import pad_to_bucket
from _torch_parity import n, port_cfg

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "golden"))
import gen_images  # noqa: E402

CFG = HesaffConfig()
PCFG = port_cfg(CFG)


@pytest.fixture(scope="module")
def golden_padded(golden_small):
    img = np.asarray(golden_small["gray"], np.float32)
    padded, hw = pad_to_bucket(img, 64)
    assert padded.shape != img.shape
    return img, padded, np.asarray([hw], np.int32)


@pytest.fixture(scope="module")
def port_padded(golden_padded):
    _, padded, hw = golden_padded
    return batch.extract_batch(padded[None], PCFG, return_stats=True,
                               valid_hw=hw, device="cpu")


def test_padded_extraction_matches_unpadded(golden_padded, port_padded):
    img, _, _ = golden_padded
    f0 = batch.extract_batch(img[None], PCFG, device="cpu")[0]
    f1 = port_padded[0][0]
    assert abs(f1.n - f0.n) <= max(2, 0.03 * f0.n)
    matched = 0
    for i in range(f0.n):
        dd = np.hypot(f1.x - f0.x[i], f1.y - f0.y[i])
        j = int(dd.argmin())
        if dd[j] < 0.25:
            matched += 1
            assert abs(f1.s[j] - f0.s[i]) < 0.05 * f0.s[i] + 1e-3
    assert matched >= 0.97 * f0.n


def test_padded_extraction_matches_jax(golden_padded, port_padded):
    _, padded, hw = golden_padded
    ref, rstats = jbatch.extract_batch(padded[None], CFG, return_stats=True,
                                       valid_hw=hw)
    ref = ref[0]
    feats, stats = port_padded[0][0], port_padded[1]
    assert stats == rstats
    matched, close = 0, 0
    for i in range(ref.n):
        dd = np.hypot(feats.x - ref.x[i], feats.y - ref.y[i])
        j = int(dd.argmin())
        if dd[j] < 0.01 and abs(feats.s[j] - ref.s[i]) < 1e-3 * ref.s[i]:
            matched += 1
            diff = np.abs(feats.desc[j].astype(int) - ref.desc[i].astype(int))
            close += int(diff.max() <= 2)
    assert matched >= 0.99 * ref.n
    assert close >= 0.988 * matched


def test_grouped_padded_matches_unpadded():
    B, H, W = 2, 150, 170          # not multiples of 64: padding engages
    imgs = np.stack([
        gen_images.synth_image(W, H, seed=s).astype(np.float32).mean(-1)
        for s in range(B)])
    groups_u = dist.default_group_spec(H, W, PCFG, per_image_cap=512,
                                       batch=B)
    ref = dist.extraction_step_grouped(imgs, PCFG, groups_u, device="cpu")
    padded, hw = zip(*[pad_to_bucket(im) for im in imgs])
    padded = np.stack(padded)
    Hp, Wp = padded.shape[-2:]
    groups_p = dist.default_group_spec(Hp, Wp, PCFG, per_image_cap=512,
                                       batch=B)
    out = dist.extraction_step_grouped(padded, PCFG, groups_p,
                                       valid_hw=np.asarray(hw, np.int32),
                                       device="cpu")
    rv, ov = n(ref.valid).astype(bool), n(out.valid).astype(bool)
    assert rv.sum() == ov.sum() > 20
    assert int(ref.overflow) == int(out.overflow) == 0

    def keyed(d, v):
        return {(int(i), round(float(x), 3), round(float(y), 3),
                 round(float(s), 3)): k
                for k, (i, x, y, s) in enumerate(zip(
                    n(d.img_idx)[v], n(d.x)[v], n(d.y)[v], n(d.s)[v]))}

    rk, gk = keyed(ref, rv), keyed(out, ov)
    assert set(rk) == set(gk)
    rd = n(ref.desc)[rv].astype(int)
    od = n(out.desc)[ov].astype(int)
    diffs = np.array([np.abs(rd[rk[k]] - od[gk[k]]).max() for k in rk])
    assert (diffs <= 2).mean() >= 0.95
    assert diffs.mean() <= 0.3


def test_pad_to_bucket_matches_jax():
    rng = np.random.default_rng(0)
    for shape in ((200, 160), (64, 128), (65, 1), (13, 77)):
        img = rng.random(shape).astype(np.float32)
        for m in (64, 32):
            a, ahw = pad_to_bucket(img, m)
            b, bhw = jpad_to_bucket(img, m)
            assert ahw == bhw
            np.testing.assert_array_equal(a, b)


VHW = [(40, 48), (33, 41), (20, 30), (12, 48)]


@pytest.fixture(scope="module")
def ladder():
    """Octave 0's DoH and blur ladders of synthetic 48x40 images."""
    from hesaff_tpu_torch import pyramid

    imgs = np.stack([
        gen_images.synth_image(48, 40, seed=10 + s).astype(np.float32)
        .mean(-1) for s in range(len(VHW))])
    first, pd = pyramid.prepare_first_level(torch.from_numpy(imgs), PCFG)
    o = pyramid.build_octave(first, pd, PCFG)
    return n(o.resps), n(o.blurs)


def test_plain_window_matches_jax(ladder):
    """K2's and K3's plain versions with limits against JAX's XLA twin
    (candidate_mask + _walk_dense with valid_hw) at every level, image
    by image, bit for bit: ok, cand / mask and cells."""
    resps, blurs = ladder
    vhw = np.asarray(VHW, np.int32)
    ok, cell, _, cand = cuda_detect.detect_walk_octave(
        torch.from_numpy(resps), torch.from_numpy(blurs), PCFG,
        torch.from_numpy(vhw))
    assert int(cand.sum()) > 0
    for b, v in enumerate(vhw):
        for l in range(1, CFG.num_scales + 1):
            args = [jnp.asarray(resps[b, k]) for k in (l - 1, l, l + 1)]
            mask, allm = jdetect._level_maps(*args, jnp.asarray(blurs[b, l]),
                                             CFG, valid_hw=jnp.asarray(v))
            jok, jcell = jdetect._walk_dense(allm, mask, CFG)
            np.testing.assert_array_equal(n(cand[b, l - 1]), n(mask))
            np.testing.assert_array_equal(n(ok[b, l - 1]), n(jok))
            np.testing.assert_array_equal(n(cell[b, l - 1])[n(jok)],
                                          n(jcell)[n(jok)])
            # K3's plain version: the same window on its mask
            planes = [torch.from_numpy(resps[b:b + 1, k])
                      for k in (l - 1, l, l + 1)]
            kmask = cuda_detect.detect_maps(*planes, PCFG,
                                            torch.from_numpy(vhw[b:b + 1]))[3]
            np.testing.assert_array_equal(n(kmask[0]), n(mask))
        # the window is the start pixels' only: nothing at or past it
        h, w = v
        assert not n(cand[b, :, h - CFG.border:, :]).any()
        assert not n(cand[b, :, :, w - CFG.border:]).any()


def test_detect_octave_window_matches_jax_under_upscale():
    """detect_affine_batch with valid_hw and upscale_input (the true size
    doubled, then floor-halved each octave) against the JAX package's:
    the same funnel counts per octave and the same detected keypoints."""
    cfg = dataclasses.replace(CFG, upscale_input=True)
    img = gen_images.synth_image(72, 64, seed=21).astype(np.float32).mean(-1)
    imgs = np.stack([img, img])
    vhw = np.asarray([[64, 72], [51, 45]], np.int32)
    ref = jbatch.detect_affine_batch(jnp.asarray(imgs), cfg,
                                     valid_hw=jnp.asarray(vhw))
    out = batch.detect_affine_batch(torch.from_numpy(imgs), port_cfg(cfg),
                                    vhw)
    np.testing.assert_array_equal(n(out["n_cand"]), n(ref["n_cand"]))
    np.testing.assert_array_equal(n(out["overflow"]), n(ref["overflow"]))
    np.testing.assert_array_equal(n(out["det_ok"]), n(ref["det_ok"]))
    d = n(ref["det_ok"])
    for k in ("x", "y"):
        np.testing.assert_allclose(n(out[k])[d], n(ref[k])[d], atol=0.01)
    # the same image: the narrower window of image 1 keeps fewer
    assert 0 < int(n(out["n_cand"])[1].sum()) < int(n(out["n_cand"])[0].sum())
