"""extract() of the PyTorch port end to end, on the CPU.

Against the oracle with the asserts of test_pipeline.py (>= 97% of
oracle keypoints within 0.5 px, ellipse rel < 0.02, descriptor mean
L1 < 0.5, count within max(2, 2%)); against JAX extract() on the same
image (>= 99% of keypoints at the same place within 0.01 px, and
descriptors within +-2 steps on >= 98.8% of them).
"""

import numpy as np
import pytest
import torch

from hesaff_tpu.config import HesaffConfig
from hesaff_tpu.ops import masks
from hesaff_tpu.sift_io import ellipse_abc
from hesaff_tpu_torch import extract, extract_batch, params
from hesaff_tpu_torch.ops.blur import gaussian_taps
from tests.conftest import parse_sift_bytes
from _torch_parity import n, port_cfg

CFG = HesaffConfig()
PCFG = port_cfg(CFG)


@pytest.fixture(scope="module")
def port_small(golden_small):
    return extract(golden_small["gray"], PCFG, device="cpu",
                   return_stats=True)


def test_end_to_end_matches_oracle(golden_small, port_small):
    gu, gv, ge, gdesc = parse_sift_bytes(golden_small["sift_file"])
    feats, stats = port_small
    assert stats.candidate_overflow == 0
    assert stats.bucket_overflow == 0
    e00, e01, e11 = ellipse_abc(
        feats.a11.astype(np.float64), feats.a12.astype(np.float64),
        feats.a21.astype(np.float64), feats.a22.astype(np.float64),
        feats.s.astype(np.float64), CFG.mr_size)
    matched = 0
    for i in range(len(gu)):
        dd = np.hypot(feats.x - gu[i], feats.y - gv[i])
        j = int(dd.argmin())
        if dd[j] < 0.5:
            matched += 1
            ell = np.array([e00[j], e01[j], e11[j]])
            rel = np.abs(ell - ge[i]).max() / max(np.abs(ge[i]).max(), 1e-12)
            assert rel < 0.02, f"ellipse mismatch at oracle kp {i}"
            l1 = np.abs(feats.desc[j].astype(np.int32) - gdesc[i]).mean()
            assert l1 < 0.5, f"descriptor mismatch at oracle kp {i}"
    assert matched >= 0.97 * len(gu)
    assert abs(feats.n - len(gu)) <= max(2, 0.02 * len(gu))


def test_end_to_end_matches_jax(golden_small, port_small):
    import hesaff_tpu

    ref, rstats = hesaff_tpu.extract(golden_small["gray"], CFG,
                                     return_stats=True)
    feats, stats = port_small
    assert stats == rstats
    assert feats.desc.dtype == np.uint8 and feats.desc.shape == (feats.n,
                                                                 128)
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


@pytest.mark.parametrize("shape", [(64, 64), (13, 13)])
def test_flat_or_tiny_image_gives_no_features(shape):
    feats, stats = extract(np.full(shape, 9.0, np.float32), PCFG,
                           device="cpu", return_stats=True)
    assert feats.n == 0 and stats.num_candidates == 0
    assert feats.desc.shape == (0, 128)


def test_batch_of_two_matches_single_extraction(golden_small, port_small):
    g = golden_small["gray"]
    out = extract_batch(torch.as_tensor(np.stack([g, g[:, ::-1].copy()])),
                        PCFG)
    first = out[0]
    np.testing.assert_array_equal(first.x, port_small[0].x)
    np.testing.assert_array_equal(first.desc, port_small[0].desc)
    assert out[1].n > 0


def test_params_tables_equal_jax_side():
    from hesaff_tpu import pyramid as jpyr
    from hesaff_tpu.ops.blur import gaussian_taps as jtaps

    tb = params.tables(PCFG, "cpu")
    np.testing.assert_array_equal(n(tb["smm_mask"]),
                                  masks.smm_gauss_mask(CFG.smm_window_size))
    np.testing.assert_array_equal(n(tb["circ_mask"]),
                                  masks.circular_gauss_mask(CFG.patch_size))
    np.testing.assert_array_equal(
        n(tb["spatial_bins"]),
        masks.sift_spatial_bins(CFG.patch_size, CFG.spatial_bins))
    sig = jpyr.level_sigmas(CFG)
    step = CFG.sigma_step
    for i, taps in enumerate(tb["ladder_taps"]):
        np.testing.assert_array_equal(
            n(taps), jtaps(sig[i] * np.sqrt(step * step - 1.0)))
    np.testing.assert_array_equal(
        n(tb["first_taps"]), jtaps(np.sqrt(CFG.initial_sigma ** 2 - 0.25)))
    np.testing.assert_array_equal(n(tb["first_taps"]),
                                  gaussian_taps(np.sqrt(1.6 ** 2 - 0.25)))
