"""The port's single-image conveniences against their JAX twins.

octave_shapes, gaussian_blur / gaussian_blur_traced, solve3x3,
affine_sample, adapt_compacted / adapt_level and extract_bucket, each on
the same numpy inputs as the JAX function, on the CPU: the schedule
equal; blurs and warps at rtol / atol 1e-5; solve3x3 with the NaN / Inf
pattern of singular systems equal; adaptation under test_pallas.py's
budget (assert_affine_parity); patches at test_pallas.py's atol 1e-3
with equal ok flags.  adapt_level runs tests/test_affine.py's cases
(the 200x160 golden's octave-0 detection levels against their
prevBlur, and a flat window), extract_bucket tests/test_patches.py's
(the oracle's own affine shapes, rectified, bucket by bucket: all nine
buckets against the oracle's patches, three against JAX).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hesaff_tpu import affine_shape as jaff
from hesaff_tpu import patches as jpat
from hesaff_tpu import pyramid as jpyr
from hesaff_tpu.config import HesaffConfig
from hesaff_tpu.ops import blur as jblur
from hesaff_tpu.ops import linalg as jlin
from hesaff_tpu.ops import warp as jwarp
from hesaff_tpu_torch import affine_shape, detect, patches, pyramid
from hesaff_tpu_torch.ops import blur, linalg, warp
from _torch_parity import assert_affine_parity, n, port_cfg, smooth_stacks, t
from test_torch_ops import _systems

CFG = HesaffConfig()
PCFG = port_cfg(CFG)


@pytest.mark.parametrize("h,w,upscale", [
    (160, 200, False), (13, 13, False), (160, 200, True)])
def test_octave_shapes_match_jax(h, w, upscale):
    cfg = dataclasses.replace(CFG, upscale_input=upscale)
    assert (pyramid.octave_shapes(h, w, port_cfg(cfg))
            == jpyr.octave_shapes(h, w, cfg))


@pytest.mark.parametrize("sigma", [0.8, 1.6, 3.1])
def test_gaussian_blur_matches_jax(sigma):
    img = smooth_stacks(np.random.default_rng(1), 2, 37, 53)
    ref = jblur.gaussian_blur(jnp.asarray(img), sigma)
    np.testing.assert_allclose(n(blur.gaussian_blur(t(img), sigma)),
                               n(ref), rtol=1e-5, atol=1e-5)
    taps = jblur.gaussian_taps(sigma)
    ref = jblur.gaussian_blur_traced(jnp.asarray(img), jnp.asarray(taps))
    for arg in (taps, t(taps)):
        np.testing.assert_allclose(
            n(blur.gaussian_blur_traced(t(img), arg)), n(ref),
            rtol=1e-5, atol=1e-5)


def test_solve3x3_matches_jax_with_singular_pattern():
    A, b = _systems(np.random.default_rng(5), 64)
    r = n(jlin.solve3x3(jnp.asarray(A), jnp.asarray(b)))
    o = n(linalg.solve3x3(t(A), t(b)))
    assert o.shape == r.shape == (64, 3)
    np.testing.assert_array_equal(np.isnan(o), np.isnan(r))
    np.testing.assert_array_equal(np.isinf(o), np.isinf(r))
    assert not np.isfinite(r[:5]).all()
    fin = np.isfinite(r)
    np.testing.assert_allclose(o[fin], r[fin], rtol=1e-5, atol=1e-5)
    # a stack of systems with two leading axes
    o2 = n(linalg.solve3x3(t(A[8:16].reshape(2, 4, 3, 3)),
                           t(b[8:16].reshape(2, 4, 3))))
    np.testing.assert_array_equal(o2.reshape(8, 3), o[8:16])


@pytest.mark.parametrize("params,touched", [
    ((31.3, 27.8, 1.2, 0.0, -0.3, 0.83), False),
    ((20.5, 33.1, 0.7, 0.25, 0.4, 1.1), False),
    ((5.2, 30.0, 1.0, 0.0, 0.0, 1.0), True),       # runs off the left edge
])
def test_affine_sample_matches_jax(params, touched):
    img = smooth_stacks(np.random.default_rng(2), 64, 72)
    ref, rt = jwarp.affine_sample(jnp.asarray(img), 21, 25,
                                  *(jnp.float32(v) for v in params))
    out, ot = warp.affine_sample(t(img), 21, 25,
                                 *(torch.tensor(v) for v in params))
    np.testing.assert_allclose(n(out), n(ref), rtol=1e-5, atol=1e-5)
    assert bool(ot) == bool(rt) == touched


def _golden_levels(golden):
    """tests/test_affine.py's inputs at octave 0: the 200x160 golden's
    detection levels, deduplicated, with the blur below each.  The
    port's ladder and detection make them (held to JAX's by
    test_torch_pyramid.py and test_torch_detect.py); both packages'
    adaptations then take the same numpy arrays."""
    cur, pd = pyramid.prepare_first_level(t(golden["gray"]), PCFG)
    sig = pyramid.level_sigmas(PCFG)
    H, W = cur.shape
    o = pyramid.build_octave(cur[None], pd, PCFG)
    cap = PCFG.level_capacity(H, W)
    levels = detect.dedup_octave([
        detect.detect_level(o.resps[:, l - 1], o.resps[:, l],
                            o.resps[:, l + 1], o.blurs[:, l], sig[l], pd,
                            cap, PCFG)
        for l in (1, 2, 3)], H, W)
    stack = n(o.blurs[0])
    out = []
    for lvl, lk in zip((1, 2, 3), levels):
        ok = n(lk.ok[0])
        safe = lambda a, d: np.where(ok, n(a[0]), d).astype(np.float32)
        out.append((stack[lvl - 1], stack, lvl - 1,
                    safe(lk.x, (W // 2) * pd), safe(lk.y, (H // 2) * pd),
                    safe(lk.s, 2.0 * pd), pd, ok))
    return out


def test_adapt_level_and_compacted_match_jax(golden_small):
    # one compile for the three levels (equal shapes)
    jadapt = jax.jit(jaff.adapt_level, static_argnums=(4, 5))
    matched = 0
    for prev, stack, src, x, y, s, pd, ok in _golden_levels(golden_small):
        ref = jadapt(jnp.asarray(prev), jnp.asarray(x), jnp.asarray(y),
                     jnp.asarray(s), pd, CFG)
        out = affine_shape.adapt_level(t(prev), t(x), t(y), t(s), pd, PCFG)
        assert_affine_parity(ref, out, ok, min_matched=0)
        matched += int((n(out.ok) & ok).sum())
        # the same keypoints through the stack form, active = ok: equal
        # to adapt_level where active
        srcs = np.full(x.shape, src, np.int32)
        out_c = affine_shape.adapt_compacted(t(stack), t(srcs), t(x), t(y),
                                             t(s), pd, PCFG, active=t(ok))
        for f in out._fields:
            np.testing.assert_array_equal(n(getattr(out_c, f))[ok],
                                          n(getattr(out, f))[ok])
        assert not n(out_c.ok)[~ok].any()
    assert matched >= 30


def test_adapt_level_flat_window_does_not_converge():
    """tests/test_affine.py's flat window: zero gradients, a singular
    second-moment matrix, no convergence (on both packages)."""
    blur0 = np.zeros((64, 64), np.float32)
    args = ([32.0], [32.0], [2.0])
    ref = jaff.adapt_level(jnp.asarray(blur0),
                           *(jnp.asarray(a, jnp.float32) for a in args),
                           1.0, CFG)
    out = affine_shape.adapt_level(t(blur0),
                                   *(torch.tensor(a) for a in args), 1.0,
                                   PCFG)
    assert not bool(ref.ok[0]) and not bool(out.ok[0])


JAX_BUCKETS = (25, 65, 161)   # the case's smallest, fullest and largest


def test_extract_bucket_matches_jax(golden_small):
    """tests/test_patches.py's case: every bucket against the oracle's
    patches (that test's bounds: ok equal, atol 0.01), and the
    smallest, fullest and largest of its nine buckets against JAX's
    extract_bucket (equal ok, atol 1e-3; each JAX bucket is a compile
    of its own)."""
    g = golden_small["affine_shapes"]
    x, y, s = g[:, 0], g[:, 1], g[:, 2]
    r11, r12, r21, r22 = (np.asarray(v) for v in jlin.rectify_up_is_up(
        *(jnp.asarray(g[:, i]) for i in (4, 5, 6, 7))))
    image = golden_small["gray"]
    groups = {}
    for i, ws in enumerate(jpat.patch_image_size(s, CFG.mr_size) + 2):
        groups.setdefault(jpat.bucket_for(int(ws)), []).append(i)
    assert set(JAX_BUCKETS) <= set(groups)
    ok_all = np.zeros(len(g), bool)
    pk_all = np.zeros((len(g), CFG.patch_size, CFG.patch_size), np.float32)
    for b, idx in sorted(groups.items()):
        args = [np.ascontiguousarray(a[idx], np.float32)
                for a in (x, y, s, r11, r12, r21, r22)]
        pk, ok = patches.extract_bucket(t(image), b, *(t(a) for a in args),
                                        PCFG)
        pk_all[idx], ok_all[idx] = n(pk), n(ok)
        if b in JAX_BUCKETS:
            pk_ref, ok_ref = jpat.extract_bucket(
                jnp.asarray(image), b, *(jnp.asarray(a) for a in args), CFG)
            np.testing.assert_array_equal(n(ok), n(ok_ref))
            m = n(ok)
            np.testing.assert_allclose(n(pk)[m], n(pk_ref)[m], atol=1e-3)
    np.testing.assert_array_equal(ok_all,
                                  golden_small["rect_norm"][:, 5] > 0)
    gp = golden_small["patches"]
    assert ok_all.sum() == len(gp)
    np.testing.assert_allclose(pk_all[ok_all].reshape(len(gp), -1), gp,
                               atol=0.01)
