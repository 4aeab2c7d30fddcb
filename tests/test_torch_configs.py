"""The port at configurations other than the default, against JAX.

Each plain version that stands beside a configurable CUDA kernel is
held to its JAX XLA twin at the tolerances the default configuration's
parity tests use: SIFT (K6) within one step and > 99% exact on patches
of 65, 96 and 97 px and at 3 x 3 x 8, 4 x 4 x 6 and 4 x 4 x 1 bins
(test_torch_patches_sift.py); the group patch pipeline (K5) and the
bucket path (K5 beside the direct warp in a mixed bucket)
with equal ok flags and patches at atol 1e-3 at 65 and 97 px, and
at 96 and 128 px against JAX's Pallas group kernel in interpret mode
(test_torch_group_patches.py); blur + DoH (K1) at 37 and 63 taps and
the octave ladder at initial_sigma 4.0 with blur atol 1e-4 and response
atol 0.05 (test_torch_ladder.py); the affine loop (K4) at grid sides 33
and 63 under the 2% ok / iteration flip budget, U rtol 1e-4 / atol
5e-5 (test_torch_affine.py).  The whole slice, where the direct-warp
branch is live: extract at patch_size 65 on the 200x160 golden against
JAX's extract_batch with test_torch_pipeline.py's rule (>= 99% of
keypoints at the same place within 0.01 px, >= 98.8% of those with
every bin within 2), and the grouped path at 65 and 96 on the golden
and a flipped copy against JAX's grouped step, with equal counts per
image, equal overflow and the same rule.  extract at an even side
raises a ValueError in both packages (the bucket path's subsample has
P + 1 points a side).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hesaff_tpu import affine_shape as jaff
from hesaff_tpu import batch as jbatch
from hesaff_tpu import dist as jdist
from hesaff_tpu import patches as jpat
from hesaff_tpu import pyramid as jpyr
from hesaff_tpu import sift as jsift
from hesaff_tpu.config import HesaffConfig
from hesaff_tpu.ops.blur import gaussian_blur_traced
from hesaff_tpu.ops.hessian import hessian_response as jresponse
from hesaff_tpu_torch import affine_shape, dist, extract, patches, pyramid
from hesaff_tpu_torch import sift
from hesaff_tpu_torch.ops import cuda_blur, cuda_patches, cuda_sift
from hesaff_tpu_torch.ops.blur import gaussian_taps
from hesaff_tpu_torch.ops.hessian import norm2_of
from _torch_parity import assert_affine_parity, n, port_cfg, smooth_stacks, t

CFG = HesaffConfig()


def cfg_of(**kw):
    return dataclasses.replace(CFG, **kw)


@pytest.mark.parametrize("P,sb,ob", [
    (65, 4, 8), (96, 4, 8), (97, 4, 8), (41, 3, 8), (41, 4, 6),
    (65, 3, 8), (41, 4, 1)])
def test_sift_matches_jax(P, sb, ob):
    cfg = cfg_of(patch_size=P, spatial_bins=sb, orientation_bins=ob)
    rng = np.random.default_rng(P + 10 * sb + ob)
    p = np.clip(smooth_stacks(rng, 60, P, P), 0, 255).astype(np.float32)
    p[0] = 55.0                              # flat: photometric no-op
    ref = np.asarray(jsift.sift_descriptors(jnp.asarray(p), cfg))
    out = n(sift.sift_descriptors(t(p), port_cfg(cfg)))
    assert out.shape == ref.shape == (60, sb * sb * ob)
    fin = np.isfinite(ref).all(axis=1)
    np.testing.assert_array_equal(np.isfinite(out).all(axis=1), fin)
    diff = np.abs(ref[fin] - out[fin])
    assert diff.max() <= 1
    assert (diff == 0).mean() > 0.99


@pytest.mark.parametrize("sb,ob", [(3, 8), (4, 6)])
def test_describe_masked_plain_rows(sb, ob):
    """K6's masked entry (plain version): rows sb * sb * ob wide, the
    float entry's values where valid, zero elsewhere."""
    cfg = port_cfg(cfg_of(spatial_bins=sb, orientation_bins=ob))
    rng = np.random.default_rng(sb * ob)
    p = t(np.clip(smooth_stacks(rng, 12, 41, 41), 0, 255))
    valid = t(rng.random(12) < 0.5)
    out = cuda_sift.describe_masked(p, valid, cfg)
    assert out.dtype == torch.uint8 and out.shape == (12, sb * sb * ob)
    assert not bool(out[~valid].any())
    assert torch.equal(out[valid],
                       sift.sift_descriptors(p[valid], cfg).to(torch.uint8))


def _bucket_case(rng, P, bucket, K=48):
    """Keypoints whose workspaces fill `bucket` at patch side P, far
    enough from the border that most patches fit."""
    B, H, W = 2, 2 * bucket + 100, 2 * bucket + 180
    images = smooth_stacks(rng, B, H, W)
    i = patches.BUCKET_SIZES.index(bucket)
    prev = patches.BUCKET_SIZES[i - 1] if i else 0
    # ws = 2 ceil(s mr_size) + 3 in (prev, bucket]
    smin = (max(prev - 3, 1) + 0.01) / (2 * CFG.mr_size)
    smax = (bucket - 3) / (2 * CFG.mr_size)
    d = np.exp(rng.normal(0, 0.25, K)).astype(np.float32)
    kp = dict(
        img_idx=rng.integers(0, B, K).astype(np.int32),
        x=rng.uniform(bucket, W - bucket, K).astype(np.float32),
        y=rng.uniform(bucket, H - bucket, K).astype(np.float32),
        s=rng.uniform(smin, smax, K).astype(np.float32),
        a11=d, a12=np.zeros(K, np.float32),
        a21=rng.normal(0, 0.35, K).astype(np.float32),
        a22=(1.0 / d).astype(np.float32))
    kp["x"][:2] = [3.0, W - 4.0]               # boundary-touching patches
    active = rng.uniform(size=K) > 0.2
    active[:2] = True
    return images, kp, active, prev


_KP = ("img_idx", "x", "y", "s", "a11", "a12", "a21", "a22")


@pytest.mark.parametrize("P,bucket", [(65, 33), (65, 97), (97, 41),
                                      (97, 193)])
def test_patch_paths_match_jax(P, bucket):
    """At P = 65 bucket 33 mixes direct-warp keypoints into the blur
    branch, and at 97 bucket 41 does.  The port's bucket path (the group
    pipeline of K5 for the blur branch, the direct warp for the rest,
    run here on CPU tensors) and the group pipeline alone on the
    blur-branch keypoints, against JAX's bucket path."""
    cfg = cfg_of(patch_size=P)
    pcfg = port_cfg(cfg)
    images, kp, active, prev = _bucket_case(
        np.random.default_rng(P + bucket), P, bucket)
    ref_pk, ref_ok = (np.asarray(a) for a in jpat.extract_bucket_batch(
        jnp.asarray(images), bucket, *(jnp.asarray(kp[k]) for k in _KP),
        cfg, active=jnp.asarray(active), prev_bucket=prev))
    ref_ok = ref_ok & active
    assert ref_ok.sum() >= 8 and not ref_ok[:2].any()
    _, _, its = cuda_patches.patch_geometry(t(kp["s"]), pcfg)
    direct = n(cuda_patches.takes_direct(its, pcfg))
    use_blur = (bucket - 2) / P > CFG.oversample_cutoff
    mixed = cuda_patches.direct_possible(pcfg, prev)
    assert use_blur and mixed == (bucket == {65: 33, 97: 41}[P])
    assert direct.any() == mixed
    args = [t(kp[k]) for k in _KP]
    pk, ok = patches.extract_bucket_batch(
        t(images), bucket, *args, pcfg, active=t(active), prev_bucket=prev)
    np.testing.assert_array_equal(n(ok), ref_ok)
    np.testing.assert_allclose(n(pk)[ref_ok], ref_pk[ref_ok], atol=1e-3)
    blur_act = active & ~direct
    pk, ok = cuda_patches.extract_group(
        t(images), bucket, *args[:5], *args[6:], pcfg, t(blur_act))
    sel = ref_ok & blur_act
    assert sel.sum() >= 4
    np.testing.assert_array_equal(n(ok), sel)
    np.testing.assert_allclose(n(pk)[sel], ref_pk[sel], atol=1e-3)


@pytest.mark.parametrize("P,bucket,smin,smax", [(96, 97, 4.5, 8.8),
                                                (128, 193, 9.5, 18.0)])
def test_group_pipeline_at_even_side_matches_jax_kernel(P, bucket, smin,
                                                        smax):
    """K5's plain version at even patch sides (which JAX's bucket path
    does not take) against JAX's Pallas group kernel in interpret mode,
    test_torch_group_patches.py's tolerances."""
    from hesaff_tpu.ops import pallas_patches as jpp

    cfg = cfg_of(patch_size=P)
    rng = np.random.default_rng(P)
    B, H, W = 2, 400, 480
    images = smooth_stacks(rng, B, H, W)
    K = 16
    d = np.exp(rng.normal(0, 0.25, K)).astype(np.float32)
    kp = dict(img_idx=rng.integers(0, B, K).astype(np.int32),
              x=rng.uniform(120, W - 120, K).astype(np.float32),
              y=rng.uniform(120, H - 120, K).astype(np.float32),
              s=rng.uniform(smin, smax, K).astype(np.float32),
              a11=d, a21=rng.normal(0, 0.3, K).astype(np.float32),
              a22=(1.0 / d).astype(np.float32))
    active = rng.uniform(size=K) > 0.2
    names = ("img_idx", "x", "y", "s", "a11", "a21", "a22")
    pk_ref, ok_ref = jpp.extract_group_pallas(
        jnp.asarray(images), bucket, *(jnp.asarray(kp[k]) for k in names),
        cfg, active=jnp.asarray(active), interpret=True)
    pk, ok = cuda_patches.extract_group(
        t(images), bucket, *(t(kp[k]) for k in names), port_cfg(cfg),
        t(active))
    ok_ref = n(ok_ref) & active
    np.testing.assert_array_equal(n(ok), ok_ref)
    assert ok_ref.sum() >= 8
    np.testing.assert_allclose(n(pk)[ok_ref], n(pk_ref)[ok_ref], atol=1e-3)


@pytest.mark.parametrize("k", [37, 63])
def test_blur_doh_plain_matches_jax(k):
    rng = np.random.default_rng(k)
    img = smooth_stacks(rng, 2, 90, 120)
    sigma = (k - 1) / 6.0
    taps = gaussian_taps(sigma, k)
    b, r = cuda_blur.blur_doh_plain(t(img), taps, norm2_of(sigma * sigma))
    for i in range(2):
        jb = gaussian_blur_traced(jnp.asarray(img[i]), jnp.asarray(taps))
        np.testing.assert_allclose(n(b[i]), np.asarray(jb), atol=1e-4)
        np.testing.assert_allclose(
            n(r[i]), np.asarray(jresponse(jb, sigma * sigma)), atol=0.05)


def test_ladder_at_initial_sigma_4_matches_jax(golden_small):
    """The ladder's taps at initial_sigma 4.0 (37 at its top level, 25
    for the first level) and the octave against JAX's build_octave."""
    cfg = cfg_of(initial_sigma=4.0)
    pcfg = port_cfg(cfg)
    widths = [len(k) for k in pyramid.ladder_taps(pcfg)]
    assert max(widths) == 37
    assert {cuda_blur.instance(w) for w in widths} == {"generic"}
    gray = golden_small["gray"]
    first, pd = pyramid.prepare_first_level(t(gray[None]), pcfg)
    o = pyramid.build_octave(first, pd, pcfg)
    jfirst, jpd = jpyr.prepare_first_level(jnp.asarray(gray), cfg)
    np.testing.assert_allclose(n(first[0]), n(jfirst), atol=1e-4)
    jo = jpyr.build_octave(jfirst, jpd, cfg)
    np.testing.assert_allclose(n(o.blurs[0]), n(jo.blurs), atol=1e-4)
    np.testing.assert_allclose(n(o.resps[0]), n(jo.resps), atol=0.05)


@pytest.mark.parametrize("G", [33, 63])
def test_adapt_matches_jax_at_grid_side(G):
    cfg = cfg_of(smm_window_size=G)
    rng = np.random.default_rng(G)
    B, L, H, W, K = 2, 3, 128, 112, 48
    stacks = smooth_stacks(rng, B, L, H, W)
    img_idx = rng.integers(0, B, K).astype(np.int32)
    src = rng.integers(0, L, K).astype(np.int32)
    x = rng.uniform(20, W - 20, K).astype(np.float32)
    y = rng.uniform(20, H - 20, K).astype(np.float32)
    s = rng.uniform(2.0, 5.0, K).astype(np.float32)
    active = rng.uniform(size=K) > 0.2
    ref = jaff.adapt_flat(jnp.asarray(stacks), jnp.asarray(img_idx),
                          jnp.asarray(src), jnp.asarray(x), jnp.asarray(y),
                          jnp.asarray(s), 1.0, cfg,
                          active=jnp.asarray(active))
    out = affine_shape.adapt_flat(t(stacks), t(img_idx), t(src), t(x),
                                  t(y), t(s), 1.0, port_cfg(cfg),
                                  active=t(active))
    assert_affine_parity(ref, out, active, min_matched=8)
    jax.clear_caches()


def _pipeline_rule(ref, got):
    """test_torch_pipeline.py's rule: >= 99% of ref's keypoints at the
    same place within 0.01 px (and s within 1e-3), >= 98.8% of those
    with every bin within 2.  ref, got: (x, y, s, desc) arrays."""
    rx, ry, rs, rd = ref
    gx, gy, gs, gd = got
    matched, close = 0, 0
    for i in range(len(rx)):
        dd = np.hypot(gx - rx[i], gy - ry[i])
        j = int(dd.argmin())
        if dd[j] < 0.01 and abs(gs[j] - rs[i]) < 1e-3 * rs[i]:
            matched += 1
            diff = np.abs(gd[j].astype(int) - rd[i].astype(int))
            close += int(diff.max() <= 2)
    assert len(rx) > 20
    assert matched >= 0.99 * len(rx)
    assert close >= 0.988 * matched


@pytest.fixture(scope="module")
def extract_65(golden_small):
    """extract at patch_size 65 (its direct branch live) on the 200x160
    golden: JAX's extract_batch and the port's extract."""
    cfg = cfg_of(patch_size=65)
    pcfg = port_cfg(cfg)
    assert cuda_patches.direct_possible(pcfg)
    gray = golden_small["gray"]
    ref = jbatch.extract_batch(jnp.asarray(gray[None]), cfg)[0]
    got = extract(gray, pcfg, device="cpu", return_stats=True)
    jax.clear_caches()
    return ref, got


def test_extract_at_patch_65_matches_jax(extract_65):
    ref, (got, stats) = extract_65
    assert stats.candidate_overflow == stats.bucket_overflow == 0
    assert got.desc.shape == (got.n, 128)
    assert abs(got.n - ref.n) <= max(1, 0.01 * ref.n)
    _pipeline_rule((ref.x, ref.y, ref.s, ref.desc),
                   (got.x, got.y, got.s, got.desc))


# One full-resolution group and the direct stage.  The capacities
# overflow (keypoints past 97 px and past the direct stage's 64 slots),
# so the count of those held out is compared too.  JAX's grouped step
# runs its Pallas kernel in interpret mode here: ~35-40 s a patch side,
# most of it tracing, so the default table's three groups are not used.
GROUPS = ((97, 256),)
_DENSE = ("valid", "img_idx", "x", "y", "s", "desc", "overflow")


@pytest.fixture(scope="module", params=[65, 96])
def grouped_pair(request, golden_small):
    """The grouped step at patch_size 65 and 96 (the direct branch live
    at both) on the 200x160 golden and a flipped copy: JAX's (Pallas in
    interpret mode) and the port's."""
    P = request.param
    cfg = cfg_of(patch_size=P)
    gray = golden_small["gray"]
    imgs = np.stack([gray, gray[::-1, ::-1].copy()])
    ref = jdist.extraction_step_grouped(jnp.asarray(imgs), cfg, GROUPS,
                                        interpret=True)
    ref = {k: np.asarray(getattr(ref, k)) for k in _DENSE}
    out = dist.extraction_step_grouped(imgs, port_cfg(cfg), GROUPS,
                                       device="cpu")
    jax.clear_caches()
    return P, ref, {k: n(getattr(out, k)) for k in _DENSE}


def test_grouped_matches_jax_grouped_step(grouped_pair):
    """Equal overflow, equal counts per image, the pipeline rule per
    image, and zero rows where no patch is valid."""
    P, ref, out = grouped_pair
    assert int(out["overflow"]) == int(ref["overflow"]) > 0
    ov, rv = out["valid"].astype(bool), ref["valid"].astype(bool)
    S = 2 * np.ceil(out["s"][ov] * CFG.mr_size).astype(np.int32) + 1
    assert (S / P <= CFG.oversample_cutoff).any()       # direct branch
    assert out["desc"].shape == (ov.size, 128)
    assert not out["desc"][~ov].any()
    for b in range(2):
        m = ov & (out["img_idx"] == b)
        r = rv & (ref["img_idx"] == b)
        assert m.sum() == r.sum()
        _pipeline_rule(tuple(ref[k][r] for k in ("x", "y", "s", "desc")),
                       tuple(out[k][m] for k in ("x", "y", "s", "desc")))


@pytest.mark.parametrize("P", [96, 128])
def test_extract_at_even_patch_side_raises(P):
    """The bucket path's blur branch does not take an even patch side
    (its subsample has P + 1 points a side): the port raises a
    ValueError that names it.  JAX's extract_batch raises a ValueError
    on this input at 96 too, by a shape mismatch ("value array of shape
    (2,97,97) could not be broadcast to indexing result of shape
    (2,96,96)", batch.py); not run here, ~20 s of tracing."""
    gray = np.zeros((64, 64), np.float32)
    gray[20:40, 24:44] = 200.0
    with pytest.raises(ValueError, match=f"patch_size {P} is even"):
        extract(gray, port_cfg(cfg_of(patch_size=P)), device="cpu")
