"""The port's CUDA kernels against their plain versions, on a GPU.

Marked `cuda`: each test skips where torch.cuda.is_available() is
false.  They need neither JAX nor the golden fixtures, so on a GPU host
they run as

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances are the kernels' (chip_smoke.py states the same): blur atol
1e-4 and response atol 0.1 (and bit-equal blur and response at every
tap count, in stack slots and blur-only); the octave-wide walk exact (ok, cand,
cells) at every level with its field table at rtol 1e-6 / atol 1e-5 at
every pixel; the maps kernel with equal mask, nan and edge flags and
the maps at rtol 1e-6 / atol 1e-5 where the mask is set (bit-equal
everywhere on odd shapes, strided views and planes with NaN and inf); the sparse
octave path equal to its CPU run in every field but s (rtol 1e-6, the
exp2 wobble); the affine loop under the 2% ok/iteration flip budget
with U rtol 1e-4 / atol 5e-5; the patch kernel with equal bad flags
and patches at atol 1e-3; SIFT within one step and >= 99% exact (its masked uint8 entry equal to
its float entry, zero rows where not valid).  After the descriptors
(no kernel of the port's own): knn2 on the card bit-equal to its CPU
run on uint8 descriptors (a single database row's padded dist2 at rtol
1e-6), match pairs equal; RANSAC and the pose to tests/test_ransac.py's
thresholds; the Oxford file from CUDA tensors byte-equal to the one
from their numpy copies.  Padded mode: K2 and K3 with per-image limits
equal to their plain versions (the table and maps bit-equal to the
unlimited call's), the padded grouped path equal to its CPU run.
Geometry: an LM step bit-equal across two runs (dense and tracks),
within rtol 1e-4 / atol 1e-5 of the CPU step; ba_solve and
incremental_sfm at tests/test_geom.py's and tests/test_sfm.py's
thresholds.  Multi-device: the staged bucket step (K5 on every bucket at
full resolution) against its CPU run (keypoints within 0.01 px,
descriptors within 2 steps, equal overflow); the pipeline with both
stages on cuda:0 equal to the staged step (fields within 1e-5); over a
one-rank NCCL group ring_knn2 and ba_solve_sharded bit-equal to their
one-device forms.
"""

import os

import numpy as np
import pytest
import torch

from hesaff_tpu_torch.config import HesaffConfig
from _torch_parity import assert_affine_parity, smooth_stacks
from _torch_scenes import ba_problem, sfm_scene

pytestmark = pytest.mark.cuda
CFG = HesaffConfig()
AFFINE_FIELDS = ("ok", "u11", "u12", "u21", "u22", "iters")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape,k", [((2, 61, 47), 15), ((1, 200, 333), 9),
                                     ((3, 17, 16), 31)])
def test_blur_doh_kernel(dev, shape, k):
    from hesaff_tpu_torch.ops import cuda_blur
    from hesaff_tpu_torch.ops.blur import gaussian_taps

    rng = np.random.default_rng(0)
    img = torch.as_tensor((rng.random(shape) * 255).astype(np.float32),
                          device=dev)
    taps = gaussian_taps((k - 1) / 6.0, k)
    before = cuda_blur.LAUNCHES
    b, r = cuda_blur.blur_doh(img, taps, 6.5536)
    pb, pr = cuda_blur.blur_doh_plain(img, taps, 6.5536)
    torch.cuda.synchronize()
    assert cuda_blur.LAUNCHES == before + 1
    assert float((b - pb).abs().max()) <= 1e-4
    assert float((r - pr).abs().max()) <= 0.1


@pytest.mark.parametrize("k", [1, 3, 9, 11, 13, 15, 31])
@pytest.mark.parametrize("shape", [(3, 17, 16), (2, 61, 47), (1, 70, 200)])
def test_blur_doh_kernel_bit_equal(dev, shape, k):
    """K1 at each templated tap count (1, 9, 11, 13, 15) and the generic
    instance (3, 31), on sizes off the 64 x 32 tile and on rows that
    take the 16-byte loads (W % 4 == 0): bit-equal to its plain version,
    blur and response."""
    from hesaff_tpu_torch.ops import cuda_blur
    from hesaff_tpu_torch.ops.blur import gaussian_taps

    rng = np.random.default_rng(k)
    img = torch.as_tensor((rng.random(shape) * 255).astype(np.float32),
                          device=dev)
    taps = [1.0] if k == 1 else gaussian_taps((k - 1) / 6.0, k)
    before = cuda_blur.LAUNCHES
    b, r = cuda_blur.blur_doh(img, taps, 6.5536)
    pb, pr = cuda_blur.blur_doh_plain(img, taps, 6.5536)
    torch.cuda.synchronize()
    assert cuda_blur.LAUNCHES == before + 1
    assert torch.equal(b, pb) and torch.equal(r, pr)
    if k == 1:
        assert torch.equal(b, img)


@pytest.mark.parametrize("H,W", [(61, 47), (64, 128)])
def test_blur_doh_kernel_stack_slots(dev, H, W):
    """K1 reading slot i of a (B, L, H, W) stack and writing slot i + 1
    of it and of a response stack, and in blur-only mode from a slot:
    bit-equal to the plain version, the other slots untouched."""
    from hesaff_tpu_torch.ops import cuda_blur
    from hesaff_tpu_torch.ops.blur import gaussian_taps, separable_blur

    rng = np.random.default_rng(11)
    stack = torch.as_tensor(smooth_stacks(rng, 2, 5, H, W), device=dev)
    keep = stack.clone()
    resps = torch.full_like(stack, -1.0)
    taps = gaussian_taps(2.45)
    before = cuda_blur.LAUNCHES
    cuda_blur.blur_doh(stack[:, 1], taps, 6.5536, out=stack[:, 2],
                       resp_out=resps[:, 2])
    pb, pr = cuda_blur.blur_doh_plain(keep[:, 1], taps, 6.5536)
    only = cuda_blur.blur(stack[:, 0], taps)
    torch.cuda.synchronize()
    assert cuda_blur.LAUNCHES == before + 2
    assert torch.equal(stack[:, 2], pb) and torch.equal(resps[:, 2], pr)
    assert torch.equal(only, separable_blur(keep[:, 0], taps))
    for i in (0, 1, 3, 4):
        assert torch.equal(stack[:, i], keep[:, i])
    assert bool((resps[:, [0, 1, 3, 4]] == -1.0).all())


def test_ladder_on_gpu_equals_cpu(dev):
    """prepare_first_level and build_octave on the card (K1 only: blur-
    only first level, identity level 0, slots) equal the plain run."""
    from hesaff_tpu_torch import pyramid
    from hesaff_tpu_torch.ops import cuda_blur

    rng = np.random.default_rng(12)
    imgs = (rng.random((2, 90, 124)) * 255).astype(np.float32)
    before = cuda_blur.LAUNCHES
    first, pd = pyramid.prepare_first_level(torch.as_tensor(imgs,
                                                            device=dev), CFG)
    o = pyramid.build_octave(first, pd, CFG)
    torch.cuda.synchronize()
    assert cuda_blur.LAUNCHES == before + 1 + CFG.num_scales + 2
    cfirst, _ = pyramid.prepare_first_level(torch.as_tensor(imgs), CFG)
    co = pyramid.build_octave(cfirst, pd, CFG)
    assert torch.equal(first.cpu(), cfirst)
    assert torch.equal(o.blurs.cpu(), co.blurs)
    assert torch.equal(o.resps.cpu(), co.resps)
    assert torch.equal(o.next_first.cpu(), co.next_first)


@pytest.mark.parametrize("H,W,iters,strided", [
    (200, 240, 5, False), (61, 45, 5, False), (24, 131, 1, False),
    (13, 64, 5, True), (70, 300, 1, True)])
def test_detect_walk_kernel(dev, H, W, iters, strided):
    """K2 over every detection level of an octave in one launch, against
    its plain version: widths off the 32-column tile, heights under one
    64-row tile, walks of 0 and 4 steps, and ladders that are strided
    views (the 16-byte copy path where W % 4 == 0).  The table is
    compared at every pixel, not only where ok is set."""
    import dataclasses

    from hesaff_tpu_torch.ops import cuda_detect

    cfg = dataclasses.replace(CFG, localize_iterations=iters)
    rng = np.random.default_rng(5)
    L = cfg.num_scales + 2
    resps = torch.as_tensor(smooth_stacks(rng, 2, L, H, W) * 40.0,
                            device=dev)
    blurs = torch.as_tensor(smooth_stacks(rng, 2, L, H, W), device=dev)
    if strided:
        wide = torch.zeros((2, L + 2, H, W), device=dev)
        wide[:, 1:L + 1] = resps
        resps = wide[:, 1:L + 1]
    before = cuda_detect.LAUNCHES
    ok, cell, tab, cand = cuda_detect.detect_walk_octave(resps, blurs, cfg)
    pok, pcell, ptab, pcand = cuda_detect.detect_walk_octave_plain(
        resps, blurs, cfg)
    torch.cuda.synchronize()
    assert cuda_detect.LAUNCHES == before + 1
    assert int(pcand.sum()) > 0
    for l in range(cfg.num_scales):
        m = pok[:, l]
        assert torch.equal(ok[:, l], m) and torch.equal(cand[:, l],
                                                        pcand[:, l])
        assert torch.equal(cell[:, l], pcell[:, l])
        np.testing.assert_allclose(tab[:, l].cpu().numpy(),
                                   ptab[:, l].cpu().numpy(), rtol=1e-6,
                                   atol=1e-5)


@pytest.mark.parametrize("H,W", [(200, 240), (61, 45), (24, 2600)])
def test_detect_maps_kernel(dev, H, W):
    """K3 against its plain version; the 2600-wide case shows that no
    width limit of the TPU kernel's VMEM budget carries over."""
    from hesaff_tpu_torch.ops import cuda_detect

    rng = np.random.default_rng(7)
    planes = [torch.as_tensor(smooth_stacks(rng, 2, H, W) * 40.0,
                              device=dev) for _ in range(3)]
    before = cuda_detect.MAPS_LAUNCHES
    maps, nan_flag, edge, mask = cuda_detect.detect_maps(*planes, CFG)
    pmaps, pnan, pedge, pmask = cuda_detect.detect_maps_plain(*planes, CFG)
    torch.cuda.synchronize()
    assert cuda_detect.MAPS_LAUNCHES == before + 1
    assert torch.equal(mask, pmask) and int(pmask.sum()) > 0
    assert torch.equal(nan_flag, pnan) and torch.equal(edge, pedge)
    np.testing.assert_allclose(maps[pmask].cpu().numpy(),
                               pmaps[pmask].cpu().numpy(), rtol=1e-6,
                               atol=1e-5)


def _maps_planes(rng, dev, H, W, strided, special):
    """Three (2, H, W) DoH-like planes; strided: views of one (2, 5, H,
    W) stack, as detect_level reads a ladder; special: about 1% of the
    pixels NaN and 1% each +inf and -inf."""
    stack = smooth_stacks(rng, 2, 5, H, W) * 40.0
    if special:
        u = rng.uniform(size=stack.shape)
        stack[u < 0.01] = np.nan
        stack[(u >= 0.01) & (u < 0.02)] = np.inf
        stack[(u >= 0.02) & (u < 0.03)] = -np.inf
    stack = torch.as_tensor(stack, device=dev)
    if strided:
        return [stack[:, l] for l in (0, 2, 4)]
    return [stack[:, l].contiguous() for l in (0, 2, 4)]


@pytest.mark.parametrize("H,W,strided,special", [
    (13, 61, False, False), (70, 91, True, False), (37, 33, False, True),
    (130, 7, True, True), (200, 243, True, True)])
def test_detect_maps_kernel_edges(dev, H, W, strided, special):
    """K3 at heights under a warp's 16 rows and a block's 64, widths off
    its 30-column strips and off 4, on strided plane views and on planes
    with NaN and +-inf: flags equal, and the maps bit-equal to the plain
    version's everywhere (the solve is operation for operation)."""
    from hesaff_tpu_torch.ops import cuda_detect

    planes = _maps_planes(np.random.default_rng(11), dev, H, W, strided,
                          special)
    before = cuda_detect.MAPS_LAUNCHES
    maps, nan_flag, edge, mask = cuda_detect.detect_maps(*planes, CFG)
    pmaps, pnan, pedge, pmask = cuda_detect.detect_maps_plain(*planes, CFG)
    torch.cuda.synchronize()
    assert cuda_detect.MAPS_LAUNCHES == before + 1
    assert torch.equal(mask, pmask) and torch.equal(nan_flag, pnan)
    assert torch.equal(edge, pedge)
    assert torch.equal(maps, pmaps)
    if special:
        assert bool(pnan.any())


@pytest.mark.parametrize("caps", ["default", "small"])
def test_sparse_octave_on_gpu_matches_cpu(dev, caps):
    """The sparse octave path (K3, the windowed walk, dedup, compaction)
    on the card equals its CPU run on the 200x160 golden's octave 0 and
    its flip, also where the small capacities overflow."""
    import dataclasses

    from hesaff_tpu_torch import detect
    from hesaff_tpu_torch.ops import cuda_detect
    from hesaff_tpu_torch.pyramid import level_sigmas

    cfg = CFG if caps == "default" else dataclasses.replace(
        CFG, candidate_cap_min=16, candidate_cap_max=32, affine_cap_min=16,
        affine_cap_max=40)
    d = np.load(os.path.join(os.path.dirname(__file__), "golden", "data",
                             "synth_200x160.npz"))
    stack = lambda k: np.stack([d[f"oct0_{k}{i}"] for i in range(5)])
    flip = lambda a: np.ascontiguousarray(a[:, ::-1, ::-1])
    resps, blurs = (torch.as_tensor(np.stack([a, flip(a)]).astype(np.float32))
                    for a in (stack("resp"), stack("blur")))
    sig = level_sigmas(cfg)
    before = cuda_detect.MAPS_LAUNCHES
    gpu = detect.detect_octave_sparse(resps.to(dev), blurs.to(dev), sig,
                                      1.0, cfg)
    cpu = detect.detect_octave_sparse(resps, blurs, sig, 1.0, cfg)
    assert cuda_detect.MAPS_LAUNCHES == before + cfg.num_scales
    assert int(cpu["ok"].sum()) > 40
    assert (caps == "small") == bool((cpu["overflow"] > 0).all())
    for k, v in cpu.items():
        if k == "s":     # exp2 may round an ulp apart on the two devices
            np.testing.assert_allclose(gpu[k].cpu().numpy(), v.numpy(),
                                       rtol=1e-6, atol=0)
        else:
            assert torch.equal(gpu[k].cpu(), v), k


@pytest.mark.parametrize("H,W,margin", [(200, 160, 20), (48, 40, 4)])
def test_affine_kernel(dev, H, W, margin):
    from hesaff_tpu_torch.affine_shape import sample_window_size
    from hesaff_tpu_torch.ops import cuda_affine

    rng = np.random.default_rng(0)
    B, L, K = 2, 3, 256
    stacks = torch.as_tensor(smooth_stacks(rng, B, L, H, W), device=dev)
    g = lambda a: torch.as_tensor(a, device=dev)
    args = (stacks, g(rng.integers(0, B, K)), g(rng.integers(0, L, K)),
            g(rng.uniform(margin, W - margin, K).astype(np.float32)),
            g(rng.uniform(margin, H - margin, K).astype(np.float32)),
            g(rng.uniform(1.2, 3.2, K).astype(np.float32)),
            g(rng.uniform(size=K) > 0.2), sample_window_size(CFG, H, W),
            CFG)
    out = cuda_affine.adapt(*args)
    ref = cuda_affine.adapt_plain(*args)
    torch.cuda.synchronize()
    assert_affine_parity(ref, out, args[6], min_matched=4)


def _affine_case(rng, dev, G, K, act_share=0.85, H=96, W=120):
    """adapt's arguments for K keypoints at any position (some grids
    reach outside the image) and ratio 0.8-3.5 on a window 24 px under
    the image's width, so that some grids leave it inside the image."""
    import dataclasses

    cfg = dataclasses.replace(CFG, smm_window_size=G)
    B, L = 2, 3
    g = lambda a: torch.as_tensor(a, device=dev)
    return [g(smooth_stacks(rng, B, L, H, W)), g(rng.integers(0, B, K)),
            g(rng.integers(0, L, K)),
            g(rng.uniform(-2, W + 2, K).astype(np.float32)),
            g(rng.uniform(-2, H + 2, K).astype(np.float32)),
            g(rng.uniform(0.8, 3.5, K).astype(np.float32)),
            g(rng.uniform(size=K) < act_share), min(H, W) - 24, cfg]


@pytest.mark.parametrize("G", [19, 15])
def test_affine_kernel_paths(dev, G):
    """K4's instance for the configuration's 19 x 19 grid and its generic
    instance (G = 15) against the plain loop, on keypoints that converge,
    diverge, run all 16 steps, sample outside the image, and sample
    inside it but outside the window; 301 slots, a multiple of neither
    the block's 4 warps nor a warp's 32 lanes."""
    from hesaff_tpu_torch.ops import cuda_affine

    args = _affine_case(np.random.default_rng(5), dev, G, 301)
    cfg, act, ratio = args[-1], args[6], args[5]
    before = cuda_affine.LAUNCHES
    out = cuda_affine.adapt(*args)
    ref, steps = cuda_affine.adapt_plain(*args, return_steps=True)
    # the whole image as the window: only the window test differs
    whole = cuda_affine.adapt_plain(*args[:7], 96, cfg)
    torch.cuda.synchronize()
    assert cuda_affine.LAUNCHES == before + 1
    reach = (G // 2) * ratio
    outside = act & ((args[3] < reach) | (args[4] < reach)
                     | (args[3] + reach > 119) | (args[4] + reach > 95))
    assert bool((steps == cfg.max_iterations).any())
    assert bool((act & ~whole.ok & (steps < cfg.max_iterations)).any())
    assert bool((whole.ok & ~ref.ok).any()) and bool(outside.any())
    assert_affine_parity(ref, out, act, min_matched=40)
    assert not bool(out.ok[~act].any()) and bool((out.iters[~act] == 0).all())
    eye = torch.tensor([1.0, 0.0, 0.0, 1.0], device=dev)
    u = torch.stack([out.u11, out.u12, out.u21, out.u22], dim=1)
    assert bool((u[~act] == eye).all())


@pytest.mark.parametrize("K,act_share", [(0, 1.0), (64, 0.0), (1, 1.0),
                                         (7, 1.0), (133, 0.5)])
def test_affine_kernel_slot_counts(dev, K, act_share):
    """K4 over no slots, over slots all inactive (each written as ok 0,
    U = I, iters 0), and over slot counts off the block and warp sizes,
    against the plain loop."""
    from hesaff_tpu_torch.ops import cuda_affine

    args = _affine_case(np.random.default_rng(K), dev, 19, K, act_share)
    out = cuda_affine.adapt(*args)
    ref = cuda_affine.adapt_plain(*args)
    torch.cuda.synchronize()
    for f in AFFINE_FIELDS:
        assert getattr(out, f).shape == (K,)
    if not bool(args[6].any()):
        for f in AFFINE_FIELDS:
            assert torch.equal(getattr(out, f), getattr(ref, f)), f
    assert_affine_parity(ref, out, args[6], min_matched=0)


def test_extract_on_gpu_matches_cpu(dev):
    from hesaff_tpu_torch import extract

    d = np.load(os.path.join(os.path.dirname(__file__), "golden", "data",
                             "synth_200x160.npz"))
    gpu = extract(d["gray"], CFG, device=dev)
    cpu = extract(d["gray"], CFG, device="cpu")
    assert abs(gpu.n - cpu.n) <= 1 and gpu.n > 40
    for i in range(cpu.n):
        dd = np.hypot(gpu.x - cpu.x[i], gpu.y - cpu.y[i])
        j = int(dd.argmin())
        assert dd[j] < 0.01
        assert np.abs(gpu.desc[j].astype(int)
                      - cpu.desc[i].astype(int)).max() <= 2


def _keypoints(rng, dev, K, B, H, W, smin, smax, margin=10.0):
    g = lambda a: torch.as_tensor(a, device=dev)
    d = np.exp(rng.normal(0, 0.25, K)).astype(np.float32)
    return dict(
        img_idx=g(rng.integers(0, B, K).astype(np.int32)),
        x=g(rng.uniform(margin, W - margin, K).astype(np.float32)),
        y=g(rng.uniform(margin, H - margin, K).astype(np.float32)),
        s=g(rng.uniform(smin, smax, K).astype(np.float32)),
        a11=g(d), a21=g(rng.normal(0, 0.4, K).astype(np.float32)),
        a22=g((1.0 / d).astype(np.float32)),
        active=g(rng.uniform(size=K) > 0.2))


def _kernel_vs_plain(args):
    from hesaff_tpu_torch.ops import cuda_patches

    before = cuda_patches.LAUNCHES
    pk, bad = cuda_patches.patches_group(*args)
    pp, pbad = cuda_patches.patches_group_plain(*args)
    torch.cuda.synchronize()
    assert cuda_patches.LAUNCHES == before + 1
    assert torch.equal(bad, pbad)
    good = ~pbad
    assert int(good.sum()) >= 8
    assert float((pk - pp)[good].abs().max()) <= 1e-3
    assert bool((pk[~args[-2]] == 0).all())


@pytest.mark.parametrize("bucket,smin,smax,K", [
    (49, 1.6, 4.2, 96), (49, 0.9, 4.42, 384), (97, 4.5, 8.8, 96),
    (97, 2.2, 9.0, 256), (193, 9.5, 18.0, 96), (385, 19.0, 36.0, 96)])
def test_patches_group_kernel(dev, bucket, smin, smax, K):
    """K5 against its plain version in each serving-path bucket; the
    384-keypoint group-49 and 256-keypoint group-97 cases span their
    bucket from under a third of it to the bucket's own workspace (the
    geometries that hold the whole workspace in shared memory), with
    active and inactive slots and blur widths below KMAX."""
    from hesaff_tpu_torch.ops import cuda_patches

    rng = np.random.default_rng(bucket + K)
    B, H, W = 2, 640, 800
    images = torch.as_tensor(smooth_stacks(rng, B, H, W), device=dev)
    kp = _keypoints(rng, dev, K, B, H, W, smin, smax)
    args, _ = cuda_patches.group_args(
        images, bucket, *(kp[k] for k in ("img_idx", "x", "y", "s", "a11",
                                          "a21", "a22")), CFG, kp["active"])
    if K > 96:
        ws, taps = args[7], args[9]
        assert int(ws.min()) < bucket // 3 and int(ws.max()) == bucket
        assert int((taps != 0).sum(1).min()) < taps.shape[1]
    _kernel_vs_plain(args)


@pytest.mark.parametrize("prev,bsize", [(385, 641), (641, 1025)])
def test_patches_group_kernel_scaled(dev, prev, bsize):
    """The pyramid tail: bucket_src 323 (ps 2) and 259 (ps 4) on the
    first level of the octave that tail_source_plan picks, keypoints
    near the centre of a 1280x1600 image so that their patches fit."""
    from hesaff_tpu_torch import dist, pyramid
    from hesaff_tpu_torch.ops import cuda_patches

    ps, octave, bucket_src = dist.tail_source_plan(bsize, 1.0)
    rng = np.random.default_rng(bsize)
    B, H, W = 1, 1280, 1600
    images = torch.as_tensor(smooth_stacks(rng, B, H, W), device=dev)
    src = pyramid.scaled_first_level(images, CFG, octave).contiguous()
    kp = _keypoints(rng, dev, 48, B, H, W, (prev - 1) / (2 * CFG.mr_size),
                    (bsize - 3) / (2 * CFG.mr_size), margin=0.0)
    kp["x"] = W / 2 + (kp["x"] / W - 0.5) * 160.0
    kp["y"] = H / 2 + (kp["y"] / H - 0.5) * 160.0
    kp["a21"] = 0.25 * kp["a21"]                  # mild shapes: the patch
    kp["a11"] = 1.0 + 0.25 * (kp["a11"] - 1.0)    # of a 1025 workspace
    kp["a22"] = 1.0 / kp["a11"]                   # must fit the image
    names = ("img_idx", "x", "y", "s", "a11", "a21", "a22")
    before = cuda_patches.LAUNCHES
    pk, ok = cuda_patches.extract_group_scaled(
        src, ps, bucket_src, *(kp[k] for k in names), CFG, kp["active"],
        orig_hw=(H, W))
    pp, pok = cuda_patches.extract_group_scaled(
        src.cpu(), ps, bucket_src, *(kp[k].cpu() for k in names), CFG,
        kp["active"].cpu(), orig_hw=(H, W))
    assert cuda_patches.LAUNCHES == before + 1
    assert torch.equal(ok.cpu(), pok)
    assert int(pok.sum()) >= 8
    assert float((pk.cpu() - pp)[pok].abs().max()) <= 1e-3


def test_sift_kernel(dev):
    from hesaff_tpu_torch import sift
    from hesaff_tpu_torch.ops import cuda_sift

    rng = np.random.default_rng(5)
    p = np.clip(smooth_stacks(rng, 300, 41, 41), 0, 255).astype(np.float32)
    pt = torch.as_tensor(p, device=dev)
    before = cuda_sift.LAUNCHES
    out = cuda_sift.sift_descriptors(pt, CFG)
    ref = sift.sift_descriptors(pt, CFG)
    torch.cuda.synchronize()
    assert cuda_sift.LAUNCHES == before + 1
    diff = (out - ref).abs()
    assert float(diff.max()) <= 1
    assert float((diff == 0).float().mean()) >= 0.99


@pytest.mark.parametrize("K", [0, 1, 7, 301])
def test_sift_kernel_counts(dev, K):
    """K6 on no patch, one, and counts that are not a multiple of the
    patches a block: within one step and >= 99% exact."""
    from hesaff_tpu_torch import sift
    from hesaff_tpu_torch.ops import cuda_sift

    rng = np.random.default_rng(K)
    p = np.clip(smooth_stacks(rng, K + 1, 41, 41)[:K], 0, 255)
    pt = torch.as_tensor(p.astype(np.float32), device=dev)
    out = cuda_sift.sift_descriptors(pt, CFG)
    ref = sift.sift_descriptors(pt, CFG)
    torch.cuda.synchronize()
    assert tuple(out.shape) == (K, 128) and out.dtype == torch.float32
    if K:
        diff = (out - ref).abs()
        assert float(diff.max()) <= 1
        assert float((diff == 0).float().mean()) >= 0.99


@pytest.mark.parametrize("mask", ["none", "all", "random"])
def test_describe_masked_kernel(dev, mask):
    """K6's masked uint8 entry: zero rows where valid is false; valid
    rows equal to the kernel's float entry and within one step (>= 99%
    exact) of the plain version."""
    from hesaff_tpu_torch import sift
    from hesaff_tpu_torch.ops import cuda_sift

    rng = np.random.default_rng(13)
    K = 203
    p = np.clip(smooth_stacks(rng, K, 41, 41), 0, 255).astype(np.float32)
    pt = torch.as_tensor(p, device=dev)
    v = {"none": np.zeros(K, bool), "all": np.ones(K, bool),
         "random": rng.random(K) < 0.5}[mask]
    valid = torch.as_tensor(v, device=dev)
    before = cuda_sift.LAUNCHES
    out = cuda_sift.describe_masked(pt, valid, CFG)
    torch.cuda.synchronize()
    assert cuda_sift.LAUNCHES == before + 1
    assert out.dtype == torch.uint8 and tuple(out.shape) == (K, 128)
    assert not bool(out[~valid].any())
    if v.any():
        full = cuda_sift.sift_descriptors(pt[valid], CFG)
        assert torch.equal(out[valid], full.to(torch.uint8))
        ref = sift.sift_descriptors(pt[valid], CFG)
        diff = (out[valid].float() - ref).abs()
        assert float(diff.max()) <= 1
        assert float((diff == 0).float().mean()) >= 0.99


def test_grouped_on_gpu_matches_cpu(dev):
    import sys

    from hesaff_tpu_torch import dist
    from hesaff_tpu_torch.ops import cuda_patches, cuda_sift

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "golden"))
    import gen_images

    B, H, W = 2, 240, 320
    imgs = np.stack([
        gen_images.synth_image(W, H, seed=s).astype(np.float32).mean(-1)
        for s in range(B)])
    groups = dist.default_group_spec(H, W, CFG, per_image_cap=512, batch=B)
    before = (cuda_patches.LAUNCHES, cuda_sift.LAUNCHES)
    gpu = dist.extraction_step_grouped(imgs, CFG, groups, device=dev)
    cpu = dist.extraction_step_grouped(imgs, CFG, groups, device="cpu")
    assert cuda_patches.LAUNCHES > before[0]
    assert cuda_sift.LAUNCHES == before[1] + 1
    gv, cv = gpu.valid.cpu(), cpu.valid
    assert abs(int(gv.sum()) - int(cv.sum())) <= 1 and int(cv.sum()) > 50
    assert int(gpu.overflow) == int(cpu.overflow) == 0
    gx, gy = gpu.x.cpu()[gv].numpy(), gpu.y.cpu()[gv].numpy()
    gd = gpu.desc.cpu()[gv].numpy().astype(int)
    cd = cpu.desc[cv].numpy().astype(int)
    for i, (x, y) in enumerate(zip(cpu.x[cv].numpy(), cpu.y[cv].numpy())):
        j = int(np.argmin(np.hypot(gx - x, gy - y)))
        assert np.hypot(gx[j] - x, gy[j] - y) < 0.01
        assert np.abs(gd[j] - cd[i]).max() <= 2


@pytest.mark.parametrize("entry", ["extract", "grouped"])
def test_upscale_direct_branch_on_gpu_matches_cpu(dev, entry):
    """Under upscale_input small keypoints take the direct warp beside
    the patch kernel (extract_batch's mixed bucket, the grouped path's
    direct branch)."""
    import dataclasses

    from hesaff_tpu_torch import dist, extract

    d = np.load(os.path.join(os.path.dirname(__file__), "golden", "data",
                             "synth_200x160.npz"))
    img = d["gray"]
    cfg = dataclasses.replace(CFG, upscale_input=True)

    def run(device):
        if entry == "extract":
            f = extract(img, cfg, device=device)
            return f.x, f.y, f.s, f.desc
        groups = dist.default_group_spec(*img.shape, cfg, per_image_cap=512)
        o = dist.extraction_step_grouped(img[None], cfg, groups,
                                         device=device)
        v = o.valid.cpu()
        assert int(o.overflow) == 0
        return tuple(getattr(o, k).cpu()[v].numpy()
                     for k in ("x", "y", "s", "desc"))

    gx, gy, gs, gd = run(dev)
    cx, cy, cs, cd = run("cpu")
    S = 2 * np.ceil(cs * cfg.mr_size) + 1
    assert (S / cfg.patch_size <= cfg.oversample_cutoff).any()
    assert abs(len(gx) - len(cx)) <= 1 and len(cx) > 10
    for i in range(len(cx)):
        dd = np.hypot(gx - cx[i], gy - cy[i])
        j = int(dd.argmin())
        assert dd[j] < 0.01
        assert np.abs(gd[j].astype(int) - cd[i].astype(int)).max() <= 2


def homography_scene(n=200, outlier_frac=0.3, seed=0):
    """tests/test_ransac.py's make_homography_data, without its JAX
    import (tests/test_torch_ransac.py holds the two equal)."""
    rng = np.random.RandomState(seed)
    H = np.array([[1.1, 0.1, 5.0], [-0.05, 0.95, -3.0], [1e-4, -2e-4, 1.0]])
    p1 = rng.rand(n, 2) * 500
    ph = np.concatenate([p1, np.ones((n, 1))], axis=1) @ H.T
    p2 = ph[:, :2] / ph[:, 2:3]
    p2 += rng.randn(n, 2) * 0.3
    n_out = int(n * outlier_frac)
    p2[:n_out] = rng.rand(n_out, 2) * 500
    return p1, p2, H, n_out


def two_view_scene(n=300, outlier_frac=0.2, seed=1):
    """tests/test_ransac.py's make_two_view_data, without its JAX
    import (tests/test_torch_ransac.py holds the two equal)."""
    rng = np.random.RandomState(seed)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    angle = 0.15
    R = np.array([[np.cos(angle), 0, np.sin(angle)], [0, 1, 0],
                  [-np.sin(angle), 0, np.cos(angle)]])
    t = np.array([0.5, 0.05, 0.1])
    X = rng.rand(n, 3) * [4, 3, 4] + [-2, -1.5, 4]
    x1 = (X / X[:, 2:3]) @ K.T
    X2 = X @ R.T + t
    x2 = (X2 / X2[:, 2:3]) @ K.T
    p1 = x1[:, :2] + rng.randn(n, 2) * 0.3
    p2 = x2[:, :2] + rng.randn(n, 2) * 0.3
    n_out = int(n * outlier_frac)
    p2[:n_out] = rng.rand(n_out, 2) * [640, 480]
    return p1, p2, K, R, t, n_out


@pytest.mark.parametrize("nq,m,block", [(3000, 7000, 4096), (500, 1, 4096),
                                        (257, 1000, 256)])
def test_knn2_on_gpu_equals_cpu(dev, nq, m, block):
    """uint8-valued descriptors with duplicate rows: idx, dist and dist2
    bit-equal to the CPU run (every term an integer below 2^24; with
    M == 1 dist2 is a padding row's distance, not exact: rtol 1e-6)."""
    from hesaff_tpu_torch import match

    rng = np.random.default_rng(m)
    db = rng.integers(0, 256, (m, 128)).astype(np.uint8)
    db[rng.integers(0, m, m // 10)] = db[rng.integers(0, m, m // 10)]
    q = rng.integers(0, 256, (nq, 128)).astype(np.uint8)
    q[: nq // 3] = db[rng.integers(0, m, nq // 3)]
    g = match.knn2(q, db, block=block, device=dev)
    c = match.knn2(q, db, block=block, device="cpu")
    assert g.idx.device.type == "cuda"
    assert torch.equal(g.idx.cpu(), c.idx)
    assert torch.equal(g.dist.cpu(), c.dist)
    if m == 1:
        np.testing.assert_allclose(g.dist2.cpu().numpy(), c.dist2.numpy(),
                                   rtol=1e-6)
    else:
        assert torch.equal(g.dist2.cpu(), c.dist2)
    pairs = match.match_descriptors(q, db, device=dev)
    for a, b in zip(pairs, match.match_descriptors(q, db, device="cpu")):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ransac_homography_on_gpu(dev, seed):
    """tests/test_ransac.py's outcome thresholds, on the card; numpy
    input with no device runs there too."""
    from hesaff_tpu_torch import ransac

    p1, p2, H, n_out = homography_scene()
    res = ransac.ransac_homography(p1, p2, threshold=9.0,
                                   num_hypotheses=512, seed=seed)
    assert res.model.device.type == "cuda"
    inl = res.inliers.cpu().numpy()
    assert inl[n_out:].mean() > 0.97
    assert inl[:n_out].mean() < 0.05
    Hm = res.model.cpu().numpy().astype(np.float64)
    np.testing.assert_allclose(Hm / Hm[2, 2], H / H[2, 2], rtol=0.05,
                               atol=0.05)
    cpu = ransac.ransac_homography(p1, p2, threshold=9.0,
                                   num_hypotheses=512, seed=seed,
                                   device="cpu")
    assert abs(int(res.num_inliers) - int(cpu.num_inliers)) <= 0.01 * len(p1)


def test_ransac_fundamental_and_pose_on_gpu(dev):
    """F, E and the cheirality pose (batched least squares through the
    `gels` driver) on the card, to tests/test_ransac.py's thresholds."""
    from hesaff_tpu_torch import ransac

    p1, p2, K, R, t, n_out = two_view_scene()
    res = ransac.ransac_fundamental(p1, p2, threshold=3.0, device=dev)
    inl = res.inliers.cpu().numpy()
    assert inl[n_out:].mean() > 0.95
    assert inl[:n_out].mean() < 0.1
    E = ransac.essential_from_fundamental(res.model, K, K)
    Kinv = np.linalg.inv(K)
    sel = np.nonzero(inl)[0]
    h1 = np.concatenate([p1[sel], np.ones((len(sel), 1))], 1) @ Kinv.T
    h2 = np.concatenate([p2[sel], np.ones((len(sel), 1))], 1) @ Kinv.T
    Rm, tm = ransac.decompose_essential(E, h1[:, :2], h2[:, :2])
    assert Rm.device.type == "cuda"
    Rm, tm = (Rm.cpu().numpy().astype(np.float64),
              tm.cpu().numpy().astype(np.float64))
    ang = np.degrees(np.arccos(np.clip((np.trace(Rm.T @ R) - 1) / 2, -1, 1)))
    assert ang < 1.0
    assert abs(tm @ t / (np.linalg.norm(tm) * np.linalg.norm(t))) > 0.98


def test_write_sift_file_from_gpu_tensors(dev, tmp_path):
    """CUDA tensors and their numpy copies write the same bytes."""
    from hesaff_tpu_torch import sift_io

    rng = np.random.default_rng(0)
    k = 300
    geo = [rng.uniform(0, 800, k), rng.uniform(0, 600, k),
           rng.uniform(1, 30, k), rng.uniform(0.5, 2, k),
           rng.uniform(-0.5, 0.5, k), rng.uniform(-0.5, 0.5, k),
           rng.uniform(0.5, 2, k)]
    geo = [a.astype(np.float32) for a in geo]
    desc = rng.integers(0, 256, (k, 128)).astype(np.uint8)
    a, b = str(tmp_path / "gpu.sift"), str(tmp_path / "host.sift")
    sift_io.write_sift_file(a, *[torch.as_tensor(g, device=dev) for g in geo],
                            torch.as_tensor(desc, device=dev), 5.196)
    sift_io.write_sift_file(b, *geo, desc, 5.196)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("H,W,vhw", [
    (200, 240, ((200, 240), (150, 201))), (61, 45, ((40, 45), (61, 9))),
    (24, 131, ((24, 100), (3, 131)))])
def test_detect_walk_kernel_limits(dev, H, W, vhw):
    """K2 with per-image start-pixel limits against its plain version:
    ok, cand and cells equal at every level, the table at every pixel
    as without limits, and nothing at or past a limit's border."""
    from hesaff_tpu_torch.ops import cuda_detect

    rng = np.random.default_rng(5)
    L = CFG.num_scales + 2
    resps = torch.as_tensor(smooth_stacks(rng, 2, L, H, W) * 40.0,
                            device=dev)
    blurs = torch.as_tensor(smooth_stacks(rng, 2, L, H, W), device=dev)
    lim = torch.as_tensor(vhw, dtype=torch.int32, device=dev)
    before = cuda_detect.LAUNCHES
    ok, cell, tab, cand = cuda_detect.detect_walk_octave(resps, blurs, CFG,
                                                         lim)
    pok, pcell, ptab, pcand = cuda_detect.detect_walk_octave_plain(
        resps, blurs, CFG, lim)
    torch.cuda.synchronize()
    assert cuda_detect.LAUNCHES == before + 1
    assert int(pcand.sum()) > 0
    assert torch.equal(ok, pok) and torch.equal(cand, pcand)
    assert torch.equal(cell, pcell)
    np.testing.assert_allclose(tab.cpu().numpy(), ptab.cpu().numpy(),
                               rtol=1e-6, atol=1e-5)
    full = cuda_detect.detect_walk_octave(resps, blurs, CFG)
    assert torch.equal(tab, full[2])
    for b, (h, w) in enumerate(vhw):
        assert not bool(cand[b, :, max(h - CFG.border, 0):].any())
        assert not bool(cand[b, :, :, max(w - CFG.border, 0):].any())
        assert torch.equal(cand[b], full[3][b] & pcand[b])


@pytest.mark.parametrize("H,W,vhw", [
    (130, 91, ((130, 91), (97, 50))), (37, 33, ((20, 33), (37, 12)))])
def test_detect_maps_kernel_limits(dev, H, W, vhw):
    """K3 with per-plane limits on strided planes: mask equal to the
    plain version's, maps and the other flags bit-equal to the
    unlimited call's."""
    from hesaff_tpu_torch.ops import cuda_detect

    planes = _maps_planes(np.random.default_rng(3), dev, H, W, True, False)
    lim = torch.as_tensor(vhw, dtype=torch.int32, device=dev)
    before = cuda_detect.MAPS_LAUNCHES
    maps, nan_flag, edge, mask = cuda_detect.detect_maps(*planes, CFG, lim)
    pmask = cuda_detect.detect_maps_plain(*planes, CFG, lim)[3]
    full = cuda_detect.detect_maps(*planes, CFG)
    torch.cuda.synchronize()
    assert cuda_detect.MAPS_LAUNCHES == before + 2
    assert torch.equal(mask, pmask) and int(pmask.sum()) > 0
    assert int(pmask.sum()) < int(full[3].sum())
    assert torch.equal(maps, full[0]) and torch.equal(nan_flag, full[1])
    assert torch.equal(edge, full[2])


def test_padded_grouped_on_gpu_matches_cpu(dev):
    """The grouped path in padded mode on the card against its CPU run:
    the same keypoints, descriptors within 2 steps."""
    import sys

    from hesaff_tpu_torch import dist
    from hesaff_tpu_torch.utils.fleet import pad_to_bucket

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "golden"))
    import gen_images

    imgs = [gen_images.synth_image(W, H, seed=s).astype(np.float32).mean(-1)
            for s, (H, W) in enumerate(((150, 170), (140, 180)))]
    padded, hw = zip(*[pad_to_bucket(im) for im in imgs])
    padded, hw = np.stack(padded), np.asarray(hw, np.int32)
    groups = dist.default_group_spec(*padded.shape[1:], CFG,
                                     per_image_cap=512, batch=2)
    gpu = dist.extraction_step_grouped(padded, CFG, groups, valid_hw=hw,
                                       device=dev)
    cpu = dist.extraction_step_grouped(padded, CFG, groups, valid_hw=hw,
                                       device="cpu")
    gv, cv = gpu.valid.cpu(), cpu.valid
    assert abs(int(gv.sum()) - int(cv.sum())) <= 1 and int(cv.sum()) > 50
    assert int(gpu.overflow) == int(cpu.overflow) == 0
    gi, ci = gpu.img_idx.cpu()[gv].numpy(), cpu.img_idx[cv].numpy()
    gx, gy = gpu.x.cpu()[gv].numpy(), gpu.y.cpu()[gv].numpy()
    gd = gpu.desc.cpu()[gv].numpy().astype(int)
    cd = cpu.desc[cv].numpy().astype(int)
    for i, (x, y) in enumerate(zip(cpu.x[cv].numpy(), cpu.y[cv].numpy())):
        d = np.hypot(gx - x, gy - y) + 1e9 * (gi != ci[i])
        j = int(np.argmin(d))
        assert d[j] < 0.01
        assert np.abs(gd[j] - cd[i]).max() <= 2


def test_ba_step_bit_equal_across_runs(dev):
    """A dense and a track-form LM step on the card give the same bits
    twice (deterministic segment sums, no atomics), agree with the CPU
    step, and ba_solve converges on the card as on the CPU."""
    from hesaff_tpu_torch.geom import ba

    p = ba_problem(dev)
    a = ba._lm_step(p, 0.1)
    b = ba._lm_step(p, 0.1)
    tr = ba.problem_to_tracks(p)[0]
    c = ba._tracks_lm_step(tr, 0.1, True)
    d = ba._tracks_lm_step(tr, 0.1, True)
    for x, y in ((a, b), (c, d)):
        for k in ("cam_rvec", "cam_tvec", "points"):
            assert torch.equal(getattr(x[0], k), getattr(y[0], k)), k
        assert torch.equal(x[1], y[1])
    q = ba_problem("cpu")
    ref = ba._lm_step(q, 0.1)[0]
    for k in ("cam_rvec", "cam_tvec", "points"):
        np.testing.assert_allclose(getattr(a[0], k).cpu().numpy(),
                                   getattr(ref, k).numpy(), rtol=1e-4,
                                   atol=1e-5)
    _, err_g = ba.ba_solve(p, iterations=12)
    _, err_c = ba.ba_solve(q, iterations=12)
    assert err_g < 0.45 and abs(err_g - err_c) < 0.02


def test_incremental_sfm_on_gpu(dev):
    """test_sfm.py's scene (rebuilt without JAX) on the card: every
    frame registered, ATE < 0.15 and rmse < 2e-3, as on the CPU."""
    from hesaff_tpu_torch import sfm

    tracks, K, rv_gt, tv_gt = sfm_scene()
    rec = sfm.incremental_sfm(tracks, K, ba_every=3, device=dev)
    assert len(rec.cam_rvec) == len(rv_gt)
    ate = sfm.absolute_trajectory_error(rec.cam_rvec, rec.cam_tvec,
                                        rv_gt, tv_gt)
    assert ate < 0.15 and rec.rmse < 2e-3


def _bench_like(B, H, W):
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "golden"))
    import gen_images

    return np.stack([
        gen_images.synth_image(W, H, seed=s).astype(np.float32).mean(-1)
        for s in range(B)])


def test_bucket_step_on_gpu_matches_cpu(dev):
    """extraction_step_staged on the card (K5 on every bucket at full
    resolution, 385 and 513 included) against its CPU run: the same
    keypoints within 0.01 px, descriptors within 2 steps, equal
    overflow."""
    from hesaff_tpu_torch import dist
    from hesaff_tpu_torch.ops import cuda_patches

    imgs = _bench_like(2, 480, 640)
    buckets = dist.default_bucket_spec(480, 640, CFG, per_image_cap=1024,
                                       batch=2)
    assert max(b for b, _ in buckets) >= 513
    before = cuda_patches.LAUNCHES
    gpu = dist.extraction_step_staged(imgs, CFG, buckets, device=dev)
    cpu = dist.extraction_step_staged(imgs, CFG, buckets, device="cpu")
    assert cuda_patches.LAUNCHES - before == len(buckets)
    gv, cv = gpu.valid.cpu(), cpu.valid
    assert abs(int(gv.sum()) - int(cv.sum())) <= 1 and int(cv.sum()) > 50
    assert int(gpu.overflow) == int(cpu.overflow)
    gi, ci = gpu.img_idx.cpu()[gv].numpy(), cpu.img_idx[cv].numpy()
    gx, gy = gpu.x.cpu()[gv].numpy(), gpu.y.cpu()[gv].numpy()
    gd = gpu.desc.cpu()[gv].numpy().astype(int)
    cd = cpu.desc[cv].numpy().astype(int)
    for i, (x, y) in enumerate(zip(cpu.x[cv].numpy(), cpu.y[cv].numpy())):
        d = np.hypot(gx - x, gy - y) + 1e9 * (gi != ci[i])
        j = int(np.argmin(d))
        assert d[j] < 0.01
        assert np.abs(gd[j] - cd[i]).max() <= 2


def test_pipeline_on_one_gpu_matches_staged(dev):
    """PipelinedExtractor with both stages on cuda:0 (a stream each)
    equal to the staged step of each microbatch: valid equal, fields
    within 1e-5, descriptors and overflow equal."""
    from hesaff_tpu_torch import dist

    imgs = _bench_like(4, 240, 320)
    buckets = dist.default_bucket_spec(240, 320, CFG, per_image_cap=512,
                                       batch=2)
    pipe = dist.PipelinedExtractor(CFG, buckets, devices=[dev, dev])
    batches = [imgs[:2], imgs[2:]]
    outs = list(pipe(batches))
    assert len(outs) == 2
    for mb, out in zip(batches, outs):
        ref = dist.extraction_step_staged(mb, CFG, buckets, device=dev)
        assert torch.equal(out.valid, ref.valid)
        v = ref.valid
        for f in ("x", "y", "s", "a11", "a21", "a22", "response"):
            assert float((getattr(out, f)[v] - getattr(ref, f)[v])
                         .abs().max()) <= 1e-5
        assert torch.equal(out.desc[v], ref.desc[v])
        assert int(out.overflow) == int(ref.overflow)


@pytest.fixture
def nccl_group(dev):
    """A one-rank NCCL process group in this process (TCP store on
    localhost)."""
    import socket

    from hesaff_tpu_torch import dist

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_multihost(f"localhost:{port}", 1, 0)
    try:
        yield dist.make_mesh()
    finally:
        torch.distributed.destroy_process_group()


def test_one_rank_nccl_matches_single_device(dev, nccl_group):
    """Over a one-rank NCCL group ring_knn2 is bit-equal to knn2 on uint8
    descriptors and ba_solve_sharded to its mesh=None form; host_barrier
    passes on the group's gloo side group."""
    from hesaff_tpu_torch.geom import ba
    from hesaff_tpu_torch.match import knn2, ring_knn2
    from hesaff_tpu_torch.utils.fleet import barrier_group, host_barrier

    assert torch.distributed.get_backend(nccl_group) == "nccl"
    assert torch.distributed.get_backend(barrier_group()) == "gloo"
    host_barrier("nccl", timeout_s=10.0)
    rng = np.random.default_rng(3)
    q = torch.as_tensor(rng.integers(0, 256, (3000, 128)), device=dev)
    db = torch.as_tensor(rng.integers(0, 256, (7000, 128)), device=dev)
    db[4500] = db[17]
    ring, dense = ring_knn2(q, db, nccl_group), knn2(q, db)
    for a, b in zip(ring, dense):
        assert torch.equal(a, b)
    p = ba_problem(dev)
    s1, e1 = ba.ba_solve_sharded(p, mesh=nccl_group, iterations=6)
    s0, e0 = ba.ba_solve_sharded(p, iterations=6)
    assert e1 == e0
    for k in ("cam_rvec", "cam_tvec", "points"):
        assert torch.equal(getattr(s1, k), getattr(s0, k)), k
