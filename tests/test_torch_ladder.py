"""The ladder's blur + DoH entries (ops/cuda_blur) and build_octave's
stacks, on CPU tensors (the kernel's plain version).

The identity tap and the blur-only entry are exact by construction, so
they are held with torch.equal; build_octave is held tensor for tensor
to the composition it replaced (per-level calls, a stack of the levels
and the plain DoH of level 0), and to JAX's build_octave at the
Pallas-vs-XLA tolerances of test_pallas.py (blur atol 1e-4, resp atol
0.05).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hesaff_tpu import pyramid as jpyr
from hesaff_tpu.config import HesaffConfig
from hesaff_tpu_torch import pyramid
from hesaff_tpu_torch.ops import cuda_blur
from hesaff_tpu_torch.ops.blur import gaussian_taps, separable_blur
from hesaff_tpu_torch.ops.hessian import hessian_response, norm2_of
from hesaff_tpu_torch.ops.resample import half_image
from _torch_parity import n, port_cfg, smooth_stacks, t

CFG = HesaffConfig()
PCFG = port_cfg(CFG)


@pytest.mark.parametrize("shape", [(37, 29), (2, 17, 16)])
def test_identity_tap_is_copy_and_doh(shape):
    x = t(smooth_stacks(np.random.default_rng(1), *shape))
    b, r = cuda_blur.blur_doh_plain(x, [1.0], norm2_of(2.56))
    assert torch.equal(b, x)
    assert torch.equal(r, hessian_response(x, 2.56))


@pytest.mark.parametrize("k", [1, 3, 11, 31])
def test_blur_only_equals_separable_blur(k):
    x = t(smooth_stacks(np.random.default_rng(2), 3, 40, 33))
    taps = gaussian_taps((k - 1) / 6.0 if k > 1 else 0.3, k)
    before = cuda_blur.LAUNCHES
    assert torch.equal(cuda_blur.blur(x, taps), separable_blur(x, taps))
    assert torch.equal(cuda_blur.blur(x[:, 2:], taps),
                       separable_blur(x[:, 2:], taps))
    assert cuda_blur.LAUNCHES == before


def test_blur_doh_into_stack_slots():
    """A level read from one slot of a (B, L, H, W) stack and written
    into the next, as build_octave calls it, equals the fresh result."""
    rng = np.random.default_rng(3)
    blurs = t(smooth_stacks(rng, 2, 5, 31, 26))
    resps = torch.zeros_like(blurs)
    taps = gaussian_taps(1.5)
    ref_b, ref_r = cuda_blur.blur_doh(blurs[:, 1].contiguous(), taps, 3.0)
    b, r = cuda_blur.blur_doh(blurs[:, 1], taps, 3.0, out=blurs[:, 2],
                              resp_out=resps[:, 2])
    assert b.data_ptr() == blurs[:, 2].data_ptr()
    assert torch.equal(blurs[:, 2], ref_b) and torch.equal(resps[:, 2], ref_r)
    with pytest.raises(ValueError):
        cuda_blur.blur_doh(blurs[:, 1], taps, 3.0, out=blurs[:, 2])


def _old_build_octave(first, pd, cfg):
    """The composition build_octave replaced: a list of per-level
    blur_doh calls, the plain DoH of level 0, and torch.stack."""
    sig = pyramid.level_sigmas(cfg)
    blurs = [first]
    resps = [hessian_response(first, sig[0] ** 2)]
    for i, taps in enumerate(pyramid.ladder_taps(cfg)):
        b, r = cuda_blur.blur_doh_plain(blurs[-1], taps,
                                        norm2_of(sig[i + 1] ** 2))
        blurs.append(b)
        resps.append(r)
    return (torch.stack(blurs, dim=-3), torch.stack(resps, dim=-3),
            half_image(blurs[cfg.num_scales]))


@pytest.mark.parametrize("shape", [(48, 40), (2, 33, 51)])
def test_build_octave_equals_old_composition(shape):
    first = t(smooth_stacks(np.random.default_rng(4), *shape))
    o = pyramid.build_octave(first, 1.0, PCFG)
    ob, orr, onext = _old_build_octave(first, 1.0, PCFG)
    L = PCFG.num_scales + 2
    assert o.blurs.shape == o.resps.shape == shape[:-2] + (L,) + shape[-2:]
    assert o.blurs.is_contiguous() and o.resps.is_contiguous()
    assert torch.equal(o.blurs, ob)
    assert torch.equal(o.resps, orr)
    assert torch.equal(o.next_first, onext)


def test_batched_build_octave_matches_jax(golden_small):
    """The 200x160 golden and a flipped copy as one batch, against JAX's
    build_octave of each image."""
    gray = golden_small["gray"]
    imgs = np.stack([gray, gray[::-1].copy()])
    first, pd = pyramid.prepare_first_level(t(imgs), PCFG)
    o = pyramid.build_octave(first, pd, PCFG)
    for i in range(2):
        jfirst, jpd = jpyr.prepare_first_level(jnp.asarray(imgs[i]), CFG)
        np.testing.assert_allclose(n(first[i]), n(jfirst), atol=1e-4)
        jo = jpyr.build_octave(jfirst, jpd, CFG)
        np.testing.assert_allclose(n(o.blurs[i]), n(jo.blurs), atol=1e-4)
        np.testing.assert_allclose(n(o.resps[i]), n(jo.resps), atol=0.05)
    jax.clear_caches()


def test_planes_rejects_uneven_layouts():
    x = torch.zeros((3, 4, 10, 12))
    with pytest.raises(ValueError):
        cuda_blur._planes(x[:, :, :, :6], "input")
    with pytest.raises(ValueError):
        cuda_blur._planes(x[:, :2], "input")
    assert cuda_blur._planes(x[:, 1], "input") == (3, 4 * 120)
    assert cuda_blur._planes(x, "input") == (12, 120)
