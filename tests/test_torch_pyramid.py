"""Pyramid ladder of the PyTorch port against JAX and the oracle goldens.

The ladder levels come from the blur + DoH kernel's plain version here
(CPU tensors).  Tolerances: blur atol 1e-4 and response atol 0.05
against JAX (the Pallas-vs-XLA tolerances of test_pallas.py), blurs
atol 3e-4 against the oracle (test_pyramid.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from hesaff_tpu import pyramid as jpyr
from hesaff_tpu.config import HesaffConfig
from hesaff_tpu_torch import pyramid
from hesaff_tpu_torch.ops import cuda_blur
from hesaff_tpu_torch.ops.blur import gaussian_taps
from _torch_parity import n, port_cfg, t

CFG = HesaffConfig()
PCFG = port_cfg(CFG)


def test_build_octave_matches_jax(golden_small):
    gray = golden_small["gray"]
    jfirst, jpd = jpyr.prepare_first_level(jnp.asarray(gray), CFG)
    first, pd = pyramid.prepare_first_level(t(gray), PCFG)
    assert pd == jpd
    np.testing.assert_allclose(n(first), n(jfirst), atol=1e-4)
    jo = jpyr.build_octave(jnp.asarray(n(jfirst)), jpd, CFG)
    o = pyramid.build_octave(t(n(jfirst)), pd, PCFG)
    assert o.sigmas == jo.sigmas
    np.testing.assert_allclose(n(o.blurs), n(jo.blurs), atol=1e-4)
    np.testing.assert_allclose(n(o.resps), n(jo.resps), atol=0.05)
    np.testing.assert_allclose(n(o.next_first), n(jo.next_first),
                               atol=1e-4)


def test_three_octave_ladder_matches_oracle(golden_mid):
    cur, pd = pyramid.prepare_first_level(t(golden_mid["gray"]), PCFG)
    np.testing.assert_allclose(n(cur), golden_mid["firstLevel"], atol=2e-4)
    for octave in range(3):
        o = pyramid.build_octave(cur, pd, PCFG)
        for k in range(CFG.num_scales + 2):
            key = f"oct{octave}_blur{k}"
            if key in golden_mid:
                np.testing.assert_allclose(n(o.blurs[k]), golden_mid[key],
                                           atol=3e-4, err_msg=key)
        cur, pd = o.next_first, pd * 2


@pytest.mark.parametrize("shape,sigma", [((100, 128), 1.2),
                                         ((2, 61, 47), 2.46)])
def test_blur_doh_plain_matches_jax_twin(shape, sigma):
    """The kernel's plain version is the JAX XLA twin of the Pallas
    blur_doh (blur atol 1e-4, resp atol 0.05; 1-px frame zero)."""
    from hesaff_tpu.ops.blur import gaussian_blur_traced
    from hesaff_tpu.ops.hessian import hessian_response

    rng = np.random.RandomState(0)
    img = (rng.rand(*shape) * 200).astype(np.float32)
    taps = gaussian_taps(sigma)
    sigma_next = 1.6
    b, r = cuda_blur.blur_doh(t(img), taps, float(sigma_next ** 4))
    rb = gaussian_blur_traced(jnp.asarray(img), jnp.asarray(taps))
    rr = hessian_response(rb, sigma_next ** 2)
    np.testing.assert_allclose(n(b), n(rb), atol=1e-4)
    np.testing.assert_allclose(n(r), n(rr), atol=0.05)
    r = n(r)
    assert np.all(r[..., 0, :] == 0) and np.all(r[..., -1, :] == 0)
    assert np.all(r[..., :, 0] == 0) and np.all(r[..., :, -1] == 0)
