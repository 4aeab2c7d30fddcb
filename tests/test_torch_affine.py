"""Affine adaptation of the PyTorch port against the JAX package.

The port's plain version (CPU tensors) against JAX adapt_flat (its XLA
twin on the CPU) under the _assert_affine_parity budget of
test_pallas.py: <= 2% ok or iteration flips, U rtol 1e-4 / atol 5e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from hesaff_tpu import affine_shape as jaff
from hesaff_tpu.config import HesaffConfig
from hesaff_tpu_torch import affine_shape
from _torch_parity import assert_affine_parity, port_cfg, smooth_stacks, t

CFG = HesaffConfig()
PCFG = port_cfg(CFG)


def _case(seed, B, L, H, W, K, margin):
    rng = np.random.default_rng(seed)
    stacks = smooth_stacks(rng, B, L, H, W)
    img_idx = rng.integers(0, B, K).astype(np.int32)
    src = rng.integers(0, L, K).astype(np.int32)
    x = rng.uniform(margin, W - margin, K).astype(np.float32)
    y = rng.uniform(margin, H - margin, K).astype(np.float32)
    s = rng.uniform(2.0, 5.0, K).astype(np.float32)
    active = rng.uniform(size=K) > 0.2
    return stacks, img_idx, src, x, y, s, active


@pytest.mark.parametrize("seed,B,L,H,W,K,margin,pd,min_matched", [
    (0, 2, 3, 200, 160, 64, 20, 1.0, 10),
    # small octave: the sampling window clamps to the octave size, and
    # keypoints near the border sample outside the image
    (3, 2, 3, 48, 40, 48, 4, 2.0, 4),
])
def test_adapt_flat_matches_jax(seed, B, L, H, W, K, margin, pd,
                                min_matched):
    stacks, img_idx, src, x, y, s, active = _case(seed, B, L, H, W, K,
                                                  margin)
    if H < 100:
        assert (affine_shape.sample_window_size(PCFG, H, W)
                < affine_shape.unclamped_window_size(PCFG))
    x, y, s = x * pd, y * pd, s * pd
    ref = jaff.adapt_flat(jnp.asarray(stacks), jnp.asarray(img_idx),
                          jnp.asarray(src), jnp.asarray(x), jnp.asarray(y),
                          jnp.asarray(s), pd, CFG,
                          active=jnp.asarray(active))
    out = affine_shape.adapt_flat(t(stacks), t(img_idx), t(src), t(x),
                                  t(y), t(s), pd, PCFG, active=t(active))
    assert_affine_parity(ref, out, active, min_matched=min_matched)
    assert not np.asarray(out.ok)[~active].any()


def test_window_sizes_match_jax():
    for H, W in ((640, 800), (40, 50), (20, 25), (8, 9)):
        assert (affine_shape.sample_window_size(PCFG, H, W)
                == jaff.sample_window_size(CFG, H, W))
    assert (affine_shape.unclamped_window_size(PCFG)
            == jaff.unclamped_window_size(CFG))


def test_plain_step_count():
    """adapt_batch_plain's step count (the bound of the affine kernel in
    chip_smoke.py) against the loop itself: 0 where inactive, at most
    max_iterations, iters + 1 where accepted; and the loop capped at m
    steps gives the same result for every keypoint that ran at most m,
    and m steps to the others."""
    import dataclasses

    import torch

    from hesaff_tpu_torch.ops import cuda_affine

    stacks, img_idx, src, x, y, s, active = _case(0, 2, 3, 200, 160, 96, 4)
    args = affine_shape.adapt_args(t(stacks), t(img_idx), t(src), t(x),
                                   t(y), t(s), 1.0, PCFG, active=t(active))
    ref, steps = cuda_affine.adapt_plain(*args, return_steps=True)
    act = t(active)
    assert bool((steps[~act] == 0).all())
    assert bool((steps[act] >= 1).all())
    assert bool((steps <= PCFG.max_iterations).all())
    assert bool((steps == PCFG.max_iterations).any())
    assert bool((steps[ref.ok] == ref.iters[ref.ok] + 1).all())
    m = 3
    cap = dataclasses.replace(PCFG, max_iterations=m)
    short, csteps = cuda_affine.adapt_plain(*args[:-1], cap,
                                            return_steps=True)
    assert torch.equal(csteps, torch.clamp(steps, max=m))
    done = steps <= m
    assert bool(done.any()) and bool((~done & act).any())
    for f in ("ok", "u11", "u12", "u21", "u22", "iters"):
        assert torch.equal(getattr(short, f)[done], getattr(ref, f)[done]), f
    assert not bool(short.ok[~done].any())
