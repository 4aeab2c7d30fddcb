"""The SIFT kernel's plain version against the JAX Pallas kernel.

cuda_sift.sift_descriptors on a CPU tensor (the plain version) against
sift_descriptors_pallas in interpret mode, on test_pallas.py's inputs
(K = 150, not a multiple of the TPU kernel's 128-patch block): within
one quantisation step and > 99% exact (test_pallas.py's tolerance).
"""

import jax.numpy as jnp
import numpy as np
import torch

from hesaff_tpu.config import HesaffConfig
from hesaff_tpu.ops.pallas_sift import sift_descriptors_pallas
from hesaff_tpu_torch.ops import cuda_sift
from _torch_parity import n, port_cfg, smooth_stacks, t

CFG = HesaffConfig()


def test_plain_sift_matches_jax_kernel():
    rng = np.random.default_rng(5)
    K, P = 150, CFG.patch_size
    patches = np.clip(smooth_stacks(rng, 1, K, P, P)[0], 0, 255)
    patches = patches.astype(np.float32)
    ref = n(sift_descriptors_pallas(jnp.asarray(patches), CFG,
                                    interpret=True)).astype(np.int32)
    before = cuda_sift.LAUNCHES
    out = n(cuda_sift.sift_descriptors(t(patches), port_cfg(CFG)))
    assert cuda_sift.LAUNCHES == before
    assert out.shape == ref.shape == (K, 128)
    diff = np.abs(ref - out.astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff == 0).mean() > 0.99


def test_plain_sift_of_no_patches():
    out = cuda_sift.sift_descriptors(t(np.zeros((0, 41, 41), np.float32)),
                                     port_cfg(CFG))
    assert tuple(out.shape) == (0, 128)


def test_describe_masked_plain_rows():
    """describe_masked on CPU tensors: uint8 rows equal to the plain
    version's values where valid, zero rows elsewhere, no launch."""
    from hesaff_tpu_torch import dist, sift

    rng = np.random.default_rng(9)
    K, P = 40, CFG.patch_size
    patches = t(np.clip(smooth_stacks(rng, 1, K, P, P)[0], 0, 255))
    valid = t(rng.random(K) < 0.6)
    pcfg = port_cfg(CFG)
    before = cuda_sift.LAUNCHES
    out = cuda_sift.describe_masked(patches, valid, pcfg)
    assert cuda_sift.LAUNCHES == before
    assert out.dtype == torch.uint8 and tuple(out.shape) == (K, 128)
    assert not out[~valid].any()
    ref = sift.sift_descriptors(patches[valid], pcfg).to(torch.uint8)
    assert torch.equal(out[valid], ref)
    assert torch.equal(dist.describe_valid(patches, valid, pcfg), out)
    none = cuda_sift.describe_masked(patches, torch.zeros(K, dtype=bool),
                                     pcfg)
    assert tuple(none.shape) == (K, 128) and not none.any()
