"""The port's blocked 2-NN and descriptor matching against the JAX
package's (hesaff_tpu.match), on the CPU.

Descriptors are uint8 values held as float32, so every distance term is
an integer below 2^24 and exact in any summation order: idx, dist and
dist2 must be bit-equal to JAX's.  The sets plant duplicate rows (the
same keypoint reached twice), within a block and across blocks, so ties
exercise the first-index rule and dist2 == dist.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hesaff_tpu import match as jmatch
from hesaff_tpu_torch import match
from _torch_parity import n


def planted(nq, m, seed):
    """uint8 query / database sets with duplicate database rows, some
    of them block-width (256) apart, and queries equal to database
    rows."""
    rng = np.random.default_rng(seed)
    db = rng.integers(0, 256, (m, 128)).astype(np.uint8)
    src = rng.integers(0, m, m // 10)
    dst = rng.integers(0, m, m // 10)
    db[dst] = db[src]
    for i in range(0, m - 256, 97):
        db[i + 256] = db[i]
    q = rng.integers(0, 256, (nq, 128)).astype(np.uint8)
    pick = rng.integers(0, m, nq // 3)
    q[: nq // 3] = db[pick]
    noisy = np.clip(db[pick].astype(np.int32)
                    + rng.integers(-3, 4, (nq // 3, 128)), 0, 255)
    q[nq // 3: 2 * (nq // 3)] = noisy
    return q, db


def jax_knn2(q, db, block):
    m = jmatch.knn2(jnp.asarray(q, jnp.float32), jnp.asarray(db, jnp.float32),
                    block=block)
    return n(m.idx), n(m.dist), n(m.dist2)


@pytest.mark.parametrize("nq,m,block", [(300, 700, 256), (300, 700, 4096),
                                        (257, 1000, 256), (64, 513, 256)])
def test_knn2_bit_equal(nq, m, block):
    q, db = planted(nq, m, seed=m)
    ref = jax_knn2(q, db, block)
    out = match.knn2(q, db, block=block, device="cpu")
    assert out.idx.dtype == torch.int32 and out.dist.dtype == torch.float32
    for a, b in zip(ref, (out.idx, out.dist, out.dist2)):
        np.testing.assert_array_equal(n(b), a)
    # the planted ties are there: some queries have dist2 == dist
    assert (n(out.dist2) == n(out.dist)).any()
    assert (n(out.dist) == 0).sum() >= nq // 3


def test_knn2_single_row_padding():
    """M == 1: dist2 is the distance to a 1e6 padding row of the block,
    which is not an integer and so not exact; rtol 1e-6 there.  idx and
    dist stay exact."""
    q, db = planted(50, 300, seed=3)
    ref = jax_knn2(q, db[:1], 4096)
    out = match.knn2(q, db[:1], device="cpu")
    np.testing.assert_array_equal(n(out.idx), ref[0])
    np.testing.assert_array_equal(n(out.dist), ref[1])
    np.testing.assert_allclose(n(out.dist2), ref[2], rtol=1e-6)


@pytest.mark.parametrize("ratio,cross_check", [(0.8, True), (0.8, False),
                                               (1.0, True), (0.9, False)])
def test_match_descriptors_equal(ratio, cross_check):
    q, db = planted(400, 900, seed=7)
    ref = jmatch.match_descriptors(q, db, ratio=ratio,
                                   cross_check=cross_check)
    out = match.match_descriptors(q, db, ratio=ratio,
                                  cross_check=cross_check, device="cpu")
    for a, b in zip(ref, out):
        assert b.dtype == np.int32
        np.testing.assert_array_equal(b, a)
    assert len(out[0]) > 0


def test_match_descriptors_tensor_input():
    """CPU tensors run on the CPU with no device given."""
    q, db = planted(100, 300, seed=11)
    ref = match.match_descriptors(q, db, device="cpu")
    out = match.match_descriptors(torch.from_numpy(q), torch.from_numpy(db))
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("nq,m", [(0, 50), (50, 0), (0, 0)])
def test_match_descriptors_empty(nq, m):
    rng = np.random.default_rng(0)
    q = rng.integers(0, 256, (nq, 128)).astype(np.uint8)
    db = rng.integers(0, 256, (m, 128)).astype(np.uint8)
    ref = jmatch.match_descriptors(q, db)
    out = match.match_descriptors(q, db, device="cpu")
    for a, b in zip(ref, out):
        assert b.dtype == np.int32 and b.shape == (0,)
        np.testing.assert_array_equal(b, a)
