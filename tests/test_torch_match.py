"""The port's blocked 2-NN and descriptor matching against the JAX
package's (hesaff_tpu.match), on the CPU.

Descriptors are uint8 values held as float32, so every distance term is
an integer below 2^24 and exact in any summation order: idx, dist and
dist2 must be bit-equal to JAX's.  The sets plant duplicate rows (the
same keypoint reached twice), within a block and across blocks, so ties
exercise the first-index rule and dist2 == dist.  The same semantics
hold the K7 kernel (ops/cuda_knn2) on the card; here its dispatch rule
and its work plan are checked, which need no card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hesaff_tpu import match as jmatch
from hesaff_tpu_torch import match
from hesaff_tpu_torch.ops import cuda_knn2
from _torch_parity import n


def planted(nq, m, seed, extremes=False):
    """uint8 query / database sets with duplicate database rows, some
    of them block-width (256) apart, and queries equal to database
    rows; query 0 is a copy of a row held twice (a duplicate minimum,
    also at nq = 1 or m = 2).  With `extremes`, all-zero and all-255
    rows (the zero row twice) and the last two queries of each."""
    rng = np.random.default_rng(seed)
    db = rng.integers(0, 256, (m, 128)).astype(np.uint8)
    src = rng.integers(0, m, m // 10)
    dst = rng.integers(0, m, m // 10)
    db[dst] = db[src]
    for i in range(0, m - 256, 97):
        db[i + 256] = db[i]
    db[m - 1] = db[0]
    if extremes:
        db[1], db[2], db[3] = 0, 255, 0
    q = rng.integers(0, 256, (nq, 128)).astype(np.uint8)
    pick = rng.integers(0, m, nq // 3)
    q[: nq // 3] = db[pick]
    noisy = np.clip(db[pick].astype(np.int32)
                    + rng.integers(-3, 4, (nq // 3, 128)), 0, 255)
    q[nq // 3: 2 * (nq // 3)] = noisy
    q[0] = db[0]
    if extremes:
        q[-1], q[-2] = 0, 255
    return q, db


def jax_knn2(q, db, block):
    m = jmatch.knn2(jnp.asarray(q, jnp.float32), jnp.asarray(db, jnp.float32),
                    block=block)
    return n(m.idx), n(m.dist), n(m.dist2)


KNN2_CASES = [(300, 700, 256, False), (300, 700, 4096, False),
              (257, 1000, 256, False), (64, 513, 256, False),
              (1, 700, 256, False), (300, 2, 4096, False),
              (1, 2, 4096, False), (300, 700, 256, True)]


@pytest.mark.parametrize(
    "nq,m,block,extremes", KNN2_CASES,
    ids=[f"{nq}-{m}-{b}" + ("-extremes" if e else "")
         for nq, m, b, e in KNN2_CASES])
def test_knn2_bit_equal(nq, m, block, extremes):
    q, db = planted(nq, m, seed=m, extremes=extremes)
    ref = jax_knn2(q, db, block)
    out = match.knn2(q, db, block=block, device="cpu")
    assert out.idx.dtype == torch.int32 and out.dist.dtype == torch.float32
    for a, b in zip(ref, (out.idx, out.dist, out.dist2)):
        np.testing.assert_array_equal(n(b), a)
    # the planted ties are there: some queries have dist2 == dist
    assert (n(out.dist2) == n(out.dist)).any()
    assert (n(out.dist) == 0).sum() >= nq // 3
    if extremes:
        assert n(out.dist)[-1] == 0 and n(out.dist2)[-1] == 0
        assert n(out.idx)[-1] == 1 and n(out.dist)[-2] == 0


@pytest.mark.parametrize("nq,m", [(2750, 16_334_970), (2560, 16_334_970),
                                  (1, 2), (37, 63), (1, 300_000),
                                  (2750, 4097), (27_774, 27_774)])
def test_knn2_u8_plan(nq, m):
    """The kernel's work plan: whole tiles in every strip, one item a
    (query tile, strip), CTAs that each get the same number of items or
    one fewer; the Oxford5k query (~2,750 rows against 16.33 M) takes
    one item an SM."""
    n_sm = 132
    strips, ctas = cuda_knn2.plan(nq, m, n_sm)
    tiles = -(-m // cuda_knn2.DROWS)
    items = -(-nq // cuda_knn2.QROWS) * strips
    assert 1 <= strips <= tiles and ctas == min(items, n_sm)
    assert items / ctas <= -(-items // ctas)
    if (nq, m) == (2750, 16_334_970):
        assert items == n_sm


@pytest.mark.parametrize("q_dtype,db_rows", [(np.uint8, 300), (np.float32, 300),
                                             (np.uint8, 1)])
def test_knn2_cpu_keeps_the_plain_path(q_dtype, db_rows):
    """CPU input, uint8 or not, never reaches the kernel, whatever the
    database's row count."""
    q, db = planted(40, 300, seed=5)
    before = cuda_knn2.LAUNCHES
    out = match.knn2(torch.from_numpy(q.astype(q_dtype)),
                     torch.from_numpy(db[:db_rows]))
    assert out.idx.device.type == "cpu" and cuda_knn2.LAUNCHES == before


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
