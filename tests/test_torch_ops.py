"""Leaf ops of the PyTorch port against the JAX package's ops.

Float outputs are held at atol 1e-5 (same arithmetic, op for op);
integer and boolean outputs exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hesaff_tpu.ops import batching as jb
from hesaff_tpu.ops import blur as jblur
from hesaff_tpu.ops import hessian as jhess
from hesaff_tpu.ops import linalg as jlin
from hesaff_tpu.ops import resample as jres
from hesaff_tpu.ops import warp as jwarp
from hesaff_tpu_torch.ops import batching, blur, hessian, linalg, resample
from hesaff_tpu_torch.ops import warp
from _torch_parity import (COMPACTION_CASES, compact_rows_nonzero,
                           compaction_mask, n, t)

ATOL = 1e-5


@pytest.mark.parametrize("sigma", [0.5, 1.2489, 1.6, 2.0158, 2.4558, 7.3])
def test_gaussian_taps_equal(sigma):
    assert blur.opencv_ksize(sigma) == jblur.opencv_ksize(sigma)
    np.testing.assert_array_equal(blur.gaussian_taps(sigma),
                                  jblur.gaussian_taps(sigma))


@pytest.mark.parametrize("sigma,shape", [(1.2489, (37, 52)),
                                         (2.4558, (2, 23, 31))])
def test_separable_blur(sigma, shape):
    rng = np.random.default_rng(0)
    img = (rng.random(shape) * 255).astype(np.float32)
    taps = jblur.gaussian_taps(sigma)
    ref = jblur.gaussian_blur_traced(jnp.asarray(img), jnp.asarray(taps))
    out = blur.separable_blur(t(img), taps)
    np.testing.assert_allclose(n(out), n(ref), atol=ATOL * 255)


def test_hessian_response():
    rng = np.random.default_rng(1)
    img = (rng.random((2, 29, 33)) * 100).astype(np.float32)
    ref = jhess.hessian_response(jnp.asarray(img), 1.6 ** 2)
    out = hessian.hessian_response(t(img), 1.6 ** 2)
    np.testing.assert_allclose(n(out), n(ref), rtol=1e-6, atol=ATOL)
    assert np.all(n(out)[:, 0] == 0) and np.all(n(out)[:, :, -1] == 0)


def test_resample():
    rng = np.random.default_rng(2)
    img = rng.random((3, 11, 14)).astype(np.float32)
    np.testing.assert_array_equal(n(resample.half_image(t(img))),
                                  n(jres.half_image(jnp.asarray(img))))
    np.testing.assert_allclose(n(resample.double_image(t(img))),
                               n(jres.double_image(jnp.asarray(img))),
                               atol=ATOL)


def _systems(rng, k):
    A = rng.normal(size=(k, 3, 3)).astype(np.float32)
    b = rng.normal(size=(k, 3)).astype(np.float32)
    # singular systems: zero matrix, repeated rows, zero first column,
    # a zero pivot after elimination
    A[0] = 0.0
    A[1, 1] = A[1, 0]
    A[2, :, 0] = 0.0
    A[3] = [[1, 2, 3], [2, 4, 6], [1, 1, 1]]
    A[4] = [[0, 0, 0], [0, 0, 0], [0, 0, 1]]
    return A, b


def test_solve3x3_parts_and_singular_pattern():
    rng = np.random.default_rng(3)
    A, b = _systems(rng, 64)
    ref = jlin.solve3x3(jnp.asarray(A), jnp.asarray(b))
    out = torch.stack(linalg.solve3x3_parts(
        [[t(A[:, i, j]) for j in range(3)] for i in range(3)],
        [t(b[:, i]) for i in range(3)]), dim=-1)
    r, o = n(ref), n(out)
    np.testing.assert_array_equal(np.isnan(r), np.isnan(o))
    np.testing.assert_array_equal(np.isinf(r), np.isinf(o))
    assert np.isnan(r[:5]).any() or np.isinf(r[:5]).any()
    fin = np.isfinite(r)
    np.testing.assert_allclose(o[fin], r[fin], rtol=1e-5, atol=ATOL)


def test_inv_sqrt_eigen_rectify():
    rng = np.random.default_rng(4)
    k = 200
    a = rng.uniform(0.1, 5, k).astype(np.float32)
    c = rng.uniform(0.1, 5, k).astype(np.float32)
    b = (rng.uniform(-1, 1, k) * np.sqrt(a * c) * 0.9).astype(np.float32)
    b[:10] = 0.0                       # the b == 0 branch
    a[10:12] = 0.0                     # flat window: NaN propagation
    b[10:12] = 0.0
    c[10:12] = 0.0
    ref = jlin.inv_sqrt_2x2(*(jnp.asarray(v) for v in (a, b, c)))
    out = linalg.inv_sqrt_2x2(*(t(v) for v in (a, b, c)))
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(np.isnan(n(r)), np.isnan(n(o)))
        np.testing.assert_allclose(n(o), n(r), rtol=1e-5, atol=ATOL)

    m = rng.normal(size=(4, k)).astype(np.float32)
    m[:, :5] = [[1], [3], [-2], [1]]   # complex eigenvalues
    ref = jlin.eigenvalues_2x2(*(jnp.asarray(v) for v in m))
    out = linalg.eigenvalues_2x2(*(t(v) for v in m))
    np.testing.assert_array_equal(n(ref[2]), n(out[2]))
    for r, o in zip(ref[:2], out[:2]):
        np.testing.assert_allclose(n(o), n(r), rtol=1e-5, atol=ATOL)

    ref = jlin.rectify_up_is_up(*(jnp.asarray(v) for v in m))
    out = linalg.rectify_up_is_up(*(t(v) for v in m))
    for r, o in zip(ref, out):
        np.testing.assert_allclose(n(o), n(r), rtol=1e-5, atol=ATOL)


def test_warp_grid_sample_and_borders():
    rng = np.random.default_rng(5)
    H, W = 40, 50
    stack = (rng.random((3, H, W)) * 255).astype(np.float32)
    k = 24
    ofx = rng.uniform(-5, W + 5, k).astype(np.float32)
    ofy = rng.uniform(-5, H + 5, k).astype(np.float32)
    A = rng.normal(0, 0.8, (4, k)).astype(np.float32)
    idx = rng.integers(0, 3, k)
    for i in range(k):
        args = (ofx[i], ofy[i], *A[:, i])
        jx, jy = jwarp.affine_grid(7, 9, *(jnp.float32(v) for v in args))
        tx, ty = warp.affine_grid(7, 9, *(t(np.float32(v)) for v in args))
        np.testing.assert_allclose(n(tx), n(jx), atol=ATOL)
        np.testing.assert_allclose(n(ty), n(jy), atol=ATOL)
        rv, rt = jwarp.bilinear_sample_from(jnp.asarray(stack),
                                            int(idx[i]), jx, jy)
        ov, ovalid = warp.bilinear_sample_from(t(stack), int(idx[i]),
                                               t(n(jx)), t(n(jy)))
        np.testing.assert_allclose(n(ov), n(rv), atol=ATOL * 255)
        assert bool(rt) == bool((~ovalid).any())
        sv, st = warp.bilinear_sample(t(stack[idx[i]]), t(n(jx)), t(n(jy)))
        np.testing.assert_array_equal(n(sv), n(ov))
        assert st == bool(rt)
        rb = jwarp.check_borders(H, W, 41, 41, *(jnp.float32(v)
                                                 for v in args))
        ob = warp.check_borders(H, W, 41, 41, *(t(np.float32(v))
                                                for v in args))
        assert bool(rb) == bool(ob)


@pytest.mark.parametrize("density,capacity", [(0.01, 50), (0.3, 64),
                                              (0.0, 8)])
def test_compact_indices(density, capacity):
    rng = np.random.default_rng(6)
    mask = rng.random((3, 37, 41)) < density
    ref = jb.compact_indices(jnp.asarray(mask), capacity)
    out = batching.compact_indices(t(mask), capacity)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(n(o), n(r))


@pytest.mark.parametrize("density,rows,capacity", COMPACTION_CASES)
def test_compact_rows_equals_nonzero_compaction(density, rows, capacity):
    """The fixed-shape compaction equals the nonzero-based one element
    for element: idx, valid and overflow, by rows and flat."""
    mask = compaction_mask(density, rows)
    out = batching.compact_rows(mask, capacity)
    ref = compact_rows_nonzero(mask, capacity)
    for o, r in zip(out, ref):
        assert o.dtype == r.dtype and torch.equal(o, r)
    flat = batching.compact_indices(mask, capacity)
    ref = compact_rows_nonzero(mask.reshape(1, -1), capacity)
    for o, r in zip(flat, ref):
        assert o.dtype == r.dtype and torch.equal(o, r[0])
