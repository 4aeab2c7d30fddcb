"""Dense detection of the PyTorch port against the JAX package.

The walk's plain version is held exactly to JAX's _level_maps +
_walk_dense (as test_pallas.py holds the Pallas kernel): same ok plane,
same final cells where accepted, same field table at rtol 1e-6 /
atol 1e-5.  The octave detection is held slot for slot, with s allowed
the <= 1-ulp exp2 wobble (rtol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hesaff_tpu import detect as jdet
from hesaff_tpu import pyramid as jpyr
from hesaff_tpu.config import HesaffConfig
from hesaff_tpu_torch import detect
from hesaff_tpu_torch.ops import cuda_detect
from _torch_parity import n, port_cfg, smooth_stacks, t

CFG = HesaffConfig()
PCFG = port_cfg(CFG)


@pytest.mark.parametrize("H,W", [(200, 240), (61, 45)])
def test_plain_walk_matches_jax_dense(H, W):
    rng = np.random.RandomState(5)
    mk = lambda: smooth_stacks(
        np.random.default_rng(rng.randint(1 << 30)), H, W) * 40.0
    low, cur, high, blur = mk(), mk(), mk(), mk()

    mask, allm = jdet._level_maps(*(jnp.asarray(a) for a in
                                    (low, cur, high, blur)), CFG)
    ok_ref, cell_ref = jdet._walk_dense(allm, mask, CFG)
    ok_ref, cell_ref, allm = n(ok_ref), n(cell_ref), n(allm)
    lxx_ref = (n(jdet._shift_rep(blur, 0, -1)) - 2.0 * blur
               + n(jdet._shift_rep(blur, 0, 1)))

    ok, cell, tab, cand = cuda_detect.detect_walk_plain(
        *(t(a)[None] for a in (low, cur, high, blur)), PCFG)
    ok, cell, tab, cand = n(ok[0]), n(cell[0]), n(tab[0]), n(cand[0])

    assert ok_ref.sum() > (20 if H >= 100 else 0)
    np.testing.assert_array_equal(ok, ok_ref)
    np.testing.assert_array_equal(cell[ok_ref], cell_ref[ok_ref])
    np.testing.assert_array_equal(cand, n(mask))
    for ch, ref in enumerate((allm[..., 0], allm[..., 1], allm[..., 2],
                              allm[..., 3], lxx_ref)):
        np.testing.assert_allclose(tab[..., ch][ok_ref], ref[ok_ref],
                                   rtol=1e-6, atol=1e-5)


def test_plain_octave_walk_matches_jax_dense(golden_small):
    """The octave-wide walk's plain version (every detection level in one
    call, planar table) against JAX's per-level _level_maps +
    _walk_dense on the 200x160 golden's octave 0 and its flip."""
    g1 = golden_small["gray"]
    imgs = jnp.asarray(np.stack([g1, np.ascontiguousarray(g1[::-1, ::-1])]))
    first = jax.vmap(lambda im: jpyr.prepare_first_level(im, CFG)[0])(imgs)
    o = jax.vmap(lambda f: jpyr.build_octave(f, 1.0, CFG))(first)
    resps, blurs = n(o.resps), n(o.blurs)
    ok, cell, tab, cand = (n(v) for v in cuda_detect.detect_walk_octave(
        t(resps), t(blurs), PCFG))
    nl = CFG.num_scales
    assert ok.shape == (2, nl) + resps.shape[-2:]
    assert tab.shape == (2, nl, 5) + resps.shape[-2:]
    for b in range(2):
        for l in range(1, nl + 1):
            low, cur, high, blur = (resps[b, l - 1], resps[b, l],
                                    resps[b, l + 1], blurs[b, l])
            mask, allm = jdet._level_maps(*(jnp.asarray(a) for a in
                                            (low, cur, high, blur)), CFG)
            ok_ref, cell_ref = (n(v) for v in
                                jdet._walk_dense(allm, mask, CFG))
            allm = n(allm)
            lxx_ref = (n(jdet._shift_rep(blur, 0, -1)) - 2.0 * blur
                       + n(jdet._shift_rep(blur, 0, 1)))
            np.testing.assert_array_equal(ok[b, l - 1], ok_ref)
            np.testing.assert_array_equal(cand[b, l - 1], n(mask))
            np.testing.assert_array_equal(cell[b, l - 1][ok_ref],
                                          cell_ref[ok_ref])
            for ch, ref in enumerate((allm[..., 0], allm[..., 1],
                                      allm[..., 2], allm[..., 3], lxx_ref)):
                np.testing.assert_allclose(tab[b, l - 1, ch][ok_ref],
                                           ref[ok_ref], rtol=1e-6,
                                           atol=1e-5)
    assert ok.sum() > 50


def test_octave_detection_matches_jax(golden_small):
    g1 = golden_small["gray"]
    imgs = jnp.asarray(np.stack([g1, np.ascontiguousarray(g1[::-1, ::-1])]))
    first = jax.vmap(lambda im: jpyr.prepare_first_level(im, CFG)[0])(imgs)
    o = jax.vmap(lambda f: jpyr.build_octave(f, 1.0, CFG))(first)
    sig = jpyr.level_sigmas(CFG)
    ref = jax.tree.map(np.asarray, jdet.detect_octave_batch_dense(
        o.resps, o.blurs, sig, 1.0, CFG, octave=0))
    out = detect.detect_octave_batch(t(n(o.resps)), t(n(o.blurs)), sig,
                                     1.0, PCFG, octave=0)
    out = {k: n(v) for k, v in out.items()}

    assert ref["ok"].sum() > 50
    np.testing.assert_array_equal(out["ok"], ref["ok"])
    m = ref["ok"]
    for k in ("level", "x", "y", "response", "type"):
        np.testing.assert_array_equal(out[k][m], ref[k][m], err_msg=k)
    np.testing.assert_allclose(out["s"][m], ref["s"][m], rtol=1e-6)
    np.testing.assert_array_equal(out["overflow"], ref["overflow"])
    np.testing.assert_array_equal(out["n_cand"], ref["n_cand"])


def test_dedup_keeps_first_in_scan_order():
    cell = torch.tensor([[5, 3, 5, 7, 3, 9]])
    valid = torch.tensor([[True, True, True, True, True, False]])
    keep = detect._dedup_compacted(cell, valid, 100)
    ref = jdet._dedup_compacted(jnp.asarray(n(cell[0])),
                                jnp.asarray(n(valid[0])), 100)
    np.testing.assert_array_equal(n(keep[0]), n(ref))
    np.testing.assert_array_equal(n(keep[0]),
                                  [True, True, False, True, False, False])


@pytest.mark.parametrize("threshold,path", [(160 * 200, "sparse"),
                                            (160 * 200 + 1, "dense")])
def test_sparse_size_dispatches(monkeypatch, threshold, path):
    """An octave takes the sparse path exactly when H * W reaches
    SPARSE_PATH_PIXELS (2^23, the JAX package's rule), checked at a
    lowered threshold."""
    assert detect.SPARSE_PATH_PIXELS == 1 << 23
    monkeypatch.setattr(detect, "SPARSE_PATH_PIXELS", threshold)
    taken = []
    for name in ("sparse", "dense"):
        monkeypatch.setattr(detect, f"detect_octave_{name}",
                            lambda *a, name=name: taken.append(name))
    x = torch.zeros((1, 5, 160, 200))
    detect.detect_octave_batch(x, x, [1.0] * 5, 1.0, PCFG)
    assert taken == [path]
