"""Sparse and per-level detection of the PyTorch port against the JAX
package.

Inputs are the 200x160 golden's octave-0 DoH and blur planes and their
flip.  The maps' plain version is held to both JAX references of K3
(the XLA pair and detect_maps_pallas in interpret mode) with
test_pallas.py's tolerance: equal mask / nan / edge flags, the maps
close on >= 99.5% of pixels at 1e-4, and the same walk decisions.  The
sparse octave path, detect_level and _detect_one_octave are held slot
for slot under capacities that fit and capacities that overflow: ok,
level, type, the final cells, overflow and n_cand equal; x, y and
response within rtol 3e-7, because XLA's fusion of the jitted JAX
reference rounds them up to an ulp away from its own unjitted run
(test_detect.py allows JAX the same between its two forms; the port
equals the unjitted run bit for bit, but running it unjitted takes
~20 s a config); s within rtol 1e-6, the exp2 wobble.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hesaff_tpu import batch as jbatch
from hesaff_tpu import detect as jdet
from hesaff_tpu.config import HesaffConfig
from hesaff_tpu.pyramid import level_sigmas
from hesaff_tpu.sift_io import ellipse_abc
from hesaff_tpu_torch import batch, detect, extract
from hesaff_tpu_torch.ops import cuda_detect
from _torch_parity import n, port_cfg, t

CFG = HesaffConfig()
SMALL_CAPS = dataclasses.replace(CFG, candidate_cap_min=16,
                                 candidate_cap_max=32, affine_cap_min=16,
                                 affine_cap_max=40)
SIG = level_sigmas(CFG)


@pytest.fixture(scope="module")
def planes(golden_small):
    """(2, 5, 160, 200) octave-0 responses and blurs: golden, flipped."""
    g = golden_small
    r = np.stack([g[f"oct0_resp{i}"] for i in range(5)]).astype(np.float32)
    b = np.stack([g[f"oct0_blur{i}"] for i in range(5)]).astype(np.float32)
    flip = lambda a: np.ascontiguousarray(a[:, ::-1, ::-1])
    return np.stack([r, flip(r)]), np.stack([b, flip(b)])


def _assert_slots_equal(out, ref, min_ok):
    """ok everywhere; the fields on accepted slots; overflow and
    n_cand."""
    assert ref["ok"].sum() >= min_ok
    np.testing.assert_array_equal(out["ok"], ref["ok"])
    m = ref["ok"]
    for k in ("level", "type"):
        np.testing.assert_array_equal(out[k][m], ref[k][m], err_msg=k)
    for k, rtol in (("x", 3e-7), ("y", 3e-7), ("response", 3e-7),
                    ("s", 1e-6)):
        np.testing.assert_allclose(out[k][m], ref[k][m], rtol=rtol, atol=0,
                                   err_msg=k)
    np.testing.assert_array_equal(out["overflow"], ref["overflow"])
    np.testing.assert_array_equal(out["n_cand"], ref["n_cand"])


@pytest.mark.parametrize("ref_kind", ["xla", "pallas_interpret"])
def test_detect_maps_plain_matches_jax(golden_small, ref_kind):
    low, cur, high = (golden_small[f"oct0_resp{i}"] for i in (0, 1, 2))
    blur = golden_small["oct0_blur1"]
    jl, jc, jh, jb = (jnp.asarray(a) for a in (low, cur, high, blur))
    ref_mask = jdet.candidate_mask(jl, jc, jh, CFG)
    if ref_kind == "xla":
        rmaps, redge = jdet._localization_maps(jl, jc, jh, CFG)
        pack = jdet._pack_walk_channels(rmaps, redge, jb)
    else:
        from hesaff_tpu.ops.pallas_detect import detect_maps_pallas

        rmaps, rnan, redge, rmask = detect_maps_pallas(
            jl, jc, jh, CFG.border, CFG.positive_threshold,
            CFG.negative_threshold, CFG.edge_score_threshold,
            interpret=True)
        np.testing.assert_array_equal(n(rmask), n(ref_mask))
        pack = jdet._stack_walk_channels(
            rmaps[..., 0], rmaps[..., 1], rmaps[..., 2], rmaps[..., 3],
            rnan, redge, jb)
    pack = n(pack)

    maps, nan_flag, edge, mask = cuda_detect.detect_maps_plain(
        *(t(a)[None] for a in (low, cur, high)), port_cfg(CFG))
    maps, nan_flag, edge, mask = (n(a[0]) for a in (maps, nan_flag, edge,
                                                     mask))
    np.testing.assert_array_equal(mask, n(ref_mask))
    np.testing.assert_array_equal(nan_flag, pack[..., 4] > 0.5)
    np.testing.assert_array_equal(edge, pack[..., 5] > 0.5)
    close = np.isclose(maps, pack[..., :4], rtol=1e-4, atol=1e-4)
    assert close.all(axis=-1).mean() > 0.995

    # walk decisions: JAX's per-candidate walk over its pack against the
    # port's windowed walk over its own maps
    H, W = cur.shape
    rows, cols, valid, _ = jdet.compact_candidates(ref_mask, 512)
    walk = jax.jit(jax.vmap(lambda rr, cc: jdet._walk_one(
        jnp.asarray(pack), rr, cc, jnp.float32(SIG[1]), jnp.float32(1.0),
        H, W, CFG)))
    ref = [n(o) for o in walk(rows, cols)]
    out = [n(o[0]) for o in detect._walk_window(
        t(maps)[None], t(nan_flag)[None], t(edge)[None], t(blur)[None],
        t(rows, torch.int64)[None], t(cols, torch.int64)[None], SIG[1], 1.0,
        port_cfg(CFG))]
    v = n(valid)
    assert v.sum() > 10
    agree = out[0][v] == ref[0][v]
    assert agree.mean() > 0.99
    both = v.copy()
    both[v] &= out[0][v] & ref[0][v] & agree
    assert both.sum() > 5
    for i in (1, 2, 3):   # x, y, s of accepted keypoints
        np.testing.assert_allclose(out[i][both], ref[i][both], rtol=1e-3,
                                   atol=1e-3)


@pytest.mark.parametrize("cfg,min_ok,overflows", [
    (CFG, 80, False), (SMALL_CAPS, 60, True)],
    ids=["default_caps", "small_caps"])
def test_sparse_octave_matches_jax(planes, monkeypatch, cfg, min_ok,
                                   overflows):
    resps, blurs = planes
    monkeypatch.setattr(jdet, "_DETECT_DENSE", False)
    run = jax.jit(lambda r, b: jdet.detect_octave_batch(r, b, SIG, 1.0, cfg,
                                                        octave=0))
    ref = jax.tree.map(np.asarray, run(jnp.asarray(resps),
                                       jnp.asarray(blurs)))
    out = detect.detect_octave_sparse(t(resps), t(blurs), SIG, 1.0,
                                      port_cfg(cfg), octave=0)
    out = {k: n(v) for k, v in out.items()}
    assert bool((ref["overflow"] > 0).all()) == overflows
    _assert_slots_equal(out, ref, min_ok)


@pytest.mark.parametrize("border", [5, 2, 0])
def test_detect_one_octave_matches_jax(planes, border):
    """Per-image detection through detect_level.  Border 2 and 0 put
    candidates whose windows are clamped at the image edge (border 0:
    reads outside the window, which give 0); there every valid slot is
    held, accepted or not."""
    cfg = dataclasses.replace(CFG, border=border)
    resps, blurs = planes[0][0], planes[1][0]
    run = jax.jit(lambda r, b: jbatch._detect_one_octave(r, b, SIG, 1.0,
                                                         cfg))
    ref = jax.tree.map(np.asarray, run(jnp.asarray(resps),
                                       jnp.asarray(blurs)))
    out = batch._detect_one_octave(t(resps), t(blurs), SIG, 1.0,
                                   port_cfg(cfg))
    out = {k: n(v) for k, v in out.items()}
    _assert_slots_equal(out, ref, 40)
    lv = jax.jit(lambda: jdet.detect_level(
        *(jnp.asarray(resps[i]) for i in (0, 1, 2)), jnp.asarray(blurs[1]),
        SIG[1], 1.0, 512, cfg))()
    lk = detect.detect_level(*(t(resps[i])[None] for i in (0, 1, 2)),
                             t(blurs[1])[None], SIG[1], 1.0, 512,
                             port_cfg(cfg))
    v = np.arange(512) < int(lv.n_cand)
    assert v.sum() > 10
    np.testing.assert_array_equal(n(lk.ok[0]), n(lv.ok))
    for f in ("type", "r_final", "c_final"):
        np.testing.assert_array_equal(n(getattr(lk, f)[0])[v],
                                      n(getattr(lv, f))[v], err_msg=f)
    for f, rtol in (("x", 3e-7), ("y", 3e-7), ("response", 3e-7),
                    ("s", 1e-6)):
        np.testing.assert_allclose(n(getattr(lk, f)[0])[v],
                                   n(getattr(lv, f))[v], rtol=rtol, atol=0,
                                   err_msg=f)


def _port_detection(gray, form):
    """The oracle's keypoint list over every octave, through the port's
    detect_level + dedup_octave (tests/test_detect.py's run_detection)
    or through batch._detect_one_octave, which adds the compaction to
    the affine capacity (nothing overflows on the goldens)."""
    from hesaff_tpu_torch import pyramid

    cfg = port_cfg(CFG)
    cur, pd = pyramid.prepare_first_level(t(gray)[None], cfg)
    sig = pyramid.level_sigmas(cfg)
    out = []
    octave = 0
    while (cur.shape[-2] > cfg.min_octave_size
           and cur.shape[-1] > cfg.min_octave_size):
        H, W = cur.shape[-2:]
        o = pyramid.build_octave(cur, pd, cfg)
        if form == "detect_level":
            cap = cfg.level_capacity(H, W)
            levels = [detect.detect_level(o.resps[:, l - 1], o.resps[:, l],
                                          o.resps[:, l + 1], o.blurs[:, l],
                                          sig[l], pd, cap, cfg)
                      for l in (1, 2, 3)]
            kps = [{f: getattr(lk, f)[0] for f in
                    ("ok", "x", "y", "s", "type", "response")}
                   for lk in detect.dedup_octave(levels, H, W)]
        else:
            kps = [batch._detect_one_octave(o.resps[0], o.blurs[0], sig, pd,
                                            cfg, octave)]
            assert int(kps[0]["overflow"]) == 0
        for k in kps:
            for j in np.nonzero(n(k["ok"]))[0]:
                out.append((float(k["x"][j]), float(k["y"][j]),
                            float(k["s"][j]), pd, int(k["type"][j]),
                            float(k["response"][j])))
        cur = o.next_first
        pd *= 2.0
        octave += 1
    return np.asarray(out)


@pytest.mark.parametrize("form", ["detect_level", "one_octave"])
@pytest.mark.parametrize("pack", ["golden_small", "golden_mid"])
def test_detect_level_matches_oracle(pack, form, request):
    """test_detect.py's oracle asserts: >= 97% of oracle keypoints found
    within 0.3 px x pd, each within 2% in scale and response with the
    same type, counts within max(2, 2%)."""
    golden = request.getfixturevalue(pack)
    g = golden["hess_keypoints"]
    mine = _port_detection(golden["gray"], form)
    matched = close = 0
    for row in g:
        cand = mine[mine[:, 3] == row[3]]
        if len(cand) == 0:
            continue
        dd = np.hypot(cand[:, 0] - row[0], cand[:, 1] - row[1])
        i = dd.argmin()
        if dd[i] < 0.3 * row[3]:
            matched += 1
            close += int(abs(cand[i, 2] - row[2]) < 0.02 * row[2]
                         and abs(cand[i, 5] - row[5]) < 0.02 * abs(row[5])
                         and cand[i, 4] == row[4])
    assert matched >= 0.97 * len(g)
    assert close == matched
    assert abs(len(mine) - len(g)) <= max(2, 0.02 * len(g))


def test_extract_all_sparse_equals_dense(golden_small, monkeypatch):
    """extract() with every octave on the sparse path: nothing
    overflows on the golden, so it equals the dense run, and it meets
    test_torch_pipeline.py's oracle asserts."""
    from tests.conftest import parse_sift_bytes

    cfg = port_cfg(CFG)
    dense, dstats = extract(golden_small["gray"], cfg, device="cpu",
                            return_stats=True)
    monkeypatch.setattr(detect, "SPARSE_PATH_PIXELS", 0)
    sparse, sstats = extract(golden_small["gray"], cfg, device="cpu",
                             return_stats=True)
    assert sstats == dstats and sstats.candidate_overflow == 0
    for f in sparse._fields:
        np.testing.assert_allclose(getattr(sparse, f), getattr(dense, f),
                                   rtol=1e-6, atol=0, err_msg=f)

    gu, gv, ge, gdesc = parse_sift_bytes(golden_small["sift_file"])
    ell = np.stack(ellipse_abc(
        *(getattr(sparse, f).astype(np.float64)
          for f in ("a11", "a12", "a21", "a22", "s")), CFG.mr_size), -1)
    matched = 0
    for i in range(len(gu)):
        dd = np.hypot(sparse.x - gu[i], sparse.y - gv[i])
        j = int(dd.argmin())
        if dd[j] < 0.5:
            matched += 1
            rel = np.abs(ell[j] - ge[i]).max() / max(np.abs(ge[i]).max(),
                                                     1e-12)
            assert rel < 0.02
            l1 = np.abs(sparse.desc[j].astype(np.int32) - gdesc[i]).mean()
            assert l1 < 0.5
    assert matched >= 0.97 * len(gu)
    assert abs(sparse.n - len(gu)) <= max(2, 0.02 * len(gu))
