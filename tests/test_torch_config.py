"""The port's own HesaffConfig and masks, and its copies of the JAX
package's numpy-only code (the Oxford export's ellipse and number
formatting, the overlap scorer, the PNM fallback), equal the JAX
package's on seeded inputs."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from hesaff_tpu import config as jconfig
from hesaff_tpu import evaluate as jevaluate
from hesaff_tpu import sift_io as jsift_io
from hesaff_tpu.ops import masks as jmasks
from hesaff_tpu_torch import config, evaluate, sift_io
from hesaff_tpu_torch.ops import masks

_DERIVED = ("final_threshold", "positive_threshold", "negative_threshold",
            "edge_score_threshold", "sigma_step", "min_octave_size")


@pytest.mark.parametrize("name", ["DEFAULT_CONFIG", "FAST_CONFIG",
                                  "replaced"])
def test_config_matches_jax(name):
    if name == "replaced":
        kw = dict(threshold=4.0, num_scales=4, upscale_input=True,
                  candidate_cap_div=64, affine_cap_div=96)
        mine = dataclasses.replace(config.DEFAULT_CONFIG, **kw)
        ref = dataclasses.replace(jconfig.DEFAULT_CONFIG, **kw)
    else:
        mine, ref = getattr(config, name), getattr(jconfig, name)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert ([f.name for f in dataclasses.fields(mine)]
            == [f.name for f in dataclasses.fields(ref)])
    assert config.HesaffConfig(**dataclasses.asdict(ref)) == mine
    for prop in _DERIVED:
        assert getattr(mine, prop) == getattr(ref, prop), prop
    for h, w in ((640, 800), (160, 128), (13, 13), (3000, 2000)):
        assert mine.num_octaves(h, w) == ref.num_octaves(h, w)
        assert (mine.octave_candidate_capacity(h, w)
                == ref.octave_candidate_capacity(h, w))
        for octave in range(4):
            assert (mine.level_capacity(h, w, octave)
                    == ref.level_capacity(h, w, octave))
            assert (mine.affine_capacity(h, w, octave)
                    == ref.affine_capacity(h, w, octave))


@pytest.mark.parametrize("size", [19, 41, 7])
def test_masks_match_jax(size):
    np.testing.assert_array_equal(masks.smm_gauss_mask(size),
                                  jmasks.smm_gauss_mask(size))
    np.testing.assert_array_equal(masks.circular_gauss_mask(size),
                                  jmasks.circular_gauss_mask(size))
    for bins in (4, 3):
        np.testing.assert_array_equal(masks.sift_spatial_bins(size, bins),
                                      jmasks.sift_spatial_bins(size, bins))


def test_every_port_module_imports_without_the_jax_package():
    """Each module of the package, found by walking it, imports with
    `jax` and `hesaff_tpu` blocked."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['hesaff_tpu'] = None\n"
        "import hesaff_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    hesaff_tpu_torch.__path__, 'hesaff_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "print(' '.join(sorted(names)))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=dict(os.environ, PYTHONPATH=root),
                       timeout=300, cwd=root)
    assert r.returncode == 0, r.stderr
    names = set(r.stdout.split())
    for mod in ("dist", "ops.cuda_patches", "ops.cuda_sift", "ops.masks",
                "config", "batch", "pipeline", "sift_io", "native", "match",
                "evaluate", "ransac", "retrieval", "cli", "sfm",
                "utils.fleet", "utils.profiling", "geom.se3", "geom.ba",
                "geom.posegraph"):
        assert f"hesaff_tpu_torch.{mod}" in names


def _random_ellipses(rng, n, spread=40.0):
    """(n, 5) [u, v, a, b, c] rows of positive-definite shapes, radii
    2-30 px, centres within `spread` px."""
    th = rng.uniform(0, np.pi, n)
    r1 = np.exp(rng.uniform(np.log(2.0), np.log(30.0), n))
    r2 = r1 * rng.uniform(0.2, 1.0, n)
    c, s = np.cos(th), np.sin(th)
    a = c * c / r1 ** 2 + s * s / r2 ** 2
    b = c * s * (1 / r1 ** 2 - 1 / r2 ** 2)
    cc = s * s / r1 ** 2 + c * c / r2 ** 2
    return np.stack([rng.uniform(0, spread, n), rng.uniform(0, spread, n),
                     a, b, cc], 1)


@pytest.mark.parametrize("seed", [0, 1])
def test_export_copies_match_jax(seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(0, 1, (4, 500))
    s = rng.uniform(1, 40, 500)
    for mine, ref in zip(sift_io.ellipse_abc(*a, s, 5.196),
                         jsift_io.ellipse_abc(*a, s, 5.196)):
        np.testing.assert_array_equal(mine, ref)
    vals = np.concatenate([rng.normal(0, 1e3, 200), rng.normal(0, 1e-4, 200),
                           np.float32(rng.normal(0, 300, 200)),
                           [0.0, -0.0, 1e-7, 123456.5, 1e21]])
    assert ([sift_io.format_float(float(v)) for v in vals]
            == [jsift_io.format_float(float(v)) for v in vals])


@pytest.mark.parametrize("seed", [0, 1])
def test_overlap_scorer_copies_match_jax(seed):
    rng = np.random.default_rng(seed)
    e1, e2 = _random_ellipses(rng, 60), _random_ellipses(rng, 70)
    for normalize in (True, False):
        np.testing.assert_array_equal(
            evaluate._overlap_matrix(e1, e2, normalize),
            jevaluate._overlap_matrix(e1, e2, normalize))
    E = lambda e: np.stack([np.stack([e[:, 2], e[:, 3]], -1),
                            np.stack([e[:, 3], e[:, 4]], -1)], 1)
    p1, p2 = e1[:50], e2[:50]
    for fn in ("_pair_overlap", "_pair_overlap_exact"):
        np.testing.assert_array_equal(
            getattr(evaluate, fn)(p1, E(p1), p2, E(p2), True),
            getattr(jevaluate, fn)(p1, E(p1), p2, E(p2), True))
    H = np.array([[1.05, 0.1, 3.0], [-0.08, 0.97, -2.0], [1e-4, 2e-4, 1.0]])
    np.testing.assert_array_equal(evaluate._project_ellipses(e1, H),
                                  jevaluate._project_ellipses(e1, H))


@pytest.mark.parametrize("magic,comment", [(b"P6", b""), (b"P5", b""),
                                           (b"P6", b"# made by a test\n")])
def test_pnm_fallback_copy_matches_jax(tmp_path, magic, comment):
    rng = np.random.default_rng(len(comment) + len(magic))
    ch = 3 if magic == b"P6" else 1
    pix = rng.integers(0, 256, (13, 17, ch)).astype(np.uint8)
    path = str(tmp_path / "img.pnm")
    with open(path, "wb") as f:
        f.write(magic + b"\n" + comment + b"17 13\n255\n" + pix.tobytes())
    np.testing.assert_array_equal(sift_io._load_pnm_gray(path),
                                  jsift_io._load_pnm_gray(path))
