"""The port's own HesaffConfig and masks equal the JAX package's."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from hesaff_tpu import config as jconfig
from hesaff_tpu.ops import masks as jmasks
from hesaff_tpu_torch import config
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
                "config", "batch", "pipeline"):
        assert f"hesaff_tpu_torch.{mod}" in names
