"""The PyTorch port imports neither JAX nor the JAX package, a CPU run
launches no kernel, and an entry point given no device runs on the GPU
or raises: extraction, matching, RANSAC and retrieval alike."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"         # any `import jax` now fails
        "sys.modules['hesaff_tpu'] = None\n"  # and any import of the package
        "import hesaff_tpu_torch, hesaff_tpu_torch.batch\n"
        "from hesaff_tpu_torch import dist, params, patches, sift\n"
        "from hesaff_tpu_torch.ops import cuda_affine, cuda_blur, "
        "cuda_build, cuda_detect, cuda_patches, cuda_sift, masks\n"
        "from hesaff_tpu_torch import sift_io, native, match, evaluate, "
        "ransac, retrieval, cli\n"
        "assert 'jaxlib' not in sys.modules\n"
        "assert not [m for m in sys.modules if m.startswith('hesaff_tpu.')]\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_cpu_run_launches_no_kernel(golden_small):
    from hesaff_tpu_torch import extract
    from hesaff_tpu_torch.ops import (cuda_affine, cuda_blur, cuda_detect,
                                      cuda_patches, cuda_sift)

    mods = (cuda_blur, cuda_detect, cuda_affine, cuda_patches, cuda_sift)
    count = lambda: [m.LAUNCHES for m in mods] + [cuda_detect.MAPS_LAUNCHES]
    before = count()
    feats = extract(golden_small["gray"][:96, :80], device="cpu")
    assert feats.n > 0
    assert count() == before == [0] * (len(mods) + 1)
    assert np.isfinite(feats.x).all()


def test_extract_without_device_needs_a_gpu():
    from hesaff_tpu_torch import extract

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: extract() runs on it")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        extract(np.zeros((64, 64), np.float32))


def _no_device_calls():
    from hesaff_tpu_torch import evaluate, match, ransac, retrieval

    rng = np.random.default_rng(0)
    desc = rng.integers(0, 256, (20, 128)).astype(np.uint8)
    pts = rng.random((20, 2)) * 100
    ell = np.tile([10.0, 10.0, 0.01, 0.0, 0.01], (20, 1))
    return {
        "match_descriptors": lambda: match.match_descriptors(desc, desc),
        "knn2": lambda: match.knn2(desc, desc),
        "ransac_homography": lambda: ransac.ransac_homography(pts, pts),
        "ransac_fundamental": lambda: ransac.ransac_fundamental(pts, pts),
        "rank_images": lambda: retrieval.rank_images(
            retrieval.build_index([desc, desc]), desc),
        "repeatability": lambda: evaluate.repeatability(
            ell, ell, np.eye(3), (50, 50), desc, desc),
    }


@pytest.mark.parametrize("entry", ["match_descriptors", "knn2",
                                   "ransac_homography", "ransac_fundamental",
                                   "rank_images", "repeatability"])
def test_downstream_without_device_needs_a_gpu(entry):
    """Numpy input and no device: the GPU, or the device="cpu" error."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry point runs on it")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _no_device_calls()[entry]()
