"""The PyTorch port imports neither JAX nor the JAX package, a CPU run
launches no kernel, and an entry point given no device runs on the GPU
or raises: extraction, matching, RANSAC, retrieval, the fleet, SfM and
the multi-device entry points alike (init_multihost's NCCL backend
raises without a CUDA device, before it contacts the coordinator)."""

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
        "ransac, retrieval, cli, sfm\n"
        "from hesaff_tpu_torch.utils import fleet, profiling\n"
        "from hesaff_tpu_torch.geom import ba, posegraph, se3\n"
        "from hesaff_tpu_torch import comm\n"
        "from hesaff_tpu_torch.dist import (PipelinedExtractor, "
        "default_bucket_spec, extraction_step, extraction_step_staged, "
        "host_shard, init_multihost, make_mesh, sharded_extraction_step)\n"
        "from hesaff_tpu_torch.match import ring_knn2\n"
        "from hesaff_tpu_torch.retrieval import sharded_query_votes\n"
        "from hesaff_tpu_torch.utils.fleet import barrier_group, "
        "host_barrier\n"
        "assert ba.ba_solve_sharded and host_shard(range(3)) == [0, 1, 2]\n"
        "assert 'jaxlib' not in sys.modules\n"
        "assert not [m for m in sys.modules if m.startswith('hesaff_tpu.')]\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


_TOOL_RUNS = {
    # a tiny run of each tool's path on the CPU (the retrieval tool's
    # main, its JSON line included), so the modules it imports lazily
    # are imported too
    "torch_retrieval_bench": (
        "import contextlib, io, json\n"
        "buf = io.StringIO()\n"
        "with contextlib.redirect_stdout(buf):\n"
        "    tool.main(['--n', '4', '--queries', '1', '--batch', '4',"
        " '--width', '64', '--height', '52', '--cap', '32',"
        " '--device', 'cpu'])\n"
        "rec = json.loads(buf.getvalue().strip().splitlines()[-1])\n"
        "assert rec['corpus'] == 4 and rec['corpus_s'] > 0\n"),
    "torch_fleet_bench": (
        "p = os.path.join(sys.argv[1], 'a.png')\n"
        "tool.write_png_gray(p, np.full((52, 64), 9, np.uint8))\n"
        "rec = tool.run([p], os.path.join(sys.argv[1], 'out'), 1, 'cpu')\n"
        "assert rec['images'] == 1\n"),
}


@pytest.mark.parametrize("tool", sorted(_TOOL_RUNS))
def test_tools_import_without_jax(tool, tmp_path):
    """tools/torch_retrieval_bench.py and tools/torch_fleet_bench.py
    import neither JAX nor the JAX package, through a run of their
    path."""
    code = (
        "import os, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['hesaff_tpu'] = None\n"
        "import numpy as np\n"
        f"sys.path.insert(0, {os.path.join(ROOT, 'tools')!r})\n"
        f"import {tool} as tool\n"
        + _TOOL_RUNS[tool] +
        "assert 'jaxlib' not in sys.modules\n"
        "assert not [m for m in sys.modules if m.startswith('hesaff_tpu.')]\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                       capture_output=True, text=True, env=env, timeout=300,
                       cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
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
    from hesaff_tpu_torch import (dist, evaluate, match, ransac, retrieval,
                                  sfm)
    from hesaff_tpu_torch.config import HesaffConfig

    rng = np.random.default_rng(0)
    desc = rng.integers(0, 256, (20, 128)).astype(np.uint8)
    pts = rng.random((20, 2)) * 100
    ell = np.tile([10.0, 10.0, 0.01, 0.0, 0.01], (20, 1))
    imgs = np.zeros((2, 64, 64), np.float32)
    cfg = HesaffConfig()
    buckets = dist.default_bucket_spec(64, 64, cfg, batch=2)
    return {
        "extraction_step": lambda: dist.extraction_step(imgs, cfg, buckets),
        "sharded_extraction_step": lambda: dist.sharded_extraction_step(
            None, cfg, buckets)(imgs),
        "PipelinedExtractor": lambda: dist.PipelinedExtractor(cfg, buckets),
        "init_multihost": lambda: dist.init_multihost(
            "localhost:1", 1, 0, backend="nccl"),
        "match_descriptors": lambda: match.match_descriptors(desc, desc),
        "knn2": lambda: match.knn2(desc, desc),
        "ransac_homography": lambda: ransac.ransac_homography(pts, pts),
        "ransac_fundamental": lambda: ransac.ransac_fundamental(pts, pts),
        "rank_images": lambda: retrieval.rank_images(
            retrieval.build_index([desc, desc]), desc),
        "repeatability": lambda: evaluate.repeatability(
            ell, ell, np.eye(3), (50, 50), desc, desc),
        "pnp_ransac": lambda: sfm.pnp_ransac(
            np.c_[pts, pts[:, :1] + 5.0], pts / 100.0),
        "triangulate_nview": lambda: sfm.triangulate_nview(
            np.zeros((2, 3)), np.eye(2, 3), pts[:2] / 100.0),
    }


@pytest.mark.parametrize("entry", ["match_descriptors", "knn2",
                                   "ransac_homography", "ransac_fundamental",
                                   "rank_images", "repeatability",
                                   "pnp_ransac", "triangulate_nview",
                                   "extraction_step",
                                   "sharded_extraction_step",
                                   "PipelinedExtractor", "init_multihost"])
def test_downstream_without_device_needs_a_gpu(entry):
    """Numpy input and no device: the GPU, or the device="cpu" error
    (init_multihost: the nccl backend's, naming backend="gloo")."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry point runs on it")
    error = ('backend="gloo"' if entry == "init_multihost"
             else 'device="cpu"')
    with pytest.raises(RuntimeError, match=error):
        _no_device_calls()[entry]()
    assert not torch.distributed.is_initialized()
