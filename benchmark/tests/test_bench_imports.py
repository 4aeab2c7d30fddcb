"""What the benchmark loads: never JAX, jaxlib, flax or the JAX package,
and the reference nothing of the port either.  Names are compared as
whole top-level names: hesaff_tpu_torch begins with hesaff_tpu."""

import json
import os
import subprocess
import sys

from benchmark import harness

ROOT = harness.ROOT

LOAD_ALL = """
import json, sys
sys.path.insert(0, {root!r})
from pathlib import Path
from benchmark import harness
import benchmark.run, benchmark.control, benchmark.imagery, benchmark.features
for sub in ("drivers", "metrics"):
    for p in sorted((harness.HERE / sub).glob("*.py")):
        harness.load_module(p, "x_" + p.stem.replace(".", "_"))
import benchmark.reference.knn2, benchmark.reference.compare
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

LOAD_REFERENCE = """
import json, pkgutil, importlib, sys
sys.path.insert(0, {root!r})
import benchmark.reference as r
for m in pkgutil.walk_packages(r.__path__, "benchmark.reference."):
    importlib.import_module(m.name)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def tops(code: str) -> set:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    loaded = tops(LOAD_ALL)
    assert "benchmark" in loaded and "torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "hesaff_tpu"}


def test_the_reference_loads_nothing_of_the_port():
    loaded = tops(LOAD_REFERENCE)
    assert not loaded & {"jax", "jaxlib", "flax", "hesaff_tpu",
                         "hesaff_tpu_torch"}


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "hesaff_tpu_torch_fake", object())
    assert "hesaff_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "hesaff_tpu.batch", object())
    assert "hesaff_tpu" in harness.forbidden_modules()


def test_run_exits_without_a_card_and_prints_no_result():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "oxford_affine_800x640.batch16", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_fails_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark,
    a run (the look for a card skipped) fails at the program's import."""
    import shutil

    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("import sys; sys.path.insert(0, '.'); from benchmark import run; "
            "run.execute('oxford_affine_800x640.batch16', 1, 1.0, False, "
            "device='cpu')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "hesaff_tpu_torch" in out.stderr
