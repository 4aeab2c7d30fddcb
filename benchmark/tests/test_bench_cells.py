"""Each cell end to end on the CPU at a small size, with the port's
plain versions, and a new cell taken up from its files alone."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from bench_sizes import BATCH, QUERY, SMALL
from benchmark import harness
from benchmark import run as bench_run

SEED = 2**31 + 17


@pytest.mark.parametrize("cell", [BATCH, QUERY])
def test_cell_end_to_end(cell):
    result, checks = bench_run.execute(cell, SEED, 1.0, False, device="cpu",
                                       overrides=SMALL[cell])
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 1
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    want = {m["name"] for m in bench_run.cell_metrics(bench, cell, False)}
    assert set(result["metrics"]) == want
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == set(
        harness.load_json(harness.HERE / "workloads" / f"{cell}.json")
        ["limits"])
    assert all(v <= lim for _, v, lim in checks)


@pytest.mark.parametrize("cell,span_metric", [
    (BATCH, "phase_a_host_ms.batch16"), (QUERY, "extract_ms.query")])
def test_cell_traced(cell, span_metric):
    result, _ = bench_run.execute(cell, SEED, 0.5, True, device="cpu",
                                  overrides=SMALL[cell])
    assert result["correct"] is True
    # the CPU has no device trace: only the host spans' metrics read
    assert span_metric in result["metrics"]
    assert not any("roofline" in k for k in result["metrics"])
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_new_cell_is_taken_up_from_its_files(tmp_path):
    """A cell added as a workload file and an entry in BENCHMARK.json
    runs with no edit of the harness."""
    root = harness.ROOT
    shutil.copytree(root / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.load_json(root / "BENCHMARK.json")
    cell = harness.load_json(root / "benchmark" / "workloads" /
                             f"{BATCH}.json")
    cell["traffic"].update(batch=1, pool=2, warmup_calls=1, sample_calls=1)
    name = "oxford_affine_800x640.single"
    (tmp_path / "benchmark" / "workloads" / f"{name}.json").write_text(
        json.dumps(cell))
    bench["workloads"].append({"name": name,
                               "config": "oxford_affine_800x640",
                               "traffic": "single", "chips": 1,
                               "why": "one image a call"})
    for m in bench["end_to_end"]:
        if "img_per_s" == m["name"]:
            m["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys, json; sys.path.insert(0, sys.argv[1]);"
        "from benchmark import run;"
        "r, _ = run.execute(sys.argv[2], 3, 0.5, False, device='cpu',"
        " overrides={'image': {'width': 96, 'height': 80}});"
        "print(json.dumps(r))")
    env = dict(os.environ, PYTHONPATH=str(root))
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path), name],
                         capture_output=True, text=True, env=env,
                         timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True
    assert set(r["metrics"]) == {"img_per_s", "setup_s"}
