"""The benchmark of hesaff_tpu_torch: one cell, one seed, one run.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                            --trace <0|1>

Runs from the root of a checkout.  The cell's file
(workloads/<cell>.json) names its configuration (configs/<name>.json),
its traffic and its driver (drivers/<driver>.py); BENCHMARK.json names
the metrics the cell reports, each read by metrics/<metric>.py.  With
--trace 0 they are the cell's end-to-end metrics, with --trace 1 its
per-layer metrics, read from torch.profiler over the window's first
`traced_calls` calls.

The run needs the cards the cell asks for: without them it prints no
result and exits 2.  After the window it reads the peak memory, frees
the program's cached blocks, and judges a seeded sample of the window's
answers against the plain reference (the driver's judge); each compared
number is printed with its limit as the last lines on standard error
and, under "checks", last in the result line, the last line of standard
output.  It exits 3 without a result if JAX, jaxlib, flax or the JAX
package was loaded.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

HERE = harness.HERE


def cell_metrics(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics BENCHMARK.json has this cell report: its end-to-end
    ones, or with `trace` its per-layer ones.  A metric without a
    `workloads` list is the cell's where the cell reports the metric it
    moves (per-layer) or always (end-to-end)."""
    def here(m):
        return workload in m["workloads"] if "workloads" in m else None

    e2e = [m for m in bench["end_to_end"] if here(m) is not False]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if here(m) or (here(m) is None and m["moves"] in names)]


def card_and_limit() -> str:
    """The card's name and power limit (nvidia-smi), or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        return f"not read ({exc.__class__.__name__})"


class Run:
    """What the metric readers read: the window's calls, its length,
    the set-up's seconds, the trace (or None), the cell and its
    configuration."""

    def __init__(self, window, setup_s, cell, config):
        self.calls = window.calls
        self.window_s = window.window_s
        self.trace = window.trace
        self.setup_s = setup_s
        self.cell, self.config = cell, config


def execute(workload: str, seed: int, seconds: float, trace: bool,
            device="cuda", overrides: dict | None = None,
            driver_hook=None) -> tuple[dict, list]:
    """One run in this process.  Returns (the result line's object, the
    checks as (name, value, limit)).

    overrides: as harness.load_cell takes them; driver_hook(driver) is
    called after set-up (tests plant faults there).
    """
    import torch

    bench, cell, config, traffic = harness.load_cell(workload, overrides)
    device = torch.device(device)
    driver = harness.make_driver(cell, config, traffic, seed, device)
    t_setup = time.perf_counter()
    driver.setup()
    t_setup = time.perf_counter() - t_setup
    if driver_hook is not None:
        driver_hook(driver)
    driver.sync()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - PROCESS_START
    print(f"setup {setup_s:.3f} s: the driver's {t_setup:.3f} s after "
          f"{setup_s - t_setup:.3f} s of imports and context",
          file=sys.stderr)
    window = harness.closed_loop(
        driver.call, seconds, traffic["sample_calls"], seed,
        traced_calls=traffic["traced_calls"] if trace else 0,
        work=driver.work, sync=driver.sync)
    q = max(1, len(window.calls) // 4)
    print("median call ms by quarter of the window: " + ", ".join(
        f"{1e3 * harness.quantile([c.t1 - c.t0 for c in part], 0.5):.3f}"
        for part in (window.calls[k:k + q]
                     for k in range(0, len(window.calls), q))),
        file=sys.stderr)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    finding = driver.finding(len(window.calls))
    card = card_and_limit() if device.type == "cuda" else "cpu"

    run = Run(window, setup_s, cell, config)
    metrics = {}
    for m in cell_metrics(bench, workload, trace):
        reader = harness.load_module(HERE / "metrics" / f"{m['name']}.py",
                                     "benchmark_metric_" + m["name"]
                                     .replace(".", "_").replace("-", "_"))
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings = driver.judge(window.sample)
    limits = cell["limits"]
    checks = [(k, readings[k], limits[k]) for k in limits]
    correct = (window.failed == 0 and bool(window.sample)
               and all(v <= lim for _, v, lim in checks))

    result = {
        "correct": correct,
        "attempted": len(window.calls),
        "failed": window.failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else "cpu",
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": 1,
            "memory_peak_bytes": peak,
        },
        "card": card,
        "seed": seed,
        **finding,
    }
    if window.trace is not None:
        t = window.trace
        result["device"]["busy_s"] = t.busy_us() / 1e6
        result["device"]["window_s"] = t.wall_s
        result["breakdown"] = {"device_ops": harness.device_ops(t),
                               "idle_gaps": harness.idle_gaps(t)}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, v, lim in checks}
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    cell = harness.load_json(HERE / "workloads" / f"{args.workload}.json")
    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA device(s), "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 2
    result, checks = execute(args.workload, args.seed, args.seconds,
                             bool(args.trace))
    found = harness.forbidden_modules()
    if found:
        print(f"no result: the process holds {found}", file=sys.stderr)
        return 3
    for k, v, lim in checks:
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
