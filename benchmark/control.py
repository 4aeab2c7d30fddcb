"""Readings of the program and of the control, for setting limits.

    python benchmark/control.py --workload <cell> --seeds 1,2,3
                                [--calls N] [--control 0|1]

For each seed, in this process: the cell's set-up, N calls at its own
load (N defaults to the cell's sample_calls, as many as a run
compares), then the driver's judgement of those calls' answers against
the float32 reference (the program's readings) and, with --control 1,
of the reference in the precision below float32 (reference/precision.py)
put in the program's place (the control's
readings).  One JSON line a seed.  The benchmark's own runs do not run
this; a limit lies between the largest program reading over a dozen
seeds or more and the smallest control reading.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402


def readings(workload: str, seed: int, calls: int | None, control: bool,
             device="cuda", overrides: dict | None = None) -> dict:
    import torch

    _, cell, config, traffic = harness.load_cell(workload, overrides)
    t0 = time.perf_counter()
    driver = harness.make_driver(cell, config, traffic, seed,
                                 torch.device(device))
    driver.setup()
    n = calls or traffic["sample_calls"]
    base = traffic["warmup_calls"]
    sample = [(base + i, driver.call(base + i)[1]) for i in range(n)]
    t1 = time.perf_counter()
    out = {"seed": seed, "calls": n, "program": driver.judge(sample)}
    t2 = time.perf_counter()
    if control:
        out["control"] = driver.judge(sample, control=True)
    out["seconds"] = {"setup_and_calls": t1 - t0, "judge": t2 - t1,
                      "control": time.perf_counter() - t2}
    del driver, sample
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--calls", type=int, default=None)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    for s in args.seeds.split(","):
        print(json.dumps(readings(args.workload, int(s), args.calls,
                                  bool(args.control))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
