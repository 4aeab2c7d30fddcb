"""The host syncs of one call of a benchmark cell, on the card.

    python3 tools/torch_sync_sites.py [--cell NAME ...] [--seed N]
                                      [--out FILE]

Sets up each cell as benchmark/run.py does (its inputs and its
warm-up), then runs one more call under torch.profiler and
torch.cuda.set_sync_debug_mode("warn").  Each synchronising operation
that PyTorch reports is put down to the innermost frame of
hesaff_tpu_torch/ on its Python stack (or counted as the benchmark's
own where there is none) and to the innermost profiler span open at
the time; the program's "sync: " spans of the same call are counted.
A site whose span does not start with "sync: " is a sync that no span
names.  Prints one JSON line a cell, and writes them all to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback
import warnings
from collections import Counter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.sep + "hesaff_tpu_torch" + os.sep
CELLS = ("oxford_affine_800x640.batch16", "oxford5k_1024x768.query",
         "eth3d_6048x4032.batch2")


def span_stack():
    """A list that holds the names of the open record_function spans,
    innermost last, from now on."""
    from torch.autograd.profiler import record_function

    stack = []
    enter, leave = record_function.__enter__, record_function.__exit__

    def _enter(self):
        stack.append(self.name)
        return enter(self)

    def _exit(self, *exc):
        stack.pop()
        return leave(self, *exc)

    record_function.__enter__, record_function.__exit__ = _enter, _exit
    return stack


def one_call(cell, i: int, stack: list) -> dict:
    """The syncs of cell.call(i): PyTorch's reports by site and span,
    and the count of the program's sync spans."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark import harness

    sites = Counter()
    outside = Counter()
    show = warnings.showwarning

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return show(message, category, filename, lineno, file, line)
        frames = [f for f in traceback.extract_stack()[:-1]
                  if PKG in f.filename]
        where = stack[-1] if stack else "(no span)"
        if not frames:
            outside[where] += 1
            return None
        f = frames[-1]
        path = os.path.relpath(f.filename, ROOT)
        caller = (f"{os.path.relpath(frames[-2].filename, ROOT)}:"
                  f"{frames[-2].lineno}" if len(frames) > 1 else "")
        sites[(f"{path}:{f.lineno}", f.line or "", caller, where)] += 1
        return None

    cell.sync()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.set_sync_debug_mode("warn")
            try:
                cell.call(i)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            cell.sync()
    _, spans = harness.parse_profile(prof)
    n_spans = sum(1 for n, _, _ in spans if n.startswith("sync: "))
    rows = [dict(site=s, code=c.strip(), caller=k, span=w, count=n)
            for (s, c, k, w), n in sorted(sites.items())]
    reported = sum(sites.values())
    return dict(reported=reported, sync_spans=n_spans,
                unnamed=sum(r["count"] for r in rows
                            if not r["span"].startswith("sync: ")),
                sites=rows, benchmark_syncs=dict(outside))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", action="append", choices=CELLS)
    ap.add_argument("--seed", type=int, default=2**31 + 99)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "sync_sites.json"))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        raise SystemExit("torch_sync_sites: needs a CUDA device")
    stack = span_stack()
    lines = []
    for name in args.cell or CELLS:
        _, spec, config, traffic = harness.load_cell(name)
        cell = harness.make_driver(spec, config, traffic, args.seed,
                                   torch.device("cuda"))
        cell.setup()
        rec = dict(cell=name, seed=args.seed,
                   **one_call(cell, traffic["warmup_calls"], stack))
        print(json.dumps(rec), flush=True)
        lines.append(rec)
        del cell
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        f.write("".join(json.dumps(r) + "\n" for r in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
