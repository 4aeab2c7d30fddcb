"""Stage timing and traces.

Port of ``hesaff_tpu/utils/profiling.py`` on torch.profiler:

  * `StageTimes.stage(name)` times a pipeline stage on the host clock and
    opens a ``record_function`` span of that name, the kind of span
    dist.py opens around its stages, so a trace shows it.  The stage's
    device work may still run after it returns: synchronising before the
    stage ends is the caller's job.
  * `StageTimes.report()` lists wall ms per stage with derived rates.
  * `trace_to(logdir)` records a torch.profiler trace (CPU, and CUDA
    where a GPU is present) and writes it as a Chrome trace JSON file
    into logdir when the block ends, also when it raises.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile, record_function


class StageTimes:
    """Accumulates per-stage wall times across calls."""

    def __init__(self):
        self.times = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        with record_function(name):
            t0 = time.perf_counter()
            yield
            dt = time.perf_counter() - t0
        self.times[name] += dt
        self.counts[name] += 1

    def report(self, items_per_stage: dict | None = None) -> str:
        lines = []
        for name in sorted(self.times, key=self.times.get, reverse=True):
            line = (f"{name:24s} {self.times[name]*1e3:9.1f} ms "
                    f"({self.counts[name]}x)")
            if items_per_stage and name in items_per_stage:
                rate = items_per_stage[name] / max(self.times[name], 1e-9)
                line += f"  {rate:,.0f}/s"
            lines.append(line)
        return "\n".join(lines)


@contextlib.contextmanager
def trace_to(logdir: str):
    """torch.profiler trace of the block, written to
    <logdir>/trace-<pid>-<ns>.json (Chrome trace format) at its end.
    Yields the profiler."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
