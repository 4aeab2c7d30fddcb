"""The benchmark's machinery, shared by every cell.

A run: the driver's set-up (inputs from the seed, warm-up of the cell's
shapes), a closed-loop window of ``--seconds`` on the host clock, the
device's peak memory, then the driver's judgement of a sample of the
window's answers against the plain reference, and one result line.
With ``--trace 1`` the first ``traced_calls`` calls of the window run
under torch.profiler, and the per-layer metrics are read from that
trace by the readers in ``metrics/``.

Nothing here names a cell, a configuration or a metric: they are found
by name in ``BENCHMARK.json``, ``configs/``, ``workloads/``,
``drivers/`` and ``metrics/``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import random
import sys
import time
from pathlib import Path
from typing import Callable

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# top-level module names the benchmark's process must not hold once the
# window has closed: JAX, its libraries and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "hesaff_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, overrides: dict | None = None):
    """(BENCHMARK.json, the cell's file, its configuration, its traffic)
    of a cell.  overrides: {"traffic": {...}, <config key>: {...} or a
    value} merged into the traffic and the configuration (tests run a
    cell at a small size)."""
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = load_json(HERE / "workloads" / f"{workload}.json")
    config = load_json(HERE / "configs" / f"{cell['config']}.json")
    traffic = dict(cell["traffic"])
    for k, v in (overrides or {}).items():
        if k == "traffic":
            traffic.update(v)
        elif isinstance(v, dict):
            config[k] = {**config.get(k, {}), **v}
        else:
            config[k] = v
    return bench, cell, config, traffic


def make_driver(cell: dict, config: dict, traffic: dict, seed: int, device):
    """The cell's driver (drivers/<driver>.py), not yet set up."""
    mod = load_module(HERE / "drivers" / f"{cell['driver']}.py",
                      f"benchmark_driver_{cell['driver']}")
    return mod.Driver(config, traffic, seed, device)


def load_module(path: Path, name: str):
    """The Python file `path` as a module named `name` (file names of
    metrics carry dots, so they are loaded by path)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """FORBIDDEN names that sys.modules holds, compared as whole
    top-level names (hesaff_tpu_torch is not hesaff_tpu)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


@dataclasses.dataclass
class Call:
    """One call of the closed loop: host-clock start and end (seconds)
    and the items it finished (images or queries)."""

    t0: float
    t1: float
    items: int


@dataclasses.dataclass
class Trace:
    """The profiled calls: device intervals (kernels, copies and sets,
    microseconds on the profiler's clock), host spans (name, start,
    end), the host-clock wall of the calls, and what the driver counted
    of their work."""

    calls: int
    wall_s: float
    device: list            # [(name, start_us, end_us)]
    spans: list             # [(name, start_us, end_us)]
    work: list              # one dict a traced call, from the driver

    def busy_us(self, lo: float = -math.inf, hi: float = math.inf) -> float:
        """Microseconds in [lo, hi] in which the device ran anything:
        the union of its intervals."""
        return union_us([(max(a, lo), min(b, hi)) for _, a, b in self.device
                         if b > lo and a < hi])

    def device_us(self, names) -> float:
        """Summed duration of the device intervals whose name contains
        one of `names`."""
        return sum(b - a for n, a, b in self.device
                   if any(s in n for s in names))

    def span_total_us(self, prefixes) -> float:
        """Summed host duration of the spans whose name starts with one
        of `prefixes`."""
        return sum(b - a for n, a, b in self.spans
                   if n.startswith(tuple(prefixes)))

    def busy_in_spans_us(self, name: str) -> float:
        """Device busy time inside each span called `name`, summed."""
        return sum(self.busy_us(a, b) for n, a, b in self.spans if n == name)


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(iv for iv in intervals if iv[1] > iv[0]):
        if a > end:
            total, end = total + b - a, b
        elif b > end:
            total, end = total + b - end, b
    return total


def idle_gaps(trace: Trace, top: int = 10) -> list:
    """Idle time of the device between its busy intervals, summed by
    the innermost host span open at each gap's midpoint."""
    merged = []
    for a, b in sorted((a, b) for _, a, b in trace.device if b > a):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    by = {}
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        mid = 0.5 * (e0 + s1)
        open_ = [(a, n) for n, a, b in trace.spans if a <= mid <= b]
        label = max(open_)[1] if open_ else "(no span)"
        by[label] = by.get(label, 0.0) + (s1 - e0) / 1e6
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]


def device_ops(trace: Trace, top: int = 10) -> list:
    """Device seconds by operation name, the largest first."""
    by = {}
    for n, a, b in trace.device:
        by[n] = by.get(n, 0.0) + (b - a) / 1e6
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]


def parse_profile(prof) -> tuple[list, list]:
    """(device intervals, host spans) of a finished torch.profiler run,
    in microseconds from the first event.

    Device: every event on the CUDA side (kernels, copies, sets).
    Host spans: record_function ranges, the program's ("phase A",
    "group N: ...", "SIFT") and the benchmark's own.  Read from the
    profiler's flat event list (prof.events() builds a tree of every
    host op first, a minute for the query cell's ~10^5 launches).
    """
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    t0 = min((e.start_ns() for e in events), default=0)
    device, spans = [], []
    for e in events:
        a, b = (e.start_ns() - t0) / 1e3, (e.end_ns() - t0) / 1e3
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((e.name(), a, b))
        elif e.is_user_annotation():
            spans.append((e.name(), a, b))
    return device, spans


class Reservoir:
    """A uniform sample of at most k items of a stream, drawn from a
    seed (algorithm R)."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen, self.items = k, random.Random(seed), 0, []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = item


@dataclasses.dataclass
class Window:
    """What the closed loop measured."""

    calls: list             # [Call]
    window_s: float
    failed: int
    sample: list            # the reservoir's (index, answer) pairs
    trace: Trace | None


def closed_loop(call: Callable[[int], tuple], seconds: float, sample_k: int,
                seed: int, traced_calls: int = 0,
                work: Callable[[int, object], dict] | None = None,
                sync: Callable[[], None] = lambda: None) -> Window:
    """Call `call(i)` back to back for `seconds` on the host clock.

    call(i) returns (items finished, answer); answers go through a
    seeded reservoir of sample_k.  With traced_calls > 0 the first
    traced_calls calls run under torch.profiler (sync() is called before
    it starts and after it stops) and `work(i, answer)` records what
    each traced call did, for the roofline readers.
    """
    res = Reservoir(sample_k, seed)
    calls, failed, trace = [], 0, None
    i = 0

    def one():
        nonlocal i, failed
        t0 = time.perf_counter()
        try:
            items, answer = call(i)
        except RuntimeError as exc:
            print(f"call {i} failed: {exc!r}", file=sys.stderr)
            failed += 1
            items, answer = 0, None
        t1 = time.perf_counter()
        calls.append(Call(t0, t1, items))
        if answer is not None:
            res.offer((i, answer))
        i += 1
        return answer

    start = time.perf_counter()
    if traced_calls:
        from torch.profiler import ProfilerActivity, profile

        sync()
        answers = []
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(traced_calls):
                answers.append(one())
            sync()
        wall = calls[-1].t1 - calls[0].t0
    while time.perf_counter() - start < seconds:
        one()
    if traced_calls:
        device, spans = parse_profile(prof)
        works = [work(k, a) if a is not None else {}
                 for k, a in enumerate(answers)]
        trace = Trace(traced_calls, wall, device, spans, works)
    return Window(calls=calls, window_s=calls[-1].t1 - start, failed=failed,
                  sample=res.items, trace=trace)


def quantile(values, q: float) -> float:
    """The q-quantile of all values (linear between order statistics,
    numpy's default), q in [0, 1]."""
    v = sorted(values)
    if not v:
        return math.nan
    pos = q * (len(v) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)

