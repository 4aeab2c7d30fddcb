"""Spans, counters and traces on torch.profiler's clock.

  * `tracing()`: whether torch.profiler is recording.
  * `span(name)`: a ``record_function`` span of that name while tracing,
    a shared null context otherwise (a fraction of a microsecond, where
    a ``record_function`` costs ~10 us even with no profiler running).
    The program's spans are all opened through it, so kineto stamps
    them on the clock of the device events of the same trace.  Names
    starting with ``sync: `` hold one blocking device-to-host point
    each: their count is the number of host syncs.
  * `counter(name, device)`: a (1,) int64 tensor on the device that
    the program adds into while tracing (``k4_steps``: the Baumberg steps
    K4 ran; ``sparse_candidates``: the candidates the sparse detection
    path walked; ``pair_queries``, ``pair_tentative``: the query x
    database rows of the sequential matcher's 2-NN calls and its
    tentative matches; ``ransac_residuals``: hypotheses x matches that
    RANSAC scored); `counters()` reads every total (that read
    synchronises).  Code that counts asks `counted(name, device)` for
    the tensor to add into: the counter while tracing, None otherwise,
    and while a CUDA graph is captured (`counting_into`) a tensor of the
    graph's own, which utils/graphs adds into the counter after each
    replay that runs while tracing.
  * `trace_to(logdir)` records a torch.profiler trace (CPU, and CUDA
    where a GPU is present) and writes it as a Chrome trace JSON file
    into logdir when the block ends, also when it raises.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

_OFF = contextlib.nullcontext()

# name -> device -> (1,) int64 tensor
_COUNTERS: dict[str, dict[torch.device, torch.Tensor]] = {}


def tracing() -> bool:
    """Whether torch.profiler is recording in this process."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str):
    """A profiler span called `name` while tracing, else a no-op."""
    return record_function(name) if tracing() else _OFF


def counter(name: str, device) -> torch.Tensor:
    """The (1,) int64 tensor on `device` that counter `name` adds into,
    zero when first asked for."""
    dev = torch.device(device)
    per = _COUNTERS.setdefault(name, {})
    if dev not in per:
        per[dev] = torch.zeros(1, dtype=torch.int64, device=dev)
    return per[dev]


# the store of counting_into, per thread (a graph captures on one)
_capturing = threading.local()


def counted(name: str, device):
    """The (1,) int64 tensor to add counter `name` into now, or None
    where nothing counts: the process's counter while tracing; inside
    counting_into, the store's tensor (made zero where first asked for),
    whether tracing or not."""
    store = getattr(_capturing, "store", None)
    if store is None:
        return counter(name, device) if tracing() else None
    if name not in store:
        store[name] = torch.zeros(1, dtype=torch.int64, device=device)
    return store[name]


@contextlib.contextmanager
def counting_into(store: dict):
    """While the block runs in this thread, counted() hands out the
    tensors of `store` (name -> (1,) int64), each set to zero first."""
    for t in store.values():
        t.zero_()
    prev = getattr(_capturing, "store", None)
    _capturing.store = store
    try:
        yield store
    finally:
        _capturing.store = prev


def counters() -> dict[str, int]:
    """Each counter's total over its devices (synchronises)."""
    return {name: sum(int(t.item()) for t in per.values())
            for name, per in _COUNTERS.items()}


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
