"""CUDA graphs of a call's stages: capture once, then replay.

Phase A (batch.detect_affine_batch) runs each octave's stages through a
`Call` that `batch.PHASE_A.call(key, device)` hands out, in one of three
modes:

  * eager: each stage's Python runs and launches its kernels;
  * capture: each stage is captured into a CUDA graph of its own, in call
    order, into one private memory pool for the key, and replayed at
    once, so the capturing call returns what an eager call returns (no
    automatic garbage collection runs during a capture);
  * replay: each stage's graph is launched and none of its Python runs.

A key's first call runs eager: it loads the kernel libraries and CUDA
modules, sets the kernels' attributes and builds the constant tables,
none of which a capture may do.  Its second call captures and later
calls replay.  At most LRU_KEYS keys are held; the least recently used
one is dropped with its graphs and pool, once the device has finished
its last call.  A CPU tensor always runs eager.

Counters (utils/profiling): while a stage is captured, what it counts
(K4's steps) goes into tensors of its graph's own, zeroed by the graph
at each replay; a replay while torch.profiler records adds them into
the process's counters, so those grow in traced calls only, as eagerly.
Traced and untraced calls replay the same graphs, and torch.profiler
names each kernel a replay runs.

Stage inputs: a tensor made by an earlier stage of the same key is read
where the graph reads it; any other (the call's images, what a stage
run eager between two graphs makes) is copied into a buffer of the
graph's at each replay.  A stage's outputs are the graph's own and are
overwritten by the next replay, so what the call returns is copied out
(`Call.result`).  A graph also reads device tensors that no stage makes
and no argument passes (a kernel's constant table, cached elsewhere):
the caller names them (`holds`), and a key keeps what its capturing call
was given as long as it keeps its graphs, since a replay reads them at
the addresses of the capture.  One call of a key runs at a time (a lock),
and a call waits on the device for the previous call's copies out.

The kernel wrappers count their launches in Python, which a replay
skips: the caller names those counters (`launches`: (module, attribute)
pairs), and each graph adds what its capture added to them at every
replay.  SEGMENTS_CAPTURED / SEGMENTS_REPLAYED / SEGMENTS_EAGER count
the stages run each way in this process.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import threading

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from hesaff_tpu_torch.utils import profiling
from hesaff_tpu_torch.utils.profiling import span

# keys held at once (the least recently used one is dropped)
LRU_KEYS = 4
# stages run in this process: captured, replayed, run eager
SEGMENTS_CAPTURED = 0
SEGMENTS_REPLAYED = 0
SEGMENTS_EAGER = 0


def read_launches(launches) -> list:
    """The value of each (module, attribute) launch counter."""
    return [getattr(m, a) for m, a in launches]


def add_launches(launches, delta) -> None:
    """Add delta[i] to the i-th (module, attribute) launch counter."""
    for (m, a), d in zip(launches, delta):
        setattr(m, a, getattr(m, a) + d)


def segment_counts() -> dict:
    """The stages run each way in this process so far."""
    return {"captured": SEGMENTS_CAPTURED, "replayed": SEGMENTS_REPLAYED,
            "eager": SEGMENTS_EAGER}


_side_streams: dict = {}
# captures under way in this process, and whether the cyclic garbage
# collector ran before the first of them
_collection = {"held": 0, "was_on": False}
_collection_lock = threading.Lock()


@contextlib.contextmanager
def _no_collection():
    """No automatic garbage collection while the block runs (in any
    thread).  A collection inside a capture may free a dropped key that
    a reference cycle held (after an exception, say), and destroying its
    graphs while a stream captures invalidates the capture."""
    with _collection_lock:
        if _collection["held"] == 0:
            _collection["was_on"] = gc.isenabled()
            gc.disable()
        _collection["held"] += 1
    try:
        yield
    finally:
        with _collection_lock:
            _collection["held"] -= 1
            if _collection["held"] == 0 and _collection["was_on"]:
                gc.enable()


class CudaGraph:
    """One stage as a torch.cuda.CUDAGraph, captured on a side stream of
    its device into `pool`, replayed on the current stream."""

    def __init__(self, pool, device):
        self._graph = torch.cuda.CUDAGraph()
        self._pool = pool
        self._device = device

    def capture(self, fn, *args):
        with torch.cuda.device(self._device):
            cur = torch.cuda.current_stream()
            side = _side_streams.setdefault(self._device,
                                            torch.cuda.Stream())
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                # thread_local: other threads (decoders, writers) may
                # call CUDA while this one captures
                self._graph.capture_begin(pool=self._pool,
                                          capture_error_mode="thread_local")
                try:
                    out = fn(*args)
                finally:
                    self._graph.capture_end()
            cur.wait_stream(side)
        return out

    def replay(self) -> None:
        with torch.cuda.device(self._device):
            self._graph.replay()


def new_pool(device):
    """A private memory pool shared by the graphs of one key."""
    return torch.cuda.graph_pool_handle()


class _Segment:
    def __init__(self, graph, slots, ptrs, out, launches, delta, counts):
        self.graph = graph
        self.slots = slots    # per input leaf: a buffer to copy into, or None
        self.ptrs = ptrs      # per input leaf: where an earlier stage's is
        self.out = out
        self.launches = launches
        self.delta = delta    # what the capture added to each of them
        self.counts = counts  # counter name -> the graph's own tensor

    def add_counts(self) -> None:
        """What the last replay counted, into the process's counters
        while tracing."""
        if self.counts and profiling.tracing():
            for name, t in self.counts.items():
                profiling.counter(name, t.device).add_(t)

    def replay(self) -> None:
        self.graph.replay()
        add_launches(self.launches, self.delta)
        self.add_counts()


class _Entry:
    """What one key holds: its segments in call order, their pool, the
    tensors they own, what else they read (`holds`), whether a call has
    run and the last call's end."""

    def __init__(self):
        self.warm = False
        self.segments: list[_Segment] = []
        self.captured = False
        self.pool = None
        self.owned: set = set()
        self.holds = None
        self.lock = threading.Lock()
        self.done = None

    def mode(self) -> str:
        if self.captured:
            return "replay"
        return "capture" if self.warm else "eager"


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class Call:
    """The stages of one call (a context manager); see the module
    docstring.  `mode` is "eager", "capture" or "replay"."""

    def __init__(self, entry, device, new_graph=CudaGraph,
                 new_pool=new_pool, launches=(), holds=None):
        self._entry = entry
        self._device = device
        self._launches = launches
        self._holds = holds
        self._new_graph = new_graph
        self._new_pool = new_pool
        self._next = 0
        self.mode = "eager"

    def __enter__(self):
        e = self._entry
        if e is None:
            return self
        e.lock.acquire()
        self.mode = e.mode()
        if self.mode == "capture":
            e.pool = self._new_pool(self._device)
            e.holds = self._holds
        if e.done is not None:
            torch.cuda.current_stream(self._device).wait_event(e.done)
        return self

    def __exit__(self, typ, exc, tb):
        e = self._entry
        if e is None:
            return False
        try:
            if typ is not None:
                if self.mode == "capture":
                    e.segments, e.owned = [], set()
                    e.pool = e.holds = None
                return False
            if self.mode == "replay" and self._next != len(e.segments):
                raise RuntimeError(f"graphs: a call ran {self._next} of "
                                   f"the {len(e.segments)} stages captured")
            e.warm = True
            e.captured = e.captured or self.mode == "capture"
            if self._device.type == "cuda" and self.mode != "eager":
                e.done = torch.cuda.Event()
                e.done.record(torch.cuda.current_stream(self._device))
        finally:
            e.lock.release()
        return False

    def stage(self, name: str, fn, *args):
        """fn(*args) in a span `name`: run, captured or replayed.  args:
        tensors, None or dicts of them; fn returns the same."""
        global SEGMENTS_EAGER
        with span(name):
            if self.mode == "eager":
                SEGMENTS_EAGER += 1
                return fn(*args)
            if self.mode == "capture":
                return self._capture(fn, args)
            return self._replay(args)

    def eager(self, name: str, fn, *args):
        """fn(*args) in a span `name`, run eager in any mode (a stage no
        graph holds); what it makes is copied into the graphs that read
        it."""
        global SEGMENTS_EAGER
        with span(name):
            SEGMENTS_EAGER += 1
            return fn(*args)

    def result(self, t: torch.Tensor) -> torch.Tensor:
        """A stage's output as the caller may keep it: a copy where a
        graph owns it."""
        return t if self.mode == "eager" else t.clone()

    def _capture(self, fn, args):
        global SEGMENTS_CAPTURED
        e = self._entry
        leaves, spec = tree_flatten(args)
        slots, ptrs, ins = [], [], []
        for a in leaves:
            buf = ptr = None
            if isinstance(a, torch.Tensor):
                if _storage(a) in e.owned:
                    ptr = a.data_ptr()
                else:
                    buf = a = a.clone(memory_format=torch.contiguous_format)
            slots.append(buf)
            ptrs.append(ptr)
            ins.append(a)
        counts = {}

        def counting(*a):
            with profiling.counting_into(counts):
                return fn(*a)

        graph = self._new_graph(e.pool, self._device)
        before = read_launches(self._launches)
        with _no_collection():
            out = graph.capture(counting, *tree_unflatten(ins, spec))
        delta = [b - a for a, b in
                 zip(before, read_launches(self._launches))]
        seg = _Segment(graph, slots, ptrs, out, self._launches, delta,
                       counts)
        # this call's own launches were counted by the capture
        graph.replay()
        seg.add_counts()
        e.segments.append(seg)
        e.owned.update(_storage(t) for t in tree_flatten(out)[0]
                       if isinstance(t, torch.Tensor))
        SEGMENTS_CAPTURED += 1
        return out

    def _replay(self, args):
        global SEGMENTS_REPLAYED
        seg = self._entry.segments[self._next]
        self._next += 1
        for a, buf, ptr in zip(tree_flatten(args)[0], seg.slots, seg.ptrs):
            if buf is not None:
                buf.copy_(a)
            elif ptr is not None and a.data_ptr() != ptr:
                raise RuntimeError("graphs: a stage input moved since "
                                   "its capture")
        seg.replay()
        SEGMENTS_REPLAYED += 1
        return seg.out


def on_card(device) -> bool:
    return torch.device(device).type == "cuda"


class Graphs:
    """The keys held and the mode of each call (see the module
    docstring).  launches: the (module, attribute) launch counters of
    the kernels the stages run; new_graph(pool, device) makes a graph
    with capture(fn, *args) and replay(); new_pool(device) a pool;
    capturable(device) says whether a device's calls may capture at
    all."""

    def __init__(self, bound: int = LRU_KEYS, launches=(),
                 new_graph=CudaGraph, new_pool=new_pool,
                 capturable=on_card):
        self.bound = bound
        self.launches = tuple(launches)
        self._new_graph = new_graph
        self._new_pool = new_pool
        self._capturable = capturable
        self._held: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()

    def held(self) -> list:
        """The (device, key) pairs held, oldest first."""
        with self._lock:
            return list(self._held)

    def call(self, key, device, holds=None) -> Call:
        """The Call of a call with `key` (hashable: shapes, configuration,
        ...) on `device`.  holds: what the stages read that no stage
        makes and no argument passes (kept with the key's graphs where
        this call captures)."""
        device = torch.device(device)
        if not self._capturable(device):
            return Call(None, device)
        full = (device, key)
        with self._lock:
            entry = self._held.get(full)
            if entry is None:
                entry = self._held[full] = _Entry()
                while len(self._held) > self.bound:
                    _, old = self._held.popitem(last=False)
                    if old.done is not None:
                        # its buffers may still be read on another stream
                        old.done.synchronize()
            else:
                self._held.move_to_end(full)
        return Call(entry, device, self._new_graph, self._new_pool,
                    self.launches, holds)
