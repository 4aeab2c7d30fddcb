"""Extraction steps on fixed capacities, one device and many.

Port of ``hesaff_tpu/dist.py``.  The grouped serving path
(extraction_step_grouped, the step bench.py, the fleet runner and the
retrieval bench serve with), padded (valid_hw) mode included: the JAX
package splits the step into separately compiled stages; here one
Python function loops over the groups and every result stays on the
device.

Phase A is batch.phase_a (batch.detect_affine_batch, flattened), and
the slot gathering, the assembly and DenseFeatures are batch.py's,
which dist re-exports.  Phase B selects the accepted
keypoints of each workspace group (default_group_spec) into its fixed
capacity, sorted by |a21| within the group, and extracts their patches
with the fused patch kernel (ops/cuda_patches): at full resolution up
to FULL_RES_GROUP_MAX, and above it from the downsampled pyramid level
that tail_source_plan picks (the "pyramid tail").  Keypoints that
overflow a group's capacity, or whose workspace exceeds the last group
of a table that ends at or below JAX_GROUP_MAX (the JAX package's
tables), are counted; a table that goes past it reaches the border
limit, and what lies above it fails the border check.  One masked SIFT
pass (ops/cuda_sift) describes the slots whose patch is valid.

The bucket step (extraction_step, also named extraction_step_staged as
in the JAX package, where the two give one result) is the reference
the serving path is held against: the same phase A, then
batch.bucket_phase_b, the phase B of batch.extract_batch too: every
BUCKET_SIZES bucket at full resolution (default_bucket_spec), slots in
row-major order, no sort and no pyramid tail.

Many devices (torch.distributed; the JAX package's jax.distributed and
meshes): init_multihost, host_shard, make_mesh (a process group in
place of a Mesh), sharded_extraction_step (each rank extracts its own
images, the keypoints are gathered to every rank) and
PipelinedExtractor (phase A on one device, phase B on another, on a
stream of their own).

Each stage runs inside a torch.profiler span ("input copy", "phase A",
"group N: select", "group N: patches", "bucket N", "direct branch",
"assemble", "SIFT"; utils/profiling.span), so a profile of one call
attributes host time to the stages; without an active profiler a span
costs one flag read.
"""

from __future__ import annotations

import contextlib
import itertools
import math
from typing import Sequence

import torch
import torch.distributed as tdist

from hesaff_tpu_torch import comm
from hesaff_tpu_torch.batch import (  # noqa: F401 (re-exported)
    DenseFeatures, as_valid_hw, assemble, bucket_phase_b, describe_valid,
    gather_slots, phase_a)
from hesaff_tpu_torch.config import DEFAULT_CONFIG, HesaffConfig
from hesaff_tpu_torch.ops.batching import compact_indices
from hesaff_tpu_torch.ops.cuda_patches import (direct_possible,
                                               extract_group,
                                               extract_group_scaled,
                                               patch_geometry, takes_direct)
from hesaff_tpu_torch.patches import (BUCKET_SIZES, direct_patches,
                                      extract_bucket_batch)
from hesaff_tpu_torch.pipeline import resolve_device
from hesaff_tpu_torch.pyramid import scaled_first_level
from hesaff_tpu_torch.utils.profiling import span

# Largest group extracted from the full-resolution image; larger groups
# warp from a downsampled level.  The JAX package chose 384 because its
# fused TPU kernel stops fitting the 16 MB VMEM budget above it; the
# port keeps the value because it decides which keypoints are warped
# from a downsampled level, and so changes results.
FULL_RES_GROUP_MAX = 384

# The JAX package's table ends at this group; every keypoint above the
# last group of a table that ends there counts as overflow, as it does
# in the JAX package, though none of them can pass the border check.
JAX_GROUP_MAX = 1025

def default_group_spec(height: int, width: int,
                       cfg: HesaffConfig = DEFAULT_CONFIG,
                       per_image_cap: int = 512, batch: int = 1):
    """Static (group bound, capacity) pairs for an image size.

    Groups up to 1,025: capacities follow the keypoint distribution
    measured on dense synthetic 800x640 imagery at batch 16 (occupancy
    18228 / 8601 / 2101 / 643 / 92 / 4 of 16384 slots) plus ~13%
    headroom, pooled across the batch, rounded up to 32.  Past 1,025
    the bounds double (2,049, 4,097, ...) until one reaches the border
    limit min(H, W) + 2: groups above it cannot pass the border check
    and are left out, and every keypoint below it has a group.  The
    2,049 and 4,097 fractions follow 6048x4032 mosaics of that imagery
    (occupancy, the most of 152 calls of 2 frames: 215 / 20 of 376,832
    slots) plus ~25% headroom; later groups take the last fraction.
    Every short side under 1,024 px stops at or before 1,025, where the
    table is the JAX package's.
    """
    limit = min(height, width) + 2
    total = per_image_cap * batch
    sizes = (49, 97, 193, 385, 641, 1025, 2049, 4097)
    fracs = (1.26, 0.6, 0.15, 0.046, 0.0075, 0.002, 0.00072, 0.000066)
    spec = []
    for k in itertools.count():
        bsize = sizes[k] if k < len(sizes) else 2 * spec[-1][0] - 1
        cap = max(32, int(total * fracs[min(k, len(fracs) - 1)]))
        cap = ((cap + 31) // 32) * 32
        spec.append((bsize, cap))
        if bsize >= limit:
            return tuple(spec)


def default_bucket_spec(height: int, width: int,
                        cfg: HesaffConfig = DEFAULT_CONFIG,
                        per_image_cap: int = 512, batch: int = 1):
    """Static (bucket, capacity) pairs of the bucket step for an image
    size: every BUCKET_SIZES bucket up to the first at or above
    min(H, W) + 2 (larger ones cannot pass the border check), half the
    batch's per_image_cap * batch slots in each bucket up to 97, an
    eighth up to 193, then max(64, 1/32) up to 385 and max(32, 1/128)
    above (the keypoint distribution concentrates in octave 0's buckets
    and octave 2's).  The JAX package's table, unchanged.
    """
    limit = min(height, width) + 2
    total = per_image_cap * batch
    spec = []
    for b in BUCKET_SIZES:
        if b <= 97:
            cap = total // 2
        elif b <= 193:
            cap = total // 8
        elif b <= 385:
            cap = max(64, total // 32)
        else:
            cap = max(32, total // 128)
        spec.append((b, cap))
        if b >= limit:
            break
    return tuple(spec)


def tail_source_plan(bsize: int, base_pd: float):
    """(ps, octave, bucket_src) for a pyramid-tail group.

    ps: the smallest power-of-two downsample whose source workspace
    2*ceil((bsize-2)/(2 ps))+3 fits FULL_RES_GROUP_MAX; octave: the
    pyramid octave whose first level has that pixel distance (relative
    to base_pd, 0.5 under upscale_input); bucket_src: the source
    workspace bound.
    """
    ps = 2.0
    while (2 * ((bsize - 2 + 2 * ps - 1) // (2 * ps)) + 3
           > FULL_RES_GROUP_MAX):
        ps *= 2.0
    octave = int(round(math.log2(ps / base_pd)))
    bucket_src = int(2 * -(-(bsize - 2) // (2 * ps)) + 3)
    return ps, octave, bucket_src


def tail_source_level(images, cfg: HesaffConfig, octave: int, levels_a,
                      cache: dict):
    """Octave `octave`'s first level: phase A's by-product where phase A
    reached that octave (levels_a[octave - 1]), else computed once and
    kept in `cache`."""
    if octave not in cache:
        cache[octave] = (
            levels_a[octave - 1] if 0 <= octave - 1 < len(levels_a)
            else scaled_first_level(images, cfg, octave))
    return cache[octave]


def group_selections(flat, cfg: HesaffConfig, groups: Sequence[tuple],
                     ncap: int):
    """Per group, in order: (bound, previous bound, img_idx, fields,
    valid, overflow) of the accepted keypoints with ws in (previous,
    bound], compacted into the group's capacity.  Direct-branch
    keypoints are left out of the full-resolution groups when the
    configuration has any."""
    _, ws, its = patch_geometry(flat["s"], cfg)
    skip = takes_direct(its, cfg) if direct_possible(cfg) else None
    prev = 0
    for bsize, bcap in groups:
        with span(f"group {bsize}: select"):
            m = flat["ok"] & (ws > prev) & (ws <= bsize)
            full = bsize <= FULL_RES_GROUP_MAX
            if full and skip is not None:
                m = m & ~skip
            idx, valid, over = compact_indices(m, bcap)
            gi, a, valid = gather_slots(flat, idx, valid, ncap,
                                        sort=full or cfg.tail_from_pyramid)
        yield bsize, prev, gi, a, valid, over
        prev = bsize


def group_patches(images, cfg: HesaffConfig, bsize: int, prev: int, gi, a,
                  valid, levels_a, cache: dict, valid_hw=None):
    """Patches and ok flags of one group's selection: at full
    resolution up to FULL_RES_GROUP_MAX, above it from the pyramid level
    tail_source_plan picks (or, with tail_from_pyramid off, through the
    reference's full-resolution bucket path, slots unsorted).  valid_hw:
    the true sizes of edge-padded images, for the corner check."""
    kp = (gi, *(a[k] for k in ("x", "y", "s", "a11")))
    with span(f"group {bsize}: patches"):
        if bsize <= FULL_RES_GROUP_MAX:
            return extract_group(images, bsize, *kp, a["a21"], a["a22"],
                                 cfg, valid, valid_hw)
        if cfg.tail_from_pyramid:
            ps, octave, bucket_src = tail_source_plan(
                bsize, 0.5 if cfg.upscale_input else 1.0)
            src = tail_source_level(images, cfg, octave, levels_a, cache)
            return extract_group_scaled(
                src.contiguous(), ps, bucket_src, *kp, a["a21"], a["a22"],
                cfg, valid, orig_hw=tuple(images.shape[-2:]),
                valid_hw=valid_hw)
        return extract_bucket_batch(images, bsize, *kp, a["a12"], a["a21"],
                                    a["a22"], cfg, active=valid,
                                    prev_bucket=prev, valid_hw=valid_hw)


def _as_images(images, device) -> torch.Tensor:
    """(B, H, W) float32 contiguous images on the entry point's device
    (pipeline.resolve_device's rule).  Moving them between the host and
    the card waits for the stream: that copy runs in a "sync: input"
    span."""
    dev = resolve_device(images, device)
    there = isinstance(images, torch.Tensor) and images.device.type == dev.type
    with contextlib.nullcontext() if there else span("sync: input"):
        return torch.as_tensor(images, dtype=torch.float32,
                               device=dev).contiguous()


def extraction_step_grouped(images, cfg: HesaffConfig,
                            groups: Sequence[tuple], valid_hw=None,
                            device=None) -> DenseFeatures:
    """Phase A, grouped patch extraction and masked SIFT for a batch.

    images: (B, H, W) float32 array or tensor; groups: ((bound,
    capacity), ...) from default_group_spec; valid_hw: optional (B, 2)
    int32 true sizes when the batch is edge-padded to a shape bucket
    (the detection window and every group's corner check use them, as
    in extract_batch); device: where to run (default: the tensor's
    device, or the GPU for numpy input; pass "cpu" to run on the CPU).
    Returns DenseFeatures of tensors on the device.
    """
    with span("input copy"):
        images = _as_images(images, device)
    valid_hw = as_valid_hw(valid_hw, images.device)
    flat, levels_a, overflow, ncap = phase_a(images, cfg, valid_hw)
    levels = {}
    pieces = []
    for bsize, prev, gi, a, valid, over in group_selections(flat, cfg, groups,
                                                           ncap):
        pk, pok = group_patches(images, cfg, bsize, prev, gi, a, valid,
                                levels_a, levels, valid_hw)
        pieces.append((pk, pok, gi, a))
        overflow = overflow + over
    with span("assemble"):
        _, ws, its = patch_geometry(flat["s"], cfg)
        above = flat["ok"] & (ws > groups[-1][0])
        if groups[-1][0] > JAX_GROUP_MAX:
            # the table ends at the border limit: a workspace above it
            # fails the border check, no capacity drops it
            above = above & (ws <= min(images.shape[-2:]) + 2)
        overflow = overflow + above.sum()
    if direct_possible(cfg):
        with span("direct branch"):
            dcap = max(64, groups[0][1] // 4)
            idx, valid, over = compact_indices(
                flat["ok"] & takes_direct(its, cfg), dcap)
            gi, a, valid = gather_slots(flat, idx, valid, ncap, sort=False)
            pk, pok = direct_patches(images, gi, a["x"], a["y"], a["s"],
                                     a["a11"], a["a21"], a["a22"], cfg,
                                     valid, valid_hw)
        pieces.append((pk, pok, gi, a))
        overflow = overflow + over

    return assemble(pieces, overflow, cfg)


def extraction_step(images, cfg: HesaffConfig, buckets: Sequence[tuple],
                    device=None) -> DenseFeatures:
    """The bucket step: phase A, then every bucket at full resolution and
    one masked SIFT pass, on fixed capacities.

    images: (B, H, W) float32 array or tensor; buckets: ((size,
    capacity), ...) from default_bucket_spec, capacities for the whole
    batch; device: where to run (default: the tensor's device, or the GPU
    for numpy input; pass "cpu" to run on the CPU).  Returns
    DenseFeatures on the device, in the JAX package's slot layout:
    bucket after bucket, each bucket's keypoints in row-major (image,
    slot) order; desc is zero where not valid.

    The JAX package has two names for one result, a single program and
    a chain of stages (extraction_step_staged); here both names are this
    function.
    """
    images = _as_images(images, device)
    flat, _, overflow, ncap = phase_a(images, cfg)
    return bucket_phase_b(images, flat, ncap, overflow, cfg, buckets)[0]


extraction_step_staged = extraction_step


def _concat_features(parts, sizes) -> DenseFeatures:
    """DenseFeatures of consecutive image batches (sizes[i] images in
    parts[i]) as one: slots concatenated in order, img_idx shifted by the
    images before each part, overflow summed."""
    first, img = 0, []
    for d, b in zip(parts, sizes):
        img.append(d.img_idx + first)
        first += int(b)
    cat = lambda k: torch.cat([getattr(d, k) for d in parts])
    return DenseFeatures(
        **{k: cat(k) for k in DenseFeatures._fields
           if k not in ("img_idx", "overflow")},
        img_idx=torch.cat(img),
        overflow=torch.stack([d.overflow for d in parts]).sum())


def _lane_buckets(buckets: Sequence[tuple], n: int) -> tuple:
    """A bucket table of a batch split n ways: each capacity divided by
    n, rounded up."""
    return tuple((b, -(-c // n)) for b, c in buckets)


# ---------------------------------------------------------------------------
# many devices: process groups

def init_multihost(coordinator: str, num_processes: int, process_id: int,
                   backend: str | None = None) -> None:
    """Join this process to a job of num_processes ranks (the JAX
    package's jax.distributed.initialize).

    coordinator: "host:port" of the TCP store, which rank 0 serves;
    num_processes, process_id: the world size and this rank, given
    explicitly (nothing on a machine announces a cluster).  backend:
    "nccl" unless the caller names "gloo"; never picked from what the
    machine has.  Under NCCL the rank first takes its card
    (torch.cuda.set_device(process_id % cards)) and a gloo side group is
    made for host_barrier; without a CUDA device NCCL raises before the
    coordinator is contacted.
    """
    from hesaff_tpu_torch.utils.fleet import barrier_group

    backend = backend or "nccl"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("init_multihost: the nccl backend needs a "
                               "CUDA device and none is available; pass "
                               "backend=\"gloo\" for host collectives")
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    tdist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                             world_size=num_processes, rank=process_id)
    barrier_group()


def host_shard(items, process_index: int | None = None,
               process_count: int | None = None):
    """This host's share of a work list: items[h::n], h and n from the
    process group (rank 0 of 1 without one) unless given."""
    on = tdist.is_available() and tdist.is_initialized()
    if process_index is None:
        process_index = tdist.get_rank() if on else 0
    if process_count is None:
        process_count = tdist.get_world_size() if on else 1
    return list(items)[process_index::process_count]


def make_mesh(n_devices: int | None = None):
    """What the sharded functions take as `mesh` in place of a JAX Mesh:
    the process group of ranks 0..n_devices-1, or the world group
    (n_devices None or the world size).  A smaller group is made by
    torch.distributed.new_group, which every rank must call."""
    if not (tdist.is_available() and tdist.is_initialized()):
        raise RuntimeError("make_mesh: no process group; call "
                           "init_multihost first")
    if n_devices is None or n_devices == tdist.get_world_size():
        return tdist.group.WORLD
    return tdist.new_group(ranks=list(range(n_devices)))


def sharded_extraction_step(mesh, cfg: HesaffConfig,
                            buckets: Sequence[tuple]):
    """The bucket step with images sharded over a process group.

    mesh: a process group (make_mesh); buckets: the table of the whole
    batch, as the JAX package's step takes it: each rank runs
    extraction_step on its own images with every capacity divided by the
    group's size (rounded up).  Returns step(local_images, device=None)
    (device as extraction_step's); every rank calls it with its images,
    the ranks' batches in rank order making the whole batch.  Each rank
    receives the whole DenseFeatures: the ranks' slots concatenated in
    rank order (all_gather), img_idx counted over the whole batch,
    overflow summed over the group.  The JAX package returns
    (step, input sharding); here the rank's images are its shard.
    """
    def step(local_images, device=None) -> DenseFeatures:
        images = _as_images(local_images, device)
        n = tdist.get_world_size(mesh)
        out = extraction_step(images, cfg, _lane_buckets(buckets, n))
        sizes = comm.all_gather_list(
            torch.tensor(images.shape[0], device=images.device), mesh)
        lists = {k: comm.all_gather_list(getattr(out, k), mesh)
                 for k in DenseFeatures._fields}
        parts = [DenseFeatures(**{k: v[i] for k, v in lists.items()})
                 for i in range(n)]
        return _concat_features(parts, sizes)

    return step


def _stage_stream(device: torch.device):
    """A CUDA stream of its own for a pipeline stage (None on the CPU)."""
    return torch.cuda.Stream(device) if device.type == "cuda" else None


def _on(stream):
    """The stage's stream as the current one on its device (nothing on
    the CPU)."""
    return (contextlib.nullcontext() if stream is None
            else torch.cuda.stream(stream))


class PipelinedExtractor:
    """Two-stage pipeline of the bucket step over (stage x data) devices.

    Stage A runs phase A (pyramid, detection, affine adaptation) on
    devices[:data_parallel]; stage B runs phase B (bucketed patches and
    SIFT, batch.bucket_phase_b) on devices[data_parallel:2 * data_parallel].
    With data_parallel > 1 each microbatch is split into that many
    lanes, lane d running on stage A's device d and stage B's device d
    with the bucket capacities divided by data_parallel, and the lanes'
    outputs are concatenated on stage B's first device.

    Each stage has a CUDA stream of its own, also where one device
    serves both (the same device may be passed twice, as to the JAX
    package).  At the handoff stage B's stream waits for stage A's, and
    what crosses (the images and phase A's per-keypoint fields) is
    recorded on stage B's stream on the same device, or copied to
    stage B's device without blocking the host.  Phase A's compactions
    keep fixed shapes on the device and wait on nothing, so the host
    goes on to stage A of microbatch t+1 while stage B of t still runs.
    """

    def __init__(self, cfg: HesaffConfig, buckets: Sequence[tuple],
                 devices=None, data_parallel: int = 1):
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "PipelinedExtractor: no CUDA device is available; pass "
                    "devices (device=\"cpu\" for each stage) to run on "
                    "the CPU")
            devices = range(torch.cuda.device_count())
        devs = [torch.device("cuda", d) if isinstance(d, int)
                else torch.device(d) for d in devices]
        if len(devs) < 2 * data_parallel:
            raise ValueError(f"pipeline needs 2*{data_parallel} devices, "
                             f"have {len(devs)}")
        self.cfg = cfg
        self.dp = data_parallel
        self.buckets = _lane_buckets(buckets, data_parallel)
        self.lanes = [(devs[d], devs[data_parallel + d],
                       _stage_stream(devs[d]),
                       _stage_stream(devs[data_parallel + d]))
                      for d in range(data_parallel)]

    def _submit(self, imgs):
        """Stage A, the handoff and stage B of one microbatch, enqueued
        lane by lane.  Returns [(DenseFeatures, stage B's stream, images
        in the lane)]."""
        per = -(-len(imgs) // self.dp)
        lanes = []
        for d, (dev_a, dev_b, sa, sb) in enumerate(self.lanes):
            chunk = imgs[d * per:(d + 1) * per]
            with _on(sa):
                im = torch.as_tensor(chunk, dtype=torch.float32,
                                     device=dev_a).contiguous()
                flat, _, overflow, ncap = phase_a(im, self.cfg)
            with _on(sa), _on(sb):
                if sb is not None and sa is not None:
                    sb.wait_stream(sa)
                crossing = [im, overflow, *flat.values()]
                if dev_a == dev_b:
                    if sb is not None:
                        for t in crossing:
                            t.record_stream(sb)
                else:
                    crossing = [t.to(dev_b, non_blocking=True)
                                for t in crossing]
                im_b, over_b, *vals = crossing
                out, _ = bucket_phase_b(im_b, dict(zip(flat, vals)), ncap,
                                        over_b, self.cfg, self.buckets)
            lanes.append((out, sb, len(chunk)))
        return lanes

    def _finish(self, lanes) -> DenseFeatures:
        """Wait for a microbatch's stage B and hand its output to the
        caller's stream on stage B's first device."""
        dev = self.lanes[0][1]
        parts = []
        for out, sb, _ in lanes:
            if sb is not None:
                sb.synchronize()
                consumer = torch.cuda.current_stream(sb.device)
                for t in out:
                    t.record_stream(consumer)
            parts.append(DenseFeatures(*(t.to(dev) for t in out)))
        if len(parts) == 1:
            return parts[0]
        return _concat_features(parts, [n for _, _, n in lanes])

    def __call__(self, batches, depth: int = 2):
        """Stream microbatches through the pipeline.

        batches: iterable of (B, H, W) float32 arrays or tensors of one
        shape.  Yields one DenseFeatures per microbatch, in order, on
        stage B's first device.  `depth` bounds the microbatches in
        flight (2: stage B works on t while stage A works on t+1).
        """
        inflight = []
        for imgs in batches:
            inflight.append(self._submit(imgs))
            while len(inflight) > depth:
                yield self._finish(inflight.pop(0))
        for lanes in inflight:
            yield self._finish(lanes)
