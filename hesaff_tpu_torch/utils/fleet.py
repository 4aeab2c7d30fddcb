"""Checkpointed, failure-isolated fleet extraction.

Port of ``hesaff_tpu/utils/fleet.py`` for one device.  `extract_fleet`
walks an image list in chunks, writes one .npz per image (natural
checkpoints) and a cursor file, so a restarted job resumes where it
stopped; a failing chunk is retried image by image, so one bad image
fails alone.  Images of mixed sizes are edge-padded to shape buckets
(`pad_to_bucket`) and extracted in padded (valid_hw) mode, which adds
no keypoints.

A chunk's route follows its tensor's device: on a GPU the grouped
serving path (dist.extraction_step_grouped with valid_hw and a group
table cached per shape, batch, capacity and configuration), whose
results stay on the card while the previous chunk is copied out and
written; on the CPU batch.extract_batch with valid_hw.  A grouped
chunk whose fixed capacities overflowed reruns through extract_batch,
which has none to overflow.  In a multi-host job each host runs
extract_fleet on its own slice (dist.host_shard), and ``host_barrier``
before each collective round turns a dropped peer into
``HostDropError``.
"""

from __future__ import annotations

import concurrent.futures
import datetime
import json
import os
import traceback
from typing import Callable, Sequence

import numpy as np
import torch

from hesaff_tpu_torch.pipeline import Features, resolve_device

_FIELDS = ("x", "y", "s", "a11", "a12", "a21", "a22", "response", "type",
           "desc")


def _default_loader(path: str) -> np.ndarray:
    from hesaff_tpu_torch.sift_io import load_image_gray

    return load_image_gray(path)


class HostDropError(RuntimeError):
    """A peer host failed to reach the liveness barrier (died/wedged)."""


# the world group -> the gloo group host_barrier runs on (the world group
# itself under gloo; a side group made once under NCCL)
_BARRIER_GROUPS: dict = {}


def barrier_group():
    """The gloo group of host_barrier for the current process group.
    Under NCCL it is a side group of the same ranks, made on the first
    call, which every rank must make (dist.init_multihost does), while
    no peer can have dropped yet."""
    import torch.distributed as tdist

    world = tdist.group.WORLD
    if tdist.get_backend(world) == "gloo":
        return world
    if world not in _BARRIER_GROUPS:
        _BARRIER_GROUPS[world] = tdist.new_group(backend="gloo")
    return _BARRIER_GROUPS[world]


def host_barrier(name: str, timeout_s: float = 60.0) -> None:
    """Liveness barrier of a multi-host job, called before each
    collective round.

    A collective with a dead or wedged peer waits for it without end;
    this barrier is no device collective, so it cannot hang past its
    timeout: torch.distributed.monitored_barrier on a gloo group
    (barrier_group), where rank 0 waits for every other rank's arrival
    for timeout_s.  Any failure raises HostDropError, so the survivors
    can checkpoint and the job restart on the hosts that remain (the
    recovery protocol of tests/_torch_drophost_worker.py).  A no-op
    without a process group.
    """
    import torch.distributed as tdist

    if not (tdist.is_available() and tdist.is_initialized()):
        return
    try:
        tdist.monitored_barrier(
            barrier_group(), timeout=datetime.timedelta(seconds=timeout_s),
            wait_all_ranks=True)
    except RuntimeError as e:  # any failure of the barrier is a lost peer
        raise HostDropError(
            f"liveness barrier {name!r} failed after {timeout_s} s "
            f"(peer host dropped?): {e}") from e


def pad_to_bucket(img: np.ndarray, multiple: int = 64):
    """Edge-pad an image up to the next multiple of `multiple` on each
    axis, so that a fleet of mixed sizes shares a few shapes (and the
    group tables and allocations that go with them).  Returns (padded,
    (h, w)) with the true size, for valid_hw."""
    h, w = img.shape
    hp = ((h + multiple - 1) // multiple) * multiple
    wp = ((w + multiple - 1) // multiple) * multiple
    if hp == h and wp == w:
        return img, (h, w)
    return np.pad(img, ((0, hp - h), (0, wp - w)), mode="edge"), (h, w)


_GROUP_SPECS = {}


def _submit_chunk(imgs: np.ndarray, hws: np.ndarray, cfg,
                  per_image_cap: int = 1024, device=None):
    """Start extraction of a shape-homogeneous padded chunk.

    imgs: (B, H, W) float32; hws: (B, 2) int32 true sizes.  On a GPU
    the chunk takes the grouped serving path and its results stay on
    the card (the caller drains the previous chunk meanwhile); on the
    CPU extract_batch runs it to the end.  Returns an opaque token for
    _drain_chunk.
    """
    from hesaff_tpu_torch.batch import extract_batch

    images = torch.as_tensor(imgs, dtype=torch.float32,
                             device=resolve_device(imgs, device))
    B, H, W = images.shape
    if images.device.type == "cuda":
        from hesaff_tpu_torch.dist import (default_group_spec,
                                           extraction_step_grouped)

        # cfg is part of the key: default_group_spec reads its fields
        key = (H, W, B, per_image_cap, cfg)
        groups = _GROUP_SPECS.get(key)
        if groups is None:
            groups = default_group_spec(H, W, cfg,
                                        per_image_cap=per_image_cap,
                                        batch=B)
            _GROUP_SPECS[key] = groups
        out = extraction_step_grouped(images, cfg, groups, valid_hw=hws)
        return ("grouped", out, images, hws, B)
    return ("staged", extract_batch(images, cfg, valid_hw=hws))


def _drain_chunk(token, cfg):
    """A _submit_chunk token's list of Features (host arrays).

    A grouped chunk whose fixed capacities overflowed reruns through
    extract_batch on the same device: no keypoint is dropped silently.
    """
    from hesaff_tpu_torch.batch import extract_batch

    if token[0] == "staged":
        return token[1]
    _, out, images, hws, B = token
    if int(out.overflow) == 0:
        valid = out.valid.cpu().numpy()
        gi = out.img_idx.cpu().numpy()
        fields = {k: getattr(out, k).cpu().numpy() for k in _FIELDS}
        feats = []
        for b in range(B):
            m = valid & (gi == b)
            feats.append(Features(**{k: fields[k][m] for k in _FIELDS}))
        return feats
    return extract_batch(images, cfg, valid_hw=hws)


def _extract_chunk(imgs: np.ndarray, hws: np.ndarray, cfg,
                   per_image_cap: int = 1024, device=None):
    """Submit and drain one chunk (single-chunk callers, warm-up)."""
    return _drain_chunk(_submit_chunk(imgs, hws, cfg, per_image_cap,
                                      device), cfg)


def extract_fleet(paths: Sequence[str], out_dir: str, cfg=None,
                  batch_size: int = 8,
                  loader: Callable[[str], np.ndarray] = _default_loader,
                  log: Callable[[str], None] = print,
                  prefetch: bool = True, device=None):
    """Extract features for `paths`, checkpointed and failure isolated.

    Writes <out_dir>/<basename>.npz per image (x, y, s, a11, a12, a21,
    a22, response, type, desc) and a cursor.json with {done: [...],
    failed: {path: error}}.  Re-running skips completed and failed
    images.  Returns the cursor dict.  device: where to run (the GPU by
    default; "cpu" on request).

    With `prefetch` (default) and the default loader, images are read,
    decoded and padded by the native C++ thread pool
    (native.PrefetchLoader) ahead of the device loop; formats the
    native decoders do not cover fall back to the Python loader per
    image.  One chunk is in flight while the previous one is copied
    out; the .npz writes run on one background thread and are awaited
    before the cursor marks their chunk done.
    """
    from hesaff_tpu_torch.batch import extract_batch
    from hesaff_tpu_torch.config import DEFAULT_CONFIG

    cfg = cfg or DEFAULT_CONFIG
    device = resolve_device(None, device)
    os.makedirs(out_dir, exist_ok=True)
    cursor_path = os.path.join(out_dir, "cursor.json")
    cursor = {"done": [], "failed": {}}
    if os.path.exists(cursor_path):
        with open(cursor_path) as f:
            cursor = json.load(f)
    done = set(cursor["done"])

    def save_cursor():
        tmp = cursor_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(cursor, f)
        os.replace(tmp, cursor_path)

    def write_one(path, feats):
        base = os.path.splitext(os.path.basename(path))[0]
        # uncompressed: the bulk is near-random uint8 descriptor bins
        np.savez(os.path.join(out_dir, base + ".npz"),
                 **{k: getattr(feats, k) for k in _FIELDS})

    def run_one(path, img=None, true_hw=None):
        if img is None:
            img, true_hw = pad_to_bucket(loader(path))
        feats = extract_batch(img[None], cfg,
                              valid_hw=np.asarray([true_hw], np.int32),
                              device=device)[0]
        write_one(path, feats)

    def fail(path, e):
        cursor["failed"][path] = "".join(
            traceback.format_exception_only(type(e), e)).strip()
        log(f"extract_fleet: FAILED {path}: {cursor['failed'][path]}")

    pending = [p for p in paths if p not in done
               and p not in cursor["failed"]]

    stream = None
    if prefetch and loader is _default_loader and pending:
        from hesaff_tpu_torch import native

        if native.available():
            try:
                stream = native.PrefetchLoader(pending)
            except RuntimeError:
                stream = None

    prefetched = {}  # path -> (img_or_None, hw_or_None)

    def load_padded(path):
        # pull from the native stream until `path` surfaces (an earlier
        # mid-chunk exception can leave the consumer behind the stream;
        # buffering keeps them in step without decoding twice)
        while (stream is not None and path not in prefetched
               and len(prefetched) <= 2 * batch_size):
            try:
                sp, img, hw = next(stream)
            except StopIteration:
                break
            prefetched[sp] = (img, hw)
        img, hw = prefetched.pop(path, (None, None))
        if img is not None:
            return img, hw
        return pad_to_bucket(loader(path))

    writer = concurrent.futures.ThreadPoolExecutor(max_workers=1)

    def drain(rec):
        """Finish one submitted chunk: copy out, write, checkpoint.  A
        failure retries each image of the chunk alone, so only a bad
        image fails."""
        writes = []
        try:
            for unit in rec["units"]:
                if unit[0] == "tok":
                    _, paths_u, tok = unit
                    feats = _drain_chunk(tok, cfg)
                    for p, f in zip(paths_u, feats):
                        writes.append((p, writer.submit(write_one, p, f)))
                else:
                    _, p, im, hw = unit
                    run_one(p, im, hw)
                    cursor["done"].append(p)
            for p, fut in writes:
                fut.result()
                cursor["done"].append(p)
        except Exception:
            for p, fut in writes:
                try:
                    fut.result()
                    if p not in cursor["done"]:
                        cursor["done"].append(p)
                except Exception:
                    pass
            for p in rec["chunk"]:
                if p in cursor["done"] or p in cursor["failed"]:
                    continue
                try:
                    run_one(p)
                    cursor["done"].append(p)
                except Exception as e:  # noqa: BLE001 — keep the job alive
                    fail(p, e)
        save_cursor()

    inflight = None
    try:
        i = 0
        while i < len(pending):
            chunk = pending[i:i + batch_size]
            i += batch_size
            units = []
            try:
                imgs = [load_padded(p) for p in chunk]
                by_bucket = {}
                for p, (im, hw) in zip(chunk, imgs):
                    by_bucket.setdefault(im.shape, []).append((p, im, hw))
                for group in by_bucket.values():
                    if len(group) > 1:
                        tok = _submit_chunk(
                            np.stack([im for _, im, _ in group]),
                            np.asarray([hw for _, _, hw in group],
                                       np.int32), cfg, device=device)
                        units.append(
                            ("tok", [p for p, _, _ in group], tok))
                    else:
                        units.append(("one",) + group[0])
            except Exception:
                # a load or submit failed: isolate image by image now
                units = []
                for p in chunk:
                    prefetched.pop(p, None)
                    if p in cursor["done"]:
                        continue
                    try:
                        run_one(p)
                        cursor["done"].append(p)
                    except Exception as e:  # noqa: BLE001
                        fail(p, e)
                save_cursor()
            # realign the stream to the chunk boundary: a mid-chunk
            # exception can leave undelivered paths in flight
            if stream is not None:
                try:
                    while stream.pos < i:
                        next(stream)
                except StopIteration:
                    pass
            prefetched.clear()
            if inflight is not None:
                drain(inflight)
            inflight = {"chunk": chunk, "units": units} if units else None
        if inflight is not None:
            drain(inflight)
    finally:
        writer.shutdown(wait=True)
        if stream is not None:
            stream.close()
    return cursor
