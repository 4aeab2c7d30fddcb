"""Collectives of the port's multi-device functions over a process group.

The JAX package shards with a mesh and ``jax.lax`` collectives; the port
runs one process a rank over a ``torch.distributed`` process group (a
"mesh" in the sharded functions' signatures, from ``dist.make_mesh``).

The group's backend fixes where a collective's tensors live: CUDA
tensors under NCCL, host tensors under gloo, which has no CUDA send or
receive.  Each helper moves its tensor to that device, runs the
collective there and returns the result on the tensor's own device, so
under NCCL a CUDA tensor never goes through the host.  Every rank must
call the helpers in the same order (gloo matches payloads by order).
"""

from __future__ import annotations

import torch
import torch.distributed as tdist


def rank_and_size(group) -> tuple[int, int]:
    """(this process's rank in the group, the group's size)."""
    return tdist.get_rank(group), tdist.get_world_size(group)


def comm_device(group) -> torch.device:
    """Where the group's collectives take their tensors."""
    if tdist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _wire(t: torch.Tensor, group) -> torch.Tensor:
    """A contiguous copy of t on the group's device (bool as uint8: not
    every backend moves bool)."""
    x = t.to(comm_device(group), copy=True)
    return (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()


def all_gather_list(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's t (one shape on every rank), in rank order, on t's
    device."""
    x = _wire(t, group)[None]
    parts = [torch.empty_like(x) for _ in range(tdist.get_world_size(group))]
    tdist.all_gather(parts, x, group=group)
    return [p[0].to(device=t.device, dtype=t.dtype) for p in parts]


def all_gather_cat(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's t concatenated along axis 0 in rank order."""
    return torch.cat(all_gather_list(t, group))


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's t (a new tensor on t's device)."""
    x = _wire(t, group)
    tdist.all_reduce(x, group=group)
    return x.to(device=t.device, dtype=t.dtype)


def ring_shift(t: torch.Tensor, group) -> torch.Tensor:
    """Send t to rank r + 1 and return what rank r - 1 sent: one step
    around the ring, the send and the receive paired in one
    batch_isend_irecv."""
    group = tdist.group.WORLD if group is None else group
    r, n = rank_and_size(group)
    x = _wire(t, group)
    out = torch.empty_like(x)
    peer = lambda k: tdist.get_global_rank(group, k % n)
    ops = [tdist.P2POp(tdist.isend, x, peer(r + 1), group),
           tdist.P2POp(tdist.irecv, out, peer(r - 1), group)]
    for work in tdist.batch_isend_irecv(ops):
        work.wait()
    return out.to(device=t.device, dtype=t.dtype)
