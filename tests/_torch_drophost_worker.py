"""Drop-host fault injection for the port: a multi-round ring 2-NN job
over a gloo process group in which one host wedges.

The port's counterpart of tests/drophost_worker.py, with its protocol:

  * every round starts with utils.fleet.host_barrier, the liveness gate
    that turns a dead or wedged peer into HostDropError instead of a
    collective that never returns;
  * each host writes its shard's result after every completed round
    (natural checkpoints) and a cursor of completed rounds;
  * the doomed host (rank 1) wedges at round `die_after`: it sleeps
    without reaching the barrier;
  * rank 0, which serves the group's TCP store, catches HostDropError,
    writes its cursor and leaves with exit code 17, the restart signal
    a fleet controller acts on, through os._exit: a normal shutdown of
    the group would wait for the wedged peer.

tests/test_torch_multidevice.py runs two ranks on the CPU and
chip_smoke.py (phase 10) two ranks sharing one GPU, then "restart the
job" in one process from the checkpoints and hold the union of the
rounds equal to a dense knn2 of every round.

Usage: _torch_drophost_worker.py <rank> <nproc> <port> <outdir> <rounds>
       <die_after> [<device> [<timeout_s>]]
Imports only torch, numpy and the port.
"""

import json
import os
import sys
import time

import numpy as np


def round_data(r: int, nproc: int, per: int = 32, dim: int = 16):
    """The round's queries and database (drophost_worker.py's data)."""
    rng = np.random.default_rng(1000 + r)
    q = rng.standard_normal((nproc * per, dim)).astype(np.float32)
    db = rng.standard_normal((nproc * per, dim)).astype(np.float32)
    return q, db


def run(rank: int, nproc: int, port: int, outdir: str, rounds: int,
        die_after: int, device: str = "cpu", timeout_s: float = 10.0,
        per: int = 32) -> None:
    import torch

    torch.set_num_threads(2)
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    from hesaff_tpu_torch import dist
    from hesaff_tpu_torch.match import ring_knn2
    from hesaff_tpu_torch.utils.fleet import HostDropError, host_barrier

    dist.init_multihost(f"localhost:{port}", nproc, rank, backend="gloo")
    group = dist.make_mesh()
    cursor = {"completed": 0}
    path = os.path.join(outdir, f"cursor_{rank}.json")
    for r in range(rounds):
        if rank == 1 and r == die_after:
            time.sleep(1200)       # wedged: alive, but no progress
        try:
            host_barrier(f"round{r}", timeout_s=timeout_s)
        except HostDropError as e:
            cursor["detected_drop_at"] = r
            with open(path, "w") as f:
                json.dump(cursor, f)
            print(f"rank {rank}: {e}; checkpointed at round "
                  f"{cursor['completed']}", flush=True)
            os._exit(17)
        q, db = round_data(r, nproc, per)
        mine = slice(rank * per, (rank + 1) * per)
        out = ring_knn2(q[mine], db[mine], group, device=device)
        np.save(os.path.join(outdir, f"round{r}_shard{rank}.npy"),
                out.idx.cpu().numpy())
        cursor["completed"] = r + 1
        with open(path, "w") as f:
            json.dump(cursor, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    a = sys.argv[1:]
    run(int(a[0]), int(a[1]), int(a[2]), a[3], int(a[4]), int(a[5]),
        *(a[6:7]), *(float(x) for x in a[7:8]))
