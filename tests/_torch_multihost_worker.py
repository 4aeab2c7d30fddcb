"""One rank of the port's multi-device cases over a gloo process group.

Launched once a module by tests/test_torch_multidevice.py as N
processes on the CPU (the port's counterpart of tests/multihost_smoke.py,
which runs the JAX package's cases over jax.distributed).  Each rank
reads the cases' inputs from <workdir>/inputs.npz, runs every sharded
function of the port on them, in one order on every rank, and writes
its results to <workdir>/rank<r>.npz:

  * sharded_extraction_step over the ranks' images (the whole gathered
    DenseFeatures, on every rank);
  * ring_knn2 of the rank's query and database shards;
  * sharded_query_votes of one query over an index;
  * ba_solve_sharded over the group, and one LM step's all-reduced
    partials;
  * host_barrier with every rank present.

Usage: _torch_multihost_worker.py <rank> <nproc> <port> <workdir>
Imports only torch, numpy and the port.
"""

import os
import sys

import numpy as np
import torch


def main(rank: int, nproc: int, port: int, workdir: str) -> None:
    torch.set_num_threads(2)
    from hesaff_tpu_torch import dist
    from hesaff_tpu_torch.config import HesaffConfig
    from hesaff_tpu_torch.geom import ba
    from hesaff_tpu_torch.match import ring_knn2
    from hesaff_tpu_torch.retrieval import build_index, sharded_query_votes
    from hesaff_tpu_torch.utils.fleet import host_barrier

    inp = np.load(os.path.join(workdir, "inputs.npz"))
    dist.init_multihost(f"localhost:{port}", nproc, rank, backend="gloo")
    group = dist.make_mesh()
    out = {}

    cfg = HesaffConfig()
    imgs = inp["ext_images"]
    per = len(imgs) // nproc
    buckets = tuple(map(tuple, inp["ext_buckets"]))
    step = dist.sharded_extraction_step(group, cfg, buckets)
    feats = step(imgs[rank * per:(rank + 1) * per], device="cpu")
    for k, v in feats._asdict().items():
        out[f"ext_{k}"] = v.numpy()

    qs = len(inp["ring_q"]) // nproc
    ds = len(inp["ring_db"]) // nproc
    m = ring_knn2(inp["ring_q"][rank * qs:(rank + 1) * qs],
                  inp["ring_db"][rank * ds:(rank + 1) * ds], group,
                  device="cpu")
    for k, v in m._asdict().items():
        out[f"ring_{k}"] = v.numpy()

    index = build_index(list(inp["votes_corpus"]))
    out["votes"] = sharded_query_votes(group, index, inp["votes_query"],
                                       ratio=0.9, device="cpu")

    t = lambda k: torch.from_numpy(inp[k])
    p = ba.BAProblem(
        cam_rvec=t("ba_rvec"), cam_tvec=t("ba_tvec"), points=t("ba_points"),
        f=float(inp["ba_f"]), cx=float(inp["ba_cx"]), cy=float(inp["ba_cy"]),
        cam_idx=t("ba_cam_idx"), pt_idx=t("ba_pt_idx"), uv=t("ba_uv"),
        w=t("ba_w"))
    sol, err = ba.ba_solve_sharded(p, mesh=group, iterations=20)
    out.update(ba_rvec=sol.cam_rvec.numpy(), ba_tvec=sol.cam_tvec.numpy(),
               ba_points=sol.points.numpy(), ba_err=np.float64(err))
    tracks, _ = ba.problem_to_tracks(p, pad_points_multiple=nproc)
    pl = tracks.points.shape[0] // nproc
    mine = slice(rank * pl, (rank + 1) * pl)
    local = tracks._replace(points=tracks.points[mine],
                            cam_t=tracks.cam_t[mine],
                            uv_t=tracks.uv_t[mine], w_t=tracks.w_t[mine])
    with ba.full_f32():
        parts, _ = ba._tracks_partials(local, 1e-3)
        parts = ba._reduce_parts(parts, group)
    for name, v in zip(("Hcc", "gc", "Soff", "rhs_corr"), parts):
        out[f"ba_{name}"] = v.numpy()

    host_barrier("done", timeout_s=60.0)
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
