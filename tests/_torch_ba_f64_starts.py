"""Float32 sharded BA against float64, from many starts (CPU).

tests/test_torch_multidevice.py settles the float64 comparison on
test_geom.py's own start; this script repeats it over the starts
RandomState(0..N-1) of the same perturbation (7 is test_geom.py's), and
adds the one-device runs of both packages.  For each start, after 12 LM
iterations:

  * the reference: the port's dense ba_solve in float64;
  * the port's ba_solve_sharded over 4 gloo ranks in float64 (its
    largest point distance from the reference, `f64_sharded`);
  * in float32: JAX's ba_solve_sharded on a 4-device CPU mesh (`jax`)
    and with mesh=None (`jax1`), the port's over the 4 ranks (`port`)
    and with mesh=None (`port1`).

Each float32 run is moved along the free scale gauge
(test_torch_multidevice.scale_gauge) and its points' max-abs and RMS
distances from the reference are printed (`points_max_raw`: before
the move), one JSON line a start, then the means.

Usage: python tests/_torch_ba_f64_starts.py [N]     (N = 10: ~75 s)
The ranks are this script started with --rank.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NRANKS = 4
ITERS = 12
KEYS = ("rvec", "tvec", "points")


def _fields(sol):
    """(rvec, tvec, points) of a solved problem of either package, as
    numpy."""
    return [np.asarray(v) for v in (sol.cam_rvec, sol.cam_tvec, sol.points)]


def rank_main(rank: int, port: int, work: str) -> None:
    """One gloo rank: the sharded solve of every start, float32 and
    float64; rank 0 writes them to work/port.npz."""
    import torch

    sys.path.insert(0, ROOT)
    from hesaff_tpu_torch import dist
    from hesaff_tpu_torch.geom import ba

    torch.set_num_threads(2)
    inp = np.load(os.path.join(work, "inputs.npz"))
    dist.init_multihost(f"localhost:{port}", NRANKS, rank, backend="gloo")
    group = dist.make_mesh()
    out = {}
    for dt, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        t = lambda k: torch.from_numpy(inp[k]).to(dt)
        sols = []
        for i in range(len(inp["points"])):
            p = ba.BAProblem(
                cam_rvec=t("rvec")[i], cam_tvec=t("tvec")[i],
                points=t("points")[i], f=float(inp["f"]),
                cx=float(inp["cx"]), cy=float(inp["cy"]),
                cam_idx=torch.from_numpy(inp["cam_idx"]),
                pt_idx=torch.from_numpy(inp["pt_idx"]), uv=t("uv"), w=t("w"))
            sol, err = ba.ba_solve_sharded(p, mesh=group, iterations=ITERS)
            sols.append((sol, err))
        for j, k in enumerate(KEYS):
            out[f"{tag}_{k}"] = np.stack([_fields(s)[j] for s, _ in sols])
        out[f"{tag}_err"] = np.asarray([e for _, e in sols])
    if rank == 0:
        np.savez(os.path.join(work, "port.npz"), **out)
    torch.distributed.destroy_process_group()


def main(n: int) -> None:
    import shutil
    import tempfile

    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=8")
    sys.path[:0] = [ROOT, HERE]
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch
    from jax.sharding import Mesh

    from hesaff_tpu.geom import ba as jba
    from hesaff_tpu_torch.geom import ba as tba
    from test_torch_multidevice import _ba_f64_dense, _ba_problem, scale_gauge

    starts = [_ba_problem(seed) for seed in range(n)]
    b = starts[0]
    work = tempfile.mkdtemp(prefix="ba_f64_starts_")
    np.savez(os.path.join(work, "inputs.npz"),
             **{k: np.stack([s[k] for s in starts]) for k in KEYS},
             **{k: b[k] for k in ("f", "cx", "cy", "cam_idx", "pt_idx", "uv",
                                  "w")})
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r),
                               str(port), work]) for r in range(NRANKS)]
    for p in procs:
        if p.wait() != 0:
            raise SystemExit(f"a rank exited {p.returncode}")
    got = dict(np.load(os.path.join(work, "port.npz")))
    shutil.rmtree(work)

    mesh = Mesh(np.asarray(jax.devices()[:NRANKS]), ("data",))
    rows = []
    for i, st in enumerate(starts):
        ref, err64 = _ba_f64_dense(st)
        jp = jba.BAProblem(
            cam_rvec=jnp.asarray(st["rvec"]), cam_tvec=jnp.asarray(st["tvec"]),
            points=jnp.asarray(st["points"]), f=float(b["f"]),
            cx=float(b["cx"]), cy=float(b["cy"]),
            cam_idx=jnp.asarray(b["cam_idx"]), pt_idx=jnp.asarray(b["pt_idx"]),
            uv=jnp.asarray(b["uv"]), w=jnp.asarray(b["w"]))
        tp = tba.BAProblem(
            cam_rvec=torch.from_numpy(st["rvec"]),
            cam_tvec=torch.from_numpy(st["tvec"]),
            points=torch.from_numpy(st["points"]), f=float(b["f"]),
            cx=float(b["cx"]), cy=float(b["cy"]),
            cam_idx=torch.from_numpy(b["cam_idx"]),
            pt_idx=torch.from_numpy(b["pt_idx"]),
            uv=torch.from_numpy(b["uv"]), w=torch.from_numpy(b["w"]))
        runs = {
            "jax": _fields(jba.ba_solve_sharded(jp, mesh=mesh,
                                                iterations=ITERS)[0]),
            "jax1": _fields(jba.ba_solve_sharded(jp, mesh=None,
                                                 iterations=ITERS)[0]),
            "port": [got[f"f32_{k}"][i] for k in KEYS],
            "port1": _fields(tba.ba_solve_sharded(tp, mesh=None,
                                                  iterations=ITERS)[0]),
        }
        row = {"seed": i, "rmse_f64": err64, "f64_sharded": float(np.abs(
            got["f64_points"][i] - ref.points.numpy()).max())}
        for name, sol in runs.items():
            pts = scale_gauge(ref, *sol)[0]
            dp = pts - ref.points.numpy()
            row[name] = {"points_max": float(np.abs(dp).max()),
                         "points_rms": float(np.sqrt(np.mean(dp * dp))),
                         "points_max_raw": float(np.abs(
                             sol[2] - ref.points.numpy()).max())}
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({name: {m: float(np.mean([r[name][m] for r in rows]))
                             for m in ("points_max", "points_rms")}
                      for name in runs}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        main(int(sys.argv[1]) if len(sys.argv) > 1 else 10)
