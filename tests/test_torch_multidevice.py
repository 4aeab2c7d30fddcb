"""The port's multi-device slice against the JAX package's, on the CPU.

One module-scoped launch of four gloo ranks (tests/_torch_multihost_worker.py)
serves every sharded case; the JAX counterparts run here on a 4-device
slice of the conftest's 8-device CPU mesh, so both rings visit the
shards in the same order.  Same seeded numpy inputs on both sides:

  * default_bucket_spec equal to JAX's;
  * sharded_extraction_step over the 4 ranks (2 of test_dist.py's 96x96
    images each) against JAX's unsharded extraction_step over the 8
    images, image by image: one-to-one within 0.01 px, s within 1e-3
    relative, descriptors within 1, equal overflow; every rank holds
    the same whole result;
  * PipelinedExtractor on ["cpu", "cpu"] equal to the port's staged step
    (test_dist.py's pipeline bounds: valid equal, fields within 1e-5,
    descriptors and overflow equal; test_torch_bucket_step.py holds that
    step to JAX's), and with two lanes on four CPU "devices" image by
    image;
  * ring_knn2 bit-equal to JAX's ring_knn2 under shard_map on uint8
    descriptors held as float32 (exact integer distances), ties between
    equal database rows in different shards included (the ring keeps the
    first shard it visits, dense knn2 the lowest index);
  * sharded_query_votes equal to JAX's and to query_votes;
  * ba_solve_sharded against JAX's on the 4-device mesh at test_geom.py's
    bounds (rmse within 0.02, cameras within 8e-3, points within 6e-2),
    20 LM iterations each (the solvers' default; after test_geom.py's 12
    neither has converged from its perturbed start and the two float32
    trajectories differ by up to 0.064 in a point coordinate, as JAX's
    own 4-device and one-device solves differ by 0.029), and one LM
    step's all-reduced partials against JAX's psum at rtol 1e-4;
  * host_barrier a no-op without a group; the drop-host protocol
    (tests/_torch_drophost_worker.py, JAX's 3 rounds with a wedge at
    round 1, a 10 s barrier): rank 0 exits 17 with its cursor, and the
    restarted union equals a dense knn2 of every round.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from hesaff_tpu import dist as jdist
from hesaff_tpu.config import HesaffConfig
from hesaff_tpu.geom import ba as jba
from hesaff_tpu.match import ring_knn2 as jring_knn2
from hesaff_tpu.retrieval import build_index as jbuild_index
from hesaff_tpu.retrieval import sharded_query_votes as jsharded_votes
from hesaff_tpu_torch import dist
from hesaff_tpu_torch.match import knn2
from hesaff_tpu_torch.retrieval import build_index, query_votes
from hesaff_tpu_torch.utils.fleet import host_barrier
from _torch_parity import assert_same_features, match_slots, n, port_cfg
from test_dist import _images
from test_geom import make_ba_problem
from test_retrieval import make_corpus

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CFG = HesaffConfig()
NRANKS = 4
QS, DS = 16, 24          # ring: query and database rows a rank


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(script: str, args_of_rank, n: int):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return [subprocess.Popen(
        [sys.executable, os.path.join(HERE, script),
         *map(str, args_of_rank(r))], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]


def _ring_inputs():
    rng = np.random.default_rng(0)
    q = rng.integers(0, 256, (NRANKS * QS, 128)).astype(np.float32)
    db = rng.integers(0, 256, (NRANKS * DS, 128)).astype(np.float32)
    # a database row repeated in shard 1, and three queries equal to it in
    # the shards of ranks 0, 1 and 2: ties at distance 0 across shards
    db[DS + 5] = db[5]
    for r, i in ((0, 2), (1, 2), (2, 1)):
        q[r * QS + i] = db[5]
    return q, db


def _ba_problem():
    (rv, tv, X, f, cx, cy, ci, pi, uv) = make_ba_problem(noise=0.3, seed=3)
    rng = np.random.RandomState(7)
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(rvec=f32(rv + rng.randn(*rv.shape) * 0.02),
                tvec=f32(tv + rng.randn(*tv.shape) * 0.05),
                points=f32(X + rng.randn(*X.shape) * 0.05), f=f, cx=cx, cy=cy,
                cam_idx=ci, pt_idx=pi, uv=uv,
                w=np.ones(len(ci), np.float32))


def _votes_inputs():
    corpus = make_corpus(n_images=10, per_image=48)
    rng = np.random.RandomState(2)
    q = np.clip(corpus[3][:30].astype(np.int32)
                + rng.randint(-3, 4, (30, 128)), 0, 255).astype(np.uint8)
    return corpus, q


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Inputs of every sharded case, and each rank's results."""
    work = str(tmp_path_factory.mktemp("ranks"))
    imgs = _images(n=8)
    buckets = jdist.default_bucket_spec(96, 96, CFG, per_image_cap=1024,
                                        batch=8)
    q, db = _ring_inputs()
    corpus, vq = _votes_inputs()
    bap = _ba_problem()
    inputs = dict(ext_images=imgs, ext_buckets=np.asarray(buckets),
                  ring_q=q, ring_db=db, votes_corpus=np.stack(corpus),
                  votes_query=vq, **{f"ba_{k}": v for k, v in bap.items()})
    np.savez(os.path.join(work, "inputs.npz"), **inputs)
    port = _free_port()
    procs = _launch("_torch_multihost_worker.py",
                    lambda r: (r, NRANKS, port, work), NRANKS)
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{outs[r]}"
    results = [dict(np.load(os.path.join(work, f"rank{r}.npz")))
               for r in range(NRANKS)]
    return inputs, results


def _mesh():
    return Mesh(np.asarray(jax.devices()[:NRANKS]), ("data",))


@pytest.mark.parametrize("H,W,cap,B", [
    (640, 800, 1024, 16), (160, 128, 512, 2), (480, 640, 512, 4),
    (2000, 3000, 512, 2), (13, 13, 512, 1), (96, 96, 1024, 8)])
def test_bucket_spec_matches_jax(H, W, cap, B):
    assert (dist.default_bucket_spec(H, W, port_cfg(CFG), cap, B)
            == jdist.default_bucket_spec(H, W, CFG, cap, B))


def test_sharded_step_matches_jax(ranks):
    inputs, results = ranks
    ref = jdist.extraction_step(jnp.asarray(inputs["ext_images"]), CFG,
                                tuple(map(tuple, inputs["ext_buckets"])))
    for r in results[1:]:
        for k in dist.DenseFeatures._fields:
            np.testing.assert_array_equal(r[f"ext_{k}"],
                                          results[0][f"ext_{k}"])
    out = dist.DenseFeatures(**{k: torch.from_numpy(
        np.asarray(results[0][f"ext_{k}"]))
        for k in dist.DenseFeatures._fields})
    pairs = assert_same_features(ref, out, overflow=int(ref.overflow))
    imgs = n(out.img_idx)[list(pairs.values())]
    assert sorted(set(imgs.tolist())) == list(range(8))


@pytest.mark.parametrize("dp", [1, 2])
def test_pipeline_matches_staged(dp):
    cfg = port_cfg(CFG)
    imgs = _images(n=4, h=96, w=96, seed=11)
    buckets = dist.default_bucket_spec(96, 96, cfg, per_image_cap=256,
                                       batch=2)
    pipe = dist.PipelinedExtractor(cfg, buckets, devices=["cpu"] * 2 * dp,
                                   data_parallel=dp)
    batches = [imgs[:2], imgs[2:]]
    outs = list(pipe(batches))
    assert len(outs) == 2
    for mb, out in zip(batches, outs):
        ref = dist.extraction_step_staged(mb, cfg, buckets, device="cpu")
        assert int(out.overflow) == int(ref.overflow)
        if dp == 2:      # lanes: per-lane slots, the same keypoints
            pairs = match_slots(ref, out)
            i, j = map(list, zip(*pairs.items()))
            np.testing.assert_array_equal(n(out.desc)[j], n(ref.desc)[i])
            continue
        assert torch.equal(out.valid, ref.valid)
        v = ref.valid
        for f in ("x", "y", "s", "a11", "a21", "a22", "response"):
            np.testing.assert_allclose(n(getattr(out, f))[v],
                                       n(getattr(ref, f))[v], rtol=0,
                                       atol=1e-5)
        assert torch.equal(out.desc[v], ref.desc[v])


def test_ring_knn2_matches_jax(ranks):
    inputs, results = ranks
    ring = shard_map(lambda qq, dd: jring_knn2(qq, dd, "data"), mesh=_mesh(),
                     in_specs=(P("data"), P("data")), out_specs=P("data"))
    ref = ring(jnp.asarray(inputs["ring_q"]), jnp.asarray(inputs["ring_db"]))
    for k in ("idx", "dist", "dist2"):
        got = np.concatenate([r[f"ring_{k}"] for r in results])
        np.testing.assert_array_equal(got, np.asarray(getattr(ref, k)))
    got_idx = np.concatenate([r["ring_idx"] for r in results])
    dense = knn2(inputs["ring_q"], inputs["ring_db"], device="cpu")
    # the planted ties: the ring keeps the shard it visits first (its own,
    # then r-1, r-2, ...), dense knn2 the lowest index
    tied = [r * QS + i for r, i in ((0, 2), (1, 2), (2, 1))]
    assert (n(dense.dist)[tied] == n(dense.dist2)[tied]).all()
    assert got_idx[tied].tolist() == [5, DS + 5, DS + 5]
    assert n(dense.idx)[tied].tolist() == [5, 5, 5]
    rest = np.ones(len(got_idx), bool)
    rest[tied] = False
    np.testing.assert_array_equal(got_idx[rest], n(dense.idx)[rest])


def test_sharded_votes_match_jax(ranks):
    inputs, results = ranks
    corpus, q = _votes_inputs()
    ref = jsharded_votes(_mesh(), jbuild_index(corpus), q, ratio=0.9)
    dense, _ = query_votes(build_index(corpus), q, ratio=0.9, device="cpu")
    for r in results:
        np.testing.assert_array_equal(r["votes"], ref)
        np.testing.assert_array_equal(r["votes"], dense)
    assert ref.argmax() == 3


def test_ba_sharded_matches_jax(ranks):
    inputs, results = ranks
    b = {k[3:]: v for k, v in inputs.items() if k.startswith("ba_")}
    p = jba.BAProblem(
        cam_rvec=jnp.asarray(b["rvec"]), cam_tvec=jnp.asarray(b["tvec"]),
        points=jnp.asarray(b["points"]), f=float(b["f"]), cx=float(b["cx"]),
        cy=float(b["cy"]), cam_idx=jnp.asarray(b["cam_idx"]),
        pt_idx=jnp.asarray(b["pt_idx"]), uv=jnp.asarray(b["uv"]),
        w=jnp.asarray(b["w"]))
    mesh = _mesh()
    sol, err = jba.ba_solve_sharded(p, mesh=mesh, iterations=20)
    for r in results[1:]:
        for k in ("ba_rvec", "ba_tvec", "ba_points", "ba_err"):
            np.testing.assert_array_equal(r[k], results[0][k])
    got = results[0]
    assert err < 0.45 and abs(float(got["ba_err"]) - err) < 0.02
    np.testing.assert_allclose(got["ba_rvec"], np.asarray(sol.cam_rvec),
                               atol=8e-3)
    np.testing.assert_allclose(got["ba_points"], np.asarray(sol.points),
                               atol=6e-2)

    # one LM step's partial reduced systems, psum'd over the mesh
    tracks, _ = jba.problem_to_tracks(p, pad_points_multiple=NRANKS)

    def partials(points, cam_t, uv_t, w_t):
        tr = tracks._replace(points=points, cam_t=cam_t, uv_t=uv_t, w_t=w_t)
        return jax.lax.psum(jba._tracks_partials(tr, jnp.float32(1e-3))[0],
                            "data")

    ref = jax.jit(shard_map(partials, mesh=mesh, in_specs=(P("data"),) * 4,
                            out_specs=P(), check_vma=False))(
        tracks.points, tracks.cam_t, tracks.uv_t, tracks.w_t)
    for name, want in zip(("Hcc", "gc", "Soff", "rhs_corr"), ref):
        want = np.asarray(want)
        np.testing.assert_allclose(got[f"ba_{name}"], want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


def test_host_shard_and_barrier_without_group():
    assert not torch.distributed.is_initialized()
    assert host_barrier("alone", timeout_s=0.01) is None
    assert dist.host_shard(range(5)) == [0, 1, 2, 3, 4]
    assert dist.host_shard(range(10), 1, 4) == [1, 5, 9]
    with pytest.raises(RuntimeError, match="init_multihost"):
        dist.make_mesh()


def test_drop_host_detection_and_restart(tmp_path):
    sys.path.insert(0, HERE)
    import _torch_drophost_worker as dw

    rounds, die_after = 3, 1
    port = _free_port()
    procs = _launch("_torch_drophost_worker.py",
                    lambda r: (r, 2, port, tmp_path, rounds, die_after,
                               "cpu", 10.0), 2)
    try:
        out0 = procs[0].communicate(timeout=300)[0]
        assert procs[0].returncode == 17, out0     # detected, restart
    finally:
        procs[1].kill()                            # the controller reaps
        procs[1].communicate(timeout=60)           # the wedged host
    assert "HostDropError" in out0 or "liveness barrier" in out0
    with open(tmp_path / "cursor_0.json") as f:
        cur = json.load(f)
    assert cur == {"completed": die_after, "detected_drop_at": die_after}

    # the job restarts in one process from the checkpoints
    results = {}
    for r in range(cur["completed"]):
        results[r] = np.concatenate([
            np.load(tmp_path / f"round{r}_shard{k}.npy") for k in range(2)])
    for r in range(cur["completed"], rounds):
        results[r] = n(knn2(*dw.round_data(r, 2), device="cpu").idx)
    for r in range(rounds):
        want = n(knn2(*dw.round_data(r, 2), device="cpu").idx)
        np.testing.assert_array_equal(results[r], want)
