"""Schur-complement bundle adjustment (Levenberg-Marquardt).

Port of ``hesaff_tpu/geom/ba.py`` on tensors of any device, in float32
with TF32 off (``match.full_f32``) around every product and solve:

  * residuals and Jacobians: one function of an observation's 9 local
    degrees of freedom, differentiated by ``torch.func.jacfwd`` under
    ``torch.func.vmap``, as the JAX package takes ``jax.jacfwd`` under
    ``jax.vmap``;
  * per-camera and per-point blocks are summed over observations;
    ``ba_solve`` keeps the camera-point coupling E dense as (C, P, 6, 3)
    and reduces S = B - E D^-1 E^T with two einsums; the reduced
    (6C x 6C) system is solved dense;
  * the track form (``ba_solve_sharded``) groups the observations per
    point (BATracks), so memory is O(observations) instead of C * P;
    over a process group the points and their tracks are sharded and
    each LM step all-reduces the partial reduced camera system.

The JAX package sums observations with ``.at[].add``, a scatter-add.
On a GPU ``index_add_`` sums with atomics in an arbitrary order, so an
LM step would round differently from run to run and LM's accept /
reject could differ.  Here every such sum is a `Segments` sum: the
observations sorted by target once per problem, then a fixed tree of
elementwise adds within each target's run.  It gives the same bits on
every run and on the CPU and the GPU alike for equal inputs.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as tdist
from torch.func import jacfwd, vmap

from hesaff_tpu_torch import comm
from hesaff_tpu_torch.geom.se3 import so3_exp
from hesaff_tpu_torch.match import full_f32
from hesaff_tpu_torch.pipeline import resolve_device


class BAProblem(NamedTuple):
    """Static-shape BA problem (tensors on one device).

    cam_rvec: (C, 3) axis-angle world->cam rotations
    cam_tvec: (C, 3) translations
    points:   (P, 3)
    f, cx, cy: floats (shared pinhole intrinsics)
    cam_idx, pt_idx: (O,) int observation incidence
    uv:       (O, 2) measured pixels
    w:        (O,) observation weights (0 masks an observation out)
    """

    cam_rvec: torch.Tensor
    cam_tvec: torch.Tensor
    points: torch.Tensor
    f: float
    cx: float
    cy: float
    cam_idx: torch.Tensor
    pt_idx: torch.Tensor
    uv: torch.Tensor
    w: torch.Tensor


class Segments:
    """Deterministic sums of rows by a fixed target index.

    index: (M,) targets in [0, n).  The rows are sorted by target once
    (stable); `sum` then runs an inclusive segmented scan of
    ceil(log2(longest run)) steps of elementwise adds (Hillis-Steele:
    step d adds the row d places back where it has the same target)
    and keeps each run's last row.  No atomics: the bits depend on the
    values alone.
    """

    def __init__(self, index: torch.Tensor, n: int):
        index = index.reshape(-1).long()
        self.n = n
        self.order = torch.argsort(index, stable=True)
        s = index[self.order]
        M = s.numel()
        last = torch.ones(M, dtype=torch.bool, device=s.device)
        last[:-1] = s[1:] != s[:-1]
        self.last = last.nonzero()[:, 0]
        self.target = s[self.last]
        longest = int(torch.bincount(index, minlength=1).max()) if M else 0
        self.steps = []
        d = 1
        while d < longest:
            self.steps.append((d, s[d:] == s[:-d]))
            d *= 2

    def sum(self, values: torch.Tensor) -> torch.Tensor:
        """(M, ...) rows -> (n, ...) sums by target (zero where none)."""
        v = values[self.order]
        for d, same in self.steps:
            keep = same.reshape((-1,) + (1,) * (v.dim() - 1))
            v = torch.cat([v[:d], v[d:] + torch.where(keep, v[:-d], 0.0)])
        out = values.new_zeros((self.n,) + tuple(values.shape[1:]))
        out[self.target] = v[self.last]
        return out


def project(rvec, tvec, X, f, cx, cy):
    """Pinhole projection of points X (..., 3) into cameras (..., 3).

    The depth keeps a trailing axis: under torch.func.jacfwd an
    arithmetic of a 0-d tensor and a Python float gives float64
    tangents."""
    R = so3_exp(rvec)
    Xc = (R @ X[..., None])[..., 0] + tvec
    z = torch.clamp_min(Xc[..., 2:3], 1e-6)
    return f * Xc[..., :2] / z + Xc.new_tensor([cx, cy])


def _residual_one(cam6, X, uv, f, cx, cy):
    return project(cam6[..., :3], cam6[..., 3:], X, f, cx, cy) - uv


def _residuals_and_jacobians(cams, X, uv, f, cx, cy):
    """r (O, 2), Jc (O, 2, 6), Jp (O, 2, 3) of each observation."""
    res = lambda c6, x, u: _residual_one(c6, x, u, f, cx, cy)
    r = res(cams, X, uv)
    Jc, Jp = vmap(jacfwd(res, argnums=(0, 1)))(cams, X, uv)
    return r, Jc, Jp


def reprojection_rmse(p: BAProblem):
    cams = torch.cat([p.cam_rvec, p.cam_tvec], dim=1)
    with full_f32():
        r = _residual_one(cams[p.cam_idx.long()], p.points[p.pt_idx.long()],
                          p.uv, p.f, p.cx, p.cy)
        wsum = torch.clamp_min(torch.sum(p.w), 1.0)
        return torch.sqrt(torch.sum(torch.sum(r * r, dim=1) * p.w) / wsum)


def problem_segments(p: BAProblem):
    """The Segments sums of _build_system: by camera, by point, and by
    (camera, point) pair for the dense coupling E."""
    C, P = p.cam_rvec.shape[0], p.points.shape[0]
    ci, pi = p.cam_idx.long(), p.pt_idx.long()
    return Segments(ci, C), Segments(pi, P), Segments(ci * P + pi, C * P)


def _build_system(p: BAProblem, segs=None):
    """Per-observation Jacobians -> (Hcc, Hpp, E, g_c, g_p)."""
    C, P = p.cam_rvec.shape[0], p.points.shape[0]
    by_cam, by_pt, by_pair = segs or problem_segments(p)
    cams = torch.cat([p.cam_rvec, p.cam_tvec], dim=1)
    r, Jc, Jp = _residuals_and_jacobians(
        cams[p.cam_idx.long()], p.points[p.pt_idx.long()], p.uv, p.f, p.cx,
        p.cy)
    wo = p.w[:, None, None]
    Hcc_o = torch.einsum("oki,okj->oij", Jc, Jc) * wo         # (O, 6, 6)
    Hpp_o = torch.einsum("oki,okj->oij", Jp, Jp) * wo         # (O, 3, 3)
    E_o = torch.einsum("oki,okj->oij", Jc, Jp) * wo           # (O, 6, 3)
    gc_o = torch.einsum("oki,ok->oi", Jc, r) * p.w[:, None]   # (O, 6)
    gp_o = torch.einsum("oki,ok->oi", Jp, r) * p.w[:, None]   # (O, 3)
    return (by_cam.sum(Hcc_o), by_pt.sum(Hpp_o),
            by_pair.sum(E_o).reshape(C, P, 6, 3), by_cam.sum(gc_o),
            by_pt.sum(gp_o))


def _damp(H, lam):
    """Marquardt damping: lam times each block's own diagonal (floored
    at 1e-6) added to it."""
    d = torch.diagonal(H, dim1=-2, dim2=-1)
    dm = torch.clamp_min(d, 1e-6)
    n = H.shape[-1]
    return H + lam * dm[..., None] * torch.eye(n, dtype=H.dtype,
                                               device=H.device)


def _camera_solve(S, rhs, fix_first_cam: bool):
    """Solve the reduced (C, C, 6, 6) system S dc = -rhs with camera 0
    pinned (gauge) and Jacobi rescaling for a float32-friendly solve."""
    C = S.shape[0]
    Sm = S.permute(0, 2, 1, 3).reshape(6 * C, 6 * C)
    rv = rhs.reshape(6 * C)
    if fix_first_cam:
        mask = torch.ones(6 * C, dtype=S.dtype, device=S.device)
        mask[:6] = 0.0
        Sm = Sm * mask[:, None] * mask[None, :] + torch.diag(1.0 - mask)
        rv = rv * mask
    scale = 1.0 / torch.sqrt(torch.clamp_min(torch.diagonal(Sm), 1e-8))
    Sm = Sm * scale[:, None] * scale[None, :]
    return -(torch.linalg.solve(Sm, rv * scale) * scale).reshape(C, 6)


def _schur_solve(Hcc, Hpp, E, gc, gp, lam, fix_first_cam: bool):
    """Damped Schur reduction, dense camera solve, back-substitution.

    Marquardt damping and the Jacobi rescaling keep the solve well
    conditioned in float32 (the raw pixel-scale normal equations span
    ~10 orders of magnitude).
    """
    C = Hcc.shape[0]
    Dinv = torch.linalg.inv(_damp(Hpp, lam))                  # (P, 3, 3)
    # S = blockdiag(Hcc) - E Dinv E^T
    ED = torch.einsum("cpij,pjk->cpik", E, Dinv)              # (C, P, 6, 3)
    S = -torch.einsum("cpik,dpjk->cdij", ED, E)               # (C, C, 6, 6)
    ar = torch.arange(C, device=S.device)
    S[ar, ar] = S[ar, ar] + _damp(Hcc, lam)
    rhs = gc - torch.einsum("cpik,pk->ci", ED, gp)            # (C, 6)
    dc = _camera_solve(S, rhs, fix_first_cam)
    # back-substitute points: dp = -Dinv (gp + E^T dc)
    Etdc = torch.einsum("cpij,ci->pj", E, dc)                 # (P, 3)
    dp = -torch.einsum("pij,pj->pi", Dinv, gp + Etdc)
    return dc, dp


def _lm_step(p: BAProblem, lam, fix_first_cam: bool = True, segs=None):
    """One damped Gauss-Newton step: (new problem, its rmse)."""
    with full_f32():
        Hcc, Hpp, E, gc, gp = _build_system(p, segs)
        dc, dp = _schur_solve(Hcc, Hpp, E, gc, gp, lam, fix_first_cam)
    new = p._replace(cam_rvec=p.cam_rvec + dc[:, :3],
                     cam_tvec=p.cam_tvec + dc[:, 3:],
                     points=p.points + dp)
    return new, reprojection_rmse(new)


def save_checkpoint(path: str, p: BAProblem, lam: float = 1e-3,
                    iteration: int = 0) -> None:
    """Checkpoint BA state (parameters, damping, progress) to an .npz
    (the JAX package's format, so either package reads it)."""
    h = lambda t: t.detach().cpu().numpy() if isinstance(
        t, torch.Tensor) else np.asarray(t)
    np.savez_compressed(
        path, cam_rvec=h(p.cam_rvec), cam_tvec=h(p.cam_tvec),
        points=h(p.points), f=p.f, cx=p.cx, cy=p.cy,
        cam_idx=h(p.cam_idx), pt_idx=h(p.pt_idx), uv=h(p.uv), w=h(p.w),
        lam=lam, iteration=iteration)


def load_checkpoint(path: str, device=None):
    """Load a BA checkpoint -> (BAProblem on `device` (the GPU unless
    "cpu" is asked for), lam, iteration)."""
    dev = resolve_device(None, device)
    d = np.load(path)
    t = lambda k: torch.as_tensor(d[k], device=dev)
    p = BAProblem(
        cam_rvec=t("cam_rvec"), cam_tvec=t("cam_tvec"), points=t("points"),
        f=float(d["f"]), cx=float(d["cx"]), cy=float(d["cy"]),
        cam_idx=t("cam_idx"), pt_idx=t("pt_idx"), uv=t("uv"), w=t("w"))
    return p, float(d["lam"]), int(d["iteration"])


class BATracks(NamedTuple):
    """Track-layout BA problem: observations grouped per point.

    cam_t: (P, T) int32 camera index of each observation of each point;
    uv_t:  (P, T, 2) measured pixels;  w_t: (P, T) weights (0 = padding).
    Memory is O(P*T) = O(observations): no C*P coupling tensor.
    """

    cam_rvec: torch.Tensor
    cam_tvec: torch.Tensor
    points: torch.Tensor
    f: float
    cx: float
    cy: float
    cam_t: torch.Tensor
    uv_t: torch.Tensor
    w_t: torch.Tensor


def problem_to_tracks(p: BAProblem, track_cap: int | None = None,
                      pad_points_multiple: int = 1):
    """Group a flat observation list into per-point tracks (on the host,
    results on p's device).

    Returns (BATracks, n_dropped): observations beyond track_cap per
    point are dropped and counted.  Points are padded with zero-weight
    slots to a multiple of pad_points_multiple.
    """
    h = lambda t: t.detach().cpu().numpy()
    cam_idx, pt_idx = h(p.cam_idx), h(p.pt_idx)
    uv = h(p.uv).astype(np.float32)
    w = h(p.w).astype(np.float32)
    P = int(p.points.shape[0])

    live = w > 0
    counts = np.bincount(pt_idx[live], minlength=P)
    T = int(max(1, counts.max())) if track_cap is None else int(track_cap)

    order = np.argsort(pt_idx[live], kind="stable")
    pts_s = pt_idx[live][order]
    # slot of each observation within its point's track (0-based)
    slot = np.arange(pts_s.size) - np.searchsorted(pts_s, pts_s)
    keep = slot < T
    n_dropped = int((~keep).sum())

    Ppad = ((P + pad_points_multiple - 1)
            // pad_points_multiple) * pad_points_multiple
    cam_t = np.zeros((Ppad, T), np.int32)
    uv_t = np.zeros((Ppad, T, 2), np.float32)
    w_t = np.zeros((Ppad, T), np.float32)
    rows, cols = pts_s[keep], slot[keep]
    src = np.flatnonzero(live)[order][keep]
    cam_t[rows, cols] = cam_idx[src]
    uv_t[rows, cols] = uv[src]
    w_t[rows, cols] = w[src]

    points = np.zeros((Ppad, 3), np.float32)
    points[:P] = h(p.points).astype(np.float32)
    dev = p.points.device
    t = lambda a: torch.as_tensor(a, device=dev)
    return BATracks(
        cam_rvec=p.cam_rvec, cam_tvec=p.cam_tvec, points=t(points),
        f=p.f, cx=p.cx, cy=p.cy, cam_t=t(cam_t), uv_t=t(uv_t),
        w_t=t(w_t)), n_dropped


def tracks_segments(tr: BATracks):
    """The Segments sums of _tracks_partials: by camera of each track
    slot, and by (camera, camera) pair of each slot pair."""
    C = tr.cam_rvec.shape[0]
    Pl, T = tr.w_t.shape
    cam = tr.cam_t.long()
    ci = cam[:, :, None].expand(Pl, T, T)
    cj = cam[:, None, :].expand(Pl, T, T)
    return Segments(cam, C), Segments(ci * C + cj, C * C)


def _tracks_partials(tr: BATracks, lam, segs=None):
    """Schur partials of the tracks' points.

    Returns (Hcc, gc, Soff, rhs_corr), the sums a process group would
    reduce, and the local (Dinv, E_t, gp) of the back-substitution.
    """
    C = tr.cam_rvec.shape[0]
    Pl, T = tr.w_t.shape
    by_cam, by_pair = segs or tracks_segments(tr)
    cams = torch.cat([tr.cam_rvec, tr.cam_tvec], dim=1)
    cam_flat = tr.cam_t.reshape(-1).long()
    w_flat = tr.w_t.reshape(-1)
    r, Jc, Jp = _residuals_and_jacobians(
        cams[cam_flat], tr.points.repeat_interleave(T, dim=0),
        tr.uv_t.reshape(-1, 2), tr.f, tr.cx, tr.cy)

    Hcc_o = torch.einsum("oki,okj->oij", Jc, Jc) * w_flat[:, None, None]
    gc_o = torch.einsum("oki,ok->oi", Jc, r) * w_flat[:, None]
    Hcc = by_cam.sum(Hcc_o)
    gc = by_cam.sum(gc_o)

    wt = tr.w_t
    Hpp = torch.einsum("oki,okj->oij", Jp, Jp).reshape(Pl, T, 3, 3)
    Hpp = torch.sum(Hpp * wt[..., None, None], dim=1)         # (Pl, 3, 3)
    gp = torch.einsum("oki,ok->oi", Jp, r).reshape(Pl, T, 3)
    gp = torch.sum(gp * wt[..., None], dim=1)                 # (Pl, 3)
    E_t = (torch.einsum("oki,okj->oij", Jc, Jp).reshape(Pl, T, 6, 3)
           * wt[..., None, None])                             # (Pl, T, 6, 3)

    Dinv = torch.linalg.inv(_damp(Hpp, lam))                  # (Pl, 3, 3)
    ED = torch.einsum("ptik,pkl->ptil", E_t, Dinv)            # (Pl, T, 6, 3)
    # same-point camera-pair couplings -> the reduced system's blocks
    pair = torch.einsum("ptik,psjk->ptsij", ED, E_t)          # (Pl,T,T,6,6)
    Soff = by_pair.sum(pair.reshape(-1, 6, 6)).reshape(C, C, 6, 6)
    rhs_corr = by_cam.sum(
        torch.einsum("ptik,pk->pti", ED, gp).reshape(-1, 6))
    return (Hcc, gc, Soff, rhs_corr), (Dinv, E_t, gp)


def _reduced_solve(Hcc, gc, Soff, rhs_corr, lam, fix_first_cam: bool):
    """Damped reduced camera solve."""
    C = Hcc.shape[0]
    S = -Soff
    ar = torch.arange(C, device=S.device)
    S[ar, ar] = S[ar, ar] + _damp(Hcc, lam)
    return _camera_solve(S, gc - rhs_corr, fix_first_cam)


def _tracks_rmse_parts(tr: BATracks):
    cams = torch.cat([tr.cam_rvec, tr.cam_tvec], dim=1)
    T = tr.w_t.shape[1]
    with full_f32():
        r = _residual_one(cams[tr.cam_t.reshape(-1).long()],
                          tr.points.repeat_interleave(T, dim=0),
                          tr.uv_t.reshape(-1, 2), tr.f, tr.cx, tr.cy)
        w = tr.w_t.reshape(-1)
        return torch.sum(torch.sum(r * r, dim=1) * w), torch.sum(w)


def _reduce_parts(parts, group):
    """The sum over the group of each rank's (Hcc, gc, Soff, rhs_corr):
    one all_reduce of the four, flattened in that order."""
    flat = comm.all_reduce_sum(torch.cat([t.reshape(-1) for t in parts]),
                               group)
    sizes = [t.numel() for t in parts]
    return tuple(x.reshape(t.shape)
                 for x, t in zip(flat.split(sizes), parts))


def _tracks_rmse(tr: BATracks, group=None):
    """Reprojection rmse of the tracks, over the group's shards."""
    sq, wsum = _tracks_rmse_parts(tr)
    if group is not None:
        sq, wsum = comm.all_reduce_sum(torch.stack([sq, wsum]),
                                       group).unbind()
    return torch.sqrt(sq / torch.clamp_min(wsum, 1.0))


def _tracks_lm_step(tr: BATracks, lam, fix_first_cam: bool, segs=None,
                    group=None):
    """One LM step on track-layout data: (new tracks, rmse).  Over a
    process group, tr holds this rank's points and the partials and
    the rmse are summed over the group; the cameras and the reduced
    solve are the same on every rank."""
    with full_f32():
        parts, (Dinv, E_t, gp) = _tracks_partials(tr, lam, segs)
        if group is not None:
            parts = _reduce_parts(parts, group)
        dc = _reduced_solve(*parts, lam, fix_first_cam)
        # back-substitute: dp = -Dinv (gp + sum_t E_t^T dc[cam_t])
        Etdc = torch.einsum("ptij,pti->pj", E_t, dc[tr.cam_t.long()])
        dp = -torch.einsum("pij,pj->pi", Dinv, gp + Etdc)
    new = tr._replace(cam_rvec=tr.cam_rvec + dc[:, :3],
                      cam_tvec=tr.cam_tvec + dc[:, 3:],
                      points=tr.points + dp)
    return new, _tracks_rmse(new, group)


def _lm_loop(step, state, err: float, iterations: int, lam0: float,
             lam_min: float, verbose: bool, label: str):
    """Levenberg-Marquardt with multiplicative damping adaptation: a step
    is kept when its rmse is finite and lower."""
    lam = lam0
    for it in range(iterations):
        new, new_err = step(state, lam)
        new_err = float(new_err)
        if np.isfinite(new_err) and new_err < err:
            state, err = new, new_err
            lam = max(lam * 0.5, lam_min)
        else:
            lam = min(lam * 4.0, 1e6)
        if verbose:
            print(f"{label} iter {it}: rmse {err:.4f} lam {lam:.1e}")
    return state, err


def ba_solve_sharded(p: BAProblem, mesh=None, iterations: int = 20,
                     lam0: float = 1e-3, fix_first_cam: bool = True,
                     track_cap: int | None = None, verbose: bool = False):
    """Track-layout Schur BA, on one device or over a process group.

    mesh=None: the track form on p's device, the O(observations)
    replacement for the dense-E `ba_solve`.  mesh: a process group
    (dist.make_mesh) whose every rank calls this with the same problem:
    the points, padded to a multiple of the group's size, and their
    tracks are split into equal shards, rank r taking the r-th; the
    cameras are replicated.  Each LM step sums the rank's share of the
    reduced camera system through `Segments` and all-reduces the four
    partials in one collective, solves the (6C x 6C) system on every
    rank, back-substitutes the rank's points, and all-reduces the rmse's
    two sums, so every rank takes the same accept / reject.  At the end
    the points are gathered to every rank.  Communication is O(C^2) a
    step, whatever the point count.  Over a group of one rank the
    result is bit-equal to mesh=None's.

    Returns (BAProblem with refined parameters, final rmse).
    """
    if mesh is not None and not isinstance(mesh, tdist.ProcessGroup):
        raise ValueError("ba_solve_sharded: mesh must be a process group "
                         "(dist.make_mesh), or mesh=None for one device")
    r, n = (0, 1) if mesh is None else comm.rank_and_size(mesh)
    tracks, dropped = problem_to_tracks(p, track_cap=track_cap,
                                        pad_points_multiple=n)
    if verbose and dropped:
        print(f"BA tracks: dropped {dropped} observations over track cap")
    P = int(p.points.shape[0])
    Pl = tracks.points.shape[0] // n
    mine = slice(r * Pl, (r + 1) * Pl)
    tracks = tracks._replace(
        points=tracks.points[mine], cam_t=tracks.cam_t[mine],
        uv_t=tracks.uv_t[mine], w_t=tracks.w_t[mine])
    segs = tracks_segments(tracks)
    err = float(_tracks_rmse(tracks, mesh))
    tracks, err = _lm_loop(
        lambda tr, lam: _tracks_lm_step(tr, lam, fix_first_cam, segs, mesh),
        tracks, err, iterations, lam0, 1e-9, verbose, "BA[tracks]")
    points = (tracks.points if mesh is None
              else comm.all_gather_cat(tracks.points, mesh))
    return p._replace(cam_rvec=tracks.cam_rvec, cam_tvec=tracks.cam_tvec,
                      points=points[:P]), err


def ba_solve(p: BAProblem, iterations: int = 20, lam0: float = 1e-3,
             fix_first_cam: bool = True, verbose: bool = False):
    """Levenberg-Marquardt with multiplicative damping adaptation over
    dense-E Schur steps (LM's accept / reject is sequential: one host
    read of the rmse a step).  Returns (refined BAProblem, rmse)."""
    segs = problem_segments(p)
    return _lm_loop(lambda q, lam: _lm_step(q, lam, fix_first_cam, segs),
                    p, float(reprojection_rmse(p)), iterations, lam0, 1e-9,
                    verbose, "BA")
