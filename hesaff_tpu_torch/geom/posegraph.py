"""Pose-graph optimisation over SE(3) (Gauss-Newton / LM, dense).

Port of ``hesaff_tpu/geom/posegraph.py``.  Nodes are world->cam poses
(axis-angle + translation); an edge (i, j) carries the measured pose of
j in i's frame.  The residual of an edge is the se3 log of the predicted
relative pose's inverse composed with the measured one; the Jacobian of
all residuals is ``torch.func.jacfwd`` of the batched residual, the
gauge is fixed by anchoring node 0, and the dense normal equations are
solved in float32 with TF32 off: the graphs are tens to hundreds of
keyframes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd

from hesaff_tpu_torch.geom.se3 import se3_log, so3_exp
from hesaff_tpu_torch.match import full_f32


class PoseGraph(NamedTuple):
    rvec: torch.Tensor       # (N, 3) world->cam axis-angle
    tvec: torch.Tensor       # (N, 3)
    edge_i: torch.Tensor     # (E,) int
    edge_j: torch.Tensor     # (E,) int
    rel_rvec: torch.Tensor   # (E, 3) measured: pose j expressed in i frame
    rel_tvec: torch.Tensor   # (E, 3)
    w: torch.Tensor          # (E,) edge weights


def _edge_residual(ri, ti, rj, tj, rrel, trel):
    """se3 error of measured against predicted relative poses, (E, 6).

    Predicted pose of j in i (world->cam): R_pred = R_j R_i^T, t_pred =
    t_j - R_pred t_i; the residual is se3_log(pred^-1 * meas).
    """
    mv = lambda M, v: (M @ v[..., None])[..., 0]
    Ri = so3_exp(ri)
    Rj = so3_exp(rj)
    Rpred = Rj @ Ri.transpose(-1, -2)
    tpred = tj - mv(Rpred, ti)
    Rmeas = so3_exp(rrel)
    RpT = Rpred.transpose(-1, -2)
    return se3_log(RpT @ Rmeas, mv(RpT, trel - tpred))


def pose_graph_residuals(g: PoseGraph):
    i, j = g.edge_i.long(), g.edge_j.long()
    return (_edge_residual(g.rvec[i], g.tvec[i], g.rvec[j], g.tvec[j],
                           g.rel_rvec, g.rel_tvec)
            * torch.sqrt(g.w)[:, None])


def _rms(g: PoseGraph):
    return torch.sqrt(torch.mean(pose_graph_residuals(g) ** 2))


def _gn_step(g: PoseGraph, lam):
    """One damped Gauss-Newton step: (new graph, its residual rms)."""
    N = g.rvec.shape[0]

    def flat_residual(params):
        return pose_graph_residuals(
            g._replace(rvec=params[:, :3], tvec=params[:, 3:])).reshape(-1)

    with full_f32():
        params = torch.cat([g.rvec, g.tvec], dim=1)            # (N, 6)
        r = flat_residual(params)
        J = jacfwd(flat_residual)(params).reshape(r.shape[0], N * 6)
        H = J.T @ J
        b = J.T @ r
        # gauge fix: anchor node 0
        mask = torch.ones(6 * N, dtype=H.dtype, device=H.device)
        mask[:6] = 0.0
        H = H * mask[:, None] * mask[None, :] + torch.diag(1.0 - mask)
        b = b * mask
        H = H + lam * torch.eye(6 * N, dtype=H.dtype, device=H.device)
        delta = -torch.linalg.solve(H, b).reshape(N, 6)
        new = g._replace(rvec=g.rvec + delta[:, :3],
                         tvec=g.tvec + delta[:, 3:])
        return new, _rms(new)


def pose_graph_solve(g: PoseGraph, iterations: int = 15, lam0: float = 1e-4):
    """LM loop; returns (optimised graph, final edge-residual rms)."""
    lam = lam0
    with full_f32():
        err = float(_rms(g))
    for _ in range(iterations):
        new, new_err = _gn_step(g, lam)
        new_err = float(new_err)
        if np.isfinite(new_err) and new_err < err:
            g, err = new, new_err
            lam = max(lam * 0.5, 1e-10)
        else:
            lam = min(lam * 4.0, 1e6)
    return g, err
