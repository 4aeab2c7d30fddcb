"""Batched-hypothesis RANSAC for two-view geometry (H and F/E).

Port of ``hesaff_tpu/ransac.py``.  All hypotheses are drawn, solved and
scored at once on the run's device: minimal-set sampling is one
(num_hypotheses, k) index draw, model estimation one batched SVD of the
(num_hypotheses, 2k or k, 9) DLT systems, and verification each
hypothesis' count of residuals under the threshold.  For F on the card
that count is one launch of the K8 kernel (ops/cuda_ransac), which
stores no residual; elsewhere the plain version computes the
(num_hypotheses, N) residuals, compares and sums them along N.  The two
counts are equal bit for bit: _f_residuals takes the kernel's float32
operations in its order.  The best hypothesis (first index on ties) is
polished by two rounds of weighted least-squares refit over its inliers
(eigh of the 9x9 normal matrix); a round's model is kept only where it
has at least as many inliers as the model it refits (LO-RANSAC's rule,
taken on the device).  The JAX package keeps every round; the two agree
wherever no round loses inliers.  Where the inliers barely constrain the
model (a few dozen of them, near a plane) the normal matrix's two
smallest eigenvalues are close, and a round can land on a model with a
fraction of the inliers.

Sampling cannot reproduce the JAX package's: its draws come from
``jax.random.choice`` keys.  Here a ``torch.Generator`` on the run's
device, seeded from `seed`, draws each hypothesis' minimal set without
replacement (the k smallest of N uniform keys); the CPU and CUDA
generators give different streams for one seed.  So the port is held
to the JAX package on outcomes (the inlier set and the model), and the
refit arithmetic, which is deterministic, on values.  Everything runs
in float32 with TF32 off, as the JAX package runs.

Each stage runs in a span (utils/profiling): "ransac: draw", "ransac:
solve" (the batched minimal solves), "ransac: score" (every
hypothesis' count and the argmax, read on the host in "sync: best", so
the span holds the scoring's device time) and "ransac: refit" (the two
refits and the final inliers); while tracing, the counter
``ransac_residuals`` grows by hypotheses x points scored.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from hesaff_tpu_torch.match import full_f32
from hesaff_tpu_torch.ops import cuda_ransac
from hesaff_tpu_torch.pipeline import resolve_device
from hesaff_tpu_torch.utils.profiling import counted, span


class RansacResult(NamedTuple):
    model: torch.Tensor        # (3, 3) best H or F
    inliers: torch.Tensor      # (N,) bool
    num_inliers: torch.Tensor  # () int32


def _hartley(c, s):
    """T = [[s, 0, -c0 s], [0, s, -c1 s], [0, 0, 1]] over leading dims."""
    z, o = torch.zeros_like(s), torch.ones_like(s)
    return torch.stack([
        torch.stack([s, z, -c[..., 0] * s], -1),
        torch.stack([z, s, -c[..., 1] * s], -1),
        torch.stack([z, z, o], -1)], -2)


def _normalize_points(pts):
    """Hartley normalization: zero-mean, mean distance sqrt(2).

    pts: (..., n, 2) -> (normalised points, (..., 3, 3) T)."""
    c = pts.mean(-2)
    d = torch.linalg.norm(pts - c[..., None, :], dim=-1).mean(-1)
    s = math.sqrt(2.0) / d.clamp_min(1e-12)
    return (pts - c[..., None, :]) * s[..., None, None], _hartley(c, s)


def _null_vector(A):
    """Right singular vector of the smallest singular value of each
    (..., m, 9) system (full SVD, as the JAX package takes it)."""
    _, _, vh = torch.linalg.svd(A, full_matrices=True)
    return vh[..., -1, :].reshape(A.shape[:-2] + (3, 3))


def _rank2(F):
    """Zero the smallest singular value of each (..., 3, 3) F."""
    uf, sf, vhf = torch.linalg.svd(F)
    sf = torch.cat([sf[..., :2], torch.zeros_like(sf[..., 2:])], -1)
    return (uf * sf[..., None, :]) @ vhf


def _solve_h_4pt(p1, p2):
    """DLT homography from 4 correspondences. p1, p2: (..., 4, 2)."""
    x, y = p1[..., 0], p1[..., 1]
    u, v = p2[..., 0], p2[..., 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    r1 = torch.stack([-x, -y, -o, z, z, z, u * x, u * y, u], -1)
    r2 = torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], -1)
    A = torch.stack([r1, r2], -2).flatten(-3, -2)     # rows r1_0, r2_0, ...
    return _null_vector(A)


def _solve_f_8pt(p1, p2):
    """Normalized 8-point fundamental matrix. p1, p2: (..., 8, 2)."""
    n1, T1 = _normalize_points(p1)
    n2, T2 = _normalize_points(p2)
    x, y = n1[..., 0], n1[..., 1]
    u, v = n2[..., 0], n2[..., 1]
    one = torch.ones_like(x)
    A = torch.stack([u * x, u * y, u, v * x, v * y, v, x, y, one], -1)
    F = _rank2(_null_vector(A))
    return T2.transpose(-1, -2) @ F @ T1


def _homog(p):
    return torch.cat([p, p.new_ones(p.shape[:-1] + (1,))], -1)


def _h_residuals(H, p1, p2):
    """Forward transfer error |H p1 - p2|^2 of each (..., 3, 3) H."""
    ph = _homog(p1) @ H.transpose(-1, -2)
    w = ph[..., 2:3]
    proj = ph[..., :2] / torch.where(w.abs() < 1e-12, 1e-12, w)
    return ((proj - p2) ** 2).sum(-1)


def _f_residuals(F, p1, p2):
    """Sampson distance of each (..., 3, 3) F at every correspondence,
    (..., N), elementwise in the K8 kernel's order of float32 operations
    (csrc/ransac_score.cu): a, b, c the rows of F x1, at, bt the first
    two of F^T x2, (u a + v b + c)^2 over a a + b b + at at + bt bt
    clamped at 1e-12 (a NaN stays NaN)."""
    x, y = p1[:, 0], p1[:, 1]
    u, v = p2[:, 0], p2[:, 1]
    f = lambda i, j: F[..., i, j, None]
    a = f(0, 0) * x + f(0, 1) * y + f(0, 2)
    b = f(1, 0) * x + f(1, 1) * y + f(1, 2)
    c = f(2, 0) * x + f(2, 1) * y + f(2, 2)
    at = f(0, 0) * u + f(1, 0) * v + f(2, 0)
    bt = f(0, 1) * u + f(1, 1) * v + f(2, 1)
    num = (u * a + v * b + c) ** 2
    return num / (a * a + b * b + at * at + bt * bt).clamp_min(1e-12)


def _normalize_masked(pts, w):
    """Hartley normalization restricted to weighted points."""
    wsum = w.sum().clamp_min(1e-9)
    c = (pts * w[:, None]).sum(0) / wsum
    d = (torch.linalg.norm(pts - c, dim=1) * w).sum() / wsum
    s = math.sqrt(2.0) / d.clamp_min(1e-12)
    return (pts - c) * s, _hartley(c, s)


def _smallest_eigvec(A):
    """Eigenvector of the smallest eigenvalue of A^T A (9x9)."""
    _, vecs = torch.linalg.eigh(A.t() @ A)
    return vecs[:, 0].reshape(3, 3)


def _refit_h(p1, p2, w):
    """Weighted DLT homography over inliers via the 9x9 normal matrix."""
    n1, T1 = _normalize_masked(p1, w)
    n2, T2 = _normalize_masked(p2, w)
    x, y = n1[:, 0], n1[:, 1]
    u, v = n2[:, 0], n2[:, 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    r1 = torch.stack([-x, -y, -o, z, z, z, u * x, u * y, u], 1)
    r2 = torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], 1)
    A = torch.cat([r1 * w[:, None], r2 * w[:, None]])
    return torch.linalg.solve(T2, _smallest_eigvec(A) @ T1)


def _refit_f(p1, p2, w):
    """Weighted 8-point fundamental over inliers (normalized, rank-2)."""
    n1, T1 = _normalize_masked(p1, w)
    n2, T2 = _normalize_masked(p2, w)
    x, y = n1[:, 0], n1[:, 1]
    u, v = n2[:, 0], n2[:, 1]
    o = torch.ones_like(x)
    A = torch.stack([u * x, u * y, u, v * x, v * y, v, x, y, o], 1)
    F = _rank2(_smallest_eigvec(A * w[:, None]))
    return T2.t() @ F @ T1


_MODELS = {
    "homography": (_solve_h_4pt, _h_residuals, _refit_h),
    "fundamental": (_solve_f_8pt, _f_residuals, _refit_f),
}


def draw_minimal_sets(n: int, num_hypotheses: int, min_set: int,
                      generator: torch.Generator) -> torch.Tensor:
    """(num_hypotheses, min_set) int64 indices, each row `min_set`
    distinct points of `n` (the `min_set` smallest of n uniform keys),
    on the generator's device."""
    if n < min_set:
        raise ValueError(f"cannot take a sample of {min_set} points from "
                         f"{n} without replacement")
    keys = torch.rand(num_hypotheses, n, generator=generator,
                      device=generator.device)
    return keys.topk(min_set, dim=1, largest=False).indices


def _ransac(generator, p1, p2, model: str, threshold: float,
            num_hypotheses: int, min_set: int) -> RansacResult:
    solve, resid, refit = _MODELS[model]
    with span("ransac: draw"):
        sel = draw_minimal_sets(p1.shape[0], num_hypotheses, min_set,
                                generator)
    with full_f32():
        with span("ransac: solve"):
            models = solve(p1[sel], p2[sel])
        with span("ransac: score"):
            if model == "fundamental" and p1.is_cuda:
                counts = cuda_ransac.sampson_counts(models, p1, p2,
                                                    threshold)
            else:
                counts = (resid(models, p1, p2) < threshold).sum(1)
            # the refits' eigh waits for the scores anyway; waiting here
            # keeps the scoring's device time inside its span
            with span("sync: best"):
                best = int(counts.argmax())
            M = models[best]
            scored = counted("ransac_residuals", p1.device)
            if scored is not None:
                scored += num_hypotheses * p1.shape[0]
        with span("ransac: refit"):
            # local-optimization polish: two rounds of inlier
            # least-squares refit, each kept where it loses no inlier
            inl = resid(M, p1, p2) < threshold
            n = inl.sum()
            for _ in range(2):
                M_new = refit(p1, p2, inl.to(torch.float32))
                inl_new = resid(M_new, p1, p2) < threshold
                n_new = inl_new.sum()
                keep = n_new >= n
                M = torch.where(keep, M_new, M)
                inl = torch.where(keep, inl_new, inl)
                n = torch.maximum(n, n_new)
    return RansacResult(model=M, inliers=inl,
                        num_inliers=n.to(torch.int32))


def _f32(a, dev):
    return torch.as_tensor(a, dtype=torch.float32, device=dev)


def _run(pts1, pts2, model, threshold, num_hypotheses, min_set, seed,
         device) -> RansacResult:
    dev = resolve_device(pts1, device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return _ransac(g, _f32(pts1, dev), _f32(pts2, dev), model, threshold,
                   num_hypotheses, min_set)


def ransac_homography(pts1, pts2, threshold: float = 9.0,
                      num_hypotheses: int = 1024, seed: int = 0,
                      device=None) -> RansacResult:
    """Parallel-hypothesis RANSAC homography.

    pts1, pts2: (N, 2) matched coordinates; threshold: squared px error.
    Runs on `device` (default: pts1's device if a tensor, else the GPU).
    """
    return _run(pts1, pts2, "homography", threshold, num_hypotheses, 4,
                seed, device)


def ransac_fundamental(pts1, pts2, threshold: float = 3.0,
                       num_hypotheses: int = 1024, seed: int = 0,
                       device=None) -> RansacResult:
    """Parallel-hypothesis RANSAC fundamental matrix (Sampson gating)."""
    return _run(pts1, pts2, "fundamental", threshold, num_hypotheses, 8,
                seed, device)


def essential_from_fundamental(F, K1, K2, device=None):
    """E = K2^T F K1, singular values balanced to (1, 1, 0)."""
    dev = resolve_device(F, device)
    with full_f32():
        E = _f32(K2, dev).t() @ _f32(F, dev) @ _f32(K1, dev)
        u, s, vh = torch.linalg.svd(E)
        m = (s[0] + s[1]) / 2.0
        return (u * torch.stack([m, m, torch.zeros_like(m)])[None, :]) @ vh


def decompose_essential(E, pts1_norm, pts2_norm, device=None):
    """Recover (R, t) from E via the cheirality check.

    pts*_norm: (N, 2) K-normalized image coordinates of inlier matches.
    Returns (R, t) with the most points in front of both cameras (the
    first of the four candidates on ties).
    """
    dev = resolve_device(E, device)
    E = _f32(E, dev)
    p1, p2 = _f32(pts1_norm, dev), _f32(pts2_norm, dev)
    with full_f32():
        u, _, vh = torch.linalg.svd(E)
        # ensure proper rotations
        u = u * torch.sign(torch.linalg.det(u))
        vh = vh * torch.sign(torch.linalg.det(vh))
        W = _f32([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dev)
        Rs = [u @ W @ vh, u @ W.t() @ vh]
        ts = [u[:, 2], -u[:, 2]]
        Rstack = torch.stack([R for R in Rs for _ in ts])
        tstack = torch.stack([t for _ in Rs for t in ts])
        z1, z2 = _triangulate_depths(Rstack, tstack, p1, p2)
        counts = ((z1 > 0) & (z2 > 0)).sum(-1)
    best = counts.argmax()
    return Rstack[best], tstack[best]


def _triangulate_depths(R, t, p1, p2):
    """Linear triangulation depths for cheirality.

    R: (..., 3, 3), t: (..., 3); p1, p2: (N, 2).  For each point,
    X = z1*a in camera 1 and z2*b = R(z1*a) + t in camera 2, so
    z1*(R a) - z2*b = -t, solved in least squares: each system is a
    3x2 A, tall and of full rank unless a ray lies along the baseline,
    which the QR driver (`gels`, the one CUDA has) needs.  Returns
    (z1, z2) of shape (..., N).
    """
    x1, x2 = _homog(p1), _homog(p2)
    Ra = x1 @ R.transpose(-1, -2)                          # (..., N, 3)
    A = torch.stack([Ra, -x2.expand_as(Ra)], -1)           # (..., N, 3, 2)
    b = (-t)[..., None, :, None].expand(A.shape[:-1] + (1,))
    sol = torch.linalg.lstsq(A, b, driver="gels").solution[..., 0]
    return sol[..., 0], sol[..., 1]
