"""SO(3) / SE(3) exponential and logarithm maps (closed form, batched).

Port of ``hesaff_tpu/geom/se3.py``, operation for operation, on tensors
of any leading shape and device.  The small-angle branches are
polynomials in theta^2 = sum(w^2) (never a sqrt or arccos of a
near-degenerate argument), so values and forward-mode derivatives
(``torch.func.jacfwd``, which bundle adjustment and the pose graph take)
stay finite and right at and around the identity.  As for any
single-chart log, so3_log's derivatives blow up near theta = pi.
"""

from __future__ import annotations

import torch

# branch switchover on theta^2; below it the Taylor forms are more
# accurate in float32 than the trigonometric ones (1 - cos cancels)
_SMALL2 = 1e-6


def _eye3(like: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(shape)


def hat(w):
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], -1),
        torch.stack([wz, z, -wx], -1),
        torch.stack([-wy, wx, z], -1),
    ], -2)


def _abc(t2):
    """a = sin(t)/t, b = (1-cos t)/t^2, c = (t-sin t)/t^3 from t2 = t^2.

    The trigonometric branch evaluates at ts = sqrt(t2) only where it is
    taken (elsewhere at 1), so its derivative is finite everywhere.
    """
    small = t2 < _SMALL2
    ts2 = torch.where(small, torch.ones_like(t2), t2)
    ts = torch.sqrt(ts2)
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(ts) / ts)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(ts)) / ts2)
    c = torch.where(small, 1.0 / 6.0 - t2 / 120.0,
                    (ts - torch.sin(ts)) / (ts2 * ts))
    return a, b, c


def so3_exp(w):
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3) (Rodrigues)."""
    t2 = torch.sum(w * w, dim=-1)[..., None, None]
    K = hat(w)
    K2 = K @ K
    a, b, _ = _abc(t2)
    return _eye3(w, K.shape) + a * K + b * K2


def so3_log(R):
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3).

    w = fac * vee(R - R^T), fac = theta / (2 sin theta).  Near the
    identity fac is a polynomial in s2 = |vee|^2 / 4 = sin^2(theta).
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    vee = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], -1)
    s2 = torch.sum(vee * vee, dim=-1) / 4.0     # sin^2(theta)
    small = cos > 1.0 - 1e-4                    # theta < ~1.4e-2
    cos_safe = torch.where(small, torch.zeros_like(cos), cos)
    theta = torch.arccos(cos_safe)
    sin_safe = torch.where(small, torch.ones_like(cos), torch.sqrt(
        torch.clamp_min(1.0 - cos_safe ** 2, 1e-12)))
    fac = torch.where(small,
                      0.5 + s2 / 12.0 + s2 * s2 * (3.0 / 40.0) / 4.0,
                      theta / (2.0 * sin_safe))
    return fac[..., None] * vee


def se3_exp(xi):
    """Twist (..., 6) [rho, w] -> (R (..., 3, 3), t (..., 3))."""
    rho, w = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    t2 = torch.sum(w * w, dim=-1)[..., None, None]
    K = hat(w)
    K2 = K @ K
    _, b, c = _abc(t2)
    V = _eye3(xi, K.shape) + b * K + c * K2
    t = (V @ rho[..., None])[..., 0]
    return R, t


def se3_log(R, t):
    """(R, t) -> twist (..., 6) [rho, w]."""
    w = so3_log(R)
    t2 = torch.sum(w * w, dim=-1)[..., None, None]
    K = hat(w)
    K2 = K @ K
    small = t2 < _SMALL2
    ts2 = torch.where(small, torch.ones_like(t2), t2)
    ts = torch.sqrt(ts2)
    a = torch.sin(ts) / ts
    b = (1.0 - torch.cos(ts)) / ts2
    # V^{-1} = I - K/2 + coef K^2, coef = (1 - a/(2b)) / theta^2
    coef = torch.where(small, 1.0 / 12.0 + t2 / 720.0,
                       (1.0 - a / (2.0 * b)) / ts2)
    Vinv = _eye3(t, K.shape) - 0.5 * K + coef * K2
    rho = (Vinv @ t[..., None])[..., 0]
    return torch.cat([rho, w], dim=-1)
