"""Closed-form small linear algebra on tensors (plain PyTorch).

Same arithmetic, operation by operation, as ``hesaff_tpu.ops.linalg``:
the pivot order and strict comparisons of the reference's 3x3 solver
(so singular systems give the same NaN/Inf pattern, which localisation
uses as its rejection signal), the Jacobi closed form of the
det-normalised inverse square root, and the 2x2 eigenvalue formula.
The CUDA kernels repeat these expressions in the same order.
"""

from __future__ import annotations

import torch


def fdiv(x: torch.Tensor, v: float) -> torch.Tensor:
    """x / v rounded as one float32 division.

    PyTorch's CUDA kernels turn division by a Python scalar into a
    multiplication by its reciprocal (two roundings), and `v / x` is
    reciprocal(x) * v on every device; this helper divides by a 0-d
    tensor instead, as the JAX package and the kernels do.
    """
    return x / torch.full((), v, dtype=x.dtype, device=x.device)


def rdiv(v: float, x: torch.Tensor) -> torch.Tensor:
    """v / x rounded as one float32 division (see fdiv)."""
    return torch.full((), v, dtype=x.dtype, device=x.device) / x


def _pick(cond, xs, ys):
    return [torch.where(cond, x, y) for x, y in zip(xs, ys)]


def solve3x3_parts(a, bb):
    """Solve A x = b on unstacked entries.

    a: 3x3 nested list of tensors; bb: list of 3 tensors.
    Returns (x0, x1, x2).
    """
    p1 = a[1][0].abs() > a[0][0].abs()
    vp = torch.where(p1, a[1][0].abs(), a[0][0].abs())
    p2 = a[2][0].abs() > vp

    row0 = _pick(p2, a[2], _pick(p1, a[1], a[0]))
    row1 = _pick(p2, a[1], _pick(p1, a[0], a[1]))
    row2 = _pick(p2, a[0], a[2])
    b0 = torch.where(p2, bb[2], torch.where(p1, bb[1], bb[0]))
    b1 = torch.where(p2, bb[1], torch.where(p1, bb[0], bb[1]))
    b2 = torch.where(p2, bb[0], bb[2])

    f1 = row1[0] / row0[0]
    row1 = [row1[1] - f1 * row0[1], row1[2] - f1 * row0[2]]
    b1 = b1 - f1 * b0
    f2 = row2[0] / row0[0]
    row2 = [row2[1] - f2 * row0[1], row2[2] - f2 * row0[2]]
    b2 = b2 - f2 * b0

    sw = row1[0].abs() < row2[0].abs()
    r1 = _pick(sw, row2, row1)
    r2 = _pick(sw, row1, row2)
    b1n = torch.where(sw, b2, b1)
    b2n = torch.where(sw, b1, b2)

    f3 = r2[0] / r1[0]
    r22 = r2[1] - f3 * r1[1]
    b2n = b2n - f3 * b1n

    x2 = b2n / r22
    x1 = (b1n - r1[1] * x2) / r1[0]
    x0 = (b0 - row0[2] * x2 - row0[1] * x1) / row0[0]
    return x0, x1, x2


def inv_sqrt_2x2(a, b, c):
    """Det-normalised inverse square root of symmetric [[a,b],[b,c]].

    Returns (ia, ib, ic, l1, l2); l1 >= l2 are its eigenvalues before
    output ordering.  NaN propagates through max/min as in jnp.
    """
    nz = b != 0
    r_angle = torch.where(nz, (c - a) / (2.0 * torch.where(nz, b, 1.0)),
                          0.0)
    root = torch.sqrt(1.0 + r_angle * r_angle)
    t = torch.where(r_angle >= 0, 1.0 / (r_angle + root),
                    -1.0 / (-r_angle + root))
    cs = 1.0 / torch.sqrt(1.0 + t * t)
    sn = t * cs
    cs = torch.where(nz, cs, 1.0)
    sn = torch.where(nz, sn, 0.0)

    x = 1.0 / torch.sqrt(cs * cs * a - 2.0 * cs * sn * b + sn * sn * c)
    z = 1.0 / torch.sqrt(sn * sn * a + 2.0 * cs * sn * b + cs * cs * c)
    d = torch.sqrt(x * z)
    x = x / d
    z = z / d
    l1 = torch.maximum(x, z)
    l2 = torch.minimum(x, z)
    ia = cs * cs * x + sn * sn * z
    ib = -cs * sn * x + sn * cs * z
    ic = sn * sn * x + cs * cs * z
    return ia, ib, ic, l1, l2


def eigenvalues_2x2(a, b, c, d):
    """Eigenvalues of [[a,b],[c,d]] as (l1, l2, is_real), l1 >= l2."""
    trace = a + d
    delta1 = trace * trace - 4.0 * (a * d - b * c)
    is_real = delta1 >= 0
    delta = torch.sqrt(torch.clamp_min(delta1, 0.0))
    l1 = (trace + delta) / 2.0
    l2 = (trace - delta) / 2.0
    return l1, l2, is_real


def rectify_up_is_up(a11, a12, a21, a22):
    """Rotation-free lower-triangular frame of the affine shape."""
    det = torch.sqrt(torch.abs(a11 * a22 - a12 * a21))
    b2a2 = torch.sqrt(a12 * a12 + a11 * a11)
    r11 = b2a2 / det
    r12 = torch.zeros_like(det)
    r21 = (a22 * a12 + a21 * a11) / (b2a2 * det)
    r22 = det / b2a2
    return r11, r12, r21, r22
