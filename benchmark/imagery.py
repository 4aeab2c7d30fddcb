"""Seeded imagery of the benchmark, rendered on the device.

A copy of ``tests/golden/gen_images.synth_image`` (gradient, Gaussian
blobs of mixed scale, polarity and anisotropy, rectangles, texture
noise; three channels averaged to gray) split in two: ``draw`` makes
the seeded draws in NumPy, in gen_images' order, and ``render`` paints
them on the device in float64.  The blobs are one quadratic form each
in (x, y), so their exponents are one matrix product over the
monomials [x^2, xy, y^2, x, y, 1], and the rectangles are a product of
row and column masks.  NumPy paints a 800x640 image in ~8 s on one
core; the card paints one in milliseconds.

The texture noise is the one change for speed: ``pool`` draws it on
the device with a ``torch.Generator`` (14 ms an image in NumPy), while
``synth_gray`` continues gen_images' NumPy stream, so that at small
sizes it equals gen_images (tests/test_imagery.py).

Also here: the rotated query (tools/torch_retrieval_bench.warp_query's
bilinear warp) and the seeded SIFT-like filler rows of a retrieval
index.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# pixels a chunk of the blob product covers (its exponents are
# n_blobs x chunk float64)
_CHUNK_PX = 1 << 17


def image_seeds(seed: int, n: int) -> list[int]:
    """n per-image seeds (32-bit) derived from a run's seed."""
    return [int(s) for s in np.random.SeedSequence(seed).generate_state(n)]


def draw(width: int, height: int, rng: np.random.RandomState) -> dict:
    """gen_images.synth_image's draws before its noise, in its order."""
    n_blobs = max(40, (width * height) // 900)
    blobs = np.empty((n_blobs, 6))          # cx, cy, s, amp, th, ax
    for k in range(n_blobs):
        cx = rng.uniform(0.03, 0.97) * width
        cy = rng.uniform(0.03, 0.97) * height
        if rng.rand() < 0.85:
            s = rng.uniform(1.2, 6.0)
        else:
            s = rng.uniform(6.0, min(width, height) / 8.0)
        amp = rng.uniform(-130, 130)
        th = rng.uniform(0, np.pi)
        ax = rng.uniform(0.4, 2.5)
        blobs[k] = cx, cy, s, amp, th, ax
    n_rect = max(10, n_blobs // 3)
    rects = np.empty((n_rect, 5))            # x0, y0, w, h, value
    for k in range(n_rect):
        x0 = int(rng.uniform(0, width * 0.85))
        y0 = int(rng.uniform(0, height * 0.85))
        w = int(rng.uniform(3, width * 0.12))
        h = int(rng.uniform(3, height * 0.12))
        rects[k] = x0, y0, w, h, rng.uniform(-70, 70)
    return {"blobs": blobs, "rects": rects}


def _blob_coefficients(blobs: np.ndarray) -> np.ndarray:
    """(n, 6) coefficients of each blob's exponent on [x^2, xy, y^2, x,
    y, 1]: -(dx^2 ax + dy^2 / ax) / (2 s^2) with (dx, dy) the pixel's
    offset from (cx, cy) rotated by th."""
    cx, cy, s, _, th, ax = blobs.T
    c, sn = np.cos(th), np.sin(th)
    A = c * c * ax + sn * sn / ax
    B = 2 * c * sn * (ax - 1 / ax)
    C = sn * sn * ax + c * c / ax
    k = -1.0 / (2 * s * s)
    return np.stack([k * A, k * B, k * C, k * (-2 * A * cx - B * cy),
                     k * (-B * cx - 2 * C * cy),
                     k * (A * cx * cx + B * cx * cy + C * cy * cy)], 1)


class Canvas:
    """The monomial planes of one image size on one device."""

    def __init__(self, width: int, height: int, device):
        self.width, self.height = width, height
        self.device = torch.device(device)
        f64 = dict(dtype=torch.float64, device=self.device)
        y, x = torch.meshgrid(torch.arange(height, **f64),
                              torch.arange(width, **f64), indexing="ij")
        self.x, self.y = x, y
        self.planes = torch.stack([x * x, x * y, y * y, x, y,
                                   torch.ones_like(x)]).reshape(6, -1)

    def render(self, params: dict, noise: torch.Tensor) -> torch.Tensor:
        """(H, W) float32 gray of one image's draws plus (H, W) float64
        unit-variance noise, as gen_images makes and the callers of
        synth_image average it."""
        W, H, dev = self.width, self.height, self.device
        f64 = dict(dtype=torch.float64, device=dev)
        img = 40.0 + 60.0 * (self.x / W) + 30.0 * (self.y / H)
        coef = torch.as_tensor(_blob_coefficients(params["blobs"]), **f64)
        amp = torch.as_tensor(params["blobs"][:, 3], **f64)
        flat = img.reshape(-1)
        for p0 in range(0, H * W, _CHUNK_PX):
            q = coef @ self.planes[:, p0:p0 + _CHUNK_PX]
            flat[p0:p0 + _CHUNK_PX] += amp @ q.exp_()
        r = torch.as_tensor(params["rects"], **f64)
        x0, y0, w, h, val = r.T
        cols = torch.arange(W, **f64)
        rows = torch.arange(H, **f64)
        rmask = ((rows >= y0[:, None]) & (rows < (y0 + h)[:, None])
                 ).to(torch.float64) * val[:, None]
        cmask = ((cols >= x0[:, None]) & (cols < (x0 + w)[:, None])
                 ).to(torch.float64)
        img = img + rmask.T @ cmask
        img = torch.clamp(img + noise * 5.0, 0, 255)
        g = img.to(torch.uint8)
        r8 = torch.clamp(img + 6.0 * torch.sin(self.x / 17.0), 0, 255
                         ).to(torch.uint8)
        b8 = torch.clamp(img - 5.0 * torch.cos(self.y / 23.0), 0, 255
                         ).to(torch.uint8)
        return (r8.to(torch.float32) + g.to(torch.float32)
                + b8.to(torch.float32)) / 3.0


def synth_gray(width: int, height: int, seed: int,
               device="cpu") -> torch.Tensor:
    """gen_images.synth_image(width, height, seed), channel-mean gray,
    noise included from gen_images' own NumPy stream."""
    rng = np.random.RandomState(seed)
    params = draw(width, height, rng)
    noise = torch.as_tensor(rng.randn(height, width), device=device)
    return Canvas(width, height, device).render(params, noise)


def pool(width: int, height: int, seeds, device) -> torch.Tensor:
    """(len(seeds), H, W) float32 gray images on `device`: each seed's
    draws in NumPy, its noise from a device generator seeded with it."""
    canvas = Canvas(width, height, device)
    gen = torch.Generator(device=canvas.device)
    out = torch.empty((len(seeds), height, width), dtype=torch.float32,
                      device=canvas.device)
    for i, s in enumerate(seeds):
        params = draw(width, height, np.random.RandomState(s))
        gen.manual_seed(s)
        noise = torch.randn((height, width), generator=gen,
                            dtype=torch.float64, device=canvas.device)
        out[i] = canvas.render(params, noise)
    return out


def warp_query(img: torch.Tensor, angle: float) -> torch.Tensor:
    """img (H, W) rotated by `angle` about its centre, bilinear
    (tools/torch_retrieval_bench.warp_query on the device)."""
    H, W = img.shape
    f64 = dict(dtype=torch.float64, device=img.device)
    yy, xx = torch.meshgrid(torch.arange(H, **f64), torch.arange(W, **f64),
                            indexing="ij")
    c, s = math.cos(angle), math.sin(angle)
    cx, cy = W / 2, H / 2
    sx = c * (xx - cx) - s * (yy - cy) + cx
    sy = s * (xx - cx) + c * (yy - cy) + cy
    x0 = torch.clamp(sx.to(torch.int32), 0, W - 2).long()
    y0 = torch.clamp(sy.to(torch.int32), 0, H - 2).long()
    fx = torch.clamp(sx - x0, 0, 1)
    fy = torch.clamp(sy - y0, 0, 1)
    im = img.to(torch.float64)
    at = lambda yi, xi: im[yi, xi]
    return ((1 - fy) * ((1 - fx) * at(y0, x0) + fx * at(y0, x0 + 1))
            + fy * ((1 - fx) * at(y0 + 1, x0) + fx * at(y0 + 1, x0 + 1))
            ).to(torch.float32)


def filler_rows(n: int, seed: int, device, dim: int = 128,
                zero_share: float = 0.4, max_bin: float = 0.2,
                chunk: int = 1 << 21) -> torch.Tensor:
    """(n, dim) uint8 SIFT-like rows made on `device` from `seed`.

    Each row: a share `zero_share` of its bins zero, the others drawn
    heavy-tailed (the square of an exponential), then as the SIFT
    quantiser treats a histogram: L2-normalised, clipped at max_bin,
    renormalised, floor(512 v) capped at 255.
    """
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(seed)
    out = torch.empty((n, dim), dtype=torch.uint8, device=device)
    for r0 in range(0, n, chunk):
        m = min(chunk, n - r0)
        u = torch.rand((m, dim), generator=gen, device=device)
        keep = torch.rand((m, dim), generator=gen, device=device)
        v = torch.where(keep >= zero_share, torch.log(u).square(), 0.0)
        v[:, 0] += 1e-3                 # no all-zero row
        v = v / v.norm(dim=1, keepdim=True)
        v = torch.clamp_max(v, max_bin)
        v = v / v.norm(dim=1, keepdim=True)
        out[r0:r0 + m] = torch.clamp_max(torch.floor(512.0 * v), 255.0
                                         ).to(torch.uint8)
    return out
