"""A seeded piecewise-planar scene, rendered on the device: the frames
of a camera orbiting a building, for two-view matching.

The scene: a box-shaped building (four facades and a roof) standing on
a square patch of textured ground.  Every plane is tiled with the
benchmark's synthetic tiles (imagery.pool), one texel a world unit, a
seeded pick of the tile pool for each tile of each plane; past the
ground's edge lies a flat haze.  Lengths are in units of the focal
length f, in texels, so that at mean depth a texel covers about one
pixel at any frame size.

The camera: a pinhole of focal f and principal point at the frame's
centre, on a closed circular orbit of ``n_frames`` stations ``step``
degrees apart around the building, above its roof, looking at a point
on the building's axis.  From every station it sees the roof, at least
one facade and the ground: three planes, not all parallel, so the
two-view geometry of any pair is a general fundamental matrix.

A pixel takes the nearest plane its ray meets (ray-plane intersection
against each rectangle), sampled bilinearly within its tile, averaged
over ``supersample`` x ``supersample`` rays a pixel, in float32 (a
texel's position to ~1e-3 at the ground's edge).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import imagery

# the scene in units of f (texels): building half-width and height,
# the ground's half-size, the orbit's radius and height, and the height
# of the point the camera looks at (chosen so that the mean depth of
# the pixels is f: 0.99-1.00 f over the orbit, the median 0.76-0.80 f;
# the ground fills ~62% of a frame, the roof ~19%, facades 12-16%, the
# haze 3-5%)
BUILDING_HALF = 0.342
BUILDING_HEIGHT = 0.342
GROUND_HALF = 2.105
ORBIT_RADIUS = 0.763
ORBIT_HEIGHT = 0.711
TARGET_HEIGHT = 0.0
HAZE = 118.0
# rows of a frame rendered at once (bounds the temporaries)
_ROWS = 256


def planes(f: float) -> list:
    """(origin, u axis, v axis, u extent, v extent) of each textured
    rectangle, world coordinates (z up) in texels: the ground, the four
    facades (v running down from the eaves), the roof."""
    b, h, g = BUILDING_HALF * f, BUILDING_HEIGHT * f, GROUND_HALF * f
    X, Y, Z = np.eye(3)
    out = [(np.array([-g, -g, 0.0]), X, Y, 2 * g, 2 * g)]
    for c, s in ((1, 0), (0, 1), (-1, 0), (0, -1)):
        normal = np.array([c, s, 0.0])
        along = np.array([-s, c, 0.0])
        origin = b * normal - b * along + h * Z
        out.append((origin, along, -Z, 2 * b, h))
    out.append((np.array([-b, -b, h]), X, Y, 2 * b, 2 * b))
    return out


def camera(k: int, n_frames: int, step: float, f: float, width: int,
           height: int):
    """(K, R, C) of station k: intrinsics (pixel centres at whole
    coordinates, as the detector reports them), world-to-camera
    rotation (x right, y down, z forward) and centre, float64."""
    a = math.radians(step * (k % n_frames))
    C = np.array([ORBIT_RADIUS * f * math.cos(a),
                  ORBIT_RADIUS * f * math.sin(a), ORBIT_HEIGHT * f])
    fwd = np.array([0.0, 0.0, TARGET_HEIGHT * f]) - C
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])
    K = np.array([[f, 0.0, width / 2.0 - 0.5],
                  [0.0, f, height / 2.0 - 0.5], [0.0, 0.0, 1.0]])
    return K, R, C


def fundamental(K, R1, C1, R2, C2) -> np.ndarray:
    """The true F of two stations: x2^T F x1 = 0 for a point seen at x1
    in the first and x2 in the second (pixels, homogeneous)."""
    R = R2 @ R1.T
    t = R2 @ (C1 - C2)
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    Ki = np.linalg.inv(K)
    return Ki.T @ tx @ R @ Ki


def tile_picks(seed: int, n_tiles: int, tile_w: int, tile_h: int,
               f: float) -> list:
    """Per plane, the (rows, cols) tile indices that texture it, a
    seeded draw from the pool."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 2]))
    return [rng.integers(0, n_tiles, (math.ceil(V / tile_h),
                                      math.ceil(U / tile_w)))
            for _, _, _, U, V in planes(f)]


class Renderer:
    """The scene of one seed on one device: its tiles and picks."""

    def __init__(self, width: int, height: int, tile_w: int, tile_h: int,
                 n_tiles: int, seed: int, device, focal: float,
                 supersample: int = 2):
        self.W, self.H, self.f = width, height, float(focal)
        self.tw, self.th = tile_w, tile_h
        self.ss = supersample
        self.device = torch.device(device)
        self.tiles = imagery.pool(tile_w, tile_h,
                                  imagery.image_seeds(seed, n_tiles),
                                  self.device).reshape(-1)
        f32 = dict(dtype=torch.float32, device=self.device)
        self.planes = [tuple(torch.as_tensor(np.asarray(p, np.float32), **f32)
                             for p in pl[:3]) + pl[3:]
                       for pl in planes(self.f)]
        self.picks = [torch.as_tensor(p, device=self.device)
                      for p in tile_picks(seed, n_tiles, tile_w, tile_h,
                                          self.f)]

    def _sample(self, k: int, u, v) -> torch.Tensor:
        """Bilinear samples of plane k's texture at texel coordinates
        (u, v) within it, each within its own tile."""
        tw, th = self.tw, self.th
        col = torch.clamp((u // tw).long(), 0, self.picks[k].shape[1] - 1)
        row = torch.clamp((v // th).long(), 0, self.picks[k].shape[0] - 1)
        base = self.picks[k][row, col] * (tw * th)
        x = torch.clamp(u - col * tw - 0.5, 0, tw - 1.0)
        y = torch.clamp(v - row * th - 0.5, 0, th - 1.0)
        x0 = torch.clamp(x.floor().long(), 0, tw - 2)
        y0 = torch.clamp(y.floor().long(), 0, th - 2)
        fx, fy = x - x0, y - y0
        at = lambda dy, dx: self.tiles[base + (y0 + dy) * tw + x0 + dx]
        return ((1 - fy) * ((1 - fx) * at(0, 0) + fx * at(0, 1))
                + fy * ((1 - fx) * at(1, 0) + fx * at(1, 1)))

    def frame(self, k: int, n_frames: int, step: float) -> torch.Tensor:
        """(H, W) float32 frame of station k, on the device."""
        _, R, C = camera(k, n_frames, step, self.f, self.W, self.H)
        f32 = dict(dtype=torch.float32, device=self.device)
        Rt = torch.as_tensor(R.T.copy(), **f32)
        C = torch.as_tensor(C, **f32)
        ss = self.ss
        sub = (torch.arange(ss, **f32) + 0.5) / ss
        xs = ((torch.arange(self.W, **f32)[:, None] + sub).reshape(-1)
              - self.W / 2.0) / self.f
        out = torch.empty((self.H, self.W), dtype=torch.float32,
                          device=self.device)
        for r0 in range(0, self.H, _ROWS):
            r1 = min(self.H, r0 + _ROWS)
            ys = ((torch.arange(r0, r1, **f32)[:, None] + sub).reshape(-1)
                  - self.H / 2.0) / self.f
            # world directions of the rays (rows, cols, 3): R^T (x, y, 1)
            d = (xs[None, :, None] * Rt[:, 0] + ys[:, None, None] * Rt[:, 1]
                 + Rt[:, 2])
            best = torch.full(d.shape[:2], math.inf, **f32)
            val = torch.full(d.shape[:2], HAZE, dtype=torch.float32,
                             device=self.device)
            for k_pl, (o, eu, ev, U, V) in enumerate(self.planes):
                n = torch.linalg.cross(eu, ev)
                t = ((o - C) * n).sum() / (d * n).sum(-1)
                p = C + t[..., None] * d - o
                u, v = (p * eu).sum(-1), (p * ev).sum(-1)
                hit = ((t > 0) & (t < best) & (u >= 0) & (u < U)
                       & (v >= 0) & (v < V))
                best = torch.where(hit, t, best)
                val = torch.where(hit, self._sample(k_pl, u, v), val)
            val = val.reshape(r1 - r0, ss, self.W, ss).mean((1, 3))
            out[r0:r1] = val
        return out


def orbit_frames(width: int, height: int, tile_w: int, tile_h: int,
                 n_frames: int, n_tiles: int, seed: int, device,
                 focal: float, step: float,
                 supersample: int = 2) -> np.ndarray:
    """(n_frames, height, width) float32 frames on the host, station k
    in row k."""
    r = Renderer(width, height, tile_w, tile_h, n_tiles, seed, device,
                 focal, supersample)
    out = np.empty((n_frames, height, width), np.float32)
    for k in range(n_frames):
        out[k] = r.frame(k, n_frames, step).cpu().numpy()
    return out
