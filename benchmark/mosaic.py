"""Seeded mosaic frames: large images tiled from the benchmark's
synthetic tiles.

A frame of H x W holds ceil(H / h) rows of ceil(W / w) tiles of h x w,
cut to H x W.  The tiles are imagery.pool's synthetic gray images,
rendered on the device from the run's seed; each frame takes its own
seeded pick of them (without repeats where the tile pool holds enough),
so no two frames of a pool are alike.  Painting every pixel of a 24 MP
frame with imagery.draw's blobs would take ~27 k blobs a frame; the
tiles keep the 800x640 imagery's density of structure at any size.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import imagery


def tile_grid(width: int, height: int, tile_w: int, tile_h: int):
    """(rows, columns) of tiles that cover a width x height frame."""
    return -(-height // tile_h), -(-width // tile_w)


def picks(seed: int, n_frames: int, n_tiles: int, per_frame: int):
    """(n_frames, per_frame) tile indices, each frame's row a seeded
    pick of the n_tiles tiles (a permutation's head where n_tiles >=
    per_frame, else draws with repeats)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 1]))
    if n_tiles >= per_frame:
        return np.stack([rng.permutation(n_tiles)[:per_frame]
                         for _ in range(n_frames)])
    return rng.integers(0, n_tiles, (n_frames, per_frame))


def frames(width: int, height: int, tile_w: int, tile_h: int,
           n_frames: int, n_tiles: int, seed: int, device) -> np.ndarray:
    """(n_frames, height, width) float32 gray frames on the host."""
    rows, cols = tile_grid(width, height, tile_w, tile_h)
    tiles = imagery.pool(tile_w, tile_h, imagery.image_seeds(seed, n_tiles),
                         device)
    out = np.empty((n_frames, height, width), np.float32)
    for f, pick in enumerate(picks(seed, n_frames, n_tiles, rows * cols)):
        grid = tiles[torch.as_tensor(pick, device=tiles.device)]
        grid = grid.reshape(rows, cols, tile_h, tile_w).permute(0, 2, 1, 3)
        frame = grid.reshape(rows * tile_h, cols * tile_w)
        out[f] = frame[:height, :width].cpu().numpy()
    return out
