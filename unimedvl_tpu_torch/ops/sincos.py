"""Frozen 2D sin-cos position table (port of unimedvl_tpu/ops/sincos.py, whose
module imports jax). Numerics mirror reference modeling_utils.py:23-65,
including the w-before-h meshgrid quirk.
"""

from __future__ import annotations

import numpy as np


def _sincos_1d(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    """(M, embed_dim) = [sin(pos * w), cos(pos * w)]."""
    if embed_dim % 2:
        raise ValueError(f"embed_dim must be even, got {embed_dim}")
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000**omega
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int) -> np.ndarray:
    """(grid_size**2, embed_dim) fp32 table, row-major (index = row * grid_size
    + col). np.meshgrid(grid_w, grid_h) puts the column coordinate in grid[0],
    so the first embed_dim // 2 dims encode the column (reference quirk)."""
    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.meshgrid(grid_w, grid_h)
    grid = np.stack(grid, axis=0).reshape([2, 1, grid_size, grid_size])
    emb_a = _sincos_1d(embed_dim // 2, grid[0])
    emb_b = _sincos_1d(embed_dim // 2, grid[1])
    return np.concatenate([emb_a, emb_b], axis=1).astype(np.float32)
