"""Rotary position embeddings (port of unimedvl_tpu/ops/rope.py): 1D for the
LLM, and the 2D tables of the ViT's rope (``rope_2d_tables``).

fp32 angles, split-halves ``rotate_half`` (not interleaved), and the multiply
in the dtype of q/k with cos/sin cast to it first.
"""

from __future__ import annotations

from typing import Tuple

import torch


def rope_inv_freq(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """[head_dim // 2] fp32 inverse frequencies."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponent)


def rope_cos_sin(
    position_ids: torch.Tensor, head_dim: int, theta: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 cos/sin tables [..., head_dim] for integer position ids [...],
    with the (freqs, freqs) duplication convention."""
    inv_freq = rope_inv_freq(head_dim, theta, position_ids.device)
    freqs = position_ids.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(
    q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate q [..., T, H, D] and k [..., T, Hk, D] by cos/sin [..., T, D]
    (broadcast over heads), in the dtype of q and k."""
    cos_q = cos.to(q.dtype)[..., :, None, :]
    sin_q = sin.to(q.dtype)[..., :, None, :]
    q_out = q * cos_q + _rotate_half(q) * sin_q
    k_out = k * cos_q.to(k.dtype) + _rotate_half(k) * sin_q.to(k.dtype)
    return q_out, k_out


def apply_rope_one(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """:func:`apply_rope` for one tensor [..., T, H, D] (the k side, when the q
    side is rotated inside the attention kernel). cos/sin [..., T, D], or
    [..., 1, D] when every row shares one position."""
    cos = cos.to(x.dtype)[..., :, None, :]
    sin = sin.to(x.dtype)[..., :, None, :]
    return x * cos + _rotate_half(x) * sin


def rope_2d_tables(dim: int, max_h: int, max_w: int, theta: float = 10000.0, device=None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """2D ViT rope tables (siglip_navit.py:102-127). ``dim`` is head_dim // 2
    (each spatial axis rotates half of a head). Returns (cos_h, sin_h, cos_w,
    sin_w), each [max_h * max_w, dim] fp32, indexed by the flattened position
    id row * max_w + col."""
    inv_freq = rope_inv_freq(dim, theta, device)
    rows = torch.arange(max_h, dtype=torch.float32, device=device)[:, None].expand(max_h, max_w)
    cols = torch.arange(max_w, dtype=torch.float32, device=device)[None, :].expand(max_h, max_w)

    def one_side(grid):
        freqs = grid[..., None] * inv_freq  # [H, W, dim // 2]
        emb = torch.cat([freqs, freqs], dim=-1).reshape(-1, dim)
        return torch.cos(emb), torch.sin(emb)

    return (*one_side(rows), *one_side(cols))
