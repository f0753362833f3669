"""1D rotary position embeddings for the LLM (port of unimedvl_tpu/ops/rope.py).

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
