"""Normalisation ops with explicit fp32 islands (port of unimedvl_tpu/ops/norms.py).

Numerics as in the JAX package: statistics in fp32, the normalised value cast
back to the input dtype, then the weight multiply in that dtype.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis (Qwen2RMSNorm numerics)."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return weight * y.to(x.dtype)


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """LayerNorm over the last axis, statistics in fp32."""
    x32 = x.float()
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mean), dim=-1, keepdim=True)
    y = ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    return y * weight + bias
