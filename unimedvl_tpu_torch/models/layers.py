"""Parameter-holding building blocks shared by the SigLIP and MoT modules.

Parameters are created with ``torch.empty`` on the given device and dtype:
weights come from a checkpoint, from the JAX tree (weights/loader.py) or from
``models.bagel.init_random_``.
"""

from __future__ import annotations

import torch
from torch import nn

from unimedvl_tpu_torch.ops.norms import layer_norm, rms_norm


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, device=device, dtype=dtype))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(dim, device=device, dtype=dtype))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class PosEmbed(nn.Module):
    """A frozen [N, C] position table under the released name ``pos_embed``."""

    def __init__(self, n: int, dim: int, device=None, dtype=None):
        super().__init__()
        self.pos_embed = nn.Parameter(
            torch.empty(n, dim, device=device, dtype=dtype), requires_grad=False
        )


def linear(cin: int, cout: int, bias: bool, device=None, dtype=None) -> nn.Linear:
    """An nn.Linear whose weights are left for the loader or init to fill."""
    lin = nn.Linear(cin, cout, bias=bias, device="meta", dtype=dtype)
    return lin.to_empty(device=device if device is not None else "cpu")


def embedding(n: int, dim: int, device=None, dtype=None) -> nn.Embedding:
    emb = nn.Embedding(n, dim, device="meta", dtype=dtype)
    return emb.to_empty(device=device if device is not None else "cpu")
