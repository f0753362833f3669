"""Activation functions matching the reference's torch/HF flavours (port of
unimedvl_tpu/ops/activations.py)."""

import torch
import torch.nn.functional as F


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """HF ``gelu_pytorch_tanh`` == tanh-approximated GELU."""
    return F.gelu(x, approximate="tanh")


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


ACT2FN = {
    "gelu_pytorch_tanh": gelu_tanh,
    "silu": silu,
    "gelu": F.gelu,
    "relu": F.relu,
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
}
