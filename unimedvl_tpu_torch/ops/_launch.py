"""Argument checks shared by the kernel wrappers: the kernels read raw pointers,
so everything they assume about a tensor is checked here and raises."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def per_stream(x, S: int, device: torch.device) -> torch.Tensor:
    """A Python int, or a scalar or [S] integer tensor, as a contiguous int32
    [S] tensor on ``device``. An int is filled on the device: a host-to-device
    copy would synchronise the stream."""
    if isinstance(x, int):
        return torch.full((S,), x, dtype=torch.int32, device=device)
    t = torch.as_tensor(x, device=device).to(torch.int32).reshape(-1)
    if t.numel() == 1:
        return t.expand(S).contiguous()
    if t.shape != (S,):
        raise ValueError(f"expected a scalar or [{S}] per-stream value, got {tuple(t.shape)}")
    return t.contiguous()


def check_bf16_cuda(names: Sequence[str], tensors: Sequence[torch.Tensor]) -> None:
    device = tensors[0].device
    for name, t in zip(names, tensors):
        if t.device != device or t.device.type != "cuda":
            raise ValueError(f"{name} must be on {device} (CUDA), got {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16 for the kernel, got {t.dtype}")
        if t.stride(-1) != 1 or t.data_ptr() % 16:
            raise ValueError(f"{name} needs a contiguous, 16-byte aligned last dim")


def kv_strides(name: str, t: torch.Tensor) -> Tuple[int, int, int]:
    """(stream, head, key) strides of a [S, Hk, M, D] view, in elements; the
    kernels read rows of D with 16-byte loads, so each stride is a multiple of 8."""
    strides = (t.stride(0), t.stride(1), t.stride(2))
    if any(s % 8 for s in strides):
        raise ValueError(f"{name} strides {t.stride()} are not multiples of 8 elements")
    return strides


def check_index(names: Sequence[str], tensors: Sequence[torch.Tensor], S: int,
                device: torch.device) -> None:
    for name, t in zip(names, tensors):
        if t.device != device or t.dtype != torch.int32 or t.shape != (S,) or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous int32 [{S}] tensor on {device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
