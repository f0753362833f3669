"""Argument checks shared by the kernel wrappers: the kernels read raw pointers,
so everything they assume about a tensor is checked here and raises with the
tensor's name."""

from __future__ import annotations

import contextlib
from typing import Sequence, Tuple

import torch

LOAD_BYTES = 16  # the kernels read rows with 16-byte loads


def per_stream(x, S: int, device: torch.device) -> torch.Tensor:
    """A Python int, or a scalar or [S] integer tensor, as a contiguous int32
    [S] tensor on ``device``. An int is filled on the device: a host-to-device
    copy would synchronise the stream. A tensor that already is one comes back
    as it is, after the fewest checks (the decode loop passes them so)."""
    if type(x) is torch.Tensor and x.dtype == torch.int32 and x.shape == (S,) \
            and x.device == device and x.is_contiguous():
        return x
    if isinstance(x, int):
        return torch.full((S,), x, dtype=torch.int32, device=device)
    t = torch.as_tensor(x, device=device).to(torch.int32).reshape(-1)
    if t.numel() == 1:
        return t.expand(S).contiguous()
    if t.shape != (S,):
        raise ValueError(f"expected a scalar or [{S}] per-stream value, got {tuple(t.shape)}")
    return t.contiguous()


def on_device(index: int):
    """A guard that makes CUDA device ``index`` current for a launch, or,
    when it already is (the common case), one that does nothing: the device
    switch costs several microseconds of host time per launch."""
    if torch.cuda.current_device() == index:
        return contextlib.nullcontext()
    return torch.cuda.device(index)


ATTENTION_ROUTES = ("training attention: ops.flash_attention_train.packed_train_attention; "
                    "the ViT: dense_attention=True")


def check_no_grad(kernel: str, names: Sequence[str], tensors: Sequence[torch.Tensor],
                  routes: str = ATTENTION_ROUTES) -> None:
    """A kernel without a backward must not sit in an autograd graph: its
    output has no ``grad_fn``, so the inputs' gradients would silently come out
    as zero. Raises when grad mode is on and an input requires grad (a None
    input is skipped); ``routes`` names the differentiable routes."""
    if not torch.is_grad_enabled():
        return
    wanting = [n for n, t in zip(names, tensors) if t is not None and t.requires_grad]
    if wanting:
        raise RuntimeError(
            f"{kernel} has no backward kernel, but {', '.join(wanting)} require grad: call it "
            f"under torch.no_grad(), or take a differentiable route ({routes})"
        )


def check_cuda(names: Sequence[str], tensors: Sequence[torch.Tensor], dtype) -> None:
    """Every tensor on the first one's CUDA device, of ``dtype`` (one for all,
    or a sequence with one per tensor), with a contiguous last dim that starts
    on a 16-byte boundary."""
    device = tensors[0].device
    dtypes = dtype if isinstance(dtype, (tuple, list)) else (dtype,) * len(tensors)
    for name, t, want in zip(names, tensors, dtypes):
        if t.device != device or device.type != "cuda":
            raise ValueError(f"{name} must be on {device} (CUDA), got {t.device}")
        if t.dtype != want:
            raise TypeError(f"{name} must be {want} for the kernel, got {t.dtype}")
        if t.stride(-1) != 1 or t.data_ptr() % LOAD_BYTES:
            raise ValueError(f"{name} needs a contiguous, 16-byte aligned last dim")


def check_contiguous_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, shape,
                          device: torch.device) -> None:
    """A dense tensor the kernel indexes by shape alone (scales, int8
    activations, packed weights): device, dtype, shape, contiguity and a
    16-byte aligned start. Whether its rows are whole 16-byte loads follows
    from the shape, which the caller checks."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name} must be {dtype} {tuple(shape)} on {device}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous() or t.data_ptr() % LOAD_BYTES:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def kv_strides(name: str, t: torch.Tensor) -> Tuple[int, int, int]:
    """(stream, head, key) strides of a [S, Hk, M, D] view, in elements; the
    kernels read rows of D with 16-byte loads, so each stride is a multiple of
    16 bytes: 8 elements of bf16, 16 of int8."""
    per_load = LOAD_BYTES // t.element_size()
    strides = t.stride()[:3]
    if any(s % per_load for s in strides):
        raise ValueError(
            f"{name} strides {t.stride()} are not multiples of {per_load} elements "
            f"({LOAD_BYTES} bytes of {t.dtype})"
        )
    return strides


def check_index(names: Sequence[str], tensors: Sequence[torch.Tensor], S: int,
                device: torch.device) -> None:
    for name, t in zip(names, tensors):
        if t.device != device or t.dtype != torch.int32 or t.shape != (S,) or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous int32 [{S}] tensor on {device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
