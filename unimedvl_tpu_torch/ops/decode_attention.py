"""K2: single-token GQA decode attention over the head-major KV cache.

Port of unimedvl_tpu/ops/decode_attention.py::decode_attention for a bf16
cache; the int8 cache with per-key scales waits for the quantized serving slice
(ROADMAP M8). The kernel is CUDA C++ for sm_90a (``csrc/decode_attention.cu``);
``decode_attention_ref`` is its plain PyTorch version.

Visibility, per stream s: key j is visible iff ``j < lens[s]`` or
``base[s] <= j <= col[s]`` with ``band = (base, col)``. generate_text passes
its aligned decode band; serving's scatter decode passes ``(lens, lens)``.

``decode_attention`` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; there is no size threshold and no fallback.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from unimedvl_tpu_torch.ops import _launch, cuda_build
from unimedvl_tpu_torch.ops.attention import gqa_attention_hm

# launches of the kernel and calls of the plain version, for showing which ran
counts = {"kernel": 0, "plain": 0}

KERNEL_HEAD_DIM = 128
KERNEL_MAX_GROUP = 8


def decode_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lens: torch.Tensor,
    band: Tuple[torch.Tensor, torch.Tensor],
) -> torch.Tensor:
    """Plain version of :func:`decode_attention`: the masked softmax in fp32
    on whatever device the inputs are on. Returns [S, 1, H, D] in q's dtype."""
    counts["plain"] += 1
    S, M = q.shape[0], k.shape[2]
    base = _launch.per_stream(band[0], S, q.device)
    col = _launch.per_stream(band[1], S, q.device)
    lens = _launch.per_stream(lens, S, q.device)
    j = torch.arange(M, device=q.device)[None, None, :]
    mask = (j < lens[:, None, None]) | (
        (j >= base[:, None, None]) & (j <= col[:, None, None])
    )
    return gqa_attention_hm(q.float(), k.float(), v.float(), mask).to(q.dtype)


def _launch_kernel(q, k, v, lens, base, col):
    S, T, H, D = q.shape
    if k.shape != v.shape or k.dim() != 4 or k.shape[0] != S or k.shape[3] != D:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match q {tuple(q.shape)}")
    Hk, M = k.shape[1], k.shape[2]
    if D != KERNEL_HEAD_DIM:
        raise ValueError(f"decode_attention kernel takes head dim {KERNEL_HEAD_DIM}, got {D}")
    if H % Hk or H // Hk > KERNEL_MAX_GROUP:
        raise ValueError(f"{H} query heads over {Hk} kv heads: need a group of at most {KERNEL_MAX_GROUP}")
    _launch.check_bf16_cuda(("q", "k", "v"), (q, k, v))
    if not q.is_contiguous():
        raise ValueError("q must be contiguous [S, 1, H, D]")
    _launch.check_index(("lens", "base", "col"), (lens, base, col), S, q.device)
    k_str, v_str = _launch.kv_strides("k", k), _launch.kv_strides("v", v)
    out = torch.empty_like(q)
    lib = cuda_build.load_library()
    with torch.cuda.device(q.device):
        rc = lib.unimedvl_decode_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lens.data_ptr(), base.data_ptr(), col.data_ptr(),
            S, H, Hk, D, M, *k_str, *v_str, float(D**-0.5),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    cuda_build.check(rc, "decode_attention")
    counts["kernel"] += 1
    return out


def decode_attention(
    q: torch.Tensor,  # [S, 1, H, D]
    k: torch.Tensor,  # [S, Hk, M, D] head-major cache layout
    v: torch.Tensor,
    lens: torch.Tensor,  # [S] context lengths
    band: Tuple[torch.Tensor, torch.Tensor],  # (base, col) decoded band, inclusive
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Single-token GQA decode attention; returns [S, 1, H, D]. ``band`` values
    may be scalars or [S]. CUDA tensors go through the kernel (bf16, head dim
    128, at most 8 query heads per kv head; anything else raises), CPU tensors
    through :func:`decode_attention_ref`."""
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "the int8 KV cache decode (k/v scales) is ROADMAP slice M8"
        )
    S, T = q.shape[:2]
    if T != 1:
        raise ValueError(f"decode_attention takes one query token per stream, got {T}")
    if q.device.type == "cuda":
        return _launch_kernel(
            q, k, v,
            _launch.per_stream(lens, S, q.device),
            _launch.per_stream(band[0], S, q.device),
            _launch.per_stream(band[1], S, q.device),
        )
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, lens, band)
    raise ValueError(f"decode_attention runs on CUDA or CPU tensors, got {q.device}")
