"""K2 and K2-int8: single-token GQA decode attention over the head-major KV
cache.

Port of unimedvl_tpu/ops/decode_attention.py::decode_attention: a bf16 cache
(K2), or an int8 cache with fp32 per-key scales ``k_scale``, ``v_scale``
[S, Hk, M] (K2-int8), where ``logit = (q . k_int8) * k_scale / sqrt(D)`` and the
softmax weight of key j is multiplied by ``v_scale[j]`` before the P V sum, so
the cache is never dequantized. The kernels are CUDA C++ for sm_90a
(``csrc/decode_attention.cu``, one template, two instances);
``decode_attention_ref`` is their plain PyTorch version.

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
from unimedvl_tpu_torch.ops.attention import gqa_attention_hm, gqa_attention_quant_hm

# launches of the kernel and calls of the plain version, for showing which ran:
# the bf16 cache (K2) and the int8 cache (K2-int8) count apart
counts = {"kernel": 0, "plain": 0}
int8_counts = {"kernel": 0, "plain": 0}

KERNEL_HEAD_DIM = 128
KERNEL_MAX_GROUP = 8


def decode_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lens: torch.Tensor,
    band: Tuple[torch.Tensor, torch.Tensor],
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of :func:`decode_attention`: the masked softmax in fp32
    on whatever device the inputs are on. Returns [S, 1, H, D] in q's dtype."""
    quantized = _check_scales(k, v, k_scale, v_scale)
    (int8_counts if quantized else counts)["plain"] += 1
    S, M = q.shape[0], k.shape[2]
    base = _launch.per_stream(band[0], S, q.device)
    col = _launch.per_stream(band[1], S, q.device)
    lens = _launch.per_stream(lens, S, q.device)
    j = torch.arange(M, device=q.device)[None, None, :]
    mask = (j < lens[:, None, None]) | (
        (j >= base[:, None, None]) & (j <= col[:, None, None])
    )
    if quantized:
        return gqa_attention_quant_hm(q, k, k_scale, v, v_scale, mask)
    return gqa_attention_hm(q.float(), k.float(), v.float(), mask).to(q.dtype)


def _check_scales(k, v, k_scale, v_scale) -> bool:
    """True for an int8 cache with both scales, False for a float cache with
    none; anything between raises."""
    quantized = k.dtype == torch.int8
    if (k_scale is None) != (v_scale is None) or v.dtype != k.dtype:
        raise ValueError("k and v need one dtype, and k_scale and v_scale come together")
    if quantized != (k_scale is not None):
        raise ValueError(
            f"an int8 cache needs k_scale and v_scale, a float cache takes none: got "
            f"{k.dtype} with{'' if k_scale is not None else 'out'} scales"
        )
    if quantized and (k_scale.shape != k.shape[:3] or v_scale.shape != v.shape[:3]):
        raise ValueError(
            f"scales must be [S, Hk, M] = {tuple(k.shape[:3])}, got "
            f"{tuple(k_scale.shape)} and {tuple(v_scale.shape)}"
        )
    return quantized


def _launch_kernel(q, k, v, lens, base, col, k_scale=None, v_scale=None):
    S, T, H, D = q.shape
    if k.shape != v.shape or k.dim() != 4 or k.shape[0] != S or k.shape[3] != D:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match q {tuple(q.shape)}")
    Hk, M = k.shape[1], k.shape[2]
    if D != KERNEL_HEAD_DIM:
        raise ValueError(f"decode_attention kernel takes head dim {KERNEL_HEAD_DIM}, got {D}")
    if H % Hk or H // Hk > KERNEL_MAX_GROUP:
        raise ValueError(f"{H} query heads over {Hk} kv heads: need a group of at most {KERNEL_MAX_GROUP}")
    quantized = k_scale is not None
    _launch.check_cuda(("q",), (q,), torch.bfloat16)
    if quantized:
        _launch.check_cuda(("k", "v"), (k, v), torch.int8)
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            _launch.check_contiguous_cuda(name, t, torch.float32, (S, Hk, M), q.device)
    else:
        _launch.check_cuda(("k", "v"), (k, v), torch.bfloat16)
    if k.device != q.device:
        raise ValueError(f"k and v must be on q's device {q.device}, got {k.device}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous [S, 1, H, D]")
    _launch.check_index(("lens", "base", "col"), (lens, base, col), S, q.device)
    k_str, v_str = _launch.kv_strides("k", k), _launch.kv_strides("v", v)
    out = torch.empty_like(q)
    lib = cuda_build.load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        if quantized:
            rc = lib.unimedvl_decode_attention_int8(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
                v_scale.data_ptr(), out.data_ptr(),
                lens.data_ptr(), base.data_ptr(), col.data_ptr(),
                S, H, Hk, D, M, *k_str, *v_str, float(D**-0.5), stream,
            )
        else:
            rc = lib.unimedvl_decode_attention_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lens.data_ptr(), base.data_ptr(), col.data_ptr(),
                S, H, Hk, D, M, *k_str, *v_str, float(D**-0.5), stream,
            )
    cuda_build.check(rc, "decode_attention")
    (int8_counts if quantized else counts)["kernel"] += 1
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
    may be scalars or [S]. An int8 cache comes with ``k_scale`` and
    ``v_scale`` [S, Hk, M] fp32. CUDA tensors go through the kernel (bf16 q;
    a bf16 or int8 cache; head dim 128, at most 8 query heads per kv head;
    anything else raises), CPU tensors through :func:`decode_attention_ref`.
    The kernel has no backward: CUDA inputs that require grad, with grad mode
    on, raise."""
    _check_scales(k, v, k_scale, v_scale)
    S, T = q.shape[:2]
    if T != 1:
        raise ValueError(f"decode_attention takes one query token per stream, got {T}")
    if q.device.type == "cuda":
        _launch.check_no_grad("decode_attention", ("q", "k", "v"), (q, k, v))
        return _launch_kernel(
            q, k, v,
            _launch.per_stream(lens, S, q.device),
            _launch.per_stream(band[0], S, q.device),
            _launch.per_stream(band[1], S, q.device),
            k_scale, v_scale,
        )
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, lens, band, k_scale, v_scale)
    raise ValueError(f"decode_attention runs on CUDA or CPU tensors, got {q.device}")
