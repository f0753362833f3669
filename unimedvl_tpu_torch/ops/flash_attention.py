"""K1a: flash attention of a query block over cache plus block.

Port of unimedvl_tpu/ops/flash_attention.py::flash_block_attention without its
fused q pre-processing (K1b, gen mode) and log-sum-exp output (K1c, sequence-
parallel denoise). The kernel is CUDA C++ for sm_90a
(``csrc/flash_block_attention.cu``); ``flash_block_attention_ref`` is its plain
PyTorch version.

Visibility, per stream s: key j is visible iff ``j < lens[s]`` or
``block_start[s] <= j < block_start[s] + q_valid_len[s]``; causal mode adds
``j - block_start[s] <= i`` for query row i. Query rows at or past
``q_valid_len[s]`` are trailing padding and their output is garbage by contract.

``flash_block_attention`` launches the kernel for CUDA tensors and runs the
plain version for CPU tensors; there is no size threshold and no fallback.
"""

from __future__ import annotations

from typing import Optional

import torch

from unimedvl_tpu_torch.ops import _launch, cuda_build
from unimedvl_tpu_torch.ops.attention import gqa_attention_hm

# launches of the kernel and calls of the plain version, for showing which ran
counts = {"kernel": 0, "plain": 0}

KERNEL_HEAD_DIMS = (72, 128)


def _visibility_mask(T, M, lens, block_start, q_valid_len, causal, device):
    j = torch.arange(M, device=device)[None, None, :]
    i = torch.arange(T, device=device)[None, :, None]
    off = j - block_start[:, None, None]
    in_block = (off >= 0) & (off < q_valid_len[:, None, None])
    if causal:
        in_block = in_block & (off <= i)
    return (j < lens[:, None, None]) | in_block  # [S, T, M]


def flash_block_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lens: torch.Tensor,
    block_start: torch.Tensor,
    causal: bool,
    q_valid_len: Optional[torch.Tensor] = None,
    kv_head_major: bool = False,
) -> torch.Tensor:
    """Plain version of :func:`flash_block_attention`: the masked softmax in
    fp32 on whatever device the inputs are on. Returns [S, T, H, D] in q's dtype."""
    counts["plain"] += 1
    S, T = q.shape[:2]
    if not kv_head_major:
        k, v = k.transpose(1, 2), v.transpose(1, 2)
    M = k.shape[2]
    mask = _visibility_mask(
        T, M, _launch.per_stream(lens, S, q.device),
        _launch.per_stream(block_start, S, q.device),
        _launch.per_stream(T if q_valid_len is None else q_valid_len, S, q.device),
        causal, q.device,
    )
    return gqa_attention_hm(q.float(), k.float(), v.float(), mask).to(q.dtype)


def _launch_kernel(q, k, v, lens, block_start, causal, q_valid_len, kv_head_major):
    S, T, H, D = q.shape
    if not kv_head_major:  # [S, M, Hk, D] read through its strides as [S, Hk, M, D]
        k, v = k.transpose(1, 2), v.transpose(1, 2)
    if k.shape != v.shape or k.dim() != 4 or k.shape[0] != S or k.shape[3] != D:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match q {tuple(q.shape)}")
    Hk, M = k.shape[1], k.shape[2]
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_block_attention kernel takes head dims {KERNEL_HEAD_DIMS}, got {D}")
    if H % Hk:
        raise ValueError(f"query heads {H} are not a multiple of kv heads {Hk}")
    _launch.check_bf16_cuda(("q", "k", "v"), (q, k, v))
    if not q.is_contiguous():
        raise ValueError("q must be contiguous [S, T, H, D]")
    _launch.check_index(
        ("lens", "block_start", "q_valid_len"), (lens, block_start, q_valid_len), S, q.device
    )
    k_str, v_str = _launch.kv_strides("k", k), _launch.kv_strides("v", v)
    out = torch.empty_like(q)
    lib = cuda_build.load_library()
    with torch.cuda.device(q.device):
        rc = lib.unimedvl_flash_block_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lens.data_ptr(), block_start.data_ptr(), q_valid_len.data_ptr(),
            S, T, H, Hk, D, M, *k_str, *v_str, int(causal), float(D**-0.5),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    cuda_build.check(rc, "flash_block_attention")
    counts["kernel"] += 1
    return out


def flash_block_attention(
    q: torch.Tensor,  # [S, T, H, D]
    k: torch.Tensor,  # [S, M, Hk, D], or head-major [S, Hk, M, D]
    v: torch.Tensor,
    lens: torch.Tensor,  # [S] int valid context length
    block_start: torch.Tensor,  # [S] int where the query block's keys start
    causal: bool,
    q_valid_len: Optional[torch.Tensor] = None,  # [S] valid block length (<= T)
    kv_head_major: bool = False,
    q_preproc: Optional[dict] = None,
    return_lse: bool = False,
) -> torch.Tensor:
    """Attention of the query block over cache plus block; returns [S, T, H, D].

    CUDA tensors go through the kernel (bf16, head dim 72 or 128; anything else
    raises), CPU tensors through :func:`flash_block_attention_ref`. The softmax
    scale is 1/sqrt(D). ``kv_head_major`` says k/v are [S, Hk, M, D] (the KV
    cache layout); otherwise [S, M, Hk, D], which the kernel reads through its
    strides without a transpose copy.
    """
    if q_preproc is not None:
        raise NotImplementedError(
            "fused q pre-processing is kernel K1b (gen mode, ROADMAP slice M7)"
        )
    if return_lse:
        raise NotImplementedError(
            "return_lse is kernel K1c (sequence-parallel denoise, ROADMAP slice M13)"
        )
    if q.device.type == "cuda":
        S, T = q.shape[:2]
        return _launch_kernel(
            q, k, v, _launch.per_stream(lens, S, q.device),
            _launch.per_stream(block_start, S, q.device), causal,
            _launch.per_stream(T if q_valid_len is None else q_valid_len, S, q.device),
            kv_head_major,
        )
    if q.device.type == "cpu":
        return flash_block_attention_ref(
            q, k, v, lens, block_start, causal, q_valid_len, kv_head_major
        )
    raise ValueError(f"flash_block_attention runs on CUDA or CPU tensors, got {q.device}")
