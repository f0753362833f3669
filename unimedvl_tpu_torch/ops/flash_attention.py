"""K1a and K1b: flash attention of a query block over cache plus block.

Port of unimedvl_tpu/ops/flash_attention.py::flash_block_attention without its
log-sum-exp output (K1c, sequence-parallel denoise). K1a is the call without
q pre-processing; K1b the call with ``q_preproc``, which fuses the gen-mode
fp32 qk-norm + RoPE of the query side into the kernel. The kernel is CUDA C++
for sm_90a (``csrc/flash_block_attention.cu``); ``flash_block_attention_ref``
is its plain PyTorch version.

Visibility, per stream s: key j is visible iff ``j < lens[s]`` or
``block_start[s] <= j < block_start[s] + q_valid_len[s]``; causal mode adds
``j - block_start[s] <= i`` for query row i. Query rows at or past
``q_valid_len[s]`` are trailing padding and their output is garbage by contract.

``flash_block_attention`` launches the kernel for CUDA tensors and runs the
plain version for CPU tensors; there is no size threshold and no fallback.
The kernel has no backward: on CUDA tensors that require grad, with grad mode
on, the call raises instead of returning an output cut off from the graph.
"""

from __future__ import annotations

from typing import Optional

import torch

from unimedvl_tpu_torch.ops import _launch, cuda_build
from unimedvl_tpu_torch.ops.attention import gqa_attention_hm
from unimedvl_tpu_torch.ops.rope import apply_rope_one

# launches of the kernel and calls of the plain version, for showing which
# ran: ``counts`` without q pre-processing (K1a), ``q_preproc_counts`` with it (K1b)
counts = {"kernel": 0, "plain": 0}
q_preproc_counts = {"kernel": 0, "plain": 0}

KERNEL_HEAD_DIMS = (72, 128)
Q_PREPROC_HEAD_DIM = 128


def _visibility_mask(T, M, lens, block_start, q_valid_len, causal, device):
    j = torch.arange(M, device=device)[None, None, :]
    i = torch.arange(T, device=device)[None, :, None]
    off = j - block_start[:, None, None]
    in_block = (off >= 0) & (off < q_valid_len[:, None, None])
    if causal:
        in_block = in_block & (off <= i)
    return (j < lens[:, None, None]) | in_block  # [S, T, M]


def preprocess_q(q: torch.Tensor, q_preproc: dict) -> torch.Tensor:
    """The gen-mode q island on raw projected q [S, T, H, D], in fp32
    (qwen2_navit.py:568-583): RMSNorm with ``w_und`` on the text rows
    {0, end_row} and ``w_gen`` elsewhere, then RoPE; rounded to q's dtype.

    ``q_preproc``: ``w_und``/``w_gen`` [D]; ``cos``/``sin`` [S, T, D], or
    [S, 1, D] when the block shares one rope position; ``end_row`` (int, or
    scalar or [S] int tensor; None = T - 1); ``eps``."""
    S, T = q.shape[:2]
    end_row = q_preproc.get("end_row")
    end_row = _launch.per_stream(T - 1 if end_row is None else end_row, S, q.device)
    rows = torch.arange(T, device=q.device)[None]
    text = (rows == 0) | (rows == end_row[:, None])  # [S, T]
    w = torch.where(
        text[:, :, None, None], q_preproc["w_und"].float(), q_preproc["w_gen"].float()
    )
    q32 = q.float()
    var = torch.mean(q32 * q32, dim=-1, keepdim=True)
    qn = q32 * torch.rsqrt(var + q_preproc.get("eps", 1e-6)) * w
    return apply_rope_one(qn, q_preproc["cos"].float(), q_preproc["sin"].float()).to(q.dtype)


def flash_block_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lens: torch.Tensor,
    block_start: torch.Tensor,
    causal: bool,
    q_valid_len: Optional[torch.Tensor] = None,
    kv_head_major: bool = False,
    q_preproc: Optional[dict] = None,
) -> torch.Tensor:
    """Plain version of :func:`flash_block_attention`: :func:`preprocess_q`
    when ``q_preproc`` is given, then the masked softmax in fp32 on whatever
    device the inputs are on. Returns [S, T, H, D] in q's dtype."""
    if q_preproc is not None:
        q_preproc_counts["plain"] += 1
        q = preprocess_q(q, q_preproc)
    else:
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


def _preproc_args(q_preproc: dict, S: int, T: int, device: torch.device):
    """K1b's extra C arguments: fp32 norm weights [128], fp32 tables with
    their (stream, row) strides, end_row int32 [S], eps. The tensors are
    returned too, so they outlive the launch."""
    D = Q_PREPROC_HEAD_DIM
    w_und = q_preproc["w_und"].to(torch.float32).contiguous()
    w_gen = q_preproc["w_gen"].to(torch.float32).contiguous()
    rows = q_preproc["cos"].shape[-2]
    if rows not in (1, T):
        raise ValueError(f"rope tables must have 1 or {T} rows, got {rows}")
    cos = q_preproc["cos"].to(torch.float32).expand(S, rows, D).contiguous()
    sin = q_preproc["sin"].to(torch.float32).expand(S, rows, D).contiguous()
    end_row = q_preproc.get("end_row")
    end_row = _launch.per_stream(T - 1 if end_row is None else end_row, S, device)
    for name, t in (("w_und", w_und), ("w_gen", w_gen), ("cos", cos), ("sin", sin)):
        if t.device != device or t.shape[-1] != D:
            raise ValueError(f"q_preproc {name} must be [..., {D}] on {device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    tab_rs = 0 if rows == 1 else D
    ptrs = [w_und.data_ptr(), w_gen.data_ptr(), cos.data_ptr(), sin.data_ptr(),
            rows * D, tab_rs, end_row.data_ptr(), float(q_preproc.get("eps", 1e-6))]
    return ptrs, (w_und, w_gen, cos, sin, end_row)


def _launch_kernel(q, k, v, lens, block_start, causal, q_valid_len, kv_head_major, q_preproc):
    S, T, H, D = q.shape
    if not kv_head_major:  # [S, M, Hk, D] read through its strides as [S, Hk, M, D]
        k, v = k.transpose(1, 2), v.transpose(1, 2)
    if k.shape != v.shape or k.dim() != 4 or k.shape[0] != S or k.shape[3] != D:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match q {tuple(q.shape)}")
    Hk, M = k.shape[1], k.shape[2]
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_block_attention kernel takes head dims {KERNEL_HEAD_DIMS}, got {D}")
    if q_preproc is not None and D != Q_PREPROC_HEAD_DIM:
        raise ValueError(
            f"the q pre-processing kernel (K1b) takes head dim {Q_PREPROC_HEAD_DIM}, got {D}"
        )
    if H % Hk:
        raise ValueError(f"query heads {H} are not a multiple of kv heads {Hk}")
    _launch.check_cuda(("q", "k", "v"), (q, k, v), torch.bfloat16)
    if not q.is_contiguous():
        raise ValueError("q must be contiguous [S, T, H, D]")
    _launch.check_index(
        ("lens", "block_start", "q_valid_len"), (lens, block_start, q_valid_len), S, q.device
    )
    k_str, v_str = _launch.kv_strides("k", k), _launch.kv_strides("v", v)
    out = torch.empty_like(q)
    lib = cuda_build.load_library()
    args = [
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lens.data_ptr(), block_start.data_ptr(), q_valid_len.data_ptr(),
        S, T, H, Hk, D, M, *k_str, *v_str, int(causal), float(D**-0.5),
    ]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if q_preproc is None:
            rc = lib.unimedvl_flash_block_attention_bf16(*args, stream)
            name, launched = "flash_block_attention", counts
        else:
            pre, _keep = _preproc_args(q_preproc, S, T, q.device)
            rc = lib.unimedvl_flash_block_attention_qpre_bf16(*args, *pre, stream)
            name, launched = "flash_block_attention (q_preproc)", q_preproc_counts
    cuda_build.check(rc, name)
    launched["kernel"] += 1
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

    CUDA tensors go through the kernel (bf16, head dim 72 or 128, 128 with
    ``q_preproc``; anything else raises), CPU tensors through
    :func:`flash_block_attention_ref`. The softmax scale is 1/sqrt(D).
    ``kv_head_major`` says k/v are [S, Hk, M, D] (the KV cache layout);
    otherwise [S, M, Hk, D], which the kernel reads through its strides
    without a transpose copy. ``q_preproc`` (see :func:`preprocess_q`): q is
    the raw projection, and the kernel norms and rotates it first (K1b).
    """
    if return_lse:
        raise NotImplementedError(
            "return_lse is kernel K1c (sequence-parallel denoise, ROADMAP slice M13)"
        )
    if q.device.type == "cuda":
        _launch.check_no_grad("flash_block_attention", ("q", "k", "v"), (q, k, v))
        S, T = q.shape[:2]
        return _launch_kernel(
            q, k, v, _launch.per_stream(lens, S, q.device),
            _launch.per_stream(block_start, S, q.device), causal,
            _launch.per_stream(T if q_valid_len is None else q_valid_len, S, q.device),
            kv_head_major, q_preproc,
        )
    if q.device.type == "cpu":
        return flash_block_attention_ref(
            q, k, v, lens, block_start, causal, q_valid_len, kv_head_major, q_preproc
        )
    raise ValueError(f"flash_block_attention runs on CUDA or CPU tensors, got {q.device}")
