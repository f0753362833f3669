"""K5: differentiable attention for the packed training forward, with the
reference's composable mask (data_utils.py:13-40) evaluated inside the kernels
from three segment-id arrays.

Port of unimedvl_tpu/ops/flash_attention_train.py::packed_train_attention. The
three kernels (forward, dq, dk/dv) are CUDA C++ for sm_90a
(``csrc/packed_train_attention.cu``); ``packed_train_attention_ref`` is the
plain PyTorch version (the dense mask of ops/blockmask.py and
``gqa_attention``, differentiated by autograd).

    allowed(q, k) = (q >= k or (fn[q] == fn[k] and fn[q] >= 0))
                    and not (noise[k] >= 0 and noise[q] != noise[k])
                    and doc[q] == doc[k]

``packed_train_attention`` launches the kernels for CUDA tensors (bf16, head
dim 128; anything else raises) through a ``torch.autograd.Function`` and runs
the plain version for CPU tensors; there is no size threshold and no
fallback. The kernels feed bf16 to the tensor cores, accumulate in fp32 and
round the probabilities and ``ds`` to bf16 for the second product of each
chain, so against the plain version on the same bf16 inputs the output agrees
to about 2^-8 of its value and each gradient to about 2^-7 of its row's
largest entry. A query row that may attend to nothing (which no packed batch
produces: every token sees itself) comes out as zero from the kernels and as
the mean of v from the plain version.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from unimedvl_tpu_torch.ops import _launch, cuda_build
from unimedvl_tpu_torch.ops.attention import gqa_attention
from unimedvl_tpu_torch.ops.blockmask import dense_packed_mask

# launches of each kernel and calls of the plain version, for showing which ran
counts = {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0, "plain": 0}

KERNEL_HEAD_DIM = 128


def packed_train_attention_ref(
    q: torch.Tensor,  # [T, H, D]
    k: torch.Tensor,  # [T, Hk, D]
    v: torch.Tensor,
    doc_id: torch.Tensor,  # [T] int
    fn_id: torch.Tensor,
    noise_id: torch.Tensor,
) -> torch.Tensor:
    """Plain version of :func:`packed_train_attention`: the dense [T, T] mask
    and a masked softmax in fp32, on whatever device and in whatever dtype the
    inputs are; autograd differentiates it. Returns [T, H, D] in q's dtype."""
    counts["plain"] += 1
    mask = dense_packed_mask(doc_id, fn_id, noise_id)
    return gqa_attention(q[None], k[None], v[None], mask[None])[0]


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` [T, heads, D] as the kernels read it: D contiguous, a head stride
    of D, rows on 16-byte boundaries; copied only when its layout differs."""
    D = t.shape[-1]
    per_load = _launch.LOAD_BYTES // t.element_size()
    if (t.stride(2) == 1 and t.stride(1) == D and t.stride(0) % per_load == 0
            and t.data_ptr() % _launch.LOAD_BYTES == 0):
        return t
    return t.contiguous()


def _ids(x: torch.Tensor, T: int, device: torch.device, name: str) -> torch.Tensor:
    if x.shape != (T,) or x.device != device:
        raise ValueError(f"{name} must be [{T}] on {device}, got {tuple(x.shape)} on {x.device}")
    return x.to(torch.int32).contiguous()


def _check(q, k, v) -> Tuple[int, int, int, int]:
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[2] != q.shape[2]:
        raise ValueError(
            f"expected q [T, H, D] and k, v [T, Hk, D], got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}")
    T, H, D = q.shape
    Hk = k.shape[1]
    if D != KERNEL_HEAD_DIM:
        raise ValueError(f"the packed training attention kernels take head dim "
                         f"{KERNEL_HEAD_DIM}, got {D}")
    if H % Hk:
        raise ValueError(f"query heads {H} are not a multiple of kv heads {Hk}")
    _launch.check_cuda(("q", "k", "v"), (q, k, v), torch.bfloat16)
    return T, H, Hk, D


def _launch_fwd(q, k, v, doc, fn, nz):
    """The forward kernel: (out [T, H, D] bf16, lse [H, T] fp32)."""
    T, H, Hk, D = _check(q, k, v)
    out = torch.empty((T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((H, T), dtype=torch.float32, device=q.device)
    lib = cuda_build.load_library()
    with torch.cuda.device(q.device):
        rc = lib.unimedvl_packed_train_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            doc.data_ptr(), fn.data_ptr(), nz.data_ptr(), T, H, Hk, D,
            q.stride(0), k.stride(0), v.stride(0), float(D**-0.5),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    cuda_build.check(rc, "packed_train_attention (forward)")
    counts["fwd"] += 1
    return out, lse


def _launch_bwd(q, k, v, out, lse, doc, fn, nz, grad_out, need_dq: bool, need_dkv: bool):
    """The backward kernels: (dq or None, dk or None, dv or None). ``dsum`` is
    taken in fp32 from the cotangent as it arrives; the kernels read the
    cotangent rounded to q's dtype, as the TPU kernels do."""
    T, H, Hk, D = _check(q, k, v)
    dsum = (grad_out.float() * out.float()).sum(dim=-1).t().contiguous()  # [H, T]
    do = _rows(grad_out.to(q.dtype))
    lib = cuda_build.load_library()
    common = (T, H, Hk, D, q.stride(0), k.stride(0), v.stride(0), do.stride(0), float(D**-0.5))
    ids = (doc.data_ptr(), fn.data_ptr(), nz.data_ptr())
    dq = dk = dv = None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if need_dq:
            dq = torch.empty((T, H, D), dtype=q.dtype, device=q.device)
            rc = lib.unimedvl_packed_train_attention_bwd_dq(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                dsum.data_ptr(), dq.data_ptr(), *ids, *common, stream)
            cuda_build.check(rc, "packed_train_attention (dq)")
            counts["bwd_dq"] += 1
        if need_dkv:
            dk = torch.empty((T, Hk, D), dtype=k.dtype, device=q.device)
            dv = torch.empty((T, Hk, D), dtype=v.dtype, device=q.device)
            rc = lib.unimedvl_packed_train_attention_bwd_dkv(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                dsum.data_ptr(), dk.data_ptr(), dv.data_ptr(), *ids, *common, stream)
            cuda_build.check(rc, "packed_train_attention (dk/dv)")
            counts["bwd_dkv"] += 1
    return dq, dk, dv


class _PackedTrainAttention(torch.autograd.Function):
    """The three kernels under autograd: the forward saves q, k, v, out, lse
    and the ids; the backward is not itself differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, doc, fn, nz):
        q, k, v = _rows(q), _rows(k), _rows(v)
        out, lse = _launch_fwd(q, k, v, doc, fn, nz)
        ctx.save_for_backward(q, k, v, out, lse, doc, fn, nz)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        q, k, v, out, lse, doc, fn, nz = ctx.saved_tensors
        need = ctx.needs_input_grad
        dq, dk, dv = _launch_bwd(q, k, v, out, lse, doc, fn, nz, grad_out,
                                 need[0], need[1] or need[2])
        return dq, dk if need[1] else None, dv if need[2] else None, None, None, None


def packed_train_attention(
    q: torch.Tensor,  # [T, H, D]
    k: torch.Tensor,  # [T, Hk, D]
    v: torch.Tensor,  # [T, Hk, D]
    doc_id: torch.Tensor,  # [T] int
    fn_id: torch.Tensor,  # [T] int
    noise_id: torch.Tensor,  # [T] int
) -> torch.Tensor:
    """Packed training attention under the segment mask; returns [T, H, D] in
    q's dtype, differentiable in q, k and v (the ids carry no gradient).

    CUDA tensors go through the kernels (bf16, head dim 128; anything else
    raises), CPU tensors through :func:`packed_train_attention_ref`. The
    softmax scale is 1/sqrt(D)."""
    if q.device.type == "cuda":
        T = q.shape[0]
        ids = [_ids(x, T, q.device, name) for x, name in
               ((doc_id, "doc_id"), (fn_id, "fn_id"), (noise_id, "noise_id"))]
        return _PackedTrainAttention.apply(q, k, v, *ids)
    if q.device.type == "cpu":
        return packed_train_attention_ref(q, k, v, doc_id, fn_id, noise_id)
    raise ValueError(f"packed_train_attention runs on CUDA or CPU tensors, got {q.device}")
