"""Plain attention over batched padded sequences with explicit masks (port of
unimedvl_tpu/ops/attention.py). These back the plain versions of the attention
kernels (ops/flash_attention.py, ops/decode_attention.py) and the CPU tests.

Logits, softmax and both contractions run in fp32, as the JAX package's
``preferred_element_type=float32`` einsums do; the probabilities are rounded to
v's dtype before the P V contraction, as there.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = float(torch.finfo(torch.float32).min)


def _softmax_av(logits, mask, v, out_dtype, pv_eq):
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum(pv_eq, probs.to(v.dtype).float(), v.float()).to(out_dtype)


def gqa_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor],
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Grouped-query attention. q: [B, Tq, H, D]; k/v: [B, Tk, Hk, D];
    mask: bool [B, Tq, Tk] (True = attend) or None. Returns [B, Tq, H, D]."""
    B, Tq, H, D = q.shape
    Hk = k.shape[2]
    scale = D**-0.5 if scale is None else scale
    qg = q.reshape(B, Tq, Hk, H // Hk, D).float()
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    m = None if mask is None else mask[:, None, None]
    out = _softmax_av(logits, m, v, q.dtype, "bhgqk,bkhd->bqhgd")
    return out.reshape(B, Tq, H, D)


def gqa_attention_hm(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor],
    scale: Optional[float] = None,
) -> torch.Tensor:
    """GQA over head-major kv (the KV cache layout). q: [B, Tq, H, D];
    k/v: [B, Hk, Tk, D]; mask: bool [B, Tq, Tk] or None."""
    B, Tq, H, D = q.shape
    Hk = k.shape[1]
    scale = D**-0.5 if scale is None else scale
    qg = q.reshape(B, Tq, Hk, H // Hk, D).float()
    logits = torch.einsum("bqhgd,bhkd->bhgqk", qg, k.float()) * scale
    m = None if mask is None else mask[:, None, None]
    out = _softmax_av(logits, m, v, q.dtype, "bhgqk,bhkd->bqhgd")
    return out.reshape(B, Tq, H, D)


def padding_mask(valid_q: torch.Tensor, valid_kv: torch.Tensor) -> torch.Tensor:
    """[B, Tq] x [B, Tk] -> [B, Tq, Tk] bool."""
    return valid_q[:, :, None] & valid_kv[:, None, :]
