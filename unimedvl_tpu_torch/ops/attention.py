"""Plain attention over batched padded sequences with explicit masks (port of
unimedvl_tpu/ops/attention.py). These back the plain versions of the attention
kernels (ops/flash_attention.py, ops/decode_attention.py) and the CPU tests;
``combine_attention_partials`` also runs on the sequence-parallel denoise path
(parallel/sp_denoise.py), on the card, as ordinary tensor ops.

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


def gqa_attention_hm_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor],
    scale: Optional[float] = None,
):
    """:func:`gqa_attention_hm` that also returns the log-sum-exp of the
    scaled logits, [B, Tq, H] fp32, for merging partial attentions over
    disjoint key sets (:func:`combine_attention_partials`). A row with no
    visible key gives a zero output and ``lse = NEG_INF`` (float32 min, finite:
    the merge subtracts lses). Such rows pivot their exponentials at 0, so
    every ``exp(NEG_INF - 0)`` is 0; pivoting at their maximum, NEG_INF, would
    make each masked key weigh 1."""
    B, Tq, H, D = q.shape
    Hk = k.shape[1]
    scale = D**-0.5 if scale is None else scale
    qg = q.reshape(B, Tq, Hk, H // Hk, D).float()
    logits = torch.einsum("bqhgd,bhkd->bhgqk", qg, k.float()) * scale
    if mask is not None:
        logits = torch.where(mask[:, None, None], logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m <= NEG_INF / 2, 0.0, m)
    p = torch.exp(logits - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    probs = p / l.clamp_min(1e-30)
    out = torch.einsum("bhgqk,bhkd->bqhgd", probs.to(v.dtype).float(), v.float())
    lse = torch.where(l > 0, m_safe + torch.log(l.clamp_min(1e-30)), NEG_INF)
    lse = lse[..., 0].permute(0, 3, 1, 2).reshape(B, Tq, H)  # [B, Hk, G, Tq] -> [B, Tq, H]
    return out.reshape(B, Tq, H, D).to(q.dtype), lse


def combine_attention_partials(parts):
    """Merge partial attention outputs over disjoint key sets: given
    ``[(o_i [B, T, H, D], lse_i [B, T, H]), ...]``, each o_i normalised over
    its own keys, the attention over their union is ``sum_i w_i o_i / sum_i
    w_i`` with ``w_i = exp(lse_i - max_j lse_j)``, in fp32, rounded to the
    first output's dtype. An empty partial (lse NEG_INF) weighs 0 beside a
    non-empty one; if every partial of a row is empty the weights are equal
    and the zero outputs give 0."""
    lses = torch.stack([lse for _, lse in parts])  # [P, B, T, H]
    ws = torch.exp(lses - lses.amax(dim=0))
    den = ws.sum(dim=0).clamp_min(1e-30)
    out = sum(o.float() * (ws[i] / den)[..., None] for i, (o, _) in enumerate(parts))
    return out.to(parts[0][0].dtype)


def gqa_attention_quant_hm(
    q: torch.Tensor,
    k_q: torch.Tensor,  # [B, Hk, Tk, D] int8 (head-major cache layout)
    k_scale: torch.Tensor,  # [B, Hk, Tk] fp32
    v_q: torch.Tensor,
    v_scale: torch.Tensor,
    mask: Optional[torch.Tensor],
    scale: Optional[float] = None,
) -> torch.Tensor:
    """:func:`gqa_attention_hm` over an int8 cache without dequantizing it:
    the per-key scales factor into the logits (``k_scale``) and into the
    softmax weights (``v_scale``), which are rounded to q's dtype before the
    P V contraction. The plain version of the int8 decode kernel."""
    B, Tq, H, D = q.shape
    Hk = k_q.shape[1]
    scale = D**-0.5 if scale is None else scale
    qg = q.reshape(B, Tq, Hk, H // Hk, D).float()
    logits = torch.einsum("bqhgd,bhkd->bhgqk", qg, k_q.float())
    logits = logits * (k_scale[:, :, None, None, :] * scale)
    if mask is not None:
        logits = torch.where(mask[:, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1) * v_scale[:, :, None, None, :]
    out = torch.einsum("bhgqk,bhkd->bqhgd", probs.to(q.dtype).float(), v_q.float())
    return out.to(q.dtype).reshape(B, Tq, H, D)


def padding_mask(valid_q: torch.Tensor, valid_kv: torch.Tensor) -> torch.Tensor:
    """[B, Tq] x [B, Tk] -> [B, Tq, Tk] bool."""
    return valid_q[:, :, None] & valid_kv[:, None, :]
