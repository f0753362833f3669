"""Qwen2 Mixture-of-Transformers decoder, und mode (port of
unimedvl_tpu/models/qwen2_mot.py).

The KV cache keeps the JAX package's head-major layout: k, v [L, S, Hk, M, D]
plus per-stream ``lens`` [S] int32. The port updates the cache tensors in
place: a prefill writes its block at columns ``lens[s] + t`` and returns a new
``KVCache`` whose lens have advanced; an aligned-column decode step writes at
column ``col`` (>= every lens) and leaves lens where they were, so the context a
caller holds never sees decode writes.

Module and parameter names follow the released checkpoint
(``language_model.model.layers.{i}.self_attn.q_proj`` ...). Both experts'
weights are held; only the understanding expert runs here. The gen-mode
forward is ROADMAP slice M7.

Attention: prefill blocks (text, image) go through K1a
(ops/flash_attention.py), decode steps through K2 (ops/decode_attention.py),
at every block size.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from unimedvl_tpu.config import LLMConfig
from unimedvl_tpu_torch.models.layers import RMSNorm, embedding, linear
from unimedvl_tpu_torch.ops.activations import ACT2FN
from unimedvl_tpu_torch.ops.decode_attention import decode_attention
from unimedvl_tpu_torch.ops.flash_attention import flash_block_attention
from unimedvl_tpu_torch.ops.rope import apply_rope, rope_cos_sin


@dataclasses.dataclass
class KVCache:
    """Append-only per-stream KV cache: k, v [L, S, Hk, M, D]; lens [S] int32."""

    k: torch.Tensor
    v: torch.Tensor
    lens: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.k.shape[3]

    @classmethod
    def create(cls, num_layers, num_streams, capacity, num_kv_heads, head_dim,
               dtype=torch.bfloat16, device=None) -> "KVCache":
        shape = (num_layers, num_streams, num_kv_heads, capacity, head_dim)
        return cls(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            lens=torch.zeros(num_streams, dtype=torch.int32, device=device),
        )


def _write_kv(cache_l: torch.Tensor, block: torch.Tensor, cols: torch.Tensor) -> None:
    """cache_l [S, Hk, M, D] <- block [S, T, Hk, D] at columns cols [S, T]."""
    S, T = cols.shape
    rows = torch.arange(S, device=cols.device)[:, None].expand(S, T)
    cache_l[rows, :, cols] = block.to(cache_l.dtype)


class Qwen2MoTAttention(nn.Module):
    def __init__(self, cfg: LLMConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        C, H, Hk, D = cfg.hidden_size, cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        experts = ("", "_moe_gen") if cfg.mot_attention else ("",)
        for sfx in experts:
            setattr(self, "q_proj" + sfx, linear(C, H * D, True, device, dtype))
            setattr(self, "k_proj" + sfx, linear(C, Hk * D, True, device, dtype))
            setattr(self, "v_proj" + sfx, linear(C, Hk * D, True, device, dtype))
            setattr(self, "o_proj" + sfx, linear(H * D, C, False, device, dtype))
            if cfg.qk_norm:
                setattr(self, "q_norm" + sfx, RMSNorm(D, cfg.rms_norm_eps, device, dtype))
                setattr(self, "k_norm" + sfx, RMSNorm(D, cfg.rms_norm_eps, device, dtype))

    def forward(self, x, cos, sin, k_cache, v_cache, lens, causal, q_valid_len, decode_cols):
        """x [S, T, C] normed input; k_cache/v_cache [S, Hk, M, D] this layer's
        cache, written in place. Returns the attention output [S, T, C]."""
        cfg = self.cfg
        S, T, _ = x.shape
        H, Hk, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        q = self.q_proj(x).view(S, T, H, D)
        k = self.k_proj(x).view(S, T, Hk, D)
        v = self.v_proj(x).view(S, T, Hk, D)
        if cfg.qk_norm:
            q = self.q_norm(q)
            k = self.k_norm(k)
        q, k = apply_rope(q, k, cos, sin)
        q, k = q.to(x.dtype), k.to(x.dtype)
        if decode_cols is not None:
            base, col = decode_cols
            cols = col.reshape(1, 1).expand(S, 1)
            _write_kv(k_cache, k, cols)
            _write_kv(v_cache, v, cols)
            o = decode_attention(q, k_cache, v_cache, lens, (base, col))
        else:
            cols = lens[:, None] + torch.arange(T, device=x.device)
            _write_kv(k_cache, k, cols)
            _write_kv(v_cache, v, cols)
            o = flash_block_attention(
                q, k_cache, v_cache, lens, lens, causal,
                q_valid_len=q_valid_len, kv_head_major=True,
            )
        return self.o_proj(o.reshape(S, T, H * D))


class Qwen2MLP(nn.Module):
    def __init__(self, cfg: LLMConfig, device=None, dtype=None):
        super().__init__()
        C, I = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = linear(C, I, False, device, dtype)
        self.up_proj = linear(C, I, False, device, dtype)
        self.down_proj = linear(I, C, False, device, dtype)
        self.act = ACT2FN[cfg.hidden_act]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(self.act(self.gate_proj(x)) * self.up_proj(x))


class Qwen2MoTDecoderLayer(nn.Module):
    """Qwen2MoTDecoderLayer (qwen2_navit.py:713-731), und expert path."""

    def __init__(self, cfg: LLMConfig, device=None, dtype=None):
        super().__init__()
        C, eps = cfg.hidden_size, cfg.rms_norm_eps
        self.self_attn = Qwen2MoTAttention(cfg, device, dtype)
        self.mlp = Qwen2MLP(cfg, device, dtype)
        self.input_layernorm = RMSNorm(C, eps, device, dtype)
        self.post_attention_layernorm = RMSNorm(C, eps, device, dtype)
        if cfg.mot_attention:
            self.input_layernorm_moe_gen = RMSNorm(C, eps, device, dtype)
            self.post_attention_layernorm_moe_gen = RMSNorm(C, eps, device, dtype)
        if cfg.use_moe:
            self.mlp_moe_gen = Qwen2MLP(cfg, device, dtype)

    def forward(self, x, cos, sin, k_cache, v_cache, lens, causal, q_valid_len, decode_cols):
        x = x + self.self_attn(
            self.input_layernorm(x), cos, sin, k_cache, v_cache, lens, causal,
            q_valid_len, decode_cols,
        )
        return x + self.mlp(self.post_attention_layernorm(x))


class Qwen2MoTModel(nn.Module):
    def __init__(self, cfg: LLMConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = embedding(cfg.vocab_size, cfg.hidden_size, device, dtype)
        self.layers = nn.ModuleList(
            Qwen2MoTDecoderLayer(cfg, device, dtype) for _ in range(cfg.num_hidden_layers)
        )
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device, dtype)
        if cfg.use_moe:
            self.norm_moe_gen = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device, dtype)

    def forward(
        self,
        x: torch.Tensor,
        positions: torch.Tensor,
        cache: KVCache,
        causal: bool = True,
        q_valid: Optional[torch.Tensor] = None,
        decode_cols: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        mode: str = "und",
    ) -> Tuple[torch.Tensor, KVCache]:
        """Run every decoder layer over a query block against the cache.

        x: [S, T, C] embedded inputs; positions: [S, T] rope ids; q_valid: bool
        [S, T] trailing-padding mask (None = all valid). Returns (normed hidden
        [S, T, C], cache with advanced lens). ``decode_cols=(base, col)``: one
        decode token written at column ``col`` for every stream; lens do not
        advance and the mask admits [0, lens) plus [base, col].
        """
        if mode != "und":
            raise NotImplementedError("the gen-mode MoT forward is ROADMAP slice M7")
        cfg = self.cfg
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
        q_valid_len = None if q_valid is None else q_valid.sum(dim=1, dtype=torch.int32)
        for i, layer in enumerate(self.layers):
            x = layer(x, cos, sin, cache.k[i], cache.v[i], cache.lens, causal,
                      q_valid_len, decode_cols)
        h = self.norm(x)
        if decode_cols is not None:
            lens = cache.lens
        elif q_valid_len is None:
            lens = cache.lens + x.shape[1]
        else:
            lens = cache.lens + q_valid_len
        return h, KVCache(k=cache.k, v=cache.v, lens=lens)


class Qwen2MoTForCausalLM(nn.Module):
    def __init__(self, cfg: LLMConfig, device=None, dtype=None):
        super().__init__()
        self.model = Qwen2MoTModel(cfg, device, dtype)
        self.lm_head = linear(cfg.hidden_size, cfg.vocab_size, False, device, dtype)


def embed_tokens(lm: Qwen2MoTForCausalLM, token_ids: torch.Tensor) -> torch.Tensor:
    return lm.model.embed_tokens(token_ids)


def lm_head(lm: Qwen2MoTForCausalLM, hidden: torch.Tensor) -> torch.Tensor:
    """fp32 logits [..., V]. A bf16 hidden on the card multiplies the bf16
    weight with fp32 accumulation and output (``torch.mm`` with
    ``out_dtype``), so the [V, C] weight is read once and never widened."""
    w = lm.lm_head.weight
    if hidden.dtype == torch.float32:
        return hidden @ w.float().t()
    if not hidden.is_cuda:
        raise ValueError("low-precision lm_head runs on CUDA tensors only")
    h2 = hidden.reshape(-1, hidden.shape[-1])
    logits = torch.mm(h2, w.t(), out_dtype=torch.float32)
    return logits.reshape(*hidden.shape[:-1], w.shape[0])
