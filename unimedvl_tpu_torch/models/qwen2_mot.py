"""Qwen2 Mixture-of-Transformers decoder, und and gen modes (port of
unimedvl_tpu/models/qwen2_mot.py).

The KV cache keeps the JAX package's head-major layout: k, v [L, S, Hk, M, D]
plus per-stream ``lens`` [S] int32. The port updates the cache tensors in
place: a prefill writes its block at columns ``lens[s] + t`` and returns a new
``KVCache`` whose lens have advanced; an aligned-column decode step writes at
column ``col`` (>= every lens) and leaves lens where they were, so the context a
caller holds never sees decode writes.

Module and parameter names follow the released checkpoint
(``language_model.model.layers.{i}.self_attn.q_proj`` ...). Both experts'
weights are held. Und mode runs the understanding expert on every row; gen
mode (VAE image blocks and denoise steps, packing contract
``[<vision_start>, latents..., <vision_end>]``) runs the generation expert
(``*_moe_gen``) on every row and the understanding expert on the two text
rows, 0 and ``gen_end_row`` (T - 1 unless given).

Attention: und blocks (text, ViT images) go through K1a
(ops/flash_attention.py), decode steps through K2 (ops/decode_attention.py),
gen blocks through K1b, which norms and rotates the raw q inside the kernel;
the k side gets the same fp32 island outside it, since its result is what
the cache holds. With ``update_cache=False`` (the denoise steps) a gen block
attends to ``concat(cache slice, block kv)`` and the cache is left untouched.
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
from unimedvl_tpu_torch.ops.rope import apply_rope, apply_rope_one, rope_cos_sin


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


def _mot_rows(x, und_fn, gen_fn, gen: bool, end_row: Optional[int]) -> torch.Tensor:
    """In gen mode, ``gen_fn`` on every row of x [S, T, ...] and ``und_fn``
    on the text rows 0 and ``end_row`` (None: T - 1), which overwrite; in und
    mode ``und_fn`` on every row. The text rows go through ``und_fn`` in one
    call, so the understanding expert's weights are read once."""
    if not gen:
        return und_fn(x)
    y = gen_fn(x)
    end = x.shape[1] - 1 if end_row is None else end_row
    text_y = und_fn(torch.cat([x[:, :1], x[:, end:end + 1]], dim=1)).to(y.dtype)
    y[:, :1] = text_y[:, :1]
    y[:, end:end + 1] = text_y[:, 1:]
    return y


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

    def _proj(self, name, x, gen, end_row):
        gen_fn = getattr(self, name + "_moe_gen") if gen else None
        return _mot_rows(x, getattr(self, name), gen_fn, gen, end_row)

    def forward(self, x, cos, sin, k_cache, v_cache, lens, causal, q_valid_len, decode_cols,
                gen=False, end_row=None, update_cache=True):
        """x [S, T, C] normed input; k_cache/v_cache [S, Hk, M, D] this layer's
        cache, written in place unless ``update_cache`` is False. ``gen``: the
        MoT gen mode (see the module docstring). Returns the attention output
        [S, T, C]."""
        cfg = self.cfg
        S, T, _ = x.shape
        H, Hk, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        q = self._proj("q_proj", x, gen, end_row).view(S, T, H, D)
        k = self._proj("k_proj", x, gen, end_row).view(S, T, Hk, D)
        v = self._proj("v_proj", x, gen, end_row).view(S, T, Hk, D)
        q_preproc = None
        if gen and cfg.qk_norm:
            # fp32 island (qwen2_navit.py:568-583): the q side runs in K1b
            k = _mot_rows(k.float(), self.k_norm, self.k_norm_moe_gen, True, end_row)
            k = apply_rope_one(k, cos, sin).to(x.dtype)
            q_preproc = dict(
                w_und=self.q_norm.weight, w_gen=self.q_norm_moe_gen.weight, cos=cos,
                sin=sin, end_row=end_row, eps=cfg.rms_norm_eps,
            )
        else:
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
        elif update_cache:
            cols = lens[:, None] + torch.arange(T, device=x.device)
            _write_kv(k_cache, k, cols)
            _write_kv(v_cache, v, cols)
            o = flash_block_attention(
                q, k_cache, v_cache, lens, lens, causal,
                q_valid_len=q_valid_len, kv_head_major=True, q_preproc=q_preproc,
            )
        else:
            M0 = k_cache.shape[2]
            k_cat = torch.cat([k_cache, k.to(k_cache.dtype).transpose(1, 2)], dim=2)
            v_cat = torch.cat([v_cache, v.to(v_cache.dtype).transpose(1, 2)], dim=2)
            o = flash_block_attention(
                q, k_cat, v_cat, lens, M0, causal,
                q_valid_len=q_valid_len, kv_head_major=True, q_preproc=q_preproc,
            )
        return self._proj("o_proj", o.reshape(S, T, H * D), gen, end_row)


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
    """Qwen2MoTDecoderLayer (qwen2_navit.py:713-731): MoT input and
    post-attention norms, and the gen expert's MLP ``mlp_moe_gen``."""

    def __init__(self, cfg: LLMConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
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

    def forward(self, x, cos, sin, k_cache, v_cache, lens, causal, q_valid_len, decode_cols,
                gen=False, end_row=None, update_cache=True):
        cfg = self.cfg
        gen_mot = gen and cfg.mot_attention
        gen_moe = gen and cfg.use_moe
        h = _mot_rows(
            x, self.input_layernorm, lambda t: self.input_layernorm_moe_gen(t), gen_mot, end_row
        )
        x = x + self.self_attn(
            h, cos, sin, k_cache, v_cache, lens, causal, q_valid_len, decode_cols,
            gen_mot, end_row, update_cache,
        )
        if cfg.mot_attention:
            h = _mot_rows(
                x, lambda t: self.mlp(self.post_attention_layernorm(t)),
                lambda t: self.mlp_moe_gen(self.post_attention_layernorm_moe_gen(t)),
                gen_moe, end_row,
            )
        else:
            h = _mot_rows(
                self.post_attention_layernorm(x), self.mlp, lambda t: self.mlp_moe_gen(t),
                gen_moe, end_row,
            )
        return x + h


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
        gen_end_row: Optional[int] = None,
        update_cache: bool = True,
    ) -> Tuple[torch.Tensor, KVCache]:
        """Run every decoder layer over a query block against the cache.

        x: [S, T, C] embedded inputs; positions: [S, T] rope ids, or [S, 1]
        when every row of the block shares one position (image blocks: the
        rope tables then stay one row long); q_valid: bool [S, T]
        trailing-padding mask (None = all valid). Returns (normed hidden
        [S, T, C], cache with advanced lens). ``decode_cols=(base, col)``: one
        decode token written at column ``col`` for every stream; lens do not
        advance and the mask admits [0, lens) plus [base, col].

        ``mode="gen"``: the gen packing contract, with the <vision_end> row at
        ``gen_end_row`` (a host int, for a trailing-padded block) or T - 1.
        ``update_cache=False``: the block attends to cache plus itself and the
        cache comes back as it was.
        """
        if mode not in ("und", "gen"):
            raise ValueError(f"mode must be 'und' or 'gen', got {mode!r}")
        gen = mode == "gen"
        if gen and decode_cols is not None:
            raise ValueError("decode_cols is an und-mode decode step")
        cfg = self.cfg
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
        q_valid_len = None if q_valid is None else q_valid.sum(dim=1, dtype=torch.int32)
        for i, layer in enumerate(self.layers):
            x = layer(x, cos, sin, cache.k[i], cache.v[i], cache.lens, causal,
                      q_valid_len, decode_cols, gen, gen_end_row, update_cache)
        h = _mot_rows(
            x, self.norm, lambda t: self.norm_moe_gen(t), gen and cfg.use_moe, gen_end_row
        )
        if not update_cache:
            return h, cache
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
