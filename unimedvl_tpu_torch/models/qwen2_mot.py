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
(ops/flash_attention.py), decode steps through K2 (ops/decode_attention.py):
the aligned-column step (``decode_cols``) and serving's per-stream step (one
causal und token per stream, written at its own ``lens[s]``, band
``(lens, lens)``); gen blocks through K1b, which norms and rotates the raw q
inside the kernel; the k side gets the same fp32 island outside it, since its
result is what the cache holds. With ``update_cache=False`` (the denoise
steps) a gen block attends to ``concat(cache slice, block kv)`` and the cache
is left untouched.

Quantized serving modes (unimedvl_tpu_torch/quant.py). A projection may be a
``QuantLinear`` (int8 or packed-int4 weights) and q/k/v and gate/up may be
fused into ``qkv_proj`` and ``gate_up_proj`` (or their shard-interleaved
``_tp{N}`` variants, de-interleaved here); the modules use what they hold.
On a down projection that quantizes its input (modes ``qa``, ``p4a``) with a
silu activation, the MLP forms ``silu(gate) * up`` and its per-token int8
quantization in one pass (K3, ops/act_quant.py), always. The KV cache may be
int8 (``KVCache.create(quantized=True)``): k, v int8 with fp32 per-key scales
``k_scale``, ``v_scale`` [L, S, Hk, M], one layout for every path. A write
quantizes the block and stores its scales at the same columns, in place;
decode steps go through K2-int8 with the layer's scales; prefill and denoise
blocks dequantize the layer's slice once and take K1a / K1b. A multi-stream
write whose window runs past capacity is dropped for that stream, as the JAX
package's scatter drops it (serving's finished streams run on to the end of
their chunk). With ``kv_bits=4`` the values are int4 in [-7, 7], two to a
byte along D (``pack_int4``, K4's nibble order), under the same scales:
every path writes and reads them where it writes and reads int8, a read
unpacking the layer's slice to int8 first (``unpack_int4``).

Training (``forward_train``): one packed flat sequence [T, C] with no cache.
Each token belongs to one expert by index (``und_idx``, ``gen_idx``); every
projection, norm and MLP is applied per expert and written back to packed
order (``_route``). With ``segments`` (document, full-span and noise-span ids)
attention goes through K5 (ops/flash_attention_train.py), which evaluates the
mask in the kernel and has backward kernels; without, through the dense
[T, T] mask. The index arrays hold real tokens only: the host drops the
padding slots of ``data.packing.pack_training_batch`` before they reach the
device (``training.dataset.prepare_sequence``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from unimedvl_tpu_torch.config import LLMConfig
from unimedvl_tpu_torch import quant
from unimedvl_tpu_torch.models.layers import QuantLinear, RMSNorm, embedding, linear
from unimedvl_tpu_torch.ops.act_quant import silu_mul_quant_autograd, silu_mul_quant_global
from unimedvl_tpu_torch.ops.activations import ACT2FN
from unimedvl_tpu_torch.ops.attention import gqa_attention
from unimedvl_tpu_torch.ops.decode_attention import decode_attention
from unimedvl_tpu_torch.ops.flash_attention import flash_block_attention
from unimedvl_tpu_torch.ops.flash_attention_train import packed_train_attention
from unimedvl_tpu_torch.ops.rope import apply_rope, apply_rope_one, rope_cos_sin
# the int4 cache packs along D as K4 packs its weights along K
from unimedvl_tpu_torch.ops.w4_matmul import pack_int4, unpack_int4
from unimedvl_tpu_torch.parallel import mesh as pmesh


@dataclasses.dataclass
class KVCache:
    """Append-only per-stream KV cache: k, v [L, S, Hk, M, D]; lens [S] int32.
    The int8 serving mode (``create(..., quantized=True)``) stores k, v as
    int8 with fp32 per-(stream, head, position) absmax scales ``k_scale``,
    ``v_scale`` [L, S, Hk, M]: half the cache bytes a decode step reads.
    ``kv_bits=4`` stores int4 values packed two to a byte along D (k, v
    [L, S, Hk, M, D / 2] int8; ``pack_int4``: element 2j in the low nibble of
    byte j, two's complement) under the same scales: a quarter of the bf16
    cache's bytes. ``kv_bits`` is the stored width of a
    quantized cache (torch has no int4 dtype, so the dtype cannot tell);
    the head dim is the config's, never ``k.shape[-1]``."""

    k: torch.Tensor
    v: torch.Tensor
    lens: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    kv_bits: int = 8

    @property
    def capacity(self) -> int:
        return self.k.shape[3]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @classmethod
    def create(cls, num_layers, num_streams, capacity, num_kv_heads, head_dim,
               dtype=torch.bfloat16, device=None, quantized: bool = False,
               kv_bits: int = 8) -> "KVCache":
        shape = (num_layers, num_streams, num_kv_heads, capacity, head_dim)
        lens = torch.zeros(num_streams, dtype=torch.int32, device=device)
        if not quantized:
            return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device), lens=lens)
        check_kv_bits(kv_bits)
        if kv_bits == 4 and head_dim % 2:
            raise ValueError(f"an int4 cache packs pairs along the head dim; {head_dim} is odd")
        vshape = shape[:-1] + (head_dim * kv_bits // 8,)
        return cls(
            k=torch.zeros(vshape, dtype=torch.int8, device=device),
            v=torch.zeros(vshape, dtype=torch.int8, device=device), lens=lens,
            k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            kv_bits=kv_bits,
        )

    def _map(self, kv_fn, scale_fn, lens) -> "KVCache":
        return dataclasses.replace(
            self, k=kv_fn(self.k), v=kv_fn(self.v), lens=lens,
            k_scale=None if self.k_scale is None else scale_fn(self.k_scale),
            v_scale=None if self.v_scale is None else scale_fn(self.v_scale),
        )

    def clone(self) -> "KVCache":
        """The same contents in storage of its own."""
        return self._map(torch.clone, torch.clone, self.lens.clone())

    def padded(self, pad: int) -> "KVCache":
        """``pad`` more zeroed columns of capacity, in new tensors."""
        if pad == 0:
            return self
        return self._map(lambda t: F.pad(t, (0, 0, 0, pad)), lambda t: F.pad(t, (0, pad)),
                         self.lens)

    def streams(self, n: int) -> "KVCache":
        """A view of the first ``n`` streams."""
        return self._map(lambda t: t[:, :n], lambda t: t[:, :n], self.lens[:n])

    @classmethod
    def stack(cls, caches) -> "KVCache":
        """Caches of one capacity and one kind joined along the stream dim."""
        if len({(c.quantized, c.quantized and c.kv_bits) for c in caches}) != 1:
            raise ValueError("cannot stack a mix of int8 and float KV caches, or of int8 "
                             "and int4 ones")
        cat = lambda ts: torch.cat(ts, dim=1)  # noqa: E731
        quantized = caches[0].quantized
        return cls(
            k=cat([c.k for c in caches]), v=cat([c.v for c in caches]),
            lens=torch.cat([c.lens for c in caches]),
            k_scale=cat([c.k_scale for c in caches]) if quantized else None,
            v_scale=cat([c.v_scale for c in caches]) if quantized else None,
            kv_bits=caches[0].kv_bits,
        )

    def layer(self, i: int):
        """(k, v, k_scale, v_scale, bits) of layer ``i``: views of the arrays,
        the scales None for a float cache, ``bits`` the stored width of a
        quantized one (else None)."""
        if self.k_scale is None:
            return self.k[i], self.v[i], None, None, None
        return self.k[i], self.v[i], self.k_scale[i], self.v_scale[i], self.kv_bits


def check_kv_bits(kv_bits: int) -> None:
    """A quantized cache stores int8 or int4 values; other widths raise, as
    the JAX package's ``assert kv_bits in (8, 4)`` refuses them."""
    if kv_bits not in (8, 4):
        raise ValueError(f"kv_bits={kv_bits}: a quantized KV cache stores 8 or 4 bits")


def _quantize_kv_block(block: torch.Tensor, bits: int = 8):
    """[..., D] -> (values, fp32 per-row absmax scales over the last dim):
    int8 values, or with ``bits`` 4 the JAX package's int4 rounding
    (``max(absmax, 1e-8) / 7``, round half to even, clip to [-7, 7]) packed
    by :func:`pack_int4`."""
    if bits != 4:
        q, scale = quant.quantize_activations(block)
        return q, scale[..., 0]
    b32 = block.float()
    scale = torch.clamp_min(b32.abs().amax(dim=-1), 1e-8) / 7.0
    q = torch.clamp(torch.round(b32 / scale[..., None]), -7, 7).to(torch.int8)
    return pack_int4(q), scale


def dequant_slice(vals: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype,
                  bits: int = 8) -> torch.Tensor:
    """int8 [..., D] (or packed int4 [..., D / 2] with ``bits`` 4) x fp32
    [...] -> ``dtype`` [..., D]: a cache slice as the prefill and denoise
    kernels read it, materialised once per layer."""
    if bits == 4:
        vals = unpack_int4(vals)
    return (vals.float() * scale[..., None]).to(dtype)


def _write_kv(cache_l: torch.Tensor, block: torch.Tensor, cols: torch.Tensor,
              scale_l: Optional[torch.Tensor] = None, drop_overflow: bool = False,
              bits: int = 8) -> None:
    """cache_l [S, Hk, M, D] <- block [S, T, Hk, D] at columns cols [S, T], in
    place. With ``scale_l`` [S, Hk, M] (a quantized cache of ``bits``) the
    block is quantized per (token, head), packed where ``bits`` is 4 (cache_l
    is then [S, Hk, M, D / 2]), and its scales land at the same columns.

    ``drop_overflow``: a row whose window (ascending columns) runs past M is
    dropped whole and its cache row stays as it was, as the JAX package's
    multi-stream scatter drops it: the row's columns are clamped and rewritten
    with what they held, so no host sync decides which rows write."""
    S, T = cols.shape
    rows = torch.arange(S, device=cols.device)[:, None].expand(S, T)
    if scale_l is None:
        vals = [(cache_l, block.to(cache_l.dtype))]
    else:
        q, scale = _quantize_kv_block(block, bits)
        vals = [(cache_l, q), (scale_l, scale)]
    if drop_overflow:
        M = cache_l.shape[2]
        fits = cols[:, -1:] < M  # [S, 1]
        cols = cols.clamp_max(M - 1)
        vals = [(dst, torch.where(fits.view(S, 1, *(1,) * (src.dim() - 2)), src,
                                  dst[rows, :, cols]))
                for dst, src in vals]
    for dst, src in vals:
        dst[rows, :, cols] = src


def _decode_kv(k_cache: torch.Tensor, v_cache: torch.Tensor, bits: Optional[int]):
    """The layer's k, v slices as K2 / K2-int8 take them: an int4 cache's
    values unpacked to int8 over every column (the band's reach is on the
    device, and reading it would synchronise the host), the scales applied
    by the kernel as for int8."""
    if bits == 4:
        return unpack_int4(k_cache), unpack_int4(v_cache)
    return k_cache, v_cache


def _mot_rows(x, und_fn, gen_fn, gen: bool, end_row) -> torch.Tensor:
    """In gen mode, ``gen_fn`` on every row of x [S, T, ...] and ``und_fn``
    on the text rows 0 and ``end_row`` (None: T - 1), which overwrite; in und
    mode ``und_fn`` on every row. The text rows go through ``und_fn`` in one
    call, so the understanding expert's weights are read once.

    ``end_row``: a host int, or a 0-dim or one-element integer tensor on x's
    device, one row for every stream (a bucketed block's <vision_end>, which
    a device program takes as an input, as the JAX package traces it): that
    row is gathered and written back by index (``index_select`` /
    ``index_copy_``), the same values as the slices of a host int."""
    if not gen:
        return und_fn(x)
    y = gen_fn(x)
    if isinstance(end_row, torch.Tensor):
        end = end_row.reshape(1).to(torch.int64)
        text_y = und_fn(torch.cat([x[:, :1], x.index_select(1, end)], dim=1)).to(y.dtype)
        y[:, :1] = text_y[:, :1]
        return y.index_copy_(1, end, text_y[:, 1:])
    end = x.shape[1] - 1 if end_row is None else end_row
    text_y = und_fn(torch.cat([x[:, :1], x[:, end:end + 1]], dim=1)).to(y.dtype)
    y[:, :1] = text_y[:, :1]
    y[:, end:end + 1] = text_y[:, 1:]
    return y


def _attend_cache_and_block(q, k, v, k_cache, v_cache, lens, causal, q_valid_len, q_preproc):
    """Attention of a block that is not written to the cache (the denoise
    steps): the block's k, v [S, T, Hk, D] are copied behind the cache slice
    [S, Hk, M, D] and the whole goes through K1a / K1b with the block at
    column M. (K6, ``ops.flash_attention.flash_cache_block_attention``, computes
    the same without the copy; the JAX package does not route this call
    through it, and neither does the port.)"""
    M0 = k_cache.shape[2]
    k_cat = torch.cat([k_cache, k.to(k_cache.dtype).transpose(1, 2)], dim=2)
    v_cat = torch.cat([v_cache, v.to(v_cache.dtype).transpose(1, 2)], dim=2)
    return flash_block_attention(
        q, k_cat, v_cat, lens, M0, causal,
        q_valid_len=q_valid_len, kv_head_major=True, q_preproc=q_preproc,
    )


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

    def forward(self, x, cos, sin, kv_layer, lens, causal, q_valid_len, decode_cols,
                gen=False, end_row=None, update_cache=True):
        """x [S, T, C] normed input; ``kv_layer``: this layer's cache views
        (k, v [S, Hk, M, D], and for a quantized cache k_scale, v_scale
        [S, Hk, M] and its width, else None; int4 values packed, [S, Hk, M,
        D / 2]), written in place unless ``update_cache`` is False. ``gen``:
        the MoT gen mode (see the module docstring). Returns the attention
        output [S, T, C]."""
        cfg = self.cfg
        S, T, _ = x.shape
        H, Hk, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        k_cache, v_cache, k_scale, v_scale, bits = kv_layer
        fused, ftp = quant.fused_key(self, "qkv_proj")
        if fused is not None:  # serving fusion: one projection, not three
            qkv = self._proj(fused, x, gen, end_row)
            q, k, v = quant.deinterleave(qkv, ftp, (H * D, Hk * D, Hk * D))
            q, k, v = q.reshape(S, T, H, D), k.reshape(S, T, Hk, D), v.reshape(S, T, Hk, D)
        else:
            q = self._proj("q_proj", x, gen, end_row).view(S, T, H, D)
            k = self._proj("k_proj", x, gen, end_row).view(S, T, Hk, D)
            v = self._proj("v_proj", x, gen, end_row).view(S, T, Hk, D)
        q_preproc = None
        if gen and cfg.qk_norm:
            # fp32 island (qwen2_navit.py:568-583): the q side runs in K1b
            k = _mot_rows(k.float(), self.k_norm, self.k_norm_moe_gen, True, end_row)
            k = apply_rope_one(k, cos, sin).to(x.dtype)
            q = q.contiguous()  # a view of the fused qkv output otherwise; K1b reads it raw
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
            _write_kv(k_cache, k, cols, k_scale, bits=bits)
            _write_kv(v_cache, v, cols, v_scale, bits=bits)
            o = decode_attention(q, *_decode_kv(k_cache, v_cache, bits), lens, (base, col),
                                 k_scale=k_scale, v_scale=v_scale)
        elif update_cache:
            # one stream: the window lands where the JAX package's
            # dynamic_update_slice puts it, its start clamped into [0, M - T];
            # several: at lens, a window past M dropped whole
            start = lens.clamp(0, k_cache.shape[2] - T) if S == 1 else lens
            cols = start[:, None] + torch.arange(T, device=x.device)
            _write_kv(k_cache, k, cols, k_scale, drop_overflow=S > 1, bits=bits)
            _write_kv(v_cache, v, cols, v_scale, drop_overflow=S > 1, bits=bits)
            if T == 1 and causal and not gen:
                # serving's decode step: each stream attends to [0, lens[s]],
                # the band (lens, lens), through K2 or K2-int8
                o = decode_attention(q, *_decode_kv(k_cache, v_cache, bits), lens, (lens, lens),
                                     k_scale=k_scale, v_scale=v_scale)
            else:
                if k_scale is not None:
                    k_cache = dequant_slice(k_cache, k_scale, x.dtype, bits)
                    v_cache = dequant_slice(v_cache, v_scale, x.dtype, bits)
                o = flash_block_attention(
                    q, k_cache, v_cache, lens, lens, causal,
                    q_valid_len=q_valid_len, kv_head_major=True, q_preproc=q_preproc,
                )
        else:
            if k_scale is not None:
                k_cache = dequant_slice(k_cache, k_scale, x.dtype, bits)
                v_cache = dequant_slice(v_cache, v_scale, x.dtype, bits)
            o = _attend_cache_and_block(q, k, v, k_cache, v_cache, lens, causal, q_valid_len,
                                        q_preproc)
        return self._proj("o_proj", o.reshape(S, T, H * D), gen, end_row)


class Qwen2MLP(nn.Module):
    def __init__(self, cfg: LLMConfig, device=None, dtype=None):
        super().__init__()
        C, I = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = linear(C, I, False, device, dtype)
        self.up_proj = linear(C, I, False, device, dtype)
        self.down_proj = linear(I, C, False, device, dtype)
        self.act = ACT2FN[cfg.hidden_act]
        self.act_is_silu = cfg.hidden_act == "silu"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fused, ftp = quant.fused_key(self, "gate_up_proj")
        if fused is not None:  # serving fusion
            gu = getattr(self, fused)(x)
            g, u = quant.deinterleave(gu, ftp, (gu.shape[-1] // 2,) * 2)
        else:
            g, u = self.gate_proj(x), self.up_proj(x)
        down = self.down_proj
        # a full-int8 / w4a8 down projection without an adapter, with silu: K3
        # forms silu(g) * u in fp32 and quantizes it per token in one pass. An
        # adapted down (a LoRALinear, not a QuantLinear) takes the product
        # rounded to x's dtype, as the JAX package's _mlp does ("lora_a" not
        # in down)
        if isinstance(down, QuantLinear) and down.act_quant and self.act_is_silu:
            if down.reduce_max is not None:  # a row-parallel shard: the whole row's scales
                xq, xs = silu_mul_quant_global(g, u, down.reduce_max)
            else:
                xq, xs = silu_mul_quant_autograd(g, u)
            return quant.quantized_linear_preq(xq, xs, down, x.dtype)
        return down(self.act(g) * u)


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
        #: a rank's layer of a tensor-parallel mesh (parallel.mesh.attach_mesh): its
        #: attention and MLP outputs are partial sums over "model"
        self.mesh = None

    def forward(self, x, cos, sin, kv_layer, lens, causal, q_valid_len, decode_cols,
                gen=False, end_row=None, update_cache=True):
        cfg = self.cfg
        gen_mot = gen and cfg.mot_attention
        gen_moe = gen and cfg.use_moe
        h = _mot_rows(
            x, self.input_layernorm, lambda t: self.input_layernorm_moe_gen(t), gen_mot, end_row
        )
        a = self.self_attn(
            h, cos, sin, kv_layer, lens, causal, q_valid_len, decode_cols,
            gen_mot, end_row, update_cache,
        )
        if self.mesh is not None:  # the row-parallel o_proj's sum (Megatron)
            self.mesh.all_reduce(a, "model")
        x = x + a
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
        if self.mesh is not None:  # the row-parallel down_proj's sum
            self.mesh.all_reduce(h, "model")
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
        ``gen_end_row`` (a host int or a 0-dim device tensor, for a
        trailing-padded block) or T - 1.
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
            x = layer(x, cos, sin, cache.layer(i), cache.lens, causal,
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
        return h, dataclasses.replace(cache, lens=lens)


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
    ``out_dtype``), so the [V, C] weight is read once and never widened. A
    quantized head (always int8): mode ``qa`` quantizes the hidden per token
    and multiplies in integers; mode ``q`` widens the int8 weight to the
    hidden's dtype. Either keeps the logits fp32. Every head is
    differentiable in the hidden (the training loss goes through it; a
    quantized head under QLoRA): ``qa`` through the activation scale, ``q``
    through ``quant.WidenedMatmul``.

    A rank's model of a mesh (``parallel.mesh.place_params``) holds a vocab
    slice of the head: its logits are gathered over "model" (a sum into a
    zeroed [rows, V] buffer), so every rank has the whole row. Under autograd
    the hidden enters through ``parallel.mesh.copy_in`` (each rank's part of
    its gradient comes from its vocab slice) and the gather is
    ``parallel.mesh.gather_model`` (the backward takes the rank's slice)."""
    mesh = getattr(lm, "mesh", None)
    logits = _lm_head_local(lm, pmesh.copy_in(hidden, mesh))
    if mesh is None:
        return logits
    return pmesh.gather_model(logits, mesh, dim=-1)


def _lm_head_local(lm: Qwen2MoTForCausalLM, hidden: torch.Tensor) -> torch.Tensor:
    """:func:`lm_head` over the rows this module holds."""
    head = lm.lm_head
    h2 = hidden.reshape(-1, hidden.shape[-1])
    if isinstance(head, QuantLinear):
        if head.packed:
            raise ValueError("the lm_head is int8 in every quantized mode, not packed int4")
        if head.act_quant:
            hq, hs = quant.quantize_activations(h2)
            logits = quant.int_mm(hq, head.weight_q).float() * (hs * head.scale)
        else:
            logits = quant.widened_matmul(h2, head.weight_q, head.scale)
        return logits.reshape(*hidden.shape[:-1], head.out_features)
    w = pmesh.fsdp_weight(head)
    if hidden.dtype != torch.float32 and not hidden.is_cuda:
        raise ValueError("low-precision lm_head runs on CUDA tensors only")
    logits = _MatmulF32Out.apply(h2, w.to(hidden.dtype))
    return logits.reshape(*hidden.shape[:-1], w.shape[0])


class _MatmulF32Out(torch.autograd.Function):
    """``quant.mm_f32`` (x [m, K] @ w [N, K]^T, fp32 sums and output) under
    autograd, for the training loss: the cotangent is fp32 [m, N] and is
    rounded to the operands' dtype for the two backward products, as a
    low-precision linear's backward rounds it."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return quant.mm_f32(x2, w)

    @staticmethod
    def backward(ctx, grad):
        x2, w = ctx.saved_tensors
        g = grad.to(x2.dtype)
        dx = g @ w if ctx.needs_input_grad[0] else None
        dw = g.t() @ x2 if ctx.needs_input_grad[1] else None
        return dx, dw


# ---------------------------------------------------------------------------
# training forward (packed flat sequence, index-routed MoT)
# ---------------------------------------------------------------------------

class Rows(NamedTuple):
    """One expert's rows of a packed [T, ...] sequence: ``read`` the rows
    gathered, ``write`` where their results go. A padding slot of a padded
    list (index T, ``pack_training_batch``'s) reads row T - 1 and writes the
    sink row T, which is dropped: the JAX package's gather with fill and
    scatter with ``mode="drop"``, without an out-of-range index (on the card
    a device-side assert). A list without padding slots reads and writes its
    own rows."""

    read: torch.Tensor
    write: torch.Tensor


def route_rows(idx: torch.Tensor, T: int) -> Rows:
    return Rows(idx.clamp(max=T - 1), idx)


def _route(
    x: torch.Tensor,
    und: Rows,
    gen: Rows,
    und_fn,
    gen_fn,
    out_shape_tail: Tuple[int, ...],
    freeze_und: bool = False,
) -> torch.Tensor:
    """Index-routed dual-expert application over a packed [T, ...] sequence
    (the reference's boolean-index writes, qwen2_navit.py:435-446, 820-835):
    ``und_fn`` on the rows ``und``, ``gen_fn`` on the rows ``gen``
    (:class:`Rows`), written back to packed order; rows in neither set
    (trailing padding) are zero. A padding slot's row is computed on row
    T - 1 and dropped: each row's result depends on that row alone, so the
    real rows are the unpadded lists' and the dropped ones carry no gradient.
    With ``freeze_und`` the understanding rows carry no gradient."""
    T = x.shape[0]
    yu = und_fn(x.index_select(0, und.read))
    if freeze_und:
        yu = yu.detach()
    yg = gen_fn(x.index_select(0, gen.read))
    out = torch.zeros((T + 1, *out_shape_tail), dtype=yg.dtype, device=x.device)
    out.index_copy_(0, und.write, yu.to(yg.dtype))
    out.index_copy_(0, gen.write, yg)
    return out[:T]


def make_train_layer_body(
    cfg: LLMConfig,
    position_ids: torch.Tensor,  # [T]
    mask: Optional[torch.Tensor],  # [T, T] bool; unused when ``segments`` is given
    und_idx: torch.Tensor,
    gen_idx: torch.Tensor,
    segments=None,
):
    """The per-layer training body ``body(x, layer) -> x`` closed over one
    packed sequence's routing and mask state; ``layer`` is a
    ``Qwen2MoTDecoderLayer``. On a rank of a mesh (``layer.mesh``, set by
    ``parallel.mesh.attach_mesh``; ``cfg`` the rank's geometry) the body is
    Megatron's: the norms' outputs enter each expert's column-parallel
    projections through ``parallel.mesh.copy_in``, and the outputs of o and
    down leave through ``parallel.mesh.reduce_out``; under FSDP the layer's
    shards are gathered over "data" for the body's span
    (``parallel.mesh.whole_leaves``)."""
    T = position_ids.shape[0]
    C = cfg.hidden_size
    H, Hk, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    fz = cfg.freeze_und
    cos, sin = rope_cos_sin(position_ids, cfg.head_dim, cfg.rope_theta)
    if segments is None and mask is None:
        raise ValueError("the training forward needs the segment ids or a dense mask")
    und, gen = route_rows(und_idx, T), route_rows(gen_idx, T)

    def route(x, und_fn, gen_fn, tail, freeze=False):
        return _route(x, und, gen, und_fn, gen_fn, tail, freeze)

    def body(x, layer):
        # FSDP: the layer's whole leaves, gathered here (inside the checkpoint of cfg.remat,
        # so the recompute gathers again) and dropped at the end
        with pmesh.whole_leaves(layer):
            return layer_body(x, layer, getattr(layer, "mesh", None))

    def layer_body(x, layer, mesh):
        # on a rank of a "model" axis: copy_in in front of each expert's column-parallel
        # q k v and gate up, reduce_out after o and after down (Megatron's f and g)
        ap = layer.self_attn
        residual = x
        if cfg.mot_attention:
            h = route(x, layer.input_layernorm, layer.input_layernorm_moe_gen, (C,))
            h = pmesh.copy_in(h, mesh)
            q = route(h, ap.q_proj, ap.q_proj_moe_gen, (H * D,))
            k = route(h, ap.k_proj, ap.k_proj_moe_gen, (Hk * D,))
            v = route(h, ap.v_proj, ap.v_proj_moe_gen, (Hk * D,), freeze=fz)
        else:
            h = pmesh.copy_in(layer.input_layernorm(x), mesh)
            q, k, v = ap.q_proj(h), ap.k_proj(h), ap.v_proj(h)
        q = q.reshape(T, H, D)
        k = k.reshape(T, Hk, D)
        v = v.reshape(T, Hk, D)
        if cfg.qk_norm:
            if cfg.mot_attention:
                q = route(q, ap.q_norm, ap.q_norm_moe_gen, (H, D), freeze=fz)
                k = route(k, ap.k_norm, ap.k_norm_moe_gen, (Hk, D), freeze=fz)
            else:
                q, k = ap.q_norm(q), ap.k_norm(k)
        q, k = apply_rope(q, k, cos, sin)
        if segments is not None:
            o = packed_train_attention(q, k, v, *segments).reshape(T, H * D)
        else:
            o = gqa_attention(q[None], k[None], v[None], mask[None])[0].reshape(T, H * D)
        if cfg.mot_attention:
            o = route(o, ap.o_proj, ap.o_proj_moe_gen, (C,), freeze=fz)
        else:
            o = ap.o_proj(o)
        x = residual + pmesh.reduce_out(o, mesh)

        residual = x
        if cfg.mot_attention:
            h = route(
                x, lambda t: layer.mlp(pmesh.copy_in(layer.post_attention_layernorm(t), mesh)),
                lambda t: layer.mlp_moe_gen(
                    pmesh.copy_in(layer.post_attention_layernorm_moe_gen(t), mesh)),
                (C,), freeze=fz,
            )
        elif cfg.use_moe:  # one post norm, routed MLP (qwen2_navit.py:946-955)
            h = route(pmesh.copy_in(layer.post_attention_layernorm(x), mesh), layer.mlp,
                      layer.mlp_moe_gen, (C,), freeze=fz)
        else:
            h = layer.mlp(pmesh.copy_in(layer.post_attention_layernorm(x), mesh))
        return residual + pmesh.reduce_out(h, mesh)

    return body


def forward_train(
    model: Qwen2MoTModel,
    packed_x: torch.Tensor,  # [T, C] embedded packed sequence
    position_ids: torch.Tensor,  # [T]
    mask: Optional[torch.Tensor],  # [T, T] bool (ops.blockmask.dense_packed_mask) or None
    und_idx: torch.Tensor,  # [Nu] int64; padding slots (index T) allowed
    gen_idx: torch.Tensor,  # [Ng] int64; padding slots allowed
    segments=None,  # (doc_id, fn_id, noise_id) [T] int tensors
    feature_layer: Optional[int] = None,
):
    """Packed training forward (reference Qwen2Model.forward_train,
    qwen2_navit.py:1051-1113). Returns the final dual-normed hidden [T, C];
    with ``feature_layer`` set, (hidden, the hidden after that layer): the
    diffusion_feature_layer tap (qwen2_navit.py:1083-1097).

    With ``segments`` every layer's attention goes through
    ``packed_train_attention`` (the kernels on the card, the dense plain
    version on the CPU) and ``mask`` may be None; without, through the dense
    ``mask``. ``cfg.remat`` recomputes each layer in the backward pass
    (non-reentrant checkpointing), so one layer's activations are live at a
    time and the layer's forward, its attention kernel included, runs twice."""
    cfg = model.cfg
    body = make_train_layer_body(cfg, position_ids, mask, und_idx, gen_idx, segments=segments)
    if cfg.freeze_und:  # the understanding rows enter detached
        packed_x = detach_rows(packed_x, und_idx)
    remat = cfg.remat and torch.is_grad_enabled()
    h, features = packed_x, None
    for i, layer in enumerate(model.layers):
        if remat:
            h = checkpoint(body, h, layer, use_reentrant=False, preserve_rng_state=False)
        else:
            h = body(h, layer)
        if feature_layer is not None and i == feature_layer % len(model.layers):
            features = h
    h = final_norm(model, h, und_idx, gen_idx)
    if feature_layer is not None:
        return h, features
    return h


def detach_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x`` [T, ...] with the rows ``idx`` detached (no gradient flows into
    them); a padding slot of a padded list (index T) marks the sink."""
    T = x.shape[0]
    rows = torch.zeros(T + 1, dtype=torch.bool, device=x.device)
    rows = rows.index_fill_(0, idx, True)[:T].reshape(T, *([1] * (x.dim() - 1)))
    return torch.where(rows, x.detach(), x)


def final_norm(model: Qwen2MoTModel, h: torch.Tensor, und_idx, gen_idx) -> torch.Tensor:
    """Final RMS norm after the layer stack, per expert under ``use_moe``
    (reference qwen2_navit.py:1106-1113)."""
    cfg = model.cfg
    if cfg.use_moe:
        T = h.shape[0]
        return _route(h, route_rows(und_idx, T), route_rows(gen_idx, T), model.norm,
                      model.norm_moe_gen, (h.shape[-1],), freeze_und=cfg.freeze_und)
    return model.norm(h)
