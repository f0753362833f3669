"""SigLIP NaViT vision encoder (port of unimedvl_tpu/models/siglip.py).

Images are batched as [N, T_pad, patch_dim] with trailing padding and a
validity mask. Module and parameter names follow the released checkpoint
(``vit_model.vision_model...``) so weights load by name; the patch embedding
is held in its converted linear form [C, p*p*3].

With ``cfg.rope`` (the 2D rope of siglip_navit.py; released checkpoints
ship without it) the position table is left out and q and k are rotated by
the 2D tables before attention, as the JAX package rotates them.

Attention goes through K1a (ops/flash_attention.py) at every token count: the
padding is trailing, so the mask is ``key < valid_len`` with the block region
disabled by ``block_start = T``. Padded rows of the output are garbage;
callers mask them. K1a has no backward kernel, so a caller that trains the
ViT asks for ``dense_attention=True``: plain masked attention
(``ops.attention.gqa_attention`` with the padding mask, as the JAX package
differentiates its ViT), which autograd differentiates.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from unimedvl_tpu_torch.config import ViTConfig
from unimedvl_tpu_torch.models.layers import LayerNorm, embedding, linear
from unimedvl_tpu_torch.ops.activations import ACT2FN
from unimedvl_tpu_torch.ops.attention import gqa_attention, padding_mask
from unimedvl_tpu_torch.ops.flash_attention import flash_block_attention
from unimedvl_tpu_torch.ops.rope import _rotate_half, rope_2d_tables


def _apply_rope_2d(q, k, rope_tables, position_ids):
    """2D ViT rope (siglip_navit.py:224-230): the h tables rotate the first
    half of each head, the w tables the second half. q, k [N, T, H, D];
    position_ids [N, T] flattened raster ids."""
    cos_h, sin_h, cos_w, sin_w = rope_tables
    half = q.shape[-1] // 2

    def rot(x, cos, sin):
        c = cos[position_ids][:, :, None, :].to(x.dtype)
        s = sin[position_ids][:, :, None, :].to(x.dtype)
        return x * c + _rotate_half(x) * s

    return tuple(torch.cat([rot(x[..., :half], cos_h, sin_h), rot(x[..., half:], cos_w, sin_w)],
                           dim=-1) for x in (q, k))


class SiglipAttention(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None, dtype=None):
        super().__init__()
        C = cfg.hidden_size
        self.q_proj = linear(C, C, True, device, dtype)
        self.k_proj = linear(C, C, True, device, dtype)
        self.v_proj = linear(C, C, True, device, dtype)
        self.out_proj = linear(C, C, True, device, dtype)


class SiglipMLP(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None, dtype=None):
        super().__init__()
        self.fc1 = linear(cfg.hidden_size, cfg.intermediate_size, True, device, dtype)
        self.fc2 = linear(cfg.intermediate_size, cfg.hidden_size, True, device, dtype)


class SiglipEncoderLayer(nn.Module):
    """One SiglipEncoderLayer (siglip_navit.py:262-300)."""

    def __init__(self, cfg: ViTConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        C, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.layer_norm1 = LayerNorm(C, eps, device, dtype)
        self.self_attn = SiglipAttention(cfg, device, dtype)
        self.layer_norm2 = LayerNorm(C, eps, device, dtype)
        self.mlp = SiglipMLP(cfg, device, dtype)

    def forward(self, x: torch.Tensor, valid_lens: torch.Tensor,
                dense_mask: Optional[torch.Tensor] = None, rope_tables=None,
                position_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: [N, T, C]; valid_lens: [N] count of leading valid tokens;
        ``dense_mask``: bool [N, T, T], given when the caller wants plain
        differentiable attention instead of K1a; ``rope_tables`` and
        ``position_ids`` [N, T]: the 2D rope of q and k."""
        N, T, C = x.shape
        H, D = self.cfg.num_attention_heads, self.cfg.head_dim
        attn = self.self_attn
        h = self.layer_norm1(x)
        q = attn.q_proj(h).view(N, T, H, D)
        k = attn.k_proj(h).view(N, T, H, D)
        v = attn.v_proj(h).view(N, T, H, D)
        if rope_tables is not None:
            q, k = _apply_rope_2d(q, k, rope_tables, position_ids)
        if dense_mask is None:
            o = flash_block_attention(q, k, v, valid_lens, T, causal=False)
        else:
            o = gqa_attention(q, k, v, dense_mask)
        x = x + attn.out_proj(o.reshape(N, T, C))
        h = self.mlp.fc2(ACT2FN[self.cfg.hidden_act](self.mlp.fc1(self.layer_norm2(x))))
        return x + h


class SiglipEmbeddings(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None, dtype=None):
        super().__init__()
        patch_dim = cfg.num_channels * cfg.patch_size**2
        self.patch_embedding = linear(patch_dim, cfg.hidden_size, True, device, dtype)
        if not cfg.rope:
            self.position_embedding = embedding(
                cfg.num_patches_per_side**2, cfg.hidden_size, device, dtype
            )


class SiglipEncoder(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None, dtype=None):
        super().__init__()
        self.layers = nn.ModuleList(
            SiglipEncoderLayer(cfg, device, dtype) for _ in range(cfg.num_hidden_layers)
        )


class SiglipVisionTransformer(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.embeddings = SiglipEmbeddings(cfg, device, dtype)
        self.encoder = SiglipEncoder(cfg, device, dtype)
        self.post_layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device, dtype)

    def forward(
        self,
        patch_tokens: torch.Tensor,
        position_ids: torch.Tensor,
        valid: Optional[torch.Tensor] = None,
        dense_attention: bool = False,
    ) -> torch.Tensor:
        """patch_tokens [N, T, p*p*3], position_ids [N, T] flattened raster ids,
        valid bool [N, T] (None = all valid). Returns [N, T, hidden].
        ``dense_attention``: plain masked attention that autograd
        differentiates (a trainable ViT) instead of K1a."""
        N, T, _ = patch_tokens.shape
        x = self.embeddings.patch_embedding(patch_tokens)
        rope_tables = None
        if self.cfg.rope:
            side = self.cfg.num_patches_per_side
            rope_tables = rope_2d_tables(self.cfg.head_dim // 2, side, side, device=x.device)
        else:
            x = x + self.embeddings.position_embedding(position_ids).to(x.dtype)
        if valid is None:
            valid_lens = torch.full((N,), T, dtype=torch.int32, device=x.device)
        else:  # trailing-padding contract: the valid count is the prefix length
            valid_lens = valid.sum(dim=1, dtype=torch.int32)
        dense_mask = None
        if dense_attention:
            if valid is None:
                valid = torch.ones((N, T), dtype=torch.bool, device=x.device)
            dense_mask = padding_mask(valid, valid)
        for layer in self.encoder.layers:
            x = layer(x, valid_lens, dense_mask, rope_tables, position_ids)
        return self.post_layernorm(x)


class SiglipVisionModel(nn.Module):
    """Holder that gives the released name prefix ``vision_model``."""

    def __init__(self, cfg: ViTConfig, device=None, dtype=None):
        super().__init__()
        self.vision_model = SiglipVisionTransformer(cfg, device, dtype)

    def forward(self, *args, **kwargs) -> torch.Tensor:
        return self.vision_model(*args, **kwargs)
