"""SigLIP NaViT vision encoder (port of unimedvl_tpu/models/siglip.py).

Images are batched as [N, T_pad, patch_dim] with trailing padding and a
validity mask. Module and parameter names follow the released checkpoint
(``vit_model.vision_model...``) so weights load by name; the patch embedding
is held in its converted linear form [C, p*p*3].

Attention goes through K1a (ops/flash_attention.py) at every token count: the
padding is trailing, so the mask is ``key < valid_len`` with the block region
disabled by ``block_start = T``. Padded rows of the output are garbage;
callers mask them.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from unimedvl_tpu.config import ViTConfig
from unimedvl_tpu_torch.models.layers import LayerNorm, embedding, linear
from unimedvl_tpu_torch.ops.activations import ACT2FN
from unimedvl_tpu_torch.ops.flash_attention import flash_block_attention


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

    def forward(self, x: torch.Tensor, valid_lens: torch.Tensor) -> torch.Tensor:
        """x: [N, T, C]; valid_lens: [N] count of leading valid tokens."""
        N, T, C = x.shape
        H, D = self.cfg.num_attention_heads, self.cfg.head_dim
        attn = self.self_attn
        h = self.layer_norm1(x)
        q = attn.q_proj(h).view(N, T, H, D)
        k = attn.k_proj(h).view(N, T, H, D)
        v = attn.v_proj(h).view(N, T, H, D)
        o = flash_block_attention(q, k, v, valid_lens, T, causal=False)
        x = x + attn.out_proj(o.reshape(N, T, C))
        h = self.mlp.fc2(ACT2FN[self.cfg.hidden_act](self.mlp.fc1(self.layer_norm2(x))))
        return x + h


class SiglipEmbeddings(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None, dtype=None):
        super().__init__()
        patch_dim = cfg.num_channels * cfg.patch_size**2
        self.patch_embedding = linear(patch_dim, cfg.hidden_size, True, device, dtype)
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
        if cfg.rope:
            raise NotImplementedError(
                "the 2D ViT rope is not ported (released checkpoints force rope=False)"
            )
        self.cfg = cfg
        self.embeddings = SiglipEmbeddings(cfg, device, dtype)
        self.encoder = SiglipEncoder(cfg, device, dtype)
        self.post_layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device, dtype)

    def forward(
        self,
        patch_tokens: torch.Tensor,
        position_ids: torch.Tensor,
        valid: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """patch_tokens [N, T, p*p*3], position_ids [N, T] flattened raster ids,
        valid bool [N, T] (None = all valid). Returns [N, T, hidden]."""
        N, T, _ = patch_tokens.shape
        x = self.embeddings.patch_embedding(patch_tokens)
        x = x + self.embeddings.position_embedding(position_ids).to(x.dtype)
        if valid is None:
            valid_lens = torch.full((N,), T, dtype=torch.int32, device=x.device)
        else:  # trailing-padding contract: the valid count is the prefix length
            valid_lens = valid.sum(dim=1, dtype=torch.int32)
        for layer in self.encoder.layers:
            x = layer(x, valid_lens)
        return self.post_layernorm(x)


class SiglipVisionModel(nn.Module):
    """Holder that gives the released name prefix ``vision_model``."""

    def __init__(self, cfg: ViTConfig, device=None, dtype=None):
        super().__init__()
        self.vision_model = SiglipVisionTransformer(cfg, device, dtype)

    def forward(self, *args, **kwargs) -> torch.Tensor:
        return self.vision_model(*args, **kwargs)
