"""Bagel unified model, understanding programs (port of
unimedvl_tpu/models/bagel.py): the ViT image prefill, the causal text prefill
and the greedy / sampled decode loop.

``Bagel`` holds every released weight under its released name: the Qwen2 MoT
LLM with both experts, the SigLIP ViT, the connector and the frozen ViT
position table, and the gen-side projections (``vae2llm``, ``llm2vae``,
``time_embedder``, ``latent_pos_embed``), which are loaded and held but not run
here: text-to-image is ROADMAP slice M7.

Packing contracts as in the JAX package: text blocks are [S, T] ids with
trailing padding, causal; an image block is [<vision_start>, vit tokens...,
<vision_end>] sharing one rope position, non-causal.

dtype note: the JAX package lets its fp32 patch tokens promote the ViT and the
image prefill to fp32 whatever the weights' dtype; the port casts the patch
tokens to the weights' dtype, so a bf16 model runs both in bf16 and its
attention goes through the bf16 kernels.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from unimedvl_tpu.config import BagelConfig
from unimedvl_tpu_torch.models import qwen2_mot as mot
from unimedvl_tpu_torch.models.layers import LayerNorm, PosEmbed, RMSNorm, linear
from unimedvl_tpu_torch.models.qwen2_mot import KVCache, Qwen2MoTForCausalLM
from unimedvl_tpu_torch.models.siglip import SiglipVisionModel
from unimedvl_tpu_torch.ops.activations import ACT2FN
from unimedvl_tpu_torch.ops.sincos import get_2d_sincos_pos_embed


class MLPConnector(nn.Module):
    def __init__(self, cin: int, cout: int, device=None, dtype=None):
        super().__init__()
        self.fc1 = linear(cin, cout, True, device, dtype)
        self.fc2 = linear(cout, cout, True, device, dtype)


class TimestepEmbedder(nn.Module):
    """Held for the gen slice; released names ``time_embedder.mlp.{0,2}``."""

    def __init__(self, dim: int, freq_dim: int = 256, device=None, dtype=None):
        super().__init__()
        self.mlp = nn.Sequential(
            linear(freq_dim, dim, True, device, dtype), nn.SiLU(),
            linear(dim, dim, True, device, dtype),
        )


class Bagel(nn.Module):
    """All released weights of the unified model, inference only.

    ``device="meta"`` builds the structure without memory; ``to_empty`` and
    :func:`init_random_` (or a loader) then fill it.
    """

    def __init__(self, cfg: BagelConfig, device=None, dtype=None):
        super().__init__()
        self.config = cfg
        C = cfg.llm.hidden_size
        self.language_model = Qwen2MoTForCausalLM(cfg.llm, device, dtype)
        if cfg.visual_und and cfg.vit is not None:
            self.vit_model = SiglipVisionModel(cfg.vit, device, dtype)
            self.connector = MLPConnector(cfg.vit.hidden_size, C, device, dtype)
            self.vit_pos_embed = PosEmbed(cfg.vit_max_num_patch_per_side**2, C, device, dtype)
        if cfg.visual_gen and cfg.vae is not None:
            pd = cfg.patch_latent_dim
            self.vae2llm = linear(pd, C, True, device, dtype)
            self.llm2vae = linear(C, pd, True, device, dtype)
            self.time_embedder = TimestepEmbedder(C, device=device, dtype=dtype)
            self.latent_pos_embed = PosEmbed(cfg.max_latent_size**2, C, device, dtype)
        self.requires_grad_(False)


@torch.no_grad()
def init_random_(model: Bagel, generator: torch.Generator) -> Bagel:
    """Fill every weight from ``generator`` the way the JAX package's
    ``init_params`` does: linears uniform in +-1/sqrt(fan_in) with zero bias,
    embeddings and lm_head normal * 0.02, norm gains 1 and biases 0, the
    position tables sin-cos, ``llm2vae`` zero."""
    cfg = model.config
    for name, mod in model.named_modules():
        if isinstance(mod, nn.Linear):
            if name == "language_model.lm_head":
                mod.weight.normal_(0.0, 0.02, generator=generator)
            else:
                bound = 1.0 / math.sqrt(mod.in_features)
                mod.weight.uniform_(-bound, bound, generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, 0.02, generator=generator)
        elif isinstance(mod, (RMSNorm, LayerNorm)):
            mod.weight.fill_(1.0)
            if isinstance(mod, LayerNorm):
                mod.bias.zero_()
    C = cfg.llm.hidden_size
    if hasattr(model, "vit_pos_embed"):
        model.vit_pos_embed.pos_embed.copy_(
            torch.from_numpy(get_2d_sincos_pos_embed(C, cfg.vit_max_num_patch_per_side))
        )
    if hasattr(model, "latent_pos_embed"):
        model.latent_pos_embed.pos_embed.copy_(
            torch.from_numpy(get_2d_sincos_pos_embed(C, cfg.max_latent_size))
        )
        model.llm2vae.weight.zero_()
        model.llm2vae.bias.zero_()
    return model


def connector(model: Bagel, x: torch.Tensor) -> torch.Tensor:
    """MLPconnector (modeling_utils.py:112-123)."""
    c = model.connector
    return c.fc2(ACT2FN[model.config.connector_act](c.fc1(x)))


@torch.no_grad()
def encode_vit_tokens(
    model: Bagel,
    patch_tokens: torch.Tensor,  # [N, Tv, p*p*3]
    vit_pos_ids: torch.Tensor,  # [N, Tv]
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """ViT encode + connector + frozen 2D position add; [N, Tv, C]. The patch
    tokens are cast to the weights' dtype (see the module's dtype note)."""
    w = model.vit_model.vision_model.embeddings.patch_embedding.weight
    h = model.vit_model(patch_tokens.to(w.dtype), vit_pos_ids, valid)
    h = connector(model, h)
    return h + model.vit_pos_embed.pos_embed.to(h.dtype)[vit_pos_ids]


def preprocess_vit_image(cfg: BagelConfig, image_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [H, W, 3] -> normalized fp32 patch tokens [1, Tv, p*p*3] on the
    image's device (mean = std = 0.5; patchify in hwpqc order)."""
    x = image_u8.float() / 255.0
    x = (x - 0.5) / 0.5
    H, W, C = x.shape
    p = cfg.vit.patch_size
    x = x.reshape(H // p, p, W // p, p, C).permute(0, 2, 1, 3, 4)
    return x.reshape(1, (H // p) * (W // p), p * p * C)


def vit_token_bucket(n: int) -> int:
    """Token-count bucket for image prefill: fine steps for small images,
    512-steps beyond (the JAX package's ladder, kept so both pad alike)."""
    for b in (16, 32, 64, 128, 256):
        if n <= b:
            return b
    return ((n + 511) // 512) * 512


@torch.no_grad()
def prefill_text(
    model: Bagel,
    cache: KVCache,
    token_ids: torch.Tensor,  # [S, T] trailing padding
    positions: torch.Tensor,  # [S, T]
    valid: torch.Tensor,  # [S, T] bool
) -> KVCache:
    """Causal text prefill (bagel.py:412-458)."""
    lm = model.language_model
    x = mot.embed_tokens(lm, token_ids)
    _, cache = lm.model(x, positions, cache, causal=True, q_valid=valid)
    return cache


@torch.no_grad()
def prefill_vit_bucketed(
    model: Bagel,
    cache: KVCache,
    patch_tokens: torch.Tensor,  # [1, Tb, p*p*3] padded to a bucket
    vit_pos_ids: torch.Tensor,  # [1, Tb]
    n_tokens: int,  # actual patch count (<= Tb)
    start_end_ids: torch.Tensor,  # [2] (<vision_start>, <vision_end>)
    rope_pos: int,
) -> KVCache:
    """ViT image prefill, non-causal (bagel.py:523-615), over a padded bucket:
    <vision_end> sits at row n + 1 and rows >= n + 2 are masked (their cache
    columns are overwritten by the next append)."""
    lm = model.language_model
    Tb = patch_tokens.shape[1]
    T = Tb + 2
    device = patch_tokens.device
    vit_valid = (torch.arange(Tb, device=device) < n_tokens)[None]
    vit_embed = encode_vit_tokens(model, patch_tokens, vit_pos_ids, vit_valid)
    se = mot.embed_tokens(lm, start_end_ids).to(vit_embed.dtype)
    x = torch.zeros(1, T, vit_embed.shape[-1], dtype=vit_embed.dtype, device=device)
    x[0, 0] = se[0]
    x[0, 1:Tb + 1] = vit_embed[0]
    x[0, n_tokens + 1] = se[1]
    q_valid = (torch.arange(T, device=device) < n_tokens + 2)[None]
    positions = torch.full((1, T), rope_pos, dtype=torch.int64, device=device)
    _, cache = lm.model(x, positions, cache, causal=False, q_valid=q_valid)
    return cache


@torch.no_grad()
def generate_text(
    model: Bagel,
    cache: KVCache,
    start_tokens: torch.Tensor,  # [S]
    positions: torch.Tensor,  # [S] rope position of the start token
    max_length: int,
    eos_id: int,
    do_sample: bool = False,
    temperature: float = 1.0,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Autoregressive decode (bagel.py:1259-1314) as a Python loop with one
    eos check per step.

    Step d writes its kv at column base + d with base = max(lens) for every
    stream (the JAX package's aligned-column decode); lens do not advance, so
    the caller's context is unaffected. The caller guarantees capacity for
    base + max_length columns.

    Returns (tokens [S, max_length] int32 — starting with the start token,
    excluding eos, padded with -1; lengths [S]).
    """
    lm = model.language_model
    S = start_tokens.shape[0]
    device = start_tokens.device
    out = torch.full((S, max_length), -1, dtype=torch.int32, device=device)
    base = cache.lens.max()
    done = torch.zeros(S, dtype=torch.bool, device=device)
    cur = start_tokens.to(torch.int32)
    pos = positions.to(torch.int64)
    for step in range(max_length):
        out[:, step] = torch.where(done, -1, cur)
        x = mot.embed_tokens(lm, cur)[:, None, :]
        h, cache = lm.model(
            x, pos[:, None], cache, causal=True, decode_cols=(base, base + step)
        )
        logits = mot.lm_head(lm, h[:, 0])  # [S, V] fp32
        if do_sample:
            probs = torch.softmax(logits / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        cur = nxt.to(torch.int32)
        done = done | (cur == eos_id)
        pos = pos + 1
        if bool(done.all()):
            break
    lengths = (out >= 0).sum(dim=1)
    return out, lengths
