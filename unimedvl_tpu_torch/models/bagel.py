"""Bagel unified model (port of unimedvl_tpu/models/bagel.py): the
understanding programs (the ViT image prefill, the causal text prefill, the
greedy / sampled decode loops: the aligned-column decode, the
contiguous-cache decode that keeps its answer in the cache, and the
prompt-lookup speculative decode, greedy-exact against the latter) and the
generation programs (the VAE image prefill, the rectified-flow loop with
batched CFG, the VAE decode). On a CUDA device each prefill and loop runs as
a captured device program (:class:`PrefillProgram`, :class:`DecodeProgram`,
:class:`SpecProgram`, :class:`FlowProgram`; ``inference/programs.py``), its
eager function the plain version (``graphs=False``).

``Bagel`` holds every released weight under its released name: the Qwen2 MoT
LLM with both experts, the SigLIP ViT, the connector and the frozen ViT
position table, the gen-side projections (``vae2llm``, ``llm2vae``,
``time_embedder``, ``latent_pos_embed``) and, when built ``with_vae``, the
FLUX VAE as ``vae_model`` (shipped apart, as ``ae.safetensors``). With
``cfg.e2e`` it also holds the REPA projections ``repa_proj`` (LLM hidden ->
teacher width) and ``repa_vae_proj`` (latent tokens -> teacher width), which
no released checkpoint carries.

Packing contracts as in the JAX package: text blocks are [S, T] ids with
trailing padding, causal; an image block is [<vision_start>, tokens...,
<vision_end>] sharing one rope position, non-causal; ViT images run through
the und expert, VAE latents through the gen expert.

dtype notes. The JAX package lets its fp32 patch tokens and VAE latents
promote the ViT and the image prefills to fp32 whatever the weights' dtype;
the port casts them to the weights' dtype, so a bf16 model runs both in bf16
and its attention goes through the bf16 kernels (the training forward's ViT
too). The flow loop keeps the JAX
package's mixed dtypes: the state x_t is fp32 throughout, ``vae2llm`` and the
timestep embedding run in fp32 (their weights widened, not x_t rounded), the
sum is rounded to the model dtype once, the velocity comes out of ``llm2vae``
in the model dtype, and the CFG combination and the update are fp32. The VAE
is held and runs in fp32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from unimedvl_tpu_torch.config import BagelConfig
from unimedvl_tpu_torch.data.packing import strip_padding
from unimedvl_tpu_torch.models import qwen2_mot as mot
from unimedvl_tpu_torch.models.layers import LayerNorm, PosEmbed, RMSNorm, linear
from unimedvl_tpu_torch.models.qwen2_mot import KVCache, Qwen2MoTForCausalLM
from unimedvl_tpu_torch.models.siglip import SiglipVisionModel
from unimedvl_tpu_torch.models.vae import AutoEncoder, GroupNorm
from unimedvl_tpu_torch.ops.activations import ACT2FN, silu
from unimedvl_tpu_torch.ops.sincos import get_2d_sincos_pos_embed, timestep_embedding
from unimedvl_tpu_torch.parallel.mesh import stream_range
from unimedvl_tpu_torch.training import e2e_vae


class MLPConnector(nn.Module):
    def __init__(self, cin: int, cout: int, device=None, dtype=None):
        super().__init__()
        self.fc1 = linear(cin, cout, True, device, dtype)
        self.fc2 = linear(cout, cout, True, device, dtype)


class TimestepEmbedder(nn.Module):
    """Released names ``time_embedder.mlp.{0,2}``; run by :func:`time_embed`."""

    def __init__(self, dim: int, freq_dim: int = 256, device=None, dtype=None):
        super().__init__()
        self.mlp = nn.Sequential(
            linear(freq_dim, dim, True, device, dtype), nn.SiLU(),
            linear(dim, dim, True, device, dtype),
        )


class Bagel(nn.Module):
    """All released weights of the unified model. Every parameter is created
    with ``requires_grad=False``; ``training.trainer`` and ``training.lora``
    switch on the ones they train.

    ``device="meta"`` builds the structure without memory; ``to_empty`` and
    :func:`init_random_` (or a loader) then fill it. ``with_vae`` adds the
    FLUX VAE as ``vae_model``, in fp32 whatever ``dtype`` is.
    """

    def __init__(self, cfg: BagelConfig, device=None, dtype=None, with_vae: bool = False):
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
            if with_vae:
                self.vae_model = AutoEncoder(cfg.vae, device)
        if cfg.e2e is not None:  # the REPA projections (training/e2e_vae.py), trained
            dt = cfg.e2e.teacher_feature_dim
            self.repa_proj = linear(C, dt, True, device, dtype)
            if cfg.visual_gen and cfg.vae is not None:
                self.repa_vae_proj = linear(cfg.patch_latent_dim, dt, True, device, dtype)
        self.requires_grad_(False)


@torch.no_grad()
def init_random_(model: Bagel, generator: torch.Generator, llm2vae_zero: bool = True) -> Bagel:
    """Fill every weight from ``generator`` the way the JAX package's
    ``init_params`` does: linears and convolutions uniform in
    +-1/sqrt(fan_in) with zero bias, embeddings and lm_head normal * 0.02,
    norm gains 1 and biases 0, the position tables sin-cos, ``llm2vae`` zero
    unless ``llm2vae_zero`` is False (then the velocity head is random too,
    and the flow loop moves its state)."""
    cfg = model.config
    for name, mod in model.named_modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            if name == "language_model.lm_head":
                mod.weight.normal_(0.0, 0.02, generator=generator)
            else:
                bound = 1.0 / math.sqrt(mod.weight[0].numel())  # fan_in
                mod.weight.uniform_(-bound, bound, generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, 0.02, generator=generator)
        elif isinstance(mod, (RMSNorm, LayerNorm, GroupNorm)):
            mod.weight.fill_(1.0)
            if not isinstance(mod, RMSNorm):
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
        if llm2vae_zero:  # bagel.py:156-159
            model.llm2vae.weight.zero_()
            model.llm2vae.bias.zero_()
    return model


def connector(model: Bagel, x: torch.Tensor) -> torch.Tensor:
    """MLPconnector (modeling_utils.py:112-123)."""
    c = model.connector
    return c.fc2(ACT2FN[model.config.connector_act](c.fc1(x)))


def _encode_vit_tokens(model, patch_tokens, vit_pos_ids, valid, dense_attention: bool):
    w = model.vit_model.vision_model.embeddings.patch_embedding.weight
    h = model.vit_model(patch_tokens.to(w.dtype), vit_pos_ids, valid,
                        dense_attention=dense_attention)
    h = connector(model, h)
    return h + model.vit_pos_embed.pos_embed.to(h.dtype)[vit_pos_ids]


@torch.no_grad()
def encode_vit_tokens(
    model: Bagel,
    patch_tokens: torch.Tensor,  # [N, Tv, p*p*3]
    vit_pos_ids: torch.Tensor,  # [N, Tv]
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """ViT encode + connector + 2D position add, without gradients;
    [N, Tv, C]. The patch tokens are cast to the weights' dtype (see the
    module's dtype note)."""
    return _encode_vit_tokens(model, patch_tokens, vit_pos_ids, valid, dense_attention=False)


def preprocess_vit_image(cfg: BagelConfig, image_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [H, W, 3] -> normalized fp32 patch tokens [1, Tv, p*p*3] on the
    image's device (mean = std = 0.5; patchify in hwpqc order)."""
    x = image_u8.float() / 255.0
    x = (x - 0.5) / 0.5
    H, W, C = x.shape
    p = cfg.vit.patch_size
    x = x.reshape(H // p, p, W // p, p, C).permute(0, 2, 1, 3, 4)
    return x.reshape(1, (H // p) * (W // p), p * p * C)


@torch.no_grad()
def prefill_vit(
    model: Bagel,
    cache: KVCache,
    patch_tokens: torch.Tensor,  # [1, Tv, p*p*3] exact shape
    vit_pos_ids: torch.Tensor,  # [1, Tv]
    start_end_ids: torch.Tensor,  # [2] (<vision_start>, <vision_end>)
    rope_pos: torch.Tensor,  # [1] shared position id
) -> KVCache:
    """ViT image prefill of one image at its exact token count, non-causal
    (bagel.py:523-615): [<vision_start>, tokens..., <vision_end>] at one rope
    position. :func:`prefill_vit_bucketed` is the same block padded to a
    bucket."""
    lm = model.language_model
    vit_embed = encode_vit_tokens(model, patch_tokens, vit_pos_ids)
    se = mot.embed_tokens(lm, start_end_ids).to(vit_embed.dtype)
    x = torch.cat([se[None, :1], vit_embed, se[None, 1:]], dim=1)
    _, cache = lm.model(x, rope_pos.to(torch.int64)[:, None], cache, causal=False)
    return cache


def vit_token_bucket(n: int) -> int:
    """Token-count bucket for image prefill: fine steps for small images,
    512-steps beyond (the JAX package's ladder, kept so both pad alike)."""
    for b in (16, 32, 64, 128, 256):
        if n <= b:
            return b
    return ((n + 511) // 512) * 512


def _prefill_text(model: Bagel, cache: KVCache, token_ids, positions, valid) -> KVCache:
    lm = model.language_model
    x = mot.embed_tokens(lm, token_ids)
    _, cache = lm.model(x, positions, cache, causal=True, q_valid=valid)
    return cache


@torch.no_grad()
def prefill_text(
    model: Bagel,
    cache: KVCache,
    token_ids: torch.Tensor,  # [S, T] trailing padding
    positions: torch.Tensor,  # [S, T]
    valid: torch.Tensor,  # [S, T] bool
    graphs: Optional[bool] = None,
    static: bool = True,
) -> KVCache:
    """Causal text prefill (bagel.py:412-458).

    ``graphs`` (``inference.programs.use_graphs``): by default, on a CUDA
    device, a :class:`PrefillProgram` keyed by S, T and the cache's shape,
    dtype and width: the ids, positions and mask copied into its buffers, the
    caller's cache into the programs' own of its shape and the columns made
    valid copied back; with ``static`` False over the caller's own arrays
    (the batcher's pool), keyed by their storage. ``graphs=False``: the eager
    forward, the program's plain version."""
    return _prefill("text", model, _prefill_text, (model.language_model,),
                    dict(token_ids=token_ids, positions=positions, valid=valid), cache, graphs,
                    "static" if static else "caller", dict(prefill=1), token_ids.shape[1])


def _prefill_vit_bucketed(model: Bagel, cache: KVCache, patch_tokens, vit_pos_ids, n_tokens,
                          start_end_ids, rope_pos) -> KVCache:
    return _prefill_vit_rows(model, cache, patch_tokens, vit_pos_ids, n_tokens.reshape(1),
                             start_end_ids, rope_pos.reshape(1))


@torch.no_grad()
def prefill_vit_bucketed(
    model: Bagel,
    cache: KVCache,
    patch_tokens: torch.Tensor,  # [1, Tb, p*p*3] padded to a bucket
    vit_pos_ids: torch.Tensor,  # [1, Tb]
    n_tokens,  # actual patch count (<= Tb): a host int or a 0-dim device tensor
    start_end_ids: torch.Tensor,  # [2] (<vision_start>, <vision_end>)
    rope_pos,  # a host int or a 0-dim device tensor
    graphs: Optional[bool] = None,
) -> KVCache:
    """ViT image prefill, non-causal (bagel.py:523-615), over a padded bucket:
    <vision_end> sits at row n + 1 (placed by ``torch.where`` on the row
    index) and rows >= n + 2 are masked (their cache columns are overwritten
    by the next append). ``n_tokens`` and ``rope_pos`` are device tensors
    within, as the JAX package traces them, so the program
    (:class:`PrefillProgram`, by default on a CUDA device; ``graphs`` as for
    :func:`prefill_text`: the ViT, the connector, the position add and the
    und prefill in one graph) captures once a bucket and capacity and serves
    every image of them."""
    return _prefill("vit", model, _prefill_vit_bucketed, _vit_modules(model),
                    dict(patch_tokens=patch_tokens, vit_pos_ids=vit_pos_ids, n_tokens=n_tokens,
                         start_end_ids=start_end_ids, rope_pos=rope_pos),
                    cache, graphs, "static", dict(vit=1, prefill=1), patch_tokens.shape[1] + 2)


def _prefill_vit_rows(model: Bagel, cache: KVCache, patch_tokens, vit_pos_ids, n_tokens,
                      start_end_ids, rope_pos) -> KVCache:
    """P images of one bucket, one a row, appended to ``cache`` at its lens:
    [<vision_start>, tokens..., <vision_end>] at row i's rope position, the
    end row placed by ``torch.where`` on the row index, rows past n_i + 2
    masked; n_i = 0 is an inactive row, whose lens do not advance."""
    lm = model.language_model
    P, Tb = patch_tokens.shape[:2]
    T = Tb + 2
    device = patch_tokens.device
    n = n_tokens.to(device=device, dtype=torch.int64)
    active = n > 0
    vit_valid = (torch.arange(Tb, device=device)[None] < n[:, None]) & active[:, None]
    vit_embed = encode_vit_tokens(model, patch_tokens, vit_pos_ids, vit_valid)
    se = mot.embed_tokens(lm, start_end_ids).to(vit_embed.dtype)
    # rows: 0 = start, 1..Tb = vit (garbage past n_i, masked), n_i + 1 = end
    x = F.pad(vit_embed, (0, 0, 1, 1))
    x[:, 0] = se[0]
    is_end = torch.arange(T, device=device)[None, :, None] == (n[:, None, None] + 1)
    x = torch.where(is_end, se[1], x)
    q_valid = (torch.arange(T, device=device)[None] < n[:, None] + 2) & active[:, None]
    positions = rope_pos.to(device=device, dtype=torch.int64)[:, None]
    _, cache = lm.model(x, positions, cache, causal=False, q_valid=q_valid)
    return cache


@torch.no_grad()
def prefill_vit_group(
    model: Bagel,
    patch_tokens: torch.Tensor,  # [P, Tb, p*p*3] padded to one shared bucket
    vit_pos_ids: torch.Tensor,  # [P, Tb]
    n_tokens: torch.Tensor,  # [P] int actual patch counts; 0 = inactive row
    start_end_ids: torch.Tensor,  # [2] (<vision_start>, <vision_end>)
    rope_pos: torch.Tensor,  # [P]
    kv_dtype: torch.dtype = torch.bfloat16,
    quantized: bool = False,
    capacity: Optional[int] = None,
    kv_bits: int = 8,
) -> KVCache:
    """P images of one bucket in one pass (bagel.py:196-249): the ViT over
    [P, Tb], the connector and the position add, then an und-mode
    non-causal forward into a fresh P-stream cache block of ``capacity``
    columns (default Tb + 2; more leaves room for the requests' text, which
    serving appends into the same block). Row i holds [<vision_start>,
    tokens..., <vision_end>] with lens n_i + 2, or lens 0 for an inactive
    row; the caller stores the block into its slot pool
    (``inference.serving.group_store``). The batcher's admission runs it,
    with the text append, as a program (``serving.image_text_block``)."""
    llm = model.config.llm
    P, Tb = patch_tokens.shape[:2]
    block = KVCache.create(
        llm.num_hidden_layers, P, Tb + 2 if capacity is None else capacity,
        llm.num_key_value_heads, llm.head_dim, kv_dtype, device=patch_tokens.device,
        quantized=quantized, kv_bits=kv_bits,
    )
    return _prefill_vit_rows(model, block, patch_tokens, vit_pos_ids, n_tokens, start_end_ids,
                             rope_pos)


def _vit_modules(model: Bagel) -> tuple:
    """The modules an image prefill reads: the LLM, the ViT, the connector
    and the ViT position table."""
    return (model.language_model, model.vit_model, model.connector, model.vit_pos_embed)


def _scalar(x, device: torch.device) -> torch.Tensor:
    """A host int as a 0-dim int64 tensor filled on ``device`` (no
    host-to-device copy); a tensor as it is."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.full((), int(x), dtype=torch.int64, device=device)


def _prefill(name: str, model: Bagel, fn, modules: tuple, inputs: dict, cache, graphs,
             storage: Optional[str], forwards: dict, width: int = 0, out=None, bake=(),
             block=None, family: Optional[str] = None):
    """``fn(model, cache, **inputs)`` by the route of ``graphs``
    (``inference.programs.use_graphs``): its :class:`PrefillProgram`, or
    the eager call, host ints among the inputs as 0-dim device tensors."""
    from unimedvl_tpu_torch.inference import programs

    device = next(v.device for v in inputs.values() if isinstance(v, torch.Tensor))
    if programs.use_graphs(graphs, device, model):
        prog = PrefillProgram.get(name, model, fn, modules, inputs, cache, storage, forwards,
                                  width, out, bake, block, family)
        return prog.run(cache, **inputs)
    if block is not None:
        cache = block()
    return fn(model, cache, **{k: _scalar(v, device) for k, v in inputs.items()})


class PrefillProgram:
    """A prefill as a device program (the JAX package jits each prefill per
    shape): one captured graph ("prefill") runs the eager function over
    static input buffers, into which every call copies its inputs (token
    ids, positions and masks, patch or latent tokens, the posterior noise;
    row counts, rope positions and <vision_end> rows as 0-dim tensors,
    filled), so one capture serves every input of its shapes: every image
    of a bucket. The cache it writes, by ``storage``:

    - "static": the programs' shared cache of the caller's shape, dtype and
      width (:func:`static_cache`, as :class:`DecodeProgram`'s). The caller's
      is copied in at every call and the columns the prefill made valid,
      [lens, new lens) of each stream, are copied back into the caller's
      storage, where the eager prefill writes them. A chat's context is new
      at every request and at every 512-column bucket it grows to
      (``InterleaveInferencer._ensure_capacity``): a program keyed by its
      storage would capture once a request, one keyed by its shape once.
    - "caller": the caller's own arrays (the batcher's pool, which persists
      across rounds), keyed by their storage; ``serving.repack_pool`` drops
      the program.
    - "block": a block cache of the program's own, made by ``block()``,
      which the function zeroes and fills (the batcher's admission blocks,
      which the eager route creates anew), returned; valid until the
      program's next call.
    - None: no cache (the VAE encode and decode); the result is a tensor of
      ``out = (shape, dtype)``, returned as a copy.

    The graph writes only where the eager function writes, and its warm-up
    writes the columns its replay then rewrites. Keyed by the flavour, the
    inputs' shapes and dtypes, the cache (its kind, or its storage for
    "caller"), what the function bakes in (``bake``) and the weights of
    ``modules``; a ``family`` bounds how many stay
    (``programs.FAMILY_LIMITS``)."""

    def __init__(self, model: Bagel, fn, inputs: dict, cache: Optional[KVCache],
                 storage: Optional[str], forwards: dict, width: int, out, block):
        from unimedvl_tpu_torch.inference import programs

        device = next(v.device for v in inputs.values() if isinstance(v, torch.Tensor))
        self._model = programs.model_ref(model)
        self.fn, self.storage, self.width = fn, storage, width
        self.inputs = {k: torch.zeros_like(v) if isinstance(v, torch.Tensor)
                       else torch.zeros((), dtype=torch.int64, device=device)
                       for k, v in inputs.items()}
        self.cache = static_cache(cache) if storage == "static" else (
            block() if storage == "block" else None)
        like = self.cache if self.cache is not None else cache
        self.lens = None if like is None else torch.zeros_like(like.lens)
        self.new_lens = None if like is None else torch.zeros_like(like.lens)
        self.out = None if out is None else torch.zeros(out[0], dtype=out[1], device=device)
        rows = 0 if like is None else like.lens.shape[0]
        self.graph = programs.Graph("prefill", self._body, device, rows=rows, forwards=forwards)

    @classmethod
    def get(cls, name: str, model: Bagel, fn, modules: tuple, inputs: dict, cache, storage,
            forwards: dict, width: int, out, bake, block, family):
        from unimedvl_tpu_torch.inference import programs

        shapes = tuple((k, tuple(v.shape), v.dtype, v.device) if isinstance(v, torch.Tensor)
                       else (k, int) for k, v in inputs.items())
        key = ("prefill", name, storage, shapes, bake, programs.weights_key(*modules),
               programs.mesh_key(model))
        reads = modules
        if storage == "static":
            key += (_cache_kind(cache),)
        elif storage == "caller":
            arrays = _cache_arrays(cache)
            key += (cache.kv_bits, cache.lens.dtype, programs.tensors_key(arrays))
            reads += (arrays,)
        return programs.lookup(key, lambda: cls(model, fn, inputs, cache, storage, forwards,
                                                width, out, block),
                               reads=reads, owner=model.language_model, family=family)

    def graphs(self):
        return [self.graph]

    def _body(self) -> None:
        cache = None if self.cache is None else dataclasses.replace(self.cache, lens=self.lens)
        got = self.fn(self._model(), cache, **self.inputs)
        if self.out is not None:
            self.out.copy_(got)
        else:
            self.new_lens.copy_(got.lens)

    def run(self, cache: Optional[KVCache] = None, **inputs):
        """The prefill of ``inputs`` into ``cache`` (see the class's
        docstring); the cache with its new lens, the block, or the tensor."""
        for k, v in inputs.items():
            if isinstance(v, torch.Tensor):
                self.inputs[k].copy_(v)
            else:
                self.inputs[k].fill_(v)
        if self.storage == "static":
            _copy_cache(self.cache, cache)
        elif self.storage == "caller":
            self.cache = cache
        if self.storage in ("static", "caller"):
            self.lens.copy_(cache.lens)
        try:
            self.graph.replay()
        finally:
            if self.storage == "caller":
                self.cache = None
        if self.out is not None:
            return self.out.clone()
        lens = self.new_lens.clone()
        if self.storage == "block":
            return dataclasses.replace(self.cache, lens=lens)
        if self.storage == "static":
            _copy_columns(cache, self.cache, cache.lens, lens, self.width)
        return dataclasses.replace(cache, lens=lens)


def _exp_noise(like: torch.Tensor, generator) -> torch.Tensor:
    """``q ~ Exp(1)`` of ``like``'s shape and dtype from ``generator`` (the
    default generator of its device when None): a sampled step's draw."""
    return torch.empty_like(like).exponential_(1, generator=generator)


def _next_token(logits, do_sample: bool, temperature: float, generator) -> torch.Tensor:
    """Every stream's next token, int32 [S]: the argmax, or one draw of
    ``softmax(logits / temperature)`` made as ``torch.multinomial`` makes
    one (``argmax(probs / q)``, ``q`` from :func:`_exp_noise`), so that the
    same generator state gives the same tokens, without its sanity checks,
    which read the probabilities on the host and could not be captured."""
    if do_sample:
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.argmax(probs / _exp_noise(probs, generator), dim=-1).to(torch.int32)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _sampler(do_sample: bool, temperature: float, generator, device: torch.device) -> tuple:
    """The sampling options a decode program bakes in: (do_sample,
    temperature, the generator, resolved to its device's default when None;
    the key's part: the generator by identity, which the program holds, so
    the identity is not reused while it lives)."""
    if not do_sample:
        return False, 1.0, None, (False,)
    if generator is None:
        generator = (torch.cuda.default_generators[device.index] if device.type == "cuda"
                     else torch.default_generator)
    return True, float(temperature), generator, (True, float(temperature), id(generator))


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
    graphs: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Autoregressive decode (bagel.py:1259-1314). Over an int8 cache every
    step quantizes its kv at the write and attends through the int8 decode
    kernel; the scales keep the cache's one layout [L, S, Hk, M].

    Step d writes its kv at column base + d with base = max(lens) for every
    stream (the JAX package's aligned-column decode); lens do not advance, so
    the caller's context is unaffected. The caller guarantees capacity for
    base + max_length columns.

    ``graphs`` (``inference.programs.use_graphs``): by default, on a CUDA
    device, the decode runs as a captured device program
    (:class:`DecodeProgram`, the JAX package's jitted ``while_loop``), and
    the caller's cache is copied into the program's own and left as it was;
    ``graphs=False`` runs the eager loop below, the program's plain version,
    with one eos check per step. ``do_sample`` draws every step from
    ``generator`` (the device's default when None) as :func:`_next_token`
    draws, by either route: the same tokens from the same generator state,
    which both routes advance alike.

    Returns (tokens [S, max_length] int32 — starting with the start token,
    excluding eos, padded with -1; lengths [S]).
    """
    from unimedvl_tpu_torch.inference import programs

    if programs.use_graphs(graphs, start_tokens.device, model):
        prog = DecodeProgram.get(model, cache, start_tokens.shape[0], max_length, eos_id, False,
                                 do_sample, temperature, generator)
        return prog.run(cache, start_tokens, positions)[:2]
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
        cur = _next_token(logits, do_sample, temperature, generator)
        done = done | (cur == eos_id)
        pos = pos + 1
        if bool(done.all()):
            break
    lengths = (out >= 0).sum(dim=1)
    return out, lengths


def _static_like(cache: KVCache) -> KVCache:
    """A zeroed cache of ``cache``'s shapes, dtypes and width."""
    return cache._map(torch.zeros_like, torch.zeros_like, torch.zeros_like(cache.lens))


def _cache_arrays(cache: KVCache) -> list:
    return [t for t in (cache.k, cache.v, cache.k_scale, cache.v_scale) if t is not None]


def _copy_cache(dst: KVCache, src: KVCache) -> None:
    """``src``'s values, scales and lens into ``dst``'s storage."""
    for d, s in zip(_cache_arrays(dst) + [dst.lens], _cache_arrays(src) + [src.lens]):
        d.copy_(s)


def _cache_kind(cache: KVCache) -> tuple:
    return (tuple(cache.k.shape), cache.k.dtype, cache.quantized, cache.kv_bits,
            cache.lens.dtype, cache.k.device)


def static_cache(cache: KVCache) -> KVCache:
    """The cache of ``cache``'s shape, dtype and width that device programs
    copy their caller's into at every call (``programs.static_buffer``): one
    a kind, shared by every such program."""
    from unimedvl_tpu_torch.inference import programs

    return programs.static_buffer(("cache",) + _cache_kind(cache), lambda: _static_like(cache))


def _window(lo: torch.Tensor, hi: torch.Tensor, width: int, end: int):
    """(rows, cols, keep) [S, width] of each stream's columns [lo, hi),
    ``hi - lo <= width``: the window's columns past ``end`` are clamped onto
    its last one, where every copy then writes the same value."""
    S = lo.shape[0]
    cols = (lo.to(torch.int64)[:, None] + torch.arange(width, device=lo.device)).clamp_max(end - 1)
    keep = (cols >= lo.to(torch.int64)[:, None]) & (cols < hi.to(torch.int64)[:, None])
    return torch.arange(S, device=lo.device)[:, None].expand(S, width), cols, keep


def _copy_columns(dst: KVCache, src: KVCache, lo: torch.Tensor, hi: torch.Tensor,
                  width: int) -> None:
    """Columns [lo[s], hi[s]) of every stream of ``src``'s values and scales
    into ``dst``'s, in place: what a program's steps made valid in its own
    cache, into its caller's; ``hi - lo <= width``."""
    rows, cols, keep = _window(lo, hi, width, dst.capacity)
    for d, s in zip(_cache_arrays(dst), _cache_arrays(src)):
        k = keep.view(*keep.shape, *(1,) * (d.dim() - 2))  # [S, width, L, Hk(, D)]
        d[:, rows, :, cols] = torch.where(k, s[:, rows, :, cols], d[:, rows, :, cols])


def _copy_ids(dst: torch.Tensor, src: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
              width: int) -> None:
    """Columns [lo[s], hi[s]) of each row of ``src`` [S, HL] into ``dst``."""
    rows, cols, keep = _window(lo, hi, width, dst.shape[1])
    dst[rows, cols] = torch.where(keep, src[rows, cols], dst[rows, cols])


class DecodeProgram:
    """The decode loops of :func:`generate_text` (the aligned-column decode)
    and, with ``kept``, of :func:`generate_text_ctx` (each stream written at
    its own lens) as a device program: one captured graph is one decode step
    over static buffers (``inference/programs.py``). The loop state lives on
    the device: ``step`` (0-dim int32), ``cur``, ``pos``, ``done``, the output
    tokens ``out``, the kept decode's ``lens`` and ``go = (step < max_length)
    & ~all(done)``, the JAX ``cond``, which gates every state update. The
    aligned step's kv column ``base + step`` is computed in the graph into
    the 0-dim int32 band K2 / K2-int8 read without a copy; the kept step
    writes each stream at its ``lens`` (the band ``(lens, lens)``) with
    ``q_valid = ~done``, and ``lens`` advances on the device. A sampled
    program draws from its generator, which the graph registers.

    The cache is the programs' shared one of its shape, dtype and width
    (:func:`static_cache`; the caller's copied in at every call: 323 MB read
    and written at M 5632 in bf16, about 0.2 ms at 3.35 TB/s), so one program
    serves every request whose cache has its shape: a chat turn, whose
    context is new every turn, captures nothing anew. The aligned decode
    never writes the caller's cache; the kept decode copies the columns its
    steps made valid, [lens, new lens) of each stream, back into the caller's
    storage, where the eager loop writes them.

    The host reads ``go`` after every replay (R = 1: a blocking 1-byte read,
    tens of microseconds beside a step of several milliseconds), so the
    program never runs a step the eager loop would not, never more than
    ``max_length`` replays, and a sampled program draws what the eager loop
    draws. Keyed by the flavour, S, ``max_length``, eos, the sampling options
    (:func:`_sampler`), the cache's shape, dtype and width, and the LLM's
    weights."""

    def __init__(self, model: Bagel, cache: KVCache, S: int, max_length: int, eos_id: int,
                 kept: bool, sampler: tuple):
        from unimedvl_tpu_torch.inference import programs

        dev = cache.k.device
        self._model = programs.model_ref(model)
        self.max_length, self.eos_id, self.kept = max_length, int(eos_id), kept
        self.do_sample, self.temperature, self.generator, _ = sampler
        self.cache = static_cache(cache)
        i32 = dict(dtype=torch.int32, device=dev)
        self.lens = torch.zeros(S, dtype=cache.lens.dtype, device=dev)
        self.base = torch.zeros((), **i32)
        self.step = torch.zeros((), **i32)
        self.cur = torch.zeros(S, **i32)
        self.pos = torch.zeros(S, dtype=torch.int64, device=dev)
        self.done = torch.zeros(S, dtype=torch.bool, device=dev)
        self.go = torch.ones((), dtype=torch.bool, device=dev)
        self.out = torch.full((S, max_length), -1, **i32)
        self.cols = torch.arange(max_length, **i32)
        self.graph = programs.Graph(
            "decode", self._body, dev, rows=S,
            keep=(self.step, self.cur, self.pos, self.done, self.go, self.out, self.lens),
            generators=[self.generator] if self.do_sample and dev.type == "cuda" else [])

    @classmethod
    def get(cls, model: Bagel, cache: KVCache, S: int, max_length: int, eos_id: int,
            kept: bool = False, do_sample: bool = False, temperature: float = 1.0,
            generator: Optional[torch.Generator] = None):
        from unimedvl_tpu_torch.inference import programs

        sampler = _sampler(do_sample, temperature, generator, cache.k.device)
        key = ("decode", kept, S, max_length, int(eos_id), sampler[3], _cache_kind(cache),
               programs.weights_key(model.language_model), programs.mesh_key(model))
        return programs.lookup(key, lambda: cls(model, cache, S, max_length, eos_id, kept,
                                                sampler),
                               reads=(model.language_model,), owner=model.language_model)

    def graphs(self):
        return [self.graph]

    def _body(self) -> None:
        lm = self._model().language_model
        go = self.go
        self.out.copy_(torch.where(go & (self.cols == self.step),
                                   torch.where(self.done, -1, self.cur)[:, None], self.out))
        x = mot.embed_tokens(lm, self.cur)[:, None, :]
        if self.kept:
            h, cache = lm.model(x, self.pos[:, None],
                                dataclasses.replace(self.cache, lens=self.lens), causal=True,
                                q_valid=~self.done[:, None])
            self.lens.copy_(torch.where(go, cache.lens, self.lens))
        else:
            h, _ = lm.model(x, self.pos[:, None], self.cache, causal=True,
                            decode_cols=(self.base, self.base + self.step))
        nxt = _next_token(mot.lm_head(lm, h[:, 0]), self.do_sample, self.temperature,
                          self.generator)
        self.cur.copy_(torch.where(go, nxt, self.cur))
        self.done.copy_(torch.where(go, self.done | (nxt == self.eos_id), self.done))
        self.pos.add_(go.to(torch.int64))
        self.step.add_(go.to(torch.int32))
        self.go.copy_((self.step < self.max_length) & ~self.done.all())

    def run(self, cache: KVCache, start_tokens: torch.Tensor, positions: torch.Tensor):
        """The loop from the given state: (tokens, lengths, and for the kept
        decode the caller's cache with its new lens, else None)."""
        _copy_cache(self.cache, cache)
        self.lens.copy_(cache.lens)
        self.base.copy_(cache.lens.max())
        self.step.zero_()
        self.cur.copy_(start_tokens)
        self.pos.copy_(positions)
        self.done.zero_()
        self.go.fill_(True)
        self.out.fill_(-1)
        for _ in range(self.max_length):
            self.graph.replay()
            if not bool(self.go):  # the host's one read of a step
                break
        out = self.out.clone()
        lengths = (out >= 0).sum(dim=1)
        if not self.kept:
            return out, lengths, None
        _copy_columns(cache, self.cache, cache.lens, self.lens, self.max_length)
        return out, lengths, dataclasses.replace(cache, lens=self.lens.clone())


@torch.no_grad()
def generate_text_ctx(
    model: Bagel,
    cache: KVCache,
    start_tokens: torch.Tensor,  # [S]
    positions: torch.Tensor,  # [S]
    max_length: int,
    eos_id: int,
    do_sample: bool = False,
    temperature: float = 1.0,
    generator: Optional[torch.Generator] = None,
    graphs: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor, KVCache]:
    """The contiguous-cache decode (bagel.py:430-496): like
    :func:`generate_text`, but each stream appends its kv at its own
    ``lens[s]`` (the T = 1 per-stream step, K2 / K2-int8 with the band
    ``(lens, lens)``) and the cache comes back with lens advanced, so a
    multi-turn chat keeps its context instead of prefilling every answer
    again. The cache then holds the start token and every emitted token but
    eos (eos is never forwarded); a finished stream stops advancing
    (``q_valid = ~done``). The kv lands in the caller's cache tensors past
    its lens; the returned lens are new tensors. ``graphs``, ``do_sample``
    and ``generator`` as for :func:`generate_text`: by default on a CUDA
    device the kept :class:`DecodeProgram`, which copies the columns [lens,
    new lens) back into the caller's tensors (what the eager loop wrote past
    them is not: nothing reads it).

    Returns (tokens [S, max_length] padded with -1, lengths [S], cache)."""
    from unimedvl_tpu_torch.inference import programs

    if programs.use_graphs(graphs, start_tokens.device, model):
        prog = DecodeProgram.get(model, cache, start_tokens.shape[0], max_length, eos_id, True,
                                 do_sample, temperature, generator)
        return prog.run(cache, start_tokens, positions)
    lm = model.language_model
    S = start_tokens.shape[0]
    device = start_tokens.device
    out = torch.full((S, max_length), -1, dtype=torch.int32, device=device)
    done = torch.zeros(S, dtype=torch.bool, device=device)
    cur = start_tokens.to(torch.int32)
    pos = positions.to(torch.int64)
    for step in range(max_length):
        out[:, step] = torch.where(done, -1, cur)
        x = mot.embed_tokens(lm, cur)[:, None, :]
        h, cache = lm.model(x, pos[:, None], cache, causal=True, q_valid=~done[:, None])
        cur = _next_token(mot.lm_head(lm, h[:, 0]), do_sample, temperature, generator)
        done = done | (cur == eos_id)
        pos = pos + 1
        if bool(done.all()):  # the one host read of a step
            break
    return out, (out >= 0).sum(dim=1), cache


def propose_drafts(hist: torch.Tensor, hlen: torch.Tensor, ngram: int, K: int) -> torch.Tensor:
    """Prompt-lookup drafts (bagel.py:499-519): the K ids that followed the
    latest PRIOR occurrence of each stream's trailing ``ngram`` ids in
    ``hist`` [S, HL] (valid region [0, hlen)). Tail positions are clamped at
    0; a match counts only at b < hlen - ngram; with no match the drafts
    start at 0; draft positions are clipped to HL - 1. Drafts cost speed
    only, never correctness: one is accepted only where it equals the greedy
    choice. Returns int32 [S, K]."""
    HL = hist.shape[1]
    B = HL - ngram + 1
    dev = hist.device
    hlen = hlen.to(torch.int64)
    tail_pos = (hlen[:, None] - ngram + torch.arange(ngram, device=dev)).clamp_min(0)
    tail = torch.gather(hist, 1, tail_pos)
    windows = hist.unfold(1, ngram, 1)  # [S, B, ngram]
    b = torch.arange(B, device=dev)
    match = (windows == tail[:, None, :]).all(dim=-1) & (b[None] < hlen[:, None] - ngram)
    b_star = torch.where(match, b[None], -1).amax(dim=1)  # -1: no match
    dstart = torch.where(b_star >= 0, b_star + ngram, 0)
    dpos = (dstart[:, None] + torch.arange(K, device=dev)).clamp(0, HL - 1)
    return torch.gather(hist, 1, dpos).to(torch.int32)


def _scatter_row_window(buf: torch.Tensor, vals: torch.Tensor,
                        starts: torch.Tensor) -> torch.Tensor:
    """Write a [S, W] window into ``buf`` [S, L] at per-stream columns
    ``starts``, in place, and return ``buf`` (bagel.py:522-540). One stream
    clamps its start into [0, L - W], as JAX's ``dynamic_update_slice`` does;
    several drop a row whose window runs past L, whole, as JAX's
    ``FILL_OR_DROP`` scatter does (the row's columns are rewritten with what
    they held, so no host read decides which rows write)."""
    S, W = vals.shape
    L = buf.shape[1]
    steps = torch.arange(W, device=buf.device)
    starts = starts.to(torch.int64)
    vals = vals.to(buf.dtype)
    if S == 1:
        buf[0, starts[:1].clamp(0, L - W) + steps] = vals[0]
        return buf
    cols = starts[:, None] + steps
    fits = cols[:, -1:] < L
    cols = cols.clamp_max(L - 1)
    rows = torch.arange(S, device=buf.device)[:, None].expand(S, W)
    buf[rows, cols] = torch.where(fits, vals, buf[rows, cols])
    return buf


def spec_accept(draft, g, live, cursor, limit, eos_id: int):
    """The acceptance algebra of one verify forward (bagel.py:611-642),
    on the device: ``draft`` [S, K], ``g`` the greedy choices [S, K + 1] of
    the block [cur, draft]. A live stream accepts 1 + the longest prefix of
    drafts equal to the greedy choices, cut at the first valid eos and at
    ``limit - cursor`` tokens; the others accept 0 (they freeze). Returns
    (E [S] tokens accepted, fin [S] an eos was reached, the [S, K + 1]
    window of accepted tokens (-1 past E), the last accepted token or -1)."""
    K1 = g.shape[1]
    idxs = torch.arange(K1, device=g.device)[None]
    matched = (draft == g[:, :-1]).to(torch.int32)
    c = 1 + torch.cumprod(matched, dim=1).sum(dim=1)
    is_eos = (g == eos_id) & (idxs < c[:, None])
    e = torch.where(is_eos, idxs, K1).amin(dim=1)
    E = torch.where(live, torch.minimum(torch.minimum(c, e), limit - cursor), 0).to(torch.int32)
    fin = live & (e < c) & (e <= E)
    emit = torch.where(idxs < E[:, None], g, -1)
    last = torch.gather(g, 1, (E.to(torch.int64) - 1).clamp_min(0)[:, None])[:, 0]
    return E, fin, emit, torch.where(E >= 1, last, -1)


def verify_block(model: Bagel, cache: KVCache, cur, draft, pos, live):
    """The [S, K + 1] verify forward: the block [cur, drafts] at positions
    pos.., written at each stream's lens (a window past the capacity is
    dropped whole when S > 1), causal over the cache through K1a, only the
    ``live`` streams' rows valid. Returns (greedy choices int32 [S, K + 1],
    the cache)."""
    lm = model.language_model
    S, K = draft.shape
    block = torch.cat([cur[:, None], draft], dim=1)
    x = mot.embed_tokens(lm, block)
    block_pos = pos[:, None] + torch.arange(K + 1, device=pos.device)
    h, cache = lm.model(x, block_pos, cache, causal=True,
                        q_valid=live[:, None].expand(S, K + 1))
    logits = mot.lm_head(lm, h.reshape(S * (K + 1), -1))
    return torch.argmax(logits, dim=-1).reshape(S, K + 1).to(torch.int32), cache


class SpecProgram:
    """The speculative decode loops as a device program: one captured graph
    ("verify") is one iteration of :func:`generate_text_spec` or, with
    ``chunk``, of ``serving.decode_chunk_spec``: the drafts (the
    ``propose_drafts`` the program was built with), the [S, k + 1] verify
    forward (:func:`verify_block`, K1a at T = k + 1), the acceptance
    (:func:`spec_accept`), the two windowed writes of the tokens and of the
    history, and the updates of ``lens``, ``cur``, ``pending``, ``cursor``,
    ``pos``, ``hlen`` and the forward counter ``it``, all on the device and
    gated by ``go = (it < iters) & any(live)``, ``live = active & ~fin &
    (cursor < limit)``: the JAX ``cond``s, with ``limit`` the answer's
    ``max_length`` or the chunk's budgets, ``active`` every stream or the
    chunk's slots, ``iters`` ``max_length`` (never binding) or the chunk's
    ``num_iters``. A second graph ("decode") is :func:`generate_text_spec`'s
    fix-up forward, the pending tokens' kv at T = 1.

    Replays past the exit change nothing the caller reads: no stream is
    live, so nothing is accepted and no lens, position or cursor moves, and
    the token and history windows are written only under ``go``. The verify
    still writes its kv window at [lens, lens + k + 1) of each stream, past
    its valid columns, inside the room the capacity contract reserves
    (lens + max_length + k + 1 for :func:`generate_text_spec`); with S > 1 a
    window that runs past the capacity is dropped whole
    (``qwen2_mot._write_kv``, as :func:`_scatter_row_window` drops a row),
    but one stream's is clamped into the cache, so with S = 1 the host reads
    ``go`` before every replay and runs none past the exit.

    Storage: with ``static`` the cache and the history are buffers of their
    shape shared by the programs (:func:`static_cache`), the caller's copied
    in at every call and the columns the call made valid copied back ([lens,
    new lens); of the history [hlen, new hlen + k + 1), where the eager loop
    wrote, since drafts read past hlen), so that a caller whose storage is
    new at every request (a chat, a stream) captures nothing anew; otherwise the
    program writes the caller's own (the batcher's pool and history, which
    persist across rounds) and is keyed by their storage.
    :func:`generate_text_spec` reads ``go`` before every replay (one host
    read an iteration, as its eager loop; at most ``max_length`` replays); a
    chunk of S > 1 replays ``num_iters`` times with no host read."""

    def __init__(self, model: Bagel, cache: KVCache, hist: torch.Tensor, k_draft: int,
                 ngram: int, eos_id: int, iters: int, chunk: bool, static: bool, propose):
        from unimedvl_tpu_torch.inference import programs

        S, HL = hist.shape
        dev = cache.k.device
        self._model = programs.model_ref(model)
        self.S, self.K, self.ngram, self.eos = S, k_draft, ngram, int(eos_id)
        self.iters, self.chunk, self.static, self.propose = iters, chunk, static, propose
        # a chunk's pool is its caller's, held only while it runs; its history is
        # the caller's too, held by the program (the key holds its storage)
        self.cache = static_cache(cache) if static else None
        self.hist = programs.static_buffer(
            ("hist", S, HL, dev), lambda: torch.zeros((S, HL), dtype=torch.int32, device=dev)
        ) if static else hist
        i32 = dict(dtype=torch.int32, device=dev)
        self.width = iters * (k_draft + 1) if chunk else iters  # tokens a call can emit
        self.lens = torch.zeros(S, dtype=cache.lens.dtype, device=dev)
        self.active = torch.ones(S, dtype=torch.bool, device=dev)
        self.limit = torch.zeros(S, **i32)
        self.fin = torch.zeros(S, dtype=torch.bool, device=dev)
        self.pending = torch.zeros(S, dtype=torch.bool, device=dev)
        self.cursor = torch.zeros(S, **i32)
        self.cur = torch.zeros(S, **i32)
        self.pos = torch.zeros(S, dtype=torch.int64, device=dev)
        self.hlen = torch.zeros(S, **i32)
        self.it = torch.zeros((), **i32)
        self.go = torch.ones((), dtype=torch.bool, device=dev)
        self.out = torch.zeros((S, self.width + k_draft + 1), **i32)  # windowed-write margin
        self.verify = programs.Graph("verify", self._body, dev, rows=S, keep=(
            self.lens, self.fin, self.pending, self.cursor, self.cur, self.pos, self.hlen,
            self.it, self.go, self.out, self.hist))
        self.fixup = None if chunk else programs.Graph("decode", self._fixup, dev, rows=S,
                                                       keep=(self.lens,))

    @classmethod
    def get(cls, model: Bagel, cache: KVCache, hist: torch.Tensor, k_draft: int, ngram: int,
            eos_id: int, iters: int, chunk: bool, static: bool = True):
        from unimedvl_tpu_torch.inference import programs

        propose = globals()["propose_drafts"]  # a stand-in swapped in captures its own graph
        key = ("spec", chunk, static, iters, k_draft, ngram, int(eos_id), tuple(hist.shape),
               propose, programs.weights_key(model.language_model), programs.mesh_key(model))
        reads = (model.language_model,)
        if static:
            key += (_cache_kind(cache),)
        else:
            arrays = _cache_arrays(cache) + [hist]
            key += (cache.kv_bits, cache.lens.dtype, programs.tensors_key(arrays))
            reads += (arrays,)
        return programs.lookup(key, lambda: cls(model, cache, hist, k_draft, ngram, eos_id, iters,
                                                chunk, static, propose),
                               reads=reads, owner=model.language_model)

    def graphs(self):
        return [g for g in (self.verify, self.fixup) if g is not None]

    def _live(self) -> torch.Tensor:
        return self.active & ~self.fin & (self.cursor < self.limit)

    def _body(self) -> None:
        go = self.go
        live = go & self._live()
        draft = self.propose(self.hist, self.hlen, self.ngram, self.K)
        # the eager loops' verify rows: a chunk's live slots; generate_text_spec's
        # every stream not done (a full one's too)
        g, _ = verify_block(self._model(), dataclasses.replace(self.cache, lens=self.lens),
                            self.cur, draft, self.pos, live if self.chunk else go & ~self.fin)
        E, fin, emit, last = spec_accept(draft, g, live, self.cursor, self.limit, self.eos)
        self.fin.copy_(self.fin | fin)
        self.out.copy_(torch.where(go, _scatter_row_window(self.out.clone(), emit, self.cursor),
                                   self.out))
        self.hist.copy_(torch.where(
            go, _scatter_row_window(self.hist.clone(), emit.clamp_min(0), self.hlen), self.hist))
        self.lens.add_(torch.where(live, E.clamp_min(1), 0).to(self.lens.dtype))
        self.cur.copy_(torch.where(E >= 1, last, self.cur))
        self.pending.copy_(torch.where(live, E >= 1, self.pending))
        self.cursor.add_(E)
        self.pos.add_(E)
        self.hlen.add_(E)
        self.it.add_(go.to(torch.int32))
        self.go.copy_((self.it < self.iters) & self._live().any())

    def _fixup(self) -> None:
        lm = self._model().language_model
        x = mot.embed_tokens(lm, self.cur)[:, None, :]
        lm.model(x, self.pos[:, None], dataclasses.replace(self.cache, lens=self.lens),
                 causal=True, q_valid=self.pending[:, None])
        self.lens.add_(self.pending.to(self.lens.dtype))

    def _loop(self, cache: KVCache, hist: torch.Tensor, cur, positions, hlen) -> None:
        """Copies the caller's state in (its cache and history too, when
        static) and runs the verify replays."""
        if self.static:
            _copy_cache(self.cache, cache)
            self.hist.copy_(hist)
        else:
            self.cache = cache
        self.lens.copy_(cache.lens)
        self.cur.copy_(cur)
        self.pos.copy_(positions)
        self.hlen.copy_(hlen)
        self.fin.zero_()
        self.pending.fill_(True)  # the start token's kv is not written yet
        self.it.zero_()
        self.go.copy_(self._live().any() & (self.iters > 0))
        if self.S == 1 or not self.chunk:
            for _ in range(self.iters):
                if not bool(self.go):  # the host's one read of an iteration
                    break
                self.verify.replay()
        else:
            for _ in range(self.iters):
                self.verify.replay()

    def _copy_back(self, cache: KVCache, hist: torch.Tensor, hlen0: torch.Tensor) -> None:
        if self.static:
            _copy_columns(cache, self.cache, cache.lens, self.lens, self.width)
            # the history as the eager loop leaves it, its last window's zeros too:
            # the next call's drafts may read past hlen
            _copy_ids(hist, self.hist, hlen0.to(self.hlen.device), self.hlen + self.K + 1,
                      self.width + self.K + 1)
        else:
            self.cache = None

    def generate(self, cache: KVCache, start_tokens, positions, hist_ids, hist_lens):
        """:func:`generate_text_spec`'s loop and fix-up forward; its result,
        ``n_forwards`` the device counter (a 0-dim tensor)."""
        self.active.fill_(True)
        self.limit.fill_(self.iters)
        self.out.fill_(-1)
        self.out[:, 0] = start_tokens
        self.cursor.fill_(1)  # slot 0 holds the start token
        self._loop(cache, hist_ids, start_tokens, positions, hist_lens)
        self.fixup.replay()
        _copy_columns(cache, self.cache, cache.lens, self.lens, self.width)
        out = self.out[:, :self.iters].clone()
        return (out, (out >= 0).sum(dim=1), dataclasses.replace(cache, lens=self.lens.clone()),
                self.it.clone())

    def run_chunk(self, cache: KVCache, cur_tokens, positions, active, budget, hist, hlen):
        """``serving.decode_chunk_spec``'s loop; its result and the verify
        forwards run (a 0-dim tensor). ``hist`` is updated in place."""
        self.active.copy_(active)
        self.limit.copy_(budget)
        self.out.zero_()
        self.cursor.zero_()
        try:
            self._loop(cache, hist, cur_tokens, positions, hlen)
        finally:
            self._copy_back(cache, hist, hlen)
        return (self.out[:, :self.width].clone(), self.cursor.clone(), self.fin.clone(),
                self.cur.clone(), self.pos.to(positions.dtype, copy=True),
                dataclasses.replace(cache, lens=self.lens.clone()), hist, self.hlen.clone(),
                self.it.clone())


@torch.no_grad()
def generate_text_spec(
    model: Bagel,
    cache: KVCache,
    start_tokens: torch.Tensor,  # [S]
    positions: torch.Tensor,  # [S]
    max_length: int,
    eos_id: int,
    hist_ids: torch.Tensor,  # [S, HL] prompt ids, the last valid one the start token
    hist_lens: torch.Tensor,  # [S]
    k_draft: int = 7,
    ngram: int = 3,
    graphs: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor, KVCache, object]:
    """Prompt-lookup speculative decode (bagel.py:547-674), greedy-exact
    against :func:`generate_text_ctx`: the same tokens, lengths and final
    cache, with ``k_draft`` drafts (:func:`propose_drafts`) verified per
    forward (:func:`verify_block`). Streams freeze (no lens or position
    advance) once done or full. After the loop one T = 1 forward
    (``q_valid = pending``) writes the kv of each stream's newest accepted
    token, so that the cache holds every emitted token as the plain decode's
    does.

    ``graphs`` (``inference.programs.use_graphs``): by default, on a CUDA
    device, a :class:`SpecProgram` (one captured graph an iteration, the
    fix-up forward another; the cache and the history copied into the
    program's own, the columns made valid copied back); ``graphs=False``
    the eager loop, its plain version: a Python loop with one host read an
    iteration (is any stream still live), the acceptance on the device.

    ``hist_ids`` is not modified. HL must be >= max(hist_lens) + max_length
    + k_draft, and the cache must have room for lens + max_length + k_draft
    + 1 columns. Returns (tokens [S, max_length] with the start token and
    without eos, padded with -1; lengths [S]; the cache; the number of verify
    forwards: an int, or a 0-dim device tensor from the program)."""
    from unimedvl_tpu_torch.inference import programs

    if programs.use_graphs(graphs, start_tokens.device, model):
        prog = SpecProgram.get(model, cache, hist_ids, k_draft, ngram, eos_id, max_length,
                               chunk=False)
        return prog.generate(cache, start_tokens, positions, hist_ids, hist_lens)
    S = start_tokens.shape[0]
    dev = start_tokens.device
    K = k_draft
    out = torch.full((S, max_length + K + 1), -1, dtype=torch.int32, device=dev)
    out[:, 0] = start_tokens.to(torch.int32)
    cursor = torch.ones(S, dtype=torch.int32, device=dev)  # slot 0 holds the start token
    done = torch.zeros(S, dtype=torch.bool, device=dev)
    cur = start_tokens.to(torch.int32)
    pos = positions.to(torch.int64)
    lens = cache.lens
    pending = torch.ones(S, dtype=torch.bool, device=dev)  # the start token has no kv yet
    hist = hist_ids.to(torch.int32).clone()
    hlen = hist_lens.to(torch.int32).to(dev)
    n_forwards = 0
    while bool(((cursor < max_length) & ~done).any()):  # the one host read of an iteration
        draft = propose_drafts(hist, hlen, ngram, K)
        g, cache = verify_block(model, dataclasses.replace(cache, lens=lens), cur, draft,
                                pos, ~done)
        active = ~done & (cursor < max_length)
        E, fin, emit, last = spec_accept(draft, g, active, cursor, max_length, eos_id)
        done = done | fin
        _scatter_row_window(out, emit, cursor)
        _scatter_row_window(hist, emit.clamp_min(0), hlen)
        # active with E == 0 is the immediate eos: cur's kv was written and
        # consumed, and nothing new is pending
        lens = lens + torch.where(active, E.clamp_min(1), 0).to(lens.dtype)
        cur = torch.where(E >= 1, last, cur)
        pending = torch.where(active, E >= 1, pending)
        cursor = cursor + E
        pos = pos + E
        hlen = hlen + E
        n_forwards += 1
    lm = model.language_model
    x = mot.embed_tokens(lm, cur)[:, None, :]
    _, cache = lm.model(x, pos[:, None], dataclasses.replace(cache, lens=lens), causal=True,
                        q_valid=pending[:, None])
    cache = dataclasses.replace(cache, lens=lens + pending.to(lens.dtype))
    out = out[:, :max_length]
    return out, (out >= 0).sum(dim=1), cache, n_forwards


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

def _linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """A linear in x's dtype, the weights cast to it (the JAX package's
    ``_linear``): fp32 inputs keep fp32, whatever the weights' dtype."""
    bias = None if lin.bias is None else lin.bias.to(x.dtype)
    return F.linear(x, lin.weight.to(x.dtype), bias)


def time_embed(model: Bagel, t: torch.Tensor, freq_dim: int = 256) -> torch.Tensor:
    """TimestepEmbedder (modeling_utils.py:73-109): t [N] -> [N, C] fp32."""
    mlp = model.time_embedder.mlp
    h = timestep_embedding(t, freq_dim)
    return _linear(silu(_linear(h, mlp[0])), mlp[2])


def preprocess_vae_image(image_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [H, W, 3] -> normalized fp32 [1, 3, H, W] in [-1, 1] on the
    image's device, the VAE encoder's input."""
    x = image_u8.float() / 255.0
    return ((x - 0.5) / 0.5).permute(2, 0, 1)[None]


def _encode_vae_latent_tokens(model: Bagel, cache, image, noise=None) -> torch.Tensor:
    z = model.vae_model.encode(image, noise).permute(0, 2, 3, 1)  # NHWC
    p = model.config.latent_patch_size
    n, h, w, c = z.shape
    z = z.reshape(n, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return z.reshape(n, (h // p) * (w // p), p * p * c)


@torch.no_grad()
def encode_vae_latent_tokens(
    model: Bagel, image: torch.Tensor, noise: Optional[torch.Tensor] = None,
    graphs: Optional[bool] = None,
) -> torch.Tensor:
    """VAE-encode image [1, 3, H, W] and patchify the latent into
    [1, h*w, p*p*z] tokens in (p, q, channel) order (bagel.py:757-776).
    ``noise`` [1, z, H/8, W/8] draws the posterior sample; None takes the mean.
    ``graphs`` as for :func:`prefill_text`: by default on a CUDA device a
    :class:`PrefillProgram` keyed by the image's shape (the image and the
    noise copied into its buffers; the noise is drawn by the caller)."""
    cfg = model.config
    p, ds = cfg.latent_patch_size, cfg.vae.downsample
    h, w = image.shape[2] // ds, image.shape[3] // ds
    out = ((1, (h // p) * (w // p), p * p * cfg.vae.z_channels), torch.float32)
    inputs = dict(image=image) if noise is None else dict(image=image, noise=noise)
    return _prefill("vae_encode", model, _encode_vae_latent_tokens, (model.vae_model,), inputs,
                    None, graphs, None, {}, out=out)


def _vae_block(model: Bagel, latent_tokens, latent_pos_ids, start_end_ids, n_tokens, timestep):
    """The gen block [1, Nb + 2, C]: <vision_start>, the latent tokens
    (vae2llm + timestep embedding + position, in fp32, then rounded to the
    model dtype), <vision_end> at row n_tokens + 1 (a host int or a 0-dim
    device tensor; placed by ``torch.where`` on the row index)."""
    lm = model.language_model
    t = torch.full((1,), float(timestep), dtype=torch.float32, device=latent_tokens.device)
    x_lat = _linear(latent_tokens.float(), model.vae2llm) + time_embed(model, t)[:, None]
    x_lat = x_lat + model.latent_pos_embed.pos_embed[latent_pos_ids]
    se = mot.embed_tokens(lm, start_end_ids)
    x = F.pad(x_lat.to(se.dtype), (0, 0, 1, 1))
    x[:, 0] = se[0]
    rows = torch.arange(x.shape[1], device=x.device)[None, :, None]
    return torch.where(rows == n_tokens + 1, se[1], x)


@torch.no_grad()
def prefill_vae(
    model: Bagel,
    cache: KVCache,
    latent_tokens: torch.Tensor,  # [1, n, p*p*z]
    latent_pos_ids: torch.Tensor,  # [1, n]
    start_end_ids: torch.Tensor,  # [2]
    rope_pos: int,
    timestep: float = 0.0,  # 0 for a clean conditioning image
) -> KVCache:
    """VAE image prefill through the gen expert (bagel.py:697-806), exact shape."""
    n = latent_tokens.shape[1]
    x = _vae_block(model, latent_tokens, latent_pos_ids, start_end_ids, n, timestep)
    positions = torch.full((1, 1), rope_pos, dtype=torch.int64, device=x.device)
    _, cache = model.language_model.model(x, positions, cache, causal=False, mode="gen")
    return cache


def _prefill_vae_bucketed(model: Bagel, cache: KVCache, latent_tokens, latent_pos_ids, n_tokens,
                          start_end_ids, rope_pos, timestep: float = 0.0) -> KVCache:
    x = _vae_block(model, latent_tokens, latent_pos_ids, start_end_ids, n_tokens, timestep)
    T = x.shape[1]
    q_valid = (torch.arange(T, device=x.device) < n_tokens + 2)[None]
    _, cache = model.language_model.model(
        x, rope_pos.reshape(1, 1), cache, causal=False, q_valid=q_valid, mode="gen",
        gen_end_row=n_tokens + 1,
    )
    return cache


@torch.no_grad()
def prefill_vae_bucketed(
    model: Bagel,
    cache: KVCache,
    latent_tokens: torch.Tensor,  # [1, Nb, p*p*z] padded to a bucket
    latent_pos_ids: torch.Tensor,  # [1, Nb]
    n_tokens,  # actual latent count (<= Nb): a host int or a 0-dim device tensor
    start_end_ids: torch.Tensor,  # [2]
    rope_pos,  # a host int or a 0-dim device tensor
    timestep: float = 0.0,
    graphs: Optional[bool] = None,
) -> KVCache:
    """VAE image prefill over a padded bucket: <vision_end> sits at row
    n + 1, which the MoT routes to the und expert (``gen_end_row``, a device
    tensor: ``qwen2_mot._mot_rows`` gathers it by index, K1b reads it from
    the device), and rows >= n + 2 are masked (their cache columns are
    overwritten by the next append). The caller provides capacity for the
    whole padded block. ``graphs`` as for :func:`prefill_vit_bucketed`: one
    capture serves every latent count of a bucket (``timestep`` is baked
    in)."""
    def fn(model, cache, **kw):
        return _prefill_vae_bucketed(model, cache, **kw, timestep=timestep)

    mods = (model.language_model, model.vae2llm, model.time_embedder, model.latent_pos_embed)
    return _prefill("vae", model, fn, mods,
                    dict(latent_tokens=latent_tokens, latent_pos_ids=latent_pos_ids,
                         n_tokens=n_tokens, start_end_ids=start_end_ids, rope_pos=rope_pos),
                    cache, graphs, "static", dict(prefill=1, gen=1),
                    latent_tokens.shape[1] + 2, bake=(float(timestep),))


def _cfg_combine(
    v: torch.Tensor,  # [n, d] main velocity
    v_text: torch.Tensor,  # [n, d] text-dropped context velocity
    v_img: torch.Tensor,  # [n, d] image-dropped context velocity
    text_scale: float,  # 1.0 outside cfg_interval
    img_scale: float,
    renorm_min: float,
    renorm_type: str,
    use_text_cfg: bool,
    use_img_cfg: bool,
    seq_group=None,
) -> torch.Tensor:
    """CFG combination with renorm clamping (bagel.py:1173-1207), in fp32,
    rounded back to v's dtype. With scales 1.0 every formula gives v.

    ``seq_group``: the process group over which the token dim is sharded
    (parallel/sp_denoise.py). The "global" renorm's two sums of squares are
    then all-reduced over it; the channel renorms are per token and need no
    communication."""
    if not use_text_cfg:
        return v
    v32, vt32 = v.float(), v_text.float()
    v_ = vt32 + text_scale * (v32 - vt32)
    if renorm_type == "text_channel":
        norm_v = torch.linalg.vector_norm(v32, dim=-1, keepdim=True)
        norm_v_ = torch.linalg.vector_norm(v_, dim=-1, keepdim=True)
        v_ = v_ * torch.clamp(norm_v / (norm_v_ + 1e-8), renorm_min, 1.0)
        if use_img_cfg:
            vi32 = v_img.float()
            v_ = vi32 + img_scale * (v_ - vi32)
        return v_.to(v.dtype)
    if use_img_cfg:
        vi32 = v_img.float()
        v_ = vi32 + img_scale * (v_ - vi32)
    if renorm_type == "global" and seq_group is not None:
        sums = torch.stack([torch.sum(v32 * v32), torch.sum(v_ * v_)])
        torch.distributed.all_reduce(sums, group=seq_group)
        norm_v, norm_v_ = torch.sqrt(sums[0]), torch.sqrt(sums[1])
    elif renorm_type == "global":
        norm_v, norm_v_ = torch.linalg.vector_norm(v32), torch.linalg.vector_norm(v_)
    elif renorm_type == "channel":
        norm_v = torch.linalg.vector_norm(v32, dim=-1, keepdim=True)
        norm_v_ = torch.linalg.vector_norm(v_, dim=-1, keepdim=True)
    else:
        raise NotImplementedError(renorm_type)
    return (v_ * torch.clamp(norm_v / (norm_v_ + 1e-8), renorm_min, 1.0)).to(v.dtype)


def _step_velocities(model: Bagel, x: torch.Tensor, block_positions: torch.Tensor,
                     step_caches: KVCache, G: int, active: int, n: int) -> torch.Tensor:
    """A flow step's velocities [G, active, n, d] of its G * active streams
    (blocks ``x``): on a rank of a mesh whose "data" axis divides them, the
    forward of this data rank's share (``parallel.mesh.stream_range``) and
    the velocities gathered over "data"; otherwise every stream's."""
    lm = model.language_model
    mesh = getattr(lm, "mesh", None)
    s0, ns = (0, G * active) if mesh is None else stream_range(mesh, G * active)
    if ns < G * active:
        sl = slice(s0, s0 + ns)
        mine = step_caches._map(lambda t: t[:, sl], lambda t: t[:, sl], step_caches.lens[sl])
        h, _ = lm.model(x[sl], block_positions[sl], mine, causal=False, mode="gen",
                        update_cache=False)
        v_loc = _linear(h[:, 1:n + 1], model.llm2vae)
        return mesh.gather(v_loc, "data", dim=0).view(G, active, n, -1)
    h, _ = lm.model(x, block_positions, step_caches, causal=False, mode="gen",
                    update_cache=False)
    return _linear(h[:, 1:n + 1], model.llm2vae).view(G, active, n, -1)


def flow_timesteps(num_timesteps: int, timestep_shift: float):
    """(timesteps [T-1], dts [T-1]) fp32 numpy (bagel.py:937-940)."""
    ts = np.linspace(1.0, 0.0, num_timesteps, dtype=np.float32)
    ts = timestep_shift * ts / (1 + (timestep_shift - 1) * ts)
    dts = ts[:-1] - ts[1:]
    return ts[:-1], dts


def _cfg_runs(in_interval: np.ndarray):
    """Contiguous (start, end, cfg_on) runs of the static schedule."""
    runs, start = [], 0
    for i in range(1, len(in_interval) + 1):
        if i == len(in_interval) or bool(in_interval[i]) != bool(in_interval[start]):
            runs.append((start, i, bool(in_interval[start])))
            start = i
    return runs


def generate_latents(
    model: Bagel,
    caches: KVCache,  # stacked streams [L, S_cfg, Hk, M, D]: main, cfg_text?, cfg_img?
    positions: torch.Tensor,  # [S_cfg] rope position of each context
    latent_pos_ids: torch.Tensor,  # [n]
    init_noise: torch.Tensor,  # [n, p*p*z] fp32
    start_end_ids: torch.Tensor,  # [2]
    **kw,
) -> torch.Tensor:
    """The rectified-flow loop (bagel.py:901-1211) as a Python loop; returns
    the final latent tokens [n, p*p*z] fp32.

    Each step runs one gen-mode forward over all context streams at once,
    attending to each stream's cache plus the latent block without writing
    it. Steps outside ``cfg_interval`` run the main stream alone.
    ``step_range=(lo, hi)`` runs steps [lo, hi) of the schedule with
    ``init_noise`` as the state at step lo; split ranges compose to the
    full run. The options are :func:`generate_latents_group`'s: this is that
    loop over one image.
    """
    return generate_latents_group(model, caches, positions, latent_pos_ids, init_noise[None],
                                  start_end_ids, **kw)[0]


@torch.no_grad()
def generate_latents_group(
    model: Bagel,
    caches: KVCache,  # [L, G * S1, Hk, M, D]: each image's streams, g-major
    positions: torch.Tensor,  # [G * S1] rope position of each context stream
    latent_pos_ids: torch.Tensor,  # [n], one geometry for every image
    init_noise: torch.Tensor,  # [G, n, p*p*z] fp32
    start_end_ids: torch.Tensor,  # [2]
    num_timesteps: int = 50,
    timestep_shift: float = 3.0,
    cfg_text_scale: float = 1.0,
    cfg_img_scale: float = 1.0,
    cfg_interval: Tuple[float, float] = (0.0, 1.0),
    cfg_renorm_min: float = 0.0,
    cfg_renorm_type: str = "global",
    use_text_cfg: bool = False,
    use_img_cfg: bool = False,
    step_range: Optional[Tuple[int, int]] = None,
    graphs: Optional[bool] = None,
) -> torch.Tensor:
    """The flow loop of G images in one forward a step (bagel.py:872-1001):
    the stream layout is G copies of one image's [main, cfg_text?, cfg_img?],
    g-major, so ``caches`` is the stream-dim concatenation of the images'
    caches; every image shares the schedule and the CFG options. Outside the
    CFG interval only each image's main stream runs (rows 0::S1). The CFG
    combination and its renorm run per image, so each image's latents are
    those of its own loop. Returns the final latents [G, n, p*p*z] fp32.

    State dtypes (see the module's note): x_t fp32, ``vae2llm`` and the
    timestep embedding in fp32, their sum rounded to the model dtype once,
    the velocity from ``llm2vae`` in the model dtype, the CFG and the update
    in fp32.

    On a rank of a mesh (``parallel.mesh.place_params``) whose "data" axis
    divides a step's streams, each data rank runs the forward of its share
    of the streams (``parallel.mesh.stream_range``) and the velocities are
    gathered over "data" before the CFG combination, every step (the JAX
    mesh program shards the streams over "data" there); otherwise every data
    rank runs every stream.

    ``graphs`` (``inference.programs.use_graphs``): by default, on a CUDA
    device (on a rank's model, when its mesh's groups are all NCCL), the
    loop runs as a captured device program (:class:`FlowProgram`, the JAX
    package's ``lax.scan``, the gather over "data" inside its graph);
    ``graphs=False`` runs the eager loop below, the program's plain
    version."""
    from unimedvl_tpu_torch.inference import programs

    lm = model.language_model
    G, n = init_noise.shape[:2]
    S_all = caches.k.shape[1]
    if S_all % G:
        raise ValueError(f"{S_all} cache streams do not split into {G} images")
    S1 = S_all // G
    device = init_noise.device
    ts, dts = flow_timesteps(num_timesteps, timestep_shift)
    lo, hi = cfg_interval
    in_interval = (ts > lo) & (ts <= hi)
    text_scales = np.where(in_interval, cfg_text_scale, 1.0).astype(np.float32)
    img_scales = np.where(in_interval, cfg_img_scale, 1.0).astype(np.float32)
    lo_s, hi_s = step_range if step_range is not None else (0, len(ts))
    if programs.use_graphs(graphs, device, model):
        cfg = dict(num_timesteps=num_timesteps, timestep_shift=timestep_shift,
                   cfg_text_scale=cfg_text_scale, cfg_img_scale=cfg_img_scale,
                   cfg_interval=tuple(cfg_interval), cfg_renorm_min=cfg_renorm_min,
                   cfg_renorm_type=cfg_renorm_type, use_text_cfg=use_text_cfg,
                   use_img_cfg=use_img_cfg)
        prog = FlowProgram.get(model, caches, positions, G, n, init_noise.shape[-1], cfg)
        return prog.run(caches, positions, latent_pos_ids, init_noise, start_end_ids, lo_s, hi_s)

    se = mot.embed_tokens(lm, start_end_ids)
    C = se.shape[-1]
    pos_emb = model.latent_pos_embed.pos_embed[latent_pos_ids]  # [n, C]
    # every step's timestep embedding in one call: no host-to-device copy per step
    t_emb = time_embed(model, torch.from_numpy(ts).to(device))  # [steps, C] fp32
    x_t = init_noise.float()
    for run_start, run_end, cfg_on in _cfg_runs(in_interval):
        run_start, run_end = max(run_start, lo_s), min(run_end, hi_s)
        if run_start >= run_end:
            continue
        cfg_on = cfg_on and S1 > 1
        active = S1 if cfg_on else 1  # streams per image in this run
        if active == S1:
            step_caches, pos_act = caches, positions
        else:  # each image's main stream
            step_caches = caches._map(lambda t: t[:, 0::S1], lambda t: t[:, 0::S1],
                                      caches.lens[0::S1])
            pos_act = positions[0::S1]
        block_positions = pos_act[:, None]
        for i in range(run_start, run_end):
            x_lat = (_linear(x_t, model.vae2llm) + t_emb[i] + pos_emb).to(se.dtype)
            block = torch.cat([se[:1].expand(G, 1, C), x_lat, se[1:].expand(G, 1, C)], dim=1)
            # each image's block over its active streams (a view at G = 1)
            x = block[:, None].expand(G, active, n + 2, C).reshape(G * active, n + 2, C)
            v_all = _step_velocities(model, x, block_positions, step_caches, G, active, n)
            v = v_all[:, 0]
            if cfg_on:
                v_text = v_all[:, 1] if use_text_cfg else v
                v_img = v_all[:, 1 + int(use_text_cfg)] if use_img_cfg else v
                v = torch.stack([_cfg_combine(
                    v[g], v_text[g], v_img[g], float(text_scales[i]), float(img_scales[i]),
                    cfg_renorm_min, cfg_renorm_type, use_text_cfg, use_img_cfg,
                ) for g in range(G)])
            x_t = x_t - v.float() * float(dts[i])
    return x_t


class FlowProgram:
    """:func:`generate_latents_group` as a device program: one captured graph
    is one flow step of a cfg-run kind ("all": every stream of each image, in
    the CFG interval; "main": each image's main stream, rows ``0::S1``), over
    static buffers (``inference/programs.py``): the state ``x_t`` (fp32,
    updated in place), the step index ``i`` (0-dim int64), and the step's
    inputs read at ``i`` from device arrays (the timestep embeddings of every
    step, computed once, and the ``dts``). The CFG scales are constant within
    a ``_cfg_runs`` run and are baked into the "all" graph. The caches, the
    positions, the latent position embedding and the <vision_start/end>
    embeddings are the program's own, copied in at every call, so one program
    serves every request of its geometry; a ``step_range`` segment sets ``i``
    and replays. No exit test: a run's steps are known on the host. On a
    rank's model whose "data" axis divides a step's streams the graph runs
    the rank's share and gathers the velocities over "data", as the eager
    loop does. Keyed by G, S1, the latent count and width, the caches'
    shape, dtype and width, the schedule and CFG options, the weights and
    the mesh (``programs.mesh_key``)."""

    def __init__(self, model: Bagel, caches: KVCache, positions: torch.Tensor, G: int, n: int,
                 d: int, cfg: dict):
        from unimedvl_tpu_torch.inference import programs

        lm = model.language_model
        dev = caches.k.device
        self._model = programs.model_ref(model)
        self.cfg, self.G, self.n = cfg, G, n
        self.S1 = caches.k.shape[1] // G
        self.caches = static_cache(caches)
        self.positions = torch.zeros_like(positions)
        C = model.config.llm.hidden_size
        self.dtype = lm.model.embed_tokens.weight.dtype
        self.pos_emb = torch.zeros((n, C), dtype=model.latent_pos_embed.pos_embed.dtype, device=dev)
        self.se = torch.zeros((2, C), dtype=self.dtype, device=dev)
        self.x_t = torch.zeros((G, n, d), dtype=torch.float32, device=dev)
        self.i = torch.zeros((), dtype=torch.int64, device=dev)
        ts, dts = flow_timesteps(cfg["num_timesteps"], cfg["timestep_shift"])
        self.t_emb = time_embed(model, torch.from_numpy(ts).to(dev))  # [steps, C] fp32
        self.dts = torch.from_numpy(dts).to(dev)
        lo, hi = cfg["cfg_interval"]
        self.in_interval = (ts > lo) & (ts <= hi)
        self._graphs = {}
        self.device = dev

    @classmethod
    def get(cls, model: Bagel, caches: KVCache, positions: torch.Tensor, G: int, n: int, d: int,
            cfg: dict):
        from unimedvl_tpu_torch.inference import programs

        mods = (model.language_model, model.vae2llm, model.llm2vae, model.time_embedder,
                model.latent_pos_embed)
        key = ("flow", G, n, d, _cache_kind(caches), tuple(positions.shape), positions.dtype,
               tuple(sorted(cfg.items())), programs.weights_key(*mods), programs.mesh_key(model))
        return programs.lookup(key, lambda: cls(model, caches, positions, G, n, d, cfg),
                               reads=mods, owner=model.language_model)

    def graphs(self):
        return list(self._graphs.values())

    def _graph(self, cfg_on: bool):
        from unimedvl_tpu_torch.inference import programs

        kind = "all" if cfg_on else "main"
        if kind not in self._graphs:
            self._graphs[kind] = programs.Graph(
                "denoise", lambda: self._body(cfg_on), self.device, keep=(self.x_t, self.i),
                rows=self.G * (self.S1 if cfg_on else 1))
        return self._graphs[kind]

    def _body(self, cfg_on: bool) -> None:
        model, cfg, G, n, S1 = self._model(), self.cfg, self.G, self.n, self.S1
        C = self.se.shape[-1]
        active = S1 if cfg_on else 1
        if cfg_on:
            step_caches, pos_act = self.caches, self.positions
        else:  # each image's main stream
            c = self.caches
            step_caches = c._map(lambda t: t[:, 0::S1], lambda t: t[:, 0::S1], c.lens[0::S1])
            pos_act = self.positions[0::S1]
        i = self.i.view(1)
        x_lat = (_linear(self.x_t, model.vae2llm) + self.t_emb.index_select(0, i)
                 + self.pos_emb).to(self.dtype)
        se = self.se
        block = torch.cat([se[:1].expand(G, 1, C), x_lat, se[1:].expand(G, 1, C)], dim=1)
        x = block[:, None].expand(G, active, n + 2, C).reshape(G * active, n + 2, C)
        v_all = _step_velocities(model, x, pos_act[:, None], step_caches, G, active, n)
        v = v_all[:, 0]
        if cfg_on:
            ut, ui = cfg["use_text_cfg"], cfg["use_img_cfg"]
            v_text = v_all[:, 1] if ut else v
            v_img = v_all[:, 1 + int(ut)] if ui else v
            v = torch.stack([_cfg_combine(
                v[g], v_text[g], v_img[g], float(cfg["cfg_text_scale"]),
                float(cfg["cfg_img_scale"]), cfg["cfg_renorm_min"], cfg["cfg_renorm_type"], ut, ui,
            ) for g in range(G)])
        self.x_t.copy_(self.x_t - v.float() * self.dts.index_select(0, i))
        self.i.add_(1)

    def run(self, caches, positions, latent_pos_ids, init_noise, start_end_ids, lo_s, hi_s):
        model = self._model()
        _copy_cache(self.caches, caches)
        self.positions.copy_(positions)
        self.pos_emb.copy_(model.latent_pos_embed.pos_embed[latent_pos_ids])
        self.se.copy_(mot.embed_tokens(model.language_model, start_end_ids))
        self.x_t.copy_(init_noise)
        for run_start, run_end, cfg_on in _cfg_runs(self.in_interval):
            run_start, run_end = max(run_start, lo_s), min(run_end, hi_s)
            if run_start >= run_end:
                continue
            graph = self._graph(cfg_on and self.S1 > 1)
            self.i.fill_(run_start)
            for _ in range(run_start, run_end):
                graph.replay()
        return self.x_t.clone()


def _decode_latent_to_image(model: Bagel, latent_tokens, latent_h: int,
                            latent_w: int) -> torch.Tensor:
    cfg = model.config
    p, c = cfg.latent_patch_size, cfg.latent_channel
    z = latent_tokens.float().reshape(latent_h, latent_w, p, p, c).permute(4, 0, 2, 1, 3)
    z = z.reshape(1, c, latent_h * p, latent_w * p)
    img = model.vae_model.decode(z)[0].permute(1, 2, 0)  # [H, W, 3] in [-1, 1]
    img = torch.clamp(img.float() * 0.5 + 0.5, 0.0, 1.0) * 255.0
    return img.to(torch.uint8)


@torch.no_grad()
def decode_latent_to_image(
    model: Bagel, latent_tokens: torch.Tensor, latent_h: int, latent_w: int,
    graphs: Optional[bool] = None,
) -> torch.Tensor:
    """Unpatchify, VAE decode, denormalize: latent tokens [n, p*p*z] ->
    uint8 [H, W, 3] on their device (inferencer.py:234-256). ``graphs`` as
    for :func:`encode_vae_latent_tokens`: by default on a CUDA device a
    :class:`PrefillProgram` (the JAX package jits the decode per latent
    size), one per ``(latent_h, latent_w)`` and token dtype, the tokens
    copied into its buffer; the image is returned as a new tensor."""
    ld = model.config.latent_downsample
    out = ((latent_h * ld, latent_w * ld, 3), torch.uint8)

    def fn(model, _cache, latent_tokens):
        return _decode_latent_to_image(model, latent_tokens, latent_h, latent_w)

    return _prefill("vae_decode", model, fn, (model.vae_model,),
                    dict(latent_tokens=latent_tokens), None, graphs, None, {}, out=out,
                    bake=(int(latent_h), int(latent_w)))


# ---------------------------------------------------------------------------
# training forward (reference Bagel.forward, bagel.py:202-374)
# ---------------------------------------------------------------------------

_INDEX_KEYS = ("packed_text_indexes", "und_idx", "gen_idx", "ce_idx", "ce_labels",
               "vit_scatter_idx", "vit_token_idx", "vae_scatter_idx", "vit_pos_ids",
               "vae_latent_pos_ids", "packed_position_ids")


class PreparedSequence(dict):
    """One packed sequence as :func:`prepare_sequence` gives it, its padding
    slots dropped. ``host``: the numpy arrays it was prepared from, so that
    a training step whose route takes the other form
    (``training.trainer.prepared``) prepares it again."""

    host: Optional[Dict[str, np.ndarray]] = None


class PaddedSequence(PreparedSequence):
    """One packed sequence as :func:`prepare_sequence` gives it with
    ``padded=True``: every index list keeps its padding slots (index T) and
    the arrays beside them their padding rows, as ``pack_training_batch``
    pads them, so that the arrays' shapes are the batch's bucket's.
    ``vae_rows``: its real latent rows (a host int), the rows of the flow
    noise the eager step draws for it."""

    vae_rows: int = 0


def prepare_sequence(batch: Dict[str, np.ndarray], device, pin: bool = False,
                     padded: bool = False) -> PreparedSequence:
    """One packed sequence of ``data.packing.pack_training_batch`` (numpy, or
    one row of a ``stack_packed`` batch) as the tensors :func:`train_forward`
    takes, on ``device``.

    The packed arrays pad their index lists with T and rely on out-of-range
    gathers that fill and scatters that drop. By default the padding slots
    are dropped here, on the host (``strip_padding``): they carry zero loss
    weight and reach no token, so every loss equals the padded
    computation's. With ``padded`` they stay (a :class:`PaddedSequence`):
    ViT images as [N, max_n] with ``vit_valid`` and ``vit_scatter_idx`` over
    all N * max_n rows, the other lists at their padded lengths; the forward
    reads a padding slot's row from row T - 1 and writes it to a dropped
    sink row (``qwen2_mot.Rows``). Every shape is then fixed by the bucket,
    as a captured training program needs. Index arrays become int64,
    segment ids stay int32. ``pin`` stages the arrays in pinned host memory
    and copies without blocking (for a worker thread feeding the card; the
    caching host allocator keeps a staged block until its copy is done)."""
    if padded:
        out = PaddedSequence()
        T = batch["packed_position_ids"].shape[0]
        if "vae_scatter_idx" in batch:
            out.vae_rows = int((np.asarray(batch["vae_scatter_idx"]) < T).sum())
        arrays = batch
    else:
        out, arrays = PreparedSequence(), strip_padding(batch)
    out.host = batch
    for key, a in arrays.items():
        t = torch.from_numpy(np.ascontiguousarray(a))
        if key in _INDEX_KEYS:
            t = t.to(torch.int64)
        if pin and t.numel():
            t = t.pin_memory()
        out[key] = t.to(device, non_blocking=pin)
    return out


def is_padded(batch) -> bool:
    return isinstance(batch, PaddedSequence)


def train_forward(
    model: Bagel,
    batch: Dict[str, torch.Tensor],
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    diffusion_feature_layer: Optional[int] = None,
    bn_state=None,
) -> Dict[str, torch.Tensor]:
    """Packed multimodal training forward with the CE and rectified-flow MSE
    losses.

    ``batch`` is one packed sequence as :func:`prepare_sequence` returns it
    (a numpy batch of ``pack_training_batch`` is prepared here, onto the
    model's device): packed_text_ids / indexes, packed_position_ids [T], the
    mask segment arrays (document / fn / noise ids [T]), und_idx / gen_idx,
    vit_* (batched padded images, and which of their rows go where), vae_*
    (clean latent tokens, raw timesteps, scatter indexes), ce_idx / ce_labels
    / ce_weight, mse_weight. ``noise`` [Nv, 64] is the flow noise; when None
    it is drawn from ``generator``. Returns dict(ce=..., mse=..., loss=...)
    of fp32 scalars (weighted means); with ``diffusion_feature_layer``, also
    ``diffusion_features``.

    ``cfg.e2e`` (training/e2e_vae.py, as the JAX package's train_forward):
    the feature tap defaults to ``cfg.e2e.diffusion_feature_layer``; with
    ``enable_batch_norm`` and a ``bn_state`` the clean latents are
    batch-normed and the new state comes back as ``bn_state``; with
    ``repa_teacher_features`` [Nv, Dt] in the batch the REPA terms join the
    loss (``repa_align`` through ``repa_proj``, ``repa_vae_align`` through
    ``repa_vae_proj``).

    Attention takes the segment arrays (K5 on the card). The dense [T, T]
    mask is built only for CPU tensors, whose plain attention needs it.

    A :class:`PaddedSequence` runs at its padded lengths: every padding row
    is computed and dropped, with zero loss weight (the JAX forward's
    semantics), so its losses and gradients are the stripped sequence's."""
    cfg = model.config
    if diffusion_feature_layer is None and cfg.e2e is not None:
        diffusion_feature_layer = cfg.e2e.diffusion_feature_layer
    if isinstance(batch["packed_position_ids"], np.ndarray):
        batch = prepare_sequence(batch, model.language_model.model.embed_tokens.weight.device)
    x, stash = train_embed(model, batch, noise, generator, bn_state=bn_state)
    segments = (batch["mask_document_id"], batch["mask_fn_id"], batch["mask_noise_id"])
    result = mot.forward_train(
        model.language_model.model, x, batch["packed_position_ids"], None,
        batch["und_idx"], batch["gen_idx"], segments=segments,
        feature_layer=diffusion_feature_layer,
    )
    h, features = result if diffusion_feature_layer is not None else (result, None)
    return train_losses(model, batch, h, stash, features=features)


def train_embed(
    model: Bagel,
    batch: Dict[str, torch.Tensor],
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    bn_state=None,
):
    """Prologue of :func:`train_forward`: the packed [T, C] input embedding
    (text, ViT and noised VAE-latent rows, reference bagel.py:229-287).
    Returns (x, stash); the stash carries what the losses need (noise, clean
    (batch-normed under ``cfg.e2e.enable_batch_norm`` with a ``bn_state``),
    t_shifted, the new bn_state or None).

    A ViT with trainable parameters runs with plain differentiable attention;
    a frozen one runs under ``torch.no_grad()`` through K1a."""
    cfg = model.config
    lm = model.language_model
    T = batch["packed_position_ids"].shape[0]
    text_embed = mot.embed_tokens(lm, batch["packed_text_ids"])
    # row T: the sink of a padded sequence's padding slots, dropped at the end
    x = torch.zeros((T + 1, cfg.llm.hidden_size), dtype=text_embed.dtype,
                    device=text_embed.device)
    x.index_copy_(0, batch["packed_text_indexes"], text_embed)

    if "vit_patch_tokens" in batch:  # visual understanding branch (bagel.py:248-261)
        args = (model, batch["vit_patch_tokens"], batch["vit_pos_ids"], batch.get("vit_valid"))
        if any(p.requires_grad for p in model.vit_model.parameters()):
            vit_embed = _encode_vit_tokens(*args, dense_attention=True)
        else:
            with torch.no_grad():
                vit_embed = _encode_vit_tokens(*args, dense_attention=False)
        flat = vit_embed.reshape(-1, vit_embed.shape[-1])
        if "vit_token_idx" in batch:  # stripped: the real rows only
            flat = flat.index_select(0, batch["vit_token_idx"])
        x.index_copy_(0, batch["vit_scatter_idx"], flat.to(x.dtype))

    clean = t_shifted = new_bn_state = bn_rows = None
    if "vae_clean_tokens" in batch:  # visual generation branch (bagel.py:263-287)
        clean = batch["vae_clean_tokens"]  # [Nv, 64]
        real = batch["vae_scatter_idx"] < T if is_padded(batch) else None
        if cfg.e2e is not None and cfg.e2e.enable_batch_norm and bn_state is not None:
            # the latent batch-norm on the clean latents (bagel.py:230-231), its statistics
            # over the real rows
            clean, new_bn_state = e2e_vae.latent_batch_norm(
                clean, bn_state, cfg.vae.z_channels, training=True,
                momentum=cfg.e2e.bn_momentum, eps=cfg.e2e.bn_eps, valid=real)
            if real is not None:
                bn_rows = real.sum(dtype=torch.float32)
        t = torch.sigmoid(batch["vae_timesteps_raw"])
        t_shifted = cfg.timestep_shift * t / (1 + (cfg.timestep_shift - 1) * t)
        noise = _flow_noise(batch, clean, noise, generator)
        x_t = (1 - t_shifted[:, None]) * clean + t_shifted[:, None] * noise
        lat = _linear(x_t, model.vae2llm) + time_embed(model, t_shifted)
        lat = lat + model.latent_pos_embed.pos_embed[batch["vae_latent_pos_ids"]]
        x.index_copy_(0, batch["vae_scatter_idx"], lat.to(x.dtype))

    return x[:T], {"noise": noise, "t_shifted": t_shifted, "clean": clean,
                   "bn_state": new_bn_state, "bn_rows": bn_rows}


def _flow_noise(batch, clean: torch.Tensor, noise, generator) -> torch.Tensor:
    """The flow noise of a sequence's latent rows, in their dtype: ``noise``
    or, when None, a draw from ``generator`` of one row per real latent
    token. A padded sequence takes its real rows' noise (drawn, or given as
    the eager step takes it) with zero padding rows, or a [n_pad, 64] tensor
    as it is."""
    n_real = batch.vae_rows if is_padded(batch) else clean.shape[0]
    if noise is None:
        if generator is None:
            raise ValueError("the flow noise is an input: pass noise=, or a torch.Generator "
                             "to draw it from")
        noise = torch.randn((n_real, clean.shape[1]), generator=generator, dtype=torch.float32,
                            device=generator.device).to(clean.device)
    if is_padded(batch) and noise.shape == (n_real, clean.shape[1]) != clean.shape:
        noise = torch.cat([noise.to(clean.device), noise.new_zeros(
            (clean.shape[0] - n_real, clean.shape[1]), device=clean.device)])
    if noise.shape != clean.shape:
        raise ValueError(f"noise must be {tuple(clean.shape)} (one row per latent token, "
                         f"padding rows dropped), got {tuple(noise.shape)}")
    return noise.to(clean.dtype)


def train_losses(
    model: Bagel,
    batch: Dict[str, torch.Tensor],
    h: torch.Tensor,  # [T, C] post-final-norm hidden from forward_train
    stash: Dict,
    features: Optional[torch.Tensor] = None,  # diffusion_feature_layer tap [T, C]
) -> Dict[str, torch.Tensor]:
    """Epilogue of :func:`train_forward`: the CE and rectified-flow MSE
    losses and, under ``cfg.e2e``, the REPA terms (reference
    bagel.py:309-374)."""
    cfg = model.config
    T = h.shape[0]

    def rows(key):  # a padding slot (index T) reads row T - 1; its loss weight is 0
        return batch[key].clamp(max=T - 1)

    out: Dict[str, torch.Tensor] = {}
    if features is not None and "vae_scatter_idx" in batch:
        out["diffusion_features"] = features.index_select(0, rows("vae_scatter_idx"))
    loss = torch.zeros((), dtype=torch.float32, device=h.device)

    if "vae_clean_tokens" in batch:
        h_vae = h.index_select(0, rows("vae_scatter_idx"))
        pred = _linear(h_vae, model.llm2vae).float()
        target = (stash["noise"] - stash["clean"]).float()
        per_tok = torch.mean(torch.square(pred - target), dim=-1)
        # conditioning latents (t_raw -inf or very negative) have t_shifted == 0: no flow loss
        w = batch["mse_weight"].float() * (stash["t_shifted"] > 0)
        out["mse"] = torch.sum(per_tok * w) / torch.clamp(torch.sum(w), min=1.0)
        loss = loss + out["mse"]

    teacher = batch.get("repa_teacher_features") if cfg.e2e is not None else None
    if teacher is not None and "diffusion_features" in out and hasattr(model, "repa_proj"):
        # mid-layer diffusion features against the frozen teacher (bagel.py:63-83)
        out["repa_align"] = e2e_vae.repa_alignment_loss(
            out["diffusion_features"], teacher, model.repa_proj, weight=batch.get("mse_weight"),
            alignment_type=cfg.e2e.repa_alignment_type)
        loss = loss + cfg.e2e.repa_diffusion_coeff * out["repa_align"]
    if teacher is not None and "vae_clean_tokens" in batch and hasattr(model, "repa_vae_proj"):
        # the latents themselves against the teacher (REPA-E style; bagel.py:69), post-BN
        out["repa_vae_align"] = e2e_vae.repa_alignment_loss(
            stash["clean"], teacher, model.repa_vae_proj, weight=batch.get("mse_weight"),
            alignment_type=cfg.e2e.repa_alignment_type)
        loss = loss + cfg.e2e.repa_vae_coeff * out["repa_vae_align"]
    if stash.get("bn_state") is not None:
        out["bn_state"] = stash["bn_state"]
        if stash.get("bn_rows") is not None:
            out["bn_rows"] = stash["bn_rows"]  # its real latent rows (a padded sequence)

    fsdp_head = getattr(model.language_model.lm_head, "fsdp_dim", None) is not None
    if "ce_idx" not in batch and fsdp_head:
        # an FSDP head is gathered over "data" by every data rank, so a sequence without
        # CE rows runs it on none (its collectives, forward and backward, must run)
        loss = loss + mot.lm_head(model.language_model, h[:0]).sum()
    if "ce_idx" in batch:
        h_ce = h.index_select(0, rows("ce_idx"))
        logits = mot.lm_head(model.language_model, h_ce)  # fp32 [Nc, V]
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(1, batch["ce_labels"][:, None])[:, 0]
        w = batch["ce_weight"].float()
        out["ce"] = torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)
        loss = loss + out["ce"]

    out["loss"] = loss
    return out
