"""Sequence-parallel x tensor-parallel denoise (port of
unimedvl_tpu/parallel/sp_denoise.py): the rectified-flow loop of
``models.bagel.generate_latents`` as one program over a ``("model", "seq")``
mesh of ranks, each a process with its own device.

Every rank calls :func:`generate_latents_tp_sp` with its own model, its own
kv heads of the context cache, the full noise and latent inputs and its own
:class:`~unimedvl_tpu_torch.parallel.mesh.Mesh`; the function slices the noise
and the position embeddings for that rank and returns the full latent on
every rank.

  * Megatron tensor parallelism over "model": the model is this rank's shard
    (``parallel.mesh.place_params``: the attention heads and the MLP
    intermediate of both MoT experts, a vocab slice of the embedding), or
    the whole model when "model" has one rank; the cache holds the rank's kv
    heads (``parallel.mesh.shard_kv_heads`` of a whole one). Two all-reduces
    per layer on the local [S, nloc + 2, C] activations. A full-int8 or w4a8
    row-parallel projection quantizes its input over the rank's features
    (per-rank scales), as the JAX shard_map program does.
  * The n latent tokens shard over "seq". The two text rows (<vision_start>,
    <vision_end>) are replicated on every seq rank, so each local block keeps
    the [start, latents..., end] packing contract and the MoT row routing of
    qwen2_mot works unchanged.
  * One all-gather per layer of the block's k (normed and rotated on the
    local shard first) and v latent rows over "seq". Queries shard cleanly:
    latents attend to the whole block and the whole cache, so no attention
    scores are exchanged.
  * The KV cache (the text / image context) shards over kv heads on "model"
    and is replicated over "seq".

Attention. With ``overlap_gather`` (the default) each layer's attention is
two K1c calls, ``flash_block_attention(..., return_lse=True)`` with
``q_preproc``: a cache partial, which needs no collective and runs while the
gathers are in flight, and a block partial over the gathered keys; they are
merged with ``ops.attention.combine_attention_partials``. Without it: gather,
concatenate behind the cache slice, one K1b call. ``flash_block_attention``
picks the kernel or its plain version by the tensors' device, so the JAX
module's third branch (masked softmax in XLA) has no counterpart here.

A mesh of one rank is legal and needs no process group: it is how one card
runs this program. The JAX module's jitted ``shard_map`` scan and its cache
(``_PROGRAM_CACHE``) are :class:`SPProgram`: one captured CUDA graph a flow
step of a cfg-run kind, every collective inside it, kept in the device
programs' registry (``inference/programs.py``), on a mesh whose groups are
all NCCL; a mesh with a gloo group, and ``graphs=False``, run the eager loop
over steps and layers.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from unimedvl_tpu_torch import quant
from unimedvl_tpu_torch.models import bagel
from unimedvl_tpu_torch.models import qwen2_mot as mot
from unimedvl_tpu_torch.models.bagel import Bagel
from unimedvl_tpu_torch.models.layers import QuantLinear
from unimedvl_tpu_torch.models.qwen2_mot import KVCache, _mot_rows
from unimedvl_tpu_torch.ops.act_quant import silu_mul_quant
from unimedvl_tpu_torch.ops.attention import combine_attention_partials
from unimedvl_tpu_torch.ops.flash_attention import flash_block_attention
from unimedvl_tpu_torch.ops.rope import apply_rope_one, rope_cos_sin
from unimedvl_tpu_torch.parallel.mesh import FUSED, Mesh


def gather_block(t: torch.Tensor, mesh: Mesh):
    """Start the all-gather over "seq" of the latent rows of a local block
    t [S, lT, Hkl, D]; the returned function waits for it and gives
    [S, n + 2, Hkl, D]: the gathered rows between the two text rows, which are
    the same on every seq rank and stay local."""
    pending = mesh.all_gather(t[:, 1:-1], "seq", dim=1)

    def finish() -> torch.Tensor:
        return torch.cat([t[:, :1], pending.wait(), t[:, -1:]], dim=1)

    return finish


def _sp_attention(
    x: torch.Tensor,  # [S, lT, C] local block [start, latent chunk, end], normed
    lp: Dict,  # this rank's layer (_layer_view)
    cfg,
    cos_q: torch.Tensor,  # [S, 1, D]: one rope position per stream
    sin_q: torch.Tensor,
    k_cache: torch.Tensor,  # [S, Hkl, M, D] this rank's kv heads (head-major)
    v_cache: torch.Tensor,
    lens: torch.Tensor,
    n_global: int,  # latent tokens over all seq ranks
    mesh: Mesh,
    overlap_gather: bool = False,
) -> torch.Tensor:
    """Gen-mode MoT attention of the local block over the cache and the
    gathered block, the cache left as it is. Returns the attention context
    [S, lT, Hl * D] before the output projection.

    ``overlap_gather``: a cache partial and a block partial (K1c twice,
    merged by their log-sum-exps); both gathers are started before the cache
    partial, whose kernel runs while they are in flight."""
    S, lT, _ = x.shape
    D = cfg.head_dim
    Hl, Hkl = cfg.num_attention_heads, cfg.num_key_value_heads  # the rank's own
    ap = lp["attn"]

    def proj(name):
        return _mot_rows(x, ap[name], ap[name + "_moe_gen"], True, None)

    if "qkv_proj" in ap:  # fused serving layout: the rank's [q|k|v] columns
        q, k, v = proj("qkv_proj").split([Hl * D, Hkl * D, Hkl * D], dim=-1)
    else:
        q, k, v = proj("q_proj"), proj("k_proj"), proj("v_proj")
    q = q.reshape(S, lT, Hl, D).contiguous()  # the kernels read q dense
    k = k.reshape(S, lT, Hkl, D)
    v = v.reshape(S, lT, Hkl, D)
    Tblk = n_global + 2

    def as_cache(t):  # [S, Tblk, Hkl, D] -> a head-major view in the cache's dtype
        return t.to(k_cache.dtype).transpose(1, 2)

    if not cfg.qk_norm:
        q = apply_rope_one(q, cos_q, sin_q).to(x.dtype)
        k_full = gather_block(apply_rope_one(k, cos_q, sin_q).to(x.dtype), mesh)
        v_full = gather_block(v, mesh)
        k_cat = torch.cat([k_cache, as_cache(k_full())], dim=2)
        v_cat = torch.cat([v_cache, as_cache(v_full())], dim=2)
        o = flash_block_attention(q, k_cat, v_cat, lens, k_cache.shape[2], False,
                                  q_valid_len=Tblk, kv_head_major=True)
        return o.reshape(S, lT, Hl * D)

    # the k island (fp32 norm + RoPE) on the local shard, before the gather: its
    # cost shrinks with the seq degree; the q island runs inside the kernel
    k32 = _mot_rows(k.float(), ap["k_norm"], ap["k_norm_moe_gen"], True, None)
    kp = apply_rope_one(k32, cos_q, sin_q).to(x.dtype)
    k_full, v_full = gather_block(kp, mesh), gather_block(v, mesh)
    q_pre = dict(w_und=ap["q_norm"].weight, w_gen=ap["q_norm_moe_gen"].weight, cos=cos_q,
                 sin=sin_q, end_row=None, eps=cfg.rms_norm_eps)
    if overlap_gather:
        # cache partial: the context columns [0, lens) only, no block keys
        part_c = flash_block_attention(
            q, k_cache, v_cache, lens, lens, False, q_valid_len=0, q_preproc=q_pre,
            kv_head_major=True, return_lse=True)
        # block partial: the gathered rows, all visible (as "context" rows)
        part_b = flash_block_attention(
            q, as_cache(k_full()), as_cache(v_full()), Tblk, Tblk, False, q_valid_len=0,
            q_preproc=q_pre, kv_head_major=True, return_lse=True)
        return combine_attention_partials([part_c, part_b]).reshape(S, lT, Hl * D)
    k_cat = torch.cat([k_cache, as_cache(k_full())], dim=2)
    v_cat = torch.cat([v_cache, as_cache(v_full())], dim=2)
    o = flash_block_attention(q, k_cat, v_cat, lens, k_cache.shape[2], False, q_valid_len=Tblk,
                              q_preproc=q_pre, kv_head_major=True)
    return o.reshape(S, lT, Hl * D)


def _owned_text(und_fn, text: torch.Tensor, layer_idx: int, mesh: Mesh) -> torch.Tensor:
    """The und-expert update of the (seq-replicated) text rows, computed on
    one seq rank per layer (owner = layer % sp) and summed over "seq", which
    broadcasts it: the other ranks contribute zeros and skip the und MLP and
    its weight reads. Exact: the owner computes what every rank would have.
    The value is this model rank's partial sum; the caller's all-reduce over
    "model" completes it."""
    owner = mesh.coords["seq"] == layer_idx % mesh.shape["seq"]
    ty = und_fn(text).to(text.dtype) if owner else torch.zeros_like(text)
    mesh.all_reduce(ty, "seq")
    return ty


def _mot_one_text_row(x, und_fn, gen_fn, gen_mode: bool, text_row: Optional[int]):
    """``_mot_rows`` for a chunk of rows of the gen block that holds exactly
    one text row: ``text_row`` 0 (the <vision_start> chunk), -1 (the
    <vision_end> chunk) or None (latent rows only)."""
    if not gen_mode:
        return und_fn(x)
    y = gen_fn(x)
    if text_row is None:
        return y
    sl = slice(0, 1) if text_row == 0 else slice(-1, None)
    y[:, sl] = und_fn(x[:, sl]).to(y.dtype)
    return y


def _per_rank_scales(mod):
    """A row-parallel projection (o, down) as the JAX shard_map program runs
    it: one that quantizes its input takes the absmax over this rank's
    features only, with no all-reduce-max (ROADMAP's recorded difference
    "Full-int8 on a mesh is a different function"); others as they are."""
    if isinstance(mod, QuantLinear) and mod.act_quant:
        return lambda t: quant.quantized_linear_preq(*quant.quantize_activations(t), mod,
                                                     t.dtype)
    return mod


def _layer_view(layer, path: str, tp: int) -> Dict:
    """One decoder layer of this rank's model as the denoise reads it:
    ``{"attn": {...}, "mlp": {...}, "mlp_moe_gen": {...}}`` of its
    projections of both experts (a fused one under its plain name) and q/k
    norms, the MLPs' activations and the layer norms, the row-parallel
    projections through :func:`_per_rank_scales`. A fused leaf laid out for
    a "model" degree (``_tpN``) raises: a rank's model holds its own block
    (``parallel.mesh.place_params``)."""
    def projections(module, where):
        out = {}
        for name, child in module._modules.items():
            base = name[: -len("_moe_gen")] if name.endswith("_moe_gen") else name
            fused = next((f for f in FUSED if base.startswith(f)), None)
            if fused is not None and base != fused:
                raise ValueError(
                    f"{where}.{name}: fused projection layout tp={base[len(fused) + 3:]} != mesh "
                    f"model axis {tp}; give this rank's shard (parallel.mesh.place_params), or "
                    f"re-fuse with quant.fuse_serving_projections(tp=1)")
            if base in ("o_proj", "down_proj"):
                out[name + "_per_rank"] = _per_rank_scales(child)
            out[name] = child
        return out

    attn = layer.self_attn
    view = {"attn": projections(attn, f"{path}.self_attn")}
    for name in ("mlp", "mlp_moe_gen"):
        if hasattr(layer, name):
            mlp = getattr(layer, name)
            view[name] = projections(mlp, f"{path}.{name}")
            view[name]["act"], view[name]["act_is_silu"] = mlp.act, mlp.act_is_silu
    for name in ("input_layernorm", "post_attention_layernorm", "input_layernorm_moe_gen",
                 "post_attention_layernorm_moe_gen"):
        if hasattr(layer, name):
            view[name] = getattr(layer, name)
    return view


def _mlp_fn(norm, mv: Dict):
    """norm -> gate/up -> act -> down on this rank's MLP shard; the result is
    a partial sum over "model". A down projection that quantizes its input
    takes K3 (silu * mul * quant in one pass, per-rank scales), as
    ``Qwen2MLP`` does on one device."""
    down = mv["down_proj"]

    def f(t):
        tn = norm(t)
        if "gate_up_proj" in mv:  # fused: the local [gate_s|up_s] halves
            g, u = mv["gate_up_proj"](tn).chunk(2, dim=-1)
        else:
            g, u = mv["gate_proj"](tn), mv["up_proj"](tn)
        if isinstance(down, QuantLinear) and down.act_quant and mv["act_is_silu"]:
            xq, xs = silu_mul_quant(g, u)
            return quant.quantized_linear_preq(xq, xs, down, t.dtype)
        return mv["down_proj_per_rank"](mv["act"](g) * u)

    return f


def _sp_decoder_layer(
    x, lp, cfg, cos_q, sin_q, k_cache, v_cache, lens, n_global, mesh: Mesh,
    overlap_chunks: int = 1,
    overlap_gather: bool = False,
    layer_idx: Optional[int] = None,
    dedup_text_mlp: bool = False,
):
    """One decoder layer on the local block. ``overlap_chunks`` 2 splits the
    rows after the attention into two chains, each with one text row, and
    starts each chain's all-reduce over "model" asynchronously, so that it
    runs beside the other chain's matmuls; 1 is one chain."""
    dedup = dedup_text_mlp and cfg.use_moe and layer_idx is not None
    ap = lp["attn"]
    residual = x
    h = _mot_rows(x, lp["input_layernorm"], lp["input_layernorm_moe_gen"], cfg.mot_attention,
                  None)
    attn_ctx = _sp_attention(h, lp, cfg, cos_q, sin_q, k_cache, v_cache, lens, n_global, mesh,
                             overlap_gather=overlap_gather)
    und_f = _mlp_fn(lp["post_attention_layernorm"], lp["mlp"])
    gen_f = _mlp_fn(lp["post_attention_layernorm_moe_gen"], lp["mlp_moe_gen"])

    lT = x.shape[1]
    if overlap_chunks <= 1 or lT < 4:
        o = _mot_rows(attn_ctx, ap["o_proj_per_rank"], ap["o_proj_moe_gen_per_rank"], True, None)
        mesh.all_reduce(o, "model")  # the Megatron row-parallel reduction
        x = residual + o
        if dedup:
            h = gen_f(x)
            ty = _owned_text(und_f, torch.cat([x[:, :1], x[:, -1:]], dim=1), layer_idx, mesh)
            h[:, :1] = ty[:, :1].to(h.dtype)
            h[:, -1:] = ty[:, 1:].to(h.dtype)
        else:
            h = _mot_rows(x, und_f, gen_f, cfg.use_moe, None)
        mesh.all_reduce(h, "model")
        return x + h

    def o_proj(ctx, text_row):
        return _mot_one_text_row(ctx, ap["o_proj_per_rank"], ap["o_proj_moe_gen_per_rank"], True,
                                 text_row).contiguous()

    def mlp_block(xc, text_row):
        if not dedup:
            return _mot_one_text_row(xc, und_f, gen_f, cfg.use_moe, text_row).contiguous()
        h = gen_f(xc)
        sl = slice(0, 1) if text_row == 0 else slice(-1, None)
        h[:, sl] = _owned_text(und_f, xc[:, sl].contiguous(), layer_idx, mesh).to(h.dtype)
        return h.contiguous()

    # after the attention the layer is row-wise independent: each chain's reduction is in
    # flight while the other chain computes, and is waited for where its result is read
    half = lT // 2
    chunks = ((slice(0, half), 0), (slice(half, None), -1))
    o_parts = []
    for sl, text_row in chunks:
        o = o_proj(attn_ctx[:, sl], text_row)
        o_parts.append((o, mesh.all_reduce(o, "model", async_op=True)))
    x_parts, h_parts = [], []
    for (sl, text_row), (o, work) in zip(chunks, o_parts):
        if work is not None:
            work.wait()
        xc = residual[:, sl] + o
        h = mlp_block(xc, text_row)
        x_parts.append(xc)
        h_parts.append((h, mesh.all_reduce(h, "model", async_op=True)))
    outs = []
    for xc, (h, work) in zip(x_parts, h_parts):
        if work is not None:
            work.wait()
        outs.append(xc + h)
    return torch.cat(outs, dim=1)


def _sp_step(
    model: Bagel,
    views: list,  # this model rank's view of every layer
    se: torch.Tensor,  # [2, C] start / end token embeddings
    pos_emb: torch.Tensor,  # [nloc, C] local latent position embeddings
    caches: KVCache,  # this rank's kv heads [L, S, Hkl, M, D]
    positions: torch.Tensor,  # [S]
    x_t: torch.Tensor,  # [nloc, p*p*z] fp32 flow state
    t_emb: torch.Tensor,  # the step's timestep embedding, [C] or [1, C] fp32
    dt,  # the step's dt: a float, or a [1] fp32 tensor read on the device
    scales: Optional[Tuple[float, float]],  # (text, img) CFG scales; None: the main stream
    n_global: int,
    statics: Dict,
    mesh: Mesh,
    overlap_chunks: int = 1,
    overlap_gather: bool = False,
    dedup_text_mlp: bool = False,
) -> torch.Tensor:
    """One flow step of one rank: every stream of ``caches`` when ``scales``
    is given (the CFG interval), else the main stream alone. Returns the
    next local state [nloc, p*p*z] fp32. The eager loop and
    :class:`SPProgram`'s graphs run this body."""
    llm = model.config.llm
    lm = model.language_model.model
    nloc = x_t.shape[0]
    n_streams = caches.k.shape[1] if scales is not None else 1
    step_caches = caches if scales is not None else caches.streams(1)
    cos_q, sin_q = rope_cos_sin(positions[:n_streams, None], llm.head_dim, llm.rope_theta)
    x_lat = (bagel._linear(x_t, model.vae2llm) + t_emb + pos_emb).to(se.dtype)
    block = torch.cat([se[:1], x_lat, se[1:]], dim=0)  # [nloc + 2, C]
    h = block[None].expand(n_streams, -1, -1)
    for li, lp in enumerate(views):
        h = _sp_decoder_layer(
            h, lp, llm, cos_q, sin_q, step_caches.k[li], step_caches.v[li], step_caches.lens,
            n_global, mesh, overlap_chunks=overlap_chunks, overlap_gather=overlap_gather,
            layer_idx=li, dedup_text_mlp=dedup_text_mlp,
        )
    h = _mot_rows(h, lm.norm, lambda t: lm.norm_moe_gen(t), llm.use_moe, None)
    v_all = bagel._linear(h[:, 1:nloc + 1], model.llm2vae)  # [ns, nloc, p*p*z]
    v = v_all[0]
    if scales is not None:
        use_text_cfg, use_img_cfg = statics["use_text_cfg"], statics["use_img_cfg"]
        v_text = v_all[1] if use_text_cfg else v
        v_img = v_all[1 + int(use_text_cfg)] if use_img_cfg else v
        v = bagel._cfg_combine(
            v, v_text, v_img, scales[0], scales[1], statics["cfg_renorm_min"],
            statics["cfg_renorm_type"], use_text_cfg, use_img_cfg, seq_group=mesh.groups["seq"],
        )
    return x_t - v.float() * dt


def _views(model: Bagel, mesh: Mesh) -> list:
    return [_layer_view(layer, f"layers.{i}", mesh.shape["model"])
            for i, layer in enumerate(model.language_model.model.layers)]


def _denoise_body(
    model: Bagel,
    se: torch.Tensor,  # [2, C] start / end token embeddings
    pos_emb: torch.Tensor,  # [nloc, C] local latent position embeddings
    caches: KVCache,  # this rank's kv heads [L, S, Hkl, M, D]
    positions: torch.Tensor,  # [S]
    noise: torch.Tensor,  # [nloc, p*p*z]
    schedule,  # host arrays (ts, dts, text_scales, img_scales, runs)
    n_global: int,
    statics: Dict,
    mesh: Mesh,
    **opts,
) -> torch.Tensor:
    """One rank's part of the denoise loop, eagerly: Python loops over the
    CFG runs, the steps and the layers (:func:`_sp_step`). Returns the local
    final latents [nloc, p*p*z]."""
    S = caches.k.shape[1]
    ts, dts, text_scales, img_scales, runs = schedule
    views = _views(model, mesh)
    # every step's timestep embedding in one call: no host-to-device copy per step
    t_emb = bagel.time_embed(model, torch.from_numpy(ts).to(noise.device))  # [steps, C] fp32
    x_t = noise.float()
    for run_start, run_end, cfg_on in runs:
        cfg_on = cfg_on and S > 1
        for i in range(run_start, run_end):
            scales = (float(text_scales[i]), float(img_scales[i])) if cfg_on else None
            x_t = _sp_step(model, views, se, pos_emb, caches, positions, x_t, t_emb[i],
                           float(dts[i]), scales, n_global, statics, mesh, **opts)
    return x_t


class SPProgram:
    """One rank's part of the sequence-parallel denoise as a device program,
    as ``bagel.FlowProgram`` is the single-device loop's: one captured graph
    is one flow step (:func:`_sp_step`) of a cfg-run kind ("all": every
    stream, in the CFG interval, its scales baked in; "main": the main
    stream), over static buffers: the local state ``x_t`` (fp32), the step
    index ``i`` (0-dim int64), and the step's timestep embedding and dt read
    at ``i`` from device arrays. Every collective of the step runs inside the
    graph: the gathers of the block's k and v over "seq"
    (:func:`gather_block`), the overlap chunks' all-reduces over "model", the
    text rows' broadcast over "seq" and the renorm's sums. The caches (this
    rank's kv heads), the positions, the local latent position embeddings and
    the <vision_start/end> embeddings are copied in at every call; the final
    gather over "seq" runs after the replays. Keyed by the geometry, the
    schedule and CFG options, the overlap options, the weights and the mesh
    (``programs.mesh_key``)."""

    def __init__(self, model: Bagel, caches: KVCache, positions: torch.Tensor, nloc: int, d: int,
                 n_global: int, schedule, statics: Dict, opts: Dict, mesh: Mesh,
                 cfg_scales: Tuple[float, float]):
        from unimedvl_tpu_torch.inference import programs

        dev = caches.k.device
        self._model = programs.model_ref(model)
        self.mesh, self.n_global, self.statics, self.opts = mesh, n_global, statics, opts
        self.caches = bagel.static_cache(caches)
        self.positions = torch.zeros_like(positions)
        C = model.config.llm.hidden_size
        self.pos_emb = torch.zeros((nloc, C), dtype=model.latent_pos_embed.pos_embed.dtype,
                                   device=dev)
        self.se = torch.zeros((2, C), dtype=model.language_model.model.embed_tokens.weight.dtype,
                              device=dev)
        self.x_t = torch.zeros((nloc, d), dtype=torch.float32, device=dev)
        self.i = torch.zeros((), dtype=torch.int64, device=dev)
        ts, dts, _, _, self.runs = schedule
        self.t_emb = bagel.time_embed(model, torch.from_numpy(ts).to(dev))  # [steps, C] fp32
        self.dts = torch.from_numpy(dts).to(dev)
        self.cfg_scales = cfg_scales
        self._graphs = {}
        self.device = dev

    @classmethod
    def get(cls, model: Bagel, caches: KVCache, positions: torch.Tensor, nloc: int, d: int,
            n_global: int, schedule_kw: Dict, statics: Dict, opts: Dict, mesh: Mesh):
        from unimedvl_tpu_torch.inference import programs

        mods = (model.language_model, model.vae2llm, model.llm2vae, model.time_embedder,
                model.latent_pos_embed)
        key = ("sp", nloc, d, n_global, bagel._cache_kind(caches), tuple(positions.shape),
               positions.dtype, tuple(sorted(schedule_kw.items())),
               tuple(sorted(statics.items())), tuple(sorted(opts.items())),
               programs.weights_key(*mods), programs.mesh_key(model, mesh))
        # a cfg run's scales, as the eager loop's float32 schedule holds them
        scales = (float(np.float32(schedule_kw["cfg_text_scale"])),
                  float(np.float32(schedule_kw["cfg_img_scale"])))
        return programs.lookup(key, lambda: cls(model, caches, positions, nloc, d, n_global,
                                                _schedule(**schedule_kw), statics, opts, mesh,
                                                scales),
                               reads=mods, owner=model.language_model)

    def graphs(self):
        return list(self._graphs.values())

    def _graph(self, cfg_on: bool):
        from unimedvl_tpu_torch.inference import programs

        kind = "all" if cfg_on else "main"
        if kind not in self._graphs:
            self._graphs[kind] = programs.Graph(
                "denoise", lambda: self._body(cfg_on), self.device, keep=(self.x_t, self.i),
                rows=self.caches.k.shape[1] if cfg_on else 1)
        return self._graphs[kind]

    def _body(self, cfg_on: bool) -> None:
        model = self._model()
        i = self.i.view(1)
        x_t = _sp_step(model, _views(model, self.mesh), self.se, self.pos_emb, self.caches,
                       self.positions, self.x_t, self.t_emb.index_select(0, i),
                       self.dts.index_select(0, i), self.cfg_scales if cfg_on else None,
                       self.n_global, self.statics, self.mesh, **self.opts)
        self.x_t.copy_(x_t)
        self.i.add_(1)

    def run(self, se, pos_emb, caches, positions, noise) -> torch.Tensor:
        bagel._copy_cache(self.caches, caches)
        self.positions.copy_(positions)
        self.pos_emb.copy_(pos_emb)
        self.se.copy_(se)
        self.x_t.copy_(noise)
        S = caches.k.shape[1]
        for run_start, run_end, cfg_on in self.runs:
            graph = self._graph(cfg_on and S > 1)
            self.i.fill_(run_start)
            for _ in range(run_start, run_end):
                graph.replay()
        return self.x_t.clone()


def _check_layout(model: Bagel, caches: KVCache, n: int, mesh: Mesh, axes: Tuple[str, ...]):
    """The model must be this "model" rank's (a whole model only when the
    axis has one rank) and the caches must hold its kv heads."""
    if mesh.axis_names != axes:
        raise ValueError(f"the mesh must have the axes {axes}, got {mesh.axis_names}")
    if caches.quantized:
        raise ValueError("int8 KV caches are a serving-decode feature; the sequence-parallel "
                         "denoise reads the (small) context cache in the model's dtype")
    llm = model.config.llm
    tp, sp = mesh.shape["model"], mesh.shape["seq"]
    if n % sp:
        raise ValueError(f"{n} latent tokens do not split over seq={sp}")
    placed = getattr(model.language_model, "mesh", None)
    if placed is None and tp > 1:
        raise ValueError(f"over model={tp} the denoise takes this rank's model: "
                         "parallel.mesh.place_params(model, mesh)")
    if placed is not None and (placed.shape.get("model", 1), placed.coords.get("model", 0)) != (
            tp, mesh.coords["model"]):
        raise ValueError(
            f"the model is the shard of model rank {placed.coords.get('model', 0)} of "
            f"{placed.shape.get('model', 1)}; this mesh wants rank {mesh.coords['model']} "
            f"of {tp}: the two meshes must span the same ranks in the same order")
    if caches.k.shape[2] != llm.num_key_value_heads:
        raise ValueError(f"the caches hold {caches.k.shape[2]} kv heads, this rank's model "
                         f"{llm.num_key_value_heads}: parallel.mesh.shard_kv_heads")
    if not llm.mot_attention:
        raise ValueError("the sequence-parallel denoise routes through the MoT gen twins: "
                         "the config needs mot_attention")


def _schedule(num_timesteps, timestep_shift, cfg_text_scale, cfg_img_scale, cfg_interval):
    """The host-side schedule, as ``generate_latents`` makes it."""
    ts, dts = bagel.flow_timesteps(num_timesteps, timestep_shift)
    lo, hi = cfg_interval
    in_interval = (ts > lo) & (ts <= hi)
    text_scales = np.where(in_interval, cfg_text_scale, 1.0).astype(np.float32)
    img_scales = np.where(in_interval, cfg_img_scale, 1.0).astype(np.float32)
    return ts, dts, text_scales, img_scales, bagel._cfg_runs(in_interval)


def _denoise_on_rank(model, caches, positions, latent_pos_ids, init_noise, start_end_ids, mesh,
                     schedule_kw, statics, opts, graphs):
    """Slice the latent rows for this seq rank, run its part (by the route
    of ``graphs``: its :class:`SPProgram` or the eager loop), and gather the
    latents over "seq": the full [n, p*p*z] on every rank."""
    from unimedvl_tpu_torch.inference import programs

    sp, s_rank = mesh.shape["seq"], mesh.coords["seq"]
    n = init_noise.shape[0]
    nloc = n // sp
    rows = slice(s_rank * nloc, (s_rank + 1) * nloc)
    se = mot.embed_tokens(model.language_model, start_end_ids)
    pos_emb = model.latent_pos_embed.pos_embed[latent_pos_ids][rows]
    noise = init_noise[rows]
    if programs.use_graphs(graphs, noise.device, model, mesh):
        prog = SPProgram.get(model, caches, positions, nloc, noise.shape[-1], n, schedule_kw,
                             statics, opts, mesh)
        x0 = prog.run(se, pos_emb, caches, positions, noise)
    else:
        x0 = _denoise_body(model, se, pos_emb, caches, positions, noise,
                           _schedule(**schedule_kw), n, statics, mesh, **opts)
    return mesh.all_gather(x0, "seq", dim=0).wait()


def _options(num_timesteps, timestep_shift, cfg_text_scale, cfg_img_scale, cfg_interval,
             cfg_renorm_min, cfg_renorm_type, use_text_cfg, use_img_cfg, overlap_chunks,
             overlap_gather, dedup_text_mlp):
    """(schedule, statics, opts) keyword dicts of the entry points' options."""
    return (dict(num_timesteps=num_timesteps, timestep_shift=timestep_shift,
                 cfg_text_scale=cfg_text_scale, cfg_img_scale=cfg_img_scale,
                 cfg_interval=tuple(cfg_interval)),
            dict(cfg_renorm_min=cfg_renorm_min, cfg_renorm_type=cfg_renorm_type,
                 use_text_cfg=use_text_cfg, use_img_cfg=use_img_cfg),
            dict(overlap_chunks=overlap_chunks, overlap_gather=overlap_gather,
                 dedup_text_mlp=dedup_text_mlp))


@torch.no_grad()
def generate_latents_tp_sp(
    model: Bagel,  # this "model" rank's (parallel.mesh.place_params); whole at model=1
    caches: KVCache,  # [L, S_cfg, Hkl, M, D]: this rank's kv heads, on its device
    positions: torch.Tensor,  # [S_cfg]
    latent_pos_ids: torch.Tensor,  # [n]
    init_noise: torch.Tensor,  # [n, p*p*z]
    start_end_ids: torch.Tensor,  # [2]
    mesh: Mesh,
    num_timesteps: int = 50,
    timestep_shift: float = 3.0,
    cfg_text_scale: float = 1.0,
    cfg_img_scale: float = 1.0,
    cfg_interval: Tuple[float, float] = (0.0, 1.0),
    cfg_renorm_min: float = 0.0,
    cfg_renorm_type: str = "global",
    use_text_cfg: bool = False,
    use_img_cfg: bool = False,
    overlap_chunks: int = 2,
    overlap_gather: bool = True,
    dedup_text_mlp: bool = True,
    graphs: Optional[bool] = None,
) -> torch.Tensor:
    """The rectified-flow denoise over a ("model", "seq") mesh; the same
    function as ``models.bagel.generate_latents`` (any (tp, sp) whose heads
    ``parallel.mesh.head_split`` splits, with ``n % sp == 0``). Called by
    every rank of the mesh with its model and kv heads and the same full
    latent inputs; returns x_0 [n, p*p*z] fp32 on every rank.

    ``overlap_chunks``: 2 (default) splits each layer's chain after the
    attention into two row-independent chunks whose all-reduces over "model"
    overlap the other chunk's compute (``_sp_decoder_layer``); 1 is one chain.
    ``overlap_gather``: split each layer's attention into a cache partial and
    a gathered-block partial (two K1c calls and a merge), so that the
    all-gather over "seq" overlaps the cache partial (``_sp_attention``).
    ``dedup_text_mlp``: the und-expert MLP of the two seq-replicated text rows
    runs on one seq rank per layer (owner = layer % sp) and a small all-reduce
    broadcasts it, instead of every rank reading the und MLP shard for them.
    Exact.

    ``graphs`` (``inference.programs.use_graphs``, over the model's mesh and
    ``mesh``): by default, on a CUDA device whose groups are all NCCL, each
    flow step replays a captured graph (:class:`SPProgram`) with every
    collective inside it; on a mesh with a gloo group, and with
    ``graphs=False``, the eager loop, the program's plain version."""
    _check_layout(model, caches, init_noise.shape[0], mesh, ("model", "seq"))
    schedule_kw, statics, opts = _options(
        num_timesteps, timestep_shift, cfg_text_scale, cfg_img_scale, cfg_interval,
        cfg_renorm_min, cfg_renorm_type, use_text_cfg, use_img_cfg, overlap_chunks,
        overlap_gather, dedup_text_mlp)
    return _denoise_on_rank(model, caches, positions, latent_pos_ids, init_noise, start_end_ids,
                            mesh, schedule_kw, statics, opts, graphs)


@torch.no_grad()
def generate_latents_dp_tp_sp(
    model: Bagel,
    group_caches,  # list[G] of KVCache [L, S_cfg, Hkl, M, D] (this rank's kv heads)
    group_positions,  # list[G] of [S_cfg]
    group_latent_pos_ids,  # list[G] of [n]
    group_init_noise,  # list[G] of [n, p*p*z]
    start_end_ids: torch.Tensor,  # [2]
    mesh: Mesh,  # ("data", "model", "seq")
    num_timesteps: int = 50,
    timestep_shift: float = 3.0,
    cfg_text_scale: float = 1.0,
    cfg_img_scale: float = 1.0,
    cfg_interval: Tuple[float, float] = (0.0, 1.0),
    cfg_renorm_min: float = 0.0,
    cfg_renorm_type: str = "global",
    use_text_cfg: bool = False,
    use_img_cfg: bool = False,
    overlap_chunks: int = 2,
    overlap_gather: bool = True,
    dedup_text_mlp: bool = True,
    graphs: Optional[bool] = None,
) -> torch.Tensor:
    """G = mesh.shape["data"] independent images denoised at once, each on its
    own ("model", "seq") sub-mesh; the groups share the schedule and the CFG
    settings and have one geometry. ``model``: this rank's, as for
    :func:`generate_latents_tp_sp`. Every rank is given every group's inputs
    and runs its own group's program (the data axis carries no collective
    until the end); returns x_0 stacked [G, n, p*p*z] on every rank.
    ``graphs`` as there: a rank's group runs its :class:`SPProgram`."""
    G = mesh.shape.get("data", 0)
    if len(group_caches) != G:
        raise ValueError(f"{len(group_caches)} groups for a data axis of {G}")
    g = mesh.coords["data"]
    _check_layout(model, group_caches[g], group_init_noise[g].shape[0], mesh,
                  ("data", "model", "seq"))
    if any(c.quantized for c in group_caches):
        raise ValueError("int8 KV caches are not supported in the sequence-parallel denoise")
    schedule_kw, statics, opts = _options(
        num_timesteps, timestep_shift, cfg_text_scale, cfg_img_scale, cfg_interval,
        cfg_renorm_min, cfg_renorm_type, use_text_cfg, use_img_cfg, overlap_chunks,
        overlap_gather, dedup_text_mlp)
    x0 = _denoise_on_rank(model, group_caches[g], group_positions[g], group_latent_pos_ids[g],
                          group_init_noise[g], start_end_ids, mesh, schedule_kw, statics, opts,
                          graphs)
    return mesh.all_gather(x0[None], "data", dim=0).wait()
