"""Dry run of serving over a ("data", "model") mesh on spawned CPU ranks: the
real programs (``InterleaveInferencer(mesh=...)``, ``ContinuousBatcher(mesh=...)``)
over real collectives (``torch.distributed``, gloo), at a tiny config with
random weights from a seed, held against the same calls on one device. The
port's counterpart of the serving part of the JAX package's multi-chip dry
run.

    python -m unimedvl_tpu_torch.tools.dryrun_mesh --device cpu --tp 4 --dp 2
    python -m unimedvl_tpu_torch.tools.dryrun_mesh --device cpu --tp 2 --dp 1

Prints one JSON line: the mesh, whether every rank's chat answer and batcher
answers equal the single device's, and the seconds the ranks took. Exits
non-zero if they differ. ``--device cuda`` (the default) runs the one mesh a
single card holds, 1 x 1, on the card; meshes of several ranks run on the CPU,
one process per rank.

``run_mesh_cases`` is also what the tests spawn (tests/test_torch_mesh.py,
test_torch_serving_mesh.py, test_torch_sharded_load.py): one set of ranks runs
a list of cases, so that a test file pays for one spawn per mesh shape. The
functions live here because a spawned child imports its target's module, and
the test modules import jax.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from unimedvl_tpu_torch.config import BagelConfig, LLMConfig, VAEConfig, ViTConfig
from unimedvl_tpu_torch.models import bagel
from unimedvl_tpu_torch.parallel import mesh as pmesh

# the JAX package's tests/test_pipeline.py TINY geometry, on which the mesh tests run
TINY = BagelConfig(
    llm=LLMConfig(vocab_size=300, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, rope_theta=10000.0),
    vit=ViTConfig(hidden_size=24, intermediate_size=48, num_hidden_layers=2,
                  num_attention_heads=2, image_size=32, patch_size=2, rope=False),
    vae=VAEConfig(resolution=32, downsample=4, ch=32, ch_mult=(1, 2, 2), num_res_blocks=1,
                  z_channels=4),
    latent_patch_size=2, max_latent_size=8, vit_max_num_patch_per_side=16,
)
VAE_T, VIT_T = (32, 8, 8, 1024), (32, 8, 2, 1024)  # the tests' ImageTransform arguments


class CharTokenizer:
    """One id per character (``ord % 256``), special tokens from 256 up: the
    JAX package's test tokenizer, so that both packages' strings compare."""

    def __init__(self):
        self.specials = {}
        self.special_tokens_map = {}

    def add_tokens(self, tokens):
        for t in tokens:
            if t not in self.specials:
                self.specials[t] = 256 + len(self.specials)
        return len(tokens)

    def convert_tokens_to_ids(self, tok):
        return self.specials[tok]

    def encode(self, text):
        return [ord(c) % 256 for c in text]

    def decode(self, ids):
        inv = {v: k for k, v in self.specials.items()}
        return "".join(inv.get(i, chr(i)) for i in ids)


def tokenizer():
    from unimedvl_tpu_torch.data.tokenizer import add_special_tokens

    tok, ids, _ = add_special_tokens(CharTokenizer())
    return tok, ids


def inferencer(model, mesh, **kw):
    from unimedvl_tpu_torch.data import imaging
    from unimedvl_tpu_torch.inference import InterleaveInferencer

    tok, ids = tokenizer()
    return InterleaveInferencer(model, tok, ids, vae_transform=imaging.ImageTransform(*VAE_T),
                                vit_transform=imaging.ImageTransform(*VIT_T), mesh=mesh, **kw)


def _replay(inf, noises):
    draws = iter(noises)
    inf._randn = lambda shape: torch.from_numpy(np.array(next(draws))).reshape(shape)


def latent_recipe(inf, case) -> torch.Tensor:
    """The JAX mesh tests' latent recipe (tests/test_pipeline_mesh.py): text
    to image, or with ``case["image"]`` an edit (the image's VAE and ViT
    tokens, the cfg_text context after it), up to the final latent."""
    gen = inf.init_gen_context()
    cfg_img = gen.fork()
    if case.get("image") is not None:
        gen = inf.update_context_image(case["image"], gen, vae=True, vit=True)
    cfg_text = gen.fork()
    gen = inf.update_context_text(case["text"], gen)
    cfg_img = inf.update_context_text(case["text"], cfg_img)
    return inf.gen_image_latent(case.get("shape", (16, 16)), gen, cfg_text_precontext=cfg_text,
                                cfg_img_precontext=cfg_img, **case["gen_kw"])


def serve(model, mesh, case):
    """A ``ContinuousBatcher`` over ``case["requests"]`` ((prompt, image or
    None, max_new_tokens) tuples; with ``case["t2i"]`` also text-to-image
    requests ((prompt, (H, W), gen_params)) through ``pipeline=``, an
    inferencer of the same mesh): (rids, answers by rid — an image as a
    uint8 array —, sorted error rids, emitted tokens)."""
    from unimedvl_tpu_torch.data import imaging
    from unimedvl_tpu_torch.inference.serving import ContinuousBatcher, Request

    tok, ids = tokenizer()
    pipe = inferencer(model, mesh, graphs=case["batch_kw"].get("graphs")) if case.get("t2i") \
        else None
    b = ContinuousBatcher(model, tok, ids, vit_transform=imaging.ImageTransform(*VIT_T),
                          mesh=mesh, pipeline=pipe, **case["batch_kw"])
    pid = b.register_prefix(case["prefix"]) if case.get("prefix") else None
    rids = []
    for prompt, image, max_new in case["requests"]:
        img = None if image is None else imaging.Image.fromarray(image)
        rids.append(b.submit(Request(prompt=prompt, image=img, max_new_tokens=max_new,
                                     prefix_id=pid)))
    for prompt, size, gen_params in case.get("t2i", ()):
        rids.append(b.submit(Request(prompt=prompt, image_size=size, gen_params=gen_params)))
    done = {r: v if isinstance(v, str) else np.asarray(v) for r, v in b.run().items()}
    return rids, done, sorted(b.errors), int(b.stats["emitted_tokens"])


def vqa_eval(model, mesh, case):
    from unimedvl_tpu_torch.data import imaging
    from unimedvl_tpu_torch.eval import vqa

    vqa.build_transform = lambda: imaging.ImageTransform(*VIT_T)
    tok, ids = tokenizer()
    samples = [dict(s, image=None if s["image"] is None else imaging.Image.fromarray(s["image"]))
               for s in case["samples"]]
    return vqa.run_vqa_eval(model, tok, ids, samples, mesh=mesh, **case["kw"])


def shard_bytes(model) -> Dict[str, int]:
    """Bytes of the LLM's tensors a mesh shards (projections of both
    experts, embedding, lm_head) and of the rest, of a rank's model."""
    out = {"sharded": 0, "whole": 0}
    for key, t in model.state_dict().items():
        sharded = key.startswith("language_model.") and (
            key.startswith(pmesh.EMBED) or key.startswith(pmesh.HEAD)
            or any(f".{n}" in key for n in pmesh.COL + pmesh.ROW + pmesh.FUSED))
        out["sharded" if sharded else "whole"] += t.numel() * t.element_size()
    return out


def _replayed_draws(gumbels):
    """``bagel._exp_noise`` replaying the JAX loop's Gumbel draws g as the
    exponential draws exp(-g) (argmax(probs / q) is then the JAX categorical
    draw), in order."""
    draws = iter(gumbels)
    return lambda like, generator: torch.exp(-torch.from_numpy(np.array(next(draws)))).to(like)


def run_case(model, mesh, case):
    """One case on this rank (see :func:`run_mesh_cases`). A case's
    ``inf_kw`` / ``batch_kw`` reach the inferencer / batcher, ``graphs``
    among them (True: the device programs' plain route on the CPU); a chat
    case with ``sample`` (temperature, Gumbel draws) samples with the draws
    replayed."""
    kind = case["kind"]
    if kind == "chat":
        inf = inferencer(model, mesh, **case.get("inf_kw", {}))
        sample = case.get("sample")
        if sample is None:
            return inf.chat(case["images"], case["prompt"], max_length=case.get("max_length", 8))
        real = bagel._exp_noise
        bagel._exp_noise = _replayed_draws(sample["gumbels"])
        try:
            return inf.chat(case["images"], case["prompt"], max_length=case.get("max_length", 8),
                            do_sample=True, temperature=sample["temperature"])
        finally:
            bagel._exp_noise = real
    if kind == "latent":
        inf = inferencer(model, mesh, **case.get("inf_kw", {}))
        _replay(inf, case["noises"])
        return latent_recipe(inf, case).numpy()
    if kind == "serve":
        return serve(model, mesh, case)
    if kind == "vqa":
        return vqa_eval(model, mesh, case)
    if kind == "grouped":
        gmesh = pmesh.make_mesh(("data", "model", "seq"), case["sizes"])
        inf = inferencer(model, None, **case.get("inf_kw", {}))
        _replay(inf, case["noises"])
        ctxs, texts, imgs = [], [], []
        for prompt in case["texts"]:
            gen = inf.init_gen_context()
            cfg_img, cfg_text = gen.fork(), gen.fork()
            ctxs.append(inf.update_context_text(prompt, gen))
            imgs.append(inf.update_context_text(prompt, cfg_img))
            texts.append(cfg_text)
        return inf.gen_image_latents_grouped(case.get("shape", (16, 16)), ctxs, gmesh,
                                             cfg_text_precontexts=texts,
                                             cfg_img_precontexts=imgs, **case["gen_kw"]).numpy()
    if kind == "place":
        return shard_bytes(pmesh.place_params(model, mesh))
    if kind == "load":
        import copy

        from unimedvl_tpu_torch import quant
        from unimedvl_tpu_torch.weights.loader import from_jax_params, load_bagel_checkpoint

        qkw = case.get("quant") or {}
        loaded = load_bagel_checkpoint(case["ckpt"], cfg=case.get("cfg"), device="cpu",
                                       dtype=torch.float32, mesh=mesh, **qkw)
        if qkw:  # the whole model quantized, then placed
            whole = copy.deepcopy(model)
            quant.quantize_llm_params(whole.language_model, bits=qkw["quantize_bits"],
                                      act_quant=qkw.get("act_quant", False))
            refs = [pmesh.place_params(whole, mesh)]
        else:
            refs = [pmesh.place_params(model, mesh),
                    from_jax_params(case["tree"], case["cfg"], device="cpu", mesh=mesh)]
        a = loaded.state_dict()
        same = [a.keys() == r.state_dict().keys()
                and all(torch.equal(a[k], r.state_dict()[k]) for k in a) for r in refs]
        inf = inferencer(loaded, mesh)
        return dict(same=same, bytes=shard_bytes(loaded),
                    chat=inf.chat(case["images"], case["prompt"], max_length=6))
    raise ValueError(f"unknown case kind {kind!r}")


def run_mesh_cases(rank: int, world: int, axes, sizes, models, cases: List[Dict]) -> list:
    """On one rank of a mesh ``axes`` x ``sizes``: each case of ``cases`` on
    the model ``models[case["model"]]`` (a dict of whole CPU models, or one
    model), through :func:`run_case`. A case is a dict with ``kind``
    ("chat", "latent", "serve", "vqa", "grouped", "place", "load") and its
    inputs (numpy arrays and plain values). Returns each case's result;
    with ``record`` in a case, under :class:`GlobalScaleCheck`: ``(result,
    (q, scale) of K3's second entry's first call, the check's stats)``."""
    mesh = pmesh.make_mesh(axes, sizes)
    out = []
    for case in cases:
        model = models[case.get("model", "base")] if isinstance(models, dict) else models
        if case.get("record"):
            with GlobalScaleCheck(mesh) as check:
                res = run_case(model, mesh, case)
            out.append((res, check.first, check.stats))
        else:
            out.append(run_case(model, mesh, case))
    return out


class GlobalScaleCheck:
    """Holds every call of K3's second entry on this rank
    (``qwen2_mot.silu_mul_quant_global``, the whole row's scales) to the
    function of one rank on the same input: up to ``rows`` of the rank's
    (g, u) rows, evenly spaced, are gathered over "model" into whole rows,
    the first entry (``ops.act_quant.silu_mul_quant``, what the one-rank
    model's MLP calls) quantizes them, and the rank's columns of its q and
    its scales are compared with what the second entry gave. The control is
    the first entry on the rank's own columns (per-rank scales, the JAX
    shard_map function): its scales must differ, or the check could not
    tell the two functions apart. ``stats``: calls, the largest q step, the
    largest share of q differing, the largest scale relative error, and the
    control's largest scale relative error and the share of all the checked
    rows whose scale it moves. ``first``: (q, scale) of the first call,
    numpy."""

    def __init__(self, mesh, rows: int = 64):
        self.mesh, self.rows = mesh, rows
        self.first = None
        self.stats = dict(calls=0, rows=0, max_step=0, max_share=0.0, max_scale_rel=0.0,
                          per_rank_max_scale_rel=0.0, per_rank_rows_differ=0.0)
        self._differ = 0

    def __enter__(self):
        from unimedvl_tpu_torch.models import qwen2_mot

        self._real = qwen2_mot.silu_mul_quant_global
        qwen2_mot.silu_mul_quant_global = self._call
        return self

    def __exit__(self, *exc):
        from unimedvl_tpu_torch.models import qwen2_mot

        qwen2_mot.silu_mul_quant_global = self._real

    def _call(self, g, u, reduce_max):
        from unimedvl_tpu_torch.ops import act_quant

        q, s = self._real(g, u, reduce_max)
        if self.first is None:
            self.first = (q.cpu().numpy(), s.cpu().numpy())
        I = g.shape[-1]
        R = g.numel() // I
        if R == 0:  # every rank routes the same rows: all skip together
            return q, s
        rows = torch.linspace(0, R - 1, min(R, self.rows), device=g.device).round().long()
        g2, u2 = g.reshape(R, I)[rows].contiguous(), u.reshape(R, I)[rows].contiguous()
        q1, s1 = act_quant.silu_mul_quant(self.mesh.gather(g2, "model", dim=-1),
                                          self.mesh.gather(u2, "model", dim=-1))
        m = self.mesh.coords.get("model", 0)
        mine, s_mine = q.reshape(R, I)[rows], s.reshape(R)[rows]
        step = (mine.int() - q1[:, m * I:(m + 1) * I].int()).abs()
        whole = s1.reshape(-1)
        rel = ((s_mine - whole).abs() / whole).max().item()
        _, s_rank = act_quant.silu_mul_quant(g2, u2)
        control = (s_rank.reshape(-1) - whole).abs() / whole
        st = self.stats
        st["calls"] += 1
        st["rows"] += int(rows.numel())
        self._differ += int((control > 1e-6).sum().item())
        st["max_step"] = max(st["max_step"], int(step.max().item()))
        st["max_share"] = max(st["max_share"], (step > 0).float().mean().item())
        st["max_scale_rel"] = max(st["max_scale_rel"], rel)
        st["per_rank_max_scale_rel"] = max(st["per_rank_max_scale_rel"], control.max().item())
        st["per_rank_rows_differ"] = self._differ / st["rows"]
        return q, s


# ---------------------------------------------------------------------------
# tensor parallelism on one card: ranks that build only their shard
# ---------------------------------------------------------------------------

@torch.no_grad()
def random_rank_model(cfg: BagelConfig, mesh, seed: int, device, dtype=torch.bfloat16,
                      with_vae: bool = False, llm2vae_zero: bool = False):
    """This rank's shard (``parallel.mesh.build_rank_model``) of the model
    ``bagel.init_random_`` draws from a generator on ``device`` seeded with
    ``seed``, without the whole model: ``init_random_``'s draws are replayed
    in its order, one tensor at a time, each full tensor drawn into a scratch
    buffer of its own shape and dtype (so the generator advances as it does
    there) and only the rank's part kept. The peak is one full tensor beside
    the shard (the lm_head's, 1.09 GB at the 14B width)."""
    import math

    from torch import nn

    from unimedvl_tpu_torch.models.layers import LayerNorm, RMSNorm
    from unimedvl_tpu_torch.models.vae import GroupNorm
    from unimedvl_tpu_torch.ops.sincos import get_2d_sincos_pos_embed

    skel = bagel.Bagel(cfg, device="meta", dtype=dtype, with_vae=with_vae)
    g = torch.Generator(device=device).manual_seed(seed)
    tp, rank = mesh.shape.get("model", 1), mesh.coords.get("model", 0)
    state = {}

    def keep(name, full):
        part = pmesh.take_ranges(full, pmesh.leaf_ranges(name, full.shape, cfg.llm, tp, rank))
        state[name] = full if part is full else part.clone()

    def new(p, fill=None):
        t = torch.empty(p.shape, dtype=p.dtype, device=device)
        return t if fill is None else t.fill_(fill)

    for name, mod in skel.named_modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            w = new(mod.weight)
            if name == "language_model.lm_head":
                w.normal_(0.0, 0.02, generator=g)
            else:
                bound = 1.0 / math.sqrt(mod.weight[0].numel())
                w.uniform_(-bound, bound, generator=g)
            keep(name + ".weight", w)
            if mod.bias is not None:
                keep(name + ".bias", new(mod.bias, 0.0))
        elif isinstance(mod, nn.Embedding):
            keep(name + ".weight", new(mod.weight).normal_(0.0, 0.02, generator=g))
        elif isinstance(mod, (RMSNorm, LayerNorm, GroupNorm)):
            keep(name + ".weight", new(mod.weight, 1.0))
            if not isinstance(mod, RMSNorm):
                keep(name + ".bias", new(mod.bias, 0.0))
    C = cfg.llm.hidden_size
    for table, side in (("vit_pos_embed", cfg.vit_max_num_patch_per_side),
                        ("latent_pos_embed", cfg.max_latent_size)):
        if hasattr(skel, table):
            state[f"{table}.pos_embed"] = torch.from_numpy(
                get_2d_sincos_pos_embed(C, side)).to(device=device, dtype=dtype)
    if hasattr(skel, "llm2vae") and llm2vae_zero:
        state["llm2vae.weight"].zero_()
        state["llm2vae.bias"].zero_()
    missing = set(skel.state_dict()) - set(state)
    if missing:
        raise RuntimeError(f"random_rank_model: no draw for {sorted(missing)[:5]}")
    return pmesh.build_rank_model(state, cfg, mesh, device, dtype)


def first_step_logits(inf, image, prompt) -> torch.Tensor:
    """chat's first decode step on one request (no image when ``image`` is
    None): its logits [V] fp32, gathered over "model" on a mesh."""
    from unimedvl_tpu_torch.models import qwen2_mot

    ctx = inf.init_gen_context()
    if image is not None:
        ctx = inf.update_context_image(image, ctx, vae=False)
    ctx = inf.update_context_text(prompt, ctx)
    ctx = inf._ensure_capacity(ctx, 1)
    lm = inf.model.language_model
    base = ctx.cache.lens.max()
    bos = torch.tensor([inf.new_token_ids["bos_token_id"]], device=inf.device)
    x = qwen2_mot.embed_tokens(lm, bos)[:, None]
    pos = torch.tensor([[ctx.rope]], device=inf.device)
    with torch.no_grad():
        h, _ = lm.model(x, pos, ctx.cache, causal=True, decode_cols=(base, base))
    return qwen2_mot.lm_head(lm, h[:, 0])[0]


def _kernel_counts() -> Dict[str, int]:
    from unimedvl_tpu_torch.ops import act_quant, decode_attention, flash_attention, w4_matmul

    return {"flash_block_attention": flash_attention.counts["kernel"],
            "decode_attention": decode_attention.counts["kernel"],
            "decode_attention_int8": decode_attention.int8_counts["kernel"],
            "silu_mul_quant": act_quant.counts["kernel"],
            "silu_mul_quant_global": act_quant.global_counts["kernel"],
            "w4_matmul": w4_matmul.counts["kernel"],
            "plain": sum(c["plain"] for c in (
                flash_attention.counts, decode_attention.counts, decode_attention.int8_counts,
                act_quant.counts, act_quant.global_counts, w4_matmul.counts))}


def _chat_run(inf, image, prompt, max_length: int) -> Dict:
    """One greedy chat request on a rank, the card synchronised around it:
    the ids (start token, the tokens, eos where it ended on one), the top-2
    logits of every step, the first step's logits, the forwards (prefills,
    decode steps), the kernels' launches and the seconds."""
    from unimedvl_tpu_torch.models import qwen2_mot

    steps, forwards = [], {"prefill": 0, "decode": 0}
    real = qwen2_mot.lm_head

    def record(lm, h):
        logits = real(lm, h)
        steps.append(torch.topk(logits[0], 2))
        return logits

    def count(module, args):
        forwards["decode" if args[0].shape[1] == 1 else "prefill"] += 1

    hook = inf.model.language_model.model.register_forward_pre_hook(count)
    before = _kernel_counts()
    qwen2_mot.lm_head = record
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        inf.chat([image], prompt, max_length=max_length)
        torch.cuda.synchronize()
    finally:
        qwen2_mot.lm_head = real
        hook.remove()
    seconds = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in _kernel_counts().items()}
    top2 = [(t.values.tolist(), t.indices.tolist()) for t in steps]
    ids = [inf.new_token_ids["bos_token_id"]] + [i[0] for _v, i in top2]
    eos = inf.new_token_ids["eos_token_id"]
    ids = ids[: ids.index(eos) + 1] if eos in ids else ids[:max_length]
    return dict(ids=ids, top2=top2, forwards=forwards, launches=launches, seconds=seconds)


def tp_chat_rank(rank: int, world: int, cfg: BagelConfig, seed: int, image, prompt: str,
                 max_lengths, transform) -> Dict:
    """A rank of the tensor-parallel chat program on one card (every rank on
    cuda:0, joined by gloo): its shard of the seeded random model
    (:func:`random_rank_model`), the chat request in bf16, then the shard
    quantized in place to w4a8 per channel (fused, an int8 KV cache) and the
    request again; ``max_lengths``: the answer length of each. Returns per
    mode the first-step logits (numpy), the run (:func:`_chat_run`) and the
    peak GiB of the rank; in w4a8 also the stats of
    :class:`GlobalScaleCheck` over the first step's forwards (their
    launches, made before the run, are not the run's)."""
    from unimedvl_tpu_torch import quant
    from unimedvl_tpu_torch.data import imaging
    from unimedvl_tpu_torch.inference import InterleaveInferencer

    torch.cuda.set_device(0)
    mesh = pmesh.make_mesh(("data", "model"), (1, world))
    t0 = time.perf_counter()
    model = random_rank_model(cfg, mesh, seed, "cuda")
    torch.cuda.synchronize()
    out = {"build_s": time.perf_counter() - t0,
           "built_gib": torch.cuda.memory_allocated() / 2**30}
    tok, ids = _smoke_tokenizer()
    t = imaging.ImageTransform(*transform)
    for mode, max_length in zip(("bf16", "w4a8"), max_lengths):
        if mode == "w4a8":
            quant.quantize_llm_params(model.language_model, bits=4, act_quant=True)
            quant.fuse_serving_projections(model.language_model)
            torch.cuda.empty_cache()
        inf = InterleaveInferencer(model, tok, ids, vit_transform=t, seed=seed, mesh=mesh,
                                   kv_quantized=mode == "w4a8")
        torch.cuda.reset_peak_memory_stats()
        with GlobalScaleCheck(mesh) as check:
            logits = first_step_logits(inf, image, prompt).float().cpu().numpy()
        run = _chat_run(inf, image, prompt, max_length)
        out[mode] = dict(logits=logits, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                         global_scales=check.stats, **run)
    return out


def tp_chat_and_load_rank(rank: int, world: int, chat_args: tuple, load_args: tuple) -> Dict:
    """:func:`tp_chat_rank` and then, its model freed, :func:`tp_load_rank`
    in one rank process: one spawn (process start, CUDA and the gloo group)
    for both programs. Returns {"chat": ..., "load": ...}."""
    import gc

    out = {"chat": tp_chat_rank(rank, world, *chat_args)}
    gc.collect()
    torch.cuda.empty_cache()
    out["load"] = tp_load_rank(rank, world, *load_args)
    return out


def _smoke_tokenizer():
    from unimedvl_tpu_torch.data.tokenizer import ByteTokenizer, add_special_tokens

    tok, ids, _ = add_special_tokens(ByteTokenizer())
    return tok, ids


def tp_load_rank(rank: int, world: int, ckpt: str, image, prompt: str, transform) -> Dict:
    """A rank of the sharded loader on one card (cuda:0, gloo):
    ``load_bagel_checkpoint(mesh=...)`` of ``ckpt``; its bytes
    (:func:`shard_bytes`), the first-step logits of the request, and the same
    logits of the tensor-parallel program over the same files built the
    other way (the whole checkpoint loaded, then ``place_params``): they must
    be equal."""
    from unimedvl_tpu_torch.data import imaging
    from unimedvl_tpu_torch.inference import InterleaveInferencer
    from unimedvl_tpu_torch.weights.loader import load_bagel_checkpoint

    torch.cuda.set_device(0)
    mesh = pmesh.make_mesh(("data", "model"), (1, world))
    tok, ids = _smoke_tokenizer()
    t = imaging.ImageTransform(*transform)
    t0 = time.perf_counter()
    model = load_bagel_checkpoint(ckpt, device="cuda", mesh=mesh)
    torch.cuda.synchronize()
    out = dict(load_s=time.perf_counter() - t0, bytes=shard_bytes(model))
    out["logits"] = first_step_logits(InterleaveInferencer(
        model, tok, ids, vit_transform=t, mesh=mesh), image, prompt).cpu().numpy()
    del model
    torch.cuda.empty_cache()
    placed = pmesh.place_params(load_bagel_checkpoint(ckpt, device="cuda"), mesh)
    out["placed_logits"] = first_step_logits(InterleaveInferencer(
        placed, tok, ids, vit_transform=t, mesh=mesh), image, prompt).cpu().numpy()
    return out


def _http(base: str, path: str, payload=None):
    """The JSON body of a route's answer (of an error status too)."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    try:
        with urllib.request.urlopen(urllib.request.Request(base + path, data=data),
                                    timeout=120) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        return json.loads(e.read())


def http_rank(rank: int, world: int, model, argv, requests, prefix: str) -> list:
    """``scripts.serve_http`` on one rank of a mesh (``--tp`` / ``--dp`` in
    ``argv``; the process group is up) or on one process (world 1), over
    ``model`` (placed on the mesh here) with :class:`CharTokenizer`. Rank 0
    registers ``prefix`` (``POST /v1/prefixes``), submits ``requests``
    ((prompt, image or None, max_new_tokens, with the prefix) tuples) with
    ``"async": true`` through its HTTP server, collects every answer and
    stops the daemon, which stops the other ranks' loops. Returns the
    answers (None on the other ranks)."""
    import base64
    import io
    import threading

    from PIL import Image

    from unimedvl_tpu_torch.data import imaging
    from unimedvl_tpu_torch.scripts import common, serve_http

    args = serve_http.parse_args(["--checkpoint", "unused", "--device", "cpu", "--port", "0",
                                  *argv])
    mesh = common.make_mesh(args)
    local = model if mesh is None else pmesh.place_params(model, mesh)
    tok, ids = tokenizer()
    daemon, server = serve_http.build(args, local, tok, ids, mesh,
                                      vit_transform=imaging.ImageTransform(*VIT_T))
    if server is None:
        daemon.follow()
        return None
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        pid = _http(base, "/v1/prefixes", {"text": prefix})["prefix_id"]
        tickets = []
        for prompt, image, max_new, prefixed in requests:
            payload = {"prompt": prompt, "max_new_tokens": max_new, "async": True}
            if image is not None:
                buf = io.BytesIO()
                Image.fromarray(image).save(buf, format="PNG")
                payload["image_png_b64"] = base64.b64encode(buf.getvalue()).decode()
            if prefixed:
                payload["prefix_id"] = pid
            tickets.append(_http(base, "/v1/generate", payload)["ticket"])
        answers = []
        for t in tickets:
            while True:
                got = _http(base, f"/v1/result/{t}?timeout=30")
                if got.get("status") != "pending":
                    answers.append(got.get("text", got.get("error")))
                    break
        return answers
    finally:
        server.shutdown()
        server.server_close()
        daemon.stop()


def tiny_model(seed: int = 0, device="cpu", dtype=torch.float32):
    model = bagel.Bagel(TINY, device="meta", dtype=dtype, with_vae=True).to_empty(device=device)
    return bagel.init_random_(model, torch.Generator(device=device).manual_seed(seed),
                              llm2vae_zero=False)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (a 1 x 1 mesh on the card) or cpu")
    ap.add_argument("--dp", type=int, default=2)
    ap.add_argument("--tp", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    from unimedvl_tpu_torch.weights.loader import _target_device

    device = _target_device(args.device)
    world = args.dp * args.tp
    if device.type == "cuda" and world != 1:
        raise SystemExit("one card holds one rank: --device cuda runs --dp 1 --tp 1; meshes of "
                         "several ranks run with --device cpu")
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = tiny_model(args.seed, device, dtype)
    rng = np.random.default_rng(args.seed)
    image = rng.integers(0, 255, (24, 28, 3), dtype=np.uint8)
    cases = [
        dict(kind="chat", images=[image], prompt="what is this?", max_length=8),
        dict(kind="serve", batch_kw=dict(num_slots=4, capacity=512, chunk=4),
             requests=[("alpha", None, 6), ("what is shown?", image, 5), ("beta", None, 4)]),
    ]
    want = [run_case(model, None, c) for c in cases]
    t0 = time.perf_counter()
    axes, sizes = ("data", "model"), (args.dp, args.tp)
    if world == 1:
        per_rank = [[run_case(model, pmesh.make_mesh(axes, sizes), c) for c in cases]]
    else:
        per_rank = pmesh.run_on_ranks(run_mesh_cases, world, axes, sizes, model, cases)
    seconds = time.perf_counter() - t0
    ok = all(r == want for r in per_rank)
    print(json.dumps(dict(ok=bool(ok), device=str(device), mesh=dict(zip(axes, sizes)),
                          ranks=world, chat=per_rank[0][0], chat_single=want[0],
                          seconds=seconds)))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
