"""Dry run of the sequence-parallel denoise on spawned CPU ranks: the real
program (``parallel.sp_denoise``) over real collectives (``torch.distributed``,
gloo), at a tiny config with random weights from a seed, held against the
port's single-device ``generate_latents`` on the same inputs. The port's
counterpart of the sequence-parallel part of the JAX package's multi-chip dry
run.

    python -m unimedvl_tpu_torch.tools.dryrun_sp --device cpu --tp 2 --sp 4
    python -m unimedvl_tpu_torch.tools.dryrun_sp --device cpu --dp 2 --tp 2 --sp 2

Prints one JSON line: the mesh, the largest absolute difference from the
single-device latents, the tolerance and the seconds the ranks took. Exits
non-zero if they disagree. ``--device cuda`` (the default) runs the one mesh
a single card can hold, 1 x 1, on the card; meshes of several ranks run on
the CPU, one process per rank.

``run_denoise_calls`` is also what the tests spawn (tests/test_torch_sp.py):
one set of ranks runs a list of calls, so that a test pays for one spawn.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from unimedvl_tpu_torch.config import BagelConfig, LLMConfig, VAEConfig
from unimedvl_tpu_torch.models import bagel
from unimedvl_tpu_torch.models.qwen2_mot import KVCache
from unimedvl_tpu_torch.parallel import mesh as pmesh
from unimedvl_tpu_torch.parallel import sp_denoise

RTOL, ATOL = 2e-4, 2e-5  # fp32; sums over ranks are taken in another order

TINY = BagelConfig(
    llm=LLMConfig(vocab_size=128, hidden_size=512, intermediate_size=256, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2),
    vit=None, visual_und=False,
    vae=VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4, downsample=2),
    max_latent_size=8,
)


def _cache(k, v, lens) -> KVCache:
    return KVCache(k=k, v=v, lens=lens)


def run_denoise_calls(rank: int, world: int, axes, sizes, models, calls: List[Dict]) -> list:
    """On one rank of a mesh ``axes`` x ``sizes``: each call of ``calls``
    through ``generate_latents_tp_sp`` (or, with ``grouped``, through
    ``generate_latents_dp_tp_sp``). ``models``: a Bagel, or a dict of them by
    name. A call is ``{"inputs": (k, v, lens, positions, pos_ids, noise,
    start_end) or a list of such per group, "kw": keyword arguments,
    "grouped": bool, "model": a name of ``models``}``, tensors on the CPU,
    the caches whole. Each whole model is placed once (this rank's shard,
    ``parallel.mesh.place_params``) when "model" has several ranks, and each
    cache narrowed to the rank's kv heads. Returns the latents as numpy
    arrays, one per call."""
    mesh = pmesh.make_mesh(axes, sizes)
    placed = {}

    def rank_model(name, whole):
        if mesh.shape["model"] == 1:
            return whole
        if name not in placed:
            placed[name] = pmesh.place_params(whole, mesh)
        return placed[name]

    out = []
    for call in calls:
        name = call.get("model")
        whole = models[name] if isinstance(models, dict) else models
        model = rank_model(name, whole)

        def cache(k, v, lens):
            return pmesh.shard_kv_heads(_cache(k, v, lens), whole.config, mesh)

        if call.get("grouped"):
            groups = call["inputs"]
            got = sp_denoise.generate_latents_dp_tp_sp(
                model, [cache(*g[:3]) for g in groups], [g[3] for g in groups],
                [g[4] for g in groups], [g[5] for g in groups], groups[0][6], mesh,
                **call["kw"])
        else:
            k, v, lens, positions, pos_ids, noise, se = call["inputs"]
            got = sp_denoise.generate_latents_tp_sp(
                model, cache(k, v, lens), positions, pos_ids, noise, se, mesh, **call["kw"])
        out.append(got.numpy())
    return out


def run_interleave_calls(rank: int, world: int, axes, sizes, model, transforms, calls) -> list:
    """On one rank of the mesh: an ``InterleaveInferencer(sp_mesh=...)`` over
    ``model`` with a byte tokenizer, and each call of ``calls`` through
    ``interleave_inference`` up to the final latents (no VAE decode). A call
    is ``{"inputs": [...], "noises": [numpy arrays the draws replay, in
    order], "kw": {...}}``; ``transforms`` the (vae, vit) ``ImageTransform``
    arguments. Returns the latents as numpy arrays."""
    from unimedvl_tpu_torch.data import imaging
    from unimedvl_tpu_torch.data.tokenizer import ByteTokenizer, add_special_tokens
    from unimedvl_tpu_torch.inference import InterleaveInferencer

    mesh = pmesh.make_mesh(axes, sizes)
    tok, ids, _ = add_special_tokens(ByteTokenizer())
    vae_t, vit_t = (imaging.ImageTransform(*a) for a in transforms)
    inf = InterleaveInferencer(model, tok, ids, vae_transform=vae_t, vit_transform=vit_t,
                               sp_mesh=mesh)
    inf.decode_image = lambda latent, shape: latent
    out = []
    for call in calls:
        draws = iter(call["noises"])
        inf._randn = lambda shape, draws=draws: torch.from_numpy(next(draws)).reshape(shape)
        out.append(inf.interleave_inference(call["inputs"], **call["kw"])[-1].numpy())
    return out


def tiny_inputs(cfg: BagelConfig, S: int, n: int, cap: int, seed: int, device="cpu"):
    """(k, v, lens, positions, pos_ids, noise, start_end) from a numpy seed."""
    llm = cfg.llm
    rng = np.random.default_rng(seed)
    shape = (llm.num_hidden_layers, S, llm.num_key_value_heads, cap, llm.head_dim)
    arrays = (
        rng.standard_normal(shape).astype(np.float32),
        rng.standard_normal(shape).astype(np.float32),
        rng.integers(1, cap // 2, (S,)).astype(np.int32),
        rng.integers(1, 5, (S,)).astype(np.int64),
        (np.arange(n) % cfg.max_latent_size**2).astype(np.int64),
        rng.standard_normal((n, cfg.patch_latent_dim)).astype(np.float32),
        np.asarray([3, 4], np.int64),
    )
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (a 1 x 1 mesh on the card) or cpu")
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--sp", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--latents", type=int, default=16)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    from unimedvl_tpu_torch.weights.loader import _target_device

    device = _target_device(args.device)
    world = args.dp * args.tp * args.sp
    if device.type == "cuda" and world != 1:
        raise SystemExit("one card holds one rank: --device cuda runs --dp 1 --tp 1 --sp 1; "
                         "meshes of several ranks run with --device cpu")
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = bagel.Bagel(TINY, device="meta", dtype=dtype).to_empty(device=device)
    bagel.init_random_(model, torch.Generator(device=device).manual_seed(args.seed),
                       llm2vae_zero=False)
    kw = dict(num_timesteps=args.steps + 1, timestep_shift=3.0, cfg_text_scale=2.0,
              cfg_img_scale=1.5, cfg_interval=(0.0, 1.0), cfg_renorm_type="global",
              use_text_cfg=True, use_img_cfg=True)
    groups = [tiny_inputs(TINY, 3, args.latents, 32, args.seed + 1 + g, device)
              for g in range(args.dp)]
    if dtype != torch.float32:
        groups = [(g[0].to(dtype), g[1].to(dtype), *g[2:]) for g in groups]
    want = [bagel.generate_latents(model, _cache(*g[:3]), *g[3:], **kw).cpu().numpy()
            for g in groups]
    t0 = time.perf_counter()
    if args.dp > 1:
        axes, sizes = ("data", "model", "seq"), (args.dp, args.tp, args.sp)
        call = dict(inputs=groups, kw=kw, grouped=True)
    else:
        axes, sizes = ("model", "seq"), (args.tp, args.sp)
        call = dict(inputs=groups[0], kw=kw)
    if world == 1:
        mesh = pmesh.make_mesh(axes, sizes)
        g = groups[0]
        got = sp_denoise.generate_latents_tp_sp(model, _cache(*g[:3]), *g[3:], mesh, **kw)
        per_rank = [[got.cpu().numpy()]]
    else:
        per_rank = pmesh.run_on_ranks(run_denoise_calls, world, axes, sizes, model, [call])
    seconds = time.perf_counter() - t0
    want_arr = np.stack(want) if args.dp > 1 else want[0]
    # bf16 on the card: the kernels against themselves in another order
    rtol, atol = (RTOL, ATOL) if dtype == torch.float32 else (2.0**-6, 2.0**-6)
    err = max(float(np.abs(r[0] - want_arr).max()) for r in per_rank)
    ok = all(np.allclose(r[0], want_arr, rtol=rtol, atol=atol) for r in per_rank)
    same = all(np.array_equal(r[0], per_rank[0][0]) for r in per_rank)
    print(json.dumps(dict(ok=bool(ok and same), device=str(device), mesh=dict(zip(axes, sizes)),
                          ranks=world, max_abs_err=err, rtol=rtol, atol=atol,
                          every_rank_same=bool(same), seconds=seconds)))
    return 0 if ok and same else 1


if __name__ == "__main__":
    sys.exit(main())
