"""Toy end-to-end training run: examples -> packing -> the train step, over a
tiny random-weight Bagel, on one device or on a ("data", "model") mesh of
``--dp`` x ``--tp`` ranks (the port's counterpart of scripts/toy_overfit.py
and its TP x DP mesh).

It overfits a handful of synthetic examples of the three task types
(vlm_sft, t2i_pretrain, unified_edit), so the losses, masks and MoT routing
are shown to compose over consecutive steps, and checks that the loss fell
and both experts moved. The loss curve and the before / after losses go to
``--out`` as JSON. ``--export-dir`` writes the trained (EMA, with
``--ema-decay``) weights as a released-format checkpoint and reloads them.

    python -m unimedvl_tpu_torch.scripts.toy_overfit --out curve.json \\
        [--steps 200] [--device cuda|cpu] [--ema-decay 0.99] [--export-dir DIR]
    torchrun --nproc-per-node 8 -m unimedvl_tpu_torch.scripts.toy_overfit \\
        --out curve.json --tp 4 --dp 2 --device cpu

On a mesh every rank builds the same seeded model and batches, trains its
shard (``make_train_step(mesh=)``: each data rank takes its share of every
batch) and checks the same asserts; rank 0 prints and writes ``--out``.
``--export-dir`` runs on one device only.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def tiny_config():
    """A two-layer Bagel small enough for the CPU: every part of the full
    model (MoT with both experts, the SigLIP ViT, the VAE), narrow."""
    from unimedvl_tpu_torch.config import BagelConfig, LLMConfig, VAEConfig, ViTConfig

    return BagelConfig(
        llm=LLMConfig(vocab_size=300, hidden_size=32, intermediate_size=64,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                      rope_theta=10000.0),
        vit=ViTConfig(hidden_size=24, intermediate_size=48, num_hidden_layers=2,
                      num_attention_heads=2, image_size=32, patch_size=2, rope=False),
        vae=VAEConfig(resolution=32, downsample=4, ch=32, ch_mult=(1, 2, 2), num_res_blocks=1,
                      z_channels=4),
        max_latent_size=16, vit_max_num_patch_per_side=16, timestep_shift=1.0,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="where the loss curve (JSON) is written")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="where the model trains (default: cuda)")
    ap.add_argument("--ema-decay", type=float, default=None,
                    help="keep an EMA shadow of the trained parameters")
    ap.add_argument("--export-dir", default=None,
                    help="export the trained (EMA with --ema-decay) weights and reload them")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree (the mesh's model axis); run under torchrun")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel degree (the mesh's data axis); run under torchrun")
    args = ap.parse_args(argv)
    if args.export_dir and args.tp * args.dp > 1:
        sys.exit("toy_overfit: --export-dir writes the whole model, which a rank of a mesh does "
                 "not hold; export from a one-device run")

    import torch
    from PIL import Image

    from unimedvl_tpu_torch.data.imaging import ImageTransform
    from unimedvl_tpu_torch.data.tokenizer import ByteTokenizer, add_special_tokens
    from unimedvl_tpu_torch.models import bagel
    from unimedvl_tpu_torch.training import dataset, trainer
    from unimedvl_tpu_torch.scripts import common
    from unimedvl_tpu_torch.weights.loader import _target_device

    common.init_ranks(args, args.tp * args.dp)
    device = _target_device(args.device)
    cfg = tiny_config()
    whole = bagel.Bagel(cfg, device="meta", dtype=torch.float32, with_vae=True)
    whole = whole.to_empty(device=device)
    bagel.init_random_(whole, torch.Generator(device=device).manual_seed(args.seed),
                       llm2vae_zero=False)
    mesh = common.make_mesh(args)
    model = whole
    if mesh is not None:
        from unimedvl_tpu_torch.parallel.mesh import place_params

        model = place_params(whole, mesh)
    tok, new_ids, _ = add_special_tokens(ByteTokenizer())

    def img(seed):
        r = np.random.default_rng(seed)
        return Image.fromarray(r.integers(0, 255, (24, 28, 3), dtype=np.uint8))

    ex = dataset.Example
    examples = [
        ex("vlm_sft", "what is shown?", image=img(1), answer="a lung."),
        ex("vlm_sft", "any fracture?", image=img(2), answer="no."),
        ex("t2i_pretrain", "a chest x-ray", image=img(3)),
        ex("unified_edit", "add contrast", image=img(4), target_image=img(5)),
    ]
    it = dataset.Prefetcher(dataset.PackedBatchIterator(
        examples, tok, new_ids, cfg, ImageTransform(32, 8, 2, 1024),
        ImageTransform(32, 8, 8, 1024), latent_fn=dataset.make_latent_fn(whole),
        batch_size=args.batch_size, seq_len=args.seq_len, seed=args.seed,
    ), place_fn=dataset.make_place_fn(device))
    try:
        step, init_state = trainer.make_train_step(
            cfg, model, optimizer=trainer.make_optimizer(learning_rate=args.lr),
            ema_decay=args.ema_decay, mesh=mesh)
        state = init_state()
        eval_batch = next(it)

        def eval_losses():
            g = torch.Generator(device=device).manual_seed(42)
            ce, mse = [], []
            with torch.no_grad():
                for seq in eval_batch:
                    out = bagel.train_forward(model, seq, generator=g)
                    ce.append(float(out["ce"]))
                    if "mse" in out:
                        mse.append(float(out["mse"]))
            return float(np.mean(ce)), float(np.mean(mse)) if mse else float("nan")

        ce0, mse0 = eval_losses()
        params = dict(model.named_parameters())
        watch = {"und": "language_model.model.layers.0.mlp.gate_proj.weight",
                 "gen": "language_model.model.layers.0.mlp_moe_gen.gate_proj.weight"}
        before = {k: params[n].detach().clone() for k, n in watch.items()}
        g = torch.Generator(device=device).manual_seed(args.seed + 7)
        curve = []
        t0 = time.perf_counter()
        for i in range(args.steps):
            state, loss = step(state, next(it), generator=g)
            curve.append(float(loss))
            if i % 20 == 0:
                common.say(f"step {i}: loss {curve[-1]:.4f}", flush=True)
        seconds = time.perf_counter() - t0
        ce1, mse1 = eval_losses()
    finally:
        it.close(wait=True)
    delta = {k: float((params[n].detach() - before[k]).abs().max()) for k, n in watch.items()}
    out = {
        "device": str(device), "mesh": None if mesh is None else dict(mesh.shape),
        "steps": args.steps, "seconds": seconds,
        "loss_first10_mean": float(np.mean(curve[:10])),
        "loss_last10_mean": float(np.mean(curve[-10:])),
        "ce_before": ce0, "ce_after": ce1, "mse_before": mse0, "mse_after": mse1,
        "und_expert_max_delta": delta["und"], "gen_expert_max_delta": delta["gen"],
        "curve": curve,
    }
    if args.export_dir:
        from unimedvl_tpu_torch.weights.bagel_export import export_bagel_checkpoint
        from unimedvl_tpu_torch.weights.loader import load_bagel_checkpoint

        written = export_bagel_checkpoint(args.export_dir, model, dtype=torch.float32,
                                          overrides=state.ema_params)
        reloaded = load_bagel_checkpoint(args.export_dir, cfg=cfg, device=device,
                                         dtype=torch.float32)
        name = "language_model.model.norm.weight"
        want = (state.ema_params or {}).get(name, params[name]).float()
        if not torch.equal(dict(reloaded.named_parameters())[name], want):
            raise SystemExit("toy_overfit: the exported weights do not reload as written")
        out["exported"] = sorted(written)
        out["export_kind"] = "ema" if args.ema_decay is not None else "params"
    if common.is_rank0():
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    common.say(json.dumps({k: v for k, v in out.items() if k != "curve"}))
    ok = (out["loss_last10_mean"] < out["loss_first10_mean"] and ce1 < ce0
          and delta["und"] > 0 and delta["gen"] > 0 and (np.isnan(mse0) or mse1 < mse0))
    common.say("OVERFIT", "PASS" if ok else "FAIL")
    return 0 if ok else 1


def run_rank(rank: int, world: int, argv) -> int:
    """:func:`main` on one rank of a process group that is already up (the
    tests' spawned gloo ranks, ``parallel.mesh.run_on_ranks``)."""
    return main(argv)


if __name__ == "__main__":
    sys.exit(main())
