"""Export a model to the released UniMedVL checkpoint layout (the port's
counterpart of scripts/export_checkpoint.py).

Sources (one of):
  --from-ckpt DIR      a released-format checkpoint directory, read through
                       the loader (with --base: a base and fine-tune pair
                       folded into one standalone checkpoint)
  --from-snapshot DIR  a snapshot written by weights.snapshot.save_snapshot
                       (a model, or a TrainState: its EMA shadow is written
                       when it has one, unless --no-ema)

The output matches interactive_vqa_inferencer.py:127-213: llm_config.json,
vit_config.json, ema.safetensors (sharded, with model.safetensors.index.json,
above --shard-gb), ae.safetensors. LoRA adapters are merged.

    python -m unimedvl_tpu_torch.scripts.export_checkpoint OUT --from-ckpt CKPT [--base BASE]
    python -m unimedvl_tpu_torch.scripts.export_checkpoint OUT --from-snapshot SNAP \\
        --ckpt-config CKPT
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--from-ckpt")
    src.add_argument("--from-snapshot")
    ap.add_argument("--base", default=None, help="base checkpoint merged under --from-ckpt")
    ap.add_argument("--ckpt-config", default=None,
                    help="checkpoint directory whose llm/vit_config.json describe the "
                         "snapshot's model (required with --from-snapshot); also the "
                         "tokenizer's source")
    ap.add_argument("--shard-gb", type=float, default=4.0)
    ap.add_argument("--no-ema", action="store_true",
                    help="write a TrainState snapshot's parameters, not its EMA shadow")
    ap.add_argument("--device", default="cuda",
                    help="where the weights are staged (default: cuda; cpu keeps the card free)")
    args = ap.parse_args(argv)

    from unimedvl_tpu_torch.config import BagelConfig
    from unimedvl_tpu_torch.models.bagel import Bagel
    from unimedvl_tpu_torch.weights.bagel_export import export_bagel_checkpoint
    from unimedvl_tpu_torch.weights.loader import _target_device, load_bagel_checkpoint
    from unimedvl_tpu_torch.weights.snapshot import restore_snapshot

    overrides = None
    if args.from_ckpt:
        model = load_bagel_checkpoint(args.from_ckpt, device=args.device, base_dir=args.base)
        tok_src = args.from_ckpt
    else:
        if args.ckpt_config is None:
            ap.error("--from-snapshot requires --ckpt-config")
        device = _target_device(args.device)
        payload = restore_snapshot(args.from_snapshot, device=device)
        # the e2e-VAE extras' REPA projections are training state, not released weights
        state = {k: v for k, v in payload["model"].items() if not k.startswith("repa_")}
        cfg = BagelConfig.from_checkpoint_dir(args.ckpt_config)
        dtype = next(v.dtype for k, v in state.items() if k.endswith("embed_tokens.weight"))
        model = Bagel(cfg, device="meta", dtype=dtype,
                      with_vae=any(k.startswith("vae_model.") for k in state))
        _adapters_as_saved(model, state)
        model.load_state_dict(state, strict=True, assign=True)
        if payload["kind"] == "train_state" and payload["ema_params"] and not args.no_ema:
            overrides = payload["ema_params"]
        tok_src = args.ckpt_config
    written = export_bagel_checkpoint(args.out_dir, model, shard_gb=args.shard_gb,
                                      tokenizer_src=tok_src, overrides=overrides)
    for name in sorted(written):
        print(f"  {name} [{written[name]}]")
    print(f"exported {len(written)} files -> {args.out_dir}")
    return 0


def _adapters_as_saved(model, state) -> None:
    """Put a LoRALinear wherever the saved state has an adapter, so a
    snapshot of an adapter run loads (the export then merges it)."""
    from unimedvl_tpu_torch.models.layers import LoRALinear

    for key in [k for k in state if k.endswith(".lora_a")]:
        path = key[: -len(".lora_a")]
        model.set_submodule(path, LoRALinear(model.get_submodule(path), state[key],
                                             state[path + ".lora_b"],
                                             float(state[path + ".lora_s"])))


if __name__ == "__main__":
    sys.exit(main())
