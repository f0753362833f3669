"""What the port's front ends share: the model flags, the refusal of flags
whose paths are not ported, loading a released checkpoint onto the device
in the mode the flags ask for, and the KV cache options."""

from __future__ import annotations

import argparse
import sys


def add_model_flags(ap: argparse.ArgumentParser) -> None:
    """The checkpoint, device and quantized-mode flags, named as the JAX
    package's scripts name them, and the flags of paths the port does not
    have (refused by :func:`refuse_unported`)."""
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--base-checkpoint", default=None,
                    help="base checkpoint merged under the fine-tune (fine-tune keys win)")
    ap.add_argument("--device", default="cuda", help="where the model runs (default: cuda)")
    ap.add_argument("--int8-kv", action="store_true", help="int8 KV caches with per-key scales")
    ap.add_argument("--int8", action="store_true", help="int8 weights (weight-only)")
    ap.add_argument("--act-int8", action="store_true",
                    help="int8 weights and activations (implies --int8)")
    ap.add_argument("--w4", action="store_true",
                    help="packed-int4 layer weights (with --int8: weight-only w4; with "
                         "--act-int8: w4a8)")
    ap.add_argument("--w4-group", type=int, default=0,
                    help="group-wise w4 scales (0 = per channel)")
    ap.add_argument("--fused", action="store_true",
                    help="fuse the qkv and gate_up projections")
    ap.add_argument("--int4-kv", action="store_true",
                    help="int4 KV caches, two values a byte, per-key scales (a quarter of the "
                         "bf16 cache's bytes; a further accuracy step)")
    ap.add_argument("--tp", type=int, default=1, help="not ported (ROADMAP queue 1, M13)")
    ap.add_argument("--dp", type=int, default=1, help="not ported (ROADMAP queue 1, M13)")


def refuse_unported(args) -> None:
    """Exit non-zero, naming why, for a flag whose path the port lacks."""
    if args.tp > 1 or args.dp > 1:
        sys.exit("--tp/--dp: serving over a device mesh is not ported (ROADMAP queue 1, "
                 "what remains of M13); the port serves on one card")


def load(args):
    """(model, tokenizer, new_token_ids) from ``args.checkpoint`` on
    ``args.device``, quantized and fused as the flags ask."""
    from unimedvl_tpu_torch import quant
    from unimedvl_tpu_torch.data.tokenizer import load_tokenizer
    from unimedvl_tpu_torch.weights.loader import load_bagel_checkpoint

    quantized = args.int8 or args.act_int8
    model = load_bagel_checkpoint(
        args.checkpoint, device=args.device, base_dir=args.base_checkpoint,
        quantize_bits=(4 if args.w4 else 8) if quantized else None,
        act_quant=args.act_int8, quantize_group=args.w4_group if quantized else 0)
    if args.fused:
        quant.fuse_serving_projections(model.language_model)
    tokenizer, new_token_ids, _ = load_tokenizer(args.checkpoint)
    return model, tokenizer, new_token_ids


def kv_options(args) -> dict:
    """The inferencer's and the batcher's KV cache options from the flags
    (``--int4-kv`` wins over ``--int8-kv``, as in the JAX package's scripts)."""
    return dict(kv_quantized=args.int8_kv or args.int4_kv, kv_bits=4 if args.int4_kv else 8)


def vit_transform():
    """The VQA ViT geometry (980 / 378 / stride 14)."""
    from unimedvl_tpu_torch.config import TransformConfig
    from unimedvl_tpu_torch.data.imaging import ImageTransform

    tv = TransformConfig.vit_vqa()
    return ImageTransform(tv.max_size, tv.min_size, tv.stride, tv.max_pixels)
