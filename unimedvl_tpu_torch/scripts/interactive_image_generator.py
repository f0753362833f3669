"""Interactive medical image generation and editing on the port (the
counterpart of the JAX package's scripts/interactive_image_generator.py;
reference codes/interactive_image_generator.py): loads a released checkpoint
directory onto the card, then text to image, or an edit of ``--image`` by the
prompt, with an optional understanding ("thinking") pre-pass.

Usage:
  python -m unimedvl_tpu_torch.scripts.interactive_image_generator \\
      --checkpoint /path/to/ckpt --prompt "Chest X-ray with right pleural effusion" \\
      [--out out.png] [--image input.png] [--size 512] [--steps 50] \\
      [--cfg-text 3.0 --cfg-img 1.5 --renorm global] [--think] [--spec] \\
      [--int8-kv | --int4-kv] [--int8 | --act-int8] [--w4 [--w4-group 512]] [--fused]
  torchrun --nproc-per-node N -m unimedvl_tpu_torch.scripts.interactive_image_generator ... \\
      --tp T --dp D        (a ("data", "model") mesh of N = T * D ranks; --dp 3 puts the
                            three CFG streams on their own ranks)
      --tp T --sp S        (the sequence-parallel denoise over a ("model", "seq") mesh of
                            N = T * S ranks; prefill and decode run whole on every rank)
"""

from __future__ import annotations

import argparse
import sys
import time

from unimedvl_tpu_torch.scripts import common

DEFAULT_CONFIG = {
    # mirrors interactive_image_generator.py DEFAULT_CONFIG (:56-71)
    "num_timesteps": 50,
    "timestep_shift": 3.0,
    "cfg_text_scale": 3.0,
    "cfg_img_scale": 1.5,
    "cfg_interval": (0.4, 1.0),
    "cfg_renorm_type": "global",
    "cfg_renorm_min": 0.0,
    "seed": 42,
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    common.add_model_flags(ap)
    ap.add_argument("--prompt", required=True)
    ap.add_argument("--image", help="optional input image (editing / i2i)")
    ap.add_argument("--out", default="generated.png")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--steps", type=int, default=DEFAULT_CONFIG["num_timesteps"])
    ap.add_argument("--cfg-text", type=float, default=DEFAULT_CONFIG["cfg_text_scale"])
    ap.add_argument("--cfg-img", type=float, default=DEFAULT_CONFIG["cfg_img_scale"])
    ap.add_argument("--renorm", default=DEFAULT_CONFIG["cfg_renorm_type"],
                    choices=["global", "channel", "text_channel"])
    ap.add_argument("--timestep-shift", type=float, default=DEFAULT_CONFIG["timestep_shift"])
    ap.add_argument("--think", action="store_true")
    ap.add_argument("--spec", action="store_true",
                    help="prompt-lookup speculative decoding for the think-mode text "
                         "pre-pass (greedy-exact)")
    ap.add_argument("--seed", type=int, default=DEFAULT_CONFIG["seed"])
    ap.add_argument("--sp", type=int, default=1,
                    help="sequence-parallel degree of the denoise: with --tp T the T * S "
                         "ranks form a (model, seq) mesh and the latents shard over seq")
    args = ap.parse_args(argv)
    if args.sp > 1 and args.dp > 1:
        sys.exit("--sp takes --tp, not --dp (a (model, seq) mesh)")
    return args


def recipe(args) -> dict:
    """``interleave_inference``'s options from the flags. An edit with the
    global renorm takes the reference's editing default instead: the
    text_channel renorm over the whole interval (0.0, 1.0]
    (interactive_image_generator.py:365-371)."""
    renorm, cfg_interval = args.renorm, DEFAULT_CONFIG["cfg_interval"]
    if args.image and args.renorm == "global":
        renorm, cfg_interval = "text_channel", (0.0, 1.0)
    return dict(
        think=args.think, understanding_output=False, num_timesteps=args.steps,
        timestep_shift=args.timestep_shift, cfg_text_scale=args.cfg_text,
        cfg_img_scale=args.cfg_img, cfg_interval=cfg_interval, cfg_renorm_type=renorm,
        cfg_renorm_min=DEFAULT_CONFIG["cfg_renorm_min"], image_shapes=(args.size, args.size),
    )


def build(args):
    from unimedvl_tpu_torch.config import TransformConfig
    from unimedvl_tpu_torch.data.imaging import ImageTransform
    from unimedvl_tpu_torch.inference import InterleaveInferencer
    from unimedvl_tpu_torch.parallel.mesh import make_mesh
    from unimedvl_tpu_torch.utils import get_logger

    t0 = time.time()
    mesh = sp_mesh = None
    if args.sp > 1:  # every rank holds the whole model; the denoise shards it
        rank = common.init_ranks(args, args.tp * args.sp)
        sp_mesh = make_mesh(("model", "seq"), (args.tp, args.sp))
        model, tokenizer, new_token_ids = common.load(args, fuse_tp=args.tp)
    else:
        rank = common.init_ranks(args, args.tp * args.dp)
        mesh = common.make_mesh(args)
        model, tokenizer, new_token_ids = common.load(args, mesh)
    tvae, tvit = TransformConfig.vae_interactive(), TransformConfig.vit_interactive()
    inferencer = InterleaveInferencer(
        model, tokenizer, new_token_ids,
        vae_transform=ImageTransform(tvae.max_size, tvae.min_size, tvae.stride,
                                     tvae.max_pixels),
        vit_transform=ImageTransform(tvit.max_size, tvit.min_size, tvit.stride,
                                     tvit.max_pixels),
        seed=args.seed, mesh=mesh, sp_mesh=sp_mesh, spec_decode=args.spec,
        **common.kv_options(args))
    if rank == 0:
        get_logger("unimedvl_tpu_torch.interactive_image_generator").info(
            common.loaded_message(t0, inferencer))
    return inferencer


def main(argv=None):
    args = parse_args(argv)
    from PIL import Image

    inferencer = build(args)
    inputs = ([Image.open(args.image)] if args.image else []) + [args.prompt]
    t0 = time.time()
    for item in inferencer.interleave_inference(inputs, **recipe(args)):
        if isinstance(item, str):
            common.say(f"[think] {item}")
        elif common.is_rank0():
            item.save(args.out)
            print(f"[{time.time() - t0:.2f}s] saved {args.out} ({item.size[0]}x{item.size[1]})")


if __name__ == "__main__":
    main()
