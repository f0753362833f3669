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
                    help="not ported (ROADMAP queue 1, M13): one card serves one rank")
    args = ap.parse_args(argv)
    common.refuse_unported(args)
    if args.sp > 1:
        sys.exit("--sp: a sequence-parallel mesh over several cards is not ported (ROADMAP "
                 "queue 1, what remains of M13); one card serves one rank")
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

    t0 = time.time()
    model, tokenizer, new_token_ids = common.load(args)
    tvae, tvit = TransformConfig.vae_interactive(), TransformConfig.vit_interactive()
    inferencer = InterleaveInferencer(
        model, tokenizer, new_token_ids,
        vae_transform=ImageTransform(tvae.max_size, tvae.min_size, tvae.stride,
                                     tvae.max_pixels),
        vit_transform=ImageTransform(tvit.max_size, tvit.min_size, tvit.stride,
                                     tvit.max_pixels),
        seed=args.seed, spec_decode=args.spec, **common.kv_options(args))
    print(f"model loaded in {time.time() - t0:.1f} s on {inferencer.device}", file=sys.stderr)
    return inferencer


def main(argv=None):
    args = parse_args(argv)
    from PIL import Image

    inferencer = build(args)
    inputs = ([Image.open(args.image)] if args.image else []) + [args.prompt]
    t0 = time.time()
    for item in inferencer.interleave_inference(inputs, **recipe(args)):
        if isinstance(item, str):
            print(f"[think] {item}")
        else:
            item.save(args.out)
            print(f"[{time.time() - t0:.2f}s] saved {args.out} ({item.size[0]}x{item.size[1]})")


if __name__ == "__main__":
    main()
