"""Interactive medical VQA and report generation on the port (the counterpart
of the JAX package's scripts/interactive_vqa.py; reference
codes/interactive_vqa_inferencer.py): loads a released checkpoint directory
onto the card and answers questions about images from one-shot flags or a
REPL.

Usage:
  python -m unimedvl_tpu_torch.scripts.interactive_vqa --checkpoint /path/to/ckpt \\
      [--image xr.png --prompt "What abnormality is visible?"] \\
      [--max-length 512] [--sample --temperature 0.3] [--think] [--stream] \\
      [--spec] [--int8-kv | --int4-kv] [--int8 | --act-int8] [--w4 [--w4-group 512]] \\
      [--fused]
  torchrun --nproc-per-node N -m unimedvl_tpu_torch.scripts.interactive_vqa ... \\
      --tp T --dp D        (N = T * D ranks; every rank loads its shard, rank 0 prints)
"""

from __future__ import annotations

import argparse
import sys
import time

from unimedvl_tpu_torch.scripts import common

DEFAULT_CONFIG = {
    # interactive_vqa_inferencer.py DEFAULT_CONFIG (:58-71)
    "max_length": 512,
    "do_sample": False,
    "temperature": 0.3,
    "seed": 42,
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    common.add_model_flags(ap)
    ap.add_argument("--image", action="append", default=[])
    ap.add_argument("--prompt")
    ap.add_argument("--max-length", type=int, default=DEFAULT_CONFIG["max_length"])
    ap.add_argument("--sample", action="store_true")
    ap.add_argument("--temperature", type=float, default=DEFAULT_CONFIG["temperature"])
    ap.add_argument("--think", action="store_true")
    ap.add_argument("--stream", action="store_true",
                    help="print the answer as it decodes (greedy only)")
    ap.add_argument("--spec", action="store_true",
                    help="prompt-lookup speculative decoding (greedy-exact)")
    ap.add_argument("--seed", type=int, default=DEFAULT_CONFIG["seed"])
    return ap.parse_args(argv)


def build(args):
    from unimedvl_tpu_torch.inference import InterleaveInferencer
    from unimedvl_tpu_torch.utils import get_logger

    t0 = time.time()
    rank = common.init_ranks(args, args.tp * args.dp)
    mesh = common.make_mesh(args)
    model, tokenizer, new_token_ids = common.load(args, mesh)
    inferencer = InterleaveInferencer(
        model, tokenizer, new_token_ids, vit_transform=common.vit_transform(), seed=args.seed,
        mesh=mesh, spec_decode=args.spec, **common.kv_options(args))
    if rank == 0:
        get_logger("unimedvl_tpu_torch.interactive_vqa").info(
            common.loaded_message(t0, inferencer))
    return inferencer


def main(argv=None):
    args = parse_args(argv)
    from PIL import Image

    inferencer = build(args)

    def answer(images, prompt):
        t0 = time.time()
        if args.think:
            out = inferencer(
                image=[Image.open(p) for p in images] or None, text=prompt, think=True,
                understanding_output=True, max_think_token_n=args.max_length,
                do_sample=args.sample, text_temperature=args.temperature)["text"]
        elif args.stream and not args.sample:
            ctx = inferencer.init_gen_context()
            for p in images:
                ctx = inferencer.update_context_image(Image.open(p).convert("RGB"), ctx,
                                                      vae=False, vit=True)
            ctx = inferencer.update_context_text(prompt, ctx)
            for piece in inferencer.gen_text_stream(ctx, max_length=args.max_length):
                common.say(piece, end="", flush=True)
            common.say(f"\n[{time.time() - t0:.2f}s]")
            return
        else:
            out = inferencer.chat([Image.open(p) for p in images], prompt,
                                  max_length=args.max_length, do_sample=args.sample,
                                  temperature=args.temperature)
        common.say(f"[{time.time() - t0:.2f}s] {out}")

    if args.prompt:
        answer(args.image, args.prompt)
        return
    if args.tp * args.dp > 1:
        sys.exit("the REPL reads one terminal: on a mesh, pass --prompt")

    print("Interactive VQA. Commands: /image <path>  /clear  /quit")
    images = list(args.image)
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        if line == "/quit":
            break
        if line == "/clear":
            images = []
            continue
        if line.startswith("/image "):
            images.append(line.split(" ", 1)[1])
            continue
        answer(images, line)


if __name__ == "__main__":
    main()
