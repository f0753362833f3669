"""HTTP serving daemon on the port: unified report and image generation over
the continuous-batching engine (the counterpart of the JAX package's
scripts/serve_http.py). Loads a released checkpoint directory onto the card.

Usage:
  python -m unimedvl_tpu_torch.scripts.serve_http --checkpoint /path/to/ckpt \\
      [--host 127.0.0.1 --port 8000] [--slots 48] [--capacity 4096] [--chunk 16] \\
      [--int8-kv | --int4-kv] [--int8 | --act-int8] [--w4 [--w4-group 512]] [--fused] \\
      [--spec] [--t2i [--gen-chunk 10 --gen-group 4]] [--prefix-text TEXT]

  curl -s localhost:8000/v1/health
  curl -s -X POST localhost:8000/v1/generate \\
      -d '{"prompt": "Describe the findings.", "max_new_tokens": 256}'
  curl -s -X POST localhost:8000/v1/images \\
      -d '{"prompt": "frontal chest radiograph", "height": 512, "width": 512}'

On a ("data", "model") mesh, one process per rank:
  torchrun --nproc-per-node 2 -m unimedvl_tpu_torch.scripts.serve_http \\
      --checkpoint /path/to/ckpt --tp 2 [--dp 1] [--device cpu]
Every rank loads its shard and runs the engine; rank 0 serves HTTP and
fans each round's requests out to the others (inference/server.py).
"""

from __future__ import annotations

import argparse
import sys

from unimedvl_tpu_torch.scripts import common


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    common.add_model_flags(ap)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--slots", type=int, default=48)
    ap.add_argument("--capacity", type=int, default=4096)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--spec", action="store_true", help="speculative continuous batching")
    ap.add_argument("--t2i", action="store_true",
                    help="serve POST /v1/images (an InterleaveInferencer for chunked denoise)")
    ap.add_argument("--gen-chunk", type=int, default=10,
                    help="denoise steps per image segment between decode chunks")
    ap.add_argument("--gen-group", type=int, default=4,
                    help="most images of one geometry and options denoised in one forward")
    ap.add_argument("--dynamic-windows", action="store_true",
                    help="not ported: the port runs any step window without compiling")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prefix-text", default=None, metavar="TEXT",
                    help="register a shared preamble at start-up (prefix_id 0)")
    args = ap.parse_args(argv)
    if args.dynamic_windows:
        sys.exit("--dynamic-windows: the compiled denoise windows are left out of the port "
                 "(ROADMAP, not to port: step_range gives the same schedule, and nothing "
                 "compiles per window)")
    return args


def build(args, model, tokenizer, new_token_ids, mesh=None, vit_transform=None):
    """The engine, the daemon and, on rank 0, the HTTP server (None on the
    other ranks of a mesh, which run ``daemon.follow()``) over ``model``
    (this rank's shard on ``mesh``). ``vit_transform``: the VQA geometry
    unless the caller gives another."""
    from unimedvl_tpu_torch.inference import ContinuousBatcher, InterleaveInferencer
    from unimedvl_tpu_torch.inference.server import ServingDaemon, make_server

    vit_transform = vit_transform or common.vit_transform()
    pipeline = None
    if args.t2i:
        pipeline = InterleaveInferencer(model, tokenizer, new_token_ids,
                                        vit_transform=vit_transform, seed=args.seed, mesh=mesh)
    batcher = ContinuousBatcher(
        model, tokenizer, new_token_ids, args.slots, args.capacity, args.chunk, vit_transform,
        args.seed, spec_decode=args.spec, pipeline=pipeline, mesh=mesh,
        **common.kv_options(args), gen_chunk=args.gen_chunk, gen_group=args.gen_group)
    daemon = ServingDaemon(batcher, mesh=mesh)
    if args.prefix_text:  # on every rank: a prefill, before the loop starts
        pid = batcher.register_prefix(args.prefix_text)
        common.say(f"registered prefix_id {pid} ({len(args.prefix_text)} chars)",
                   file=sys.stderr)
    if not common.is_rank0():
        return daemon, None
    return daemon.start(), make_server(daemon, host=args.host, port=args.port)


def main(argv=None):
    args = parse_args(argv)
    common.init_ranks(args, args.tp * args.dp)
    mesh = common.make_mesh(args)
    model, tokenizer, new_token_ids = common.load(args, mesh)
    daemon, server = build(args, model, tokenizer, new_token_ids, mesh)
    if server is None:
        daemon.follow()
        return
    print(f"serving on http://{args.host}:{server.server_address[1]} (slots {args.slots}"
          f"{', spec' if args.spec else ''}{', t2i' if args.t2i else ''}"
          f"{'' if mesh is None else f', mesh {dict(mesh.shape)}'})", file=sys.stderr)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        daemon.stop()


if __name__ == "__main__":
    main()
