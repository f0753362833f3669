"""What the port's front ends share: the model flags, the process group and
mesh of ``--tp`` / ``--dp`` under ``torchrun``, loading a released
checkpoint (a rank's shard on a mesh) onto the device in the mode the flags
ask for, and the KV cache options.

A mesh run starts one process per rank::

    torchrun --nproc-per-node 4 -m unimedvl_tpu_torch.scripts.interactive_vqa \
        --checkpoint CKPT --tp 2 --dp 2 --image x.png --prompt "..."

Every rank loads its shard and runs the same calls; rank 0 prints. On CUDA
the ranks join over NCCL, rank r on ``cuda:{LOCAL_RANK}``; with ``--device
cpu`` over gloo."""

from __future__ import annotations

import argparse
import datetime
import os
import sys


def add_model_flags(ap: argparse.ArgumentParser) -> None:
    """The checkpoint, device, quantized-mode and mesh flags, named as the
    JAX package's scripts name them."""
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
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree (the mesh's model axis); run under torchrun")
    ap.add_argument("--dp", type=int, default=1,
                    help="data axis size (slots, CFG streams); run under torchrun")


def init_ranks(args, world: int):
    """Join the default process group of a ``torchrun`` launch of ``world``
    ranks (NCCL on CUDA, rank r on ``cuda:{LOCAL_RANK}``; gloo with
    ``--device cpu``) and point ``args.device`` at this rank's device.
    Nothing to do for one rank, or where the caller has made the group
    already (the tests' spawned ranks). Returns the process's rank."""
    import torch
    import torch.distributed as dist

    if world == 1:
        return 0
    if dist.is_available() and dist.is_initialized():  # a group made by the caller
        if dist.get_world_size() != world:
            sys.exit(f"the mesh has {world} ranks, the process group {dist.get_world_size()}")
        return dist.get_rank()
    if "RANK" not in os.environ:
        sys.exit(f"a mesh of {world} ranks runs under torchrun --nproc-per-node {world}")
    if int(os.environ["WORLD_SIZE"]) != world:
        sys.exit(f"the mesh has {world} ranks, torchrun started {os.environ['WORLD_SIZE']}")
    cuda = torch.device(args.device).type == "cuda"
    if cuda:
        args.device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
        torch.cuda.set_device(torch.device(args.device))
    dist.init_process_group("nccl" if cuda else "gloo",
                            timeout=datetime.timedelta(seconds=600))
    return dist.get_rank()


def make_mesh(args):
    """The ("data", "model") mesh of ``--dp`` x ``--tp`` (None for one
    rank); the process group must be up (:func:`init_ranks`)."""
    if args.tp * args.dp == 1:
        return None
    from unimedvl_tpu_torch.parallel.mesh import make_mesh as mk

    return mk(("data", "model"), (args.dp, args.tp))


def is_rank0() -> bool:
    """Whether this process prints: rank 0 of a mesh, or the only one."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def say(*a, **kw) -> None:
    """``print`` on rank 0 only."""
    if is_rank0():
        print(*a, **kw)


def loaded_message(t0: float, inferencer) -> str:
    """The front ends' start-up line: seconds, device and its memory."""
    import time

    from unimedvl_tpu_torch.utils import device_memory_stats

    gib = device_memory_stats(inferencer.device).get("allocated_bytes.all.current", 0) / 2**30
    return (f"model loaded in {time.time() - t0:.1f} s on {inferencer.device} "
            f"({gib:.1f} GiB held)")


def load(args, mesh=None, fuse_tp: int = 1):
    """(model, tokenizer, new_token_ids) from ``args.checkpoint`` on
    ``args.device``, quantized and fused as the flags ask; with ``mesh``
    this rank's shard. ``fuse_tp``: the fused leaves' shard layout (the
    sequence-parallel denoise's "model" degree). bf16 on the card, fp32 on
    the CPU (whose plain versions take no bf16 lm_head)."""
    import torch

    from unimedvl_tpu_torch import quant
    from unimedvl_tpu_torch.data.tokenizer import load_tokenizer
    from unimedvl_tpu_torch.weights.loader import load_bagel_checkpoint

    quantized = args.int8 or args.act_int8
    cpu = torch.device(args.device).type == "cpu"
    model = load_bagel_checkpoint(
        args.checkpoint, device=args.device, base_dir=args.base_checkpoint,
        dtype=torch.float32 if cpu else torch.bfloat16,
        quantize_bits=(4 if args.w4 else 8) if quantized else None,
        act_quant=args.act_int8, quantize_group=args.w4_group if quantized else 0, mesh=mesh)
    if args.fused:
        quant.fuse_serving_projections(model.language_model, tp=fuse_tp)
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
