"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): builds the CUDA
kernels from ``unimedvl_tpu_torch/csrc``, holds each kernel against its plain
PyTorch version at the paths' shapes, then, with the full 14B geometry
(random bf16 weights and an fp32 VAE from a seed):

- the chat path: three VQA requests through ``InterleaveInferencer.chat``;
  then the 378x378 request sampled, two ``chat_turn``s and a
  ``gen_text_stream``, each by its captured device program and by its eager
  loop (tokens equal);
- the generation path: a 512x512 text-to-image request and a 512x512 image
  edit through ``interleave_inference`` with the recipe's defaults (50
  timesteps, CFG text 3.0 and image 1.5 on the interval (0.4, 1.0], global
  renorm); the VAE decode of the text-to-image latent by its captured
  program against the eager decode (within 1 per pixel);
- the quantized chat path, the LLM quantized on the card with an int8 KV
  cache and fused projections: full-int8 (the three chat requests), w4a8
  per channel and w4a8 with groups of 512 (one request each), weight-only w4
  per channel (the 980x980 and 378x378 requests);
- the batched serving path: ``ContinuousBatcher`` (a pool of 16 streams x
  6144 columns, chunks of 16, the pool ladder) serving 24 requests (980x980,
  378x532 and 378x378 images, text prompts, four on a registered preamble)
  in two waves with bf16 weights and a bf16 pool (run A) and an int8 pool
  (run B), and 12 378x378 requests with w4a8 weights and an int8 pool (run
  C); each run's first-step logits (images admitted in groups of one
  bucket, text, text after the preamble) held to chat's, and its answers to
  chat's up to near-ties; A's and B's pools also near capacity, where the
  batcher falls back to the scatter chunk; run D, B's workload decoded
  speculatively (``spec_decode=True``, 7 drafts a verify forward, no ladder);
- the unified serving path (run E): the batcher with ``pipeline=`` serving 12
  of run A's text and image requests beside eight text-to-image requests
  (four 512x512, four 256x256: two groups of four images denoised in one
  forward a step, ``gen_chunk`` 10), text answers gated against chat's and
  each image's latent against the one-shot path; then the HTTP front end
  (``ServingDaemon``, ``make_server`` on 127.0.0.1): /v1/generate with an
  image, /v1/images at 512x512, /v1/health;
- the quantized generation path (run H): the 512x512 text-to-image request
  and the edit in full-int8, w4a8 per channel and weight-only w4 per channel
  (fused, int8 KV cache), K3 and K4 at every projection of the denoise
  steps; each first velocity held to the same quantized model's plain
  versions;
- batched VQA eval (run F): ``eval.run_vqa_eval`` over run A's 16 image
  requests in a pool of 16 x 6144, three times: a bf16 pool, an int8 pool
  and an int4 pool (``kv_bits=4``: values packed two a byte, unpacked a
  layer at a time for K2-int8), the bf16 predictions gated against chat's,
  the accuracy and the report metrics against chat's answers;
- the vqa-reconstruction recipes (run G): ``inference_ver=1`` on a 512x512
  image (an answer, then the image generated again from it) and ``_ver0_1``
  over two images, ver1's first velocity and final latent held to the plain
  versions and to ``gen_image_latent`` on the same contexts;
- the speculative decode path: ``InterleaveInferencer(spec_decode=True)``
  answering the three chat requests, the 378x378 request at 128 tokens
  plainly and speculatively (the lookup over a junk history and over the
  plain answer planted; junk drafts, the floor, and the plain answer as
  drafts, the ceiling), planted and oracle again in w4a8 (K4's int8 GEMM and
  K3 at m 8), two ``chat_turn``s and a ``gen_text_stream``; every answer gated
  against chat's up to near-ties; the decodes run as captured device
  programs, and the chat, the ``chat_turn``s and run D once more eagerly
  (tokens and verify forwards equal); K1a at the verify block's shapes (T 8);
- the training path: LoRA steps (rank 16, every projection of both experts)
  over the frozen model cut to ``LORA_LAYERS`` layers, on packed batches of synthetic VQA,
  text-to-image and editing examples (980 px and 378 px understanding
  images, 512 px generation images) from ``PackedBatchIterator`` through
  ``Prefetcher``; then full fine-tune steps (gradient accumulation 2, EMA)
  at the full width with the depth cut to what one card holds, and once more
  with the understanding expert frozen;
- the sequence-parallel denoise path: the same two generation requests
  through an inferencer with ``sp_mesh``, a ("model", "seq") mesh of 1 x 1
  (one card holds one rank) on a one-rank NCCL group, so that the collective
  calls really run (a group that cannot start fails the run), every layer's
  attention as a cache partial and a block partial (K1c twice) merged by
  their log-sum-exps; each flow step a captured graph
  (``sp_denoise.SPProgram``, the collectives inside it), the text-to-image
  denoise once more by the eager loop;
- the serving paths under ``mesh=`` (M13's serving side) on a one-rank
  ("data", "model") NCCL mesh over the same model, by their captured
  programs (every collective inside the graphs) and once eagerly: the three
  chat requests, run A's 24 requests through ``ContinuousBatcher(mesh=...)``,
  run F's bf16 eval through ``run_vqa_eval(mesh=...)`` and a 512x512
  text-to-image request (11 timesteps) through ``gen_images_grouped`` on a
  1 x 1 x 1 ("data", "model", "seq") mesh, each equal to the same call
  without the mesh and to its eager route; tensor parallelism
  over two processes sharing the card (gloo, eagerly: no graph captures a
  host-staged collective; each builds only its shard of
  the same seeded weights): the 980x980 chat request in bf16 and in w4a8
  (K4 at the shard shapes, K3's second entry with the row scales all-reduced
  with MAX), held to the one-rank model; the sharded loader on a 2-layer
  checkpoint at the 14B width; and every kernel at a rank's shapes for tp 2
  and 4 (``check_shard_shapes``; K5 at a TP-2 rank's 14 / 2 heads);
- training on a mesh (run K, M13's training side) at the full width and the
  fine-tune's depth: the TP x DP step on a one-rank NCCL mesh, bit-equal to
  the step without a mesh; the GPipe step on a one-rank NCCL ("data",
  "pipe", "model") mesh by its program (one "pipeline" graph: the schedule,
  its broadcasts and the reverse schedule), held to the eager step and
  replayed on new inputs; then over two processes sharing the card (gloo,
  each building only its shard of the same seeded weights) a TP-2 step, an
  FSDP step over two data ranks and a GPipe step over two stages, each held
  to the one-rank step's loss and gradients at a bound set from the floor
  measured in the same call (kernels against plain versions), with the
  replicated tensors bit-equal on both ranks after one more step;

and checks that every kernel call of each path went through the kernels, and
that each path's output agrees with the same computation on the kernels'
plain versions.

    python3 chip_smoke.py

Needs a CUDA device; exits non-zero without one, or on any failed check. The
last line of standard output is ``{"ok": true, "device": {...}}``; the line
before it lists each kernel with its launches on the paths, its error
against the plain version, both times, the least time the card could take
for the same work (``bound_ms``, from the bytes moved and the operations
done at the peaks below) and, where one PyTorch call computes the same
function, that call's time.
"""

from __future__ import annotations

import contextlib
import copy
import datetime
import gc
import hashlib
import itertools
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import weakref
from functools import partial

import numpy as np
import torch

from unimedvl_tpu_torch.config import (BagelConfig, E2EVAEConfig, LLMConfig, TransformConfig,
                                       VAEConfig, ViTConfig)
from unimedvl_tpu_torch.data.tokenizer import ByteTokenizer, add_special_tokens
from unimedvl_tpu_torch import quant
from unimedvl_tpu_torch.inference import ContinuousBatcher, InterleaveInferencer, Request, serving
from unimedvl_tpu_torch.inference import programs
from unimedvl_tpu_torch.models import bagel, qwen2_mot, siglip
from unimedvl_tpu_torch.models.layers import QuantLinear
from unimedvl_tpu_torch.ops import act_quant as aq
from unimedvl_tpu_torch.ops import cuda_build
from unimedvl_tpu_torch.ops import decode_attention as dec
from unimedvl_tpu_torch.ops import flash_attention as fa
from unimedvl_tpu_torch.ops import flash_attention_train as fat
from unimedvl_tpu_torch.ops import w4_matmul as w4
from unimedvl_tpu_torch.ops.attention import combine_attention_partials
from unimedvl_tpu_torch.ops.blockmask import dense_packed_mask, packed_segment_ids
from unimedvl_tpu_torch.ops.rope import rope_cos_sin
from unimedvl_tpu_torch.parallel import mesh as pmesh
from unimedvl_tpu_torch.parallel import sp_denoise
from unimedvl_tpu_torch.tools import time_quant_kernels as tqk
from unimedvl_tpu_torch.training import dataset, e2e_vae, lora, trainer

SEED = 0
# kernel vs plain version (fp32 softmax over the same bf16 inputs): the kernel
# rounds P to bf16 for the P V product and its output to bf16 (half an ulp is
# 2^-9 of the value), so each element must satisfy
# |kernel - plain| <= ATOL + RTOL * |plain|, and the mean error stay small
ATOL = 1e-2
RTOL = 2.0**-7
MEAN_ABS_TOL = 2e-3
# the whole path with kernels vs with the plain versions: first-step logits of
# a chat request, first-step post-CFG velocity of a generation request
LOGITS_COS_TOL = 0.999
# One attention call inside the model against its plain version on the same
# inputs (the quantized paths with their int8 activations replayed): both
# round their output to bf16 (2^-9 of a value), so 1 - cos is of order 1e-6;
# a wrong mask, scale or head map reads far below the bound
ATTN_COS_TOL = 0.9999
# The velocity's bound comes from its noise floor, measured on an H100 80GB
# HBM3 (PERF.md): the plain versions in bf16 (p and q's island rounded to
# bf16, as the kernels round them) against the plain versions with fp32
# attention read cosine 0.999104 on one device and 0.999093 on the
# sequence-parallel path, 1 - cos = 9.1e-4: bf16 rounding inside attention,
# amplified by CFG (text 3.0, image 1.5, renorm). The kernels read 0.999092 and
# 0.999062 against fp32 attention, on the floor; the sequence-parallel program
# reads 0.998981-0.998999 against the single-device one in every variant, fp32
# attention included (its sums run in another order). The bound allows twice
# the floor, 1 - 2 * 9.07e-4; it also holds the SP path to the single device.
VELOCITY_COS_TOL = 1 - 2 * (1 - 0.999093)
# K1c's log-sum-exp against the plain version's: absolute, where that is finite;
# where it is float32 min (a row that sees nothing) the kernel's must equal it
LSE_ATOL = 1e-3
NEG_INF = float(torch.finfo(torch.float32).min)
REQUESTS = [  # (height, width, prompt): already at stride-14 sizes
    (980, 980, "What abnormality is visible in this chest radiograph?"),
    (378, 532, "Which organ is shown, and is the finding benign?"),
    (378, 378, "Is there a pleural effusion in this image?"),
]
MAX_LENGTH = 32
GEN_SIZE = (512, 512)
W4_GROUP = 512
# K3 against its plain version: scales relative, q in steps, share of q that may differ
K3_SCALE_RTOL, K3_MAX_STEP, K3_MAX_SHARE = 1e-6, 1, 1e-3
# Published peaks of one H100 SXM (dense): the card's bound for a kernel is the
# larger of bytes / HBM rate and operations / the peak rate of their type
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
GEN_PROMPT = "A chest radiograph with a small left pleural effusion."
EDIT_PROMPT = "Make the opacity in the right lower lobe more visible."


def cuda_ms(fn, warmup: int = 2, iters: int = 7, reps: int = 1) -> float:
    """Median milliseconds of one ``fn`` on the current stream (CUDA events
    around ``reps`` calls in a row)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


BACK_TO_BACK = 20  # calls in a row for a one-row shape, as a decode loop makes them


def back_to_back_ms(fn) -> float:
    """Milliseconds per call in a run of BACK_TO_BACK calls: the device-side
    figure for a one-row shape, whose single call is mostly the wrapper's
    host time (the card waits for the launch)."""
    return cuda_ms(fn, iters=5, reps=BACK_TO_BACK)


def _b2b_text(ms) -> str:
    return "" if ms is None else f"; {ms:.4f} ms per call in a run of {BACK_TO_BACK}"


def bound(n_bytes: float, n_ops: float, op_type: str) -> dict:
    """The least time the card could take: each input byte read once and each
    output byte written once at the HBM rate, or the operations at the peak
    rate of their type, whichever is larger."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / PEAK_OPS_S[op_type]
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def attention_bound(q_rows, keys, H, Hk, D, kv_bytes: int, op_type: str, scales=False,
                    pairs=None, extra_bytes: float = 0.0) -> dict:
    """Bound of an attention call from this run's data: ``q_rows`` and
    ``keys`` are per-stream sequences of valid query rows and of the keys they
    see; ``pairs`` the visible (row, key) pairs per stream (rows x keys unless
    given: a causal block sees fewer). q and out are bf16; k and v rows of
    ``kv_bytes`` per element, read once per kv head; ``extra_bytes`` for a
    further output (the log-sum-exp)."""
    n_bytes, n_ops = float(extra_bytes), 0.0
    pairs = [r * kv for r, kv in zip(q_rows, keys)] if pairs is None else pairs
    for rows, kv, n_pairs in zip(q_rows, keys, pairs):
        n_bytes += 2 * rows * H * D * 2 + 2 * kv * Hk * D * kv_bytes
        if scales:
            n_bytes += 2 * kv * Hk * 4
        n_ops += 4.0 * H * D * n_pairs
    return bound(n_bytes, n_ops, op_type)


def sdpa_ms(q, k, v, mask) -> float:
    """Time of one ``scaled_dot_product_attention`` call on the same inputs
    and mask: q [S, T, H, D], k/v head-major [S, Hk, M, D] (the heads of a
    group expanded beforehand, outside the timing), mask bool [S, T, M]."""
    G = q.shape[2] // k.shape[1]
    qh = q.transpose(1, 2)
    kh, vh = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
    m = mask[:, None]
    return cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=m), warmup=1, iters=5)


CARD = None  # the card's name and power limit, as nvidia-smi gives them


def check_device() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    global CARD
    CARD = smi
    print(smi)
    print(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)


def build_kernels() -> None:
    t0 = time.perf_counter()
    cuda_build.load_library()
    print(f"kernel build+load: {time.perf_counter() - t0:.1f} s", flush=True)
    log = cuda_build.library_path().with_suffix(".log")
    if log.exists():  # absent when the library was already built
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print("  ptxas:", line.strip())


def _compare(name, kernel_fn, plain_fn, rows, back_to_back=None, row_atol=False, valid=None):
    """Kernel vs plain on the valid query rows [:, :rows], or on the rows
    that ``valid`` (bool [S, T]) marks; both times, and the kernel's time per
    call in a run of calls (``back_to_back``; by default for a one-row
    shape). ``row_atol``: the absolute part of the bound is RTOL times the
    largest |plain| of the output row [..., D] instead of ATOL, for outputs
    whose size the inputs' scales set."""
    got = kernel_fn()
    torch.cuda.synchronize()
    want = plain_fn()
    pick = (lambda t: t[:, :rows]) if valid is None else (lambda t: t[valid])
    ref = pick(want).float()
    diff = (pick(got).float() - ref).abs()
    max_abs, mean_abs = diff.max().item(), diff.mean().item()
    atol = RTOL * ref.abs().amax(dim=-1, keepdim=True) if row_atol else ATOL
    worst = (diff / (atol + RTOL * ref.abs())).max().item()
    ms, plain_ms = cuda_ms(kernel_fn), cuda_ms(plain_fn, warmup=1, iters=3)
    b2b = back_to_back_ms(kernel_fn) if (rows == 1 if back_to_back is None else back_to_back) \
        else None
    print(f"  {name}: max_abs_err {max_abs:.3e} mean_abs_err {mean_abs:.3e} "
          f"worst err/bound {worst:.3f} (|ref| max {ref.abs().max().item():.3f}, mean "
          f"{ref.abs().mean().item():.4f}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms"
          f"{_b2b_text(b2b)}", flush=True)
    if not (worst <= 1.0 and mean_abs <= MEAN_ABS_TOL):
        raise SystemExit(f"chip_smoke: {name} disagrees with its plain version")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, "ms_back_to_back": b2b}


def check_kernels() -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    print(f"kernel checks (bf16 inputs; tolerance |err| <= {ATOL} + {RTOL} |ref| "
          f"per element, mean abs <= {MEAN_ABS_TOL}):", flush=True)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    dev, bf = "cuda", torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(bf)

    def ints(*vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)

    results = {"flash_block_attention": [], "decode_attention": [], "q_preproc": []}
    # K1a, ViT: 980 px image = 4900 patches in the 5120 bucket, D = 72, k/v [N, T, H, D]
    T = 5120
    q, k, v = randn(1, T, 16, 72, scale=2.0), randn(1, T, 16, 72), randn(1, T, 16, 72)
    lens, bstart = ints(4900), ints(T)
    vit = _compare(
        "K1a ViT T=5120 D=72 non-causal, 4900 valid",
        lambda: fa.flash_block_attention(q, k, v, lens, bstart, False),
        lambda: fa.flash_block_attention_ref(q, k, v, lens, bstart, False), 4900)
    vit.update(attention_bound([4900], [4900], 16, 16, 72, 2, "bf16"))
    jv = torch.arange(T, device=dev)
    vit["library_ms"] = sdpa_ms(q, k.transpose(1, 2), v.transpose(1, 2),
                                (jv < 4900)[None, None].expand(1, T, T))
    print(f"    bound {vit['bound_ms']:.4f} ms by {vit['bound_by']}; SDPA, same mask "
          f"{vit['library_ms']:.3f} ms", flush=True)
    results["flash_block_attention"].append(vit)
    # K1a, LLM image block: T = 5122 over a 5632-column head-major cache, 4902 valid
    M = 5632
    q = randn(1, 5122, 28, 128, scale=2.0)
    kc, vc = randn(1, 4, M, 128), randn(1, 4, M, 128)
    zero, qvl = ints(0), ints(4902)
    image = _compare(
        "K1a image prefill T=5122 M=5632 D=128 non-causal",
        lambda: fa.flash_block_attention(q, kc, vc, zero, zero, False, qvl, True),
        lambda: fa.flash_block_attention_ref(q, kc, vc, zero, zero, False, qvl, True), 4902,
        back_to_back=True)
    image.update(attention_bound([4902], [4902], 28, 4, 128, 2, "bf16"))
    jk = torch.arange(M, device=dev)
    image["library_ms"] = sdpa_ms(q, kc, vc, (jk < 4902)[None, None].expand(1, 5122, M))
    results["flash_block_attention"].append(image)
    # K1a, LLM text block: causal, 40 of 64 rows valid, after a 4902-token context
    q = randn(1, 64, 28, 128, scale=2.0)
    lens, qvl = ints(4902), ints(40)
    results["flash_block_attention"].append(_compare(
        "K1a text prefill T=64 (40 valid) causal after 4902",
        lambda: fa.flash_block_attention(q, kc, vc, lens, lens, True, qvl, True),
        lambda: fa.flash_block_attention_ref(q, kc, vc, lens, lens, True, qvl, True), 40))
    # K1a, two streams with differing lens
    q2 = randn(2, 64, 28, 128, scale=2.0)
    kc2, vc2 = randn(2, 4, 2048, 128), randn(2, 4, 2048, 128)
    lens2, qvl2 = ints(1500, 37), ints(64, 21)
    results["flash_block_attention"].append(_compare(
        "K1a S=2 causal, lens (1500, 37)",
        lambda: fa.flash_block_attention(q2, kc2, vc2, lens2, lens2, True, qvl2, True),
        lambda: fa.flash_block_attention_ref(q2, kc2, vc2, lens2, lens2, True, qvl2, True),
        21))
    # K2: chat decode, one stream, band [4950, 4960]
    qd = randn(1, 1, 28, 128, scale=2.0)
    lens, base, col = ints(4950), ints(4950), ints(4960)
    name = "K2 decode S=1 M=5632 lens=4950 band [4950, 4960]"
    kernel = lambda: dec.decode_attention(qd, kc, vc, lens, (base, col))  # noqa: E731
    step = _with_splits(name, 1, M, _compare(
        name, kernel, lambda: dec.decode_attention_ref(qd, kc, vc, lens, (base, col)), 1),
        kernel)
    step.update(attention_bound([1], [4961], 28, 4, 128, 2, "bf16"))
    step["library_ms"] = sdpa_ms(qd, kc, vc, (jk < 4961)[None, None])
    results["decode_attention"].append(step)
    # K2: three streams with differing lens and the aligned band
    qd3 = randn(3, 1, 28, 128, scale=2.0)
    kc3, vc3 = randn(3, 4, M, 128), randn(3, 4, M, 128)
    lens3, base3, col3 = ints(100, 2000, 4950), ints(4950, 4950, 4950), ints(4955, 4955, 4955)
    name = "K2 decode S=3 lens (100, 2000, 4950) band [4950, 4955]"
    kernel = lambda: dec.decode_attention(qd3, kc3, vc3, lens3, (base3, col3))  # noqa: E731
    results["decode_attention"].append(_with_splits(name, 3, M, _compare(
        name, kernel, lambda: dec.decode_attention_ref(qd3, kc3, vc3, lens3, (base3, col3)), 1),
        kernel))
    denoise = check_q_preproc(randn, ints, results["q_preproc"])
    # the 512 px 3-stream denoise: 1026 rows over lens (37, 0, 37) + the block
    denoise.update(attention_bound([1026] * 3, [37 + 1026, 1026, 37 + 1026], 28, 4, 128, 2, "bf16"))
    denoise["library_ms"] = None  # no PyTorch call norms and rotates q inside attention

    def summary(rows, shown):
        out = dict(shown)
        out["max_abs_err"] = max(r["max_abs_err"] for r in rows)
        return out

    timings = {
        "flash_block_attention": dict(summary(results["flash_block_attention"], image),
                                      vit={key: vit[key] for key in (
                                          "ms", "ms_back_to_back", "bound_ms", "library_ms")}),
        "flash_block_attention_q_preproc": summary(results["q_preproc"], denoise),
        "decode_attention": dict(summary(results["decode_attention"], step),
                                 cases=[r["case"] for r in results["decode_attention"]]),
    }
    timings["flash_block_attention_lse"] = check_return_lse(randn, ints)
    timings["flash_cache_block_attention"] = check_cache_block(randn, ints)
    timings["decode_attention_int8"] = check_decode_int8(g, randn, ints)
    timings["silu_mul_quant"] = check_silu_mul_quant(randn)
    timings["w4_matmul"], timings["w4_matmul_simple"] = check_w4_matmul(g, randn)
    for name, rows in check_serving_shapes(g, randn, ints).items():
        timings[name]["serving_cases"] = rows
    print("K1a at the speculative verify shapes:", flush=True)
    timings["flash_block_attention"]["spec_cases"] = check_spec_k1a(randn, ints)
    print("K1b at the grouped denoise shapes (run E):", flush=True)
    timings["flash_block_attention_q_preproc"]["group_cases"] = check_group_k1b(randn, ints)
    for name, rows in check_generation_quant_shapes(g, randn).items():
        timings[name]["gen_cases"] = rows
    timings["decode_attention_int8"]["int4_cases"] = check_int4_decode(g, randn, ints)
    shard_rows, timings["silu_mul_quant_global"] = check_shard_shapes(g, randn, ints)
    for name, rows in shard_rows.items():
        timings.setdefault(name, {})["shard_cases"] = rows
    return timings


def graph_ms(fn) -> float:
    """Milliseconds per call in a CUDA graph of BACK_TO_BACK calls: the
    card's time alone, where a run of calls reads the wrapper's host time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(BACK_TO_BACK):
            fn()
    return cuda_ms(graph.replay, iters=5) / BACK_TO_BACK


def _with_splits(name, S, M, row, kernel_fn) -> dict:
    """The split plan the decode kernels launched with at this shape (28/4
    heads), printed, and kept in the row beside its time per call in a run
    and in a CUDA graph (the decode kernels take less time than their
    wrapper's host work, so only the graph shows the card's time)."""
    n_split, split_len = dec.plan_splits(S, 4, M)
    row["ms_in_graph"] = graph_ms(kernel_fn)
    print(f"    {n_split} split(s) of {split_len} keys: grid ({n_split}, 4, {S})"
          f"{', and a combine launch' if n_split > 1 else ''}; {row['ms_in_graph']:.4f} ms per "
          f"call in a CUDA graph of {BACK_TO_BACK}", flush=True)
    row.update(n_split=n_split, split_len=split_len)
    row["case"] = dict(case=name, n_split=n_split, ms_back_to_back=row["ms_back_to_back"],
                       ms_in_graph=row["ms_in_graph"])
    return row


def _rand_int8(g, *shape, lo=-127, hi=128):
    return torch.randint(lo, hi, shape, generator=g, device="cuda", dtype=torch.int8)


def _line(name, err, ms, plain_ms, b, extra=""):
    print(f"  {name}: {err}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{b['bound_ms']:.4f} ms by {b['bound_by']}{extra}", flush=True)


def _island(g, S, rows=1, end_row=None, position=41) -> dict:
    """Options of one qk-norm + RoPE island: random norm weights, tables of
    ``rows`` rows per stream (1: the whole block at one rope position)."""
    pos = torch.full((S, rows), position, device="cuda")
    if rows > 1:
        pos = pos + torch.arange(rows, device="cuda")
    cos, sin = rope_cos_sin(pos, 128, 1e6)
    w = [(1 + 0.1 * torch.randn(128, generator=g, device="cuda")).to(torch.bfloat16)
         for _ in range(2)]
    return dict(w_und=w[0], w_gen=w[1], cos=cos, sin=sin, end_row=end_row, eps=1e-6)


def check_return_lse(randn, ints) -> dict:
    """K1c at the sequence-parallel denoise's shapes, with ``q_preproc`` and
    one rope row per block: the cache partial (``block_start = lens``, no
    block keys) over the text-to-image and the edit caches, the block partial
    (``lens = block_start = Tblk`` over exactly Tblk keys, read through the
    strides of a [S, Tblk, Hk, D] block), on the 1 x 1 mesh (H 28 / Hk 4,
    T 1026) and at the local shapes of a TP2 x SP4 rank (H 14 / Hk 2, T 258,
    1026 gathered keys). Then the two kernel partials, merged, against K1b's
    plain version over the concatenation. SDPA, the library call beside it,
    returns no log-sum-exp and is given the pre-processed q."""
    print(f"K1c return_lse (output as the attention tolerance; lse within {LSE_ATOL} of the "
          "plain version's where that is finite, equal to it where it is float32 min):",
          flush=True)
    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    Tblk = 1026
    cases = [
        # (name, S, T, H, Hk, cache capacity or None (block partial), lens)
        ("cache partial, text-to-image, lens (56, 0, 56)", 3, 1026, 28, 4, 512, (56, 0, 56)),
        ("cache partial, text-to-image, 1 stream", 1, 1026, 28, 4, 512, (56,)),
        ("cache partial, edit, lens (2453, 2397, 56)", 3, 1026, 28, 4, 2560, (2453, 2397, 56)),
        ("cache partial, edit, 1 stream", 1, 1026, 28, 4, 2560, (2453,)),
        ("block partial, 3 streams over 1026 keys", 3, 1026, 28, 4, None, None),
        ("block partial, 1 stream", 1, 1026, 28, 4, None, None),
        ("TP2 x SP4 rank, cache partial, lens (56, 0, 56)", 3, 258, 14, 2, 512, (56, 0, 56)),
        ("TP2 x SP4 rank, block partial over 1026 gathered keys", 3, 258, 14, 2, None, None),
    ]
    rows, kept = [], {}
    for name, S, T, H, Hk, cap, lens in cases:
        q = randn(S, T, H, 128, scale=2.0)
        qp = _island(g, S)
        if cap is None:  # the gathered block, as the path hands it over: a transposed view
            k, v = randn(S, Tblk, Hk, 128).transpose(1, 2), randn(S, Tblk, Hk, 128).transpose(1, 2)
            ln, keys = Tblk, [Tblk] * S
        else:
            k, v = randn(S, Hk, cap, 128), randn(S, Hk, cap, 128)
            ln, keys = ints(*lens), list(lens)
        kw = dict(q_valid_len=0, kv_head_major=True, q_preproc=qp, return_lse=True)

        def kernel():
            return fa.flash_block_attention(q, k, v, ln, ln, False, **kw)

        def plain():
            return fa.flash_block_attention_ref(q, k, v, ln, ln, False, **kw)

        r = _compare(f"K1c {name}: S={S} T={T} H={H} M={k.shape[2]}", lambda: kernel()[0],
                     lambda: plain()[0], T, back_to_back=False)
        got, want = kernel()[1], plain()[1]
        empty = want == NEG_INF
        lse_err = (got - want).abs()[~empty].max().item() if (~empty).any() else 0.0
        ok = (torch.equal(got[empty], want[empty]) and bool(torch.isfinite(got).all())
              and lse_err <= LSE_ATOL)
        print(f"    lse: max abs err {lse_err:.3e} over the rows that see keys; "
              f"{int(empty.sum())} of {empty.numel()} rows see none and hold float32 min in "
              f"both: {torch.equal(got[empty], want[empty])}", flush=True)
        if not ok or got.shape != (S, T, H) or got.dtype != torch.float32:
            raise SystemExit(f"chip_smoke: K1c {name}: the log-sum-exp disagrees")
        r["max_abs_err_lse"] = lse_err
        r.update(attention_bound([T] * S, keys, H, Hk, 128, 2, "bf16",
                                 extra_bytes=S * T * H * 4))
        r["library_ms"] = None
        if S == 3 and H == 28:  # SDPA on the same mask, q pre-processed beforehand
            M = k.shape[2]
            mask = (torch.arange(M, device="cuda")[None, None]
                    < (ints(*keys))[:, None, None]).expand(S, T, M)
            r["library_ms"] = sdpa_ms(fa.preprocess_q(q, qp), k, v, mask)
        print(f"    bound {r['bound_ms']:.4f} ms by {r['bound_by']}"
              + ("" if r["library_ms"] is None else
                 f"; SDPA on the same mask (no lse; q pre-processed outside) "
                 f"{r['library_ms']:.3f} ms"), flush=True)
        rows.append(r)
        kept[name] = (q, k, v, ln, qp, r)
    # merge of the two kernel partials against K1b's plain version over the concatenation
    q, kc, vc, ln, qp, _ = kept[cases[0][0]]
    _, kb, vb, _, _, _ = kept[cases[4][0]]
    kw = dict(q_valid_len=0, kv_head_major=True, q_preproc=qp, return_lse=True)

    def merged():
        part_c = fa.flash_block_attention(q, kc, vc, ln, ln, False, **kw)
        part_b = fa.flash_block_attention(q, kb, vb, Tblk, Tblk, False, **kw)
        return combine_attention_partials([part_c, part_b])

    k_cat, v_cat = torch.cat([kc, kb], dim=2), torch.cat([vc, vb], dim=2)
    M0 = kc.shape[2]
    _compare("K1c cache + block partials merged vs K1b's plain version over the concatenation",
             merged, lambda: fa.flash_block_attention_ref(
                 q, k_cat, v_cat, ln, M0, False, None, True, q_preproc=qp), 1026,
             back_to_back=False)
    k1b = cuda_ms(lambda: fa.flash_block_attention(q, k_cat, v_cat, ln, M0, False, None, True,
                                                   q_preproc=qp))
    print(f"    beside it: one K1b call over the ready concatenation {k1b:.3f} ms", flush=True)
    # the line's row: the block partial of the 3-stream step; the cache partials beside it
    out = dict(kept[cases[4][0]][5])
    out["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    out["max_abs_err_lse"] = max(r["max_abs_err_lse"] for r in rows)
    out["cache_partial_t2i_ms"] = kept[cases[0][0]][5]["ms"]
    out["cache_partial_edit_ms"] = kept[cases[2][0]][5]["ms"]
    out["library_note"] = "SDPA on the same mask with q pre-processed outside; it returns no lse"
    return out


def check_cache_block(randn, ints) -> dict:
    """K6 against its plain version: (a) the denoise step that leaves the
    cache as it is (S 3, T = Tb = 1026 over the edit's cache, q and k islands
    fused, one rope row per block), timed beside what the port runs there: the
    k island in torch, the copy of cache and block into one array, one K1b
    call; (b) a TP2 x SP4 rank's local queries over gathered raw keys
    (``block_len``, the k island's own end row); (c) a causal text block over a
    cache of 800, no island; (d) a k island with one table row per block row."""
    print("K6 flash_cache_block_attention (the attention tolerance):", flush=True)
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    cases = [
        # (name, S, T, Tb, H, Hk, M, lens, causal, q island, k island rows (0: none), k end row,
        #  block_len)
        ("(a) denoise without cache update, edit cache", 3, 1026, 1026, 28, 4, 2560,
         (2453, 2397, 56), False, True, 1, None, None),
        ("(b) TP2 x SP4 rank, gathered raw keys", 3, 258, 1026, 14, 2, 512, (56, 0, 56), False,
         True, 1, 1025, 1026),
        ("(c) causal text block over a cache of 800", 1, 64, 64, 28, 4, 1024, (800,), True,
         False, 0, None, None),
        ("(d) k tables with a row per block row", 2, 130, 130, 28, 4, 512, (100, 37), False,
         True, 130, None, None),
    ]
    rows = []
    for name, S, T, Tb, H, Hk, M, lens, causal, q_pre, k_rows, k_end, block_len in cases:
        q = randn(S, T, H, 128, scale=2.0)
        kc, vc = randn(S, Hk, M, 128), randn(S, Hk, M, 128)
        kb, vb = randn(S, Tb, Hk, 128, scale=2.0 if k_rows else 1.0), randn(S, Tb, Hk, 128)
        ln = ints(*lens)
        qp = _island(g, S) if q_pre else None
        kvp = None
        if k_rows:
            kvp = _island(g, S, k_rows, k_end)
            if k_rows == 1:  # the defaults: q's tables
                del kvp["cos"], kvp["sin"]
            if k_end is None:
                del kvp["end_row"]
        kw = dict(q_preproc=qp, kv_preproc=kvp, block_len=block_len, cache_head_major=True)
        r = _compare(
            f"K6 {name}: S={S} T={T} Tb={Tb} H={H} M={M}",
            lambda: fa.flash_cache_block_attention(q, kc, vc, kb, vb, ln, causal, **kw),
            lambda: fa.flash_cache_block_attention_ref(q, kc, vc, kb, vb, ln, causal, **kw), T,
            back_to_back=False)
        blk = Tb if block_len is None else block_len
        # q and out once, the visible cache keys and the block once per kv head; a causal
        # block shows row i its first i + 1 keys
        pairs = [T * n + (T * (T + 1) // 2 if causal else T * blk) for n in lens]
        r.update(attention_bound([T] * S, [n + blk for n in lens], H, Hk, 128, 2, "bf16",
                                 pairs=pairs))
        r["library_ms"] = None
        print(f"    bound {r['bound_ms']:.4f} ms by {r['bound_by']}", flush=True)
        if name.startswith("(a)"):
            full = dict(qp, **kvp)

            def k_island():
                return fa.preprocess_q(kb, full)

            def concat(kp):
                return (torch.cat([kc, kp.transpose(1, 2)], dim=2),
                        torch.cat([vc, vb.transpose(1, 2)], dim=2))

            kp = k_island()
            k_cat, v_cat = concat(kp)

            def k1b():
                return fa.flash_block_attention(q, k_cat, v_cat, ln, M, False, None, True,
                                                q_preproc=qp)

            def today():
                kc2, vc2 = concat(k_island())
                return fa.flash_block_attention(q, kc2, vc2, ln, M, False, None, True,
                                                q_preproc=qp)

            def k6_q_only():
                return fa.flash_cache_block_attention(q, kc, vc, kp, vb, ln, False, q_preproc=qp,
                                                      cache_head_major=True)

            t = dict(k_island=cuda_ms(k_island), concat=cuda_ms(lambda: concat(kp)),
                     k1b=cuda_ms(k1b), today=cuda_ms(today), k6_q_only=cuda_ms(k6_q_only))
            diff = (fa.flash_cache_block_attention(q, kc, vc, kb, vb, ln, False, **kw).float()
                    - today().float()).abs().max().item()
            print(f"    beside it, what the no-update denoise runs today: k island in torch "
                  f"{t['k_island']:.3f} ms + concat copy {t['concat']:.3f} ms + K1b "
                  f"{t['k1b']:.3f} ms = {t['today']:.3f} ms in one go; K6 with both islands "
                  f"{r['ms']:.3f} ms; K6 with the q island only (k processed outside, "
                  f"{t['k_island']:.3f} ms more) {t['k6_q_only']:.3f} ms; max abs difference "
                  f"K6 vs today's {diff:.3e}", flush=True)
            mask = (torch.arange(M + Tb, device="cuda")[None, None]
                    < ln[:, None, None]) | (torch.arange(M + Tb, device="cuda") >= M)
            r["library_ms"] = sdpa_ms(fa.preprocess_q(q, qp), k_cat, v_cat,
                                      mask.expand(S, T, M + Tb))
            r.update(concat_k1b_ms=t["today"], k_island_ms=t["k_island"],
                     concat_copy_ms=t["concat"], k1b_on_concat_ms=t["k1b"],
                     q_island_only_ms=t["k6_q_only"],
                     library_note="SDPA over the ready concatenation, q and k pre-processed "
                                  "outside")
            print(f"    SDPA over the ready concatenation (islands and copy outside) "
                  f"{r['library_ms']:.3f} ms", flush=True)
        rows.append(r)
    out = dict(rows[0])
    out["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    return out


def check_decode_int8(g, randn, ints) -> dict:
    """K2-int8 against its plain version (the scales factored into logits and
    softmax weights, fp32): the chat decode (S = 1, lens 4950), three streams
    with differing lens, and a 48-stream batched decode at lens ~800 with band
    (lens, lens). The scales set the outputs' size, so the absolute part of
    the attention tolerance is taken from each output row: |err| <= 2^-7
    (max|plain| of the row + |plain|), which a dropped or misplaced scale
    cannot meet."""
    print(f"K2-int8 (|err| <= {RTOL} (max|ref| of the output row + |ref|) per element, mean "
          f"abs <= {MEAN_ABS_TOL}):", flush=True)
    cases = [
        ("S=1 M=5632 lens=4950 band [4950, 4960]", 5632, (4950,), (4950,), (4960,)),
        ("S=3 lens (100, 2000, 4950) band [4950, 4955]", 5632, (100, 2000, 4950),
         (4950,) * 3, (4955,) * 3),
        ("S=48 lens ~800 band (lens, lens)", 1024, tuple(776 + (i % 7) * 8 for i in range(48)),
         None, None),
    ]
    rows = []
    for name, M, lens, base, col in cases:
        S = len(lens)
        q = randn(S, 1, 28, 128, scale=2.0)
        k, v = _rand_int8(g, S, 4, M, 128), _rand_int8(g, S, 4, M, 128)
        ks = torch.rand(S, 4, M, generator=g, device="cuda") * 0.02 + 0.002
        vs = torch.rand(S, 4, M, generator=g, device="cuda") * 0.02 + 0.002
        ln = ints(*lens)
        band = (ln, ln) if base is None else (ints(*base), ints(*col))
        kernel = lambda: dec.decode_attention(q, k, v, ln, band, k_scale=ks, v_scale=vs)  # noqa: E731
        r = _with_splits(f"K2-int8 decode {name}", S, M, _compare(
            f"K2-int8 decode {name}", kernel,
            lambda: dec.decode_attention_ref(q, k, v, ln, band, ks, vs), 1, row_atol=True),
            kernel)
        keys = [a + max(0, c - max(a, b) + 1)  # the context, and the band past it
                for a, b, c in zip(lens, band[0].tolist(), band[1].tolist())]
        r.update(attention_bound([1] * S, keys, 28, 4, 128, 1, "bf16", scales=True))
        r["library_ms"] = None  # no PyTorch attention call reads an int8 cache with scales
        print(f"    bound {r['bound_ms']:.4f} ms by {r['bound_by']}", flush=True)
        rows.append(r)
    out = dict(rows[0])
    out["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    out["cases"] = [r["case"] for r in rows]
    return out


def check_silu_mul_quant(randn) -> dict:
    """K3 against its plain version at the MLP's width: a decode step (R = 1),
    three streams, the 378 px image block and the 980 px image block, each
    on the launch shape the wrapper picks and on the other one (rows over a
    cluster up to CLUSTER_MAX_ROWS rows, persistent CTAs past that); the
    decode step also in a CUDA graph (the card's time alone)."""
    print(f"K3 silu_mul_quant, I = 18944 (scales within {K3_SCALE_RTOL} relative, q within "
          f"{K3_MAX_STEP} step, at most {K3_MAX_SHARE} of q differing):", flush=True)
    I, rows = 18944, []
    for R in (1, 3, 731, 4902):
        gu = randn(R, 2 * I, scale=2.0)  # the halves of a fused gate_up output
        gate, up = gu.split(I, dim=-1)
        q_ref, sc_ref = aq.silu_mul_quant_ref(gate, up)
        default = R <= aq.CLUSTER_MAX_ROWS  # the wrapper spreads the row over a cluster
        for on_cluster in (default, not default):
            limit = aq.CLUSTER_MAX_ROWS
            aq.CLUSTER_MAX_ROWS = R if on_cluster else 0  # the launch shape to check
            try:
                q, sc = aq.silu_mul_quant(gate, up)
            finally:
                aq.CLUSTER_MAX_ROWS = limit
            torch.cuda.synchronize()
            step = (q.int() - q_ref.int()).abs()
            share = (step > 0).float().mean().item()
            rel = ((sc - sc_ref).abs() / sc_ref).max().item()
            how = f"cluster of {aq.CLUSTER_SIZE}" if on_cluster else "many-row"
            if on_cluster != default:
                print(f"  K3 R={R} on the other launch shape ({how}): max step "
                      f"{step.max().item()}, share differing {share:.2e}, scale rel err "
                      f"{rel:.2e}", flush=True)
            if rel > K3_SCALE_RTOL or step.max().item() > K3_MAX_STEP or share > K3_MAX_SHARE:
                raise SystemExit(f"chip_smoke: K3 R={R} ({how}) disagrees with its plain version")
            if on_cluster != default:
                continue
            ms = cuda_ms(lambda: aq.silu_mul_quant(gate, up))
            plain_ms = cuda_ms(lambda: aq.silu_mul_quant_ref(gate, up), warmup=1, iters=3)
            b2b = back_to_back_ms(lambda: aq.silu_mul_quant(gate, up)) if R in (1, 4902) else None
            in_graph = graph_ms(lambda: aq.silu_mul_quant(gate, up)) if R == 1 else None
            b = bound(R * I * 5 + R * 4, R * I * 15, "fp32")
            _line(f"K3 R={R} ({how})", f"max step {step.max().item()}, share differing "
                  f"{share:.2e}, scale rel err {rel:.2e}", ms, plain_ms, b,
                  _b2b_text(b2b) + ("" if in_graph is None else
                                    f"; {in_graph:.4f} ms per call in a CUDA graph of "
                                    f"{BACK_TO_BACK}"))
            rows.append(dict(max_abs_err=float(step.max().item()), ms=ms, plain_ms=plain_ms,
                             ms_back_to_back=b2b, ms_in_graph=in_graph, library_ms=None,
                             **b))  # no one PyTorch call
    out = dict(rows[-1])  # the 980 px image block; the decode step beside it
    out["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    out["one_row_ms"], out["one_row_ms_back_to_back"] = rows[0]["ms"], rows[0]["ms_back_to_back"]
    out["one_row_ms_in_graph"] = rows[0]["ms_in_graph"]
    del out["ms_in_graph"]
    return out


W4_G32 = 32  # the finest group on K4's tensor-core routes
W4_SIMPLE_GROUP = 16  # a group no tensor-core product holds: the simple kernel's


def k4_bound(m: int, K: int, N: int, G: int, int8_x: bool) -> dict:
    """K4's least time: x, x_scale, the packed weights, w_scale read once and
    y written once; the products (2 m K N) at the int8 or bf16 peak; with
    group scales every group's sum scaled and added (2 m N G fp32
    operations), at the fp32 peak: whichever of the three is largest."""
    n_bytes = m * K * (1 if int8_x else 2) + (4 * m if int8_x else 0) + N * K // 2 \
        + 4 * N * max(G, 1) + 2 * m * N
    t_bytes = n_bytes / HBM_BYTES_S
    t_ops = max(2.0 * m * K * N / PEAK_OPS_S["int8" if int8_x else "bf16"],
                2.0 * m * N * G / PEAK_OPS_S["fp32"])
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def _k4_route_call(x, xs, wp, ws):
    """One K4 call on the card, and the route whose counter it moved
    (exactly one launch, on the route ``k4_route`` names for the shape)."""
    before = dict(w4.route_counts)
    got = w4.w4_matmul(x, xs, wp, ws)
    moved = [r for r in w4.route_counts if w4.route_counts[r] != before[r]]
    N, K = wp.shape[0], 2 * wp.shape[1]
    G = ws.shape[0] if ws.dim() == 2 else 0
    want = w4.k4_route(x.numel() // K, K, N, G, xs is not None)
    if moved != [want] or w4.route_counts[want] != before[want] + 1:
        raise SystemExit(f"chip_smoke: K4 at m={x.numel() // K} K={K} N={N} G={G} launched "
                         f"{moved}, not one {want}")
    return got, want


def _k4_want(x, xs, wp, ws):
    """What a K4 call must equal (int8 x) or approach (bf16 x): the plain
    version, or with int8 x on the GEMV at groups of 32 its twin, whose fold
    adds the plain version's fp32 terms in another association (held to it
    on the CPU by tests/test_torch_w4_gemv.py)."""
    K = 2 * wp.shape[1]
    m = x.numel() // K
    G = ws.shape[0] if ws.dim() == 2 else 0
    if xs is not None and G and K // G == W4_G32 and w4.k4_route(m, K, wp.shape[0], G, True) \
            == "gemv":
        return w4.w4_gemv_tiled_ref(x.cpu(), xs.cpu(), wp.cpu(), ws.cpu(),
                                    n_sms=w4._n_sms(x.device)).cuda()
    return w4.w4_matmul_ref(x, xs, wp, ws)


def _k4_case(name, x, xs, wp, ws, timed=True, b2b=False, plain_iters=3) -> dict:
    """K4 on one input against what it must equal (int8 x: bit for bit) or
    approach (bf16 x: |err| <= 2^-7 |plain| + 1e-3 sqrt(K) 8 max|x|
    max(w_scale) / 16), its route, and, where ``timed``, its time, the plain
    version's and the bound."""
    K, N = 2 * wp.shape[1], wp.shape[0]
    m = x.numel() // K
    G = ws.shape[0] if ws.dim() == 2 else 0
    got, route = _k4_route_call(x, xs, wp, ws)
    torch.cuda.synchronize()
    want = _k4_want(x, xs, wp, ws)
    err = (got.float() - want.float()).abs()
    if xs is not None:
        ok, text = torch.equal(got, want), f"equal {torch.equal(got, want)}"
    else:
        tol = 2.0**-7 * want.float().abs() + 1e-3 * K**0.5 * 8 * x.float().abs().max() \
            * ws.max() / 16
        worst = (err / tol).max().item()
        ok, text = worst <= 1.0, f"worst err/bound {worst:.3f}"
    text = f"{route}: {text} (max abs err {err.max().item():.3e})"
    r = dict(case=name, route=route, max_abs_err=err.max().item(), library_ms=None,
             **k4_bound(m, K, N, G, xs is not None))
    if timed:
        r["ms"] = cuda_ms(lambda: w4.w4_matmul(x, xs, wp, ws))
        r["plain_ms"] = cuda_ms(lambda: w4.w4_matmul_ref(x, xs, wp, ws), warmup=1,
                                iters=plain_iters)
        r["ms_back_to_back"] = back_to_back_ms(lambda: w4.w4_matmul(x, xs, wp, ws)) if b2b \
            else None
        _line(name, text, r["ms"], r["plain_ms"], r, _b2b_text(r["ms_back_to_back"]))
    else:
        print(f"  {name}: {text}", flush=True)
    if not ok:
        raise SystemExit(f"chip_smoke: {name} disagrees with its plain version")
    return r


def check_w4_matmul(g, randn) -> dict:
    """K4 against its plain version at the LLM's four projection shapes (qkv
    and gate_up fused, o, down), per channel and with groups of 512 and of
    32: the int8 branch (w4a8) must be EQUAL (exact integer sums, the same
    rounded fp32 scaling), on the GEMV (m 1 to 4; at groups of 32 equal to its
    twin, the fold's order) and the GEMM (m 731, 4902); the bf16 branch
    (weight-only w4; GEMV at m 1 to 4, GEMM at a text prefill's 17 rows and
    at m 731, 4902) sums fp32 in another order: |err| <= 2^-7 |plain| + 1e-3
    sqrt(K) 8 max|x| max(w_scale) / 16. Each call must launch the route
    ``k4_route`` names. Groups of 32 at m 1, 4, 731, 4902 (int8 x) and 1, 4,
    17, 4902 (bf16 x). Then the simple kernel: groups of 16 at qkv, m 4, and
    K 96, N 12. The GEMV captured in a CUDA graph must replay equal to an
    eager call on new x. The ``kernels`` line's row is the decode step's GEMV
    at gate_up, with the prefill's GEMMs at gate_up, m 4902, per channel
    under ``gemm`` (int8 x) and ``bf16_gemm`` (bf16 x, with the ``torch.mm``
    yardstick), the groups of 32 under ``group32_cases``, and the GEMV cold
    at each projection under ``gemv_cases`` (``gemv_cold_cases``); the
    simple kernel's row is returned beside it."""
    print("K4 w4_matmul (w4a8: equality; bf16 x: |err| <= 2^-7 |ref| + reordering bound):",
          flush=True)
    shapes = [(3584, 4608), (3584, 3584), (3584, 37888), (18944, 3584)]
    rows, group32, shown, gemm, bf16_gemm = [], [], None, None, None
    for K, N in shapes:
        wp = w4.pack_int4(_rand_int8(g, N, K, lo=-8, hi=8))
        for G, int8_ms, bf16_ms in ((0, (1, 2, 3, 4, 731, 4902), (1, 2, 3, 4, 17, 731, 4902)),
                                    (K // W4_GROUP, (1, 2, 3, 4, 731, 4902),
                                     (1, 2, 3, 4, 17, 731, 4902)),
                                    (K // W4_G32, (1, 4, 731, 4902), (1, 4, 17, 4902))):
            ws = torch.rand((G, N) if G else (N,), generator=g, device="cuda") * 0.01 + 0.001
            kind = f"group {K // G}" if G else "per channel"
            for m in int8_ms:
                x = _rand_int8(g, m, K)
                xs = torch.rand(m, 1, generator=g, device="cuda") * 0.05 + 0.001
                r = _k4_case(f"K4 w4a8 m={m} K={K} N={N} {kind}", x, xs, wp, ws, b2b=m == 1)
                (group32 if G and K // G == W4_G32 else rows).append(r)
                if (m, K, N, G) == (1, 3584, 37888, 0):
                    shown = r
                if (m, K, N, G) == (4902, 3584, 37888, 0):  # the GEMM path at gate_up
                    gemm = {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
            for m in bf16_ms:
                x = randn(m, K)
                # the prefills and the groups of 32: timed
                r = _k4_case(f"K4 w4 bf16-x m={m} K={K} N={N} {kind}", x, None, wp, ws,
                             timed=m >= 731 or (G and K // G == W4_G32))
                (group32 if G and K // G == W4_G32 else rows).append(r)
                if (m, K, N, G) == (4902, 3584, 37888, 0):  # the weight-only prefill's GEMM
                    # yardstick: x by the weight unpacked, scaled and cast to bf16 (another
                    # function: no PyTorch call multiplies by packed int4)
                    wb = (w4.unpack_int4(wp).float() * ws[:, None]).to(torch.bfloat16)
                    mm_ms = cuda_ms(lambda: torch.mm(x, wb.t()))
                    del wb
                    print(f"    yardstick torch.mm on the unpacked bf16 weight: {mm_ms:.4f} ms",
                          flush=True)
                    bf16_gemm = {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
                    bf16_gemm["yardstick_mm_ms"] = mm_ms
    check_gemv_graph_replay(g, randn)
    out = dict(shown, gemm=dict(gemm, case="w4a8 m=4902 K=3584 N=37888 per channel"),
               bf16_gemm=dict(bf16_gemm, case="bf16 x m=4902 K=3584 N=37888 per channel"),
               group32_cases=group32, gemv_cases=gemv_cold_cases(g, randn))
    out["max_abs_err"] = max(r["max_abs_err"] for r in rows + group32)
    for key in ("case", "route"):
        out.pop(key)
    return out, check_w4_simple(g, randn)


def check_w4_simple(g, randn) -> dict:
    """K4's simple kernel (the shapes no tensor-core product holds) against
    the plain version: groups of 16 at qkv (K 3584, N 4608), m 4, and K 96,
    N 12 per channel and with groups of 32 and 16, each with int8 x (equal)
    and bf16 x (the reordering bound). Returns the ``kernels`` line's row:
    the group-16 int8 case's numbers, every case under ``cases``."""
    print("K4 simple kernel (the shapes outside the tensor-core routes):", flush=True)
    cases = []
    for K, N, G, m in ((3584, 4608, 3584 // W4_SIMPLE_GROUP, 4), (96, 12, 0, 4), (96, 12, 3, 4),
                       (96, 12, 6, 17)):
        wp = w4.pack_int4(_rand_int8(g, N, K, lo=-8, hi=8))
        ws = torch.rand((G, N) if G else (N,), generator=g, device="cuda") * 0.01 + 0.001
        kind = f"group {K // G}" if G else "per channel"
        x = _rand_int8(g, m, K)
        xs = torch.rand(m, 1, generator=g, device="cuda") * 0.05 + 0.001
        cases.append(_k4_case(f"K4 simple w4a8 m={m} K={K} N={N} {kind}", x, xs, wp, ws,
                              b2b=True))
        cases.append(_k4_case(f"K4 simple bf16-x m={m} K={K} N={N} {kind}", randn(m, K), None,
                              wp, ws))
    row = {k: v for k, v in cases[0].items() if k not in ("case", "route")}
    row["max_abs_err"] = max(r["max_abs_err"] for r in cases)
    row["cases"] = cases
    return row


def check_gemv_graph_replay(g, randn) -> None:
    """K4's GEMV captured in a CUDA graph at down, m 4, groups of 512 (the
    most slices of the int32 combine, so the most arrivals per tile) and of 32
    (the fold), with int8 and bf16 x: three replays, each on new x copied
    in, equal to an eager call on that x (the arrival counters are back at
    zero after every launch)."""
    K, N, m = 18944, 3584, 4
    wp = w4.pack_int4(_rand_int8(g, N, K, lo=-8, hi=8))
    for G in (K // W4_GROUP, K // W4_G32):
        ws = torch.rand(G, N, generator=g, device="cuda") * 0.01 + 0.001
        for int8x in (True, False):
            def new_x():
                if int8x:
                    return _rand_int8(g, m, K), torch.rand(m, 1, generator=g,
                                                           device="cuda") * 0.05
                return randn(m, K), None
            x, xs = new_x()
            w4.w4_matmul(x, xs, wp, ws)
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                y = w4.w4_matmul(x, xs, wp, ws)
            for _ in range(3):
                nx, nxs = new_x()
                x.copy_(nx)
                if int8x:
                    xs.copy_(nxs)
                graph.replay()
                torch.cuda.synchronize()
                if not torch.equal(y, w4.w4_matmul(nx, nxs, wp, ws)):
                    raise SystemExit("chip_smoke: K4's GEMV replayed in a CUDA graph differs "
                                     "from an eager call")
        print(f"  K4 GEMV in a CUDA graph (K={K} N={N} group {K // G} m={m}, int8 and bf16 x): "
              "three replays on new x equal to eager calls", flush=True)


def gemv_cold_cases(g, randn) -> list:
    """K4's GEMV at m 1 at each projection, per channel, int8 and bf16 x, as
    a decode step meets it: per call in a CUDA graph of 20 that rotate over
    copies of the weight exceeding twice the L2 (``tqk.cold_copies``), with
    the bound and the yardstick on the same kind of rotation (``torch._int_mm``
    on the unpacked int8 weight, rows padded to 17; ``torch.mm`` on the
    weight unpacked, scaled and cast to bf16): other functions, timed only."""
    cases = []
    for name, (K, N) in tqk.PROJECTIONS.items():
        wq = _rand_int8(g, N, K, lo=-8, hi=8)
        ws = torch.rand(N, generator=g, device="cuda") * 0.01 + 0.001
        wp = w4.pack_int4(wq)
        copies = [(wp, ws)] + [(wp.clone(), ws.clone())
                               for _ in range(tqk.cold_copies(wp.numel()) - 1)]
        wqs = [wq] + [wq.clone() for _ in range(tqk.cold_copies(wq.numel()) - 1)]
        wb = (wq.float() * ws[:, None]).to(torch.bfloat16)
        wbs = [wb] + [wb.clone() for _ in range(tqk.cold_copies(2 * wb.numel()) - 1)]
        xi, xs = _rand_int8(g, 1, K), torch.rand(1, 1, generator=g, device="cuda") * 0.05 + 0.001
        xb = randn(1, K)
        for xname, x, x_scale, yard in (
                ("int8 x", xi, xs, [(lambda w=w: quant.int_mm(xi, w)) for w in wqs]),
                ("bf16 x", xb, None, [(lambda w=w: torch.mm(xb, w.t())) for w in wbs])):
            ms = statistics.median(tqk.rotating_graph_readings(
                [(lambda c=c: w4.w4_matmul(x, x_scale, *c)) for c in copies]))
            yard_ms = statistics.median(tqk.rotating_graph_readings(yard))
            b = tqk.k4_bound_ms(1, K, N, 0, bf16_x=xname == "bf16 x")
            print(f"  K4 GEMV cold, {name} (K={K} N={N}) m=1 {xname} per channel: {ms:.5f} ms "
                  f"per call in a CUDA graph of {tqk.RUN} over {len(copies)} weight copies; "
                  f"bound {b:.5f} ms by bytes; yardstick {yard_ms:.5f} ms", flush=True)
            cases.append(dict(case=f"{name} K={K} N={N} m=1 {xname} per channel", ms_cold=ms,
                              bound_ms=b, yardstick_ms=yard_ms, weight_copies=len(copies)))
        del copies, wqs, wbs, wb
    return cases


def time_int8_matmul_candidates(g) -> None:
    """The s8 x s8 product of the full-int8 mode is a library call, as the JAX
    package left it to XLA's dot: ``torch._int_mm`` (rows padded to 17 for a
    decode step) against widening both operands to bf16 for ``torch.mm``,
    at the gate_up shape. Also the weight-only int8 linear (its widened copy is
    a real write and read per call) beside a bf16 linear of the same shape."""
    K, N = 3584, 37888
    w = _rand_int8(g, N, K)
    wb = w.to(torch.bfloat16)
    print(f"int8 matmul candidates at K={K} N={N} (not kernels of the port; timed to choose):",
          flush=True)
    for m in (1, 731, 4902):
        xq = _rand_int8(g, m, K)
        xb = xq.to(torch.bfloat16)
        t_int = cuda_ms(lambda: quant.int_mm(xq, w))
        t_wide = cuda_ms(lambda: torch.mm(xq.to(torch.bfloat16), w.to(torch.bfloat16).t(),
                                          out_dtype=torch.float32), warmup=1, iters=5)
        t_q = cuda_ms(lambda: quant.mm_f32(xb, w.to(torch.bfloat16)), warmup=1, iters=5)
        t_bf = cuda_ms(lambda: torch.mm(xb, wb.t()), warmup=1, iters=5)
        print(f"  m={m}: torch._int_mm {t_int:.4f} ms; int8 widened to bf16 then torch.mm "
              f"{t_wide:.4f} ms | weight-only int8 linear (widen + mm) {t_q:.4f} ms; bf16 "
              f"torch.mm of that shape {t_bf:.4f} ms", flush=True)


def _row_ulp(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """bf16 spacing (8 significant bits) at the largest |value| of each
    output row [..., D], in fp32, broadcast over the row."""
    scale = torch.maximum(got.abs(), want.abs()).amax(dim=-1, keepdim=True)
    return torch.exp2(torch.floor(torch.log2(scale.float().clamp_min(2.0**-126))) - 7)


def check_q_preproc(randn, ints, results) -> dict:
    """K1b at the generation path's shapes (H 28 / Hk 4, D 128, non-causal,
    one rope row per block), then its prologue alone: K1b on raw q against
    K1a on the plainly pre-processed q. The two q may differ in the rounding
    of a few elements (sums of squares taken in another order), which moves
    a whole output row by an amount set by the row's scale, so the bound is
    one bf16 ulp of the output row's largest |value|, per element."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)

    def q_preproc(S, end_row):
        cos, sin = rope_cos_sin(torch.full((S, 1), 41, device="cuda"), 128, 1e6)
        w = [(1 + 0.1 * torch.randn(128, generator=g, device="cuda")).to(torch.bfloat16)
             for _ in range(2)]
        return dict(w_und=w[0], w_gen=w[1], cos=cos, sin=sin, end_row=end_row, eps=1e-6)

    cases = [
        # (name, S, T, cap or None (block at lens), lens, q_valid_len, end_row)
        ("512 px denoise, 3 streams, lens (37, 0, 37)", 3, 1026, 512, (37, 0, 37), None, None),
        ("512 px denoise, 1 stream", 1, 1026, 512, (37,), None, None),
        ("512 px edit denoise, lens (2440, 2403, 37)", 3, 1026, 3072, (2440, 2403, 37), None,
         None),
        ("1024 px denoise, 3 streams", 3, 4098, 512, (37, 0, 37), None, None),
        ("512 px VAE prefill, 1024 latents", 1, 1026, None, (0,), None, None),
        ("VAE prefill bucket 1024, 990 latents", 1, 1026, None, (0,), 992, 991),
    ]
    first = None
    for name, S, T, cap, lens, qvl, end_row in cases:
        M = (cap if cap is not None else max(lens)) + T
        q = randn(S, T, 28, 128, scale=2.0)
        kc, vc = randn(S, 4, M, 128), randn(S, 4, M, 128)
        ln = ints(*lens)
        bs = ints(*([cap] * S)) if cap is not None else ln
        qv = None if qvl is None else ints(qvl)
        qp = q_preproc(S, end_row)
        r = _compare(
            f"K1b {name}: S={S} T={T} M={M}",
            lambda: fa.flash_block_attention(q, kc, vc, ln, bs, False, qv, True, q_preproc=qp),
            lambda: fa.flash_block_attention_ref(q, kc, vc, ln, bs, False, qv, True,
                                                 q_preproc=qp),
            T if qvl is None else qvl, back_to_back=first is None)
        results.append(r)
        if first is None:
            first = r, (q, kc, vc, ln, bs, qp)
    q, kc, vc, ln, bs, qp = first[1]
    got = fa.flash_block_attention(q, kc, vc, ln, bs, False, None, True, q_preproc=qp).float()
    want = fa.flash_block_attention(fa.preprocess_q(q, qp), kc, vc, ln, bs, False, None,
                                    True).float()
    diff = (got - want).abs()
    over = diff / _row_ulp(got, want)
    print(f"  K1b prologue vs K1a on plainly pre-processed q ({cases[0][0]}): max abs "
          f"{diff.max().item():.3e}, max {over.max().item():.3f} bf16 ulp of the row's scale, "
          f"{(diff > 0).float().mean().item():.2e} of elements differ", flush=True)
    if over.max().item() > 1.0:
        raise SystemExit("chip_smoke: K1b's prologue differs from the plain pre-processing "
                         "by more than one bf16 ulp of an output row's scale")
    return first[0]


def full_config() -> BagelConfig:
    """The released 14B geometry (scripts/make_synthetic_ckpt.py): LLM 28 layers,
    hidden 3584, 28/4 heads, MLP 18944, vocab 152064; SigLIP 26 layers, 1152."""
    return BagelConfig(llm=LLMConfig(), vit=ViTConfig(), vae=VAEConfig())


def build_inferencer() -> InterleaveInferencer:
    from unimedvl_tpu_torch.data.imaging import ImageTransform

    t0 = time.perf_counter()
    cfg = full_config()
    model = bagel.Bagel(cfg, device="meta", dtype=torch.bfloat16, with_vae=True)
    model = model.to_empty(device="cuda")
    # a random velocity head, or every flow step would return its input
    bagel.init_random_(model, torch.Generator(device="cuda").manual_seed(SEED),
                       llm2vae_zero=False)
    torch.cuda.synchronize()
    n_vae = sum(p.numel() for p in model.vae_model.parameters())
    n_params = sum(p.numel() for p in model.parameters()) - n_vae
    print(f"model: {n_params / 1e9:.2f} B params bf16 + VAE {n_vae / 1e6:.1f} M params fp32 "
          f"on the card, {torch.cuda.memory_allocated() / 2**30:.1f} GiB, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    tok, new_token_ids, _ = add_special_tokens(ByteTokenizer())
    vqa = TransformConfig.vit_vqa()
    transform = ImageTransform(vqa.max_size, vqa.min_size, vqa.stride, vqa.max_pixels)
    return InterleaveInferencer(model, tok, new_token_ids, vit_transform=transform, seed=SEED)


def _images():
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w, _ in REQUESTS]


def _chat_pass(inf: InterleaveInferencer, requests, images, graphed: bool):
    """One pass of chat requests by one route: the captured decode program
    (``graphed``) or the eager loop (``inf.graphs = False``, with the top-2 of
    every step recorded as :func:`_greedy_steps` records them, and kept for
    the later phases' gates in ``_CHAT_STEPS``). Returns (each request's row
    of times, each request's answer ids, the eager pass's top-2 per step).
    Stamps, synchronised: an eager forward at its embedding (its start), a
    replay of a prefill or decode program at its end; the first replay of a
    graph holds its capture, so ms per decode step leaves the first step
    out. ``ttft_s`` is PERF.md's "TTFT after image": from the end of the
    image prefill to the end of the first decode step (the first answer
    token chosen); ``ttft_from_start_s`` from the request's start."""
    stamps = []

    def stamp(module, args, output):
        if programs.capturing():
            return
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    def replayed(graph):
        if graph.kind in ("decode", "prefill"):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

    answers, tops, rows = [], [], []
    generate = bagel.generate_text

    def recording(*args, **kw):
        out = generate(*args, **kw)
        answers.append([i for i in out[0][0].tolist() if i >= 0])
        return out

    hook = inf.model.language_model.model.embed_tokens.register_forward_hook(stamp)
    programs.listeners.append(replayed)
    bagel.generate_text = recording
    captures = programs.stats["captures"]
    try:
        for i in requests:
            (h, w, prompt), image = REQUESTS[i], images[i]
            stamps.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if graphed:
                inf.chat([image], prompt, max_length=MAX_LENGTH)
            else:
                ids, steps = _greedy_steps(inf, lambda: inf.chat([image], prompt,
                                                                 max_length=MAX_LENGTH),
                                           MAX_LENGTH)
                digest = hashlib.sha1(image.tobytes()).hexdigest()
                key = (inf.__dict__.setdefault("_smoke_key", next(_INF_KEYS)), digest, prompt,
                       MAX_LENGTH)
                _CHAT_STEPS[key] = ids, steps
                tops.append((ids, steps))
            torch.cuda.synchronize()
            t_end = time.perf_counter()
            n_img = (h // 14) * (w // 14)
            if graphed:  # stamps: each replay's end (image prefill, text prefill, decode steps)
                steps, image_end, first_end = len(stamps) - 2, stamps[0], stamps[2]
                ms_step = 1e3 * (stamps[-1] - stamps[2]) / max(1, steps - 1)
            else:  # stamps: image prefill, text prefill, then each decode step's start
                steps, image_end, first_end = len(stamps) - 2, stamps[1], stamps[3]
                ms_step = 1e3 * (t_end - stamps[3]) / max(1, steps - 1)
            rows.append(dict(
                route="graphed" if graphed else "eager", image=f"{h}x{w}", image_tokens=n_img,
                s_per_image=image_end - t0, ttft_s=first_end - image_end,
                ttft_from_start_s=first_end - t0, decode_steps=steps,
                ms_per_decode_step=ms_step,
                decode_tok_s=(steps - 1) / (t_end - first_end) if steps > 1 else None,
                captures=programs.stats["captures"] - captures))
            captures = programs.stats["captures"]
            print(f"  request {rows[-1]['image']} ({rows[-1]['route']}): {json.dumps(rows[-1])}",
                  flush=True)
    finally:
        bagel.generate_text = generate
        programs.listeners.remove(replayed)
        hook.remove()
    return rows, answers, tops


def run_chat_requests(inf: InterleaveInferencer, requests, path: str, expected,
                      rows_out=None, graphed: bool = True, eager_requests=None,
                      trace: bool = True, warm: bool = False, all_rows=None) -> dict:
    """Chat requests (indices into REQUESTS) by the default route, the
    captured decode program, and then by the eager loop (``graphs=False``),
    the counters reset just before each pass; ``expected(forwards,
    decode_steps, image_blocks)`` gives the launch counts each pass must show
    (the program's replays count their captured launches, and it runs the
    steps the eager loop runs, so both passes show the same). The graphed
    answers must be the eager ones token for token (:func:`check_answers`
    with no near-tie allowance). Then a profiler trace of the graphed decode
    step (:func:`trace_decode_step`). Returns the graphed pass's launches
    (the path's); each request's graphed row goes to ``rows_out`` where
    given. Without ``graphed`` (a model on a mesh, which runs eagerly) only
    the eager pass runs, and its launches and rows are returned.
    ``eager_requests`` (default: all): the eager pass's requests, to bound
    the smoke's time; with fewer, each pass's launches are held to
    ``expected`` of its own forwards. ``trace``: trace the graphed step.
    ``warm``: each request once by the graphed route first, untimed, so
    that the graphed pass replays programs captured before it."""
    images = _images()
    # warm-up (cuBLAS handles, first launches; with ``warm`` every program's capture),
    # not counted or timed
    for i in (requests if warm else [2]):
        inf.chat([images[i]], REQUESTS[i][2], max_length=MAX_LENGTH if warm else 2)
    eager_requests = list(requests if eager_requests is None else eager_requests)
    launches, rows = {}, {}
    for graphed in (True, False) if graphed else (False,):
        inf.graphs = None if graphed else False
        reqs = list(requests) if graphed else eager_requests
        reset_counts()
        counter = ForwardCounter(inf.model)
        try:
            rows[graphed], answers, tops = _chat_pass(inf, reqs, images, graphed)
        finally:
            counter.remove()
            inf.graphs = None
        steps = sum(r["decode_steps"] for r in rows[graphed])
        route = "graphed" if graphed else "eager"
        launches[graphed] = check_counts(f"{path} ({route})", expected(
            counter.prefill + counter.decode, steps, len(reqs)))
        if graphed:
            got = {i: ids for i, ids in zip(reqs, answers)}
    if True not in launches:
        if rows_out is not None:
            rows_out.extend(rows[False])
        return launches[False]
    if eager_requests == list(requests) and launches[True] != launches[False]:
        raise SystemExit(f"chip_smoke: {path}: the graphed launches differ from the eager ones")
    refs = dict(zip(eager_requests, tops))
    check_answers(f"{path}, graphed vs eager", inf,
                  [(i, images[i], REQUESTS[i][2]) for i in eager_requests], got, MAX_LENGTH,
                  0.0, reference=lambda image, prompt, budget: refs[
                      next(i for i in eager_requests if REQUESTS[i][2] == prompt
                           and images[i] is image)])
    ms = {route: statistics.median(r["ms_per_decode_step"] for r in rows[g])
          for route, g in (("graphed", True), ("eager", False))}
    print(f"  {path}: ms per decode step (median over the requests) graphed {ms['graphed']:.3f}, "
          f"eager {ms['eager']:.3f} ({CARD})", flush=True)
    if trace:
        trace_decode_step(inf, requests[0], path)
    if rows_out is not None:
        rows_out.extend(rows[True])
    if all_rows is not None:
        all_rows.extend(rows[True] + rows[False])
    return launches[True]


CONTEXT_REPS = 1  # timed builds of each context by each route (graphed: after its capture)


def _chat_context(inf: InterleaveInferencer, i: int) -> list:
    """chat's context of REQUESTS[i]: the ViT image, then the prompt."""
    ctx = inf.update_context_image(_images()[i], inf.init_gen_context(), vae=False)
    return [inf.update_context_text(REQUESTS[i][2], ctx)]


def _same_contexts(case: str, got: list, want: list) -> None:
    """Graphed contexts against eager ones: kv_len, rope, lens, and each
    stream's values (and scales) on [0, lens), bit for bit."""
    for g, w in zip(got, want):
        a, b = g.cache, w.cache
        same = (g.kv_len, g.rope) == (w.kv_len, w.rope) and torch.equal(a.lens, b.lens)
        for s, n in enumerate(b.lens.tolist()):
            for x, y in zip(serving._arrays(a), serving._arrays(b)):
                if same and not torch.equal(x[:, s, :, :n], y[:, s, :, :n]):
                    diff = (x[:, s, :, :n].float() - y[:, s, :, :n].float()).abs().max().item()
                    print(f"  {case}: graphed vs eager context, max abs {diff}", flush=True)
                    same = False
        if not same:
            raise SystemExit(f"chip_smoke: {case}: the graphed context build differs from the "
                             "eager one")


def check_context_builds(inf: InterleaveInferencer) -> list:
    """Every context build of the chat and generation paths by its prefill
    programs and eagerly (``graphs=False``): the three chat requests' (the
    ViT image, then the prompt), the text-to-image request's and the
    edit's (:func:`_gen_contexts`: text prefills, and the edit's VAE encode,
    VAE and ViT images). Each route builds each case CONTEXT_REPS times
    timed (the card waited for at both ends), the graphed route after an
    untimed build (its captures); the graphed contexts must equal the eager ones
    (:func:`_same_contexts`). Prints each case's seconds by route (median),
    the captures, their seconds, the shared pool's bytes after them and the
    live programs. Returns the rows."""
    cases = [(f"chat {h}x{w}", partial(_chat_context, inf, i))
             for i, (h, w, _p) in enumerate(REQUESTS)]
    cases += [("text-to-image 512x512", partial(_gen_contexts, inf)),
              ("edit 512x512", partial(_gen_contexts, inf, True))]
    rows = []
    for case, build in cases:
        row, built = dict(card=CARD, case=case), {}
        for route, graphs in (("graphed", None), ("eager", False)):
            inf.graphs = graphs
            captures, capture_s = programs.stats["captures"], programs.stats["capture_s"]
            try:
                if graphs is None:  # the programs' captures
                    built[route] = build()
                walls = []
                for _ in range(CONTEXT_REPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    built[route] = build()
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
            finally:
                inf.graphs = None
            row[f"{route}_s"] = statistics.median(walls)
            if graphs is None:
                row["captures"] = programs.stats["captures"] - captures
                row["capture_s"] = programs.stats["capture_s"] - capture_s
        _same_contexts(case, built["graphed"], built["eager"])
        row["equal"] = True
        print(f"  context build {case}: {json.dumps(row)}", flush=True)
        rows.append(row)
    keys = {}
    for name, mods in (("LLM", (inf.model.language_model,)),
                       ("LLM + ViT", bagel._vit_modules(inf.model))):
        t0 = time.perf_counter()
        for _ in range(10):
            programs.weights_key(*mods)
        keys[name] = 1e3 * (time.perf_counter() - t0) / 10
    print(f"  context builds: graphs captured so far {programs.stats['captures']} in "
          f"{programs.stats['capture_s']:.2f} s, the graph pool {programs.pool_bytes()} bytes "
          f"after them, {len(programs.programs())} programs kept; host ms of a lookup's "
          f"weights key {json.dumps(keys)} ({CARD})", flush=True)
    return rows


TRACE_STEPS = 8


def trace_decode_step(inf: InterleaveInferencer, request: int, path: str) -> dict:
    """Where a graphed decode step's time goes: TRACE_STEPS steps of one
    request's decode program (an end token that never comes) in a
    ``torch.profiler`` trace; busy time from the trace's kernel events (the
    union of their intervals), idle share against the wall of the same steps
    without the profiler (median of 3); on a mesh, NCCL's kernels apart and
    the collectives' breakdown (``collective_stats``). Prints and returns the
    row."""
    from unimedvl_tpu_torch.tools.profile_decode_step import KINDS, _summarise, collective_stats

    h, w, prompt = REQUESTS[request]
    ctx = inf.init_gen_context()
    ctx = inf.update_context_image(_images()[request], ctx, vae=False)
    ctx = inf.update_context_text(prompt, ctx)
    ctx = inf._ensure_capacity(ctx, TRACE_STEPS + 1)
    start = torch.tensor([inf.new_token_ids["bos_token_id"]], device="cuda")
    pos = torch.tensor([ctx.rope], device="cuda")

    def run():
        return bagel.generate_text(inf.model, ctx.cache, start, pos, TRACE_STEPS, eos_id=-1)

    run()  # the capture
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "decode.trace.json")
        prof.export_chrome_trace(trace)
        from pathlib import Path
        wall_ms = 1e3 * statistics.median(walls) / TRACE_STEPS
        row = dict(card=CARD, route="graphed", image=f"{h}x{w}", steps=TRACE_STEPS,
                   wall_ms=wall_ms, **_summarise(Path(trace), TRACE_STEPS, wall_ms,
                                                 KINDS + [("nccl", ("nccl",))]))
        if inf.mesh is not None:
            row["collectives"] = collective_stats(Path(trace), TRACE_STEPS)
    row.pop("k4_by_grid", None)
    print(f"  {path}: graphed decode step, traced: {json.dumps(row)}", flush=True)
    return row


def run_main_path(inf: InterleaveInferencer) -> dict:
    """The bf16 chat path: three requests through K1a and K2, each program
    captured before the graphed pass; prints the warm rows side by side."""
    n_vit, n_llm = inf.cfg.vit.num_hidden_layers, inf.cfg.llm.num_hidden_layers
    rows = []
    launches = run_chat_requests(
        inf, range(len(REQUESTS)), "the chat path", lambda f, steps, imgs: {
            "flash_block_attention": imgs * (n_vit + n_llm) + imgs * n_llm,
            "decode_attention": steps * n_llm}, CHAT_ROWS, warm=True, all_rows=rows)
    for route in ("graphed", "eager"):
        for r in (r for r in rows if r["route"] == route):
            print(f"  warm chat {r['image']} ({route}): s/image {r['s_per_image']:.4f}, TTFT "
                  f"after the image {r['ttft_s']:.4f} s (from the start "
                  f"{r['ttft_from_start_s']:.4f}), decode {r['decode_tok_s']:.1f} tok/s "
                  f"({CARD})", flush=True)
    return launches


@contextlib.contextmanager
def _recording(name: str, calls: list):
    """Within the block ``bagel.<name>`` (a decode function) appends (its
    output, the seconds it took, synchronised) to ``calls`` at every call."""
    decode = getattr(bagel, name)

    def recorded(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = decode(*args, **kw)
        torch.cuda.synchronize()
        calls.append((out, time.perf_counter() - t0))
        return out

    setattr(bagel, name, recorded)
    try:
        yield calls
    finally:
        setattr(bagel, name, decode)


def _decode_row(route: str, out, seconds: float, captures: int) -> dict:
    """A decode call's row: its tokens after the start token, steps (each
    emitted token was forwarded once) and ms per step."""
    steps = int(out[1][0])
    return dict(route=route, tokens=steps - 1, decode_steps=steps,
                ms_per_decode_step=1e3 * seconds / steps, decode_tok_s=(steps - 1) / seconds,
                captures=captures)


SAMPLE_TEMPERATURE = 0.7


def run_sampled_chat(inf: InterleaveInferencer) -> dict:
    """The 378x378 chat request sampled at SAMPLE_TEMPERATURE from one state
    of the inferencer's generator: by the captured decode program (twice:
    the first call captures, the second is timed) and by the eager loop. The
    tokens must be equal, and so must the generator's state after each (a
    replay draws from the registered generator as the eager step does); the
    generator is then put back as it was. Returns the graphed pass's
    launches."""
    n_vit, n_llm = inf.cfg.vit.num_hidden_layers, inf.cfg.llm.num_hidden_layers
    image, prompt = _images()[2], REQUESTS[2][2]
    print(f"sampled chat: the 378x378 request, do_sample=True, temperature "
          f"{SAMPLE_TEMPERATURE}; torch.cuda.CUDAGraph.register_generator_state: "
          f"{hasattr(torch.cuda.CUDAGraph, 'register_generator_state')}", flush=True)
    kept = inf._generator.get_state()
    rows, got, launches = [], {}, None
    try:
        for route, graphs in (("graphed", None), ("graphed", None), ("eager", False)):
            inf.graphs = graphs
            inf._generator.manual_seed(SEED + 21)
            calls = []
            counter = ForwardCounter(inf.model)
            reset_counts()
            captures = programs.stats["captures"]
            try:
                with _recording("generate_text", calls):
                    inf.chat([image], prompt, max_length=MAX_LENGTH, do_sample=True,
                             temperature=SAMPLE_TEMPERATURE)
            finally:
                counter.remove()
                inf.graphs = None
            (out, _lengths), dt = calls[-1]
            count = check_counts(f"the sampled chat ({route})", _expected(
                counter, n_vit, n_llm, False, 0, 0))
            launches = launches or count
            rows.append(_decode_row(route, (out, _lengths), dt,
                                    programs.stats["captures"] - captures))
            got.setdefault(route, []).append((_answer_ids(out), inf._generator.get_state()))
    finally:
        inf._generator.set_state(kept)
    (ids, state), (ids2, state2) = got["graphed"]
    e_ids, e_state = got["eager"][0]
    same = ids == ids2 == e_ids and torch.equal(state, e_state) and torch.equal(state2, e_state)
    print(f"  sampled chat ({CARD}): {json.dumps(rows)}; graphed tokens and generator state "
          f"equal to the eager loop's: {same}", flush=True)
    if not same:
        raise SystemExit("chip_smoke: the sampled decode program's tokens or generator state "
                         "differ from the eager loop's")
    return launches


def run_kept_decode(inf: InterleaveInferencer) -> dict:
    """Two ``chat_turn``s (the 378x378 request, then SPEC_TURN) and one
    ``gen_text_stream`` (chunks of 8) of the plain inferencer, by the
    captured programs (the kept-context decode; the stream's chunks over
    buffers of the cache's shape) and by the eager loops: the kept ids and
    the stream's pieces must be equal, and each route's launches must follow
    from its forwards; the pieces joined must be the first turn's answer (the same
    context, decoded through the same per-stream steps). Prints ms per
    decode step of each turn both ways. Returns the graphed pass's
    launches."""
    n_vit, n_llm = inf.cfg.vit.num_hidden_layers, inf.cfg.llm.num_hidden_layers
    image, p1, p2 = _images()[2], REQUESTS[2][2], SPEC_TURN
    rows, got, launches = [], {}, {}
    for route, graphs in (("graphed", None), ("eager", False)):
        inf.graphs = graphs
        calls = []
        counter = ForwardCounter(inf.model)
        reset_counts()
        captures = programs.stats["captures"]
        try:
            with _recording("generate_text_ctx", calls):
                a1, ctx1 = inf.chat_turn(None, p1, images=[image], max_length=MAX_LENGTH)
                _a2, ctx2 = inf.chat_turn(ctx1, p2, max_length=MAX_LENGTH)
            ctx = _context(inf, image, p1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pieces = list(inf.gen_text_stream(ctx, max_length=MAX_LENGTH, chunk=8))
            stream_s = time.perf_counter() - t0
        finally:
            counter.remove()
            inf.graphs = None
        launches[route] = check_counts(f"the kept-context turns and the stream ({route})",
                                       _expected(counter, n_vit, n_llm, False, 0, 0))
        for turn, (out, dt) in enumerate(calls, 1):
            rows.append(dict(_decode_row(route, out, dt, 0), turn=turn))
        rows.append(dict(route=route, stream_pieces=len(pieces), stream_s=stream_s,
                         captures=programs.stats["captures"] - captures))
        got[route] = (ctx2.hist, ctx2.kv_len, pieces, a1)
    same = got["graphed"] == got["eager"] and "".join(got["graphed"][2]) == got["graphed"][3]
    print(f"  kept-context turns and stream ({CARD}): {json.dumps(rows)}; graphed ids and "
          f"pieces equal to the eager ones, joined equal to the first turn's answer: {same}",
          flush=True)
    if not same:
        raise SystemExit("chip_smoke: the kept-context or stream programs differ from the "
                         "eager loops")
    return launches["graphed"]


def quantized_inferencer(inf: InterleaveInferencer, **kw) -> InterleaveInferencer:
    """An inferencer over a quantized copy of ``inf``'s LLM, its projections
    fused as a server fuses them, with an int8 KV cache. The copy shares every tensor that stays as it is (embedding,
    norms, biases; the ViT and the rest of the model) and quantizes each
    projection from the bf16 weight on the card, one at a time."""
    t0 = time.perf_counter()
    before = torch.cuda.memory_allocated()
    lm = inf.model.language_model
    shared = {id(t): t for t in itertools.chain(lm.parameters(), lm.buffers())}
    qlm = copy.deepcopy(lm, shared)  # new modules around the same tensors
    quant.quantize_llm_params(qlm, **kw)
    quant.fuse_serving_projections(qlm)
    model = copy.copy(inf.model)
    model._modules = dict(inf.model._modules, language_model=qlm)
    torch.cuda.synchronize()
    print(f"  quantized the LLM on the card ({kw}, fused): "
          f"{(torch.cuda.memory_allocated() - before) / 2**30:.2f} GiB more, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return InterleaveInferencer(model, inf.tokenizer, inf.new_token_ids,
                                vit_transform=inf.vit_transform, seed=SEED, kv_quantized=True)


def run_quantized_chat(inf: InterleaveInferencer, logits_bf16: torch.Tensor) -> dict:
    """The quantized serving modes at the full width, each on its own
    quantized copy of the LLM (freed before the next) with an int8 KV cache:
    (a) full-int8, fused projections: the three requests; (b) w4a8 per channel
    and (c) w4a8 with groups of 512 and of 32, fused: the 378x378 request; (d)
    weight-only w4 per channel, fused: the 980x980 request (a 4902-row
    prefill through K4's bf16-x GEMM) and the 378x378 one, with x never
    quantized, so K3 runs in no layer; (e) w4a8 with groups of 16, fused: a
    text request through K4's simple kernel (:func:`run_simple_chat`). After
    each, the first-step logits with the kernels against the same model on
    the plain versions (asserted) and against the bf16 model (printed: these
    are non-parity modes, and the weights are random). Returns the launches
    of the phases added up."""
    n_vit, n_llm = inf.cfg.vit.num_hidden_layers, inf.cfg.llm.num_hidden_layers
    fused_per_layer = 4  # qkv, o, gate_up, down of the und expert
    phases = [  # name, options, requests, K4 launches per layer, K3 launches per layer
        ("full-int8 + fused + int8 KV", dict(bits=8, act_quant=True), range(len(REQUESTS)), 0, 1),
        ("w4a8 per channel + fused + int8 KV", dict(bits=4, act_quant=True), [2],
         fused_per_layer, 1),
        (f"w4a8 group {W4_GROUP} + fused + int8 KV",
         dict(bits=4, act_quant=True, group_size=W4_GROUP), [2], fused_per_layer, 1),
        (f"w4a8 group {W4_G32} + fused + int8 KV",
         dict(bits=4, act_quant=True, group_size=W4_G32), [2], fused_per_layer, 1),
        ("weight-only w4 per channel + fused + int8 KV", dict(bits=4), [0, 2],
         fused_per_layer, 0),
    ]
    total = {name: 0 for name in COUNTERS}
    h, w, prompt = REQUESTS[1]
    image = _images()[1]
    s_per_image = {}
    for name, kw, requests, k4_per_layer, k3_per_layer in phases:
        print(f"quantized chat path, {name}: {len(requests)} request(s), greedy, max_length "
              f"{MAX_LENGTH}", flush=True)
        t_mode = time.perf_counter()
        qinf = quantized_inferencer(inf, **kw)
        rows = []
        # the eager comparison on one request a mode, and a trace of the graphed step in
        # full-int8 and w4a8 per channel (the smoke's time)
        launches = run_chat_requests(qinf, requests, f"the {name} path", lambda f, steps, imgs: {
            "flash_block_attention": imgs * (n_vit + n_llm) + imgs * n_llm,
            "decode_attention_int8": steps * n_llm,
            "silu_mul_quant": f * n_llm * k3_per_layer,
            "w4_matmul": f * n_llm * k4_per_layer,
        }, rows, eager_requests=list(requests)[-1:],
            trace=name.startswith(("full-int8", "w4a8 per channel")))
        s_per_image[name] = {row["image"]: row["s_per_image"] for row in rows}
        for k, v in launches.items():
            total[k] += v
        got = _first_step_logits(qinf, image, prompt)
        want = _with_plain_versions(lambda: _first_step_logits(qinf, image, prompt))
        cos = torch.nn.functional.cosine_similarity(got, want, dim=0).item()
        cos_bf16 = torch.nn.functional.cosine_similarity(got, logits_bf16, dim=0).item()
        finite = bool(torch.isfinite(got).all())
        print(f"  end to end ({h}x{w}): first-step logits kernels vs plain versions: cosine "
              f"{cos:.6f}, max abs {(got - want).abs().max().item():.4f} (logits std "
              f"{want.std().item():.3f}), argmax {got.argmax().item()} vs "
              f"{want.argmax().item()}, finite {finite}; against the bf16 model's logits "
              f"(not a parity mode): cosine {cos_bf16:.4f}", flush=True)
        if not finite or got.shape != (inf.cfg.llm.vocab_size,) or cos < LOGITS_COS_TOL:
            raise SystemExit(f"chip_smoke: {name}: the kernel path's logits disagree with "
                             "the plain versions'")
        del qinf
        torch.cuda.empty_cache()
        print(f"  the {name} mode in {time.perf_counter() - t_mode:.1f} s", flush=True)
    print(f"s/image by quantized mode (one request each): {json.dumps(s_per_image)}", flush=True)
    t_mode = time.perf_counter()
    for k, v in run_simple_chat(inf).items():
        total[k] += v
    print(f"  the simple kernel's chat in {time.perf_counter() - t_mode:.1f} s", flush=True)
    return total


SIMPLE_PROMPT = "Name the imaging modality used to examine the lungs."
SIMPLE_MAX_LENGTH = 8


def run_simple_chat(inf: InterleaveInferencer) -> dict:
    """K4's simple kernel on the chat path: the LLM quantized w4a8 with groups
    of W4_SIMPLE_GROUP in-rows (no tensor-core product holds one), fused,
    with an int8 KV cache, answering a text request through ``chat`` by the
    captured programs (one warm-up call first, uncounted). Every K4 launch
    must be the simple kernel's: forwards x 28 x 4 of each counter. The
    first-step logits against the same model on the plain versions at
    LOGITS_COS_TOL. Returns the launches."""
    n_llm = inf.cfg.llm.num_hidden_layers
    name = f"w4a8 group {W4_SIMPLE_GROUP} + fused + int8 KV, text only"
    print(f"quantized chat path, {name}: one request, greedy, max_length {SIMPLE_MAX_LENGTH}",
          flush=True)
    qinf = quantized_inferencer(inf, bits=4, act_quant=True, group_size=W4_SIMPLE_GROUP)
    qinf.chat([], SIMPLE_PROMPT, max_length=2)
    reset_counts()
    counter = ForwardCounter(qinf.model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        answer = qinf.chat([], SIMPLE_PROMPT, max_length=SIMPLE_MAX_LENGTH)
    finally:
        counter.remove()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    f = counter.prefill + counter.decode
    launches = check_counts(f"the {name} path", {
        "flash_block_attention": counter.prefill * n_llm,
        "decode_attention_int8": counter.decode * n_llm,
        "silu_mul_quant": f * n_llm, "w4_matmul": f * n_llm * 4,
        "w4_matmul_simple": f * n_llm * 4})
    print(f"  answered in {seconds:.3f} s: {counter.prefill} prefill(s), {counter.decode} decode "
          f"steps ({CARD}); {answer!r}", flush=True)
    got = _first_step_logits(qinf, None, SIMPLE_PROMPT)
    want = _with_plain_versions(lambda: _first_step_logits(qinf, None, SIMPLE_PROMPT),
                                quant_only=True)
    cos = torch.nn.functional.cosine_similarity(got, want, dim=0).item()
    finite = bool(torch.isfinite(got).all())
    print(f"  end to end (text): first-step logits kernels vs plain K3 and K4: cosine {cos:.6f}, "
          f"max abs {(got - want).abs().max().item():.4f}, argmax {got.argmax().item()} vs "
          f"{want.argmax().item()}, finite {finite}", flush=True)
    if not finite or got.shape != (inf.cfg.llm.vocab_size,) or cos < LOGITS_COS_TOL:
        raise SystemExit(f"chip_smoke: {name}: the kernel path's logits disagree with the plain "
                         "versions'")
    del qinf
    torch.cuda.empty_cache()
    return launches


# -- batched serving (ContinuousBatcher) ------------------------------------------------------
SERVE_SLOTS, SERVE_CAPACITY, SERVE_CHUNK, SERVE_MAX_NEW = 16, 6144, 16, 32
SERVE_PREAMBLE = "You are a radiology assistant. Answer in one short sentence. "
SERVE_TEXT = [
    "Summarise the findings of a normal chest radiograph.",
    "List three causes of a pleural effusion.",
    "What does a silhouette sign indicate?",
    "Define atelectasis in one line.",
    "Is cardiomegaly visible on a lateral view?",
    "Name the lobes of the right lung.",
    "What is a Kerley B line?",
    "Describe a pneumothorax on an upright film.",
]
# the pool's lens in run A's mix, for the kernel shapes: 980 px streams near 5150
# columns, 378x532 near 1070, 378 px near 750
SERVE_LENS = tuple([5141 + 3 * i for i in range(4)] + [1063 + 5 * i for i in range(4)]
                   + [746 + 4 * i for i in range(8)])


def _k1a_case(name, q, k, v, lens, bstart, causal, qvl=None) -> dict:
    """K1a at one admission shape against its plain version on each
    stream's valid query rows: rows < ``qvl[s]`` over a head-major cache, or,
    without ``qvl``, the ViT's rows < ``lens[s]`` over token-major k/v. Adds
    the bound from the visible (row, key) pairs and SDPA's time on the same
    mask. Returns the case's row of the ``kernels`` line."""
    vit = qvl is None
    S, T, H, D = q.shape
    kh, vh = (k.transpose(1, 2), v.transpose(1, 2)) if vit else (k, v)
    Hk, M = kh.shape[1], kh.shape[2]
    args = (lens, bstart, causal) if vit else (lens, bstart, causal, qvl, True)
    per = fa._launch.per_stream
    mask = fa._visibility_mask(T, M, lens, per(bstart, S, q.device),
                               per(T if vit else qvl, S, q.device), causal, q.device)
    valid = torch.arange(T, device=q.device)[None] < (lens if vit else qvl)[:, None]
    r = _compare(name, lambda: fa.flash_block_attention(q, k, v, *args),
                 lambda: fa.flash_block_attention_ref(q, k, v, *args), None,
                 back_to_back=False, valid=valid)
    seen = mask & valid[:, :, None]
    r.update(attention_bound(valid.sum(1).tolist(), seen.any(1).sum(-1).tolist(), H, Hk, D, 2,
                             "bf16", pairs=seen.sum((1, 2)).tolist()))
    r["library_ms"] = sdpa_ms(q, kh, vh, mask)
    print(f"    bound {r['bound_ms']:.4f} ms by {r['bound_by']}; SDPA, same mask "
          f"{r['library_ms']:.3f} ms", flush=True)
    r.pop("ms_back_to_back")
    return dict(case=name, **r)


def check_serving_k1a(randn, ints) -> list:
    """K1a at the batcher's admission shapes, with mixed valid lengths: the
    grouped ViT (D 72) at P 8 over the 1024 bucket (378 px images are 729
    patches) and P 4 over the 5120 bucket (980 px: 4900); the image+text
    block at P 8 (the image rows non-causal into a block of bucket + 2 +
    T_max columns, then each row's text causal after its image); the text
    block at P 32 (8 requests, 24 padding rows with no valid row) and a
    prefixed one (every row's lens the preamble's 62)."""
    cases = []
    for P, Tb, ns in ((8, 1024, (729, 513, 1024, 600, 729, 900, 800, 700)),
                      (4, 5120, (4900, 4608, 5120, 4700))):
        q, k, v = randn(P, Tb, 16, 72, scale=2.0), randn(P, Tb, 16, 72), randn(P, Tb, 16, 72)
        cases.append(_k1a_case(f"K1a ViT P={P} bucket {Tb} D=72 valid {min(ns)}-{max(ns)}",
                               q, k, v, ints(*ns), Tb, False))
    ns = torch.tensor((729, 513, 1024, 600, 729, 900, 800, 700), device="cuda")
    texts = ints(54, 41, 64, 38, 45, 60, 33, 50)
    M = 1024 + 2 + 64
    kc, vc = randn(8, 4, M, 128), randn(8, 4, M, 128)
    zero = ints(*[0] * 8)
    cases.append(_k1a_case(f"K1a image block P=8 T=1026 M={M} non-causal", randn(
        8, 1026, 28, 128, scale=2.0), kc, vc, zero, zero, False, (ns + 2).int()))
    lens = (ns + 2).int()
    cases.append(_k1a_case(f"K1a text after image P=8 T=64 M={M} causal", randn(
        8, 64, 28, 128, scale=2.0), kc, vc, lens, lens, True, texts))
    for M, pre, qvl in ((64, 0, (54, 41, 64, 38, 45, 60, 33, 50)), (128, 62, (54, 41, 38, 45))):
        kc, vc = randn(32, 4, M, 128), randn(32, 4, M, 128)
        lens = ints(*[pre] * 32)
        cases.append(_k1a_case(
            f"K1a text block P=32 T=64 M={M} causal, lens {pre}, {len(qvl)} requests",
            randn(32, 64, 28, 128, scale=2.0), kc, vc, lens, lens, True,
            ints(*qvl, *[0] * (32 - len(qvl)))))
    return cases


def check_serving_shapes(g, randn, ints) -> dict:
    """The kernels at the batched-serving shapes: K1a at the admission
    shapes (:func:`check_serving_k1a`); K2 and K2-int8 over a pool
    of 16 streams x 6144 columns with run A's mixed lens, under the aligned
    band (base the largest lens, col base + 7: step 8 of a chunk) and under
    (lens, lens) (the scatter chunk); K3 at R 16 (many-row kernel) and R 8
    (cluster kernel); K4 w4a8 per channel at m 16 and 8 (the int8 GEMM) for
    the four projections. Each row: the kernel per call (one call, and in a
    CUDA graph of 20), the plain version, the bound and, for K2, SDPA with the
    same mask. Returns {kernel name: [rows]}."""
    print("kernels at the serving shapes (pool of 16 x 6144 columns):", flush=True)
    rows = {"flash_block_attention": check_serving_k1a(randn, ints), "decode_attention": [],
            "decode_attention_int8": [], "silu_mul_quant": [], "w4_matmul": []}
    S, M = SERVE_SLOTS, SERVE_CAPACITY
    ln = ints(*SERVE_LENS)
    top = max(SERVE_LENS)
    bands = {f"aligned band [{top}, {top + 7}]": (ints(*[top] * S), ints(*[top + 7] * S)),
             "band (lens, lens)": (ln, ln)}
    q = randn(S, 1, 28, 128, scale=2.0)
    kc, vc = randn(S, 4, M, 128), randn(S, 4, M, 128)
    k8, v8 = _rand_int8(g, S, 4, M, 128), _rand_int8(g, S, 4, M, 128)
    ks = torch.rand(S, 4, M, generator=g, device="cuda") * 0.02 + 0.002
    vs = torch.rand(S, 4, M, generator=g, device="cuda") * 0.02 + 0.002
    j = torch.arange(M, device="cuda")
    for band_name, (base, col) in bands.items():
        keys = [a + max(0, c - max(a, b) + 1)
                for a, b, c in zip(SERVE_LENS, base.tolist(), col.tolist())]
        mask = (j[None] < ln[:, None]) | ((j[None] >= base[:, None]) & (j[None] <= col[:, None]))
        for int8 in (False, True):
            name = (f"K2{'-int8' if int8 else ''} decode S=16 M=6144 lens 746-5150, "
                    f"{band_name}")
            k, v = (k8, v8) if int8 else (kc, vc)
            sc = dict(k_scale=ks, v_scale=vs) if int8 else {}
            kernel = lambda: dec.decode_attention(q, k, v, ln, (base, col), **sc)  # noqa: E731
            r = _with_splits(name, S, M, _compare(
                name, kernel, lambda: dec.decode_attention_ref(q, k, v, ln, (base, col), **sc),
                1, row_atol=int8), kernel)
            r.update(attention_bound([1] * S, keys, 28, 4, 128, 1 if int8 else 2, "bf16",
                                     scales=int8))
            r["library_ms"] = None if int8 else sdpa_ms(q, kc, vc, mask[:, None])
            print(f"    bound {r['bound_ms']:.4f} ms by {r['bound_by']}; SDPA, same mask "
                  f"{r['library_ms']}", flush=True)
            r["case"] = dict(r["case"], max_abs_err=r["max_abs_err"], ms=r["ms"],
                             plain_ms=r["plain_ms"],
                             bound_ms=r["bound_ms"], library_ms=r["library_ms"])
            rows["decode_attention_int8" if int8 else "decode_attention"].append(r["case"])
    I = 18944
    for R in (16, 8):
        gate, up = randn(R, 2 * I, scale=2.0).split(I, dim=-1)
        q_ref, sc_ref = aq.silu_mul_quant_ref(gate, up)
        qq, sc = aq.silu_mul_quant(gate, up)
        torch.cuda.synchronize()
        step = (qq.int() - q_ref.int()).abs()
        share = (step > 0).float().mean().item()
        rel = ((sc - sc_ref).abs() / sc_ref).max().item()
        how = f"cluster of {aq.CLUSTER_SIZE}" if R <= aq.CLUSTER_MAX_ROWS else "many-row"
        if rel > K3_SCALE_RTOL or step.max().item() > K3_MAX_STEP or share > K3_MAX_SHARE:
            raise SystemExit(f"chip_smoke: K3 R={R} ({how}) disagrees with its plain version")
        fn = lambda: aq.silu_mul_quant(gate, up)  # noqa: E731
        ms, plain_ms = cuda_ms(fn), cuda_ms(lambda: aq.silu_mul_quant_ref(gate, up), warmup=1,
                                            iters=3)
        in_graph = graph_ms(fn)
        b = bound(R * I * 5 + R * 4, R * I * 15, "fp32")
        _line(f"K3 R={R} ({how})", f"max step {step.max().item()}, share differing "
              f"{share:.2e}, scale rel err {rel:.2e}", ms, plain_ms, b,
              f"; {in_graph:.4f} ms per call in a CUDA graph of {BACK_TO_BACK}")
        rows["silu_mul_quant"].append(dict(case=f"R={R} ({how})", max_abs_err=float(
            step.max().item()), ms=ms, ms_in_graph=in_graph, plain_ms=plain_ms,
            library_ms=None, **b))
    for proj, (K, N) in zip(("qkv", "o", "gate_up", "down"),
                            [(3584, 4608), (3584, 3584), (3584, 37888), (18944, 3584)]):
        wp = w4.pack_int4(_rand_int8(g, N, K, lo=-8, hi=8))
        ws = torch.rand(N, generator=g, device="cuda") * 0.01 + 0.001
        for m in (16, 8):
            x = _rand_int8(g, m, K)
            xs = torch.rand(m, 1, generator=g, device="cuda") * 0.05 + 0.001
            got, want = w4.w4_matmul(x, xs, wp, ws), w4.w4_matmul_ref(x, xs, wp, ws)
            fn = lambda: w4.w4_matmul(x, xs, wp, ws)  # noqa: E731
            ms = cuda_ms(fn)
            plain_ms = cuda_ms(lambda: w4.w4_matmul_ref(x, xs, wp, ws), warmup=1, iters=3)
            in_graph = graph_ms(fn)
            b = bound(m * K + m * 4 + N * K // 2 + N * 4 + m * N * 2, 2.0 * m * K * N, "int8")
            equal = torch.equal(got, want)
            _line(f"K4 w4a8 {proj} m={m} K={K} N={N} per channel", f"equal {equal}", ms,
                  plain_ms, b, f"; {in_graph:.4f} ms per call in a CUDA graph of {BACK_TO_BACK}")
            if not equal:
                raise SystemExit("chip_smoke: K4 (w4a8) differs from its plain version")
            rows["w4_matmul"].append(dict(
                case=f"w4a8 {proj} m={m} per channel", max_abs_err=0.0, ms=ms,
                ms_in_graph=in_graph, plain_ms=plain_ms, library_ms=None, **b))
    return rows


# -- the kernels at this slice's shapes (eval's int4 pool, quantized text to image) ----------
GEN_ROWS = (3078, 1026)  # a 512 px denoise step's rows: 3 streams x 1026, and 1 stream
PROJECTIONS = (("qkv", 3584, 4608), ("o", 3584, 3584), ("gate_up", 3584, 37888),
               ("down", 18944, 3584))


def check_generation_quant_shapes(g, randn) -> dict:
    """K3 and K4 at the quantized generation path's rows (m 3078 and 1026:
    the 3-stream and 1-stream steps at 512 px): K3 at I 18944 (q within
    K3_MAX_STEP, scales within K3_SCALE_RTOL), K4 at the four projections
    per channel with int8 x (w4a8: EQUAL to the plain version) and bf16 x
    (weight-only w4: the reordering bound of :func:`check_w4_matmul`). Each
    K4 row carries the ``torch.mm`` time on the weight unpacked and scaled to
    bf16 (a yardstick: no PyTorch call multiplies by packed int4). Returns
    {kernel name: [rows]}."""
    print("K3 and K4 at the 512 px denoise step's rows (m 3078 = 3 x 1026, m 1026):",
          flush=True)
    rows = {"silu_mul_quant": [], "w4_matmul": []}
    I = 18944
    for R in GEN_ROWS:
        gate, up = randn(R, 2 * I, scale=2.0).split(I, dim=-1)
        q_ref, sc_ref = aq.silu_mul_quant_ref(gate, up)
        qq, sc = aq.silu_mul_quant(gate, up)
        torch.cuda.synchronize()
        step = (qq.int() - q_ref.int()).abs()
        share = (step > 0).float().mean().item()
        rel = ((sc - sc_ref).abs() / sc_ref).max().item()
        if rel > K3_SCALE_RTOL or step.max().item() > K3_MAX_STEP or share > K3_MAX_SHARE:
            raise SystemExit(f"chip_smoke: K3 R={R} disagrees with its plain version")
        ms = cuda_ms(lambda: aq.silu_mul_quant(gate, up))
        plain_ms = cuda_ms(lambda: aq.silu_mul_quant_ref(gate, up), warmup=1, iters=3)
        b = bound(R * I * 5 + R * 4, R * I * 15, "fp32")
        _line(f"K3 R={R}", f"max step {step.max().item()}, share differing {share:.2e}, "
              f"scale rel err {rel:.2e}", ms, plain_ms, b)
        rows["silu_mul_quant"].append(dict(case=f"R={R}", max_abs_err=float(step.max().item()),
                                           ms=ms, plain_ms=plain_ms, library_ms=None, **b))
    for proj, K, N in PROJECTIONS:
        wp = w4.pack_int4(_rand_int8(g, N, K, lo=-8, hi=8))
        ws = torch.rand(N, generator=g, device="cuda") * 0.01 + 0.001
        wb = (w4.unpack_int4(wp).float() * ws[:, None]).to(torch.bfloat16)
        for m in GEN_ROWS:
            for kind in ("w4a8", "bf16 x"):
                if kind == "w4a8":
                    x = _rand_int8(g, m, K)
                    xs = torch.rand(m, 1, generator=g, device="cuda") * 0.05 + 0.001
                    got, want = w4.w4_matmul(x, xs, wp, ws), w4.w4_matmul_ref(x, xs, wp, ws)
                    ok = torch.equal(got, want)
                    err = (got.float() - want.float()).abs().max().item()
                    text = f"equal {ok}"
                    b = bound(m * K + m * 4 + N * K // 2 + N * 4 + m * N * 2, 2.0 * m * K * N,
                              "int8")
                    xb = randn(m, K)  # the yardstick's bf16 x of the same shape
                else:
                    x, xs = randn(m, K), None
                    got = w4.w4_matmul(x, None, wp, ws).float()
                    torch.cuda.synchronize()
                    want = w4.w4_matmul_ref(x, None, wp, ws).float()
                    tol = (2.0**-7 * want.abs()
                           + 1e-3 * K**0.5 * 8 * x.float().abs().max() * ws.max() / 16)
                    err = (got - want).abs().max().item()
                    worst = ((got - want).abs() / tol).max().item()
                    ok = worst <= 1.0
                    text = f"max abs err {err:.3e}, worst err/bound {worst:.3f}"
                    b = bound(m * K * 2 + N * K // 2 + N * 4 + m * N * 2, 2.0 * m * K * N, "bf16")
                    xb = x
                if not ok:
                    raise SystemExit(f"chip_smoke: K4 {kind} {proj} m={m} disagrees with its "
                                     "plain version")
                ms = cuda_ms(lambda: w4.w4_matmul(x, xs, wp, ws))
                plain_ms = cuda_ms(lambda: w4.w4_matmul_ref(x, xs, wp, ws), warmup=1, iters=3)
                mm_ms = cuda_ms(lambda: torch.mm(xb, wb.t()))
                _line(f"K4 {kind} {proj} m={m} K={K} N={N} per channel", text, ms, plain_ms, b,
                      f"; torch.mm on the unpacked bf16 weight {mm_ms:.4f} ms")
                rows["w4_matmul"].append(dict(
                    case=f"{kind} {proj} m={m} per channel", max_abs_err=err, ms=ms,
                    plain_ms=plain_ms, library_ms=None, yardstick_mm_ms=mm_ms, **b))
        del wb
    return rows


def check_int4_decode(g, randn, ints) -> list:
    """K2-int8 behind the int4 cache's unpack at run A's pool (16 streams x
    6144 columns, run A's lens): random int4 values packed two a byte as the
    cache stores them, unpacked a layer's slice at a time
    (``qwen2_mot._decode_kv``: every column, k and v) and read by K2-int8
    with the scales, under (lens, lens) and the aligned band. The unpack
    must give back the values packed; K2-int8 is held to its plain version
    on the unpacked values. Times the unpack apart from K2-int8. Returns the
    rows."""
    print("K2-int8 behind the int4 unpack (pool of 16 x 6144, run A's lens):", flush=True)
    S, M, D = SERVE_SLOTS, SERVE_CAPACITY, 128
    ln = ints(*SERVE_LENS)
    top = max(SERVE_LENS)
    q = randn(S, 1, 28, D, scale=2.0)
    k4, v4 = (_rand_int8(g, S, 4, M, D, lo=-7, hi=8) for _ in "kv")
    kp, vp = qwen2_mot.pack_int4(k4), qwen2_mot.pack_int4(v4)
    ks = torch.rand(S, 4, M, generator=g, device="cuda") * 0.3 + 0.03
    vs = torch.rand(S, 4, M, generator=g, device="cuda") * 0.3 + 0.03
    k8, v8 = qwen2_mot._decode_kv(kp, vp, 4)
    if not (torch.equal(k8, k4) and torch.equal(v8, v4)):
        raise SystemExit("chip_smoke: the int4 unpack does not give back the packed values")
    unpack_ms = cuda_ms(lambda: qwen2_mot._decode_kv(kp, vp, 4))
    # the unpack reads k and v packed and writes them as int8
    unpack_bound = bound(2 * S * 4 * M * (D // 2 + D), 0, "int8")
    print(f"  int4 unpack of a layer's k and v slices [{S}, 4, {M}, {D // 2}] -> int8: equal "
          f"True; "
          f"{unpack_ms:.4f} ms (bound {unpack_bound['bound_ms']:.4f} ms by bytes), "
          f"{28 * unpack_ms:.2f} ms a decode step of 28 layers", flush=True)
    rows = []
    bands = {"band (lens, lens)": (ln, ln),
             f"aligned band [{top}, {top + 7}]": (ints(*[top] * S), ints(*[top + 7] * S))}
    for band_name, (base, col) in bands.items():
        name = f"K2-int8 on unpacked int4, S={S} M={M}, {band_name}"
        kernel = lambda: dec.decode_attention(q, k8, v8, ln, (base, col), k_scale=ks,  # noqa: E731
                                              v_scale=vs)
        r = _with_splits(name, S, M, _compare(
            name, kernel, lambda: dec.decode_attention_ref(q, k8, v8, ln, (base, col), ks, vs),
            1, row_atol=True), kernel)
        keys = [a + max(0, c - max(a, b) + 1)
                for a, b, c in zip(SERVE_LENS, base.tolist(), col.tolist())]
        r.update(attention_bound([1] * S, keys, 28, 4, D, 1, "bf16", scales=True))
        rows.append(dict(r["case"], max_abs_err=r["max_abs_err"], ms=r["ms"],
                         plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], library_ms=None,
                         unpack_ms=unpack_ms, unpack_bound_ms=unpack_bound["bound_ms"]))
    return rows


def _pil_image(arr: np.ndarray):
    from PIL import Image

    return Image.fromarray(arr)


def _image_group(rng, i: int, n: int):
    """REQUESTS[i] and ``n`` more random images of its size, as (image array,
    prompt, prefixed) requests: one bucket, so one grouped prefill."""
    h, w, prompt = REQUESTS[i]
    return [(_images()[i], prompt, False)] + [
        (rng.integers(0, 256, (h, w, 3), dtype=np.uint8), f"{prompt} (view {k})", False)
        for k in range(1, n + 1)]


def serving_workload(run: str):
    """Run A and B's 24 requests, or run C's 12, as two waves of arrivals
    (the second submitted after the first round, as a server receives them):
    (wave 1, wave 2), each a list of (image array or None, prompt, prefixed).
    A/B: wave 1 the three REQUESTS and three more of each of their sizes
    (980x980, 378x532, 378x378); wave 2 four more 378x378 and the eight text
    prompts, the first four on the registered preamble. C: eight 378x378
    (REQUESTS[2] first), then four more."""
    rng = np.random.default_rng(SEED + 7)
    if run == "C":
        return _image_group(rng, 2, 7), _image_group(rng, 2, 4)[1:]
    first = _image_group(rng, 0, 3) + _image_group(rng, 1, 3) + _image_group(rng, 2, 3)
    text = [(None, p, k < 4) for k, p in enumerate(SERVE_TEXT)]
    return first, _image_group(rng, 2, 4)[1:] + text


def logits_workload(run: str):
    """The first-step logits check's requests, admitted in one round: images
    in groups of more than one per bucket (A, B: REQUESTS[0], [1] and [2]
    with 1, 1 and 3 more of their sizes; C: REQUESTS[2] with 7 more), two
    plain text prompts (rows 0 and 1 of their block) and two on the
    preamble."""
    rng = np.random.default_rng(SEED + 11)
    images = (_image_group(rng, 2, 7) if run == "C" else
              _image_group(rng, 0, 1) + _image_group(rng, 1, 1) + _image_group(rng, 2, 3))
    return images + [(None, SERVE_TEXT[4], False), (None, SERVE_TEXT[5], False),
                     (None, SERVE_TEXT[0], True), (None, SERVE_TEXT[1], True)]


class ForwardCounter:
    """Forwards of the LLM split into denoise steps (gen-mode forwards that
    leave the cache as it was), decode steps (one row per stream) and
    prefills (the speculative verify forwards among them, counted also in
    ``verify``), and forwards of the ViT; ``gen`` counts the gen-mode
    forwards (VAE image prefills and denoise steps, through K1b): the
    launches a run must show follow from them. A captured device program's
    step counts at each replay (``programs.listeners``: a decode or chunk
    step is a decode step, a verify forward a prefill and a verify, a flow
    step a denoise step, a prefill program's the forwards its graph names:
    its ViT forward of ``graph.rows`` images, its LLM prefills, gen-mode or
    not), and the forwards of a graph's warm-up and capture count nowhere."""

    def __init__(self, model):
        self.decode = self.prefill = self.vit = self.verify = self.denoise = self.gen = 0
        self.vit_rows = []  # the images of each ViT forward
        lm = model.language_model.model
        self.hooks = [
            lm.register_forward_pre_hook(self._llm, with_kwargs=True),
            model.vit_model.register_forward_pre_hook(self._vit),
        ]
        programs.listeners.append(self._replay)

    def _replay(self, graph):
        if graph.kind == "prefill":
            f = graph.forwards
            self.vit += f.get("vit", 0)
            self.vit_rows += [graph.rows] * f.get("vit", 0)
            self.prefill += f.get("prefill", 0)
            self.gen += f.get("gen", 0)
        elif graph.kind == "denoise":
            self.denoise += 1
            self.gen += 1
        elif graph.kind == "verify":
            self.prefill += 1
            self.verify += 1
        else:
            self.decode += 1

    def _llm(self, module, args, kwargs):
        if programs.capturing():
            return
        self.gen += kwargs.get("mode") == "gen"  # VAE image blocks and denoise steps
        if kwargs.get("update_cache") is False:
            self.denoise += 1
        elif args[0].shape[1] == 1:
            self.decode += 1
        else:  # a prefill block has 18 rows or more, a verify block SPEC_K + 1
            self.prefill += 1
            self.verify += args[0].shape[1] == SPEC_K + 1

    def _vit(self, module, args):
        if programs.capturing():
            return
        self.vit += 1
        self.vit_rows.append(args[0].shape[0])

    def remove(self):
        for h in self.hooks:
            h.remove()
        programs.listeners.remove(self._replay)


# an answer that parts from chat's passes only at a near-tie: the engine took
# chat's second choice, whose logit is within this many times the largest
# first-step logit difference between the pool and chat measured in the run
NEAR_TIE_FACTOR = 2.0
SERVE_TIGHT = 96  # the near-capacity run's pool capacity (columns)


def _greedy_steps(inf: InterleaveInferencer, decode, max_length: int):
    """``decode()`` (a plain greedy decode of ``inf``: one lm_head call a
    step), with ``qwen2_mot.lm_head`` wrapped while it runs to keep the two
    largest logits of every step. Returns (ids: [bos] and the greedy tokens,
    eos last where the answer ended on it, at most max_length; steps:
    [(top-2 values, top-2 ids)] per step)."""
    steps = []
    lm_head = qwen2_mot.lm_head

    def record(lm, h):
        logits = lm_head(lm, h)
        steps.append(torch.topk(logits[0], 2))
        return logits

    qwen2_mot.lm_head = record
    try:
        with programs.eager():  # the eager loop: a graph would not call the wrapper
            decode()
    finally:
        qwen2_mot.lm_head = lm_head
    steps = [(t.values.tolist(), t.indices.tolist()) for t in steps]
    ids = ([inf.new_token_ids["bos_token_id"]] + [i[0] for _v, i in steps])[:max_length]
    eos = inf.new_token_ids["eos_token_id"]
    return (ids[: ids.index(eos) + 1] if eos in ids else ids), steps


_CHAT_STEPS = {}  # (inferencer, image digest, prompt, max_length) -> _greedy_steps' result
_INF_KEYS = itertools.count()  # an inferencer's key there (an id() may be reused)


def _chat_ids(inf: InterleaveInferencer, decode, max_length: int) -> list:
    """``decode()`` (a greedy chat of ``inf``) by its default route, the
    captured decode program on the card: [bos] and the answer's ids, eos
    last where the answer ended on it (:func:`_greedy_steps`' form)."""
    outs = []
    generate = bagel.generate_text

    def recording(*args, **kw):
        out = generate(*args, **kw)
        outs.append(out[0][0].tolist())
        return out

    bagel.generate_text = recording
    try:
        decode()
    finally:
        bagel.generate_text = generate
    ids = [i for i in outs[-1] if i >= 0]
    return ids + ([inf.new_token_ids["eos_token_id"]] if len(ids) < max_length else [])


class _LazySteps:
    """chat's top-2 per step (:func:`_greedy_steps`), computed on the eager
    route at the first read and held to the graphed answer's ids: a gate
    reads them only where an answer parts from chat's, so the references
    decode on the captured program and a parting request once eagerly. The
    inferencer is held weakly: a kept reference must not keep its model on
    the card."""

    def __init__(self, inf: InterleaveInferencer, image, prompt: str, max_length: int,
                 ids: list):
        self.inf, self.request, self.ids, self.steps = weakref.ref(inf), (
            image, prompt, max_length), ids, None

    def _get(self) -> list:
        if self.steps is None:
            inf = self.inf()
            if inf is None:
                raise SystemExit("chip_smoke: a chat reference's inferencer was freed")
            image, prompt, max_length = self.request
            ids, self.steps = _greedy_steps(inf, lambda: inf.chat(
                [] if image is None else [image], prompt, max_length=max_length), max_length)
            if ids != self.ids:
                raise SystemExit("chip_smoke: chat's eager answer differs from its graphed one")
        return self.steps

    def __getitem__(self, i):
        return self._get()[i]

    def __iter__(self):
        return iter(self._get())

    def __len__(self) -> int:
        return len(self._get())


def _chat_steps(inf: InterleaveInferencer, image, prompt: str, max_length: int):
    """chat's answer ids on one request and its top-2 per step (lazily:
    :class:`_LazySteps`), kept for the run: the serving runs and the spec
    phase gate the same requests against the same inferencer."""
    digest = None if image is None else hashlib.sha1(image.tobytes()).hexdigest()
    key = (inf.__dict__.setdefault("_smoke_key", next(_INF_KEYS)), digest, prompt, max_length)
    if key not in _CHAT_STEPS:
        def decode():
            return inf.chat([] if image is None else [image], prompt, max_length=max_length)

        ids = _chat_ids(inf, decode, max_length)
        _CHAT_STEPS[key] = ids, _LazySteps(inf, image, prompt, max_length, ids)
    return _CHAT_STEPS[key]


def check_answers(run: str, ref: InterleaveInferencer, requests, got_ids: dict, max_new,
                  gap_limit: float, reference=None) -> list:
    """Each request's answer ids (``got_ids``: rid -> the slot's out_ids)
    against ``ref.chat``'s on the same request: equal, or parting at a
    near-tie, where the engine took chat's second choice and chat's top-2
    logits lie within ``gap_limit``. ``requests``: [(rid, image, prompt)];
    ``max_new``: one budget, or one per request. Prints each request's
    agreeing tokens and, where it parts, the step, chat's top-2 gap there and
    whether the engine took chat's runner-up. ``reference(image, prompt,
    budget)`` replaces chat as the reference (:func:`_greedy_steps`' result).
    Returns the splits as (step, gap) pairs; fails on one that is no
    near-tie."""
    eos = ref.new_token_ids["eos_token_id"]
    budgets = max_new if isinstance(max_new, list) else [max_new] * len(requests)
    shown, splits, bad = [], [], []
    for (rid, image, prompt), budget in zip(requests, budgets):
        want, steps = (reference or partial(_chat_steps, ref))(image, prompt, budget)
        got = got_ids[rid] + ([eos] if len(got_ids[rid]) < budget else [])
        n = 0
        while n < min(len(got), len(want)) and got[n] == want[n]:
            n += 1
        if n == len(got) == len(want):
            shown.append(f"{n - 1}/{n - 1}")
            continue
        (v1, v2), (_i1, i2) = steps[n - 1]
        runner_up = n < len(got) and got[n] == i2
        splits.append((n, v1 - v2))
        shown.append(f"{n - 1}/{len(want) - 1} (parts at token {n}: chat's top-2 gap "
                     f"{v1 - v2:.4f}, engine took chat's runner-up: {runner_up})")
        if not (runner_up and v1 - v2 <= gap_limit):
            bad.append(rid)
    print(f"  run {run}: answer tokens agreeing with chat's, per request (agree/len; a split "
          f"passes as a near-tie with a top-2 gap <= {gap_limit:.4f}): {' '.join(shown)}",
          flush=True)
    if bad:
        raise SystemExit(f"chip_smoke: serving run {run}: requests {bad} part from chat's "
                         "answer at no near-tie")
    return splits


def _recording_ids(b: ContinuousBatcher) -> dict:
    """rid -> the slot's out_ids ([start token] + the emitted tokens, no eos),
    kept as the batcher finishes each request."""
    ids = {}
    finish = b._finish

    def record(slot):
        ids[slot.request_id] = list(slot.out_ids)
        finish(slot)

    b._finish = record
    return ids


def _engine_first_step_logits(b: ContinuousBatcher, scatter: bool) -> torch.Tensor:
    """After admission: the first decode step of every slot over a clone of
    the pool, through the engine's own step (``serving._step_logits``) with
    the options that the aligned chunk gives its step 0 or, with
    ``scatter``, the scatter chunk's. Returns the logits [pool, V]."""
    cache = b.cache.clone()
    slots = b.slots[: b.pool]
    live = [s.request_id is not None for s in slots]
    active = torch.tensor(live, device=b.device)
    cur = torch.tensor([s.cur_token if a else 0 for s, a in zip(slots, live)],
                       dtype=torch.int32, device=b.device)
    pos = torch.tensor([s.position for s in slots], dtype=torch.int64, device=b.device)
    step_kw = serving._scatter_kw(active) if scatter else serving._aligned_kw(cache, active)[1]
    with torch.no_grad():
        logits, _ = serving._step_logits(b.model, cache, cur, pos, **step_kw(0))
    return logits


def _verify_row0_logits(model, cache: qwen2_mot.KVCache, cur: torch.Tensor, pos: torch.Tensor,
                        live: torch.Tensor) -> torch.Tensor:
    """A speculative verify forward ([S, SPEC_K + 1]: each stream's current
    token and SPEC_K zero drafts, causal, the ``live`` rows valid) over
    ``cache``, written past its lens; the logits [S, V] of row 0, the one
    that a plain step's logits compare with (the rows after it see the
    drafts)."""
    lm = model.language_model
    S = cur.shape[0]
    block = torch.cat([cur[:, None], torch.zeros((S, SPEC_K), dtype=cur.dtype,
                                                 device=cur.device)], dim=1)
    positions = pos[:, None] + torch.arange(SPEC_K + 1, device=pos.device)
    with torch.no_grad():
        h, _ = lm.model(qwen2_mot.embed_tokens(lm, block), positions, cache, causal=True,
                        q_valid=live[:, None].expand(S, SPEC_K + 1))
        return qwen2_mot.lm_head(lm, h[:, 0])


def _engine_first_verify_logits(b: ContinuousBatcher) -> torch.Tensor:
    """After admission: every slot's first verify forward over a clone of
    the pool; the logits [pool, V] of its row 0."""
    slots = b.slots[: b.pool]
    live = torch.tensor([s.request_id is not None for s in slots], device=b.device)
    cur = torch.tensor([s.cur_token if s.request_id is not None else 0 for s in slots],
                       dtype=torch.int64, device=b.device)
    pos = torch.tensor([s.position for s in slots], dtype=torch.int64, device=b.device)
    return _verify_row0_logits(b.model, b.cache.clone(), cur, pos, live)


def _prompt(prompt: str, prefixed: bool) -> str:
    return (SERVE_PREAMBLE if prefixed else "") + prompt


def check_serving_logits(run: str, ref: InterleaveInferencer, engine,
                         flavours=("aligned", "scatter")) -> float:
    """The first-step logits of :func:`logits_workload`'s requests, admitted
    in one round (every ViT group of more than one image; the text rows in a
    P = 32 block, two of them after the preamble), the step run as the
    aligned chunk and as the scatter chunk run it (or as a speculative
    chunk's verify forward runs it: ``flavours`` ("verify",)), against
    chat's on the same request at LOGITS_COS_TOL. Returns the largest
    |logit difference|."""
    b = engine()
    pid = b.register_prefix(SERVE_PREAMBLE)
    reqs = logits_workload(run)
    rids = [b.submit(Request(prompt=p, image=None if a is None else _pil_image(a),
                             max_new_tokens=SERVE_MAX_NEW, prefix_id=pid if pre else None))
            for a, p, pre in reqs]
    counter = ForwardCounter(ref.model)
    b._admit()
    counter.remove()
    if b.errors or min(counter.vit_rows) < 2:
        raise SystemExit(f"chip_smoke: serving run {run}: the logits check's admission gave "
                         f"errors {b.errors}, ViT groups {counter.vit_rows}")
    logits = {flavour: _engine_first_verify_logits(b) if flavour == "verify" else
              _engine_first_step_logits(b, flavour == "scatter") for flavour in flavours}
    slot_of = {s.request_id: i for i, s in enumerate(b.slots[: b.pool])}
    worst = 0.0
    for rid, (arr, prompt, pre) in zip(rids, reqs):
        what = "text" if arr is None else "x".join(map(str, arr.shape[:2]))
        what += " after the preamble" if pre else ""
        want = _first_step_logits(ref, arr, _prompt(prompt, pre))
        for flavour, rows in logits.items():
            got = rows[slot_of[rid]]
            cos = torch.nn.functional.cosine_similarity(got, want, dim=0).item()
            diff = (got - want).abs().max().item()
            finite = bool(torch.isfinite(got).all())
            worst = max(worst, diff)
            print(f"  run {run} {what}: first-step logits in the pool ({flavour} step) vs "
                  f"chat's: cosine {cos:.6f}, max abs {diff:.4f}, argmax "
                  f"{got.argmax().item()} vs {want.argmax().item()}, finite {finite}", flush=True)
            if not finite or cos < LOGITS_COS_TOL:
                raise SystemExit(f"chip_smoke: serving run {run}: first-step logits disagree "
                                 "with chat's")
    print(f"  run {run}: ViT groups of {counter.vit_rows} images; logits of {len(reqs)} "
          f"requests checked", flush=True)
    del b
    torch.cuda.empty_cache()
    return worst


def run_serving(name: str, ref: InterleaveInferencer, run: str, min_pool: int,
                k3_per_layer: int, k4_per_layer: int, spec: bool = False,
                warm: bool = False) -> dict:
    """One serving run at the full width: ``ContinuousBatcher`` over
    ``ref.model`` (pool of 16 x 6144 columns, chunks of 16, the ladder down to
    ``min_pool``, an int8 pool when ``ref`` has an int8 cache). First the
    first-step logits check (:func:`check_serving_logits`). Then a warm-up
    request (it leaves the pool at the smallest rung, so the run grows it);
    then, counters reset, the preamble registered and the workload's two
    waves served. Checks the launches against the forwards the run made, that
    every request was answered, ``errors`` is empty and each answer is
    chat's or parts from it at a near-tie (:func:`check_answers`); prints the
    seconds, ``stats``, emitted tokens per second. With ``spec`` the engine
    decodes speculatively (``spec_decode=True``, SPEC_K drafts, SPEC_NGRAM)
    over a pool that keeps its 16 rows (no ladder); the logits check runs
    the verify forward's first row, and the row adds the tokens per verify
    forward and the int8 dequantize time of one verify forward (both layer
    slices of the pool, every layer). Returns (the launches, the near-tie gap
    limit). The workload runs twice: by the default route, the captured
    chunk programs (the run's launches and answers), then on an eager
    batcher (``graphs=False``), whose tokens and decode steps (with ``spec``
    verify forwards) run the graphed run must show. With ``warm`` the eager
    batcher runs first and its admission blocks are built again by their
    programs (:func:`_admission_recorded`, :func:`_capture_admission`): the
    graphed run replays programs captured before it, and each program's block
    is held to the eager one."""
    kv_quantized = ref.kv_quantized
    first, later = serving_workload(run)
    options = (dict(spec_decode=True, spec_k=SPEC_K, spec_ngram=SPEC_NGRAM) if spec
               else dict(pool_ladder=True, min_pool=min_pool))
    print(f"serving run {run} ({name}): {len(first) + len(later)} requests in two waves, "
          f"max_new_tokens {SERVE_MAX_NEW}, ContinuousBatcher(num_slots={SERVE_SLOTS}, "
          f"capacity={SERVE_CAPACITY}, chunk={SERVE_CHUNK}, kv_quantized={kv_quantized}, "
          f"{', '.join(f'{k}={v}' for k, v in options.items())})", flush=True)

    def engine(graphs=None):
        return ContinuousBatcher(
            ref.model, ref.tokenizer, ref.new_token_ids, SERVE_SLOTS, SERVE_CAPACITY,
            SERVE_CHUNK, ref.vit_transform, SEED, kv_quantized=kv_quantized, graphs=graphs,
            **options)

    # the logits check admits eagerly: its groups' shapes are not the run's, and the
    # admission programs are held to the eager blocks below
    gap_limit = NEAR_TIE_FACTOR * check_serving_logits(
        run, ref, lambda: engine(False), ("verify",) if spec else ("aligned", "scatter"))
    # with ``warm`` the eager run comes first: its admission blocks, built again by their
    # programs (captured there), make the graphed run's admission warm
    routes = [("eager", False), ("graphed", None)] if warm else [("graphed", None),
                                                                 ("eager", False)]
    runs = {}
    for route, graphs in routes:
        recording = warm and route == "eager"
        with (_admission_recorded() if recording else contextlib.nullcontext()) as calls:
            runs[route] = _serve_waves(run, ref, engine(graphs), first, later, min_pool, spec,
                                       route, k3_per_layer, k4_per_layer)
        if recording:
            blocks = _capture_admission(calls)
            print(f"  run {run}: the eager run's admission blocks by their programs, captured "
                  f"now: every array equal to the eager block's, {json.dumps(blocks)}",
                  flush=True)
    launches, rids, got_ids, row = runs["graphed"]
    _, eager_rids, eager_ids, eager_row = runs["eager"]
    same = [r for r, e in zip(rids, eager_rids) if got_ids.get(r) == eager_ids.get(e)]
    ran = row["stats"]["decode_steps"]
    forwards = "verify_forwards" if spec else "decode_forwards"
    step = "verify forward" if spec else "decode step"
    print(f"  run {run}: graphed vs eager batcher: requests with equal tokens "
          f"{len(same)}/{len(rids)}; {step}s run {ran} graphed (of {row[forwards]} replays: "
          f"{row[forwards] - ran} past a chunk's exit), {eager_row[forwards]} eager; emitted "
          f"tok/s {row['emitted_tok_s']:.1f} graphed, {eager_row['emitted_tok_s']:.1f} eager; ms "
          f"per {step} {row['ms_per_decode_step']:.3f} graphed, "
          f"{eager_row['ms_per_decode_step']:.3f} eager; admit_s {row['stats']['admit_s']:.4f} "
          f"graphed, {eager_row['stats']['admit_s']:.4f} eager; graphs captured "
          f"{row['graphs_captured']}, the graph pool at most {row['graph_pool_bytes_max']} "
          f"bytes so far ({CARD})",
          flush=True)
    if len(same) != len(rids) or ran != eager_row[forwards]:
        raise SystemExit(f"chip_smoke: serving run {run}: the graphed batcher's tokens or "
                         f"{step}s differ from the eager batcher's")
    check_answers(run, ref, [(rid, a, _prompt(p, pre)) for rid, (a, p, pre)
                             in zip(rids, first + later)], got_ids, SERVE_MAX_NEW, gap_limit)
    return launches, gap_limit


def _serve_waves(run: str, ref: InterleaveInferencer, b: ContinuousBatcher, first, later,
                 min_pool: int, spec: bool, route: str, k3_per_layer: int,
                 k4_per_layer: int):
    """:func:`run_serving`'s workload on engine ``b``: the warm-up request,
    then, counters reset, the preamble and the two waves. Checks the launches
    against the forwards (a replay of a chunk program is a decode forward,
    those past a chunk's exit included), the answers and ``errors``; prints
    the row. Returns (launches, rids, the answer ids, the row)."""
    n_vit, n_llm = ref.cfg.vit.num_hidden_layers, ref.cfg.llm.num_hidden_layers
    decode_key = "decode_attention_int8" if ref.kv_quantized else "decode_attention"
    b.submit(Request(prompt="warm-up", max_new_tokens=2))
    b.run()
    if b.pool != (SERVE_SLOTS if spec else min_pool):
        raise SystemExit(f"chip_smoke: the drained pool is {b.pool} rows, not {min_pool}")
    eos = b.new_token_ids["eos_token_id"]
    got_ids = _recording_ids(b)
    counter = ForwardCounter(ref.model)
    reset_counts()
    captures = programs.stats["captures"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pid = b.register_prefix(SERVE_PREAMBLE)

    def submit(wave):
        return [b.submit(Request(prompt=p, image=None if a is None else _pil_image(a),
                                 max_new_tokens=SERVE_MAX_NEW,
                                 prefix_id=pid if pre else None)) for a, p, pre in wave]

    rids = submit(first)
    st = b._reset_stats()
    pools = []
    while b.has_work():
        b._round(st, eos)
        pools.append(b.pool)
        if st["rounds"] == 1:
            rids += submit(later)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counter.remove()
    forwards = counter.decode + counter.prefill
    launches = check_counts(f"serving run {run} ({route})", {
        "flash_block_attention": counter.vit * n_vit + counter.prefill * n_llm,
        decode_key: counter.decode * n_llm,
        "silu_mul_quant": forwards * n_llm * k3_per_layer,
        "w4_matmul": forwards * n_llm * k4_per_layer,
    })
    answers = dict(b._done)
    missing = [r for r in rids if not isinstance(answers.get(r), str)]
    if b.errors or missing:
        raise SystemExit(f"chip_smoke: serving run {run}: errors {b.errors}, unanswered {missing}")
    rounds = st["rounds"]
    row = dict(card=CARD, route=route, seconds=seconds, emitted_tokens=st["emitted_tokens"],
               emitted_tok_s=st["emitted_tokens"] / seconds,
               stats={k: st[k] for k in ("rounds", "admit_s", "decode_s", "host_s", "round_s",
                                         "repacks", "repack_s", "admitted", "decode_steps")},
               pool_by_round=pools, decode_forwards=counter.decode,
               # a spec run's steps are its verify forwards run (replays past a chunk's exit
               # left out), the device counter the batcher adds to decode_steps
               ms_per_decode_step=1e3 * st["decode_s"] / max(
                   1, st["decode_steps"] if spec else counter.decode),
               tokens_per_decode_forward=st["emitted_tokens"] / max(
                   1, st["decode_steps"] if spec else counter.decode),
               prefill_forwards=counter.prefill, vit_forwards=counter.vit,
               vit_group_images=counter.vit_rows,
               graphs_captured=programs.stats["captures"] - captures,
               graph_pool_bytes_max=programs.stats["pool_bytes_max"],
               graph_pool_bytes=programs.pool_bytes(), live_programs=len(programs.programs()),
               launches_per_round={k: v / rounds for k, v in launches.items() if v})
    if spec:
        k8, v8, ks, vs, _bits = b.cache.layer(0)
        dequant = cuda_ms(lambda: (qwen2_mot.dequant_slice(k8, ks, torch.bfloat16),
                                   qwen2_mot.dequant_slice(v8, vs, torch.bfloat16)))
        row.update(verify_forwards=counter.verify,
                   dequant_ms_per_verify_forward=dequant * ref.cfg.llm.num_hidden_layers,
                   dequant_ms_per_layer=dequant)
    print(f"  run {run}: {json.dumps(row)}", flush=True)
    del b
    torch.cuda.empty_cache()
    return launches, rids, got_ids, row


@contextlib.contextmanager
def _admission_recorded():
    """Within the block every admission block the batcher builds
    (``serving.image_text_block``, ``serving.text_block``) is recorded:
    yields the list of (name, function, args, keyword args but ``graphs``)."""
    calls = []
    saved = serving.image_text_block, serving.text_block

    def wrap(name, fn):
        def recording(*args, graphs=None, **kw):
            calls.append((name, fn, args, kw))
            return fn(*args, graphs=graphs, **kw)
        return recording

    serving.image_text_block = wrap("image_text_block", saved[0])
    serving.text_block = wrap("text_block", saved[1])
    try:
        yield calls
    finally:
        serving.image_text_block, serving.text_block = saved


def _capture_admission(calls) -> dict:
    """Each recorded admission block built by its program (``graphs=None``:
    captured at its first use) and eagerly (``graphs=False``): every array
    of the two must be equal, bit for bit (the program zeroes its block as
    the eager route makes a new one). Returns the blocks checked by kind."""
    checked = {}
    for name, fn, args, kw in calls:
        got = fn(*args, graphs=None, **kw)
        want = fn(*args, graphs=False, **kw)
        for a, w in zip(serving._arrays(got) + [got.lens], serving._arrays(want) + [want.lens]):
            if not torch.equal(a, w):
                diff = (a.float() - w.float()).abs().max().item()
                raise SystemExit(f"chip_smoke: the {name} program's block differs from the "
                                 f"eager block (max abs {diff}, shape {tuple(a.shape)})")
        checked[name] = checked.get(name, 0) + 1
    return checked


def run_near_capacity(run: str, ref: InterleaveInferencer, gap_limit: float) -> dict:
    """The scatter chunk at the full width: four text requests (SERVE_TEXT[:4])
    in a pool of 4 x SERVE_TIGHT columns, each asking for as many tokens as
    its extent allows, less 0, 5, 10 and 15. Their decode tails come within
    a chunk of the capacity, so the batcher falls back to the scatter chunk,
    and a slot that finishes inside such a chunk runs on past the capacity,
    its writes dropped. Checks that both happened, the launches (K2 or
    K2-int8 at every decode step), that ``errors`` is empty and the answers
    against chat's (:func:`check_answers`). Returns the launches."""
    n_llm = ref.cfg.llm.num_hidden_layers
    decode_key = "decode_attention_int8" if ref.kv_quantized else "decode_attention"
    b = ContinuousBatcher(ref.model, ref.tokenizer, ref.new_token_ids, 4, SERVE_TIGHT,
                          SERVE_CHUNK, ref.vit_transform, SEED, kv_quantized=ref.kv_quantized)
    budgets = [SERVE_TIGHT - (len(ref.tokenizer.encode(p)) + 2) - 1 - 5 * k
               for k, p in enumerate(SERVE_TEXT[:4])]
    print(f"serving run {run}, near capacity: {len(budgets)} text requests, max_new_tokens "
          f"{budgets}, ContinuousBatcher(num_slots=4, capacity={SERVE_TIGHT}, "
          f"chunk={SERVE_CHUNK}, kv_quantized={ref.kv_quantized})", flush=True)
    got_ids = _recording_ids(b)
    seen = dict(scatter_chunks=0, chunks_past_capacity=0)
    chunk = serving.decode_chunk

    def counted(*args, **kw):
        out = chunk(*args, **kw)
        seen["scatter_chunks"] += 1
        seen["chunks_past_capacity"] += int(out[3].lens.max().item() > SERVE_TIGHT)
        return out

    counter = ForwardCounter(ref.model)
    reset_counts()
    serving.decode_chunk = counted
    try:
        rids = [b.submit(Request(prompt=p, max_new_tokens=n))
                for p, n in zip(SERVE_TEXT[:4], budgets)]
        b.run()
    finally:
        serving.decode_chunk = chunk
        counter.remove()
    launches = check_counts(f"serving run {run} near capacity", {
        "flash_block_attention": counter.prefill * n_llm, decode_key: counter.decode * n_llm})
    print(f"  run {run} near capacity: {json.dumps(dict(seen, stats=b.stats))}", flush=True)
    missing = [r for r in rids if r not in got_ids]
    if b.errors or missing or not seen["scatter_chunks"] or not seen["chunks_past_capacity"]:
        raise SystemExit(f"chip_smoke: serving run {run} near capacity: errors {b.errors}, "
                         f"unanswered {missing}, {seen}")
    del b
    torch.cuda.empty_cache()
    check_answers(f"{run} near capacity", ref, [(rid, None, p) for rid, p in
                                               zip(rids, SERVE_TEXT[:4])], got_ids, budgets,
                  gap_limit)
    return launches


def run_serving_phase(inf: InterleaveInferencer) -> list:
    """Runs A (bf16 weights and pool), B (bf16 weights, int8 pool), C
    (w4a8 per channel, fused, int8 pool) and D (B's, decoded speculatively:
    SPEC_K drafts a verify forward, no ladder) on the smoke's model, A's and
    B's pools also near capacity; after A, run E (unified text and image
    serving) and the HTTP front end. The batcher waits for the card at the end of
    each phase of a round (UNIMEDVL_SERVING_PROFILE), so that ``stats`` splits
    device work. Returns their launches."""
    os.environ["UNIMEDVL_SERVING_PROFILE"] = "1"
    try:
        int8_pool = InterleaveInferencer(inf.model, inf.tokenizer, inf.new_token_ids,
                                         vit_transform=inf.vit_transform, seed=SEED,
                                         kv_quantized=True)
        launches = []
        for name, ref, run in (("bf16 weights, bf16 pool", inf, "A"),
                               ("bf16 weights, int8 pool", int8_pool, "B")):
            main, gap_limit = run_serving(name, ref, run, 4, 0, 0, warm=True)
            GAP_LIMITS[run] = gap_limit
            launches += [main, run_near_capacity(run, ref, gap_limit)]
            if run == "A":
                launches += [run_unified_serving(inf, gap_limit), run_http(inf)]
        w4a8 = quantized_inferencer(inf, bits=4, act_quant=True)
        launches.append(run_serving("w4a8 per channel, fused, int8 pool", w4a8, "C", 2, 1, 4)[0])
        del w4a8
        torch.cuda.empty_cache()
        launches.append(run_serving("bf16 weights, int8 pool, speculative", int8_pool, "D",
                                    SERVE_SLOTS, 0, 0, spec=True)[0])
        del int8_pool
    finally:
        os.environ.pop("UNIMEDVL_SERVING_PROFILE")
    # the serving runs' admission blocks, pool-keyed chunk programs and their graphs'
    # share of the pool: no later phase replays them
    programs.drop_all()
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# -- unified text and image serving (M10b) -----------------------------------------------------
GEN_CHUNK, GEN_GROUP = 10, 4  # the batcher's defaults
T2I_REQUESTS = [(GEN_SIZE, p) for p in (
    GEN_PROMPT, "An axial CT slice of the abdomen with a renal cyst.",
    "A T2-weighted brain MRI with a small frontal lesion.", "A frontal chest radiograph, normal.",
)] + [((256, 256), p) for p in (
    "A lateral knee radiograph.", "A hand radiograph with a healed fracture.",
    "An ultrasound of the gallbladder with a stone.", "A sagittal lumbar spine MRI.",
)]


def t2i_lens(prompt: str) -> int:
    """A text-to-image request's context length: bos + the prompt + eos."""
    return len(prompt.encode("utf-8")) + 2


def check_group_k1b(randn, ints) -> list:
    """K1b at the grouped denoise steps of run E (H 28 / Hk 4, D 128,
    non-causal, the block behind a 512-column context cache): S 12 = 4
    images x 3 streams at T 1026 (512 px) and T 258 (256 px), lens as
    ``_start_gen`` leaves them (the prompt for the main and cfg_img streams, 0
    for cfg_text), and S 4, T 1026 (the 1-stream steps of four images).
    Each row: kernel against plain on every row, the bound from this data's
    visible pairs, and SDPA's time on the same mask with q pre-processed
    outside (no PyTorch call norms and rotates q inside attention)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    lens512 = [t2i_lens(p) for (size, p) in T2I_REQUESTS if size == GEN_SIZE]
    lens256 = [t2i_lens(p) for (size, p) in T2I_REQUESTS if size != GEN_SIZE]
    cases = []
    for name, T, lens in (
            ("4 images x 3 streams, 512 px", 1026, [x for n in lens512 for x in (n, 0, n)]),
            ("4 images x 3 streams, 256 px", 258, [x for n in lens256 for x in (n, 0, n)]),
            ("4 images x 1 stream, 512 px", 1026, lens512)):
        S, cap = len(lens), 512
        M = cap + T
        q = randn(S, T, 28, 128, scale=2.0)
        kc, vc = randn(S, 4, M, 128), randn(S, 4, M, 128)
        ln, bs = ints(*lens), ints(*[cap] * S)
        cos, sin = rope_cos_sin(torch.full((S, 1), 57, device="cuda"), 128, 1e6)
        w = [(1 + 0.1 * torch.randn(128, generator=g, device="cuda")).to(torch.bfloat16)
             for _ in range(2)]
        qp = dict(w_und=w[0], w_gen=w[1], cos=cos, sin=sin, end_row=None, eps=1e-6)
        r = _compare(f"K1b grouped denoise, {name}: S={S} T={T} M={M}",
                     lambda: fa.flash_block_attention(q, kc, vc, ln, bs, False, None, True,
                                                      q_preproc=qp),
                     lambda: fa.flash_block_attention_ref(q, kc, vc, ln, bs, False, None, True,
                                                          q_preproc=qp), T, back_to_back=False)
        r.update(attention_bound([T] * S, [n + T for n in lens], 28, 4, 128, 2, "bf16"))
        per = fa._launch.per_stream
        mask = fa._visibility_mask(T, M, ln, bs, per(T, S, q.device), False, q.device)
        r["library_ms"] = sdpa_ms(fa.preprocess_q(q, qp), kc, vc, mask)
        print(f"    bound {r['bound_ms']:.4f} ms by {r['bound_by']}; SDPA on q pre-processed "
              f"outside, same mask {r['library_ms']:.3f} ms", flush=True)
        r.pop("ms_back_to_back")
        cases.append(dict(case=f"{name}: S={S} T={T} M={M}, lens {min(lens)}-{max(lens)}", **r))
    return cases


def _unified_text_workload():
    """Run E's 12 text and image requests, from run A's: two of each image
    size (980x980, 378x532, 378x378) and six text prompts, without the
    preamble, as (image array or None, prompt)."""
    first, later = serving_workload("A")
    images = [first[i] for i in (0, 1, 4, 5, 8, 9)]
    return [(a, p) for a, p, _pre in images] + [(None, p) for p in SERVE_TEXT[:6]]


def _t2i_contexts(inf: InterleaveInferencer, prompt: str):
    """The batcher's text-to-image context recipe (``ContinuousBatcher._start_gen``)."""
    g = inf.init_gen_context()
    ci, ct = g.fork(), g.fork()
    return inf.update_context_text(prompt, g), ct, inf.update_context_text(prompt, ci)


def _timed(store: dict, key_fn, fn):
    """``fn`` wrapped to add its synchronised seconds to ``store[key_fn(args)]``."""
    def call(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        key = key_fn(*args, **kw)
        store[key] = store.get(key, 0.0) + time.perf_counter() - t0
        return out
    return call


def run_unified_serving(inf: InterleaveInferencer, gap_limit: float) -> dict:
    """Run E, unified serving at the full width: ``ContinuousBatcher``
    (pool of 16 x 6144, chunks of 16, ``pipeline=inf``, ``gen_chunk`` 10,
    ``gen_group`` 4) serving 12 of run A's text and image requests and eight
    text-to-image requests at the batcher's defaults (50 timesteps, CFG text
    3.0 and image 1.5 on (0.4, 1.0]): four 512x512 and four 256x256, two
    groups. The same 12 text requests run alone first, on an engine without
    a pipeline. Checks the launches against the forwards (K1b at every
    denoise forward x 28), that every request was answered with ``errors``
    empty, the text answers against chat's (:func:`check_answers`, run A's
    near-tie limit) and each image's final latent against the one-shot
    ``gen_image_latent`` of the same request, the generator replayed to the
    same draw (cosine at VELOCITY_COS_TOL: cuBLAS picks algorithms by row
    count, so a group is not bit-equal). Prints the text emitted tok/s alone
    and with the images in flight, ``gen_s``, s/image per geometry and the ms
    per grouped denoise step at G 4 against G 1. Returns the launches."""
    n_vit, n_llm = inf.cfg.vit.num_hidden_layers, inf.cfg.llm.num_hidden_layers
    text = _unified_text_workload()

    def engine(pipeline=None):
        return ContinuousBatcher(inf.model, inf.tokenizer, inf.new_token_ids, SERVE_SLOTS,
                                 SERVE_CAPACITY, SERVE_CHUNK, inf.vit_transform, SEED,
                                 pipeline=pipeline, gen_chunk=GEN_CHUNK, gen_group=GEN_GROUP)

    def submit_text(b):
        return [b.submit(Request(prompt=p, image=None if a is None else _pil_image(a),
                                 max_new_tokens=SERVE_MAX_NEW)) for a, p in text]

    print(f"serving run E (unified): {len(text)} text and image requests and "
          f"{len(T2I_REQUESTS)} text-to-image requests (4 x 512x512, 4 x 256x256, 50 "
          f"timesteps), ContinuousBatcher(num_slots={SERVE_SLOTS}, capacity={SERVE_CAPACITY}, "
          f"chunk={SERVE_CHUNK}, pipeline=..., gen_chunk={GEN_CHUNK}, gen_group={GEN_GROUP})",
          flush=True)
    warm = engine(inf)  # first uses of the shapes and the VAE decode, not counted
    warm.submit(Request(prompt="warm-up", max_new_tokens=2))
    warm.submit(Request(prompt="warm-up", image_size=(256, 256), gen_params=dict(
        num_timesteps=3)))
    warm.run()
    del warm
    b = engine()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    submit_text(b)
    b.run()
    torch.cuda.synchronize()
    alone_s = time.perf_counter() - t0
    alone_tok_s = b.stats["emitted_tokens"] / alone_s
    del b

    b = engine(inf)
    eos = b.new_token_ids["eos_token_id"]
    got_ids = _recording_ids(b)
    latents, spent = {}, {}
    finish_group = inf.finish_gen_job_group

    def record(job):
        x = job.x_t if job.x_t.dim() == 3 else job.x_t[None]
        for rid, xg in zip(b._gen_job[0], x):
            latents[rid] = xg.clone()
        return finish_group(job)

    geometry = lambda job, *a, **k: job.image_shape  # noqa: E731
    inf.finish_gen_job_group = _timed(spent, geometry, record)
    inf.advance_gen_job = _timed(spent, geometry, inf.advance_gen_job)
    b._start_gen = _timed(spent, lambda req: req.image_size, b._start_gen)
    gen_state = inf._generator.get_state()
    counter = ForwardCounter(inf.model)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        rids = submit_text(b)
        img_rids = [b.submit(Request(prompt=p, image_size=hw)) for hw, p in T2I_REQUESTS]
        st = b._reset_stats()
        text_s, gen_rounds = None, 0
        while b.has_work():
            gen_rounds += b._gen_job is not None
            b._round(st, eos)
            if text_s is None and all(r in b._done or r in b.errors for r in rids):
                text_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        counter.remove()
        for name in ("finish_gen_job_group", "advance_gen_job"):
            del inf.__dict__[name]
    launches = check_counts("serving run E (unified)", {
        "flash_block_attention": counter.vit * n_vit + counter.prefill * n_llm,
        "flash_block_attention_q_preproc": counter.denoise * n_llm,
        "decode_attention": counter.decode * n_llm,
    })
    out = dict(b._done)
    bad = [r for r in rids if not isinstance(out.get(r), str)] + [
        r for r, (hw, _p) in zip(img_rids, T2I_REQUESTS)
        if getattr(out.get(r), "size", None) != hw[::-1]]
    if b.errors or bad:
        raise SystemExit(f"chip_smoke: serving run E: errors {b.errors}, unanswered {bad}")
    n_img = {hw: sum(h == hw for h, _p in T2I_REQUESTS) for hw, _p in T2I_REQUESTS}
    row = dict(card=CARD, seconds=seconds, text_s=text_s,
               text_emitted_tokens=st["emitted_tokens"],
               text_emitted_tok_s_with_t2i=st["emitted_tokens"] / text_s,
               text_emitted_tok_s_alone=alone_tok_s, alone_s=alone_s,
               stats={k: st[k] for k in ("rounds", "admit_s", "gen_s", "decode_s", "host_s",
                                         "round_s", "gen_images", "emitted_tokens")},
               s_per_image={f"{h}x{w}": spent[(h, w)] / n for (h, w), n in n_img.items()},
               gen_rounds=gen_rounds, denoise_forwards=counter.denoise,
               decode_forwards=counter.decode, prefill_forwards=counter.prefill,
               vit_forwards=counter.vit)
    print(f"  run E: {json.dumps(row)}", flush=True)
    check_answers("E", inf, [(rid, a, p) for rid, (a, p) in zip(rids, text)], got_ids,
                  SERVE_MAX_NEW, gap_limit)
    # each image against the one-shot path on the same draw of the generator
    inf._generator.set_state(gen_state)
    for rid, (hw, p) in zip(img_rids, T2I_REQUESTS):
        g_ctx, ct, ci = _t2i_contexts(inf, p)
        want = inf.gen_image_latent(hw, g_ctx, cfg_text_precontext=ct, cfg_img_precontext=ci,
                                    cfg_text_scale=3.0)
        got = latents[rid]
        cos, finite = _cosine(got, want), bool(torch.isfinite(got).all())
        print(f"  run E image {hw[0]}x{hw[1]} {p[:32]!r}: final latent vs the one-shot "
              f"gen_image_latent: cosine {cos:.6f}, max abs {(got - want).abs().max().item():.4f} "
              f"(latent std {want.std().item():.3f}), finite {finite}", flush=True)
        if not finite or got.shape != want.shape or cos < VELOCITY_COS_TOL:
            raise SystemExit("chip_smoke: run E's image disagrees with the one-shot path")
    time_grouped_steps(inf, b)
    del b
    torch.cuda.empty_cache()
    return launches


def time_grouped_steps(inf: InterleaveInferencer, b: ContinuousBatcher) -> None:
    """ms per denoise step of four images in one forward (G 4) against one
    image (G 1), at each of run E's geometries, for a 3-stream step (step 0,
    CFG on) and a 1-stream step (step 48, outside the interval)."""
    se = inf._start_end()
    rows = {}
    for hw in dict.fromkeys(hw for hw, _p in T2I_REQUESTS):
        jobs = [b._start_gen(Request(prompt=p, image_size=hw)) for h, p in T2I_REQUESTS
                if h == hw]
        grouped = inf.merge_gen_jobs(jobs)
        for step, kind in ((0, "3-stream"), (48, "1-stream")):
            ms = {}
            for G, j in ((4, grouped), (1, jobs[0])):
                fn = bagel.generate_latents_group if G > 1 else bagel.generate_latents
                ms[G] = cuda_ms(lambda: fn(inf.model, j.caches, j.positions, j.pos_ids, j.x_t,
                                           se, step_range=(step, step + 1), **j.kw),
                                warmup=1, iters=5)
            rows[f"{hw[0]}x{hw[1]} {kind}"] = dict(g4_ms=ms[4], g1_ms=ms[1],
                                                    g4_per_image_ms=ms[4] / 4)
    print(f"  run E, ms per denoise step, four images in one forward (G 4) vs one (G 1): "
          f"{json.dumps(dict(card=CARD, steps=rows))}", flush=True)


def _http(base: str, path: str, payload=None):
    """(status, JSON body) of a GET (no payload) or POST to the local server."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data, method="GET" if data is None else "POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def run_http(inf: InterleaveInferencer) -> dict:
    """The HTTP front end in this process (``ServingDaemon`` on its thread,
    ``make_server`` on 127.0.0.1, an ephemeral port) over an engine with
    ``pipeline=inf`` (pool 4 x 2048): one /v1/generate with the 378x378
    image as PNG, whose answer must equal the engine's for the same request
    run alone; one /v1/images at 512x512 (a PNG of that size, finite and not
    flat); /v1/health. Checks the launches. Returns them."""
    import base64
    import io
    import threading

    from unimedvl_tpu_torch.inference.server import ServingDaemon, make_server

    n_vit, n_llm = inf.cfg.vit.num_hidden_layers, inf.cfg.llm.num_hidden_layers
    h, w, prompt = REQUESTS[2]
    image = _images()[2]

    def engine():
        return ContinuousBatcher(inf.model, inf.tokenizer, inf.new_token_ids, 4, 2048,
                                 SERVE_CHUNK, inf.vit_transform, SEED, pipeline=inf,
                                 gen_chunk=GEN_CHUNK, gen_group=GEN_GROUP)

    ref = engine()
    rid = ref.submit(Request(prompt=prompt, image=_pil_image(image), max_new_tokens=SERVE_MAX_NEW))
    want = ref.run()[rid]
    del ref
    buf = io.BytesIO()
    _pil_image(image).save(buf, format="PNG")
    print("HTTP front end: ServingDaemon + make_server on 127.0.0.1 (ephemeral port), an engine "
          "with pipeline=..., pool 4 x 2048", flush=True)
    counter = ForwardCounter(inf.model)
    reset_counts()
    daemon = ServingDaemon(engine()).start()
    server = make_server(daemon, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        t0 = time.perf_counter()
        code, text = _http(base, "/v1/generate", {
            "prompt": prompt, "max_new_tokens": SERVE_MAX_NEW,
            "image_png_b64": base64.b64encode(buf.getvalue()).decode()})
        t1 = time.perf_counter()
        code_img, img = _http(base, "/v1/images", {"prompt": GEN_PROMPT, "height": GEN_SIZE[0],
                                                   "width": GEN_SIZE[1]})
        t2 = time.perf_counter()
        code_h, health = _http(base, "/v1/health")
    finally:
        server.shutdown()
        server.server_close()
        daemon.stop()
        thread.join(timeout=30)
        counter.remove()
    launches = check_counts("the HTTP front end", {
        "flash_block_attention": counter.vit * n_vit + counter.prefill * n_llm,
        "flash_block_attention_q_preproc": counter.denoise * n_llm,
        "decode_attention": counter.decode * n_llm,
    })
    from PIL import Image

    pixels = np.zeros((0,), np.uint8)
    if code_img == 200:
        pixels = np.asarray(Image.open(io.BytesIO(base64.b64decode(img["image_png_b64"]))))
    print(f"  /v1/generate ({h}x{w} PNG): {code}, {t1 - t0:.2f} s, answer equals the engine's: "
          f"{text.get('text') == want}; /v1/images {GEN_SIZE[0]}x{GEN_SIZE[1]}: {code_img}, "
          f"{t2 - t1:.2f} s, shape {pixels.shape}, std {float(pixels.std()) if pixels.size else 0:.3f}"
          f"; /v1/health: {code_h}, stats {json.dumps(health.get('stats'))}", flush=True)
    if (code != 200 or text.get("text") != want or code_img != 200
            or pixels.shape != (*GEN_SIZE, 3) or not pixels.std() > 0
            or code_h != 200 or health.get("ok") is not True):
        raise SystemExit("chip_smoke: the HTTP front end failed")
    return launches


# -- speculative decoding (M9) ------------------------------------------------------------------
SPEC_K, SPEC_NGRAM = 7, 3
SPEC_LENGTH = 128  # the floor / ceiling request's answer length
SPEC_TURN = "Now describe the right lung in one sentence."


def check_spec_k1a(randn, ints) -> list:
    """K1a at the verify block's shapes: T = SPEC_K + 1 causal rows per
    stream after its context, at S 1 with lens 800 (M 1024: a 378 px chat)
    and 5000 (M 5632: a 980 px chat), and at S 16 over run A's pool lens (M
    6144: run D); the rows of ``flash_block_attention.spec_cases``."""
    T = SPEC_K + 1
    cases = []
    for S, lens, M in ((1, (800,), 1024), (1, (5000,), 5632), (16, SERVE_LENS, SERVE_CAPACITY)):
        kc, vc = randn(S, 4, M, 128), randn(S, 4, M, 128)
        ln = ints(*lens)
        cases.append(_k1a_case(
            f"K1a verify S={S} T={T} M={M} causal, lens {min(lens)}-{max(lens)}",
            randn(S, T, 28, 128, scale=2.0), kc, vc, ln, ln, True, ints(*[T] * S)))
    return cases


def spec_inferencer(inf: InterleaveInferencer) -> InterleaveInferencer:
    """An inferencer over ``inf``'s model and cache kind that decodes greedy
    answers speculatively."""
    return InterleaveInferencer(inf.model, inf.tokenizer, inf.new_token_ids,
                                vit_transform=inf.vit_transform, seed=SEED,
                                kv_quantized=inf.kv_quantized, spec_decode=True, spec_k=SPEC_K,
                                spec_ngram=SPEC_NGRAM)


def _context(inf: InterleaveInferencer, image, prompt: str):
    ctx = inf.init_gen_context()
    if image is not None:
        ctx = inf.update_context_image(image, ctx, vae=False)
    return inf.update_context_text(prompt, ctx)


def spec_gap_limit(name: str, plain: InterleaveInferencer, spec: InterleaveInferencer,
                   requests) -> float:
    """Row 0 of the first verify forward against chat's first decode step,
    per (image, prompt) request, at LOGITS_COS_TOL: K1a over T = SPEC_K + 1
    rows against K2 (or K2-int8) over one. Returns NEAR_TIE_FACTOR times the
    largest |logit difference|, the answers' near-tie gate."""
    worst = 0.0
    for image, prompt in requests:
        ctx = spec._ensure_capacity(_context(spec, image, prompt), SPEC_K + 1)
        dev = spec.device
        got = _verify_row0_logits(
            spec.model, ctx.cache, torch.tensor([spec.new_token_ids["bos_token_id"]], device=dev),
            torch.tensor([ctx.rope], device=dev), torch.ones(1, dtype=torch.bool, device=dev))[0]
        want = _first_step_logits(plain, image, prompt)
        cos = torch.nn.functional.cosine_similarity(got, want, dim=0).item()
        diff = (got - want).abs().max().item()
        worst = max(worst, diff)
        what = "text" if image is None else "x".join(map(str, image.shape[:2]))
        print(f"  {name} {what}: first verify row's logits vs chat's first step: cosine "
              f"{cos:.6f}, max abs {diff:.4f}, argmax {got.argmax().item()} vs "
              f"{want.argmax().item()}", flush=True)
        if not bool(torch.isfinite(got).all()) or cos < LOGITS_COS_TOL:
            raise SystemExit(f"chip_smoke: {name}: the verify forward's logits disagree with "
                             "chat's")
    return NEAR_TIE_FACTOR * worst


def _answer_ids(out: torch.Tensor) -> list:
    return [t for t in out[0].tolist() if t >= 0]


def _expected(counter: ForwardCounter, n_vit: int, n_llm: int, kv_int8: bool, k3: int,
              k4: int) -> dict:
    """The launches that the forwards ``counter`` saw must show."""
    forwards = counter.decode + counter.prefill
    return {"flash_block_attention": counter.vit * n_vit + counter.prefill * n_llm,
            "decode_attention_int8" if kv_int8 else "decode_attention": counter.decode * n_llm,
            "silu_mul_quant": forwards * n_llm * k3, "w4_matmul": forwards * n_llm * k4}


def run_spec_chat(plain: InterleaveInferencer, spec: InterleaveInferencer) -> tuple:
    """The three chat requests through ``spec.chat`` at MAX_LENGTH by the
    captured spec program (a warm-up request captures the 378x378 shape
    first), the verify forwards and each request's fix-up forward counted,
    the answers gated against plain chat's; then the 378x378 request once
    more on the eager loop: its tokens and verify forwards must be the
    graphed ones. Prints ms per verify forward (the decode call over its
    forwards, the fix-up one counted) and tok/s both ways. Returns (the
    graphed launches, the gap limit)."""
    n_vit, n_llm = plain.cfg.vit.num_hidden_layers, plain.cfg.llm.num_hidden_layers
    images = _images()
    requests = [(images[i], REQUESTS[i][2]) for i in range(len(REQUESTS))]
    gap_limit = spec_gap_limit("spec chat", plain, spec, requests)
    spec.chat([images[2]], REQUESTS[2][2], max_length=MAX_LENGTH)  # warm-up: its capture
    calls, rows = [], {}

    def row(route, out, dt):
        ids, n_fwd = _answer_ids(out[0]), int(out[3])
        return ids, n_fwd, dict(route=route, tokens=len(ids) - 1, verify_forwards=n_fwd,
                                tokens_per_forward=(len(ids) - 1) / n_fwd,
                                ms_per_verify_forward=1e3 * dt / (n_fwd + 1),
                                decode_tok_s=(len(ids) - 1) / dt)

    counter = ForwardCounter(spec.model)
    reset_counts()
    try:
        with _recording("generate_text_spec", calls):
            for image, prompt in requests:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                spec.chat([image], prompt, max_length=MAX_LENGTH)
                torch.cuda.synchronize()
                ids, n_fwd, r = row("graphed", *calls[-1])
                print(f"  spec chat {'x'.join(map(str, image.shape[:2]))}: {json.dumps(r)}, "
                      f"{time.perf_counter() - t0:.3f} s with the image and text prefills",
                      flush=True)
    finally:
        counter.remove()
    launches = check_counts("the spec chat path", _expected(counter, n_vit, n_llm, False, 0, 0))
    check_answers("spec chat", plain, [(i, image, prompt) for i, (image, prompt)
                                       in enumerate(requests)],
                  {i: row("graphed", *c)[0] for i, c in enumerate(calls)}, MAX_LENGTH, gap_limit)
    rows["graphed"] = row("graphed", *calls[2])
    spec.graphs = False
    try:
        with _recording("generate_text_spec", calls):
            spec.chat([images[2]], REQUESTS[2][2], max_length=MAX_LENGTH)
    finally:
        spec.graphs = None
    rows["eager"] = row("eager", *calls[-1])
    same = rows["graphed"][:2] == rows["eager"][:2]
    print(f"  spec chat 378x378, graphed vs eager ({CARD}): "
          f"{json.dumps([rows['graphed'][2], rows['eager'][2]])}; tokens and verify forwards "
          f"equal: {same}", flush=True)
    if not same:
        raise SystemExit("chip_smoke: the spec program's tokens or verify forwards differ from "
                         "the eager loop's")
    return launches, gap_limit


def _fixed_drafts(table: list, start, device):
    """A stand-in for ``bagel.propose_drafts`` that drafts ``table``'s ids
    from column ``start(hlen)`` on (clipped to its end) instead of looking
    them up; a few device ops, no host read."""
    ids = torch.tensor(table, dtype=torch.int32, device=device)

    def propose(hist, hlen, ngram, K):
        col = start(hlen.to(torch.int64))[:, None] + torch.arange(K, device=device)
        return ids[col.clamp(0, len(table) - 1)]
    return propose


def spec_floor_ceiling(name: str, plain: InterleaveInferencer, gap_limit: float,
                       labels, k3: int, k4: int) -> tuple:
    """The 378x378 request at SPEC_LENGTH tokens, on one context: the plain
    aligned decode, then ``generate_text_spec`` with the drafts of each of
    ``labels``: "junk history" (the lookup over random ids) and "planted"
    (over the plain answer planted before the real history, as
    benchmarks/spec_decode_bench.py plants it) keep the lookup, which also
    finds the answer's own repeats: a random model's answer repeats itself,
    and the latest match wins, so neither is a pure floor or ceiling. "junk
    drafts" (random ids in place of the lookup: the floor) and "oracle
    drafts" (the plain answer's next SPEC_K tokens: the ceiling) replace
    ``bagel.propose_drafts``. Each decode runs as its captured program,
    timed after an untimed call that captures it (a stand-in proposer
    captures a program of its own). For each: decode tok/s (answer tokens
    after the start token over the decode call), tokens per verify forward,
    forwards and ms per forward (the fix-up forward counted); the launches
    checked and the answers gated against chat's. Returns (the launches
    added up, the rows)."""
    n_vit, n_llm = plain.cfg.vit.num_hidden_layers, plain.cfg.llm.num_hidden_layers
    _h, _w, prompt = REQUESTS[2]
    image = _images()[2]
    model = plain.model
    ctx = plain._ensure_capacity(_context(plain, image, prompt), SPEC_LENGTH + SPEC_K + 1)
    bos, eos = plain.new_token_ids["bos_token_id"], plain.new_token_ids["eos_token_id"]
    dev = plain.device
    start = torch.tensor([bos], device=dev)
    positions = torch.tensor([ctx.rope], device=dev)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # both decodes by their default route, the captured programs; their captures untimed
    bagel.generate_text(model, ctx.cache, start, positions, SPEC_LENGTH, eos)
    (out, lengths), dt = timed(lambda: bagel.generate_text(
        model, ctx.cache, start, positions, SPEC_LENGTH, eos))
    plain_ids = _answer_ids(out)
    n = len(plain_ids)
    rows = {"plain": dict(tokens=n, decode_tok_s=(n - 1) / dt, forwards=n, tokens_per_forward=1.0,
                          ms_per_forward=1e3 * dt / n)}
    real = list(ctx.hist) + [bos]
    junk = np.random.default_rng(SEED + 13).integers(0, plain.cfg.llm.vocab_size,
                                                     len(real) + SPEC_LENGTH).tolist()
    hlen0 = len(real)
    runs = {  # label: (history, the stand-in for propose_drafts or None)
        "junk history": (junk[:len(real) - 1] + [bos], None),
        "planted": (real[-SPEC_NGRAM:] + plain_ids[1:] + real, None),
        "junk drafts": (real, _fixed_drafts(junk, lambda hlen: hlen, dev)),
        "oracle drafts": (real, _fixed_drafts(plain_ids[1:], lambda hlen: hlen - hlen0, dev)),
    }
    got, total = {}, {}
    lookup = bagel.propose_drafts
    for label in labels:
        hist, drafts = runs[label]
        HL = -(-(len(hist) + SPEC_LENGTH + SPEC_K) // 256) * 256
        row = torch.zeros((1, HL), dtype=torch.int32)
        row[0, :len(hist)] = torch.tensor(hist, dtype=torch.int32)
        row = row.to(dev)
        hlen = torch.tensor([len(hist)], dtype=torch.int32, device=dev)
        bagel.propose_drafts = drafts or lookup  # a stand-in captures a program of its own

        def decode():
            return bagel.generate_text_spec(model, ctx.cache, start, positions, SPEC_LENGTH, eos,
                                            row, hlen, k_draft=SPEC_K, ngram=SPEC_NGRAM)

        try:
            decode()  # the capture
            counter = ForwardCounter(model)
            reset_counts()
            try:
                (out, _lengths, _cache, n_fwd), dt = timed(decode)
            finally:
                counter.remove()
        finally:
            bagel.propose_drafts = lookup
        n_fwd = int(n_fwd)
        launches = check_counts(f"the {name} spec decode, {label}",
                                _expected(counter, n_vit, n_llm, plain.kv_quantized, k3, k4))
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        got[label] = _answer_ids(out)
        n = len(got[label])
        rows[label] = dict(tokens=n, decode_tok_s=(n - 1) / dt, forwards=n_fwd,
                           tokens_per_forward=(n - 1) / n_fwd,
                           ms_per_forward=1e3 * dt / (n_fwd + 1))
    print(f"  {name}, 378x378 at {SPEC_LENGTH} tokens ({CARD}): {json.dumps(rows)}", flush=True)
    check_answers(f"{name} spec floor/ceiling", plain, [(label, image, prompt) for label in got],
                  got, SPEC_LENGTH, gap_limit)
    if "oracle drafts" in rows and rows["oracle drafts"]["tokens_per_forward"] <= 1.0:
        raise SystemExit(f"chip_smoke: {name}: the oracle drafts were not accepted")
    return total, rows


def run_chat_turns(plain: InterleaveInferencer, spec: InterleaveInferencer,
                   gap_limit: float) -> None:
    """Two ``chat_turn``s of ``spec``: the 378x378 request, then a text
    question, by the captured spec program, then again on the eager loop:
    the kept ids and each turn's verify forwards must be equal. The second
    turn's first forward must prefill its own text only, at the rope
    position after the kept answer; each answer is gated against the plain
    ``chat_turn`` on the same context."""
    image = _images()[2]
    p1, p2 = REQUESTS[2][2], SPEC_TURN

    def reference(fn):
        return _greedy_steps(plain, fn, MAX_LENGTH)

    refs = {p1: reference(lambda: plain.chat_turn(None, p1, images=[image],
                                                  max_length=MAX_LENGTH))}
    turns = {}
    for route, graphs in (("graphed", None), ("eager", False)):
        spec.graphs = graphs
        calls, first = [], []
        try:
            with _recording("generate_text_spec", calls):
                a1, ctx1 = spec.chat_turn(None, p1, images=[image], max_length=MAX_LENGTH)
                # turn 2's text prefill, by either route (its program runs no forward hook)
                prefill = bagel.prefill_text

                def recorded(model, cache, ids, pos, valid, **kw):
                    first.append((int(pos[0, 0]), ids.shape[1], int(valid.sum())))
                    return prefill(model, cache, ids, pos, valid, **kw)

                bagel.prefill_text = recorded
                try:
                    a2, ctx2 = spec.chat_turn(ctx1, p2, max_length=MAX_LENGTH)
                finally:
                    bagel.prefill_text = prefill
        finally:
            spec.graphs = None
        turns[route] = (ctx2.hist, [int(out[3]) for out, _dt in calls],
                        [1e3 * dt / (int(out[3]) + 1) for out, dt in calls])
        if route == "graphed":
            refs[p2] = reference(lambda: plain.chat_turn(ctx1, p2, max_length=MAX_LENGTH))
            n2 = len(spec._encode_prompt(p2))
            print(f"  chat_turn: turn 1 kept {ctx1.kv_len} columns, turn 2 prefilled "
                  f"{first[0][2]} rows at position {first[0][0]} (its prompt: {n2} ids after rope "
                  f"{ctx1.rope}), kept {ctx2.kv_len}; answers {a1[:40]!r} / {a2[:40]!r}",
                  flush=True)
            if first[0] != (ctx1.rope, max(32, -(-n2 // 32) * 32), n2):
                raise SystemExit("chip_smoke: the second chat_turn prefilled more than its own "
                                 "text")
            ids1 = list(ctx1.hist[len(spec._encode_prompt(p1)):])
            ids2 = list(ctx2.hist[len(ctx1.hist) + n2:])
    same = turns["graphed"][:2] == turns["eager"][:2]
    print(f"  spec chat_turns, graphed vs eager ({CARD}): verify forwards "
          f"{turns['graphed'][1]} / {turns['eager'][1]}, ms per verify forward "
          f"{[round(x, 3) for x in turns['graphed'][2]]} / "
          f"{[round(x, 3) for x in turns['eager'][2]]}; kept ids and forwards equal: {same}",
          flush=True)
    if not same:
        raise SystemExit("chip_smoke: the spec chat_turns differ between the program and the "
                         "eager loop")
    check_answers("spec chat_turn", plain, [(1, image, p1), (2, None, p2)], {1: ids1, 2: ids2},
                  MAX_LENGTH, gap_limit, reference=lambda _image, prompt, _b: refs[prompt])


def run_spec_stream(spec: InterleaveInferencer) -> None:
    """One ``gen_text_stream`` of ``spec`` (chunks of 8 verify forwards, the
    spec chunk's program over buffers of the cache's shape): its pieces must
    concatenate to ``spec.gen_text``'s answer."""
    image = _images()[2]
    ctx = _context(spec, image, REQUESTS[2][2])
    pieces = list(spec.gen_text_stream(ctx, max_length=MAX_LENGTH, chunk=8))
    answer = spec.gen_text(ctx, max_length=MAX_LENGTH)
    print(f"  gen_text_stream: {len(pieces)} pieces, joined equal to gen_text's answer: "
          f"{''.join(pieces) == answer}", flush=True)
    if "".join(pieces) != answer:
        raise SystemExit("chip_smoke: the spec stream's pieces differ from gen_text's answer")


def run_spec_phase(inf: InterleaveInferencer) -> list:
    """Speculative decoding at the full width (SPEC_K drafts, SPEC_NGRAM):
    bf16 spec chat on the three requests, the 378x378 request at
    SPEC_LENGTH tokens plain and with four draft sources
    (:func:`spec_floor_ceiling`), planted and oracle drafts again in w4a8 per
    channel (K4's int8 GEMM and K3 at m 8), two ``chat_turn``s and one
    ``gen_text_stream`` (serving run D runs in :func:`run_serving_phase`).
    Returns the launches of each path."""
    n_vit, n_llm = inf.cfg.vit.num_hidden_layers, inf.cfg.llm.num_hidden_layers
    spec = spec_inferencer(inf)
    print(f"spec decode path: InterleaveInferencer(spec_decode=True, spec_k={SPEC_K}, "
          f"spec_ngram={SPEC_NGRAM}), 3 chat requests at max_length {MAX_LENGTH}", flush=True)
    chat_launches, gap_limit = run_spec_chat(inf, spec)
    paths = [chat_launches]
    print(f"spec decode, 378x378 request at {SPEC_LENGTH} tokens: plain; the lookup over a junk "
          "history and over the plain answer planted; junk and oracle drafts in its place",
          flush=True)
    paths.append(spec_floor_ceiling("bf16", inf, gap_limit, (
        "junk history", "planted", "junk drafts", "oracle drafts"), 0, 0)[0])
    print("spec decode, w4a8 per channel + fused + int8 KV: planted and oracle drafts",
          flush=True)
    w4a8 = quantized_inferencer(inf, bits=4, act_quant=True)
    w4a8_gap = spec_gap_limit("w4a8 spec", w4a8, spec_inferencer(w4a8), [(_images()[2],
                                                                          REQUESTS[2][2])])
    paths.append(spec_floor_ceiling("w4a8 per channel", w4a8, w4a8_gap,
                                    ("planted", "oracle drafts"), 1, 4)[0])
    del w4a8
    torch.cuda.empty_cache()
    print("spec decode: two chat_turns and a gen_text_stream", flush=True)
    counter = ForwardCounter(inf.model)
    reset_counts()
    try:
        run_chat_turns(inf, spec, gap_limit)
        run_spec_stream(spec)
    finally:
        counter.remove()
    paths.append(check_counts("the chat_turn and stream calls",
                              _expected(counter, n_vit, n_llm, False, 0, 0)))
    print(f"  graphs captured so far {programs.stats['captures']}, the graph pool at most "
          f"{programs.stats['pool_bytes_max']} bytes, now {programs.pool_bytes()}, "
          f"{len(programs.programs())} programs kept ({CARD})", flush=True)
    return paths


# further numbers a kernel's row of the ``kernels`` line carries, where it has them
# -- batched VQA eval (M11), with the int4 KV cache -----------------------------------------
EVAL_SLOTS, EVAL_CAPACITY, EVAL_MAX_NEW = 16, 6144, 32
GAP_LIMITS = {}  # serving run -> its near-tie limit (run_serving_phase)
EVAL_PREDS = {}  # run F's pool -> (its predictions, seconds), for the mesh eval


def eval_requests():
    """Run A's 16 image requests: 4 x 980x980, 4 x 378x532, 8 x 378x378, as
    (image array, question)."""
    first, later = serving_workload("A")
    return [(a, p) for a, p, _pre in first + later if a is not None]


def _chat_answer(inf: InterleaveInferencer, image, prompt: str) -> str:
    """chat's greedy answer text on one request (from :func:`_chat_steps`, so
    a request that run A gated costs nothing more)."""
    ids, _ = _chat_steps(inf, image, prompt, EVAL_MAX_NEW)
    eos = inf.new_token_ids["eos_token_id"]
    return inf._parse([i for i in ids if i != eos])[0]


class _EvalBatcher(ContinuousBatcher):
    """The batcher ``run_vqa_eval`` builds, kept where the smoke can read it:
    its submissions in order (``rids``) and each request's ids as it
    finishes (``ids``)."""

    made = []
    graphs = None  # the route of its decode chunks

    def __init__(self, *args, **kw):
        super().__init__(*args, graphs=type(self).graphs, **kw)
        self.rids, self.ids = [], _recording_ids(self)
        _EvalBatcher.made.append(self)

    def submit(self, req):
        self.rids.append(super().submit(req))
        return self.rids[-1]


class _EagerEvalBatcher(_EvalBatcher):
    """:class:`_EvalBatcher` with the eager decode chunks (``graphs=False``)."""

    graphs = False


def _eval_first_step_logits(inf: InterleaveInferencer, samples, **kv) -> torch.Tensor:
    """The first decode step's logits [16, V] of the eval's engine over
    ``samples`` (all admitted in one round into a pool of the kind ``kv``
    asks for), in sample order."""
    from unimedvl_tpu_torch.eval import vqa

    b = ContinuousBatcher(inf.model, inf.tokenizer, inf.new_token_ids, EVAL_SLOTS,
                          EVAL_CAPACITY, vit_transform=vqa.build_transform(), **kv)
    rids = [b.submit(Request(prompt=s["question"], image=s["image"],
                             max_new_tokens=EVAL_MAX_NEW)) for s in samples]
    b._admit()
    if b.errors or b._pending:
        raise SystemExit(f"chip_smoke: eval run F's admission gave errors {b.errors}")
    logits = _engine_first_step_logits(b, scatter=False)
    slot_of = {s.request_id: i for i, s in enumerate(b.slots[: b.pool])}
    out = logits[[slot_of[r] for r in rids]]
    del b, logits
    torch.cuda.empty_cache()
    return out


def _eager_eval(inf: InterleaveInferencer, samples, kv: dict, name: str,
                graphed: _EvalBatcher) -> dict:
    """``run_vqa_eval`` once more over the same samples and pool on eager
    decode chunks (``graphs=False``): every request's ids must be the graphed
    engine's. Runs outside the counted window (the caller's counters are
    saved and put back). Returns the eager run's seconds and emitted tok/s."""
    from unimedvl_tpu_torch.eval import exact_match_accuracy, vqa

    saved = {name_: dict(c) for name_, (c, _key) in COUNTERS.items()}
    made = serving.ContinuousBatcher
    serving.ContinuousBatcher = _EagerEvalBatcher
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        vqa.run_vqa_eval(inf.model, inf.tokenizer, inf.new_token_ids, samples,
                         max_new_tokens=EVAL_MAX_NEW, num_slots=EVAL_SLOTS,
                         capacity=EVAL_CAPACITY, metric=exact_match_accuracy, **kv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        serving.ContinuousBatcher = made
        for name_, (c, _key) in COUNTERS.items():
            c.update(saved[name_])
    b = _EvalBatcher.made.pop()
    same = sum(graphed.ids.get(r) == b.ids.get(e) for r, e in zip(graphed.rids, b.rids))
    print(f"  run F ({name}): graphed vs eager batcher, requests with equal tokens "
          f"{same}/{len(b.rids)}", flush=True)
    if same != len(b.rids) or len(b.rids) != len(graphed.rids):
        raise SystemExit(f"chip_smoke: eval run F ({name}): the graphed engine's tokens differ "
                         "from the eager engine's")
    return dict(seconds=seconds, emitted_tok_s=b.stats["emitted_tokens"] / seconds,
                admit_s=b.stats["admit_s"])


def run_eval_phase(inf: InterleaveInferencer) -> dict:
    """Run F, the batched VQA eval at the full width: ``eval.run_vqa_eval``
    over run A's 16 image requests (``num_slots=16``, ``capacity=6144``,
    ``max_new_tokens=32``), each sample's answer chat's greedy answer, three
    times: a bf16 pool, an int8 pool, an int4 pool (``kv_bits=4``). Gates:
    the bf16 predictions against chat's (:func:`check_answers`, run A's
    near-tie limit); ``exact_match_accuracy`` at least the share of samples
    with no split; on every sample whose prediction equals chat's answer,
    ``report_metrics`` is what identical texts score (ROUGE-L 1.0 where the
    text has a word; BLEU-3 needs three words, and METEOR's fragmentation
    penalty keeps identity below 1); every run's launches against its
    forwards (K2 in the bf16 run, K2-int8 at every decode step of the int8
    and int4 runs); the first-step logits finite. The int8 and int4 runs'
    first-step logits against the bf16 engine's are printed side by side
    (non-parity modes: no gate), and each run's emitted tok/s, ``stats`` and
    the metrics. Returns the launches."""
    from unimedvl_tpu_torch.eval import exact_match_accuracy, report_metrics, vqa
    from unimedvl_tpu_torch.eval.text_metrics import tokenize

    n_vit, n_llm = inf.cfg.vit.num_hidden_layers, inf.cfg.llm.num_hidden_layers
    reqs = eval_requests()
    answers = [_chat_answer(inf, a, p) for a, p in reqs]
    samples = [dict(image=_pil_image(a), question=p, answer=ans)
               for (a, p), ans in zip(reqs, answers)]
    runs = [("bf16 pool", dict()), ("int8 pool", dict(kv_quantized=True)),
            ("int4 pool", dict(kv_quantized=True, kv_bits=4))]
    print(f"eval run F: run_vqa_eval over {len(samples)} image samples (4 x 980x980, 4 x "
          f"378x532, 8 x 378x378), num_slots={EVAL_SLOTS}, capacity={EVAL_CAPACITY}, "
          f"max_new_tokens={EVAL_MAX_NEW}, answers chat's; pools: bf16, int8, int4", flush=True)
    logits = {}
    total = {name: 0 for name in COUNTERS}
    os.environ["UNIMEDVL_SERVING_PROFILE"] = "1"
    made = serving.ContinuousBatcher
    try:
        for name, kv in runs:
            # just before the pool's timed runs: its admission programs, captured here, are
            # the ones the graphed run replays
            logits[name] = _eval_first_step_logits(inf, samples, **kv)
            if not bool(torch.isfinite(logits[name]).all()):
                raise SystemExit(f"chip_smoke: eval run F ({name}): non-finite first-step "
                                 "logits")
            decode_key = "decode_attention_int8" if kv else "decode_attention"
            counter = ForwardCounter(inf.model)
            reset_counts()
            serving.ContinuousBatcher = _EvalBatcher
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                preds, acc = vqa.run_vqa_eval(
                    inf.model, inf.tokenizer, inf.new_token_ids, samples,
                    max_new_tokens=EVAL_MAX_NEW, num_slots=EVAL_SLOTS, capacity=EVAL_CAPACITY,
                    metric=exact_match_accuracy, **kv)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
            finally:
                serving.ContinuousBatcher = made
                counter.remove()
            b = _EvalBatcher.made.pop()
            EVAL_PREDS[name] = preds, seconds
            eager = _eager_eval(inf, samples, kv, name, b)
            launches = check_counts(f"eval run F ({name})", {
                "flash_block_attention": counter.vit * n_vit + counter.prefill * n_llm,
                decode_key: counter.decode * n_llm,
            })
            for k, v in launches.items():
                total[k] += v
            if b.errors or len(preds) != len(samples) or not all(isinstance(p, str)
                                                                 for p in preds):
                raise SystemExit(f"chip_smoke: eval run F ({name}): errors {b.errors}")
            st = b.stats
            row = dict(card=CARD, pool=name, seconds=seconds,
                       emitted_tokens=st["emitted_tokens"],
                       emitted_tok_s=st["emitted_tokens"] / seconds,
                       stats={k: st[k] for k in ("rounds", "admit_s", "decode_s", "host_s",
                                                 "round_s", "admitted")},
                       decode_forwards=counter.decode, prefill_forwards=counter.prefill,
                       vit_forwards=counter.vit, accuracy=acc,
                       same_as_chat=sum(p == a for p, a in zip(preds, answers)),
                       eager=eager,
                       report_metrics=report_metrics(preds, answers),
                       cache_gib=sum(t.numel() * t.element_size() for t in
                                     serving._arrays(b.cache)) / 2**30)
            print(f"  run F ({name}): {json.dumps(row)}", flush=True)
            if name == "bf16 pool":
                splits = check_answers("F", inf, [(rid, a, p) for rid, (a, p) in
                                                  zip(b.rids, reqs)], b.ids, EVAL_MAX_NEW,
                                       GAP_LIMITS["A"])
                floor = (len(samples) - len(splits)) / len(samples)
                if acc < floor:
                    raise SystemExit(f"chip_smoke: eval run F: accuracy {acc} below the share "
                                     f"of samples with no split, {floor}")
                for p, a in zip(preds, answers):
                    if p != a:
                        continue
                    got, ident = report_metrics([p], [a]), report_metrics([a], [a])
                    if got != ident or (tokenize(a) and got["rouge_l"] != 1.0):
                        raise SystemExit(f"chip_smoke: eval run F: report_metrics {got} on an "
                                         f"answer equal to chat's (identity scores {ident})")
            del b
            torch.cuda.empty_cache()
    finally:
        os.environ.pop("UNIMEDVL_SERVING_PROFILE")
    for name in ("int8 pool", "int4 pool"):
        cos = torch.nn.functional.cosine_similarity(logits[name], logits["bf16 pool"], dim=-1)
        diff = (logits[name] - logits["bf16 pool"]).abs().amax(dim=-1)
        agree = (logits[name].argmax(-1) == logits["bf16 pool"].argmax(-1)).float().mean()
        print(f"  run F {name} vs bf16 pool, first-step logits per sample: cosine min "
              f"{cos.min().item():.6f} median {cos.median().item():.6f}, max abs max "
              f"{diff.max().item():.4f}, argmax agreeing {agree.item():.3f}", flush=True)
    return total


EXTRA_KEYS = (
    "one_row_ms", "one_row_ms_back_to_back", "tiles_skipped", "max_abs_err_lse",
    "cache_partial_t2i_ms", "cache_partial_edit_ms", "library_note", "concat_k1b_ms",
    "k_island_ms", "concat_copy_ms", "k1b_on_concat_ms", "q_island_only_ms", "launches_from",
    "n_split", "split_len", "cases", "ms_in_graph", "vit", "gemm", "bf16_gemm",
    "one_row_ms_in_graph", "gemv_cases", "serving_cases", "spec_cases", "group_cases",
    "gen_cases", "int4_cases", "backward_cases", "shard_cases", "group32_cases",
)

COUNTERS = {  # kernel name -> (its wrapper's counts, the key of its launches there)
    "flash_block_attention": (fa.counts, "kernel"),
    "flash_block_attention_q_preproc": (fa.q_preproc_counts, "kernel"),
    "flash_block_attention_lse": (fa.lse_counts, "kernel"),
    "flash_cache_block_attention": (fa.cache_block_counts, "kernel"),
    "decode_attention": (dec.counts, "kernel"),
    "decode_attention_int8": (dec.int8_counts, "kernel"),
    "silu_mul_quant": (aq.counts, "kernel"),
    "silu_mul_quant_global": (aq.global_counts, "kernel"),
    "w4_matmul": (w4.counts, "kernel"),  # every route
    "w4_matmul_simple": (w4.route_counts, "simple"),
    "packed_train_attention_fwd": (fat.counts, "fwd"),
    "packed_train_attention_bwd_dq": (fat.counts, "bwd_dq"),
    "packed_train_attention_bwd_dkv": (fat.counts, "bwd_dkv"),
}


def reset_counts() -> None:
    for c, key in COUNTERS.values():
        c[key] = 0
        if "plain" in c:
            c["plain"] = 0


def check_counts(path: str, want: dict) -> dict:
    """The launches each kernel counted since reset_counts, against ``want``
    (kernels it does not name: 0); no plain version may have run."""
    want = {name: want.get(name, 0) for name in COUNTERS}
    launches = {name: c[key] for name, (c, key) in COUNTERS.items()}
    plain = {name: c.get("plain", 0) for name, (c, _) in COUNTERS.items()}
    print(f"launches on {path}: {launches} (expected {want}); plain versions called "
          f"{plain}", flush=True)
    if launches != want or any(plain.values()):
        raise SystemExit(f"chip_smoke: {path} did not run through the kernels as expected")
    return launches


def _first_step_logits(inf: InterleaveInferencer, image, prompt) -> torch.Tensor:
    """chat's first decode step on one request (no image when ``image`` is
    None); its logits [V]."""
    ctx = inf.init_gen_context()
    if image is not None:
        ctx = inf.update_context_image(image, ctx, vae=False)
    ctx = inf.update_context_text(prompt, ctx)
    ctx = inf._ensure_capacity(ctx, 1)
    lm = inf.model.language_model
    base = ctx.cache.lens.max()
    bos = torch.tensor([inf.new_token_ids["bos_token_id"]], device="cuda")
    x = qwen2_mot.embed_tokens(lm, bos)[:, None]
    pos = torch.tensor([[ctx.rope]], device="cuda")
    with torch.no_grad():
        h, _ = lm.model(x, pos, ctx.cache, causal=True, decode_cols=(base, base))
    return qwen2_mot.lm_head(lm, h[:, 0])[0]


def check_against_plain_path(inf: InterleaveInferencer) -> torch.Tensor:
    """The second request's first-step logits with the kernels vs with every
    attention call swapped for its plain version (fp32 softmax); returns the
    kernels' logits."""
    h, w, prompt = REQUESTS[1]
    image = _images()[1]
    got = _first_step_logits(inf, image, prompt)
    want = _with_plain_versions(lambda: _first_step_logits(inf, image, prompt))
    cos = torch.nn.functional.cosine_similarity(got, want, dim=0).item()
    max_abs = (got - want).abs().max().item()
    finite = bool(torch.isfinite(got).all())
    print(f"end to end ({h}x{w}): first-step logits kernels vs plain: cosine {cos:.6f}, "
          f"max abs {max_abs:.4f} (logits std {want.std().item():.3f}), argmax "
          f"{got.argmax().item()} vs {want.argmax().item()}, finite {finite}", flush=True)
    if not finite or got.shape != (inf.cfg.llm.vocab_size,) or cos < LOGITS_COS_TOL:
        raise SystemExit("chip_smoke: the kernel path's logits disagree with the plain path's")
    return got


class StepTimer:
    """Host stamps around every forward of the LLM (synchronised, so each
    stamp is the device's time too): the denoise steps are the gen-mode
    forwards that leave the cache as it was. A captured flow step is stamped
    at the end of its replay (``programs.listeners``), its start the end of
    what ran before it (a forward or any replay: a context build's prefill
    programs too); the first replay of a graph includes its capture."""

    def __init__(self, lm_model):
        self.steps = []  # (start, end, streams)
        self._start = None
        self._hooks = [
            lm_model.register_forward_pre_hook(self._pre, with_kwargs=True),
            lm_model.register_forward_hook(self._post, with_kwargs=True),
        ]
        self._mark = None  # the end of the last forward or replay
        programs.listeners.append(self._replay)

    def _pre(self, module, args, kwargs):
        if programs.capturing():
            return
        torch.cuda.synchronize()
        self._start = time.perf_counter()

    def _post(self, module, args, kwargs, output):
        if programs.capturing():
            return
        torch.cuda.synchronize()
        self._mark = time.perf_counter()
        if kwargs.get("update_cache", True):
            return
        self.steps.append((self._start, self._mark, args[0].shape[0]))

    def _replay(self, graph):
        torch.cuda.synchronize()
        start, self._mark = self._mark, time.perf_counter()
        if graph.kind == "denoise":
            self.steps.append((start, self._mark, graph.rows))

    def remove(self):
        for h in self._hooks:
            h.remove()
        programs.listeners.remove(self._replay)


class SPStepTimer(StepTimer):
    """StepTimer for the sequence-parallel denoise, which runs the decoder
    layers itself: an eager step is stamped (synchronised) before its first
    layer and after its last; a captured step (``sp_denoise.SPProgram``) at
    the end of its replay, as StepTimer stamps a flow step (the layers run
    in the graph; a warm-up or capture is not stamped)."""

    def __init__(self, lm_model):
        super().__init__(lm_model)
        self._last = len(lm_model.layers) - 1
        self._layer = sp_denoise._sp_decoder_layer
        sp_denoise._sp_decoder_layer = self._timed

    def _timed(self, x, *args, layer_idx=None, **kw):
        if programs.capturing():
            return self._layer(x, *args, layer_idx=layer_idx, **kw)
        if layer_idx == 0:
            torch.cuda.synchronize()
            self._start = time.perf_counter()
        out = self._layer(x, *args, layer_idx=layer_idx, **kw)
        if layer_idx == self._last:
            torch.cuda.synchronize()
            self._mark = time.perf_counter()
            self.steps.append((self._start, self._mark, x.shape[0]))
        return out

    def remove(self):
        super().remove()
        sp_denoise._sp_decoder_layer = self._layer


def _gen_request(inf: InterleaveInferencer, inputs, **kw):
    """One interleave_inference request; returns (image, row of timings).
    The row's ``latent`` is the final latent tokens, as ``decode_image``
    (wrapped here) took them: the decode is a program on the card, whose
    replay no module hook sees."""
    timer_cls = StepTimer if inf.sp_mesh is None else SPStepTimer
    timer = timer_cls(inf.model.language_model.model)
    decoded, decode_image, wrapped = [], inf.decode_image, inf.__dict__.get("decode_image")

    def keeping(latent, shape):
        decoded.append(latent.detach().clone())
        return decode_image(latent, shape)

    inf.decode_image = keeping
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inf.interleave_inference(inputs, image_shapes=GEN_SIZE, **kw)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    finally:
        timer.remove()
        if wrapped is None:
            del inf.__dict__["decode_image"]
        else:
            inf.decode_image = wrapped
    image = out[-1]
    z = decoded[-1]
    if (getattr(image, "size", None) != GEN_SIZE[::-1] or image.mode != "RGB"
            or not bool(torch.isfinite(z).all()) or np.asarray(image).std() == 0):
        raise SystemExit(f"chip_smoke: generation returned {image!r}, non-finite latents or a "
                         "blank image")
    steps = timer.steps
    dur = [(b[0] if i + 1 < len(steps) else a[1]) - a[0]
           for i, (a, b) in enumerate(zip(steps, steps[1:] + steps[-1:]))]

    def ms_per_step(n_streams):
        d = [x for x, st in zip(dur, steps) if st[2] == n_streams]
        return 1e3 * statistics.median(d) if d else None

    row = dict(
        context_build_s=steps[0][0] - t0, denoise_s=steps[-1][1] - steps[0][0],
        steps=len(steps), steps_3_stream=sum(st[2] == 3 for st in steps),
        ms_per_3_stream_step=ms_per_step(3), ms_per_1_stream_step=ms_per_step(1),
        vae_decode_s=t_end - steps[-1][1], s_per_image=t_end - t0,
        image_std=float(np.asarray(image).std()),
    )
    row["latent"] = z
    return image, row


def check_gen_against_eager(inf: InterleaveInferencer, path: str, requests, states,
                            graphed: dict, expected: dict) -> None:
    """The generation requests once more on the eager flow loop
    (``inf.graphs = False``), each from the generator state its graphed run
    started from: the final latent within VELOCITY_COS_TOL of the graphed
    one, the image within 1 per uint8 pixel, the launches ``expected()``
    (the graphed run's for the same requests). Prints s/image both ways.
    ``graphed``: name -> (image, row) of the graphed runs."""
    reset_counts()
    inf.graphs = False
    try:
        for (name, inputs), state in zip(requests, states):
            inf._generator.set_state(state)
            image, row = _gen_request(inf, inputs)
            g_image, g_row = graphed[name]
            cos = _cosine(g_row["latent"], row["latent"])
            px = int(np.abs(np.asarray(image, np.int32) - np.asarray(g_image, np.int32)).max())
            print(f"  {path} {name}: graphed vs eager flow loop: final latent cosine {cos:.6f}, "
                  f"image max |diff| {px} per pixel; s/image {g_row['s_per_image']:.3f} graphed, "
                  f"{row['s_per_image']:.3f} eager; ms per 3-stream step "
                  f"{g_row['ms_per_3_stream_step']:.2f} / {row['ms_per_3_stream_step']:.2f}, "
                  f"1-stream {g_row['ms_per_1_stream_step']:.2f} / "
                  f"{row['ms_per_1_stream_step']:.2f} ({CARD})", flush=True)
            if cos < VELOCITY_COS_TOL or px > 1:
                raise SystemExit(f"chip_smoke: {path} {name}: the graphed flow loop disagrees "
                                 "with the eager one")
    finally:
        inf.graphs = None
    check_counts(f"{path} (eager)", expected())


def check_vae_decode(inf: InterleaveInferencer, latent: torch.Tensor) -> dict:
    """The 512x512 VAE decode of ``latent`` (the text-to-image request's
    final latent tokens) by its program against the eager decode: the
    program dropped and captured anew, then replayed, then the eager decode
    (its decoder's output finite); the images within 1 per uint8 pixel.
    Prints s per decode both ways, the capture's, and the shared graph
    pool's bytes before and after the capture (its fp32 activations)."""
    h, w = (s // inf.cfg.latent_downsample for s in GEN_SIZE)
    programs.drop_reading(inf.model.vae_model)  # the VAE's programs: the decode and the encodes
    pool_before = programs.pool_bytes()
    caps = programs.stats["captures"]

    def timed(graphs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        image = bagel.decode_latent_to_image(inf.model, latent, h, w, graphs=graphs)
        torch.cuda.synchronize()
        return image, time.perf_counter() - t0

    _, capture_s = timed(None)
    got, graphed_s = timed(None)
    captured = programs.stats["captures"] - caps
    finite = []
    hook = inf.model.vae_model.decoder.register_forward_hook(
        lambda m, a, out: finite.append(bool(torch.isfinite(out).all())))
    try:
        want, eager_s = timed(False)
    finally:
        hook.remove()
    px = int((got.int() - want.int()).abs().max())
    row = dict(card=CARD, vae_decode_s_graphed=graphed_s, vae_decode_s_eager=eager_s,
               capture_call_s=capture_s, captures=captured, max_abs_pixel_diff=px,
               shared_pool_bytes_before=pool_before, shared_pool_bytes_after=programs.pool_bytes())
    print(f"  VAE decode {GEN_SIZE[0]}x{GEN_SIZE[1]}, program vs eager on the text-to-image "
          f"latent: {json.dumps(row)}", flush=True)
    if captured != 1 or px > 1 or finite != [True]:
        raise SystemExit("chip_smoke: the VAE decode's program disagrees with the eager decode, "
                         "or did not capture once, or the decoder's output is not finite")
    return row


def _edit_image() -> np.ndarray:
    rng = np.random.default_rng(SEED + 2)
    return rng.integers(0, 256, (*GEN_SIZE, 3), dtype=np.uint8)


def run_generation(inf: InterleaveInferencer):
    """A text-to-image request and an image edit at 512x512 with the
    recipe's defaults, counters reset just before. With ``inf.sp_mesh`` the
    denoise is the sequence-parallel program: two K1c launches per layer and
    step in place of one K1b. Returns (the launches, each request's timings)."""
    sp = inf.sp_mesh is not None
    # warm-up edit request (first uses of the shapes, cuDNN set-up), few steps, eager (a
    # schedule of 3 steps would capture graphs of its own), not counted
    with programs.eager():
        inf.interleave_inference([_edit_image(), EDIT_PROMPT], image_shapes=GEN_SIZE,
                                 num_timesteps=3)
    reset_counts()
    requests = [("text-to-image", [GEN_PROMPT]), ("edit", [_edit_image(), EDIT_PROMPT])]
    rows, outs, states = {}, {}, []
    for name, inputs in requests:
        states.append(inf._generator.get_state())
        outs[name] = _gen_request(inf, inputs)
        rows[name] = {k: v for k, v in outs[name][1].items() if k != "latent"}
        print(f"  request {name} {GEN_SIZE[0]}x{GEN_SIZE[1]}: {json.dumps(rows[name])}",
              flush=True)
    n_vit, n_llm = inf.cfg.vit.num_hidden_layers, inf.cfg.llm.num_hidden_layers
    steps = 49  # num_timesteps 50
    denoise = 2 * steps * n_llm  # every denoise step of both requests
    expected = {
        # text prefills: main and cfg_img context in each request; the edit's ViT image
        "flash_block_attention": 2 * 2 * n_llm + (n_vit + n_llm),
        # the edit's VAE prefill, and without sp_mesh every denoise step
        "flash_block_attention_q_preproc": n_llm + (0 if sp else denoise),
        # with sp_mesh: a cache partial and a block partial per layer and step
        "flash_block_attention_lse": 2 * denoise if sp else 0,
        "decode_attention": 0,
    }
    path = "the sequence-parallel denoise path" if sp else "the generation path"
    launches = check_counts(path, expected)
    if not sp:
        check_vae_decode(inf, outs["text-to-image"][1]["latent"])
    if not sp:  # the sequence-parallel denoise runs eagerly
        # the eager comparison on the text-to-image request (the smoke's time)
        check_gen_against_eager(inf, path, requests[:1], states[:1], outs, lambda: {
            "flash_block_attention": 2 * n_llm,
            "flash_block_attention_q_preproc": steps * n_llm})
    return launches, rows


def _gen_contexts(inf: InterleaveInferencer, edit: bool = False) -> list:
    """A 512x512 request's contexts [main, cfg_text, cfg_img], built as
    interleave_inference builds them: the text-to-image request, or with
    ``edit`` the image edit (its VAE posterior sample from SEED + 10)."""
    inf._generator.manual_seed(SEED + 10)  # the same VAE posterior sample at every call
    ctx = inf.init_gen_context()
    cfg_img, cfg_text = ctx.fork(), ctx.fork()
    prompt = EDIT_PROMPT if edit else GEN_PROMPT
    if edit:
        ctx = inf.update_context_image(inf._vae_resized_u8(_edit_image()), ctx, vae=True,
                                       vit=True)
        cfg_text = ctx.fork()
    ctx = inf.update_context_text(prompt, ctx)
    cfg_img = inf.update_context_text(prompt, cfg_img)
    return [ctx, cfg_text, cfg_img]


def _denoise_inputs(inf: InterleaveInferencer, edit: bool = False):
    """(caches, positions, latent position ids, noise) of a 512x512 request's
    denoise over :func:`_gen_contexts`."""
    return _stacked_inputs(inf, _gen_contexts(inf, edit), GEN_SIZE)


def _stacked_inputs(inf: InterleaveInferencer, contexts, shape):
    """(caches, positions, latent position ids, noise) of a denoise at
    ``shape`` over ``contexts`` (main, cfg_text, cfg_img), the noise from a
    generator of its own (SEED + 3)."""
    caches, positions = inf._stack_contexts(contexts)
    ld = inf.cfg.latent_downsample
    h, w = shape[0] // ld, shape[1] // ld
    pos_ids = torch.from_numpy(inf._position_ids(*shape, ld, inf.cfg.max_latent_size))
    g = torch.Generator(device=inf.device).manual_seed(SEED + 3)
    noise = torch.randn(h * w, inf.cfg.patch_latent_dim, generator=g, device=inf.device)
    return caches, positions, pos_ids.to(inf.device), noise


RECIPE = dict(timestep_shift=3.0, cfg_text_scale=3.0, cfg_img_scale=1.5, cfg_interval=(0.4, 1.0),
              use_text_cfg=True, use_img_cfg=True)


def _first_step_velocity(inf: InterleaveInferencer, mesh=None, edit: bool = False
                         ) -> torch.Tensor:
    """Post-CFG velocity of the first flow step (t = 1) of the text-to-image
    request, or of the edit. With ``mesh``, through the sequence-parallel
    program: a schedule of two timesteps is that one step with dt = 1."""
    inputs = _denoise_inputs(inf, edit)
    if mesh is not None:
        caches, positions, pos_ids, noise = inputs
        x1 = sp_denoise.generate_latents_tp_sp(
            inf.model, caches, positions, pos_ids, noise, inf._start_end(), mesh,
            num_timesteps=2, **RECIPE)
        return noise - x1
    return _velocity_on(inf, *inputs)


def _velocity_on(inf: InterleaveInferencer, caches, positions, pos_ids, noise) -> torch.Tensor:
    """The first flow step's post-CFG velocity (t = 1, RECIPE's options) on
    stacked denoise inputs."""
    x1 = bagel.generate_latents(
        inf.model, caches, positions, pos_ids, noise, inf._start_end(), num_timesteps=50,
        step_range=(0, 1), **RECIPE)
    _, dts = bagel.flow_timesteps(50, 3.0)
    return (noise - x1) / float(dts[0])


def _upcast(ref):
    """An attention plain version with its float tensor inputs upcast to fp32,
    so that q's island and p are not rounded to bf16 inside it; its output is
    rounded back to q's dtype once, as the model's next projection needs."""
    def up(x):
        return x.float() if torch.is_tensor(x) and x.is_floating_point() else x

    def call(q, *args, **kw):
        out = ref(q.float(), *map(up, args), **{key: up(val) for key, val in kw.items()})
        if isinstance(out, tuple):  # (out, lse)
            return out[0].to(q.dtype), out[1]
        return out.to(q.dtype)
    return call


def _with_plain_versions(fn, fp32_attention: bool = False, quant_only: bool = False):
    """fn() with every kernel call swapped for its plain version; with
    ``fp32_attention`` the attention ones run in fp32 (``_upcast``); with
    ``quant_only`` only K3 and K4 (the attention kernels stay)."""
    flash, decode, train = (_upcast(f) if fp32_attention else f for f in (
        fa.flash_block_attention_ref, dec.decode_attention_ref, fat.packed_train_attention_ref))
    swapped = [(qwen2_mot, "silu_mul_quant_autograd", aq.silu_mul_quant_ref),
               (quant, "w4_matmul_autograd", w4.w4_matmul_ref)]
    if not quant_only:
        swapped += [(siglip, "flash_block_attention", flash),
                    (qwen2_mot, "flash_block_attention", flash),
                    (qwen2_mot, "decode_attention", decode),
                    (qwen2_mot, "packed_train_attention", train),
                    (sp_denoise, "flash_block_attention", flash)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swapped]
    for mod, name, f in swapped:
        setattr(mod, name, f)
    try:
        with programs.eager():  # a captured graph would replay the kernels
            return fn()
    finally:
        for mod, name, f in saved:
            setattr(mod, name, f)


def check_velocity_against_plain(inf: InterleaveInferencer, mesh=None) -> dict:
    """The first post-CFG velocity of the text-to-image request through the
    kernels against the plain versions (:func:`check_velocities`)."""
    path = "the sequence-parallel path" if mesh is not None else \
        f"text-to-image {GEN_SIZE[0]}x{GEN_SIZE[1]}"
    return check_velocities(path, lambda: _first_step_velocity(inf, mesh))


class QuantReplay:
    """The kernel side's int8 activations, recorded in call order and fed to
    the plain sides: K3's (q, scale) (``qwen2_mot.silu_mul_quant_autograd``)
    and every ``quant.quantize_activations`` output (the act-quant
    projections' inputs, the int8 KV cache's keys and values, the int8
    head's hidden). Both sides then round the same, so a last-place
    difference before a rounding cannot move a value a whole int8 step.
    What this takes out of the end-to-end comparison is held call by call:
    each replayed K3 call runs the plain version on the plain side's own
    (g, u) and holds the recorded (q, scale) to it at K3's bounds (a wrong
    K3 fails here), and :class:`AttentionTap` holds every attention output.
    ``own_scales`` (a training step, whose gradient flows through the
    scales): each replayed scale carries the plain side's own scale's graph,
    ``recorded + (own - own.detach())``, so the forward uses the recorded
    values bit for bit and the gradient is the plain definition's. The call
    order is the code's, the same on both sides (recomputed layers
    included); each replayed call checks its shape and the replay must use
    up the record."""

    def __init__(self, own_scales: bool = False):
        self.k3, self.act, self.own_scales = [], [], own_scales
        self.k3_worst = dict(step=0, share=0.0, scale_rel=0.0)

    def _patched(self, k3_fn, act_fn):
        saved = (qwen2_mot.silu_mul_quant_autograd, quant.quantize_activations)
        qwen2_mot.silu_mul_quant_autograd, quant.quantize_activations = k3_fn, act_fn
        return saved

    def record(self, fn):
        k3, act = qwen2_mot.silu_mul_quant_autograd, quant.quantize_activations

        def rec(store, out):  # q waits in host memory: a training step's would crowd the card
            store.append((out[0].detach().to("cpu"), out[1].detach()))
            return out

        saved = self._patched(lambda g, u: rec(self.k3, k3(g, u)),
                              lambda x, reduce_max=None: rec(self.act, act(x, reduce_max)))
        try:
            return fn()
        finally:
            self._patched(*saved)

    def _k3(self, it, g, u):
        """A replayed K3 call: the recorded (q, scale) against the plain
        version on this side's (g, u)."""
        q, scale = next(it)
        if q.shape != g.shape:
            raise SystemExit(f"chip_smoke: the replayed K3 output is {tuple(q.shape)}, the "
                             f"plain side asks for {tuple(g.shape)}")
        q = q.to(g.device)
        q_ref, own = aq.silu_mul_quant_ref(g, u)
        if q.numel():
            with torch.no_grad():
                step = (q.int() - q_ref.int()).abs()
                w = self.k3_worst
                w["step"] = max(w["step"], int(step.max().item()))
                w["share"] = max(w["share"], (step > 0).float().mean().item())
                w["scale_rel"] = max(w["scale_rel"], ((scale - own).abs() / own).max().item())
        return q, (scale + (own - own.detach()) if self.own_scales else scale)

    def _act(self, it, x, act):
        q, scale = next(it)
        if q.shape != x.shape:
            raise SystemExit(f"chip_smoke: the replayed activations are {tuple(q.shape)}, the "
                             f"plain side asks for {tuple(x.shape)}")
        if self.own_scales:
            own = act(x)[1]
            scale = scale + (own - own.detach())
        return q.to(x.device), scale

    def replay(self, fn):
        it = {"k3": iter(self.k3), "act": iter(self.act)}
        act = quant.quantize_activations
        # one rank: no projection reduces its scales (reduce_max stays None)
        saved = self._patched(lambda g, u: self._k3(it["k3"], g, u),
                              lambda x, reduce_max=None: self._act(it["act"], x, act))
        try:
            out = fn()
        finally:
            self._patched(*saved)
        left = sum(1 for _ in it["k3"]) + sum(1 for _ in it["act"])
        if left:
            raise SystemExit(f"chip_smoke: {left} recorded activations were not replayed")
        return out

    def check_k3(self, path: str) -> None:
        """Prints and gates the replayed K3 calls' worst readings (the bounds
        of :func:`check_silu_mul_quant`)."""
        if not self.k3:
            return
        w = self.k3_worst
        print(f"  K3 call by call ({len(self.k3)} calls) against the plain version on the same "
              f"(g, u): max step {w['step']}, largest share differing {w['share']:.2e}, scale "
              f"rel err {w['scale_rel']:.2e}", flush=True)
        if (w["step"] > K3_MAX_STEP or w["share"] > K3_MAX_SHARE
                or w["scale_rel"] > K3_SCALE_RTOL):
            raise SystemExit(f"chip_smoke: K3 inside {path} disagrees with its plain version")


class AttentionTap:
    """The model's attention outputs, call by call (``qwen2_mot``'s K1a / K1b,
    K2 and K5 call sites): recorded on the kernel side and held, on a plain
    side that ran on the kernel side's int8 activations (:class:`QuantReplay`),
    to the plain version's output on the same inputs. There every
    projection's input is replayed, so a layer's attention output reaches the
    result only through int8 values; this is where a wrong attention kernel
    fails. Each call: cosine at ATTN_COS_TOL and every element within the
    kernel checks' bound, ATOL + RTOL |plain|, where the plain output is
    finite (a query row that sees nothing); the kernel's must be finite
    there too."""

    SITES = ("flash_block_attention", "decode_attention", "packed_train_attention")

    def __init__(self):
        self.outs, self.worst = [], {}

    def _run(self, fn, on_call):
        saved = {n: getattr(qwen2_mot, n) for n in self.SITES}

        def wrap(n, f):
            def call(*args, **kw):
                out = f(*args, **kw)
                on_call(n, out[0] if isinstance(out, tuple) else out)
                return out
            return call

        for n, f in saved.items():
            setattr(qwen2_mot, n, wrap(n, f))
        try:
            return fn()
        finally:
            for n, f in saved.items():
                setattr(qwen2_mot, n, f)

    def record(self, fn):
        return self._run(fn, lambda n, out: self.outs.append((n, out.detach())))

    def compare(self, side: str, fn):
        """fn() with each attention output held to the recorded one; keeps,
        per site, the calls, the lowest cosine and the worst err/bound."""
        it = iter(self.outs)

        def check(n, want):
            name, got = next(it)
            if name != n or got.shape != want.shape:
                raise SystemExit(f"chip_smoke: the {side} side called {n} "
                                 f"{tuple(want.shape)} where the kernel side called {name} "
                                 f"{tuple(got.shape)}")
            ref = want.detach().float()
            ok = torch.isfinite(ref)
            got = got.float()
            if not bool(torch.isfinite(got[ok]).all()):
                raise SystemExit(f"chip_smoke: {n} gave a non-finite output where its plain "
                                 "version is finite")
            ref, got = ref[ok], got[ok]
            worst = ((got - ref).abs() / (ATOL + RTOL * ref.abs())).max().item() \
                if ref.numel() else 0.0
            cos = _cosine(got, ref) if ref.numel() else 1.0
            calls, lo, hi = self.worst.get((side, n), (0, 1.0, 0.0))
            self.worst[(side, n)] = (calls + 1, min(lo, cos), max(hi, worst))

        out = self._run(fn, check)
        if next(it, None) is not None:
            raise SystemExit(f"chip_smoke: the {side} side made fewer attention calls than the "
                             "kernel side")
        return out

    def check(self, path: str) -> None:
        for (side, n), (calls, cos, worst) in sorted(self.worst.items()):
            print(f"  {n} call by call against the {side} version on the same inputs: {calls} "
                  f"calls, lowest cosine {cos:.6f}, worst err/bound {worst:.3f}", flush=True)
            if cos < ATTN_COS_TOL or worst > 1.0:
                raise SystemExit(f"chip_smoke: {n} inside {path} disagrees with its {side} "
                                 "version")


def check_velocities(path: str, velocity, replay: bool = False, per_call: bool = False) -> dict:
    """``velocity()`` (a first post-CFG velocity) on the same inputs through
    the kernels, the plain versions (bf16 in and out, p rounded to bf16
    before P V, as the kernels round it) and the plain versions with the
    attention in fp32; asserts kernels vs plain and kernels vs fp32 at
    VELOCITY_COS_TOL and prints the noise floor, plain bf16 vs fp32.
    ``replay`` (the quantized modes): the plain sides run on the kernel
    side's int8 activations (:class:`QuantReplay`). ``per_call`` (where every
    projection's input is replayed, so each layer's attention sees the
    kernel side's inputs): every attention output and K3 call is also held
    to its plain version (:class:`AttentionTap`, ``QuantReplay.check_k3``).
    Returns the three velocities and the replay (``v["replay"]``)."""
    with programs.eager():  # the recorders and taps see every call of the eager step
        return _check_velocities(path, velocity, replay, per_call)


def _check_velocities(path: str, velocity, replay: bool, per_call: bool) -> dict:
    rec = QuantReplay() if replay else None
    tap = AttentionTap() if per_call else None
    if rec is None:
        v = {"kernels": velocity(),
             "plain": _with_plain_versions(velocity),
             "fp32": _with_plain_versions(velocity, True)}
    else:
        def plain(side):
            run = (lambda: rec.replay(velocity)) if tap is None else \
                (lambda: tap.compare(side, lambda: rec.replay(velocity)))
            return _with_plain_versions(run, side == "fp32")

        kernels = (lambda: rec.record(velocity)) if tap is None else \
            (lambda: tap.record(lambda: rec.record(velocity)))
        v = {"kernels": kernels(), "plain": plain("plain"), "fp32": plain("fp32")}
        print(f"  replayed the kernel side's int8 activations: {len(rec.k3)} K3 outputs, "
              f"{len(rec.act)} quantize_activations outputs", flush=True)
        if tap is not None:
            tap.check(path)
            rec.check_k3(path)
            del tap
    cos = {pair: _cosine(v[pair[0]], v[pair[1]])
           for pair in (("kernels", "plain"), ("kernels", "fp32"), ("plain", "fp32"))}
    print(f"end to end ({path}): first-step post-CFG velocity (std "
          f"{v['fp32'].std().item():.3f}), cosine kernels vs plain "
          f"{cos['kernels', 'plain']:.6f}, kernels vs fp32 attention "
          f"{cos['kernels', 'fp32']:.6f}; the noise floor, plain bf16 vs fp32 attention "
          f"{cos['plain', 'fp32']:.6f}; max abs kernels vs fp32 "
          f"{(v['kernels'] - v['fp32']).abs().max().item():.4f}", flush=True)
    if (not bool(torch.isfinite(v["kernels"]).all()) or v["kernels"].shape != v["fp32"].shape
            or min(cos[("kernels", "plain")], cos[("kernels", "fp32")]) < VELOCITY_COS_TOL):
        raise SystemExit(f"chip_smoke: the velocity of {path} disagrees with the plain versions' "
                         f"(VELOCITY_COS_TOL {VELOCITY_COS_TOL:.6f})")
    v["replay"] = rec
    return v


def _cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    return torch.nn.functional.cosine_similarity(a.flatten(), b.flatten(), dim=0).item()


def gen_path_launches(counter: ForwardCounter, n_vit: int, n_llm: int, k3: int = 0,
                      k4: int = 0, decode_key: str = "decode_attention") -> dict:
    """The launches a generation-side run must show, from its forwards: K1a
    at every ViT layer and at every und-mode prefill (text), K1b at every
    gen-mode forward (VAE image prefills, denoise steps), K2 / K2-int8 at
    every decode step; with quantized projections ``k3`` K3 and ``k4`` K4
    launches per layer and expert run, where a gen-mode forward runs both
    experts (the gen expert on every row, the und expert on the text rows)."""
    und = counter.prefill - (counter.gen - counter.denoise)
    runs = counter.decode + und + 2 * counter.gen
    return {"flash_block_attention": counter.vit * n_vit + und * n_llm,
            "flash_block_attention_q_preproc": counter.gen * n_llm,
            decode_key: counter.decode * n_llm,
            "silu_mul_quant": k3 * n_llm * runs, "w4_matmul": k4 * n_llm * runs}


# -- the vqa-reconstruction recipes (what remains of M7) --------------------------------------
RECON_PROMPT = "What abnormality is visible? Describe it in one sentence."


def _recon_image(i: int) -> np.ndarray:
    rng = np.random.default_rng(SEED + 20 + i)
    return rng.integers(0, 256, (*GEN_SIZE, 3), dtype=np.uint8)


def _recon_request(inf: InterleaveInferencer, path: str, call):
    """``call()`` (a recipe) with ``gen_image`` and ``decode_image`` wrapped
    to keep each image's contexts, options, the generator's state before its
    noise is drawn, its seconds (synchronised) and its final latent; counters
    reset just before. Returns (the recipe's output, its seconds, the kept
    generations, the launches)."""
    n_vit, n_llm = inf.cfg.vit.num_hidden_layers, inf.cfg.llm.num_hidden_layers
    gens, gen_image, decode_image = [], inf.gen_image, inf.decode_image

    def recording(shape, ctx, **kw):
        state = inf._generator.get_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gen_image(shape, ctx, **kw)
        torch.cuda.synchronize()
        gens[-1].update(shape=shape, ctx=ctx, kw=kw, state=state,
                        seconds=time.perf_counter() - t0)
        return out

    def keeping(latent, shape):
        gens.append(dict(latent=latent.clone()))
        return decode_image(latent, shape)

    inf.gen_image, inf.decode_image = recording, keeping
    counter = ForwardCounter(inf.model)
    reset_counts()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        counter.remove()
        del inf.__dict__["gen_image"], inf.__dict__["decode_image"]
    launches = check_counts(path, gen_path_launches(counter, n_vit, n_llm))
    return out, seconds, gens, launches


def run_reconstruction(inf: InterleaveInferencer) -> dict:
    """Run G, the vqa-reconstruction recipes at the full width, recipe
    defaults (50 timesteps, CFG text 3.0 / image 1.5 on (0.4, 1.0], global
    renorm), answers of at most MAX_LENGTH tokens: ``inf(image=<512x512>,
    text=..., inference_ver=1, reconstruct_image=True)`` (``_ver1``: the
    answer from a VAE + ViT context, the image generated again from it),
    then ``_ver0_1`` over two 512x512 images (a fresh context per image, CFG
    scales 7.0). Gates: a non-empty answer and one 512x512 image per input
    image; the launches against the forwards; ver1's first denoise step's
    velocity on its own three contexts against the plain versions
    (:func:`check_velocities`); ver1's final latent against
    ``gen_image_latent`` on the same contexts with the generator replayed
    (cosine at VELOCITY_COS_TOL, max |diff| printed). Returns the launches."""
    total = {name: 0 for name in COUNTERS}
    print(f"vqa-reconstruction (run G): inference_ver=1 on a {GEN_SIZE[0]}x{GEN_SIZE[1]} "
          f"image, then _ver0_1 over two; 50 timesteps, answers of at most {MAX_LENGTH} "
          "tokens", flush=True)
    cases = [
        ("ver1", [_recon_image(0)], lambda: inf(
            image=_pil_image(_recon_image(0)), text=RECON_PROMPT, inference_ver=1,
            reconstruct_image=True, max_think_token_n=MAX_LENGTH)),
        ("ver0_1", [_recon_image(0), _recon_image(1)],
         lambda: inf.interleave_inference_for_vqa_reconstruction_ver0_1(
             [_pil_image(_recon_image(0)), _pil_image(_recon_image(1)), RECON_PROMPT],
             reconstruct_image=True, max_think_token_n=MAX_LENGTH)),
    ]
    for name, images, call in cases:
        out, seconds, gens, launches = _recon_request(inf, f"the {name} recipe", call)
        for k, v in launches.items():
            total[k] += v
        text = out["text"] if isinstance(out, dict) else out[0]
        imgs = (([out["image"]] if out["image"] is not None else []) if isinstance(out, dict)
                else out[1:])
        row = dict(card=CARD, recipe=name, seconds=seconds, answer=text[:60],
                   s_per_image=[gd["seconds"] for gd in gens],
                   answer_and_contexts_s=seconds - sum(gd["seconds"] for gd in gens))
        print(f"  {name}: {json.dumps(row)}", flush=True)
        if (not isinstance(text, str) or not text.strip() or len(imgs) != len(images)
                or any(getattr(im, "size", None) != GEN_SIZE[::-1] for im in imgs)
                or any(not bool(torch.isfinite(gd["latent"]).all()) for gd in gens)):
            raise SystemExit(f"chip_smoke: the {name} recipe returned {text!r} and {imgs}")
        if name != "ver1":
            continue
        gd = gens[0]
        contexts = [gd["ctx"], gd["kw"]["cfg_text_precontext"], gd["kw"]["cfg_img_precontext"]]
        check_velocities(f"the ver1 recipe's reconstruction {GEN_SIZE[0]}x{GEN_SIZE[1]}",
                         lambda: _velocity_on(inf, *_stacked_inputs(inf, contexts, gd["shape"])))
        inf._generator.set_state(gd["state"])
        want = inf.gen_image_latent(gd["shape"], gd["ctx"], **gd["kw"])
        cos = _cosine(gd["latent"], want)
        print(f"  ver1's image: final latent vs gen_image_latent on the same contexts, the "
              f"generator replayed: cosine {cos:.6f}, max abs "
              f"{(gd['latent'] - want).abs().max().item():.4f} (latent std "
              f"{want.std().item():.3f})", flush=True)
        if cos < VELOCITY_COS_TOL:
            raise SystemExit("chip_smoke: ver1's image disagrees with gen_image_latent")
    return total


# -- quantized text to image (what remains of M7) --------------------------------------------
QUANT_GEN_MODES = [  # name, options, K4 launches per layer and expert run, K3 likewise
    ("full-int8 + fused + int8 KV", dict(bits=8, act_quant=True), 0, 1),
    ("w4a8 per channel + fused + int8 KV", dict(bits=4, act_quant=True), 4, 1),
    ("weight-only w4 per channel + fused + int8 KV", dict(bits=4), 4, 0),
]


def run_quantized_generation(inf: InterleaveInferencer, v_bf16: torch.Tensor,
                             bf16_rows: dict) -> dict:
    """Run H, text to image and an edit at 512x512 (recipe defaults) in the
    quantized modes, each on its own quantized copy of the LLM (freed before
    the next), fused, with an int8 KV cache: full-int8, w4a8 per channel,
    weight-only w4 per channel. Checks the launches against the forwards (K3
    and K4 at every projection of both experts in a gen-mode forward, of the
    und expert in a text prefill), gates the first post-CFG velocity of the
    text-to-image request against the same quantized model's plain versions
    at the fixed VELOCITY_COS_TOL, the plain sides fed the kernel side's int8
    activations (:func:`check_velocities` with ``replay``), also with only K4
    swapped for its plain version, and prints its cosine against the bf16
    model's
    (``v_bf16``: an observation, these are non-parity modes) and each
    request's s/image split into context build, denoise and VAE decode beside
    bf16's (``bf16_rows``, from the same call). Returns the launches."""
    n_vit, n_llm = inf.cfg.vit.num_hidden_layers, inf.cfg.llm.num_hidden_layers
    total = {name: 0 for name in COUNTERS}
    for name, kw, k4, k3 in QUANT_GEN_MODES:
        print(f"quantized generation path (run H), {name}: text-to-image and an edit at "
              f"{GEN_SIZE[0]}x{GEN_SIZE[1]}, 50 timesteps", flush=True)
        qinf = quantized_inferencer(inf, **kw)
        # warm-up (first uses of the quantized shapes), few steps, eager (a schedule of 3 steps
        # would capture graphs of its own), not counted
        with programs.eager():
            qinf.interleave_inference([GEN_PROMPT], image_shapes=GEN_SIZE, num_timesteps=3)
        counter = ForwardCounter(qinf.model)
        reset_counts()
        rows, outs, states = {}, {}, []
        requests = (("text-to-image", [GEN_PROMPT]), ("edit", [_edit_image(), EDIT_PROMPT]))
        try:
            for rname, inputs in requests:
                states.append(qinf._generator.get_state())
                outs[rname] = _gen_request(qinf, inputs)
                rows[rname] = outs[rname][1]
        finally:
            counter.remove()
        path = f"the quantized generation path ({name})"
        launches = check_counts(path, gen_path_launches(
            counter, n_vit, n_llm, k3=k3, k4=k4, decode_key="decode_attention_int8"))
        # the eager comparison on the text-to-image request alone (the smoke's time)
        counter = ForwardCounter(qinf.model)
        try:
            check_gen_against_eager(qinf, path, requests[:1], states[:1], outs, lambda: (
                gen_path_launches(counter, n_vit, n_llm, k3=k3, k4=k4,
                                  decode_key="decode_attention_int8")))
        finally:
            counter.remove()
        for k, v in launches.items():
            total[k] += v
        for rname, row in rows.items():
            ref = bf16_rows[rname]
            split = {k: row[k] for k in ("s_per_image", "context_build_s", "denoise_s",
                                         "vae_decode_s", "ms_per_3_stream_step",
                                         "ms_per_1_stream_step")}
            print(f"  {name} {rname}: {json.dumps(dict(card=CARD, **split))}; bf16 "
                  f"{json.dumps({k: ref[k] for k in split})}; s/image "
                  f"{row['s_per_image'] / ref['s_per_image']:.3f}x bf16's", flush=True)
        velocity = partial(_first_step_velocity, qinf)
        v = check_velocities(f"quantized text-to-image, {name}", velocity, replay=True,
                             per_call=kw.get("act_quant", False))
        cos_quant = _cosine(v["kernels"], _with_plain_versions(
            lambda: v["replay"].replay(velocity), quant_only=True))
        print(f"  {name}: first velocity with K4 against its plain version alone on the same "
              f"int8 activations (the attention kernels kept): cosine {cos_quant:.6f}; against "
              f"the bf16 model's (not a parity mode): cosine "
              f"{_cosine(v['kernels'], v_bf16):.4f}", flush=True)
        if cos_quant < VELOCITY_COS_TOL:
            raise SystemExit(f"chip_smoke: K4 moves the first velocity of {name}")
        del qinf, v
        torch.cuda.empty_cache()
    return total


def run_cache_block_step(inf: InterleaveInferencer) -> dict:
    """K6 inside the model. No entry point routes through it (nor does the
    JAX package's): here the attention of the denoise step that leaves the
    cache as it is is swapped for K6 (the q island in the kernel; the k island
    stays outside, as the layer computes it), the first flow step of the
    text-to-image request and of the edit runs at the full depth, and its
    post-CFG velocity is held against the same step through concat + K1b.
    Returns the launches of the swapped steps: K6's count in the kernels
    line, which no unswapped path would give it."""
    def attend(q, k, v, k_cache, v_cache, lens, causal, q_valid_len, q_preproc):
        if q_valid_len is not None:
            raise SystemExit("chip_smoke: the denoise block is not trailing-padded")
        return fa.flash_cache_block_attention(q, k_cache, v_cache, k, v, lens, causal,
                                              q_preproc=q_preproc, cache_head_major=True)

    def swapped(fn):
        saved = qwen2_mot._attend_cache_and_block
        qwen2_mot._attend_cache_and_block = attend
        try:
            with programs.eager():  # a captured graph would not see the swap
                return fn()
        finally:
            qwen2_mot._attend_cache_and_block = saved

    n_vit, n_llm = inf.cfg.vit.num_hidden_layers, inf.cfg.llm.num_hidden_layers
    want = {False: _first_step_velocity(inf), True: _first_step_velocity(inf, edit=True)}
    reset_counts()
    got = {edit: swapped(lambda: _first_step_velocity(inf, edit=edit)) for edit in (False, True)}
    launches = check_counts("one denoise step of each request with K6 swapped in", {
        "flash_block_attention": 2 * 2 * n_llm + (n_vit + n_llm),  # the context builds
        "flash_block_attention_q_preproc": n_llm,  # the edit's VAE prefill
        "flash_cache_block_attention": 2 * n_llm,
    })
    for edit, name in ((False, "text-to-image"), (True, "edit")):
        cos, finite = _cosine(got[edit], want[edit]), bool(torch.isfinite(got[edit]).all())
        caches, positions, pos_ids, noise = _denoise_inputs(inf, edit)
        step = lambda: bagel.generate_latents(  # noqa: E731  (eager, as K6's swap runs)
            inf.model, caches, positions, pos_ids, noise, inf._start_end(), num_timesteps=50,
            step_range=(0, 1), graphs=False, **RECIPE)
        ms_today, ms_k6 = cuda_ms(step, iters=5), cuda_ms(lambda: swapped(step), iters=5)
        print(f"  {name} {GEN_SIZE[0]}x{GEN_SIZE[1]}, first step (3 streams, lens "
              f"{caches.lens.tolist()}, capacity {caches.capacity}): post-CFG velocity K6 vs "
              f"concat + K1b: cosine {cos:.6f}, max abs "
              f"{(got[edit] - want[edit]).abs().max().item():.4f}, finite {finite}; the step "
              f"takes {ms_k6:.2f} ms with K6, {ms_today:.2f} ms with concat + K1b", flush=True)
        if not finite or cos < VELOCITY_COS_TOL:
            raise SystemExit("chip_smoke: the denoise step through K6 disagrees with the step "
                             "through concat + K1b")
    return launches


NCCL_PROBE = """
import datetime, tempfile, torch, torch.distributed as dist
d = tempfile.mkdtemp()
dist.init_process_group("nccl", init_method="file://" + d + "/rendezvous", world_size=1, rank=0,
                        timeout=datetime.timedelta(seconds=60))
t = torch.ones(4, device="cuda")
dist.all_reduce(t)
parts = [torch.empty_like(t)]
dist.all_gather(parts, t)
torch.cuda.synchronize()
assert parts[0].sum().item() == 4.0
dist.destroy_process_group()
print("ok")
"""


def run_sp_generation(inf: InterleaveInferencer, mesh, plain_rows: dict) -> dict:
    """The sequence-parallel denoise path on the 1 x 1 mesh of one-rank NCCL
    groups: the text-to-image request and the edit through an inferencer with
    ``sp_mesh``, by the default route (the captured ``sp_denoise.SPProgram``,
    every collective in its graphs), timed beside ``plain_rows`` (the same
    requests without it, earlier in this run); then the path against the
    single-device one on the same inputs: the final latent of the
    text-to-image request's denoise (all 49 steps) against
    ``bagel.generate_latents`` on its contexts and noise and against the same
    denoise by the eager loop (``graphs=False``, bit for bit; timed: ms per
    step both ways), and the first post-CFG velocity, the latter also against
    the plain versions."""
    sp_inf = InterleaveInferencer(inf.model, inf.tokenizer, inf.new_token_ids,
                                  vit_transform=inf.vit_transform, seed=SEED, sp_mesh=mesh)
    if not programs.use_graphs(None, torch.device("cuda"), inf.model, mesh):
        raise SystemExit("chip_smoke: the NCCL sp_mesh does not take the SP program")
    captures = (programs.stats["captures"], programs.stats["collective_captures"])
    calls = []  # each full-depth SP denoise of the requests: its inputs and its latent
    tp_sp = sp_denoise.generate_latents_tp_sp

    def recorded(model, caches, positions, pos_ids, x_t, se, sp_mesh, **kw):
        noise = x_t.clone()
        out = tp_sp(model, caches, positions, pos_ids, x_t, se, sp_mesh, **kw)
        if kw.get("num_timesteps") == 50:
            calls.append((model, caches, positions, pos_ids, noise, se, kw, out))
        return out

    sp_denoise.generate_latents_tp_sp = recorded
    try:
        launches, rows = run_generation(sp_inf)
    finally:
        sp_denoise.generate_latents_tp_sp = tp_sp
    for name, row in rows.items():
        base = plain_rows[name]
        print(f"  {name}: " + "; ".join(
            f"{key} {row[key]:.3f} with sp_mesh (graphed), {base[key]:.3f} without"
            for key in ("s_per_image", "denoise_s", "ms_per_3_stream_step",
                        "ms_per_1_stream_step")) + f" ({CARD})", flush=True)
    print(f"  SP programs: {programs.stats['captures'] - captures[0]} captures, of which "
          f"{programs.stats['collective_captures'] - captures[1]} hold collectives", flush=True)
    # the text-to-image request's own denoise against the single-device loop on its inputs
    model, caches, positions, pos_ids, noise, se, kw, x_sp = calls[0]
    # ... and against the eager loop on the same inputs, timed (one rank: the same sums)
    timer = SPStepTimer(model.language_model.model)
    n = pmesh.counts["collectives"]
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x_eager = tp_sp(model, caches, positions, pos_ids, noise, se, mesh,
                        **dict(kw, graphs=False))
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
    finally:
        timer.remove()
    collectives = pmesh.counts["collectives"] - n
    eager_ms = {k: 1e3 * statistics.median(b - a for a, b, st in timer.steps if st == k)
                for k in (3, 1) if any(st == k for _, _, st in timer.steps)}
    row = rows["text-to-image"]
    cos = _cosine(x_sp, x_eager)
    print(f"  text-to-image denoise, graphed vs eager SP loop: final latent equal "
          f"{torch.equal(x_sp, x_eager)}, cosine {cos:.6f}, max abs "
          f"{(x_sp - x_eager).abs().max().item():.3g}; denoise s {row['denoise_s']:.3f} graphed, "
          f"{eager_s:.3f} eager ({collectives} collectives); ms per 3-stream step "
          f"{row['ms_per_3_stream_step']:.2f} graphed / {eager_ms.get(3, float('nan')):.2f} eager "
          f"/ {plain_rows['text-to-image']['ms_per_3_stream_step']:.2f} one device; 1-stream "
          f"{row['ms_per_1_stream_step']:.2f} / {eager_ms.get(1, float('nan')):.2f} / "
          f"{plain_rows['text-to-image']['ms_per_1_stream_step']:.2f} ({CARD})", flush=True)
    if not torch.equal(x_sp, x_eager):  # the same kernels on the same inputs, in one order
        raise SystemExit("chip_smoke: the captured SP denoise differs from the eager loop")
    x_one = bagel.generate_latents(model, caches, positions, pos_ids, noise, se, **kw)
    cos, finite = _cosine(x_sp, x_one), bool(torch.isfinite(x_sp).all())
    moved = (x_one - noise).std().item()
    print(f"end to end (text-to-image {GEN_SIZE[0]}x{GEN_SIZE[1]}, 49 steps, the request's "
          "contexts and noise): "
          f"final latent [n, 64] of generate_latents_tp_sp vs generate_latents: cosine "
          f"{cos:.6f}, max abs {(x_sp - x_one).abs().max().item():.4f} (latent std "
          f"{x_one.std().item():.3f}, of which the denoise moved {moved:.3f}), cosine of the "
          f"two displacements from the noise {_cosine(x_sp - noise, x_one - noise):.6f}, "
          f"finite {finite}", flush=True)
    if not finite or x_sp.shape != noise.shape or cos < VELOCITY_COS_TOL:
        raise SystemExit("chip_smoke: the sequence-parallel denoise's latent disagrees with "
                         "the single-device denoise's")
    got = check_velocity_against_plain(inf, mesh)["kernels"]
    cos = _cosine(got, _first_step_velocity(inf))
    print(f"    vs the single-device kernel path's velocity: cosine {cos:.6f}", flush=True)
    if cos < VELOCITY_COS_TOL:
        raise SystemExit("chip_smoke: the sequence-parallel path's velocity disagrees with the "
                         "single-device path's")
    return launches


# ---------------------------------------------------------------------------
# serving over a device mesh (M13, serving side)
# ---------------------------------------------------------------------------

SHARD_TPS = (2, 4)  # the "model" degrees whose per-rank kernel shapes are checked
# K3's second entry: decode and the batcher's streams (the cluster route), a 378 px block, the
# 3-stream denoise and the 980 px image prefill (the ring)
K3_GLOBAL_ROWS = (1, 8, 16, 731, 3078, 4902)


def check_shard_shapes(g, randn, ints) -> dict:
    """The kernels at the shapes one rank of a tensor-parallel mesh gives
    them at the 14B width, tp 2 and 4 (28 / 4 heads: 14 / 2 and 7 / 1 a
    rank): K1a at the 980 px image prefill (T 5122 over 5632 columns); K2
    and K2-int8 at the chat decode (S 1, lens 4950) and at run A's 16
    streams (band (lens, lens)); K4 w4a8 (equal) and bf16-x at the four
    projections' shards (qkv N 2304 / 1152, gate_up N 18944 / 9472, o K 1792
    / 896, down K 9472 / 4736) at m 1, 16, 4902, per channel, with groups of
    512 where the columns split (a row-parallel shard of o or down splits a
    group of 512: the placement refuses it) and with groups of 32 at the down
    shards (which split no group of 32); K3's second entry (the scale
    pass and the quantize pass) at R 1, 8, 16, 731, 3078, 4902 over I 9472 /
    4736, against its plain version and, without a reduction, equal to the
    first entry; at R <= 16 also in a CUDA graph of 20. Each row: time, plain
    time, bound, library time.
    Returns {kernel: rows} (``shard_cases`` in the kernels line) and the
    ``kernels`` line's row of K3's second entry."""
    print("kernels at the per-rank shapes of tensor parallelism (tp 2 and 4):", flush=True)
    out = {k: [] for k in ("flash_block_attention", "decode_attention", "decode_attention_int8",
                           "w4_matmul", "silu_mul_quant_global")}
    M, T, n_img = 5632, 5122, 4902
    jk = torch.arange(M, device="cuda")
    for tp in SHARD_TPS:
        H, Hk = 28 // tp, max(1, 4 // tp)
        q = randn(1, T, H, 128, scale=2.0)
        kc, vc = randn(1, Hk, M, 128), randn(1, Hk, M, 128)
        zero, qvl = ints(0), ints(n_img)
        name = f"K1a image prefill tp {tp}: T={T} M={M} {H}/{Hk} heads"
        r = _compare(name, lambda: fa.flash_block_attention(q, kc, vc, zero, zero, False, qvl,
                                                            True),
                     lambda: fa.flash_block_attention_ref(q, kc, vc, zero, zero, False, qvl,
                                                          True), n_img, back_to_back=False)
        r.update(attention_bound([n_img], [n_img], H, Hk, 128, 2, "bf16"))
        r["library_ms"] = sdpa_ms(q, kc, vc, (jk < n_img)[None, None].expand(1, T, M))
        r.pop("ms_back_to_back")
        out["flash_block_attention"].append(dict(case=name, **r))
        del q, kc, vc
        for S, lens, Mc in ((1, (4950,), M), (16, SERVE_LENS, SERVE_CAPACITY)):
            qd = randn(S, 1, H, 128, scale=2.0)
            ln = ints(*lens)
            band = (ln, ln)
            keys = [n + 1 for n in lens]
            kb, vb = randn(S, Hk, Mc, 128), randn(S, Hk, Mc, 128)
            name = f"K2 decode tp {tp}: S={S} {H}/{Hk} heads M={Mc}"
            kern = lambda: dec.decode_attention(qd, kb, vb, ln, band)  # noqa: E731
            r = _compare(name, kern, lambda: dec.decode_attention_ref(qd, kb, vb, ln, band), 1)
            r["ms_in_graph"] = graph_ms(kern)
            r.update(attention_bound([1] * S, keys, H, Hk, 128, 2, "bf16"))
            mask = (torch.arange(Mc, device="cuda")[None] <= ln[:, None].long())[:, None]
            r["library_ms"] = sdpa_ms(qd, kb, vb, mask)
            out["decode_attention"].append(dict(case=name, **r))
            k8, v8 = _rand_int8(g, S, Hk, Mc, 128), _rand_int8(g, S, Hk, Mc, 128)
            ks = torch.rand(S, Hk, Mc, generator=g, device="cuda") * 0.02 + 0.002
            vs = torch.rand(S, Hk, Mc, generator=g, device="cuda") * 0.02 + 0.002
            name = f"K2-int8 decode tp {tp}: S={S} {H}/{Hk} heads M={Mc}"
            kern = lambda: dec.decode_attention(qd, k8, v8, ln, band, k_scale=ks,  # noqa: E731
                                                v_scale=vs)
            r = _compare(name, kern, lambda: dec.decode_attention_ref(qd, k8, v8, ln, band, ks,
                                                                      vs), 1, row_atol=True)
            r["ms_in_graph"] = graph_ms(kern)
            r.update(attention_bound([1] * S, keys, H, Hk, 128, 1, "bf16", scales=True))
            r["library_ms"] = None  # no PyTorch attention call reads an int8 cache with scales
            out["decode_attention_int8"].append(dict(case=name, **r))
            del kb, vb, k8, v8
        for proj, K, N, column in (("qkv", 3584, 4608 // tp, True),
                                   ("gate_up", 3584, 37888 // tp, True),
                                   ("o", 3584 // tp, 3584, False),
                                   ("down", 18944 // tp, 3584, False)):
            wp = w4.pack_int4(_rand_int8(g, N, K, lo=-8, hi=8))
            # groups of 512 where the columns split; groups of 32 at the down shard, which
            # splits a group of 512 but not one of 32
            groups = (0, K // W4_GROUP) if column else (0, K // W4_G32) if proj == "down" \
                else (0,)
            for G in groups:
                ws = torch.rand((G, N) if G else (N,), generator=g, device="cuda") * 0.01 + 0.001
                kind = f"group {K // G}" if G else "per channel"
                for m in (1, 16, 4902):
                    x = _rand_int8(g, m, K)
                    xs = torch.rand(m, 1, generator=g, device="cuda") * 0.05 + 0.001
                    got, route = _k4_route_call(x, xs, wp, ws)
                    torch.cuda.synchronize()
                    want = _k4_want(x, xs, wp, ws)
                    ms = cuda_ms(lambda: w4.w4_matmul(x, xs, wp, ws), warmup=1, iters=5)
                    plain_ms = cuda_ms(lambda: w4.w4_matmul_ref(x, xs, wp, ws), warmup=1,
                                       iters=2)
                    b = k4_bound(m, K, N, G, True)
                    name = f"K4 w4a8 tp {tp} {proj} m={m} K={K} N={N} {kind}"
                    _line(name, f"{route}: equal {torch.equal(got, want)}", ms, plain_ms, b)
                    if not torch.equal(got, want):
                        raise SystemExit(f"chip_smoke: {name} differs from its plain version")
                    out["w4_matmul"].append(dict(case=name, max_abs_err=0.0, ms=ms,
                                                 plain_ms=plain_ms, library_ms=None, **b))
                    xb = randn(m, K)
                    got = _k4_route_call(xb, None, wp, ws)[0].float()
                    torch.cuda.synchronize()
                    want = w4.w4_matmul_ref(xb, None, wp, ws).float()
                    tol = (2.0**-7 * want.abs()
                           + 1e-3 * K**0.5 * 8 * xb.float().abs().max() * ws.max() / 16)
                    err = (got - want).abs()
                    worst = (err / tol).max().item()
                    ms = cuda_ms(lambda: w4.w4_matmul(xb, None, wp, ws), warmup=1, iters=5)
                    plain_ms = cuda_ms(lambda: w4.w4_matmul_ref(xb, None, wp, ws), warmup=1,
                                       iters=2)
                    b = k4_bound(m, K, N, G, False)
                    name = f"K4 w4 bf16-x tp {tp} {proj} m={m} K={K} N={N} {kind}"
                    _line(name, f"max abs err {err.max().item():.3e}, worst err/bound "
                          f"{worst:.3f}", ms, plain_ms, b)
                    if worst > 1.0:
                        raise SystemExit(f"chip_smoke: {name} disagrees with its plain version")
                    out["w4_matmul"].append(dict(case=name, max_abs_err=err.max().item(), ms=ms,
                                                 plain_ms=plain_ms, library_ms=None, **b))
            del wp
        I = 18944 // tp
        t0 = time.perf_counter()
        for R in K3_GLOBAL_ROWS:
            gu = randn(R, 2 * I, scale=2.0)  # the halves of a fused gate_up shard's output
            gate, up = gu.split(I, dim=-1)
            q8, sc = aq.silu_mul_quant_global(gate, up, None)
            torch.cuda.synchronize()
            q_ref, sc_ref = aq.silu_mul_quant_global_ref(gate, up, None)
            step = (q8.int() - q_ref.int()).abs()
            share = (step > 0).float().mean().item()
            rel = ((sc - sc_ref).abs() / sc_ref).max().item()
            first_q, first_sc = aq.silu_mul_quant(gate, up)
            same_as_first = bool(torch.equal(first_q, q8) and torch.equal(first_sc, sc))
            kern = lambda: aq.silu_mul_quant_global(gate, up, None)  # noqa: E731
            ms = cuda_ms(kern)
            plain_ms = cuda_ms(lambda: aq.silu_mul_quant_global_ref(gate, up, None), warmup=1,
                               iters=3)
            b2b = back_to_back_ms(kern) if R == 1 else None
            in_graph = graph_ms(kern) if R <= 16 else None
            # the function's least traffic, as the first entry's: g and u read once, q and
            # the scales written; the kernel's two passes read g and u twice and form the
            # product twice, a cost of its design, printed beside it
            b = bound(R * I * 5 + R * 4, R * I * 15, "fp32")
            two_pass = bound(R * I * 9 + R * 4, 2 * R * I * 15, "fp32")["bound_ms"]
            name = f"K3 second entry tp {tp}: R={R} I={I}"
            graph_text = "" if in_graph is None else \
                f"; {in_graph:.4f} ms per call in a CUDA graph of {BACK_TO_BACK}"
            _line(name, f"max step {step.max().item()}, share differing {share:.2e}, scale rel "
                  f"err {rel:.2e}, equal to the first entry's {same_as_first}; the two passes' "
                  f"own bound {two_pass:.4f} ms; {aq.global_plan(R, I, aq._sm_count(0))}", ms,
                  plain_ms, b, _b2b_text(b2b) + graph_text)
            if rel > K3_SCALE_RTOL or step.max().item() > K3_MAX_STEP or share > K3_MAX_SHARE:
                raise SystemExit(f"chip_smoke: {name} disagrees with its plain version")
            if not same_as_first:
                raise SystemExit(f"chip_smoke: {name} without a reduction differs from the "
                                 f"first entry")
            out["silu_mul_quant_global"].append(dict(
                case=name, max_abs_err=float(step.max().item()), ms=ms, plain_ms=plain_ms,
                ms_back_to_back=b2b, ms_in_graph=in_graph, library_ms=None,
                two_pass_bound_ms=two_pass, **b))  # no one PyTorch call
            del gu
        print(f"  [K3 second entry at tp {tp}: {len(K3_GLOBAL_ROWS)} shapes in "
              f"{time.perf_counter() - t0:.1f} s]", flush=True)
    torch.cuda.empty_cache()
    out.update(check_k5_shard_shapes(g))
    rows = out.pop("silu_mul_quant_global")
    main = dict(rows[K3_GLOBAL_ROWS.index(4902)])  # tp 2, R 4902: the image prefill's down shard
    main.pop("case")
    main["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    main["one_row_ms"], main["one_row_ms_back_to_back"] = rows[0]["ms"], rows[0]["ms_back_to_back"]
    main["one_row_ms_in_graph"] = rows[0]["ms_in_graph"]
    main["shard_cases"] = rows
    return out, main


# K5 at a TP-2 rank's heads (14 / 2) on packed layouts like the training batches': (sample
# lens, split lens, modes) at T 4096 (a 512 px edit's latents beside a 378 px VQA) and T 6144
# (a 980 px VQA beside a 512 px edit)
K5_SHARD_LAYOUTS = (
    ([1095, 3001], [40, 1026, 29, 33, 729, 2239], ["causal", "noise", "causal", "causal", "full",
                                                   "causal"]),
    ([4949, 1195], [24, 4900, 25, 40, 1026, 129], ["causal", "full", "causal", "causal", "noise",
                                                   "causal"]),
)


def check_k5_shard_shapes(g) -> dict:
    """K5 (forward, dq, dk/dv) at the heads one rank of a TP-2 training mesh
    gives it at the 14B width (14 / 2), at T 4096 and T 6144, against its
    plain version, timed beside SDPA on the same mask and the card's bound.
    Returns {K5 kernel name: rows} for ``shard_cases``."""
    out = {"packed_train_attention_" + k: [] for k in ("fwd", "bwd_dq", "bwd_dkv")}
    for layout in K5_SHARD_LAYOUTS:
        ids = tuple(torch.from_numpy(a).to(DEVICE) for a in packed_segment_ids(*layout))
        T = ids[0].shape[0]
        rows = _k5_case(f"tp 2 rank, 14/2 heads, T {T}", ids, g, timed=True, heads=(14, 2))
        for key, row in rows.items():
            out["packed_train_attention_" + key].append(dict(case=f"tp 2, 14/2 heads, T {T}",
                                                             **row))
    torch.cuda.empty_cache()
    return out


def one_rank_mesh(axes, rendezvous_dir: str):
    """A mesh of one rank over ``axes`` with a real one-rank NCCL group on
    every axis, so that its all-reduces and gathers really run. The default
    NCCL group starts at the first call, after a child process has shown
    that one can (under a time limit: a communicator that cannot start must
    not hang this run); if NCCL is missing or the probe fails, the run fails
    with the probe's last line. No mesh without groups stands in for it."""
    dist = torch.distributed
    if not dist.is_initialized():
        if not (dist.is_available() and dist.is_nccl_available()):
            raise SystemExit("chip_smoke: NCCL is not built into this torch: the mesh paths "
                             "need a one-rank NCCL group")
        try:
            probe = subprocess.run([sys.executable, "-c", NCCL_PROBE], capture_output=True,
                                   text=True, timeout=120)
            failed = None if probe.returncode == 0 else (
                probe.stderr.strip().splitlines()[-1:] or [f"exit {probe.returncode}"])
        except subprocess.TimeoutExpired:
            failed = ["no answer within 120 s"]
        if failed is not None:
            raise SystemExit(f"chip_smoke: a one-rank NCCL group did not start: {failed[0]}")
        dist.init_process_group(
            "nccl", init_method=f"file://{rendezvous_dir}/rendezvous", world_size=1, rank=0,
            timeout=datetime.timedelta(seconds=120))
    mesh = pmesh.make_mesh(axes, (1,) * len(axes), singleton_groups=True)
    print(f"mesh {dict(mesh.shape)} on a one-rank NCCL group (file:// rendezvous): the path's "
          "collectives really run", flush=True)
    return mesh


CHAT_ROWS = []  # the bf16 chat path's rows (run_main_path), beside the mesh chat's


def _mesh_chat(inf: InterleaveInferencer, mesh) -> dict:
    """The three chat requests through ``InterleaveInferencer(mesh=...)`` on
    the one-rank NCCL mesh over ``inf.model``, by the default route (the
    captured programs, the collectives in their graphs) and then eagerly
    (:func:`run_chat_requests`: answers token for token, launches equal, the
    graphed decode step traced): answer ids equal to chat's without the
    mesh, ms per decode step graphed / eager / without the mesh (56
    all-reduces a step, the embedding's sum and the vocab gather)."""
    minf = InterleaveInferencer(inf.model, inf.tokenizer, inf.new_token_ids,
                                vit_transform=inf.vit_transform, seed=SEED, mesh=mesh)
    if not programs.use_graphs(None, minf.device, minf.model):
        raise SystemExit("chip_smoke: a model on the NCCL mesh does not take its programs")
    images = _images()
    rows = []
    n_vit, n_llm = inf.cfg.vit.num_hidden_layers, inf.cfg.llm.num_hidden_layers
    captures = (programs.stats["captures"], programs.stats["collective_captures"])
    n = pmesh.counts["collectives"]
    launches = run_chat_requests(minf, range(len(REQUESTS)), "the mesh chat path",
                                 lambda f, steps, imgs: {
                                     "flash_block_attention": imgs * (n_vit + n_llm)
                                     + imgs * n_llm,
                                     "decode_attention": steps * n_llm}, all_rows=rows)
    print(f"  mesh chat: {programs.stats['captures'] - captures[0]} captures, of which "
          f"{programs.stats['collective_captures'] - captures[1]} hold collectives; "
          f"{pmesh.counts['collectives'] - n} collectives in all", flush=True)
    for i, (h, w, prompt) in enumerate(REQUESTS):
        want, _ = _chat_steps(inf, images[i], prompt, MAX_LENGTH)
        got, _ = _chat_steps(minf, images[i], prompt, MAX_LENGTH)  # the eager pass's
        print(f"  mesh chat {h}x{w}: {len(got) - 1} tokens, equal to the no-mesh answer "
              f"{got == want}", flush=True)
        if got != want:
            raise SystemExit(f"chip_smoke: the mesh chat's answer {h}x{w} differs from chat's")
    graphed = [r for r in rows if r["route"] == "graphed"]
    eager = [r for r in rows if r["route"] == "eager"]
    for g, e, base in zip(graphed, eager, CHAT_ROWS):
        print(f"  {g['image']}: ms per decode step on the mesh {g['ms_per_decode_step']:.3f} "
              f"graphed, {e['ms_per_decode_step']:.3f} eager ({2 * n_llm} all-reduces over "
              f"'model', the embedding's sum, one vocab gather); "
              f"{base['ms_per_decode_step']:.3f} without the mesh (graphed; not gated) ({CARD})",
              flush=True)
    return launches


def _serve_run_a(inf: InterleaveInferencer, mesh, counted: bool = False, graphs=None):
    """Run A's workload (two waves, the preamble) through a batcher without
    the ladder, with or without ``mesh``, by the route of ``graphs``: (each
    request's ids, seconds, stats, the launches against the forwards when
    ``counted``)."""
    b = ContinuousBatcher(inf.model, inf.tokenizer, inf.new_token_ids, SERVE_SLOTS,
                          SERVE_CAPACITY, SERVE_CHUNK, inf.vit_transform, SEED, mesh=mesh,
                          graphs=graphs)
    got = _recording_ids(b)
    counter = ForwardCounter(b.model) if counted else None  # the rank's model on a mesh
    reset_counts()
    first, later = serving_workload("A")
    eos = b.new_token_ids["eos_token_id"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pid = b.register_prefix(SERVE_PREAMBLE)

    def submit(wave):
        return [b.submit(Request(prompt=p, image=None if a is None else _pil_image(a),
                                 max_new_tokens=SERVE_MAX_NEW,
                                 prefix_id=pid if pre else None)) for a, p, pre in wave]

    rids = submit(first)
    st = b._reset_stats()
    try:
        while b.has_work():
            b._round(st, eos)
            if st["rounds"] == 1:
                rids += submit(later)
        torch.cuda.synchronize()
    finally:
        if counter is not None:
            counter.remove()
    seconds = time.perf_counter() - t0
    if b.errors or any(r not in got for r in rids):
        raise SystemExit(f"chip_smoke: run A (mesh {mesh is not None}): errors {b.errors}")
    launches = None
    if counted:
        n_vit, n_llm = inf.cfg.vit.num_hidden_layers, inf.cfg.llm.num_hidden_layers
        launches = check_counts("run A through ContinuousBatcher(mesh=...)", {
            "flash_block_attention": counter.vit * n_vit + counter.prefill * n_llm,
            "decode_attention": counter.decode * n_llm})
    return [got[r] for r in rids], seconds, st, launches


def _mesh_serving(inf: InterleaveInferencer, mesh) -> dict:
    """Run A's 24 requests through ``ContinuousBatcher(mesh=...)`` by the
    default route (captured chunks and admission blocks, the collectives in
    their graphs), then eagerly (``graphs=False``), and without the mesh
    (the same options, no ladder): equal ids, the launches of the graphed
    mesh run against its forwards."""
    plain, s_plain, _, _ = _serve_run_a(inf, None)
    captures = (programs.stats["captures"], programs.stats["collective_captures"])
    got, s_mesh, st, launches = _serve_run_a(inf, mesh, counted=True)
    captures = (programs.stats["captures"] - captures[0],
                programs.stats["collective_captures"] - captures[1])
    eager, s_eager, _, _ = _serve_run_a(inf, mesh, graphs=False)
    print(f"  run A through ContinuousBatcher(mesh=...): {len(got)} requests, "
          f"{st['emitted_tokens']} tokens in {s_mesh:.2f} s graphed ({captures[0]} captures, "
          f"{captures[1]} holding collectives), {s_eager:.2f} s eager; without the mesh "
          f"{s_plain:.2f} s (graphed); ids equal to the eager route's {got == eager}, to the "
          f"no-mesh run's {got == plain} ({CARD})", flush=True)
    if got != plain or got != eager:
        raise SystemExit("chip_smoke: run A on the mesh answered otherwise than eagerly or "
                         "without it")
    return launches


def _mesh_eval(inf: InterleaveInferencer, mesh) -> None:
    """Run F's bf16 eval through ``run_vqa_eval(mesh=...)``: predictions
    equal to the same call without the mesh (run F's bf16 run, whose
    predictions the eval phase keeps in EVAL_PREDS)."""
    from unimedvl_tpu_torch.eval import vqa

    samples = [dict(image=_pil_image(a), question=p) for a, p in eval_requests()]
    kw = dict(max_new_tokens=EVAL_MAX_NEW, num_slots=EVAL_SLOTS, capacity=EVAL_CAPACITY)
    want, s_want = EVAL_PREDS["bf16 pool"]
    t1 = time.perf_counter()
    got, _ = vqa.run_vqa_eval(inf.model, inf.tokenizer, inf.new_token_ids, samples, mesh=mesh,
                              **kw)
    t2 = time.perf_counter()
    with programs.eager():  # the eval takes no graphs=: its batcher's default, eagerly
        eager, _ = vqa.run_vqa_eval(inf.model, inf.tokenizer, inf.new_token_ids, samples,
                                    mesh=mesh, **kw)
    t3 = time.perf_counter()
    print(f"  run F (bf16 pool) through run_vqa_eval(mesh=...): {len(got)} predictions equal "
          f"to the no-mesh call's {got == want}, to the eager route's {got == eager} "
          f"({t2 - t1:.2f} s graphed, {t3 - t2:.2f} s eager, without the mesh {s_want:.2f} s)",
          flush=True)
    if got != want or got != eager:
        raise SystemExit("chip_smoke: run_vqa_eval on the mesh predicted otherwise")


MESH_GEN_TIMESTEPS = 11  # the grouped mesh request's schedule: 10 steps, both CFG regimes


def _mesh_grouped(inf: InterleaveInferencer, tmp: str) -> dict:
    """One 512 px text-to-image request through ``gen_images_grouped`` (G 1)
    on a 1 x 1 x 1 ("data", "model", "seq") mesh with a one-rank NCCL group
    per axis, by the default route (``sp_denoise.SPProgram``, the
    collectives in its graphs), against the same call on a mesh without
    groups (captured too: no collective), at MESH_GEN_TIMESTEPS: equal
    latents (a one-rank all-reduce of bf16 is exact); and against the NCCL
    mesh's eager loop (``graphs=False``), bit for bit. Launches: a cache
    partial and a block partial (K1c) per layer and step."""
    gmesh = one_rank_mesh(("data", "model", "seq"), tmp)
    plain = pmesh.make_mesh(("data", "model", "seq"), (1, 1, 1))
    ctx = inf.init_gen_context()
    cfg_img, cfg_text = ctx.fork(), ctx.fork()
    ctx = inf.update_context_text(GEN_PROMPT, ctx)
    cfg_img = inf.update_context_text(GEN_PROMPT, cfg_img)
    kw = dict(cfg_text_scale=3.0, cfg_img_scale=1.5, cfg_interval=(0.4, 1.0),
              timestep_shift=3.0, num_timesteps=MESH_GEN_TIMESTEPS)
    out = {}
    n_llm = inf.cfg.llm.num_hidden_layers
    for name, m in (("plain", plain), ("mesh", gmesh), ("eager", gmesh)):
        inf._generator.manual_seed(SEED + 20)
        if name == "mesh":
            reset_counts()
        inf.graphs = False if name == "eager" else None
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[name] = inf.gen_image_latents_grouped(GEN_SIZE, [ctx], m, [cfg_text], [cfg_img],
                                                      **kw)
            torch.cuda.synchronize()
            out[name + "_s"] = time.perf_counter() - t0
        finally:
            inf.graphs = None
        if name == "mesh":
            launches = check_counts(
                "gen_images_grouped on the one-rank mesh",
                {"flash_block_attention_lse": 2 * (MESH_GEN_TIMESTEPS - 1) * n_llm})
    image = inf.decode_image(out["mesh"][0], GEN_SIZE)
    same = torch.equal(out["mesh"], out["plain"])
    cos = _cosine(out["mesh"], out["eager"])
    print(f"  gen_images_grouped G=1 on a 1x1x1 NCCL mesh (graphed): latent "
          f"{tuple(out['mesh'].shape)} equal to the groupless mesh's {same}, to the eager "
          f"loop's {torch.equal(out['mesh'], out['eager'])} (cosine {cos:.6f}), finite "
          f"{bool(torch.isfinite(out['mesh']).all())}, image {image.size}; denoise "
          f"{out['mesh_s']:.2f} s graphed (the first call captures), {out['eager_s']:.2f} s "
          f"eager, without groups {out['plain_s']:.2f} s", flush=True)
    if not same or not torch.equal(out["mesh"], out["eager"]):
        raise SystemExit("chip_smoke: gen_images_grouped on the NCCL mesh differs")
    return launches


TP_RANKS = 2
TP_REQUEST = 0  # the 980x980 chat request
# the TP-2 bf16 logits' cosine bound: 1 - factor x (1 - the one-rank model's bf16-vs-fp32-attention
# cosine measured in the same call), as VELOCITY_COS_TOL was set; the w4a8 run stays at
# LOGITS_COS_TOL (its int8 roundings move with the partial sums' order)
TP_FLOOR_FACTOR = 2.0
TP_W4A8_LENGTH = 8  # the w4a8 answer's length: its launches, not a second answer, are the point


def _tp_gate(name: str, ref_logits: torch.Tensor, ref_steps, got: dict, cos_bound: float
             ) -> float:
    """A TP rank's first-step logits against the one-rank model's (cosine at
    ``cos_bound``, set from the floor measured in the same call), and its
    greedy ids against the one-rank ids up to the first step whose top-2 gap
    lies within NEAR_TIE_FACTOR x the largest first-step logit difference
    (printed). Returns that floor."""
    logits = torch.from_numpy(got["logits"]).to(ref_logits.device)
    cos = torch.nn.functional.cosine_similarity(logits, ref_logits.float(), dim=0).item()
    diff = (logits - ref_logits.float()).abs().max().item()
    floor = NEAR_TIE_FACTOR * diff
    ids, want_ids = got["ids"], ref_steps[0]
    n = 0
    while n < min(len(ids), len(want_ids)) and ids[n] == want_ids[n]:
        n += 1
    tie = next((i for i, ((v1, v2), _) in enumerate(ref_steps[1]) if v1 - v2 <= floor), None)
    print(f"  {name}: first-step logits vs the one-rank model: cosine {cos:.6f} (bound "
          f"{cos_bound:.6f}), max abs {diff:.4f}; ids agree for {n - 1} of {len(want_ids) - 1} "
          f"tokens; the first near-tie step (top-2 gap <= {floor:.4f}) is {tie}", flush=True)
    if cos < cos_bound or not np.isfinite(got["logits"]).all():
        raise SystemExit(f"chip_smoke: {name}: the TP logits disagree with the one-rank model's")
    agree_to = len(want_ids) if tie is None else tie + 1
    if n < min(agree_to, len(ids), len(want_ids)):
        raise SystemExit(f"chip_smoke: {name}: the TP answer parts from the one-rank one at "
                         f"token {n}, before the first near-tie")
    return floor


def run_tp_program(inf: InterleaveInferencer, tmp: str) -> dict:
    """Tensor parallelism over two ranks on this one card: two spawned
    processes joined by gloo (NCCL refuses two ranks on one device), each
    building only its shard of the same seeded weights
    (``tools.dryrun_mesh.random_rank_model``: 14 query and 2 kv heads a rank),
    answer the 980x980 chat request in bf16, then quantize their shards to
    w4a8 per channel in place (fused, int8 KV cache) and answer it again:
    K4's int8-x GEMM and GEMV at the shard shapes, K3's second entry at every
    down (the whole row's scales, all-reduced with MAX). Both ranks are held
    to ``inf.model`` (the one-rank model of the same weights) and its w4a8
    copy: first-step logits, greedy ids up to a near-tie; in w4a8 every
    down input of the first step to the one-rank K3 on the same rows
    (``dryrun_mesh.GlobalScaleCheck``, K3's bounds), beside the control of
    per-rank scales, which must read otherwise. The walls measure gloo's
    staging through the host, not a multi-card figure. The same spawn then
    runs the sharded loader (:func:`_sharded_load_setup`,
    :func:`_check_sharded_load`): one process start, CUDA and gloo group a
    rank for both."""
    from unimedvl_tpu_torch.tools import dryrun_mesh

    h, w, prompt = REQUESTS[TP_REQUEST]
    image = _images()[TP_REQUEST]
    ref_steps = _chat_steps(inf, image, prompt, MAX_LENGTH)
    ref_bf16 = _first_step_logits(inf, image, prompt)
    # the floor: the one-rank logits against the same with every attention in fp32
    fp32 = _with_plain_versions(lambda: _first_step_logits(inf, image, prompt),
                                fp32_attention=True)
    floor_cos = _cosine(ref_bf16.float(), fp32.float())
    cos_bound = 1 - TP_FLOOR_FACTOR * (1 - floor_cos)
    print(f"  TP-2 logits bound: the one-rank first-step logits in bf16 vs with fp32 attention, "
          f"cosine {floor_cos:.6f} (the floor); the ranks are held at 1 - {TP_FLOOR_FACTOR:g} "
          f"(1 - floor) = {cos_bound:.6f}", flush=True)
    del fp32
    vt = inf.vit_transform.resize_transform
    transform = (vt.max_size, vt.min_size, vt.stride, vt.max_pixels)
    load = _sharded_load_setup(inf, tmp)
    # the ranks need the card's memory that the graphs' pool and the programs' caches hold
    programs.drop_all()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"tensor parallelism over {TP_RANKS} processes on this card (gloo: host-staged "
          f"collectives, which no CUDA graph captures, so these ranks run eagerly: "
          f"programs.use_graphs): the {h}x{w} chat request, max_length {MAX_LENGTH}, bf16 then "
          "w4a8; then, in the same processes, the sharded loader", flush=True)
    t0 = time.perf_counter()
    both = pmesh.run_on_ranks(
        dryrun_mesh.tp_chat_and_load_rank, TP_RANKS,
        (full_config(), SEED, image, prompt, (MAX_LENGTH, TP_W4A8_LENGTH), transform),
        (load["ckpt"], load["image"], load["prompt"], transform), timeout_s=900.0)
    wall = time.perf_counter() - t0
    ranks = [r["chat"] for r in both]
    _check_sharded_load(load, [r["load"] for r in both])
    qinf = quantized_inferencer(inf, bits=4, act_quant=True)
    ref_w4a8 = _first_step_logits(qinf, image, prompt)
    del qinf
    torch.cuda.empty_cache()
    n_vit, n_llm = inf.cfg.vit.num_hidden_layers, inf.cfg.llm.num_hidden_layers
    launches = {name: 0 for name in COUNTERS}
    for r, got in enumerate(ranks):
        for mode, ref in (("bf16", ref_bf16), ("w4a8", ref_w4a8)):
            run = got[mode]
            f = run["forwards"]
            forwards = f["prefill"] + f["decode"]
            want = {"flash_block_attention": n_vit + 2 * n_llm,
                    "decode_attention" if mode == "bf16" else "decode_attention_int8":
                        f["decode"] * n_llm,
                    "silu_mul_quant_global": forwards * n_llm if mode == "w4a8" else 0,
                    "w4_matmul": forwards * n_llm * 4 if mode == "w4a8" else 0,
                    "silu_mul_quant": 0, "plain": 0}
            seen = {k: run["launches"].get(k, 0) for k in want}
            row = dict(card=CARD, seconds=run["seconds"], forwards=f, launches=seen,
                       peak_gib=run["peak_gib"])
            print(f"  rank {r} {mode}: {json.dumps(row)}", flush=True)
            if seen != want:
                raise SystemExit(f"chip_smoke: TP rank {r} {mode} launched {seen}, not {want}")
            if mode == "bf16":
                _tp_gate(f"TP rank {r} bf16", ref, ref_steps, run, cos_bound)
            else:
                logits = torch.from_numpy(run["logits"]).to(ref.device)
                cos = torch.nn.functional.cosine_similarity(logits, ref, dim=0).item()
                gs = run["global_scales"]
                print(f"  TP rank {r} w4a8: first-step logits vs the one-rank w4a8 model: "
                      f"cosine {cos:.6f}, max abs {(logits - ref).abs().max().item():.4f}; "
                      f"K3's second entry against the one-rank K3 on the same gathered rows, "
                      f"{gs['calls']} calls, {gs['rows']} rows: max step {gs['max_step']}, "
                      f"share differing {gs['max_share']:.2e}, scale rel err "
                      f"{gs['max_scale_rel']:.2e}; per-rank scales (the control) would read "
                      f"scale rel err {gs['per_rank_max_scale_rel']:.3e}, moving "
                      f"{gs['per_rank_rows_differ']:.1%} of the rows' scales", flush=True)
                if cos < LOGITS_COS_TOL:
                    raise SystemExit("chip_smoke: the TP w4a8 logits disagree")
                # the down input of every layer of the first step is the one-rank model's to
                # K3's bounds; the control shows the check tells per-rank scales apart
                if (gs["calls"] < n_llm or gs["max_step"] > K3_MAX_STEP
                        or gs["max_share"] > K3_MAX_SHARE or gs["max_scale_rel"] > K3_SCALE_RTOL
                        or gs["per_rank_max_scale_rel"] <= K3_SCALE_RTOL):
                    raise SystemExit(f"chip_smoke: TP rank {r} w4a8: the down input's global "
                                     f"scales disagree with the one-rank model's: {gs}")
            if r == 0:
                for k in launches:
                    launches[k] += run["launches"].get(k, 0)
    if not np.array_equal(ranks[0]["bf16"]["logits"], ranks[1]["bf16"]["logits"]):
        raise SystemExit("chip_smoke: the two TP ranks' logits differ")
    print(f"  TP program and sharded loader: {wall:.1f} s for both ranks (one spawn, build "
          f"{ranks[0]['build_s']:.1f} s, {ranks[0]['built_gib']:.2f} GiB a rank after the "
          "build); gloo's host staging, not a multi-card figure", flush=True)
    return launches


LOAD_LAYERS = 2  # the sharded loader's checkpoint: the 14B width, two LLM layers


def _sharded_load_setup(inf: InterleaveInferencer, tmp: str) -> dict:
    """The sharded loader's inputs at the 14B width: ``scripts.make_synthetic_ckpt``
    writes a checkpoint of LOAD_LAYERS LLM layers (bf16, no VAE), and the
    one-rank model of those files gives the reference logits and bytes."""
    from unimedvl_tpu_torch.scripts import make_synthetic_ckpt
    from unimedvl_tpu_torch.tools.dryrun_mesh import first_step_logits, shard_bytes
    from unimedvl_tpu_torch.weights.loader import load_bagel_checkpoint

    ckpt = os.path.join(tmp, "ckpt_tp")
    t0 = time.perf_counter()
    make_synthetic_ckpt.main([ckpt, "--layers", str(LOAD_LAYERS), "--no-vae", "--seed", "5",
                              "--shard-gb", "2"])
    write_s = time.perf_counter() - t0
    image, prompt = _images()[2], REQUESTS[2][2]
    whole = load_bagel_checkpoint(ckpt, device="cuda")
    winf = InterleaveInferencer(whole, inf.tokenizer, inf.new_token_ids,
                                vit_transform=inf.vit_transform, seed=SEED)
    ref = first_step_logits(winf, image, prompt)
    whole_bytes = shard_bytes(whole)
    del winf, whole
    torch.cuda.empty_cache()
    return dict(ckpt=ckpt, image=image, prompt=prompt, ref=ref, whole_bytes=whole_bytes,
                write_s=write_s)


def _check_sharded_load(load: dict, ranks: list) -> None:
    """The sharded loader's ranks (each read its halves:
    ``load_bagel_checkpoint(mesh=...)``, ranges through ``get_slice``): the
    halves' bytes add up to the one-rank load's, each rank's first-step
    logits equal those of the TP program built from the whole load
    (``place_params``) and match the one-rank model of the same files
    (LOGITS_COS_TOL)."""
    ref, whole_bytes = load["ref"], load["whole_bytes"]
    sharded = sum(r["bytes"]["sharded"] for r in ranks)
    print(f"sharded loader ({LOAD_LAYERS}-layer 14B-width checkpoint written in "
          f"{load['write_s']:.1f} s): TP-sharded bytes per rank "
          f"{[r['bytes']['sharded'] for r in ranks]} add up to "
          f"{sharded} (one-rank load {whole_bytes['sharded']}); unsharded bytes per rank "
          f"{[r['bytes']['whole'] for r in ranks]} (one-rank {whole_bytes['whole']}); load "
          f"{[round(r['load_s'], 2) for r in ranks]} s a rank", flush=True)
    if sharded != whole_bytes["sharded"] or any(r["bytes"]["whole"] != whole_bytes["whole"]
                                                for r in ranks):
        raise SystemExit("chip_smoke: the sharded loader's halves do not add up to the whole")
    for i, r in enumerate(ranks):
        same = np.array_equal(r["logits"], r["placed_logits"])
        logits = torch.from_numpy(r["logits"]).to(ref.device)
        cos = torch.nn.functional.cosine_similarity(logits, ref.float(), dim=0).item()
        print(f"  rank {i}: first-step logits equal to the placed whole load's {same}; vs the "
              f"one-rank model of the same files: cosine {cos:.6f}, max abs "
              f"{(logits - ref.float()).abs().max().item():.4f}", flush=True)
        if not same or cos < LOGITS_COS_TOL:
            raise SystemExit("chip_smoke: the sharded load's logits disagree")


def run_mesh_phase(inf: InterleaveInferencer, tmp: str) -> list:
    """The serving paths under ``mesh=`` on a one-rank ("data", "model")
    NCCL mesh over ``inf.model`` (chat, run A through the batcher, run F's
    eval, a grouped text-to-image request), each by the default route (the
    captured programs, every collective in their graphs) against the same
    call by the eager route and without the mesh; then tensor parallelism
    over two processes on the card (gloo: eagerly) and the sharded loader.
    Returns the launches."""
    mesh = one_rank_mesh(("data", "model"), tmp)
    print("mesh paths on a one-rank ('data', 'model') NCCL mesh, full depth and width, by the "
          "captured programs (the default on an NCCL mesh), each against its eager route:",
          flush=True)
    launches = [_mesh_chat(inf, mesh), _mesh_serving(inf, mesh)]
    _mesh_eval(inf, mesh)
    launches.append(_mesh_grouped(inf, tmp))
    torch.cuda.empty_cache()
    launches.append(run_tp_program(inf, tmp))
    return launches


# ---------------------------------------------------------------------------
# the training path
# ---------------------------------------------------------------------------

LORA_SEQ_LEN = 6144  # room for the 980 px VQA example (4900 patches) beside another
LORA_RANK = 16
# the LoRA and QLoRA steps' depth: cut from 28 when run K was added, to keep the smoke inside
# its time limit; the width, the sequence and every gate stay
LORA_LAYERS = 8
FT_SEQ_LEN = 4096
# full fine-tune: bf16 parameter + gradient + two moments + fp32 EMA are 12
# bytes per trained parameter; both experts are 466 M parameters per layer,
# embedding + head 1.09 B, the ViT 0.4 B, so the depth one 80 GB card holds
# beside the activations is cut to:
FT_LAYERS = 4
FT_ACCUM, FT_EMA_DECAY = 2, 0.999
TRAIN_STEPS = 3
# the LoRA step with the kernels against the same step with plain attention
LOSS_REL_TOL = 1e-2
# a replayed training step's loss against the eager forward's on the same batch, parameters and
# noise (the same kernels over the padded and the stripped shapes: they agree to about 1e-6 on the
# first step, against a loss that moves by far more between two batches)
REPLAY_LOSS_RTOL = 1e-3
GRAD_COS_TOL = 0.999
# K5's gradients against the plain version's, per element:
# |err| <= K5_GRAD_RTOL (m + |plain|) + floor, m the largest |plain| of the
# element's row [..., D]: the kernels round p and ds to bf16 for their second
# product. The floor covers what does not shrink with the row's own gradient.
# dk, dv: K5_GRAD_FLOOR M, M the mean of m over the tensor (sums over many
# query rows and the heads of a group). dq: the kernels take dsum = do . out
# from the bf16 output, autograd's softmax backward from unrounded values; the
# difference, about 2^-9 sqrt(sum_d (do_d out_d)^2), reaches dq as
# scale * p * k, so the floor is K5_DSUM_SIGMAS times that with max|k|. It
# matters for rows that see a few keys (out is large, dq nearly zero).
K5_GRAD_RTOL, K5_GRAD_FLOOR, K5_DSUM_SIGMAS = 2.0**-7, 2.0**-4, 6.0
K5_TILE = 64
K5_LONG_T = 4096
DEVICE = "cuda"


def _pil(seed: int, h: int, w: int):
    from PIL import Image

    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


def _shift_letters(text: str, k: int) -> str:
    """``text`` with each ASCII letter moved ``k`` places in the alphabet."""
    def shift(c):
        base = 97 if c.islower() else 65
        return chr((ord(c) - base + k) % 26 + base) if c.isascii() and c.isalpha() else c
    return "".join(map(shift, text))


def train_examples(with_980: bool, variant: int = 0):
    """Synthetic examples of the three tasks at real sizes: VQA at 980 px
    (``with_980``) and 378 px, text-to-image at 512 px, an edit of a 512 px
    image (its source also goes through the ViT, at 504 px). ``variant`` k:
    other images (their seeds moved by 100 k) and each text's letters moved
    k places, so that the examples pack into the same layout (the byte-level
    tokenizer keeps each text's length) with new values."""
    ex = dataset.Example

    def img(seed, h, w):
        return _pil(seed + 100 * variant, h, w)

    def text(t):
        return _shift_letters(t, variant)

    out = [
        ex("vlm_sft", text(REQUESTS[2][2]), image=img(11, 378, 378),
           answer=text("No effusion is seen; both costophrenic angles are sharp.")),
        ex("t2i_pretrain", text(GEN_PROMPT), image=img(12, *GEN_SIZE)),
        ex("unified_edit", text(EDIT_PROMPT), image=img(13, *GEN_SIZE),
           target_image=img(14, *GEN_SIZE)),
    ]
    if with_980:
        out.insert(0, ex("vlm_sft", text(REQUESTS[0][2]), image=img(10, 980, 980),
                         answer=text("A rounded opacity projects over the right lower zone.")))
    return out


def train_batches(model, tok, new_token_ids, with_980: bool, seq_len: int, steps: int = 1,
                  per_step: int = 1, extra=None) -> dataset.Prefetcher:
    """The batches of ``steps`` training steps of ``per_step`` packed batches
    of one sequence each, prepared and copied to the card by the
    prefetcher's worker thread (``dataset.make_place_fn``: with their
    padding, as the step's program takes them). Step k takes the first
    ``per_step`` packs of ``train_examples(with_980, variant=k)``, so every
    step's batches fall in the first step's buckets and a replay of its
    graphs takes new values. ``extra(batch)`` adds arrays to a numpy batch
    before it is placed; the latents come from the model's VAE."""
    from unimedvl_tpu_torch.data.imaging import ImageTransform

    vit, vae = TransformConfig.vit_vqa(), TransformConfig.vae_interactive()

    def packs():
        for k in range(steps):
            it = iter(dataset.PackedBatchIterator(
                train_examples(with_980, k), tok, new_token_ids, model.config,
                ImageTransform(vit.max_size, vit.min_size, vit.stride, vit.max_pixels),
                ImageTransform(vae.max_size, vae.min_size, vae.stride, vae.max_pixels),
                latent_fn=dataset.make_latent_fn(model), batch_size=1, seq_len=seq_len,
                seed=SEED))
            for _ in range(per_step):
                batch = next(it)
                yield batch if extra is None else extra(batch)

    return dataset.Prefetcher(packs(), depth=2, place_fn=dataset.make_place_fn(DEVICE))


class StepBatches:
    """The batches of each step of the training paths that share them: step
    i's ``per_step`` batches are taken from the prefetcher when a path first
    asks for them (the wait printed) and kept for the paths after it."""

    def __init__(self, it: dataset.Prefetcher, per_step: int):
        self.it, self.per_step, self.steps = it, per_step, []

    def __call__(self, i: int) -> list:
        while len(self.steps) <= i:
            t0 = time.perf_counter()
            self.steps.append([next(self.it) for _ in range(self.per_step)])
            print(f"  waited {time.perf_counter() - t0:.3f} s for step {len(self.steps) - 1}'s "
                  f"batch(es) from the prefetcher", flush=True)
        return self.steps[i]


def _segments(seq) -> tuple:
    return seq["mask_document_id"], seq["mask_fn_id"], seq["mask_noise_id"]


def _describe(seq) -> str:
    doc = seq["mask_document_id"]
    return (f"T {doc.shape[0]} ({int((doc > 0).sum())} real tokens in {int(doc.max())} "
            f"documents; und {seq['und_idx'].numel()}, gen {seq['gen_idx'].numel()})")


def _grad_error(got: torch.Tensor, want: torch.Tensor, floor=None):
    got, want = got.float(), want.float()
    m = want.abs().amax(dim=-1, keepdim=True)
    tol = K5_GRAD_RTOL * (m + want.abs()) + (K5_GRAD_FLOOR * m.mean() if floor is None else floor)
    diff = (got - want).abs()
    return (diff / tol).max().item(), diff.max().item()


def _k5_case(name, ids, g, timed: bool, heads=(28, 4)):
    """K5 (forward and the three gradients) against its plain version on one
    set of segment ids, at ``heads`` (query, kv; the LLM's by default); with
    ``timed``, also the three kernels' times, the plain version's, SDPA's and
    the card's bounds."""
    (H, Hk), D = heads, 128
    T = ids[0].shape[0]

    def randn(h):
        return torch.randn(T, h, D, generator=g, device=DEVICE).to(torch.bfloat16)

    q, k, v = (randn(h).requires_grad_(True) for h in (H, Hk, Hk))
    cot = randn(H)

    def run(fn):
        out = fn(q, k, v, *ids)
        grads = torch.autograd.grad(out, (q, k, v), cot)
        return out.detach(), grads

    out, (dq, dk, dv) = run(fat.packed_train_attention)
    torch.cuda.synchronize()
    ref, (rq, rk, rv) = run(fat.packed_train_attention_ref)
    diff = (out.float() - ref.float()).abs()
    worst = (diff / (ATOL + RTOL * ref.float().abs())).max().item()
    dsum_spread = (cot.float() * ref.float()).square().sum(dim=-1, keepdim=True).sqrt()
    dq_floor = K5_DSUM_SIGMAS * D**-0.5 * 2.0**-9 * dsum_spread * k.detach().abs().max().float()
    errs = {"out": (worst, diff.max().item()), "dq": _grad_error(dq, rq, dq_floor),
            "dk": _grad_error(dk, rk), "dv": _grad_error(dv, rv)}
    finite = all(bool(torch.isfinite(t).all()) for t in (out, dq, dk, dv))
    mask = dense_packed_mask(*ids)
    n = -(-T // K5_TILE)
    tiles = torch.zeros((n * K5_TILE, n * K5_TILE), dtype=torch.bool, device=DEVICE)
    tiles[:T, :T] = mask
    live = tiles.view(n, K5_TILE, n, K5_TILE).any(dim=3).any(dim=1).float().mean().item()
    pairs = int(mask.sum())
    print(f"  K5 {name}: T {T}, {pairs} allowed pairs ({pairs / T**2:.3f} of T^2), "
          f"{1 - live:.3f} of the {K5_TILE}x{K5_TILE} tile pairs skipped; worst err/bound "
          + ", ".join(f"{key} {w:.3f} (max abs {a:.3e})" for key, (w, a) in errs.items())
          + f", finite {finite}", flush=True)
    if not finite or any(w > 1.0 for w, _ in errs.values()) or diff.mean().item() > MEAN_ABS_TOL:
        raise SystemExit(f"chip_smoke: K5 {name} disagrees with its plain version")
    rows = {"fwd": dict(max_abs_err=errs["out"][1]), "bwd_dq": dict(max_abs_err=errs["dq"][1]),
            "bwd_dkv": dict(max_abs_err=max(errs["dk"][1], errs["dv"][1]))}
    if not timed:
        return rows
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    o, lse, plan = fat._launch_fwd(qd, kd, vd, *ids)
    calls = {
        # the forward call includes the plan launch (tile classes, lists, order)
        "fwd": lambda: fat._launch_fwd(qd, kd, vd, *ids),
        # each backward call includes the row launch (lse2, dsum = do . out)
        "bwd_dq": lambda: fat._launch_bwd(qd, kd, vd, o, lse, plan, cot, True, False),
        "bwd_dkv": lambda: fat._launch_bwd(qd, kd, vd, o, lse, plan, cot, False, True),
    }
    # plain version: the forward, and one backward pass that yields all three gradients
    plain_fwd = cuda_ms(lambda: fat.packed_train_attention_ref(qd, kd, vd, *ids), 1, 3)
    pref = fat.packed_train_attention_ref(q, k, v, *ids)
    plain_bwd = cuda_ms(lambda: torch.autograd.grad(pref, (q, k, v), cot, retain_graph=True), 1, 3)
    del pref
    # one library call: SDPA with the dense bool mask, K/V expanded to the query heads
    G = H // Hk
    qh, kh, vh = (t.detach().repeat_interleave(rep, dim=1).transpose(0, 1)[None]
                  .contiguous().requires_grad_(True) for t, rep in ((q, 1), (k, G), (v, G)))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_fwd = cuda_ms(lambda: sdpa(qh.detach(), kh.detach(), vh.detach(),
                                   attn_mask=mask[None, None]), 1, 5)
    lout = sdpa(qh, kh, vh, attn_mask=mask[None, None])
    lcot = cot.transpose(0, 1)[None].contiguous()
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(lout, (qh, kh, vh), lcot, retain_graph=True),
                      1, 5)
    del lout
    qb, kb, stat, idb = T * H * D * 2, T * Hk * D * 2, H * T * 4, 3 * T * 4
    work = {  # bytes for the operands once; products over the allowed pairs only
        "fwd": (2 * qb + 2 * kb + stat + idb, 4.0 * D * pairs * H),          # S, P V
        "bwd_dq": (3 * qb + 2 * kb + 2 * stat + idb, 6.0 * D * pairs * H),   # S, dP, dS K
        "bwd_dkv": (2 * qb + 4 * kb + 2 * stat + idb, 8.0 * D * pairs * H),  # S, dP, P^T dO, dS^T Q
    }
    for key, fn in calls.items():
        rows[key].update(ms=cuda_ms(fn), ms_back_to_back=back_to_back_ms(fn),
                         plain_ms=plain_fwd if key == "fwd" else plain_bwd,
                         library_ms=lib_fwd if key == "fwd" else lib_bwd,
                         tiles_skipped=1 - live, **bound(*work[key], "bf16"))
        r = rows[key]
        print(f"    {key}: kernel {r['ms']:.3f} ms ({r['ms_back_to_back']:.3f} ms per call in a "
              f"run of {BACK_TO_BACK}), plain {r['plain_ms']:.3f} ms, SDPA (dense bool mask) "
              f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']}"
              + ("" if key == "fwd" else " [plain and SDPA: one backward pass, all three "
                 "gradients]"), flush=True)
    return rows


def check_packed_train_attention(ft_seq, lora_seq) -> dict:
    """K5 against its plain version at the LLM's heads (H 28, Hk 4, D 128), on
    the segment ids of the batches the training phases run and on layouts
    chosen to be awkward. The timings kept for the ``kernels`` line are those
    of the full fine-tune's first sequence (T 4096)."""
    print(f"K5 packed training attention (forward as the attention tolerance above; gradients "
          f"|err| <= {K5_GRAD_RTOL} (m + |ref|) + floor per element, m the largest |ref| of the "
          f"row; floor {K5_GRAD_FLOOR} mean(m) for dk, dv and {K5_DSUM_SIGMAS} / sqrt(D) 2^-9 "
          f"|do * out| max|k| for dq):", flush=True)
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 6)

    def layout(sample_lens, split_lens, modes):
        return tuple(torch.from_numpy(a).to(DEVICE) for a in
                     packed_segment_ids(sample_lens, split_lens, modes))

    shown = _k5_case(f"the full fine-tune's first sequence, {_describe(ft_seq)}",
                     _segments(ft_seq), g, timed=True)
    rows = [shown, _k5_case(f"the LoRA phase's first sequence, {_describe(lora_seq)}",
                            _segments(lora_seq), g, timed=True)]
    rows.append(_k5_case(
        "causal, full and noise spans in two documents, span edges inside tiles",
        layout([384, 384], [128, 128, 128, 64, 192, 128],
               ["causal", "full", "noise", "causal", "noise", "full"]), g, False))
    rows.append(_k5_case("T not a multiple of the tile",
                         layout([150, 111], [60, 90, 111], ["causal", "noise", "causal"]), g,
                         False))
    rows.append(_k5_case("one long causal document", layout([K5_LONG_T], [K5_LONG_T], ["causal"]), g, False))
    out = {}
    for key in ("fwd", "bwd_dq", "bwd_dkv"):
        out["packed_train_attention_" + key] = dict(
            shown[key], max_abs_err=max(r[key]["max_abs_err"] for r in rows))
    return out


def _checksums(named) -> dict:
    """An exact, order-free checksum of every tensor's bits (the int64 sum of
    its 8-, 16- or 32-bit words): any update of a tensor changes it."""
    words = {1: torch.int8, 2: torch.int16, 4: torch.int32}
    return {n: int(torch.sum(p.detach().view(words[p.element_size()]), dtype=torch.int64))
            for n, p in named}


def _draw_noises(seqs, g):
    """One flow-noise draw per sequence with latents, of its real rows (as the
    eager step draws it; a padded sequence's program copies it into its real
    rows)."""
    return [torch.randn((s.vae_rows if bagel.is_padded(s) else s["vae_clean_tokens"].shape[0],
                         s["vae_clean_tokens"].shape[1]), generator=g, device=DEVICE)
            if "vae_clean_tokens" in s else None for s in seqs]


def _loss_and_grads(model, seqs, noises):
    loss, _ = trainer.loss_fn(model, seqs, noises, backward_scale=1.0)
    grads = {n: p.grad.float() for n, p in model.named_parameters() if p.grad is not None}
    for p in model.parameters():
        p.grad = None
    return float(loss), grads


STEP_STATS = {}  # path -> its steps' s/step graphed and eager, packed tokens/s, peak GiB, graphs


def _trained_named(state) -> list:
    names = {id(p): n for n, p in state.model.named_parameters()}
    return [(names[id(p)], p) for g in state.optimizer.param_groups for p in g["params"]]


def _dot_cosine(pairs) -> float:
    """The cosine of two tensor lists joined, from per-tensor fp32 dots on the
    card summed in float64 on the host; 1 when both are zero (a tensor that
    no gradient reaches, as the ViT under ``freeze_und``)."""
    dot = na = nb = 0.0
    for a, b in pairs:
        a, b = a.float().flatten(), b.float().flatten()
        dot += float(torch.dot(a, b))
        na += float(torch.dot(a, a))
        nb += float(torch.dot(b, b))
    if na == nb == 0.0:
        return 1.0
    return dot / max(math.sqrt(na * nb), 1e-300)


def _eager_reference(step, state, batch, noises, names=None):
    """One eager step of ``step``'s kind (its accumulation and EMA) on
    ``batch`` (stripped sequences) from ``state``, which must be fresh, then
    the state put back as it was (parameters, EMA, optimizer, step,
    batch-norm state). Returns (the loss, the AdamW first moment of each
    trained tensor, or of ``names``, by name, the step's seconds)."""
    if state.step:
        raise ValueError("the eager reference puts the state back to a fresh one: give it one")
    trained = _trained_named(state)
    keep = {n: p.detach().clone() for n, p in trained}
    bn = None if state.bn_state is None else (state.bn_state.mean.clone(),
                                              state.bn_state.var.clone())
    eager = trainer.TrainStep(step.accum_steps, step.ema_decay, graphs=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, loss = eager(state, batch, noises=noises)
    loss = float(loss)
    seconds = time.perf_counter() - t0
    moments = {n: m.clone() for n, m in _moments(state, names).items()}
    with torch.no_grad():
        for n, p in trained:
            p.copy_(keep[n])
            if state.ema_params is not None:  # a fresh EMA equals the parameters
                state.ema_params[n].copy_(keep[n])
    state.optimizer.state.clear()
    state.step = 0
    if bn is not None:
        state.bn_state = e2e_vae.BatchNormState(mean=bn[0].clone(), var=bn[1].clone())
    return loss, moments, seconds


def _moments(state, names=None) -> dict:
    """Each trained tensor's AdamW first moment by name (of ``names``)."""
    return {n: state.optimizer.state[p]["exp_avg"] for n, p in _trained_named(state)
            if (names is None or n in names) and p in state.optimizer.state}


def _gate_against_eager(path: str, loss: float, loss_e: float, got: dict, ref: dict, b1: float,
                        watch=None):
    """The program's first step against the eager step from the same state
    on the same noise: the loss within LOSS_REL_TOL, the AdamW first moments
    (``got`` the program's, ``ref`` the eager step's: (1 - b1) times the mean
    gradient) at GRAD_COS_TOL over every tensor of ``ref`` joined, or each of
    ``watch``."""
    pairs = {n: (ref[n], got[n]) for n in ref}
    if watch is None:
        cos, what = _dot_cosine(pairs.values()), f"{len(pairs)} tensors joined"
    else:
        per = {n: _dot_cosine([pairs[n]]) for n in watch}
        worst = min(per, key=per.get)
        cos, what = per[worst], f"the worst of {len(per)} watched, {worst}"
    print(f"  {path}, the program's first step against the eager step (same state and noise): "
          f"loss {loss:.5f} vs {loss_e:.5f}; AdamW first moments (1 - {b1}) g: cosine "
          f"{cos:.6f} ({what})", flush=True)
    if not (abs(loss - loss_e) <= LOSS_REL_TOL * abs(loss_e) and cos >= GRAD_COS_TOL):
        raise SystemExit(f"chip_smoke: {path}: the program's step disagrees with the eager step")


def _uncounted(fn):
    """fn() with the kernels' counters left as they were (launches made to
    check a step, not the main path's)."""
    saved = [(c, dict(c)) for c, _key in COUNTERS.values()]
    try:
        return fn()
    finally:
        for c, old in saved:
            c.update(old)


def _forward_loss(model, taken, noises, bn_state=None) -> float:
    """The loss a step computes on ``taken`` (its batches, each the mean over
    its sequences; their mean) at the current parameters, by the eager
    forward on the stripped sequences, without gradients."""
    with torch.no_grad():
        return float(np.mean([float(trainer.loss_fn(model, b, n, bn_state=bn_state)[0])
                              for b, n in zip(taken, noises)]))


def _gate_replay(path: str, i: int, loss: float, want: float, captured: int, taken,
                 before, rtol: float = REPLAY_LOSS_RTOL) -> None:
    """A step after the first: it replayed the first step's graphs (none
    captured) on batches with new values (``before``: the step's before), and
    its loss is the eager forward's on the same batches, parameters and
    noise (``want``) within ``rtol``."""
    new = sorted({k for b, p in zip(taken, before) for k in b[0]
                  if not torch.equal(b[0][k], p[0][k])})
    print(f"  {path}, step {i}: {captured} graphs captured, inputs with new values {new}; loss "
          f"{loss:.6f} vs the eager forward's {want:.6f} on the same batch, parameters and noise "
          f"(rel {abs(loss - want) / abs(want):.2e})", flush=True)
    if captured or not new or not abs(loss - want) <= rtol * abs(want):
        raise SystemExit(f"chip_smoke: {path}: step {i} did not replay its graphs on new values "
                         "to the eager forward's loss")


def _run_steps(step, state, batches, g, n_llm: int, n_vit: int, path: str, frozen_vit: bool,
               quant_launches=None, watch=None):
    """The path's TRAIN_STEPS steps, the counters reset just before; step i
    takes ``batches(i)`` (a list of ``per_step`` batches, :class:`StepBatches`).
    Step 0: one eager step with the state then put back
    (:func:`_eager_reference`), then the step by its program, which captures
    its graphs, gated against the eager step (:func:`_gate_against_eager`).
    Steps 1..: the prefetcher's next batches, in the first step's buckets
    with new values, the flow noise drawn by the step from ``g``: each
    replays the graphs and is gated against the eager forward on the same
    batch (:func:`_gate_replay`). Checks the launches: with per-layer
    recomputation the forward kernel runs twice per layer and sequence, each
    backward kernel once; a frozen ViT goes through K1a, a trained one
    through plain attention; ``quant_launches(seq)``: the K3 / K4 launches a
    sequence adds (a padded sequence runs each expert on its padded rows).
    Keeps the numbers in STEP_STATS[path]. Returns (state, launches)."""
    first = batches(0)
    per_step = len(first)

    def arg(x):
        return x if per_step > 1 else x[0]

    stripped = [trainer.prepared(b, DEVICE, False) for b in first]
    noises = [_draw_noises(b, g) for b in first]
    tokens = sum(s["mask_document_id"].shape[0] for b in first for s in b)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    loss_e, ref, t_eager = _eager_reference(step, state, arg(stripped), arg(noises), watch)
    seqs = [s for b in stripped for s in b]
    times = []
    caps0, cap_s0 = programs.stats["captures"], programs.stats["capture_s"]
    for i in range(TRAIN_STEPS):
        taken = batches(i)
        want = None
        if i:  # the noise the step draws, from a copy of its generator
            twin = torch.Generator(device=DEVICE)
            twin.set_state(g.get_state())
            want = _uncounted(lambda: _forward_loss(
                state.model, taken, [_draw_noises(b, twin) for b in taken]))
        caps = programs.stats["captures"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, arg(taken), generator=g,
                           noises=arg(noises) if i == 0 else None)
        loss = float(loss)  # waits for the card
        times.append(time.perf_counter() - t0)
        seqs += [s for b in taken for s in b]
        print(f"  graphed step {i}: loss {loss:.4f}; {per_step} batch(es), {tokens} packed "
              f"tokens; {times[-1]:.3f} s ({programs.stats['captures'] - caps} graphs captured), "
              f"{tokens / times[-1]:.0f} packed tokens/s", flush=True)
        if not np.isfinite(loss):
            raise SystemExit(f"chip_smoke: {path}: the loss is not finite")
        if i == 0:
            _gate_against_eager(path, loss, loss_e, _moments(state, ref), ref,
                                state.optimizer.param_groups[0]["betas"][0], watch)
        else:
            _gate_replay(path, i, loss, want, programs.stats["captures"] - caps, taken,
                         batches(i - 1))
    del ref
    peak = torch.cuda.max_memory_allocated() / 2**30
    graphed = statistics.median(times[1:]) if len(times) > 1 else times[0]
    # the eager step is the fresh state's first (its one-time costs inside, as the capturing
    # step's are): tools/profile_train_step.py times both routes in their steady state
    STEP_STATS[path] = dict(
        card=CARD, s_per_step_graphed=graphed, s_capture_step=times[0],
        s_first_eager_step=t_eager, packed_tokens_per_s_graphed=tokens / graphed,
        peak_gib=peak, captures=programs.stats["captures"] - caps0,
        capture_s=programs.stats["capture_s"] - cap_s0,
        train_pool_bytes=programs.pool_bytes(pool="train"))
    print(f"  {path}: eager step {t_eager:.3f} s (loss {loss_e:.4f}); "
          f"{json.dumps(STEP_STATS[path])}", flush=True)
    extra = {}
    for seq in seqs:
        for k, v in (quant_launches(seq) if quant_launches else {}).items():
            extra[k] = extra.get(k, 0) + v
    n_seq, n_vit_seq = len(seqs), sum("vit_patch_tokens" in q for q in seqs)
    launches = check_counts(path, {
        "packed_train_attention_fwd": 2 * n_llm * n_seq,
        "packed_train_attention_bwd_dq": n_llm * n_seq,
        "packed_train_attention_bwd_dkv": n_llm * n_seq,
        "flash_block_attention": n_vit * n_vit_seq if frozen_vit else 0,
        **extra,
    })
    return state, launches


def _grad_cosines(grads_a, grads_b) -> tuple:
    """(cosine over every adapter gradient, {lora_b name: its cosine})."""
    names = sorted(grads_a)
    flat_a = torch.cat([grads_a[n].flatten() for n in names])
    flat_b = torch.cat([grads_b[n].flatten() for n in names])
    per = {n: _cosine(grads_a[n], grads_b[n]) for n in names if n.endswith("lora_b")}
    return _cosine(flat_a, flat_b), per


def _gate_first_step(name: str, model, first, g, replay: bool = False) -> None:
    """The first step's loss and adapter gradients through the kernels
    against the same step with every kernel swapped for its plain version:
    loss within LOSS_REL_TOL, the adapter gradients at GRAD_COS_TOL.
    ``replay`` (a base that quantizes its activations, :func:`_gate_replayed`)."""
    noises = _draw_noises(first, g)
    step = partial(_loss_and_grads, model, first, noises)
    if replay:
        return _gate_replayed(name, model, first, g, step)
    loss_k, grads_k = step()
    loss_p, grads_p = _with_plain_versions(step)
    cos, per = _grad_cosines(grads_k, grads_p)
    worst = min(per, key=per.get)
    flat_k = torch.cat([grads_k[n].flatten() for n in sorted(grads_k)])
    print(f"  {name} first step, kernels vs plain versions ({_describe(first[0])}): loss "
          f"{loss_k:.5f} vs {loss_p:.5f}; adapter gradients: cosine {cos:.6f} over "
          f"{flat_k.numel()} values (norm {flat_k.norm().item():.4f}), worst tensor "
          f"{per[worst]:.6f} ({worst})", flush=True)
    if not (abs(loss_k - loss_p) <= LOSS_REL_TOL * abs(loss_p) and cos >= GRAD_COS_TOL
            and bool(torch.isfinite(flat_k).all())):
        raise SystemExit(f"chip_smoke: the {name} step with the kernels disagrees with the same "
                         "step on the plain versions")


QA_WITNESS_DRAWS = 3  # flow-noise draws of the unreplayed first step (the first is the gated one)


def _gate_replayed(name: str, model, first, g, step) -> None:
    """The first step over a base that quantizes its activations. Without a
    replay the int8 roundings of the two sides part (a last-place difference
    moves a value a whole step, and an act-quant projection passes its input
    gradient only at each row's absmax entry, which a near tie moves), so the
    unreplayed adapter gradients are read, not gated, beside their noise
    floor: on QA_WITNESS_DRAWS flow-noise draws, kernels vs plain, kernels vs
    plain with fp32 attention and plain vs plain with fp32 attention (no
    kernel in it), each with its worst lora_b tensor. Gated: the unreplayed
    loss within LOSS_REL_TOL; on the step replayed with the kernel side's
    int8 values (:class:`QuantReplay` with the plain side's own scales'
    gradients), the loss within LOSS_REL_TOL, the adapter gradients at
    GRAD_COS_TOL, every K5 forward (:class:`AttentionTap`) and every K3 call
    against its plain version on the same inputs."""
    rec, tap = QuantReplay(own_scales=True), AttentionTap()
    loss_k, grads_k = tap.record(lambda: rec.record(step))
    loss_r, grads_r = _with_plain_versions(lambda: tap.compare("plain", lambda: rec.replay(step)))
    n_k3, n_act = len(rec.k3), len(rec.act)
    rec.check_k3(f"the {name} step")
    tap.check(f"the {name} step")
    del rec, tap
    cos_r, per_r = _grad_cosines(grads_k, grads_r)
    worst_r = min(per_r, key=per_r.get)
    flat = torch.cat([grads_k[n].flatten() for n in sorted(grads_k)])
    print(f"  {name} first step ({_describe(first[0])}), replayed ({n_k3} K3 outputs, {n_act} "
          f"quantize_activations outputs), kernels vs plain versions: loss {loss_k:.5f} vs "
          f"{loss_r:.5f}; adapter gradients: cosine {cos_r:.6f} over {flat.numel()} values "
          f"(norm {flat.norm().item():.4f}), worst tensor {per_r[worst_r]:.6f} ({worst_r})",
          flush=True)
    loss_k0, loss_p = loss_k, None
    for draw in range(QA_WITNESS_DRAWS):
        if draw:
            noises = _draw_noises(first, g)
            step = partial(_loss_and_grads, model, first, noises)
            loss_k, grads_k = step()
        sides = {"kernels": (loss_k, grads_k), "plain": _with_plain_versions(step),
                 "fp32": _with_plain_versions(step, True)}
        if draw == 0:
            loss_p = sides["plain"][0]
        text = []
        for a, b in (("kernels", "plain"), ("kernels", "fp32"), ("plain", "fp32")):
            cos, per = _grad_cosines(sides[a][1], sides[b][1])
            worst = min(per, key=per.get)
            text.append(f"{a} vs {b} {cos:.6f} (loss {sides[a][0]:.5f} vs {sides[b][0]:.5f}; "
                        f"worst {per[worst]:.6f}, {worst.replace('language_model.model.', '')}"
                        f"; that tensor in the gated pair {per_r[worst]:.6f})")
        print(f"  {name}, unreplayed, noise draw {draw}: adapter gradient cosines "
              + "; ".join(text), flush=True)
        del sides
    if not (abs(loss_k0 - loss_p) <= LOSS_REL_TOL * abs(loss_p)
            and abs(loss_k0 - loss_r) <= LOSS_REL_TOL * abs(loss_r) and cos_r >= GRAD_COS_TOL
            and bool(torch.isfinite(flat).all())):
        raise SystemExit(f"chip_smoke: the {name} step with the kernels disagrees with the same "
                         "step on the plain versions")


def shallow_model(model, n_layers: int):
    """``model`` cut to its first ``n_layers`` LLM layers at the full width:
    new Bagel and LLM module objects around the same layer modules and
    tensors, the configs' depth cut to match."""
    if n_layers == model.config.llm.num_hidden_layers:
        return model
    lm = copy.copy(model.language_model)
    inner = copy.copy(lm.model)
    inner._modules = dict(inner._modules,
                          layers=torch.nn.ModuleList(list(inner.layers)[:n_layers]))
    inner.cfg = dataclasses.replace(inner.cfg, num_hidden_layers=n_layers)
    lm._modules = dict(lm._modules, model=inner)
    out = copy.copy(model)
    out._modules = dict(model._modules, language_model=lm)
    out.config = dataclasses.replace(model.config, llm=dataclasses.replace(
        model.config.llm, num_hidden_layers=n_layers))
    return out


def run_lora(model, batches) -> dict:
    """Adapters of rank 16 on every projection of both experts of the bf16
    model (LORA_LAYERS of its layers), ``make_lora_train_step``: by its
    program, gated against one eager step and the eager forward
    (:func:`_run_steps` over ``batches``, a :class:`StepBatches`)."""
    cfg = model.config
    n_llm, n_vit = cfg.llm.num_hidden_layers, cfg.vit.num_hidden_layers
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    base = [(n, p) for n, p in model.named_parameters()]
    before = _checksums(base)
    lora.add_lora(model, g, rank=LORA_RANK)
    step, state = lora.make_lora_train_step(cfg, model)
    adapters = [m for m in model.modules() if isinstance(m, lora.LoRALinear)]
    print(f"LoRA: {len(adapters)} adapted projections, rank {LORA_RANK}, "
          f"{lora.count_lora_params(model) / 1e6:.1f} M adapter parameters (bf16) over "
          f"{sum(p.numel() for _, p in base) / 1e9:.2f} B frozen; remat {cfg.llm.remat}; "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB held", flush=True)
    _gate_first_step("LoRA", model, trainer.prepared(batches(0)[0], DEVICE, False), g)
    state, launches = _run_steps(step, state, batches, g, n_llm, n_vit,
                                 "the LoRA training path", frozen_vit=True)
    still = [n for n, c in _checksums(base).items() if c != before[n]]
    unmoved = [i for i, m in enumerate(adapters) if not bool((m.lora_b != 0).any())]
    print(f"  after {state.step} steps: {len(adapters) - len(unmoved)} of {len(adapters)} lora_b "
          f"moved from zero; base tensors whose bits changed: {len(still)} of {len(base)}",
          flush=True)
    if still or unmoved or any(p.grad is not None or p.requires_grad for _, p in base):
        raise SystemExit("chip_smoke: LoRA moved the base, or left an adapter where it was")
    del step, state
    programs.drop_all()  # the step's training pool with it
    return launches


def build_trainable(n_layers: int, freeze_und: bool) -> bagel.Bagel:
    """The full width at ``n_layers`` LLM layers (the ViT at its full depth),
    random bf16 weights and an fp32 VAE from the seed."""
    cfg = full_config()
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, num_hidden_layers=n_layers, freeze_und=freeze_und))
    model = bagel.Bagel(cfg, device="meta", dtype=torch.bfloat16, with_vae=True)
    model = model.to_empty(device=DEVICE)
    bagel.init_random_(model, torch.Generator(device=DEVICE).manual_seed(SEED),
                       llm2vae_zero=False)
    return model


def run_full_finetune(tok, new_token_ids) -> list:
    """``make_train_step`` with accumulation and an EMA shadow at the full
    width, then once more with the understanding expert frozen (no EMA).
    Returns the launches of both runs."""
    paths = []
    for freeze_und in (False, True):
        model = build_trainable(FT_LAYERS, freeze_und)
        # the steps, and one more update for the EMA's recurrence
        it = train_batches(model, tok, new_token_ids, False, FT_SEQ_LEN,
                           TRAIN_STEPS + (not freeze_und), FT_ACCUM)
        try:
            paths.append(_finetune(model, it, freeze_und))
        finally:  # a worker left running would abort the interpreter's exit
            it.close(wait=True)
        del model, it
        gc.collect()
        torch.cuda.empty_cache()
    return paths


FT_WATCH = (  # the full fine-tune's gate reads these tensors' first moments
    "language_model.model.layers.0.mlp.gate_proj.weight",
    "language_model.model.layers.0.mlp_moe_gen.gate_proj.weight",
    f"language_model.model.layers.{FT_LAYERS - 1}.self_attn.o_proj_moe_gen.weight",
    "language_model.lm_head.weight",
    "vit_model.vision_model.encoder.layers.0.mlp.fc1.weight",
)


def _finetune(model, it, freeze_und: bool) -> dict:
    cfg = model.config
    step, init_state = trainer.make_train_step(
        cfg, model, accum_steps=FT_ACCUM, ema_decay=None if freeze_und else FT_EMA_DECAY)
    state = init_state()
    torch.cuda.synchronize()
    params = dict(model.named_parameters())
    n_trained = sum(p.numel() for p in params.values() if p.requires_grad)
    name = "full fine-tune" + (", understanding expert frozen" if freeze_und else "")
    print(f"{name}: {FT_LAYERS} of 28 LLM layers at the full width, {n_trained / 1e9:.2f} B "
          f"trained parameters (bf16; AdamW moments bf16{'' if freeze_und else ', EMA fp32'}), "
          f"accumulation {FT_ACCUM}, {torch.cuda.memory_allocated() / 2**30:.1f} GiB held before "
          f"the first step", flush=True)
    watch = {
        "und expert": "language_model.model.layers.0.mlp.gate_proj.weight",
        "gen expert": "language_model.model.layers.0.mlp_moe_gen.gate_proj.weight",
        "ViT": "vit_model.vision_model.encoder.layers.0.mlp.fc1.weight",
    }
    before = {k: params[n].detach().clone() for k, n in watch.items()}
    frozen = {n: params[n].detach().clone()
              for n, lab in trainer._freeze_und_labels(model).items()
              if freeze_und and lab == "freeze"}
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    batches = StepBatches(it, FT_ACCUM)
    gate = [n for n in FT_WATCH if params[n].requires_grad]
    state, launches = _run_steps(step, state, batches, g, cfg.llm.num_hidden_layers,
                                 cfg.vit.num_hidden_layers, f"the {name} path",
                                 frozen_vit=False, watch=gate)
    if not freeze_und:  # one more update, to hold the EMA to its recurrence
        ema_before = {n: state.ema_params[n].clone() for n in watch.values()}
        state, _ = step(state, batches(TRAIN_STEPS), generator=g)
        for n, prev in ema_before.items():
            want = FT_EMA_DECAY * prev + (1 - FT_EMA_DECAY) * params[n].detach().float()
            torch.testing.assert_close(state.ema_params[n], want, rtol=1e-6, atol=1e-9)
        print(f"  the EMA shadow obeys ema = {FT_EMA_DECAY} ema + {1 - FT_EMA_DECAY:.3f} param "
              f"after a replayed update ({len(ema_before)} tensors, fp32)", flush=True)
        for key, n in (("packed_train_attention_fwd", 2), ("packed_train_attention_bwd_dq", 1),
                       ("packed_train_attention_bwd_dkv", 1)):
            launches[key] += n * FT_ACCUM * cfg.llm.num_hidden_layers
    moved = {k: (params[n] != before[k]).float().mean().item() for k, n in watch.items()}
    print(f"  share of entries that moved after {state.step} updates (bf16 weights, lr 1e-5): "
          f"{moved}", flush=True)
    if freeze_und:
        changed = [n for n, t in frozen.items() if not torch.equal(params[n], t)]
        print(f"  frozen understanding tensors whose bits changed: {len(changed)} of "
              f"{len(frozen)}", flush=True)
        if changed or not frozen or not moved["gen expert"] > 0:
            raise SystemExit("chip_smoke: freeze_und moved the understanding expert, or left "
                             "the generation expert where it was")
    elif not all(m > 0 for m in moved.values()):
        raise SystemExit("chip_smoke: the full fine-tune left an expert or the ViT unmoved")
    del step, state
    programs.drop_all()
    return launches


# -- training on a mesh (run K): TP, FSDP and GPipe over two processes on the card ------------
MESH_SEQS = 2  # the global batch: two packed sequences of FT_SEQ_LEN
MESH_STEPS = 1  # steps after the gradient step
# a program's loss and watched-gradient cosines against the one-rank step are held at a bound set
# from the floor measured in the same call (the one-rank step with the kernels against the same
# step with every kernel's plain version): cosine >= 1 - factor (1 - floor), loss relative
# difference <= factor x the floor's, as VELOCITY_COS_TOL was set
MESH_FLOOR_FACTOR = 2.0
MESH_WATCH = (
    "language_model.model.layers.0.mlp.gate_proj.weight",
    "language_model.model.layers.0.mlp_moe_gen.gate_proj.weight",
    f"language_model.model.layers.{FT_LAYERS - 1}.self_attn.o_proj.weight",
    "language_model.model.embed_tokens.weight",
    "vit_model.vision_model.encoder.layers.0.mlp.fc1.weight",
)
MESH_DTYPE = torch.bfloat16
# the one-rank NCCL pipeline program's replays on new inputs against the eager forward's loss
PIPE_REPLAY_RTOL = 1e-5
MESH_PROGRAMS = (  # name, axes, sizes, options
    dict(name="TP 2", axes=("data", "model"), sizes=(1, 2)),
    dict(name="FSDP over 2 data ranks", axes=("data", "model"), sizes=(2, 1), fsdp=True),
    dict(name="GPipe, 2 stages", axes=("pipe",), sizes=(2,), pipe=True),
)


def _embed_ids(seqs) -> list:
    """The token ids of the batch's text (the embedding rows with a gradient)."""
    return sorted({int(i) for s in seqs for i in s["packed_text_ids"].tolist()})


def _watched_loss_and_grads(model, seqs, noises, embed_ids):
    """One one-rank step's mean loss and the gradients of MESH_WATCH (fp32; of
    the embedding the rows of ``embed_ids``); the model's gradients are then
    dropped."""
    loss, _ = trainer.loss_fn(model, seqs, noises, backward_scale=1.0)
    params = dict(model.named_parameters())
    ids = torch.tensor(embed_ids, device=DEVICE)
    grads = {n: (params[n].grad[ids] if n == pmesh.EMBED + ".weight" else params[n].grad)
             .float() for n in MESH_WATCH}
    for p in model.parameters():
        p.grad = None
    return float(loss), grads


def _cos64(a: torch.Tensor, b: torch.Tensor) -> float:
    """The cosine of two large tensors with float64 sums (fp32 reductions over
    tens of millions of entries lose the digits that these cosines need)."""
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b) / max(float(a.norm() * b.norm()), 1e-300)


def _mesh_cosines(per_rank, i, prog, ref, embed_ids, llm) -> dict:
    """Each watched gradient of program ``i`` against the reference's, over
    the whole tensor: the ranks' parts joined by their dot products (a
    tensor every rank holds whole counted once)."""
    from unimedvl_tpu_torch.tools import dryrun_train

    shape = dict(zip(prog["axes"], prog["sizes"]))
    fsdp, pipe = prog.get("fsdp", False), prog.get("pipe", False)
    row_of = {t: j for j, t in enumerate(embed_ids)}
    out = {}
    for name in MESH_WATCH:
        dot = na = nb = 0.0
        counted = False
        for r in per_rank:
            res = r[i]
            if name not in res["grads"]:
                continue
            if dryrun_train.replicated(name, llm, shape, fsdp, pipe):
                if counted:
                    continue
                counted = True
            if name == dryrun_train.EMBED:
                part = res["grads"][name]
                got = dryrun_train.from_host(part["rows"]).to(DEVICE)
                want = ref[name][[row_of[t] for t in part["ids"]]]
                if fsdp:
                    n = want.shape[1] // shape["data"]
                    want = want[:, res["coords"]["data"] * n:(res["coords"]["data"] + 1) * n]
            else:
                got = dryrun_train.from_host(res["grads"][name]).to(DEVICE)
                want = dryrun_train.rank_part(name, ref[name], llm, shape, res["coords"], fsdp)
            got, want = got.double(), want.double()
            dot += float((got * want).sum())
            na += float(got.square().sum())
            nb += float(want.square().sum())
        out[name] = dot / max(math.sqrt(na * nb), 1e-30)
    return out


def _one_rank_nccl_step(model, padded, noises, tmp) -> dict:
    """The TP x DP step on a one-rank ("data", "model") NCCL mesh against the
    same step without a mesh (on ``model``, then on a model built anew from
    the same seed), both by their programs (every collective inside the
    graphs), on the same batch and noise: the loss and every parameter after
    it bit for bit; then the mesh step eagerly on a third model, the
    program's step gated against it (:func:`_gate_against_eager` over
    MESH_WATCH). ``padded``: the batch's sequences as the prefetcher placed
    them (each step prepares them for its route). Frees ``model``. Returns
    the K5 launches of the three steps."""
    mesh = one_rank_mesh(("data", "model"), tmp)
    sums, losses, moments = [], [], {}
    reset_counts()
    for placed, graphs in ((False, None), (True, None), (True, False)):
        if placed:
            model = pmesh.place_params(build_trainable(FT_LAYERS, False), mesh)
        step, init_state = trainer.make_train_step(model.whole_config if placed else
                                                   model.config, model,
                                                   mesh=mesh if placed else None, graphs=graphs)
        state = init_state()
        caps = programs.stats["collective_captures"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, padded, noises=noises)
        losses.append(float(loss))
        torch.cuda.synchronize()
        route = "eagerly" if graphs is False else (
            f"by its program ({programs.stats['collective_captures'] - caps} captures holding "
            "collectives)")
        print(f"  {'one-rank NCCL mesh' if placed else 'no mesh'} {route}: loss {losses[-1]:.6f}, "
              f"step {time.perf_counter() - t0:.3f} s", flush=True)
        if graphs is None:
            sums.append(_checksums(model.named_parameters()))
        if placed and graphs is None:
            moments = {n: m.clone() for n, m in _moments(state, MESH_WATCH).items()}
        elif placed:
            _gate_against_eager("the one-rank NCCL mesh step", losses[1], losses[2], moments,
                                _moments(state, MESH_WATCH),
                                state.optimizer.param_groups[0]["betas"][0], watch=MESH_WATCH)
            del moments
        del model, state, step, init_state
        programs.drop_all()
        gc.collect()
        torch.cuda.empty_cache()
    equal = sum(sums[0][n] == sums[1][n] for n in sums[0])
    print(f"  the TP x DP step on the one-rank NCCL mesh vs without, both by their programs: "
          f"loss equal {losses[0] == losses[1]}, parameters bit-equal {equal} of {len(sums[0])}",
          flush=True)
    if losses[0] != losses[1] or equal != len(sums[0]) or sums[0].keys() != sums[1].keys():
        raise SystemExit("chip_smoke: the one-rank NCCL mesh step differs from the step without "
                         "a mesh")
    n = len(padded) * FT_LAYERS * 3
    return check_counts("the no-mesh and one-rank NCCL mesh steps", {
        "packed_train_attention_fwd": 2 * n, "packed_train_attention_bwd_dq": n,
        "packed_train_attention_bwd_dkv": n})


def _one_rank_pipeline_step(batches, noises, tmp) -> dict:
    """The GPipe step (``make_pp_train_step``) on a stage model of a one-rank
    NCCL ("data", "pipe", "model") mesh (``place_params_pp`` of the seeded
    model; every axis's collectives inside the graphs), MESH_SEQS
    microbatches: the first step by its program, gated against the same
    step run eagerly on a model built anew from the seed
    (:func:`_gate_against_eager` over MESH_WATCH); then MESH_STEPS program
    steps on ``batches[k]`` (``train_examples(variant=k)``: the first's
    bucket, new values, the noise drawn by the step), each capturing nothing
    and its loss the eager forward's within PIPE_REPLAY_RTOL. ``noises``:
    the first batch's. Returns K5's launches (the program's steps and the
    eager step; layers x microbatches x 2 forward, 1 dq, 1 dk/dv each)."""
    from unimedvl_tpu_torch.parallel.pp_train import place_params_pp

    mesh = one_rank_mesh(("data", "pipe", "model"), tmp)
    reset_counts()
    path = "the one-rank NCCL pipeline step"
    rows, moments = {}, None
    for graphs in (None, False):
        model = place_params_pp(build_trainable(FT_LAYERS, False), mesh)
        step, init_state = trainer.make_pp_train_step(model.whole_config, model, mesh,
                                                      graphs=graphs)
        state = init_state()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        caps, cap_s = programs.stats["captures"], programs.stats["capture_s"]
        walls, losses = [], []
        t0 = time.perf_counter()
        state, loss = step(state, batches[0], noises=noises)
        losses.append(float(loss))
        walls.append(time.perf_counter() - t0)
        route = "eager" if graphs is False else "graphed"
        if graphs is None:
            moments = {n: m.clone() for n, m in _moments(state, MESH_WATCH).items()}
            g = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
            for k in range(1, 1 + MESH_STEPS):
                twin = torch.Generator(device=DEVICE)
                twin.set_state(g.get_state())
                want = _uncounted(lambda: _forward_loss(model, [batches[k]],
                                                        [_draw_noises(batches[k], twin)]))
                before = programs.stats["captures"]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, loss = step(state, batches[k], generator=g)
                losses.append(float(loss))
                walls.append(time.perf_counter() - t0)
                _gate_replay(path, k, losses[-1], want, programs.stats["captures"] - before,
                             [batches[k]], [batches[k - 1]], rtol=PIPE_REPLAY_RTOL)
        else:
            _gate_against_eager(path, rows["graphed"]["losses"][0], losses[0], moments,
                                _moments(state, MESH_WATCH),
                                state.optimizer.param_groups[0]["betas"][0], watch=MESH_WATCH)
        rows[route] = dict(card=CARD, losses=losses, walls_s=walls,
                           peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                           captures=programs.stats["captures"] - caps,
                           capture_s=programs.stats["capture_s"] - cap_s,
                           train_pool_bytes=programs.pool_bytes(pool="train"))
        print(f"  {path} {route} ({MESH_SEQS} microbatches, {FT_LAYERS} layers): "
              f"{json.dumps(rows[route])}", flush=True)
        del model, state, step, init_state
        programs.drop_all()
        gc.collect()
        torch.cuda.empty_cache()
    n = len(batches[0]) * FT_LAYERS * (2 + MESH_STEPS)
    return check_counts(path, {"packed_train_attention_fwd": 2 * n,
                               "packed_train_attention_bwd_dq": n,
                               "packed_train_attention_bwd_dkv": n})


def run_mesh_training(tok, new_token_ids, tmp: str) -> dict:
    """Run K: training on a mesh at the full width and FT_LAYERS layers, bf16.
    The one-rank reference first (the gradient step of MESH_SEQS packed
    sequences of FT_SEQ_LEN with the kernels, and with the plain versions:
    the floor), then the TP x DP step on a one-rank NCCL mesh against the
    step without a mesh (bit for bit), the pipeline program on a one-rank
    NCCL mesh against its eager step (:func:`_one_rank_pipeline_step`), then
    one spawn of two processes on
    this card (gloo) running the programs of MESH_PROGRAMS in turn: each
    builds its shard of the same seeded weights, takes the gradient step and
    MESH_STEPS more. Gates per program: the loss and every watched
    gradient's cosine against the reference at the floor's bound, every
    loss finite, the tensors replicated over the mesh bit-equal on both
    ranks after the steps, K5's launches on each rank as its layers,
    sequences and recomputation give them. The walls measure gloo's host
    staging on one card, not a multi-card figure. Returns the launches."""
    from unimedvl_tpu_torch.tools import dryrun_train

    model = build_trainable(FT_LAYERS, False)
    trainer.set_trainable(model)
    it = train_batches(model, tok, new_token_ids, False, FT_SEQ_LEN, 1 + MESH_STEPS, MESH_SEQS)
    try:  # the first step's batch, and the pipeline program's later steps' (new values)
        steps = [[s for _ in range(MESH_SEQS) for s in next(it)]
                 for _ in range(1 + MESH_STEPS)]
    finally:
        it.close(wait=True)
    padded = steps[0]
    seqs = trainer.prepared(padded, DEVICE, False)
    noises = _draw_noises(seqs, torch.Generator(device=DEVICE).manual_seed(SEED + 9))
    ids = _embed_ids(seqs)
    print(f"training on a mesh (run K): {FT_LAYERS} of 28 LLM layers at the full width, bf16, "
          f"a batch of {len(seqs)} packed sequences ({', '.join(_describe(q) for q in seqs)}); "
          f"the gradient step and {MESH_STEPS} more in each program", flush=True)
    loss_k, ref = _watched_loss_and_grads(model, seqs, noises, ids)
    loss_p, plain = _with_plain_versions(lambda: _watched_loss_and_grads(model, seqs, noises, ids))
    floor_cos = {n: _cos64(ref[n], plain[n]) for n in MESH_WATCH}
    floor_loss = abs(loss_k - loss_p) / abs(loss_p)
    bounds = {n: 1 - MESH_FLOOR_FACTOR * (1 - c) for n, c in floor_cos.items()}
    loss_bound = MESH_FLOOR_FACTOR * floor_loss
    short = {n: n.replace("language_model.model.", "").replace("vit_model.vision_model.", "vit.")
             for n in MESH_WATCH}
    print(f"  one-rank reference, kernels vs plain versions (the floor): loss {loss_k:.6f} vs "
          f"{loss_p:.6f} (rel {floor_loss:.3e}; programs held to {loss_bound:.3e}); cosines "
          + ", ".join(f"{short[n]} {floor_cos[n]:.6f} (bound {bounds[n]:.6f})"
                      for n in MESH_WATCH), flush=True)
    llm = model.config.llm
    del plain
    paths = [_one_rank_nccl_step(model, padded, noises, tmp)]
    del model, padded
    paths.append(_one_rank_pipeline_step(steps, noises, tmp))
    del steps
    host_seqs = [{k: v.cpu() for k, v in q.items()} for q in seqs]
    host_noises = [None if n is None else n.cpu() for n in noises]
    del seqs, noises
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(full_config(), llm=dataclasses.replace(
        full_config().llm, num_hidden_layers=FT_LAYERS))
    print(f"  {len(MESH_PROGRAMS)} programs over two processes on this card (gloo), one spawn: "
          + "; ".join(f"{p['name']} {dict(zip(p['axes'], p['sizes']))}" for p in MESH_PROGRAMS),
          flush=True)
    t0 = time.perf_counter()
    ranks = pmesh.run_on_ranks(dryrun_train.card_train_rank, 2, cfg, SEED, host_seqs,
                               host_noises, MESH_PROGRAMS, MESH_WATCH, ids, MESH_STEPS, DEVICE,
                               MESH_DTYPE, timeout_s=900.0)
    wall = time.perf_counter() - t0
    launches = {k: 0 for k in COUNTERS}
    for i, prog in enumerate(MESH_PROGRAMS):
        shape = dict(zip(prog["axes"], prog["sizes"]))
        cos = _mesh_cosines(ranks, i, prog, ref, ids, llm)
        for r, per in enumerate(ranks):
            res = per[i]
            n_seq = len(host_seqs) // shape.get("data", 1)
            n = res["layers"] * n_seq * (1 + MESH_STEPS)
            want = {"fwd": 2 * n, "bwd_dq": n, "bwd_dkv": n, "plain": 0}
            print(f"  {prog['name']}, rank {r} {res['coords']}: losses "
                  f"{[round(x, 6) for x in res['losses']]}; K5 launches {res['launches']} "
                  f"(expected {want}: {res['layers']} layers x {n_seq} sequence(s) x "
                  f"{1 + MESH_STEPS} steps, the forward twice); peak {res['peak_gib']:.1f} GiB; "
                  f"build {res['build_s']:.1f} s, steps {res['steps_s']:.1f} s ({CARD})",
                  flush=True)
            if res["launches"] != want:
                raise SystemExit(f"chip_smoke: {prog['name']} rank {r} launched K5 "
                                 f"{res['launches']}, not {want}")
            if not np.isfinite(res["losses"]).all():
                raise SystemExit(f"chip_smoke: {prog['name']}: a loss is not finite")
            for key, name in (("fwd", "packed_train_attention_fwd"),
                              ("bwd_dq", "packed_train_attention_bwd_dq"),
                              ("bwd_dkv", "packed_train_attention_bwd_dkv")):
                launches[name] += res["launches"][key]
        loss = ranks[0][i]["losses"][0]
        rel = abs(loss - loss_k) / abs(loss_k)
        names = [n for n in ranks[0][i]["checksums"]
                 if dryrun_train.replicated(n, llm, shape, prog.get("fsdp", False),
                                            prog.get("pipe", False))]
        differ = [n for n in names if ranks[1][i]["checksums"].get(n) !=
                  ranks[0][i]["checksums"][n]]
        print(f"  {prog['name']}: gradient-step loss {loss:.6f} vs the one-rank {loss_k:.6f} "
              f"(rel {rel:.3e}, bound {loss_bound:.3e}); watched gradients' cosine to the "
              "one-rank step: " + ", ".join(f"{short[n]} {c:.6f}" for n, c in cos.items())
              + f"; after {1 + MESH_STEPS} updates {len(names) - len(differ)} of {len(names)} "
              "replicated tensors bit-equal on both ranks", flush=True)
        if rel > loss_bound or any(c < bounds[n] for n, c in cos.items()) or differ:
            raise SystemExit(f"chip_smoke: {prog['name']} disagrees with the one-rank step, or "
                             f"its replicated tensors differ across ranks ({differ[:3]})")
    print(f"  run K's programs: {wall:.1f} s for both ranks, one spawn (gloo's host staging on "
          "one card, not a multi-card figure)", flush=True)
    paths.append(launches)
    return {k: sum(p.get(k, 0) for p in paths) for k in COUNTERS}


# -- QLoRA: the quantized projections under autograd (run I) ----------------------------------
# mode, quantize_llm_params options, group size; the projections of the 14B at the routed rows
# of a training sequence
QB_MODES = [("q", 8, False, 0), ("qa", 8, True, 0), ("p4", 4, False, 0), ("p4", 4, False, 512),
            ("p4a", 4, True, 0), ("p4a", 4, True, 512)]
QB_PROJECTIONS = (("q/o", 3584, 3584), ("k/v", 3584, 512), ("gate/up", 3584, 18944),
                  ("down", 18944, 3584))
QB_COS_TOL = 0.999  # each gradient against autograd of the plain route, as a whole


def _plain_quant_linear(x, lin):
    """The plain route of a quantized projection, differentiable by torch's
    autograd: x quantized per token in the act-quant modes, the product in
    fp32 (K4's plain version for packed weights)."""
    xq, xs = quant.quantize_activations(x) if lin.act_quant else (x, None)
    return _plain_preq(xq, xs, lin)


def _plain_preq(xq, xs, lin):
    if lin.packed:
        return w4.w4_matmul_ref(xq, xs, lin.weight_q, lin.scale, torch.bfloat16)
    acc = xq.float() @ lin.weight_q.float().t()
    return (acc * (lin.scale if xs is None else xs * lin.scale)).to(torch.bfloat16)


def _grad_case(fn_kernel, fn_plain, inputs, dy, timed: bool):
    """Gradients of ``fn(*inputs)`` into the float inputs through the kernel
    route and the plain route, their cosines and max abs differences; with
    ``timed`` the kernel route's forward and backward and the plain route's
    times."""
    out = {}
    for side, fn in (("kernel", fn_kernel), ("plain", fn_plain)):
        xs = [t.detach().clone().requires_grad_(True) for t in inputs]
        y = fn(*xs)
        out[side] = torch.autograd.grad(y, xs, dy, retain_graph=timed)
        if timed:
            out[side + "_fwd_ms"] = cuda_ms(lambda: fn(*xs), 1, 5)
            out[side + "_bwd_ms"] = cuda_ms(
                lambda: torch.autograd.grad(y, xs, dy, retain_graph=True), 1, 5)
        del y
    res = dict(cos=[_cosine(a.float(), b.float()) for a, b in zip(out["kernel"], out["plain"])],
               max_abs=[(a.float() - b.float()).abs().max().item()
                        for a, b in zip(out["kernel"], out["plain"])])
    if timed:
        res.update({k: v for k, v in out.items() if k.endswith("_ms")})
    return res


def check_quant_backward(seq) -> dict:
    """Each quantized mode's differentiable route at the 14B projection shapes
    (q/o 3584->3584, k/v 3584->512, gate/up 3584->18944, down 18944->3584), at
    the rows the training forward routes to each expert in ``seq`` (a T 6144
    sequence of the LoRA phase): dx (and K3's dg, du at the down projection
    of the act-quant modes) against autograd of the plain route, gated at
    QB_COS_TOL; at the understanding rows also the forward's and the
    backward's times and the widening's (the weight to bf16, once per
    backward in ``q`` and ``p4``). Returns the K4 and K3 rows for the
    ``kernels`` line."""
    rows = (seq["und_idx"].numel(), seq["gen_idx"].numel())
    print(f"QLoRA's projections under autograd at the routed rows of {_describe(seq)} "
          f"(card {CARD}): dx against autograd of the plain route, cosine >= {QB_COS_TOL}",
          flush=True)
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 8)
    k4_rows, k3_rows, failed = [], [], []
    for mode, bits, act, group in QB_MODES:
        for pname, K, N in QB_PROJECTIONS:
            w = torch.randn(N, K, generator=g, device=DEVICE) * K**-0.5
            q, scale = quant.quantize_weight(w.to(torch.bfloat16), bits, group)
            lin = QuantLinear(quant.mode_name(bits, act), q, scale)
            del w
            for m in rows:
                if m == 0:
                    continue
                timed = m == rows[0]
                x = torch.randn(m, K, generator=g, device=DEVICE).to(torch.bfloat16)
                dy = torch.randn(m, N, generator=g, device=DEVICE).to(torch.bfloat16)
                before = dict(w4.counts)
                r = _grad_case(lin, lambda t: _plain_quant_linear(t, lin), [x], dy, timed)
                widen = None
                if timed and not act:
                    widen = cuda_ms(lambda: (w4.unpack_int4(lin.weight_q) if lin.packed
                                             else lin.weight_q).to(torch.bfloat16), 1, 5)
                row = dict(mode=mode, group=group, projection=pname, m=m, K=K, N=N,
                           cos_dx=r["cos"][0], max_abs_dx=r["max_abs"][0],
                           **{k: r[k] for k in r if k.endswith("_ms")},
                           widen_ms=widen)
                if lin.packed and x.is_cuda and w4.counts["kernel"] == before["kernel"]:
                    raise SystemExit(f"chip_smoke: {mode} {pname} did not launch K4")
                print(f"  {json.dumps(row)}", flush=True)
                if r["cos"][0] < QB_COS_TOL or not math.isfinite(r["max_abs"][0]):
                    failed.append(row)
                if lin.packed:
                    k4_rows.append(row)
                if pname == "down" and act:  # K3 in front of the down projection
                    gg = torch.randn(m, K, generator=g, device=DEVICE).to(torch.bfloat16) * 2
                    uu = torch.randn(m, K, generator=g, device=DEVICE).to(torch.bfloat16)
                    r3 = _grad_case(
                        lambda a, b: quant.quantized_linear_preq(
                            *aq.silu_mul_quant_autograd(a, b), lin, torch.bfloat16),
                        lambda a, b: _plain_preq(*aq.silu_mul_quant_ref(a, b), lin),
                        [gg, uu], dy, timed)
                    row3 = dict(mode=mode, group=group, R=m, I=K, cos_dg=r3["cos"][0],
                                cos_du=r3["cos"][1], max_abs_dg=r3["max_abs"][0],
                                max_abs_du=r3["max_abs"][1],
                                **{k: v for k, v in r3.items() if k.endswith("_ms")})
                    print(f"  K3 {json.dumps(row3)}", flush=True)
                    k3_rows.append(row3)
                    if min(r3["cos"]) < QB_COS_TOL:
                        failed.append(row3)
            del lin, q, scale
    torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"chip_smoke: a quantized route's gradient disagrees with the plain "
                         f"route's: {failed}")
    return {"w4_matmul": k4_rows, "silu_mul_quant": k3_rows}


QLORA_MODES = [  # name, quantize_llm_params options, adapter targets, K4 / K3 per expert call set
    ("weight-only w4 per channel (p4), adapters on every projection", dict(bits=4),
     lora.TARGETS_ALL, 7, 0),
    ("full-int8 (qa), adapters on q/k/v/o", dict(bits=8, act_quant=True),
     ("q", "k", "v", "o"), 0, 1),
]


def qlora_model(model, **kw):
    """A copy of ``model`` whose LLM is quantized on the card: new modules
    around the same tensors for everything that stays, each projection
    quantized from its bf16 weight."""
    lm = model.language_model
    shared = {id(t): t for t in itertools.chain(lm.parameters(), lm.buffers())}
    qlm = copy.deepcopy(lm, shared)
    quant.quantize_llm_params(qlm, **kw)
    qmodel = copy.copy(model)
    qmodel._modules = dict(model._modules, language_model=qlm)
    return qmodel


def run_qlora(inf_model, batches) -> list:
    """Run I: adapter training over a quantized copy of the LLM (LORA_LAYERS
    layers), rank 16, in each of QLORA_MODES (the copy freed before the next):
    K4 forward and its backward route at every projection of both experts
    (weight-only w4), K3 forward and its backward route at every MLP's down
    (full-int8), inside the step's graphs. Gates as run LoRA's: the first
    step against the same step on the plain versions, the program's first
    step against an eager step, the base's bits unchanged, every lora_b
    moved, the launches against the forwards (recomputed once per layer)."""
    cfg = inf_model.config
    n_llm, n_vit = cfg.llm.num_hidden_layers, cfg.vit.num_hidden_layers
    paths = []
    for name, kw, targets, k4, k3 in QLORA_MODES:
        t0 = time.perf_counter()
        held = torch.cuda.memory_allocated()
        model = qlora_model(inf_model, **kw)
        g = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
        base = list(itertools.chain(model.named_parameters(), model.named_buffers()))
        before = _checksums(base)
        lora.add_lora(model, g, rank=LORA_RANK, targets=targets)
        step, state = lora.make_lora_train_step(cfg, model)
        adapters = [m for m in model.modules() if isinstance(m, lora.LoRALinear)]
        torch.cuda.synchronize()
        print(f"QLoRA (run I), {name}: {len(adapters)} adapted projections, "
              f"{lora.count_lora_params(model) / 1e6:.1f} M adapter parameters (bf16); the "
              f"quantized copy {(torch.cuda.memory_allocated() - held) / 2**30:.2f} GiB, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        _gate_first_step(f"QLoRA {name}", model, trainer.prepared(batches(0)[0], DEVICE, False),
                         g, replay=kw.get("act_quant", False))

        def launches(seq, k4=k4, k3=k3):
            runs = 2 * n_llm * ((seq["und_idx"].numel() > 0) + (seq["gen_idx"].numel() > 0))
            return {"w4_matmul": k4 * runs, "silu_mul_quant": k3 * runs}

        path = f"the QLoRA training path, {name}"
        state, counted = _run_steps(step, state, batches, g, n_llm, n_vit, path,
                                    frozen_vit=True, quant_launches=launches)
        paths.append(counted)
        still = [n for n, c in _checksums(base).items() if c != before[n]]
        unmoved = [i for i, m in enumerate(adapters) if not bool((m.lora_b != 0).any())]
        print(f"  after {state.step} steps: {len(adapters) - len(unmoved)} of {len(adapters)} "
              f"lora_b moved from zero; base tensors (the quantized buffers included) whose "
              f"bits changed: {len(still)} of {len(base)}", flush=True)
        if still or unmoved:
            raise SystemExit(f"chip_smoke: QLoRA ({name}) moved the base, or left an adapter "
                             "where it was")
        del model, state, step, adapters, base
        programs.drop_all()
        gc.collect()
        torch.cuda.empty_cache()
    return paths


# -- the e2e-VAE extras, snapshots and export (run J) ------------------------------------------
E2E_LAYERS = FT_LAYERS
E2E_DTYPE = torch.bfloat16
E2E_RESUME_LOSS_RTOL = 1e-3  # the resumed step against the uninterrupted one, if not bit-equal
E2E_RESUME_PARAM_ULPS = 2  # and each watched entry within 2 bf16 steps of its magnitude


def _e2e_config():
    cfg = full_config()
    return dataclasses.replace(
        cfg, llm=dataclasses.replace(cfg.llm, num_hidden_layers=E2E_LAYERS),
        e2e=E2EVAEConfig(enable_batch_norm=True, diffusion_feature_layer=E2E_LAYERS // 2))


def _e2e_model(seed: int) -> bagel.Bagel:
    model = bagel.Bagel(_e2e_config(), device="meta", dtype=E2E_DTYPE, with_vae=True)
    model = model.to_empty(device=DEVICE)
    return bagel.init_random_(model, torch.Generator(device=DEVICE).manual_seed(seed),
                              llm2vae_zero=False)


def _e2e_step(step, state, batch, i: int):
    """One e2e step on ``batch`` with the flow noise drawn from a generator
    seeded by the step's index, so a resumed run draws the same."""
    noises = _draw_noises(batch, torch.Generator(device=DEVICE).manual_seed(SEED + 30 + i))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, loss = step(state, batch, noises=noises)
    loss = float(loss)
    return state, loss, time.perf_counter() - t0


def run_e2e(tok, new_token_ids, tmp: str) -> dict:
    """Run J: a full fine-tune at E2E_LAYERS of 28 LLM layers, full width,
    with ``cfg.e2e`` (the latent batch-norm and both REPA terms, teacher
    features from the seed at teacher_feature_dim): two steps,
    ``save_snapshot``, a third step (the steps after the first on new values
    in the first's bucket, replays gated against the eager forward); the
    exported checkpoint
    (``export_bagel_checkpoint``) read back by ``load_bagel_checkpoint`` must
    give the in-memory model's first-step chat logits; a fresh model
    restored from the snapshot takes the third step again, which must equal
    the uninterrupted one (bit for bit, or within E2E_RESUME_LOSS_RTOL and
    E2E_RESUME_PARAM_ULPS where the card's sums are not deterministic).
    Returns the launches of the three steps."""
    from unimedvl_tpu_torch.weights.bagel_export import export_bagel_checkpoint
    from unimedvl_tpu_torch.weights.loader import load_bagel_checkpoint
    from unimedvl_tpu_torch.weights.snapshot import restore_snapshot, save_snapshot

    model = _e2e_model(SEED)
    cfg = model.config
    n_llm, dt = cfg.llm.num_hidden_layers, cfg.e2e.teacher_feature_dim
    rng = np.random.default_rng(SEED + 9)

    def teacher(batch):  # the teacher's features of the real latent rows, zero padding rows
        if "vae_scatter_idx" in batch:
            real = batch["vae_scatter_idx"] < batch["packed_position_ids"].shape[-1]
            batch["repa_teacher_features"] = (rng.standard_normal((*real.shape, dt), np.float32)
                                              * real[..., None])
        return batch

    it = train_batches(model, tok, new_token_ids, False, FT_SEQ_LEN, TRAIN_STEPS, extra=teacher)
    try:
        batches = [next(it) for _ in range(TRAIN_STEPS)]
    finally:
        it.close(wait=True)
    step, init_state = trainer.make_train_step(cfg, model)
    state = init_state()
    n_trained = sum(p.numel() for p in model.parameters() if p.requires_grad)
    print(f"e2e-VAE fine-tune (run J): {n_llm} of 28 LLM layers at the full width, "
          f"{n_trained / 1e9:.2f} B trained parameters (bf16, AdamW moments bf16), latent "
          f"batch-norm and REPA (teacher width {dt}, feature layer "
          f"{cfg.e2e.diffusion_feature_layer}), {torch.cuda.memory_allocated() / 2**30:.1f} GiB "
          "held; the steps by the step's program, the first gated against an eager step",
          flush=True)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    gate = ["language_model.model.layers.0.mlp_moe_gen.down_proj.weight", "repa_proj.weight",
            "repa_vae_proj.weight", "language_model.model.embed_tokens.weight"]
    loss_e, ref, t_eager = _eager_reference(
        step, state, batches[0],
        _draw_noises(batches[0], torch.Generator(device=DEVICE).manual_seed(SEED + 30)), gate)
    snap = os.path.join(tmp, "snapshot")
    losses, times = [], []
    for i, batch in enumerate(batches):
        if i == TRAIN_STEPS - 1:
            t0 = time.perf_counter()
            save_snapshot(snap, state)
            size = os.path.getsize(os.path.join(snap, "snapshot.pt")) / 2**30
            print(f"  snapshot after step {state.step}: {size:.1f} GiB written in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        want = None
        if i:  # the eager forward on the step's batch and noise (_e2e_step's draw)
            nz = _draw_noises(batch, torch.Generator(device=DEVICE).manual_seed(SEED + 30 + i))
            want = _uncounted(lambda: _forward_loss(model, [batch], [nz], state.bn_state))
        caps = programs.stats["captures"]
        state, loss, sec = _e2e_step(step, state, batch, i)
        losses.append(loss)
        times.append(sec)
        print(f"  step {i}: loss {loss:.4f} ({_describe(batch[0])}), {sec:.3f} s "
              f"({programs.stats['captures'] - caps} graphs captured); bn_state mean "
              f"{state.bn_state.mean.abs().mean().item():.4f}, var "
              f"{state.bn_state.var.mean().item():.4f}", flush=True)
        if not math.isfinite(loss):
            raise SystemExit("chip_smoke: run J's loss is not finite")
        if i == 0:
            _gate_against_eager("run J", loss, loss_e, _moments(state, gate), ref,
                                state.optimizer.param_groups[0]["betas"][0], watch=gate)
            del ref
        else:
            _gate_replay("run J", i, loss, want, programs.stats["captures"] - caps, [batch],
                         [batches[i - 1]])
    launches = check_counts("the e2e-VAE training path (run J)", {
        "packed_train_attention_fwd": 2 * n_llm * (TRAIN_STEPS + 1),
        "packed_train_attention_bwd_dq": n_llm * (TRAIN_STEPS + 1),
        "packed_train_attention_bwd_dkv": n_llm * (TRAIN_STEPS + 1),
    })
    peak = torch.cuda.max_memory_allocated() / 2**30
    STEP_STATS["run J"] = dict(card=CARD, s_steps_graphed=times, s_first_eager_step=t_eager,
                               peak_gib=peak, train_pool_bytes=programs.pool_bytes(pool="train"))
    print(f"  run J: {json.dumps(STEP_STATS['run J'])}", flush=True)
    watch = ["language_model.model.layers.0.mlp_moe_gen.down_proj.weight",
             "language_model.model.layers.0.self_attn.q_proj.weight", "repa_proj.weight",
             "repa_vae_proj.weight", "vit_model.vision_model.encoder.layers.0.mlp.fc1.weight"]
    params = dict(model.named_parameters())
    want = {n: params[n].detach().float().cpu() for n in watch}
    want_sums = _checksums(model.named_parameters())
    want_bn = (state.bn_state.mean.cpu(), state.bn_state.var.cpu())
    del state, step, params
    gc.collect()

    # export, then the released-format files read back: the same first-step logits
    export = os.path.join(tmp, "export")
    model.requires_grad_(False)
    t0 = time.perf_counter()
    written = export_bagel_checkpoint(export, model, dtype=E2E_DTYPE)
    print(f"  exported {sorted(written)} in {time.perf_counter() - t0:.1f} s", flush=True)
    image, prompt = _images()[1], REQUESTS[1][2]
    logits = {}
    logits["in memory"] = _first_step_logits(InterleaveInferencer(
        model, tok, new_token_ids, seed=SEED), image, prompt)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    reloaded = load_bagel_checkpoint(export, device=DEVICE, dtype=E2E_DTYPE)
    logits["reloaded"] = _first_step_logits(InterleaveInferencer(
        reloaded, tok, new_token_ids, seed=SEED), image, prompt)
    del reloaded
    gc.collect()
    torch.cuda.empty_cache()
    diff = (logits["in memory"] - logits["reloaded"]).abs().max().item()
    print(f"  export round trip: first-step chat logits of the reloaded checkpoint against the "
          f"in-memory model's: max abs {diff:.3e}, equal {diff == 0}", flush=True)
    if diff != 0:
        raise SystemExit("chip_smoke: the exported checkpoint does not reload to the same model")

    # the snapshot restored into a fresh model; its third step against the uninterrupted one
    fresh = _e2e_model(SEED + 1)
    step, init_state = trainer.make_train_step(fresh.config, fresh)
    t0 = time.perf_counter()
    state = restore_snapshot(snap, init_state(), device=DEVICE)
    print(f"  restored the snapshot (step {state.step}) into a fresh model in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    state, loss, _ = _e2e_step(step, state, batches[-1], TRAIN_STEPS - 1)
    params = dict(fresh.named_parameters())
    sums = _checksums(fresh.named_parameters())
    equal = sum(sums[n] == want_sums[n] for n in want_sums)
    worst = max(((params[n].detach().float().cpu() - want[n]).abs()
                 / (want[n].abs() * 2.0**-8 * E2E_RESUME_PARAM_ULPS + 1e-12)).max().item()
                for n in watch)
    bn_equal = torch.equal(state.bn_state.mean.cpu(), want_bn[0]) and \
        torch.equal(state.bn_state.var.cpu(), want_bn[1])
    print(f"  resumed step {TRAIN_STEPS - 1}: loss {loss:.6f} vs uninterrupted "
          f"{losses[-1]:.6f}; {equal} of {len(want_sums)} parameter tensors bit-equal; watched "
          f"entries' worst |diff| / ({E2E_RESUME_PARAM_ULPS} bf16 steps) {worst:.3f}; bn_state "
          f"equal {bn_equal}", flush=True)
    if not (abs(loss - losses[-1]) <= E2E_RESUME_LOSS_RTOL * abs(losses[-1]) and worst <= 1.0):
        raise SystemExit("chip_smoke: the resumed run J differs from the uninterrupted one")
    del fresh, state, step, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def run_training(inf: InterleaveInferencer):
    """The training phases; returns (K5's timings, K3's and K4's backward
    cases, the launches of each path)."""
    tok, ids = inf.tokenizer, inf.new_token_ids
    lora_it = train_batches(inf.model, tok, ids, True, LORA_SEQ_LEN, TRAIN_STEPS)
    ft_it = train_batches(inf.model, tok, ids, False, FT_SEQ_LEN)
    try:
        batches = StepBatches(lora_it, 1)
        first = trainer.prepared(batches(0)[0], DEVICE, False)[0]
        ft_first = trainer.prepared(next(ft_it), DEVICE, False)[0]
        ft_it.close(wait=True)
        timings = check_packed_train_attention(ft_first, first)
        backward = check_quant_backward(first)
        small = shallow_model(inf.model, LORA_LAYERS)
        print(f"QLoRA training paths (run I): {TRAIN_STEPS} steps by the step's program and one "
              f"eager step each over a quantized copy of the model at {LORA_LAYERS} of its 28 "
              f"layers (full width), one packed sequence of {LORA_SEQ_LEN} tokens per step (the "
              "steps after the first: the prefetcher's next batches, new values in the first's "
              "bucket)", flush=True)
        paths = run_qlora(small, batches)
        print(f"LoRA training path: {TRAIN_STEPS} steps by the step's program and one eager step "
              f"over the model at {LORA_LAYERS} of its 28 layers, one packed sequence of "
              f"{LORA_SEQ_LEN} tokens per step", flush=True)
        paths.append(run_lora(small, batches))
        return timings, backward, paths
    finally:  # a worker left running would abort the interpreter's exit
        ft_it.close(wait=True)
        lora_it.close(wait=True)


#: the phases ``--phases`` selects, by the names their stamps print, and the phases each needs
#: run before it (its gates read their outputs); the kernel checks always run
PHASES = {
    "kernel checks": (), "chat": (), "generation": (), "sp generation": ("generation",),
    "quantized chat": ("chat",), "quantized generation": ("generation",), "serving": (),
    "eval": ("serving",), "mesh": ("chat", "eval"), "reconstruction": (), "spec": (),
    "training": (), "mesh training": (), "e2e": (),
}


def select_phases(names) -> list:
    """The phases to run, in the run's order: ``names`` (None: all) with the
    phases they need."""
    if names is None:
        return list(PHASES)
    unknown = [n for n in names if n not in PHASES]
    if unknown:
        raise SystemExit(f"chip_smoke: unknown phases {unknown}; the phases are {list(PHASES)}")
    want = set(names) | {"kernel checks"}
    while True:
        more = {d for n in want for d in PHASES[n]} - want
        if not more:
            return [n for n in PHASES if n in want]
        want |= more


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="The port's smoke run on one card.")
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases to run (with the phases they need): "
                         + ", ".join(PHASES) + "; by default every phase")
    args = ap.parse_args(argv)
    check_device()
    phases = select_phases(None if args.phases is None else
                           [n.strip() for n in args.phases.split(",") if n.strip()])
    with tempfile.TemporaryDirectory() as tmp:
        try:
            run(tmp, phases)
        finally:
            if torch.distributed.is_available() and torch.distributed.is_initialized():
                torch.distributed.destroy_process_group()


def run(tmp: str, phases=None) -> None:
    phases = list(PHASES) if phases is None else phases
    full = phases == list(PHASES)
    t_start = time.perf_counter()
    t_last = [t_start]

    def done(phase: str, what: str = "") -> None:
        """Where the run's time goes: seconds since the start and the phase's own, at each
        phase's end (and the graphs captured so far, with the seconds their warm-ups and
        captures took). ``phase`` is its name in PHASES."""
        now = time.perf_counter()
        print(f"[{now - t_start:.1f} s] {phase} done{f' ({what})' if what else ''} in "
              f"{now - t_last[0]:.1f} s (graphs captured so far {programs.stats['captures']} "
              f"in {programs.stats['capture_s']:.1f} s)", flush=True)
        t_last[0] = now

    if not full:
        print(f"phases: {phases}", flush=True)
    build_kernels()
    timings = check_kernels()
    time_int8_matmul_candidates(torch.Generator(device="cuda").manual_seed(SEED + 4))
    torch.cuda.empty_cache()
    done("kernel checks")
    paths = []
    inf = tok = new_token_ids = None
    if set(phases) - {"kernel checks", "mesh training", "e2e"}:
        inf = build_inferencer()
        tok, new_token_ids = inf.tokenizer, inf.new_token_ids
    elif set(phases) & {"mesh training", "e2e"}:
        tok, new_token_ids, _ = add_special_tokens(ByteTokenizer())
    if "chat" in phases:
        print("chat path: 3 chat requests, greedy, max_length "
              f"{MAX_LENGTH}, full 14B geometry, random weights (seed {SEED})", flush=True)
        paths = [run_main_path(inf)]
        check_context_builds(inf)
        logits_bf16 = check_against_plain_path(inf)
        paths += [run_sampled_chat(inf), run_kept_decode(inf)]
        done("chat")
    if "generation" in phases:
        print(f"generation path: text-to-image and an image edit at {GEN_SIZE[0]}x{GEN_SIZE[1]}, "
              "50 timesteps, CFG text 3.0 / image 1.5 on (0.4, 1.0], global renorm", flush=True)
        launches, plain_rows = run_generation(inf)
        paths.append(launches)
        v_bf16 = check_velocity_against_plain(inf)["kernels"]
        print("K6 inside the model: the first denoise step of each request, its attention "
              "swapped for K6", flush=True)
        paths.append(run_cache_block_step(inf))
        done("generation")
    if "sp generation" in phases:
        print("sequence-parallel denoise path: the same two requests through "
              "InterleaveInferencer(sp_mesh=...), full depth", flush=True)
        paths.append(run_sp_generation(inf, one_rank_mesh(("model", "seq"), tmp), plain_rows))
        done("sp generation", "the SP denoise through sp_mesh")
    if "quantized chat" in phases:
        paths.append(run_quantized_chat(inf, logits_bf16))
        done("quantized chat")
    if "quantized generation" in phases:
        paths.append(run_quantized_generation(inf, v_bf16, plain_rows))
        done("quantized generation", "run H")
    if "serving" in phases:
        paths += run_serving_phase(inf)
        done("serving", "runs A-E, HTTP")
    if "eval" in phases:
        paths.append(run_eval_phase(inf))
        done("eval", "run F")
    if "mesh" in phases:
        paths += run_mesh_phase(inf, tmp)
        done("mesh", "one-rank NCCL mesh, TP over two processes, sharded loader")
    if "reconstruction" in phases:
        paths.append(run_reconstruction(inf))
        done("reconstruction", "run G")
    if "spec" in phases:
        paths += run_spec_phase(inf)
        done("spec", "speculative decoding")
    if "training" in phases:
        train_timings, backward, train_paths = run_training(inf)
        for name, row in train_timings.items():  # K5's rows at a TP rank's shapes stay
            row["shard_cases"] = timings.get(name, {}).get("shard_cases")
        timings.update(train_timings)
        for name, cases in backward.items():
            timings[name]["backward_cases"] = cases
        paths += train_paths
    if inf is not None:
        _CHAT_STEPS.clear()  # the chat references of the inference phases
        del inf  # the 28-layer model makes room for the full fine-tune's state
        gc.collect()
        torch.cuda.empty_cache()
    if "training" in phases:
        paths += run_full_finetune(tok, new_token_ids)
        print(f"training steps, graphed and eager (same call, {CARD}): "
              + json.dumps(STEP_STATS), flush=True)
        done("training")
    if "mesh training" in phases:
        paths.append(run_mesh_training(tok, new_token_ids, tmp))
        done("mesh training", "run K: the one-rank NCCL step; TP, FSDP and GPipe over two "
             "processes")
    if "e2e" in phases:
        paths.append(run_e2e(tok, new_token_ids, tmp))
        done("e2e", "run J: e2e-VAE steps, snapshot resume and export")
    flash = "unimedvl_tpu_torch/csrc/flash_block_attention.cu"
    decode = "unimedvl_tpu_torch/csrc/decode_attention.cu"
    train = "unimedvl_tpu_torch/csrc/packed_train_attention.cu"
    sources = {
        "flash_block_attention": (flash, "unimedvl_tpu/ops/flash_attention.py:209"),
        "flash_block_attention_q_preproc": (
            flash, "unimedvl_tpu/ops/flash_attention.py:209 (q_preproc, _fused_q_preproc :33)"),
        "flash_block_attention_lse": (
            flash, "unimedvl_tpu/ops/flash_attention.py:209 (return_lse, _kernel :149-153)"),
        "flash_cache_block_attention": (
            "unimedvl_tpu_torch/csrc/flash_cache_block_attention.cu",
            "unimedvl_tpu/ops/flash_attention.py:502 (_kernel2 :389, _proc_k_chunk :438)"),
        "decode_attention": (decode, "unimedvl_tpu/ops/decode_attention.py:130"),
        "decode_attention_int8": (
            decode, "unimedvl_tpu/ops/decode_attention.py:130 (int8 k/v, k_scale, v_scale)"),
        "silu_mul_quant": ("unimedvl_tpu_torch/csrc/silu_mul_quant.cu",
                           "unimedvl_tpu/ops/act_quant.py:57"),
        "silu_mul_quant_global": (
            "unimedvl_tpu_torch/csrc/silu_mul_quant.cu",
            "unimedvl_tpu/ops/act_quant.py:57 (second entry: row scales all-reduced over "
            "'model' between a scale pass and a quantize pass)"),
        "w4_matmul": ("unimedvl_tpu_torch/csrc/w4_matmul.cu",
                      "unimedvl_tpu/ops/w4_matmul.py:202"),
        "w4_matmul_simple": (
            "unimedvl_tpu_torch/csrc/w4_matmul.cu",
            "unimedvl_tpu/ops/w4_matmul.py:202 (the shapes its gate _kernel_fits :149 refuses, "
            "which run its XLA group scan :262: groups of 16, 8, odd widths)"),
        "packed_train_attention_fwd": (
            train, "unimedvl_tpu/ops/flash_attention_train.py:263 (_fwd :111, _fwd_kernel :60)"),
        "packed_train_attention_bwd_dq": (
            train, "unimedvl_tpu/ops/flash_attention_train.py:263 (_bwd_dq_kernel :167)"),
        "packed_train_attention_bwd_dkv": (
            train, "unimedvl_tpu/ops/flash_attention_train.py:263 (_bwd_dkv_kernel :211)"),
    }
    # ms is one call between two events, host time of the wrapper included;
    # ms_back_to_back is the time per call in a run of 20, which the card sets
    keys = ("max_abs_err", "ms", "ms_back_to_back", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    # K6 is on no entry point's path: its launches are those of the phase that swaps it into
    # the denoise step (run_cache_block_step), and the line says so
    timings.setdefault("flash_cache_block_attention", {})["launches_from"] = (
        "a denoise step with K6 swapped in; no entry point routes through it")
    # a run of some phases lists every kernel: those it did not time carry nulls
    kernels = [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=sum(p.get(name, 0) for p in paths),
             **{k: timings.get(name, {}).get(k) for k in keys},
             **{k: v for k, v in timings.get(name, {}).items() if k in EXTRA_KEYS})
        for name, (src, rep) in sources.items()
    ]
    unlaunched = [k["name"] for k in kernels if k["launches"] < 1]
    if unlaunched and full:
        raise SystemExit(f"chip_smoke: no path launched {unlaunched}")
    if unlaunched:
        print(f"kernels no selected phase launched: {unlaunched}", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
