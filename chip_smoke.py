"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): builds the CUDA
kernels from ``unimedvl_tpu_torch/csrc``, holds each kernel against its plain
PyTorch version at the paths' shapes, then, with the full 14B geometry
(random bf16 weights and an fp32 VAE from a seed):

- the chat path: three VQA requests through ``InterleaveInferencer.chat``;
- the generation path: a 512x512 text-to-image request and a 512x512 image
  edit through ``interleave_inference`` with the recipe's defaults (50
  timesteps, CFG text 3.0 and image 1.5 on the interval (0.4, 1.0], global
  renorm);
- the quantized chat path, the LLM quantized on the card with an int8 KV
  cache and fused projections: full-int8 (the three chat requests), w4a8
  per channel and w4a8 with groups of 512 (one request each), weight-only w4
  per channel (the 980x980 and 378x378 requests);
- the training path: LoRA steps (rank 16, every projection of both experts)
  over the frozen 28-layer model, on packed batches of synthetic VQA,
  text-to-image and editing examples (980 px and 378 px understanding
  images, 512 px generation images) from ``PackedBatchIterator`` through
  ``Prefetcher``; then full fine-tune steps (gradient accumulation 2, EMA)
  at the full width with the depth cut to what one card holds, and once more
  with the understanding expert frozen;
- the sequence-parallel denoise path: the same two generation requests
  through an inferencer with ``sp_mesh``, a ("model", "seq") mesh of 1 x 1
  (one card holds one rank; on a one-rank NCCL group where NCCL starts, so
  that the collective calls really run), every layer's attention as a cache
  partial and a block partial (K1c twice) merged by their log-sum-exps;

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

import copy
import datetime
import gc
import itertools
import json
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from unimedvl_tpu_torch.config import BagelConfig, LLMConfig, TransformConfig, VAEConfig, ViTConfig
from unimedvl_tpu_torch.data.tokenizer import ByteTokenizer, add_special_tokens
from unimedvl_tpu_torch import quant
from unimedvl_tpu_torch.inference import InterleaveInferencer
from unimedvl_tpu_torch.models import bagel, qwen2_mot, siglip
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
from unimedvl_tpu_torch.training import dataset, lora, trainer

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


def check_device() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
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


def _compare(name, kernel_fn, plain_fn, rows, back_to_back=None, row_atol=False):
    """Kernel vs plain on the valid query rows [:, :rows]; both times, and
    the kernel's time per call in a run of calls (``back_to_back``; by default
    for a one-row shape). ``row_atol``: the absolute part of the bound is
    RTOL times the largest |plain| of the output row [..., D] instead of
    ATOL, for outputs whose size the inputs' scales set."""
    got = kernel_fn()
    torch.cuda.synchronize()
    want = plain_fn()
    ref = want[:, :rows].float()
    diff = (got[:, :rows].float() - ref).abs()
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
    timings["w4_matmul"] = check_w4_matmul(g, randn)
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


def check_w4_matmul(g, randn) -> dict:
    """K4 against its plain version at the LLM's four projection shapes (qkv
    and gate_up fused, o, down), per channel and with groups of 512: the int8
    branch (w4a8) must be EQUAL (exact integer sums, the same rounded fp32
    scaling), on the GEMV (m 1 to 4) and the GEMM (m 731, 4902); the bf16 branch
    (weight-only w4; GEMV at m 1 to 4, GEMM at a text prefill's 17 rows and
    at m 731, 4902) sums fp32 in another order: |err| <= 2^-7 |plain| + 1e-3
    sqrt(K) 8 max|x| max(w_scale) / 16. The GEMV captured in a CUDA graph
    must replay equal to an eager call on new x. The ``kernels`` line's row
    is the decode step's GEMV at gate_up, with the prefill's GEMMs at gate_up,
    m 4902, per channel under ``gemm`` (int8 x) and ``bf16_gemm`` (bf16 x,
    with the ``torch.mm`` yardstick), and the GEMV cold at each projection
    under ``gemv_cases`` (``gemv_cold_cases``)."""
    print("K4 w4_matmul (w4a8: equality; bf16 x: |err| <= 2^-7 |ref| + reordering bound):",
          flush=True)
    shapes = [(3584, 4608), (3584, 3584), (3584, 37888), (18944, 3584)]
    rows, shown, gemm, bf16_gemm = [], None, None, None
    for K, N in shapes:
        wp = w4.pack_int4(_rand_int8(g, N, K, lo=-8, hi=8))
        for G in (0, K // W4_GROUP):
            ws = torch.rand((G, N) if G else (N,), generator=g, device="cuda") * 0.01 + 0.001
            for m in (1, 2, 3, 4, 731, 4902):
                x = _rand_int8(g, m, K)
                xs = torch.rand(m, 1, generator=g, device="cuda") * 0.05 + 0.001
                got = w4.w4_matmul(x, xs, wp, ws)
                torch.cuda.synchronize()
                want = w4.w4_matmul_ref(x, xs, wp, ws)
                err = (got.float() - want.float()).abs().max().item()
                ms = cuda_ms(lambda: w4.w4_matmul(x, xs, wp, ws))
                plain_ms = cuda_ms(lambda: w4.w4_matmul_ref(x, xs, wp, ws), warmup=1, iters=3)
                b2b = back_to_back_ms(lambda: w4.w4_matmul(x, xs, wp, ws)) if m == 1 else None
                b = bound(m * K + m * 4 + N * K // 2 + ws.numel() * 4 + m * N * 2,
                          2.0 * m * K * N, "int8")
                _line(f"K4 w4a8 m={m} K={K} N={N} {'group 512' if G else 'per channel'}",
                      f"equal {torch.equal(got, want)} (max abs err {err:.3e})", ms, plain_ms, b,
                      _b2b_text(b2b))
                if not torch.equal(got, want):
                    raise SystemExit("chip_smoke: K4 (w4a8) differs from its plain version")
                r = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, ms_back_to_back=b2b,
                         library_ms=None, **b)
                rows.append(r)  # no PyTorch call multiplies by packed int4 weights
                if (m, K, N, G) == (1, 3584, 37888, 0):
                    shown = r
                if (m, K, N, G) == (4902, 3584, 37888, 0):  # the GEMM path at gate_up
                    gemm = {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
        for G in (0, K // W4_GROUP):
            ws = torch.rand((G, N) if G else (N,), generator=g, device="cuda") * 0.01 + 0.001
            for m in (1, 2, 3, 4, 17, 731, 4902):
                x = randn(m, K)
                got = w4.w4_matmul(x, None, wp, ws).float()
                torch.cuda.synchronize()
                want = w4.w4_matmul_ref(x, None, wp, ws).float()
                tol = (2.0**-7 * want.abs()
                       + 1e-3 * K**0.5 * 8 * x.float().abs().max() * ws.max() / 16)
                err, worst = (got - want).abs(), ((got - want).abs() / tol).max().item()
                kind = f"{'group 512' if G else 'per channel'}"
                b = bound(m * K * 2 + N * K // 2 + ws.numel() * 4 + m * N * 2,
                          2.0 * m * K * N, "bf16")
                r = dict(max_abs_err=err.max().item(), library_ms=None, **b)
                text = f"max abs err {err.max().item():.3e}, worst err/bound {worst:.3f}"
                if m >= 731:  # the prefills: timed
                    r["ms"] = cuda_ms(lambda: w4.w4_matmul(x, None, wp, ws))
                    r["plain_ms"] = cuda_ms(lambda: w4.w4_matmul_ref(x, None, wp, ws),
                                            warmup=1, iters=3)
                    _line(f"K4 w4 bf16-x m={m} K={K} N={N} {kind}", text, r["ms"],
                          r["plain_ms"], b)
                else:
                    print(f"  K4 w4 bf16-x m={m} K={K} N={N} {kind}: {text}", flush=True)
                if worst > 1.0:
                    raise SystemExit("chip_smoke: K4 (bf16 x) disagrees with its plain version")
                rows.append(r)
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
               gemv_cases=gemv_cold_cases(g, randn))
    out["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    return out


def check_gemv_graph_replay(g, randn) -> None:
    """K4's GEMV captured in a CUDA graph at down, m 4, groups of 512 (the
    most slices, so the most arrivals per tile), with int8 and bf16 x:
    three replays, each on new x copied in, equal to an eager call on that
    x (the arrival counters are back at zero after every launch)."""
    K, N, G, m = 18944, 3584, 18944 // W4_GROUP, 4
    wp = w4.pack_int4(_rand_int8(g, N, K, lo=-8, hi=8))
    ws = torch.rand(G, N, generator=g, device="cuda") * 0.01 + 0.001
    for int8x in (True, False):
        def new_x():
            if int8x:
                return _rand_int8(g, m, K), torch.rand(m, 1, generator=g, device="cuda") * 0.05
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
                raise SystemExit("chip_smoke: K4's GEMV replayed in a CUDA graph differs from "
                                 "an eager call")
    print(f"  K4 GEMV in a CUDA graph (K={K} N={N} group 512 m={m}, int8 and bf16 x): three "
          "replays on new x equal to eager calls", flush=True)


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


def run_chat_requests(inf: InterleaveInferencer, requests, path: str, expected,
                      rows_out=None) -> dict:
    """Chat requests (indices into REQUESTS) with the counters reset just
    before; ``expected(forwards, decode_steps, image_blocks)`` gives the launch
    counts the path must show. Returns the launches each kernel counted; each
    request's row of times goes to ``rows_out`` where given."""
    images = _images()
    # warm-up request (cuBLAS handles, first launches), not counted or timed
    inf.chat([images[2]], REQUESTS[2][2], max_length=2)

    stamps = []  # embed_tokens runs once per forward: the image and text
    # prefills, then every decode step, whose input is the token just chosen

    def stamp(module, args, output):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    hook = inf.model.language_model.model.embed_tokens.register_forward_hook(stamp)
    reset_counts()
    total_steps, image_blocks, forwards = 0, 0, 0
    for i in requests:
        (h, w, prompt), image = REQUESTS[i], images[i]
        stamps.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        answer = inf.chat([image], prompt, max_length=MAX_LENGTH)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        if not isinstance(answer, str):
            raise SystemExit(f"chip_smoke: chat returned {type(answer)}")
        steps = len(stamps) - 2
        n_img = (h // 14) * (w // 14)
        total_steps += steps
        image_blocks += 1
        forwards += len(stamps)
        row = dict(
            image=f"{h}x{w}", image_tokens=n_img, s_per_image=stamps[1] - t0,
            text_prefill_s=stamps[2] - stamps[1],
            ttft_s=stamps[3] - t0 if steps > 1 else None,
            ttft_after_image_s=stamps[3] - stamps[1] if steps > 1 else None,
            decode_steps=steps,
            decode_tok_s=(steps - 1) / (t_end - stamps[3]) if steps > 1 else None,
        )
        print(f"  request {row['image']}: {json.dumps(row)} answer {answer[:60]!r}", flush=True)
        if rows_out is not None:
            rows_out.append(row)
    hook.remove()
    return check_counts(path, expected(forwards, total_steps, image_blocks))


def run_main_path(inf: InterleaveInferencer) -> dict:
    """The bf16 chat path: three requests through K1a and K2."""
    n_vit, n_llm = inf.cfg.vit.num_hidden_layers, inf.cfg.llm.num_hidden_layers
    return run_chat_requests(inf, range(len(REQUESTS)), "the chat path", lambda f, steps, imgs: {
        "flash_block_attention": imgs * (n_vit + n_llm) + imgs * n_llm,
        "decode_attention": steps * n_llm,
    })


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
    and (c) w4a8 with groups of 512, fused: the 378x378 request; (d)
    weight-only w4 per channel, fused: the 980x980 request (a 4902-row
    prefill through K4's bf16-x GEMM) and the 378x378 one, with x never
    quantized, so K3 runs in no layer. After each, the first-step logits with
    the kernels against the same model on the plain versions (asserted) and
    against the bf16 model (printed: these are non-parity modes, and the
    weights are random). Returns the launches of the phases added up."""
    n_vit, n_llm = inf.cfg.vit.num_hidden_layers, inf.cfg.llm.num_hidden_layers
    fused_per_layer = 4  # qkv, o, gate_up, down of the und expert
    phases = [  # name, options, requests, K4 launches per layer, K3 launches per layer
        ("full-int8 + fused + int8 KV", dict(bits=8, act_quant=True), range(len(REQUESTS)), 0, 1),
        ("w4a8 per channel + fused + int8 KV", dict(bits=4, act_quant=True), [2],
         fused_per_layer, 1),
        (f"w4a8 group {W4_GROUP} + fused + int8 KV",
         dict(bits=4, act_quant=True, group_size=W4_GROUP), [2], fused_per_layer, 1),
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
        qinf = quantized_inferencer(inf, **kw)
        rows = []
        launches = run_chat_requests(qinf, requests, f"the {name} path", lambda f, steps, imgs: {
            "flash_block_attention": imgs * (n_vit + n_llm) + imgs * n_llm,
            "decode_attention_int8": steps * n_llm,
            "silu_mul_quant": f * n_llm * k3_per_layer,
            "w4_matmul": f * n_llm * k4_per_layer,
        }, rows)
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
    print(f"s/image by quantized mode (one request each): {json.dumps(s_per_image)}", flush=True)
    return total


# further numbers a kernel's row of the ``kernels`` line carries, where it has them
EXTRA_KEYS = (
    "one_row_ms", "one_row_ms_back_to_back", "tiles_skipped", "max_abs_err_lse",
    "cache_partial_t2i_ms", "cache_partial_edit_ms", "library_note", "concat_k1b_ms",
    "k_island_ms", "concat_copy_ms", "k1b_on_concat_ms", "q_island_only_ms", "launches_from",
    "n_split", "split_len", "cases", "ms_in_graph", "vit", "gemm", "bf16_gemm",
    "one_row_ms_in_graph", "gemv_cases",
)

COUNTERS = {  # kernel name -> (its wrapper's counts, the key of its launches there)
    "flash_block_attention": (fa.counts, "kernel"),
    "flash_block_attention_q_preproc": (fa.q_preproc_counts, "kernel"),
    "flash_block_attention_lse": (fa.lse_counts, "kernel"),
    "flash_cache_block_attention": (fa.cache_block_counts, "kernel"),
    "decode_attention": (dec.counts, "kernel"),
    "decode_attention_int8": (dec.int8_counts, "kernel"),
    "silu_mul_quant": (aq.counts, "kernel"),
    "w4_matmul": (w4.counts, "kernel"),
    "packed_train_attention_fwd": (fat.counts, "fwd"),
    "packed_train_attention_bwd_dq": (fat.counts, "bwd_dq"),
    "packed_train_attention_bwd_dkv": (fat.counts, "bwd_dkv"),
}


def reset_counts() -> None:
    for c, key in COUNTERS.values():
        c[key] = c["plain"] = 0


def check_counts(path: str, want: dict) -> dict:
    """The launches each kernel counted since reset_counts, against ``want``
    (kernels it does not name: 0); no plain version may have run."""
    want = {name: want.get(name, 0) for name in COUNTERS}
    launches = {name: c[key] for name, (c, key) in COUNTERS.items()}
    plain = {name: c["plain"] for name, (c, _) in COUNTERS.items()}
    print(f"launches on {path}: {launches} (expected {want}); plain versions called "
          f"{plain}", flush=True)
    if launches != want or any(plain.values()):
        raise SystemExit(f"chip_smoke: {path} did not run through the kernels as expected")
    return launches


def _first_step_logits(inf: InterleaveInferencer, image, prompt) -> torch.Tensor:
    ctx = inf.init_gen_context()
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
    forwards that leave the cache as it was."""

    def __init__(self, lm_model):
        self.steps = []  # (start, end, streams)
        self._start = None
        self._hooks = [
            lm_model.register_forward_pre_hook(self._pre, with_kwargs=True),
            lm_model.register_forward_hook(self._post, with_kwargs=True),
        ]

    def _pre(self, module, args, kwargs):
        torch.cuda.synchronize()
        self._start = time.perf_counter()

    def _post(self, module, args, kwargs, output):
        if kwargs.get("update_cache", True):
            return
        torch.cuda.synchronize()
        self.steps.append((self._start, time.perf_counter(), args[0].shape[0]))

    def remove(self):
        for h in self._hooks:
            h.remove()


class SPStepTimer:
    """StepTimer's counterpart for the sequence-parallel denoise, which runs
    the decoder layers itself: stamps (synchronised) before a step's first
    layer and after its last."""

    def __init__(self, lm_model):
        self.steps = []  # (start, end, streams)
        self._start = None
        self._last = len(lm_model.layers) - 1
        self._layer = sp_denoise._sp_decoder_layer
        sp_denoise._sp_decoder_layer = self._timed

    def _timed(self, x, *args, layer_idx=None, **kw):
        if layer_idx == 0:
            torch.cuda.synchronize()
            self._start = time.perf_counter()
        out = self._layer(x, *args, layer_idx=layer_idx, **kw)
        if layer_idx == self._last:
            torch.cuda.synchronize()
            self.steps.append((self._start, time.perf_counter(), x.shape[0]))
        return out

    def remove(self):
        sp_denoise._sp_decoder_layer = self._layer


def _gen_request(inf: InterleaveInferencer, inputs, **kw):
    """One interleave_inference request; returns (image, row of timings)."""
    timer_cls = StepTimer if inf.sp_mesh is None else SPStepTimer
    timer = timer_cls(inf.model.language_model.model)
    decoded = []
    hook = inf.model.vae_model.decoder.register_forward_hook(
        lambda m, a, out: decoded.append((a[0].detach(), out.detach())))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inf.interleave_inference(inputs, image_shapes=GEN_SIZE, **kw)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    finally:
        timer.remove()
        hook.remove()
    image = out[-1]
    z, pixels = decoded[-1]
    if (getattr(image, "size", None) != GEN_SIZE[::-1] or image.mode != "RGB"
            or not bool(torch.isfinite(z).all()) or not bool(torch.isfinite(pixels).all())):
        raise SystemExit(f"chip_smoke: generation returned {image!r}, or non-finite latents")
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
    return image, row


def _edit_image() -> np.ndarray:
    rng = np.random.default_rng(SEED + 2)
    return rng.integers(0, 256, (*GEN_SIZE, 3), dtype=np.uint8)


def run_generation(inf: InterleaveInferencer):
    """A text-to-image request and an image edit at 512x512 with the
    recipe's defaults, counters reset just before. With ``inf.sp_mesh`` the
    denoise is the sequence-parallel program: two K1c launches per layer and
    step in place of one K1b. Returns (the launches, each request's timings)."""
    sp = inf.sp_mesh is not None
    # warm-up edit request (first uses of the shapes, cuDNN set-up), few steps, not counted
    inf.interleave_inference([_edit_image(), EDIT_PROMPT], image_shapes=GEN_SIZE,
                             num_timesteps=3)
    reset_counts()
    requests = [("text-to-image", [GEN_PROMPT]), ("edit", [_edit_image(), EDIT_PROMPT])]
    rows = {}
    for name, inputs in requests:
        _, rows[name] = _gen_request(inf, inputs)
        print(f"  request {name} {GEN_SIZE[0]}x{GEN_SIZE[1]}: {json.dumps(rows[name])}",
              flush=True)
    n_vit, n_llm = inf.cfg.vit.num_hidden_layers, inf.cfg.llm.num_hidden_layers
    steps = 49  # num_timesteps 50
    denoise = 2 * steps * n_llm  # every denoise step of both requests
    launches = check_counts(
        "the sequence-parallel denoise path" if sp else "the generation path", {
            # text prefills: main and cfg_img context in each request; the edit's ViT image
            "flash_block_attention": 2 * 2 * n_llm + (n_vit + n_llm),
            # the edit's VAE prefill, and without sp_mesh every denoise step
            "flash_block_attention_q_preproc": n_llm + (0 if sp else denoise),
            # with sp_mesh: a cache partial and a block partial per layer and step
            "flash_block_attention_lse": 2 * denoise if sp else 0,
            "decode_attention": 0,
        })
    return launches, rows


def _denoise_inputs(inf: InterleaveInferencer, edit: bool = False):
    """(caches, positions, latent position ids, noise) of a 512x512 request's
    denoise, the contexts built as interleave_inference builds them: the
    text-to-image request, or with ``edit`` the image edit."""
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
    caches, positions = inf._stack_contexts([ctx, cfg_text, cfg_img])
    ld = inf.cfg.latent_downsample
    h, w = GEN_SIZE[0] // ld, GEN_SIZE[1] // ld
    pos_ids = torch.from_numpy(inf._position_ids(*GEN_SIZE, ld, inf.cfg.max_latent_size))
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
    caches, positions, pos_ids, noise = _denoise_inputs(inf, edit)
    if mesh is not None:
        x1 = sp_denoise.generate_latents_tp_sp(
            inf.model, caches, positions, pos_ids, noise, inf._start_end(), mesh,
            num_timesteps=2, **RECIPE)
        return noise - x1
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


def _with_plain_versions(fn, fp32_attention: bool = False):
    """fn() with every kernel call swapped for its plain version; with
    ``fp32_attention`` the attention ones run in fp32 (``_upcast``)."""
    flash = _upcast(fa.flash_block_attention_ref) if fp32_attention else \
        fa.flash_block_attention_ref
    decode = _upcast(dec.decode_attention_ref) if fp32_attention else dec.decode_attention_ref
    swapped = [(siglip, "flash_block_attention", flash),
               (qwen2_mot, "flash_block_attention", flash),
               (qwen2_mot, "decode_attention", decode),
               (qwen2_mot, "silu_mul_quant", aq.silu_mul_quant_ref),
               (qwen2_mot, "packed_train_attention", fat.packed_train_attention_ref),
               (sp_denoise, "flash_block_attention", flash),
               (quant, "w4_matmul", w4.w4_matmul_ref)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swapped]
    for mod, name, f in swapped:
        setattr(mod, name, f)
    try:
        return fn()
    finally:
        for mod, name, f in saved:
            setattr(mod, name, f)


def check_velocity_against_plain(inf: InterleaveInferencer, mesh=None) -> dict:
    """The first post-CFG velocity on the same inputs through the kernels,
    the plain versions (bf16 in and out, p rounded to bf16 before P V, as the
    kernels round it) and the plain versions with the attention in fp32;
    asserts kernels vs plain and kernels vs fp32 at VELOCITY_COS_TOL and
    prints the noise floor, plain bf16 vs fp32. Returns the three velocities."""
    v = {"kernels": _first_step_velocity(inf, mesh),
         "plain": _with_plain_versions(lambda: _first_step_velocity(inf, mesh)),
         "fp32": _with_plain_versions(lambda: _first_step_velocity(inf, mesh), True)}
    cos = {pair: _cosine(v[pair[0]], v[pair[1]])
           for pair in (("kernels", "plain"), ("kernels", "fp32"), ("plain", "fp32"))}
    path = "the sequence-parallel path" if mesh is not None else \
        f"text-to-image {GEN_SIZE[0]}x{GEN_SIZE[1]}"
    print(f"end to end ({path}): first-step post-CFG velocity (std "
          f"{v['fp32'].std().item():.3f}), cosine kernels vs plain "
          f"{cos['kernels', 'plain']:.6f}, kernels vs fp32 attention "
          f"{cos['kernels', 'fp32']:.6f}; the noise floor, plain bf16 vs fp32 attention "
          f"{cos['plain', 'fp32']:.6f}; max abs kernels vs fp32 "
          f"{(v['kernels'] - v['fp32']).abs().max().item():.4f}", flush=True)
    if (not bool(torch.isfinite(v["kernels"]).all()) or v["kernels"].shape != v["fp32"].shape
            or min(cos[("kernels", "plain")], cos[("kernels", "fp32")]) < VELOCITY_COS_TOL):
        raise SystemExit(f"chip_smoke: the velocity of {path} disagrees with the plain versions'")
    return v


def _cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    return torch.nn.functional.cosine_similarity(a.flatten(), b.flatten(), dim=0).item()


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
        step = lambda: bagel.generate_latents(  # noqa: E731
            inf.model, caches, positions, pos_ids, noise, inf._start_end(), num_timesteps=50,
            step_range=(0, 1), **RECIPE)
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


def make_sp_mesh(rendezvous_dir: str):
    """The ("model", "seq") mesh of one rank. Where NCCL is built in and a
    one-rank group starts (tried in a child process first, under a time limit:
    a communicator that cannot start must not take this run with it), the mesh
    sits on a real NCCL group with a one-rank group per axis, so the path's
    all-reduces and all-gathers really run; otherwise it has no group and every
    collective is the identity. Prints which."""
    axes, sizes = ("model", "seq"), (1, 1)
    dist = torch.distributed
    if not (dist.is_available() and dist.is_nccl_available()):
        print("sequence-parallel mesh 1 x 1: NCCL is not built into this torch; no process "
              "group, collectives are the identity", flush=True)
        return pmesh.make_mesh(axes, sizes)
    try:
        probe = subprocess.run([sys.executable, "-c", NCCL_PROBE], capture_output=True,
                               text=True, timeout=120)
        failed = None if probe.returncode == 0 else probe.stderr.strip().splitlines()[-1:]
    except subprocess.TimeoutExpired:
        failed = ["no answer within 120 s"]
    if failed is not None:
        print(f"sequence-parallel mesh 1 x 1: a one-rank NCCL group did not start ({failed}); "
              "no process group, collectives are the identity", flush=True)
        return pmesh.make_mesh(axes, sizes)
    dist.init_process_group(
        "nccl", init_method=f"file://{rendezvous_dir}/rendezvous", world_size=1, rank=0,
        timeout=datetime.timedelta(seconds=120))
    mesh = pmesh.make_mesh(axes, sizes, singleton_groups=True)
    print("sequence-parallel mesh 1 x 1 on a one-rank NCCL group (file:// rendezvous): the "
          "path's all-reduces and all-gathers really run", flush=True)
    return mesh


def run_sp_generation(inf: InterleaveInferencer, mesh, plain_rows: dict) -> dict:
    """The sequence-parallel denoise path on the 1 x 1 mesh: the text-to-image
    request and the edit through an inferencer with ``sp_mesh``, timed beside
    ``plain_rows`` (the same requests without it, earlier in this run); then
    the path against the single-device one on the same noise: the final latent
    of the text-to-image denoise (all 49 steps) and the first post-CFG
    velocity, the latter also against the plain versions."""
    sp_inf = InterleaveInferencer(inf.model, inf.tokenizer, inf.new_token_ids,
                                  vit_transform=inf.vit_transform, seed=SEED, sp_mesh=mesh)
    launches, rows = run_generation(sp_inf)
    for name, row in rows.items():
        base = plain_rows[name]
        print(f"  {name}: " + "; ".join(
            f"{key} {row[key]:.3f} with sp_mesh, {base[key]:.3f} without"
            for key in ("s_per_image", "denoise_s", "ms_per_3_stream_step",
                        "ms_per_1_stream_step")), flush=True)
    caches, positions, pos_ids, noise = _denoise_inputs(inf)
    args = (inf.model, caches, positions, pos_ids, noise, inf._start_end())
    x_sp = sp_denoise.generate_latents_tp_sp(*args, mesh, num_timesteps=50, **RECIPE)
    x_one = bagel.generate_latents(*args, num_timesteps=50, **RECIPE)
    cos, finite = _cosine(x_sp, x_one), bool(torch.isfinite(x_sp).all())
    moved = (x_one - noise).std().item()
    print(f"end to end (text-to-image {GEN_SIZE[0]}x{GEN_SIZE[1]}, 49 steps, the same noise): "
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
# the training path
# ---------------------------------------------------------------------------

LORA_SEQ_LEN = 6144  # room for the 980 px VQA example (4900 patches) beside another
LORA_RANK = 16
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


def train_examples(with_980: bool):
    """Synthetic examples of the three tasks at real sizes: VQA at 980 px
    (``with_980``) and 378 px, text-to-image at 512 px, an edit of a 512 px
    image (its source also goes through the ViT, at 504 px)."""
    ex = dataset.Example
    out = [
        ex("vlm_sft", REQUESTS[2][2], image=_pil(11, 378, 378),
           answer="No effusion is seen; both costophrenic angles are sharp."),
        ex("t2i_pretrain", GEN_PROMPT, image=_pil(12, *GEN_SIZE)),
        ex("unified_edit", EDIT_PROMPT, image=_pil(13, *GEN_SIZE), target_image=_pil(14, *GEN_SIZE)),
    ]
    if with_980:
        out.insert(0, ex("vlm_sft", REQUESTS[0][2], image=_pil(10, 980, 980),
                         answer="A rounded opacity projects over the right lower zone."))
    return out


def train_batches(model, tok, new_token_ids, examples, seq_len: int) -> dataset.Prefetcher:
    """Packed batches of one sequence each, prepared and copied to the card by
    the prefetcher's worker thread; the latents come from the model's VAE."""
    from unimedvl_tpu_torch.data.imaging import ImageTransform

    vit, vae = TransformConfig.vit_vqa(), TransformConfig.vae_interactive()
    it = dataset.PackedBatchIterator(
        examples, tok, new_token_ids, model.config,
        ImageTransform(vit.max_size, vit.min_size, vit.stride, vit.max_pixels),
        ImageTransform(vae.max_size, vae.min_size, vae.stride, vae.max_pixels),
        latent_fn=dataset.make_latent_fn(model), batch_size=1, seq_len=seq_len, seed=SEED)
    return dataset.Prefetcher(it, depth=2, place_fn=dataset.make_place_fn(DEVICE))


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


def _k5_case(name, ids, g, timed: bool):
    """K5 (forward and the three gradients) against its plain version on one
    set of segment ids, at the LLM's heads; with ``timed``, also the three
    kernels' times, the plain version's, SDPA's and the card's bounds."""
    H, Hk, D = 28, 4, 128
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
    its 16- or 32-bit words): any update of a tensor changes it."""
    words = {2: torch.int16, 4: torch.int32}
    return {n: int(torch.sum(p.detach().view(words[p.element_size()]), dtype=torch.int64))
            for n, p in named}


def _draw_noises(seqs, g):
    return [torch.randn(s["vae_clean_tokens"].shape, generator=g, device=DEVICE)
            if "vae_clean_tokens" in s else None for s in seqs]


def _loss_and_grads(model, seqs, noises):
    loss = trainer.loss_fn(model, seqs, noises, backward_scale=1.0)
    grads = {n: p.grad.float() for n, p in model.named_parameters() if p.grad is not None}
    for p in model.parameters():
        p.grad = None
    return float(loss), grads


def _run_steps(step, state, batches, it, g, per_step: int, n_llm: int, n_vit: int, path: str,
               frozen_vit: bool):
    """TRAIN_STEPS steps with the counters reset just before: each takes
    ``per_step`` batches (the given ones first, then the prefetcher's).
    Prints the losses and times and checks the launch counts: with per-layer
    recomputation the forward kernel runs twice per layer and sequence, each
    backward kernel once; a frozen ViT goes through K1a, a trained one through
    plain attention. Returns (state, launches)."""
    batches = list(batches)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    n_seq = n_vit_seq = 0
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while len(batches) < per_step:
            batches.append(next(it))
        taken, batches = batches[:per_step], batches[per_step:]
        t1 = time.perf_counter()
        state, loss = step(state, taken if per_step > 1 else taken[0], generator=g)
        loss = float(loss)
        t2 = time.perf_counter()  # float() waited for the card
        seqs = [s for b in taken for s in b]
        n_seq += len(seqs)
        n_vit_seq += sum("vit_patch_tokens" in s for s in seqs)
        tokens = sum(s["mask_document_id"].shape[0] for s in seqs)
        real = sum(int((s["mask_document_id"] > 0).sum()) for s in seqs)
        print(f"  step {i}: loss {loss:.4f}; {len(seqs)} sequence(s), {tokens} packed tokens "
              f"({real} real); waited {t1 - t0:.3f} s for the batch, step {t2 - t1:.3f} s, "
              f"{tokens / (t2 - t1):.0f} packed tokens/s", flush=True)
        if not np.isfinite(loss):
            raise SystemExit(f"chip_smoke: {path}: the loss is not finite")
    print(f"  peak memory over the steps: {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB",
          flush=True)
    launches = check_counts(path, {
        "packed_train_attention_fwd": 2 * n_llm * n_seq,
        "packed_train_attention_bwd_dq": n_llm * n_seq,
        "packed_train_attention_bwd_dkv": n_llm * n_seq,
        "flash_block_attention": n_vit * n_vit_seq if frozen_vit else 0,
    })
    return state, launches


def run_lora(inf: InterleaveInferencer, it, first) -> dict:
    """The slice's full-depth path: adapters of rank 16 on every projection
    of both experts of the 28-layer bf16 model, ``make_lora_train_step``."""
    model, cfg = inf.model, inf.model.config
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
    # the first step's loss and adapter gradients, kernels against plain attention
    noises = _draw_noises(first, g)
    loss_k, grads_k = _loss_and_grads(model, first, noises)
    loss_p, grads_p = _with_plain_versions(lambda: _loss_and_grads(model, first, noises))
    flat_k = torch.cat([grads_k[n].flatten() for n in sorted(grads_k)])
    flat_p = torch.cat([grads_p[n].flatten() for n in sorted(grads_k)])
    cos = torch.nn.functional.cosine_similarity(flat_k, flat_p, dim=0).item()
    per = {n: torch.nn.functional.cosine_similarity(
        grads_k[n].flatten(), grads_p[n].flatten(), dim=0).item()
        for n in grads_k if n.endswith("lora_b")}
    worst = min(per, key=per.get)
    print(f"  first step, kernels vs plain attention ({_describe(first[0])}): loss {loss_k:.5f} "
          f"vs {loss_p:.5f}; adapter gradients: cosine {cos:.6f} over {flat_k.numel()} values "
          f"(norm {flat_k.norm().item():.4f}), worst tensor {per[worst]:.6f} ({worst})",
          flush=True)
    if not (abs(loss_k - loss_p) <= LOSS_REL_TOL * abs(loss_p) and cos >= GRAD_COS_TOL
            and bool(torch.isfinite(flat_k).all())):
        raise SystemExit("chip_smoke: the LoRA step with the kernels disagrees with the same "
                         "step with plain attention")
    del grads_k, grads_p, flat_k, flat_p
    state, launches = _run_steps(step, state, [first], it, g, 1, n_llm, n_vit,
                                 "the LoRA training path", frozen_vit=True)
    still = [n for n, c in _checksums(base).items() if c != before[n]]
    unmoved = [i for i, m in enumerate(adapters) if not bool((m.lora_b != 0).any())]
    print(f"  after {state.step} steps: {len(adapters) - len(unmoved)} of {len(adapters)} lora_b "
          f"moved from zero; base tensors whose bits changed: {len(still)} of {len(base)}",
          flush=True)
    if still or unmoved or any(p.grad is not None or p.requires_grad for _, p in base):
        raise SystemExit("chip_smoke: LoRA moved the base, or left an adapter where it was")
    return launches


def build_trainable(n_layers: int, freeze_und: bool) -> bagel.Bagel:
    """The full width at ``n_layers`` LLM layers (the ViT at its full depth),
    random bf16 weights and an fp32 VAE from the seed."""
    import dataclasses

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
        it = train_batches(model, tok, new_token_ids, train_examples(False), FT_SEQ_LEN)
        try:
            paths.append(_finetune(model, it, freeze_und))
        finally:  # a worker left running would abort the interpreter's exit
            it.close(wait=True)
        del model, it
        gc.collect()
        torch.cuda.empty_cache()
    return paths


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
    if not freeze_und:  # one step alone, to hold the EMA to its recurrence
        ema_before = {n: state.ema_params[n].clone() for n in watch.values()}
        state, _ = step(state, [next(it) for _ in range(FT_ACCUM)], generator=g)
        for n, prev in ema_before.items():
            want = FT_EMA_DECAY * prev + (1 - FT_EMA_DECAY) * params[n].detach().float()
            torch.testing.assert_close(state.ema_params[n], want, rtol=1e-6, atol=1e-9)
        print(f"  the EMA shadow obeys ema = {FT_EMA_DECAY} ema + {1 - FT_EMA_DECAY:.3f} param "
              f"after the first update ({len(ema_before)} tensors, fp32)", flush=True)
    state, launches = _run_steps(step, state, [], it, g, FT_ACCUM, cfg.llm.num_hidden_layers,
                                 cfg.vit.num_hidden_layers, f"the {name} path",
                                 frozen_vit=False)
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
    return launches


def run_training(inf: InterleaveInferencer):
    """The training phases; returns (K5's timings, the launches of each path)."""
    tok, ids = inf.tokenizer, inf.new_token_ids
    lora_it = train_batches(inf.model, tok, ids, train_examples(True), LORA_SEQ_LEN)
    ft_it = train_batches(inf.model, tok, ids, train_examples(False), FT_SEQ_LEN)
    try:
        first, ft_first = next(lora_it), next(ft_it)
        ft_it.close(wait=True)
        timings = check_packed_train_attention(ft_first[0], first[0])
        print(f"LoRA training path: {TRAIN_STEPS} steps over the full-depth model, one packed "
              f"sequence of {LORA_SEQ_LEN} tokens per step", flush=True)
        return timings, [run_lora(inf, lora_it, first)]
    finally:  # a worker left running would abort the interpreter's exit
        ft_it.close(wait=True)
        lora_it.close(wait=True)


def main() -> None:
    check_device()
    with tempfile.TemporaryDirectory() as tmp:
        try:
            run(tmp)
        finally:
            if torch.distributed.is_available() and torch.distributed.is_initialized():
                torch.distributed.destroy_process_group()


def run(tmp: str) -> None:
    build_kernels()
    timings = check_kernels()
    time_int8_matmul_candidates(torch.Generator(device="cuda").manual_seed(SEED + 4))
    torch.cuda.empty_cache()
    inf = build_inferencer()
    print("chat path: 3 chat requests, greedy, max_length "
          f"{MAX_LENGTH}, full 14B geometry, random weights (seed {SEED})", flush=True)
    paths = [run_main_path(inf)]
    logits_bf16 = check_against_plain_path(inf)
    print(f"generation path: text-to-image and an image edit at {GEN_SIZE[0]}x{GEN_SIZE[1]}, "
          "50 timesteps, CFG text 3.0 / image 1.5 on (0.4, 1.0], global renorm", flush=True)
    launches, plain_rows = run_generation(inf)
    paths.append(launches)
    check_velocity_against_plain(inf)
    print("K6 inside the model: the first denoise step of each request, its attention swapped "
          "for K6", flush=True)
    paths.append(run_cache_block_step(inf))
    print("sequence-parallel denoise path: the same two requests through "
          "InterleaveInferencer(sp_mesh=...), full depth", flush=True)
    paths.append(run_sp_generation(inf, make_sp_mesh(tmp), plain_rows))
    paths.append(run_quantized_chat(inf, logits_bf16))
    train_timings, train_paths = run_training(inf)
    timings.update(train_timings)
    paths += train_paths
    tok, new_token_ids = inf.tokenizer, inf.new_token_ids
    del inf  # the 28-layer model makes room for the full fine-tune's state
    gc.collect()
    torch.cuda.empty_cache()
    paths += run_full_finetune(tok, new_token_ids)
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
        "w4_matmul": ("unimedvl_tpu_torch/csrc/w4_matmul.cu",
                      "unimedvl_tpu/ops/w4_matmul.py:202"),
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
    timings["flash_cache_block_attention"]["launches_from"] = (
        "a denoise step with K6 swapped in; no entry point routes through it")
    kernels = [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=sum(p[name] for p in paths), **{k: timings[name][k] for k in keys},
             **{k: v for k, v in timings[name].items() if k in EXTRA_KEYS})
        for name, (src, rep) in sources.items()
    ]
    unlaunched = [k["name"] for k in kernels if k["launches"] < 1]
    if unlaunched:
        raise SystemExit(f"chip_smoke: no path launched {unlaunched}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
