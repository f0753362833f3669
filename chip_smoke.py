"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): builds the CUDA
kernels from ``unimedvl_tpu_torch/csrc``, holds each kernel against its plain
PyTorch version at the main path's shapes, then answers three VQA chat
requests with the full 14B geometry (random bf16 weights from a seed) through
``InterleaveInferencer.chat`` and checks that every attention of that path
went through the kernels.

    python3 chip_smoke.py

Needs a CUDA device; exits non-zero without one, or on any failed check. The
last line of standard output is ``{"ok": true, "device": {...}}``; the line
before it lists each kernel with its launches on the main path, its error
against the plain version and both times.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from unimedvl_tpu.config import BagelConfig, LLMConfig, TransformConfig, VAEConfig, ViTConfig
from unimedvl_tpu.data.tokenizer import add_special_tokens
from unimedvl_tpu_torch.inference import InterleaveInferencer
from unimedvl_tpu_torch.models import bagel, qwen2_mot, siglip
from unimedvl_tpu_torch.ops import cuda_build
from unimedvl_tpu_torch.ops import decode_attention as dec
from unimedvl_tpu_torch.ops import flash_attention as fa

SEED = 0
# kernel vs plain version (fp32 softmax over the same bf16 inputs): the kernel
# rounds P to bf16 for the P V product and its output to bf16 (half an ulp is
# 2^-9 of the value), so each element must satisfy
# |kernel - plain| <= ATOL + RTOL * |plain|, and the mean error stay small
ATOL = 1e-2
RTOL = 2.0**-7
MEAN_ABS_TOL = 2e-3
# the whole path with kernels vs with the plain versions, first-step logits
LOGITS_COS_TOL = 0.999
REQUESTS = [  # (height, width, prompt): already at stride-14 sizes
    (980, 980, "What abnormality is visible in this chest radiograph?"),
    (378, 532, "Which organ is shown, and is the finding benign?"),
    (378, 378, "Is there a pleural effusion in this image?"),
]
MAX_LENGTH = 32


class ByteTokenizer:
    """Byte-level tokenizer: ids 0-255 are bytes, special tokens from 256 up.
    Other ids decode as ``<id>``."""

    def __init__(self):
        self.specials = {}
        self.special_tokens_map = {}

    def add_tokens(self, tokens):
        for t in tokens:
            self.specials.setdefault(t, 256 + len(self.specials))
        return len(tokens)

    def convert_tokens_to_ids(self, tok):
        return self.specials[tok]

    def encode(self, text):
        return list(text.encode("utf-8"))

    def decode(self, ids):
        inv = {v: k for k, v in self.specials.items()}
        return "".join(inv.get(i, chr(i) if i < 128 else f"<{i}>") for i in ids)


def cuda_ms(fn, warmup: int = 2, iters: int = 7) -> float:
    """Median milliseconds of ``fn`` on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def _compare(name, kernel_fn, plain_fn, rows):
    """Kernel vs plain on the valid query rows [:, :rows]; both times."""
    got = kernel_fn()
    torch.cuda.synchronize()
    want = plain_fn()
    ref = want[:, :rows].float()
    diff = (got[:, :rows].float() - ref).abs()
    max_abs, mean_abs = diff.max().item(), diff.mean().item()
    worst = (diff / (ATOL + RTOL * ref.abs())).max().item()
    ms, plain_ms = cuda_ms(kernel_fn), cuda_ms(plain_fn, warmup=1, iters=3)
    print(f"  {name}: max_abs_err {max_abs:.3e} mean_abs_err {mean_abs:.3e} "
          f"worst err/bound {worst:.3f} (|ref| max {ref.abs().max().item():.3f}); "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)
    if not (worst <= 1.0 and mean_abs <= MEAN_ABS_TOL):
        raise SystemExit(f"chip_smoke: {name} disagrees with its plain version")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}


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

    results = {"flash_block_attention": [], "decode_attention": []}
    # K1a, ViT: 980 px image = 4900 patches in the 5120 bucket, D = 72, k/v [N, T, H, D]
    T = 5120
    q, k, v = randn(1, T, 16, 72, scale=2.0), randn(1, T, 16, 72), randn(1, T, 16, 72)
    lens, bstart = ints(4900), ints(T)
    results["flash_block_attention"].append(_compare(
        "K1a ViT T=5120 D=72 non-causal, 4900 valid",
        lambda: fa.flash_block_attention(q, k, v, lens, bstart, False),
        lambda: fa.flash_block_attention_ref(q, k, v, lens, bstart, False), 4900))
    # K1a, LLM image block: T = 5122 over a 5632-column head-major cache, 4902 valid
    M = 5632
    q = randn(1, 5122, 28, 128, scale=2.0)
    kc, vc = randn(1, 4, M, 128), randn(1, 4, M, 128)
    zero, qvl = ints(0), ints(4902)
    image = _compare(
        "K1a image prefill T=5122 M=5632 D=128 non-causal",
        lambda: fa.flash_block_attention(q, kc, vc, zero, zero, False, qvl, True),
        lambda: fa.flash_block_attention_ref(q, kc, vc, zero, zero, False, qvl, True), 4902)
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
    step = _compare(
        "K2 decode S=1 M=5632 lens=4950 band [4950, 4960]",
        lambda: dec.decode_attention(qd, kc, vc, lens, (base, col)),
        lambda: dec.decode_attention_ref(qd, kc, vc, lens, (base, col)), 1)
    results["decode_attention"].append(step)
    # K2: three streams with differing lens and the aligned band
    qd3 = randn(3, 1, 28, 128, scale=2.0)
    kc3, vc3 = randn(3, 4, M, 128), randn(3, 4, M, 128)
    lens3, base3, col3 = ints(100, 2000, 4950), ints(4950, 4950, 4950), ints(4955, 4955, 4955)
    results["decode_attention"].append(_compare(
        "K2 decode S=3 lens (100, 2000, 4950) band [4950, 4955]",
        lambda: dec.decode_attention(qd3, kc3, vc3, lens3, (base3, col3)),
        lambda: dec.decode_attention_ref(qd3, kc3, vc3, lens3, (base3, col3)), 1))
    return {
        "flash_block_attention": dict(
            max_abs_err=max(r["max_abs_err"] for r in results["flash_block_attention"]),
            ms=image["ms"], plain_ms=image["plain_ms"]),
        "decode_attention": dict(
            max_abs_err=max(r["max_abs_err"] for r in results["decode_attention"]),
            ms=step["ms"], plain_ms=step["plain_ms"]),
    }


def full_config() -> BagelConfig:
    """The released 14B geometry (scripts/make_synthetic_ckpt.py): LLM 28 layers,
    hidden 3584, 28/4 heads, MLP 18944, vocab 152064; SigLIP 26 layers, 1152."""
    return BagelConfig(llm=LLMConfig(), vit=ViTConfig(), vae=VAEConfig())


def build_inferencer() -> InterleaveInferencer:
    from unimedvl_tpu.data.imaging import ImageTransform

    t0 = time.perf_counter()
    cfg = full_config()
    model = bagel.Bagel(cfg, device="meta", dtype=torch.bfloat16).to_empty(device="cuda")
    bagel.init_random_(model, torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params / 1e9:.2f} B params bf16 on the card, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    tok, new_token_ids, _ = add_special_tokens(ByteTokenizer())
    vqa = TransformConfig.vit_vqa()
    transform = ImageTransform(vqa.max_size, vqa.min_size, vqa.stride, vqa.max_pixels)
    return InterleaveInferencer(model, tok, new_token_ids, vit_transform=transform, seed=SEED)


def _images():
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w, _ in REQUESTS]


def run_main_path(inf: InterleaveInferencer) -> dict:
    """Three chat requests with the counters reset just before; returns the
    launches each kernel counted."""
    images = _images()
    # warm-up request (cuBLAS handles, first launches), not counted or timed
    inf.chat([images[2]], REQUESTS[2][2], max_length=2)

    stamps = []  # embed_tokens runs once per forward: the image and text
    # prefills, then every decode step, whose input is the token just chosen

    def stamp(module, args, output):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    hook = inf.model.language_model.model.embed_tokens.register_forward_hook(stamp)
    fa.counts.update(kernel=0, plain=0)
    dec.counts.update(kernel=0, plain=0)
    total_steps, image_blocks = 0, 0
    per_request = []
    for (h, w, prompt), image in zip(REQUESTS, images):
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
        row = dict(
            image=f"{h}x{w}", image_tokens=n_img, s_per_image=stamps[1] - t0,
            text_prefill_s=stamps[2] - stamps[1],
            ttft_s=stamps[3] - t0 if steps > 1 else None,
            ttft_after_image_s=stamps[3] - stamps[1] if steps > 1 else None,
            decode_steps=steps,
            decode_tok_s=(steps - 1) / (t_end - stamps[3]) if steps > 1 else None,
        )
        per_request.append(row)
        print(f"  request {row['image']}: {json.dumps(row)} answer {answer[:60]!r}", flush=True)
    hook.remove()
    launches = {"flash_block_attention": fa.counts["kernel"], "decode_attention": dec.counts["kernel"]}
    n_vit, n_llm = inf.cfg.vit.num_hidden_layers, inf.cfg.llm.num_hidden_layers
    want = {
        "flash_block_attention": image_blocks * (n_vit + n_llm) + len(REQUESTS) * n_llm,
        "decode_attention": total_steps * n_llm,
    }
    print(f"launches on the main path: {launches} (expected {want}); plain versions "
          f"called {fa.counts['plain']} + {dec.counts['plain']} times", flush=True)
    if launches != want or fa.counts["plain"] or dec.counts["plain"]:
        raise SystemExit("chip_smoke: the main path did not run through the kernels as expected")
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


def check_against_plain_path(inf: InterleaveInferencer) -> None:
    """The second request's first-step logits with the kernels vs with every
    attention call swapped for its plain version (fp32 softmax)."""
    h, w, prompt = REQUESTS[1]
    image = _images()[1]
    got = _first_step_logits(inf, image, prompt)
    swapped = [(siglip, "flash_block_attention", fa.flash_block_attention_ref),
               (qwen2_mot, "flash_block_attention", fa.flash_block_attention_ref),
               (qwen2_mot, "decode_attention", dec.decode_attention_ref)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swapped]
    for mod, name, fn in swapped:
        setattr(mod, name, fn)
    try:
        want = _first_step_logits(inf, image, prompt)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    cos = torch.nn.functional.cosine_similarity(got, want, dim=0).item()
    max_abs = (got - want).abs().max().item()
    finite = bool(torch.isfinite(got).all())
    print(f"end to end ({h}x{w}): first-step logits kernels vs plain: cosine {cos:.6f}, "
          f"max abs {max_abs:.4f} (logits std {want.std().item():.3f}), argmax "
          f"{got.argmax().item()} vs {want.argmax().item()}, finite {finite}", flush=True)
    if not finite or got.shape != (inf.cfg.llm.vocab_size,) or cos < LOGITS_COS_TOL:
        raise SystemExit("chip_smoke: the kernel path's logits disagree with the plain path's")


def main() -> None:
    check_device()
    build_kernels()
    timings = check_kernels()
    torch.cuda.empty_cache()
    inf = build_inferencer()
    print("main path: 3 chat requests, greedy, max_length "
          f"{MAX_LENGTH}, full 14B geometry, random weights (seed {SEED})", flush=True)
    launches = run_main_path(inf)
    check_against_plain_path(inf)
    kernels = [
        dict(name="flash_block_attention", route="cuda",
             source="unimedvl_tpu_torch/csrc/flash_block_attention.cu",
             replaces="unimedvl_tpu/ops/flash_attention.py:209",
             launches=launches["flash_block_attention"], **timings["flash_block_attention"]),
        dict(name="decode_attention", route="cuda",
             source="unimedvl_tpu_torch/csrc/decode_attention.cu",
             replaces="unimedvl_tpu/ops/decode_attention.py:130",
             launches=launches["decode_attention"], **timings["decode_attention"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
