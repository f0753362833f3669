"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): builds the CUDA
kernels from ``unimedvl_tpu_torch/csrc``, holds each kernel against its plain
PyTorch version at the paths' shapes, then, with the full 14B geometry
(random bf16 weights and an fp32 VAE from a seed):

- the chat path: three VQA requests through ``InterleaveInferencer.chat``;
- the generation path: a 512x512 text-to-image request and a 512x512 image
  edit through ``interleave_inference`` with the recipe's defaults (50
  timesteps, CFG text 3.0 and image 1.5 on the interval (0.4, 1.0], global
  renorm);

and checks that every attention of each path went through the kernels, and
that each path's output agrees with the same computation on the plain
attention versions.

    python3 chip_smoke.py

Needs a CUDA device; exits non-zero without one, or on any failed check. The
last line of standard output is ``{"ok": true, "device": {...}}``; the line
before it lists each kernel with its launches on the paths, its error
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
from unimedvl_tpu_torch.ops.rope import rope_cos_sin

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
VELOCITY_COS_TOL = 0.999
REQUESTS = [  # (height, width, prompt): already at stride-14 sizes
    (980, 980, "What abnormality is visible in this chest radiograph?"),
    (378, 532, "Which organ is shown, and is the finding benign?"),
    (378, 378, "Is there a pleural effusion in this image?"),
]
MAX_LENGTH = 32
GEN_SIZE = (512, 512)
GEN_PROMPT = "A chest radiograph with a small left pleural effusion."
EDIT_PROMPT = "Make the opacity in the right lower lobe more visible."


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

    results = {"flash_block_attention": [], "decode_attention": [], "q_preproc": []}
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
    denoise = check_q_preproc(randn, ints, results["q_preproc"])
    return {
        "flash_block_attention": dict(
            max_abs_err=max(r["max_abs_err"] for r in results["flash_block_attention"]),
            ms=image["ms"], plain_ms=image["plain_ms"]),
        "flash_block_attention_q_preproc": dict(
            max_abs_err=max(r["max_abs_err"] for r in results["q_preproc"]),
            ms=denoise["ms"], plain_ms=denoise["plain_ms"]),
        "decode_attention": dict(
            max_abs_err=max(r["max_abs_err"] for r in results["decode_attention"]),
            ms=step["ms"], plain_ms=step["plain_ms"]),
    }


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
            T if qvl is None else qvl)
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
    from unimedvl_tpu.data.imaging import ImageTransform

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
    reset_counts()
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
    n_vit, n_llm = inf.cfg.vit.num_hidden_layers, inf.cfg.llm.num_hidden_layers
    return check_counts("the chat path", {
        "flash_block_attention": image_blocks * (n_vit + n_llm) + len(REQUESTS) * n_llm,
        "flash_block_attention_q_preproc": 0,
        "decode_attention": total_steps * n_llm,
    })


COUNTERS = {  # kernel name -> its wrapper's counts
    "flash_block_attention": fa.counts,
    "flash_block_attention_q_preproc": fa.q_preproc_counts,
    "decode_attention": dec.counts,
}


def reset_counts() -> None:
    for c in COUNTERS.values():
        c.update(kernel=0, plain=0)


def check_counts(path: str, want: dict) -> dict:
    """The launches each kernel counted since reset_counts, against ``want``;
    no plain version may have run."""
    launches = {name: c["kernel"] for name, c in COUNTERS.items()}
    plain = {name: c["plain"] for name, c in COUNTERS.items()}
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


def check_against_plain_path(inf: InterleaveInferencer) -> None:
    """The second request's first-step logits with the kernels vs with every
    attention call swapped for its plain version (fp32 softmax)."""
    h, w, prompt = REQUESTS[1]
    image = _images()[1]
    got = _first_step_logits(inf, image, prompt)
    want = _with_plain_attention(lambda: _first_step_logits(inf, image, prompt))
    cos = torch.nn.functional.cosine_similarity(got, want, dim=0).item()
    max_abs = (got - want).abs().max().item()
    finite = bool(torch.isfinite(got).all())
    print(f"end to end ({h}x{w}): first-step logits kernels vs plain: cosine {cos:.6f}, "
          f"max abs {max_abs:.4f} (logits std {want.std().item():.3f}), argmax "
          f"{got.argmax().item()} vs {want.argmax().item()}, finite {finite}", flush=True)
    if not finite or got.shape != (inf.cfg.llm.vocab_size,) or cos < LOGITS_COS_TOL:
        raise SystemExit("chip_smoke: the kernel path's logits disagree with the plain path's")


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


def _gen_request(inf: InterleaveInferencer, inputs, **kw):
    """One interleave_inference request; returns (image, row of timings)."""
    timer = StepTimer(inf.model.language_model.model)
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


def run_generation(inf: InterleaveInferencer) -> dict:
    """A text-to-image request and an image edit at 512x512 with the
    recipe's defaults, counters reset just before; returns the launches."""
    # warm-up edit request (first uses of the shapes, cuDNN set-up), few steps, not counted
    inf.interleave_inference([_edit_image(), EDIT_PROMPT], image_shapes=GEN_SIZE,
                             num_timesteps=3)
    reset_counts()
    requests = [("text-to-image", [GEN_PROMPT]), ("edit", [_edit_image(), EDIT_PROMPT])]
    for name, inputs in requests:
        _, row = _gen_request(inf, inputs)
        print(f"  request {name} {GEN_SIZE[0]}x{GEN_SIZE[1]}: {json.dumps(row)}", flush=True)
    n_vit, n_llm = inf.cfg.vit.num_hidden_layers, inf.cfg.llm.num_hidden_layers
    steps = 49  # num_timesteps 50
    return check_counts("the generation path", {
        # text prefills: main and cfg_img context in each request; the edit's ViT image
        "flash_block_attention": 2 * 2 * n_llm + (n_vit + n_llm),
        # every denoise step of both requests, and the edit's VAE prefill
        "flash_block_attention_q_preproc": 2 * steps * n_llm + n_llm,
        "decode_attention": 0,
    })


def _first_step_velocity(inf: InterleaveInferencer) -> torch.Tensor:
    """Post-CFG velocity of the first flow step of the text-to-image request
    (contexts built as interleave_inference builds them)."""
    ctx = inf.init_gen_context()
    cfg_img, cfg_text = ctx.fork(), ctx.fork()
    ctx = inf.update_context_text(GEN_PROMPT, ctx)
    cfg_img = inf.update_context_text(GEN_PROMPT, cfg_img)
    caches, positions = inf._stack_contexts([ctx, cfg_text, cfg_img])
    ld = inf.cfg.latent_downsample
    h, w = GEN_SIZE[0] // ld, GEN_SIZE[1] // ld
    pos_ids = torch.from_numpy(inf._position_ids(*GEN_SIZE, ld, inf.cfg.max_latent_size))
    g = torch.Generator(device=inf.device).manual_seed(SEED + 3)
    noise = torch.randn(h * w, inf.cfg.patch_latent_dim, generator=g, device=inf.device)
    x1 = bagel.generate_latents(
        inf.model, caches, positions, pos_ids.to(inf.device), noise, inf._start_end(),
        num_timesteps=50, timestep_shift=3.0, cfg_text_scale=3.0, cfg_img_scale=1.5,
        cfg_interval=(0.4, 1.0), use_text_cfg=True, use_img_cfg=True, step_range=(0, 1),
    )
    _, dts = bagel.flow_timesteps(50, 3.0)
    return (noise - x1) / float(dts[0])


def _with_plain_attention(fn):
    """fn() with every attention call swapped for its plain version."""
    swapped = [(siglip, "flash_block_attention", fa.flash_block_attention_ref),
               (qwen2_mot, "flash_block_attention", fa.flash_block_attention_ref),
               (qwen2_mot, "decode_attention", dec.decode_attention_ref)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swapped]
    for mod, name, f in swapped:
        setattr(mod, name, f)
    try:
        return fn()
    finally:
        for mod, name, f in saved:
            setattr(mod, name, f)


def check_velocity_against_plain(inf: InterleaveInferencer) -> None:
    got = _first_step_velocity(inf)
    want = _with_plain_attention(lambda: _first_step_velocity(inf))
    cos = torch.nn.functional.cosine_similarity(got.flatten(), want.flatten(), dim=0).item()
    finite = bool(torch.isfinite(got).all())
    print(f"end to end (text-to-image {GEN_SIZE[0]}x{GEN_SIZE[1]}): first-step post-CFG "
          f"velocity, kernels vs plain: cosine {cos:.6f}, max abs "
          f"{(got - want).abs().max().item():.4f} (velocity std {want.std().item():.3f}), "
          f"finite {finite}", flush=True)
    if not finite or got.shape != want.shape or cos < VELOCITY_COS_TOL:
        raise SystemExit("chip_smoke: the kernel path's velocity disagrees with the plain path's")


def main() -> None:
    check_device()
    build_kernels()
    timings = check_kernels()
    torch.cuda.empty_cache()
    inf = build_inferencer()
    print("chat path: 3 chat requests, greedy, max_length "
          f"{MAX_LENGTH}, full 14B geometry, random weights (seed {SEED})", flush=True)
    chat = run_main_path(inf)
    check_against_plain_path(inf)
    print(f"generation path: text-to-image and an image edit at {GEN_SIZE[0]}x{GEN_SIZE[1]}, "
          "50 timesteps, CFG text 3.0 / image 1.5 on (0.4, 1.0], global renorm", flush=True)
    gen = run_generation(inf)
    check_velocity_against_plain(inf)
    sources = {
        "flash_block_attention": ("unimedvl_tpu_torch/csrc/flash_block_attention.cu",
                                  "unimedvl_tpu/ops/flash_attention.py:209"),
        "flash_block_attention_q_preproc": (
            "unimedvl_tpu_torch/csrc/flash_block_attention.cu",
            "unimedvl_tpu/ops/flash_attention.py:209 (q_preproc, _fused_q_preproc :33)"),
        "decode_attention": ("unimedvl_tpu_torch/csrc/decode_attention.cu",
                             "unimedvl_tpu/ops/decode_attention.py:130"),
    }
    kernels = [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=chat[name] + gen[name], **timings[name])
        for name, (src, rep) in sources.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
