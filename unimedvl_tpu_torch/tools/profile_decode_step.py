"""Where a chat decode step's time goes on one card: a ``torch.profiler`` trace
of a few decode steps of the 980 px and the 378 px chat requests of
``chip_smoke.py`` (full 14B geometry, random weights), in bf16 and in
full-int8 with fused projections and an int8 KV cache (built as
``chip_smoke.quantized_inferencer`` builds it).

    PYTHONPATH=. python unimedvl_tpu_torch/tools/profile_decode_step.py [OUT_DIR]

Each request's context is built as ``chat`` builds it; then
``bagel.generate_text`` runs STEPS greedy steps with an end token that never
comes, as ``gen_text`` runs them (one host read of the end test per step).
Per (mode, request) it prints one JSON line, every figure per decode step:
the wall time without the profiler (median of 3 runs), and from the trace's
kernel events the card's busy time (the union of kernel intervals), the
launches, and the busy time split by kind (K2 / K2-int8, GEMMs, K3, K4, the
rest: element-wise ops, reductions, copies). ``idle_share`` is 1 - busy / wall;
``idle_share_traced`` the same over the traced window (the profiler slows the
host). The traces are written to OUT_DIR (default ``build/profile``)."""

from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

import torch

import chip_smoke as cs
from unimedvl_tpu_torch.models import bagel

STEPS = 8
KINDS = [  # first match wins
    ("k2", ("decode_attention",)),
    ("k3", ("silu_mul_quant",)),
    ("k4", ("w4_",)),
    ("gemm", ("gemm", "cutlass", "nvjet", "xmma", "cublas", "gemv", "imma")),
]


def _kind(name: str, kinds) -> str:
    low = name.lower()
    for kind, keys in kinds:
        if any(k in low for k in keys):
            return kind
    return "elementwise"


def _summarise(trace_path: Path, steps: int, wall_ms: float, kinds=KINDS) -> dict:
    """Per step, from a trace's kernel events: busy time (the union of kernel
    intervals), idle shares, launches and busy time by kind (``kinds``: first
    match of (kind, name fragments) wins; the rest is "elementwise")."""
    events = [e for e in json.loads(trace_path.read_text())["traceEvents"]
              if e.get("cat") == "kernel"]
    by_kind: dict = {}
    for e in events:
        kind = _kind(e["name"], kinds)
        by_kind[kind] = by_kind.get(kind, 0.0) + e["dur"] / 1e3
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    busy, end = 0.0, spans[0][0]
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    busy_ms = busy / 1e3 / steps
    window_ms = (spans[-1][1] - spans[0][0]) / 1e3 / steps
    return dict(busy_ms=busy_ms, idle_share=1 - busy_ms / wall_ms,
                idle_share_traced=1 - busy_ms / window_ms, launches=len(events) / steps,
                busy_ms_by_kind={k: v / steps for k, v in sorted(by_kind.items())},
                busy_share_by_kind={k: v / steps / busy_ms for k, v in sorted(by_kind.items())})


def profile(mode: str, inf, request: int, out_dir: Path) -> None:
    h, w, prompt = cs.REQUESTS[request]
    ctx = inf.init_gen_context()
    ctx = inf.update_context_image(cs._images()[request], ctx, vae=False)
    ctx = inf.update_context_text(prompt, ctx)
    ctx = inf._ensure_capacity(ctx, STEPS + 1)
    start = torch.tensor([inf.new_token_ids["bos_token_id"]], device=inf.device)
    pos = torch.tensor([ctx.rope], device=inf.device)

    def run():
        with torch.no_grad():
            bagel.generate_text(inf.model, ctx.cache, start, pos, STEPS, eos_id=-1)

    run()
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
    path = out_dir / f"decode_step_{mode}_{h}x{w}.trace.json"
    prof.export_chrome_trace(str(path))
    wall_ms = 1e3 * statistics.median(walls) / STEPS
    row = dict(mode=mode, image=f"{h}x{w}", cache_columns=int(ctx.cache.lens.max()) + 1,
               steps=STEPS, wall_ms=wall_ms, decode_tok_s=1e3 / wall_ms,
               **_summarise(path, STEPS, wall_ms))
    print(json.dumps(row), flush=True)


def main() -> None:
    out_dir = Path(sys.argv[1] if len(sys.argv) > 1 else "build/profile")
    out_dir.mkdir(parents=True, exist_ok=True)
    cs.check_device()
    cs.build_kernels()
    inf = cs.build_inferencer()
    for request in (0, 2):
        profile("bf16", inf, request, out_dir)
    qinf = cs.quantized_inferencer(inf, bits=8, act_quant=True)
    for request in (0, 2):
        profile("full_int8_int8kv", qinf, request, out_dir)


if __name__ == "__main__":
    main()
