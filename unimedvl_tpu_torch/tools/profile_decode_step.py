"""Where a chat decode step's time goes on one card: a ``torch.profiler`` trace
of a few decode steps of the 980 px and the 378 px chat requests of
``chip_smoke.py`` (full 14B geometry, random weights), in bf16, in full-int8,
in w4a8 per channel and in weight-only w4 per channel, the quantized modes
with fused projections and an int8 KV cache (built as
``chip_smoke.quantized_inferencer`` builds them; K4 serves every projection
of a w4 decode step with its GEMV, int8 x in w4a8, bf16 x in weight-only w4).

    python unimedvl_tpu_torch/tools/profile_decode_step.py [--modes M,..] [CHECKOUT ...]

Each checkout (default ``.``) is profiled in a process of its own that
imports that checkout's package and ``chip_smoke.py`` and builds its
kernels, so two versions can be compared in one run (``build/parent .``).
``--modes`` picks among ``bf16``, ``full_int8``, ``w4a8`` and ``w4`` (default:
all four).

Each request's context is built as ``chat`` builds it; then
``bagel.generate_text`` runs STEPS greedy steps with an end token that never
comes, as ``gen_text`` runs them (one host read of the end test per step),
by each route: the captured decode program (``graphs=True``, the default on
the card; its capture before the timed runs) and the eager loop
(``graphs=False``). Per (checkout, mode, request, route) it prints one JSON
line, every figure per decode step: the wall time without the profiler (median of 3 runs), and from
the trace's kernel events the card's busy time (the union of kernel
intervals), the launches, the busy time split by kind (K2 / K2-int8,
GEMMs, K3, K4, the rest: element-wise ops, reductions, copies), and K4's
launches by grid (one grid per projection shape: calls a step, mean us).
``idle_share`` is 1 - busy / wall; ``idle_share_traced`` the same over the
traced window (the profiler slows the host). The traces are written to
``build/profile`` of the checkout that runs this script."""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

STEPS = 8
MODES = {  # name -> options of chip_smoke.quantized_inferencer (None: the bf16 model)
    "bf16": None,
    "full_int8": dict(bits=8, act_quant=True),
    "w4a8": dict(bits=4, act_quant=True),
    "w4": dict(bits=4),
}
OUT_DIR = Path(__file__).resolve().parents[2] / "build" / "profile"
KINDS = [  # first match wins
    ("k2", ("decode_attention",)),
    ("k3", ("silu_mul_quant",)),
    ("k4", ("w4_", "w4a8_")),
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
    k4 = {}  # K4's launches by grid (one grid per projection shape): calls a step, mean us
    for e in events:
        if _kind(e["name"], kinds) == "k4":
            key = f"grid {e.get('args', {}).get('grid')}"
            n, total = k4.get(key, (0, 0.0))
            k4[key] = (n + 1, total + e["dur"])
    return dict(busy_ms=busy_ms, idle_share=1 - busy_ms / wall_ms,
                idle_share_traced=1 - busy_ms / window_ms, launches=len(events) / steps,
                busy_ms_by_kind={k: v / steps for k, v in sorted(by_kind.items())},
                busy_share_by_kind={k: v / steps / busy_ms for k, v in sorted(by_kind.items())},
                k4_by_grid={k: dict(calls=n / steps, mean_us=t / n) for k, (n, t) in k4.items()})


def profile(checkout: str, mode: str, inf, request: int) -> None:
    import torch

    import chip_smoke as cs
    from unimedvl_tpu_torch.models import bagel

    h, w, prompt = cs.REQUESTS[request]
    ctx = inf.init_gen_context()
    ctx = inf.update_context_image(cs._images()[request], ctx, vae=False)
    ctx = inf.update_context_text(prompt, ctx)
    ctx = inf._ensure_capacity(ctx, STEPS + 1)
    start = torch.tensor([inf.new_token_ids["bos_token_id"]], device=inf.device)
    pos = torch.tensor([ctx.rope], device=inf.device)

    for graphs in (True, False):
        def run():
            with torch.no_grad():
                bagel.generate_text(inf.model, ctx.cache, start, pos, STEPS, eos_id=-1,
                                    graphs=graphs)

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
        tag = Path(checkout).resolve().name
        route = "graphed" if graphs else "eager"
        path = OUT_DIR / f"decode_step_{tag}_{mode}_{h}x{w}_{route}.trace.json"
        prof.export_chrome_trace(str(path))
        wall_ms = 1e3 * statistics.median(walls) / STEPS
        row = dict(checkout=checkout, mode=mode, image=f"{h}x{w}", route=route,
                   cache_columns=int(ctx.cache.lens.max()) + 1, steps=STEPS, wall_ms=wall_ms,
                   decode_tok_s=1e3 / wall_ms, **_summarise(path, STEPS, wall_ms))
        print(json.dumps(row), flush=True)


def _worker(checkout: str, modes) -> None:
    sys.path.insert(0, checkout)
    import torch

    import chip_smoke as cs

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    cs.build_kernels()
    inf = cs.build_inferencer()
    for mode in modes:
        kw = MODES[mode]
        qinf = inf if kw is None else cs.quantized_inferencer(inf, **kw)
        for request in (0, 2):
            profile(checkout, mode, qinf, request)
        del qinf
        torch.cuda.empty_cache()


def main() -> None:
    args = sys.argv[1:]
    if args[:1] == ["--worker"]:
        _worker(args[1], args[2].split(","))
        return
    modes = list(MODES)
    if args[:1] == ["--modes"]:
        modes, args = args[1].split(","), args[2:]
        unknown = set(modes) - set(MODES)
        if unknown:
            raise SystemExit(f"unknown modes {sorted(unknown)}; choose among {list(MODES)}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for checkout in args or ["."]:
        subprocess.run([sys.executable, __file__, "--worker", checkout, ",".join(modes)],
                       check=True)


if __name__ == "__main__":
    main()
