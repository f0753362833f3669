"""Where a context build's and an admission round's time goes on one card: a
``torch.profiler`` trace of ``chip_smoke.py``'s chat context builds (the
980x980 and the 378x378 request: the ViT prefill of the image, then the
text prefill of the prompt, as ``chat`` builds them) and of serving run A's
first admission round (the first wave's twelve images, in three groups of
four, each with its text: ``ContinuousBatcher._admit`` into a fresh pool of
16 x 6144 columns), and of the 512x512 VAE decode (fp32, a latent drawn
from a seed), at the full 14B geometry with random bf16 weights.

    python unimedvl_tpu_torch/tools/profile_prefill.py [--routes eager,graphed] \
        [--cases builds,admission,decode]

Each (case, route) is run once untimed (by the graphed route, its
programs' captures), three times timed (the median is the wall, the card
waited for at both ends) and once under the profiler. Per (case, route) it
prints one JSON line: the wall, and from the trace's kernel events the
card's busy time (the union of kernel intervals), the idle share (1 - busy
/ wall; ``idle_share_traced`` over the traced window, where the profiler
slows the host), the launches, and the busy time and launches by kind (K1a,
GEMMs, copies and the rest: element-wise ops and reductions). The route
"eager" takes the eager prefills (``graphs=False``), "graphed" the
captured programs. The traces are written to ``build/profile``."""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
OUT_DIR = ROOT / "build" / "profile"
KINDS = [  # first match wins
    ("k1a", ("flash_block",)),
    ("gemm", ("gemm", "cutlass", "nvjet", "xmma", "cublas", "gemv", "imma")),
    ("copy", ("copy", "memcpy", "memset", "fill")),
]


def _kinds(trace: Path) -> dict:
    """Launches by kind, from a trace's kernel events."""
    from unimedvl_tpu_torch.tools.profile_decode_step import _kind

    events = [e for e in json.loads(trace.read_text())["traceEvents"] if e.get("cat") == "kernel"]
    out: dict = {}
    for e in events:
        k = _kind(e["name"], KINDS)
        out[k] = out.get(k, 0) + 1
    return out


def profile(name: str, route: str, run, card: str, prepare=lambda: None) -> dict:
    """``run(prepare())`` once untimed, three times timed, once traced (each
    ``prepare()`` outside the timed and traced window); the row."""
    import torch

    from unimedvl_tpu_torch.tools.profile_decode_step import _summarise

    run(prepare())
    walls = []
    for _ in range(3):
        state = prepare()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(state)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    state = prepare()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run(state)
        torch.cuda.synchronize()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    trace = OUT_DIR / f"prefill_{name.replace(' ', '_')}_{route}.trace.json"
    prof.export_chrome_trace(str(trace))
    wall_ms = 1e3 * statistics.median(walls)
    row = dict(card=card, case=name, route=route, wall_ms=wall_ms,
               walls_ms=[1e3 * w for w in walls],
               **_summarise(trace, 1, wall_ms, KINDS), launches_by_kind=_kinds(trace))
    row.pop("k4_by_grid", None)
    print(json.dumps(row), flush=True)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--routes", default="eager,graphed")
    ap.add_argument("--cases", default="builds,admission,decode")
    args = ap.parse_args(argv)
    cases = args.cases.split(",")
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from unimedvl_tpu_torch.inference import programs
    from unimedvl_tpu_torch.inference.serving import ContinuousBatcher, Request
    from unimedvl_tpu_torch.models import bagel

    cs.check_device()
    cs.build_kernels()
    inf = cs.build_inferencer()
    images = cs._images()
    for route in args.routes.split(","):
        graphs = {"eager": False, "graphed": None}[route]
        inf.graphs = graphs
        for i in ((0, 2) if "builds" in cases else ()):
            h, w, prompt = cs.REQUESTS[i]

            def build(_state, i=i, prompt=prompt):
                ctx = inf.update_context_image(images[i], inf.init_gen_context(), vae=False)
                return inf.update_context_text(prompt, ctx)

            profile(f"context build {h}x{w}", route, build, cs.CARD)
        first, _later = cs.serving_workload("A")

        def batcher(graphs=graphs):
            b = ContinuousBatcher(inf.model, inf.tokenizer, inf.new_token_ids, cs.SERVE_SLOTS,
                                  cs.SERVE_CAPACITY, cs.SERVE_CHUNK, inf.vit_transform, cs.SEED,
                                  graphs=graphs)
            for a, p, _pre in first:
                b.submit(Request(prompt=p, image=cs._pil_image(a),
                                 max_new_tokens=cs.SERVE_MAX_NEW))
            return b

        def admit(b):
            b._admit()
            if b.errors or b._pending:
                raise SystemExit(f"profile_prefill: admission gave errors {b.errors}")

        if "admission" in cases:
            profile("run A admission round", route, admit, cs.CARD, prepare=batcher)
        if "decode" in cases:
            h, w = (s // inf.cfg.latent_downsample for s in cs.GEN_SIZE)
            latent = torch.randn(h * w, inf.cfg.patch_latent_dim, device="cuda",
                                 generator=torch.Generator(device="cuda").manual_seed(cs.SEED))
            profile(f"vae decode {cs.GEN_SIZE[0]}x{cs.GEN_SIZE[1]}", route,
                    lambda _s: bagel.decode_latent_to_image(inf.model, latent, h, w,
                                                            graphs=graphs), cs.CARD)
        torch.cuda.empty_cache()
    inf.graphs = None
    print(json.dumps(dict(card=cs.CARD, captures=programs.stats["captures"],
                          capture_s=programs.stats["capture_s"],
                          pool_bytes=programs.pool_bytes(), programs=len(programs.programs()))),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
