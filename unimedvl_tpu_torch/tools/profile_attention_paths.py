"""Where the time of the flash attention's paths goes on one card, for one or
more checkouts of this repository in one run: the 980 px chat context build
(ViT, image prefill and text prefill, as ``chat`` builds them) and the first
denoise step (three streams) of the 512 px text-to-image request and of the
edit (contexts built as ``interleave_inference`` builds them), at the full 14B
geometry with random weights (``chip_smoke.build_inferencer``), each traced
with ``torch.profiler``; then both requests end to end.

    PYTHONPATH=. python unimedvl_tpu_torch/tools/profile_attention_paths.py PARENT CHANGE CHANGE PARENT

Each checkout runs in a process of its own, with its own package and its own
``chip_smoke``. Per checkout one JSON line: for the context build and each
denoise step, the wall time without the profiler (median of 3 synchronised
calls) and, from the trace's kernel events, the card's busy time (the union of
kernel intervals), the idle share, the launches and the busy time by kind (K1:
``flash_block_attention`` kernels; GEMMs; the rest), with K1's share of busy;
then s/image of each request (one request each, after a short warm-up edit).
Traces are written to build/profile."""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

KINDS = [  # first match wins
    ("k1", ("flash_block_attention",)),
    ("gemm", ("gemm", "cutlass", "nvjet", "xmma", "cublas", "gemv")),
]


def _worker(checkout: str, tag: str) -> None:
    sys.path.insert(0, checkout)
    import torch

    import chip_smoke as cs
    from profile_decode_step import _summarise
    from unimedvl_tpu_torch.models import bagel

    out_dir = Path("build/profile")
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    inf = cs.build_inferencer()

    def measure(name, fn):
        with torch.no_grad():
            fn()
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                fn()
                torch.cuda.synchronize()
        path = out_dir / f"{name.replace(' ', '_')}_{tag}.trace.json"
        prof.export_chrome_trace(str(path))
        wall_ms = 1e3 * statistics.median(walls)
        row = dict(wall_ms=wall_ms, **_summarise(path, 1, wall_ms, KINDS))
        row["k1_share"] = row["busy_share_by_kind"].get("k1", 0.0)
        return row

    out = {"checkout": checkout}
    h, w, prompt = cs.REQUESTS[0]
    image = cs._images()[0]

    def context_build():
        ctx = inf.init_gen_context()
        ctx = inf.update_context_image(image, ctx, vae=False)
        return inf.update_context_text(prompt, ctx)

    out[f"chat context build {h}x{w}"] = measure("chat_context_build", context_build)
    for edit, name in ((False, "text to image"), (True, "edit")):
        caches, positions, pos_ids, noise = cs._denoise_inputs(inf, edit)
        out[f"3-stream denoise step, {name}"] = measure(
            f"denoise_step_{'edit' if edit else 't2i'}",
            lambda: bagel.generate_latents(inf.model, caches, positions, pos_ids, noise,
                                           inf._start_end(), num_timesteps=50,
                                           step_range=(0, 1), **cs.RECIPE))
    inf.interleave_inference([cs._edit_image(), cs.EDIT_PROMPT], image_shapes=cs.GEN_SIZE,
                             num_timesteps=3)
    for name, inputs in (("text to image", [cs.GEN_PROMPT]),
                         ("edit", [cs._edit_image(), cs.EDIT_PROMPT])):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inf.interleave_inference(inputs, image_shapes=cs.GEN_SIZE)
        torch.cuda.synchronize()
        out[f"s_per_image, {name}"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)


def main(argv) -> int:
    if len(argv) == 3 and argv[0] == "--worker":
        _worker(argv[1], argv[2])
        return 0
    if not argv:
        print(__doc__)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for i, checkout in enumerate(argv):
        subprocess.run([sys.executable, __file__, "--worker", checkout, str(i)], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
