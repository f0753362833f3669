"""Where a training step's time goes on one card: a ``torch.profiler`` trace
of one LoRA step over the 28-layer model and of one full fine-tune step
(accumulation 2) at the depth ``chip_smoke.py`` trains, on the smoke's own
batches, after warm-up steps that are not traced.

    PYTHONPATH=. python unimedvl_tpu_torch/tools/profile_train_step.py [OUT_DIR]

Per phase it prints one JSON line: the step's wall time without the profiler
(median of 3), and from the trace's kernel events the card's busy time (the
union of kernel intervals), the idle share of the traced step, the number of
kernel launches, and the busy time split by kind: the K5 kernels by name
(forward, dq, dk/dv, the plan launches and the dk/dv combine), K1a,
GEMMs (cuBLAS / CUTLASS names), the optimizer's multi-tensor kernels and the
EMA update, and the rest (element-wise, reductions, copies, the MoT row
routing). The traces are written to OUT_DIR (default ``build/profile``)."""

from __future__ import annotations

import gc
import json
import statistics
import sys
import time
from pathlib import Path

import torch

import chip_smoke as cs
from unimedvl_tpu_torch.training import lora, trainer

KINDS = [  # first match wins
    ("k5_fwd", ("packed_train_fwd", "fwd_sweep_kernel")),
    ("k5_dq", ("packed_train_bwd_dq", "bwd_dq_kernel")),
    ("k5_dkv", ("packed_train_bwd_dkv", "bwd_dkv_kernel")),
    ("k5_plan", ("bwd_prep_kernel", "bwd_lists_kernel", "plan_", "bwd_rows_kernel")),
    ("k5_combine", ("bwd_dkv_combine",)),
    ("k1a", ("flash_block",)),
    ("gemm", ("gemm", "cutlass", "nvjet", "xmma", "cublas", "gemv")),
    ("optimizer", ("multi_tensor", "adam", "foreach")),
]


def _kind(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def _summarise(trace_path: Path) -> dict:
    events = [e for e in json.loads(trace_path.read_text())["traceEvents"]
              if e.get("cat") == "kernel"]
    by_kind: dict = {}
    for e in events:
        by_kind[_kind(e["name"])] = by_kind.get(_kind(e["name"]), 0.0) + e["dur"] / 1e3
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    busy, end = 0.0, spans[0][0]
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    window = (spans[-1][1] - spans[0][0]) / 1e3
    return dict(launches=len(events), traced_window_ms=window, busy_ms=busy / 1e3,
                idle_share=1 - busy / 1e3 / window,
                busy_ms_by_kind={k: round(v, 3) for k, v in sorted(by_kind.items())})


def profile(name: str, run_step, out_dir: Path) -> None:
    for _ in range(2):
        run_step()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run_step()
        torch.cuda.synchronize()
    path = out_dir / f"train_step_{name}.trace.json"
    prof.export_chrome_trace(str(path))
    row = dict(phase=name, wall_ms=1e3 * statistics.median(walls),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30, **_summarise(path))
    print(json.dumps(row), flush=True)


def main() -> None:
    out_dir = Path(sys.argv[1] if len(sys.argv) > 1 else "build/profile")
    out_dir.mkdir(parents=True, exist_ok=True)
    cs.check_device()
    cs.build_kernels()
    inf = cs.build_inferencer()
    tok, ids = inf.tokenizer, inf.new_token_ids
    model, cfg = inf.model, inf.model.config
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 5)

    it = cs.train_batches(model, tok, ids, cs.train_examples(True), cs.LORA_SEQ_LEN)
    batch = next(it)
    it.close(wait=True)
    print(f"LoRA step on {cs._describe(batch[0])}", flush=True)
    lora.add_lora(model, g, rank=cs.LORA_RANK)
    step, state = lora.make_lora_train_step(cfg, model)
    profile("lora", lambda: step(state, batch, generator=g), out_dir)
    del inf, model, step, state, it, batch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    model = cs.build_trainable(cs.FT_LAYERS, False)
    it = cs.train_batches(model, tok, ids, cs.train_examples(False), cs.FT_SEQ_LEN)
    batches = [next(it) for _ in range(cs.FT_ACCUM)]
    it.close(wait=True)
    print("full fine-tune step on " + "; ".join(cs._describe(b[0]) for b in batches), flush=True)
    step, init_state = trainer.make_train_step(
        model.config, model, accum_steps=cs.FT_ACCUM, ema_decay=cs.FT_EMA_DECAY)
    state = init_state()
    profile(f"full_finetune_{cs.FT_LAYERS}_layers", lambda: step(state, batches, generator=g),
            out_dir)


if __name__ == "__main__":
    main()
