"""Where a training step's time goes on one card: a ``torch.profiler`` trace
of one step of each training path at the smoke's widths, on the smoke's own
batches, after steps that are not traced (a graphed route's first step
captures its programs there), by each route asked for:

- ``lora``: LoRA (rank 16, every projection of both experts) over the
  28-layer bf16 model, one packed sequence of T 6144;
- ``qlora_w4a8`` / ``qlora_int8``: the same over a copy of the LLM quantized
  on the card to w4a8 per channel (adapters on every projection) / full-int8
  (adapters on q, k, v, o, so that K3 feeds each down projection);
- ``ft``: the full fine-tune at ``chip_smoke.FT_LAYERS`` layers, T 4096,
  accumulation 2 and an EMA;
- ``mesh`` / ``mesh_fsdp``: that step on a one-rank NCCL ("data", "model")
  mesh, without and with ``fsdp``;
- ``pipe``: the GPipe step (``make_pp_train_step``) on a stage model of a
  one-rank NCCL ("data", "pipe", "model") mesh at ``chip_smoke.FT_LAYERS``
  layers, the ``ft`` step's two sequences as its M = 2 microbatches.

    PYTHONPATH=. python unimedvl_tpu_torch/tools/profile_train_step.py \\
        [--routes eager|graphed|graphed,eager] [--steps lora,qlora_w4a8,...] [--out DIR]

Per step and route it prints one JSON line: the step's wall time without
the profiler (median of 3), s/step and packed tokens/s, the peak memory,
from the trace's kernel events the card's busy time (the union of kernel
intervals), the idle share of the traced step, the kernel launches, the
copies' time and count (a graph's copies run as kernel nodes and count in
its busy time; eager copies are copy events outside it), the busy time by
kind (the K5 kernels by name, K1a, K3, K4, GEMMs, the
optimizer's multi-tensor kernels, the rest), and from its host ranges the
host time per sequence, per pipeline call and per update (the trainer's
``train.sequence``, ``train.pipeline`` and ``train.update`` ranges: issuing
a sequence's forward and backward, or the pipeline's, or copying its inputs
in and replaying its graph); for a graphed route also the
captures, their seconds and the training pool's bytes; the card's mean SM
clock and power draw over the timed steps (``nvidia-smi``). With both
routes, a line of the kernels whose time differs most between them. The
traces go to DIR (default ``build/profile``)."""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

import chip_smoke as cs
from unimedvl_tpu_torch.inference import programs
from unimedvl_tpu_torch.training import lora, trainer

KINDS = [  # first match wins
    ("k5_fwd", ("packed_train_fwd", "fwd_sweep_kernel")),
    ("k5_dq", ("packed_train_bwd_dq", "bwd_dq_kernel")),
    ("k5_dkv", ("packed_train_bwd_dkv", "bwd_dkv_kernel")),
    ("k5_plan", ("bwd_prep_kernel", "bwd_lists_kernel", "plan_", "bwd_rows_kernel")),
    ("k5_combine", ("bwd_dkv_combine",)),
    ("k1a", ("flash_block",)),
    ("k3", ("silu_mul_quant",)),
    ("k4", ("w4a8", "w4_bf16", "w4_gemv", "w4_")),
    ("gemm", ("gemm", "cutlass", "nvjet", "xmma", "cublas", "gemv")),
    ("optimizer", ("multi_tensor", "adam", "foreach")),
]
STEPS = ("lora", "qlora_w4a8", "qlora_int8", "ft", "mesh", "mesh_fsdp", "pipe")


def _kind(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


class ClockSampler:
    """The card's SM clock (MHz) and power draw (W) sampled by ``nvidia-smi``
    on a thread while the block runs; their means after it."""

    QUERY = ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits"]

    def __enter__(self):
        self.samples, self._stop = [], threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.is_set():
            out = subprocess.run(self.QUERY, capture_output=True, text=True).stdout
            self.samples.append([float(x) for x in out.splitlines()[0].split(",")])
            self._stop.wait(0.2)

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=10)

    def means(self) -> dict:
        if not self.samples:
            return {}
        return dict(sm_clock_mhz=statistics.mean(s[0] for s in self.samples),
                    power_w=statistics.mean(s[1] for s in self.samples))


def _summarise(trace_path: Path) -> dict:
    events = json.loads(trace_path.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    by_kind: dict = {}
    by_name: dict = {}
    for e in kernels:
        by_kind[_kind(e["name"])] = by_kind.get(_kind(e["name"]), 0.0) + e["dur"] / 1e3
        n = by_name.setdefault(e["name"][:90], [0, 0.0])
        n[0] += 1
        n[1] += e["dur"] / 1e3
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    busy, end = 0.0, spans[0][0]
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    window = (spans[-1][1] - spans[0][0]) / 1e3
    # a graph's copies are kernel nodes ("memcpy32_post", "memcpy128"); eager copies are
    # gpu_memcpy / gpu_memset events: their time, by both names, for a like comparison
    copies = [e for e in events if e.get("cat") in ("gpu_memcpy", "gpu_memset")
              or (e.get("cat") == "kernel" and e.get("name", "").startswith("memcpy"))]
    host = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name", "").startswith("train."):
            host.setdefault(e["name"], []).append(e["dur"] / 1e3)
    return dict(launches=len(kernels), traced_window_ms=window, busy_ms=busy / 1e3,
                copy_ms=sum(e["dur"] for e in copies) / 1e3, copies=len(copies),
                idle_share=1 - busy / 1e3 / window,
                busy_ms_by_kind={k: round(v, 3) for k, v in sorted(by_kind.items())},
                host_ms_per_sequence=statistics.mean(host.get("train.sequence", [0.0])),
                host_ms_per_pipeline=statistics.mean(host.get("train.pipeline", [0.0])),
                host_ms_per_update=statistics.mean(host.get("train.update", [0.0])),
                sequences_traced=len(host.get("train.sequence", [])), by_name=by_name)


def profile(name: str, route: str, run_step, tokens: int, out_dir: Path) -> dict:
    torch.cuda.reset_peak_memory_stats()
    before = dict(programs.stats)
    for _ in range(2):
        run_step()
    walls = []
    with ClockSampler() as clocks:
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
    path = out_dir / f"train_step_{name}_{route}.trace.json"
    prof.export_chrome_trace(str(path))
    wall = statistics.median(walls)
    row = dict(step=name, route=route, card=cs.CARD, wall_ms=1e3 * wall, walls_ms=[
        round(1e3 * w, 2) for w in walls], packed_tokens_per_s=tokens / wall,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30, **clocks.means(), **_summarise(path))
    if route == "graphed":
        row.update(captures=programs.stats["captures"] - before["captures"],
                   capture_s=programs.stats["capture_s"] - before["capture_s"],
                   train_pool_bytes=programs.pool_bytes(pool="train"))
    by_name = row.pop("by_name")
    print(json.dumps(row), flush=True)
    row["by_name"] = by_name
    return row


def _print_diff(name: str, rows: dict, top: int = 15) -> None:
    """The kernels (by name) whose summed time differs most between the
    graphed and the eager traced step, with their counts."""
    g, e = rows["graphed"]["by_name"], rows["eager"]["by_name"]
    diff = sorted(((g.get(k, [0, 0.0])[1] - e.get(k, [0, 0.0])[1], k) for k in set(g) | set(e)),
                  key=lambda t: -abs(t[0]))[:top]
    print(json.dumps(dict(step=name, graphed_minus_eager_ms=[
        dict(kernel=k, ms=round(d, 3), count_graphed=g.get(k, [0])[0],
             count_eager=e.get(k, [0])[0]) for d, k in diff])), flush=True)


def _routes(name, make, pairs, tokens, routes, out_dir, g):
    """Profile ``make(graphs) -> (step, state)`` by each route on its side of
    ``pairs`` (the padded sequences for the program, the stripped ones for
    the eager step, each prepared before the trace), the step (and its
    programs) dropped after each."""
    rows = {}
    for route in routes:
        step, state = make(route == "graphed")
        batch = pairs[0 if route == "graphed" else 1]
        rows[route] = profile(name, route, lambda: step(state, batch, generator=g), tokens,
                              out_dir)
        del step, state
        programs.drop_all()
        gc.collect()
        torch.cuda.empty_cache()
    if set(rows) == {"graphed", "eager"}:
        _print_diff(name, rows)


def _tokens(batches) -> int:
    return sum(s["mask_document_id"].shape[0] for b in batches for s in b)


def _sides(padded) -> tuple:
    """(padded batches, the same batches stripped) of the prefetcher's padded
    batches."""
    return padded, [trainer.prepared(b, "cuda", False) for b in padded]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--routes", default="eager")
    ap.add_argument("--steps", default=",".join(STEPS))
    ap.add_argument("--out", default="build/profile")
    args = ap.parse_args(argv)
    routes = args.routes.split(",")
    steps = args.steps.split(",")
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    cs.check_device()
    cs.build_kernels()
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 5)
    inf = cs.build_inferencer()
    tok, ids = inf.tokenizer, inf.new_token_ids
    lora_steps = [s for s in steps if s in ("lora", "qlora_w4a8", "qlora_int8")]
    if lora_steps:
        it = cs.train_batches(inf.model, tok, ids, True, cs.LORA_SEQ_LEN)
        pair = [side[0] for side in _sides([next(it)])]
        it.close(wait=True)
        print(f"LoRA steps on {cs._describe(pair[1][0])}", flush=True)
        kinds = {"lora": (None, lora.TARGETS_ALL),
                 "qlora_w4a8": (dict(bits=4, act_quant=True), lora.TARGETS_ALL),
                 "qlora_int8": (dict(bits=8, act_quant=True), ("q", "k", "v", "o"))}
        for name in lora_steps:
            kw, targets = kinds[name]
            model = inf.model if kw is None else cs.qlora_model(inf.model, **kw)
            lora.add_lora(model, torch.Generator(device="cuda").manual_seed(cs.SEED + 5),
                          rank=cs.LORA_RANK, targets=targets)
            _routes(name, lambda graphs: lora.make_lora_train_step(model.config, model,
                                                                   graphs=graphs),
                    pair, _tokens([pair[0]]), routes, out_dir, g)
            if kw is None:
                lora.merge_lora(model)  # the bf16 base back for the quantized copies
            del model
            gc.collect()
            torch.cuda.empty_cache()
    del inf
    gc.collect()
    torch.cuda.empty_cache()
    ft_steps = [s for s in steps if s in ("ft", "mesh", "mesh_fsdp", "pipe")]
    if not ft_steps:
        return
    model = cs.build_trainable(cs.FT_LAYERS, False)
    it = cs.train_batches(model, tok, ids, False, cs.FT_SEQ_LEN, per_step=cs.FT_ACCUM)
    batches = _sides([next(it) for _ in range(cs.FT_ACCUM)])
    it.close(wait=True)
    print("full fine-tune steps on " + "; ".join(cs._describe(b[0]) for b in batches[1]),
          flush=True)
    if "ft" in ft_steps:
        def make(graphs):
            step, init_state = trainer.make_train_step(
                model.config, model, accum_steps=cs.FT_ACCUM, ema_decay=cs.FT_EMA_DECAY,
                graphs=graphs)
            return step, init_state()

        _routes(f"ft_{cs.FT_LAYERS}_layers", make, batches, _tokens(batches[0]), routes, out_dir,
                g)
    mesh_steps = [s for s in ft_steps if s != "ft"]
    if not mesh_steps:
        return
    del model
    gc.collect()
    torch.cuda.empty_cache()
    from unimedvl_tpu_torch.parallel.pp_train import place_params_pp

    with tempfile.TemporaryDirectory() as tmp:
        seqs = [[s for b in side for s in b] for side in batches]  # one batch of both
        try:
            for name in mesh_steps:
                whole = cs.build_trainable(cs.FT_LAYERS, False)
                if name == "pipe":
                    mesh = cs.one_rank_mesh(("data", "pipe", "model"), tmp)
                    placed = place_params_pp(whole, mesh)

                    def make(graphs, placed=placed, mesh=mesh):
                        step, init_state = trainer.make_pp_train_step(
                            placed.whole_config, placed, mesh, graphs=graphs)
                        return step, init_state()
                else:
                    mesh = cs.one_rank_mesh(("data", "model"), tmp)
                    placed = cs.pmesh.place_params(whole, mesh)

                    def make(graphs, placed=placed, mesh=mesh, fsdp=name == "mesh_fsdp"):
                        step, init_state = trainer.make_train_step(
                            placed.whole_config, placed, mesh=mesh, fsdp=fsdp, graphs=graphs)
                        return step, init_state()
                del whole

                _routes(f"{name}_{cs.FT_LAYERS}_layers", make, seqs, _tokens(batches[0]), routes,
                        out_dir, g)
                del placed
                gc.collect()
                torch.cuda.empty_cache()
        finally:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
