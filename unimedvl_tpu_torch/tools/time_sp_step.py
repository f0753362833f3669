"""Where the sequence-parallel denoise step's time goes on one card: denoise
steps of the 512 x 512 text-to-image request at the full 14B geometry (random
weights from a seed), timed in turns in one run:

- the single-device ``generate_latents`` step;
- ``generate_latents_tp_sp`` on a 1 x 1 mesh without a process group, for
  each setting of ``overlap_gather``, ``overlap_chunks`` and
  ``dedup_text_mlp``;
- the same on a 1 x 1 mesh over a one-rank NCCL group
  (``chip_smoke.one_rank_mesh``), by the eager loop and by the captured
  program (``sp_denoise.SPProgram``), and the cost of one all-reduce and
  one all-gather on that group.

    PYTHONPATH=. python unimedvl_tpu_torch/tools/time_sp_step.py [--mesh] [--routes eager|both]

Prints one JSON line per variant (ms per 3-stream step and per 1-stream step,
host-clock medians over synchronised steps) and the card's name and power
limit first. Needs a CUDA device. Every variant but the NCCL mesh's runs
eagerly (``graphs=False``) unless its name says "graphed".

``--mesh``: only the defaults without a process group, and each 3-stream
step of the single device, of the mesh without a process group and of the
NCCL mesh (by the routes of ``--routes``, default both) is also traced
(``torch.profiler``, one step): busy ms, launches and idle share, and on the
NCCL mesh the collectives' breakdown
(``tools/profile_decode_step.collective_stats``: NCCL kernels, the hop to
NCCL's stream and back, host time per collective call). Traces go to
``build/profile``.
"""

from __future__ import annotations

import json
import statistics
import sys
import tempfile
import time

import torch

import chip_smoke
from unimedvl_tpu_torch.models import bagel
from unimedvl_tpu_torch.parallel import mesh as pmesh
from unimedvl_tpu_torch.parallel import sp_denoise
from unimedvl_tpu_torch.tools import profile_decode_step as pds

STEPS = 6  # timed steps per variant and stream count


def _ms(fn, n: int = STEPS) -> float:
    fn()  # warm-up
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


TRACED = None  # set by --mesh: rows trace their 3-stream step


def _trace(name: str, fn) -> dict:
    """One traced call of ``fn`` (a 3-stream step): busy ms, launches and idle
    share over the traced window, by kind, and on a mesh the collectives."""
    pds.OUT_DIR.mkdir(parents=True, exist_ok=True)
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    tag = "".join(c if c.isalnum() else "_" for c in name)[:80]
    path = pds.OUT_DIR / f"sp_step_{tag}.trace.json"
    prof.export_chrome_trace(str(path))
    out = pds._summarise(path, 1, wall_ms, pds.KINDS + [("nccl", ("nccl",))])
    out["traced_wall_ms"] = wall_ms
    if "NCCL" in name:
        out["collectives"] = pds.collective_stats(path, 1)
    return out


def _row(name, step3, step1) -> None:
    row = dict(variant=name, ms_per_3_stream_step=_ms(step3), ms_per_1_stream_step=_ms(step1))
    if TRACED:
        row["trace_3_stream_step"] = _trace(name, step3)
    print(json.dumps(row), flush=True)


def main() -> None:
    global TRACED
    argv = sys.argv[1:]
    routes = "both"
    if argv[:1] == ["--mesh"]:
        TRACED, argv = True, argv[1:]
        if argv[:1] == ["--routes"]:
            routes = argv[1]
            if routes not in ("eager", "both"):
                raise SystemExit(f"--routes takes eager or both, got {routes!r}")
    chip_smoke.check_device()
    print(chip_smoke.CARD, flush=True)
    chip_smoke.build_kernels()
    inf = chip_smoke.build_inferencer()
    caches, positions, pos_ids, noise = chip_smoke._denoise_inputs(inf)
    args = (inf.model, caches, positions, pos_ids, noise, inf._start_end())
    # two timesteps are one step at t = 1: inside the CFG interval (3 streams) with the
    # recipe's interval, outside it (1 stream) with an empty one
    on = dict(chip_smoke.RECIPE, num_timesteps=2)
    off = dict(on, cfg_interval=(2.0, 3.0))
    _row("generate_latents (single device), eager",
         lambda: bagel.generate_latents(*args, graphs=False, **on),
         lambda: bagel.generate_latents(*args, graphs=False, **off))
    _row("generate_latents (single device), graphed",
         lambda: bagel.generate_latents(*args, **on),
         lambda: bagel.generate_latents(*args, **off))
    plain = pmesh.make_mesh(("model", "seq"), (1, 1))
    variants = [
        ("defaults", {}),
        ("overlap_gather=False", dict(overlap_gather=False)),
        ("overlap_chunks=1", dict(overlap_chunks=1)),
        ("dedup_text_mlp=False", dict(dedup_text_mlp=False)),
        ("overlap_gather=False, overlap_chunks=1", dict(overlap_gather=False, overlap_chunks=1)),
    ]
    for name, kw in variants[:1] if TRACED else variants:
        kw = dict(kw, graphs=False)
        _row(f"generate_latents_tp_sp, 1 x 1 mesh, no process group, {name}",
             lambda: sp_denoise.generate_latents_tp_sp(*args, plain, **on, **kw),
             lambda: sp_denoise.generate_latents_tp_sp(*args, plain, **off, **kw))
    with tempfile.TemporaryDirectory() as tmp:
        mesh = chip_smoke.one_rank_mesh(("model", "seq"), tmp)
        try:
            mesh_rows = [(f"eager, {name}", dict(kw, graphs=False))
                         for name, kw in (variants[:1] if TRACED else variants[:2])]
            if routes == "both":
                mesh_rows.append(("graphed (SPProgram), defaults", {}))
            for name, kw in mesh_rows:
                _row(f"generate_latents_tp_sp, 1 x 1 mesh on a one-rank NCCL group, {name}",
                     lambda: sp_denoise.generate_latents_tp_sp(*args, mesh, **on, **kw),
                     lambda: sp_denoise.generate_latents_tp_sp(*args, mesh, **off, **kw))
            t = torch.ones(3, 1026, 3584, dtype=torch.bfloat16, device="cuda")

            def reduce_sync():
                mesh.all_reduce(t, "model")

            def reduce_async():
                mesh.all_reduce(t, "model", async_op=True).wait()

            def gather():
                mesh.all_gather(t[:, 1:-1], "seq", dim=1).wait()

            print(json.dumps(dict(
                nccl_one_rank_ms_per_call=dict(
                    all_reduce=chip_smoke.cuda_ms(reduce_sync, reps=20),
                    all_reduce_async_wait=chip_smoke.cuda_ms(reduce_async, reps=20),
                    all_gather_async_wait_cat=chip_smoke.cuda_ms(gather, reps=20)),
                host_ms_per_call=dict(
                    all_reduce=_host_ms(reduce_sync), all_reduce_async_wait=_host_ms(reduce_async),
                    all_gather_async_wait_cat=_host_ms(gather)))), flush=True)
        finally:
            torch.distributed.destroy_process_group()


def _host_ms(fn, n: int = 50) -> float:
    """Host time per call in a run of ``n`` enqueued calls (no synchronise
    inside the run): what the launch loop pays."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * dt / n


if __name__ == "__main__":
    sys.exit(main())
