"""Where the sequence-parallel denoise step's time goes on one card: denoise
steps of the 512 x 512 text-to-image request at the full 14B geometry (random
weights from a seed), timed in turns in one run:

- the single-device ``generate_latents`` step;
- ``generate_latents_tp_sp`` on a 1 x 1 mesh without a process group, for
  each setting of ``overlap_gather``, ``overlap_chunks`` and
  ``dedup_text_mlp``;
- the same on a 1 x 1 mesh over a one-rank NCCL group (where one starts),
  and the cost of one all-reduce and one all-gather on that group.

    PYTHONPATH=. python unimedvl_tpu_torch/tools/time_sp_step.py

Prints one JSON line per variant (ms per 3-stream step and per 1-stream step,
host-clock medians over synchronised steps) and the card's name and power
limit first. Needs a CUDA device.
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


def _row(name, step3, step1) -> None:
    print(json.dumps(dict(variant=name, ms_per_3_stream_step=_ms(step3),
                          ms_per_1_stream_step=_ms(step1))), flush=True)


def main() -> None:
    chip_smoke.check_device()
    chip_smoke.build_kernels()
    inf = chip_smoke.build_inferencer()
    caches, positions, pos_ids, noise = chip_smoke._denoise_inputs(inf)
    args = (inf.model, caches, positions, pos_ids, noise, inf._start_end())
    # two timesteps are one step at t = 1: inside the CFG interval (3 streams) with the
    # recipe's interval, outside it (1 stream) with an empty one
    on = dict(chip_smoke.RECIPE, num_timesteps=2)
    off = dict(on, cfg_interval=(2.0, 3.0))
    _row("generate_latents (single device)",
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
    for name, kw in variants:
        _row(f"generate_latents_tp_sp, 1 x 1 mesh, no process group, {name}",
             lambda: sp_denoise.generate_latents_tp_sp(*args, plain, **on, **kw),
             lambda: sp_denoise.generate_latents_tp_sp(*args, plain, **off, **kw))
    with tempfile.TemporaryDirectory() as tmp:
        mesh = chip_smoke.make_sp_mesh(tmp)
        if mesh.groups["seq"] is None:
            return
        try:
            for name, kw in variants[:2]:
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
