"""The host's cost of one collective on a one-rank NCCL group, and what a
CUDA graph captures of it: the all-reduce and the all-gather of the SP
step's [3, 1026, 3584] bf16 block, each called 200 times without a
synchronise (host microseconds a call), then 50 all-reduces captured into
one CUDA graph and replayed (microseconds a call, and whether the graph is
empty: NCCL launches no kernel for an in-place all-reduce of one rank).

    python unimedvl_tpu_torch/tools/nccl_host_cost.py
    TORCH_NCCL_TRACE_BUFFER_SIZE=0 python unimedvl_tpu_torch/tools/nccl_host_cost.py

The second line runs it with NCCL's flight recorder off. Prints one JSON
line. Needs a CUDA device.
"""

from __future__ import annotations

import datetime
import json
import os
import tempfile
import time
import warnings

import torch
import torch.distributed as dist


def _host_us(fn, n: int = 200) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * dt / n


def main() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous", world_size=1,
                                rank=0, timeout=datetime.timedelta(seconds=60))
        try:
            group = dist.new_group([0])
            t = torch.ones(3, 1026, 3584, dtype=torch.bfloat16, device="cuda")
            parts = [torch.empty_like(t)]

            def reduce():
                dist.all_reduce(t, group=group)

            def gather():
                dist.all_gather(parts, t, group=group, async_op=True).wait()

            row = dict(trace_buffer_size=os.environ.get("TORCH_NCCL_TRACE_BUFFER_SIZE"),
                       all_reduce_host_us=_host_us(reduce), all_gather_host_us=_host_us(gather))
            side = torch.cuda.Stream()
            with torch.cuda.stream(side), warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                reduce()
                torch.cuda.synchronize()
                graph = torch.cuda.CUDAGraph()
                graph.capture_begin(capture_error_mode="thread_local")
                for _ in range(50):
                    reduce()
                graph.capture_end()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            graph.replay()
            torch.cuda.synchronize()
            row["graph_replay_us_per_all_reduce"] = 1e6 * (time.perf_counter() - t0) / 50
            row["graph_empty"] = any("empty" in str(w.message) for w in seen)
            print(json.dumps(row), flush=True)
        finally:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
