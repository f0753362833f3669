"""Time the decode-attention kernels (K2, and K2-int8 where the checkout has
it) of one or more checkouts of this repository on one card, in one run, so
that two versions of ``csrc/decode_attention.cu`` can be compared:

    python unimedvl_tpu_torch/tools/time_decode_kernels.py PARENT CHANGE CHANGE PARENT

Each checkout is timed in a process of its own (it imports that checkout's
package and builds its kernels there), at the chat decode shapes of
``chip_smoke.py``: S = 1, lens 4950 over a 5632-column cache, and S = 3 with
lens (100, 2000, 4950); 28/4 heads, D = 128; K2-int8 also at the batched
decode's S = 48, lens 776-824 over 1024 columns with band (lens, lens). Per
shape it prints three medians of 7 single calls (CUDA events; the wrapper's
host time is inside), three times per call in a run of 20 (the larger of the
wrapper's host time and the card's time) and three per call in a CUDA graph of
20 calls (the card's time alone), and beside K2 the same two for one
``scaled_dot_product_attention`` on the same inputs and mask (heads expanded
beforehand), as one JSON line per checkout after the card's name and power
limit."""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

RUN = 20


def _worker(checkout: str) -> None:
    sys.path.insert(0, checkout)
    import torch

    from unimedvl_tpu_torch.ops import decode_attention as dec

    def ms(fn, reps=1):
        for _ in range(2):
            fn()
        times = []
        for _ in range(7):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / reps)
        return statistics.median(times)

    def graph_ms(fn):
        """Per call in a CUDA graph of RUN calls: the device's time alone,
        without the wrapper's host time between launches."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(RUN):
                fn()
        return [round(ms(graph.replay) / RUN, 4) for _ in range(3)]

    def both(fn):
        return {"single_ms": [round(ms(fn), 4) for _ in range(3)],
                "run_ms": [round(ms(fn, RUN), 4) for _ in range(3)],
                "graph_ms": graph_ms(fn)}

    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(torch.bfloat16)

    def ints(*vals):
        return torch.tensor(vals, dtype=torch.int32, device="cuda")

    def sdpa_run_ms(q, k, v, lens, band):
        j = torch.arange(k.shape[2], device="cuda")[None]
        mask = (j < lens[:, None]) | ((j >= band[0][:, None]) & (j <= band[1][:, None]))
        qh = q.transpose(1, 2)
        kh, vh = k.repeat_interleave(7, dim=1), v.repeat_interleave(7, dim=1)
        m = mask[:, None, None]

        def fn():
            return torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, attn_mask=m)

        return {"run_ms": round(ms(fn, RUN), 4), "graph_ms": graph_ms(fn)}

    lens48 = ints(*(776 + (i % 7) * 8 for i in range(48)))
    shapes = {
        "S=1": (5632, ints(4950), (ints(4950), ints(4960)), True),
        "S=3": (5632, ints(100, 2000, 4950), (ints(4950, 4950, 4950), ints(4955, 4955, 4955)),
                True),
        "S=48": (1024, lens48, (lens48, lens48), False),
    }
    out = {"checkout": checkout}
    for name, (M, lens, band, bf16) in shapes.items():
        S = lens.numel()
        q = randn(S, 1, 28, 128, scale=2.0)
        if hasattr(dec, "plan_splits"):  # a checkout with the split-key kernels
            out[f"n_split {name}"] = dec.plan_splits(S, 4, M)[0]
        if bf16:
            k, v = randn(S, 4, M, 128), randn(S, 4, M, 128)
            out[f"K2 {name}"] = both(lambda: dec.decode_attention(q, k, v, lens, band))
            out[f"SDPA {name}"] = sdpa_run_ms(q, k, v, lens, band)
            del k, v
        if not hasattr(dec, "int8_counts"):  # a checkout from before K2-int8
            continue
        k8 = torch.randint(-127, 128, (S, 4, M, 128), generator=g, device="cuda",
                           dtype=torch.int8)
        v8 = torch.randint(-127, 128, (S, 4, M, 128), generator=g, device="cuda",
                           dtype=torch.int8)
        ks = torch.rand(S, 4, M, generator=g, device="cuda") * 0.02 + 0.002
        vs = torch.rand(S, 4, M, generator=g, device="cuda") * 0.02 + 0.002
        out[f"K2-int8 {name}"] = both(
            lambda: dec.decode_attention(q, k8, v8, lens, band, k_scale=ks, v_scale=vs))
    print(json.dumps(out), flush=True)


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--worker":
        _worker(argv[1])
        return 0
    if not argv:
        print(__doc__)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for checkout in argv:
        subprocess.run([sys.executable, __file__, "--worker", checkout], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
