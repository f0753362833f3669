"""Time the decode-attention kernels (K2, and K2-int8 where the checkout has
it) of one or more checkouts of this repository on one card, in one run, so
that two versions of ``csrc/decode_attention.cu`` can be compared:

    python unimedvl_tpu_torch/tools/time_decode_kernels.py PARENT CHANGE CHANGE PARENT

Each checkout is timed in a process of its own (it imports that checkout's
package and builds its kernels there), at the chat decode shapes of
``chip_smoke.py``: S = 1, lens 4950 over a 5632-column cache, and S = 3 with
lens (100, 2000, 4950); 28/4 heads, D = 128. Per shape it prints three medians
of 7 single calls (CUDA events; the wrapper's host time is inside) and three
times per call in a run of 20 (what the card sets), as one JSON line per
checkout after the card's name and power limit."""

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

    def both(fn):
        return {"single_ms": [round(ms(fn), 4) for _ in range(3)],
                "run_ms": [round(ms(fn, RUN), 4) for _ in range(3)]}

    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(torch.bfloat16)

    def ints(*vals):
        return torch.tensor(vals, dtype=torch.int32, device="cuda")

    M = 5632
    shapes = {
        "S=1": (ints(4950), (ints(4950), ints(4960))),
        "S=3": (ints(100, 2000, 4950), (ints(4950, 4950, 4950), ints(4955, 4955, 4955))),
    }
    out = {"checkout": checkout}
    for name, (lens, band) in shapes.items():
        S = lens.numel()
        q = randn(S, 1, 28, 128, scale=2.0)
        k, v = randn(S, 4, M, 128), randn(S, 4, M, 128)
        out[f"K2 {name}"] = both(lambda: dec.decode_attention(q, k, v, lens, band))
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
