"""Time the block flash attention kernels (K1a, K1b, and K1c and K6 where the
checkout has them) of one or more checkouts of this repository on one card,
in one run, so that two versions of ``csrc/flash_block_attention.cu`` (and of
the device code it shares) can be compared:

    python unimedvl_tpu_torch/tools/time_flash_kernels.py PARENT CHANGE CHANGE PARENT

Each checkout is timed in a process of its own (it imports that checkout's
package and builds its kernels there), at path shapes of ``chip_smoke.py``,
28/4 heads: K1a image prefill (T 5122 over M 5632, D 128) and ViT (T 5120, D
72); K1b 3-stream denoise steps (T 1026; lens (37, 0, 37) over M 1538 and
(2440, 2403, 37) over M 4098); K1c's block partial and K6 over the edit cache.
Per shape it prints three medians of 7 single calls (CUDA events) and three
times per call in a run of 20, as one JSON line per checkout after the card's
name and power limit."""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

RUN = 20


def _worker(checkout: str) -> None:
    sys.path.insert(0, checkout)
    import torch

    from unimedvl_tpu_torch.ops import flash_attention as fa
    from unimedvl_tpu_torch.ops.rope import rope_cos_sin

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

    out = {"checkout": checkout}
    q, kv = randn(1, 5122, 28, 128, scale=2.0), randn(2, 1, 4, 5632, 128)
    zero, qvl = ints(0), ints(4902)
    out["K1a image prefill"] = both(
        lambda: fa.flash_block_attention(q, kv[0], kv[1], zero, zero, False, qvl, True))
    qv, kvv = randn(1, 5120, 16, 72, scale=2.0), randn(2, 1, 5120, 16, 72)
    lens, bstart = ints(4900), ints(5120)
    out["K1a ViT"] = both(
        lambda: fa.flash_block_attention(qv, kvv[0], kvv[1], lens, bstart, False))
    cos, sin = rope_cos_sin(torch.full((3, 1), 41, device="cuda"), 128, 1e6)
    w = [(1 + 0.1 * torch.randn(128, generator=g, device="cuda")).to(torch.bfloat16)
         for _ in range(2)]
    qp = dict(w_und=w[0], w_gen=w[1], cos=cos, sin=sin, end_row=None, eps=1e-6)
    qd = randn(3, 1026, 28, 128, scale=2.0)
    for name, cap, ln in (("text to image", 512, (37, 0, 37)), ("edit", 3072, (2440, 2403, 37))):
        kc = randn(2, 3, 4, cap + 1026, 128)
        args = (qd, kc[0], kc[1], ints(*ln), ints(cap, cap, cap), False, None, True)
        out[f"K1b denoise, {name}"] = both(
            lambda: fa.flash_block_attention(*args, q_preproc=qp))
    if hasattr(fa, "lse_counts"):  # a checkout with K1c and K6
        kb = randn(2, 3, 1026, 4, 128)
        out["K1c block partial"] = both(lambda: fa.flash_block_attention(
            qd, kb[0].transpose(1, 2), kb[1].transpose(1, 2), 1026, 1026, False,
            q_valid_len=0, kv_head_major=True, q_preproc=qp, return_lse=True))
        kc = randn(2, 3, 4, 2560, 128)
        ln = ints(2453, 2397, 56)
        out["K6 edit cache, q island"] = both(lambda: fa.flash_cache_block_attention(
            qd, kc[0], kc[1], kb[0], kb[1], ln, False, q_preproc=qp, cache_head_major=True))
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
