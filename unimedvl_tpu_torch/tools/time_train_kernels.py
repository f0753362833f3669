"""Time the packed training attention kernels (K5: forward, dq, dk/dv) of one
or more checkouts of this repository on one card, in one run, so that two
versions of ``csrc/packed_train_attention.cu`` can be compared:

    python unimedvl_tpu_torch/tools/time_train_kernels.py PARENT CHANGE CHANGE PARENT

Each checkout is timed in a process of its own (it imports that checkout's
package and builds its kernels there), at two packed layouts like those
``chip_smoke.py`` trains on, 28/4 heads, D = 128: an edit example alone in
4096 tokens (text 56, ViT 1296 full, clean latents 1024 full, noised latents
1024, pads) and a 980 px VQA example with a text-to-image example in 6144
(text 60, ViT 4900 full, text 60; text 57, noised latents 1024; pads). Per
layout and kernel it prints three medians of 7 calls (CUDA events, ms), as
one JSON line per checkout after the card's name and power limit."""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

LAYOUTS = {  # name -> (T, sample_lens, split_lens, modes)
    "edit_4096": (4096, [3400], [56, 1296, 1024, 1024], ["causal", "full", "full", "noise"]),
    "vqa980_t2i_6144": (6144, [5020, 1081], [60, 4900, 60, 57, 1024],
                        ["causal", "full", "causal", "causal", "noise"]),
}


def _worker(checkout: str) -> None:
    sys.path.insert(0, checkout)
    import numpy as np
    import torch

    from unimedvl_tpu_torch.ops import flash_attention_train as fat
    from unimedvl_tpu_torch.ops.blockmask import packed_segment_ids

    def ms(fn):
        for _ in range(2):
            fn()
        times = []
        for _ in range(7):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    g = torch.Generator(device="cuda").manual_seed(0)
    out = {"checkout": checkout}
    for name, (T, sample_lens, split_lens, modes) in LAYOUTS.items():
        ids = []
        for a, fill in zip(packed_segment_ids(sample_lens, split_lens, modes), (0, -1, -1)):
            ids.append(torch.from_numpy(
                np.concatenate([a, np.full(T - len(a), fill, np.int32)])).cuda())
        q, k, v, cot = (torch.randn(T, h, 128, generator=g, device="cuda").to(torch.bfloat16)
                        for h in (28, 4, 4, 28))
        o, lse = fat._launch_fwd(q, k, v, *ids)
        calls = {
            "fwd": lambda: fat._launch_fwd(q, k, v, *ids),
            "bwd_dq": lambda: fat._launch_bwd(q, k, v, o, lse, *ids, cot, True, False),
            "bwd_dkv": lambda: fat._launch_bwd(q, k, v, o, lse, *ids, cot, False, True),
        }
        out[name] = {key: [round(ms(fn), 4) for _ in range(3)] for key, fn in calls.items()}
    print(json.dumps(out), flush=True)


def main() -> None:
    if len(sys.argv) >= 3 and sys.argv[1] == "--worker":
        _worker(sys.argv[2])
        return
    checkouts = sys.argv[1:] or ["."]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for checkout in checkouts:
        subprocess.run([sys.executable, __file__, "--worker", checkout], check=True)


if __name__ == "__main__":
    main()
