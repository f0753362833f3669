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
layout it prints, as three readings of the time per call in a run of 20 (CUDA
events, ms): the forward, the backward for dq alone, for dk/dv alone and for
all three gradients (what a training step runs: one plan for both kernels;
the forward includes the plan launch where the checkout's forward builds the
plan, each backward the launch of its row data); beside them, in the same
process, one ``scaled_dot_product_attention`` on the same dense bool mask (K/V
expanded to the query heads) forward and backward (all three gradients), and
each kernel's bound: the larger of its bytes (each
operand read once, each output written once) over 3.35 TB/s and its flops over
the allowed pairs (4, 6 and 8 D per pair and head for forward, dq and dk/dv)
over 989 TFLOP/s. One JSON line per checkout, after the card's name and power
limit."""

from __future__ import annotations

import json
import subprocess
import sys

RUN = 20
H, HK, D = 28, 4, 128
HBM_BYTES_S, BF16_FLOPS_S = 3.35e12, 989e12
LAYOUTS = {  # name -> (T, sample_lens, split_lens, modes)
    "edit_4096": (4096, [3400], [56, 1296, 1024, 1024], ["causal", "full", "full", "noise"]),
    "vqa980_t2i_6144": (6144, [5020, 1081], [60, 4900, 60, 57, 1024],
                        ["causal", "full", "causal", "causal", "noise"]),
}


def bounds_ms(T: int, pairs: int) -> dict:
    """The bound of each kernel (as ``chip_smoke.py`` counts it) and of the
    two backward kernels together, for T tokens of which ``pairs`` (query,
    key) pairs are allowed."""
    qb, kb, stat, idb = T * H * D * 2, T * HK * D * 2, H * T * 4, 3 * T * 4
    work = {
        "fwd": (2 * qb + 2 * kb + stat + idb, 4.0 * D * pairs * H),
        "bwd_dq": (3 * qb + 2 * kb + 2 * stat + idb, 6.0 * D * pairs * H),
        "bwd_dkv": (2 * qb + 4 * kb + 2 * stat + idb, 8.0 * D * pairs * H),
        "bwd": (3 * qb + 4 * kb + 2 * stat + idb, 14.0 * D * pairs * H),
    }
    return {k: 1e3 * max(b / HBM_BYTES_S, f / BF16_FLOPS_S) for k, (b, f) in work.items()}


def _worker(checkout: str) -> None:
    sys.path.insert(0, checkout)
    import numpy as np
    import torch

    from unimedvl_tpu_torch.ops import flash_attention_train as fat
    from unimedvl_tpu_torch.ops.blockmask import dense_packed_mask, packed_segment_ids

    def run_ms(fn):
        """Three readings of the time per call in a run of RUN, after warm-up."""
        for _ in range(3):
            fn()
        readings = []
        for _ in range(3):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(RUN):
                fn()
            end.record()
            torch.cuda.synchronize()
            readings.append(round(start.elapsed_time(end) / RUN, 4))
        return readings

    g = torch.Generator(device="cuda").manual_seed(0)
    out = {"checkout": checkout}
    for name, (T, sample_lens, split_lens, modes) in LAYOUTS.items():
        ids = []
        for a, fill in zip(packed_segment_ids(sample_lens, split_lens, modes), (0, -1, -1)):
            ids.append(torch.from_numpy(
                np.concatenate([a, np.full(T - len(a), fill, np.int32)])).cuda())
        q, k, v, cot = (torch.randn(T, h, D, generator=g, device="cuda").to(torch.bfloat16)
                        for h in (H, HK, HK, H))
        o, lse, *plan = fat._launch_fwd(q, k, v, *ids)
        # a checkout whose forward returns its plan passes it to the backward in the ids'
        # place; an older one's backward takes the ids and builds its plan itself
        between = tuple(plan) or tuple(ids)
        row = {key: run_ms(fn) for key, fn in {
            "fwd": lambda: fat._launch_fwd(q, k, v, *ids),
            "bwd_dq": lambda: fat._launch_bwd(q, k, v, o, lse, *between, cot, True, False),
            "bwd_dkv": lambda: fat._launch_bwd(q, k, v, o, lse, *between, cot, False, True),
            "bwd": lambda: fat._launch_bwd(q, k, v, o, lse, *between, cot, True, True),
        }.items()}
        mask = dense_packed_mask(*ids)
        qh, kh, vh = (t.repeat_interleave(r, dim=1).transpose(0, 1)[None].contiguous()
                      .requires_grad_(True) for t, r in ((q, 1), (k, H // HK), (v, H // HK)))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lout = sdpa(qh, kh, vh, attn_mask=mask[None, None])
        lcot = cot.transpose(0, 1)[None].contiguous()
        row["sdpa_fwd"] = run_ms(lambda: sdpa(qh.detach(), kh.detach(), vh.detach(),
                                              attn_mask=mask[None, None]))
        row["sdpa_bwd"] = run_ms(
            lambda: torch.autograd.grad(lout, (qh, kh, vh), lcot, retain_graph=True))
        del lout
        row["bound_ms"] = {k: round(b, 4) for k, b in
                           bounds_ms(T, int(mask.sum())).items()}
        out[name] = row
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
