"""Time the quantized serving kernels (K4: packed-int4 matmul with int8 x,
w4a8; K3: silu * mul * quantize) of one or more checkouts of this repository
on one card, in one run, so that two versions of ``csrc/w4_matmul.cu`` or
``csrc/silu_mul_quant.cu`` can be compared:

    python unimedvl_tpu_torch/tools/time_quant_kernels.py PARENT CHANGE CHANGE PARENT

Each checkout is timed in a process of its own (it imports that checkout's
package and builds its kernels there). K4 runs at the LLM's four quantized
projections, (K, N) = (3584, 4608) qkv fused, (3584, 3584) o, (3584, 37888)
gate_up fused and (18944, 3584) down, at m = 1 (a decode step), 731 (the
378 px image's prefill) and 4902 (the 980 px image's), per output channel and
with groups of 512 in-rows; beside each, in the same process, one
``torch._int_mm`` on the same x and the unpacked int8 weight (rows padded to
17 below that; a yardstick only: no PyTorch call multiplies by packed int4)
and the bound: the larger of the bytes (x, x_scale, the packed weight, its
scales and the bf16 output, each once) over 3.35 TB/s and 2 m K N int8
operations over 1979 TOP/s. K3 runs at R = 1 and 4902 rows of I = 18944, its
bound the bytes (g and u in bf16, q in int8 and the row scales) over 3.35
TB/s. Every time is three readings of the time per call in a run of 20 (CUDA
events, ms, after warm-up). One JSON line per checkout, after the card's name
and power limit."""

from __future__ import annotations

import json
import subprocess
import sys

RUN = 20
HBM_BYTES_S, INT8_OPS_S = 3.35e12, 1979e12
PROJECTIONS = {"qkv": (3584, 4608), "o": (3584, 3584), "gate_up": (3584, 37888),
               "down": (18944, 3584)}
ROWS = (1, 731, 4902)
GROUP = 512
K3_I, K3_ROWS = 18944, (1, 4902)


def k4_bound_ms(m: int, K: int, N: int, groups: int) -> float:
    n_bytes = m * K + 4 * m + N * K // 2 + 4 * N * max(groups, 1) + 2 * m * N
    return 1e3 * max(n_bytes / HBM_BYTES_S, 2.0 * m * K * N / INT8_OPS_S)


def k3_bound_ms(R: int) -> float:
    return 1e3 * (R * K3_I * (2 + 2 + 1) + 4 * R) / HBM_BYTES_S


def _worker(checkout: str) -> None:
    sys.path.insert(0, checkout)
    import torch

    from unimedvl_tpu_torch import quant
    from unimedvl_tpu_torch.ops import act_quant as aq
    from unimedvl_tpu_torch.ops import w4_matmul as w4

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

    def int8(*shape, lo=-127, hi=128):
        return torch.randint(lo, hi, shape, generator=g, device="cuda", dtype=torch.int8)

    out = {"checkout": checkout, "k4": {}, "k3": {}}
    for name, (K, N) in PROJECTIONS.items():
        wq = int8(N, K, lo=-8, hi=8)
        wp = w4.pack_int4(wq)
        for groups in (0, K // GROUP):
            ws = torch.rand((groups, N) if groups else (N,), generator=g, device="cuda") * 0.01
            for m in ROWS:
                x = int8(m, K)
                xs = torch.rand(m, 1, generator=g, device="cuda") * 0.05 + 0.001
                out["k4"][f"{name} m={m} {'group 512' if groups else 'per channel'}"] = {
                    "ms": run_ms(lambda: w4.w4_matmul(x, xs, wp, ws)),
                    "int_mm_ms": run_ms(lambda: quant.int_mm(x, wq)),
                    "bound_ms": round(k4_bound_ms(m, K, N, groups), 4),
                }
        del wq, wp
    for R in K3_ROWS:
        gu = torch.randn(R, 2 * K3_I, generator=g, device="cuda").to(torch.bfloat16)
        gate, up = gu.split(K3_I, dim=-1)
        out["k3"][f"R={R}"] = {"ms": run_ms(lambda: aq.silu_mul_quant(gate, up)),
                               "bound_ms": round(k3_bound_ms(R), 5)}
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
