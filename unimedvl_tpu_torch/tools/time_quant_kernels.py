"""Time the quantized serving kernels (K4: packed-int4 matmul, with int8 x
(w4a8) and with bf16 x (weight-only w4); K3: silu * mul * quantize) of one or
more checkouts of this repository on one card, in one run, so that two
versions of ``csrc/w4_matmul.cu`` or ``csrc/silu_mul_quant.cu`` can be
compared:

    python unimedvl_tpu_torch/tools/time_quant_kernels.py PARENT CHANGE CHANGE PARENT
    python unimedvl_tpu_torch/tools/time_quant_kernels.py --gemv PARENT CHANGE CHANGE PARENT
    python unimedvl_tpu_torch/tools/time_quant_kernels.py --chat PARENT CHANGE CHANGE PARENT

Each checkout is timed in a process of its own (it imports that checkout's
package and builds its kernels there). K4 runs at the LLM's four quantized
projections, (K, N) = (3584, 4608) qkv fused, (3584, 3584) o, (3584, 37888)
gate_up fused and (18944, 3584) down, per output channel and with groups of
512 in-rows. With int8 x at m = 1 (a decode step), 731 (the 378 px image's
prefill) and 4902 (the 980 px image's), beside one ``torch._int_mm`` on the
same x and the unpacked int8 weight (rows padded to 17 below that); with bf16
x at m = 731 and 4902, beside one ``torch.mm`` of x by the weight unpacked,
scaled and cast to bf16. Both are yardsticks only: no PyTorch call
multiplies by packed int4. The bound is the larger of the bytes (x, x_scale,
the packed weight, its scales and the bf16 output, each once) over 3.35
TB/s and 2 m K N operations over 1979 TOP/s (int8 x) or 989 TFLOP/s (bf16
x). K3 runs at R = 1, 731 and 4902 rows of I = 18944, its bound the bytes (g
and u in bf16, q in int8 and the row scales) over 3.35 TB/s. Every time is
three readings of the time per call in a run of 20 (CUDA events, ms, after
warm-up). K3's one-row calls (R 1 and 3) are also read in a CUDA graph of 20
calls, the card's time alone; where a checkout's K3 has launch shapes (``CLUSTER_SIZE``,
``CLUSTER_MAX_ROWS``), R 1 and 3 are read at every cluster size and on the
many-row path too.

``--gemv`` instead times K4's GEMV as a decode step meets it, cold: at the
four projections, m = 1, 2, 3, 4, int8 x and bf16 x, per channel and with
groups of 512, each case in a CUDA graph of 20 calls that rotate over copies
of the packed weight and its scales, as many as exceed twice the card's L2
(``cold_copies``), so that every call reads its weight from HBM as a decode
step reads each layer's; beside it the bound and the yardstick on the same
kind of rotation (``torch._int_mm`` on the unpacked int8 weight, rows
padded to 17, for int8 x; ``torch.mm`` on the weight unpacked, scaled and
cast to bf16 for bf16 x; the yardstick does not depend on the scales' kind,
so it is timed per channel only), and per x type and kind of scales the sum
of the four projections at m = 1, one layer of a decode step. Three readings
each. Beside them the wrapper's host time per call at m = 1 (``host_us``:
200 calls on the host clock, no synchronisation inside; what a host-bound
decode step pays per projection).

``--chat`` instead times, per checkout, the weight-only w4 serving mode end
to end at the 14B geometry (random weights, ``chip_smoke.py``'s model and
requests): the 980 px and 378 px requests, three times each after a warm-up,
with s/image (``chat`` start to the end of the image's LLM prefill) and the
image's LLM prefill alone. One JSON line per checkout, after the card's name
and power limit."""

from __future__ import annotations

import json
import math
import subprocess
import sys

RUN = 20
HBM_BYTES_S, INT8_OPS_S, BF16_OPS_S = 3.35e12, 1979e12, 989e12
PROJECTIONS = {"qkv": (3584, 4608), "o": (3584, 3584), "gate_up": (3584, 37888),
               "down": (18944, 3584)}
ROWS = (1, 731, 4902)
BF16_ROWS = (731, 4902)
GROUP = 512
K3_I, K3_ROWS = 18944, (1, 731, 4902)
CLUSTERS = (0, 2, 4, 8, 16)
GEMV_ROWS = (1, 2, 3, 4)
L2_BYTES = 50e6  # the H100's L2


def cold_copies(n_bytes: int) -> int:
    """Copies of an operand of ``n_bytes`` that a rotation of calls needs to
    read more than twice the L2 between two uses of one copy."""
    return max(1, math.ceil(2 * L2_BYTES / n_bytes))


def rotating_graph_readings(calls, run: int = RUN, readings: int = 3) -> list:
    """``readings`` times per call in ms: CUDA graphs of ``run`` calls that
    take ``calls`` in turn, replayed after a warm-up (CUDA events around
    ``run`` replays)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for call in calls:
            call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(run):
            calls[i % len(calls)]()
    for _ in range(3):
        graph.replay()
    out = []
    for _ in range(readings):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(run):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        out.append(round(start.elapsed_time(end) / run / run, 5))
    return out


def k4_bound_ms(m: int, K: int, N: int, groups: int, bf16_x: bool = False) -> float:
    x_bytes = 2 * m * K if bf16_x else m * K + 4 * m
    n_bytes = x_bytes + N * K // 2 + 4 * N * max(groups, 1) + 2 * m * N
    ops_s = BF16_OPS_S if bf16_x else INT8_OPS_S
    return 1e3 * max(n_bytes / HBM_BYTES_S, 2.0 * m * K * N / ops_s)


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

    def graph_ms(fn):
        """Three readings of the time per call in a CUDA graph of RUN calls."""
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
        return [round(r / RUN, 5) for r in run_ms(graph.replay)]

    g = torch.Generator(device="cuda").manual_seed(0)

    def int8(*shape, lo=-127, hi=128):
        return torch.randint(lo, hi, shape, generator=g, device="cuda", dtype=torch.int8)

    out = {"checkout": checkout, "k4": {}, "k4_bf16": {}, "k3": {}, "graph": {}}
    for name, (K, N) in PROJECTIONS.items():
        wq = int8(N, K, lo=-8, hi=8)
        wp = w4.pack_int4(wq)
        for groups in (0, K // GROUP):
            ws = torch.rand((groups, N) if groups else (N,), generator=g, device="cuda") * 0.01
            kind = "group 512" if groups else "per channel"
            for m in ROWS:
                x = int8(m, K)
                xs = torch.rand(m, 1, generator=g, device="cuda") * 0.05 + 0.001
                out["k4"][f"{name} m={m} {kind}"] = {
                    "ms": run_ms(lambda: w4.w4_matmul(x, xs, wp, ws)),
                    "int_mm_ms": run_ms(lambda: quant.int_mm(x, wq)),
                    "bound_ms": round(k4_bound_ms(m, K, N, groups), 4),
                }
            # the yardstick's weight: unpacked, scaled and cast to bf16 once, outside the timing
            scale = ws.t().repeat_interleave(K // groups, dim=1) if groups else ws[:, None]
            wb = (wq.float() * scale).to(torch.bfloat16)
            for m in BF16_ROWS:
                x = torch.randn(m, K, generator=g, device="cuda").to(torch.bfloat16)
                out["k4_bf16"][f"{name} m={m} {kind}"] = {
                    "ms": run_ms(lambda: w4.w4_matmul(x, None, wp, ws)),
                    "mm_ms": run_ms(lambda: torch.mm(x, wb.t())),
                    "bound_ms": round(k4_bound_ms(m, K, N, groups, bf16_x=True), 4),
                }
            del wb
        del wq, wp
    has_clusters = hasattr(aq, "CLUSTER_SIZE")
    for R in K3_ROWS:
        gu = torch.randn(R, 2 * K3_I, generator=g, device="cuda").to(torch.bfloat16)
        gate, up = gu.split(K3_I, dim=-1)
        out["k3"][f"R={R}"] = {"ms": run_ms(lambda: aq.silu_mul_quant(gate, up)),
                               "bound_ms": round(k3_bound_ms(R), 5)}
    for R in (1, 3):
        gu = torch.randn(R, 2 * K3_I, generator=g, device="cuda").to(torch.bfloat16)
        gate, up = gu.split(K3_I, dim=-1)
        out["graph"][f"k3 R={R}"] = graph_ms(lambda: aq.silu_mul_quant(gate, up))
        for c in CLUSTERS if has_clusters else ():  # 0: the many-row path
            limit, size = aq.CLUSTER_MAX_ROWS, aq.CLUSTER_SIZE
            aq.CLUSTER_MAX_ROWS, aq.CLUSTER_SIZE = (R, c) if c else (0, size)
            out["graph"][f"k3 R={R} cluster={c}"] = graph_ms(lambda: aq.silu_mul_quant(gate, up))
            aq.CLUSTER_MAX_ROWS, aq.CLUSTER_SIZE = limit, size
    print(json.dumps(out), flush=True)


def _gemv_worker(checkout: str) -> None:
    sys.path.insert(0, checkout)
    import statistics

    import torch

    from unimedvl_tpu_torch import quant
    from unimedvl_tpu_torch.ops import w4_matmul as w4

    import time

    def host_us(fn, calls=200):
        """Median of three: host microseconds per call over ``calls`` calls."""
        readings = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            readings.append(1e6 * (time.perf_counter() - t0) / calls)
            torch.cuda.synchronize()
        return round(statistics.median(readings), 2)

    g = torch.Generator(device="cuda").manual_seed(0)
    out = {"checkout": checkout, "gemv": {}, "layer_m1": {}}
    for name, (K, N) in PROJECTIONS.items():
        wq = torch.randint(-8, 8, (N, K), generator=g, device="cuda", dtype=torch.int8)
        wp = w4.pack_int4(wq)
        ws0 = torch.rand(N, generator=g, device="cuda") * 0.01
        # the yardsticks' weights, rotated as the packed ones are
        wqs = [wq] + [wq.clone() for _ in range(cold_copies(wq.numel()) - 1)]
        wb = (wq.float() * ws0[:, None]).to(torch.bfloat16)
        wbs = [wb] + [wb.clone() for _ in range(cold_copies(2 * wb.numel()) - 1)]
        for groups in (0, K // GROUP):
            kind = "group 512" if groups else "per channel"
            ws = torch.rand((groups, N) if groups else (N,), generator=g, device="cuda") * 0.01
            copies = [(wp, ws)] + [(wp.clone(), ws.clone()) for _ in range(
                cold_copies(wp.numel() + 4 * ws.numel()) - 1)]
            for m in GEMV_ROWS:
                xi = torch.randint(-127, 128, (m, K), generator=g, device="cuda", dtype=torch.int8)
                xs = torch.rand(m, 1, generator=g, device="cuda") * 0.05 + 0.001
                xb = torch.randn(m, K, generator=g, device="cuda").to(torch.bfloat16)
                for xname, x, x_scale, bf16_x in (("int8 x", xi, xs, False),
                                                  ("bf16 x", xb, None, True)):
                    row = {
                        "ms": rotating_graph_readings([
                            (lambda c=c: w4.w4_matmul(x, x_scale, *c)) for c in copies]),
                        "bound_ms": round(k4_bound_ms(m, K, N, groups, bf16_x=bf16_x), 5),
                        "copies": len(copies),
                    }
                    if m == 1:
                        row["host_us"] = host_us(lambda: w4.w4_matmul(x, x_scale, *copies[0]))
                    if not groups:
                        row["yardstick_ms"] = rotating_graph_readings(
                            [(lambda w=w: torch.mm(x, w.t())) for w in wbs] if bf16_x else
                            [(lambda w=w: quant.int_mm(x, w)) for w in wqs])
                    out["gemv"][f"{name} m={m} {xname} {kind}"] = row
            del copies
        del wqs, wbs, wb
    for xname in ("int8 x", "bf16 x"):
        for kind in ("per channel", "group 512"):
            rows = [out["gemv"][f"{name} m=1 {xname} {kind}"] for name in PROJECTIONS]
            out["layer_m1"][f"{xname} {kind}"] = {
                "ms": round(sum(statistics.median(r["ms"]) for r in rows), 5),
                "bound_ms": round(sum(r["bound_ms"] for r in rows), 5)}
    print(json.dumps(out), flush=True)


def _chat_worker(checkout: str) -> None:
    sys.path.insert(0, checkout)
    import time

    import torch

    import chip_smoke as smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    inf = smoke.build_inferencer()
    qinf = smoke.quantized_inferencer(inf, bits=4)
    images = smoke._images()
    lm = qinf.model.language_model
    stamps = []

    def stamp(module, args, output):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    hook = lm.model.embed_tokens.register_forward_hook(stamp)
    out = {"checkout": checkout, "mode": "w4 weight-only, fused, int8 KV", "requests": {}}
    qinf.chat([images[2]], smoke.REQUESTS[2][2], max_length=2)  # warm-up
    for i in (0, 2):
        h, w, prompt = smoke.REQUESTS[i]
        rows = []
        for _ in range(3):
            stamps.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            qinf.chat([images[i]], prompt, max_length=2)
            torch.cuda.synchronize()
            rows.append({"s_per_image": round(stamps[1] - t0, 5),
                         "image_prefill_s": round(stamps[1] - stamps[0], 5)})
        out["requests"][f"{h}x{w}"] = rows
    hook.remove()
    print(json.dumps(out), flush=True)


def main() -> None:
    workers = {"--worker": _worker, "--gemv-worker": _gemv_worker, "--chat-worker": _chat_worker}
    if len(sys.argv) >= 3 and sys.argv[1] in workers:
        workers[sys.argv[1]](sys.argv[2])
        return
    mode = sys.argv[1] if len(sys.argv) >= 2 and sys.argv[1] in ("--chat", "--gemv") else ""
    checkouts = sys.argv[2 if mode else 1:] or ["."]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for checkout in checkouts:
        subprocess.run([sys.executable, __file__, f"{mode}-worker" if mode else "--worker",
                        checkout], check=True)

if __name__ == "__main__":
    main()
