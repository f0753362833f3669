"""Time the quantized serving kernels (K4: packed-int4 matmul, with int8 x
(w4a8) and with bf16 x (weight-only w4); K3: silu * mul * quantize) of one or
more checkouts of this repository on one card, in one run, so that two
versions of ``csrc/w4_matmul.cu`` or ``csrc/silu_mul_quant.cu`` can be
compared:

    python unimedvl_tpu_torch/tools/time_quant_kernels.py PARENT CHANGE CHANGE PARENT
    python unimedvl_tpu_torch/tools/time_quant_kernels.py --gemv PARENT CHANGE CHANGE PARENT
    python unimedvl_tpu_torch/tools/time_quant_kernels.py --chat PARENT CHANGE CHANGE PARENT
    python unimedvl_tpu_torch/tools/time_quant_kernels.py --global PARENT CHANGE CHANGE PARENT

Each checkout is timed in a process of its own (it imports that checkout's
package and builds its kernels there). K4 runs at the LLM's four quantized
projections, (K, N) = (3584, 4608) qkv fused, (3584, 3584) o, (3584, 37888)
gate_up fused and (18944, 3584) down, per output channel and with groups of
512 in-rows (and of 32 where the checkout's K4 takes them). With int8 x at m = 1 (a decode step), 731 (the 378 px image's
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
groups of 512 (and of 32, as above), each case in a CUDA graph of 20 calls that rotate over copies
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

``--global`` instead times K3's second entry (``silu_mul_quant_global``)
at a tensor-parallel rank's down shard, I = 18944 / 2 and / 4, at R = 1, 8,
16 (decode and the batcher's streams), 731 (a 378 px block), 1026 and 3078
(the mesh denoise rows) and 4902 (the 980 px image prefill), on the halves of
one fused gate_up output: the whole call with ``reduce_max=None`` and each
pass alone as a bare launch, each in a run of 20 and in a CUDA graph of 20,
beside the function's bound (5 R I + 4 R bytes), the two passes' (9 R I + 4
R) and each pass's own. Where the checkout has ``global_plan``, its plan, and
both passes in CUDA graphs on other plans: at R 1 to 256 on each cluster
size and on the ring; above 128 rows on the ring with one CTA an SM or two,
each with 2 stages or its most. Beside them the first entry
(``silu_mul_quant``) on the whole row, I 18944, at R 1, 8 and 16, in a
graph.

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
GLOBAL_TPS = {2: 18944 // 2, 4: 18944 // 4}  # K3's second entry: I of a down shard at tp 2, 4
GLOBAL_ROWS = (1, 8, 16, 731, 1026, 3078, 4902)
GLOBAL_SWEEP_ROWS = (1, 8, 16, 32, 64, 128, 256, 731, 4902)
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


def run_ms(fn, run: int = RUN) -> list:
    """Three readings of the time per call in ms in a run of ``run``, after
    warm-up (CUDA events)."""
    import torch

    for _ in range(3):
        fn()
    readings = []
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(run):
            fn()
        end.record()
        torch.cuda.synchronize()
        readings.append(round(start.elapsed_time(end) / run, 4))
    return readings


def graph_ms(fn, run: int = RUN) -> list:
    """Three readings of the time per call in ms in a CUDA graph of ``run``
    calls: the card's time alone."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(run):
            fn()
    return [round(r / run, 5) for r in run_ms(graph.replay)]


def group_sizes(w4) -> tuple:
    """K4's group sizes timed in a checkout: 512, and 32 where its kernels
    take groups of 32 (``k4_route``)."""
    return (GROUP, 32) if hasattr(w4, "k4_route") else (GROUP,)


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

    g = torch.Generator(device="cuda").manual_seed(0)

    def int8(*shape, lo=-127, hi=128):
        return torch.randint(lo, hi, shape, generator=g, device="cuda", dtype=torch.int8)

    out = {"checkout": checkout, "k4": {}, "k4_bf16": {}, "k3": {}, "graph": {}}
    for name, (K, N) in PROJECTIONS.items():
        wq = int8(N, K, lo=-8, hi=8)
        wp = w4.pack_int4(wq)
        for groups in (0, *(K // size for size in group_sizes(w4))):
            ws = torch.rand((groups, N) if groups else (N,), generator=g, device="cuda") * 0.01
            kind = f"group {K // groups}" if groups else "per channel"
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


def global_bounds_ms(R: int, I: int) -> dict:
    """Bounds of K3's second entry at R rows of I: the function's (g and u
    read once, q and the scales written, as the smoke reckons it), the two
    passes' (g and u read twice), and each pass's own."""
    ms = lambda n_bytes: round(1e3 * n_bytes / HBM_BYTES_S, 5)  # noqa: E731
    return {"bound_ms": ms(5 * R * I + 4 * R), "two_pass_bound_ms": ms(9 * R * I + 4 * R),
            "scale_bound_ms": ms(4 * R * I + 4 * R), "quant_bound_ms": ms(5 * R * I + 4 * R)}


def _global_worker(checkout: str) -> None:
    sys.path.insert(0, checkout)
    import torch

    from unimedvl_tpu_torch.ops import act_quant as aq
    from unimedvl_tpu_torch.ops import cuda_build

    lib = cuda_build.load_library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    planned = hasattr(aq, "global_plan")  # the redesigned entry; before it, two plain kernels

    def passes(g2, u2, scale, q, plan=None):
        """(scale pass, quantize pass) as launches alone, without the wrapper."""
        R, I = g2.shape
        stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
        if planned:
            plan = plan or aq.global_plan(R, I, sms)
            return (lambda: aq._global_pass(0, aq._global_args(g2, u2, scale, q, plan, stream())),
                    lambda: aq._global_pass(1, aq._global_args(g2, u2, scale, q, plan, stream())))
        return (lambda: cuda_build.check(lib.unimedvl_silu_mul_scale(
                    g2.data_ptr(), u2.data_ptr(), scale.data_ptr(), R, I, g2.stride(0),
                    u2.stride(0), stream()), "scale pass"),
                lambda: cuda_build.check(lib.unimedvl_silu_mul_quant_scaled(
                    g2.data_ptr(), u2.data_ptr(), scale.data_ptr(), q.data_ptr(), R, I,
                    g2.stride(0), u2.stride(0), stream()), "quantize pass"))

    g = torch.Generator(device="cuda").manual_seed(0)
    out = {"checkout": checkout, "global": {}, "first_entry_graph": {}, "sweeps": {}}
    for tp, I in GLOBAL_TPS.items():
        for R in GLOBAL_ROWS:
            gu = (torch.randn(R, 2 * I, generator=g, device="cuda") * 2.0).to(torch.bfloat16)
            gate, up = gu.split(I, dim=-1)  # the halves of a fused gate_up shard's output
            q = torch.empty(R, I, dtype=torch.int8, device="cuda")
            scale = torch.empty(R, 1, device="cuda")
            call = lambda: aq.silu_mul_quant_global(gate, up, None)  # noqa: E731
            scale_pass, quant_pass = passes(gate, up, scale, q)
            scale_pass()
            row = {"call": {"run": run_ms(call), "graph": graph_ms(call)},
                   "scale": {"run": run_ms(scale_pass), "graph": graph_ms(scale_pass)},
                   "quant": {"run": run_ms(quant_pass), "graph": graph_ms(quant_pass)},
                   **global_bounds_ms(R, I)}
            if planned:
                row["plan"] = aq.global_plan(R, I, sms)._asdict()
            out["global"][f"tp {tp} R={R} I={I}"] = row
            del gu, q, scale
        for R in GLOBAL_SWEEP_ROWS if planned else ():
            gu = (torch.randn(R, 2 * I, generator=g, device="cuda") * 2.0).to(torch.bfloat16)
            gate, up = gu.split(I, dim=-1)
            q = torch.empty(R, I, dtype=torch.int8, device="cuda")
            scale = torch.empty(R, 1, device="cuda")
            plans = {}
            if R <= 256:  # either route, and each cluster size
                plans = {f"cluster {c}": aq.GlobalPlan(c, c * R, 0) for c in (2, 4, 8, 16)}
            base = aq.global_plan(max(R, aq.GLOBAL_CLUSTER_MAX_ROWS + 1), I, sms)
            base = base._replace(ctas=min(R, base.per_sm * sms))
            plans["ring"] = base
            for per_sm in (1, 2) if R > 128 else ():  # the ring's other shape, and its stages
                most = min(aq.RING_STAGES, aq.RING_BYTES // per_sm // (4 * I))
                for stages in sorted({2, most}):
                    plans[f"ring {per_sm} an SM, {stages} stages"] = base._replace(
                        per_sm=per_sm, stages=stages, ctas=min(R, per_sm * sms))
            for name, plan in plans.items():
                both = passes(gate, up, scale, q, plan)
                out["sweeps"][f"tp {tp} R={R} {name}"] = graph_ms(lambda: (both[0](), both[1]()))
            del gu, q, scale
    for R in (1, 8, 16):  # the first entry on the whole row, as one card runs it
        gu = torch.randn(R, 2 * K3_I, generator=g, device="cuda").to(torch.bfloat16)
        gate, up = gu.split(K3_I, dim=-1)
        out["first_entry_graph"][f"R={R} I={K3_I}"] = graph_ms(lambda: aq.silu_mul_quant(gate, up))
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
        for groups in (0, *(K // size for size in group_sizes(w4))):
            kind = f"group {K // groups}" if groups else "per channel"
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
        for kind in ("per channel", *(f"group {size}" for size in group_sizes(w4))):
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
    workers = {"--worker": _worker, "--gemv-worker": _gemv_worker, "--chat-worker": _chat_worker,
               "--global-worker": _global_worker}
    if len(sys.argv) >= 3 and sys.argv[1] in workers:
        workers[sys.argv[1]](sys.argv[2])
        return
    modes = ("--chat", "--gemv", "--global")
    mode = sys.argv[1] if len(sys.argv) >= 2 and sys.argv[1] in modes else ""
    checkouts = sys.argv[2 if mode else 1:] or ["."]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for checkout in checkouts:
        subprocess.run([sys.executable, __file__, f"{mode}-worker" if mode else "--worker",
                        checkout], check=True)

if __name__ == "__main__":
    main()
