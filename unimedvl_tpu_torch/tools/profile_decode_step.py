"""Where a chat decode step's time goes on one card: a ``torch.profiler`` trace
of a few decode steps of the 980 px and the 378 px chat requests of
``chip_smoke.py`` (full 14B geometry, random weights), in bf16, in full-int8,
in w4a8 per channel and in weight-only w4 per channel, the quantized modes
with fused projections and an int8 KV cache (built as
``chip_smoke.quantized_inferencer`` builds them; K4 serves every projection
of a w4 decode step with its GEMV, int8 x in w4a8, bf16 x in weight-only w4).

    python unimedvl_tpu_torch/tools/profile_decode_step.py [--modes M,..] [CHECKOUT ...]

Each checkout (default ``.``) is profiled in a process of its own that
imports that checkout's package and ``chip_smoke.py`` and builds its
kernels, so two versions can be compared in one run (``build/parent .``).
``--modes`` picks among ``bf16``, ``full_int8``, ``w4a8`` and ``w4`` (default:
all four).

Each request's context is built as ``chat`` builds it; then
``bagel.generate_text`` runs STEPS greedy steps with an end token that never
comes, as ``gen_text`` runs them (one host read of the end test per step),
by each route: the captured decode program (``graphs=True``, the default on
the card; its capture before the timed runs) and the eager loop
(``graphs=False``). Per (checkout, mode, request, route) it prints one JSON
line, every figure per decode step: the wall time without the profiler (median of 3 runs), and from
the trace's kernel events the card's busy time (the union of kernel
intervals), the launches, the busy time split by kind (K2 / K2-int8,
GEMMs, K3, K4, the rest: element-wise ops, reductions, copies), and K4's
launches by grid (one grid per projection shape: calls a step, mean us).
``idle_share`` is 1 - busy / wall; ``idle_share_traced`` the same over the
traced window (the profiler slows the host). The traces are written to
``build/profile`` of the checkout that runs this script.

    python unimedvl_tpu_torch/tools/profile_decode_step.py --mesh [--routes eager|both]

``--mesh`` profiles the bf16 steps of the same two requests on a rank's
model of a one-rank NCCL ("data", "model") mesh (``chip_smoke.one_rank_mesh``:
the all-reduces and the vocab gather really run) beside the same steps
without a mesh, each by the routes of ``--routes`` (default both; ``eager``
runs the mesh steps eagerly only, the no-mesh steps by both routes). Each
mesh row adds ``collectives`` (:func:`collective_stats`): the NCCL kernels
(launches and device time a step), the hop from the compute stream to
NCCL's and back (the idle gap on the card before and after each NCCL kernel)
and the host time of each collective call (the trace's CPU ops of the
collectives, per call).

    python unimedvl_tpu_torch/tools/profile_decode_step.py --diff A B STEPS

prints, for two traces (``.trace.json``, or gzipped) of STEPS steps each,
the traced window a step and the host events (CPU ops, annotations, CUDA
runtime calls) whose time a step grew most from A to B, with their calls a
step: where a mesh's eager step spends what the step without one does not."""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

STEPS = 8
MODES = {  # name -> options of chip_smoke.quantized_inferencer (None: the bf16 model)
    "bf16": None,
    "full_int8": dict(bits=8, act_quant=True),
    "w4a8": dict(bits=4, act_quant=True),
    "w4": dict(bits=4),
}
OUT_DIR = Path(__file__).resolve().parents[2] / "build" / "profile"
KINDS = [  # first match wins
    ("k2", ("decode_attention",)),
    ("k3", ("silu_mul_quant",)),
    ("k4", ("w4_", "w4a8_")),
    ("gemm", ("gemm", "cutlass", "nvjet", "xmma", "cublas", "gemv", "imma")),
]


def _kind(name: str, kinds) -> str:
    low = name.lower()
    for kind, keys in kinds:
        if any(k in low for k in keys):
            return kind
    return "elementwise"


def _summarise(trace_path: Path, steps: int, wall_ms: float, kinds=KINDS) -> dict:
    """Per step, from a trace's kernel events: busy time (the union of kernel
    intervals), idle shares, launches and busy time by kind (``kinds``: first
    match of (kind, name fragments) wins; the rest is "elementwise")."""
    events = [e for e in json.loads(trace_path.read_text())["traceEvents"]
              if e.get("cat") == "kernel"]
    by_kind: dict = {}
    for e in events:
        kind = _kind(e["name"], kinds)
        by_kind[kind] = by_kind.get(kind, 0.0) + e["dur"] / 1e3
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    busy, end = 0.0, spans[0][0]
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    busy_ms = busy / 1e3 / steps
    window_ms = (spans[-1][1] - spans[0][0]) / 1e3 / steps
    k4 = {}  # K4's launches by grid (one grid per projection shape): calls a step, mean us
    for e in events:
        if _kind(e["name"], kinds) == "k4":
            key = f"grid {e.get('args', {}).get('grid')}"
            n, total = k4.get(key, (0, 0.0))
            k4[key] = (n + 1, total + e["dur"])
    return dict(busy_ms=busy_ms, idle_share=1 - busy_ms / wall_ms,
                idle_share_traced=1 - busy_ms / window_ms, launches=len(events) / steps,
                busy_ms_by_kind={k: v / steps for k, v in sorted(by_kind.items())},
                busy_share_by_kind={k: v / steps / busy_ms for k, v in sorted(by_kind.items())},
                k4_by_grid={k: dict(calls=n / steps, mean_us=t / n) for k, (n, t) in k4.items()})


def _nccl(name: str) -> bool:
    return "nccl" in name.lower()


def collective_stats(trace_path: Path, steps: int) -> dict:
    """Per step, from a trace: the NCCL kernels (launches, device ms, mean
    us), the hop around each (``hop_in_us``: from the end of the last
    compute kernel before it to its start; ``hop_out_us``: from its end to
    the start of the next compute kernel; means, and the ms a step both
    add), and the host's collective calls (the CPU ops whose name holds
    allreduce / allgather / broadcast: calls a step and mean us, by name;
    ``launch_gap_us``: the mean host time from the last kernel launch before
    such a call to the first one after it, beside ``other_gap_us``, the mean
    time between two launches elsewhere; ``runtime_calls``: the CUDA runtime
    calls other than launches, a step, by name)."""
    trace = json.loads(trace_path.read_text())["traceEvents"]
    kernels = sorted((e for e in trace if e.get("cat") == "kernel"), key=lambda e: e["ts"])
    nccl = [e for e in kernels if _nccl(e["name"])]
    compute = [(e["ts"], e["ts"] + e["dur"]) for e in kernels if not _nccl(e["name"])]
    starts = [a for a, _ in compute]
    ends = sorted(b for _, b in compute)
    import bisect

    hop_in, hop_out = [], []
    for e in nccl:
        a, b = e["ts"], e["ts"] + e["dur"]
        i = bisect.bisect_right(ends, a)
        if i:
            hop_in.append(a - ends[i - 1])
        j = bisect.bisect_left(starts, b)
        if j < len(starts):
            hop_out.append(starts[j] - b)
    host: dict = {}
    calls = []
    for e in trace:
        low = e.get("name", "").lower()
        if e.get("cat") == "cpu_op" and any(k in low for k in ("allreduce", "all_reduce",
                                                                "allgather", "all_gather",
                                                                "broadcast")):
            n, total = host.get(e["name"], (0, 0.0))
            host[e["name"]] = (n + 1, total + e["dur"])
            calls.append((e["ts"], e["ts"] + e["dur"]))
    runtime = [e for e in trace if e.get("cat") == "cuda_runtime"]
    launches = sorted(e["ts"] for e in runtime if "launch" in e.get("name", "").lower())
    other: dict = {}
    for e in runtime:
        if "launch" not in e.get("name", "").lower():
            other[e["name"]] = other.get(e["name"], 0) + 1
    around, inside = [], set()
    for a, b in calls:
        i = bisect.bisect_left(launches, a)
        j = bisect.bisect_right(launches, b)
        if 0 < i and j < len(launches):
            around.append(launches[j] - launches[i - 1])
            inside.update(range(i - 1, j))
    gaps = [launches[k + 1] - launches[k] for k in range(len(launches) - 1) if k not in inside]

    def mean(xs):
        return sum(xs) / len(xs) if xs else None

    return dict(
        nccl_launches=len(nccl) / steps,
        nccl_ms=sum(e["dur"] for e in nccl) / 1e3 / steps,
        nccl_mean_us=mean([e["dur"] for e in nccl]),
        hop_in_us=mean(hop_in), hop_out_us=mean(hop_out),
        hop_ms=(sum(hop_in) + sum(hop_out)) / 1e3 / steps,
        host_calls={k: dict(calls=n / steps, mean_us=t / n) for k, (n, t) in host.items()},
        launch_gap_us=mean(around), other_gap_us=mean(gaps),
        runtime_calls={k: n / steps for k, n in sorted(other.items())})


def _host_time(path: str, steps: int):
    """(traced window ms a step, {(category, name): (us, calls)} of the host
    events) of a trace."""
    import collections
    import gzip

    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    window = (max(e["ts"] + e["dur"] for e in kernels) - min(e["ts"] for e in kernels)) / 1e3
    time, calls = collections.Counter(), collections.Counter()
    for e in events:
        if e.get("cat") in ("cpu_op", "cuda_runtime", "user_annotation"):
            time[(e["cat"], e["name"])] += e.get("dur", 0)
            calls[(e["cat"], e["name"])] += 1
    return window / steps, {k: (time[k] / steps, calls[k] / steps) for k in time}


def diff_traces(a: str, b: str, steps: int, top: int = 20) -> None:
    wa, ha = _host_time(a, steps)
    wb, hb = _host_time(b, steps)
    print(json.dumps(dict(window_ms_a=wa, window_ms_b=wb)))
    grown = sorted(set(ha) | set(hb),
                   key=lambda k: ha.get(k, (0, 0))[0] - hb.get(k, (0, 0))[0])
    for k in grown[:top]:
        (ta, ca), (tb, cb) = ha.get(k, (0.0, 0.0)), hb.get(k, (0.0, 0.0))
        print(json.dumps(dict(event=list(k), ms_a=ta / 1e3, ms_b=tb / 1e3, grew_ms=(tb - ta) / 1e3,
                              calls_a=ca, calls_b=cb)))


def profile(checkout: str, mode: str, inf, request: int, routes=(True, False),
            tag_extra: str = "") -> None:
    import torch

    import chip_smoke as cs
    from unimedvl_tpu_torch.models import bagel

    h, w, prompt = cs.REQUESTS[request]
    ctx = inf.init_gen_context()
    ctx = inf.update_context_image(cs._images()[request], ctx, vae=False)
    ctx = inf.update_context_text(prompt, ctx)
    ctx = inf._ensure_capacity(ctx, STEPS + 1)
    start = torch.tensor([inf.new_token_ids["bos_token_id"]], device=inf.device)
    pos = torch.tensor([ctx.rope], device=inf.device)

    for graphs in routes:
        def run():
            with torch.no_grad():
                bagel.generate_text(inf.model, ctx.cache, start, pos, STEPS, eos_id=-1,
                                    graphs=graphs)

        run()
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            run()
            torch.cuda.synchronize()
        tag = Path(checkout).resolve().name
        route = "graphed" if graphs else "eager"
        path = OUT_DIR / f"decode_step_{tag}_{mode}{tag_extra}_{h}x{w}_{route}.trace.json"
        prof.export_chrome_trace(str(path))
        wall_ms = 1e3 * statistics.median(walls) / STEPS
        row = dict(checkout=checkout, mode=mode + tag_extra, image=f"{h}x{w}", route=route,
                   cache_columns=int(ctx.cache.lens.max()) + 1, steps=STEPS, wall_ms=wall_ms,
                   decode_tok_s=1e3 / wall_ms,
                   **_summarise(path, STEPS, wall_ms, KINDS + [("nccl", ("nccl",))]))
        if tag_extra:
            row["collectives"] = collective_stats(path, STEPS)
        print(json.dumps(row), flush=True)


def _mesh_worker(checkout: str, mesh_routes) -> None:
    """The bf16 steps without a mesh (both routes), then on a rank's model
    of a one-rank NCCL ("data", "model") mesh (``mesh_routes``)."""
    import tempfile

    import torch

    import chip_smoke as cs
    from unimedvl_tpu_torch.inference import InterleaveInferencer

    inf = cs.build_inferencer()
    for request in (0, 2):
        profile(checkout, "bf16", inf, request)
    with tempfile.TemporaryDirectory() as tmp:
        mesh = cs.one_rank_mesh(("data", "model"), tmp)
        minf = InterleaveInferencer(inf.model, inf.tokenizer, inf.new_token_ids,
                                    vit_transform=inf.vit_transform, seed=cs.SEED, mesh=mesh)
        try:
            for request in (0, 2):
                profile(checkout, "bf16", minf, request, mesh_routes, tag_extra="_nccl_mesh")
        finally:
            torch.distributed.destroy_process_group()


def _worker(checkout: str, modes, mesh_routes=None) -> None:
    sys.path.insert(0, checkout)
    import torch

    import chip_smoke as cs

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    cs.build_kernels()
    if mesh_routes is not None:
        _mesh_worker(checkout, mesh_routes)
        return
    inf = cs.build_inferencer()
    for mode in modes:
        kw = MODES[mode]
        qinf = inf if kw is None else cs.quantized_inferencer(inf, **kw)
        for request in (0, 2):
            profile(checkout, mode, qinf, request)
        del qinf
        torch.cuda.empty_cache()


def main() -> None:
    args = sys.argv[1:]
    if args[:1] == ["--diff"]:
        diff_traces(args[1], args[2], int(args[3]))
        return
    if args[:1] == ["--worker"]:
        mesh_routes = None if len(args) < 5 else {
            "eager": (False,), "both": (True, False)}[args[4]]
        _worker(args[1], args[2].split(","), mesh_routes)
        return
    mesh = None
    if args[:1] == ["--mesh"]:
        mesh, args = "both", args[1:]
        if args[:1] == ["--routes"]:
            mesh, args = args[1], args[2:]
            if mesh not in ("eager", "both"):
                raise SystemExit(f"--routes takes eager or both, got {mesh!r}")
    modes = list(MODES)
    if args[:1] == ["--modes"]:
        modes, args = args[1].split(","), args[2:]
        unknown = set(modes) - set(MODES)
        if unknown:
            raise SystemExit(f"unknown modes {sorted(unknown)}; choose among {list(MODES)}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for checkout in args or ["."]:
        subprocess.run([sys.executable, __file__, "--worker", checkout, ",".join(modes)]
                       + ([] if mesh is None else ["--mesh", mesh]), check=True)


if __name__ == "__main__":
    main()
