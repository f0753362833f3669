"""K3: fused silu·mul + dynamic per-row int8 activation quantization.

Port of unimedvl_tpu/ops/act_quant.py::silu_mul_quant. The full-int8 MLP
quantizes its down projection's input ``silu(gate) * up`` per token; done
plainly that is the product written to device memory in bf16, read back for
the row absmax and read again to quantize. The kernel (CUDA C++ for sm_90a,
``csrc/silu_mul_quant.cu``) reads gate and up once, keeps the fp32 product of
a row in registers, and writes the int8 row and one fp32 scale. It has two
launch shapes: up to ``CLUSTER_MAX_ROWS`` rows (a decode step, a few
streams) each row is spread over a cluster of ``CLUSTER_SIZE`` CTAs that
exchange their absmax through distributed shared memory; more rows go to
persistent CTAs, one per SM, that keep the next row in flight.

The definition, which the kernel and ``silu_mul_quant_ref`` share, is the JAX
kernel's: everything in fp32,

    x     = (g * sigmoid(g)) * u          sigmoid(g) = 1 / (1 + exp(-g))
    scale = max(absmax_row(x), 1e-8) / 127
    q     = clip(round_half_even(x / scale), -127, 127)

with a true division by ``scale``. The kernel takes ``x * (1 / scale)`` and
redoes the true division only where that product lies within 2^-12 of a
half-integer, which gives the same q (``quantize_fast_twin`` is that rule in
plain torch, held to the division in the CPU tests). The port always takes
this definition on a quantized down projection; it has no gate between this
and a bf16 product chain. On the card the kernel and the plain version can differ where
``expf`` and ``torch.sigmoid`` differ in the last place: scales within 1e-6
relative, q within one step on a small share of elements.

``silu_mul_quant`` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; there is no threshold and no fallback.

The second entry, :func:`silu_mul_quant_global`, is the same function for a
row whose I columns are sharded over tensor-parallel ranks (a row-parallel
down projection under ``mesh=``): the scale must be the whole row's, as the
JAX mesh program's all-reduce-max gives it. It is two launches of
``csrc/silu_mul_quant.cu`` around the caller's reduction: a scale pass
(each rank's row scale), the all-reduce-max, and a quantize pass that takes
the scales (``silu_mul_quant_global_ref`` is its plain version). Both passes
follow :func:`global_plan`, which depends on (R, I) and the card's SM count
alone, so every rank of a mesh launches the same and calls the reduction
once: up to ``GLOBAL_CLUSTER_MAX_ROWS`` rows each row is spread over a
cluster of CTAs; more rows go to persistent CTAs, one or two an SM, that keep a
ring of rows in flight, and the quantize pass walks each CTA's rows
backward, so that it starts on those the scale pass left in the L2.

Gradients. The kernel has no backward: its wrapper refuses inputs that
require grad while grad mode is on (``_launch.check_no_grad``).
``silu_mul_quant_autograd`` is the differentiable route (QLoRA over a
full-int8 base), with the gradient ``jax.grad`` gives the JAX definition: q
is integer and passes none; the scale's reaches g and u only at each row's
argmax of |x| (split equally over ties; none for a row whose absmax is under
1e-8), then dg = dx * u * silu'(g) and du = dx * silu(g), in torch
(:func:`silu_mul_quant_backward`).
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import torch

from unimedvl_tpu_torch.ops import _launch, cuda_build

# launches of the kernel and calls of the plain version, for showing which ran
counts = {"kernel": 0, "plain": 0}
# the same for the second entry (silu_mul_quant_global): one per call, whose kernel side is two
# launches (the scale pass and the quantize pass) around the caller's all-reduce
global_counts = {"kernel": 0, "plain": 0}

KERNEL_MAX_WIDTH = 1024 * 3 * 8  # 1024 threads x 3 chunks of 8 values in registers
# rows spread over a cluster of CTAs up to this many rows (a CTA per SM at most), and the
# cluster's size (2, 4, 8 or 16; 16 read fastest at R 1 and 3 on an H100, PERF.md); the
# card tests and tools/time_quant_kernels.py set them to reach either launch shape
CLUSTER_MAX_ROWS, CLUSTER_SIZE = 8, 16
NEAR_TIE = 0.5 - 2.0**-12  # |x / scale - its rint| from which the kernel redoes the division
ROUND_ADD = 1.5 * 2.0**23  # p + this - this is rint(p) in fp32 for |p| < 2^22
# the second entry's plan (global_plan): up to GLOBAL_CLUSTER_MAX_ROWS rows each row over a cluster
# of the fewest CTAs (2, 4, 8, 16) that give each at most GLOBAL_CLUSTER_CHUNKS 16-byte chunks,
# halved down to 2 while the route's CTAs are more than GLOBAL_CLUSTER_CTAS; more rows on
# persistent CTAs, each a producer warp and consumer warps around a ring of up to RING_STAGES rows
# of g and u: one an SM of 31 consumer warps with RING_BYTES of shared memory or, where half of it
# still holds RING_PAIR_STAGES rows, two of 15 with half each. Chosen by the sweeps of
# tools/time_quant_kernels.py --global on an H100 (PERF.md §6)
GLOBAL_CLUSTER_MAX_ROWS, GLOBAL_CLUSTER_CHUNKS, GLOBAL_CLUSTER_CTAS = 128, 160, 128
RING_STAGES, RING_BYTES, RING_PAIR_STAGES = 8, 8 * KERNEL_MAX_WIDTH, 4


def silu_mul_quant_ref(g: torch.Tensor, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`silu_mul_quant` on whatever device the inputs
    are on: (q int8 [..., I], scale fp32 [..., 1])."""
    counts["plain"] += 1
    g32, u32 = g.float(), u.float()
    x = (g32 * torch.sigmoid(g32)) * u32
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(absmax, 1e-8) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_fast_twin(x: torch.Tensor, scale: torch.Tensor, fadd: bool = False) -> torch.Tensor:
    """The kernel's rule for ``clip(round_half_even(x / scale), -127, 127)``
    in plain torch, fp32: ``x * (1 / scale)`` rounded, with the true division
    redone where that product lies within 2^-12 of a half-integer. Equal to
    the division bit for bit wherever ``|x / scale| < 128`` (x at most the
    row's absmax); used by nothing on the main path. ``fadd``: as the second
    entry's passes round (``quant8_chunk``): the product rounded by adding and
    subtracting 1.5 * 2^23, and the value read back as the low byte of the
    clipped value plus 1.5 * 2^23."""
    x, scale = x.float(), scale.float()
    p = x * (1.0 / scale)
    r = (p + ROUND_ADD) - ROUND_ADD if fadd else torch.round(p)
    r = torch.where((p - r).abs() >= NEAR_TIE, torch.round(x / scale), r)
    r = torch.clamp(r, -127, 127)
    if fadd:
        byte = ((r + ROUND_ADD).view(torch.int32) & 0xFF).to(torch.uint8).view(torch.int8)
        r = byte.float()
    return r


def _launch_kernel(g, u):
    _launch.check_no_grad("silu_mul_quant", ("g", "u"), (g, u),
                          "ops.act_quant.silu_mul_quant_autograd")
    I = g.shape[-1]
    R = g.numel() // I
    if I % 8 or I > KERNEL_MAX_WIDTH or R < 1:
        raise ValueError(
            f"the silu_mul_quant kernel takes rows of a multiple of 8 up to "
            f"{KERNEL_MAX_WIDTH} values, got {R} rows of {I}"
        )
    if g.dim() < 2:
        raise ValueError(f"g and u must be [..., I] with at least one leading dim, got {tuple(g.shape)}")
    _launch.check_cuda(("g", "u"), (g, u), torch.bfloat16)
    # rows may be strided (the halves of a fused gate_up output): one row
    # stride for all leading dims, a multiple of 8 elements
    g2, u2 = _rows(g, "g"), _rows(u, "u")
    q = torch.empty(g.shape, dtype=torch.int8, device=g.device)
    scale = torch.empty(*g.shape[:-1], 1, dtype=torch.float32, device=g.device)
    cluster = CLUSTER_SIZE if R <= CLUSTER_MAX_ROWS else 0  # 0: the many-row path
    if cluster not in (0, 2, 4, 8, 16):
        raise ValueError(f"CLUSTER_SIZE must be 2, 4, 8 or 16, got {CLUSTER_SIZE}")
    lib = cuda_build.load_library()
    with torch.cuda.device(g.device):
        rc = lib.unimedvl_silu_mul_quant(
            g2.data_ptr(), u2.data_ptr(), q.data_ptr(), scale.data_ptr(),
            R, I, g2.stride(0), u2.stride(0), cluster,
            torch.cuda.current_stream(g.device).cuda_stream,
        )
    cuda_build.check(rc, "silu_mul_quant")
    counts["kernel"] += 1
    return q, scale


def _rows(t: torch.Tensor, name: str) -> torch.Tensor:
    """t [..., I] as a [R, I] view with one row stride (no copy), or raise."""
    I = t.shape[-1]
    try:
        t2 = t.view(-1, I)
    except RuntimeError:
        raise ValueError(
            f"{name} {tuple(t.shape)} with strides {t.stride()} has no single row stride"
        ) from None
    if t2.stride(0) % 8:
        raise ValueError(f"{name}'s row stride {t2.stride(0)} is not a multiple of 8 elements")
    return t2


def silu_mul_quant(g: torch.Tensor, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``quantize_activations(silu(g) * u)`` in one pass, by the module's
    definition. g, u: [..., I] of one shape. Returns (q int8 [..., I], scale
    fp32 [..., 1]), the input of ``quant.quantized_linear_preq``; no rows give
    empty outputs and launch nothing. CUDA tensors go through the kernel
    (bf16, rows 16-byte aligned; anything else raises), CPU tensors through
    :func:`silu_mul_quant_ref`."""
    if g.shape != u.shape:
        raise ValueError(f"g and u must have one shape, got {tuple(g.shape)} and {tuple(u.shape)}")
    if g.numel() == 0:  # no rows (an expert the sequence routes nothing to): no launch
        return (torch.empty(g.shape, dtype=torch.int8, device=g.device),
                torch.empty(*g.shape[:-1], 1, dtype=torch.float32, device=g.device))
    if g.device.type == "cuda":
        return _launch_kernel(g, u)
    if g.device.type == "cpu":
        return silu_mul_quant_ref(g, u)
    raise ValueError(f"silu_mul_quant runs on CUDA or CPU tensors, got {g.device}")


def silu_mul_quant_global_ref(g: torch.Tensor, u: torch.Tensor, reduce_max=None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`silu_mul_quant_global`: the row scales of
    :func:`silu_mul_quant_ref`, reduced by ``reduce_max`` (in place; None:
    as they are), then q by those scales."""
    global_counts["plain"] += 1
    g32, u32 = g.float(), u.float()
    x = (g32 * torch.sigmoid(g32)) * u32
    scale = torch.clamp_min(x.abs().amax(dim=-1, keepdim=True), 1e-8) / 127.0
    if reduce_max is not None:
        reduce_max(scale)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


class GlobalPlan(NamedTuple):
    """How both passes of :func:`silu_mul_quant_global` launch."""

    cluster: int  # CTAs a row is spread over (2, 4, 8, 16), or 0: the ring route
    ctas: int  # CTAs a pass launches
    stages: int  # rows a ring CTA holds in shared memory, or 0
    per_sm: int = 1  # ring CTAs an SM


@functools.lru_cache(maxsize=256)  # the wrapper's host time: a decode loop asks for one plan
def global_plan(R: int, I: int, sms: int) -> GlobalPlan:
    """The second entry's launch plan for R rows of I values on a card of
    ``sms`` SMs: from these alone, never from the data, so that every rank of
    a mesh makes the same launches and collectives. Raises for an I the
    kernels do not take."""
    if I <= 0 or I % 8 or I > KERNEL_MAX_WIDTH:
        raise ValueError(f"the silu_mul_quant_global kernels take rows of a multiple of 8 up to "
                         f"KERNEL_MAX_WIDTH = {KERNEL_MAX_WIDTH} values, got {I}")
    n_vec = I // 8
    if R <= GLOBAL_CLUSTER_MAX_ROWS:
        C = next((c for c in (2, 4, 8, 16) if -(-n_vec // c) <= GLOBAL_CLUSTER_CHUNKS), 16)
        while C > 2 and C * R > GLOBAL_CLUSTER_CTAS:
            C //= 2
        return GlobalPlan(C, C * R, 0)
    per_sm = 2 if RING_BYTES // 2 // (4 * I) >= RING_PAIR_STAGES else 1
    stages = min(RING_STAGES, RING_BYTES // per_sm // (4 * I))
    return GlobalPlan(0, min(R, per_sm * sms), stages, per_sm)


def global_rows(plan: GlobalPlan, R: int, quantize: bool) -> List[List[int]]:
    """The rows that each worker of a pass takes, in its order, as the
    kernels walk them: a cluster (or the quantize pass's C CTAs) per row, or a
    ring CTA b its rows b, b + ctas, ... in the scale pass and the same rows
    backward in the quantize pass, which so starts on those it read last."""
    if plan.cluster:
        return [[r] for r in range(R)]
    walks = [list(range(b, R, plan.ctas)) for b in range(plan.ctas)]
    return [walk[::-1] for walk in walks] if quantize else walks


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_PASSES = ("silu_mul_quant_global (scale pass)", "silu_mul_quant_global (quantize pass)")


def _global_args(g2, u2, scale, q, plan: GlobalPlan, stream: int) -> tuple:
    """The launch arguments of both passes on [R, I] row views g2, u2."""
    R, I = g2.shape
    return (g2.data_ptr(), u2.data_ptr(), q.data_ptr(), scale.data_ptr(), R, I, g2.stride(0),
            u2.stride(0), plan.cluster, plan.per_sm, plan.ctas, plan.stages, stream)


def _global_pass(quantize: int, args: tuple) -> None:
    """One pass of the second entry: the row scales (0), or q by them (1)."""
    rc = cuda_build.load_library().unimedvl_silu_mul_global_pass(quantize, *args)
    cuda_build.check(rc, _PASSES[quantize])


def _launch_global(g, u, reduce_max):
    _launch.check_no_grad("silu_mul_quant_global", ("g", "u"), (g, u),
                          "ops.act_quant.silu_mul_quant_autograd (one rank)")
    I = g.shape[-1]
    R = g.numel() // I
    if g.dim() < 2:
        raise ValueError(f"g and u must be [..., I] with at least one leading dim, "
                         f"got {tuple(g.shape)}")
    _launch.check_cuda(("g", "u"), (g, u), torch.bfloat16)
    plan = global_plan(R, I, _sm_count(g.device.index))
    g2, u2 = _rows(g, "g"), _rows(u, "u")
    q = torch.empty(g.shape, dtype=torch.int8, device=g.device)
    scale = torch.empty(*g.shape[:-1], 1, dtype=torch.float32, device=g.device)
    with _launch.on_device(g.device.index):
        args = _global_args(g2, u2, scale, q, plan, torch.cuda.current_stream(g.device).cuda_stream)
        _global_pass(0, args)
        if reduce_max is not None:
            reduce_max(scale)
        _global_pass(1, args)
    global_counts["kernel"] += 1
    return q, scale


def silu_mul_quant_global(g: torch.Tensor, u: torch.Tensor, reduce_max
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`silu_mul_quant` with the row scales reduced over ranks before
    the quantization: ``reduce_max(scale)`` (in place, e.g. an all-reduce-max
    over "model") between a scale pass and a quantize pass. Returns (q int8
    [..., I], scale fp32 [..., 1]), the whole row's scale. CUDA tensors go
    through the kernels (bf16, any I a multiple of 8), CPU tensors through
    :func:`silu_mul_quant_global_ref`."""
    if g.shape != u.shape:
        raise ValueError(f"g and u must have one shape, got {tuple(g.shape)} and {tuple(u.shape)}")
    if g.numel() == 0:
        # no rows: the reduction still runs, so every rank joins the same collectives
        scale = torch.empty(*g.shape[:-1], 1, dtype=torch.float32, device=g.device)
        if reduce_max is not None:
            reduce_max(scale)
        return torch.empty(g.shape, dtype=torch.int8, device=g.device), scale
    if g.device.type == "cuda":
        return _launch_global(g, u, reduce_max)
    if g.device.type == "cpu":
        return silu_mul_quant_global_ref(g, u, reduce_max)
    raise ValueError(f"silu_mul_quant_global runs on CUDA or CPU tensors, got {g.device}")


# ---------------------------------------------------------------------------
# the differentiable route
# ---------------------------------------------------------------------------

def silu_mul_quant_backward(g: torch.Tensor, u: torch.Tensor, d_scale: torch.Tensor):
    """(dg, du) in g's and u's dtypes from the scale's cotangent ``d_scale``
    [..., 1]: x = silu(g) * u in fp32 as the forward defines it; d absmax =
    d_scale / 127 where absmax >= 1e-8 (the clamp's branch), 0 elsewhere;
    shared equally by the entries of a row where |x| equals its absmax, with
    sign(x); then through the product and silu."""
    g32, u32 = g.float(), u.float()
    sig = torch.sigmoid(g32)
    silu_g = g32 * sig
    x = silu_g * u32
    ax = x.abs()
    absmax = ax.amax(dim=-1, keepdim=True)
    tie = ax == absmax
    d_absmax = torch.where(absmax >= 1e-8, d_scale.float() / 127.0, torch.zeros_like(absmax))
    dx = torch.where(tie, torch.sign(x) * (d_absmax / tie.sum(dim=-1, keepdim=True)),
                     torch.zeros_like(x))
    dg = dx * u32 * (sig * (1.0 + g32 * (1.0 - sig)))
    du = dx * silu_g
    return dg.to(g.dtype), du.to(u.dtype)


class SiluMulQuant(torch.autograd.Function):
    """:func:`silu_mul_quant` under autograd: the forward is the kernel on
    CUDA tensors and the plain version on CPU tensors; the backward is
    :func:`silu_mul_quant_backward`. q is marked non-differentiable."""

    @staticmethod
    def forward(ctx, g, u):
        q, scale = silu_mul_quant(g, u)
        ctx.save_for_backward(g, u)
        ctx.mark_non_differentiable(q)
        return q, scale

    @staticmethod
    def backward(ctx, dq, d_scale):
        g, u = ctx.saved_tensors
        if d_scale is None:
            return None, None
        return silu_mul_quant_backward(g, u, d_scale)


def silu_mul_quant_autograd(g: torch.Tensor, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`silu_mul_quant` where a gradient may be wanted, through
    :class:`SiluMulQuant` (which builds no graph under no_grad or for inputs
    that need no gradient)."""
    return SiluMulQuant.apply(g, u)
