"""Quantized serving modes of the LLM (port of unimedvl_tpu/quant.py): int8 and
packed-int4 weights with fp32 scales, dynamic per-token int8 activations, and
the serving transforms of the module tree.

These are non-parity modes (the reference runs bf16); the default model stays
bf16. The modes, by the name the JAX leaf carries:

- ``q``   (``kernel_q``): int8 weights, bf16 x; the weights widen per call.
- ``qa``  (``kernel_qa``): int8 weights, x quantized per token: s8 x s8 -> s32.
- ``p4``  (``kernel_p4``): packed-int4 weights, bf16 x (K4's bf16 branch).
- ``p4a`` (``kernel_p4a``): packed-int4 weights, int8 x (w4a8, K4).

Weights are [out, in] as ``nn.Linear`` keeps them, so the per-output-channel
scale reduces over the last dim and int4 packs along it
(ops/w4_matmul.py). A quantized leaf is a
:class:`~unimedvl_tpu_torch.models.layers.QuantLinear`; the functions here take
it as ``p`` and read ``p.mode``, ``p.weight_q``, ``p.scale``, ``p.bias``.

Apply to a loaded model with::

    quantize_llm_params(model.language_model, act_quant=True)   # in place
    fuse_serving_projections(model.language_model)              # in place

Quantization runs on the weight's device, one weight at a time, and each bf16
weight is released as soon as its quantized form exists.

Gradients (QLoRA). Every mode passes a gradient to x, as ``jax.grad`` of the
JAX package's ``_linear`` does on the CPU. ``q`` and ``p4``: through the
widened weight (:class:`WidenedMatmul`; K4's backward,
``ops.w4_matmul.W4Matmul``). ``qa`` and ``p4a``: only through the
activation scale ``max(|x|) / 127``, at each row's absmax entry (torch's
autograd of :func:`quantize_activations`; K4 with int8 x and K3 pass it on).
The weights are buffers and take none.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.distributed as dist
from torch import nn

from unimedvl_tpu_torch.ops.w4_matmul import pack_int4, unpack_int4, w4_matmul_autograd

# projections quantized inside each decoder layer (biases and norms stay as they are)
QUANT_KEYS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
EXPERTS = ("", "_moe_gen")
INT_MM_MIN_ROWS = 17  # torch._int_mm takes more than 16 rows


def quantize_weight(weight: torch.Tensor, bits: int = 8, group_size: int = 0,
                    reduce_max=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel intN quantization of a [.., out, in]
    weight: ``scale = max(absmax, 1e-8) / qmax`` over the in dim, ``q =
    clip(round_half_even(w / scale), -qmax, qmax)``, in fp32.

    ``bits=8``: (int8 [.., out, in], fp32 scale [.., out]). ``bits=4``: the
    values packed two to a byte along the in dim, (int8 [.., out, in/2],
    scale). ``group_size`` (bits=4 only): one scale for each block of
    ``group_size`` in-rows of an output channel; scale [.., in/group, out].

    ``reduce_max``: for an in dim sharded over ranks (a row-parallel shard),
    reduces the per-channel absmax to the whole row's in place, so that every
    rank quantizes its columns with the scale of the whole weight (group
    scales need none: a rank holds whole groups)."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if group_size and bits != 4:
        raise ValueError("group_size is a w4 feature")
    if group_size and weight.shape[-1] % group_size:
        raise ValueError(f"in dim {weight.shape[-1]} is not a multiple of group_size {group_size}")
    qmax = 127.0 if bits == 8 else 7.0
    w32 = weight.float()
    if group_size:
        wg = w32.reshape(*w32.shape[:-1], w32.shape[-1] // group_size, group_size)
        absmax = wg.abs().amax(dim=-1, keepdim=True)
        scale = torch.clamp_min(absmax, 1e-8) / qmax  # [.., out, G, 1]
        q = torch.clamp(torch.round(wg / scale), -qmax, qmax).to(torch.int8).reshape(w32.shape)
        scale = scale.squeeze(-1).transpose(-1, -2).contiguous()  # [.., G, out]
    else:
        absmax = w32.abs().amax(dim=-1, keepdim=True)
        if reduce_max is not None:
            reduce_max(absmax)
        scale = torch.clamp_min(absmax, 1e-8) / qmax
        q = torch.clamp(torch.round(w32 / scale), -qmax, qmax).to(torch.int8)
        scale = scale.squeeze(-1)
    if bits == 4:
        q = pack_int4(q)
    return q, scale


def dequantize_weight(p, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The [out, in] weight a quantized leaf stands for, in ``dtype``."""
    q = unpack_int4(p.weight_q) if p.packed else p.weight_q
    scale = p.scale
    if scale.dim() == q.dim():  # group-wise [.., G, out]
        g = q.shape[-1] // scale.shape[-2]
        scale = scale.transpose(-1, -2).repeat_interleave(g, dim=-1)  # [.., out, in]
        return (q.float() * scale).to(dtype)
    return (q.float() * scale[..., :, None]).to(dtype)


def mm_f32(x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x2 [m, K] @ w [N, K]^T with fp32 accumulation and fp32 output; w is in
    x2's dtype. On the card a bf16 product keeps its fp32 sums
    (``out_dtype``); on the CPU the operands widen."""
    if x2.dtype == torch.float32:
        return x2 @ w.t()
    if x2.is_cuda:
        return torch.mm(x2, w.t(), out_dtype=torch.float32)
    return x2.float() @ w.float().t()


def int_mm(xq2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """xq2 [m, K] int8 @ w [N, K]^T int8 -> int32 [m, N], exactly. On the card
    ``torch._int_mm`` (cuBLASLt; the JAX package left this product to XLA's
    dot too), whose rows are padded up to 17 for it; on the CPU an int32
    matmul."""
    if not xq2.is_cuda:
        return xq2.to(torch.int32) @ w.to(torch.int32).t()
    m = xq2.shape[0]
    if m < INT_MM_MIN_ROWS:
        pad = torch.zeros(INT_MM_MIN_ROWS, xq2.shape[1], dtype=torch.int8, device=xq2.device)
        pad[:m] = xq2
        return torch._int_mm(pad, w.t())[:m]
    return torch._int_mm(xq2, w.t())


class WidenedMatmul(torch.autograd.Function):
    """``(x2 @ weight_q^T) * scale`` with the int8 weight widened to x2's
    dtype, fp32 sums and an fp32 result [m, N] (:func:`mm_f32`), under
    autograd: the backward widens the weight again, where saving the widened
    copy would hold a bf16 weight per projection until the backward, and
    gives dx = (dy * scale) rounded to x2's dtype @ W. The weight and scale
    take no gradient."""

    @staticmethod
    def forward(ctx, x2, weight_q, scale):
        ctx.save_for_backward(weight_q, scale)
        ctx.x_dtype = x2.dtype
        return mm_f32(x2, weight_q.to(x2.dtype)) * scale

    @staticmethod
    def backward(ctx, dy):
        weight_q, scale = ctx.saved_tensors
        dtype = ctx.x_dtype
        dx = (dy * scale).to(dtype) @ weight_q.to(dtype) if ctx.needs_input_grad[0] else None
        return dx, None, None


def widened_matmul(x2: torch.Tensor, weight_q: torch.Tensor, scale: torch.Tensor
                   ) -> torch.Tensor:
    """``(x2 @ weight_q^T) * scale``, fp32 [m, N], through
    :class:`WidenedMatmul` (which builds no graph under no_grad or for an x2
    that needs no gradient)."""
    return WidenedMatmul.apply(x2, weight_q, scale)


def quantized_linear(x: torch.Tensor, p) -> torch.Tensor:
    """Weight-only modes: ``y = (x @ W_q^T) * scale (+ bias)`` in x's dtype.
    ``q``: the int8 weights widen to x's dtype (a real write and read of the
    widened copy per call), the sums are fp32. ``p4``: K4 on bf16 x. Both
    are differentiable in x."""
    if p.packed:
        y = w4_matmul_autograd(x, None, p.weight_q, p.scale, out_dtype=x.dtype)
    else:
        x2 = x.reshape(-1, x.shape[-1])
        y = widened_matmul(x2, p.weight_q, p.scale)
        y = y.to(x.dtype).reshape(*x.shape[:-1], y.shape[-1])
    if p.bias is not None:
        y = y + p.bias.to(x.dtype)
    return y


def quantize_activations(x: torch.Tensor, reduce_max=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-token int8: (x_q int8, x_scale fp32 [..., 1]),
    absmax over the feature dim. ``reduce_max``: for a feature dim sharded
    over ranks, reduces the partial absmax to the whole row's, in place."""
    x32 = x.float()
    absmax = x32.abs().amax(dim=-1, keepdim=True)
    if reduce_max is not None:
        reduce_max(absmax)
    scale = torch.clamp_min(absmax, 1e-8) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def quantized_linear_act(x: torch.Tensor, p) -> torch.Tensor:
    """Full-int8 (``qa``) and w4a8 (``p4a``) matmul: x is quantized per token,
    the product is integer, and ``x_scale`` and the weight scale rescale it in
    fp32."""
    xq, xs = quantize_activations(x, getattr(p, "reduce_max", None))
    return quantized_linear_preq(xq, xs, p, x.dtype)


def quantized_linear_preq(xq: torch.Tensor, xs: torch.Tensor, p,
                          out_dtype: torch.dtype) -> torch.Tensor:
    """:func:`quantized_linear_act` with the activations quantized already:
    (xq int8, xs fp32 [..., 1]) from :func:`quantize_activations` or from
    K3 (ops/act_quant.py)."""
    if p.packed:  # w4a8: the nibbles unpack in registers (K4)
        y = w4_matmul_autograd(xq, xs, p.weight_q, p.scale, out_dtype=out_dtype)
    else:
        acc = int_mm(xq.reshape(-1, xq.shape[-1]), p.weight_q)
        y = acc.reshape(*xq.shape[:-1], acc.shape[-1]).float() * (xs * p.scale)
        y = y.to(out_dtype)
    if p.bias is not None:
        y = y + p.bias.to(out_dtype)
    return y


def quantized_forward(x: torch.Tensor, p) -> torch.Tensor:
    """A quantized leaf's forward by its mode, as the JAX ``_linear``
    dispatches: modes ending in ``a`` quantize x and multiply in integers."""
    if p.act_quant:
        return quantized_linear_act(x, p)
    return quantized_linear(x, p)


# ---------------------------------------------------------------------------
# transforms of the module tree
# ---------------------------------------------------------------------------

def mode_name(bits: int, act_quant: bool) -> str:
    """The mode of a leaf quantized to ``bits``: ``q``/``p4``, with ``a`` for
    integer matmuls."""
    return ("p4" if bits == 4 else "q") + ("a" if act_quant else "")


@torch.no_grad()
def _quantize_module(lin: nn.Module, bits: int, act_quant: bool, group_size: int,
                     reduce_max=None):
    """A quantized leaf for a bf16 ``nn.Linear``, or for a ``LoRALinear`` over
    one: its adapter rides along on the quantized base (the same parameters),
    as the JAX package carries ``lora_a`` / ``lora_b`` / ``lora_s`` across.
    ``reduce_max``: the leaf is a row-parallel shard (see
    :func:`quantize_weight`); an act-quant leaf keeps it for its
    activations' scales."""
    from unimedvl_tpu_torch.models.layers import LoRALinear, QuantLinear  # layers imports this

    q, scale = quantize_weight(lin.weight, bits, group_size, reduce_max)
    base = QuantLinear(mode_name(bits, act_quant), q, scale, lin.bias)
    if act_quant:
        base.reduce_max = reduce_max
    if isinstance(lin, LoRALinear):
        return LoRALinear(base, lin.lora_a, lin.lora_b, float(lin.lora_s))
    return base


@torch.no_grad()
def quantize_llm_params(lm, act_quant: bool = False, bits: int = 8, group_size: int = 0):
    """Quantize, in place, every attention and MLP projection of both experts
    in each decoder layer and the lm_head of a ``Qwen2MoTForCausalLM``;
    returns it. Embedding, norms and biases stay as they are. Each bf16
    weight is dropped as its quantized form replaces it.

    ``act_quant=True`` marks the leaves for integer matmuls (``qa`` /
    ``p4a``): the same stored bytes, another forward. ``bits=4`` packs int4
    (``group_size``: group-wise scales); the lm_head stays int8 even then:
    the logits are the step's accuracy-critical tail. A projection that
    carries a LoRA adapter becomes an adapted quantized projection (QLoRA).

    A rank's shard of a mesh (``parallel.mesh.place_params``) quantizes its
    shard: the row-parallel projections with the whole row's per-channel
    absmax (an all-reduce-max over "model"), so every rank holds its part of
    the whole model's quantized weights."""
    from unimedvl_tpu_torch.inference import programs
    from unimedvl_tpu_torch.models.layers import LoRALinear

    programs.drop_reading(lm)  # the device programs that read the weights it replaces

    mesh = getattr(lm, "mesh", None)
    row_reduce = None
    if mesh is not None and mesh.shape.get("model", 1) > 1:
        row_reduce = functools.partial(mesh.all_reduce, axis="model", op=dist.ReduceOp.MAX)
    for layer in lm.model.layers:
        for parent in (layer.self_attn, layer.mlp, getattr(layer, "mlp_moe_gen", None)):
            if parent is None:
                continue
            for key in QUANT_KEYS:
                for sfx in EXPERTS:
                    lin = getattr(parent, key + sfx, None)
                    if isinstance(lin, nn.Linear) or (isinstance(lin, LoRALinear)
                                                      and lin.mode is None):
                        reduce = row_reduce if key in ("o_proj", "down_proj") else None
                        setattr(parent, key + sfx,
                                _quantize_module(lin, bits, act_quant, group_size, reduce))
    lm.lm_head = _quantize_module(lm.lm_head, 8, act_quant, 0)
    return lm


def fused_key(module: nn.Module, base: str):
    """The fused leaf ``base`` (``qkv_proj``, ``gate_up_proj``) of a module, or
    its shard-interleaved variant ``{base}_tp{N}``
    (``fuse_serving_projections(tp=N)``): (name, N), or (None, 1). The gen
    expert's twin is ``name + "_moe_gen"``."""
    if base in module._modules:
        return base, 1
    pre = base + "_tp"
    for name in module._modules:
        if name.startswith(pre) and not name.endswith("_moe_gen"):
            return name, int(name[len(pre):])
    return None, 1


def deinterleave(y: torch.Tensor, tp: int, widths):
    """The plain parts of a shard-interleaved fused output [..., sum(widths)]:
    block s of the last dim holds every part's s-th column shard in order, so
    a reshape, a slice per part and a flatten give each part's original
    column order. With ``tp == 1`` a plain split."""
    if tp == 1:
        return y.split(list(widths), dim=-1)
    r = y.unflatten(-1, (tp, y.shape[-1] // tp))
    parts, off = [], 0
    for w in widths:
        parts.append(r[..., off:off + w // tp].reshape(*y.shape[:-1], w))
        off += w // tp
    return parts


def _cat(tensors, tp: int, dim: int) -> torch.Tensor:
    """Join along the output dim ``dim``. With ``tp > 1`` the result is ``tp``
    contiguous shard blocks, each the join of every part's s-th shard
    (``[q_0|k_0|v_0|q_1|k_1|v_1|...]``): an even split over ``tp`` ranks hands
    rank s its Megatron column shard of every part."""
    if tp == 1:
        return torch.cat(list(tensors), dim=dim)
    dim = dim % tensors[0].dim()
    blocks = []
    for t in tensors:
        if t.shape[dim] % tp:
            raise ValueError(f"output dim {t.shape[dim]} does not split over tp={tp}")
        blocks.append(t.unflatten(dim, (tp, t.shape[dim] // tp)))
    return torch.cat(blocks, dim=dim + 1).flatten(dim, dim + 1)


def _concat_linears(parts, tp: int = 1):
    """Linear leaves joined along the output dim: bf16 ``nn.Linear``s or
    quantized leaves of one mode. A part without a bias contributes zeros.
    ``tp``: the shard-interleaved block layout of :func:`_cat`."""
    from unimedvl_tpu_torch.models.layers import QuantLinear, linear_from_tensors

    first = parts[0]
    if any(hasattr(p, "lora_a") for p in parts):
        raise ValueError("cannot fuse projections that carry LoRA adapters: "
                         "training.lora.merge_lora first")
    biases = None
    if any(p.bias is not None for p in parts):
        ref = next(p.bias for p in parts if p.bias is not None)
        biases = _cat([
            p.bias if p.bias is not None
            else torch.zeros(p.out_features, dtype=ref.dtype, device=ref.device)
            for p in parts
        ], tp, 0)
    if isinstance(first, QuantLinear):
        if any(not isinstance(p, QuantLinear) or p.mode != first.mode for p in parts):
            raise ValueError("cannot fuse projections of different quantized modes")
        weight_q = _cat([p.weight_q for p in parts], tp, 0)
        scale = _cat([p.scale for p in parts], tp, -1)
        return QuantLinear(first.mode, weight_q, scale, biases)
    return linear_from_tensors(_cat([p.weight for p in parts], tp, 0), biases)


@torch.no_grad()
def fuse_serving_projections(lm, tp: int = 1):
    """Serving transform, in place: fuse q/k/v of each expert into one
    ``qkv_proj`` (``qkv_proj_moe_gen``) and the MLPs' gate/up into one
    ``gate_up_proj``: three matmuls fewer per layer and expert, which is
    fixed cost on a decode step. The attention and MLP modules use the fused
    leaves when they are there. Composes with quantization (apply after
    :func:`quantize_llm_params`). Works on meta tensors too, which is how the
    loader shapes a model for an already fused tree.

    ``tp > 1`` lays the fused output dim out as ``tp`` contiguous shard blocks
    (each ``[q_s|k_s|v_s]`` / ``[gate_s|up_s]``) and names the leaves
    ``qkv_proj_tp{N}``, ``qkv_proj_tp{N}_moe_gen``, ``gate_up_proj_tp{N}`` (the
    JAX package's ``qkv_tp{N}``, ``qkv_gen_tp{N}``, ``gate_up_tp{N}``). An even
    split of the fused dim then gives every "model" rank its column shard
    (parallel/sp_denoise.py splits it by local widths), and the single-device
    forward recovers the plain q/k/v and gate/up with :func:`deinterleave`, so
    one such tree serves prefill, decode and the manual-TP denoise. ``tp``
    must equal the mesh's "model" axis."""
    from unimedvl_tpu_torch.inference import programs

    programs.drop_reading(lm)  # the device programs that read the weights it replaces
    tag = f"_tp{tp}" if tp > 1 else ""
    for layer in lm.model.layers:
        attn = layer.self_attn
        for sfx in EXPERTS:
            if hasattr(attn, "q_proj" + sfx):
                names = [n + sfx for n in ("q_proj", "k_proj", "v_proj")]
                setattr(attn, "qkv_proj" + tag + sfx,
                        _concat_linears([getattr(attn, n) for n in names], tp))
                for n in names:
                    delattr(attn, n)
        for mlp in (layer.mlp, getattr(layer, "mlp_moe_gen", None)):
            if mlp is not None and hasattr(mlp, "gate_proj"):
                setattr(mlp, "gate_up_proj" + tag,
                        _concat_linears([mlp.gate_proj, mlp.up_proj], tp))
                del mlp.gate_proj, mlp.up_proj
    return lm
