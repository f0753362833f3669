"""Parameter-holding building blocks shared by the SigLIP and MoT modules.

Parameters are created with ``torch.empty`` on the given device and dtype:
weights come from a checkpoint, from the JAX tree (weights/loader.py) or from
``models.bagel.init_random_``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from unimedvl_tpu_torch import quant
from unimedvl_tpu_torch.ops.norms import layer_norm, rms_norm


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, device=device, dtype=dtype))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(dim, device=device, dtype=dtype))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class PosEmbed(nn.Module):
    """A frozen [N, C] position table under the released name ``pos_embed``."""

    def __init__(self, n: int, dim: int, device=None, dtype=None):
        super().__init__()
        self.pos_embed = nn.Parameter(
            torch.empty(n, dim, device=device, dtype=dtype), requires_grad=False
        )


def linear(cin: int, cout: int, bias: bool, device=None, dtype=None) -> nn.Linear:
    """An nn.Linear whose weights are left for the loader or init to fill."""
    lin = nn.Linear(cin, cout, bias=bias, device="meta", dtype=dtype)
    return lin.to_empty(device=device if device is not None else "cpu")


def linear_from_tensors(weight: torch.Tensor, bias=None) -> nn.Linear:
    """An nn.Linear around an existing [out, in] weight (and bias), frozen."""
    lin = nn.Linear(weight.shape[1], weight.shape[0], bias=bias is not None, device="meta")
    lin.weight = nn.Parameter(weight, requires_grad=False)
    if bias is not None:
        lin.bias = nn.Parameter(bias, requires_grad=False)
    return lin


class LoRALinear(nn.Module):
    """A linear with a low-rank adapter (the ``lora_a`` branch of the JAX
    package's ``_linear``): ``y = base(x) + ((x A^T) B^T) * s``.

    The base is a bf16 or fp32 ``nn.Linear`` (``weight`` [out, in], shared,
    not copied) or a :class:`QuantLinear` (QLoRA: its ``weight_q`` and
    ``scale`` stay buffers under the same names, ``mode`` says how it
    multiplies); its ``bias`` is the base's own frozen parameter. ``lora_a``
    [r, in] and ``lora_b`` [out, r] are the adapter (the JAX leaves [in, r]
    and [r, out], transposed to this package's [out, in] convention); a
    packed int4 base has ``in = 2 * weight_q.shape[1]``, as JAX's
    ``_kernel_shape`` widens it. ``lora_s`` (alpha / rank) is a buffer: it
    takes no gradient and no optimizer update. Every path that calls the
    module sees the adapter: the training forward and unfused inference. An
    adapted module is not a ``QuantLinear``: the MLP takes K3 only for a down
    projection without an adapter, as the JAX package does."""

    def __init__(self, base: nn.Module, lora_a: torch.Tensor, lora_b: torch.Tensor,
                 lora_s: float):
        super().__init__()
        if isinstance(base, QuantLinear):
            self.mode = base.mode
            out_f, in_f = base.out_features, base.in_features
            self.register_buffer("weight_q", base.weight_q)
            self.register_buffer("scale", base.scale)
        elif isinstance(base, nn.Linear):
            self.mode = None
            out_f, in_f = base.weight.shape
            self.weight = base.weight
        else:
            raise TypeError(f"LoRA adapts an nn.Linear or a QuantLinear, got {type(base).__name__}")
        if lora_a.shape[1] != in_f or lora_b.shape != (out_f, lora_a.shape[0]):
            raise ValueError(
                f"adapter shapes {tuple(lora_a.shape)}, {tuple(lora_b.shape)} do not fit a "
                f"[{out_f}, {in_f}] weight")
        self.in_features, self.out_features = in_f, out_f
        self.bias = base.bias
        self.lora_a = lora_a if isinstance(lora_a, nn.Parameter) else nn.Parameter(lora_a)
        self.lora_b = lora_b if isinstance(lora_b, nn.Parameter) else nn.Parameter(lora_b)
        self.register_buffer("lora_s", torch.tensor(float(lora_s), dtype=torch.float32,
                                                    device=lora_a.device))

    @property
    def rank(self) -> int:
        return self.lora_a.shape[0]

    @property
    def packed(self) -> bool:
        return self.mode is not None and self.mode.startswith("p4")

    @property
    def act_quant(self) -> bool:
        return self.mode is not None and self.mode.endswith("a")

    def extra_repr(self) -> str:
        base = "" if self.mode is None else f"mode={self.mode}, "
        return f"{base}in={self.in_features}, out={self.out_features}, rank={self.rank}"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode is None:
            y = F.linear(x, self.weight, self.bias)
        else:
            y = quant.quantized_forward(x, self)
        low = F.linear(F.linear(x, self.lora_a.to(x.dtype)), self.lora_b.to(x.dtype))
        return y + low * self.lora_s.to(y.dtype)


QUANT_MODES = ("q", "qa", "p4", "p4a")


class QuantLinear(nn.Module):
    """A quantized linear beside :func:`linear`: the weight as an int8
    buffer ``weight_q`` ([out, in], or [out, in/2] packed int4), its fp32
    ``scale`` ([out], or [G, out] group-wise) as a buffer, the optional bias as
    a parameter, and the mode the JAX leaf's name carries: ``q``
    (``kernel_q``), ``qa`` (``kernel_qa``), ``p4`` (``kernel_p4``), ``p4a``
    (``kernel_p4a``). The forward dispatches as the JAX package's ``_linear``
    does: modes ending in ``a`` quantize x per token and multiply in
    integers, the others keep x's dtype (unimedvl_tpu_torch/quant.py)."""

    def __init__(self, mode: str, weight_q: torch.Tensor, scale: torch.Tensor, bias=None):
        super().__init__()
        if mode not in QUANT_MODES:
            raise ValueError(f"mode must be one of {QUANT_MODES}, got {mode!r}")
        self.mode = mode
        self.out_features = weight_q.shape[0]
        self.in_features = weight_q.shape[1] * (2 if self.packed else 1)
        if weight_q.dtype != torch.int8 or scale.shape[-1] != self.out_features or (
                scale.dim() == 2 and not self.packed):
            raise ValueError(
                f"mode {mode!r} takes int8 weights [out, in{'/2' if self.packed else ''}] and "
                f"scales [out]{' or [G, out]' if self.packed else ''}, got {weight_q.dtype} "
                f"{tuple(weight_q.shape)} and scales {tuple(scale.shape)}"
            )
        self.register_buffer("weight_q", weight_q)
        self.register_buffer("scale", scale)
        if bias is None:
            self.register_parameter("bias", None)
        else:
            self.bias = nn.Parameter(bias.detach(), requires_grad=False)
        #: a row-parallel shard under tensor parallelism (parallel.mesh.attach_mesh):
        #: reduces the activations' row absmax over "model" in place, so that the
        #: int8 scale is the whole row's; None elsewhere
        self.reduce_max = None

    @property
    def packed(self) -> bool:
        return self.mode.startswith("p4")

    @property
    def act_quant(self) -> bool:
        return self.mode.endswith("a")

    def extra_repr(self) -> str:
        return f"mode={self.mode}, in={self.in_features}, out={self.out_features}"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return quant.quantized_forward(x, self)


def embedding(n: int, dim: int, device=None, dtype=None) -> nn.Embedding:
    emb = nn.Embedding(n, dim, device="meta", dtype=dtype)
    return emb.to_empty(device=device if device is not None else "cpu")
