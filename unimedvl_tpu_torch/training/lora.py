"""LoRA parameter-efficient fine-tuning (port of unimedvl_tpu/training/lora.py).

Low-rank adapters ride the linear projections of the LLM's decoder layers: a
projection becomes a ``models.layers.LoRALinear`` that shares the base
weight and adds ``((x A^T) B^T) * s`` on every path that calls it: the packed
training forward and unfused inference (prefill, decode, denoise). The fused
serving layouts need :func:`merge_lora` first
(``quant.fuse_serving_projections`` refuses unmerged adapters).

Where the JAX package returns new trees, the port edits the module tree in
place: a 14B base cannot be copied on one card. Only ``lora_a`` and ``lora_b``
require grad: the base gets no gradient and no optimizer moments, so adapter
training over the full-depth bf16 base fits one 80 GB card beside the base's
28 GB.

QLoRA: adapters ride a quantized base too, in every mode (int8 ``q`` /
``qa``, packed int4 ``p4`` / ``p4a``, per channel or group-wise). Quantize
first and add adapters (``add_lora`` over ``QuantLinear`` leaves), or add
adapters and quantize (``quant.quantize_llm_params`` carries them across).
The frozen base's buffers stay integers; its projections pass gradients to
x through their differentiable routes (``quant.py``). :func:`merge_lora`
refuses a quantized base, as the JAX package's does.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
from torch import nn

from unimedvl_tpu_torch.models.layers import LoRALinear, QuantLinear
from unimedvl_tpu_torch.training import trainer

# user-facing target names -> (container, understanding leaf, generation leaf)
_TARGET_MAP = {
    "q": ("attn", "q_proj", "q_proj_moe_gen"),
    "k": ("attn", "k_proj", "k_proj_moe_gen"),
    "v": ("attn", "v_proj", "v_proj_moe_gen"),
    "o": ("attn", "o_proj", "o_proj_moe_gen"),
    "gate": ("mlp", "gate_proj", None),
    "up": ("mlp", "up_proj", None),
    "down": ("mlp", "down_proj", None),
}
TARGETS_ALL: Tuple[str, ...] = tuple(_TARGET_MAP)
_ADAPTER_LEAVES = ("lora_a", "lora_b")


def _llm(model):
    return getattr(model, "language_model", model)


def _adapter_sites(lm, targets: Sequence[str], experts: Sequence[str]
                   ) -> Iterator[Tuple[nn.Module, str]]:
    """(parent module, attribute name) of every projection to adapt."""
    for layer in lm.model.layers:
        for t in targets:
            container, und_name, gen_name = _TARGET_MAP[t]
            if container == "attn":
                attn = layer.self_attn
                if "und" in experts and hasattr(attn, und_name):
                    yield attn, und_name
                if "gen" in experts and hasattr(attn, gen_name):
                    yield attn, gen_name
            else:
                if "und" in experts and hasattr(layer.mlp, und_name):
                    yield layer.mlp, und_name
                gen_mlp = getattr(layer, "mlp_moe_gen", None)
                if "gen" in experts and gen_mlp is not None and hasattr(gen_mlp, und_name):
                    yield gen_mlp, und_name


def add_lora(
    model,
    generator: torch.Generator,
    rank: int = 16,
    alpha: float = 32.0,
    targets: Sequence[str] = TARGETS_ALL,
    experts: Sequence[str] = ("und", "gen"),
    dtype: torch.dtype = torch.bfloat16,
):
    """Attach LoRA adapters, in place, to a Bagel or its LLM; returns it.
    ``lora_a`` ~ N(0, 1/in) drawn from ``generator``, ``lora_b`` = 0 (the
    model's function is unchanged at step 0), ``lora_s`` = alpha / rank.
    Works over bf16 and quantized bases alike."""
    from unimedvl_tpu_torch.inference import programs

    programs.drop_reading(model)  # the device programs that read the weights it replaces
    unknown = set(targets) - set(_TARGET_MAP)
    if unknown:
        raise ValueError(f"unknown lora targets {sorted(unknown)}; valid: {TARGETS_ALL}")
    sites = list(_adapter_sites(_llm(model), targets, experts))
    if not sites:
        raise ValueError("no adapter sites matched (targets/experts filter)")
    for parent, name in sites:
        base = getattr(parent, name)
        if isinstance(base, LoRALinear):
            raise ValueError(f"{name} already carries an adapter")
        if isinstance(base, QuantLinear):  # QLoRA; a packed base counts 2 in-rows a byte
            out_f, in_f, device = base.out_features, base.in_features, base.weight_q.device
        else:
            out_f, in_f = base.weight.shape
            device = base.weight.device
        a = torch.randn((rank, in_f), generator=generator, dtype=torch.float32,
                        device=generator.device) * in_f**-0.5
        setattr(parent, name, LoRALinear(
            base, a.to(device=device, dtype=dtype),
            torch.zeros((out_f, rank), dtype=dtype, device=device), alpha / rank))
    return model


def _lora_modules(model) -> List[Tuple[nn.Module, str, LoRALinear]]:
    found = []
    for parent in model.modules():
        for name, child in parent.named_children():
            if isinstance(child, LoRALinear):
                found.append((parent, name, child))
    return found


@torch.no_grad()
def merge_lora(model):
    """Fold every adapter into its base weight, in fp32, in place, and put a
    plain linear back; returns the model. A quantized base cannot absorb the
    update exactly, so it raises (quantize after merging instead), as the
    JAX package's does."""
    from unimedvl_tpu_torch.inference import programs

    programs.drop_reading(model)  # the device programs that read the weights it replaces
    found = _lora_modules(model)
    if any(mod.mode is not None for _, _, mod in found):
        raise ValueError("merge_lora on a quantized base: dequantize, or quantize after "
                         "merging instead")
    for parent, name, mod in found:
        delta = (mod.lora_b.float() @ mod.lora_a.float()) * mod.lora_s
        mod.weight.copy_((mod.weight.float() + delta).to(mod.weight.dtype))
        lin = nn.Linear(mod.in_features, mod.out_features, bias=mod.bias is not None,
                        device="meta")
        lin.weight, lin.bias = mod.weight, mod.bias
        setattr(parent, name, lin)
    return model


def has_lora(model) -> bool:
    return bool(_lora_modules(model))


def lora_labels(model) -> Dict[str, str]:
    """'train' on lora_a / lora_b, 'freeze' on every other parameter name."""
    return {name: "train" if name.rsplit(".", 1)[-1] in _ADAPTER_LEAVES else "freeze"
            for name, _ in model.named_parameters()}


def apply_lora_only(model) -> List[nn.Parameter]:
    """Only the adapters require grad, so only they get gradients, optimizer
    moments and weight decay; returns them."""
    params = dict(model.named_parameters())
    for name, label in lora_labels(model).items():
        params[name].requires_grad_(label == "train")
    return [p for p in params.values() if p.requires_grad]


def make_lora_train_step(cfg, model, optimizer=None, accum_steps: int = 1,
                         graphs: Optional[bool] = None):
    """Adapter training step: returns ``(step, state)`` with
    ``step(state, batches, generator=None, noises=None) -> (state, loss)``.
    The frozen base takes part in the forward only; gradients and AdamW
    moments exist for the adapter leaves alone. ``optimizer``: a factory as
    ``trainer.make_optimizer`` returns (default AdamW 1e-4, b2 0.95, weight
    decay 1e-4). ``batches`` follow ``trainer.loss_fn``'s contract. The base
    may be quantized (QLoRA). The e2e-VAE extras (latent batch-norm, REPA)
    are not taken here, as the JAX package's lean step does not take them:
    ``cfg.e2e`` raises. ``graphs`` as ``trainer.make_train_step`` takes it:
    on a CUDA device the step runs as its program by default, the adapters'
    gradients preallocated and every quantized base's kernels (K3, K4 under
    autograd) inside its graphs."""
    if cfg.e2e is not None:
        raise ValueError("make_lora_train_step takes no e2e-VAE extras (cfg.e2e): train them "
                         "with trainer.make_train_step")
    adapters = apply_lora_only(model)
    if not adapters:
        raise ValueError("the model carries no adapters: add_lora(...) first")
    factory = optimizer or trainer.make_optimizer(1e-4, weight_decay=1e-4, b1=0.9, b2=0.95)
    state = trainer._init_state(model, None, factory, None, torch.float32, params=adapters)
    return trainer.TrainStep(accum_steps, None, graphs), state


def count_lora_params(model) -> int:
    return int(sum(p.numel() for name, p in model.named_parameters()
                   if name.rsplit(".", 1)[-1] in _ADAPTER_LEAVES))
