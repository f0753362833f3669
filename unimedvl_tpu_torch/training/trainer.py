"""Training step on one card: loss, gradients, AdamW, gradient accumulation
and an EMA shadow (port of unimedvl_tpu/training/trainer.py).

The reference releases no training pipeline (README.md:60-67); like the JAX
package this trains the forward the modeling code ships (bagel.py:202-374).
Where the JAX package maps a pure function over a stacked batch, the port
loops over the packed sequences of a batch and backpropagates each as soon
as its loss is known, so one sequence's activations are live at a time and
the gradients sum in place in ``param.grad``. The model is updated in place.

Every parameter outside the VAE trains (the position tables too, which are
plain leaves of the JAX tree; the REPA projections under ``cfg.e2e``), with
decoupled weight decay on all of them, as optax's ``adamw`` applies it. With
``cfg.e2e.enable_batch_norm`` the state carries the latent batch-norm's
running statistics (``bn_state``), updated with the mean over a step's
sequences of each sequence's new statistics. The VAE is fp32 and frozen: latents come from
``training.dataset.make_latent_fn``. Sharding over several cards (the JAX
package's ``mesh`` / ``fsdp`` arguments, ``make_pp_train_step``) belongs to
the multi-GPU slice.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import torch

from unimedvl_tpu_torch.config import BagelConfig
from unimedvl_tpu_torch.models import bagel
from unimedvl_tpu_torch.models.bagel import Bagel
from unimedvl_tpu_torch.training.e2e_vae import BatchNormState

_VAE = "vae_model."
_UND_LAYER_PARTS = ("input_layernorm", "post_attention_layernorm", "mlp")


@dataclasses.dataclass
class TrainState:
    """The model (updated in place), its optimizer, the step count, the
    latent batch-norm's running statistics under ``cfg.e2e.enable_batch_norm``
    (else None) and, when an EMA decay is set, the EMA shadow of every
    trained parameter by name. The shadow is fp32 by default: at decay 0.999
    a step moves it by ~1e-3 of the value, below bf16's resolution. (The
    released checkpoints are EMA weights, ``ema.safetensors``.)"""

    model: Bagel
    optimizer: torch.optim.Optimizer
    step: int = 0
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    bn_state: Optional[BatchNormState] = None


def make_optimizer(
    learning_rate: float = 1e-5, weight_decay: float = 0.01, b1: float = 0.9, b2: float = 0.95,
    eps: float = 1e-8,
) -> Callable[[Iterable[torch.nn.Parameter]], torch.optim.Optimizer]:
    """AdamW with decoupled weight decay as optax's ``adamw`` writes it:
    returns a factory that takes the parameters to train. The moments take
    each parameter's dtype."""
    return functools.partial(
        torch.optim.AdamW, lr=learning_rate, betas=(b1, b2), eps=eps, weight_decay=weight_decay
    )


def _freeze_und_labels(model: Bagel) -> Dict[str, str]:
    """'train' / 'freeze' for every parameter name, mirroring the freeze_und
    stop-gradient boundary of the training forward: the understanding expert's
    twins in every layer (the attention projections and q/k norms without
    ``_moe_gen``, the MLP, both layer norms) and the understanding final norm
    get no gradient from the loss, so the optimizer must not move them either:
    AdamW's decoupled weight decay would shrink 'frozen' weights every step."""
    labels = {}
    for name, _ in model.named_parameters():
        keys = name.split(".")
        label = "train"
        if keys[0] == "language_model" and "layers" in keys:
            sub = keys[keys.index("layers") + 2]
            if sub in _UND_LAYER_PARTS:
                label = "freeze"
            elif sub == "self_attn" and not keys[keys.index("layers") + 3].endswith("_moe_gen"):
                label = "freeze"
        elif keys[:3] == ["language_model", "model", "norm"]:
            label = "freeze"
        labels[name] = label
    return labels


def apply_freeze_und(model: Bagel) -> None:
    """Take the frozen understanding twins out of training: they require no
    grad, so they are in no optimizer and weight decay cannot move them."""
    params = dict(model.named_parameters())
    for name, label in _freeze_und_labels(model).items():
        if label == "freeze":
            params[name].requires_grad_(False)


def set_trainable(model: Bagel, cfg: Optional[BagelConfig] = None) -> List[torch.nn.Parameter]:
    """Mark every parameter outside the VAE as trainable (minus the frozen
    understanding twins under ``cfg.llm.freeze_und``); returns them."""
    cfg = cfg or model.config
    for name, p in model.named_parameters():
        p.requires_grad_(not name.startswith(_VAE))
    if cfg.llm.freeze_und:
        apply_freeze_und(model)
    return [p for p in model.parameters() if p.requires_grad]


def create_train_state(model: Bagel, optimizer=None, cfg: Optional[BagelConfig] = None
                       ) -> TrainState:
    """A train state over ``model``: everything outside the VAE trains.
    ``optimizer``: a factory as :func:`make_optimizer` returns."""
    cfg = cfg or model.config
    return _init_state(model, set_trainable(model, cfg), optimizer or make_optimizer(), None,
                       torch.float32, cfg)


def place_batches(batches, device, pin: bool = False) -> List[Dict[str, torch.Tensor]]:
    """A stacked numpy batch [B, ...] (``training.dataset.stack_packed``) as a
    list of B prepared sequences on ``device`` (``bagel.prepare_sequence``:
    padding slots dropped on the host). A list passes through."""
    if isinstance(batches, (list, tuple)):
        return list(batches)
    B = batches["packed_position_ids"].shape[0]
    return [bagel.prepare_sequence({k: v[b] for k, v in batches.items()}, device, pin)
            for b in range(B)]


def loss_fn(
    model: Bagel,
    batches,
    noises: Optional[Sequence[Optional[torch.Tensor]]] = None,
    generator: Optional[torch.Generator] = None,
    backward_scale: Optional[float] = None,
    bn_state: Optional[BatchNormState] = None,
):
    """(mean loss, new bn_state or None) over the packed sequences of
    ``batches`` (a stacked numpy batch with a leading axis [B, ...], or a
    list of prepared sequences). ``noises``: one flow-noise tensor per
    sequence (None entries, or no list: drawn from ``generator``, one draw
    per sequence in order). ``bn_state``: every sequence is normalized with
    it, and the new state is the mean of the new states of the sequences
    that carry latent tokens (the JAX package's sync-BN analogue over its
    batch, whose vmap also averages in a sequence without latents, from its
    bucket of zero rows).

    ``backward_scale``: backpropagate ``scale * loss_i / B`` right after each
    sequence's forward, so only one sequence's graph is ever live; the
    returned mean is then detached."""
    device = model.language_model.model.embed_tokens.weight.device
    seqs = place_batches(batches, device)
    total = torch.zeros((), dtype=torch.float32, device=device)
    new_bn = []
    for i, seq in enumerate(seqs):
        noise = noises[i] if noises is not None else None
        out = bagel.train_forward(model, seq, noise=noise, generator=generator,
                                  bn_state=bn_state)
        loss = out["loss"]
        if "bn_state" in out:
            new_bn.append(out["bn_state"])
        if backward_scale is not None:
            (loss * (backward_scale / len(seqs))).backward()
            loss = loss.detach()
        total = total + loss
    return total / len(seqs), _mean_bn(new_bn)


def _mean_bn(states: Sequence[BatchNormState]) -> Optional[BatchNormState]:
    if not states:
        return None
    return BatchNormState(mean=torch.stack([s.mean for s in states]).mean(dim=0),
                          var=torch.stack([s.var for s in states]).mean(dim=0))


def _apply_update(state: TrainState, ema_decay: Optional[float]) -> None:
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    state.step += 1
    if ema_decay is not None:
        with torch.no_grad():
            params = dict(state.model.named_parameters())
            for name, e in state.ema_params.items():
                e.mul_(ema_decay).add_(params[name].to(e.dtype), alpha=1.0 - ema_decay)


def train_step(state: TrainState, batches, generator: Optional[torch.Generator] = None,
               noises=None):
    """One plain step (no accumulation, no EMA): returns (state, mean loss)."""
    return _step(state, batches, generator, noises, accum_steps=1, ema_decay=None)


def make_train_step(
    cfg: BagelConfig,
    model: Bagel,
    optimizer=None,
    accum_steps: int = 1,
    ema_decay: Optional[float] = None,
    ema_dtype: torch.dtype = torch.float32,
    mesh=None,
    fsdp: bool = False,
):
    """Build the train step for one card: returns ``(step, init_state)`` with
    ``step(state, batches, generator=None, noises=None) -> (state, loss)``.
    With ``cfg.llm.freeze_und`` the understanding twins are out of the
    optimizer entirely (no update, not just no gradient).

    ``accum_steps``: gradient accumulation. ``batches`` is then a sequence of
    ``accum_steps`` batches, or one stacked numpy batch with a leading
    [accum_steps, B, ...] axis (and ``noises`` one list per batch); gradients sum
    in place in ``param.grad`` (one gradient per parameter in memory) and are
    divided once; one optimizer update of the mean gradient per call, equal
    to a single batch of ``accum_steps * B`` sequences.

    ``ema_decay``: keep an exponential moving average of the trained
    parameters in ``state.ema_params`` (dtype ``ema_dtype``):
    ``ema = decay * ema + (1 - decay) * param`` after every update.

    ``cfg.e2e``: the REPA projections train with the rest, and with
    ``enable_batch_norm`` the state starts a ``BatchNormState`` (zero means,
    unit variances) that each step replaces with the mean of its sequences'
    new statistics (over the accumulated batches too).

    ``mesh`` / ``fsdp`` (sharding over several cards) are not ported yet:
    the training half of M13 is the next slice (ROADMAP queue 1)."""
    if mesh is not None or fsdp:
        raise NotImplementedError(
            "make_train_step(mesh=..., fsdp=...): sharded training is the next slice of M13 "
            "(ROADMAP queue 1: make_train_step(mesh=, fsdp=), parallel/pp_train.py); this "
            "step runs on one card"
        )
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be at least 1, got {accum_steps}")
    factory = optimizer or make_optimizer()

    def init_state() -> TrainState:
        return _init_state(model, set_trainable(model, cfg), factory, ema_decay, ema_dtype, cfg)

    return functools.partial(_step, accum_steps=accum_steps, ema_decay=ema_decay), init_state


def _init_state(model, params, factory, ema_decay, ema_dtype, cfg=None) -> TrainState:
    ema = None
    if ema_decay is not None:
        ema = {name: p.detach().to(ema_dtype, copy=True)
               for name, p in model.named_parameters() if p.requires_grad}
    bn_state = None
    if cfg is not None and cfg.e2e is not None and cfg.e2e.enable_batch_norm:
        bn_state = BatchNormState.create(
            cfg.vae.z_channels, model.language_model.model.embed_tokens.weight.device)
    return TrainState(model=model, optimizer=factory(params), ema_params=ema, bn_state=bn_state)


def _step(state: TrainState, batches, generator=None, noises=None, *, accum_steps: int,
          ema_decay: Optional[float]):
    if accum_steps == 1:
        loss, new_bn = loss_fn(state.model, batches, noises, generator, backward_scale=1.0,
                               bn_state=state.bn_state)
    else:
        if isinstance(batches, dict):  # stacked [accum_steps, B, ...], as the JAX step takes it
            batches = [{k: v[i] for k, v in batches.items()} for i in range(accum_steps)]
        if len(batches) != accum_steps:
            raise ValueError(f"expected {accum_steps} batches to accumulate, got {len(batches)}")
        loss, states = 0.0, []
        for i, b in enumerate(batches):
            loss_i, bn_i = loss_fn(state.model, b, None if noises is None else noises[i],
                                   generator, backward_scale=1.0, bn_state=state.bn_state)
            loss = loss + loss_i
            if bn_i is not None:
                states.append(bn_i)
        inv = 1.0 / accum_steps
        loss = loss * inv
        new_bn = _mean_bn(states)
        grads = [p.grad for g in state.optimizer.param_groups for p in g["params"]
                 if p.grad is not None]
        torch._foreach_mul_(grads, inv)
    _apply_update(state, ema_decay)
    if new_bn is not None:
        state.bn_state = new_bn
    return state, loss
