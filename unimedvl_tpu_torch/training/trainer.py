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
``training.dataset.make_latent_fn``.

On a mesh (``make_train_step(mesh=, fsdp=)``, ``make_pp_train_step``) every
rank runs this host code over its shard of the model and its share of the
batch; the result is the JAX mesh program's, the single-device function:
the mean loss over the global batch, its gradients, one AdamW update per
call, and every tensor replicated over an axis bit-equal on the ranks of
that axis.

On a CUDA device the step runs as its program by default
(:class:`TrainProgram`, ``graphs=``): the counterpart of the JAX package's
jitted step. The sequences keep their padding (``bagel.prepare_sequence(
padded=True)``), so a batch's shapes are its bucket's; a "train" graph per
bucket runs one sequence's forward and backward into preallocated
gradients, and an "update" graph the rest of the call; the pipeline step's
program (:class:`PipelineProgram`) runs the whole GPipe call as one graph
in place of the per-sequence ones. The eager step
(``graphs=False``, or a gloo mesh) strips the padding on the host. Either
prepares the sequences it is given for its own route (:func:`prepared`).
"""

from __future__ import annotations

import dataclasses
import functools
import weakref
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import torch

from unimedvl_tpu_torch.config import BagelConfig
from unimedvl_tpu_torch.inference import programs
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
    #: the ``parallel.mesh.Mesh`` the state is a rank's shard of (None: one card); with
    #: ``fsdp`` the large leaves (``parallel.mesh.fsdp_dim``) hold this data rank's slice
    mesh: Optional[object] = None
    fsdp: bool = False


def make_optimizer(
    learning_rate: float = 1e-5, weight_decay: float = 0.01, b1: float = 0.9, b2: float = 0.95,
    eps: float = 1e-8,
) -> Callable[[Iterable[torch.nn.Parameter]], torch.optim.Optimizer]:
    """AdamW with decoupled weight decay as optax's ``adamw`` writes it:
    returns a factory that takes the parameters to train. The moments take
    each parameter's dtype. Parameters on a card get the fused
    implementation with ``capturable=True`` (its step count on the card), as
    the step's program captures it; the eager step updates with the same."""

    def factory(params) -> torch.optim.Optimizer:
        params = list(params)
        card = bool(params) and all(p.is_cuda for p in params)
        return torch.optim.AdamW(params, lr=learning_rate, betas=(b1, b2), eps=eps,
                                 weight_decay=weight_decay, fused=card or None, capturable=card)

    return factory


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
    return _init_state(model, cfg or model.config, optimizer or make_optimizer(), None,
                       torch.float32)


def place_batches(batches, device, pin: bool = False) -> List[Dict[str, torch.Tensor]]:
    """A stacked numpy batch [B, ...] (``training.dataset.stack_packed``) as a
    list of B prepared sequences on ``device`` (``bagel.prepare_sequence``:
    padding slots dropped on the host), as the eager step runs them. A list
    of stripped sequences passes through (:func:`prepared`)."""
    return prepared(batches, device, False, pin)


def _sequences(batches) -> list:
    """A batch's sequences: the rows of a stacked numpy batch, or the list."""
    if isinstance(batches, (list, tuple)):
        return list(batches)
    B = batches["packed_position_ids"].shape[0]
    return [{k: v[b] for k, v in batches.items()} for b in range(B)]


def prepared(batches, device, padded: bool, pin: bool = False) -> list:
    """A batch's sequences on ``device`` in the form a route of the step
    takes: with their padding (``padded``, :class:`TrainProgram`) or
    stripped (the eager step). A numpy sequence is prepared
    (``bagel.prepare_sequence``); a prepared one passes when its form is the
    route's and is prepared again from its host arrays when it is not; a
    dict of tensors passes as a stripped sequence."""
    out = []
    for seq in _sequences(batches):
        if isinstance(seq, bagel.PreparedSequence):
            if bagel.is_padded(seq) == padded:
                out.append(seq)
                continue
            if seq.host is None:
                raise ValueError("a prepared sequence without its host arrays cannot change form")
            seq = seq.host
        elif any(isinstance(v, torch.Tensor) for v in seq.values()):
            if padded:
                raise ValueError("the training program takes sequences with their padding: a "
                                 "numpy batch, or sequences from bagel.prepare_sequence; "
                                 "graphs=False runs the eager step")
            out.append(seq)
            continue
        out.append(bagel.prepare_sequence(seq, device, pin, padded))
    return out


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
    total, new_bn = _loss_sum(model, seqs, noises, generator, backward_scale, len(seqs),
                              bn_state)
    return total / len(seqs), _mean_bn(new_bn)


def _loss_sum(model, seqs, noises, generator, backward_scale, denominator, bn_state):
    """(sum of the sequences' losses, their new bn states): each sequence
    backpropagates ``backward_scale * loss_i / denominator`` after its
    forward."""
    device = model.language_model.model.embed_tokens.weight.device
    total = torch.zeros((), dtype=torch.float32, device=device)
    new_bn = []
    for i, seq in enumerate(seqs):
        noise = noises[i] if noises is not None else None
        with torch.profiler.record_function("train.sequence"):
            out = bagel.train_forward(model, seq, noise=noise, generator=generator,
                                      bn_state=bn_state)
            loss = out["loss"]
            if "bn_state" in out and _latent_rows(seq):  # (a neutral block has none)
                new_bn.append(out["bn_state"])
            if backward_scale is not None:
                (loss * (backward_scale / denominator)).backward()
                loss = loss.detach()
            total = total + loss
    return total, new_bn


def _latent_rows(seq) -> int:
    """The real latent rows of a sequence (a host int)."""
    shape = _noise_shape(seq)
    return 0 if shape is None else shape[0]


def _mean_bn(states: Sequence[BatchNormState]) -> Optional[BatchNormState]:
    if not states:
        return None
    return BatchNormState(mean=torch.stack([s.mean for s in states]).mean(dim=0),
                          var=torch.stack([s.var for s in states]).mean(dim=0))


def _apply_update(state: TrainState, ema_decay: Optional[float]) -> None:
    with torch.profiler.record_function("train.update"):
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        if ema_decay is not None:
            with torch.no_grad():
                params = dict(state.model.named_parameters())
                for name, e in state.ema_params.items():
                    e.mul_(ema_decay).add_(params[name].to(e.dtype), alpha=1.0 - ema_decay)


_PLAIN_STEPS: Dict[Optional[bool], "TrainStep"] = {}  # train_step's, one per ``graphs``


def train_step(state: TrainState, batches, generator: Optional[torch.Generator] = None,
               noises=None, graphs: Optional[bool] = None):
    """One plain step (no accumulation, no EMA): returns (state, mean loss).
    ``graphs`` as :func:`make_train_step` takes it (one step object per value,
    so that its programs are kept between calls)."""
    if graphs not in _PLAIN_STEPS:
        _PLAIN_STEPS[graphs] = TrainStep(1, None, graphs)
    return _PLAIN_STEPS[graphs](state, batches, generator, noises)


def make_train_step(
    cfg: BagelConfig,
    model: Bagel,
    optimizer=None,
    accum_steps: int = 1,
    ema_decay: Optional[float] = None,
    ema_dtype: torch.dtype = torch.float32,
    mesh=None,
    fsdp: bool = False,
    graphs: Optional[bool] = None,
):
    """Build the train step: returns ``(step, init_state)`` with
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

    ``mesh``: a ``parallel.mesh.Mesh`` with the axes ("data", "model"), and
    ``model`` this rank's model of it (``parallel.mesh.place_params``,
    ``build_rank_model``, ``load_bagel_checkpoint(mesh=)``): TP over
    "model" (Megatron's collectives in the training body, the vocab-parallel
    embedding and head), DP over "data". Every rank is given the whole
    batch of B sequences (B % data == 0) and runs sequences [d B / dp,
    (d + 1) B / dp); drawn noise is drawn for all B in the one-device order
    and each rank keeps its own, so injected and drawn noises agree. After
    the backward the gradients of the leaves that are not FSDP shards are
    summed over "data" (the q / k norms', applied to the rank's heads, also
    over "model"), as are the loss and the batch-norm statistics.
    ``init_state`` copies every parameter first (a placed model shares the
    whole model's tensors, and the step updates in place).

    ``fsdp``: the large LLM leaves (``parallel.mesh.fsdp_dim``: the layer
    kernels of both experts, the embedding, the head) and their AdamW
    moments and EMA hold this data rank's slice; each layer gathers them
    over "data" at the start of its body and its backward reduce-scatters
    their gradients (``parallel.mesh.whole_leaves``).

    ``graphs``: None runs the step as its program (:class:`TrainProgram`)
    on a CUDA device and eagerly elsewhere; True the program on any device
    (its plain route on the CPU, on any mesh); False the eager step. On a
    CUDA device a mesh with a gloo group runs eagerly, and True raises
    (``inference.programs.use_graphs``); so does an optimizer the program
    cannot capture (:meth:`TrainStep._program_updates`). ``batches`` may be
    numpy or prepared sequences of either form (:func:`prepared`): the step
    prepares them for its route, padded for the program, stripped for the
    eager step."""
    if fsdp and mesh is None:
        raise ValueError("fsdp=True shards over the 'data' axis of a mesh: pass mesh=")
    if mesh is not None:
        _check_rank_model(model, mesh, ("data", "model"))
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be at least 1, got {accum_steps}")
    init_state = functools.partial(_init_state, model, cfg, optimizer or make_optimizer(),
                                   ema_decay, ema_dtype, mesh, fsdp)
    return TrainStep(accum_steps, ema_decay, graphs), init_state


def _check_rank_model(model: Bagel, mesh, axes) -> None:
    if tuple(mesh.axis_names) != tuple(axes):
        raise ValueError(f"this step runs on a mesh with the axes {axes}, got "
                         f"{mesh.axis_names}")
    if getattr(model.language_model, "mesh", None) is not mesh:
        raise ValueError("model is not a rank's model of this mesh: place it first "
                         "(parallel.mesh.place_params, build_rank_model, or "
                         "load_bagel_checkpoint(mesh=))")
    tp = mesh.shape.get("model", 1)
    whole = getattr(model, "whole_config", model.config)
    if whole.llm.num_key_value_heads % tp:
        raise ValueError(f"training at model={tp} needs the {whole.llm.num_key_value_heads} kv "
                         "heads to split over it, not be replicated (a rank would hold a "
                         "partial gradient of a shared head)")


def _init_state(model, cfg, factory, ema_decay, ema_dtype, mesh=None, fsdp=False,
                params=None) -> TrainState:
    """A train state over ``model`` training ``params`` (by default everything
    outside the VAE, :func:`set_trainable`); on a mesh its parameters are
    copied first and, with ``fsdp``, narrowed
    (``parallel.mesh.shard_for_training``)."""
    if mesh is not None:
        from unimedvl_tpu_torch.parallel.mesh import shard_for_training

        shard_for_training(model, mesh, fsdp)
    if params is None:
        params = set_trainable(model, cfg)
    ema = None
    if ema_decay is not None:
        ema = {name: p.detach().to(ema_dtype, copy=True)
               for name, p in model.named_parameters() if p.requires_grad}
    bn_state = None
    if cfg is not None and cfg.e2e is not None and cfg.e2e.enable_batch_norm:
        bn_state = BatchNormState.create(
            cfg.vae.z_channels, model.language_model.model.embed_tokens.weight.device)
    return TrainState(model=model, optimizer=factory(params), ema_params=ema, bn_state=bn_state,
                      mesh=mesh, fsdp=fsdp)


def _accum_batches(batches, noises, accum_steps: int):
    """[(batch, its noises)] of one call: ``accum_steps`` of them."""
    if accum_steps == 1:
        return [(batches, noises)]
    if isinstance(batches, dict):  # stacked [accum_steps, B, ...], as the JAX step takes it
        batches = [{k: v[i] for k, v in batches.items()} for i in range(accum_steps)]
    if len(batches) != accum_steps:
        raise ValueError(f"expected {accum_steps} batches to accumulate, got {len(batches)}")
    return [(b, None if noises is None else noises[i]) for i, b in enumerate(batches)]


def _noise_shape(seq) -> Optional[tuple]:
    """The flow-noise shape of a sequence (None without the latent keys),
    padding rows dropped, as ``train_embed`` draws it."""
    if "vae_clean_tokens" not in seq:
        return None
    width = seq["vae_clean_tokens"].shape[-1]
    if bagel.is_padded(seq):
        return seq.vae_rows, width
    if isinstance(seq["vae_clean_tokens"], torch.Tensor):  # stripped
        return tuple(seq["vae_clean_tokens"].shape)
    T = seq["packed_position_ids"].shape[0]
    return int((seq["vae_scatter_idx"] < T).sum()), width


def data_share(mesh, n: int):
    """(first, count) of the ``n`` sequences of a batch that this "data"
    rank runs: a contiguous share, as ``P("data")`` places a batch axis; a
    batch that does not divide raises."""
    dp, d = mesh.shape.get("data", 1), mesh.coords.get("data", 0)
    if n % dp:
        raise ValueError(f"a batch of {n} sequences does not split over data={dp}")
    return d * (n // dp), n // dp


def _noise_shapes(batches) -> List[Optional[tuple]]:
    """The flow-noise shape of each sequence of a batch (:func:`_noise_shape`)."""
    return [_noise_shape(s) for s in _sequences(batches)]


def _rank_sequences(batches, noises, generator, mesh):
    """(this rank's sequences, as :func:`prepared` takes them, their noises,
    B): the rank's share of the batch, with the noise of every sequence of
    the batch drawn in order when it is drawn (so each rank keeps the draws
    the single device makes)."""
    seqs = _sequences(batches)
    B = len(seqs)
    if mesh is None or mesh.shape.get("data", 1) == 1:
        return seqs, noises, B
    s0, n = data_share(mesh, B)
    if noises is None and generator is not None:
        noises = [None if sh is None else
                  torch.randn(sh, generator=generator, dtype=torch.float32,
                              device=generator.device)
                  for sh in _noise_shapes(seqs)]
    return seqs[s0:s0 + n], None if noises is None else list(noises[s0:s0 + n]), B


def _bn_sums(states: Sequence[BatchNormState], z: int, device) -> torch.Tensor:
    """[sum of means | sum of variances | count] of some sequences' new
    batch-norm states (fp32), for a sum over "data"."""
    out = torch.zeros(2 * z + 1, dtype=torch.float32, device=device)
    for st in states:
        out[:z] += st.mean.float()
        out[z:2 * z] += st.var.float()
        out[2 * z] += 1
    return out


def compute_gradients(state: TrainState, batches, generator=None, noises=None,
                      accum_steps: int = 1):
    """The gradients of one call of the step, left in ``param.grad`` (on a
    mesh: this rank's part, reduced over the axes its leaves are replicated
    over), without the update: returns (mean loss, the new batch-norm state
    or None). ``batches`` / ``noises`` as the step takes them."""
    mesh = state.mesh
    model = state.model
    device = model.language_model.model.embed_tokens.weight.device
    groups = _accum_batches(batches, noises, accum_steps)
    loss = torch.zeros((), dtype=torch.float32, device=device)
    bn_parts = []
    for b, nz in groups:
        seqs, nz, B = _rank_sequences(b, nz, generator, mesh)
        loss_i, bn_i = _loss_sum(model, prepared(seqs, device, False), nz, generator, 1.0, B,
                                 state.bn_state)
        loss = loss + loss_i / B
        bn_parts.append(bn_i)
    if accum_steps > 1:
        inv = 1.0 / accum_steps
        loss = loss * inv
        grads = [p.grad for g in state.optimizer.param_groups for p in g["params"]
                 if p.grad is not None]
        torch._foreach_mul_(grads, inv)
    if mesh is None:
        return loss, _mean_bn([m for m in (_mean_bn(p) for p in bn_parts) if m is not None])
    reduce_gradients(model, state.fsdp)
    return _reduce_loss(mesh, loss), _reduce_bn(mesh, bn_parts, state.bn_state)


def _sum_over(mesh, t: torch.Tensor, axis: str) -> torch.Tensor:
    """``t`` summed over ``axis`` in place (as it is without that axis)."""
    from unimedvl_tpu_torch.parallel.mesh import axis_group

    if axis_group(mesh, axis) is not None:
        mesh.all_reduce(t, axis)
    return t


def _reduce_loss(mesh, loss: torch.Tensor) -> torch.Tensor:
    return _sum_over(mesh, loss.reshape(1).clone(), "data")[0]


def _step(state: TrainState, batches, generator=None, noises=None, *, accum_steps: int,
          ema_decay: Optional[float]):
    loss, new_bn = compute_gradients(state, batches, generator, noises, accum_steps)
    _apply_update(state, ema_decay)
    if new_bn is not None:
        state.bn_state = new_bn
    return state, loss


class TrainStep:
    """The train step of :func:`make_train_step` and
    ``lora.make_lora_train_step``: ``step(state, batches, generator=None,
    noises=None) -> (state, loss)``, by its program (:class:`TrainProgram`)
    or eagerly, as ``graphs`` and the device say
    (``inference.programs.use_graphs``). Its programs are dropped with it."""

    def __init__(self, accum_steps: int, ema_decay: Optional[float],
                 graphs: Optional[bool] = None):
        self.accum_steps, self.ema_decay, self.graphs = accum_steps, ema_decay, graphs

    def __call__(self, state: TrainState, batches, generator=None, noises=None):
        model = state.model
        device = model.language_model.model.embed_tokens.weight.device
        if not (programs.use_graphs(self.graphs, device, model)
                and self._program_updates(state.optimizer, device)):
            return self._eager(state, batches, generator, noises)
        prog = self._program().get(self, state, device)
        loss = prog.run(state, batches, generator, noises)
        state.step += 1
        return state, loss

    def _eager(self, state: TrainState, batches, generator, noises):
        return _step(state, batches, generator, noises, accum_steps=self.accum_steps,
                     ema_decay=self.ema_decay)

    def _program(self):
        return TrainProgram

    def _program_updates(self, optimizer: torch.optim.Optimizer, device) -> bool:
        """Whether the program can update with ``optimizer``: Adam or AdamW,
        on a card built with ``capturable=True`` (:func:`make_optimizer`'s
        there). Another runs the eager step under ``graphs=None`` and is
        refused under ``graphs=True``."""
        if not isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW)):
            why = f"it updates with Adam or AdamW, got {type(optimizer).__name__}"
        elif device.type == "cuda" and not all(g["capturable"] for g in optimizer.param_groups):
            why = "on a card it captures its optimizer's update: build it with capturable=True"
        else:
            return True
        if self.graphs:
            raise ValueError(f"the training program (graphs=True): {why}")
        return False


def _adam_state(optimizer: torch.optim.Optimizer) -> list:
    """Create the Adam state of every parameter that has none yet, as the
    optimizer's first step would (the step count on the parameter's device
    when the optimizer is capturable or fused), so that a program's key sees
    the state it updates. Returns the state's tensors."""
    from torch.optim.optimizer import _get_scalar_dtype

    out = []
    for group in optimizer.param_groups:
        on_device = group["capturable"] or group["fused"]
        for p in group["params"]:
            st = optimizer.state[p]
            if not st:
                st["step"] = torch.zeros((), dtype=_get_scalar_dtype(),
                                         device=p.device if on_device else None)
                st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                if group["amsgrad"]:
                    st["max_exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            out.extend(v for v in st.values() if isinstance(v, torch.Tensor))
    return out


class TrainProgram:
    """A train step as device programs (the JAX package's jitted step,
    ``unimedvl_tpu/training/trainer.py:270``), over static buffers:

    - the gradients: one preallocated tensor per trained parameter, bound as
      its ``.grad`` (on a mesh, views into one flat buffer per dtype of the
      leaves summed over "data", so that their all-reduce needs no copy);
    - a "train" graph per bucket (:class:`_TrainBucket`; a bucket is fixed
      by T, every padded list's length, the ViT's [N, max_n] and which keys
      the sequence has): one sequence's forward and the backward of ``w ·
      loss_i`` (w = 1 / B) adding into the gradients, with the loss and the
      batch-norm statistics summed on the device; replayed once per
      sequence of a call (B × ``accum_steps`` times), its inputs and noise
      copied into its buffers before each replay;
    - an "update" graph: the gradients times 1 / ``accum_steps``, on a mesh
      their sums over the axes they are replicated over (and the loss's and
      the statistics'), the optimizer's AdamW (on a card built capturable,
      its step count on the card: :func:`make_optimizer`'s fused one there),
      the gradients zeroed in place, the EMA as in-place ops,
      and the new batch-norm state chosen on the device (the eager step's
      host test of each accumulated batch's count).

    Each graph's warm-up is the call's real work: the first sequence of a
    bucket and the first update run eagerly on the capture stream, then the
    capture records them, so the capturing call computes what a replay
    computes. The flow noise is drawn outside the graphs from the caller's
    generator, in the eager step's shapes and order ([real rows, 64] a
    sequence), into a bucket's noise buffer, whose padding rows are zero;
    injected ``noises`` are copied in. A trained parameter that a call's
    sequences do not reach gets a zero gradient, as in the JAX step (the
    eager step leaves it out of that update).

    The program is keyed by its step, the weights (``programs.weights_key``),
    the optimizer's and the EMA's tensors and the mesh; its graphs share the
    "train" graph pool, freed when the step is dropped."""

    #: the kind of its buckets' graphs, and the profiler range around each replay
    KIND = "train"
    RANGE = "train.sequence"

    def __init__(self, state: TrainState, step: TrainStep, device: torch.device):
        model = state.model
        self.model = programs.model_ref(model)
        accum_steps, ema_decay = step.accum_steps, step.ema_decay
        self.device, self.accum_steps, self.ema_decay = device, accum_steps, ema_decay
        self.optimizer = state.optimizer
        self.mesh = state.mesh
        self.params = [p for g in state.optimizer.param_groups for p in g["params"]]
        names = {id(p): n for n, p in model.named_parameters()}
        self.names = [names[id(p)] for p in self.params]
        self.grads, self._flats = self._gradient_buffers(state.fsdp)
        f32 = dict(dtype=torch.float32, device=device)
        self.loss_sum, self.loss_out = torch.zeros((), **f32), torch.zeros((), **f32)
        self.weight = torch.ones((), **f32)
        self.group = torch.zeros(1, dtype=torch.int64, device=device)
        self.bn = None
        if state.bn_state is not None:
            z = state.bn_state.mean.shape[-1]
            self.bn = BatchNormState(mean=state.bn_state.mean.clone(),
                                     var=state.bn_state.var.clone())
            self.bn_sums = torch.zeros((accum_steps, 2 * z + 1), **f32)
        self.ema = None
        if ema_decay is not None:
            self.ema = [state.ema_params[n] for n in self.names]
        self.update = programs.Graph("update", self._update, device, training=True)

    @classmethod
    def get(cls, step: TrainStep, state: TrainState, device: torch.device) -> "TrainProgram":
        model = state.model
        opt = _adam_state(state.optimizer)
        ema = [] if state.ema_params is None else list(state.ema_params.values())
        key = (cls.KIND, id(step), step.accum_steps, step.ema_decay, state.bn_state is not None,
               state.fsdp, programs.weights_key(model), programs.tensors_key(opt),
               programs.tensors_key(ema), programs.mesh_key(model))
        return programs.lookup(key, lambda: cls(state, step, device), reads=(model, opt, ema),
                               owner=step)

    def graphs(self):
        return [self.update]

    def release(self) -> None:
        """Unbind the static gradients (dropped with the program)."""
        for p, g in zip(self.params, self.grads):
            if p.grad is g:
                p.grad = None

    def _gradient_buffers(self, fsdp: bool):
        """(one gradient tensor per trained parameter, the flat buffers of
        those summed over "data": [(dtype, flat, their indexes)])."""
        from unimedvl_tpu_torch.parallel.mesh import axis_group, fsdp_dim

        grads = [None] * len(self.params)
        flats = []
        if axis_group(self.mesh, "data") is not None:
            summed = [i for i, n in enumerate(self.names) if not (fsdp and fsdp_dim(n) is not None)]
            for dtype in sorted({self.params[i].dtype for i in summed}, key=str):
                idx = [i for i in summed if self.params[i].dtype == dtype]
                flat = torch.zeros(sum(self.params[i].numel() for i in idx), dtype=dtype,
                                   device=self.device)
                for i, part in zip(idx, flat.split([self.params[i].numel() for i in idx])):
                    grads[i] = part.view(self.params[i].shape)
                flats.append((dtype, flat, idx))
        for i, p in enumerate(self.params):
            if grads[i] is None:
                grads[i] = torch.zeros_like(p, memory_format=torch.contiguous_format)
        return grads, flats

    def _bind(self) -> None:
        """Make the static gradients the parameters' ``.grad``; if a
        parameter held another (an eager pass in between, which may also
        have added into a static one), zero them first."""
        stray = False
        for p, g in zip(self.params, self.grads):
            if p.grad is not g:
                stray = True
                p.grad = g
        if stray:
            torch._foreach_zero_(self.grads)

    def run(self, state: TrainState, batches, generator=None, noises=None) -> torch.Tensor:
        """One call of the step: every sequence through its bucket's graph,
        then the update; returns the mean loss (a new 0-dim tensor)."""
        self._bind()
        if self.bn is not None:
            self.bn.mean.copy_(state.bn_state.mean)
            self.bn.var.copy_(state.bn_state.var)
        for gi, (b, nz) in enumerate(_accum_batches(batches, noises, self.accum_steps)):
            seqs, nz, B = _rank_sequences(b, nz, generator, self.mesh)
            seqs = prepared(seqs, self.device, True, pin=self.device.type == "cuda")
            nz = [_program_noise(seq, None if nz is None else nz[i], generator)
                  for i, seq in enumerate(seqs)]
            self.weight.fill_(1.0 / B)
            self.group.fill_(gi)
            for part, part_noises in self._parts(seqs, nz):
                with torch.profiler.record_function(self.RANGE):
                    _TrainBucket.get(self, part).run(part, part_noises)
        with torch.profiler.record_function("train.update"):
            self.update.replay()
        if self.bn is not None:
            state.bn_state = BatchNormState(mean=self.bn.mean.clone(), var=self.bn.var.clone())
        return self.loss_out.clone()

    def _parts(self, seqs, noises) -> list:
        """The replays of one batch: ([sequences], [their noises]) each, one
        sequence a replay."""
        return [([seq], [noise]) for seq, noise in zip(seqs, noises)]

    def losses(self, seqs, noises) -> tuple:
        """(the summed loss of a bucket's ``seqs``, their ``train_losses``
        outputs): one sequence's training forward."""
        out = bagel.train_forward(self.model(), seqs[0], noise=noises[0], bn_state=self.bn)
        return out["loss"], [out]

    def _update(self) -> None:
        with torch.no_grad():
            if self.accum_steps > 1:
                torch._foreach_mul_(self.grads, 1.0 / self.accum_steps)
                self.loss_sum.mul_(1.0 / self.accum_steps)
            if self.mesh is not None:
                self._reduce()
            self.optimizer.step()
            torch._foreach_zero_(self.grads)
            self.loss_out.copy_(self.loss_sum)
            self.loss_sum.zero_()
            if self.ema is not None:
                d = self.ema_decay
                for e, p in zip(self.ema, self.params):
                    e.mul_(d).add_(p.to(e.dtype), alpha=1.0 - d)
            if self.bn is not None:
                self._choose_bn()

    def _reduce(self) -> None:
        """The eager step's ``reduce_gradients``, ``_reduce_loss`` and
        ``_reduce_bn`` sums over the fixed buffers: the gradients of the
        leaves that are not FSDP shards over "data" (one all-reduce a flat
        buffer), the q / k norms' also over "model", the loss and the
        statistics over "data"."""
        from unimedvl_tpu_torch.parallel.mesh import axis_group, model_partial

        mesh = self.mesh
        for _, flat, _ in self._flats:
            mesh.all_reduce(flat, "data")
        if axis_group(mesh, "model") is not None:
            part = [g for g, n in zip(self.grads, self.names) if model_partial(n)]
            for dtype in sorted({g.dtype for g in part}, key=str):
                group = [g for g in part if g.dtype == dtype]
                flat = torch.cat([g.reshape(-1) for g in group])
                mesh.all_reduce(flat, "model")
                for g, v in zip(group, flat.split([g.numel() for g in group])):
                    g.copy_(v.view(g.shape))
        if axis_group(mesh, "data") is not None:
            mesh.all_reduce(self.loss_sum.view(1), "data")
            if self.bn is not None:
                mesh.all_reduce(self.bn_sums, "data")

    def _choose_bn(self) -> None:
        """The new batch-norm state: per accumulated batch the mean over its
        sequences with latent rows, then the mean over the batches that had
        any; the old state where none had."""
        z = self.bn.mean.shape[-1]
        count = self.bn_sums[:, 2 * z]
        have = (count > 0).to(torch.float32)[:, None]
        k = have.sum()
        per = self.bn_sums[:, :2 * z] / count.clamp(min=1)[:, None]
        new = (per * have).sum(dim=0) / k.clamp(min=1)
        self.bn.mean.copy_(torch.where(k > 0, new[:z], self.bn.mean))
        self.bn.var.copy_(torch.where(k > 0, new[z:], self.bn.var))
        self.bn_sums.zero_()


def _program_noise(seq, noise, generator):
    """A sequence's flow noise for a program: ``noise`` as given, or drawn
    from ``generator`` in the eager step's shape ([real rows, 64]) when the
    sequence has latents; None without."""
    if noise is None and "vae_clean_tokens" in seq:
        if generator is None:
            raise ValueError("the flow noise is an input: pass noises=, or a torch.Generator "
                             "to draw it from")
        noise = torch.randn(_noise_shape(seq), generator=generator, dtype=torch.float32,
                            device=generator.device)
    return noise


class _TrainBucket:
    """One bucket of a :class:`TrainProgram`: the static inputs of the
    sequences one replay runs (a ``PaddedSequence`` of the bucket's shapes
    each: one sequence, or a pipeline step's microbatches), their noise
    buffers and the graph (of the program's ``KIND``) of their forward and
    the backward of ``weight · Σ losses``."""

    def __init__(self, prog: TrainProgram, seqs):
        self.prog = weakref.ref(prog)  # the program drops its buckets when it goes
        self.inputs = [bagel.PaddedSequence({k: torch.empty_like(v) for k, v in seq.items()})
                       for seq in seqs]
        self.noises = [torch.zeros(seq["vae_clean_tokens"].shape, dtype=torch.float32,
                                   device=prog.device) if "vae_clean_tokens" in seq else None
                       for seq in seqs]
        self.graph = programs.Graph(prog.KIND, self._body, prog.device, training=True)

    @staticmethod
    def key(seqs) -> tuple:
        return tuple(tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(seq.items()))
                     for seq in seqs)

    @classmethod
    def get(cls, prog: TrainProgram, seqs) -> "_TrainBucket":
        return programs.lookup(("train-bucket", id(prog), cls.key(seqs)),
                               lambda: cls(prog, seqs), reads=(prog.model(),), owner=prog,
                               family="train")

    def graphs(self):
        return [self.graph]

    def run(self, seqs, noises) -> None:
        for inputs, buf, seq, noise in zip(self.inputs, self.noises, seqs, noises):
            for k, v in seq.items():
                inputs[k].copy_(v, non_blocking=True)
            inputs.vae_rows = seq.vae_rows
            if buf is not None:
                n = seq.vae_rows
                if noise is not None and tuple(noise.shape) == tuple(buf.shape):
                    buf.copy_(noise)
                else:
                    buf[:n].copy_(noise)
                    buf[n:].zero_()
        self.graph.replay()

    def _body(self) -> None:
        prog = self.prog()
        total, outs = prog.losses(self.inputs, self.noises)
        (total * prog.weight).backward()
        with torch.no_grad():
            prog.loss_sum.add_(total.detach() * prog.weight)
            for out in outs:
                if "bn_state" in out:
                    st, have = out["bn_state"], (out["bn_rows"] > 0).to(torch.float32)
                    row = torch.cat([st.mean.float() * have, st.var.float() * have, have[None]])
                    prog.bn_sums.index_add_(0, prog.group, row[None])


def _reduce_bn(mesh, parts, bn_state: BatchNormState) -> Optional[BatchNormState]:
    """The new batch-norm state of a call on a mesh: per accumulated batch the
    mean over its latent-carrying sequences of every data rank (sums and
    counts summed over "data": every rank takes part, with or without such
    sequences), then the mean over the batches that had any."""
    if bn_state is None:
        return None
    z = bn_state.mean.shape[-1]
    sums = _sum_over(mesh, torch.stack([_bn_sums(p, z, bn_state.mean.device) for p in parts]),
                     "data")
    means = [(row[:z] / row[2 * z], row[z:2 * z] / row[2 * z]) for row in sums if row[2 * z] > 0]
    if not means:
        return None
    return BatchNormState(mean=torch.stack([m for m, _ in means]).mean(dim=0),
                          var=torch.stack([v for _, v in means]).mean(dim=0))


def reduce_gradients(model: Bagel, fsdp: bool = False) -> None:
    """Sum the gradients of a rank's trained parameters over the mesh axes
    they are replicated over: over "data" every leaf that is not an FSDP
    shard (those were summed in their gather's backward), and over "model"
    the q / k norms (applied to the rank's heads, so each rank holds a
    partial sum). One ``all_reduce`` per axis and dtype, over a flat buffer;
    a parameter without a gradient takes part with zeros, so every rank runs
    the same collectives."""
    from unimedvl_tpu_torch.parallel.mesh import axis_group, fsdp_dim, model_partial

    mesh = model.language_model.mesh
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    plan = [("data", [p for n, p in named if not (fsdp and fsdp_dim(n) is not None)]),
            ("model", [p for n, p in named if model_partial(n)])]
    for ax, params in plan:
        if axis_group(mesh, ax) is None or not params:
            continue
        for dtype in sorted({p.dtype for p in params}, key=str):
            group = [p for p in params if p.dtype == dtype]
            flat = torch.cat([torch.zeros(p.numel(), dtype=dtype, device=p.device)
                              if p.grad is None else p.grad.reshape(-1) for p in group])
            mesh.all_reduce(flat, ax)
            for p, g in zip(group, flat.split([p.numel() for p in group])):
                p.grad = g.view(p.shape)


def make_pp_train_step(cfg: BagelConfig, model: Bagel, mesh, optimizer=None,
                       ema_decay: Optional[float] = None,
                       ema_dtype: torch.dtype = torch.float32, graphs: Optional[bool] = None):
    """The pipeline-parallel train step (the JAX ``make_pp_train_step``):
    the layer stack over the mesh's "pipe" axis with the GPipe schedule
    (``parallel.pp_train``), ``model`` this rank's stage model
    (``parallel.pp_train.place_params_pp``). ``batches`` carry M
    microbatches (a stacked numpy batch [M, ...] or a list), given whole to
    every rank; the loss is the mean over them and one AdamW update is made
    per call. The state and the update are :func:`make_train_step`'s: the
    optimizer, the EMA and ``freeze_und`` act on the rank's parameters; the
    gradients are summed over "data" (the q / k norms' also over "model").

    ``graphs`` as :func:`make_train_step` takes it: by default on a CUDA
    device whose mesh groups are all NCCL the step runs as its program
    (:class:`PipelineProgram`), a gloo mesh there eagerly (True raises), the
    CPU eagerly (True: the program's plain route)."""
    from unimedvl_tpu_torch.parallel.pp_train import PP_AXES

    if tuple(mesh.axis_names) not in PP_AXES:
        raise ValueError(f"a pipeline mesh has the axes {PP_AXES}, got {mesh.axis_names}")
    _check_rank_model(model, mesh, mesh.axis_names)
    init_state = functools.partial(_init_state, model, cfg, optimizer or make_optimizer(),
                                   ema_decay, ema_dtype, mesh)
    return PipelineStep(cfg, ema_decay, graphs), init_state


class PipelineStep(TrainStep):
    """The step of :func:`make_pp_train_step`: ``step(state, batches,
    generator=None, noises=None) -> (state, loss)``, by its program
    (:class:`PipelineProgram`) or eagerly (:func:`pp_compute_gradients`,
    then the update), by :class:`TrainStep`'s rules."""

    def __init__(self, cfg: BagelConfig, ema_decay: Optional[float],
                 graphs: Optional[bool] = None):
        super().__init__(1, ema_decay, graphs)
        self.cfg = cfg

    def _eager(self, state: TrainState, batches, generator, noises):
        loss, new_bn = pp_compute_gradients(state, self.cfg, batches, generator, noises)
        _apply_update(state, self.ema_decay)
        if new_bn is not None:
            state.bn_state = new_bn
        return state, loss

    def _program(self):
        return PipelineProgram


class PipelineProgram(TrainProgram):
    """The pipeline step as device programs (the JAX package's jitted
    ``shard_map`` around the GPipe ``lax.scan``,
    ``unimedvl_tpu/training/trainer.py:307``): :class:`TrainProgram`'s
    gradients, binding and "update" graph, and in place of a graph per
    sequence one "pipeline" graph per bucket of this data rank's M / dp
    padded microbatches (keyed by every microbatch's shapes), replayed once
    a call. Its body is the whole GPipe call: each microbatch's embedding
    (the ``freeze_und`` detach), the schedule over "pipe" with its
    broadcasts, the final norm and the losses, and the backward of
    ``Σ losses / M`` through the reverse schedule into the static
    gradients, the loss and the batch-norm sums accumulated on the card.
    The noise is drawn as :class:`TrainProgram` draws it, in the eager
    step's order (``_rank_sequences``)."""

    KIND = "pipeline"
    RANGE = "train.pipeline"

    def __init__(self, state: TrainState, step: PipelineStep, device: torch.device):
        super().__init__(state, step, device)
        self.cfg = step.cfg

    def _parts(self, seqs, noises) -> list:
        from unimedvl_tpu_torch.parallel.pp_train import check_stage

        check_stage(self.model(), self.cfg, self.mesh)
        return [(seqs, noises)]

    def losses(self, seqs, noises) -> tuple:
        from unimedvl_tpu_torch.parallel.pp_train import pipeline_loss_sum

        return pipeline_loss_sum(self.model(), self.mesh, seqs, noises, bn_state=self.bn)


def pp_compute_gradients(state: TrainState, cfg: BagelConfig, batches, generator=None,
                         noises=None):
    """:func:`compute_gradients` of the pipeline step: the GPipe loss over
    the microbatches and its reverse schedule, the gradients reduced over
    the axes their leaves are replicated over. Returns (mean loss, the new
    batch-norm state or None)."""
    from unimedvl_tpu_torch.parallel.pp_train import pipeline_train_loss

    mesh = state.mesh
    with torch.profiler.record_function("train.pipeline"):
        loss, new_bn = pipeline_train_loss(state.model, cfg, mesh, batches, noises, generator,
                                           state.bn_state)
        loss.backward()
    reduce_gradients(state.model)
    return _reduce_loss(mesh, loss.detach()), _reduce_bn(mesh, [new_bn], state.bn_state)
