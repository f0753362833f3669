"""GPipe pipeline-parallel training over a "pipe" mesh axis (the port of
unimedvl_tpu/parallel/pp_train.py).

Stage s of S holds the decoder layers [s L / S, (s + 1) L / S) of the
model, with its tensor-parallel shard when the mesh has a "model" axis;
everything outside the layer stack is replicated over "pipe"
(:func:`place_params_pp`, the JAX ``pipe_layer_specs`` / ``place_params_pp``).
Every rank embeds the microbatches of its "data" slice, the layer stack runs
the GPipe schedule of ``M + S - 1`` ticks (stage s runs microbatch ``t - s``
at tick t), the last stage's hidden states reach every "pipe" rank (the JAX
``psum``), and the final norm and the losses run replicated.

The backward is the reverse schedule, in one ``torch.autograd.Function``
around the stack (:class:`_Pipeline`): the cotangent of each microbatch's
output enters the last stage, each stage backpropagates its stashed graph of
that microbatch (GPipe, full stash; per-layer recomputation under
``cfg.remat``) and hands the input's cotangent to stage s - 1, and stage 0's
is broadcast over "pipe", so the replicated embedding side gets the same
gradients on every stage. The parameters' gradients accumulate in
``param.grad``.

The hops are ``broadcast``s over the "pipe" group (gloo carries
``all_reduce`` and ``broadcast`` of CUDA tensors, NCCL the same). With a
"data" axis each data slice runs its own pipeline over its ``M / dp``
microbatches. ``L % S == 0`` and ``M % dp == 0`` are required; the
diffusion feature tap is refused, as the JAX pipeline refuses it.

On a CUDA device whose mesh groups are all NCCL the step
(``training.trainer.make_pp_train_step``) runs the whole call as one
captured graph (``training.trainer.PipelineProgram``) over padded
microbatches: the embedding, this schedule, the losses and the reverse
schedule, its nested backward on the capture's stream. Every buffer a hop
broadcasts is allocated inside the call, never carried between calls.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from unimedvl_tpu_torch.models import bagel
from unimedvl_tpu_torch.models import qwen2_mot as mot
from unimedvl_tpu_torch.parallel import mesh as pmesh

PP_AXES = (("pipe",), ("pipe", "model"), ("data", "pipe", "model"))


def stage_range(num_layers: int, mesh: "pmesh.Mesh") -> Tuple[int, int]:
    """(first layer, layers) of this rank's pipeline stage."""
    S, s = mesh.shape["pipe"], mesh.coords["pipe"]
    if num_layers % S:
        raise ValueError(f"layers {num_layers} not divisible by pipe stages {S}")
    return s * (num_layers // S), num_layers // S


def keep_stage_layers(model, mesh: "pmesh.Mesh"):
    """Drop from a rank's model every decoder layer outside its stage (in
    place; returns the model). ``model.language_model.model.first_layer`` is
    the stage's first layer; the config keeps the whole depth."""
    lm = model.language_model.model
    first, n = stage_range(len(lm.layers), mesh)
    lm.layers = nn.ModuleList(list(lm.layers)[first:first + n])
    lm.first_layer = first
    return model


def place_params_pp(model, mesh: "pmesh.Mesh"):
    """This rank's stage model from a whole Bagel: its tensor-parallel shard
    over "model" when the mesh has one (``parallel.mesh.place_params``'s
    rules; views of the whole model's tensors), then only its stage's
    layers. The vocab-parallel embedding and head are whole over "pipe"."""
    if tuple(mesh.axis_names) not in PP_AXES:
        raise ValueError(f"a pipeline mesh has the axes {PP_AXES}, got {mesh.axis_names}")
    norm = model.language_model.model.norm.weight
    state = pmesh.shard_state(dict(model.state_dict(keep_vars=True)), model.config.llm, mesh)
    state = {k: v.detach() for k, v in state.items()}
    placed = pmesh.build_rank_model(state, model.config, mesh, norm.device, norm.dtype)
    return keep_stage_layers(placed, mesh)


class _Schedule:
    """One call's GPipe schedule on this rank: the stage's layers, the
    microbatches' layer bodies, and the stash of every (stage, microbatch)
    graph from the forward to its backward."""

    def __init__(self, layers, bodies, mesh, remat: bool):
        self.layers, self.bodies, self.mesh, self.remat = layers, bodies, mesh, remat
        self.S, self.s = mesh.shape["pipe"], mesh.coords["pipe"]
        self.stash = {}

    def _layers(self, x, m):
        body = self.bodies[m]
        for layer in self.layers:
            if self.remat:
                x = checkpoint(body, x, layer, use_reentrant=False, preserve_rng_state=False)
            else:
                x = body(x, layer)
        return x

    def forward(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        S, s, M = self.S, self.s, len(xs)
        outs: List[Optional[torch.Tensor]] = [None] * M
        recv = {}
        for t in range(M + S - 1):
            m, y = t - s, None
            if 0 <= m < M:
                x_in = (xs[m] if s == 0 else recv.pop(m)).detach().requires_grad_(True)
                with torch.enable_grad():
                    y = self._layers(x_in, m)
                self.stash[m] = (x_in, y)
            for src in range(S):  # this tick's outputs, in stage order, on every pipe rank
                mm = t - src
                if not 0 <= mm < M:
                    continue
                buf = y.detach().clone() if src == s else torch.empty_like(xs[mm])
                self.mesh.broadcast(buf, "pipe", src)
                if src == s - 1:
                    recv[mm] = buf
                if src == S - 1:
                    outs[mm] = buf
        return outs

    def backward(self, grads: Sequence[Optional[torch.Tensor]], like) -> List[torch.Tensor]:
        S, s, M = self.S, self.s, len(grads)
        dxs: List[Optional[torch.Tensor]] = [None] * M
        recv = {}
        for t in range(M + S - 1):
            m, gx = M - 1 - (t - (S - 1 - s)), None
            if 0 <= m < M:
                g = grads[m] if s == S - 1 else recv.pop(m)
                x_in, y = self.stash.pop(m)
                torch.autograd.backward(y, torch.zeros_like(y) if g is None else g)
                gx = x_in.grad
            for src in range(S):  # this tick's input cotangents, in stage order
                mm = M - 1 - (t - (S - 1 - src))
                if not 0 <= mm < M:
                    continue
                shape, dtype, device = like[mm]
                buf = gx.contiguous() if src == s else torch.empty(shape, dtype=dtype,
                                                                  device=device)
                self.mesh.broadcast(buf, "pipe", src)
                if src == s + 1:
                    recv[mm] = buf
                if src == 0:
                    dxs[mm] = buf
        return dxs


class _Pipeline(torch.autograd.Function):
    """The layer stack over M microbatches with the GPipe schedule.
    Forward: the schedule's forward (every stage's graph of every
    microbatch stashed); the outputs are the last stage's hidden states, on
    every "pipe" rank. Backward: the reverse schedule; returns stage 0's
    input cotangents, the same on every "pipe" rank. The stage's parameter
    gradients accumulate in ``param.grad`` (they are no inputs here)."""

    @staticmethod
    def forward(ctx, schedule, *xs):
        ctx.schedule = schedule
        ctx.like = [(x.shape, x.dtype, x.device) for x in xs]
        return tuple(schedule.forward(xs))

    @staticmethod
    def backward(ctx, *grads):
        dxs = ctx.schedule.backward(grads, ctx.like)
        return (None, *dxs)


def pipeline_layers(model, mesh: "pmesh.Mesh", xs: Sequence[torch.Tensor], seqs) -> tuple:
    """The stage's layers over the microbatches ``xs`` (embedded [T, C]
    each; ``seqs`` their prepared sequences) with the GPipe schedule: the
    [T, C] hidden states before the final norm, on every "pipe" rank."""
    lm = model.language_model.model
    cfg = lm.cfg
    bodies = [mot.make_train_layer_body(
        cfg, seq["packed_position_ids"], None, seq["und_idx"], seq["gen_idx"],
        segments=(seq["mask_document_id"], seq["mask_fn_id"], seq["mask_noise_id"]))
        for seq in seqs]
    remat = cfg.remat and torch.is_grad_enabled()
    return _Pipeline.apply(_Schedule(lm.layers, bodies, mesh, remat), *xs)


def pipeline_loss_sum(model, mesh: "pmesh.Mesh", seqs, noises=None,
                      generator: Optional[torch.Generator] = None, bn_state=None):
    """(sum of the losses of this data rank's microbatches ``seqs``, each
    one's ``bagel.train_losses`` outputs): embedding and losses replicated on
    every stage, the layer stack pipelined (:func:`pipeline_layers`).
    Differentiable. The microbatches may be stripped or padded
    (``bagel.prepare_sequence(padded=True)``, the step's program)."""
    cfg = model.config
    if cfg.e2e is not None and cfg.e2e.diffusion_feature_layer is not None:
        raise ValueError("the diffusion feature tap is not available inside the pipeline; "
                         "train REPA runs with make_train_step")
    xs, stashes = [], []
    for i, seq in enumerate(seqs):
        x, stash = bagel.train_embed(model, seq, None if noises is None else noises[i],
                                     generator, bn_state=bn_state)
        if cfg.llm.freeze_und:
            x = mot.detach_rows(x, seq["und_idx"])
        xs.append(x)
        stashes.append(stash)
    hs = pipeline_layers(model, mesh, xs, seqs)
    lm = model.language_model.model
    total = torch.zeros((), dtype=torch.float32, device=xs[0].device)
    outs = []
    for seq, h, stash in zip(seqs, hs, stashes):
        h = mot.final_norm(lm, h, seq["und_idx"], seq["gen_idx"])
        outs.append(bagel.train_losses(model, seq, h, stash))
        total = total + outs[-1]["loss"]
    return total, outs


def check_stage(model, cfg, mesh: "pmesh.Mesh") -> None:
    """Refuse a model that does not hold exactly its stage's layers."""
    _, n = stage_range(cfg.llm.num_hidden_layers, mesh)
    if len(model.language_model.model.layers) != n:
        raise ValueError(f"the model holds {len(model.language_model.model.layers)} layers, "
                         f"its stage {n}: place it with place_params_pp")


def pipeline_train_loss(model, cfg, mesh: "pmesh.Mesh", batches, noises=None,
                        generator: Optional[torch.Generator] = None, bn_state=None):
    """The mean training loss over the M microbatches of ``batches`` (a
    stacked numpy batch [M, ...] or a list of M prepared sequences, given
    whole to every rank) with the layer stack pipelined over "pipe".
    Returns (this data rank's part of the mean: the sum of its microbatches'
    losses over M, the mean itself without a "data" axis; the new
    batch-norm states of this data rank's microbatches with latent rows, as
    ``training.trainer.loss_fn`` keeps them). ``loss.backward()`` runs the
    reverse schedule and leaves in ``param.grad`` this rank's part of the
    gradient of the mean (summed over "data" by
    ``training.trainer.reduce_gradients``).
    ``noises``: one per microbatch, or drawn from ``generator`` for all M in
    order."""
    from unimedvl_tpu_torch.training.trainer import _latent_rows, _rank_sequences, prepared

    check_stage(model, cfg, mesh)
    device = model.language_model.model.norm.weight.device
    seqs, noises, M = _rank_sequences(batches, noises, generator, mesh)
    seqs = prepared(seqs, device, False)
    total, outs = pipeline_loss_sum(model, mesh, seqs, noises, generator, bn_state)
    # the new batch-norm states of the microbatches with latent rows (a neutral block has none)
    return total / M, [o["bn_state"] for seq, o in zip(seqs, outs)
                       if "bn_state" in o and _latent_rows(seq)]
