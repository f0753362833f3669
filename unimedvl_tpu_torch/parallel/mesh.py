"""A device mesh over ``torch.distributed`` process groups, and the per-rank
views that manual tensor parallelism needs (the part of
unimedvl_tpu/parallel/mesh.py and sp_denoise.py's ``_layer_specs`` that the
sequence-parallel denoise uses).

One process is one rank and holds one device. ``Mesh`` names the axes
(``("model", "seq")``, or ``("data", "model", "seq")`` for the grouped entry
point), places rank r at the coordinates of ``arange(world).reshape(sizes)``
(the JAX package's ``devices.reshape(tp, sp)``) and keeps, per axis, the
process group of the ranks that differ from this one along that axis only. A
collective over an axis without a group is the identity: a mesh of one rank
needs no ``torch.distributed`` at all. The backend is the default group's:
NCCL for CUDA tensors, gloo for CPU tensors.

``tp_layer_view`` is the counterpart of ``_layer_specs``: where JAX shards a
stacked parameter tree by ``PartitionSpec``, a rank here narrows its own copy
of each projection (every rank holds the whole model, as every process loads
it): column-parallel leaves (``q k v q_gen k_gen v_gen gate up`` and the fused
``qkv*``/``gate_up*``) keep a slice of their output dim (weight rows, bias,
per-column scale), row-parallel leaves (``o o_gen down``) a slice of their
input dim (scales whole), norms stay whole. Slices are views of the model's
tensors, except the int8 weights of a row-parallel leaf, which are copied so
that the integer matmul reads a dense matrix.

``run_on_ranks`` runs a function on ``world`` spawned CPU ranks joined by a
gloo group (``file://`` rendezvous in a temporary directory): the tests and
``tools/dryrun_sp.py`` hold the multi-rank program to the single-device one
with it.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import multiprocessing
import os
import queue
import tempfile
import traceback
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from unimedvl_tpu_torch.models.layers import QuantLinear, linear_from_tensors

GROUP_TIMEOUT_S = 120.0


@dataclasses.dataclass
class Mesh:
    """Axis names and sizes, this rank's coordinates, and the process group
    of each axis (None: no collective runs over it)."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    rank: int
    coords: Dict[str, int]
    groups: Dict[str, Optional[dist.ProcessGroup]]

    def all_reduce(self, t: torch.Tensor, axis: str, async_op: bool = False):
        """Sum ``t`` over ``axis``, in place. Returns a handle whose ``wait()``
        must be called before ``t`` is read (None when nothing was started)."""
        group = self.groups[axis]
        if group is None:
            return None
        work = dist.all_reduce(t, group=group, async_op=async_op)
        return work if async_op else None

    def all_gather(self, t: torch.Tensor, axis: str, dim: int) -> "Gathered":
        """Start gathering ``t`` over ``axis``; ``Gathered.wait()`` returns the
        ranks' tensors joined along ``dim`` in rank order."""
        group = self.groups[axis]
        if group is None:
            return Gathered(t, None, None, dim)
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.shape[axis])]
        work = dist.all_gather(parts, t, group=group, async_op=True)
        return Gathered(t, parts, work, dim)


@dataclasses.dataclass
class Gathered:
    """An all-gather in flight. It keeps its input alive until ``wait()``: on
    NCCL the collective runs on a stream of its own and reads the tensor after
    the call has returned."""

    source: torch.Tensor
    parts: Optional[list]
    work: Optional[object]
    dim: int

    def wait(self) -> torch.Tensor:
        if self.parts is None:
            return self.source
        self.work.wait()
        return torch.cat(self.parts, dim=self.dim)


def make_mesh(axis_names: Sequence[str], sizes: Sequence[int],
              singleton_groups: bool = False) -> Mesh:
    """The mesh of the initialised default process group (or of one process
    without one). Every rank must call this, with the same arguments: the
    groups of every axis are created collectively, in one order.

    ``singleton_groups``: give an axis of size 1 a real one-rank group, so
    that its collectives really run (a smoke run of the collective calls on
    one device); by default such an axis has none."""
    axis_names, sizes = tuple(axis_names), tuple(int(s) for s in sizes)
    world = int(np.prod(sizes))
    initialised = dist.is_available() and dist.is_initialized()
    if not initialised:
        if world != 1:
            raise RuntimeError(
                f"a mesh of {world} ranks needs torch.distributed.init_process_group first")
        return Mesh(axis_names, dict(zip(axis_names, sizes)), 0, {a: 0 for a in axis_names},
                    {a: None for a in axis_names})
    if dist.get_world_size() != world:
        raise ValueError(f"mesh {dict(zip(axis_names, sizes))} has {world} ranks, the process "
                         f"group {dist.get_world_size()}")
    rank = dist.get_rank()
    grid = np.arange(world).reshape(sizes)
    coords = dict(zip(axis_names, (int(c) for c in np.unravel_index(rank, sizes))))
    groups: Dict[str, Optional[dist.ProcessGroup]] = {}
    for ax, name in enumerate(axis_names):
        groups[name] = None
        if sizes[ax] == 1 and not singleton_groups:
            continue
        others = [range(s) for i, s in enumerate(sizes) if i != ax]
        for fixed in itertools.product(*others):
            index = list(fixed)
            index.insert(ax, slice(None))
            ranks = [int(r) for r in grid[tuple(index)]]
            group = dist.new_group(ranks)  # collective: every rank creates every group
            if rank in ranks:
                groups[name] = group
    return Mesh(axis_names, dict(zip(axis_names, sizes)), rank, coords, groups)


# ---------------------------------------------------------------------------
# manual tensor parallelism: this rank's slice of each projection
# ---------------------------------------------------------------------------

COL = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
ROW = ("o_proj", "down_proj")
FUSED = ("qkv_proj", "gate_up_proj")


def _narrow(t: Optional[torch.Tensor], dim: int, rank: int, tp: int, what: str):
    if t is None:
        return None
    if t.shape[dim] % tp:
        raise ValueError(f"{what}: dim {dim} of {tuple(t.shape)} does not split over {tp} ranks")
    n = t.shape[dim] // tp
    return t.narrow(dim, rank * n, n)


def shard_linear(lin: nn.Module, column: bool, rank: int, tp: int, what: str) -> nn.Module:
    """This rank's Megatron shard of a linear: ``column`` narrows the output
    dim (weight rows, bias, per-column scale), otherwise the input dim (the
    scale stays whole). ``nn.Linear`` and ``QuantLinear`` in modes ``q`` and
    ``qa``; with ``tp == 1`` the module itself."""
    if tp == 1:
        return lin
    if hasattr(lin, "lora_a"):
        raise ValueError(f"{what} carries a LoRA adapter: training.lora.merge_lora first")
    if not column and lin.bias is not None:
        # a replicated bias would be summed tp times by the row-parallel all-reduce
        raise ValueError(f"{what}: a row-parallel projection with a bias is not supported")
    if isinstance(lin, QuantLinear):
        if lin.packed:
            raise NotImplementedError(
                f"{what}: packed-int4 projections under tensor parallelism are a later slice "
                "(ROADMAP queue 1, what remains of M13)")
        if column:
            return QuantLinear(lin.mode, _narrow(lin.weight_q, 0, rank, tp, what),
                               _narrow(lin.scale, 0, rank, tp, what),
                               _narrow(lin.bias, 0, rank, tp, what))
        return QuantLinear(lin.mode, _narrow(lin.weight_q, 1, rank, tp, what).contiguous(),
                           lin.scale, None)
    if not isinstance(lin, nn.Linear):
        raise TypeError(f"{what}: cannot shard a {type(lin).__name__}")
    if column:
        return linear_from_tensors(_narrow(lin.weight, 0, rank, tp, what),
                                   _narrow(lin.bias, 0, rank, tp, what))
    return linear_from_tensors(_narrow(lin.weight, 1, rank, tp, what), None)


def _shard_children(module: nn.Module, rank: int, tp: int, path: str) -> Dict[str, nn.Module]:
    """name -> this rank's shard, for every projection of ``module`` (both
    experts); a fused leaf comes under its plain name (``qkv_proj``,
    ``gate_up_proj``), whatever shard degree its own name carries: inside the
    manual region that degree is the mesh's."""
    out: Dict[str, nn.Module] = {}
    for name, child in module._modules.items():
        base = name[: -len("_moe_gen")] if name.endswith("_moe_gen") else name
        sfx = name[len(base):]
        if base in COL or base in ROW:
            out[name] = shard_linear(child, base in COL, rank, tp, f"{path}.{name}")
        elif base.startswith(FUSED):
            plain = next(f for f in FUSED if base.startswith(f))
            degree = int(base[len(plain) + len("_tp"):]) if base != plain else 1
            if degree != tp:
                raise ValueError(
                    f"{path}.{name}: fused projection layout tp={degree} != mesh model axis "
                    f"{tp}; re-fuse with quant.fuse_serving_projections(tp={tp})")
            out[plain + sfx] = shard_linear(child, True, rank, tp, f"{path}.{name}")
    return out


def tp_layer_view(layer: nn.Module, rank: int, tp: int, path: str = "layer") -> Dict:
    """One decoder layer as this "model" rank sees it: ``{"attn": {...},
    "mlp": {...}, "mlp_moe_gen": {...}}`` of sharded projections, the norms
    (whole) under their own names."""
    attn = layer.self_attn
    view = {"attn": _shard_children(attn, rank, tp, path + ".self_attn")}
    for name in ("q_norm", "k_norm", "q_norm_moe_gen", "k_norm_moe_gen"):
        if hasattr(attn, name):
            view["attn"][name] = getattr(attn, name)
    for name in ("mlp", "mlp_moe_gen"):
        if hasattr(layer, name):
            mlp = getattr(layer, name)
            view[name] = _shard_children(mlp, rank, tp, f"{path}.{name}")
            view[name]["act"], view[name]["act_is_silu"] = mlp.act, mlp.act_is_silu
    for name in ("input_layernorm", "post_attention_layernorm", "input_layernorm_moe_gen",
                 "post_attention_layernorm_moe_gen"):
        if hasattr(layer, name):
            view[name] = getattr(layer, name)
    return view


def shard_kv_heads(t: torch.Tensor, rank: int, tp: int) -> torch.Tensor:
    """The kv-head slice [L, S, Hk / tp, M, D] of a cache tensor for one
    "model" rank, as a view."""
    return _narrow(t, 2, rank, tp, "KV cache")


# ---------------------------------------------------------------------------
# spawned CPU ranks
# ---------------------------------------------------------------------------

def _rank_main(fn, rank: int, world: int, rendezvous: str, timeout_s: float, args, results):
    try:
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", init_method=f"file://{rendezvous}", world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            results.put((rank, True, fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise


def run_on_ranks(fn, world: int, *args, timeout_s: float = GROUP_TIMEOUT_S) -> list:
    """``fn(rank, world, *args)`` on ``world`` spawned processes joined by a
    gloo group, one torch thread each; returns their results in rank order.
    ``fn`` is a module-level function of an importable module and everything
    crossing the process boundary is pickled (return numpy arrays or plain
    values). A rank that raises, or a run that outlasts ``timeout_s`` (a
    deadlocked collective), kills every child and raises here."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [
            ctx.Process(target=_rank_main, daemon=True,
                        args=(fn, r, world, os.path.join(tmp, "rendezvous"), timeout_s, args,
                              results))
            for r in range(world)
        ]
        for p in procs:
            p.start()
        got, failure = {}, None
        try:
            while len(got) < world and failure is None:
                try:
                    rank, ok, value = results.get(timeout=timeout_s)
                except queue.Empty:
                    failure = f"no result within {timeout_s} s (ranks done: {sorted(got)})"
                    break
                if ok:
                    got[rank] = value
                else:
                    failure = f"rank {rank} raised:\n{value}"
        finally:
            for p in procs:  # the queue is drained (or given up on) before any join
                if failure is None:
                    p.join(timeout=timeout_s)
                if p.is_alive():
                    failure = failure or "a rank did not exit"
                    p.kill()
                    p.join()
    if failure is not None:
        raise RuntimeError(f"run_on_ranks({getattr(fn, '__name__', fn)}, world={world}): {failure}")
    return [got[r] for r in range(world)]
