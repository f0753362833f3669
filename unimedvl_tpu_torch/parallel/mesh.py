"""A device mesh over ``torch.distributed`` process groups, and what manual
tensor parallelism needs on each rank (the port of unimedvl_tpu/parallel/
mesh.py, of ``bagel_loader.place_params`` and of sp_denoise.py's
``_layer_specs``).

One process is one rank. ``Mesh`` names the axes (``("data", "model")`` for
serving, ``("model", "seq")`` for the sequence-parallel denoise, ``("data",
"model", "seq")`` for the grouped one), places rank r at the coordinates of
``arange(world).reshape(sizes)`` (the JAX package's ``devices.reshape``) and
keeps, per axis, the process group of the ranks that differ from this one
along that axis only. A collective over an axis without a group is the
identity: a mesh of one rank needs no ``torch.distributed`` at all. The
backend is the default group's: NCCL for CUDA tensors, gloo for CPU tensors
(and for CUDA tensors where NCCL cannot run, several ranks on one card:
gloo carries ``all_reduce`` and ``broadcast`` of CUDA tensors, so every
gather here is a sum into a zeroed buffer, :meth:`Mesh.gather`).

Where JAX places a parameter tree by ``PartitionSpec`` and XLA partitions one
program, every rank here holds a model of its own shapes and runs the same
host code: :func:`leaf_ranges` says which part of each tensor a "model" rank
holds (column-parallel ``q k v gate up`` and the fused ``qkv`` / ``gate_up``
keep their output rows, the rank's heads by :func:`head_split`; row-parallel
``o down`` their input columns, packed int4 bytes and group scales
included; the embedding and the lm_head a vocab slice), :func:`place_params`
builds the rank's model from a whole one (views, no copies at one "model"
rank) and :func:`build_rank_model` from a state dict of shards (the sharded
loader's). Decoder layers sum over "model" after the attention and after
the MLP; the vocab-parallel embedding and head sum and gather over it.

:func:`stream_range` is the one rule for what "data" shards (streams when
they divide it), :func:`kv_head_range` for the kv heads a "model" rank
caches. ``run_on_ranks`` runs a function on ``world`` spawned CPU
ranks joined by a gloo group (``file://`` rendezvous in a temporary
directory): the tests and ``tools/dryrun_sp.py`` / ``tools/dryrun_mesh.py``
hold the multi-rank programs to the single-device ones with it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import functools
import itertools
import multiprocessing
import os
import queue
import re
import tempfile
import traceback
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

GROUP_TIMEOUT_S = 120.0

#: collectives issued over a group (a graph's replay adds those its capture issued, as
#: the kernels' launch counters do: ``inference/programs.py``)
counts = {"collectives": 0}


def group_backend(group: dist.ProcessGroup) -> str:
    """The backend of a process group ("nccl", "gloo", ...)."""
    return str(dist.get_backend(group))


@dataclasses.dataclass
class Mesh:
    """Axis names and sizes, this rank's coordinates, and the process group
    of each axis (None: no collective runs over it).

    Every collective is issued on the current stream and reads nothing back
    to the host: on NCCL the stream waits for the collective's stream by an
    event, so a CUDA graph captures it as an edge of the graph. A work
    started with ``async_op`` is waited for by the code that started it,
    before its result is read."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    rank: int
    coords: Dict[str, int]
    groups: Dict[str, Optional[dist.ProcessGroup]]

    def backends(self) -> Dict[str, str]:
        """The backend of each axis that has a group."""
        return {a: group_backend(g) for a, g in self.groups.items() if g is not None}

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can capture this mesh's collectives: every
        group is NCCL (a mesh without groups runs none). Gloo stages a CUDA
        tensor through the host, which no graph captures."""
        return all(b == "nccl" for b in self.backends().values())

    def all_reduce(self, t: torch.Tensor, axis: str, async_op: bool = False,
                   op=dist.ReduceOp.SUM):
        """Reduce ``t`` over ``axis`` (a sum unless ``op`` says otherwise), in
        place. Returns a handle whose ``wait()`` must be called before ``t`` is
        read (None when nothing was started). An axis the mesh does not have
        raises."""
        group = self.groups[axis]
        if group is None:
            return None
        counts["collectives"] += 1
        work = dist.all_reduce(t, op=op, group=group, async_op=async_op)
        return work if async_op else None

    def axis_rank(self, axis: str, index: int) -> int:
        """The global rank at this rank's coordinates with ``axis`` set to
        ``index``."""
        coords = [index if a == axis else self.coords[a] for a in self.axis_names]
        return int(np.ravel_multi_index(coords, [self.shape[a] for a in self.axis_names]))

    def broadcast(self, t: torch.Tensor, axis: str, index: int) -> None:
        """Broadcast ``t`` in place from the rank at ``index`` along ``axis``
        to every rank of that axis (nothing without a group)."""
        group = self.groups[axis]
        if group is not None:
            counts["collectives"] += 1
            dist.broadcast(t, src=self.axis_rank(axis, index), group=group)

    def gather(self, t: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        """The ranks' ``t`` joined along ``dim`` in rank order over ``axis``,
        as a sum into a zeroed buffer where this rank's part is written: one
        ``all_reduce``, which every backend carries for CUDA tensors (gloo
        has no CUDA ``all_gather``). Exact: every element is one rank's value
        plus zeros."""
        if self.groups[axis] is None:
            return t
        n, r = self.shape[axis], self.coords[axis]
        shape = list(t.shape)
        shape[dim] *= n
        out = torch.zeros(shape, dtype=t.dtype, device=t.device)
        out.narrow(dim, r * t.shape[dim], t.shape[dim]).copy_(t)
        self.all_reduce(out, axis)
        return out

    def all_gather(self, t: torch.Tensor, axis: str, dim: int) -> "Gathered":
        """Start gathering ``t`` over ``axis``; ``Gathered.wait()`` returns the
        ranks' tensors joined along ``dim`` in rank order."""
        group = self.groups[axis]
        if group is None:
            return Gathered(t, None, None, dim)
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.shape[axis])]
        counts["collectives"] += 1
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
# differentiable collectives: the training forward on a rank
# ---------------------------------------------------------------------------

def axis_group(mesh: Optional["Mesh"], axis: str) -> Optional[dist.ProcessGroup]:
    """The process group of ``axis`` on ``mesh`` (None without a mesh, an
    axis the mesh lacks, or one without a group): a collective over it is
    the identity."""
    return None if mesh is None else mesh.groups.get(axis)


class _CopyIn(torch.autograd.Function):
    """Megatron's f, in front of a column-parallel projection. Forward: the
    identity (every "model" rank holds the whole input). Backward: the
    cotangent summed over "model" (each rank's is the part that flowed
    through its output columns)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        ctx.mesh.all_reduce(g, "model")
        return g, None


class _ReduceOut(torch.autograd.Function):
    """Megatron's g, after a row-parallel projection (and the vocab-parallel
    lookup). Forward: the ranks' partial sums summed over "model".
    Backward: the identity (each partial entered the sum with weight one)."""

    @staticmethod
    def forward(ctx, x, mesh):
        out = x.clone(memory_format=torch.contiguous_format)
        mesh.all_reduce(out, "model")
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherModel(torch.autograd.Function):
    """The vocab-parallel logits joined over "model". Forward:
    :meth:`Mesh.gather` along ``dim``. Backward: the rank's slice of the
    cotangent. Exact because every rank computes the same loss from the same
    whole row, so the cotangent is the same on every rank."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.dim, ctx.n, ctx.r = dim, x.shape[dim], mesh.coords["model"]
        return mesh.gather(x.contiguous(), "model", dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.r * ctx.n, ctx.n), None, None


class _GatherData(torch.autograd.Function):
    """FSDP: whole tensors from each "data" rank's shards. Forward: each data
    rank in turn broadcasts its shards, joined into one flat buffer, and
    every rank writes them into their places (a gather: each shard crosses
    once, half the traffic of a sum into zeros). Backward: the whole
    gradients written into one flat buffer, summed over "data" by one
    ``all_reduce``, and each rank keeps its slice (a reduce-scatter): the
    gradient of the batch of every data rank, for the rank's shard."""

    @staticmethod
    def forward(ctx, mesh, dims, *shards):
        n, me = mesh.shape["data"], mesh.coords["data"]
        shapes = []
        for t, d in zip(shards, dims):
            shape = list(t.shape)
            shape[d] *= n
            shapes.append(shape)
        sizes = [int(np.prod(s)) for s in shapes]
        like = shards[0]
        out = torch.empty(sum(sizes), dtype=like.dtype, device=like.device)
        wholes = [v.view(s) for v, s in zip(out.split(sizes), shapes)]
        mine = torch.cat([t.reshape(-1) for t in shards])
        for r in range(n):
            flat = mine if r == me else torch.empty_like(mine)
            mesh.broadcast(flat, "data", r)
            for w, part, t, d in zip(wholes, flat.split([t.numel() for t in shards]), shards,
                                     dims):
                w.narrow(d, r * t.shape[d], t.shape[d]).copy_(part.view(t.shape))
        ctx.mesh, ctx.dims, ctx.shapes, ctx.sizes = mesh, dims, shapes, sizes
        return tuple(wholes)

    @staticmethod
    def backward(ctx, *grads):
        mesh = ctx.mesh
        n, r = mesh.shape["data"], mesh.coords["data"]
        like = next(g for g in grads if g is not None)
        buf = torch.zeros(sum(ctx.sizes), dtype=like.dtype, device=like.device)
        for v, g, s in zip(buf.split(ctx.sizes), grads, ctx.shapes):
            if g is not None:
                v.view(s).copy_(g)
        mesh.all_reduce(buf, "data")
        out = []
        for v, s, d, need in zip(buf.split(ctx.sizes), ctx.shapes, ctx.dims,
                                 ctx.needs_input_grad[2:]):
            k = s[d] // n
            out.append(v.view(s).narrow(d, r * k, k).clone() if need else None)
        return (None, None, *out)


def _taped(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_in(x: torch.Tensor, mesh: Optional["Mesh"]) -> torch.Tensor:
    """:class:`_CopyIn` over "model" (the identity without a "model" group,
    or for a tensor off the autograd tape)."""
    if axis_group(mesh, "model") is None or not _taped(x):
        return x
    return _CopyIn.apply(x, mesh)


def reduce_out(x: torch.Tensor, mesh: Optional["Mesh"]) -> torch.Tensor:
    """The sum over "model" of a partial result: :class:`_ReduceOut` when
    ``x`` is on the autograd tape, else an in-place ``all_reduce``."""
    if axis_group(mesh, "model") is None:
        return x
    if _taped(x):
        return _ReduceOut.apply(x, mesh)
    mesh.all_reduce(x, "model")
    return x


def gather_model(x: torch.Tensor, mesh: Optional["Mesh"], dim: int = -1) -> torch.Tensor:
    """The ranks' ``x`` joined along ``dim`` over "model":
    :class:`_GatherModel` when ``x`` is on the autograd tape, else
    :meth:`Mesh.gather`."""
    if axis_group(mesh, "model") is None:
        return x
    dim = dim % x.dim()
    if _taped(x):
        return _GatherModel.apply(x, mesh, dim)
    return mesh.gather(x, "model", dim)


def gather_data(mesh: "Mesh", shards: Sequence[torch.Tensor], dims: Sequence[int]):
    """The whole tensors of FSDP ``shards`` (each sharded over "data" along
    its entry of ``dims``), by :class:`_GatherData`: one collective each way
    for all of them. The shards must share a dtype."""
    if axis_group(mesh, "data") is None:
        return tuple(shards)
    if len({t.dtype for t in shards}) != 1:
        raise ValueError(f"gather_data takes shards of one dtype, got "
                         f"{sorted({str(t.dtype) for t in shards})}")
    return _GatherData.apply(mesh, tuple(dims), *shards)


# ---------------------------------------------------------------------------
# FSDP: the large leaves of a rank's model sharded over "data" as well
# ---------------------------------------------------------------------------

FSDP_DIM = 1  # every FSDP leaf shards its hidden dim: the in dim of a column-parallel
# kernel and of the vocab tables, the out dim (0) of a row-parallel kernel


def fsdp_dim(key: str) -> Optional[int]:
    """The dim of the parameter ``key`` (a name of a rank's model) that FSDP
    shards over "data", as ``bagel_param_specs(fsdp=True)`` places it
    (unimedvl_tpu/parallel/mesh.py), in torch's [out, in] layout: the in dim
    of the column-parallel ``q k v gate up`` of both experts
    (``P(None, d, "model")``), the out dim of the row-parallel ``o down``
    (``P(None, "model", d)``), the hidden dim of ``embed_tokens``
    (``P("model", d)``) and of the ``lm_head`` (``P(d, "model")``). None for
    every other tensor (norms, biases, everything outside the LLM)."""
    module, leaf = key.rsplit(".", 1)
    if leaf != "weight":
        return None
    if module in (EMBED, HEAD):
        return 1
    if not module.startswith("language_model.model.layers."):
        return None
    name = module.rsplit(".", 1)[1]
    base = name[: -len("_moe_gen")] if name.endswith("_moe_gen") else name
    if base in COL:
        return 1
    if base in ROW:
        return 0
    return None


def fsdp_range(key: str, shape, mesh: "Mesh") -> Optional[Ranges]:
    """The "data" rank's part of the tensor ``key`` of a rank's model under
    FSDP: (dim, [(start, length)]), or None for a tensor FSDP leaves whole. A
    dim that does not divide over "data" raises, naming the numbers, as the
    JAX placement refuses it."""
    d = fsdp_dim(key)
    if d is None:
        return None
    dp, r = mesh.shape.get("data", 1), mesh.coords.get("data", 0)
    if shape[d] % dp:
        raise ValueError(f"{key}: dim {d} of {tuple(shape)} ({shape[d]}) does not split over "
                         f"data={dp} (FSDP)")
    n = shape[d] // dp
    return d, [(r * n, n)]


def model_partial(key: str) -> bool:
    """Whether the gradient of the parameter ``key`` of a rank's model is a
    partial sum over "model": the q / k norms, one [D] weight applied to
    every head of the rank's share."""
    module = key.rsplit(".", 1)[0]
    name = module.rsplit(".", 1)[-1]
    return module.startswith("language_model.model.layers.") and name in (
        "q_norm", "k_norm", "q_norm_moe_gen", "k_norm_moe_gen")


def shard_for_training(model, mesh: "Mesh", fsdp: bool) -> None:
    """Make a rank's model of ``mesh`` the train state's own: every parameter
    is copied (a model placed with views shares the whole model's tensors,
    and a train step updates its parameters in place), and with ``fsdp`` the
    FSDP leaves (:func:`fsdp_dim`) are narrowed to this "data" rank's slice
    and marked: each decoder layer gathers its leaves at the start of its
    training body (:func:`whole_leaves`), the embedding and the lm_head
    theirs at each use (:func:`fsdp_weight`)."""
    if getattr(model, "train_sharding", None) == (id(mesh), fsdp):
        return  # already the state's own
    for name, p in model.named_parameters():
        p.data = take_ranges(p.data, fsdp_range(name, p.shape, mesh) if fsdp else None).clone()
    model.train_sharding = (id(mesh), fsdp)
    if not fsdp:
        return
    layers = model.language_model.model.layers
    for layer in layers:
        layer.fsdp_leaves = []
    prefix = "language_model.model.layers."
    for path, mod in model.named_modules():
        d = fsdp_dim(path + ".weight") if "weight" in mod._parameters else None
        if d is None:
            continue
        if path.startswith(prefix):
            layers[int(path[len(prefix):].split(".", 1)[0])].fsdp_leaves.append((mod, d))
        else:
            mod.fsdp_dim = d
        mod.fsdp_mesh = mesh


def fsdp_weight(module) -> torch.Tensor:
    """``module.weight``, whole: gathered over "data" when it is an FSDP
    shard (:func:`shard_for_training`)."""
    d = getattr(module, "fsdp_dim", None)
    if d is None:
        return module.weight
    return gather_data(module.fsdp_mesh, [module.weight], [d])[0]


@contextlib.contextmanager
def whole_leaves(layer):
    """Within the block, the FSDP leaves of ``layer`` are whole tensors
    gathered over "data" (one collective; the gradients go back to the
    shards through its backward); outside it the layer holds its shards.
    Under per-layer recomputation this runs again in the backward, so no
    whole layer lives between layers."""
    leaves = getattr(layer, "fsdp_leaves", None)
    if not leaves:
        yield
        return
    shards = [mod._parameters["weight"] for mod, _ in leaves]
    wholes = gather_data(leaves[0][0].fsdp_mesh, shards, [d for _, d in leaves])
    try:
        for (mod, _), w in zip(leaves, wholes):
            mod._parameters["weight"] = w
        yield
    finally:
        for (mod, _), p in zip(leaves, shards):
            mod._parameters["weight"] = p


# ---------------------------------------------------------------------------
# manual tensor parallelism: which part of each leaf a "model" rank holds
# ---------------------------------------------------------------------------

COL = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
ROW = ("o_proj", "down_proj")
FUSED = ("qkv_proj", "gate_up_proj")
EMBED = "language_model.model.embed_tokens"
HEAD = "language_model.lm_head"

# (dim, [(start, length), ...]): the rank's part of a tensor, the ranges joined along dim
Ranges = Tuple[int, List[Tuple[int, int]]]


@dataclasses.dataclass(frozen=True)
class HeadSplit:
    """The attention heads of one "model" rank: query heads [q0, q0 + Hl)
    and the kv heads [kv0, kv0 + Hkl) they read."""

    q0: int
    Hl: int
    kv0: int
    Hkl: int


def head_split(H: int, Hk: int, tp: int, rank: int) -> HeadSplit:
    """Rank ``rank`` of ``tp`` serves query heads [r H / tp, (r + 1) H / tp)
    and computes and caches the kv heads those read: ``Hk / tp`` of them when
    tp divides Hk, else (tp a multiple of Hk) the one head of its group,
    replicated over tp / Hk ranks, as the JAX mesh program replicates the
    cache over "model" there. Any other split raises."""
    if H % tp:
        raise ValueError(f"{H} query heads do not split over model={tp}")
    Hl = H // tp
    if Hk % tp == 0:
        return HeadSplit(rank * Hl, Hl, rank * (Hk // tp), Hk // tp)
    if tp % Hk == 0:
        return HeadSplit(rank * Hl, Hl, rank // (tp // Hk), 1)
    raise ValueError(f"{Hk} kv heads neither split over model={tp} nor divide it "
                     f"({H} query heads)")


def local_llm_config(llm, tp: int, rank: int):
    """The LLM geometry one "model" rank computes: its heads and MLP
    intermediate, at the model's head dim. The vocabulary stays whole: the
    rank's embedding and head rows are a vocab slice, gathered per call."""
    hs = head_split(llm.num_attention_heads, llm.num_key_value_heads, tp, rank)
    if llm.intermediate_size % tp:
        raise ValueError(f"MLP intermediate {llm.intermediate_size} does not split over "
                         f"model={tp}")
    return dataclasses.replace(llm, num_attention_heads=hs.Hl, num_key_value_heads=hs.Hkl,
                               intermediate_size=llm.intermediate_size // tp,
                               head_dim_override=llm.head_dim)


def vocab_range(V: int, tp: int, rank: int) -> Tuple[int, int]:
    """(first row, rows) of the vocab slice of rank ``rank``."""
    if V % tp:
        raise ValueError(f"vocab {V} does not split over model={tp}")
    return rank * (V // tp), V // tp


def _fused_ranges(widths, local, ftp: int) -> List[Tuple[int, int]]:
    """Rows of a fused leaf laid out as ``ftp`` shard blocks (each the join
    of every part's block-th column shard; ``quant._cat``) that hold the
    ``local`` (start, length) range of each part, in part order."""
    W = sum(widths)
    out: List[Tuple[int, int]] = []
    off = 0
    for w, (a, n) in zip(widths, local):
        per = w // ftp
        j = a
        while j < a + n:  # one run per shard block the range crosses
            s, within = divmod(j, per)
            take = min(per - within, a + n - j)
            start = s * (W // ftp) + off // ftp + within
            if out and out[-1][0] + out[-1][1] == start:
                out[-1] = (out[-1][0], out[-1][1] + take)
            else:
                out.append((start, take))
            j += take
        off += w
    return out


def leaf_ranges(key: str, shape, llm, tp: int, rank: int) -> Optional[Ranges]:
    """The part of the tensor ``key`` (a name of the model's state dict,
    released or quantized: ``.weight``, ``.bias``, ``.weight_q``, ``.scale``)
    that "model" rank ``rank`` of ``tp`` holds, as ``bagel_param_specs``
    places it (unimedvl_tpu/parallel/mesh.py): None for a whole tensor.

    Column-parallel leaves (``q k v gate up`` of both experts and the fused
    ``qkv`` / ``gate_up``, any shard layout) keep their output rows: the
    rank's heads (:func:`head_split`) or its intermediate slice, and the same
    columns of a per-column or group ``scale``. Row-parallel leaves (``o``,
    ``down``) keep their input columns: the packed bytes of an int4 weight
    (two in-rows a byte, so a contiguous byte range is a contiguous in
    range), the groups of a [G, N] scale (the range must be whole groups, or
    it raises with the group count; the JAX spec cannot place such a leaf
    either); a per-column scale stays whole. The embedding and the lm_head
    keep a vocab slice of rows. Norms, biases of row-parallel leaves (none in
    this model) and everything outside the LLM stay whole."""
    if tp == 1:
        return None
    module, leaf = key.rsplit(".", 1)
    shape = tuple(shape)
    if module in (EMBED, HEAD):
        if leaf == "bias":
            raise ValueError(f"{key}: a vocab-parallel head with a bias is not supported")
        return 0, [vocab_range(shape[-1] if leaf == "scale" else shape[0], tp, rank)]
    if not module.startswith("language_model.model.layers."):
        return None
    name = module.rsplit(".", 1)[1]
    base = name[: -len("_moe_gen")] if name.endswith("_moe_gen") else name
    hs = head_split(llm.num_attention_heads, llm.num_key_value_heads, tp, rank)
    D, I = llm.head_dim, llm.intermediate_size
    part = {"q_proj": (hs.q0 * D, hs.Hl * D), "k_proj": (hs.kv0 * D, hs.Hkl * D),
            "v_proj": (hs.kv0 * D, hs.Hkl * D), "gate_proj": (rank * I // tp, I // tp),
            "up_proj": (rank * I // tp, I // tp), "o_proj": (hs.q0 * D, hs.Hl * D),
            "down_proj": (rank * I // tp, I // tp)}
    col_dim = 0 if leaf in ("weight", "weight_q", "bias") else len(shape) - 1
    if base in COL:
        return col_dim, [part[base]]
    for fused in FUSED:
        if base == fused or base.startswith(fused + "_tp"):
            ftp = 1 if base == fused else int(base[len(fused) + 3:])
            if fused == "qkv_proj":
                widths = (llm.num_attention_heads * D,) + (llm.num_key_value_heads * D,) * 2
                local = [part["q_proj"], part["k_proj"], part["v_proj"]]
            else:
                widths, local = (I, I), [part["gate_proj"], part["up_proj"]]
            return col_dim, _fused_ranges(widths, local, ftp)
    if base not in ROW:
        return None
    a, n = part[base]
    K = (llm.num_attention_heads * D) if base == "o_proj" else I
    if leaf == "bias":
        raise ValueError(f"{key}: a row-parallel projection with a bias is not supported")
    if leaf == "weight":
        return 1, [(a, n)]
    if leaf == "weight_q":
        packed = shape[1] * 2 == K
        if packed and (a % 2 or n % 2):
            raise ValueError(f"{key}: in range [{a}, {a + n}) splits a packed byte")
        return 1, [(a // 2, n // 2) if packed else (a, n)]
    if leaf == "scale" and len(shape) == 2:  # group scales [G, N]: the in-range's groups
        G = shape[0]
        g = K // G
        if a % g or n % g:
            raise ValueError(
                f"{key}: {G} groups of {g} in-rows do not split over model={tp} (a row-parallel "
                f"rank holds {n} in-rows); quantize per channel, or with a group that divides "
                f"{n}")
        return 0, [(a // g, n // g)]
    return None


def take_ranges(t, ranges: Optional[Ranges]):
    """The part ``ranges`` of ``t``: ``t`` itself for None or a range that
    covers it, a view for one range, a new tensor for several (None for a
    missing tensor, a bias-free leaf's)."""
    if ranges is None or t is None:
        return t
    dim, parts = ranges
    if len(parts) == 1:
        a, n = parts[0]
        return t if (a, n) == (0, t.shape[dim]) else t.narrow(dim, a, n)
    return torch.cat([t.narrow(dim, a, n) for a, n in parts], dim=dim)


def _local_key(key: str, tp: int) -> str:
    """A fused leaf's name in a rank's model: every shard layout becomes the
    plain ``qkv_proj`` / ``gate_up_proj`` (a rank holds its own shard block,
    in part order) when tp > 1."""
    if tp == 1:
        return key
    return re.sub(r"\.(qkv_proj|gate_up_proj)_tp\d+(_moe_gen)?\.", r".\1\2.", key)


def shard_state(state: Dict[str, torch.Tensor], llm, mesh: "Mesh") -> Dict[str, torch.Tensor]:
    """The rank's part of every tensor of a whole model's state dict, under
    the names of the rank's model (:func:`_local_key`); with one "model"
    rank the tensors themselves. Quantized row-parallel weights are made
    dense (the integer matmuls and K4 read them so)."""
    tp, rank = mesh.shape.get("model", 1), mesh.coords.get("model", 0)
    if tp > 1 and any(k.endswith(".lora_a") for k in state):
        raise ValueError("a model with LoRA adapters cannot be sharded over 'model': "
                         "training.lora.merge_lora first")
    out = {}
    for key, t in state.items():
        part = take_ranges(t, leaf_ranges(key, t.shape, llm, tp, rank))
        if key.endswith(".weight_q") and part is not t:
            part = part.contiguous()
        out[_local_key(key, tp)] = part
    return out


def fused_degree(keys) -> int:
    """The shard layout of a state dict's fused leaves: 0 unfused, else N of
    ``qkv_proj_tpN`` (1 for the plain ``qkv_proj``)."""
    m = re.search(r"\.qkv_proj(_tp(\d+))?\.", " ".join(keys))
    return 0 if m is None else int(m.group(2) or 1)


class VocabParallelEmbedding(nn.Module):
    """The token embedding of one "model" rank: rows [start, start + n) of the
    table as ``weight``. A lookup takes the rank's rows (zeros for the ids of
    other ranks) and sums over "model" (:func:`reduce_out`), which gives
    every rank the whole lookup exactly (each id is found on one rank) and,
    under autograd, each rank the gradient of its own rows. The weight
    requires grad as the caller's did; under FSDP it is gathered over "data"
    at each lookup (:func:`fsdp_weight`)."""

    def __init__(self, weight: torch.Tensor, start: int, mesh: "Mesh",
                 requires_grad: bool = False):
        super().__init__()
        self.weight = nn.Parameter(weight, requires_grad=requires_grad)
        self.start = start
        self.mesh = mesh

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        w = fsdp_weight(self)
        local = ids - self.start
        mine = (local >= 0) & (local < w.shape[0])
        rows = torch.nn.functional.embedding(local.clamp(0, w.shape[0] - 1), w)
        out = torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                             device=rows.device))
        return reduce_out(out, self.mesh)


def _row_parallel(path: str) -> bool:
    name = path.rsplit(".", 1)[-1]
    return (name[: -len("_moe_gen")] if name.endswith("_moe_gen") else name) in ROW


def attach_mesh(model, mesh: "Mesh") -> None:
    """Mark a rank's model as one shard of ``mesh``: every decoder layer sums
    its attention and MLP outputs over "model", the lm_head gathers the
    vocab slices, and a row-parallel projection that quantizes its input
    takes the whole row's absmax (an all-reduce-max over "model") as the JAX
    mesh program's ``max(|x|)`` over a sharded axis does."""
    from unimedvl_tpu_torch.models.layers import QuantLinear

    lm = model.language_model
    lm.mesh = mesh
    for layer in lm.model.layers:
        layer.mesh = mesh
    if mesh.shape.get("model", 1) > 1:
        reduce_max = functools.partial(mesh.all_reduce, axis="model", op=dist.ReduceOp.MAX)
        for path, mod in lm.named_modules():
            if isinstance(mod, QuantLinear) and mod.act_quant and _row_parallel(path):
                mod.reduce_max = reduce_max


def build_rank_model(state: Dict[str, torch.Tensor], cfg, mesh: "Mesh", device, dtype,
                     quant_modes: Optional[Dict[str, str]] = None):
    """A rank's Bagel around its shard ``state`` (names and shapes as
    :func:`shard_state` gives them): the LLM built at the rank's geometry
    (:func:`local_llm_config`), a :class:`VocabParallelEmbedding`, a vocab
    slice of the lm_head, and :func:`attach_mesh`. ``model.config.llm`` is
    the rank's geometry with the whole vocabulary; the pipeline and the
    batcher size their caches from it."""
    from unimedvl_tpu_torch.weights import loader

    tp, rank = mesh.shape.get("model", 1), mesh.coords.get("model", 0)
    llm = local_llm_config(cfg.llm, tp, rank)
    v0, Vl = vocab_range(cfg.llm.vocab_size, tp, rank)
    build_cfg = dataclasses.replace(cfg, llm=dataclasses.replace(llm, vocab_size=Vl))
    modes = {_local_key(k + ".", tp)[:-1]: m for k, m in (quant_modes or {}).items()}

    def prepare(model):
        lm = model.language_model
        if tp > 1 or any(g is not None for g in mesh.groups.values()):
            weight = lm.model.embed_tokens.weight
            lm.model.embed_tokens = VocabParallelEmbedding(weight, v0, mesh,
                                                           weight.requires_grad)
        lm.vocab_start = v0

    model = loader._build(state, build_cfg, device, dtype, modes, fused_degree(state),
                          prepare=prepare)
    model.config = dataclasses.replace(cfg, llm=llm)
    model.whole_config = cfg
    attach_mesh(model, mesh)
    return model


def _quant_modes(model) -> Dict[str, str]:
    from unimedvl_tpu_torch.models.layers import QuantLinear

    return {path: mod.mode for path, mod in model.named_modules()
            if isinstance(mod, QuantLinear)}


def place_params(model, mesh: "Mesh"):
    """This rank's model of ``mesh`` from a whole Bagel (the counterpart of
    ``unimedvl_tpu/weights/bagel_loader.py::place_params``): the LLM's
    projections of both experts sharded over "model" (views of the whole
    model's tensors; a dense copy for a quantized row-parallel weight), the
    embedding and the lm_head over the vocabulary, the ViT, the VAE, the
    connector and the position tables shared whole. With one "model" rank
    every tensor is the model's own: nothing is copied. The whole model is
    left as it was, and can serve beside the placed one."""
    if "model" not in mesh.shape:
        raise ValueError(f"place_params needs a 'model' axis, got {mesh.axis_names}")
    norm = model.language_model.model.norm.weight
    state = shard_state(dict(model.state_dict(keep_vars=True)), model.config.llm, mesh)
    state = {k: v.detach() for k, v in state.items()}
    return build_rank_model(state, model.config, mesh, norm.device, norm.dtype,
                            _quant_modes(model))


def stream_range(mesh: "Mesh", n_streams: int) -> Tuple[int, int]:
    """(first, count) of the ``n_streams`` streams (KV-cache slots, CFG
    streams) this rank runs: a contiguous share over "data" when the data
    degree divides them, as the JAX package shards them there, else all of
    them on every data rank. The one place of this rule: the batcher's slots,
    the grouped denoise's streams and :func:`kv_cache_spec` take it here."""
    dp, d = mesh.shape.get("data", 1), mesh.coords.get("data", 0)
    if n_streams % dp:
        return 0, n_streams
    return d * (n_streams // dp), n_streams // dp


def kv_head_range(cfg, mesh: "Mesh") -> Tuple[int, int]:
    """(first, count) of the kv heads of the whole model ``cfg`` that this
    "model" rank computes and caches (:func:`head_split`)."""
    hs = head_split(cfg.llm.num_attention_heads, cfg.llm.num_key_value_heads,
                    mesh.shape.get("model", 1), mesh.coords.get("model", 0))
    return hs.kv0, hs.Hkl


def kv_cache_spec(cfg, mesh: "Mesh", n_streams: int) -> Dict[str, object]:
    """How a KV cache of ``n_streams`` of the whole model ``cfg`` shards on
    ``mesh``, as the JAX package's ``kv_cache_spec`` / ``_cache_spec`` read:
    streams over "data" (:func:`stream_range`), kv heads over "model"
    (:func:`kv_head_range`). ``{"streams": (first, count), "kv_heads":
    (first, count)}`` for this rank."""
    return {"streams": stream_range(mesh, n_streams), "kv_heads": kv_head_range(cfg, mesh)}


def shard_kv_heads(cache, cfg, mesh: "Mesh"):
    """This "model" rank's kv heads of a ``KVCache`` built by the whole model
    ``cfg`` (values and scales, as views; every stream kept)."""
    h0, nh = kv_head_range(cfg, mesh)
    heads = lambda t: None if t is None else t[:, :, h0:h0 + nh]  # noqa: E731
    return dataclasses.replace(cache, k=heads(cache.k), v=heads(cache.v),
                               k_scale=heads(cache.k_scale), v_scale=heads(cache.v_scale))


def shard_cache(cache, cfg, mesh: "Mesh"):
    """This rank's part of a whole ``KVCache`` (:func:`kv_cache_spec`), as
    views: its streams and its kv heads of values and scales."""
    s0, ns = stream_range(mesh, cache.k.shape[1])
    cache = shard_kv_heads(cache, cfg, mesh)
    streams = lambda t: None if t is None else t[:, s0:s0 + ns]  # noqa: E731
    return dataclasses.replace(
        cache, k=streams(cache.k), v=streams(cache.v), lens=cache.lens[s0:s0 + ns],
        k_scale=streams(cache.k_scale), v_scale=streams(cache.v_scale))


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
