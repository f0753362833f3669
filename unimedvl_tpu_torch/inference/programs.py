"""Device programs: the port's counterpart of the JAX package's compiled loops
(``jax.jit`` around ``lax.while_loop`` / ``lax.scan``), as captured CUDA
graphs.

A program is one step body over static buffers: the loop state lives on the
device (a 0-dim int32 step counter, the current tokens, positions, finished
flags, the output tokens, the flow state ``x_t``, a cache's ``lens``), and
the loop's exit test is computed there too (``go``), gating every state
update, so a replay past the exit changes nothing the caller reads. The
bodies live beside their eager loops (``models/bagel.py``: the chat decode
and the flow step; ``inference/serving.py``: the batcher's decode chunks);
this module holds what they share:

- :class:`Graph`, one step body. On a CUDA device its first replay warms
  the body up on a side stream (library loads, ``cudaFuncSetAttribute``, the
  per-card buffers such as K4's arrival counters happen outside capture),
  puts the state back as it was, and captures the body into one memory pool
  shared by every program (``torch.cuda.graph_pool_handle()``); later
  replays launch the graph. On a CPU tensor a replay calls the same body on
  the same buffers: the plain route the CPU tests run. A capture or replay
  error raises; nothing falls back to the eager loop. A body that samples
  names its ``torch.Generator``: the warm-up's draws are put back, and the
  generator is registered with the graph
  (``CUDAGraph.register_generator_state``), so that every replay draws
  from its state and advances it as the eager step would, and eager draws
  between replays (the image noise of an inferencer's one generator) go on
  from there.
- The registry (:func:`lookup`): programs keyed by what they run (program,
  streams, capacity, the cache's dtype and bits, the chunk flavour, the
  options baked into the body) and by the storage their graphs read (the
  weights: every parameter's and buffer's data pointer, shape and dtype,
  :func:`weights_key`; a cache that the program does not copy into buffers of
  its own). What replaces storage drops the programs that read it
  (:func:`drop_reading`: ``quant.quantize_llm_params``,
  ``fuse_serving_projections``, ``serving.repack_pool``,
  ``InterleaveInferencer._ensure_capacity``, ``training.lora.add_lora`` and
  ``merge_lora``); a key
  whose storage changed no longer matches and is captured anew. At most
  ``MAX_PROGRAMS`` stay, and ``FAMILY_LIMITS`` of a family (the batcher's
  admission blocks), the least recently used dropped first.
- Launch counts. A kernel wrapper counts its launches in Python; a replay
  runs no Python, so each graph records what its capture added to the
  counters (``COUNTER_MODULES``), puts the counters back as they were before
  the warm-up, and adds that record at every replay. ``listeners`` are
  called at every captured replay with the graph (its ``kind``: "decode"
  for a T = 1 forward of a decode loop, "chunk" for a step of a batcher's
  chunk, "verify" for a speculative verify forward, "denoise" for a flow
  step, "prefill" for a context build or an admission block, whose
  ``forwards`` say what it ran); :func:`capturing` is true during a warm-up
  and a capture, so that forward hooks can tell those calls from the
  path's.
- :func:`static_buffer`: the caches (and draft histories) that programs copy
  their caller's into, one per shape, dtype and width, shared by every
  program that copies in at each call.

The prefills (``bagel.PrefillProgram``: the text, ViT and VAE context
builds, the VAE encode and decode, the batcher's admission blocks) are
programs of one graph and no loop: their inputs, row counts and rope
positions included, are copied into static buffers at every call.

A rank's model of a mesh (``parallel.mesh``) runs the same programs when
every group of its mesh is NCCL (:func:`use_graphs`): ProcessGroupNCCL
issues a collective on a stream of its own, joined to the caller's by
events, which a capture records as edges of the graph, so each graph holds
its step's all-reduces and gathers beside the kernels. A communicator is
created at its group's first collective, which a capture cannot do: the
warm-up, which runs the whole body, runs every collective once before.
A program's key holds the mesh (:func:`mesh_key`), and a graph records the
collectives a replay runs (``parallel.mesh.counts``) as it records
launches; ``stats["collective_captures"]`` counts the captures that hold
any. The sequence-parallel denoise's flow step is
``parallel.sp_denoise.SPProgram``.

The training steps (``training.trainer.TrainProgram``, and
``PipelineProgram`` for the pipeline-parallel step) are programs whose
graphs are ``Graph(training=True)``: the warm-up is the call's real work (a
"train" graph's first run is the sequence it is given, an "update" graph's
the call's update), so nothing is put back and the capture only records;
the allocator's cached blocks are returned between the two, so that a
step's activations are not held twice; and they share a pool of their own
(``pool_bytes(pool="train")``), freed with the step.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
import weakref
from typing import Callable, Dict, Iterable, List, Optional

import torch
from torch import nn

#: modules whose ``*counts`` dicts count kernel launches
COUNTER_MODULES = ("act_quant", "decode_attention", "flash_attention", "flash_attention_train",
                   "w4_matmul")
MAX_PROGRAMS = 24
#: programs kept of a ``family`` (:func:`lookup`): the batcher's admission
#: blocks each hold a block cache of their own (a 980 px group of four in
#: bf16: 0.6 GB); a training step's buckets (``training.trainer``) each hold a
#: graph of a forward and a backward
FAMILY_LIMITS = {"admission": 8, "train": 8}

#: called as fn(graph) at every captured replay
listeners: List[Callable[["Graph"], None]] = []

_state = threading.local()
_lock = threading.RLock()
_registry: "collections.OrderedDict[tuple, object]" = collections.OrderedDict()
_pools: Dict[tuple, object] = {}  # (device index, pool name) -> graph pool handle
_pool_users: Dict[tuple, int] = {}
_streams: Dict[int, object] = {}
_static: "weakref.WeakValueDictionary[tuple, object]" = weakref.WeakValueDictionary()
#: graphs captured in this process, those of them that hold collectives (a model on an
#: NCCL mesh), the seconds their warm-ups and captures took (the card waited for at both
#: ends), and the largest the shared pool and the training pool have been after a capture
stats = {"captures": 0, "collective_captures": 0, "capture_s": 0.0, "pool_bytes_max": 0,
         "train_pool_bytes_max": 0}


def capturing() -> bool:
    """True while a graph's warm-up or capture runs its body on this thread."""
    return getattr(_state, "capturing", False)


def _meshes(model: Optional[nn.Module], mesh) -> list:
    """The meshes a call runs over: the model's (a rank's model of a mesh,
    ``parallel.mesh.attach_mesh``) and ``mesh`` (the sequence-parallel
    denoise's, which a whole model at one "model" rank does not carry)."""
    found = [] if model is None else [getattr(model.language_model, "mesh", None)]
    return [m for m in found + [mesh] if m is not None]


def use_graphs(graphs: Optional[bool], device: torch.device, model: Optional[nn.Module],
               mesh=None) -> bool:
    """Whether a loop runs as its program: ``graphs`` None takes the program
    on a CUDA device and the eager loop elsewhere; True the program on any
    device (its plain route on the CPU); False the eager loop. Within
    :func:`eager`, None takes the eager loop.

    On a mesh (the model's, or ``mesh``) the program's graph captures the
    collectives with the kernels when every group is NCCL, which runs on
    the card's streams: the rule above holds as it is. A gloo group stages
    a CUDA tensor through the host, which a graph cannot capture: on a CUDA
    device such a mesh takes the eager loop, and True raises naming the
    backend. On the CPU, True takes the program's plain route on any
    mesh."""
    meshes = _meshes(model, mesh)
    if device.type == "cuda" and not all(m.capturable for m in meshes):
        if graphs:
            blocked = {a: b for m in meshes for a, b in m.backends().items() if b != "nccl"}
            raise ValueError(
                "graphs=True: a CUDA graph captures NCCL collectives only; this mesh's "
                + ", ".join(f"{a!r} axis runs over {b}" for a, b in sorted(blocked.items()))
                + " (the eager route, graphs=None or False, runs it)")
        return False
    if graphs is None:
        return device.type == "cuda" and not getattr(_state, "eager", False)
    return bool(graphs)


def mesh_key(model: Optional[nn.Module], mesh=None) -> tuple:
    """What a program's key holds of the meshes it runs over (the model's
    and ``mesh``): each one's axes and sizes, this rank, and its groups (a
    graph replays the communicators it captured)."""
    return tuple((m.axis_names, tuple(m.shape[a] for a in m.axis_names), m.rank,
                  tuple(None if m.groups[a] is None else id(m.groups[a]) for a in m.axis_names))
                 for m in _meshes(model, mesh))


@contextlib.contextmanager
def plain_bodies():
    """Within the block, on this thread, a :class:`Graph` on a CUDA device
    runs its body directly instead of capturing or replaying it: the
    program's own computation over its own buffers, launched op by op (what
    a captured graph is held to, bit for bit)."""
    before = getattr(_state, "plain", False)
    _state.plain = True
    try:
        yield
    finally:
        _state.plain = before


@contextlib.contextmanager
def eager():
    """Within the block, on this thread, ``graphs=None`` takes the eager
    loops: for code that swaps module functions for others (plain versions,
    taps, recorders), which a captured graph would not see (it replays the
    kernels it captured). An explicit ``graphs=True`` still takes the
    program."""
    before = getattr(_state, "eager", False)
    _state.eager = True
    try:
        yield
    finally:
        _state.eager = before


def weights_key(*modules: nn.Module) -> tuple:
    """(name, data pointer, shape, dtype) of every parameter and buffer of
    ``modules``: the storage a captured body reads. Quantizing, fusing,
    loading into new tensors or adding adapters changes it."""
    key = []
    for m in modules:
        for name, t in m.named_parameters():
            key.append((name, t.data_ptr(), tuple(t.shape), t.dtype))
        for name, t in m.named_buffers():
            key.append((name, t.data_ptr(), tuple(t.shape), t.dtype))
    return tuple(key)


def tensors_key(tensors: Iterable[Optional[torch.Tensor]]) -> tuple:
    """(data pointer, shape, strides, dtype) of each tensor (None kept)."""
    return tuple(None if t is None else (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                 for t in tensors)


def _pointer_set(sources) -> set:
    """The data pointers of ``sources``: modules (their parameters and
    buffers), tensors, or iterables of tensors; None is skipped."""
    ptrs = set()
    for s in sources:
        if s is None:
            continue
        if isinstance(s, nn.Module):
            ptrs.update(t.data_ptr() for t in s.parameters())
            ptrs.update(t.data_ptr() for t in s.buffers())
        elif isinstance(s, torch.Tensor):
            ptrs.add(s.data_ptr())
        else:
            ptrs.update(t.data_ptr() for t in s if t is not None)
    ptrs.discard(0)  # an empty or meta tensor holds no storage
    return ptrs


def lookup(key: tuple, build: Callable[[], object], reads: Iterable = (), owner=None,
           family: Optional[str] = None):
    """The program of ``key``, built by ``build()`` at its first use and
    recorded as reading the storage of ``reads`` (as :func:`drop_reading`
    takes it); dropped when ``owner`` (the module it runs, which a program
    holds only weakly) is collected, and, the least recently used first,
    beyond ``MAX_PROGRAMS``, or beyond ``FAMILY_LIMITS[family]`` programs of
    its ``family``."""
    with _lock:
        prog = _registry.get(key)
        if prog is not None:
            _registry.move_to_end(key)
            return prog
    prog = build()
    prog.reads = _pointer_set(reads)
    prog.family = family
    if owner is not None:
        weakref.finalize(owner, _drop_if_current, key, id(prog))
    with _lock:
        _registry[key] = prog
        while len(_registry) > MAX_PROGRAMS:
            _release(_registry.popitem(last=False)[1])
        kin = [k for k, p in _registry.items() if family is not None and p.family == family]
        for k in kin[:max(0, len(kin) - FAMILY_LIMITS.get(family, len(kin)))]:
            _release(_registry.pop(k))
    return prog


def _drop_if_current(key: tuple, prog_id: int) -> None:
    with _lock:
        prog = _registry.get(key)
        if prog is not None and id(prog) == prog_id:
            _release(_registry.pop(key))


def _release(prog) -> None:
    for g in prog.graphs():
        g.reset()
        g.body = None  # the graph's body holds its program: free both without the cycle GC
    if hasattr(prog, "release"):  # what else it holds (a training step's gradients)
        prog.release()


def static_buffer(key: tuple, make: Callable[[], object]):
    """A buffer shared by the programs that ask for it under ``key`` (a
    cache of one shape, which each program copies its caller's into at every
    call); kept while a program holds it."""
    with _lock:
        buf = _static.get(key)
        if buf is None:
            buf = make()
            _static[key] = buf
        return buf


def model_ref(model: nn.Module):
    """A weak reference to ``model`` for a program's body: a program must not
    keep the weights alive (its ``lookup`` owner drops it with them)."""
    ref = weakref.ref(model)

    def get():
        m = ref()
        if m is None:
            raise RuntimeError("the model of this device program was freed")
        return m
    return get


def drop_reading(*sources) -> int:
    """Drop every program that reads the storage of ``sources`` (modules,
    tensors, or iterables of tensors). Returns how many were dropped."""
    ptrs = _pointer_set(sources)
    with _lock:
        stale = [k for k, p in _registry.items() if p.reads & ptrs]
        for k in stale:
            _release(_registry.pop(k))
    return len(stale)


def drop_all() -> None:
    with _lock:
        while _registry:
            _release(_registry.popitem()[1])


def programs() -> list:
    """The live programs, least recently used first."""
    with _lock:
        return list(_registry.values())


def pool_bytes(device: Optional[torch.device] = None, pool: str = "shared") -> Optional[int]:
    """The bytes the graph pool ``pool`` ("shared": the inference programs';
    "train": the training steps') reserves on ``device`` (the current CUDA
    device by default), from the allocator's snapshot; None when no graph
    of it was captured there."""
    index = None if device is None else torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    pool = _pools.get((index, pool))
    if pool is None:
        return None
    want = tuple(pool) if isinstance(pool, (tuple, list)) else pool
    total = 0
    for seg in torch.cuda.memory_snapshot():
        got = seg.get("segment_pool_id")
        if seg.get("device") == index and got is not None and tuple(got) == want:
            total += seg["total_size"]
    return total


def _pool(key: tuple):
    """The pool ``key`` (device index, pool name), counted as used by one
    more graph. The allocator frees a pool once no graph uses it, and a
    capture into a freed pool's handle fails, so a pool whose graphs are all
    reset is forgotten and the next capture takes a new one."""
    with _lock:
        if key not in _pools:
            with torch.cuda.device(key[0]):
                _pools[key] = torch.cuda.graph_pool_handle()
            _pool_users[key] = 0
        _pool_users[key] += 1
        return _pools[key]


def _capture_stream(device: torch.device):
    """The one side stream of ``device`` on which every graph warms up and is
    captured. The allocator keeps a freed block for the stream it was used
    on, so one stream lets each capture reuse the pool's blocks and each
    warm-up the last one's, where a stream per capture would strand them."""
    with _lock:
        if device.index not in _streams:
            _streams[device.index] = torch.cuda.Stream(device)
        return _streams[device.index]


def _unpool(key: tuple) -> None:
    with _lock:
        _pool_users[key] -= 1
        if _pool_users[key] == 0:
            del _pools[key], _pool_users[key]


def _counter_dicts() -> list:
    """The kernels' launch counters, and last the mesh's collective counter."""
    import importlib

    from unimedvl_tpu_torch.parallel import mesh as pmesh

    out = []
    for name in COUNTER_MODULES:
        mod = importlib.import_module(f"unimedvl_tpu_torch.ops.{name}")
        out.extend(v for k, v in vars(mod).items() if k.endswith("counts") and isinstance(v, dict))
    return out + [pmesh.counts]


def _snapshot(dicts) -> list:
    return [dict(d) for d in dicts]


class Graph:
    """One step body over static buffers (see the module's docstring).
    ``keep``: the state tensors the warm-up changes and that are put back
    before the capture; ``generators``: those the body draws from, whose
    state the warm-up's draws are taken back from and which the graph
    registers; ``rows`` is told to the listeners (the streams of a step);
    ``forwards``, of a "prefill" graph, the forwards one replay runs (``vit``:
    ViT forwards, ``prefill``: LLM block forwards, ``gen``: those of them in
    gen mode), for listeners that count forwards.

    ``training``: a training step's graph (see the module's docstring): the
    warm-up is the first call's real work (nothing is put back, its
    launches count, and the call that captures replays nothing), the
    allocator's cached blocks are returned before the capture, and the
    graph goes into the "train" pool."""

    def __init__(self, kind: str, body: Callable[[], None], device: torch.device,
                 keep: Iterable[torch.Tensor] = (), rows: int = 0,
                 generators: Iterable[torch.Generator] = (),
                 forwards: Optional[Dict[str, int]] = None, training: bool = False):
        self.kind, self.body, self.device = kind, body, device
        self.training = training
        self.pool = "train" if training else "shared"
        self.keep = list(keep)
        self.generators = list(generators)
        self.rows = rows
        self.forwards = dict(forwards or {})
        self.graph = None
        self.launches: list = []  # (counter dict, key, launches) added by one replay
        self.collectives = 0  # the collectives one replay runs (``parallel.mesh.counts``)

    def replay(self) -> None:
        if self.device.type != "cuda" or getattr(_state, "plain", False):
            self.body()
            return
        if self.graph is None:
            self._capture()
            if self.training:  # the warm-up was this call's work
                for fn in listeners:
                    fn(self)
                return
        self.graph.replay()
        for d, k, n in self.launches:
            d[k] += n
        for fn in listeners:
            fn(self)

    def reset(self) -> None:
        if self.graph is not None:
            self.graph.reset()
            self.graph = None
            _unpool(self._pool_key)

    def _capture(self) -> None:
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        dicts = _counter_dicts()
        before = _snapshot(dicts)
        saved = [t.clone() for t in self.keep]
        drawn = [g.get_state() for g in self.generators]
        main = torch.cuda.current_stream(self.device)
        side = _capture_stream(main.device)
        _state.capturing = True
        try:
            side.wait_stream(main)
            with torch.cuda.stream(side):
                self.body()  # warm-up: lazy loads and per-card buffers, outside capture
                for t, s in zip(self.keep, saved):
                    t.copy_(s)
            main.wait_stream(side)
            for g, s in zip(self.generators, drawn):
                g.set_state(s)
            mid = _snapshot(dicts)
            if self.training:
                torch.cuda.synchronize(self.device)
                torch.cuda.empty_cache()
            graph = torch.cuda.CUDAGraph()
            for g in self.generators:
                graph.register_generator_state(g)
            key = (side.device.index, self.pool)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                graph.capture_begin(pool=_pool(key), capture_error_mode="thread_local")
                try:
                    self.body()
                finally:
                    try:
                        graph.capture_end()
                    finally:
                        self._pool_key = key
            main.wait_stream(side)
            after = _snapshot(dicts)
        finally:
            _state.capturing = False
        self.launches = [(d, k, after[i][k] - mid[i][k]) for i, d in enumerate(dicts)
                         for k in d if after[i][k] != mid[i][k]]
        self.collectives = after[-1]["collectives"] - mid[-1]["collectives"]
        for d, b in zip(dicts, mid if self.training else before):
            d.update(b)
        self.graph = graph
        torch.cuda.synchronize(self.device)
        stats["captures"] += 1
        stats["collective_captures"] += bool(self.collectives)
        stats["capture_s"] += time.perf_counter() - t0
        name = "pool_bytes_max" if self.pool == "shared" else f"{self.pool}_pool_bytes_max"
        stats[name] = max(stats.get(name, 0), pool_bytes(self.device, self.pool) or 0)
