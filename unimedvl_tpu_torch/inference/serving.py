"""Continuous batching for batched VQA, report and image serving (port of
unimedvl_tpu/inference/serving.py; BASELINE config 3).

A pool of S slots over one multi-stream ``KVCache`` on the model's device.
Requests are admitted into free slots by grouped prefills into small
P-stream blocks (:func:`image_text_block`: ``bagel.prefill_vit_group`` for
images of one bucket, P padded to a power of two, and their text;
:func:`text_block`: a [P, T] text prefill, an optional shared preamble
seeded into the block), each stored into the pool with one indexed copy per
array (:func:`group_store`).
Decoding runs in chunks of up to K greedy steps between host reads: the
aligned chunk (:func:`decode_chunk_aligned`: every stream writes step d at
one column, then the band moves back to each stream's tail) or, near
capacity, the scatter chunk (:func:`decode_chunk`: each stream writes at its
own ``lens[s]``); both attend through K2, or K2-int8 over an int8 pool or an
int4 one (``kv_bits=4``: values packed two a byte, a layer's slice unpacked
to int8 for the kernel); the pool moves carry packed arrays unchanged. A
chunk ends early once every active slot has emitted eos; a slot that
finishes mid-chunk wastes the chunk's remaining steps, and its row is reused,
lens rewritten, at the next admission. With the pool ladder the pool shrinks
to the rung that fits the live slots and the backlog (:func:`repack_pool`),
and grows a rung ahead of admission. With ``spec_decode`` every chunk is a
speculative one (:func:`decode_chunk_spec`): prompt-lookup drafts from each
slot's id history, verified k + 1 at a time through K1a, greedy-exact per
slot; the chunk flavours share the pending-token contract, so they interleave.

With a ``pipeline`` (an ``InterleaveInferencer`` over the same model) the
engine also serves text-to-image requests (``Request(image_size=...)``):
each becomes a ``pipeline.GenImageJob`` with the interleave-inference
context recipe, up to ``gen_group`` compatible jobs (one geometry, the same
options) merge into one grouped job whose images share each step's forward,
and every round runs one segment of ``gen_chunk`` flow steps beside its
decode chunk, so text and image requests share the card.

With ``mesh`` (a ``parallel.mesh.Mesh`` with the axes ("data", "model"))
every rank runs the same batcher on the same requests and holds its shard of
the model (``parallel.mesh.place_params``): heads and MLP intermediate over
"model", the pool's kv heads with them. The slots shard over "data" when the
data axis divides them (else every data rank holds the whole pool): each data
rank prefills, stores and decodes its own slots, and after every chunk the
per-slot results the host reads (tokens, and a speculative chunk's counts,
finished flags, last tokens and positions) are gathered over "data", so the
host state, ``errors`` and ``stats`` are the same on every rank.

The port writes the pool in place where the JAX package donates it. Where
the JAX package has a jitted chunk ``while_loop``, the port runs a captured
device program on the card (:class:`ChunkProgram`, ``inference/programs.py``):
one graph a step, the loop state and the exit test on the device, one host
read a chunk; the speculative chunks likewise (``bagel.SpecProgram``: one
graph a verify forward), and each admission block (``bagel.PrefillProgram``:
one graph a block shape); ``graphs=False`` takes the eager loops and
prefills, one host check a step or a verify forward. The batcher decodes greedily; the chunks
also sample (``do_sample``). Not here: the compiled denoise windows
(``gen_window_dynamic``), which ``step_range`` replaces.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from unimedvl_tpu_torch.models import bagel
from unimedvl_tpu_torch.models import qwen2_mot as mot
from unimedvl_tpu_torch.models.bagel import Bagel
from unimedvl_tpu_torch.models.qwen2_mot import KVCache


def _arrays(cache: KVCache):
    """The cache's value and scale arrays (the scales only when int8)."""
    return [cache.k, cache.v] + ([cache.k_scale, cache.v_scale] if cache.quantized else [])


def group_store(cache: KVCache, block: KVCache, slots: np.ndarray) -> KVCache:
    """Store a P-stream block (capacity Tc, from column 0) into the pool's
    rows ``slots``, in place: one indexed copy per array. ``slots[i] >= S``
    marks a padding row of the group, left out on the host (the JAX
    package's ``mode="drop"``). Returns the pool with the stored rows' lens."""
    slots = np.asarray(slots)
    keep = np.nonzero(slots < cache.k.shape[1])[0]
    if len(keep) == 0:
        return cache
    dev = cache.k.device
    rows = torch.from_numpy(slots[keep].astype(np.int64)).to(dev)
    src = torch.from_numpy(keep.astype(np.int64)).to(dev)
    Tc = block.capacity
    for dst, blk in zip(_arrays(cache), _arrays(block)):
        dst[:, rows, :, :Tc] = blk.index_select(1, src).to(dst.dtype)
    lens = cache.lens.clone()
    lens[rows] = block.lens.index_select(0, src).to(lens.dtype)
    return dataclasses.replace(cache, lens=lens)


def repack_pool(cache: KVCache, perm) -> KVCache:
    """Gather slot rows into a new pool of ``len(perm)`` rows: new slot i
    takes old slot ``perm[i]``; ``perm[i] < 0`` gives a fresh row (lens 0,
    stale values, never attended). The ladder's move: once most requests
    have finished, the live rows go to a prefix of a smaller pool, so a
    chunk's per-slot work (cache reads, activation rows) follows the work
    left; it grows back a rung ahead of admission."""
    from unimedvl_tpu_torch.inference import programs

    programs.drop_reading(_arrays(cache))  # the chunk programs of the pool it replaces
    perm = torch.as_tensor(np.asarray(perm), dtype=torch.int64).to(cache.k.device)
    src = perm.clamp_min(0)
    lens = torch.where(perm >= 0, cache.lens.index_select(0, src), 0).to(cache.lens.dtype)

    def take(t):
        return None if t is None else t.index_select(1, src)

    return dataclasses.replace(cache, k=take(cache.k), v=take(cache.v), lens=lens,
                               k_scale=take(cache.k_scale), v_scale=take(cache.v_scale))


def seed_prefix_block(block: KVCache, prefix: KVCache, tp) -> KVCache:
    """Copy a 1-stream prefix cache into the leading columns of every row of
    a fresh admission block, in place (values, and scales for an int8
    cache): the shared preamble, prefilled once, instead of once per request.
    ``tp``: the preamble's valid length (a host int or a 0-dim device
    tensor), which becomes every row's lens; columns past it hold the prefix
    block's padding and are overwritten by the suffix prefill before
    anything attends to them."""
    Mp = prefix.capacity
    for dst, src in zip(_arrays(block), _arrays(prefix)):
        dst[:, :, :, :Mp] = src.to(dst.dtype)  # broadcast over the block's rows
    lens = torch.zeros_like(block.lens) + tp
    return dataclasses.replace(block, lens=lens)


def _zeroed(block: KVCache) -> KVCache:
    """``block``'s arrays zeroed in place, with lens 0: a fresh block, as
    ``KVCache.create`` makes it, in storage a program keeps."""
    for t in _arrays(block):
        t.zero_()
    return dataclasses.replace(block, lens=torch.zeros_like(block.lens))


def _image_text_block(model: Bagel, block: KVCache, patch_tokens, vit_pos_ids, n_tokens,
                      start_end_ids, rope_pos, token_ids=None, positions=None,
                      valid=None) -> KVCache:
    block = bagel._prefill_vit_rows(model, _zeroed(block), patch_tokens, vit_pos_ids, n_tokens,
                                    start_end_ids, rope_pos)
    if token_ids is None:
        return block
    return bagel._prefill_text(model, block, token_ids, positions, valid)


def _block_maker(model: Bagel, P: int, capacity: int, device, kv_dtype, quantized: bool,
                 kv_bits: int):
    llm = model.config.llm
    return lambda: KVCache.create(llm.num_hidden_layers, P, capacity, llm.num_key_value_heads,
                                  llm.head_dim, kv_dtype, device=device, quantized=quantized,
                                  kv_bits=kv_bits)


@torch.no_grad()
def image_text_block(
    model: Bagel,
    patch_tokens: torch.Tensor,  # [P, Tb, p*p*3] padded to one shared bucket
    vit_pos_ids: torch.Tensor,  # [P, Tb]
    n_tokens: torch.Tensor,  # [P]; 0 = inactive row
    start_end_ids: torch.Tensor,  # [2]
    token_ids: Optional[torch.Tensor] = None,  # [P, T_max], the text after each image
    positions: Optional[torch.Tensor] = None,  # [P, T_max]
    valid: Optional[torch.Tensor] = None,  # [P, T_max] bool
    capacity: Optional[int] = None,
    kv_dtype: torch.dtype = torch.bfloat16,
    quantized: bool = False,
    kv_bits: int = 8,
    graphs: Optional[bool] = None,
) -> KVCache:
    """An image admission block: ``bagel.prefill_vit_group`` of P images
    (rope 0) into a block of ``capacity`` columns (default Tb + 2), then,
    with ``token_ids``, their text appended into the same block
    (``bagel.prefill_text``; rope 1 on, the caller's ``positions``).
    ``graphs`` (``inference.programs.use_graphs``): by default, on a CUDA
    device, a ``bagel.PrefillProgram`` keyed by (P, bucket, T_max, the
    block's kind), which zeroes and fills a block of its own and returns it
    (valid until its next call: store it at once); ``graphs=False`` the
    eager functions into a new block."""
    P, Tb = patch_tokens.shape[:2]
    kind = (P, Tb + 2 if capacity is None else capacity, kv_dtype, quantized, kv_bits)
    inputs = dict(patch_tokens=patch_tokens, vit_pos_ids=vit_pos_ids, n_tokens=n_tokens,
                  start_end_ids=start_end_ids,
                  rope_pos=torch.zeros((P,), dtype=torch.int64, device=patch_tokens.device))
    if token_ids is not None:
        inputs.update(token_ids=token_ids, positions=positions, valid=valid)
    return bagel._prefill("admit_image", model, _image_text_block, bagel._vit_modules(model),
                          inputs, None, graphs, "block",
                          dict(vit=1, prefill=1 + (token_ids is not None)), bake=kind,
                          block=_block_maker(model, *kind[:2], patch_tokens.device, *kind[2:]),
                          family="admission")


def _text_block(model: Bagel, block: KVCache, token_ids, positions, valid, prefix_len=None,
                **prefix) -> KVCache:
    block = _zeroed(block)
    if prefix:
        pfx = KVCache(k=prefix["prefix_k"], v=prefix["prefix_v"], lens=block.lens[:1],
                      k_scale=prefix.get("prefix_k_scale"), v_scale=prefix.get("prefix_v_scale"),
                      kv_bits=block.kv_bits)
        block = seed_prefix_block(block, pfx, prefix_len)
    return bagel._prefill_text(model, block, token_ids, positions, valid)


@torch.no_grad()
def text_block(
    model: Bagel,
    token_ids: torch.Tensor,  # [P, T_max]
    positions: torch.Tensor,  # [P, T_max]
    valid: torch.Tensor,  # [P, T_max] bool
    capacity: int,
    prefix: Optional[KVCache] = None,
    prefix_len=None,
    kv_dtype: torch.dtype = torch.bfloat16,
    quantized: bool = False,
    kv_bits: int = 8,
    graphs: Optional[bool] = None,
) -> KVCache:
    """A text admission block of ``capacity`` columns: with ``prefix`` (a
    1-stream preamble cache, valid for ``prefix_len`` columns) its leading
    columns seeded by :func:`seed_prefix_block`, then the [P, T_max]
    prefill. ``graphs`` as for :func:`image_text_block`: a program per
    (P, T_max, the preamble's width, the block's kind); the preamble is
    copied into its buffers at every call."""
    P = token_ids.shape[0]
    kind = (P, capacity, kv_dtype, quantized, kv_bits)
    inputs = dict(token_ids=token_ids, positions=positions, valid=valid)
    if prefix is not None:
        inputs.update(prefix_len=prefix_len, prefix_k=prefix.k, prefix_v=prefix.v)
        if prefix.quantized:
            inputs.update(prefix_k_scale=prefix.k_scale, prefix_v_scale=prefix.v_scale)
    return bagel._prefill("admit_text", model, _text_block, (model.language_model,), inputs,
                          None, graphs, "block", dict(prefill=1), bake=kind,
                          block=_block_maker(model, P, capacity, token_ids.device, *kind[2:]),
                          family="admission")


def _step_logits(model: Bagel, cache: KVCache, cur: torch.Tensor, pos: torch.Tensor, **kw):
    """One decode step of every stream, ``kw`` the forward's options (from
    :func:`_scatter_kw` or :func:`_aligned_kw`); (logits [S, V] fp32, cache)."""
    lm = model.language_model
    x = mot.embed_tokens(lm, cur)[:, None, :]
    h, cache = lm.model(x, pos[:, None], cache, causal=True, **kw)
    return mot.lm_head(lm, h[:, 0]), cache


def _step(model: Bagel, cache: KVCache, cur: torch.Tensor, pos: torch.Tensor, sampler=None,
          **kw):
    """One decode step of every stream, greedy or by ``sampler`` (``(do_sample,
    temperature, generator)``, as ``bagel._next_token`` takes them); (next
    tokens [S] int32, cache)."""
    logits, cache = _step_logits(model, cache, cur, pos, **kw)
    return bagel._next_token(logits, *(sampler or (False, 1.0, None))), cache


def _scatter_kw(active: torch.Tensor):
    """The forward's options of :func:`decode_chunk`'s step i: each stream
    written at its own lens[s], only the active rows valid."""
    q_valid = active.to(torch.bool)[:, None]
    return lambda i: dict(q_valid=q_valid)


def _aligned_kw(cache: KVCache, active: torch.Tensor):
    """(base, the forward's options of :func:`decode_chunk_aligned`'s step
    i): step i writes every stream at column base + i, base the largest lens
    of an ACTIVE slot (a freed slot's stale lens must not push the band up)."""
    base = torch.where(active.to(torch.bool), cache.lens, 0).max().to(torch.int32)
    return base, lambda i: dict(decode_cols=(base, base + i))


@torch.no_grad()
def _chunk(model, cache, cur_tokens, positions, active, num_steps, eos, step_kw, sampler):
    """The eager loop both chunk flavours share, the plain version of
    :class:`ChunkProgram`: up to ``num_steps`` steps, ``step_kw(i)`` the
    forward's options of step i, one host read a step. Returns (tokens
    [S, K] zero-filled past the exit, last [S], positions [S], cache, steps
    run)."""
    S = cur_tokens.shape[0]
    dev = cur_tokens.device
    buf = torch.zeros((S, num_steps), dtype=torch.int32, device=dev)
    cur = cur_tokens.to(torch.int32)
    pos = positions.to(torch.int64)
    done = ~active  # inactive slots count as finished for the early exit
    n = 0
    while n < num_steps:
        cur, cache = _step(model, cache, cur, pos, sampler, **step_kw(n))
        pos = torch.where(active, pos + 1, pos)
        buf[:, n] = cur
        n += 1
        if eos is not None:
            done = done | (cur == eos)
            if bool(done.all()):  # the one host read of a step
                break
    return buf, cur, pos.to(positions.dtype), cache, n


class ChunkProgram:
    """A decode chunk as a device program (the JAX package's jitted chunk
    ``while_loop`` with its donated cache): one captured graph is one step of
    every slot over static buffers (``inference/programs.py``). The loop
    state lives on the device: the step counter ``n`` (0-dim int32, the
    number of steps run), ``cur``, ``pos``, ``done``, the tokens ``buf``, the
    slots' ``lens`` (the scatter flavour advances them in place) and ``go =
    (n < K) & ~all(done)``, which gates every state update. A chunk is K
    replays and no host read: the caller reads the tokens (and ``n``) once,
    after the chunk, as the JAX batcher does. A replay past the exit runs the
    step's kernels and changes no state: its kv write lands at a column past
    each stream's valid length (the pending token's, rewritten by the next
    chunk) or, in the aligned flavour, inside the band past the steps run,
    which :func:`_compact_band` leaves past each stream's lens. A sampled
    chunk draws from its generator, registered with the graph; its replays
    past the exit draw too, so the generator ends K steps' draws on, where
    the eager loop stops drawing at the exit (the JAX chunk takes a key and
    returns none).

    The program writes the pool's own arrays (the batcher's pool, which
    persists across rounds), keyed by them: ``repack_pool`` drops the
    programs of the pool it replaces. With ``static`` (the scatter flavour
    only: ``InterleaveInferencer.gen_text_stream``, whose cache is new every
    request) it runs in the programs' shared cache of the pool's shape
    (``bagel.static_cache``), the caller's copied in at every call and the
    columns the chunk made valid, [lens, new lens), copied back, so a new
    caller captures nothing anew. The slots' lens, tokens, positions and
    the active mask are copied into its buffers at every call. Keyed by the
    flavour, S, K, eos, the sampling options, the pool arrays (pointers,
    shapes, dtype, width; with ``static`` the shape, dtype and width) and
    the LLM's weights."""

    def __init__(self, model: Bagel, cache: KVCache, num_steps: int, eos: Optional[int],
                 aligned: bool, static: bool, sampler: tuple):
        from unimedvl_tpu_torch.inference import programs

        S = cache.k.shape[1]
        dev = cache.k.device
        self._model = programs.model_ref(model)
        self.K, self.eos, self.aligned, self.static = num_steps, eos, aligned, static
        self.sampler = sampler[:3]
        i32 = dict(dtype=torch.int32, device=dev)
        self.lens = torch.zeros(S, dtype=cache.lens.dtype, device=dev)
        # the pool with self.lens (a caller's pool held only while a chunk runs)
        self.static_cache = bagel.static_cache(cache) if static else None
        self.cache = None
        self.active = torch.zeros(S, dtype=torch.bool, device=dev)
        self.q_valid = self.active[:, None]
        self.cur = torch.zeros(S, **i32)
        self.pos = torch.zeros(S, dtype=torch.int64, device=dev)
        self.done = torch.zeros(S, dtype=torch.bool, device=dev)
        self.buf = torch.zeros((S, num_steps), **i32)
        self.n = torch.zeros((), **i32)
        self.go = torch.ones((), dtype=torch.bool, device=dev)
        self.base = torch.zeros((), **i32)
        self.cols = torch.arange(num_steps, **i32)
        self.graph = programs.Graph(
            "chunk", self._body, dev, rows=S,
            keep=(self.lens, self.cur, self.pos, self.done, self.buf, self.n, self.go),
            generators=[sampler[2]] if sampler[0] and dev.type == "cuda" else [])

    @classmethod
    def get(cls, model: Bagel, cache: KVCache, num_steps: int, eos: Optional[int],
            aligned: bool, static: bool = False, do_sample: bool = False,
            temperature: float = 1.0, generator: Optional[torch.Generator] = None):
        from unimedvl_tpu_torch.inference import programs

        if aligned and static:
            raise ValueError("the aligned chunk writes its caller's pool; static is the scatter "
                             "chunk's")
        sampler = bagel._sampler(do_sample, temperature, generator, cache.k.device)
        arrays = _arrays(cache)
        where = (bagel._cache_kind(cache),) if static else (
            cache.kv_bits, cache.lens.dtype, programs.tensors_key(arrays))
        key = ("chunk", aligned, static, num_steps, eos, sampler[3], where,
               programs.weights_key(model.language_model), programs.mesh_key(model))
        reads = (model.language_model,) if static else (model.language_model, arrays)
        return programs.lookup(key, lambda: cls(model, cache, num_steps, eos, aligned, static,
                                                sampler),
                               reads=reads, owner=model.language_model)

    def graphs(self):
        return [self.graph]

    def _body(self) -> None:
        go = self.go
        if self.aligned:
            kw = dict(decode_cols=(self.base, self.base + self.n))
        else:
            kw = dict(q_valid=self.q_valid)
        nxt, cache = _step(self._model(), self.cache, self.cur, self.pos, self.sampler, **kw)
        if not self.aligned:
            self.lens.copy_(torch.where(go, cache.lens, self.lens))
        self.pos.copy_(torch.where(go & self.active, self.pos + 1, self.pos))
        self.buf.copy_(torch.where(go & (self.cols == self.n), nxt[:, None], self.buf))
        self.cur.copy_(torch.where(go, nxt, self.cur))
        self.n.add_(go.to(torch.int32))
        if self.eos is None:
            self.go.copy_(self.n < self.K)
        else:
            self.done.copy_(torch.where(go, self.done | (nxt == self.eos), self.done))
            self.go.copy_((self.n < self.K) & ~self.done.all())

    def run(self, cache: KVCache, cur_tokens, positions, active):
        """K replays from the given state; (tokens [S, K], last [S],
        positions [S], cache, steps run as a 0-dim device tensor)."""
        self.lens.copy_(cache.lens)
        self.active.copy_(active)
        self.cur.copy_(cur_tokens)
        self.pos.copy_(positions)
        self.done.copy_(~active)
        self.buf.zero_()
        self.n.zero_()
        self.go.fill_(True)
        if self.aligned:
            self.base.copy_(torch.where(active, cache.lens, 0).max())
        if self.static:
            bagel._copy_cache(self.static_cache, cache)
        store = self.static_cache if self.static else cache
        self.cache = dataclasses.replace(store, lens=self.lens)
        try:
            for _ in range(self.K):
                self.graph.replay()
        finally:
            self.cache = None
        n = self.n.clone()
        if self.aligned:
            out = _compact_band(cache, self.base.clone(), self.K, cache.lens, active, n)
        else:
            if self.static:
                bagel._copy_columns(cache, self.static_cache, cache.lens, self.lens, self.K)
            out = dataclasses.replace(cache, lens=self.lens.clone())
        return (self.buf.clone(), self.cur.clone(), self.pos.to(positions.dtype, copy=True), out,
                n)


@torch.no_grad()
def _run_chunk(model, cache, cur_tokens, positions, active, num_steps, eos, aligned, graphs,
               static=False, sampler=(False, 1.0, None)):
    """Either chunk flavour by either route (``inference.programs.use_graphs``):
    (tokens, last, positions, cache, steps run)."""
    from unimedvl_tpu_torch.inference import programs

    active = active.to(torch.bool)
    if programs.use_graphs(graphs, cur_tokens.device, model):
        prog = ChunkProgram.get(model, cache, num_steps, eos, aligned, static, *sampler)
        return prog.run(cache, cur_tokens, positions, active)
    if not aligned:
        return _chunk(model, cache, cur_tokens, positions, active, num_steps, eos,
                      _scatter_kw(active), sampler)
    lens0 = cache.lens
    base, step_kw = _aligned_kw(cache, active)
    tokens, last, pos, cache, n = _chunk(
        model, cache, cur_tokens, positions, active, num_steps, eos, step_kw, sampler)
    return tokens, last, pos, _compact_band(cache, base, num_steps, lens0, active, n), n


def decode_chunk(
    model: Bagel,
    cache: KVCache,
    cur_tokens: torch.Tensor,  # [S]
    positions: torch.Tensor,  # [S]
    active: torch.Tensor,  # [S] bool
    num_steps: int,
    eos: Optional[int] = None,
    do_sample: bool = False,
    temperature: float = 1.0,
    generator: Optional[torch.Generator] = None,
    graphs: Optional[bool] = None,
    return_steps: bool = False,
    static: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, KVCache]:
    """Up to ``num_steps`` decode steps of every slot (serving.py:110), greedy
    or, with ``do_sample``, drawn at ``temperature`` from ``generator`` (the
    device's default when None) as ``bagel._next_token`` draws. Each step
    writes a stream's kv at its own ``lens[s]`` and attends to [0, lens[s]]
    (K2 / K2-int8 with the band ``(lens, lens)``); only active slots advance
    their lens and positions. With ``eos`` the chunk exits once every active
    slot has emitted it. Returns (tokens [S, K], zero past the exit, last
    [S], positions [S], cache), and with ``return_steps`` the steps run (an
    int, or a 0-dim device tensor from the program).

    ``graphs``: by default, on a CUDA device, the chunk runs as a
    :class:`ChunkProgram` with no host read; ``graphs=False`` runs the eager
    loop, its plain version, with one host read a step. ``static``: the
    program runs in a cache of its own, the caller's copied in and the
    columns made valid copied back (see :class:`ChunkProgram`), for a caller
    whose cache is new at every request."""
    out = _run_chunk(model, cache, cur_tokens, positions, active, num_steps, eos, False, graphs,
                     static, (do_sample, temperature, generator))
    return out if return_steps else out[:4]


def _compact_band(cache: KVCache, base: torch.Tensor, k: int, lens0: torch.Tensor,
                  active: torch.Tensor, n_steps) -> KVCache:
    """Move the aligned band [base, base + k) back to each active stream's
    [lens0[s], lens0[s] + k), in place, and advance the active streams' lens
    by ``n_steps`` (an int, or a 0-dim device tensor). The band is taken out
    first (the two overlap when lens0[s] > base - k); an inactive stream
    writes its band onto itself. Past lens0[s] + n_steps the window carries
    stale columns on an early exit, which only happens once every active
    stream has finished. The scales move like the values ([L, S, Hk, M], no
    column-major carry)."""
    S = lens0.shape[0]
    dev = lens0.device
    steps = torch.arange(k, device=dev)
    band_cols = base.to(torch.int64) + steps  # [k]
    start = torch.where(active, lens0.to(torch.int64), base.to(torch.int64))
    rows = torch.arange(S, device=dev)[:, None].expand(S, k)
    cols = start[:, None] + steps  # [S, k]
    for arr in _arrays(cache):
        band = arr.index_select(3, band_cols)  # [L, S, Hk, k, ...], a copy
        perm = (1, 3, 0, 2) + tuple(range(4, arr.dim()))
        arr[:, rows, :, cols] = band.permute(*perm)
    lens = torch.where(active, lens0 + n_steps, lens0).to(lens0.dtype)
    return dataclasses.replace(cache, lens=lens)


def decode_chunk_aligned(
    model: Bagel,
    cache: KVCache,
    cur_tokens: torch.Tensor,  # [S]
    positions: torch.Tensor,  # [S]
    active: torch.Tensor,  # [S] bool
    num_steps: int,
    eos: Optional[int] = None,
    do_sample: bool = False,
    temperature: float = 1.0,
    generator: Optional[torch.Generator] = None,
    graphs: Optional[bool] = None,
    return_steps: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, KVCache]:
    """:func:`decode_chunk` with the aligned-column write (serving.py:234):
    step d writes every stream's kv at column base + d, base the largest
    lens of an ACTIVE slot (a freed slot's stale lens must not push the band
    up), and attends to [0, lens[s]) and the band [base, base + d] through
    the ``decode_cols`` path (K2 / K2-int8); then :func:`_compact_band` moves
    the band to each stream's tail, so the returned cache keeps the
    contiguous contract and the two flavours interleave freely. Contract:
    max(lens[active]) + num_steps <= capacity (the batcher falls back to
    :func:`decode_chunk` near capacity). The softmax visits the columns in
    another order than the scatter chunk's, so logits may differ in the last
    place. ``do_sample``, ``temperature``, ``generator``, ``graphs`` and
    ``return_steps`` as for :func:`decode_chunk`."""
    out = _run_chunk(model, cache, cur_tokens, positions, active, num_steps, eos, True, graphs,
                     sampler=(do_sample, temperature, generator))
    return out if return_steps else out[:4]


@torch.no_grad()
def decode_chunk_spec(
    model: Bagel,
    cache: KVCache,
    cur_tokens: torch.Tensor,  # [S]
    positions: torch.Tensor,  # [S]
    active: torch.Tensor,  # [S] bool
    budget: torch.Tensor,  # [S] int: most tokens a slot may emit in this chunk
    hist: torch.Tensor,  # [S, HL] int32 id history (prompt + emitted)
    hlen: torch.Tensor,  # [S]
    num_iters: int,
    eos: int,
    k_draft: int = 7,
    ngram: int = 3,
    graphs: Optional[bool] = None,
    return_steps: bool = False,
    static: bool = False,
):
    """A speculative chunk (serving.py:320-410): up to ``num_iters`` verify
    forwards ([S, k_draft + 1] each, ``bagel.verify_block``), each emitting 1
    to k_draft + 1 greedy-exact tokens per live slot (``bagel.spec_accept``).
    It keeps :func:`decode_chunk`'s pending-token contract: the returned
    ``last`` token has no kv yet, and the next chunk of either flavour
    forwards it. A slot freezes (no lens or position advance) once it has
    emitted ``budget`` tokens or eos; the chunk ends early when no slot is
    live. ``hist`` is updated in place.

    ``graphs``: by default, on a CUDA device, a ``bagel.SpecProgram``
    (``num_iters`` replays with no host read, one a replay with one slot)
    over the pool's own arrays and ``hist``, keyed by their storage; with
    ``static`` over buffers of their shape, the caller's copied in and the
    columns made valid copied back, for a caller whose cache and history
    are new at every request. ``graphs=False``: the eager loop, its plain
    version, with one host read an iteration.

    Returns (tokens [S, num_iters * (k_draft + 1)], counts [S], fin [S],
    last [S], positions [S], cache, hist, hlen), and with ``return_steps``
    the verify forwards run (an int, or a 0-dim device tensor from the
    program): ``tokens[:counts]`` holds no eos, and ``fin`` says whether a
    slot stopped at eos."""
    from unimedvl_tpu_torch.inference import programs

    active = active.to(torch.bool)
    if programs.use_graphs(graphs, cur_tokens.device, model):
        prog = bagel.SpecProgram.get(model, cache, hist, k_draft, ngram, eos, num_iters,
                                     chunk=True, static=static)
        out = prog.run_chunk(cache, cur_tokens, positions, active,
                             budget.to(device=cur_tokens.device, dtype=torch.int32), hist, hlen)
        return out if return_steps else out[:8]
    S = cur_tokens.shape[0]
    dev = cur_tokens.device
    K = k_draft
    W = num_iters * (K + 1)
    out = torch.zeros((S, W + K + 1), dtype=torch.int32, device=dev)  # windowed-write margin
    budget = budget.to(device=dev, dtype=torch.int32)
    fin = torch.zeros(S, dtype=torch.bool, device=dev)
    cursor = torch.zeros(S, dtype=torch.int32, device=dev)
    cur = cur_tokens.to(torch.int32)
    pos = positions.to(torch.int64)
    hlen = hlen.to(torch.int32)
    n = 0
    for _ in range(num_iters):
        live = active & ~fin & (cursor < budget)
        if not bool(live.any()):  # the one host read of an iteration
            break
        draft = bagel.propose_drafts(hist, hlen, ngram, K)
        lens = cache.lens
        g, cache = bagel.verify_block(model, cache, cur, draft, pos, live)
        E, done, emit, last = bagel.spec_accept(draft, g, live, cursor, budget, eos)
        fin = fin | done
        bagel._scatter_row_window(out, emit, cursor)
        bagel._scatter_row_window(hist, emit.clamp_min(0), hlen)
        # live with E == 0 is the immediate eos: the pending cur's kv was
        # written and consumed although nothing was emitted
        lens = lens + torch.where(live, E.clamp_min(1), 0).to(lens.dtype)
        cache = dataclasses.replace(cache, lens=lens)
        cur = torch.where(E >= 1, last, cur)
        cursor = cursor + E
        pos = pos + E
        hlen = hlen + E
        n += 1
    got = (out[:, :W], cursor, fin, cur, pos.to(positions.dtype), cache, hist, hlen)
    return got + (n,) if return_steps else got


@dataclasses.dataclass
class _Slot:
    request_id: Optional[int] = None
    cur_token: int = 0
    position: int = 0
    remaining: int = 0
    out_ids: List[int] = dataclasses.field(default_factory=list)
    #: host mirror of the slot's cache lens (kv extent): the planned kv_len at
    #: admission, plus the chunk length for every chunk the slot survives.
    #: Gates the aligned chunk (max live kv_len + chunk <= capacity).
    kv_len: int = 0


@dataclasses.dataclass
class Request:
    prompt: str
    #: a PIL image (or anything ``data.imaging.pil_img2rgb`` takes)
    image: Optional[object] = None
    max_new_tokens: int = 128
    #: a text-to-image request: generate an (H, W) image from ``prompt``
    #: (needs ContinuousBatcher(pipeline=...); the result is a PIL image)
    image_size: Optional[Tuple[int, int]] = None
    #: the denoise's option overrides of such a request (anything
    #: ``start_gen_job`` takes)
    gen_params: Optional[Dict] = None
    #: shared-preamble reuse: an id from ContinuousBatcher.register_prefix.
    #: Admission seeds the slot with the preamble's cache and prefills only
    #: [encode(prompt) + eos] after it. Text-only requests.
    prefix_id: Optional[int] = None


class ContinuousBatcher:
    def __init__(
        self,
        model: Bagel,
        tokenizer,
        new_token_ids: Dict[str, int],
        num_slots: int = 8,
        capacity: int = 4096,
        chunk: int = 16,
        vit_transform=None,
        seed: int = 0,
        *,
        mesh=None,
        kv_quantized: bool = False,
        kv_bits: int = 8,
        spec_decode: bool = False,
        spec_k: int = 7,
        spec_ngram: int = 3,
        pipeline=None,
        gen_chunk: int = 10,
        gen_group: int = 4,
        pool_ladder: bool = False,
        min_pool: int = 32,
        graphs: Optional[bool] = None,
    ):
        """The positional parameters come in the JAX batcher's order, with
        ``model`` in the place of its ``params, cfg``; the rest are
        keyword-only.

        ``model``: a Bagel on its device, whose pool of ``num_slots`` x
        ``capacity`` columns is allocated there; ``tokenizer`` /
        ``new_token_ids``: as for the inferencer; ``chunk``: decode steps
        between host reads; ``vit_transform``: a
        ``data.imaging.ImageTransform`` for image requests; ``seed``: kept
        for the JAX batcher's order (decoding is greedy and draws nothing).
        ``kv_quantized``: an int8 pool with per-key scales (K2-int8);
        ``kv_bits``: 8, or 4 for int4 values packed two to a byte, unpacked
        to int8 a layer at a time for K2-int8. ``spec_decode``:
        speculative continuous batching, every chunk a
        :func:`decode_chunk_spec` (``spec_k`` prompt-lookup drafts verified
        per forward, from the trailing ``spec_ngram`` ids of each slot's
        history: its prompt, a preamble's ids included, and what it emitted);
        greedy-exact per slot. ``pipeline``: an ``InterleaveInferencer`` over
        the same model, for text-to-image requests, denoised ``gen_chunk``
        flow steps a round, up to ``gen_group`` compatible ones in one
        grouped job. ``pool_ladder``: the drain-tail rightsizing over the
        rungs ``num_slots``, its halvings down to ``min_pool``; not with
        ``spec_decode``. ``mesh``: a ``parallel.mesh.Mesh`` with the axes
        ("data", "model") (see the module's docstring); ``model`` whole or
        already a rank's shard of it; a ``pipeline`` then has the same mesh
        and its shard serves both. Not with ``pool_ladder``. ``graphs``: the
        route of the decode chunks and of admission
        (``inference.programs.use_graphs``): by default a captured
        :class:`ChunkProgram` (a speculative chunk: a ``bagel.SpecProgram``)
        on a CUDA device, one host read a chunk, and the admission blocks'
        and the preambles' prefill programs; on a mesh whose groups are all
        NCCL too, the collectives inside the graphs, and eagerly on a mesh
        with a gloo group; False the eager loops and prefills, one host read
        a step or a verify forward."""
        if spec_decode and pool_ladder:
            raise ValueError("pool_ladder and spec_decode are not composed (nor in the JAX "
                             "batcher)")
        self.mesh = mesh
        #: this rank's slots [lo, lo + n) of the pool (all of them without a data split)
        self._slot_lo, self._slot_n = 0, num_slots
        if mesh is not None:
            from unimedvl_tpu_torch.parallel.mesh import place_params, stream_range

            if mesh.axis_names != ("data", "model"):
                raise ValueError(f"mesh must have the axes ('data', 'model'), got "
                                 f"{mesh.axis_names}")
            if pool_ladder:
                raise ValueError("pool_ladder and a mesh are not composed (nor in the JAX "
                                 "batcher)")
            if pipeline is not None:
                if getattr(pipeline, "mesh", None) is None or pipeline.mesh.shape != mesh.shape:
                    raise ValueError("with a mesh, the pipeline must be an InterleaveInferencer "
                                     "of the same mesh")
                model = pipeline.model
            elif getattr(model.language_model, "mesh", None) is None:
                model = place_params(model, mesh)
            self._slot_lo, self._slot_n = stream_range(mesh, num_slots)
        self.model = model
        self.cfg = model.config
        self.tokenizer = tokenizer
        self.new_token_ids = new_token_ids
        self.num_slots = num_slots
        self.chunk = chunk
        self.graphs = graphs
        #: images per grouped prefill, and per admission round while slots decode
        self._img_group = 8
        #: rows of a text admission block: fixed, padding rows left out by the store
        self._txt_group = 32
        self.vit_transform = vit_transform
        self.seed = seed
        norm = model.language_model.model.norm.weight
        self.device, self.dtype = norm.device, norm.dtype
        llm = self.cfg.llm
        self.cache = KVCache.create(
            llm.num_hidden_layers, self._slot_n, capacity, llm.num_key_value_heads,
            llm.head_dim, self.dtype, device=self.device, quantized=kv_quantized,
            kv_bits=kv_bits,
        )
        self.capacity = capacity
        self.spec_decode = spec_decode
        self.spec_k = spec_k
        self.spec_ngram = spec_ngram
        if spec_decode:
            # each slot's id history for the drafts: rewritten at admission,
            # appended by the chunks
            self._hist = torch.zeros((self._slot_n, capacity), dtype=torch.int32,
                                     device=self.device)
            self._hlen = torch.zeros((self._slot_n,), dtype=torch.int32, device=self.device)
        self.slots = [_Slot() for _ in range(num_slots)]
        #: registered preambles: (1-stream cache block, valid length, ids)
        self._prefixes: List[Tuple[KVCache, int, List[int]]] = []
        self.pool_ladder = pool_ladder
        #: the pool's current size (the slot axis of self.cache); only slots
        #: [0, pool) are admissible. Without the ladder it stays num_slots.
        self.pool = num_slots
        rungs = {num_slots}
        if pool_ladder:
            r = num_slots
            while r // 2 >= max(1, min_pool):
                r //= 2
                rungs.add(r)
        self._rungs = sorted(rungs)
        self._next_id = 0
        self._pending: List[Tuple[int, Request]] = []
        self.pipeline = pipeline
        self.gen_chunk = gen_chunk
        self.gen_group = gen_group
        self._gen_pending: List[Tuple[int, Request]] = []
        #: started jobs not yet in a group
        self._gen_ready: List[Tuple[int, object]] = []
        #: (rids, GenImageJob) in flight; a cancelled member's rid is None
        self._gen_job = None
        #: rid -> answer text, or a PIL image for a text-to-image request
        self._done: Dict[int, object] = {}
        #: per-request failures (rejections, prefill errors, cancellations):
        #: a failed request never stops the batch
        self.errors: Dict[int, str] = {}
        #: run()'s breakdown in seconds and counts, reset per run (the JAX
        #: batcher's keys)
        self.stats: Dict[str, float] = {}

    # -- pool ladder ----------------------------------------------------------
    def _rung(self, want: int) -> int:
        """Smallest ladder rung that fits ``want`` live slots (num_slots cap)."""
        for r in self._rungs:
            if r >= want:
                return r
        return self.num_slots

    def _repack(self, target: int) -> None:
        """Compact the live slots to a prefix of a pool of ``target`` rows
        (:func:`repack_pool`); each slot's host state moves with its row."""
        t0 = time.perf_counter()
        actives = [i for i in range(self.pool) if self.slots[i].request_id is not None]
        assert len(actives) <= target, (len(actives), target)
        perm = np.full((target,), -1, np.int64)
        perm[: len(actives)] = actives
        self.cache = repack_pool(self.cache, perm)
        new_slots = [self.slots[i] for i in actives]
        new_slots += [_Slot() for _ in range(self.num_slots - len(new_slots))]
        self.slots = new_slots
        self.pool = target
        self._fence()
        if self.stats:
            self.stats["repacks"] = self.stats.get("repacks", 0) + 1
            self.stats["repack_s"] = (
                self.stats.get("repack_s", 0.0) + time.perf_counter() - t0)

    # -- requests -------------------------------------------------------------
    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _mine(self, slot: int) -> bool:
        """Whether pool slot ``slot`` lives on this rank (every slot does
        without a data split)."""
        return self._slot_lo <= slot < self._slot_lo + self._slot_n

    def _local_slots(self, slots) -> np.ndarray:
        """Pool slots as rows of this rank's pool; another rank's slot, or a
        padding row, becomes a row past it (left out by ``group_store``)."""
        s = np.asarray(slots, np.int64)
        local = s - self._slot_lo
        return np.where((local >= 0) & (local < self._slot_n), local, self._slot_n)

    def _gather_slots(self, t: torch.Tensor) -> torch.Tensor:
        """Per-slot results [n, ...] of this rank's slots as those of the whole
        pool, gathered over "data" (the tensor itself without a data split)."""
        if self._slot_n == self.num_slots:
            return t
        return self.mesh.gather(t, "data", dim=0)

    def _start_end(self) -> torch.Tensor:
        ids = self.new_token_ids
        return torch.tensor([ids["start_of_image"], ids["end_of_image"]], device=self.device)

    def register_prefix(self, text: str) -> int:
        """Prefill a shared preamble (system prompt, report template) once;
        requests carrying the returned id (``Request(prefix_id=...)``) prefill
        only their own suffix after it, the preamble's cache copied into their
        admission block (:func:`seed_prefix_block`). A prefixed request decodes
        over ``[bos] + encode(text) + encode(prompt) + [eos]``: end the
        preamble where the tokenizer splits anyway if the result must equal an
        unsplit prompt's."""
        ids = [self.new_token_ids["bos_token_id"]] + self.tokenizer.encode(text)
        Tp = len(ids)
        Tp_pad = max(32, ((Tp + 31) // 32) * 32)
        llm = self.cfg.llm
        pad_ids = np.zeros((1, Tp_pad), np.int64)
        pad_ids[0, :Tp] = ids
        pos = np.arange(Tp_pad, dtype=np.int64)[None]
        valid = np.zeros((1, Tp_pad), bool)
        valid[0, :Tp] = True
        block = KVCache.create(
            llm.num_hidden_layers, 1, Tp_pad, llm.num_key_value_heads, llm.head_dim,
            device=self.device, **self._block_options())
        block = bagel.prefill_text(self.model, block, self._tensor(pad_ids),
                                   self._tensor(pos), self._tensor(valid), graphs=self.graphs)
        self._prefixes.append((block, Tp, ids))
        return len(self._prefixes) - 1

    def submit(self, request: Request) -> int:
        rid = self._next_id
        self._next_id += 1
        if request.image_size is not None:
            if self.pipeline is None:
                self.errors[rid] = ("t2i request needs ContinuousBatcher(pipeline=...) "
                                    "(rejected before any device work)")
            else:
                self._gen_pending.append((rid, request))
        else:
            self._pending.append((rid, request))
        return rid

    def cancel(self, rid: int) -> bool:
        """Cancel a submitted request: a pending one is dropped before any
        device work; an in-flight text request frees its slot at the next
        chunk boundary (what its current chunk produced is discarded); a
        started image request leaves its group, whose other members denoise
        on. The rid lands in ``errors``. False if the request already
        finished."""
        for queue in (self._pending, self._gen_pending):
            for i, (r, _req) in enumerate(queue):
                if r == rid:
                    del queue[i]
                    self.errors[rid] = "cancelled before start"
                    return True
        for slot in self.slots:
            if slot.request_id == rid:
                slot.request_id = None  # the row's lens are rewritten on reuse
                self.errors[rid] = "cancelled mid-decode"
                return True
        for i, (r, _job) in enumerate(self._gen_ready):
            if r == rid:
                del self._gen_ready[i]
                self.errors[rid] = "cancelled before denoise"
                return True
        if self._gen_job is not None and rid in self._gen_job[0]:
            rids, job = self._gen_job
            if any(r is not None and r != rid for r in rids):
                self._gen_job = ([None if r == rid else r for r in rids], job)
            else:
                self._gen_job = None
            self.errors[rid] = "cancelled mid-denoise"
            return True
        return False

    # -- text to image ----------------------------------------------------------
    def _start_gen(self, request: Request):
        """The job of a text-to-image request, with the interleave-inference
        context recipe: the cfg_text context forks before the prompt, the
        cfg_img context holds the prompt; ``cfg_text_scale`` 3.0 unless
        ``gen_params`` says otherwise."""
        pipe = self.pipeline
        gen_context = pipe.init_gen_context()
        cfg_img_context = gen_context.fork()
        cfg_text_context = gen_context.fork()
        gen_context = pipe.update_context_text(request.prompt, gen_context)
        cfg_img_context = pipe.update_context_text(request.prompt, cfg_img_context)
        kw = dict(cfg_text_scale=3.0)  # interleave_inference's default
        kw.update(request.gen_params or {})
        return pipe.start_gen_job(request.image_size, gen_context,
                                  cfg_text_precontext=cfg_text_context,
                                  cfg_img_precontext=cfg_img_context, **kw)

    @staticmethod
    def _group_compatible(a, b) -> bool:
        """``merge_gen_jobs``' precondition: one geometry, the same options,
        the same step and caches of one shape."""
        return (a.image_shape == b.image_shape and a.kw == b.kw
                and (a.step, a.total_steps) == (b.step, b.total_steps)
                and a.caches.k.shape == b.caches.k.shape)

    def _advance_gen(self) -> None:
        """One segment of the image work: with no job in flight, start
        pending requests (their context prefills) until a group's worth is
        ready and merge the first with up to ``gen_group`` - 1 compatible
        ones (the others wait in ``_gen_ready``); then ``gen_chunk`` flow
        steps of the job, and the VAE decode once it is done. A failure
        lands in ``errors`` for the requests it concerns."""
        if self._gen_job is None and (self._gen_ready or self._gen_pending):
            while self._gen_pending and len(self._gen_ready) < self.gen_group:
                rid, req = self._gen_pending.pop(0)
                try:
                    self._gen_ready.append((rid, self._start_gen(req)))
                except Exception as e:  # a bad size or option of this request
                    self.errors[rid] = f"t2i prefill failed: {e}"
            if self._gen_ready:
                (lead_rid, lead), rest = self._gen_ready[0], []
                rids, jobs = [lead_rid], [lead]
                for rid, job in self._gen_ready[1:]:
                    if len(jobs) < self.gen_group and self._group_compatible(lead, job):
                        rids.append(rid)
                        jobs.append(job)
                    else:
                        rest.append((rid, job))
                self._gen_ready = rest
                self._gen_job = (rids, self.pipeline.merge_gen_jobs(jobs))
        if self._gen_job is None:
            return
        rids, job = self._gen_job
        try:
            job = self.pipeline.advance_gen_job(job, self.gen_chunk)
            if job.done:
                for rid, image in zip(rids, self.pipeline.finish_gen_job_group(job)):
                    if rid is not None:  # None: cancelled mid-denoise
                        self._done[rid] = image
                self._gen_job = None
            else:
                self._gen_job = (rids, job)
        except Exception as e:
            for rid in rids:
                if rid is not None:
                    self.errors[rid] = f"t2i denoise failed: {e}"
            self._gen_job = None

    # -- admission -------------------------------------------------------------
    def _plan_request(self, request: Request):
        """Host-side shape math before any device work: token ids, image
        geometry, and the largest cache extent the request will touch (the
        image bucket's write, the padded text write, the decode appends)."""
        from unimedvl_tpu_torch.data import imaging  # imports PIL

        pfx_len = 0
        pfx_pad = 0
        if request.prefix_id is not None:
            if request.image is not None or request.image_size is not None:
                raise ValueError("prefix_id supports text-only requests")
            pfx_block, pfx_len, _pids = self._prefixes[request.prefix_id]
            pfx_pad = pfx_block.capacity
            ids = (self.tokenizer.encode(request.prompt)
                   + [self.new_token_ids["eos_token_id"]])
        else:
            ids = ([self.new_token_ids["bos_token_id"]]
                   + self.tokenizer.encode(request.prompt)
                   + [self.new_token_ids["eos_token_id"]])
        T = len(ids)
        T_pad = max(32, ((T + 31) // 32) * 32)
        img_meta = None
        kv_img = 0
        extent = pfx_pad + T_pad if pfx_len else 0
        if request.image is not None:
            img = imaging.pil_img2rgb(request.image)
            rt = self.vit_transform.resize_transform
            w0, h0 = img.size
            new_w, new_h = imaging.compute_resize_shape(
                w0, h0, rt.max_size, rt.min_size, rt.stride, rt.max_pixels)
            p = self.cfg.vit.patch_size
            n = (new_h // p) * (new_w // p)
            bucket = bagel.vit_token_bucket(n)
            img_meta = (img, n, bucket)
            kv_img = n + 2
            extent = max(extent, bucket + 2)
        kv_len = kv_img + pfx_len + T
        extent = max(extent, kv_img + T_pad, kv_len + request.max_new_tokens + 1)
        return ids, T_pad, img_meta, kv_len, extent

    def _image_host_prep(self, img_meta):
        """Resize, patchify and position ids of one image: (patch tokens
        [1, bucket, p*p*3] on the device, position ids [bucket] numpy, n,
        bucket)."""
        from unimedvl_tpu_torch.data import imaging  # imports PIL

        img, n, bucket = img_meta
        u8 = np.array(self.vit_transform.resize_transform(img), dtype=np.uint8)
        H, W = u8.shape[:2]
        p = self.cfg.vit.patch_size
        pos_ids = imaging.position_ids_extrapolate(H, W, p, self.cfg.vit_max_num_patch_per_side)
        tokens = bagel.preprocess_vit_image(self.cfg, torch.from_numpy(u8).to(self.device))
        tokens = F.pad(tokens, (0, 0, 0, bucket - n))
        padded_pos = np.zeros(bucket, dtype=np.int64)
        padded_pos[:n] = pos_ids
        return tokens, padded_pos, n, bucket

    def _block_options(self):
        """The ``KVCache.create`` options of an admission block: the pool's
        kind (dtype, quantized, kv_bits)."""
        return dict(dtype=self.dtype, quantized=self.cache.quantized,
                    kv_bits=self.cache.kv_bits)

    def _vit_group(self, preps, texts=None, capacity: Optional[int] = None) -> KVCache:
        """The grouped ViT prefill of same-bucket images, P padded to a power
        of two with inactive rows (n = 0, stored nowhere), as the JAX batcher
        pads it, so that the programs stay few; with ``texts`` (ids,
        positions, valid [P, T_max] numpy of the real rows) their text
        appended into the same block (:func:`image_text_block`)."""
        P, bucket = len(preps), preps[0][3]
        P_pad = 1 << (P - 1).bit_length()
        rows = [prep[0] for prep in preps]
        if P_pad > P:
            rows.append(rows[0].new_zeros((P_pad - P,) + tuple(rows[0].shape[1:])))
        toks = torch.cat(rows, dim=0)
        pos = np.zeros((P_pad, bucket), np.int64)
        ns = np.zeros((P_pad,), np.int64)
        for j, (_tok, ppos, n, _b) in enumerate(preps):
            pos[j] = ppos
            ns[j] = n
        text = {}
        if texts is not None:
            text = {name: self._tensor(np.concatenate(
                [a, np.zeros((P_pad - P,) + a.shape[1:], a.dtype)]))
                for name, a in zip(("token_ids", "positions", "valid"), texts)}
        kind = self._block_options()
        return image_text_block(
            self.model, toks, self._tensor(pos), self._tensor(ns), self._start_end(), **text,
            capacity=capacity, kv_dtype=kind["dtype"], quantized=kind["quantized"],
            kv_bits=kind["kv_bits"], graphs=self.graphs)

    def _prefill_image_group(self, group) -> None:
        """The legacy pool path's image step: the grouped ViT prefill into a
        block of the bucket's size, stored into the pool. group: [(slot_idx,
        rid, prep)]."""
        group = [m for m in group if self._mine(m[0])]
        if not group:
            return
        block = self._vit_group([prep for _i, _r, prep in group])
        slots = np.asarray([i for i, _r, _p in group], np.int64)
        self.cache = group_store(self.cache, block, self._local_slots(slots))

    def _admit_image_text_block(self, members) -> None:
        """Image and text prefill of a same-bucket group in one compact block:
        the grouped ViT prefill with room for the text (capacity bucket + 2 +
        T_max), one [P, T_max] text append into the block, one store into the
        pool. members: [(slot_idx, rid, prep, admit)]; with a data split, this
        rank's members."""
        members = [m for m in members if self._mine(m[0])]
        if not members:
            return
        bucket = members[0][2][3]
        T_max = max(a[4] for *_x, a in members)
        P = len(members)
        slots = np.zeros((P,), np.int64)
        batch_ids = np.zeros((P, T_max), np.int64)
        batch_pos = np.zeros((P, T_max), np.int64)
        batch_valid = np.zeros((P, T_max), bool)
        for j, (slot_idx, _rid, _prep, admit) in enumerate(members):
            ids = admit[3]
            T = len(ids)
            slots[j] = slot_idx
            batch_ids[j, :T] = ids
            batch_pos[j, :T] = np.arange(1, 1 + T)  # rope 1 after the image
            batch_valid[j, :T] = True
        block = self._vit_group([m[2] for m in members], (batch_ids, batch_pos, batch_valid),
                                capacity=bucket + 2 + T_max)
        self.cache = group_store(self.cache, block, self._local_slots(slots))

    def _admit_text_block(self, group, prefix_id: Optional[int] = None) -> None:
        """Text-only admission in a compact [P, T_max] block: one prefill,
        one store into the pool. P is fixed at ``_txt_group`` (the store leaves
        the padding rows out). With ``prefix_id`` the block grows to
        [P, Tp_pad + T_max], its leading columns seeded with the preamble's
        cache, and only the suffixes are prefilled, at positions Tp on.
        group: [admit]; with a data split, this rank's members."""
        group = [a for a in group if self._mine(a[0])]
        if not group:
            return
        T_max = max(a[4] for a in group)
        P = max(self._txt_group, len(group))
        pos0 = 0
        M_blk = T_max
        if prefix_id is not None:
            pfx_block, pos0, _pids = self._prefixes[prefix_id]
            M_blk = pfx_block.capacity + T_max
        batch_ids = np.zeros((P, T_max), np.int64)
        batch_pos = np.zeros((P, T_max), np.int64)
        batch_valid = np.zeros((P, T_max), bool)
        slots = np.full((P,), self.num_slots, np.int64)
        for j, (i, _rid, _req, ids, _T_pad, _img, _kv_len) in enumerate(group):
            T = len(ids)
            batch_ids[j, :T] = ids
            batch_pos[j, :T] = np.arange(pos0, pos0 + T)
            batch_valid[j, :T] = True
            slots[j] = i
        kind = self._block_options()
        block = text_block(
            self.model, self._tensor(batch_ids), self._tensor(batch_pos),
            self._tensor(batch_valid), M_blk, pfx_block if prefix_id is not None else None, pos0,
            kv_dtype=kind["dtype"], quantized=kind["quantized"], kv_bits=kind["kv_bits"],
            graphs=self.graphs)
        self.cache = group_store(self.cache, block, self._local_slots(slots))

    def _prefill_text_group(self, group, T_max: int) -> None:
        """The legacy pool path's text step: a [pool, T_max] prefill over the
        whole pool (this rank's slots of it), the members' rows valid and
        appended after their image."""
        group = [a for a in group if self._mine(a[0])]
        if not group:
            return
        S = min(self.pool, self._slot_n)
        batch_ids = np.zeros((S, T_max), np.int64)
        batch_pos = np.zeros((S, T_max), np.int64)
        batch_valid = np.zeros((S, T_max), bool)
        for i, _rid, _req, ids, _T_pad, img_meta, _kv_len in group:
            i -= self._slot_lo
            T = len(ids)
            rope0 = 1 if img_meta is not None else 0
            batch_ids[i, :T] = ids
            batch_pos[i, :T] = np.arange(rope0, rope0 + T)
            batch_valid[i, :T] = True
        self.cache = bagel.prefill_text(self.model, self.cache, self._tensor(batch_ids),
                                        self._tensor(batch_pos), self._tensor(batch_valid),
                                        graphs=self.graphs, static=False)

    def _admit(self, throttle: bool = False):
        """Admit pending requests into free slots, in FIFO order.

        A request that cannot fit the capacity is rejected into ``errors``
        before any prefill, and the batch runs on. Images of one bucket are
        prefilled as a group, each with its text in the same compact block;
        text-only requests as blocks of ``_txt_group`` rows, one block per
        registered preamble. An image whose block (bucket + 2 + T_pad) would
        exceed the capacity although the request fits takes the legacy pool
        path: its image block is stored first, then its text is appended over
        the whole pool, in groups whose shared padded length fits every
        member (a member whose window overflows would lose its whole text).

        ``throttle`` caps the round's admission while other slots decode: one
        image group, a full text block. Reaching the image cap stops the
        round, so later text does not overtake an earlier image request."""
        admits = []  # (slot_idx, rid, req, ids, T_pad, img_meta, kv_len)
        max_admits = self._txt_group if throttle else self.num_slots
        max_img = self._img_group if throttle else self.num_slots
        n_img = 0
        stop = False
        for i, slot in enumerate(self.slots[: self.pool]):
            if slot.request_id is not None:
                continue
            if stop or len(admits) >= max_admits:
                break
            while self._pending:
                rid, req = self._pending.pop(0)
                try:
                    ids, T_pad, img_meta, kv_len, extent = self._plan_request(req)
                except Exception as e:  # a bad image, prefix id or tokenizer input
                    self.errors[rid] = f"prefill planning failed: {e}"
                    continue
                if extent > self.capacity:
                    self.errors[rid] = (
                        f"request needs cache extent {extent} > capacity "
                        f"{self.capacity} (rejected before prefill)"
                    )
                    continue
                if img_meta is not None:
                    if n_img >= max_img:  # image budget spent: requeue, stop
                        self._pending.insert(0, (rid, req))
                        stop = True
                        break
                    n_img += 1
                admits.append((i, rid, req, ids, T_pad, img_meta, kv_len))
                break
        if not admits:
            return

        img_groups: Dict[int, list] = {}  # bucket -> [(i, rid, prep, admit)]
        txt_groups: Dict[Optional[int], list] = {}  # prefix_id -> [admit]
        legacy: list = []  # [(i, rid, prep, admit)]
        ok_admits = []
        for admit in admits:
            i, rid, req, ids, T_pad, img_meta, kv_len = admit
            if img_meta is not None:
                try:
                    prep = self._image_host_prep(img_meta)
                except Exception as e:
                    self.errors[rid] = f"image prefill failed: {e}"
                    continue
                bucket = prep[3]
                if bucket + 2 + T_pad <= self.capacity:
                    img_groups.setdefault(bucket, []).append((i, rid, prep, admit))
                else:
                    legacy.append((i, rid, prep, admit))
            else:
                txt_groups.setdefault(req.prefix_id, []).append(admit)
            ok_admits.append(admit)
        for bucket, members in sorted(img_groups.items()):
            for lo in range(0, len(members), self._img_group):
                self._admit_image_text_block(members[lo: lo + self._img_group])
        for pid in sorted(txt_groups, key=lambda k: (k is not None, k or 0)):
            grp = txt_groups[pid]
            for lo in range(0, len(grp), self._txt_group):
                self._admit_text_block(grp[lo: lo + self._txt_group], prefix_id=pid)
        if legacy:
            for lo in range(0, len(legacy), self._img_group):
                self._prefill_image_group(
                    [(i, rid, prep) for i, rid, prep, _a in legacy[lo: lo + self._img_group]])
            # the text after each image, grouped so that every member's window
            # [kv_img, kv_img + T_max) fits (the longest always fits its own group)
            remaining = [a for _i, _r, _p, a in legacy]
            while remaining:
                T_max = max(a[4] for a in remaining)
                fit = [a for a in remaining if (a[6] - len(a[3])) + T_max <= self.capacity]
                remaining = [a for a in remaining
                             if (a[6] - len(a[3])) + T_max > self.capacity]
                self._prefill_text_group(fit, T_max)

        for i, rid, req, ids, T_pad, img_meta, kv_len in ok_admits:
            slot = self.slots[i]
            rope0 = 1 if img_meta is not None else 0
            if req.prefix_id is not None:  # the suffix's rope continues at Tp
                rope0 = self._prefixes[req.prefix_id][1]
            slot.request_id = rid
            slot.cur_token = self.new_token_ids["bos_token_id"]
            slot.kv_len = kv_len
            slot.position = rope0 + len(ids)
            # max_new_tokens counts the start token, as the reference's max_length does
            slot.remaining = req.max_new_tokens - 1
            slot.out_ids = [slot.cur_token]
        mine = [a for a in ok_admits if self._mine(a[0])]
        if self.spec_decode and mine:
            self._write_hist(mine)

    def _write_hist(self, admits) -> None:
        """The admitted slots' history rows: the prompt's ids (after a
        preamble's ids for a prefixed request) and the start token, the last
        ``capacity`` of them."""
        bos = self.new_token_ids["bos_token_id"]
        rows = np.zeros((len(admits), self.capacity), np.int32)
        hlens = np.zeros((len(admits),), np.int32)
        for j, (_i, _rid, req, ids, *_rest) in enumerate(admits):
            seq = list(ids) + [bos]
            if req.prefix_id is not None:  # draft from the preamble too
                seq = list(self._prefixes[req.prefix_id][2]) + seq
            seq = seq[-self.capacity:]
            rows[j, :len(seq)] = seq
            hlens[j] = len(seq)
        idx = self._tensor(np.asarray([a[0] - self._slot_lo for a in admits], np.int64))
        self._hist[idx] = self._tensor(rows)
        self._hlen[idx] = self._tensor(hlens)

    # -- results ----------------------------------------------------------------
    def _text(self, ids: List[int]) -> str:
        text = self.tokenizer.decode(ids)
        text = text.split("<|im_end|>")[0]
        if "<|im_start|>" in text:
            text = text.split("<|im_start|>")[1]
        return text

    def _finish(self, slot: _Slot):
        self._done[slot.request_id] = self._text(slot.out_ids)
        slot.request_id = None

    def partials(self) -> Dict[int, str]:
        """In-flight outputs: rid -> the text decoded so far, the last token
        held back (it may begin a multi-token byte sequence). Host only."""
        return {slot.request_id: self._text(slot.out_ids[:-1]) for slot in self.slots
                if slot.request_id is not None and len(slot.out_ids) > 2}

    def has_work(self) -> bool:
        """True while any submitted request is unfinished."""
        return bool(self._pending or self._gen_pending or self._gen_ready
                    or self._gen_job is not None
                    or any(s.request_id is not None for s in self.slots))

    def _reset_stats(self) -> Dict[str, float]:
        self.stats = {
            "rounds": 0, "admit_s": 0.0, "decode_s": 0.0, "host_s": 0.0,
            "gen_s": 0.0, "admitted": 0, "emitted_tokens": 0, "gen_images": 0,
            "repacks": 0, "repack_s": 0.0, "round_s": 0.0, "decode_steps": 0,
        }
        return self.stats

    # -- the engine ---------------------------------------------------------------
    def run(self) -> Dict[int, object]:
        """Serve every submitted request to the end; rid -> answer text, or
        the image of a text-to-image request."""
        st = self._reset_stats()
        eos = self.new_token_ids["eos_token_id"]
        while self.has_work():
            self._round(st, eos)
        return dict(self._done)

    def _round(self, st: Dict[str, float], eos: int) -> None:
        """One round: throttled admission, one segment of image work, one
        decode chunk and its host bookkeeping. ``round_s`` adds up the whole
        round, so what it holds beyond admit_s + gen_s + decode_s + host_s +
        repack_s is unattributed."""
        t_round = time.perf_counter()
        try:
            self._round_inner(st, eos)
        finally:
            st["round_s"] = st.get("round_s", 0.0) + time.perf_counter() - t_round

    def _fence(self) -> None:
        """With UNIMEDVL_SERVING_PROFILE set, wait for the device at the end
        of a repack, of admission and of an image segment, so that
        ``repack_s``, ``admit_s`` and ``gen_s`` hold their device work
        (``decode_s`` ends on its host read anyway); unset, those hold host
        time and their queued device work lands in ``decode_s``."""
        if os.environ.get("UNIMEDVL_SERVING_PROFILE") and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _round_inner(self, st: Dict[str, float], eos: int) -> None:
        st["rounds"] += 1
        # throttle admission while other slots decode, so that a burst of
        # prefills does not stall them for long
        running = any(s.request_id is not None for s in self.slots)
        if self.pool_ladder and self._pending:
            # grow a rung ahead of admission, for the backlog
            n_active = sum(s.request_id is not None for s in self.slots)
            target = self._rung(n_active + len(self._pending))
            if target > self.pool:
                self._repack(target)
        t0 = time.perf_counter()
        n_before = sum(s.request_id is not None for s in self.slots)
        self._admit(throttle=running)
        st["admitted"] += sum(s.request_id is not None for s in self.slots) - n_before
        self._fence()
        st["admit_s"] += time.perf_counter() - t0
        # one segment of image work a round, beside the decode chunk below
        if self._gen_job is not None or self._gen_pending or self._gen_ready:
            t0 = time.perf_counter()
            n_done = len(self._done)
            self._advance_gen()
            self._fence()
            st["gen_images"] += len(self._done) - n_done
            st["gen_s"] += time.perf_counter() - t0
        if not any(s.request_id is not None for s in self.slots):
            return  # no text in flight: no decode chunk
        t0 = time.perf_counter()
        pool_slots = self.slots[: self.pool]
        active = np.asarray([s.request_id is not None for s in pool_slots])
        cur = np.asarray([s.cur_token if s.request_id is not None else 0 for s in pool_slots],
                         np.int32)
        pos = np.asarray([s.position for s in pool_slots], np.int64)
        k = self.chunk
        if self.spec_decode:
            self._spec_round(st, eos, pool_slots, active, cur, pos, t0)
            return
        # the aligned chunk while its band fits above every live stream (the
        # largest live kv extent + chunk <= capacity), else the scatter chunk.
        # kv_len mirrors the device lens: a chunk advances every active slot
        # by the steps it ran, and a surviving slot always ran all of them
        # (an early exit needs every active slot finished).
        base_est = max((s.kv_len for s in self.slots if s.request_id is not None), default=0)
        chunk_fn = decode_chunk_aligned if base_est + k <= self.capacity else decode_chunk
        mine = slice(self._slot_lo, self._slot_lo + min(self._slot_n, len(pool_slots)))
        tokens, _last, _pos, self.cache, n = chunk_fn(
            self.model, self.cache, self._tensor(cur[mine]), self._tensor(pos[mine]),
            self._tensor(active[mine]), k, eos=eos, graphs=self.graphs, return_steps=True)
        # the round's host read: the tokens [S, k] and the steps run
        tokens = self._gather_slots(tokens)
        host = torch.cat([tokens.flatten(), torch.as_tensor(n, dtype=tokens.dtype,
                                                            device=tokens.device).view(1)])
        host = host.cpu().numpy()
        tokens = host[:-1].reshape(tokens.shape)
        st["decode_steps"] += int(host[-1])
        st["decode_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        for i, slot in enumerate(pool_slots):
            if slot.request_id is None:
                continue
            slot.kv_len += k
            seq = tokens[i]
            # max_new_tokens 1 is the start token alone: the budget is spent
            # before any of the chunk's tokens
            finished = slot.remaining <= 0
            used = 0
            for t in seq:
                if finished:
                    break
                used += 1
                if int(t) == eos:
                    finished = True
                    break
                slot.out_ids.append(int(t))
                slot.remaining -= 1
                if slot.remaining <= 0:
                    finished = True
                    break
            slot.position = int(pos[i]) + used
            slot.cur_token = int(seq[used - 1])
            st["emitted_tokens"] += used
            if finished:
                self._finish(slot)
        st["host_s"] += time.perf_counter() - t0
        if self.pool_ladder:
            # drain-tail shrink: the next chunk runs at the rung that fits the
            # live slots and the backlog
            n_active = sum(s.request_id is not None for s in self.slots)
            target = self._rung(max(1, n_active + len(self._pending)))
            if target < self.pool:
                self._repack(target)

    def _spec_round(self, st, eos, pool_slots, active, cur, pos, t0) -> None:
        """The round's decode as one :func:`decode_chunk_spec` of up to
        ``chunk`` verify forwards, each slot's budget its remaining tokens,
        and its host bookkeeping (serving.py:1280-1314). ``decode_steps``
        counts the verify forwards run."""
        budget = np.asarray([max(s.remaining, 0) if s.request_id is not None else 0
                             for s in pool_slots], np.int32)
        mine = slice(self._slot_lo, self._slot_lo + self._slot_n)
        tokens, counts, fin, last, new_pos, self.cache, self._hist, self._hlen, n = \
            decode_chunk_spec(
                self.model, self.cache, self._tensor(cur[mine]), self._tensor(pos[mine]),
                self._tensor(active[mine]), self._tensor(budget[mine]), self._hist, self._hlen,
                self.chunk, eos, k_draft=self.spec_k, ngram=self.spec_ngram, graphs=self.graphs,
                return_steps=True)
        tokens, counts, fin, last, new_pos = (
            self._gather_slots(t).cpu().numpy()
            for t in (tokens, counts, fin.to(torch.int32), last, new_pos))  # the host read
        st["decode_steps"] += int(n)
        st["decode_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        for i, slot in enumerate(pool_slots):
            if slot.request_id is None:
                continue
            n = int(counts[i])
            slot.out_ids.extend(int(t) for t in tokens[i, :n])
            st["emitted_tokens"] += n
            slot.remaining -= n
            slot.position = int(new_pos[i])
            slot.cur_token = int(last[i])
            if bool(fin[i]) or slot.remaining <= 0:
                self._finish(slot)
        st["host_s"] += time.perf_counter() - t0
