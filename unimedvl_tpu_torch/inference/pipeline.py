"""Host-side inference orchestrator (port of
unimedvl_tpu/inference/pipeline.py::InterleaveInferencer): context set-up,
text, ViT and VAE image context updates, answer decoding (``gen_text``, also
keeping the answer in the context, and ``gen_text_stream``), ``chat`` (the VQA
entry point) and the stateful ``chat_turn``, and image generation:
``gen_image`` with the batched CFG flow loop, ``interleave_inference`` (text to
image, image editing), the vqa-reconstruction recipes (an answer, then the
input images generated again from it) and ``__call__``.

Contexts hold the KV cache, which the port updates in place. A context is a
cursor into that cache, not a snapshot: after ``update_context_*`` on a
context, use the returned one and drop the old. ``fork`` gives a context
storage of its own (a copy), so forks can be appended to independently, as
the CFG recipes do. ``gen_text`` and ``gen_text_stream`` write their decode kv
past the context's ``lens`` and never advance them, so asking twice on one
context gives the same answer; a context they return (``return_ctx``,
``result``, ``chat_turn``) shares the storage and has lens of its own.

With ``spec_decode`` greedy answers decode speculatively
(``bagel.generate_text_spec``, ``serving.decode_chunk_spec``): drafts looked
up in the context's text history (``GenContext.hist``: prompt and answer ids),
verified ``spec_k`` + 1 tokens a forward, the same tokens as the plain decode.

Every random draw (the initial noise of the flow loop, the VAE posterior
sample) comes from the inferencer's ``torch.Generator`` through ``_randn``.

With ``mesh`` (a ``parallel.mesh.Mesh`` with the axes ("data", "model"))
every rank runs the inferencer with the same arguments and seed and holds its
shard of the model (``parallel.mesh.place_params``): heads and the MLP
intermediate of both experts over "model", the vocab over "model", its part
of every KV cache; the CFG streams of a denoise step shard over "data" when
they divide it. Every rank returns the same answers and images.
``gen_images_grouped`` denoises G images at once over a ("data", "model",
"seq") mesh. With ``sp_mesh`` the flow loop runs as the sequence-parallel
program of ``parallel/sp_denoise.py`` over that mesh's ranks. On a mesh whose
groups are all NCCL the device programs run as on one device, with the
collectives inside their graphs; a mesh with a gloo group runs eagerly
(``inference.programs.use_graphs``).

Generation also runs as a resumable job (``start_gen_job``,
``advance_gen_job``, ``finish_gen_job``), a few flow steps at a time, which
the serving engine interleaves with its text decode; ``merge_gen_jobs`` joins
compatible jobs into one grouped job whose images share each step's forward
(``bagel.generate_latents_group``). A job chunked at any boundary gives the
one-shot ``gen_image``'s result.

"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from unimedvl_tpu_torch.config import TransformConfig
from unimedvl_tpu_torch.models import bagel
from unimedvl_tpu_torch.models.bagel import Bagel
from unimedvl_tpu_torch.models import qwen2_mot as mot
from unimedvl_tpu_torch.models.qwen2_mot import KVCache, check_kv_bits

# System prompts for think mode (inferencer.py:23-28).
VLM_THINK_SYSTEM_PROMPT = """You should first think about the reasoning process in the mind and then provide the user with the answer.
The reasoning process is enclosed within <think> </think> tags, i.e. <think> reasoning process here </think> answer here"""

GEN_THINK_SYSTEM_PROMPT = """You should first think about the planning process in your mind, and then generate the image.
The planning process is enclosed within <think> </think> tags; that is, <think> planning process here </think> image here.
"""

_CAPACITY_BUCKET = 512


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class GenContext:
    """One conversation context: cache + host bookkeeping (kv length and next
    rope position). ``hist``: the running text id history (prompts and
    answers; image blocks are not recorded), where the speculative decode
    looks up its drafts."""

    cache: KVCache
    kv_len: int = 0
    rope: int = 0
    hist: Tuple[int, ...] = ()

    def fork(self) -> "GenContext":
        """A context with the same contents in storage of its own: appending
        to either leaves the other as it was."""
        return GenContext(cache=self.cache.clone(), kv_len=self.kv_len, rope=self.rope,
                          hist=self.hist)


@dataclasses.dataclass
class GenImageJob:
    """A resumable text-to-image denoise (pipeline.py:71-91): made by
    :meth:`InterleaveInferencer.start_gen_job`, advanced a few flow steps at
    a time by ``advance_gen_job``, decoded by ``finish_gen_job``. ``x_t`` is
    [n, p*p*z] for one image, [G, n, p*p*z] for a group from
    ``merge_gen_jobs``, whose ``caches`` then hold the images' streams
    g-major."""

    image_shape: Tuple[int, int]
    caches: KVCache  # stacked [main, cfg_text?, cfg_img?] context streams, per image
    positions: torch.Tensor
    pos_ids: torch.Tensor
    x_t: torch.Tensor
    step: int  # flow steps done
    total_steps: int  # num_timesteps - 1
    kw: Dict[str, Any]

    @property
    def done(self) -> bool:
        return self.step >= self.total_steps


class InterleaveInferencer:
    def __init__(
        self,
        model: Bagel,
        tokenizer,
        new_token_ids: Dict[str, int],
        vae_transform=None,
        vit_transform=None,
        seed: int = 0,
        *,
        mesh=None,
        sp_mesh=None,
        kv_quantized: bool = False,
        kv_bits: int = 8,
        spec_decode: bool = False,
        spec_k: int = 7,
        spec_ngram: int = 3,
        graphs: Optional[bool] = None,
    ):
        """The positional parameters come in the JAX inferencer's order, with
        ``model`` in the place of its ``params, cfg``; the rest are
        keyword-only.

        ``model``: a Bagel on its device (built ``with_vae`` for image
        generation and VAE image contexts); ``tokenizer``: anything with
        ``encode``/``decode`` whose special tokens went through
        ``unimedvl_tpu_torch.data.tokenizer.add_special_tokens`` (which gave
        ``new_token_ids``); ``vit_transform`` / ``vae_transform``:
        ``unimedvl_tpu_torch.data.imaging.ImageTransform``s (defaults: the
        interactive ViT and VAE geometries, built at the first image);
        ``seed``: seeds the generator of every random draw;
        ``kv_quantized``: int8 KV caches with per-key scales for every
        context (half the cache bytes of a decode step and of a long
        context; a non-parity mode, like the quantized weights);
        ``kv_bits``: their width, 8, or 4 for int4 values packed two to a
        byte (a quarter of the bf16 cache's bytes; a further accuracy step).
        ``spec_decode``: prompt-lookup speculative decoding of greedy answers
        (``bagel.generate_text_spec``): ``spec_k`` drafts verified per forward,
        looked up after the latest earlier occurrence of the trailing
        ``spec_ngram`` ids of the context's text history; the same answer as
        the plain decode. A sampling request decodes plainly.
        ``sp_mesh``: a ``parallel.mesh.Mesh`` with the axes ("model", "seq").
        The denoise loop then goes through
        ``parallel.sp_denoise.generate_latents_tp_sp`` (latents sharded over
        "seq", heads over "model") whenever the latent count divides the
        "seq" axis and the kv heads the "model" axis, on this rank's shard of
        the model (placed once from a whole one); every rank of the mesh runs
        the same inferencer with the same seed. Context builds and text
        decoding stay single-device. Not with ``kv_quantized``: that path
        reads the context cache in the model's dtype.
        ``mesh``: a ``parallel.mesh.Mesh`` with the axes ("data", "model");
        ``model`` is whole (this rank's shard is placed from it) or already a
        rank's shard of this mesh (``load_bagel_checkpoint(mesh=...)``).
        Every rank of the mesh runs the same calls with the same seed; the
        answers and images are the single-device ones. With ``sp_mesh`` too,
        the two must span the same ranks in the same order.
        ``graphs``: the route of the context builds (the text, ViT and VAE
        prefills and the VAE encode), of the answer decodes (``gen_text``,
        greedy or sampled, kept in the context or not, speculative or not),
        of ``gen_text_stream``'s chunks, of the flow loop and of the VAE
        decode (``inference.programs.use_graphs``): by default, on a CUDA
        device, the captured device programs (``bagel.PrefillProgram``,
        ``bagel.DecodeProgram``, ``bagel.SpecProgram``,
        ``serving.ChunkProgram``, ``bagel.FlowProgram``, and the
        sequence-parallel denoise's ``sp_denoise.SPProgram``); on a
        ``mesh`` or ``sp_mesh`` whose groups are all NCCL too, with the
        collectives inside the graphs, and eagerly on one with a gloo group;
        False their eager versions."""
        if kv_quantized:
            check_kv_bits(kv_bits)
        if kv_quantized and sp_mesh is not None:
            raise ValueError(
                "kv_quantized=True is not supported with sp_mesh "
                "(parallel/sp_denoise.py reads the context cache in the model's dtype)"
            )
        if mesh is not None:
            from unimedvl_tpu_torch.parallel.mesh import place_params

            if mesh.axis_names != ("data", "model"):
                raise ValueError(f"mesh must have the axes ('data', 'model'), got "
                                 f"{mesh.axis_names}")
            if sp_mesh is not None and (
                    int(np.prod(list(mesh.shape.values())))
                    != int(np.prod(list(sp_mesh.shape.values()))) or mesh.rank != sp_mesh.rank):
                raise ValueError("mesh and sp_mesh must span the same ranks in the same order")
            placed = getattr(model.language_model, "mesh", None)
            if placed is None:
                model = place_params(model, mesh)
            elif placed.shape != mesh.shape or placed.rank != mesh.rank:
                raise ValueError(f"the model is a shard of a mesh {placed.shape}, not of "
                                 f"{mesh.shape}")
        self.mesh = mesh
        self.sp_mesh = sp_mesh
        #: (mesh, this rank's model of it) for the sequence-parallel denoise of a whole model
        self._sp_placed = None
        self.kv_quantized = kv_quantized
        self.kv_bits = kv_bits
        self.spec_decode = spec_decode
        self.spec_k = spec_k
        self.spec_ngram = spec_ngram
        self.graphs = graphs
        self.model = model
        self.cfg = model.config
        self.tokenizer = tokenizer
        self.new_token_ids = new_token_ids
        self.vit_transform = vit_transform
        self.vae_transform = vae_transform
        norm = model.language_model.model.norm.weight
        self.device, self.dtype = norm.device, norm.dtype
        self._generator = torch.Generator(device=self.device).manual_seed(seed)

    def _randn(self, shape) -> torch.Tensor:
        """Standard normal fp32 noise on the device, from the inferencer's
        generator: the only source of randomness of image generation."""
        return torch.randn(shape, generator=self._generator, device=self.device,
                           dtype=torch.float32)

    # -- context management --------------------------------------------------
    def init_gen_context(self, capacity: int = _CAPACITY_BUCKET) -> GenContext:
        llm = self.cfg.llm
        cache = KVCache.create(
            llm.num_hidden_layers, 1, capacity, llm.num_key_value_heads,
            llm.head_dim, dtype=self.dtype, device=self.device,
            quantized=self.kv_quantized, kv_bits=self.kv_bits,
        )
        return GenContext(cache=cache)

    def _ensure_capacity(self, ctx: GenContext, additional: int) -> GenContext:
        """Grow the cache (zero-padded, in 512-column buckets) so that
        ``kv_len + additional`` columns fit; the grown cache is a new tensor."""
        needed = ctx.kv_len + additional
        cap = ctx.cache.capacity
        if needed <= cap:
            return ctx
        pad = _round_up(needed, _CAPACITY_BUCKET) - cap
        from unimedvl_tpu_torch.inference import programs

        programs.drop_reading(ctx.cache.k, ctx.cache.v, ctx.cache.k_scale, ctx.cache.v_scale)
        return dataclasses.replace(ctx, cache=ctx.cache.padded(pad))

    # -- text ----------------------------------------------------------------
    def _encode_prompt(self, text: str) -> List[int]:
        ids = self.tokenizer.encode(text)
        return [self.new_token_ids["bos_token_id"]] + ids + [self.new_token_ids["eos_token_id"]]

    def update_context_text(self, text: str, ctx: GenContext) -> GenContext:
        """Causal text append: bos + ids + eos, padded to a multiple of 32."""
        ids = self._encode_prompt(text)
        T = len(ids)
        T_pad = max(32, _round_up(T, 32))
        ctx = self._ensure_capacity(ctx, T_pad)
        padded = np.zeros(T_pad, np.int64)
        padded[:T] = ids
        positions = np.zeros(T_pad, np.int64)
        positions[:T] = np.arange(ctx.rope, ctx.rope + T)
        dev = self.device
        cache = bagel.prefill_text(
            self.model, ctx.cache,
            torch.from_numpy(padded)[None].to(dev),
            torch.from_numpy(positions)[None].to(dev),
            (torch.arange(T_pad) < T)[None].to(dev), graphs=self.graphs,
        )
        return GenContext(cache=cache, kv_len=ctx.kv_len + T, rope=ctx.rope + T,
                          hist=ctx.hist + tuple(ids))

    # -- images --------------------------------------------------------------
    @staticmethod
    def _transform(transform, default: TransformConfig):
        if transform is not None:
            return transform
        from unimedvl_tpu_torch.data import imaging  # imports PIL

        return imaging.ImageTransform(
            default.max_size, default.min_size, default.stride, default.max_pixels
        )

    @staticmethod
    def _resized_u8(image, transform) -> np.ndarray:
        """A PIL image, or a uint8 [H, W, 3] array, resized by ``transform``
        (PIL bicubic). An array already at the target size is used as is."""
        from unimedvl_tpu_torch.data import imaging  # imports PIL

        rt = transform.resize_transform
        if isinstance(image, np.ndarray):
            if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
                raise ValueError(
                    f"image arrays must be uint8 [H, W, 3], got {image.dtype} {image.shape}"
                )
            H, W = image.shape[:2]
            size = imaging.compute_resize_shape(
                W, H, rt.max_size, rt.min_size, rt.stride, rt.max_pixels
            )
            if size == (W, H):
                return image
            image = imaging.Image.fromarray(image)
        return np.asarray(rt(imaging.pil_img2rgb(image)), dtype=np.uint8)

    def _vit_resized_u8(self, image) -> np.ndarray:
        self.vit_transform = self._transform(self.vit_transform, TransformConfig.vit_interactive())
        return self._resized_u8(image, self.vit_transform)

    def _vae_resized_u8(self, image) -> np.ndarray:
        self.vae_transform = self._transform(self.vae_transform, TransformConfig.vae_interactive())
        return self._resized_u8(image, self.vae_transform)

    def _position_ids(self, H: int, W: int, patch: int, max_side: int) -> np.ndarray:
        from unimedvl_tpu_torch.data import imaging

        position_ids = (
            imaging.position_ids_interpolate if self.cfg.interpolate_pos
            else imaging.position_ids_extrapolate
        )
        return position_ids(H, W, patch, max_side)

    def _start_end(self) -> torch.Tensor:
        return torch.tensor(
            [self.new_token_ids["start_of_image"], self.new_token_ids["end_of_image"]],
            device=self.device,
        )

    def _update_context_vae(self, image, ctx: GenContext) -> GenContext:
        """VAE image append through the gen expert (inferencer.py:131-162):
        encode with a posterior sample, then the bucketed gen-mode prefill."""
        if not hasattr(self.model, "vae_model"):
            raise ValueError("a VAE image context needs a Bagel built with_vae (or load_ae)")
        u8 = self._vae_resized_u8(image)
        H, W = u8.shape[:2]
        ld, vae = self.cfg.latent_downsample, self.cfg.vae
        n = (H // ld) * (W // ld)
        pos_ids = self._position_ids(H, W, ld, self.cfg.max_latent_size)
        bucket = bagel.vit_token_bucket(n)
        # the whole padded block is written before its padding is masked
        ctx = self._ensure_capacity(ctx, bucket + 2)
        image_t = bagel.preprocess_vae_image(torch.tensor(u8, device=self.device))
        noise = self._randn((1, vae.z_channels, H // vae.downsample, W // vae.downsample))
        tokens = bagel.encode_vae_latent_tokens(self.model, image_t, noise, graphs=self.graphs)
        tokens = F.pad(tokens, (0, 0, 0, bucket - n))
        padded_pos = np.zeros(bucket, np.int64)
        padded_pos[:n] = pos_ids
        cache = bagel.prefill_vae_bucketed(
            self.model, ctx.cache, tokens, torch.from_numpy(padded_pos)[None].to(self.device),
            n, self._start_end(), ctx.rope, graphs=self.graphs,
        )
        return dataclasses.replace(ctx, cache=cache, kv_len=ctx.kv_len + n + 2, rope=ctx.rope + 1)

    def update_context_image(self, image, ctx: GenContext, vae: bool = True,
                             vit: bool = True) -> GenContext:
        """Image append (inferencer.py:131-162): the VAE latents through the
        gen expert, then the ViT tokens through the und expert, as asked.
        ``image``: a PIL image or a uint8 [H, W, 3] array."""
        if not (vae or vit):
            raise ValueError("update_context_image needs vae=True or vit=True")
        if vae:
            ctx = self._update_context_vae(image, ctx)
        if not vit:
            return ctx
        u8 = self._vit_resized_u8(image)
        H, W = u8.shape[:2]
        p = self.cfg.vit.patch_size
        n = (H // p) * (W // p)
        pos_ids = self._position_ids(H, W, p, self.cfg.vit_max_num_patch_per_side)
        bucket = bagel.vit_token_bucket(n)
        # the whole padded block is written before its padding is masked
        ctx = self._ensure_capacity(ctx, bucket + 2)
        tokens = bagel.preprocess_vit_image(
            self.cfg, torch.tensor(u8, device=self.device)
        )
        tokens = F.pad(tokens, (0, 0, 0, bucket - n))
        padded_pos = np.zeros(bucket, np.int64)
        padded_pos[:n] = pos_ids
        cache = bagel.prefill_vit_bucketed(
            self.model, ctx.cache, tokens,
            torch.from_numpy(padded_pos)[None].to(self.device), n, self._start_end(), ctx.rope,
            graphs=self.graphs,
        )
        return dataclasses.replace(ctx, cache=cache, kv_len=ctx.kv_len + n + 2, rope=ctx.rope + 1)

    # -- text generation -----------------------------------------------------
    def _hist_rows(self, ctx: GenContext, start: int, max_length: int):
        """The speculative decode's history: the context's text ids and the
        start token, in a row of HL columns (room for the answer and a draft
        window, rounded up to 256), and its length; both on the device."""
        hist = list(ctx.hist) + [start]
        HL = _round_up(len(hist) + max_length + self.spec_k, 256)
        row = np.zeros((1, HL), np.int32)
        row[0, :len(hist)] = hist
        return (torch.from_numpy(row).to(self.device),
                torch.tensor([len(hist)], dtype=torch.int32, device=self.device))

    def _parse(self, ids: List[int]) -> Tuple[str, bool]:
        """The answer text of ``ids`` (reference parsing, bagel.py:1389-1391)
        and whether it reached <|im_end|>."""
        text = self.tokenizer.decode(ids)
        done = "<|im_end|>" in text
        text = text.split("<|im_end|>")[0]
        if "<|im_start|>" in text:
            text = text.split("<|im_start|>")[1]
        return text, done

    def gen_text(self, ctx: GenContext, max_length: int = 500, do_sample: bool = False,
                 temperature: float = 1.0, *,
                 return_ctx: bool = False) -> Union[str, Tuple[str, GenContext]]:
        """Decode an answer (inferencer.py:259-279; bagel.py:1236-1317). The
        caller's context is unaffected: decode kv lands past its lens.

        ``return_ctx``: also return the context after the answer, whose cache
        holds the start token and every emitted token (the reference's
        cache-keeping decode, bagel.py:1259-1314), so that the next turn
        prefills only its own text; it shares the caller's storage. Greedy
        with ``spec_decode``: the speculative decode (capacity for
        max_length + spec_k + 1 more columns); else with ``return_ctx``: the
        contiguous-cache decode; else the aligned-column decode."""
        use_spec = self.spec_decode and not do_sample
        ctx = self._ensure_capacity(ctx, max_length + (self.spec_k + 1 if use_spec else 1))
        bos, eos = self.new_token_ids["bos_token_id"], self.new_token_ids["eos_token_id"]
        start = torch.tensor([bos], device=self.device)
        positions = torch.tensor([ctx.rope], device=self.device)
        if use_spec:
            hist, hlen = self._hist_rows(ctx, bos, max_length)
            out, lengths, cache, _ = bagel.generate_text_spec(
                self.model, ctx.cache, start, positions, max_length, eos, hist, hlen,
                k_draft=self.spec_k, ngram=self.spec_ngram, graphs=self.graphs)
        elif return_ctx:
            out, lengths, cache = bagel.generate_text_ctx(
                self.model, ctx.cache, start, positions, max_length, eos, do_sample,
                temperature, self._generator, graphs=self.graphs)
        else:
            out, lengths = bagel.generate_text(
                self.model, ctx.cache, start, positions, max_length, eos, do_sample,
                temperature, self._generator, graphs=self.graphs)
        ids = [i for i in out[0].tolist() if i >= 0]
        text, _ = self._parse(ids)
        if not return_ctx:
            return text
        n = int(lengths[0])
        return text, GenContext(cache=cache, kv_len=ctx.kv_len + n, rope=ctx.rope + n,
                                hist=ctx.hist + tuple(ids))

    def gen_text_stream(self, ctx: GenContext, max_length: int = 500, chunk: int = 8,
                        result: Optional[dict] = None):
        """Greedy decode as a generator of text increments
        (pipeline.py:460-609): the decode runs in chunks of ``chunk`` steps
        (``serving.decode_chunk`` at S = 1) or, with ``spec_decode``, of
        ``chunk`` verify forwards (``serving.decode_chunk_spec``), with one
        host read a chunk: by the route of ``graphs``, the chunks' programs
        over buffers of the cache's shape (``static=True``: nothing is
        captured anew for a new request), or their eager loops, one host read
        a step or a verify forward. The pieces concatenate to
        ``gen_text``'s answer: each yield decodes the id prefix but its last
        id (which may merge with the next), with a trailing U+FFFD trimmed.
        Stops at eos, <|im_end|> or ``max_length``. The caller's context is
        unaffected: decode kv lands past its lens, and the chunks return new
        lens.

        ``result``: a dict filled at the end with ``text`` (the answer) and
        ``ctx`` (the context after it, as ``gen_text(return_ctx=True)``
        gives it; the newest token's pending kv is written by one more T = 1
        forward). The plain path's capacity covers a whole chunk past
        ``max_length``, since a chunk may run on past it."""
        from unimedvl_tpu_torch.inference.serving import decode_chunk, decode_chunk_spec

        use_spec = self.spec_decode
        ctx = self._ensure_capacity(ctx, max_length + (self.spec_k + 1 if use_spec else chunk))
        eos = self.new_token_ids["eos_token_id"]
        cache = ctx.cache
        cur = self.new_token_ids["bos_token_id"]
        pos = ctx.rope
        ids = [cur]
        emitted = ""
        stop = False
        pending = True  # the newest emitted token's kv is not yet written
        plain_forwards = 0  # the plain path's steps run so far
        dev = self.device
        one = torch.ones((1,), dtype=torch.bool, device=dev)
        if use_spec:
            hist, hlen = self._hist_rows(ctx, cur, max_length)

        while len(ids) < max_length and not stop:
            cur_t = torch.tensor([cur], dtype=torch.int32, device=dev)
            pos_t = torch.tensor([pos], dtype=torch.int64, device=dev)
            if use_spec:
                budget = torch.tensor([max_length - len(ids)], dtype=torch.int32, device=dev)
                tokens, counts, fin, last, new_pos, cache, hist, hlen = decode_chunk_spec(
                    self.model, cache, cur_t, pos_t, one, budget, hist, hlen, chunk, eos,
                    k_draft=self.spec_k, ngram=self.spec_ngram, graphs=self.graphs,
                    static=True)
                n = int(counts[0])
                ids.extend(tokens[0, :n].tolist())
                pos, cur = int(new_pos[0]), int(last[0])
                if bool(fin[0]):
                    stop = True
                    pending = pending and n > 0  # an immediate eos consumed the pending token
                stop = stop or len(ids) >= max_length
            else:
                tokens, _last, _pos, cache = decode_chunk(
                    self.model, cache, cur_t, pos_t, one, chunk, eos=eos, graphs=self.graphs,
                    static=True)
                seq = tokens[0].tolist()
                used = 0
                hit_eos = False
                for t in seq:
                    used += 1
                    if t == eos:
                        stop = hit_eos = True
                        break
                    ids.append(t)
                    if len(ids) >= max_length:
                        stop = True
                        break
                pos += used
                cur = seq[used - 1]
                # the steps run: up to the eos step, else the whole chunk (it
                # exits early on eos only); the newest token has kv once the
                # forwards cover every id
                plain_forwards += used if hit_eos else len(seq)
                pending = plain_forwards < len(ids)
            text, done = self._parse(ids if stop else ids[:-1])
            stop = stop or done
            text = text if stop else text.rstrip("\ufffd")
            if text.startswith(emitted) and len(text) > len(emitted):
                yield text[len(emitted):]
                emitted = text

        final, _ = self._parse(ids)
        if final.startswith(emitted) and len(final) > len(emitted):
            yield final[len(emitted):]
        if result is None:
            return
        if pending:
            lm = self.model.language_model
            x = mot.embed_tokens(lm, torch.tensor([cur], device=dev))[:, None, :]
            with torch.no_grad():
                _, cache = lm.model(x, torch.tensor([[pos]], device=dev), cache, causal=True)
        n = len(ids)
        result["text"] = final
        result["ctx"] = GenContext(
            cache=dataclasses.replace(cache, lens=ctx.cache.lens + n),
            kv_len=ctx.kv_len + n, rope=ctx.rope + n, hist=ctx.hist + tuple(ids))

    def chat(self, images: List, prompt: str, max_length: int = 512,
             do_sample: bool = False, temperature: float = 1.0) -> str:
        """VQA / report generation (bagel.py:1321-1391): ViT-only image
        context, then the prompt, then decode. Images are PIL images or uint8
        [H, W, 3] arrays."""
        ctx = self.init_gen_context()
        for image in images:
            ctx = self.update_context_image(image, ctx, vae=False, vit=True)
        ctx = self.update_context_text(prompt, ctx)
        return self.gen_text(
            ctx, max_length=max_length, do_sample=do_sample, temperature=temperature
        )

    def chat_turn(self, ctx: Optional[GenContext], prompt: str, images: Optional[List] = None,
                  max_length: int = 512, do_sample: bool = False,
                  temperature: float = 1.0) -> Tuple[str, GenContext]:
        """One turn of a stateful chat (pipeline.py:1281-1306): the images
        (ViT only) and the prompt appended to ``ctx`` (None starts a
        conversation), an answer decoded, and (answer, the context after it),
        whose cache already holds the answer, so the next turn prefills only
        its own text. The new context shares the storage of ``ctx``."""
        if ctx is None:
            ctx = self.init_gen_context()
        for image in images or []:
            ctx = self.update_context_image(image, ctx, vae=False, vit=True)
        ctx = self.update_context_text(prompt, ctx)
        return self.gen_text(ctx, max_length=max_length, do_sample=do_sample,
                             temperature=temperature, return_ctx=True)

    # -- image generation ----------------------------------------------------
    def _stack_contexts(self, contexts: List[GenContext]) -> Tuple[KVCache, torch.Tensor]:
        """Stack 1-3 single-stream caches into one multi-stream cache, each
        zero-padded to the largest capacity; returns it and each context's
        rope position."""
        cap = max(c.cache.capacity for c in contexts)
        stacked = KVCache.stack([c.cache.padded(cap - c.cache.capacity) for c in contexts])
        positions = torch.tensor([c.rope for c in contexts], device=self.device)
        return stacked, positions

    def start_gen_job(
        self,
        image_shape: Tuple[int, int],
        gen_context: GenContext,
        cfg_text_scale: float = 4.0,
        cfg_img_scale: float = 1.5,
        cfg_text_precontext: Optional[GenContext] = None,
        cfg_img_precontext: Optional[GenContext] = None,
        cfg_interval: Tuple[float, float] = (0.4, 1.0),
        cfg_renorm_min: float = 0.0,
        cfg_renorm_type: str = "global",
        num_timesteps: int = 50,
        timestep_shift: float = 3.0,
    ) -> GenImageJob:
        """A denoise not yet started, with :meth:`gen_image`'s options and
        contexts: the main context and the CFG contexts in use stacked as the
        streams of one cache, and the initial noise, drawn from the
        inferencer's generator as the one-shot path draws it (one draw a
        job, in the order the jobs start), so a job run to its end gives the
        one-shot result."""
        H, W = image_shape
        ld = self.cfg.latent_downsample
        use_text_cfg = cfg_text_scale > 1.0 and cfg_text_precontext is not None
        use_img_cfg = cfg_img_scale > 1.0 and cfg_img_precontext is not None
        contexts = [gen_context]
        if use_text_cfg:
            contexts.append(cfg_text_precontext)
        if use_img_cfg:
            contexts.append(cfg_img_precontext)
        caches, positions = self._stack_contexts(contexts)
        pos_ids = self._position_ids(H, W, ld, self.cfg.max_latent_size)
        noise = self._randn(((H // ld) * (W // ld), self.cfg.patch_latent_dim))
        kw = dict(
            num_timesteps=num_timesteps, timestep_shift=timestep_shift,
            cfg_text_scale=cfg_text_scale, cfg_img_scale=cfg_img_scale,
            cfg_interval=tuple(cfg_interval), cfg_renorm_min=cfg_renorm_min,
            cfg_renorm_type=cfg_renorm_type, use_text_cfg=use_text_cfg,
            use_img_cfg=use_img_cfg,
        )
        return GenImageJob(image_shape=image_shape, caches=caches, positions=positions,
                           pos_ids=torch.from_numpy(pos_ids).to(self.device), x_t=noise, step=0,
                           total_steps=num_timesteps - 1, kw=kw)

    def advance_gen_job(self, job: GenImageJob, steps: int) -> GenImageJob:
        """The job after its next ``steps`` flow steps (fewer at the end):
        ``bagel.generate_latents`` over ``step_range``, or
        ``generate_latents_group`` for a grouped job, every image in one
        forward a step."""
        if job.done:
            return job
        hi = min(job.step + steps, job.total_steps)
        fn = bagel.generate_latents_group if job.x_t.dim() == 3 else bagel.generate_latents
        x_t = fn(self.model, job.caches, job.positions, job.pos_ids, job.x_t, self._start_end(),
                 step_range=(job.step, hi), graphs=self.graphs, **job.kw)
        return dataclasses.replace(job, x_t=x_t, step=hi)

    def merge_gen_jobs(self, jobs: List[GenImageJob]) -> GenImageJob:
        """G compatible jobs (one geometry, the same options, at the same
        step, caches of one shape) as one grouped job: the caches joined
        g-major on the stream dim (a copy), the states stacked."""
        j0 = jobs[0]
        for j in jobs[1:]:
            if (j.image_shape != j0.image_shape or j.kw != j0.kw
                    or (j.step, j.total_steps) != (j0.step, j0.total_steps)
                    or j.caches.k.shape != j0.caches.k.shape):
                raise ValueError("merge_gen_jobs: the jobs differ in geometry, options, step "
                                 "or cache shape")
        if len(jobs) == 1:
            return j0
        return dataclasses.replace(
            j0, caches=KVCache.stack([j.caches for j in jobs]),
            positions=torch.cat([j.positions for j in jobs]),
            x_t=torch.stack([j.x_t for j in jobs]))

    def finish_gen_job(self, job: GenImageJob):
        """The finished job's image (PIL); a grouped job takes
        :meth:`finish_gen_job_group`."""
        if not job.done or job.x_t.dim() != 2:
            raise ValueError("finish_gen_job: the job is not done, or is grouped")
        return self.decode_image(job.x_t, job.image_shape)

    def finish_gen_job_group(self, job: GenImageJob) -> List:
        """The finished job's images (PIL), one per member."""
        if not job.done:
            raise ValueError("finish_gen_job_group: the job is not done")
        x_t = job.x_t if job.x_t.dim() == 3 else job.x_t[None]
        return [self.decode_image(x, job.image_shape) for x in x_t]

    def gen_image_latent(self, image_shape: Tuple[int, int], gen_context: GenContext,
                         **kw) -> torch.Tensor:
        """Denoise to the final latent tokens [h*w, p*p*z] fp32, without the
        VAE decode; :meth:`gen_image`'s options. The main context and the CFG
        contexts in use run as the streams of one batched forward per step."""
        job = self.start_gen_job(image_shape, gen_context, **kw)
        mesh = self.sp_mesh
        if (
            mesh is not None
            and job.x_t.shape[0] % mesh.shape["seq"] == 0
            # a rank's shard of ``self.mesh`` holds its kv heads already
            and (self.mesh is not None
                 or self.cfg.llm.num_key_value_heads % mesh.shape["model"] == 0)
            # the sequence-parallel attention routes through the MoT gen twins;
            # other configs take the single-device denoise
            and self.cfg.llm.mot_attention
        ):
            from unimedvl_tpu_torch.parallel.sp_denoise import generate_latents_tp_sp

            model, (caches,) = self._sp_rank(mesh, [job.caches])
            return generate_latents_tp_sp(
                model, caches, job.positions, job.pos_ids, job.x_t, self._start_end(), mesh,
                graphs=self.graphs, **job.kw)
        return self.advance_gen_job(job, job.total_steps).x_t

    def _sp_rank(self, mesh, caches: List[KVCache]):
        """This rank's model and kv heads of ``caches`` for the
        sequence-parallel denoise over ``mesh``: the inferencer's own when its
        model is a rank's shard already (``mesh=``) or "model" has one rank;
        else the rank's shard of the whole model, placed once
        (``parallel.mesh.place_params``: views of its tensors), and the
        caches' kv heads of that rank. Context builds stay on the whole
        model."""
        if self.mesh is not None or mesh.shape["model"] == 1:
            return self.model, caches
        from unimedvl_tpu_torch.parallel import mesh as pmesh

        if self._sp_placed is None or self._sp_placed[0] is not mesh:
            self._sp_placed = (mesh, pmesh.place_params(self.model, mesh))
        return self._sp_placed[1], [pmesh.shard_kv_heads(c, self.cfg, mesh) for c in caches]

    def gen_image_latents_grouped(
        self,
        image_shape: Tuple[int, int],
        gen_contexts: List[GenContext],
        group_mesh,
        cfg_text_precontexts: Optional[List[GenContext]] = None,
        cfg_img_precontexts: Optional[List[GenContext]] = None,
        cfg_text_scale: float = 4.0,
        cfg_img_scale: float = 1.5,
        cfg_interval: Tuple[float, float] = (0.4, 1.0),
        cfg_renorm_min: float = 0.0,
        cfg_renorm_type: str = "global",
        num_timesteps: int = 50,
        timestep_shift: float = 3.0,
    ) -> torch.Tensor:
        """G images denoised at once over a ("data", "model", "seq")
        ``group_mesh`` (pipeline.py:909-981): image g runs the
        sequence-parallel program (``parallel.sp_denoise
        .generate_latents_dp_tp_sp``) on the ("model", "seq") sub-mesh of
        data rank g. The images share ``image_shape`` and the CFG options;
        each image's caches are padded to one capacity; the noise is drawn
        per image from the inferencer's generator, in image order. Returns
        the latents [G, h*w, p*p*z] fp32 on every rank."""
        G = len(gen_contexts)
        if group_mesh.axis_names != ("data", "model", "seq"):
            raise ValueError(f"group_mesh must have the axes ('data', 'model', 'seq'), got "
                             f"{group_mesh.axis_names}")
        if group_mesh.shape["data"] != G:
            raise ValueError(f"{G} images for a data axis of {group_mesh.shape['data']}")
        if not self.cfg.llm.mot_attention:
            raise ValueError("the grouped denoise routes projections through the MoT gen "
                             "experts: the config needs mot_attention")
        H, W = image_shape
        ld = self.cfg.latent_downsample
        n = (H // ld) * (W // ld)
        if n % group_mesh.shape["seq"]:
            raise ValueError(f"{n} latent tokens do not split over seq={group_mesh.shape['seq']}")
        use_text_cfg = cfg_text_scale > 1.0 and cfg_text_precontexts is not None
        use_img_cfg = cfg_img_scale > 1.0 and cfg_img_precontexts is not None
        group_caches, group_positions = [], []
        for g in range(G):
            contexts = [gen_contexts[g]]
            if use_text_cfg:
                contexts.append(cfg_text_precontexts[g])
            if use_img_cfg:
                contexts.append(cfg_img_precontexts[g])
            caches, positions = self._stack_contexts(contexts)
            group_caches.append(caches)
            group_positions.append(positions)
        cap = max(c.capacity for c in group_caches)
        group_caches = [c.padded(cap - c.capacity) for c in group_caches]
        pos_ids = torch.from_numpy(
            self._position_ids(H, W, ld, self.cfg.max_latent_size)).to(self.device)
        group_noise = [self._randn((n, self.cfg.patch_latent_dim)) for _ in range(G)]
        from unimedvl_tpu_torch.parallel.sp_denoise import generate_latents_dp_tp_sp

        model, group_caches = self._sp_rank(group_mesh, group_caches)
        return generate_latents_dp_tp_sp(
            model, group_caches, group_positions, [pos_ids] * G, group_noise,
            self._start_end(), group_mesh, num_timesteps=num_timesteps,
            timestep_shift=timestep_shift, cfg_text_scale=cfg_text_scale,
            cfg_img_scale=cfg_img_scale, cfg_interval=tuple(cfg_interval),
            cfg_renorm_min=cfg_renorm_min, cfg_renorm_type=cfg_renorm_type,
            use_text_cfg=use_text_cfg, use_img_cfg=use_img_cfg, graphs=self.graphs)

    def gen_images_grouped(self, image_shape: Tuple[int, int], gen_contexts: List[GenContext],
                           group_mesh, cfg_text_precontexts: Optional[List[GenContext]] = None,
                           cfg_img_precontexts: Optional[List[GenContext]] = None,
                           **kw) -> List:
        """:meth:`gen_image_latents_grouped`, then each image VAE-decoded in
        turn (PIL images, in context order)."""
        latents = self.gen_image_latents_grouped(
            image_shape, gen_contexts, group_mesh, cfg_text_precontexts=cfg_text_precontexts,
            cfg_img_precontexts=cfg_img_precontexts, **kw)
        return [self.decode_image(latents[g], image_shape) for g in range(latents.shape[0])]

    def decode_image(self, latent_tokens: torch.Tensor, image_shape: Tuple[int, int]):
        """Latent tokens -> a PIL RGB image of ``image_shape`` (H, W)."""
        from PIL import Image

        H, W = image_shape
        ld = self.cfg.latent_downsample
        img = bagel.decode_latent_to_image(self.model, latent_tokens, H // ld, W // ld,
                                           graphs=self.graphs)
        return Image.fromarray(img.cpu().numpy())

    def gen_image(
        self,
        image_shape: Tuple[int, int],
        gen_context: GenContext,
        cfg_text_scale: float = 4.0,
        cfg_img_scale: float = 1.5,
        cfg_text_precontext: Optional[GenContext] = None,
        cfg_img_precontext: Optional[GenContext] = None,
        cfg_interval: Tuple[float, float] = (0.4, 1.0),
        cfg_renorm_min: float = 0.0,
        cfg_renorm_type: str = "global",
        num_timesteps: int = 50,
        timestep_shift: float = 3.0,
    ):
        """Text- and image-conditioned generation with dual CFG
        (inferencer.py:165-232); returns a PIL image."""
        latent = self.gen_image_latent(
            image_shape, gen_context, cfg_text_scale=cfg_text_scale,
            cfg_img_scale=cfg_img_scale, cfg_text_precontext=cfg_text_precontext,
            cfg_img_precontext=cfg_img_precontext, cfg_interval=cfg_interval,
            cfg_renorm_min=cfg_renorm_min, cfg_renorm_type=cfg_renorm_type,
            num_timesteps=num_timesteps, timestep_shift=timestep_shift,
        )
        return self.decode_image(latent, image_shape)

    # -- top-level recipes ---------------------------------------------------
    def interleave_inference(
        self,
        input_lists: List[Any],
        think: bool = False,
        understanding_output: bool = False,
        max_think_token_n: int = 1000,
        do_sample: bool = False,
        text_temperature: float = 0.3,
        cfg_text_scale: float = 3.0,
        cfg_img_scale: float = 1.5,
        cfg_interval: Tuple[float, float] = (0.4, 1.0),
        timestep_shift: float = 3.0,
        num_timesteps: int = 50,
        cfg_renorm_min: float = 0.0,
        cfg_renorm_type: str = "global",
        image_shapes: Tuple[int, int] = (1024, 1024),
    ) -> List[Any]:
        """The interleaved recipe (inferencer.py:552-638): strings and images
        (PIL, or uint8 [H, W, 3] arrays) into the context, then an answer
        (``understanding_output``) or an image. The cfg_text context is the
        context before the latest text; the cfg_img context holds the texts
        only."""
        output_list: List[Any] = []
        gen_context = self.init_gen_context()
        cfg_img_context = gen_context.fork()
        cfg_text_context = gen_context.fork()
        if think:
            sp = VLM_THINK_SYSTEM_PROMPT if understanding_output else GEN_THINK_SYSTEM_PROMPT
            gen_context = self.update_context_text(sp, gen_context)
            cfg_img_context = self.update_context_text(sp, cfg_img_context)
        for term in input_lists:
            if isinstance(term, str):
                cfg_text_context = gen_context.fork()
                gen_context = self.update_context_text(term, gen_context)
                cfg_img_context = self.update_context_text(term, cfg_img_context)
            else:
                img = self._vae_resized_u8(term)
                gen_context = self.update_context_image(
                    img, gen_context, vae=not understanding_output, vit=True
                )
                cfg_text_context = gen_context.fork()
        if understanding_output:
            output_list.append(self.gen_text(
                gen_context, max_length=max_think_token_n, do_sample=do_sample,
                temperature=text_temperature,
            ))
            return output_list
        if think:
            text = self.gen_text(
                gen_context, max_length=max_think_token_n, do_sample=do_sample,
                temperature=text_temperature,
            )
            gen_context = self.update_context_text(text, gen_context)
            output_list.append(text)
        output_list.append(self.gen_image(
            image_shapes, gen_context, cfg_text_precontext=cfg_text_context,
            cfg_img_precontext=cfg_img_context, cfg_text_scale=cfg_text_scale,
            cfg_img_scale=cfg_img_scale, cfg_interval=cfg_interval,
            timestep_shift=timestep_shift, num_timesteps=num_timesteps,
            cfg_renorm_min=cfg_renorm_min, cfg_renorm_type=cfg_renorm_type,
        ))
        return output_list

    def _answer_context(self, input_lists: List[Any], text_fork: bool):
        """The vqa-reconstruction recipes' context: texts, and images with
        their VAE and ViT tokens; with ``text_fork`` also a context of the
        texts alone. Returns (context, the texts' context or None)."""
        ctx = self.init_gen_context()
        texts = ctx.fork() if text_fork else None
        for term in input_lists:
            if isinstance(term, str):
                ctx = self.update_context_text(term, ctx)
                if text_fork:
                    texts = self.update_context_text(term, texts)
            else:
                ctx = self.update_context_image(self._vae_resized_u8(term), ctx, vae=True,
                                                vit=True)
        return ctx, texts

    def _target_shape(self, image) -> Tuple[int, int]:
        """(H, W) to reconstruct ``image`` (PIL or uint8 [H, W, 3]) at."""
        h, w = image.shape[:2] if isinstance(image, np.ndarray) else image.size[::-1]
        return self._calculate_target_size_with_aspect_ratio(w, h)

    def interleave_inference_for_vqa_reconstruction_ver1(
        self,
        input_lists: List[Any],
        reconstruct_image: bool = False,
        max_think_token_n: int = 1000,
        do_sample: bool = False,
        text_temperature: float = 0.3,
        cfg_text_scale: float = 3.0,
        cfg_img_scale: float = 1.5,
        cfg_interval: Tuple[float, float] = (0.4, 1.0),
        timestep_shift: float = 3.0,
        num_timesteps: int = 50,
        cfg_renorm_min: float = 0.0,
        cfg_renorm_type: str = "global",
        **_,
    ) -> List[Any]:
        """VQA, then each input image reconstructed from the answer in turn
        (inferencer.py:282-362): the answer from a VAE + ViT context; each
        image generated at its aspect-preserving target size and fed back
        VAE-only into the full and cfg_text contexts before the next. The
        cfg_img context holds the texts and the answer."""
        output_list: List[Any] = []
        vqa_context, vqa_img_context = self._answer_context(input_lists, text_fork=True)
        answer = self.gen_text(vqa_context, max_length=max_think_token_n, do_sample=do_sample,
                               temperature=text_temperature)
        output_list.append(answer)
        images = [t for t in input_lists if not isinstance(t, str)]
        if not reconstruct_image or not answer.strip() or not images:
            return output_list
        cfg_text_context = vqa_context.fork()
        cfg_img_context = self.update_context_text(answer, vqa_img_context.fork())
        full_context = self.update_context_text(answer, vqa_context.fork())
        for image in images:
            generated = self.gen_image(
                self._target_shape(image), full_context, cfg_text_precontext=cfg_text_context,
                cfg_img_precontext=cfg_img_context, cfg_text_scale=cfg_text_scale,
                cfg_img_scale=cfg_img_scale, cfg_interval=cfg_interval,
                timestep_shift=timestep_shift, num_timesteps=num_timesteps,
                cfg_renorm_min=cfg_renorm_min, cfg_renorm_type=cfg_renorm_type,
            )
            output_list.append(generated)
            processed = self._vae_resized_u8(generated)
            full_context = self.update_context_image(processed, full_context, vae=True,
                                                     vit=False)
            cfg_text_context = self.update_context_image(processed, cfg_text_context, vae=True,
                                                         vit=False)
        return output_list

    def interleave_inference_for_vqa_reconstruction_ver0(
        self,
        input_lists: List[Any],
        reconstruct_image: bool = False,
        max_think_token_n: int = 1000,
        do_sample: bool = False,
        text_temperature: float = 0.3,
        cfg_interval: Tuple[float, float] = (0.4, 1.0),
        timestep_shift: float = 3.0,
        num_timesteps: int = 50,
        cfg_renorm_min: float = 0.0,
        cfg_renorm_type: str = "global",
        multi_image: bool = False,
        **_,
    ) -> List[Any]:
        """VQA, then a reconstruction of the first input image (every one
        with ``multi_image``) from a fresh context per image
        (inferencer.py:365-549): the image (VAE + ViT) is the cfg_text
        context, image and answer the full context, the answer alone the
        cfg_img context; CFG text and image scales 7.0."""
        output_list: List[Any] = []
        vqa_context, _ = self._answer_context(input_lists, text_fork=False)
        answer = self.gen_text(vqa_context, max_length=max_think_token_n, do_sample=do_sample,
                               temperature=text_temperature)
        output_list.append(answer)
        images = [t for t in input_lists if not isinstance(t, str)]
        if not reconstruct_image or not answer.strip() or not images:
            return output_list
        for image in images if multi_image else images[:1]:
            shape = self._target_shape(image)
            gen_context = self.init_gen_context()
            cfg_text_context = self.update_context_image(
                self._vae_resized_u8(image), gen_context.fork(), vae=True, vit=True)
            full_context = self.update_context_text(answer, cfg_text_context.fork())
            cfg_img_context = self.update_context_text(answer, gen_context.fork())
            output_list.append(self.gen_image(
                shape, full_context, cfg_text_precontext=cfg_text_context,
                cfg_img_precontext=cfg_img_context, cfg_text_scale=7.0, cfg_img_scale=7.0,
                cfg_interval=cfg_interval, timestep_shift=timestep_shift,
                num_timesteps=num_timesteps, cfg_renorm_min=cfg_renorm_min,
                cfg_renorm_type=cfg_renorm_type,
            ))
        return output_list

    def interleave_inference_for_vqa_reconstruction_ver0_1(self, input_lists: List[Any],
                                                           **kw) -> List[Any]:
        """``_ver0`` over every input image (``multi_image=True``)."""
        return self.interleave_inference_for_vqa_reconstruction_ver0(
            input_lists, multi_image=True, **kw)

    def _calculate_target_size_with_aspect_ratio(self, width: int, height: int):
        """(H, W) keeping the aspect ratio under the VAE transform's
        constraints (inferencer.py:42-71)."""
        from unimedvl_tpu_torch.data.imaging import compute_resize_shape

        self.vae_transform = self._transform(self.vae_transform, TransformConfig.vae_interactive())
        rt = self.vae_transform.resize_transform
        new_w, new_h = compute_resize_shape(
            width, height, rt.max_size, rt.min_size, rt.stride, rt.max_pixels
        )
        return new_h, new_w

    def __call__(self, image=None, text: Optional[str] = None, inference_ver: int = 0,
                 **kwargs) -> Dict[str, Any]:
        """Main entry point (inferencer.py:640-680): ``{"image": ..., "text": ...}``.
        ``inference_ver=0`` is ``interleave_inference``, 1 the
        vqa-reconstruction recipe (``_ver1``); any other raises."""
        output: Dict[str, Any] = {"image": None, "text": None}
        if image is None and text is None:
            return output
        inputs: List[Any] = []
        if image is not None:
            inputs.extend(image if isinstance(image, list) else [image])
        if text is not None:
            inputs.append(text)
        if inference_ver == 0:
            items = self.interleave_inference(inputs, **kwargs)
        elif inference_ver == 1:
            items = self.interleave_inference_for_vqa_reconstruction_ver1(inputs, **kwargs)
        else:
            raise ValueError(f"Unsupported inference_ver: {inference_ver}")
        images = []
        for item in items:
            if isinstance(item, str):
                output["text"] = item
            else:
                images.append(item)
        if images:
            output["image"] = images[0] if len(images) == 1 else images
        return output
