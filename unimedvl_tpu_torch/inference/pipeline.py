"""Host-side inference orchestrator, understanding slice (port of
unimedvl_tpu/inference/pipeline.py::InterleaveInferencer): context set-up,
text and ViT image context updates, greedy or sampled answer decoding, and
``chat``, the one-call VQA entry point.

Contexts hold the KV cache, which the port updates in place. A context is a
cursor into that cache, not a snapshot: after ``update_context_*`` on a
context, use the returned one and drop the old. ``gen_text`` writes its decode
kv past the context's ``lens`` and never advances them, so asking twice on one
context gives the same answer.

Text-to-image, the VAE image context, multi-turn ``chat_turn``, streaming and
speculative decoding are later slices of ROADMAP queue 1.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from unimedvl_tpu.config import TransformConfig
from unimedvl_tpu_torch.models import bagel
from unimedvl_tpu_torch.models.bagel import Bagel
from unimedvl_tpu_torch.models.qwen2_mot import KVCache

_CAPACITY_BUCKET = 512


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class GenContext:
    """One conversation context: cache + host bookkeeping (kv length and next
    rope position)."""

    cache: KVCache
    kv_len: int = 0
    rope: int = 0


class InterleaveInferencer:
    def __init__(
        self,
        model: Bagel,
        tokenizer,
        new_token_ids: Dict[str, int],
        vit_transform=None,
        seed: int = 0,
    ):
        """``model``: a Bagel on its device; ``tokenizer``: anything with
        ``encode``/``decode`` whose special tokens went through
        ``unimedvl_tpu.data.tokenizer.add_special_tokens`` (which gave
        ``new_token_ids``); ``vit_transform``: an
        ``unimedvl_tpu.data.imaging.ImageTransform`` (default: the interactive
        ViT geometry, built at the first image); ``seed``: seeds the sampling
        generator."""
        self.model = model
        self.cfg = model.config
        self.tokenizer = tokenizer
        self.new_token_ids = new_token_ids
        self.vit_transform = vit_transform
        norm = model.language_model.model.norm.weight
        self.device, self.dtype = norm.device, norm.dtype
        self._generator = torch.Generator(device=self.device).manual_seed(seed)

    # -- context management --------------------------------------------------
    def init_gen_context(self, capacity: int = _CAPACITY_BUCKET) -> GenContext:
        llm = self.cfg.llm
        cache = KVCache.create(
            llm.num_hidden_layers, 1, capacity, llm.num_key_value_heads,
            llm.head_dim, dtype=self.dtype, device=self.device,
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
        c = ctx.cache
        cache = KVCache(
            k=F.pad(c.k, (0, 0, 0, pad)), v=F.pad(c.v, (0, 0, 0, pad)), lens=c.lens
        )
        return GenContext(cache=cache, kv_len=ctx.kv_len, rope=ctx.rope)

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
            (torch.arange(T_pad) < T)[None].to(dev),
        )
        return GenContext(cache=cache, kv_len=ctx.kv_len + T, rope=ctx.rope + T)

    # -- images --------------------------------------------------------------
    def _vit_resized_u8(self, image) -> np.ndarray:
        """A PIL image, or a uint8 [H, W, 3] array, resized by the ViT transform
        (PIL bicubic). An array already at the target size is used as is."""
        from unimedvl_tpu.data import imaging  # imports PIL

        if self.vit_transform is None:
            t = TransformConfig.vit_interactive()
            self.vit_transform = imaging.ImageTransform(
                t.max_size, t.min_size, t.stride, t.max_pixels
            )
        rt = self.vit_transform.resize_transform
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

    def update_context_image(self, image, ctx: GenContext, vae: bool = True,
                             vit: bool = True) -> GenContext:
        """ViT image append through the und expert (inferencer.py:131-162).
        ``vae=True`` (the gen-expert VAE context) is ROADMAP slice M7."""
        if vae:
            raise NotImplementedError(
                "the VAE image context is ROADMAP slice M7; pass vae=False"
            )
        if not vit:
            raise ValueError("update_context_image needs vit=True")
        from unimedvl_tpu.data import imaging

        u8 = self._vit_resized_u8(image)
        H, W = u8.shape[:2]
        p = self.cfg.vit.patch_size
        n = (H // p) * (W // p)
        position_ids = (
            imaging.position_ids_interpolate if self.cfg.interpolate_pos
            else imaging.position_ids_extrapolate
        )
        pos_ids = position_ids(H, W, p, self.cfg.vit_max_num_patch_per_side)
        bucket = bagel.vit_token_bucket(n)
        # the whole padded block is written before its padding is masked
        ctx = self._ensure_capacity(ctx, bucket + 2)
        tokens = bagel.preprocess_vit_image(
            self.cfg, torch.tensor(u8, device=self.device)
        )
        tokens = F.pad(tokens, (0, 0, 0, bucket - n))
        padded_pos = np.zeros(bucket, np.int64)
        padded_pos[:n] = pos_ids
        start_end = torch.tensor(
            [self.new_token_ids["start_of_image"], self.new_token_ids["end_of_image"]],
            device=self.device,
        )
        cache = bagel.prefill_vit_bucketed(
            self.model, ctx.cache, tokens,
            torch.from_numpy(padded_pos)[None].to(self.device), n, start_end, ctx.rope,
        )
        return GenContext(cache=cache, kv_len=ctx.kv_len + n + 2, rope=ctx.rope + 1)

    # -- text generation -----------------------------------------------------
    def gen_text(self, ctx: GenContext, max_length: int = 500, do_sample: bool = False,
                 temperature: float = 1.0) -> str:
        """Decode an answer (inferencer.py:259-279; bagel.py:1236-1317). The
        caller's context is unaffected: decode kv lands past its lens."""
        ctx = self._ensure_capacity(ctx, max_length + 1)
        bos = self.new_token_ids["bos_token_id"]
        out, _ = bagel.generate_text(
            self.model, ctx.cache,
            torch.tensor([bos], device=self.device),
            torch.tensor([ctx.rope], device=self.device),
            max_length, self.new_token_ids["eos_token_id"],
            do_sample, temperature, self._generator,
        )
        ids = [i for i in out[0].tolist() if i >= 0]
        text = self.tokenizer.decode(ids)
        # reference parsing (bagel.py:1389-1391)
        text = text.split("<|im_end|>")[0]
        if "<|im_start|>" in text:
            text = text.split("<|im_start|>")[1]
        return text

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
