"""Streaming dataset -> packed-batch training pipeline (port of
unimedvl_tpu/training/dataset.py).

The reference ships no training pipeline (README.md:60-67): only the
training forward exists in its modeling code, and data/default.yaml records
per-task transform geometry. This module turns (image, text) examples into
the packed multimodal sequences ``models.bagel.train_forward`` consumes, with
a yaml-style task mix. The host side is numpy and yields the same arrays as
the JAX package's iterator for the same seed (padded to stable shapes);
``place_fn`` then drops the padding slots and moves each sequence to the card
(``trainer.place_batches``).

Tasks (default.yaml keys):
  vlm_sft       [prompt text, ViT image, answer text (CE loss)]
  t2i_pretrain  [caption text (CE-free), noised VAE latents (MSE loss)]
  unified_edit  [instruction text, ViT source, clean VAE source (condition,
                 t~0, attention mode "full"), noised VAE target (MSE loss)]

Sequences are PACKED: several samples share one [seq_len] sequence (the
reference's packed-attention design, data_utils.py:72-102) until the token
budget is reached; every array is padded to fixed sizes derived from
``seq_len`` so shapes never vary across batches.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from unimedvl_tpu_torch.config import BagelConfig
from unimedvl_tpu_torch.data.imaging import (
    ImageTransform,
    patchify,
    pil_img2rgb,
    position_ids_extrapolate,
)
from unimedvl_tpu_torch.data.packing import pack_training_batch

#: timestep_raw for clean conditioning latents: sigmoid(-30) ~ 0 -> x_t = x
COND_T_RAW = -30.0


@dataclasses.dataclass
class Example:
    """One training example. ``image``/``target_image`` are PIL images."""

    task: str
    text: str
    image: Optional[object] = None
    target_image: Optional[object] = None
    answer: Optional[str] = None


def _encode(tokenizer, new_token_ids, text: str, loss: bool) -> Dict:
    ids = (
        [new_token_ids["bos_token_id"]]
        + tokenizer.encode(text)
        + [new_token_ids["eos_token_id"]]
    )
    return {"type": "text", "ids": ids, "loss": loss}


def _vit_item(image, transform: ImageTransform, cfg: BagelConfig) -> Dict:
    arr = np.asarray(transform.resize_transform(pil_img2rgb(image)), np.uint8)
    x = (arr.astype(np.float32) / 255.0 - 0.5) / 0.5
    p = cfg.vit.patch_size
    tokens = patchify(x.transpose(2, 0, 1), p)  # patchify takes [C, H, W]
    pos = position_ids_extrapolate(
        arr.shape[0], arr.shape[1], p, cfg.vit_max_num_patch_per_side
    )
    return {"type": "vit", "patch_tokens": tokens, "pos_ids": pos}


def _vae_item(
    image,
    transform: ImageTransform,
    cfg: BagelConfig,
    latent_fn: Callable,
    timestep_raw: float,
    loss: bool,
) -> Dict:
    arr = np.asarray(transform.resize_transform(pil_img2rgb(image)), np.uint8)
    tokens = np.asarray(latent_fn(arr))  # [n, patch_latent_dim]
    ld = cfg.latent_downsample
    h, w = arr.shape[0] // ld, arr.shape[1] // ld
    rows = np.arange(h).repeat(w)
    cols = np.tile(np.arange(w), h)
    pos = rows * cfg.max_latent_size + cols
    return {
        "type": "vae", "clean_tokens": tokens, "pos_ids": pos,
        "timestep_raw": timestep_raw, "loss": loss,
    }


def example_to_items(
    ex: Example,
    tokenizer,
    new_token_ids: Dict[str, int],
    cfg: BagelConfig,
    vit_transform: ImageTransform,
    vae_transform: ImageTransform,
    latent_fn: Optional[Callable],
    rng: np.random.Generator,
) -> List[Dict]:
    t_raw = float(rng.normal())  # t = sigmoid(raw), reference bagel.py:268
    if ex.task == "vlm_sft":
        items = [_encode(tokenizer, new_token_ids, ex.text, False)]
        if ex.image is not None:
            items.append(_vit_item(ex.image, vit_transform, cfg))
        items.append(_encode(tokenizer, new_token_ids, ex.answer or "", True))
        return items
    if ex.task == "t2i_pretrain":
        _need_latent_fn(latent_fn, ex.task)
        return [
            _encode(tokenizer, new_token_ids, ex.text, False),
            _vae_item(ex.image, vae_transform, cfg, latent_fn, t_raw, True),
        ]
    if ex.task == "unified_edit":
        _need_latent_fn(latent_fn, ex.task)
        return [
            _encode(tokenizer, new_token_ids, ex.text, False),
            _vit_item(ex.image, vit_transform, cfg),
            _vae_item(ex.image, vae_transform, cfg, latent_fn, COND_T_RAW,
                      False),
            _vae_item(ex.target_image or ex.image, vae_transform, cfg,
                      latent_fn, t_raw, True),
        ]
    raise ValueError(f"unknown task {ex.task!r}")


def _need_latent_fn(latent_fn, task: str) -> None:
    if latent_fn is None:
        raise ValueError(f"task {task!r} needs latent_fn (the VAE encode)")


def _items_len(items: List[Dict]) -> int:
    n = 0
    for it in items:
        if it["type"] == "text":
            n += len(it["ids"])
        elif it["type"] == "vit":
            n += it["patch_tokens"].shape[0]
        else:
            n += it["clean_tokens"].shape[0]
    return n


def _pad_to(a: np.ndarray, shape, fill) -> np.ndarray:
    out = np.full(shape, fill, a.dtype)
    out[tuple(slice(0, s) for s in a.shape)] = a
    return out


def stack_packed(seqs: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack per-sequence packed dicts into one [B, ...] batch, padding each
    array to the across-batch max shape. Index arrays pad with T (dropped by
    the device scatters), labels/weights with 0.

    A sequence MISSING a modality another sequence has (e.g. a pure-t2i
    sequence in a batch with a vlm_sft sequence) gets a NEUTRAL block
    synthesized: scatter indexes T (dropped), zero tokens, zero loss weights
    with no loss contribution from the synthetic rows (the port's
    ``strip_padding`` then drops them before they reach the device)."""
    keys = set()
    for s in seqs:
        keys |= set(s)
    T = seqs[0]["packed_position_ids"].shape[0]
    fills = {
        "packed_text_indexes": T, "und_idx": T, "gen_idx": T, "ce_idx": T,
        "vit_scatter_idx": T, "vae_scatter_idx": T,
    }
    out = {}
    for k in sorted(keys):
        proto = next(np.asarray(s[k]) for s in seqs if k in s)
        fill = fills.get(k, False if proto.dtype == bool else 0)
        arrs = []
        for s in seqs:
            if k in s:
                arrs.append(np.asarray(s[k]))
            else:
                # neutral block: minimal shape of the prototype, all fill
                arrs.append(np.full(tuple(1 for _ in proto.shape), fill,
                                    proto.dtype))
        shape = tuple(max(a.shape[d] for a in arrs)
                      for d in range(arrs[0].ndim))
        out[k] = np.stack([_pad_to(a, shape, fill) for a in arrs])
    return out


class PackedBatchIterator:
    """Infinite iterator of stacked packed batches from a task-mixed example
    pool (epoch-shuffled). Each sequence packs examples until ``seq_len``
    would overflow; each batch stacks ``batch_size`` sequences.

    ``latent_fn``: uint8 [H, W, 3] -> clean latent tokens [n, d] (the VAE
    encode + patchify, e.g. ``make_latent_fn``).
    """

    def __init__(
        self,
        examples: Sequence[Example],
        tokenizer,
        new_token_ids: Dict[str, int],
        cfg: BagelConfig,
        vit_transform: ImageTransform,
        vae_transform: ImageTransform,
        latent_fn: Optional[Callable] = None,
        batch_size: int = 2,
        seq_len: int = 512,
        seed: int = 0,
        loss_reduction: str = "token",
        pad_multiple: int = 64,
    ):
        if not examples:
            raise ValueError("empty example pool")
        self.examples = list(examples)
        self.tokenizer = tokenizer
        self.new_token_ids = new_token_ids
        self.cfg = cfg
        self.vit_transform = vit_transform
        self.vae_transform = vae_transform
        self.latent_fn = latent_fn
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.loss_reduction = loss_reduction
        self.pad_multiple = pad_multiple
        self._rng = np.random.default_rng(seed)

    def _example_stream(self) -> Iterator[Example]:
        while True:
            order = self._rng.permutation(len(self.examples))
            for i in order:
                yield self.examples[i]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        stream = self._example_stream()
        while True:
            seqs = []
            for _ in range(self.batch_size):
                samples, used = [], 0
                while True:
                    ex = next(stream)
                    items = example_to_items(
                        ex, self.tokenizer, self.new_token_ids, self.cfg,
                        self.vit_transform, self.vae_transform,
                        self.latent_fn, self._rng,
                    )
                    n = _items_len(items)
                    if used + n > self.seq_len and samples:
                        break
                    samples.append(items)
                    used += n
                    if used >= self.seq_len:
                        break
                seqs.append(pack_training_batch(
                    samples, seq_len=self.seq_len,
                    pad_multiple=self.pad_multiple,
                    loss_reduction=self.loss_reduction,
                ))
            yield stack_packed(seqs)


class Prefetcher:
    """Background-thread prefetch over a batch iterator: overlaps host-side
    example packing (tokenize, resize, VAE-latent encode, packing math) with
    device compute, so the train step does not wait on the host. ``place_fn``
    (e.g. :func:`make_place_fn`: pinned host memory and non-blocking copies to
    the card) runs in the worker thread, so transfers start before the
    consumer asks.

    Exceptions in the worker propagate to the consumer on the next
    ``__next__``. Call ``close()`` (or exhaust the iterator) to stop the
    thread; it is a daemon, so leaking one cannot hang interpreter exit.
    """

    _DONE = object()

    def __init__(self, iterable, depth: int = 2, place_fn: Optional[Callable] = None):
        import queue
        import threading

        self._q = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()

        def work():
            try:
                for item in iterable:
                    if place_fn is not None:
                        item = place_fn(item)
                    while not self._stop.is_set():
                        try:
                            self._q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if self._stop.is_set():
                        return
                self._q.put(self._DONE)
            except BaseException as e:  # propagate to the consumer
                self._q.put(e)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        return item

    def close(self, wait: bool = False):
        """Stop the worker; ``wait`` also joins it (it finishes the item it
        is on), so that what its iterable holds can be freed."""
        self._stop.set()
        if wait:
            self._thread.join()


def make_place_fn(device) -> Callable:
    """A ``place_fn`` for :class:`Prefetcher`: a stacked numpy batch becomes a
    list of prepared sequences on ``device``, in the form the train step
    takes there by default (``trainer.prepared``): with their padding on a
    card, where the step runs as its program, stripped on the host
    elsewhere. A step whose route takes the other form prepares them again.
    On a card the arrays are staged in pinned memory and copied without
    blocking: the caching host allocator holds a staged block until its copy
    has run, and the worker's copies are ordered before the step's use on
    the card's default stream."""
    import torch

    from unimedvl_tpu_torch.training import trainer

    device = torch.device(device)
    card = device.type == "cuda"

    def place(batch):
        return trainer.prepared(batch, device, padded=card, pin=card)

    return place


def make_latent_fn(model):
    """Bind the model's VAE encode + 2x2 latent patchify as a host callable:
    uint8 [H, W, 3] -> fp32 latent tokens [n, d] (the posterior mean, so
    packing is deterministic; the flow noise is drawn in train_forward). Runs
    on the VAE's device."""
    import torch

    from unimedvl_tpu_torch.models import bagel

    device = next(model.vae_model.parameters()).device

    def latent_fn(image_u8: np.ndarray) -> np.ndarray:
        img = bagel.preprocess_vae_image(torch.from_numpy(np.array(image_u8))
                                         .to(device))
        # eager: the packing worker meets each image geometry once, off the main thread
        toks = bagel.encode_vae_latent_tokens(model, img, None, graphs=False)
        return toks[0].float().cpu().numpy()

    return latent_fn
