"""Host-side packing of multimodal training samples into the flat packed
layout consumed by models.bagel.train_forward (the port's own copy of
unimedvl_tpu/data/packing.py; numpy only). ``strip_padding`` is the port's
addition: torch index ops take no out-of-range index, so the padding slots
are dropped on the host before a batch becomes tensors.

The reference never published its dataset pipeline; the packed-input contract
is reverse-specified from Bagel.forward's signature (bagel.py:202-299) and the
mask algebra (data_utils.py:13-40). Samples are lists of items:

  {"type": "text", "ids": [int], "loss": bool}
  {"type": "vit", "patch_tokens": np [n, p*p*3], "pos_ids": np [n]}
  {"type": "vae", "clean_tokens": np [n, 64], "pos_ids": np [n],
   "timestep_raw": float, "loss": bool}
      loss=True -> attention mode "noise" (noised latents, MSE target);
      loss=False -> mode "full" (clean conditioning image, timestep_raw
      should be -inf so sigmoid(t)=0).

Rope positions: text advances one per token; each image consumes ONE position
(bagel.py:501-504). Images are wrapped in <vision_start>/<vision_end> text
tokens by the caller via explicit text items if desired (the reference's
training format keeps them as ordinary text splits).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from unimedvl_tpu_torch.ops.blockmask import packed_segment_ids


def len2weight(x: int, loss_reduction: str = "square") -> float:
    """Per-sample CE weight from loss-token count (data_utils.py:178-187)."""
    if x == 0:
        return 0.0
    if loss_reduction == "token":
        return 1.0
    if loss_reduction == "sample":
        return 1.0 / x
    if loss_reduction == "square":
        return 1.0 / (x**0.5)
    raise NotImplementedError(loss_reduction)


def split_integer_exp_decay(S: int, ng_sample_decay: float = 1.0, rng=None):
    """Random integer partition with exponential-decay part count
    (data_utils.py:104-113)."""
    import math
    import random as _random

    rng = rng or _random
    if ng_sample_decay == 1.0:
        N = rng.randint(1, S)
    else:
        base = (1 - ng_sample_decay) / (1 - math.pow(ng_sample_decay, S))
        p = [base * math.pow(ng_sample_decay, i) for i in range(S)]
        N = rng.choices(list(range(1, S + 1)), p, k=1)[0]
    cumsum = [0] + sorted(rng.sample(range(1, S), N - 1)) + [S]
    return [cumsum[i + 1] - cumsum[i] for i in range(len(cumsum) - 1)], cumsum


def _pad_idx(idx: List[int], size: int, pad_value: int) -> np.ndarray:
    out = np.full(size, pad_value, dtype=np.int32)
    out[: len(idx)] = idx
    return out


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pack_training_batch(
    samples: Sequence[Sequence[Dict]],
    pad_multiple: int = 128,
    seq_len: Optional[int] = None,
    loss_reduction: str = "token",
) -> Dict[str, np.ndarray]:
    """Pack samples into one flat sequence plus index/segment arrays.

    All output shapes are padded to stable buckets so a fixed-size compile
    serves many batches. Padded slots use index T (dropped by the device-side
    scatters) and zero weights.
    """
    text_ids: List[int] = []
    text_idx: List[int] = []
    position_ids: List[int] = []
    und_idx: List[int] = []
    gen_idx: List[int] = []
    ce_idx: List[int] = []
    ce_labels: List[int] = []
    ce_w: List[float] = []
    sample_lens: List[int] = []
    split_lens: List[int] = []
    attn_modes: List[str] = []

    vit_tokens: List[np.ndarray] = []
    vit_pos: List[np.ndarray] = []
    vit_scatter: List[int] = []
    vae_tokens: List[np.ndarray] = []
    vae_pos: List[np.ndarray] = []
    vae_scatter: List[int] = []
    vae_t_raw: List[float] = []
    mse_weight: List[float] = []

    curr = 0
    for sample in samples:
        rope = 0
        start = curr
        for item in sample:
            if item["type"] == "text":
                ids = list(item["ids"])
                n = len(ids)
                text_ids.extend(ids)
                text_idx.extend(range(curr, curr + n))
                und_idx.extend(range(curr, curr + n))
                position_ids.extend(range(rope, rope + n))
                if item.get("loss"):
                    # predict ids[1:] from positions of ids[:-1]
                    ce_idx.extend(range(curr, curr + n - 1))
                    ce_labels.extend(ids[1:])
                    ce_w.extend([len2weight(n - 1, loss_reduction)] * (n - 1))
                split_lens.append(n)
                attn_modes.append("causal")
                rope += n
                curr += n
            elif item["type"] == "vit":
                n = item["patch_tokens"].shape[0]
                vit_tokens.append(np.asarray(item["patch_tokens"], np.float32))
                vit_pos.append(np.asarray(item["pos_ids"], np.int64))
                vit_scatter.extend(range(curr, curr + n))
                und_idx.extend(range(curr, curr + n))
                position_ids.extend([rope] * n)
                split_lens.append(n)
                attn_modes.append("full")
                rope += 1
                curr += n
            elif item["type"] == "vae":
                n = item["clean_tokens"].shape[0]
                vae_tokens.append(np.asarray(item["clean_tokens"], np.float32))
                vae_pos.append(np.asarray(item["pos_ids"], np.int64))
                vae_scatter.extend(range(curr, curr + n))
                gen_idx.extend(range(curr, curr + n))
                position_ids.extend([rope] * n)
                is_noise = bool(item.get("loss", True))
                split_lens.append(n)
                attn_modes.append("noise" if is_noise else "full")
                vae_t_raw.extend([float(item["timestep_raw"])] * n)
                mse_weight.extend([1.0 if is_noise else 0.0] * n)
                rope += 1
                curr += n
            else:
                raise ValueError(item["type"])
        sample_lens.append(curr - start)

    T_real = curr
    T = seq_len or _round_up(max(T_real, 1), pad_multiple)
    if T < T_real:
        raise ValueError(f"the samples hold {T_real} tokens, more than seq_len {T}")

    doc_id, fn_id, noise_id = packed_segment_ids(sample_lens, split_lens, attn_modes)
    # pad segment arrays: padding tokens get document 0 (matches nothing real)
    doc = np.zeros(T, np.int32)
    doc[:T_real] = doc_id
    fn = np.full(T, -1, np.int32)
    fn[:T_real] = fn_id
    nz = np.full(T, -1, np.int32)
    nz[:T_real] = noise_id
    pos = np.zeros(T, np.int32)
    pos[:T_real] = position_ids

    n_text = _round_up(max(len(text_ids), 1), pad_multiple)
    padded_text_ids = np.zeros(n_text, np.int32)
    padded_text_ids[: len(text_ids)] = text_ids

    batch: Dict[str, np.ndarray] = {
        "packed_text_ids": padded_text_ids,
        "packed_text_indexes": _pad_idx(text_idx, n_text, T),
        "packed_position_ids": pos,
        "mask_document_id": doc,
        "mask_fn_id": fn,
        "mask_noise_id": nz,
        "und_idx": _pad_idx(und_idx, _round_up(max(len(und_idx), 1), pad_multiple), T),
        "gen_idx": _pad_idx(gen_idx, _round_up(max(len(gen_idx), 1), pad_multiple), T),
    }
    if ce_idx:
        n = _round_up(len(ce_idx), pad_multiple)
        batch["ce_idx"] = _pad_idx(ce_idx, n, T)
        labels = np.zeros(n, np.int32)
        labels[: len(ce_labels)] = ce_labels
        batch["ce_labels"] = labels
        w = np.zeros(n, np.float32)
        w[: len(ce_idx)] = ce_w
        batch["ce_weight"] = w
    if vit_tokens:
        max_n = max(t.shape[0] for t in vit_tokens)
        N = len(vit_tokens)
        pd = vit_tokens[0].shape[1]
        toks = np.zeros((N, max_n, pd), np.float32)
        pids = np.zeros((N, max_n), np.int64)
        valid = np.zeros((N, max_n), bool)
        scatter = np.full(N * max_n, T, np.int32)
        flat_i = 0
        src_i = 0
        for i, (tk, pp) in enumerate(zip(vit_tokens, vit_pos)):
            n = tk.shape[0]
            toks[i, :n] = tk
            pids[i, :n] = pp
            valid[i, :n] = True
            scatter[i * max_n : i * max_n + n] = vit_scatter[src_i : src_i + n]
            src_i += n
        batch["vit_patch_tokens"] = toks
        batch["vit_pos_ids"] = pids
        batch["vit_valid"] = valid
        batch["vit_scatter_idx"] = scatter
    if vae_tokens:
        clean = np.concatenate(vae_tokens, axis=0)
        n = _round_up(clean.shape[0], pad_multiple)
        padded = np.zeros((n, clean.shape[1]), np.float32)
        padded[: clean.shape[0]] = clean
        batch["vae_clean_tokens"] = padded
        ppos = np.zeros(n, np.int64)
        ppos[: clean.shape[0]] = np.concatenate(vae_pos)
        batch["vae_latent_pos_ids"] = ppos
        batch["vae_scatter_idx"] = _pad_idx(vae_scatter, n, T)
        traw = np.full(n, -np.inf, np.float32)
        traw[: clean.shape[0]] = vae_t_raw
        batch["vae_timesteps_raw"] = traw
        w = np.zeros(n, np.float32)
        w[: clean.shape[0]] = mse_weight
        batch["mse_weight"] = w
    return batch


def strip_padding(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """One packed sequence (the output of :func:`pack_training_batch`, or one
    row of a stacked batch) without its padding slots.

    Index lists padded with T lose those entries, together with the rows of
    the arrays that run beside them (text ids; CE labels and weights; VAE
    tokens, positions, timesteps and weights, and REPA teacher features where
    the batch has them). ViT images keep their padded
    [N, max_n] form, minus images with no valid token; ``vit_token_idx`` (new)
    lists the rows of the flat [N * max_n] embedding that are real, and
    ``vit_scatter_idx`` where in the packed sequence each goes. A sequence
    whose ViT block holds no real token loses its ``vit_*`` keys. The [T]
    arrays stay whole: trailing pad tokens are ordinary tokens of document 0."""
    T = batch["packed_position_ids"].shape[0]
    out = dict(batch)

    def keep_rows(index_key, *beside):
        keep = np.flatnonzero(batch[index_key] < T)
        for key in (index_key, *beside):
            out[key] = batch[key][keep]

    keep_rows("packed_text_indexes", "packed_text_ids")
    keep_rows("und_idx")
    keep_rows("gen_idx")
    if "ce_idx" in batch:
        keep_rows("ce_idx", "ce_labels", "ce_weight")
    if "vae_scatter_idx" in batch:
        keep_rows("vae_scatter_idx", "vae_clean_tokens", "vae_latent_pos_ids",
                  "vae_timesteps_raw", "mse_weight",
                  *(["repa_teacher_features"] if "repa_teacher_features" in batch else []))
    if "vit_scatter_idx" in batch:
        vit_keys = ("vit_patch_tokens", "vit_pos_ids", "vit_valid", "vit_scatter_idx")
        N, max_n = batch["vit_pos_ids"].shape
        scatter = batch["vit_scatter_idx"].reshape(N, max_n)
        images = np.flatnonzero((scatter < T).any(axis=1))
        if images.size == 0:
            for key in vit_keys:
                out.pop(key, None)
        else:
            scatter = scatter[images].reshape(-1)
            for key in vit_keys[:3]:
                if key in batch:
                    out[key] = batch[key][images]
            rows = np.flatnonzero(scatter < T)
            out["vit_token_idx"] = rows.astype(np.int64)
            out["vit_scatter_idx"] = scatter[rows]
    return out
