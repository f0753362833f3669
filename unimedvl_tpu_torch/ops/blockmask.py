"""Training attention-mask algebra for packed multimodal sequences (port of
unimedvl_tpu/ops/blockmask.py).

The flex-attention mask combinators of the reference (data_utils.py:13-40
create_sparse_mask) as segment-id arrays plus a function that makes the dense
mask. For global token indexes q, k:

  allowed(q, k) = (q >= k  OR  (fn_id[q] == fn_id[k] AND fn_id[q] >= 0))
                  AND NOT (noise_id[k] >= 0 AND noise_id[q] != noise_id[k])
                  AND document_id[q] == document_id[k]

``fn_id`` groups 'full' and 'noise' splits, ``noise_id`` groups 'noise' splits
(-1 elsewhere), ``document_id`` isolates packed samples. The training
attention kernel (ops/flash_attention_train.py) evaluates the same predicate
from the three arrays; the dense mask backs its plain version.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

ATTN_MODES = ("causal", "full", "noise")


def packed_segment_ids(
    sample_lens: Sequence[int],
    split_lens: Sequence[int],
    attn_modes: Sequence[str],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host side: (document_id, fn_id, noise_id) int32 arrays [T].
    ``split_lens`` and ``attn_modes`` cover the whole packed sequence across
    all samples, in order (the reference passes them so, bagel.py:238)."""
    fn, noise = [], []
    for i, (length, mode) in enumerate(zip(split_lens, attn_modes)):
        if mode not in ATTN_MODES:
            raise ValueError(f"attention mode must be one of {ATTN_MODES}, got {mode!r}")
        fn.extend([i if mode in ("full", "noise") else -1] * length)
        noise.extend([i if mode == "noise" else -1] * length)
    doc = np.concatenate(
        [np.full(n, i, dtype=np.int32) for i, n in enumerate(sample_lens, start=1)]
    )
    if len(fn) != len(doc):
        raise ValueError(f"splits cover {len(fn)} tokens, samples {len(doc)}")
    return (
        doc.astype(np.int32),
        np.asarray(fn, dtype=np.int32),
        np.asarray(noise, dtype=np.int32),
    )


def dense_packed_mask(
    document_id: torch.Tensor, fn_id: torch.Tensor, noise_id: torch.Tensor
) -> torch.Tensor:
    """[T] segment arrays -> bool [T, T] mask (True = attend), on their device."""
    q = torch.arange(document_id.shape[0], device=document_id.device)
    causal = q[:, None] >= q[None, :]
    fn_same = (fn_id[:, None] == fn_id[None, :]) & (fn_id[:, None] >= 0)
    keep_noise = ~((noise_id[None, :] >= 0) & (noise_id[:, None] != noise_id[None, :]))
    same_doc = document_id[:, None] == document_id[None, :]
    return (causal | fn_same) & keep_noise & same_doc


def dense_sample_mask(split_lens: Sequence[int], attn_modes: Sequence[str]) -> np.ndarray:
    """Per-sample dense mask, as prepare_attention_mask_per_sample
    (data_utils.py:72-102) builds it. Returns bool [T, T]."""
    T = int(sum(split_lens))
    mask = np.zeros((T, T), dtype=bool)
    csum = 0
    for s, mode in zip(split_lens, attn_modes):
        if mode == "causal":
            mask[csum : csum + s, csum : csum + s] = np.tril(np.ones((s, s), bool))
        else:
            mask[csum : csum + s, csum : csum + s] = True
        mask[csum : csum + s, :csum] = True
        csum += s
    csum = 0
    for s, mode in zip(split_lens, attn_modes):
        if mode == "noise":
            mask[:, csum : csum + s] = False
            mask[csum : csum + s, csum : csum + s] = True
        csum += s
    return mask
