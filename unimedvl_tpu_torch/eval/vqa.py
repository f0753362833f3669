"""Batched VQA evaluation on the port (unimedvl_tpu/eval/vqa.py; reference
eval/vlm/utils.py:486-506 and a VLMEvalKit-style runner).

``run_vqa_eval`` drives the continuous-batching engine
(``inference.serving.ContinuousBatcher``) over (image, question) samples and
scores the answers with a pluggable metric: exact match by default (SLAKE /
VQA-RAD closed-set style), or ``eval.text_metrics.report_metrics`` for
report text.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from PIL import Image

from unimedvl_tpu_torch.config import TransformConfig
from unimedvl_tpu_torch.data.imaging import ImageTransform, pil_img2rgb


def build_transform() -> ImageTransform:
    """vlm_sft transform (eval/vlm/utils.py:486-502): 980/378/14/2_007_040."""
    t = TransformConfig.vit_vqa()
    return ImageTransform(t.max_size, t.min_size, t.stride, t.max_pixels)


def process_conversation(images: Sequence[Image.Image], conversation):
    """eval/vlm/utils.py:504-506."""
    return [pil_img2rgb(img) for img in images], conversation


def _normalize(ans: str) -> str:
    ans = ans.strip().lower()
    ans = re.sub(r"[^\w\s]", "", ans)
    return re.sub(r"\s+", " ", ans)


def exact_match_accuracy(predictions: Sequence[str], answers: Sequence[str]) -> float:
    """Closed-set VQA accuracy: normalized exact match (either contained)."""
    hits = 0
    for p, a in zip(predictions, answers):
        pn, an = _normalize(p), _normalize(a)
        if pn == an or (an and an in pn):
            hits += 1
    return hits / max(len(predictions), 1)


def run_vqa_eval(
    model,
    tokenizer,
    new_token_ids: Dict[str, int],
    samples: Iterable[Dict],
    max_new_tokens: int = 64,
    num_slots: int = 8,
    capacity: int = 8192,
    metric: Callable[[Sequence[str], Sequence[str]], object] = exact_match_accuracy,
    mesh=None,
    spec_decode: bool = False,
    kv_quantized: bool = False,
    kv_bits: int = 8,
) -> Tuple[List[str], Optional[object]]:
    """samples: dicts with 'image' (PIL, a path, or None), 'question' and an
    optional 'answer'. ``model``: a Bagel on its device (the JAX runner's
    ``params, cfg``); the engine's pool of ``num_slots`` x ``capacity``
    columns is allocated there.

    ``spec_decode``: speculative continuous batching (greedy-exact, so the
    eval numbers are unchanged). ``kv_quantized`` / ``kv_bits``: an int8 or
    int4 pool (a non-parity mode). ``metric``: ``exact_match_accuracy``
    (closed-set VQA, default) or ``text_metrics.report_metrics`` (BLEU-3 /
    METEOR / ROUGE-L) -- any callable over (predictions, answers).
    ``mesh``: a ("data", "model") ``parallel.mesh.Mesh``; every rank calls
    this with the same samples and holds its shard (the model's heads over
    "model", the engine's slots over "data"; see ``ContinuousBatcher``), and
    every rank returns the same predictions.

    Returns (predictions in sample order, the metric's result, or None when
    a sample has no answer)."""
    from unimedvl_tpu_torch.inference import serving

    samples = list(samples)
    batcher = serving.ContinuousBatcher(
        model, tokenizer, new_token_ids, num_slots, capacity,
        vit_transform=build_transform(), mesh=mesh, spec_decode=spec_decode,
        kv_quantized=kv_quantized, kv_bits=kv_bits,
    )
    rids = []
    for s in samples:
        img = s.get("image")
        if isinstance(img, str):
            img = Image.open(img)
        if img is not None:
            img = pil_img2rgb(img)
        rids.append(batcher.submit(
            serving.Request(prompt=s["question"], image=img, max_new_tokens=max_new_tokens)))
    results = batcher.run()
    predictions = [results[r] for r in rids]

    answers = [s.get("answer") for s in samples]
    acc = None
    if answers and all(a is not None for a in answers):
        acc = metric(predictions, answers)
    return predictions, acc
