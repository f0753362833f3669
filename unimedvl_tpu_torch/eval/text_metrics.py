"""Report-generation text metrics: BLEU-n, ROUGE-L, METEOR (the port's own
copy of unimedvl_tpu/eval/text_metrics.py; pure Python, no framework).

The reference's counterfactual-CXR table reports BLEU-3 / METEOR / ROUGE-L
for generated radiology reports; the batched eval runner (eval/vqa.py) needs
these beyond closed-set exact match. The standard formulas:

  * BLEU-n: corpus-level, uniform 1..n weights, brevity penalty
    (Papineni et al. 2002).
  * ROUGE-L: sentence-level LCS F-measure with beta=1.2 averaged over the
    corpus (Lin 2004; beta matches the COCO caption eval implementation).
  * METEOR: exact-match alignment harmonic mean with fragmentation penalty,
    alpha=0.9, beta=3, gamma=0.5 (Lavie & Denkowski 2009 defaults). Without
    stem/synonym stages scores are slightly conservative vs the Java tool.

Tokenization is lowercase + punctuation-split, shared across metrics.
"""

from __future__ import annotations

import math
import re
from collections import Counter
from typing import Dict, List, Sequence


def tokenize(text: str) -> List[str]:
    return re.findall(r"\w+", text.lower())


# ---------------------------------------------------------------------------
# BLEU
# ---------------------------------------------------------------------------

def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def bleu(
    predictions: Sequence[str], references: Sequence[str], max_n: int = 3
) -> float:
    """Corpus BLEU with uniform weights over 1..max_n and brevity penalty.
    Single reference per prediction."""
    assert len(predictions) == len(references)
    clipped = [0] * max_n
    totals = [0] * max_n
    pred_len = 0
    ref_len = 0
    for p, r in zip(predictions, references):
        pt, rt = tokenize(p), tokenize(r)
        pred_len += len(pt)
        ref_len += len(rt)
        for n in range(1, max_n + 1):
            pn = _ngrams(pt, n)
            rn = _ngrams(rt, n)
            totals[n - 1] += sum(pn.values())
            clipped[n - 1] += sum(min(c, rn[g]) for g, c in pn.items())
    if pred_len == 0:
        return 0.0
    log_precisions = []
    for c, t in zip(clipped, totals):
        if c == 0 or t == 0:
            return 0.0
        log_precisions.append(math.log(c / t))
    bp = 1.0 if pred_len > ref_len else math.exp(1.0 - ref_len / max(pred_len, 1))
    return bp * math.exp(sum(log_precisions) / max_n)


def bleu3(predictions: Sequence[str], references: Sequence[str]) -> float:
    return bleu(predictions, references, max_n=3)


# ---------------------------------------------------------------------------
# ROUGE-L
# ---------------------------------------------------------------------------

def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def rouge_l(
    predictions: Sequence[str], references: Sequence[str], beta: float = 1.2
) -> float:
    """Mean sentence-level ROUGE-L F-measure (beta weights recall, 1.2 as in
    the COCO caption evaluator)."""
    assert len(predictions) == len(references)
    scores = []
    for p, r in zip(predictions, references):
        pt, rt = tokenize(p), tokenize(r)
        lcs = _lcs_len(pt, rt)
        if lcs == 0:
            scores.append(0.0)
            continue
        prec = lcs / len(pt)
        rec = lcs / len(rt)
        scores.append((1 + beta**2) * prec * rec / (rec + beta**2 * prec))
    return sum(scores) / max(len(scores), 1)


# ---------------------------------------------------------------------------
# METEOR
# ---------------------------------------------------------------------------

def _meteor_align(pt: List[str], rt: List[str]) -> List[tuple]:
    """Greedy left-to-right exact alignment: each pred token matches the
    first unused identical ref token."""
    used = [False] * len(rt)
    pairs = []
    for i, tok in enumerate(pt):
        for j, rtok in enumerate(rt):
            if not used[j] and tok == rtok:
                used[j] = True
                pairs.append((i, j))
                break
    return pairs


def _chunks(pairs: List[tuple]) -> int:
    """Number of maximal runs contiguous AND monotonic in both sentences."""
    if not pairs:
        return 0
    chunks = 1
    for (i0, j0), (i1, j1) in zip(pairs, pairs[1:]):
        if i1 != i0 + 1 or j1 != j0 + 1:
            chunks += 1
    return chunks


def meteor(
    predictions: Sequence[str],
    references: Sequence[str],
    alpha: float = 0.9,
    beta: float = 3.0,
    gamma: float = 0.5,
) -> float:
    """Mean sentence-level METEOR (exact-match stage only)."""
    assert len(predictions) == len(references)
    scores = []
    for p, r in zip(predictions, references):
        pt, rt = tokenize(p), tokenize(r)
        pairs = _meteor_align(pt, rt)
        m = len(pairs)
        if m == 0 or not pt or not rt:
            scores.append(0.0)
            continue
        prec = m / len(pt)
        rec = m / len(rt)
        f_mean = prec * rec / (alpha * prec + (1 - alpha) * rec)
        frag = _chunks(pairs) / m
        penalty = gamma * frag**beta
        scores.append((1 - penalty) * f_mean)
    return sum(scores) / max(len(scores), 1)


def report_metrics(
    predictions: Sequence[str], references: Sequence[str]
) -> Dict[str, float]:
    """The counterfactual-CXR text columns: BLEU-3, METEOR, ROUGE-L."""
    return {
        "bleu3": bleu3(predictions, references),
        "meteor": meteor(predictions, references),
        "rouge_l": rouge_l(predictions, references),
    }
