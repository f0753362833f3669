"""The port's eval package (``unimedvl_tpu_torch.eval``) against the JAX
package's, on the CPU.

- The text metrics (the port keeps its own copy of the pure-Python module):
  BLEU-3, ROUGE-L, METEOR and ``report_metrics`` on seeded random corpora
  against ``unimedvl_tpu.eval.text_metrics`` (equal floats: the same
  formulas in the same order), and the hand-computed cases of
  tests/test_text_metrics.py and tests/test_eval.py.
- ``run_vqa_eval`` on tests/test_pipeline.py's TINY config, the same fp32
  weights (``from_jax_params``), the fake tokenizer, ``build_transform``
  monkeypatched to the tiny ViT's geometry in both packages as
  tests/test_eval.py does: the same predictions, string for string, and the
  same metric, over a float pool and an int4 pool (the int8 pool's engine is
  held in tests/test_torch_serving.py).
"""

import math

import jax
import numpy as np
import pytest
from PIL import Image

from unimedvl_tpu.data.imaging import ImageTransform
from unimedvl_tpu.data.tokenizer import add_special_tokens
from unimedvl_tpu.eval import text_metrics as jtm
from unimedvl_tpu.eval import vqa as jvqa
from unimedvl_tpu_torch import eval as teval
from unimedvl_tpu_torch.data import imaging as timaging
from unimedvl_tpu_torch.data import tokenizer as ttokenizer
from unimedvl_tpu_torch.eval import text_metrics as tm
from unimedvl_tpu_torch.eval import vqa
from unimedvl_tpu_torch.parallel import mesh as pmesh
from unimedvl_tpu_torch.weights.loader import from_jax_params

from tests.test_pipeline import TINY
from tests.test_torch_config import init_params, port_config
from tests.test_torch_pipeline import FakeTokenizer

PRED = "the cat sat on mat"
REF = "the cat sat on the mat"
WORDS = ["the", "left", "lung", "opacity", "no", "effusion", "Mild", "right", "base,",
         "heart.", "size", "normal", "is", "a", "of"]


def _corpus(seed, n=12):
    """n (prediction, reference) pairs of 0-14 words from a small
    vocabulary (many shared n-grams), some identical, one empty."""
    rng = np.random.default_rng(seed)
    preds, refs = [], []
    for i in range(n):
        ref = " ".join(rng.choice(WORDS, rng.integers(1, 15)))
        pred = ref if i % 4 == 0 else " ".join(rng.choice(WORDS, rng.integers(0, 15)))
        preds.append(pred)
        refs.append(ref)
    preds[-1] = ""
    return preds, refs


@pytest.mark.parametrize("seed", range(6))
def test_metrics_match_jax_on_random_corpora(seed):
    preds, refs = _corpus(seed)
    for n in (1, 2, 3, 4):
        assert tm.bleu(preds, refs, max_n=n) == jtm.bleu(preds, refs, max_n=n)
    for name in ("bleu3", "rouge_l", "meteor"):
        assert getattr(tm, name)(preds, refs) == getattr(jtm, name)(preds, refs), name
    assert tm.report_metrics(preds, refs) == jtm.report_metrics(preds, refs)
    for p, r in zip(preds, refs):
        assert tm.tokenize(p) == jtm.tokenize(p)
        assert tm.report_metrics([p], [r]) == jtm.report_metrics([p], [r])
    assert vqa.exact_match_accuracy(preds, refs) == jvqa.exact_match_accuracy(preds, refs)


class TestHandComputed:
    """tests/test_text_metrics.py's cases, on the port's copy."""

    def test_bleu(self):
        assert tm.bleu3([REF], [REF]) == 1.0
        want = math.exp(-0.2) * (1.0 * 0.75 * (2 / 3)) ** (1 / 3)
        np.testing.assert_allclose(tm.bleu3([PRED], [REF]), want, rtol=1e-12)
        assert tm.bleu3(["a x b y c z"], ["a b c q r s"]) == 0.0
        assert tm.bleu3([""], [REF]) == 0.0

    def test_rouge_l(self):
        p, r, b2 = 1.0, 5 / 6, 1.44
        np.testing.assert_allclose(tm.rouge_l([PRED], [REF]),
                                   (1 + b2) * p * r / (r + b2 * p), rtol=1e-12)
        p, r = 2 / 3, 1.0
        np.testing.assert_allclose(tm.rouge_l(["a x b"], ["a b"]),
                                   (1 + b2) * p * r / (r + b2 * p), rtol=1e-12)
        assert tm.rouge_l(["The cat."], ["the cat"]) == 1.0

    def test_meteor(self):
        p, r = 1.0, 5 / 6
        f_mean = p * r / (0.9 * p + 0.1 * r)
        np.testing.assert_allclose(tm.meteor([PRED], [REF]),
                                   (1 - 0.5 * (2 / 5) ** 3) * f_mean, rtol=1e-12)
        np.testing.assert_allclose(tm.meteor([REF], [REF]), 1.0 - 0.5 * (1 / 6) ** 3,
                                   rtol=1e-12)
        assert tm.meteor(["a b"], ["c d"]) == 0.0

    def test_report_metrics_and_tokenize(self):
        out = tm.report_metrics([PRED, REF], [REF, REF])
        assert set(out) == {"bleu3", "meteor", "rouge_l"}
        assert all(0.0 <= v <= 1.0 for v in out.values())
        assert tm.tokenize("The CAT, sat!") == ["the", "cat", "sat"]

    def test_exact_match(self):
        assert vqa.exact_match_accuracy(["Yes", "no", "left lung"],
                                        ["yes", "yes", "Left Lung"]) == pytest.approx(2 / 3)
        assert vqa.exact_match_accuracy(["the answer is pneumonia."], ["pneumonia"]) == 1.0
        assert vqa.exact_match_accuracy([], []) == 0.0

    def test_process_conversation(self):
        img = Image.new("RGBA", (4, 4), (255, 0, 0, 0))
        imgs, conv = vqa.process_conversation([img], [{"q": "x"}])
        assert imgs[0].mode == "RGB" and conv == [{"q": "x"}]


def test_package_exports_and_transform():
    import unimedvl_tpu.eval as jeval

    assert teval.__all__ == jeval.__all__
    t, jt = vqa.build_transform(), jvqa.build_transform()
    rt, jrt = t.resize_transform, jt.resize_transform
    assert (rt.max_size, rt.min_size, rt.stride, rt.max_pixels) == (
        jrt.max_size, jrt.min_size, jrt.stride, jrt.max_pixels) == (980, 378, 14, 2_007_040)


@pytest.fixture(scope="module")
def models():
    params = init_params(0, TINY, llm2vae_zero=False)
    model = from_jax_params(jax.tree.map(np.asarray, params), port_config(TINY), device="cpu")
    return params, model


def _samples(tmp_path):
    rng = np.random.default_rng(0)
    imgs = [Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
            for h, w in ((24, 28), (28, 24), (24, 28))]  # one bucket: one JAX compile
    path = tmp_path / "sample.png"
    imgs[2].save(path)
    return [
        {"image": imgs[0], "question": "q one", "answer": "a"},
        {"image": None, "question": "q two", "answer": "b"},
        {"image": imgs[1].convert("RGBA"), "question": "is there an effusion?",
         "answer": "no"},
        {"image": str(path), "question": "which side?", "answer": "left"},
        {"image": None, "question": "describe the findings", "answer": "normal"},
    ]


@pytest.mark.parametrize("kv", [dict(), dict(kv_quantized=True, kv_bits=4)],
                         ids=["float", "int4"])  # the int8 pool: tests/test_torch_serving.py
def test_run_vqa_eval_matches_jax(models, monkeypatch, tmp_path, kv):
    """Five samples (three images, one given as a path, one RGBA; two text)
    over two slots: the predictions equal the JAX runner's, string for
    string, and so does the accuracy."""
    params, model = models
    monkeypatch.setattr(jvqa, "build_transform", lambda: ImageTransform(32, 8, 2, 1024))
    monkeypatch.setattr(vqa, "build_transform", lambda: timaging.ImageTransform(32, 8, 2, 1024))
    tok, ids, _ = add_special_tokens(FakeTokenizer())
    ttok, tids, _ = ttokenizer.add_special_tokens(FakeTokenizer())
    samples = _samples(tmp_path)
    opts = dict(max_new_tokens=5, num_slots=2, capacity=512, **kv)
    want, want_acc = jvqa.run_vqa_eval(params, TINY, tok, ids, samples, **opts)
    got, acc = vqa.run_vqa_eval(model, ttok, tids, samples, **opts)
    assert len(got) == 5 and all(isinstance(p, str) for p in got)
    assert got == want
    assert acc == want_acc and 0.0 <= acc <= 1.0
    # any metric over (predictions, answers); the answers are the predictions' own
    answers = [dict(s, answer=p) for s, p in zip(samples, want)]
    _, report = vqa.run_vqa_eval(model, ttok, tids, answers, metric=tm.report_metrics, **opts)
    assert report == jtm.report_metrics(want, want)


def test_run_vqa_eval_without_answers_and_refusals(models, monkeypatch):
    _, model = models
    monkeypatch.setattr(vqa, "build_transform", lambda: timaging.ImageTransform(32, 8, 2, 1024))
    ttok, tids, _ = ttokenizer.add_special_tokens(FakeTokenizer())
    preds, acc = vqa.run_vqa_eval(model, ttok, tids, [{"question": "q", "answer": "a"},
                                                      {"question": "r"}],
                                  max_new_tokens=3, num_slots=2, capacity=128)
    assert len(preds) == 2 and acc is None
    # a mesh is taken (tests/test_torch_serving_mesh.py); one without the serving axes is not
    with pytest.raises(ValueError, match="'data', 'model'"):
        vqa.run_vqa_eval(model, ttok, tids, [], mesh=pmesh.make_mesh(("model", "seq"), (1, 1)))
    with pytest.raises(ValueError, match="8 or 4 bits"):
        vqa.run_vqa_eval(model, ttok, tids, [], kv_quantized=True, kv_bits=2)
