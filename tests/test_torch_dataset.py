"""The port's example-to-packed-batch pipeline against the JAX package's
(TINY config, CPU): items and stacked batches equal array for array for the
same seed, the VAE latent function within fp32 tolerance, the Prefetcher's
order, worker exception and close, ``place_batches``, and a short run over
the whole path (iterator -> prefetcher -> train step) whose loss falls.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from unimedvl_tpu.data.imaging import ImageTransform as JImageTransform
from unimedvl_tpu.data.tokenizer import add_special_tokens as j_add_special_tokens
from unimedvl_tpu.training import dataset as jdataset
from unimedvl_tpu_torch.data.imaging import ImageTransform
from unimedvl_tpu_torch.data.tokenizer import add_special_tokens
from unimedvl_tpu_torch.training import dataset, trainer

from tests.test_pipeline import TINY, FakeTokenizer
from tests.test_torch_config import init_params, port_config
from tests.test_torch_train import port_model

TCFG = port_config(TINY)
TASKS = [("vlm_sft", dict(text="what is shown?", answer="a lung.")),
         ("vlm_sft", dict(text="any fracture?", answer="no.")),
         ("t2i_pretrain", dict(text="a chest x-ray")),
         ("unified_edit", dict(text="add contrast"))]


def _img(seed, shape=(24, 28, 3)):
    r = np.random.default_rng(seed)
    return Image.fromarray(r.integers(0, 255, shape, dtype=np.uint8))


def _examples(cls):
    out = []
    for i, (task, kw) in enumerate(TASKS):
        extra = dict(target_image=_img(10 + i)) if task == "unified_edit" else {}
        out.append(cls(task, image=_img(i + 1), **kw, **extra))
    return out


@pytest.fixture(scope="module")
def setup():
    params = init_params(0, TINY, llm2vae_zero=False)
    return params, port_model(params), jdataset.make_latent_fn(params, TINY)


def _iterators(latent_fn, **kw):
    jtok, jids, _ = j_add_special_tokens(FakeTokenizer())
    ttok, tids, _ = add_special_tokens(FakeTokenizer())
    assert jids == tids
    jit = jdataset.PackedBatchIterator(
        _examples(jdataset.Example), jtok, jids, TINY, JImageTransform(32, 8, 2, 1024),
        JImageTransform(32, 8, 8, 1024), latent_fn=latent_fn, **kw)
    tit = dataset.PackedBatchIterator(
        _examples(dataset.Example), ttok, tids, TCFG, ImageTransform(32, 8, 2, 1024),
        ImageTransform(32, 8, 8, 1024), latent_fn=latent_fn, **kw)
    return jit, tit


class TestIterator:
    @pytest.mark.parametrize("kw", [dict(batch_size=2, seq_len=256, seed=0),
                                    dict(batch_size=3, seq_len=320, seed=5, pad_multiple=32,
                                         loss_reduction="square")])
    def test_batches_equal_the_jax_iterators(self, setup, kw):
        jit, tit = _iterators(setup[2], **kw)
        ji, ti = iter(jit), iter(tit)
        for _ in range(3):
            want, got = next(ji), next(ti)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    def test_latent_fn(self, setup):
        _, model, jlatent = setup
        arr = np.asarray(_img(3, (32, 24, 3)))
        got, want = dataset.make_latent_fn(model)(arr), jlatent(arr)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)  # fp32 convolutions

    def test_items_need_a_latent_fn(self):
        tok, ids, _ = add_special_tokens(FakeTokenizer())
        t = ImageTransform(32, 8, 8, 1024)
        with pytest.raises(ValueError, match="latent_fn"):
            dataset.example_to_items(dataset.Example("t2i_pretrain", "x", image=_img(1)), tok,
                                     ids, TCFG, t, t, None, np.random.default_rng(0))
        with pytest.raises(ValueError, match="empty"):
            dataset.PackedBatchIterator([], tok, ids, TCFG, t, t)

    def test_stack_packed_and_place_batches(self, setup):
        _, tit = _iterators(setup[2], batch_size=3, seq_len=256, seed=1)
        stacked = next(iter(tit))
        T = stacked["packed_position_ids"].shape[1]
        seqs = trainer.place_batches(stacked, "cpu")
        assert len(seqs) == 3 and trainer.place_batches(seqs, "cpu") == seqs
        for b, seq in enumerate(seqs):
            assert seq["und_idx"].dtype == torch.int64
            assert seq["mask_document_id"].dtype == torch.int32
            for key in ("und_idx", "gen_idx", "packed_text_indexes", "vae_scatter_idx"):
                if key in seq and seq[key].numel():
                    assert int(seq[key].max()) < T
            n_real = int((stacked["mask_document_id"][b] > 0).sum())
            assert len(seq["und_idx"]) + len(seq["gen_idx"]) == n_real
        assert dataset.make_place_fn("cpu")(stacked)[0].keys() == seqs[0].keys()


class TestPrefetcher:
    def test_order_and_end(self):
        seen = []
        pf = dataset.Prefetcher(iter(range(7)), depth=2,
                                place_fn=lambda x: (seen.append(threading.get_ident()), x * 2)[1])
        assert list(pf) == [0, 2, 4, 6, 8, 10, 12]
        assert set(seen) != {threading.get_ident()}  # placed in the worker thread

    def test_worker_exception_reaches_the_consumer(self):
        def gen():
            yield 1
            raise KeyError("boom")

        pf = dataset.Prefetcher(gen())
        assert next(pf) == 1
        with pytest.raises(KeyError, match="boom"):
            next(pf)

    def test_close_stops_the_worker(self):
        def forever():
            i = 0
            while True:
                yield i
                i += 1

        pf = dataset.Prefetcher(forever(), depth=1)
        assert next(pf) == 0
        pf.close()
        pf._thread.join(timeout=5)
        assert not pf._thread.is_alive()


def test_short_overfit_run(setup):
    """Iterator -> Prefetcher -> make_train_step for 30 steps on four examples:
    the loss falls and both experts move."""
    params, _, jlatent = setup
    model = port_model(params)
    _, tit = _iterators(dataset.make_latent_fn(model), batch_size=2, seq_len=256, seed=0)
    it = dataset.Prefetcher(tit, place_fn=dataset.make_place_fn("cpu"))
    step, init_state = trainer.make_train_step(
        TCFG, model, trainer.make_optimizer(learning_rate=3e-3), ema_decay=0.99)
    state = init_state()
    layer = model.language_model.model.layers[0]
    w_und = layer.mlp.gate_proj.weight.detach().clone()
    w_gen = layer.mlp_moe_gen.gate_proj.weight.detach().clone()
    g = torch.Generator().manual_seed(7)
    t0 = time.time()
    curve = []
    try:
        for _ in range(30):
            state, loss = step(state, next(it), generator=g)
            curve.append(float(loss))
    finally:
        it.close()
    assert np.isfinite(curve).all() and time.time() - t0 < 120
    assert np.mean(curve[-5:]) < 0.9 * np.mean(curve[:5]), curve
    assert not torch.equal(layer.mlp.gate_proj.weight, w_und)
    assert not torch.equal(layer.mlp_moe_gen.gate_proj.weight, w_gen)
    assert state.step == 30
