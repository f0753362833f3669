"""The port's ``ContinuousBatcher`` (unimedvl_tpu_torch/inference/serving.py)
against the JAX package's, on the CPU: tests/test_pipeline.py's TINY config,
the same weights (``from_jax_params``), fp32, the fake byte tokenizer.

The engines' contract: the same requests give the same answers (rid ->
text), the same ``errors`` keys and the same ``stats["emitted_tokens"]``.
The pool moves and the chunks are held against the JAX functions on the same
inputs: caches agree within 1e-5 in fp32 (int8 values exactly, their scales
within 1e-6 relative), lens exactly. The cases follow tests/test_serving.py:
answers equal to unbatched ``chat``, grouped image admission, capacity
rejection and the co-admission split, the legacy pool path, a failed image,
the early exit, the scatter fallback near capacity, the int8 pool, the pool
ladder, the prefix cache, cancellation and a w4a8 engine; and the speculative
engine (``spec_decode``, tests/test_serving.py:229, :277, :830), against the
JAX one and the plain engine, with images, a preamble and near capacity.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from unimedvl_tpu import quant as jquant
from unimedvl_tpu.data.imaging import ImageTransform
from unimedvl_tpu.data.tokenizer import add_special_tokens
from unimedvl_tpu.inference import serving as jserving
from unimedvl_tpu.models import bagel as jbagel
from unimedvl_tpu.models import qwen2_mot as jmot
from unimedvl_tpu_torch import quant
from unimedvl_tpu_torch.data import imaging as timaging
from unimedvl_tpu_torch.data import tokenizer as ttokenizer
from unimedvl_tpu_torch.inference import ContinuousBatcher, InterleaveInferencer, Request
from unimedvl_tpu_torch.inference import serving
from unimedvl_tpu_torch.models import bagel
from unimedvl_tpu_torch.models.qwen2_mot import KVCache
from unimedvl_tpu_torch.ops import decode_attention as dec
from unimedvl_tpu_torch.ops import flash_attention as fa
from unimedvl_tpu_torch.weights.loader import from_jax_params

from tests.test_pipeline import TINY as CFG
from tests.test_torch_config import init_params, port_config
from tests.test_torch_pipeline import QCFG, QUANT_MODES, FakeTokenizer

ATOL = 1e-5
PREAMBLE = "you are a radiology assistant. answer concisely. "


@dataclasses.dataclass
class Side:
    """One framework's batcher class, request class and constructor options."""

    batcher: object
    request: object
    kw: dict

    def engine(self, **kw):
        return self.batcher(**self.kw, **kw)


@pytest.fixture(scope="module")
def pair():
    return make_pair(init_params(1, CFG))


def make_pair(params):
    """Both batchers and the port's inferencer over one JAX tree of CFG."""
    model = from_jax_params(jax.tree.map(np.asarray, params), port_config(CFG), device="cpu")
    tok, ids, _ = add_special_tokens(FakeTokenizer())
    ttok, tids, _ = ttokenizer.add_special_tokens(FakeTokenizer())
    jside = Side(
        lambda **kw: jserving.ContinuousBatcher(
            params, CFG, tok, ids, vit_transform=ImageTransform(32, 8, 2, 1024), **kw),
        jserving.Request, {})
    tside = Side(
        lambda **kw: ContinuousBatcher(
            model, ttok, tids, vit_transform=timaging.ImageTransform(32, 8, 2, 1024), **kw),
        Request, {})
    inf = InterleaveInferencer(model, ttok, tids,
                               vit_transform=timaging.ImageTransform(32, 8, 2, 1024))
    return dict(params=params, model=model, jax=jside, torch=tside, inf=inf)


def _image(seed, h, w):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))


def serve(side: Side, requests, prefixes=(), cancel=None, warm=None, **kw):
    """Submit ``requests`` (dicts of Request fields; ``prefix`` indexes
    ``prefixes``) to a new engine and run it: (answers in submission order,
    the engine, rids). ``cancel(engine, rids)`` runs after the first round;
    ``warm`` requests run to the end first."""
    eng = side.engine(**kw)
    pids = [eng.register_prefix(p) for p in prefixes]
    if warm:
        for r in warm:
            eng.submit(side.request(**r))
        eng.run()

    def make(r):
        r = dict(r)
        if "prefix" in r:
            p = r.pop("prefix")
            r["prefix_id"] = pids[p] if p < len(pids) else p
        return side.request(**r)

    rids = [eng.submit(make(r)) for r in requests]
    if cancel is not None:
        eng._reset_stats()
        eng._round(eng.stats, eng.new_token_ids["eos_token_id"])
        cancel(eng, rids)
    eng.run()
    return [eng._done.get(r) for r in rids], eng, rids


def both(pair, requests, **kw):
    """The engines' contract on one workload; returns the port's (answers,
    engine)."""
    want, jeng, _ = serve(pair["jax"], requests, **kw)
    got, teng, _ = serve(pair["torch"], requests, **kw)
    assert got == want, (got, want)
    assert sorted(teng.errors) == sorted(jeng.errors), (teng.errors, jeng.errors)
    assert teng.stats["emitted_tokens"] == jeng.stats["emitted_tokens"]
    return got, teng


def both_ids(pair, requests, **kw):
    """Both engines on ``requests``, recording each request's ids (the
    slot's ``out_ids``: the start token and the emitted tokens) as it
    finishes: they must be equal token for token, and ``errors`` empty.
    Returns the port's (ids in submission order, engine)."""
    out = []
    for side in (pair["jax"], pair["torch"]):
        eng = side.engine(**kw)
        ids = {}

        def record(slot, ids=ids, finish=eng._finish):
            ids[slot.request_id] = list(slot.out_ids)
            finish(slot)

        eng._finish = record
        rids = [eng.submit(side.request(**r)) for r in requests]
        eng.run()
        out.append(([ids.get(r) for r in rids], eng))
    (want, jeng), (got, teng) = out
    assert got == want, (got, want)
    assert not teng.errors and not jeng.errors, (teng.errors, jeng.errors)
    return got, teng


def chat_answers(inf, requests):
    """The unbatched oracle: the port's ``chat`` / ``gen_text`` per request."""
    out = []
    for r in requests:
        if r.get("image") is not None:
            out.append(inf.chat([r["image"]], r["prompt"], max_length=r["max_new_tokens"]))
        else:
            ctx = inf.update_context_text(r["prompt"], inf.init_gen_context())
            out.append(inf.gen_text(ctx, max_length=r["max_new_tokens"]))
    return out


TEXT = [dict(prompt=p, max_new_tokens=m) for p, m in
        [("alpha", 6), ("beta question", 9), ("gamma?", 4), ("delta scan", 7), ("eps", 6)]]
IMAGES = [dict(prompt=p, image=_image(11 + i, h, w), max_new_tokens=5) for i, (p, h, w) in
          enumerate([("what?", 24, 28), ("describe", 26, 22), ("count", 10, 12)])]
SLOTS = dict(num_slots=4, capacity=512, chunk=4)


class TestEngine:
    @pytest.mark.parametrize("requests,kw", [
        (TEXT, dict(num_slots=2, capacity=128, chunk=4)),
        (IMAGES[:1] + TEXT[:1], dict(num_slots=2, capacity=512, chunk=4)),
    ], ids=["text", "image"])
    def test_matches_unbatched_chat(self, pair, requests, kw):
        got, eng = both(pair, requests, **kw)
        assert not eng.errors
        assert got == chat_answers(pair["inf"], requests)

    def test_image_group_prefill(self, pair):
        """Three images (two share a bucket) and a text request admitted in
        one round: grouped ViT prefill per bucket, as unbatched chat."""
        requests = IMAGES + TEXT[3:4]
        before = dict(fa.counts)
        got, eng = both(pair, requests, **SLOTS)
        assert not eng.errors
        assert got == chat_answers(pair["inf"], requests)
        assert fa.counts["plain"] > before["plain"]

    def test_overcapacity_rejected_before_prefill(self, pair):
        requests = [dict(prompt="fits", max_new_tokens=5),
                    dict(prompt="way too long", max_new_tokens=10_000),
                    dict(prompt="also fits", max_new_tokens=5)]
        got, eng = both(pair, requests, num_slots=2, capacity=64, chunk=4)
        assert got[1] is None and "rejected before prefill" in eng.errors[1]
        assert got[0] is not None and got[2] is not None

    def test_near_capacity_coadmission_not_dropped(self, pair):
        """An image request near capacity co-admitted with a longer prompt:
        its text window must not overflow (the split into fitting groups)."""
        requests = [dict(prompt="hey", image=_image(12, 8, 8), max_new_tokens=5),
                    dict(prompt="x" * 38, max_new_tokens=5)]
        got, eng = both(pair, requests, num_slots=2, capacity=64, chunk=4)
        assert not eng.errors
        assert got == chat_answers(pair["inf"], requests)

    def test_legacy_pool_path(self, pair):
        """bucket + 2 + T_pad > capacity although the request fits: the image
        block goes into the pool first, the text after it over the pool."""
        requests = [dict(prompt="hey", image=_image(13, 10, 12), max_new_tokens=5),
                    dict(prompt="text co-admit", max_new_tokens=5)]
        got, eng = both(pair, requests, num_slots=2, capacity=64, chunk=4)
        assert not eng.errors
        assert got == chat_answers(pair["inf"], requests)

    def test_failed_image_does_not_kill_the_batch(self, pair):
        class BadImage:
            def __getattr__(self, name):
                raise RuntimeError("corrupt image")

        requests = [dict(prompt="hello", max_new_tokens=5),
                    dict(prompt="oops", image=BadImage(), max_new_tokens=5)]
        got, eng = both(pair, requests, num_slots=2, capacity=512, chunk=4)
        assert got[0] is not None and 1 in eng.errors

    def test_near_capacity_falls_back_to_the_scatter_chunk(self, pair, monkeypatch):
        # kv_len 41 (bos + 39 + eos), extent 41 + 22 + 1 = 64: the third chunk's
        # band would start at 57 and end past 64, so it runs scattered, and its
        # last step writes past capacity after the request finished (dropped)
        requests = [dict(prompt="q" * 39, max_new_tokens=22)]
        calls = []
        for name in ("decode_chunk", "decode_chunk_aligned"):
            fn = getattr(serving, name)
            monkeypatch.setattr(serving, name, lambda *a, _f=fn, _n=name, **k: (
                calls.append(_n), _f(*a, **k))[1])
        got, eng = both(pair, requests, num_slots=2, capacity=64, chunk=8)
        assert not eng.errors
        assert got == chat_answers(pair["inf"], requests)
        assert calls[0] == "decode_chunk_aligned" and "decode_chunk" in calls

    def test_int8_pool_matches_jax(self, pair):
        requests = TEXT[:3] + [dict(prompt="look", image=_image(3, 24, 28), max_new_tokens=6)]
        got, eng = both(pair, requests, kv_quantized=True, **SLOTS)
        assert not eng.errors and eng.cache.k.dtype == torch.int8

    def test_one_stream_scatter_chunk_past_capacity(self, pair, monkeypatch):
        """``num_slots=1``, one request planned to the capacity (kv_len 22 +
        42 + 1 = 65) whose budget ends one token into a scatter chunk: the
        chunk's other steps write at columns 63-65, past the end, which one
        stream clamps back over its last column, as the JAX package's
        ``dynamic_update_slice`` does. The ids equal the JAX batcher's token
        for token. Before the S = 1 repair the write past M raised
        (IndexError on the CPU, a device-side assert on the card)."""
        past = []
        chunk = serving.decode_chunk

        def watched(*args, **kw):
            out = chunk(*args, **kw)
            past.append(int(out[3].lens.max()) > out[3].capacity)
            return out

        monkeypatch.setattr(serving, "decode_chunk", watched)
        got, eng = both_ids(pair, [dict(prompt="q" * 20, max_new_tokens=42)], num_slots=1,
                            capacity=65, chunk=4)
        assert len(got[0]) == 42 and any(past)

    def test_t2i_request_rejected(self, pair):
        """Without a pipeline a text-to-image request is rejected into
        ``errors`` before any device work (tests/test_serving.py:507)."""
        requests = [dict(prompt="draw", image_size=(32, 32)), dict(prompt="hi", max_new_tokens=4)]
        got, eng = serve(pair["torch"], requests, **SLOTS)[:2]
        assert got[0] is None and "pipeline" in eng.errors[0]
        assert got[1] is not None


class TestPoolLadder:
    LONG = [dict(prompt=p, max_new_tokens=m, **({"image": _image(5, 24, 28)} if i == 0 else {}))
            for i, (p, m) in enumerate([("look here", 10), ("alpha", 3), ("beta question", 12),
                                        ("gamma?", 3), ("eps longer", 3)])]

    @pytest.mark.parametrize("kv_quantized", [False, True], ids=["fp32", "int8"])
    def test_ladder_matches_fixed_pool(self, pair, kv_quantized):
        want, _ = both(pair, self.LONG, num_slots=8, capacity=512, chunk=4,
                       kv_quantized=kv_quantized)
        got, eng = both(pair, self.LONG, num_slots=8, capacity=512, chunk=4,
                        kv_quantized=kv_quantized, pool_ladder=True, min_pool=2)
        assert got == want
        assert eng.stats["repacks"] >= 1 and eng.pool in eng._rungs and eng.pool < 8

    def test_ladder_grows_for_a_backlog(self, pair):
        requests = [dict(prompt=f"req {i}", max_new_tokens=4) for i in range(9)]
        want, _ = both(pair, requests, num_slots=8, capacity=512, chunk=4)
        got, eng = both(pair, requests, num_slots=8, capacity=512, chunk=4, pool_ladder=True,
                        min_pool=2, warm=[dict(prompt="w", max_new_tokens=2)])
        assert got == want
        assert eng.stats["repacks"] >= 1


class TestPrefixCache:
    SUFFIXES = [dict(prompt=s, max_new_tokens=m) for s, m in
                [("is there a fracture?", 6), ("describe the lungs", 9), ("any effusion?", 4)]]

    @pytest.mark.parametrize("kv_quantized", [False, True], ids=["fp32", "int8"])
    def test_matches_unprefixed(self, pair, kv_quantized):
        prefixed = [dict(r, prefix=0) for r in self.SUFFIXES]
        got, eng = both(pair, prefixed, prefixes=[PREAMBLE], kv_quantized=kv_quantized,
                        **SLOTS)
        plain = [dict(r, prompt=PREAMBLE + r["prompt"]) for r in self.SUFFIXES]
        want, _ = both(pair, plain, kv_quantized=kv_quantized, **SLOTS)
        assert got == want and len(eng._prefixes) == 1

    def test_mixed_prefixes_plain_and_a_bad_id(self, pair):
        requests = [dict(prompt="q one", max_new_tokens=5, prefix=0),
                    dict(prompt="q two", max_new_tokens=5, prefix=1),
                    dict(prompt="plain request", max_new_tokens=5),
                    dict(prompt="x", max_new_tokens=4, prefix=7),
                    dict(prompt="look", image=_image(3, 24, 28), max_new_tokens=4, prefix=0)]
        got, eng = both(pair, requests, prefixes=["preamble A: ", "a different preamble B!! "],
                        **SLOTS)
        assert sorted(eng.errors) == [3, 4] and "text-only" in eng.errors[4]
        want, _ = both(pair, [dict(prompt="preamble A: q one", max_new_tokens=5),
                              dict(prompt="a different preamble B!! q two", max_new_tokens=5),
                              dict(prompt="plain request", max_new_tokens=5)], **SLOTS)
        assert got[:3] == want


class TestCancel:
    def test_cancel_before_start_and_mid_decode(self, pair):
        requests = [dict(prompt="alpha", max_new_tokens=12), dict(prompt="beta", max_new_tokens=8),
                    dict(prompt="gamma", max_new_tokens=6)]

        def cancel(eng, rids):
            assert eng.cancel(rids[0])  # in a slot: mid-decode
            assert eng.cancel(rids[2])  # still queued: before start
            assert not eng.cancel(99)

        got, eng = both(pair, requests, cancel=cancel, num_slots=2, capacity=128, chunk=4)
        assert eng.errors == {0: "cancelled mid-decode", 2: "cancelled before start"}
        assert got[0] is None and got[2] is None
        assert got[1] == chat_answers(pair["inf"], requests[1:2])[0]


@pytest.fixture(scope="module")
def w4a8_pair():
    """Both batchers over one w4a8 tree (per channel, unfused) with int8 pools,
    the JAX ``_mlp`` held to K3's definition as in tests/test_torch_pipeline.py."""
    kw, fused = QUANT_MODES["w4a8"]
    params = init_params(3, QCFG)
    jparams = {**params, "llm": jquant.quantize_llm_params(params["llm"], via_host=True, **kw)}
    model = from_jax_params(jax.tree.map(np.asarray, params), port_config(QCFG), device="cpu")
    quant.quantize_llm_params(model.language_model, **kw)
    assert not fused
    tok, ids, _ = add_special_tokens(FakeTokenizer())
    ttok, tids, _ = ttokenizer.add_special_tokens(FakeTokenizer())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmot, "_FORCE_SILU_QUANT", True)
        yield dict(
            jax=Side(lambda **k: jserving.ContinuousBatcher(
                jparams, QCFG, tok, ids, vit_transform=ImageTransform(32, 8, 2, 1024), **k),
                jserving.Request, dict(kv_quantized=True)),
            torch=Side(lambda **k: ContinuousBatcher(
                model, ttok, tids, vit_transform=timaging.ImageTransform(32, 8, 2, 1024), **k),
                Request, dict(kv_quantized=True)))


def test_w4a8_engine_matches_jax(w4a8_pair):
    from unimedvl_tpu_torch.ops import act_quant as aq
    from unimedvl_tpu_torch.ops import w4_matmul as w4

    before = dict(aq.counts), dict(w4.counts), dict(dec.int8_counts)
    requests = TEXT[:3] + [dict(prompt="look", image=_image(4, 24, 28), max_new_tokens=6)]
    got, eng = both(w4a8_pair, requests, **SLOTS)
    assert not eng.errors and all(isinstance(g, str) for g in got)
    assert aq.counts["plain"] > before[0]["plain"] and w4.counts["plain"] > before[1]["plain"]
    assert dec.int8_counts["plain"] > before[2]["plain"]


# ---------------------------------------------------------------------------
# the functions, against the JAX package's on the same inputs
# ---------------------------------------------------------------------------

def _to_torch(c) -> KVCache:
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))  # noqa: E731
    return KVCache(k=t(c.k), v=t(c.v), lens=t(c.lens), k_scale=t(c.k_scale),
                   v_scale=t(c.v_scale))


def _to_jax(c: KVCache):
    j = lambda t: None if t is None else jnp.asarray(t.numpy())  # noqa: E731
    return jmot.KVCache(k=j(c.k), v=j(c.v), lens=j(c.lens), k_scale=j(c.k_scale),
                        v_scale=j(c.v_scale))


def assert_caches_equal(got: KVCache, want, rows=None, valid_only=True, scale_rtol=1e-6):
    """Per row, the columns [0, lens) (or all of them) agree; lens exactly."""
    want = _to_torch(want)
    lens = want.lens
    assert torch.equal(got.lens.to(lens.dtype), lens), (got.lens, lens)
    for s in range(lens.shape[0]) if rows is None else rows:
        n = int(lens[s]) if valid_only else got.k.shape[3]
        for name in ("k", "v", "k_scale", "v_scale"):
            a, w = getattr(got, name), getattr(want, name)
            if a is None:
                assert w is None
                continue
            a, w = a[:, s, :, :n], w[:, s, :, :n]
            if name.endswith("scale"):
                torch.testing.assert_close(a, w, rtol=scale_rtol, atol=0)
            elif a.dtype == torch.int8:
                assert torch.equal(a, w)
            else:
                torch.testing.assert_close(a, w, rtol=0, atol=ATOL)


def _random_cache(seed, S, M, quantized, lens):
    rng = np.random.default_rng(seed)
    L, Hk, D = CFG.llm.num_hidden_layers, CFG.llm.num_key_value_heads, CFG.llm.head_dim
    shape = (L, S, Hk, M, D)
    if quantized:
        k, v = (torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8)) for _ in "kv")
        ks, vs = (torch.from_numpy(rng.random(shape[:-1], dtype=np.float32)) for _ in "kv")
    else:
        k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)) for _ in "kv")
        ks = vs = None
    return KVCache(k=k, v=v, lens=torch.tensor(lens, dtype=torch.int32), k_scale=ks, v_scale=vs)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_group_store_leaves_out_padding_rows(quantized):
    pool = _random_cache(0, 4, 16, quantized, [3, 7, 0, 11])
    block = _random_cache(1, 3, 10, quantized, [5, 9, 2])
    slots = np.asarray([2, 4, 0])  # row 1 is padding (>= S)
    want = jserving.group_store(_to_jax(pool), _to_jax(block), jnp.asarray(slots))
    got = serving.group_store(pool.clone(), block, slots)
    assert_caches_equal(got, want, valid_only=False)


@pytest.mark.parametrize("perm", [[2, 0], [1, 3, -1, -1, 0, -1, -1, -1]], ids=["shrink", "grow"])
def test_repack_pool(perm):
    pool = _random_cache(2, 4, 8, True, [3, 7, 0, 5])
    want = jserving.repack_pool(_to_jax(pool), jnp.asarray(perm, jnp.int32))
    got = serving.repack_pool(pool, np.asarray(perm))
    assert got.k.shape[1] == len(perm)
    assert_caches_equal(got, want, valid_only=False)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_seed_prefix_block(quantized):
    block = _random_cache(3, 3, 24, quantized, [0, 0, 0])
    prefix = _random_cache(4, 1, 8, quantized, [6])
    want = jserving.seed_prefix_block(_to_jax(block), _to_jax(prefix), jnp.asarray(6, jnp.int32))
    got = serving.seed_prefix_block(block.clone(), prefix, 6)
    assert_caches_equal(got, want, valid_only=False)


def test_prefill_vit_group_with_an_inactive_row(pair):
    """Three rows of one bucket, the middle one inactive (n = 0), into a
    block with text headroom; the active rows' cache and every lens agree."""
    rng = np.random.default_rng(7)
    P, Tb, n = 3, 32, np.asarray([30, 0, 17])
    p = CFG.vit.patch_size
    toks = rng.standard_normal((P, Tb, p * p * 3)).astype(np.float32)
    pos = np.stack([np.arange(Tb) * (i + 1) % (CFG.vit_max_num_patch_per_side ** 2)
                    for i in range(P)]).astype(np.int64)
    se = np.asarray([256, 257])
    want = jbagel.prefill_vit_group(
        pair["params"], CFG, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(n, jnp.int32),
        jnp.asarray(se, jnp.int32), jnp.zeros((P,), jnp.int32), kv_dtype=jnp.float32,
        capacity=Tb + 2 + 8)
    got = bagel.prefill_vit_group(
        pair["model"], torch.from_numpy(toks), torch.from_numpy(pos), torch.from_numpy(n),
        torch.from_numpy(se), torch.zeros(P, dtype=torch.int64), kv_dtype=torch.float32,
        capacity=Tb + 2 + 8)
    assert got.capacity == Tb + 10 and got.lens.tolist() == [32, 0, 19]
    assert_caches_equal(got, want, rows=[0, 2])


def _prefilled(pair, quantized, S=3, M=64):
    """A pool after a text prefill of mixed lengths 8, 5, 3 (JAX and port)."""
    ids = np.arange(S * 8).reshape(S, 8) % CFG.llm.vocab_size
    pos8 = np.broadcast_to(np.arange(8), (S, 8))
    valid = np.asarray([[True] * 8, [True] * 5 + [False] * 3, [True] * 3 + [False] * 5])
    L, Hk, D = CFG.llm.num_hidden_layers, CFG.llm.num_key_value_heads, CFG.llm.head_dim

    def jfresh():
        c = jmot.KVCache.create(L, S, M, Hk, D, jnp.float32, quantized=quantized)
        return jbagel.prefill_text(pair["params"], CFG, c, jnp.asarray(ids, jnp.int32),
                                   jnp.asarray(pos8, jnp.int32), jnp.asarray(valid))

    c = KVCache.create(L, S, M, Hk, D, torch.float32, quantized=quantized)
    tc = bagel.prefill_text(pair["model"], c, torch.from_numpy(ids), torch.from_numpy(pos8.copy()),
                            torch.from_numpy(valid))
    return jfresh, tc


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("flavour", ["decode_chunk", "decode_chunk_aligned"])
@pytest.mark.parametrize("active,M", [([True, True, False], 64), ([False, True, True], 10)],
                         ids=["roomy", "freed-longest"])
def test_chunk_matches_jax(pair, quantized, flavour, active, M):
    """Tokens, positions, lens and each stream's valid cache, one inactive
    slot, mixed context lengths (8, 5, 3). In "freed-longest" the inactive
    slot holds the longest lens and the capacity fits the band only above
    the active slots (5 + 5 = 10): the aligned band's base is the largest
    ACTIVE lens, and the freed slot's scatter writes stay in place."""
    jfresh, cache = _prefilled(pair, quantized, M=M)
    cur, pos = [3, 5, 7], [8, 5, 3]
    K = 5
    act = np.asarray(active)
    tok_j, last_j, pos_j, cache_j = getattr(jserving, flavour)(
        pair["params"], CFG, jfresh(), jnp.asarray(cur, jnp.int32), jnp.asarray(pos, jnp.int32),
        jnp.asarray(active), K, jax.random.PRNGKey(2))
    tok, last, pos_t, cache_t = getattr(serving, flavour)(
        pair["model"], cache, torch.tensor(cur), torch.tensor(pos), torch.tensor(active), K)
    np.testing.assert_array_equal(tok.numpy()[act], np.asarray(tok_j)[act])
    np.testing.assert_array_equal(last.numpy()[act], np.asarray(last_j)[act])
    np.testing.assert_array_equal(pos_t.numpy(), np.asarray(pos_j))
    # a freed slot is dead: where the aligned band lies inside its old lens the
    # band's writes land there (the JAX chunk keeps that slot's old scales, the
    # port writes scales with the values), so only the live rows are compared
    rows = None if M == 64 else np.nonzero(act)[0]
    assert_caches_equal(cache_t, cache_j, rows=rows)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_scatter_chunk_drops_writes_past_capacity(pair, quantized):
    """A stream that runs past capacity (a slot finished mid-chunk runs on
    to the chunk's end): its writes past M are dropped, as the JAX scatter
    drops them, and every stream's cache and lens agree with the JAX chunk."""
    jfresh, cache = _prefilled(pair, quantized, M=10)
    args = ([3, 5, 7], [8, 5, 3], [True, True, True], 5)
    tok_j, _, pos_j, cache_j = jserving.decode_chunk(
        pair["params"], CFG, jfresh(), *(jnp.asarray(a) for a in args[:3]), args[3],
        jax.random.PRNGKey(2))
    tok, _, pos_t, cache_t = serving.decode_chunk(
        pair["model"], cache, *(torch.tensor(a) for a in args[:3]), args[3])
    assert cache_t.lens.tolist() == [13, 10, 8]
    np.testing.assert_array_equal(tok.numpy(), np.asarray(tok_j))
    np.testing.assert_array_equal(pos_t.numpy(), np.asarray(pos_j))
    assert_caches_equal(cache_t, cache_j)


def test_chunk_exits_when_every_active_slot_emitted_eos(pair):
    """With eos (slot 0's first token) the chunk stops once both slots have
    emitted it; the tokens up to there equal the chunk run without eos, the
    rest are zero, as in the JAX chunk."""
    L, Hk, D = CFG.llm.num_hidden_layers, CFG.llm.num_key_value_heads, CFG.llm.head_dim
    cur, pos, active = torch.tensor([3, 5]), torch.tensor([0, 0]), torch.ones(2, dtype=torch.bool)

    def fresh():
        return KVCache.create(L, 2, 64, Hk, D, torch.float32)

    free, *_ = serving.decode_chunk(pair["model"], fresh(), cur, pos, active, 8)
    eos = int(free[0, 0])
    toks, *_ = serving.decode_chunk(pair["model"], fresh(), cur, pos, active, 8, eos=eos)
    want, *_ = jserving.decode_chunk(
        pair["params"], CFG, jmot.KVCache.create(L, 2, 64, Hk, D, jnp.float32),
        jnp.asarray([3, 5], jnp.int32), jnp.asarray([0, 0], jnp.int32), jnp.ones(2, bool), 8,
        jax.random.PRNGKey(1), eos=jnp.asarray(eos, jnp.int32))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want))
    exit_step = next(i + 1 for i in range(8) if (free[:, : i + 1] == eos).any(dim=1).all())
    assert exit_step < 8
    assert torch.equal(toks[:, :exit_step], free[:, :exit_step])
    assert (toks[:, exit_step:] == 0).all()


@pytest.mark.parametrize("flavour", ["decode_chunk", "decode_chunk_aligned"])
def test_step_logits_with_a_chunks_options_pick_its_first_tokens(pair, flavour):
    """``_step_logits`` with the options a chunk gives its step 0 (the step
    whose logits the card's smoke holds to chat's) is that chunk's step: its
    argmax is the chunk's first token on every active slot."""
    _jfresh, cache = _prefilled(pair, False, M=64)
    cur, pos = torch.tensor([3, 5, 7], dtype=torch.int32), torch.tensor([8, 5, 3])
    active = torch.tensor([True, True, False])
    step_kw = (serving._scatter_kw(active) if flavour == "decode_chunk"
               else serving._aligned_kw(cache, active)[1])
    logits, _ = serving._step_logits(pair["model"], cache.clone(), cur, pos, **step_kw(0))
    tok, *_ = getattr(serving, flavour)(pair["model"], cache, cur, pos, active, 1)
    assert torch.equal(tok[active, 0], logits.argmax(dim=-1).to(torch.int32)[active])


def test_scatter_step_goes_through_decode_attention(pair):
    """The T = 1 per-stream step calls the decode attention (K2's plain
    version here) and not the block attention; a prefill still calls the
    latter."""
    jfresh, cache = _prefilled(pair, False)
    before_dec, before_fa = dict(dec.counts), dict(fa.counts)
    serving.decode_chunk(pair["model"], cache, torch.tensor([3, 5, 7]), torch.tensor([8, 5, 3]),
                         torch.tensor([True, True, False]), 1)
    n_layers = CFG.llm.num_hidden_layers
    assert dec.counts["plain"] - before_dec["plain"] == n_layers
    assert fa.counts == before_fa
    _prefilled(pair, False)
    assert fa.counts["plain"] - before_fa["plain"] == n_layers
    assert dec.counts["plain"] - before_dec["plain"] == n_layers


def test_positional_parameters_follow_the_jax_batcher(pair):
    """The batchers' shared parameters come in the same relative order (the
    port's ``model`` in the place of ``params, cfg``), the port's tail is
    keyword-only, and ``Request`` keeps every field of the JAX one."""
    jax_params = list(inspect.signature(jserving.ContinuousBatcher.__init__).parameters)
    port = inspect.signature(ContinuousBatcher.__init__).parameters
    positional = [n for n, p in port.items() if p.kind == p.POSITIONAL_OR_KEYWORD]
    assert positional == ["self", "model", "tokenizer", "new_token_ids", "num_slots", "capacity",
                          "chunk", "vit_transform", "seed"]
    assert positional[2:] == jax_params[3:len(positional) + 1]
    keyword = [n for n, p in port.items() if p.kind == p.KEYWORD_ONLY]
    assert keyword == ["mesh", "kv_quantized", "kv_bits", "spec_decode", "spec_k", "spec_ngram",
                       "pipeline", "gen_chunk", "gen_group", "pool_ladder", "min_pool", "graphs"]
    # graphs: the route of the port's decode chunks, which has no JAX counterpart
    assert port["graphs"].default is None
    keyword.remove("graphs")
    assert keyword == sorted(keyword, key=jax_params.index)
    assert all(n in jax_params for n in keyword)
    for name in keyword + positional[2:]:
        assert port[name].default == inspect.signature(
            jserving.ContinuousBatcher.__init__).parameters[name].default, name
    eng = ContinuousBatcher(pair["model"], None, {}, 2, 64, 8, "vit", 5)
    assert (eng.num_slots, eng.capacity, eng.chunk, eng.vit_transform, eng.seed) == (
        2, 64, 8, "vit", 5)
    with pytest.raises(TypeError):
        ContinuousBatcher(pair["model"], None, {}, 2, 64, 8, None, 5, None)
    with pytest.raises(ValueError, match="8 or 4 bits"):
        ContinuousBatcher(pair["model"], None, {}, kv_quantized=True, kv_bits=2)
    assert ContinuousBatcher(pair["model"], None, {}, kv_quantized=True,
                             kv_bits=4).cache.kv_bits == 4


def test_request_keeps_the_jax_fields():
    jf = [(f.name, f.default) for f in dataclasses.fields(jserving.Request)]
    tf = [(f.name, f.default) for f in dataclasses.fields(Request)]
    assert tf == jf


SPEC = dict(spec_decode=True, spec_k=3, spec_ngram=2)


class TestSpecBatcher:
    @pytest.mark.parametrize("requests,kw", [
        (TEXT, dict(num_slots=2, capacity=128, chunk=4)),
        (IMAGES + TEXT[3:4], SLOTS),
    ], ids=["text", "images"])
    def test_matches_jax_and_the_plain_engine(self, pair, requests, kw):
        got, eng = both(pair, requests, **SPEC, **kw)
        assert not eng.errors and eng._hist.shape == (kw["num_slots"], kw["capacity"])
        assert got == serve(pair["torch"], requests, **kw)[0]

    @pytest.mark.parametrize("kv_quantized", [False, True], ids=["fp32", "int8"])
    def test_preamble(self, pair, kv_quantized):
        reqs = [dict(prompt=p, max_new_tokens=m, prefix=0) for p, m in
                [("is there a fracture?", 6), ("describe the lungs", 9), ("any effusion?", 4)]]
        got, eng = both(pair, reqs, prefixes=[PREAMBLE], kv_quantized=kv_quantized, **SPEC,
                        **SLOTS)
        plain = serve(pair["torch"], reqs, prefixes=[PREAMBLE], kv_quantized=kv_quantized,
                      **SLOTS)[0]
        assert got == plain and not eng.errors

    def test_near_capacity(self, pair, monkeypatch):
        """Requests whose extent (kv_len + max_new_tokens + 1) meets the
        capacity: the batcher reserves no draft margin, so late verify
        windows straddle the end and the JAX scatter drops them whole, so the
        block's rows attend stale columns at their own positions. The port
        matches the JAX batcher there; on these requests both also still give
        the plain engine's answers (ROADMAP queue 3 records the stale read)."""
        reqs = [dict(prompt="q" * 39, max_new_tokens=22), dict(prompt="r" * 30, max_new_tokens=31)]
        straddled = []
        verify = bagel.verify_block

        def watched(model, cache, cur, draft, pos, live):
            past = (cache.lens + draft.shape[1] + 1 > cache.capacity) & live
            straddled.append(bool(past.any()))
            return verify(model, cache, cur, draft, pos, live)

        monkeypatch.setattr(bagel, "verify_block", watched)
        got, eng = both(pair, reqs, num_slots=2, capacity=64, chunk=4, **SPEC)
        assert not eng.errors and all(isinstance(a, str) for a in got)
        assert any(straddled)
        monkeypatch.undo()
        assert got == serve(pair["torch"], reqs, num_slots=2, capacity=64, chunk=4)[0]

    def test_pool_ladder_raises(self, pair):
        with pytest.raises(ValueError, match="pool_ladder"):
            ContinuousBatcher(pair["model"], None, {}, spec_decode=True, pool_ladder=True)
