"""The int4 KV cache of the PyTorch port against the JAX package's
``KVCache(kv_bits=4)``, on the CPU: tests/test_pipeline.py's TINY config (head
dim 8), the same fp32 weights (``from_jax_params``).

torch has no int4 dtype: the port packs two values a byte along D
(``qwen2_mot.pack_int4``: element 2j in the low nibble) where XLA holds an
int4 array. The JAX values are read back as int8
(``np.asarray(...).astype(np.int8)``) and compared with the port's unpacked
values: EQUAL, and the scales within 1e-6 relative, as the int8 cache's in
tests/test_torch_serving.py (the k and v they are taken from are fp32 sums
in another order: 3.9e-7 seen). Decoded tokens equal the
JAX package's through ``generate_text``, ``generate_text_ctx``, the batcher's
aligned, scatter and speculative chunks, and one slot planned to its
capacity (the one-stream start clamp on packed arrays); the pool moves and
the prefix cache carry packed arrays unchanged.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unimedvl_tpu.inference import serving as jserving
from unimedvl_tpu.models import bagel as jbagel
from unimedvl_tpu.models import qwen2_mot as jmot
from unimedvl_tpu_torch.inference import serving
from unimedvl_tpu_torch.models import bagel, qwen2_mot
from unimedvl_tpu_torch.models.qwen2_mot import KVCache, pack_int4, unpack_int4
from unimedvl_tpu_torch.ops import decode_attention as dec

from tests.test_pipeline import TINY as CFG
from tests.test_torch_config import init_params
from tests.test_torch_serving import (
    IMAGES, PREAMBLE, SLOTS, TEXT, both, both_ids, make_pair, serve,
)

L, HK, D = CFG.llm.num_hidden_layers, CFG.llm.num_key_value_heads, CFG.llm.head_dim
INT4 = dict(kv_quantized=True, kv_bits=4)
SCALE_RTOL = 1e-6


@pytest.fixture(scope="module")
def pair():
    """test_torch_serving.py's pair over the tree the training, eval and
    recipe modules draw (one draw a process, ~20 s)."""
    return make_pair(init_params(0, CFG, llm2vae_zero=False))


def _to_torch(c) -> KVCache:
    """A JAX int4 cache as the port's packed one."""
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    p = lambda a: pack_int4(torch.from_numpy(np.asarray(a).astype(np.int8)))  # noqa: E731
    return KVCache(k=p(c.k), v=p(c.v), lens=t(c.lens), k_scale=t(c.k_scale),
                   v_scale=t(c.v_scale), kv_bits=4)


def _to_jax(c: KVCache):
    """The port's packed cache as a JAX int4 one."""
    q = lambda t: jnp.asarray(unpack_int4(t).numpy()).astype(jnp.int4)  # noqa: E731
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    return jmot.KVCache(k=q(c.k), v=q(c.v), lens=j(c.lens), k_scale=j(c.k_scale),
                        v_scale=j(c.v_scale))


def assert_int4_equal(got: KVCache, want, rows=None, valid_only=True, scale_rtol=SCALE_RTOL):
    """Per row, the columns [0, lens) (or all): unpacked values equal to the
    JAX int4 values, scales within ``scale_rtol``; lens exactly."""
    assert got.kv_bits == 4 and got.k.shape[-1] == D // 2
    lens = torch.from_numpy(np.array(want.lens))
    assert torch.equal(got.lens.to(lens.dtype), lens), (got.lens, lens)
    for s in range(lens.shape[0]) if rows is None else rows:
        n = int(lens[s]) if valid_only else got.capacity
        for name in ("k", "v"):
            a = unpack_int4(getattr(got, name)[:, s, :, :n])
            w = torch.from_numpy(np.asarray(getattr(want, name)).astype(np.int8)[:, s, :, :n])
            assert torch.equal(a, w), name
        for name in ("k_scale", "v_scale"):
            a = getattr(got, name)[:, s, :, :n]
            w = torch.from_numpy(np.array(getattr(want, name))[:, s, :, :n])
            torch.testing.assert_close(a, w, rtol=scale_rtol, atol=0)


def _prefilled(pair, S=3, M=64):
    """A pool of int4 caches after a text prefill of lengths 8, 5, 3 in
    both frameworks: (a function giving a fresh JAX one, the port's)."""
    ids = np.arange(S * 8).reshape(S, 8) % CFG.llm.vocab_size
    pos8 = np.broadcast_to(np.arange(8), (S, 8))
    valid = np.asarray([[True] * 8, [True] * 5 + [False] * 3, [True] * 3 + [False] * 5])[:S]

    def jfresh():
        c = jmot.KVCache.create(L, S, M, HK, D, jnp.float32, quantized=True, kv_bits=4)
        return jbagel.prefill_text(pair["params"], CFG, c, jnp.asarray(ids, jnp.int32),
                                   jnp.asarray(pos8, jnp.int32), jnp.asarray(valid))

    c = KVCache.create(L, S, M, HK, D, torch.float32, quantized=True, kv_bits=4)
    tc = bagel.prefill_text(pair["model"], c, torch.from_numpy(ids),
                            torch.from_numpy(pos8.copy()), torch.from_numpy(valid))
    return jfresh, tc


# ---------------------------------------------------------------------------
# storage
# ---------------------------------------------------------------------------

def test_pack_layout_and_round_trip():
    """Every pair of values in [-7, 7] round-trips; the even index is the low
    nibble, two's complement."""
    v = torch.arange(-7, 8, dtype=torch.int8)
    q = torch.stack(torch.meshgrid(v, v, indexing="ij"), dim=-1).reshape(-1, 2)
    p = pack_int4(q)
    assert p.shape == (225, 1) and p.dtype == torch.int8
    assert torch.equal(unpack_int4(p), q)
    assert (p[:, 0].to(torch.int32) & 0xF).tolist() == (q[:, 0].to(torch.int32) & 0xF).tolist()
    assert pack_int4(torch.tensor([[-1, 1]], dtype=torch.int8)).item() == 0x1F


def test_quantize_kv_block_equals_jax():
    rng = np.random.default_rng(17)
    b = rng.standard_normal((2, 5, 2, 16)).astype(np.float32) * 3
    b[0, 1, 1] = 0.0
    wq, ws = jmot._quantize_kv_block(jnp.asarray(b), jnp.int4)
    q, s = qwen2_mot._quantize_kv_block(torch.from_numpy(b), bits=4)
    assert q.shape == (2, 5, 2, 8)
    assert torch.equal(unpack_int4(q), torch.from_numpy(np.asarray(wq).astype(np.int8)))
    assert torch.equal(s, torch.from_numpy(np.array(ws)))
    want = jmot.dequant_slice(wq, ws, jnp.float32)
    np.testing.assert_array_equal(qwen2_mot.dequant_slice(q, s, torch.float32, 4).numpy(),
                                  np.asarray(want))


def test_cache_moves_carry_packed_arrays():
    c = KVCache.create(2, 3, 8, 2, 4, torch.float32, quantized=True, kv_bits=4)
    c.k.random_(-128, 128)
    for moved in (c.clone(), c.padded(5), c.streams(2), KVCache.stack([c, c.streams(1)])):
        assert moved.kv_bits == 4 and moved.k.shape[-1] == 2
        n = moved.k.shape[1]
        assert torch.equal(moved.k[:, :, :, :8], torch.cat([c.k, c.k], dim=1)[:, :n])
    with pytest.raises(ValueError, match="int8 and int4"):
        KVCache.stack([c, KVCache.create(2, 3, 8, 2, 4, torch.float32, quantized=True)])
    with pytest.raises(ValueError, match="odd"):
        KVCache.create(1, 1, 8, 1, 5, quantized=True, kv_bits=4)


# ---------------------------------------------------------------------------
# prefill and the decodes
# ---------------------------------------------------------------------------

def test_prefill_values_equal_jax(pair):
    jfresh, tc = _prefilled(pair)
    assert_int4_equal(tc, jfresh())


def test_generate_text_matches_jax(pair):
    """The aligned-column decode over an int4 cache: each step's kv written
    at base + d, every step through K2-int8's plain version on the unpacked
    slice (the JAX package's int4 decode multiplies q by the int4 values and
    the scale, as K2-int8 does)."""
    jfresh, tc = _prefilled(pair)
    start, rope = [3, 5, 7], [8, 5, 3]
    want, want_len = jbagel.generate_text(
        pair["params"], CFG, jfresh(), jnp.asarray(start, jnp.int32),
        jnp.asarray(rope, jnp.int32), 10, jnp.asarray(-1, jnp.int32), False, 1.0,
        jax.random.PRNGKey(1))
    before = dict(dec.int8_counts), dict(dec.counts)
    got, got_len = bagel.generate_text(pair["model"], tc, torch.tensor(start),
                                       torch.tensor(rope), 10, -1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert dec.int8_counts["plain"] - before[0]["plain"] == 10 * L  # every step, every layer
    assert dec.counts == before[1]


def test_generate_text_ctx_matches_jax(pair):
    """The contiguous decode: the tokens, and the cache it keeps, equal."""
    jfresh, tc = _prefilled(pair)
    start, rope = [3, 5, 7], [8, 5, 3]
    want = jbagel.generate_text_ctx(pair["params"], CFG, jfresh(), jnp.asarray(start, jnp.int32),
                                    jnp.asarray(rope, jnp.int32), 9, jnp.asarray(-1, jnp.int32))
    got = bagel.generate_text_ctx(pair["model"], tc, torch.tensor(start), torch.tensor(rope),
                                  9, -1)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    # the decoded rows' scales come from hidden states that went through the
    # int4 attention of earlier steps: 1.1e-6 seen, 2e-6 as the int8 verify
    # path's in tests/test_torch_spec.py
    assert_int4_equal(got[2], want[2], scale_rtol=2e-6)


@pytest.mark.parametrize("flavour", ["decode_chunk", "decode_chunk_aligned"])
def test_chunk_matches_jax(pair, flavour):
    """The serving chunks over an int4 pool, one inactive slot: tokens,
    positions and each live stream's cache."""
    jfresh, cache = _prefilled(pair)
    cur, pos, active = [3, 5, 7], [8, 5, 3], [True, True, False]
    tok_j, last_j, pos_j, cache_j = getattr(jserving, flavour)(
        pair["params"], CFG, jfresh(), jnp.asarray(cur, jnp.int32), jnp.asarray(pos, jnp.int32),
        jnp.asarray(active), 5, jax.random.PRNGKey(2))
    tok, last, pos_t, cache_t = getattr(serving, flavour)(
        pair["model"], cache, torch.tensor(cur), torch.tensor(pos), torch.tensor(active), 5)
    act = np.asarray(active)
    np.testing.assert_array_equal(tok.numpy()[act], np.asarray(tok_j)[act])
    np.testing.assert_array_equal(last.numpy()[act], np.asarray(last_j)[act])
    np.testing.assert_array_equal(pos_t.numpy(), np.asarray(pos_j))
    assert_int4_equal(cache_t, cache_j)


def test_spec_chunk_matches_jax(pair):
    """The speculative chunk (verify blocks of T = 4 through the dequantized
    slice) over an int4 pool."""
    jfresh, cache = _prefilled(pair)
    hist = np.zeros((3, 64), np.int32)
    hist[:, :4] = [[3, 9, 3, 9], [5, 5, 5, 5], [7, 1, 2, 7]]
    hlen = np.asarray([4, 4, 4], np.int32)
    args = ([3, 5, 7], [8, 5, 3], [True, True, True], [12, 12, 12])
    want = jserving.decode_chunk_spec(
        pair["params"], CFG, jfresh(), *(jnp.asarray(a) for a in args), jnp.asarray(hist),
        jnp.asarray(hlen), 3, jnp.asarray(-1, jnp.int32), k_draft=3, ngram=2)
    got = serving.decode_chunk_spec(
        pair["model"], cache, torch.tensor(args[0]), torch.tensor(args[1]),
        torch.tensor(args[2]), torch.tensor(args[3], dtype=torch.int32),
        torch.from_numpy(hist.copy()), torch.from_numpy(hlen), 3, -1, k_draft=3, ngram=2)
    for i in (0, 1, 2, 3, 4, 6, 7):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    assert_int4_equal(got[5], want[5])


# ---------------------------------------------------------------------------
# the batcher over an int4 pool
# ---------------------------------------------------------------------------

class TestInt4Pool:
    def test_matches_jax(self, pair):
        """Text and image requests (grouped ViT admission into int4 blocks),
        the aligned chunks."""
        got, eng = both(pair, TEXT[:3] + IMAGES[:2], **INT4, **SLOTS)
        assert not eng.errors and eng.cache.kv_bits == 4
        assert eng.cache.k.shape[-1] == D // 2

    def test_scatter_chunk_near_capacity(self, pair, monkeypatch):
        calls = []
        fn = serving.decode_chunk
        monkeypatch.setattr(serving, "decode_chunk",
                            lambda *a, **k: (calls.append(1), fn(*a, **k))[1])
        got, eng = both(pair, [dict(prompt="q" * 39, max_new_tokens=22)], num_slots=2,
                        capacity=64, chunk=8, **INT4)
        assert not eng.errors and calls

    def test_spec_batcher(self, pair):
        got, eng = both(pair, TEXT[:3], num_slots=2, capacity=128, chunk=4, spec_decode=True,
                        spec_k=3, spec_ngram=2, **INT4)
        assert not eng.errors

    def test_one_stream_planned_to_capacity(self, pair):
        """``num_slots=1``, a request whose extent meets the capacity: the
        last chunk's writes past the end clamp back over the last columns,
        on packed values and scales alike, as the JAX package's
        ``dynamic_update_slice`` places them."""
        got, _ = both_ids(pair, [dict(prompt="q" * 20, max_new_tokens=42)], num_slots=1,
                          capacity=65, chunk=4, **INT4)
        assert len(got[0]) == 42

    def test_prefix_cache(self, pair):
        prefixed = [dict(prompt=r["prompt"], max_new_tokens=r["max_new_tokens"], prefix=0)
                    for r in TEXT[:3]]
        got, eng = both(pair, prefixed, prefixes=[PREAMBLE], **INT4, **SLOTS)
        assert not eng.errors and eng._prefixes[0][0].kv_bits == 4

    def test_ladder(self, pair):
        fixed = serve(pair["torch"], TEXT, num_slots=4, capacity=128, chunk=4, **INT4)[0]
        got, eng = both(pair, TEXT, num_slots=4, capacity=128, chunk=4, pool_ladder=True,
                        min_pool=2, **INT4)
        assert got == fixed and eng.cache.kv_bits == 4


def _random_cache(seed, S, M, lens):
    rng = np.random.default_rng(seed)
    shape = (L, S, HK, M, D)
    k, v = (pack_int4(torch.from_numpy(rng.integers(-7, 8, shape, dtype=np.int8))) for _ in "kv")
    ks, vs = (torch.from_numpy(rng.random(shape[:-1], dtype=np.float32)) for _ in "kv")
    return KVCache(k=k, v=v, lens=torch.tensor(lens, dtype=torch.int32), k_scale=ks, v_scale=vs,
                   kv_bits=4)


def test_group_store():
    pool = _random_cache(0, 4, 16, [3, 7, 0, 11])
    block = _random_cache(1, 3, 10, [5, 9, 2])
    slots = np.asarray([2, 4, 0])  # row 1 is padding (>= S)
    want = jserving.group_store(_to_jax(pool), _to_jax(block), jnp.asarray(slots))
    got = serving.group_store(pool.clone(), block, slots)
    assert_int4_equal(got, want, valid_only=False, scale_rtol=0)


@pytest.mark.parametrize("perm", [[2, 0], [1, 3, -1, -1, 0, -1, -1, -1]], ids=["shrink", "grow"])
def test_repack_pool(perm):
    pool = _random_cache(2, 4, 8, [3, 7, 0, 5])
    want = jserving.repack_pool(_to_jax(pool), jnp.asarray(perm, jnp.int32))
    got = serving.repack_pool(pool, np.asarray(perm))
    assert got.k.shape[1] == len(perm)
    assert_int4_equal(got, want, valid_only=False, scale_rtol=0)


def test_seed_prefix_block():
    block = _random_cache(3, 3, 24, [0, 0, 0])
    prefix = _random_cache(4, 1, 8, [6])
    want = jserving.seed_prefix_block(_to_jax(block), _to_jax(prefix), jnp.asarray(6, jnp.int32))
    got = serving.seed_prefix_block(block.clone(), prefix, 6)
    assert_int4_equal(got, want, valid_only=False, scale_rtol=0)


def test_round_trip_through_the_jax_layout():
    c = _random_cache(5, 2, 8, [4, 6])
    back = _to_torch(_to_jax(c))
    for f in dataclasses.fields(KVCache):
        a, b = getattr(c, f.name), getattr(back, f.name)
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b
