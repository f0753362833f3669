"""The speculative decode (M9) and the kept-context decode it is exact
against, in the PyTorch port, held to the JAX package on the CPU: the same
weights (``from_jax_params``), fp32, inputs from a numpy seed.

- ``propose_drafts`` and ``_scatter_row_window`` against the JAX functions
  (random histories, ngram 1-3, rows with no match and rows at HL; the
  one-stream clamp and the several-stream drop);
- ``generate_text_ctx`` and ``generate_text_spec`` against the JAX functions
  in the regimes of tests/test_spec_decode.py (random prompts, several
  streams, eos, the planted oracle, the int8 cache, k 1 = k 7), the spec
  decode also against the port's own ``generate_text_ctx``;
- ``serving.decode_chunk_spec`` against the JAX chunk, near capacity too,
  where verify windows run past the end.

The spec batcher is held in tests/test_torch_serving.py (``TestSpecBatcher``),
the inferencer's spec ``chat``, ``chat_turn`` and ``gen_text_stream`` in
tests/test_torch_pipeline.py (``TestSpecAndKeptContext``).

Tolerances: tokens, lengths, ``n_forwards`` and lens exactly; caches within
1e-5 on each stream's [0, lens), int8 values exactly, their scales within
1e-6 relative, 2e-6 where the verify block wrote them (see ``_spec_case``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unimedvl_tpu.config import BagelConfig, LLMConfig, VAEConfig
from unimedvl_tpu.inference import serving as jserving
from unimedvl_tpu.models import bagel as jbagel
from unimedvl_tpu.models import qwen2_mot as jmot
from unimedvl_tpu_torch.inference import serving
from unimedvl_tpu_torch.models import bagel
from unimedvl_tpu_torch.models.qwen2_mot import KVCache
from unimedvl_tpu_torch.ops import flash_attention as fa
from unimedvl_tpu_torch.weights.loader import from_jax_params

from tests.test_torch_config import init_params, port_config
from tests.test_torch_serving import _to_jax, assert_caches_equal, both_ids, pair  # noqa: F401

# tests/test_spec_decode.py's config
CFG = BagelConfig(
    llm=LLMConfig(vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                  num_attention_heads=8, num_key_value_heads=4),
    vit=None, visual_und=False,
    vae=VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4, downsample=2),
    max_latent_size=8,
)
HL = 96  # history columns
CAP = 128  # cache capacity


@pytest.fixture(scope="module")
def models():
    params = init_params(0, CFG)
    model = from_jax_params(jax.tree.map(np.asarray, params), port_config(CFG), device="cpu")
    return params, model


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ngram", [1, 2, 3])
def test_propose_drafts(ngram):
    """Random histories over a small alphabet (many matches), a row without
    any match, a row whose tail is all of it, rows at HL and short rows."""
    rng = np.random.default_rng(ngram)
    S, L, K = 8, 40, 5
    hist = rng.integers(0, 4, (S, L)).astype(np.int32)
    hist[1] = np.arange(L) + 10  # all distinct: no match
    hlen = np.asarray([L, L, 17, ngram, 1, 0, 25, L - 1], np.int32)
    want = jbagel.propose_drafts(jnp.asarray(hist), jnp.asarray(hlen), ngram, K)
    got = bagel.propose_drafts(torch.from_numpy(hist), torch.from_numpy(hlen), ngram, K)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[1].numpy(), hist[1, :K])  # no match: from column 0


@pytest.mark.parametrize("S,starts", [(1, [3]), (1, [18]), (3, [0, 17, 9]), (3, [18, 2, 20])],
                         ids=["one-in", "one-clamped", "three-in", "three-dropped"])
def test_scatter_row_window(S, starts):
    """A window of 5 into rows of 22: one stream's start is clamped into the
    row (JAX's dynamic_update_slice), several streams drop a row whose
    window runs past the end (JAX's FILL_OR_DROP)."""
    rng = np.random.default_rng(S)
    buf = rng.integers(0, 50, (S, 22)).astype(np.int32)
    vals = rng.integers(100, 150, (S, 5)).astype(np.int32)
    st = np.asarray(starts, np.int32)
    want = jbagel._scatter_row_window(jnp.asarray(buf), jnp.asarray(vals), jnp.asarray(st))
    got = bagel._scatter_row_window(torch.from_numpy(buf.copy()), torch.from_numpy(vals),
                                    torch.from_numpy(st))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if S == 3 and starts[0] == 18:
        np.testing.assert_array_equal(got[0].numpy(), buf[0])  # dropped whole


# ---------------------------------------------------------------------------
# the decodes
# ---------------------------------------------------------------------------

def _prefill(params, model, prompts, quantized=False, cap=CAP):
    """Both frameworks' caches (``cap`` columns) after a prefill of each
    prompt but its last id (the start token, which the decode forwards);
    (JAX cache, port cache, start, positions, hist, hlen), the last four
    numpy."""
    S = len(prompts)
    L, Hk, D = CFG.llm.num_hidden_layers, CFG.llm.num_key_value_heads, CFG.llm.head_dim
    T = max(len(p) - 1 for p in prompts)
    ids = np.zeros((S, T), np.int32)
    pos = np.zeros((S, T), np.int32)
    valid = np.zeros((S, T), bool)
    hist = np.zeros((S, HL), np.int32)
    hlen = np.zeros((S,), np.int32)
    for s, p in enumerate(prompts):
        n = len(p) - 1
        ids[s, :n] = p[:-1]
        pos[s, :n] = np.arange(n)
        valid[s, :n] = True
        hist[s, :len(p)] = p
        hlen[s] = len(p)
    jc = jbagel.prefill_text(
        params, CFG, jmot.KVCache.create(L, S, cap, Hk, D, jnp.float32, quantized=quantized),
        jnp.asarray(ids), jnp.asarray(pos), jnp.asarray(valid))
    tc = bagel.prefill_text(
        model, KVCache.create(L, S, cap, Hk, D, torch.float32, quantized=quantized),
        torch.from_numpy(ids).long(), torch.from_numpy(pos).long(), torch.from_numpy(valid))
    start = np.asarray([p[-1] for p in prompts], np.int32)
    positions = np.asarray([len(p) - 1 for p in prompts], np.int32)
    return jc, tc, start, positions, hist, hlen


def _ctx_pair(models, prompts, max_len, eos, quantized=False):
    params, model = models
    jc, tc, start, positions, *_ = _prefill(params, model, prompts, quantized)
    want = jbagel.generate_text_ctx(params, CFG, jc, jnp.asarray(start), jnp.asarray(positions),
                                    max_len, jnp.asarray(eos, jnp.int32))
    got = bagel.generate_text_ctx(model, tc, torch.from_numpy(start), torch.from_numpy(positions),
                                  max_len, eos)
    return got, want


def _assert_decodes_equal(got, want, cache=True, **tol):
    """Tokens and lengths exactly, and the caches (``cache``) or their lens."""
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    if cache:
        assert_caches_equal(got[2], want[2], **tol)
    else:
        np.testing.assert_array_equal(got[2].lens.numpy(), np.asarray(want[2].lens))


@pytest.mark.parametrize("prompts,quantized", [
    ([[5, 17, 3, 44, 9], [7, 2], [31, 8, 8, 12]], False),
    ([[5, 17, 3, 44, 9], [7, 2, 11]], True),
], ids=["fp32", "int8"])
def test_generate_text_ctx_matches_jax(models, prompts, quantized):
    got, want = _ctx_pair(models, prompts, 9, eos=1, quantized=quantized)
    _assert_decodes_equal(got, want)
    assert (got[2].lens > 0).all()


def _spec_case(models, prompts, max_len, eos, k_draft=4, ngram=3, hist=None, hlen=None,
               quantized=False):
    """The port's spec decode against the JAX spec decode (tokens, lengths,
    cache, n_forwards) and against the JAX and the port's contiguous decode
    (tokens, lengths, cache). Over an int8 cache the spec decode's cache is
    held to the JAX spec decode's with the scales within 2e-6 relative (one
    layer-1 k scale reads 1.13e-6: eleven fp32 ulps of its absmax, from the
    sums' order in the two frameworks), and to the contiguous decodes by
    tokens, lengths and lens, as tests/test_spec_decode.py holds it: their k
    and v come from a T = k + 1 block and T = 1 steps, whose fp32 sums can
    round an int8 step apart. Returns (tokens, lengths, n_forwards)."""
    params, model = models
    jc, tc, start, positions, hist0, hlen0 = _prefill(params, model, prompts, quantized)
    hist = hist0 if hist is None else hist
    hlen = hlen0 if hlen is None else hlen
    jeos = jnp.asarray(eos, jnp.int32)
    want = jbagel.generate_text_spec(
        params, CFG, jc, jnp.asarray(start), jnp.asarray(positions), max_len, jeos,
        jnp.asarray(hist), jnp.asarray(hlen), k_draft=k_draft, ngram=ngram)
    want_ctx = jbagel.generate_text_ctx(params, CFG, jc, jnp.asarray(start),
                                        jnp.asarray(positions), max_len, jeos)
    hist_t = torch.from_numpy(hist.copy())
    got = bagel.generate_text_spec(
        model, tc.clone(), torch.from_numpy(start), torch.from_numpy(positions), max_len, eos,
        hist_t, torch.from_numpy(hlen), k_draft=k_draft, ngram=ngram)
    np.testing.assert_array_equal(hist_t.numpy(), hist)  # the caller's history is kept
    _assert_decodes_equal(got[:3], want[:3], **(dict(scale_rtol=2e-6) if quantized else {}))
    assert got[3] == int(want[3])
    _assert_decodes_equal(got[:3], want_ctx, cache=not quantized)
    port_ctx = bagel.generate_text_ctx(model, tc, torch.from_numpy(start),
                                       torch.from_numpy(positions), max_len, eos)
    _assert_decodes_equal(got[:3], [np.asarray(port_ctx[0]), np.asarray(port_ctx[1]),
                                    _to_jax(port_ctx[2])], cache=not quantized)
    return got[0].numpy(), got[1].numpy(), got[3]


class TestGenerateTextSpec:
    def test_random_prompt(self, models):
        _spec_case(models, [[5, 17, 3, 44, 9]], 10, eos=1)

    def test_several_streams(self, models):
        """Streams drain at different rates: each freezes on its own."""
        _spec_case(models, [[5, 17, 3, 44, 9], [7, 2], [31, 8, 8, 12]], 8, eos=1)

    def test_eos(self, models):
        out, _, _ = _spec_case(models, [[5, 17, 3, 44, 9]], 12, eos=1)
        ids = out[0][out[0] >= 0]
        assert len(ids) > 3
        _spec_case(models, [[5, 17, 3, 44, 9]], 12, eos=int(ids[2]))  # stops mid-way
        _spec_case(models, [[5, 17, 3, 44, 9], [7, 2, 11]], 12, eos=int(ids[1]))

    def test_planted_oracle_accepts_several_a_forward(self, models):
        """The true continuation planted in the history: every draft matches,
        so the loop takes about len / (k + 1) forwards, the output exact."""
        params, model = models
        prompt = [5, 17, 3, 44, 9]
        got, _ = _ctx_pair(models, [prompt], 12, eos=1)
        cont = got[0][0].numpy()
        cont = cont[cont >= 0][1:]
        seq = prompt[-3:] + cont.tolist() + prompt
        hist = np.zeros((1, HL), np.int32)
        hist[0, :len(seq)] = seq
        _, lengths, n_fwd = _spec_case(models, [prompt], 12, eos=1, hist=hist,
                                       hlen=np.asarray([len(seq)], np.int32))
        assert n_fwd < int(lengths[0]) and n_fwd <= -(-int(lengths[0]) // 5) + 2

    def test_int8_cache(self, models):
        _spec_case(models, [[5, 17, 3, 44, 9], [7, 2, 11]], 8, eos=1, k_draft=3, quantized=True)

    def test_k1_equals_k7(self, models):
        a = _spec_case(models, [[9, 9, 2, 9, 9]], 9, eos=1, k_draft=1)
        b = _spec_case(models, [[9, 9, 2, 9, 9]], 9, eos=1, k_draft=7)
        np.testing.assert_array_equal(a[0], b[0])

    def test_verify_block_goes_through_block_attention(self, models):
        """The verify forward of k + 1 rows takes K1a (its plain version
        here) in every layer, the fix-up forward the decode attention."""
        before = dict(fa.counts)
        _, lengths, n_fwd = _spec_case(models, [[5, 17, 3, 44, 9]], 6, eos=1)
        # the JAX side runs no port code; the port ran the spec decode, its
        # own contiguous decode for the comparison, and the prefill
        n_layers = CFG.llm.num_hidden_layers
        assert fa.counts["plain"] - before["plain"] == (n_fwd + 1) * n_layers


# ---------------------------------------------------------------------------
# the speculative chunk and the batcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("case", ["roomy", "budgets", "near-capacity"])
def test_decode_chunk_spec_matches_jax(models, quantized, case):
    """Three slots of mixed lengths, one inactive in "roomy"; in "budgets" a
    slot with budget 0, one with 3; "near-capacity" leaves a capacity at
    which the verify windows of two slots run past the end (dropped whole,
    as the JAX scatter drops them). Then a plain chunk forwards the pending
    token, as a mixed schedule would."""
    params, model = models
    prompts = [[5, 17, 3, 44, 9, 5, 17, 3], [7, 2, 11], [31, 8, 8, 12, 31, 8]]
    # near capacity: 13 columns, 6 past the longest prefill
    jc, tc, start, positions, hist, hlen = _prefill(
        params, model, prompts, quantized, cap=13 if case == "near-capacity" else CAP)
    active = np.asarray([True, case != "roomy", True])
    budget = np.asarray([0, 3, 20] if case == "budgets" else [20] * 3, np.int32)
    n_iters, eos = 4, 1
    want = jserving.decode_chunk_spec(
        params, CFG, jc, jnp.asarray(start), jnp.asarray(positions), jnp.asarray(active),
        jnp.asarray(budget), jnp.asarray(hist), jnp.asarray(hlen), n_iters,
        jnp.asarray(eos, jnp.int32), k_draft=3, ngram=2)
    got = serving.decode_chunk_spec(
        model, tc, torch.from_numpy(start), torch.from_numpy(positions).long(),
        torch.from_numpy(active), torch.from_numpy(budget), torch.from_numpy(hist.copy()),
        torch.from_numpy(hlen), n_iters, eos, k_draft=3, ngram=2)
    tokens, counts, fin, last, pos, cache, hist_t, hlen_t = got
    act = active
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want[1]))
    for a, w in ((tokens, want[0]), (fin, want[2]), (last, want[3]), (hist_t, want[6])):
        np.testing.assert_array_equal(a.numpy()[act], np.asarray(w)[act])
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want[4]))
    np.testing.assert_array_equal(hlen_t.numpy(), np.asarray(want[7]))
    rows = np.nonzero(act)[0]
    tol = dict(scale_rtol=2e-6) if quantized else {}  # see _spec_case
    assert_caches_equal(cache, want[5], rows=rows, **tol)
    # the pending token through a plain chunk of either framework
    t2 = serving.decode_chunk(model, cache, last, pos, torch.from_numpy(active), 2)
    w2 = jserving.decode_chunk(params, CFG, want[5], want[3], want[4], jnp.asarray(active), 2,
                               jax.random.PRNGKey(0))
    np.testing.assert_array_equal(t2[0].numpy()[act], np.asarray(w2[0])[act])
    assert_caches_equal(t2[3], w2[3], rows=rows, **tol)


def test_one_stream_spec_batcher_to_capacity(pair, monkeypatch):
    """A ``num_slots=1`` spec batcher (3 drafts a forward) whose request is
    planned to the capacity (kv_len 22 + 41 + 1 = 64): the JAX batcher plans
    no draft margin, so the last verify windows straddle the end, and one
    stream's window is clamped back into [0, M - T] as the JAX package's
    ``dynamic_update_slice`` places it. The ids equal the JAX batcher's token
    for token. Before the S = 1 repair the write past M raised (IndexError on
    the CPU, a device-side assert on the card)."""
    straddled = []
    verify = bagel.verify_block

    def watched(model, cache, cur, draft, pos, live):
        straddled.append(bool(((cache.lens + draft.shape[1] + 1 > cache.capacity) & live).any()))
        return verify(model, cache, cur, draft, pos, live)

    monkeypatch.setattr(bagel, "verify_block", watched)
    got, eng = both_ids(pair, [dict(prompt="q" * 20, max_new_tokens=41)], num_slots=1,
                        capacity=64, chunk=4, spec_decode=True, spec_k=3, spec_ngram=2)
    assert len(got[0]) == 41 and any(straddled)
