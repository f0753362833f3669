"""The port's device programs (unimedvl_tpu_torch/inference/programs.py) on
the CPU: tests/test_pipeline.py's TINY config, fp32, weights drawn with numpy
into the JAX tree's structure (``jax.eval_shape`` of its ``init_params``, no
compile) and loaded into both frameworks.

On a CPU tensor a program's replay calls its step body on its static
buffers: that plain route must equal the eager loop bit for bit (tokens,
lengths, positions, lens, steps run, verify forwards, histories, cache
arrays, latents; a program that copies the columns it made valid back into
its caller's cache is held to the eager loop's on [0, lens)), and the JAX
program on the same inputs (one JAX program each: ``generate_text`` greedy
and sampled, ``generate_text_ctx``, ``generate_text_spec``,
``decode_chunk``, ``decode_chunk_aligned``, ``decode_chunk_spec``,
``generate_latents_group``; tokens exactly, caches as
tests/test_torch_serving.py's ``assert_caches_equal``, latents within 1e-5
as tests/test_torch_gen_serving.py holds the eager loop). A sampled program
draws what the eager loop draws from one generator state; against JAX, the
JAX loop's Gumbel draws g are replayed as the exponential draws exp(-g). The
decodes run in the float mode, full-int8 fused over an int8 cache, w4a8 over
an int4 cache; the chunks exit early mid-chunk and run their remaining
replays past the exit, which change nothing the caller reads; the flow loop
runs over two ``step_range`` segments; ``gen_text_stream`` runs both kinds
of chunk. A program's key is dropped by ``quantize_llm_params`` and by
``repack_pool``; the programs keyed by a cache's shape survive
``_ensure_capacity``. The prefill programs (``bagel.PrefillProgram``: the
text, ViT and VAE context builds with the VAE encode, the batcher's image
and text admission blocks) are held to their eager functions bit for bit
and to the JAX jitted functions in the three modes; one ViT program serves
two images of a bucket, a VAE program's <vision_end> row moves within one,
an image group of three is padded to four, and the inferencer's and the
batcher's answers are those of the eager prefills. The captured route
(CUDA graphs) is held to the eager one in tests/test_torch_kernels_cuda.py,
on the card.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unimedvl_tpu import quant as jquant
from unimedvl_tpu.inference import serving as jserving
from unimedvl_tpu.models import bagel as jbagel
from unimedvl_tpu.models import qwen2_mot as jmot
from unimedvl_tpu_torch import quant
from unimedvl_tpu_torch.inference import programs, serving
from unimedvl_tpu_torch.models import bagel
from unimedvl_tpu_torch.models.qwen2_mot import KVCache
from unimedvl_tpu_torch.models.qwen2_mot import _mot_rows as mot_rows
from unimedvl_tpu_torch.weights.loader import from_jax_params

from tests.test_pipeline import TINY as CFG
from tests.test_torch_config import port_config
from tests.test_torch_kv4 import _to_jax as _to_jax4, assert_int4_equal
from tests.test_torch_serving import _to_jax, assert_caches_equal

L, Hk, D = CFG.llm.num_hidden_layers, CFG.llm.num_key_value_heads, CFG.llm.head_dim
V = CFG.llm.vocab_size


def numpy_params(seed: int = 0):
    """A JAX parameter tree of CFG with numpy draws: norm scales near 1,
    everything else N(0, 0.2)."""
    shapes = jax.eval_shape(
        lambda: jbagel.init_params(jax.random.PRNGKey(0), CFG, llm2vae_zero=False))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path).lower()
        x = rng.standard_normal(leaf.shape).astype(leaf.dtype)
        return 1.0 + 0.1 * x if "norm" in name and name.endswith("['scale']") else 0.2 * x

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def setup():
    params = numpy_params()
    model = from_jax_params(params, port_config(CFG), device="cpu")
    return dict(params=jax.tree.map(jnp.asarray, params), model=model)


def _modes(model):
    """mode -> (model, KVCache.create options): the float mode, full-int8
    fused over an int8 cache, w4a8 over an int4 cache."""
    int8 = copy.deepcopy(model)
    quant.quantize_llm_params(int8.language_model, act_quant=True, bits=8)
    quant.fuse_serving_projections(int8.language_model)
    w4a8 = copy.deepcopy(model)
    quant.quantize_llm_params(w4a8.language_model, act_quant=True, bits=4)
    return {"float": (model, {}), "int8": (int8, dict(quantized=True)),
            "w4a8-int4kv": (w4a8, dict(quantized=True, kv_bits=4))}


@pytest.fixture(scope="module")
def modes(setup):
    return _modes(setup["model"])


def _prefilled(model, S=2, M=48, lens=(9, 6), **kw):
    """A text prefill of mixed lengths, [S, M] capacity."""
    ids = (np.arange(S * 12).reshape(S, 12) * 7 + 3) % V
    pos = np.broadcast_to(np.arange(12), (S, 12)).copy()
    valid = np.arange(12)[None] < np.asarray(lens)[:, None]
    c = KVCache.create(L, S, M, Hk, D, torch.float32, **kw)
    return bagel.prefill_text(model, c, torch.from_numpy(ids), torch.from_numpy(pos),
                              torch.from_numpy(valid))


def _arrays(c: KVCache):
    return [t for t in (c.k, c.v, c.k_scale, c.v_scale, c.lens) if t is not None]


def _assert_same_cache(a: KVCache, b: KVCache, valid_only: bool = False, rows=None):
    """Equal arrays, or with ``valid_only`` equal lens and the columns
    [0, lens) of each stream (of ``rows``, a mask, where given)."""
    if not valid_only:
        for x, y in zip(_arrays(a), _arrays(b)):
            assert torch.equal(x, y)
        return
    assert torch.equal(a.lens, b.lens)
    for s, n in enumerate(a.lens.tolist()):
        if rows is not None and not rows[s]:
            continue
        for x, y in zip(_arrays(a)[:-1], _arrays(b)[:-1]):
            assert torch.equal(x[:, s, :, :n], y[:, s, :, :n])


# ---------------------------------------------------------------------------
# (a) the chat decode
# ---------------------------------------------------------------------------

def _decode(model, cache, max_length, eos, graphs):
    start, pos = torch.tensor([5, 9]), torch.tensor([9, 6])
    return bagel.generate_text(model, cache, start, pos, max_length, eos, graphs=graphs)


@pytest.mark.parametrize("mode", ["float", "int8", "w4a8-int4kv"])
def test_decode_program_equals_the_eager_loop(modes, mode):
    """Tokens and lengths bit for bit, with an eos that ends one stream early
    and another that ends the loop before max_length; the caller's cache is
    left as it was by the program."""
    model, kw = modes[mode]
    cache = _prefilled(model, **kw)
    free, _ = _decode(model, cache.clone(), 10, -1, False)
    common = [int(t) for t in free[0, 1:] if (free[1, 1:] == t).any()]
    ends = [-1, int(free[1, 3])] + common[:1]  # no eos, one stream's, both streams'
    for e in ends:
        want = _decode(model, cache.clone(), 10, e, False)
        before = cache.clone()
        got = _decode(model, cache, 10, e, True)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        _assert_same_cache(cache, before)
    assert (want[1] < 10).any()


def test_decode_program_matches_jax(setup):
    model = setup["model"]
    cache = _prefilled(model)
    free, _ = _decode(model, cache.clone(), 8, -1, False)
    eos = int(free[0, 2])
    got, lengths = _decode(model, cache, 8, eos, True)
    want, jlen = jbagel.generate_text(
        setup["params"], CFG, _to_jax(cache), jnp.asarray([5, 9], jnp.int32),
        jnp.asarray([9, 6], jnp.int32), 8, jnp.asarray(eos, jnp.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(jlen))


def test_decode_replays_past_the_exit_change_nothing(setup):
    """After the loop ended on eos, more replays leave the state the caller
    reads (tokens, positions, flags, step) as it was."""
    model = setup["model"]
    cache = _prefilled(model)
    free, _ = _decode(model, cache.clone(), 8, -1, False)
    eos = int(free[0, 1])
    prog = bagel.DecodeProgram.get(model, cache, 2, 8, eos)
    _decode(model, cache, 8, eos, True)
    state = [t.clone() for t in (prog.out, prog.cur, prog.pos, prog.done, prog.step, prog.go)]
    assert not bool(prog.go)
    for _ in range(3):
        prog.graph.replay()
    for a, b in zip(state, (prog.out, prog.cur, prog.pos, prog.done, prog.step, prog.go)):
        assert torch.equal(a, b)


def test_sampled_decode_is_eager_by_design(modes):
    """Sampled decoding was eager by design while a captured
    ``torch.multinomial`` could not be; it now runs as its program: in every
    mode, from one generator state, the program's tokens are the eager
    loop's and the generator ends in the same state."""
    for model, kw in modes.values():
        cache = _prefilled(model, **kw)
        got = []
        for graphs in (False, True):
            g = torch.Generator().manual_seed(11)
            out = bagel.generate_text(model, cache, torch.tensor([5, 9]), torch.tensor([9, 6]), 8,
                                      -1, do_sample=True, temperature=0.7, generator=g,
                                      graphs=graphs)
            got.append((out, g.get_state()))
        (want, want_state), (tokens, state) = got
        for a, b in zip(tokens, want):
            assert torch.equal(a, b)
        assert torch.equal(state, want_state)


def test_sampling_draw_is_multinomials():
    """The capturable draw gives ``torch.multinomial``'s sample for the same
    generator state and leaves the generator where it does."""
    logits = torch.from_numpy(np.random.default_rng(4).standard_normal((3, V), np.float32) * 3)
    for seed in range(8):
        a, b = torch.Generator().manual_seed(seed), torch.Generator().manual_seed(seed)
        want = torch.multinomial(torch.softmax(logits / 0.8, dim=-1), 1, generator=a)[:, 0]
        assert torch.equal(bagel._next_token(logits, True, 0.8, b), want.to(torch.int32))
        assert torch.equal(a.get_state(), b.get_state())


SAMPLED = ["generate_text_ctx", "decode_chunk", "decode_chunk_aligned"]


@pytest.mark.parametrize("fn", SAMPLED)
def test_sampled_programs_equal_the_eager_loops(setup, fn):
    """The kept-context decode and both chunk flavours, sampled from one
    generator state: tokens and lens bit for bit by either route."""
    model = setup["model"]
    got = []
    for graphs in (False, True):
        g = torch.Generator().manual_seed(5)
        if fn == "generate_text_ctx":
            out = bagel.generate_text_ctx(model, _prefilled(model), torch.tensor([5, 9]),
                                          torch.tensor([9, 6]), 8, -1, True, 1.3, g, graphs=graphs)
        else:
            cache = _prefilled(model, S=3, M=40, lens=(9, 6, 11))
            out = getattr(serving, fn)(model, cache, *_chunk_args(MASKS[0]), 6, do_sample=True,
                                       temperature=1.3, generator=g, graphs=graphs)
        got.append(out)
    for a, b in zip(got[0][:2], got[1][:2]):
        assert torch.equal(a, b)
    assert torch.equal(got[0][-1].lens, got[1][-1].lens)


def test_sampled_decode_program_matches_jax(setup, monkeypatch):
    """The JAX loop's Gumbel draws g replayed as the port's exponential draws
    q = exp(-g): argmax(probs / q) is argmax(logits / T + g), the JAX
    categorical draw, so the tokens are the JAX program's."""
    model, S, T, steps = setup["model"], 2, 0.9, 8
    cache = _prefilled(model)
    rng, gumbels = jax.random.PRNGKey(3), []
    for _ in range(steps):
        rng, sub = jax.random.split(rng)
        gumbels.append(torch.from_numpy(np.array(jax.random.gumbel(sub, (S, V), jnp.float32))))
    draws = iter(gumbels)
    monkeypatch.setattr(bagel, "_exp_noise", lambda like, generator: torch.exp(-next(draws)))
    got, lengths = bagel.generate_text(model, cache, torch.tensor([5, 9]), torch.tensor([9, 6]),
                                       steps, -1, do_sample=True, temperature=T, graphs=True)
    want, jlen = jbagel.generate_text(
        setup["params"], CFG, _to_jax(cache), jnp.asarray([5, 9], jnp.int32),
        jnp.asarray([9, 6], jnp.int32), steps, jnp.asarray(-1, jnp.int32), do_sample=True,
        temperature=T, rng=jax.random.PRNGKey(3))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(jlen))


# ---------------------------------------------------------------------------
# (a') the kept-context decode
# ---------------------------------------------------------------------------

def _kept(model, cache, max_length, eos, graphs):
    return bagel.generate_text_ctx(model, cache, torch.tensor([5, 9]), torch.tensor([9, 6]),
                                   max_length, eos, graphs=graphs)


@pytest.mark.parametrize("mode", ["float", "int8", "w4a8-int4kv"])
def test_kept_decode_program_equals_the_eager_loop(modes, mode):
    """Tokens, lengths and the new lens bit for bit, with no eos, one
    stream's and both streams'; the program writes the columns it made
    valid into the caller's storage, equal to the eager loop's on [0, lens)."""
    model, kw = modes[mode]
    cache = _prefilled(model, **kw)
    free, *_ = _kept(model, cache.clone(), 10, -1, False)
    common = [int(t) for t in free[0, 1:] if (free[1, 1:] == t).any()]
    for e in [-1, int(free[1, 3])] + common[:1]:
        want = _kept(model, cache.clone(), 10, e, False)
        mine = cache.clone()
        got = _kept(model, mine, 10, e, True)
        for g, w in zip(got[:2], want[:2]):
            assert torch.equal(g, w)
        assert got[2].k is mine.k
        _assert_same_cache(got[2], want[2], valid_only=True)
        assert torch.equal(mine.lens, cache.lens)  # the caller's lens are not advanced


def test_kept_decode_program_matches_jax(setup):
    model = setup["model"]
    cache = _prefilled(model)
    free, *_ = _kept(model, cache.clone(), 8, -1, False)
    eos = int(free[0, 3])
    jcache = _to_jax(cache)
    got = _kept(model, cache, 8, eos, True)
    want = jbagel.generate_text_ctx(setup["params"], CFG, jcache, jnp.asarray([5, 9], jnp.int32),
                                    jnp.asarray([9, 6], jnp.int32), 8, jnp.asarray(eos, jnp.int32))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert_caches_equal(got[2], want[2])


# ---------------------------------------------------------------------------
# (b) the batcher's decode chunks
# ---------------------------------------------------------------------------

CHUNKS = ["decode_chunk", "decode_chunk_aligned"]


MASKS = ([True, False, True], [True, True, False], [False, True, True], [True, False, False])


def _chunk_args(active):
    return torch.tensor([3, 5, 7]), torch.tensor([9, 6, 4]), torch.tensor(active)


def _early_exit(model, cache, fn, K):
    """(active mask, eos) that end the chunk before its K steps: a token every
    active slot emits within K - 2 steps, for the first mask that has one
    (one active slot always does)."""
    for active in MASKS:
        free, *_ = fn(model, cache.clone(), *_chunk_args(active), K, graphs=False)
        rows = free[torch.tensor(active), :K - 2]
        common = [int(t) for t in rows[0] if all((r == t).any() for r in rows[1:])]
        if common:
            return active, common[0]
    raise AssertionError("no early exit")


@pytest.mark.parametrize("mode", ["float", "int8", "w4a8-int4kv"])
@pytest.mark.parametrize("flavour", CHUNKS)
def test_chunk_program_equals_the_eager_loop(modes, mode, flavour):
    """Tokens, last, positions, lens, steps run and each live stream's valid
    cache columns bit for bit; with an eos that both active slots emit before
    the chunk's end, so the program runs its last replays past the exit
    (their kv writes land past each stream's lens, where nothing reads)."""
    model, kw = modes[mode]
    fn = getattr(serving, flavour)
    cache = _prefilled(model, S=3, M=40, lens=(9, 6, 11), **kw)
    active, eos = _early_exit(model, cache, fn, 8)
    ran = []
    for graphs in (False, True):
        c = cache.clone()
        *out, n = fn(model, c, *_chunk_args(active), 8, eos=eos, graphs=graphs,
                     return_steps=True)
        ran.append((out, int(n), c))
    (want, n_want, c_want), (got, n_got, c_got) = ran
    assert n_got == n_want
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    assert n_want < 8
    # a freed slot is dead: the aligned band may lie inside its stale lens
    _assert_same_cache(got[3], want[3], valid_only=True, rows=active)
    _assert_same_cache(c_got._map(lambda t: t, lambda t: t, got[3].lens),
                       c_want._map(lambda t: t, lambda t: t, want[3].lens), valid_only=True,
                       rows=active)


@pytest.mark.parametrize("flavour", CHUNKS)
def test_chunk_program_matches_jax(setup, flavour):
    model = setup["model"]
    cache = _prefilled(model, S=3, M=40, lens=(9, 6, 11))
    jcache = _to_jax(cache)
    K = 6
    active, eos = _early_exit(model, cache, getattr(serving, flavour), K)
    tok, last, pos, out, n = getattr(serving, flavour)(
        model, cache, *_chunk_args(active), K, eos=eos, graphs=True, return_steps=True)
    cur, p, act = (np.asarray(t) for t in _chunk_args(active))
    tok_j, last_j, pos_j, cache_j = getattr(jserving, flavour)(
        setup["params"], CFG, jcache, jnp.asarray(cur, jnp.int32), jnp.asarray(p, jnp.int32),
        jnp.asarray(act), K, jax.random.PRNGKey(0), eos=jnp.asarray(eos, jnp.int32))
    np.testing.assert_array_equal(tok.numpy()[act], np.asarray(tok_j)[act])
    np.testing.assert_array_equal(last.numpy()[act], np.asarray(last_j)[act])
    np.testing.assert_array_equal(pos.numpy(), np.asarray(pos_j))
    np.testing.assert_array_equal(out.lens.numpy(), np.asarray(cache_j.lens))
    assert 0 < int(n) < K


# ---------------------------------------------------------------------------
# (b') speculative decoding and the stream
# ---------------------------------------------------------------------------

HL = 64


def _hist(S, lens, start):
    """Each stream's draft history, as ``_prefilled`` made its context: its
    prompt ids and the start token, in [S, HL] int32, and the lengths; stale
    ids past them (a batcher's reused row), which drafts may read."""
    ids = (np.arange(S * 12).reshape(S, 12) * 7 + 3) % V
    hist = np.zeros((S, HL), np.int32)
    hist[:, :40] = (np.arange(40) * 5 + 1) % V
    for s, n in enumerate(lens):
        hist[s, :n] = ids[s, :n]
        hist[s, n] = start[s]
    return torch.from_numpy(hist), torch.tensor([n + 1 for n in lens], dtype=torch.int32)


def _spec(model, cache, max_length, eos, graphs, hist=None):
    """``hist``: (ids, lengths), by default :func:`_hist`'s."""
    h, hlen = _hist(2, (9, 6), (5, 9)) if hist is None else hist
    return bagel.generate_text_spec(model, cache, torch.tensor([5, 9]), torch.tensor([9, 6]),
                                    max_length, eos, h, hlen, k_draft=3, ngram=2, graphs=graphs)


def _planted(answers):
    """Each stream's history with its answer planted before it, after its
    trailing two ids (the lookup's ngram): every draft is then accepted."""
    h, hlen = _hist(2, (9, 6), (5, 9))
    out = torch.zeros_like(h)
    lens = []
    for s, n in enumerate(hlen.tolist()):
        real = h[s, :n].tolist()
        seq = real[-2:] + [t for t in answers[s, 1:].tolist() if t >= 0] + real
        out[s, :len(seq)] = torch.tensor(seq)
        lens.append(len(seq))
    return out, torch.tensor(lens, dtype=torch.int32)


@pytest.mark.parametrize("mode", ["float", "int8", "w4a8-int4kv"])
def test_spec_program_equals_the_eager_loop(modes, mode):
    """Tokens, lengths, the new lens and the verify forwards bit for bit,
    with no eos and with one, and with the answer planted in the history (a
    stream accepts several drafts a forward); the caller's history is left
    as it was and the caller's cache holds the eager loop's columns on
    [0, lens)."""
    model, kw = modes[mode]
    cache = _prefilled(model, **kw)
    free = _spec(model, cache.clone(), 10, -1, False)
    for eos, hist in ((-1, None), (int(free[0][1, 3]), None), (-1, _planted(free[0]))):
        want = _spec(model, cache.clone(), 10, eos, False, hist)
        before = None if hist is None else hist[0].clone()
        mine = cache.clone()
        got = _spec(model, mine, 10, eos, True, hist)
        for g, w in zip(got[:2], want[:2]):
            assert torch.equal(g, w)
        assert int(got[3]) == want[3]
        assert got[2].k is mine.k
        _assert_same_cache(got[2], want[2], valid_only=True)
        if hist is not None:
            assert torch.equal(hist[0], before)
    assert int(got[3]) < int(got[1].max()) - 1  # the planted answer took fewer forwards


def test_spec_program_matches_jax(setup):
    model = setup["model"]
    cache = _prefilled(model)
    jcache = _to_jax(cache)
    h, hlen = _hist(2, (9, 6), (5, 9))
    out, lengths, got_cache, n = _spec(model, cache, 9, -1, True)
    want = jbagel.generate_text_spec(
        setup["params"], CFG, jcache, jnp.asarray([5, 9], jnp.int32),
        jnp.asarray([9, 6], jnp.int32), 9, jnp.asarray(-1, jnp.int32), jnp.asarray(h.numpy()),
        jnp.asarray(hlen.numpy()), k_draft=3, ngram=2)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(want[1]))
    assert_caches_equal(got_cache, want[2])
    assert int(n) == int(want[3])


SPEC_ACTIVE = torch.tensor([True, False, True])


def _spec_chunk(model, cache, graphs, static=False, budget=(20, 3, 20), iters=4):
    hist, hlen = _hist(3, (9, 6, 11), (3, 5, 7))
    return serving.decode_chunk_spec(
        model, cache, torch.tensor([3, 5, 7]), torch.tensor([9, 6, 11]), SPEC_ACTIVE,
        torch.tensor(budget), hist, hlen, iters, 1, k_draft=3, ngram=2, graphs=graphs,
        return_steps=True, static=static)


@pytest.mark.parametrize("mode", ["float", "int8", "w4a8-int4kv"])
@pytest.mark.parametrize("static", [False, True], ids=["pool", "static"])
def test_spec_chunk_program_equals_the_eager_loop(modes, mode, static):
    """Every output bit for bit (tokens, counts, fin, last, positions, the
    history, hlen, verify forwards run) and the live slots' cache columns on
    [0, lens): over the pool's own arrays, and over the programs' static
    buffers with the columns made valid copied back; budgets that end every
    slot before the chunk's last iteration, so the program replays past its
    exit."""
    model, kw = modes[mode]
    cache = _prefilled(model, S=3, M=40, lens=(9, 6, 11), **kw)
    runs = []
    for graphs in (False, True):
        c = cache.clone()
        runs.append((_spec_chunk(model, c, graphs, static, budget=(4, 2, 5), iters=6), c))
    (want, _), (got, mine) = runs
    for i in (0, 1, 2, 3, 4, 6, 7):
        assert torch.equal(got[i], want[i]), i
    assert int(got[8]) == want[8] < 6
    assert got[5].k is mine.k
    _assert_same_cache(got[5], want[5], valid_only=True, rows=SPEC_ACTIVE.tolist())


def test_spec_chunk_program_matches_jax(setup):
    model = setup["model"]
    cache = _prefilled(model, S=3, M=40, lens=(9, 6, 11))
    jcache = _to_jax(cache)
    hist, hlen = _hist(3, (9, 6, 11), (3, 5, 7))
    want = jserving.decode_chunk_spec(
        setup["params"], CFG, jcache, jnp.asarray([3, 5, 7], jnp.int32),
        jnp.asarray([9, 6, 11], jnp.int32), jnp.asarray(SPEC_ACTIVE.numpy()),
        jnp.asarray([20, 3, 20], jnp.int32), jnp.asarray(hist.numpy()), jnp.asarray(hlen.numpy()),
        4, jnp.asarray(1, jnp.int32), k_draft=3, ngram=2)
    got = _spec_chunk(model, cache, True)
    act = SPEC_ACTIVE.numpy()
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for a, w in ((got[0], want[0]), (got[2], want[2]), (got[3], want[3]), (got[6], want[6])):
        np.testing.assert_array_equal(a.numpy()[act], np.asarray(w)[act])
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    np.testing.assert_array_equal(got[7].numpy(), np.asarray(want[7]))
    assert_caches_equal(got[5], want[5], rows=np.nonzero(act)[0])


def test_replays_past_the_exit_change_nothing(setup):
    """After a speculative chunk (every slot done before its last
    iteration) and a kept-context decode, more replays leave the state the
    caller reads as it was: the tokens, counts, flags, lens, positions,
    history and hlen, the forward counter, and the pool's valid columns."""
    model = setup["model"]
    pool = _prefilled(model, S=3, M=40, lens=(9, 6, 11))
    got = _spec_chunk(model, pool, True, budget=(4, 2, 5), iters=6)
    prog = programs.programs()[-1]
    assert isinstance(prog, bagel.SpecProgram) and not bool(prog.go)
    assert prog.hist is got[6]
    prog.cache = pool  # held only while a chunk runs
    names = ("out", "cursor", "fin", "cur", "pos", "lens", "hlen", "hist", "it", "go", "pending")
    state = [getattr(prog, n).clone() for n in names]
    valid = pool._map(lambda t: t, lambda t: t, prog.lens).clone()
    for _ in range(3):
        prog.verify.replay()
    for n, a in zip(names, state):
        assert torch.equal(getattr(prog, n), a), n
    _assert_same_cache(pool._map(lambda t: t, lambda t: t, prog.lens), valid, valid_only=True)
    kept = _prefilled(model)
    free, *_ = _kept(model, kept.clone(), 8, -1, False)
    _kept(model, kept, 8, int(free[0, 2]), True)
    prog = programs.programs()[-1]
    names = ("out", "cur", "pos", "done", "step", "go", "lens")
    state = [getattr(prog, n).clone() for n in names]
    prog.graph.replay()
    for n, a in zip(names, state):
        assert torch.equal(getattr(prog, n), a), n


def _loops() -> list:
    """The live programs but the context builds' prefills (also keyed by
    their cache's shape: the counts below are the decode loops')."""
    return [p for p in programs.programs() if not isinstance(p, bagel.PrefillProgram)]


def _inferencers(model, **kw):
    from unimedvl_tpu_torch.tools import dryrun_mesh

    return [dryrun_mesh.inferencer(model, None, graphs=g, **kw) for g in (False, True)]


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_stream_programs_equal_the_eager_chunks(setup, spec):
    """``gen_text_stream`` by the chunks' programs (over buffers of the
    cache's shape, the valid columns copied back) and by their eager loops:
    the same pieces, answer and kept context; a second request on a new
    context captures nothing anew."""
    kw = dict(spec_decode=True, spec_k=3, spec_ngram=2) if spec else {}
    programs.drop_all()
    results = []
    for inf in _inferencers(setup["model"], **kw):
        ctx = inf.update_context_text("a scan of the chest; a scan of the", inf.init_gen_context())
        res = {}
        pieces = list(inf.gen_text_stream(ctx, max_length=11, chunk=3, result=res))
        n = len(_loops())
        ctx2 = inf.update_context_text("another scan", inf.init_gen_context())
        again = list(inf.gen_text_stream(ctx2, max_length=11, chunk=3))
        assert len(_loops()) == n
        results.append((pieces, res, again))
    (want, wres, wagain), (got, gres, gagain) = results
    assert got == want and gagain == wagain and gres["text"] == wres["text"]
    assert (gres["ctx"].kv_len, gres["ctx"].rope, gres["ctx"].hist) == (
        wres["ctx"].kv_len, wres["ctx"].rope, wres["ctx"].hist)
    _assert_same_cache(gres["ctx"].cache, wres["ctx"].cache, valid_only=True)


# ---------------------------------------------------------------------------
# (c) the flow step
# ---------------------------------------------------------------------------

def _flow_inputs(seed=0, G=2, S1=3, M=24):
    rng = np.random.default_rng(seed)
    shape = (L, G * S1, Hk, M, D)
    k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)) for _ in "kv")
    lens = torch.from_numpy(rng.integers(4, M, G * S1).astype(np.int32))
    n = 16
    return dict(
        caches=KVCache(k=k, v=v, lens=lens),
        positions=torch.from_numpy(rng.integers(1, 30, G * S1)),
        latent_pos_ids=torch.from_numpy(rng.permutation(CFG.max_latent_size ** 2)[:n]),
        init_noise=torch.from_numpy(rng.standard_normal((G, n, CFG.patch_latent_dim),
                                                        dtype=np.float32)),
        start_end_ids=torch.tensor([V - 2, V - 1]))


FLOW_KW = dict(num_timesteps=5, timestep_shift=1.0, cfg_text_scale=2.0, cfg_img_scale=1.5, cfg_interval=(0.4, 1.0),
               use_text_cfg=True, use_img_cfg=True)


def test_flow_program_equals_the_eager_loop_over_two_segments(setup):
    """Steps 0-2 inside the CFG interval (every stream), 3 outside (each
    image's main stream): the one-shot program, the program over [0, 2) then
    [2, 4), and the eager loop, bit for bit."""
    model, a = setup["model"], _flow_inputs()
    args = [a[k] for k in ("caches", "positions", "latent_pos_ids", "init_noise",
                           "start_end_ids")]
    want = bagel.generate_latents_group(model, *args, **FLOW_KW, graphs=False)
    got = bagel.generate_latents_group(model, *args, **FLOW_KW, graphs=True)
    assert torch.equal(got, want)
    half = bagel.generate_latents_group(model, *args, **FLOW_KW, step_range=(0, 2), graphs=True)
    split = bagel.generate_latents_group(model, *args[:3], half, args[4], **FLOW_KW,
                                         step_range=(2, 4), graphs=True)
    assert torch.equal(split, want)
    prog = programs.programs()[-1]
    assert isinstance(prog, bagel.FlowProgram)
    assert sorted(g.kind for g in prog.graphs()) == ["denoise", "denoise"]


def test_flow_program_matches_jax(setup):
    model, a = setup["model"], _flow_inputs(1)
    got = bagel.generate_latents_group(model, a["caches"], a["positions"], a["latent_pos_ids"],
                                       a["init_noise"], a["start_end_ids"], **FLOW_KW,
                                       graphs=True)
    want = jbagel.generate_latents_group(
        setup["params"], CFG, _to_jax(a["caches"]), jnp.asarray(a["positions"].numpy()),
        jnp.asarray(a["latent_pos_ids"].numpy()), jnp.asarray(a["init_noise"].numpy()),
        jnp.asarray(a["start_end_ids"].numpy()), **FLOW_KW)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------

def test_a_program_is_kept_per_key_and_dropped_with_its_storage(setup):
    """One decode program serves two caches of one shape; quantizing the
    weights drops it; ``repack_pool`` drops the chunk program of the pool it
    replaces, and the repacked pool gets a program of its own."""
    model = copy.deepcopy(setup["model"])
    programs.drop_all()
    _decode(model, _prefilled(model), 6, -1, True)
    _decode(model, _prefilled(model), 6, -1, True)
    decode = [p for p in programs.programs() if isinstance(p, bagel.DecodeProgram)]
    assert len(decode) == 1
    pool = _prefilled(model, S=3, M=40, lens=(9, 6, 11))
    serving.decode_chunk(model, pool, *_chunk_args(MASKS[0]), 4, graphs=True)
    chunk = [p for p in programs.programs() if isinstance(p, serving.ChunkProgram)]
    assert len(chunk) == 1 and len(programs.programs()) == 2
    pool = serving.repack_pool(pool, np.asarray([1, 0, 2]))
    assert programs.programs() == decode
    serving.decode_chunk(model, pool, *_chunk_args(MASKS[0]), 4, graphs=True)
    assert len(programs.programs()) == 2 and programs.programs()[-1] is not chunk[0]
    quant.quantize_llm_params(model.language_model, act_quant=True)
    assert programs.programs() == []


def test_new_programs_are_kept_per_shape_and_the_pool_ones_dropped(setup, monkeypatch):
    """The kept-context and speculative programs of a chat, keyed by its
    cache's shape, read none of its storage: ``_ensure_capacity`` growing
    the context keeps them, and a new context of the old shape reuses them.
    A speculative chunk over a pool is keyed by the pool and its history:
    ``repack_pool`` drops it. A draft proposer swapped in gets a program of
    its own."""
    model = copy.deepcopy(setup["model"])
    programs.drop_all()
    plain, spec = (_inferencers(model, **kw)[1] for kw in (
        {}, dict(spec_decode=True, spec_k=3, spec_ngram=2)))
    for inf in (plain, spec):
        ctx = inf.update_context_text("a scan of the chest", inf.init_gen_context())
        inf.chat_turn(ctx, "and the left side?", max_length=6)
    kinds = [(type(p), getattr(p, "kept", None)) for p in _loops()]
    assert kinds == [(bagel.DecodeProgram, True), (bagel.SpecProgram, None)]
    grown = spec._ensure_capacity(ctx, ctx.cache.capacity + 1)
    assert grown.cache.k is not ctx.cache.k and len(_loops()) == 2
    for inf in (plain, spec):
        inf.chat_turn(None, "a new conversation", max_length=6)
    assert len(_loops()) == 2
    pool = _prefilled(model, S=3, M=40, lens=(9, 6, 11))
    _spec_chunk(model, pool, True)
    assert len(_loops()) == 3
    serving.repack_pool(pool, np.asarray([1, 0, 2]))
    assert len(_loops()) == 2
    _spec(model, _prefilled(model), 6, -1, True)
    monkeypatch.setattr(bagel, "propose_drafts", _fixed_proposer)
    _spec(model, _prefilled(model), 6, -1, True)
    assert _loops()[-1].propose is _fixed_proposer and len(_loops()) == 4


def _fixed_proposer(hist, hlen, ngram, K):
    return torch.zeros((hist.shape[0], K), dtype=torch.int32)


# ---------------------------------------------------------------------------
# (d) the prefills and the batcher's admission blocks
# ---------------------------------------------------------------------------

MODES = ["float", "int8", "w4a8-int4kv"]
SE = np.asarray([V - 2, V - 1])


@pytest.fixture(scope="module")
def jax_modes(setup):
    """mode -> the JAX tree of ``_modes``' port model: the same transforms
    (``quantize_llm_params(via_host=True)``, ``fuse_serving_projections``),
    which the port's equal bit for bit (tests/test_torch_quant.py)."""
    params = setup["params"]
    int8 = jquant.fuse_serving_projections(
        jquant.quantize_llm_params(params["llm"], via_host=True, act_quant=True, bits=8))
    w4a8 = jquant.quantize_llm_params(params["llm"], via_host=True, act_quant=True, bits=4)
    return {"float": params, "int8": {**params, "llm": int8},
            "w4a8-int4kv": {**params, "llm": w4a8}}


@pytest.fixture
def jax_k3(monkeypatch):
    """The JAX ``_mlp`` held to K3's definition (tests/test_torch_pipeline.py)."""
    monkeypatch.setattr(jmot, "_FORCE_SILU_QUANT", True)


def _jx(c: KVCache):
    """The port's cache as a JAX one (an int4 cache's values unpacked)."""
    return _to_jax4(c) if c.quantized and c.kv_bits == 4 else _to_jax(c)


def _jcreate(S, M, kw):
    return jmot.KVCache.create(L, S, M, Hk, D, jnp.float32, quantized=bool(kw),
                               kv_bits=kw.get("kv_bits", 8))


def _both_routes(fn):
    """``fn(graphs)`` by the eager route and by the program's plain route
    (a new program: every one is dropped first)."""
    programs.drop_all()
    return fn(False), fn(True)


def _vit_inputs(seed, n, Tb=32):
    rng = np.random.default_rng(seed)
    p = CFG.vit.patch_size
    toks = rng.standard_normal((1, Tb, p * p * 3)).astype(np.float32)
    toks[:, n:] = 0
    pos = np.zeros((1, Tb), np.int64)
    pos[0, :n] = rng.permutation(CFG.vit_max_num_patch_per_side ** 2)[:n]
    return toks, pos


def _vae_inputs(seed, h, w):
    """An image [1, 3, h, w], its posterior noise (NCHW, and the JAX key it
    comes from) and the latent position ids padded to the bucket 16."""
    rng = np.random.default_rng(seed)
    image = rng.uniform(-1, 1, (1, 3, h, w)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    ds, z = CFG.vae.downsample, CFG.vae.z_channels
    noise = np.asarray(jax.random.normal(key, (1, h // ds, w // ds, z), jnp.float32))
    n = (h // CFG.latent_downsample) * (w // CFG.latent_downsample)
    pos = np.zeros((1, 16), np.int64)
    pos[0, :n] = rng.permutation(CFG.max_latent_size ** 2)[:n]
    return image, key, noise.transpose(0, 3, 1, 2).copy(), pos, n


def _group_inputs(seed, ns=(30, 17, 25), P=4, Tb=30, T=32):
    """An image group of len(ns) rows padded to P (n = 0), with each real
    row's text [P, T] after it (rope 1 on)."""
    rng = np.random.default_rng(seed)
    p = CFG.vit.patch_size
    toks = rng.standard_normal((P, Tb, p * p * 3)).astype(np.float32)
    ns = np.asarray(list(ns) + [0] * (P - len(ns)))
    toks[ns == 0] = 0
    pos = np.stack([np.arange(Tb) * (i + 1) % (CFG.vit_max_num_patch_per_side ** 2)
                    for i in range(P)]).astype(np.int64)
    ids = (np.arange(P * T).reshape(P, T) * 11 + 5) % V
    tpos = np.broadcast_to(np.arange(1, 1 + T), (P, T)).copy()
    lens = np.asarray([9, 20, 3, 0])[:P]
    valid = (np.arange(T)[None] < lens[:, None]) & (ns[:, None] > 0)
    return toks, pos, ns, ids, tpos, valid


def _prefix(model, kw, Mp=32, tp=13):
    """A registered preamble's 1-stream block: tp ids prefilled into Mp columns."""
    ids = (np.arange(Mp)[None] * 3 + 1) % V
    c = KVCache.create(L, 1, Mp, Hk, D, torch.float32, **kw)
    return bagel.prefill_text(model, c, torch.from_numpy(ids), torch.from_numpy(np.arange(Mp)[None]),
                              torch.from_numpy(np.arange(Mp)[None] < tp), graphs=False), tp


def _text_block_inputs(P=4, T=32, tp=13):
    ids = (np.arange(P * T).reshape(P, T) * 5 + 2) % V
    pos = np.broadcast_to(np.arange(tp, tp + T), (P, T)).copy()
    valid = np.arange(T)[None] < np.asarray([7, 19, 1, 0])[:P, None]
    return ids, pos, valid


def _run_program(name, model, kw, graphs):
    """One prefill program's function by the route of ``graphs``: (its
    cache or block, the inputs the JAX side needs)."""
    t = torch.from_numpy
    if name == "text":
        # every [4, 32] prefill of a mode into 64 columns: one JAX compile a mode
        cache = _prefilled(model, S=4, M=64, lens=(9, 6, 11, 3), **kw)
        ids = (np.arange(4 * 32).reshape(4, 32) * 3 + 4) % V
        pos = np.stack([np.arange(n, n + 32) for n in (9, 6, 11, 3)])
        valid = np.arange(32)[None] < np.asarray([[21], [30], [0], [32]])
        jc = _jx(cache)
        out = bagel.prefill_text(model, cache, t(ids), t(pos), t(valid), graphs=graphs)
        return out, (jc, ids, pos, valid)
    if name == "vit":
        cache = _prefilled(model, S=1, M=80, lens=(9,), **kw)
        toks, pos = _vit_inputs(1, 27)
        jc = _jx(cache)
        out = bagel.prefill_vit_bucketed(model, cache, t(toks), t(pos), 27, t(SE), 9,
                                         graphs=graphs)
        return out, (jc, toks, pos)
    if name == "vae":
        cache = _prefilled(model, S=1, M=80, lens=(9,), **kw)
        image, key, noise, pos, n = _vae_inputs(2, 24, 32)
        tokens = bagel.encode_vae_latent_tokens(model, t(image), t(noise), graphs=graphs)
        jc = _jx(cache)
        padded = torch.nn.functional.pad(tokens, (0, 0, 0, 16 - n))
        out = bagel.prefill_vae_bucketed(model, cache, padded, t(pos), n, t(SE), 9,
                                         graphs=graphs)
        return out, (jc, image, key, padded.numpy(), pos, n, tokens)
    if name == "image_group":
        toks, pos, ns, ids, tpos, valid = _group_inputs(3)
        block = serving.image_text_block(
            model, t(toks), t(pos), t(ns), t(SE), t(ids), t(tpos), t(valid), capacity=30 + 2 + 32,
            kv_dtype=torch.float32, quantized=bool(kw), kv_bits=kw.get("kv_bits", 8),
            graphs=graphs)
        return block.clone(), (toks, pos, ns, ids, tpos, valid)
    prefix, tp = _prefix(model, kw)
    ids, pos, valid = _text_block_inputs()
    block = serving.text_block(model, t(ids), t(pos), t(valid), 32 + 32, prefix, tp,
                               kv_dtype=torch.float32, quantized=bool(kw),
                               kv_bits=kw.get("kv_bits", 8), graphs=graphs)
    return block.clone(), (_jx(prefix), tp, ids, pos, valid)


def _jax_program(name, jparams, kw, args):
    """The JAX jitted functions on the same inputs."""
    j = jnp.asarray
    i32 = lambda a: jnp.asarray(a, jnp.int32)  # noqa: E731
    if name == "text":
        jc, ids, pos, valid = args
        return jbagel.prefill_text(jparams, CFG, jc, i32(ids), i32(pos), j(valid))
    if name == "vit":
        jc, toks, pos = args
        return jbagel.prefill_vit_bucketed(jparams, CFG, jc, j(toks), i32(pos), i32(27), i32(SE),
                                           i32([9]))
    if name == "vae":
        jc, image, key, padded, pos, n, tokens = args
        # the encode reads the VAE alone: one compile for the three modes
        want = jbagel.encode_vae_latent_tokens({"vae": jparams["vae"]}, CFG,
                                               j(image.transpose(0, 2, 3, 1)), key)
        np.testing.assert_allclose(tokens.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
        return jbagel.prefill_vae_bucketed(jparams, CFG, jc, j(padded), i32(pos), i32(n),
                                           i32(SE), i32([9]), jnp.asarray(0.0, jnp.float32))
    if name == "image_group":
        toks, pos, ns, ids, tpos, valid = args
        block = jbagel.prefill_vit_group(
            jparams, CFG, j(toks), i32(pos), i32(ns), i32(SE), jnp.zeros((4,), jnp.int32),
            kv_dtype=jnp.float32, quantized=bool(kw), capacity=64, kv_bits=kw.get("kv_bits", 8))
        return jbagel.prefill_text(jparams, CFG, block, i32(ids), i32(tpos), j(valid))
    jprefix, tp, ids, pos, valid = args
    block = jserving.seed_prefix_block(_jcreate(4, 64, kw), jprefix, i32(tp))
    return jbagel.prefill_text(jparams, CFG, block, i32(ids), i32(pos), j(valid))


PREFILLS = ["text", "vit", "vae", "image_group", "seeded_text_block"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", PREFILLS)
def test_prefill_program_equals_the_eager_function_and_jax(modes, jax_modes, jax_k3, name, mode):
    """Each prefill program's plain route against its eager function, bit
    for bit (lens, and each stream's cache arrays on [0, lens); a block's
    every column: the program zeroes its own as the eager route creates a
    new one), and against the JAX jitted function on the same inputs at
    ``assert_caches_equal``'s tolerances (the VAE latent tokens within 1e-4,
    as tests/test_torch_gen.py holds the encode; the JAX prefill then takes
    the port's tokens). The image group is P = 3 padded to 4 (row 3
    inactive, stored nowhere: its lens stays 0)."""
    model, kw = modes[mode]
    (want, _), (got, args) = _both_routes(lambda g: _run_program(name, model, kw, g))
    block = name in ("image_group", "seeded_text_block")
    _assert_same_cache(got, want, valid_only=not block)
    jwant = _jax_program(name, jax_modes[mode], kw, args)
    rows = [0, 1, 2] if name == "image_group" else None
    (assert_int4_equal if kw.get("kv_bits") == 4 else assert_caches_equal)(got, jwant, rows=rows)
    if name == "image_group":
        assert got.lens.tolist()[3] == 0 and got.k.shape[1] == 4


def test_one_vit_program_serves_a_bucket(setup):
    """Two images of one bucket (n 27 and 19) and two rope positions through
    one program, each equal to the eager function's cache."""
    model = setup["model"]
    programs.drop_all()
    for seed, n, rope in ((1, 27, 9), (4, 19, 3)):
        toks, pos = _vit_inputs(seed, n)
        runs = []
        for graphs in (False, True):
            cache = _prefilled(model, S=1, M=80, lens=(9,))
            runs.append(bagel.prefill_vit_bucketed(
                model, cache, torch.from_numpy(toks), torch.from_numpy(pos), n,
                torch.from_numpy(SE), rope, graphs=graphs))
        _assert_same_cache(runs[1], runs[0], valid_only=True)
        assert runs[1].lens.tolist() == [9 + n + 2]
    assert len(programs.programs()) == 1
    assert isinstance(programs.programs()[0], bagel.PrefillProgram)


def test_vae_end_row_moves_within_a_bucket(setup):
    """Two VAE images of bucket 16, 12 and 16 latent tokens: one encode
    program each (its key is the image's shape) and one prefill program
    whose <vision_end> row moves (13, then 17: the block's last row), each
    equal to the eager route bit for bit (the JAX side:
    ``test_prefill_program_equals_the_eager_function_and_jax[vae-*]``)."""
    model = setup["model"]
    programs.drop_all()
    t = torch.from_numpy
    for seed, h, w in ((2, 24, 32), (5, 32, 32)):
        image, key, noise, pos, n = _vae_inputs(seed, h, w)
        runs = []
        for graphs in (False, True):
            cache = _prefilled(model, S=1, M=80, lens=(9,))
            tokens = bagel.encode_vae_latent_tokens(model, t(image), t(noise), graphs=graphs)
            padded = torch.nn.functional.pad(tokens, (0, 0, 0, 16 - n))
            runs.append(bagel.prefill_vae_bucketed(model, cache, padded, t(pos), n, t(SE), 4,
                                                   graphs=graphs))
        _assert_same_cache(runs[1], runs[0], valid_only=True)
        assert runs[1].lens.tolist() == [9 + n + 2]
    kinds = sorted(p.graph.forwards.get("gen", 0) for p in programs.programs())
    assert kinds == [0, 0, 1]  # two encodes (one a geometry), one prefill


def test_mot_rows_by_a_device_row_equals_the_host_row():
    """``_mot_rows`` with ``end_row`` a 0-dim tensor: the rows of the host
    int's slices, bit for bit."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 7, 5), np.float32))
    und, gen = (lambda t: t * 3.0 + 1.0), (lambda t: t * -2.0)
    for end in (1, 4, 6):
        want = mot_rows(x, und, gen, True, end)
        assert torch.equal(mot_rows(x, und, gen, True, torch.tensor(end)), want)


def _chats(model, image, graphs):
    from unimedvl_tpu_torch.tools import dryrun_mesh

    inf = dryrun_mesh.inferencer(model, None, graphs=graphs)
    ctx = inf.update_context_image(image, inf.init_gen_context(), vae=True, vit=True)
    ctx = inf.update_context_text("which side?", ctx)
    return inf, ctx, inf.gen_text(ctx, max_length=4), inf.chat([image], "and now?", max_length=4)


def test_inferencer_context_builds_by_program(setup):
    """An edit-style context (VAE and ViT image, then text) and a chat by
    the programs and by the eager prefills: the same cache on [0, lens),
    kv_len, rope and answers. A second image of the same buckets captures
    nothing anew."""
    model = setup["model"]
    img = np.random.default_rng(3).integers(0, 256, (32, 24, 3), dtype=np.uint8)
    (_, wctx, wtext, wchat), (inf, gctx, gtext, gchat) = _both_routes(
        lambda g: _chats(model, img, g))
    assert (gtext, gchat) == (wtext, wchat)
    assert (gctx.kv_len, gctx.rope) == (wctx.kv_len, wctx.rope)
    _assert_same_cache(gctx.cache, wctx.cache, valid_only=True)
    n = len(programs.programs())
    other = np.random.default_rng(4).integers(0, 256, (24, 32, 3), dtype=np.uint8)
    inf.chat([other], "and now?", max_length=4)
    prefills = [p for p in programs.programs() if isinstance(p, bagel.PrefillProgram)]
    # the VAE encode, the VAE prefill, the ViT prefill, the text prefill
    assert len(programs.programs()) == n and len(prefills) == 4


def _batcher(model, graphs, **kw):
    from unimedvl_tpu_torch.data import imaging
    from unimedvl_tpu_torch.data.tokenizer import add_special_tokens
    from tests.test_torch_pipeline import FakeTokenizer

    tok, ids, _ = add_special_tokens(FakeTokenizer())
    return serving.ContinuousBatcher(model, tok, ids, num_slots=8, capacity=512, chunk=4,
                                     vit_transform=imaging.ImageTransform(32, 8, 2, 1024),
                                     graphs=graphs, **kw)


def _serve_port(model, graphs):
    from tests.test_torch_serving import _image

    b = _batcher(model, graphs)
    pid = b.register_prefix("You are a radiologist. ")
    reqs = [serving.Request(prompt=p, image=_image(20 + i, h, w), max_new_tokens=3)
            for i, (p, h, w) in enumerate([("what?", 24, 28), ("describe", 32, 24),
                                           ("count", 26, 30)])]
    reqs += [serving.Request(prompt="alpha", max_new_tokens=3),
             serving.Request(prompt="beta", max_new_tokens=3, prefix_id=pid)]
    rids = [b.submit(r) for r in reqs]
    out = b.run()
    assert not b.errors
    return [out[r] for r in rids], b


def test_batcher_admission_by_program(setup):
    """The batcher's admission blocks by their programs and eagerly: the
    same answers; three images of one bucket are one block padded to four
    rows (the JAX batcher's power of two), and the text blocks with and
    without the preamble are programs of their own."""
    model = setup["model"]
    (want, _), (got, b) = _both_routes(lambda g: _serve_port(model, g))
    assert got == want
    blocks = [p for p in programs.programs() if p.family == "admission"]
    rows = sorted(p.cache.k.shape[1] for p in blocks)
    assert rows == [4, 32, 32]
    assert len({tuple(p.inputs) for p in blocks}) == 3  # image, text, preamble-seeded text


def test_prefill_programs_dropped_with_their_storage(setup):
    """Quantizing the weights drops the prefill programs; ``repack_pool``
    drops a pool's text prefill (the batcher's legacy path writes the pool's
    own arrays), and not the one keyed by a cache's shape."""
    model = copy.deepcopy(setup["model"])
    programs.drop_all()
    pool = _prefilled(model, S=3, M=40, lens=(9, 6, 11))
    ids = torch.from_numpy((np.arange(3 * 8).reshape(3, 8) * 7) % V)
    pos = torch.from_numpy(np.broadcast_to(np.arange(12, 20), (3, 8)).copy())
    valid = torch.ones((3, 8), dtype=torch.bool)
    pool = bagel.prefill_text(model, pool, ids, pos, valid, graphs=True, static=False)
    bagel.prefill_text(model, _prefilled(model, S=3, M=40, lens=(9, 6, 11)), ids, pos, valid,
                       graphs=True)
    assert len(programs.programs()) == 2
    serving.repack_pool(pool, np.asarray([2, 0, 1]))
    (left,) = programs.programs()
    assert left.storage == "static"
    quant.quantize_llm_params(model.language_model, act_quant=True)
    assert programs.programs() == []


# ---------------------------------------------------------------------------
# the route of a model on a mesh (programs.use_graphs), with stand-in groups
# ---------------------------------------------------------------------------

class _Group:
    """A stand-in process group: only its backend is read."""

    def __init__(self, backend):
        self.backend = backend


def _on_mesh(monkeypatch, model_backend, seq_backend=None):
    """(a stand-in rank's model on a ("data", "model") mesh whose "model"
    group runs over ``model_backend``, an ("model", "seq") mesh whose "seq"
    group runs over ``seq_backend``)."""
    from types import SimpleNamespace

    from unimedvl_tpu_torch.parallel import mesh as pmesh

    monkeypatch.setattr(pmesh, "group_backend", lambda g: g.backend)

    def mesh(axes, groups):
        return pmesh.Mesh(axes, {a: 1 for a in axes}, 0, {a: 0 for a in axes}, groups)

    model = SimpleNamespace(language_model=SimpleNamespace(
        mesh=mesh(("data", "model"), {"data": None, "model": _Group(model_backend)})))
    sp = mesh(("model", "seq"), {"model": None,
                                 "seq": None if seq_backend is None else _Group(seq_backend)})
    return model, sp


CUDA, CPU = torch.device("cuda"), torch.device("cpu")


def test_nccl_mesh_takes_the_programs_by_default(monkeypatch):
    """Every group NCCL: the rule of one device (programs on the card, the
    eager loops on the CPU, ``graphs`` as given); the mesh enters the key."""
    model, sp = _on_mesh(monkeypatch, "nccl", "nccl")
    assert model.language_model.mesh.capturable and sp.capturable
    assert programs.use_graphs(None, CUDA, model) and programs.use_graphs(None, CUDA, model, sp)
    assert programs.use_graphs(True, CUDA, model) and not programs.use_graphs(False, CUDA, model)
    assert not programs.use_graphs(None, CPU, model)
    with programs.eager():
        assert not programs.use_graphs(None, CUDA, model)
    key = programs.mesh_key(model, sp)
    assert [k[0] for k in key] == [("data", "model"), ("model", "seq")]
    assert key != programs.mesh_key(model) and programs.mesh_key(None) == ()


def test_gloo_mesh_runs_eagerly_on_the_card(monkeypatch):
    """A gloo group (the model's, or the sequence-parallel mesh's): on a
    CUDA device ``graphs=None`` takes the eager loop; on the CPU ``graphs=
    True`` takes the program's plain route, as the CPU mesh tests run it."""
    for model_backend, seq_backend in (("gloo", None), ("nccl", "gloo")):
        model, sp = _on_mesh(monkeypatch, model_backend, seq_backend)
        assert not programs.use_graphs(None, CUDA, model, sp)
        assert not programs.use_graphs(False, CUDA, model, sp)
        assert programs.use_graphs(True, CPU, model, sp)
        assert not programs.use_graphs(None, CPU, model, sp)
    assert not model.language_model.mesh.capturable or not sp.capturable


def test_gloo_mesh_refuses_graphs_on_the_card(monkeypatch):
    """``graphs=True`` on a CUDA device over a gloo group raises, naming the
    axis and its backend."""
    model, sp = _on_mesh(monkeypatch, "gloo")
    with pytest.raises(ValueError, match="'model' axis runs over gloo"):
        programs.use_graphs(True, CUDA, model)
    model, sp = _on_mesh(monkeypatch, "nccl", "gloo")
    with pytest.raises(ValueError, match="'seq' axis runs over gloo"):
        programs.use_graphs(True, CUDA, model, sp)
