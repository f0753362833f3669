"""The port's device programs (unimedvl_tpu_torch/inference/programs.py) on
the CPU: tests/test_pipeline.py's TINY config, fp32, weights drawn with numpy
into the JAX tree's structure (``jax.eval_shape`` of its ``init_params``, no
compile) and loaded into both frameworks.

On a CPU tensor a program's replay calls its step body on its static
buffers: that plain route must equal the eager loop bit for bit (tokens,
lengths, positions, lens, steps run, cache arrays, latents), and the JAX
program on the same inputs (one JAX program each: ``generate_text``,
``decode_chunk``, ``decode_chunk_aligned``, ``generate_latents_group``;
tokens exactly, latents within 1e-5 as tests/test_torch_gen_serving.py holds
the eager loop). The decode runs in the float mode, full-int8 fused over an
int8 cache, w4a8 over an int4 cache; the chunks exit early mid-chunk and run
their remaining replays past the exit; the flow loop runs over two
``step_range`` segments. A program's key is dropped by ``quantize_llm_params``
and by ``repack_pool``. The captured route (CUDA graphs) is held to the eager
one in tests/test_torch_kernels_cuda.py, on the card.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unimedvl_tpu.inference import serving as jserving
from unimedvl_tpu.models import bagel as jbagel
from unimedvl_tpu_torch import quant
from unimedvl_tpu_torch.inference import programs, serving
from unimedvl_tpu_torch.models import bagel
from unimedvl_tpu_torch.models.qwen2_mot import KVCache
from unimedvl_tpu_torch.weights.loader import from_jax_params

from tests.test_pipeline import TINY as CFG
from tests.test_torch_config import port_config
from tests.test_torch_serving import _to_jax

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


def test_sampled_decode_is_eager_by_design(setup):
    model = setup["model"]
    with pytest.raises(ValueError, match="sampled decoding runs eagerly"):
        bagel.generate_text(model, _prefilled(model), torch.tensor([5, 9]), torch.tensor([9, 6]),
                            4, -1, do_sample=True, graphs=True)


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
