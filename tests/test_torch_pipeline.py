"""``InterleaveInferencer`` of the PyTorch port against the JAX package's, on
the CPU: the tiny config and fake tokenizer of tests/test_pipeline.py, the
same weights (``from_jax_params``), fp32. Answers must be the same strings.
The speculative decode and the kept context (``TestSpecAndKeptContext``, as
tests/test_pipeline.py:138-270 holds them): spec ``chat``, ``chat_turn``
over three turns and ``gen_text_stream`` plain and spec, with the kept
contexts equal (kv length, rope, history, cache on [0, lens)).

Generation runs on the tiny config with its VAE and a random velocity head;
the port's ``_randn`` replays the JAX inferencer's draws (a copy of its key,
split in the same order), so both start from the same noise. Latents agree
within 1e-4 (a few layers and flow steps in fp32, sums in another order);
decoded images within 1 per uint8 pixel (the cast truncates).

The quantized serving modes as a whole (``TestQuantizedChat``): both
inferencers with ``kv_quantized=True`` over the same quantized trees
(full-int8 with fused projections, w4a8, and weight-only w4 fused and with
groups of 32), the JAX ``_mlp`` held to the fused silu * mul * quant
definition the port always takes (``_FORCE_SILU_QUANT``; the weight-only
modes never quantize x). Integer matmuls agree exactly; what can differ is an
int8 rounding of an activation or of a cached k/v where torch's and XLA's fp32
(norms, rope, softmax, sigmoid) differ in the last place. On these seeds no
rounding flips: the first-step logits agree within 1e-6 (seen: 9e-8; in the
weight-only modes, whose fp32 sums run in another order, within 2e-5, seen
4.9e-6) and the greedy tokens and ``chat`` strings are identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from unimedvl_tpu import quant as jquant
from unimedvl_tpu.config import BagelConfig, LLMConfig, ViTConfig
from unimedvl_tpu.data.imaging import ImageTransform
from unimedvl_tpu.data.tokenizer import add_special_tokens
from unimedvl_tpu.inference import InterleaveInferencer as JaxInferencer
from unimedvl_tpu.models import bagel as jbagel
from unimedvl_tpu.models import qwen2_mot as jmot
from unimedvl_tpu_torch import quant
from unimedvl_tpu_torch.data import imaging as timaging
from unimedvl_tpu_torch.data import tokenizer as ttokenizer
from unimedvl_tpu_torch.inference import InterleaveInferencer
from unimedvl_tpu_torch.models import qwen2_mot
from unimedvl_tpu_torch.ops import act_quant as aq
from unimedvl_tpu_torch.ops import decode_attention as dec
from unimedvl_tpu_torch.ops import w4_matmul as w4
from unimedvl_tpu_torch.weights.loader import from_jax_params

from tests.test_pipeline import TINY as GEN_CFG
from tests.test_torch_config import init_params, port_config

# tests/test_pipeline.py's TINY without the gen side, which chat never runs
CFG = BagelConfig(
    llm=LLMConfig(
        vocab_size=300, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, rope_theta=10000.0,
    ),
    vit=ViTConfig(
        hidden_size=24, intermediate_size=48, num_hidden_layers=2,
        num_attention_heads=2, image_size=32, patch_size=2, rope=False,
    ),
    vae=None,
    visual_gen=False,
    vit_max_num_patch_per_side=16,
)


class FakeTokenizer:
    """Byte-level fake tokenizer: char -> id. ids 0-255 chars; specials 256+."""

    def __init__(self):
        self.specials = {}
        self.special_tokens_map = {}

    def add_tokens(self, tokens):
        for t in tokens:
            if t not in self.specials:
                self.specials[t] = 256 + len(self.specials)
        return len(tokens)

    def convert_tokens_to_ids(self, tok):
        return self.specials[tok]

    def encode(self, text):
        return [ord(c) % 256 for c in text]

    def decode(self, ids):
        inv = {v: k for k, v in self.specials.items()}
        return "".join(inv.get(i, chr(i)) for i in ids)


@pytest.fixture(scope="module")
def pair():
    params = init_params(1, CFG)
    tok, new_token_ids, _ = add_special_tokens(FakeTokenizer())
    transform = ImageTransform(32, 8, 2, 1024)
    jax_inf = JaxInferencer(params, CFG, tok, new_token_ids, vit_transform=transform)
    model = from_jax_params(jax.tree.map(np.asarray, params), port_config(CFG), device="cpu")
    ttok, tids, _ = ttokenizer.add_special_tokens(FakeTokenizer())
    torch_inf = InterleaveInferencer(model, ttok, tids,
                                     vit_transform=timaging.ImageTransform(32, 8, 2, 1024))
    return jax_inf, torch_inf


def _image(seed, h, w):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))


class TestChat:
    @pytest.mark.parametrize("n_images", [1, 2])
    def test_chat_matches_jax(self, pair, n_images):
        jax_inf, torch_inf = pair
        images = [_image(i, 24 + 4 * i, 28) for i in range(n_images)]
        want = jax_inf.chat(images, "what is this?", max_length=8)
        got = torch_inf.chat(images, "what is this?", max_length=8)
        assert isinstance(got, str)
        assert got == want

    def test_uint8_array_at_target_size_needs_no_resize(self, pair):
        _, torch_inf = pair
        image = _image(3, 16, 20)  # inside (8, 32) and stride 2: no resize
        arr = np.asarray(image)
        assert torch_inf._vit_resized_u8(arr) is arr
        assert torch_inf.chat([arr], "and this?", max_length=6) == torch_inf.chat(
            [image], "and this?", max_length=6
        )

    def test_gen_text_twice_on_one_context(self, pair):
        """Decode writes land past the context's lens, so a second answer on
        the same context is the same answer."""
        _, torch_inf = pair
        ctx = torch_inf.init_gen_context()
        ctx = torch_inf.update_context_image(_image(4, 20, 20), ctx, vae=False)
        ctx = torch_inf.update_context_text("describe the image", ctx)
        lens = ctx.cache.lens.clone()
        first = torch_inf.gen_text(ctx, max_length=10)
        assert torch_inf.gen_text(ctx, max_length=10) == first
        assert (ctx.cache.lens == lens).all()


# hidden 64 / intermediate 128: wide enough for int8 activations to carry the signal
QCFG = BagelConfig(
    llm=LLMConfig(
        vocab_size=300, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, rope_theta=10000.0,
    ),
    vit=CFG.vit, vae=None, visual_gen=False, vit_max_num_patch_per_side=16,
)
QUANT_MODES = {
    "int8-act-fused": (dict(bits=8, act_quant=True), True),
    "w4a8": (dict(bits=4, act_quant=True), False),
    # weight-only w4: bf16 x through K4's bf16-x branch, K3 never runs
    "w4": (dict(bits=4), True),
    "w4-g32": (dict(bits=4, group_size=32), False),
}
WEIGHT_ONLY = ("w4", "w4-g32")


@pytest.fixture(scope="module", params=sorted(QUANT_MODES))
def quant_pair(request):
    """Both inferencers over one quantized tree, int8 KV caches. The port's
    model comes from its own transforms on the fp32 weights (which
    tests/test_torch_quant.py shows equal to loading the JAX tree)."""
    kw, fused = QUANT_MODES[request.param]
    params = init_params(3, QCFG)
    llm = jquant.quantize_llm_params(params["llm"], via_host=True, **kw)
    if fused:
        llm = jquant.fuse_serving_projections(llm)
    jparams = {**params, "llm": llm}
    tok, new_token_ids, _ = add_special_tokens(FakeTokenizer())
    jax_inf = JaxInferencer(jparams, QCFG, tok, new_token_ids,
                            vit_transform=ImageTransform(32, 8, 2, 1024), kv_quantized=True)
    model = from_jax_params(jax.tree.map(np.asarray, params), port_config(QCFG), device="cpu")
    quant.quantize_llm_params(model.language_model, **kw)
    if fused:
        quant.fuse_serving_projections(model.language_model)
    ttok, tids, _ = ttokenizer.add_special_tokens(FakeTokenizer())
    torch_inf = InterleaveInferencer(
        model, ttok, tids, vit_transform=timaging.ImageTransform(32, 8, 2, 1024),
        kv_quantized=True)
    with pytest.MonkeyPatch.context() as mp:  # the JAX _mlp takes K3's definition too
        mp.setattr(jmot, "_FORCE_SILU_QUANT", True)
        yield request.param, jax_inf, torch_inf


def _first_step_logits_jax(inf, image, prompt):
    ctx = inf.init_gen_context()
    ctx = inf.update_context_image(image, ctx, vae=False)
    ctx = inf.update_context_text(prompt, ctx)
    ctx = inf._ensure_capacity(ctx, 1)
    llm = inf.params["llm"]
    base = jnp.max(ctx.cache.lens)
    x = jmot.embed_tokens(llm, jnp.asarray([inf.new_token_ids["bos_token_id"]]))[:, None]
    h, _ = jmot.forward(llm, inf.cfg.llm, x, jnp.asarray([[ctx.rope]]), ctx.cache,
                        jmot.ForwardSpec("und", True, True), decode_cols=(base, base))
    return np.asarray(jmot.lm_head(llm, h[:, 0]))[0]


def _first_step_logits_torch(inf, image, prompt):
    ctx = inf.init_gen_context()
    ctx = inf.update_context_image(image, ctx, vae=False)
    ctx = inf.update_context_text(prompt, ctx)
    ctx = inf._ensure_capacity(ctx, 1)
    lm = inf.model.language_model
    base = ctx.cache.lens.max()
    x = qwen2_mot.embed_tokens(lm, torch.tensor([inf.new_token_ids["bos_token_id"]]))[:, None]
    with torch.no_grad():
        h, _ = lm.model(x, torch.tensor([[ctx.rope]]), ctx.cache, causal=True,
                        decode_cols=(base, base))
    return qwen2_mot.lm_head(lm, h[:, 0])[0].numpy()


class TestQuantizedChat:
    def test_first_step_logits_match_jax(self, quant_pair):
        mode, jax_inf, torch_inf = quant_pair
        image = _image(8, 24, 28)
        want = _first_step_logits_jax(jax_inf, image, "what is this?")
        got = _first_step_logits_torch(torch_inf, image, "what is this?")
        assert got.shape == want.shape == (QCFG.llm.vocab_size,)
        # seen on these seeds: 9e-8 on logits of std 0.16. The matmuls are exact
        # integers; a flipped int8 step of an activation or of a cached k/v (where
        # the two frameworks' fp32 differ in the last place) would show as ~1e-3
        # and did not occur. The weight-only modes multiply fp32 x by the unpacked
        # weights, and the JAX package's unkernelled path sums the even and the odd
        # in-rows apart: fp32 sums in another order, seen up to 4.9e-6, so 2e-5
        atol = 2e-5 if mode in WEIGHT_ONLY else 1e-6
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
        assert got.argmax() == want.argmax()

    @pytest.mark.parametrize("n_images", [1, 2])
    def test_chat_matches_jax(self, quant_pair, n_images):
        mode, jax_inf, torch_inf = quant_pair
        images = [_image(i, 24 + 4 * i, 28) for i in range(n_images)]
        want = jax_inf.chat(images, "what is this?", max_length=8)
        before = dict(aq.counts), dict(dec.int8_counts), dict(w4.counts), dict(dec.counts)
        got = torch_inf.chat(images, "what is this?", max_length=8)
        assert isinstance(got, str) and got == want
        # the path went through the plain versions of K3 (never in the weight-only
        # modes, whose x stays bf16) and K2-int8 (and of K4 in the w4 modes), never
        # through the bf16 decode
        assert (aq.counts["plain"] > before[0]["plain"]) == (mode not in WEIGHT_ONLY)
        assert dec.int8_counts["plain"] > before[1]["plain"]
        assert (w4.counts["plain"] > before[2]["plain"]) == mode.startswith("w4")
        assert dec.counts == before[3]

    def test_contexts_are_int8_and_forks_copy_the_scales(self, quant_pair):
        _, _, torch_inf = quant_pair
        ctx = torch_inf.update_context_text("shared", torch_inf.init_gen_context())
        assert ctx.cache.quantized and ctx.cache.k.dtype == torch.int8
        assert ctx.cache.k_scale[..., : ctx.kv_len].min() > 0
        fork = ctx.fork()
        kept = fork.cache.k_scale.clone()
        ctx = torch_inf.update_context_text("the original goes on", ctx)
        assert torch.equal(fork.cache.k_scale, kept)
        assert not torch.equal(ctx.cache.k_scale[..., : ctx.kv_len], kept[..., : ctx.kv_len])
        grown = torch_inf._ensure_capacity(ctx, 2000)
        assert grown.cache.k_scale.shape[-1] == grown.cache.capacity >= ctx.kv_len + 2000
        stacked, _ = torch_inf._stack_contexts([grown, fork])
        assert stacked.k_scale.shape[1] == 2 and stacked.k.dtype == torch.int8

    def test_gen_text_twice_on_one_int8_context(self, quant_pair):
        _, _, torch_inf = quant_pair
        ctx = torch_inf.update_context_text("describe", torch_inf.init_gen_context())
        first = torch_inf.gen_text(ctx, max_length=6)
        assert torch_inf.gen_text(ctx, max_length=6) == first


def test_int4_kv_cache_raises_naming_the_roadmap():
    model = from_jax_params(
        jax.tree.map(np.asarray, init_params(1, CFG)),
        port_config(CFG), device="cpu")
    with pytest.raises(ValueError, match="8 or 4 bits"):
        InterleaveInferencer(model, None, {}, kv_quantized=True, kv_bits=2)
    assert not InterleaveInferencer(model, None, {}).init_gen_context().cache.quantized
    cache = InterleaveInferencer(model, None, {}, kv_quantized=True,
                                 kv_bits=4).init_gen_context().cache
    assert cache.kv_bits == 4 and cache.k.shape[-1] == CFG.llm.head_dim // 2


def test_positional_parameters_follow_the_jax_inferencer():
    """The parameters both inferencers take come in the same relative order,
    and the port's tail is keyword-only, so a positional caller of either
    binds each transform where the other does."""
    import inspect

    jax_params = list(inspect.signature(JaxInferencer.__init__).parameters)
    port = inspect.signature(InterleaveInferencer.__init__).parameters
    shared = [n for n in port if n in jax_params]
    assert shared == sorted(shared, key=jax_params.index)
    assert shared[:6] == ["self", "tokenizer", "new_token_ids", "vae_transform", "vit_transform", "seed"]
    positional = [n for n, p in port.items() if p.kind == p.POSITIONAL_OR_KEYWORD]
    assert positional == ["self", "model", "tokenizer", "new_token_ids", "vae_transform",
                          "vit_transform", "seed"]
    keyword = [n for n, p in port.items() if p.kind == p.KEYWORD_ONLY]
    assert keyword == ["mesh", "sp_mesh", "kv_quantized", "kv_bits", "spec_decode", "spec_k",
                       "spec_ngram", "graphs"]
    # graphs: the route of the port's device programs, which has no JAX counterpart
    assert port["graphs"].default is None
    keyword.remove("graphs")
    for name in keyword:
        assert port[name].default == inspect.signature(JaxInferencer.__init__).parameters[
            name].default, name
    gen_text = inspect.signature(InterleaveInferencer.gen_text).parameters
    assert gen_text["return_ctx"].kind == inspect.Parameter.KEYWORD_ONLY
    assert list(gen_text) == list(inspect.signature(JaxInferencer.gen_text).parameters)

    model = from_jax_params(
        jax.tree.map(np.asarray, init_params(1, CFG)),
        port_config(CFG), device="cpu")
    vae_t, vit_t = timaging.ImageTransform(32, 8, 8, 1024), timaging.ImageTransform(32, 8, 2, 1024)
    inf = InterleaveInferencer(model, None, {}, vae_t, vit_t, 3)
    assert inf.vae_transform is vae_t and inf.vit_transform is vit_t
    with pytest.raises(TypeError):
        InterleaveInferencer(model, None, {}, vae_t, vit_t, 3, None)


@pytest.fixture(scope="module")
def inferencers():
    """JAX and port inferencers, plain and spec (k 3, ngram 2), over one
    model of the chat config."""
    params = init_params(1, CFG)
    tok, ids, _ = add_special_tokens(FakeTokenizer())
    transform = ImageTransform(32, 8, 2, 1024)
    model = from_jax_params(jax.tree.map(np.asarray, params), port_config(CFG), device="cpu")
    ttok, tids, _ = ttokenizer.add_special_tokens(FakeTokenizer())
    out = {}
    for name, kw in (("plain", {}), ("spec", dict(spec_decode=True, spec_k=3, spec_ngram=2))):
        out["jax", name] = JaxInferencer(params, CFG, tok, ids, vit_transform=transform,
                                         **kw)
        out["torch", name] = InterleaveInferencer(
            model, ttok, tids, vit_transform=timaging.ImageTransform(32, 8, 2, 1024), **kw)
    return out


def assert_caches_equal(got, want):
    """tests/test_torch_serving.py's comparison (imported here, where that
    module, which imports this one, is complete)."""
    from tests.test_torch_serving import assert_caches_equal as same

    same(got, want)


class TestSpecAndKeptContext:
    def test_spec_chat(self, inferencers):
        images = [_image(2, 24, 28)]
        prompt = "what is this? what is this?"
        want = inferencers["jax", "spec"].chat(images, prompt, max_length=12)
        got = inferencers["torch", "spec"].chat(images, prompt, max_length=12)
        assert got == want == inferencers["torch", "plain"].chat(images, prompt, max_length=12)

    def test_gen_text_twice_on_one_context(self, inferencers):
        inf = inferencers["torch", "spec"]
        ctx = inf.update_context_text("describe the image", inf.init_gen_context())
        lens, hist = ctx.cache.lens.clone(), ctx.hist
        first = inf.gen_text(ctx, max_length=10)
        text, new = inf.gen_text(ctx, max_length=10, return_ctx=True)
        assert text == first == inf.gen_text(ctx, max_length=10)
        assert torch.equal(ctx.cache.lens, lens) and ctx.hist == hist
        assert new.cache.k is ctx.cache.k and int(new.cache.lens[0]) == int(lens[0]) + (
            new.kv_len - ctx.kv_len)

    @pytest.mark.parametrize("mode", ["plain", "spec"])
    def test_chat_turns(self, inferencers, mode):
        """Three turns, the first with an image: each answer and the kept
        context (kv length, rope, history, cache on [0, lens)) equal the
        JAX inferencer's; the second turn prefills only its own text."""
        jinf, tinf = inferencers["jax", mode], inferencers["torch", mode]
        jctx = tctx = None
        turns = [("what is this?", [_image(5, 20, 24)]), ("and the left side?", None),
                 ("what is this? and the left side?", None)]
        first = []  # (start position, valid rows) of each turn's first forward
        hook = tinf.model.language_model.model.register_forward_pre_hook(
            lambda m, args, kw: first.append((int(args[1][0, 0]), int(kw["q_valid"].sum()))),
            with_kwargs=True)
        try:
            for i, (prompt, images) in enumerate(turns):
                want, jctx = jinf.chat_turn(jctx, prompt, images=images, max_length=9)
                rope, n = (0, 0) if tctx is None else (tctx.rope, len(first))
                got, tctx = tinf.chat_turn(tctx, prompt, images=images, max_length=9)
                assert got == want
                assert (tctx.kv_len, tctx.rope, tctx.hist) == (jctx.kv_len, jctx.rope,
                                                              jctx.hist)
                assert_caches_equal(tctx.cache, jctx.cache)
                if i:  # a later turn prefills its own text only, after the kept answer
                    assert first[n] == (rope, len(tinf._encode_prompt(prompt)))
        finally:
            hook.remove()

    @pytest.mark.parametrize("mode,chunk", [("plain", 3), ("spec", 2)])
    def test_gen_text_stream(self, inferencers, mode, chunk):
        """The pieces concatenate to gen_text's answer (and the JAX stream's
        pieces are the same); the kept context equals the JAX stream's and
        gen_text(return_ctx=True)'s."""
        jinf, tinf = inferencers["jax", mode], inferencers["torch", mode]
        prompt = "a scan of the chest; a scan of the"
        tctx = tinf.update_context_text(prompt, tinf.init_gen_context())
        jctx = jinf.update_context_text(prompt, jinf.init_gen_context())
        jres, tres = {}, {}
        want = list(jinf.gen_text_stream(jctx, max_length=11, chunk=chunk, result=jres))
        got = list(tinf.gen_text_stream(tctx, max_length=11, chunk=chunk, result=tres))
        assert got == want and "".join(got) == tres["text"] == tinf.gen_text(tctx, max_length=11)
        text, kept = tinf.gen_text(tctx, max_length=11, return_ctx=True)
        for c in (tres["ctx"], kept):
            assert (c.kv_len, c.rope, c.hist) == (jres["ctx"].kv_len, jres["ctx"].rope,
                                                  jres["ctx"].hist)
            assert_caches_equal(c.cache, jres["ctx"].cache)

    def test_sampling_decodes_plainly(self, inferencers):
        """A sampling request with spec_decode takes the plain decode: the
        same draws give the same answer as the plain inferencer's."""
        spec, plain = inferencers["torch", "spec"], inferencers["torch", "plain"]
        answers = []
        for inf in (spec, plain):
            inf._generator.manual_seed(7)
            ctx = inf.update_context_text("sample me", inf.init_gen_context())
            answers.append(inf.gen_text(ctx, max_length=8, do_sample=True, temperature=0.8))
        assert answers[0] == answers[1]


@pytest.fixture(scope="module")
def gen_pair():
    params = init_params(0, GEN_CFG, llm2vae_zero=False)
    tok, new_token_ids, _ = add_special_tokens(FakeTokenizer())
    kw = dict(vae_transform=ImageTransform(32, 8, 8, 1024),
              vit_transform=ImageTransform(32, 8, 2, 1024), seed=0)
    jax_inf = JaxInferencer(params, GEN_CFG, tok, new_token_ids, **kw)
    model = from_jax_params(jax.tree.map(np.asarray, params), port_config(GEN_CFG), device="cpu")
    ttok, tids, _ = ttokenizer.add_special_tokens(FakeTokenizer())
    tkw = dict(vae_transform=timaging.ImageTransform(32, 8, 8, 1024),
               vit_transform=timaging.ImageTransform(32, 8, 2, 1024), seed=0)
    return jax_inf, InterleaveInferencer(model, ttok, tids, **tkw)


def _replay_jax_noise(jax_inf, torch_inf, monkeypatch):
    """The port's draws become the JAX inferencer's next draws: a copy of its
    key split in the same order; NCHW requests are the NHWC draw transposed.
    Returns the replayed key, in a list."""
    key = [jax_inf._rng]

    def randn(shape):
        key[0], sub = jax.random.split(key[0])
        if len(shape) == 4:
            n, c, h, w = shape
            a = np.asarray(jax.random.normal(sub, (n, h, w, c), jnp.float32)).transpose(0, 3, 1, 2)
        else:
            a = np.asarray(jax.random.normal(sub, shape, jnp.float32))
        return torch.from_numpy(np.array(a))

    monkeypatch.setattr(torch_inf, "_randn", randn)
    return key


GEN_KW = dict(image_shapes=(32, 32), num_timesteps=6)


class TestGeneration:
    @pytest.mark.parametrize("with_image", [False, True], ids=["text-to-image", "edit"])
    def test_latents_match_jax(self, gen_pair, monkeypatch, with_image):
        """interleave_inference up to the final latents: text only, and an
        image (VAE + ViT context) then an instruction."""
        jax_inf, torch_inf = gen_pair
        _replay_jax_noise(jax_inf, torch_inf, monkeypatch)
        monkeypatch.setattr(jax_inf, "decode_image", lambda latent, shape: latent)
        monkeypatch.setattr(torch_inf, "decode_image", lambda latent, shape: latent)
        inputs = ([_image(6, 24, 28)] if with_image else []) + ["a chest x-ray"]
        want = np.asarray(jax_inf.interleave_inference(inputs, **GEN_KW)[-1])
        got = torch_inf.interleave_inference(inputs, **GEN_KW)[-1]
        assert got.shape == want.shape == (16, GEN_CFG.patch_latent_dim)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)

    def test_first_velocity_int8_matches_jax(self, gen_pair, monkeypatch):
        """Full-int8 weights with fused projections and int8 KV caches through
        the text-to-image recipe for one flow step (2 timesteps: dt = 1, CFG
        on, three streams): the final latent is the noise minus the first
        post-CFG velocity. The JAX ``_mlp`` is held to the fused silu * mul *
        quant definition. Integer matmuls agree exactly; the rest is fp32 in
        another order: 1e-4, as the bf16-free generation tests."""
        jax_base, torch_base = gen_pair
        monkeypatch.setattr(jmot, "_FORCE_SILU_QUANT", True)
        kw = dict(bits=8, act_quant=True)
        llm = jquant.fuse_serving_projections(
            jquant.quantize_llm_params(jax_base.params["llm"], via_host=True, **kw))
        jax_inf = JaxInferencer(
            {**jax_base.params, "llm": llm}, GEN_CFG, jax_base.tokenizer,
            jax_base.new_token_ids, vae_transform=jax_base.vae_transform,
            vit_transform=jax_base.vit_transform, seed=0, kv_quantized=True)
        model = from_jax_params(jax.tree.map(np.asarray, jax_inf.params), port_config(GEN_CFG),
                                device="cpu")
        assert hasattr(model.language_model.model.layers[0].mlp_moe_gen, "gate_up_proj")
        torch_inf = InterleaveInferencer(
            model, torch_base.tokenizer, torch_base.new_token_ids,
            vae_transform=torch_base.vae_transform, vit_transform=torch_base.vit_transform,
            seed=0, kv_quantized=True)
        _replay_jax_noise(jax_inf, torch_inf, monkeypatch)
        noise = []
        replay = torch_inf._randn

        def recorded(shape):
            noise.append(replay(shape))
            return noise[-1]

        monkeypatch.setattr(torch_inf, "_randn", recorded)
        monkeypatch.setattr(jax_inf, "decode_image", lambda latent, shape: latent)
        monkeypatch.setattr(torch_inf, "decode_image", lambda latent, shape: latent)
        one_step = dict(image_shapes=(32, 32), num_timesteps=2)
        before = dict(aq.counts)
        want = np.asarray(jax_inf.interleave_inference(["a chest x-ray"], **one_step)[-1])
        got = torch_inf.interleave_inference(["a chest x-ray"], **one_step)[-1]
        assert aq.counts["plain"] > before["plain"]  # the gen expert's MLP took K3 too
        velocity = noise[-1].numpy() - got.numpy()  # dt = 1
        np.testing.assert_allclose(velocity, noise[-1].numpy() - want, rtol=1e-4, atol=1e-4)
        assert np.abs(velocity).max() > 1e-2  # a random velocity head: the step moved

    def test_call_image_matches_jax(self, gen_pair, monkeypatch):
        jax_inf, torch_inf = gen_pair
        _replay_jax_noise(jax_inf, torch_inf, monkeypatch)
        want = np.asarray(jax_inf(text="an axial CT slice", **GEN_KW)["image"])
        out = torch_inf(text="an axial CT slice", **GEN_KW)
        assert out["text"] is None and isinstance(out["image"], Image.Image)
        got = np.asarray(out["image"])
        assert got.shape == want.shape == (32, 32, 3)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1

    def test_uint8_array_edit_matches_pil(self, gen_pair, monkeypatch):
        _, torch_inf = gen_pair
        image = _image(7, 32, 32)
        monkeypatch.setattr(torch_inf, "decode_image", lambda latent, shape: latent)
        runs = []
        for item in (image, np.asarray(image)):
            monkeypatch.setattr(torch_inf, "_generator", torch.Generator().manual_seed(3))
            runs.append(torch_inf.interleave_inference([item, "sharper"], **GEN_KW)[-1])
        torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)

    def test_forks_do_not_share_storage(self, gen_pair):
        """Two forks of one context both append; neither sees the other's kv."""
        _, torch_inf = gen_pair
        base = torch_inf.update_context_text("shared", torch_inf.init_gen_context())
        first, second = base.fork(), base.fork()
        first = torch_inf.update_context_text("the first fork", first)
        kept = first.cache.k[..., : first.kv_len, :].clone()
        base_k = base.cache.k.clone()
        second = torch_inf.update_context_text("a second, longer fork", second)
        assert torch.equal(first.cache.k[..., : first.kv_len, :], kept)
        assert torch.equal(base.cache.k, base_k)
        assert not torch.equal(second.cache.k[..., : first.kv_len, :], kept)

    @pytest.mark.parametrize("size", [(640, 480), (100, 300), (2000, 2000)])
    def test_target_size_with_aspect_ratio(self, gen_pair, size):
        jax_inf, torch_inf = gen_pair
        assert (torch_inf._calculate_target_size_with_aspect_ratio(*size)
                == jax_inf._calculate_target_size_with_aspect_ratio(*size))

    def test_other_inference_versions_raise(self, gen_pair):
        """0 and 1 are the recipes (1, vqa-reconstruction, in
        tests/test_torch_recipes.py); any other raises, as in JAX."""
        jax_inf, torch_inf = gen_pair
        for inf in (jax_inf, torch_inf):
            with pytest.raises(ValueError, match="Unsupported inference_ver: 2"):
                inf(text="x", inference_ver=2)
