"""``InterleaveInferencer`` of the PyTorch port against the JAX package's, on
the CPU: the tiny config and fake tokenizer of tests/test_pipeline.py, the
same weights (``from_jax_params``), fp32. Answers must be the same strings.

Generation runs on the tiny config with its VAE and a random velocity head;
the port's ``_randn`` replays the JAX inferencer's draws (a copy of its key,
split in the same order), so both start from the same noise. Latents agree
within 1e-4 (a few layers and flow steps in fp32, sums in another order);
decoded images within 1 per uint8 pixel (the cast truncates).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from unimedvl_tpu.config import BagelConfig, LLMConfig, ViTConfig
from unimedvl_tpu.data.imaging import ImageTransform
from unimedvl_tpu.data.tokenizer import add_special_tokens
from unimedvl_tpu.inference import InterleaveInferencer as JaxInferencer
from unimedvl_tpu.models import bagel as jbagel
from unimedvl_tpu_torch.inference import InterleaveInferencer
from unimedvl_tpu_torch.weights.loader import from_jax_params

from tests.test_pipeline import TINY as GEN_CFG

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
    params = jbagel.init_params(jax.random.PRNGKey(1), CFG)
    tok, new_token_ids, _ = add_special_tokens(FakeTokenizer())
    transform = ImageTransform(32, 8, 2, 1024)
    jax_inf = JaxInferencer(params, CFG, tok, new_token_ids, vit_transform=transform)
    model = from_jax_params(jax.tree.map(np.asarray, params), CFG)
    torch_inf = InterleaveInferencer(model, tok, new_token_ids, vit_transform=transform)
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



@pytest.fixture(scope="module")
def gen_pair():
    params = jbagel.init_params(jax.random.PRNGKey(0), GEN_CFG, llm2vae_zero=False)
    tok, new_token_ids, _ = add_special_tokens(FakeTokenizer())
    kw = dict(vae_transform=ImageTransform(32, 8, 8, 1024),
              vit_transform=ImageTransform(32, 8, 2, 1024), seed=0)
    jax_inf = JaxInferencer(params, GEN_CFG, tok, new_token_ids, **kw)
    model = from_jax_params(jax.tree.map(np.asarray, params), GEN_CFG)
    return jax_inf, InterleaveInferencer(model, tok, new_token_ids, **kw)


def _replay_jax_noise(jax_inf, torch_inf, monkeypatch):
    """The port's draws become the JAX inferencer's next draws: a copy of its
    key split in the same order; NCHW requests are the NHWC draw transposed."""
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
        _, torch_inf = gen_pair
        with pytest.raises(NotImplementedError, match="later slice"):
            torch_inf(text="x", inference_ver=1)
