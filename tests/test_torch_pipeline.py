"""``InterleaveInferencer`` of the PyTorch port against the JAX package's, on
the CPU: the tiny config and fake tokenizer of tests/test_pipeline.py, the
same weights (``from_jax_params``), fp32. Answers must be the same strings."""

import jax
import numpy as np
import pytest
from PIL import Image

from unimedvl_tpu.config import BagelConfig, LLMConfig, ViTConfig
from unimedvl_tpu.data.imaging import ImageTransform
from unimedvl_tpu.data.tokenizer import add_special_tokens
from unimedvl_tpu.inference import InterleaveInferencer as JaxInferencer
from unimedvl_tpu.models import bagel as jbagel
from unimedvl_tpu_torch.inference import InterleaveInferencer
from unimedvl_tpu_torch.weights.loader import from_jax_params

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

    def test_gen_side_raises_naming_the_slice(self, pair):
        _, torch_inf = pair
        with pytest.raises(NotImplementedError, match="M7"):
            torch_inf.update_context_image(_image(5, 8, 8), torch_inf.init_gen_context())
