"""The vqa-reconstruction recipes of the port's ``InterleaveInferencer``
against the JAX package's, on the CPU: tests/test_pipeline.py's TINY config
with its VAE and a random velocity head, the same weights, fp32, the fake
tokenizer; the port's ``_randn`` replays the JAX inferencer's draws (the VAE
posterior samples of the image contexts and each image's initial noise, in
the same order), as ``TestGeneration`` in tests/test_torch_pipeline.py does,
with the key the JAX ``gen_text`` splits off for its decode split off too.

``_ver1`` answers from a VAE + ViT context, then generates each input image
again from the answer, feeding each generated image back (VAE only) into the
full and cfg_text contexts before the next; ``_ver0`` generates the first
image from a fresh context per image at CFG scales 7.0, ``_ver0_1`` every
image. The answers must be the same strings and the images within 1 per
uint8 pixel (the cast truncates), as the generation tests hold them.
"""

import jax
import numpy as np
import pytest
from PIL import Image

from tests.test_torch_pipeline import _image, _replay_jax_noise, gen_pair  # noqa: F401

# few flow steps, short answers: the CPU budget
RECIPE_KW = dict(reconstruct_image=True, max_think_token_n=6, num_timesteps=3)
IMAGES = [_image(21, 24, 28), _image(22, 32, 16)]
PROMPT = "what is abnormal here?"


def _replay(jax_inf, torch_inf, monkeypatch):
    """``_replay_jax_noise``, and the key the JAX ``gen_text`` splits off for
    its decode (a greedy one draws nothing from it; the port's draws nothing
    and splits nothing) split off the replayed key as well, so that the
    draws after an answer line up."""
    key = _replay_jax_noise(jax_inf, torch_inf, monkeypatch)
    gen_text = torch_inf.gen_text

    def gen_text_splitting(*args, **kw):
        key[0], _ = jax.random.split(key[0])
        return gen_text(*args, **kw)

    monkeypatch.setattr(torch_inf, "gen_text", gen_text_splitting)


def _assert_outputs_match(got, want, n_images):
    assert len(got) == len(want) == 1 + n_images
    assert isinstance(got[0], str) and got[0] == want[0] and got[0].strip()
    for g, w in zip(got[1:], want[1:]):
        assert isinstance(g, Image.Image) and g.size == w.size
        diff = np.abs(np.asarray(g).astype(int) - np.asarray(w).astype(int))
        assert diff.max() <= 1


@pytest.mark.parametrize("recipe,images,n_out", [
    ("interleave_inference_for_vqa_reconstruction_ver1", IMAGES[:1], 1),
    ("interleave_inference_for_vqa_reconstruction_ver1", IMAGES, 2),
    ("interleave_inference_for_vqa_reconstruction_ver0", IMAGES, 1),
    ("interleave_inference_for_vqa_reconstruction_ver0_1", IMAGES, 2),
], ids=["ver1", "ver1-two-images", "ver0", "ver0_1"])
def test_recipe_matches_jax(gen_pair, monkeypatch, recipe, images, n_out):  # noqa: F811
    """The answer, then ``n_out`` images at the inputs' aspect-preserving
    sizes; with two images ``_ver1`` feeds the first one back before the
    second."""
    jax_inf, torch_inf = gen_pair
    _replay(jax_inf, torch_inf, monkeypatch)
    want = getattr(jax_inf, recipe)(images + [PROMPT], **RECIPE_KW)
    got = getattr(torch_inf, recipe)(images + [PROMPT], **RECIPE_KW)
    _assert_outputs_match(got, want, n_out)
    for image, out in zip(images, got[1:]):
        h, w = torch_inf._calculate_target_size_with_aspect_ratio(*image.size)
        assert out.size == (w, h)


def test_call_inference_ver_1_matches_jax(gen_pair, monkeypatch):  # noqa: F811
    jax_inf, torch_inf = gen_pair
    _replay(jax_inf, torch_inf, monkeypatch)
    want = jax_inf(image=IMAGES[0], text=PROMPT, inference_ver=1, **RECIPE_KW)
    got = torch_inf(image=IMAGES[0], text=PROMPT, inference_ver=1, **RECIPE_KW)
    _assert_outputs_match([got["text"], got["image"]], [want["text"], want["image"]], 1)


def test_without_reconstruction_only_the_answer(gen_pair, monkeypatch):  # noqa: F811
    """``reconstruct_image=False`` (the default): the answer alone, equal to
    JAX's, no denoise; a uint8 array is taken as the PIL image it holds."""
    jax_inf, torch_inf = gen_pair
    _replay(jax_inf, torch_inf, monkeypatch)
    want = jax_inf.interleave_inference_for_vqa_reconstruction_ver1(
        [IMAGES[0], PROMPT], max_think_token_n=6)
    got = torch_inf.interleave_inference_for_vqa_reconstruction_ver1(
        [np.asarray(IMAGES[0]), PROMPT], max_think_token_n=6)
    assert got == want and len(got) == 1
