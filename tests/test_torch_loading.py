"""What remains of chat and loading (M0-M6) in the PyTorch port, against the
JAX package on the CPU, fp32:

- ``bagel.prefill_vit``, the exact-shape ViT prefill of one image, against
  the JAX function and against the port's bucketed prefill on the cache
  columns (as tests/test_pipeline.py:352): atol 1e-5;
- ``load_bagel_checkpoint(base_dir=...)`` on synthetic released-format files:
  the fine-tune's keys win, the rest come from the base, and the model equals
  a JAX ``load_bagel_checkpoint(base_dir=...)`` of the same files through
  ``from_jax_params``, bit for bit;
- the 2D ViT rope (``rope_2d_tables``, ``siglip._apply_rope_2d``): the
  encoder with ``rope=True`` against the JAX encoder, through K1a's route and
  the dense differentiable one: atol 1e-4, as tests/test_torch_model.py;
- the front ends ``scripts/interactive_vqa``, ``scripts/serve_http`` and
  ``scripts/interactive_image_generator``: ``--help``, the refusal of flags
  whose paths are not ported, the KV cache flags, a one-shot answer and the
  REPL of the VQA front end over the tiny model, and the image front end's
  text to image and edit (the reference's editing renorm) over the tiny
  generation model.

Time budget: about 20 s alone.
"""

import dataclasses
import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unimedvl_tpu.config import BagelConfig
from unimedvl_tpu.data.imaging import position_ids_extrapolate
from unimedvl_tpu.models import bagel as jbagel
from unimedvl_tpu.models import siglip as jsiglip
from unimedvl_tpu.ops import rope as jrope
from unimedvl_tpu.weights import bagel_loader as jloader
from unimedvl_tpu_torch.models import bagel
from unimedvl_tpu_torch.ops import rope
from unimedvl_tpu_torch.scripts import (
    common, interactive_image_generator, interactive_vqa, serve_http,
)
from unimedvl_tpu_torch.weights import loader

from tests.test_torch_config import init_params, port_config
from tests.test_torch_model import released_ckpt  # noqa: F401
from tests.test_torch_pipeline import CFG, _image, pair  # noqa: F401


def test_prefill_vit_matches_jax_and_the_bucketed_prefill(pair):  # noqa: F811
    jax_inf, torch_inf = pair
    img = _image(5, 24, 28)
    arr = np.asarray(torch_inf._vit_resized_u8(img), np.uint8)
    H, W = arr.shape[:2]
    pos = position_ids_extrapolate(H, W, CFG.vit.patch_size, CFG.vit_max_num_patch_per_side)
    want = jbagel.prefill_vit(
        jax_inf.params, CFG, jax_inf.init_gen_context().cache,
        jbagel.preprocess_vit_image(CFG, jnp.asarray(arr)), jnp.asarray(pos)[None],
        jax_inf._start_end(), jnp.asarray([0], jnp.int32))
    tokens = bagel.preprocess_vit_image(torch_inf.cfg, torch.from_numpy(arr.copy()))
    got = bagel.prefill_vit(torch_inf.model, torch_inf.init_gen_context().cache, tokens,
                            torch.from_numpy(pos)[None], torch_inf._start_end(),
                            torch.tensor([0]))
    n = tokens.shape[1] + 2
    bucketed = torch_inf.update_context_image(img, torch_inf.init_gen_context(), vae=False)
    assert int(got.lens[0]) == int(want.lens[0]) == int(bucketed.cache.lens[0]) == n
    for name in ("k", "v"):
        mine = getattr(got, name)[:, 0, :, :n]
        np.testing.assert_allclose(mine.numpy(), np.asarray(getattr(want, name))[:, 0, :, :n],
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(getattr(bucketed.cache, name)[:, 0, :, :n], mine,
                                   rtol=1e-5, atol=1e-5)


def test_base_checkpoint_merge_matches_jax(released_ckpt, tmp_path):  # noqa: F811
    """A fine-tune directory holding three keys over the released base: the
    merged model takes those three from the fine-tune and every other weight
    from the base, and equals the JAX loader's merge."""
    from safetensors.numpy import load_file, save_file

    base = load_file(str(released_ckpt / "ema.safetensors"))
    changed = ["language_model.model.embed_tokens.weight",
               "vit_model.vision_model.encoder.layers.0.mlp.fc1.weight",
               "connector.fc2.bias"]
    save_file({k: base[k] * 2.0 + 1.0 for k in changed}, str(tmp_path / "ema.safetensors"))
    cfg = BagelConfig.from_checkpoint_dir(str(released_ckpt), max_latent_size=4,
                                          vit_max_num_patch_per_side=4)
    jparams = jloader.load_bagel_checkpoint(str(tmp_path), cfg, dtype=jnp.float32,
                                            base_dir=str(released_ckpt))
    want = loader.from_jax_params(jax.tree.map(np.asarray, jparams), port_config(cfg),
                                  device="cpu").state_dict()
    got = loader.load_bagel_checkpoint(str(tmp_path), port_config(cfg), device="cpu",
                                       dtype=torch.float32, base_dir=str(released_ckpt))
    got = got.state_dict()
    plain = loader.load_bagel_checkpoint(str(released_ckpt), port_config(cfg), device="cpu",
                                         dtype=torch.float32).state_dict()
    assert got.keys() == want.keys()
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert {k for k in got if not torch.equal(got[k], plain[k])} == set(changed)
    with pytest.raises(FileNotFoundError):
        loader.load_bagel_checkpoint(str(tmp_path), port_config(cfg), device="cpu",
                                     base_dir=str(tmp_path / "nowhere"))


# ---------------------------------------------------------------------------
# the 2D ViT rope
# ---------------------------------------------------------------------------

ROPE_CFG = dataclasses.replace(CFG, vit=dataclasses.replace(CFG.vit, rope=True))


def test_rope_2d_tables_match_jax():
    want = jrope.rope_2d_tables(8, 5, 7)
    got = rope.rope_2d_tables(8, 5, 7)
    assert [t.shape for t in got] == [(35, 8)] * 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dense", [False, True], ids=["k1a-route", "dense"])
def test_vit_with_2d_rope_matches_jax(dense):
    """The tiny ViT with ``rope=True`` (no position table; q and k rotated
    by the 2D tables before attention), 20 of 32 tokens valid, raster ids
    from the 16 x 16 grid."""
    params = init_params(2, ROPE_CFG)
    assert "position_embedding" not in params["vit"]
    model = loader.from_jax_params(jax.tree.map(np.asarray, params), port_config(ROPE_CFG),
                                   device="cpu")
    assert not hasattr(model.vit_model.vision_model.embeddings, "position_embedding")
    rng = np.random.default_rng(0)
    tokens = rng.standard_normal((1, 32, 12)).astype(np.float32)
    pos = np.zeros((1, 32), np.int64)
    pos[0, :20] = rng.permutation(ROPE_CFG.vit.num_patches_per_side ** 2)[:20]
    valid = (np.arange(32) < 20)[None]
    want = jsiglip.forward(params["vit"], ROPE_CFG.vit, *map(jnp.asarray, (tokens, pos, valid)))
    got = model.vit_model(*map(torch.from_numpy, (tokens, pos, valid)), dense_attention=dense)
    np.testing.assert_allclose(got[0, :20].numpy(), np.asarray(want)[0, :20], rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# the front ends
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("script,base", [
    pytest.param(interactive_vqa, [], id="vqa"),
    pytest.param(serve_http, [], id="serve"),
    pytest.param(interactive_image_generator, ["--prompt", "p"], id="image"),
])
def test_help_and_unported_flags(script, base, capsys):
    """``--help``; ``--tp`` / ``--dp`` above 1 parse for every front end, the
    HTTP server's included (a mesh under torchrun; the server fans each
    round's requests out to every rank); the image front end's ``--sp`` parses with ``--tp`` and
    exits with ``--dp``; ``--int4-kv`` (refused until the int4 cache was
    ported) now asks for int4 caches."""
    with pytest.raises(SystemExit) as e:
        script.parse_args(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    for flag in ("--checkpoint", "--base-checkpoint", "--int8-kv", "--int4-kv", "--act-int8",
                 "--w4", "--device"):
        assert flag in out
    for argv in [["--tp", "2"], ["--dp", "2"]]:
        args = script.parse_args(["--checkpoint", "x"] + base + argv)
        assert (args.tp, args.dp) == ((2, 1) if argv[0] == "--tp" else (1, 2))
    if script is interactive_image_generator:
        args = script.parse_args(["--checkpoint", "x"] + base + ["--tp", "2", "--sp", "2"])
        assert (args.tp, args.sp) == (2, 2)
        with pytest.raises(SystemExit) as e:
            script.parse_args(["--checkpoint", "x"] + base + ["--dp", "2", "--sp", "2"])
        assert "--sp" in str(e.value.code)
    args = script.parse_args(["--checkpoint", "x"] + base)
    assert args.device == "cuda"
    assert common.kv_options(args) == dict(kv_quantized=False, kv_bits=8)
    for argv in (["--int4-kv"], ["--int8-kv", "--int4-kv"]):
        args = script.parse_args(["--checkpoint", "x"] + base + argv)
        assert common.kv_options(args) == dict(kv_quantized=True, kv_bits=4)
    args = script.parse_args(["--checkpoint", "x", "--int8-kv"] + base)
    assert common.kv_options(args) == dict(kv_quantized=True, kv_bits=8)


def test_serve_http_flags():
    args = serve_http.parse_args(["--checkpoint", "x", "--t2i", "--gen-chunk", "5",
                                  "--gen-group", "2", "--slots", "4", "--spec"])
    assert (args.t2i, args.gen_chunk, args.gen_group, args.slots, args.spec) == (
        True, 5, 2, 4, True)
    with pytest.raises(SystemExit) as e:
        serve_http.parse_args(["--checkpoint", "x", "--dynamic-windows"])
    assert "step_range" in str(e.value.code)


def test_common_load_quantizes_and_fuses(released_ckpt, monkeypatch):  # noqa: F811
    """``--int8 --w4 --fused`` on the synthetic checkpoint: a weight-only w4
    model with fused projections, equal to quantizing a plain load (fp32 on
    the CPU, as the front ends load there)."""
    from unimedvl_tpu_torch import quant
    from unimedvl_tpu_torch.config import BagelConfig as TBagelConfig
    from unimedvl_tpu_torch.data import tokenizer as ttokenizer

    monkeypatch.setattr(ttokenizer, "load_tokenizer",
                        lambda path: ttokenizer.add_special_tokens(ttokenizer.ByteTokenizer()))
    from_dir = TBagelConfig.from_checkpoint_dir  # the synthetic files' position tables: 4 x 4
    monkeypatch.setattr(TBagelConfig, "from_checkpoint_dir", classmethod(
        lambda cls, d: from_dir(d, max_latent_size=4, vit_max_num_patch_per_side=4)))
    args = interactive_vqa.parse_args(["--checkpoint", str(released_ckpt), "--device", "cpu",
                                       "--int8", "--w4", "--fused"])
    model, tok, ids = common.load(args)
    attn = model.language_model.model.layers[0].self_attn
    assert hasattr(attn, "qkv_proj") and attn.qkv_proj.mode == quant.mode_name(4, False)
    assert set(ids) == {"bos_token_id", "eos_token_id", "start_of_image", "end_of_image"}
    want = loader.load_bagel_checkpoint(str(released_ckpt), device="cpu", dtype=torch.float32,
                                        quantize_bits=4)
    quant.fuse_serving_projections(want.language_model)
    assert torch.equal(attn.qkv_proj.weight_q,
                       want.language_model.model.layers[0].self_attn.qkv_proj.weight_q)


def test_interactive_vqa_answers(pair, monkeypatch, capsys):  # noqa: F811
    """One-shot flags and the REPL over the tiny model: the printed answers
    are ``chat``'s."""
    from PIL import Image

    _jax_inf, torch_inf = pair
    monkeypatch.setattr(interactive_vqa, "build", lambda args: torch_inf)
    image_path = "/dev/null"
    img = _image(8, 20, 24)
    monkeypatch.setattr(Image, "open", lambda p: img)
    want = torch_inf.chat([img], "what is this?", max_length=6)
    interactive_vqa.main(["--checkpoint", "x", "--image", image_path, "--prompt",
                          "what is this?", "--max-length", "6"])
    assert capsys.readouterr().out.rstrip().endswith(want)
    text_only = torch_inf.gen_text(torch_inf.update_context_text(
        "and now?", torch_inf.init_gen_context()), max_length=6)
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        f"/image {image_path}\nwhat is this?\n/clear\nand now?\n/quit\n"))
    interactive_vqa.main(["--checkpoint", "x", "--max-length", "6"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[")]
    assert len(lines) == 2 and lines[0].endswith(want) and lines[1].endswith(text_only)
    interactive_vqa.main(["--checkpoint", "x", "--prompt", "and now?", "--max-length", "6",
                          "--stream"])
    assert capsys.readouterr().out.startswith(text_only)


def test_image_generator_edit_takes_the_editing_renorm():
    """An edit with the default (global) renorm switches to text_channel on
    (0.0, 1.0] (interactive_image_generator.py:365-371); text to image and an
    edit with another renorm keep the flags'."""
    parse = interactive_image_generator.parse_args
    t2i = interactive_image_generator.recipe(parse(["--checkpoint", "x", "--prompt", "p"]))
    assert (t2i["cfg_renorm_type"], t2i["cfg_interval"]) == ("global", (0.4, 1.0))
    assert t2i["image_shapes"] == (512, 512) and t2i["num_timesteps"] == 50
    edit = interactive_image_generator.recipe(parse(
        ["--checkpoint", "x", "--prompt", "p", "--image", "in.png", "--size", "32"]))
    assert (edit["cfg_renorm_type"], edit["cfg_interval"]) == ("text_channel", (0.0, 1.0))
    assert edit["image_shapes"] == (32, 32)
    kept = interactive_image_generator.recipe(parse(
        ["--checkpoint", "x", "--prompt", "p", "--image", "in.png", "--renorm", "channel"]))
    assert (kept["cfg_renorm_type"], kept["cfg_interval"]) == ("channel", (0.4, 1.0))


@pytest.mark.parametrize("edit", [False, True], ids=["text-to-image", "edit"])
def test_image_generator_saves_the_recipes_image(edit, monkeypatch, tmp_path, capsys):
    """``main`` over the tiny generation model (random weights, its VAE):
    the saved PNG is ``interleave_inference``'s image for the flags' recipe on
    the same seed."""
    from PIL import Image

    from tests.test_pipeline import TINY
    from unimedvl_tpu_torch.data import imaging as timaging
    from unimedvl_tpu_torch.data import tokenizer as ttokenizer
    from unimedvl_tpu_torch.inference import InterleaveInferencer
    from tests.test_torch_pipeline import FakeTokenizer

    model = bagel.Bagel(port_config(TINY), device="cpu", dtype=torch.float32, with_vae=True)
    bagel.init_random_(model, torch.Generator().manual_seed(3), llm2vae_zero=False)
    tok, ids, _ = ttokenizer.add_special_tokens(FakeTokenizer())

    def build(args):
        return InterleaveInferencer(
            model, tok, ids, vae_transform=timaging.ImageTransform(32, 8, 8, 1024),
            vit_transform=timaging.ImageTransform(32, 8, 2, 1024), seed=args.seed)

    monkeypatch.setattr(interactive_image_generator, "build", build)
    src = tmp_path / "in.png"
    _image(9, 32, 32).save(src)
    out = tmp_path / "out.png"
    argv = ["--checkpoint", "x", "--prompt", "a chest x-ray", "--size", "32", "--steps", "3",
            "--out", str(out)] + (["--image", str(src)] if edit else [])
    interactive_image_generator.main(argv)
    assert "saved" in capsys.readouterr().out
    args = interactive_image_generator.parse_args(argv)
    inputs = ([Image.open(src)] if edit else []) + ["a chest x-ray"]
    want = build(args).interleave_inference(inputs, **interactive_image_generator.recipe(args))
    np.testing.assert_array_equal(np.asarray(Image.open(out)), np.asarray(want[-1]))
