"""Models and weights of the PyTorch port against the JAX package, on the CPU.

Both packages hold the same weights: the JAX tree from ``bagel.init_params``
goes into the port through ``from_jax_params``. The same numpy inputs go
through both. Everything runs in fp32; outputs agree within atol 1e-4
(sums over a few layers taken in another order), greedy tokens exactly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unimedvl_tpu.config import BagelConfig, LLMConfig, ViTConfig
from unimedvl_tpu.models import bagel as jbagel
from unimedvl_tpu.models import qwen2_mot as jmot
from unimedvl_tpu.models import siglip as jsiglip
from unimedvl_tpu.weights import bagel_loader as jloader
from unimedvl_tpu_torch.models import bagel, qwen2_mot
from unimedvl_tpu_torch.models.qwen2_mot import KVCache
from unimedvl_tpu_torch.weights import loader

from tests.test_weights import CFG as CKPT_CFG, synthetic_state_dict

TOL = dict(rtol=1e-4, atol=1e-4)

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
    visual_gen=False,  # the gen-side weights are covered by TestLoader
    vit_max_num_patch_per_side=16,
)


@pytest.fixture(scope="module")
def pair():
    params = jbagel.init_params(jax.random.PRNGKey(0), CFG)
    model = loader.from_jax_params(jax.tree.map(np.asarray, params), CFG)
    return params, model


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def _vit_inputs(rng, T=32, n=20):
    tokens = rng.standard_normal((1, T, 3 * 2 * 2)).astype(np.float32)
    pos = np.zeros((1, T), np.int64)
    pos[0, :n] = rng.permutation(CFG.vit.num_patches_per_side**2)[:n]
    valid = (np.arange(T) < n)[None]
    return tokens, pos, valid


class TestVision:
    def test_siglip_forward(self, pair):
        params, model = pair
        tokens, pos, valid = _vit_inputs(np.random.default_rng(0))
        want = jsiglip.forward(params["vit"], CFG.vit, *map(jnp.asarray, (tokens, pos, valid)))
        got = model.vit_model(*map(torch.from_numpy, (tokens, pos, valid)))
        _close(got[0, :20], np.asarray(want)[0, :20])

    def test_encode_vit_tokens(self, pair):
        params, model = pair
        tokens, pos, valid = _vit_inputs(np.random.default_rng(1))
        want = jbagel.encode_vit_tokens(params, CFG, *map(jnp.asarray, (tokens, pos, valid)))
        got = bagel.encode_vit_tokens(model, *map(torch.from_numpy, (tokens, pos, valid)))
        _close(got[0, :20], np.asarray(want)[0, :20])


def _prefill_both(params, model, rng):
    """A causal text block (11 of 16 rows valid), then a non-causal image-like
    block (9 of 12 valid) after it, through both packages."""
    L, Hk, D = CFG.llm.num_hidden_layers, CFG.llm.num_key_value_heads, CFG.llm.head_dim
    jcache = jmot.KVCache.create(L, 1, 64, Hk, D, jnp.float32)
    tcache = KVCache.create(L, 1, 64, Hk, D, torch.float32)
    outs = []
    rope = 0
    for T, n, causal in ((16, 11, True), (12, 9, False)):
        x = rng.standard_normal((1, T, CFG.llm.hidden_size)).astype(np.float32)
        pos = np.full((1, T), rope, np.int64)
        if causal:
            pos[0, :n] = np.arange(rope, rope + n)
        valid = (np.arange(T) < n)[None]
        jh, jcache = jmot.forward(
            params["llm"], CFG.llm, jnp.asarray(x), jnp.asarray(pos), jcache,
            jmot.ForwardSpec("und", causal, True), q_valid=jnp.asarray(valid),
        )
        th, tcache = model.language_model.model(
            torch.from_numpy(x), torch.from_numpy(pos), tcache, causal=causal,
            q_valid=torch.from_numpy(valid),
        )
        outs.append((jh, th, n))
        rope = rope + n if causal else rope + 1
    return jcache, tcache, outs, rope


class TestLanguageModel:
    def test_prefill_hidden_logits_and_cache(self, pair):
        params, model = pair
        jcache, tcache, outs, _ = _prefill_both(params, model, np.random.default_rng(2))
        for jh, th, n in outs:
            _close(th[0, :n], np.asarray(jh)[0, :n])
            _close(qwen2_mot.lm_head(model.language_model, th[:, :n]),
                   jmot.lm_head(params["llm"], jh[:, :n]))
        np.testing.assert_array_equal(tcache.lens.numpy(), np.asarray(jcache.lens))
        n = int(tcache.lens[0])
        _close(tcache.k[:, :, :, :n], np.asarray(jcache.k)[:, :, :, :n])
        _close(tcache.v[:, :, :, :n], np.asarray(jcache.v)[:, :, :, :n])

    def test_generate_text_greedy_tokens(self, pair):
        params, model = pair
        jcache, tcache, _, rope = _prefill_both(params, model, np.random.default_rng(3))
        lens_before = tcache.lens.clone()
        want, want_len = jbagel.generate_text(
            params, CFG, jcache, jnp.asarray([256], jnp.int32), jnp.asarray([rope], jnp.int32),
            10, jnp.asarray(257, jnp.int32), False, 1.0, jax.random.PRNGKey(1),
        )
        got, got_len = bagel.generate_text(
            model, tcache, torch.tensor([256]), torch.tensor([rope]), 10, 257,
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
        assert torch.equal(tcache.lens, lens_before)  # decode never advances lens


@pytest.fixture(scope="module")
def released_ckpt(tmp_path_factory):
    """A tiny checkpoint in the released format: configs as they ship
    (pre-override values) and ema.safetensors with reference names."""
    from safetensors.numpy import save_file

    path = tmp_path_factory.mktemp("torch_ckpt")
    l, v = CKPT_CFG.llm, CKPT_CFG.vit
    (path / "llm_config.json").write_text(json.dumps({
        "vocab_size": l.vocab_size, "hidden_size": l.hidden_size,
        "intermediate_size": l.intermediate_size,
        "num_hidden_layers": l.num_hidden_layers,
        "num_attention_heads": l.num_attention_heads,
        "num_key_value_heads": l.num_key_value_heads,
        "rope_theta": 10000.0, "tie_word_embeddings": True,
    }))
    (path / "vit_config.json").write_text(json.dumps({
        "hidden_size": v.hidden_size, "intermediate_size": v.intermediate_size,
        "num_hidden_layers": v.num_hidden_layers + 1,
        "num_attention_heads": v.num_attention_heads,
        "image_size": v.image_size, "patch_size": v.patch_size, "rope": True,
    }))
    sd = synthetic_state_dict(CKPT_CFG)
    # the dropped last ViT layer ships in the file too
    extra = f"vit_model.vision_model.encoder.layers.{v.num_hidden_layers}.mlp.fc1.weight"
    sd[extra] = np.ones((v.intermediate_size, v.hidden_size), np.float32)
    save_file(sd, str(path / "ema.safetensors"))
    return path


class TestLoader:
    def test_checkpoint_matches_from_jax_params(self, released_ckpt):
        cfg = BagelConfig.from_checkpoint_dir(
            str(released_ckpt), max_latent_size=4, vit_max_num_patch_per_side=4
        )
        assert cfg.vit.num_hidden_layers == CKPT_CFG.vit.num_hidden_layers
        jparams = jloader.load_bagel_checkpoint(str(released_ckpt), cfg, dtype=jnp.float32)
        want = loader.from_jax_params(jax.tree.map(np.asarray, jparams), cfg).state_dict()
        got = loader.load_bagel_checkpoint(
            str(released_ckpt), cfg, dtype=torch.float32
        ).state_dict()
        assert got.keys() == want.keys()
        for key in want:
            assert torch.equal(got[key], want[key]), key
