"""The port's LoRA fine-tuning against the JAX package's, on the CPU in fp32
(TINY config): adapters carried over by ``from_jax_params``, step-0 identity,
runtime adapter math equal to merged weights, the adapter-only step against
``make_lora_train_step`` for two steps with the base bit-identical, and the
refusals (merging into a quantized base, fusing unmerged adapters).

Tolerances: losses 1e-5 absolute; adapter leaves after two AdamW steps 1e-5;
merged against runtime 1e-5 (the same low-rank product summed in another
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unimedvl_tpu.models import bagel as jbagel
from unimedvl_tpu.training import lora as jlora
from unimedvl_tpu_torch import quant
from unimedvl_tpu_torch.models import bagel
from unimedvl_tpu_torch.models.layers import LoRALinear
from unimedvl_tpu_torch.training import lora

from tests.test_torch_config import init_params, port_config
from tests.test_torch_train import (
    CFG, LOSS_TOL, PARAM_TOL, _jax_train_forward, _replay_batch_noise, _stacked, jax_batch,
    jax_state_dict, make_batch, port_model, replay_noise,
)


def _randomize_b(params, seed=7):
    """lora_b starts at zero; give it values so the adapters matter."""
    k = [jax.random.PRNGKey(seed)]

    def walk(path, x):
        if path and getattr(path[-1], "key", None) == "lora_b":
            k[0], sub = jax.random.split(k[0])
            return jax.random.normal(sub, x.shape, jnp.float32).astype(x.dtype) * 0.1
        return x

    return jax.tree_util.tree_map_with_path(walk, params)


@pytest.fixture(scope="module")
def jparams():
    base = init_params(0, CFG, llm2vae_zero=False)
    return _randomize_b(jlora.add_lora(base, jax.random.PRNGKey(3), rank=4, alpha=8.0,
                                       dtype=jnp.float32))


class TestAdapters:
    def test_loader_carries_the_adapters(self, jparams):
        model = port_model(jparams)
        attn = model.language_model.model.layers[1].self_attn
        assert isinstance(attn.q_proj_moe_gen, LoRALinear) and attn.q_proj.rank == 4
        leaf = jparams["llm"]["layers"]["attn"]["q_gen"]
        np.testing.assert_array_equal(attn.q_proj_moe_gen.lora_a.detach().numpy(),
                                      np.asarray(leaf["lora_a"])[1].T)
        np.testing.assert_array_equal(attn.q_proj_moe_gen.lora_b.detach().numpy(),
                                      np.asarray(leaf["lora_b"])[1].T)
        assert float(attn.q_proj_moe_gen.lora_s) == float(leaf["lora_s"][1]) == 2.0
        assert lora.has_lora(model) and jlora.has_lora(jparams)
        assert lora.count_lora_params(model) == jlora.count_lora_params(jparams)

    @pytest.mark.parametrize("targets,experts", [
        (lora.TARGETS_ALL, ("und", "gen")), (("q", "v"), ("gen",)), (("down",), ("und",))])
    def test_add_lora_sites_and_step0_identity(self, targets, experts):
        base = init_params(0, CFG, llm2vae_zero=False)
        want = jlora.add_lora(base, jax.random.PRNGKey(1), rank=4, targets=targets,
                              experts=experts)
        batch, key = make_batch(), jax.random.PRNGKey(2)
        model = port_model(base)
        before = bagel.train_forward(model, batch, noise=replay_noise(key, batch))["loss"]
        lora.add_lora(model, torch.Generator().manual_seed(0), rank=4, targets=targets,
                      experts=experts, dtype=torch.float32)
        assert lora.count_lora_params(model) == jlora.count_lora_params(want)
        after = bagel.train_forward(model, batch, noise=replay_noise(key, batch))["loss"]
        assert float(before) == float(after)  # lora_b = 0
        a = next(m for m in model.modules() if isinstance(m, LoRALinear)).lora_a
        assert abs(float(a.std()) * a.shape[1] ** 0.5 - 1.0) < 0.3  # ~ N(0, 1/in)

    def test_label_counts_match(self, jparams):
        model = port_model(jparams)
        labels = lora.lora_labels(model)
        jlabels = jax.tree_util.tree_leaves(jlora.lora_labels(jparams))
        L = CFG.llm.num_hidden_layers
        # a stacked JAX adapter leaf is one port leaf per layer
        assert sum(v == "train" for v in labels.values()) == L * jlabels.count("train")
        assert all(n.endswith(("lora_a", "lora_b")) for n, v in labels.items() if v == "train")

    def test_runtime_equals_merged(self, jparams):
        batch, key = make_batch(), jax.random.PRNGKey(4)
        want = _jax_train_forward(jparams, CFG, jax_batch(batch), key)
        model = port_model(jparams)
        noise = replay_noise(key, batch)
        runtime = bagel.train_forward(model, batch, noise=noise)
        assert abs(float(runtime["loss"]) - float(want["loss"])) <= LOSS_TOL
        lora.merge_lora(model)
        assert not lora.has_lora(model)
        merged = bagel.train_forward(model, batch, noise=noise)
        assert abs(float(merged["loss"]) - float(runtime["loss"])) <= LOSS_TOL
        jmerged = jax_state_dict(jlora.merge_lora(jparams))
        for name, p in model.named_parameters():
            if not name.startswith("vae_model."):
                np.testing.assert_allclose(p.detach().numpy(), jmerged[name], rtol=PARAM_TOL,
                                           atol=PARAM_TOL, err_msg=name)

    def test_refusals(self, jparams):
        model = port_model(jparams)
        with pytest.raises(ValueError, match="merge_lora"):
            quant.fuse_serving_projections(model.language_model)
        with pytest.raises(ValueError, match="already carries"):
            lora.add_lora(model, torch.Generator(), rank=4)
        with pytest.raises(ValueError, match="unknown lora targets"):
            lora.add_lora(model, torch.Generator(), targets=("qkv",))
        # adapters ride a quantized base (QLoRA, tests/test_torch_qlora.py); a quantized
        # base cannot absorb them
        quant.quantize_llm_params(model.language_model)
        assert model.language_model.model.layers[0].self_attn.q_proj.mode == "q"
        with pytest.raises(ValueError, match="quantized base"):
            lora.merge_lora(model)
        plain = port_model(init_params(0, CFG))
        with pytest.raises(ValueError, match="no adapters"):
            lora.make_lora_train_step(port_config(CFG), plain)
        quant.quantize_llm_params(plain.language_model)
        lora.add_lora(plain, torch.Generator(), rank=4, dtype=torch.float32)
        assert plain.language_model.model.layers[0].mlp.down_proj.mode == "q"


class TestLoRAStep:
    def test_two_steps_against_the_jax_lean_step(self, jparams):
        stacked = _stacked()
        keys = [jax.random.PRNGKey(20), jax.random.PRNGKey(21)]
        jstep, adapters, opt_state, base, combine = jlora.make_lora_train_step(
            CFG, jax.tree.map(jnp.array, jparams))
        want_losses = []
        for key in keys:
            adapters, opt_state, loss = jstep(adapters, opt_state, base, jax_batch(stacked), key)
            want_losses.append(float(loss))
        want = jax_state_dict(combine(adapters, base))

        model = port_model(jparams)
        frozen = {n: p.detach().clone() for n, p in model.named_parameters()
                  if not n.endswith(("lora_a", "lora_b"))}
        step, state = lora.make_lora_train_step(port_config(CFG), model)
        assert len(state.optimizer.param_groups[0]["params"]) == \
            sum(v == "train" for v in lora.lora_labels(model).values())
        losses = []
        for key in keys:
            state, loss = step(state, stacked, noises=_replay_batch_noise(key, stacked))
            losses.append(float(loss))
        np.testing.assert_allclose(losses, want_losses, rtol=0, atol=LOSS_TOL)
        moved = 0
        for name, p in model.named_parameters():
            if name in frozen:
                assert torch.equal(p, frozen[name]), name  # the base is bit-identical
                assert p.grad is None, name  # and got no gradient
            else:
                np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=PARAM_TOL,
                                           atol=PARAM_TOL, err_msg=name)
                moved += 1
        assert moved == 2 * 2 * 14  # layers x (a, b) x (4 attn x 2 experts + 3 mlp x 2)
        assert float(model.language_model.model.layers[0].mlp.up_proj.lora_s) == 2.0

    def test_adapters_serve_unfused_inference(self, jparams):
        """A LoRALinear is called wherever the projection is: the und-mode
        prefill sees the adapter, and equals the merged model's."""
        from unimedvl_tpu_torch.models.qwen2_mot import KVCache

        model = port_model(jparams)
        lm, c = model.language_model, CFG.llm
        ids = torch.tensor([[5, 9, 3, 7]])
        pos = torch.arange(4)[None]

        def hidden():
            cache = KVCache.create(c.num_hidden_layers, 1, 8, c.num_key_value_heads, c.head_dim,
                                   dtype=torch.float32)
            with torch.no_grad():
                return lm.model(lm.model.embed_tokens(ids), pos, cache)[0]

        runtime = hidden()
        lora.merge_lora(model)
        torch.testing.assert_close(hidden(), runtime, rtol=1e-5, atol=1e-5)
