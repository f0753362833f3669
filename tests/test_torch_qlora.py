"""QLoRA in the port against the JAX package, on the CPU in fp32: every
quantized projection's output and gradient into x against ``jax.grad`` of the
JAX ``_linear`` (with a planted |x| tie and an all-zero row), K3's
differentiable route against ``jax.grad`` of the JAX XLA route, the MLP with
and without an adapter on an act-quant down, the int8 lm_head in both
modes, the loader in both orders (adapters then quantization, and the
reverse), two lean adapter steps over int8 and int4 bases against
``make_lora_train_step``, and the refusals.

On the CPU the kernel wrappers take their plain versions, and the
differentiable routes (``ops.w4_matmul.W4Matmul``, ``ops.act_quant.
SiluMulQuant``, ``quant.WidenedMatmul``) run their torch backwards: the
same backwards the card runs after its kernels.

Tolerances: outputs and dx 1e-5 relative with a 1e-5 absolute floor (fp32
sums in another order); losses 1e-5 absolute; adapters after two AdamW
steps 2e-4 absolute (a quantized forward rounds x per token: a last-place
difference moves a value a whole int8 step, which AdamW's normalized update
turns into a relative change of the update, not of the gradient's size).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unimedvl_tpu import quant as jquant
from unimedvl_tpu.models import qwen2_mot as jmot
from unimedvl_tpu.ops.activations import ACT2FN as JACT2FN
from unimedvl_tpu.training import lora as jlora
from unimedvl_tpu_torch import quant
from unimedvl_tpu_torch.config import E2EVAEConfig
from unimedvl_tpu_torch.models import qwen2_mot
from unimedvl_tpu_torch.models.layers import LoRALinear, QuantLinear
from unimedvl_tpu_torch.ops import act_quant as aq
from unimedvl_tpu_torch.ops import w4_matmul as w4
from unimedvl_tpu_torch.training import lora

from tests.test_torch_config import init_params, port_config
from tests.test_torch_lora import _randomize_b
from tests.test_torch_train import (
    CFG, LOSS_TOL, _replay_batch_noise, _stacked, jax_batch, jax_state_dict, port_model,
)

RTOL = ATOL = 1e-5
ADAPTER_ATOL = 2e-4
JAX_LEAF = {"q": "kernel_q", "qa": "kernel_qa", "p4": "kernel_p4", "p4a": "kernel_p4a"}
# mode, group size (0: per channel); the in dims here are 64 and 96
MODES = [("q", 0), ("qa", 0), ("p4", 0), ("p4a", 0), ("p4", 32), ("p4a", 32)]


def _bits(mode):
    return 4 if mode.startswith("p4") else 8


def jax_leaf(w, mode, group):
    """The JAX quantized leaf of a [in, out] kernel in ``mode``."""
    p = jquant.quantize_weight(jnp.asarray(w), False, _bits(mode), group_size=group)
    key = next(k for k in p if k.startswith("kernel"))
    return {JAX_LEAF[mode]: p.pop(key), **p}


def port_leaf(p, mode):
    """The port's QuantLinear holding the JAX leaf's integers and scales."""
    q = torch.from_numpy(np.ascontiguousarray(np.asarray(p[JAX_LEAF[mode]]).T))
    return QuantLinear(mode, q, torch.from_numpy(np.array(p["scale"])))


def planted_x(rng, m, k):
    """Rows with a planted |x| tie (row 1: +5 and -5 are the row's absmax)
    and an all-zero row (row 2)."""
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[1, 3], x[1, 7] = 5.0, -5.0
    x[2] = 0.0
    return x


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


class TestProjectionGradients:
    @pytest.mark.parametrize("mode,group", MODES)
    def test_output_and_dx_against_jax_grad(self, mode, group):
        rng = np.random.default_rng(0)
        K, N, m = 96, 40, 5
        p = jax_leaf(rng.standard_normal((K, N)).astype(np.float32), mode, group)
        x = planted_x(rng, m, K)
        dy = rng.standard_normal((m, N)).astype(np.float32)
        want_y = jmot._linear(jnp.asarray(x), p)
        want_dx = jax.grad(lambda v: jnp.sum(jmot._linear(v, p) * dy))(jnp.asarray(x))
        lin = port_leaf(p, mode)
        xt = torch.from_numpy(x).requires_grad_(True)
        y = lin(xt)
        assert y.grad_fn is not None
        y.backward(torch.from_numpy(dy))
        close(y.detach(), want_y)
        close(xt.grad, want_dx)
        if mode.endswith("a"):  # only through the scale: one entry per row, two at the tie
            assert (xt.grad != 0).sum(dim=1).tolist() == [1, 2, 0, 1, 1]

    @pytest.mark.parametrize("group", [0, 32])
    def test_w4_function_against_plain_autograd(self, group):
        """W4Matmul's backward (bf16-x widening and int8-x scale) against
        torch autograd through the forward's plain version."""
        rng = np.random.default_rng(1)
        K, N, m = 128, 24, 6
        q = torch.from_numpy(rng.integers(-8, 8, (N, K)).astype(np.int8))
        wp = w4.pack_int4(q)
        ws = torch.from_numpy(rng.uniform(0.01, 0.1, (max(group and K // group, 1), N))
                              .astype(np.float32)).squeeze(0)
        x = torch.from_numpy(planted_x(rng, m, K))
        dy = torch.from_numpy(rng.standard_normal((m, N)).astype(np.float32))
        for route in (w4.w4_matmul_autograd, w4.w4_matmul_ref):
            a = x.clone().requires_grad_(True)
            route(a, None, wp, ws, torch.float32).backward(dy)
            xq, xs = quant.quantize_activations(x)
            s = xs.clone().requires_grad_(True)
            route(xq, s, wp, ws, torch.float32).backward(dy)
            if route is w4.w4_matmul_autograd:
                got = (a.grad, s.grad)
            else:
                close(got[0], a.grad)
                close(got[1], s.grad)

    def test_wrappers_refuse_grad_outside_their_routes(self):
        """On a CUDA tensor the plain wrappers check grad before anything
        else; the check is the same ``_launch.check_no_grad`` the attention
        kernels use, named for the differentiable route."""
        x = torch.zeros(4, 64, requires_grad=True)
        with pytest.raises(RuntimeError, match="w4_matmul_autograd"):
            w4._launch_kernel(x, None, torch.zeros(8, 32, dtype=torch.int8), torch.ones(8),
                              torch.bfloat16)
        with pytest.raises(RuntimeError, match="silu_mul_quant_autograd"):
            aq._launch_kernel(x, x)

    @pytest.mark.parametrize("mode", ["q", "qa"])
    def test_int8_lm_head_under_grad(self, mode):
        rng = np.random.default_rng(2)
        C, V, m = 32, 50, 5
        head = jax_leaf(rng.standard_normal((C, V)).astype(np.float32) * 0.1, mode, 0)
        h = planted_x(rng, m, C)
        dy = rng.standard_normal((m, V)).astype(np.float32)
        jlm = {"lm_head": head}
        want = jmot.lm_head(jlm, jnp.asarray(h))
        want_dh = jax.grad(lambda v: jnp.sum(jmot.lm_head(jlm, v) * dy))(jnp.asarray(h))
        lm = type("LM", (), {})()
        lm.lm_head = port_leaf(head, mode)
        ht = torch.from_numpy(h).requires_grad_(True)
        logits = qwen2_mot.lm_head(lm, ht)
        logits.backward(torch.from_numpy(dy))
        close(logits.detach(), want)
        close(ht.grad, want_dh)


class TestK3Gradient:
    def _gu(self, rng, R=6, I=64):
        g = rng.standard_normal((R, I)).astype(np.float32)
        u = rng.standard_normal((R, I)).astype(np.float32)
        g[1, 4] = g[1, 9] = 3.0  # a tie in |silu(g) * u|: equal products of opposite sign
        u[1, 4], u[1, 9] = 4.0, -4.0
        g[2] = 0.0  # silu(0) = 0: an all-zero row
        return g, u

    def test_routes_against_jax_grad_of_the_xla_route(self):
        rng = np.random.default_rng(3)
        g, u = self._gu(rng)
        down = jax_leaf(rng.standard_normal((64, 32)).astype(np.float32), "qa", 0)
        dy = rng.standard_normal((6, 32)).astype(np.float32)
        act = JACT2FN["silu"]

        def f(a, b):
            return jnp.sum(jmot._linear(act(a) * b, down) * dy)

        want_y = jmot._linear(act(jnp.asarray(g)) * jnp.asarray(u), down)
        want_dg, want_du = jax.grad(f, argnums=(0, 1))(jnp.asarray(g), jnp.asarray(u))
        lin = port_leaf(down, "qa")
        for route in (aq.silu_mul_quant_autograd, aq.silu_mul_quant_ref):
            gt = torch.from_numpy(g).requires_grad_(True)
            ut = torch.from_numpy(u).requires_grad_(True)
            xq, xs = route(gt, ut)
            y = quant.quantized_linear_preq(xq, xs, lin, torch.float32)
            y.backward(torch.from_numpy(dy))
            close(y.detach(), want_y)
            close(gt.grad, want_dg)
            close(ut.grad, want_du)
            assert (gt.grad != 0).sum(dim=1).tolist() == [1, 2, 0, 1, 1, 1]

    def test_backward_of_a_row_under_the_clamp(self):
        g = torch.zeros(2, 16)
        g[1, 3] = 1e-9  # |x| far below 1e-8: the clamp's branch, no gradient
        d_g, d_u = aq.silu_mul_quant_backward(g, torch.ones(2, 16), torch.ones(2, 1))
        assert not d_g.any() and not d_u.any()


def _mlp_params(rng, mode, adapted):
    C, I = 32, 64
    p = {name: jax_leaf(rng.standard_normal(shape).astype(np.float32) * 0.2, mode, 0)
         for name, shape in (("gate", (C, I)), ("up", (C, I)), ("down", (I, C)))}
    if adapted:
        p["down"]["lora_a"] = jnp.asarray(rng.standard_normal((I, 4)).astype(np.float32) * 0.1)
        p["down"]["lora_b"] = jnp.asarray(rng.standard_normal((4, C)).astype(np.float32) * 0.1)
        p["down"]["lora_s"] = jnp.asarray(2.0, jnp.float32)
    return p


class TestMLPRoute:
    @pytest.mark.parametrize("adapted", [False, True])
    def test_down_with_and_without_adapter(self, adapted):
        """Without an adapter the port's MLP takes K3 (its plain version
        here), an adapted down the product in x's dtype quantized per token,
        as the JAX _mlp does ("lora_a" in down); both against jax.grad of the
        JAX _mlp's XLA route (its Pallas K3 has no backward)."""
        rng = np.random.default_rng(4)
        p = _mlp_params(rng, "qa", adapted)
        x = rng.standard_normal((5, 32)).astype(np.float32)
        dy = rng.standard_normal((5, 32)).astype(np.float32)
        act = JACT2FN["silu"]
        want = jmot._mlp(jnp.asarray(x), p, act)
        want_dx = jax.grad(lambda v: jnp.sum(jmot._mlp(v, p, act) * dy))(jnp.asarray(x))
        mlp = qwen2_mot.Qwen2MLP(port_config(CFG).llm)
        mlp.gate_proj, mlp.up_proj = port_leaf(p["gate"], "qa"), port_leaf(p["up"], "qa")
        down = port_leaf(p["down"], "qa")
        if adapted:
            down = LoRALinear(down, torch.from_numpy(np.asarray(p["down"]["lora_a"]).T.copy()),
                              torch.from_numpy(np.asarray(p["down"]["lora_b"]).T.copy()), 2.0)
        mlp.down_proj = down
        calls = aq.counts["plain"]
        xt = torch.from_numpy(x).requires_grad_(True)
        y = mlp(xt)
        y.backward(torch.from_numpy(dy))
        assert aq.counts["plain"] - calls == (0 if adapted else 1)  # K3 (its plain version)
        close(y.detach(), want)
        close(xt.grad, want_dx)


@pytest.fixture(scope="module")
def base():
    return init_params(0, CFG, llm2vae_zero=False)


def _quantized_jax(params, mode, group):
    out = dict(params)
    out["llm"] = jquant.quantize_llm_params(params["llm"], via_host=True,
                                            act_quant=mode.endswith("a"), bits=_bits(mode),
                                            group_size=group)
    return out


class TestLoader:
    @pytest.mark.parametrize("mode,group", [("p4a", 16)])
    def test_adapters_then_quantization(self, base, mode, group):
        """JAX add_lora then quantize_llm_params, loaded, equals the port's
        own quantize_llm_params over the adapted bf16 model, bit for bit."""
        adapted = _randomize_b(jlora.add_lora(base, jax.random.PRNGKey(3), rank=4,
                                              dtype=jnp.float32))
        loaded = port_model(_quantized_jax(adapted, mode, group))
        ours = port_model(adapted)
        quant.quantize_llm_params(ours.language_model, act_quant=mode.endswith("a"),
                                  bits=_bits(mode), group_size=group)
        sd, want = ours.state_dict(), loaded.state_dict()
        assert sorted(sd) == sorted(want)
        for k in want:
            assert torch.equal(sd[k], want[k]), k
        q = ours.language_model.model.layers[0].mlp.down_proj
        assert isinstance(q, LoRALinear) and q.mode == mode
        assert q.in_features == CFG.llm.intermediate_size

    @pytest.mark.parametrize("mode,group", [("p4", 0)])
    def test_quantization_then_adapters(self, base, mode, group):
        """JAX quantize_llm_params then add_lora (the adapter's in dim of a
        packed base is twice the stored rows), loaded: the adapters over the
        JAX leaf's integers. TestLeanSteps runs this order's forward and
        step against the JAX package."""
        params = _randomize_b(jlora.add_lora(_quantized_jax(base, mode, group),
                                             jax.random.PRNGKey(5), rank=4, dtype=jnp.float32))
        model = port_model(params)
        o = model.language_model.model.layers[1].self_attn.o_proj_moe_gen
        leaf = params["llm"]["layers"]["attn"]["o_gen"]
        assert isinstance(o, LoRALinear) and o.mode == mode
        np.testing.assert_array_equal(o.lora_a.detach().numpy(), np.asarray(leaf["lora_a"])[1].T)
        np.testing.assert_array_equal(o.weight_q.numpy(), np.asarray(leaf[JAX_LEAF[mode]])[1].T)
        assert o.in_features == 2 * o.weight_q.shape[1] == o.lora_a.shape[1]


class TestLeanSteps:
    @pytest.mark.parametrize("mode,group", [("qa", 0), ("p4", 0)])
    def test_two_steps_against_the_jax_lean_step(self, base, mode, group):
        """Full-int8 and weight-only w4 (K4's backward at every projection),
        adapters on every projection of both experts. With an adapter on
        every down, the full-int8 step takes JAX's adapted-down route, the
        product quantized per token, and not K3 (whose route under autograd
        is held by ``test_down_with_and_without_adapter``)."""
        params = _randomize_b(jlora.add_lora(_quantized_jax(base, mode, group),
                                             jax.random.PRNGKey(3), rank=4, dtype=jnp.float32))
        stacked = _stacked()
        keys = [jax.random.PRNGKey(20), jax.random.PRNGKey(21)]
        jstep, adapters, opt_state, jbase, combine = jlora.make_lora_train_step(
            CFG, jax.tree.map(jnp.array, params))
        want_losses = []
        for key in keys:
            adapters, opt_state, loss = jstep(adapters, opt_state, jbase, jax_batch(stacked), key)
            want_losses.append(float(loss))
        want = jax_state_dict(combine(adapters, jbase))

        model = port_model(params)
        frozen = {k: v.clone() for k, v in model.state_dict().items()
                  if not k.endswith(("lora_a", "lora_b"))}
        step, state = lora.make_lora_train_step(port_config(CFG), model)
        losses = []
        for key in keys:
            state, loss = step(state, stacked, noises=_replay_batch_noise(key, stacked))
            losses.append(float(loss))
        np.testing.assert_allclose(losses, want_losses, rtol=0, atol=LOSS_TOL)
        moved = 0
        for name, t in model.state_dict().items():
            if name in frozen:
                assert torch.equal(t, frozen[name]), name  # the base's bits, buffers included
            else:
                np.testing.assert_allclose(t.numpy(), want[name], rtol=0, atol=ADAPTER_ATOL,
                                           err_msg=name)
                moved += 1
        assert moved == 2 * 2 * 14
        assert all(p.grad is None for n, p in model.named_parameters()
                   if not n.endswith(("lora_a", "lora_b")))


class TestRefusals:
    def test_refusals(self, base):
        model = port_model(_quantized_jax(base, "qa", 0))
        lora.add_lora(model, torch.Generator().manual_seed(0), rank=4, dtype=torch.float32)
        with pytest.raises(ValueError, match="quantized base"):
            lora.merge_lora(model)
        with pytest.raises(ValueError, match="already carries"):
            lora.add_lora(model, torch.Generator(), rank=4)
        with pytest.raises(ValueError, match="merge_lora"):
            quant.fuse_serving_projections(model.language_model)
        cfg = dataclasses.replace(port_config(CFG), e2e=E2EVAEConfig())
        with pytest.raises(ValueError, match="e2e"):
            lora.make_lora_train_step(cfg, model)
        with pytest.raises(TypeError, match="LoRA adapts"):
            LoRALinear(torch.nn.Identity(), torch.zeros(4, 2), torch.zeros(2, 4), 1.0)
