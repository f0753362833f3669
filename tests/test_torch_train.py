"""The port's training path against the JAX package, on the CPU, in fp32, on
the TINY config of tests/test_pipeline.py: the mask algebra and the packing
(array for array), the plain version of the training attention kernels
against the Pallas kernels in interpret mode, ``train_forward`` (losses,
feature tap, every parameter's gradient), ``freeze_und``, the AdamW step
against optax, gradient accumulation and the EMA shadow.

Weights go through ``from_jax_params(device="cpu")``; the flow noise the JAX
forward draws from its key is replayed as the port's ``noise`` input. Each
tolerance is stated where it is used: fp32 sums in another order give ~1e-6
relative on the losses; gradients and updated parameters are held to 1e-4
relative with an absolute floor for entries that are zero by construction.
"""

import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unimedvl_tpu.data import packing as jpacking
from unimedvl_tpu.models import bagel as jbagel
from unimedvl_tpu.ops import blockmask as jblockmask
from unimedvl_tpu.ops.flash_attention_train import packed_train_attention as j_packed_attention
from unimedvl_tpu.parallel.mesh import create_mesh
from unimedvl_tpu.training import trainer as jtrainer
from unimedvl_tpu_torch.config import E2EVAEConfig
from unimedvl_tpu_torch.data import packing
from unimedvl_tpu_torch.models import bagel
from unimedvl_tpu_torch.ops import _launch, blockmask
from unimedvl_tpu_torch.ops import flash_attention_train as fat
from unimedvl_tpu_torch.parallel import mesh as pmesh
from unimedvl_tpu_torch.training import trainer
from unimedvl_tpu_torch.weights import loader

from tests.test_pipeline import TINY
from tests.test_torch_config import init_params, port_config

CFG = TINY
LOSS_TOL = 1e-5  # ce / mse / loss, absolute on values of order 1-10
GRAD_RTOL, GRAD_ATOL = 1e-4, 2e-6
PARAM_TOL = 1e-5

LAYOUTS = [
    ([96, 96], [32, 32, 32, 16, 48, 32], ["causal", "full", "noise", "causal", "noise", "full"]),
    ([50, 37], [20, 30, 37], ["causal", "noise", "causal"]),
    ([10, 8], [4, 3, 3, 2, 6], ["causal", "full", "noise", "causal", "noise"]),
]


def samples(with_vit=True, with_vae=True, seed=0):
    """Two packed samples: a t2i one (caption, a clean conditioning latent, a
    noised latent) and a VQA one (image, question with loss)."""
    rng = np.random.default_rng(seed)
    pd, vp = CFG.patch_latent_dim, CFG.vit.patch_size**2 * 3
    first = [{"type": "text", "ids": [1, 5, 9, 3], "loss": True}]
    if with_vae:
        first += [
            {"type": "vae", "clean_tokens": rng.standard_normal((4, pd)).astype(np.float32),
             "pos_ids": np.arange(4), "timestep_raw": -np.inf, "loss": False},
            {"type": "vae", "clean_tokens": rng.standard_normal((6, pd)).astype(np.float32),
             "pos_ids": np.arange(6), "timestep_raw": 0.3, "loss": True},
        ]
    second = []
    if with_vit:
        second.append({"type": "vit",
                       "patch_tokens": rng.standard_normal((16, vp)).astype(np.float32),
                       "pos_ids": np.arange(16)})
        first.append({"type": "vit",
                      "patch_tokens": rng.standard_normal((9, vp)).astype(np.float32),
                      "pos_ids": np.arange(9)})
    second.append({"type": "text", "ids": [2, 7, 8, 4, 6], "loss": True})
    return [first, second]


def make_batch(**kw):
    return jpacking.pack_training_batch(samples(**kw), pad_multiple=16)


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def replay_noise(key, batch):
    """The noise the JAX ``train_forward`` draws from ``key``, without the
    rows of the padding slots (which ``strip_padding`` drops)."""
    if "vae_clean_tokens" not in batch:
        return None
    full = np.array(jax.random.normal(key, batch["vae_clean_tokens"].shape, jnp.float32))
    n = int((batch["vae_scatter_idx"] < batch["packed_position_ids"].shape[0]).sum())
    return torch.from_numpy(full[:n])


# the JAX forward as one compiled program per batch layout (op by op it compiled each
# primitive apart, several times slower); same function, fp32 sums fused differently
_jax_train_forward = jax.jit(jbagel.train_forward, static_argnums=(1, 4))


def port_model(params, cfg=CFG):
    return loader.from_jax_params(jax.tree.map(np.asarray, params), port_config(cfg),
                                  device="cpu")


def jax_state_dict(tree, cfg=CFG):
    """A JAX tree (parameters or gradients) under the port's parameter names."""
    return loader.jax_tree_to_state_dict(jax.tree.map(np.asarray, tree), port_config(cfg))


@pytest.fixture(scope="module")
def params():
    return init_params(0, CFG, llm2vae_zero=False)


class TestBlockmask:
    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_segment_ids_and_dense_mask(self, layout):
        got = blockmask.packed_segment_ids(*layout)
        want = jblockmask.packed_segment_ids(*layout)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        mask = blockmask.dense_packed_mask(*[torch.from_numpy(a) for a in got])
        jmask = jblockmask.dense_packed_mask(*[jnp.asarray(a) for a in want])
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))

    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_sample_mask(self, layout):
        np.testing.assert_array_equal(blockmask.dense_sample_mask(*layout[1:]),
                                      jblockmask.dense_sample_mask(*layout[1:]))

    def test_unknown_mode_raises(self):
        with pytest.raises(ValueError, match="attention mode"):
            blockmask.packed_segment_ids([3], [3], ["block"])


class TestPacking:
    @pytest.mark.parametrize("kw", [
        dict(pad_multiple=16), dict(pad_multiple=128, loss_reduction="square"),
        dict(seq_len=96, pad_multiple=8, loss_reduction="sample"),
    ])
    @pytest.mark.parametrize("mods", [(True, True), (False, True), (True, False),
                                      (False, False)])
    def test_pack_training_batch_equal(self, kw, mods):
        s = samples(with_vit=mods[0], with_vae=mods[1])
        got, want = packing.pack_training_batch(s, **kw), jpacking.pack_training_batch(s, **kw)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    def test_len2weight_and_split(self):
        for red in ("token", "sample", "square"):
            for x in (0, 1, 7):
                assert packing.len2weight(x, red) == jpacking.len2weight(x, red)
        for decay in (1.0, 0.7):
            assert packing.split_integer_exp_decay(12, decay, random.Random(3)) == \
                jpacking.split_integer_exp_decay(12, decay, random.Random(3))

    def test_strip_padding(self):
        batch = make_batch()
        T = batch["packed_position_ids"].shape[0]
        out = packing.strip_padding(batch)
        for key in ("und_idx", "gen_idx", "ce_idx", "packed_text_indexes", "vae_scatter_idx",
                    "vit_scatter_idx"):
            assert out[key].max() < T and len(out[key]) == int((batch[key] < T).sum())
        assert len(out["und_idx"]) + len(out["gen_idx"]) == int((batch["mask_document_id"] > 0).sum())
        assert out["vae_clean_tokens"].shape[0] == len(out["vae_scatter_idx"]) == 10
        assert out["ce_weight"].sum() == batch["ce_weight"].sum()
        # the rows of the flat ViT embedding that are real, and where each goes
        flat_scatter = batch["vit_scatter_idx"]
        np.testing.assert_array_equal(flat_scatter[out["vit_token_idx"]], out["vit_scatter_idx"])
        assert out["packed_position_ids"].shape == (T,)

    def test_strip_padding_drops_an_empty_vit_block(self):
        batch = dict(make_batch())
        batch["vit_scatter_idx"] = np.full_like(batch["vit_scatter_idx"],
                                                batch["packed_position_ids"].shape[0])
        out = packing.strip_padding(batch)
        assert not [k for k in out if k.startswith("vit_")]


def attention_case(sample_lens, split_lens, modes, H, Hk, D=128, seed=0, scale=0.3):
    doc, fn, nz = jblockmask.packed_segment_ids(sample_lens, split_lens, modes)
    T = sum(sample_lens)
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((T, H, D)).astype(np.float32) * scale
    k = rng.standard_normal((T, Hk, D)).astype(np.float32) * scale
    v = rng.standard_normal((T, Hk, D)).astype(np.float32) * scale
    return (q, k, v), (doc, fn, nz)


class TestTrainAttentionPlainVersion:
    """K5's plain version against the Pallas kernels run with interpret=True
    (tolerances of tests/test_flash_train.py)."""

    @pytest.mark.parametrize("layout,heads", [(LAYOUTS[0], (4, 2)), (LAYOUTS[1], (2, 1))])
    def test_forward(self, layout, heads):
        qkv, ids = attention_case(*layout, *heads)
        want = j_packed_attention(*[jnp.asarray(a) for a in qkv + ids], 64, 64, True)
        before = fat.counts["plain"]
        got = fat.packed_train_attention(*[torch.from_numpy(a) for a in qkv + ids])
        assert fat.counts["plain"] == before + 1  # a CPU tensor takes the plain version
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)

    @pytest.mark.parametrize("layout,heads", [(LAYOUTS[0], (4, 2)), (LAYOUTS[1], (2, 1))])
    def test_gradients(self, layout, heads):
        qkv, ids = attention_case(*layout, *heads, seed=1)
        cot = np.random.default_rng(2).standard_normal(qkv[0].shape).astype(np.float32)
        jids = [jnp.asarray(a) for a in ids]

        def loss(q, k, v):
            return jnp.sum(j_packed_attention(q, k, v, *jids, 64, 64, True) * jnp.asarray(cot))

        want = jax.grad(loss, argnums=(0, 1, 2))(*[jnp.asarray(a) for a in qkv])
        tq, tk, tv = [torch.from_numpy(a).requires_grad_(True) for a in qkv]
        out = fat.packed_train_attention(tq, tk, tv, *[torch.from_numpy(a) for a in ids])
        (out * torch.from_numpy(cot)).sum().backward()
        for got, w, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
            np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=5e-4, atol=5e-5,
                                       err_msg=f"grad of {name}")

    def test_wrapper_rejects_other_devices_and_shapes(self):
        qkv, ids = attention_case(*LAYOUTS[2], 2, 1, D=8)
        t = [torch.from_numpy(a) for a in qkv + ids]
        with pytest.raises(ValueError, match="CUDA or CPU"):
            fat.packed_train_attention(t[0].to("meta"), *t[1:])
        with pytest.raises(ValueError, match="head dim"):
            fat._check(*[a.to(torch.bfloat16) for a in t[:3]])


class TestTrainForward:
    @pytest.mark.parametrize("mods", [(True, True), (False, True), (True, False),
                                      (False, False)])
    def test_losses(self, params, mods):
        batch = make_batch(with_vit=mods[0], with_vae=mods[1])
        key = jax.random.PRNGKey(1)
        want = _jax_train_forward(params, CFG, jax_batch(batch), key)
        got = bagel.train_forward(port_model(params), batch, noise=replay_noise(key, batch))
        assert sorted(got) == sorted(want)
        for k in want:
            assert abs(float(got[k]) - float(want[k])) <= LOSS_TOL, k
        assert ("mse" in got) == mods[1]

    def test_feature_layer_tap(self, params):
        batch = make_batch()
        key = jax.random.PRNGKey(2)
        want = _jax_train_forward(params, CFG, jax_batch(batch), key, 0)
        got = bagel.train_forward(port_model(params), batch, noise=replay_noise(key, batch),
                                  diffusion_feature_layer=0)
        feats = got["diffusion_features"].detach().numpy()
        # the JAX rows of the padding slots are filled with zeros; the port drops them
        np.testing.assert_allclose(feats, np.asarray(want["diffusion_features"])[: len(feats)],
                                   rtol=1e-5, atol=1e-5)
        assert abs(float(got["loss"]) - float(want["loss"])) <= LOSS_TOL

    def test_noise_is_an_input(self, params):
        model, batch = port_model(params), make_batch()
        with pytest.raises(ValueError, match="noise"):
            bagel.train_forward(model, batch)
        g = torch.Generator().manual_seed(0)
        a = bagel.train_forward(model, batch, generator=g)["loss"]
        b = bagel.train_forward(model, batch, generator=torch.Generator().manual_seed(0))["loss"]
        assert torch.isfinite(a) and a == b
        with pytest.raises(ValueError, match="one row per latent token"):
            bagel.train_forward(model, batch, noise=torch.zeros(3, CFG.patch_latent_dim))

    def test_e2e_extras_raise(self, params):
        """The e2e-VAE extras are ported (tests/test_torch_e2e_vae.py): without
        ``cfg.e2e`` a bn_state is ignored, as in the JAX package; a mesh step
        refuses a model that is not a rank's model of its mesh, and FSDP
        without a mesh (tests/test_torch_train_mesh.py runs the mesh steps)."""
        model = port_model(params)
        batch, key = make_batch(), jax.random.PRNGKey(1)
        plain = bagel.train_forward(model, batch, noise=replay_noise(key, batch))
        ignored = bagel.train_forward(model, batch, noise=replay_noise(key, batch),
                                      bn_state=object())
        assert float(ignored["loss"]) == float(plain["loss"]) and "bn_state" not in ignored
        mesh = pmesh.Mesh(("data", "model"), {"data": 1, "model": 2}, 0,
                          {"data": 0, "model": 0}, {"data": None, "model": None})
        with pytest.raises(ValueError, match="not a rank's model of this mesh"):
            trainer.make_train_step(port_config(CFG), model, mesh=mesh)
        with pytest.raises(ValueError, match="fsdp=True"):
            trainer.make_train_step(port_config(CFG), model, fsdp=True)
        cfg = dataclasses.replace(port_config(CFG), e2e=E2EVAEConfig(enable_batch_norm=True))
        state = trainer.make_train_step(cfg, model)[1]()  # the step keeps the BN state
        assert torch.equal(state.bn_state.var, torch.ones(CFG.vae.z_channels))

    def test_remat_changes_nothing(self, params):
        batch, key = make_batch(), jax.random.PRNGKey(1)
        losses = []
        for remat in (True, False):
            cfg = dataclasses.replace(CFG, llm=dataclasses.replace(CFG.llm, remat=remat))
            model = port_model(params, cfg)
            trainer.set_trainable(model)
            out = bagel.train_forward(model, batch, noise=replay_noise(key, batch))
            out["loss"].backward()
            losses.append((float(out["loss"]),
                           model.language_model.model.layers[0].mlp.gate_proj.weight.grad.clone()))
        assert losses[0][0] == losses[1][0]
        torch.testing.assert_close(losses[0][1], losses[1][1], rtol=0, atol=0)


def assert_tree_close(got_named, want_sd, rtol, atol, skip=("vae_model.",)):
    checked = 0
    for name, got in got_named:
        if name.startswith(skip):
            continue
        np.testing.assert_allclose(got, want_sd[name], rtol=rtol, atol=atol, err_msg=name)
        checked += 1
    return checked


class TestGradients:
    @pytest.mark.parametrize("freeze_und", [False, True])
    def test_every_parameter(self, freeze_und):
        cfg = dataclasses.replace(CFG, llm=dataclasses.replace(CFG.llm, freeze_und=freeze_und))
        params = init_params(0, cfg, llm2vae_zero=False)
        batch, key = make_batch(), jax.random.PRNGKey(1)

        def loss(p):
            return jbagel.train_forward(p, cfg, jax_batch(batch), key)["loss"]

        want = jax_state_dict(jax.jit(jax.grad(loss))(params), cfg)
        model = port_model(params, cfg)
        for p in model.parameters():  # every leaf, the frozen twins too: their grads must be 0
            p.requires_grad_(True)
        bagel.train_forward(model, batch, noise=replay_noise(key, batch))["loss"].backward()
        grads = [(n, np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy())
                 for n, p in model.named_parameters()]
        assert assert_tree_close(grads, want, GRAD_RTOL, GRAD_ATOL) > 60
        labels = trainer._freeze_und_labels(model)
        assert sum(lab == "freeze" for lab in labels.values()) > 20
        if freeze_und:
            for n, g in grads:
                if labels[n] == "freeze":
                    assert not g.any(), n
            gen = dict(grads)["language_model.model.layers.0.mlp_moe_gen.gate_proj.weight"]
            assert gen.any()

    def test_freeze_labels_match_the_jax_package(self, params):
        model = port_model(params)
        labels = trainer._freeze_und_labels(model)
        jlabels = jtrainer._freeze_und_labels(params)
        # one JAX leaf is stacked over layers; a frozen JAX leaf freezes each layer's twin
        jfrozen = jax_state_dict(jax.tree.map(
            lambda lab, x: np.full(np.shape(x), lab == "freeze"), jlabels, params))
        for name, lab in labels.items():
            if not name.startswith("vae_model."):
                assert bool(jfrozen[name].all()) == (lab == "freeze"), name


def _optax_steps(params, cfg, batches, keys, lr):
    opt = jtrainer.make_optimizer(learning_rate=lr)
    if cfg.llm.freeze_und:
        opt = jtrainer.apply_freeze_und(opt, params)
    state = jtrainer.create_train_state(jax.tree.map(jnp.array, params), opt)
    losses = []
    for b, key in zip(batches, keys):
        state, loss = jtrainer.train_step(state, cfg, b, key, optimizer=opt)
        losses.append(float(loss))
    return losses, state.params


def _stacked(with_vit=True):
    """B = 2: the mixed sequence and a text+image one."""
    from unimedvl_tpu.training.dataset import stack_packed

    return stack_packed([make_batch(with_vit=with_vit), make_batch(with_vae=False, seed=1)])


def _replay_batch_noise(key, stacked):
    B = stacked["packed_position_ids"].shape[0]
    keys = jax.random.split(key, B)
    return [replay_noise(keys[i], {k: v[i] for k, v in stacked.items()}) for i in range(B)]


class TestTrainStep:
    @pytest.mark.parametrize("freeze_und", [False, True])
    def test_three_steps_against_optax(self, freeze_und):
        cfg = dataclasses.replace(CFG, llm=dataclasses.replace(CFG.llm, freeze_und=freeze_und))
        params = init_params(0, cfg, llm2vae_zero=False)
        stacked = _stacked()
        keys = [jax.random.PRNGKey(10 + i) for i in range(3)]
        lr = 1e-3
        want_losses, want_params = _optax_steps(
            params, cfg, [jax_batch(stacked)] * 3, keys, lr)

        model = port_model(params, cfg)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        state = trainer.create_train_state(model, trainer.make_optimizer(learning_rate=lr))
        losses = []
        for key in keys:
            state, loss = trainer.train_step(state, stacked,
                                             noises=_replay_batch_noise(key, stacked))
            losses.append(float(loss))
        assert state.step == 3
        np.testing.assert_allclose(losses, want_losses, rtol=0, atol=LOSS_TOL)
        want = jax_state_dict(want_params, cfg)
        got = [(n, p.detach().numpy()) for n, p in model.named_parameters()]
        assert assert_tree_close(got, want, PARAM_TOL, PARAM_TOL) > 60
        moved = [n for n, p in model.named_parameters() if not torch.equal(p, before[n])]
        labels = trainer._freeze_und_labels(model)
        for n in before:
            if n.startswith("vae_model.") or (freeze_und and labels[n] == "freeze"):
                # out of the optimizer: weight decay cannot move it
                assert n not in moved, n
            elif not freeze_und or "_moe_gen" in n:
                # (under freeze_und the ViT's rows carry no gradient either, and a zero
                # bias without a gradient stays zero under weight decay)
                assert n in moved, n

    def test_accumulation_equals_the_jax_step(self, params):
        stacked = _stacked()
        two = {k: np.stack([v, v[::-1]]) for k, v in stacked.items()}  # [accum 2, B 2, ...]
        key = jax.random.PRNGKey(5)
        mesh = create_mesh((1, 1), devices=jax.devices()[:1])
        opt = jtrainer.make_optimizer(learning_rate=1e-3)
        jstep, jinit = jtrainer.make_train_step(CFG, mesh, params, optimizer=opt, accum_steps=2,
                                                ema_decay=0.9)
        with jax.set_mesh(mesh):
            jstate, want_loss = jstep(jinit(), jax_batch(two), key)
        model = port_model(params)
        step, init_state = trainer.make_train_step(
            port_config(CFG), model, trainer.make_optimizer(learning_rate=1e-3), accum_steps=2,
            ema_decay=0.9)
        noises = [_replay_batch_noise(k, {n: v[i] for n, v in two.items()})
                  for i, k in enumerate(jax.random.split(key, 2))]
        state, loss = step(init_state(), two, noises=noises)
        assert abs(float(loss) - float(want_loss)) <= LOSS_TOL
        got = [(n, p.detach().numpy()) for n, p in model.named_parameters()]
        assert_tree_close(got, jax_state_dict(jstate.params), PARAM_TOL, PARAM_TOL)
        ema = [(n, e.numpy()) for n, e in state.ema_params.items()]
        assert assert_tree_close(ema, jax_state_dict(jstate.ema_params), PARAM_TOL, PARAM_TOL) > 60

    def test_ema_recurrence(self, params):
        model = port_model(params)
        step, init_state = trainer.make_train_step(
            port_config(CFG), model, trainer.make_optimizer(learning_rate=1e-2), ema_decay=0.5)
        state = init_state()
        name = "language_model.model.layers.1.mlp_moe_gen.up_proj.weight"
        p0 = dict(model.named_parameters())[name].detach().clone()
        assert state.ema_params[name].dtype == torch.float32
        torch.testing.assert_close(state.ema_params[name], p0)
        g = torch.Generator().manual_seed(0)
        want = p0.clone()
        for _ in range(2):
            state, _ = step(state, _stacked(), generator=g)
            want = 0.5 * want + 0.5 * dict(model.named_parameters())[name].detach()
        torch.testing.assert_close(state.ema_params[name], want, rtol=1e-6, atol=1e-7)
        assert not [n for n in state.ema_params if n.startswith("vae_model.")]

    def test_accum_argument_checks(self, params):
        model = port_model(params)
        with pytest.raises(ValueError, match="accum_steps"):
            trainer.make_train_step(port_config(CFG), model, accum_steps=0)
        step, init_state = trainer.make_train_step(port_config(CFG), model, accum_steps=2)
        with pytest.raises(ValueError, match="expected 2 batches"):
            step(init_state(), [_stacked()], generator=torch.Generator())


class TestNoBackwardKernels:
    """K1a, K1b and K2 have no backward kernel: their wrappers refuse inputs
    that require grad instead of returning an output cut off from the graph."""

    def test_check_no_grad(self):
        x = torch.zeros(2, requires_grad=True)
        with pytest.raises(RuntimeError, match="no backward kernel.*q"):
            _launch.check_no_grad("flash_block_attention", ("q", "k"), (x, x.detach()))
        _launch.check_no_grad("flash_block_attention", ("q",), (x.detach(),))
        with torch.no_grad():
            _launch.check_no_grad("flash_block_attention", ("q",), (x,))

    def test_from_jax_params_defaults_to_the_card(self, params):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            loader.from_jax_params(jax.tree.map(np.asarray, params), port_config(CFG))
