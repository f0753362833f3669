"""The e2e-VAE training extras of the port (training/e2e_vae.py and their
wiring through train_forward and the train step) against the JAX package, on
the CPU in fp32 (TINY config with ``cfg.e2e``: latent batch-norm, both REPA
terms): the batch-norm against JAX and against ``torch.nn.BatchNorm2d``,
REPA's value and gradients, ``train_forward``'s losses and every gradient,
and ``bn_state`` after a train step.

The port drops a packed batch's padding rows on the host, so its batch-norm
sees the real latent tokens only (as the reference's BatchNorm2d does); the
JAX package normalizes its padded bucket, whose zero rows enter the
statistics. The batches here are packed with ``pad_multiple=2``, which
leaves the latent block without padding rows, where the two agree; the
padding case is held to the port's definition by
``test_padding_rows_are_not_statistics``.

Tolerances: losses 1e-5 absolute; gradients 1e-4 relative with a 2e-6
floor (test_torch_train.py's); batch-norm outputs and statistics 1e-5
relative / 1e-6 absolute (fp32 means in another order); parameters after a
step 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unimedvl_tpu.config import E2EVAEConfig as JE2E
from unimedvl_tpu.data import packing as jpacking
from unimedvl_tpu.models import bagel as jbagel
from unimedvl_tpu.training import e2e_vae as je2e
from unimedvl_tpu.training import trainer as jtrainer
from unimedvl_tpu_torch.models import bagel
from unimedvl_tpu_torch.training import e2e_vae, trainer

from tests.test_torch_config import init_params, port_config
from tests.test_torch_train import (
    CFG, GRAD_ATOL, GRAD_RTOL, LOSS_TOL, PARAM_TOL, _replay_batch_noise, assert_tree_close,
    jax_batch, jax_state_dict, port_model, replay_noise, samples,
)

DT = 12  # teacher feature width
E2E_CFG = dataclasses.replace(CFG, e2e=JE2E(enable_batch_norm=True, teacher_feature_dim=DT,
                                            diffusion_feature_layer=0))
BN_RTOL, BN_ATOL = 1e-5, 1e-6


def e2e_batch(seed=0):
    """One packed sequence with its latent block unpadded and seeded teacher
    features for its latent tokens."""
    batch = jpacking.pack_training_batch(samples(seed=seed), pad_multiple=2)
    nv = batch["vae_clean_tokens"].shape[0]
    assert (batch["vae_scatter_idx"] < batch["packed_position_ids"].shape[0]).all()
    rng = np.random.default_rng(100 + seed)
    batch["repa_teacher_features"] = rng.standard_normal((nv, DT)).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def params():
    """``bagel.init_params(PRNGKey(0), E2E_CFG, llm2vae_zero=False)``, built
    as that function builds it: the shared draw of the config without e2e
    (the same leaves) and the REPA projections from the key's tenth split."""
    tree = dict(init_params(0, CFG, llm2vae_zero=False))
    k_d, k_v = jax.random.split(jax.random.split(jax.random.PRNGKey(0), 10)[9])
    tree["repa_proj"] = je2e.init_repa_params(k_d, CFG.llm.hidden_size, E2E_CFG.e2e)
    tree["repa_vae_proj"] = je2e.init_repa_params(k_v, CFG.patch_latent_dim, E2E_CFG.e2e)
    return tree


def _tokens(seed, n=10, zc=4, pp=4):
    return np.random.default_rng(seed).standard_normal((n, pp * zc)).astype(np.float32) * 2 + 0.5


class TestBatchNorm:
    @pytest.mark.parametrize("training", [True, False])
    def test_against_jax(self, training):
        x = _tokens(0)
        jstate = je2e.BatchNormState(mean=jnp.arange(4.0) * 0.1, var=jnp.arange(1.0, 5.0))
        want, wstate = je2e.latent_batch_norm(jnp.asarray(x), jstate, 4, training, 0.2, 1e-3)
        state = e2e_vae.BatchNormState(torch.arange(4.0) * 0.1, torch.arange(1.0, 5.0))
        got, gstate = e2e_vae.latent_batch_norm(torch.from_numpy(x), state, 4, training, 0.2,
                                                1e-3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=BN_RTOL, atol=BN_ATOL)
        for a, b in ((gstate.mean, wstate.mean), (gstate.var, wstate.var)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=BN_RTOL, atol=BN_ATOL)

    def test_against_torch_batchnorm2d(self):
        """Tokens [N, p*p*zc] grouped by channel are BatchNorm2d's input
        [1, zc, N*p*p, 1]; both steps of the running statistics agree."""
        zc = 4
        bn = torch.nn.BatchNorm2d(zc, eps=1e-4, momentum=0.1, affine=False)
        state = e2e_vae.BatchNormState.create(zc)
        for seed in (1, 2):
            x = torch.from_numpy(_tokens(seed))
            got, state = e2e_vae.latent_batch_norm(x, state, zc, True)
            want = bn(x.reshape(-1, zc).t().reshape(1, zc, -1, 1))
            torch.testing.assert_close(got, want.reshape(zc, -1).t().reshape(x.shape),
                                       rtol=BN_RTOL, atol=BN_ATOL)
            torch.testing.assert_close(state.mean, bn.running_mean, rtol=BN_RTOL, atol=BN_ATOL)
            torch.testing.assert_close(state.var, bn.running_var, rtol=BN_RTOL, atol=BN_ATOL)
        bn.eval()
        x = torch.from_numpy(_tokens(3))
        got, same = e2e_vae.latent_batch_norm(x, state, zc, False)
        want = bn(x.reshape(-1, zc).t().reshape(1, zc, -1, 1)).reshape(zc, -1).t()
        torch.testing.assert_close(got, want.reshape(x.shape), rtol=BN_RTOL, atol=BN_ATOL)
        assert same is state

    def test_padding_rows_are_not_statistics(self, params):
        """At ``pack_training_batch``'s default bucket (pad_multiple 128) the
        latent block has padding rows. The port drops them on the host, so
        its new statistics are those of the real rows, as the reference's
        BatchNorm2d over the image's latents has them. The JAX package hands
        the whole padded block to ``latent_batch_norm``
        (unimedvl_tpu/models/bagel.py:1213-1221), so its zero rows enter the
        statistics: its batch mean is the real rows' times real / bucket.
        The gap is shown here and left open (ROADMAP queue 3)."""
        batch = jpacking.pack_training_batch(samples())
        clean = batch["vae_clean_tokens"]
        real = int((batch["vae_scatter_idx"] < batch["packed_position_ids"].shape[0]).sum())
        assert real < clean.shape[0] and not clean[real:].any()
        model = port_model(params, E2E_CFG)
        out = bagel.train_forward(model, batch, noise=replay_noise(jax.random.PRNGKey(1), batch),
                                  bn_state=e2e_vae.BatchNormState.create(4))
        m, eps = E2E_CFG.e2e.bn_momentum, E2E_CFG.e2e.bn_eps
        fresh = je2e.BatchNormState.create(4)
        _, on_real = je2e.latent_batch_norm(jnp.asarray(clean[:real]), fresh, 4, True, m, eps)
        _, on_bucket = je2e.latent_batch_norm(jnp.asarray(clean), fresh, 4, True, m, eps)
        got = out["bn_state"]
        for a, b in ((got.mean, on_real.mean), (got.var, on_real.var)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=BN_RTOL, atol=BN_ATOL)
        real_mean = clean[:real].reshape(-1, 4).mean(axis=0)
        np.testing.assert_allclose(np.asarray(on_bucket.mean),
                                   m * real_mean * real / clean.shape[0],
                                   rtol=BN_RTOL, atol=BN_ATOL)
        assert np.abs(np.asarray(on_bucket.mean) - got.mean.numpy()).max() > 1e-3

    def test_sequences_without_latents_are_not_averaged(self, params):
        """A step's new statistics are the mean over the sequences that carry
        latent tokens (``trainer.loss_fn``): a text-only sequence beside one
        with latents leaves that one's state. The JAX ``loss_fn`` averages
        every sequence of its stacked batch (unimedvl_tpu/training/
        trainer.py:97-115), and there a sequence without latents normalizes
        its bucket of zero rows, state (1 - m) * old; shown, and left open
        (ROADMAP queue 3)."""
        with_latents = jpacking.pack_training_batch(samples())
        text_only = jpacking.pack_training_batch(samples(with_vae=False))
        model = port_model(params, E2E_CFG)
        noise = replay_noise(jax.random.PRNGKey(1), with_latents)
        fresh = e2e_vae.BatchNormState.create(4)
        seqs = [bagel.prepare_sequence(b, "cpu") for b in (with_latents, text_only)]
        with torch.no_grad():
            alone = bagel.train_forward(model, seqs[0], noise=noise, bn_state=fresh)["bn_state"]
            _, got = trainer.loss_fn(model, seqs, noises=[noise, None], bn_state=fresh)
        assert torch.equal(got.mean, alone.mean) and torch.equal(got.var, alone.var)
        m = E2E_CFG.e2e.bn_momentum
        zeros = np.zeros_like(with_latents["vae_clean_tokens"])
        _, from_zeros = je2e.latent_batch_norm(jnp.asarray(zeros), je2e.BatchNormState.create(4),
                                               4, True, m, E2E_CFG.e2e.bn_eps)
        np.testing.assert_allclose(np.asarray(from_zeros.var), 1 - m, rtol=BN_RTOL)
        jax_mean = (alone.mean.numpy() + np.asarray(from_zeros.mean)) / 2
        assert np.abs(jax_mean - got.mean.numpy()).max() > 1e-3


class TestREPA:
    @pytest.mark.parametrize("kind", ["cosine", "l2"])
    def test_value_and_gradients(self, kind):
        rng = np.random.default_rng(4)
        h = rng.standard_normal((7, 32)).astype(np.float32)
        h[3] = 0.0  # an all-zero row keeps a finite gradient
        t = rng.standard_normal((7, DT)).astype(np.float32)
        w = np.array([1, 1, 0, 1, 0.5, 1, 1], np.float32)
        jp = je2e.init_repa_params(jax.random.PRNGKey(0), 32, E2E_CFG.e2e)

        def f(hh, p):
            return je2e.repa_alignment_loss(hh, jnp.asarray(t), p, jnp.asarray(w), kind)

        want = f(jnp.asarray(h), jp)
        dh, dp = jax.grad(f, argnums=(0, 1))(jnp.asarray(h), jp)
        proj = torch.nn.Linear(32, DT)
        with torch.no_grad():
            proj.weight.copy_(torch.from_numpy(np.asarray(jp["proj"]["kernel"]).T.copy()))
            proj.bias.copy_(torch.from_numpy(np.array(jp["proj"]["bias"])))
        ht = torch.from_numpy(h).requires_grad_(True)
        got = e2e_vae.repa_alignment_loss(ht, torch.from_numpy(t), proj, torch.from_numpy(w), kind)
        got.backward()
        assert abs(float(got.detach()) - float(want)) <= LOSS_TOL
        for a, b in ((ht.grad, dh), (proj.weight.grad.t(), dp["proj"]["kernel"]),
                     (proj.bias.grad, dp["proj"]["bias"])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_RTOL, atol=GRAD_ATOL)
        assert torch.isfinite(ht.grad[3]).all()

    def test_unknown_alignment_type_raises(self):
        proj = torch.nn.Linear(4, 3)
        with pytest.raises(ValueError, match="alignment_type"):
            e2e_vae.repa_alignment_loss(torch.zeros(2, 4), torch.zeros(2, 3), proj,
                                        alignment_type="dot")

    def test_init_repa_params(self):
        lin = e2e_vae.init_repa_params(torch.Generator().manual_seed(0), 64, E2E_CFG.e2e)
        assert lin.weight.shape == (DT, 64) and not lin.bias.any()
        assert float(lin.weight.abs().max()) <= 64**-0.5
        again = e2e_vae.init_repa_params(torch.Generator().manual_seed(0), 64, E2E_CFG.e2e)
        assert torch.equal(lin.weight, again.weight)


class TestTrainForward:
    def test_losses_and_every_gradient(self, params):
        batch, key = e2e_batch(), jax.random.PRNGKey(1)
        jbn = je2e.BatchNormState.create(4)

        def loss(p):
            out = jbagel.train_forward(p, E2E_CFG, jax_batch(batch), key, bn_state=jbn)
            return out["loss"], out

        # one compiled program (op by op, the gradient took ~4x as long to compile)
        (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
        model = port_model(params, E2E_CFG)
        for p in model.parameters():
            p.requires_grad_(True)
        got = bagel.train_forward(model, batch, noise=replay_noise(key, batch),
                                  bn_state=e2e_vae.BatchNormState.create(4))
        assert sorted(got) == sorted(want)
        for k in ("mse", "ce", "repa_align", "repa_vae_align", "loss"):
            assert abs(float(got[k]) - float(want[k])) <= LOSS_TOL, k
        got["loss"].backward()
        named = [(n, np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy())
                 for n, p in model.named_parameters()]
        assert assert_tree_close(named, jax_state_dict(grads, E2E_CFG), GRAD_RTOL,
                                 GRAD_ATOL) > 60
        assert model.repa_proj.weight.grad.any() and model.repa_vae_proj.weight.grad.any()


class TestTrainStep:
    def test_bn_state_and_parameters_after_a_step(self, params):
        from unimedvl_tpu.training.dataset import stack_packed

        stacked = stack_packed([e2e_batch(0), e2e_batch(1)])
        key, lr = jax.random.PRNGKey(10), 1e-3
        opt = jtrainer.make_optimizer(learning_rate=lr)
        jstate = jtrainer.create_train_state(jax.tree.map(jnp.array, params), opt, E2E_CFG)
        jstate, want_loss = jtrainer.train_step(jstate, E2E_CFG, jax_batch(stacked), key,
                                                optimizer=opt)
        model = port_model(params, E2E_CFG)
        step, init_state = trainer.make_train_step(
            port_config(E2E_CFG), model, optimizer=trainer.make_optimizer(learning_rate=lr))
        state = init_state()
        assert torch.equal(state.bn_state.var, torch.ones(4))
        state, loss = step(state, stacked, noises=_replay_batch_noise(key, stacked))
        assert abs(float(loss) - float(want_loss)) <= LOSS_TOL
        for a, b in ((state.bn_state.mean, jstate.bn_state.mean),
                     (state.bn_state.var, jstate.bn_state.var)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=BN_RTOL, atol=BN_ATOL)
        got = [(n, p.detach().numpy()) for n, p in model.named_parameters()]
        assert assert_tree_close(got, jax_state_dict(jstate.params, E2E_CFG), PARAM_TOL,
                                 PARAM_TOL) > 60
