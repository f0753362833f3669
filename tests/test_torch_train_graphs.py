"""The training steps as programs (``training.trainer.TrainProgram``), on the
CPU in fp32 (TINY config of tests/test_pipeline.py): the program's plain
route (``graphs=True``: the same bodies over the same static buffers that a
card captures, run op by op) against the eager step, which strips the
padding on the host, and against the JAX package's jitted steps.

The batches are ``tests/test_torch_train.py::_stacked``: B = 2, packed with
``pad_multiple=16``, so every list has padding slots (text, und, gen, CE, the
latent block) and one ViT image has invalid rows; the second sequence has
no latents (``stack_packed``'s neutral block: a latent block without a real
row). The JAX noise is replayed as the port's ``noises`` (real rows only).

Tolerances: against the eager step, losses 1e-5 absolute and every
parameter, EMA tensor and batch-norm statistic 1e-5 (fp32 sums over the
padded and the stripped shapes in another order); against JAX, losses
test_torch_train.py's 1e-5 and every parameter rtol 2e-4 / atol 2e-6, the
mesh tests' tolerance (tests/test_torch_train_mesh.py), the attention key
biases within the learning rate (their gradient is zero in exact arithmetic,
rounding noise that AdamW scales up to a step of about lr); adapters after
two quantized steps test_torch_qlora.py's 2e-4.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unimedvl_tpu.config import E2EVAEConfig as JE2E
from unimedvl_tpu.parallel.mesh import create_mesh
from unimedvl_tpu.training import e2e_vae as je2e
from unimedvl_tpu.training import lora as jlora
from unimedvl_tpu.training import trainer as jtrainer
from unimedvl_tpu_torch.inference import programs
from unimedvl_tpu_torch.models import bagel
from unimedvl_tpu_torch.scripts import toy_overfit
from unimedvl_tpu_torch.training import dataset, lora, trainer

from tests.test_torch_config import init_params, port_config
from tests.test_torch_e2e_vae import e2e_batch
from tests.test_torch_lora import _randomize_b
from tests.test_torch_qlora import ADAPTER_ATOL, _quantized_jax
from tests.test_torch_train import (
    CFG, LOSS_TOL, _replay_batch_noise, _stacked, jax_batch, jax_state_dict, make_batch,
    port_model,
)

EAGER_TOL = dict(rtol=1e-5, atol=1e-5)
JAX_TOL = dict(rtol=2e-4, atol=2e-6)
LR = 1e-3
FZ = dataclasses.replace(CFG, llm=dataclasses.replace(CFG.llm, freeze_und=True))
E2E = dataclasses.replace(CFG, e2e=JE2E(enable_batch_norm=True, teacher_feature_dim=12,
                                        diffusion_feature_layer=0))


@pytest.fixture(scope="module")
def params():
    return init_params(0, CFG, llm2vae_zero=False)


def _two_calls():
    """Two calls of accumulation 2: [accum 2, B 2, ...] stacked batches."""
    first = _stacked()
    second = {k: v[::-1].copy() for k, v in first.items()}
    return [{k: np.stack([first[k], second[k]]) for k in first},
            {k: np.stack([second[k], first[k]]) for k in first}]


def _run(model, cfg, calls, graphs, noises=None, generator=None, **kw):
    """(losses, the state) after the calls of ``make_train_step(**kw)``."""
    step, init_state = trainer.make_train_step(
        port_config(cfg), model, trainer.make_optimizer(learning_rate=LR), graphs=graphs, **kw)
    state, losses = init_state(), []
    for i, batch in enumerate(calls):
        state, loss = step(state, batch, generator=generator,
                           noises=None if noises is None else noises[i])
        losses.append(float(loss))
    return losses, state


def _assert_named_close(got, want, tol, exempt=()):
    checked = 0
    for name, t in got.items():
        if name.startswith("vae_model."):
            continue
        w = want[name]
        t = t.detach().numpy() if isinstance(t, torch.Tensor) else t
        w = w.detach().numpy() if isinstance(w, torch.Tensor) else w
        if name.endswith(exempt):
            np.testing.assert_allclose(t, w, rtol=0, atol=LR, err_msg=name)
        else:
            np.testing.assert_allclose(t, w, err_msg=name, **tol)
        checked += 1
    return checked


def _params_of(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


KEY_BIASES = ("k_proj.bias", "k_proj_moe_gen.bias")


class TestPaddedAgainstStripped:
    @pytest.mark.parametrize("freeze_und", [False, True], ids=["all", "freeze_und"])
    def test_program_equals_the_stripped_eager_step(self, params, freeze_und):
        """Two calls of accumulation 2 with the EMA, the flow noise drawn
        from one generator: the loss, every updated leaf and the EMA after
        both, and the generator where the eager step leaves it."""
        cfg = FZ if freeze_und else CFG
        base = port_model(params, cfg)
        calls = _two_calls()
        out = {}
        for graphs in (False, True):
            model = copy.deepcopy(base)
            g = torch.Generator().manual_seed(7)
            losses, state = _run(model, cfg, calls, graphs, generator=g, accum_steps=2,
                                 ema_decay=0.9)
            out[graphs] = (losses, _params_of(model), state.ema_params, g.get_state())
        np.testing.assert_allclose(out[True][0], out[False][0], rtol=0, atol=LOSS_TOL)
        assert _assert_named_close(out[True][1], out[False][1], EAGER_TOL) > 60
        assert _assert_named_close(out[True][2], out[False][2], EAGER_TOL) > 60
        assert torch.equal(out[True][3], out[False][3])
        if freeze_und:
            frozen = [n for n, lab in trainer._freeze_und_labels(base).items() if lab == "freeze"]
            before = _params_of(base)
            assert frozen and all(torch.equal(out[True][1][n], before[n]) for n in frozen)

    def test_prepared_padded_sequences_and_the_place_fn(self, params):
        """Each route prepares what it is given for itself: the program
        takes the place function's sequences (stripped on the CPU, the
        eager step's default there) and the eager step padded ones, each
        prepared again from its host arrays; a dict of tensors without them
        is refused by the program."""
        calls = [_stacked()]
        noises = [_replay_batch_noise(jax.random.PRNGKey(3), calls[0])]
        want, _ = _run(port_model(params), CFG, calls, False, noises)
        placed = dataset.make_place_fn("cpu")(calls[0])
        assert not any(bagel.is_padded(s) for s in placed)
        padded = trainer.prepared(calls[0], "cpu", True)
        assert all(bagel.is_padded(s) for s in padded)
        for graphs, seqs in ((True, placed), (False, padded), (True, padded)):
            got, _ = _run(port_model(params), CFG, [seqs], graphs, noises)
            np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_TOL)
        bare = [dict(s) for s in placed]
        with pytest.raises(ValueError, match="with their padding"):
            _run(port_model(params), CFG, [bare], True, noises)


class TestAgainstJax:
    def test_train_step_program_equals_the_jax_step(self):
        """``make_train_step`` with accumulation 2, the EMA and
        ``freeze_und`` by its program against the JAX ``make_train_step``
        on the same padded batch."""
        params = init_params(0, FZ, llm2vae_zero=False)
        two = _two_calls()[0]
        key = jax.random.PRNGKey(5)
        mesh = create_mesh((1, 1), devices=jax.devices()[:1])
        jstep, jinit = jtrainer.make_train_step(
            FZ, mesh, params, optimizer=jtrainer.make_optimizer(learning_rate=LR),
            accum_steps=2, ema_decay=0.9)
        with jax.set_mesh(mesh):
            jstate, want_loss = jstep(jinit(), jax_batch(two), key)
        noises = [_replay_batch_noise(k, {n: v[i] for n, v in two.items()})
                  for i, k in enumerate(jax.random.split(key, 2))]
        model = port_model(params, FZ)
        losses, state = _run(model, FZ, [two], True, [noises], accum_steps=2, ema_decay=0.9)
        assert abs(losses[0] - float(want_loss)) <= LOSS_TOL
        assert _assert_named_close(_params_of(model), jax_state_dict(jstate.params, FZ),
                                   JAX_TOL, KEY_BIASES) > 60
        assert _assert_named_close(state.ema_params, jax_state_dict(jstate.ema_params, FZ),
                                   JAX_TOL, KEY_BIASES) > 60

    @pytest.mark.parametrize("mode", ["bf16", "qa", "p4a"])
    def test_lora_program_equals_the_jax_lean_step(self, params, mode):
        """The LoRA step by its program against the JAX lean step for two
        calls: bf16 adapters, and QLoRA over the full-int8 (``qa``) and the
        w4a8 (``p4a``) bases, adapters on every projection of both experts."""
        base = params if mode == "bf16" else _quantized_jax(params, mode, 0)
        jparams = _randomize_b(jlora.add_lora(base, jax.random.PRNGKey(3), rank=4,
                                              dtype=jnp.float32))
        stacked = _stacked()
        keys = [jax.random.PRNGKey(20), jax.random.PRNGKey(21)]
        jstep, adapters, opt_state, jbase, combine = jlora.make_lora_train_step(
            CFG, jax.tree.map(jnp.array, jparams))
        want_losses = []
        for key in keys:
            adapters, opt_state, loss = jstep(adapters, opt_state, jbase, jax_batch(stacked), key)
            want_losses.append(float(loss))
        want = jax_state_dict(combine(adapters, jbase))
        model = port_model(jparams)
        frozen = {k: v.clone() for k, v in model.state_dict().items()
                  if not k.endswith(("lora_a", "lora_b"))}
        step, state = lora.make_lora_train_step(port_config(CFG), model, graphs=True)
        losses = []
        for key in keys:
            state, loss = step(state, stacked, noises=_replay_batch_noise(key, stacked))
            losses.append(float(loss))
        np.testing.assert_allclose(losses, want_losses, rtol=0, atol=LOSS_TOL)
        tol = JAX_TOL if mode == "bf16" else dict(rtol=0, atol=ADAPTER_ATOL)
        moved = 0
        for name, t in model.state_dict().items():
            if name in frozen:
                assert torch.equal(t, frozen[name]), name
            else:
                np.testing.assert_allclose(t.numpy(), want[name], err_msg=name, **tol)
                moved += 1
        assert moved == 2 * 2 * 14


@pytest.fixture(scope="module")
def e2e_params():
    """The JAX e2e tree as tests/test_torch_e2e_vae.py builds it."""
    tree = dict(init_params(0, CFG, llm2vae_zero=False))
    k_d, k_v = jax.random.split(jax.random.split(jax.random.PRNGKey(0), 10)[9])
    tree["repa_proj"] = je2e.init_repa_params(k_d, CFG.llm.hidden_size, E2E.e2e)
    tree["repa_vae_proj"] = je2e.init_repa_params(k_v, CFG.patch_latent_dim, E2E.e2e)
    return tree


class TestE2EExtras:
    def test_program_equals_the_jax_step_without_padding_rows(self, e2e_params):
        """The latent batch-norm and both REPA terms: the program's step on
        two sequences whose latent blocks have no padding rows against the
        JAX ``train_step``: loss, ``bn_state`` and every parameter."""
        stacked = dataset.stack_packed([e2e_batch(0), e2e_batch(1)])
        key = jax.random.PRNGKey(10)
        opt = jtrainer.make_optimizer(learning_rate=LR)
        jstate = jtrainer.create_train_state(jax.tree.map(jnp.array, e2e_params), opt, E2E)
        jstate, want_loss = jtrainer.train_step(jstate, E2E, jax_batch(stacked), key,
                                                optimizer=opt)
        model = port_model(e2e_params, E2E)
        losses, state = _run(model, E2E, [stacked], True,
                             [_replay_batch_noise(key, stacked)])
        assert abs(losses[0] - float(want_loss)) <= LOSS_TOL
        for a, b in ((state.bn_state.mean, jstate.bn_state.mean),
                     (state.bn_state.var, jstate.bn_state.var)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
        assert _assert_named_close(_params_of(model), jax_state_dict(jstate.params, E2E),
                                   JAX_TOL, KEY_BIASES) > 60

    def test_program_equals_the_eager_step_with_padding_rows(self, e2e_params):
        """A latent block with padding rows (``pad_multiple=16``) and a
        sequence without latents, accumulation 2: the program's batch-norm
        statistics over the real rows, its state and every parameter equal
        the eager step's, which strips those rows."""
        padded = make_batch()
        n = padded["vae_clean_tokens"].shape[0]
        real = int((padded["vae_scatter_idx"] < padded["packed_position_ids"].shape[0]).sum())
        assert real < n
        padded["repa_teacher_features"] = np.random.default_rng(4).standard_normal(
            (n, 12)).astype(np.float32)
        stacked = dataset.stack_packed([padded, make_batch(with_vae=False, seed=1)])
        calls = [{k: np.stack([stacked[k], stacked[k][::-1]]) for k in stacked}]
        out = {}
        for graphs in (False, True):
            model = port_model(e2e_params, E2E)
            g = torch.Generator().manual_seed(2)
            losses, state = _run(model, E2E, calls * 2, graphs, generator=g, accum_steps=2)
            out[graphs] = (losses, _params_of(model), state.bn_state)
        np.testing.assert_allclose(out[True][0], out[False][0], rtol=0, atol=LOSS_TOL)
        assert _assert_named_close(out[True][1], out[False][1], EAGER_TOL) > 60
        for a, b in ((out[True][2].mean, out[False][2].mean), (out[True][2].var,
                                                                out[False][2].var)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        assert not torch.equal(out[True][2].var, torch.ones_like(out[True][2].var))


class TestPrograms:
    def test_buckets_and_their_programs(self, params):
        """Two batches of one bucket replay one bucket program; a third
        bucket (another layout) makes a second; both under the step's
        program, dropped with the step."""
        programs.drop_all()
        model = port_model(params)
        step, init_state = trainer.make_train_step(port_config(CFG), model, graphs=True)
        state = init_state()

        def buckets():
            return [p for p in programs.programs() if p.family == "train"]

        def one(batch):  # a batch of one sequence
            return {k: v[None] for k, v in batch.items()}

        g = torch.Generator().manual_seed(0)
        step(state, one(make_batch()), generator=g)
        step(state, one(make_batch(seed=3)), generator=g)  # other values, the same bucket
        assert len(buckets()) == 1
        step(state, one(make_batch(with_vit=False)), generator=g)
        assert len(buckets()) == 2
        assert sum(isinstance(p, trainer.TrainProgram) for p in programs.programs()) == 1
        del step
        assert not buckets() and not programs.programs()

    def test_gradients_are_the_programs_own(self, params):
        """The program binds its preallocated gradients as ``.grad`` and
        leaves them zeroed after the update; an eager pass in between that
        drops them does not leak into the next call."""
        model = port_model(params)
        step, init_state = trainer.make_train_step(port_config(CFG), model, graphs=True)
        state = init_state()
        calls = [_stacked()] * 3
        noises = [_replay_batch_noise(jax.random.PRNGKey(3), calls[0])] * 3
        state, _ = step(state, calls[0], noises=noises[0])
        grads = [p.grad for p in state.optimizer.param_groups[0]["params"]]
        assert all(g is not None and not g.any() for g in grads)
        trainer.loss_fn(model, calls[0], noises[0], backward_scale=1.0)  # adds into them
        for p in model.parameters():
            p.grad = None
        state, got = step(state, calls[1], noises=noises[1])
        twin = port_model(params)
        tstep, tinit = trainer.make_train_step(port_config(CFG), twin, graphs=True)
        tstate, _ = tstep(tinit(), calls[0], noises=noises[0])
        tstate, want = tstep(tstate, calls[1], noises=noises[1])
        assert float(got) == float(want)
        for (n, a), b in zip(model.named_parameters(), twin.parameters()):
            assert torch.equal(a, b), n

    def test_refusals(self, params):
        """An optimizer the program cannot update with: ``graphs=True``
        refuses it and names the reason; ``graphs=False`` runs it eagerly."""
        sgd = lambda p: torch.optim.SGD(p, lr=LR)  # noqa: E731
        calls = [_stacked()]
        noises = [_replay_batch_noise(jax.random.PRNGKey(3), calls[0])]
        step, init_state = trainer.make_train_step(port_config(CFG), port_model(params), sgd,
                                                   graphs=True)
        with pytest.raises(ValueError, match="Adam or AdamW, got SGD"):
            step(init_state(), calls[0], noises=noises[0])
        step, init_state = trainer.make_train_step(port_config(CFG), port_model(params), sgd,
                                                   graphs=False)
        assert np.isfinite(float(step(init_state(), calls[0], noises=noises[0])[1]))


def test_toy_overfit_by_the_program(tmp_path, monkeypatch):
    """``scripts.toy_overfit``'s loop (its prefetcher and place function)
    with the step forced onto its program, as a card runs it by default."""
    runs = []
    make, run = trainer.make_train_step, trainer.TrainProgram.run
    monkeypatch.setattr(trainer, "make_train_step",
                        lambda *a, **kw: make(*a, **{**kw, "graphs": True}))
    monkeypatch.setattr(trainer.TrainProgram, "run",
                        lambda self, *a, **kw: runs.append(1) or run(self, *a, **kw))
    out = tmp_path / "curve.json"
    assert toy_overfit.main(["--out", str(out), "--steps", "25", "--device", "cpu"]) == 0
    assert len(runs) == 25
