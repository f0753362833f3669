"""GPipe training of the port (``parallel/pp_train.py``,
``make_pp_train_step``) on spawned gloo ranks against the JAX package's
``pipeline_train_loss`` and ``make_pp_train_step`` (the counterpart of
tests/test_pp_train.py).

TINY (two layers: one a stage at S = 2), fp32, ``llm2vae_zero=False``;
microbatches are packed sequences of text, a ViT image and latent tokens,
their flow noise replayed from the JAX keys. One spawn per mesh shape runs
every case of that shape (``tools/dryrun_train.run_train_cases``): ("pipe",)
with M 2 and 4, ("pipe", "model") (2, 2) with the loss and gradients and one
train step, eagerly and by the step's program (``graphs=True``: on the
CPU the plain route of ``trainer.PipelineProgram``, the bodies a card
captures run op by op over padded microbatches); ("data", "pipe", "model")
(2, 2, 2) is tests/test_torch_pp_train_3d.py. Each port program is held
to the JAX ``pipeline_train_loss`` on the same mesh and to one JAX
``make_pp_train_step`` step, on the virtual CPU devices of
tests/conftest.py: the loss within rtol 2e-5, every gradient
and every parameter after the step within rtol 2e-4 / atol 2e-6 (the JAX
suite's FSDP-against-TP tolerances, tests/test_training.py), but for the
attention key biases after the step (:data:`ZERO_GRAD`). The program's
step is held to the eager step of the same spawn within 1e-5
(:data:`EAGER_TOL`, tests/test_torch_train_graphs.py's bound of the padded
against the stripped computation), the key biases within LR.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unimedvl_tpu.parallel import create_mesh, pipeline_train_loss
from unimedvl_tpu.parallel.pp_train import place_params_pp
from unimedvl_tpu.training import trainer as jtrainer
from unimedvl_tpu_torch.parallel import mesh as pmesh
from unimedvl_tpu_torch.parallel import pp_train
from unimedvl_tpu_torch.tools import dryrun_train

from tests.test_torch_config import init_params, port_config
from tests.test_torch_train import (CFG, _replay_batch_noise, jax_state_dict, make_batch,
                                   port_model)
from tests.test_torch_train_graphs import E2E, e2e_params  # noqa: F401 (fixture)

RANKS_TIMEOUT_S = 240.0
LOSS_RTOL = 2e-5
TOL = dict(rtol=2e-4, atol=2e-6)
LR = 1e-3
EAGER_TOL = dict(rtol=1e-5, atol=1e-5)
# the attention key biases: a softmax over the keys is invariant to them, so their gradient is
# zero in exact arithmetic and rounding noise in either package (held to zero within atol in the
# gradient tests); AdamW scales that noise up to a step of about lr, so after the step each entry
# is held to the reference within LR instead of the parameters' tolerance
ZERO_GRAD = ("self_attn.k_proj.bias", "self_attn.k_proj_moe_gen.bias")


def eager_tol(name: str) -> dict:
    """The program's step against the eager step: :data:`EAGER_TOL`, and
    the attention key biases (:data:`ZERO_GRAD`: rounding noise of another
    order of sums, scaled by AdamW) within LR."""
    return dict(rtol=0, atol=LR) if name.endswith(ZERO_GRAD) else EAGER_TOL


@pytest.fixture(scope="module")
def params():
    return init_params(0, CFG, llm2vae_zero=False)


def _micro(m, seed=0):
    batch = dryrun_train.tiny_batches(port_config(CFG), m, seed=seed)
    key = jax.random.PRNGKey(7 + m)
    noises = [None if n is None else n.numpy() for n in _replay_batch_noise(key, batch)]
    return batch, key, noises


@pytest.fixture(scope="module")
def micro():
    return {m: _micro(m) for m in (2, 4)}


def _jax_grads(params, shape, axes, batch, key):
    mesh = create_mesh(shape, axes, devices=jax.devices()[:int(np.prod(shape))])
    placed = place_params_pp(params, mesh, cfg=CFG if "model" in axes else None)
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    with jax.set_mesh(mesh):
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: pipeline_train_loss(p, CFG, mesh, b, key)[0]))(placed)
    return float(loss), jax_state_dict(grads)


@pytest.fixture(scope="module")
def jax_side(params, micro):
    """Every JAX program this file holds the port to, run once."""
    out = {
        "pipe2": _jax_grads(params, (2,), ("pipe",), *micro[2][:2]),
        "pipe4": _jax_grads(params, (2,), ("pipe",), *micro[4][:2]),
        "pipe_model": _jax_grads(params, (2, 2), ("pipe", "model"), *micro[2][:2]),
    }
    mesh = create_mesh((2, 2), ("pipe", "model"), devices=jax.devices()[:4])
    step, init_state = jtrainer.make_pp_train_step(
        CFG, mesh, params, optimizer=jtrainer.make_optimizer(learning_rate=LR))
    batch, key, _ = micro[2]
    with jax.set_mesh(mesh):
        state, loss = step(init_state(), {k: jnp.asarray(v) for k, v in batch.items()}, key)
    out["step"] = (float(loss), jax_state_dict(state.params))
    return out


def _spawn(params, axes, sizes, cases):
    return pmesh.run_on_ranks(dryrun_train.run_train_cases, int(np.prod(sizes)), axes, sizes,
                              {"base": port_model(params)}, cases, timeout_s=RANKS_TIMEOUT_S)


def _grads_case(micro, m):
    batch, _, noises = micro[m]
    return dict(batches=[batch], noises=[noises], pipe=True, grads=True)


@pytest.fixture(scope="module")
def pipe_ranks(params, micro):
    return _spawn(params, ("pipe",), (2,), [_grads_case(micro, 2), _grads_case(micro, 4)])


def _two_calls(micro):
    """Two calls of M = 2: ``micro[2]``'s batch, then one of the same bucket
    with other values (another seed), with their noises."""
    batch, _, noises = micro[2]
    batch2, _, noises2 = _micro(2, seed=1)
    return dict(batches=[batch, batch2], noises=[noises, noises2])


@pytest.fixture(scope="module")
def pipe_model_ranks(params, micro):
    """Cases: 0 the gradients; 1 one eager step; 2 the program's step
    (``graphs=True``) on the same batch, then a second call in its bucket;
    3 the same two calls eagerly."""
    batch, _, noises = micro[2]
    step = dict(batches=[batch], noises=[noises], pipe=True, lr=LR)
    program = dict(_two_calls(micro), pipe=True, lr=LR, graphs=True, first_params=True)
    eager = dict(_two_calls(micro), pipe=True, lr=LR, graphs=False)
    return _spawn(params, ("pipe", "model"), (2, 2),
                  [_grads_case(micro, 2), step, program, eager])


def _check_grads(per_rank, i, want_loss, want, axes, sizes):
    shape = dict(zip(axes, sizes))
    llm = port_config(CFG).llm
    seen = set()
    for r in per_rank:
        got = r[i]
        np.testing.assert_allclose(got["loss"], want_loss, rtol=LOSS_RTOL)
        for name, g in got["grads"].items():
            part = dryrun_train.rank_part(name, want[name], llm, shape, got["coords"])
            np.testing.assert_allclose(g, part, err_msg=f"{name} at {got['coords']}", **TOL)
            seen.add(name)
    # every trained tensor of the whole model has a gradient on some rank
    trained = {n for n in want if not n.startswith("vae_model.")}
    assert trained <= seen, sorted(trained - seen)[:5]


class TestPipeline:
    @pytest.mark.parametrize("m,i", [(2, 0), (4, 1)])
    def test_pipe_loss_and_grads(self, jax_side, pipe_ranks, m, i):
        """("pipe",), 2 stages of one layer, M 2 and 4."""
        _check_grads(pipe_ranks, i, *jax_side[f"pipe{m}"], ("pipe",), (2,))

    def test_pipe_model_loss_and_grads(self, jax_side, pipe_model_ranks):
        """("pipe", "model") (2, 2): TP inside each stage."""
        _check_grads(pipe_model_ranks, 0, *jax_side["pipe_model"], ("pipe", "model"), (2, 2))

    def test_pp_train_step_equals_jax(self, params, jax_side, pipe_model_ranks):
        """One ``make_pp_train_step`` step on ("pipe", "model") (2, 2): the loss
        and every parameter after it as JAX's; each stage holds its layer;
        the replicated tensors are bit-equal on the ranks of each "pipe"
        pair and the layer-free ones on every rank."""
        want_loss, want = jax_side["step"]
        shape = {"pipe": 2, "model": 2}
        llm = port_config(CFG).llm
        vae = {n: t.numpy() for n, t in port_model(params).state_dict().items()
               if n.startswith("vae_model.")}
        for r in pipe_model_ranks:
            got = r[1]
            np.testing.assert_allclose(got["losses"][0], want_loss, rtol=LOSS_RTOL)
            layers = {n.split(".")[3] for n in got["params"]
                      if n.startswith(dryrun_train.LAYERS)}
            assert layers == {str(got["coords"]["pipe"])}
            for name, t in got["params"].items():
                part = dryrun_train.rank_part(name, {**want, **vae}[name], llm, shape,
                                              got["coords"])
                tol = dict(rtol=0, atol=LR) if name.endswith(ZERO_GRAD) else TOL
                np.testing.assert_allclose(t, part, err_msg=name, **tol)
        names = [n for n in pipe_model_ranks[0][1]["checksums"]
                 if dryrun_train.replicated(n, llm, shape, False, pipe=True)]
        assert len(names) > 50
        for r in pipe_model_ranks[1:]:
            for n in names:
                assert r[1]["checksums"][n] == pipe_model_ranks[0][1]["checksums"][n], n

    def test_pp_program_step_equals_jax_and_the_eager_step(self, params, jax_side,
                                                            pipe_model_ranks):
        """The step by its program (``graphs=True``, the plain route over
        gloo) on ("pipe", "model") (2, 2): the first call's loss and every
        parameter after it as JAX's ``make_pp_train_step`` and within 1e-5 of
        the eager step's; the second call (new values in the first call's
        bucket: no new bucket) within 1e-5 of the eager second call; after
        each, the replicated tensors bit-equal on the ranks of each "pipe"
        pair (the layer-free ones on every rank)."""
        want_loss, want = jax_side["step"]
        shape = {"pipe": 2, "model": 2}
        llm = port_config(CFG).llm
        vae = {n: t.numpy() for n, t in port_model(params).state_dict().items()
               if n.startswith("vae_model.")}
        for r in pipe_model_ranks:
            prog, eager_one, eager_two = r[2], r[1], r[3]
            assert prog["train_buckets"] == [1, 1]
            np.testing.assert_allclose(prog["losses"][0], want_loss, rtol=LOSS_RTOL)
            np.testing.assert_allclose(prog["losses"], eager_two["losses"], **EAGER_TOL)
            for name, t in prog["first_params"].items():
                part = dryrun_train.rank_part(name, {**want, **vae}[name], llm, shape,
                                              prog["coords"])
                tol = dict(rtol=0, atol=LR) if name.endswith(ZERO_GRAD) else TOL
                np.testing.assert_allclose(t, part, err_msg=name, **tol)
                np.testing.assert_allclose(t, eager_one["params"][name], err_msg=name,
                                           **eager_tol(name))
            for name, t in prog["params"].items():
                np.testing.assert_allclose(t, eager_two["params"][name], err_msg=name,
                                           **eager_tol(name))
        for key in ("first_checksums", "checksums"):
            sums = [r[2][key] for r in pipe_model_ranks]
            names = [n for n in sums[0] if dryrun_train.replicated(n, llm, shape, False, True)]
            assert len(names) > 50
            assert all(s[n] == sums[0][n] for s in sums[1:] for n in names)

    def test_pp_program_refusals(self, params):
        """The program refuses an optimizer it cannot update with
        (``graphs=True``; ``graphs=False`` runs it eagerly). On a CUDA device
        a gloo "pipe" group takes the eager step under ``graphs=None`` and
        ``graphs=True`` raises, naming the axis and the backend."""
        from unimedvl_tpu_torch.training import trainer

        mesh = pmesh.Mesh(("pipe",), {"pipe": 1}, 0, {"pipe": 0}, {"pipe": None})
        model = pp_train.place_params_pp(port_model(params), mesh)
        sgd = lambda p: torch.optim.SGD(p, lr=LR)  # noqa: E731
        batch, _, noises = _micro(2)
        noises = [None if n is None else torch.from_numpy(n) for n in noises]
        step, init_state = trainer.make_pp_train_step(model.whole_config, model, mesh, sgd,
                                                      graphs=True)
        with pytest.raises(ValueError, match="Adam or AdamW, got SGD"):
            step(init_state(), batch, noises=noises)
        step, init_state = trainer.make_pp_train_step(model.whole_config, model, mesh, sgd,
                                                      graphs=False)
        assert np.isfinite(float(step(init_state(), batch, noises=noises)[1]))

        class Gloo:  # a stand-in group on a stand-in card
            backend = "gloo"

        eager = []
        card = pmesh.Mesh(("pipe",), {"pipe": 1}, 0, {"pipe": 0}, {"pipe": Gloo()})
        cuda = types.SimpleNamespace(device=torch.device("cuda"))
        stand_in = types.SimpleNamespace(language_model=types.SimpleNamespace(
            mesh=card, model=types.SimpleNamespace(embed_tokens=types.SimpleNamespace(
                weight=cuda))))
        state = trainer.TrainState(model=stand_in, optimizer=None, mesh=card)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pmesh, "group_backend", lambda g: g.backend)
            mp.setattr(trainer.PipelineStep, "_eager",
                       lambda self, *a: eager.append(a) or (a[0], None))
            trainer.PipelineStep(CFG, None, graphs=None)(state, batch)
            assert len(eager) == 1
            with pytest.raises(ValueError, match="'pipe' axis runs over gloo"):
                trainer.PipelineStep(CFG, None, graphs=True)(state, batch)

    def test_pp_program_keeps_the_batch_norm_rule(self, e2e_params):
        """The latent batch-norm (``cfg.e2e.enable_batch_norm``) under the
        program: the new state is the mean over the microbatches that carry
        latent rows, each one's statistics over its real rows, as the eager
        step takes it. The second microbatch has no latents
        (``stack_packed``'s neutral block), so this is the recorded
        difference from the JAX step, which averages every sequence
        (ROADMAP.md, queue 3), and the program keeps it. On a one-stage mesh
        without groups, two calls by the program's plain route against the
        eager step: the losses, the state and every parameter that a
        microbatch reaches within 1e-5 (the REPA projections reach none in
        the pipeline, which has no feature tap: the program gives them a zero
        gradient, the eager step none)."""
        from unimedvl_tpu_torch.training import dataset, trainer

        cfg = dataclasses.replace(E2E, e2e=dataclasses.replace(E2E.e2e,
                                                                diffusion_feature_layer=None))
        stacked = dataset.stack_packed([make_batch(), make_batch(with_vae=False, seed=1)])
        mesh = pmesh.Mesh(("pipe",), {"pipe": 1}, 0, {"pipe": 0}, {"pipe": None})
        out = {}
        for graphs in (False, True):
            model = pp_train.place_params_pp(port_model(e2e_params, cfg), mesh)
            step, init_state = trainer.make_pp_train_step(
                model.whole_config, model, mesh, trainer.make_optimizer(learning_rate=LR),
                graphs=graphs)
            state, losses, g = init_state(), [], torch.Generator().manual_seed(2)
            for _ in range(2):
                state, loss = step(state, stacked, generator=g)
                losses.append(float(loss))
            params = {n: p.detach().clone() for n, p in model.named_parameters()
                      if not n.startswith(("repa_", "vae_model."))}
            out[graphs] = (losses, params, state.bn_state)
        np.testing.assert_allclose(out[True][0], out[False][0], **EAGER_TOL)
        for name, t in out[True][1].items():
            np.testing.assert_allclose(t.numpy(), out[False][1][name].numpy(), err_msg=name,
                                       **eager_tol(name))
        for a, b in ((out[True][2].mean, out[False][2].mean),
                     (out[True][2].var, out[False][2].var)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        assert not torch.equal(out[True][2].var, torch.ones_like(out[True][2].var))

    def test_refusals(self, params):
        """L % S, and the feature tap, as the JAX pipeline asserts them."""
        mesh = pmesh.Mesh(("pipe",), {"pipe": 4}, 0, {"pipe": 0}, {"pipe": None})
        with pytest.raises(ValueError, match="not divisible by pipe stages 4"):
            pp_train.place_params_pp(port_model(params), mesh)
        mesh = pmesh.Mesh(("data", "model"), {"data": 1, "model": 1}, 0,
                          {"data": 0, "model": 0}, {"data": None, "model": None})
        with pytest.raises(ValueError, match="pipeline mesh"):
            pp_train.place_params_pp(port_model(params), mesh)
