"""GPipe training of the port (``parallel/pp_train.py``,
``make_pp_train_step``) on spawned gloo ranks against the JAX package's
``pipeline_train_loss`` and ``make_pp_train_step`` (the counterpart of
tests/test_pp_train.py).

TINY (two layers: one a stage at S = 2), fp32, ``llm2vae_zero=False``;
microbatches are packed sequences of text, a ViT image and latent tokens,
their flow noise replayed from the JAX keys. One spawn per mesh shape runs
every case of that shape (``tools/dryrun_train.run_train_cases``): ("pipe",)
with M 2 and 4, ("pipe", "model") (2, 2) with the loss and gradients and one
train step; ("data", "pipe", "model") (2, 2, 2) is
tests/test_torch_pp_train_3d.py. Each port program is held
to the JAX ``pipeline_train_loss`` on the same mesh and to one JAX
``make_pp_train_step`` step, on the virtual CPU devices of
tests/conftest.py: the loss within rtol 2e-5, every gradient
and every parameter after the step within rtol 2e-4 / atol 2e-6 (the JAX
suite's FSDP-against-TP tolerances, tests/test_training.py), but for the
attention key biases after the step (:data:`ZERO_GRAD`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from unimedvl_tpu.parallel import create_mesh, pipeline_train_loss
from unimedvl_tpu.parallel.pp_train import place_params_pp
from unimedvl_tpu.training import trainer as jtrainer
from unimedvl_tpu_torch.parallel import mesh as pmesh
from unimedvl_tpu_torch.parallel import pp_train
from unimedvl_tpu_torch.tools import dryrun_train

from tests.test_torch_config import init_params, port_config
from tests.test_torch_train import CFG, _replay_batch_noise, jax_state_dict, port_model

RANKS_TIMEOUT_S = 240.0
LOSS_RTOL = 2e-5
TOL = dict(rtol=2e-4, atol=2e-6)
LR = 1e-3
# the attention key biases: a softmax over the keys is invariant to them, so their gradient is
# zero in exact arithmetic and rounding noise in either package (held to zero within atol in the
# gradient tests); AdamW scales that noise up to a step of about lr, so after the step each entry
# is held to the reference within LR instead of the parameters' tolerance
ZERO_GRAD = ("self_attn.k_proj.bias", "self_attn.k_proj_moe_gen.bias")


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


@pytest.fixture(scope="module")
def pipe_model_ranks(params, micro):
    batch, _, noises = micro[2]
    step = dict(batches=[batch], noises=[noises], pipe=True, lr=LR)
    return _spawn(params, ("pipe", "model"), (2, 2), [_grads_case(micro, 2), step])


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

    def test_refusals(self, params):
        """L % S, and the feature tap, as the JAX pipeline asserts them."""
        mesh = pmesh.Mesh(("pipe",), {"pipe": 4}, 0, {"pipe": 0}, {"pipe": None})
        with pytest.raises(ValueError, match="not divisible by pipe stages 4"):
            pp_train.place_params_pp(port_model(params), mesh)
        mesh = pmesh.Mesh(("data", "model"), {"data": 1, "model": 1}, 0,
                          {"data": 0, "model": 0}, {"data": None, "model": None})
        with pytest.raises(ValueError, match="pipeline mesh"):
            pp_train.place_params_pp(port_model(params), mesh)
