"""GPipe training of the port on a ("data", "pipe", "model") (2, 2, 2) mesh
of spawned gloo ranks against the JAX package's ``pipeline_train_loss`` on
the same mesh of 8 virtual CPU devices (the counterpart of
tests/test_pp_train.py::test_pp_dp_tp_3d_parity): each data slice runs its
own pipeline over 2 of the 4 microbatches, TP inside each stage. The setup
and tolerances are tests/test_torch_pp_train.py's (the loss within rtol
2e-5, every gradient within rtol 2e-4 / atol 2e-6); a file of its own so
that each file's JAX programs and spawns stay short. The same spawn runs one
train step eagerly and by its program (``graphs=True``: the plain route of
``trainer.PipelineProgram`` over a data rank's padded microbatches), held
to each other within 1e-5 (the attention key biases within the learning
rate, as the file above holds them).
"""

import pytest

from tests.test_torch_config import init_params, port_config
from tests.test_torch_pp_train import (CFG, EAGER_TOL, LR, _check_grads, _grads_case, _jax_grads,
                                       _micro, _spawn, eager_tol)

AXES, SIZES = ("data", "pipe", "model"), (2, 2, 2)


@pytest.fixture(scope="module")
def params():
    return init_params(0, CFG, llm2vae_zero=False)


@pytest.fixture(scope="module")
def micro():
    return {4: _micro(4)}


@pytest.fixture(scope="module")
def ranks(params, micro):
    """Cases: 0 the gradients; 1 one eager step; 2 the same step by its
    program."""
    batch, _, noises = micro[4]
    step = dict(batches=[batch], noises=[noises], pipe=True, lr=LR)
    return _spawn(params, AXES, SIZES, [_grads_case(micro, 4), dict(step, graphs=False),
                                        dict(step, graphs=True)])


def test_data_pipe_model_loss_and_grads(params, micro, ranks):
    """("data", "pipe", "model") (2, 2, 2): the loss and every gradient of
    every rank against the JAX mesh program's."""
    want = _jax_grads(params, SIZES, AXES, *micro[4][:2])
    _check_grads(ranks, 0, *want, AXES, SIZES)


def test_data_pipe_model_program_step_equals_the_eager_step(ranks):
    """One step by the program against the eager step on every rank: the
    loss and every parameter within 1e-5 (the key biases within LR); the
    tensors replicated over the
    mesh bit-equal on every rank that holds them."""
    import numpy as np

    from unimedvl_tpu_torch.tools import dryrun_train

    shape = dict(zip(AXES, SIZES))
    llm = port_config(CFG).llm
    for r in ranks:
        prog, eager = r[2], r[1]
        assert prog["train_buckets"] == [1]
        np.testing.assert_allclose(prog["losses"], eager["losses"], **EAGER_TOL)
        assert prog["params"].keys() == eager["params"].keys()
        for name, t in prog["params"].items():
            np.testing.assert_allclose(t, eager["params"][name], err_msg=name, **eager_tol(name))
    sums = [r[2]["checksums"] for r in ranks]
    names = [n for n in sums[0] if dryrun_train.replicated(n, llm, shape, False, True)]
    assert len(names) > 50
    assert all(s[n] == sums[0][n] for s in sums[1:] for n in names)
