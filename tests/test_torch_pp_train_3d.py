"""GPipe training of the port on a ("data", "pipe", "model") (2, 2, 2) mesh
of spawned gloo ranks against the JAX package's ``pipeline_train_loss`` on
the same mesh of 8 virtual CPU devices (the counterpart of
tests/test_pp_train.py::test_pp_dp_tp_3d_parity): each data slice runs its
own pipeline over 2 of the 4 microbatches, TP inside each stage. The setup
and tolerances are tests/test_torch_pp_train.py's (the loss within rtol
2e-5, every gradient within rtol 2e-4 / atol 2e-6); a file of its own so
that each file's JAX programs and spawns stay short.
"""

import pytest

from tests.test_torch_config import init_params
from tests.test_torch_pp_train import (CFG, _check_grads, _grads_case, _jax_grads, _micro,
                                       _spawn)

AXES, SIZES = ("data", "pipe", "model"), (2, 2, 2)


@pytest.fixture(scope="module")
def params():
    return init_params(0, CFG, llm2vae_zero=False)


def test_data_pipe_model_loss_and_grads(params):
    """("data", "pipe", "model") (2, 2, 2): the loss and every gradient of
    every rank against the JAX mesh program's."""
    micro = {4: _micro(4)}
    want = _jax_grads(params, SIZES, AXES, *micro[4][:2])
    per_rank = _spawn(params, AXES, SIZES, [_grads_case(micro, 4)])
    _check_grads(per_rank, 0, *want, AXES, SIZES)
