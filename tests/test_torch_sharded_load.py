"""The sharded loader of the port (the counterpart of
tests/test_sharded_load.py): ``load_bagel_checkpoint(mesh=...)`` reads each
rank's ranges of a synthetic released-format checkpoint (written by the
port's exporter, fp32, in several shards) and gives the model
``from_jax_params(mesh=...)`` and ``place_params`` give on that rank, bit for
bit; quantized at load (full-int8) the model that quantizing the whole one
and placing it gives (the row-parallel shards take the whole row's scales);
the TP-sharded bytes of the ranks add up to the whole model's; every rank
answers as one device does. The JAX package's sharded load of the same files
gives the same tree. One spawn of a (1, 2) mesh runs every case.
"""

import jax
import numpy as np
import pytest
import torch

from unimedvl_tpu.parallel import create_mesh
from unimedvl_tpu.weights import bagel_loader as jloader
from unimedvl_tpu_torch.parallel import mesh as pmesh
from unimedvl_tpu_torch.tools import dryrun_mesh
from unimedvl_tpu_torch.weights import bagel_export
from unimedvl_tpu_torch.weights.loader import from_jax_params

from tests.test_pipeline import TINY
from tests.test_torch_config import init_params, port_config

RANKS_TIMEOUT_S = 240.0


def _image():
    return np.random.default_rng(0).integers(0, 255, (24, 28, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(np.asarray, init_params(0, TINY, llm2vae_zero=False))


@pytest.fixture(scope="module")
def model(tree):
    return from_jax_params(tree, port_config(TINY), device="cpu")


@pytest.fixture(scope="module")
def ckpt(model, tmp_path_factory):
    out = tmp_path_factory.mktemp("ckpt")
    bagel_export.export_bagel_checkpoint(str(out), model, dtype=torch.float32, shard_gb=2e-4)
    return str(out)


@pytest.fixture(scope="module")
def ranks(model, tree, ckpt):
    base = dict(kind="load", ckpt=ckpt, cfg=port_config(TINY), images=[_image()],
                prompt="what is this?")
    cases = [dict(base, tree=tree),
             dict(base, quant=dict(quantize_bits=8, act_quant=True))]
    return pmesh.run_on_ranks(dryrun_mesh.run_mesh_cases, 2, ("data", "model"), (1, 2), model,
                              cases, timeout_s=RANKS_TIMEOUT_S)


class TestShardedLoad:
    def test_equals_from_jax_params_and_place_params(self, ranks):
        for r in ranks:
            assert r[0]["same"] == [True, True]

    def test_quantized_at_load(self, ranks):
        """Full-int8 at load: each rank's integers and scales are those of
        the whole model quantized, then placed."""
        for r in ranks:
            assert r[1]["same"] == [True]

    def test_halves_add_up(self, ranks, model):
        whole = dryrun_mesh.shard_bytes(model)
        b = [r[0]["bytes"] for r in ranks]
        assert b[0]["sharded"] + b[1]["sharded"] == whole["sharded"]
        assert b[0]["whole"] == b[1]["whole"] == whole["whole"]

    def test_answers_as_one_device(self, ranks, model):
        want = dryrun_mesh.run_case(model, None, dict(kind="chat", images=[_image()],
                                                      prompt="what is this?", max_length=6))
        assert [r[i]["chat"] for r in ranks for i in (0,)] == [want, want]

    def test_jax_sharded_load_reads_the_same_files(self, tree, ckpt):
        got = jloader.load_bagel_checkpoint(ckpt, TINY, dtype=np.float32,
                                            mesh=create_mesh((1, 2), devices=jax.devices()[:2]))
        flat_w, flat_g = jax.tree.leaves(tree), jax.tree.leaves(jax.tree.map(np.asarray, got))
        assert len(flat_w) == len(flat_g)
        for a, b in zip(flat_w, flat_g):
            np.testing.assert_array_equal(a, b)
