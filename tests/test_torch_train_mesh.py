"""``make_train_step(mesh=, fsdp=)`` of the port on spawned gloo ranks against
the JAX package's mesh train step (the counterpart of the mesh cases of
tests/test_training.py and tests/test_checkpoint_resume.py), and the
toy-overfit front end on a TP x DP mesh.

TINY (4 heads, 2 kv heads), fp32, ``llm2vae_zero=False``, through
``from_jax_params(..., device="cpu")``. One spawn of a (2, 2) ("data",
"model") mesh runs every case (``tools/dryrun_train.run_train_cases``): the
TP x DP step, which is held to the JAX ``make_train_step`` on a (2, 2) mesh of
4 virtual devices with the same weights and noise (the one JAX program of
this file); FSDP, accumulation, the EMA, ``freeze_und`` and the sharded
snapshot, which are held to the TP x DP step or to the port's one-device
step (itself held to JAX in tests/test_torch_train.py). The tolerances are
the JAX suite's own FSDP-against-TP ones (tests/test_training.py): the loss
within rtol 2e-5, every parameter after the step within rtol 2e-4 / atol 2e-6.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from unimedvl_tpu.parallel import create_mesh
from unimedvl_tpu.training import trainer as jtrainer
from unimedvl_tpu_torch.parallel import mesh as pmesh
from unimedvl_tpu_torch.scripts import toy_overfit
from unimedvl_tpu_torch.tools import dryrun_train
from unimedvl_tpu_torch.training import trainer

from tests.test_torch_config import init_params, port_config
from tests.test_torch_train import (CFG, _replay_batch_noise, _stacked, jax_batch,
                                    jax_state_dict, port_model)

RANKS_TIMEOUT_S = 240.0
LOSS_RTOL = 2e-5
TOL = dict(rtol=2e-4, atol=2e-6)
SHAPE = {"data": 2, "model": 2}
LR = 1e-3
KEY_BIASES = ("k_proj.bias", "k_proj_moe_gen.bias")
FZ = dataclasses.replace(CFG, llm=dataclasses.replace(CFG.llm, freeze_und=True))


@pytest.fixture(scope="module")
def params():
    return init_params(0, CFG, llm2vae_zero=False)


@pytest.fixture(scope="module")
def data():
    """Two batches of B = 2 (the mixed sequence and a text + image one; the
    second reversed), their noises replayed from JAX keys, and their join
    (B = 4)."""
    first = _stacked()
    second = {k: v[::-1].copy() for k, v in first.items()}
    key = jax.random.PRNGKey(3)
    n1 = _np(_replay_batch_noise(key, first))
    n2 = _np(_replay_batch_noise(jax.random.PRNGKey(4), second))
    both = {k: np.concatenate([first[k], second[k]]) for k in first}
    return dict(first=first, second=second, key=key, n1=n1, n2=n2, both=both)


def _np(noises):
    return [None if n is None else n.numpy() for n in noises]


@pytest.fixture(scope="module")
def jax_step(params, data):
    """The JAX mesh program: one step on a (2, 2) mesh of 4 virtual devices."""
    mesh = create_mesh((2, 2), devices=jax.devices()[:4])
    step, init_state = jtrainer.make_train_step(
        CFG, mesh, params, optimizer=jtrainer.make_optimizer(learning_rate=LR))
    with jax.set_mesh(mesh):
        state, loss = step(init_state(), jax_batch(data["first"]), data["key"])
    return float(loss), jax_state_dict(state.params)


@pytest.fixture(scope="module")
def ranks(params, data, tmp_path_factory):
    """One spawn of the (2, 2) mesh running every case."""
    snap = str(tmp_path_factory.mktemp("snapshot"))
    one = dict(batches=[data["first"]], noises=[data["n1"]], lr=LR)
    cases = [
        dict(one),                                            # 0 TP x DP
        dict(one, fsdp=True),                                 # 1 FSDP
        dict(batches=[[data["first"], data["second"]]], noises=[[data["n1"], data["n2"]]],
             accum=2, fsdp=True, lr=LR),                      # 2 FSDP, accumulation of 2
        dict(batches=[data["both"]], noises=[data["n1"] + data["n2"]], lr=LR),  # 3 one batch of 4
        dict(batches=[data["first"]] * 2, noises=[data["n1"]] * 2, ema=0.5, fsdp=True,
             lr=LR),                                          # 4 EMA on the shards
        dict(one, model="fz", fsdp=True),                     # 5 freeze_und
        dict(batches=[data["first"], data["second"]], noises=[data["n1"], data["n2"]],
             ema=0.9, fsdp=True, lr=LR, snapshot=snap),       # 6 sharded snapshot
        dict(one, graphs=True),                               # 7 TP x DP, the program
        dict(batches=[[data["first"], data["second"]]], noises=[[data["n1"], data["n2"]]],
             accum=2, fsdp=True, lr=LR, graphs=True),         # 8 case 2 by the program
    ]
    models = {"base": port_model(params), "fz": port_model(params, FZ)}
    return pmesh.run_on_ranks(dryrun_train.run_train_cases, 4, ("data", "model"), (2, 2),
                              models, cases, timeout_s=RANKS_TIMEOUT_S)


def _one_device(params, cfg, batches, noises, **kw):
    """The port's one-device step over the same calls: (losses, state)."""
    model = port_model(params, cfg)
    step, init_state = trainer.make_train_step(
        port_config(cfg), model, trainer.make_optimizer(learning_rate=kw.pop("lr", LR)), **kw)
    state, losses = init_state(), []
    for b, n in zip(batches, noises):
        if isinstance(n[0], list):
            n = [[None if x is None else torch.from_numpy(x) for x in m] for m in n]
        else:
            n = [None if x is None else torch.from_numpy(x) for x in n]
        state, loss = step(state, b, noises=n)
        losses.append(float(loss))
    return losses, state


def _assert_parts(per_rank, i, want, fsdp, what="params", **tol):
    """Every rank's tensors of case ``i`` equal to its part of ``want`` (the
    whole model's, by name)."""
    llm = port_config(CFG).llm
    checked = 0
    for r in per_rank:
        got = r[i]
        for name, t in got[what].items():
            part = dryrun_train.rank_part(name, want[name], llm, SHAPE, got["coords"], fsdp)
            np.testing.assert_allclose(t, part, err_msg=f"{name} at {got['coords']}", **tol)
            checked += 1
    return checked


def _replicated_equal(per_rank, i, fsdp):
    llm = port_config(CFG).llm
    names = [n for n in per_rank[0][i]["checksums"]
             if dryrun_train.replicated(n, llm, SHAPE, fsdp, pipe=False)]
    assert len(names) > 50
    for r in per_rank[1:]:
        for n in names:
            assert r[i]["checksums"][n] == per_rank[0][i]["checksums"][n], n


class TestMeshTrainStep:
    def test_tp_dp_step_equals_the_jax_mesh_step(self, params, jax_step, ranks):
        """One step on (2, 2): the loss within rtol 2e-5 and every parameter
        within rtol 2e-4 / atol 2e-6 of the JAX mesh program's; the
        vocab-parallel embedding moved; replicated tensors bit-equal."""
        want_loss, want = jax_step
        for r in ranks:
            np.testing.assert_allclose(r[0]["losses"][0], want_loss, rtol=LOSS_RTOL)
        assert _assert_parts(ranks, 0, {**want, **_vae(params)}, False, **TOL) > 4 * 60
        before = port_model(params).state_dict()
        embed = "language_model.model.embed_tokens.weight"
        for r in ranks:
            part = dryrun_train.rank_part(embed, before[embed].numpy(), port_config(CFG).llm,
                                          SHAPE, r[0]["coords"])
            assert not np.array_equal(r[0]["params"][embed], part)
        _replicated_equal(ranks, 0, False)

    def test_steps_leave_the_placed_from_model_alone(self, ranks):
        """``place_params`` gives a rank views of the whole model; the step's
        ``init_state`` copies every parameter first, so no case moved the
        whole model it was placed from (the JAX step's copy before placing)."""
        for r in ranks:
            assert all(case["whole_unchanged"] for case in r)

    def test_fsdp_step_equals_the_tp_step(self, ranks):
        """FSDP over "data" on top of TP: the same loss and parameters as the
        TP x DP step (the JAX suite's FSDP-against-TP tolerances)."""
        for r in ranks:
            np.testing.assert_allclose(r[1]["losses"][0], r[0]["losses"][0], rtol=LOSS_RTOL)
            fsdp = r[1]["params"]
            # the TP step's rank holds the whole "data" extent: take the FSDP slice of it
            fake = pmesh.Mesh(("data", "model"), SHAPE, 0, r[1]["coords"],
                              {"data": None, "model": None})
            for name, t in r[0]["params"].items():
                want = pmesh.take_ranges(torch.from_numpy(t), pmesh.fsdp_range(name, t.shape,
                                                                                fake)).numpy()
                np.testing.assert_allclose(fsdp[name], want, err_msg=name, **TOL)
        _replicated_equal(ranks, 1, True)

    def test_fsdp_shards_params_and_moments_over_both_axes(self, params, ranks):
        """Each large kernel and its two AdamW moments hold 1 / (dp tp) of the
        whole on a rank (the embedding and head: 1 / (dp tp) too)."""
        whole = port_model(params).state_dict()
        names = ["language_model.model.layers.0.mlp.down_proj.weight",
                 "language_model.model.layers.1.self_attn.q_proj_moe_gen.weight",
                 "language_model.model.layers.0.mlp_moe_gen.gate_proj.weight",
                 "language_model.model.embed_tokens.weight", "language_model.lm_head.weight"]
        for r in ranks:
            for n in names:
                shard = r[1]["params"][n]
                assert shard.size * 4 == whole[n].numel(), (n, shard.shape)
                assert r[1]["moments"][n] == (shard.shape, shard.shape), n
            norm = "language_model.model.layers.0.input_layernorm.weight"
            assert r[1]["params"][norm].shape == tuple(whole[norm].shape)

    def test_accumulation_equals_one_batch_of_2b(self, ranks):
        """FSDP with accumulation over 2 batches of B = 2 equals one batch of
        the 4 sequences (the same noises) on the same mesh."""
        for r in ranks:
            np.testing.assert_allclose(r[2]["losses"][0], r[3]["losses"][0], rtol=LOSS_RTOL)
            one = r[3]["params"]
            fake = pmesh.Mesh(("data", "model"), SHAPE, 0, r[2]["coords"],
                              {"data": None, "model": None})
            for name, t in r[2]["params"].items():
                want = pmesh.take_ranges(torch.from_numpy(one[name]),
                                         pmesh.fsdp_range(name, one[name].shape, fake)).numpy()
                np.testing.assert_allclose(t, want, err_msg=name, **TOL)

    def test_ema_on_the_shards(self, ranks):
        """The EMA shadow (decay 0.5, two steps, FSDP) follows its recurrence
        ``ema = 0.5 ema + 0.5 param`` on each rank's shards, and has the
        shard's shape."""
        for r in ranks:
            assert r[4]["ema_recurrence_err"] <= 1e-7
            n = "language_model.model.layers.1.mlp_moe_gen.up_proj.weight"
            assert r[4]["ema"][n].shape == r[4]["params"][n].shape
            assert r[4]["ema"][n].size * 4 == CFG.llm.hidden_size * CFG.llm.intermediate_size
            assert not np.array_equal(r[4]["ema"][n], r[4]["params"][n])

    def test_freeze_und_leaves_the_twins_bit_equal(self, params, data, ranks):
        """``freeze_und`` under FSDP: every frozen understanding twin is bit-equal
        to its part of the initial weights on every rank; the rest follows the
        one-device step."""
        model = port_model(params, FZ)
        labels = trainer._freeze_und_labels(model)
        init = {n: p.detach().numpy() for n, p in model.named_parameters()}
        _, state = _one_device(params, FZ, [data["first"]], [data["n1"]])
        want = {n: p.detach().numpy() for n, p in state.model.named_parameters()}
        llm = port_config(FZ).llm
        frozen = 0
        for r in ranks:
            for name, t in r[5]["params"].items():
                if labels[name] == "freeze":
                    part = dryrun_train.rank_part(name, init[name], llm, SHAPE, r[5]["coords"],
                                                  fsdp=True)
                    assert np.array_equal(t, part), name
                    frozen += 1
        assert frozen > 4 * 20
        _assert_parts(ranks, 5, {**want, **_vae(params)}, True, **TOL)

    def test_sharded_snapshot_resumes_bit_for_bit(self, ranks):
        """A snapshot of each rank's FSDP shard written after step 1, restored
        into a fresh rank model, continues as the uninterrupted step 2 bit
        for bit (parameters, moments, EMA); a restore onto a mesh of another
        shape raises."""
        for r in ranks:
            res = r[6]
            assert res["restored_step"] == 1 and res["step"] == 2
            assert res["resumed_equal"]
            assert res["resumed_loss"] == res["losses"][1]
            assert res["other_mesh"] is not None and "mesh" in res["other_mesh"]


    def test_programs_equal_the_jax_step_and_the_eager_steps(self, params, data, jax_step,
                                                               ranks):
        """The step's program (``graphs=True``: its plain route on the CPU,
        the collectives over gloo) on the (2, 2) mesh: TP x DP against the
        JAX mesh program as the eager step is held; FSDP with accumulation
        against the eager step of case 2 (the loss) and against the
        one-device program on the same batches (every parameter: the eager
        step strips the padding, and over the stripped shapes AdamW's first
        step turns a gradient entry at rounding size into an update anywhere
        in [-lr, lr]; so do the attention key biases, whose gradient is zero
        in exact arithmetic, here as in tests/test_torch_train_graphs.py);
        replicated tensors bit-equal across ranks."""
        want_loss, want = jax_step
        _, one = _one_device(params, CFG, [[data["first"], data["second"]]],
                             [[data["n1"], data["n2"]]], accum_steps=2, graphs=True)
        whole = {n: p.detach().numpy() for n, p in one.model.named_parameters()}
        llm = port_config(CFG).llm
        for r in ranks:
            np.testing.assert_allclose(r[7]["losses"][0], want_loss, rtol=LOSS_RTOL)
            np.testing.assert_allclose(r[8]["losses"][0], r[2]["losses"][0], rtol=LOSS_RTOL)
            for name, t in r[8]["params"].items():
                part = dryrun_train.rank_part(name, whole[name], llm, SHAPE, r[8]["coords"], True)
                tol = dict(rtol=0, atol=LR) if name.endswith(KEY_BIASES) else TOL
                np.testing.assert_allclose(t, part, err_msg=name, **tol)
        assert _assert_parts(ranks, 7, {**want, **_vae(params)}, False, **TOL) > 4 * 60
        _replicated_equal(ranks, 7, False)
        _replicated_equal(ranks, 8, True)


def _vae(params):
    """The VAE's tensors (out of training) by name: placed whole, unchanged."""
    return {n: t.numpy() for n, t in port_model(params).state_dict().items()
            if n.startswith("vae_model.")}


class TestFSDPRules:
    def _mesh(self, dp, tp, rank=0):
        coords = dict(zip(("data", "model"), (int(c) for c in np.unravel_index(rank, (dp, tp)))))
        return pmesh.Mesh(("data", "model"), {"data": dp, "model": tp}, rank, coords,
                          {"data": None, "model": None})

    @pytest.mark.parametrize("name,dim", [
        ("language_model.model.layers.0.self_attn.q_proj.weight", 1),
        ("language_model.model.layers.1.mlp_moe_gen.up_proj.weight", 1),
        ("language_model.model.layers.0.self_attn.o_proj_moe_gen.weight", 0),
        ("language_model.model.layers.1.mlp.down_proj.weight", 0),
        ("language_model.model.embed_tokens.weight", 1),
        ("language_model.lm_head.weight", 1),
        ("language_model.model.layers.0.self_attn.q_proj.bias", None),
        ("language_model.model.layers.0.input_layernorm.weight", None),
        ("language_model.model.layers.0.self_attn.q_norm.weight", None),
        ("vit_model.vision_model.encoder.layers.0.mlp.fc1.weight", None),
    ])
    def test_fsdp_dims_follow_the_jax_specs(self, name, dim):
        """The hidden dim of every large LLM leaf, in torch's [out, in]
        layout: the JAX ``P(None, d, "model")`` / ``P(None, "model", d)`` /
        ``P("model", d)`` / ``P(d, "model")``; nothing else."""
        assert pmesh.fsdp_dim(name) == dim

    def test_a_dim_that_does_not_divide_raises(self):
        with pytest.raises(ValueError, match=r"\(30\) does not split over data=4"):
            pmesh.fsdp_range("language_model.model.layers.0.mlp.gate_proj.weight", (64, 30),
                             self._mesh(4, 1))
        assert pmesh.fsdp_range("language_model.model.layers.0.mlp.gate_proj.weight", (64, 32),
                                self._mesh(4, 1, 3)) == (1, [(24, 8)])

    def test_model_partial_leaves(self):
        """The q / k norms (one [D] weight over a rank's heads) are the only
        replicated leaves whose gradient a "model" rank holds in part."""
        assert pmesh.model_partial("language_model.model.layers.0.self_attn.q_norm.weight")
        assert pmesh.model_partial("language_model.model.layers.1.self_attn.k_norm_moe_gen.weight")
        assert not pmesh.model_partial("language_model.model.layers.0.input_layernorm.weight")
        assert not pmesh.model_partial("language_model.model.norm.weight")

    def test_training_refuses_replicated_kv_heads(self, params):
        """At model = 4 the 2 kv heads would be replicated over pairs of ranks,
        each holding a partial gradient of a shared head: the step refuses."""
        model = pmesh.place_params(port_model(params), self._mesh(1, 4))
        with pytest.raises(ValueError, match="2 kv heads to split"):
            trainer.make_train_step(port_config(CFG), model, mesh=model.language_model.mesh)


def test_toy_overfit_on_a_tp_dp_mesh(tmp_path):
    """``toy_overfit --tp 2 --dp 2 --device cpu`` over four gloo ranks passes
    the JAX script's asserts (the loss falls, CE and MSE fall, both experts'
    gate kernels move) on every rank."""
    out = str(tmp_path / "curve.json")
    codes = pmesh.run_on_ranks(toy_overfit.run_rank, 4, ["--out", out, "--device", "cpu",
                                                          "--steps", "30", "--tp", "2",
                                                          "--dp", "2"],
                               timeout_s=RANKS_TIMEOUT_S)
    assert codes == [0, 0, 0, 0]
    import json

    with open(out) as f:
        got = json.load(f)
    assert got["mesh"] == {"data": 2, "model": 2}
    assert got["loss_last10_mean"] < got["loss_first10_mean"]
    assert got["und_expert_max_delta"] > 0 and got["gen_expert_max_delta"] > 0
