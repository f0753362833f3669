"""``InterleaveInferencer(mesh=...)`` of the port on spawned gloo ranks
against the JAX package's ``mesh=`` programs (the counterpart of
tests/test_pipeline_mesh.py), and the per-rank placement rules of
``parallel/mesh.py`` (of tests/test_sharding.py).

TINY (4 heads, 2 kv heads), fp32, ``llm2vae_zero=False``, through
``from_jax_params(..., device="cpu")``. A (2, 4) mesh replicates the kv heads
over pairs of "model" ranks, as the JAX program's cache spec does there. Each
mesh shape runs once in this file: one spawn of its ranks runs every case
(a module fixture, ``tools/dryrun_mesh.run_mesh_cases``), with its own time
limit. Strings and tokens must be equal; latents within rtol / atol 2e-4,
the JAX test's own; full-int8's quantized down inputs within an int8 step.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from unimedvl_tpu import quant as jquant
from unimedvl_tpu.data.imaging import ImageTransform
from unimedvl_tpu.data.tokenizer import add_special_tokens
from unimedvl_tpu.inference import InterleaveInferencer as JaxInferencer
from unimedvl_tpu.models import qwen2_mot as jmot
from unimedvl_tpu.parallel import create_mesh
from unimedvl_tpu.parallel.mesh import shard_params
from unimedvl_tpu_torch import quant
from unimedvl_tpu_torch.ops import act_quant
from unimedvl_tpu_torch.parallel import mesh as pmesh
from unimedvl_tpu_torch.tools import dryrun_mesh
from unimedvl_tpu_torch.weights.loader import from_jax_params

from tests.test_pipeline import TINY, FakeTokenizer
from tests.test_torch_config import init_params, port_config

RANKS_TIMEOUT_S = 240.0
TOL = dict(rtol=2e-4, atol=2e-4)
PROMPT = "what is this?"
SAMPLE_T = 0.7  # the sampled chat's temperature
GEN_KW = dict(cfg_text_scale=2.0, cfg_img_scale=1.5, cfg_interval=(0.0, 1.0),
              cfg_renorm_type="global", num_timesteps=3)
EDIT_KW = dict(GEN_KW, cfg_img_scale=2.0, cfg_renorm_type="text_channel")
# the int4 trees: per channel, and group 16 (whole groups on both sides at tp 2; the
# row-parallel o (K 32) splits a group at tp 4)
P4 = {"p4": dict(bits=4), "p4a": dict(bits=4, act_quant=True),
      "p4-g16": dict(bits=4, group_size=16)}


def _image():
    rng = np.random.default_rng(0)
    return rng.integers(0, 255, (24, 28, 3), dtype=np.uint8)


def _jax_inf(params, mesh=None, seed=0, **kw):
    tok, ids, _ = add_special_tokens(FakeTokenizer())
    return JaxInferencer(params, TINY, tok, ids, vae_transform=ImageTransform(32, 8, 8, 1024),
                         vit_transform=ImageTransform(32, 8, 2, 1024), seed=seed, mesh=mesh,
                         **kw)


def _jax_latent(inf, image=None, **kw):
    """tests/test_pipeline_mesh.py's latent recipe, with the keys the JAX
    inferencer draws its noise from, in order."""
    keys = []
    real = inf._next_rng

    def next_rng():
        keys.append(real())
        return keys[-1]

    inf._next_rng = next_rng
    gen = inf.init_gen_context()
    cfg_img = gen.fork()
    if image is not None:
        gen = inf.update_context_image(image, gen, vae=True, vit=True)
    cfg_text = gen.fork()
    gen = inf.update_context_text("a tiny image", gen)
    cfg_img = inf.update_context_text("a tiny image", cfg_img)
    out = np.asarray(inf.gen_image_latent((16, 16), gen, cfg_text_precontext=cfg_text,
                                          cfg_img_precontext=cfg_img, **kw), np.float32)
    return out, keys


def _port_noise(model, case, keys):
    """The port's draws of ``case`` (one device) made from the JAX keys, as
    numpy arrays in order (NCHW requests are the NHWC draw transposed): what
    the ranks replay."""
    import jax.numpy as jnp

    drawn, it = [], iter(keys)

    def randn(shape):
        if len(shape) == 4:
            n, c, h, w = shape
            a = np.asarray(jax.random.normal(next(it), (n, h, w, c), jnp.float32))
            a = a.transpose(0, 3, 1, 2)
        else:
            a = np.asarray(jax.random.normal(next(it), shape, jnp.float32))
        drawn.append(np.array(a))
        return torch.from_numpy(np.array(a))

    inf = dryrun_mesh.inferencer(model, None, **case.get("inf_kw", {}))
    inf._randn = randn
    dryrun_mesh.latent_recipe(inf, case)
    return drawn


GROUPED_PROMPTS = ["a tiny image", "another one"]
N_LATENT = (16 // TINY.latent_downsample) ** 2


def _jax_grouped(params):
    """The JAX inferencer's ``gen_image_latents_grouped`` of two images on a
    (2, 2, 2) mesh, and the noise it drew (from its keys, by shape)."""
    import jax.numpy as jnp

    inf = _jax_inf(params, seed=5)
    keys = []
    real = inf._next_rng
    inf._next_rng = lambda: keys.append(real()) or keys[-1]
    ctxs, texts, imgs = [], [], []
    for p in GROUPED_PROMPTS:
        gen = inf.init_gen_context()
        cfg_img, cfg_text = gen.fork(), gen.fork()
        ctxs.append(inf.update_context_text(p, gen))
        imgs.append(inf.update_context_text(p, cfg_img))
        texts.append(cfg_text)
    jmesh = jax.sharding.Mesh(np.asarray(jax.devices()[:8]).reshape(2, 2, 2),
                              ("data", "model", "seq"))
    out = np.asarray(inf.gen_image_latents_grouped(
        (16, 16), ctxs, jmesh, cfg_text_precontexts=texts, cfg_img_precontexts=imgs,
        **GEN_KW), np.float32)
    noises = [np.asarray(jax.random.normal(k, (N_LATENT, TINY.patch_latent_dim), jnp.float32))
              for k in keys]
    return out, noises


def _jax_sampled(params, mesh):
    """The JAX mesh inferencer's sampled chat and the Gumbel draws of its
    decode loop (``jax.random.categorical`` is the argmax of logits / T plus
    them), made from the key it drew, in step order."""
    import jax.numpy as jnp

    inf = _jax_inf(params, mesh)
    keys = []
    real = inf._next_rng
    inf._next_rng = lambda: keys.append(real()) or keys[-1]
    text = inf.chat([Image.fromarray(_image())], PROMPT, max_length=8, do_sample=True,
                    temperature=SAMPLE_T)
    rng, gumbels = keys[-1], []
    for _ in range(4 * 8):  # more than the loop draws: replays past the exit draw too
        rng, sub = jax.random.split(rng)
        gumbels.append(np.asarray(jax.random.gumbel(sub, (1, TINY.llm.vocab_size), jnp.float32)))
    return text, gumbels


def _port(tree):
    return from_jax_params(jax.tree.map(np.asarray, tree), port_config(TINY), device="cpu")


def _quantized(params, kw, fused=False):
    llm = jquant.quantize_llm_params(params["llm"], via_host=True, **kw)
    return {**params, "llm": jquant.fuse_serving_projections(llm) if fused else llm}


@pytest.fixture(scope="module")
def params():
    return init_params(0, TINY, llm2vae_zero=False)


@pytest.fixture(scope="module")
def edit_image():
    """The edit's input as the JAX test feeds it: resized by the VAE
    transform."""
    return np.asarray(ImageTransform(32, 8, 8, 1024).resize_transform(Image.fromarray(_image())))


@pytest.fixture(scope="module")
def jax_side(params, edit_image):
    """Every JAX result the port is held to, computed once."""
    img = Image.fromarray(_image())
    mesh24 = create_mesh((2, 4))
    out = {}
    single = _jax_inf(params)
    out["chat"] = single.chat([img], PROMPT, max_length=8)
    out["chat_mesh"] = _jax_inf(params, mesh24).chat([img], PROMPT, max_length=8)
    out["spec_mesh"] = _jax_inf(params, mesh24, spec_decode=True, spec_k=4).chat(
        [img], PROMPT, max_length=8)
    out["t2i"], out["t2i_keys"] = _jax_latent(
        _jax_inf(params, create_mesh((3, 2), devices=jax.devices()[:6]), seed=11), **GEN_KW)
    out["edit"], out["edit_keys"] = _jax_latent(_jax_inf(params, mesh24, seed=13),
                                                 image=Image.fromarray(edit_image), **EDIT_KW)
    q = _quantized(params, dict(bits=8), fused=True)
    out["q"] = _jax_inf(q, mesh24).chat([img], PROMPT, max_length=8)
    qa = _quantized(params, dict(bits=8, act_quant=True))
    out["qa_mesh"] = _jax_inf(qa, mesh24).chat([img], PROMPT, max_length=8)
    out["qa"] = _jax_inf(qa).chat([img], PROMPT, max_length=8)
    for name, kw in P4.items():
        out[name] = _jax_inf(_quantized(params, kw)).chat([img], PROMPT, max_length=8)
    out["grouped"], out["grouped_noise"] = _jax_grouped(params)
    out["sampled_mesh"], out["sampled_gumbels"] = _jax_sampled(params, mesh24)
    return out


@pytest.fixture(scope="module")
def models(params):
    out = {"base": _port(params), "q": _port(_quantized(params, dict(bits=8), fused=True)),
           "qa": _port(_quantized(params, dict(bits=8, act_quant=True)))}
    for name, kw in P4.items():
        out[name] = _port(_quantized(params, kw))
    return out


def _chat(model, **kw):
    return dict(kind="chat", model=model, images=[_image()], prompt=PROMPT, max_length=8, **kw)


@pytest.fixture(scope="module")
def mesh24(models, jax_side, edit_image):
    """One spawn of the (2, 4) mesh: chat, spec chat, edit, int8 fused,
    full-int8 (with K3's second entry recorded), per-channel int4, and the
    grouped text to image on a (2, 2, 2) mesh of the same ranks; then chat,
    spec chat, edit and the grouped text to image again by the device
    programs' plain route (``graphs=True``), and a sampled chat (the JAX
    draws replayed) by both routes."""
    edit = dict(kind="latent", model="base", image=edit_image, text="a tiny image",
                gen_kw=EDIT_KW, inf_kw=dict(seed=13))
    edit["noises"] = _port_noise(models["base"], edit, jax_side["edit_keys"])
    cases = [
        _chat("base"), _chat("base", inf_kw=dict(spec_decode=True, spec_k=4)), edit,
        _chat("q"), dict(_chat("qa"), record=True), _chat("p4"), _chat("p4a"),
        dict(kind="grouped", model="base", sizes=(2, 2, 2), texts=GROUPED_PROMPTS,
             noises=jax_side["grouped_noise"], gen_kw=GEN_KW),
    ]
    graphed = dict(graphs=True)
    sample = dict(temperature=SAMPLE_T, gumbels=jax_side["sampled_gumbels"])
    cases += [
        _chat("base", inf_kw=graphed), _chat("base", inf_kw=dict(graphed, spec_decode=True,
                                                                 spec_k=4)),
        dict(edit, inf_kw=dict(graphed, seed=13)), dict(cases[7], inf_kw=graphed),
        _chat("base", sample=sample), _chat("base", sample=sample, inf_kw=graphed),
    ]
    return pmesh.run_on_ranks(dryrun_mesh.run_mesh_cases, 8, ("data", "model"), (2, 4), models,
                              cases, timeout_s=RANKS_TIMEOUT_S)


#: the (2, 4) spawn's cases run by the programs' plain route, and their eager twins
PROGRAM_CASES = {"chat": (8, 0), "spec_chat": (9, 1), "edit": (10, 2), "grouped": (11, 7),
                 "sampled_chat": (13, 12)}


@pytest.fixture(scope="module")
def mesh12(models):
    """One spawn of a (1, 2) mesh: the int4 trees at tp 2, group-wise too."""
    cases = [_chat("p4"), _chat("p4a"), _chat("p4-g16")]
    return pmesh.run_on_ranks(dryrun_mesh.run_mesh_cases, 2, ("data", "model"), (1, 2), models,
                              cases, timeout_s=RANKS_TIMEOUT_S)


@pytest.fixture(scope="module")
def mesh32(models, jax_side):
    """One spawn of a (3, 2) mesh: text to image with its 3 CFG streams over
    "data", eagerly and by the flow program's plain route."""
    case = dict(kind="latent", model="base", text="a tiny image", gen_kw=GEN_KW,
                inf_kw=dict(seed=11))
    case["noises"] = _port_noise(models["base"], case, jax_side["t2i_keys"])
    cases = [case, dict(case, inf_kw=dict(seed=11, graphs=True))]
    return pmesh.run_on_ranks(dryrun_mesh.run_mesh_cases, 6, ("data", "model"), (3, 2), models,
                              cases, timeout_s=RANKS_TIMEOUT_S)


def _every_rank(per_rank, i):
    first = per_rank[0][i]
    for r in per_rank[1:]:
        if isinstance(first, np.ndarray):
            np.testing.assert_array_equal(r[i], first)
        else:
            assert r[i] == first
    return first


class TestMeshPipeline:
    def test_chat_tp_mesh(self, jax_side, mesh24):
        """(2, 4): kv heads replicated over pairs of model ranks; the JAX
        mesh program's string, and the single device's."""
        assert jax_side["chat_mesh"] == jax_side["chat"]
        assert _every_rank(mesh24, 0) == jax_side["chat_mesh"]

    def test_spec_chat_tp_mesh(self, jax_side, mesh24):
        assert _every_rank(mesh24, 1) == jax_side["spec_mesh"] == jax_side["chat"]

    def test_t2i_latents_stream_mesh(self, jax_side, mesh32):
        """3 CFG streams over data = 3 x TP 2, the noise replayed from the
        JAX mesh inferencer's draws."""
        got = _every_rank(mesh32, 0)
        np.testing.assert_allclose(got, jax_side["t2i"], **TOL)

    def test_edit_latents_tp_mesh(self, jax_side, mesh24):
        np.testing.assert_allclose(_every_rank(mesh24, 2), jax_side["edit"], **TOL)

    def test_int8_fused_tp_mesh(self, jax_side, mesh24):
        assert _every_rank(mesh24, 3) == jax_side["q"]

    def test_full_int8_global_scales(self, jax_side, mesh24, models):
        """``qa``: the JAX mesh program equals the single-device one (its
        act-quant scale is the whole row's); the port's ranks give the same
        string, and the down input they quantize (K3's second entry, scales
        reduced over "model") is the single device's to an int8 step."""
        assert jax_side["qa_mesh"] == jax_side["qa"]
        texts = [r[4][0] for r in mesh24]
        assert texts == [jax_side["qa"]] * 8
        seen = []
        real = act_quant.silu_mul_quant

        def recording(g, u):
            out = real(g, u)
            seen.append(tuple(t.numpy() for t in out))
            return out

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(act_quant, "silu_mul_quant", recording)
            dryrun_mesh.run_case(models["qa"], None, _chat("qa"))
        q1, s1 = seen[0]
        tp, H = 4, 64 // 4  # model ranks; the MLP intermediate is 64
        for r, per_case in enumerate(mesh24):
            _, (q, s), _ = per_case[4]
            m = r % tp
            np.testing.assert_allclose(s, s1, rtol=1e-6)
            assert np.abs(q.astype(np.int32) - q1[..., m * H:(m + 1) * H]).max() <= 1

    def test_global_scale_check_tells_per_rank_scales_apart(self, mesh24):
        """The check the card's TP-2 program holds its w4a8 run to
        (``dryrun_mesh.GlobalScaleCheck``), on the (2, 4) ranks' full-int8
        chat: every call of K3's second entry gives the q and the scales of
        the one-rank K3 on the same rows gathered over "model", and the
        control, per-rank scales, moves the scales of a large share of the
        rows (three in four expected at tp 4), so the check tells the two
        functions apart."""
        for per_case in mesh24:
            stats = per_case[4][2]
            assert stats["calls"] >= TINY.llm.num_hidden_layers
            assert stats["max_step"] <= 1 and stats["max_scale_rel"] <= 1e-6
            assert stats["per_rank_max_scale_rel"] > 1e-2
            assert stats["per_rank_rows_differ"] > 0.4

    def test_grouped_t2i_dp_tp_sp(self, jax_side, mesh24):
        """``gen_image_latents_grouped`` of two images on a (2, 2, 2)
        ("data", "model", "seq") mesh (the same 8 ranks) against the JAX
        inferencer's, the noise replayed from its keys."""
        got = _every_rank(mesh24, 7)
        want = jax_side["grouped"]
        assert got.shape == want.shape == (2, N_LATENT, TINY.patch_latent_dim)
        np.testing.assert_allclose(got, want, **TOL)

    @pytest.mark.parametrize("name,tp", [("p4", 4), ("p4a", 4), ("p4", 2), ("p4a", 2),
                                         ("p4-g16", 2)])
    def test_packed_int4(self, jax_side, mesh24, mesh12, name, tp):
        per_rank, i = (mesh24, {"p4": 5, "p4a": 6}[name]) if tp == 4 else (
            mesh12, {"p4": 0, "p4a": 1, "p4-g16": 2}[name])
        assert _every_rank(per_rank, i) == jax_side[name]


class TestMeshPrograms:
    """The device programs' plain route on a gloo mesh (``graphs=True`` on
    the CPU: each program's step body on its static buffers, the collectives
    inside it) against the eager route on the same ranks, bit for bit, and
    against the JAX mesh program at the tolerances above."""

    @pytest.mark.parametrize("name", ["chat", "spec_chat", "sampled_chat"])
    def test_chat_programs_tp_mesh(self, jax_side, mesh24, name):
        """Greedy, speculative and sampled chat (the sampled one from the JAX
        loop's Gumbel draws, replayed as the port's exponential draws)."""
        got, eager = (_every_rank(mesh24, i) for i in PROGRAM_CASES[name])
        want = {"chat": "chat_mesh", "spec_chat": "spec_mesh", "sampled_chat": "sampled_mesh"}
        assert got == eager == jax_side[want[name]]

    @pytest.mark.parametrize("name,want", [("edit", "edit"), ("grouped", "grouped")])
    def test_latent_programs_tp_mesh(self, jax_side, mesh24, name, want):
        """The edit's flow program over (2, 4), and the grouped text to image's
        sequence-parallel program over (2, 2, 2)."""
        got, eager = (_every_rank(mesh24, i) for i in PROGRAM_CASES[name])
        np.testing.assert_array_equal(got, eager)
        np.testing.assert_allclose(got, jax_side[want], **TOL)

    def test_flow_program_gathers_streams_over_data(self, jax_side, mesh32):
        """The flow program on (3, 2): each data rank's stream, the
        velocities gathered over "data" inside the step body."""
        got, eager = _every_rank(mesh32, 1), _every_rank(mesh32, 0)
        np.testing.assert_array_equal(got, eager)
        np.testing.assert_allclose(got, jax_side["t2i"], **TOL)


def _fake_mesh(dp, tp, rank):
    """A Mesh object for ``rank`` without process groups: placement needs
    none (its collectives run in the forward)."""
    coords = dict(zip(("data", "model"), (int(c) for c in np.unravel_index(rank, (dp, tp)))))
    return pmesh.Mesh(("data", "model"), {"data": dp, "model": tp}, rank, coords,
                      {"data": None, "model": None})


class TestPlacement:
    def test_group_refusal_beside_jax(self, params, models):
        """Group 16 at tp 4: the row-parallel o (in dim 32) would split a
        group; the port refuses, naming the groups, as the JAX placement
        refuses the same tree."""
        with pytest.raises(ValueError, match="2 groups of 16"):
            pmesh.place_params(models["p4-g16"], _fake_mesh(1, 4, 0))
        with pytest.raises(ValueError, match="divisible"):
            shard_params(_quantized(params, P4["p4-g16"]), TINY, create_mesh((2, 4)))

    def test_kv_head_rule(self):
        assert pmesh.head_split(28, 4, 2, 1) == pmesh.HeadSplit(14, 14, 2, 2)
        assert pmesh.head_split(28, 4, 4, 3) == pmesh.HeadSplit(21, 7, 3, 1)
        assert pmesh.head_split(4, 2, 4, 3) == pmesh.HeadSplit(3, 1, 1, 1)
        with pytest.raises(ValueError, match="3 kv heads"):
            pmesh.head_split(6, 3, 2, 0)

    @pytest.mark.parametrize("name", ["base", "p4a"])
    @pytest.mark.parametrize("tp", [2, 4])
    def test_place_params_bytes(self, models, name, tp):
        """Each rank holds 1 / tp of every TP-sharded leaf: of the k / v rows
        1 / min(tp, Hk) (tp 4 > Hk 2 keeps one head a rank), a row-parallel
        leaf's per-column scale whole; every other tensor is the whole
        model's own (no copy). With one "model" rank nothing is copied."""
        whole = models[name].state_dict()
        for r in range(tp):
            local = pmesh.place_params(models[name], _fake_mesh(1, tp, r)).state_dict()
            assert local.keys() == whole.keys()
            for key, t in whole.items():
                part = local[key]
                module = key.rsplit(".", 1)[0]
                if pmesh.leaf_ranges(key, t.shape, port_config(TINY).llm, tp, r) is None:
                    assert part.data_ptr() == t.data_ptr(), key
                elif module.endswith(("k_proj", "v_proj", "k_proj_moe_gen", "v_proj_moe_gen")):
                    assert part.numel() * min(tp, 2) == t.numel(), key
                else:
                    assert part.numel() * tp == t.numel(), key
            assert sum(t.numel() for k, t in local.items() if k.endswith("o_proj.scale")) \
                == sum(t.numel() for k, t in whole.items() if k.endswith("o_proj.scale"))
        one = pmesh.place_params(models[name], _fake_mesh(1, 1, 0)).state_dict()
        assert all(one[k].data_ptr() == whole[k].data_ptr() for k in whole)

    def test_shard_cache_spec(self):
        cfg = port_config(TINY)
        cache = torch.arange(2 * 4 * 2 * 3 * 8, dtype=torch.float32).reshape(2, 4, 2, 3, 8)
        from unimedvl_tpu_torch.models.qwen2_mot import KVCache

        c = KVCache(k=cache, v=cache, lens=torch.arange(4, dtype=torch.int32))
        got = pmesh.shard_cache(c, cfg, _fake_mesh(2, 4, 7))  # data 1, model 3: kv head 1
        assert torch.equal(got.k, cache[:, 2:4, 1:2]) and torch.equal(got.lens, c.lens[2:4])
        spec = pmesh.kv_cache_spec(cfg, _fake_mesh(2, 4, 7), 3)  # 3 streams: whole
        assert spec == {"streams": (0, 3), "kv_heads": (1, 1)}
