"""The port's sequence-parallel x tensor-parallel denoise
(unimedvl_tpu_torch/parallel/sp_denoise.py) on spawned gloo ranks, against the
JAX package's ``generate_latents_tp_sp`` on its 8 virtual CPU devices and
against the port's own single-device ``generate_latents``; the counterpart of
tests/test_sp_denoise.py.

Same tiny config, weights (``bagel.init_params`` with a random velocity head,
through ``from_jax_params``) and numpy inputs on both sides, fp32. Each test
that needs ranks spawns them once, through
``unimedvl_tpu_torch.parallel.mesh.run_on_ranks``, whose time limit kills the
children: a deadlocked collective fails that test and nothing else.

Tolerances: the multi-rank program sums over ranks in another order than one
device, and XLA in another than torch: rtol 2e-4, atol 2e-5 against either
reference (the JAX test's own); the chunked chain only reorders independent
rows: 1e-5 / 1e-6; the owner-rotated text MLP is exact; the two-partial
attention is softmax algebra in fp32: 1e-4 / 1e-5. The SP program's plain
route (``graphs=True``) equals the eager loop bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from unimedvl_tpu import quant as jquant
from unimedvl_tpu.config import BagelConfig, LLMConfig, VAEConfig
from unimedvl_tpu.models import bagel as jbagel
from unimedvl_tpu.models import qwen2_mot as jmot
from unimedvl_tpu.parallel import sp_denoise as jsp
from unimedvl_tpu_torch.models import bagel
from unimedvl_tpu_torch.models.qwen2_mot import KVCache
from unimedvl_tpu_torch.ops import flash_attention as fa
from unimedvl_tpu_torch.parallel import mesh as pmesh
from unimedvl_tpu_torch.parallel import sp_denoise
from unimedvl_tpu_torch.tools import dryrun_sp
from unimedvl_tpu_torch.weights.loader import from_jax_params

from tests.test_torch_config import init_params, port_config

CFG = BagelConfig(
    llm=LLMConfig(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                  num_attention_heads=8, num_key_value_heads=4),
    vit=None, visual_und=False,
    vae=VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4, downsample=2),
    max_latent_size=8,
)
# head dim 128, and 62 latents per seq rank at sp = 2: a local block of 64 rows,
# where the JAX side takes its Pallas kernels (interpret mode)
CFG128 = BagelConfig(
    llm=LLMConfig(vocab_size=128, hidden_size=256, intermediate_size=128, num_hidden_layers=1,
                  num_attention_heads=2, num_key_value_heads=2),
    vit=None, visual_und=False,
    vae=VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4, downsample=2),
    max_latent_size=16,
)
TOL = dict(rtol=2e-4, atol=2e-5)
RANKS_TIMEOUT_S = 300.0

CFG_ON = dict(num_timesteps=4, timestep_shift=3.0, cfg_text_scale=2.0, cfg_img_scale=1.5,
              cfg_interval=(0.3, 1.0), cfg_renorm_min=0.1, use_text_cfg=True, use_img_cfg=True)
CFG_ALL = dict(num_timesteps=3, timestep_shift=3.0, cfg_text_scale=2.0, cfg_img_scale=1.5,
               cfg_interval=(0.0, 1.0), cfg_renorm_type="global", use_text_cfg=True,
               use_img_cfg=True)


def _inputs(cfg, S, n, cap, seed, lens=None):
    """numpy (k, v, lens, positions, pos_ids, noise, start_end)."""
    llm = cfg.llm
    rng = np.random.default_rng(seed)
    shape = (llm.num_hidden_layers, S, llm.num_key_value_heads, cap, llm.head_dim)
    return (
        rng.standard_normal(shape).astype(np.float32),
        rng.standard_normal(shape).astype(np.float32),
        np.asarray(lens, np.int32) if lens is not None
        else rng.integers(1, cap // 2, (S,)).astype(np.int32),
        rng.integers(1, 5, (S,)).astype(np.int64),
        (np.arange(n) % cfg.max_latent_size**2).astype(np.int64),
        rng.standard_normal((n, cfg.patch_latent_dim)).astype(np.float32),
        np.asarray([3, 4], np.int64),
    )


def _torch_inputs(arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _jax_inputs(arrays):
    k, v, lens, positions, pos_ids, noise, se = arrays
    cache = jmot.KVCache(k=jnp.asarray(k), v=jnp.asarray(v), lens=jnp.asarray(lens))
    return (cache, jnp.asarray(positions, jnp.int32), jnp.asarray(pos_ids), jnp.asarray(noise),
            jnp.asarray(se, jnp.int32))


def _jax_mesh(*sizes, names=("model", "seq")):
    n = int(np.prod(sizes))
    return JaxMesh(np.asarray(jax.devices()[:n]).reshape(sizes), names)


def _jax_sp(params, cfg, arrays, mesh, **kw):
    return np.asarray(jsp.generate_latents_tp_sp(params, cfg, *_jax_inputs(arrays), mesh=mesh,
                                                 **kw))


def _single(model, arrays, **kw):
    k, v, lens, *rest = _torch_inputs(arrays)
    return bagel.generate_latents(model, KVCache(k=k, v=v, lens=lens), *rest, **kw).numpy()


def _port(tree, cfg=CFG):
    return from_jax_params(jax.tree.map(np.asarray, tree), port_config(cfg), device="cpu")


def _same_on_every_rank(per_rank, i):
    first = per_rank[0][i]
    for r in per_rank[1:]:
        np.testing.assert_array_equal(r[i], first)
    return first


@pytest.fixture(scope="module")
def trees():
    """The JAX trees: unquantized, int8, and the three fused ``_tp2`` ones."""
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    base = init_params(0, CFG, llm2vae_zero=False)
    q = jquant.quantize_llm_params(base["llm"])
    qa = jquant.quantize_llm_params(base["llm"], act_quant=True)

    def with_llm(llm):
        return {**base, "llm": llm}

    return {
        "base": base, "q": with_llm(q), "qa": with_llm(qa),
        "bf16_tp2": with_llm(jquant.fuse_serving_projections(base["llm"], tp=2)),
        "q_tp2": with_llm(jquant.fuse_serving_projections(q, tp=2)),
        "qa_tp2": with_llm(jquant.fuse_serving_projections(qa, tp=2)),
    }


@pytest.fixture(scope="module")
def models(trees):
    return {name: _port(tree) for name, tree in trees.items()}


# name -> (model, inputs (S, n, cap, seed), keyword arguments): every call the
# TP2 x SP4 ranks run, in one spawn
TP2_SP4_CALLS = {
    **{f"renorm_{r}": ("base", (3, 16, 32, 1), dict(CFG_ON, cfg_renorm_type=r))
       for r in ("global", "channel", "text_channel")},
    "chunks_1": ("base", (3, 16, 32, 5), dict(CFG_ALL, overlap_chunks=1)),
    "chunks_2": ("base", (3, 16, 32, 5), dict(CFG_ALL, overlap_chunks=2)),
    "dedup_off": ("base", (3, 16, 32, 7), dict(CFG_ALL, dedup_text_mlp=False)),
    "dedup_on": ("base", (3, 16, 32, 7), dict(CFG_ALL, dedup_text_mlp=True)),
    "gather_off": ("base", (3, 16, 32, 23), dict(CFG_ALL, overlap_gather=False)),
    "gather_on": ("base", (3, 16, 32, 23), dict(CFG_ALL, overlap_gather=True)),
    "one_stream": ("base", (1, 16, 32, 3), dict(num_timesteps=3, timestep_shift=3.0)),
    "q": ("q", (1, 16, 32, 9), dict(num_timesteps=3)),
    "qa_tp2": ("qa_tp2", (1, 16, 32, 17), dict(num_timesteps=3)),
    "bf16_tp2": ("bf16_tp2", (3, 16, 32, 11), dict(CFG_ALL)),
    "q_tp2": ("q_tp2", (1, 16, 32, 13), dict(num_timesteps=3)),
    # renorm_global by the SP program's plain route: both cfg-run kinds, every collective
    # inside the step body
    "program": ("base", (3, 16, 32, 1), dict(CFG_ON, cfg_renorm_type="global", graphs=True)),
}


@pytest.fixture(scope="module")
def tp2_sp4(models):
    """name -> the latents of that call, the same on all 8 ranks."""
    names = list(TP2_SP4_CALLS)
    calls = [dict(model=m, inputs=_torch_inputs(_inputs(CFG, *shape)), kw=kw)
             for m, shape, kw in TP2_SP4_CALLS.values()]
    per_rank = pmesh.run_on_ranks(dryrun_sp.run_denoise_calls, 8, ("model", "seq"), (2, 4),
                                  models, calls, timeout_s=RANKS_TIMEOUT_S)
    return {name: _same_on_every_rank(per_rank, i) for i, name in enumerate(names)}


class TestSPDenoise:
    @pytest.mark.parametrize("renorm", ["global", "channel", "text_channel"])
    def test_tp2_sp4_matches_jax_and_single_device(self, trees, models, tp2_sp4, renorm):
        model_name, shape, kw = TP2_SP4_CALLS[f"renorm_{renorm}"]
        arrays = _inputs(CFG, *shape)
        got = tp2_sp4[f"renorm_{renorm}"]
        assert got.shape == (16, CFG.patch_latent_dim) and np.isfinite(got).all()
        np.testing.assert_allclose(
            got, _jax_sp(trees["base"], CFG, arrays, _jax_mesh(2, 4), **kw), **TOL)
        np.testing.assert_allclose(got, _single(models["base"], arrays, **kw), **TOL)
        assert np.abs(got - arrays[5]).max() > 1e-2  # a random velocity head: the state moved

    def test_tp2_sp4_program_equals_eager_and_jax(self, trees, tp2_sp4):
        """``graphs=True`` on the gloo ranks: :class:`SPProgram`'s step body
        on its static buffers (the step index and dt read on the device, the
        CFG scales baked in) gives the eager loop's latents bit for bit, and
        the JAX mesh program's within its tolerance."""
        _, shape, kw = TP2_SP4_CALLS["renorm_global"]
        np.testing.assert_array_equal(tp2_sp4["program"], tp2_sp4["renorm_global"])
        np.testing.assert_allclose(
            tp2_sp4["program"], _jax_sp(trees["base"], CFG, _inputs(CFG, *shape),
                                        _jax_mesh(2, 4), **kw), **TOL)

    def test_overlap_chunks_equivalence(self, tp2_sp4):
        np.testing.assert_allclose(tp2_sp4["chunks_2"], tp2_sp4["chunks_1"], rtol=1e-5,
                                   atol=1e-6)

    def test_dedup_text_mlp_exact(self, tp2_sp4):
        np.testing.assert_array_equal(tp2_sp4["dedup_on"], tp2_sp4["dedup_off"])

    def test_overlap_gather_equivalence(self, trees, tp2_sp4):
        np.testing.assert_allclose(tp2_sp4["gather_on"], tp2_sp4["gather_off"], rtol=1e-4,
                                   atol=1e-5)
        _, shape, kw = TP2_SP4_CALLS["gather_off"]
        want = _jax_sp(trees["base"], CFG, _inputs(CFG, *shape), _jax_mesh(2, 4), **kw)
        np.testing.assert_allclose(tp2_sp4["gather_off"], want, **TOL)

    def test_single_stream_no_cfg(self, trees, models, tp2_sp4):
        _, shape, kw = TP2_SP4_CALLS["one_stream"]
        arrays = _inputs(CFG, *shape)
        np.testing.assert_allclose(
            tp2_sp4["one_stream"], _jax_sp(trees["base"], CFG, arrays, _jax_mesh(2, 4), **kw),
            **TOL)
        np.testing.assert_allclose(tp2_sp4["one_stream"], _single(models["base"], arrays, **kw),
                                   **TOL)

    @pytest.mark.parametrize("name,oracle", [("q", "q"), ("qa_tp2", "qa"),
                                             ("bf16_tp2", "base"), ("q_tp2", "q")])
    def test_quantized_and_fused_trees(self, trees, models, tp2_sp4, name, oracle):
        """int8 (``q``) leaves, and the shard-interleaved fused trees (bf16,
        ``q``, full-int8 ``qa``) on the mesh whose "model" axis they were
        fused for: against the JAX program on the same tree, and against the
        port's single-device loop on the same tree (which de-interleaves it)
        and on the unfused tree of the same weights.

        Full-int8 is another function on a mesh than on one device, in both
        packages: a row-parallel projection quantizes its input per rank, over
        that rank's slice of the features, where one device takes the absmax
        over all of them. So ``qa`` agrees with the JAX mesh program within
        the usual tolerance, and with the single-device loop within int8
        steps of the activations (1/127 of a row's largest value each, a few
        of them through two layers and two flow steps): atol 2e-2."""
        _, shape, kw = TP2_SP4_CALLS[name]
        arrays = _inputs(CFG, *shape)
        got = tp2_sp4[name]
        np.testing.assert_allclose(
            got, _jax_sp(trees[name], CFG, arrays, _jax_mesh(2, 4), **kw), **TOL)
        tol = dict(rtol=0, atol=2e-2) if name == "qa_tp2" else TOL
        np.testing.assert_allclose(got, _single(models[name], arrays, **kw), **tol)
        np.testing.assert_allclose(got, _single(models[oracle], arrays, **kw), **tol)
        if name == "qa_tp2":  # on one device the fused tree is the unfused one, exactly as close
            np.testing.assert_allclose(_single(models[name], arrays, **kw),
                                       _single(models[oracle], arrays, **kw), **TOL)

    def test_sp_only_layout(self, trees, models):
        """tp = 1: no narrowing over "model", four seq shards of four tokens."""
        arrays = _inputs(CFG, 3, 16, 32, 5)
        kw = dict(num_timesteps=3, cfg_text_scale=2.0, use_text_cfg=True,
                  cfg_renorm_type="global")
        per_rank = pmesh.run_on_ranks(
            dryrun_sp.run_denoise_calls, 4, ("model", "seq"), (1, 4), models["base"],
            [dict(inputs=_torch_inputs(arrays), kw=kw)], timeout_s=RANKS_TIMEOUT_S)
        got = _same_on_every_rank(per_rank, 0)
        np.testing.assert_allclose(
            got, _jax_sp(trees["base"], CFG, arrays, _jax_mesh(1, 4), **kw), **TOL)
        np.testing.assert_allclose(got, _single(models["base"], arrays, **kw), **TOL)

    def test_one_rank_mesh_needs_no_process_group(self, models):
        """The 1 x 1 mesh, as one card runs it: no torch.distributed at all,
        every attention call through K1c's wrapper (two per layer and step)."""
        assert not torch.distributed.is_initialized()
        mesh = pmesh.make_mesh(("model", "seq"), (1, 1))
        assert mesh.groups == {"model": None, "seq": None} and mesh.rank == 0
        arrays = _inputs(CFG, 3, 16, 32, 29)
        k, v, lens, *rest = _torch_inputs(arrays)
        before = dict(fa.lse_counts)
        got = sp_denoise.generate_latents_tp_sp(
            models["base"], KVCache(k=k, v=v, lens=lens), *rest, mesh, **CFG_ALL)
        steps, layers = CFG_ALL["num_timesteps"] - 1, CFG.llm.num_hidden_layers
        assert fa.lse_counts["plain"] == before["plain"] + 2 * steps * layers
        assert fa.lse_counts["kernel"] == before["kernel"]
        np.testing.assert_allclose(got.numpy(), _single(models["base"], arrays, **CFG_ALL),
                                   **TOL)

    def test_layout_errors(self, models):
        mesh = pmesh.make_mesh(("model", "seq"), (1, 1))
        k, v, lens, *rest = _torch_inputs(_inputs(CFG, 1, 16, 32, 2))
        with pytest.raises(ValueError, match="axes"):
            sp_denoise.generate_latents_tp_sp(
                models["base"], KVCache(k=k, v=v, lens=lens), *rest,
                pmesh.make_mesh(("seq", "model"), (1, 1)))
        quantized = KVCache(k=k.to(torch.int8), v=v.to(torch.int8), lens=lens,
                            k_scale=torch.ones(k.shape[:-1]), v_scale=torch.ones(k.shape[:-1]))
        with pytest.raises(ValueError, match="int8 KV caches"):
            sp_denoise.generate_latents_tp_sp(models["base"], quantized, *rest, mesh)
        with pytest.raises(ValueError, match="tp=2 != mesh model axis 1"):
            sp_denoise.generate_latents_tp_sp(
                models["bf16_tp2"], KVCache(k=k, v=v, lens=lens), *rest, mesh)
        with pytest.raises(RuntimeError, match="init_process_group"):
            pmesh.make_mesh(("model", "seq"), (2, 2))


class TestGroupedDenoise:
    def test_dp2_tp2_sp2_matches_single_device_per_group(self, trees, models):
        """Two independent images, each on its own TP2 x SP2 sub-mesh: every
        group reproduces the single-device denoise of its own inputs, and the
        JAX grouped program's."""
        groups = [_inputs(CFG, 3, 16, 32, 20 + g) for g in range(2)]
        kw = dict(CFG_ON, num_timesteps=3, cfg_renorm_type="global")
        per_rank = pmesh.run_on_ranks(
            dryrun_sp.run_denoise_calls, 8, ("data", "model", "seq"), (2, 2, 2), models["base"],
            [dict(inputs=[_torch_inputs(g) for g in groups], kw=kw, grouped=True)],
            timeout_s=RANKS_TIMEOUT_S)
        got = _same_on_every_rank(per_rank, 0)
        assert got.shape == (2, 16, CFG.patch_latent_dim)
        jg = [_jax_inputs(g) for g in groups]
        want = np.asarray(jsp.generate_latents_dp_tp_sp(
            trees["base"], CFG, [g[0] for g in jg], [g[1] for g in jg], [g[2] for g in jg],
            [g[3] for g in jg], jg[0][4],
            mesh=_jax_mesh(2, 2, 2, names=("data", "model", "seq")), **kw))
        for g in range(2):
            np.testing.assert_allclose(got[g], want[g], **TOL)
            np.testing.assert_allclose(got[g], _single(models["base"], groups[g], **kw), **TOL)


class TestSPDenoiseFlashGeometry:
    @pytest.mark.parametrize("overlap_gather", [True, False])
    def test_head_dim_128_matches_jax_kernels(self, monkeypatch, overlap_gather):
        """Head dim 128 and local blocks of 64 rows on a TP2 x SP2 mesh: the
        JAX side runs its Pallas kernels (K1c twice, or K1b over the concat)
        in interpret mode, the port K1c's and K1b's plain versions. Tolerance
        5e-4: the JAX flash test's own (online softmax in tiles against one
        softmax, through a layer and two flow steps)."""
        params = init_params(2, CFG128, llm2vae_zero=False)
        model = _port(params, CFG128)
        arrays = _inputs(CFG128, 2, 124, 32, 11, lens=[5, 9])
        kw = dict(num_timesteps=3, cfg_text_scale=2.0, use_text_cfg=True,
                  cfg_renorm_type="text_channel", overlap_gather=overlap_gather)
        per_rank = pmesh.run_on_ranks(
            dryrun_sp.run_denoise_calls, 4, ("model", "seq"), (2, 2), model,
            [dict(inputs=_torch_inputs(arrays), kw=kw)], timeout_s=RANKS_TIMEOUT_S)
        got = _same_on_every_rank(per_rank, 0)
        monkeypatch.setattr(jmot, "_FORCE_FLASH", True)
        want = _jax_sp(params, CFG128, arrays, _jax_mesh(2, 2), **kw)
        np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)
        np.testing.assert_allclose(got, _single(model, arrays, **{
            k: v for k, v in kw.items() if k != "overlap_gather"}), **TOL)


class TestInferencer:
    def test_interleave_inference_with_sp_mesh(self):
        """``InterleaveInferencer(sp_mesh=...)`` end to end on
        tests/test_pipeline.py's tiny config: the text-to-image recipe up to
        the final latents on a TP2 x SP2 mesh of ranks, every draw replaying
        the JAX inferencer's, against the JAX inferencer with its ``sp_mesh``
        and against the port's inferencer without one."""
        from tests.test_pipeline import TINY
        from tests.test_torch_pipeline import GEN_KW, FakeTokenizer
        from unimedvl_tpu.data.imaging import ImageTransform
        from unimedvl_tpu.data.tokenizer import add_special_tokens
        from unimedvl_tpu.inference import InterleaveInferencer as JaxInferencer
        from unimedvl_tpu_torch.inference import InterleaveInferencer

        params = init_params(0, TINY, llm2vae_zero=False)
        tok, ids, _ = add_special_tokens(FakeTokenizer())
        transforms = ((32, 8, 8, 1024), (32, 8, 2, 1024))
        jax_inf = JaxInferencer(
            params, TINY, tok, ids, vae_transform=ImageTransform(*transforms[0]),
            vit_transform=ImageTransform(*transforms[1]), seed=0, sp_mesh=_jax_mesh(2, 2))
        jax_inf.decode_image = lambda latent, shape: latent
        _, sub = jax.random.split(jax_inf._rng)  # the recipe's one draw: the initial noise
        noise = np.asarray(jax.random.normal(sub, (16, TINY.patch_latent_dim), jnp.float32))
        want = np.asarray(jax_inf.interleave_inference(["a chest x-ray"], **GEN_KW)[-1])

        model = _port(params, TINY)
        call = dict(inputs=["a chest x-ray"], noises=[noise], kw=GEN_KW)
        per_rank = pmesh.run_on_ranks(
            dryrun_sp.run_interleave_calls, 4, ("model", "seq"), (2, 2), model, transforms,
            [call], timeout_s=RANKS_TIMEOUT_S)
        got = _same_on_every_rank(per_rank, 0)
        assert got.shape == (16, TINY.patch_latent_dim)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

        plain = InterleaveInferencer(
            model, *_byte_tokenizer(), seed=0,
            vae_transform=_port_transform(transforms[0]),
            vit_transform=_port_transform(transforms[1]))
        plain.decode_image = lambda latent, shape: latent
        plain._randn = lambda shape: torch.from_numpy(np.array(noise)).reshape(shape)
        np.testing.assert_allclose(
            got, plain.interleave_inference(["a chest x-ray"], **GEN_KW)[-1].numpy(),
            rtol=1e-4, atol=1e-4)

    def test_kv_quantized_with_sp_mesh_raises(self, models):
        from unimedvl_tpu_torch.inference import InterleaveInferencer

        mesh = pmesh.make_mesh(("model", "seq"), (1, 1))
        with pytest.raises(ValueError, match="kv_quantized=True is not supported with sp_mesh"):
            InterleaveInferencer(models["base"], *_byte_tokenizer(), kv_quantized=True,
                                 sp_mesh=mesh)


def _byte_tokenizer():
    from unimedvl_tpu_torch.data.tokenizer import ByteTokenizer, add_special_tokens

    tok, ids, _ = add_special_tokens(ByteTokenizer())
    return tok, ids


def _port_transform(args):
    from unimedvl_tpu_torch.data import imaging

    return imaging.ImageTransform(*args)
