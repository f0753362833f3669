"""The generation path of the PyTorch port against the JAX package, on the CPU.

The tiny config of tests/test_pipeline.py (its VAE is tests/test_vae.py's
SMALL) with a random velocity head (``llm2vae_zero=False``). The JAX tree from
``bagel.init_params`` goes into the port through ``from_jax_params``; the same
numpy inputs and noise go through both. Everything runs in fp32.

Tolerances, each with its reason:
- ops and single forwards: atol/rtol 1e-5 (sums taken in another order);
- K1b's plain version against the Pallas kernel in interpret mode: 2e-5
  (fp32 online softmax against the masked softmax);
- model-level outputs (a few layers, a few flow steps): 1e-4;
- decoded uint8 images: within 1 per pixel (the uint8 cast truncates, so a
  value an ulp either side of an integer flips).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unimedvl_tpu.config import BagelConfig
from unimedvl_tpu.models import bagel as jbagel
from unimedvl_tpu.models import qwen2_mot as jmot
from unimedvl_tpu.models import vae as jvae
from unimedvl_tpu.ops import norms as jnorms
from unimedvl_tpu.ops import rope as jrope
from unimedvl_tpu.ops import sincos as jsincos
from unimedvl_tpu.ops.flash_attention import flash_block_attention as j_flash
from unimedvl_tpu.weights.vae_loader import convert_vae_state_dict
from unimedvl_tpu_torch.models import bagel
from unimedvl_tpu_torch.models.qwen2_mot import KVCache
from unimedvl_tpu_torch.models.vae import AutoEncoder
from unimedvl_tpu_torch.ops import flash_attention as fa
from unimedvl_tpu_torch.ops import norms, rope, sincos
from unimedvl_tpu_torch.weights import loader

from tests.test_pipeline import TINY as CFG
from tests.test_torch_config import init_params, port_config
from tests.test_torch_model import released_ckpt  # noqa: F401 (fixture)
from tests.test_vae import SMALL

TCFG = port_config(CFG)  # the port's own config object, from the JAX one's fields
OP_TOL = dict(rtol=1e-5, atol=1e-5)
KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def pair():
    params = init_params(2, CFG, llm2vae_zero=False)
    model = loader.from_jax_params(jax.tree.map(np.asarray, params), TCFG, device="cpu")
    return params, model


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _t(a):
    return torch.from_numpy(np.array(a))


class TestGenOps:
    def test_group_norm(self):
        rng = np.random.default_rng(0)
        x, w, b = _rand(rng, 2, 64, 5, 6), _rand(rng, 64), _rand(rng, 64)
        got = norms.group_norm(_t(x), _t(w), _t(b), 32, 1e-6)
        want = jnorms.group_norm(jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(w),
                                 jnp.asarray(b), 32, 1e-6)
        _close(got, np.asarray(want).transpose(0, 3, 1, 2), OP_TOL)

    @pytest.mark.parametrize("rows", [7, 1])
    def test_apply_rope_one(self, rows):
        """Full tables, and one row shared by the whole block."""
        rng = np.random.default_rng(1)
        pos = rng.integers(0, 3000, (2, rows))
        x = _rand(rng, 2, 7, 3, 16)
        cos, sin = rope.rope_cos_sin(_t(pos), 16, 1e6)
        jcos, jsin = jrope.rope_cos_sin(jnp.asarray(pos), 16, 1e6)
        _close(rope.apply_rope_one(_t(x), cos, sin),
               jrope.apply_rope_one(jnp.asarray(x), jcos, jsin), OP_TOL)

    @pytest.mark.parametrize("dim", [256, 33])
    def test_timestep_embedding(self, dim):
        t = np.asarray([0.0, 0.25, 0.993, 1.0], np.float32)
        _close(sincos.timestep_embedding(_t(t), dim),
               jsincos.timestep_embedding(jnp.asarray(t), dim), OP_TOL)

    def test_time_embed(self, pair):
        params, model = pair
        t = np.asarray([0.0, 0.5, 0.9866], np.float32)
        _close(bagel.time_embed(model, _t(t)),
               jbagel.time_embed(params["time_embedder"], jnp.asarray(t)), OP_TOL)


# (name, S, T, M, lens, block_start, q_valid_len, end_row, compact, causal)
K1B_CASES = [
    ("full tables, static end row", 2, 64, 128, [37, 0], [37, 0], None, None, False, True),
    ("compact tables, dynamic end row", 1, 96, 192, [50], [50], [70], 69, True, False),
    ("S=3 denoise, lens (L, 0, L)", 3, 66, 192, [40, 0, 40], [126, 126, 126], None, None,
     True, False),
]


class TestQPreprocPlain:
    @pytest.mark.parametrize("case", K1B_CASES, ids=[c[0] for c in K1B_CASES])
    def test_plain_matches_jax_kernel(self, case):
        """K1b's plain version against the JAX kernel with q_preproc
        (interpret mode), D = 128, on the valid query rows."""
        _, S, T, M, lens, bstart, qvl, end_row, compact, causal = case
        H, Hk, D = 4, 2, 128
        rng = np.random.default_rng(3)
        q, k, v = _rand(rng, S, T, H, D), _rand(rng, S, Hk, M, D), _rand(rng, S, Hk, M, D)
        w_und, w_gen = 1 + 0.1 * _rand(rng, D), 1 + 0.1 * _rand(rng, D)
        pos = rng.integers(0, 500, (S, 1 if compact else T))
        cos, sin = (np.asarray(a) for a in jrope.rope_cos_sin(jnp.asarray(pos), D, 1e6))
        lens_a, bs_a = np.asarray(lens, np.int32), np.asarray(bstart, np.int32)
        qv = None if qvl is None else np.asarray(qvl, np.int32)
        er = None if end_row is None else np.full(S, end_row, np.int32)
        want = j_flash(
            *map(jnp.asarray, (q, k, v, lens_a, bs_a)), causal, block_q=32, block_k=64,
            interpret=True, q_valid_len=None if qv is None else jnp.asarray(qv),
            kv_head_major=True,
            q_preproc=dict(w_und=jnp.asarray(w_und), w_gen=jnp.asarray(w_gen),
                           cos=jnp.asarray(cos), sin=jnp.asarray(sin),
                           end_row=None if er is None else jnp.asarray(er), eps=1e-6),
        )
        before = dict(fa.q_preproc_counts), dict(fa.counts)
        got = fa.flash_block_attention(
            *map(_t, (q, k, v, lens_a, bs_a)), causal,
            q_valid_len=None if qv is None else _t(qv), kv_head_major=True,
            q_preproc=dict(w_und=_t(w_und), w_gen=_t(w_gen), cos=_t(cos), sin=_t(sin),
                           end_row=end_row, eps=1e-6),
        )
        assert fa.q_preproc_counts["plain"] == before[0]["plain"] + 1
        assert fa.q_preproc_counts["kernel"] == before[0]["kernel"]
        assert fa.counts == before[1]  # K1a's counters untouched
        valid = np.full(S, T) if qv is None else qv
        for s in range(S):
            _close(got[s, : valid[s]], np.asarray(want)[s, : valid[s]], KERNEL_TOL)

    def test_preprocess_q_routes_text_rows(self):
        """Rows 0 and end_row take w_und, the others w_gen."""
        S, T, H, D = 2, 6, 1, 4
        q = torch.ones(S, T, H, D)
        zeros = torch.zeros(S, 1, D)
        qp = dict(w_und=torch.full((D,), 2.0), w_gen=torch.full((D,), 3.0),
                  cos=torch.ones(S, 1, D), sin=zeros, end_row=torch.tensor([3, 5]))
        got = fa.preprocess_q(q, qp)[..., 0, 0]
        want = torch.full((S, T), 3.0)
        want[:, 0] = 2.0
        want[0, 3] = want[1, 5] = 2.0
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _random_caches(rng, S, M, lens):
    L, Hk, D = CFG.llm.num_hidden_layers, CFG.llm.num_key_value_heads, CFG.llm.head_dim
    k, v = _rand(rng, L, S, Hk, M, D), _rand(rng, L, S, Hk, M, D)
    lens = np.asarray(lens, np.int32)
    jc = jmot.KVCache(k=jnp.asarray(k), v=jnp.asarray(v), lens=jnp.asarray(lens))
    tc = KVCache(k=_t(k), v=_t(v), lens=_t(lens))
    return jc, tc


class TestGenForward:
    @pytest.mark.parametrize("update_cache", [True, False])
    @pytest.mark.parametrize("S", [1, 3])
    def test_forward_matches_jax(self, pair, S, update_cache):
        """A gen block [start, latents..., end] with one rope position per
        stream; with a cache update the block is trailing-padded and its end
        row dynamic, without one it attends to cache plus block."""
        params, model = pair
        rng = np.random.default_rng(4 + S)
        T, M, C = 12, 40, CFG.llm.hidden_size
        lens = [9, 0, 17][:S]
        jc, tc = _random_caches(rng, S, M, lens)
        x = _rand(rng, S, T, C)
        pos = np.repeat(rng.integers(0, 50, (S, 1)), T, axis=1)
        n_valid = 9 if update_cache else T
        valid = np.broadcast_to(np.arange(T) < n_valid, (S, T))
        end_row = n_valid - 1 if update_cache else None
        want_h, want_c = jmot.forward(
            params["llm"], CFG.llm, jnp.asarray(x), jnp.asarray(pos), jc,
            jmot.ForwardSpec("gen", False, update_cache, rope_const=True),
            q_valid=jnp.asarray(valid) if update_cache else None,
            gen_end_row=None if end_row is None else jnp.asarray(end_row, jnp.int32),
        )
        k_before = tc.k.clone()
        got_h, got_c = model.language_model.model(
            _t(x), _t(pos[:, :1]), tc, causal=False,
            q_valid=_t(valid) if update_cache else None, mode="gen",
            gen_end_row=end_row, update_cache=update_cache,
        )
        _close(got_h[:, :n_valid], np.asarray(want_h)[:, :n_valid], MODEL_TOL)
        np.testing.assert_array_equal(got_c.lens.numpy(), np.asarray(want_c.lens))
        if update_cache:
            for s, ln in enumerate(lens):
                end = ln + n_valid
                _close(got_c.k[:, s, :, :end], np.asarray(want_c.k)[:, s, :, :end], MODEL_TOL)
                _close(got_c.v[:, s, :, :end], np.asarray(want_c.v)[:, s, :, :end], MODEL_TOL)
        else:
            assert torch.equal(got_c.k, k_before)

    def test_prefill_vae_exact_shape(self, pair):
        params, model = pair
        rng = np.random.default_rng(6)
        n, rope_pos = 9, 3
        jc, tc = _random_caches(rng, 1, 32, [4])
        tokens = _rand(rng, 1, n, CFG.patch_latent_dim)
        pos_ids = rng.permutation(CFG.max_latent_size**2)[:n][None]
        se = np.asarray([260, 261], np.int32)
        want = jbagel.prefill_vae(
            params, CFG, jc, jnp.asarray(tokens), jnp.asarray(pos_ids), jnp.asarray(se),
            jnp.asarray([rope_pos], jnp.int32), jnp.asarray(0.0, jnp.float32),
        )
        got = bagel.prefill_vae(model, tc, _t(tokens), _t(pos_ids), _t(se.astype(np.int64)),
                                rope_pos)
        np.testing.assert_array_equal(got.lens.numpy(), np.asarray(want.lens))
        _close(got.k[:, :, :, : 4 + n + 2], np.asarray(want.k)[:, :, :, : 4 + n + 2], MODEL_TOL)

    def test_prefill_vae_bucketed_cache_columns(self, pair):
        params, model = pair
        rng = np.random.default_rng(7)
        Nb, n, rope_pos = 16, 11, 5
        jc, tc = _random_caches(rng, 1, 64, [6])
        tokens = _rand(rng, 1, Nb, CFG.patch_latent_dim)
        pos_ids = np.zeros((1, Nb), np.int64)
        pos_ids[0, :n] = rng.permutation(CFG.max_latent_size**2)[:n]
        se = np.asarray([260, 261], np.int32)
        want = jbagel.prefill_vae_bucketed(
            params, CFG, jc, jnp.asarray(tokens), jnp.asarray(pos_ids),
            jnp.asarray(n, jnp.int32), jnp.asarray(se), jnp.asarray([rope_pos], jnp.int32),
            jnp.asarray(0.0, jnp.float32),
        )
        got = bagel.prefill_vae_bucketed(
            model, tc, _t(tokens), _t(pos_ids), n, _t(se.astype(np.int64)), rope_pos
        )
        np.testing.assert_array_equal(got.lens.numpy(), np.asarray(want.lens))
        end = 6 + n + 2
        _close(got.k[:, :, :, :end], np.asarray(want.k)[:, :, :, :end], MODEL_TOL)
        _close(got.v[:, :, :, :end], np.asarray(want.v)[:, :, :, :end], MODEL_TOL)


RENORMS = ["global", "channel", "text_channel"]


class TestFlow:
    @pytest.mark.parametrize("use_img_cfg", [True, False])
    @pytest.mark.parametrize("renorm", RENORMS)
    def test_cfg_combine(self, renorm, use_img_cfg):
        rng = np.random.default_rng(8)
        v, vt, vi = (_rand(rng, 20, 16) for _ in range(3))
        args = (3.0, 1.5, 0.3, renorm, True, use_img_cfg)
        want = jbagel._cfg_combine(*map(jnp.asarray, (v, vt, vi)), *args)
        _close(bagel._cfg_combine(_t(v), _t(vt), _t(vi), *args), want, OP_TOL)

    def test_flow_timesteps(self):
        for a, b in zip(bagel.flow_timesteps(50, 3.0), jbagel.flow_timesteps(50, 3.0)):
            np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("cfg_on", [True, False])
    def test_generate_latents(self, pair, cfg_on):
        """Injected noise; with CFG the three streams are main, cfg_text
        (an empty context) and cfg_img, and the interval leaves the last
        steps on one stream."""
        params, model = pair
        rng = np.random.default_rng(9)
        S = 3 if cfg_on else 1
        jc, tc = _random_caches(rng, S, 48, [20, 0, 13][:S])
        n = 16
        noise = _rand(rng, n, CFG.patch_latent_dim)
        pos_ids = rng.permutation(CFG.max_latent_size**2)[:n]
        positions = np.asarray([20, 0, 13][:S], np.int32)
        se = np.asarray([260, 261], np.int32)
        kw = dict(num_timesteps=6, timestep_shift=3.0, cfg_text_scale=3.0, cfg_img_scale=1.5,
                  cfg_interval=(0.4, 1.0), cfg_renorm_type="global",
                  use_text_cfg=cfg_on, use_img_cfg=cfg_on)
        want = jbagel.generate_latents(
            params, CFG, jc, jnp.asarray(positions), jnp.asarray(pos_ids), jnp.asarray(noise),
            jnp.asarray(se), **kw,
        )
        args = (model, tc, _t(positions), _t(pos_ids), _t(noise), _t(se.astype(np.int64)))
        got = bagel.generate_latents(*args, **kw)
        _close(got, want, MODEL_TOL)
        assert not np.allclose(np.asarray(want), noise, atol=1e-3)  # the loop moved
        half = bagel.generate_latents(*args, **kw, step_range=(0, 2))
        args = (*args[:4], half, args[5])
        torch.testing.assert_close(bagel.generate_latents(*args, **kw, step_range=(2, 5)), got,
                                   rtol=0, atol=0)


class TestVAE:
    def test_tiny_vae_is_test_vae_small(self):
        assert CFG.vae == SMALL

    def test_encode_moments_and_decode(self, pair):
        params, model = pair
        rng = np.random.default_rng(10)
        x = _rand(rng, 2, 3, 32, 32)
        mean, logvar = model.vae_model.encode_moments(_t(x))
        jmean, jlogvar = jvae.encode_moments(params["vae"], SMALL, jnp.asarray(x.transpose(0, 2, 3, 1)))
        _close(mean, np.asarray(jmean).transpose(0, 3, 1, 2), MODEL_TOL)
        _close(logvar, np.asarray(jlogvar).transpose(0, 3, 1, 2), MODEL_TOL)
        z = _rand(rng, 2, 4, 8, 8)
        want = jvae.decode(params["vae"], SMALL, jnp.asarray(z.transpose(0, 2, 3, 1)))
        _close(model.vae_model.decode(_t(z)), np.asarray(want).transpose(0, 3, 1, 2),
               MODEL_TOL)

    def test_encode_sample_and_latent_tokens(self, pair):
        """The posterior sample with the same noise, patchified in (p, q, c) order."""
        params, model = pair
        key = jax.random.PRNGKey(3)
        x = _rand(np.random.default_rng(11), 1, 3, 32, 32)
        want = jbagel.encode_vae_latent_tokens(params, CFG, jnp.asarray(x.transpose(0, 2, 3, 1)),
                                               key)
        noise = np.asarray(jax.random.normal(key, (1, 8, 8, 4), jnp.float32)).transpose(0, 3, 1, 2)
        got = bagel.encode_vae_latent_tokens(model, _t(x), _t(noise))
        _close(got, want, MODEL_TOL)

    def test_decode_latent_to_image(self, pair):
        params, model = pair
        tokens = _rand(np.random.default_rng(12), 16, CFG.patch_latent_dim)
        want = np.asarray(jbagel.decode_latent_to_image(params, CFG, jnp.asarray(tokens), 4, 4))
        got = bagel.decode_latent_to_image(model, _t(tokens), 4, 4).numpy()
        assert got.dtype == np.uint8 and got.shape == want.shape == (32, 32, 3)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1

    def test_decode_latent_to_image_program(self, pair):
        """The decode as a program (``graphs=True``: its plain route over the
        static buffers) equals the eager decode bit for bit and the JAX
        decode as above; two latents of one size share one program (the
        second replays it), another size builds a second."""
        from unimedvl_tpu_torch.inference import programs

        params, model = pair
        programs.drop_all()
        rng = np.random.default_rng(14)
        for h, w in ((4, 4), (4, 4), (2, 6)):
            tokens = _rand(rng, h * w, CFG.patch_latent_dim)
            want = np.asarray(jbagel.decode_latent_to_image(params, CFG, jnp.asarray(tokens), h, w))
            eager = bagel.decode_latent_to_image(model, _t(tokens), h, w, graphs=False)
            got = bagel.decode_latent_to_image(model, _t(tokens), h, w, graphs=True)
            assert got.dtype == torch.uint8 and got.shape == want.shape == (8 * h, 8 * w, 3)
            assert torch.equal(got, eager)
            assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1
        assert sum(isinstance(p, bagel.PrefillProgram) for p in programs.programs()) == 2
        programs.drop_all()

    @pytest.mark.parametrize("prefix", ["", "module."])
    def test_load_ae_matches_jax_converter(self, tmp_path, prefix):
        """A synthetic ae.safetensors under the released names (with and
        without the DDP prefix) read by both loaders decodes alike."""
        from safetensors.numpy import save_file

        rng = np.random.default_rng(13)
        names = AutoEncoder(SMALL, device="meta").state_dict()
        sd = {k: 0.1 * _rand(rng, *v.shape) for k, v in names.items()}
        path = tmp_path / "ae.safetensors"
        save_file({prefix + k: v for k, v in sd.items()}, str(path))
        ae = loader.load_ae(str(path), SMALL, device="cpu")
        for k, v in ae.state_dict().items():
            assert v.dtype == torch.float32
            np.testing.assert_array_equal(v.numpy(), sd[k])
        jparams = convert_vae_state_dict({prefix + k: v for k, v in sd.items()}, SMALL,
                                         jnp.float32)
        z = _rand(rng, 1, 4, 8, 8)
        want = jvae.decode(jparams, SMALL, jnp.asarray(z.transpose(0, 2, 3, 1)))
        _close(ae.decode(_t(z)), np.asarray(want).transpose(0, 3, 1, 2), MODEL_TOL)

    def test_checkpoint_dir_reads_ae(self, released_ckpt, tmp_path):  # noqa: F811
        """A released checkpoint directory with an ae.safetensors: the port's
        loader and the JAX loader (through from_jax_params) give the same
        weights, the VAE's among them."""
        import shutil

        from safetensors.numpy import save_file

        from unimedvl_tpu.weights import bagel_loader as jloader

        ckpt = tmp_path / "ckpt"
        shutil.copytree(released_ckpt, ckpt)
        rng = np.random.default_rng(14)
        vae_cfg = dataclasses.replace(SMALL, z_channels=16)  # the checkpoint's 64-wide latents
        names = AutoEncoder(vae_cfg, device="meta").state_dict()
        save_file({k: 0.1 * _rand(rng, *v.shape) for k, v in names.items()},
                  str(ckpt / "ae.safetensors"))
        cfg = BagelConfig.from_checkpoint_dir(
            str(ckpt), vae=vae_cfg, max_latent_size=4, vit_max_num_patch_per_side=4
        )
        jparams = jloader.load_bagel_checkpoint(str(ckpt), cfg, dtype=jnp.float32)
        want = loader.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      port_config(cfg), device="cpu").state_dict()
        got = loader.load_bagel_checkpoint(str(ckpt), port_config(cfg), device="cpu",
                                           dtype=torch.float32).state_dict()
        assert got.keys() == want.keys()
        assert len([k for k in got if k.startswith("vae_model.")]) == len(names)
        for key in want:
            torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)

    def test_vae_stays_fp32_beside_bf16_weights(self, pair):
        params, _ = pair
        sd = loader.jax_tree_to_state_dict(jax.tree.map(np.asarray, params), TCFG)
        vae_keys = [k for k in sd if k.startswith("vae_model.")]
        assert len(vae_keys) == len(AutoEncoder(SMALL, device="meta").state_dict())
        model = loader.from_jax_params(jax.tree.map(np.asarray, params), TCFG,
                                       dtype=torch.bfloat16, device="cpu")
        assert model.vae_model.decoder.conv_out.weight.dtype == torch.float32
        assert model.llm2vae.weight.dtype == torch.bfloat16


def test_init_random_fills_the_vae_and_velocity_head():
    cfg = BagelConfig(llm=CFG.llm, vit=CFG.vit, vae=CFG.vae, latent_patch_size=2,
                      max_latent_size=8, vit_max_num_patch_per_side=16)
    for zero in (True, False):
        model = bagel.Bagel(port_config(cfg), device="meta", dtype=torch.bfloat16, with_vae=True)
        model = model.to_empty(device="cpu")
        bagel.init_random_(model, torch.Generator().manual_seed(0), llm2vae_zero=zero)
        assert bool((model.llm2vae.weight == 0).all()) == zero
        conv = model.vae_model.encoder.conv_in.weight
        assert conv.dtype == torch.float32 and conv.abs().max() <= 1 / np.sqrt(27)
        assert bool((model.vae_model.encoder.norm_out.weight == 1).all())
