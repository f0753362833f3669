"""Ops of the PyTorch port against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and its
torch counterpart. Plain ops and the plain attention versions agree in fp32
within atol 1e-5 (sums taken in another order); the kernels' plain versions
are held against the JAX Pallas kernels run in interpret mode, on valid query
rows only (padded rows are garbage by contract).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from unimedvl_tpu.ops import activations as jact
from unimedvl_tpu.ops import attention as jatt
from unimedvl_tpu.ops import norms as jnorms
from unimedvl_tpu.ops import rope as jrope
from unimedvl_tpu.ops import sincos as jsincos
from unimedvl_tpu.ops.decode_attention import decode_attention as j_decode
from unimedvl_tpu.ops.flash_attention import flash_block_attention as j_flash
from unimedvl_tpu_torch.ops import _launch, activations, attention, cuda_build, norms, rope, sincos
from unimedvl_tpu_torch.ops import decode_attention as dec
from unimedvl_tpu_torch.ops import flash_attention as fa

ATOL = 1e-5


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5, atol=atol)


class TestPlainOps:
    def test_norms(self):
        rng = np.random.default_rng(0)
        x, w, b = _rand(rng, 3, 5, 24), _rand(rng, 24), _rand(rng, 24)
        _close(norms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
               jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))
        _close(norms.layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)),
               jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))

    @pytest.mark.parametrize("name", sorted(activations.ACT2FN))
    def test_activations(self, name):
        x = _rand(np.random.default_rng(1), 4, 33) * 3
        _close(activations.ACT2FN[name](torch.from_numpy(x)), jact.ACT2FN[name](jnp.asarray(x)))

    def test_rope(self):
        rng = np.random.default_rng(2)
        pos = rng.integers(0, 5000, (2, 7))
        cos, sin = rope.rope_cos_sin(torch.from_numpy(pos), 16, 1e6)
        jcos, jsin = jrope.rope_cos_sin(jnp.asarray(pos), 16, 1e6)
        _close(cos, jcos)
        _close(sin, jsin)
        q, k = _rand(rng, 2, 7, 4, 16), _rand(rng, 2, 7, 2, 16)
        got = rope.apply_rope(torch.from_numpy(q), torch.from_numpy(k), cos, sin)
        want = jrope.apply_rope(jnp.asarray(q), jnp.asarray(k), jcos, jsin)
        for g, w in zip(got, want):
            _close(g, w)

    def test_sincos_table_is_exact(self):
        np.testing.assert_array_equal(
            sincos.get_2d_sincos_pos_embed(32, 6), jsincos.get_2d_sincos_pos_embed(32, 6)
        )

    def test_gqa_attention(self):
        rng = np.random.default_rng(3)
        q, k, v = _rand(rng, 2, 5, 6, 8), _rand(rng, 2, 9, 3, 8), _rand(rng, 2, 9, 3, 8)
        vq = np.arange(5)[None] < np.array([[5], [3]])
        vk = np.arange(9)[None] < np.array([[9], [4]])
        m = attention.padding_mask(torch.from_numpy(vq), torch.from_numpy(vk))
        jm = jatt.padding_mask(jnp.asarray(vq), jnp.asarray(vk))
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
        _close(attention.gqa_attention(*map(torch.from_numpy, (q, k, v)), m),
               jatt.gqa_attention(*map(jnp.asarray, (q, k, v)), jm))
        kh, vh = k.transpose(0, 2, 1, 3).copy(), v.transpose(0, 2, 1, 3).copy()
        _close(attention.gqa_attention_hm(*map(torch.from_numpy, (q, kh, vh)), m),
               jatt.gqa_attention_hm(*map(jnp.asarray, (q, kh, vh)), jm))


# Each case keeps the block region inside M: the JAX kernel pads M up to its
# key block and would count block keys in that padding as visible.
FLASH_CASES = [
    # (name, T, M, lens, block_start, q_valid_len or None, causal, head_major, D)
    ("vit-like padded tail", 32, 32, [32, 13], [32, 32], None, False, False, 24),
    ("image block after context", 20, 64, [0, 5], [0, 5], [17, 20], False, True, 8),
    ("causal text over context", 20, 64, [30, 11], [30, 11], [14, 20], True, True, 24),
    ("causal, not head-major", 12, 40, [3, 0], [3, 0], None, True, False, 12),
]


class TestFlashBlockAttention:
    @pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
    def test_plain_matches_jax_kernel(self, case):
        _, T, M, lens, bstart, qvl, causal, hm, D = case
        S, H, Hk = 2, 4, 2
        rng = np.random.default_rng(4)
        q = _rand(rng, S, T, H, D)
        kv_shape = (S, Hk, M, D) if hm else (S, M, Hk, D)
        k, v = _rand(rng, *kv_shape), _rand(rng, *kv_shape)
        args = [np.asarray(lens, np.int32), np.asarray(bstart, np.int32)]
        qv = None if qvl is None else np.asarray(qvl, np.int32)
        want = j_flash(*map(jnp.asarray, (q, k, v, *args)), causal, block_q=32, block_k=32,
                       interpret=True,
                       q_valid_len=None if qv is None else jnp.asarray(qv),
                       kv_head_major=hm)
        before = dict(fa.counts)
        got = fa.flash_block_attention(
            *map(torch.from_numpy, (q, k, v, *args)), causal,
            q_valid_len=None if qv is None else torch.from_numpy(qv), kv_head_major=hm,
        )
        assert fa.counts["plain"] == before["plain"] + 1
        assert fa.counts["kernel"] == before["kernel"]
        valid = np.full(S, T) if qv is None else qv
        for s in range(S):
            _close(got[s, : valid[s]], np.asarray(want)[s, : valid[s]])

    def test_unported_options_raise(self):
        z = torch.zeros(1, 4, 2, 8)
        lens = torch.zeros(1, dtype=torch.int32)
        with pytest.raises(NotImplementedError, match="K1b"):
            fa.flash_block_attention(z, z, z, lens, lens, True, q_preproc={})
        with pytest.raises(NotImplementedError, match="K1c"):
            fa.flash_block_attention(z, z, z, lens, lens, True, return_lse=True)


class TestDecodeAttention:
    @pytest.mark.parametrize("M", [130, 300])
    def test_plain_matches_jax_kernel(self, M):
        S, H, Hk, D = 3, 8, 2, 16
        rng = np.random.default_rng(5)
        q, k, v = _rand(rng, S, 1, H, D), _rand(rng, S, Hk, M, D), _rand(rng, S, Hk, M, D)
        lens = np.asarray([7, 45, 100], np.int32)
        base = np.asarray([110, 110, 110], np.int32)
        col = np.asarray([115, 115, 115], np.int32)
        want = j_decode(*map(jnp.asarray, (q, k, v, lens)),
                        (jnp.asarray(base), jnp.asarray(col)), interpret=True)
        before = dict(dec.counts)
        got = dec.decode_attention(*map(torch.from_numpy, (q, k, v, lens)),
                                   (torch.from_numpy(base), torch.from_numpy(col)))
        assert dec.counts["plain"] == before["plain"] + 1
        assert dec.counts["kernel"] == before["kernel"]
        _close(got, want)

    def test_scalar_band_is_serving_semantics(self):
        """band (lens, lens) with scalars: keys j <= lens are visible."""
        S, H, Hk, D, M = 2, 4, 2, 8, 40
        rng = np.random.default_rng(6)
        q, k, v = _rand(rng, S, 1, H, D), _rand(rng, S, Hk, M, D), _rand(rng, S, Hk, M, D)
        lens = np.asarray([9, 9], np.int32)
        got = dec.decode_attention(*map(torch.from_numpy, (q, k, v, lens)), (9, 9))
        mask = (np.arange(M) <= 9)[None, None].repeat(S, 0)
        want = jatt.gqa_attention_hm(*map(jnp.asarray, (q, k, v)), jnp.asarray(mask))
        _close(got, want)

    def test_int8_scales_raise(self):
        z = torch.zeros(1, 1, 2, 8)
        kv = torch.zeros(1, 2, 4, 8)
        with pytest.raises(NotImplementedError, match="M8"):
            dec.decode_attention(z, kv, kv, torch.zeros(1, dtype=torch.int32), (0, 0),
                                 k_scale=torch.ones(1, 2, 4))


class TestWrappers:
    def test_per_stream_values(self):
        dev = torch.device("cpu")
        assert _launch.per_stream(7, 3, dev).tolist() == [7, 7, 7]
        assert _launch.per_stream(torch.tensor(5, dtype=torch.int64), 2, dev).tolist() == [5, 5]
        t = _launch.per_stream(torch.tensor([1, 2]), 2, dev)
        assert t.dtype == torch.int32 and t.is_contiguous() and t.tolist() == [1, 2]
        with pytest.raises(ValueError, match=r"\[3\]"):
            _launch.per_stream(torch.tensor([1, 2]), 3, dev)

    def test_other_devices_raise(self):
        """Neither the kernel nor the plain version runs on a third device."""
        q, kv = torch.empty(1, 4, 2, 8, device="meta"), torch.empty(1, 2, 4, 8, device="meta")
        with pytest.raises(ValueError, match="CUDA or CPU"):
            fa.flash_block_attention(q, kv, kv, 0, 0, True, kv_head_major=True)
        with pytest.raises(ValueError, match="CUDA or CPU"):
            dec.decode_attention(q[:, :1], kv, kv, 0, (0, 0))

    def test_build_without_nvcc_raises(self, tmp_path, monkeypatch):
        monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
        monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
        monkeypatch.setenv("PATH", str(tmp_path / "no-bin"))
        with pytest.raises(RuntimeError, match="nvcc not found"):
            cuda_build.build()
        assert not list(tmp_path.iterdir())

    def test_library_name_follows_the_sources(self, tmp_path, monkeypatch):
        for name in ("a.cu", "b.cu"):
            (tmp_path / name).write_text("// " + name)
        monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
        first = cuda_build.library_path()
        assert first == cuda_build.library_path()
        (tmp_path / "b.cu").write_text("// edited")
        assert cuda_build.library_path() != first
