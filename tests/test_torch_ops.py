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
from unimedvl_tpu.ops.flash_attention import flash_cache_block_attention as j_flash2
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
        """``return_lse`` (K1c) is ported: it returns (out, lse) and raises
        nothing. What still raises is an option the kernels do not take:
        ``kv_preproc`` without ``q_preproc``, and a key block of another
        length than the query block without ``block_len``."""
        z = torch.zeros(1, 4, 2, 8)
        lens = torch.zeros(1, dtype=torch.int32)
        out, lse = fa.flash_block_attention(z, z, z, lens, lens, True, return_lse=True)
        assert out.shape == z.shape and lse.shape == (1, 4, 2) and lse.dtype == torch.float32
        with pytest.raises(ValueError, match="requires q_preproc"):
            fa.flash_cache_block_attention(z, z, z, z, z, lens, False,
                                           kv_preproc=dict(w_und=None, w_gen=None))
        with pytest.raises(ValueError, match="requires block_len"):
            fa.flash_cache_block_attention(z, z, z, z[:, :3], z[:, :3], lens, False)


NEG_INF = float(np.finfo(np.float32).min)


def _t(a):
    return torch.from_numpy(np.array(a))


class TestPartialAttention:
    """``gqa_attention_hm_lse`` and ``combine_attention_partials`` against the
    JAX functions, fp32: rtol 1e-5, atol 1e-6."""

    TOL = dict(rtol=1e-5, atol=1e-6)

    def _case(self):
        rng = np.random.default_rng(11)
        q, k, v = _rand(rng, 3, 5, 6, 8), _rand(rng, 3, 3, 9, 8), _rand(rng, 3, 3, 9, 8)
        visible = np.asarray([9, 0, 4])  # the second stream sees nothing
        mask = np.broadcast_to(np.arange(9)[None, None] < visible[:, None, None], (3, 5, 9))
        return q, k, v, mask

    def test_lse_matches_jax(self):
        q, k, v, mask = self._case()
        out, lse = attention.gqa_attention_hm_lse(*map(_t, (q, k, v, mask)))
        jout, jlse = jatt.gqa_attention_hm_lse(*map(jnp.asarray, (q, k, v, mask)))
        np.testing.assert_allclose(out, np.asarray(jout), **self.TOL)
        np.testing.assert_allclose(lse, np.asarray(jlse), **self.TOL)
        assert lse.shape == (3, 5, 6) and lse.dtype == torch.float32
        assert (lse[1] == NEG_INF).all() and (out[1] == 0).all()  # finite, and a zero output
        assert torch.isfinite(lse).all()

    def test_lse_without_mask_matches_softmax(self):
        q, k, v, _ = self._case()
        out, lse = attention.gqa_attention_hm_lse(*map(_t, (q, k, v)), None)
        _close(out, attention.gqa_attention_hm(*map(_t, (q, k, v)), None))
        jout, jlse = jatt.gqa_attention_hm_lse(*map(jnp.asarray, (q, k, v)), None)
        np.testing.assert_allclose(lse, np.asarray(jlse), **self.TOL)

    def test_combine_matches_jax_and_the_full_attention(self):
        """Two partials over disjoint keys, one of them empty for a stream,
        merge to the attention over all keys."""
        q, k, v, mask = self._case()
        k2, v2 = _rand(np.random.default_rng(12), 3, 3, 7, 8), _rand(
            np.random.default_rng(13), 3, 3, 7, 8)
        parts = [attention.gqa_attention_hm_lse(*map(_t, (q, k, v, mask))),
                 attention.gqa_attention_hm_lse(*map(_t, (q, k2, v2)), None)]
        got = attention.combine_attention_partials(parts)
        jparts = [jatt.gqa_attention_hm_lse(*map(jnp.asarray, (q, k, v, mask))),
                  jatt.gqa_attention_hm_lse(*map(jnp.asarray, (q, k2, v2)), None)]
        np.testing.assert_allclose(
            got, np.asarray(jatt.combine_attention_partials(jparts)), **self.TOL)
        full_mask = np.concatenate([mask, np.ones((3, 5, 7), bool)], axis=2)
        want = attention.gqa_attention_hm(
            _t(q), _t(np.concatenate([k, k2], 2)), _t(np.concatenate([v, v2], 2)), _t(full_mask))
        _close(got, want)

    def test_two_empty_partials_give_zero_not_nan(self):
        q, k, v, _ = self._case()
        none = np.zeros((3, 5, 9), bool)
        part = attention.gqa_attention_hm_lse(*map(_t, (q, k, v, none)))
        got = attention.combine_attention_partials([part, part])
        jpart = jatt.gqa_attention_hm_lse(*map(jnp.asarray, (q, k, v, none)))
        assert torch.isfinite(got).all() and (got == 0).all()
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jatt.combine_attention_partials([jpart, jpart])))


def _preproc(rng, S, T, D, compact, end_row=None):
    """(numpy dict, jax dict, torch dict) of one island's options."""
    pos = rng.integers(0, 500, (S, 1 if compact else T))
    cos, sin = (np.asarray(a) for a in jrope.rope_cos_sin(jnp.asarray(pos), D, 1e6))
    w_und, w_gen = 1 + 0.1 * _rand(rng, D), 1 + 0.1 * _rand(rng, D)
    er = None if end_row is None else np.full(S, end_row, np.int32)
    jd = dict(w_und=jnp.asarray(w_und), w_gen=jnp.asarray(w_gen), cos=jnp.asarray(cos),
              sin=jnp.asarray(sin), end_row=None if er is None else jnp.asarray(er), eps=1e-6)
    td = dict(w_und=_t(w_und), w_gen=_t(w_gen), cos=_t(cos), sin=_t(sin), end_row=end_row,
              eps=1e-6)
    return jd, td


LSE_CASES = [
    # (name, S, T, M, lens, block_start, q_valid_len, causal, D, q_preproc)
    ("cache partial, one stream empty", 3, 66, 128, [40, 0, 17], [40, 0, 17], [0, 0, 0], False,
     128, True),
    ("block partial, M not a tile multiple", 2, 34, 70, [70, 70], [70, 70], [0, 0], False, 128,
     True),
    ("causal block after context, no q island", 2, 20, 64, [30, 11], [30, 11], [14, 20], True,
     24, False),
]


class TestFlashReturnLse:
    @pytest.mark.parametrize("case", LSE_CASES, ids=[c[0] for c in LSE_CASES])
    def test_plain_matches_jax_kernel(self, case):
        """K1c's plain version against the Pallas kernel in interpret mode:
        output atol 2e-5 (online softmax in tiles against one softmax), lse
        atol 1e-4, and the float32-min rows equal."""
        _, S, T, M, lens, bstart, qvl, causal, D, pre = case
        H, Hk = 4, 2
        rng = np.random.default_rng(21)
        q, k, v = _rand(rng, S, T, H, D), _rand(rng, S, Hk, M, D), _rand(rng, S, Hk, M, D)
        jd, td = _preproc(rng, S, T, D, True) if pre else (None, None)
        ints = [np.asarray(a, np.int32) for a in (lens, bstart, qvl)]
        want, want_lse = j_flash(
            *map(jnp.asarray, (q, k, v, ints[0], ints[1])), causal, block_q=32, block_k=32,
            interpret=True, q_valid_len=jnp.asarray(ints[2]), q_preproc=jd, kv_head_major=True,
            return_lse=True)
        before = dict(fa.lse_counts), dict(fa.counts), dict(fa.q_preproc_counts)
        got, got_lse = fa.flash_block_attention(
            *map(_t, (q, k, v, ints[0], ints[1])), causal, q_valid_len=_t(ints[2]),
            kv_head_major=True, q_preproc=td, return_lse=True)
        assert fa.lse_counts["plain"] == before[0]["plain"] + 1
        assert (fa.counts, fa.q_preproc_counts) == before[1:]  # K1c has counters of its own
        want, want_lse = np.asarray(want), np.asarray(want_lse)
        # q_valid_len 0: a partial without block keys, every query row valid
        rows = [T if n == 0 else n for n in qvl]
        for s in range(S):
            np.testing.assert_allclose(got[s, :rows[s]], want[s, :rows[s]], rtol=1e-5, atol=2e-5)
            empty = want_lse[s, :rows[s]] == NEG_INF
            np.testing.assert_array_equal(got_lse[s, :rows[s]].numpy() == NEG_INF, empty)
            np.testing.assert_allclose(got_lse[s, :rows[s]].numpy()[~empty],
                                       want_lse[s, :rows[s]][~empty], rtol=1e-5, atol=1e-4)
        assert torch.isfinite(got_lse).all()
        if lens[1] == 0 and qvl[1] == 0:  # the empty partial: zeros and the finite float32 min
            assert (got_lse[1] == NEG_INF).all() and (got[1] == 0).all()


K6_CASES = [
    # (name, S, T, Tb, M, lens, causal, q island, k island: None|"compact"|"full"|"own",
    #  block_len, cache_head_major)
    ("plain, non-causal", 2, 40, 40, 64, [37, 0], False, False, None, None, False),
    ("causal", 2, 40, 40, 64, [37, 5], True, False, None, None, False),
    ("q island", 2, 40, 40, 96, [50, 3], False, True, None, None, True),
    ("q and k islands, compact tables", 2, 40, 40, 96, [50, 0], False, True, "compact", None, True),
    ("q and k islands, causal, unaligned", 1, 37, 37, 50, [21], True, True, "compact", None, False),
    ("k island with full tables", 2, 24, 24, 64, [9, 30], False, True, "full", None, True),
    ("gathered keys: block_len, own k tables and end row", 1, 18, 66, 64, [20], False, True,
     "own", 66, True),
    ("padded key block: block_len below Tb", 2, 24, 40, 64, [9, 64], False, False, None, 31, True),
]


class TestFlashCacheBlockAttention:
    @pytest.mark.parametrize("case", K6_CASES, ids=[c[0] for c in K6_CASES])
    def test_plain_matches_jax_kernel(self, case):
        """K6's plain version against the Pallas kernel in interpret mode over
        its options (fp32, D = 128 where an island runs): atol 2e-5."""
        _, S, T, Tb, M, lens, causal, q_pre, k_pre, block_len, hm = case
        H, Hk, D = 4, 2, 128 if q_pre else 24
        rng = np.random.default_rng(31)
        q = _rand(rng, S, T, H, D)
        cshape = (S, Hk, M, D) if hm else (S, M, Hk, D)
        kc, vc = _rand(rng, *cshape), _rand(rng, *cshape)
        kb, vb = _rand(rng, S, Tb, Hk, D), _rand(rng, S, Tb, Hk, D)
        jq, tq = _preproc(rng, S, T, D, True) if q_pre else (None, None)
        jk = tk = None
        if k_pre is not None:
            jk, tk = _preproc(rng, S, Tb, D, k_pre != "full", Tb - 1 if k_pre == "own" else None)
            if k_pre == "compact":  # weights only: tables and end row default to q's
                jk = {n: jk[n] for n in ("w_und", "w_gen")}
                tk = {n: tk[n] for n in ("w_und", "w_gen")}
            elif k_pre == "full":  # own tables, q's end row
                del jk["end_row"], tk["end_row"]
        ln = np.asarray(lens, np.int32)
        want = j_flash2(
            *map(jnp.asarray, (q, kc, vc, kb, vb, ln)), causal, block_q=32, block_k=32,
            interpret=True, q_preproc=jq, kv_preproc=jk, block_len=block_len,
            cache_head_major=hm)
        before = dict(fa.cache_block_counts)
        got = fa.flash_cache_block_attention(
            *map(_t, (q, kc, vc, kb, vb, ln)), causal, q_preproc=tq, kv_preproc=tk,
            block_len=block_len, cache_head_major=hm)
        assert fa.cache_block_counts["plain"] == before["plain"] + 1
        assert fa.cache_block_counts["kernel"] == before["kernel"]
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=2e-5)

    def test_equals_the_concatenation(self):
        """K6 over (cache, block) is K1b over their concatenation with the k
        island applied outside."""
        S, T, H, Hk, D, M = 2, 20, 4, 2, 128, 32
        rng = np.random.default_rng(32)
        q, kc, vc = _rand(rng, S, T, H, D), _rand(rng, S, Hk, M, D), _rand(rng, S, Hk, M, D)
        kb, vb = _rand(rng, S, T, Hk, D), _rand(rng, S, T, Hk, D)
        _, tq = _preproc(rng, S, T, D, True)
        _, tk = _preproc(rng, S, T, D, True)
        tk = {n: tk[n] for n in ("w_und", "w_gen")}
        lens = _t(np.asarray([7, 32], np.int32))
        got = fa.flash_cache_block_attention(*map(_t, (q, kc, vc, kb, vb)), lens, False,
                                             q_preproc=tq, kv_preproc=tk, cache_head_major=True)
        kp = fa.preprocess_q(_t(kb), dict(tq, **tk))
        k_cat = torch.cat([_t(kc), kp.transpose(1, 2)], dim=2)
        v_cat = torch.cat([_t(vc), _t(vb).transpose(1, 2)], dim=2)
        want = fa.flash_block_attention(_t(q), k_cat, v_cat, lens, M, False, kv_head_major=True,
                                        q_preproc=tq)
        _close(got, want)

    def test_value_errors(self):
        """The JAX function's three refusals, with its words."""
        z = torch.zeros(1, 4, 2, 8)
        lens = torch.zeros(1, dtype=torch.int32)
        jz, jl = jnp.zeros((1, 4, 2, 8)), jnp.zeros((1,), jnp.int32)
        qp = dict(w_und=torch.ones(8), w_gen=torch.ones(8), cos=torch.ones(1, 1, 8),
                  sin=torch.zeros(1, 1, 8))
        cases = [
            ("k_block length != q length requires block_len",
             dict(k_block=z[:, :3], v_block=z[:, :3]), {}),
            ("non-causal only", dict(k_block=z[:, :3], v_block=z[:, :3]),
             dict(causal=True, block_len=3)),
            ("kv_preproc requires q_preproc", dict(k_block=z, v_block=z), dict(kv_preproc=qp)),
        ]
        for match, blocks, kw in cases:
            causal = kw.pop("causal", False)
            with pytest.raises(ValueError, match=match):
                fa.flash_cache_block_attention(z, z, z, blocks["k_block"], blocks["v_block"],
                                               lens, causal, **kw)
            jkw = {k: ({n: jnp.asarray(t.numpy()) for n, t in v.items()} if k == "kv_preproc"
                       else v) for k, v in kw.items()}
            n = blocks["k_block"].shape[1]
            with pytest.raises(ValueError, match=match):
                j_flash2(jz, jz, jz, jz[:, :n], jz[:, :n], jl, causal, interpret=True, **jkw)


# Cases of the kernels' partition of the sweep (the tiles each CTA visits);
# block regions stay inside M rounded down to the JAX kernel's key block of 32.
TILED_CASES = [
    # (name, S, T, M, lens, block_start, q_valid_len, causal, D, q_preproc, return_lse)
    ("gap of six dead tiles", 2, 130, 600, [40, 100], [450, 450], [130, 130], False, 128, True,
     False),
    ("lens 0 streams: empty partials", 3, 150, 256, [0, 77, 0], [0, 77, 0], [0, 0, 0], False,
     128, True, True),
    ("causal blocks off the tile grid", 2, 200, 330, [37, 0], [100, 5], [200, 180], True, 128,
     False, False),
    ("D 72, padded tail", 2, 160, 160, [160, 61], [160, 160], None, False, 72, False, False),
    ("D 72, causal, lse", 1, 70, 200, [60], [60], [70], True, 72, False, True),
]

TILED_K6_CASES = [
    # (name, S, T, Tb, M, lens, causal, q island, k island: None|"compact"|"own", block_len,
    #  cache_head_major)
    ("cache gap, both islands", 2, 70, 70, 300, [37, 0], False, True, "compact", None, True),
    ("causal block off the grid after a full cache", 1, 100, 100, 130, [129], True, True, None,
     None, False),
    ("gathered keys, own k tables", 2, 40, 150, 64, [20, 64], False, True, "own", 131, True),
]


class TestSweepPartition:
    """The kernels' partition of the sweep in plain torch
    (``flash_block_attention_tiled_ref``, ``flash_cache_block_attention_tiled_ref``:
    only the tiles each CTA visits, an online softmax, the early exit of a CTA
    that sees nothing) against the one-pass plain versions and the Pallas
    kernels in interpret mode, fp32: rtol 1e-5, atol 2e-5 (sums in another
    order), lse atol 1e-4, float32-min rows equal."""

    @pytest.mark.parametrize("args,want", [
        ((1538, 37, 512, 1026, False, 127), 18),  # 512 px denoise: 7 of 25 tiles in the gap
        ((5632, 0, 0, 4902, False, 127), 77),  # image prefill over the 5632-column cache
        ((5120, 4900, 5120, 5120, False, 63), 77),  # ViT: the padded tail is not swept
        ((512, 0, 0, 0, False, 127), 0),  # the text-CFG stream's cache partial: no tile
        ((5632, 4902, 4902, 40, True, 63), 78),  # causal text block after the image
        ((600, 40, 450, 130, True, 127), 4),  # causal: rows 0-127 reach keys < 578
        ((600, 40, 450, 130, True, 63), 3),  # rows 0-63 reach keys < 514
    ])
    def test_sweep_plan(self, args, want):
        plan = fa.sweep_plan(*args)
        assert len(plan) == want
        assert plan == sorted(set(plan)) and all(j % fa.TILE_KEYS == 0 for j in plan)

    @pytest.mark.parametrize("case", TILED_CASES, ids=[c[0] for c in TILED_CASES])
    def test_tiled_ref_matches_plain_and_jax_kernel(self, case):
        _, S, T, M, lens, bstart, qvl, causal, D, pre, ret_lse = case
        H, Hk = 4, 2
        rng = np.random.default_rng(41)
        q, k, v = _rand(rng, S, T, H, D), _rand(rng, S, Hk, M, D), _rand(rng, S, Hk, M, D)
        jd, td = _preproc(rng, S, T, D, True) if pre else (None, None)
        ints = [np.asarray(a, np.int32) for a in (lens, bstart)]
        qv = None if qvl is None else np.asarray(qvl, np.int32)
        kw = dict(q_valid_len=None if qv is None else _t(qv), kv_head_major=True, q_preproc=td,
                  return_lse=ret_lse)
        before = dict(fa.counts), dict(fa.q_preproc_counts), dict(fa.lse_counts)
        got = fa.flash_block_attention_tiled_ref(*map(_t, (q, k, v, *ints)), causal, **kw)
        assert (dict(fa.counts), dict(fa.q_preproc_counts), dict(fa.lse_counts)) == before
        plain = fa.flash_block_attention_ref(*map(_t, (q, k, v, *ints)), causal, **kw)
        jax_out = j_flash(*map(jnp.asarray, (q, k, v, *ints)), causal, block_q=32, block_k=32,
                          interpret=True, q_valid_len=None if qv is None else jnp.asarray(qv),
                          q_preproc=jd, kv_head_major=True, return_lse=ret_lse)
        got_out, got_lse = got if ret_lse else (got, None)
        pairs = [plain, jax_out] if ret_lse else [(plain, None), (jax_out, None)]
        # q_valid_len 0: a partial without block keys, every query row valid
        rows = [T if qvl is None or qvl[s] == 0 else qvl[s] for s in range(S)]
        for want, want_lse in pairs:
            for s in range(S):
                np.testing.assert_allclose(got_out[s, :rows[s]], np.asarray(want)[s, :rows[s]],
                                           rtol=1e-5, atol=2e-5)
                if ret_lse:
                    wl = np.asarray(want_lse)[s, :rows[s]]
                    empty = wl == NEG_INF
                    gl = got_lse[s, :rows[s]].numpy()
                    np.testing.assert_array_equal(gl == NEG_INF, empty)
                    np.testing.assert_allclose(gl[~empty], wl[~empty], rtol=1e-5, atol=1e-4)
        for s in range(S):
            if ret_lse and lens[s] == 0 and qvl[s] == 0:  # no tile: zeros, the float32 min
                assert (got_out[s] == 0).all() and (got_lse[s] == NEG_INF).all()

    @pytest.mark.parametrize("case", TILED_K6_CASES, ids=[c[0] for c in TILED_K6_CASES])
    def test_cache_block_tiled_ref_matches_plain_and_jax_kernel(self, case):
        _, S, T, Tb, M, lens, causal, q_pre, k_pre, block_len, hm = case
        H, Hk, D = 4, 2, 128
        rng = np.random.default_rng(42)
        q = _rand(rng, S, T, H, D)
        cshape = (S, Hk, M, D) if hm else (S, M, Hk, D)
        kc, vc = _rand(rng, *cshape), _rand(rng, *cshape)
        kb, vb = _rand(rng, S, Tb, Hk, D), _rand(rng, S, Tb, Hk, D)
        jq, tq = _preproc(rng, S, T, D, True) if q_pre else (None, None)
        jk = tk = None
        if k_pre is not None:
            jk, tk = _preproc(rng, S, Tb, D, True, Tb - 1 if k_pre == "own" else None)
            if k_pre == "compact":  # weights only: tables and end row default to q's
                jk = {n: jk[n] for n in ("w_und", "w_gen")}
                tk = {n: tk[n] for n in ("w_und", "w_gen")}
        ln = np.asarray(lens, np.int32)
        kw = dict(q_preproc=tq, kv_preproc=tk, block_len=block_len, cache_head_major=hm)
        before = dict(fa.cache_block_counts)
        got = fa.flash_cache_block_attention_tiled_ref(*map(_t, (q, kc, vc, kb, vb, ln)), causal,
                                                       **kw)
        assert fa.cache_block_counts == before
        _close(got, fa.flash_cache_block_attention_ref(*map(_t, (q, kc, vc, kb, vb, ln)), causal,
                                                       **kw), atol=2e-5)
        want = j_flash2(*map(jnp.asarray, (q, kc, vc, kb, vb, ln)), causal, block_q=32,
                        block_k=32, interpret=True, q_preproc=jq, kv_preproc=jk,
                        block_len=block_len, cache_head_major=hm)
        _close(got, want, atol=2e-5)

    @pytest.mark.parametrize("D", [72, 128])
    def test_skipped_and_unreachable_keys_are_never_read(self, D):
        """NaN in every key row that no query row of a CTA reaches (the gap,
        the tail, the cache of a stream whose cache partial is empty) and in
        the q of a stream that sees nothing: the partition skips the dead
        tiles, zero-fills unreachable rows of the tiles it sweeps, and never
        reads that q, so the output equals the plain version's on clean data."""
        S, T, H, Hk, M = 3, 70, 4, 2, 400
        rng = np.random.default_rng(43)
        q, k, v = _rand(rng, S, T, H, D), _rand(rng, S, Hk, M, D), _rand(rng, S, Hk, M, D)
        lens, bstart, qvl = [37, 0, 0], [300, 300, 0], [70, 70, 0]
        args = (_t(np.asarray(lens, np.int32)), _t(np.asarray(bstart, np.int32)), False)
        kw = dict(q_valid_len=_t(np.asarray(qvl, np.int32)), kv_head_major=True, return_lse=True)
        want, want_lse = fa.flash_block_attention_ref(_t(q), _t(k), _t(v), *args, **kw)
        j = np.arange(M)
        for s in range(S):
            dead = ~((j < lens[s]) | ((j >= bstart[s]) & (j < bstart[s] + qvl[s])))
            k[s][:, dead], v[s][:, dead] = np.nan, np.nan
        q[2] = np.nan
        got, got_lse = fa.flash_block_attention_tiled_ref(_t(q), _t(k), _t(v), *args, **kw)
        assert torch.isfinite(got).all() and torch.isfinite(got_lse).all()
        _close(got, want, atol=2e-5)
        _close(got_lse, want_lse, atol=1e-4)
        assert (got[2] == 0).all() and (got_lse[2] == NEG_INF).all()


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

    # (plan, lens, base, col): plans of 1, 2 and 7 splits and the planner's own
    # (11 splits of one tile); the band past a gap [lens, base) of several
    # whole splits, splits past max(lens, col + 1), lens not a split multiple
    SPLIT_CASES = [
        ((1, 704), (7, 45, 100), (650,) * 3, (660,) * 3),
        ((2, 384), (7, 45, 400), (650,) * 3, (660,) * 3),
        ((7, 128), (7, 300, 130), (650,) * 3, (660,) * 3),
        (None, (0, 45, 699), (64, 650, 699), (127, 660, 699)),
    ]

    @pytest.mark.parametrize("case", SPLIT_CASES, ids=["1", "2", "7", "planner"])
    def test_split_ref_matches_plain_and_jax_kernel(self, case):
        """The kernel's partition and combine (``decode_attention_split_ref``)
        against the one-pass plain version and the Pallas kernel in interpret
        mode, fp32, atol 1e-5 (sums in another order)."""
        plan, lens, base, col = case
        S, H, Hk, D, M = 3, 8, 2, 16, 700
        rng = np.random.default_rng(11)
        q, k, v = _rand(rng, S, 1, H, D), _rand(rng, S, Hk, M, D), _rand(rng, S, Hk, M, D)
        lens, base, col = (np.asarray(a, np.int32) for a in (lens, base, col))
        t = [torch.from_numpy(a) for a in (q, k, v, lens, base, col)]
        got = dec.decode_attention_split_ref(*t[:4], (t[4], t[5]), plan=plan)
        if plan is None:
            assert dec.plan_splits(S, Hk, M) == (11, 64)
        _close(got, dec.decode_attention_ref(*t[:4], (t[4], t[5])))
        want = j_decode(*map(jnp.asarray, (q, k, v, lens)), (jnp.asarray(base), jnp.asarray(col)),
                        interpret=True)
        _close(got, want)

    @pytest.mark.parametrize("plan", [(1, 192), (3, 64), None])
    def test_split_ref_stream_that_sees_nothing_gives_zero(self, plan):
        """lens 0 and an empty band: every split weighs 0 and the stream gives
        0, as the Pallas kernel gives where its sweep is empty (band (0, -1));
        an inverted band (10, 5) gives 0 too. The other stream is unaffected."""
        S, H, Hk, D, M = 3, 4, 2, 8, 150
        rng = np.random.default_rng(12)
        q, k, v = _rand(rng, S, 1, H, D), _rand(rng, S, Hk, M, D), _rand(rng, S, Hk, M, D)
        lens, base, col = (np.asarray(a, np.int32) for a in ((90, 0, 0), (95, 0, 10), (99, -1, 5)))
        t = [torch.from_numpy(a) for a in (q, k, v, lens, base, col)]
        got = dec.decode_attention_split_ref(*t[:4], (t[4], t[5]), plan=plan)
        assert (got[1:] == 0).all()
        _close(got[:1], dec.decode_attention_ref(t[0][:1], t[1][:1], t[2][:1], t[3][:1],
                                                 (t[4][:1], t[5][:1])))
        want = np.asarray(j_decode(*map(jnp.asarray, (q[:2], k[:2], v[:2], lens[:2])),
                                   (jnp.asarray(base[:2]), jnp.asarray(col[:2])), interpret=True))
        _close(got[:2], want)

    @pytest.mark.parametrize("shape,want", [
        ((1, 4, 5632), (44, 128)),  # chat decode at the 980 px request's cache
        ((3, 4, 5632), (22, 256)),
        ((48, 4, 1024), (2, 512)),  # batched decode
        ((1, 4, 257), (5, 64)),
        ((1, 4, 40), (1, 64)),  # below one tile: the kernel writes the output itself
    ])
    def test_plan_splits_at_the_paths_shapes(self, shape, want):
        S, Hk, M = shape
        n_split, split_len = dec.plan_splits(S, Hk, M)
        assert (n_split, split_len) == want
        assert split_len % dec.SPLIT_TILE == 0
        assert (n_split - 1) * split_len < M <= n_split * split_len  # no split wholly past M
        assert n_split == 1 or n_split * S * Hk <= 2 * dec.TARGET_CTAS

    def test_index_reads_a_scalar_band_in_place(self):
        """A 0-dim int32 tensor on the device is passed to the kernel as it is,
        flagged as one value for every stream; anything else becomes int32 [S]."""
        dev = torch.device("cpu")
        base = torch.tensor(9, dtype=torch.int32)
        assert dec._index(base, 3, dev) == (base, 1)
        t, bcast = dec._index(torch.tensor(9), 3, dev)  # int64: converted and expanded
        assert bcast == 0 and t.dtype == torch.int32 and t.tolist() == [9, 9, 9]
        lens = torch.tensor([1, 2, 3], dtype=torch.int32)
        assert dec._index(lens, 3, dev) == (lens, 0)
        t, bcast = dec._index(4, 3, dev)
        assert bcast == 0 and t.tolist() == [4, 4, 4]

    def test_plan_splits_reads_no_tensor(self):
        """The planner takes shapes as Python ints only: a tensor (which could
        be a device tensor, whose read would synchronise the host) raises."""
        for bad in (torch.tensor(5632), torch.tensor([1]), 5632.0, True, np.int64(5632)):
            with pytest.raises(TypeError, match="positive Python ints"):
                dec.plan_splits(1, 4, bad)
        with pytest.raises(TypeError):
            dec.plan_splits(0, 4, 64)

    def test_int8_scales_raise(self):
        """Scales and an int8 cache come together: a float cache with scales,
        or an int8 cache without, raises (the int8 cache itself is served:
        tests/test_torch_quant.py)."""
        z = torch.zeros(1, 1, 2, 8)
        kv = torch.zeros(1, 2, 4, 8)
        lens = torch.zeros(1, dtype=torch.int32)
        with pytest.raises(ValueError, match="come together"):
            dec.decode_attention(z, kv, kv, lens, (0, 0), k_scale=torch.ones(1, 2, 4))
        with pytest.raises(ValueError, match="float cache takes none"):
            dec.decode_attention(z, kv, kv, lens, (0, 0), k_scale=torch.ones(1, 2, 4),
                                 v_scale=torch.ones(1, 2, 4))
        with pytest.raises(ValueError, match="int8 cache needs"):
            dec.decode_attention(z, kv.to(torch.int8), kv.to(torch.int8), lens, (0, 0))


class TestWrappers:
    def test_per_stream_values(self):
        dev = torch.device("cpu")
        assert _launch.per_stream(7, 3, dev).tolist() == [7, 7, 7]
        assert _launch.per_stream(torch.tensor(5, dtype=torch.int64), 2, dev).tolist() == [5, 5]
        t = _launch.per_stream(torch.tensor([1, 2]), 2, dev)
        assert t.dtype == torch.int32 and t.is_contiguous() and t.tolist() == [1, 2]
        assert _launch.per_stream(t, 2, dev) is t  # already int32 [S] on the device
        with pytest.raises(ValueError, match=r"\[3\]"):
            _launch.per_stream(torch.tensor([1, 2]), 3, dev)

    def test_tensor_checks_name_the_tensor(self):
        """The checks the kernels' raw pointers rest on run before any launch,
        so they can be held on CPU tensors: each raises with the name."""
        cpu = torch.device("cpu")
        with pytest.raises(ValueError, match="k must be on"):
            _launch.check_cuda(("k",), (torch.zeros(4, 16, dtype=torch.int8),), torch.int8)
        with pytest.raises(ValueError, match="x_scale must be torch.float32"):
            _launch.check_contiguous_cuda("x_scale", torch.zeros(3, dtype=torch.float64),
                                          torch.float32, (3,), cpu)
        with pytest.raises(ValueError, match=r"wp must be torch.int8 \(8, 16\)"):
            _launch.check_contiguous_cuda("wp", torch.zeros(8, 8, dtype=torch.int8),
                                          torch.int8, (8, 16), cpu)
        with pytest.raises(ValueError, match="w_scale must be contiguous"):
            _launch.check_contiguous_cuda("w_scale", torch.zeros(4, 8)[:, ::2],
                                          torch.float32, (4, 4), cpu)
        ok = torch.zeros(4, 16)
        _launch.check_contiguous_cuda("ok", ok, torch.float32, (4, 16), cpu)

    @pytest.mark.parametrize("dtype,per_load", [(torch.bfloat16, 8), (torch.int8, 16)])
    def test_kv_strides_are_in_16_byte_loads(self, dtype, per_load):
        """Strides come back in elements and must be whole 16-byte loads: 8
        elements of bf16, 16 of int8."""
        t = torch.zeros(2, 3, 5, 2 * per_load, dtype=dtype)
        assert _launch.kv_strides("k", t) == (t.stride(0), t.stride(1), t.stride(2))
        odd = torch.zeros(2, 3, 5, per_load + per_load // 2, dtype=dtype)
        with pytest.raises(ValueError, match=f"k strides .* multiples of {per_load} elements"):
            _launch.kv_strides("k", odd)

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
