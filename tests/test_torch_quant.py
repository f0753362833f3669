"""The quantized serving modes of the PyTorch port against the JAX package, on
the CPU: quantizers and packers, the plain versions of K3 (silu * mul *
quant), K4 (packed-int4 matmul) and K2-int8 (decode over an int8 cache)
against the Pallas kernels in interpret mode, the loader on quantized and
fused trees, the MLP and the int8 cache, and the loading of a released-format
checkpoint with quantization.

Inputs come from numpy seeds and go through both packages. Integers and
scales must be EQUAL wherever both sides run the same rounded fp32 ops
(quantizers, packers, the loader, K4's int8 branch); each other tolerance is
stated where it is used.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from unimedvl_tpu import quant as jquant
from unimedvl_tpu.config import BagelConfig, LLMConfig, ViTConfig
from unimedvl_tpu.models import bagel as jbagel
from unimedvl_tpu.models import qwen2_mot as jmot
from unimedvl_tpu.ops import act_quant as jaq
from unimedvl_tpu.ops import attention as jatt
from unimedvl_tpu.ops import w4_matmul as jw4
from unimedvl_tpu.ops.activations import ACT2FN as JACT2FN
from unimedvl_tpu.ops.decode_attention import decode_attention as j_decode
from unimedvl_tpu_torch import config as tconfig
from unimedvl_tpu_torch import quant
from unimedvl_tpu_torch.models import bagel, qwen2_mot
from unimedvl_tpu_torch.models.layers import QuantLinear
from unimedvl_tpu_torch.models.qwen2_mot import KVCache
from unimedvl_tpu_torch.ops import act_quant as aq
from unimedvl_tpu_torch.ops import attention
from unimedvl_tpu_torch.ops import decode_attention as dec
from unimedvl_tpu_torch.ops import w4_matmul as w4
from unimedvl_tpu_torch.weights import loader

from tests.test_torch_config import init_params
from tests.test_torch_model import released_ckpt  # noqa: F401  (fixture)

CFG = BagelConfig(
    llm=LLMConfig(
        vocab_size=300, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, rope_theta=10000.0,
    ),
    vit=ViTConfig(
        hidden_size=24, intermediate_size=48, num_hidden_layers=2,
        num_attention_heads=2, image_size=32, patch_size=2, rope=False,
    ),
    vae=None,
    visual_gen=False,
    vit_max_num_patch_per_side=16,
)
TCFG = tconfig.BagelConfig.from_dict(dataclasses.asdict(CFG))

# (name, quantize_llm_params kwargs): every leaf form the JAX package makes
MODES = [
    ("int8", dict(bits=8)),
    ("int8-act", dict(bits=8, act_quant=True)),
    ("w4", dict(bits=4)),
    ("w4a8", dict(bits=4, act_quant=True)),
    ("w4a8-g32", dict(bits=4, act_quant=True, group_size=32)),
]
MODE_IDS = [m[0] for m in MODES]


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


class TestQuantizers:
    @pytest.mark.parametrize("bits,group", [(8, 0), (4, 0), (4, 16)])
    def test_quantize_weight_equals_jax(self, bits, group):
        """The JAX kernel is [in, out], the port's weight [out, in]: the
        integers transpose, packed bytes and all; scales are the same arrays."""
        w = _rand(np.random.default_rng(0), 64, 24) * 0.1  # [in, out]
        w[:, 3] = 0.0  # a zero channel: scale 1e-8 / qmax
        want = jquant.quantize_weight(w, via_host=True, bits=bits, group_size=group)
        q, scale = quant.quantize_weight(torch.from_numpy(w.T.copy()), bits, group)
        key = "kernel_q" if bits == 8 else "kernel_p4"
        _eq(q, np.asarray(want[key]).T)
        _eq(scale, want["scale"])
        assert q.dtype == torch.int8 and scale.dtype == torch.float32

    def test_pack_unpack_equal_jax(self):
        rng = np.random.default_rng(1)
        q = rng.integers(-8, 8, (3, 24, 64)).astype(np.int8)  # [.., out, in]
        wp = w4.pack_int4(torch.from_numpy(q))
        assert wp.shape == (3, 24, 32) and wp.dtype == torch.int8
        _eq(wp, np.swapaxes(jw4.pack_int4(np.swapaxes(q, -1, -2)), -1, -2))
        _eq(w4.unpack_int4(wp), q)
        _eq(w4.unpack_int4(wp), np.swapaxes(np.asarray(
            jw4.unpack_int4(jnp.asarray(np.swapaxes(wp.numpy(), -1, -2)))), -1, -2))

    def test_quantize_activations_equals_jax(self):
        x = _rand(np.random.default_rng(2), 3, 5, 64) * 3
        x[1, 2] = 0.0
        want_q, want_s = jquant.quantize_activations(jnp.asarray(x))
        q, s = quant.quantize_activations(torch.from_numpy(x))
        _eq(q, want_q)
        _eq(s, want_s)

    def test_dequantize_weight_equals_jax(self):
        w = _rand(np.random.default_rng(3), 64, 24) * 0.1
        for bits, group in ((8, 0), (4, 0), (4, 16)):
            jp = jquant.quantize_weight(w, via_host=True, bits=bits, group_size=group)
            q, scale = quant.quantize_weight(torch.from_numpy(w.T.copy()), bits, group)
            p = QuantLinear("q" if bits == 8 else "p4", q, scale)
            _eq(quant.dequantize_weight(p, torch.float32),
                np.asarray(jquant.dequantize_weight(jp, jnp.float32)).T)

    def test_bad_arguments_raise(self):
        w = torch.zeros(8, 16)
        with pytest.raises(ValueError, match="bits"):
            quant.quantize_weight(w, bits=3)
        with pytest.raises(ValueError, match="w4 feature"):
            quant.quantize_weight(w, bits=8, group_size=8)
        with pytest.raises(ValueError, match="multiple of group_size"):
            quant.quantize_weight(w, bits=4, group_size=5)
        with pytest.raises(ValueError, match="even last dim"):
            w4.pack_int4(torch.zeros(4, 3, dtype=torch.int8))


def _linear_pair(rng, mode_kw, cin=64, cout=24, bias=True):
    """One linear leaf, quantized by each package from the same weights."""
    w = _rand(rng, cin, cout) * 0.1
    b = _rand(rng, cout) if bias else None
    kw = dict(mode_kw)
    act = kw.pop("act_quant", False)
    jp = jquant.quantize_weight(w, via_host=True, bits=kw["bits"],
                                group_size=kw.get("group_size", 0))
    if act:
        k = "kernel_p4" if "kernel_p4" in jp else "kernel_q"
        jp = {k + "a": jp.pop(k), **jp}
    lin = torch.nn.Linear(cin, cout, bias=bias)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T.copy()))
        if bias:
            lin.bias.copy_(torch.from_numpy(b))
            jp["bias"] = jnp.asarray(b)
    return jp, quant._quantize_module(lin, kw["bits"], act, kw.get("group_size", 0))


class TestQuantLinear:
    @pytest.mark.parametrize("name,kw", MODES, ids=MODE_IDS)
    def test_forward_matches_jax_linear(self, name, kw):
        """``QuantLinear.forward`` is the dispatch of the JAX ``_linear``.
        Integer-matmul modes: the same integers go through the same rounded
        fp32 multiplies, so outputs agree to the last fp32 sum order of the
        bias-free part: equal. Weight-only modes sum fp32 products in another
        order: rtol 1e-5."""
        jp, mod = _linear_pair(np.random.default_rng(4), kw)
        x = _rand(np.random.default_rng(5), 2, 7, 64)
        want = np.asarray(jmot._linear(jnp.asarray(x), jp))
        got = mod(torch.from_numpy(x)).numpy()
        if mod.act_quant and "group_size" not in kw:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    def test_modes_and_shapes(self):
        w8, w4p = torch.zeros(16, 64, dtype=torch.int8), torch.zeros(16, 32, dtype=torch.int8)
        with pytest.raises(ValueError, match="mode must be"):
            QuantLinear("int8", w8, torch.ones(16))
        with pytest.raises(ValueError, match=r"scales \[out\], got"):
            QuantLinear("qa", w8, torch.ones(2, 16))  # group-wise scales are a w4 feature
        with pytest.raises(ValueError, match="takes int8 weights"):
            QuantLinear("q", w8.float(), torch.ones(16))
        m = QuantLinear("p4a", w4p, torch.ones(2, 16), torch.zeros(16))
        assert (m.in_features, m.out_features) == (64, 16) and m.packed and m.act_quant
        assert set(dict(m.named_buffers())) == {"weight_q", "scale"}
        assert [n for n, _ in m.named_parameters()] == ["bias"]


_F32_BIG = float(np.float32(1e30))


class TestSiluMulQuant:
    """K3's plain version. Against the Pallas kernel in interpret mode:
    scales within 1e-6 relative, q within one step and differing on at most
    1e-3 of the elements (XLA's and torch's sigmoid may differ in the last
    place, which can move a value across a rounding boundary). Against the
    definition written out in fp32 numpy-style torch ops: equal."""

    @pytest.mark.parametrize("shape", [(1, 256), (3, 7, 128), (70, 512)])
    def test_plain_matches_jax_kernel(self, shape):
        rng = np.random.default_rng(6)
        g, u = _rand(rng, *shape) * 2, _rand(rng, *shape)
        g16, u16 = torch.from_numpy(g).bfloat16(), torch.from_numpy(u).bfloat16()
        want_q, want_s = jaq.silu_mul_quant(
            jnp.asarray(g16.float().numpy()).astype(jnp.bfloat16),
            jnp.asarray(u16.float().numpy()).astype(jnp.bfloat16), interpret=True)
        before = dict(aq.counts)
        q, s = aq.silu_mul_quant(g16, u16)
        assert aq.counts == dict(kernel=before["kernel"], plain=before["plain"] + 1)
        assert q.shape == shape and s.shape == (*shape[:-1], 1)
        np.testing.assert_allclose(s.numpy(), np.asarray(want_s), rtol=1e-6, atol=0)
        diff = np.abs(q.numpy().astype(int) - np.asarray(want_q).astype(int))
        assert diff.max() <= 1
        assert (diff > 0).mean() <= 1e-3

    def test_plain_is_its_fp32_definition(self):
        rng = np.random.default_rng(7)
        g = torch.from_numpy(_rand(rng, 5, 128) * 2).bfloat16()
        u = torch.from_numpy(_rand(rng, 5, 128)).bfloat16()
        q, s = aq.silu_mul_quant(g, u)
        g32, u32 = g.float(), u.float()
        x = (g32 * (1.0 / (1.0 + torch.exp(-g32)))) * u32
        scale = torch.clamp_min(x.abs().amax(-1, keepdim=True), 1e-8) / 127.0
        want = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        assert torch.equal(s, scale)
        assert (q.int() - want.int()).abs().max() <= 1  # torch.sigmoid vs 1 / (1 + exp(-g))
        assert (q != want).float().mean() <= 1e-3

    def test_zero_row(self):
        """A row of zeros: scale 1e-8 / 127 (the IEEE quotient; XLA's CPU
        code divides by the constant through a reciprocal, one ulp away, hence
        rtol 1e-6 against it) and q = 0, as the JAX kernel."""
        g = torch.zeros(2, 64, dtype=torch.bfloat16)
        u = torch.ones(2, 64, dtype=torch.bfloat16)
        g[1] = 1.5
        q, s = aq.silu_mul_quant(g, u)
        assert (q[0] == 0).all() and s[0].item() == np.float32(1e-8) / np.float32(127.0)
        want_q, want_s = jaq.silu_mul_quant(jnp.zeros((1, 64), jnp.bfloat16),
                                            jnp.ones((1, 64), jnp.bfloat16), interpret=True)
        _eq(q[:1], want_q)
        np.testing.assert_allclose(s[:1].numpy(), np.asarray(want_s), rtol=1e-6, atol=0)

    @staticmethod
    def _division(x, scale):
        return torch.clamp(torch.round(x / scale), -127, 127)

    def test_fast_quantize_twin_equals_the_division_at_every_tie(self):
        """The kernel's rule (``x * (1 / scale)``, the division redone near a
        half-integer) against the true division at the points where they
        could part: x = (k + 1/2) * scale and one ulp either side, for every
        k with |k + 1/2| < 128, at scales from the 1e-8 floor up."""
        k = torch.arange(-128, 128, dtype=torch.float32) + 0.5
        for absmax in (1e-8, 3.3e-5, 0.7, 1.0, 2.3, 47.11, 1234.5678, 3.0e7):
            scale = torch.tensor(max(absmax, 1e-8), dtype=torch.float32) / 127.0
            tie = k * scale
            xs = torch.cat([tie, torch.nextafter(tie, tie + 1), torch.nextafter(tie, tie - 1),
                            torch.nextafter(torch.nextafter(tie, tie + 1), tie + 1)])
            xs = xs[(xs / scale).abs() < 128]
            got = aq.quantize_fast_twin(xs, scale)
            assert torch.equal(got, self._division(xs, scale)), absmax

    @settings(max_examples=300, deadline=None, derandomize=True)
    @given(st.lists(st.floats(-_F32_BIG, _F32_BIG, width=32, allow_subnormal=True),
                    min_size=1, max_size=64),
           st.floats(0.0, 1.0, width=32))
    def test_fast_quantize_twin_equals_the_division(self, values, shrink):
        """On rows of any fp32 values (tiny, huge, subnormal, zero), with the
        row's own scale and with the 1e-8 floor (shrink scales the row)."""
        x = torch.tensor(values, dtype=torch.float32) * shrink
        scale = torch.clamp_min(x.abs().amax(), 1e-8) / 127.0
        assert torch.equal(aq.quantize_fast_twin(x, scale), self._division(x, scale))

    def test_shape_mismatch_and_other_devices_raise(self):
        with pytest.raises(ValueError, match="one shape"):
            aq.silu_mul_quant(torch.zeros(2, 8), torch.zeros(2, 16))
        m = torch.empty(2, 8, device="meta")
        with pytest.raises(ValueError, match="CUDA or CPU"):
            aq.silu_mul_quant(m, m)


def _int_reference(xq, xs, q, ws):
    """tests/test_w4_matmul.py's integer reference: q [K, N] unpacked int4."""
    want = (xq.astype(np.int32) @ q.astype(np.int32)).astype(np.float32)
    return want * xs * ws[None, :]


class TestW4Matmul:
    """K4's plain version, at K = 1024, N = 512 so that the Pallas kernel
    tiles (interpret mode, ``force_kernel=True``)."""

    K, N = 1024, 512

    def _inputs(self, seed, m, groups=0):
        rng = np.random.default_rng(seed)
        xq = rng.integers(-127, 128, (m, self.K)).astype(np.int8)
        xs = rng.uniform(0.01, 0.1, (m, 1)).astype(np.float32)
        q = rng.integers(-8, 8, (self.K, self.N)).astype(np.int8)  # [K, N]
        shape = (groups, self.N) if groups else (self.N,)
        ws = rng.uniform(0.01, 0.1, shape).astype(np.float32)
        wp_t = w4.pack_int4(torch.from_numpy(q.T.copy()))  # the port's [N, K/2]
        return xq, xs, q, ws, wp_t

    def test_widen_twin_equals_unpack_for_every_byte(self):
        """The bf16-x GEMM widens nibbles through the mantissa of 128.0; its
        twin equals ``unpack_int4`` (and the JAX package's unpacking) for all
        256 byte values, each at all four places of a 32-bit word."""
        b = torch.arange(256)
        wp = ((b[:, None] + torch.arange(4)[None]) % 256).to(torch.uint8).view(torch.int8)
        wp = wp.reshape(256, 4)
        got = w4.widen_nibbles_twin(wp)
        assert got.dtype == torch.bfloat16 and got.shape == (256, 8)
        want = w4.unpack_int4(wp)
        assert torch.equal(got.float(), want.float())
        assert set(got.float().unique().tolist()) == set(range(-8, 8))
        jax_unpacked = np.asarray(jw4.unpack_int4(jnp.asarray(wp.numpy().T))).T
        np.testing.assert_array_equal(got.float().numpy(), jax_unpacked.astype(np.float32))

    @pytest.mark.parametrize("m", [1, 16, 37, 300])
    def test_w4a8_per_channel_is_bit_exact(self, m):
        """int32 sums are exact and both sides apply float(acc) * x_scale *
        w_scale in that order: equal to the JAX kernel and to the integer
        reference, in fp32 and after the bf16 rounding. m = 37 and 300 are no
        multiple of the kernel's row tile."""
        xq, xs, q, ws, wp_t = self._inputs(8, m)
        jwp = jnp.asarray(jw4.pack_int4(q))
        before = dict(w4.counts)
        for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
            want = jw4.w4_matmul(jnp.asarray(xq), jnp.asarray(xs), jwp, jnp.asarray(ws),
                                 out_dtype=jdt, interpret=True, force_kernel=True)
            got = w4.w4_matmul(torch.from_numpy(xq), torch.from_numpy(xs), wp_t,
                               torch.from_numpy(ws), out_dtype=tdt)
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want.astype(jnp.float32)))
        assert w4.counts == dict(kernel=before["kernel"], plain=before["plain"] + 2)
        got = w4.w4_matmul(torch.from_numpy(xq), torch.from_numpy(xs), wp_t,
                           torch.from_numpy(ws), out_dtype=torch.float32)
        np.testing.assert_array_equal(got.numpy(), _int_reference(xq, xs, q, ws))

    @pytest.mark.parametrize("groups", [2, 1])
    def test_w4a8_grouped(self, groups):
        """Group sums are exact integers; each is scaled and added in fp32 in
        group order on both sides. The JAX kernel adds per 512-row k-step
        with a multiply-add that XLA may fuse, so the two differ by an fp32
        rounding of a group's term: rtol 1e-6 plus atol 1e-5 (terms of size
        up to 100 that cancel in the sum), against a per-group reference too."""
        xq, xs, q, ws, wp_t = self._inputs(9, 20, groups)
        want = jw4.w4_matmul(jnp.asarray(xq), jnp.asarray(xs), jnp.asarray(jw4.pack_int4(q)),
                             jnp.asarray(ws), out_dtype=jnp.float32, interpret=True,
                             force_kernel=True)
        got = w4.w4_matmul(torch.from_numpy(xq), torch.from_numpy(xs), wp_t,
                           torch.from_numpy(ws), out_dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)
        g = self.K // groups
        ref = sum(
            (xq[:, i * g:(i + 1) * g].astype(np.int32) @ q[i * g:(i + 1) * g].astype(np.int32)
             ).astype(np.float32) * ws[i] for i in range(groups)) * xs
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-5)

    @pytest.mark.parametrize("m,K,N,groups", [
        (5, 1024, 512, 0), (300, 1024, 512, 0), (37, 1024, 512, 2), (261, 1024, 512, 1),
        (70, 192, 136, 3), (131, 320, 264, 0),
        (37, 512, 512, 16), (70, 192, 136, 6), (131, 320, 264, 10), (70, 192, 136, 2),
    ])
    def test_w4a8_gemm_partition_equals_plain(self, m, K, N, groups):
        """The int8-x GEMM's partition (``w4a8_gemm_tiled_ref``: 128 weight rows
        by 256 x rows, 128 with groups of a multiple of 64 in-rows, 64 with
        groups of 32 or 96; k32 products; group flushes; the epilogue's order
        of multiplies) equals the plain version bit for bit, in fp32 and after
        the bf16 rounding, with m no multiple of 64, K no multiple of the
        128-row stage (192, 320), groups of 64, 32 and 96 and N no multiple of
        the 128-row tile; at K 1024, N 512 also the JAX kernel (interpret
        mode, ``force_kernel=True``): equal per channel, within the grouped
        test's rtol 1e-6, atol 1e-5 with group scales (it may fuse the
        multiply-add)."""
        rng = np.random.default_rng(m + K + groups)
        xq = rng.integers(-127, 128, (m, K)).astype(np.int8)
        xs = rng.uniform(0.01, 0.1, (m, 1)).astype(np.float32)
        q = rng.integers(-8, 8, (K, N)).astype(np.int8)
        ws = rng.uniform(0.01, 0.1, (groups, N) if groups else (N,)).astype(np.float32)
        args = (torch.from_numpy(xq), torch.from_numpy(xs),
                w4.pack_int4(torch.from_numpy(q.T.copy())), torch.from_numpy(ws))
        for dt in (torch.float32, torch.bfloat16):
            before = dict(w4.counts)
            got = w4.w4a8_gemm_tiled_ref(*args, out_dtype=dt)
            assert w4.counts == before
            want = w4.w4_matmul_ref(*args, out_dtype=dt)
            assert got.dtype == dt and torch.equal(got, want)
        if (K, N) != (self.K, self.N):
            return
        jwant = np.asarray(jw4.w4_matmul(
            jnp.asarray(xq), jnp.asarray(xs), jnp.asarray(jw4.pack_int4(q)), jnp.asarray(ws),
            out_dtype=jnp.float32, interpret=True, force_kernel=True))
        plain = w4.w4_matmul_ref(*args, out_dtype=torch.float32).numpy()
        if groups:
            np.testing.assert_allclose(plain, jwant, rtol=1e-6, atol=1e-5)
        else:
            np.testing.assert_array_equal(plain, jwant)

    @pytest.mark.parametrize("int8_x", [True, False], ids=["int8_x", "bf16_x"])
    @pytest.mark.parametrize("K,N,groups", [
        (1024, 512, 32), (1024, 512, 64), (1024, 512, 128), (96, 12, 0), (96, 12, 3),
        (96, 12, 6),
    ])
    def test_plain_matches_the_jax_group_scan(self, K, N, groups, int8_x):
        """The shapes the JAX package's Pallas K4 does not take (groups of 32,
        16 and 8 in-rows, K 96 with N 12) run its XLA route (the group scan);
        the port's plain version, which the card's simple kernel and group-32
        routes are held to, against it on the same inputs: int8 x equal per
        channel; with group scales within the grouped test's rtol 1e-6 and
        its atol 1e-5 per two groups (XLA may fuse each group's multiply-add:
        one rounding of a term of size up to 100 a group, so the atol grows
        with G; 1e-5 at the grouped test's G = 2); bf16 x within the bf16
        branch's rtol 1e-4, atol 1e-4."""
        rng = np.random.default_rng(K + N + groups)
        xq = rng.integers(-127, 128, (20, K)).astype(np.int8)
        xs = rng.uniform(0.01, 0.1, (20, 1)).astype(np.float32)
        q = rng.integers(-8, 8, (K, N)).astype(np.int8)
        ws = rng.uniform(0.01, 0.1, (groups, N) if groups else (N,)).astype(np.float32)
        wp_t = w4.pack_int4(torch.from_numpy(q.T.copy()))
        jwp, jws = jnp.asarray(jw4.pack_int4(q)), jnp.asarray(ws)
        if int8_x:
            want = jw4.w4_matmul(jnp.asarray(xq), jnp.asarray(xs), jwp, jws, out_dtype=jnp.float32)
            got = w4.w4_matmul(torch.from_numpy(xq), torch.from_numpy(xs), wp_t,
                               torch.from_numpy(ws), out_dtype=torch.float32)
        else:
            x = torch.from_numpy(_rand(rng, 20, K)).bfloat16()
            want = jw4.w4_matmul(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), None, jwp,
                                 jws, out_dtype=jnp.float32)
            got = w4.w4_matmul(x, None, wp_t, torch.from_numpy(ws), out_dtype=torch.float32)
        if int8_x and not groups:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        elif int8_x:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                       atol=1e-5 * groups / 2)
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("int8_x", [True, False])
    def test_k4_route_gives_every_shape_a_kernel(self, int8_x):
        """Every shape the plain version takes has a route on the card: the
        GEMV (m <= 4), the int8 GEMM or the bf16 GEMM where K is a multiple of
        64, N of 8 and the group (K / G, or K per channel) of 32; the simple
        kernel everywhere else. Each GEMV shape has a plan whose slices the C
        entry takes (a multiple of 32 up to 512 dividing K, and the group
        unless it is 32)."""
        for m in (1, 4, 5, 731):
            for K in (2, 6, 96, 128, 192, 320, 3584, 18944):
                for N in (1, 12, 16, 4608):
                    for G in [0] + [g for g in (1, 2, 3, 6, 7, 10, 37, 112, 224, 448, 592)
                                    if K % g == 0]:
                        gsize = K // G if G else K
                        tensor = K % 64 == 0 and N % 8 == 0 and gsize % 32 == 0
                        want = ("simple" if not tensor else "gemv" if m <= 4
                                else "gemm" if int8_x else "bf16_gemm")
                        assert w4.k4_route(m, K, N, G, int8_x) == want, (m, K, N, G)
                        if want != "gemv":
                            continue
                        plan = w4.gemv_plan(m, K, N, G, 132, bf16_x=not int8_x)
                        assert plan.slice_k % 32 == 0 and plan.slice_k <= 512
                        assert K % plan.slice_k == 0
                        assert plan.fold == (gsize == 32)
                        assert plan.fold or gsize % plan.slice_k == 0
        # the 14B projections at groups of 32 (the tensor cores), 16 and 8 (the simple kernel)
        for K, N in ((3584, 4608), (3584, 3584), (3584, 37888), (18944, 3584)):
            for m, route in ((1, "gemv"), (4, "gemv"), (5, "gemm" if int8_x else "bf16_gemm"),
                             (4902, "gemm" if int8_x else "bf16_gemm")):
                assert w4.k4_route(m, K, N, K // 32, int8_x) == route
                assert w4.k4_route(m, K, N, K // 16, int8_x) == "simple"
                assert w4.k4_route(m, K, N, K // 8, int8_x) == "simple"
        assert w4.k4_route(1, 3584, w4.KERNEL_MAX_N + 8, 0, int8_x) == "simple"
        assert w4.k4_route(731, w4.KERNEL_MAX_K + 64, 8, 0, int8_x) == "simple"

    @pytest.mark.parametrize("groups", [0, 2])
    def test_bf16_x_branch(self, groups):
        """Weight-only w4: bf16 x, nibbles exact in bf16, fp32 sums in another
        order than the Pallas kernel's two half-K dots: rtol 1e-4 on the fp32
        result over K = 1024 terms (plus atol 1e-4 for cancelling sums)."""
        rng = np.random.default_rng(10)
        _, _, q, ws, wp_t = self._inputs(10, 1, groups)
        x = torch.from_numpy(_rand(rng, 9, self.K)).bfloat16()
        jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
        want = jw4.w4_matmul(jx, None, jnp.asarray(jw4.pack_int4(q)), jnp.asarray(ws),
                             out_dtype=jnp.float32, interpret=True, force_kernel=True)
        got = w4.w4_matmul(x, None, wp_t, torch.from_numpy(ws), out_dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)

    def test_leading_dims(self):
        xq, xs, q, ws, wp_t = self._inputs(11, 6)
        got = w4.w4_matmul(torch.from_numpy(xq).reshape(2, 3, self.K),
                           torch.from_numpy(xs).reshape(2, 3, 1), wp_t, torch.from_numpy(ws),
                           out_dtype=torch.float32)
        assert got.shape == (2, 3, self.N)
        np.testing.assert_array_equal(got.reshape(6, self.N).numpy(),
                                      _int_reference(xq, xs, q, ws))

    def test_bad_arguments_raise(self):
        wp = torch.zeros(8, 16, dtype=torch.int8)
        with pytest.raises(ValueError, match="wp must be int8"):
            w4.w4_matmul(torch.zeros(2, 30, dtype=torch.int8), torch.ones(2, 1), wp,
                         torch.ones(8))
        with pytest.raises(ValueError, match="x_scale"):
            w4.w4_matmul(torch.zeros(2, 32, dtype=torch.int8), None, wp, torch.ones(8))
        with pytest.raises(ValueError, match="w_scale"):
            w4.w4_matmul(torch.zeros(2, 32), None, wp, torch.ones(3, 8))
        m = torch.empty(2, 32, device="meta")
        with pytest.raises(ValueError, match="CUDA or CPU"):
            w4.w4_matmul(m, None, torch.empty(8, 16, dtype=torch.int8, device="meta"),
                         torch.empty(8, device="meta"))


class TestDecodeInt8:
    """K2-int8's plain version against the Pallas decode kernel in interpret
    mode with scales, and against ``gqa_attention_quant_hm`` of both
    packages: fp32, atol 1e-5 (sums in another order)."""

    def _inputs(self, seed, S=3, H=8, Hk=2, D=16, M=300):
        rng = np.random.default_rng(seed)
        q = _rand(rng, S, 1, H, D)
        k = rng.integers(-127, 128, (S, Hk, M, D)).astype(np.int8)
        v = rng.integers(-127, 128, (S, Hk, M, D)).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, (S, Hk, M)).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, (S, Hk, M)).astype(np.float32)
        return q, k, v, ks, vs

    def test_aligned_band_matches_jax_kernel(self):
        q, k, v, ks, vs = self._inputs(12)
        lens = np.asarray([7, 45, 100], np.int32)
        base, col = np.full(3, 110, np.int32), np.full(3, 115, np.int32)
        want = j_decode(*map(jnp.asarray, (q, k, v, lens)), (jnp.asarray(base), jnp.asarray(col)),
                        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), interpret=True)
        before = dict(dec.int8_counts), dict(dec.counts)
        got = dec.decode_attention(
            *map(torch.from_numpy, (q, k, v, lens)),
            (torch.from_numpy(base), torch.from_numpy(col)),
            k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
        assert dec.int8_counts == dict(kernel=before[0]["kernel"], plain=before[0]["plain"] + 1)
        assert dec.counts == before[1]  # the bf16 kernel's counts stay
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    def test_serving_band_matches_jax_kernel_and_quant_attention(self):
        """band (lens, lens): keys j <= lens are visible."""
        q, k, v, ks, vs = self._inputs(13, S=2, M=130)
        lens = np.asarray([9, 77], np.int32)
        want = j_decode(*map(jnp.asarray, (q, k, v, lens)),
                        (jnp.asarray(lens), jnp.asarray(lens)),
                        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), interpret=True)
        tl = torch.from_numpy(lens)
        got = dec.decode_attention(*map(torch.from_numpy, (q, k, v)), tl, (tl, tl),
                                   k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        mask = np.arange(130)[None, None] <= lens[:, None, None]
        jwant = jatt.gqa_attention_quant_hm(*map(jnp.asarray, (q, k, ks, v, vs, mask)))
        np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=1e-5, atol=1e-5)
        tgot = attention.gqa_attention_quant_hm(*map(torch.from_numpy, (q, k, ks, v, vs, mask)))
        np.testing.assert_allclose(tgot.numpy(), np.asarray(jwant), rtol=1e-5, atol=1e-5)

    def test_masked_out_stream_gives_zero(self):
        q, k, v, ks, vs = self._inputs(14, S=2, M=40)
        lens = torch.tensor([5, 0], dtype=torch.int32)
        got = dec.decode_attention(*map(torch.from_numpy, (q, k, v)), lens,
                                   (torch.tensor([9, 4]), torch.tensor([9, 3])),
                                   k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
        assert torch.isfinite(got).all()

    @pytest.mark.parametrize("plan", [(1, 320), (2, 192), (7, 64), None],
                             ids=["1", "2", "7", "planner"])
    def test_split_ref_matches_plain_and_jax_kernel(self, plan):
        """The kernel's partition and combine over an int8 cache
        (``decode_attention_split_ref``): splits wholly in the gap [lens, base)
        and past max(lens, col + 1), against the one-pass plain version and
        the Pallas kernel in interpret mode, fp32, atol 1e-5."""
        q, k, v, ks, vs = self._inputs(16)
        lens = np.asarray([7, 45, 100], np.int32)
        base, col = np.full(3, 200, np.int32), np.full(3, 215, np.int32)
        t = [torch.from_numpy(a) for a in (q, k, v, lens, base, col, ks, vs)]
        got = dec.decode_attention_split_ref(*t[:4], (t[4], t[5]), t[6], t[7], plan=plan)
        want = dec.decode_attention_ref(*t[:4], (t[4], t[5]), t[6], t[7])
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
        jwant = j_decode(*map(jnp.asarray, (q, k, v, lens)), (jnp.asarray(base), jnp.asarray(col)),
                         k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("plan", [(1, 320), (5, 64)])
    def test_split_ref_nan_scales_on_masked_keys(self, plan):
        """NaN k and v scales on every masked key (the gap, past the band, the
        whole of a stream that sees nothing) never reach the output: the same
        as with finite scales there, and zeros for the empty stream."""
        q, k, v, ks, vs = self._inputs(17)
        lens, base, col = (np.asarray(a, np.int32) for a in ((30, 0, 80), (150, 0, 150),
                                                             (160, -1, 150)))
        j = np.arange(300)
        masked = ~((j[None] < lens[:, None]) | ((j[None] >= base[:, None]) & (j[None] <= col[:, None])))
        nks, nvs = ks.copy(), vs.copy()
        nks[np.broadcast_to(masked[:, None], ks.shape)] = np.nan
        nvs[np.broadcast_to(masked[:, None], vs.shape)] = np.nan
        t = [torch.from_numpy(a) for a in (q, k, v, lens, base, col)]
        got = dec.decode_attention_split_ref(*t[:4], (t[4], t[5]), torch.from_numpy(nks),
                                             torch.from_numpy(nvs), plan=plan)
        assert torch.isfinite(got).all() and (got[1] == 0).all()
        keep = [0, 2]
        want = dec.decode_attention_ref(*(x[keep] for x in t[:4]), (t[4][keep], t[5][keep]),
                                        torch.from_numpy(ks[keep]), torch.from_numpy(vs[keep]))
        np.testing.assert_allclose(got[keep].numpy(), want.numpy(), rtol=1e-5, atol=1e-5)

    def test_scale_and_dtype_mismatches_raise(self):
        q, k, v, ks, vs = map(torch.from_numpy, self._inputs(15, S=1, M=8))
        lens = torch.zeros(1, dtype=torch.int32)
        with pytest.raises(ValueError, match="come together"):
            dec.decode_attention(q, k, v, lens, (0, 0), k_scale=ks)
        with pytest.raises(ValueError, match="int8 cache needs"):
            dec.decode_attention(q, k, v, lens, (0, 0))
        with pytest.raises(ValueError, match="float cache takes none"):
            dec.decode_attention(q, k.float(), v.float(), lens, (0, 0), k_scale=ks, v_scale=vs)
        with pytest.raises(ValueError, match="scales must be"):
            dec.decode_attention(q, k, v, lens, (0, 0), k_scale=ks[:, :, :4], v_scale=vs)


# ---------------------------------------------------------------------------
# the module tree: loader and transforms
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def base():
    """bf16-free fp32 weights of the small config in both packages."""
    params = init_params(2, CFG)
    return params, jax.tree.map(np.asarray, params)


def _jax_quantized(params, kw, fused):
    llm = jquant.quantize_llm_params(params["llm"], via_host=True, **kw)
    if fused:
        llm = jquant.fuse_serving_projections(llm)
    return {**params, "llm": llm}


def _port_quantized(np_params, kw, fused):
    model = loader.from_jax_params(np_params, TCFG, device="cpu")
    quant.quantize_llm_params(model.language_model, **kw)
    if fused:
        quant.fuse_serving_projections(model.language_model)
    return model


def _assert_same_state(got, want):
    got, want = got.state_dict(), want.state_dict()
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key


class TestLoaderOnQuantizedTrees:
    @pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
    @pytest.mark.parametrize("name,kw", MODES, ids=MODE_IDS)
    def test_from_jax_params_equals_port_transforms(self, base, name, kw, fused):
        """The JAX package's quantized (and fused) tree through
        ``from_jax_params``, against the port's own ``quantize_llm_params``
        (and ``fuse_serving_projections``) on the fp32 model: the same
        buffers, bit for bit, and the same modes."""
        params, np_params = base
        jtree = jax.tree.map(np.asarray, _jax_quantized(params, kw, fused))
        got = loader.from_jax_params(jtree, TCFG, device="cpu")
        want = _port_quantized(np_params, kw, fused)
        _assert_same_state(got, want)
        modes = {n: m.mode for n, m in got.named_modules() if isinstance(m, QuantLinear)}
        assert modes == {n: m.mode for n, m in want.named_modules()
                         if isinstance(m, QuantLinear)}
        body = ("p4" if kw["bits"] == 4 else "q") + ("a" if kw.get("act_quant") else "")
        head = "qa" if kw.get("act_quant") else "q"  # the lm_head is int8 always
        assert modes.pop("language_model.lm_head") == head
        per_layer = 2 * (4 if fused else 7)  # two experts of attention + MLP projections
        assert len(modes) == per_layer * CFG.llm.num_hidden_layers
        assert set(modes.values()) == {body}
        assert hasattr(got.language_model.model.layers[0].self_attn, "qkv_proj") == fused

    def test_fused_bf16_tree(self, base):
        """Fusion without quantization: concatenated nn.Linear weights."""
        params, np_params = base
        jtree = {**params, "llm": jquant.fuse_serving_projections(params["llm"])}
        got = loader.from_jax_params(jax.tree.map(np.asarray, jtree), TCFG, device="cpu")
        want = loader.from_jax_params(np_params, TCFG, device="cpu")
        quant.fuse_serving_projections(want.language_model)
        _assert_same_state(got, want)
        attn = got.language_model.model.layers[0].self_attn
        assert not hasattr(attn, "q_proj") and attn.qkv_proj.weight.shape == (64 + 2 * 32, 64)
        assert attn.qkv_proj.bias is not None and attn.qkv_proj_moe_gen.bias is not None

    def test_tp_fused_leaves_raise(self, base):
        """The shard-interleaved fused leaves are ported; what raises now is
        a use they do not serve: a whole model whose fused layout is for
        another "model" degree than the sequence-parallel mesh's (a rank's
        shard holds its own block), a row-parallel packed-int4 shard that
        would split a group of scales (packed int4 itself shards,
        tests/test_torch_mesh.py), a width that does not divide."""
        from unimedvl_tpu_torch.parallel import mesh as pmesh
        from unimedvl_tpu_torch.parallel import sp_denoise

        def model_rank0(tp):  # placement runs no collective: no process group needed
            return pmesh.Mesh(("data", "model"), {"data": 1, "model": tp}, 0,
                              {"data": 0, "model": 0}, {"data": None, "model": None})

        params, np_params = base
        model = loader.from_jax_params(np_params, TCFG, device="cpu")
        quant.fuse_serving_projections(model.language_model, tp=2)
        layer = model.language_model.model.layers[0]
        assert hasattr(layer.self_attn, "qkv_proj_tp2") and hasattr(layer.mlp, "gate_up_proj_tp2")
        with pytest.raises(ValueError, match="tp=2 != mesh model axis 1"):
            sp_denoise._layer_view(layer, "layers.0", 1)
        p4 = _port_quantized(np_params, dict(bits=4), False)
        rank0 = pmesh.place_params(p4, model_rank0(2)).language_model.model.layers[0]
        K = TCFG.llm.num_attention_heads * TCFG.llm.head_dim
        assert rank0.self_attn.o_proj.in_features * 2 == K  # the packed in dim split
        grouped = _port_quantized(np_params, dict(bits=4, group_size=K // 2), False)
        with pytest.raises(ValueError, match="2 groups of"):
            pmesh.place_params(grouped, model_rank0(4))
        plain = loader.from_jax_params(np_params, TCFG, device="cpu")
        with pytest.raises(ValueError, match="does not split over tp=3"):
            quant.fuse_serving_projections(plain.language_model, tp=3)

    @pytest.mark.parametrize("name,kw", [("bf16", None)] + MODES[:2],
                             ids=["bf16", "int8", "int8-act"])
    def test_tp_fused_tree_equals_port_transform(self, base, name, kw):
        """``fuse_serving_projections(tp=2)`` on the port's model against
        ``from_jax_params`` of the JAX package's ``_tp2`` tree: the same
        shard-interleaved buffers, bit for bit, under the ``_tp2`` names."""
        params, np_params = base
        llm = params["llm"] if kw is None else jquant.quantize_llm_params(
            params["llm"], via_host=True, **kw)
        jtree = {**params, "llm": jquant.fuse_serving_projections(llm, tp=2)}
        got = loader.from_jax_params(jax.tree.map(np.asarray, jtree), TCFG, device="cpu")
        want = loader.from_jax_params(np_params, TCFG, device="cpu")
        if kw is not None:
            quant.quantize_llm_params(want.language_model, **kw)
        quant.fuse_serving_projections(want.language_model, tp=2)
        _assert_same_state(got, want)
        names = set(dict(got.language_model.model.layers[0].named_children())["self_attn"]
                    ._modules)
        assert {"qkv_proj_tp2", "qkv_proj_tp2_moe_gen"} <= names and "q_proj" not in names
        # not the plain concatenation: block 0 is [q_0 | k_0 | v_0]
        plain = loader.from_jax_params(np_params, TCFG, device="cpu")
        if kw is not None:
            quant.quantize_llm_params(plain.language_model, **kw)
        attn = plain.language_model.model.layers[0].self_attn
        w = "weight" if kw is None else "weight_q"
        fused = getattr(got.language_model.model.layers[0].self_attn.qkv_proj_tp2, w)
        parts = [getattr(getattr(attn, n), w) for n in ("q_proj", "k_proj", "v_proj")]
        block0 = torch.cat([p[: p.shape[0] // 2] for p in parts])
        assert torch.equal(fused[: fused.shape[0] // 2], block0)

    @pytest.mark.parametrize("mode", ["und", "gen"])
    def test_tp_fused_forward_equals_unfused(self, base, mode):
        """The single-device forward de-interleaves a ``_tp2`` tree: the same
        hidden states as the unfused model (fp32: the products are the same
        dot products, taken in one fused matmul)."""
        _, np_params = base
        plain = loader.from_jax_params(np_params, TCFG, device="cpu")
        fused = loader.from_jax_params(np_params, TCFG, device="cpu")
        quant.fuse_serving_projections(fused.language_model, tp=2)
        rng = np.random.default_rng(41)
        L, Hk, D = CFG.llm.num_hidden_layers, CFG.llm.num_key_value_heads, CFG.llm.head_dim
        x = torch.from_numpy(_rand(rng, 2, 10, CFG.llm.hidden_size))
        pos = torch.from_numpy(rng.integers(0, 40, (2, 1 if mode == "gen" else 10)))
        outs = []
        for model in (plain, fused):
            cache = KVCache.create(L, 2, 32, Hk, D, torch.float32)
            h, cache = model.language_model.model(x, pos, cache, causal=mode == "und", mode=mode)
            outs.append((h, cache.k))
        torch.testing.assert_close(outs[1][0], outs[0][0], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(outs[1][1], outs[0][1], rtol=1e-5, atol=1e-5)

    def test_fusing_mixed_modes_raises(self, base):
        model = loader.from_jax_params(base[1], TCFG, device="cpu")
        attn = model.language_model.model.layers[0].self_attn
        attn.q_proj = quant._quantize_module(attn.q_proj, 8, False, 0)
        with pytest.raises(ValueError, match="different quantized modes"):
            quant.fuse_serving_projections(model.language_model)

    @pytest.mark.parametrize("name,kw", MODES, ids=MODE_IDS)
    def test_checkpoint_load_with_quantization(self, released_ckpt, name, kw):  # noqa: F811
        """``load_bagel_checkpoint(quantize_bits=...)`` on the synthetic
        released-format checkpoint equals quantizing after a plain load."""
        cfg = tconfig.BagelConfig.from_checkpoint_dir(
            str(released_ckpt), max_latent_size=4, vit_max_num_patch_per_side=4)
        got = loader.load_bagel_checkpoint(
            str(released_ckpt), cfg, device="cpu", dtype=torch.float32,
            quantize_bits=kw["bits"],
            act_quant=kw.get("act_quant", False),
            quantize_group=16 if "group_size" in kw else 0)
        want = loader.load_bagel_checkpoint(str(released_ckpt), cfg, device="cpu",
                                            dtype=torch.float32)
        quant.quantize_llm_params(
            want.language_model, act_quant=kw.get("act_quant", False), bits=kw["bits"],
            group_size=16 if "group_size" in kw else 0)
        _assert_same_state(got, want)
        assert got.language_model.lm_head.mode == ("qa" if kw.get("act_quant") else "q")

    def test_checkpoint_quantize_options_need_bits(self, released_ckpt):  # noqa: F811
        with pytest.raises(ValueError, match="need quantize_bits"):
            loader.load_bagel_checkpoint(str(released_ckpt), device="cpu", act_quant=True)

    @pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine without a card")
    @pytest.mark.parametrize("entry", ["load_bagel_checkpoint", "load_ae"])
    def test_loaders_default_to_the_card(self, released_ckpt, entry):  # noqa: F811
        """The loaders place the model on the card by default; without one
        they raise and do not quietly load on the host."""
        import inspect

        fn = getattr(loader, entry)
        assert inspect.signature(fn).parameters["device"].default == "cuda"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(str(released_ckpt))


# ---------------------------------------------------------------------------
# the MLP with K3, the int8 cache, decode
# ---------------------------------------------------------------------------

class TestMLP:
    @pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
    @pytest.mark.parametrize("name,kw", [MODES[1], MODES[3]], ids=["int8-act", "w4a8"])
    def test_mlp_with_k3_matches_jax(self, base, monkeypatch, name, kw, fused):
        """The port's MLP always takes K3's definition on a quantizing down
        projection; the JAX ``_mlp`` takes it with ``_FORCE_SILU_QUANT``.
        Gate and up agree exactly (integer matmuls), K3's q may differ by one
        step where the sigmoids differ in the last place, and one step of one
        element moves an output by at most x_scale * max|w|: atol 1e-3 on
        outputs of order 1."""
        monkeypatch.setattr(jmot, "_FORCE_SILU_QUANT", True)
        params, np_params = base
        jtree = _jax_quantized(params, kw, fused)
        model = _port_quantized(np_params, kw, fused)
        x = _rand(np.random.default_rng(16), 2, 9, CFG.llm.hidden_size)
        jp = jax.tree.map(lambda a: a[1], jtree["llm"]["layers"]["mlp"])
        want = jmot._mlp(jnp.asarray(x), jp, JACT2FN[CFG.llm.hidden_act])
        before = dict(aq.counts)
        got = model.language_model.model.layers[1].mlp(torch.from_numpy(x))
        assert aq.counts["plain"] == before["plain"] + 1
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-3)

    def test_weight_only_mlp_takes_the_plain_product(self, base):
        """Modes that keep x float (``q``, ``p4``) never reach K3."""
        model = _port_quantized(base[1], dict(bits=8), False)
        before = dict(aq.counts)
        model.language_model.model.layers[0].mlp(torch.zeros(1, 3, CFG.llm.hidden_size))
        assert aq.counts == before


def _prefill_and_decode(params, model, rng, jkw):
    """A causal text block (11 of 16 rows valid), a non-causal block (9 of 12)
    and three aligned decode steps through both packages over int8 caches;
    returns the caches and the (jax, torch) hidden states of every forward."""
    L, Hk, D = CFG.llm.num_hidden_layers, CFG.llm.num_key_value_heads, CFG.llm.head_dim
    jcache = jmot.KVCache.create(L, 1, 64, Hk, D, jnp.float32, quantized=True)
    tcache = KVCache.create(L, 1, 64, Hk, D, torch.float32, quantized=True)
    outs, rope = [], 0
    for T, n, causal in ((16, 11, True), (12, 9, False)):
        x = _rand(rng, 1, T, CFG.llm.hidden_size)
        pos = np.full((1, T), rope, np.int64)
        if causal:
            pos[0, :n] = np.arange(rope, rope + n)
        valid = (np.arange(T) < n)[None]
        jh, jcache = jmot.forward(
            params["llm"], CFG.llm, jnp.asarray(x), jnp.asarray(pos), jcache,
            jmot.ForwardSpec("und", causal, True), q_valid=jnp.asarray(valid))
        th, tcache = model.language_model.model(
            torch.from_numpy(x), torch.from_numpy(pos), tcache, causal=causal,
            q_valid=torch.from_numpy(valid))
        outs.append((np.asarray(jh)[0, :n], th[0, :n].numpy()))
        rope = rope + n if causal else rope + 1
    base_col = int(tcache.lens.max())
    for d in range(3):
        x = _rand(rng, 1, 1, CFG.llm.hidden_size)
        pos = np.full((1, 1), rope + d, np.int64)
        jh, jcache = jmot.forward(
            params["llm"], CFG.llm, jnp.asarray(x), jnp.asarray(pos), jcache,
            jmot.ForwardSpec("und", True, True),
            decode_cols=(jnp.asarray(base_col), jnp.asarray(base_col + d)), **jkw)
        th, tcache = model.language_model.model(
            torch.from_numpy(x), torch.from_numpy(pos), tcache, causal=True,
            decode_cols=(torch.tensor(base_col), torch.tensor(base_col + d)))
        outs.append((np.asarray(jh)[0], th[0].numpy()))
    return jcache, tcache, outs, base_col + 3


class TestInt8Cache:
    def test_create_and_helpers(self):
        c = KVCache.create(2, 3, 8, 2, 4, torch.float32, quantized=True)
        assert c.quantized and c.k.dtype == torch.int8 and c.k.shape == (2, 3, 2, 8, 4)
        assert c.k_scale.shape == (2, 3, 2, 8) and c.v_scale.dtype == torch.float32
        assert not KVCache.create(2, 3, 8, 2, 4).quantized
        p = c.padded(5)
        assert p.capacity == 13 and p.k_scale.shape[-1] == 13 and c.padded(0) is c
        f = c.clone()
        f.k_scale += 1
        assert (c.k_scale == 0).all()
        assert c.streams(1).k_scale.shape[1] == 1 and c.streams(1).lens.shape == (1,)
        s = KVCache.stack([c, c.streams(2)])
        assert s.k.shape[1] == 5 and s.v_scale.shape[1] == 5 and s.lens.shape == (5,)
        with pytest.raises(ValueError, match="mix of int8 and float"):
            KVCache.stack([c, KVCache.create(2, 3, 8, 2, 4)])

    def test_kv_bits_4_raises(self):
        """Widths other than 8 and 4 raise, as the JAX package's assert
        refuses them; 4 builds the packed int4 cache (tests/test_torch_kv4.py
        holds its contents against the JAX package)."""
        with pytest.raises(ValueError, match="8 or 4 bits"):
            KVCache.create(1, 1, 8, 1, 4, quantized=True, kv_bits=2)
        c = KVCache.create(1, 1, 8, 1, 4, quantized=True, kv_bits=4)
        assert (c.kv_bits, c.k.dtype, c.k.shape, c.k_scale.shape) == (
            4, torch.int8, (1, 1, 1, 8, 2), (1, 1, 1, 8))

    def test_quantize_kv_block_equals_jax(self):
        b = _rand(np.random.default_rng(17), 2, 5, 2, 16)
        b[0, 1, 1] = 0.0
        wq, ws = jmot._quantize_kv_block(jnp.asarray(b))
        q, s = qwen2_mot._quantize_kv_block(torch.from_numpy(b))
        _eq(q, wq)
        _eq(s, ws)
        _eq(qwen2_mot.dequant_slice(q, s, torch.float32),
            jmot.dequant_slice(wq, ws, jnp.float32))

    @pytest.mark.parametrize("scales_cm", [False, True], ids=["scatter-layout", "column-major"])
    def test_cache_contents_match_jax(self, base, scales_cm):
        """Prefills then aligned decode steps over an int8 cache, fp32
        weights. The port keeps one scale layout [L, S, Hk, M]; the JAX
        decode loop may carry its scales column-major [L, Hk, M, S], which
        holds the same numbers (compared transposed). Written columns:
        hidden states within 2e-3 (the JAX prefill multiplies the scales into
        its logits, the port dequantizes the slice; either is exact up to
        fp32 rounding, but one flipped int8 step of a cached value shows at
        this size), cache integers within one step on at most 1e-3 of the
        elements, scales within 1e-6 relative."""
        params, np_params = base
        model = loader.from_jax_params(np_params, TCFG, device="cpu")
        L, S = CFG.llm.num_hidden_layers, 1
        rng = np.random.default_rng(18)
        if scales_cm:  # as generate_text does: transpose once, before the decode steps
            orig = jmot.forward

            def forward(p, cfg, x, pos, cache, spec, **kw):
                if kw.get("scales_cm") and cache.k_scale.shape[1] == S:
                    cache = cache.replace(k_scale=jnp.transpose(cache.k_scale, (0, 2, 3, 1)),
                                          v_scale=jnp.transpose(cache.v_scale, (0, 2, 3, 1)))
                return orig(p, cfg, x, pos, cache, spec, **kw)

            jkw = dict(scales_cm=True)
            try:
                jmot.forward = forward
                jcache, tcache, outs, n = _prefill_and_decode(params, model, rng, jkw)
            finally:
                jmot.forward = orig
            jks = np.transpose(np.asarray(jcache.k_scale), (0, 3, 1, 2))
            jvs = np.transpose(np.asarray(jcache.v_scale), (0, 3, 1, 2))
        else:
            jcache, tcache, outs, n = _prefill_and_decode(params, model, rng, {})
            jks, jvs = np.asarray(jcache.k_scale), np.asarray(jcache.v_scale)
        for jh, th in outs:
            np.testing.assert_allclose(th, jh, rtol=1e-3, atol=2e-3)
        assert tcache.k.dtype == torch.int8 and tcache.k_scale.shape == (L, S, 2, 64)
        # the second block is 12 columns wide with 9 valid: columns 20..22 hold
        # its padding until the decode steps overwrite them
        for got, want in ((tcache.k, jcache.k), (tcache.v, jcache.v)):
            diff = np.abs(got[:, :, :, :n].numpy().astype(int)
                          - np.asarray(want)[:, :, :, :n].astype(int))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
        np.testing.assert_allclose(tcache.k_scale[..., :n].numpy(), jks[..., :n], rtol=1e-6)
        np.testing.assert_allclose(tcache.v_scale[..., :n].numpy(), jvs[..., :n], rtol=1e-6)

    @pytest.mark.parametrize("name,kw", [MODES[1], MODES[3]], ids=["int8-act", "w4a8"])
    def test_generate_text_over_int8_cache(self, base, name, kw):
        """Greedy tokens over an int8 cache with quantized, fused weights:
        the JAX package's tokens on this seed."""
        params, np_params = base
        jtree = _jax_quantized(params, kw, True)
        model = _port_quantized(np_params, kw, True)
        jcache, tcache, _, _ = _prefill_and_decode(jtree, model, np.random.default_rng(19), {})
        rope = 20
        want, want_len = jbagel.generate_text(
            jtree, CFG, jcache, jnp.asarray([256], jnp.int32), jnp.asarray([rope], jnp.int32),
            10, jnp.asarray(257, jnp.int32), False, 1.0, jax.random.PRNGKey(1))
        lens_before = tcache.lens.clone()
        before = dict(dec.int8_counts)
        got, got_len = bagel.generate_text(
            model, tcache, torch.tensor([256]), torch.tensor([rope]), 10, 257)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
        assert torch.equal(tcache.lens, lens_before)
        steps = int(got_len[0])
        assert dec.int8_counts["plain"] >= before["plain"] + steps * CFG.llm.num_hidden_layers


class TestLmHead:
    @pytest.mark.parametrize("act", [False, True], ids=["kernel_q", "kernel_qa"])
    def test_quantized_lm_head_matches_jax(self, base, act):
        params, np_params = base
        jtree = _jax_quantized(params, dict(bits=8, act_quant=act), False)
        model = _port_quantized(np_params, dict(bits=8, act_quant=act), False)
        h = _rand(np.random.default_rng(20), 2, 3, CFG.llm.hidden_size)
        want = np.asarray(jmot.lm_head(jtree["llm"], jnp.asarray(h)))
        got = qwen2_mot.lm_head(model.language_model, torch.from_numpy(h))
        assert got.dtype == torch.float32 and got.shape == (2, 3, CFG.llm.vocab_size)
        if act:  # integer matmul, then the same two fp32 multiplies
            np.testing.assert_array_equal(got.numpy(), want)
        else:  # fp32 sums in another order
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
