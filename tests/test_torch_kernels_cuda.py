"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where there is no CUDA device (the CPU test
run). On the card:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda

Inputs are bf16; the plain versions compute in fp32 from the same inputs.
Tolerance per element: |kernel - plain| <= 1e-2 + 2^-7 |plain| (the kernels
round P and their output to bf16). Only valid query rows are compared. K1b
(q pre-processing) against K1a on the plainly pre-processed q: within one
bf16 ulp of each output row's largest |value|, since only the rounding of a
few q elements may differ, which moves the whole row.
"""

import pytest
import torch

from unimedvl_tpu_torch.ops import decode_attention as dec
from unimedvl_tpu_torch.ops import flash_attention as fa
from unimedvl_tpu_torch.ops.rope import rope_cos_sin

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, scale=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)


def _ints(*vals):
    return torch.tensor(vals, dtype=torch.int32, device="cuda")


def _assert_close(got, want):
    err = (got.float() - want.float()).abs()
    assert (err <= 1e-2 + 2.0**-7 * want.float().abs()).all(), err.max().item()


FLASH = [
    # (T, M, H, Hk, D, lens, bstart, q_valid_len, causal, head_major)
    (1, 70, 28, 4, 128, (33,), (33,), (1,), True, True),
    (77, 300, 28, 4, 128, (100, 0), (100, 0), (77, 50), True, True),
    (130, 130, 16, 16, 72, (130, 61), (130, 130), None, False, False),
    (66, 200, 8, 2, 128, (10, 3), (120, 3), (66, 40), False, True),
    (64, 64, 4, 4, 72, (0,), (0,), (64,), True, False),
]


@pytest.mark.parametrize("case", FLASH)
def test_flash_block_attention_matches_plain(gen, case):
    T, M, H, Hk, D, lens, bstart, qvl, causal, hm = case
    S = len(lens)
    q = _randn(gen, S, T, H, D, scale=2.0)
    kv_shape = (S, Hk, M, D) if hm else (S, M, Hk, D)
    k, v = _randn(gen, *kv_shape), _randn(gen, *kv_shape)
    args = (_ints(*lens), _ints(*bstart), causal)
    qv = None if qvl is None else _ints(*qvl)
    before = fa.counts["kernel"]
    got = fa.flash_block_attention(q, k, v, *args, q_valid_len=qv, kv_head_major=hm)
    assert fa.counts["kernel"] == before + 1
    want = fa.flash_block_attention_ref(q, k, v, *args, q_valid_len=qv, kv_head_major=hm)
    for s in range(S):
        n = T if qvl is None else qvl[s]
        _assert_close(got[s, :n], want[s, :n])


def test_flash_reads_strided_kv(gen):
    """k/v as views of a wider buffer (the cache slice of one layer)."""
    buf = _randn(gen, 2, 3, 4, 256, 128)  # [L, S, Hk, M, D]
    q = _randn(gen, 3, 20, 28, 128)
    lens = _ints(40, 0, 200)
    k, v = buf[0], buf[1]
    got = fa.flash_block_attention(q, k, v, lens, lens, True, kv_head_major=True)
    want = fa.flash_block_attention_ref(q, k, v, lens, lens, True, kv_head_major=True)
    _assert_close(got, want)


def _q_preproc(gen, S, T, compact, end_row, D=128):
    pos = torch.randint(0, 4000, (S, 1 if compact else T), generator=gen, device="cuda")
    cos, sin = rope_cos_sin(pos, D, 1e6)
    w = lambda: 1 + 0.1 * torch.randn(D, generator=gen, device="cuda")  # noqa: E731
    return dict(w_und=w().to(torch.bfloat16), w_gen=w().to(torch.bfloat16), cos=cos, sin=sin,
                end_row=end_row, eps=1e-6)


def _row_ulp(got, want):
    """bf16 spacing (8 significant bits) at each output row's largest |value|."""
    scale = torch.maximum(got.abs(), want.abs()).amax(dim=-1, keepdim=True)
    return torch.exp2(torch.floor(torch.log2(scale.float().clamp_min(2.0**-126))) - 7)


QPRE = [
    # (S, T, cap, lens, q_valid_len, end_row, compact, causal): block at cap
    # (denoise) or at lens (cap None: the VAE prefill writes into the cache)
    (3, 1026, 512, (37, 0, 37), None, None, True, False),  # 512 px denoise, CFG on
    (1, 1026, 512, (37,), None, None, True, False),  # 512 px denoise, one stream
    (3, 1026, 3072, (2440, 2403, 37), None, None, True, False),  # 512 px edit denoise
    (1, 1026, None, (0,), (992,), 991, True, False),  # bucketed VAE prefill, 990 latents
    (2, 130, 256, (100, 3), (130, 77), (129, 76), False, True),  # full tables, causal
]


@pytest.mark.parametrize("case", QPRE)
def test_flash_q_preproc_matches_plain(gen, case):
    S, T, cap, lens, qvl, end_row, compact, causal = case
    H, Hk, D = 28, 4, 128
    M = (cap if cap is not None else max(lens)) + T
    q = _randn(gen, S, T, H, D, scale=2.0)
    k, v = _randn(gen, S, Hk, M, D), _randn(gen, S, Hk, M, D)
    bstart = _ints(*([cap] * S)) if cap is not None else _ints(*lens)
    qv = None if qvl is None else _ints(*qvl)
    er = None if end_row is None else (_ints(*end_row) if isinstance(end_row, tuple) else end_row)
    qp = _q_preproc(gen, S, T, compact, er)
    args = (q, k, v, _ints(*lens), bstart, causal)
    before = dict(fa.q_preproc_counts), dict(fa.counts)
    got = fa.flash_block_attention(*args, q_valid_len=qv, kv_head_major=True, q_preproc=qp)
    assert fa.q_preproc_counts["kernel"] == before[0]["kernel"] + 1
    assert fa.counts == before[1]
    want = fa.flash_block_attention_ref(*args, q_valid_len=qv, kv_head_major=True, q_preproc=qp)
    for s in range(S):
        n = T if qvl is None else qvl[s]
        _assert_close(got[s, :n], want[s, :n])


def test_flash_q_preproc_prologue_against_k1a(gen):
    """K1b on raw q against K1a on the plainly pre-processed q."""
    S, T, M, H, Hk, D = 3, 1026, 1538, 28, 4, 128
    q = _randn(gen, S, T, H, D, scale=2.0)
    k, v = _randn(gen, S, Hk, M, D), _randn(gen, S, Hk, M, D)
    qp = _q_preproc(gen, S, T, True, None)
    args = (k, v, _ints(37, 0, 37), _ints(512, 512, 512), False)
    got = fa.flash_block_attention(q, *args, kv_head_major=True, q_preproc=qp).float()
    want = fa.flash_block_attention(fa.preprocess_q(q, qp), *args, kv_head_major=True).float()
    ulp = _row_ulp(got, want)
    assert ((got - want).abs() <= ulp).all(), ((got - want).abs() / ulp).max().item()


def test_flash_q_preproc_takes_head_dim_128_only(gen):
    q, kv = _randn(gen, 1, 8, 4, 72), _randn(gen, 1, 4, 16, 72)
    qp = _q_preproc(gen, 1, 8, True, None, D=72)
    with pytest.raises(ValueError, match="K1b"):
        fa.flash_block_attention(q, kv, kv, _ints(0), _ints(0), False, kv_head_major=True,
                                 q_preproc=qp)


DECODE = [
    # (M, H, Hk, lens, base, col)
    (5632, 28, 4, (4950,), (4950,), (4960,)),
    (700, 28, 4, (10, 300, 650), (650, 650, 650), (699, 699, 699)),
    (257, 16, 2, (256, 0), (256, 0), (256, 0)),
]


@pytest.mark.parametrize("case", DECODE)
def test_decode_attention_matches_plain(gen, case):
    M, H, Hk, lens, base, col = case
    S = len(lens)
    q = _randn(gen, S, 1, H, 128, scale=2.0)
    k, v = _randn(gen, S, Hk, M, 128), _randn(gen, S, Hk, M, 128)
    band = (_ints(*base), _ints(*col))
    before = dec.counts["kernel"]
    got = dec.decode_attention(q, k, v, _ints(*lens), band)
    assert dec.counts["kernel"] == before + 1
    _assert_close(got, dec.decode_attention_ref(q, k, v, _ints(*lens), band))


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    q = _randn(gen, 1, 8, 4, 64)
    kv = _randn(gen, 1, 4, 16, 64)
    lens = _ints(0)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_block_attention(q, kv, kv, lens, lens, True, kv_head_major=True)
    with pytest.raises(TypeError, match="bfloat16"):
        q128, kv128 = _randn(gen, 1, 8, 4, 128), _randn(gen, 1, 4, 16, 128)
        fa.flash_block_attention(q128.float(), kv128, kv128, lens, lens, True,
                                 kv_head_major=True)
    with pytest.raises(ValueError, match="head dim"):
        dec.decode_attention(q[:, :1].contiguous(), kv, kv, lens, (0, 0))
