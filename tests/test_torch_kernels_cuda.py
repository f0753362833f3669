"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where there is no CUDA device (the CPU test
run). On the card:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda

Inputs are bf16; the plain versions compute in fp32 from the same inputs.
Tolerance per element: |kernel - plain| <= 1e-2 + 2^-7 |plain| (the kernels
round P and their output to bf16). Only valid query rows are compared.
"""

import pytest
import torch

from unimedvl_tpu_torch.ops import decode_attention as dec
from unimedvl_tpu_torch.ops import flash_attention as fa

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
