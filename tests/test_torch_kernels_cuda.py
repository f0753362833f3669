"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where there is no CUDA device (the CPU test
run). On the card:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda

Inputs are bf16; the plain versions compute in fp32 from the same inputs.
Tolerance per element: |kernel - plain| <= 1e-2 + 2^-7 |plain| (the kernels
round P and their output to bf16). Only valid query rows are compared. K1b
(q pre-processing) against K1a on the plainly pre-processed q: within one
bf16 ulp of each output row's largest |value|, since only the rounding of a
few q elements may differ, which moves the whole row. K1c's lse: within 1e-3
absolute of the plain version's, and equal to it where that is float32 min
(rows that see nothing). K6 takes the attention tolerance.

The quantized kernels. K4 (packed-int4 matmul) with int8 x equals its plain
version bit for bit, per channel and grouped (integer sums are exact and both
apply the same rounded fp32 multiplies and adds in one order); with bf16 x the
fp32 sums run in another order: |err| <= 2^-7 |plain| + 1e-3 * sqrt(K) * 8 *
max|x| * max(w_scale) / 16 per element (a loose bound on the reordering error,
well under one output rounding). K4's GEMV (m <= 4) combines its slice sums
in a fixed order: repeats, and replays of a CUDA graph that captured it, are
bit-equal to eager calls. K3 (silu * mul * quant): scales within 1e-6
relative, q within one step, at most 1e-3 of the elements differing (expf
against torch.sigmoid in the last place). K2-int8 takes the attention
tolerance above.

K5 (packed training attention). Its forward takes the attention tolerance.
Each gradient is held, per element, to |err| <= 2^-7 (m + |plain|) + floor,
with m the largest |plain| of the element's row [..., D]: the kernels round p
and ds to bf16 for their second product (2^-9 of a row's scale per term). The
floor covers what does not shrink with the row's own gradient. For dk and dv
it is 2^-4 M, M the mean of m over the tensor. For dq: the kernels take
dsum = do . out from the bf16 output where autograd's softmax backward uses
unrounded values, a difference of about 2^-9 sqrt(sum_d (do_d out_d)^2) that
reaches dq as scale * p * k, so the floor is 6 times that with max|k| (it
matters for rows that see a few keys: out is large and dq nearly zero). The
cotangent is bf16-representable, as it is on the model's path. dk and dv are
summed per query head in registers, then over the heads of a group in head
order by the combine launch (no atomics): repeats are bit-equal. The plan
launch, which the forward runs and the backward reuses, is held to its Python
twin (``tile_plan``, ``query_tile_order``), list for list; the forward's lse to
its tiled twin's within 1e-3 (``packed_train_attention_fwd_tiled_ref``, the
kernel's partition and log2-unit softmax on the same bf16 inputs).
"""

import pytest
import torch

from unimedvl_tpu_torch.ops import act_quant as aq
from unimedvl_tpu_torch.ops import decode_attention as dec
from unimedvl_tpu_torch.ops import flash_attention as fa
from unimedvl_tpu_torch.ops import flash_attention_train as fat
from unimedvl_tpu_torch.ops.blockmask import packed_segment_ids
from unimedvl_tpu_torch.ops import w4_matmul as w4
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


NEG_INF = float(torch.finfo(torch.float32).min)
LSE_ATOL = 1e-3  # fp32 online sums against one fp32 softmax over the same bf16 logits


def _assert_lse_close(got, want):
    """Within LSE_ATOL where the plain lse is finite, equal where it is the
    float32 min (a row that sees nothing)."""
    empty = want == NEG_INF
    assert torch.equal(got[empty], want[empty])
    assert torch.isfinite(got).all()
    assert ((got - want).abs()[~empty] <= LSE_ATOL).all(), (got - want).abs()[~empty].max().item()


LSE = [
    # (S, T, H, Hk, D, M, lens, bstart, q_valid_len, causal, q_preproc)
    (3, 1026, 28, 4, 128, 512, (56, 0, 56), (56, 0, 56), (0, 0, 0), False, True),  # cache partial
    (3, 1026, 28, 4, 128, 1026, (1026,) * 3, (1026,) * 3, (0, 0, 0), False, True),  # block partial
    (1, 258, 14, 2, 128, 1026, (1026,), (1026,), (0,), False, True),  # TP2 x SP4 local shapes
    (2, 77, 8, 2, 128, 300, (100, 0), (100, 0), (77, 50), True, False),  # K1a shapes, causal
    (2, 130, 16, 16, 72, 130, (130, 61), (130, 130), None, False, False),  # D 72
]


@pytest.mark.parametrize("case", LSE)
def test_flash_return_lse_matches_plain(gen, case):
    S, T, H, Hk, D, M, lens, bstart, qvl, causal, pre = case
    q = _randn(gen, S, T, H, D, scale=2.0)
    k, v = _randn(gen, S, Hk, M, D), _randn(gen, S, Hk, M, D)
    qv = None if qvl is None else _ints(*qvl)
    qp = _q_preproc(gen, S, T, True, None) if pre else None
    args = (q, k, v, _ints(*lens), _ints(*bstart), causal)
    kw = dict(q_valid_len=qv, kv_head_major=True, q_preproc=qp, return_lse=True)
    before = dict(fa.lse_counts), dict(fa.counts), dict(fa.q_preproc_counts)
    got, got_lse = fa.flash_block_attention(*args, **kw)
    assert fa.lse_counts["kernel"] == before[0]["kernel"] + 1
    assert (fa.counts, fa.q_preproc_counts) == before[1:]
    want, want_lse = fa.flash_block_attention_ref(*args, **kw)
    assert got_lse.shape == (S, T, H) and got_lse.dtype == torch.float32
    # q_valid_len 0 (the partials) means no block keys, not no valid rows
    rows = [T if qvl is None or qvl[s] == 0 else qvl[s] for s in range(S)]
    for s in range(S):
        _assert_close(got[s, :rows[s]], want[s, :rows[s]])
        _assert_lse_close(got_lse[s, :rows[s]], want_lse[s, :rows[s]])


def test_flash_partials_combine_to_k1b(gen):
    """The cache partial and the block partial of the sequence-parallel
    denoise, merged, against K1b over the concatenation; the text-CFG stream's
    cache partial is empty."""
    from unimedvl_tpu_torch.ops.attention import combine_attention_partials

    S, T, H, Hk, D, M0 = 3, 1026, 28, 4, 128, 512
    q = _randn(gen, S, T, H, D, scale=2.0)
    kc, vc = _randn(gen, S, Hk, M0, D), _randn(gen, S, Hk, M0, D)
    kb, vb = _randn(gen, S, T, Hk, D), _randn(gen, S, T, Hk, D)
    lens = _ints(56, 0, 56)
    qp = _q_preproc(gen, S, T, True, None)
    kw = dict(q_valid_len=0, kv_head_major=True, q_preproc=qp, return_lse=True)
    part_c = fa.flash_block_attention(q, kc, vc, lens, lens, False, **kw)
    part_b = fa.flash_block_attention(q, kb.transpose(1, 2), vb.transpose(1, 2), T, T, False, **kw)
    assert (part_c[1][1] == NEG_INF).all() and (part_c[0][1] == 0).all()
    got = combine_attention_partials([part_c, part_b])
    k_cat = torch.cat([kc, kb.transpose(1, 2)], dim=2)
    v_cat = torch.cat([vc, vb.transpose(1, 2)], dim=2)
    want = fa.flash_block_attention_ref(q, k_cat, v_cat, lens, M0, False, kv_head_major=True,
                                        q_preproc=qp)
    assert torch.isfinite(got.float()).all()
    _assert_close(got, want)


K6 = [
    # (S, T, Tb, H, Hk, M, lens, causal, q_pre, kv_pre: None | "compact" | "full", k_end_row,
    #  block_len, cache_head_major)
    (3, 1026, 1026, 28, 4, 3072, (2453, 2397, 56), False, True, "compact", None, None, True),
    (1, 258, 1026, 14, 2, 512, (56,), False, True, "compact", 1025, 1026, True),  # SP gathered keys
    (2, 64, 64, 28, 4, 1024, (800, 37), True, False, None, None, None, True),  # causal text block
    (2, 70, 70, 8, 2, 200, (33, 0), False, True, "full", None, None, False),  # full k tables
    (2, 70, 96, 8, 2, 200, (33, 200), False, True, None, None, 81, False),  # padded key block
    (1, 130, 130, 4, 4, 64, (64,), True, True, None, None, None, True),  # causal with q island
]


@pytest.mark.parametrize("case", K6)
def test_flash_cache_block_attention_matches_plain(gen, case):
    S, T, Tb, H, Hk, M, lens, causal, q_pre, kv_pre, k_end, block_len, hm = case
    D = 128
    q = _randn(gen, S, T, H, D, scale=2.0)
    cshape = (S, Hk, M, D) if hm else (S, M, Hk, D)
    kc, vc = _randn(gen, *cshape), _randn(gen, *cshape)
    kb, vb = _randn(gen, S, Tb, Hk, D, scale=2.0 if kv_pre else 1.0), _randn(gen, S, Tb, Hk, D)
    qp = _q_preproc(gen, S, T, True, None) if q_pre else None
    kvp = None
    if kv_pre is not None:
        kvp = _q_preproc(gen, S, Tb, kv_pre == "compact", k_end)
        if kv_pre == "compact":  # the defaults: q's tables
            del kvp["cos"], kvp["sin"]
        if k_end is None:
            del kvp["end_row"]
    kw = dict(q_preproc=qp, kv_preproc=kvp, block_len=block_len, cache_head_major=hm)
    before = fa.cache_block_counts["kernel"]
    got = fa.flash_cache_block_attention(q, kc, vc, kb, vb, _ints(*lens), causal, **kw)
    assert fa.cache_block_counts["kernel"] == before + 1
    want = fa.flash_cache_block_attention_ref(q, kc, vc, kb, vb, _ints(*lens), causal, **kw)
    assert torch.isfinite(got.float()).all()
    _assert_close(got, want)


def test_flash_cache_block_equals_concat_k1b(gen):
    """K6 against K1b over the concatenation it avoids (kernel against
    kernel), within the attention tolerance."""
    S, T, H, Hk, D, M = 2, 130, 8, 2, 128, 256
    q = _randn(gen, S, T, H, D, scale=2.0)
    kc, vc = _randn(gen, S, Hk, M, D), _randn(gen, S, Hk, M, D)
    kb, vb = _randn(gen, S, T, Hk, D), _randn(gen, S, T, Hk, D)
    qp = _q_preproc(gen, S, T, True, None)
    lens = _ints(128, 77)
    got = fa.flash_cache_block_attention(q, kc, vc, kb, vb, lens, False, q_preproc=qp,
                                         cache_head_major=True)
    k_cat = torch.cat([kc, kb.transpose(1, 2)], dim=2)
    v_cat = torch.cat([vc, vb.transpose(1, 2)], dim=2)
    want = fa.flash_block_attention(q, k_cat, v_cat, lens, M, False, kv_head_major=True,
                                    q_preproc=qp)
    _assert_close(got, want)


def test_flash_cache_block_raises(gen):
    q, kv = _randn(gen, 1, 8, 4, 128), _randn(gen, 1, 4, 16, 128)
    kb = _randn(gen, 1, 12, 4, 128)
    qp = _q_preproc(gen, 1, 8, True, None)
    lens = _ints(3)
    with pytest.raises(ValueError, match="requires block_len"):
        fa.flash_cache_block_attention(q, kv, kv, kb, kb, lens, False, cache_head_major=True)
    with pytest.raises(ValueError, match="non-causal only"):
        fa.flash_cache_block_attention(q, kv, kv, kb, kb, lens, True, block_len=12,
                                       cache_head_major=True)
    with pytest.raises(ValueError, match="requires q_preproc"):
        fa.flash_cache_block_attention(q, kv, kv, kb[:, :8], kb[:, :8], lens, False,
                                       kv_preproc=qp, cache_head_major=True)
    q72, kv72 = _randn(gen, 1, 8, 4, 72), _randn(gen, 1, 4, 16, 72)
    with pytest.raises(ValueError, match="K6"):
        fa.flash_cache_block_attention(q72, kv72, kv72, q72, q72, lens, False,
                                       cache_head_major=True)


# The sweep visits only the key tiles with a visible key for some row of a CTA
# (ops.flash_attention.sweep_plan): 64 keys a tile, 128 query rows a CTA (two
# warpgroups on wgmma) at D 72 and 128.
SWEEP = [
    # (S, T, M, H, Hk, D, lens, bstart, q_valid_len, causal)
    (3, 1026, 1538, 28, 4, 128, (37, 0, 37), (512, 512, 512), None, False),  # K1b's gap
    (2, 200, 700, 8, 2, 128, (37, 100), (333, 301), (200, 150), True),  # causal, off the grid
    (2, 200, 700, 8, 2, 128, (37, 100), (333, 301), (200, 150), False),
    (2, 130, 500, 16, 16, 72, (61, 0), (300, 77), (130, 100), False),  # D 72 with a block
    (1, 1, 70, 28, 4, 128, (33,), (33,), (1,), True),  # T 1
    (1, 1, 70, 16, 16, 72, (33,), (33,), (1,), False),
    (2, 129, 400, 8, 2, 128, (129, 0), (129, 0), (129, 129), True),  # T = 128 + 1
    (2, 65, 300, 8, 8, 72, (0, 200), (0, 200), (65, 65), True),  # one warpgroup + 1 row
]


@pytest.mark.parametrize("case", SWEEP)
def test_flash_sweep_skips_dead_tiles_and_selects_in_straddling_ones(gen, case):
    """NaN in every key row that no query row sees (the gap between lens and
    the block, the tail past the block, the rows past a causal row's reach are
    kept: other rows see them): skipped tiles never reach the output, and the
    tiles that straddle a boundary zero-fill and select their dead rows."""
    S, T, M, H, Hk, D, lens, bstart, qvl, causal = case
    q = _randn(gen, S, T, H, D, scale=2.0)
    k, v = _randn(gen, S, Hk, M, D), _randn(gen, S, Hk, M, D)
    qv = _ints(*(qvl or (T,) * S))
    args = (_ints(*lens), _ints(*bstart), causal)
    want = fa.flash_block_attention_ref(q, k, v, *args, q_valid_len=qv, kv_head_major=True)
    j = torch.arange(M, device="cuda")
    ln, bs = _ints(*lens)[:, None], _ints(*bstart)[:, None]
    dead = ~((j < ln) | ((j >= bs) & (j < bs + qv[:, None])))  # [S, M]
    k[dead[:, None].expand(S, Hk, M)] = float("nan")
    v[dead[:, None].expand(S, Hk, M)] = float("nan")
    got = fa.flash_block_attention(q, k, v, *args, q_valid_len=qv, kv_head_major=True)
    for s in range(S):
        n = (qvl or (T,) * S)[s]
        assert torch.isfinite(got[s, :n].float()).all()
        _assert_close(got[s, :n], want[s, :n])


@pytest.mark.parametrize("D,pre", [(128, True), (128, False), (72, False)])
def test_flash_stream_without_keys_never_reads_q(gen, D, pre):
    """A stream with lens 0 and no block keys (the text-CFG stream's cache
    partial): its CTAs write zeros and the lse minimum before any load, so
    NaN in its q (and in its whole k/v) never shows; the other streams agree
    with the plain version."""
    S, T, M, H, Hk = 3, 300, 256, 8, 2
    q = _randn(gen, S, T, H, D, scale=2.0)
    k, v = _randn(gen, S, Hk, M, D), _randn(gen, S, Hk, M, D)
    lens = _ints(56, 0, 200)
    qp = _q_preproc(gen, S, T, True, None) if pre else None
    kw = dict(q_valid_len=0, kv_head_major=True, q_preproc=qp, return_lse=True)
    want, want_lse = fa.flash_block_attention_ref(q, k, v, lens, lens, False, **kw)
    q[1], k[1], v[1] = float("nan"), float("nan"), float("nan")
    got, got_lse = fa.flash_block_attention(q, k, v, lens, lens, False, **kw)
    assert (got[1] == 0).all() and (got_lse[1] == NEG_INF).all()
    assert torch.isfinite(got.float()).all() and torch.isfinite(got_lse).all()
    _assert_close(got, want)
    _assert_lse_close(got_lse, want_lse)


@pytest.mark.parametrize("D", [72, 128])
def test_flash_reads_strided_kv_at_both_head_dims(gen, D):
    """k/v as non-contiguous views: heads and keys strided in a wider
    buffer ([S, M, Hk, D + 8], not head-major), and every other key of a
    head-major buffer."""
    S, T, M, H, Hk = 2, 150, 300, 8, 2
    q = _randn(gen, S, T, H, D, scale=2.0)
    lens = _ints(120, 37)
    wide = _randn(gen, 2, S, M, Hk, D + 8)[..., :D]
    assert not wide[0].is_contiguous()
    got = fa.flash_block_attention(q, wide[0], wide[1], lens, lens, True)
    _assert_close(got, fa.flash_block_attention_ref(q, wide[0], wide[1], lens, lens, True))
    every_other = _randn(gen, 2, S, Hk, 2 * M, D)[:, :, :, ::2]
    got = fa.flash_block_attention(q, every_other[0], every_other[1], lens, lens, True,
                                   kv_head_major=True)
    _assert_close(got, fa.flash_block_attention_ref(q, every_other[0], every_other[1], lens, lens,
                                                    True, kv_head_major=True))


def test_flash_repeats_are_bit_equal(gen):
    """K1a (D 72 and 128), K1b with lse and K6 with both islands, twice each
    on the same inputs: every sum runs in one fixed order, so the outputs are
    bit-equal."""
    S, T, M, H, Hk = 3, 300, 700, 8, 2
    lens = _ints(37, 0, 500)
    calls = []
    for D in (72, 128):
        q, k, v = _randn(gen, S, T, H, D), _randn(gen, S, Hk, M, D), _randn(gen, S, Hk, M, D)
        calls.append(lambda q=q, k=k, v=v: fa.flash_block_attention(
            q, k, v, lens, _ints(512, 512, 512), False, kv_head_major=True))
    qp = _q_preproc(gen, S, T, True, None)
    calls.append(lambda: fa.flash_block_attention(q, k, v, lens, lens, False, q_valid_len=0,
                                                  kv_head_major=True, q_preproc=qp,
                                                  return_lse=True))
    kb, vb = _randn(gen, S, T, Hk, 128), _randn(gen, S, T, Hk, 128)
    kvp = {n: _q_preproc(gen, S, T, True, None)[n] for n in ("w_und", "w_gen")}
    calls.append(lambda: fa.flash_cache_block_attention(q, k, v, kb, vb, lens, False,
                                                        q_preproc=qp, kv_preproc=kvp,
                                                        cache_head_major=True))
    for call in calls:
        a, b = call(), call()
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)


def test_flash_cache_block_skips_the_cache_gap(gen):
    """K6 reads the cache only below lens: NaN in the cache columns from lens
    to the capacity, and in the block rows past block_len, never show."""
    S, T, Tb, H, Hk, M = 3, 258, 1026, 14, 2, 512
    q = _randn(gen, S, T, H, 128, scale=2.0)
    kc, vc = _randn(gen, S, Hk, M, 128), _randn(gen, S, Hk, M, 128)
    kb, vb = _randn(gen, S, Tb, Hk, 128), _randn(gen, S, Tb, Hk, 128)
    lens, blk = _ints(56, 0, 300), 1000
    qp = _q_preproc(gen, S, T, True, None)
    kw = dict(q_preproc=qp, block_len=blk, cache_head_major=True)
    want = fa.flash_cache_block_attention_ref(q, kc, vc, kb, vb, lens, False, **kw)
    gap = torch.arange(M, device="cuda")[None] >= lens[:, None]
    kc[gap[:, None].expand(S, Hk, M)] = float("nan")
    vc[gap[:, None].expand(S, Hk, M)] = float("nan")
    kb[:, blk:], vb[:, blk:] = float("nan"), float("nan")
    got = fa.flash_cache_block_attention(q, kc, vc, kb, vb, lens, False, **kw)
    assert torch.isfinite(got.float()).all()
    _assert_close(got, want)


DECODE = [
    # (M, H, Hk, lens, base, col); the kernel's splits (ops.decode_attention.plan_splits)
    # are noted where the case is about them
    (5632, 28, 4, (4950,), (4950,), (4960,)),  # 44 splits of 128
    (700, 28, 4, (10, 300, 650), (650, 650, 650), (699, 699, 699)),
    (257, 16, 2, (256, 0), (256, 0), (256, 0)),
    (3000, 28, 4, (1234,), (1234,), (1234,)),  # lens not a multiple of the split (64)
    # 30 splits of 192: stream 0's gap [100, 4950) spans 25 whole splits
    (5632, 28, 4, (100, 4000), (4950, 4950), (4955, 4955)),
    (1024, 28, 4, tuple(776 + (i % 7) * 8 for i in range(48)),  # batched decode, 2 splits
     tuple(776 + (i % 7) * 8 for i in range(48)), tuple(776 + (i % 7) * 8 for i in range(48))),
    (40, 28, 4, (30, 3), (30, 20), (35, 19)),  # below one tile; stream 1 band empty
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


@pytest.mark.parametrize("quantized", [False, True])
def test_decode_attention_reads_a_scalar_band_tensor(gen, quantized):
    """The decode loop's band: 0-dim int32 tensors on the card, one value for
    every stream, read as they are (no copy kernel)."""
    S, M = 3, 1500
    q = _randn(gen, S, 1, 28, 128, scale=2.0)
    if quantized:
        k, v = _int8(gen, S, 4, M, 128), _int8(gen, S, 4, M, 128)
        scales = [torch.rand(S, 4, M, generator=gen, device="cuda") * 0.02 + 0.005
                  for _ in range(2)]
    else:
        k, v, scales = _randn(gen, S, 4, M, 128), _randn(gen, S, 4, M, 128), [None, None]
    lens = _ints(10, 700, 1200)
    base = lens.max()
    band = (base, base + 7)
    assert band[0].dim() == 0 and band[1].dtype == torch.int32
    got = dec.decode_attention(q, k, v, lens, band, *scales)
    want = dec.decode_attention_ref(q, k, v, lens, (_ints(1200, 1200, 1200), _ints(1207, 1207, 1207)),
                                    *scales)
    _assert_close(got, want)


@pytest.mark.parametrize("M", [300, 5632])
def test_decode_attention_masked_rows_never_reach_the_output(gen, M):
    """NaN in every cache row that no stream sees (the gap [lens, base), past
    the band, past the longest stream): the kernel zero-fills those rows
    instead of reading them, and weighs them 0 by selection."""
    S, H, Hk = 2, 28, 4
    q = _randn(gen, S, 1, H, 128, scale=2.0)
    k, v = _randn(gen, S, Hk, M, 128), _randn(gen, S, Hk, M, 128)
    lens, base, col = _ints(M // 10, 7), _ints(M // 2, M // 2), _ints(M // 2 + 5, M // 2 + 5)
    want = dec.decode_attention_ref(q, k, v, lens, (base, col))
    j = torch.arange(M, device="cuda")
    masked = ~((j[None] < lens[:, None]) | ((j[None] >= base[:, None]) & (j[None] <= col[:, None])))
    k[masked[:, None].expand(S, Hk, M)] = float("nan")
    v[masked[:, None].expand(S, Hk, M)] = float("nan")
    got = dec.decode_attention(q, k, v, lens, (base, col))
    assert torch.isfinite(got).all()
    _assert_close(got, want)


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


def _int8(gen, *shape, lo=-127, hi=128):
    return torch.randint(lo, hi, shape, generator=gen, device="cuda", dtype=torch.int8)


DECODE_INT8 = DECODE + [
    (1024, 28, 4, tuple([800] * 48), tuple([800] * 48), tuple([800] * 48)),  # (lens, lens)
]


@pytest.mark.parametrize("case", DECODE_INT8)
def test_decode_attention_int8_matches_plain(gen, case):
    M, H, Hk, lens, base, col = case
    S = len(lens)
    q = _randn(gen, S, 1, H, 128, scale=2.0)
    k, v = _int8(gen, S, Hk, M, 128), _int8(gen, S, Hk, M, 128)
    ks = torch.rand(S, Hk, M, generator=gen, device="cuda") * 0.02 + 0.005
    vs = torch.rand(S, Hk, M, generator=gen, device="cuda") * 0.02 + 0.005
    band = (_ints(*base), _ints(*col))
    before = dict(dec.int8_counts), dict(dec.counts)
    got = dec.decode_attention(q, k, v, _ints(*lens), band, k_scale=ks, v_scale=vs)
    assert dec.int8_counts["kernel"] == before[0]["kernel"] + 1 and dec.counts == before[1]
    _assert_close(got, dec.decode_attention_ref(q, k, v, _ints(*lens), band, ks, vs))


def test_decode_attention_int8_reads_a_cache_layer(gen):
    """k/v and scales as one layer's views of the stacked cache; a stream whose
    keys are all masked gives zeros, not NaN, even over NaN scales."""
    L, S, Hk, M = 2, 2, 4, 300
    kc, vc = _int8(gen, L, S, Hk, M, 128), _int8(gen, L, S, Hk, M, 128)
    ks = torch.rand(L, S, Hk, M, generator=gen, device="cuda") * 0.02
    vs = torch.rand(L, S, Hk, M, generator=gen, device="cuda") * 0.02
    q = _randn(gen, S, 1, 28, 128)
    lens, band = _ints(200, 0), (_ints(250, 10), _ints(255, 5))  # stream 1: empty band
    vs[1, 1] = float("nan")
    got = dec.decode_attention(q, kc[1], vc[1], lens, band, k_scale=ks[1], v_scale=vs[1])
    want = dec.decode_attention_ref(q[:1], kc[1, :1], vc[1, :1], lens[:1],
                                    (band[0][:1], band[1][:1]), ks[1, :1], vs[1, :1])
    _assert_close(got[:1], want)
    assert (got[1] == 0).all()


@pytest.mark.parametrize("R", [1, 3, 731])
@pytest.mark.parametrize("I", [18944, 64])
def test_silu_mul_quant_matches_plain(gen, R, I):
    g, u = _randn(gen, R, I, scale=2.0), _randn(gen, R, I)
    before = aq.counts["kernel"]
    q, s = aq.silu_mul_quant(g, u)
    assert aq.counts["kernel"] == before + 1
    q_ref, s_ref = aq.silu_mul_quant_ref(g, u)
    assert q.dtype == torch.int8 and q.shape == (R, I) and s.shape == (R, 1)
    torch.testing.assert_close(s, s_ref, rtol=1e-6, atol=0)
    diff = (q.int() - q_ref.int()).abs()
    assert diff.max().item() <= 1
    assert (diff > 0).float().mean().item() <= 1e-3


def test_silu_mul_quant_zero_rows_and_fused_halves(gen):
    """A row of zeros gives scale 1e-8 / 127 and q = 0; g and u may be the two
    halves of one fused [.., 2 I] tensor (strided rows), with leading dims."""
    I = 256
    gu = _randn(gen, 2, 5, 2 * I)
    gu[1, 2] = 0
    g, u = gu.split(I, dim=-1)
    q, s = aq.silu_mul_quant(g, u)
    q_ref, s_ref = aq.silu_mul_quant_ref(g, u)
    assert q.shape == (2, 5, I) and s.shape == (2, 5, 1)
    assert (q[1, 2] == 0).all() and s[1, 2].item() == pytest.approx(1e-8 / 127, rel=1e-6)
    torch.testing.assert_close(s, s_ref, rtol=1e-6, atol=0)
    assert (q.int() - q_ref.int()).abs().max().item() <= 1


@pytest.mark.parametrize("cluster", [0, 16])
@pytest.mark.parametrize("R", [1, 2, 131, 133, 4902])
def test_silu_mul_quant_both_launch_shapes(gen, R, cluster, monkeypatch):
    """The many-row path (persistent CTAs, the next row in flight) and the
    cluster path (a row over 16 CTAs) at the MLP's width, each at every row
    count, on the two halves of one fused gate_up output (row stride 2 I)
    with two leading dims."""
    monkeypatch.setattr(aq, "CLUSTER_MAX_ROWS", 10**6 if cluster else 0)
    monkeypatch.setattr(aq, "CLUSTER_SIZE", cluster or aq.CLUSTER_SIZE)
    I = 18944
    lead = (2, R // 2) if R % 2 == 0 else (1, R)
    gu = _randn(gen, *lead, 2 * I, scale=2.0)
    g, u = gu.split(I, dim=-1)
    q, s = aq.silu_mul_quant(g, u)
    q_ref, s_ref = aq.silu_mul_quant_ref(g, u)
    assert q.shape == (*lead, I) and s.shape == (*lead, 1)
    torch.testing.assert_close(s, s_ref, rtol=1e-6, atol=0)
    diff = (q.int() - q_ref.int()).abs()
    assert diff.max().item() <= 1
    assert (diff > 0).float().mean().item() <= 1e-3


@pytest.mark.parametrize("cluster", [2, 4, 8])
@pytest.mark.parametrize("R", [1, 3])
def test_silu_mul_quant_cluster_sizes(gen, R, cluster, monkeypatch):
    """Every cluster size the kernel takes gives the same q and scales as the
    many-row path (the row's slices differ, the arithmetic does not)."""
    I = 18944
    gu = _randn(gen, R, 2 * I, scale=2.0)
    g, u = gu.split(I, dim=-1)
    monkeypatch.setattr(aq, "CLUSTER_SIZE", cluster)
    q, s = aq.silu_mul_quant(g, u)
    monkeypatch.setattr(aq, "CLUSTER_MAX_ROWS", 0)
    q0, s0 = aq.silu_mul_quant(g, u)
    assert torch.equal(q, q0) and torch.equal(s, s0)


def _w4_inputs(gen, m, K, N, G):
    wq = _int8(gen, N, K, lo=-8, hi=8)
    wp = w4.pack_int4(wq)
    ws = torch.rand((G, N) if G else (N,), generator=gen, device="cuda") * 0.01 + 0.001
    return wq, wp, ws


W4_SHAPES = [
    # (m, K, N, G)
    (1, 3584, 4608, 0), (3, 3584, 4608, 7), (4, 18944, 3584, 37), (2, 1024, 512, 0),
    (5, 3584, 512, 0), (731, 3584, 4608, 0), (731, 3584, 4608, 7), (200, 18944, 3584, 37),
    (130, 1024, 136, 2), (64, 128, 8, 2), (3, 192, 24, 3), (70, 192, 136, 3), (131, 320, 264, 0),
]
# (K, N) of the LLM's four quantized projections: qkv fused, o, gate_up fused, down
W4_PROJECTIONS = [(3584, 4608), (3584, 3584), (3584, 37888), (18944, 3584)]


@pytest.mark.parametrize("shape", W4_SHAPES)
def test_w4a8_matmul_equals_plain(gen, shape):
    m, K, N, G = shape
    _, wp, ws = _w4_inputs(gen, m, K, N, G)
    x = _int8(gen, m, K)
    xs = torch.rand(m, 1, generator=gen, device="cuda") * 0.05 + 0.001
    before = w4.counts["kernel"]
    got = w4.w4_matmul(x, xs, wp, ws)
    assert w4.counts["kernel"] == before + 1
    want = w4.w4_matmul_ref(x, xs, wp, ws)
    assert got.dtype == torch.bfloat16 and got.shape == (m, N)
    assert torch.equal(got, want), (got.float() - want.float()).abs().max().item()


@pytest.mark.parametrize("group", [0, 512])
@pytest.mark.parametrize("kn", W4_PROJECTIONS)
@pytest.mark.parametrize("m", [5, 64, 65, 731, 4902])
def test_w4a8_gemm_equals_plain_at_the_projection_shapes(gen, m, kn, group):
    """The int8-x GEMM (m > 4) at the prefill's shapes, per channel and with
    groups of 512 in-rows: equal to the plain version bit for bit."""
    K, N = kn
    _, wp, ws = _w4_inputs(gen, m, K, N, K // group if group else 0)
    x = _int8(gen, m, K)
    xs = torch.rand(m, 1, generator=gen, device="cuda") * 0.05 + 0.001
    got = w4.w4_matmul(x, xs, wp, ws)
    want = w4.w4_matmul_ref(x, xs, wp, ws)
    assert torch.equal(got, want), (got.float() - want.float()).abs().max().item()


@pytest.mark.parametrize("shape", W4_SHAPES)
def test_w4_matmul_bf16_x_matches_plain(gen, shape):
    m, K, N, G = shape
    _, wp, ws = _w4_inputs(gen, m, K, N, G)
    x = _randn(gen, m, K)
    got = w4.w4_matmul(x, None, wp, ws).float()
    want = w4.w4_matmul_ref(x, None, wp, ws).float()
    bound = 2.0**-7 * want.abs() + 1e-3 * K**0.5 * 8 * x.float().abs().max() * ws.max() / 16
    assert ((got - want).abs() <= bound).all(), ((got - want).abs() / bound).max().item()


@pytest.mark.parametrize("group", [0, 512])
@pytest.mark.parametrize("kn", W4_PROJECTIONS)
@pytest.mark.parametrize("m", [5, 17, 255, 257, 731, 4902])
def test_w4_bf16_gemm_matches_plain_at_the_projection_shapes(gen, m, kn, group):
    """The bf16-x GEMM (weight-only w4, m > 4) at the prefill's shapes, per
    channel and with groups of 512 in-rows: x tiles of 64, 128 and 256 rows,
    cut at the edge (255, 257, 731, 4902) and a text prefill's few rows."""
    K, N = kn
    _, wp, ws = _w4_inputs(gen, m, K, N, K // group if group else 0)
    x = _randn(gen, m, K)
    before = w4.counts["kernel"]
    got = w4.w4_matmul(x, None, wp, ws).float()
    assert w4.counts["kernel"] == before + 1
    want = w4.w4_matmul_ref(x, None, wp, ws).float()
    bound = 2.0**-7 * want.abs() + 1e-3 * K**0.5 * 8 * x.float().abs().max() * ws.max() / 16
    assert ((got - want).abs() <= bound).all(), ((got - want).abs() / bound).max().item()


def _w4_gemv_x(gen, m, K, int8x):
    if int8x:
        return _int8(gen, m, K), torch.rand(m, 1, generator=gen, device="cuda") * 0.05 + 0.001
    return _randn(gen, m, K), None


def _assert_w4_matches_plain(got, want, x, xs, ws, K):
    if xs is not None:  # int8 x: bit for bit
        assert torch.equal(got, want), (got.float() - want.float()).abs().max().item()
        return
    got, want = got.float(), want.float()
    bound = 2.0**-7 * want.abs() + 1e-3 * K**0.5 * 8 * x.float().abs().max() * ws.max() / 16
    assert ((got - want).abs() <= bound).all(), ((got - want).abs() / bound).max().item()


@pytest.mark.parametrize("int8x", [True, False], ids=["int8_x", "bf16_x"])
@pytest.mark.parametrize("group", [0, 512])
@pytest.mark.parametrize("kn", W4_PROJECTIONS)
@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_w4_gemv_matches_plain_at_the_projection_shapes(gen, m, kn, group, int8x):
    """The GEMV (m <= 4) at the decode step's shapes, per channel and with
    groups of 512 in-rows: int8 x equal to the plain version, bf16 x within
    the reordering bound; three calls bit-equal, each counted once."""
    K, N = kn
    _, wp, ws = _w4_inputs(gen, m, K, N, K // group if group else 0)
    x, xs = _w4_gemv_x(gen, m, K, int8x)
    before = w4.counts["kernel"]
    outs = [w4.w4_matmul(x, xs, wp, ws) for _ in range(3)]
    assert w4.counts["kernel"] == before + 3
    assert outs[0].dtype == torch.bfloat16 and outs[0].shape == (m, N)
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    _assert_w4_matches_plain(outs[0], w4.w4_matmul_ref(x, xs, wp, ws), x, xs, ws, K)


@pytest.mark.parametrize("int8x", [True, False], ids=["int8_x", "bf16_x"])
@pytest.mark.parametrize("shape", [(1, 3584, 37888, 0), (4, 18944, 3584, 37), (3, 3584, 4608, 7)])
def test_w4_gemv_replays_in_a_cuda_graph(gen, shape, int8x):
    """Captured in a CUDA graph, the GEMV replays bit-equal to eager calls on
    the x copied in before each of three replays: its arrival counters are
    back at zero after every launch, and its workspace is the graph's."""
    m, K, N, G = shape
    _, wp, ws = _w4_inputs(gen, m, K, N, G)
    x, xs = _w4_gemv_x(gen, m, K, int8x)
    w4.w4_matmul(x, xs, wp, ws)  # the counters exist before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = w4.w4_matmul(x, xs, wp, ws)
    for _ in range(3):
        new_x, new_xs = _w4_gemv_x(gen, m, K, int8x)
        x.copy_(new_x)
        if xs is not None:
            xs.copy_(new_xs)
        graph.replay()
        torch.cuda.synchronize()
        want = w4.w4_matmul(new_x, new_xs, wp, ws)
        assert torch.equal(y, want)
        _assert_w4_matches_plain(y, w4.w4_matmul_ref(new_x, new_xs, wp, ws), new_x, new_xs, ws, K)


def test_w4_matmul_leading_dims_and_unpack(gen):
    wq, wp, ws = _w4_inputs(gen, 6, 128, 16, 0)
    assert torch.equal(w4.unpack_int4(wp), wq)
    x = _int8(gen, 2, 3, 128)
    xs = torch.rand(2, 3, 1, generator=gen, device="cuda") * 0.05
    got = w4.w4_matmul(x, xs, wp, ws)
    assert got.shape == (2, 3, 16)
    assert torch.equal(got, w4.w4_matmul_ref(x, xs, wp, ws))


def test_quantized_wrappers_refuse_what_the_kernels_do_not_take(gen):
    _, wp, ws = _w4_inputs(gen, 1, 96, 16, 0)
    x = _int8(gen, 2, 96)
    xs = torch.ones(2, 1, device="cuda")
    with pytest.raises(ValueError, match="multiple of 64"):
        w4.w4_matmul(x, xs, wp, ws)
    _, wp, ws = _w4_inputs(gen, 1, 128, 16, 0)
    with pytest.raises(TypeError, match="int8 .* or bfloat16"):
        w4.w4_matmul(torch.zeros(2, 128, device="cuda"), None, wp, ws)
    with pytest.raises(ValueError, match="x_scale"):
        w4.w4_matmul(_int8(gen, 2, 128), None, wp, ws)
    with pytest.raises(TypeError, match="bfloat16"):
        aq.silu_mul_quant(torch.zeros(2, 64, device="cuda"), torch.zeros(2, 64, device="cuda"))
    q = _randn(gen, 1, 1, 28, 128)
    kv = _int8(gen, 1, 4, 32, 128)
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        dec.decode_attention(q, kv, kv, _ints(3), (3, 3))
    sc = torch.ones(1, 4, 32, device="cuda")
    with pytest.raises(ValueError, match=r"scales must be \[S, Hk, M\]"):
        dec.decode_attention(q, kv, kv, _ints(3), (3, 3), k_scale=sc[:, :, ::2], v_scale=sc)
    with pytest.raises(ValueError, match="k_scale must be .* contiguous|k_scale must be"):
        dec.decode_attention(q, kv, kv, _ints(3), (3, 3),
                             k_scale=torch.ones(1, 4, 64, device="cuda")[:, :, ::2], v_scale=sc)


# ---------------------------------------------------------------------------
# K5: packed training attention (forward, dq, dk/dv)
# ---------------------------------------------------------------------------

TRAIN_LAYOUTS = [
    # (sample_lens, split_lens, modes, trailing pad tokens): span edges fall inside 64-row tiles
    ([384, 384], [128, 128, 128, 64, 192, 128],
     ["causal", "full", "noise", "causal", "noise", "full"], 0),
    ([150, 111], [60, 90, 111], ["causal", "noise", "causal"], 0),  # T = 261, not a tile multiple
    ([1024], [1024], ["causal"], 0),
    ([500, 300], [100, 400, 50, 250], ["causal", "noise", "causal", "full"], 200),
    ([70], [30, 40], ["causal", "full"], 0),
]


def _train_case(gen, layout, H=28, Hk=4):
    import numpy as np

    sample_lens, split_lens, modes, pad = layout
    doc, fn, nz = packed_segment_ids(sample_lens, split_lens, modes)
    doc = np.concatenate([doc, np.zeros(pad, np.int32)])  # pad tokens: document 0, causal
    fn, nz = (np.concatenate([a, np.full(pad, -1, np.int32)]) for a in (fn, nz))
    T = len(doc)
    q, k, v = (_randn(gen, T, h, 128).requires_grad_(True) for h in (H, Hk, Hk))
    cot = _randn(gen, T, H, 128).float()
    return (q, k, v), [torch.from_numpy(a).cuda() for a in (doc, fn, nz)], cot


def _run(fn, qkv, ids, cot):
    for t in qkv:
        t.grad = None
    out = fn(*qkv, *ids)
    out.backward(cot)
    return [out.detach()] + [t.grad.clone() for t in qkv]


def _assert_grad_close(got, want, name, floor=None):
    got, want = got.float(), want.float()
    m = want.abs().amax(dim=-1, keepdim=True)
    tol = 2.0**-7 * (m + want.abs()) + (2.0**-4 * m.mean() if floor is None else floor)
    worst = ((got - want).abs() / tol).max().item()
    assert worst <= 1.0, (name, worst)


@pytest.mark.parametrize("layout", TRAIN_LAYOUTS)
@pytest.mark.parametrize("heads", [(28, 4), (4, 4)])
def test_packed_train_attention_matches_plain(gen, layout, heads):
    qkv, ids, cot = _train_case(gen, layout, *heads)
    before = dict(fat.counts)
    got = _run(fat.packed_train_attention, qkv, ids, cot)
    assert [fat.counts[k] - before[k] for k in ("fwd", "bwd_dq", "bwd_dkv", "plain")] == \
        [1, 1, 1, 0]
    want = _run(fat.packed_train_attention_ref, qkv, ids, cot)
    assert all(torch.isfinite(t).all() for t in got)
    _assert_close(got[0], want[0])
    spread = (cot * want[0].float()).square().sum(dim=-1, keepdim=True).sqrt()
    dq_floor = 6.0 * 128**-0.5 * 2.0**-9 * spread * qkv[1].detach().abs().max().float()
    for g, w, name, floor in zip(got[1:], want[1:], ("dq", "dk", "dv"), (dq_floor, None, None)):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        _assert_grad_close(g, w, name, floor)


def test_packed_train_attention_repeats_are_bit_equal(gen):
    qkv, ids, cot = _train_case(gen, TRAIN_LAYOUTS[3])
    a = _run(fat.packed_train_attention, qkv, ids, cot)
    b = _run(fat.packed_train_attention, qkv, ids, cot)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_packed_train_attention_layouts_and_partial_grads(gen):
    """q, k, v as column slices of one fused projection (read through the row
    stride), a non-contiguous cotangent, and gradients asked of q alone."""
    (q, k, v), ids, cot = _train_case(gen, TRAIN_LAYOUTS[1])
    T = q.shape[0]
    fused = torch.cat([q.detach().reshape(T, -1), k.detach().reshape(T, -1),
                       v.detach().reshape(T, -1)], dim=1)
    qs, ks, vs = (t.reshape(T, -1, 128) for t in fused.split([28 * 128, 4 * 128, 4 * 128], dim=1))
    assert not qs.is_contiguous()
    want = fat.packed_train_attention(q.detach(), k.detach(), v.detach(), *ids)
    assert torch.equal(fat.packed_train_attention(qs, ks, vs, *ids), want)
    ref = _run(fat.packed_train_attention, (q, k, v), ids, cot)
    cot_t = cot.transpose(0, 1).contiguous().transpose(0, 1)  # same values, other strides
    assert torch.equal(_run(fat.packed_train_attention, (q, k, v), ids, cot_t)[1], ref[1])
    before = dict(fat.counts)
    q2 = q.detach().requires_grad_(True)
    fat.packed_train_attention(q2, k.detach(), v.detach(), *ids).backward(cot)
    assert torch.equal(q2.grad, ref[1])
    assert fat.counts["bwd_dq"] == before["bwd_dq"] + 1
    assert fat.counts["bwd_dkv"] == before["bwd_dkv"]


def test_packed_train_attention_under_checkpoint(gen):
    """Non-reentrant checkpointing runs the forward kernel twice and gives
    the same gradients."""
    from torch.utils.checkpoint import checkpoint

    qkv, ids, cot = _train_case(gen, TRAIN_LAYOUTS[0])
    ref = _run(fat.packed_train_attention, qkv, ids, cot)
    before = dict(fat.counts)
    got = _run(lambda *a: checkpoint(fat.packed_train_attention, *a, use_reentrant=False),
               qkv, ids, cot)
    assert fat.counts["fwd"] == before["fwd"] + 2 and fat.counts["bwd_dq"] == before["bwd_dq"] + 1
    for x, y in zip(got, ref):
        assert torch.equal(x, y)


def test_packed_train_attention_refuses_what_the_kernels_do_not_take(gen):
    (q, k, v), ids, _ = _train_case(gen, TRAIN_LAYOUTS[4])
    with pytest.raises(TypeError, match="bfloat16"):
        fat.packed_train_attention(q.float(), k.float(), v.float(), *ids)
    with pytest.raises(ValueError, match="head dim"):
        fat.packed_train_attention(q[..., :64], k[..., :64], v[..., :64], *ids)
    with pytest.raises(ValueError, match="doc_id"):
        fat.packed_train_attention(q, k, v, ids[0][:-1], ids[1], ids[2])
    with pytest.raises(ValueError, match="multiple"):
        fat.packed_train_attention(q[:, :27], k, v, *ids)


# The backward's plan, off-grid lengths, head layouts, strides and NaN past T

def _ids_of(layout, T=None):
    """Segment ids on the card: a packed layout, padded with causal document-0
    tokens to T."""
    import numpy as np

    doc, fn, nz = packed_segment_ids(*layout)
    pad = 0 if T is None else T - len(doc)
    doc = np.concatenate([doc, np.zeros(pad, np.int32)])
    fn, nz = (np.concatenate([a, np.full(pad, -1, np.int32)]) for a in (fn, nz))
    return [torch.from_numpy(a).cuda() for a in (doc, fn, nz)]


def _every_pair_partial(T):
    """Tokens alternate between two documents that are each one full span:
    every (64, 64) tile pair holds allowed and forbidden pairs."""
    par = torch.arange(T, dtype=torch.int32, device="cuda") % 2
    return [par, par.clone(), torch.full_like(par, -1)]


PLAN_CASES = {
    "T 1": lambda: _ids_of(([1], [1], ["causal"])),
    "T 63": lambda: _ids_of(([63], [20, 43], ["causal", "noise"])),
    "T 65": lambda: _ids_of(([65], [65], ["causal"])),
    "T 127": lambda: _ids_of(([100], [40, 60], ["causal", "full"]), 127),
    "T 129": lambda: _ids_of(([129], [70, 59], ["causal", "noise"])),
    "T 4097": lambda: _ids_of(([3000, 1000], [56, 1296, 1024, 624, 1000],
                               ["causal", "full", "noise", "causal", "full"]), 4097),
    "every pair partial": lambda: _every_pair_partial(300),
}


def _held_to_plain(got, want, qkv, cot):
    """The tolerances above; dk's floor also covers the dsum term as dq's does
    (it reaches dk as scale * ds^T q): where every pair of a key is a
    one-key softmax (T 1) the plain dk is exactly 0, the kernels' is that term."""
    assert all(torch.isfinite(t).all() for t in got)
    _assert_close(got[0], want[0])
    spread = (cot.float() * want[0].float()).square().sum(dim=-1, keepdim=True).sqrt()
    dsum_term = 6.0 * 128**-0.5 * 2.0**-9 * spread
    dq_floor = dsum_term * qkv[1].detach().abs().max().float()
    m = want[2].float().abs().amax(dim=-1, keepdim=True)
    dk_floor = 2.0**-4 * m.mean() + dsum_term.max() * qkv[0].detach().abs().max().float()
    for g, w, name, floor in zip(got[1:], want[1:], ("dq", "dk", "dv"),
                                 (dq_floor, dk_floor, None)):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        _assert_grad_close(g, w, name, floor)


def _qkv(gen, T, H, Hk):
    q, k, v = (_randn(gen, T, h, 128).requires_grad_(True) for h in (H, Hk, Hk))
    return (q, k, v), _randn(gen, T, H, 128).float()


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_packed_train_attention_plan_matches_its_twin(gen, case):
    ids = PLAN_CASES[case]()
    T, H = ids[0].shape[0], 28
    do, out = _randn(gen, T, H, 128), _randn(gen, T, H, 128)
    lse = torch.randn(H, T, generator=gen, device="cuda")
    lse[0, 0] = -3.402823466e38  # a row that saw nothing: +inf in log2 units
    plan = fat._launch_plan(*ids)
    want = fat.tile_plan(*ids)
    assert torch.equal(plan.dq_order, fat.query_tile_order(want[1]))
    for got_list, got_count, want_list, want_count in (
            (plan.dq_list, plan.dq_count, want[0], want[1]),
            (plan.dkv_list, plan.dkv_count, want[2], want[3])):
        assert torch.equal(got_count, want_count)
        for x in range(got_count.shape[0]):
            n = int(want_count[x])
            assert torch.equal(got_list[x, :n], want_list[x, :n]), (case, x)
    t_pad = plan.ids4.shape[0]
    assert t_pad == want[1].shape[0] * 128
    assert torch.equal(plan.ids4[:T, :3], torch.stack(ids, dim=1))
    assert (plan.ids4[T:] == 0).all() and (plan.ids4[:, 3] == 0).all()
    lse2, dsum = fat._launch_rows(do, out, lse)
    assert lse2.shape == dsum.shape == (H, t_pad)
    want_dsum = (do.float() * out.float()).sum(dim=-1).t()
    torch.testing.assert_close(dsum[:, :T], want_dsum, rtol=1e-5, atol=1e-4)
    want_lse2 = lse * 1.4426950408889634
    want_lse2[0, 0] = torch.inf
    torch.testing.assert_close(lse2[:, :T], want_lse2, rtol=1e-6, atol=1e-6)
    assert (dsum[:, T:] == 0).all() and (lse2[:, T:] == 0).all()


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_packed_train_attention_forward_matches_plain_and_its_twin(gen, case):
    """The forward alone at T 1, 63, 65, 127, 129, 4097 and with every pair
    partial: out within the attention tolerance of the plain version, lse
    within 1e-3 of the tiled twin's, and the plan it saves for the backward
    equal to the twin's lists."""
    ids = PLAN_CASES[case]()
    (q, k, v), _ = _qkv(gen, ids[0].shape[0], 28, 4)
    q, k, v = q.detach(), k.detach(), v.detach()
    before = dict(fat.counts)
    out, lse, plan = fat._launch_fwd(q, k, v, *ids)
    assert fat.counts["fwd"] == before["fwd"] + 1
    _assert_close(out, fat.packed_train_attention_ref(q, k, v, *ids))
    twin_out, twin_lse = fat.packed_train_attention_fwd_tiled_ref(q, k, v, *ids)
    _assert_close(out, twin_out)
    assert (lse - twin_lse).abs().max().item() <= 1e-3
    want = fat.tile_plan(*ids)
    for x in range(want[1].shape[0]):
        n = int(want[1][x])
        assert torch.equal(plan.dq_list[x, :n], want[0][x, :n]), (case, x)
    assert torch.equal(plan.dq_count, want[1])


def test_packed_train_attention_backward_reads_the_forwards_plan(gen):
    """The autograd function saves the forward's plan; the backward over it
    gives the bits of a backward over a plan built anew, and the saved lists
    are the twin's."""
    (q, k, v), ids, cot = _train_case(gen, TRAIN_LAYOUTS[0])
    out = fat.packed_train_attention(q, k, v, *ids)
    saved = fat.Plan(*out.grad_fn.saved_tensors[5:])
    want = fat.tile_plan(*ids)
    assert torch.equal(saved.dq_count, want[1]) and torch.equal(saved.dkv_count, want[3])
    for x in range(want[1].shape[0]):
        assert torch.equal(saved.dq_list[x, :int(want[1][x])], want[0][x, :int(want[1][x])])
        assert torch.equal(saved.dkv_list[x, :int(want[3][x])], want[2][x, :int(want[3][x])])
    grads = torch.autograd.grad(out, (q, k, v), cot)
    o, lse, _ = fat._launch_fwd(q.detach(), k.detach(), v.detach(), *ids)
    assert torch.equal(o, out.detach())
    fresh = fat._launch_bwd(q.detach(), k.detach(), v.detach(), o, lse, fat._launch_plan(*ids),
                            cot, True, True)
    for x, y in zip(fresh, grads):
        assert torch.equal(x, y)


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_packed_train_attention_backward_on_awkward_layouts(gen, case):
    ids = PLAN_CASES[case]()
    qkv, cot = _qkv(gen, ids[0].shape[0], 28, 4)
    before = dict(fat.counts)
    got = _run(fat.packed_train_attention, qkv, ids, cot)
    assert [fat.counts[k] - before[k] for k in ("fwd", "bwd_dq", "bwd_dkv", "plain")] == \
        [1, 1, 1, 0]
    _held_to_plain(got, _run(fat.packed_train_attention_ref, qkv, ids, cot), qkv, cot)


@pytest.mark.parametrize("heads", [(28, 28), (28, 1)])
def test_packed_train_attention_backward_head_layouts(gen, heads):
    """H = Hk (one head per split) and one KV head for 28 query heads (28
    partials per key in the combine)."""
    ids = _ids_of(TRAIN_LAYOUTS[3][:3], 1000)
    qkv, cot = _qkv(gen, 1000, *heads)
    got = _run(fat.packed_train_attention, qkv, ids, cot)
    _held_to_plain(got, _run(fat.packed_train_attention_ref, qkv, ids, cot), qkv, cot)


def test_packed_train_attention_backward_reads_strided_views_and_ignores_rows_past_t(gen):
    """q, k, v as column slices of one fused projection, and q, k, v and the
    cotangent as the first T rows of parents whose further rows are NaN: the
    backward reads them in place through its tensor maps and gives the bits of
    the contiguous case."""
    (q, k, v), ids, cot = _train_case(gen, TRAIN_LAYOUTS[3])
    T = q.shape[0]
    ref = _run(fat.packed_train_attention, (q, k, v), ids, cot)
    fused = torch.cat([q.detach().reshape(T, -1), k.detach().reshape(T, -1),
                       v.detach().reshape(T, -1)], dim=1)
    views = [t.reshape(T, -1, 128).requires_grad_(True)
             for t in fused.split([28 * 128, 4 * 128, 4 * 128], dim=1)]
    got = _run(fat.packed_train_attention, views, ids, cot)
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
    parents = [torch.full((T + 70, h, 128), float("nan"), dtype=torch.bfloat16, device="cuda")
               for h in (28, 4, 4, 28)]
    for p, t in zip(parents, (q, k, v, cot)):
        p[:T] = t.detach()
    leaves = [p[:T].requires_grad_(True) for p in parents[:3]]
    got = _run(fat.packed_train_attention, leaves, ids, parents[3][:T])
    for x, y in zip(got, ref):
        assert torch.equal(x, y)


def test_packed_train_attention_dkv_alone(gen):
    """Gradients asked of k and v alone: one dk/dv launch, no dq launch, the
    bits of the full backward."""
    (q, k, v), ids, cot = _train_case(gen, TRAIN_LAYOUTS[1])
    ref = _run(fat.packed_train_attention, (q, k, v), ids, cot)
    k2, v2 = k.detach().requires_grad_(True), v.detach().requires_grad_(True)
    before = dict(fat.counts)
    fat.packed_train_attention(q.detach(), k2, v2, *ids).backward(cot)
    assert fat.counts["bwd_dkv"] == before["bwd_dkv"] + 1
    assert fat.counts["bwd_dq"] == before["bwd_dq"]
    assert torch.equal(k2.grad, ref[2]) and torch.equal(v2.grad, ref[3])


def test_kernels_without_a_backward_refuse_inputs_that_require_grad(gen):
    q = _randn(gen, 1, 64, 4, 128).requires_grad_(True)
    kc, vc = _randn(gen, 1, 4, 128, 128), _randn(gen, 1, 4, 128, 128)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        fa.flash_block_attention(q, kc, vc, _ints(0), _ints(0), True, kv_head_major=True)
    with torch.no_grad():
        fa.flash_block_attention(q, kc, vc, _ints(0), _ints(0), True, kv_head_major=True)
    qd = _randn(gen, 1, 1, 4, 128).requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        dec.decode_attention(qd, kc, vc, _ints(10), (_ints(10), _ints(12)))
    dec.decode_attention(qd.detach(), kc, vc, _ints(10), (_ints(10), _ints(12)))
