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
apply the same rounded fp32 multiplies and adds in one order), on every route
``k4_route`` picks: the GEMV, the int8 GEMM, and the simple kernel that takes
the shapes the tensor cores do not (groups of 16 or 8, K 96, N 12); the GEMV
at groups of 32 adds its groups' fp32 terms in another association and equals
its twin ``w4_gemv_tiled_ref`` bit for bit instead (the twin is held to the
plain version on the CPU). With bf16 x the fp32 sums run in another order:
|err| <= 2^-7 |plain| + 1e-3 * sqrt(K) * 8 * max|x| * max(w_scale) / 16 per
element (a loose bound on the reordering error, well under one output
rounding). K4's GEMV (m <= 4) combines its slice sums in a fixed order:
repeats, and replays of a CUDA graph that captured it, are bit-equal to eager
calls. K3 (silu * mul * quant): scales within 1e-6
relative, q within one step, at most 1e-3 of the elements differing (expf
against torch.sigmoid in the last place). K2-int8 takes the attention
tolerance above, also over an int4 cache layer unpacked to int8 (the
decode route of ``KVCache(kv_bits=4)``), whose unpack on the card must equal
the CPU's for every byte.

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
    # the speculative verify block: 8 causal rows after the context; a
    # finished stream (no valid row) and a window that runs past M
    (8, 1024, 28, 4, 128, (800,), (800,), (8,), True, True),
    (8, 64, 28, 4, 128, (40, 20, 57, 0), (40, 20, 57, 0), (8, 0, 8, 8), True, True),
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


SERVE_LENS = tuple([5141 + 3 * i for i in range(4)] + [1063 + 5 * i for i in range(4)]
                   + [746 + 4 * i for i in range(8)])
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
    # batched serving: a pool of 16 over 6144 columns, 980 / 378x532 / 378 px streams near
    # 5150 / 1070 / 750 columns, the aligned chunk's band at step 8, then (lens, lens)
    (6144, 28, 4, SERVE_LENS, (max(SERVE_LENS),) * 16, (max(SERVE_LENS) + 7,) * 16),
    (6144, 28, 4, SERVE_LENS, SERVE_LENS, SERVE_LENS),
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


def test_int4_unpack_on_the_card_equals_the_cpu(gen):
    """Every byte unpacks on the card as on the CPU (int8 shifts), and
    packing random int4 values gives them back."""
    from unimedvl_tpu_torch.models import qwen2_mot

    every = torch.arange(-128, 128, dtype=torch.int8)
    assert torch.equal(qwen2_mot.unpack_int4(every.cuda()).cpu(), qwen2_mot.unpack_int4(every))
    q = torch.randint(-7, 8, (3, 4, 300, 128), generator=gen, device="cuda", dtype=torch.int8)
    assert torch.equal(qwen2_mot.unpack_int4(qwen2_mot.pack_int4(q)), q)


@pytest.mark.parametrize("band", ["aligned", "lens"])
def test_decode_over_an_int4_cache_layer_takes_k2_int8(gen, band):
    """One layer of an int4 cache as the decode step reads it: unpacked to
    int8 (``_decode_kv``), then K2-int8 with the scales, against the plain
    version on the unpacked values."""
    from unimedvl_tpu_torch.models import qwen2_mot

    L, S, Hk, M = 2, 3, 4, 700
    q4 = torch.randint(-7, 8, (L, S, Hk, M, 128), generator=gen, device="cuda",
                       dtype=torch.int8)
    kp, vp = qwen2_mot.pack_int4(q4), qwen2_mot.pack_int4(q4.flip(-1))
    ks = torch.rand(L, S, Hk, M, generator=gen, device="cuda") * 0.3 + 0.02
    vs = torch.rand(L, S, Hk, M, generator=gen, device="cuda") * 0.3 + 0.02
    q = _randn(gen, S, 1, 28, 128, scale=2.0)
    lens = _ints(500, 37, 690)
    bands = (_ints(690, 690, 690), _ints(695, 695, 695)) if band == "aligned" else (lens, lens)
    k8, v8 = qwen2_mot._decode_kv(kp[1], vp[1], 4)
    before = dec.int8_counts["kernel"]
    got = dec.decode_attention(q, k8, v8, lens, bands, k_scale=ks[1], v_scale=vs[1])
    assert dec.int8_counts["kernel"] == before + 1
    _assert_close(got, dec.decode_attention_ref(q, k8, v8, lens, bands, ks[1], vs[1]))


@pytest.mark.parametrize("R", [1, 3, 8, 16, 731])  # 8, 16: a serving pool's decode step
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
    # groups of 32 (the GEMV's fold, the GEMMs' pieces), of 96 (pieces of three products; the
    # GEMV's slice of 96), K no multiple of 128
    (3, 3584, 4608, 112), (200, 18944, 3584, 592), (64, 192, 24, 6), (5, 320, 264, 10),
    (2, 192, 24, 2), (70, 192, 136, 2), (131, 576, 264, 6),
]
# the simple kernel's shapes: groups of 16, 8, 6, 2 in-rows; K no multiple of 64; N no multiple
# of 8; a single in-row pair
W4_SIMPLE_SHAPES = [
    (1, 3584, 4608, 224), (4, 3584, 4608, 448), (17, 3584, 4608, 224), (3, 96, 12, 0),
    (5, 96, 12, 6), (40, 96, 12, 3), (2, 128, 12, 0), (9, 320, 20, 20), (6, 6, 5, 3), (3, 2, 1, 0),
]
# (K, N) of the LLM's four quantized projections: qkv fused, o, gate_up fused, down
W4_PROJECTIONS = [(3584, 4608), (3584, 3584), (3584, 37888), (18944, 3584)]


def _w4_call(x, xs, wp, ws, route):
    """One call of the wrapper, checked to be one launch of ``route``."""
    before = dict(w4.route_counts), w4.counts["kernel"]
    got = w4.w4_matmul(x, xs, wp, ws)
    want = dict(before[0])
    want[route] += 1
    assert w4.route_counts == want and w4.counts["kernel"] == before[1] + 1
    return got


@pytest.mark.parametrize("shape", W4_SHAPES + W4_SIMPLE_SHAPES)
def test_w4a8_matmul_equals_plain(gen, shape):
    m, K, N, G = shape
    _, wp, ws = _w4_inputs(gen, m, K, N, G)
    x = _int8(gen, m, K)
    xs = torch.rand(m, 1, generator=gen, device="cuda") * 0.05 + 0.001
    got = _w4_call(x, xs, wp, ws, w4.k4_route(m, K, N, G, True))
    want = w4.w4_matmul_ref(x, xs, wp, ws)
    assert got.dtype == torch.bfloat16 and got.shape == (m, N)
    if w4.k4_route(m, K, N, G, True) == "gemv" and G and K // G == 32:  # the GEMV's fold
        want = w4.w4_gemv_tiled_ref(x.cpu(), xs.cpu(), wp.cpu(), ws.cpu(), n_sms=w4._n_sms(x.device))
        got = got.cpu()
    assert torch.equal(got, want), (got.float() - want.float()).abs().max().item()


@pytest.mark.parametrize("group", [0, 512, 32])
@pytest.mark.parametrize("kn", W4_PROJECTIONS)
@pytest.mark.parametrize("m", [5, 8, 16, 64, 65, 731, 4902])
def test_w4a8_gemm_equals_plain_at_the_projection_shapes(gen, m, kn, group):
    """The int8-x GEMM (m > 4) at the prefill's shapes and a serving pool's
    decode step (m 8, 16), per channel and with groups of 512 and 32 in-rows:
    equal to the plain version bit for bit."""
    K, N = kn
    _, wp, ws = _w4_inputs(gen, m, K, N, K // group if group else 0)
    x = _int8(gen, m, K)
    xs = torch.rand(m, 1, generator=gen, device="cuda") * 0.05 + 0.001
    got = _w4_call(x, xs, wp, ws, "gemm")
    want = w4.w4_matmul_ref(x, xs, wp, ws)
    assert torch.equal(got, want), (got.float() - want.float()).abs().max().item()


def _assert_bf16_x_bound(got, want, x, ws, K):
    got, want = got.float(), want.float()
    bound = 2.0**-7 * want.abs() + 1e-3 * K**0.5 * 8 * x.float().abs().max() * ws.max() / 16
    assert ((got - want).abs() <= bound).all(), ((got - want).abs() / bound).max().item()


@pytest.mark.parametrize("shape", W4_SHAPES + W4_SIMPLE_SHAPES)
def test_w4_matmul_bf16_x_matches_plain(gen, shape):
    m, K, N, G = shape
    _, wp, ws = _w4_inputs(gen, m, K, N, G)
    x = _randn(gen, m, K)
    got = _w4_call(x, None, wp, ws, w4.k4_route(m, K, N, G, False))
    _assert_bf16_x_bound(got, w4.w4_matmul_ref(x, None, wp, ws), x, ws, K)


@pytest.mark.parametrize("group", [0, 512, 32])
@pytest.mark.parametrize("kn", W4_PROJECTIONS)
@pytest.mark.parametrize("m", [5, 17, 255, 257, 731, 4902])
def test_w4_bf16_gemm_matches_plain_at_the_projection_shapes(gen, m, kn, group):
    """The bf16-x GEMM (weight-only w4, m > 4) at the prefill's shapes, per
    channel and with groups of 512 and 32 in-rows: x tiles of 64, 128 and 256
    rows, cut at the edge (255, 257, 731, 4902) and a text prefill's few
    rows."""
    K, N = kn
    _, wp, ws = _w4_inputs(gen, m, K, N, K // group if group else 0)
    x = _randn(gen, m, K)
    got = _w4_call(x, None, wp, ws, "bf16_gemm")
    _assert_bf16_x_bound(got, w4.w4_matmul_ref(x, None, wp, ws), x, ws, K)


def _w4_gemv_x(gen, m, K, int8x):
    if int8x:
        return _int8(gen, m, K), torch.rand(m, 1, generator=gen, device="cuda") * 0.05 + 0.001
    return _randn(gen, m, K), None


def _assert_w4_matches_plain(got, want, x, xs, ws, K):
    if xs is not None:  # int8 x: bit for bit
        assert torch.equal(got, want), (got.float() - want.float()).abs().max().item()
        return
    _assert_bf16_x_bound(got, want, x, ws, K)


def _w4_gemv_want(x, xs, wp, ws):
    """What the GEMV must equal: the plain version, or with int8 x at groups
    of 32 its twin (the fold's order), on the CPU."""
    K = 2 * wp.shape[1]
    if xs is not None and ws.dim() == 2 and K // ws.shape[0] == 32:
        return w4.w4_gemv_tiled_ref(x.cpu(), xs.cpu(), wp.cpu(), ws.cpu(),
                                    n_sms=w4._n_sms(x.device)).to(x.device)
    return w4.w4_matmul_ref(x, xs, wp, ws)


@pytest.mark.parametrize("int8x", [True, False], ids=["int8_x", "bf16_x"])
@pytest.mark.parametrize("group", [0, 512, 32])
@pytest.mark.parametrize("kn", W4_PROJECTIONS)
@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_w4_gemv_matches_plain_at_the_projection_shapes(gen, m, kn, group, int8x):
    """The GEMV (m <= 4) at the decode step's shapes, per channel and with
    groups of 512 and 32 in-rows: int8 x equal to the plain version (at
    groups of 32 to its twin ``w4_gemv_tiled_ref``), bf16 x within the
    reordering bound; three calls bit-equal, each counted once."""
    K, N = kn
    _, wp, ws = _w4_inputs(gen, m, K, N, K // group if group else 0)
    x, xs = _w4_gemv_x(gen, m, K, int8x)
    outs = [_w4_call(x, xs, wp, ws, "gemv") for _ in range(3)]
    assert outs[0].dtype == torch.bfloat16 and outs[0].shape == (m, N)
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    _assert_w4_matches_plain(outs[0], _w4_gemv_want(x, xs, wp, ws), x, xs, ws, K)


@pytest.mark.parametrize("int8x", [True, False], ids=["int8_x", "bf16_x"])
@pytest.mark.parametrize("shape", [(1, 3584, 37888, 0), (4, 18944, 3584, 37), (3, 3584, 4608, 7),
                                   (1, 3584, 37888, 112), (4, 18944, 3584, 592),
                                   (2, 3584, 4608, 112)])
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
        _assert_w4_matches_plain(y, _w4_gemv_want(new_x, new_xs, wp, ws), new_x, new_xs, ws, K)


@pytest.mark.parametrize("int8x", [True, False], ids=["int8_x", "bf16_x"])
@pytest.mark.parametrize("group", [16, 8])
@pytest.mark.parametrize("m", [1, 4, 17, 731])
def test_w4_simple_kernel_at_a_projection_shape(gen, m, group, int8x):
    """Groups of 16 and 8 in-rows fit no tensor-core product: the simple
    kernel takes them at the qkv projection's shape, at a decode step's rows,
    a text block's and a 378 px image prefill's; int8 x equal to the plain
    version, bf16 x within the reordering bound."""
    K, N = 3584, 4608
    _, wp, ws = _w4_inputs(gen, m, K, N, K // group)
    x, xs = _w4_gemv_x(gen, m, K, int8x)
    got = _w4_call(x, xs, wp, ws, "simple")
    _assert_w4_matches_plain(got, w4.w4_matmul_ref(x, xs, wp, ws), x, xs, ws, K)


def test_w4_matmul_leading_dims_and_unpack(gen):
    wq, wp, ws = _w4_inputs(gen, 6, 128, 16, 0)
    assert torch.equal(w4.unpack_int4(wp), wq)
    x = _int8(gen, 2, 3, 128)
    xs = torch.rand(2, 3, 1, generator=gen, device="cuda") * 0.05
    got = w4.w4_matmul(x, xs, wp, ws)
    assert got.shape == (2, 3, 16)
    assert torch.equal(got, w4.w4_matmul_ref(x, xs, wp, ws))


def test_quantized_wrappers_refuse_what_the_kernels_do_not_take(gen):
    # K 96 is no tensor-core shape: the simple kernel takes it, equal to the plain version
    _, wp, ws = _w4_inputs(gen, 1, 96, 16, 0)
    x = _int8(gen, 2, 96)
    xs = torch.ones(2, 1, device="cuda")
    got = _w4_call(x, xs, wp, ws, "simple")
    assert torch.equal(got, w4.w4_matmul_ref(x, xs, wp, ws))
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


# -- the differentiable routes of K3 and K4 (QLoRA) -------------------------------------------
# Each route's forward is the kernel and its backward torch; both are held to autograd of the
# plain version on the same inputs, each gradient as a whole by cosine >= 0.9999: with bf16 x,
# dx rounds dy * w_scale to bf16 before a bf16 product where the plain version's backward is
# fp32; with int8 x the scale's gradient takes y from the kernel's bf16 output.


def _cos(a, b):
    return torch.nn.functional.cosine_similarity(a.float().flatten(), b.float().flatten(), 0).item()


@pytest.mark.parametrize("group", [0, 512])
@pytest.mark.parametrize("kn", [(3584, 512), (18944, 3584)])
def test_w4_matmul_autograd_against_plain_autograd(gen, kn, group):
    K, N = kn
    m = 300
    q = torch.randint(-8, 8, (N, K), generator=gen, device="cuda", dtype=torch.int8)
    wp = w4.pack_int4(q)
    G = K // group if group else 1
    ws = (torch.rand(G, N, generator=gen, device="cuda") * 0.02 + 0.001).squeeze(0)
    x = _randn(gen, m, K)
    x[1, 5] = x[1, 9] = x[1].abs().max() * 2  # a tie in the int8 case's absmax
    dy = _randn(gen, m, N)
    grads = {}
    for name, route in (("kernel", w4.w4_matmul_autograd), ("plain", w4.w4_matmul_ref)):
        a = x.clone().requires_grad_(True)
        before = w4.counts["kernel"]
        y = route(a, None, wp, ws)
        y.backward(dy)
        xq, xs = aq.silu_mul_quant_ref(a.detach(), torch.ones_like(a.detach()))  # any int8 x
        s = xs.clone().requires_grad_(True)
        route(xq, s, wp, ws).backward(dy)
        if name == "kernel":
            assert w4.counts["kernel"] == before + 2 and y.grad_fn is not None
        grads[name] = (a.grad, s.grad)
    assert _cos(grads["kernel"][0], grads["plain"][0]) >= 0.9999
    assert _cos(grads["kernel"][1], grads["plain"][1]) >= 0.9999


@pytest.mark.parametrize("R", [3, 700])
def test_silu_mul_quant_autograd_against_plain_autograd(gen, R):
    g, u = _randn(gen, R, 18944, scale=2.0), _randn(gen, R, 18944)
    d_scale = torch.randn(R, 1, generator=gen, device="cuda")
    out = {}
    for name, route in (("kernel", aq.silu_mul_quant_autograd), ("plain", aq.silu_mul_quant_ref)):
        gg, uu = g.clone().requires_grad_(True), u.clone().requires_grad_(True)
        q, scale = route(gg, uu)
        scale.backward(d_scale)
        out[name] = (gg.grad, uu.grad, scale.detach())
    torch.testing.assert_close(out["kernel"][2], out["plain"][2], rtol=1e-6, atol=0)
    for i in range(2):
        assert _cos(out["kernel"][i], out["plain"][i]) >= 0.9999
        # one entry per row (a tie in bf16 products may make two)
        assert ((out["kernel"][i] != 0).sum(dim=1) <= 2).all()


def test_quantized_kernels_refuse_grad_outside_their_routes(gen):
    x = _randn(gen, 8, 1024).requires_grad_(True)
    wp = torch.zeros(512, 512, dtype=torch.int8, device="cuda")
    with pytest.raises(RuntimeError, match="w4_matmul_autograd"):
        w4.w4_matmul(x, None, wp, torch.ones(512, device="cuda"))
    with pytest.raises(RuntimeError, match="silu_mul_quant_autograd"):
        aq.silu_mul_quant(x, x)
    with torch.no_grad():
        w4.w4_matmul(x, None, wp, torch.ones(512, device="cuda"))
        aq.silu_mul_quant(x, x)


# ---------------------------------------------------------------------------
# tensor parallelism: K3's second entry and K4 at a rank's shard shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("R", [1, 3, 8, 9, 16, 128, 129, 731, 1026, 3078, 4902])
@pytest.mark.parametrize("I", [9472, 4736, 64])
def test_silu_mul_quant_global_matches_plain(gen, R, I):
    """K3's second entry (scale pass, reduction, quantize pass) at a down
    shard's widths (I 18944 / 2 and / 4) on the halves of one fused gate_up
    output, on the cluster route and the ring (the switch at R 128, 129):
    scales within 1e-6 relative and q within one step of its plain version;
    without a reduction it gives the first entry's q and scales."""
    gu = _randn(gen, R, 2 * I, scale=2.0)
    g, u = gu.split(I, dim=-1)
    before = aq.global_counts["kernel"]
    q, s = aq.silu_mul_quant_global(g, u, None)
    assert aq.global_counts["kernel"] == before + 1
    _assert_global_close(q, s, *aq.silu_mul_quant_global_ref(g, u, None))
    assert q.shape == (R, I) and s.shape == (R, 1)
    q1, s1 = aq.silu_mul_quant(g, u)
    assert torch.equal(q, q1) and torch.equal(s, s1)


def _assert_global_close(q, s, q_ref, s_ref):
    """K3's tolerance: scales within 1e-6 relative, q within one step on at
    most 1e-3 of the elements."""
    torch.testing.assert_close(s, s_ref, rtol=1e-6, atol=0)
    diff = (q.int() - q_ref.int()).abs()
    assert diff.max().item() <= 1 and (diff > 0).float().mean().item() <= 1e-3


def test_silu_mul_quant_global_takes_the_reduced_scales(gen):
    """The quantize pass takes the scales as the reduction leaves them: a
    reduction that doubles them halves q (to the rounding) against the plain
    version given the same reduction."""
    g, u = _randn(gen, 5, 9472, scale=2.0), _randn(gen, 5, 9472)

    def double(s):
        s.mul_(2.0)

    q, s = aq.silu_mul_quant_global(g, u, double)
    q_ref, s_ref = aq.silu_mul_quant_global_ref(g, u, double)
    torch.testing.assert_close(s, s_ref, rtol=1e-6, atol=0)
    assert (q.int() - q_ref.int()).abs().max().item() <= 1
    assert q.abs().max().item() <= 64


@pytest.mark.parametrize("R,I", [(3, 9472), (731, 9472), (4902, 9472), (3078, 4736)])
def test_silu_mul_quant_global_quantizes_each_row_by_its_own_scale(gen, R, I):
    """The quantize pass walks the rows backward on the ring: a reduction
    that scales row r by 1 + (r mod 7) / 4 holds every row to its own scale,
    against the plain version given the same reduction."""
    gu = _randn(gen, R, 2 * I, scale=2.0)
    g, u = gu.split(I, dim=-1)

    def per_row(s):
        s.mul_(1.0 + (torch.arange(R, device=s.device) % 7).view(R, 1) / 4.0)

    q, s = aq.silu_mul_quant_global(g, u, per_row)
    _assert_global_close(q, s, *aq.silu_mul_quant_global_ref(g, u, per_row))


@pytest.mark.parametrize("R", [0, 1, 8, 9, 128, 129, 731])
@pytest.mark.parametrize("I", [9472, 4736])
def test_silu_mul_quant_global_reduces_once_on_every_route(gen, R, I):
    """``reduce_max`` runs exactly once a call, on either route and with no
    rows, so that every rank of a mesh joins the same collectives."""
    gu = _randn(gen, R, 2 * I, scale=2.0)
    g, u = gu.split(I, dim=-1)
    calls = []
    q, s = aq.silu_mul_quant_global(g, u, calls.append)
    assert len(calls) == 1 and calls[0] is s and s.shape == (R, 1) and q.shape == (R, I)


def test_silu_mul_quant_global_past_the_old_grid_and_in_3d(gen):
    """R 70000 rows (past the 65535 CTAs of a grid's y) at I 64, and a 3-D
    input on strided halves, against the plain version."""
    gu = _randn(gen, 70000, 128, scale=2.0)
    g, u = gu.split(64, dim=-1)
    q, s = aq.silu_mul_quant_global(g, u, None)
    _assert_global_close(q, s, *aq.silu_mul_quant_global_ref(g, u, None))
    gu = _randn(gen, 3, 245, 2 * 4736, scale=2.0)
    g, u = gu.split(4736, dim=-1)
    q, s = aq.silu_mul_quant_global(g, u, None)
    assert q.shape == (3, 245, 4736) and s.shape == (3, 245, 1)
    _assert_global_close(q, s, *aq.silu_mul_quant_global_ref(g, u, None))


def test_silu_mul_quant_global_refuses_rows_past_its_width(gen):
    """A row wider than the kernels take raises, naming the cap; it never
    falls back to the plain version."""
    I = aq.KERNEL_MAX_WIDTH + 8
    g = _randn(gen, 2, I)
    before = dict(aq.global_counts)
    with pytest.raises(ValueError, match="KERNEL_MAX_WIDTH"):
        aq.silu_mul_quant_global(g, g, None)
    assert aq.global_counts == before


# (K, N) of a rank's projections at tp 2 and 4: qkv and gate_up column shards, o and down
# row shards (packed K / 2 bytes)
W4_SHARDS = [(3584, 2304), (3584, 1152), (3584, 18944), (3584, 9472), (1792, 3584),
             (896, 3584), (9472, 3584), (4736, 3584)]


@pytest.mark.parametrize("kn,group", [(kn, 0) for kn in W4_SHARDS]
                         + [(kn, 512) for kn in W4_SHARDS if kn[0] % 512 == 0])
@pytest.mark.parametrize("m", [1, 16, 4902])
def test_w4_matmul_at_the_shard_shapes(gen, m, kn, group):
    """K4 at a tensor-parallel rank's shapes, m 1 (GEMV), 16 and 4902
    (GEMM): int8 x equal to the plain version, bf16 x within the reordering
    bound. Groups of 512 only where a shard holds whole groups (the column
    shards; the row shards of o and down split a group of 512 and are
    refused by the placement)."""
    K, N = kn
    _, wp, ws = _w4_inputs(gen, m, K, N, K // group if group else 0)
    x = _int8(gen, m, K)
    xs = torch.rand(m, 1, generator=gen, device="cuda") * 0.05 + 0.001
    got = w4.w4_matmul(x, xs, wp, ws)
    assert torch.equal(got, w4.w4_matmul_ref(x, xs, wp, ws))
    xb = _randn(gen, m, K)
    got = w4.w4_matmul(xb, None, wp, ws).float()
    want = w4.w4_matmul_ref(xb, None, wp, ws).float()
    bound = 2.0**-7 * want.abs() + 1e-3 * K**0.5 * 8 * xb.float().abs().max() * ws.max() / 16
    assert ((got - want).abs() <= bound).all(), ((got - want).abs() / bound).max().item()


# ---------------------------------------------------------------------------
# The device programs (inference/programs.py): each captured program against
# its eager loop on the same inputs. A two-layer model of head dim 128 (K2,
# K1b), bf16, random weights; an int8 cache for the decode. Tokens and lens
# must be equal; latents within 1e-3 (the same kernels on the same inputs).
# ---------------------------------------------------------------------------

def _program_model():
    import dataclasses

    from unimedvl_tpu_torch.config import LLMConfig
    from unimedvl_tpu_torch.models import bagel
    from unimedvl_tpu_torch.scripts.toy_overfit import tiny_config

    cfg = dataclasses.replace(tiny_config(), llm=LLMConfig(
        vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
        num_attention_heads=2, num_key_value_heads=1, rope_theta=10000.0))
    model = bagel.Bagel(cfg, device="cuda", dtype=torch.bfloat16)
    bagel.init_random_(model, torch.Generator(device="cuda").manual_seed(0), llm2vae_zero=False)
    return model


def _program_context(model, S, M, lens, quantized=False, graphs=None):
    from unimedvl_tpu_torch.models import bagel
    from unimedvl_tpu_torch.models.qwen2_mot import KVCache

    llm = model.config.llm
    T = max(lens)
    ids = (torch.arange(S * T, device="cuda").reshape(S, T) * 7 + 3) % llm.vocab_size
    pos = torch.arange(T, device="cuda").expand(S, T).contiguous()
    valid = torch.arange(T, device="cuda")[None] < torch.tensor(lens, device="cuda")[:, None]
    cache = KVCache.create(llm.num_hidden_layers, S, M, llm.num_key_value_heads, llm.head_dim,
                           torch.bfloat16, device="cuda", quantized=quantized)
    return bagel.prefill_text(model, cache, ids, pos, valid, graphs=graphs)


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16_cache", "int8_cache"])
def test_decode_program_captured_equals_eager(gen, quantized):
    """generate_text as a captured graph against its eager loop: tokens,
    lengths and K2's launches equal, twice (the second call replays)."""
    from unimedvl_tpu_torch.models import bagel

    model = _program_model()
    cache = _program_context(model, 2, 512, [40, 23], quantized)
    start, pos = torch.tensor([5, 9], device="cuda"), torch.tensor([40, 23], device="cuda")
    counts = dec.int8_counts if quantized else dec.counts
    before = counts["kernel"]
    want = bagel.generate_text(model, cache, start, pos, 12, -1, graphs=False)
    eager = counts["kernel"] - before
    for _ in range(2):
        before = counts["kernel"]
        got = bagel.generate_text(model, cache, start, pos, 12, -1, graphs=True)
        assert counts["kernel"] - before == eager == 12 * 2
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("flavour", ["decode_chunk", "decode_chunk_aligned"])
def test_chunk_program_captured_equals_eager(gen, flavour):
    """A decode chunk as a captured graph against its eager loop: tokens,
    last, positions, lens and each live stream's cache columns equal."""
    from unimedvl_tpu_torch.inference import serving

    model = _program_model()
    fn = getattr(serving, flavour)
    args = (torch.tensor([3, 5, 7], device="cuda"), torch.tensor([40, 23, 11], device="cuda"),
            torch.tensor([True, False, True], device="cuda"))
    out = {}
    for graphs in (False, True):
        cache = _program_context(model, 3, 256, [40, 23, 11])
        out[graphs] = fn(model, cache, *args, 8, graphs=graphs, return_steps=True)
    (tok, last, pos, c, n), (tok_g, last_g, pos_g, c_g, n_g) = out[False], out[True]
    assert int(n) == int(n_g) == 8
    for a, b in ((tok, tok_g), (last, last_g), (pos, pos_g), (c.lens, c_g.lens)):
        assert torch.equal(a, b)
    for s in (0, 2):
        n_s = int(c.lens[s])
        assert torch.equal(c.k[:, s, :, :n_s], c_g.k[:, s, :, :n_s])


def test_flow_program_captured_equals_eager(gen):
    """generate_latents_group as captured graphs (a CFG run and a main-stream
    run, K1b inside) against its eager loop, over two step_range segments."""
    from unimedvl_tpu_torch.models import bagel
    from unimedvl_tpu_torch.models.qwen2_mot import KVCache

    model = _program_model()
    cfg, llm = model.config, model.config.llm
    G, S1, n = 2, 3, 16
    caches = KVCache.stack([_program_context(model, S1, 128, [20, 9, 20]) for _ in range(G)])
    positions = torch.tensor([20, 9, 20] * G, device="cuda")
    pos_ids = torch.randperm(cfg.max_latent_size ** 2, device="cuda", generator=gen)[:n]
    noise = torch.randn(G, n, cfg.patch_latent_dim, device="cuda", generator=gen)
    se = torch.tensor([llm.vocab_size - 2, llm.vocab_size - 1], device="cuda")
    kw = dict(num_timesteps=6, timestep_shift=1.0, cfg_text_scale=2.0, cfg_img_scale=1.5,
              cfg_interval=(0.4, 1.0), use_text_cfg=True, use_img_cfg=True)
    want = bagel.generate_latents_group(model, caches, positions, pos_ids, noise, se,
                                        graphs=False, **kw)
    before = fa.q_preproc_counts["kernel"]
    half = bagel.generate_latents_group(model, caches, positions, pos_ids, noise, se,
                                        graphs=True, step_range=(0, 2), **kw)
    got = bagel.generate_latents_group(model, caches, positions, pos_ids, half, se,
                                       graphs=True, step_range=(2, 5), **kw)
    assert fa.q_preproc_counts["kernel"] - before == 5 * llm.num_hidden_layers
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("fn", ["generate_text", "generate_text_ctx", "decode_chunk",
                                "decode_chunk_aligned"])
def test_sampled_program_captured_equals_eager(gen, fn):
    """A sampled decode as a captured graph (its generator registered with
    the graph) against its eager loop, from one seed: tokens and lens equal,
    the generator left in the same state by both, so that a draw after the
    decode (an inferencer's image noise) is the same; twice (the second call
    replays)."""
    from unimedvl_tpu_torch.inference import serving
    from unimedvl_tpu_torch.models import bagel

    model = _program_model()
    chunk = fn.startswith("decode_chunk")
    S = 3 if chunk else 2
    lens = [40, 23, 11][:S]
    start, pos = torch.tensor([5, 9, 7][:S], device="cuda"), torch.tensor(lens, device="cuda")
    active = torch.ones(S, dtype=torch.bool, device="cuda")
    out = {}
    g = torch.Generator(device="cuda")
    for graphs in (False, True, True):
        g.manual_seed(7)
        cache = _program_context(model, S, 256, lens)
        if chunk:
            got = getattr(serving, fn)(model, cache, start, pos, active, 8, do_sample=True,
                                       temperature=1.5, generator=g, graphs=graphs)
        else:
            got = getattr(bagel, fn)(model, cache, start, pos, 12, -1, True, 1.5, g,
                                     graphs=graphs)
        after = torch.randn(4, generator=g, device="cuda")
        if graphs in out:
            for a, b in zip(got[:2], out[graphs][0][:2]):
                assert torch.equal(a, b)
        out.setdefault(graphs, (got, after))
    (want, w_after), (got, g_after) = out[False], out[True]
    for a, b in zip(got[:2], want[:2]):
        assert torch.equal(a, b)
    if fn != "generate_text":
        assert torch.equal(got[-1].lens, want[-1].lens)
    if not chunk:  # a chunk's replays past its exit draw too (none here: no eos)
        assert torch.equal(g_after, w_after)


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16_cache", "int8_cache"])
def test_kept_and_spec_programs_captured_equal_eager(gen, quantized):
    """generate_text_ctx and generate_text_spec (S 1 and 2, verify block of
    T 4 through K1a) as captured graphs against their eager loops: tokens,
    lengths, verify forwards, lens, the caller's cache on [0, lens) and the
    kernels' launches equal."""
    from unimedvl_tpu_torch.models import bagel

    model = _program_model()
    counts = dec.int8_counts if quantized else dec.counts
    for S in (1, 2):
        lens = [40, 23][:S]
        start, pos = torch.tensor([5, 9][:S], device="cuda"), torch.tensor(lens, device="cuda")
        hist = torch.zeros((S, 256), dtype=torch.int32, device="cuda")
        for s, n in enumerate(lens):
            hist[s, :n] = (torch.arange(n, device="cuda") * 7 + 3 + s * n) % 512
            hist[s, n - 1] = start[s]
        hlen = torch.tensor(lens, dtype=torch.int32, device="cuda")
        for fn in ("generate_text_ctx", "generate_text_spec"):
            extra = (hist, hlen) if fn == "generate_text_spec" else ()
            kw = dict(k_draft=3, ngram=2) if extra else {}
            res = {}
            for graphs in (False, True, True):
                cache = _program_context(model, S, 512, lens, quantized)
                before = (counts["kernel"], fa.counts["kernel"])
                got = getattr(bagel, fn)(model, cache, start, pos, 16, -1, *extra, graphs=graphs,
                                         **kw)
                launched = (counts["kernel"] - before[0], fa.counts["kernel"] - before[1])
                res[graphs] = (got, launched)
            (want, w_n), (got, g_n) = res[False], res[True]
            assert g_n == w_n
            for a, b in zip(got[:2], want[:2]):
                assert torch.equal(a, b)
            if extra:
                assert int(got[3]) == want[3] and w_n[1] == want[3] * 2
            assert torch.equal(got[2].lens, want[2].lens)
            for s in range(S):
                n_s = int(want[2].lens[s])
                assert torch.equal(got[2].k[:, s, :, :n_s], want[2].k[:, s, :, :n_s])
                assert torch.equal(got[2].v[:, s, :, :n_s], want[2].v[:, s, :, :n_s])


@pytest.mark.parametrize("static", [False, True], ids=["pool", "static"])
def test_spec_chunk_program_captured_equals_eager(gen, static):
    """decode_chunk_spec as a captured graph (S 3, budgets that end the
    slots early, so some replays run past the exit) against its eager loop:
    every output, the verify forwards run and the live slots' cache columns
    equal."""
    from unimedvl_tpu_torch.inference import serving

    model = _program_model()
    lens = [40, 23, 11]
    args = (torch.tensor([3, 5, 7], device="cuda"), torch.tensor(lens, device="cuda"),
            torch.tensor([True, False, True], device="cuda"),
            torch.tensor([5, 3, 6], dtype=torch.int32, device="cuda"))
    out = {}
    for graphs in (False, True):
        cache = _program_context(model, 3, 256, lens)
        hist = torch.zeros((3, 256), dtype=torch.int32, device="cuda")
        hist[:, :40] = (torch.arange(40, device="cuda") * 5 + 1) % 512
        hlen = torch.tensor(lens, dtype=torch.int32, device="cuda")
        out[graphs] = serving.decode_chunk_spec(model, cache, *args, hist, hlen, 8, 1,
                                                k_draft=3, ngram=2, graphs=graphs,
                                                return_steps=True, static=static)
    want, got = out[False], out[True]
    for i in (0, 1, 2, 3, 4, 6, 7):
        assert torch.equal(got[i], want[i]), i
    assert int(got[8]) == want[8] < 8
    assert torch.equal(got[5].lens, want[5].lens)
    for s in (0, 2):
        n_s = int(want[5].lens[s])
        assert torch.equal(got[5].k[:, s, :, :n_s], want[5].k[:, s, :, :n_s])


def _prefill_model():
    """:func:`_program_model`'s LLM with a ViT of head dim 72 (K1a) and the
    tiny VAE (fp32)."""
    import dataclasses

    from unimedvl_tpu_torch.config import ViTConfig
    from unimedvl_tpu_torch.models import bagel

    cfg = dataclasses.replace(_program_model().config, vit=ViTConfig(
        hidden_size=144, intermediate_size=288, num_hidden_layers=2, num_attention_heads=2,
        image_size=32, patch_size=2, rope=False))
    model = bagel.Bagel(cfg, device="cuda", dtype=torch.bfloat16, with_vae=True)
    bagel.init_random_(model, torch.Generator(device="cuda").manual_seed(1), llm2vae_zero=False)
    return model


def _same_valid(a, b):
    """Equal lens and equal values and scales on each stream's [0, lens)."""
    assert torch.equal(a.lens, b.lens)
    for s, n in enumerate(a.lens.tolist()):
        for x, y in zip((a.k, a.v, a.k_scale, a.v_scale), (b.k, b.v, b.k_scale, b.v_scale)):
            if x is not None:
                assert torch.equal(x[:, s, :, :n], y[:, s, :, :n])


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16_cache", "int8_cache"])
def test_context_prefill_programs_captured_equal_eager(gen, quantized):
    """The context builds as captured programs against their eager
    functions: a text prefill; two images of one ViT bucket (n 50 and 37,
    one capture); two VAE images of one latent bucket (16 and 12 tokens: one
    prefill capture whose <vision_end> row moves, an encode capture a
    geometry). Lens, each cache's valid columns and K1a / K1b's launches
    equal."""
    from unimedvl_tpu_torch.inference import programs
    from unimedvl_tpu_torch.models import bagel

    model = _prefill_model()
    cfg, llm = model.config, model.config.llm
    se = torch.tensor([llm.vocab_size - 2, llm.vocab_size - 1], device="cuda")
    images = [torch.rand(1, 3, h, w, device="cuda", generator=gen) * 2 - 1
              for h, w in ((32, 32), (24, 32))]
    noises = [torch.randn(1, 4, h // 4, w // 4, device="cuda", generator=gen)
              for h, w in ((32, 32), (24, 32))]
    vit = [torch.randn(1, 64, 12, device="cuda", generator=gen) for _ in range(2)]
    pos = torch.randperm(256, device="cuda", generator=gen)[:64][None]
    runs = {}
    for graphs in (False, True):
        programs.drop_all()
        cache = _program_context(model, 1, 512, [20], quantized)
        before = (fa.counts["kernel"], fa.q_preproc_counts["kernel"], programs.stats["captures"])
        got = []
        ids = (torch.arange(32, device="cuda")[None] * 5 + 1) % llm.vocab_size
        cache = bagel.prefill_text(model, cache, ids, torch.arange(20, 52, device="cuda")[None],
                                   torch.arange(32, device="cuda")[None] < 25, graphs=graphs)
        got.append(cache.clone())
        for tokens, n in zip(vit, (50, 37)):
            cache = bagel.prefill_vit_bucketed(model, cache, tokens, pos, n, se,
                                               int(cache.lens[0]), graphs=graphs)
            got.append(cache.clone())
        for image, noise in zip(images, noises):
            lat = bagel.encode_vae_latent_tokens(model, image, noise, graphs=graphs)
            n = lat.shape[1]
            lat = torch.nn.functional.pad(lat, (0, 0, 0, 16 - n))
            lpos = torch.arange(16, device="cuda")[None] * (torch.arange(16, device="cuda") < n)
            cache = bagel.prefill_vae_bucketed(model, cache, lat, lpos, n, se, 60,
                                               graphs=graphs)
            got.append(cache.clone())
        runs[graphs] = got, (fa.counts["kernel"] - before[0],
                             fa.q_preproc_counts["kernel"] - before[1],
                             programs.stats["captures"] - before[2])
    (want, w_counts), (got, g_counts) = runs[False], runs[True]
    for a, b in zip(got, want):
        _same_valid(a, b)
    assert g_counts[:2] == w_counts[:2]
    assert g_counts[1] == 2 * llm.num_hidden_layers
    assert g_counts[2] == 5  # text, ViT, VAE prefill, an encode for each geometry


def test_vae_decode_program_captured_equals_eager(gen):
    """The VAE decode as a captured program against the eager decode, bit
    for bit: two latents of one size (one capture, then a replay on new
    values) and a second size (a second program)."""
    from unimedvl_tpu_torch.inference import programs
    from unimedvl_tpu_torch.models import bagel

    programs.drop_all()
    model = _prefill_model()
    width = model.config.patch_latent_dim
    caps = programs.stats["captures"]
    for h, w in ((4, 4), (4, 4), (2, 6)):
        tokens = torch.randn(h * w, width, generator=gen, device="cuda")
        want = bagel.decode_latent_to_image(model, tokens, h, w, graphs=False)
        got = bagel.decode_latent_to_image(model, tokens, h, w)
        assert got.dtype == torch.uint8 and got.shape == want.shape
        assert torch.equal(got, want)
    assert programs.stats["captures"] - caps == 2
    programs.drop_all()


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16_pool", "int8_pool"])
def test_admission_programs_captured_equal_eager(gen, quantized):
    """The batcher's admission blocks as captured programs against the eager
    functions, twice (the second call replays): an image group of 3 padded
    to 4 with its text, and a text block seeded with a preamble. Every
    column equal (each program zeroes its block as the eager route creates
    a new one)."""
    from unimedvl_tpu_torch.inference import programs, serving
    from unimedvl_tpu_torch.models import bagel

    model = _prefill_model()
    llm = model.config.llm
    V = llm.vocab_size
    se = torch.tensor([V - 2, V - 1], device="cuda")
    kind = dict(kv_dtype=torch.bfloat16, quantized=quantized)
    prefix = _program_context(model, 1, 64, [29], quantized)
    tids = (torch.arange(32 * 32, device="cuda").reshape(32, 32) * 3 + 2) % V
    tpos = torch.arange(29, 61, device="cuda").expand(32, 32).contiguous()
    tvalid = torch.arange(32, device="cuda")[None] < (torch.arange(32, device="cuda") % 7)[:, None]
    for call in range(2):
        toks = torch.randn(4, 64, 12, device="cuda", generator=gen)
        ns = torch.tensor([60, 41, 64, 0], device="cuda")
        vpos = torch.randperm(256, device="cuda", generator=gen)[:64].expand(4, 64).contiguous()
        ids = (torch.arange(4 * 32, device="cuda").reshape(4, 32) * 7 + call) % V
        ipos = torch.arange(1, 33, device="cuda").expand(4, 32).contiguous()
        ivalid = torch.arange(32, device="cuda")[None] < torch.tensor([[9], [30], [3], [0]],
                                                                      device="cuda")
        blocks = {}
        for graphs in (False, True):
            img = serving.image_text_block(model, toks, vpos, ns, se, ids, ipos, ivalid,
                                           capacity=64 + 2 + 32, graphs=graphs, **kind)
            txt = serving.text_block(model, tids, tpos, tvalid, 96, prefix, 29, graphs=graphs,
                                     **kind)
            blocks[graphs] = img.clone(), txt.clone()
        for a, b in zip(blocks[True], blocks[False]):
            for x, y in zip((a.k, a.v, a.k_scale, a.v_scale, a.lens),
                            (b.k, b.v, b.k_scale, b.v_scale, b.lens)):
                assert (x is None and y is None) or torch.equal(x, y)
    assert len([p for p in programs.programs() if p.family == "admission"]) == 2


# ---------------------------------------------------------------------------
# The programs on a one-rank NCCL mesh: a rank's model (parallel.mesh.place_params
# over a mesh whose axes each hold a real one-rank NCCL group) runs its captured
# programs by default, every collective inside the graph; each is held to its eager
# route on the same inputs, with the same number of collectives a call.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nccl_group(tmp_path_factory):
    """A one-rank NCCL default group for the module (destroyed after it)."""
    import datetime

    import torch.distributed as dist

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    made = not dist.is_initialized()
    if made:
        rendezvous = tmp_path_factory.mktemp("nccl") / "rendezvous"
        dist.init_process_group("nccl", init_method=f"file://{rendezvous}", world_size=1, rank=0,
                                timeout=datetime.timedelta(seconds=120))
    assert dist.get_backend() == "nccl"
    yield
    if made:
        dist.destroy_process_group()


def _nccl_mesh(axes):
    from unimedvl_tpu_torch.parallel import mesh as pmesh

    mesh = pmesh.make_mesh(axes, (1,) * len(axes), singleton_groups=True)
    assert mesh.capturable and all(g is not None for g in mesh.groups.values())
    return mesh


def _both_routes(run):
    """``run(graphs)`` eagerly, then captured (a new capture, then a replay):
    (eager result, captured results, collectives of each call, captures that
    hold collectives)."""
    from unimedvl_tpu_torch.inference import programs
    from unimedvl_tpu_torch.parallel import mesh as pmesh

    programs.drop_all()
    out, calls = {}, []
    before = programs.stats["collective_captures"]
    for graphs in (False, True, True):
        n = pmesh.counts["collectives"]
        out.setdefault(graphs, []).append(run(graphs))
        calls.append(pmesh.counts["collectives"] - n)
    return out[False][0], out[True], calls, programs.stats["collective_captures"] - before


def test_mesh_decode_program_captured_equals_eager(gen, nccl_group):
    """generate_text on a rank's model of a one-rank NCCL ("data", "model")
    mesh: by default the captured program (its 2 L all-reduces and the vocab
    gather inside the graph); tokens, lengths and the last step's logits
    equal to the eager route's, twice (the second call replays), with as
    many collectives a call."""
    from unimedvl_tpu_torch.inference import programs
    from unimedvl_tpu_torch.models import bagel
    from unimedvl_tpu_torch.models import qwen2_mot as mot
    from unimedvl_tpu_torch.parallel import mesh as pmesh

    mesh = _nccl_mesh(("data", "model"))
    model = pmesh.place_params(_program_model(), mesh)
    assert programs.use_graphs(None, torch.device("cuda"), model)
    start, pos = torch.tensor([5, 9], device="cuda"), torch.tensor([40, 23], device="cuda")
    last = torch.zeros(2, model.config.llm.vocab_size, device="cuda")
    real = mot.lm_head

    def recorded(lm, h):
        logits = real(lm, h)
        last.copy_(logits)
        return logits

    def run(graphs):
        cache = _program_context(model, 2, 512, [40, 23], graphs=False)
        mot.lm_head = recorded
        try:
            tokens, lengths = bagel.generate_text(model, cache, start, pos, 12, -1,
                                                  graphs=None if graphs else False)
        finally:
            mot.lm_head = real
        return tokens, lengths, last.clone()

    want, got, calls, captures = _both_routes(run)
    for g in got:
        for a, b in zip(g, want):
            assert torch.equal(a, b)
    L = model.config.llm.num_hidden_layers
    assert calls[0] > 12 * (2 * L + 1) and len(set(calls)) == 1
    assert captures == 1


def test_mesh_chunk_and_admission_programs_captured_equal_eager(gen, nccl_group):
    """A batcher's decode chunk and an admission block (an image group and
    its text) on a rank's model of a one-rank NCCL mesh, captured against
    eager: tokens, positions, lens and the live columns of the chunk, every
    column of the block."""
    from unimedvl_tpu_torch.inference import serving
    from unimedvl_tpu_torch.parallel import mesh as pmesh

    mesh = _nccl_mesh(("data", "model"))
    model = pmesh.place_params(_prefill_model(), mesh)
    args = (torch.tensor([3, 5, 7], device="cuda"), torch.tensor([40, 23, 11], device="cuda"),
            torch.tensor([True, False, True], device="cuda"))

    def chunk(graphs):
        cache = _program_context(model, 3, 256, [40, 23, 11], graphs=False)
        return serving.decode_chunk(model, cache, *args, 8, graphs=None if graphs else False,
                                    return_steps=True)

    want, got, calls, captures = _both_routes(chunk)
    for tok, last, pos, c, n in got:
        assert int(n) == int(want[4]) == 8
        for a, b in ((tok, want[0]), (last, want[1]), (pos, want[2]), (c.lens, want[3].lens)):
            assert torch.equal(a, b)
        for s in (0, 2):
            n_s = int(want[3].lens[s])
            assert torch.equal(c.k[:, s, :, :n_s], want[3].k[:, s, :, :n_s])
    # a chunk program is keyed by its pool's arrays, and each call's pool is new
    assert len(set(calls)) == 1 and captures == 2

    V = model.config.llm.vocab_size
    se = torch.tensor([V - 2, V - 1], device="cuda")
    toks = torch.randn(4, 64, 12, device="cuda", generator=gen)
    ns = torch.tensor([60, 41, 64, 0], device="cuda")
    vpos = torch.randperm(256, device="cuda", generator=gen)[:64].expand(4, 64).contiguous()
    ids = (torch.arange(4 * 32, device="cuda").reshape(4, 32) * 7) % V
    ipos = torch.arange(1, 33, device="cuda").expand(4, 32).contiguous()
    ivalid = torch.arange(32, device="cuda")[None] < torch.tensor([[9], [30], [3], [0]],
                                                                  device="cuda")

    def block(graphs):
        return serving.image_text_block(model, toks, vpos, ns, se, ids, ipos, ivalid,
                                        capacity=64 + 2 + 32, graphs=None if graphs else False,
                                        kv_dtype=torch.bfloat16, quantized=False).clone()

    want, got, calls, captures = _both_routes(block)
    for b in got:
        for x, y in ((b.k, want.k), (b.v, want.v), (b.lens, want.lens)):
            assert torch.equal(x, y)
    assert calls[0] > 0 and len(set(calls)) == 1 and captures == 1


def test_mesh_flow_and_sp_programs_captured_equal_eager(gen, nccl_group):
    """A flow step (generate_latents_group on a rank's model of a one-rank
    NCCL ("data", "model") mesh) and the sequence-parallel step
    (generate_latents_tp_sp over a one-rank NCCL ("model", "seq") mesh: the
    gathers over "seq", the chunks' all-reduces over "model" and the renorm's
    sums in the graph), captured against eager within the flow program's
    tolerance, each with as many collectives a call and one capture a
    cfg-run kind."""
    from unimedvl_tpu_torch.models import bagel
    from unimedvl_tpu_torch.models.qwen2_mot import KVCache
    from unimedvl_tpu_torch.parallel import mesh as pmesh
    from unimedvl_tpu_torch.parallel import sp_denoise

    whole = _program_model()
    cfg, llm = whole.config, whole.config.llm
    model = pmesh.place_params(whole, _nccl_mesh(("data", "model")))
    S1, n = 3, 16
    caches = KVCache.stack([_program_context(whole, S1, 128, [20, 9, 20])])
    positions = torch.tensor([20, 9, 20], device="cuda")
    pos_ids = torch.randperm(cfg.max_latent_size ** 2, device="cuda", generator=gen)[:n]
    noise = torch.randn(n, cfg.patch_latent_dim, device="cuda", generator=gen)
    se = torch.tensor([llm.vocab_size - 2, llm.vocab_size - 1], device="cuda")
    kw = dict(num_timesteps=6, timestep_shift=1.0, cfg_text_scale=2.0, cfg_img_scale=1.5,
              cfg_interval=(0.4, 1.0), use_text_cfg=True, use_img_cfg=True)

    def flow(graphs):
        return bagel.generate_latents(model, caches, positions, pos_ids, noise, se,
                                      graphs=None if graphs else False, **kw)

    want, got, calls, captures = _both_routes(flow)
    for g in got:
        torch.testing.assert_close(g, want, rtol=1e-3, atol=1e-3)
    assert calls[0] > 0 and len(set(calls)) == 1 and captures == 2

    sp_mesh = _nccl_mesh(("model", "seq"))

    def sp(graphs):
        return sp_denoise.generate_latents_tp_sp(whole, caches, positions, pos_ids, noise, se,
                                                 sp_mesh, graphs=None if graphs else False, **kw)

    want_sp, got, calls, captures = _both_routes(sp)
    for g in got:
        torch.testing.assert_close(g, want_sp, rtol=1e-3, atol=1e-3)
    assert calls[0] > 0 and len(set(calls)) == 1 and captures == 2
    torch.testing.assert_close(want_sp, want, rtol=2.0**-6, atol=2.0**-6)


# ---------------------------------------------------------------------------
# The training steps as programs (training.trainer.TrainProgram): each graphed
# step against its own bodies run op by op over the same buffers
# (programs.plain_bodies), bit for bit over three calls that include the
# capturing one, K5's launches inside the captures counted as the bodies
# count them; and the first call against the stripped eager step, within a
# floor measured in the same test: the gap between the eager bf16 step and
# the same step in fp32 on the CPU (the plain versions), as the smoke's
# TP_FLOOR_FACTOR bounds the tensor-parallel chat. The gap is read on the
# AdamW first moments after the first update ((1 - b1) times the mean
# gradient) and on the loss (plus one bf16 step of it).
# ---------------------------------------------------------------------------

TRAIN_FLOOR_FACTOR = 2.0
TRAIN_KINDS = ["full", "lora", "qlora_w4a8"]


def _train_batch(cfg, seed):
    """A stacked batch of B = 2 packed sequences (text with CE rows, a
    conditioning and a noised latent block, ViT images of 36 and 20 patches)
    with padding in every list."""
    import numpy as np

    from unimedvl_tpu_torch.data.packing import pack_training_batch
    from unimedvl_tpu_torch.training.dataset import stack_packed

    rng = np.random.default_rng(seed)
    pd, vp, V = cfg.patch_latent_dim, cfg.vit.patch_size ** 2 * 3, cfg.llm.vocab_size

    def text(n):
        return {"type": "text", "ids": rng.integers(0, V - 8, n).tolist(), "loss": True}

    def vae(n, t, loss):
        return {"type": "vae", "clean_tokens": rng.standard_normal((n, pd)).astype(np.float32),
                "pos_ids": np.arange(n), "timestep_raw": t, "loss": loss}

    def vit(n):
        return {"type": "vit", "patch_tokens": rng.standard_normal((n, vp)).astype(np.float32),
                "pos_ids": np.arange(n)}

    a = pack_training_batch([[text(40), vae(16, -np.inf, False), vae(24, 0.3, True)],
                             [vit(36), text(30)]], pad_multiple=32)
    b = pack_training_batch([[vit(20), text(25)], [text(12), vae(20, -0.4, True)]],
                            pad_multiple=32)
    return stack_packed([a, b])


def _train_kind(kind, mesh=None, cpu=False):
    """(model, make(graphs) -> (step, state)) of a training kind on
    :func:`_prefill_model` (bf16, a ViT of head dim 72): the full fine-tune
    (accumulation 2, EMA), LoRA, QLoRA over w4a8 per channel (K3 and K4
    under autograd); on ``mesh``, a rank's model of it; with ``cpu``, the
    same model in fp32 on the CPU (the plain versions)."""
    from unimedvl_tpu_torch import quant
    from unimedvl_tpu_torch.parallel import mesh as pmesh
    from unimedvl_tpu_torch.training import lora, trainer

    model = _prefill_model()
    if kind == "qlora_w4a8":
        quant.quantize_llm_params(model.language_model, act_quant=True, bits=4)
    if kind != "full":
        lora.add_lora(model, torch.Generator(device="cuda").manual_seed(3), rank=4)
    if cpu:
        model = model.float().cpu()
    if kind == "pipe":  # the GPipe step; on the CPU over a mesh without groups
        from unimedvl_tpu_torch.parallel.pp_train import place_params_pp

        axes = ("data", "pipe", "model")
        mesh = mesh or pmesh.Mesh(axes, {a: 1 for a in axes}, 0, {a: 0 for a in axes},
                                  {a: None for a in axes})
        model = place_params_pp(model, mesh)
    elif mesh is not None:
        model = pmesh.place_params(model, mesh)
    cfg = getattr(model, "whole_config", model.config)

    def make(graphs):
        if kind == "pipe":
            step, init = trainer.make_pp_train_step(cfg, model, mesh, ema_decay=0.9,
                                                    graphs=graphs)
            return step, init()
        if kind == "full":
            step, init = trainer.make_train_step(cfg, model, accum_steps=2, ema_decay=0.9,
                                                 mesh=mesh, graphs=graphs)
            return step, init()
        return lora.make_lora_train_step(cfg, model, graphs=graphs)

    return model, make


def _train_calls(model, kind):
    """Three calls' batches (the first twice: a replay of its buckets) and
    their noises (drawn from a seed, real rows only)."""
    from unimedvl_tpu_torch.training import trainer

    batches = [_train_batch(model.config, s) for s in (0, 0, 1)]
    g = torch.Generator(device="cuda").manual_seed(9)

    def noises(b):
        shapes = trainer._noise_shapes(b)
        return [None if s is None else torch.randn(s, generator=g, device="cuda")
                for s in shapes]

    if kind == "full":  # accumulation 2: two batches a call
        return [([b, b], [noises(b), noises(b)]) for b in batches]
    return [(b, noises(b)) for b in batches]


def _moments(state):
    return [state.optimizer.state[p]["exp_avg"].float()
            for g in state.optimizer.param_groups for p in g["params"]]


def _rel(a, b):
    num = sum(float((x - y).square().sum()) for x, y in zip(a, b))
    den = sum(float(y.square().sum()) for y in b)
    return (num / max(den, 1e-30)) ** 0.5


def _held_to_floor(kind, make_model, graphed_first):
    """The graphed first call (its loss and first moments) against the
    stripped eager step of ``make_model()``, within TRAIN_FLOOR_FACTOR times
    the eager step's own gap to the fp32 plain step on the CPU."""
    model, make = make_model()
    (batch, noises), = _train_calls(model, kind)[:1]
    step, state = make(False)
    _, loss_e = step(state, batch, noises=noises)
    m_e = _moments(state)
    del step, state, model, make
    _, make_f = _train_kind(kind, cpu=True)
    step, state = make_f(False)

    def to_cpu(n):
        return None if n is None else n.cpu()

    nz = ([[to_cpu(x) for x in n] for n in noises] if kind == "full" else
          [to_cpu(x) for x in noises])
    _, loss_f = step(state, batch, noises=nz)
    m_f = [m.cuda() for m in _moments(state)]
    loss_g, m_g = graphed_first
    floor = _rel(m_e, m_f)
    assert _rel(m_g, m_f) <= TRAIN_FLOOR_FACTOR * floor, (_rel(m_g, m_f), floor)
    gap_e, gap_g = abs(float(loss_e) - float(loss_f)), abs(loss_g - float(loss_f))
    assert gap_g <= TRAIN_FLOOR_FACTOR * gap_e + 2.0**-8 * abs(float(loss_f))


def _graphed_against_bodies(model_pair, kind):
    """Three calls by the graphs and by the bodies run op by op over their own
    buffers, on two identical models: losses, every trained tensor, the
    AdamW state and K5's launches equal. Returns the graphed first call's
    (loss, first moments) and the collectives one graphed call ran."""
    from unimedvl_tpu_torch.inference import programs
    from unimedvl_tpu_torch.parallel import mesh as pmesh

    programs.drop_all()
    out = {}
    for route in ("bodies", "graphs"):
        model, make = model_pair()
        step, state = make(True)
        losses, launches, first = [], [], None
        calls = _train_calls(model, kind)
        for i, (batch, noises) in enumerate(calls):
            before = dict(fat.counts)
            n = pmesh.counts["collectives"]
            if route == "bodies":
                with programs.plain_bodies():
                    state, loss = step(state, batch, noises=noises)
            else:
                state, loss = step(state, batch, noises=noises)
            losses.append(float(loss))
            launches.append({k: fat.counts[k] - before[k] for k in ("fwd", "bwd_dq", "bwd_dkv")})
            if i == 0:
                first = (losses[0], [m.clone() for m in _moments(state)])
                collectives = pmesh.counts["collectives"] - n
        params = [p.detach().clone() for g in state.optimizer.param_groups for p in g["params"]]
        out[route] = (losses, launches, params, _moments(state), first, collectives)
        del step, state, model
        programs.drop_all()
    (lb, kb, pb, mb, _, cb), (lg, kg, pg, mg, first, cg) = out["bodies"], out["graphs"]
    assert lg == lb
    assert kg == kb and all(k["fwd"] > 0 and k["bwd_dq"] > 0 and k["bwd_dkv"] > 0 for k in kg)
    assert all(torch.equal(a, b) for a, b in zip(pg, pb))
    assert all(torch.equal(a, b) for a, b in zip(mg, mb))
    assert cg == cb
    return first, cg


@pytest.mark.parametrize("kind", TRAIN_KINDS)
def test_train_program_captured_equals_its_bodies_and_the_eager_step(gen, kind):
    """A graphed training step (the full fine-tune with accumulation and the
    EMA, LoRA, QLoRA w4a8) equals its bodies run op by op, bit for bit, over
    three calls (the first captures); its first call lies within the floor
    of the stripped eager step."""
    first, _ = _graphed_against_bodies(lambda: _train_kind(kind), kind)
    _held_to_floor(kind, lambda: _train_kind(kind), first)


def test_mesh_train_program_captured_equals_its_bodies_and_the_eager_step(gen, nccl_group):
    """The full fine-tune step on a rank's model of a one-rank NCCL ("data",
    "model") mesh: its graphs (the gradients' and the loss's all-reduces
    inside the update graph, the forward's and backward's collectives inside
    the train graphs) against its bodies, bit for bit over three calls with
    as many collectives a call; its first call within the floor of the
    stripped eager mesh step."""
    from unimedvl_tpu_torch.inference import programs

    mesh = _nccl_mesh(("data", "model"))
    before = programs.stats["collective_captures"]
    first, collectives = _graphed_against_bodies(lambda: _train_kind("full", mesh), "full")
    assert collectives > 0 and programs.stats["collective_captures"] > before
    _held_to_floor("full", lambda: _train_kind("full", mesh), first)


def test_pipeline_train_program_captured_equals_its_bodies_and_the_eager_step(gen, nccl_group):
    """The GPipe step (``make_pp_train_step``, the EMA) on a stage model of a
    one-rank NCCL ("data", "pipe", "model") mesh, M = 2 microbatches: its
    "pipeline" graph (the embedding, the schedule with its broadcasts over
    "pipe", the losses and the reverse schedule's nested backward) and its
    update graph against its bodies, bit for bit over three calls with as
    many collectives a call; its first call within the floor of the
    stripped eager pipeline step."""
    from unimedvl_tpu_torch.inference import programs

    mesh = _nccl_mesh(("data", "pipe", "model"))
    before = programs.stats["collective_captures"]
    first, collectives = _graphed_against_bodies(lambda: _train_kind("pipe", mesh), "pipe")
    assert collectives > 0 and programs.stats["collective_captures"] > before
    _held_to_floor("pipe", lambda: _train_kind("pipe", mesh), first)
