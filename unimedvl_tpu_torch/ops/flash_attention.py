"""K1a, K1b, K1c and K6: flash attention of a query block over cache plus block.

Port of unimedvl_tpu/ops/flash_attention.py. ``flash_block_attention`` is K1a
(no q pre-processing), K1b (``q_preproc``: the gen-mode fp32 qk-norm + RoPE of
the query side fused into the kernel) and K1c (either, with ``return_lse``:
also the log-sum-exp of the scaled logits, with which the sequence-parallel
denoise merges a cache partial and a block partial).
``flash_cache_block_attention`` is K6: the same attention with the cache and
the block as separate arrays, never concatenated, and optionally the k-side
island fused too (``kv_preproc``). The kernels are CUDA C++ for sm_90a
(``csrc/flash_block_attention.cu``, ``csrc/flash_cache_block_attention.cu``,
shared device code in ``csrc/flash_common.cuh``); ``flash_block_attention_ref``
and ``flash_cache_block_attention_ref`` are their plain PyTorch versions.

Visibility, per stream s: key j is visible iff ``j < lens[s]`` or
``block_start[s] <= j < block_start[s] + q_valid_len[s]``; causal mode adds
``j - block_start[s] <= i`` for query row i. Query rows at or past
``q_valid_len[s]`` are trailing padding and their output is garbage by contract.

Rows that see no key. With ``return_lse`` the kernel and the plain version
agree: the output row is 0 and its lse is ``NEG_INF`` (float32 min), finite,
so that ``combine_attention_partials`` weighs the partial 0 and never forms
``-inf - (-inf)``. This covers both a stream whose sweep is empty (the
text-CFG stream's cache partial, ``lens = 0``) and a row whose swept keys are
all masked (the JAX kernel weighs each masked key of such a tile 1 there; no
caller has such a row). Without ``return_lse`` the kernel gives 0 for such a
row and the plain version the mean of v; callers never read them.

Each wrapper launches its kernel for CUDA tensors and runs the plain version
for CPU tensors; there is no size threshold and no fallback. The kernels have
no backward: on CUDA tensors that require grad, with grad mode on, the calls
raise instead of returning an output cut off from the graph.
"""

from __future__ import annotations

from typing import Optional

import torch

from unimedvl_tpu_torch.ops import _launch, cuda_build
from unimedvl_tpu_torch.ops.attention import NEG_INF, gqa_attention_hm, gqa_attention_hm_lse
from unimedvl_tpu_torch.ops.rope import apply_rope_one

# launches of the kernel and calls of the plain version, for showing which
# ran: ``counts`` without q pre-processing (K1a), ``q_preproc_counts`` with it
# (K1b), ``lse_counts`` for either with return_lse (K1c), ``cache_block_counts``
# for flash_cache_block_attention (K6). A call counts in exactly one of them.
counts = {"kernel": 0, "plain": 0}
q_preproc_counts = {"kernel": 0, "plain": 0}
lse_counts = {"kernel": 0, "plain": 0}
cache_block_counts = {"kernel": 0, "plain": 0}

KERNEL_HEAD_DIMS = (72, 128)
Q_PREPROC_HEAD_DIM = 128


def _visibility_mask(T, M, lens, block_start, q_valid_len, causal, device):
    j = torch.arange(M, device=device)[None, None, :]
    i = torch.arange(T, device=device)[None, :, None]
    off = j - block_start[:, None, None]
    in_block = (off >= 0) & (off < q_valid_len[:, None, None])
    if causal:
        in_block = in_block & (off <= i)
    return (j < lens[:, None, None]) | in_block  # [S, T, M]


def preprocess_q(q: torch.Tensor, q_preproc: dict) -> torch.Tensor:
    """The gen-mode island on a raw projection [S, T, heads, D] (q, or for K6
    the block's k), in fp32 (qwen2_navit.py:568-583): RMSNorm with ``w_und``
    on the text rows {0, end_row} and ``w_gen`` elsewhere, then RoPE; rounded
    to the input's dtype.

    ``q_preproc``: ``w_und``/``w_gen`` [D]; ``cos``/``sin`` [S, T, D], or
    [S, 1, D] when the block shares one rope position; ``end_row`` (int, or
    scalar or [S] int tensor; None = T - 1); ``eps``."""
    S, T = q.shape[:2]
    end_row = q_preproc.get("end_row")
    end_row = _launch.per_stream(T - 1 if end_row is None else end_row, S, q.device)
    rows = torch.arange(T, device=q.device)[None]
    text = (rows == 0) | (rows == end_row[:, None])  # [S, T]
    w = torch.where(
        text[:, :, None, None], q_preproc["w_und"].float(), q_preproc["w_gen"].float()
    )
    q32 = q.float()
    var = torch.mean(q32 * q32, dim=-1, keepdim=True)
    qn = q32 * torch.rsqrt(var + q_preproc.get("eps", 1e-6)) * w
    return apply_rope_one(qn, q_preproc["cos"].float(), q_preproc["sin"].float()).to(q.dtype)


def _count(which: str, q_preproc, return_lse: bool = False) -> None:
    if return_lse:
        lse_counts[which] += 1
    elif q_preproc is not None:
        q_preproc_counts[which] += 1
    else:
        counts[which] += 1


def flash_block_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lens: torch.Tensor,
    block_start: torch.Tensor,
    causal: bool,
    q_valid_len: Optional[torch.Tensor] = None,
    kv_head_major: bool = False,
    q_preproc: Optional[dict] = None,
    return_lse: bool = False,
):
    """Plain version of :func:`flash_block_attention`: :func:`preprocess_q`
    when ``q_preproc`` is given, then the masked softmax in fp32 on whatever
    device the inputs are on. Returns [S, T, H, D] in q's dtype; with
    ``return_lse`` (through ``gqa_attention_hm_lse``) also the lse [S, T, H]
    fp32, ``NEG_INF`` and a zero output for rows that see nothing."""
    _count("plain", q_preproc, return_lse)
    if q_preproc is not None:
        q = preprocess_q(q, q_preproc)
    S, T = q.shape[:2]
    if not kv_head_major:
        k, v = k.transpose(1, 2), v.transpose(1, 2)
    M = k.shape[2]
    mask = _visibility_mask(
        T, M, _launch.per_stream(lens, S, q.device),
        _launch.per_stream(block_start, S, q.device),
        _launch.per_stream(T if q_valid_len is None else q_valid_len, S, q.device),
        causal, q.device,
    )
    if return_lse:
        out, lse = gqa_attention_hm_lse(q.float(), k.float(), v.float(), mask)
        return out.to(q.dtype), lse
    return gqa_attention_hm(q.float(), k.float(), v.float(), mask).to(q.dtype)


# ---------------------------------------------------------------------------
# The kernels' partition of the sweep, in plain torch
# ---------------------------------------------------------------------------

TILE_KEYS = 64  # keys per tile of the kernels' sweep (csrc/flash_common.cuh, kBN)
CTA_ROWS = 128  # query rows per CTA: two warpgroups of 64 (WgmmaCta)


def sweep_plan(n_keys: int, ln: int, bs: int, qv: int, causal: bool, last_row: int) -> list:
    """Start keys of the tiles that a CTA whose last query row is
    ``last_row`` sweeps over one key array (``csrc/flash_common.cuh::
    plan_tiles``): the tiles of the context [0, ln), then those of the block
    up to what its rows reach; every tile wholly inside the gap between them
    or past that end is skipped. Python ints."""
    ln = min(ln, n_keys)
    n_ctx = -(-ln // TILE_KEYS) if ln > 0 else 0
    lo = max(bs, 0)
    hi = min(bs + (min(qv, last_row + 1) if causal else qv), n_keys)
    b_lo = max(lo // TILE_KEYS, n_ctx)
    b_hi = -(-hi // TILE_KEYS) if hi > lo else 0
    return [t * TILE_KEYS for t in [*range(n_ctx), *range(b_lo, b_hi)]]


def _tiled_sweeps(q, arrays, return_lse):
    """The kernels' arithmetic in fp32: per stream and CTA of query rows, the
    tiles of ``sweep_plan`` of each key array in turn on one online-softmax
    state; key rows that no row of the CTA reaches are zero-filled, masked
    keys weigh 0 by selection, p is rounded to v's dtype before P V. A CTA
    whose plans are all empty gives zero rows and lse ``NEG_INF`` without
    touching q. ``arrays``: (k, v, rule) with k/v head-major [S, Hk, N, D] and
    rule[s] = (n_keys, ln, bs, qv, causal) in Python ints."""
    S, T, H, D = q.shape
    Hk = arrays[0][0].shape[1]
    G, R = H // Hk, CTA_ROWS
    out = torch.zeros(S, T, H, D, dtype=torch.float32, device=q.device)
    lse = torch.full((S, T, H), NEG_INF, dtype=torch.float32, device=q.device)
    for s in range(S):
        for q0 in range(0, T, R):
            rows = torch.arange(q0, min(q0 + R, T), device=q.device)
            n, last = len(rows), q0 + len(rows) - 1
            plans = [sweep_plan(*rule[s], last) for _, _, rule in arrays]
            if not any(plans):
                continue  # the kernel writes zeros without loading Q
            qt = q[s, q0:q0 + n].float().reshape(n, Hk, G, D)
            m = torch.full((Hk, G, n), NEG_INF, device=q.device)
            l = torch.zeros(Hk, G, n, device=q.device)
            acc = torch.zeros(Hk, G, n, D, device=q.device)
            for (k, v, rule), plan in zip(arrays, plans):
                n_keys, ln, bs, qv, causal = rule[s]
                end = bs + (min(qv, last + 1) if causal else qv)
                for j0 in plan:
                    j = torch.arange(j0, min(j0 + TILE_KEYS, n_keys), device=q.device)
                    reach = (j < ln) | ((j >= bs) & (j < end))
                    kt = torch.where(reach[:, None], k[s, :, j0:j0 + len(j)].float(), 0.0)
                    vt = torch.where(reach[:, None], v[s, :, j0:j0 + len(j)].float(), 0.0)
                    off = j[None] - bs
                    vis = (j[None] < ln) | ((off >= 0) & (off < qv)
                                            & ((off <= rows[:, None]) if causal else True))
                    x = torch.einsum("nhgd,hjd->hgnj", qt, kt) * D**-0.5
                    x = torch.where(vis, x, NEG_INF)
                    mx = torch.maximum(m, x.amax(dim=-1))
                    alpha = torch.exp(m - mx)
                    p = torch.where(vis, torch.exp(x - mx[..., None]), 0.0)
                    l = l * alpha + p.sum(dim=-1)
                    pv = torch.einsum("hgnj,hjd->hgnd", p.to(v.dtype).float(), vt)
                    acc = acc * alpha[..., None] + pv
                    m = mx
            o = acc / l.clamp_min(1e-30)[..., None]
            out[s, q0:q0 + n] = o.permute(2, 0, 1, 3).reshape(n, H, D)
            row_lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)), NEG_INF)
            lse[s, q0:q0 + n] = row_lse.permute(2, 0, 1).reshape(n, H)
    out = out.to(q.dtype)
    return (out, lse) if return_lse else out


def _ints(x, S: int, device) -> list:
    return _launch.per_stream(x, S, device).tolist()


def flash_block_attention_tiled_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lens: torch.Tensor,
    block_start: torch.Tensor,
    causal: bool,
    q_valid_len: Optional[torch.Tensor] = None,
    kv_head_major: bool = False,
    q_preproc: Optional[dict] = None,
    return_lse: bool = False,
):
    """:func:`flash_block_attention` as the kernels partition it: the same
    function as :func:`flash_block_attention_ref`, computed over the tiles
    that the kernel's CTAs visit and no others (``sweep_plan``), with its
    online softmax and its early exit. For the CPU tests of the partition; it
    counts in no counter."""
    if q_preproc is not None:
        q = preprocess_q(q, q_preproc)
    S, T = q.shape[:2]
    if not kv_head_major:
        k, v = k.transpose(1, 2), v.transpose(1, 2)
    M = k.shape[2]
    ln, bs = _ints(lens, S, q.device), _ints(block_start, S, q.device)
    qv = _ints(T if q_valid_len is None else q_valid_len, S, q.device)
    rule = [(M, ln[s], bs[s], qv[s], causal) for s in range(S)]
    return _tiled_sweeps(q, [(k, v, rule)], return_lse)


def flash_cache_block_attention_tiled_ref(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_block: torch.Tensor,
    v_block: torch.Tensor,
    lens: torch.Tensor,
    causal: bool,
    q_preproc: Optional[dict] = None,
    kv_preproc: Optional[dict] = None,
    block_len: Optional[int] = None,
    cache_head_major: bool = False,
) -> torch.Tensor:
    """:func:`flash_cache_block_attention` as the kernel partitions it: the
    cache's tiles below ``lens``, then the block's (causally reachable)
    tiles, on one online-softmax state (``sweep_plan`` for each array). For
    the CPU tests of the partition; it counts in no counter."""
    blk_valid, kvp = _block_options(q, k_block, causal, q_preproc, kv_preproc, block_len)
    if q_preproc is not None:
        q = preprocess_q(q, q_preproc)
    if kvp is not None:
        k_block = preprocess_q(k_block.to(k_cache.dtype), kvp)
    if not cache_head_major:
        k_cache, v_cache = k_cache.transpose(1, 2), v_cache.transpose(1, 2)
    S = q.shape[0]
    M, Tb = k_cache.shape[2], k_block.shape[1]
    ln = _ints(lens, S, q.device)
    cache = [(M, min(ln[s], M), 0, 0, False) for s in range(S)]
    block = [(Tb, 0, 0, min(blk_valid, Tb), causal)] * S
    kb = k_block.to(k_cache.dtype).transpose(1, 2)
    vb = v_block.to(v_cache.dtype).transpose(1, 2)
    return _tiled_sweeps(q, [(k_cache, v_cache, cache), (kb, vb, block)], False)


def _preproc_args(preproc: Optional[dict], S: int, T: int, device: torch.device):
    """The C arguments of one pre-processing island over a block of T rows:
    fp32 norm weights [128], fp32 tables with their (stream, row) strides,
    end_row int32 [S]; null pointers for ``None``. The tensors are returned
    too, so they outlive the launch."""
    if preproc is None:
        return [0, 0, 0, 0, 0, 0, 0], ()
    D = Q_PREPROC_HEAD_DIM
    w_und = preproc["w_und"].to(torch.float32).contiguous()
    w_gen = preproc["w_gen"].to(torch.float32).contiguous()
    rows = preproc["cos"].shape[-2]
    if rows not in (1, T):
        raise ValueError(f"rope tables must have 1 or {T} rows, got {rows}")
    cos = preproc["cos"].to(torch.float32).expand(S, rows, D).contiguous()
    sin = preproc["sin"].to(torch.float32).expand(S, rows, D).contiguous()
    end_row = preproc.get("end_row")
    end_row = _launch.per_stream(T - 1 if end_row is None else end_row, S, device)
    for name, t in (("w_und", w_und), ("w_gen", w_gen), ("cos", cos), ("sin", sin)):
        if t.device != device or t.shape[-1] != D:
            raise ValueError(f"pre-processing {name} must be [..., {D}] on {device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    tab_rs = 0 if rows == 1 else D
    ptrs = [w_und.data_ptr(), w_gen.data_ptr(), cos.data_ptr(), sin.data_ptr(),
            rows * D, tab_rs, end_row.data_ptr()]
    return ptrs, (w_und, w_gen, cos, sin, end_row)


def _head_major_kv(q, k, v, head_major: bool, what: str):
    """k, v as [S, Hk, M, D] views (a transpose of [S, M, Hk, D] otherwise,
    read through its strides), checked against q [S, T, H, D]; returns them
    with their (stream, head, key) strides."""
    S, _, H, D = q.shape
    if not head_major:
        k, v = k.transpose(1, 2), v.transpose(1, 2)
    if k.shape != v.shape or k.dim() != 4 or k.shape[0] != S or k.shape[3] != D:
        raise ValueError(f"{what} k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if H % k.shape[1]:
        raise ValueError(f"query heads {H} are not a multiple of kv heads {k.shape[1]}")
    return k, v, _launch.kv_strides(what + " k", k), _launch.kv_strides(what + " v", v)


def _launch_kernel(q, k, v, lens, block_start, causal, q_valid_len, kv_head_major, q_preproc,
                   return_lse):
    S, T, H, D = q.shape
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_block_attention kernel takes head dims {KERNEL_HEAD_DIMS}, got {D}")
    if q_preproc is not None and D != Q_PREPROC_HEAD_DIM:
        raise ValueError(
            f"the q pre-processing kernel (K1b) takes head dim {Q_PREPROC_HEAD_DIM}, got {D}"
        )
    k, v, k_str, v_str = _head_major_kv(q, k, v, kv_head_major, "the")
    Hk, M = k.shape[1], k.shape[2]
    _launch.check_cuda(("q", "k", "v"), (q, k, v), torch.bfloat16)
    if not q.is_contiguous():
        raise ValueError("q must be contiguous [S, T, H, D]")
    _launch.check_index(
        ("lens", "block_start", "q_valid_len"), (lens, block_start, q_valid_len), S, q.device
    )
    out = torch.empty_like(q)
    lse = torch.empty((S, T, H), dtype=torch.float32, device=q.device) if return_lse else None
    lib = cuda_build.load_library()
    args = [
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if return_lse else 0,
        lens.data_ptr(), block_start.data_ptr(), q_valid_len.data_ptr(),
        S, T, H, Hk, D, M, *k_str, *v_str, int(causal), float(D**-0.5),
    ]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if q_preproc is None:
            rc = lib.unimedvl_flash_block_attention_bf16(*args, stream)
            name = "flash_block_attention"
        else:
            pre, _keep = _preproc_args(q_preproc, S, T, q.device)
            rc = lib.unimedvl_flash_block_attention_qpre_bf16(
                *args, *pre, float(q_preproc.get("eps", 1e-6)), stream)
            name = "flash_block_attention (q_preproc)"
    cuda_build.check(rc, name + (" (return_lse)" if return_lse else ""))
    _count("kernel", q_preproc, return_lse)
    return (out, lse) if return_lse else out


def flash_block_attention(
    q: torch.Tensor,  # [S, T, H, D]
    k: torch.Tensor,  # [S, M, Hk, D], or head-major [S, Hk, M, D]
    v: torch.Tensor,
    lens: torch.Tensor,  # [S] int valid context length
    block_start: torch.Tensor,  # [S] int where the query block's keys start
    causal: bool,
    q_valid_len: Optional[torch.Tensor] = None,  # [S] valid block length (<= T)
    kv_head_major: bool = False,
    q_preproc: Optional[dict] = None,
    return_lse: bool = False,
):
    """Attention of the query block over cache plus block; returns [S, T, H, D],
    and with ``return_lse`` (K1c) the pair (out, lse): lse [S, T, H] fp32 is
    the natural-log sum-exp of the scaled logits over the visible keys,
    ``h = hk * G + g``; a row that sees no key has a zero output and lse
    ``NEG_INF`` (float32 min, finite), see the module docstring.

    CUDA tensors go through the kernel (bf16, head dim 72 or 128, 128 with
    ``q_preproc``; anything else raises), CPU tensors through
    :func:`flash_block_attention_ref`. The softmax scale is 1/sqrt(D).
    ``kv_head_major`` says k/v are [S, Hk, M, D] (the KV cache layout);
    otherwise [S, M, Hk, D], which the kernel reads through its strides
    without a transpose copy. ``q_preproc`` (see :func:`preprocess_q`): q is
    the raw projection, and the kernel norms and rotates it first (K1b).
    """
    if q.device.type == "cuda":
        _launch.check_no_grad("flash_block_attention", ("q", "k", "v"), (q, k, v))
        S, T = q.shape[:2]
        return _launch_kernel(
            q, k, v, _launch.per_stream(lens, S, q.device),
            _launch.per_stream(block_start, S, q.device), causal,
            _launch.per_stream(T if q_valid_len is None else q_valid_len, S, q.device),
            kv_head_major, q_preproc, return_lse,
        )
    if q.device.type == "cpu":
        return flash_block_attention_ref(
            q, k, v, lens, block_start, causal, q_valid_len, kv_head_major, q_preproc,
            return_lse,
        )
    raise ValueError(f"flash_block_attention runs on CUDA or CPU tensors, got {q.device}")


# ---------------------------------------------------------------------------
# K6: the cache and the block as separate arrays
# ---------------------------------------------------------------------------

def _block_options(q, k_block, causal, q_preproc, kv_preproc, block_len):
    """The checks of the JAX function, in its order; returns (valid block
    length, the k island's options or None): ``kv_preproc``'s weights with
    cos, sin and end_row defaulting to ``q_preproc``'s."""
    T, Tb = q.shape[1], k_block.shape[1]
    if block_len is None and Tb != T:
        raise ValueError("k_block length != q length requires block_len")
    if causal and block_len is not None:
        raise ValueError("block_len (SP gathered keys) is non-causal only")
    if kv_preproc is None:
        return (Tb if block_len is None else block_len), None
    if q_preproc is None:
        raise ValueError("kv_preproc requires q_preproc (shared tables)")
    kvp = dict(
        q_preproc, w_und=kv_preproc["w_und"], w_gen=kv_preproc["w_gen"],
        cos=kv_preproc.get("cos", q_preproc["cos"]),
        sin=kv_preproc.get("sin", q_preproc["sin"]),
        end_row=kv_preproc.get("end_row", q_preproc.get("end_row")),
    )
    return (Tb if block_len is None else block_len), kvp


def flash_cache_block_attention_ref(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_block: torch.Tensor,
    v_block: torch.Tensor,
    lens: torch.Tensor,
    causal: bool,
    q_preproc: Optional[dict] = None,
    kv_preproc: Optional[dict] = None,
    block_len: Optional[int] = None,
    cache_head_major: bool = False,
) -> torch.Tensor:
    """Plain version of :func:`flash_cache_block_attention`: process q and the
    block's k as the kernel does (:func:`preprocess_q`, the k rounded to the
    cache's dtype), concatenate cache and block, mask, fp32 softmax."""
    cache_block_counts["plain"] += 1
    blk_valid, kvp = _block_options(q, k_block, causal, q_preproc, kv_preproc, block_len)
    if q_preproc is not None:
        q = preprocess_q(q, q_preproc)
    if kvp is not None:
        k_block = preprocess_q(k_block.to(k_cache.dtype), kvp)
    if not cache_head_major:
        k_cache, v_cache = k_cache.transpose(1, 2), v_cache.transpose(1, 2)
    S, T = q.shape[:2]
    M = k_cache.shape[2]
    k_all = torch.cat([k_cache, k_block.to(k_cache.dtype).transpose(1, 2)], dim=2)
    v_all = torch.cat([v_cache, v_block.to(v_cache.dtype).transpose(1, 2)], dim=2)
    mask = _visibility_mask(
        T, k_all.shape[2], _launch.per_stream(lens, S, q.device).clamp(max=M),
        _launch.per_stream(M, S, q.device), _launch.per_stream(blk_valid, S, q.device),
        causal, q.device,
    )
    return gqa_attention_hm(q.float(), k_all.float(), v_all.float(), mask).to(q.dtype)


def _launch_cache_block_kernel(q, k_cache, v_cache, k_block, v_block, lens, causal, q_preproc,
                               kvp, blk_valid, cache_head_major):
    S, T, H, D = q.shape
    if D != Q_PREPROC_HEAD_DIM:
        raise ValueError(
            f"the flash_cache_block_attention kernel (K6) takes head dim {Q_PREPROC_HEAD_DIM}, "
            f"got {D}")
    kc, vc, kc_str, vc_str = _head_major_kv(q, k_cache, v_cache, cache_head_major, "cache")
    kb, vb, kb_str, vb_str = _head_major_kv(q, k_block, v_block, False, "block")
    Hk, M, Tb = kc.shape[1], kc.shape[2], kb.shape[2]
    if kb.shape[1] != Hk:
        raise ValueError(f"the block has {kb.shape[1]} kv heads, the cache {Hk}")
    if M == 0:
        raise ValueError("the cache has no columns: use flash_block_attention on the block")
    _launch.check_cuda(("q", "k_cache", "v_cache", "k_block", "v_block"),
                       (q, kc, vc, kb, vb), torch.bfloat16)
    if not q.is_contiguous():
        raise ValueError("q must be contiguous [S, T, H, D]")
    _launch.check_index(("lens",), (lens,), S, q.device)
    out = torch.empty_like(q)
    lib = cuda_build.load_library()
    q_pre, _keep_q = _preproc_args(q_preproc, S, T, q.device)
    k_pre, _keep_k = _preproc_args(kvp, S, Tb, q.device)
    eps = float((q_preproc or {}).get("eps", 1e-6))
    with torch.cuda.device(q.device):
        rc = lib.unimedvl_flash_cache_block_attention_bf16(
            q.data_ptr(), kc.data_ptr(), vc.data_ptr(), kb.data_ptr(), vb.data_ptr(),
            out.data_ptr(), lens.data_ptr(), S, T, H, Hk, D, M, Tb, int(blk_valid),
            *kc_str, *vc_str, *kb_str, *vb_str, int(causal), float(D**-0.5),
            int(q_preproc is not None), *q_pre, int(kvp is not None), *k_pre, eps,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    cuda_build.check(rc, "flash_cache_block_attention")
    cache_block_counts["kernel"] += 1
    return out


def flash_cache_block_attention(
    q: torch.Tensor,  # [S, T, H, D]
    k_cache: torch.Tensor,  # [S, M, Hk, D], or head-major [S, Hk, M, D]
    v_cache: torch.Tensor,
    k_block: torch.Tensor,  # [S, Tb, Hk, D] the block's own keys
    v_block: torch.Tensor,
    lens: torch.Tensor,  # [S] valid cache length
    causal: bool,
    q_preproc: Optional[dict] = None,
    kv_preproc: Optional[dict] = None,
    block_len: Optional[int] = None,
    cache_head_major: bool = False,
) -> torch.Tensor:
    """Attention over the virtual ``concat(cache[:lens], block)`` without
    building it (K6); returns [S, T, H, D]. The cache keys below ``lens[s]``
    and the block keys below the block's valid length are visible; ``causal``
    adds ``j <= i`` within the block.

    ``cache_head_major``: the cache arrives as [S, Hk, M, D] (the KV cache
    layout); either layout is read in place through its strides, as is the
    block. ``q_preproc``: as in :func:`flash_block_attention`.
    ``kv_preproc``: fuse the k-side island too. ``k_block`` is then the raw
    projection, and the dict holds the k norm's ``w_und``/``w_gen`` and
    optionally ``cos``/``sin`` ([S, 1, D] or [S, Tb, D], indexed by block row)
    and ``end_row`` (in block rows) where the key block is not the query
    block; they default to ``q_preproc``'s, whose ``eps`` is shared, so
    ``kv_preproc`` without ``q_preproc`` raises. The processed k is rounded
    to bf16 before the product, as the path that processes it outside rounds
    it, and never reaches device memory: legal only where the block's k is
    not written to the cache. ``block_len``: the static valid length of a
    key block that is not the query block (sequence parallelism: local
    queries, gathered keys, ``Tb != T``); non-causal only.

    CUDA tensors go through the kernel (bf16, head dim 128; anything else
    raises), CPU tensors through :func:`flash_cache_block_attention_ref`.
    """
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_cache_block_attention runs on CUDA or CPU tensors, got {q.device}")
    if q.device.type == "cpu":
        return flash_cache_block_attention_ref(
            q, k_cache, v_cache, k_block, v_block, lens, causal, q_preproc, kv_preproc,
            block_len, cache_head_major,
        )
    tensors = (q, k_cache, v_cache, k_block, v_block)
    _launch.check_no_grad("flash_cache_block_attention",
                          ("q", "k_cache", "v_cache", "k_block", "v_block"), tensors)
    blk_valid, kvp = _block_options(q, k_block, causal, q_preproc, kv_preproc, block_len)
    return _launch_cache_block_kernel(
        q, k_cache, v_cache, k_block, v_block, _launch.per_stream(lens, q.shape[0], q.device),
        causal, q_preproc, kvp, blk_valid, cache_head_major,
    )
