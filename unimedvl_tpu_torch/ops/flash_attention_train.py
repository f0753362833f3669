"""K5: differentiable attention for the packed training forward, with the
reference's composable mask (data_utils.py:13-40) evaluated inside the kernels
from three segment-id arrays.

Port of unimedvl_tpu/ops/flash_attention_train.py::packed_train_attention. The
kernels (forward, dq, dk/dv) are CUDA C++ for sm_90a
(``csrc/packed_train_attention.cu``); ``packed_train_attention_ref`` is the
plain PyTorch version (the dense mask of ops/blockmask.py and
``gqa_attention``, differentiated by autograd).

    allowed(q, k) = (q >= k or (fn[q] == fn[k] and fn[q] >= 0))
                    and not (noise[k] >= 0 and noise[q] != noise[k])
                    and doc[q] == doc[k]

``packed_train_attention`` launches the kernels for CUDA tensors (bf16, head
dim 128; anything else raises) through a ``torch.autograd.Function`` and runs
the plain version for CPU tensors; there is no size threshold and no
fallback. The kernels feed bf16 to the tensor cores, accumulate in fp32 and
round the probabilities and ``ds`` to bf16 for the second product of each
chain, so against the plain version on the same bf16 inputs the output agrees
to about 2^-8 of its value and each gradient to about 2^-7 of its row's
largest entry. A query row that may attend to nothing (which no packed batch
produces: every token sees itself) comes out as zero from the kernels and as
the mean of v from the plain version.

The plan, once per forward call (three small launches on the card, no host
synchronisation): every (64, 64) tile pair is classified dead, full or partial,
and listed per 128 query rows (the key tiles they see: the forward's and dq's
sweep) and per 128 keys (the query tiles that see them: dk/dv's), each entry
with the classes of its two 64-row halves, beside the ids as int4 rows and the
order in which the forward takes the query tiles (longest list first);
``tile_plan`` is its Python twin. The forward sweeps only the listed key tiles
(``packed_train_attention_fwd_tiled_ref`` is its partition and online softmax
in plain torch) and the autograd function saves the plan for the backward,
whose own launch takes only ``dsum = sum_d do * out`` in fp32 from the
cotangent rounded to bf16 and the lse in log2 units. The dq kernel sweeps the
forward's lists; the dk/dv kernel is split by query head (one CTA per 64 keys
and head, over the list of the 128 keys around them), writes fp32 partials to
a workspace of ``H * T_pad * D * 8`` bytes, and a combine launch adds the G
partials of each KV head in head order: no atomics, the same bits on every
run. ``packed_train_attention_bwd_tiled_ref`` is that partition and order in
plain torch.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch.autograd.function import once_differentiable

from unimedvl_tpu_torch.ops import _launch, cuda_build
from unimedvl_tpu_torch.ops.attention import gqa_attention
from unimedvl_tpu_torch.ops.blockmask import dense_packed_mask

# launches of each kernel and calls of the plain version, for showing which ran
counts = {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0, "plain": 0}

KERNEL_HEAD_DIM = 128
TILE = 64  # rows of a tile of the plan
CTA_ROWS = 128  # rows a CTA owns: query rows (forward, dq) or keys (dk/dv)
DEAD, PARTIAL, FULL = 0, 1, 2  # classes of a (TILE, TILE) pair
ENTRY_SHIFT = 16  # a list entry: tile | (class of the first half | class of the second << 2) << 16


def packed_train_attention_ref(
    q: torch.Tensor,  # [T, H, D]
    k: torch.Tensor,  # [T, Hk, D]
    v: torch.Tensor,
    doc_id: torch.Tensor,  # [T] int
    fn_id: torch.Tensor,
    noise_id: torch.Tensor,
) -> torch.Tensor:
    """Plain version of :func:`packed_train_attention`: the dense [T, T] mask
    and a masked softmax in fp32, on whatever device and in whatever dtype the
    inputs are; autograd differentiates it. Returns [T, H, D] in q's dtype."""
    counts["plain"] += 1
    mask = dense_packed_mask(doc_id, fn_id, noise_id)
    return gqa_attention(q[None], k[None], v[None], mask[None])[0]


def _allowed(i, j, ids, T: int) -> torch.Tensor:
    """The segment rule for query rows ``i`` [n, 1] and keys ``j`` [1, m] of a
    sequence of T tokens, from ids = (doc, fn, noise) padded past T; rows at or
    past T see nothing and are seen by nothing."""
    d, f, z = ids
    return ((i < T) & (j < T) & ((i >= j) | ((f[i] == f[j]) & (f[i] >= 0)))
            & ~((z[j] >= 0) & (z[i] != z[j])) & (d[i] == d[j]))


def _padded_ids(doc_id, fn_id, noise_id, t_pad: int):
    T = doc_id.shape[0]
    return tuple(torch.cat([x.to(torch.int32), x.new_zeros(t_pad - T, dtype=torch.int32)])
                 for x in (doc_id, fn_id, noise_id))


def tile_classes(doc_id: torch.Tensor, fn_id: torch.Tensor, noise_id: torch.Tensor) -> torch.Tensor:
    """int32 [n64, n64]: the class of every (query tile, key tile) pair of TILE
    rows on the grid of CTA_ROWS (n64 = 2 ceil(T / 128)): DEAD (no allowed
    pair), FULL (every pair allowed and every row below T) or PARTIAL, from the
    segment rule evaluated per element, as the plan launch does."""
    T = doc_id.shape[0]
    n64 = 2 * -(-T // CTA_ROWS)
    t_pad = n64 * TILE
    idx = torch.arange(t_pad, device=doc_id.device)
    ok = _allowed(idx[:, None], idx[None, :], _padded_ids(doc_id, fn_id, noise_id, t_pad), T)
    tiles = ok.view(n64, TILE, n64, TILE)
    live, full = tiles.any(dim=3).any(dim=1), tiles.all(dim=3).all(dim=1)
    return torch.where(full, FULL, torch.where(live, PARTIAL, DEAD)).to(torch.int32)


def tile_plan(doc_id: torch.Tensor, fn_id: torch.Tensor, noise_id: torch.Tensor):
    """Python twin of the plan launch's lists: (dq_list, dq_count,
    dkv_list, dkv_count), int32 on the ids' device, depending on the ids and T
    alone. Row x of dq_list [n128, n64] lists the key tiles (of TILE rows) that
    query rows [128 x, 128 x + 128) see (the forward's and dq's sweep), in
    order, as tile | (class of rows 0-63 | class of rows 64-127 << 2) <<
    ENTRY_SHIFT; row x of dkv_list lists
    the query tiles that see keys [128 x, 128 x + 128), with the classes of the
    two 64-key halves. Entries past a row's count are -1 here (the launch
    leaves them unwritten)."""
    cls = tile_classes(doc_id, fn_id, noise_id)
    dq_codes = cls[0::2] | cls[1::2] << 2  # [n128, n64]: query tile pairs over key tiles
    dkv_codes = (cls[:, 0::2] | cls[:, 1::2] << 2).t()  # key tile pairs over query tiles

    def compact(codes):
        n128, n64 = codes.shape
        live = codes != DEAD
        cols = torch.arange(n64, dtype=torch.int32, device=codes.device).expand(n128, n64)
        order = torch.argsort(torch.where(live, cols, cols + n64), dim=1)
        entries = torch.gather(cols | codes << ENTRY_SHIFT, 1, order)
        count = live.sum(dim=1, dtype=torch.int32)
        return torch.where(cols < count[:, None], entries, -1), count

    return (*compact(dq_codes), *compact(dkv_codes))


def query_tile_order(dq_count: torch.Tensor) -> torch.Tensor:
    """The order in which the forward's grid takes the query tiles: longest
    dq list first, ties by index (the plan launch's ``dq_order``)."""
    return torch.argsort(-dq_count.long(), stable=True).to(torch.int32)


def packed_train_attention_fwd_tiled_ref(q, k, v, doc_id, fn_id, noise_id):
    """The forward kernel's partition and arithmetic in plain torch, fp32:
    per 128 query rows, each 64-row half sweeps the key tiles of the dq list
    of :func:`tile_plan` in order, skips a dead half and masks a partial one
    (a masked logit becomes the float32 minimum and weighs 0), and keeps an
    online softmax in log2 units (logits times scale * log2 e; a row maximum
    that moves rescales the sums by 2^(m_old - m_new)); p is rounded to q's
    dtype for P V, as the kernel does. Returns out [T, H, D] and lse [H, T]
    in natural log (fp32); a row that sees nothing gives 0 and the float32
    minimum."""
    T, H, D = q.shape
    G = H // k.shape[1]
    sl2 = D**-0.5 * 1.4426950408889634
    neg = torch.finfo(torch.float32).min
    dq_list, dq_count, _, _ = tile_plan(doc_id, fn_id, noise_id)
    t_pad = dq_count.shape[0] * CTA_ROWS
    ids = _padded_ids(doc_id, fn_id, noise_id, t_pad)

    def pad(x, heads_rep):
        x = x.float().repeat_interleave(heads_rep, dim=1)
        return torch.cat([x, x.new_zeros((t_pad - T, *x.shape[1:]))])

    qf, kf, vf = pad(q, 1), pad(k, G), pad(v, G)
    idx = torch.arange(t_pad, device=q.device)
    out = torch.zeros(t_pad, H, D, device=q.device)
    lse = torch.zeros(H, t_pad, device=q.device)
    for x in range(dq_count.shape[0]):
        for half in range(2):
            rows = idx[x * CTA_ROWS + half * TILE:][:TILE]
            m = torch.full((H, TILE), neg, device=q.device)
            l = torch.zeros(H, TILE, device=q.device)
            o = torch.zeros(H, TILE, D, device=q.device)
            for e in dq_list[x, :int(dq_count[x])].tolist():
                cls = (e >> (ENTRY_SHIFT + 2 * half)) & 3
                if cls == DEAD:
                    continue
                keys = idx[(e & 0xFFFF) * TILE:][:TILE]
                s = torch.einsum("ihd,jhd->hij", qf[rows], kf[keys])
                if cls == PARTIAL:
                    s = torch.where(_allowed(rows[:, None], keys[None, :], ids, T), s, neg)
                mx = s.amax(dim=-1)
                mn = torch.where(mx > neg, torch.maximum(m, mx * sl2), m)
                al = torch.where(mn != m, torch.exp2(m - mn), 1.0)
                p = torch.exp2(s * sl2 - mn[..., None])
                if cls == PARTIAL:
                    p = torch.where(s > neg, p, 0.0)
                l = l * al + p.sum(dim=-1)
                o = o * al[..., None] + torch.einsum("hij,jhd->hid", p.to(q.dtype).float(),
                                                     vf[keys])
                m = mn
            out[rows] = (o / l.clamp_min(1e-30)[..., None]).transpose(0, 1)
            lse[:, rows] = torch.where(l > 0, (m + torch.log2(l)) * 0.6931471805599453, neg)
    return out[:T], lse[:, :T]


def packed_train_attention_bwd_tiled_ref(q, k, v, doc_id, fn_id, noise_id, grad_out):
    """The backward kernels' partition and order in plain torch, fp32 sums:
    the forward's out and lse from the dense mask, dsum from the cotangent,
    then dq per 128 query rows over the key tiles of :func:`tile_plan`,
    and dk/dv per 64 keys split by query head over the query tiles listed for
    them, the splits' partials added in head order. A dead half is skipped, the mask
    is applied on partial halves only, and p and ds are rounded to q's dtype
    for the second product of each chain, as the kernels do. Returns (dq, dk,
    dv) fp32."""
    T, H, D = q.shape
    Hk = k.shape[1]
    G, scale = H // Hk, D**-0.5
    dq_list, dq_count, dkv_list, dkv_count = tile_plan(doc_id, fn_id, noise_id)
    t_pad = dq_count.shape[0] * CTA_ROWS
    ids = _padded_ids(doc_id, fn_id, noise_id, t_pad)

    def pad(x):
        x = x.float()
        return torch.cat([x, x.new_zeros((t_pad - T, *x.shape[1:]))])

    qf, kf, vf, do = pad(q), pad(k), pad(v), pad(grad_out.to(q.dtype))
    # the forward's outputs, as the forward kernel gives them (every row sees itself)
    mask = dense_packed_mask(doc_id, fn_id, noise_id)
    logits = torch.einsum("ihd,jhd->hij", qf[:T], kf[:T].repeat_interleave(G, dim=1)) * scale
    logits = torch.where(mask, logits, -torch.inf)
    lse = torch.logsumexp(logits, dim=-1)  # [H, T]
    out = torch.einsum("hij,jhd->ihd", torch.softmax(logits, dim=-1),
                       vf[:T].repeat_interleave(G, dim=1)).to(q.dtype).float()
    dsum = (do[:T] * out).sum(dim=-1).t()
    lse_p = torch.cat([lse, lse.new_zeros(H, t_pad - T)], dim=1)
    dsum_p = torch.cat([dsum, dsum.new_zeros(H, t_pad - T)], dim=1)
    idx = torch.arange(t_pad, device=q.device)

    def chain(qr, kc, vc, dor, lse_r, dsum_r, cls, rows, keys):
        """p and ds [heads, rows, keys] of one (64, 64) pair."""
        s = torch.einsum("ihd,jhd->hij", qr, kc) * scale
        p = torch.exp(s - lse_r[..., None])
        if cls == PARTIAL:
            p = torch.where(_allowed(rows[:, None], keys[None, :], ids, T), p, 0.0)
        dp = torch.einsum("ihd,jhd->hij", dor, vc)
        return p, p * (dp - dsum_r[..., None])

    def rnd(x):
        return x.to(q.dtype).float()

    dq = torch.zeros(t_pad, H, D, device=q.device)
    for x in range(dq_count.shape[0]):
        for e in dq_list[x, :int(dq_count[x])].tolist():
            keys = idx[(e & 0xFFFF) * TILE:][:TILE]
            kc = kf[keys].repeat_interleave(G, dim=1)
            for half in range(2):
                cls = (e >> (ENTRY_SHIFT + 2 * half)) & 3
                if cls == DEAD:
                    continue
                rows = idx[x * CTA_ROWS + half * TILE:][:TILE]
                _, ds = chain(qf[rows], kc, vf[keys].repeat_interleave(G, dim=1), do[rows],
                              lse_p[:, rows], dsum_p[:, rows], cls, rows, keys)
                dq[rows] += torch.einsum("hij,jhd->ihd", rnd(ds), kc)

    ws = torch.zeros(2, G, t_pad, Hk, D, device=q.device)
    for x in range(dkv_count.shape[0]):
        for gh in range(G):  # the split: query head hk * G + gh of every KV head
            heads = gh + G * torch.arange(Hk, device=q.device)
            for e in dkv_list[x, :int(dkv_count[x])].tolist():
                rows = idx[(e & 0xFFFF) * TILE:][:TILE]
                for half in range(2):
                    cls = (e >> (ENTRY_SHIFT + 2 * half)) & 3
                    if cls == DEAD:
                        continue
                    keys = idx[x * CTA_ROWS + half * TILE:][:TILE]
                    qr, dor = qf[rows][:, heads], do[rows][:, heads]
                    p, ds = chain(qr, kf[keys], vf[keys], dor, lse_p[heads][:, rows],
                                  dsum_p[heads][:, rows], cls, rows, keys)
                    ws[0, gh, keys] += torch.einsum("hij,ihd->jhd", rnd(ds), qr)
                    ws[1, gh, keys] += torch.einsum("hij,ihd->jhd", rnd(p), dor)
    dk, dv = ws[0, 0], ws[1, 0]
    for gh in range(1, G):  # the combine's order
        dk, dv = dk + ws[0, gh], dv + ws[1, gh]
    return dq[:T] * scale, dk[:T] * scale, dv[:T]


def _mapped(t: torch.Tensor) -> torch.Tensor:
    """``t`` [T, heads, D] as the kernels' tensor maps read it: D contiguous,
    row and head strides positive multiples of 16 bytes, a 16-byte aligned
    start; copied only when it is not so."""
    per_load = _launch.LOAD_BYTES // t.element_size()
    if (t.stride(2) == 1 and all(s > 0 and s % per_load == 0 for s in t.stride()[:2])
            and t.data_ptr() % _launch.LOAD_BYTES == 0):
        return t
    return t.contiguous()


def _ids(x: torch.Tensor, T: int, device: torch.device, name: str) -> torch.Tensor:
    if x.shape != (T,) or x.device != device:
        raise ValueError(f"{name} must be [{T}] on {device}, got {tuple(x.shape)} on {x.device}")
    return x.to(torch.int32).contiguous()


def _check(q, k, v) -> Tuple[int, int, int, int]:
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[2] != q.shape[2]:
        raise ValueError(
            f"expected q [T, H, D] and k, v [T, Hk, D], got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}")
    T, H, D = q.shape
    Hk = k.shape[1]
    if D != KERNEL_HEAD_DIM:
        raise ValueError(f"the packed training attention kernels take head dim "
                         f"{KERNEL_HEAD_DIM}, got {D}")
    if H % Hk:
        raise ValueError(f"query heads {H} are not a multiple of kv heads {Hk}")
    _launch.check_cuda(("q", "k", "v"), (q, k, v), torch.bfloat16)
    return T, H, Hk, D


class Plan(NamedTuple):
    """What the plan launch writes for one sequence (T_pad = 128 n128): ids4
    int32 [T_pad, 4] (doc, fn, noise, 0; zeros past T), the lists of
    :func:`tile_plan` (entries past each count are not written) and dq_order
    int32 [n128] (:func:`query_tile_order`)."""
    ids4: torch.Tensor
    dq_list: torch.Tensor
    dq_count: torch.Tensor
    dkv_list: torch.Tensor
    dkv_count: torch.Tensor
    dq_order: torch.Tensor


def _launch_plan(doc, fn, nz) -> Plan:
    """The plan launch (three kernels, no host synchronisation) from the ids
    (contiguous int32 [T] on the card)."""
    T, dev = doc.shape[0], doc.device
    n128 = -(-T // CTA_ROWS)
    n64 = 2 * n128
    ids4 = torch.empty((n64 * TILE, 4), dtype=torch.int32, device=dev)
    states = torch.empty((n64, n64), dtype=torch.uint8, device=dev)
    lists = torch.empty((2, n128, n64), dtype=torch.int32, device=dev)
    counts = torch.empty((3, n128), dtype=torch.int32, device=dev)  # dq, dk/dv, dq order
    lib = cuda_build.load_library()
    with torch.cuda.device(dev):
        rc = lib.unimedvl_packed_train_attention_plan(
            doc.data_ptr(), fn.data_ptr(), nz.data_ptr(), ids4.data_ptr(), states.data_ptr(),
            lists[0].data_ptr(), counts[0].data_ptr(), lists[1].data_ptr(),
            counts[1].data_ptr(), counts[2].data_ptr(), T,
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, "packed_train_attention (plan)")
    return Plan(ids4, lists[0], counts[0], lists[1], counts[1], counts[2])


def _launch_fwd(q, k, v, doc, fn, nz):
    """The plan launch, then the forward kernel over the plan's dq lists:
    (out [T, H, D] bf16, lse [H, T] fp32, the plan). q, k, v in any strides
    :func:`_mapped` passes."""
    T, H, Hk, D = _check(q, k, v)
    plan = _launch_plan(doc, fn, nz)
    out = torch.empty((T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((H, T), dtype=torch.float32, device=q.device)
    lib = cuda_build.load_library()
    with torch.cuda.device(q.device):
        rc = lib.unimedvl_packed_train_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            plan.ids4.data_ptr(), plan.dq_list.data_ptr(), plan.dq_count.data_ptr(),
            plan.dq_order.data_ptr(), T, H, Hk, D, q.stride(0), q.stride(1), k.stride(0),
            k.stride(1), v.stride(0), v.stride(1), float(D**-0.5),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    cuda_build.check(rc, "packed_train_attention (forward)")
    counts["fwd"] += 1
    return out, lse, plan


def _launch_rows(do, out, lse):
    """The backward's row data: (lse2, dsum), fp32 [H, T_pad]: lse in log2
    units (+inf where lse is the float32 minimum, 0 past T) and dsum =
    sum_d do * out (0 past T), from the bf16 cotangent ``do`` (any strides
    :func:`_mapped` passes), ``out`` [T, H, D] contiguous and ``lse`` [H, T]."""
    T, H, D = out.shape
    t_pad = -(-T // CTA_ROWS) * CTA_ROWS
    lse2, dsum = (torch.empty((H, t_pad), dtype=torch.float32, device=out.device)
                  for _ in range(2))
    lib = cuda_build.load_library()
    with torch.cuda.device(out.device):
        rc = lib.unimedvl_packed_train_attention_bwd_rows(
            do.data_ptr(), out.data_ptr(), lse.data_ptr(), lse2.data_ptr(), dsum.data_ptr(),
            T, H, D, do.stride(0), do.stride(1), torch.cuda.current_stream(out.device).cuda_stream)
    cuda_build.check(rc, "packed_train_attention (backward rows)")
    return lse2, dsum


def _launch_bwd(q, k, v, out, lse, plan: Plan, grad_out, need_dq: bool, need_dkv: bool):
    """The backward kernels over the forward's plan: (dq or None, dk or None,
    dv or None). The row launch runs first; the kernels read the cotangent
    rounded to q's dtype, as the TPU kernels do, and ``dsum`` is taken from
    it."""
    T, H, Hk, D = _check(q, k, v)
    do = _mapped(grad_out.to(q.dtype))
    _launch.check_cuda(("grad_out", "out"), (do, out), torch.bfloat16)
    if not out.is_contiguous() or out.shape != q.shape:
        raise ValueError("out must be the forward's contiguous [T, H, D] output")
    lse2, dsum = _launch_rows(do, out, lse)
    lib = cuda_build.load_library()
    common = (T, H, Hk, D, q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
              v.stride(1), do.stride(0), do.stride(1), float(D**-0.5))
    rows = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse2.data_ptr(),
            dsum.data_ptr(), plan.ids4.data_ptr())
    dq = dk = dv = None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if need_dq:
            dq = torch.empty((T, H, D), dtype=q.dtype, device=q.device)
            rc = lib.unimedvl_packed_train_attention_bwd_dq(
                *rows, plan.dq_list.data_ptr(), plan.dq_count.data_ptr(), dq.data_ptr(), *common,
                stream)
            cuda_build.check(rc, "packed_train_attention (dq)")
            counts["bwd_dq"] += 1
        if need_dkv:
            ws = torch.empty((2, H // Hk, Hk, plan.ids4.shape[0], D), dtype=torch.float32,
                             device=q.device)
            dk = torch.empty((T, Hk, D), dtype=k.dtype, device=q.device)
            dv = torch.empty((T, Hk, D), dtype=v.dtype, device=q.device)
            rc = lib.unimedvl_packed_train_attention_bwd_dkv(
                *rows, plan.dkv_list.data_ptr(), plan.dkv_count.data_ptr(), ws.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), *common, stream)
            cuda_build.check(rc, "packed_train_attention (dk/dv)")
            counts["bwd_dkv"] += 1
    return dq, dk, dv


class _PackedTrainAttention(torch.autograd.Function):
    """The kernels under autograd: the forward saves q, k, v, out, lse and
    the plan it swept; the backward is not itself differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, doc, fn, nz):
        q, k, v = _mapped(q), _mapped(k), _mapped(v)
        out, lse, plan = _launch_fwd(q, k, v, doc, fn, nz)
        ctx.save_for_backward(q, k, v, out, lse, *plan)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        q, k, v, out, lse, *plan = ctx.saved_tensors
        need = ctx.needs_input_grad
        dq, dk, dv = _launch_bwd(q, k, v, out, lse, Plan(*plan), grad_out,
                                 need[0], need[1] or need[2])
        return dq, dk if need[1] else None, dv if need[2] else None, None, None, None


def packed_train_attention(
    q: torch.Tensor,  # [T, H, D]
    k: torch.Tensor,  # [T, Hk, D]
    v: torch.Tensor,  # [T, Hk, D]
    doc_id: torch.Tensor,  # [T] int
    fn_id: torch.Tensor,  # [T] int
    noise_id: torch.Tensor,  # [T] int
) -> torch.Tensor:
    """Packed training attention under the segment mask; returns [T, H, D] in
    q's dtype, differentiable in q, k and v (the ids carry no gradient).

    CUDA tensors go through the kernels (bf16, head dim 128; anything else
    raises), CPU tensors through :func:`packed_train_attention_ref`. The
    softmax scale is 1/sqrt(D)."""
    if q.device.type == "cuda":
        T = q.shape[0]
        ids = [_ids(x, T, q.device, name) for x, name in
               ((doc_id, "doc_id"), (fn_id, "fn_id"), (noise_id, "noise_id"))]
        return _PackedTrainAttention.apply(q, k, v, *ids)
    if q.device.type == "cpu":
        return packed_train_attention_ref(q, k, v, doc_id, fn_id, noise_id)
    raise ValueError(f"packed_train_attention runs on CUDA or CPU tensors, got {q.device}")
