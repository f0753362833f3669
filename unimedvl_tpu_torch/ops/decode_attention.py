"""K2 and K2-int8: single-token GQA decode attention over the head-major KV
cache.

Port of unimedvl_tpu/ops/decode_attention.py::decode_attention: a bf16 cache
(K2), or an int8 cache with fp32 per-key scales ``k_scale``, ``v_scale``
[S, Hk, M] (K2-int8), where ``logit = (q . k_int8) * k_scale / sqrt(D)`` and the
softmax weight of key j is multiplied by ``v_scale[j]`` before the P V sum, so
the cache is never dequantized. The kernels are CUDA C++ for sm_90a
(``csrc/decode_attention.cu``, one template, two instances, and a combine
kernel); ``decode_attention_ref`` is their plain PyTorch version.

The kernel splits the key axis over CTAs (flash-decoding): ``plan_splits``
picks (n_split, split_len) from S, Hk and M alone, never from ``lens`` or the
band, which live on the device; each split computes fp32 partials (m, l, acc)
and a second launch combines them. ``decode_attention_split_ref`` is the same
partition and combine in plain PyTorch, for the tests.

Visibility, per stream s: key j is visible iff ``j < lens[s]`` or
``base[s] <= j <= col[s]`` with ``band = (base, col)``. generate_text passes
its aligned decode band; serving's scatter decode passes ``(lens, lens)``.

``decode_attention`` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; there is no size threshold and no fallback.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from unimedvl_tpu_torch.ops import _launch, cuda_build
from unimedvl_tpu_torch.ops.attention import NEG_INF, gqa_attention_hm, gqa_attention_quant_hm

# launches of the kernel and calls of the plain version, for showing which ran:
# the bf16 cache (K2) and the int8 cache (K2-int8) count apart
counts = {"kernel": 0, "plain": 0}
int8_counts = {"kernel": 0, "plain": 0}

KERNEL_HEAD_DIM = 128
KERNEL_MAX_GROUP = 8
SPLIT_TILE = 64  # keys per tile of the kernel: a split is a whole number of tiles
TARGET_CTAS = 2 * 132  # about two CTAs per SM of an H100


@functools.lru_cache(maxsize=None, typed=True)  # typed: 5632.0 is no hit for 5632
def plan_splits(S: int, Hk: int, M: int) -> Tuple[int, int]:
    """(n_split, split_len) of the kernel's grid (n_split, Hk, S): split i
    covers keys [i * split_len, (i + 1) * split_len) of the M cache columns.
    About TARGET_CTAS CTAs in all, each a whole number of SPLIT_TILE tiles,
    from the shapes alone: Python ints, never a device tensor (reading lens
    would synchronise the host on every decode call)."""
    for name, x in (("S", S), ("Hk", Hk), ("M", M)):
        if type(x) is not int or x <= 0:
            raise TypeError(f"plan_splits takes positive Python ints, got {name}={x!r}")
    n_tiles = -(-M // SPLIT_TILE)
    per_split = -(-n_tiles // min(n_tiles, -(-TARGET_CTAS // (S * Hk))))
    return -(-n_tiles // per_split), per_split * SPLIT_TILE


def decode_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lens: torch.Tensor,
    band: Tuple[torch.Tensor, torch.Tensor],
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of :func:`decode_attention`: the masked softmax in fp32
    on whatever device the inputs are on. Returns [S, 1, H, D] in q's dtype."""
    quantized = _check_scales(k, v, k_scale, v_scale)
    (int8_counts if quantized else counts)["plain"] += 1
    S, M = q.shape[0], k.shape[2]
    base = _launch.per_stream(band[0], S, q.device)
    col = _launch.per_stream(band[1], S, q.device)
    lens = _launch.per_stream(lens, S, q.device)
    j = torch.arange(M, device=q.device)[None, None, :]
    mask = (j < lens[:, None, None]) | (
        (j >= base[:, None, None]) & (j <= col[:, None, None])
    )
    if quantized:
        return gqa_attention_quant_hm(q, k, k_scale, v, v_scale, mask)
    return gqa_attention_hm(q.float(), k.float(), v.float(), mask).to(q.dtype)


def decode_attention_split_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lens: torch.Tensor,
    band: Tuple[torch.Tensor, torch.Tensor],
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    plan: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, fp32: the keys cut into the
    splits of ``plan`` (default :func:`plan_splits`), each split's partial
    (m, l, acc) with p relative to its own max, masked keys and their v rows
    and v scales taken out by selection; then the combine over the splits
    that saw a key. A stream that sees no key gives 0. Returns [S, 1, H, D]
    in q's dtype."""
    quantized = _check_scales(k, v, k_scale, v_scale)
    S, _, H, D = q.shape
    Hk, M = k.shape[1], k.shape[2]
    n_split, split_len = plan_splits(S, Hk, M) if plan is None else plan
    if n_split * split_len < M:
        raise ValueError(f"{n_split} splits of {split_len} keys do not cover {M} columns")
    dev = q.device
    base = _launch.per_stream(band[0], S, dev)[:, None]
    col = _launch.per_stream(band[1], S, dev)[:, None]
    ln = _launch.per_stream(lens, S, dev)[:, None]
    j = torch.arange(n_split * split_len, device=dev)[None]
    mask = ((j < ln) | ((j >= base) & (j <= col))) & (j < M)  # [S, n_split * split_len]
    pad = n_split * split_len - M

    def padded(t):  # [S, Hk, M, ...] -> [S, Hk, n_split, split_len, ...], fp32
        t = t.float()
        t = torch.cat([t, t.new_zeros(S, Hk, pad, *t.shape[3:])], dim=2) if pad else t
        return t.reshape(S, Hk, n_split, split_len, *t.shape[3:])

    mask = mask.reshape(S, 1, 1, n_split, split_len)
    qg = q[:, 0].reshape(S, Hk, H // Hk, D).float() * D**-0.5
    logits = torch.einsum("shgd,shnjd->shgnj", qg, padded(k))
    if quantized:
        logits = logits * padded(k_scale)[:, :, None]
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1)  # [S, Hk, G, n_split]
    p = torch.where(mask, torch.exp(logits - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    w = torch.where(mask, p * padded(v_scale)[:, :, None], 0.0) if quantized else p
    vm = torch.where(mask[:, 0, :, :, :, None], padded(v), 0.0)
    acc = torch.einsum("shgnj,shnjd->shgnd", w, vm)
    seen = l > 0
    m_all = torch.where(seen, m, NEG_INF).amax(dim=-1, keepdim=True)
    f = torch.where(seen, torch.exp(m - m_all), 0.0)
    out = (f[..., None] * acc).sum(dim=-2) / (f * l).sum(dim=-1).clamp_min(1e-30)[..., None]
    return out.reshape(S, 1, H, D).to(q.dtype)


def _check_scales(k, v, k_scale, v_scale) -> bool:
    """True for an int8 cache with both scales, False for a float cache with
    none; anything between raises."""
    quantized = k.dtype == torch.int8
    if (k_scale is None) != (v_scale is None) or v.dtype != k.dtype:
        raise ValueError("k and v need one dtype, and k_scale and v_scale come together")
    if quantized != (k_scale is not None):
        raise ValueError(
            f"an int8 cache needs k_scale and v_scale, a float cache takes none: got "
            f"{k.dtype} with{'' if k_scale is not None else 'out'} scales"
        )
    if quantized and (k_scale.shape != k.shape[:3] or v_scale.shape != v.shape[:3]):
        raise ValueError(
            f"scales must be [S, Hk, M] = {tuple(k.shape[:3])}, got "
            f"{tuple(k_scale.shape)} and {tuple(v_scale.shape)}"
        )
    return quantized


_BF16_NAMES, _BF16_TYPES = ("q", "k", "v"), (torch.bfloat16,) * 3
_INT8_NAMES = ("q", "k", "v", "k_scale", "v_scale")
_INT8_TYPES = (torch.bfloat16, torch.int8, torch.int8, torch.float32, torch.float32)


def _index(x, S: int, dev: torch.device):
    """A per-stream int32 index for the kernel, and 1 where it is one value
    for every stream: a 0-dim int32 tensor on the device (the decode loop's
    band) is read as it is, without a copy kernel; anything else becomes a
    contiguous int32 [S] tensor through ``per_stream``."""
    if type(x) is torch.Tensor and x.dim() == 0 and x.dtype == torch.int32 and x.device == dev:
        return x, 1
    return _launch.per_stream(x, S, dev), 0


def _launch_kernel(q, k, v, lens, base, col, index_bcast, k_scale=None, v_scale=None):
    # Every check reads only host-side metadata; this runs 28 times per decode
    # step of a host-bound loop, so it is written for few Python calls. lens,
    # base and col come from _index: int32 on q's device, [S] or broadcast.
    S, _, H, D = q.shape
    shape = k.shape
    if shape != v.shape or len(shape) != 4 or shape[0] != S or shape[3] != D:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match q {tuple(q.shape)}")
    Hk, M = shape[1], shape[2]
    if D != KERNEL_HEAD_DIM:
        raise ValueError(f"decode_attention kernel takes head dim {KERNEL_HEAD_DIM}, got {D}")
    if H % Hk or H // Hk > KERNEL_MAX_GROUP:
        raise ValueError(f"{H} query heads over {Hk} kv heads: need a group of at most {KERNEL_MAX_GROUP}")
    quantized = k_scale is not None
    if quantized:  # the scales' shapes were checked by _check_scales
        if not (k_scale.is_contiguous() and v_scale.is_contiguous()):
            name = "v_scale" if k_scale.is_contiguous() else "k_scale"
            raise ValueError(f"{name} must be contiguous fp32 [S, Hk, M]")
        _launch.check_cuda(_INT8_NAMES, (q, k, v, k_scale, v_scale), _INT8_TYPES)
    else:
        _launch.check_cuda(_BF16_NAMES, (q, k, v), _BF16_TYPES)
    dev = q.device
    if not q.is_contiguous():
        raise ValueError("q must be contiguous [S, 1, H, D]")
    k_str, v_str = _launch.kv_strides("k", k), _launch.kv_strides("v", v)
    n_split, split_len = plan_splits(S, Hk, M)
    out = torch.empty_like(q)
    # fp32 partials of the splits: acc [S, Hk, n_split, 8, D], then m and l [S, Hk, n_split, 8]
    part_ptr = None if n_split == 1 else torch.empty(
        S * Hk * n_split * KERNEL_MAX_GROUP * (D + 2), dtype=torch.float32, device=dev
    ).data_ptr()  # freed at return: the caching allocator reuses it after the launches only
    lib = cuda_build.load_library()
    index = dev.index
    with _launch.on_device(index):
        stream = torch._C._cuda_getCurrentRawStream(index)
        if quantized:
            rc = lib.unimedvl_decode_attention_int8(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
                v_scale.data_ptr(), out.data_ptr(),
                lens.data_ptr(), base.data_ptr(), col.data_ptr(), part_ptr,
                S, H, Hk, D, M, n_split, split_len, index_bcast, *k_str, *v_str, D**-0.5, stream,
            )
        else:
            rc = lib.unimedvl_decode_attention_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lens.data_ptr(), base.data_ptr(), col.data_ptr(), part_ptr,
                S, H, Hk, D, M, n_split, split_len, index_bcast, *k_str, *v_str, D**-0.5, stream,
            )
    if rc:
        cuda_build.check(rc, "decode_attention")
    (int8_counts if quantized else counts)["kernel"] += 1
    return out


def decode_attention(
    q: torch.Tensor,  # [S, 1, H, D]
    k: torch.Tensor,  # [S, Hk, M, D] head-major cache layout
    v: torch.Tensor,
    lens: torch.Tensor,  # [S] context lengths
    band: Tuple[torch.Tensor, torch.Tensor],  # (base, col) decoded band, inclusive
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Single-token GQA decode attention; returns [S, 1, H, D]. ``band`` values
    may be scalars or [S]. An int8 cache comes with ``k_scale`` and
    ``v_scale`` [S, Hk, M] fp32. CUDA tensors go through the kernel (bf16 q;
    a bf16 or int8 cache; head dim 128, at most 8 query heads per kv head;
    anything else raises), CPU tensors through :func:`decode_attention_ref`.
    The kernel has no backward: CUDA inputs that require grad, with grad mode
    on, raise."""
    _check_scales(k, v, k_scale, v_scale)
    S, T = q.shape[:2]
    if T != 1:
        raise ValueError(f"decode_attention takes one query token per stream, got {T}")
    dev = q.device
    if dev.type == "cuda":
        _launch.check_no_grad("decode_attention", ("q", "k", "v"), (q, k, v))
        lens, b0 = _index(lens, S, dev)
        base, b1 = _index(band[0], S, dev)
        col, b2 = _index(band[1], S, dev)
        return _launch_kernel(q, k, v, lens, base, col, b0 | b1 << 1 | b2 << 2, k_scale, v_scale)
    if dev.type == "cpu":
        return decode_attention_ref(q, k, v, lens, band, k_scale, v_scale)
    raise ValueError(f"decode_attention runs on CUDA or CPU tensors, got {q.device}")
