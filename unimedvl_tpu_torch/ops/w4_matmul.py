"""K4: packed-int4 weight matmul (w4a8 and weight-only w4).

Port of unimedvl_tpu/ops/w4_matmul.py::w4_matmul. The kernel is CUDA C++ for
sm_90a (``csrc/w4_matmul.cu``); ``w4_matmul_ref`` is its plain PyTorch
version.

    y = (x @ unpack(wp).T) * x_scale * w_scale

Storage. The port keeps weights as ``nn.Linear`` does, [out, in]; packing runs
along the contraction dim, which is the last one here: ``wp`` is [N, K/2] int8
and byte ``r`` of a row holds in-row ``2r`` in its low nibble and ``2r + 1`` in
its high nibble, both signed in [-8, 7]. That is the JAX package's byte
content ([K/2, N] there) transposed, so ``pack_int4(q) ==
jax_pack_int4(q.T).T``. ``w_scale`` is fp32 [N] per output channel, or [G, N]
for groups of K/G in-rows, as in the JAX package.

Arithmetic, which the plain version and the kernel share:

- int8 x (w4a8): the products accumulate in int32, exactly. Per channel the
  whole K accumulates first, then ``float(acc) * x_scale * w_scale`` in that
  order, so kernel and plain version agree bit for bit. Grouped: each group's
  int32 sum is scaled by the group's ``w_scale`` and the groups add in fp32
  in group order; ``x_scale`` multiplies last.
- bf16 x (weight-only w4, ``x_scale=None``): the nibbles widen to bf16
  exactly and the products accumulate in fp32; the order of that sum differs
  between kernel and plain version. Per channel the sum is scaled once;
  grouped, each group's sum is scaled (rounded multiply) and added (rounded
  add) in group order.

``w4_matmul`` launches the kernel for CUDA tensors and runs the plain version
for CPU tensors. On the card, m <= 4 rows take a weight stream on ``mma.sync``
split evenly over the SMs: units of 32 weight rows by one slice of in-rows,
a contiguous share of them per warp (``gemv_plan``), slice sums in a
workspace, and the warp that brings a tile's last slice adding the slices in
order, or for the small projections one CTA per tile adding them in shared
memory (``w4_gemv_tiled_ref`` is that partition and combine in plain torch).
More rows take a GEMM on ``wgmma`` fed by a TMA ring: with int8 x the weights
are spread from packed bytes into the register operand
(``w4a8_gemm_tiled_ref`` is that partition in plain torch); with bf16 x they
are widened into a bf16 tile in shared memory, each nibble through the
mantissa of 128.0 (``widen_nibbles_twin``; the GEMV widens the same way in
registers). A shape the kernel does not take raises: there is no threshold
and no fallback.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from unimedvl_tpu_torch.ops import _launch, cuda_build

# launches of the kernel and calls of the plain version, for showing which ran
counts = {"kernel": 0, "plain": 0}

KERNEL_K_MULTIPLE = 64  # one k-step of the kernel: 32 packed bytes of a weight row
KERNEL_N_MULTIPLE = 8
# the int8-x GEMM's partition: a CTA's weight rows, its x rows per channel and with group
# scales, and the in-rows of one product (a stage holds four)
GEMM_W_ROWS, GEMM_X_ROWS, GEMM_X_ROWS_GROUPED, GEMM_K_STEP = 128, 256, 128, 32
# the GEMV: the most x rows it takes, the weight rows of a unit, the in-rows of a unit's slice
# (the first that divides the group, or K per channel), its workers (warps) per SM, the most
# slices of a tile combined in one CTA, and the arrival counters kept per card (one a tile:
# N < 65536 x 128, which the kernel's argument checks hold, makes at most 2^18 tiles)
GEMV_MAX_ROWS, GEMV_COLS, GEMV_SLICES = 4, 32, (512, 256, 128, 64)
GEMV_WARPS_PER_SM, GEMV_TILE_CTA_SLICES, GEMV_MAX_TILES = 16, 8, 1 << 18


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int8-stored int4 values in [-8, 7] along the last dim:
    [.., N, K] -> [.., N, K/2], byte r = (q[2r] & 0xF) | (q[2r + 1] << 4)."""
    if q.dtype != torch.int8 or q.shape[-1] % 2:
        raise ValueError(f"pack_int4 takes int8 with an even last dim, got {q.dtype} {tuple(q.shape)}")
    lo = q[..., 0::2]
    hi = q[..., 1::2]
    return (lo & 0x0F) | (hi << 4)


def unpack_int4(wp: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: [.., N, K/2] int8 -> [.., N, K] int8 in
    [-8, 7] (arithmetic shifts on the signed byte)."""
    lo = (wp << 4) >> 4
    hi = wp >> 4
    return torch.stack([lo, hi], dim=-1).reshape(*wp.shape[:-1], 2 * wp.shape[-1])


def widen_nibbles_twin(wp: torch.Tensor) -> torch.Tensor:
    """The bf16-x GEMM's widening of packed weights, bit for bit in plain
    torch: [.., N, K/2] int8 -> [.., N, K] bf16, equal to ``unpack_int4``.
    Per 32-bit word w of a packed row (bytes in memory order), x = w ^
    0x88888888 biases each signed nibble n to n + 8; for byte b, byte b of x
    (low nibble: in-row 2b) and of x >> 4 (low nibble: in-row 2b + 1) land in
    the two 16-bit halves, are masked to their low nibble and OR'd into the
    mantissa of bf16 128.0 (0x4300), and 136 (0x4308) is subtracted in bf16.
    Used by nothing on the main path."""
    if wp.dtype != torch.int8 or wp.shape[-1] % 4:
        raise ValueError(f"widen_nibbles_twin takes int8 rows of whole words, got {wp.dtype} "
                         f"{tuple(wp.shape)}")
    b = wp.to(torch.int64) & 0xFF
    words = b.reshape(*wp.shape[:-1], -1, 4)
    w = words[..., 0] | (words[..., 1] << 8) | (words[..., 2] << 16) | (words[..., 3] << 24)
    x = w ^ 0x88888888
    sh = x >> 4
    halves = []
    for byte in range(4):
        v = ((x >> (8 * byte)) & 0xF) | (((sh >> (8 * byte)) & 0xF) << 16) | 0x43004300
        halves += [v & 0xFFFF, v >> 16]  # in-row 2b, in-row 2b + 1
    bits = torch.stack(halves, dim=-1).reshape(*wp.shape[:-1], 2 * wp.shape[-1])
    as_bf16 = bits.to(torch.int16).view(torch.bfloat16)  # 0x43xx: below 2^15, no wrap
    return as_bf16 - torch.tensor(136.0, dtype=torch.bfloat16)


def _n_groups(w_scale: torch.Tensor, N: int, K: int) -> int:
    """0 for per-channel scales [N] (or [1, N]), else G of [G, N]."""
    if w_scale.dim() == 1 or (w_scale.dim() == 2 and w_scale.shape[0] == 1):
        if w_scale.shape[-1] != N:
            raise ValueError(f"w_scale {tuple(w_scale.shape)} does not match N = {N}")
        return 0
    if w_scale.dim() != 2 or w_scale.shape[1] != N or K % w_scale.shape[0]:
        raise ValueError(f"w_scale {tuple(w_scale.shape)} does not match wp: N = {N}, K = {K}")
    return w_scale.shape[0]


def w4_matmul_ref(
    x: torch.Tensor,
    x_scale: Optional[torch.Tensor],
    wp: torch.Tensor,
    w_scale: torch.Tensor,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Plain version of :func:`w4_matmul`, on whatever device the inputs are
    on. Integer x takes an int32 matmul on the CPU; on the card, where
    PyTorch has no integer matmul of any shape, it takes fp64, in which
    every partial sum (below 2^53) is exact as well."""
    counts["plain"] += 1
    N, K = wp.shape[0], 2 * wp.shape[1]
    m = x.numel() // K
    x2 = x.reshape(m, K)
    w = unpack_int4(wp)  # [N, K]
    G = _n_groups(w_scale, N, K)
    int_x = x.dtype == torch.int8
    if int_x != (x_scale is not None):
        raise ValueError("int8 x comes with x_scale, float x without")

    def dot(xs, ws):  # [m, k] x [N, k] -> [m, N] fp32 (exact for int8 x)
        if not int_x:
            return xs.float() @ ws.float().t()
        wide = torch.int32 if xs.device.type == "cpu" else torch.float64
        return (xs.to(wide) @ ws.to(wide).t()).float()

    ws32 = w_scale.float().reshape(max(G, 1), N)
    if G:
        g = K // G
        acc = torch.zeros(m, N, dtype=torch.float32, device=x.device)
        for i in range(G):
            acc = acc + dot(x2[:, i * g:(i + 1) * g], w[:, i * g:(i + 1) * g]) * ws32[i]
        y = acc if x_scale is None else acc * x_scale.reshape(m, 1).float()
    else:
        y = dot(x2, w)
        if x_scale is not None:
            y = y * x_scale.reshape(m, 1).float()
        y = y * ws32[0]
    return y.to(out_dtype).reshape(*x.shape[:-1], N)


def w4a8_gemm_tiled_ref(x, x_scale, wp, w_scale, out_dtype=torch.bfloat16) -> torch.Tensor:
    """The int8-x GEMM's partition (m > 4) in plain torch on the CPU:
    y^T = W x^T per tile of GEMM_W_ROWS weight rows by GEMM_X_ROWS x rows
    (GEMM_X_ROWS_GROUPED with group scales), the weights as the kernel's
    registers hold them (signed bytes, 16 times each nibble), int32 sums over
    products of GEMM_K_STEP in-rows in k order, shifted right by 4; with group
    scales each group's sum is flushed at its end into an fp32 sum (rounded
    multiply by the group's scale, rounded add); then the epilogue's order:
    float(acc) * x_scale * w_scale per channel, fp32 sum * x_scale grouped.
    Equal to :func:`w4_matmul_ref` bit for bit. Counts as no call of either
    version."""
    N, K = wp.shape[0], 2 * wp.shape[1]
    m = x.numel() // K
    G = _n_groups(w_scale, N, K)
    gsize = K // G if G else K
    rows = GEMM_X_ROWS_GROUPED if G else GEMM_X_ROWS
    x2 = x.reshape(m, K).to(torch.int32)
    xs = x_scale.reshape(m).float()
    w16 = unpack_int4(wp).to(torch.int32) * 16
    ws = w_scale.float().reshape(max(G, 1), N)
    y = torch.empty(m, N, dtype=out_dtype)
    for m0 in range(0, m, rows):
        xt = x2[m0:m0 + rows]
        for n0 in range(0, N, GEMM_W_ROWS):
            wt = w16[n0:n0 + GEMM_W_ROWS]
            acc = torch.zeros(wt.shape[0], xt.shape[0], dtype=torch.int32)
            facc = torch.zeros(acc.shape)
            for k in range(0, K, GEMM_K_STEP):
                acc += wt[:, k:k + GEMM_K_STEP] @ xt[:, k:k + GEMM_K_STEP].t()
                if G and (k + GEMM_K_STEP) % gsize == 0:
                    scale = ws[(k + GEMM_K_STEP) // gsize - 1, n0:n0 + GEMM_W_ROWS, None]
                    facc = facc + (acc >> 4).float() * scale
                    acc.zero_()
            if G:
                yt = facc * xs[None, m0:m0 + rows]
            else:
                yt = (acc >> 4).float() * xs[None, m0:m0 + rows] * ws[0, n0:n0 + GEMM_W_ROWS, None]
            y[m0:m0 + rows, n0:n0 + GEMM_W_ROWS] = yt.t().to(out_dtype)
    return y.reshape(*x.shape[:-1], N)


class GemvPlan(NamedTuple):
    """The GEMV's partition: unit u is (weight-row tile u // n_slices, slice
    u % n_slices), GEMV_COLS weight rows by ``slice_k`` in-rows; worker (a
    warp of the grid) w takes the units ``units(w)``."""
    slice_k: int
    n_slices: int
    n_tiles: int
    n_units: int
    n_workers: int
    tile_ctas: bool  # one CTA per tile, a warp per slice, combined in shared memory

    def units(self, worker: int) -> range:
        return range(self.n_units * worker // self.n_workers,
                     self.n_units * (worker + 1) // self.n_workers)


@functools.lru_cache(maxsize=None, typed=True)
def gemv_plan(m: int, K: int, N: int, G: int, n_sms: int, bf16_x: bool = False) -> GemvPlan:
    """The partition of the GEMV (m <= GEMV_MAX_ROWS rows) over the warps of
    ``n_sms`` SMs, from Python ints alone: slices of the largest of
    GEMV_SLICES in-rows that divides the group (K / G, or K per channel), so
    no slice straddles two groups; GEMV_WARPS_PER_SM workers per SM, or one
    per unit where there are fewer; each worker a contiguous run of units,
    the runs differing by at most one unit (so every SM streams the same
    bytes to within GEMV_WARPS_PER_SM units). Where every unit has a worker
    and a tile has at most GEMV_TILE_CTA_SLICES slices (qkv and o at K 3584),
    each tile is one CTA (``tile_ctas``) whose warps combine in shared
    memory: the same units and combine order, without the workspace's round
    trips. With bf16 x only where no SM gets two such CTAs (o, not qkv): the
    widening makes an SM with two the tail (measured on the H100; PERF.md)."""
    for name, v in (("m", m), ("K", K), ("N", N), ("G", G), ("n_sms", n_sms)):
        if type(v) is not int or v < (0 if name == "G" else 1):
            raise TypeError(f"gemv_plan takes Python ints, got {name}={v!r}")
    gsize = K // G if G else K
    if m > GEMV_MAX_ROWS or K % KERNEL_K_MULTIPLE or (G and K % G) or gsize % KERNEL_K_MULTIPLE:
        raise ValueError(f"no GEMV plan for m = {m}, K = {K}, G = {G}")
    slice_k = next(s for s in GEMV_SLICES if gsize % s == 0)
    n_slices, n_tiles = K // slice_k, -(-N // GEMV_COLS)
    n_units = n_slices * n_tiles
    n_workers = min(n_sms * GEMV_WARPS_PER_SM, n_units)
    tile_ctas = (n_workers == n_units and n_slices <= GEMV_TILE_CTA_SLICES
                 and (not bf16_x or n_tiles <= n_sms))
    return GemvPlan(slice_k, n_slices, n_tiles, n_units, n_workers, tile_ctas)


def w4_gemv_tiled_ref(x, x_scale, wp, w_scale, n_sms: int, out_dtype=torch.bfloat16):
    """The GEMV's partition and combine in plain torch on the CPU, as
    ``gemv_plan`` lays them out for ``n_sms`` SMs: each worker's units in turn,
    every unit's slice sums into a workspace (int32 sums of 16 times each
    nibble for int8 x, fp32 for bf16 x), and when a tile's last slice has
    arrived its combine: the slices added in order (shifted right by 4 for
    int8 x), per channel ``float(acc) * x_scale * w_scale``, with group
    scales each group's sum scaled and added in group order, then x_scale.
    Equal to :func:`w4_matmul_ref` bit for bit for int8 x. Counts as no call
    of either version."""
    N, K = wp.shape[0], 2 * wp.shape[1]
    m = x.numel() // K
    G = _n_groups(w_scale, N, K)
    int_x = x.dtype == torch.int8
    plan = gemv_plan(m, K, N, G, n_sms, bf16_x=not int_x)
    x2 = x.reshape(m, K).to(torch.int32 if int_x else torch.float32)
    w = unpack_int4(wp).to(torch.int32) * 16 if int_x else unpack_int4(wp).float()
    ws = w_scale.float().reshape(max(G, 1), N)
    work = torch.empty(plan.n_slices, m, N, dtype=torch.int32 if int_x else torch.float32)
    arrived = [0] * plan.n_tiles
    y = torch.empty(m, N, dtype=out_dtype)
    per_group = plan.n_slices // max(G, 1)
    S = plan.slice_k
    for worker in range(plan.n_workers):
        for u in plan.units(worker):
            tile, s = divmod(u, plan.n_slices)
            cols = slice(tile * GEMV_COLS, (tile + 1) * GEMV_COLS)
            work[s, :, cols] = x2[:, s * S:(s + 1) * S] @ w[cols, s * S:(s + 1) * S].t()
            arrived[tile] += 1
            if arrived[tile] < plan.n_slices:
                continue
            acc = None
            for gi in range(max(G, 1)):
                part = work[gi * per_group, :, cols]
                for s2 in range(gi * per_group + 1, (gi + 1) * per_group):
                    part = part + work[s2, :, cols]
                v = (part >> 4).float() if int_x else part
                acc = v if not G else (v * ws[gi, cols] if acc is None else acc + v * ws[gi, cols])
            if int_x:
                acc = acc * x_scale.reshape(m, 1).float()
            if not G:
                acc = acc * ws[0, cols]
            y[:, cols] = acc.to(out_dtype)
    return y.reshape(*x.shape[:-1], N)


_SMS: dict = {}
_ARRIVALS: dict = {}


def _n_sms(dev: torch.device) -> int:
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SMS[index]


def _arrivals(dev: torch.device) -> torch.Tensor:
    """The GEMV's arrival counter per tile on this card: zeroed once, and
    left at zero by every launch (the combining warp resets its tile's), so
    a CUDA graph that captured a call replays right. Launches on one card
    share it: they must not run at once on two streams."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _ARRIVALS:
        _ARRIVALS[index] = torch.zeros(GEMV_MAX_TILES, dtype=torch.int32, device=dev)
    return _ARRIVALS[index]


def _launch_kernel(x, x_scale, wp, w_scale, out_dtype):
    N, K = wp.shape[0], 2 * wp.shape[1]
    m = x.numel() // K
    dev = x.device
    if out_dtype != torch.bfloat16:
        raise TypeError(f"the w4_matmul kernel writes bfloat16, got out_dtype {out_dtype}")
    if K % KERNEL_K_MULTIPLE or N % KERNEL_N_MULTIPLE or m < 1:
        raise ValueError(
            f"the w4_matmul kernel takes K a multiple of {KERNEL_K_MULTIPLE} and N a "
            f"multiple of {KERNEL_N_MULTIPLE}, got m = {m}, K = {K}, N = {N}"
        )
    G = _n_groups(w_scale, N, K)
    if G and (K // G) % KERNEL_K_MULTIPLE:
        raise ValueError(
            f"group size {K // G} is not a multiple of the kernel's k-step {KERNEL_K_MULTIPLE}"
        )
    int_x = x.dtype == torch.int8
    if not int_x and x.dtype != torch.bfloat16:
        raise TypeError(f"x must be int8 (with x_scale) or bfloat16 for the kernel, got {x.dtype}")
    if int_x != (x_scale is not None):
        raise ValueError("int8 x comes with x_scale, bfloat16 x without")
    x2 = x.reshape(m, K)
    _launch.check_contiguous_cuda("x", x2, x.dtype, (m, K), dev)
    _launch.check_contiguous_cuda("wp", wp, torch.int8, (N, K // 2), dev)
    ws = w_scale.reshape(max(G, 1), N)
    _launch.check_contiguous_cuda("w_scale", ws, torch.float32, (max(G, 1), N), dev)
    xs_ptr = 0
    if int_x:
        xs = x_scale.reshape(m)
        _launch.check_contiguous_cuda("x_scale", xs, torch.float32, (m,), dev)
        xs_ptr = xs.data_ptr()
    out = torch.empty(m, N, dtype=torch.bfloat16, device=dev)
    work = arrivals = None  # held until the launch is enqueued
    slice_k = n_workers = tile_ctas = 0
    if m <= GEMV_MAX_ROWS:
        plan = gemv_plan(m, K, N, G, _n_sms(dev), bf16_x=not int_x)
        if not plan.tile_ctas:
            arrivals = _arrivals(dev)
            work = torch.empty(N * m * (-(-plan.n_slices // 4) * 4), dtype=torch.int32,
                               device=dev)
        slice_k, n_workers, tile_ctas = plan.slice_k, plan.n_workers, int(plan.tile_ctas)
    lib = cuda_build.load_library()
    with torch.cuda.device(dev):
        rc = lib.unimedvl_w4_matmul(
            x2.data_ptr(), xs_ptr, wp.data_ptr(), ws.data_ptr(), out.data_ptr(),
            0 if work is None else work.data_ptr(), 0 if arrivals is None else arrivals.data_ptr(),
            m, K, N, G, int(int_x), slice_k, n_workers, tile_ctas,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    cuda_build.check(rc, "w4_matmul")
    counts["kernel"] += 1
    return out.reshape(*x.shape[:-1], N)


def w4_matmul(
    x: torch.Tensor,  # [..., K] int8 (with x_scale) or bf16 (x_scale None)
    x_scale: Optional[torch.Tensor],  # [..., 1] fp32 per-row scales of an int8 x
    wp: torch.Tensor,  # [N, K/2] packed int4 (pack_int4)
    w_scale: torch.Tensor,  # fp32 [N], or [G, N] group-wise
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """``y = (x @ unpack(wp).T) * x_scale * w_scale`` without the unpacked
    weights ever reaching device memory; returns [..., N] in ``out_dtype``.
    Leading dims of x are flattened. CUDA tensors go through the kernel (K a
    multiple of 64, groups of a multiple of 64 in-rows, N a multiple of 8,
    bf16 output; anything else raises), CPU tensors through
    :func:`w4_matmul_ref`."""
    if wp.dim() != 2 or wp.dtype != torch.int8 or x.shape[-1] != 2 * wp.shape[1]:
        raise ValueError(
            f"wp must be int8 [N, K/2] with K = x.shape[-1]: got {wp.dtype} "
            f"{tuple(wp.shape)} for x {tuple(x.shape)}"
        )
    if x.device.type == "cuda":
        return _launch_kernel(x, x_scale, wp, w_scale, out_dtype)
    if x.device.type == "cpu":
        return w4_matmul_ref(x, x_scale, wp, w_scale, out_dtype)
    raise ValueError(f"w4_matmul runs on CUDA or CPU tensors, got {x.device}")
