"""K4's GEMV (m <= 4 rows) on the CPU: the partition ``gemv_plan`` lays out
for the kernel, and ``w4_gemv_tiled_ref``, the same partition and combine in
plain torch, against the port's plain version and the JAX package's K4.

Inputs come from numpy seeds. With int8 x the twin must EQUAL the plain
version bit for bit, per channel and with group scales (integer slice sums
are exact; the scales apply in the same rounded fp32 order). With bf16 x the
twin sums fp32 slice by slice in another order than one fp32 matmul: rtol 1e-5
plus atol 1e-5 of the fp32 result (sums of at most K = 2048 products of size
below 8 max|x|). Against the JAX kernel (interpret mode, ``force_kernel=True``,
K 1024, N 512, as ``test_torch_quant.py`` runs it): int8 x per channel equal;
with group scales within rtol 1e-6, atol 1e-5 (the Pallas kernel may fuse the
group's multiply-add); bf16 x within rtol 1e-4, atol 1e-4 (its two half-K
dots sum in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unimedvl_tpu.ops import w4_matmul as jw4
from unimedvl_tpu_torch.ops import w4_matmul as w4

# (K, N, G): per channel and grouped; K no multiple of 512 (slices of 64, 128, 256), N no
# multiple of the 32-row tile, groups of 64 in-rows, and the down projection's 37 groups
SHAPES = [
    (1024, 512, 0), (1024, 512, 2), (192, 136, 3), (320, 24, 0), (768, 200, 3),
    (1536, 72, 0), (2048, 64, 4), (2368, 56, 37),
]


def _inputs(seed, m, K, N, G):
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, (m, K)).astype(np.int8)
    xs = rng.uniform(0.01, 0.1, (m, 1)).astype(np.float32)
    xb = rng.standard_normal((m, K)).astype(np.float32)
    q = rng.integers(-8, 8, (K, N)).astype(np.int8)  # [K, N], as the JAX package keeps it
    ws = rng.uniform(0.01, 0.1, (G, N) if G else (N,)).astype(np.float32)
    wp = w4.pack_int4(torch.from_numpy(q.T.copy()))  # the port's [N, K/2]
    return xq, xs, torch.from_numpy(xb).bfloat16(), q, ws, wp


@pytest.mark.parametrize("n_sms", [132, 5, 1])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_twin_equals_plain(m, shape, n_sms):
    K, N, G = shape
    xq, xs, xb, _, ws, wp = _inputs(m * 7 + K + G, m, K, N, G)
    args = (torch.from_numpy(xq), torch.from_numpy(xs), wp, torch.from_numpy(ws))
    for dt in (torch.float32, torch.bfloat16):
        before = dict(w4.counts)
        got = w4.w4_gemv_tiled_ref(*args, n_sms=n_sms, out_dtype=dt)
        assert w4.counts == before
        want = w4.w4_matmul_ref(*args, out_dtype=dt)
        assert got.dtype == dt and got.shape == (m, N) and torch.equal(got, want)
    got = w4.w4_gemv_tiled_ref(xb, None, wp, torch.from_numpy(ws), n_sms=n_sms,
                               out_dtype=torch.float32)
    want = w4.w4_matmul_ref(xb, None, wp, torch.from_numpy(ws), out_dtype=torch.float32)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("groups", [0, 2, 1])
@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_twin_matches_the_jax_kernel(m, groups):
    K, N = 1024, 512
    xq, xs, xb, q, ws, wp = _inputs(100 + m + groups, m, K, N, groups)
    jwp = jnp.asarray(jw4.pack_int4(q))
    want = np.asarray(jw4.w4_matmul(jnp.asarray(xq), jnp.asarray(xs), jwp, jnp.asarray(ws),
                                    out_dtype=jnp.float32, interpret=True, force_kernel=True))
    got = w4.w4_gemv_tiled_ref(torch.from_numpy(xq), torch.from_numpy(xs), wp,
                               torch.from_numpy(ws), n_sms=132, out_dtype=torch.float32).numpy()
    if groups:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)
    jx = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)
    want = np.asarray(jw4.w4_matmul(jx, None, jwp, jnp.asarray(ws), out_dtype=jnp.float32,
                                    interpret=True, force_kernel=True))
    got = w4.w4_gemv_tiled_ref(xb, None, wp, torch.from_numpy(ws), n_sms=132,
                               out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# (K, N, G) of the LLM's four quantized projections, per channel and with groups of 512 in-rows,
# and the small shapes above
PLAN_SHAPES = [(3584, 4608, 0), (3584, 3584, 0), (3584, 37888, 0), (18944, 3584, 0),
               (3584, 4608, 7), (3584, 3584, 7), (3584, 37888, 7), (18944, 3584, 37)] + SHAPES


@pytest.mark.parametrize("n_sms", [132, 114, 7, 1])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_covers_every_byte_once_in_group_aligned_balanced_runs(shape, n_sms):
    K, N, G = shape
    plan = w4.gemv_plan(1, K, N, G, n_sms)
    gsize = K // G if G else K
    assert gsize % plan.slice_k == 0 and plan.slice_k in w4.GEMV_SLICES
    assert plan.slice_k == max(s for s in w4.GEMV_SLICES if gsize % s == 0)
    assert plan.n_workers == min(n_sms * w4.GEMV_WARPS_PER_SM, plan.n_units)
    # the slices tile a packed row: bytes [s slice_k / 2, (s + 1) slice_k / 2) are slice s's
    assert plan.n_slices * plan.slice_k == K
    covered = torch.zeros(N, plan.n_slices, dtype=torch.int32)  # per weight row and slice
    sizes, seen = [], []
    for worker in range(plan.n_workers):
        units = plan.units(worker)
        sizes.append(len(units))
        seen += list(units)
        for u in units:
            tile, s = divmod(u, plan.n_slices)
            covered[tile * w4.GEMV_COLS:(tile + 1) * w4.GEMV_COLS, s] += 1
            # a slice lies inside one group
            assert s * plan.slice_k // gsize == ((s + 1) * plan.slice_k - 1) // gsize
    assert seen == list(range(plan.n_units))  # contiguous runs, in order
    assert bool((covered == 1).all())
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1


def test_plan_takes_python_ints_and_gemv_shapes_only():
    with pytest.raises(TypeError, match="Python ints"):
        w4.gemv_plan(1, torch.tensor(1024), 512, 0, 132)
    with pytest.raises(ValueError, match="no GEMV plan"):
        w4.gemv_plan(5, 1024, 512, 0, 132)
    with pytest.raises(ValueError, match="no GEMV plan"):
        w4.gemv_plan(1, 1024, 512, 3, 132)
    with pytest.raises(ValueError, match="no GEMV plan"):
        w4.gemv_plan(1, 96, 512, 0, 132)


@pytest.mark.parametrize("shape,int8_tiles,bf16_tiles", [
    ((3584, 4608, 0), True, False), ((3584, 4608, 7), True, False),
    ((3584, 3584, 0), True, True), ((3584, 3584, 7), True, True),
    ((3584, 37888, 0), False, False), ((18944, 3584, 37), False, False),
])
def test_plan_combines_small_projections_in_one_cta_per_tile(shape, int8_tiles, bf16_tiles):
    """On 132 SMs: qkv and o (7 slices a tile, every unit a warp) combine in
    shared memory, one CTA per tile; with bf16 x only o, whose 112 tiles put
    at most one such CTA on an SM; gate_up and down through the workspace."""
    K, N, G = shape
    for bf16_x, want in ((False, int8_tiles), (True, bf16_tiles)):
        plan = w4.gemv_plan(1, K, N, G, 132, bf16_x=bf16_x)
        assert plan.tile_ctas == want
        if plan.tile_ctas:
            assert plan.n_workers == plan.n_units
            assert plan.n_slices <= w4.GEMV_TILE_CTA_SLICES
