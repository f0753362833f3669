// K5: packed training attention, forward, dq and dk/dv kernels, bf16, for sm_90a.
//
// Replaces the Pallas TPU kernels of unimedvl_tpu/ops/flash_attention_train.py::
// packed_train_attention: `_fwd_kernel`, `_bwd_dq_kernel` and `_bwd_dkv_kernel`.
//
// What they compute. One packed sequence of T tokens, q [T, H, D], k and v [T, Hk, D] (query head
// h reads KV head h / (H / Hk)), and three int32 arrays [T]: document id, full-span id (fn) and
// noise-span id. Query i may attend to key j iff
//   (i >= j or (fn[i] == fn[j] and fn[i] >= 0)) and not (noise[j] >= 0 and noise[i] != noise[j])
//   and doc[i] == doc[j].
// Forward: out[i, h] = sum_j softmax_j(q[i, h] . k[j, hk] / sqrt(D)) v[j, hk] over the allowed j,
// online softmax in fp32, and lse[h, i] = m + log(l); a row that sees nothing gives out = 0 and
// lse = -FLT_MAX. Backward, from do (the cotangent in bf16), lse and
// dsum[h, i] = sum_d do . out (fp32): p = exp(s - lse) SELECTED to 0 where masked,
// ds = p (dp - dsum) with dp = do . v^T, and
//   dq = ds k / sqrt(D),   dk = ds^T q / sqrt(D),   dv = p^T do,
// dk and dv summed over the G = H / Hk query heads of the KV head and over all query rows.
// D = 128 only. T is any length: rows at or past T are zero-filled in shared memory, masked out
// and never stored, so the caller pads nothing and transposes nothing (each [T, heads, D] array
// is read through its row and head strides).
//
// What bounds them on the H100: operations. A live (64 query, 64 key) tile pair costs
// 4 * 64 * 64 * D flops forward and 10 * 64 * 64 * D backward against 2 * 64 * D bf16 loads that
// the G heads of a group and neighbouring CTAs share through L2, so the tensor cores' rate
// sets the time, and the only large saving is not to touch tile pairs in which nothing is
// allowed: packed documents are block-diagonal and noise spans are hidden from every later token.
//
// Device code for wgmma, TMA, mbarriers and the online softmax is in flash_common.cuh, shared
// with K1.
// - The plan, once per forward call, on the card, from the ids and T alone (three small
//   launches, no host synchronisation): every (64-row, 64-row) tile pair is classified dead, full
//   (every pair allowed, every row inside T: no mask) or partial; then, per 128 query rows, the
//   list of key tiles that either 64-row half sees (the forward's and dq's sweep), and per 128
//   keys the list of query tiles that see either half (for dk/dv), each entry with both halves'
//   classes, so a warpgroup skips a dead half and masks only a partial one; the ids as one int4
//   per row, padded to the 128-row grid; and the order in which the forward takes the query
//   tiles, longest list first. The autograd function saves the plan for the backward, whose own
//   launch (`bwd_rows_kernel`) writes only dsum (fp32, from the bf16 do and out) and lse in log2
//   units (+inf for a row that sees nothing, so its p is 0 unmasked too).
// - Forward: one CTA per (query head, 128 query rows): two consumer warpgroups of 64 rows and
//   one producer warp. Q comes once by TMA; K and V tiles of the plan's list come through a ring
//   of four stages by TMA, with the tile's ids by a bulk copy (per-stage `full` / `empty`
//   mbarriers, no CTA-wide barrier per tile). S = Q K^T is a wgmma m64n64k16 with both operands
//   in shared memory, O += P V a wgmma m64n128k16 with P in registers and V MN-major; the online
//   softmax runs in log2 units (`flash::softmax_update`), the epilogue writes out and lse in
//   natural log. The grid's x is the head, so the G heads of a KV group sweep the same K/V tiles
//   side by side (L2), and its y the rank of the query tile in the plan's order: a document's
//   last query tiles see the most key tiles and start first.
// - dq: one CTA per (128 query rows, query head), the forward's partition with dO beside Q:
//   S = Q K^T and dP = dO V^T are wgmma m64n64k16 with both operands in shared memory, dQ += dS K
//   a wgmma m64n128k16 with dS in registers (the accumulator layout is the A operand's) and K
//   read MN-major from the tile that fed Q K^T.
// - dk/dv: one CTA per (64 keys, query head h): the head is the split. K and V of the 64 keys
//   come once; Q, dO, lse, dsum and ids of each query tile that the plan lists for these keys
//   stream through the ring. The tile is transposed (S^T = K Q^T, dP^T = V dO^T: every
//   accumulator row is a key), and the two consumer warpgroups split the chain over the same
//   64 keys: warpgroup 0 takes S^T, P^T and dV += P^T dO, warpgroup 1 dP^T, dS^T = P^T (dP^T -
//   dsum) and dK += dS^T Q, P^T passing between them through two slots of shared memory. The
//   K-major products read Q and dO, and the RS products read them MN-major, from the same
//   swizzled tiles. One warpgroup holding both 64 x 128 fp32 accumulators (128 registers a
//   thread) for its own 64 keys made the compiler spill and serialise the wgmma products, also
//   with setmaxnreg (24 / 240): 3.76 ms against 1.78 at T 6144 (NVIDIA H100 80GB HBM3, 700 W).
//   Each CTA writes its fp32 partial dK and dV to a workspace [2][G][Hk][T_pad][D] (H T_pad D
//   8 bytes: 168 MiB at T 6144, 28 heads); a combine launch sums the G partials of each KV head
//   in head order and rounds to bf16. No atomics: the same bits on every run, whatever the
//   order in which CTAs run. The split by head gives 2 H CTAs per 128 keys (2688 at T 6144)
//   where one CTA per (64 keys, KV head) gave 384 for 132 SMs, and bounds a CTA's work by one
//   head's share of its keys' list (a document's first key tile is seen by all its query
//   tiles, its last by one).
// - The mask, where it runs (partial pairs only), is branch-free; logits are in log2 units
//   (scale times log2 e), so each p is one fma and one ex2; p and ds are rounded to bf16 for
//   the second product of each chain.
// The TPU kernels' lane-replicated lse/dsum, the [Hk, G, T, D] transposes, the padding to a tile
// multiple and the whole-K/V-resident grid step are Mosaic shapes and are not carried over.

#include "flash_common.cuh"

namespace k5 {

using flash::bf16;
using flash::ex2;
using flash::fence_regs;
using flash::kLog2e;
using flash::mbar_arrive;
using flash::mbar_expect_tx;
using flash::mbar_init;
using flash::mbar_wait;
using flash::pack_bf16x2;
using flash::smem_u32;
using flash::tma_load;
using flash::wgmma_64x128_rs;
using flash::wgmma_64x64_ss;
using flash::wgmma_commit;
using flash::wgmma_desc;
using flash::wgmma_fence;
using flash::wgmma_wait;

constexpr float kMin = flash::kNegInf;  // the lse of a row that sees nothing
constexpr int kD = 128;
constexpr int kT = 64;                     // rows of a tile; a CTA owns two (kRows)
constexpr int kRows = 2 * kT;
constexpr int kTile = kT * kD;             // elements of a tile: two swizzled 64-column halves
constexpr int kTileBytes = kTile * 2;
constexpr int kStages = 4;
constexpr int kConsumers = 256;            // two warpgroups
constexpr int kEntryShift = 16;            // a plan entry: tile index | code << 16
constexpr int kDead = 0, kPartial = 1, kFull = 2;  // a 64 x 64 pair's class; code = lo | hi << 2
constexpr int kStateSplit = 4;             // CTAs per query tile that classify tile pairs
constexpr int kPrepThreads = 256;

// A 64 x 16 k-step of a K-major operand: 16 dims a step, 32 bytes in a half, then the other.
__device__ __forceinline__ uint64_t kstep(int kk) {
  return static_cast<uint64_t>((((kk >> 2) * (kT * 64) + (kk & 3) * 16) * 2) >> 4);
}

// Rows row0 .. row0 + 63 of a [*, heads, D] array (tensor map) -> a swizzled tile.
__device__ __forceinline__ void tma_tile(bf16* dst, const CUtensorMap* map, uint64_t* bar,
                                         int row0, int head) {
  tma_load(dst, map, bar, 0, row0, head, 0);
  tma_load(dst + kT * 64, map, bar, 64, row0, head, 0);
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) global -> shared, counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// May query i (ids a: doc, fn, noise) attend to key j (ids b)? Branch-free; rows past T never.
__device__ __forceinline__ bool allowed(int i, int j, int4 a, int4 b, int T) {
  return (i < T) & (j < T) & ((i >= j) | ((a.y == b.y) & (a.y >= 0))) &
         !((b.z >= 0) & (a.z != b.z)) & (a.x == b.x);
}

__device__ __forceinline__ void init_barriers(uint64_t* full, uint64_t* empty, uint64_t* once) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kConsumers / 32);
    }
    mbar_init(once, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* smem) {
  const uint32_t base = smem_u32(smem);
  return smem + (((base + 1023u) & ~1023u) - base);
}

// ---------------------------------------------------------------------------------------------
// the plan
// ---------------------------------------------------------------------------------------------

// grid (n64, kStateSplit + 1), n64 = T_pad / 64 tiles of the 128-row grid.
// y < kStateSplit: the classes of pairs (query tile x, key tiles of chunk y), one warp a pair,
//   each lane two key columns against the 64 rows;
// y == kStateSplit: the ids of the tile's rows as int4 (doc, fn, noise, 0), zeros past T.
__global__ void __launch_bounds__(kPrepThreads)
    plan_classes_kernel(const int* __restrict__ doc, const int* __restrict__ fn,
                        const int* __restrict__ nz, int4* __restrict__ ids4,
                        uint8_t* __restrict__ states, int T, int n64) {
  const int qa = blockIdx.x, role = blockIdx.y, r0 = qa * kT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (role == kStateSplit) {
    if (threadIdx.x < kT) {
      const int i = r0 + threadIdx.x;
      ids4[i] = i < T ? make_int4(doc[i], fn[i], nz[i], 0) : make_int4(0, 0, 0, 0);
    }
    return;
  }
  __shared__ int4 rid[kT];
  if (threadIdx.x < kT) {
    const int i = r0 + threadIdx.x;
    rid[threadIdx.x] = i < T ? make_int4(doc[i], fn[i], nz[i], 0) : make_int4(0, 0, 0, 0);
  }
  __syncthreads();
  const int per = (n64 + kStateSplit - 1) / kStateSplit;
  const int end = min(n64, (role + 1) * per);
  for (int kb = role * per + warp; kb < end; kb += kPrepThreads / 32) {
    int any = 0, all = 1;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = kb * kT + half * 32 + lane;
      const int4 kid = j < T ? make_int4(doc[j], fn[j], nz[j], 0) : make_int4(0, 0, 0, 0);
#pragma unroll 8
      for (int r = 0; r < kT; ++r) {
        const int ok = allowed(r0 + r, j, rid[r], kid, T);
        any |= ok;
        all &= ok;
      }
    }
    any = __any_sync(0xffffffffu, any);
    all = __all_sync(0xffffffffu, all);
    if (lane == 0) states[qa * n64 + kb] = any ? (all ? kFull : kPartial) : kDead;
  }
}

// grid (n128, 2), one warp: y = 0, the dq list of query tile x (its key tiles that either
// 64-row half sees, in order); y = 1, the dk/dv list of key tile x (the query tiles that see
// either half). Entry: tile index | (class of half 0 | class of half 1 << 2) << 16.
__global__ void __launch_bounds__(32)
    plan_lists_kernel(const uint8_t* __restrict__ states, int* __restrict__ dq_list,
                      int* __restrict__ dq_count, int* __restrict__ dkv_list,
                      int* __restrict__ dkv_count, int n64) {
  const int tile = blockIdx.x, lane = threadIdx.x;
  const bool kv = blockIdx.y == 1;
  int* list = (kv ? dkv_list : dq_list) + (long long)tile * n64;
  int n = 0;
  for (int c0 = 0; c0 < n64; c0 += 32) {
    const int c = c0 + lane;
    int code = 0;
    if (c < n64) {
      const int lo = kv ? states[c * n64 + 2 * tile] : states[2 * tile * n64 + c];
      const int hi = kv ? states[c * n64 + 2 * tile + 1] : states[(2 * tile + 1) * n64 + c];
      code = lo | hi << 2;
    }
    const unsigned live = __ballot_sync(0xffffffffu, code != 0);
    if (code != 0) list[n + __popc(live & ((1u << lane) - 1u))] = c | code << kEntryShift;
    n += __popc(live);
  }
  if (lane == 0) (kv ? dkv_count : dq_count)[tile] = n;
}

// One CTA: order[r] = the query tile whose dq list is the r-th longest (ties by index), the
// order in which the forward's grid takes them.
constexpr int kOrderThreads = 1024;
__global__ void __launch_bounds__(kOrderThreads)
    plan_order_kernel(const int* __restrict__ dq_count, int* __restrict__ order, int n128) {
  for (int x = threadIdx.x; x < n128; x += kOrderThreads) {
    const int c = dq_count[x];
    int rank = 0;
    for (int y = 0; y < n128; ++y) {
      const int d = dq_count[y];
      rank += (d > c) | ((d == c) & (y < x));
    }
    order[rank] = x;
  }
}

// grid (n64, H): head y's dsum and lse in log2 units of tile x's rows (0 past T), one warp a
// row.
__global__ void __launch_bounds__(kPrepThreads)
    bwd_rows_kernel(const bf16* __restrict__ dout, long long do_rs, long long do_hs,
                    const bf16* __restrict__ out, const float* __restrict__ lse,
                    float* __restrict__ lse2, float* __restrict__ dsum, int T, int H, int n64) {
  const int r0 = blockIdx.x * kT, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Tp = n64 * kT;
  for (int r = warp; r < kT; r += kPrepThreads / 32) {
    const int i = r0 + r;
    float acc = 0.f, l2 = 0.f;
    if (i < T) {  // warp-uniform
      const uint2 a = *reinterpret_cast<const uint2*>(dout + i * do_rs + h * do_hs + lane * 4);
      const uint2 b = *reinterpret_cast<const uint2*>(out + ((long long)i * H + h) * kD + lane * 4);
      const float2 a0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a.x));
      const float2 a1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a.y));
      const float2 b0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&b.x));
      const float2 b1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&b.y));
      acc = a0.x * b0.x + a0.y * b0.y + a1.x * b1.x + a1.y * b1.y;
#pragma unroll
      for (int w = 16; w >= 1; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
      const float l = lse[(long long)h * T + i];
      l2 = l > kMin ? l * kLog2e : __int_as_float(0x7f800000);  // +inf: p = 0 everywhere
    }
    if (lane == 0) {
      dsum[(long long)h * Tp + i] = acc;
      lse2[(long long)h * Tp + i] = l2;
    }
  }
}

// ---------------------------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------------------------

constexpr int kFwdThreads = kConsumers + 32;
// Q tiles, the K/V ring, the ring's ids, its mbarriers and the Q barrier, alignment slack
constexpr int kFwdSmem = (2 + 2 * kStages) * kTileBytes + kStages * kT * 16 +
                         8 * (2 * kStages + 1) + 1024;

__global__ void __launch_bounds__(kFwdThreads, 1)
    fwd_sweep_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, const int4* __restrict__ ids4,
                     const int* __restrict__ list, const int* __restrict__ count,
                     const int* __restrict__ order, bf16* __restrict__ out,
                     float* __restrict__ lse, int T, int H, int Hk, int n64, float scale) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* s_q = reinterpret_cast<bf16*>(align1024(smem_raw));  // [2 halves of rows][tile]
  bf16* s_kv = s_q + 2 * kTile;                              // [kStages][K tile, V tile]
  int4* s_ids = reinterpret_cast<int4*>(s_kv + 2 * kStages * kTile);  // [kStages][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(s_ids + kStages * kT);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int h = blockIdx.x, qt = order[blockIdx.y], q0 = qt * kRows;
  const int hk = h / (H / Hk);
  const int* plan = list + (long long)qt * n64;
  const int n = count[qt];
  init_barriers(full, empty, qbar);

  if (threadIdx.x >= kConsumers) {  // the producer warp
    if (threadIdx.x != kConsumers) return;
    mbar_expect_tx(qbar, 2 * kTileBytes);
    tma_tile(s_q, &qmap, qbar, q0, h);
    tma_tile(s_q + kTile, &qmap, qbar, q0 + kT, h);
    for (int i = 0; i < n; ++i) {
      const int st = i % kStages;
      if (i >= kStages) mbar_wait(empty + st, ((i / kStages) - 1) & 1);
      const int j0 = (plan[i] & 0xffff) * kT;
      mbar_expect_tx(full + st, 2 * kTileBytes + kT * 16);
      tma_tile(s_kv + st * 2 * kTile, &kmap, full + st, j0, hk);
      tma_tile(s_kv + st * 2 * kTile + kTile, &vmap, full + st, j0, hk);
      bulk_load(s_ids + st * kT, ids4 + j0, kT * 16, full + st);
    }
    return;
  }

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int row_a = q0 + wg * kT + warp * 16 + (lane >> 2), row_b = row_a + 8;
  const int4 ia = ids4[row_a], ib = ids4[row_b];
  const float sl2 = scale * kLog2e;
  float o[64];  // this warpgroup's 64 x 128 output accumulator: blocks of 8 columns x 4
#pragma unroll
  for (int x = 0; x < 64; ++x) o[x] = 0.f;
  flash::RowStats rs;
  rs.init();
  const uint64_t d_q = wgmma_desc(s_q + wg * kTile, 16, 1024);
  mbar_wait(qbar, 0);

  for (int i = 0; i < n; ++i) {
    const int st = i % kStages;
    const int e = plan[i];
    const int code = (e >> (kEntryShift + 2 * wg)) & 3;  // this warpgroup's class
    const int j0 = (e & 0xffff) * kT;
    mbar_wait(full + st, (i / kStages) & 1);
    if (code != kDead) {  // warpgroup-uniform
      const bf16* sk = s_kv + st * 2 * kTile;
      const bf16* sv = sk + kTile;
      float s[32];
#pragma unroll
      for (int x = 0; x < 32; ++x) s[x] = 0.f;
      fence_regs(s);
      wgmma_fence();
      const uint64_t d_k = wgmma_desc(sk, 16, 1024);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) wgmma_64x64_ss(s, d_q + kstep(kk), d_k + kstep(kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      if (code == kPartial) {  // masked logits -> kMin, which the softmax weighs 0
        const int4* kid = s_ids + st * kT;
#pragma unroll
        for (int nt = 0; nt < kT / 8; ++nt) {
          const int c = nt * 8 + 2 * t;
          const int4 b0 = kid[c], b1 = kid[c + 1];
          s[4 * nt + 0] = allowed(row_a, j0 + c, ia, b0, T) ? s[4 * nt + 0] : kMin;
          s[4 * nt + 1] = allowed(row_a, j0 + c + 1, ia, b1, T) ? s[4 * nt + 1] : kMin;
          s[4 * nt + 2] = allowed(row_b, j0 + c, ib, b0, T) ? s[4 * nt + 2] : kMin;
          s[4 * nt + 3] = allowed(row_b, j0 + c + 1, ib, b1, T) ? s[4 * nt + 3] : kMin;
          asm volatile("" ::: "memory");  // two columns' ids live at a time, not sixteen
        }
      }
      const float2 al = flash::softmax_update(s, rs, code == kFull, sl2);
      if (__any_sync(0xffffffffu, al.x != 1.f || al.y != 1.f)) {  // a row maximum moved
#pragma unroll
        for (int nb = 0; nb < kD / 8; ++nb) {
          o[4 * nb + 0] *= al.x;
          o[4 * nb + 1] *= al.x;
          o[4 * nb + 2] *= al.y;
          o[4 * nb + 3] *= al.y;
        }
      }
      uint32_t a[4][4];  // P as the A operand: keys 16ks .. 16ks + 15
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        a[ks][0] = pack_bf16x2(s[8 * ks + 0], s[8 * ks + 1]);
        a[ks][1] = pack_bf16x2(s[8 * ks + 2], s[8 * ks + 3]);
        a[ks][2] = pack_bf16x2(s[8 * ks + 4], s[8 * ks + 5]);
        a[ks][3] = pack_bf16x2(s[8 * ks + 6], s[8 * ks + 7]);
      }
      fence_regs(o);
      wgmma_fence();
      // V MN-major: the two 64-column halves 8 KB apart, groups of 8 keys 1 KB apart
      const uint64_t d_v = wgmma_desc(sv, kT * 64 * 2, 1024);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) wgmma_64x128_rs(o, a[ks], d_v + ((ks * 16 * 128) >> 4));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);
  }

  // out = o / l and lse = (m + log2 l) ln 2 for the rows below T; a row that saw nothing: 0 and
  // kMin
#pragma unroll
  for (int w = 1; w <= 2; w <<= 1) {
    rs.l_a += __shfl_xor_sync(0xffffffffu, rs.l_a, w);
    rs.l_b += __shfl_xor_sync(0xffffffffu, rs.l_b, w);
  }
  const float inv_a = 1.f / fmaxf(rs.l_a, 1e-30f), inv_b = 1.f / fmaxf(rs.l_b, 1e-30f);
  if (row_a < T) {
    bf16* dst = out + ((long long)row_a * H + h) * kD + 2 * t;
#pragma unroll
    for (int nb = 0; nb < kD / 8; ++nb)
      *reinterpret_cast<uint32_t*>(dst + nb * 8) =
          pack_bf16x2(o[4 * nb] * inv_a, o[4 * nb + 1] * inv_a);
    if (t == 0)
      lse[(long long)h * T + row_a] =
          rs.l_a > 0.f ? (rs.m_a + log2f(rs.l_a)) * flash::kLn2 : kMin;
  }
  if (row_b < T) {
    bf16* dst = out + ((long long)row_b * H + h) * kD + 2 * t;
#pragma unroll
    for (int nb = 0; nb < kD / 8; ++nb)
      *reinterpret_cast<uint32_t*>(dst + nb * 8) =
          pack_bf16x2(o[4 * nb + 2] * inv_b, o[4 * nb + 3] * inv_b);
    if (t == 0)
      lse[(long long)h * T + row_b] =
          rs.l_b > 0.f ? (rs.m_b + log2f(rs.l_b)) * flash::kLn2 : kMin;
  }
}

// ---------------------------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------------------------

constexpr int kDqThreads = kConsumers + 32;
// Q and dO tiles, the K/V ring, the ring's ids, its mbarriers and the Q barrier, alignment slack
constexpr int kDqSmem = (4 + 2 * kStages) * kTileBytes + kStages * kT * 16 +
                        8 * (2 * kStages + 1) + 1024;

__global__ void __launch_bounds__(kDqThreads, 1)
    bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const __grid_constant__ CUtensorMap domap, const float* __restrict__ lse2,
                  const float* __restrict__ dsum, const int4* __restrict__ ids4,
                  const int* __restrict__ list, const int* __restrict__ count,
                  bf16* __restrict__ dq, int T, int H, int Hk, int n64, float scale) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* s_q = reinterpret_cast<bf16*>(align1024(smem_raw));  // [2 halves of rows][tile]
  bf16* s_do = s_q + 2 * kTile;
  bf16* s_kv = s_do + 2 * kTile;                             // [kStages][K tile, V tile]
  int4* s_ids = reinterpret_cast<int4*>(s_kv + 2 * kStages * kTile);  // [kStages][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(s_ids + kStages * kT);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int qt = blockIdx.x, h = blockIdx.y, q0 = qt * kRows;
  const int hk = h / (H / Hk);
  const int* plan = list + (long long)qt * n64;
  const int n = count[qt];
  init_barriers(full, empty, qbar);

  if (threadIdx.x >= kConsumers) {  // the producer warp
    if (threadIdx.x != kConsumers) return;
    mbar_expect_tx(qbar, 4 * kTileBytes);
    tma_tile(s_q, &qmap, qbar, q0, h);
    tma_tile(s_q + kTile, &qmap, qbar, q0 + kT, h);
    tma_tile(s_do, &domap, qbar, q0, h);
    tma_tile(s_do + kTile, &domap, qbar, q0 + kT, h);
    for (int i = 0; i < n; ++i) {
      const int st = i % kStages;
      if (i >= kStages) mbar_wait(empty + st, ((i / kStages) - 1) & 1);
      const int j0 = (plan[i] & 0xffff) * kT;
      mbar_expect_tx(full + st, 2 * kTileBytes + kT * 16);
      tma_tile(s_kv + st * 2 * kTile, &kmap, full + st, j0, hk);
      tma_tile(s_kv + st * 2 * kTile + kTile, &vmap, full + st, j0, hk);
      bulk_load(s_ids + st * kT, ids4 + j0, kT * 16, full + st);
    }
    return;
  }

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int row_a = q0 + wg * kT + warp * 16 + (lane >> 2), row_b = row_a + 8;
  const int Tp = n64 * kT;
  const float la = lse2[(long long)h * Tp + row_a], lb = lse2[(long long)h * Tp + row_b];
  const float da = dsum[(long long)h * Tp + row_a], db = dsum[(long long)h * Tp + row_b];
  const int4 ia = ids4[row_a], ib = ids4[row_b];
  const float sl2 = scale * kLog2e;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const uint64_t d_q = wgmma_desc(s_q + wg * kTile, 16, 1024);
  const uint64_t d_do = wgmma_desc(s_do + wg * kTile, 16, 1024);
  mbar_wait(qbar, 0);

  for (int i = 0; i < n; ++i) {
    const int st = i % kStages;
    const int e = plan[i];
    const int code = (e >> (kEntryShift + 2 * wg)) & 3;  // this warpgroup's class
    const int j0 = (e & 0xffff) * kT;
    mbar_wait(full + st, (i / kStages) & 1);
    if (code != kDead) {  // warpgroup-uniform
      const bf16* sk = s_kv + st * 2 * kTile;
      const bf16* sv = sk + kTile;
      float s[32], dp[32];
#pragma unroll
      for (int x = 0; x < 32; ++x) s[x] = dp[x] = 0.f;
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      const uint64_t d_k = wgmma_desc(sk, 16, 1024), d_v = wgmma_desc(sv, 16, 1024);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) wgmma_64x64_ss(s, d_q + kstep(kk), d_k + kstep(kk));
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) wgmma_64x64_ss(dp, d_do + kstep(kk), d_v + kstep(kk));
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);
      // p = 2^(s sl2 - lse2), selected to 0 where masked (partial pairs only)
#pragma unroll
      for (int x = 0; x < 32; ++x) s[x] = ex2(fmaf(s[x], sl2, -((x & 2) ? lb : la)));
      if (code == kPartial) {
        const int4* kid = s_ids + st * kT;
#pragma unroll
        for (int nt = 0; nt < kT / 8; ++nt) {
          const int c = nt * 8 + 2 * t;
          const int4 b0 = kid[c], b1 = kid[c + 1];
          s[4 * nt + 0] = allowed(row_a, j0 + c, ia, b0, T) ? s[4 * nt + 0] : 0.f;
          s[4 * nt + 1] = allowed(row_a, j0 + c + 1, ia, b1, T) ? s[4 * nt + 1] : 0.f;
          s[4 * nt + 2] = allowed(row_b, j0 + c, ib, b0, T) ? s[4 * nt + 2] : 0.f;
          s[4 * nt + 3] = allowed(row_b, j0 + c + 1, ib, b1, T) ? s[4 * nt + 3] : 0.f;
          asm volatile("" ::: "memory");  // two columns' ids live at a time, not sixteen
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int x = 0; x < 32; ++x) s[x] *= dp[x] - ((x & 2) ? db : da);  // ds
      uint32_t a[4][4];  // dS as the A operand: keys 16ks .. 16ks + 15
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        a[ks][0] = pack_bf16x2(s[8 * ks + 0], s[8 * ks + 1]);
        a[ks][1] = pack_bf16x2(s[8 * ks + 2], s[8 * ks + 3]);
        a[ks][2] = pack_bf16x2(s[8 * ks + 4], s[8 * ks + 5]);
        a[ks][3] = pack_bf16x2(s[8 * ks + 6], s[8 * ks + 7]);
      }
      fence_regs(acc);
      wgmma_fence();
      // K MN-major: the two 64-column halves 8 KB apart, groups of 8 keys 1 KB apart
      const uint64_t d_kt = wgmma_desc(sk, kT * 64 * 2, 1024);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) wgmma_64x128_rs(acc, a[ks], d_kt + ((ks * 16 * 128) >> 4));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);
  }

  if (row_a < T) {
    bf16* dst = dq + ((long long)row_a * H + h) * kD + 2 * t;
#pragma unroll
    for (int nb = 0; nb < kD / 8; ++nb)
      *reinterpret_cast<uint32_t*>(dst + nb * 8) =
          pack_bf16x2(acc[4 * nb] * scale, acc[4 * nb + 1] * scale);
  }
  if (row_b < T) {
    bf16* dst = dq + ((long long)row_b * H + h) * kD + 2 * t;
#pragma unroll
    for (int nb = 0; nb < kD / 8; ++nb)
      *reinterpret_cast<uint32_t*>(dst + nb * 8) =
          pack_bf16x2(acc[4 * nb + 2] * scale, acc[4 * nb + 3] * scale);
  }
}

// ---------------------------------------------------------------------------------------------
// dk and dv
// ---------------------------------------------------------------------------------------------

// One CTA per (64 keys, query head h); its two consumer warpgroups share the 64 keys and split
// the chain between them: warpgroup 0 takes S^T = K Q^T, P and dV += P^T dO, warpgroup 1
// dP^T = V dO^T, dS = P (dP - dsum) and dK += dS^T Q, and P goes from the one to the other
// through shared memory (two slots, each thread's 32 values where its partner thread, which
// holds the same elements of dP^T, reads them). Each consumer keeps one 64 x 128 fp32
// accumulator: the two (128 registers) in one warpgroup did not fit its register budget, and
// the compiler serialised the products and spilled.
constexpr int kDkvThreads = kConsumers + 32;
constexpr int kAuxBytes = kT * 16 + 2 * kT * 4;  // a stage's query ids, lse and dsum
constexpr int kPSlot = kT * kT / 4;               // float4s of one P slot
// K and V tiles, the Q/dO ring, the ring's ids/lse/dsum, two P slots, mbarriers, slack
constexpr int kDkvSmem = (2 + 2 * kStages) * kTileBytes + kStages * kAuxBytes +
                         2 * kPSlot * 16 + 8 * (2 * kStages + 5) + 1024;

__global__ void __launch_bounds__(kDkvThreads, 1)
    bwd_dkv_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap domap, const float* __restrict__ lse2,
                   const float* __restrict__ dsum, const int4* __restrict__ ids4,
                   const int* __restrict__ list, const int* __restrict__ count,
                   float* __restrict__ ws, int T, int H, int Hk, int n64, float scale) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* s_k = reinterpret_cast<bf16*>(align1024(smem_raw));
  bf16* s_v = s_k + kTile;
  bf16* s_ring = s_v + kTile;  // [kStages][Q tile, dO tile]
  uint8_t* s_aux = reinterpret_cast<uint8_t*>(s_ring + 2 * kStages * kTile);  // [kStages]
  float4* s_p = reinterpret_cast<float4*>(s_aux + kStages * kAuxBytes);  // [2][4 warps][8][32]
  uint64_t* full = reinterpret_cast<uint64_t*>(s_p + 2 * kPSlot);
  uint64_t* empty = full + kStages;
  uint64_t* kvbar = empty + kStages;
  uint64_t* pfull = kvbar + 1;  // [2] a slot holds P
  uint64_t* pempty = pfull + 2;  // [2] warpgroup 1 has read a slot

  const int kt = blockIdx.x, h = blockIdx.y, k0 = kt * kT, half = kt & 1;
  const int G = H / Hk, hk = h / G, gh = h - hk * G;
  const int* plan = list + (long long)(kt >> 1) * n64;  // the list of the 128 keys around
  const int n = count[kt >> 1];
  const int Tp = n64 * kT;
  if (threadIdx.x == 0)
    for (int i = 0; i < 2; ++i) {
      mbar_init(pfull + i, kConsumers / 2);
      mbar_init(pempty + i, kConsumers / 2);
    }
  init_barriers(full, empty, kvbar);

  if (threadIdx.x >= kConsumers) {  // the producer warp
    if (threadIdx.x != kConsumers) return;
    mbar_expect_tx(kvbar, 2 * kTileBytes);
    tma_tile(s_k, &kmap, kvbar, k0, hk);
    tma_tile(s_v, &vmap, kvbar, k0, hk);
    for (int i = 0, pos = 0; i < n; ++i) {
      const int e = plan[i];
      if (((e >> (kEntryShift + 2 * half)) & 3) == kDead) continue;  // none of these keys
      const int st = pos % kStages;
      if (pos >= kStages) mbar_wait(empty + st, ((pos / kStages) - 1) & 1);
      const int r0 = (e & 0xffff) * kT;
      uint8_t* aux = s_aux + st * kAuxBytes;
      mbar_expect_tx(full + st, 2 * kTileBytes + kAuxBytes);
      tma_tile(s_ring + st * 2 * kTile, &qmap, full + st, r0, h);
      tma_tile(s_ring + st * 2 * kTile + kTile, &domap, full + st, r0, h);
      bulk_load(aux, ids4 + r0, kT * 16, full + st);
      bulk_load(aux + kT * 16, lse2 + (long long)h * Tp + r0, kT * 4, full + st);
      bulk_load(aux + kT * 20, dsum + (long long)h * Tp + r0, kT * 4, full + st);
      ++pos;
    }
    return;
  }

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int key_a = k0 + warp * 16 + (lane >> 2), key_b = key_a + 8;
  const int4 ia = ids4[key_a], ib = ids4[key_b];
  const float sl2 = scale * kLog2e;
  float acc[64];  // dV (warpgroup 0) or dK (warpgroup 1) of the 64 keys
#pragma unroll
  for (int x = 0; x < 64; ++x) acc[x] = 0.f;
  const uint64_t d_a = wgmma_desc(wg == 0 ? s_k : s_v, 16, 1024);
  mbar_wait(kvbar, 0);

  for (int i = 0, pos = 0; i < n; ++i) {
    const int e = plan[i];
    const int code = (e >> (kEntryShift + 2 * half)) & 3;
    if (code == kDead) continue;  // CTA-uniform, as in the producer
    const int st = pos % kStages, slot = pos & 1, use = pos >> 1;
    const int r0 = (e & 0xffff) * kT;
    mbar_wait(full + st, (pos / kStages) & 1);
    const bf16* sq = s_ring + st * 2 * kTile;
    const bf16* sdo = sq + kTile;
    const uint8_t* aux = s_aux + st * kAuxBytes;
    // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1): rows are keys, columns query
    // rows r0 + c
    float x[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) x[j] = 0.f;
    fence_regs(x);
    wgmma_fence();
    const uint64_t d_b = wgmma_desc(wg == 0 ? sq : sdo, 16, 1024);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) wgmma_64x64_ss(x, d_a + kstep(kk), d_b + kstep(kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(x);
    float4* mine = s_p + slot * kPSlot + warp * 8 * 32 + lane;  // chunk nt at mine[nt * 32]
    if (wg == 0) {
      // p = 2^(s sl2 - lse2), selected to 0 where masked (partial pairs only); each query row's
      // lse and ids are read next to their use, two columns a step
      const float* q_lse = reinterpret_cast<const float*>(aux + kT * 16);
      const int4* qid = reinterpret_cast<const int4*>(aux);
#pragma unroll
      for (int nt = 0; nt < kT / 8; ++nt) {
        const int c = nt * 8 + 2 * t;
        const float2 l = *reinterpret_cast<const float2*>(q_lse + c);
        x[4 * nt + 0] = ex2(fmaf(x[4 * nt + 0], sl2, -l.x));
        x[4 * nt + 1] = ex2(fmaf(x[4 * nt + 1], sl2, -l.y));
        x[4 * nt + 2] = ex2(fmaf(x[4 * nt + 2], sl2, -l.x));
        x[4 * nt + 3] = ex2(fmaf(x[4 * nt + 3], sl2, -l.y));
        if (code == kPartial) {
          const int4 u0 = qid[c], u1 = qid[c + 1];
          x[4 * nt + 0] = allowed(r0 + c, key_a, u0, ia, T) ? x[4 * nt + 0] : 0.f;
          x[4 * nt + 1] = allowed(r0 + c + 1, key_a, u1, ia, T) ? x[4 * nt + 1] : 0.f;
          x[4 * nt + 2] = allowed(r0 + c, key_b, u0, ib, T) ? x[4 * nt + 2] : 0.f;
          x[4 * nt + 3] = allowed(r0 + c + 1, key_b, u1, ib, T) ? x[4 * nt + 3] : 0.f;
        }
        asm volatile("" ::: "memory");
      }
      if (use > 0) mbar_wait(pempty + slot, (use - 1) & 1);
#pragma unroll
      for (int nt = 0; nt < kT / 8; ++nt)
        mine[nt * 32] = make_float4(x[4 * nt], x[4 * nt + 1], x[4 * nt + 2], x[4 * nt + 3]);
      mbar_arrive(pfull + slot);
    } else {
      // dS^T = P^T (dP^T - dsum), P from warpgroup 0
      const float* q_dsum = reinterpret_cast<const float*>(aux + kT * 20);
      mbar_wait(pfull + slot, use & 1);
#pragma unroll
      for (int nt = 0; nt < kT / 8; ++nt) {
        const float4 p = mine[nt * 32];
        const float2 d = *reinterpret_cast<const float2*>(q_dsum + nt * 8 + 2 * t);
        x[4 * nt + 0] = p.x * (x[4 * nt + 0] - d.x);
        x[4 * nt + 1] = p.y * (x[4 * nt + 1] - d.y);
        x[4 * nt + 2] = p.z * (x[4 * nt + 2] - d.x);
        x[4 * nt + 3] = p.w * (x[4 * nt + 3] - d.y);
      }
      mbar_arrive(pempty + slot);
    }
    uint32_t a[4][4];  // P^T or dS^T as the A operand: query rows 16ks .. 16ks + 15
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) a[ks][r] = pack_bf16x2(x[8 * ks + 2 * r], x[8 * ks + 2 * r + 1]);
    fence_regs(acc);
    wgmma_fence();
    // dO (for dV) or Q (for dK) MN-major, from the tile that fed the K-major product
    const uint64_t d_bt = wgmma_desc(wg == 0 ? sdo : sq, kT * 64 * 2, 1024);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_64x128_rs(acc, a[ks], d_bt + ((ks * 16 * 128) >> 4));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);
    ++pos;
  }

  // this head's partial: ws[0 (dk) or 1 (dv)][gh][hk][key][D], fp32, every key of the tile
  float* dst = ws + (wg == 0 ? (long long)G * Hk * Tp * kD : 0) +
               ((long long)(gh * Hk + hk) * Tp) * kD + 2 * t;
#pragma unroll
  for (int nb = 0; nb < kD / 8; ++nb) {
    *reinterpret_cast<float2*>(dst + (long long)key_a * kD + nb * 8) =
        make_float2(acc[4 * nb], acc[4 * nb + 1]);
    *reinterpret_cast<float2*>(dst + (long long)key_b * kD + nb * 8) =
        make_float2(acc[4 * nb + 2], acc[4 * nb + 3]);
  }
}

// dk[key, hk] = bf16(scale * sum_gh ws[0][gh][hk][key]), dv likewise without the scale, the
// partials added in head order; one thread per 4 columns of a (key, KV head) row below T.
__global__ void __launch_bounds__(256)
    bwd_dkv_combine_kernel(const float* __restrict__ ws, bf16* __restrict__ dk,
                           bf16* __restrict__ dv, int T, int Hk, int G, int Tp, float scale) {
  const long long idx = (long long)blockIdx.x * 256 + threadIdx.x;
  if (idx >= (long long)T * Hk * (kD / 4)) return;
  const int c = static_cast<int>(idx % (kD / 4)) * 4;
  const long long row = idx / (kD / 4);
  const int key = static_cast<int>(row / Hk), hk = static_cast<int>(row % Hk);
  const long long plane = (long long)G * Hk * Tp * kD;
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
  for (int gh = 0; gh < G; ++gh) {
    const long long off = ((long long)(gh * Hk + hk) * Tp + key) * kD + c;
    const float4 a = *reinterpret_cast<const float4*>(ws + off);
    const float4 b = *reinterpret_cast<const float4*>(ws + plane + off);
    sk.x += a.x;
    sk.y += a.y;
    sk.z += a.z;
    sk.w += a.w;
    sv.x += b.x;
    sv.y += b.y;
    sv.z += b.z;
    sv.w += b.w;
  }
  const long long o = row * kD + c;
  *reinterpret_cast<uint2*>(dk + o) =
      make_uint2(pack_bf16x2(sk.x * scale, sk.y * scale), pack_bf16x2(sk.z * scale, sk.w * scale));
  *reinterpret_cast<uint2*>(dv + o) = make_uint2(pack_bf16x2(sv.x, sv.y), pack_bf16x2(sv.z, sv.w));
}

// The tensor map of a [T, heads, D] bf16 array with the given row and head strides (elements).
bool encode_rows(CUtensorMap* map, const void* base, int T, int heads, long long rs,
                 long long hs) {
  return flash::encode_kv_map(map, base, 1, heads, T, kD, (long long)T * rs, hs, rs);
}

bool bad_shape(int T, int H, int Hk, int D) {
  return T <= 0 || Hk <= 0 || H <= 0 || H % Hk != 0 || H > 65535 || D != kD ||
         (T + kRows - 1) / kRows * 2 > 0xffff;
}

const int* i32(const void* p) { return static_cast<const int*>(p); }
int* i32(void* p) { return static_cast<int*>(p); }

}  // namespace k5

// The plan of one sequence from the ids (int32 [T]). With n128 = ceil(T / 128), n64 = 2 n128 and
// T_pad = 64 n64, it writes ids4 (int32 [T_pad, 4]), states (uint8 [n64, n64], scratch), dq_list
// and dkv_list (int32 [n128, n64], the first count[x] entries of row x), dq_count, dkv_count and
// dq_order (int32 [n128]). Three launches; returns a cudaError_t.
extern "C" int unimedvl_packed_train_attention_plan(const void* doc, const void* fn,
                                                    const void* nz, void* ids4, void* states,
                                                    void* dq_list, void* dq_count,
                                                    void* dkv_list, void* dkv_count,
                                                    void* dq_order, int T, void* stream) {
  using namespace k5;
  if (bad_shape(T, 1, 1, kD)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n128 = (T + kRows - 1) / kRows, n64 = 2 * n128;
  plan_classes_kernel<<<dim3(n64, kStateSplit + 1), kPrepThreads, 0, st>>>(
      i32(doc), i32(fn), i32(nz), static_cast<int4*>(ids4), static_cast<uint8_t*>(states), T,
      n64);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  plan_lists_kernel<<<dim3(n128, 2), 32, 0, st>>>(static_cast<const uint8_t*>(states),
                                                   i32(dq_list), i32(dq_count), i32(dkv_list),
                                                   i32(dkv_count), n64);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  plan_order_kernel<<<1, kOrderThreads, 0, st>>>(i32(dq_count), i32(dq_order), n128);
  return static_cast<int>(cudaGetLastError());
}

// out [T, H, D] bf16 contiguous and lse fp32 [H, T] from q, k, v ([T, heads, D] with the given
// row and head strides in elements, multiples of 8) and the plan's ids4, dq_list, dq_count,
// dq_order.
extern "C" int unimedvl_packed_train_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse, const void* ids4,
    const void* dq_list, const void* dq_count, const void* dq_order, int T, int H, int Hk, int D,
    long long q_rs, long long q_hs, long long k_rs, long long k_hs, long long v_rs,
    long long v_hs, float scale, void* stream) {
  using namespace k5;
  if (bad_shape(T, H, Hk, D)) return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_set[64] = {};
  cudaError_t err = flash::allow_smem(fwd_sweep_kernel, kFwdSmem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap qmap, kmap, vmap;
  if (!encode_rows(&qmap, q, T, H, q_rs, q_hs) || !encode_rows(&kmap, k, T, Hk, k_rs, k_hs) ||
      !encode_rows(&vmap, v, T, Hk, v_rs, v_hs))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n128 = (T + kRows - 1) / kRows;
  fwd_sweep_kernel<<<dim3(H, n128), kFwdThreads, kFwdSmem, static_cast<cudaStream_t>(stream)>>>(
      qmap, kmap, vmap, static_cast<const int4*>(ids4), i32(dq_list), i32(dq_count),
      i32(dq_order), static_cast<bf16*>(out), static_cast<float*>(lse), T, H, Hk, 2 * n128, scale);
  return static_cast<int>(cudaGetLastError());
}

// The backward's row data from do (bf16 [T, H, D], row and head strides do_rs, do_hs in
// elements, multiples of 4), out (bf16 [T, H, D] contiguous) and lse (fp32 [H, T]): lse2 and dsum
// (fp32 [H, T_pad]). One launch; returns a cudaError_t.
extern "C" int unimedvl_packed_train_attention_bwd_rows(const void* dout, const void* out,
                                                        const void* lse, void* lse2, void* dsum,
                                                        int T, int H, int D, long long do_rs,
                                                        long long do_hs, void* stream) {
  using namespace k5;
  if (bad_shape(T, H, 1, D)) return static_cast<int>(cudaErrorInvalidValue);
  const int n64 = 2 * ((T + kRows - 1) / kRows);
  bwd_rows_kernel<<<dim3(n64, H), kPrepThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(dout), do_rs, do_hs, static_cast<const bf16*>(out),
      static_cast<const float*>(lse), static_cast<float*>(lse2), static_cast<float*>(dsum), T, H,
      n64);
  return static_cast<int>(cudaGetLastError());
}
// dq [T, H, D] bf16 contiguous from q, k, v, do ([T, heads, D] with the given row and head
// strides in elements, multiples of 8) and the plan's ids4, lse2, dsum, dq_list, dq_count.
extern "C" int unimedvl_packed_train_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout, const void* lse2,
    const void* dsum, const void* ids4, const void* dq_list, const void* dq_count, void* dq,
    int T, int H, int Hk, int D, long long q_rs, long long q_hs, long long k_rs, long long k_hs,
    long long v_rs, long long v_hs, long long do_rs, long long do_hs, float scale, void* stream) {
  using namespace k5;
  if (bad_shape(T, H, Hk, D)) return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_set[64] = {};
  cudaError_t err = flash::allow_smem(bwd_dq_kernel, kDqSmem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap qmap, kmap, vmap, domap;
  if (!encode_rows(&qmap, q, T, H, q_rs, q_hs) || !encode_rows(&kmap, k, T, Hk, k_rs, k_hs) ||
      !encode_rows(&vmap, v, T, Hk, v_rs, v_hs) || !encode_rows(&domap, dout, T, H, do_rs, do_hs))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n128 = (T + kRows - 1) / kRows;
  bwd_dq_kernel<<<dim3(n128, H), kDqThreads, kDqSmem, static_cast<cudaStream_t>(stream)>>>(
      qmap, kmap, vmap, domap, static_cast<const float*>(lse2), static_cast<const float*>(dsum),
      static_cast<const int4*>(ids4), i32(dq_list), i32(dq_count), static_cast<bf16*>(dq), T, H,
      Hk, 2 * n128, scale);
  return static_cast<int>(cudaGetLastError());
}

// dk, dv [T, Hk, D] bf16 contiguous, from the same inputs and the plan's dkv_list, dkv_count,
// through ws (fp32 [2, H / Hk, Hk, T_pad, D], scratch): the split launch and the combine launch.
extern "C" int unimedvl_packed_train_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse2,
    const void* dsum, const void* ids4, const void* dkv_list, const void* dkv_count, void* ws,
    void* dk, void* dv, int T, int H, int Hk, int D, long long q_rs, long long q_hs,
    long long k_rs, long long k_hs, long long v_rs, long long v_hs, long long do_rs,
    long long do_hs, float scale, void* stream) {
  using namespace k5;
  if (bad_shape(T, H, Hk, D)) return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_set[64] = {};
  cudaError_t err = flash::allow_smem(bwd_dkv_kernel, kDkvSmem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap qmap, kmap, vmap, domap;
  if (!encode_rows(&qmap, q, T, H, q_rs, q_hs) || !encode_rows(&kmap, k, T, Hk, k_rs, k_hs) ||
      !encode_rows(&vmap, v, T, Hk, v_rs, v_hs) || !encode_rows(&domap, dout, T, H, do_rs, do_hs))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n128 = (T + kRows - 1) / kRows, n64 = 2 * n128;
  bwd_dkv_kernel<<<dim3(n64, H), kDkvThreads, kDkvSmem, st>>>(
      qmap, kmap, vmap, domap, static_cast<const float*>(lse2), static_cast<const float*>(dsum),
      static_cast<const int4*>(ids4), i32(dkv_list), i32(dkv_count), static_cast<float*>(ws), T,
      H, Hk, n64, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long threads = (long long)T * Hk * (k5::kD / 4);
  bwd_dkv_combine_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(ws), static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, Hk, H / Hk,
      n64 * kT, scale);
  return static_cast<int>(cudaGetLastError());
}
