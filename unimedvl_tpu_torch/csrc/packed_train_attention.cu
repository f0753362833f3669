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
// Forward: one CTA of 4 warps per (64 query rows, head) on mma.sync m16n8k16 with ldmatrix
// operands; it evaluates the mask of each (64, 64) tile pair from the id vectors in shared memory
// (a vote across the CTA) before loading K/V, skips the loads and products of a dead pair, and
// applies no mask element by element on a pair in which everything is allowed.
//
// Backward (device code for wgmma, TMA and mbarriers in flash_common.cuh, shared with K1):
// - The plan, once per backward call, on the card, from the ids and T alone (two small launches,
//   no host synchronisation): every (64-row, 64-row) tile pair is classified dead, full (every
//   pair allowed, every row inside T: no mask) or partial; then, per 128 query rows, the list of
//   key tiles that either 64-row half sees (for dq), and per 128 keys the list of query tiles
//   that see either half (for dk/dv), each entry with both halves' classes, so a warpgroup
//   skips a dead half and masks only a partial one. The same launch writes dsum (fp32, from the
//   bf16 do and out), lse in log2 units (+inf for a row that sees nothing, so its p is 0
//   unmasked too), and the ids as one int4 per row, padded to the 128-row grid.
// - dq: one CTA per (128 query rows, query head): two consumer warpgroups of 64 rows and one
//   producer warp. Q and dO come once by TMA; K and V tiles of the plan's list come through a
//   ring of four stages by TMA, with the tile's ids by a bulk copy (per-stage `full` / `empty`
//   mbarriers, no CTA-wide barrier per tile). S = Q K^T and dP = dO V^T are wgmma m64n64k16 with
//   both operands in shared memory, dQ += dS K a wgmma m64n128k16 with dS in registers (the
//   accumulator layout is the A operand's) and K read MN-major from the tile that fed Q K^T.
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

namespace {

constexpr float kNegInf = -3.402823466e38f;  // finfo(float32).min, the TPU kernel's mask value
constexpr int kD = 128;                       // head dim
constexpr int kDP = kD + 8;                   // shared row stride: conflict-free fragment loads
constexpr int kB = 64;                        // rows of a query tile and of a key tile (forward)
constexpr int kThreads = 128;
constexpr int kKSteps = kD / 16;
constexpr int kDTiles = kD / 8;

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four 8 x 8 bf16 matrices of a shared tile in one instruction: lane l gives the address of row
// l % 8 of matrix l / 8 (16 bytes, 16-byte aligned); r[m] is this lane's fragment of matrix m
// (row lane / 4, columns 2 (lane % 4) and + 1; with .trans: rows 2 (lane % 4) and + 1, column
// lane / 4), which is the layout mma.m16n8k16 takes its operands in.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The A operand (rows row0 .. row0 + 15, columns c0 .. c0 + 15 of a shared tile).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int row0, int c0,
                                       int lane) {
  const int m = lane >> 3, r = lane & 7;
  ldsm_x4(a, tile + (row0 + (m & 1) * 8 + r) * kDP + c0 + (m >> 1) * 8);
}

// B operands of a product whose B[k][n] = tile[n][k] (the tile's rows are the n axis: K for
// Q K^T): b[0], b[1] for columns n0 .. n0 + 7 and b[2], b[3] for
// n0 + 8 .. n0 + 15, over k0 .. k0 + 15.
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4], const __nv_bfloat16* tile, int n0,
                                            int k0, int lane) {
  const int m = lane >> 3, r = lane & 7;
  ldsm_x4(b, tile + (n0 + (m >> 1) * 8 + r) * kDP + k0 + (m & 1) * 8);
}

// B operands of a product whose B[k][n] = tile[k][n] (the tile's rows are the k axis: V for
// P V): b[0], b[1] for columns n0 .. n0 + 7 and b[2], b[3] for n0 + 8 .. n0 + 15, over rows
// k0 .. k0 + 15.
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[4], const __nv_bfloat16* tile, int k0,
                                            int n0, int lane) {
  const int m = lane >> 3, r = lane & 7;
  ldsm_x4_t(b, tile + (k0 + (m & 1) * 8 + r) * kDP + n0 + (m >> 1) * 8);
}

// Rows [r0, r0 + 64) of a bf16 matrix with kD contiguous columns and a row stride of `stride`
// elements -> shared tile [64][kDP]; rows at or past n_rows become zero.
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile, const __nv_bfloat16* src,
                                          long long stride, int r0, int n_rows) {
  constexpr int kVecs = kD / 8;
  for (int idx = threadIdx.x; idx < kB * kVecs; idx += kThreads) {
    const int r = idx / kVecs, c = idx - r * kVecs;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n_rows)
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * stride + c * 8);
    *reinterpret_cast<uint4*>(tile + r * kDP + c * 8) = val;
  }
}

// The ids of rows [r0, r0 + 64) -> ids[0..2][64] (doc, fn, noise); rows past T get -1, and are
// excluded by index wherever the mask is evaluated.
__device__ __forceinline__ void load_ids(int (*ids)[kB], const int* doc, const int* fn,
                                         const int* nz, int r0, int T) {
  if (threadIdx.x < kB) {
    const int r = r0 + threadIdx.x;
    const bool in = r < T;
    ids[0][threadIdx.x] = in ? doc[r] : -1;
    ids[1][threadIdx.x] = in ? fn[r] : -1;
    ids[2][threadIdx.x] = in ? nz[r] : -1;
  }
}

// May query i (ids di, fi, ni) attend to key j (ids dj, fj, nj)?
__device__ __forceinline__ bool allowed(int i, int j, int di, int dj, int fi, int fj, int ni,
                                        int nj) {
  return (i >= j || (fi == fj && fi >= 0)) && !(nj >= 0 && ni != nj) && di == dj;
}

// What a tile pair holds: kDead (no allowed pair: skipped), kFull (every pair allowed, all rows
// inside T: no mask to apply element by element) or kPartial. Each thread tries one key column
// against 32 query rows, then the CTA votes (the votes are barriers too).
constexpr int kDead = 0, kPartial = 1, kFull = 2;

__device__ __forceinline__ int tile_state(int (*qid)[kB], int (*kid)[kB], int q0, int k0, int T) {
  const int c = threadIdx.x & (kB - 1), r0 = (threadIdx.x >> 6) * 32;
  const int j = k0 + c;
  int any = 0, all = j < T;
  if (j < T) {
    const int dj = kid[0][c], fj = kid[1][c], nj = kid[2][c];
#pragma unroll 8
    for (int r = r0; r < r0 + 32; ++r) {
      const int i = q0 + r;
      const int ok = (i < T) && allowed(i, j, qid[0][r], dj, qid[1][r], fj, qid[2][r], nj);
      any |= ok;
      all &= ok;
    }
  }
  if (!__syncthreads_or(any)) return kDead;  // uniform across the CTA
  return __syncthreads_and(all) ? kFull : kPartial;
}

// ---------------------------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------------------------

// Three CTAs per SM (168 registers): the kernel is bound by latency, and measured slower both
// with two CTAs of more registers and with four whose registers spill.
__global__ void __launch_bounds__(kThreads, 3)
    packed_train_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                            float* __restrict__ lse, const int* __restrict__ doc,
                            const int* __restrict__ fn, const int* __restrict__ nz, int T, int H,
                            int Hk, long long q_rs, long long k_rs, long long v_rs, float scale) {
  __shared__ __align__(16) __nv_bfloat16 s_k[kB * kDP];  // the Q tile, then each K tile
  __shared__ __align__(16) __nv_bfloat16 s_v[kB * kDP];
  __shared__ int s_qid[3][kB];
  __shared__ int s_kid[3][kB];

  const int h = blockIdx.y, q0 = blockIdx.x * kB;
  const int hk = h / (H / Hk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  load_tile(s_k, q + (long long)h * kD, q_rs, q0, T);
  load_ids(s_qid, doc, fn, nz, q0, T);
  __syncthreads();
  uint32_t qf[kKSteps][4];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) load_a(qf[kk], s_k, warp * 16, kk * 16, lane);
  const int ra = warp * 16 + g, rb = ra + 8;
  const int row_a = q0 + ra, row_b = q0 + rb;
  const int da = s_qid[0][ra], fa = s_qid[1][ra], na = s_qid[2][ra];
  const int db = s_qid[0][rb], fb = s_qid[1][rb], nb = s_qid[2][rb];
  __syncthreads();

  float o[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;  // l: this thread's columns only

  const __nv_bfloat16* k_base = k + (long long)hk * kD;
  const __nv_bfloat16* v_base = v + (long long)hk * kD;

  for (int n0 = 0; n0 < T; n0 += kB) {
    load_ids(s_kid, doc, fn, nz, n0, T);
    __syncthreads();
    const int state = tile_state(s_qid, s_kid, q0, n0, T);
    if (state == kDead) continue;
    const bool full = state == kFull;
    load_tile(s_k, k_base, k_rs, n0, T);
    load_tile(s_v, v_base, v_rs, n0, T);
    __syncthreads();

    float sc[kB / 8][4];
#pragma unroll
    for (int nt = 0; nt < kB / 8; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
      for (int np = 0; np < kB / 16; ++np) {
        uint32_t b[4];
        load_b_rows(b, s_k, np * 16, kk * 16, lane);
        mma_16816(sc[2 * np], qf[kk], b[0], b[1]);
        mma_16816(sc[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }

    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int nt = 0; nt < kB / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool ok = true;
        if (!full) {
          const int c = nt * 8 + 2 * t + (e & 1);
          const int j = n0 + c;
          const int dj = s_kid[0][c], fj = s_kid[1][c], nj = s_kid[2][c];
          ok = j < T && (e < 2 ? (row_a < T && allowed(row_a, j, da, dj, fa, fj, na, nj))
                               : (row_b < T && allowed(row_b, j, db, dj, fb, fj, nb, nj)));
        }
        const float x = ok ? sc[nt][e] * scale : kNegInf;
        sc[nt][e] = x;
        if (e < 2)
          mx_a = fmaxf(mx_a, x);
        else
          mx_b = fmaxf(mx_b, x);
      }
    }
#pragma unroll
    for (int w = 1; w <= 2; w <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, w));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, w));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float al_a = __expf(m_a - mn_a), al_b = __expf(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;

    // P = exp(S - m); a masked key (logit == kNegInf, which no allowed logit reaches) weighs 0.
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int nt = 0; nt < kB / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = sc[nt][e];
        const float p = x > kNegInf ? __expf(x - (e < 2 ? mn_a : mn_b)) : 0.f;
        sc[nt][e] = p;
        if (e < 2)
          sum_a += p;
        else
          sum_b += p;
      }
    }
    l_a = l_a * al_a + sum_a;
    l_b = l_b * al_b + sum_b;
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      o[dt][0] *= al_a;
      o[dt][1] *= al_a;
      o[dt][2] *= al_b;
      o[dt][3] *= al_b;
    }

    // O += P V: the S accumulators of two adjacent key n-tiles form one A fragment.
#pragma unroll
    for (int kk = 0; kk < kB / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(sc[2 * kk][0], sc[2 * kk][1]);
      pa[1] = pack_bf16x2(sc[2 * kk][2], sc[2 * kk][3]);
      pa[2] = pack_bf16x2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[3] = pack_bf16x2(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < kDTiles / 2; ++dp) {
        uint32_t b[4];
        load_b_cols(b, s_v, kk * 16, dp * 16, lane);
        mma_16816(o[2 * dp], pa, b[0], b[1]);
        mma_16816(o[2 * dp + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // the next step overwrites s_k, s_v and s_kid
  }

#pragma unroll
  for (int w = 1; w <= 2; w <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, w);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, w);
  }
  const float ls_a = fmaxf(l_a, 1e-30f), ls_b = fmaxf(l_b, 1e-30f);
  const float inv_a = 1.f / ls_a, inv_b = 1.f / ls_b;
  if (row_a < T) {
    __nv_bfloat16* dst = out + ((long long)row_a * H + h) * kD + 2 * t;
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt)
      *reinterpret_cast<uint32_t*>(dst + dt * 8) = pack_bf16x2(o[dt][0] * inv_a, o[dt][1] * inv_a);
    if (t == 0) lse[(long long)h * T + row_a] = l_a > 0.f ? m_a + logf(ls_a) : kNegInf;
  }
  if (row_b < T) {
    __nv_bfloat16* dst = out + ((long long)row_b * H + h) * kD + 2 * t;
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt)
      *reinterpret_cast<uint32_t*>(dst + dt * 8) = pack_bf16x2(o[dt][2] * inv_b, o[dt][3] * inv_b);
    if (t == 0) lse[(long long)h * T + row_b] = l_b > 0.f ? m_b + logf(ls_b) : kNegInf;
  }
}

bool bad_shape(int T, int H, int Hk, int D) {
  return T <= 0 || Hk <= 0 || H <= 0 || H % Hk != 0 || H > 65535 || D != kD;
}

const __nv_bfloat16* bf(const void* p) { return static_cast<const __nv_bfloat16*>(p); }
const int* i32(const void* p) { return static_cast<const int*>(p); }

}  // namespace

// ---------------------------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------------------------

namespace k5bwd {

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

constexpr float kMin = -3.402823466e38f;  // the lse of a row that sees nothing
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

// grid (n64, kStateSplit + 1 + H), n64 = T_pad / 64 tiles of the 128-row grid.
// y < kStateSplit: the classes of pairs (query tile x, key tiles of chunk y), one warp a pair,
//   each lane two key columns against the 64 rows;
// y == kStateSplit: the ids of the tile's rows as int4 (doc, fn, noise, 0), zeros past T;
// y > kStateSplit: head y - kStateSplit - 1: dsum and lse in log2 units of the tile's rows
//   (0 past T), one warp a row.
__global__ void __launch_bounds__(kPrepThreads)
    bwd_prep_kernel(const int* __restrict__ doc, const int* __restrict__ fn,
                    const int* __restrict__ nz, const bf16* __restrict__ dout, long long do_rs,
                    long long do_hs, const bf16* __restrict__ out, const float* __restrict__ lse,
                    int4* __restrict__ ids4, float* __restrict__ lse2, float* __restrict__ dsum,
                    uint8_t* __restrict__ states, int T, int H, int n64) {
  const int qa = blockIdx.x, role = blockIdx.y, r0 = qa * kT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Tp = n64 * kT;
  if (role < kStateSplit) {
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
  } else if (role == kStateSplit) {
    if (threadIdx.x < kT) {
      const int i = r0 + threadIdx.x;
      ids4[i] = i < T ? make_int4(doc[i], fn[i], nz[i], 0) : make_int4(0, 0, 0, 0);
    }
  } else {
    const int h = role - kStateSplit - 1;
    for (int r = warp; r < kT; r += kPrepThreads / 32) {
      const int i = r0 + r;
      float acc = 0.f, l2 = 0.f;
      if (i < T) {  // warp-uniform
        const uint2 a = *reinterpret_cast<const uint2*>(dout + i * do_rs + h * do_hs + lane * 4);
        const uint2 b =
            *reinterpret_cast<const uint2*>(out + ((long long)i * H + h) * kD + lane * 4);
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
}

// grid (n128, 2), one warp: y = 0, the dq list of query tile x (its key tiles that either
// 64-row half sees, in order); y = 1, the dk/dv list of key tile x (the query tiles that see
// either half). Entry: tile index | (class of half 0 | class of half 1 << 2) << 16.
__global__ void __launch_bounds__(32)
    bwd_lists_kernel(const uint8_t* __restrict__ states, int* __restrict__ dq_list,
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

bool bad_bwd_shape(int T, int H, int Hk, int D) {
  return T <= 0 || Hk <= 0 || H <= 0 || H % Hk != 0 || H > 65535 || D != kD ||
         (T + kRows - 1) / kRows * 2 > 0xffff;
}

}  // namespace k5bwd

// Every tensor [T, heads, D] with D contiguous, a head stride of D and the given row stride in
// elements; out [T, H, D] contiguous; lse fp32 [H, T]; doc, fn, nz int32 [T]. Returns a
// cudaError_t.
extern "C" int unimedvl_packed_train_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse, const void* doc,
    const void* fn, const void* nz, int T, int H, int Hk, int D, long long q_rs, long long k_rs,
    long long v_rs, float scale, void* stream) {
  if (bad_shape(T, H, Hk, D)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((T + kB - 1) / kB, H);
  packed_train_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      bf(q), bf(k), bf(v), static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), i32(doc),
      i32(fn), i32(nz), T, H, Hk, q_rs, k_rs, v_rs, scale);
  return static_cast<int>(cudaGetLastError());
}

// The backward's plan and row data, from do (bf16 [T, H, D], row and head strides do_rs, do_hs
// in elements, multiples of 8), out (bf16 [T, H, D] contiguous), lse (fp32 [H, T]) and the ids
// (int32 [T]). With n128 = ceil(T / 128), n64 = 2 n128 and T_pad = 64 n64, it writes ids4
// (int32 [T_pad, 4]), lse2 and dsum (fp32 [H, T_pad]), states (uint8 [n64, n64], scratch),
// dq_list and dkv_list (int32 [n128, n64], the first count[x] entries of row x) and dq_count,
// dkv_count (int32 [n128]). Two launches; returns a cudaError_t.
extern "C" int unimedvl_packed_train_attention_bwd_plan(
    const void* dout, const void* out, const void* lse, const void* doc, const void* fn,
    const void* nz, void* ids4, void* lse2, void* dsum, void* states, void* dq_list,
    void* dq_count, void* dkv_list, void* dkv_count, int T, int H, int D, long long do_rs,
    long long do_hs, void* stream) {
  using namespace k5bwd;
  if (bad_bwd_shape(T, H, 1, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n128 = (T + kRows - 1) / kRows, n64 = 2 * n128;
  bwd_prep_kernel<<<dim3(n64, kStateSplit + 1 + H), kPrepThreads, 0, st>>>(
      i32(doc), i32(fn), i32(nz), bf(dout), do_rs, do_hs, bf(out), static_cast<const float*>(lse),
      static_cast<int4*>(ids4), static_cast<float*>(lse2), static_cast<float*>(dsum),
      static_cast<uint8_t*>(states), T, H, n64);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_lists_kernel<<<dim3(n128, 2), 32, 0, st>>>(
      static_cast<const uint8_t*>(states), static_cast<int*>(dq_list),
      static_cast<int*>(dq_count), static_cast<int*>(dkv_list), static_cast<int*>(dkv_count), n64);
  return static_cast<int>(cudaGetLastError());
}

// dq [T, H, D] bf16 contiguous from q, k, v, do ([T, heads, D] with the given row and head
// strides in elements, multiples of 8) and the plan's ids4, lse2, dsum, dq_list, dq_count.
extern "C" int unimedvl_packed_train_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout, const void* lse2,
    const void* dsum, const void* ids4, const void* dq_list, const void* dq_count, void* dq,
    int T, int H, int Hk, int D, long long q_rs, long long q_hs, long long k_rs, long long k_hs,
    long long v_rs, long long v_hs, long long do_rs, long long do_hs, float scale, void* stream) {
  using namespace k5bwd;
  if (bad_bwd_shape(T, H, Hk, D)) return static_cast<int>(cudaErrorInvalidValue);
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
  using namespace k5bwd;
  if (bad_bwd_shape(T, H, Hk, D)) return static_cast<int>(cudaErrorInvalidValue);
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
  const long long threads = (long long)T * Hk * (k5bwd::kD / 4);
  bwd_dkv_combine_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(ws), static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, Hk, H / Hk,
      n64 * kT, scale);
  return static_cast<int>(cudaGetLastError());
}
