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
// lse = -FLT_MAX. Backward, from do (rounded to bf16 by the caller), lse and
// dsum[h, i] = sum_d do . out (fp32, from the caller): p = exp(s - lse) SELECTED to 0 where
// masked, ds = p (dp - dsum) with dp = do . v^T, and
//   dq = ds k / sqrt(D),   dk = ds^T q / sqrt(D),   dv = p^T do,
// dk and dv summed over the G = H / Hk query heads of the KV head and over all query rows.
// D = 128 only. T is any length: rows at or past T are zero-filled in shared memory, masked out
// and never stored, so the caller pads nothing and transposes nothing ([T, H, D] is read through
// its row stride).
//
// What bounds them on the H100: operations. A live (64 query, 64 key) tile pair costs
// 4 * 64 * 64 * D flops forward and 10 * 64 * 64 * D backward against 2 * 64 * D bf16 loads that
// the G heads of a group and neighbouring CTAs share through L2, so the tensor cores' rate
// sets the time, and the only large saving is not to touch tile pairs in which nothing is
// allowed: packed documents are block-diagonal and noise spans are hidden from every later token.
// What the design does about it: every kernel evaluates the mask for a tile pair from the six id
// vectors in shared memory (votes across the CTA) BEFORE loading K/V or Q/dO, and skips the
// loads and all products of a dead pair; a pair in which everything is allowed (the inside of a
// full or noise span, the tiles below a causal diagonal) applies no mask element by element.
// Products run on mma.sync m16n8k16 (bf16 in, fp32 accumulate); p and ds are rounded to bf16
// for the second product of each chain.
// Operands reach the tensor cores through ldmatrix (x4: four 8 x 8 matrices, the operands of two
// mma.sync, per instruction; .trans where the tile's rows are the product's k axis).
//   forward and dq: one CTA of 4 warps per (64 query rows, head); each warp owns 16 rows and keeps
//     its Q (and dO) fragments, the row statistics and the O or dQ accumulator in registers; K and
//     V tiles of 64 keys are staged in shared memory.
//   dk/dv: one CTA per (64 keys, KV head) that loops over the query tiles and the G heads of the
//     group, works on the transposed tile (S^T = K Q^T, so each warp owns 16 KEYS) and keeps dK
//     and dV in registers until the end: no atomics, no second pass, the same bits on every run.
//     K and V stay in shared memory for the CTA's life; Q, dO, lse and dsum tiles stream through.
// The TPU kernels' lane-replicated lse/dsum, the [Hk, G, T, D] transposes, the padding to a tile
// multiple and the whole-K/V-resident grid step are Mosaic shapes and are not carried over.
// Later work: wgmma with TMA-fed tiles, cp.async double buffering, a tile-pair list built once
// per batch instead of a vote per pair.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -3.402823466e38f;  // finfo(float32).min, the TPU kernel's mask value
constexpr int kD = 128;                       // head dim
constexpr int kDP = kD + 8;                   // shared row stride: conflict-free fragment loads
constexpr int kB = 64;                        // rows of a query tile and of a key tile
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
// Q K^T, V for dO V^T, Q for K Q^T): b[0], b[1] for columns n0 .. n0 + 7 and b[2], b[3] for
// n0 + 8 .. n0 + 15, over k0 .. k0 + 15.
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4], const __nv_bfloat16* tile, int n0,
                                            int k0, int lane) {
  const int m = lane >> 3, r = lane & 7;
  ldsm_x4(b, tile + (n0 + (m >> 1) * 8 + r) * kDP + k0 + (m & 1) * 8);
}

// B operands of a product whose B[k][n] = tile[k][n] (the tile's rows are the k axis: V for
// P V, K for dS K, dO for P^T dO, Q for dS^T Q): b[0], b[1] for columns n0 .. n0 + 7 and b[2],
// b[3] for n0 + 8 .. n0 + 15, over rows k0 .. k0 + 15.
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

// ---------------------------------------------------------------------------------------------
// backward: dq
// ---------------------------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    packed_train_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               const __nv_bfloat16* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ dsum,
                               __nv_bfloat16* __restrict__ dq, const int* __restrict__ doc,
                               const int* __restrict__ fn, const int* __restrict__ nz, int T, int H,
                               int Hk, long long q_rs, long long k_rs, long long v_rs,
                               long long do_rs, float scale) {
  __shared__ __align__(16) __nv_bfloat16 s_k[kB * kDP];  // the Q tile, then each K tile
  __shared__ __align__(16) __nv_bfloat16 s_v[kB * kDP];  // the dO tile, then each V tile
  __shared__ int s_qid[3][kB];
  __shared__ int s_kid[3][kB];

  const int h = blockIdx.y, q0 = blockIdx.x * kB;
  const int hk = h / (H / Hk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  load_tile(s_k, q + (long long)h * kD, q_rs, q0, T);
  load_tile(s_v, dout + (long long)h * kD, do_rs, q0, T);
  load_ids(s_qid, doc, fn, nz, q0, T);
  __syncthreads();
  uint32_t qf[kKSteps][4], dof[kKSteps][4];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    load_a(qf[kk], s_k, warp * 16, kk * 16, lane);
    load_a(dof[kk], s_v, warp * 16, kk * 16, lane);
  }
  const int ra = warp * 16 + g, rb = ra + 8;
  const int row_a = q0 + ra, row_b = q0 + rb;
  const int da = s_qid[0][ra], fa = s_qid[1][ra], na = s_qid[2][ra];
  const int db = s_qid[0][rb], fb = s_qid[1][rb], nb = s_qid[2][rb];
  const float lse_a = row_a < T ? lse[(long long)h * T + row_a] : 0.f;
  const float lse_b = row_b < T ? lse[(long long)h * T + row_b] : 0.f;
  const float ds_a = row_a < T ? dsum[(long long)h * T + row_a] : 0.f;
  const float ds_b = row_b < T ? dsum[(long long)h * T + row_b] : 0.f;
  __syncthreads();

  float acc[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

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

    // the 64 keys in two halves of 32, to keep the S and dP tiles small in registers
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float sc[4][4], dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
        dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bk[4], bv[4];
          load_b_rows(bk, s_k, hh * 32 + np * 16, kk * 16, lane);
          load_b_rows(bv, s_v, hh * 32 + np * 16, kk * 16, lane);
          mma_16816(sc[2 * np], qf[kk], bk[0], bk[1]);
          mma_16816(sc[2 * np + 1], qf[kk], bk[2], bk[3]);
          mma_16816(dp[2 * np], dof[kk], bv[0], bv[1]);
          mma_16816(dp[2 * np + 1], dof[kk], bv[2], bv[3]);
        }
      }
      // ds = p (dp - dsum), p = exp(s - lse) selected to 0 where masked
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bool ok = true;
          if (!full) {
            const int c = (hh * 4 + n) * 8 + 2 * t + (e & 1);
            const int j = n0 + c;
            const int dj = s_kid[0][c], fj = s_kid[1][c], nj = s_kid[2][c];
            ok = j < T && (e < 2 ? (row_a < T && allowed(row_a, j, da, dj, fa, fj, na, nj))
                                 : (row_b < T && allowed(row_b, j, db, dj, fb, fj, nb, nj)));
          }
          const float p = ok ? __expf(sc[n][e] * scale - (e < 2 ? lse_a : lse_b)) : 0.f;
          sc[n][e] = p * (dp[n][e] - (e < 2 ? ds_a : ds_b));
        }
      }
      // dQ += dS K
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2) {
        const int kk = hh * 2 + k2;
        uint32_t pa[4];
        pa[0] = pack_bf16x2(sc[2 * k2][0], sc[2 * k2][1]);
        pa[1] = pack_bf16x2(sc[2 * k2][2], sc[2 * k2][3]);
        pa[2] = pack_bf16x2(sc[2 * k2 + 1][0], sc[2 * k2 + 1][1]);
        pa[3] = pack_bf16x2(sc[2 * k2 + 1][2], sc[2 * k2 + 1][3]);
#pragma unroll
        for (int dd = 0; dd < kDTiles / 2; ++dd) {
          uint32_t b[4];
          load_b_cols(b, s_k, kk * 16, dd * 16, lane);
          mma_16816(acc[2 * dd], pa, b[0], b[1]);
          mma_16816(acc[2 * dd + 1], pa, b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }

  if (row_a < T) {
    __nv_bfloat16* dst = dq + ((long long)row_a * H + h) * kD + 2 * t;
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt)
      *reinterpret_cast<uint32_t*>(dst + dt * 8) =
          pack_bf16x2(acc[dt][0] * scale, acc[dt][1] * scale);
  }
  if (row_b < T) {
    __nv_bfloat16* dst = dq + ((long long)row_b * H + h) * kD + 2 * t;
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt)
      *reinterpret_cast<uint32_t*>(dst + dt * 8) =
          pack_bf16x2(acc[dt][2] * scale, acc[dt][3] * scale);
  }
}

// ---------------------------------------------------------------------------------------------
// backward: dk and dv
// ---------------------------------------------------------------------------------------------

constexpr int kDkvTileBytes = kB * kDP * (int)sizeof(__nv_bfloat16);
constexpr int kDkvSmemBytes = 4 * kDkvTileBytes;  // K, V, Q and dO tiles: above the static limit

__global__ void __launch_bounds__(kThreads)
    packed_train_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                const __nv_bfloat16* __restrict__ dout,
                                const float* __restrict__ lse, const float* __restrict__ dsum,
                                __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                                const int* __restrict__ doc, const int* __restrict__ fn,
                                const int* __restrict__ nz, int T, int H, int Hk, long long q_rs,
                                long long k_rs, long long v_rs, long long do_rs, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* s_k = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_v = s_k + kB * kDP;
  __nv_bfloat16* s_q = s_v + kB * kDP;
  __nv_bfloat16* s_do = s_q + kB * kDP;
  __shared__ int s_qid[3][kB];
  __shared__ int s_kid[3][kB];
  __shared__ float s_lse[kB];
  __shared__ float s_dsum[kB];

  const int hk = blockIdx.y, k0 = blockIdx.x * kB;
  const int G = H / Hk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  load_tile(s_k, k + (long long)hk * kD, k_rs, k0, T);
  load_tile(s_v, v + (long long)hk * kD, v_rs, k0, T);
  load_ids(s_kid, doc, fn, nz, k0, T);
  __syncthreads();
  const int ra = warp * 16 + g, rb = ra + 8;  // this thread's key rows of the tile
  const int key_a = k0 + ra, key_b = k0 + rb;
  const int da = s_kid[0][ra], fa = s_kid[1][ra], na = s_kid[2][ra];
  const int db = s_kid[0][rb], fb = s_kid[1][rb], nb = s_kid[2][rb];

  float acc_k[kDTiles][4], acc_v[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    acc_k[dt][0] = acc_k[dt][1] = acc_k[dt][2] = acc_k[dt][3] = 0.f;
    acc_v[dt][0] = acc_v[dt][1] = acc_v[dt][2] = acc_v[dt][3] = 0.f;
  }

  for (int q0 = 0; q0 < T; q0 += kB) {
    load_ids(s_qid, doc, fn, nz, q0, T);
    __syncthreads();
    const int state = tile_state(s_qid, s_kid, q0, k0, T);
    if (state == kDead) continue;  // for every head of the group
    const bool full = state == kFull;
    for (int gh = 0; gh < G; ++gh) {
      const int h = hk * G + gh;
      load_tile(s_q, q + (long long)h * kD, q_rs, q0, T);
      load_tile(s_do, dout + (long long)h * kD, do_rs, q0, T);
      if (threadIdx.x < kB) {
        const int r = q0 + threadIdx.x;
        s_lse[threadIdx.x] = r < T ? lse[(long long)h * T + r] : 0.f;
        s_dsum[threadIdx.x] = r < T ? dsum[(long long)h * T + r] : 0.f;
      }
      __syncthreads();

      // the 64 query rows in two halves of 32: S^T and dP^T tiles of 16 keys x 32 queries
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float st[4][4], dpt[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
          st[n][0] = st[n][1] = st[n][2] = st[n][3] = dpt[n][0] = dpt[n][1] = dpt[n][2] =
              dpt[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kKSteps; ++kk) {
          uint32_t ka[4], va[4];
          load_a(ka, s_k, warp * 16, kk * 16, lane);
          load_a(va, s_v, warp * 16, kk * 16, lane);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t bq[4], bd[4];
            load_b_rows(bq, s_q, hh * 32 + np * 16, kk * 16, lane);
            load_b_rows(bd, s_do, hh * 32 + np * 16, kk * 16, lane);
            mma_16816(st[2 * np], ka, bq[0], bq[1]);
            mma_16816(st[2 * np + 1], ka, bq[2], bq[3]);
            mma_16816(dpt[2 * np], va, bd[0], bd[1]);
            mma_16816(dpt[2 * np + 1], va, bd[2], bd[3]);
          }
        }
        // p^T and ds^T, in place: st <- p^T, dpt <- ds^T
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = (hh * 4 + n) * 8 + 2 * t + (e & 1);  // query row of the tile
            bool ok = true;
            if (!full) {
              const int i = q0 + c;
              const int di = s_qid[0][c], fi = s_qid[1][c], ni = s_qid[2][c];
              ok = i < T && (e < 2 ? (key_a < T && allowed(i, key_a, di, da, fi, fa, ni, na))
                                   : (key_b < T && allowed(i, key_b, di, db, fi, fb, ni, nb)));
            }
            const float p = ok ? __expf(st[n][e] * scale - s_lse[c]) : 0.f;
            st[n][e] = p;
            dpt[n][e] = p * (dpt[n][e] - s_dsum[c]);
          }
        }
        // dV += P^T dO and dK += dS^T Q
#pragma unroll
        for (int k2 = 0; k2 < 2; ++k2) {
          const int kk = hh * 2 + k2;
          uint32_t pa[4], sa[4];
          pa[0] = pack_bf16x2(st[2 * k2][0], st[2 * k2][1]);
          pa[1] = pack_bf16x2(st[2 * k2][2], st[2 * k2][3]);
          pa[2] = pack_bf16x2(st[2 * k2 + 1][0], st[2 * k2 + 1][1]);
          pa[3] = pack_bf16x2(st[2 * k2 + 1][2], st[2 * k2 + 1][3]);
          sa[0] = pack_bf16x2(dpt[2 * k2][0], dpt[2 * k2][1]);
          sa[1] = pack_bf16x2(dpt[2 * k2][2], dpt[2 * k2][3]);
          sa[2] = pack_bf16x2(dpt[2 * k2 + 1][0], dpt[2 * k2 + 1][1]);
          sa[3] = pack_bf16x2(dpt[2 * k2 + 1][2], dpt[2 * k2 + 1][3]);
#pragma unroll
          for (int dd = 0; dd < kDTiles / 2; ++dd) {
            uint32_t bd[4], bq[4];
            load_b_cols(bd, s_do, kk * 16, dd * 16, lane);
            load_b_cols(bq, s_q, kk * 16, dd * 16, lane);
            mma_16816(acc_v[2 * dd], pa, bd[0], bd[1]);
            mma_16816(acc_v[2 * dd + 1], pa, bd[2], bd[3]);
            mma_16816(acc_k[2 * dd], sa, bq[0], bq[1]);
            mma_16816(acc_k[2 * dd + 1], sa, bq[2], bq[3]);
          }
        }
      }
      __syncthreads();  // the next head or tile overwrites s_q, s_do, s_lse, s_dsum, s_qid
    }
  }

  if (key_a < T) {
    const long long off = ((long long)key_a * Hk + hk) * kD + 2 * t;
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      *reinterpret_cast<uint32_t*>(dk + off + dt * 8) =
          pack_bf16x2(acc_k[dt][0] * scale, acc_k[dt][1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + dt * 8) = pack_bf16x2(acc_v[dt][0], acc_v[dt][1]);
    }
  }
  if (key_b < T) {
    const long long off = ((long long)key_b * Hk + hk) * kD + 2 * t;
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      *reinterpret_cast<uint32_t*>(dk + off + dt * 8) =
          pack_bf16x2(acc_k[dt][2] * scale, acc_k[dt][3] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + dt * 8) = pack_bf16x2(acc_v[dt][2], acc_v[dt][3]);
    }
  }
}

bool bad_shape(int T, int H, int Hk, int D) {
  return T <= 0 || Hk <= 0 || H <= 0 || H % Hk != 0 || H > 65535 || D != kD;
}

const __nv_bfloat16* bf(const void* p) { return static_cast<const __nv_bfloat16*>(p); }
const int* i32(const void* p) { return static_cast<const int*>(p); }

}  // namespace

// Every tensor [T, heads, D] with D contiguous, a head stride of D and the given row stride in
// elements; out, dq [T, H, D] and dk, dv [T, Hk, D] contiguous; lse, dsum fp32 [H, T];
// doc, fn, nz int32 [T]. Each returns a cudaError_t.
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

extern "C" int unimedvl_packed_train_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* dsum, void* dq, const void* doc, const void* fn, const void* nz, int T, int H,
    int Hk, int D, long long q_rs, long long k_rs, long long v_rs, long long do_rs, float scale,
    void* stream) {
  if (bad_shape(T, H, Hk, D)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((T + kB - 1) / kB, H);
  packed_train_bwd_dq_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      bf(q), bf(k), bf(v), bf(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dsum), static_cast<__nv_bfloat16*>(dq), i32(doc), i32(fn), i32(nz),
      T, H, Hk, q_rs, k_rs, v_rs, do_rs, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int unimedvl_packed_train_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* dsum, void* dk, void* dv, const void* doc, const void* fn, const void* nz, int T,
    int H, int Hk, int D, long long q_rs, long long k_rs, long long v_rs, long long do_rs,
    float scale, void* stream) {
  if (bad_shape(T, H, Hk, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(packed_train_bwd_dkv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kB - 1) / kB, Hk);
  packed_train_bwd_dkv_kernel<<<grid, kThreads, kDkvSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      bf(q), bf(k), bf(v), bf(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dsum), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), i32(doc), i32(fn), i32(nz), T, H, Hk, q_rs, k_rs, v_rs,
      do_rs, scale);
  return static_cast<int>(cudaGetLastError());
}
