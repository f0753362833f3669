// Device code shared by the flash attention kernels of the inference paths, bf16, for sm_90a:
// flash_block_attention.cu (K1a, K1b, K1c) and flash_cache_block_attention.cu (K6).
//
// One CTA of 4 warps owns 64 query rows of one head; each warp owns 16 rows and keeps its Q
// fragments, S tile and O accumulator in registers. Q K^T and P V run on the tensor cores through
// mma.sync m16n8k16 (bf16 in, fp32 accumulate); K and V tiles of 64 keys are staged in shared
// memory with 16-byte loads. `sweep_keys` is one online-softmax pass over a key array under the
// cache-plus-block visibility rule; a kernel calls it once (K1) or once per key array (K6) on
// the same running state. `preprocess_tile` is the MoT qk-norm + RoPE island on a 64-row tile in
// shared memory, used for the raw Q tile (K1b, K1c, K6) and for raw block-K tiles (K6).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float kNegInf = -3.402823466e38f;  // finfo(float32).min, the TPU kernel's mask value
constexpr int kBM = 64;                       // query rows per CTA (4 warps x 16)
constexpr int kBN = 64;                       // keys per step of the sweep
constexpr int kThreads = 128;

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values as one bf16x2 register; `lo` takes the lower column index.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_u16(const __nv_bfloat16* lo, const __nv_bfloat16* hi) {
  const uint32_t a = *reinterpret_cast<const uint16_t*>(lo);
  const uint32_t b = *reinterpret_cast<const uint16_t*>(hi);
  return a | (b << 16);
}

// Rows [r0, r0 + 64) of a bf16 matrix with D contiguous columns and a row stride of `stride`
// elements -> shared tile [64][DP]. Rows at or past n_rows and columns [D, DK) become zero.
template <int D, int DK, int DP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile, const __nv_bfloat16* src,
                                          long long stride, int r0, int n_rows) {
  constexpr int kVecs = D / 8;
  for (int idx = threadIdx.x; idx < kBM * kVecs; idx += kThreads) {
    const int r = idx / kVecs, c = idx - r * kVecs;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n_rows)
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * stride + c * 8);
    *reinterpret_cast<uint4*>(tile + r * DP + c * 8) = val;
  }
  if constexpr (DK > D) {
    for (int idx = threadIdx.x; idx < kBM * ((DK - D) / 8); idx += kThreads) {
      const int r = idx / ((DK - D) / 8), c = D + (idx - r * ((DK - D) / 8)) * 8;
      *reinterpret_cast<uint4*>(tile + r * DP + c) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Operands of the MoT qk-norm + RoPE island. Table row r of stream s is at
// cos + s * tab_ss + r * tab_rs (tab_rs = 0 for one row shared by the whole block).
struct Preproc {
  const float* w_und;  // [128] norm weights of the text rows
  const float* w_gen;  // [128] norm weights of every other row
  const float* cos;
  const float* sin;
  long long tab_ss, tab_rs;
  const int* end_row;  // [S] the <vision_end> row
  float eps;
};

// A raw 64-row tile in shared memory (rows r0 .. r0 + 63 of a block of n_rows) -> its gen-mode
// form (MoT RMSNorm + RoPE in fp32, rounded to bf16), in place: qn = x * rsqrt(mean(x^2) + eps),
// times w_und on the text rows (row == 0 or row == end_row[s]) and w_gen elsewhere, then RoPE
// with rotate_half. Warp w owns rows [16w, 16w + 16); lane l owns columns 2l, 2l + 1, 2l + 64,
// 2l + 65, so the rotation needs no exchange between threads and the row's sum of squares one
// warp reduction. D = 128.
template <int DP>
__device__ __forceinline__ void preprocess_tile(__nv_bfloat16* tile, const Preproc& pre, int s,
                                                int r0, int n_rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = 2 * lane;
  const int er = pre.end_row[s];
  const float2 wu_lo = *reinterpret_cast<const float2*>(pre.w_und + c);
  const float2 wu_hi = *reinterpret_cast<const float2*>(pre.w_und + c + 64);
  const float2 wg_lo = *reinterpret_cast<const float2*>(pre.w_gen + c);
  const float2 wg_hi = *reinterpret_cast<const float2*>(pre.w_gen + c + 64);
  for (int rr = 0; rr < 16; ++rr) {
    const int r = warp * 16 + rr, row = r0 + r;
    if (row >= n_rows) break;  // warp-uniform; rows past the block stay zero
    __nv_bfloat162* p_lo = reinterpret_cast<__nv_bfloat162*>(tile + r * DP + c);
    __nv_bfloat162* p_hi = reinterpret_cast<__nv_bfloat162*>(tile + r * DP + c + 64);
    const float2 lo = __bfloat1622float2(*p_lo), hi = __bfloat1622float2(*p_hi);
    float ss = lo.x * lo.x + lo.y * lo.y + hi.x * hi.x + hi.y * hi.y;
#pragma unroll
    for (int w = 16; w >= 1; w >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, w);
    const float inv = rsqrtf(ss * (1.f / 128.f) + pre.eps);
    const bool text = row == 0 || row == er;
    const float2 w_lo = text ? wu_lo : wg_lo, w_hi = text ? wu_hi : wg_hi;
    const float a0 = __fmul_rn(lo.x * inv, w_lo.x), a1 = __fmul_rn(lo.y * inv, w_lo.y);
    const float b0 = __fmul_rn(hi.x * inv, w_hi.x), b1 = __fmul_rn(hi.y * inv, w_hi.y);
    const long long off = s * pre.tab_ss + row * pre.tab_rs;
    const float2 cs_lo = *reinterpret_cast<const float2*>(pre.cos + off + c);
    const float2 cs_hi = *reinterpret_cast<const float2*>(pre.cos + off + c + 64);
    const float2 sn_lo = *reinterpret_cast<const float2*>(pre.sin + off + c);
    const float2 sn_hi = *reinterpret_cast<const float2*>(pre.sin + off + c + 64);
    // rotate_half(x)[c] = -x[c + 64] for c < 64, x[c - 64] above; each product and the sum
    // rounded on its own (no fma), as the plain version's separate element-wise ops round them
    *p_lo = __floats2bfloat162_rn(__fadd_rn(__fmul_rn(a0, cs_lo.x), __fmul_rn(-b0, sn_lo.x)),
                                  __fadd_rn(__fmul_rn(a1, cs_lo.y), __fmul_rn(-b1, sn_lo.y)));
    *p_hi = __floats2bfloat162_rn(__fadd_rn(__fmul_rn(b0, cs_hi.x), __fmul_rn(a0, sn_hi.x)),
                                  __fadd_rn(__fmul_rn(b1, cs_hi.y), __fmul_rn(a1, sn_hi.y)));
  }
}

// The running online-softmax state of the two query rows (g and g + 8 of the warp's 16) a thread
// holds: the O accumulator fragments, the row maxima (uniform over the 4 threads of a row) and
// the row sums of this thread's columns only.
template <int D>
struct RowState {
  float o[D / 8][4];
  float m_a, m_b, l_a, l_b;
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
    m_a = m_b = kNegInf;
    l_a = l_b = 0.f;
  }
};

// The Q tile in shared memory -> this warp's A fragments (rows g and g + 8 of its 16).
template <int DK, int DP>
__device__ __forceinline__ void load_q_fragments(uint32_t (&qf)[DK / 16][4],
                                                 const __nv_bfloat16* s_q) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* ra = s_q + (warp * 16 + g) * DP + 2 * t;
  const __nv_bfloat16* rb = ra + 8 * DP;
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) {
    qf[kk][0] = ld_u32(ra + kk * 16);
    qf[kk][1] = ld_u32(rb + kk * 16);
    qf[kk][2] = ld_u32(ra + kk * 16 + 8);
    qf[kk][3] = ld_u32(rb + kk * 16 + 8);
  }
}

// One pass over keys [0, kv_hi) of a key array of n_keys rows (K rows at k_base + j * k_sm, V
// alike), updating `st`. Key j is visible to query row i iff j < ln, or with off = j - bs:
// 0 <= off < qv and (not causal or off <= i). A masked key weighs 0: its logit is kNegInf, which
// no visible logit reaches, and p is selected to 0 for it, so a row that has seen no visible key
// keeps l == 0 whatever it swept. With kKPre each raw K tile goes through `preprocess_tile`
// (rows counted in this key array) before the product. All threads of the CTA call it together.
template <int D, int DK, int DP, bool kKPre>
__device__ __forceinline__ void sweep_keys(RowState<D>& st, const uint32_t (&qf)[DK / 16][4],
                                           __nv_bfloat16* s_k, __nv_bfloat16* s_v,
                                           const __nv_bfloat16* k_base, long long k_sm,
                                           const __nv_bfloat16* v_base, long long v_sm, int n_keys,
                                           int kv_hi, int ln, int bs, int qv, int causal,
                                           float scale, int row_a, int row_b, const Preproc& kpre,
                                           int s) {
  constexpr int kKSteps = DK / 16;
  constexpr int kDTiles = D / 8;
  constexpr int kNTiles = kBN / 8;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group and thread-in-group

  for (int n0 = 0; n0 < kv_hi; n0 += kBN) {
    load_tile<D, DK, DP>(s_k, k_base, k_sm, n0, n_keys);
    load_tile<D, D, DP>(s_v, v_base, v_sm, n0, n_keys);
    __syncthreads();
    if constexpr (kKPre) {
      preprocess_tile<DP>(s_k, kpre, s, n0, n_keys);
      __syncthreads();
    }

    // S = Q K^T for this warp's 16 rows x 64 keys.
    float sc[kNTiles][4];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
      const __nv_bfloat16* kr = s_k + (nt * 8 + g) * DP + 2 * t;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
        mma_16816(sc[nt], qf[kk], ld_u32(kr + kk * 16), ld_u32(kr + kk * 16 + 8));
    }

    // Mask, scale, and the running row maxima.
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = n0 + nt * 8 + 2 * t + (e & 1);
        const int i = e < 2 ? row_a : row_b;
        const int off = j - bs;
        const bool ok = j < n_keys && (j < ln || (off >= 0 && off < qv && (!causal || off <= i)));
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
    const float mn_a = fmaxf(st.m_a, mx_a), mn_b = fmaxf(st.m_b, mx_b);
    const float al_a = __expf(st.m_a - mn_a), al_b = __expf(st.m_b - mn_b);
    st.m_a = mn_a;
    st.m_b = mn_b;

    // P = exp(S - m); a masked key (logit == kNegInf, which no visible logit reaches) weighs 0.
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
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
    st.l_a = st.l_a * al_a + sum_a;
    st.l_b = st.l_b * al_b + sum_b;
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      st.o[dt][0] *= al_a;
      st.o[dt][1] *= al_a;
      st.o[dt][2] *= al_b;
      st.o[dt][3] *= al_b;
    }

    // O += P V: the S accumulators of two adjacent key n-tiles form one A fragment.
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(sc[2 * kk][0], sc[2 * kk][1]);
      pa[1] = pack_bf16x2(sc[2 * kk][2], sc[2 * kk][3]);
      pa[2] = pack_bf16x2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[3] = pack_bf16x2(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
      const __nv_bfloat16* vr = s_v + (kk * 16 + 2 * t) * DP + g;
#pragma unroll
      for (int dt = 0; dt < kDTiles; ++dt) {
        const uint32_t b0 = pack_u16(vr + dt * 8, vr + DP + dt * 8);
        const uint32_t b1 = pack_u16(vr + 8 * DP + dt * 8, vr + 9 * DP + dt * 8);
        mma_16816(st.o[dt], pa, b0, b1);
      }
    }
    __syncthreads();  // the next step overwrites s_k and s_v
  }
}

// out[s, row, h] = o / max(l, 1e-30) for the rows below T (trailing tile rows are not stored),
// and, when `lse` is given, lse[s, row, h] = m + log(l), the natural-log sum-exp of the scaled
// logits, or kNegInf (finite) for a row that saw no key, whose output is 0.
template <int D>
__device__ __forceinline__ void store_rows(RowState<D>& st, __nv_bfloat16* out, float* lse, int s,
                                           int T, int H, int h, int row_a, int row_b) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int w = 1; w <= 2; w <<= 1) {
    st.l_a += __shfl_xor_sync(0xffffffffu, st.l_a, w);
    st.l_b += __shfl_xor_sync(0xffffffffu, st.l_b, w);
  }
  const float inv_a = 1.f / fmaxf(st.l_a, 1e-30f), inv_b = 1.f / fmaxf(st.l_b, 1e-30f);
  if (row_a < T) {
    __nv_bfloat16* dst = out + (((long long)s * T + row_a) * H + h) * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(dst + dt * 8) =
          pack_bf16x2(st.o[dt][0] * inv_a, st.o[dt][1] * inv_a);
    if (lse != nullptr && t == 0)
      lse[((long long)s * T + row_a) * H + h] = st.l_a > 0.f ? st.m_a + logf(st.l_a) : kNegInf;
  }
  if (row_b < T) {
    __nv_bfloat16* dst = out + (((long long)s * T + row_b) * H + h) * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(dst + dt * 8) =
          pack_bf16x2(st.o[dt][2] * inv_b, st.o[dt][3] * inv_b);
    if (lse != nullptr && t == 0)
      lse[((long long)s * T + row_b) * H + h] = st.l_b > 0.f ? st.m_b + logf(st.l_b) : kNegInf;
  }
}

}  // namespace flash
