// K2 and K2-int8: single-token GQA decode attention over the head-major KV cache, bf16 or int8
// with per-key fp32 scales, for sm_90a. One kernel template, instantiated for each cache type,
// and one combine kernel.
//
// Replaces the Pallas TPU kernel unimedvl_tpu/ops/decode_attention.py::decode_attention
// (kernel body `_kernel`), whose `quantized` flag is the template's int8 instance.
//
// What it computes, for stream s and query head h (KV head hk = h / G, G = H / Hk):
//   out[s, 0, h] = sum_j softmax_j(q[s, 0, h] . k[s, hk, j] / sqrt(D)) v[s, hk, j]
// over the keys j < M that are visible: j < lens[s], or base[s] <= j <= col[s]. The band
// (base, col) is the aligned-column decode band of generate_text; serving passes (lens, lens).
// Softmax in fp32; out = acc / max(l, 1e-30), so a stream that sees no key gives 0.
// With an int8 cache and scales k_scale, v_scale [S, Hk, M], the cache is never dequantized:
//   logit[j] = (q . k_int8[j]) * k_scale[j] / sqrt(D),   out = sum_j (p[j] * v_scale[j]) v_int8[j] / l
// where l sums the unscaled p.
//
// What bounds it on the H100: each (stream, KV head) reads its 2 * kv * D cache elements once
// (2 bytes each in bf16, 1 in int8, plus 8 bytes of scales per key) and does about 4 * G * D
// flops per key: 7 flops per byte at G = 7, far below the card's ~295, so HBM bandwidth
// bounds it. At chat's S = 1 the whole call moves 10 MB: one CTA per (stream, KV head), as
// the TPU kernel's grid has it, would put 4 CTAs on 132 SMs and leave most of the bandwidth
// unused.
//
// What the design does about it (flash-decoding):
// - The key axis is split over CTAs: the grid is (n_split, Hk, S) and split i covers keys
//   [i * L, (i + 1) * L). The wrapper plans (n_split, L) from S, Hk and M alone, for about two
//   CTAs per SM (ops/decode_attention.py::plan_splits): reading lens from the device would
//   synchronise the host on every call. Each CTA reads lens/base/col itself and returns at once,
//   without a load, when its keys lie past max(lens, col + 1) or wholly inside the dead gap
//   [lens, base) that generate_text's aligned band leaves for streams shorter than the longest.
// - Tiles of 64 keys x 128 dims of K and V go into shared memory with cp.async (16 bytes a
//   thread) in a ring of three stages, so that the next tiles load while this one is scored.
//   Keys that are not visible are zero-filled by the copy (src-size 0): they cost no HBM read,
//   and NaN or garbage in masked cache rows never reaches a product. cp.async and not TMA: k and
//   v are per-layer views of the stacked cache with strides, and a TMA descriptor would have to
//   be encoded on the host for every call of a host-bound decode loop.
// - Scoring on the tensor cores with mma.sync m16n8k16: the G <= 8 query heads of a KV group
//   are the 8 rows of a 16-row A operand (the other 8 zero), logits = Q . K^T with K^T as B; the
//   logits' accumulator layout is exactly the B operand of out^T[D, heads] += V^T[D, keys] .
//   P^T[keys, heads], so P never leaves registers. wgmma would buy nothing at 7 flops per byte.
//   Each warp scores 16 keys of a tile and keeps its own online-softmax state; the four warps
//   merge in shared memory at the end. Q's dims are read in the order in which each thread's
//   16-byte K loads deliver them, so every K fragment is one shared-memory load and the int8
//   cache widens to bf16 in registers (integers within +-127 are exact in bf16).
// - Masked keys weigh 0 by selection (p = visible ? exp(x - m) : 0; int8 weight = visible ?
//   p * v_scale : 0), never by multiplication, since 0 * NaN is NaN.
// - A second launch combines the splits' fp32 partials (m, l, acc) [S, Hk, n_split, 8, D]:
//   out = sum_i e^(m_i - m*) acc_i / max(sum_i e^(m_i - m*) l_i, 1e-30) over the splits with
//   l_i > 0 (a split that saw no key weighs exactly 0 and its acc is never read). With one split
//   the first kernel writes the output itself. A second launch and not a last-CTA-combines
//   counter: the counter needs a zeroed array per call (another launch or a memset) and a fence
//   per CTA, and a call's device time (~10 us at chat's shape, a third of it the combine) is
//   already below its wrapper's host time, so the launch saved would not show.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -3.402823466e38f;  // finfo(float32).min, the TPU kernel's mask value
constexpr int kD = 128;                       // head dim
constexpr int kThreads = 128;                 // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                     // keys per tile: 16 per warp
constexpr int kStages = 3;                    // tiles in the cp.async ring
constexpr int kMaxGroup = 8;                  // query heads per KV head (G = 7 on the 14B model)
static_assert(kThreads == kD, "the merge gives thread d dim d");

// Shared memory of one stage: the K tile, the V tile, then (int8) the tile's k and v scales.
template <typename KV>
struct Tile {
  static constexpr int kRowBytes = kD * int(sizeof(KV));
  static constexpr int kChunks = kRowBytes / 16;  // 16-byte chunks per key row
  static constexpr int kKVBytes = kTile * kRowBytes;
  static constexpr int kScaleBytes = sizeof(KV) == 1 ? 2 * kTile * 4 : 0;
  static constexpr int kStageBytes = 2 * kKVBytes + kScaleBytes;
  static constexpr int kSmemBytes = kStages * kStageBytes;
};
static_assert(kWarps * kMaxGroup * kD * 4 <= Tile<int8_t>::kSmemBytes, "merge fits the ring");

// Chunk c of tile row r lives at chunk c ^ swizzle(r), so that the fragment loads below hit
// distinct banks: rows 256 (bf16) or 128 (int8) bytes apart share banks, the XOR spreads them.
template <typename KV, bool kIsV>
__device__ __forceinline__ int swizzle(int r) {
  if constexpr (sizeof(KV) == 2 && kIsV) return ((r >> 1) & 1) | (r & 4);
  return r & 7;
}

// The first of the four dims that the k-slots (2t, 2t + 1, 2t + 8, 2t + 9) of k-step ks stand
// for in thread t (lane % 4) of a warp. Any assignment that gives each dim one slot leaves q . k
// unchanged; this one is the order in which thread t's K loads deliver the dims [32t, 32t + 32)
// (bf16: four chunks, taken in a rotated order that keeps the loads free of bank conflicts).
template <typename KV>
__device__ __forceinline__ int qk_dim(int ks, int t) {
  if constexpr (sizeof(KV) == 2) return 32 * t + 8 * (((ks >> 1) + t) & 3) + 4 * (ks & 1);
  return 32 * t + 4 * ks;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, asynchronously; zero-filled when !pred (nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// c += A (16x16 bf16, row-major) . B (16x8 bf16, column-major), fp32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// Byte i of a word of int8 values as fp32: with the byte XORed with 0x80 it becomes the low
// mantissa bits of 2^23, and subtracting 2^23 + 128 leaves the signed value, exactly.
__device__ __forceinline__ float s8_to_float(uint32_t word, int i) {
  return __uint_as_float(__byte_perm(word ^ 0x80808080u, 0x4B000000u, 0x7650 + i)) - 8388736.0f;
}

// bf16x2 of (byte i of lo_word, byte j of hi_word), both int8: exact.
__device__ __forceinline__ uint32_t s8_pair(uint32_t lo_word, int i, uint32_t hi_word, int j) {
  return pack_bf16(s8_to_float(lo_word, i), s8_to_float(hi_word, j));
}

__device__ __forceinline__ bool visible(int j, int hi, int ln, int base, int col) {
  return j < hi && (j < ln || (j >= base && j <= col));
}

// One CTA: keys [lo, hi) of split blockIdx.x for KV head blockIdx.y of stream blockIdx.z.
// partials (n_split > 1): fp32 acc [S, Hk, n_split, 8, D], then m and l [S, Hk, n_split, 8].
template <typename KV>
__global__ void __launch_bounds__(kThreads)
    decode_attention_split_kernel(const __nv_bfloat16* __restrict__ q, const KV* __restrict__ k,
                                  const KV* __restrict__ v, const float* __restrict__ k_scale,
                                  const float* __restrict__ v_scale,
                                  __nv_bfloat16* __restrict__ out, float* __restrict__ partials,
                                  const int* __restrict__ lens, const int* __restrict__ band_base,
                                  const int* __restrict__ band_col, int index_bcast, int H,
                                  int Hk, int M, int split_len, long long k_ss, long long k_sh, long long k_sm,
                                  long long v_ss, long long v_sh, long long v_sm, float scale) {
  using T = Tile<KV>;
  constexpr bool kInt8 = sizeof(KV) == 1;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float s_m[kWarps][kMaxGroup], s_l[kWarps][kMaxGroup];

  const int split = blockIdx.x, hk = blockIdx.y, s = blockIdx.z;
  const int n_split = gridDim.x, S = gridDim.z;
  const int G = H / Hk;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row (head / d-group) and k-slot quad

  // index_bcast bit 0 / 1 / 2: lens / base / col is one value for every stream
  const int ln = lens[index_bcast & 1 ? 0 : s];
  const int base = band_base[index_bcast & 2 ? 0 : s], col = band_col[index_bcast & 4 ? 0 : s];
  const int kv_hi = min(max(ln, col + 1), M);
  const int lo = split * split_len, hi = min(lo + split_len, kv_hi);
  const long long part_row = ((long long)s * Hk + hk) * n_split + split;  // of [S, Hk, n_split]
  const long long n_rows = (long long)S * Hk * n_split;

  if (lo >= hi || (lo >= ln && hi <= base)) {  // no visible key: no load
    if (n_split == 1) {
      for (int idx = tid; idx < G * kD; idx += kThreads)
        out[((long long)s * H + (long long)hk * G) * kD + idx] = __float2bfloat16(0.f);
    } else if (tid < G) {
      partials[n_rows * kMaxGroup * kD + part_row * kMaxGroup + tid] = kNegInf;
      partials[n_rows * kMaxGroup * (kD + 1) + part_row * kMaxGroup + tid] = 0.f;
    }
    return;
  }

  const KV* k_base = k + s * k_ss + hk * k_sh;
  const KV* v_base = v + s * v_ss + hk * v_sh;
  const long long scale_row = ((long long)s * Hk + hk) * M;  // scales are contiguous [S, Hk, M]

  // Q as the A operand, for all eight k-steps: row g = head g of the group (rows 8-15 zero).
  uint32_t qa[kD / 16][2];
  {
    const __nv_bfloat16* qh = q + ((long long)s * H + (long long)hk * G + g) * kD;
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks) {
      const int d0 = qk_dim<KV>(ks, t);
      qa[ks][0] = g < G ? *reinterpret_cast<const uint32_t*>(qh + d0) : 0u;
      qa[ks][1] = g < G ? *reinterpret_cast<const uint32_t*>(qh + d0 + 2) : 0u;
    }
  }

  const int n_tiles = (hi - lo + kTile - 1) / kTile;
  auto load_tile = [&](int it) {
    uint8_t* st = smem + (it % kStages) * T::kStageBytes;
    const int c0 = lo + it * kTile;
#pragma unroll
    for (int e = 0; e < kTile * T::kChunks / kThreads; ++e) {
      const int id = tid + e * kThreads, r = id / T::kChunks, c = id % T::kChunks;
      const bool ok = visible(c0 + r, hi, ln, base, col);
      const long long key = ok ? c0 + r : 0;
      cp_async16(st + r * T::kRowBytes + ((c ^ swizzle<KV, false>(r)) << 4),
                 k_base + key * k_sm + c * (16 / int(sizeof(KV))), ok);
      cp_async16(st + T::kKVBytes + r * T::kRowBytes + ((c ^ swizzle<KV, true>(r)) << 4),
                 v_base + key * v_sm + c * (16 / int(sizeof(KV))), ok);
    }
    if constexpr (kInt8) {
      const int r = tid & (kTile - 1);
      const bool ok = visible(c0 + r, hi, ln, base, col);
      const float* src = (tid < kTile ? k_scale : v_scale) + scale_row + (ok ? c0 + r : 0);
      cp_async4(st + 2 * T::kKVBytes + tid * 4, src, ok);
    }
  };

  float acc[kD / 16][4];  // out^T tile i: rows d(i, g) and d(i, g + 8), cols heads 2t, 2t + 1
#pragma unroll
  for (int i = 0; i < kD / 16; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_run = kNegInf, l_run = 0.f;  // head g's running max and sum over this warp's keys

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) load_tile(st);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    if (it + kStages - 1 < n_tiles) load_tile(it + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();

    const uint8_t* sk = smem + (it % kStages) * T::kStageBytes;
    const uint8_t* sv = sk + T::kKVBytes;
    const float* sks = reinterpret_cast<const float*>(sk + 2 * T::kKVBytes);
    const int r0 = 16 * warp;               // this warp's keys in the tile
    const int j0 = lo + it * kTile + r0;    // their index in the cache

    // Logits of head g for keys r0 + 8b + 2t + {0, 1}: Q . K^T with K^T as B (n = key g).
    float x[2][2];
    bool vis[2][2];
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      const int r = r0 + 8 * b + g;
      const uint8_t* row = sk + r * T::kRowBytes;
      if constexpr (kInt8) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint4 w4 = *reinterpret_cast<const uint4*>(
              row + (((2 * t + h) ^ swizzle<KV, false>(r)) << 4));
          const uint32_t w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int wi = 0; wi < 4; ++wi)
            mma_bf16(c, qa[4 * h + wi][0], 0u, qa[4 * h + wi][1], 0u, s8_pair(w[wi], 0, w[wi], 1),
                     s8_pair(w[wi], 2, w[wi], 3));
        }
      } else {
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int chunk = 4 * t + ((cc + t) & 3);
          const uint4 w4 = *reinterpret_cast<const uint4*>(
              row + ((chunk ^ swizzle<KV, false>(r)) << 4));
          mma_bf16(c, qa[2 * cc][0], 0u, qa[2 * cc][1], 0u, w4.x, w4.y);
          mma_bf16(c, qa[2 * cc + 1][0], 0u, qa[2 * cc + 1][1], 0u, w4.z, w4.w);
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int rk = r0 + 8 * b + 2 * t + e;
        vis[b][e] = visible(lo + it * kTile + rk, hi, ln, base, col);
        float logit = c[e] * scale;
        if constexpr (kInt8) logit *= sks[rk];
        x[b][e] = vis[b][e] ? logit : kNegInf;
      }
    }

    // Online softmax of head g over the warp's 16 keys: the four lanes of the quad hold them.
    float mx = fmaxf(fmaxf(x[0][0], x[0][1]), fmaxf(x[1][0], x[1][1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = __expf(m_run - m_new);
    float p[2][2], psum = 0.f;
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[b][e] = vis[b][e] ? __expf(x[b][e] - m_new) : 0.f;  // masked keys weigh 0
        psum += p[b][e];
      }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l_run = l_run * alpha + psum;
    m_run = m_new;
    if constexpr (kInt8) {  // the P V weights carry v's scale; l above does not
      const float* svs = sks + kTile;
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float vsc = svs[r0 + 8 * b + 2 * t + e];
          p[b][e] = vis[b][e] ? p[b][e] * vsc : 0.f;
        }
    }
    // P^T as the B operand (k = key 2t + {0, 1} and 2t + 8 + {0, 1}, n = head g)
    const uint32_t pb0 = pack_bf16(p[0][0], p[0][1]), pb1 = pack_bf16(p[1][0], p[1][1]);

    // Rescale: acc's columns are heads 2t and 2t + 1, whose alphas lanes 8t and 8t + 4 hold.
    const float a_lo = __shfl_sync(0xffffffffu, alpha, 8 * t);
    const float a_hi = __shfl_sync(0xffffffffu, alpha, 8 * t + 4);
#pragma unroll
    for (int i = 0; i < kD / 16; ++i) {
      acc[i][0] *= a_lo;
      acc[i][1] *= a_hi;
      acc[i][2] *= a_lo;
      acc[i][3] *= a_hi;
    }

    // out^T += V^T . P^T. Row g of m-tile i is dim 16g + 2i, row g + 8 dim 16g + 2i + 1: thread
    // (g, t) reads dims [16g, 16g + 16) of keys 2t, 2t + 1, 2t + 8, 2t + 9.
    const int vr[4] = {r0 + 2 * t, r0 + 2 * t + 1, r0 + 2 * t + 8, r0 + 2 * t + 9};
    if constexpr (kInt8) {
      uint32_t w[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint4 w4 = *reinterpret_cast<const uint4*>(
            sv + vr[kk] * T::kRowBytes + ((g ^ swizzle<KV, true>(vr[kk])) << 4));
        w[kk][0] = w4.x, w[kk][1] = w4.y, w[kk][2] = w4.z, w[kk][3] = w4.w;
      }
#pragma unroll
      for (int i = 0; i < kD / 16; ++i) {
        const int wi = i >> 1, by = 2 * (i & 1);
        mma_bf16(acc[i], s8_pair(w[0][wi], by, w[1][wi], by),
                 s8_pair(w[0][wi], by + 1, w[1][wi], by + 1), s8_pair(w[2][wi], by, w[3][wi], by),
                 s8_pair(w[2][wi], by + 1, w[3][wi], by + 1), pb0, pb1);
      }
    } else {
      uint32_t w[4][8];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint4 w4 = *reinterpret_cast<const uint4*>(
              sv + vr[kk] * T::kRowBytes + (((2 * g + h) ^ swizzle<KV, true>(vr[kk])) << 4));
          w[kk][4 * h] = w4.x, w[kk][4 * h + 1] = w4.y, w[kk][4 * h + 2] = w4.z,
          w[kk][4 * h + 3] = w4.w;
        }
#pragma unroll
      for (int i = 0; i < kD / 16; ++i)
        mma_bf16(acc[i], __byte_perm(w[0][i], w[1][i], 0x5410),
                 __byte_perm(w[0][i], w[1][i], 0x7632), __byte_perm(w[2][i], w[3][i], 0x5410),
                 __byte_perm(w[2][i], w[3][i], 0x7632), pb0, pb1);
    }
    __syncthreads();  // the next iteration's load overwrites this stage
  }
  cp_async_wait<0>();

  // Merge the four warps' states: s_acc [warp][head][d] in the (now idle) ring.
  if (t == 0) {
    s_m[warp][g] = m_run;
    s_l[warp][g] = l_run;
  }
  __syncthreads();
  float* s_acc = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int h = 2 * t + hh;
    float m_cta = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_cta = fmaxf(m_cta, s_m[w][h]);
    const float f = __expf(s_m[warp][h] - m_cta);  // a warp that saw no key has acc 0
    float* dst = s_acc + (warp * kMaxGroup + h) * kD + 16 * g;
#pragma unroll
    for (int i = 0; i < kD / 16; ++i)
      *reinterpret_cast<float2*>(dst + 2 * i) = make_float2(acc[i][hh] * f, acc[i][2 + hh] * f);
  }
  __syncthreads();

  const int d = tid;  // kThreads == kD: thread d writes dim d of every head
  for (int h = 0; h < G; ++h) {
    float m_cta = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_cta = fmaxf(m_cta, s_m[w][h]);
    float a = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      a += s_acc[(w * kMaxGroup + h) * kD + d];
      l += s_l[w][h] * __expf(s_m[w][h] - m_cta);
    }
    if (n_split == 1) {
      out[((long long)s * H + (long long)hk * G + h) * kD + d] =
          __float2bfloat16(a / fmaxf(l, 1e-30f));
    } else {
      partials[(part_row * kMaxGroup + h) * kD + d] = a;
      if (d == 0) {
        partials[n_rows * kMaxGroup * kD + part_row * kMaxGroup + h] = m_cta;
        partials[n_rows * kMaxGroup * (kD + 1) + part_row * kMaxGroup + h] = l;
      }
    }
  }
}

// out[s, 0, h] from the n_split partials of (s, h / G): one CTA per (head, stream). The splits'
// weights e^(m_i - m*) are formed once, in parallel, into shared memory (n_split floats of
// dynamic shared memory); then warp w sums the splits w, w + 4, ... that saw a key, four dims a
// lane (16-byte loads), and warp 0 adds the four sums.
__global__ void __launch_bounds__(kThreads)
    decode_attention_combine_kernel(const float* __restrict__ partials,
                                    __nv_bfloat16* __restrict__ out, int Hk, int n_split) {
  extern __shared__ float s_f[];
  __shared__ float s_max[kWarps], s_sum[kWarps];
  __shared__ float4 s_acc[kWarps][32];
  const int h = blockIdx.x, s = blockIdx.y, H = gridDim.x, S = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = H / Hk, hk = h / G, gh = h % G;
  const long long n_rows = (long long)S * Hk * n_split;
  const long long row0 = ((long long)s * Hk + hk) * n_split;
  const float* pm = partials + n_rows * kMaxGroup * kD;
  const float* pl = partials + n_rows * kMaxGroup * (kD + 1);

  float mx = kNegInf;
  for (int i = tid; i < n_split; i += kThreads) {
    const long long r = (row0 + i) * kMaxGroup + gh;
    if (pl[r] > 0.f) mx = fmaxf(mx, pm[r]);
  }
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
  if (lane == 0) s_max[warp] = mx;
  __syncthreads();
  float m_all = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, s_max[w]);

  float lsum = 0.f;
  for (int i = tid; i < n_split; i += kThreads) {
    const long long r = (row0 + i) * kMaxGroup + gh;
    const float li = pl[r];
    const float f = li > 0.f ? __expf(pm[r] - m_all) : 0.f;  // a split that saw no key weighs 0
    s_f[i] = f;
    lsum += f * li;
  }
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) lsum += __shfl_xor_sync(0xffffffffu, lsum, w);
  if (lane == 0) s_sum[warp] = lsum;
  __syncthreads();

  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4* acc = reinterpret_cast<const float4*>(partials);
#pragma unroll 4
  for (int i = warp; i < n_split; i += kWarps) {
    const float f = s_f[i];
    if (f > 0.f) {  // else its acc is not read: a split that saw no key never wrote it
      const float4 x = acc[((row0 + i) * kMaxGroup + gh) * (kD / 4) + lane];
      a.x += f * x.x, a.y += f * x.y, a.z += f * x.z, a.w += f * x.w;
    }
  }
  s_acc[warp][lane] = a;
  __syncthreads();
  if (warp == 0) {
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) l += s_sum[w];
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float4 b = s_acc[w][lane];
      a.x += b.x, a.y += b.y, a.z += b.z, a.w += b.w;
    }
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out + ((long long)s * H + h) * kD);
    o[2 * lane] = __floats2bfloat162_rn(a.x * inv, a.y * inv);
    o[2 * lane + 1] = __floats2bfloat162_rn(a.z * inv, a.w * inv);
  }
}

template <typename KV>
int launch(const void* q, const void* k, const void* v, const void* k_scale, const void* v_scale,
           void* out, const void* lens, const void* band_base, const void* band_col,
           void* partials, int S, int H, int Hk, int D, int M, int n_split, int split_len,
           int index_bcast, long long k_ss, long long k_sh, long long k_sm, long long v_ss,
           long long v_sh, long long v_sm, float scale, void* stream) {
  // n_split <= 12288: the combine's weights fit 48 KB of shared memory
  if (S <= 0 || M <= 0 || Hk <= 0 || H % Hk != 0 || H / Hk > kMaxGroup || S > 65535 ||
      Hk > 65535 || D != kD || n_split <= 0 || n_split > 12288 || split_len <= 0 ||
      split_len % kTile != 0 || (long long)n_split * split_len < M ||
      (n_split > 1 && partials == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = decode_attention_split_kernel<KV>;
  // The ring needs more than 48 KB of shared memory: allow it once per device (a host call per
  // launch would add to a host-bound decode loop; setting it twice in a race is harmless).
  static bool smem_set[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= 64 || !smem_set[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Tile<KV>::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < 64) smem_set[device] = true;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<dim3(n_split, Hk, S), kThreads, Tile<KV>::kSmemBytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(partials),
      static_cast<const int*>(lens), static_cast<const int*>(band_base),
      static_cast<const int*>(band_col), index_bcast, H, Hk, M, split_len, k_ss, k_sh, k_sm, v_ss,
      v_sh, v_sm, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  decode_attention_combine_kernel<<<dim3(H, S), kThreads, n_split * sizeof(float), st>>>(
      static_cast<const float*>(partials), static_cast<__nv_bfloat16*>(out), Hk, n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: contiguous [S, 1, H, D] bf16; k, v: [S, Hk, M, D] with the given (stream, head, key)
// strides in elements (multiples of 16 bytes) and D contiguous; lens, band_base, band_col:
// int32 [S], or one int32 each where bit 0 / 1 / 2 of index_bcast is set; (n_split, split_len)
// from the wrapper's plan; partials: fp32 scratch of S * Hk * n_split * 8 * (D + 2) elements
// when n_split > 1 (else unused). Returns a cudaError_t.
extern "C" int unimedvl_decode_attention_bf16(const void* q, const void* k, const void* v,
                                              void* out, const void* lens, const void* band_base,
                                              const void* band_col, void* partials, int S, int H,
                                              int Hk, int D, int M, int n_split, int split_len,
                                              int index_bcast, long long k_ss, long long k_sh,
                                              long long k_sm,
                                              long long v_ss, long long v_sh, long long v_sm,
                                              float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, nullptr, nullptr, out, lens, band_base, band_col,
                               partials, S, H, Hk, D, M, n_split, split_len, index_bcast, k_ss,
                               k_sh, k_sm, v_ss, v_sh, v_sm, scale, stream);
}

// As above over an int8 cache: k, v int8; k_scale, v_scale contiguous fp32 [S, Hk, M].
extern "C" int unimedvl_decode_attention_int8(const void* q, const void* k, const void* v,
                                              const void* k_scale, const void* v_scale, void* out,
                                              const void* lens, const void* band_base,
                                              const void* band_col, void* partials, int S, int H,
                                              int Hk, int D, int M, int n_split, int split_len,
                                              int index_bcast, long long k_ss, long long k_sh,
                                              long long k_sm,
                                              long long v_ss, long long v_sh, long long v_sm,
                                              float scale, void* stream) {
  if (k_scale == nullptr || v_scale == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<int8_t>(q, k, v, k_scale, v_scale, out, lens, band_base, band_col, partials, S,
                        H, Hk, D, M, n_split, split_len, index_bcast, k_ss, k_sh, k_sm, v_ss, v_sh,
                        v_sm, scale, stream);
}
