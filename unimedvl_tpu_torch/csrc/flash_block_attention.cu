// K1a: flash attention of a query block over cache plus block, bf16, for sm_90a.
//
// Replaces the Pallas TPU kernel unimedvl_tpu/ops/flash_attention.py::flash_block_attention
// (kernel body `_kernel`), without its fused q pre-processing (K1b) and log-sum-exp output (K1c).
//
// What it computes, for stream s, query row i and query head h (KV head hk = h / (H / Hk)):
//   out[s, i, h] = sum_j softmax_j(q[s, i, h] . k[s, j, hk] / sqrt(D)) v[s, j, hk]
// over the keys j < M that are visible: j < lens[s], or
//   block_start[s] <= j < block_start[s] + q_valid_len[s]   (and, when causal, j - block_start[s] <= i).
// Softmax is online and in fp32; out = acc / max(l, 1e-30), as on the TPU. Rows that see no key
// come out as 0; rows past q_valid_len are garbage by contract and are not compared.
//
// What bounds it on the H100: at the main path's shapes (ViT T = 5120, D = 72; image prefill
// T = 5122 over M = 5632, D = 128) each (tile, head) does 4 * 64 * kv * D flops from 2 * kv * D
// bf16 loads, about 64 flops per byte, so the tensor cores' issue rate bounds it, not HBM.
// What the design does about it: Q K^T and P V run on the tensor cores through mma.sync
// m16n8k16 (bf16 in, fp32 accumulate). One CTA of 4 warps owns 64 query rows of one head; each
// warp owns 16 rows and keeps its Q fragments, S tile and O accumulator in registers. K and V
// tiles of 64 keys are staged in shared memory with 16-byte loads; the G query heads of a KV
// head re-read them through L2. The key sweep stops at the last visible key (capacity grows in
// 512-column buckets, so the unused tail can be long). D = 72 (ViT) pads the QK^T reduction to
// 80 with zero columns in shared memory; P V needs no padding (72 = 9 n-tiles of 8).
// Later work: wgmma with TMA-fed K/V, a multi-stage cp.async pipeline, and sharing one K/V tile
// across the G heads of a group.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_block_attention_kernel(const __nv_bfloat16* __restrict__ q,
                                 const __nv_bfloat16* __restrict__ k,
                                 const __nv_bfloat16* __restrict__ v,
                                 __nv_bfloat16* __restrict__ out, const int* __restrict__ lens,
                                 const int* __restrict__ block_start,
                                 const int* __restrict__ q_valid_len, int T, int H, int Hk, int M,
                                 long long k_ss, long long k_sh, long long k_sm, long long v_ss,
                                 long long v_sh, long long v_sm, int causal, float scale) {
  constexpr int DK = (D + 15) / 16 * 16;  // reduction extent of Q K^T
  constexpr int DP = DK + 8;              // shared row stride: conflict-free fragment loads
  constexpr int kKSteps = DK / 16;
  constexpr int kDTiles = D / 8;
  constexpr int kNTiles = kBN / 8;
  static_assert(D % 8 == 0, "head dim must be a multiple of 8");
  __shared__ __align__(16) __nv_bfloat16 s_qk[kBM * DP];  // the Q tile, then each K tile
  __shared__ __align__(16) __nv_bfloat16 s_v[kBN * DP];

  const int s = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBM;
  const int hk = h / (H / Hk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group and thread-in-group

  // Q tile -> A fragments in registers (rows g and g + 8 of this warp's 16).
  load_tile<D, DK, DP>(s_qk, q + ((long long)s * T * H + h) * D, (long long)H * D, q0, T);
  __syncthreads();
  uint32_t qf[kKSteps][4];
  {
    const __nv_bfloat16* ra = s_qk + (warp * 16 + g) * DP + 2 * t;
    const __nv_bfloat16* rb = ra + 8 * DP;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      qf[kk][0] = ld_u32(ra + kk * 16);
      qf[kk][1] = ld_u32(rb + kk * 16);
      qf[kk][2] = ld_u32(ra + kk * 16 + 8);
      qf[kk][3] = ld_u32(rb + kk * 16 + 8);
    }
  }
  __syncthreads();

  const int ln = lens[s], bs = block_start[s], qv = q_valid_len[s];
  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  // Sweep bound: nothing past the context or the (causally reachable part of the) block is visible.
  const int kv_hi = min(max(ln, bs + (causal ? min(qv, q0 + kBM) : qv)), M);

  float o[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;  // l: this thread's columns only

  const __nv_bfloat16* k_base = k + s * k_ss + hk * k_sh;
  const __nv_bfloat16* v_base = v + s * v_ss + hk * v_sh;

  for (int n0 = 0; n0 < kv_hi; n0 += kBN) {
    load_tile<D, DK, DP>(s_qk, k_base, k_sm, n0, M);
    load_tile<D, D, DP>(s_v, v_base, v_sm, n0, M);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys.
    float sc[kNTiles][4];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
      const __nv_bfloat16* kr = s_qk + (nt * 8 + g) * DP + 2 * t;
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
        const bool ok = j < M && (j < ln || (off >= 0 && off < qv && (!causal || off <= i)));
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
        mma_16816(o[dt], pa, b0, b1);
      }
    }
    __syncthreads();  // the next step overwrites s_qk and s_v
  }

#pragma unroll
  for (int w = 1; w <= 2; w <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, w);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, w);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
  if (row_a < T) {
    __nv_bfloat16* dst = out + (((long long)s * T + row_a) * H + h) * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt)
      *reinterpret_cast<uint32_t*>(dst + dt * 8) = pack_bf16x2(o[dt][0] * inv_a, o[dt][1] * inv_a);
  }
  if (row_b < T) {
    __nv_bfloat16* dst = out + (((long long)s * T + row_b) * H + h) * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt)
      *reinterpret_cast<uint32_t*>(dst + dt * 8) = pack_bf16x2(o[dt][2] * inv_b, o[dt][3] * inv_b);
  }
}

template <int D>
void launch(dim3 grid, cudaStream_t stream, const void* q, const void* k, const void* v, void* out,
            const void* lens, const void* block_start, const void* q_valid_len, int T, int H,
            int Hk, int M, long long k_ss, long long k_sh, long long k_sm, long long v_ss,
            long long v_sh, long long v_sm, int causal, float scale) {
  flash_block_attention_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<const int*>(lens), static_cast<const int*>(block_start),
      static_cast<const int*>(q_valid_len), T, H, Hk, M, k_ss, k_sh, k_sm, v_ss, v_sh, v_sm,
      causal, scale);
}

}  // namespace

// q, out: contiguous [S, T, H, D]; k, v: [S, *, *, D] with the given (stream, head, key) strides
// in elements and D contiguous; lens, block_start, q_valid_len: int32 [S]. Returns a cudaError_t.
extern "C" int unimedvl_flash_block_attention_bf16(
    const void* q, const void* k, const void* v, void* out, const void* lens,
    const void* block_start, const void* q_valid_len, int S, int T, int H, int Hk, int D, int M,
    long long k_ss, long long k_sh, long long k_sm, long long v_ss, long long v_sh,
    long long v_sm, int causal, float scale, void* stream) {
  if (S <= 0 || T <= 0 || M <= 0 || Hk <= 0 || H % Hk != 0 || S > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((T + kBM - 1) / kBM, H, S);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 72:
      launch<72>(grid, st, q, k, v, out, lens, block_start, q_valid_len, T, H, Hk, M, k_ss, k_sh,
                 k_sm, v_ss, v_sh, v_sm, causal, scale);
      break;
    case 128:
      launch<128>(grid, st, q, k, v, out, lens, block_start, q_valid_len, T, H, Hk, M, k_ss, k_sh,
                  k_sm, v_ss, v_sh, v_sm, causal, scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* unimedvl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
