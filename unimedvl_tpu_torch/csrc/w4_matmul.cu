// K4: packed-int4 weight matmul (w4a8 and weight-only w4), for sm_90a.
//
// Replaces the Pallas TPU kernel unimedvl_tpu/ops/w4_matmul.py::w4_matmul (kernel body
// `_make_w4_kernel`).
//
// What it computes: y[m, N] = (x[m, K] @ unpack(wp)[N, K]^T) * x_scale[m] * w_scale, bf16 out.
//   wp [N, K/2]: byte r of a row holds in-row 2r in its low nibble and 2r + 1 in its high nibble,
//   both signed in [-8, 7] (the TPU layout [K/2, N] transposed: weights are [out, in] here).
//   x int8 with x_scale fp32 [m] (w4a8): products accumulate in int32, exactly; or x bf16 without
//   x_scale (weight-only w4): nibbles widen to bf16 exactly, products accumulate in fp32.
//   w_scale fp32 [N] (G = 0): the whole K accumulates, then float(acc) * x_scale * w_scale in that
//   order, each a rounded multiply, so the int8 branch equals the integer reference bit for bit.
//   w_scale fp32 [G, N]: each group of K/G in-rows accumulates alone, is scaled by its w_scale and
//   added in fp32 in group order (rounded multiply, rounded add: no fused multiply-add), and
//   x_scale multiplies last.
//
// Unpacking happens in registers and never widens to 16 or 32 bits per nibble. A 32-bit word of
// wp is 8 in-rows: (w << 4) & 0xF0F0F0F0 holds the four even in-rows as signed bytes, each 16
// times its nibble, and w & 0xF0F0F0F0 the four odd ones. Those bytes feed the integer dot
// products as they are, against the even and odd bytes of x (one byte permute each), and the
// int32 sum, a multiple of 16 below 2^31 for K up to 130,000, is shifted right by 4 at the end.
//
// What bounds it on the H100: at decode (m of 1 to a few rows) each weight byte is used for 2 m
// multiply-adds: HBM bandwidth, at half a byte per weight. At prefill (m in the thousands) the
// integer tensor cores.
// What the design does about it, two paths chosen by m:
//  - m <= 4: a weight-streaming GEMV. Half a warp owns an output column and walks its packed row
//    with 16-byte loads (32 in-rows each, 256 contiguous bytes per half-warp), every weight byte
//    read once; x is read through L1 and each product is a __dp4a (int8 x) or an fp32
//    multiply-add (bf16 x); the 16 lanes reduce with shuffles.
//  - m > 4: a tiled GEMM on mma.sync: m16n8k32 s8 x s8 -> s32, or m16n8k16 bf16 -> fp32. A CTA
//    of 8 warps computes a 128 x 128 tile in k-steps of 64 in-rows through shared memory (x tile
//    and packed w tile, rows padded against bank conflicts); each warp holds a 32 x 64 part of it.
// Known limits: the GEMM loads a tile, synchronises, computes, synchronises: no cp.async or TMA
// pipeline, and mma.sync, not wgmma. Those are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// The four even in-rows of a packed word as signed bytes, each 16 times its nibble; the odd ones.
__device__ __forceinline__ int lo16(uint32_t p) { return static_cast<int>((p << 4) & 0xF0F0F0F0u); }
__device__ __forceinline__ int hi16(uint32_t p) { return static_cast<int>(p & 0xF0F0F0F0u); }
// Of 8 consecutive bytes of x (two words): the even ones, the odd ones.
__device__ __forceinline__ int evens(uint32_t w0, uint32_t w1) {
  return static_cast<int>(__byte_perm(w0, w1, 0x6420));
}
__device__ __forceinline__ int odds(uint32_t w0, uint32_t w1) {
  return static_cast<int>(__byte_perm(w0, w1, 0x7531));
}
// Signed nibbles of byte b of a packed word: in-rows 2b and 2b + 1.
__device__ __forceinline__ int nib_lo(uint32_t p, int b) {
  return static_cast<int>(p << (28 - 8 * b)) >> 28;
}
__device__ __forceinline__ int nib_hi(uint32_t p, int b) {
  return static_cast<int>(p << (24 - 8 * b)) >> 28;
}

// acc += 16 * (8 in-rows of x . the packed word's 8 nibbles)
__device__ __forceinline__ int dot8(uint32_t p, uint32_t x0, uint32_t x1, int acc) {
  acc = __dp4a(lo16(p), evens(x0, x1), acc);
  return __dp4a(hi16(p), odds(x0, x1), acc);
}

// acc += 8 bf16 in-rows of x (one 16-byte load) . the packed word's 8 nibbles
__device__ __forceinline__ float dot8(uint32_t p, const uint4& xv, float acc) {
  const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&xv);
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const float2 xf = __bfloat1622float2(xp[b]);
    acc = fmaf(xf.x, static_cast<float>(nib_lo(p, b)), acc);
    acc = fmaf(xf.y, static_cast<float>(nib_hi(p, b)), acc);
  }
  return acc;
}

// ---------------------------------------------------------------------------------------------
// m <= kGemvRows: weight-streaming GEMV
// ---------------------------------------------------------------------------------------------

constexpr int kGemvRows = 4;
constexpr int kGemvThreads = 256;  // 8 warps, two output columns per warp

template <bool INT8X>
__global__ void __launch_bounds__(kGemvThreads)
    w4_gemv_kernel(const void* __restrict__ x_, const float* __restrict__ xs,
                   const uint8_t* __restrict__ wp, const float* __restrict__ ws,
                   bf16* __restrict__ out, int m, int K, int N, int G) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int hl = lane & 15;  // lane within the half-warp that owns column n
  const int n = (blockIdx.x * (kGemvThreads / 32) + warp) * 2 + (lane >> 4);
  if (n >= N) return;  // whole warps only: N is even
  const int chunks = K / 32;                      // 16-byte loads in a packed row
  const int cpg = G ? (K / G) / 32 : chunks;      // loads per scale group
  const uint4* wr = reinterpret_cast<const uint4*>(wp + static_cast<long long>(n) * (K / 2));

  float facc[kGemvRows];
#pragma unroll
  for (int r = 0; r < kGemvRows; ++r) facc[r] = 0.f;

  for (int g0 = 0, gi = 0; g0 < chunks; g0 += cpg, ++gi) {
    int iacc[kGemvRows];
    float cacc[kGemvRows];
#pragma unroll
    for (int r = 0; r < kGemvRows; ++r) {
      iacc[r] = 0;
      cacc[r] = 0.f;
    }
#pragma unroll 4
    for (int c = g0 + hl; c < g0 + cpg; c += 16) {
      const uint4 w = __ldg(wr + c);
#pragma unroll
      for (int r = 0; r < kGemvRows; ++r) {
        if (r < m) {
          if constexpr (INT8X) {
            const uint4* xr = reinterpret_cast<const uint4*>(
                static_cast<const int8_t*>(x_) + static_cast<long long>(r) * K);
            const uint4 x0 = __ldg(xr + 2 * c), x1 = __ldg(xr + 2 * c + 1);
            int a = iacc[r];
            a = dot8(w.x, x0.x, x0.y, a);
            a = dot8(w.y, x0.z, x0.w, a);
            a = dot8(w.z, x1.x, x1.y, a);
            a = dot8(w.w, x1.z, x1.w, a);
            iacc[r] = a;
          } else {
            const uint4* xr = reinterpret_cast<const uint4*>(
                static_cast<const bf16*>(x_) + static_cast<long long>(r) * K);
            float a = cacc[r];
            a = dot8(w.x, __ldg(xr + 4 * c), a);
            a = dot8(w.y, __ldg(xr + 4 * c + 1), a);
            a = dot8(w.z, __ldg(xr + 4 * c + 2), a);
            a = dot8(w.w, __ldg(xr + 4 * c + 3), a);
            cacc[r] = a;
          }
        }
      }
    }
    const float wsg = G ? ws[static_cast<long long>(gi) * N + n] : 0.f;
#pragma unroll
    for (int r = 0; r < kGemvRows; ++r) {
      float v;
      if constexpr (INT8X) {
        int a = iacc[r];
#pragma unroll
        for (int s = 8; s > 0; s >>= 1) a += __shfl_xor_sync(0xffffffffu, a, s);
        v = static_cast<float>(a >> 4);
      } else {
        v = cacc[r];
#pragma unroll
        for (int s = 8; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
      }
      facc[r] = G ? __fadd_rn(facc[r], __fmul_rn(v, wsg)) : v;
    }
  }
  if (hl == 0) {
#pragma unroll
    for (int r = 0; r < kGemvRows; ++r) {
      if (r < m) {
        float y = facc[r];
        if constexpr (INT8X) y = __fmul_rn(y, xs[r]);
        if (!G) y = __fmul_rn(y, ws[n]);
        out[static_cast<long long>(r) * N + n] = __float2bfloat16(y);
      }
    }
  }
}

// ---------------------------------------------------------------------------------------------
// m > kGemvRows: tiled GEMM on mma.sync
// ---------------------------------------------------------------------------------------------

constexpr int kBM = 128, kBN = 128, kBK = 64;  // CTA tile; k-step in in-rows
constexpr int kMmaThreads = 256;               // 8 warps as 4 (rows) x 2 (columns): 32 x 64 each
constexpr int kWStride = kBK / 2 + 16;         // bytes per packed w row in shared memory

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The two nibbles of a packed byte as a bf16 pair (in-row 2r low, 2r + 1 high).
__device__ __forceinline__ uint32_t nibbles_bf16x2(uint8_t byte) {
  const int b = static_cast<int8_t>(byte);
  const int lo = static_cast<int>(static_cast<uint32_t>(b) << 28) >> 28;
  const __nv_bfloat162 v = __floats2bfloat162_rn(static_cast<float>(lo), static_cast<float>(b >> 4));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// gsize: in-rows per scale group (a multiple of kBK), K when per channel.
template <bool INT8X, bool GROUPED>
__global__ void __launch_bounds__(kMmaThreads)
    w4_mma_kernel(const void* __restrict__ x_, const float* __restrict__ xs,
                  const uint8_t* __restrict__ wp, const float* __restrict__ ws,
                  bf16* __restrict__ out, int m, int K, int N, int gsize) {
  constexpr int kXBytes = INT8X ? 1 : 2;              // bytes per x element
  constexpr int kXStride = kBK * kXBytes + 16;        // bytes per x row in shared memory
  constexpr int kXLoads = kBK * kXBytes / 16;         // 16-byte loads per x row and k-step
  __shared__ __align__(16) uint8_t s_x[kBM * kXStride];
  __shared__ __align__(16) uint8_t s_w[kBN * kWStride];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const uint8_t* xb = static_cast<const uint8_t*>(x_);

  int iacc[2][8][4];    // int8 x: this group's (or the whole K's) integer sums, times 16
  float cacc[2][8][4];  // bf16 x: the same in fp32
  float facc[2][8][4];  // grouped: the scaled groups added so far
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        iacc[mi][ni][e] = 0;
        cacc[mi][ni][e] = 0.f;
        facc[mi][ni][e] = 0.f;
      }

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // x tile [kBM, kBK] and packed w tile [kBN, kBK / 2] into shared memory; rows past the edge 0
#pragma unroll
    for (int i = 0; i < kBM * kXLoads / kMmaThreads; ++i) {
      const int idx = tid + i * kMmaThreads;
      const int row = idx / kXLoads, c = idx % kXLoads;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + row < m)
        v = *reinterpret_cast<const uint4*>(
            xb + (static_cast<long long>(m0 + row) * K + k0) * kXBytes + c * 16);
      *reinterpret_cast<uint4*>(s_x + row * kXStride + c * 16) = v;
    }
    {
      const int row = tid >> 1, c = tid & 1;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + row < N)
        v = *reinterpret_cast<const uint4*>(
            wp + static_cast<long long>(n0 + row) * (K / 2) + k0 / 2 + c * 16);
      *reinterpret_cast<uint4*>(s_w + row * kWStride + c * 16) = v;
    }
    __syncthreads();

    if constexpr (INT8X) {
      // two k32 steps. A k32 step holds 32 in-rows; this thread's 8 are 8 tig .. 8 tig + 7: the
      // even ones fill the MMA's k slots 4 tig .. 4 tig + 3, the odd ones 16 + 4 tig ..,
      // in x and in w alike, so the sum over k is the same.
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int row = wm * 32 + mi * 16 + g;
          const uint2 r0 = *reinterpret_cast<const uint2*>(s_x + row * kXStride + kc * 32 + tig * 8);
          const uint2 r8 =
              *reinterpret_cast<const uint2*>(s_x + (row + 8) * kXStride + kc * 32 + tig * 8);
          a[mi][0] = evens(r0.x, r0.y);
          a[mi][1] = evens(r8.x, r8.y);
          a[mi][2] = odds(r0.x, r0.y);
          a[mi][3] = odds(r8.x, r8.y);
        }
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          const int col = wn * 64 + ni * 8 + g;
          const uint32_t p =
              *reinterpret_cast<const uint32_t*>(s_w + col * kWStride + kc * 16 + tig * 4);
          const uint32_t b0 = lo16(p), b1 = hi16(p);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) mma_s8(iacc[mi][ni], a[mi], b0, b1);
        }
      }
    } else {
      // four k16 steps; byte r of a packed row is the bf16 pair (2r, 2r + 1) the MMA wants
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const uint8_t* r0 = s_x + (wm * 32 + mi * 16 + g) * kXStride + kk * 32 + tig * 4;
          const uint8_t* r8 = r0 + 8 * kXStride;
          a[mi][0] = *reinterpret_cast<const uint32_t*>(r0);
          a[mi][1] = *reinterpret_cast<const uint32_t*>(r8);
          a[mi][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
          a[mi][3] = *reinterpret_cast<const uint32_t*>(r8 + 16);
        }
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          const uint8_t* wrow = s_w + (wn * 64 + ni * 8 + g) * kWStride + kk * 8 + tig;
          const uint32_t b0 = nibbles_bf16x2(wrow[0]), b1 = nibbles_bf16x2(wrow[4]);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) mma_bf16(cacc[mi][ni], a[mi], b0, b1);
        }
      }
    }
    __syncthreads();

    if constexpr (GROUPED) {
      if ((k0 + kBK) % gsize == 0) {  // a group ends: scale it, add it, start the next
        const float* wsg = ws + static_cast<long long>(k0 / gsize) * N;
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          const int col = n0 + wn * 64 + ni * 8 + tig * 2;
          const float w0 = col < N ? wsg[col] : 0.f, w1 = col + 1 < N ? wsg[col + 1] : 0.f;
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float v;
              if constexpr (INT8X) {
                v = static_cast<float>(iacc[mi][ni][e] >> 4);
                iacc[mi][ni][e] = 0;
              } else {
                v = cacc[mi][ni][e];
                cacc[mi][ni][e] = 0.f;
              }
              facc[mi][ni][e] = __fadd_rn(facc[mi][ni][e], __fmul_rn(v, (e & 1) ? w1 : w0));
            }
        }
      }
    }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = m0 + wm * 32 + mi * 16 + g + (e >> 1) * 8;
      if (row >= m) continue;
      const float xsr = INT8X ? xs[row] : 1.f;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int col = n0 + wn * 64 + ni * 8 + tig * 2 + (e & 1);
        if (col >= N) continue;
        float y;
        if constexpr (GROUPED) {
          y = facc[mi][ni][e];
        } else if constexpr (INT8X) {
          y = static_cast<float>(iacc[mi][ni][e] >> 4);
        } else {
          y = cacc[mi][ni][e];
        }
        if constexpr (INT8X) y = __fmul_rn(y, xsr);
        if constexpr (!GROUPED) y = __fmul_rn(y, ws[col]);
        out[static_cast<long long>(row) * N + col] = __float2bfloat16(y);
      }
    }
}

template <bool INT8X>
cudaError_t launch(const void* x, const float* xs, const uint8_t* wp, const float* ws, bf16* out,
                   int m, int K, int N, int G, cudaStream_t stream) {
  if (m <= kGemvRows) {
    const int cols_per_block = (kGemvThreads / 32) * 2;
    w4_gemv_kernel<INT8X><<<(N + cols_per_block - 1) / cols_per_block, kGemvThreads, 0, stream>>>(
        x, xs, wp, ws, out, m, K, N, G);
  } else {
    const dim3 grid((N + kBN - 1) / kBN, (m + kBM - 1) / kBM);
    if (G)
      w4_mma_kernel<INT8X, true><<<grid, kMmaThreads, 0, stream>>>(x, xs, wp, ws, out, m, K, N,
                                                                  K / G);
    else
      w4_mma_kernel<INT8X, false><<<grid, kMmaThreads, 0, stream>>>(x, xs, wp, ws, out, m, K, N,
                                                                   K);
  }
  return cudaGetLastError();
}

}  // namespace

// x: contiguous [m, K] int8 (int8x != 0, with xs fp32 [m]) or bf16 (xs ignored); wp: contiguous
// [N, K / 2] packed int4; ws: fp32 [N] (G == 0) or [G, N]; out: contiguous [m, N] bf16.
// K a multiple of 64, K / G a multiple of 64, N a multiple of 8; every pointer 16-byte aligned.
// Returns a cudaError_t.
extern "C" int unimedvl_w4_matmul(const void* x, const void* xs, const void* wp, const void* ws,
                                  void* out, int m, int K, int N, int G, int int8x, void* stream) {
  if (m <= 0 || K <= 0 || N <= 0 || K % kBK != 0 || N % 8 != 0 || G < 0 ||
      (G > 0 && (K % G != 0 || (K / G) % kBK != 0)) || (int8x && xs == nullptr) ||
      (m + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t rc =
      int8x ? launch<true>(x, static_cast<const float*>(xs), static_cast<const uint8_t*>(wp),
                           static_cast<const float*>(ws), static_cast<bf16*>(out), m, K, N, G, st)
            : launch<false>(x, static_cast<const float*>(xs), static_cast<const uint8_t*>(wp),
                            static_cast<const float*>(ws), static_cast<bf16*>(out), m, K, N, G, st);
  return static_cast<int>(rc);
}
