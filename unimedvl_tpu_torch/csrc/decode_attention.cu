// K2 and K2-int8: single-token GQA decode attention over the head-major KV cache, bf16 or int8
// with per-key fp32 scales, for sm_90a. One kernel template, instantiated for each cache type.
//
// Replaces the Pallas TPU kernel unimedvl_tpu/ops/decode_attention.py::decode_attention
// (kernel body `_kernel`), whose `quantized` flag is the template's INT8.
//
// What it computes, for stream s and query head h (KV head hk = h / G, G = H / Hk):
//   out[s, 0, h] = sum_j softmax_j(q[s, 0, h] . k[s, hk, j] / sqrt(D)) v[s, hk, j]
// over the keys j < M that are visible: j < lens[s], or base[s] <= j <= col[s]. The band
// (base, col) is the aligned-column decode band of generate_text; serving passes (lens, lens).
// Softmax is online and in fp32; out = acc / max(l, 1e-30), as on the TPU.
// With an int8 cache and scales k_scale, v_scale [S, Hk, M], the cache is never dequantized:
//   logit[j] = (q . k_int8[j] / sqrt(D)) * k_scale[j],   out = sum_j (p[j] * v_scale[j]) v_int8[j] / l
// where l sums the unscaled p. The int8 values widen to fp32 in registers.
//
// What bounds it on the H100: it reads 2 * kv * D cache elements (2 bytes each in bf16, 1 in
// int8, plus 8 bytes of scales per key) per (stream, KV head) and does
// about 4 * G * D flops per key, 7 flops per byte at G = 7: HBM bandwidth bounds it.
// What the design does about it: one CTA per (KV head, stream) reads each cache row once and
// serves the G query heads of the group from it. A chunk of 256 keys is one key per thread for
// the logits (q held in shared memory, fp32), one warp per head for the chunk's softmax, and one
// d-lane per thread for P V with coalesced V rows. The sweep stops at max(lens, col + 1).
// Known limit: at chat's S = 1 the grid is Hk = 4 CTAs on 132 SMs, so one SM's load bandwidth
// bounds a step. The next step is to split the key axis over more CTAs and combine the partial
// (m, l, acc) in a second pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -3.402823466e38f;  // finfo(float32).min, the TPU kernel's mask value
constexpr int kThreads = 256;                 // keys per chunk: one per thread
constexpr int kMaxGroup = 8;                  // query heads per KV head (G = 7 on the 14B model)

// Byte i of a word of int8 values, each already XORed with 0x80, as fp32: the byte becomes the
// low mantissa bits of 2^23, and subtracting 2^23 + 128 leaves the signed value, exactly. A
// byte permute and an add, both at full rate; the int-to-float conversion runs at an eighth.
__device__ __forceinline__ float s8_to_float(uint32_t word_x80, int i) {
  return __uint_as_float(__byte_perm(word_x80, 0x4B000000u, 0x7650 + i)) - 8388736.0f;
}

// A cache element as fp32.
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) {
  return __uint_as_float(0x4B000000u | (static_cast<uint8_t>(x) ^ 0x80u)) - 8388736.0f;
}

// KV is the cache element: __nv_bfloat16 (k_scale, v_scale unused) or int8_t with scales.
template <int D, typename KV>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const __nv_bfloat16* __restrict__ q, const KV* __restrict__ k,
                            const KV* __restrict__ v, const float* __restrict__ k_scale,
                            const float* __restrict__ v_scale, __nv_bfloat16* __restrict__ out,
                            const int* __restrict__ lens, const int* __restrict__ band_base,
                            const int* __restrict__ band_col, int H, int Hk, int M, long long k_ss,
                            long long k_sh, long long k_sm, long long v_ss, long long v_sh,
                            long long v_sm, float scale) {
  static_assert(kThreads % D == 0 && D % 16 == 0, "a pass of P V covers whole rows of D");
  constexpr bool kInt8 = sizeof(KV) == 1;
  constexpr int kPerLoad = 16 / sizeof(KV);  // cache elements per 16-byte load
  constexpr int kGroupsPerPass = kThreads / D;
  constexpr int kAcc = (kMaxGroup + kGroupsPerPass - 1) / kGroupsPerPass;
  __shared__ float s_q[kMaxGroup][D];
  __shared__ float s_p[kMaxGroup][kThreads];
  __shared__ float s_m[kMaxGroup], s_l[kMaxGroup], s_alpha[kMaxGroup];

  const int hk = blockIdx.x, s = blockIdx.y;
  const int G = H / Hk;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const __nv_bfloat16* qs = q + ((long long)s * H + (long long)hk * G) * D;
  for (int idx = tid; idx < G * D; idx += kThreads)
    s_q[idx / D][idx % D] = __bfloat162float(qs[idx]) * scale;
  if (tid < kMaxGroup) {
    s_m[tid] = kNegInf;
    s_l[tid] = 0.f;
  }
  __syncthreads();

  const int ln = lens[s], base = band_base[s], col = band_col[s];
  const int kv_hi = min(max(ln, col + 1), M);
  const KV* k_base = k + s * k_ss + hk * k_sh;
  const KV* v_base = v + s * v_ss + hk * v_sh;
  // scales are contiguous [S, Hk, M]
  const float* ks_base = kInt8 ? k_scale + ((long long)s * Hk + hk) * M : nullptr;
  const float* vs_base = kInt8 ? v_scale + ((long long)s * Hk + hk) * M : nullptr;
  const int d = tid % D, gsub = tid / D;
  float acc[kAcc];
#pragma unroll
  for (int e = 0; e < kAcc; ++e) acc[e] = 0.f;

  for (int c0 = 0; c0 < kv_hi; c0 += kThreads) {
    // Logits: thread tid scores key c0 + tid against the G query heads.
    const int j = c0 + tid;
    const bool ok = j < kv_hi && (j < ln || (j >= base && j <= col));
    float logit[kMaxGroup];
#pragma unroll
    for (int gg = 0; gg < kMaxGroup; ++gg) logit[gg] = 0.f;
    if (ok) {
      const uint4* kr = reinterpret_cast<const uint4*>(k_base + (long long)j * k_sm);
#pragma unroll 4
      for (int c = 0; c < D / kPerLoad; ++c) {
        const uint4 raw = kr[c];
        if constexpr (kInt8) {
          const uint32_t w[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u, raw.z ^ 0x80808080u,
                                 raw.w ^ 0x80808080u};
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            const float kf = s8_to_float(w[e >> 2], e & 3);
            const int dd = c * 16 + e;
#pragma unroll
            for (int gg = 0; gg < kMaxGroup; ++gg)
              if (gg < G) logit[gg] += s_q[gg][dd] * kf;
          }
        } else {
          const __nv_bfloat162* pr = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 kf = __bfloat1622float2(pr[e]);
            const int dd = c * 8 + 2 * e;
#pragma unroll
            for (int gg = 0; gg < kMaxGroup; ++gg)
              if (gg < G) logit[gg] += s_q[gg][dd] * kf.x + s_q[gg][dd + 1] * kf.y;
          }
        }
      }
      if constexpr (kInt8) {
        const float ksc = ks_base[j];
#pragma unroll
        for (int gg = 0; gg < kMaxGroup; ++gg) logit[gg] *= ksc;
      }
    }
#pragma unroll
    for (int gg = 0; gg < kMaxGroup; ++gg)
      if (gg < G) s_p[gg][tid] = ok ? logit[gg] : kNegInf;
    __syncthreads();

    // Softmax step: warp w updates head w's running max and sum and turns logits into weights.
    if (warp < G) {
      float mx = kNegInf;
      for (int i = lane; i < kThreads; i += 32) mx = fmaxf(mx, s_p[warp][i]);
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_old = s_m[warp], m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int i = lane; i < kThreads; i += 32) {
        const float x = s_p[warp][i];
        const float p = x > kNegInf ? __expf(x - m_new) : 0.f;  // masked keys weigh 0
        s_p[warp][i] = p;
        sum += p;
      }
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      if constexpr (kInt8) {  // weights of the P V sum carry v's scale; the sum l above does not
        for (int i = lane; i < kThreads; i += 32) {
          const int jv = c0 + i;
          const float p = s_p[warp][i];
          s_p[warp][i] = (p > 0.f && jv < kv_hi) ? p * vs_base[jv] : 0.f;
        }
      }
      if (lane == 0) {
        const float alpha = __expf(m_old - m_new);
        s_alpha[warp] = alpha;
        s_l[warp] = s_l[warp] * alpha + sum;
        s_m[warp] = m_new;
      }
    }
    __syncthreads();

    // acc[g][d] = alpha * acc + sum_j p[g][j] v[j][d]; thread (gsub, d) owns heads gsub + e * passes.
#pragma unroll
    for (int e = 0; e < kAcc; ++e) {
      const int gg = gsub + e * kGroupsPerPass;
      if (gg < G) acc[e] *= s_alpha[gg];
    }
    const int n = min(kThreads, kv_hi - c0);
    const KV* vc = v_base + (long long)c0 * v_sm + d;
#pragma unroll 8
    for (int jj = 0; jj < n; ++jj) {
      const float vv = to_float(vc[(long long)jj * v_sm]);
#pragma unroll
      for (int e = 0; e < kAcc; ++e) {
        const int gg = gsub + e * kGroupsPerPass;
        if (gg < G) acc[e] += s_p[gg][jj] * vv;
      }
    }
    __syncthreads();  // the next chunk overwrites s_p
  }

#pragma unroll
  for (int e = 0; e < kAcc; ++e) {
    const int gg = gsub + e * kGroupsPerPass;
    if (gg < G)
      out[((long long)s * H + (long long)hk * G + gg) * D + d] =
          __float2bfloat16(acc[e] / fmaxf(s_l[gg], 1e-30f));
  }
}

template <typename KV>
int launch(const void* q, const void* k, const void* v, const void* k_scale, const void* v_scale,
           void* out, const void* lens, const void* band_base, const void* band_col, int S, int H,
           int Hk, int D, int M, long long k_ss, long long k_sh, long long k_sm, long long v_ss,
           long long v_sh, long long v_sm, float scale, void* stream) {
  if (S <= 0 || M <= 0 || Hk <= 0 || H % Hk != 0 || H / Hk > kMaxGroup || S > 65535 ||
      Hk > 65535 || D != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(Hk, S);
  decode_attention_kernel<128, KV><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<__nv_bfloat16*>(out), static_cast<const int*>(lens),
      static_cast<const int*>(band_base), static_cast<const int*>(band_col), H, Hk, M, k_ss, k_sh,
      k_sm, v_ss, v_sh, v_sm, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: contiguous [S, 1, H, D] bf16; k, v: [S, Hk, M, D] with the given (stream, head, key)
// strides in elements (multiples of 16 bytes) and D contiguous; lens, band_base, band_col:
// int32 [S]. Returns a cudaError_t.
extern "C" int unimedvl_decode_attention_bf16(const void* q, const void* k, const void* v,
                                              void* out, const void* lens, const void* band_base,
                                              const void* band_col, int S, int H, int Hk, int D,
                                              int M, long long k_ss, long long k_sh,
                                              long long k_sm, long long v_ss, long long v_sh,
                                              long long v_sm, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, nullptr, nullptr, out, lens, band_base, band_col, S, H,
                               Hk, D, M, k_ss, k_sh, k_sm, v_ss, v_sh, v_sm, scale, stream);
}

// As above over an int8 cache: k, v int8; k_scale, v_scale contiguous fp32 [S, Hk, M].
extern "C" int unimedvl_decode_attention_int8(const void* q, const void* k, const void* v,
                                              const void* k_scale, const void* v_scale, void* out,
                                              const void* lens, const void* band_base,
                                              const void* band_col, int S, int H, int Hk, int D,
                                              int M, long long k_ss, long long k_sh,
                                              long long k_sm, long long v_ss, long long v_sh,
                                              long long v_sm, float scale, void* stream) {
  if (k_scale == nullptr || v_scale == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<int8_t>(q, k, v, k_scale, v_scale, out, lens, band_base, band_col, S, H, Hk, D, M,
                        k_ss, k_sh, k_sm, v_ss, v_sh, v_sm, scale, stream);
}
