// K2: single-token GQA decode attention over the head-major bf16 KV cache, for sm_90a.
//
// Replaces the Pallas TPU kernel unimedvl_tpu/ops/decode_attention.py::decode_attention
// (kernel body `_kernel`) for a bf16 cache; the int8 cache with per-key scales waits for the
// quantized serving slice.
//
// What it computes, for stream s and query head h (KV head hk = h / G, G = H / Hk):
//   out[s, 0, h] = sum_j softmax_j(q[s, 0, h] . k[s, hk, j] / sqrt(D)) v[s, hk, j]
// over the keys j < M that are visible: j < lens[s], or base[s] <= j <= col[s]. The band
// (base, col) is the aligned-column decode band of generate_text; serving passes (lens, lens).
// Softmax is online and in fp32; out = acc / max(l, 1e-30), as on the TPU.
//
// What bounds it on the H100: it reads 2 * kv * D bf16 of cache per (stream, KV head) and does
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

template <int D>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                            const int* __restrict__ lens, const int* __restrict__ band_base,
                            const int* __restrict__ band_col, int H, int Hk, int M, long long k_ss,
                            long long k_sh, long long k_sm, long long v_ss, long long v_sh,
                            long long v_sm, float scale) {
  static_assert(kThreads % D == 0 && D % 8 == 0, "a pass of P V covers whole rows of D");
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
  const __nv_bfloat16* k_base = k + s * k_ss + hk * k_sh;
  const __nv_bfloat16* v_base = v + s * v_ss + hk * v_sh;
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
      for (int c = 0; c < D / 8; ++c) {
        const uint4 raw = kr[c];
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
    const __nv_bfloat16* vc = v_base + (long long)c0 * v_sm + d;
#pragma unroll 8
    for (int jj = 0; jj < n; ++jj) {
      const float vv = __bfloat162float(vc[(long long)jj * v_sm]);
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

}  // namespace

// q, out: contiguous [S, 1, H, D]; k, v: [S, Hk, M, D] with the given (stream, head, key)
// strides in elements and D contiguous; lens, band_base, band_col: int32 [S].
// Returns a cudaError_t.
extern "C" int unimedvl_decode_attention_bf16(const void* q, const void* k, const void* v,
                                              void* out, const void* lens, const void* band_base,
                                              const void* band_col, int S, int H, int Hk, int D,
                                              int M, long long k_ss, long long k_sh,
                                              long long k_sm, long long v_ss, long long v_sh,
                                              long long v_sm, float scale, void* stream) {
  if (S <= 0 || M <= 0 || Hk <= 0 || H % Hk != 0 || H / Hk > kMaxGroup || S > 65535 ||
      Hk > 65535 || D != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(Hk, S);
  decode_attention_kernel<128><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<const int*>(lens), static_cast<const int*>(band_base),
      static_cast<const int*>(band_col), H, Hk, M, k_ss, k_sh, k_sm, v_ss, v_sh, v_sm, scale);
  return static_cast<int>(cudaGetLastError());
}
