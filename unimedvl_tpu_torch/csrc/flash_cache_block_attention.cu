// K6: attention of a query block over a cache and a separate key/value block, without building
// their concatenation; bf16, head dim 128, for sm_90a.
//
// Replaces the Pallas TPU kernel
// unimedvl_tpu/ops/flash_attention.py::flash_cache_block_attention (kernel body `_kernel2`, its
// k island `_proc_k_chunk`).
//
// What it computes, for stream s, query row i and query head h (KV head hk = h / (H / Hk)): the
// softmax attention of q[s, i, h] over the keys of two arrays as if they were one,
//   cache keys  j < lens[s]                    of k_cache, v_cache [S, Hk, M, D] (through strides),
//   block keys  j < block_len (and j <= i when causal)   of k_block, v_block [S, Tb, Hk, D],
// online softmax in fp32 over both, out = acc / max(l, 1e-30). Options, as on the TPU:
//   q pre-processing: the raw projected q tile becomes the gen-mode q first (MoT RMSNorm with
//     w_und on rows {0, end_row[s]} and w_gen elsewhere, then RoPE, fp32, rounded to bf16);
//   k pre-processing: each raw block-K tile gets the same island with the k-side weights, its
//     own tables (one row per stream, or one per block row) and its own end row, counted in
//     block rows, and is rounded to bf16 before the product, so it equals the k a caller would
//     have processed outside and written out; the processed k never reaches device memory.
//
// What bounds it on the H100: as K1 (flash_block_attention.cu), about 64 flops per byte of K/V
// staged, so the tensor cores' rate, not HBM's. What K6 saves is outside the kernel: the
// caller's copy of the whole cache slice beside the block (2 * (lens + Tb) * Hk * D bf16 written
// and read again per layer) and, with k pre-processing, the fp32 k island's passes over the block.
// What the design does about it: the CTA, tiles and sweep are K1's (flash_common.cuh); the sweep
// runs twice on one running softmax state, first over the cache up to lens[s], then over the
// block, each array read in place through its own strides. The k island runs on the K tile in
// shared memory after its load, once per CTA and tile: every query tile and head of a group
// repeats it (T / 64 * G times per block row), which is the price of keeping it out of device
// memory in this simple form. Later work: as K1, and processing each block-K tile once per KV
// head for all query tiles (a cluster sharing the tile, or a small pre-pass).

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int D = 128;
constexpr int DP = D + 8;

template <bool kQPre, bool kKPre>
__global__ void __launch_bounds__(kThreads) flash_cache_block_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
    const __nv_bfloat16* __restrict__ vc, const __nv_bfloat16* __restrict__ kb,
    const __nv_bfloat16* __restrict__ vb, __nv_bfloat16* __restrict__ out,
    const int* __restrict__ lens, int T, int H, int Hk, int M, int Tb, int block_len,
    long long kc_ss, long long kc_sh, long long kc_sm, long long vc_ss, long long vc_sh,
    long long vc_sm, long long kb_ss, long long kb_sh, long long kb_sm, long long vb_ss,
    long long vb_sh, long long vb_sm, int causal, float scale, Preproc qpre, Preproc kpre) {
  __shared__ __align__(16) __nv_bfloat16 s_qk[kBM * DP];  // the Q tile, then each K tile
  __shared__ __align__(16) __nv_bfloat16 s_v[kBN * DP];

  const int s = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBM;
  const int hk = h / (H / Hk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  load_tile<D, D, DP>(s_qk, q + ((long long)s * T * H + h) * D, (long long)H * D, q0, T);
  __syncthreads();
  if constexpr (kQPre) {
    preprocess_tile<DP>(s_qk, qpre, s, q0, T);
    __syncthreads();
  }
  uint32_t qf[D / 16][4];
  load_q_fragments<D, DP>(qf, s_qk);
  __syncthreads();

  const int row_a = q0 + warp * 16 + (lane >> 2), row_b = row_a + 8;
  RowState<D> st;
  st.init();
  // the cache: keys below lens[s], nothing else
  const int ln = min(lens[s], M);
  sweep_keys<D, D, DP, false>(st, qf, s_qk, s_v, kc + s * kc_ss + hk * kc_sh, kc_sm,
                              vc + s * vc_ss + hk * vc_sh, vc_sm, M, ln, ln, 0, 0, 0, scale,
                              row_a, row_b, kpre, s);
  // the block: keys below block_len, causal within the block when asked
  const int blk = min(block_len, Tb);
  const int blk_hi = causal ? min(blk, q0 + kBM) : blk;
  sweep_keys<D, D, DP, kKPre>(st, qf, s_qk, s_v, kb + s * kb_ss + hk * kb_sh, kb_sm,
                              vb + s * vb_ss + hk * vb_sh, vb_sm, Tb, blk_hi, 0, 0, blk, causal,
                              scale, row_a, row_b, kpre, s);
  store_rows<D>(st, out, nullptr, s, T, H, h, row_a, row_b);
}

struct Strides {
  long long ss, sh, sm;
};

template <bool kQPre, bool kKPre>
void launch(dim3 grid, cudaStream_t stream, const void* q, const void* kc, const void* vc,
            const void* kb, const void* vb, void* out, const void* lens, int T, int H, int Hk,
            int M, int Tb, int block_len, Strides a, Strides b, Strides c, Strides d, int causal,
            float scale, const Preproc& qpre, const Preproc& kpre) {
  auto bf = [](const void* p) { return static_cast<const __nv_bfloat16*>(p); };
  flash_cache_block_attention_kernel<kQPre, kKPre><<<grid, kThreads, 0, stream>>>(
      bf(q), bf(kc), bf(vc), bf(kb), bf(vb), static_cast<__nv_bfloat16*>(out),
      static_cast<const int*>(lens), T, H, Hk, M, Tb, block_len, a.ss, a.sh, a.sm, b.ss, b.sh,
      b.sm, c.ss, c.sh, c.sm, d.ss, d.sh, d.sm, causal, scale, qpre, kpre);
}

Preproc make_preproc(const void* w_und, const void* w_gen, const void* cos, const void* sin,
                     long long tab_ss, long long tab_rs, const void* end_row, float eps) {
  return Preproc{static_cast<const float*>(w_und), static_cast<const float*>(w_gen),
                 static_cast<const float*>(cos),   static_cast<const float*>(sin),
                 tab_ss,                           tab_rs,
                 static_cast<const int*>(end_row), eps};
}

}  // namespace

// q, out: contiguous [S, T, H, 128]; k_cache, v_cache: M keys, k_block, v_block: Tb keys, each
// with its (stream, head, key) strides in elements and D contiguous; lens int32 [S]. `q_pre` /
// `k_pre` switch the pre-processing on; their operands are w_und, w_gen fp32 [128], cos, sin fp32
// with stream stride tab_ss and row stride tab_rs in elements, end_row int32 [S] (ignored, and may
// be null, when off). k_pre needs q_pre. Returns a cudaError_t.
extern "C" int unimedvl_flash_cache_block_attention_bf16(
    const void* q, const void* k_cache, const void* v_cache, const void* k_block,
    const void* v_block, void* out, const void* lens, int S, int T, int H, int Hk, int D_, int M,
    int Tb, int block_len, long long kc_ss, long long kc_sh, long long kc_sm, long long vc_ss,
    long long vc_sh, long long vc_sm, long long kb_ss, long long kb_sh, long long kb_sm,
    long long vb_ss, long long vb_sh, long long vb_sm, int causal, float scale, int q_pre,
    const void* q_w_und, const void* q_w_gen, const void* q_cos, const void* q_sin,
    long long q_tab_ss, long long q_tab_rs, const void* q_end_row, int k_pre,
    const void* k_w_und, const void* k_w_gen, const void* k_cos, const void* k_sin,
    long long k_tab_ss, long long k_tab_rs, const void* k_end_row, float eps, void* stream) {
  if (S <= 0 || T <= 0 || M <= 0 || Tb <= 0 || Hk <= 0 || H % Hk != 0 || S > 65535 ||
      H > 65535 || D_ != D || block_len < 0 || (k_pre && !q_pre))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((T + kBM - 1) / kBM, H, S);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Preproc qp = make_preproc(q_w_und, q_w_gen, q_cos, q_sin, q_tab_ss, q_tab_rs, q_end_row, eps);
  const Preproc kp = make_preproc(k_w_und, k_w_gen, k_cos, k_sin, k_tab_ss, k_tab_rs, k_end_row, eps);
  const Strides a{kc_ss, kc_sh, kc_sm}, b{vc_ss, vc_sh, vc_sm}, c{kb_ss, kb_sh, kb_sm},
      d{vb_ss, vb_sh, vb_sm};
  if (k_pre)
    launch<true, true>(grid, st, q, k_cache, v_cache, k_block, v_block, out, lens, T, H, Hk, M, Tb,
                       block_len, a, b, c, d, causal, scale, qp, kp);
  else if (q_pre)
    launch<true, false>(grid, st, q, k_cache, v_cache, k_block, v_block, out, lens, T, H, Hk, M,
                        Tb, block_len, a, b, c, d, causal, scale, qp, kp);
  else
    launch<false, false>(grid, st, q, k_cache, v_cache, k_block, v_block, out, lens, T, H, Hk, M,
                         Tb, block_len, a, b, c, d, causal, scale, qp, kp);
  return static_cast<int>(cudaGetLastError());
}
