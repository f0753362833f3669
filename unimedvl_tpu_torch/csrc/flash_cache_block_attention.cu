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
// What bounds it on the H100: as K1 (flash_block_attention.cu), 64-128 flops per byte of K/V
// staged, so the tensor cores' rate, not HBM's. What K6 saves is outside the kernel: the
// caller's copy of the whole cache slice beside the block (2 * (lens + Tb) * Hk * D bf16 written
// and read again per layer) and, with k pre-processing, the fp32 k island's passes over the block.
// What the design does about it: K1's CTA and sweep at D = 128 (WgmmaCta in flash_common.cuh:
// two warpgroups x 64 query rows on wgmma, a TMA-fed ring kept full by a producer warp, only
// visible tiles swept; one tensor map per array, encoded on the host per launch). The sweep
// runs twice on one running softmax state, first over the cache tiles below lens[s] (never the
// dead columns up to the capacity), then over the block, each array read in place through its
// own strides; a CTA that sees neither writes zeros without loading Q. The producer warp runs
// on into the block's tiles while the consumers finish the cache's. The k island runs on each
// block-K tile in shared memory after it lands, once per CTA and tile, by all eight consumer
// warps (its rows unrolled, a shared rope row read once): every query tile of 128 rows and every
// head of a group repeats it (T / 128 * G times per block row), the price of keeping the
// processed k out of device memory without a pre-pass.

#include "flash_common.cuh"

namespace {

using namespace flash;
using Cta = WgmmaCta<128>;

template <bool kQPre, bool kKPre>
__global__ void __launch_bounds__(Cta::kThreads, Cta::kMinBlocks)
    flash_cache_block_attention_kernel(
        const bf16* __restrict__ q, const __grid_constant__ CUtensorMap kc,
        const __grid_constant__ CUtensorMap vc, const __grid_constant__ CUtensorMap kb,
        const __grid_constant__ CUtensorMap vb, bf16* __restrict__ out,
        const int* __restrict__ lens, int T, int H, int Hk, int M, int Tb, int block_len,
        int causal, float scale, Preproc qpre, Preproc kpre) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int s = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * Cta::kRows;
  const int hk = h / (H / Hk);
  const int last_row = min(q0 + Cta::kRows, T) - 1;
  // the cache: keys below lens[s], nothing else; the block: keys below block_len, causal within
  // the block when asked
  const Visibility cache{M, min(lens[s], M), 0, 0, 0};
  const Visibility block{Tb, 0, 0, min(block_len, Tb), causal};
  if (plan_tiles(cache, last_row).n == 0 && plan_tiles(block, last_row).n == 0) {
    store_empty<Cta::D>(out, nullptr, s, T, H, h, q0, Cta::kRows, Cta::kThreads);
    return;
  }
  const float sl2 = scale * kLog2e;
  Cta cta(smem, q0, T);
  cta.load_q(q + ((long long)s * T * H + h) * Cta::D, (long long)H * Cta::D);
  cta.sweep<kQPre, false>(cache, last_row, &kc, &vc, hk, qpre, kpre, s, sl2);
  cta.sweep<kQPre, kKPre>(block, last_row, &kb, &vb, hk, qpre, kpre, s, sl2);
  cta.store(out, nullptr, s, H, h);
}

struct Strides {
  long long ss, sh, sm;
};

template <bool kQPre, bool kKPre>
int launch(dim3 grid, cudaStream_t stream, const void* q, const void* kc, const void* vc,
           const void* kb, const void* vb, void* out, const void* lens, int S, int T, int H,
           int Hk, int M, int Tb, int block_len, Strides a, Strides b, Strides c, Strides d,
           int causal, float scale, const Preproc& qpre, const Preproc& kpre) {
  static bool smem_set[64] = {};
  auto* kernel = flash_cache_block_attention_kernel<kQPre, kKPre>;
  const cudaError_t err = allow_smem(kernel, Cta::kSmemBytes, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap maps[4];
  if (!encode_kv_map(&maps[0], kc, S, Hk, M, Cta::D, a.ss, a.sh, a.sm) ||
      !encode_kv_map(&maps[1], vc, S, Hk, M, Cta::D, b.ss, b.sh, b.sm) ||
      !encode_kv_map(&maps[2], kb, S, Hk, Tb, Cta::D, c.ss, c.sh, c.sm) ||
      !encode_kv_map(&maps[3], vb, S, Hk, Tb, Cta::D, d.ss, d.sh, d.sm))
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<grid, Cta::kThreads, Cta::kSmemBytes, stream>>>(
      static_cast<const bf16*>(q), maps[0], maps[1], maps[2], maps[3], static_cast<bf16*>(out),
      static_cast<const int*>(lens), T, H, Hk, M, Tb, block_len, causal, scale, qpre, kpre);
  return static_cast<int>(cudaGetLastError());
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
      H > 65535 || D_ != Cta::D || block_len < 0 || (k_pre && !q_pre))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((T + Cta::kRows - 1) / Cta::kRows, H, S);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Preproc qp = make_preproc(q_w_und, q_w_gen, q_cos, q_sin, q_tab_ss, q_tab_rs, q_end_row, eps);
  const Preproc kp = make_preproc(k_w_und, k_w_gen, k_cos, k_sin, k_tab_ss, k_tab_rs, k_end_row, eps);
  const Strides a{kc_ss, kc_sh, kc_sm}, b{vc_ss, vc_sh, vc_sm}, c{kb_ss, kb_sh, kb_sm},
      d{vb_ss, vb_sh, vb_sm};
  if (k_pre)
    return launch<true, true>(grid, st, q, k_cache, v_cache, k_block, v_block, out, lens, S, T, H,
                              Hk, M, Tb, block_len, a, b, c, d, causal, scale, qp, kp);
  if (q_pre)
    return launch<true, false>(grid, st, q, k_cache, v_cache, k_block, v_block, out, lens, S, T, H,
                               Hk, M, Tb, block_len, a, b, c, d, causal, scale, qp, kp);
  return launch<false, false>(grid, st, q, k_cache, v_cache, k_block, v_block, out, lens, S, T, H,
                              Hk, M, Tb, block_len, a, b, c, d, causal, scale, qp, kp);
}
