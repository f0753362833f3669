// K1a, K1b and K1c: flash attention of a query block over cache plus block, bf16, for sm_90a.
//
// Replaces the Pallas TPU kernel unimedvl_tpu/ops/flash_attention.py::flash_block_attention
// (kernel body `_kernel`): K1a is the call without q pre-processing, K1b the call with it
// (`q_preproc`, `_fused_q_preproc`), K1c either of them with `return_lse`: the same launch given
// a pointer for the log-sum-exp output.
//
// What it computes, for stream s, query row i and query head h (KV head hk = h / (H / Hk)):
//   out[s, i, h] = sum_j softmax_j(q[s, i, h] . k[s, j, hk] / sqrt(D)) v[s, j, hk]
// over the keys j < M that are visible: j < lens[s], or
//   block_start[s] <= j < block_start[s] + q_valid_len[s]   (and, when causal, j - block_start[s] <= i).
// Softmax is online and in fp32; out = acc / max(l, 1e-30), as on the TPU. Rows that see no key
// come out as 0; rows past q_valid_len are garbage by contract and are not compared.
//
// K1c also writes lse[s, i, h] = log sum_j exp(q . k / sqrt(D)) over the visible keys (natural
// log of the scaled logits, fp32, [S, T, H]), with which a caller merges partial attentions over
// disjoint key sets. A row that sees no key (an empty cache partial: lens[s] == 0 and no block)
// gets the finite kNegInf (float32 min), never -inf: the merge subtracts the largest lse, and
// -inf - (-inf) is NaN. The sweep keeps its maxima in log2 units; lse = (m + log2 l) ln 2.
//
// K1b first turns the raw projected q into the gen-mode q, in fp32, row by row (the MoT qk-norm
// island of qwen2_navit.py:568-583): qn = q * rsqrt(mean(q^2) + eps), times w_und on the text rows
// (i == 0 or i == end_row[s]) and w_gen elsewhere, then RoPE with rotate_half (partner column
// c +- 64, minus sign on the first half), rounded to bf16. This runs once per CTA on the Q tile in
// shared memory, while the first K/V tiles are in flight; the sweep is K1a's. D = 128 only, as on
// the TPU. Each lane holds columns {2l, 2l+1} and their rotate_half partners {2l+64, 2l+65}, so
// the rotation needs no exchange between threads; the TPU's pre-signed sin table and lane roll
// are not needed.
//
// What bounds it on the H100: at the main path's shapes (ViT T = 5120, D = 72; image prefill
// T = 5122 over M = 5632, D = 128; 512 px denoise T = 1026, S = 3) each (query tile, head) does
// 4 * rows * keys * D flops for 2 * keys * D bf16 loads, 64-128 flops per byte staged, so the
// tensor cores bound it, not HBM: K1a's image prefill is 0.36 TFLOP, 0.35 ms at the bf16 peak.
// The tensor cores reach that rate only through wgmma, whose operands come from shared memory
// in its swizzled layout; the TPU kernel's whole-block VMEM tiles have no counterpart.
// What the design does about it (device code in flash_common.cuh, shared with K6):
// - WgmmaCta<D>: two warpgroups x 64 query rows per CTA on wgmma (Q K^T from shared memory,
//   P V with P in registers). D = 72 (ViT) keeps D = 128's swizzled tiles: the Q K^T reduction
//   padded to 80 (5 k-steps, columns 72-79 zero) and P V as an n64 product over V's first half
//   plus an n8 one over the first 8 columns of its second. mma.sync with ldmatrix operands
//   measured slower at the ViT shape on an H100 (0.96 ms against 0.93): four warps each re-read
//   whole K/V tiles through ldmatrix, so shared-memory bandwidth bounds it.
// - K and V tiles of 64 keys come through a ring of four stages in dynamic shared memory,
//   loaded by the TMA unit from tensor maps encoded on the host per launch (any strides: a
//   head-major cache slice or a transposed [S, M, Hk, D] view). A producer warp keeps the loads
//   ahead, gated by per-stage mbarriers, so no barrier spans the CTA per tile and the two
//   consumer warpgroups drift apart. Per-thread cp.async copies measured at about 20 bytes a
//   cycle per SM on an H100 and stalled the issuing warps 1600 of a 4000-cycle tile. Rows past
//   the array and columns past D arrive as zeros; key rows inside the array that no query row
//   of the CTA sees are zeroed in shared memory (straddling tiles only), so NaN in masked rows
//   never reaches P V.
// - The sweep visits only the tiles that hold a visible key for some row of the CTA: [0, lens)
//   and the (causally reachable part of the) block, computed on the card from lens, block_start,
//   q_valid_len and causal. The dead gap of the denoise step (cache capacity in 512-column
//   buckets beyond lens) and the unused tail are never loaded; a CTA with no visible key writes
//   zeros and the lse minimum before it loads Q (the text-CFG stream's empty cache partial).
//   The mask runs only on tiles that straddle a boundary.
// - The G = 7 query heads of a KV head still read the same K/V tiles, each through L2; one CTA per
//   (query tile, head) keeps every SM busy at T 5122 (1148 CTAs) and T 1026 (756).

#include "flash_common.cuh"

namespace {

using namespace flash;

template <class Cta, bool kPreproc>
__global__ void __launch_bounds__(Cta::kThreads, Cta::kMinBlocks)
    flash_block_attention_kernel(const bf16* __restrict__ q, const __grid_constant__ CUtensorMap kmap,
                                 const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ out,
                                 float* __restrict__ lse, const int* __restrict__ lens,
                                 const int* __restrict__ block_start,
                                 const int* __restrict__ q_valid_len, int T, int H, int Hk, int M,
                                 int causal, float scale, Preproc pre) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int s = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * Cta::kRows;
  const int hk = h / (H / Hk);
  const Visibility vis{M, lens[s], block_start[s], q_valid_len[s], causal};
  const int last_row = min(q0 + Cta::kRows, T) - 1;
  if (plan_tiles(vis, last_row).n == 0) {  // no visible key: zeros without loading Q
    store_empty<Cta::D>(out, lse, s, T, H, h, q0, Cta::kRows, Cta::kThreads);
    return;
  }
  Cta cta(smem, q0, T);
  cta.load_q(q + ((long long)s * T * H + h) * Cta::D, (long long)H * Cta::D);
  cta.template sweep<kPreproc, false>(vis, last_row, &kmap, &vmap, hk, pre, pre, s,
                                      scale * kLog2e);
  cta.store(out, lse, s, H, h);
}

template <class Cta, bool kPreproc>
int launch(cudaStream_t stream, const void* q, const void* k, const void* v, void* out, void* lse,
           const void* lens, const void* block_start, const void* q_valid_len, int S, int T, int H,
           int Hk, int M, long long k_ss, long long k_sh, long long k_sm, long long v_ss,
           long long v_sh, long long v_sm, int causal, float scale, const Preproc& pre) {
  static bool smem_set[64] = {};
  auto* kernel = flash_block_attention_kernel<Cta, kPreproc>;
  const cudaError_t err = allow_smem(kernel, Cta::kSmemBytes, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap kmap, vmap;
  if (!encode_kv_map(&kmap, k, S, Hk, M, Cta::D, k_ss, k_sh, k_sm) ||
      !encode_kv_map(&vmap, v, S, Hk, M, Cta::D, v_ss, v_sh, v_sm))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((T + Cta::kRows - 1) / Cta::kRows, H, S);
  kernel<<<grid, Cta::kThreads, Cta::kSmemBytes, stream>>>(
      static_cast<const bf16*>(q), kmap, vmap, static_cast<bf16*>(out), static_cast<float*>(lse),
      static_cast<const int*>(lens), static_cast<const int*>(block_start),
      static_cast<const int*>(q_valid_len), T, H, Hk, M, causal, scale, pre);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int S, int T, int H, int Hk, int M) {
  return S <= 0 || T <= 0 || M <= 0 || Hk <= 0 || H % Hk != 0 || S > 65535 || H > 65535;
}

}  // namespace

// K1a; K1c when `lse` is not null. q, out: contiguous [S, T, H, D]; lse: null, or fp32 contiguous
// [S, T, H]; k, v: [S, *, *, D] with the given (stream, head, key) strides in elements and D
// contiguous; lens, block_start, q_valid_len: int32 [S]. Returns a cudaError_t.
extern "C" int unimedvl_flash_block_attention_bf16(
    const void* q, const void* k, const void* v, void* out, void* lse, const void* lens,
    const void* block_start, const void* q_valid_len, int S, int T, int H, int Hk, int D, int M,
    long long k_ss, long long k_sh, long long k_sm, long long v_ss, long long v_sh,
    long long v_sm, int causal, float scale, void* stream) {
  if (bad_shape(S, T, H, Hk, M)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Preproc none{};
  switch (D) {
    case 72:
      return launch<WgmmaCta<72>, false>(st, q, k, v, out, lse, lens, block_start, q_valid_len,
                                         S, T, H, Hk, M, k_ss, k_sh, k_sm, v_ss, v_sh, v_sm,
                                         causal, scale, none);
    case 128:
      return launch<WgmmaCta<128>, false>(st, q, k, v, out, lse, lens, block_start, q_valid_len,
                                          S, T, H, Hk, M, k_ss, k_sh, k_sm, v_ss, v_sh, v_sm,
                                          causal, scale, none);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K1b; K1c when `lse` is not null: K1a's arguments (q raw, D = 128) plus the pre-processing
// operands: w_und, w_gen fp32 [128]; cos, sin fp32 with stream stride tab_ss and row stride
// tab_rs in elements (rows contiguous, 8-byte aligned); end_row int32 [S]; eps.
extern "C" int unimedvl_flash_block_attention_qpre_bf16(
    const void* q, const void* k, const void* v, void* out, void* lse, const void* lens,
    const void* block_start, const void* q_valid_len, int S, int T, int H, int Hk, int D, int M,
    long long k_ss, long long k_sh, long long k_sm, long long v_ss, long long v_sh,
    long long v_sm, int causal, float scale, const void* w_und, const void* w_gen,
    const void* cos, const void* sin, long long tab_ss, long long tab_rs, const void* end_row,
    float eps, void* stream) {
  if (bad_shape(S, T, H, Hk, M) || D != 128) return static_cast<int>(cudaErrorInvalidValue);
  const Preproc pre{static_cast<const float*>(w_und), static_cast<const float*>(w_gen),
                    static_cast<const float*>(cos),   static_cast<const float*>(sin),
                    tab_ss,                           tab_rs,
                    static_cast<const int*>(end_row), eps};
  return launch<WgmmaCta<128>, true>(static_cast<cudaStream_t>(stream), q, k, v, out, lse, lens,
                                block_start, q_valid_len, S, T, H, Hk, M, k_ss, k_sh, k_sm, v_ss,
                                v_sh, v_sm, causal, scale, pre);
}

extern "C" const char* unimedvl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
