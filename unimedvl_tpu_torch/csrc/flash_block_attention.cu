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
// -inf - (-inf) is NaN. The sweep keeps its maxima in natural units, so m + log(l) needs no
// change of base; rows at or past T are not stored.
//
// K1b first turns the raw projected q into the gen-mode q, in fp32, row by row (the MoT qk-norm
// island of qwen2_navit.py:568-583): qn = q * rsqrt(mean(q^2) + eps), times w_und on the text rows
// (i == 0 or i == end_row[s]) and w_gen elsewhere, then RoPE with rotate_half (partner column
// c +- 64, minus sign on the first half), rounded to bf16. This runs once per CTA on the Q tile in
// shared memory, before the fragment loads; the sweep is K1a's. D = 128 only, as on the TPU.
//
// What bounds it on the H100: at the main path's shapes (ViT T = 5120, D = 72; image prefill
// T = 5122 over M = 5632, D = 128; 512 px denoise T = 1026, S = 3) each (tile, head) does
// 4 * 64 * kv * D flops from 2 * kv * D bf16 loads, about 64 flops per byte, so the tensor cores'
// issue rate bounds it, not HBM. The K1b prologue reads 64 * 128 q values and two fp32 table
// rows per tile, a few percent of one tile's sweep.
// What the design does about it: Q K^T and P V run on the tensor cores through mma.sync
// m16n8k16 (bf16 in, fp32 accumulate). One CTA of 4 warps owns 64 query rows of one head; each
// warp owns 16 rows and keeps its Q fragments, S tile and O accumulator in registers. K and V
// tiles of 64 keys are staged in shared memory with 16-byte loads; the G query heads of a KV
// head re-read them through L2. The key sweep stops at the last visible key (capacity grows in
// 512-column buckets, so the unused tail can be long). D = 72 (ViT) pads the QK^T reduction to
// 80 with zero columns in shared memory; P V needs no padding (72 = 9 n-tiles of 8). In the K1b
// prologue each lane holds columns {2l, 2l+1} and their rotate_half partners {2l+64, 2l+65}, so
// the rotation needs no exchange between threads and the row's sum of squares one warp reduction;
// the TPU's pre-signed sin table and lane roll are not needed.
// Later work: wgmma with TMA-fed K/V, a multi-stage cp.async pipeline, and sharing one K/V tile
// across the G heads of a group.
// The device code is in flash_common.cuh, shared with K6 (flash_cache_block_attention.cu).

#include "flash_common.cuh"

namespace {

using namespace flash;

template <int D, bool kPreproc>
__global__ void __launch_bounds__(kThreads)
    flash_block_attention_kernel(const __nv_bfloat16* __restrict__ q,
                                 const __nv_bfloat16* __restrict__ k,
                                 const __nv_bfloat16* __restrict__ v,
                                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                                 const int* __restrict__ lens, const int* __restrict__ block_start,
                                 const int* __restrict__ q_valid_len, int T, int H, int Hk, int M,
                                 long long k_ss, long long k_sh, long long k_sm, long long v_ss,
                                 long long v_sh, long long v_sm, int causal, float scale,
                                 Preproc pre) {
  constexpr int DK = (D + 15) / 16 * 16;  // reduction extent of Q K^T
  constexpr int DP = DK + 8;              // shared row stride: conflict-free fragment loads
  static_assert(D % 8 == 0, "head dim must be a multiple of 8");
  static_assert(!kPreproc || D == 128, "the q pre-processing takes head dim 128");
  __shared__ __align__(16) __nv_bfloat16 s_qk[kBM * DP];  // the Q tile, then each K tile
  __shared__ __align__(16) __nv_bfloat16 s_v[kBN * DP];

  const int s = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBM;
  const int hk = h / (H / Hk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  load_tile<D, DK, DP>(s_qk, q + ((long long)s * T * H + h) * D, (long long)H * D, q0, T);
  __syncthreads();
  if constexpr (kPreproc) {
    preprocess_tile<DP>(s_qk, pre, s, q0, T);
    __syncthreads();
  }
  uint32_t qf[DK / 16][4];
  load_q_fragments<DK, DP>(qf, s_qk);
  __syncthreads();

  const int ln = lens[s], bs = block_start[s], qv = q_valid_len[s];
  const int row_a = q0 + warp * 16 + (lane >> 2), row_b = row_a + 8;
  // Sweep bound: nothing past the context or the (causally reachable part of the) block is visible.
  const int kv_hi = min(max(ln, bs + (causal ? min(qv, q0 + kBM) : qv)), M);

  RowState<D> st;
  st.init();
  sweep_keys<D, DK, DP, false>(st, qf, s_qk, s_v, k + s * k_ss + hk * k_sh, k_sm,
                               v + s * v_ss + hk * v_sh, v_sm, M, kv_hi, ln, bs, qv, causal,
                               scale, row_a, row_b, pre, s);
  store_rows<D>(st, out, lse, s, T, H, h, row_a, row_b);
}

template <int D, bool kPreproc>
void launch(dim3 grid, cudaStream_t stream, const void* q, const void* k, const void* v, void* out,
            void* lse, const void* lens, const void* block_start, const void* q_valid_len, int T,
            int H, int Hk, int M, long long k_ss, long long k_sh, long long k_sm, long long v_ss,
            long long v_sh, long long v_sm, int causal, float scale, const Preproc& pre) {
  flash_block_attention_kernel<D, kPreproc><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), static_cast<const int*>(lens),
      static_cast<const int*>(block_start), static_cast<const int*>(q_valid_len), T, H, Hk, M,
      k_ss, k_sh, k_sm, v_ss, v_sh, v_sm, causal, scale, pre);
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
  const dim3 grid((T + kBM - 1) / kBM, H, S);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Preproc none{};
  switch (D) {
    case 72:
      launch<72, false>(grid, st, q, k, v, out, lse, lens, block_start, q_valid_len, T, H, Hk, M,
                        k_ss, k_sh, k_sm, v_ss, v_sh, v_sm, causal, scale, none);
      break;
    case 128:
      launch<128, false>(grid, st, q, k, v, out, lse, lens, block_start, q_valid_len, T, H, Hk, M,
                         k_ss, k_sh, k_sm, v_ss, v_sh, v_sm, causal, scale, none);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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
  const dim3 grid((T + kBM - 1) / kBM, H, S);
  const Preproc pre{static_cast<const float*>(w_und), static_cast<const float*>(w_gen),
                    static_cast<const float*>(cos),   static_cast<const float*>(sin),
                    tab_ss,                           tab_rs,
                    static_cast<const int*>(end_row), eps};
  launch<128, true>(grid, static_cast<cudaStream_t>(stream), q, k, v, out, lse, lens, block_start,
                    q_valid_len, T, H, Hk, M, k_ss, k_sh, k_sm, v_ss, v_sh, v_sm, causal, scale,
                    pre);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* unimedvl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
