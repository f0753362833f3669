// Device code shared by the flash attention kernels, bf16, for sm_90a: those of the inference
// paths, flash_block_attention.cu (K1a, K1b, K1c) and flash_cache_block_attention.cu (K6), and
// the training attention's, packed_train_attention.cu (K5: primitives and the online softmax).
// w4_matmul.cu (K4) takes its primitives (mbarriers, wgmma fences, tensor maps) too.
//
// A kernel runs one CTA per (tile of query rows, query head, stream) and sweeps the key tiles
// of one key array (K1) or of two arrays in turn on one running softmax state (K6: the cache,
// then the block).
//
// WgmmaCta<D>, head dim 128 (the LLM's prefills, every denoise step, the SP partials, K6) or 72
// (the ViT): two consumer warpgroups of 64 query rows each (128 rows per CTA) and one producer
// warp. Q K^T is a wgmma m64n64k16 with both operands in shared memory (k-steps of 16 dims; at D
// 72 five, columns 72-79 zero), P V a wgmma with P in registers (the S accumulator's layout is
// the A operand's) and V in shared memory as an MN-major operand: m64n128k16 at D 128,
// m64n64k16 and m64n8k16 at D 72.
// Q, K and V tiles are stored as wgmma reads them: two 64-column halves of 128-byte rows, each
// 16-byte chunk c of row r at chunk c ^ (r % 8) (the 128-byte swizzle), every tile 1024-byte
// aligned. Each warpgroup waits for its own products; the two warpgroups share the SM's tensor
// cores, so one's softmax can run under the other's products.
//
// K and V come through a ring of four stages in dynamic shared memory, loaded by the TMA unit
// from tensor maps (`encode_kv_map`, built on the host per launch, any strides) as 64 x 64 boxes
// in the swizzled layout. The producer warp issues a stage's loads once all eight consumer warps
// have released it (an `empty` mbarrier per stage); a consumer waits for its bytes (`full`).
// Nothing synchronises the whole CTA per tile. Rows past the array and columns past D arrive as
// zeros; key rows inside the array that no query row of the CTA can see are zeroed in shared
// memory (straddling tiles only), so garbage or NaN in masked rows never reaches a product.
//
// Only visible tiles are swept (`plan_tiles`): the context tiles [0, lens) and the tiles of the
// (causally reachable part of the) block; every tile wholly inside the gap between them or past
// the reachable end is neither loaded nor multiplied. A CTA whose plan is empty writes zero rows
// (and the lse minimum) without loading Q. The per-element mask runs only on the tiles that
// straddle a boundary of the visible set (`Visibility::tile_full`), and a warpgroup skips a
// causal tile that none of its rows reaches. Logits are kept in log2 units (scale times log2 e)
// so that each weight is one fma and one ex2; the mask, where it runs, is branch-free (a branch
// per element cost more than the rest of the softmax).
//
// `preprocess_rows` is the MoT qk-norm + RoPE island on rows of a tile in shared memory, in
// the swizzled layout: the raw Q tile (K1b, K1c, K6) and raw block-K tiles (K6).

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -3.402823466e38f;  // finfo(float32).min, the TPU kernel's mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kBN = 64;  // keys per tile

// ---------------------------------------------------------------------------------------------
// primitives
// ---------------------------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !pred (nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Writes of the generic proxy (cp.async, st.shared) become visible to wgmma's reads (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// mbarriers in shared memory: init (arrivals per phase), an arrival, the arrival of the thread
// that issues a stage's copies with the bytes they will bring, and a wait on a phase's parity.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// The wait gives up with a trap (an error at the next synchronisation, not a hung card) after
// about 2^26 polls, far past any tile's load.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (int polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (polls > (1 << 26)) __trap();
  }
}

// One box of a 4-d tensor map (coordinates innermost first) -> shared memory, by the TMA unit;
// completion is counted on `bar`. Elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, "
      "%3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// Two fp32 values as one bf16x2 register; `lo` takes the lower column index.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// wgmma: fence before the first product that reads registers written since, commit the issued
// products as a group, wait until at most N groups are in flight.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of accumulator registers across a wgmma
// fence, commit or wait (the asm statements do not name the registers).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start address, leading and
// stride byte offsets (16-byte units), layout type 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

#define FLASH_F4(a, i) "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3])
#define FLASH_F16(a, i) FLASH_F4(a, i), FLASH_F4(a, i + 4), FLASH_F4(a, i + 8), FLASH_F4(a, i + 12)

// d[64 x 64] += A[64 x 16] B[16 x 64], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_64x64_ss(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : FLASH_F16(d, 0), FLASH_F16(d, 16)
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 128] += A[64 x 16] B[16 x 128], A in registers (the m16n8k16 A fragment of each warp's
// 16 rows), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_64x128_rs(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : FLASH_F16(d, 0), FLASH_F16(d, 16), FLASH_F16(d, 32), FLASH_F16(d, 48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[off .. off + 31] (64 x 64) += A[64 x 16] B[16 x 64], A in registers, B MN-major in shared
// memory.
template <int kOff, int N>
__device__ __forceinline__ void wgmma_64x64_rs(float (&d)[N], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FLASH_F16(d, kOff), FLASH_F16(d, kOff + 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[off .. off + 3] (64 x 8) += A[64 x 16] B[16 x 8], as above.
template <int kOff, int N>
__device__ __forceinline__ void wgmma_64x8_rs(float (&d)[N], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 1;\n}\n"
      : FLASH_F4(d, kOff)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef FLASH_F16
#undef FLASH_F4

// ---------------------------------------------------------------------------------------------
// visibility and the plan of a sweep
// ---------------------------------------------------------------------------------------------

// The visibility rule of one key array of n_keys rows: key j is visible to query row i iff
// j < ln, or bs <= j < bs + qv and (not causal or j - bs <= i).
struct Visibility {
  int n_keys, ln, bs, qv, causal;

  __device__ __forceinline__ bool visible(int j, int i) const {  // branch-free
    const int off = j - bs;
    return (j < n_keys) & ((j < ln) | ((off >= 0) & (off < qv) & ((causal == 0) | (off <= i))));
  }
  // the end of the block keys that rows up to `row` see
  __device__ __forceinline__ int block_end(int row) const {
    return bs + (causal ? min(qv, row + 1) : qv);
  }
  // key j is visible to some row up to `last_row` (every other key row of a swept tile is
  // zeroed in shared memory)
  __device__ __forceinline__ bool reachable(int j, int last_row) const {
    return j < n_keys && (j < ln || (j >= bs && j < block_end(last_row)));
  }
  // no row up to `last_row` sees any key at or past j0: a warpgroup skips the tile
  __device__ __forceinline__ bool dead_from(int j0, int last_row) const {
    return j0 >= ln && j0 >= block_end(last_row);
  }
  // every key of the tile at j0 is visible to every row from first_row on: no mask needed
  __device__ __forceinline__ bool tile_full(int j0, int first_row) const {
    const int j1 = j0 + kBN;
    return j1 <= n_keys && (j1 <= ln || (j1 <= block_end(first_row) && (j0 >= bs || bs <= ln)));
  }
};

// The key tiles a CTA sweeps, in order: the context tiles [0, n_ctx), then n - n_ctx tiles of
// the block from b_lo. Tiles wholly inside the gap [lens, block_start) or past the end of what
// the CTA's last row reaches are not in the plan.
struct TilePlan {
  int n_ctx, b_lo, n;
  __device__ __forceinline__ int key0(int i) const {
    return (i < n_ctx ? i : b_lo + (i - n_ctx)) * kBN;
  }
};

__device__ __forceinline__ TilePlan plan_tiles(const Visibility& vis, int last_row) {
  TilePlan p;
  const int ln = min(vis.ln, vis.n_keys);
  p.n_ctx = ln > 0 ? (ln + kBN - 1) / kBN : 0;
  const int lo = max(vis.bs, 0), hi = min(vis.block_end(last_row), vis.n_keys);
  p.b_lo = max(lo / kBN, p.n_ctx);
  const int b_hi = hi > lo ? (hi + kBN - 1) / kBN : 0;
  p.n = p.n_ctx + max(b_hi - p.b_lo, 0);
  return p;
}

// ---------------------------------------------------------------------------------------------
// the qk-norm + RoPE island
// ---------------------------------------------------------------------------------------------

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

// Element offset of (r, c) in a 64-row, 128-column tile stored for wgmma: two 64-column halves
// of [64][64], 16-byte chunk k of row r at chunk k ^ (r % 8).
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 6) * (kBN * 64) + r * 64 + ((((c >> 3) & 7) ^ (r & 7)) << 3) + (c & 7);
}

// One thread's operands of the island, read from device memory once per sweep: the norm
// weights of its four columns, the end row, and the rope row when the whole block shares one
// (tab_rs == 0; otherwise each row reads its own).
struct Island {
  float2 wu_lo, wu_hi, wg_lo, wg_hi, cs_lo, cs_hi, sn_lo, sn_hi;
  const float* cos0;
  const float* sin0;
  long long tab_rs;
  int er;
  float eps;

  Island() = default;
  __device__ __forceinline__ Island(const Preproc& pre, int s) {
    const int c = 2 * (threadIdx.x & 31);
    er = pre.end_row[s];
    eps = pre.eps;
    tab_rs = pre.tab_rs;
    wu_lo = *reinterpret_cast<const float2*>(pre.w_und + c);
    wu_hi = *reinterpret_cast<const float2*>(pre.w_und + c + 64);
    wg_lo = *reinterpret_cast<const float2*>(pre.w_gen + c);
    wg_hi = *reinterpret_cast<const float2*>(pre.w_gen + c + 64);
    cos0 = pre.cos + s * pre.tab_ss + c;
    sin0 = pre.sin + s * pre.tab_ss + c;
    cs_lo = *reinterpret_cast<const float2*>(cos0);
    cs_hi = *reinterpret_cast<const float2*>(cos0 + 64);
    sn_lo = *reinterpret_cast<const float2*>(sin0);
    sn_hi = *reinterpret_cast<const float2*>(sin0 + 64);
  }
};

// Rows of a block of n_rows, raw, in a swizzled tile in shared memory -> their gen-mode form (MoT
// RMSNorm + RoPE in fp32, rounded to bf16), in place: qn = x * rsqrt(mean(x^2) + eps), times
// w_und on the text rows (row == 0 or row == end_row[s]) and w_gen elsewhere, then RoPE with
// rotate_half. Warp `warp` owns tile rows [warp * kRowsPerWarp, +kRowsPerWarp), counted in the
// block from r0; lane l owns columns 2l, 2l + 1, 2l + 64, 2l + 65, so the rotation needs no
// exchange between threads and the row's sum of squares one warp reduction. The rows are
// unrolled so that their reductions overlap. D = 128.
template <int kRowsPerWarp>
__device__ __forceinline__ void preprocess_rows(bf16* tile, const Island& is, int r0, int n_rows,
                                                int warp) {
  const int c = 2 * (threadIdx.x & 31);
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr, row = r0 + r;
    if (row < n_rows) {  // warp-uniform; rows past the block stay zero
      __nv_bfloat162* p_lo = reinterpret_cast<__nv_bfloat162*>(tile + swz(r, c));
      __nv_bfloat162* p_hi = reinterpret_cast<__nv_bfloat162*>(tile + swz(r, c + 64));
      const float2 lo = __bfloat1622float2(*p_lo), hi = __bfloat1622float2(*p_hi);
      float2 c_lo = is.cs_lo, c_hi = is.cs_hi, s_lo = is.sn_lo, s_hi = is.sn_hi;
      if (is.tab_rs != 0) {
        const long long off = (long long)row * is.tab_rs;
        c_lo = *reinterpret_cast<const float2*>(is.cos0 + off);
        c_hi = *reinterpret_cast<const float2*>(is.cos0 + off + 64);
        s_lo = *reinterpret_cast<const float2*>(is.sin0 + off);
        s_hi = *reinterpret_cast<const float2*>(is.sin0 + off + 64);
      }
      float ss = lo.x * lo.x + lo.y * lo.y + hi.x * hi.x + hi.y * hi.y;
#pragma unroll
      for (int w = 16; w >= 1; w >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, w);
      const float inv = rsqrtf(ss * (1.f / 128.f) + is.eps);
      const bool text = row == 0 || row == is.er;
      const float2 w_lo = text ? is.wu_lo : is.wg_lo, w_hi = text ? is.wu_hi : is.wg_hi;
      const float a0 = __fmul_rn(lo.x * inv, w_lo.x), a1 = __fmul_rn(lo.y * inv, w_lo.y);
      const float b0 = __fmul_rn(hi.x * inv, w_hi.x), b1 = __fmul_rn(hi.y * inv, w_hi.y);
      // rotate_half(x)[c] = -x[c + 64] for c < 64, x[c - 64] above; each product and the sum
      // rounded on its own (no fma), as the plain version's separate element-wise ops round them
      *p_lo = __floats2bfloat162_rn(__fadd_rn(__fmul_rn(a0, c_lo.x), __fmul_rn(-b0, s_lo.x)),
                                    __fadd_rn(__fmul_rn(a1, c_lo.y), __fmul_rn(-b1, s_lo.y)));
      *p_hi = __floats2bfloat162_rn(__fadd_rn(__fmul_rn(b0, c_hi.x), __fmul_rn(a0, s_hi.x)),
                                    __fadd_rn(__fmul_rn(b1, c_hi.y), __fmul_rn(a1, s_hi.y)));
    }
  }
}

// ---------------------------------------------------------------------------------------------
// the online softmax of one 64-key tile, shared by both designs
// ---------------------------------------------------------------------------------------------

// The two query rows (g and g + 8 of a warp's 16) a thread holds: row maxima in log2 units
// (uniform over the 4 threads of a row) and the row sums of this thread's columns only.
struct RowStats {
  float m_a, m_b, l_a, l_b;
  __device__ __forceinline__ void init() {
    m_a = m_b = kNegInf;
    l_a = l_b = 0.f;
  }
};

// sc[4 nt + e]: this thread's logits of a 16-row x 64-key tile in the m16n8 accumulator layout
// (e < 2: row_a, else row_b; column nt * 8 + 2t + (e & 1)), unscaled -> weights
// p = 2^(x * sl2 - m_new) (one fma and one ex2 each; sl2 > 0, so the maximum is taken on the raw
// logits and scaled once), masked keys selected to 0; updates the maxima and sums; returns the
// factors (al_a, al_b) by which the output accumulator must be scaled: exactly 1 where the row
// maximum did not move. `full` (tile-uniform) skips the mask; inside it, the visibility test and
// the selections are branch-free. `softmax_update` is the part after the mask, for a caller that
// has set every masked logit to kNegInf itself (`full` false) or has none (`full` true).
__device__ __forceinline__ float2 softmax_update(float (&sc)[kBN / 2], RowStats& st, bool full,
                                                 float sl2) {
  float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
  for (int nt = 0; nt < kBN / 8; ++nt) {
    mx_a = fmaxf(mx_a, fmaxf(sc[4 * nt], sc[4 * nt + 1]));
    mx_b = fmaxf(mx_b, fmaxf(sc[4 * nt + 2], sc[4 * nt + 3]));
  }
#pragma unroll
  for (int w = 1; w <= 2; w <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, w));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, w));
  }
  const float mn_a = mx_a > kNegInf ? fmaxf(st.m_a, mx_a * sl2) : st.m_a;
  const float mn_b = mx_b > kNegInf ? fmaxf(st.m_b, mx_b * sl2) : st.m_b;
  const float2 al = make_float2(mn_a != st.m_a ? ex2(st.m_a - mn_a) : 1.f,
                                mn_b != st.m_b ? ex2(st.m_b - mn_b) : 1.f);
  st.m_a = mn_a;
  st.m_b = mn_b;
  // a masked key (logit == kNegInf, which no visible logit reaches) weighs 0 by selection
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = sc[4 * nt + e];
      float p = ex2(fmaf(x, sl2, -(e < 2 ? mn_a : mn_b)));
      if (!full) p = x > kNegInf ? p : 0.f;
      sc[4 * nt + e] = p;
      if (e < 2)
        sum_a += p;
      else
        sum_b += p;
    }
  }
  st.l_a = st.l_a * al.x + sum_a;
  st.l_b = st.l_b * al.y + sum_b;
  return al;
}

__device__ __forceinline__ float2 softmax_tile(float (&sc)[kBN / 2], RowStats& st,
                                               const Visibility& vis, bool full, int j0,
                                               int row_a, int row_b, float sl2) {
  const int t = threadIdx.x & 3;
  if (!full) {
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[4 * nt + e] = vis.visible(j0 + nt * 8 + 2 * t + (e & 1), e < 2 ? row_a : row_b)
                             ? sc[4 * nt + e]
                             : kNegInf;
  }
  return softmax_update(sc, st, full, sl2);
}

// out[s, row, h, 2t + 8 * dt ...] = o / max(l, 1e-30) for the rows below T (trailing rows are
// not stored), and, when `lse` is given, lse[s, row, h] = the natural-log sum-exp of the scaled
// logits, or kNegInf (finite) for a row that saw no key, whose output is 0. `o` holds kDT
// 8-column blocks of the two rows, 4 values each (o[4 dt + e], the m16n8 accumulator layout).
template <int D, int kDT>
__device__ __forceinline__ void store_rows(const float (&o)[4 * kDT], RowStats st, bf16* out,
                                           float* lse, int s, int T, int H, int h, int row_a,
                                           int row_b) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int w = 1; w <= 2; w <<= 1) {
    st.l_a += __shfl_xor_sync(0xffffffffu, st.l_a, w);
    st.l_b += __shfl_xor_sync(0xffffffffu, st.l_b, w);
  }
  const float inv_a = 1.f / fmaxf(st.l_a, 1e-30f), inv_b = 1.f / fmaxf(st.l_b, 1e-30f);
  if (row_a < T) {
    bf16* dst = out + (((long long)s * T + row_a) * H + h) * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
      *reinterpret_cast<uint32_t*>(dst + dt * 8) = pack_bf16x2(o[4 * dt] * inv_a, o[4 * dt + 1] * inv_a);
    if (lse != nullptr && t == 0)
      lse[((long long)s * T + row_a) * H + h] =
          st.l_a > 0.f ? (st.m_a + log2f(st.l_a)) * kLn2 : kNegInf;
  }
  if (row_b < T) {
    bf16* dst = out + (((long long)s * T + row_b) * H + h) * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
      *reinterpret_cast<uint32_t*>(dst + dt * 8) = pack_bf16x2(o[4 * dt + 2] * inv_b, o[4 * dt + 3] * inv_b);
    if (lse != nullptr && t == 0)
      lse[((long long)s * T + row_b) * H + h] =
          st.l_b > 0.f ? (st.m_b + log2f(st.l_b)) * kLn2 : kNegInf;
  }
}

// A CTA that sees no key: zero output rows q0 .. q0 + rows - 1 below T and the lse minimum.
template <int D>
__device__ __forceinline__ void store_empty(bf16* out, float* lse, int s, int T, int H, int h,
                                            int q0, int rows, int n_threads) {
  constexpr int kVecs = D / 8;
  for (int idx = threadIdx.x; idx < rows * kVecs; idx += n_threads) {
    const int r = idx / kVecs, c = idx - r * kVecs;
    if (q0 + r < T)
      *reinterpret_cast<uint4*>(out + (((long long)s * T + q0 + r) * H + h) * D + c * 8) =
          make_uint4(0u, 0u, 0u, 0u);
  }
  if (lse != nullptr)
    for (int r = threadIdx.x; r < rows; r += n_threads)
      if (q0 + r < T) lse[((long long)s * T + q0 + r) * H + h] = kNegInf;
}

// ---------------------------------------------------------------------------------------------
// the two CTA designs
// ---------------------------------------------------------------------------------------------


// Head dim 128 or 72 on wgmma: two consumer warpgroups x 64 query rows and one producer warp.
// Every tile is stored as two swizzled 64-column halves; at D 72, Q K^T takes 5 k-steps
// (columns 72-79 are zero) and P V two products, over V's first half (n 64) and the first 8
// columns of its second (n 8). The producer warp keeps the TMA loads of the K/V ring ahead of
// the consumers: a stage is refilled once all eight consumer warps have released it (`empty`),
// and a consumer waits for a stage's bytes (`full`). No barrier spans the CTA per tile, so the
// two warpgroups drift apart and one's softmax runs under the other's products.
template <int kD>
struct WgmmaCta {
  static_assert(kD == 128 || kD == 72, "head dim 128 or 72");
  static constexpr int D = kD, kRows = 128, kConsumers = 256, kThreads = kConsumers + 32;
  static constexpr int kMinBlocks = 1, kStages = 4;
  static constexpr int kTile = kBN * 128;  // elements of one 64-row tile (two halves)
  // Q tiles, the K/V ring, its mbarriers, and slack to align the tiles to 1024 bytes
  static constexpr int kSmemBytes = (2 + 2 * kStages) * kTile * 2 + 16 * kStages + 1024;
  static constexpr int kKSteps = (D + 15) / 16;  // k-steps of Q K^T
  static constexpr int kVecs = D / 8;            // 16-byte chunks of a row, and output blocks

  bf16* s_q;         // [2 warpgroups][tile]
  bf16* s_kv;        // [kStages][K tile, V tile]
  uint64_t* full;    // [kStages] a stage's tiles have landed
  uint64_t* empty;   // [kStages] the consumer warps are done with a stage
  uint32_t n_loads;  // tiles through the ring so far: stage n % kStages, phase n / kStages
  int q0, T, wg, warp, lane, row_a, row_b;
  bool producer, q_pending;
  float o[4 * kVecs];  // this warpgroup's 64 x D output accumulator: blocks of 8 columns x 4
  RowStats st;

  __device__ __forceinline__ WgmmaCta(uint8_t* smem, int q0_, int T_) : q0(q0_), T(T_) {
    const uint32_t base = smem_u32(smem);
    bf16* aligned = reinterpret_cast<bf16*>(smem + (((base + 1023u) & ~1023u) - base));
    s_q = aligned;
    s_kv = aligned + 2 * kTile;
    full = reinterpret_cast<uint64_t*>(s_kv + 2 * kStages * kTile);
    empty = full + kStages;
    n_loads = 0;
    producer = threadIdx.x >= kConsumers;
    wg = threadIdx.x >> 7;
    warp = (threadIdx.x >> 5) & 3;
    lane = threadIdx.x & 31;
    row_a = q0 + wg * 64 + warp * 16 + (lane >> 2);
    row_b = row_a + 8;
    q_pending = false;
#pragma unroll
    for (int i = 0; i < 4 * kVecs; ++i) o[i] = 0.f;
    st.init();
    if (threadIdx.x == 0) {
      for (int i = 0; i < kStages; ++i) {
        mbar_init(full + i, 1);
        mbar_init(empty + i, kConsumers / 32);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    if constexpr (D % 16 != 0) {  // columns D .. D + 7 of the Q tiles, never copied
      for (int r = threadIdx.x; r < 2 * kBN; r += kThreads)
        *reinterpret_cast<uint4*>(s_q + (r / kBN) * kTile + swz(r % kBN, D)) =
            make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();  // the barriers are initialised before any role uses them
  }

  // The consumer warpgroups' own barrier (the producer warp never waits on it).
  __device__ __forceinline__ void consumers_sync() const {
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  }

  // Query rows q0 .. q0 + 127 of a [*, D] bf16 matrix with row stride `stride` -> the two Q
  // tiles, with cp.async by the consumers (once per CTA); rows at or past T are zero-filled.
  __device__ __forceinline__ void load_q(const bf16* q, long long stride) {
    if (producer) return;
    for (int idx = threadIdx.x; idx < kRows * kVecs; idx += kConsumers) {
      const int r = idx / kVecs, c = idx - r * kVecs;
      const bool ok = q0 + r < T;
      cp_async16(s_q + (r / kBN) * kTile + swz(r % kBN, c * 8),
                 ok ? q + (long long)(q0 + r) * stride + c * 8 : q, ok);
    }
    cp_async_commit();
    q_pending = true;
  }

  template <bool kQPre>
  __device__ __forceinline__ void prepare_q(const Preproc& qpre, int s) {
    cp_async_wait<0>();
    fence_proxy_async();
    consumers_sync();
    if constexpr (kQPre) {
      preprocess_rows<16>(s_q + wg * kTile, Island(qpre, s), q0 + wg * 64, T, warp);
      fence_proxy_async();
      consumers_sync();
    }
    q_pending = false;
  }

  __device__ __forceinline__ void step(const bf16* sk, const bf16* sv, int j0,
                                       const Visibility& vis, float sl2) {
    const int first = q0 + wg * 64;
    if (first >= T || vis.dead_from(j0, first + 63)) return;  // warpgroup-uniform
    float sacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
    fence_regs(sacc);
    wgmma_fence();
    const uint64_t dq = wgmma_desc(s_q + wg * kTile, 16, 1024);
    const uint64_t dk = wgmma_desc(sk, 16, 1024);
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {  // 16 dims a step: 32 bytes in a half, then the other
      const uint64_t off = (((kk >> 2) * (kBN * 64) + (kk & 3) * 16) * 2) >> 4;
      wgmma_64x64_ss(sacc, dq + off, dk + off);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);

    const float2 al =
        softmax_tile(sacc, st, vis, vis.tile_full(j0, first), j0, row_a, row_b, sl2);
    if (__any_sync(0xffffffffu, al.x != 1.f || al.y != 1.f)) {  // a row maximum of the warp moved
#pragma unroll
      for (int nb = 0; nb < kVecs; ++nb) {
        o[4 * nb + 0] *= al.x;
        o[4 * nb + 1] *= al.x;
        o[4 * nb + 2] *= al.y;
        o[4 * nb + 3] *= al.y;
      }
    }
    // P as the A operand: keys 16ks .. 16ks + 15 are the S blocks 2ks and 2ks + 1
    uint32_t pa[kBN / 16][4];
#pragma unroll
    for (int ks = 0; ks < kBN / 16; ++ks) {
      pa[ks][0] = pack_bf16x2(sacc[8 * ks + 0], sacc[8 * ks + 1]);
      pa[ks][1] = pack_bf16x2(sacc[8 * ks + 2], sacc[8 * ks + 3]);
      pa[ks][2] = pack_bf16x2(sacc[8 * ks + 4], sacc[8 * ks + 5]);
      pa[ks][3] = pack_bf16x2(sacc[8 * ks + 6], sacc[8 * ks + 7]);
    }
    fence_regs(o);
    wgmma_fence();
    // V MN-major: the two 64-column halves are 8 KB apart (leading offset), groups of 8 keys
    // 1 KB apart (stride offset); 16 keys a step
    const uint64_t dv = wgmma_desc(sv, kBN * 64 * 2, 1024);
#pragma unroll
    for (int ks = 0; ks < kBN / 16; ++ks) {
      const uint64_t off = (ks * 16 * 128) >> 4;
      if constexpr (D == 128) {
        wgmma_64x128_rs(o, pa[ks], dv + off);
      } else {  // columns 0-63 from V's first half, 64-71 from its second (8 KB on)
        wgmma_64x64_rs<0>(o, pa[ks], dv + off);
        wgmma_64x8_rs<32>(o, pa[ks], dv + off + ((kBN * 64 * 2) >> 4));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
  }

  // V rows of the tile at j0 that no query row of the CTA sees, zeroed in shared memory after
  // the TMA has brought them: a masked key weighs 0 by selection, but 0 * NaN in P V would still
  // be NaN. True (for every consumer) where the tile has such rows; only tiles that straddle a
  // boundary of the visible set do.
  __device__ __forceinline__ bool zero_unreachable(bf16* tile, const Visibility& vis, int last_row,
                                                   int j0) const {
    const int j1 = min(j0 + kBN, vis.n_keys), be = vis.block_end(last_row);
    if (j1 <= vis.ln || (j0 >= vis.bs && j1 <= be) || (vis.bs <= vis.ln && j1 <= max(vis.ln, be)))
      return false;  // every row below n_keys is reachable (the rest is zero already)
    for (int idx = threadIdx.x; idx < kBN * 16; idx += kConsumers) {
      const int r = idx >> 4, c = idx & 15;
      if (!vis.reachable(j0 + r, last_row))
        *reinterpret_cast<uint4*>(tile + swz(r, c * 8)) = make_uint4(0u, 0u, 0u, 0u);
    }
    return true;
  }

  // One pass over the tiles of `plan` of a key array [S, Hk, n_keys, D] (K and V tensor maps,
  // KV head hk, stream s). The producer warp loads tile after tile into the ring as stages come
  // free; each consumer warp waits for a tile, multiplies it and releases its stage. kKPre: each
  // raw K tile gets the island once it has landed. The first sweep with tiles also finishes Q.
  template <bool kQPre, bool kKPre>
  __device__ __forceinline__ void sweep(const Visibility& vis, int last_row, const CUtensorMap* kmap,
                                        const CUtensorMap* vmap, int hk, const Preproc& qpre,
                                        const Preproc& kpre, int s, float sl2) {
    static_assert(D == 128 || !(kQPre || kKPre), "the islands take head dim 128");
    const TilePlan plan = plan_tiles(vis, last_row);
    if (plan.n == 0) return;
    const uint32_t base = n_loads;  // ring position of this sweep's first tile
    n_loads = base + plan.n;
    if (producer) {
      if (lane != 0) return;
      for (int i = 0; i < plan.n; ++i) {
        const uint32_t pos = base + i;
        bf16* stage = s_kv + (pos % kStages) * 2 * kTile;
        uint64_t* bar = full + pos % kStages;
        if (pos >= kStages) mbar_wait(empty + pos % kStages, ((pos / kStages) - 1) & 1);
        mbar_expect_tx(bar, 2 * kTile * 2);
        const int j0 = plan.key0(i);
        tma_load(stage, kmap, bar, 0, j0, hk, s);  // each tile as two 64-column halves
        tma_load(stage + kBN * 64, kmap, bar, 64, j0, hk, s);
        tma_load(stage + kTile, vmap, bar, 0, j0, hk, s);
        tma_load(stage + kTile + kBN * 64, vmap, bar, 64, j0, hk, s);
      }
      return;
    }
    if (q_pending) prepare_q<kQPre>(qpre, s);
    Island kis;  // read only with kKPre: kpre's pointers are null without the k island
    if constexpr (kKPre) kis = Island(kpre, s);
    for (int i = 0; i < plan.n; ++i) {
      const uint32_t pos = base + i;
      bf16* sk = s_kv + (pos % kStages) * 2 * kTile;
      const int j0 = plan.key0(i);
      mbar_wait(full + pos % kStages, (pos / kStages) & 1);
      const bool fixed = zero_unreachable(sk + kTile, vis, last_row, j0);
      if constexpr (kKPre) preprocess_rows<8>(sk, kis, j0, vis.n_keys, threadIdx.x >> 5);
      if (kKPre || fixed) {  // consumer-uniform
        fence_proxy_async();
        consumers_sync();
      }
      step(sk, sk + kTile, j0, vis, sl2);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + pos % kStages);
    }
  }

  __device__ __forceinline__ void store(bf16* out, float* lse, int s, int H, int h) const {
    if (producer) return;
    store_rows<D, kVecs>(o, st, out, lse, s, T, H, h, row_a, row_b);
  }
};

// cuTensorMapEncodeTiled of the driver, found once through the runtime (no link to libcuda).
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// The tensor map of a bf16 array [S, heads, rows, D] with (stream, head, row) strides in
// elements and D contiguous, in boxes of 64 rows x 64 columns stored as wgmma reads them
// (128-byte swizzle); columns past D and rows past `rows` arrive as zeros. False if the driver
// refuses it (strides must be multiples of 16 bytes).
inline bool encode_kv_map(CUtensorMap* map, const void* base, int S, int heads, int rows, int D,
                          long long ss, long long sh, long long sr) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(rows), cuuint64_t(heads), cuuint64_t(S)};
  const cuuint64_t strides[3] = {cuuint64_t(sr) * 2, cuuint64_t(sh) * 2, cuuint64_t(ss) * 2};
  const cuuint32_t box[4] = {64, kBN, 1, 1}, unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Lets `kernel` use `bytes` of dynamic shared memory, once per device: `done` is the caller's
// flag per kernel (a host call per launch would add to host-bound loops; setting it twice in a
// race is harmless).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes, bool (&done)[64]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && done[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && device < 64) done[device] = true;
  return err;
}

}  // namespace flash
