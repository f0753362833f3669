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
// With int8 x, unpacking happens in registers and never widens to 16 or 32 bits per nibble. A
// 32-bit word of wp is 8 in-rows: (w << 4) & 0xF0F0F0F0 holds the four even in-rows as signed
// bytes, each 16 times its nibble, and w & 0xF0F0F0F0 the four odd ones. Those bytes feed the
// integer products as they are, and the int32 sum, a multiple of 16 below 2^31 for K up to
// 130,000, is shifted right by 4 at the end.
//
// What bounds it on the H100: at decode (m of 1 to a few rows) each weight byte is used for 2 m
// multiply-adds: HBM bandwidth, at half a byte per weight. At prefill (m in the thousands) the
// tensor cores: 1979 TOP/s dense int8 (int8 x), 989 TFLOP/s dense bf16 (bf16 x).
// What the design does about it, by m and x's type:
//  - m <= 4: a weight stream on mma.sync, split evenly over the warps of all SMs. The packed
//    weights are cut into units of 32 weight rows by one slice of in-rows (512, or the largest
//    of 256, 128, 64 that divides the group: a slice never straddles two groups), numbered tile
//    by tile with the slice fastest; warp w of n_workers (16 an SM) takes units
//    [w U / n, (w + 1) U / n), so every SM streams the same number of units to within one a warp
//    (ops/w4_matmul.py::gemv_plan). A warp issues a unit's 16 loads of 16 bytes at once (each
//    lane 2 x 2 weight rows x 64 bytes, read once: no L1 allocation, the L2 fetching whole
//    lines) and multiplies it in registers: the weights are the A operand of two 16-row tiles,
//    x the B operand (8 columns, m of them real), its fragment loaded one 128-in-row group ahead
//    and used for both tiles. The in-rows are permuted inside a step so that a lane's A
//    registers come from one packed word per weight row and its B registers from 8 consecutive
//    x values: with int8 x the word is spread into signed bytes, 16 times each nibble (`lo16` /
//    `hi16`), for one m16n8k32 s8 product; with bf16 x it is widened exactly (`widen8`, no I2F)
//    for two m16n8k16 bf16 products. Each weight is widened once, whatever m is; the even and
//    the odd steps sum apart (two dependent chains of products instead of one).
//    The slice sums meet in one of two ways, both adding a tile's slices in slice order and
//    then applying the scales as the plain version does (int32 sums are exact; with group
//    scales each group's sum is scaled and added in group order), one launch per call,
//    repeats bit-equal:
//    (a) through a workspace [N, m, slices] (int32, or fp32 bits; slices contiguous, so the
//        combine loads them as vectors): a warp that ends a run of units of a tile counts them
//        on the tile's arrival counter (acquire-release), and the warp that brings the last
//        slice combines the tile and resets the counter to 0, so a CUDA graph replays right;
//    (b) where every unit has a warp and a tile has at most 8 slices (qkv and o at K 3584: the
//        small projections, where (a)'s three dependent round trips to L2 would be the tail),
//        one CTA per tile, warp s its slice s, the sums through shared memory to warp 0.
//    What the card showed on the way (PERF.md, §6): the access pattern of the loads does not
//    matter (a load-only kernel streams gate_up at 2.8 TB/s in each of four patterns); 16-byte
//    cp.async into a CTA-wide ring with a barrier per unit reached 1.3 TB/s, bulk copies of 256
//    bytes per row less; issuing a unit's loads before the previous unit's stores and counts
//    was slower than after them.
//  - m > 4, int8 x: a GEMM on wgmma m64nBk32 s8 x s8 -> s32 that computes y^T = W x^T: the
//    weights are the A operand, from registers, and x the B operand, from shared memory (for
//    8-bit types both must be K-major, and both already are). A CTA owns 128 weight rows (two
//    consumer warpgroups of 64) by B = 256 x rows (per channel; 128 with group scales, whose
//    fp32 sums double the accumulator registers), over k-steps of 128 in-rows. One producer
//    warp keeps a ring of stages full with TMA loads: the x tile (B rows x 128 bytes, 128-byte
//    swizzle, what wgmma reads) and the packed W tile (128 rows x 64 bytes, 64-byte swizzle, so
//    that the consumers' 4-byte reads hit 32 distinct banks), with per-stage `full` / `empty`
//    mbarriers. Each consumer thread reads the packed bytes of its A fragment (rows g and
//    g + 8 of its warp's 16, in-rows 4t .. 4t + 3 and 16 + 4t .. of each k32 step: half a
//    32-bit word each) and spreads them in registers into signed bytes, 16 times the nibble,
//    in natural order (two masks and one byte permute per register): nothing unpacked goes
//    through shared memory, so no proxy fence is needed. A stage's A registers are written
//    while the previous stage's products run (two register sets), and are complete before the
//    stage's first product starts (ptxas serialises the products otherwise). With group
//    scales the s32 accumulator is flushed into an fp32 one at each group's end (rounded
//    multiply by the group's scale, rounded add), and the group's first product overwrites it;
//    a stage's four products are two commit groups of 64 in-rows, and a flush comes only
//    between them (a branch between two products of one group made ptxas serialise every
//    product: 3.4 ms against 1.15 per channel at gate_up, m 4902, on an NVIDIA H100 80GB HBM3
//    at 700 W). The epilogue scales, rounds to bf16, transposes through shared memory (the
//    ring, now free) and writes 16-byte chunks of y rows.
//    The grid's x is the x-row tile, so the CTAs that share a W tile run side by side: the
//    packed W (68 MB for gate_up, more than L2) comes from HBM about once, x (17.5 MB at 4902
//    rows) stays in L2.
//  - m > 4, bf16 x (weight-only w4): the same y^T = W x^T on wgmma m64nBk16 bf16 x bf16 -> f32,
//    both operands in shared memory. A CTA owns 128 weight rows (two consumer warpgroups of
//    64) by B x rows, B the smallest of 64, 128, 256 that holds m (at most 128 with group
//    scales), over stages of 64 in-rows (four k16 products, one commit group). The producer
//    warp keeps a ring of stages full with TMA loads: the x tile (B rows x 128 bytes, 128-byte
//    swizzle) and the packed W tile (128 rows x 32 bytes). Each consumer warpgroup widens its
//    own 64 packed rows of a stage into a bf16 tile in wgmma's swizzled layout (16 bytes a
//    thread, each nibble exact through the mantissa of 128.0, no I2F: `widen8`), fences the
//    generic proxy against the async one, meets its four warps on a named barrier and issues
//    the stage's products. The widening of stage kt + 1 runs while stage kt's products are in
//    flight (two widened tiles), so the product chain never waits on register writes, and each
//    nibble is widened once per CTA rather than once per warp that reads it. With group scales
//    the accumulator is flushed into an fp32 one (rounded multiply by the group's scale,
//    rounded add) after the group's last commit group, and the next group's first product
//    overwrites it. Epilogue and grid order as for int8 x.

#include <type_traits>

#include "flash_common.cuh"

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
// ---------------------------------------------------------------------------------------------
// m > 4, int8 x: y^T = W x^T on wgmma s8 x s8 -> s32, fed by a TMA ring
// ---------------------------------------------------------------------------------------------

using flash::mbar_arrive;
using flash::mbar_expect_tx;
using flash::mbar_init;
using flash::mbar_wait;
using flash::smem_u32;
using flash::wgmma_commit;
using flash::wgmma_desc;
using flash::wgmma_fence;
using flash::wgmma_wait;

constexpr int kWRows = 128;            // weight rows of a CTA: two consumer warpgroups of 64
constexpr int kKStep = 128;            // in-rows of a stage: four k32 products
constexpr int kWTileBytes = kWRows * kKStep / 2;
constexpr int kQConsumers = 256;
constexpr int kQThreads = kQConsumers + 32;
constexpr int kOutStride = kWRows + 8;  // bf16 per row of the output tile in shared memory

// Per x-row tile B: per channel 256 x rows and 4 stages; with group scales 128 and 6.
template <bool GROUPED>
struct W4a8Tile {
  static constexpr int kB = GROUPED ? 128 : 256;
  static constexpr int kStages = GROUPED ? 6 : 4;
  static constexpr int kXTileBytes = kB * kKStep;
  static constexpr int kStageBytes = kXTileBytes + kWTileBytes;
  static constexpr int kAcc = kB / 2;  // s32 accumulators per thread: 64 rows x kB / 128
  // the ring, its mbarriers, slack to align the tiles to 1024 bytes
  static constexpr int kSmem = kStages * kStageBytes + 16 * kStages + 1024;
  static_assert(kB * kOutStride * 2 <= kStages * kStageBytes, "the output tile fits the ring");
};

#define K4_R4(a, i) "+r"(a[i]), "+r"(a[i + 1]), "+r"(a[i + 2]), "+r"(a[i + 3])
#define K4_R16(a, i) K4_R4(a, i), K4_R4(a, i + 4), K4_R4(a, i + 8), K4_R4(a, i + 12)
#define K4_R64(a, i) K4_R16(a, i), K4_R16(a, i + 16), K4_R16(a, i + 32), K4_R16(a, i + 48)

// d[64 x 128] = A[64 x 32] B[32 x 128] (+ d where `accumulate`), s8 x s8 -> s32; A in registers
// (the m16n8k32 A fragment of each warp's 16 rows), B K-major in shared memory.
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : K4_R64(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d[64 x 256] = A[64 x 32] B[32 x 256] (+ d where `accumulate`), as above.
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], const uint32_t (&a)[4], uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, "
      "%126, %127}, "
      "{%128, %129, %130, %131}, %132, p;\n}\n"
      : K4_R64(d, 0), K4_R64(d, 64)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

#undef K4_R64
#undef K4_R16
#undef K4_R4

template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  if constexpr (N == 128)
    wgmma_s8_n256(d, a, db, accumulate);
  else
    wgmma_s8_n128(d, a, db, accumulate);
}

// Keeps the compiler from moving reads or writes of these registers across a wgmma fence,
// commit or wait (accumulators), or from computing them after the fence (A fragments).
template <int N, typename T>
__device__ __forceinline__ void fence_iregs(T (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// One box of a 2-d tensor map (coordinates innermost first) -> shared memory, by the TMA unit.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, "
      "%3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// Half (t & 1) of a packed word, in-rows 4 nibbles -> 4 signed bytes, 16 times each nibble, in
// order: [16 n0, 16 n1, 16 n2, 16 n3] of the half's two bytes (n0 the first byte's low nibble).
__device__ __forceinline__ uint32_t spread(uint32_t w, uint32_t sel) {
  return __byte_perm((w << 4) & 0xF0F0F0F0u, w & 0xF0F0F0F0u, sel);
}

// The four A registers of k32 step s for this thread's rows (packed rows ra and ra + 8 of the W
// tile, 64 bytes each, 16-byte chunk c of row r at chunk c ^ ((r >> 1) & 3)): in-rows 4t .. 4t + 3
// of the step are bytes 2t, 2t + 1 of its chunk, in-rows 16 + 4t .. bytes 8 + 2t, 9 + 2t.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint8_t* wt, int ra, int s, int t,
                                       uint32_t sel) {
  const uint8_t* p0 = wt + ra * 64 + ((s ^ ((ra >> 1) & 3)) << 4) + 4 * (t >> 1);
  const uint8_t* p8 = wt + (ra + 8) * 64 + ((s ^ (((ra + 8) >> 1) & 3)) << 4) + 4 * (t >> 1);
  const uint32_t w0 = *reinterpret_cast<const uint32_t*>(p0);
  const uint32_t w8 = *reinterpret_cast<const uint32_t*>(p8);
  const uint32_t v0 = *reinterpret_cast<const uint32_t*>(p0 + 8);
  const uint32_t v8 = *reinterpret_cast<const uint32_t*>(p8 + 8);
  a[0] = spread(w0, sel);
  a[1] = spread(w8, sel);
  a[2] = spread(v0, sel);
  a[3] = spread(v8, sel);
}

template <bool GROUPED>
struct W4a8Consumer {
  using Tile = W4a8Tile<GROUPED>;
  int acc[Tile::kAcc];                  // s32 sums of this group (or of all K), times 16
  float facc[GROUPED ? Tile::kAcc : 1];  // with group scales: the scaled groups added so far
  uint32_t a[2][4][4];                  // A registers of two stages: [set][k32 step][register]

  // Stage kt of the ring: A registers of set S from its W tile, then its four products in two
  // commit groups of two (64 in-rows each). With group scales, a group's first product
  // overwrites the accumulator instead of adding to it, and where a group ends after a half the
  // warpgroup waits for its products and adds the scaled sum to the fp32 one: only at a half's
  // end, so no branch separates two products of one commit group. Then the release of stage
  // kt - 1, whose products are done.
  template <int S>
  __device__ __forceinline__ void stage(const uint8_t* ring, uint64_t* full, uint64_t* empty,
                                        int kt, int ra, int t, uint32_t sel, int K, int gsize,
                                        const float* ws, int na, int nb, int N, int lane) {
    const int st = kt % Tile::kStages;
    mbar_wait(full + st, (kt / Tile::kStages) & 1);
    const uint8_t* xt = ring + st * Tile::kStageBytes;
    const uint8_t* wt = xt + Tile::kXTileBytes;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      load_a(a[S][s], wt, ra, s, t, sel);
      fence_iregs(a[S][s]);
    }
    const uint64_t d_x = wgmma_desc(xt, 16, 1024);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      fence_iregs(acc);
      wgmma_fence();
#pragma unroll
      for (int s = 2 * half; s < 2 * half + 2; ++s) {
        // 32 bytes of each 128-byte x row a step
        const int k0 = kt * kKStep + 32 * s;
        wgmma_s8(acc, a[S][s], d_x + ((s * 32) >> 4), GROUPED ? k0 % gsize != 0 : 1);
      }
      wgmma_commit();
      if constexpr (GROUPED) {
        const int k_end = kt * kKStep + 64 * (half + 1);
        if (k_end <= K && k_end % gsize == 0) {  // a group ends: scale its sum and add it
          wgmma_wait<0>();
          fence_iregs(acc);
          const float* wsg = ws + static_cast<long long>(k_end / gsize - 1) * N;
          const float wa = na < N ? wsg[na] : 0.f, wb = nb < N ? wsg[nb] : 0.f;
#pragma unroll
          for (int i = 0; i < Tile::kAcc; ++i)
            facc[i] = __fadd_rn(facc[i],
                                __fmul_rn(static_cast<float>(acc[i] >> 4), (i & 2) ? wb : wa));
        }
      }
    }
    wgmma_wait<2>();  // stage kt - 1's products are done: its tiles may be refilled
    fence_iregs(acc);
    if (kt > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + (kt - 1) % Tile::kStages);
    }
  }
};

// One CTA per (x-row tile of kB rows, 128 weight rows), grid (ceil(m / kB), ceil(N / 128)).
template <bool GROUPED>
__global__ void __launch_bounds__(kQThreads, 1)
    w4a8_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap, const float* __restrict__ xs,
                      const float* __restrict__ ws, bf16* __restrict__ out, int m, int K, int N,
                      int gsize) {
  using Tile = W4a8Tile<GROUPED>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  uint8_t* ring = smem_raw + (((base + 1023u) & ~1023u) - base);  // [kStages][x tile, W tile]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + Tile::kStages * Tile::kStageBytes);
  uint64_t* empty = full + Tile::kStages;

  const int m0 = blockIdx.x * Tile::kB, n0 = blockIdx.y * kWRows;
  const int nk = (K + kKStep - 1) / kKStep;
  if (threadIdx.x == 0) {
    for (int i = 0; i < Tile::kStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kQConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kQConsumers) {  // the producer warp
    if (threadIdx.x != kQConsumers) return;
    for (int kt = 0; kt < nk; ++kt) {
      const int st = kt % Tile::kStages;
      if (kt >= Tile::kStages) mbar_wait(empty + st, ((kt / Tile::kStages) - 1) & 1);
      uint8_t* xt = ring + st * Tile::kStageBytes;
      mbar_expect_tx(full + st, Tile::kStageBytes);
      tma_load_2d(xt, &xmap, full + st, kt * kKStep, m0);
      tma_load_2d(xt + Tile::kXTileBytes, &wmap, full + st, kt * kKStep / 2, n0);
    }
    return;
  }

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ra = wg * 64 + warp * 16 + g;  // this thread's weight rows in the tile: ra, ra + 8
  const int na = n0 + ra, nb = na + 8;
  const uint32_t sel = (t & 1) ? 0x7362u : 0x5140u;
  W4a8Consumer<GROUPED> c;
#pragma unroll
  for (int i = 0; i < Tile::kAcc; ++i) c.acc[i] = 0;
  if constexpr (GROUPED) {
#pragma unroll
    for (int i = 0; i < Tile::kAcc; ++i) c.facc[i] = 0.f;
  }
  for (int kt = 0; kt < nk; kt += 2) {
    c.template stage<0>(ring, full, empty, kt, ra, t, sel, K, gsize, ws, na, nb, N, lane);
    if (kt + 1 < nk)
      c.template stage<1>(ring, full, empty, kt + 1, ra, t, sel, K, gsize, ws, na, nb, N, lane);
  }
  wgmma_wait<0>();
  fence_iregs(c.acc);

  // y[m0 + j, n0 + r] for r in this thread's rows and j in its columns 8 i + 2t (+1): scaled,
  // rounded to bf16, transposed into the output tile [kB][kOutStride] in the ring (every
  // consumer's products are done before any writes it), then written as 16-byte row chunks
  asm volatile("bar.sync 1, %0;\n" ::"n"(kQConsumers) : "memory");
  bf16* s_out = reinterpret_cast<bf16*>(ring);
  const float wca = !GROUPED && na < N ? ws[na] : 0.f, wcb = !GROUPED && nb < N ? ws[nb] : 0.f;
#pragma unroll
  for (int j = 0; j < Tile::kB / 8; ++j) {
    const int col = 8 * j + 2 * t;
    const float x0 = m0 + col < m ? xs[m0 + col] : 0.f;
    const float x1 = m0 + col + 1 < m ? xs[m0 + col + 1] : 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      const float xsc = (e & 1) ? x1 : x0;
      float y;
      if constexpr (GROUPED)
        y = __fmul_rn(c.facc[i], xsc);
      else
        y = __fmul_rn(__fmul_rn(static_cast<float>(c.acc[i] >> 4), xsc), (e & 2) ? wcb : wca);
      s_out[(col + (e & 1)) * kOutStride + ra + ((e & 2) ? 8 : 0)] = __float2bfloat16(y);
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(kQConsumers) : "memory");
  constexpr int kChunks = kWRows / 8;  // 16-byte chunks of an output row
  for (int idx = threadIdx.x; idx < Tile::kB * kChunks; idx += kQConsumers) {
    const int r = idx / kChunks, ch = idx - r * kChunks;
    const int row = m0 + r, col = n0 + 8 * ch;
    if (row < m && col < N)
      *reinterpret_cast<uint4*>(out + static_cast<long long>(row) * N + col) =
          *reinterpret_cast<const uint4*>(s_out + r * kOutStride + 8 * ch);
  }
}

// The tensor map of a row-major uint8 array [rows, cols] (cols a multiple of 16) in boxes of
// box_rows x box_cols bytes with the given swizzle; out-of-range bytes arrive as zeros.
bool encode_bytes(CUtensorMap* map, const void* base, int rows, int cols, int box_rows,
                  int box_cols, CUtensorMapSwizzle swizzle) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = flash::tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(cols)};
  const cuuint32_t box[2] = {cuuint32_t(box_cols), cuuint32_t(box_rows)}, unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <bool GROUPED>
cudaError_t launch_w4a8(const int8_t* x, const float* xs, const uint8_t* wp, const float* ws,
                        bf16* out, int m, int K, int N, int gsize, cudaStream_t stream) {
  using Tile = W4a8Tile<GROUPED>;
  static bool smem_set[64] = {};
  cudaError_t err = flash::allow_smem(w4a8_wgmma_kernel<GROUPED>, Tile::kSmem, smem_set);
  if (err != cudaSuccess) return err;
  CUtensorMap xmap, wmap;
  if (!encode_bytes(&xmap, x, m, K, Tile::kB, kKStep, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_bytes(&wmap, wp, N, K / 2, kWRows, kKStep / 2, CU_TENSOR_MAP_SWIZZLE_64B))
    return cudaErrorInvalidValue;
  const dim3 grid((m + Tile::kB - 1) / Tile::kB, (N + kWRows - 1) / kWRows);
  w4a8_wgmma_kernel<GROUPED><<<grid, kQThreads, Tile::kSmem, stream>>>(xmap, wmap, xs, ws, out,
                                                                       m, K, N, gsize);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------------------------
// m > 4, bf16 x: y^T = W x^T on wgmma bf16 x bf16 -> f32, both operands in shared memory
// ---------------------------------------------------------------------------------------------

constexpr int kBKStep = 64;                           // in-rows of a stage: four k16 products
constexpr int kBPackedBytes = kWRows * kBKStep / 2;   // the packed W tile of a stage
constexpr int kBWideBytes = kWRows * kBKStep * 2;     // the same tile widened to bf16
constexpr int kBConsumers = 256;
constexpr int kBThreads = kBConsumers + 32;

// Per x-row tile B (64, 128 or 256 rows, the wgmma's n): 5 stages at B 256, else 8.
template <int B>
struct W4Bf16Tile {
  static constexpr int kStages = B == 256 ? 5 : 8;
  static constexpr int kXTileBytes = B * kBKStep * 2;  // B rows of 128 bytes
  static constexpr int kStageBytes = kXTileBytes + kBPackedBytes;
  static constexpr int kAcc = B / 2;  // fp32 accumulators per thread: 64 rows x B / 128
  // the ring, two widened W tiles, the mbarriers, slack to align the tiles to 1024 bytes
  static constexpr int kSmem = kStages * kStageBytes + 2 * kBWideBytes + 16 * kStages + 1024;
  static_assert(kStageBytes % 1024 == 0, "every tile starts on a 1024-byte boundary");
  static_assert(B * kOutStride * 2 <= kStages * kStageBytes, "the output tile fits the ring");
  static_assert(kSmem <= 232448, "the CTA fits one SM's shared memory");
};

#define K4_F4(a, i) "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3])
#define K4_F16(a, i) K4_F4(a, i), K4_F4(a, i + 4), K4_F4(a, i + 8), K4_F4(a, i + 12)

// d[64 x 64] = A[64 x 16] B[16 x 64] (+ d where `accumulate`), bf16 x bf16 -> f32; A and B
// K-major in shared memory (128-byte swizzle).
__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32], uint64_t da, uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : K4_F16(d, 0), K4_F16(d, 16)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 128] = A[64 x 16] B[16 x 128] (+ d where `accumulate`), bf16 x bf16 -> f32; A and B
// K-major in shared memory (128-byte swizzle).
__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], uint64_t da, uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : K4_F16(d, 0), K4_F16(d, 16), K4_F16(d, 32), K4_F16(d, 48)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 256] = A[64 x 16] B[16 x 256] (+ d where `accumulate`), bf16 x bf16 -> f32; A and B
// K-major in shared memory (128-byte swizzle).
__device__ __forceinline__ void wgmma_bf16_n256(float (&d)[128], uint64_t da, uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : K4_F16(d, 0), K4_F16(d, 16), K4_F16(d, 32), K4_F16(d, 48), K4_F16(d, 64), K4_F16(d, 80), K4_F16(d, 96), K4_F16(d, 112)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef K4_F16
#undef K4_F4

template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N], uint64_t da, uint64_t db,
                                           int accumulate) {
  if constexpr (N == 128)
    wgmma_bf16_n256(d, da, db, accumulate);
  else if constexpr (N == 64)
    wgmma_bf16_n128(d, da, db, accumulate);
  else
    wgmma_bf16_n64(d, da, db, accumulate);
}

// The 8 in-rows of a packed word as four bf16x2 registers (register b: in-rows 2b low, 2b + 1
// high), exactly and without I2F: the signed nibble n becomes n ^ 8 = n + 8 in [0, 15], which OR'd
// into the low mantissa bits of 128.0 (bf16 0x4300) makes the bf16 128 + n + 8; subtracting 136
// (0x4308) as bf16x2 leaves n, exact since every integer up to 256 is a bf16. One byte permute
// puts byte b of the biased word (low nibble: in-row 2b) and of the word shifted right by 4 (its
// low nibble: in-row 2b + 1) into the two halves; one AND-OR (lop3) keeps the nibbles and sets
// the exponent. ops/w4_matmul.py::widen_nibbles_twin is its plain-torch twin.
__device__ __forceinline__ uint4 widen8(uint32_t w) {
  const uint32_t x = w ^ 0x88888888u, sh = x >> 4;
  const __nv_bfloat162 bias = __halves2bfloat162(__ushort_as_bfloat16(0x4308),
                                                 __ushort_as_bfloat16(0x4308));
  uint32_t r[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const uint32_t v = (__byte_perm(x, sh, 0x4400u + 0x1111u * b) & 0x000F000Fu) | 0x43004300u;
    const __nv_bfloat162 y = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v), bias);
    r[b] = *reinterpret_cast<const uint32_t*>(&y);
  }
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// One CTA per (x-row tile of B rows, 128 weight rows), grid (ceil(m / B), ceil(N / 128)).
template <bool GROUPED, int B>
__global__ void __launch_bounds__(kBThreads, 1)
    w4_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap wmap, const float* __restrict__ ws,
                         bf16* __restrict__ out, int m, int K, int N, int gsize) {
  using Tile = W4Bf16Tile<B>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  uint8_t* ring = smem_raw + (((base + 1023u) & ~1023u) - base);  // [kStages][x tile, W tile]
  uint8_t* wide = ring + Tile::kStages * Tile::kStageBytes;       // [2][128 rows][128 bytes]
  uint64_t* full = reinterpret_cast<uint64_t*>(wide + 2 * kBWideBytes);
  uint64_t* empty = full + Tile::kStages;

  const int m0 = blockIdx.x * B, n0 = blockIdx.y * kWRows;
  const int nk = K / kBKStep;
  if (threadIdx.x == 0) {
    for (int i = 0; i < Tile::kStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kBConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kBConsumers) {  // the producer warp
    if (threadIdx.x != kBConsumers) return;
    for (int kt = 0; kt < nk; ++kt) {
      const int st = kt % Tile::kStages;
      if (kt >= Tile::kStages) mbar_wait(empty + st, ((kt / Tile::kStages) - 1) & 1);
      uint8_t* xt = ring + st * Tile::kStageBytes;
      mbar_expect_tx(full + st, Tile::kStageBytes);
      tma_load_2d(xt, &xmap, full + st, kt * kBKStep * 2, m0);
      tma_load_2d(xt + Tile::kXTileBytes, &wmap, full + st, kt * kBKStep / 2, n0);
    }
    return;
  }

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ra = wg * 64 + warp * 16 + g;  // this thread's weight rows in the tile: ra, ra + 8
  const int na = n0 + ra, nb = na + 8;
  // what this thread widens: packed row wr of its warpgroup's 64, in-rows 32 h .. 32 h + 31
  const int wr = (threadIdx.x & 127) >> 1, h = threadIdx.x & 1;
  float acc[Tile::kAcc];                  // fp32 sums of this group (or of all K)
  float facc[GROUPED ? Tile::kAcc : 1];  // with group scales: the scaled groups added so far
#pragma unroll
  for (int i = 0; i < Tile::kAcc; ++i) acc[i] = 0.f;
  if constexpr (GROUPED) {
#pragma unroll
    for (int i = 0; i < Tile::kAcc; ++i) facc[i] = 0.f;
  }

  // groups of gsize / 64 stages (per channel one group of all K); a group's first product
  // overwrites the sum, and after its last stage's products the sum is flushed: the loops have
  // no branch between a product and the flush, so nothing but wgmma defines the accumulators
  const int per_group = gsize / kBKStep;
  for (int kg = 0; kg < nk; kg += per_group) {
    for (int kt = kg; kt < kg + per_group; ++kt) {
      const int st = kt % Tile::kStages;
      mbar_wait(full + st, (kt / Tile::kStages) & 1);
      const uint8_t* xt = ring + st * Tile::kStageBytes;
      // widen this warpgroup's 64 packed rows into its half of widened tile kt & 1 (the
      // products that read it last, stage kt - 2's, are done), in wgmma's layout: 16-byte chunk
      // c (in-rows 8c .. 8c + 7) of row r at chunk c ^ (r % 8)
      uint8_t* wt = wide + (kt & 1) * kBWideBytes + wg * (kBWideBytes / 2);
      {
        const uint4 p = *reinterpret_cast<const uint4*>(xt + Tile::kXTileBytes +
                                                        (wg * 64 + wr) * 32 + h * 16);
        const uint32_t words[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<uint4*>(wt + wr * 128 + (((4 * h + j) ^ (wr & 7)) << 4)) =
              widen8(words[j]);
      }
      flash::fence_proxy_async();  // the widened tile is read by wgmma (async proxy)
      asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
      // the stage's four products, one commit group
      const uint64_t d_x = wgmma_desc(xt, 16, 1024), d_w = wgmma_desc(wt, 16, 1024);
      flash::fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s)  // 32 bytes of each 128-byte row a step
        wgmma_bf16(acc, d_w + ((s * 32) >> 4), d_x + ((s * 32) >> 4),
                   (kt == kg && s == 0) ? 0 : 1);
      wgmma_commit();
      wgmma_wait<1>();  // stage kt - 1's products are done: its tiles may be refilled
      flash::fence_regs(acc);
      if (kt > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + (kt - 1) % Tile::kStages);
      }
    }
    if constexpr (GROUPED) {  // the group's sum, scaled (rounded multiply) and added (rounded add)
      wgmma_wait<0>();
      flash::fence_regs(acc);
      const float* wsg = ws + static_cast<long long>(kg / per_group) * N;
      const float wa = na < N ? wsg[na] : 0.f, wb = nb < N ? wsg[nb] : 0.f;
#pragma unroll
      for (int i = 0; i < Tile::kAcc; ++i)
        facc[i] = __fadd_rn(facc[i], __fmul_rn(acc[i], (i & 2) ? wb : wa));
    }
  }
  wgmma_wait<0>();
  flash::fence_regs(acc);

  // y[m0 + j, n0 + r] for r in this thread's rows and j in its columns 8 i + 2t (+1): scaled,
  // rounded to bf16, transposed into the output tile [B][kOutStride] in the ring (every
  // consumer's products are done before any writes it), then written as 16-byte row chunks
  asm volatile("bar.sync 1, %0;\n" ::"n"(kBConsumers) : "memory");
  bf16* s_out = reinterpret_cast<bf16*>(ring);
  const float wca = !GROUPED && na < N ? ws[na] : 0.f, wcb = !GROUPED && nb < N ? ws[nb] : 0.f;
#pragma unroll
  for (int i = 0; i < Tile::kAcc; ++i) {
    const int col = 8 * (i >> 2) + 2 * t + (i & 1);
    const float y = GROUPED ? facc[i] : __fmul_rn(acc[i], (i & 2) ? wcb : wca);
    s_out[col * kOutStride + ra + ((i & 2) ? 8 : 0)] = __float2bfloat16(y);
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(kBConsumers) : "memory");
  constexpr int kChunks = kWRows / 8;  // 16-byte chunks of an output row
  for (int idx = threadIdx.x; idx < B * kChunks; idx += kBConsumers) {
    const int r = idx / kChunks, ch = idx - r * kChunks;
    const int row = m0 + r, col = n0 + 8 * ch;
    if (row < m && col < N)
      *reinterpret_cast<uint4*>(out + static_cast<long long>(row) * N + col) =
          *reinterpret_cast<const uint4*>(s_out + r * kOutStride + 8 * ch);
  }
}

template <bool GROUPED, int B>
cudaError_t launch_w4_bf16_tile(const bf16* x, const uint8_t* wp, const float* ws, bf16* out, int m,
                           int K, int N, int gsize, cudaStream_t stream) {
  using Tile = W4Bf16Tile<B>;
  static bool smem_set[64] = {};
  cudaError_t err = flash::allow_smem(w4_bf16_wgmma_kernel<GROUPED, B>, Tile::kSmem, smem_set);
  if (err != cudaSuccess) return err;
  CUtensorMap xmap, wmap;  // x as bytes: 128-byte boxes of 64 bf16
  if (!encode_bytes(&xmap, x, m, 2 * K, B, 2 * kBKStep, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_bytes(&wmap, wp, N, K / 2, kWRows, kBKStep / 2, CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  const dim3 grid((m + B - 1) / B, (N + kWRows - 1) / kWRows);
  w4_bf16_wgmma_kernel<GROUPED, B><<<grid, kBThreads, Tile::kSmem, stream>>>(xmap, wmap, ws, out,
                                                                            m, K, N, gsize);
  return cudaGetLastError();
}

// The x-row tile: the smallest of 64, 128, 256 that holds m, at most 128 with group scales
// (whose fp32 sums double the accumulator registers).
template <bool GROUPED>
cudaError_t launch_w4_bf16(const bf16* x, const uint8_t* wp, const float* ws, bf16* out, int m,
                           int K, int N, int gsize, cudaStream_t stream) {
  if (m <= 64) return launch_w4_bf16_tile<GROUPED, 64>(x, wp, ws, out, m, K, N, gsize, stream);
  if constexpr (GROUPED) {
    return launch_w4_bf16_tile<true, 128>(x, wp, ws, out, m, K, N, gsize, stream);
  } else {
    if (m <= 128) return launch_w4_bf16_tile<false, 128>(x, wp, ws, out, m, K, N, gsize, stream);
    return launch_w4_bf16_tile<false, 256>(x, wp, ws, out, m, K, N, gsize, stream);
  }
}

// ---------------------------------------------------------------------------------------------
// m <= kGemvRows: the weight stream on mma.sync, (32 weight rows x one slice) units over the warps
// ---------------------------------------------------------------------------------------------

constexpr int kGemvRows = 4;         // x rows of the GEMV: the B operand's 8 columns hold them
constexpr int kGemvCols = 32;        // weight rows of a unit: two m16 tiles
constexpr int kGemvMaxSlice = 512;   // in-rows of a unit: 256 bytes of each packed row
constexpr int kGemvWarps = 8;        // warps of a CTA, each a worker of its own
constexpr int kGemvBatch = 8;        // slice sums of each x row the combine loads at once

// 16 bytes of packed weights, read once: not kept in L1, the L2 asked to fetch the whole 128-byte
// line (the warp's next load reads its other half).
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::128B.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// Word q of a 16-byte vector (q known at compile time once unrolled: no local memory).
__device__ __forceinline__ uint32_t word(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// d += A[16 x 32] B[32 x 8], s8 x s8 -> s32 (A row-major: a0, a2 row g, a1, a3 row g + 8;
// B column g)
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += A[16 x 16] B[16 x 8], bf16 x bf16 -> f32, the same fragment rows
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// *p += v at device scope, returning the old value: a release of this warp's writes (those of its
// other lanes come before it through a warp barrier) and an acquire of the writes released by
// the arrivals before it.
__device__ __forceinline__ int atom_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// TILE_CTA's epilogue: warp s's sums of the tile (two per (tile j, register e), added in that
// order) go to shared memory, and after a CTA barrier warp 0 adds the slices in order and
// scales, as the global combine does (lane l: column n0 + l).
template <bool INT8X, typename Acc>
__device__ __forceinline__ void tile_combine(const Acc (&acc)[2][2][4], const float* xs,
                                             const float* ws, bf16* out, int m, int N, int G,
                                             int slices, int n0, int s, int lane, int g, int t) {
  __shared__ Acc sums[kGemvWarps][kGemvRows][kGemvCols];
  if (t < 2) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sums[s][2 * t + (e & 1)][16 * j + g + 8 * (e >> 1)] = acc[0][j][e] + acc[1][j][e];
  }
  __syncthreads();
  const int n = n0 + lane;
  if (s != 0 || n >= N) return;
  const int per_group = G ? slices / G : slices;
  float wg[kGemvWarps];  // the scale of the group each slice ends (slices <= kGemvWarps)
#pragma unroll
  for (int i = 0; i < kGemvWarps; ++i)
    wg[i] = G && i < slices && (i + 1) % per_group == 0
                ? ws[static_cast<long long>((i + 1) / per_group - 1) * N + n]
                : 0.f;
  const float wc = G ? 0.f : ws[n];
  for (int r = 0; r < m; ++r) {
    float y = 0.f;
    Acc sum = 0;
#pragma unroll
    for (int i = 0; i < kGemvWarps; ++i) {
      if (i >= slices) break;
      sum += sums[i][r][lane];
      if ((i + 1) % per_group != 0) continue;
      float v;  // the group's sum
      if constexpr (INT8X)
        v = static_cast<float>(sum >> 4);
      else
        v = sum;
      y = G ? __fadd_rn(y, __fmul_rn(v, wg[i])) : v;
      sum = 0;
    }
    if constexpr (INT8X) y = __fmul_rn(y, xs[r]);
    if (!G) y = __fmul_rn(y, wc);
    out[static_cast<long long>(r) * N + n] = __float2bfloat16(y);
  }
}

// Warp w of the grid (of n_workers) takes units [w U / n_workers, (w + 1) U / n_workers) of the
// U = tiles x slices units, unit u = (tile u / slices, slice u % slices). `work` [N, m, spad]
// holds the slice sums (int32, or fp32 bits; spad = slices rounded up to 4), `arrivals` [tiles]
// the slices done per tile (0 between calls).
// TILE_CTA: one CTA per tile, warp s its slice s (n_workers = U, at most kGemvWarps slices): the
// slice sums meet in shared memory and warp 0 combines them, with no workspace, counter or
// device-scope ordering (the small projections, where those round trips would be the tail).
template <bool INT8X, bool TILE_CTA>
__global__ void __launch_bounds__(32 * kGemvWarps, 2)
    w4_gemv_kernel(const uint8_t* __restrict__ x, const float* __restrict__ xs,
                   const uint8_t* __restrict__ wp, const float* __restrict__ ws,
                   bf16* __restrict__ out, int* __restrict__ work, int* __restrict__ arrivals,
                   int m, int K, int N, int G, int slice, int n_workers) {
  const int slices = K / slice, tiles = (N + kGemvCols - 1) / kGemvCols;
  const int worker = TILE_CTA ? blockIdx.x * slices + (threadIdx.x >> 5)
                              : blockIdx.x * kGemvWarps + (threadIdx.x >> 5);
  if (worker >= n_workers) return;  // whole warps
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long units = static_cast<long long>(tiles) * slices;
  const int u0 = static_cast<int>(units * worker / n_workers);
  const int u1 = static_cast<int>(units * (worker + 1) / n_workers);
  const int half = slice / 2;  // bytes of a packed row's slice
  const int spad = (slices + 3) & ~3;  // a (column, x row)'s slice sums: whole 16-byte vectors
  const long long row_bytes = K / 2;
  // the x row this lane's B registers hold (rows past m stay zero)
  const uint8_t* xg = x + static_cast<long long>(g < m ? g : 0) * (INT8X ? K : 2LL * K);
  using Acc = typename std::conditional<INT8X, int, float>::type;
  // The packed bytes of a unit in registers, its 16 loads issued at once: for tile j, weight rows
  // g and g + 8 (h), 64-byte group q4 of the slice, bytes 16 t .. 16 t + 15 of it (zero past the
  // slice or past N). (Issuing the next unit's loads before this one's stores, counts and
  // combine read slower on the card: more loads in flight did not raise the rate.)
  uint4 wv[2][2][4];
  auto load_unit = [&](int u) {
    const int tile = u / slices, s = u - tile * slices;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = tile * kGemvCols + 16 * j + 8 * h + g;
        const uint8_t* row = wp + static_cast<long long>(n < N ? n : 0) * row_bytes + s * half;
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4) {
          const int off = 64 * q4 + 16 * t;
          wv[j][h][q4] = n < N && off < half
                             ? ld_stream(row + off)
                             : make_uint4(0u, 0u, 0u, 0u);
        }
      }
  };
  int run = 0;  // units of the current tile whose slice sums are written but not yet counted
  for (int u = u0; u < u1; ++u) {
    load_unit(u);
    const int tile = u / slices, s = u - tile * slices, n0 = tile * kGemvCols;
    // x row g's values of group q4 (in-rows 128 q4 + 32 t .. + 31 of the slice): two 16-byte
    // vectors with int8 x, four with bf16 x (one a step), loaded one group ahead of their use
    const uint8_t* xs0 = xg + (static_cast<long long>(s) * slice + 32 * t) * (INT8X ? 1 : 2);
    auto load_x = [&](uint4 (&xv)[INT8X ? 2 : 4], int q4) {
      const bool live = g < m && 64 * q4 + 16 * t < half;
#pragma unroll
      for (int i = 0; i < (INT8X ? 2 : 4); ++i)
        xv[i] = live ? __ldg(reinterpret_cast<const uint4*>(xs0 + (INT8X ? 128 : 256) * q4) + i)
                     : make_uint4(0u, 0u, 0u, 0u);
    };
    uint4 xv[2][INT8X ? 2 : 4];
    load_x(xv[0], 0);
    // Step (q4, q): word q of each lane's 16 bytes, in-rows 128 q4 + 32 t + 8 q .. + 7 of the
    // slice, against x row g's same in-rows (the products pair them in that order).
    // two sums per tile, of the even and the odd steps, halve the products' dependent chains
    Acc acc[2][2][4];
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][j][e] = 0;
#pragma unroll
    for (int q4 = 0; q4 < 4; ++q4) {
      if (64 * q4 >= half) break;
      if (q4 + 1 < 4) load_x(xv[(q4 + 1) & 1], q4 + 1);
      const uint4* xq = xv[q4 & 1];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint32_t w0 = word(wv[j][0][q4], q), w8 = word(wv[j][1][q4], q);
          if constexpr (INT8X) {  // x in-rows 8 q .. 8 q + 7: half of vector q / 2
            const uint32_t x0 = word(xq[q / 2], 2 * (q % 2)), x1 = word(xq[q / 2], 2 * (q % 2) + 1);
            mma_s8(acc[q & 1][j], lo16(w0), lo16(w8), hi16(w0), hi16(w8), evens(x0, x1),
                   odds(x0, x1));
          } else {  // x in-rows 8 q .. 8 q + 7: vector q
            const uint4 a0 = widen8(w0), a8 = widen8(w8);
            mma_bf16(acc[q & 1][j], a0.x, a8.x, a0.y, a8.y, xq[q].x, xq[q].y);
            mma_bf16(acc[q & 1][j], a0.z, a8.z, a0.w, a8.w, xq[q].z, xq[q].w);
          }
        }
      }
    }
    if constexpr (TILE_CTA) {
      tile_combine<INT8X>(acc, xs, ws, out, m, N, G, slices, n0, s, lane, g, t);
      return;
    }
    // the slice sums: d[e] is (weight row g + 8 (e >> 1), x row 2 t + (e & 1))
    if (t < 2) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 2 * t + (e & 1), n = n0 + 16 * j + g + 8 * (e >> 1);
          if (row < m && n < N) {
            Acc v = acc[0][j][e] + acc[1][j][e];
            __stcg(work + (static_cast<long long>(n) * m + row) * spad + s,
                   *reinterpret_cast<int*>(&v));
          }
        }
    }
    // the arrivals are counted once per run of units of one tile: the warp barrier puts every
    // lane's slice sums before lane 0's release
    ++run;
    if (u + 1 < u1 && (u + 1) / slices == tile) continue;
    __syncwarp();
    int last = 0;
    if (lane == 0) last = atom_add_acq_rel(arrivals + tile, run) + run == slices;
    __syncwarp();
    run = 0;
    if (!__shfl_sync(0xffffffffu, last, 0)) continue;
    // the tile's last slice: add its slices in order and scale, as the plain version does. Lane
    // l takes column n0 + l; every x row's slice sums of a batch (and the group scales the
    // batch's slices end) are loaded at once, as 16-byte vectors.
    const int n = n0 + lane;
    if (n < N) {
      const int per_group = G ? slices / G : slices;
      const int4* col = reinterpret_cast<const int4*>(work + static_cast<long long>(n) * m * spad);
      float y[kGemvRows];
      Acc sum[kGemvRows];  // of the current group (per channel: of all K)
#pragma unroll
      for (int r = 0; r < kGemvRows; ++r) y[r] = 0.f, sum[r] = 0;
      for (int s0 = 0; s0 < slices; s0 += kGemvBatch) {
        int4 v[kGemvRows][kGemvBatch / 4];
        float wg[kGemvBatch];
#pragma unroll
        for (int r = 0; r < kGemvRows; ++r)
#pragma unroll
          for (int i = 0; i < kGemvBatch / 4; ++i)
            v[r][i] = r < m && s0 + 4 * i < slices ? __ldcg(col + (r * spad + s0) / 4 + i)
                                                   : make_int4(0, 0, 0, 0);
#pragma unroll
        for (int i = 0; i < kGemvBatch; ++i) {
          const int si = s0 + i;
          wg[i] = G && si < slices && (si + 1) % per_group == 0
                      ? ws[static_cast<long long>((si + 1) / per_group - 1) * N + n]
                      : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kGemvBatch; ++i) {
          const int si = s0 + i;
          if (si >= slices) break;
          const bool ends = (si + 1) % per_group == 0;  // the slice ends a group
#pragma unroll
          for (int r = 0; r < kGemvRows; ++r) {
            const int4 q = v[r][i / 4];
            const int bits = i % 4 == 0 ? q.x : i % 4 == 1 ? q.y : i % 4 == 2 ? q.z : q.w;
            sum[r] += *reinterpret_cast<const Acc*>(&bits);
            if (!ends) continue;
            float gsum;  // the group's sum
            if constexpr (INT8X)
              gsum = static_cast<float>(sum[r] >> 4);
            else
              gsum = sum[r];
            y[r] = G ? __fadd_rn(y[r], __fmul_rn(gsum, wg[i])) : gsum;
            sum[r] = 0;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kGemvRows; ++r) {
        if (r >= m) break;
        float o = y[r];
        if constexpr (INT8X) o = __fmul_rn(o, xs[r]);
        if (!G) o = __fmul_rn(o, ws[n]);
        out[static_cast<long long>(r) * N + n] = __float2bfloat16(o);
      }
    }
    if (lane == 0) arrivals[tile] = 0;  // every slice of the tile is in: ready for the next call
  }
}

template <bool INT8X>
cudaError_t launch_gemv(const void* x, const float* xs, const uint8_t* wp, const float* ws,
                        bf16* out, int* work, int* arrivals, int m, int K, int N, int G,
                        int slice, int n_workers, int tile_ctas, cudaStream_t stream) {
  const uint8_t* xb = static_cast<const uint8_t*>(x);
  if (tile_ctas) {
    const int slices = K / slice;
    w4_gemv_kernel<INT8X, true><<<n_workers / slices, 32 * slices, 0, stream>>>(
        xb, xs, wp, ws, out, work, arrivals, m, K, N, G, slice, n_workers);
  } else {
    w4_gemv_kernel<INT8X, false><<<(n_workers + kGemvWarps - 1) / kGemvWarps, 32 * kGemvWarps,
                                   0, stream>>>(xb, xs, wp, ws, out, work, arrivals, m, K, N, G,
                                                slice, n_workers);
  }
  return cudaGetLastError();
}

template <bool INT8X>
cudaError_t launch(const void* x, const float* xs, const uint8_t* wp, const float* ws, bf16* out,
                   int* work, int* arrivals, int m, int K, int N, int G, int slice,
                   int n_workers, int tile_ctas, cudaStream_t stream) {
  if (m <= kGemvRows)
    return launch_gemv<INT8X>(x, xs, wp, ws, out, work, arrivals, m, K, N, G, slice, n_workers,
                              tile_ctas, stream);
  const int gsize = G ? K / G : K;
  if constexpr (INT8X) {
    const int8_t* xi = static_cast<const int8_t*>(x);
    return G ? launch_w4a8<true>(xi, xs, wp, ws, out, m, K, N, gsize, stream)
             : launch_w4a8<false>(xi, xs, wp, ws, out, m, K, N, gsize, stream);
  } else {
    const bf16* xb = static_cast<const bf16*>(x);
    return G ? launch_w4_bf16<true>(xb, wp, ws, out, m, K, N, gsize, stream)
             : launch_w4_bf16<false>(xb, wp, ws, out, m, K, N, gsize, stream);
  }
}

}  // namespace

// x: contiguous [m, K] int8 (int8x != 0, with xs fp32 [m]) or bf16 (xs ignored); wp: contiguous
// [N, K / 2] packed int4; ws: fp32 [N] (G == 0) or [G, N]; out: contiguous [m, N] bf16.
// K a multiple of 64, K / G a multiple of 64, N a multiple of 8; every pointer 16-byte aligned.
// m <= 4 takes the GEMV, partitioned by ops/w4_matmul.py::gemv_plan: `slice` in-rows per unit
// (64, 128, 256 or 512, dividing K / G), `n_workers` warps (at most the units), `tile_ctas` for
// one CTA per tile (every unit a warp, at most 8 slices), else `work` int32 [N, m, K / slice
// rounded up to 4] and `arrivals` int32 [ceil(N / 32)], zero before the first call and left
// zero by every call; larger m ignores those five. Returns a cudaError_t.
extern "C" int unimedvl_w4_matmul(const void* x, const void* xs, const void* wp, const void* ws,
                                  void* out, void* work, void* arrivals, int m, int K, int N,
                                  int G, int int8x, int slice, int n_workers, int tile_ctas,
                                  void* stream) {
  if (m <= 0 || K <= 0 || N <= 0 || K % kBKStep != 0 || N % 8 != 0 || G < 0 ||
      (G > 0 && (K % G != 0 || (K / G) % kBKStep != 0)) || (int8x && xs == nullptr) ||
      (N + kWRows - 1) / kWRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m <= kGemvRows) {
    const long long units = static_cast<long long>((N + kGemvCols - 1) / kGemvCols) * (K / slice);
    if ((!tile_ctas && (work == nullptr || arrivals == nullptr)) || n_workers < 1 ||
        n_workers > units || (tile_ctas && (n_workers != units || K / slice > kGemvWarps)) ||
        (slice != 64 && slice != 128 && slice != 256 && slice != kGemvMaxSlice) ||
        (G ? K / G : K) % slice != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xsf = static_cast<const float*>(xs);
  const uint8_t* wpb = static_cast<const uint8_t*>(wp);
  const float* wsf = static_cast<const float*>(ws);
  bf16* o = static_cast<bf16*>(out);
  int* wk = static_cast<int*>(work);
  int* ar = static_cast<int*>(arrivals);
  const cudaError_t rc =
      int8x ? launch<true>(x, xsf, wpb, wsf, o, wk, ar, m, K, N, G, slice, n_workers, tile_ctas,
                           st)
            : launch<false>(x, xsf, wpb, wsf, o, wk, ar, m, K, N, G, slice, n_workers, tile_ctas,
                            st);
  return static_cast<int>(rc);
}
