// The HBM floor of K4's GEMV (m <= 4) at the LLM's four projections: a kernel that only loads the
// packed weights, cold (CUDA graphs of 20 launches rotating over copies past twice the L2), in
// four access patterns: the GEMV's own (units of 32 weight rows x 256 bytes, each lane 2 x 2 rows
// x 64 bytes per unit, warps over contiguous runs of units, 16 an SM), the same units read as 2 x
// 256 or 4 x 128 bytes per instruction, and a half-warp per weight row walking the whole row.
// Nothing of the port uses it; it says how fast the weights can stream, apart from the products
// and the combine. Build and run on the card:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/gemv_stream_floor \
//       unimedvl_tpu_torch/tools/gemv_stream_floor.cu && build/gemv_stream_floor
//
// One line per (projection, pattern): ms per call, GB/s, and the bound (bytes / 3.35 TB/s).
#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>
#define CK(x)                                                             \
  do {                                                                     \
    cudaError_t e = (x);                                                   \
    if (e) {                                                               \
      printf("error %s at line %d\n", cudaGetErrorString(e), __LINE__);   \
      return 1;                                                            \
    }                                                                      \
  } while (0)

template <int P>
__global__ void __launch_bounds__(256, 2)
    pat(const uint8_t* __restrict__ w, int N, int R, int slice_b, int n_workers, unsigned* sink) {
  int worker = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (worker >= n_workers) return;
  int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  int slices = R / slice_b, tiles = N / 32;
  long long units = (long long)tiles * slices;
  int u0 = units * worker / n_workers, u1 = units * (worker + 1) / n_workers;
  unsigned acc = 0;
  for (int u = u0; u < u1; ++u) {
    int tile = u / slices, s = u - tile * slices;
    const uint8_t* base = w + (long long)tile * 32 * R + s * slice_b;
    uint4 v[16];
    if (P == 0) {  // fragment layout: rows g, g+8 of 2 tiles, 64-byte groups, lanes t 16 B
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            v[j * 8 + h * 4 + q] = __ldcs(
                (const uint4*)(base + (long long)(16 * j + 8 * h + g) * R + 64 * q + 16 * t));
    } else if (P == 1) {  // full lines: 2 rows x 256 B per instruction
#pragma unroll
      for (int i = 0; i < 16; ++i)
        v[i] = __ldcs(
            (const uint4*)(base + (long long)(2 * i + (lane >> 4)) * R + 16 * (lane & 15)));
    } else {  // 4 rows x 128 B per instruction
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        int r = 4 * (i & 7) + (lane >> 3);
        v[i] = __ldcs((const uint4*)(base + (long long)r * R + 128 * (i >> 3) + 16 * (lane & 7)));
      }
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) acc ^= v[i].x ^ v[i].y ^ v[i].z ^ v[i].w;
  }
  if (acc == 0x12345678u) sink[worker] = acc;
}

// a half-warp per weight row, the whole row, four loads in flight
__global__ void __launch_bounds__(256)
    rows(const uint8_t* __restrict__ w, int N, int R, unsigned* sink) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, hl = lane & 15;
  int n = (blockIdx.x * 8 + warp) * 2 + (lane >> 4);
  if (n >= N) return;
  const uint4* wr = (const uint4*)(w + (long long)n * R);
  unsigned acc = 0;
#pragma unroll 4
  for (int c = hl; c < R / 16; c += 16) { uint4 v = __ldg(wr + c); acc ^= v.x ^ v.y ^ v.z ^ v.w; }
  if (acc == 0x12345678u) sink[n] = acc;
}

int main() {
  int shapes[4][2] = {{4608, 1792}, {3584, 1792}, {37888, 1792}, {3584, 9472}};
  const char* names[4] = {"qkv", "o", "gate_up", "down"};
  unsigned* sink; CK(cudaMalloc(&sink, 1 << 24));
  cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
  for (int si = 0; si < 4; ++si) {
    int N = shapes[si][0], R = shapes[si][1];
    size_t bytes = (size_t)N * R;
    int copies = (int)((100e6 + bytes - 1) / bytes); if (copies < 2) copies = 2;
    uint8_t* w; CK(cudaMalloc(&w, bytes * copies)); CK(cudaMemset(w, 1, bytes * copies));
    for (int p = 0; p < 4; ++p) {
      const int slice_b = 256;
      const long long units = (long long)(N / 32) * (R / slice_b);
      const int nw = units < 2112 ? (int)units : 2112;  // 16 warps on each of 132 SMs
      cudaStream_t st;
      cudaStreamCreate(&st);
      cudaGraph_t gr;
      cudaGraphExec_t ge;
      CK(cudaStreamBeginCapture(st, cudaStreamCaptureModeGlobal));
      for (int i = 0; i < 20; ++i) {
        const uint8_t* wi = w + (size_t)(i % copies) * bytes;
        if (p == 0) pat<0><<<(nw + 7) / 8, 256, 0, st>>>(wi, N, R, slice_b, nw, sink);
        else if (p == 1) pat<1><<<(nw + 7) / 8, 256, 0, st>>>(wi, N, R, slice_b, nw, sink);
        else if (p == 2) pat<2><<<(nw + 7) / 8, 256, 0, st>>>(wi, N, R, slice_b, nw, sink);
        else rows<<<(N + 15) / 16, 256, 0, st>>>(wi, N, R, sink);
      }
      CK(cudaStreamEndCapture(st, &gr));
      CK(cudaGraphInstantiate(&ge, gr, 0));
      for (int i = 0; i < 3; ++i) cudaGraphLaunch(ge, st);
      cudaEventRecord(a, st);
      for (int i = 0; i < 10; ++i) cudaGraphLaunch(ge, st);
      cudaEventRecord(b, st);
      CK(cudaEventSynchronize(b));
      float ms;
      cudaEventElapsedTime(&ms, a, b);
      const char* pn[4] = {"GEMV units 8 x 64 B", "units, 2 x 256 B", "units, 4 x 128 B",
                           "half-warp per row"};
      printf("%-8s %-20s %.5f ms per call, %.0f GB/s (bound %.5f ms)\n", names[si], pn[p],
             ms / 200, bytes / (ms / 200 * 1e-3) / 1e9, bytes / 3.35e12 * 1e3);
      cudaGraphExecDestroy(ge); cudaGraphDestroy(gr); cudaStreamDestroy(st);
    }
    cudaFree(w);
  }
  return 0;
}
