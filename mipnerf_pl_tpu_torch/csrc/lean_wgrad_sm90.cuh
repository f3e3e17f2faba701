// The weight-gradient products of the bf16 training backwards on Hopper's
// wgmma and TMA (lean_train.cu, tp_pair.cu), beside lean_wgrad.cuh's
// mma.sync kernel, which keeps the f32 products (3xTF32 with FLUSH) and the
// point-major activations of 'hybrid'.
//
// dW = A^T G over the points: A (activation rows) and G (cotangent rows)
// are both channel-major [C][Mp] with the points contiguous, so both are
// K-major wgmma operands, read straight from the streams by TMA.  One block
// computes one 128 x 128 output tile over one MC-point range (the same
// tiles, ranges and per-range partial sums as lean_wgrad_kernel, so every
// mode sums the same ranges in the same order): a producer warp keeps a
// 4-stage ring of 64-point slabs in flight (two 64 x 64 boxes of A rows and
// two of G rows a stage, 32 KB), two consumer warpgroups each multiply their
// 64 rows on m64n128k16, the accumulators stay in registers and go out as
// the range's partial sums.  Deterministic: fixed order, no atomics.  Rows
// of a tile past its problem read other rows of the streams (or zero past
// them); their products are not written.
//
// What bounds it: a lego level's products are ~0.42 TFLOP (0.43 ms at the
// bf16 peak) over ~3.7 GB of S and G rows (1.1 ms at 3.35 TB/s), so HBM;
// each block re-reads its A rows for every 128 G columns from L2.

#pragma once

#include "lean_wgrad.cuh"
#include "sm90.cuh"

namespace {

constexpr int WS_THREADS = 288;          // two consumer warpgroups + a producer warp
constexpr int WS_STAGES = 4;
constexpr int WS_KP = 64;                // points a stage
constexpr int WS_BOX = 64 * 64 * 2;      // bytes of one 64-row x 64-point box

struct WgradMaps {
  CUtensorMap a;   // the activation stream [a_rows][Mp]
  CUtensorMap g;   // the cotangents [g_rows][Mp]
};

// a_row[a]: activation a's first row in the stream of WgradMaps::a.
struct WgradRows {
  int a_row[MAX_LAYERS];
};

__host__ __device__ constexpr size_t wgrad_sm90_smem() {
  return (size_t)WS_STAGES * 4 * WS_BOX + 2 * WS_STAGES * sizeof(uint64_t) + 1024;
}

__global__ void __launch_bounds__(WS_THREADS, 1)
wgrad_sm90_kernel(const __grid_constant__ WgradMaps maps, WgradTable tab, WgradRows ar, int Mp,
                  int MC, float* __restrict__ partial, int PW) {
  extern __shared__ uint8_t ws_raw[];
  uint8_t* smem = ws_raw + ((1024 - (smem_u32(ws_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + WS_STAGES * 4 * WS_BOX);
  uint64_t* empty = full + WS_STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int* pr = tab.prob[tab.tile[blockIdx.x][0]];
  const int K = pr[1], g_row0 = pr[2], n = pr[3], out_off = pr[4], n_ld = pr[5];
  const int r0 = tab.tile[blockIdx.x][1], c0 = tab.tile[blockIdx.x][2];
  const int p0 = blockIdx.y * MC, p1 = min(p0 + MC, Mp);
  const int steps = (p1 - p0) / WS_KP;
  if (tid == 0) {
    for (int s = 0; s < WS_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {   // producer
    if (lane == 0) {
      const int arow = ar.a_row[pr[0]] + r0, grow = g_row0 + c0;
      for (int k = 0; k < steps; ++k) {
        const int s = k % WS_STAGES;
        mbar_wait(empty + s, ((k / WS_STAGES) & 1) ^ 1);
        mbar_expect_tx(full + s, 4 * WS_BOX);
        uint8_t* st = smem + s * 4 * WS_BOX;
        const int pt = p0 + k * WS_KP;
        tma_load_2d(st, &maps.a, full + s, pt, arow);
        tma_load_2d(st + WS_BOX, &maps.a, full + s, pt, arow + 64);
        tma_load_2d(st + 2 * WS_BOX, &maps.g, full + s, pt, grow);
        tma_load_2d(st + 3 * WS_BOX, &maps.g, full + s, pt, grow + 64);
      }
    }
    return;
  }

  // Consumer warpgroup wg: output rows 64 wg + [0, 64) of the tile.
  const int wg = warp >> 2, wi = warp & 3, g = lane >> 2, q = lane & 3;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int k = 0; k < steps; ++k) {
    const int s = k % WS_STAGES;
    mbar_wait(full + s, (k / WS_STAGES) & 1);
    const uint32_t a_addr = smem_u32(smem + s * 4 * WS_BOX + wg * WS_BOX);
    const uint32_t b_addr = smem_u32(smem + s * 4 * WS_BOX + 2 * WS_BOX);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WS_KP / 16; ++kk)
      wgmma_ss_m64n128(acc, sw128_desc(a_addr + 32 * kk), sw128_desc(b_addr + 32 * kk), 1);
    wgmma_commit();
    // The stage before is released once this one's products are issued
    // and its own are complete.
    wgmma_wait1();
    fence_regs(acc);
    if (k > 0 && lane == 0) mbar_arrive(empty + (k - 1) % WS_STAGES);
  }
  wgmma_wait0();
  fence_regs(acc);
  // Accumulator (n8 block j, element e): row 16 wi + g + 8 (e >> 1), column
  // 8 j + 2 q + (e & 1).
  float* dst = partial + (size_t)blockIdx.y * PW + out_off;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + 64 * wg + 16 * wi + g + 8 * (e >> 1);
      const int col = c0 + 8 * j + 2 * q + (e & 1);
      if (row < K && col < n) dst[(size_t)row * n_ld + col] = acc[j * 4 + e];
    }
}

// The weight gradients of one chunk on wgmma: activation a's rows start at
// row a_row[a] of the bf16 stream a_base [a_rows][Mp], the cotangents are G
// [g_rows][Mp]; tiles, MC and partial as lean_wgrad_kernel takes them.  0
// or a cudaError_t (cudaErrorInvalidValue if a tensor map cannot be made).
inline int launch_wgrad_sm90(const void* a_base, int a_rows, const int* a_row, int n_acts,
                             const void* G, int g_rows, const WgradTable& tab, int n_tiles, int Mp,
                             int MC, float* partial, int PW, cudaStream_t s) {
  WgradMaps maps;
  if (n_acts > MAX_LAYERS || Mp % WS_KP || MC % WS_KP ||
      !make_map(&maps.a, a_base, a_rows, Mp, Mp, 64) ||
      !make_map(&maps.g, G, g_rows, Mp, Mp, 64))
    return (int)cudaErrorInvalidValue;
  WgradRows ar{};
  for (int a = 0; a < n_acts; ++a) ar.a_row[a] = a_row[a];
  const size_t smem = wgrad_sm90_smem();
  cudaError_t e = cudaFuncSetAttribute(wgrad_sm90_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  wgrad_sm90_kernel<<<dim3(n_tiles, (Mp + MC - 1) / MC), WS_THREADS, smem, s>>>(maps, tab, ar, Mp,
                                                                               MC, partial, PW);
  return (int)cudaGetLastError();
}

}  // namespace
