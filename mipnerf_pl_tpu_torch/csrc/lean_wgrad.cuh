// The weight-gradient products of the training backwards (lean_train.cu,
// tp_pair.cu): dW = A^T G over the points as split-K tensor-core products
// with per-range partial sums, and the in-order reduction of those sums.
// Deterministic: fixed summation orders, no atomics.
//
// lean_wgrad_kernel (mma.sync) keeps the point-major activations of
// 'hybrid' (lean_param_grads_hybrid), in both dtypes: its A is [M][width],
// MN-major for dW = A^T G, which wgmma reads for 16-bit types only
// (transposed) and for tf32 not at all.  Every channel-major stream runs on
// wgmma and TMA: bf16 on lean_wgrad_sm90.cuh, f32 on lean_wgrad_tf32.cuh
// (3xTF32).

#pragma once

#include "lean_engines.cuh"

namespace {

constexpr int MAX_LAYERS = MAX_PARAMS / 2;
constexpr int MAX_PROBS = 32;
constexpr int MAX_TILES = 192;
constexpr int BM = 128, BN = 128, KC = 32;   // wgrad block tile, points per stage
// Tensor-core accumulation rounds toward zero, so its error grows with the
// number of products summed in the accumulator (~1e-4 relative after the
// ~15k points of one range).  In f32, every FLUSH stages the accumulators
// are added into round-to-nearest f32 sums on the CUDA cores and restarted
// (~3 % of the kernel's time; in bf16 it would cost ~45 % against an error
// far below bf16's own).
constexpr int FLUSH = 4;
constexpr int WGRAD_ACC = 64;                // accumulators per thread

// The saved activations as the backward reads them: activation a is t[a],
// channel-major [width][Mp] (S rows; ld[a] = Mp) or point-major [M][ld[a]]
// (hybrid, the only form lean_wgrad_kernel reads).
struct Acts {
  const void* t[MAX_LAYERS];
  int ld[MAX_LAYERS];
};

// Weight-gradient problems: dW[out_off + row * n_ld + col] (rows < K,
// cols < n) = sum over points of A[row] * G[g_row0 + col], A = activation a.
struct WgradTable {
  int prob[MAX_PROBS][6];   // a, K, g_row0, n, out_off, n_ld
  int tile[MAX_TILES][3];   // problem, row0, col0 of a BM x BN output tile
};

// blockIdx.x: output tile; blockIdx.y: point range [y * MC, (y + 1) * MC)
// of the chunk, whose partial sums go to partial row y.  B tile [BN
// cols][KC points] and the point-major A tile [KC points][BM rows] in
// shared memory, A read by transposed fragments; 8 warps as 2 x 4, each a
// 64 x 32 output tile.  The next stage's loads are issued into registers
// before the current stage's products.  In f32, dynamic shared memory
// holds each thread's round-to-nearest sums, [WGRAD_ACC][THREADS].
template <typename T>
__global__ void __launch_bounds__(THREADS)
lean_wgrad_kernel(Acts acts, const T* __restrict__ G, WgradTable tab, int Mp, int M, int MC,
                  float* __restrict__ partial, int PW) {
  extern __shared__ float tot[];
  constexpr bool BF = sizeof(T) == 2;
  constexpr int LDS = KC + (BF ? 8 : 4);     // padded rows: conflict-free fragments
  constexpr int LDT = BM + 8;                // the same for the point-major A tile
  constexpr int VEC = 16 / sizeof(T), PER_ROW = KC / VEC, PM_ROW = BM / VEC;
  constexpr int LOADS = BM * PER_ROW / THREADS;
  static_assert(BM == BN && BM * PER_ROW % THREADS == 0 && KC * PM_ROW == BM * PER_ROW,
                "tile loads");
  __shared__ __align__(16) T As[KC * LDT];
  __shared__ __align__(16) T Bs[BN * LDS];
  const int* pr = tab.prob[tab.tile[blockIdx.x][0]];
  const int K = pr[1], g_row0 = pr[2], n = pr[3], out_off = pr[4], n_ld = pr[5];
  const T* A = static_cast<const T*>(acts.t[pr[0]]);
  const int lda = acts.ld[pr[0]];
  const int r0 = tab.tile[blockIdx.x][1], c0 = tab.tile[blockIdx.x][2];
  const int p0 = blockIdx.y * MC, p1 = min(p0 + MC, Mp);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1, g = lane >> 2, t = lane & 3;

  float acc[4][4][4];
  // f32: acc -> tot (round to nearest), acc restarts from zero.
  auto flush = [&](bool first) {
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!BF) {
            float& t = tot[((a * 4 + b) * 4 + e) * THREADS + tid];
            t = first ? 0.f : t + acc[a][b][e];
          }
          if (first || !BF) acc[a][b][e] = 0.f;
        }
  };
  flush(true);
  uint4 ra[LOADS], rb[LOADS];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int v = tid + i * THREADS, row = v / PER_ROW, c = (v - row * PER_ROW) * VEC;
      const int pt = v / PM_ROW, ch = (v - pt * PM_ROW) * VEC;
      const uint4 zero = make_uint4(0, 0, 0, 0);
      ra[i] = k0 + pt < M && r0 + ch < lda
                  ? *reinterpret_cast<const uint4*>(A + (size_t)(k0 + pt) * lda + r0 + ch)
                  : zero;
      rb[i] = c0 + row < n
                  ? *reinterpret_cast<const uint4*>(G + (size_t)(g_row0 + c0 + row) * Mp + k0 + c)
                  : zero;
    }
  };
  fetch(p0);
  for (int k0 = p0, stage = 1; k0 < p1; k0 += KC, ++stage) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int v = tid + i * THREADS, row = v / PER_ROW, c = (v - row * PER_ROW) * VEC;
      const int pt = v / PM_ROW, ch = (v - pt * PM_ROW) * VEC;
      *reinterpret_cast<uint4*>(As + pt * LDT + ch) = ra[i];
      *reinterpret_cast<uint4*>(Bs + row * LDS + c) = rb[i];
    }
    __syncthreads();
    if (k0 + KC < p1) fetch(k0 + KC);
    if constexpr (BF) {
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        // A (m16 x k16, row-major): ldmatrix transposed from [k][row]; B
        // (k16 x n8, stored [n][k]) without transpose.
        uint32_t a[4][4], b[2][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          ldmatrix_x4_trans(a[mt], reinterpret_cast<const bf16*>(As) +
                                       (kk + (lane & 7) + 8 * (lane >> 4)) * LDT + 64 * wm +
                                       16 * mt + 8 * ((lane >> 3) & 1));
#pragma unroll
        for (int np = 0; np < 2; ++np)
          ldmatrix_x4(b[np], reinterpret_cast<const bf16*>(Bs) +
                                 (32 * wn + 16 * np + (lane & 7) + 8 * (lane >> 4)) * LDS + kk +
                                 8 * ((lane >> 3) & 1));
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_bf16(acc[mt][nt], a[mt], b[nt >> 1][2 * (nt & 1)], b[nt >> 1][2 * (nt & 1) + 1]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < KC; kk += 8) {
        uint32_t ahi[4][4], alo[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          // Fragment (row g | g + 8, k t | t + 4).
          const float* s0 = reinterpret_cast<const float*>(As) + (kk + t) * LDT + 64 * wm +
                            16 * mt + g;
          split_tf32(s0[0], ahi[mt][0], alo[mt][0]);
          split_tf32(s0[8], ahi[mt][1], alo[mt][1]);
          split_tf32(s0[4 * LDT], ahi[mt][2], alo[mt][2]);
          split_tf32(s0[8 + 4 * LDT], ahi[mt][3], alo[mt][3]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float* b = reinterpret_cast<const float*>(Bs) + (32 * wn + 8 * nt + g) * LDS + kk + t;
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(b[0], bh0, bl0);
          split_tf32(b[4], bh1, bl1);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
            mma_3xtf32(acc[mt][nt], ahi[mt], alo[mt], bh0, bl0, bh1, bl1);
        }
      }
    }
    if (!BF && stage % FLUSH == 0) flush(false);
    __syncthreads();
  }
  if (!BF) flush(false);
  float* dst = partial + (size_t)blockIdx.y * PW + out_off;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + 64 * wm + 16 * mt + g + 8 * (e >> 1);
        const int col = c0 + 32 * wn + 8 * nt + 2 * t + (e & 1);
        if (row < K && col < n)
          dst[(size_t)row * n_ld + col] =
              BF ? acc[mt][nt][e] : tot[((mt * 4 + nt) * 4 + e) * THREADS + tid];
      }
}

// out[i] = sum over r of in[r][i], r in order.
__global__ void sum_rows_kernel(const float* __restrict__ in, int rows, int cols,
                                float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cols) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += in[(size_t)r * cols + i];
  out[i] = s;
}

}  // namespace
