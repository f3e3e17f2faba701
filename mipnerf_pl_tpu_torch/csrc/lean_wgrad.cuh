// What the weight-gradient products of the training backwards (lean_train.cu,
// tp_pair.cu) share: dW = A^T G over the points as split-K tensor-core
// products with per-range partial sums, then the in-order reduction of
// those sums.  Deterministic: fixed summation orders, no atomics.
//
// Every backward reads channel-major rows [width][Mp], the points
// contiguous, so A and G are both K-major operands: bf16 runs on
// lean_wgrad_sm90.cuh (wgmma + TMA), f32 on lean_wgrad_tf32.cuh (3xTF32).

#pragma once

#include "lean_engines.cuh"

namespace {

constexpr int MAX_LAYERS = MAX_PARAMS / 2;
constexpr int MAX_PROBS = 32;
constexpr int MAX_TILES = 192;
constexpr int BM = 128, BN = 128;   // output tile of a problem
constexpr int KC = 32;               // points: a range is a multiple of them

// The saved activations as the backward reads them: activation a is t[a],
// channel-major [width][ld[a]] (rows of S, ld[a] = Mp of the chunk).
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
