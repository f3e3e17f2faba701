// The weight-gradient products of the f32 training backwards on Hopper's
// wgmma and TMA, 3xTF32 (lean_train.cu run_grads: lean_param_grads, its
// recompute form, hybrid's backward (the same entry on the stream its plain
// forward writes) and the render-fused level's backward, the classic
// mlp_bwd_saved / mlp_bwd_recompute; tp_pair.cu: tp_pair_bwd), the
// f32 counterpart of lean_wgrad_sm90.cuh: in f32, the weight-gradient sums
// of the TPU kernels _bwd_kernel_lean_save, _bwd_kernel_lean,
// _bwd_kernel_lean_hybrid, _bwd_kernel_lean_render, _bwd_kernel and
// _bwd_kernel_saved (mipnerf_pl_tpu/kernels/mlp.py) and _pair_bwd_kernel
// (kernels/tp_lean.py).
//
// dW = A^T G over the points: the activation rows A and the cotangent rows
// G are both channel-major [C][Mp] with the points contiguous, so both are
// K-major operands, the only layout wgmma reads tf32 in.  The contract is
// lean_wgrad.cuh's, so every mode sums the same ranges in the same
// order: the WgradTable problems and 128 x 128 output tiles, one block a
// tile and MC-point range, the range's sums to its own partial row (reduced
// in order by sum_rows_kernel).  Deterministic: fixed order, no atomics.
//
// Route (wgrad_tf32_takes, C entry wgrad_tf32_route, mirrored by
// kernels/mlp.py wgrad_tf32_route): f32, Mp and MC multiples of the
// WT_KP-point slab.  A tensor map it cannot make is an
// error (launch_wgrad_tf32 returns cudaErrorInvalidValue), never another
// kernel.
//
// Design.  256 threads, two consumer warpgroups, no producer warp: a 9-warp
// block gets 168 registers a thread, 8 warps up to 255, and the 64
// accumulators, the 64 restart sums and two sets of split fragments take
// 211.  Thread 0 keeps a ring of WT_STAGES slabs of WT_KP = 32 points in
// flight by TMA, each two 64-row x 128-byte f32 boxes (the 128-byte
// swizzle) of the register operand's 128 rows and two of the shared
// operand's 128 rows, and refills a slot after the block barrier that ends
// its stage.  3xTF32 (D += A_lo B_hi + A_hi B_lo + A_hi B_hi, small terms
// first, as the forward), 12 wgmma m64n128k8 a warpgroup and stage:
//   the register operand (WT_GA: the G rows, and the block computes
//     dW^T; else the activation rows): each warpgroup's 64 rows are
//     loaded from the swizzled slab into the wgmma A fragments and split
//     with cvt.rna.tf32 (split_tf32: hi rounded to nearest, lo rounded);
//   the shared operand (the other 128 rows, B): hi is the slab as TMA
//     landed it (the tensor core reads an f32 word as tf32 by ignoring its
//     low 13 bits, so hi is the word truncated), lo = x - trunc(x) (exact),
//     written by all 256 threads at the same swizzled offsets into one of
//     WT_LO lo buffers.  No second G stream crosses HBM.
// While a stage's products run, the threads write the next stage's lo and
// load and split its fragments into the other register set.
// Accuracy: tensor-core accumulation rounds toward zero, so the
// accumulators restart every WT_RESTART stages (128 points) and are added
// into round-to-nearest f32 sums held in registers (tot).  Over one lego
// range (~15k points) the emulated 3xTF32 sum drifts to 1.4e-4 relative
// without restarts and stays at 1.2e-6 with them
// (tests/test_torch_kernels.py test_wgrad_tf32_numerics).
//
// What bounds it: a lego level's products are 0.477 TFLOP (2.89 ms at the
// 3xTF32 rate, 165 TFLOP/s) over ~7.8 GB of f32 activation and G rows read
// once (2.33 ms at 3.35 TB/s): the products.  What holds it back is shared
// memory: per stage a block's wgmma read 96 KB of B (hi twice, lo once, for
// each warpgroup), TMA writes 32 KB, the fragments read 16 KB and the lo
// pass moves 32 KB, ~1,400 cycles at 128 bytes a cycle against ~1,540 of
// products at the tensor rate.  Measured forms (NVIDIA H100 80GB HBM3, 700
// W; split_fwd_kernels.py --wgrad, PERF.md): the G rows in registers read
// 1-2 % faster than the activation rows in four calls; products of two
// stages in flight (wgmma.wait_group 1, three lo buffers), a 4-stage ring
// and restarts every 256 or 512 points are within the calls' noise; with
// the lo pass or the register split switched off it is 9-11 % faster.

#pragma once

#include "lean_wgrad_sm90.cuh"

namespace {

constexpr int WT_THREADS = 256;           // two consumer warpgroups
constexpr int WT_STAGES = 5;              // TMA ring
constexpr int WT_KP = 32;                 // points a stage: one 128-byte f32 row
constexpr int WT_BOX = 64 * WT_KP * 4;    // one 64-row box, 8 KB
constexpr int WT_STAGE = 4 * WT_BOX;      // register operand | shared operand
constexpr int WT_RESTART = 4;             // stages between accumulator restarts
constexpr bool WT_GA = true;              // the G rows are the register operand
constexpr int WT_INFLIGHT = 1;            // stages of products in flight
constexpr int WT_LO = WT_INFLIGHT + 1;    // lo buffers

// Launches of wgrad_tf32_kernel by this library (wgrad_tf32_launches).
long long g_wgrad_tf32_launches = 0;

// The ring, the lo buffers (128 rows each), the ring's mbarriers, 1 KB of
// alignment.
__host__ __device__ constexpr size_t wgrad_tf32_smem() {
  return (size_t)WT_STAGES * WT_STAGE + WT_LO * 2 * WT_BOX + WT_STAGES * sizeof(uint64_t) + 1024;
}

// The shapes the kernel takes (f32 and a channel-major stream are the
// caller's).
inline bool wgrad_tf32_takes(int Mp, int MC) {
  return Mp > 0 && MC > 0 && Mp % WT_KP == 0 && MC % WT_KP == 0;
}

// x with its low 13 bits cleared: the tf32 the tensor core reads from x.
__device__ __forceinline__ float tf32_trunc(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

__global__ void __launch_bounds__(WT_THREADS, 1)
wgrad_tf32_kernel(const __grid_constant__ WgradMaps maps, WgradTable tab, WgradRows ar, int Mp,
                  int MC, float* __restrict__ partial, int PW) {
  extern __shared__ uint8_t wt_raw[];
  uint8_t* smem = wt_raw + ((1024 - (smem_u32(wt_raw) & 1023)) & 1023);
  uint8_t* lo_buf = smem + WT_STAGES * WT_STAGE;   // [WT_LO][128 rows x WT_KP]
  uint64_t* full = reinterpret_cast<uint64_t*>(lo_buf + WT_LO * 2 * WT_BOX);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int* pr = tab.prob[tab.tile[blockIdx.x][0]];
  const int K = pr[1], g_row0 = pr[2], n = pr[3], out_off = pr[4], n_ld = pr[5];
  const int r0 = tab.tile[blockIdx.x][1], c0 = tab.tile[blockIdx.x][2];
  const int p0 = blockIdx.y * MC, p1 = min(p0 + MC, Mp);
  const int steps = (p1 - p0) / WT_KP;
  const int arow = ar.a_row[pr[0]] + r0, grow = g_row0 + c0;
  const CUtensorMap* rmap = WT_GA ? &maps.g : &maps.a;
  const CUtensorMap* bmap = WT_GA ? &maps.a : &maps.g;
  const int rrow = WT_GA ? grow : arow, brow = WT_GA ? arow : grow;
  if (tid == 0) {
    for (int s = 0; s < WT_STAGES; ++s) mbar_init(full + s, 1);
    mbar_fence_init();
  }
  __syncthreads();
  // Stage k's slab into slot k % WT_STAGES (thread 0).
  auto issue = [&](int k) {
    const int s = k % WT_STAGES, pt = p0 + k * WT_KP;
    uint8_t* st = smem + s * WT_STAGE;
    mbar_expect_tx(full + s, WT_STAGE);
    tma_load_2d(st, rmap, full + s, pt, rrow);
    tma_load_2d(st + WT_BOX, rmap, full + s, pt, rrow + 64);
    tma_load_2d(st + 2 * WT_BOX, bmap, full + s, pt, brow);
    tma_load_2d(st + 3 * WT_BOX, bmap, full + s, pt, brow + 64);
  };
  if (tid == 0)
    for (int k = 0; k < steps && k < WT_STAGES; ++k) issue(k);
  // The lo of stage k's shared operand into lo buffer k % WT_LO: 16 bytes a
  // thread and step, at the slab's own (swizzled) offsets.
  auto split_lo = [&](int k) {
    const float4* src =
        reinterpret_cast<const float4*>(smem + (k % WT_STAGES) * WT_STAGE + 2 * WT_BOX);
    float4* dst = reinterpret_cast<float4*>(lo_buf + (k % WT_LO) * 2 * WT_BOX);
    constexpr int PER = 2 * WT_BOX / 16 / WT_THREADS;
    float4 v[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) v[i] = src[tid + i * WT_THREADS];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      v[i].x -= tf32_trunc(v[i].x);
      v[i].y -= tf32_trunc(v[i].y);
      v[i].z -= tf32_trunc(v[i].z);
      v[i].w -= tf32_trunc(v[i].w);
      dst[tid + i * WT_THREADS] = v[i];
    }
  };

  // Warpgroup wg: register-operand rows 64 wg + [0, 64) of the tile.
  const int wg = warp >> 2, wi = warp & 3, g = lane >> 2, t = lane & 3;
  // The A fragments of stage k's four k8 steps: rows 16 wi + g (+ 8) of
  // the warpgroup's box, points 8 kk + t (+ 4); in the 128-byte swizzle,
  // point p of row r is float 32 r + 4 ((p / 4) ^ (r % 8)) + p % 4, and
  // r % 8 = g.
  auto load_a = [&](int k, uint32_t(&ah)[4][4], uint32_t(&al)[4][4]) {
    const float* row0 = reinterpret_cast<const float*>(smem + (k % WT_STAGES) * WT_STAGE +
                                                       wg * WT_BOX) +
                        32 * (16 * wi + g);
    const float* row1 = row0 + 32 * 8;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int ca = 4 * ((2 * kk) ^ g) + t, cb = 4 * ((2 * kk + 1) ^ g) + t;
      split_tf32(row0[ca], ah[kk][0], al[kk][0]);
      split_tf32(row1[ca], ah[kk][1], al[kk][1]);
      split_tf32(row0[cb], ah[kk][2], al[kk][2]);
      split_tf32(row1[cb], ah[kk][3], al[kk][3]);
    }
  };
  float acc[64], tot[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = tot[i] = 0.f;
  // Stage k's products from the fragments (ah, al), and the next stage's
  // lo and fragments (nh, nl) while they run; with WT_INFLIGHT 2 they run
  // on beside the next stage's until the accumulators restart.
  auto stage = [&](int k, uint32_t(&ah)[4][4], uint32_t(&al)[4][4], uint32_t(&nh)[4][4],
                   uint32_t(&nl)[4][4]) {
    const uint32_t bh = smem_u32(smem + (k % WT_STAGES) * WT_STAGE + 2 * WT_BOX);
    const uint32_t bl = smem_u32(lo_buf + (k % WT_LO) * 2 * WT_BOX);
    const int keep = k % WT_RESTART != 0;   // 0: the accumulators restart
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dh = sw128_desc(bh + 32 * kk), dl = sw128_desc(bl + 32 * kk);
      wgmma_tf32_m64n128(acc, al[kk], dh, keep || kk > 0);
      wgmma_tf32_m64n128(acc, ah[kk], dl, 1);
      wgmma_tf32_m64n128(acc, ah[kk], dh, 1);
    }
    wgmma_commit();
    if (k + 1 < steps) {
      mbar_wait(full + (k + 1) % WT_STAGES, ((k + 1) / WT_STAGES) & 1);
      split_lo(k + 1);
      fence_proxy_async();
    }
    // (nh, nl) are free once the products before these are complete.
    if (WT_INFLIGHT > 1) wgmma_wait1();
    if (k + 1 < steps) load_a(k + 1, nh, nl);
    const bool restart = (k + 1) % WT_RESTART == 0 || k + 1 == steps;
    if (WT_INFLIGHT == 1 || restart) {
      wgmma_wait0();
      fence_regs(acc);
    }
    if (restart) {
#pragma unroll
      for (int i = 0; i < 64; ++i) tot[i] += acc[i];
    }
    // Stage k + 1 - WT_INFLIGHT is complete in both warpgroups, so its slot
    // is free; the next stage's lo is written.
    __syncthreads();
    const int done = k + 1 - WT_INFLIGHT;
    if (tid == 0 && done >= 0 && done + WT_STAGES < steps) {
      fence_proxy_async();
      issue(done + WT_STAGES);
    }
  };
  uint32_t f0h[4][4], f0l[4][4], f1h[4][4], f1l[4][4];
  mbar_wait(full, 0);
  split_lo(0);
  fence_proxy_async();
  load_a(0, f0h, f0l);
  __syncthreads();
  for (int k = 0; k < steps; k += 2) {
    stage(k, f0h, f0l, f1h, f1l);
    if (k + 1 < steps) stage(k + 1, f1h, f1l, f0h, f0l);
  }
  // Accumulator (n8 block j, element e): register-operand row 16 wi + g +
  // 8 (e >> 1) of the warpgroup's 64, shared-operand row 8 j + 2 t + (e & 1).
  float* dst = partial + (size_t)blockIdx.y * PW + out_off;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 64 * wg + 16 * wi + g + 8 * (e >> 1), jc = 8 * j + 2 * t + (e & 1);
      const int row = r0 + (WT_GA ? jc : i), col = c0 + (WT_GA ? i : jc);
      if (row < K && col < n) dst[(size_t)row * n_ld + col] = tot[j * 4 + e];
    }
}

// The f32 weight gradients of one chunk: activation a's rows start at row
// a_row[a] of the f32 stream a_base [a_rows][Mp], the cotangents are G
// [g_rows][Mp]; tiles, MC and partial as lean_wgrad.cuh describes them.
// 0 or a cudaError_t (cudaErrorInvalidValue for shapes outside the route or
// a tensor map that cannot be made).
inline int launch_wgrad_tf32(const void* a_base, int a_rows, const int* a_row, int n_acts,
                             const void* G, int g_rows, const WgradTable& tab, int n_tiles, int Mp,
                             int MC, float* partial, int PW, cudaStream_t s) {
  WgradMaps maps;
  if (n_acts > MAX_LAYERS || !wgrad_tf32_takes(Mp, MC) ||
      !make_map(&maps.a, a_base, a_rows, Mp, Mp, 64, CU_TENSOR_MAP_SWIZZLE_128B, true, WT_KP) ||
      !make_map(&maps.g, G, g_rows, Mp, Mp, 64, CU_TENSOR_MAP_SWIZZLE_128B, true, WT_KP))
    return (int)cudaErrorInvalidValue;
  WgradRows ar{};
  for (int a = 0; a < n_acts; ++a) ar.a_row[a] = a_row[a];
  const size_t smem = wgrad_tf32_smem();
  cudaError_t e = cudaFuncSetAttribute(wgrad_tf32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  wgrad_tf32_kernel<<<dim3(n_tiles, (Mp + MC - 1) / MC), WT_THREADS, smem, s>>>(
      maps, tab, ar, Mp, MC, partial, PW);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++g_wgrad_tf32_launches;
  return (int)e;
}

}  // namespace
