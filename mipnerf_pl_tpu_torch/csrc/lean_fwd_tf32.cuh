// The f32 MLP forward on Hopper's wgmma and TMA, 3xTF32 (lean_train.cu:
// lean_fwd, lean_save_fwd and the recompute backward's re-run, and the
// classic mlp_fwd, mlp_save_fwd and mlp_bwd_recompute's re-run;
// lean_render.cu: lean_mlp).  Replaces, in f32, the mma.sync tile
// (mlp_tile<float>, lean_engines.cuh) behind the TPU kernels
// _fwd_kernel_lean_render, _fwd_kernel_lean_save, _fwd_kernel_lean,
// _fwd_kernel and _fwd_kernel_save (mipnerf_pl_tpu/kernels/mlp.py).  bf16
// runs on lean_fwd_sm90.cuh; the classic MLP with more than one density
// head, and the widths the route refuses, keep mlp_tile.
//
// Route (fwd_tf32_route, mirrored by kernels/mlp.py fwd_tf32_route): f32,
// W and Wv multiples of 64 and at most 256, at least one view layer,
// depth + 1 + depth_cond <= FT_MAX_LAYERS, the encode (and the classic
// form's per-point view) at most FT_MAX_X features once rounded up to the
// slab, and the plan's shared memory within the block's; the classic form
// one density head, and also no view layer (depth_cond 0, Wv unused).  It
// is a rule on dtype and shape: a plan this kernel cannot make, or a launch
// it cannot get, raises through the wrapper; no other kernel takes its
// place.
//
// The classic form (fused_mlp, Fv > 0): view_0 reads concat(bottleneck,
// view) per point, the view [M][Fv] f32 loaded into the encode tile once
// the bottleneck is done with it (Fv rows rounded up to FT_KS, zeros past
// Fv), as a second K segment of view_0 with its own bias; raw heads to rgb
// [M][3] and density [M][1] f32; the stream ends with the view's rows V.
// Its NV form (no view layer): the bottleneck is the last dense layer; the
// view goes into the encode tile after it the same way, and the rgb head
// is a dot of concat(bottleneck, view) with its W + Fv rows on the CUDA
// cores, the view part of each quarter added after its bottleneck part
// (as the density head adds a skip concat's x rows); the stream is X | hs
// | bottleneck | V.
//
// 3xTF32: D += A_lo B_hi + A_hi B_lo + A_hi B_hi on wgmma m64nNk8 tf32
// with f32 accumulators, the small terms first (as Tf32Gemm).  wgmma reads
// tf32 from shared memory K-major only, so
//   A (the activations, 64 points x K) comes from registers: each thread
//     loads its fragment from the f32 tile in shared memory and splits it
//     with cvt.rna.tf32 (split_tf32), so the tile stays channel-major
//     ([channel][point], row stride FT_LD = 72 floats: the fragment loads
//     hit 32 banks);
//   B (the weights) is the transposed split the wrapper makes once a call,
//     hi = rna-tf32(k^T) and lo = k^T - hi, one [2N][Kp] f32 array a layer
//     (Kp: K with the encode rounded up to the slab, zero columns), streamed
//     by TMA in slabs of FT_KS = 16 K columns (64 bytes, the 64-byte
//     swizzle), hi and lo in two halves of the slab.
// Shared memory is the constraint: an f32 tile is twice a bf16 one.  A
// block takes one 64-point tile at a time (persistent, one block an SM):
// the activation tile hs (max(W, Wv) rows, 72 KB at 256), the encode tile
// xs (24 KB at F = 96) and a ring of FT_STAGES = 3 slabs of 32 KB (256
// columns, hi + lo).  Its two consumer warpgroups split each layer's N
// columns (N / 2 a warpgroup, 64 accumulators a thread at N = 256, under
// the 168 registers a 288-thread block gets); a producer warp's one thread
// streams the slabs, each as soon as its slot is free.  Both warpgroups
// read all K rows of the input tile, so the in-place epilogue waits for
// both (one named barrier over the 256 consumer threads), and again before
// the next layer reads the tile.  A weight byte from L2 feeds 64 points
// (twice the f32 bytes of mlp_tile's, which reads each weight once and
// splits it in registers; the lo half is the price of reading B from shared
// memory).  Per slab a warpgroup splits its A fragments (two k8 steps),
// waits for the slab, issues 6 wgmma, and waits for them before it loads
// the next A (tf32_products).  What bounds it is that path, the products
// with the split and the epilogue in lockstep (the render chunk: 13.8 ms
// with the weight loads off, 9.7 with the products off, 14.0 with both on;
// PERF.md).  Clusters of two blocks that multicast each slab (half the L2
// reads) measured 56 % slower: each slot then waits for four warpgroups.
//
// The biases and the heads' kernels are staged in shared memory when the
// block starts.  Epilogue: + the bias, + for view_0 the ray's vproj row;
// ReLU except on the bottleneck; f32 over the layer's input tile.  The
// heads are dots of the f32 tile and the staged head kernels, a quarter of
// the channels a thread, the quarters added in a fixed order.  The moments
// form decodes the IPE with decode_moments (ipe_moments' values, bit for
// bit).  Save form: the encode tile and each layer's tile go to S (rows
// X | hs | bottleneck | ys, [Cs][Mp] f32) by 16-byte stores of all 256
// consumer threads after the layer, the raw heads to [4][Mp].
//
// What bounds it: 2 x 0.6 M MACs a point at the 3xTF32 rate (495 / 3 = 165
// TFLOP/s): 1.27 TFLOP a render chunk (7.7 ms), 0.477 TFLOP a lego training
// level (2.9 ms); the save form also writes the 3.7 GiB f32 stream (1.2 ms
// at 3.35 TB/s).  L2 weight traffic: 4.8 MB a 64-point tile (hi + lo).

#pragma once

#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int FT_TM = 64;                      // points of a tile
constexpr int FT_THREADS = 288;                // two consumer warpgroups + a producer warp
constexpr int FT_STAGES = 3;                   // weight ring
constexpr int FT_KS = 16;                      // K columns a slab
constexpr int FT_SW = FT_KS * 4;               // its row: 64 bytes, the 64-byte swizzle
constexpr int FT_LD = FT_TM + 8;               // row stride of the f32 tiles (floats)
constexpr int FT_MAX_LAYERS = 12;              // dense layers (trunk, bottleneck, view)
constexpr int FT_MAX_X = 128;                  // encode rows (F rounded up to FT_KS)
constexpr int FT_HALF = 256 * FT_SW;           // the hi (or lo) half of a slab
constexpr int FT_SLAB = 2 * FT_HALF;
constexpr int FT_BARS = 64;                    // bytes of the ring's mbarriers
constexpr size_t FT_SMEM_MAX = 232448;         // an H100 block's dynamic shared memory
constexpr int FT_MAX_BIAS = FT_MAX_LAYERS * 256;
constexpr int FT_MAX_KD = 256 + FT_MAX_X;
constexpr int FT_MAX_KR = 256 * 3;
constexpr int FT_MAX_SLABS = FT_MAX_LAYERS * (256 + FT_MAX_X) / FT_KS;

struct TfLayer {
  int K;          // K columns streamed (Kp: the encode rounded up to FT_KS)
  int N;          // outputs
  int kh;         // K rows read from hs, the rest from xs (trunk_0: 0)
  int relu;
  int vproj;      // 1: view_0, + the ray's per-ray half (its bias included)
  int view_in;    // 1: the classic view_0, the per-point view loaded into xs first
  int s_row;      // first row of the output in S
  int b_off;      // offset of its bias in the staged biases, -1: none
  const float* bias;
};

struct TfPlan {
  CUtensorMap w[FT_MAX_LAYERS];   // split k^T [2N][Kp], FT_KS x N boxes
  TfLayer layer[FT_MAX_LAYERS];
  int n_layers, i_den, cat_x;
  int M, Mp, N, R, F, Fx, xrows, L, min_deg, ldx, W, Wv, wmax, use_act;
  float rgb_padding, density_bias;
  const float* k_den;
  const float* b_den;
  const float* k_rgb;
  const float* b_rgb;
  float* S;                       // saved stream [Cs][Mp], or null
  // The classic form: view [M][Fv] f32 (null: lean), Fvp its rows in xs
  // and V's first row in S; raw heads to rgb [M][3] and dens [M][1].
  const float* view;
  int Fv, Fvp, v_row;
  float* rgb;
  float* dens;
};

// Launches of lean_fwd_tf32_kernel by this library (lean_fwd_tf32_launches).
long long g_fwd_tf32_launches = 0;

__host__ __device__ inline int ft_round(int n, int k) { return (n + k - 1) / k * k; }

// Rows of the input tile xs: the encode, rounded up to the slab, and in
// the classic form (Fv > 0) the per-point view after it.
inline int ft_xrows(int F, int Fv) {
  const int fx = ft_round(F, FT_KS), fv = ft_round(Fv, FT_KS);
  return fx > fv ? fx : fv;
}

// The ring and its mbarriers, the activation and input tiles, the heads
// and their quarter sums, the staged biases and head kernels, the slab
// schedule, and the slack that aligns the ring to 1024 bytes.
inline size_t fwd_tf32_smem(int W, int Wv, int F, int Fv = 0) {
  const int wmax = W > Wv ? W : Wv;
  return (size_t)FT_STAGES * FT_SLAB + FT_BARS +
         sizeof(float) * FT_LD * (wmax + ft_xrows(F, Fv)) +
         sizeof(float) * (4 * 64 + 4 * 3 * 64 + FT_MAX_BIAS + FT_MAX_KD + FT_MAX_KR) +
         sizeof(short2) * FT_MAX_SLABS + 1024;
}

// The shapes the kernel takes (f32 is the caller's): the lean MLP (Fv 0),
// or the classic one with Fv per-point view features and nd density heads,
// with view layers or (NV: depth_cond 0, Wv 0, as the dims carry it) none.
inline bool fwd_tf32_route(int F, int W, int Wv, int depth, int depth_cond, int Fv = 0,
                           int nd = 1) {
  const bool nv = depth_cond == 0 && Fv >= 1;
  return W >= 64 && W <= 256 && W % 64 == 0 &&
         (nv ? Wv == 0 : Wv >= 64 && Wv <= 256 && Wv % 64 == 0 && depth_cond >= 1) &&
         depth >= 1 &&
         depth + 1 + depth_cond <= FT_MAX_LAYERS && F >= 1 && ft_round(F, FT_KS) <= FT_MAX_X &&
         Fv >= 0 && ft_round(Fv, FT_KS) <= FT_MAX_X && nd == 1 &&
         fwd_tf32_smem(W, Wv, F, Fv) <= FT_SMEM_MAX;
}

// One k8 step of the warpgroup's NC columns.
template <int NC>
__device__ __forceinline__ void tf32_mma(float (&acc)[NC / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  if constexpr (NC == 128)
    wgmma_tf32_m64n128(acc, a, desc_b, scale_d);
  else if constexpr (NC == 96)
    wgmma_tf32_m64n96(acc, a, desc_b, scale_d);
  else if constexpr (NC == 64)
    wgmma_tf32_m64n64(acc, a, desc_b, scale_d);
  else if constexpr (NC == 48)
    wgmma_tf32_m64n48(acc, a, desc_b, scale_d);
  else if constexpr (NC == 32)
    wgmma_tf32_m64n32(acc, a, desc_b, scale_d);
  else
    wgmma_tf32_m64n16(acc, a, desc_b, scale_d);
}

// The A fragments of two k8 steps from rows k0.. of a channel-major f32
// tile (row stride FT_LD), the warp's 16 points from p0 = 16 wi + g, split
// into tf32 hi and lo.
__device__ __forceinline__ void tf32_load_a(const float* src, int p0, int t, uint32_t (&ah)[2][4],
                                            uint32_t (&al)[2][4]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const float* s = src + (8 * kk + t) * FT_LD + p0;
    split_tf32(s[0], ah[kk][0], al[kk][0]);
    split_tf32(s[8], ah[kk][1], al[kk][1]);
    split_tf32(s[4 * FT_LD], ah[kk][2], al[kk][2]);
    split_tf32(s[4 * FT_LD + 8], ah[kk][3], al[kk][3]);
  }
}

// acc (+)= A[64][K] B[K][NC]: the warpgroup's products of one layer,
// nks slabs of the ring from `slab` on.  A's rows [0, kh) come from hs,
// the rest from xs.  Per slab: the A fragments loaded and split, the slab
// waited for, 6 wgmma (two k8 steps), and the slab released once they are
// complete.  (Loading the next slab's fragments into a second register set
// while they run, with wgmma.wait_group 1, measured 10-14 % slower.)
template <int NC>
__device__ __forceinline__ void tf32_products(float (&acc)[NC / 2], const float* hs, int kh,
                                              const float* xs, int nks, uint8_t* ring,
                                              uint64_t* full, uint64_t* empty, int& slab, int col0,
                                              int p0, int t, int lane) {
#pragma unroll 1
  for (int ks = 0; ks < nks; ++ks) {
    const int s = slab % FT_STAGES, k0 = ks * FT_KS;
    uint32_t ah[2][4], al[2][4];
    tf32_load_a(k0 < kh ? hs + k0 * FT_LD : xs + (k0 - kh) * FT_LD, p0, t, ah, al);
    mbar_wait(full + s, (slab / FT_STAGES) & 1);
    const uint32_t bh = smem_u32(ring + s * FT_SLAB) + col0 * FT_SW, bl = bh + FT_HALF;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint64_t dh = sw64_desc(bh + 32 * kk);
      const uint64_t dl = sw64_desc(bl + 32 * kk);
      tf32_mma<NC>(acc, al[kk], dh, ks > 0 || kk > 0);
      tf32_mma<NC>(acc, ah[kk], dl, 1);
      tf32_mma<NC>(acc, ah[kk], dh, 1);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(empty + s);
    ++slab;
  }
}

// MOMENTS: the lean form on the moments; CLASSIC: the classic form (rows),
// NV its form with no view layer; compile-time so that the lean forms (and
// the view-layer classic form) carry none of their code.
template <bool MOMENTS, bool CLASSIC, bool NV = false>
__global__ void __launch_bounds__(FT_THREADS, 1)
lean_fwd_tf32_kernel(const __grid_constant__ TfPlan pl, const float* __restrict__ x,
                     const float* __restrict__ vproj, float* __restrict__ out,
                     float* __restrict__ heads_out) {
  extern __shared__ uint8_t ft_raw[];
  uint8_t* ring = ft_raw + ((1024 - (smem_u32(ft_raw) & 1023)) & 1023);   // [stage][hi | lo]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + FT_STAGES * FT_SLAB);
  uint64_t* empty = full + FT_STAGES;
  float* hs = reinterpret_cast<float*>(ring + FT_STAGES * FT_SLAB + FT_BARS);   // [wmax][FT_LD]
  float* xs = hs + pl.wmax * FT_LD;                                 // [xrows][FT_LD]
  float* hd = xs + pl.xrows * FT_LD;                                // [4][64] raw heads
  float* hp = hd + 4 * 64;                                          // [quarter][3][64]
  float* bias_s = hp + 4 * 3 * 64;                                  // staged biases
  float* kd_s = bias_s + FT_MAX_BIAS;                               // k_den [W (+ F)]
  float* kr_s = kd_s + FT_MAX_KD;                                   // k_rgb [Wv (NV: W)][3]
  short2* sched = reinterpret_cast<short2*>(kr_s + FT_MAX_KR);      // (layer, k0) of a slab
  const int tid = threadIdx.x;
  const int n_tiles = pl.Mp / FT_TM;
  if (tid == 0) {
    for (int s = 0; s < FT_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);
    }
    mbar_fence_init();
  }
  int spt = 0;   // slabs a tile
  for (int li = 0; li < pl.n_layers; ++li) {
    const TfLayer& ly = pl.layer[li];
    for (int k0 = 0; k0 < ly.K; k0 += FT_KS, ++spt)
      if (tid == 0) sched[spt] = make_short2((short)li, (short)k0);
    if (ly.b_off >= 0)
      for (int c = tid; c < ly.N; c += FT_THREADS) bias_s[ly.b_off + c] = ly.bias[c];
  }
  for (int i = tid; i < pl.W + (pl.cat_x ? pl.F : 0); i += FT_THREADS) kd_s[i] = pl.k_den[i];
  // NV: the rgb head's first W rows; its view rows are read where used.
  for (int i = tid; i < 3 * (NV ? pl.W : pl.Wv); i += FT_THREADS) kr_s[i] = pl.k_rgb[i];
  // Encode rows [F, Fx) stay zero (they meet the split's zero columns).
  for (int i = tid; i < (pl.Fx - pl.F) * 64; i += FT_THREADS)
    xs[(pl.F + (i >> 6)) * FT_LD + (i & 63)] = 0.f;
  __syncthreads();
  if (tid >= 256) {
    // Weights: slab j of the block's run (every tile streams every layer)
    // into ring slot j % FT_STAGES once both warpgroups have released the
    // slab before it there: the hi rows [0, N) and the lo rows [N, 2N).
    if (tid == 256) {
      const int total = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x * spt;
      for (int j = 0; j < total; ++j) {
        const int s = j % FT_STAGES;
        const short2 e = sched[j % spt];
        const int n = pl.layer[e.x].N;
        mbar_wait(empty + s, ((j / FT_STAGES) & 1) ^ 1);
        mbar_expect_tx(full + s, 2 * n * FT_SW);
        tma_load_2d(ring + s * FT_SLAB, &pl.w[e.x], full + s, e.y, 0);
        tma_load_2d(ring + s * FT_SLAB + FT_HALF, &pl.w[e.x], full + s, e.y, n);
      }
    }
    return;
  }

  // Consumers.  Warpgroup wg owns the columns [wg N / 2, (wg + 1) N / 2) of
  // each layer; accumulator 4 j + 2 h + c: point p0 + 8 h (p0 = 16 wi + g),
  // column wg N / 2 + 8 j + 2 t + c.
  const int wg = tid >> 7, wi = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, p0 = 16 * wi + g;
  int slab = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = tile * FT_TM;
    // S rows [s_row, s_row + rows) of the tile's points from a tile.
    auto save = [&](const float* src, int rows, int s_row) {
      for (int v = tid; v < rows * 16; v += 256) {
        const int r = v >> 4, c = (v & 15) * 4;
        *reinterpret_cast<float4*>(pl.S + (size_t)(s_row + r) * pl.Mp + m0 + c) =
            *reinterpret_cast<const float4*>(src + r * FT_LD + c);
      }
    };
    // The encode tile (zero past M), once the tile before is done with the
    // tiles.  Moments: decode_moments (lean_engines.cuh), a quarter of a
    // (point, dim)'s degrees a unit, three units a thread (ipe_moments'
    // values); rows: four features of a point a thread where F allows it.
    named_sync(1, 256);
    if constexpr (MOMENTS) {
      decode_moments<4, 256>(x, pl.ldx, pl.M, pl.L, pl.min_deg, m0, tid,
                             [&](int f, int p, float v) { xs[f * FT_LD + p] = v; });
    } else if (pl.F % 4) {
      for (int idx = tid; idx < pl.F * 64; idx += 256) {
        const int f = idx >> 6, p = idx & 63, m = m0 + p;
        xs[f * FT_LD + p] = m < pl.M ? x[(size_t)m * pl.F + f] : 0.f;
      }
    } else {
      for (int idx = tid; idx < pl.F * 16; idx += 256) {
        const int f = (idx >> 6) * 4, p = idx & 63, m = m0 + p;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (m < pl.M) v = *reinterpret_cast<const float4*>(x + (size_t)m * pl.F + f);
        xs[f * FT_LD + p] = v.x;
        xs[(f + 1) * FT_LD + p] = v.y;
        xs[(f + 2) * FT_LD + p] = v.z;
        xs[(f + 3) * FT_LD + p] = v.w;
      }
    }
    // The classic view may have written rows [F, Fx) of the tile before.
    if (CLASSIC && pl.Fvp > pl.F)
      for (int i = tid; i < (pl.Fx - pl.F) * 64; i += 256)
        xs[(pl.F + (i >> 6)) * FT_LD + (i & 63)] = 0.f;
    named_sync(1, 256);
    if (pl.S) save(xs, pl.Fx, 0);

    // The classic form's per-point view of the tile into xs (zeros past Fv
    // and past M), once every product on the encode is done (the
    // bottleneck's epilogue barrier), then out to S rows V.
    auto load_view = [&]() {
      for (int idx = tid; idx < pl.Fvp * 64; idx += 256) {
        const int p = idx / pl.Fvp, f = idx - p * pl.Fvp, m = m0 + p;
        xs[f * FT_LD + p] = m < pl.M && f < pl.Fv ? pl.view[(size_t)m * pl.Fv + f] : 0.f;
      }
      named_sync(1, 256);
      if (pl.S) save(xs, pl.Fvp, pl.v_row);
    };
    for (int li = 0; li < pl.n_layers; ++li) {
      const TfLayer& ly = pl.layer[li];
      const int nks = ly.K / FT_KS, kh = ly.kh;
      if (CLASSIC && ly.view_in) load_view();   // view_0's second K segment
      // The products and the epilogue of one layer, compiled for each half
      // width (NC columns a warpgroup) with its own accumulators.
      auto run_layer = [&](auto nc_c) {
        constexpr int NC = decltype(nc_c)::value;
        const int col0 = wg * NC;
        float acc[NC / 2];
#pragma unroll
        for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;
        tf32_products<NC>(acc, hs, kh, xs, nks, ring, full, empty, slab, col0, p0, t, lane);
        // Epilogue, once both warpgroups are done reading the input tile:
        // bias (+ vproj), ReLU, f32 over the tile.
        named_sync(1, 256);
        const float* vp0 = vproj;
        const float* vp1 = vproj;
        if (ly.vproj) {
          vp0 += (size_t)min((m0 + p0) / pl.N, pl.R - 1) * pl.Wv;
          vp1 += (size_t)min((m0 + p0 + 8) / pl.N, pl.R - 1) * pl.Wv;
        }
#pragma unroll
        for (int j = 0; j < NC / 8; ++j) {
          const int col = col0 + 8 * j + 2 * t;
          float2 b = make_float2(0.f, 0.f), v0 = b, v1 = b;
          if (ly.b_off >= 0) b = *reinterpret_cast<const float2*>(bias_s + ly.b_off + col);
          if (ly.vproj) {
            v0 = *reinterpret_cast<const float2*>(vp0 + col);
            v1 = *reinterpret_cast<const float2*>(vp1 + col);
          }
          float* e = &acc[4 * j];
          e[0] = (e[0] + b.x) + v0.x;
          e[1] = (e[1] + b.y) + v0.y;
          e[2] = (e[2] + b.x) + v1.x;
          e[3] = (e[3] + b.y) + v1.y;
          if (ly.relu) {
#pragma unroll
            for (int c = 0; c < 4; ++c) e[c] = fmaxf(e[c], 0.f);
          }
          hs[col * FT_LD + p0] = e[0];
          hs[(col + 1) * FT_LD + p0] = e[1];
          hs[col * FT_LD + p0 + 8] = e[2];
          hs[(col + 1) * FT_LD + p0 + 8] = e[3];
        }
        named_sync(1, 256);
      };
      const int nh = ly.N / 64;
      if (nh == 4)
        run_layer(std::integral_constant<int, 128>());
      else if (nh == 3)
        run_layer(std::integral_constant<int, 96>());
      else if (nh == 2)
        run_layer(std::integral_constant<int, 64>());
      else
        run_layer(std::integral_constant<int, 32>());
      if (pl.S) save(hs, ly.N, ly.s_row);
      // NV: the rgb head's view rows, after the bottleneck (the last layer).
      if (NV && li == pl.n_layers - 1) load_view();
      // The heads from the layer's f32 outputs in the tile: density after
      // the last trunk layer (+ its x rows after a last skip concat), rgb
      // after the last view layer (NV: the bottleneck, + the view rows).
      // Thread tid sums a quarter of the channels of point tid % 64; the
      // quarters add in a fixed order.
      const bool den = li == pl.i_den;
      if (den || li == pl.n_layers - 1) {
        const int p = tid & 63, qd = tid >> 6, n4 = ly.N / 4;
        float s[3] = {0.f, 0.f, 0.f};
        for (int c = qd * n4; c < (qd + 1) * n4; ++c) {
          const float y = hs[c * FT_LD + p];
          if (den) {
            s[0] = fmaf(y, kd_s[c], s[0]);
          } else {
#pragma unroll
            for (int o = 0; o < 3; ++o) s[o] = fmaf(y, kr_s[c * 3 + o], s[o]);
          }
        }
        if (den && pl.cat_x)
          for (int f = qd * pl.F / 4; f < (qd + 1) * pl.F / 4; ++f)
            s[0] = fmaf(xs[f * FT_LD + p], kd_s[pl.W + f], s[0]);
        if (NV && !den)
          for (int f = qd * pl.Fv / 4; f < (qd + 1) * pl.Fv / 4; ++f) {
            const float v = xs[f * FT_LD + p];
#pragma unroll
            for (int o = 0; o < 3; ++o) s[o] = fmaf(v, __ldg(pl.k_rgb + (pl.W + f) * 3 + o), s[o]);
          }
        for (int o = 0; o < 3; ++o) hp[(3 * qd + o) * 64 + p] = s[o];
        named_sync(1, 256);
        if (tid < 64) {
          auto sum4 = [&](int o) {
            return (hp[o * 64 + p] + hp[(3 + o) * 64 + p]) +
                   (hp[(6 + o) * 64 + p] + hp[(9 + o) * 64 + p]);
          };
          if (den) {
            hd[3 * 64 + p] = sum4(0) + pl.b_den[0];
          } else {
            for (int o = 0; o < 3; ++o) hd[o * 64 + p] = sum4(o) + pl.b_rgb[o];
          }
        }
      }
    }
    // The tile's heads: raw to heads_out [4][Mp], activated (or raw) to out;
    // the classic form's raw to rgb and dens.
    named_sync(1, 256);
    if (tid < 64) {
      const int m = m0 + tid;
      if (CLASSIC && pl.rgb && m < pl.M) {
        for (int c = 0; c < 3; ++c) pl.rgb[(size_t)m * 3 + c] = hd[c * 64 + tid];
        pl.dens[m] = hd[3 * 64 + tid];
      }
      if (heads_out)
        for (int c = 0; c < 4; ++c) heads_out[(size_t)c * pl.Mp + m] = hd[c * 64 + tid];
      if (out && m < pl.M) {
        float4 o;
        float rgb[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float sg = 1.f / (1.f + expf(-hd[c * 64 + tid]));
          rgb[c] = pl.use_act ? sg * (1.f + 2.f * pl.rgb_padding) - pl.rgb_padding
                              : hd[c * 64 + tid];
        }
        const float z = hd[3 * 64 + tid] + pl.density_bias;
        o.x = rgb[0];
        o.y = rgb[1];
        o.z = rgb[2];
        o.w = pl.use_act ? fmaxf(z, 0.f) + log1pf(expf(-fabsf(z))) : hd[3 * 64 + tid];
        reinterpret_cast<float4*>(out)[m] = o;
      }
    }
  }
}

// The plan of lean_fwd_tf32_kernel for the lean MLP of `p` (param order:
// trunk, density, bottleneck, view, rgb; f32) with wt[i] the split
// transposed kernel of dense layer i ([2N][Kp] f32: hi rows, then lo rows;
// view_0's of its first W rows), on M points (Mp = M rounded up to 64) of
// N samples (R rays), the encode F wide (L >= 1: decoded from the moments
// [6][ldx] from degree min_deg), with saved S [Cs][Mp] (save form) or null:
// false where the route does not take the shape or a tensor map cannot be
// made.  Fv > 0: the classic MLP (N = 1, raw heads), view_0's split kernel
// of all its W + Fv rows (Kp = W + Fv rounded up to FT_KS), the caller
// sets view, rgb and dens; with depth_cond 0 (NV) no view layer, and the
// rgb head of W + Fv rows read from p as the other head.
inline bool fwd_tf32_plan(TfPlan& pl, const LayerPtrs& p, const void* const* wt, int M, int Mp,
                          int N, int R, int F, int L, int min_deg, int ldx, int depth,
                          int depth_cond, int skip, int W, int Wv, int use_act, float rgb_padding,
                          float density_bias, float* S, int Fv = 0) {
  if (!wt || Mp % FT_TM || !fwd_tf32_route(F, W, Wv, depth, depth_cond, Fv)) return false;
  auto skip_after = [&](int i) { return i % skip == 0 && i > 0; };
  const int Fx = ft_round(F, FT_KS);
  int n = 0, b_off = 0;
  bool ok = true;
  auto add = [&](int param, int K, int Nout, int kh, int relu, int vp, int s_row,
                 const float* bias) {
    ok = ok && wt[param] &&
         make_map(&pl.w[n], wt[param], 2 * Nout, K, K, Nout, CU_TENSOR_MAP_SWIZZLE_64B, true,
                  FT_KS);
    pl.layer[n] = TfLayer{K, Nout, kh, relu, vp, 0, s_row, bias ? b_off : -1, bias};
    b_off += bias ? Nout : 0;
    ++n;
  };
  for (int i = 0; i < depth; ++i) {
    if (i == 0)
      add(0, Fx, W, 0, 1, 0, Fx, p.b[0]);
    else
      add(i, W + (skip_after(i - 1) ? Fx : 0), W, W, 1, 0, Fx + i * W, p.b[i]);
  }
  const bool cat_x = skip_after(depth - 1);
  add(depth + 1, W + (cat_x ? Fx : 0), W, W, 0, 0, Fx + depth * W, p.b[depth + 1]);
  const int Fvp = ft_round(Fv, FT_KS);
  if (depth_cond) {
    if (Fv)
      add(depth + 2, W + Fvp, Wv, W, 1, 0, Fx + (depth + 1) * W, p.b[depth + 2]);
    else
      add(depth + 2, W, Wv, W, 1, 1, Fx + (depth + 1) * W, nullptr);
    pl.layer[n - 1].view_in = Fv > 0;
  }
  for (int j = 1; j < depth_cond; ++j)
    add(depth + 2 + j, Wv, Wv, Wv, 1, 0, Fx + (depth + 1) * W + j * Wv, p.b[depth + 2 + j]);
  pl.n_layers = n;
  pl.i_den = depth - 1;
  pl.cat_x = cat_x;
  pl.M = M;
  pl.Mp = Mp;
  pl.N = N;
  pl.R = R;
  pl.F = F;
  pl.Fx = Fx;
  pl.xrows = ft_xrows(F, Fv);
  pl.L = L;
  pl.min_deg = min_deg;
  pl.ldx = ldx;
  pl.W = W;
  pl.Wv = Wv;
  pl.wmax = W > Wv ? W : Wv;
  pl.use_act = use_act;
  pl.rgb_padding = rgb_padding;
  pl.density_bias = density_bias;
  pl.k_den = static_cast<const float*>(p.w[depth]);
  pl.b_den = p.b[depth];
  pl.k_rgb = static_cast<const float*>(p.w[depth + 2 + depth_cond]);
  pl.b_rgb = p.b[depth + 2 + depth_cond];
  pl.S = S;
  pl.view = nullptr;
  pl.Fv = Fv;
  pl.Fvp = Fvp;
  pl.v_row = Fx + (depth + 1) * W + depth_cond * Wv;
  pl.rgb = pl.dens = nullptr;
  return ok;
}

// One launch of the planned forward on x (MOMENTS: the moments; CLASSIC:
// the classic form, NV with no view layer), one block an SM at most; 0 or
// a cudaError_t.
template <bool MOMENTS, bool CLASSIC, bool NV = false>
int launch_fwd_tf32_form(const TfPlan& pl, const float* x, const float* vproj, float* out,
                         float* heads, cudaStream_t s) {
  const size_t smem = fwd_tf32_smem(pl.W, pl.Wv, pl.F, pl.Fv);
  int dev = 0, sms = 0;
  cudaError_t e = cudaFuncSetAttribute(lean_fwd_tf32_kernel<MOMENTS, CLASSIC, NV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int tiles = pl.Mp / FT_TM;
  lean_fwd_tf32_kernel<MOMENTS, CLASSIC, NV>
      <<<tiles < sms ? tiles : sms, FT_THREADS, smem, s>>>(pl, x, vproj, out, heads);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++g_fwd_tf32_launches;
  return (int)e;
}

// The lean forms (moments or rows), or with pl.view the classic one (rows;
// Wv 0: no view layer).
inline int launch_fwd_tf32(const TfPlan& pl, bool moments, const float* x, const float* vproj,
                           float* out, float* heads, cudaStream_t s) {
  if (pl.view)
    return pl.Wv ? launch_fwd_tf32_form<false, true>(pl, x, vproj, out, heads, s)
                 : launch_fwd_tf32_form<false, true, true>(pl, x, vproj, out, heads, s);
  return moments ? launch_fwd_tf32_form<true, false>(pl, x, vproj, out, heads, s)
                 : launch_fwd_tf32_form<false, false>(pl, x, vproj, out, heads, s);
}

}  // namespace
