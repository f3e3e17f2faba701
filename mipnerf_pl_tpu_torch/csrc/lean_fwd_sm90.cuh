// The MLP forward on Hopper's wgmma and TMA, bf16, widths multiples of 64
// (lean_train.cu: lean_fwd, lean_save_fwd and the recompute backward's
// re-run, and the classic mlp_fwd, mlp_save_fwd and mlp_bwd_recompute's
// re-run; lean_render.cu: lean_mlp).  Replaces, in bf16, the mma.sync tile
// (mlp_tile, lean_engines.cuh) behind the TPU kernels
// _fwd_kernel_lean_render, _fwd_kernel_lean_save, _fwd_kernel_lean,
// _fwd_kernel and _fwd_kernel_save (mipnerf_pl_tpu/kernels/mlp.py).  f32
// runs on lean_fwd_tf32.cuh; the classic MLP with more than one density
// head, and the widths the route refuses, keep mlp_tile.
//
// Route (fwd_sm90_route, mirrored by kernels/mlp.py fwd_sm90_route): bf16,
// W and Wv multiples of 64 and at most 256, at least one view layer,
// depth + 1 + depth_cond <= FW_MAX_LAYERS, the encode (and the classic
// form's per-point view) at most 128 features (two 64-row boxes once
// rounded up to the 32-row slab), the classic form one density head, and
// also no view layer (depth_cond 0, Wv unused), and the plan's shared
// memory within the block's.  It is a rule on dtype and shape: a plan this
// kernel cannot make, or a launch it cannot get, raises through the
// wrapper; no other kernel takes its place.
//
// The classic form (fused_mlp, Fv > 0; a compile-time instantiation, so
// the lean forms carry none of its code): view_0 reads concat(bottleneck,
// view) per point.  The view [M][Fv] f32, cast to bf16 and zero past Fv up
// to the 32-row slab (Fvx rows), is loaded into the encode tile once the
// bottleneck's products are done with x (the density head, which reads x
// after a last skip concat, runs before them), as view_0's second K
// segment (its kernel's W + Fv rows streamed as W + Fvx, TMA reading the
// rows past the tensor as zeros); view_0 adds its own bias and no vproj.
// Raw heads go to rgb [M][3] and dens [M][1] f32; the save form's stream
// ends with the view's rows V (Fvp = Fv rounded up to 16), stored from the
// encode tile by a map of those rows alone.  Its NV form (no view layer; a
// compile-time instantiation too): the bottleneck is the last dense layer;
// the view goes into the encode tile after its products the same way, and
// the rgb head is a dot of concat(bottleneck, view) with its W + Fv rows on
// the CUDA cores, the bf16 values as stored times the bf16 kernel in f32
// sums, the view part of each half added after its bottleneck part (as the
// density head adds a skip concat's x rows): k_rgb's W + Fv rows staged
// in the head slots.  Two threads share a point (a warpgroup's 128 threads,
// its 64 points), so the dot is in halves where lean_fwd_tf32.cuh's four
// threads a point sum quarters.  The stream is X | hs | bottleneck | V.
//
// A persistent block (one an SM) walks 128-point tiles with two consumer
// warpgroups and a producer warp.  The producer's one thread streams every
// layer's weights k[in][out] as stored (rows = K, the out columns
// contiguous: MN-major) in 32-row slabs through a FW_STAGES-deep ring (TMA,
// 128-byte swizzle, one 32 x 64 box per 64 columns), each slab as soon as
// its slot is free.  Nine warps put three on one of the SM's four register
// files, so ptxas gives a thread 168 registers and, beside 128
// accumulators, serializes the 256-column products; 256 threads (255
// registers, a consumer thread loading the slabs as it released them)
// measured slower: the ring ran dry while both warpgroups were in their
// epilogues (PERF.md).  Consumer warpgroup wg owns the tile's points
// 64 wg + [0, 64) and keeps two bf16 tiles in shared memory, channel rows
// of 64 points in 64-row boxes with the 128-byte swizzle (MN-major, as the
// chain's A, lean_chain_sm90.cuh): the activation tile hs (max(W, Wv) rows)
// and the encode tile xs (the IPE decoded from the moments, or the f32
// encode rows cast; zero past F).  A layer is D[64 points][N] = A[64][K]
// W[K][N], one m64nNk16 per k16 step with f32 accumulators in registers; A
// is the layer's input tile (then, for a skip concat, the encode tile as a
// second K segment).  Both warpgroups read every slab, so a weight byte
// from L2 feeds 128 points (mlp_tile: 64).  Clusters of two blocks that
// multicast each slab (half the L2 reads) measured no faster, nor did a
// seventh stage or another FW_LAG (PERF.md), so neither is kept.
//
// Overlap: the first warpgroup starts FW_LAG slabs ahead of the second
// (the `go` barrier), so one warpgroup's epilogue runs while the other's
// products do; the ring holds the offset, and the two meet only there.
//
// The biases and the heads' kernels are staged in shared memory (f32) when
// the block starts: read from global memory in the epilogue, their latency
// was most of its time.
//
// Epilogue (store_layer / epilogue's semantics): + the f32 bias, + for
// view_0 the ray's vproj row; ReLU except on the bottleneck; rounded to bf16
// and written transposed by stmatrix over the layer's input tile, once the
// layer's products are complete.  The density head (after the last trunk
// layer, [h, x] when the trunk ends on a skip concat) and the rgb head
// (after the last view layer) are dots of that bf16 tile in shared memory
// and the staged f32 head kernels, half the channels a thread, the halves
// added in a fixed order (in the registers, beside the accumulators, they
// made ptxas spill).  Save form: each layer's tile leaves for S at its
// first row and the warpgroup's 64 points by TMA stores (the encode tile to
// rows X through a map of Fp rows, so the 32-row boxes' zero rows past Fp
// are clipped), and a tile is overwritten only once its stores have read
// it; points past Mp are clipped by TMA; heads [4][Mp] and out [M, 4] are
// masked stores.
//
// What bounds it: 2 x 0.6 M MACs a point (0.477 TFLOP a lego training
// level, 0.48 ms at the bf16 peak; 1.27 TFLOP a render chunk, 1.29 ms);
// the save form also writes the 1.85 GiB stream (0.59 ms at 3.35 TB/s),
// which the stores overlap with the products.  L2 weight traffic: 1.2 MB a
// 128-point tile (3.7 GB a lego level).

#pragma once

#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int FW_TM = 128;                   // points of a tile
constexpr int FW_THREADS = 288;              // two consumer warpgroups + a producer warp
constexpr int FW_STAGES = 6;                 // weight ring
constexpr int FW_KS = 32;                    // weight rows (K) a slab
constexpr int FW_LAG = 3;                    // slabs the first warpgroup starts ahead
constexpr int FW_MAX_LAYERS = 12;            // dense layers (trunk, bottleneck, view)
constexpr int FW_BOX = 64 * 64 * 2;          // a 64-row x 64-point tile box
constexpr int FW_WBOX = FW_KS * 64 * 2;      // a 32-row x 64-column weight box
constexpr int FW_XBOXES = 2;                 // encode tile: up to 128 rows
constexpr size_t FW_SMEM_MAX = 232448;       // an H100 block's dynamic shared memory
constexpr int FW_MAX_BIAS = FW_MAX_LAYERS * 256;   // f32 biases staged in shared memory
constexpr int FW_MAX_KD = 256 + 64 * FW_XBOXES;    // the density head's kernel, f32
constexpr int FW_MAX_KR = (256 + 64 * FW_XBOXES) * 3;   // the rgb head's kernel, f32
constexpr int FW_MAX_SLABS = FW_MAX_LAYERS * 12;   // slabs a tile: K <= 256 + 128

struct FwdLayer {
  int K;          // weight rows streamed: the input width (+ F after a skip concat)
  int N;          // outputs
  int kh;         // k16 steps read from the first tile, the rest from the encode tile
  int from_x;     // 1: the first tile is the encode tile (trunk_0)
  int relu;
  int vproj;      // 1: view_0, + the ray's per-ray half (its bias included)
  int view_in;    // 1: the classic view_0, the per-point view loaded into xs first
  int s_row;      // first row of the output in S
  int b_off;      // offset of its bias in the staged biases, -1: none
  const float* bias;
};

struct FwdPlan {
  CUtensorMap w[FW_MAX_LAYERS];   // k [K][N], 32 x 64 boxes
  CUtensorMap s;                  // S [Cs][Mp], 64 x 64 boxes
  CUtensorMap sx;                 // S rows [0, Fp): the encode, 32 x 64 boxes
  CUtensorMap sv;                 // the classic S rows V [v_row, v_row + Fvp), 32 x 64 boxes
  FwdLayer layer[FW_MAX_LAYERS];
  int n_layers, hs_boxes, i_den, cat_x, save;
  int M, Mp, N, R, F, Fx, xrows, L, min_deg, ldx, W, Wv, use_act;
  float rgb_padding, density_bias;
  const bf16* k_den;
  const float* b_den;
  const bf16* k_rgb;
  const float* b_rgb;
  // The classic form: view [M][Fv] f32 (null: lean), Fvx its rows in xs,
  // Fvp its rows in S; raw heads to rgb [M][3] and dens [M][1].
  const float* view;
  int Fv, Fvx, Fvp;
  float* rgb;
  float* dens;
};
// The kernel's parameters within the 4 KB a launch passes.
static_assert(sizeof(FwdPlan) + 4 * sizeof(void*) <= 4096,
              "lean_fwd_sm90_kernel's parameters exceed 4 KB");

// Launches of lean_fwd_sm90_kernel by this library (lean_fwd_sm90_launches).
long long g_fwd_sm90_launches = 0;

__host__ __device__ inline int fw_round(int n, int k) { return (n + k - 1) / k * k; }

// Rows of the encode tile xs: the encode rounded up to the 32-row slab,
// and in the classic form (Fv > 0) the per-point view after it.
inline int fw_xrows(int F, int Fv) {
  const int fx = fw_round(F, FW_KS), fv = fw_round(Fv, FW_KS);
  return fx > fv ? fx : fv;
}

// The ring, the two warpgroups' activation tiles (64-row boxes) and encode
// tiles (fw_xrows rows), their head rows, the staged biases and head
// kernels, the slab schedule, the mbarriers and the slack that aligns the
// buffers to 1024 bytes.
inline size_t fwd_sm90_smem(int W, int Wv, int F, int Fv = 0) {
  const int hb = (W > Wv ? W : Wv) / 64;
  return (size_t)FW_STAGES * 4 * FW_WBOX + 2 * ((size_t)hb * FW_BOX + 128 * fw_xrows(F, Fv)) +
         sizeof(float) * (2 * 4 * 64 + 2 * 2 * 3 * 64 + FW_MAX_BIAS + FW_MAX_KD + FW_MAX_KR) +
         sizeof(short2) * FW_MAX_SLABS + sizeof(uint64_t) * (2 * FW_STAGES + 1) + 1024;
}

// The shapes the kernel takes (bf16 is the caller's): the lean MLP (Fv 0),
// or the classic one with Fv per-point view features and nd density heads,
// with view layers or (NV: depth_cond 0, Wv 0, as the dims carry it) none.
inline bool fwd_sm90_route(int F, int W, int Wv, int depth, int depth_cond, int Fv = 0,
                           int nd = 1) {
  const bool nv = depth_cond == 0 && Fv >= 1;
  return W >= 64 && W <= 256 && W % 64 == 0 &&
         (nv ? Wv == 0 : Wv >= 64 && Wv <= 256 && Wv % 64 == 0 && depth_cond >= 1) &&
         depth >= 1 &&
         depth + 1 + depth_cond <= FW_MAX_LAYERS && F >= 1 &&
         fw_round(F, FW_KS) <= 64 * FW_XBOXES && Fv >= 0 && fw_round(Fv, FW_KS) <= 64 * FW_XBOXES &&
         nd == 1 && fwd_sm90_smem(W, Wv, F, Fv) <= FW_SMEM_MAX;
}

// Byte offset of (channel row, point p) in a swizzled tile of 64-row boxes:
// row r of a box at 128 r, its 16-byte chunk c at chunk c ^ (r & 7).
__device__ __forceinline__ int fw_off(int row, int p) {
  return (row >> 6) * FW_BOX + (row & 63) * 128 + ((((p >> 3) ^ (row & 7))) << 4) + (p & 7) * 2;
}

// MOMENTS: the lean form on the moments; CLASSIC: the classic form (rows),
// NV its form with no view layer; compile-time so that the lean forms (and
// the view-layer classic form) carry none of their code.
template <bool MOMENTS, bool CLASSIC, bool NV = false>
__global__ void __launch_bounds__(FW_THREADS, 1)
lean_fwd_sm90_kernel(const __grid_constant__ FwdPlan pl, const float* __restrict__ x,
                     const float* __restrict__ vproj, float* __restrict__ out,
                     float* __restrict__ heads_out) {
  extern __shared__ uint8_t fw_raw[];
  uint8_t* smem = fw_raw + ((1024 - (smem_u32(fw_raw) & 1023)) & 1023);
  uint8_t* ring = smem;                                          // [stage][4 boxes]
  const int tile_bytes = pl.hs_boxes * FW_BOX + 128 * pl.xrows;
  uint8_t* tiles = ring + FW_STAGES * 4 * FW_WBOX;               // [wg][hs | xs]
  float* heads = reinterpret_cast<float*>(tiles + 2 * tile_bytes);   // [wg][4][64]
  float* hpart = heads + 2 * 4 * 64;                             // [wg][half][3][64]
  float* bias_s = hpart + 2 * 2 * 3 * 64;                        // staged biases
  float* kd_s = bias_s + FW_MAX_BIAS;                            // k_den [W (+ F)]
  float* kr_s = kd_s + FW_MAX_KD;                                // k_rgb [Wv (NV: W + Fv)][3]
  short2* sched = reinterpret_cast<short2*>(kr_s + FW_MAX_KR);   // (layer, k0) of a slab
  uint64_t* full = reinterpret_cast<uint64_t*>(sched + FW_MAX_SLABS);
  uint64_t* empty = full + FW_STAGES;
  uint64_t* go = empty + FW_STAGES;
  const int tid = threadIdx.x, lane = tid & 31;
  const int n_tiles = (pl.Mp + FW_TM - 1) / FW_TM;
  if (tid == 0) {
    for (int s = 0; s < FW_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);
    }
    mbar_init(go, 1);
    mbar_fence_init();
  }
  // The slab schedule of a tile, the biases and the head kernels.
  int spt = 0;   // slabs a tile
  for (int li = 0; li < pl.n_layers; ++li) {
    const FwdLayer& ly = pl.layer[li];
    for (int k0 = 0; k0 < ly.K; k0 += FW_KS, ++spt)
      if (tid == 0) sched[spt] = make_short2((short)li, (short)k0);
    if (ly.b_off >= 0)
      for (int c = tid; c < ly.N; c += FW_THREADS) bias_s[ly.b_off + c] = ly.bias[c];
  }
  for (int i = tid; i < pl.W + (pl.cat_x ? pl.F : 0); i += FW_THREADS)
    kd_s[i] = __bfloat162float(pl.k_den[i]);
  // NV: the rgb head's W bottleneck rows, then its Fv view rows.
  for (int i = tid; i < 3 * (NV ? pl.W + pl.Fv : pl.Wv); i += FW_THREADS)
    kr_s[i] = __bfloat162float(pl.k_rgb[i]);
  for (int i = tid; i < 2 * (pl.Fx - pl.F) * 64; i += FW_THREADS) {
    const int wgi = i / ((pl.Fx - pl.F) * 64), r = i % ((pl.Fx - pl.F) * 64);
    *reinterpret_cast<bf16*>(tiles + wgi * tile_bytes + pl.hs_boxes * FW_BOX +
                             fw_off(pl.F + (r >> 6), r & 63)) = __float2bfloat16_rn(0.f);
  }
  __syncthreads();
  if (tid >= 256) {
    // Weights: slab j of the block's run (every tile streams every layer)
    // into ring slot j % FW_STAGES once both warpgroups have released the
    // slab before it there.
    if (tid == 256) {
      const int total = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x * spt;
      for (int j = 0; j < total; ++j) {
        const int s = j % FW_STAGES;
        const short2 e = sched[j % spt];
        const int nb = pl.layer[e.x].N >> 6;
        mbar_wait(empty + s, ((j / FW_STAGES) & 1) ^ 1);
        mbar_expect_tx(full + s, nb * FW_WBOX);
        for (int cb = 0; cb < nb; ++cb)
          tma_load_2d(ring + (s * 4 + cb) * FW_WBOX, &pl.w[e.x], full + s, 64 * cb, e.y);
      }
    }
    return;
  }

  // Consumers.  Accumulator 32 nb + 4 j + 2 h + c: point p0 + 8 h of the
  // warpgroup's 64 (p0 = 16 wi + g), column 64 nb + 8 j + 2 q + c.
  const int wg = tid >> 7, wt = tid & 127, wi = wt >> 5;
  const int g = lane >> 2, q = lane & 3, bar = 1 + wg, p0 = 16 * wi + g;
  uint8_t* hs = tiles + wg * tile_bytes;
  uint8_t* xs = hs + pl.hs_boxes * FW_BOX;
  float* hd = heads + wg * 4 * 64;
  float* hp = hpart + wg * 2 * 3 * 64;
  const uint32_t hs_a = smem_u32(hs), xs_a = smem_u32(xs);
  int slab = 0;
  bool went = wg == 1;
  if (wg == 1) mbar_wait(go, 0);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = tile * FW_TM + 64 * wg;
    // The encode tile of the warpgroup's points (zero past F and past M),
    // once the stores of the tile before have read the tiles.
    if (pl.save && wt == 0) tma_store_wait_read();
    named_sync(bar, 128);
    // A warp's lanes take consecutive points of one feature row (two-byte
    // stores side by side).  Moments: decode_moments (lean_engines.cuh),
    // half of a (point, dim)'s degrees a unit, three units a thread (the
    // values of ipe_moments, bit for bit); rows: four features of a point a
    // thread, one 16-byte load, where F allows it.  Rows [F, Fx) stay the
    // zeros written when the block started.
    if constexpr (MOMENTS) {
      decode_moments<2, 128>(x, pl.ldx, pl.M, pl.L, pl.min_deg, m0, wt,
                             [&](int f, int p, float v) {
                               *reinterpret_cast<bf16*>(xs + fw_off(f, p)) =
                                   __float2bfloat16_rn(v);
                             });
    } else if (pl.F % 4) {
#pragma unroll 4
      for (int idx = wt; idx < pl.F * 64; idx += 128) {
        const int f = idx >> 6, p = idx & 63, m = m0 + p;
        const float v = m < pl.M ? x[(size_t)m * pl.F + f] : 0.f;
        *reinterpret_cast<bf16*>(xs + fw_off(f, p)) = __float2bfloat16_rn(v);
      }
    } else {
#pragma unroll 6
      for (int idx = wt; idx < pl.F * 16; idx += 128) {
        const int f = (idx >> 6) * 4, p = idx & 63, m = m0 + p;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (m < pl.M) v = *reinterpret_cast<const float4*>(x + (size_t)m * pl.F + f);
        *reinterpret_cast<bf16*>(xs + fw_off(f, p)) = __float2bfloat16_rn(v.x);
        *reinterpret_cast<bf16*>(xs + fw_off(f + 1, p)) = __float2bfloat16_rn(v.y);
        *reinterpret_cast<bf16*>(xs + fw_off(f + 2, p)) = __float2bfloat16_rn(v.z);
        *reinterpret_cast<bf16*>(xs + fw_off(f + 3, p)) = __float2bfloat16_rn(v.w);
      }
    }
    // The classic view of the tile before may have written rows [F, Fx).
    if (CLASSIC && pl.Fvx > pl.F)
      for (int idx = wt; idx < (pl.Fx - pl.F) * 64; idx += 128)
        *reinterpret_cast<bf16*>(xs + fw_off(pl.F + (idx >> 6), idx & 63)) =
            __float2bfloat16_rn(0.f);
    fence_proxy_async();
    named_sync(bar, 128);
    if (pl.save && wt == 0) {
      for (int cb = 0; FW_KS * cb < pl.Fx; ++cb)
        tma_store_2d(&pl.sx, xs + cb * FW_WBOX, m0, FW_KS * cb);
      tma_store_commit();
    }

    // The classic form's per-point view of the warpgroup's points into xs
    // (zeros past Fv and past M), once the products on the encode are done
    // (the bottleneck's, complete before its epilogue) and its stores have
    // read the tile; then out to S rows V.
    auto load_view = [&]() {
      if (pl.save && wt == 0) tma_store_wait_read();
      named_sync(bar, 128);
      for (int idx = wt; idx < pl.Fvx * 64; idx += 128) {
        const int f = idx >> 6, p = idx & 63, m = m0 + p;
        const float v = m < pl.M && f < pl.Fv ? pl.view[(size_t)m * pl.Fv + f] : 0.f;
        *reinterpret_cast<bf16*>(xs + fw_off(f, p)) = __float2bfloat16_rn(v);
      }
      fence_proxy_async();
      named_sync(bar, 128);
      if (pl.save && wt == 0) {
        for (int cb = 0; FW_KS * cb < pl.Fvp; ++cb)
          tma_store_2d(&pl.sv, xs + cb * FW_WBOX, m0, FW_KS * cb);
        tma_store_commit();
      }
    };
    for (int li = 0; li < pl.n_layers; ++li) {
      const FwdLayer& ly = pl.layer[li];
      const int NB = ly.N >> 6, nks = (ly.K + FW_KS - 1) / FW_KS, kh = ly.kh;
      const uint32_t a0 = ly.from_x ? xs_a : hs_a;
      if (CLASSIC && ly.view_in) load_view();   // view_0's second K segment
      // The products, K / 32 slabs of two k16 steps, and the epilogue of one
      // layer, compiled for each output width (NBC 64-column blocks) with
      // its own accumulators: one wgmma shape on one register array (a
      // kernel-wide array shared by several shapes made ptxas serialize the
      // wgmma).  A slab is released once the products of the next have been
      // issued and its own are complete.
      auto run_layer = [&](auto nb_c) {
        constexpr int NBC = decltype(nb_c)::value;
        float acc[32 * NBC];
#pragma unroll
        for (int i = 0; i < 32 * NBC; ++i) acc[i] = 0.f;
        int prev = 0;
#pragma unroll 1
        for (int ks = 0; ks < nks; ++ks) {
          const int s = slab % FW_STAGES;
          mbar_wait(full + s, (slab / FW_STAGES) & 1);
          const uint32_t b_base = smem_u32(ring + s * 4 * FW_WBOX);
          fence_regs(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            const int t = 2 * ks + kk, tx = t - kh;
            const uint32_t a = t < kh ? a0 + (t >> 2) * FW_BOX + (t & 3) * 2048
                                      : xs_a + (tx >> 2) * FW_BOX + (tx & 3) * 2048;
            const uint64_t da = sw128_desc(a);
            const uint32_t b = b_base + kk * 2048;
            // One product over all N columns (B's atoms FW_WBOX apart).
            if constexpr (NBC == 4) {
              wgmma_tt_m64n256(acc, da, sw128_desc(b, FW_WBOX), t > 0);
            } else if constexpr (NBC == 3) {
              wgmma_tt_m64n128(sub<64>(acc, 0), da, sw128_desc(b, FW_WBOX), t > 0);
              wgmma_tt_m64n64(sub<32>(acc, 64), da, sw128_desc(b + 2 * FW_WBOX), t > 0);
            } else if constexpr (NBC == 2) {
              wgmma_tt_m64n128(acc, da, sw128_desc(b, FW_WBOX), t > 0);
            } else {
              wgmma_tt_m64n64(acc, da, sw128_desc(b), t > 0);
            }
          }
          wgmma_commit();
          wgmma_wait1();
          fence_regs(acc);
          if (ks > 0 && lane == 0) mbar_arrive(empty + prev);
          prev = s;
          ++slab;
          if (!went && slab == FW_LAG) {
            if (wt == 0) mbar_arrive(go);
            went = true;
          }
        }
        wgmma_wait0();
        fence_regs(acc);
        if (lane == 0) mbar_arrive(empty + prev);

        // Epilogue: bias (+ vproj), ReLU.
        if (pl.save && wt == 0) tma_store_wait_read();
        named_sync(bar, 128);
        const float* vp0 = vproj;
        const float* vp1 = vproj;
        if (ly.vproj) {
          vp0 += (size_t)min((m0 + p0) / pl.N, pl.R - 1) * pl.Wv;
          vp1 += (size_t)min((m0 + p0 + 8) / pl.N, pl.R - 1) * pl.Wv;
        }
#pragma unroll
        for (int nb = 0; nb < NBC; ++nb) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = 64 * nb + 8 * j + 2 * q;
            float2 b = make_float2(0.f, 0.f), v0 = b, v1 = b;
            if (ly.b_off >= 0) b = *reinterpret_cast<const float2*>(bias_s + ly.b_off + col);
            if (ly.vproj) {
              v0 = *reinterpret_cast<const float2*>(vp0 + col);
              v1 = *reinterpret_cast<const float2*>(vp1 + col);
            }
            float* e = &acc[32 * nb + 4 * j];
            e[0] = (e[0] + b.x) + v0.x;
            e[1] = (e[1] + b.y) + v0.y;
            e[2] = (e[2] + b.x) + v1.x;
            e[3] = (e[3] + b.y) + v1.y;
            if (ly.relu) {
#pragma unroll
              for (int c = 0; c < 4; ++c) e[c] = fmaxf(e[c], 0.f);
            }
          }
        }
        // bf16 over the layer's input tile, transposed by stmatrix: the 8 x 8
        // block (points 16 wi + 8 h.., columns 8 j..) goes to box rows 8 j +
        // i (i < 8), 16-byte chunk (2 wi + h) ^ i; lane 8 k + i gives that
        // row's address for matrix k = (h, j & 1) of each pair of n8 blocks.
#pragma unroll
        for (int nb = 0; nb < NBC; ++nb) {
#pragma unroll
          for (int jp = 0; jp < 4; ++jp) {
            const int k = lane >> 3, i = lane & 7, cl = 8 * (2 * jp + (k >> 1)) + i;
            uint8_t* row = hs + nb * FW_BOX + cl * 128 + (((2 * wi + (k & 1)) ^ i) << 4);
            const float* d0 = &acc[32 * nb + 8 * jp];
            stmatrix_x4_trans(row, pack_bf16(d0[0], d0[1]), pack_bf16(d0[2], d0[3]),
                              pack_bf16(d0[4], d0[5]), pack_bf16(d0[6], d0[7]));
          }
        }
        fence_proxy_async();
        named_sync(bar, 128);
        if (pl.save && wt == 0) {
          for (int cb = 0; cb < NBC; ++cb)
            tma_store_2d(&pl.s, hs + cb * FW_BOX, m0, ly.s_row + 64 * cb);
          tma_store_commit();
        }
      };
      if (NB == 4)
        run_layer(std::integral_constant<int, 4>());
      else if (NB == 3)
        run_layer(std::integral_constant<int, 3>());
      else if (NB == 2)
        run_layer(std::integral_constant<int, 2>());
      else
        run_layer(std::integral_constant<int, 1>());
      // NV: the rgb head's view rows, after the bottleneck (the last layer).
      if (NV && li == pl.n_layers - 1) load_view();
      // The heads from the layer's bf16 outputs in the tile, with the
      // accumulators out of registers: density after the last trunk layer
      // (+ its x rows after a last skip concat), rgb after the last view
      // layer (NV: the bottleneck, + the view rows).  Thread wt sums half
      // the channels of point wt % 64 in f32; the two halves add in order.
      const bool den = li == pl.i_den;
      if (den || li == pl.n_layers - 1) {
        const int p = wt & 63, hh = wt >> 6, c0 = hh * (ly.N / 2);
        float s[3] = {0.f, 0.f, 0.f};
        for (int c = c0; c < c0 + ly.N / 2; ++c) {
          const float y = __bfloat162float(*reinterpret_cast<const bf16*>(hs + fw_off(c, p)));
          if (den) {
            s[0] = fmaf(y, kd_s[c], s[0]);
          } else {
#pragma unroll
            for (int o = 0; o < 3; ++o) s[o] = fmaf(y, kr_s[c * 3 + o], s[o]);
          }
        }
        if (den && pl.cat_x)
          for (int f = hh * (pl.F / 2); f < (hh ? pl.F : pl.F / 2); ++f)
            s[0] = fmaf(__bfloat162float(*reinterpret_cast<const bf16*>(xs + fw_off(f, p))),
                        kd_s[pl.W + f], s[0]);
        if (NV && !den)
          for (int f = hh * (pl.Fv / 2); f < (hh ? pl.Fv : pl.Fv / 2); ++f) {
            const float v = __bfloat162float(*reinterpret_cast<const bf16*>(xs + fw_off(f, p)));
#pragma unroll
            for (int o = 0; o < 3; ++o) s[o] = fmaf(v, kr_s[(pl.W + f) * 3 + o], s[o]);
          }
        for (int o = 0; o < 3; ++o) hp[(3 * hh + o) * 64 + p] = s[o];
        named_sync(bar, 128);
        if (wt < 64) {
          if (den) {
            hd[3 * 64 + p] = (hp[p] + hp[3 * 64 + p]) + pl.b_den[0];
          } else {
            for (int o = 0; o < 3; ++o)
              hd[o * 64 + p] = (hp[o * 64 + p] + hp[(3 + o) * 64 + p]) + pl.b_rgb[o];
          }
        }
      }
    }
    // The tile's heads: raw to heads_out [4][Mp], activated (or raw) to out;
    // the classic form's raw to rgb and dens.
    named_sync(bar, 128);
    if (wt < 64) {
      const int m = m0 + wt;
      if (CLASSIC && pl.rgb && m < pl.M) {
        for (int c = 0; c < 3; ++c) pl.rgb[(size_t)m * 3 + c] = hd[c * 64 + wt];
        pl.dens[m] = hd[3 * 64 + wt];
      }
      if (heads_out && m < pl.Mp)
        for (int c = 0; c < 4; ++c) heads_out[(size_t)c * pl.Mp + m] = hd[c * 64 + wt];
      if (out && m < pl.M) {
        float4 o;
        float rgb[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float sg = 1.f / (1.f + expf(-hd[c * 64 + wt]));
          rgb[c] = pl.use_act ? sg * (1.f + 2.f * pl.rgb_padding) - pl.rgb_padding : hd[c * 64 + wt];
        }
        const float z = hd[3 * 64 + wt] + pl.density_bias;
        o.x = rgb[0];
        o.y = rgb[1];
        o.z = rgb[2];
        o.w = pl.use_act ? fmaxf(z, 0.f) + log1pf(expf(-fabsf(z))) : hd[3 * 64 + wt];
        reinterpret_cast<float4*>(out)[m] = o;
      }
    }
  }
  // A block whose tiles hold fewer than FW_LAG slabs still lets the second
  // warpgroup start.
  if (!went && wt == 0) mbar_arrive(go);
  if (pl.save && wt == 0) tma_store_wait();
}

// The plan of lean_fwd_sm90_kernel for the lean MLP of `p` (param order:
// trunk, density, bottleneck, view, rgb) on M points of N samples (R rays),
// the encode F wide (L >= 1: decoded from the moments [6][ldx] from degree
// min_deg), with saved S [Cs][Mp] (save form) or null: false where the
// route does not take the shape or a tensor map cannot be made.  Fv > 0:
// the classic MLP (N = 1, raw heads; S [Cs + Fvp][Mp]), view_0 of all its
// W + Fv rows; the caller sets view, rgb and dens; with depth_cond 0 (NV)
// no view layer, and the rgb head of W + Fv rows read from p as the other
// head.
inline bool fwd_sm90_plan(FwdPlan& pl, const LayerPtrs& p, int M, int Mp, int N, int R, int F,
                          int L, int min_deg, int ldx, int depth, int depth_cond, int skip, int W,
                          int Wv, int use_act, float rgb_padding, float density_bias,
                          const void* S, int Fv = 0) {
  if (!fwd_sm90_route(F, W, Wv, depth, depth_cond, Fv)) return false;
  auto skip_after = [&](int i) { return i % skip == 0 && i > 0; };
  const int Fp = fw_round(F, 16), Fvx = fw_round(Fv, FW_KS);
  int n = 0, b_off = 0;
  bool ok = true;
  // A layer streaming K weight rows of a kernel of `rows` rows (past them
  // TMA reads zeros).
  auto add = [&](int param, int K, int rows, int Nout, int kh, int from_x, int relu, int vp,
                 int s_row, const float* bias) {
    FwdLayer& ly = pl.layer[n];
    ok = ok && make_map(&pl.w[n], p.w[param], rows, Nout, Nout, FW_KS);
    ly = FwdLayer{K, Nout, kh, from_x, relu, vp, 0, s_row, bias ? b_off : -1, bias};
    b_off += bias ? Nout : 0;
    ++n;
  };
  for (int i = 0; i < depth; ++i) {
    const int K = i == 0 ? F : W + (skip_after(i - 1) ? F : 0);
    if (i == 0)
      add(0, K, K, W, 2 * fw_round(F, FW_KS) / 16, 1, 1, 0, Fp, p.b[0]);
    else
      add(i, K, K, W, W / 16, 0, 1, 0, Fp + i * W, p.b[i]);
  }
  const bool cat_x = skip_after(depth - 1);
  const int Kb = W + (cat_x ? F : 0);
  add(depth + 1, Kb, Kb, W, W / 16, 0, 0, 0, Fp + depth * W, p.b[depth + 1]);
  if (depth_cond) {
    if (Fv)
      add(depth + 2, W + Fvx, W + Fv, Wv, W / 16, 0, 1, 0, Fp + (depth + 1) * W, p.b[depth + 2]);
    else
      add(depth + 2, W, W, Wv, W / 16, 0, 1, 1, Fp + (depth + 1) * W, nullptr);
    pl.layer[n - 1].view_in = Fv > 0;
  }
  for (int j = 1; j < depth_cond; ++j)
    add(depth + 2 + j, Wv, Wv, Wv, Wv / 16, 0, 1, 0, Fp + (depth + 1) * W + j * Wv,
        p.b[depth + 2 + j]);
  pl.n_layers = n;
  pl.hs_boxes = (W > Wv ? W : Wv) / 64;
  pl.i_den = depth - 1;
  pl.cat_x = cat_x;
  pl.save = S != nullptr;
  pl.M = M;
  pl.Mp = Mp;
  pl.N = N;
  pl.R = R;
  pl.F = F;
  pl.Fx = fw_round(F, FW_KS);
  pl.xrows = fw_xrows(F, Fv);
  pl.L = L;
  pl.min_deg = min_deg;
  pl.ldx = ldx;
  pl.W = W;
  pl.Wv = Wv;
  pl.use_act = use_act;
  pl.rgb_padding = rgb_padding;
  pl.density_bias = density_bias;
  pl.k_den = static_cast<const bf16*>(p.w[depth]);
  pl.b_den = p.b[depth];
  pl.k_rgb = static_cast<const bf16*>(p.w[depth + 2 + depth_cond]);
  pl.b_rgb = p.b[depth + 2 + depth_cond];
  pl.view = nullptr;
  pl.Fv = Fv;
  pl.Fvx = Fvx;
  pl.Fvp = fw_round(Fv, 16);
  pl.rgb = pl.dens = nullptr;
  if (S) {
    const int Cs = Fp + (depth + 1) * W + depth_cond * Wv;
    ok = ok && make_map(&pl.s, S, Cs, Mp, Mp, 64) && make_map(&pl.sx, S, Fp, Mp, Mp, FW_KS);
    if (Fv)
      ok = ok && make_map(&pl.sv, static_cast<const bf16*>(S) + (size_t)Cs * Mp, pl.Fvp, Mp, Mp,
                          FW_KS);
  }
  return ok;
}

// One launch of the planned forward on x (MOMENTS: the moments; CLASSIC:
// the classic form, NV with no view layer), one block an SM at most; 0 or
// a cudaError_t.
template <bool MOMENTS, bool CLASSIC, bool NV = false>
int launch_fwd_sm90_form(const FwdPlan& pl, const float* x, const float* vproj, float* out,
                         float* heads, cudaStream_t s) {
  const size_t smem = fwd_sm90_smem(pl.W, pl.Wv, pl.F, pl.Fv);
  int dev = 0, sms = 0;
  cudaError_t e = cudaFuncSetAttribute(lean_fwd_sm90_kernel<MOMENTS, CLASSIC, NV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (pl.Mp + FW_TM - 1) / FW_TM;
  lean_fwd_sm90_kernel<MOMENTS, CLASSIC, NV>
      <<<tiles < sms ? tiles : sms, FW_THREADS, smem, s>>>(pl, x, vproj, out, heads);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++g_fwd_sm90_launches;
  return (int)e;
}

// The lean forms (moments or rows), or with pl.view the classic one (rows;
// Wv 0: no view layer).
inline int launch_fwd_sm90(const FwdPlan& pl, bool moments, const float* x, const float* vproj,
                           float* out, float* heads, cudaStream_t s) {
  if (pl.view)
    return pl.Wv ? launch_fwd_sm90_form<false, true>(pl, x, vproj, out, heads, s)
                 : launch_fwd_sm90_form<false, true, true>(pl, x, vproj, out, heads, s);
  return moments ? launch_fwd_sm90_form<true, false>(pl, x, vproj, out, heads, s)
                 : launch_fwd_sm90_form<false, false>(pl, x, vproj, out, heads, s);
}

}  // namespace
