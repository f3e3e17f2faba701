// The bf16 cotangent chain of the training backwards on Hopper's wgmma and
// TMA (lean_train.cu): the channel-major saved stream of 'save',
// 'recompute' (so also the render-fused level's backward) and 'hybrid'
// (whose plain forward writes the same stream) and of the classic
// mlp_bwd_saved / mlp_bwd_recompute, widths multiples of 64.  Replaces, in
// bf16, lean_grad_chain_kernel and the classic mlp_input_grads_kernel (the
// chain and the input cotangents of the TPU kernels _bwd_kernel_lean_save,
// _bwd_kernel_lean, _bwd_kernel_lean_hybrid, _bwd_kernel_lean_render,
// _bwd_kernel_saved and _bwd_kernel, mipnerf_pl_tpu/kernels/mlp.py).  f32
// runs on lean_chain_tf32.cuh; the classic MLP with more than one density
// head keeps the mma.sync kernels.
//
// Route (chain_sm90_route, mirrored by kernels/mlp.py chain_sm90_route):
// bf16, a channel-major stream, W and Wv multiples of 64, at least one view
// layer, one density head, depth + depth_cond + 1 <= CH_MAX_STEPS (the
// classic form: its weight maps within CH_MAX_STEPS, its steps within
// CH_STEPS, dx and dview at most MAX_OUT columns once rounded up to 64, and
// also no view layer: depth_cond 0, Wv 0), and the plan's shared memory
// within the block's.  A plan it cannot make raises.
//
// A persistent block walks 128-point tiles with three warpgroups: in the
// first, one thread streams the weights, one the saved activations' boxes,
// and two warps turn those into ReLU mask bits; consumer warpgroup wg owns
// the tile's points 64 wg + [0, 64).  The steps of a tile, in order (ChainPlan::step):
//   heads   the head cotangents, activation derivatives folded in (from the
//           raw heads the forward saved), to G and to shared memory;
//   rgb     the rgb head's 3-deep backward on the CUDA cores -> ys[last];
//   view_j  j = last .. 1 -> ys[j - 1];  view_0 -> the bottleneck;
//   bottleneck (+ the rank-1 density term) -> hs[depth - 1];
//   trunk_i i = depth - 1 .. 1 -> hs[i - 1].
// A layer is D[64 points][N] = A[64][K] B[K][N], one m64nNk16 per k16 step
// (N = 256 or 128), f32 accumulators in registers: A is the step before's
// output cotangent, the bf16 tile its epilogue left in shared memory
// (channel rows of 64 points: MN-major), B the transposed weights bw [K][N]
// streamed through a 6-stage ring of 32-row slabs (TMA, 128-byte swizzle,
// MN-major).  Both warpgroups read every slab, so a weight byte from L2
// feeds 128 points.  A step's epilogue adds the density term, applies the
// mask (`> 0` of the stored activation, bits a 4-slot ring ahead), and
// writes the cotangent in bf16 into the staging tile; a TMA store takes the
// tile to G, and the next layer reads it as its A.  The f32
// values give the bias column sums (per warp, then the warpgroup's 4 warps
// in order, each warpgroup its own sums, added at the end) and, for ys[0],
// g1f.  No atomics: the per-block sums go to db_part as before.
//
// The classic form (fused_mlp: raw heads, so the head step only casts the
// given cotangents; no g1f; view_0's view rows a weight-gradient problem of
// the stream's V rows, wgrad_sm90_kernel's) also returns the input
// cotangents dx [M][F] = sum over the layers L that read x of G_L k_L[x
// rows]^T (trunk_0, each layer after a skip concat, after a last one the
// bottleneck and the rank-1 density term) and dview [M][Fv] = G_view0
// k_view0[W:]^T, each a step of its own (CH_INPUT) right after the step
// that leaves G_L in the staging tile: A that tile (the next step reads it
// too, so the input step writes no shared memory), B the x (view) rows of
// k_L transposed as the mma.sync input pass reads them ([out][Fp], zero
// past F), through the same ring, TMA reading the columns past Fp (Fvp) as
// zeros up to N = F (Fv) rounded up to 64; the products use the same
// accumulators (N = 128 / 64 at lego: 32 zero columns each, ~3 % of the
// chain's MACs, where N 96 / 32 would read half a 128-byte swizzle atom).
// The first dx step (in chain order) writes its f32 part to dx, each later
// one adds its own to what the same thread wrote there (~0.3 GB a lego
// level more HBM traffic; the f32 kernel's shared-memory stash, 24 KB, does
// not fit beside this plan's 229,632 B).  Past M and past the real columns
// nothing is written.  The classic form is a compile-time instantiation
// (CLASSIC), so the lean chain carries none of its code.  At lego it
// streams 88 slabs a tile against the lean chain's 68 and takes 3.33 ms a
// level against 2.53: the time follows the slabs, not the 13 % more MACs
// (reading dx back before any store, in 8-byte pairs, changed nothing;
// PERF.md).
//
// Its NV form (no view layer: the rgb head reads concat(bottleneck, view);
// a compile-time instantiation too, NV): the rgb step writes the
// bottleneck's cotangent (g_rgb k_rgb[:W]^T, no mask) where the view form
// writes ys[last], and dview = g_rgb k_rgb[W:]^T, the rank-3 term on the
// CUDA cores from the bf16-rounded head cotangents, each element written
// once; then the bottleneck step with the density term and the trunk, with
// their dx steps, as above.  No view weight map and no dview step: G has
// depth W + 1 + W + 3 rows; the rgb head's weight gradient [bottleneck |
// V]^T g_rgb is wgrad_sm90_kernel's, as every other.
//
// What bounds it: 2 x 0.55 M MACs a point (0.43 TFLOP a lego level, 0.44 ms
// at the bf16 peak); the L2 weight traffic is 1.1 MB a tile (3.4 GB a
// level); HBM moves the masks' rows of S and the G rows (~3.7 GB, 1.1 ms).

#pragma once

#include "sm90.cuh"

namespace {

constexpr int CH_TM = 128;                  // points of a tile
constexpr int CH_THREADS = 384;             // a producer warpgroup + two consumer warpgroups
constexpr int CH_STAGES = 4;                // weight ring
constexpr int CH_KS = 32;                   // weight rows (K) a slab
constexpr int CH_MASKS = 4;                 // mask ring
constexpr int CH_RAW = 6;                   // activation boxes for the masks
constexpr int CH_MAX_STEPS = 16;            // the lean chain's steps; a plan's weight maps
constexpr int CH_STEPS = 20;                // steps of a plan
constexpr int CH_BOX = 64 * 64 * 2;         // a 64-row x 64-point cotangent box
constexpr int CH_WBOX = CH_KS * 64 * 2;     // a 32-row x 64-column weight box
constexpr int CH_MASK = MAX_OUT * CH_TM / 8;   // mask bytes of a step
constexpr size_t CH_FIXED = (size_t)CH_STAGES * 4 * CH_WBOX + 2 * 4 * CH_BOX +
                            CH_MASKS * CH_MASK + CH_RAW * CH_BOX +
                            sizeof(float) * (2 * 4 * MAX_OUT + 2 * 4 * CH_TM);

// Step kinds: a layer's cotangent, an input cotangent (dx / dview).
enum { CH_LAYER = 0, CH_INPUT = 1 };

struct ChainStep {
  int kind;
  int w;         // weight map, -1: the rgb head on the CUDA cores
  int K, N;      // input cotangent width (the layer's out), output width
  int act_row;   // first S row of the masking activation, -1: no mask
  int g_row;     // first G row of the output cotangent
  // CH_LAYER: 1 the f32 cotangent also to g1f, 2 + the density term;
  // CH_INPUT: 1 + what out holds (an earlier dx step's part), 2 + the
  // density term's x part
  int flags;
  int cols;      // CH_INPUT: out's columns (F or Fv)
  float* out;    // CH_INPUT: dx [M][F] or dview [M][Fv], the chunk's first row
};

struct ChainPlan {
  CUtensorMap w[CH_MAX_STEPS];   // bw [K][N], 32 x 64 boxes
  CUtensorMap act;               // S [Cs][Mp], 64 x 64 boxes, not swizzled
  CUtensorMap g;                 // G [Cg][Mp], 64 x 64 boxes
  ChainStep step[CH_STEPS];
  int n_steps;
};
// The chain kernel's parameters within the 4 KB a launch passes.
static_assert(sizeof(ChainPlan) + sizeof(ChainPtrs) + sizeof(TrainDims) + 64 <= 4096,
              "lean_chain_sm90_kernel's parameters exceed 4 KB");

constexpr size_t CH_SMEM_MAX = 232448;   // an H100 block's dynamic shared memory

// Launches of lean_chain_sm90_kernel by this library (lean_chain_launches).
long long g_chain_sm90_launches = 0;

// CH_FIXED, each warpgroup's Cg bias sums, the mbarriers, and the slack
// that aligns the buffers to 1024 bytes.
inline size_t chain_sm90_smem(int Cg) {
  return CH_FIXED + 2 * sizeof(float) * ((Cg + 1) & ~1) +
         sizeof(uint64_t) * 2 * (CH_STAGES + CH_MASKS + CH_RAW) + 1024;
}

// The classic form's N of an input step of n columns (dx: F, dview: Fv).
__host__ __device__ inline int ch_cols(int n) { return (n + 63) / 64 * 64; }

// The shapes the kernel takes (bf16 and a channel-major stream are the
// caller's): the lean MLP, or (Fvp > 0) the classic one, with view layers
// or (NV: depth_cond 0, Wv 0) none, whose dview is no step of its own.  A
// shape it takes whose plan cannot be made is an error (lean_train.cu
// run_grads).
inline bool chain_sm90_route(const TrainDims& d) {
  const bool nv = d.Fvp > 0 && d.depth_cond == 0;
  const bool widths = d.W % 64 == 0 && d.W >= 64 &&
                      (nv ? d.Wv == 0 : d.Wv % 64 == 0 && d.Wv >= 64 && d.depth_cond >= 1) &&
                      d.depth >= 1 && d.nd == 1 && chain_sm90_smem(d.cg()) <= CH_SMEM_MAX;
  if (!d.Fvp) return widths && d.depth + d.depth_cond + 1 <= CH_MAX_STEPS;
  const int ix = classic_dx_steps(d) + (nv ? 0 : 1);
  return widths && d.W <= MAX_OUT && d.Wv <= MAX_OUT && d.skip >= 1 && d.F >= 1 && d.Fv >= 1 &&
         ch_cols(d.F) <= MAX_OUT && ch_cols(d.Fv) <= MAX_OUT &&
         d.depth + d.depth_cond + ix <= CH_MAX_STEPS && d.depth + d.depth_cond + 1 + ix <= CH_STEPS;
}

// CLASSIC: the classic form; NV: its form with no view layer.
template <bool CLASSIC, bool NV = false>
__global__ void __launch_bounds__(CH_THREADS, 1)
lean_chain_sm90_kernel(const __grid_constant__ ChainPlan plan, const float* __restrict__ heads,
                       const float* __restrict__ g_rgb, const float* __restrict__ g_dens,
                       ChainPtrs cp, TrainDims d, bf16* __restrict__ G, float* __restrict__ g1f,
                       float* __restrict__ db_part, int n_rows) {
  extern __shared__ uint8_t ch_raw[];
  uint8_t* smem = ch_raw + ((1024 - (smem_u32(ch_raw) & 1023)) & 1023);
  uint8_t* ring = smem;                                        // [stage][4 boxes]
  uint8_t* tiles = ring + CH_STAGES * 4 * CH_WBOX;             // [wg][4 boxes]
  uint8_t* masks = tiles + 2 * 4 * CH_BOX;                     // [slot][channel][16 bytes]
  uint8_t* raw = masks + CH_MASKS * CH_MASK;                   // [slot][64 rows][128 bytes]
  float* part = reinterpret_cast<float*>(raw + CH_RAW * CH_BOX);  // [wg][4][MAX_OUT]
  float* gh = part + 2 * 4 * MAX_OUT;                          // [4][CH_TM] head cotangents
  float* ghc = gh + 4 * CH_TM;                                 // the same, bf16 values
  const int Cg = d.cg(), Cg2 = (Cg + 1) & ~1;
  float* dbacc = ghc + 4 * CH_TM;                              // [wg][Cg2] bias sums
  uint64_t* full = reinterpret_cast<uint64_t*>(dbacc + 2 * Cg2);
  uint64_t* empty = full + CH_STAGES;
  uint64_t* mask_full = empty + CH_STAGES;
  uint64_t* mask_empty = mask_full + CH_MASKS;
  uint64_t* raw_full = mask_empty + CH_MASKS;
  uint64_t* raw_empty = raw_full + CH_RAW;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t Mp = d.Mp;
  const int n_tiles = (d.Mp + CH_TM - 1) / CH_TM;
  if (tid == 0) {
    for (int s = 0; s < CH_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);
    }
    for (int s = 0; s < CH_MASKS; ++s) {
      mbar_init(mask_full + s, 64);
      mbar_init(mask_empty + s, 2);
    }
    for (int s = 0; s < CH_RAW; ++s) {
      mbar_init(raw_full + s, 1);
      mbar_init(raw_empty + s, 64);
    }
    mbar_fence_init();
  }
  for (int c = tid; c < 2 * Cg2; c += CH_THREADS) dbacc[c] = 0.f;
  __syncthreads();

  if (warp == 0) {
    // Weights: per step its K / 32 slabs through the ring.
    if (lane == 0) {
      int slab = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
        for (int si = 0; si < plan.n_steps; ++si) {
          const ChainStep& st = plan.step[si];
          if (st.w < 0) continue;
          const int nb = st.N / 64;
          for (int k0 = 0; k0 < st.K; k0 += CH_KS, ++slab) {
            const int s = slab % CH_STAGES;
            mbar_wait(empty + s, ((slab / CH_STAGES) & 1) ^ 1);
            mbar_expect_tx(full + s, nb * CH_WBOX);
            for (int cb = 0; cb < nb; ++cb)
              tma_load_2d(ring + (s * 4 + cb) * CH_WBOX, &plan.w[st.w], full + s, 64 * cb, k0);
          }
        }
    }
    return;
  }
  if (warp == 1) {
    // The activations' tiles for the masks: per masked step, its N / 64 x 2
    // boxes of 64 channels x 64 points through the raw ring.
    if (lane == 0) {
      int rb = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
        for (int si = 0; si < plan.n_steps; ++si) {
          const ChainStep& st = plan.step[si];
          if (st.act_row < 0) continue;
          for (int cb = 0; cb < st.N / 64; ++cb)
            for (int h = 0; h < 2; ++h, ++rb) {
              const int r = rb % CH_RAW;
              mbar_wait(raw_empty + r, ((rb / CH_RAW) & 1) ^ 1);
              mbar_expect_tx(raw_full + r, CH_BOX);
              tma_load_2d(raw + r * CH_BOX, &plan.act, raw_full + r, tile * CH_TM + 64 * h,
                          st.act_row + 64 * cb);
            }
        }
    }
    return;
  }
  if (warp < 4) {
    // Masks: bit p & 7 of byte 16 c + p / 8 of a slot is `S > 0` for
    // channel c of the step's activation at the tile's point p (points past
    // the stream read 0), from the raw boxes, up to CH_MASKS steps ahead of
    // the epilogues; two warps, a 16-byte chunk (8 points) a thread at a
    // time.
    const int mt = tid - 64;
    int ms = 0, rb = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
      for (int si = 0; si < plan.n_steps; ++si) {
        const ChainStep& st = plan.step[si];
        if (st.act_row < 0) continue;
        const int slot = ms % CH_MASKS;
        mbar_wait(mask_empty + slot, ((ms / CH_MASKS) & 1) ^ 1);
        uint8_t* mb = masks + slot * CH_MASK;
        for (int cb = 0; cb < st.N / 64; ++cb)
          for (int h = 0; h < 2; ++h, ++rb) {
            const int r = rb % CH_RAW;
            mbar_wait(raw_full + r, (rb / CH_RAW) & 1);
            const uint8_t* box = raw + r * CH_BOX;
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              const int v = mt + 64 * k, c = v >> 3, p8 = v & 7;
              const uint4 u = *reinterpret_cast<const uint4*>(box + c * 128 + p8 * 16);
              const bf16* e = reinterpret_cast<const bf16*>(&u);
              uint32_t bits = 0;
#pragma unroll
              for (int i = 0; i < 8; ++i) bits |= (__bfloat162float(e[i]) > 0.f ? 1u : 0u) << i;
              mb[(64 * cb + c) * 16 + 8 * h + p8] = (uint8_t)bits;
            }
            mbar_arrive(raw_empty + r);
          }
        mbar_arrive(mask_full + slot);
        ++ms;
      }
    return;
  }

  // Consumers.  Accumulator 32 nb + 4 j + e (64-column block nb, n8 block
  // j, element e): row 16 wi + g + 8 (e >> 1) of the warpgroup's 64, column
  // 64 nb + 8 j + 2 q + (e & 1).  The two warpgroups meet only at the
  // weight and mask rings: each keeps its own bias sums.
  const int ct = tid - 128, cw = ct >> 5, wg = cw >> 2, wi = cw & 3, g = lane >> 2, q = lane & 3;
  const int wt = ct & 127, bar = 2 + wg;   // thread in the warpgroup, its barrier
  const bf16* k_rgb = static_cast<const bf16*>(cp.k_rgb);
  const bf16* k_den = static_cast<const bf16*>(cp.k_den);
  float* mydb = dbacc + wg * Cg2;
  float* mypart = part + wg * 4 * MAX_OUT;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  int slab = 0, ms = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = tile * CH_TM;
    // Head cotangents of the warpgroup's 64 points: with activated heads,
    // d sigmoid = s (1 - s) widened by the padding, d softplus(z + b) =
    // sigmoid(z + b), from the raw heads.
    for (int i = wt; i < 4 * 64; i += 128) {
      const int c = i >> 6, row = 64 * wg + (i & 63), m = m0 + row;
      float gv = 0.f;
      if (m < d.M) {
        gv = c < 3 ? g_rgb[(size_t)m * 3 + c] : g_dens[m];
        if (d.use_act) {
          const float raw = heads[(size_t)c * Mp + m];
          if (c < 3) {
            const float sg = 1.f / (1.f + expf(-raw));
            gv = gv * ((1.f + 2.f * d.rgb_padding) * sg * (1.f - sg));
          } else {
            gv = gv * (1.f / (1.f + expf(-(raw + d.density_bias))));
          }
        }
      }
      const bf16 gb = __float2bfloat16_rn(gv);
      gh[c * CH_TM + row] = gv;
      ghc[c * CH_TM + row] = __bfloat162float(gb);
      if (m < d.Mp) G[(size_t)(c < 3 ? d.g_rgb() + c : d.g_den()) * Mp + m] = gb;
    }
    named_sync(bar, 128);
    if (wt < 4) {
      float s = 0.f;
      for (int row = 0; row < 64; ++row) s += gh[wt * CH_TM + 64 * wg + row];
      mydb[wt < 3 ? d.g_rgb() + wt : d.g_den()] += s;
    }

    for (int si = 0; si < plan.n_steps; ++si) {
      const ChainStep& st = plan.step[si];
      const int NB = st.N / 64;
      if (st.w >= 0) {
        // The layer's products, K / 32 slabs of two k16 steps; A is the
        // step before's cotangent tile in its staging buffer (rows =
        // channels, MN-major), k16 step t at box t / 4, row 16 (t % 4).
        // A slab is released once the products of the next have been
        // issued and its own are complete.
        const uint32_t a_base = smem_u32(tiles + wg * 4 * CH_BOX);
        const int nks = st.K / CH_KS;
        int prev = 0;
#pragma unroll 1
        for (int ks = 0; ks < nks; ++ks) {
          const int s = slab % CH_STAGES;
          mbar_wait(full + s, (slab / CH_STAGES) & 1);
          const uint32_t b_base = smem_u32(ring + s * 4 * CH_WBOX);
          fence_regs(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            const int t = 2 * ks + kk;
            const uint64_t da = sw128_desc(a_base + (t >> 2) * CH_BOX + (t & 3) * 2048);
            const uint32_t b = b_base + kk * 2048;
            // One product over all N columns (B's atoms CH_WBOX apart).
            if (NB == 4) {
              wgmma_tt_m64n256(acc, da, sw128_desc(b, CH_WBOX), t > 0);
            } else if (NB >= 2) {
              wgmma_tt_m64n128(sub<64>(acc, 0), da, sw128_desc(b, CH_WBOX), t > 0);
              if (NB == 3)
                wgmma_tt_m64n64(sub<32>(acc, 64), da, sw128_desc(b + 2 * CH_WBOX), t > 0);
            } else {
              wgmma_tt_m64n64(sub<32>(acc, 0), da, sw128_desc(b), t > 0);
            }
          }
          wgmma_commit();
          wgmma_wait1();
          fence_regs(acc);
          if (ks > 0 && lane == 0) mbar_arrive(empty + prev);
          prev = s;
          ++slab;
        }
        wgmma_wait0();
        fence_regs(acc);
        if (lane == 0) mbar_arrive(empty + prev);
        if (CLASSIC && st.kind == CH_INPUT) {
          // An input cotangent: f32 to out's rows of the warpgroup's points
          // (+ what an earlier dx step left there, + the density term's x
          // part), nothing past M or past the real columns; the staging
          // tile, the next step's A too, stays as it is.
          const bool add = st.flags & 1, den_x = st.flags & 2;
#pragma unroll
          for (int nb = 0; nb < 4; ++nb) {
            if (nb >= NB) continue;
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int row = 64 * wg + 16 * wi + g + 8 * (e >> 1);
                const int col = 64 * nb + 8 * j + 2 * q + (e & 1);
                if (m0 + row >= d.M || col >= st.cols) continue;
                float* o = st.out + (size_t)(m0 + row) * st.cols + col;
                float v = acc[32 * nb + 4 * j + e];
                if (add) v = *o + v;
                if (den_x) v = fmaf(ghc[3 * CH_TM + row], __bfloat162float(k_den[d.W + col]), v);
                *o = v;
              }
          }
          continue;
        }
      } else {
        // The rgb head's backward: sum over c of ghc[c] k_rgb[col][c].
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          if (nb >= NB) continue;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = 64 * nb + 8 * j + 2 * q + (e & 1);
              const int row = 64 * wg + 16 * wi + g + 8 * (e >> 1);
              float v = 0.f;
              for (int c = 0; c < 3; ++c)
                v = fmaf(ghc[c * CH_TM + row], __bfloat162float(k_rgb[col * 3 + c]), v);
              acc[32 * nb + 4 * j + e] = v;
            }
        }
        if constexpr (NV) {
          // dview [M][Fv] = g_rgb k_rgb[W:]^T of the warpgroup's points,
          // past M none.
          const bf16* kv = k_rgb + 3 * d.W;
          for (int idx = wt; idx < 64 * st.cols; idx += 128) {
            const int p = idx / st.cols, f = idx - p * st.cols, row = 64 * wg + p;
            if (m0 + row >= d.M) continue;
            float v = 0.f;
            for (int c = 0; c < 3; ++c)
              v = fmaf(ghc[c * CH_TM + row], __bfloat162float(__ldg(kv + f * 3 + c)), v);
            st.out[(size_t)(m0 + row) * st.cols + f] = v;
          }
        }
      }
      // Epilogue: density term, mask, f32 to g1f, bf16 into the staging
      // tile, over this step's A, once the step before's store has read it.
      const bool mask = st.act_row >= 0, den = st.flags & 2;
      const bool to_g1f = st.flags & 1;
      const uint8_t* mb = masks + (ms % CH_MASKS) * CH_MASK + 8 * wg + 2 * wi;
      if (mask) mbar_wait(mask_full + ms % CH_MASKS, (ms / CH_MASKS) & 1);
      uint8_t* half = tiles + wg * 4 * CH_BOX;
      if (wt == 0) tma_store_wait_read();
      named_sync(bar, 128);
      // Element 32 nb + 4 j + 2 h + c is row r(h) = 16 wi + g + 8 h, column
      // col = 64 nb + 8 j + 2 q + c.
      if (den) {
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          if (nb >= NB) continue;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[32 * nb + 4 * j + e] =
                  fmaf(ghc[3 * CH_TM + 64 * wg + 16 * wi + g + 8 * (e >> 1)],
                       __bfloat162float(k_den[64 * nb + 8 * j + 2 * q + (e & 1)]),
                       acc[32 * nb + 4 * j + e]);
        }
      }
      if (mask) {
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          if (nb >= NB) continue;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              // The bits of rows g (byte 0) and g + 8 (byte 1).
              const uint32_t bits =
                  *reinterpret_cast<const uint16_t*>(mb + (64 * nb + 8 * j + 2 * q + c) * 16) >> g;
              if (!(bits & 1)) acc[32 * nb + 4 * j + c] = 0.f;
              if (!(bits & 256)) acc[32 * nb + 4 * j + 2 + c] = 0.f;
            }
        }
      }
      if (to_g1f) {
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          if (nb >= NB) continue;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const size_t m = (size_t)m0 + 64 * wg + 16 * wi + g + 8 * (e >> 1);
              if (m < Mp)
                g1f[(size_t)(64 * nb + 8 * j + 2 * q + (e & 1)) * Mp + m] = acc[32 * nb + 4 * j + e];
            }
        }
      }
      // bf16 into the staging tile, transposed by stmatrix: the 8 x 8 block
      // (rows 16 wi + 8 h.., columns 8 j..) goes to box rows 8 j + i (i <
      // 8), 16-byte chunk (2 wi + h) ^ i; lane 8 k + i gives that row's
      // address for matrix k = (h, j & 1) of each pair of n8 blocks.
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        if (nb >= NB) continue;
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          const int k = lane >> 3, i = lane & 7, cl = 8 * (2 * jp + (k >> 1)) + i;
          uint8_t* row = half + nb * CH_BOX + cl * 128 + (((2 * wi + (k & 1)) ^ i) << 4);
          const float* d0 = &acc[32 * nb + 8 * jp];
          stmatrix_x4_trans(row, pack_bf16(d0[0], d0[1]), pack_bf16(d0[2], d0[3]),
                            pack_bf16(d0[4], d0[5]), pack_bf16(d0[6], d0[7]));
        }
      }
      fence_proxy_async();
      named_sync(bar, 128);
      if (wt == 0) {
        if (mask) mbar_arrive(mask_empty + ms % CH_MASKS);
        for (int cb = 0; cb < NB; ++cb)
          tma_store_2d(&plan.g, half + cb * CH_BOX, m0 + 64 * wg, st.g_row + 64 * cb);
        tma_store_commit();
      }
      ms += mask;
      // Column sums: the warp's 16 rows (a butterfly over the 8 lanes of a
      // column pair that leaves lane (g, q) the sums of n8 block j = g),
      // then the warpgroup's 4 warps in order.
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        if (nb >= NB) continue;
        float v[16];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            v[2 * j + c] = acc[32 * nb + 4 * j + c] + acc[32 * nb + 4 * j + c + 2];
#pragma unroll
        for (int h = 8, m = 16; h >= 2; h >>= 1, m >>= 1) {
          const bool up = lane & m;
#pragma unroll
          for (int i = 0; i < h; ++i) {
            const float send = up ? v[i] : v[i + h];
            v[i] = (up ? v[i + h] : v[i]) + __shfl_xor_sync(FULL, send, m);
          }
        }
        mypart[wi * MAX_OUT + 64 * nb + 8 * g + 2 * q] = v[0];
        mypart[wi * MAX_OUT + 64 * nb + 8 * g + 2 * q + 1] = v[1];
      }
      named_sync(bar, 128);
      for (int c = wt; c < st.N; c += 128)
        mydb[st.g_row + c] += ((mypart[c] + mypart[MAX_OUT + c]) + mypart[2 * MAX_OUT + c]) +
                              mypart[3 * MAX_OUT + c];
    }
  }
  if (wt == 0) tma_store_wait();
  named_sync(1, 256);
  for (int c = ct; c < Cg; c += 256) db_part[(size_t)blockIdx.x * Cg + c] = dbacc[c] + dbacc[Cg2 + c];
  if (blockIdx.x == 0)
    for (size_t i = (size_t)gridDim.x * Cg + ct; i < (size_t)n_rows * Cg; i += 256) db_part[i] = 0.f;
}

// The plan of the chain on wgmma for the chunk whose saved activations are
// `acts` (channel-major, one stream) and cotangents G [Cg][d.Mp]: false if
// the route does not take the shape or a tensor map cuTensorMapEncodeTiled
// refuses.  The classic form (d.Fvp > 0) also takes xs[L], the x rows of
// layer L that reads x (L = depth + 1: the bottleneck) transposed, [out]
// [Fp] bf16, vs view_0's view rows transposed, [Wv][Fvp], and dx / dview
// of the chunk.  With no view layer (NV, depth_cond 0) vs is unused: the
// rgb step writes dview.
inline bool chain_sm90_plan(ChainPlan& pl, const Acts& acts, const ChainPtrs& cp,
                            const TrainDims& d, const void* G, const void* const* xs = nullptr,
                            const void* vs = nullptr, float* dx = nullptr,
                            float* dview = nullptr) {
  if (!chain_sm90_route(d) || d.Mp % 64) return false;
  const bool classic = d.Fvp > 0, nv = classic && d.depth_cond == 0;
  if (classic && (!xs || (!vs && !nv) || !dx || !dview)) return false;
  const char* base = static_cast<const char*>(acts.t[0]);
  const size_t row_bytes = 2 * (size_t)acts.ld[0];
  auto row_of = [&](int a) {
    return (int)((static_cast<const char*>(acts.t[a]) - base) / (long long)row_bytes);
  };
  const int i_view = d.depth + 2, last = d.depth_cond - 1;
  int n = 0, nw = 0;
  bool ok = true;
  // A step whose B is w [K][wn] (columns past wn up to N read as zeros;
  // null: the rgb head on the CUDA cores).
  auto step = [&](int kind, const void* w, int wn, int K, int N, int act, int g_row,
                  int flags) -> ChainStep& {
    ok = ok && n < CH_STEPS;
    ChainStep& st = pl.step[n < CH_STEPS ? n : CH_STEPS - 1];
    ++n;
    st = ChainStep{};
    st.kind = kind;
    st.w = -1;
    if (w) {
      ok = ok && nw < CH_MAX_STEPS &&
           make_map(&pl.w[nw < CH_MAX_STEPS ? nw : 0], w, K, wn, wn, CH_KS);
      st.w = nw++;
    }
    st.K = K;
    st.N = N;
    st.act_row = act < 0 ? -1 : row_of(act);
    st.g_row = g_row;
    st.flags = flags;
    return st;
  };
  auto add = [&](int layer, int K, int N, int act, int g_row, int flags) {
    step(CH_LAYER, layer < 0 ? nullptr : cp.bw[layer], N, K, N, act, g_row, flags);
    ok = ok && (layer < 0 || cp.bw[layer]);
  };
  // The input cotangents: dview from G_view0, dx from G_L of each layer L
  // that reads x, the first of them writing dx and the others adding.
  int dx_done = 0;
  auto input = [&](int L) {
    if (!classic) return;
    ok = ok && (L < 0 ? vs : xs[L]);
    ChainStep& st = L < 0 ? step(CH_INPUT, vs, d.Fvp, d.Wv, ch_cols(d.Fv), -1, 0, 0)
                          : step(CH_INPUT, xs[L], d.Fp, d.W, ch_cols(d.F), -1, 0,
                                 (dx_done > 0 ? 1 : 0) | (L > d.depth ? 2 : 0));
    st.out = L < 0 ? dview : dx;
    st.cols = L < 0 ? d.Fv : d.F;
    dx_done += L >= 0;
  };
  if (nv) {
    // The rgb step: the bottleneck's cotangent (no mask) and dview.
    ChainStep& st = step(CH_LAYER, nullptr, 0, 0, d.W, -1, d.g_bot(), 0);
    st.out = dview;
    st.cols = d.Fv;
  } else {
    add(-1, 0, d.Wv, d.a_y(last), d.g_v(last), !classic && last == 0);
    if (last == 0) input(-1);
    for (int j = last; j >= 1; --j) {
      add(i_view + j, d.Wv, d.Wv, d.a_y(j - 1), d.g_v(j - 1), !classic && j == 1);
      if (j == 1) input(-1);
    }
    add(i_view, d.Wv, d.W, -1, d.g_bot(), 0);
  }
  if (classic_reads_x(d, d.depth + 1)) input(d.depth + 1);
  add(d.depth + 1, d.W, d.W, d.a_h(d.depth - 1), d.g_t(d.depth - 1), 2);
  if (classic_reads_x(d, d.depth - 1)) input(d.depth - 1);
  for (int i = d.depth - 1; i >= 1; --i) {
    add(i, d.W, d.W, d.a_h(i - 1), d.g_t(i - 1), 0);
    if (classic_reads_x(d, i - 1)) input(i - 1);
  }
  pl.n_steps = n;
  const int s_rows = d.Fp + (d.depth + 1) * d.W + d.depth_cond * d.Wv;
  return ok && make_map(&pl.act, base, s_rows, d.Mp, acts.ld[0], 64, CU_TENSOR_MAP_SWIZZLE_NONE) &&
         make_map(&pl.g, G, d.cg(), d.Mp, d.Mp, 64);
}

}  // namespace
