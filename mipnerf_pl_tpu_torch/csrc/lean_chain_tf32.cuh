// The f32 cotangent chain of the training backwards on Hopper's wgmma and
// TMA, 3xTF32 (lean_train.cu): the channel-major saved stream of 'save',
// 'recompute' (so also the render-fused level's backward) and 'hybrid'
// (whose plain forward writes the same stream) and of the classic
// mlp_bwd_saved / mlp_bwd_recompute, widths multiples of 64.  Replaces, in
// f32, lean_grad_chain_kernel<float> and the classic
// mlp_input_grads_kernel<float> (the chain and the input cotangents of the
// TPU kernels _bwd_kernel_lean_save, _bwd_kernel_lean,
// _bwd_kernel_lean_hybrid, _bwd_kernel_lean_render, _bwd_kernel_saved and
// _bwd_kernel, mipnerf_pl_tpu/kernels/mlp.py).  The classic MLP with more
// than one density head keeps the mma.sync kernels; bf16 runs on
// lean_chain_sm90.cuh.
//
// Route (chain_tf32_route, mirrored by kernels/mlp.py chain_tf32_route): f32,
// a channel-major stream, W and Wv multiples of 64, at least one view
// layer, one density head, depth + depth_cond + 1 <= CT_MAX_STEPS (the
// classic form: its weight maps within CT_MAX_MAPS and its steps within
// CT_STEPS, and also no view layer: depth_cond 0, Wv 0), and the plan's
// shared memory within the block's.  A plan it cannot make raises.
//
// The design of lean_fwd_tf32.cuh (its constants and helpers): a persistent
// block walks 64-point tiles with two consumer warpgroups that split each
// step's N output columns and a producer thread that streams B through a
// ring of FT_STAGES slabs of FT_KS = 16 K columns (TMA, the 64-byte
// swizzle).  The steps of a tile, in order (TcPlan::step):
//   heads   the head cotangents, activation derivatives folded in (from the
//           raw heads the forward saved), to G and to shared memory;
//   rgb     the rgb head's 3-deep backward on the CUDA cores -> ys[last];
//   view_j  j = last .. 1 -> ys[j - 1];  view_0 -> the bottleneck;
//   bottleneck (+ the rank-1 density term) -> hs[depth - 1];
//   trunk_i i = depth - 1 .. 1 -> hs[i - 1].
// A layer's step is D[64 points][N] = A[64][K] B[K][N] with K the layer's
// out and N its in (its first W rows): A is the step before's f32 output
// cotangent in the shared tile ga (channel rows of 64 points, row stride
// FT_LD), loaded into registers and split into tf32 hi and lo; B is the
// layer's kernel k[:in_h] as stored ([in_h][out]: K-major already), split
// by the wrapper into [hi; lo] [2 in_h][out] f32.  3xTF32 as the forward.
// The epilogue, once both warpgroups are done reading ga, adds the density
// term and writes the f32 cotangent over ga; then all 256 consumer threads
// apply the mask (`> 0` of the stored f32 activation, read from S in
// 16-byte loads, which the producer thread prefetched into L2 with the
// step's first slab), copy ga's N rows to G (f32, channel-major, the rows
// wgrad_tf32_kernel reads) and, for ys[0], to g1f, and sum each
// column over the tile's 64 points in a fixed (rotated) order into the
// block's bias sums.  No
// atomics: the per-block sums go to db_part as lean_grad_chain_kernel's do.
//
// The classic form (fused_mlp: raw heads, no g1f, view_0's view rows a
// weight-gradient problem of the stream's V rows) also returns the input
// cotangents dx [M][F] = sum over the layers L that read x of G_L k_L[x
// rows]^T (trunk_0, each layer after a skip concat, after a last one the
// bottleneck and the rank-1 density term) and dview [M][Fv] = G_view0
// k_view0[W:]^T.  Each is a step of its own on the same engine (CT_INPUT):
// A the cotangent G_L in ga, B the split x (view) rows of k_L as stored,
// N their width rounded up to 32 (NC = N / 2 a warpgroup, 16..64),
// placed right after the step that leaves G_L in ga, before the next one
// overwrites it.  (A second launch of this kernel whose steps loaded each
// G_L back from G gave the same bits and measured 1.1 ms a lego level
// slower, PERF.md.)  Every element of dx and dview is written once: a
// layer whose x part is not the last keeps its products in ixs, the
// accumulators' thread-private stash in shared memory, which the last one
// adds.  The classic form is a compile-time instantiation (CLASSIC), so
// the lean chain carries none of its code.
//
// Its NV form (no view layer: the rgb head reads concat(bottleneck, view)):
// the rgb step writes the bottleneck's cotangent (g_rgb k_rgb[:W]^T, no
// mask) where the view form writes ys[last], and dview = g_rgb k_rgb[W:]^T,
// the rank-3 term on the CUDA cores, each element written once in the same
// order as the mma.sync input pass; then the bottleneck step with the
// density term and the trunk, with their dx steps, as above.  G has depth W
// + 1 + W + 3 rows; the rgb head's weight gradient [bottleneck | V]^T g_rgb
// is wgrad_tf32_kernel's, as every other.
//
// What bounds it: 2 x 0.55 M MACs a point at the 3xTF32 rate (0.43 TFLOP a
// lego level, 2.6 ms at 165 TFLOP/s); HBM moves the masks' rows of S and
// the f32 G rows (~7 GB, 2.2 ms at 3.35 TB/s).

#pragma once

#include "lean_fwd_tf32.cuh"

namespace {

constexpr int CT_MAX_STEPS = 16;   // the lean chain's steps
constexpr int CT_MAX_MAPS = 16;    // weight maps of a plan
constexpr int CT_STEPS = 20;       // steps of a plan

// Step kinds: a layer's cotangent, an input cotangent (dx / dview).
enum { CT_LAYER = 0, CT_INPUT = 1 };

struct TcStep {
  int kind;
  int w;              // weight map, -1: the rgb head on the CUDA cores
  int K, N;           // input cotangent width (the layer's out), output width
  const float* act;   // the masking activation's first row (channel-major), null: no mask
  int act_ld;
  int act_row;        // its first row in the stream (the prefetch map's)
  int g_row;          // first G row of the output cotangent
  // CT_LAYER: 1 the cotangent also to g1f, 2 + the density term;
  // CT_INPUT: 1 + the stash ixs, 2 + the density term's x part, 4 to the
  // stash (not out)
  int flags;
  float* out;         // CT_INPUT: dx [M][cols] or dview, the chunk's first row
  int cols;
};

struct TcPlan {
  CUtensorMap w[CT_MAX_MAPS];    // split k[:in_h] [2 in_h][out], FT_KS x in_h boxes
  CUtensorMap act;               // the stream [rows][ld] f32, 64 x 64 boxes (L2 prefetch)
  TcStep step[CT_STEPS];
  int n_steps;
};
// The chain kernel's parameters within the 4 KB a launch passes.
static_assert(sizeof(TcPlan) + sizeof(ChainPtrs) + sizeof(TrainDims) + 64 <= 4096,
              "lean_chain_tf32_kernel's parameters exceed 4 KB");

// Launches of lean_chain_tf32_kernel by this library (lean_chain_launches).
long long g_chain_tf32_launches = 0;

// The ring and its mbarriers, the cotangent tile, the head cotangents, the
// staged head kernels, the block's Cg bias sums, 1 KB of alignment; the
// classic form (ix_n > 0: the dx steps' N) also the density kernel's x
// rows and the stash of dx's products (64 points x ix_n).
inline size_t chain_tf32_smem(int W, int Wv, int Cg, int ix_n = 0) {
  const int wmax = W > Wv ? W : Wv;
  return (size_t)FT_STAGES * FT_SLAB + FT_BARS + sizeof(float) * FT_LD * wmax +
         sizeof(float) * (4 * 64 + 256 + 3 * 256 + ((Cg + 3) & ~3)) +
         (ix_n ? sizeof(float) * (FT_MAX_X + 64 * ix_n) : 0) + 1024;
}

// The classic form's N of the dx and of the dview steps: F (Fv) rounded up
// to 32 (Fp, Fvp: already rounded up to 16).
inline int ix_cols(int n) { return (n + 31) / 32 * 32; }

// The shapes the kernel takes (f32 and a channel-major stream are the
// caller's): the lean MLP, or (Fvp > 0) the classic one, with view layers
// or (NV: depth_cond 0, Wv 0) none, whose dview is no step of its own.
inline bool chain_tf32_route(const TrainDims& d) {
  const bool nv = d.Fvp > 0 && d.depth_cond == 0;
  const bool widths = d.W >= 64 && d.W <= 256 && d.W % 64 == 0 &&
                      (nv ? d.Wv == 0
                          : d.Wv >= 64 && d.Wv <= 256 && d.Wv % 64 == 0 && d.depth_cond >= 1) &&
                      d.depth >= 1 && d.nd == 1;
  if (!d.Fvp)
    return widths && d.depth + d.depth_cond + 1 <= CT_MAX_STEPS &&
           chain_tf32_smem(d.W, d.Wv, d.cg()) <= FT_SMEM_MAX;
  const int ix = classic_dx_steps(d) + (nv ? 0 : 1);
  return widths && d.skip >= 1 && ix_cols(d.Fp) <= FT_MAX_X && ix_cols(d.Fvp) <= FT_MAX_X &&
         d.depth + d.depth_cond + ix <= CT_MAX_MAPS && d.depth + d.depth_cond + 1 + ix <= CT_STEPS &&
         chain_tf32_smem(d.W, d.Wv, d.cg(), ix_cols(d.Fp)) <= FT_SMEM_MAX;
}

// CLASSIC: the classic form; NV: its form with no view layer.
template <bool CLASSIC, bool NV = false>
__global__ void __launch_bounds__(FT_THREADS, 1)
lean_chain_tf32_kernel(const __grid_constant__ TcPlan plan, const float* __restrict__ heads,
                       const float* __restrict__ g_rgb, const float* __restrict__ g_dens,
                       ChainPtrs cp, TrainDims d, float* __restrict__ G, float* __restrict__ g1f,
                       float* __restrict__ db_part, int n_rows) {
  extern __shared__ uint8_t ct_raw[];
  uint8_t* ring = ct_raw + ((1024 - (smem_u32(ct_raw) & 1023)) & 1023);   // [stage][hi | lo]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + FT_STAGES * FT_SLAB);
  uint64_t* empty = full + FT_STAGES;
  float* ga = reinterpret_cast<float*>(ring + FT_STAGES * FT_SLAB + FT_BARS);   // [wmax][FT_LD]
  const int wmax = d.W > d.Wv ? d.W : d.Wv, Cg = d.cg();
  float* gh = ga + wmax * FT_LD;      // [4][64] head cotangents
  float* kd_s = gh + 4 * 64;          // k_den [W]
  float* kr_s = kd_s + 256;           // k_rgb [Wv (NV: W)][3]
  float* dbacc = kr_s + 3 * 256;      // [Cg] the block's bias sums
  float* kdx_s = dbacc + ((Cg + 3) & ~3);   // classic: k_den's x rows [F]
  float* ixs = kdx_s + FT_MAX_X;      // classic: [NC / 2][256] the stash of dx's products
  const int tid = threadIdx.x;
  const size_t Mp = d.Mp;
  const int n_tiles = d.Mp / FT_TM;
  if (tid == 0) {
    for (int s = 0; s < FT_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);
    }
    mbar_fence_init();
  }
  for (int c = tid; c < Cg; c += FT_THREADS) dbacc[c] = 0.f;
  for (int i = tid; i < d.W; i += FT_THREADS) kd_s[i] = static_cast<const float*>(cp.k_den)[i];
  for (int i = tid; i < 3 * (NV ? d.W : d.Wv); i += FT_THREADS)
    kr_s[i] = static_cast<const float*>(cp.k_rgb)[i];
  if (CLASSIC && classic_reads_x(d, d.depth + 1))
    for (int i = tid; i < d.F; i += FT_THREADS)
      kdx_s[i] = static_cast<const float*>(cp.k_den)[d.W + i];
  __syncthreads();
  if (tid >= 256) {
    // Weights: per step its K / FT_KS slabs through the ring, the hi rows
    // [0, N) and the lo rows [N, 2N); before them, the tile's rows of the
    // step's masking activation into L2, a step's products ahead of the
    // epilogue that reads them (read from HBM there, they held it up by
    // ~4 ms a lego level).
    if (tid == 256) {
      int slab = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
        for (int si = 0; si < plan.n_steps; ++si) {
          const TcStep& st = plan.step[si];
          if (st.act)
            for (int r = 0; r < st.N; r += 64)
              tma_prefetch_2d(&plan.act, tile * FT_TM, st.act_row + r);
          if (st.w < 0) continue;
          for (int k0 = 0; k0 < st.K; k0 += FT_KS, ++slab) {
            const int s = slab % FT_STAGES;
            mbar_wait(empty + s, ((slab / FT_STAGES) & 1) ^ 1);
            mbar_expect_tx(full + s, 2 * st.N * FT_SW);
            tma_load_2d(ring + s * FT_SLAB, &plan.w[st.w], full + s, k0, 0);
            tma_load_2d(ring + s * FT_SLAB + FT_HALF, &plan.w[st.w], full + s, k0, st.N);
          }
        }
    }
    return;
  }

  // Consumers: as lean_fwd_tf32_kernel's.
  const int wg = tid >> 7, wi = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, p0 = 16 * wi + g;
  int slab = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = tile * FT_TM;
    named_sync(1, 256);
    // Head cotangents of the tile: with activated heads, d sigmoid = s (1 -
    // s) widened by the padding, d softplus(z + b) = sigmoid(z + b), from
    // the raw heads.
    {
      const int c = tid >> 6, p = tid & 63, m = m0 + p;
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
      gh[c * 64 + p] = gv;
      G[(size_t)(c < 3 ? d.g_rgb() + c : d.g_den()) * Mp + m] = gv;
    }
    named_sync(1, 256);
    if (tid < 4) {
      float s = 0.f;
      for (int p = 0; p < 64; ++p) s += gh[tid * 64 + p];
      dbacc[tid < 3 ? d.g_rgb() + tid : d.g_den()] += s;
    }

    for (int si = 0; si < plan.n_steps; ++si) {
      const TcStep& st = plan.step[si];
      if (CLASSIC && st.kind == CT_INPUT) {
        // An input cotangent: D = G_L (in ga, untouched) B, out to dx / dview
        // rows (or the stash), masked past M and past the real columns.
        auto run_input = [&](auto nc_c) {
          constexpr int NC = decltype(nc_c)::value;
          const int col0 = wg * NC;
          float acc[NC / 2];
#pragma unroll
          for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;
          tf32_products<NC>(acc, ga, st.K, ga, st.K / FT_KS, ring, full, empty, slab, col0, p0,
                            t, lane);
#pragma unroll
          for (int j = 0; j < NC / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = 4 * j + e;
              const int col = col0 + 8 * j + 2 * t + (e & 1), p = p0 + 8 * (e >> 1);
              float v = acc[i];
              if (st.flags & 1) v = ixs[i * 256 + tid] + v;
              if ((st.flags & 2) && col < st.cols) v = fmaf(gh[3 * 64 + p], kdx_s[col], v);
              if (st.flags & 4)
                ixs[i * 256 + tid] = v;
              else if (m0 + p < d.M && col < st.cols)
                st.out[(size_t)(m0 + p) * st.cols + col] = v;
            }
          }
        };
        const int nc = st.N / 2;
        if (nc == 64)
          run_input(std::integral_constant<int, 64>());
        else if (nc == 48)
          run_input(std::integral_constant<int, 48>());
        else if (nc == 32)
          run_input(std::integral_constant<int, 32>());
        else
          run_input(std::integral_constant<int, 16>());
        continue;
      }
      const bool den = st.flags & 2;
      if (st.w >= 0) {
        // The products and the epilogue of one layer's step, compiled for
        // each half width (NC columns a warpgroup).
        auto run_step = [&](auto nc_c) {
          constexpr int NC = decltype(nc_c)::value;
          const int col0 = wg * NC;
          float acc[NC / 2];
#pragma unroll
          for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;
          tf32_products<NC>(acc, ga, st.K, ga, st.K / FT_KS, ring, full, empty, slab, col0, p0,
                            t, lane);
          // Epilogue, once both warpgroups are done reading ga: the density
          // term, f32 over ga (the mask follows in the copy pass).
          named_sync(1, 256);
#pragma unroll
          for (int j = 0; j < NC / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = col0 + 8 * j + 2 * t + (e & 1), p = p0 + 8 * (e >> 1);
              float v = acc[4 * j + e];
              if (den) v = v + gh[3 * 64 + p] * kd_s[col];
              ga[col * FT_LD + p] = v;
            }
          }
        };
        const int nh = st.N / 64;
        if (nh == 4)
          run_step(std::integral_constant<int, 128>());
        else if (nh == 3)
          run_step(std::integral_constant<int, 96>());
        else if (nh == 2)
          run_step(std::integral_constant<int, 64>());
        else
          run_step(std::integral_constant<int, 32>());
      } else {
        // The rgb head's backward: sum over c of gh[c] k_rgb[j][c].
        for (int idx = tid; idx < st.N * 64; idx += 256) {
          const int j = idx >> 6, p = idx & 63;
          float v = 0.f;
          for (int c = 0; c < 3; ++c) v = fmaf(gh[c * 64 + p], kr_s[j * 3 + c], v);
          ga[j * FT_LD + p] = v;
        }
        if constexpr (NV) {
          // dview [M][Fv] = g_rgb k_rgb[W:]^T of the tile's points, past M
          // none.
          const float* kv = static_cast<const float*>(cp.k_rgb) + 3 * d.W;
          for (int idx = tid; idx < 64 * st.cols; idx += 256) {
            const int p = idx / st.cols, f = idx - p * st.cols;
            if (m0 + p >= d.M) continue;
            float v = 0.f;
            for (int c = 0; c < 3; ++c) v = fmaf(gh[c * 64 + p], __ldg(kv + f * 3 + c), v);
            st.out[(size_t)(m0 + p) * st.cols + f] = v;
          }
        }
      }
      named_sync(1, 256);
      // The mask (`> 0` of the activation's rows, 16 bytes a load) over ga,
      // and the cotangent to G (and g1f), 16 bytes an access (the mask's
      // loads coalesced, where the epilogue would read one element a thread
      // and row).  Then its column sums over the tile's points,
      // column c from point (k + c / 4) % 64 on (a fixed order, and the 32
      // lanes of a warp on 32 banks).
      // A thread's N / 16 (at most 16) mask loads are all issued before the
      // first is used.
      float4 mk[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int v = tid + 256 * i, r = v >> 4, c = (v & 15) * 4;
        if (st.act && v < st.N * 16)
          mk[i] = __ldg(reinterpret_cast<const float4*>(st.act + (size_t)r * st.act_ld + m0 + c));
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int v = tid + 256 * i, r = v >> 4, c = (v & 15) * 4;
        if (v >= st.N * 16) break;
        float4 x = *reinterpret_cast<const float4*>(ga + r * FT_LD + c);
        if (st.act) {
          x.x = mk[i].x > 0.f ? x.x : 0.f;
          x.y = mk[i].y > 0.f ? x.y : 0.f;
          x.z = mk[i].z > 0.f ? x.z : 0.f;
          x.w = mk[i].w > 0.f ? x.w : 0.f;
          *reinterpret_cast<float4*>(ga + r * FT_LD + c) = x;
        }
        *reinterpret_cast<float4*>(G + (size_t)(st.g_row + r) * Mp + m0 + c) = x;
        if (st.flags & 1) *reinterpret_cast<float4*>(g1f + (size_t)r * Mp + m0 + c) = x;
      }
      if (st.act) named_sync(1, 256);
      if (tid < st.N) {
        const int r0 = (tid >> 2) & 63;
        float s = 0.f;
        for (int k = 0; k < 64; ++k) s += ga[tid * FT_LD + ((k + r0) & 63)];
        dbacc[st.g_row + tid] += s;
      }
    }
  }
  named_sync(1, 256);
  for (int c = tid; c < Cg; c += 256) db_part[(size_t)blockIdx.x * Cg + c] = dbacc[c];
  if (blockIdx.x == 0)
    for (size_t i = (size_t)gridDim.x * Cg + tid; i < (size_t)n_rows * Cg; i += 256)
      db_part[i] = 0.f;
}

// The split B operand [2 n][K] f32 of a step as a map: FT_KS x n boxes.
inline bool chain_map(CUtensorMap* map, const void* w, int n, int K) {
  return w && make_map(map, w, 2 * n, K, K, n, CU_TENSOR_MAP_SWIZZLE_64B, true, FT_KS);
}

// The plan of the chain on tf32 wgmma for the chunk whose saved activations
// are `acts` (channel-major f32, one stream whose rows are acts.ld[0]
// apart), with ws[i] the split kernel k[:in_h] ([2 in_h][out] f32) of chain
// layer i by param index: false if a tensor map cannot be made.  The
// classic form (d.Fvp > 0) also takes xs[L], the split x rows of layer L
// that reads x (L = depth + 1: the bottleneck), [2 ix_cols(Fp)][out], vs
// view_0's split view rows [2 ix_cols(Fvp)][Wv], and dx / dview of the
// chunk.  With no view layer (NV, depth_cond 0) vs is unused: the rgb step
// writes dview.
inline bool chain_tf32_plan(TcPlan& pl, const Acts& acts, const void* const* ws,
                            const TrainDims& d, const void* const* xs = nullptr,
                            const void* vs = nullptr, float* dx = nullptr,
                            float* dview = nullptr) {
  if (!ws || !chain_tf32_route(d)) return false;
  const bool classic = d.Fvp > 0, nv = classic && d.depth_cond == 0;
  if (classic && (!xs || (!vs && !nv) || !dx || !dview)) return false;
  const int i_view = d.depth + 2, last = d.depth_cond - 1;
  const char* base = static_cast<const char*>(acts.t[0]);
  int n = 0, nw = 0;
  bool ok = true;
  auto step = [&](int kind, int K, int N, int act, int g_row, int flags) -> TcStep& {
    ok = ok && n < CT_STEPS;
    TcStep& st = pl.step[n < CT_STEPS ? n : CT_STEPS - 1];
    ++n;
    st = TcStep{};
    st.kind = kind;
    st.w = -1;
    st.K = K;
    st.N = N;
    st.act = act < 0 ? nullptr : static_cast<const float*>(acts.t[act]);
    st.act_ld = act < 0 ? 0 : acts.ld[act];
    st.act_row = act < 0 ? 0
                         : (int)((static_cast<const char*>(acts.t[act]) - base) /
                                 (4 * (long long)acts.ld[0]));
    st.g_row = g_row;
    st.flags = flags;
    return st;
  };
  auto map = [&](TcStep& st, const void* w) {
    ok = ok && nw < CT_MAX_MAPS && chain_map(&pl.w[nw], w, st.N, st.K);
    st.w = nw++;
  };
  auto add = [&](int layer, int K, int N, int act, int g_row, int flags) {
    TcStep& st = step(CT_LAYER, K, N, act, g_row, flags);
    if (layer >= 0) map(st, ws[layer]);
  };
  // The input cotangents: dview from G_view0, dx from G_L of each layer L
  // that reads x, the last of them (trunk_0) writing dx.
  const int n_dx = classic ? classic_dx_steps(d) : 0;
  int dx_done = 0;
  auto input = [&](int L) {
    if (!classic) return;
    if (L < 0) {
      TcStep& st = step(CT_INPUT, d.Wv, ix_cols(d.Fvp), -1, 0, 0);
      map(st, vs);
      st.out = dview;
      st.cols = d.Fv;
      return;
    }
    ++dx_done;
    const int flags = (dx_done > 1 ? 1 : 0) | (L > d.depth ? 2 : 0) | (dx_done < n_dx ? 4 : 0);
    TcStep& st = step(CT_INPUT, d.W, ix_cols(d.Fp), -1, 0, flags);
    map(st, xs[L]);
    st.out = dx;
    st.cols = d.F;
  };
  if (nv) {
    // The rgb step: the bottleneck's cotangent (no mask) and dview.
    TcStep& st = step(CT_LAYER, 0, d.W, -1, d.g_bot(), 0);
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
  return ok && make_map(&pl.act, base, s_rows, d.Mp, acts.ld[0], 64,
                        CU_TENSOR_MAP_SWIZZLE_NONE, true);
}

}  // namespace
