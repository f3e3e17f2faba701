// Training kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels of mipnerf_pl_tpu/kernels/mlp.py fused_mlp_lean,
// in its three modes, and of fused_mlp, in its two:
//
//   lean_fwd          _fwd_kernel_lean (pl.pallas_call in _run_fwd_lean):
//                     the lean MLP forward of each TM-point tile (mlp_tile,
//                     lean_engines.cuh) from f32 encode rows x [M, F], cast
//                     per tile into the encode buffer, or from the [6, M]
//                     moments with the IPE decoded per tile (the TPU
//                     kernel's `encode=` input, load_encode_tile); heads
//                     activated or raw.  Modes 'recompute' and (through
//                     lean_save_fwd) 'save'.
//   lean_save_fwd     _fwd_kernel_lean_save (_run_fwd_lean_save): the same
//                     kernel, which also writes the activations the
//                     backward reads and the raw heads.
//   lean_param_grads  _bwd_kernel_lean_save (pl.pallas_call in
//                     _run_bwd_lean_common) through _lean_param_grads: f32
//                     gradients of every parameter from the saved stream,
//                     none for x and view.
//   lean_param_grads_recompute
//                     _bwd_kernel_lean (the same pallas_call): the same
//                     gradients with the forward re-run chunk by chunk.
//   lean_param_grads_hybrid
//                     _bwd_kernel_lean_hybrid (the same pallas_call): the
//                     same gradients from the plain forward's residuals,
//                     one point-major stream per layer.
//   mlp_fwd           _fwd_kernel (pl.pallas_call in _run_fwd): the classic
//                     MLP of fused_mlp, mlp_fwd_kernel: the same tile
//                     (mlp_tile<T, true>) with per-point view features read
//                     into the encode buffer once the trunk is done with it,
//                     view_0 on concat(bottleneck, view) with its bias, nd
//                     raw density heads and raw rgb.  Mode 'recompute'.
//   mlp_save_fwd      _fwd_kernel_save (_run_fwd_save): the same kernel,
//                     which also writes the stream, the view rows last.
//   mlp_bwd_saved     _bwd_kernel_saved (_run_bwd_saved): dx, dview and f32
//                     gradients of every parameter from the stream: the lean
//                     driver (CL: nd heads, view rows per point, no per-ray
//                     sums) and an input-gradient pass after the chain.
//   mlp_bwd_recompute _bwd_kernel (_run_bwd): the same, the forward re-run
//                     chunk by chunk by mlp_fwd_kernel.
// The four classic entries also take a model with no view layer
// (depth_cond 0, Wv 0), a compile-time instantiation of the tile, the chain
// and the input-gradient pass (NV): the rgb head reads concat(bottleneck,
// view), its cotangent splits into the bottleneck's and dview, and the
// stream has no ys rows.
//
// Saved layout of 'save', chosen for the backward's weight-gradient
// products: one channel-major stream S [Cs][Mp] in the compute dtype, rows
//   X (the cast encode, F rows padded to Fp) | hs[0..depth-1] | bottleneck
//   | ys[0..depth_cond-1],
// Mp = M rounded up to the 64-point tile.  A tile is channel-major in
// shared memory, so each row leaves as a coalesced 64-point segment, and
// every weight gradient dW = A^T G is a product of two point-contiguous
// row blocks.  The forward also keeps its raw heads [4][Mp] f32 (16 B a
// point), so the backward folds the activation derivatives in without
// recomputing the two head products the TPU kernel redoes per tile.
// 'hybrid' reads the same activations as the row-major [M, width] tensors
// its plain forward leaves (x padded to Fp columns), never packed: the
// backward's kernels are templated on that layout (PM), and a point-major
// A tile of dW = A^T G is a transposed ldmatrix load.  Its raw heads are
// recomputed in the chain kernel from the residuals with f32 sums, as the
// TPU kernel does.
//
// What bounds them: ~1.2 MFLOP per point forward and ~2.2 backward (the
// cotangent chain and the weight gradients), so all are compute bound on
// the tensor cores; the saved stream is ~5 KB a point in bf16 (2 GB a
// level at 393,216 points), ~1 ms of HBM at 3.35 TB/s each way.
//
// The TPU backward sums every weight gradient in VMEM across a sequential
// grid.  Here blocks run in parallel and a block cannot hold 2.4 MB of f32
// sums, so the backward is passes plus reductions, all deterministic
// (fixed summation orders, no atomics), over chunks of points:
//   0. recompute only: lean_fwd_kernel re-runs the forward of the chunk
//      into a chunk-sized S and raw heads (the same kernel and tiles as
//      lean_fwd, so the same ReLU masks); no level-sized stream exists.
//   1. the cotangent chain, persistent blocks over point tiles: head
//      cotangents (activation derivatives folded in), then back through
//      rgb -> view_j -> view_0 -> bottleneck + density -> trunk with the
//      transposed weights on the same GEMM engines, ReLU masks from the
//      saved activations.  Each layer's output cotangent goes to G
//      [Cg][chunk] in the compute dtype (the operand of its weight
//      gradient); bias gradients are column sums of the f32 cotangent, per
//      block; view_0's f32 cotangent also goes to g1f [Wv][chunk].  The
//      lean chain on a bf16 channel-major stream (save, recompute) is
//      lean_chain_sm90_kernel (lean_chain_sm90.cuh: 128-point tiles,
//      wgmma fed by a TMA ring); f32, hybrid and the classic forms keep
//      lean_grad_chain_kernel (64-point tiles, mma.sync).
//   2. split-K tensor-core products dW = A^T G over the points, one 128 x
//      128 output tile per block and one MC-point range per grid row,
//      written as per-range partial sums.  Ranges never straddle a chunk,
//      so every mode sums the same ranges in the same order.  bf16 on a
//      channel-major stream: wgrad_sm90_kernel (lean_wgrad_sm90.cuh, wgmma
//      fed by a TMA ring); f32 and hybrid: lean_wgrad_kernel (mma.sync).
//      In f32 the tensor-core sums restart every 128 points into
//      round-to-nearest f32 sums (FLUSH).  The skip concat's x rows are
//      problems of their own: their weight gradients accumulate; the chain
//      drops their dx.  The classic backward (CL) takes it after the chain:
//      mlp_input_grads_kernel reads back from G the output cotangent of
//      each layer that reads x (trunk_0, every layer after a skip concat,
//      the bottleneck and density after a last one) and of view_0, and
//      sums dx [M][F] and dview [M][Fv] per tile, each element written once
//      (in the chain itself these products cost ~30 %: spills).  The
//      classic view_0 weight rows of the view are a problem of the
//      stream's V rows, per point, where the lean kernels sum g_ray per ray
//      (step 3).
//   3. g_ray = sum over each ray's samples of the f32 view_0 cotangent,
//      cast to the compute dtype (lean_ray_sum_kernel; chunks hold whole
//      rays).
// After the last chunk: sum_rows_kernel adds the partial sums and the
// per-block bias sums in order, and dW[W:] of view_0 = cast(view)^T g_ray
// (lean_view_rows_kernel).  Padded points (m >= M) have zero head
// cotangents, hence zero G, and add nothing to any sum.

#include "lean_engines.cuh"
#include "lean_wgrad_sm90.cuh"

namespace {

static_assert(THREADS == 4 * TM, "one thread per (head channel, point)");

struct TrainDims {
  int M, Mp, N, R, F, Fp, Fv, depth, depth_cond, skip, W, Wv;
  float rgb_padding, density_bias;
  int use_act;   // 1: heads activated, the backward folds the derivatives in
  // The forward's input form: L == 0 f32 encode rows x [M, F]; L >= 1 the
  // moments x [6][ldx] (F = 6L, decoded per tile from degree min_deg).
  // ldx stays the level's M in a recompute chunk.
  int L, min_deg, ldx;
  // nd density heads (1 for the lean kernels); Fvp > 0: the classic MLP,
  // whose per-point view features (Fv rows padded to Fvp) follow the ys in
  // S as one more activation.
  int nd, Fvp;
  // The saved activations, in order: x | hs[0..depth-1] | bottleneck |
  // ys[0..depth_cond-1] (| view); s_row(a) is activation a's first row in
  // S.
  __host__ __device__ int a_h(int i) const { return 1 + i; }
  __host__ __device__ int a_bot() const { return 1 + depth; }
  __host__ __device__ int a_y(int j) const { return 2 + depth + j; }
  __host__ __device__ int n_acts() const { return 2 + depth + depth_cond + (Fvp > 0); }
  __host__ __device__ int s_row(int a) const {
    return a == 0 ? 0 : a <= depth + 1 ? Fp + (a - 1) * W : Fp + (depth + 1) * W + (a - a_y(0)) * Wv;
  }
  // Rows of G (cotangents; also the offsets of the bias gradients in param
  // order).
  __host__ __device__ int g_t(int i) const { return i * W; }
  __host__ __device__ int g_den() const { return depth * W; }
  __host__ __device__ int g_bot() const { return depth * W + nd; }
  __host__ __device__ int g_v(int j) const { return depth * W + nd + W + j * Wv; }
  __host__ __device__ int g_rgb() const { return g_v(depth_cond); }
  __host__ __device__ int cg() const { return g_rgb() + 3; }
  __host__ __device__ MlpDims mlp() const {
    return MlpDims{M, N, R, L, min_deg, depth, depth_cond, skip, W, Wv, rgb_padding, density_bias};
  }
};

// Activation a of the tile at m0: (row, col) -> f32 value.  Point-major
// streams hold exactly M points, so rows past them read as 0.
template <typename T, bool PM>
struct ActTile {
  const T* p;
  int ld, rows;
  __device__ float operator()(int row, int col) const {
    if (PM) return row < rows ? Ty<T>::to_f(p[(size_t)row * ld + col]) : 0.f;
    return Ty<T>::to_f(p[(size_t)col * ld + row]);
  }
};

template <typename T, bool PM>
__device__ ActTile<T, PM> act_tile(const Acts& acts, int a, int m0, const TrainDims& d) {
  const T* p = static_cast<const T*>(acts.t[a]);
  const int ld = PM ? acts.ld[a] : d.Mp;
  return ActTile<T, PM>{p + (PM ? (size_t)m0 * ld : (size_t)m0), ld, d.M - m0};
}

// The forward of the tile at blockIdx.x * TM, from encode rows or (MOMENTS)
// the moments.  Optional outputs: out [M, 4] f32 (activated or raw heads),
// saved [Cs][Mp] and heads_out [4][Mp] (raw).
template <typename T, bool MOMENTS>
__global__ void __launch_bounds__(THREADS, 2)
lean_fwd_kernel(const float* __restrict__ x, const float* __restrict__ vproj, LayerPtrs p,
                TrainDims td, float* __restrict__ out, T* __restrict__ saved,
                float* __restrict__ heads_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int wmax = max(td.W, td.Wv);
  T* xs = reinterpret_cast<T*>(smem_raw);          // [Fp][LD] encode tile
  T* hs = xs + (size_t)td.Fp * LD;                  // [wmax][LD] activations
  T* slab = hs + (size_t)wmax * LD;                 // weight rows
  float* heads = reinterpret_cast<float*>(slab + Engine<T>::type::slab_elems(wmax));  // [4][TM]
  const int tid = threadIdx.x, m0 = blockIdx.x * TM;

  // x rows, or the IPE decoded from the moments -> channel-major encode
  // tile in the compute dtype (zero past F and past M), which also serves
  // the skip concat; then out to S rows X.
  load_encode_tile<T, MOMENTS>(xs, x, td.ldx, td.M, td.F, td.Fp, td.L, td.min_deg, m0);
  __syncthreads();
  if (saved) copy_tile_out(saved, td.Mp, m0, xs, td.Fp);

  const MlpDims d = td.mlp();
  mlp_tile<T>(xs, td.F, hs, slab, heads, p, d, vproj, m0, saved, td.Mp, td.Fp);
  if (heads_out) heads_out[(size_t)(tid / TM) * td.Mp + m0 + tid % TM] = heads[tid];
  if (out) write_activated(heads, d, m0, out, td.use_act != 0);
}

// lean_fwd_kernel of the input form d.L says (0: rows, >= 1: moments).
template <typename T>
using FwdKernel = void (*)(const float*, const float*, LayerPtrs, TrainDims, float*, T*, float*);
template <typename T>
FwdKernel<T> fwd_kernel(const TrainDims& d) {
  return d.L ? lean_fwd_kernel<T, true> : lean_fwd_kernel<T, false>;
}

// Rows of the classic forward's input tile: the encode, then (once the
// trunk is done with it) the per-point view.
__host__ __device__ inline int classic_xrows(const TrainDims& d) {
  return d.Fp > d.Fvp ? d.Fp : d.Fvp;
}

// The classic MLP forward (fused_mlp) of the tile at blockIdx.x * TM: x
// [M, F] and view [M, Fv] f32 per point -> raw heads rgb [M, 3], density
// [M, nd] f32 (either may be null), and with saved the stream [Cs][Mp]
// (X | hs | bottleneck | ys | V).  NV: depth_cond = 0, no view layer (the
// rgb head reads concat(bottleneck, view); the stream has no ys).
template <typename T, bool NV>
__global__ void __launch_bounds__(THREADS, 2)
mlp_fwd_kernel(const float* __restrict__ x, const float* __restrict__ view, LayerPtrs p,
               TrainDims td, float* __restrict__ rgb, float* __restrict__ density,
               T* __restrict__ saved) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int wmax = max(td.W, td.Wv), nh = 3 + td.nd;
  T* xs = reinterpret_cast<T*>(smem_raw);                        // [xrows][LD] input tile
  T* hs = xs + (size_t)classic_xrows(td) * LD;                   // [wmax][LD] activations
  T* slab = hs + (size_t)wmax * LD;                              // weight rows
  float* heads = reinterpret_cast<float*>(slab + Engine<T>::type::slab_elems(wmax));  // [nh][TM]
  const int m0 = blockIdx.x * TM;

  load_encode_tile<T, false>(xs, x, 0, td.M, td.F, td.Fp, 0, 0, m0);
  __syncthreads();
  if (saved) copy_tile_out(saved, td.Mp, m0, xs, td.Fp);
  mlp_tile<T, true, NV>(xs, td.F, hs, slab, heads, p, td.mlp(), nullptr, m0, saved, td.Mp, td.Fp,
                        ClassicView{view, td.Fv, td.Fvp, td.nd});
  for (int idx = threadIdx.x; idx < nh * TM; idx += THREADS) {
    const int c = idx / TM, row = idx - c * TM, m = m0 + row;
    if (m >= td.M) continue;
    if (c < 3) {
      if (rgb) rgb[(size_t)m * 3 + c] = heads[idx];
    } else if (density) {
      density[(size_t)m * td.nd + c - 3] = heads[idx];
    }
  }
}

template <typename T>
size_t classic_fwd_smem(const TrainDims& d) {
  return mlp_smem_bytes<T>(classic_xrows(d), d.W > d.Wv ? d.W : d.Wv, 3 + d.nd);
}

struct ChainPtrs {
  const void* bw[MAX_LAYERS];  // by param index: k[:in_h]^T [out][in_h], compute dtype
  const void* k_den;           // density kernel [W (+F)][nd], compute dtype
  const void* k_rgb;           // rgb kernel [Wv][3], compute dtype
  const float* b_den;          // density bias [1], f32 rounded through the compute dtype
  const float* b_rgb;          // rgb bias [3], likewise
};

// The classic backward's input-gradient products (compute dtype, zero past
// F / Fv): by param index the x columns k[x rows]^T [out][Fp] of trunk_0
// and of every layer that reads x (null elsewhere); view_0's view rows
// k[W:]^T [Wv][Fvp] (with no view layer the rgb head's, [3][Fvp]); the
// density kernel; out dx [M][F], dview [M][Fv] f32.
struct InputGrads {
  const void* bx[MAX_LAYERS];
  const void* bv;
  const void* k_den;
  float *dx, *dview;
};

// Raw head c of point row of the tile at m0, from the saved activations
// with f32 sums (ys[last] k_rgb + b_rgb; [hs[last], x] k_den + b_den).
template <typename T, bool PM>
__device__ float raw_head(const Acts& acts, const ChainPtrs& cp, const TrainDims& d, int c,
                          int m0, int row) {
  float s = 0.f;
  if (c < 3) {
    const ActTile<T, PM> y = act_tile<T, PM>(acts, d.a_y(d.depth_cond - 1), m0, d);
    const T* k = static_cast<const T*>(cp.k_rgb);
    for (int j = 0; j < d.Wv; ++j) s = fmaf(y(row, j), Ty<T>::to_f(k[j * 3 + c]), s);
    return s + cp.b_rgb[c];
  }
  const T* k = static_cast<const T*>(cp.k_den);
  const ActTile<T, PM> h = act_tile<T, PM>(acts, d.a_h(d.depth - 1), m0, d);
  for (int j = 0; j < d.W; ++j) s = fmaf(h(row, j), Ty<T>::to_f(k[j]), s);
  if ((d.depth - 1) % d.skip == 0 && d.depth - 1 > 0) {
    const ActTile<T, PM> xa = act_tile<T, PM>(acts, 0, m0, d);
    for (int f = 0; f < d.F; ++f) s = fmaf(xa(row, f), Ty<T>::to_f(k[d.W + f]), s);
  }
  return s + cp.b_den[0];
}

// Rows of the channel-major stream S: X | hs | bottleneck | ys (| V).
__host__ __device__ inline int stream_rows(const TrainDims& d) {
  return d.Fp + (d.depth + 1) * d.W + d.depth_cond * d.Wv + d.Fvp;
}

template <typename T>
size_t chain_smem_bytes(int wmax, int cg, int nh) {
  return sizeof(T) * ((size_t)wmax * LD + Engine<T>::type::slab_elems(wmax)) +
         sizeof(float) * (2 * nh * TM + 2 * MAX_OUT + cg);
}

// heads [4][Mp] raw heads of the forward (channel-major acts); the
// point-major residuals come without them and the chain recomputes them.
// CL (the classic MLP, raw heads): nd density heads and no g1f; the input
// cotangents come after, from G (mlp_input_grads_kernel).  NV (CL with
// depth_cond = 0): the rgb head's cotangent goes straight to the bottleneck,
// unmasked, through k_rgb's first W rows.
template <typename T, bool PM, bool CL = false, bool NV = false>
__global__ void __launch_bounds__(THREADS, 2)
lean_grad_chain_kernel(Acts acts, const float* __restrict__ heads,
                       const float* __restrict__ g_rgb, const float* __restrict__ g_dens,
                       ChainPtrs cp, TrainDims d, T* __restrict__ G, float* __restrict__ g1f,
                       float* __restrict__ db_part) {
  typedef typename Engine<T>::type Gemm;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // Head rows: 3 rgb + nd density (the lean kernels' one, a constant).
  const int wmax = max(d.W, d.Wv), Cg = d.cg(), nh = CL ? 3 + d.nd : 4;
  T* ga = reinterpret_cast<T*>(smem_raw);                        // [wmax][LD] cotangent tile
  T* slab = ga + (size_t)wmax * LD;                              // weight rows
  float* gh = reinterpret_cast<float*>(slab + Gemm::slab_elems(wmax));  // [nh][TM] head cotangents
  float* ghc = gh + nh * TM;                                     // the same, compute-dtype values
  float* part = ghc + nh * TM;                                   // [2][MAX_OUT] column partials
  float* dbacc = part + 2 * MAX_OUT;                             // [Cg] this block's bias sums
  const int tid = threadIdx.x, lane = tid & 31;
  const size_t Mp = d.Mp;
  const T* k_rgb = static_cast<const T*>(cp.k_rgb);
  const T* k_den = static_cast<const T*>(cp.k_den);
  const int i_view = d.depth + 2, last = d.depth_cond - 1;
  for (int c = tid; c < Cg; c += THREADS) dbacc[c] = 0.f;

  Gemm gemm;
  int m0 = 0;
  // Cotangent in the accumulators -> its column sums into dbacc, the tile
  // (compute dtype) in place over the layer input and out to G rows g_off.
  auto finish = [&](int g_off, int n, bool to_g1f) {
    gemm.colsum(n, part);
    if (to_g1f)
      gemm.transform(n, [&](int row, int col, float v) {
        g1f[(size_t)col * Mp + m0 + row] = v;
        return v;
      });
    gemm.store(ga, n);
    copy_tile_out(G + (size_t)g_off * Mp, Mp, m0, ga, n);
    for (int c = tid; c < n; c += THREADS) dbacc[g_off + c] += part[c] + part[MAX_OUT + c];
  };
  auto relu_mask = [&](int a) {
    const ActTile<T, PM> t = act_tile<T, PM>(acts, a, m0, d);
    return [t](int row, int col, float v) { return t(row, col) > 0.f ? v : 0.f; };
  };
  for (int tile = blockIdx.x; tile < d.Mp / TM; tile += gridDim.x) {
    m0 = tile * TM;
    // 1. Head cotangents; with activated heads, the activation derivatives
    //    folded in: d sigmoid = s (1 - s) widened by the padding, d
    //    softplus(z + b) = sigmoid(z + b), from the raw heads.
    if constexpr (CL) {
      for (int idx = tid; idx < nh * TM; idx += THREADS) {
        const int c = idx / TM, row = idx - c * TM, m = m0 + row;
        float g = 0.f;
        if (m < d.M) g = c < 3 ? g_rgb[(size_t)m * 3 + c] : g_dens[(size_t)m * d.nd + c - 3];
        const T gb = Ty<T>::from_f(g);
        gh[idx] = g;
        ghc[idx] = Ty<T>::to_f(gb);
        G[(size_t)(c < 3 ? d.g_rgb() + c : d.g_den() + c - 3) * Mp + m0 + row] = gb;
      }
    } else {
      const int c = tid / TM, row = tid - c * TM, m = m0 + row;
      float g = 0.f;
      if (m < d.M) {
        g = c < 3 ? g_rgb[(size_t)m * 3 + c] : g_dens[m];
        if (d.use_act) {
          const float raw = PM ? raw_head<T, PM>(acts, cp, d, c, m0, row)
                               : heads[(size_t)c * Mp + m];
          if (c < 3) {
            const float s = 1.f / (1.f + expf(-raw));
            g = g * ((1.f + 2.f * d.rgb_padding) * s * (1.f - s));
          } else {
            g = g * (1.f / (1.f + expf(-(raw + d.density_bias))));
          }
        }
      }
      const T gb = Ty<T>::from_f(g);
      gh[tid] = g;
      ghc[tid] = Ty<T>::to_f(gb);
      G[(size_t)(c < 3 ? d.g_rgb() + c : d.g_den()) * Mp + m0 + row] = gb;
    }
    __syncthreads();
    if (tid < nh) {
      float s = 0.f;
      for (int row = 0; row < TM; ++row) s += gh[tid * TM + row];
      dbacc[tid < 3 ? d.g_rgb() + tid : d.g_den() + tid - 3] += s;
    }
    // 2. rgb head backward on the CUDA cores (3-deep), masked by ys[last]:
    //    the cotangent of view_last's output (NV: of the bottleneck, which
    //    has no activation).  Thread (row, j = grp + 4i).
    {
      const int row = tid & (TM - 1), half = (tid >> 5) & 1, grp = tid >> 6;
      const int n_in = NV ? d.W : d.Wv, g_row = NV ? d.g_bot() : d.g_v(last);
      const ActTile<T, PM> y = act_tile<T, PM>(acts, NV ? d.a_bot() : d.a_y(last), m0, d);
      for (int j = grp; j < n_in; j += 4) {   // warp-uniform
        float v = 0.f;
        for (int c = 0; c < 3; ++c) v = fmaf(ghc[c * TM + row], Ty<T>::to_f(k_rgb[j * 3 + c]), v);
        if constexpr (!NV) {
          if (!(y(row, j) > 0.f)) v = 0.f;
        }
        const T vb = Ty<T>::from_f(v);
        ga[(size_t)j * LD + row] = vb;
        G[(size_t)(g_row + j) * Mp + m0 + row] = vb;
        if (!CL && last == 0) g1f[(size_t)j * Mp + m0 + row] = v;
        float s = v;
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
        if (lane == 0) part[half * MAX_OUT + j] = s;
      }
      __syncthreads();
      for (int c = tid; c < n_in; c += THREADS) dbacc[g_row + c] += part[c] + part[MAX_OUT + c];
    }
    if constexpr (!NV) {
      // 3. View layers j = last .. 1: cotangent of ys[j-1], masked by it.
      for (int j = last; j >= 1; --j) {
        gemm.zero();
        gemm.segment(static_cast<const T*>(cp.bw[i_view + j]), d.Wv, 0, ga, d.Wv, slab);
        gemm.transform(d.Wv, relu_mask(d.a_y(j - 1)));
        finish(d.g_v(j - 1), d.Wv, !CL && j == 1);
      }
      // 4. view_0's per-point rows -> the bottleneck (no activation).
      gemm.zero();
      gemm.segment(static_cast<const T*>(cp.bw[i_view]), d.W, 0, ga, d.Wv, slab);
      finish(d.g_bot(), d.W, false);
    }
    // 5. Bottleneck + density -> the last trunk output, masked by it.  The
    //    density part is rank nd: sum over c of g_den[row][c] * k_den[col][c].
    gemm.zero();
    gemm.segment(static_cast<const T*>(cp.bw[d.depth + 1]), d.W, 0, ga, d.W, slab);
    {
      auto mask = relu_mask(d.a_h(d.depth - 1));
      if constexpr (CL) {
        gemm.transform(d.W, [&](int row, int col, float v) {
          for (int c = 0; c < d.nd; ++c)
            v = fmaf(ghc[(3 + c) * TM + row], Ty<T>::to_f(k_den[col * d.nd + c]), v);
          return mask(row, col, v);
        });
      } else {
        gemm.transform(d.W, [&](int row, int col, float v) {
          return mask(row, col, v + ghc[3 * TM + row] * Ty<T>::to_f(k_den[col]));
        });
      }
    }
    finish(d.g_t(d.depth - 1), d.W, false);
    // 6. Trunk i = depth-1 .. 1 -> hs[i-1] (the x rows of a skip concat
    //    carry no cotangent here), masked by it.
    for (int i = d.depth - 1; i >= 1; --i) {
      gemm.zero();
      gemm.segment(static_cast<const T*>(cp.bw[i]), d.W, 0, ga, d.W, slab);
      gemm.transform(d.W, relu_mask(d.a_h(i - 1)));
      finish(d.g_t(i - 1), d.W, false);
    }
    __syncthreads();
  }
  __syncthreads();
  for (int c = tid; c < Cg; c += THREADS) db_part[(size_t)blockIdx.x * Cg + c] = dbacc[c];
}

// The classic backward's input cotangents of the tile at blockIdx.x * TM,
// from the chain's G rows (each layer's output cotangent, compute dtype):
// dx = sum over the layers L that read x of G_L^T k_L[x rows] (trunk_0
// whole, every layer after a skip concat, after a last one the bottleneck
// and, as a rank-nd term, the density head), dview = G_view0^T
// k_view0[view rows], summed in one set of accumulators; every element is
// written once.  NV (no view layer): dview is the rank-3 term G_rgb^T
// k_rgb[view rows], summed on the CUDA cores.
template <typename T, bool NV>
__global__ void __launch_bounds__(THREADS, 2)
mlp_input_grads_kernel(const T* __restrict__ G, InputGrads ig, TrainDims d) {
  typedef typename Engine<T>::type Gemm;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int wmax = max(d.W, d.Wv);
  T* src = reinterpret_cast<T*>(smem_raw);   // [wmax][LD] G rows of the tile
  T* slab = src + (size_t)wmax * LD;         // weight rows
  const int m0 = blockIdx.x * TM;
  const size_t Mp = d.Mp;
  const bool cat_last = (d.depth - 1) % d.skip == 0 && d.depth - 1 > 0;
  const T* k_den = static_cast<const T*>(ig.k_den);
  // G rows [g_row, g_row + rows) of the tile -> src, 16 bytes an access.
  auto load = [&](int g_row, int rows) {
    constexpr int VEC = 16 / sizeof(T), PER_ROW = TM / VEC;
    __syncthreads();
    for (int v = threadIdx.x; v < rows * PER_ROW; v += THREADS) {
      const int r = v / PER_ROW, c = (v - r * PER_ROW) * VEC;
      *reinterpret_cast<uint4*>(src + (size_t)r * LD + c) =
          *reinterpret_cast<const uint4*>(G + (size_t)(g_row + r) * Mp + m0 + c);
    }
    __syncthreads();
  };
  Gemm gemm;
  gemm.zero();
  for (int L = 0; L <= d.depth + 1; ++L) {
    const bool reads_x = L == 0 || (L < d.depth ? (L - 1) % d.skip == 0 && L - 1 > 0
                                                : L == d.depth + 1 && cat_last);
    if (!reads_x) continue;
    load(L == d.depth + 1 ? d.g_bot() : d.g_t(L), d.W);
    gemm.segment(static_cast<const T*>(ig.bx[L]), d.Fp, 0, src, d.W, slab);
  }
  gemm.transform(d.Fp, [&](int row, int col, float v) {
    const int m = m0 + row;
    if (m < d.M && col < d.F) {
      if (cat_last)
        for (int c = 0; c < d.nd; ++c)
          v = fmaf(Ty<T>::to_f(G[(size_t)(d.g_den() + c) * Mp + m]),
                   Ty<T>::to_f(k_den[(d.W + col) * d.nd + c]), v);
      ig.dx[(size_t)m * d.F + col] = v;
    }
    return v;
  });
  if constexpr (NV) {
    const T* bv = static_cast<const T*>(ig.bv);
    for (int idx = threadIdx.x; idx < TM * d.Fv; idx += THREADS) {
      const int row = idx / d.Fv, col = idx - row * d.Fv, m = m0 + row;
      if (m >= d.M) continue;
      float v = 0.f;
      for (int c = 0; c < 3; ++c)
        v = fmaf(Ty<T>::to_f(G[(size_t)(d.g_rgb() + c) * Mp + m]),
                 Ty<T>::to_f(bv[c * d.Fvp + col]), v);
      ig.dview[(size_t)m * d.Fv + col] = v;
    }
  } else {
    gemm.zero();
    load(d.g_v(0), d.Wv);
    gemm.segment(static_cast<const T*>(ig.bv), d.Fvp, 0, src, d.Wv, slab);
    gemm.transform(d.Fvp, [&](int row, int col, float v) {
      const int m = m0 + row;
      if (m < d.M && col < d.Fv) ig.dview[(size_t)m * d.Fv + col] = v;
      return v;
    });
  }
}

template <typename T>
size_t input_grads_smem_bytes(const TrainDims& d) {
  const int wmax = d.W > d.Wv ? d.W : d.Wv;
  return sizeof(T) * ((size_t)wmax * LD + Engine<T>::type::slab_elems(wmax));
}

// g_ray[r][j] = compute-dtype(sum over ray r's N samples of g1f[j][.]):
// one warp per (r, j), lanes over the samples, a fixed shuffle tree.
template <typename T>
__global__ void lean_ray_sum_kernel(const float* __restrict__ g1f, int Mp, int N, int R, int Wv,
                                    T* __restrict__ g_ray) {
  const int w = (int)(((size_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5), lane = threadIdx.x & 31;
  if (w >= R * Wv) return;   // warp-uniform
  const int r = w / Wv, j = w - r * Wv;
  const float* src = g1f + (size_t)j * Mp + (size_t)r * N;
  float s = 0.f;
  for (int i = lane; i < N; i += 32) s += src[i];
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  if (lane == 0) g_ray[(size_t)r * Wv + j] = Ty<T>::from_f(s);
}

// dw[f][j] = sum over rays of cast(view[r][f]) * g_ray[r][j]: the
// gradient of view_0's per-ray rows.  Block (f, 32 columns); warp w sums
// the rays w, w + 8, ... for its lane's column, then the 8 warp sums add in
// a fixed order.
template <typename T>
__global__ void __launch_bounds__(256)
lean_view_rows_kernel(const float* __restrict__ view, const T* __restrict__ g_ray, int R, int Fv,
                      int Wv, float* __restrict__ dw) {
  __shared__ float part[8][32];
  const int f = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.y * 32 + lane;
  float s = 0.f;
  if (j < Wv)
    for (int r = warp; r < R; r += 8)
      s = fmaf(Ty<T>::to_f(Ty<T>::from_f(view[(size_t)r * Fv + f])),
               Ty<T>::to_f(g_ray[(size_t)r * Wv + j]), s);
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && j < Wv) {
    float t = 0.f;
    for (int w = 0; w < 8; ++w) t += part[w][lane];
    dw[(size_t)f * Wv + j] = t;
  }
}

}  // namespace

#include "lean_chain_sm90.cuh"

namespace {

bool dims_ok(const TrainDims& d, int n_layers, int use_bf16) {
  const int align = use_bf16 ? 16 : 8;
  // No view layer (depth_cond 0, Wv 0): the classic kernels only.
  const bool view_ok = d.depth_cond >= 1 ? d.Wv >= align && d.Wv <= MAX_OUT && d.Wv % align == 0
                                         : d.depth_cond == 0 && d.Wv == 0 && d.Fvp > 0;
  return n_layers == d.depth + 3 + d.depth_cond && n_layers <= MAX_LAYERS && d.depth >= 1 &&
         view_ok && d.skip >= 1 && d.W >= align && d.W <= MAX_OUT && d.W % align == 0 &&
         d.M == d.R * d.N && d.M > 0 &&
         d.Mp % TM == 0 && d.Mp >= d.M && d.F >= 1 && d.F <= d.Fp && d.Fp % 16 == 0 &&
         d.Fv >= 1 && (d.use_act == 0 || d.use_act == 1) && d.L >= 0 &&
         (d.L == 0 || d.F == 6 * d.L) && d.nd >= 1 && 3 + d.nd <= MAX_HEADS &&
         (d.Fvp == 0 ? d.nd == 1
                     : d.Fvp >= d.Fv && d.Fvp % 16 == 0 && d.Fp <= d.W && d.Fvp <= d.W &&
                           d.L == 0 && d.use_act == 0 && d.N == 1);
}

TrainDims read_dims(const int* v, float rgb_padding, float density_bias, int use_act) {
  return TrainDims{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8], v[9], v[10], v[11],
                   rgb_padding, density_bias, use_act, v[12], v[13], v[0], v[14], v[15]};
}

LayerPtrs layer_ptrs(const void* weights, const void* biases, int n_layers) {
  LayerPtrs p;
  const void* const* w = static_cast<const void* const*>(weights);
  const void* const* b = static_cast<const void* const*>(biases);
  for (int i = 0; i < n_layers; ++i) {
    p.w[i] = w[i];
    p.b[i] = static_cast<const float*>(b[i]);
  }
  return p;
}

template <typename T, bool NV>
int launch_classic_fwd(const float* x, const float* view, const LayerPtrs& p, const TrainDims& d,
                       float* rgb, float* density, T* saved, cudaStream_t s) {
  const size_t smem = classic_fwd_smem<T>(d);
  cudaError_t e = cudaFuncSetAttribute((const void*)mlp_fwd_kernel<T, NV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  mlp_fwd_kernel<T, NV><<<d.Mp / TM, THREADS, smem, s>>>(x, view, p, d, rgb, density, saved);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd(const float* x, const float* vproj, const LayerPtrs& p, const TrainDims& d,
               float* out, T* saved, float* heads, cudaStream_t s) {
  const size_t smem = mlp_smem_bytes<T>(d.Fp, d.W > d.Wv ? d.W : d.Wv);
  const FwdKernel<T> kernel = fwd_kernel<T>(d);
  cudaError_t e = cudaFuncSetAttribute((const void*)kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<d.Mp / TM, THREADS, smem, s>>>(x, vproj, p, d, out, saved, heads);
  return (int)cudaGetLastError();
}

int fwd_entry(const void* x, const void* vproj, const void* weights, const void* biases,
              int n_layers, void* out, void* saved, void* heads, const int* dims,
              float rgb_padding, float density_bias, int use_act, int use_bf16, void* stream) {
  const TrainDims d = read_dims(dims, rgb_padding, density_bias, use_act);
  if (!dims_ok(d, n_layers, use_bf16) || d.Fvp) return (int)cudaErrorInvalidValue;
  const LayerPtrs p = layer_ptrs(weights, biases, n_layers);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* vp = static_cast<const float*>(vproj);
  float* o = static_cast<float*>(out);
  float* h = static_cast<float*>(heads);
  return use_bf16 ? launch_fwd<bf16>(xf, vp, p, d, o, static_cast<bf16*>(saved), h, s)
                  : launch_fwd<float>(xf, vp, p, d, o, static_cast<float*>(saved), h, s);
}

// The backward's arguments that every mode shares.
struct GradArgs {
  const float *g_rgb, *g_dens, *view;
  InputGrads ig;      // the classic entries only
  ChainPtrs cp;
  void* G;          // [Cg][chunk] compute dtype
  float* g1f;       // [Wv][chunk]
  float* db_part;   // [chunks * n_chain][Cg]
  int n_chain;
  float* partial;   // [ceil(Mp / MC)][PW], zeroed
  int MC;
  WgradTable tab;
  int n_tiles, PW;
  void* g_ray;      // [R][Wv] compute dtype
  float *dw, *db;   // [PW], [Cg]
  int view_off;
};

// Recompute mode: the forward re-run of each chunk (chunk-sized S, heads);
// the classic MLP reads the per-point view where the lean kernels read
// vproj.
struct Refwd {
  const float* x;
  const float* vproj;
  LayerPtrs p;
  void* S;
  float* heads;
};

// The chunks [c0, c0 + chunk) of the level, then the reductions.  acts /
// heads describe the whole level (save: S and its heads; hybrid: the
// point-major streams, heads null) unless rf re-runs the forward per chunk.
// CL: the classic MLP (its forward re-run, dx / dview, no per-ray sums);
// NV: the classic MLP with no view layer.
template <typename T, bool PM, bool CL = false, bool NV = false>
int run_grads(const GradArgs& a, const TrainDims& d, int chunk, const Refwd* rf,
              const Acts& level_acts, const float* level_heads, cudaStream_t s) {
  const int Cg = d.cg(), wmax = d.W > d.Wv ? d.W : d.Wv;
  const size_t csmem = chain_smem_bytes<T>(wmax, Cg, 3 + d.nd);
  const size_t wsmem = sizeof(T) == 2 ? 0 : sizeof(float) * WGRAD_ACC * THREADS;
  const size_t fsmem = CL ? classic_fwd_smem<T>(d) : mlp_smem_bytes<T>(d.Fp, wmax);
  cudaError_t e = cudaFuncSetAttribute(lean_grad_chain_kernel<T, PM, CL, NV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)csmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(lean_wgrad_kernel<T, PM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)wsmem);
  const FwdKernel<T> refwd = CL ? (FwdKernel<T>)nullptr : fwd_kernel<T>(d);
  if (e == cudaSuccess && rf)
    e = cudaFuncSetAttribute(CL ? (const void*)mlp_fwd_kernel<T, NV> : (const void*)refwd,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)fsmem);
  const size_t ismem = input_grads_smem_bytes<T>(d);
  if (e == cudaSuccess && CL)
    e = cudaFuncSetAttribute(mlp_input_grads_kernel<T, NV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ismem);
  // The lean chain of a bf16 channel-major stream runs on wgmma
  // (lean_chain_sm90.cuh) wherever its plan fits; its grid is one block an
  // SM at most.
  constexpr bool sm90 = sizeof(T) == 2 && !PM && !CL && !NV;
  int sms = 0, dev = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && sm90 && chain_sm90_smem(Cg) <= CH_SMEM_MAX)
    e = cudaFuncSetAttribute(lean_chain_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)chain_sm90_smem(Cg));
  if (e != cudaSuccess) return (int)e;
  ChainPlan plan;
  T* G = static_cast<T*>(a.G);
  T* g_ray = static_cast<T*>(a.g_ray);
  int n_chunks = 0;
  for (int c0 = 0; c0 < d.M; c0 += chunk, ++n_chunks) {
    TrainDims dc = d;
    dc.M = d.M - c0 < chunk ? d.M - c0 : chunk;
    dc.Mp = (dc.M + TM - 1) / TM * TM;
    dc.R = dc.M / d.N;
    Acts acts = level_acts;
    const float* heads = level_heads;
    if (rf) {
      T* S = static_cast<T*>(rf->S);
      if constexpr (CL) {
        // Rows start at x[c0][0] and view[c0][0].
        mlp_fwd_kernel<T, NV><<<dc.Mp / TM, THREADS, fsmem, s>>>(
            rf->x + (size_t)c0 * d.F, rf->vproj + (size_t)c0 * d.Fv, rf->p, dc, nullptr, nullptr,
            S);
      } else {
        // Rows start at x[c0][0], moments at column c0 of x [6][ldx].
        refwd<<<dc.Mp / TM, THREADS, fsmem, s>>>(
            rf->x + (d.L ? (size_t)c0 : (size_t)c0 * d.F), rf->vproj + (size_t)(c0 / d.N) * d.Wv,
            rf->p, dc, nullptr, S, rf->heads);
      }
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
      for (int i = 0; i < d.n_acts(); ++i) {
        acts.t[i] = S + (size_t)d.s_row(i) * dc.Mp;
        acts.ld[i] = dc.Mp;
      }
      heads = rf->heads;
    } else if (PM) {
      for (int i = 0; i < d.n_acts(); ++i)
        acts.t[i] = static_cast<const T*>(level_acts.t[i]) + (size_t)c0 * level_acts.ld[i];
    }
    float* db_part = a.db_part + (size_t)n_chunks * a.n_chain * Cg;
    if (sm90 && chain_sm90_plan(plan, acts, a.cp, dc, G)) {
      const int tiles = (dc.Mp + CH_TM - 1) / CH_TM;
      lean_chain_sm90_kernel<<<tiles < sms ? tiles : sms, CH_THREADS, chain_sm90_smem(Cg), s>>>(
          plan, heads, a.g_rgb + (size_t)c0 * 3, a.g_dens + (size_t)c0 * d.nd, a.cp, dc,
          reinterpret_cast<bf16*>(G), a.g1f, db_part, a.n_chain);
    } else {
      lean_grad_chain_kernel<T, PM, CL, NV><<<a.n_chain, THREADS, csmem, s>>>(
          acts, heads, a.g_rgb + (size_t)c0 * 3, a.g_dens + (size_t)c0 * d.nd, a.cp, dc, G,
          a.g1f, db_part);
    }
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    if constexpr (CL) {
      InputGrads ig = a.ig;
      ig.dx += (size_t)c0 * d.F;
      ig.dview += (size_t)c0 * d.Fv;
      mlp_input_grads_kernel<T, NV><<<dc.Mp / TM, THREADS, ismem, s>>>(G, ig, dc);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    float* partial = a.partial + (size_t)(c0 / a.MC) * a.PW;
    if constexpr (sizeof(T) == 2 && !PM) {
      // The activations are rows of one stream: their offsets from X's.
      int a_row[MAX_LAYERS];
      for (int i = 0; i < d.n_acts(); ++i)
        a_row[i] = (int)((static_cast<const char*>(acts.t[i]) -
                          static_cast<const char*>(acts.t[0])) /
                         (2 * (long long)acts.ld[0]));
      e = (cudaError_t)launch_wgrad_sm90(acts.t[0], stream_rows(d), a_row, d.n_acts(), G, Cg,
                                         a.tab, a.n_tiles, dc.Mp, a.MC, partial, a.PW, s);
      if (e != cudaSuccess) return (int)e;
    } else {
      const dim3 grid(a.n_tiles, (dc.Mp + a.MC - 1) / a.MC);
      lean_wgrad_kernel<T, PM><<<grid, THREADS, wsmem, s>>>(acts, G, a.tab, dc.Mp, dc.M, a.MC,
                                                             partial, a.PW);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    if constexpr (!CL) {
      const long long warps = (long long)dc.R * d.Wv;
      lean_ray_sum_kernel<T><<<(int)((warps * 32 + 255) / 256), 256, 0, s>>>(
          a.g1f, dc.Mp, d.N, dc.R, d.Wv, g_ray + (size_t)(c0 / d.N) * d.Wv);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
  }
  const int splits = (d.Mp + a.MC - 1) / a.MC;
  sum_rows_kernel<<<(a.PW + 255) / 256, 256, 0, s>>>(a.partial, splits, a.PW, a.dw);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  sum_rows_kernel<<<(Cg + 255) / 256, 256, 0, s>>>(a.db_part, n_chunks * a.n_chain, Cg, a.db);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if constexpr (!CL) {
    lean_view_rows_kernel<T><<<dim3(d.Fv, (d.Wv + 31) / 32), 256, 0, s>>>(
        a.view, g_ray, d.R, d.Fv, d.Wv, a.dw + a.view_off);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

// The parameters every backward entry takes after its mode's own.
#define LEAN_GRAD_PARAMS                                                                       \
  const void *g_rgb, const void *g_dens, const void *view, const void *chain_w, int n_layers,  \
      const void *k_den, const void *k_rgb, const void *b_den, const void *b_rgb, void *G,     \
      void *g1f, void *db_part, int n_chain, void *partial, int MC, const int *probs,          \
      int n_probs, const int *tiles, int n_tiles, int PW, void *g_ray, void *dw, void *db,     \
      int view_off, const int *dims, float rgb_padding, float density_bias, int use_act,       \
      int use_bf16, void *stream
#define LEAN_GRAD_ARGS                                                                          \
  g_rgb, g_dens, view, chain_w, n_layers, k_den, k_rgb, b_den, b_rgb, G, g1f, db_part, n_chain, \
      partial, MC, probs, n_probs, tiles, n_tiles, PW, g_ray, dw, db, view_off, dims,           \
      rgb_padding, density_bias, use_act, use_bf16, stream

namespace {

// Checks and unpacks the shared arguments; 0 or a cudaError_t.
int read_grad_args(GradArgs& a, TrainDims& d, LEAN_GRAD_PARAMS) {
  (void)stream;
  d = read_dims(dims, rgb_padding, density_bias, use_act);
  if (!dims_ok(d, n_layers, use_bf16) || n_probs < 1 || n_probs > MAX_PROBS || n_tiles < 1 ||
      n_tiles > MAX_TILES || n_chain < 1 || MC < TM || MC % TM || MC % d.N || MC % KC)
    return (int)cudaErrorInvalidValue;
  a.g_rgb = static_cast<const float*>(g_rgb);
  a.g_dens = static_cast<const float*>(g_dens);
  a.view = static_cast<const float*>(view);
  const void* const* cw = static_cast<const void* const*>(chain_w);
  for (int i = 0; i < MAX_LAYERS; ++i) a.cp.bw[i] = i < n_layers ? cw[i] : nullptr;
  a.ig = InputGrads{};
  a.cp.k_den = k_den;
  a.cp.k_rgb = k_rgb;
  a.cp.b_den = static_cast<const float*>(b_den);
  a.cp.b_rgb = static_cast<const float*>(b_rgb);
  for (int i = 0; i < n_probs; ++i) {
    for (int k = 0; k < 6; ++k) a.tab.prob[i][k] = probs[6 * i + k];
    if (a.tab.prob[i][0] < 0 || a.tab.prob[i][0] >= d.n_acts()) return (int)cudaErrorInvalidValue;
  }
  for (int i = 0; i < n_tiles; ++i) {
    for (int k = 0; k < 3; ++k) a.tab.tile[i][k] = tiles[3 * i + k];
    if (a.tab.tile[i][0] < 0 || a.tab.tile[i][0] >= n_probs) return (int)cudaErrorInvalidValue;
  }
  a.G = G;
  a.g1f = static_cast<float*>(g1f);
  a.db_part = static_cast<float*>(db_part);
  a.n_chain = n_chain;
  a.partial = static_cast<float*>(partial);
  a.MC = MC;
  a.n_tiles = n_tiles;
  a.PW = PW;
  a.g_ray = g_ray;
  a.dw = static_cast<float*>(dw);
  a.db = static_cast<float*>(db);
  a.view_off = view_off;
  return 0;
}

// One chunk over the whole level (save, hybrid).
int level_chunk(const TrainDims& d, int MC) { return (d.Mp + MC - 1) / MC * MC; }

// The classic backward's own arguments (see mlp_bwd_saved); 0 or a
// cudaError_t.  The layers whose input holds x must have their x columns.
int read_classic(GradArgs& a, const TrainDims& d, void* dx, void* dview, const void* x_chain,
                 const void* kv, int n_layers) {
  if (!d.Fvp || !dx || !dview || !x_chain || !kv) return (int)cudaErrorInvalidValue;
  const void* const* xc = static_cast<const void* const*>(x_chain);
  for (int i = 0; i < n_layers; ++i) a.ig.bx[i] = xc[i];
  bool ok = a.ig.bx[0] != nullptr;
  for (int i = 1; i < d.depth; ++i)
    if ((i - 1) % d.skip == 0 && i - 1 > 0) ok = ok && a.ig.bx[i];
  if ((d.depth - 1) % d.skip == 0 && d.depth - 1 > 0) ok = ok && a.ig.bx[d.depth + 1];
  if (!ok) return (int)cudaErrorInvalidValue;
  a.ig.bv = kv;
  a.ig.k_den = a.cp.k_den;
  a.ig.dx = static_cast<float*>(dx);
  a.ig.dview = static_cast<float*>(dview);
  return 0;
}

// run_grads of the classic MLP: with view layers, or (depth_cond 0) none.
int run_classic(const GradArgs& a, const TrainDims& d, int chunk, const Refwd* rf,
                const Acts& acts, int use_bf16, cudaStream_t s) {
  if (d.depth_cond == 0)
    return use_bf16 ? run_grads<bf16, false, true, true>(a, d, chunk, rf, acts, nullptr, s)
                    : run_grads<float, false, true, true>(a, d, chunk, rf, acts, nullptr, s);
  return use_bf16 ? run_grads<bf16, false, true>(a, d, chunk, rf, acts, nullptr, s)
                  : run_grads<float, false, true>(a, d, chunk, rf, acts, nullptr, s);
}

int classic_fwd_entry(const void* x, const void* view, const void* weights, const void* biases,
                      int n_layers, void* rgb, void* density, void* saved, const int* dims,
                      int use_bf16, void* stream) {
  const TrainDims d = read_dims(dims, 0.f, 0.f, 0);
  if (!dims_ok(d, n_layers, use_bf16) || !d.Fvp) return (int)cudaErrorInvalidValue;
  const LayerPtrs p = layer_ptrs(weights, biases, n_layers);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* vf = static_cast<const float*>(view);
  float* r = static_cast<float*>(rgb);
  float* dn = static_cast<float*>(density);
  bf16* sb = static_cast<bf16*>(saved);
  float* sf = static_cast<float*>(saved);
  if (d.depth_cond == 0)
    return use_bf16 ? launch_classic_fwd<bf16, true>(xf, vf, p, d, r, dn, sb, s)
                    : launch_classic_fwd<float, true>(xf, vf, p, d, r, dn, sf, s);
  return use_bf16 ? launch_classic_fwd<bf16, false>(xf, vf, p, d, r, dn, sb, s)
                  : launch_classic_fwd<float, false>(xf, vf, p, d, r, dn, sf, s);
}

}  // namespace

extern "C" {

// dims = {M, Mp, N, R, F, Fp, Fv, depth, depth_cond, skip, W, Wv, L,
// min_deg}.  x [M, F] f32 encode rows (L = 0) or the [6, M] f32 moments
// (F = 6L), vproj [R, Wv] f32 (view_0's per-ray half), weights[i]
// [in_i, out_i] in the compute dtype and biases[i] [out_i] f32 (rounded
// through the compute dtype) in param order -> out [M, 4] f32 (rgb |
// sigma, activated when use_act, else raw).
int lean_fwd(const void* x, const void* vproj, const void* weights, const void* biases,
             int n_layers, void* out, const int* dims, float rgb_padding, float density_bias,
             int use_act, int use_bf16, void* stream) {
  return fwd_entry(x, vproj, weights, biases, n_layers, out, nullptr, nullptr, dims, rgb_padding,
                   density_bias, use_act, use_bf16, stream);
}

// lean_fwd that also writes saved [Cs][Mp] compute dtype and heads [4][Mp]
// f32 (raw).
int lean_save_fwd(const void* x, const void* vproj, const void* weights, const void* biases,
                  int n_layers, void* out, void* saved, void* heads, const int* dims,
                  float rgb_padding, float density_bias, int use_act, int use_bf16, void* stream) {
  if (!saved || !heads) return (int)cudaErrorInvalidValue;
  return fwd_entry(x, vproj, weights, biases, n_layers, out, saved, heads, dims, rgb_padding,
                   density_bias, use_act, use_bf16, stream);
}

// The shared arguments: g_rgb [M, 3] / g_dens [M, 1] / view [R, Fv] f32;
// chain_w[i] (param index; null where unused) the transposed h-part
// kernels, k_den / k_rgb the head kernels (compute dtype), b_den / b_rgb
// their biases (f32).  Scratch: G [Cg][chunk] and g_ray [R][Wv] compute
// dtype, g1f [Wv][chunk], db_part [chunks * n_chain][Cg], partial
// [ceil(Mp / MC)][PW] (zeroed) f32.  Out: dw [PW] (every kernel in param
// order, [in, out] row-major), db [Cg] (every bias).  probs [n_probs][6]
// and tiles [n_tiles][3] are the weight-gradient problems and their output
// tiles; MC, the points of a partial sum, is a multiple of 64 and of N;
// view_off is the offset in dw of view_0's per-ray rows.

// saved / heads from lean_save_fwd.
int lean_param_grads(const void* saved, const void* heads, LEAN_GRAD_PARAMS) {
  GradArgs a;
  TrainDims d;
  int err = read_grad_args(a, d, LEAN_GRAD_ARGS);
  if (err) return err;
  if (d.Fvp) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t esize = use_bf16 ? 2 : 4;
  Acts acts;
  for (int i = 0; i < d.n_acts(); ++i) {
    acts.t[i] = static_cast<const char*>(saved) + esize * d.s_row(i) * d.Mp;
    acts.ld[i] = d.Mp;
  }
  const float* h = static_cast<const float*>(heads);
  const int chunk = level_chunk(d, MC);
  return use_bf16 ? run_grads<bf16, false>(a, d, chunk, nullptr, acts, h, s)
                  : run_grads<float, false>(a, d, chunk, nullptr, acts, h, s);
}

// x / vproj / weights / biases as lean_fwd takes them (rows or moments, as
// dims' L says: the re-run decodes with the forward's loader and tiles, so
// its ReLU masks are the forward's); saved [Cs][chunk]
// and heads [4][chunk] are scratch for the forward of one chunk of `chunk`
// points (a multiple of MC).
int lean_param_grads_recompute(const void* x, const void* vproj, const void* weights,
                               const void* biases, void* saved, void* heads, int chunk,
                               LEAN_GRAD_PARAMS) {
  GradArgs a;
  TrainDims d;
  int err = read_grad_args(a, d, LEAN_GRAD_ARGS);
  if (err) return err;
  if (d.Fvp || chunk < MC || chunk % MC) return (int)cudaErrorInvalidValue;
  const Refwd rf{static_cast<const float*>(x), static_cast<const float*>(vproj),
                 layer_ptrs(weights, biases, n_layers), saved, static_cast<float*>(heads)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Acts none{};
  return use_bf16 ? run_grads<bf16, false>(a, d, chunk, &rf, none, nullptr, s)
                  : run_grads<float, false>(a, d, chunk, &rf, none, nullptr, s);
}

// acts[a] the row-major compute-dtype residuals of the plain forward: x
// [M, Fp] (zero past column F) | hs, bottleneck [M, W] | ys [M, Wv].
int lean_param_grads_hybrid(const void* acts, LEAN_GRAD_PARAMS) {
  GradArgs a;
  TrainDims d;
  int err = read_grad_args(a, d, LEAN_GRAD_ARGS);
  if (err) return err;
  if (d.Fvp) return (int)cudaErrorInvalidValue;
  Acts level;
  const void* const* t = static_cast<const void* const*>(acts);
  for (int i = 0; i < d.n_acts(); ++i) {
    level.t[i] = t[i];
    level.ld[i] = i == 0 ? d.Fp : i <= d.depth + 1 ? d.W : d.Wv;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunk = level_chunk(d, MC);
  return use_bf16 ? run_grads<bf16, true>(a, d, chunk, nullptr, level, nullptr, s)
                  : run_grads<float, true>(a, d, chunk, nullptr, level, nullptr, s);
}

// The classic MLP (fused_mlp).  dims as above with N = 1 (R = M), L = 0,
// nd the density heads and Fvp = Fv rounded up to 16.  x [M, F] and view
// [M, Fv] f32 per point, weights / biases as lean_fwd takes them -> rgb
// [M, 3] and density [M, nd] f32, the raw heads.
int mlp_fwd(const void* x, const void* view, const void* weights, const void* biases,
            int n_layers, void* rgb, void* density, const int* dims, int use_bf16, void* stream) {
  return classic_fwd_entry(x, view, weights, biases, n_layers, rgb, density, nullptr, dims,
                           use_bf16, stream);
}

// mlp_fwd that also writes saved [Cs][Mp] in the compute dtype: X | hs |
// bottleneck | ys | V (the view, Fvp rows).
int mlp_save_fwd(const void* x, const void* view, const void* weights, const void* biases,
                 int n_layers, void* rgb, void* density, void* saved, const int* dims,
                 int use_bf16, void* stream) {
  if (!saved) return (int)cudaErrorInvalidValue;
  return classic_fwd_entry(x, view, weights, biases, n_layers, rgb, density, saved, dims,
                           use_bf16, stream);
}

// The classic backward from mlp_save_fwd's stream: the shared arguments as
// above (use_act 0; g_dens [M, nd]; g1f and g_ray unused, may be null),
// and its own: out dx [M, F] and dview [M, Fv] f32; x_chain[i] (param
// index, null where unused) the transposed x columns [out][Fp] of trunk_0,
// of each layer after a skip concat and (after a last one) of the
// bottleneck; kv view_0's view rows transposed, [Wv][Fvp] (compute dtype,
// zero past F / Fv).  dw also takes view_0's view rows as a problem of the
// stream's V rows.
int mlp_bwd_saved(const void* saved, void* dx, void* dview, const void* x_chain, const void* kv,
                  LEAN_GRAD_PARAMS) {
  GradArgs a;
  TrainDims d;
  int err = read_grad_args(a, d, LEAN_GRAD_ARGS);
  if (!err) err = read_classic(a, d, dx, dview, x_chain, kv, n_layers);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t esize = use_bf16 ? 2 : 4;
  Acts acts;
  for (int i = 0; i < d.n_acts(); ++i) {
    acts.t[i] = static_cast<const char*>(saved) + esize * d.s_row(i) * d.Mp;
    acts.ld[i] = d.Mp;
  }
  return run_classic(a, d, level_chunk(d, MC), nullptr, acts, use_bf16, s);
}

// mlp_bwd_saved with the forward re-run by mlp_fwd's kernel chunk by
// chunk: x / view_pts / weights / biases as mlp_fwd takes them, saved
// [Cs][chunk] scratch for one chunk of `chunk` points (a multiple of MC).
int mlp_bwd_recompute(const void* x, const void* view_pts, const void* weights,
                      const void* biases, void* saved, int chunk, void* dx, void* dview,
                      const void* x_chain, const void* kv, LEAN_GRAD_PARAMS) {
  GradArgs a;
  TrainDims d;
  int err = read_grad_args(a, d, LEAN_GRAD_ARGS);
  if (!err) err = read_classic(a, d, dx, dview, x_chain, kv, n_layers);
  if (err) return err;
  if (chunk < MC || chunk % MC) return (int)cudaErrorInvalidValue;
  const Refwd rf{static_cast<const float*>(x), static_cast<const float*>(view_pts),
                 layer_ptrs(weights, biases, n_layers), saved, nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return run_classic(a, d, chunk, &rf, Acts{}, use_bf16, s);
}

// The dynamic shared memory of the wgmma kernels for a backward whose G
// has Cg rows: out[0] the chain's, out[1] the weight gradients'.
int lean_sm90_smem(int Cg, int* out) {
  out[0] = (int)chain_sm90_smem(Cg);
  out[1] = (int)wgrad_sm90_smem();
  return 0;
}

}  // extern "C"
