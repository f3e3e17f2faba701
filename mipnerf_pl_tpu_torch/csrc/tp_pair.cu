// Megatron pair kernels of the tensor-parallel lean MLP for Hopper
// (sm_90a), plain C interface.
//
// Replaces the TPU kernels of mipnerf_pl_tpu/kernels/tp_lean.py:
//
//   tp_pair_fwd  _pair_kernel (pl.pallas_call in _pair_call): one model
//                shard's half of a column-parallel / row-parallel layer
//                pair, out = relu(x Wcol + bcol) Wrow, the f32 partial sum
//                before the sum over the model axis.  x [M, f_in] f32 or
//                compute dtype, Wcol [f_in, Wl], bcol [Wl] f32, Wrow
//                [Wl, Wout] -> out [M, Wout] f32.  No bias and no ReLU after
//                the second product: they follow the sum, outside.
//   tp_pair_bwd  _pair_bwd_kernel (_pair_bwd_call): from the pair's inputs
//                and g [M, Wout] f32, dx [M, f_in], dWcol [f_in, Wl], dbcol
//                [Wl], dWrow [Wl, Wout], all f32.  The hidden activation is
//                recomputed, never read back.
//
// Casts as the TPU bodies place them: x to the compute dtype, the bias added
// to the f32 sum, ReLU, cast; g cast before every product; the ReLU mask is
// hpre > 0 on the f32 pre-activation; dbcol sums the f32 dh, dWcol and dx
// take the cast one.
//
// What bounds them: 2 M Wl (f_in + Wout) FLOP forward and 2 M Wl (3 f_in +
// 2 Wout) backward against (f_in + Wout) values a row moved once, so both
// are compute bound on the tensor cores at every width the model uses.
//
// The TPU kernels hold both weight panels in VMEM.  At W = 1024 on two
// shards a panel is 1 MB (bf16) or 2 MB (f32), and an SM has 227 KB: here a
// 64-row tile keeps its [Wl][64] hidden activation in shared memory, the
// panels stream from L2 through the engines' slabs (lean_engines.cuh), and
// x and g pass through a 128-row staging tile, so any f_in and Wout fit.
// The engines cover 256 output columns: wider outputs are column chunks of
// the same panel (segment_ld).
//
// At the widths of the tensor-parallel slice (a local width a multiple of
// 64 up to 512, an output width a multiple of 64: pair_wg_route) both run
// on the wgmma / TMA kernel of tp_pair_sm90.cuh, tp_pair_wg_kernel, bf16
// and 3xTF32; the kernels below (tp_pair_fwd_kernel, tp_pair_bwd_kernel,
// mma.sync through lean_engines.cuh) take the other widths.
//
// The TPU backward adds the parameter gradients over a sequential grid.
// Here, over chunks of rows:
//   1. the chain (tp_pair_wg_kernel, else tp_pair_bwd_kernel), persistent
//      blocks over 64-row tiles: the hidden tile again; dh = (g Wrow^T)
//      masked, in place over it; dx = dh Wcol^T; per-block column sums of
//      dh; and the four operands of the weight gradients out to a
//      chunk-sized channel-major stream S in the compute dtype: x | h | g |
//      dh.
//   2. dWcol = x^T dh and dWrow = h^T g as split-K products over row
//      ranges, per-range partial sums, on wgmma fed by a TMA ring: in bf16
//      wgrad_sm90_kernel (lean_wgrad_sm90.cuh), in f32 wgrad_tf32_kernel
//      (lean_wgrad_tf32.cuh, 3xTF32).
// Then sum_rows_kernel adds the partial sums and the blocks' bias sums in
// order.  No atomics: two runs give the same bits.

#include "lean_engines.cuh"
#include "lean_wgrad_tf32.cuh"
#include "tp_pair_sm90.cuh"

namespace {

constexpr int STAGE = 128;       // rows of the staging tile (x or g columns a step)
constexpr int MAX_LOCAL = 512;   // widest local panel: rows of the hidden tile

struct PairDims {
  int M, f_in, Wl, Wout;
  int x_f32;   // x is f32 (the encode rows of the first pair), else compute dtype
};

// Columns [c0, c0 + rows_p) of the row-major [M, C] matrix src (f32 or the
// compute dtype) of the TM rows from m0 -> the channel-major staging tile
// st[k][row] in the compute dtype, zero past C and past M.
template <typename T>
__device__ void load_cols(T* st, const void* __restrict__ src, bool src_f32, int M, int C, int c0,
                          int rows_p, int m0) {
  for (int idx = threadIdx.x; idx < rows_p * TM; idx += THREADS) {
    const int row = idx / rows_p, k = idx - row * rows_p;
    const int m = m0 + row, c = c0 + k;
    float v = 0.f;
    if (m < M && c < C) {
      const size_t at = (size_t)m * C + c;
      v = src_f32 ? static_cast<const float*>(src)[at]
                  : Ty<T>::to_f(static_cast<const T*>(src)[at]);
    }
    st[(size_t)k * LD + row] = Ty<T>::from_f(v);
  }
}

// hs[col][row] = cast(relu(x Wcol + bcol)) of the tile at m0, col < Wl, in
// column chunks of the engines' width, x through the staging tile st.  With
// xT the cast x tile also goes out to the channel-major stream xT[k][ldT].
template <typename T>
__device__ void pair_hidden(T* hs, T* st, T* slab, const void* __restrict__ x,
                            const T* __restrict__ wc, const float* __restrict__ bc,
                            const PairDims& d, int m0, T* xT, size_t ldT) {
  typename Engine<T>::type gemm;
  for (int c0 = 0; c0 < d.Wl; c0 += MAX_OUT) {
    const int n = min(MAX_OUT, d.Wl - c0);
    gemm.zero();
    for (int k0 = 0; k0 < d.f_in; k0 += STAGE) {
      const int rows = min(STAGE, d.f_in - k0), rows_p = (rows + 15) & ~15;
      __syncthreads();
      load_cols<T>(st, x, d.x_f32 != 0, d.M, d.f_in, k0, rows_p, m0);
      __syncthreads();
      if (xT && c0 == 0) copy_tile_out(xT + (size_t)k0 * ldT, ldT, m0, st, rows_p);
      gemm.segment_ld(wc + c0, d.Wl, n, k0, st, rows, slab);
    }
    gemm.transform(n, [&](int, int col, float v) {
      return keep_positive(fmaxf(v + bc[c0 + col], 0.f), static_cast<T*>(nullptr));
    });
    gemm.store(hs + (size_t)c0 * LD, n);
  }
}

template <typename T>
size_t pair_smem_bytes(int Wl) {
  return sizeof(T) * ((size_t)(Wl + STAGE) * LD + Engine<T>::type::slab_elems(MAX_OUT)) +
         sizeof(float) * (2 * MAX_OUT + MAX_LOCAL);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
tp_pair_fwd_kernel(const void* __restrict__ x, const T* __restrict__ wc,
                   const float* __restrict__ bc, const T* __restrict__ wr, PairDims d,
                   float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* hs = reinterpret_cast<T*>(smem_raw);   // [Wl][LD] hidden activation
  T* st = hs + (size_t)d.Wl * LD;           // [STAGE][LD] x columns
  T* slab = st + (size_t)STAGE * LD;        // weight rows
  const int m0 = blockIdx.x * TM;
  pair_hidden<T>(hs, st, slab, x, wc, bc, d, m0, nullptr, 0);
  typename Engine<T>::type gemm;
  for (int c0 = 0; c0 < d.Wout; c0 += MAX_OUT) {
    const int n = min(MAX_OUT, d.Wout - c0);
    gemm.zero();
    gemm.segment_ld(wr + c0, d.Wout, n, 0, hs, d.Wl, slab);
    gemm.transform(n, [&](int row, int col, float v) {
      if (m0 + row < d.M) out[(size_t)(m0 + row) * d.Wout + c0 + col] = v;
      return v;
    });
  }
}

// Rows of the stream S [rows][Mp] of one chunk: x (Fp) | h (Wl) | g (Wout)
// | dh (Wl).
struct StreamRows {
  int x, h, g, dh, end;
};
__host__ __device__ inline StreamRows stream_rows(const PairDims& d) {
  const int Fp = enc_rows(d.f_in);
  return StreamRows{0, Fp, Fp + d.Wl, Fp + d.Wl + d.Wout, Fp + 2 * d.Wl + d.Wout};
}

// wrT = Wrow^T [Wout][Wl] and wcT = Wcol^T [Wl][Fp] (zero past f_in), compute
// dtype; the chunk's rows start at x, g and dx; Mp its rows padded to TM.
// db_part [gridDim.x][Wl]: each block's column sums of the f32 dh.
template <typename T>
__global__ void __launch_bounds__(THREADS)
tp_pair_bwd_kernel(const void* __restrict__ x, const T* __restrict__ wc,
                   const float* __restrict__ bc, const T* __restrict__ wrT,
                   const T* __restrict__ wcT, const float* __restrict__ g, PairDims d, int Mp,
                   T* __restrict__ S, float* __restrict__ dx, float* __restrict__ db_part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* hs = reinterpret_cast<T*>(smem_raw);   // [Wl][LD] h, then dh in place
  T* st = hs + (size_t)d.Wl * LD;           // [STAGE][LD] x or g columns
  T* slab = st + (size_t)STAGE * LD;        // weight rows
  float* part = reinterpret_cast<float*>(slab + Engine<T>::type::slab_elems(MAX_OUT));
  float* dbacc = part + 2 * MAX_OUT;        // [Wl] this block's bias sums
  const int tid = threadIdx.x, Fp = enc_rows(d.f_in);
  const StreamRows sr = stream_rows(d);
  const size_t ld = Mp;
  for (int c = tid; c < d.Wl; c += THREADS) dbacc[c] = 0.f;
  typename Engine<T>::type gemm;
  for (int tile = blockIdx.x; tile < Mp / TM; tile += gridDim.x) {
    const int m0 = tile * TM;
    pair_hidden<T>(hs, st, slab, x, wc, bc, d, m0, S + (size_t)sr.x * ld, ld);
    copy_tile_out(S + (size_t)sr.h * ld, ld, m0, hs, d.Wl);
    // dh = (cast(g) Wrow^T) where hpre > 0, a column chunk at a time, each
    // over the chunk of h it masks by.
    for (int c0 = 0; c0 < d.Wl; c0 += MAX_OUT) {
      const int n = min(MAX_OUT, d.Wl - c0);
      gemm.zero();
      for (int k0 = 0; k0 < d.Wout; k0 += STAGE) {
        const int rows = min(STAGE, d.Wout - k0);
        __syncthreads();
        load_cols<T>(st, g, true, d.M, d.Wout, k0, rows, m0);
        __syncthreads();
        if (c0 == 0) copy_tile_out(S + (size_t)(sr.g + k0) * ld, ld, m0, st, rows);
        gemm.segment_ld(wrT + c0, d.Wl, n, k0, st, rows, slab);
      }
      gemm.transform(n, [&](int row, int col, float v) {
        return Ty<T>::to_f(hs[(size_t)(c0 + col) * LD + row]) > 0.f ? v : 0.f;
      });
      gemm.colsum(n, part);
      gemm.store(hs + (size_t)c0 * LD, n);
      for (int c = tid; c < n; c += THREADS) dbacc[c0 + c] += part[c] + part[MAX_OUT + c];
    }
    copy_tile_out(S + (size_t)sr.dh * ld, ld, m0, hs, d.Wl);
    // dx = cast(dh) Wcol^T.
    for (int c0 = 0; c0 < Fp; c0 += MAX_OUT) {
      const int n = min(MAX_OUT, Fp - c0);
      gemm.zero();
      gemm.segment_ld(wcT + c0, Fp, n, 0, hs, d.Wl, slab);
      gemm.transform(n, [&](int row, int col, float v) {
        if (m0 + row < d.M && c0 + col < d.f_in)
          dx[(size_t)(m0 + row) * d.f_in + c0 + col] = v;
        return v;
      });
    }
    __syncthreads();
  }
  __syncthreads();
  for (int c = tid; c < d.Wl; c += THREADS) db_part[(size_t)blockIdx.x * d.Wl + c] = dbacc[c];
}

bool pair_dims_ok(const PairDims& d) {
  return d.M > 0 && d.f_in >= 1 && d.Wl >= 16 && d.Wl <= MAX_LOCAL && d.Wl % 16 == 0 &&
         d.Wout >= 16 && d.Wout % 16 == 0;
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Launches of the mma.sync pair kernels (tp_pair_fwd_kernel,
// tp_pair_bwd_kernel) by this library.
long long g_pair_mma_launches = 0;

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)e;
}

template <typename T>
int launch_fwd(const void* x, const void* wc, const float* bc, const void* wr, const PairDims& d,
               float* out, const PairB& B, cudaStream_t s) {
  constexpr bool BF16 = sizeof(T) == 2;
  if (pair_wg_route(d.f_in, d.Wl, d.Wout, BF16)) {
    PairPlan pl;
    const int Mp = ceil_div(d.M, TP_TM) * TP_TM;
    if (!pair_wg_plan<BF16>(pl, B, d.M, Mp, d.f_in, d.Wl, d.Wout, d.x_f32, false, nullptr))
      return (int)cudaErrorInvalidValue;
    int sms = 0, e = sm_count(&sms);
    if (e) return e;
    const int tiles = Mp / TP_TM;
    return launch_pair_wg<BF16, false>(pl, tiles < sms ? tiles : sms, x, nullptr, bc, out,
                                       nullptr, nullptr, s);
  }
  const size_t smem = pair_smem_bytes<T>(d.Wl);
  cudaError_t e = cudaFuncSetAttribute(tp_pair_fwd_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  tp_pair_fwd_kernel<T><<<ceil_div(d.M, TM), THREADS, smem, s>>>(
      x, static_cast<const T*>(wc), bc, static_cast<const T*>(wr), d, out);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++g_pair_mma_launches;
  return (int)e;
}

struct BwdArgs {
  const void *x, *wc, *wrT, *wcT;
  const float *bc, *g;
  void* S;
  float *dx, *db_part, *partial, *dw, *db;
  int n_blocks, MC, chunk;
};

template <typename T>
int launch_bwd(const BwdArgs& a, const PairDims& d, const PairB& B, cudaStream_t s) {
  constexpr bool BF16 = sizeof(T) == 2;
  const bool wg = pair_wg_route(d.f_in, d.Wl, d.Wout, BF16);
  const size_t smem = pair_smem_bytes<T>(d.Wl);
  cudaError_t e = cudaSuccess;
  if (!wg) {
    e = cudaFuncSetAttribute(tp_pair_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // The two weight-gradient problems and their output tiles: dWcol = x^T dh
  // at dw[0], dWrow = h^T g after it.
  const StreamRows sr = stream_rows(d);
  const int PW = d.f_in * d.Wl + d.Wl * d.Wout;
  WgradTable tab;
  const int probs[2][6] = {{0, d.f_in, sr.dh, d.Wl, 0, d.Wl},
                           {1, d.Wl, sr.g, d.Wout, d.f_in * d.Wl, d.Wout}};
  int n_tiles = 0;
  for (int p = 0; p < 2; ++p) {
    for (int k = 0; k < 6; ++k) tab.prob[p][k] = probs[p][k];
    for (int r0 = 0; r0 < probs[p][1]; r0 += BM)
      for (int c0 = 0; c0 < probs[p][3]; c0 += BN) {
        if (n_tiles == MAX_TILES) return (int)cudaErrorInvalidValue;
        tab.tile[n_tiles][0] = p;
        tab.tile[n_tiles][1] = r0;
        tab.tile[n_tiles][2] = c0;
        ++n_tiles;
      }
  }
  const size_t x_size = d.x_f32 ? 4 : sizeof(T);
  T* S = static_cast<T*>(a.S);
  int n_chunks = 0;
  for (int c0 = 0; c0 < d.M; c0 += a.chunk, ++n_chunks) {
    PairDims dc = d;
    dc.M = d.M - c0 < a.chunk ? d.M - c0 : a.chunk;
    const int Mp = ceil_div(dc.M, TM) * TM;
    const void* xc = static_cast<const char*>(a.x) + x_size * (size_t)c0 * d.f_in;
    float* db_part = a.db_part + (size_t)n_chunks * a.n_blocks * d.Wl;
    if (wg) {
      PairPlan pl;
      if (!pair_wg_plan<BF16>(pl, B, dc.M, Mp, d.f_in, d.Wl, d.Wout, d.x_f32, true, S))
        return (int)cudaErrorInvalidValue;
      const int r = launch_pair_wg<BF16, true>(pl, a.n_blocks, xc, a.g + (size_t)c0 * d.Wout, a.bc,
                                               a.dx + (size_t)c0 * d.f_in, S, db_part, s);
      if (r) return r;
    } else {
      tp_pair_bwd_kernel<T><<<a.n_blocks, THREADS, smem, s>>>(
          xc, static_cast<const T*>(a.wc), a.bc, static_cast<const T*>(a.wrT),
          static_cast<const T*>(a.wcT), a.g + (size_t)c0 * d.Wout, dc, Mp, S,
          a.dx + (size_t)c0 * d.f_in, db_part);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
      ++g_pair_mma_launches;
    }
    float* partial = a.partial + (size_t)(c0 / a.MC) * PW;
    // x, h and the cotangents are rows of the one stream S: bf16 on
    // wgrad_sm90_kernel, f32 on wgrad_tf32_kernel.
    const int a_row[2] = {sr.x, sr.h};
    e = (cudaError_t)(sizeof(T) == 2 ? launch_wgrad_sm90 : launch_wgrad_tf32)(
        S, sr.end, a_row, 2, S, sr.end, tab, n_tiles, Mp, a.MC, partial, PW, s);
    if (e != cudaSuccess) return (int)e;
  }
  const int splits = ceil_div(ceil_div(d.M, TM) * TM, a.MC);
  sum_rows_kernel<<<ceil_div(PW, 256), 256, 0, s>>>(a.partial, splits, PW, a.dw);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  sum_rows_kernel<<<ceil_div(d.Wl, 256), 256, 0, s>>>(a.db_part, n_chunks * a.n_blocks, d.Wl,
                                                      a.db);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [M, f_in] f32 (x_f32) or compute dtype, wc [f_in, Wl] and wr [Wl, Wout]
// compute dtype, bc [Wl] f32 -> out [M, Wout] f32.  Wl a multiple of 16 up
// to 512, Wout a multiple of 16.  f32 at the widths of pair_wg_route: tf32
// = {split Wcol^T [2 Wl][Kp], split Wrow^T [2 Wout][Wl]} (PairB), else
// unused (may be null).
int tp_pair_fwd(const void* x, const void* wc, const void* bc, const void* wr, void* out, int M,
                int f_in, int Wl, int Wout, int x_f32, int use_bf16, const void* const* tf32,
                void* stream) {
  const PairDims d{M, f_in, Wl, Wout, x_f32};
  if (!pair_dims_ok(d) || (!use_bf16 && !x_f32)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bc);
  float* o = static_cast<float*>(out);
  const PairB B = use_bf16 ? PairB{{wc, wr, nullptr, nullptr}}
                           : PairB{{tf32 ? tf32[0] : nullptr, tf32 ? tf32[1] : nullptr, nullptr,
                                    nullptr}};
  return use_bf16 ? launch_fwd<bf16>(x, wc, b, wr, d, o, B, s)
                  : launch_fwd<float>(x, wc, b, wr, d, o, B, s);
}

// The inputs of tp_pair_fwd, wrT = wr^T [Wout, Wl], wcT = wc^T [Wl, Fp]
// (Fp = f_in rounded up to 16, zero past f_in) and g [M, Wout] f32 -> dx
// [M, f_in], dw [f_in * Wl + Wl * Wout] (dWcol then dWrow, row-major), db
// [Wl], f32.  Scratch: S [Fp + 2 Wl + Wout][chunk] compute dtype, db_part
// [ceil(M / chunk) * n_blocks][Wl] and partial [ceil(Mp / MC)][dw's size]
// (zeroed) f32.  chunk, the rows a pass takes, is a multiple of MC, the rows
// of a partial sum, itself a multiple of 64.  f32 at the widths of
// pair_wg_route: tf32 = {split Wcol^T [2 Wl][Kp], unused, split Wrow [2
// Wl][Wout], split Wcol [2 Np][Wl]} (PairB), else unused (may be null).
int tp_pair_bwd(const void* x, const void* wc, const void* bc, const void* wrT, const void* wcT,
                const void* g, void* S, void* dx, void* db_part, int n_blocks, void* partial,
                int MC, int chunk, void* dw, void* db, int M, int f_in, int Wl, int Wout,
                int x_f32, int use_bf16, const void* const* tf32, void* stream) {
  const PairDims d{M, f_in, Wl, Wout, x_f32};
  if (!pair_dims_ok(d) || (!use_bf16 && !x_f32) || n_blocks < 1 || MC < TM || MC % TM ||
      MC % KC || chunk < MC || chunk % MC)
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{x, wc, wrT, wcT, static_cast<const float*>(bc), static_cast<const float*>(g),
                  S, static_cast<float*>(dx), static_cast<float*>(db_part),
                  static_cast<float*>(partial), static_cast<float*>(dw),
                  static_cast<float*>(db), n_blocks, MC, chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PairB B{{nullptr, nullptr, nullptr, nullptr}};
  if (use_bf16) {
    B = PairB{{wc, nullptr, wrT, wcT}};
  } else if (tf32) {
    B = PairB{{tf32[0], tf32[1], tf32[2], tf32[3]}};
  }
  return use_bf16 ? launch_bwd<bf16>(a, d, B, s) : launch_bwd<float>(a, d, B, s);
}

// Whether tp_pair_fwd and tp_pair_bwd's chain run on tp_pair_wg_kernel at
// these widths (kernels/tp_lean.py pair_sm90_route / pair_tf32_route), and
// the dynamic shared memory of its plan.
int tp_pair_wg_route(int f_in, int Wl, int Wout, int use_bf16) {
  return pair_wg_route(f_in, Wl, Wout, use_bf16 != 0) ? 1 : 0;
}
long long tp_pair_wg_smem(int Wl, int use_bf16) {
  const int st = pair_wg_stages(use_bf16 != 0, Wl);
  return st ? (long long)pair_wg_smem(use_bf16 != 0, Wl, st) : -1;
}

// Launches by this library so far: out[0] tp_pair_wg_kernel bf16, out[1]
// its f32 form, out[2] the mma.sync pair kernels.
void tp_pair_launches(long long* out) {
  out[0] = g_pair_sm90_launches;
  out[1] = g_pair_tf32_launches;
  out[2] = g_pair_mma_launches;
}

// Launches of wgrad_tf32_kernel / wgrad_sm90_kernel by this library so far
// (tp_pair_bwd's f32 / bf16 weight gradients).
long long wgrad_tf32_launches() { return g_wgrad_tf32_launches; }
long long wgrad_sm90_launches() { return g_wgrad_sm90_launches; }

}  // extern "C"
