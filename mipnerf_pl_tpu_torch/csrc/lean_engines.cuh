// Shared device code of the MLP kernels (lean_render.cu, lean_train.cu,
// tp_pair.cu).
//
// A TM-point tile of activations lives in shared memory channel-major
// ([width][TM], row stride LD) through all layers; a layer's weights stream
// from L2 through a KT-row shared slab.  Two tensor-core GEMM engines
// compute acc[point][out] += sum_k src[k][point] * Wg[k][out] with one
// warp per 32-row x 64-column output tile:
//   float32   Tf32Gemm: mma.sync m16n8k8 TF32, each operand split hi + lo
//             (3xTF32), f32 accuracy;
//   bfloat16  TcGemm: mma.sync m16n8k16 bf16 -> f32, ldmatrix.trans.
// `transform` rewrites the accumulators in place (bias, activation, ReLU
// mask), `store` writes them into a shared tile in the compute dtype,
// `colsum` reduces them over the tile's rows in a fixed order (no atomics).
// `mlp_tile` is the MLP forward of one tile, shared by the render kernel and
// the training forwards: lean (view_0's per-ray half added per ray), or the
// classic MLP of fused_mlp (mlp_tile<T, true>: per-point view features,
// nd density heads).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ipe_core.cuh"

namespace {

constexpr int TM = 64;          // sample points per block (rows of a tile)
constexpr int THREADS = 256;    // 8 warps
constexpr int MAX_OUT = 256;    // widest dense layer the tilings cover
constexpr int MAX_PARAMS = 64;  // kernel + bias pointers of all layers
constexpr int MAX_HEADS = 8;    // raw head rows: 3 rgb + up to 5 density
constexpr unsigned FULL = 0xffffffffu;
// Stride of a channel-major [width][TM] shared tile: 16-byte rows, padded
// so that the engines' fragment loads and stores spread over the banks.
constexpr int LD = TM + 8;

struct LayerPtrs {
  const void* w[MAX_PARAMS / 2];   // [in, out] row-major, compute dtype
  const float* b[MAX_PARAMS / 2];  // [out] f32
};

struct MlpDims {
  int M, N, R;             // points, samples per ray, rays (M = R * N)
  int L, min_deg;          // encode degrees: F = 6 L encode features
  int depth, depth_cond, skip, W, Wv;
  float rgb_padding, density_bias;
};

typedef __nv_bfloat16 bf16;

// Compute-dtype conversions.
template <typename T> struct Ty;
template <> struct Ty<float> {
  __device__ static float to_f(float x) { return x; }
  __device__ static float from_f(float x) { return x; }
};
template <> struct Ty<bf16> {
  __device__ static float to_f(bf16 x) { return __bfloat162float(x); }
  __device__ static bf16 from_f(float x) { return __float2bfloat16_rn(x); }
};

// The forward epilogue value of one output: act(acc + bias (+ view_0's
// per-ray half of the point's ray)).
__device__ __forceinline__ float epilogue(float x, int row, int col, const float* bias,
                                          const float* vproj, const MlpDims& d, int m0,
                                          bool relu) {
  if (bias) x += bias[col];
  if (vproj) x += vproj[(size_t)min((m0 + row) / d.N, d.R - 1) * d.Wv + col];
  return relu ? fmaxf(x, 0.f) : x;
}

// Streams the rows [k0, k0 + KT) of n_out columns of a global kernel with
// row stride ldg (from row wrow0) into a shared slab with row stride
// n_out + 8, VEC elements per access; rows at or past K are zero.  The next
// slab's loads are issued into registers before the current slab's products
// (fetch, then put after the barrier), so their latency hides behind the
// tensor-core work.
template <typename E, int KT, int VEC>
struct SlabStream {
  typedef typename std::conditional<sizeof(E) * VEC == 16, uint4, uint2>::type V;
  static constexpr int PER_THREAD = (KT * MAX_OUT / VEC + THREADS - 1) / THREADS;
  V reg[PER_THREAD];

  __device__ void fetch(const E* __restrict__ Wg, int ldg, int n_out, int wrow0, int k0, int K) {
    const int vrow = n_out / VEC;
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const int v = threadIdx.x + i * THREADS, kk = v / vrow;
      V val{};
      if (kk < KT && k0 + kk < K)
        val = *reinterpret_cast<const V*>(Wg + (size_t)(wrow0 + k0 + kk) * ldg +
                                          (v - kk * vrow) * VEC);
      reg[i] = val;
    }
  }

  __device__ void put(E* slab, int n_out) const {
    const int vrow = n_out / VEC;
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const int v = threadIdx.x + i * THREADS, kk = v / vrow;
      if (kk < KT)
        *reinterpret_cast<V*>(slab + kk * (n_out + 8) + (v - kk * vrow) * VEC) = reg[i];
    }
  }
};

// Column sums of one warp's 32 rows: `s` holds this lane's sum over its
// rows g, g + 8, g + 16, g + 24 of one column; lanes 0-3 (g = 0) end with
// the warp's sum.  Fixed shuffle order, so the result is deterministic.
__device__ __forceinline__ float sum_over_g(float s) {
  s += __shfl_xor_sync(FULL, s, 4);
  s += __shfl_xor_sync(FULL, s, 8);
  s += __shfl_xor_sync(FULL, s, 16);
  return s;
}

// ---- float32: tensor cores, 3xTF32 --------------------------------------

// x = hi + lo with hi, lo both tf32 (10 explicit mantissa bits each): the
// three products hi*hi + hi*lo + lo*hi carry x*y to ~2^-22 relative, so
// the f32 path keeps f32 accuracy on the TF32 tensor cores.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Three products per fragment pair, small terms first.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4], uint32_t bh0, uint32_t bl0,
                                           uint32_t bh1, uint32_t bl1) {
  mma_tf32(c, alo, bh0, bh1);
  mma_tf32(c, ahi, bl0, bl1);
  mma_tf32(c, ahi, bh0, bh1);
}

struct Tf32Gemm {
  typedef float T;
  static constexpr int KT = 8;     // weight rows per slab (one k8 step)
  // Warp w owns rows 32*(w%2) + [0, 32) (two m16 tiles) and the n8 tiles
  // q = w/2 + 4*j, j < 8.  Fragments of mma.m16n8k8 (lane = 4*g + t):
  // A rows g, g+8 x cols t, t+4; B rows t, t+4 x col g; C rows g, g+8 x
  // cols 2t, 2t+1.
  float acc[2][8][4];

  __host__ __device__ static size_t slab_elems(int wmax) { return (size_t)KT * (wmax + 8); }

  __device__ void zero() {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
  }

  // acc += src[0:K]^T-rows x Wg[wrow0 : wrow0 + K, :], src a channel-major
  // shared tile, Wg a global [*, n_out] kernel (n_out % 8 == 0); src rows
  // [K, roundup(K, 8)) must be finite (they meet zero weight rows).
  __device__ void segment(const float* __restrict__ Wg, int n_out, int wrow0, const float* src,
                          int K, float* slab) {
    segment_ld(Wg, n_out, n_out, wrow0, src, K, slab);
  }

  // The same on n_out columns of a wider kernel, whose rows are ldg apart
  // (ldg % 4 == 0 and Wg 16-byte aligned).
  __device__ void segment_ld(const float* __restrict__ Wg, int ldg, int n_out, int wrow0,
                             const float* src, int K, float* slab) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp & 1, wn = warp >> 1, g = lane >> 2, t = lane & 3;
    const int ldw = n_out + 8, tiles = n_out / 8;
    SlabStream<float, KT, 4> stream;
    stream.fetch(Wg, ldg, n_out, wrow0, 0, K);
    for (int k0 = 0; k0 < K; k0 += KT) {
      stream.put(slab, n_out);
      __syncthreads();
      if (k0 + KT < K) stream.fetch(Wg, ldg, n_out, wrow0, k0 + KT, K);
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float* s0 = src + (size_t)(k0 + t) * LD + 32 * wm + 16 * mi + g;
        split_tf32(s0[0], ahi[mi][0], alo[mi][0]);
        split_tf32(s0[8], ahi[mi][1], alo[mi][1]);
        split_tf32(s0[4 * LD], ahi[mi][2], alo[mi][2]);
        split_tf32(s0[4 * LD + 8], ahi[mi][3], alo[mi][3]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int q = wn + 4 * j;
        if (q < tiles) {
          const float* b = slab + t * ldw + 8 * q + g;
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(b[0], bh0, bl0);
          split_tf32(b[4 * ldw], bh1, bl1);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            mma_3xtf32(acc[mi][j], ahi[mi], alo[mi], bh0, bl0, bh1, bl1);
        }
      }
      __syncthreads();
    }
  }

  // acc = f(row, col, acc) for every output column < n_out.
  template <class F>
  __device__ void transform(int n_out, F&& f) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = warp & 1, wn = warp >> 1, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int q = wn + 4 * j;
      if (8 * q >= n_out) continue;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mi][j][e] = f(32 * wm + 16 * mi + g + 8 * (e >> 1), 8 * q + 2 * t + (e & 1),
                            acc[mi][j][e]);
    }
  }

  // dst[col][row] = acc, in place over the layer's input.
  __device__ void store(float* dst, int n_out) {
    __syncthreads();
    transform(n_out, [&](int row, int col, float x) {
      dst[(size_t)col * LD + row] = x;
      return x;
    });
    __syncthreads();
  }

  // part[wm * MAX_OUT + col] = sum of acc over warp-row half wm's 32 rows.
  __device__ void colsum(int n_out, float* part) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = warp & 1, wn = warp >> 1, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int q = wn + 4 * j;
      if (8 * q >= n_out) continue;   // warp-uniform
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float s = sum_over_g(acc[0][j][c] + acc[0][j][c + 2] + acc[1][j][c] +
                                   acc[1][j][c + 2]);
        if (g == 0) part[wm * MAX_OUT + 8 * q + 2 * t + c] = s;
      }
    }
  }
};

// ---- bfloat16: tensor-core GEMM -------------------------------------------

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct TcGemm {
  typedef bf16 T;
  static constexpr int KT = 32;    // weight rows per slab (two k16 steps)
  // Warp w owns rows 32*(w%2) + [0, 32) (two m16 tiles) and the column
  // pairs p = w/2 + 4*j (16 columns = two n8 tiles each), j < 4.  The
  // fragment layout of mma.m16n8k16: lane = 4*g + t holds rows g and g + 8,
  // columns 2t and 2t + 1 of each accumulator tile.
  float acc[2][4][2][4];

  // Slab rows are padded by 8 elements so ldmatrix rows hit distinct banks.
  __host__ __device__ static size_t slab_elems(int wmax) { return (size_t)KT * (wmax + 8); }

  __device__ void zero() {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][j][h][e] = 0.f;
  }

  // As Tf32Gemm::segment; n_out % 16 == 0, and src rows [K, roundup(K, 16))
  // must be finite (they meet zero weight rows).
  __device__ void segment(const bf16* __restrict__ Wg, int n_out, int wrow0, const bf16* src,
                          int K, bf16* slab) {
    segment_ld(Wg, n_out, n_out, wrow0, src, K, slab);
  }

  // As Tf32Gemm::segment_ld; ldg % 8 == 0.
  __device__ void segment_ld(const bf16* __restrict__ Wg, int ldg, int n_out, int wrow0,
                             const bf16* src, int K, bf16* slab) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp & 1, wn = warp >> 1;
    const int ldw = n_out + 8, pairs = n_out / 16;
    const int i8 = lane >> 3, r8 = lane & 7;   // ldmatrix: matrix, row
    SlabStream<bf16, KT, 8> stream;
    stream.fetch(Wg, ldg, n_out, wrow0, 0, K);
    for (int k0 = 0; k0 < K; k0 += KT) {
      const int ktp = (min(KT, K - k0) + 15) & ~15;
      stream.put(slab, n_out);
      __syncthreads();
      if (k0 + KT < K) stream.fetch(Wg, ldg, n_out, wrow0, k0 + KT, K);
      for (int kk = 0; kk < ktp; kk += 16) {
        // A = src^T rows: matrices (k 0-7 | 8-15) x (m 0-7 | 8-15).
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldmatrix_x4_trans(a[mi], src + (size_t)(k0 + kk + r8 + 8 * (i8 >> 1)) * LD +
                                       32 * wm + 16 * mi + 8 * (i8 & 1));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = wn + 4 * j;
          if (p < pairs) {
            // B = slab rows: matrices (k 0-7 | 8-15) x (n 0-7 | 8-15).
            uint32_t b[4];
            ldmatrix_x4_trans(b, slab + (kk + r8 + 8 * (i8 & 1)) * ldw + 16 * p + 8 * (i8 >> 1));
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              mma_bf16(acc[mi][j][0], a[mi], b[0], b[1]);
              mma_bf16(acc[mi][j][1], a[mi], b[2], b[3]);
            }
          }
        }
      }
      __syncthreads();
    }
  }

  template <class F>
  __device__ void transform(int n_out, F&& f) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = warp & 1, wn = warp >> 1, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = wn + 4 * j;
      if (16 * p >= n_out) continue;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[mi][j][h][e] = f(32 * wm + 16 * mi + g + 8 * (e >> 1),
                                 16 * p + 8 * h + 2 * t + (e & 1), acc[mi][j][h][e]);
    }
  }

  __device__ void store(bf16* dst, int n_out) {
    __syncthreads();
    transform(n_out, [&](int row, int col, float x) {
      dst[(size_t)col * LD + row] = __float2bfloat16_rn(x);
      return x;
    });
    __syncthreads();
  }

  __device__ void colsum(int n_out, float* part) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = warp & 1, wn = warp >> 1, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = wn + 4 * j;
      if (16 * p >= n_out) continue;   // warp-uniform
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float s = sum_over_g(acc[0][j][h][c] + acc[0][j][h][c + 2] + acc[1][j][h][c] +
                                     acc[1][j][h][c + 2]);
          if (g == 0) part[wm * MAX_OUT + 16 * p + 8 * h + 2 * t + c] = s;
        }
    }
  }
};

template <typename T> struct Engine;
template <> struct Engine<float> { typedef Tf32Gemm type; };
template <> struct Engine<bf16> { typedef TcGemm type; };

// One head column: out = bias + sum_k [h; x][k][row] * w[k * n_out + col].
template <typename T>
__device__ float head_dot(const T* h, int KH, const T* x, int KX,
                          const T* __restrict__ w, const float* bias,
                          int n_out, int col, int row) {
  float s = 0.f;
  for (int k = 0; k < KH; ++k)
    s = fmaf(Ty<T>::to_f(h[k * LD + row]), Ty<T>::to_f(w[k * n_out + col]), s);
  for (int k = 0; k < KX; ++k)
    s = fmaf(Ty<T>::to_f(x[k * LD + row]), Ty<T>::to_f(w[(KH + k) * n_out + col]), s);
  return s + bias[col];
}

// Rows of the encode tile: F rounded up to the tensor cores' k16 (the
// extra rows hold zeros).
__host__ __device__ inline int enc_rows(int F) { return (F + 15) & ~15; }

// The IPE of the TM points from m0, decoded from the channel-major moments
// x [6][ldx] (means xyz | diagonal covs xyz): the sine half into rows 3k +
// dim, the cosine half (sin(y + pi/2) in f32) into rows 3L + 3k + dim, k <
// L, zero past M; put(row, point, value) stores a value.  A unit is a
// (point, dim) and one of PARTS runs of its degrees, each run with its own
// reduction (ipe_moments_pair's values do not depend on the split, so every
// tile gets ipe_moments' rows bit for bit); the NT threads from tid take
// the 3 PARTS TM units in turn, a warp's lanes on consecutive points of one
// (dim, run), so that their loads are coalesced and their stores of a
// feature row side by side.  PARTS is chosen so that the units divide
// evenly over the threads.
template <int PARTS, int NT, class Put>
__device__ __forceinline__ void decode_moments(const float* __restrict__ x, size_t ldx, int M,
                                               int L, int min_deg, int m0, int tid, Put put) {
  static_assert(3 * PARTS * TM % NT == 0, "units must divide evenly over the threads");
#pragma unroll 1
  for (int u = tid; u < 3 * PARTS * TM; u += NT) {
    const int p = u % TM, r = u / TM, dim = r % 3, part = r / 3, m = m0 + p;
    const int k0 = part * L / PARTS, k1 = (part + 1) * L / PARTS;
    if (m < M) {
      const float mean = x[(size_t)dim * ldx + m];
      const IpeMoments e{ipe_turns(mean, min_deg + k0), mean, x[(size_t)(3 + dim) * ldx + m]};
#pragma unroll 2
      for (int k = k0; k < k1; ++k) {
        float vs, vc;
        ipe_moments_pair(e, min_deg + k, vs, vc);
        put(3 * k + dim, p, vs);
        put(3 * (L + k) + dim, p, vc);
      }
    } else {
      for (int k = k0; k < k1; ++k) {
        put(3 * k + dim, p, 0.f);
        put(3 * (L + k) + dim, p, 0.f);
      }
    }
  }
}

// load_encode_tile's moments form: decode_moments, a quarter of the degrees
// a unit, three units a thread, then zeros in rows [F, Fp).  Out of line:
// inlined, it cost the bf16 lean_mlp_kernel 4 / 16 more bytes of spill
// stores / loads in its layers.
template <typename T>
__device__ __noinline__ void decode_encode_tile(T* xs, const float* __restrict__ x, size_t ldx,
                                                int M, int F, int Fp, int L, int min_deg,
                                                int m0) {
  decode_moments<4, THREADS>(x, ldx, M, L, min_deg, m0, threadIdx.x,
                             [&](int f, int row, float v) {
                               xs[(size_t)f * LD + row] = Ty<T>::from_f(v);
                             });
  for (int idx = threadIdx.x; idx < (Fp - F) * TM; idx += THREADS)
    xs[(size_t)(F + idx / TM) * LD + idx % TM] = Ty<T>::from_f(0.f);
}

// The encode tile [Fp][LD] of the TM points from m0, in the compute dtype,
// zero past F and past M, from either input form, fixed at compile time so
// the rows form compiles to its plain copy loop: MOMENTS false reads f32
// encode rows x [M, F] (coalesced along the features); MOMENTS true
// decodes the moments x [6][ldx] (F = 6L; decode_encode_tile).  The caller
// syncs.
template <typename T, bool MOMENTS>
__device__ void load_encode_tile(T* xs, const float* __restrict__ x, size_t ldx, int M, int F,
                                 int Fp, int L, int min_deg, int m0) {
  if constexpr (MOMENTS) {
    decode_encode_tile(xs, x, ldx, M, F, Fp, L, min_deg, m0);
  } else {
    for (int idx = threadIdx.x; idx < Fp * TM; idx += THREADS) {
      const int row = idx / Fp, f = idx - row * Fp, m = m0 + row;
      float v = 0.f;
      if (m < M && f < F) v = x[(size_t)m * F + f];
      xs[(size_t)f * LD + row] = Ty<T>::from_f(v);
    }
  }
}

// Shared memory of one mlp_tile block: encode tile (xrows rows), activation
// tile, weight slab, nh raw head rows.
template <typename T>
size_t mlp_smem_bytes(int xrows, int wmax, int nh = 4) {
  return sizeof(T) * ((size_t)(xrows + wmax) * LD + Engine<T>::type::slab_elems(wmax)) +
         sizeof(float) * nh * TM;
}

// dst[r * ld + m0 + c] = src[r * LD + c] for r < rows, c < TM: one shared
// channel-major tile out to a global channel-major [rows][ld] stream, 16
// bytes per access.
template <typename T>
__device__ void copy_tile_out(T* __restrict__ dst, size_t ld, int m0, const T* src, int rows) {
  constexpr int VEC = 16 / sizeof(T), PER_ROW = TM / VEC;
  for (int v = threadIdx.x; v < rows * PER_ROW; v += THREADS) {
    const int r = v / PER_ROW, c = (v - r * PER_ROW) * VEC;
    *reinterpret_cast<uint4*>(dst + (size_t)r * ld + m0 + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * LD + c);
  }
}

template <class Gemm, typename T>
__device__ void store_layer(Gemm& gemm, T* dst, const float* bias, const float* vproj,
                            const MlpDims& d, int m0, int n_out, bool relu) {
  gemm.transform(n_out, [&](int row, int col, float x) {
    return epilogue(x, row, col, bias, vproj, d, m0, relu);
  });
  gemm.store(dst, n_out);
}

// The classic MLP's per-point view input (mlp_tile<T, true>): view [M, Fv]
// f32, read into the encode tile as Fvp rows (zero past Fv) once the trunk
// is done with the encode; nd density heads.
struct ClassicView {
  const float* view;
  int Fv, Fvp, nd;
};

// The MLP forward of the tile at m0: xs holds the encode tile (F features,
// rows [F, Fp) zero), hs / slab / heads are scratch.  On return
// heads[c * TM + row] holds the raw rgb (c < 3) and density (c >= 3) heads.
// With `saved` != nullptr every layer's output also goes to the global
// channel-major stream saved[Fp + ...][ld_saved]: hs[0..depth-1] |
// bottleneck | ys[0..depth_cond-1] (rows [0, Fp) are the caller's), and
// with CL the view tile after them.  CL (the classic MLP): view_0 reads
// concat(bottleneck, view) per point with its bias (lean: the bottleneck,
// plus vproj, view_0's per-ray half with the bias); cv.nd density heads;
// xs is overwritten by the view tile.  NV (CL with depth_cond = 0, no view
// layer): the rgb head itself reads concat(bottleneck, view).
template <typename T, bool CL = false, bool NV = false>
__device__ void mlp_tile(T* xs, int F, T* hs, T* slab, float* heads, const LayerPtrs& p,
                         const MlpDims& d, const float* vproj, int m0, T* saved, size_t ld_saved,
                         int Fp, const ClassicView& cv = ClassicView{}) {
  typedef typename Engine<T>::type Gemm;
  const int tid = threadIdx.x;
  Gemm gemm;
  size_t srow = Fp;
  auto save = [&](int rows) {
    if (saved) copy_tile_out(saved + srow * ld_saved, ld_saved, m0, hs, rows);
    srow += rows;
  };
  // Trunk: layer i reads [h, x] when layer i-1 was a skip layer.
  for (int i = 0; i < d.depth; ++i) {
    const T* w = static_cast<const T*>(p.w[i]);
    gemm.zero();
    if (i == 0) {
      gemm.segment(w, d.W, 0, xs, F, slab);
    } else {
      gemm.segment(w, d.W, 0, hs, d.W, slab);
      if ((i - 1) % d.skip == 0 && i - 1 > 0) gemm.segment(w, d.W, d.W, xs, F, slab);
    }
    store_layer(gemm, hs, p.b[i], nullptr, d, m0, d.W, true);
    save(d.W);
  }
  const bool cat_x = (d.depth - 1) % d.skip == 0 && d.depth - 1 > 0;
  const int KX = cat_x ? F : 0;

  // Density head (raw) before the bottleneck overwrites the trunk output.
  const int i_den = d.depth, i_bot = d.depth + 1, i_view = d.depth + 2;
  if constexpr (CL) {
    for (int idx = tid; idx < cv.nd * TM; idx += THREADS) {
      const int c = idx / TM, row = idx - c * TM;
      heads[(3 + c) * TM + row] = head_dot<T>(hs, d.W, xs, KX, static_cast<const T*>(p.w[i_den]),
                                              p.b[i_den], cv.nd, c, row);
    }
  } else if (tid < TM) {
    heads[3 * TM + tid] = head_dot<T>(hs, d.W, xs, KX, static_cast<const T*>(p.w[i_den]),
                                      p.b[i_den], 1, 0, tid);
  }
  // Bottleneck: no activation.
  {
    const T* w = static_cast<const T*>(p.w[i_bot]);
    gemm.zero();
    gemm.segment(w, d.W, 0, hs, d.W, slab);
    if (cat_x) gemm.segment(w, d.W, d.W, xs, F, slab);
    store_layer(gemm, hs, p.b[i_bot], nullptr, d, m0, d.W, false);
    save(d.W);
  }
  // view_0: per-point half from the bottleneck + the ray's per-ray half
  // (bias included there), or (CL) + the point's view rows and the bias;
  // then the remaining view layers.
  if constexpr (CL) {
    load_encode_tile<T, false>(xs, cv.view, 0, d.M, cv.Fv, cv.Fvp, 0, 0, m0);
    __syncthreads();
  }
  if constexpr (!NV) {
    gemm.zero();
    gemm.segment(static_cast<const T*>(p.w[i_view]), d.Wv, 0, hs, d.W, slab);
    if constexpr (CL) {
      gemm.segment(static_cast<const T*>(p.w[i_view]), d.Wv, d.W, xs, cv.Fv, slab);
      store_layer(gemm, hs, p.b[i_view], nullptr, d, m0, d.Wv, true);
    } else {
      store_layer(gemm, hs, nullptr, vproj, d, m0, d.Wv, true);
    }
    save(d.Wv);
    for (int j = 1; j < d.depth_cond; ++j) {
      gemm.zero();
      gemm.segment(static_cast<const T*>(p.w[i_view + j]), d.Wv, 0, hs, d.Wv, slab);
      store_layer(gemm, hs, p.b[i_view + j], nullptr, d, m0, d.Wv, true);
      save(d.Wv);
    }
  }
  if constexpr (CL) {
    if (saved) copy_tile_out(saved + srow * ld_saved, ld_saved, m0, xs, cv.Fvp);
  }
  // rgb head, one (row, channel) per thread: on the last view layer's
  // output, or (NV) on concat(bottleneck, view).
  const int i_rgb = i_view + d.depth_cond;
  if (tid < 3 * TM) {
    const int c = tid / TM, row = tid - c * TM;
    heads[c * TM + row] = head_dot<T>(hs, NV ? d.W : d.Wv, xs, NV ? cv.Fv : 0,
                                      static_cast<const T*>(p.w[i_rgb]), p.b[i_rgb], 3, c, row);
  }
  __syncthreads();
}

// Head activations of the tile into out [M, 4] f32: sigmoid rgb widened by
// rgb_padding; softplus(raw + density_bias).  With act = false the raw
// heads go out as they are.
__device__ void write_activated(const float* heads, const MlpDims& d, int m0,
                                float* __restrict__ out, bool act = true) {
  const int tid = threadIdx.x;
  if (tid < TM && m0 + tid < d.M) {
    float4 o;
    float rgb[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float s = 1.f / (1.f + expf(-heads[c * TM + tid]));
      rgb[c] = act ? s * (1.f + 2.f * d.rgb_padding) - d.rgb_padding : heads[c * TM + tid];
    }
    const float z = heads[3 * TM + tid] + d.density_bias;
    o.x = rgb[0]; o.y = rgb[1]; o.z = rgb[2];
    o.w = act ? fmaxf(z, 0.f) + log1pf(expf(-fabsf(z))) : heads[3 * TM + tid];
    reinterpret_cast<float4*>(out)[m0 + tid] = o;
  }
}

}  // namespace
