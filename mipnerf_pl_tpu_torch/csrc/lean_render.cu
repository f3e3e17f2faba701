// Fused lean-render level kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU megakernel mipnerf_pl_tpu/kernels/mlp.py
// _fwd_kernel_lean_render (the pl.pallas_call in _run_fwd_lean_render,
// save=False, encode=(min_deg, max_deg)): IPE decode from the [6, M]
// moments -> lean Mip-NeRF MLP -> head activations -> per-ray composite.
// It is split into three kernels, each launched by its own entry below:
//
//   lean_view_proj  view_0's per-ray half, once per ray:
//                   vproj[r] = view[r] @ k0[W:] + b0            [R, Wv] f32
//   lean_mlp        per tile of TM points: decode the 6L-wide IPE into
//                   shared memory, run the trunk (skip concat after layer
//                   `skip`), density / bottleneck heads, view layers (view_0
//                   adds vproj of the point's ray), rgb head, activations;
//                   writes rgb|sigma                            [M, 4] f32
//   lean_composite  one warp per ray: alpha, exclusive transmittance scan
//                   over the N samples, weights, comp rgb, acc, unclamped
//                   distance, white background   -> [R, 8] and [R, N] f32
//
// What bounds it on the card: the MLP is ~1.21 MFLOP per sample point
// (~1.27 TFLOP per 8192-ray level-chunk at the lego shape), so lean_mlp is
// compute bound; everything around it moves ~40 B per point.  The TPU kernel
// kept all weights (2.4 MB f32) resident in 96 MB of VMEM; an SM has 227 KB
// of shared memory, so here the activations of one TM-point tile stay
// resident in shared memory (channel-major, [width][TM]) across all ten
// layers and the weights stream through a KT-row shared-memory slab from
// L2 (every block reads the same weights, which stay L2-resident).  Every
// thread holds its share of a layer's output in registers, so the layer
// completes before it overwrites its input in place.  Both GEMM engines
// run on the tensor cores (mma.sync), each warp a 32-row x 64-column
// output tile:
//   float32   Tf32Gemm: m16n8k8 TF32 with each operand split hi + lo
//             (3xTF32), f32 accuracy; fragments loaded from shared memory;
//   bfloat16  TcGemm: m16n8k16 bf16 -> f32, fragments by ldmatrix.trans.
// wgmma, TMA and a pipelined weight stream are later work.
//
// Numerics: exact libm expf/sinf (the IPE's sine arguments reach 2^15|x|;
// the __sinf/__expf intrinsics and --use_fast_math are wrong at that range).
// Activations are rounded to the compute dtype after every layer, products
// accumulate in f32, biases arrive pre-rounded through the compute dtype,
// as in the TPU kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TM = 64;          // sample points per block (rows of a tile)
constexpr int THREADS = 256;    // 8 warps
constexpr int MAX_OUT = 256;    // widest dense layer the tilings cover
constexpr int MAX_PARAMS = 64;  // kernel + bias pointers of all layers
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

// The epilogue value of one output: act(acc + bias (+ view_0's per-ray
// half of the point's ray)).
__device__ __forceinline__ float epilogue(float x, int row, int col, const float* bias,
                                          const float* vproj, const MlpDims& d, int m0,
                                          bool relu) {
  if (bias) x += bias[col];
  if (vproj) x += vproj[(size_t)min((m0 + row) / d.N, d.R - 1) * d.Wv + col];
  return relu ? fmaxf(x, 0.f) : x;
}

// Streams the rows [k0, k0 + KT) of a global [*, n_out] kernel (from row
// wrow0) into a shared slab with row stride n_out + 8, VEC elements per
// access; rows at or past K are zero.  The next slab's loads are issued
// into registers before the current slab's products (fetch, then put after
// the barrier), so their latency hides behind the tensor-core work.
template <typename E, int KT, int VEC>
struct SlabStream {
  typedef typename std::conditional<sizeof(E) * VEC == 16, uint4, uint2>::type V;
  static constexpr int PER_THREAD = (KT * MAX_OUT / VEC + THREADS - 1) / THREADS;
  V reg[PER_THREAD];

  __device__ void fetch(const E* __restrict__ Wg, int n_out, int wrow0, int k0, int K) {
    const int vrow = n_out / VEC;
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const int v = threadIdx.x + i * THREADS, kk = v / vrow;
      V val{};
      if (kk < KT && k0 + kk < K)
        val = *reinterpret_cast<const V*>(Wg + (size_t)(wrow0 + k0 + kk) * n_out +
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

struct Tf32Gemm {
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
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp & 1, wn = warp >> 1, g = lane >> 2, t = lane & 3;
    const int ldw = n_out + 8, tiles = n_out / 8;
    SlabStream<float, KT, 4> stream;
    stream.fetch(Wg, n_out, wrow0, 0, K);
    for (int k0 = 0; k0 < K; k0 += KT) {
      stream.put(slab, n_out);
      __syncthreads();
      if (k0 + KT < K) stream.fetch(Wg, n_out, wrow0, k0 + KT, K);
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
          for (int mi = 0; mi < 2; ++mi) {   // small terms first
            mma_tf32(acc[mi][j], alo[mi], bh0, bh1);
            mma_tf32(acc[mi][j], ahi[mi], bl0, bl1);
            mma_tf32(acc[mi][j], ahi[mi], bh0, bh1);
          }
        }
      }
      __syncthreads();
    }
  }

  // dst[col][row] = epilogue(acc), in place over the layer's input.
  __device__ void store(float* dst, const float* bias, const float* vproj, const MlpDims& d,
                        int m0, int n_out, bool relu) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp & 1, wn = warp >> 1, g = lane >> 2, t = lane & 3;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int q = wn + 4 * j;
      if (8 * q >= n_out) continue;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 32 * wm + 16 * mi + g + 8 * (e >> 1);
          const int col = 8 * q + 2 * t + (e & 1);
          dst[(size_t)col * LD + row] =
              epilogue(acc[mi][j][e], row, col, bias, vproj, d, m0, relu);
        }
    }
    __syncthreads();
  }
};

// ---- bfloat16: tensor-core GEMM -------------------------------------------

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp & 1, wn = warp >> 1;
    const int ldw = n_out + 8, pairs = n_out / 16;
    const int i8 = lane >> 3, r8 = lane & 7;   // ldmatrix: matrix, row
    SlabStream<bf16, KT, 8> stream;
    stream.fetch(Wg, n_out, wrow0, 0, K);
    for (int k0 = 0; k0 < K; k0 += KT) {
      const int ktp = (min(KT, K - k0) + 15) & ~15;
      stream.put(slab, n_out);
      __syncthreads();
      if (k0 + KT < K) stream.fetch(Wg, n_out, wrow0, k0 + KT, K);
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

  __device__ void store(bf16* dst, const float* bias, const float* vproj, const MlpDims& d,
                        int m0, int n_out, bool relu) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp & 1, wn = warp >> 1, g = lane >> 2, t = lane & 3;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = wn + 4 * j;
      if (16 * p >= n_out) continue;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = 32 * wm + 16 * mi + g + 8 * (e >> 1);
            const int col = 16 * p + 8 * h + 2 * t + (e & 1);
            dst[(size_t)col * LD + row] = __float2bfloat16_rn(
                epilogue(acc[mi][j][h][e], row, col, bias, vproj, d, m0, relu));
          }
    }
    __syncthreads();
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
__host__ __device__ inline int enc_rows(int L) { return (6 * L + 15) & ~15; }

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
lean_mlp_kernel(const float* __restrict__ moments, const float* __restrict__ vproj,
                LayerPtrs p, MlpDims d, float* __restrict__ out) {
  typedef typename Engine<T>::type Gemm;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int F = 6 * d.L, Fp = enc_rows(d.L);
  const int wmax = max(d.W, d.Wv);
  T* xs = reinterpret_cast<T*>(smem_raw);          // [Fp][LD] encode tile
  T* hs = xs + (size_t)Fp * LD;                     // [wmax][LD] activations
  T* slab = hs + (size_t)wmax * LD;                 // weight rows
  float* heads = reinterpret_cast<float*>(slab + Gemm::slab_elems(wmax));  // [4][TM]

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * TM;

  // IPE decode: feature f = half * 3L + k * 3 + dim (sin half, then the cos
  // half as sin(y + pi/2)); scale 2^(min_deg + k) is exact in f32.
  for (int idx = tid; idx < Fp * TM; idx += THREADS) {
    const int f = idx / TM, row = idx - f * TM, m = m0 + row;
    float v = 0.f;
    if (m < d.M && f < F) {
      const int cos_half = f >= 3 * d.L;
      const int q = f - cos_half * 3 * d.L;
      const int k = q / 3, dim = q - 3 * k;
      const float scale = ldexpf(1.f, d.min_deg + k);
      const float y = moments[(size_t)dim * d.M + m] * scale;
      const float var = moments[(size_t)(3 + dim) * d.M + m] * (scale * scale);
      const float phase = cos_half ? 1.57079637050628662109375f : 0.f;
      v = expf(-0.5f * var) * sinf(y + phase);
    }
    xs[(size_t)f * LD + row] = Ty<T>::from_f(v);
  }
  __syncthreads();

  Gemm gemm;
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
    gemm.store(hs, p.b[i], nullptr, d, m0, d.W, true);
  }
  const bool cat_x = (d.depth - 1) % d.skip == 0 && d.depth - 1 > 0;
  const int KX = cat_x ? F : 0;

  // Density head (raw) before the bottleneck overwrites the trunk output.
  const int i_den = d.depth, i_bot = d.depth + 1, i_view = d.depth + 2;
  if (tid < TM)
    heads[3 * TM + tid] = head_dot<T>(hs, d.W, xs, KX, static_cast<const T*>(p.w[i_den]),
                                      p.b[i_den], 1, 0, tid);
  // Bottleneck: no activation.
  {
    const T* w = static_cast<const T*>(p.w[i_bot]);
    gemm.zero();
    gemm.segment(w, d.W, 0, hs, d.W, slab);
    if (cat_x) gemm.segment(w, d.W, d.W, xs, F, slab);
    gemm.store(hs, p.b[i_bot], nullptr, d, m0, d.W, false);
  }
  // view_0: per-point half from the bottleneck + the ray's per-ray half
  // (bias included there); then the remaining view layers.
  gemm.zero();
  gemm.segment(static_cast<const T*>(p.w[i_view]), d.Wv, 0, hs, d.W, slab);
  gemm.store(hs, nullptr, vproj, d, m0, d.Wv, true);
  for (int j = 1; j < d.depth_cond; ++j) {
    gemm.zero();
    gemm.segment(static_cast<const T*>(p.w[i_view + j]), d.Wv, 0, hs, d.Wv, slab);
    gemm.store(hs, p.b[i_view + j], nullptr, d, m0, d.Wv, true);
  }
  // rgb head, one (row, channel) per thread.
  const int i_rgb = i_view + d.depth_cond;
  if (tid < 3 * TM) {
    const int c = tid / TM, row = tid - c * TM;
    heads[c * TM + row] = head_dot<T>(hs, d.Wv, xs, 0, static_cast<const T*>(p.w[i_rgb]),
                                      p.b[i_rgb], 3, c, row);
  }
  __syncthreads();

  // Activations: sigmoid rgb widened by rgb_padding; softplus(raw + bias).
  if (tid < TM && m0 + tid < d.M) {
    const int m = m0 + tid;
    float4 o;
    float rgb[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float s = 1.f / (1.f + expf(-heads[c * TM + tid]));
      rgb[c] = s * (1.f + 2.f * d.rgb_padding) - d.rgb_padding;
    }
    const float z = heads[3 * TM + tid] + d.density_bias;
    o.x = rgb[0]; o.y = rgb[1]; o.z = rgb[2];
    o.w = fmaxf(z, 0.f) + log1pf(expf(-fabsf(z)));
    reinterpret_cast<float4*>(out)[m] = o;
  }
}

template <typename T>
__global__ void lean_view_proj_kernel(const float* __restrict__ view, const T* __restrict__ k0,
                                      const float* __restrict__ b0, float* __restrict__ out,
                                      int R, int Fv, int W, int Wv) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= R * Wv) return;
  const int r = idx / Wv, j = idx - r * Wv;
  float s = 0.f;
  for (int v = 0; v < Fv; ++v) {
    const float x = Ty<T>::to_f(Ty<T>::from_f(view[(size_t)r * Fv + v]));
    s = fmaf(x, Ty<T>::to_f(k0[(size_t)(W + v) * Wv + j]), s);
  }
  out[idx] = s + b0[j];
}

constexpr int RAYS_PER_BLOCK = 8;

__global__ void __launch_bounds__(32 * RAYS_PER_BLOCK)
lean_composite_kernel(const float* __restrict__ rgbsig, const float* __restrict__ delta,
                      const float* __restrict__ mids, float* __restrict__ perray,
                      float* __restrict__ wout, int R, int N, int white_bkgd) {
  const int ray = blockIdx.x * RAYS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (ray >= R) return;  // uniform per warp
  const float4* rs = reinterpret_cast<const float4*>(rgbsig) + (size_t)ray * N;
  const size_t base_rn = (size_t)ray * N;
  float carry = 0.f, cr = 0.f, cg = 0.f, cb = 0.f, acc = 0.f, dist = 0.f;
  for (int base = 0; base < N; base += 32) {
    const int n = base + lane;
    const bool valid = n < N;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    float dd = 0.f, md = 0.f;
    if (valid) {
      v = rs[n];
      dd = v.w * delta[base_rn + n];
      md = mids[base_rn + n];
    }
    // Inclusive warp scan of sigma * delta; the exclusive sum is the
    // neighbour's inclusive sum.
    float incl = dd;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += t;
    }
    float excl = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) excl = 0.f;
    const float w = valid ? (1.f - expf(-dd)) * expf(-(carry + excl)) : 0.f;
    if (valid) wout[base_rn + n] = w;
    cr = fmaf(w, v.x, cr); cg = fmaf(w, v.y, cg); cb = fmaf(w, v.z, cb);
    acc += w;
    dist = fmaf(w, md, dist);
    carry += __shfl_sync(FULL, incl, 31);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    cr += __shfl_xor_sync(FULL, cr, o);
    cg += __shfl_xor_sync(FULL, cg, o);
    cb += __shfl_xor_sync(FULL, cb, o);
    acc += __shfl_xor_sync(FULL, acc, o);
    dist += __shfl_xor_sync(FULL, dist, o);
  }
  if (lane == 0) {
    const float bg = white_bkgd ? 1.f - acc : 0.f;
    float* o = perray + (size_t)ray * 8;
    o[0] = cr + bg; o[1] = cg + bg; o[2] = cb + bg;
    o[3] = acc; o[4] = dist; o[5] = 0.f; o[6] = 0.f; o[7] = 0.f;
  }
}

template <typename T>
size_t mlp_smem_bytes(const MlpDims& d) {
  const int wmax = d.W > d.Wv ? d.W : d.Wv;
  return sizeof(T) * ((size_t)(enc_rows(d.L) + wmax) * LD +
                      Engine<T>::type::slab_elems(wmax)) +
         sizeof(float) * 4 * TM;
}

template <typename T>
int launch_mlp(const float* moments, const float* vproj, const LayerPtrs& p,
               const MlpDims& d, float* out, cudaStream_t stream) {
  const size_t smem = mlp_smem_bytes<T>(d);
  cudaError_t e = cudaFuncSetAttribute(lean_mlp_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (d.M + TM - 1) / TM;
  lean_mlp_kernel<T><<<blocks, THREADS, smem, stream>>>(moments, vproj, p, d, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// view [R, Fv] f32, k0 [W + Fv, Wv] and b0 [Wv] (compute dtype / f32)
// -> out [R, Wv] f32.  use_bf16 != 0 selects bfloat16 weights.
int lean_view_proj(const void* view, const void* k0, const void* b0, void* out,
                   int R, int Fv, int W, int Wv, int use_bf16, void* stream) {
  if (R <= 0 || Fv <= 0 || Wv <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int blocks = (int)(((long long)R * Wv + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_bf16)
    lean_view_proj_kernel<bf16><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(view), static_cast<const bf16*>(k0),
        static_cast<const float*>(b0), static_cast<float*>(out), R, Fv, W, Wv);
  else
    lean_view_proj_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(view), static_cast<const float*>(k0),
        static_cast<const float*>(b0), static_cast<float*>(out), R, Fv, W, Wv);
  return (int)cudaGetLastError();
}

// moments [6, M] f32, vproj [R, Wv] f32, weights[i] [in_i, out_i] in the
// compute dtype and biases[i] [out_i] f32 in param_order -> out [M, 4] f32
// (activated rgb | sigma).  Widths: multiples of 4 (f32) or 16 (bf16, the
// tensor cores' k16 / paired n8 tiles), at most MAX_OUT.
int lean_mlp(const void* moments, const void* vproj, const void* weights,
             const void* biases, int n_layers, void* out, int M, int N, int R,
             int L, int min_deg, int depth, int depth_cond, int skip, int W,
             int Wv, float rgb_padding, float density_bias, int use_bf16,
             void* stream) {
  const int align = use_bf16 ? 16 : 8;
  if (n_layers != depth + 3 + depth_cond || n_layers > MAX_PARAMS / 2 || depth < 1 ||
      depth_cond < 1 || skip < 1 || W < align || W > MAX_OUT || W % align || Wv < align ||
      Wv > MAX_OUT || Wv % align || M != R * N || M <= 0 || L < 1)
    return (int)cudaErrorInvalidValue;
  LayerPtrs p;
  const void* const* w = static_cast<const void* const*>(weights);
  const void* const* b = static_cast<const void* const*>(biases);
  for (int i = 0; i < n_layers; ++i) {
    p.w[i] = w[i];
    p.b[i] = static_cast<const float*>(b[i]);
  }
  MlpDims d{M, N, R, L, min_deg, depth, depth_cond, skip, W, Wv, rgb_padding, density_bias};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mo = static_cast<const float*>(moments);
  const float* vp = static_cast<const float*>(vproj);
  float* o = static_cast<float*>(out);
  return use_bf16 ? launch_mlp<bf16>(mo, vp, p, d, o, s)
              : launch_mlp<float>(mo, vp, p, d, o, s);
}

// rgbsig [R * N, 4] f32, delta / mids [R, N] f32 -> perray [R, 8]
// (comp rgb | acc | dist | 0 0 0), weights [R, N].
int lean_composite(const void* rgbsig, const void* delta, const void* mids,
                   void* perray, void* weights, int R, int N, int white_bkgd,
                   void* stream) {
  if (R <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (R + RAYS_PER_BLOCK - 1) / RAYS_PER_BLOCK;
  lean_composite_kernel<<<blocks, 32 * RAYS_PER_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rgbsig), static_cast<const float*>(delta),
      static_cast<const float*>(mids), static_cast<float*>(perray),
      static_cast<float*>(weights), R, N, white_bkgd);
  return (int)cudaGetLastError();
}

}  // extern "C"
