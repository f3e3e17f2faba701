// Standalone IPE encodes for Hopper (sm_90a), plain C interface.
//
// ipe_moments replaces the TPU kernel mipnerf_pl_tpu/kernels/ipe.py
// _moments_kernel (the pl.pallas_call in _run_moments, behind
// fused_ipe_moments): the [6, M] channel-major moments (means xyz | diagonal
// covs xyz) -> the [M, 6L] f32 integrated positional encoding, the encode rows
// the lean training kernels read when `nerf.pallas_encode` selects this
// producer.  With s = 2^(min_deg + l), column l*3 + d holds exp(-0.5 cov_d
// s^2) sin(y), y = mean_d s, and column 3L + l*3 + d the same with sin(fl32(y
// + fl32(pi/2))): the default encode's cosine half, rounded as its f32
// formula rounds it.  Each pair is ipe_moments_pair (ipe_core.cuh), the
// routine every lean kernel's in-tile decode of the moments calls
// (decode_moments, lean_engines.cuh), so the rows agree with those decodes
// bit for bit.  It has no backward: the moments get no cotangent (the lean
// family trains behind stop_resample_grad).
//
// ipe_fwd and ipe_bwd replace _fwd_kernel and _bwd_kernel of the same file
// (the pl.pallas_calls in _run_fwd / _run_bwd, behind the custom VJP
// fused_ipe, which `nerf.ipe_backend: pallas` selects): means and diagonal
// covs [M, 3] -> [M, 6L], and its VJP.  Column l*3 + d holds exp(-0.5 cov_d
// s^2) sin(mean_d s) and column 3L + l*3 + d the same with cos(mean_d s):
// the cosine itself, which differs from sin(y + pi/2) in f32 once mean*s is
// large (ipe_sincos).
//
// What bounds them: 24 B in + 24L B out a point (the forwards; ~160 MB a
// lego training level, ~48 us at 3.35 TB/s), the backward 24 + 24L in and
// 24 out (~170 MB, ~51 us).  Their arguments mean 2^deg reach 2^15 |mean|
// at the lego degrees, where CUDA's exact sincosf turns slow; no kernel here
// calls it: each (point, dim) reduces mean 2/pi once and takes every degree
// from it in FP64 (ipe_core.cuh), one thread a (point, dim) running all L
// degrees (mean and cov load once, no 64-bit division, every lane runs the
// same code).  ipe_moments_pair takes two sines (its cosine half is the
// sine of another f32 argument, whose quarter turns it forms from the same
// turns), each on one odd polynomial.
//
// The memory side overlaps the arithmetic: each block is persistent over
// tiles of IPE_POINTS points, two tiles of shared memory in turn.
//
//   ipe_fwd, ipe_moments  one template (ipe_rows): a tile's rows [P][6L]
//            are written into shared memory as they lie in out, and one bulk
//            TMA copy stores them while the block computes the next tile.
//            Lane p starts its ladder at degree p mod L, so that a warp's
//            stores of one step fall on different banks.  ipe_fwd reads
//            its [M, 3] inputs row-major, ipe_moments the [6, M] moments
//            channel-major (a warp's lanes on ~11 consecutive points of
//            three rows).  damp a (point, degree, dim) (a recurrence over the
//            degrees would compound its rounding): ipe_fwd's expf(-cov 2^(2
//            deg - 1)), ipe_moments_pair's expf(-0.5 (cov 2^(2 deg))).
//   ipe_bwd  the next tile's cotangent rows (one stretch of g) come in by
//            cp.async (16 bytes a copy when a row is a whole number of
//            them, L even; else 4) while the block works on this one; each
//            (point, dim) forms its 2L terms from the same sin / cos as the
//            forward and sums them in ladder order in registers: no second
//            pass, no atomics, so two runs agree bit for bit.  Shared rows
//            are ipe_stride(L) floats apart, 4 mod 8: 16-byte aligned, and
//            the 32 lanes of a warp, threads 3 p + d, reading one column of
//            their rows fall on 32 banks but for two pairs.
//
// L <= IPE_MAX_DEGREES: two tiles stay within 50 KB, and every 2^deg t
// after the first reduction under 2^(L + 1), far inside the 2^51 the
// rounding takes.

#include "ipe_core.cuh"
#include "sm90.cuh"

namespace {

constexpr int IPE_POINTS = 32;              // points a tile holds
constexpr int IPE_THREADS = 3 * IPE_POINTS;  // one a (point, dim)
constexpr int IPE_MAX_DEGREES = 32;

__host__ __device__ constexpr int ipe_stride(int L) {
  return 6 * L + ((4 - 6 * L) % 8 + 8) % 8;
}

// Bulk copies (no tensor map): shared -> global, 16-byte aligned, a multiple
// of 16 bytes, committed with tma_store_commit; cp.async global -> shared.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

// All but the newest committed store have finished reading shared memory.
__device__ __forceinline__ void bulk_wait_read_but_one() {
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The rows [M, 6L] of ipe_fwd (MOMENTS false: means, covs [M, 3]) or of
// ipe_moments (MOMENTS true: means, covs the rows [3, M] of the moments).
template <bool MOMENTS>
__device__ __forceinline__ void ipe_rows(const float* __restrict__ means,
                                         const float* __restrict__ covs, float* __restrict__ out,
                                         int M, int L, int min_deg) {
  extern __shared__ __align__(16) float tiles[];  // two tiles [IPE_POINTS][6L]
  const int L3 = 3 * L, F = 2 * L3, q = threadIdx.x, p = q / 3, d = q - 3 * p;
  const int n_tiles = (int)(((long long)M + IPE_POINTS - 1) / IPE_POINTS);
  int buf = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    float* rows = tiles + buf * IPE_POINTS * F;
    const long long m0 = (long long)tile * IPE_POINTS;
    const int points = M - m0 < IPE_POINTS ? (int)(M - m0) : IPE_POINTS;
    if (q == 0) bulk_wait_read_but_one();  // this buffer's store, two tiles back
    __syncthreads();
    if (p < points) {
      const long long at = MOMENTS ? (long long)d * M + m0 + p : m0 * 3 + q;
      const float mean = means[at], cov = covs[at];
      const IpeTurns t = ipe_turns(mean, min_deg);
      float* row = rows + p * F + d;
      for (int j = 0, l = p % L; j < L; ++j, l = l + 1 == L ? 0 : l + 1) {
        const int deg = min_deg + l;
        if constexpr (MOMENTS) {
          ipe_moments_pair({t, mean, cov}, deg, row[3 * l], row[L3 + 3 * l]);
        } else {
          float sn, cs;
          ipe_sincos(t, pow2d(deg), sn, cs);
          const float damp = expf(-(cov * pow2f(2 * deg - 1)));
          row[3 * l] = damp * sn;
          row[L3 + 3 * l] = damp * cs;
        }
      }
    }
    fence_proxy_async();
    __syncthreads();
    if (q == 0) {
      // The tile's rows are one stretch of out, 16-byte aligned (IPE_POINTS
      // 24L bytes a tile); an odd L * points leaves 8 bytes to store here.
      const int n = points * F, whole = n & ~3;
      bulk_store(out + m0 * F, rows, whole * 4);
      tma_store_commit();
      for (int e = whole; e < n; ++e) out[m0 * F + e] = rows[e];
    }
  }
  if (q == 0) tma_store_wait();
}

__global__ void __launch_bounds__(IPE_THREADS)
ipe_fwd_kernel(const float* __restrict__ means, const float* __restrict__ covs,
               float* __restrict__ out, int M, int L, int min_deg) {
  ipe_rows<false>(means, covs, out, M, L, min_deg);
}

__global__ void __launch_bounds__(IPE_THREADS)
ipe_moments_kernel(const float* __restrict__ moments, float* __restrict__ out, int M, int L,
                   int min_deg) {
  ipe_rows<true>(moments, moments + 3 * (size_t)M, out, M, L, min_deg);
}

// g [M, 6L] -> dmeans, dcovs [M, 3].
__global__ void __launch_bounds__(IPE_THREADS)
ipe_bwd_kernel(const float* __restrict__ means, const float* __restrict__ covs,
               const float* __restrict__ g, float* __restrict__ dmeans,
               float* __restrict__ dcovs, int M, int L, int min_deg) {
  extern __shared__ __align__(16) float tiles[];  // two tiles of rows ipe_stride(L) apart
  const int L3 = 3 * L, F = 2 * L3, S = ipe_stride(L), q = threadIdx.x, p = q / 3,
            d = q - 3 * p;
  const int n_tiles = (int)(((long long)M + IPE_POINTS - 1) / IPE_POINTS);
  // A thread's 16-byte pieces of a tile (L even) are q, q + IPE_THREADS, ...:
  // row and piece of the first, and the step between two.
  const int F4 = F / 4, r0 = F4 ? q / F4 : 0, c0 = F4 ? q % F4 : 0;
  const int dr = F4 ? IPE_THREADS / F4 : 0, dc = F4 ? IPE_THREADS % F4 : 0;
  // A tile's cotangent rows into buffer b.
  const auto fetch = [&](int tile, int b) {
    if (tile >= n_tiles) return;
    const long long m0 = (long long)tile * IPE_POINTS;
    const int points = M - m0 < IPE_POINTS ? (int)(M - m0) : IPE_POINTS;
    float* rows = tiles + b * IPE_POINTS * S;
    const float* src = g + m0 * F;
    if (F % 4 == 0) {
      for (int i = q, r = r0, c = c0; i < points * F4; i += IPE_THREADS) {
        cp_async16(rows + r * S + 4 * c, src + 4 * i);
        r += dr;
        if ((c += dc) >= F4) c -= F4, ++r;
      }
    } else {  // a warp a row, a lane a column
      for (int r = q >> 5; r < points; r += IPE_THREADS / 32)
        for (int c = q & 31; c < F; c += 32) cp_async4(rows + r * S + c, src + r * F + c);
    }
  };
  fetch(blockIdx.x, 0);
  cp_async_commit();
  int buf = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    fetch(tile + gridDim.x, buf ^ 1);
    cp_async_commit();
    cp_async_wait_but_one();
    __syncthreads();
    const long long m0 = (long long)tile * IPE_POINTS;
    const int points = M - m0 < IPE_POINTS ? (int)(M - m0) : IPE_POINTS;
    if (p < points) {
      const float cov = covs[m0 * 3 + q];
      const IpeTurns t = ipe_turns(means[m0 * 3 + q], min_deg);
      const float* row = tiles + buf * IPE_POINTS * S + p * S + d;
      float dm = 0.f, dc = 0.f;
      for (int l = 0; l < L; ++l) {
        const int deg = min_deg + l;
        float sn, cs;
        ipe_sincos(t, pow2d(deg), sn, cs);
        const float s2 = pow2f(2 * deg - 1), damp = expf(-(cov * s2));
        const float g_sin = row[3 * l], g_cos = row[L3 + 3 * l];
        // d enc_sin / d mean = s damp cos, d enc_cos / d mean = -s damp sin;
        // d enc / d cov = -0.5 s^2 enc.
        dm += (g_sin * damp * cs - g_cos * damp * sn) * pow2f(deg);
        dc += -((g_sin * damp * sn + g_cos * damp * cs) * s2);
      }
      dmeans[m0 * 3 + q] = dm;
      dcovs[m0 * 3 + q] = dc;
    }
    __syncthreads();  // this buffer is refilled next
  }
}

// Blocks of a persistent kernel: as many as stay resident, at most a tile
// each.
template <typename Kernel>
unsigned ipe_grid(Kernel kernel, int M, size_t shared) {
  if (shared > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, IPE_THREADS, shared);
  const long long tiles = ((long long)M + IPE_POINTS - 1) / IPE_POINTS;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  return (unsigned)(tiles < resident ? tiles : resident);
}

bool ipe_takes(int M, int L, int min_deg) {
  return M > 0 && L >= 1 && L <= IPE_MAX_DEGREES && min_deg >= IPE_MIN_DEG &&
         min_deg + L <= IPE_END_DEG;
}

}  // namespace

extern "C" {

// moments [6, M] f32 -> out [M, 6L] f32.
int ipe_moments(const void* moments, void* out, int M, int L, int min_deg, void* stream) {
  if (!ipe_takes(M, L, min_deg) || reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  const size_t shared = 2 * IPE_POINTS * 6 * L * sizeof(float);
  ipe_moments_kernel<<<ipe_grid(ipe_moments_kernel, M, shared), IPE_THREADS, shared,
                       static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(moments),
                                                            static_cast<float*>(out), M, L,
                                                            min_deg);
  return (int)cudaGetLastError();
}

// means, covs [M, 3] f32 -> out [M, 6L] f32 (sin block | cos block).
int ipe_fwd(const void* means, const void* covs, void* out, int M, int L, int min_deg,
            void* stream) {
  if (!ipe_takes(M, L, min_deg) || reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  const size_t shared = 2 * IPE_POINTS * 6 * L * sizeof(float);
  ipe_fwd_kernel<<<ipe_grid(ipe_fwd_kernel, M, shared), IPE_THREADS, shared,
                   static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(means),
                                                        static_cast<const float*>(covs),
                                                        static_cast<float*>(out), M, L, min_deg);
  return (int)cudaGetLastError();
}

// means, covs [M, 3], g [M, 6L] f32 -> dmeans, dcovs [M, 3] f32.
int ipe_bwd(const void* means, const void* covs, const void* g, void* dmeans, void* dcovs, int M,
            int L, int min_deg, void* stream) {
  if (!ipe_takes(M, L, min_deg)) return (int)cudaErrorInvalidValue;
  const size_t shared = 2 * IPE_POINTS * ipe_stride(L) * sizeof(float);
  ipe_bwd_kernel<<<ipe_grid(ipe_bwd_kernel, M, shared), IPE_THREADS, shared,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(means), static_cast<const float*>(covs),
      static_cast<const float*>(g), static_cast<float*>(dmeans), static_cast<float*>(dcovs), M, L,
      min_deg);
  return (int)cudaGetLastError();
}

}  // extern "C"
