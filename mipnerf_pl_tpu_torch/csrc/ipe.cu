// Standalone IPE encodes for Hopper (sm_90a), plain C interface.
//
// ipe_moments replaces the TPU kernel mipnerf_pl_tpu/kernels/ipe.py
// _moments_kernel (the pl.pallas_call in _run_moments, behind
// fused_ipe_moments): the [6, M] channel-major moments (means xyz | diagonal
// covs xyz) -> the [M, 6L] f32 integrated positional encoding, the encode rows
// the lean training kernels read when `nerf.pallas_encode` selects this
// producer.
//
//   ipe_moments  one thread per output element (point m, feature f), the
//                feature index fastest, so a warp writes 32 consecutive
//                floats of a row; each value is ipe_feature (lean_engines.cuh),
//                the decode every lean kernel runs in its encode tile, with
//                exact libm expf/sinf.
//
// What bounds it: 24 bytes in and 24L bytes out a point (384 at L = 16,
// ~160 MB a lego training level, ~48 us at 3.35 TB/s); two transcendentals
// an output.  It has no backward: the moments get no cotangent (the lean
// family trains behind stop_resample_grad).
//
// ipe_fwd and ipe_bwd replace _fwd_kernel and _bwd_kernel of the same file
// (the pl.pallas_calls in _run_fwd / _run_bwd, behind the custom VJP
// fused_ipe, which `nerf.ipe_backend: pallas` selects): means and diagonal
// covs [M, 3] -> [M, 6L], and its VJP.  With s = 2^(min_deg + l), column
// l*3 + d holds exp(-0.5 cov_d s^2) sin(mean_d s) and column 3L + l*3 + d
// the same with cos(mean_d s): the cosine itself, where ipe_feature (and the
// default encode) takes sin(y + pi/2), which differs in f32 once mean*s is
// large.  So neither kernel calls ipe_feature.
//
//   ipe_fwd  one thread per (point, degree, dim): one expf and one sincosf,
//            two stores 3L floats apart; the (degree, dim) index is fastest,
//            so a warp writes 32 consecutive floats of each half row.
//   ipe_bwd  a block takes IPE_BWD_POINTS points.  It stages their
//            cotangent rows (one contiguous stretch of g) through shared
//            memory with coalesced loads, each (point, degree, dim) turns its
//            two cotangents into its terms of dmean and dcov in place, and
//            after a barrier one thread per (point, dim) adds the L terms in
//            ladder order: no atomics, so two runs agree bit for bit.
//
// What bounds them: forward 24 B in + 24L B out a point, backward 24 + 24L in
// and 24 out (~160 / ~170 MB a lego level); 3L expf and 3L sincosf a point,
// whose arguments reach 2^15 |mean|, where sincosf takes its slow exact
// reduction (expect local memory for it in the ptxas line).  Scales are
// exact powers of two (ldexpf), so every product with them is exact.

#include "lean_engines.cuh"

namespace {

__global__ void ipe_moments_kernel(const float* __restrict__ moments, float* __restrict__ out,
                                   int M, int L, int min_deg) {
  const int F = 6 * L;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)M * F) return;
  const int m = (int)(idx / F), f = (int)(idx - (size_t)m * F);
  out[idx] = ipe_feature(moments, M, m, f, L, min_deg);
}

constexpr int IPE_BWD_POINTS = 32;   // points a backward block stages

__global__ void ipe_fwd_kernel(const float* __restrict__ means, const float* __restrict__ covs,
                               float* __restrict__ out, int M, int L, int min_deg) {
  const int L3 = 3 * L;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)M * L3) return;
  const size_t m = idx / L3;
  const int j = (int)(idx - m * L3), deg = min_deg + j / 3, d = j % 3;
  const float arg = ldexpf(means[m * 3 + d], deg);
  const float damp = expf(-ldexpf(covs[m * 3 + d], 2 * deg - 1));
  float sn, cs;
  sincosf(arg, &sn, &cs);
  float* row = out + m * 2 * L3;
  row[j] = damp * sn;
  row[L3 + j] = damp * cs;
}

// g [M, 6L] -> dmeans, dcovs [M, 3].  Shared rows are 6L + 1 floats apart so
// that the threads of the final sums fall on different banks.
__global__ void ipe_bwd_kernel(const float* __restrict__ means, const float* __restrict__ covs,
                               const float* __restrict__ g, float* __restrict__ dmeans,
                               float* __restrict__ dcovs, int M, int L, int min_deg) {
  extern __shared__ float tile[];
  const int L3 = 3 * L, F = 2 * L3, stride = F + 1;
  const size_t m0 = (size_t)blockIdx.x * IPE_BWD_POINTS;
  const int points = (size_t)M - m0 < IPE_BWD_POINTS ? (int)((size_t)M - m0) : IPE_BWD_POINTS;
  const float* g0 = g + m0 * F;
  for (int e = threadIdx.x; e < points * F; e += blockDim.x)
    tile[(e / F) * stride + e % F] = g0[e];
  __syncthreads();
  for (int e = threadIdx.x; e < points * L3; e += blockDim.x) {
    const int p = e / L3, j = e % L3, deg = min_deg + j / 3, d = j % 3;
    const size_t m = m0 + p;
    const float arg = ldexpf(means[m * 3 + d], deg);
    const float damp = expf(-ldexpf(covs[m * 3 + d], 2 * deg - 1));
    float sn, cs;
    sincosf(arg, &sn, &cs);
    float* row = tile + p * stride;
    const float g_sin = row[j], g_cos = row[L3 + j];
    // d enc_sin / d mean = s damp cos, d enc_cos / d mean = -s damp sin;
    // d enc / d cov = -0.5 s^2 enc.
    row[j] = ldexpf(g_sin * damp * cs - g_cos * damp * sn, deg);
    row[L3 + j] = -ldexpf(g_sin * damp * sn + g_cos * damp * cs, 2 * deg - 1);
  }
  __syncthreads();
  for (int q = threadIdx.x; q < points * 3; q += blockDim.x) {
    const float* row = tile + (q / 3) * stride + q % 3;
    float dm = 0.f, dc = 0.f;
    for (int l = 0; l < L; ++l) {
      dm += row[3 * l];
      dc += row[L3 + 3 * l];
    }
    dmeans[m0 * 3 + q] = dm;
    dcovs[m0 * 3 + q] = dc;
  }
}

}  // namespace

extern "C" {

// moments [6, M] f32 -> out [M, 6L] f32.
int ipe_moments(const void* moments, void* out, int M, int L, int min_deg, void* stream) {
  if (M <= 0 || L < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long total = (long long)M * 6 * L;
  ipe_moments_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(moments),
                                                            static_cast<float*>(out), M, L,
                                                            min_deg);
  return (int)cudaGetLastError();
}

// means, covs [M, 3] f32 -> out [M, 6L] f32 (sin block | cos block).
int ipe_fwd(const void* means, const void* covs, void* out, int M, int L, int min_deg,
            void* stream) {
  if (M <= 0 || L < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long total = (long long)M * 3 * L;
  ipe_fwd_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(means),
                                                        static_cast<const float*>(covs),
                                                        static_cast<float*>(out), M, L, min_deg);
  return (int)cudaGetLastError();
}

// means, covs [M, 3], g [M, 6L] f32 -> dmeans, dcovs [M, 3] f32.
int ipe_bwd(const void* means, const void* covs, const void* g, void* dmeans, void* dcovs, int M,
            int L, int min_deg, void* stream) {
  if (M <= 0 || L < 1) return (int)cudaErrorInvalidValue;
  const size_t shared = (size_t)IPE_BWD_POINTS * (6 * L + 1) * sizeof(float);
  if (shared > 48 * 1024) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)(((long long)M + IPE_BWD_POINTS - 1) / IPE_BWD_POINTS);
  ipe_bwd_kernel<<<blocks, 256, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(means), static_cast<const float*>(covs),
      static_cast<const float*>(g), static_cast<float*>(dmeans), static_cast<float*>(dcovs), M, L,
      min_deg);
  return (int)cudaGetLastError();
}

}  // extern "C"
