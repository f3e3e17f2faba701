// Standalone moments-form IPE encode for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel mipnerf_pl_tpu/kernels/ipe.py _moments_kernel (the
// pl.pallas_call in _run_moments, behind fused_ipe_moments): the [6, M]
// channel-major moments (means xyz | diagonal covs xyz) -> the [M, 6L] f32
// integrated positional encoding, the encode rows the lean training kernels
// read when `nerf.pallas_encode` selects this producer.
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

}  // extern "C"
