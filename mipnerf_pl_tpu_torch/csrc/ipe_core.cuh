// The IPE's sine core: sin and cos of mean 2^deg in f32 from one exact
// reduction a (point, dim), shared by the standalone encodes (ipe.cu) and
// the lean kernels' in-tile decode of the moments (lean_engines.cuh,
// lean_fwd_sm90.cuh, lean_fwd_tf32.cuh).  No libm sinf / cosf / sincosf:
// CUDA's exact ones leave their fast reduction past |arg| ~ 105,615 (2^15
// |mean| at the lego degrees) for a slow one in local memory, and a warp
// whose lanes took it waited on its slowest lane.
//
//   one reduction a (point, dim): t = mean 2/pi as a double-double (an FP64
//       two-product against a two-part 2/pi, ~105 bits), its multiples of
//       4 2^-deg0 taken off (exact, and every 2^deg t, deg >= deg0, keeps
//       its value mod 4); then a degree is 2^deg t, exact, whose nearest
//       integer k (rounded by adding 1.5 2^52, whose low mantissa bits then
//       hold k) gives the quadrant and f = 2^deg t - k, |f| <= 1/2, the
//       quarter turns past it; a second rounding takes any integer that
//       2^deg t_lo carries (means past ~2^50 2^-deg).  The error of f is
//       ~2^-105 |2^deg t|.  Two reductions of one mean from different deg0
//       give every degree the same f and the same quadrant mod 4, so the
//       values do not depend on how a caller splits a ladder;
//   the cores: sin(pi f / 2) and cos(pi f / 2) as polynomials in f^2 in
//       FP64 (ipe_sincos, for ipe_fwd / ipe_bwd, which take both), or the
//       sine alone as one odd polynomial on [-1, 1] (ipe_sin, for the
//       moments form, which takes two sines), coefficients fitted by
//       weighted least squares on Chebyshev nodes (relative error 5e-12,
//       4e-13 and 2.1e-11) and read from constant memory, not rebuilt in
//       registers each degree; rounded once to f32, within ~0.5 ulp of the
//       exact values (tests/test_torch_ipe.py mirrors both in numpy and
//       holds them against float64 sin / cos at degrees up to 32, means up
//       to 1e10).
//
// Scales 2^deg and 2^(2 deg) are built from their exponent bits (degrees
// IPE_MIN_DEG..IPE_END_DEG - 1, where both are normal floats), so x 2^e is
// one exact product: the value ldexpf gives.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int IPE_MIN_DEG = -62, IPE_END_DEG = 64;  // degrees the scales take

// 2/pi as a double-double, and the constant whose addition rounds a double
// below 2^51 to an integer held in its low mantissa bits.
constexpr double TWO_OVER_PI_HI = 0x1.45f306dc9c883p-1;
constexpr double TWO_OVER_PI_LO = -0x1.6b01ec5417056p-55;
// TWO_OVER_PI_HI = A + B exactly, A of 28 significant bits, B of 22: a
// double of up to 25 bits times either is exact.
constexpr double TWO_OVER_PI_A = 0x1.45f306ep-1;
constexpr double TWO_OVER_PI_B = -0x1.b1bbe8p-32;
constexpr double ROUND_MAGIC = 0x1.8p+52;
// fl32(pi / 2): the default encode's phase of its cosine half.
constexpr float HALF_PI_F32 = 0x1.921fb6p+0f;
// On |f| <= 1/2: sin(pi f / 2) = f (S0 + f^2 (S1 + f^2 (S2 + ...))),
// cos(pi f / 2) = 1 + f^2 (C0 + f^2 (C1 + ...)), S = IPE_SIN, C = IPE_COS.
__constant__ double IPE_SIN[5] = {0x1.921fb5443f418p+0, -0x1.4abbce58b7039p-1,
                                  0x1.466bbbc623cd1p-4, -0x1.32caf54d31facp-8,
                                  0x1.4bdc50b884a7ep-13};
__constant__ double IPE_COS[5] = {-0x1.3bd3cc9be3ecap+0, 0x1.03c1f07f444a0p-2,
                                  -0x1.55d3c266ee629p-6, 0x1.e1ece6fd2706fp-11,
                                  -0x1.a203bfd42e823p-16};
// On |x| <= 1: sin(pi x / 2) = x (P0 + x^2 (P1 + x^2 (P2 + ...))), P =
// IPE_SINE.
__constant__ double IPE_SINE[6] = {0x1.921fb5441e495p+0, -0x1.4abbce4f1a2b2p-1,
                                   0x1.466bbfc24f1b0p-4, -0x1.32d112019fb10p-8,
                                   0x1.500ff7efa48a3p-13, -0x1.cc345a238f62dp-19};

__device__ __forceinline__ double pow2d(int e) {  // 2^e, |e| <= 1022
  return __hiloint2double((e + 1023) << 20, 0);
}

__device__ __forceinline__ float pow2f(int e) {  // 2^e, |e| <= 126
  return __int_as_float((e + 127) << 23);
}

// mean 2/pi as hi + lo, hi's multiples of 4 2^-deg0 taken off.
struct IpeTurns {
  double hi, lo;
};

__device__ __forceinline__ IpeTurns ipe_turns(float mean, int deg0) {
  const double m = mean;
  const double hi = m * TWO_OVER_PI_HI;
  const double lo = fma(m, TWO_OVER_PI_LO, fma(m, TWO_OVER_PI_HI, -hi));
  return {fma(-rint(hi * pow2d(deg0 - 2)), pow2d(2 - deg0), hi), lo};
}

// f's nearest integer (|f| < 2^51) added to q, f left as the rest.
__device__ __forceinline__ void ipe_round(double& f, unsigned& q) {
  const double big = f + ROUND_MAGIC;
  q += (unsigned)__double2loint(big);
  f += ROUND_MAGIC - big;
}

// The quadrant q and the quarter turns f past it of 2^deg t_hi, exact,
// |f| <= 1/2; scale = 2^deg.
__device__ __forceinline__ double ipe_quadrant(IpeTurns t, double scale, unsigned& q) {
  const double big = fma(t.hi, scale, ROUND_MAGIC);
  q = (unsigned)__double2loint(big);
  return fma(t.hi, scale, ROUND_MAGIC - big);
}

// sin and cos of mean 2^deg, scale = 2^deg.
__device__ __forceinline__ void ipe_sincos(IpeTurns t, double scale, float& sn, float& cs) {
  unsigned q;
  double f = fma(t.lo, scale, ipe_quadrant(t, scale, q));
  ipe_round(f, q);
  const double u = f * f;
  double ps = IPE_SIN[4], pc = IPE_COS[4];
#pragma unroll
  for (int i = 3; i >= 0; --i) {
    ps = fma(ps, u, IPE_SIN[i]);
    pc = fma(pc, u, IPE_COS[i]);
  }
  const float a = (float)(f * ps), b = (float)fma(u, pc, 1.0);
  const float sv = (q & 1u) ? b : a, cv = (q & 1u) ? a : b;
  sn = (q & 2u) ? -sv : sv;
  cs = ((q + 1u) & 2u) ? -cv : cv;
}

// sin(pi (q + f) / 2) in f32, |f| <= 1/2: sin(pi x / 2) with x = f, or for
// odd q x = 1 - |f| (cos(pi f / 2); the subtraction rounds by at most
// 2^-54, on a value of at least sin(pi / 4)).
__device__ __forceinline__ float ipe_sin(double f, unsigned q) {
  const double x = (q & 1u) ? 1.0 - fabs(f) : f;
  const double u = x * x;
  double p = IPE_SINE[5];
#pragma unroll
  for (int i = 4; i >= 0; --i) p = fma(p, u, IPE_SINE[i]);
  const float v = (float)(x * p);
  return (q & 2u) ? -v : v;
}

// One (point, dim) of the moments form of the encode (the default encode:
// its cosine half is sin(y + pi/2) in f32, not cos(y)): the turns of its
// mean from some deg0, the mean and the cov.
struct IpeMoments {
  IpeTurns t;
  float mean, cov;
};

// The pair of one degree deg >= deg0, damped by expf(-0.5 (cov 2^(2 deg))):
// vs = sin(y), vc = sin(z) with y = mean 2^deg (exact in f32) and z =
// fl32(y + fl32(pi / 2)), the values of ipe_moments_plain's f32 formula.
// z 2/pi = 2^deg t + d 2/pi with d = z - y (exact in FP64 but for |y| <
// 2^-28, where its rounding is 2^-53 of d): y's exact quadrant part f0,
// plus d A rounded to a quarter turn (exact wherever |y| >= 1/2, since d
// then has at most 25 significant bits), summed (|f0 + .| <= 1, one
// rounding of the final fraction), then the tails 2^deg t_lo and d (B +
// 2/pi's tail).  Where |y| < 1/2, z lies in (1.07, 2.07), sin(z) > 0.86,
// and the rounding of d A is 2^-53 of a quarter turn.  Explicit fma /
// __dmul_rn / __dadd_rn / __fadd_rn: no contraction changes a rounding, so
// every kernel that inlines it gets the same bits.
__device__ __forceinline__ void ipe_moments_pair(const IpeMoments& e, int deg, float& vs,
                                                 float& vc) {
  const double scale = pow2d(deg);
  unsigned q;
  const double f0 = ipe_quadrant(e.t, scale, q);
  double fs = fma(e.t.lo, scale, f0);
  unsigned qs = q;
  ipe_round(fs, qs);
  const float s = pow2f(deg);
  const double d = fma((double)e.mean, -scale, (double)__fadd_rn(e.mean * s, HALF_PI_F32));
  double dq = __dmul_rn(d, TWO_OVER_PI_A);
  ipe_round(dq, q);
  double fc = __dadd_rn(f0, dq);
  fc = __dadd_rn(fma(e.t.lo, scale, fc), fma(d, TWO_OVER_PI_B, __dmul_rn(d, TWO_OVER_PI_LO)));
  ipe_round(fc, q);
  const float damp = expf(-0.5f * (e.cov * (s * s)));
  vs = damp * ipe_sin(fs, qs);
  vc = damp * ipe_sin(fc, q);
}

}  // namespace
