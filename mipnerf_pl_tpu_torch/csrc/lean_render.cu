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
// and, for training through the render-fused level, the composite's backward
// (the new part of the TPU kernel _bwd_kernel_lean_render, the pl.pallas_call
// in _run_bwd_lean_render; the rest of it is the parameter-gradient
// backward of lean_train.cu):
//
//   lean_composite_bwd  one warp per ray: the per-ray cotangents -> the
//                   activated heads' cotangents        [R*N, 3], [R*N] f32
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
// completes before it overwrites its input in place.  The tile body
// (mlp_tile) and both tensor-core GEMM engines (f32 as 3xTF32, bf16 on
// mma.sync m16n8k16) live in lean_engines.cuh, shared with the training
// kernels of lean_train.cu.
// At widths that are multiples of 64, lean_mlp runs on the wgmma / TMA
// forwards instead (launch_mlp): bf16 on lean_fwd_sm90.cuh, f32 on the
// 3xTF32 lean_fwd_tf32.cuh.
//
// Numerics: the IPE decode (decode_moments, lean_engines.cuh) takes its
// sines from one exact FP64 reduction a (point, dim) (ipe_core.cuh), within
// ~0.5 ulp of float64 sin of each f32 argument, and libm's exact expf.
// Activations are rounded to the compute dtype after every layer, products
// accumulate in f32, biases arrive pre-rounded through the compute dtype,
// as in the TPU kernel.

#include "lean_engines.cuh"
#include "lean_fwd_sm90.cuh"
#include "lean_fwd_tf32.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
lean_mlp_kernel(const float* __restrict__ moments, const float* __restrict__ vproj,
                LayerPtrs p, MlpDims d, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int F = 6 * d.L, Fp = enc_rows(F);
  const int wmax = max(d.W, d.Wv);
  T* xs = reinterpret_cast<T*>(smem_raw);          // [Fp][LD] encode tile
  T* hs = xs + (size_t)Fp * LD;                     // [wmax][LD] activations
  T* slab = hs + (size_t)wmax * LD;                 // weight rows
  float* heads = reinterpret_cast<float*>(slab + Engine<T>::type::slab_elems(wmax));  // [4][TM]

  const int m0 = blockIdx.x * TM;

  // IPE decode into the encode tile (load_encode_tile, lean_engines.cuh).
  load_encode_tile<T, true>(xs, moments, d.M, d.M, F, Fp, d.L, d.min_deg, m0);
  __syncthreads();

  mlp_tile<T>(xs, F, hs, slab, heads, p, d, vproj, m0, nullptr, 0, Fp);
  write_activated(heads, d, m0, out);
}

// view_0's per-ray half for RAYS rays a block: k0's view rows k0[W:] and
// the block's view rows (transposed, [Fv][RAYS]), rounded through the
// compute dtype, in shared memory as f32.  A group of Wv / 2 threads takes
// 8 rays at a time: thread j sums output columns 2 j, 2 j + 1 of each in
// the order v = 0 .. Fv - 1 (one 8-byte k0 load and two 16-byte view loads
// a step for 16 FMAs), then + b0.  RAYS is chosen from R (lean_view_proj):
// the most rays a block that still gives every SM a block.
template <typename T, int RAYS>
__global__ void __launch_bounds__(256)
lean_view_proj_kernel(const float* __restrict__ view, const T* __restrict__ k0,
                      const float* __restrict__ b0, float* __restrict__ out, int R, int Fv, int W,
                      int Wv, int tw) {
  extern __shared__ float4 vp_smem4[];
  float* vt = reinterpret_cast<float*>(vp_smem4);   // [Fv][RAYS]
  float* ks = vt + Fv * RAYS;                        // [Fv][Wv]
  const int r0 = blockIdx.x * RAYS, nr = min(RAYS, R - r0);
  // k0[W:] is contiguous: 16-byte loads, all in flight at once.
  constexpr int VEC = 16 / sizeof(T);
  const T* kv0 = k0 + (size_t)W * Wv;
  const int nvec = (size_t)W * Wv % VEC ? 0 : Fv * Wv / VEC;
#pragma unroll 4
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const uint4 u = reinterpret_cast<const uint4*>(kv0)[i];
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int k = 0; k < VEC; ++k) ks[i * VEC + k] = Ty<T>::to_f(e[k]);
  }
  for (int i = nvec * VEC + threadIdx.x; i < Fv * Wv; i += blockDim.x) ks[i] = Ty<T>::to_f(kv0[i]);
  for (int i = threadIdx.x; i < RAYS * Fv; i += blockDim.x) {
    const int r = i / Fv, v = i - r * Fv;
    vt[v * RAYS + r] = r < nr ? Ty<T>::to_f(Ty<T>::from_f(view[(size_t)r0 * Fv + i])) : 0.f;
  }
  __syncthreads();
  const int j = threadIdx.x % tw, groups = blockDim.x / tw;
  if (2 * j >= Wv) return;
  const float2 b = *reinterpret_cast<const float2*>(b0 + 2 * j);
  for (int rc = 8 * (threadIdx.x / tw); rc < nr; rc += 8 * groups) {
    float2 s[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) s[r] = make_float2(0.f, 0.f);
    for (int v = 0; v < Fv; ++v) {
      const float2 kv = *reinterpret_cast<const float2*>(ks + v * Wv + 2 * j);
      const float4 a = *reinterpret_cast<const float4*>(vt + v * RAYS + rc);
      const float4 c = *reinterpret_cast<const float4*>(vt + v * RAYS + rc + 4);
      const float x[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        s[r].x = fmaf(x[r], kv.x, s[r].x);
        s[r].y = fmaf(x[r], kv.y, s[r].y);
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if (rc + r < nr)
        *reinterpret_cast<float2*>(out + (size_t)(r0 + rc + r) * Wv + 2 * j) =
            make_float2(s[r].x + b.x, s[r].y + b.y);
  }
}

// The rays a block of lean_view_proj_kernel: 32, 16 or 8, the most that
// still give `sms` blocks.
inline int view_proj_rays(int R, int sms) {
  for (int rays = 32; rays > 8; rays /= 2)
    if ((R + rays - 1) / rays >= sms) return rays;
  return 8;
}

template <typename T, int RAYS>
int launch_view_proj_rays(const float* view, const T* k0, const float* b0, float* out, int R,
                          int Fv, int W, int Wv, cudaStream_t s) {
  // A group of tw >= Wv / 2 threads (whole warps) a chunk of 8 rays.
  const int tw = (Wv / 2 + 31) / 32 * 32, groups = tw <= 256 / (RAYS / 8) ? RAYS / 8 : 1;
  const size_t smem = sizeof(float) * ((size_t)Fv * Wv + RAYS * Fv);
  if (smem > 48 * 1024 || Wv % 4 || tw * groups > 256) return (int)cudaErrorInvalidValue;
  lean_view_proj_kernel<T, RAYS><<<(R + RAYS - 1) / RAYS, tw * groups, smem, s>>>(
      view, k0, b0, out, R, Fv, W, Wv, tw);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_view_proj(const float* view, const void* k0, const float* b0, float* out, int R,
                     int Fv, int W, int Wv, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const T* k = static_cast<const T*>(k0);
  switch (view_proj_rays(R, sms)) {
    case 32: return launch_view_proj_rays<T, 32>(view, k, b0, out, R, Fv, W, Wv, s);
    case 16: return launch_view_proj_rays<T, 16>(view, k, b0, out, R, Fv, W, Wv, s);
    default: return launch_view_proj_rays<T, 8>(view, k, b0, out, R, Fv, W, Wv, s);
  }
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

// Backward of lean_composite (the TPU kernel's _lean_render_head_cotangents):
// the per-ray cotangents g_perray [R, 8] (comp | acc | dist | pad) and g_w
// [R, N], with the activated heads rgbsig [R * N, 4] and delta / mids [R, N]
// -> the head cotangents g_rgb [R * N, 3] and g_sig [R * N] f32.  One warp
// per ray, the forward's sample order and scans:
//   g_w'  = g_w + g_dist mids + g_acc' + g_comp . rgb  (g_acc' = g_acc -
//           sum g_comp with a white background)
//   g_dd  = exp(-dd) g_w' trans + sum_{m > n} g_s[m],  g_s = -trans g_w' alpha
//   g_rgb = w g_comp,  g_sig = g_dd delta.
// Pass 1 walks the 32-sample chunks forwards and keeps the transmittance
// carry at the start of each (shared memory, nchunks floats a warp); pass 2
// walks them backwards, recomputes dd, alpha, trans and w bit for bit as the
// forward did, and carries the suffix sum of g_s (JAX's strictly-lower-
// triangular product) from the later chunks.  Memory bound: ~44 bytes a
// point.  Lanes past N (a ragged last chunk) add nothing to either scan.
__global__ void __launch_bounds__(32 * RAYS_PER_BLOCK)
lean_composite_bwd_kernel(const float* __restrict__ rgbsig, const float* __restrict__ delta,
                          const float* __restrict__ mids, const float* __restrict__ g_perray,
                          const float* __restrict__ g_w, float* __restrict__ g_rgb,
                          float* __restrict__ g_sig, int R, int N, int white_bkgd) {
  extern __shared__ float carries[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ray = blockIdx.x * RAYS_PER_BLOCK + warp;
  if (ray >= R) return;  // uniform per warp
  const int nchunks = (N + 31) / 32;
  float* carry_at = carries + (size_t)warp * nchunks;
  const float4* rs = reinterpret_cast<const float4*>(rgbsig) + (size_t)ray * N;
  const size_t base_rn = (size_t)ray * N;
  auto scan = [&](float dd, float& excl) {   // the forward's inclusive scan
    float incl = dd;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += t;
    }
    excl = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) excl = 0.f;
    return incl;
  };

  float carry = 0.f;
  for (int c = 0; c < nchunks; ++c) {
    const int n = 32 * c + lane;
    float excl;
    const float incl = scan(n < N ? rs[n].w * delta[base_rn + n] : 0.f, excl);
    if (lane == 0) carry_at[c] = carry;
    carry += __shfl_sync(FULL, incl, 31);
  }
  __syncwarp();

  const float* gp = g_perray + (size_t)ray * 8;
  const float gc0 = gp[0], gc1 = gp[1], gc2 = gp[2], g_dist = gp[4];
  const float g_acc = white_bkgd ? gp[3] - (gc0 + gc1 + gc2) : gp[3];
  float later = 0.f;   // sum of g_s over the chunks after this one
  for (int c = nchunks - 1; c >= 0; --c) {
    const int n = 32 * c + lane;
    const bool valid = n < N;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    float dl = 0.f, md = 0.f, gw = 0.f;
    if (valid) {
      v = rs[n];
      dl = delta[base_rn + n];
      md = mids[base_rn + n];
      gw = g_w[base_rn + n];
    }
    const float dd = valid ? v.w * dl : 0.f;
    float excl;
    scan(dd, excl);
    const float e = expf(-dd);
    const float alpha = 1.f - e;
    const float trans = expf(-(carry_at[c] + excl));
    const float w = alpha * trans;
    const float gwt = gw + g_dist * md + (g_acc + gc0 * v.x + gc1 * v.y + gc2 * v.z);
    const float gs = valid ? -trans * (gwt * alpha) : 0.f;
    // Suffix scan of g_s within the chunk: lane n gets sum over lanes > n.
    float sincl = gs;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_down_sync(FULL, sincl, o);
      if (lane + o < 32) sincl += t;
    }
    float sexcl = __shfl_down_sync(FULL, sincl, 1);
    if (lane == 31) sexcl = 0.f;
    if (valid) {
      const float g_dd = e * (gwt * trans) + (later + sexcl);
      g_sig[base_rn + n] = g_dd * dl;
      float* o = g_rgb + (base_rn + n) * 3;
      o[0] = w * gc0;
      o[1] = w * gc1;
      o[2] = w * gc2;
    }
    later += __shfl_sync(FULL, sincl, 0);
  }
}

// bf16 at the widths fwd_sm90_route takes: lean_fwd_sm90_kernel on the
// moments with activated heads and no stream (lean_fwd_sm90.cuh, the
// kernel of the bf16 training forwards); f32 at the widths fwd_tf32_route
// takes: lean_fwd_tf32_kernel (lean_fwd_tf32.cuh, from the split transposed
// kernels wt, the kernel of the f32 training forwards); every other form
// lean_mlp_kernel.
template <typename T>
int launch_mlp(const float* moments, const float* vproj, const LayerPtrs& p,
               const void* const* wt, const MlpDims& d, float* out, cudaStream_t stream) {
  const int F = 6 * d.L;
  if (sizeof(T) == 4 && fwd_tf32_route(F, d.W, d.Wv, d.depth, d.depth_cond)) {
    TfPlan pl;
    if (!fwd_tf32_plan(pl, p, wt, d.M, (d.M + TM - 1) / TM * TM, d.N, d.R, F, d.L, d.min_deg,
                       d.M, d.depth, d.depth_cond, d.skip, d.W, d.Wv, 1, d.rgb_padding,
                       d.density_bias, nullptr))
      return (int)cudaErrorInvalidValue;
    return launch_fwd_tf32(pl, true, moments, vproj, out, nullptr, stream);
  }
  if (sizeof(T) == 2 && fwd_sm90_route(F, d.W, d.Wv, d.depth, d.depth_cond)) {
    FwdPlan pl;
    if (!fwd_sm90_plan(pl, p, d.M, (d.M + TM - 1) / TM * TM, d.N, d.R, F, d.L, d.min_deg, d.M,
                       d.depth, d.depth_cond, d.skip, d.W, d.Wv, 1, d.rgb_padding,
                       d.density_bias, nullptr))
      return (int)cudaErrorInvalidValue;
    return launch_fwd_sm90(pl, true, moments, vproj, out, nullptr, stream);
  }
  const size_t smem = mlp_smem_bytes<T>(enc_rows(6 * d.L), d.W > d.Wv ? d.W : d.Wv);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(view);
  const float* b = static_cast<const float*>(b0);
  float* o = static_cast<float*>(out);
  return use_bf16 ? launch_view_proj<bf16>(v, k0, b, o, R, Fv, W, Wv, s)
                  : launch_view_proj<float>(v, k0, b, o, R, Fv, W, Wv, s);
}

// moments [6, M] f32, vproj [R, Wv] f32, weights[i] [in_i, out_i] in the
// compute dtype and biases[i] [out_i] f32 in param_order -> out [M, 4] f32
// (activated rgb | sigma).  Widths: multiples of 4 (f32) or 16 (bf16, the
// tensor cores' k16 / paired n8 tiles), at most MAX_OUT.  wt: f32 at the
// widths of fwd_tf32_route, the split transposed kernels [2N][Kp] of the
// dense layers by param index (kernels/mlp.py tf32_fwd_weights); else may
// be null.
int lean_mlp(const void* moments, const void* vproj, const void* weights,
             const void* biases, const void* wt, int n_layers, void* out, int M, int N, int R,
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
  const void* const* split = static_cast<const void* const*>(wt);
  return use_bf16 ? launch_mlp<bf16>(mo, vp, p, split, d, o, s)
                  : launch_mlp<float>(mo, vp, p, split, d, o, s);
}

// Launches of lean_fwd_sm90_kernel by this library so far.
long long lean_fwd_sm90_launches() { return g_fwd_sm90_launches; }

// Launches of lean_fwd_tf32_kernel by this library so far.
long long lean_fwd_tf32_launches() { return g_fwd_tf32_launches; }

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

// rgbsig [R * N, 4] (activated heads), delta / mids / g_w [R, N], g_perray
// [R, 8] f32 -> g_rgb [R * N, 3], g_sig [R * N] f32.
int lean_composite_bwd(const void* rgbsig, const void* delta, const void* mids,
                       const void* g_perray, const void* g_w, void* g_rgb, void* g_sig, int R,
                       int N, int white_bkgd, void* stream) {
  if (R <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * RAYS_PER_BLOCK * ((N + 31) / 32);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int blocks = (R + RAYS_PER_BLOCK - 1) / RAYS_PER_BLOCK;
  lean_composite_bwd_kernel<<<blocks, 32 * RAYS_PER_BLOCK, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rgbsig), static_cast<const float*>(delta),
      static_cast<const float*>(mids), static_cast<const float*>(g_perray),
      static_cast<const float*>(g_w), static_cast<float*>(g_rgb), static_cast<float*>(g_sig), R,
      N, white_bkgd);
  return (int)cudaGetLastError();
}

}  // extern "C"
