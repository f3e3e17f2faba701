// The cotangent chain of the lean training backward on Hopper's wgmma and
// TMA (lean_train.cu): bf16, the channel-major saved stream of 'save' and
// 'recompute', widths multiples of 64.  The other forms (f32, the
// point-major residuals of 'hybrid', the classic MLP) keep
// lean_grad_chain_kernel.
//
// A persistent block walks 128-point tiles with three warpgroups: in the
// first, one thread streams the weights, one the saved activations' boxes,
// and two warps turn those into ReLU mask bits; consumer warpgroup wg owns
// the tile's points 64 wg + [0, 64).  The steps of a tile, in order (ChainPlan::step):
//   heads   the head cotangents, activation derivatives folded in (from the
//           raw heads the forward saved), to G and to shared memory;
//   rgb     the rgb head's 3-deep backward on the CUDA cores -> ys[last];
//   view_j  j = last .. 1 -> ys[j - 1];  view_0 -> the bottleneck;
//   bottleneck (+ the rank-1 density term) -> hs[depth - 1];
//   trunk_i i = depth - 1 .. 1 -> hs[i - 1].
// A layer is D[64 points][N] = A[64][K] B[K][N], one m64nNk16 per k16 step
// (N = 256 or 128), f32 accumulators in registers: A is the step before's
// output cotangent, the bf16 tile its epilogue left in shared memory
// (channel rows of 64 points: MN-major), B the transposed weights bw [K][N]
// streamed through a 6-stage ring of 32-row slabs (TMA, 128-byte swizzle,
// MN-major).  Both warpgroups read every slab, so a weight byte from L2
// feeds 128 points.  A step's epilogue adds the density term, applies the
// mask (`> 0` of the stored activation, bits a 4-slot ring ahead), and
// writes the cotangent in bf16 into the staging tile; a TMA store takes the
// tile to G, and the next layer reads it as its A.  The f32
// values give the bias column sums (per warp, then the warpgroup's 4 warps
// in order, each warpgroup its own sums, added at the end) and, for ys[0],
// g1f.  No atomics: the per-block sums go to db_part as before.
//
// What bounds it: 2 x 0.55 M MACs a point (0.43 TFLOP a lego level, 0.44 ms
// at the bf16 peak); the L2 weight traffic is 1.1 MB a tile (3.4 GB a
// level); HBM moves the masks' rows of S and the G rows (~3.7 GB, 1.1 ms).

#pragma once

#include "sm90.cuh"

namespace {

constexpr int CH_TM = 128;                  // points of a tile
constexpr int CH_THREADS = 384;             // a producer warpgroup + two consumer warpgroups
constexpr int CH_STAGES = 4;                // weight ring
constexpr int CH_KS = 32;                   // weight rows (K) a slab
constexpr int CH_MASKS = 4;                 // mask ring
constexpr int CH_RAW = 6;                   // activation boxes for the masks
constexpr int CH_MAX_STEPS = 16;
constexpr int CH_BOX = 64 * 64 * 2;         // a 64-row x 64-point cotangent box
constexpr int CH_WBOX = CH_KS * 64 * 2;     // a 32-row x 64-column weight box
constexpr int CH_MASK = MAX_OUT * CH_TM / 8;   // mask bytes of a step
constexpr size_t CH_FIXED = (size_t)CH_STAGES * 4 * CH_WBOX + 2 * 4 * CH_BOX +
                            CH_MASKS * CH_MASK + CH_RAW * CH_BOX +
                            sizeof(float) * (2 * 4 * MAX_OUT + 2 * 4 * CH_TM);

struct ChainStep {
  int w;         // weight map, -1: the rgb head on the CUDA cores
  int K, N;      // input cotangent width (the layer's out), output width
  int act_row;   // first S row of the masking activation, -1: no mask
  int g_row;     // first G row of the output cotangent
  int flags;     // 1: the f32 cotangent also to g1f; 2: + the density term
};

struct ChainPlan {
  CUtensorMap w[CH_MAX_STEPS];   // bw [K][N], 32 x 64 boxes
  CUtensorMap act;               // S [Cs][Mp], 64 x 64 boxes, not swizzled
  CUtensorMap g;                 // G [Cg][Mp], 64 x 64 boxes
  ChainStep step[CH_MAX_STEPS];
  int n_steps;
};

constexpr size_t CH_SMEM_MAX = 232448;   // an H100 block's dynamic shared memory

// CH_FIXED, each warpgroup's Cg bias sums, the mbarriers, and the slack
// that aligns the buffers to 1024 bytes.
inline size_t chain_sm90_smem(int Cg) {
  return CH_FIXED + 2 * sizeof(float) * ((Cg + 1) & ~1) +
         sizeof(uint64_t) * 2 * (CH_STAGES + CH_MASKS + CH_RAW) + 1024;
}

__global__ void __launch_bounds__(CH_THREADS, 1)
lean_chain_sm90_kernel(const __grid_constant__ ChainPlan plan, const float* __restrict__ heads,
                       const float* __restrict__ g_rgb, const float* __restrict__ g_dens,
                       ChainPtrs cp, TrainDims d, bf16* __restrict__ G, float* __restrict__ g1f,
                       float* __restrict__ db_part, int n_rows) {
  extern __shared__ uint8_t ch_raw[];
  uint8_t* smem = ch_raw + ((1024 - (smem_u32(ch_raw) & 1023)) & 1023);
  uint8_t* ring = smem;                                        // [stage][4 boxes]
  uint8_t* tiles = ring + CH_STAGES * 4 * CH_WBOX;             // [wg][4 boxes]
  uint8_t* masks = tiles + 2 * 4 * CH_BOX;                     // [slot][channel][16 bytes]
  uint8_t* raw = masks + CH_MASKS * CH_MASK;                   // [slot][64 rows][128 bytes]
  float* part = reinterpret_cast<float*>(raw + CH_RAW * CH_BOX);  // [wg][4][MAX_OUT]
  float* gh = part + 2 * 4 * MAX_OUT;                          // [4][CH_TM] head cotangents
  float* ghc = gh + 4 * CH_TM;                                 // the same, bf16 values
  const int Cg = d.cg(), Cg2 = (Cg + 1) & ~1;
  float* dbacc = ghc + 4 * CH_TM;                              // [wg][Cg2] bias sums
  uint64_t* full = reinterpret_cast<uint64_t*>(dbacc + 2 * Cg2);
  uint64_t* empty = full + CH_STAGES;
  uint64_t* mask_full = empty + CH_STAGES;
  uint64_t* mask_empty = mask_full + CH_MASKS;
  uint64_t* raw_full = mask_empty + CH_MASKS;
  uint64_t* raw_empty = raw_full + CH_RAW;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t Mp = d.Mp;
  const int n_tiles = (d.Mp + CH_TM - 1) / CH_TM;
  if (tid == 0) {
    for (int s = 0; s < CH_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);
    }
    for (int s = 0; s < CH_MASKS; ++s) {
      mbar_init(mask_full + s, 64);
      mbar_init(mask_empty + s, 2);
    }
    for (int s = 0; s < CH_RAW; ++s) {
      mbar_init(raw_full + s, 1);
      mbar_init(raw_empty + s, 64);
    }
    mbar_fence_init();
  }
  for (int c = tid; c < 2 * Cg2; c += CH_THREADS) dbacc[c] = 0.f;
  __syncthreads();

  if (warp == 0) {
    // Weights: per step its K / 32 slabs through the ring.
    if (lane == 0) {
      int slab = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
        for (int si = 0; si < plan.n_steps; ++si) {
          const ChainStep& st = plan.step[si];
          if (st.w < 0) continue;
          const int nb = st.N / 64;
          for (int k0 = 0; k0 < st.K; k0 += CH_KS, ++slab) {
            const int s = slab % CH_STAGES;
            mbar_wait(empty + s, ((slab / CH_STAGES) & 1) ^ 1);
            mbar_expect_tx(full + s, nb * CH_WBOX);
            for (int cb = 0; cb < nb; ++cb)
              tma_load_2d(ring + (s * 4 + cb) * CH_WBOX, &plan.w[st.w], full + s, 64 * cb, k0);
          }
        }
    }
    return;
  }
  if (warp == 1) {
    // The activations' tiles for the masks: per masked step, its N / 64 x 2
    // boxes of 64 channels x 64 points through the raw ring.
    if (lane == 0) {
      int rb = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
        for (int si = 0; si < plan.n_steps; ++si) {
          const ChainStep& st = plan.step[si];
          if (st.act_row < 0) continue;
          for (int cb = 0; cb < st.N / 64; ++cb)
            for (int h = 0; h < 2; ++h, ++rb) {
              const int r = rb % CH_RAW;
              mbar_wait(raw_empty + r, ((rb / CH_RAW) & 1) ^ 1);
              mbar_expect_tx(raw_full + r, CH_BOX);
              tma_load_2d(raw + r * CH_BOX, &plan.act, raw_full + r, tile * CH_TM + 64 * h,
                          st.act_row + 64 * cb);
            }
        }
    }
    return;
  }
  if (warp < 4) {
    // Masks: bit p & 7 of byte 16 c + p / 8 of a slot is `S > 0` for
    // channel c of the step's activation at the tile's point p (points past
    // the stream read 0), from the raw boxes, up to CH_MASKS steps ahead of
    // the epilogues; two warps, a 16-byte chunk (8 points) a thread at a
    // time.
    const int mt = tid - 64;
    int ms = 0, rb = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
      for (int si = 0; si < plan.n_steps; ++si) {
        const ChainStep& st = plan.step[si];
        if (st.act_row < 0) continue;
        const int slot = ms % CH_MASKS;
        mbar_wait(mask_empty + slot, ((ms / CH_MASKS) & 1) ^ 1);
        uint8_t* mb = masks + slot * CH_MASK;
        for (int cb = 0; cb < st.N / 64; ++cb)
          for (int h = 0; h < 2; ++h, ++rb) {
            const int r = rb % CH_RAW;
            mbar_wait(raw_full + r, (rb / CH_RAW) & 1);
            const uint8_t* box = raw + r * CH_BOX;
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              const int v = mt + 64 * k, c = v >> 3, p8 = v & 7;
              const uint4 u = *reinterpret_cast<const uint4*>(box + c * 128 + p8 * 16);
              const bf16* e = reinterpret_cast<const bf16*>(&u);
              uint32_t bits = 0;
#pragma unroll
              for (int i = 0; i < 8; ++i) bits |= (__bfloat162float(e[i]) > 0.f ? 1u : 0u) << i;
              mb[(64 * cb + c) * 16 + 8 * h + p8] = (uint8_t)bits;
            }
            mbar_arrive(raw_empty + r);
          }
        mbar_arrive(mask_full + slot);
        ++ms;
      }
    return;
  }

  // Consumers.  Accumulator 32 nb + 4 j + e (64-column block nb, n8 block
  // j, element e): row 16 wi + g + 8 (e >> 1) of the warpgroup's 64, column
  // 64 nb + 8 j + 2 q + (e & 1).  The two warpgroups meet only at the
  // weight and mask rings: each keeps its own bias sums.
  const int ct = tid - 128, cw = ct >> 5, wg = cw >> 2, wi = cw & 3, g = lane >> 2, q = lane & 3;
  const int wt = ct & 127, bar = 2 + wg;   // thread in the warpgroup, its barrier
  const bf16* k_rgb = static_cast<const bf16*>(cp.k_rgb);
  const bf16* k_den = static_cast<const bf16*>(cp.k_den);
  float* mydb = dbacc + wg * Cg2;
  float* mypart = part + wg * 4 * MAX_OUT;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  int slab = 0, ms = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = tile * CH_TM;
    // Head cotangents of the warpgroup's 64 points: with activated heads,
    // d sigmoid = s (1 - s) widened by the padding, d softplus(z + b) =
    // sigmoid(z + b), from the raw heads.
    for (int i = wt; i < 4 * 64; i += 128) {
      const int c = i >> 6, row = 64 * wg + (i & 63), m = m0 + row;
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
      const bf16 gb = __float2bfloat16_rn(gv);
      gh[c * CH_TM + row] = gv;
      ghc[c * CH_TM + row] = __bfloat162float(gb);
      if (m < d.Mp) G[(size_t)(c < 3 ? d.g_rgb() + c : d.g_den()) * Mp + m] = gb;
    }
    named_sync(bar, 128);
    if (wt < 4) {
      float s = 0.f;
      for (int row = 0; row < 64; ++row) s += gh[wt * CH_TM + 64 * wg + row];
      mydb[wt < 3 ? d.g_rgb() + wt : d.g_den()] += s;
    }

    for (int si = 0; si < plan.n_steps; ++si) {
      const ChainStep& st = plan.step[si];
      const int NB = st.N / 64;
      if (st.w >= 0) {
        // The layer's products, K / 32 slabs of two k16 steps; A is the
        // step before's cotangent tile in its staging buffer (rows =
        // channels, MN-major), k16 step t at box t / 4, row 16 (t % 4).
        // A slab is released once the products of the next have been
        // issued and its own are complete.
        const uint32_t a_base = smem_u32(tiles + wg * 4 * CH_BOX);
        const int nks = st.K / CH_KS;
        int prev = 0;
#pragma unroll 1
        for (int ks = 0; ks < nks; ++ks) {
          const int s = slab % CH_STAGES;
          mbar_wait(full + s, (slab / CH_STAGES) & 1);
          const uint32_t b_base = smem_u32(ring + s * 4 * CH_WBOX);
          fence_regs(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            const int t = 2 * ks + kk;
            const uint64_t da = sw128_desc(a_base + (t >> 2) * CH_BOX + (t & 3) * 2048);
            const uint32_t b = b_base + kk * 2048;
            // One product over all N columns (B's atoms CH_WBOX apart).
            if (NB == 4) {
              wgmma_tt_m64n256(acc, da, sw128_desc(b, CH_WBOX), t > 0);
            } else if (NB >= 2) {
              wgmma_tt_m64n128(sub<64>(acc, 0), da, sw128_desc(b, CH_WBOX), t > 0);
              if (NB == 3)
                wgmma_tt_m64n64(sub<32>(acc, 64), da, sw128_desc(b + 2 * CH_WBOX), t > 0);
            } else {
              wgmma_tt_m64n64(sub<32>(acc, 0), da, sw128_desc(b), t > 0);
            }
          }
          wgmma_commit();
          wgmma_wait1();
          fence_regs(acc);
          if (ks > 0 && lane == 0) mbar_arrive(empty + prev);
          prev = s;
          ++slab;
        }
        wgmma_wait0();
        fence_regs(acc);
        if (lane == 0) mbar_arrive(empty + prev);
      } else {
        // The rgb head's backward: sum over c of ghc[c] k_rgb[col][c].
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          if (nb >= NB) continue;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = 64 * nb + 8 * j + 2 * q + (e & 1);
              const int row = 64 * wg + 16 * wi + g + 8 * (e >> 1);
              float v = 0.f;
              for (int c = 0; c < 3; ++c)
                v = fmaf(ghc[c * CH_TM + row], __bfloat162float(k_rgb[col * 3 + c]), v);
              acc[32 * nb + 4 * j + e] = v;
            }
        }
      }
      // Epilogue: density term, mask, f32 to g1f, bf16 into the staging
      // tile, over this step's A, once the step before's store has read it.
      const bool mask = st.act_row >= 0, den = st.flags & 2;
      const bool to_g1f = st.flags & 1;
      const uint8_t* mb = masks + (ms % CH_MASKS) * CH_MASK + 8 * wg + 2 * wi;
      if (mask) mbar_wait(mask_full + ms % CH_MASKS, (ms / CH_MASKS) & 1);
      uint8_t* half = tiles + wg * 4 * CH_BOX;
      if (wt == 0) tma_store_wait_read();
      named_sync(bar, 128);
      // Element 32 nb + 4 j + 2 h + c is row r(h) = 16 wi + g + 8 h, column
      // col = 64 nb + 8 j + 2 q + c.
      if (den) {
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          if (nb >= NB) continue;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[32 * nb + 4 * j + e] =
                  fmaf(ghc[3 * CH_TM + 64 * wg + 16 * wi + g + 8 * (e >> 1)],
                       __bfloat162float(k_den[64 * nb + 8 * j + 2 * q + (e & 1)]),
                       acc[32 * nb + 4 * j + e]);
        }
      }
      if (mask) {
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          if (nb >= NB) continue;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              // The bits of rows g (byte 0) and g + 8 (byte 1).
              const uint32_t bits =
                  *reinterpret_cast<const uint16_t*>(mb + (64 * nb + 8 * j + 2 * q + c) * 16) >> g;
              if (!(bits & 1)) acc[32 * nb + 4 * j + c] = 0.f;
              if (!(bits & 256)) acc[32 * nb + 4 * j + 2 + c] = 0.f;
            }
        }
      }
      if (to_g1f) {
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          if (nb >= NB) continue;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const size_t m = (size_t)m0 + 64 * wg + 16 * wi + g + 8 * (e >> 1);
              if (m < Mp)
                g1f[(size_t)(64 * nb + 8 * j + 2 * q + (e & 1)) * Mp + m] = acc[32 * nb + 4 * j + e];
            }
        }
      }
      // bf16 into the staging tile, transposed by stmatrix: the 8 x 8 block
      // (rows 16 wi + 8 h.., columns 8 j..) goes to box rows 8 j + i (i <
      // 8), 16-byte chunk (2 wi + h) ^ i; lane 8 k + i gives that row's
      // address for matrix k = (h, j & 1) of each pair of n8 blocks.
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        if (nb >= NB) continue;
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          const int k = lane >> 3, i = lane & 7, cl = 8 * (2 * jp + (k >> 1)) + i;
          uint8_t* row = half + nb * CH_BOX + cl * 128 + (((2 * wi + (k & 1)) ^ i) << 4);
          const float* d0 = &acc[32 * nb + 8 * jp];
          stmatrix_x4_trans(row, pack_bf16(d0[0], d0[1]), pack_bf16(d0[2], d0[3]),
                            pack_bf16(d0[4], d0[5]), pack_bf16(d0[6], d0[7]));
        }
      }
      fence_proxy_async();
      named_sync(bar, 128);
      if (wt == 0) {
        if (mask) mbar_arrive(mask_empty + ms % CH_MASKS);
        for (int cb = 0; cb < NB; ++cb)
          tma_store_2d(&plan.g, half + cb * CH_BOX, m0 + 64 * wg, st.g_row + 64 * cb);
        tma_store_commit();
      }
      ms += mask;
      // Column sums: the warp's 16 rows (a butterfly over the 8 lanes of a
      // column pair that leaves lane (g, q) the sums of n8 block j = g),
      // then the warpgroup's 4 warps in order.
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        if (nb >= NB) continue;
        float v[16];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            v[2 * j + c] = acc[32 * nb + 4 * j + c] + acc[32 * nb + 4 * j + c + 2];
#pragma unroll
        for (int h = 8, m = 16; h >= 2; h >>= 1, m >>= 1) {
          const bool up = lane & m;
#pragma unroll
          for (int i = 0; i < h; ++i) {
            const float send = up ? v[i] : v[i + h];
            v[i] = (up ? v[i + h] : v[i]) + __shfl_xor_sync(FULL, send, m);
          }
        }
        mypart[wi * MAX_OUT + 64 * nb + 8 * g + 2 * q] = v[0];
        mypart[wi * MAX_OUT + 64 * nb + 8 * g + 2 * q + 1] = v[1];
      }
      named_sync(bar, 128);
      for (int c = wt; c < st.N; c += 128)
        mydb[st.g_row + c] += ((mypart[c] + mypart[MAX_OUT + c]) + mypart[2 * MAX_OUT + c]) +
                              mypart[3 * MAX_OUT + c];
    }
  }
  if (wt == 0) tma_store_wait();
  named_sync(1, 256);
  for (int c = ct; c < Cg; c += 256) db_part[(size_t)blockIdx.x * Cg + c] = dbacc[c] + dbacc[Cg2 + c];
  if (blockIdx.x == 0)
    for (size_t i = (size_t)gridDim.x * Cg + ct; i < (size_t)n_rows * Cg; i += 256) db_part[i] = 0.f;
}

// The plan of the chain on wgmma for the chunk whose saved activations are
// `acts` (channel-major, one stream) and cotangents G [Cg][d.Mp]: false if
// this form does not fit it (widths not multiples of 64, too many layers,
// a tensor map cuTensorMapEncodeTiled refuses).
inline bool chain_sm90_plan(ChainPlan& pl, const Acts& acts, const ChainPtrs& cp,
                            const TrainDims& d, const void* G) {
  if (d.W % 64 || d.Wv % 64 || d.depth_cond < 1 || d.nd != 1 || d.Fvp ||
      d.depth + d.depth_cond + 1 > CH_MAX_STEPS || d.Mp % 64 ||
      chain_sm90_smem(d.cg()) > CH_SMEM_MAX)
    return false;
  const char* base = static_cast<const char*>(acts.t[0]);
  const size_t row_bytes = 2 * (size_t)acts.ld[0];
  auto row_of = [&](int a) {
    return (int)((static_cast<const char*>(acts.t[a]) - base) / (long long)row_bytes);
  };
  const int i_view = d.depth + 2, last = d.depth_cond - 1;
  int n = 0, nw = 0;
  auto add = [&](int layer, int K, int N, int act, int g_row, int flags) {
    ChainStep& st = pl.step[n++];
    st.w = -1;
    if (layer >= 0) {
      if (!make_map(&pl.w[nw], cp.bw[layer], K, N, N, CH_KS)) return false;
      st.w = nw++;
    }
    st.K = K;
    st.N = N;
    st.act_row = act < 0 ? -1 : row_of(act);
    st.g_row = g_row;
    st.flags = flags;
    return true;
  };
  bool ok = add(-1, 0, d.Wv, d.a_y(last), d.g_v(last), last == 0);
  for (int j = last; j >= 1; --j)
    ok = ok && add(i_view + j, d.Wv, d.Wv, d.a_y(j - 1), d.g_v(j - 1), j == 1);
  ok = ok && add(i_view, d.Wv, d.W, -1, d.g_bot(), 0);
  ok = ok && add(d.depth + 1, d.W, d.W, d.a_h(d.depth - 1), d.g_t(d.depth - 1), 2);
  for (int i = d.depth - 1; i >= 1; --i)
    ok = ok && add(i, d.W, d.W, d.a_h(i - 1), d.g_t(i - 1), 0);
  pl.n_steps = n;
  const int s_rows = d.Fp + (d.depth + 1) * d.W + d.depth_cond * d.Wv;
  return ok && make_map(&pl.act, base, s_rows, d.Mp, acts.ld[0], 64, CU_TENSOR_MAP_SWIZZLE_NONE) &&
         make_map(&pl.g, G, d.cg(), d.Mp, d.Mp, 64);
}

}  // namespace
