// The Megatron pair kernels on Hopper's wgmma and TMA (tp_pair.cu):
// tp_pair_fwd and the chain of tp_pair_bwd at the widths the tensor-parallel
// slice gives them, bf16 with f32 accumulators and f32 as 3xTF32, one kernel
// template for both (tp_pair_wg_kernel<BF16, BWD>).  Replaces, at those
// widths, the mma.sync tiles tp_pair_fwd_kernel / tp_pair_bwd_kernel
// behind the TPU kernels _pair_kernel and _pair_bwd_kernel
// (mipnerf_pl_tpu/kernels/tp_lean.py); the weight gradients and the sums
// after the chain stay wgrad_sm90_kernel / wgrad_tf32_kernel and
// sum_rows_kernel, reading the stream S this chain writes.
//
// Route (pair_wg_route, mirrored by kernels/tp_lean.py pair_sm90_route /
// pair_tf32_route): the local width Wl a multiple of 64 up to 512, the
// output width Wout a multiple of 64, any f_in, any row count, and a ring
// of at least two stages beside the hidden tile.  Other widths keep the
// mma.sync kernels; a plan this kernel cannot make raises through the
// wrapper.
//
// What it computes (the TPU bodies): the forward out [M, Wout] f32 =
// relu(x Wcol + bcol) Wrow, the hidden activation h cast to the compute
// dtype and never out of shared memory; the chain hpre = x Wcol + bcol, h
// = cast(relu(hpre)), dh = (cast(g) Wrow^T) where hpre > 0, dx = cast(dh)
// Wcol^T f32, the per-block column sums of the f32 dh (db_part), and the
// channel-major stream S = x | h | g | dh in the compute dtype (the rows of
// stream_rows, zero past M) that the weight gradients read.
//
// Four products, P1 hpre = x Wcol (K f_in, N Wl), P2 out = h Wrow (K Wl, N
// Wout), P3 dh = g Wrow^T (K Wout, N Wl), P4 dx = dh Wcol^T (K Wl, N f_in):
// the forward runs P1, P2; the chain P1, P3, P4.  A persistent block (one
// an SM) walks 64-point tiles with 12 warps: warp 0's lane 0 streams B,
// the weights, by TMA through a ring of `stages` slabs; warps 1-2 (the
// helpers, a thread a point) write the streamed A operands, x (P1) and g
// (P3), from global memory into the slab's A part in a register pass (that
// is where the first pair's f32 encode rows and g are cast: TMA cannot
// cast), the loads of the two slabs after it in flight; in the chain, warp
// 3 copies each such slab of a product's first pass from shared memory to
// S's x or g rows before it releases the slot with the consumers; the
// two consumer warpgroups split each product's 64-column blocks (the first
// ceil(NB / 2) to warpgroup 0, the rest to warpgroup 1) and run them in
// passes of PB blocks.  The A of P2 and P4 is the hidden tile, h then dh,
// channel-major in shared memory [Wl][64 points]: P1's epilogue (bias,
// ReLU, keep_positive, cast) writes it in the layout P2 reads, P3's reads
// the mask from it and writes dh over it.  bf16 (KS = 32 rows a slab, PB =
// 4: m64n256, 128 accumulators): A and B from shared memory, both MN-major
// with the 128-byte swizzle (the A slab one box of 32 rows x 64 points, B
// the weights as stored [K][N] in 32 x 64 boxes, the tile 64-row boxes
// written by stmatrix); h and dh go to S by TMA stores of the tile's boxes.
// f32 (KS = 16, PB = 2: m64n128, 64 accumulators): 3xTF32 as
// lean_fwd_tf32.cuh, A from registers split into tf32 hi / lo (from the
// slab or the tile, f32 [k][64 points] with the point index XOR 8 (k & 3)
// so that the fragment loads hit 32 banks), B the transposed weights split
// once a call by the wrapper ([2 Np][Kp]: hi rows then lo rows, K-major,
// 64-byte swizzle, 16 K columns a slab); h and dh go to S by 16-byte
// stores.  The f32 tile is 128 KB at Wl = 512, so its ring has two stages
// of 36 KB (bf16: four).
//
// Order: every sum is taken in a fixed order (the column sums per warp by
// a butterfly, then the warpgroup's four warps in order, into the block's
// per-column sums; each column belongs to one warpgroup), no atomics: two
// runs give the same bits.
//
// What bounds it: 2 M Wl (f_in + Wout) FLOP forward and 2 M Wl (2 f_in +
// Wout) in the chain, against (f_in + Wout) values a row in and Wout (or
// f_in + the S rows) out: the tensor cores at the widths of the slice
// (0.834 ms for the later pair forward at 1024 -> 512 -> 1024, 393,216
// rows, at the bf16 peak).  L2 weight traffic: both panels each 64-point
// tile (2 MB bf16, 4 MB f32 hi + lo at that pair).

#pragma once

#include <type_traits>

#include "lean_engines.cuh"
#include "sm90.cuh"

namespace {

constexpr int TP_TM = 64;                // points of a tile
constexpr int TP_THREADS = 384;          // producer warp, helper warps, 2 consumer warpgroups
constexpr int TP_HELPERS = 2;            // warps 1 and 2: a thread a point
constexpr int TP_MAX_STAGES = 4;
constexpr int TP_ABYTES = 4096;          // A slab: 32 x 64 bf16 or 16 x 64 f32
constexpr int TP_BOX = 4096;             // a B box: 32 x 64 bf16, 64 x 16 f32
constexpr int TP_STAGE = TP_ABYTES + 8 * TP_BOX;
constexpr int TP_MAX_LOCAL = 512;
constexpr int TP_PART = 256;             // a warp's column partials
constexpr size_t TP_SMEM_MAX = 232448;   // an H100 block's dynamic shared memory

template <bool BF16>
struct TpCfg;
template <>
struct TpCfg<true> {
  static constexpr int KS = 32, PB = 4;
};
template <>
struct TpCfg<false> {
  static constexpr int KS = 16, PB = 2;
};

// The least positive bfloat16 (2^-133).  A positive f32 pre-activation
// below it would round to a bf16 zero and drop out of the backward's mask,
// which the TPU kernel takes from the f32 value: such a value is stored as
// this one, 9e-41 away.
__device__ __forceinline__ float keep_positive(float v, bf16*) {
  const float tiny = __uint_as_float(0x00010000u);
  return v > 0.f && v < tiny ? tiny : v;
}
__device__ __forceinline__ float keep_positive(float v, float*) { return v; }

// Epilogues.
enum { TP_HIDDEN = 0, TP_OUT = 1, TP_DH = 2, TP_DX = 3 };

struct PairProd {
  int map;        // B's tensor map
  int K;          // depth, slabs of KS
  int nb0, nb1;   // 64-column blocks of warpgroup 0 ([0, nb0)) and 1 ([nb0, nb0 + nb1))
  int passes;     // ceil(nb0 / PB)
  int a;          // A: 0 the x rows, 1 the g rows (streamed by the helpers), 2 the tile
  int kind;       // epilogue
  int Np;         // 64 (nb0 + nb1): f32 B's lo rows start there
};

struct PairPlan {
  CUtensorMap w[3];   // B of the products
  CUtensorMap s;      // bf16 S [rows][Mp], 64 x 64 boxes (h and dh rows)
  PairProd prod[3];
  int n_prods, stages;
  int M, Mp, f_in, Fp, Wl, Wout;
  int x_f32;                  // x is f32, else the compute dtype
  int s_x, s_h, s_g, s_dh;    // first rows in S
};
static_assert(sizeof(PairPlan) + 8 * sizeof(void*) <= 4096,
              "tp_pair_wg_kernel's parameters exceed 4 KB");

// Launches of tp_pair_wg_kernel by this library: bf16, f32.
long long g_pair_sm90_launches = 0;
long long g_pair_tf32_launches = 0;

// The ring, the hidden tile, the mbarriers, the bias, the block's column
// sums, the warps' column partials, and the slack that aligns the ring to
// 1024 bytes.
inline size_t pair_wg_smem(bool bf16, int Wl, int stages) {
  return (size_t)stages * TP_STAGE + (size_t)Wl * TP_TM * (bf16 ? 2 : 4) +
         sizeof(uint64_t) * 3 * TP_MAX_STAGES + sizeof(float) * (2 * Wl + 2 * 4 * TP_PART) + 1024;
}

// The most stages (up to TP_MAX_STAGES) that fit beside the tile; 0: fewer
// than two.
inline int pair_wg_stages(bool bf16, int Wl) {
  for (int s = TP_MAX_STAGES; s >= 2; --s)
    if (pair_wg_smem(bf16, Wl, s) <= TP_SMEM_MAX) return s;
  return 0;
}

inline bool pair_wg_route(int f_in, int Wl, int Wout, bool bf16) {
  return f_in >= 1 && Wl >= 64 && Wl <= TP_MAX_LOCAL && Wl % 64 == 0 && Wout >= 64 &&
         Wout % 64 == 0 && pair_wg_stages(bf16, Wl) >= 2;
}

__device__ __forceinline__ void ldmatrix_x4_trans(const void* row, uint32_t& m0, uint32_t& m1,
                                                  uint32_t& m2, uint32_t& m3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(m0), "=r"(m1), "=r"(m2), "=r"(m3)
               : "r"(smem_u32(row))
               : "memory");
}

// Word of (k, point p) in an f32 [k][64] tile or slab.
__device__ __forceinline__ int tp_f32_at(int k, int p) { return k * TP_TM + (p ^ ((k & 3) << 3)); }

// Row m of the [rows][C] matrix src (f32, or bf16), columns [k0, k0 + KS),
// as floats: zero past C and for m >= M.
template <int KS>
__device__ __forceinline__ void tp_load_row(float (&v)[KS], const void* __restrict__ src,
                                            bool f32src, int M, int C, int m, int k0) {
#pragma unroll
  for (int k = 0; k < KS; ++k) v[k] = 0.f;
  if (m >= M) return;
  if (f32src) {
    const float* r = static_cast<const float*>(src) + (size_t)m * C;
    if ((C & 3) == 0 && (reinterpret_cast<uintptr_t>(r) & 15) == 0) {
#pragma unroll
      for (int c = 0; c < KS / 4; ++c)
        if (k0 + 4 * c < C) {
          const float4 u = __ldg(reinterpret_cast<const float4*>(r + k0 + 4 * c));
          v[4 * c] = u.x;
          v[4 * c + 1] = u.y;
          v[4 * c + 2] = u.z;
          v[4 * c + 3] = u.w;
        }
    } else {
#pragma unroll
      for (int k = 0; k < KS; ++k)
        if (k0 + k < C) v[k] = __ldg(r + k0 + k);
    }
  } else {
    const bf16* r = static_cast<const bf16*>(src) + (size_t)m * C;
    if ((C & 7) == 0 && (reinterpret_cast<uintptr_t>(r) & 15) == 0) {
#pragma unroll
      for (int c = 0; c < KS / 8; ++c)
        if (k0 + 8 * c < C) {
          const uint4 u = __ldg(reinterpret_cast<const uint4*>(r + k0 + 8 * c));
          const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
          for (int i = 0; i < 8; ++i) v[8 * c + i] = __bfloat162float(e[i]);
        }
    } else {
#pragma unroll
      for (int k = 0; k < KS; ++k)
        if (k0 + k < C) v[k] = __bfloat162float(r[k0 + k]);
    }
  }
}

// The slab a block's run is at: tile ti, product pi, pass ps, rows k0.
struct PairCursor {
  const PairPlan* pl;
  int ti, pi, ps, k0, ks;
  __device__ PairCursor(const PairPlan& plan, int tile, int kslab)
      : pl(&plan), ti(tile), pi(0), ps(0), k0(0), ks(kslab) {}
  __device__ bool valid() const { return ti < pl->Mp / TP_TM; }
  __device__ void next() {
    k0 += ks;
    if (k0 < pl->prod[pi].K) return;
    k0 = 0;
    if (++ps < pl->prod[pi].passes) return;
    ps = 0;
    if (++pi < pl->n_prods) return;
    pi = 0;
    ti += gridDim.x;
  }
};

template <bool BF16, bool BWD>
__global__ void __launch_bounds__(TP_THREADS, 1)
tp_pair_wg_kernel(const __grid_constant__ PairPlan pl, const void* __restrict__ x,
                  const float* __restrict__ g, const float* __restrict__ bc,
                  float* __restrict__ out, void* __restrict__ S, float* __restrict__ db_part) {
  using T = typename std::conditional<BF16, bf16, float>::type;
  constexpr int KS = TpCfg<BF16>::KS, PB = TpCfg<BF16>::PB;
  extern __shared__ uint8_t tp_raw[];
  uint8_t* ring = tp_raw + ((1024 - (smem_u32(tp_raw) & 1023)) & 1023);   // [stage][A | B]
  const int stages = pl.stages;
  uint8_t* tile = ring + (size_t)stages * TP_STAGE;                      // [Wl][64 points]
  uint64_t* full = reinterpret_cast<uint64_t*>(tile + (size_t)pl.Wl * TP_TM * sizeof(T));
  uint64_t* afull = full + TP_MAX_STAGES;
  uint64_t* empty = afull + TP_MAX_STAGES;
  float* bias = reinterpret_cast<float*>(empty + TP_MAX_STAGES);   // [Wl]
  float* dbacc = bias + pl.Wl;                                     // [Wl] the block's dh sums
  float* part = dbacc + pl.Wl;                                     // [wg][warp][TP_PART]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_tiles = pl.Mp / TP_TM;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(afull + s, 32 * TP_HELPERS);
      mbar_init(empty + s, BWD ? 9 : 8);
    }
    mbar_fence_init();
  }
  for (int c = tid; c < pl.Wl; c += TP_THREADS) {
    bias[c] = bc[c];
    dbacc[c] = 0.f;
  }
  __syncthreads();

  if (warp == 0) {
    // B: per slab the pass's 64-column blocks of both warpgroups, warpgroup
    // w's at boxes [w PB, w PB + its blocks) (f32: hi boxes, then lo).
    if (lane == 0) {
      int j = 0;
      for (int ti = blockIdx.x; ti < n_tiles; ti += gridDim.x)
        for (int pi = 0; pi < pl.n_prods; ++pi) {
          const PairProd& pr = pl.prod[pi];
          for (int p = 0; p < pr.passes; ++p) {
            const int nb[2] = {min(PB, max(0, pr.nb0 - p * PB)), min(PB, max(0, pr.nb1 - p * PB))};
            for (int k0 = 0; k0 < pr.K; k0 += KS, ++j) {
              const int s = j % stages;
              uint8_t* B = ring + (size_t)s * TP_STAGE + TP_ABYTES;
              mbar_wait(empty + s, ((j / stages) & 1) ^ 1);
              mbar_expect_tx(full + s, (nb[0] + nb[1]) * TP_BOX * (BF16 ? 1 : 2));
              for (int w = 0; w < 2; ++w) {
                const int cb = (w ? pr.nb0 : 0) + p * PB;
                for (int b = 0; b < nb[w]; ++b) {
                  if constexpr (BF16) {
                    tma_load_2d(B + (w * PB + b) * TP_BOX, &pl.w[pr.map], full + s, 64 * (cb + b),
                                k0);
                  } else {
                    tma_load_2d(B + (2 * w * PB + b) * TP_BOX, &pl.w[pr.map], full + s, k0,
                                64 * (cb + b));
                    tma_load_2d(B + ((2 * w + 1) * PB + b) * TP_BOX, &pl.w[pr.map], full + s, k0,
                                pr.Np + 64 * (cb + b));
                  }
                }
              }
            }
          }
        }
    }
    return;
  }

  if (warp == 1 + TP_HELPERS) {
    // The chain's S rows of x and g: each streamed slab of a product's
    // first pass, once the helpers have written it, copied from the slab's
    // A part to S (lane l points 2 l and 2 l + 1, a row a step), off the
    // helpers' path; the slot is released by this warp too (empty's count).
    if constexpr (BWD) {
      PairCursor c(pl, blockIdx.x, KS);
      const int p = 2 * lane;
      for (int j = 0; c.valid(); ++j, c.next()) {
        const int s = j % stages;
        const PairProd& pr = pl.prod[c.pi];
        mbar_wait(afull + s, (j / stages) & 1);
        if (pr.a < 2 && c.ps == 0) {
          const uint8_t* A = ring + (size_t)s * TP_STAGE;
          const bool is_x = pr.a == 0;
          const int rows = min(KS, (is_x ? pl.Fp : pl.Wout) - c.k0);
          T* dst = static_cast<T*>(S) + (size_t)((is_x ? pl.s_x : pl.s_g) + c.k0) * pl.Mp +
                   (size_t)c.ti * TP_TM + p;
#pragma unroll 8
          for (int k = 0; k < rows; ++k) {
            if constexpr (BF16)
              *reinterpret_cast<uint32_t*>(dst + (size_t)k * pl.Mp) = *reinterpret_cast<const uint32_t*>(
                  A + k * 128 + (((p >> 3) ^ (k & 7)) << 4) + (p & 7) * 2);
            else
              *reinterpret_cast<float2*>(dst + (size_t)k * pl.Mp) =
                  *reinterpret_cast<const float2*>(reinterpret_cast<const float*>(A) +
                                                   tp_f32_at(k, p));
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + s);
      }
    }
    return;
  }
  if (warp <= TP_HELPERS) {
    // The streamed A slabs: the helpers' thread p takes point p of every
    // slab (so that each sees every phase of the barriers in order): x or
    // g rows [k0, k0 + KS) of the tile's point.  Three register buffers in
    // turn (the loop unrolled by three, so that no load's register is
    // moved): slab j's values are stored while the loads of j + 1 and j + 2
    // are in flight.  Per slab: wait for the slot, cast into the slab's A
    // part, hand it to the consumers (and the S writer).
    const int p = tid - 32;
    PairCursor c0(pl, blockIdx.x, KS), c1 = c0, c2 = c0;
    c1.next();
    c2.next();
    c2.next();
    float b0[KS], b1[KS], b2[KS];
    auto load = [&](float (&v)[KS], const PairCursor& at) {
      if (!at.valid()) return;
      const PairProd& pr = pl.prod[at.pi];
      if (pr.a == 2) return;
      const bool is_x = pr.a == 0;
      tp_load_row<KS>(v, is_x ? x : static_cast<const void*>(g), !BF16 || !is_x || pl.x_f32, pl.M,
                      is_x ? pl.f_in : pl.Wout, at.ti * TP_TM + p, at.k0);
    };
    int j = 0;
    // Slab j (at c0, its values in v) into its slot; then the cursors move
    // on and the slab three ahead loads into v.
    auto put = [&](float (&v)[KS]) {
      const int s = j % stages;
      uint8_t* A = ring + (size_t)s * TP_STAGE;
      const PairProd& pr = pl.prod[c0.pi];
      mbar_wait(empty + s, ((j / stages) & 1) ^ 1);
      if (pr.a < 2) {
#pragma unroll
        for (int k = 0; k < KS; ++k) {
          const T e = Ty<T>::from_f(v[k]);
          if constexpr (BF16)
            *reinterpret_cast<T*>(A + k * 128 + (((p >> 3) ^ (k & 7)) << 4) + (p & 7) * 2) = e;
          else
            reinterpret_cast<T*>(A)[tp_f32_at(k, p)] = e;
        }
        fence_proxy_async();
      }
      mbar_arrive(afull + s);
      ++j;
      c0 = c1;
      c1 = c2;
      c2.next();
    };
    load(b0, c0);
    load(b1, c1);
    while (c0.valid()) {
      load(b2, c2);
      put(b0);
      if (!c0.valid()) break;
      load(b0, c2);
      put(b1);
      if (!c0.valid()) break;
      load(b1, c2);
      put(b2);
    }
    return;
  }

  // Consumers.  Warpgroup wg; accumulator 32 nb + 4 j + 2 h + c is point 16
  // wi + g + 8 h, column 64 (cb + nb) + 8 j + 2 q + c of the pass (cb its
  // first block).
  const int ct = tid - 128, wg = ct >> 7, wt = ct & 127, wi = wt >> 5;
  const int g8 = lane >> 2, q = lane & 3, bar = 2 + wg;
  float* mypart = part + wg * 4 * TP_PART;
  const uint32_t tile_a = smem_u32(tile);
  float* tile_f = reinterpret_cast<float*>(tile);
  int j = 0;
  for (int ti = blockIdx.x; ti < n_tiles; ti += gridDim.x) {
    const int m0 = ti * TP_TM;
    for (int pi = 0; pi < pl.n_prods; ++pi) {
      const PairProd& pr = pl.prod[pi];
      const int nbw = wg ? pr.nb1 : pr.nb0, nks = (pr.K + KS - 1) / KS;
      for (int ps = 0; ps < pr.passes; ++ps) {
        const int cb = (wg ? pr.nb0 : 0) + ps * PB;
        // One pass, compiled for each count of the warpgroup's blocks (0:
        // it only waits for each slab and releases it).
        auto run = [&](auto nbc_c) {
          constexpr int NBC = decltype(nbc_c)::value;
          float acc[NBC ? 32 * NBC : 1];
#pragma unroll
          for (int i = 0; i < (NBC ? 32 * NBC : 1); ++i) acc[i] = 0.f;
          if constexpr (NBC == 0) {
#pragma unroll 1
            for (int ks = 0; ks < nks; ++ks, ++j) {
              const int s = j % stages;
              mbar_wait(afull + s, (j / stages) & 1);
              mbar_wait(full + s, (j / stages) & 1);
              if (lane == 0) mbar_arrive(empty + s);
            }
          } else if constexpr (BF16) {
            // Per slab two k16 steps; a slab is released once the products
            // of the next have been issued and its own are complete.
            int prev = 0;
#pragma unroll 1
            for (int ks = 0; ks < nks; ++ks, ++j) {
              const int s = j % stages;
              const uint8_t* st = ring + (size_t)s * TP_STAGE;
              mbar_wait(afull + s, (j / stages) & 1);
              mbar_wait(full + s, (j / stages) & 1);
              const uint32_t bb = smem_u32(st + TP_ABYTES) + wg * PB * TP_BOX;
              fence_regs(acc);
              wgmma_fence();
#pragma unroll
              for (int kk = 0; kk < 2; ++kk) {
                const int t = 2 * ks + kk;
                const uint32_t a = pr.a < 2 ? smem_u32(st) + kk * 2048
                                            : tile_a + (t >> 2) * 8192 + (t & 3) * 2048;
                const uint64_t da = sw128_desc(a);
                const uint32_t b = bb + kk * 2048;
                if constexpr (NBC == 4) {
                  wgmma_tt_m64n256(acc, da, sw128_desc(b, TP_BOX), t > 0);
                } else if constexpr (NBC == 3) {
                  wgmma_tt_m64n128(sub<64>(acc, 0), da, sw128_desc(b, TP_BOX), t > 0);
                  wgmma_tt_m64n64(sub<32>(acc, 64), da, sw128_desc(b + 2 * TP_BOX), t > 0);
                } else if constexpr (NBC == 2) {
                  wgmma_tt_m64n128(acc, da, sw128_desc(b, TP_BOX), t > 0);
                } else {
                  wgmma_tt_m64n64(acc, da, sw128_desc(b), t > 0);
                }
              }
              wgmma_commit();
              wgmma_wait1();
              fence_regs(acc);
              if (ks > 0 && lane == 0) mbar_arrive(empty + prev);
              prev = s;
            }
            wgmma_wait0();
            fence_regs(acc);
            if (lane == 0) mbar_arrive(empty + prev);
          } else {
            // 3xTF32 per slab: the A fragments of two k8 steps loaded and
            // split, 6 wgmma, the slab released once they are complete.
            const int p0 = 16 * wi + g8;
#pragma unroll 1
            for (int ks = 0; ks < nks; ++ks, ++j) {
              const int s = j % stages;
              const uint8_t* st = ring + (size_t)s * TP_STAGE;
              mbar_wait(afull + s, (j / stages) & 1);
              const float* src =
                  pr.a < 2 ? reinterpret_cast<const float*>(st) : tile_f + ks * KS * TP_TM;
              uint32_t ah[2][4], al[2][4];
#pragma unroll
              for (int kk = 0; kk < 2; ++kk) {
                const int k = 8 * kk + q;
                split_tf32(src[tp_f32_at(k, p0)], ah[kk][0], al[kk][0]);
                split_tf32(src[tp_f32_at(k, p0 + 8)], ah[kk][1], al[kk][1]);
                split_tf32(src[tp_f32_at(k + 4, p0)], ah[kk][2], al[kk][2]);
                split_tf32(src[tp_f32_at(k + 4, p0 + 8)], ah[kk][3], al[kk][3]);
              }
              mbar_wait(full + s, (j / stages) & 1);
              const uint32_t bh = smem_u32(st + TP_ABYTES) + 2 * wg * PB * TP_BOX;
              const uint32_t bl = bh + PB * TP_BOX;
              fence_regs(acc);
              wgmma_fence();
#pragma unroll
              for (int kk = 0; kk < 2; ++kk) {
                const uint64_t dh = sw64_desc(bh + 32 * kk), dl = sw64_desc(bl + 32 * kk);
                if constexpr (NBC == 2) {
                  wgmma_tf32_m64n128(acc, al[kk], dh, ks > 0 || kk > 0);
                  wgmma_tf32_m64n128(acc, ah[kk], dl, 1);
                  wgmma_tf32_m64n128(acc, ah[kk], dh, 1);
                } else {
                  wgmma_tf32_m64n64(acc, al[kk], dh, ks > 0 || kk > 0);
                  wgmma_tf32_m64n64(acc, ah[kk], dl, 1);
                  wgmma_tf32_m64n64(acc, ah[kk], dh, 1);
                }
              }
              wgmma_commit();
              wgmma_wait0();
              fence_regs(acc);
              if (lane == 0) mbar_arrive(empty + s);
            }
          }

          // Epilogues.  The tile is overwritten (P1) only once both
          // warpgroups are done with the tile before and the stores of its
          // rows have read it.
          if (pr.kind == TP_HIDDEN && ps == 0) {
            if (BF16 && BWD && wt == 0) tma_store_wait_read();
            named_sync(1, 256);
          }
          if constexpr (NBC > 0) {
            // Element 32 nb + 4 jj + 2 hh + c: point r(hh) = 16 wi + g8 + 8 hh,
            // column col = 64 (cb + nb) + 8 jj + 2 q + c.
            auto col_of = [&](int e) { return 64 * cb + 8 * (e >> 2) + 2 * q + (e & 1); };
            auto row_of = [&](int e) { return 16 * wi + g8 + 8 * ((e >> 1) & 1); };
            // bf16: lane 8 k + i's row address in the tile for the 8 x 8
            // blocks of acc[32 nb + 8 jp ..] (points 16 wi + 8 hh.., columns
            // 8 jj..: box rows 8 jj + i, 16-byte chunk (2 wi + hh) ^ i, for
            // matrix k = (hh, jj & 1)), as stmatrix / ldmatrix .trans take it.
            auto box_row = [&](int nb, int jp) {
              const int k = lane >> 3, i = lane & 7, cl = 8 * (2 * jp + (k >> 1)) + i;
              return tile + (cb + nb) * 8192 + cl * 128 + (((2 * wi + (k & 1)) ^ i) << 4);
            };
            // The tile's channel-major values from acc (bf16 transposed by
            // stmatrix).
            auto to_tile = [&]() {
              if constexpr (BF16) {
#pragma unroll
                for (int nb = 0; nb < NBC; ++nb)
#pragma unroll
                  for (int jp = 0; jp < 4; ++jp) {
                    uint8_t* row = box_row(nb, jp);
                    const float* d0 = &acc[32 * nb + 8 * jp];
                    stmatrix_x4_trans(row, pack_bf16(d0[0], d0[1]), pack_bf16(d0[2], d0[3]),
                                      pack_bf16(d0[4], d0[5]), pack_bf16(d0[6], d0[7]));
                  }
              } else {
#pragma unroll
                for (int e = 0; e < 32 * NBC; ++e) tile_f[tp_f32_at(col_of(e), row_of(e))] = acc[e];
              }
            };
            // The pass's rows of the tile out to S rows s_row + its columns.
            auto tile_to_s = [&](int s_row) {
              if constexpr (BF16) {
                fence_proxy_async();
                named_sync(bar, 128);
                if (wt == 0) {
                  for (int nb = 0; nb < NBC; ++nb)
                    tma_store_2d(&pl.s, tile + (cb + nb) * 8192, m0, s_row + 64 * (cb + nb));
                  tma_store_commit();
                }
              } else {
                named_sync(bar, 128);
                for (int v = wt; v < NBC * 64 * 16; v += 128) {
                  const int col = 64 * cb + (v >> 4), p = (v & 15) * 4;
                  *reinterpret_cast<float4*>(static_cast<float*>(S) + (size_t)(s_row + col) * pl.Mp +
                                             m0 + p) =
                      *reinterpret_cast<const float4*>(tile_f + tp_f32_at(col, p));
                }
              }
            };
            if (pr.kind == TP_HIDDEN) {
#pragma unroll
              for (int e = 0; e < 32 * NBC; ++e)
                acc[e] = keep_positive(fmaxf(acc[e] + bias[col_of(e)], 0.f),
                                       static_cast<T*>(nullptr));
              to_tile();
              if constexpr (BWD) tile_to_s(pl.s_h);
            } else if (pr.kind == TP_OUT || pr.kind == TP_DX) {
              const int ncols = pr.kind == TP_OUT ? pl.Wout : pl.f_in;
#pragma unroll
              for (int e = 0; e < 32 * NBC; e += 2) {
                const int m = m0 + row_of(e), col = col_of(e);
                if (m >= pl.M) continue;
                float* o = out + (size_t)m * ncols + col;
                if (col + 1 < ncols && (ncols & 1) == 0) {
                  *reinterpret_cast<float2*>(o) = make_float2(acc[e], acc[e + 1]);
                } else {
                  if (col < ncols) o[0] = acc[e];
                  if (col + 1 < ncols) o[1] = acc[e + 1];
                }
              }
            } else if constexpr (BWD) {
              // dh: the mask from h (> 0 exactly where hpre > 0: ReLU, and
              // keep_positive in bf16), once the stores of h have read the
              // tile; the f32 column sums; dh over h, and out to S.
              if (BF16 && wt == 0) tma_store_wait_read();
              named_sync(bar, 128);
              if constexpr (BF16) {
#pragma unroll
                for (int nb = 0; nb < NBC; ++nb)
#pragma unroll
                  for (int jp = 0; jp < 4; ++jp) {
                    uint32_t r[4];
                    ldmatrix_x4_trans(box_row(nb, jp), r[0], r[1], r[2], r[3]);
                    float* d0 = &acc[32 * nb + 8 * jp];
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                      if ((int16_t)(r[i] & 0xffffu) <= 0) d0[2 * i] = 0.f;
                      if ((int16_t)(r[i] >> 16) <= 0) d0[2 * i + 1] = 0.f;
                    }
                  }
              } else {
#pragma unroll
                for (int e = 0; e < 32 * NBC; ++e)
                  if (!(tile_f[tp_f32_at(col_of(e), row_of(e))] > 0.f)) acc[e] = 0.f;
              }
              // Column sums: the warp's 16 points (a butterfly over the 8
              // lanes of a column pair that leaves lane (g8, q) the sums of
              // n8 block g8), then the warpgroup's 4 warps in order.
#pragma unroll
              for (int nb = 0; nb < NBC; ++nb) {
                float v[16];
#pragma unroll
                for (int jj = 0; jj < 8; ++jj)
#pragma unroll
                  for (int c = 0; c < 2; ++c)
                    v[2 * jj + c] = acc[32 * nb + 4 * jj + c] + acc[32 * nb + 4 * jj + c + 2];
#pragma unroll
                for (int hh = 8, msk = 16; hh >= 2; hh >>= 1, msk >>= 1) {
                  const bool up = lane & msk;
#pragma unroll
                  for (int i = 0; i < hh; ++i) {
                    const float send = up ? v[i] : v[i + hh];
                    v[i] = (up ? v[i + hh] : v[i]) + __shfl_xor_sync(FULL, send, msk);
                  }
                }
                mypart[wi * TP_PART + 64 * nb + 8 * g8 + 2 * q] = v[0];
                mypart[wi * TP_PART + 64 * nb + 8 * g8 + 2 * q + 1] = v[1];
              }
              named_sync(bar, 128);
              for (int c = wt; c < NBC * 64; c += 128)
                dbacc[64 * cb + c] += ((mypart[c] + mypart[TP_PART + c]) + mypart[2 * TP_PART + c]) +
                                      mypart[3 * TP_PART + c];
              to_tile();
              tile_to_s(pl.s_dh);
            }
          }
        };
        const int nbc = min(PB, max(0, nbw - ps * PB));
        if (nbc == 0) {
          run(std::integral_constant<int, 0>());
        } else if constexpr (BF16) {
          if (nbc == 4)
            run(std::integral_constant<int, 4>());
          else if (nbc == 3)
            run(std::integral_constant<int, 3>());
          else if (nbc == 2)
            run(std::integral_constant<int, 2>());
          else
            run(std::integral_constant<int, 1>());
        } else {
          if (nbc == 2)
            run(std::integral_constant<int, 2>());
          else
            run(std::integral_constant<int, 1>());
        }
      }
      // The next product reads the whole tile (P2 h, P4 dh).
      if (pr.kind == TP_HIDDEN || pr.kind == TP_DH) {
        if (BF16) fence_proxy_async();
        named_sync(1, 256);
      }
    }
  }
  if constexpr (BWD) {
    if (BF16 && wt == 0) tma_store_wait();
    named_sync(1, 256);
    for (int c = ct; c < pl.Wl; c += 256) db_part[(size_t)blockIdx.x * pl.Wl + c] = dbacc[c];
  }
}

// The B operands of the products, by product: P1 Wcol, P2 Wrow, P3 Wrow^T,
// P4 Wcol^T.  bf16: the compute-dtype matrices [K][N] as stored (wc [f_in]
// [Wl], wr [Wl][Wout], wrT [Wout][Wl], wcT [Wl][Fp]); f32: the split
// transposed [2 Np][Kc] f32 (hi rows, then lo rows; Np = N rounded up to 64
// with zero rows, Kc = K rounded up to 16 with zero columns).
struct PairB {
  const void* p[4];
};

// The plan of the forward (P1, P2) or the chain (P1, P3, P4) for M rows
// (Mp = M rounded up to 64), the chain's stream S [Fp + 2 Wl + Wout][Mp]:
// false where the route does not take the shape or a tensor map cannot be
// made.
template <bool BF16>
inline bool pair_wg_plan(PairPlan& pl, const PairB& B, int M, int Mp, int f_in, int Wl, int Wout,
                         int x_f32, bool bwd, const void* S) {
  constexpr int PB = TpCfg<BF16>::PB;
  if (!pair_wg_route(f_in, Wl, Wout, BF16) || Mp % TP_TM || M < 1 || Mp < M) return false;
  const int Fp = enc_rows(f_in), Kp1 = (f_in + 15) & ~15;
  bool ok = true;
  int n = 0;
  // A product of depth K and N outputs, B of Kc columns (f32) or rows of
  // Nc columns (bf16).
  auto add = [&](int bi, int K, int N, int Kc, int Nc, int a, int kind) {
    const int NB = (N + 63) / 64;
    PairProd& pr = pl.prod[n];
    pr.map = n;
    pr.K = K;
    pr.nb0 = (NB + 1) / 2;
    pr.nb1 = NB / 2;
    pr.passes = (pr.nb0 + PB - 1) / PB;
    pr.a = a;
    pr.kind = kind;
    pr.Np = 64 * NB;
    ok = ok && B.p[bi] &&
         (BF16 ? make_map(&pl.w[n], B.p[bi], K, Nc, Nc, 32)
               : make_map(&pl.w[n], B.p[bi], 2 * pr.Np, Kc, Kc, 64, CU_TENSOR_MAP_SWIZZLE_64B, true,
                          16));
    ++n;
  };
  add(0, f_in, Wl, Kp1, Wl, 0, TP_HIDDEN);
  if (bwd) {
    add(2, Wout, Wl, Wout, Wl, 1, TP_DH);
    add(3, Wl, f_in, Wl, Fp, 2, TP_DX);
  } else {
    add(1, Wl, Wout, Wl, Wout, 2, TP_OUT);
  }
  pl.n_prods = n;
  pl.stages = pair_wg_stages(BF16, Wl);
  pl.M = M;
  pl.Mp = Mp;
  pl.f_in = f_in;
  pl.Fp = Fp;
  pl.Wl = Wl;
  pl.Wout = Wout;
  pl.x_f32 = x_f32;
  pl.s_x = 0;
  pl.s_h = Fp;
  pl.s_g = Fp + Wl;
  pl.s_dh = Fp + Wl + Wout;
  if (bwd && BF16) ok = ok && S && make_map(&pl.s, S, Fp + 2 * Wl + Wout, Mp, Mp, 64);
  return ok && (!bwd || S);
}

// One launch on the planned forward (out [M][Wout]) or chain (dx [M][f_in],
// S, db_part [blocks][Wl]), `blocks` persistent blocks; 0 or a cudaError_t.
template <bool BF16, bool BWD>
int launch_pair_wg(const PairPlan& pl, int blocks, const void* x, const float* g, const float* bc,
                   float* out, void* S, float* db_part, cudaStream_t s) {
  const size_t smem = pair_wg_smem(BF16, pl.Wl, pl.stages);
  cudaError_t e = cudaFuncSetAttribute(tp_pair_wg_kernel<BF16, BWD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  tp_pair_wg_kernel<BF16, BWD><<<blocks, TP_THREADS, smem, s>>>(pl, x, g, bc, out, S, db_part);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++(BF16 ? g_pair_sm90_launches : g_pair_tf32_launches);
  return (int)e;
}

}  // namespace
