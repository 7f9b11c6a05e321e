// Tensor-core bodies of the bf16 3x3 convolution kernels (stride 1, pad 1)
// for Hopper (sm_90a): the forward #11 (fcbn_fwd_tc_kernel), the input
// gradient #12 (fcbn_bwd_dx_tc_kernel, the forward's product with dY and
// flip(w)^T) and the weight gradient #13 (fcbn_bwd_dw_tc_kernel) of
// fused_conv_bn.cu, on the wgmma building blocks of sm90.cuh.
// fused_conv_bn.cu's note gives what they compute, what bounds them and
// why the design is this one. bn1's prologue, dY's terms, dx's epilogue
// and the host's tensor maps live in bn_tc.cuh, shared with the 1x1
// kernels (#8-#10).
//
// The halo slab. A tile of T output pixels p0 .. p0 + T - 1 (rows of the
// (M, C) channels-last matrix) reads, through its nine taps, the rows
// p0 + r + (ty - 1) W + (tx - 1). The slab holds them once, 64 channels a
// row (one 128-byte row, swizzled as sm90.cuh's tiles), with bn1's
// prologue applied in place once per slab row: tap (ty, tx) of tile row r
// is slab row r + ty * rowstep + tx. With rowstep = W the slab is the
// contiguous run from p0 - W - 1 (2 W + T + 2 rows); an image so wide that
// three runs of T + 2 rows are shorter takes one run per tap row, from p0
// + (ty - 1) W - 1, rowstep apart. Runs are copied by TMA in boxes of BOXR
// rows (so a slab may hold a few rows more than it needs). A tap leaves
// the image where its pixel's (h + ty - 1, w + tx - 1) does; rows outside
// [0, M) arrive as zeros, but prologue(0) != 0 (and dY(0) = ds != 0), so
// the product masks such taps itself: tap_mask gives each pixel's nine in-image bits, computed
// once per tile.
//
// Loads. Every tile (slab runs, weight tiles, dy and y) is copied by TMA:
// one thread arms the stage's mbarrier with the bytes and issues the boxes,
// so no compute warp stalls issuing per-thread copies, and the boxes land
// 128-byte-swizzled, the layout swz() reads and wgmma's descriptors
// describe. A stage is refilled only after a block barrier that follows
// every reader's last use (and a proxy fence after generic writes).
//
// The shifted operand. wgmma reads B through a descriptor whose 8-row
// swizzle atoms must stay whole, so a tap's row shift, which is any
// integer, never moves a descriptor: the slab side of each product is the
// register operand (ldmatrix takes any 16-byte row address), and the
// masked taps are zeroed in registers.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "bn_tc.cuh"
#include "sm90.cuh"

namespace conv3 {

using bf16 = __nv_bfloat16;
using bntc::AFFINE;
using bntc::AFFINE_RELU;
using bntc::Affine;
using bntc::DyTerms;
using bntc::NONE;
using bntc::ROW;  // bytes of a slab or tile row: 64 channels
using bntc::apply_prologue;
using bntc::round_up;
using bntc::swz;

constexpr int BOXR = 64;          // rows of one TMA box of a slab
constexpr int LA = 3;             // forward: weight tiles loaded ahead
constexpr int NBUF = LA + 1;      //          weight tiles in the ring
constexpr int FWD_THREADS = 256;  // two warpgroups
constexpr int DW_THREADS = 384;   // three: one per tap row
constexpr int DW_T = 128;         // dw: pixels a tile
constexpr int RED_BYTES = 8 * 2 * 64 * 8;  // forward: per-warp column sums
constexpr int BAR_BYTES = 64;     // mbarriers: 2 slab stages, NBUF weights,
                                  // dx's x tile
constexpr int SMEM_LIMIT = 232448;

struct Slab {
  int rowstep;  // slab rows between two tap rows
  int rows;     // rows the slab holds: runs * run
  int runs;     // 1: one run from p0 - W - 1; 3: one per tap row
  int run;      // rows of a run, a multiple of BOXR
};

__host__ inline Slab make_slab(int T, int W) {
  Slab s;
  const int one = round_up(2 * W + T + 2, BOXR);
  const int each = round_up(T + 2, BOXR);
  if (one <= 3 * each) {
    s.rowstep = W;
    s.runs = 1;
    s.run = one;
  } else {
    s.rowstep = each;
    s.runs = 3;
    s.run = each;
  }
  s.rows = s.runs * s.run;
  return s;
}

// Issues the TMA boxes of the slab of the tile at pixel p0, channels c0 ..
// c0 + 63 of the (M, C) tensor map `map`, into dst, on mbarrier bar (armed
// by the caller with rows * ROW bytes): box i by lane i % 32 of the calling
// warp.
__device__ __forceinline__ void load_slab(uint32_t dst, const void* map,
                                          int c0, const Slab& s, long long p0,
                                          int W, uint32_t bar, int lane) {
  const int per_run = s.run / BOXR;
  for (int i = lane; i < s.runs * per_run; i += 32) {
    const int k = i / per_run, b = (i - k * per_run) * BOXR;
    const long long g0 =
        s.runs == 1 ? p0 - W - 1 : p0 + static_cast<long long>(k - 1) * W - 1;
    sm90::tma_load_2d(dst + (k * s.rowstep + b) * ROW, map, c0,
                      static_cast<int>(g0 + b), bar);
  }
}

// Division of n < 2^31 by a fixed d >= 1 as a multiply-high and a shift
// (Granlund and Montgomery), set up on the host.
struct FastDiv {
  uint32_t d, mult, shift;
};

__host__ inline FastDiv make_div(uint32_t d) {
  FastDiv f{d, 0u, 0u};
  while ((1ull << f.shift) < d) ++f.shift;
  f.mult = static_cast<uint32_t>(((1ull << 32) * ((1ull << f.shift) - d)) / d +
                                 1);
  return f;
}

__device__ __forceinline__ uint32_t div(uint32_t n, const FastDiv& f) {
  return (__umulhi(n, f.mult) + n) >> f.shift;
}

// Bit 3 ty + tx: tap (ty, tx) of pixel m stays inside m's image.
__device__ __forceinline__ uint32_t tap_mask(long long m, long long M,
                                             const FastDiv& H,
                                             const FastDiv& W) {
  if (m >= M) return 0u;
  const uint32_t mi = static_cast<uint32_t>(m);
  const uint32_t q = div(mi, W), w = mi - q * W.d, h = q - div(q, H) * H.d;
  const uint32_t cols = 2u | (w > 0 ? 1u : 0u) | (w + 1 < W.d ? 4u : 0u);
  uint32_t bits = cols << 3;
  if (h > 0) bits |= cols;
  if (h + 1 < H.d) bits |= cols << 6;
  return bits;
}

// ---------------------------------------------------------------------------
// #11: y = conv3x3(a, w), the column sums of y as stored
// ---------------------------------------------------------------------------

struct FwdArgs {
  const bf16* x;
  const bf16* w;  // (Cout, 3, 3, Cin)
  const float* mu;
  const float* inv;
  const float* gamma;
  const float* beta;
  bf16* y;
  double* part;  // (2, splits, Cout)
  long long M;
  int H, W, Cin, Cout;
  FastDiv divH, divW;
  int nc;      // 64-channel chunks of Cin
  int per;     // pixel tiles a block
  int splits;  // blocks along M
  int prologue;
  Slab slab;
  int slab_bytes;  // one slab stage, a multiple of 1024
};

// Shared memory of the forward's (MT, NB, RES) instance for a slab: the
// weight tiles (all nine of the one chunk, or a ring), two slab stages (the
// free one also stages the epilogue's T x 64 tile of y), the column-sum
// scratch and the mbarriers, plus slack to align to 1024.
__host__ inline int fwd_slab_bytes(const Slab& s) {
  return round_up(s.rows * ROW, 1024);
}
__host__ inline int fwd_smem(int NB, bool res, int slab_bytes) {
  return 1024 + (res ? 9 : NBUF) * NB * 64 * ROW + 2 * slab_bytes +
         RED_BYTES + BAR_BYTES;
}

// The products of NT consecutive taps (from tap0) for one warpgroup:
// acc[mt][nb] += A . B, A the warpgroup's 64 MT rows of the slab shifted
// by the tap, taken by ldmatrix and masked per row, B the tap's weight
// tile: NB blocks of 64 output channels, each 64 x 64 (tap tap0 + i at bt +
// i tiles), K-major (TRANS 0: the forward's w rows, one an output channel)
// or MN-major (TRANS 1: dx's, one a contracted channel). One software
// pipeline: batch b + 1's fragments load while batch b's products run, two
// register buffers taking turns, each pinned until the products that read
// it are done. A batch is KSB 16-channel steps, so a buffer holds 4 MT KSB
// registers (KSB 1 where MT NB = 4).
template <int MT, int NB, int NT, int TRANS = 0>
__device__ __forceinline__ void fwd_taps(float (&acc)[MT][NB][32],
                                         uint32_t slab, uint32_t bt,
                                         int row0, int rowstep,
                                         const uint32_t (&vm)[MT][2],
                                         int tap0, int lane) {
  using namespace sm90;
  constexpr int KSB = MT * NB <= 2 ? 2 : 1;
  constexpr int PER = 4 / KSB;  // batches a tap
  uint32_t fa[2][KSB][MT][4];
  auto prep = [&](int b, uint32_t (&f)[KSB][MT][4]) {
    const int tap = tap0 + b / PER, kb = (b % PER) * KSB;
    const int ty = tap / 3, shift = ty * rowstep + tap - 3 * ty;
#pragma unroll
    for (int u = 0; u < KSB; ++u)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = row0 + mt * 64 + (lane & 7) + ((lane >> 3) & 1) * 8 +
                      shift;
        ldsm_x4(slab + swz(r, 2 * (kb + u) + (lane >> 4)), f[u][mt]);
        const uint32_t m0 = 0u - ((vm[mt][0] >> tap) & 1u);
        const uint32_t m1 = 0u - ((vm[mt][1] >> tap) & 1u);
        f[u][mt][0] &= m0;
        f[u][mt][2] &= m0;
        f[u][mt][1] &= m1;
        f[u][mt][3] &= m1;
      }
  };
  auto pin = [&](uint32_t (&f)[KSB][MT][4]) {
#pragma unroll
    for (int u = 0; u < KSB; ++u)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) fence_regs(f[u][mt]);
  };
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(acc[mt][nb]);
  prep(0, fa[0]);
#pragma unroll
  for (int b = 0; b < NT * PER; ++b) {
    const int i = b / PER, kb = (b % PER) * KSB;
    pin(fa[b & 1]);
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < KSB; ++u)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          mma_rs<TRANS>(
              acc[mt][nb], fa[b & 1][u][mt][0], fa[b & 1][u][mt][1],
              fa[b & 1][u][mt][2], fa[b & 1][u][mt][3],
              TRANS ? desc_mn<64>(bt + (i * NB + nb) * 64 * ROW, kb + u, 0)
                    : desc_k<64>(bt + (i * NB + nb) * 64 * ROW, kb + u),
              1);
    wgmma_commit();
    wgmma_wait<1>();  // batch b - 1 is done: its buffer may be refilled
    pin(fa[(b + 1) & 1]);
    if (b + 1 < NT * PER) prep(b + 1, fa[(b + 1) & 1]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(acc[mt][nb]);
  pin(fa[0]);
  pin(fa[1]);
}

// Block (blockIdx.x: run of pixel tiles, blockIdx.y: NB * 64 output
// channels) of the forward. Two warpgroups own 64 MT rows each of a T =
// 128 MT-pixel tile. Steps run over (tile, 64-channel chunk kc, tap); the
// weight tile of each step is resident (RES: Cin <= 64, Cout <= 64, all
// nine loaded once) or streamed LA steps ahead through an NBUF ring; the
// next chunk's slab is copied into the other slab stage at this chunk's
// first tap. xmap: x as (M, Cin), boxes of 64 channels x BOXR rows; wmap:
// w as (Cout, 9, Cin), boxes of 64 channels x 1 tap x NB * 64 rows; ymap: y
// as (M, Cout), boxes of 64 channels x T rows, for the stores.
template <int MT, int NB, bool RES>
__global__ void __launch_bounds__(FWD_THREADS, 1)
fcbn_fwd_tc_kernel(const FwdArgs a, const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap,
                   const __grid_constant__ CUtensorMap ymap) {
  using namespace sm90;
  constexpr int T = 128 * MT;
  constexpr uint32_t BT = NB * 64 * ROW;  // bytes of one weight tile
  constexpr int BSLOTS = RES ? 9 : NBUF;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sb = (raw + 1023u) & ~1023u;
  const uint32_t ss = sb + BSLOTS * BT;
  const uint32_t sred = ss + 2 * a.slab_bytes;
  const uint32_t sbar = sred + RED_BYTES;  // slab stages 0, 1; weights
  double* red = reinterpret_cast<double*>(smem_raw + (sred - raw));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = (tid >> 7) * 64 * MT + (warp & 3) * 16;
  const int n0 = blockIdx.y * NB * 64;
  const int split = blockIdx.x;
  const long long tiles = (a.M + T - 1) / T;
  const long long tb = static_cast<long long>(split) * a.per;
  const long long te = tb + a.per < tiles ? tb + a.per : tiles;
  const int nc = a.nc;
  const int chunks = te > tb ? static_cast<int>(te - tb) * nc : 0;
  const int steps = chunks * 9;
  const bool relu = a.prologue == AFFINE_RELU;

  // Issued by warp 0: load_w by lane 0, load_chunk by the whole warp.
  auto load_w = [&](int slot, int kc, int tap, uint32_t bar) {
    tma_load_3d(sb + slot * BT, &wmap, kc * 64, tap, n0, bar);
  };
  auto load_chunk = [&](int stage, long long tile, int kc) {
    const uint32_t bar = sbar + 8 * stage;
    if (lane == 0) mbar_expect_tx(bar, a.slab.rows * ROW);
    __syncwarp();
    load_slab(ss + stage * a.slab_bytes, &xmap, kc * 64, a.slab, tile * T,
              a.W, bar, lane);
  };

  if (tid == 0) {
    prefetch_tensormap(&xmap);
    prefetch_tensormap(&wmap);
    prefetch_tensormap(&ymap);
    for (int i = 0; i < 2 + NBUF; ++i) mbar_init(sbar + 8 * i, 1);
    fence_mbar_init();
  }
  __syncthreads();
  // The first slab, and the weight tiles of steps 0 .. LA - 1 (all nine,
  // on the first weight barrier, when resident).
  if (warp == 0 && steps > 0) load_chunk(0, tb, 0);
  if (tid == 0 && steps > 0) {
    if (RES) {
      mbar_expect_tx(sbar + 16, 9 * BT);
      for (int t = 0; t < 9; ++t) load_w(t, 0, t, sbar + 16);
    } else {
      for (int s = 0; s < LA && s < steps; ++s) {
        mbar_expect_tx(sbar + 16 + 8 * s, BT);
        load_w(s, 0, s, sbar + 16 + 8 * s);
      }
    }
  }
  // The step whose weight tile loads next: (chunk l_kc, tap l_tap).
  int l_kc = 0, l_tap = LA;

  double total[NB];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) total[nb] = 0.0;
  Affine af;
  uint32_t vm[MT][2];
  float acc[MT][NB][32];
  int q = 0;  // the block's chunk index
  for (long long tile = tb; tile < te; ++tile) {
    const long long p0 = tile * T;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        vm[mt][h] = tap_mask(p0 + row0 + mt * 64 + (lane >> 2) + 8 * h, a.M,
                             a.divH, a.divW);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[mt][nb][i] = 0.f;
    uint32_t slab = 0;
    for (int kc = 0; kc < nc; ++kc, ++q) {
      const int stage = q & 1;
      slab = ss + stage * a.slab_bytes;
      if (a.prologue != NONE && (!RES || q == 0))
        af.load(a.mu, a.inv, a.gamma, a.beta, kc * 64 + 8 * (tid & 7), a.Cin);
      for (int tap = 0; tap < 9; ++tap) {
        const int j = q * 9 + tap;
        if (!RES || tap == 0) {
          // Every reader of step j - 1 is done: its weight slot and, at
          // tap 0, the other slab stage (chunk q - 1, then the epilogue's
          // staging) may be refilled.
          fence_async_shared();
          __syncthreads();
          if (tid == 0 && !RES && j + LA < steps) {
            const uint32_t bar = sbar + 16 + 8 * ((j + LA) % NBUF);
            mbar_expect_tx(bar, BT);
            load_w((j + LA) % NBUF, l_kc, l_tap, bar);
          }
          if (warp == 0 && tap == 0 && q + 1 < chunks) {
            const bool wrap = kc + 1 == nc;
            load_chunk(stage ^ 1, wrap ? tile + 1 : tile, wrap ? 0 : kc + 1);
          }
          if (!RES && ++l_tap == 9) {
            l_tap = 0;
            if (++l_kc == nc) l_kc = 0;
          }
        }
        if (tap == 0) {
          mbar_wait(sbar + 8 * stage, (q >> 1) & 1);
          if (a.prologue != NONE) {
            apply_prologue(slab, a.slab.rows, af, relu, tid, FWD_THREADS);
            __syncthreads();
          }
        }
        if (RES) {
          if (j == 0) mbar_wait(sbar + 16, 0);
          fwd_taps<MT, NB, 9>(acc, slab, sb, row0, a.slab.rowstep, vm, 0,
                              lane);
          break;  // the nine taps of the chunk in one pipeline
        }
        mbar_wait(sbar + 16 + 8 * (j % NBUF), (j / NBUF) & 1);
        fwd_taps<MT, NB, 1>(acc, slab, sb + (j % NBUF) * BT, row0,
                            a.slab.rowstep, vm, tap, lane);
      }
    }

    // Epilogue, 64 columns at a time through the free slab stage: y
    // rounded to bf16 into a swizzled T x 64 tile, out by one TMA store
    // (rows past M and columns past Cout are not written), and the
    // columns' sums of y and y^2 as stored, in double, in a fixed order.
    __syncthreads();
    const int rmax = a.M - p0 < T ? static_cast<int>(a.M - p0) : T;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int r = row0 + mt * 64 + (lane >> 2) + 8 * ((i >> 1) & 1);
          sts32(slab + swz(r, i >> 2) + 4 * (lane & 3),
                pack_bf16(acc[mt][nb][i], acc[mt][nb][i + 1]));
        }
      fence_async_shared();
      __syncthreads();
      if (tid == 0) {
        tma_store_2d(&ymap, slab, n0 + nb * 64, static_cast<int>(p0));
        bulk_commit();
      }
      const unsigned char* stg = smem_raw + (slab - raw);
      // Rows warp + 8 i in four interleaved partials (i % 4), added in a
      // fixed order; a whole tile unrolled.
      double ps[4][2] = {}, pq[4][2] = {};
      auto add = [&](int r, int u) {
        const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
            stg + swz(r, lane >> 2) + 4 * (lane & 3));
        const float2 f = __bfloat1622float2(v);
        const double x0 = f.x, x1 = f.y;
        ps[u][0] += x0;
        ps[u][1] += x1;
        pq[u][0] += x0 * x0;
        pq[u][1] += x1 * x1;
      };
      if (rmax == T) {
#pragma unroll
        for (int k = 0; k < T / 8; ++k) add(warp + 8 * k, k & 3);
      } else {
        for (int r0 = warp; r0 < rmax; r0 += 32)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (r0 + 8 * u < rmax) add(r0 + 8 * u, u);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        red[(warp * 2) * 64 + 2 * lane + e] =
            ((ps[0][e] + ps[1][e]) + ps[2][e]) + ps[3][e];
        red[(warp * 2 + 1) * 64 + 2 * lane + e] =
            ((pq[0][e] + pq[1][e]) + pq[2][e]) + pq[3][e];
      }
      if (tid == 0) bulk_wait_read<0>();  // the tile may be overwritten
      __syncthreads();
      if (tid < 128) {
        const int which = tid >> 6, col = tid & 63;
        double t = 0.0;
#pragma unroll
        for (int g = 0; g < 8; ++g) t += red[(g * 2 + which) * 64 + col];
        total[nb] += t;
      }
    }
  }
  if (tid == 0) bulk_wait<0>();
  if (tid < 128) {
    const int which = tid >> 6, col = tid & 63;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int n = n0 + nb * 64 + col;
      if (n < a.Cout)
        a.part[(static_cast<long long>(which) * a.splits + split) * a.Cout +
               n] = total[nb];
    }
  }
}

// ---------------------------------------------------------------------------
// #12: da = conv3x3(dY, flip(w)^T); with bn, dx, dbeta and dgamma through
// bn1's prologue
// ---------------------------------------------------------------------------

constexpr int DX_T = 128;  // dx: pixels a tile, 64 a warpgroup

struct DxArgs {
  const float* mu;  // bn1's vectors over Cin: the epilogue's mask and scale
  const float* inv;
  const float* gamma;
  const float* beta;
  const float* ds;  // dY's terms over Cout
  const float* dss;
  double* part;  // (2, splits, Cin): dbeta, dgamma
  long long M;
  int H, W, Cin, Cout;
  FastDiv divH, divW;
  int nc;      // 64-channel chunks of Cout
  int per;     // pixel tiles a block
  int splits;  // blocks along M
  int bn, relu;
  int stages;  // slab stages: 2, or 1 where two do not fit
  Slab slab;
  int slab_bytes;  // one slab (of dy or of y), a multiple of 1024
};

// Shared memory of dx's (NB, RES) instance: the weight tiles (the nine of
// the one chunk, or a ring), `stages` stages of a dy slab (dY once formed)
// and a y slab, whose two slabs also stage the epilogue's output blocks,
// x's tile (NB blocks of DX_T x 64), the epilogue's constants and the
// mbarriers, plus slack to align to 1024.
__host__ inline int dx_smem(int NB, bool res, int stages, int slab_bytes) {
  return 1024 + (res ? 9 : NBUF) * NB * 64 * ROW + stages * 2 * slab_bytes +
         NB * DX_T * ROW + bntc::NCONST * 64 * NB * 4 + BAR_BYTES;
}

// Block (blockIdx.x: run of pixel tiles, blockIdx.y: NB * 64 input
// channels from c0) of dx: the forward's implicit GEMM with dY for a and
// flip(w)^T for w. Two warpgroups own 64 rows each of a DX_T-pixel tile.
// Steps run over (tile, 64-channel chunk kc of Cout, tap). A chunk's dy and
// y slabs arrive by TMA into one stage, and dY = dy + ds + 2 y dss is
// formed once, rounded to bf16, in place of dy (rows outside [0, M) take
// ds, but every tap that reads them is masked). Tap t's B is w[n][8 - t][c]
// over the chunk's n: per 64-column block one TMA box of 64 c x 64 n, read
// MN-major (its rows are the contracted n), resident (RES: Cin, Cout <= 64,
// all nine loaded once) or streamed LA steps ahead through an NBUF ring.
// The next chunk's slabs load into the other stage at this chunk's first
// tap (with one stage, at the next chunk's, once this one's readers are
// done), and x's tile of the block's columns at each tile's first. The
// epilogue (bn_tc.cuh's dx_block) stages block nb of dx in slab nb of the
// free stage, out by TMA store, and runs each warp's dbeta and dgamma on in
// registers over the block's tiles. dymap, ymap: dy and y as (M, Cout),
// boxes of 64 channels x BOXR rows; wmap: w as (Cout, 9, Cin), boxes of 64
// channels x 1 tap x 64 rows; xmap, dxmap: x and dx as (M, Cin), boxes of
// 64 channels x DX_T rows.
template <int NB, bool RES>
__global__ void __launch_bounds__(FWD_THREADS, 1)
fcbn_bwd_dx_tc_kernel(const DxArgs a,
                      const __grid_constant__ CUtensorMap dymap,
                      const __grid_constant__ CUtensorMap ymap,
                      const __grid_constant__ CUtensorMap wmap,
                      const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap dxmap) {
  using namespace sm90;
  constexpr int T = DX_T;
  constexpr int QC = 64 * NB;
  constexpr uint32_t BT = 64 * ROW;  // one 64 x 64 weight box
  constexpr uint32_t BS = NB * BT;   // the weight tile of one step
  constexpr uint32_t TB = T * ROW;   // one 64-channel block of a tile
  constexpr int BSLOTS = RES ? 9 : NBUF;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sb = (raw + 1023u) & ~1023u;
  const uint32_t stage_bytes = 2 * a.slab_bytes;
  const uint32_t ss = sb + BSLOTS * BS;
  const uint32_t sx = ss + a.stages * stage_bytes;
  const uint32_t sconst = sx + NB * TB;
  // mbarriers: slab stages 0, 1; weight slots; x's tile.
  const uint32_t sbar = sconst + bntc::NCONST * QC * 4;
  const uint32_t xbar = sbar + 8 * (2 + NBUF);
  float* cst = reinterpret_cast<float*>(smem_raw + (sconst - raw));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = (tid >> 7) * 64 + (warp & 3) * 16;  // the warp's rows
  const int r0 = row0 + (lane >> 2);  // the thread's: r0 and r0 + 8
  const int c0 = blockIdx.y * QC;
  const int split = blockIdx.x;
  const long long tiles = (a.M + T - 1) / T;
  const long long tb = static_cast<long long>(split) * a.per;
  const long long te = tb + a.per < tiles ? tb + a.per : tiles;
  const int nc = a.nc, S = a.stages;
  const int chunks = te > tb ? static_cast<int>(te - tb) * nc : 0;
  const int steps = chunks * 9;
  const bool bn = a.bn != 0, relu = a.relu != 0;

  // Issued by warp 0: load_w by lane 0, load_chunk by the whole warp.
  auto load_w = [&](int slot, int kc, int tap, uint32_t bar) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      tma_load_3d(sb + slot * BS + nb * BT, &wmap, c0 + 64 * nb, 8 - tap,
                  kc * 64, bar);
  };
  auto load_chunk = [&](int q) {  // the block's chunk q, into stage q % S
    const int stage = q % S, kc = q % nc;
    const long long p0 = (tb + q / nc) * T;
    const uint32_t dst = ss + stage * stage_bytes, bar = sbar + 8 * stage;
    if (lane == 0) mbar_expect_tx(bar, 2 * a.slab.rows * ROW);
    __syncwarp();
    load_slab(dst, &dymap, kc * 64, a.slab, p0, a.W, bar, lane);
    load_slab(dst + a.slab_bytes, &ymap, kc * 64, a.slab, p0, a.W, bar,
              lane);
  };

  if (tid == 0) {
    prefetch_tensormap(&dymap);
    prefetch_tensormap(&ymap);
    prefetch_tensormap(&wmap);
    prefetch_tensormap(&dxmap);
    if (bn) prefetch_tensormap(&xmap);
    for (int i = 0; i < 3 + NBUF; ++i) mbar_init(sbar + 8 * i, 1);
    fence_mbar_init();
  }
  if (bn)
    bntc::load_dx_consts(cst, a.mu, a.inv, a.gamma, a.beta, c0, a.Cin, QC,
                         tid, FWD_THREADS);
  __syncthreads();
  // With two stages the first chunk's slabs; the weight tiles of steps 0
  // .. LA - 1 (all nine, on the first weight barrier, when resident).
  if (warp == 0 && S == 2 && chunks > 0) load_chunk(0);
  if (tid == 0 && steps > 0) {
    if (RES) {
      mbar_expect_tx(sbar + 16, 9 * BS);
      for (int t = 0; t < 9; ++t) load_w(t, 0, t, sbar + 16);
    } else {
      for (int s = 0; s < LA && s < steps; ++s) {
        mbar_expect_tx(sbar + 16 + 8 * s, BS);
        load_w(s, 0, s, sbar + 16 + 8 * s);
      }
    }
  }
  // The step whose weight tile loads next: (chunk l_kc, tap l_tap).
  int l_kc = 0, l_tap = LA;

  double tot[2][NB][2];
#pragma unroll
  for (int w = 0; w < 2; ++w)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) tot[w][nb][0] = tot[w][nb][1] = 0.0;
  DyTerms dyt;
  uint32_t vm[1][2];
  float acc[1][NB][32];
  int q = 0;  // the block's chunk index
  for (long long tile = tb; tile < te; ++tile) {
    const long long p0 = tile * T;
    const int it = static_cast<int>(tile - tb);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      vm[0][h] = tap_mask(p0 + r0 + 8 * h, a.M, a.divH, a.divW);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[0][nb][i] = 0.f;
    uint32_t slab = 0;
    for (int kc = 0; kc < nc; ++kc, ++q) {
      const int stage = S == 2 ? (q & 1) : 0;
      slab = ss + stage * stage_bytes;
      if (nc > 1 || q == 0)
        dyt.load(a.ds, a.dss, kc * 64 + 8 * (tid & 7), a.Cout);
      for (int tap = 0; tap < 9; ++tap) {
        const int j = q * 9 + tap;
        if (!RES || tap == 0) {
          // Every reader of step j - 1 is done: its weight slot and, at
          // tap 0, the stage that chunk q + S - 1 takes (chunk q - 1's,
          // whose slabs staged the last epilogue's dx: tid 0 waits for
          // those stores to have read them) and x's tile may be refilled.
          if (tap == 0 && tid == 0) bulk_wait_read<0>();
          fence_async_shared();
          __syncthreads();
          if (tid == 0 && !RES && j + LA < steps) {
            const uint32_t bar = sbar + 16 + 8 * ((j + LA) % NBUF);
            mbar_expect_tx(bar, BS);
            load_w((j + LA) % NBUF, l_kc, l_tap, bar);
          }
          if (tap == 0) {
            if (warp == 0 && q + S - 1 < chunks) load_chunk(q + S - 1);
            if (tid == 0 && bn && kc == 0) {
              mbar_expect_tx(xbar, NB * TB);
#pragma unroll
              for (int nb = 0; nb < NB; ++nb)
                tma_load_2d(sx + nb * TB, &xmap, c0 + 64 * nb,
                            static_cast<int>(p0), xbar);
            }
          }
          if (!RES && ++l_tap == 9) {
            l_tap = 0;
            if (++l_kc == nc) l_kc = 0;
          }
        }
        if (tap == 0) {
          mbar_wait(sbar + 8 * stage, (q / S) & 1);
          bntc::apply_dy(slab, slab + a.slab_bytes, a.slab.rows, dyt, tid,
                         FWD_THREADS);
          __syncthreads();
        }
        if (RES) {
          if (j == 0) mbar_wait(sbar + 16, 0);
          fwd_taps<1, NB, 9, 1>(acc, slab, sb, row0, a.slab.rowstep, vm, 0,
                                lane);
          break;  // the nine taps of the chunk in one pipeline
        }
        mbar_wait(sbar + 16 + 8 * (j % NBUF), (j / NBUF) & 1);
        fwd_taps<1, NB, 1, 1>(acc, slab, sb + (j % NBUF) * BS, row0,
                              a.slab.rowstep, vm, tap, lane);
      }
    }

    // Epilogue: every product of the tile is done, so the stage is free.
    // Block nb of dx (masked, scaled and summed with bn) rounded to bf16
    // into the stage's slab nb, out by TMA store (rows past M and columns
    // past Cin are not written); x's tile has landed by now.
    __syncthreads();
    if (bn) mbar_wait(xbar, it & 1);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      double sums[2][2];
      bntc::dx_block(acc[0][nb], 0, sx + nb * TB, slab + nb * a.slab_bytes,
                     cst + nb * 64, QC, r0, lane, bn, relu, sums);
      if (bn)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          tot[0][nb][h] += sums[0][h];
          tot[1][nb][h] += sums[1][h];
        }
    }
    fence_async_shared();
    __syncthreads();
    if (tid == 0) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        tma_store_2d(&dxmap, slab + nb * a.slab_bytes, c0 + 64 * nb,
                     static_cast<int>(p0));
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait<0>();
  // Every copy into the stages has landed and been read, every store has
  // completed: stage 0 holds the warps' sums.
  if (bn)
    bntc::block_sums<true, NB>(
        tot, reinterpret_cast<double*>(smem_raw + (ss - raw)), a.part,
        a.splits, split, a.Cin, c0, FWD_THREADS);
}

// ---------------------------------------------------------------------------
// #13: dw[n][tap][c] = sum_m dY[m][n] valid(m, tap) a[m + off(tap)][c]
// ---------------------------------------------------------------------------

struct DwArgs {
  const bf16* x;
  const float* mu;
  const float* inv;
  const float* gamma;
  const float* beta;
  const bf16* dy;
  const bf16* y;
  const float* ds;
  const float* dss;
  float* work;  // (splits, Cout, 9 * Cin)
  long long M;
  int H, W, Cin, Cout;
  FastDiv divH, divW;
  int per;  // pixel tiles a block
  int prologue;
  Slab slab;
  int slab_bytes;  // one slab, a multiple of 1024
};

// One dw stage: dY (DW_T rows, transformed in place of dy), raw y, the
// slab; two stages, the per-pixel tap masks of each, an mbarrier each, and
// slack.
__host__ inline int dw_stage_bytes(int slab_bytes) {
  return 2 * DW_T * ROW + slab_bytes;
}
__host__ inline int dw_smem(int slab_bytes) {
  return 1024 + 2 * (dw_stage_bytes(slab_bytes) + DW_T * 2 + 8);
}

// Block (blockIdx.x: chunk of M, blockIdx.y: 64 input channels c0,
// blockIdx.z: 64 output channels n0) of the weight gradient: its f32
// partial of all nine taps' 64 x 64 outputs over its chunk's pixel tiles.
// Warpgroup ty owns the taps (ty, 0..2): per 16 pixels it takes each tap's
// a^T (channels x pixels) from the slab by ldmatrix.trans at the tap's row
// shift, masks the pixels whose tap leaves the image (half-registers: the
// pixel is the contracted index), and multiplies by the tile's dY read
// MN-major through a descriptor, which no tap moves. The next tile's data
// lands while a tile's products run; its once-per-tile work (tap masks,
// bn1's prologue on the slab, dY) follows the products. xmap: x as (M,
// Cin), boxes of 64 channels x BOXR rows; dymap, ymap: dy and y as (M,
// Cout), boxes of 64 channels x DW_T rows.
__global__ void __launch_bounds__(DW_THREADS, 1)
fcbn_bwd_dw_tc_kernel(const DwArgs a, const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap dymap,
                      const __grid_constant__ CUtensorMap ymap) {
  using namespace sm90;
  constexpr int T = DW_T;
  constexpr uint32_t TB = T * ROW;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t stage_bytes = 2 * TB + a.slab_bytes;
  const uint32_t smask = base + 2 * stage_bytes;
  const uint32_t sbar = smask + 2 * T * 2;
  const uint16_t* masks =
      reinterpret_cast<const uint16_t*>(smem_raw + (smask - raw));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid >> 7, wq = warp & 3, t4 = lane & 3;
  const int split = blockIdx.x;
  const int c0 = blockIdx.y * 64, n0 = blockIdx.z * 64;
  const long long tiles = (a.M + T - 1) / T;
  const long long tb = static_cast<long long>(split) * a.per;
  const long long te = tb + a.per < tiles ? tb + a.per : tiles;
  const int ntiles = te > tb ? static_cast<int>(te - tb) : 0;
  const bool relu = a.prologue == AFFINE_RELU;

  // The block's it-th tile lives in stage it % 2; the k-th use of a
  // stage's barrier has parity k % 2. Loads are issued by warp 0.
  auto load = [&](int it) {
    const int s = it & 1;
    const uint32_t st = base + s * stage_bytes, bar = sbar + 8 * s;
    const long long p0 = (tb + it) * T;
    if (lane == 0) {
      mbar_expect_tx(bar, 2 * TB + a.slab.rows * ROW);
      tma_load_2d(st, &dymap, n0, static_cast<int>(p0), bar);
      tma_load_2d(st + TB, &ymap, n0, static_cast<int>(p0), bar);
    }
    __syncwarp();
    load_slab(st + 2 * TB, &xmap, c0, a.slab, p0, a.W, bar, lane);
  };

  Affine af;
  if (a.prologue != NONE)
    af.load(a.mu, a.inv, a.gamma, a.beta, c0 + 8 * (tid & 7), a.Cin);
  DyTerms dyt;
  dyt.load(a.ds, a.dss, n0 + 8 * (tid & 7), a.Cout);

  // Tile it's once-per-tile work, in place, after its data landed: the tap
  // masks (by the last warpgroup, one pixel each), bn1's prologue on the
  // slab, dY = dy + ds + 2 y dss rounded to bf16 over dy.
  auto prepare = [&](int it) {
    const int s = it & 1;
    const uint32_t st = base + s * stage_bytes;
    const long long p0 = (tb + it) * T;
    if (tid >= DW_THREADS - T) {
      const int r = tid - (DW_THREADS - T);
      asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(smask + (s * T + r) * 2),
                   "h"(static_cast<unsigned short>(
                       tap_mask(p0 + r, a.M, a.divH, a.divW)))
                   : "memory");
    }
    mbar_wait(sbar + 8 * s, (it >> 1) & 1);
    if (a.prologue != NONE)
      apply_prologue(st + 2 * TB, a.slab.rows, af, relu, tid, DW_THREADS);
    bntc::apply_dy(st, st + TB, T, dyt, tid, DW_THREADS);
  };

  float acc[3][32];
#pragma unroll
  for (int tx = 0; tx < 3; ++tx)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[tx][i] = 0.f;

  if (tid == 0) {
    prefetch_tensormap(&xmap);
    prefetch_tensormap(&dymap);
    prefetch_tensormap(&ymap);
    mbar_init(sbar, 1);
    mbar_init(sbar + 8, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (ntiles > 0) {
    if (warp == 0) load(0);
    prepare(0);
  }
  for (int it = 0; it < ntiles; ++it) {
    const int s = it & 1;
    const uint32_t st = base + s * stage_bytes;
    const uint32_t sdy = st, slab = st + 2 * TB;
    // Tile it is prepared and visible; every reader of tile it - 1's stage
    // is done, so it takes tile it + 1.
    fence_async_shared();
    __syncthreads();
    if (warp == 0 && it + 1 < ntiles) load(it + 1);

    // One software pipeline over the tile's 16-pixel steps: step k + 1's
    // fragments load while step k's three products run, two register
    // buffers taking turns, each pinned until its products are done.
    const uint16_t* mk = masks + s * T;
    uint32_t fa[2][3][4];
    auto prep = [&](int k, uint32_t (&f)[3][4]) {
      const int k0 = 16 * k;
      const uint32_t v0 = mk[k0 + 2 * t4], v1 = mk[k0 + 2 * t4 + 1];
      const uint32_t v2 = mk[k0 + 8 + 2 * t4], v3 = mk[k0 + 9 + 2 * t4];
#pragma unroll
      for (int tx = 0; tx < 3; ++tx) {
        const int tap = 3 * ty + tx;
        const int r = k0 + (lane & 7) + ((lane >> 4) << 3) +
                      ty * a.slab.rowstep + tx;
        ldsm_x4_trans(slab + swz(r, 2 * wq + ((lane >> 3) & 1)), f[tx]);
        const uint32_t lo = ((0u - ((v0 >> tap) & 1u)) & 0xFFFFu) |
                            ((0u - ((v1 >> tap) & 1u)) & 0xFFFF0000u);
        const uint32_t hi = ((0u - ((v2 >> tap) & 1u)) & 0xFFFFu) |
                            ((0u - ((v3 >> tap) & 1u)) & 0xFFFF0000u);
        f[tx][0] &= lo;
        f[tx][1] &= lo;
        f[tx][2] &= hi;
        f[tx][3] &= hi;
      }
    };
    auto pin = [&](uint32_t (&f)[3][4]) {
#pragma unroll
      for (int tx = 0; tx < 3; ++tx) fence_regs(f[tx]);
    };
#pragma unroll
    for (int tx = 0; tx < 3; ++tx) fence_regs(acc[tx]);
    prep(0, fa[0]);
#pragma unroll
    for (int k = 0; k < T / 16; ++k) {
      pin(fa[k & 1]);
      wgmma_fence();
#pragma unroll
      for (int tx = 0; tx < 3; ++tx)
        mma_rs<1>(acc[tx], fa[k & 1][tx][0], fa[k & 1][tx][1],
                  fa[k & 1][tx][2], fa[k & 1][tx][3], desc_mn<T>(sdy, k, 0),
                  1);
      wgmma_commit();
      wgmma_wait<1>();  // step k - 1 is done: its buffer may be refilled
      pin(fa[(k + 1) & 1]);
      if (k + 1 < T / 16) prep(k + 1, fa[(k + 1) & 1]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int tx = 0; tx < 3; ++tx) fence_regs(acc[tx]);
    pin(fa[0]);
    pin(fa[1]);
    if (it + 1 < ntiles) prepare(it + 1);
  }

  // The block's partial: work[split][n][tap * Cin + c].
  float* out = a.work + static_cast<long long>(split) * a.Cout * 9 * a.Cin;
#pragma unroll
  for (int tx = 0; tx < 3; ++tx) {
    const int tap = 3 * ty + tx;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = c0 + wq * 16 + (lane >> 2) + 8 * ((i >> 1) & 1);
      const int n = n0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
      if (c < a.Cin && n < a.Cout)
        out[static_cast<long long>(n) * 9 * a.Cin + tap * a.Cin + c] =
            acc[tx][i];
    }
  }
}

}  // namespace conv3
