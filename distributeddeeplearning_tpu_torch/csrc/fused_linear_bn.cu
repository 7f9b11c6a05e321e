// Matmul with a BatchNorm prologue and a statistics epilogue for Hopper
// (sm_90a), written by hand: a ResNet bottleneck's 1x1 convolutions.
//
// Three kernels on row-major operands: x (M, K) the layer's input rows, w
// (N, K) the weight (the (N, K, 1, 1) convolution weight viewed as (N, K)),
// y (M, N) the output rows; per-input-channel f32 vectors mu, inv
// (= rsqrt(var + eps)), gamma, beta of length K, and per-output-channel
// f32 vectors of length N:
//
// - flbn_fwd:    replaces distributeddeeplearning_tpu/ops/
//                fused_linear_bn.py:_fwd_kernel. a = relu((x - mu) * (inv *
//                gamma) + beta) rounded to x's type (a = x with bn off), y =
//                a @ w^T rounded to x's type, and the columns' sum(y) and
//                sum(y^2) over y as stored.
// - flbn_bwd_dx: replaces _bwd_dx_kernel. dY = dy + ds + 2 y dss rounded to
//                dy's type, da = dY @ w; with bn, xh = (x - mu) * inv, the
//                ReLU mask z = xh * gamma + beta > 0, dx = dz * (gamma *
//                inv) and the columns' dbeta = sum(dz), dgamma = sum(dz *
//                xh); without, dx = da.
// - flbn_bwd_dw: replaces _bwd_dw_kernel. dw = dY^T @ a in w's (N, K)
//                layout, with a and dY recomputed from x and y in the
//                prologue.
//
// What bounds them on the card: at ResNet-50's shapes the products do
// 2 * 64 to 2 * 2048 flops per element they read, so the wide layers are
// bound by the tensor cores and the 64-channel ones by their bytes. The
// design is the simple one that is right, with the BatchNorm work riding
// the tiles the product loads anyway:
//
// - f32: one generic tile product on the CUDA cores (no TF32): a 128 x
//   128 output tile of 256 threads, 8 x 8 outputs a thread, over a
//   contracted axis cut in BR-deep steps. Each operand tile is loaded from
//   a row-major source with 16-byte loads, either along its rows (x, w in
//   the forward; dy in dx) or across them (w in dx; dy and x in dw, whose
//   contracted axis is M), transformed elementwise on the way (the
//   BatchNorm prologue, or dY) and stored in shared memory. The tile
//   product and the three kernels' bodies live in bn_gemm.cuh, shared with
//   the 3x3 kernels of fused_conv_bn.cu (whose bf16 dx still runs its
//   mma.sync engine).
// - bf16 forward and dx (flbn_fwd_tc_kernel, flbn_bwd_dx_tc_kernel, one
//   body, rows_body): out = A . B, A the (M, R) rows transformed (bn's
//   prologue over x, or dY over dy), B the weight read K-major (forward)
//   or MN-major (dx, whose contracted index is w's row). At stage 1 they
//   are bound by their bytes (2 * 64 flops for each 2-byte element of a
//   64-channel side), at stage 4 by the tensor cores. A persistent block
//   (one an SM, bntc::tc_per) walks a fixed run of 128-row tiles for 64,
//   128 or 256 output channels: 64 wide where the output is 64 (no zeros
//   multiplied), all of the output up to 256 (so at stage 1 x or dy and
//   y are read once and transformed once), 128 in dx with bn (its x tiles
//   take shared memory). One thread of a producer warpgroup (which gives
//   its registers to the others by setmaxnreg) issues every TMA copy into
//   a ring of up to 8 stages of 64-channel chunks (the A chunk, dx's y
//   chunk and the weight chunk, unless the block's weight slice fits in 64
//   KB and stays resident), on mbarriers that the consumers release. Two
//   consumer warpgroups own 64 rows each: each transforms its own rows of
//   a chunk in place, once (rows past M set to 0: prologue(0) and ds are
//   not), and runs one wgmma as wide as the block's output (m64n64,
//   n128 or n256, so A is read once) from shared memory while the next
//   chunk lands. The tile leaves 64 columns at a time: rounded to bf16
//   into one of two swizzled staging tiles and out by a TMA store, which
//   clips rows past M and columns past the output. dx with bn reads x's
//   tile of its output columns (copied by TMA during the products) and
//   the per-channel constants from shared memory for the mask, the scale
//   and the sums.
// - bf16 dw (flbn_bwd_dw_tc_kernel) runs on wgmma too, as the 3x3 dw
//   of conv3x3_tc.cuh with one tap and no halo. It is bound by its bytes
//   wherever K or N is 64 (stage 1: 2 * 64 to 2 * 256 flops for each of its
//   6 input bytes a pixel), so it reads each of x, dy and y once where it
//   can: a persistent block (one an SM) walks a fixed chunk of M for a
//   tile of up to 256 input x 256 output channels (64 wide where K or N is
//   64, so no zeros are multiplied; at most 128 accumulator registers a
//   thread), which covers all of K and N at stage 1 and 2's layers. Each
//   pixel tile's x, dy and y arrive by TMA (one warp issues the 64-channel
//   boxes, an mbarrier a stage, three stages where they fit, else two, so
//   one or two tiles are in flight) into 128-byte-swizzled shared
//   memory; bn's prologue is applied to x and dY formed over dy in place,
//   once a tile, by all 256 threads (bn_tc.cuh, shared with the 3x3
//   kernels). The contracted index is the pixel, the row of both tiles:
//   a^T goes to the register A operand by ldmatrix.trans and dY is read
//   MN-major through a descriptor. Two warpgroups split the block's tile
//   along N or K, or, at 64 x 64, each pixel tile's steps; the next
//   step's fragments load while a step's products run. The partial leaves
//   through shared memory in whole rows.
// - Reductions over M without atomics. The forward and dx kernels give
//   each block a fixed run of row tiles (flbn_run_rows). In f32, after each
//   tile it sums its columns over each thread's rows in registers, then
//   over its 16 thread row groups in shared memory in a fixed order, into
//   one running total a column; in bf16 each warp sums its 16 rows by a
//   fixed reduce-scatter of shuffles and keeps its running totals in
//   registers, and the 8 warps' are added in order once, at the end. Each
//   block writes a (splits, C) partial that a second kernel sums in a
//   fixed order. These column sums (sum(y), sum(y^2), dbeta, dgamma) run in
//   double and round to f32 once: each term (an f32, or the product of
//   two) is exact in double, so the sums are about as good as f32 can hold.
//   In f32 their error carried through E[y^2] - mean^2 into the gradients:
//   an f32 ResNet-50 step was 2.7x as far from its f64 step as the unfused
//   one in the 2-norm, and with exact sums it is as far. dw cuts M into
//   fixed chunks, each block writes its (N, K) f32 partial, and a second
//   kernel sums them in order and rounds. The results repeat bit for bit
//   from run to run on one card (the bf16 dw sizes its chunks by the
//   card's SM count).
// - M is any size (bounds checks, zero fill); K and N are multiples of 8,
//   the operands 16-byte aligned (the wrapper checks).
//
// The prologue and epilogue formulas use the _rn intrinsics in the
// reference's order of operations, so no multiply-add is contracted there
// and they round as the plain PyTorch versions do.

#include "bn_gemm.cuh"
#include "bn_tc.cuh"

namespace {

template <class E, int AK>
__global__ void __launch_bounds__(THREADS, E::MIN_BLOCKS)
flbn_fwd_kernel(const typename E::T* __restrict__ x,
                const typename E::T* __restrict__ w,
                const float* __restrict__ mu, const float* __restrict__ inv,
                const float* __restrict__ gamma,
                const float* __restrict__ beta, typename E::T* __restrict__ y,
                double* __restrict__ part, long long M, int K, int N,
                int splits) {
  using T = typename E::T;
  __shared__ __align__(16) unsigned char smem[smem_bytes<E>()];
  const Source<T, AK> A{x, nullptr, mu, inv, gamma, beta, M, K};
  const Source<T, IDENT> B{w, nullptr, nullptr, nullptr, nullptr, nullptr,
                           N, K};
  fwd_body<E>(A, B, y, part, M, K, N, splits, smem);
}

template <class E, bool BN, bool RELU>
__global__ void __launch_bounds__(THREADS, E::MIN_BLOCKS)
flbn_bwd_dx_kernel(const typename E::T* __restrict__ dy,
                   const typename E::T* __restrict__ yv,
                   const float* __restrict__ ds, const float* __restrict__ dss,
                   const typename E::T* __restrict__ w,
                   const typename E::T* __restrict__ x,
                   const float* __restrict__ mu,
                   const float* __restrict__ inv,
                   const float* __restrict__ gamma,
                   const float* __restrict__ beta,
                   typename E::T* __restrict__ dx, double* __restrict__ part,
                   long long M, int K, int N, int splits) {
  using T = typename E::T;
  __shared__ __align__(16) unsigned char smem[smem_bytes<E>()];
  const Source<T, DY> A{dy, yv, ds, dss, nullptr, nullptr, M, N};
  // w (N, K) read across its rows: the tile's rows are k.
  const Source<T, IDENT> B{w, nullptr, nullptr, nullptr, nullptr, nullptr,
                           N, K};
  bwd_dx_body<E, BN, RELU>(A, B, x, mu, inv, gamma, beta, dx, part, M, K, N,
                           splits, smem);
}

template <class E, int XK>
__global__ void __launch_bounds__(THREADS, E::MIN_BLOCKS)
flbn_bwd_dw_kernel(const typename E::T* __restrict__ x,
                   const float* __restrict__ mu,
                   const float* __restrict__ inv,
                   const float* __restrict__ gamma,
                   const float* __restrict__ beta,
                   const typename E::T* __restrict__ dy,
                   const typename E::T* __restrict__ yv,
                   const float* __restrict__ ds,
                   const float* __restrict__ dss, float* __restrict__ work,
                   long long M, int K, int N, int splits) {
  using T = typename E::T;
  __shared__ __align__(16) unsigned char smem[E::SMEM];
  // Both read across their rows (the contracted index is M): the A tile's
  // rows are n, the B tile's k.
  const Source<T, DY> A{dy, yv, ds, dss, nullptr, nullptr, M, N};
  const Source<T, XK> B{x, nullptr, mu, inv, gamma, beta, M, K};
  bwd_dw_body<E>(A, B, work, M, N, K, splits, smem);
}

// dw = the (splits, N*K) partials summed in order, rounded to T.
template <typename T>
__global__ void __launch_bounds__(THREADS)
flbn_dw_finish_kernel(const float* __restrict__ work, T* __restrict__ dw,
                      long long NK, int splits) {
  dw_finish_body(work, dw, NK, splits);
}

// out0[c] = sum over splits of part[0][s][c], out1 of part[1][s][c], in a
// fixed order in double, rounded to f32 once.
__global__ void __launch_bounds__(FIN_X * FIN_Y)
flbn_column_finish_kernel(const double* __restrict__ part,
                          float* __restrict__ out0, float* __restrict__ out1,
                          int C, int splits) {
  column_finish_body(part, out0, out1, C, splits);
}

int column_finish(const double* part, float* out0, float* out1, int C,
                  int splits, cudaStream_t s) {
  flbn_column_finish_kernel<<<(C + FIN_X - 1) / FIN_X, dim3(FIN_X, FIN_Y), 0,
                              s>>>(part, out0, out1, C, splits);
  return cudaGetLastError();
}

template <class E>
int launch_fwd(const void* x, const void* w, const float* mu,
               const float* inv, const float* gamma, const float* beta,
               void* y, double* part, float* sum, float* sumsq, long long M,
               int K, int N, bool relu, bool bn, int splits, cudaStream_t s) {
  using T = typename E::T;
  if (M == 0) return column_finish(part, sum, sumsq, N, 0, s);
  const dim3 grid(cdiv(N, TILE), splits);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* yp = static_cast<T*>(y);
  if (!bn)
    flbn_fwd_kernel<E, IDENT><<<grid, THREADS, 0, s>>>(
        xp, wp, mu, inv, gamma, beta, yp, part, M, K, N, splits);
  else if (relu)
    flbn_fwd_kernel<E, AFFINE_RELU><<<grid, THREADS, 0, s>>>(
        xp, wp, mu, inv, gamma, beta, yp, part, M, K, N, splits);
  else
    flbn_fwd_kernel<E, AFFINE><<<grid, THREADS, 0, s>>>(
        xp, wp, mu, inv, gamma, beta, yp, part, M, K, N, splits);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return column_finish(part, sum, sumsq, N, splits, s);
}

template <class E>
int launch_bwd_dx(const void* dy, const void* y, const float* ds,
                  const float* dss, const void* w, const void* x,
                  const float* mu, const float* inv, const float* gamma,
                  const float* beta, void* dx, double* part, float* dbeta,
                  float* dgamma, long long M, int K, int N, bool relu,
                  bool bn, int splits, cudaStream_t s) {
  using T = typename E::T;
  if (M == 0)
    return bn ? column_finish(part, dbeta, dgamma, K, 0, s) : cudaSuccess;
  const dim3 grid(cdiv(K, TILE), splits);
  const T* dyp = static_cast<const T*>(dy);
  const T* yp = static_cast<const T*>(y);
  const T* wp = static_cast<const T*>(w);
  const T* xp = static_cast<const T*>(x);
  T* dxp = static_cast<T*>(dx);
  if (!bn)
    flbn_bwd_dx_kernel<E, false, false><<<grid, THREADS, 0, s>>>(
        dyp, yp, ds, dss, wp, xp, mu, inv, gamma, beta, dxp, part, M, K, N,
        splits);
  else if (relu)
    flbn_bwd_dx_kernel<E, true, true><<<grid, THREADS, 0, s>>>(
        dyp, yp, ds, dss, wp, xp, mu, inv, gamma, beta, dxp, part, M, K, N,
        splits);
  else
    flbn_bwd_dx_kernel<E, true, false><<<grid, THREADS, 0, s>>>(
        dyp, yp, ds, dss, wp, xp, mu, inv, gamma, beta, dxp, part, M, K, N,
        splits);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !bn) return err;
  return column_finish(part, dbeta, dgamma, K, splits, s);
}

template <class E>
int launch_bwd_dw(const void* x, const float* mu, const float* inv,
                  const float* gamma, const float* beta, const void* dy,
                  const void* y, const float* ds, const float* dss,
                  float* work, void* dw, long long M, int K, int N, bool relu,
                  bool bn, int splits, cudaStream_t s) {
  using T = typename E::T;
  const dim3 grid(cdiv(K, TILE), cdiv(N, TILE), splits);
  const T* xp = static_cast<const T*>(x);
  const T* dyp = static_cast<const T*>(dy);
  const T* yp = static_cast<const T*>(y);
  if (!bn)
    flbn_bwd_dw_kernel<E, IDENT><<<grid, THREADS, 0, s>>>(
        xp, mu, inv, gamma, beta, dyp, yp, ds, dss, work, M, K, N, splits);
  else if (relu)
    flbn_bwd_dw_kernel<E, AFFINE_RELU><<<grid, THREADS, 0, s>>>(
        xp, mu, inv, gamma, beta, dyp, yp, ds, dss, work, M, K, N, splits);
  else
    flbn_bwd_dw_kernel<E, AFFINE><<<grid, THREADS, 0, s>>>(
        xp, mu, inv, gamma, beta, dyp, yp, ds, dss, work, M, K, N, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long nk = static_cast<long long>(N) * K;
  long long blocks = cdiv(nk, THREADS);
  if (blocks > 4096) blocks = 4096;
  flbn_dw_finish_kernel<T><<<static_cast<int>(blocks), THREADS, 0, s>>>(
      work, static_cast<T*>(dw), nk, splits);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 dw (#10) on the tensor cores
// ---------------------------------------------------------------------------

namespace dwtc {

using bf16 = __nv_bfloat16;
using bntc::ROW;
using bntc::swz;

constexpr int TC_THREADS = 256;  // two warpgroups
constexpr int SMEM_LIMIT = 232448;
constexpr int OUT_STRIDE = 68;   // floats a row of a staged 64 x 64 partial
constexpr int OUT_BYTES = 64 * OUT_STRIDE * 4;

// How the two warpgroups share a block's (kc x nc) output tile: each owns
// KW x NW 64 x 64 blocks, side by side along N or K, or both own the whole
// 64 x 64 tile and take half of each pixel tile's 16-pixel steps.
enum Split { SPLIT_M = 0, SPLIT_N = 1, SPLIT_K = 2 };

// Pixels (rows of M) a tile: two stages of x, dy and y for the block's
// channels must fit in shared memory.
__host__ __device__ constexpr int tile_rows(int nw) {
  return nw == 2 ? 64 : 128;
}

struct DwArgs {
  const float* mu;
  const float* inv;
  const float* gamma;
  const float* beta;
  const float* ds;
  const float* dss;
  float* work;  // (splits, N, K)
  long long M;
  int K, N;
  int per;          // pixel tiles a block
  int prologue;     // bntc::Prologue
  int split;        // Split
  int kc, nc;       // the block's input and output channels, 64 a block
  int stage_bytes;  // x, dy and y of one tile
  int stages;       // 2 or 3, as shared memory allows
};

// Block (blockIdx.x: chunk of M, blockIdx.y: kc input channels from k0,
// blockIdx.z: nc output channels from n0) of the weight gradient: its f32
// partial dw[n][k] = sum over its chunk's pixels of dY[m][n] a[m][k]. Each
// tile's x, dy and y (64-channel column blocks of T rows) land by TMA in
// a ring of two or three stages; bn's prologue is applied to x and dY =
// dy + ds + 2 y dss formed over dy in place, once a tile. A warpgroup takes a^T
// (channels x pixels) by ldmatrix.trans as the register A and reads dY
// MN-major through a descriptor as B: both operands are contracted over
// the pixel, their rows. xmap: x as (M, K), dymap and ymap: dy and y as
// (M, N), boxes of 64 channels x T rows.
template <int KW, int NW>
__global__ void __launch_bounds__(TC_THREADS, 1)
flbn_bwd_dw_tc_kernel(const DwArgs a, const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap dymap,
                      const __grid_constant__ CUtensorMap ymap) {
  using namespace sm90;
  constexpr int T = tile_rows(NW);
  constexpr uint32_t TB = T * ROW;  // one 64-channel column block of a tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sbar = base + a.stages * a.stage_bytes;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = tid >> 7, wq = warp & 3, t4 = lane & 3;
  const int kcb = a.kc >> 6, ncb = a.nc >> 6;  // column blocks: x, dY
  const int split = blockIdx.x;
  const int k0 = blockIdx.y * a.kc, n0 = blockIdx.z * a.nc;
  const long long tiles = (a.M + T - 1) / T;
  const long long tb = static_cast<long long>(split) * a.per;
  const long long te = tb + a.per < tiles ? tb + a.per : tiles;
  const int ntiles = te > tb ? static_cast<int>(te - tb) : 0;
  const bool relu = a.prologue == bntc::AFFINE_RELU;
  // This warpgroup's first x and dY column blocks and its 16-pixel steps.
  const int kb0 = a.split == SPLIT_K ? wg * KW : 0;
  const int nb0 = a.split == SPLIT_N ? wg * NW : 0;
  const int nsteps = a.split == SPLIT_M ? T / 32 : T / 16;
  const int step0 = a.split == SPLIT_M ? wg * nsteps : 0;

  // The block's it-th tile lives in stage it % stages; the k-th use of a
  // stage's barrier has parity k % 2. Issued by warp 0, a box a lane.
  auto load = [&](int it) {
    const int s = it % a.stages;
    const uint32_t st = base + s * a.stage_bytes, bar = sbar + 8 * s;
    const int p0 = static_cast<int>((tb + it) * T);
    if (lane == 0) mbar_expect_tx(bar, a.stage_bytes);
    __syncwarp();
    const uint32_t dst = st + lane * TB;
    if (lane < kcb)
      tma_load_2d(dst, &xmap, k0 + 64 * lane, p0, bar);
    else if (lane < kcb + ncb)
      tma_load_2d(dst, &dymap, n0 + 64 * (lane - kcb), p0, bar);
    else if (lane < kcb + 2 * ncb)
      tma_load_2d(dst, &ymap, n0 + 64 * (lane - kcb - ncb), p0, bar);
  };

  // Thread t transforms chunk t % 8 of x column block (t / 8) % kcb and of
  // dY column block (t / 8) % ncb, whose constants it holds.
  const int xj = (tid >> 3) % kcb, yj = (tid >> 3) % ncb;
  bntc::Affine af;
  if (a.prologue != bntc::NONE)
    af.load(a.mu, a.inv, a.gamma, a.beta, k0 + 64 * xj + 8 * (tid & 7), a.K);
  bntc::DyTerms dyt;
  dyt.load(a.ds, a.dss, n0 + 64 * yj + 8 * (tid & 7), a.N);

  // Tile it's once-per-tile work, in place, after its data landed: bn's
  // prologue on x's rows in M, dY over dy (0 on rows past M, where dy and
  // y arrive as 0 but ds does not vanish).
  auto prepare = [&](int it) {
    const int s = it % a.stages;
    const uint32_t st = base + s * a.stage_bytes;
    const uint32_t sdy = st + kcb * TB, sy = sdy + ncb * TB;
    const long long left = a.M - (tb + it) * T;
    const int rows = left < T ? static_cast<int>(left) : T;
    mbar_wait(sbar + 8 * s, (it / a.stages) & 1);
    if (a.prologue != bntc::NONE)  // column block xj by 256 / kcb threads
      bntc::apply_prologue(st + xj * TB, rows, af, relu,
                           (tid >> 3) / kcb * 8 + (tid & 7),
                           TC_THREADS / kcb);
    bntc::apply_dy(sdy + yj * TB, sy + yj * TB, T, dyt,
                   (tid >> 3) / ncb * 8 + (tid & 7), TC_THREADS / ncb, rows);
  };

  float acc[KW][NW][32];
#pragma unroll
  for (int kb = 0; kb < KW; ++kb)
#pragma unroll
    for (int nb = 0; nb < NW; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[kb][nb][i] = 0.f;

  if (tid == 0) {
    prefetch_tensormap(&xmap);
    prefetch_tensormap(&dymap);
    prefetch_tensormap(&ymap);
    for (int i = 0; i < a.stages; ++i) mbar_init(sbar + 8 * i, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (warp == 0)
    for (int it = 0; it < a.stages - 1 && it < ntiles; ++it) load(it);
  if (ntiles > 0) prepare(0);
  for (int it = 0; it < ntiles; ++it) {
    const uint32_t st = base + (it % a.stages) * a.stage_bytes;
    const uint32_t sdy = st + kcb * TB;
    // Tile it is prepared and visible; every reader of tile it - 1's stage
    // is done, so it takes tile it + stages - 1.
    fence_async_shared();
    __syncthreads();
    if (warp == 0 && it + a.stages - 1 < ntiles) load(it + a.stages - 1);

    // One software pipeline over the warpgroup's 16-pixel steps: step k +
    // 1's fragments load while step k's products run, two register
    // buffers taking turns, each pinned until its products are done.
    uint32_t fa[2][KW][4];
    auto prep = [&](int k, uint32_t (&f)[KW][4]) {
      const int r = 16 * (step0 + k) + (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
      for (int kb = 0; kb < KW; ++kb)
        ldsm_x4_trans(st + (kb0 + kb) * TB + swz(r, 2 * wq + ((lane >> 3) & 1)),
                      f[kb]);
    };
    auto pin = [&](uint32_t (&f)[KW][4]) {
#pragma unroll
      for (int kb = 0; kb < KW; ++kb) fence_regs(f[kb]);
    };
#pragma unroll
    for (int kb = 0; kb < KW; ++kb)
#pragma unroll
      for (int nb = 0; nb < NW; ++nb) fence_regs(acc[kb][nb]);
    prep(0, fa[0]);
#pragma unroll
    for (int k = 0; k < T / 16; ++k) {
      if (k == nsteps) break;
      pin(fa[k & 1]);
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < KW; ++kb)
#pragma unroll
        for (int nb = 0; nb < NW; ++nb)
          mma_rs<1>(acc[kb][nb], fa[k & 1][kb][0], fa[k & 1][kb][1],
                    fa[k & 1][kb][2], fa[k & 1][kb][3],
                    desc_mn<T>(sdy, step0 + k, nb0 + nb), 1);
      wgmma_commit();
      wgmma_wait<1>();  // step k - 1 is done: its buffer may be refilled
      pin(fa[(k + 1) & 1]);
      if (k + 1 < nsteps) prep(k + 1, fa[(k + 1) & 1]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int kb = 0; kb < KW; ++kb)
#pragma unroll
      for (int nb = 0; nb < NW; ++nb) fence_regs(acc[kb][nb]);
    pin(fa[0]);
    pin(fa[1]);
    if (it + 1 < ntiles) prepare(it + 1);
  }

  // The block's partial, work[split][n][k], a 64 x 64 block at a time: each
  // warpgroup stages its block as rows of n in shared memory (the stages
  // are free), and the block writes whole rows of k; under SPLIT_M the two
  // warpgroups' halves are added, the first's first.
  __syncthreads();
  float* out = a.work + static_cast<long long>(split) * a.N * a.K;
  const uint32_t stg = base + wg * OUT_BYTES;
  const int slots = a.split == SPLIT_M ? 1 : 2;
#pragma unroll
  for (int kb = 0; kb < KW; ++kb)
#pragma unroll
    for (int nb = 0; nb < NW; ++nb) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = wq * 16 + (lane >> 2) + 8 * ((i >> 1) & 1);
        const int n = 8 * (i >> 2) + 2 * t4 + (i & 1);
        asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(
                         stg + (n * OUT_STRIDE + c) * 4),
                     "f"(acc[kb][nb][i])
                     : "memory");
      }
      __syncthreads();
      for (int e = tid; e < slots * 64 * 16; e += TC_THREADS) {
        const int w = e >> 10, n = (e >> 4) & 63, c = (e & 15) * 4;
        const float* row = reinterpret_cast<const float*>(
            smem_raw + (base - raw) + w * OUT_BYTES) + n * OUT_STRIDE + c;
        float4 v = *reinterpret_cast<const float4*>(row);
        if (a.split == SPLIT_M) {
          const float4 u = *reinterpret_cast<const float4*>(
              row + OUT_BYTES / 4);
          v.x = __fadd_rn(v.x, u.x);
          v.y = __fadd_rn(v.y, u.y);
          v.z = __fadd_rn(v.z, u.z);
          v.w = __fadd_rn(v.w, u.w);
        }
        const int kk = k0 + 64 * (kb + (a.split == SPLIT_K ? w * KW : 0)) + c;
        const int nn = n0 + 64 * (nb + (a.split == SPLIT_N ? w * NW : 0)) + n;
        if (kk < a.K && nn < a.N)
          *reinterpret_cast<float4*>(out + static_cast<long long>(nn) * a.K +
                                     kk) = v;
      }
      __syncthreads();
    }
}

// The tile of a shape: 64-wide where K or N is 64 (no zeros multiplied),
// and each block as wide as a warpgroup's 128 accumulator registers allow,
// so that each x and dY element is transformed once per block that needs
// it (once at K, N <= 256, 128 as at stage 1 and 2's conv1 and conv3).
struct DwPlan {
  int kw, nw, split, T, kc, nc;
};

inline DwPlan dw_plan(int K, int N) {
  DwPlan p;
  if (K <= 64 && N <= 64) {
    p = {1, 1, SPLIT_M, 0, 64, 64};
  } else if (K <= 64) {
    p = N <= 128 ? DwPlan{1, 1, SPLIT_N, 0, 64, 128}
                 : DwPlan{1, 2, SPLIT_N, 0, 64, 256};
  } else if (N <= 64) {
    p = K <= 128 ? DwPlan{1, 1, SPLIT_K, 0, 128, 64}
                 : DwPlan{2, 1, SPLIT_K, 0, 256, 64};
  } else if (K <= 128) {
    p = N <= 128 ? DwPlan{2, 1, SPLIT_N, 0, 128, 128}
                 : DwPlan{2, 2, SPLIT_N, 0, 128, 256};
  } else {
    p = {2, 2, SPLIT_K, 0, 256, 128};
  }
  p.T = tile_rows(p.nw);
  return p;
}

inline long long dw_tiles(long long M, const DwPlan& p) {
  return (M + p.T - 1) / p.T;
}

inline long long dw_units(int K, int N, const DwPlan& p) {
  return ((K + p.kc - 1) / p.kc) * static_cast<long long>((N + p.nc - 1) /
                                                          p.nc);
}

// Chunks of M: one block an SM over the (K, N) tiles.
inline int dw_splits_tc(long long M, int K, int N) {
  const DwPlan p = dw_plan(K, N);
  const long long tiles = dw_tiles(M, p);
  if (tiles == 0) return 1;
  return static_cast<int>(
      cdiv(tiles, bntc::tc_per(tiles, dw_units(K, N, p))));
}

template <int KW, int NW>
int launch_dw_inst(const DwArgs& a, const CUtensorMap (&maps)[3], int smem,
                   dim3 grid, cudaStream_t s) {
  auto kernel = flbn_bwd_dw_tc_kernel<KW, NW>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, TC_THREADS, smem, s>>>(a, maps[0], maps[1], maps[2]);
  return cudaGetLastError();
}

}  // namespace dwtc

int launch_bwd_dw_tc(const void* x, const float* mu, const float* inv,
                     const float* gamma, const float* beta, const void* dy,
                     const void* y, const float* ds, const float* dss,
                     float* work, void* dw, long long M, int K, int N,
                     bool relu, bool bn, int splits, cudaStream_t s) {
  using namespace dwtc;
  if (M > 0x7FFFFFFFLL) return cudaErrorInvalidValue;  // TMA row coordinate
  const long long nk = static_cast<long long>(N) * K;
  if (M == 0) return cudaMemsetAsync(dw, 0, nk * 2, s);
  const DwPlan p = dw_plan(K, N);
  DwArgs a;
  a.mu = mu;
  a.inv = inv;
  a.gamma = gamma;
  a.beta = beta;
  a.ds = ds;
  a.dss = dss;
  a.work = work;
  a.M = M;
  a.K = K;
  a.N = N;
  a.per = static_cast<int>(cdiv(dw_tiles(M, p), splits));
  a.prologue = !bn ? bntc::NONE : relu ? bntc::AFFINE_RELU : bntc::AFFINE;
  a.split = p.split;
  a.kc = p.kc;
  a.nc = p.nc;
  a.stage_bytes = p.T * ROW * (p.kc / 64 + 2 * p.nc / 64);
  a.stages = 1024 + 3 * a.stage_bytes + 24 <= SMEM_LIMIT ? 3 : 2;
  const int smem = 1024 + a.stages * a.stage_bytes + 8 * a.stages;
  CUtensorMap maps[3];  // x, dy, y
  int err = bntc::rows_map(&maps[0], x, M, K, p.T);
  if (err == cudaSuccess) err = bntc::rows_map(&maps[1], dy, M, N, p.T);
  if (err == cudaSuccess) err = bntc::rows_map(&maps[2], y, M, N, p.T);
  if (err != cudaSuccess) return err;
  const dim3 grid(splits, static_cast<unsigned>(cdiv(K, p.kc)),
                  static_cast<unsigned>(cdiv(N, p.nc)));
  if (p.kw == 1)
    err = p.nw == 1 ? launch_dw_inst<1, 1>(a, maps, smem, grid, s)
                    : launch_dw_inst<1, 2>(a, maps, smem, grid, s);
  else
    err = p.nw == 1 ? launch_dw_inst<2, 1>(a, maps, smem, grid, s)
                    : launch_dw_inst<2, 2>(a, maps, smem, grid, s);
  if (err != cudaSuccess) return err;
  long long blocks = cdiv(nk, THREADS);
  if (blocks > 4096) blocks = 4096;
  flbn_dw_finish_kernel<bf16><<<static_cast<int>(blocks), THREADS, 0, s>>>(
      work, static_cast<bf16*>(dw), nk, splits);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 forward (#8) and dx (#9) on the tensor cores
// ---------------------------------------------------------------------------

namespace rowtc {

using bntc::ROW;
using bntc::swz;

constexpr int T = 128;                   // pixel rows a tile, 64 a warpgroup
constexpr uint32_t TB = T * ROW;         // a tile's 64-channel column block
constexpr int CONSUMERS = 256;           // two warpgroups
constexpr int TC_THREADS = CONSUMERS + 128;  // and the producer's
constexpr int PRODUCER_REGS = 40;        // registers a thread after the
constexpr int CONSUMER_REGS = 232;       // split (65,536 an SM)
constexpr int SMEM_LIMIT = 232448;
constexpr int RES_MAX = 64 * 1024;       // a resident weight slice at most
constexpr int MAX_STAGES = 8;
constexpr int NBAR = 2 * MAX_STAGES + 5;  // full, empty; weight; x full, empty
constexpr int NCONST = 5;                // dx: mu, inv, gamma, beta, gamma inv

struct RowArgs {
  const float* mu;     // bn's vectors over K: the forward's prologue, the
  const float* inv;    // dx epilogue's mask and scale
  const float* gamma;
  const float* beta;
  const float* ds;     // dx: dY's terms over N
  const float* dss;
  double* part;        // (2, splits, Q): the forward's sum(y), sum(y^2), or
                       // dx's dbeta, dgamma
  long long M;
  int R, Q;            // contracted and output channels: (K, N) in the
                       // forward, (N, K) in dx
  int per;             // pixel tiles a block
  int splits;
  int prologue;        // bntc::Prologue: on x (forward) or in dx's epilogue
  int nch;             // 64-channel chunks of R
  int stages;          // the ring's stages
  int stage_bytes;
  int xslots;          // dx with bn: x tiles held for the epilogue (1 or 2)
  int oslots;          // staging tiles of the output (1 or 2)
};

// The block's (2, splits, Q) partial from each warp's running sums: lane
// (g, t4) of every warp holds two columns of each 64-column block nb, j =
// 0, 1: the forward's 2 lane + j (its rows warp + 8 k), dx's 32 j + 8 (g /
// 2) + 2 t4 + g % 2 (rowsum's order, over the warp's accumulator rows).
// Added over the 8 warps in order, through shared memory at `fin` (2 x 8
// x QC doubles).
template <bool DX, int NB>
__device__ __forceinline__ void write_sums(const RowArgs& a,
                                           const double (&tot)[2][NB][2],
                                           double* fin, int q0) {
  constexpr int QC = 64 * NB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  sm90::bar_sync(1, CONSUMERS);
#pragma unroll
  for (int which = 0; which < 2; ++which)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        fin[(which * 8 + warp) * QC + nb * 64 +
            (DX ? 32 * j + 8 * (g >> 1) + 2 * t4 + (g & 1) : 2 * lane + j)] =
            tot[which][nb][j];
  sm90::bar_sync(1, CONSUMERS);
  for (int e = tid; e < 2 * QC; e += CONSUMERS) {
    const int which = e / QC, col = e - which * QC;
    double t = 0.0;
#pragma unroll
    for (int w = 0; w < 8; ++w) t += fin[(which * 8 + w) * QC + col];
    if (q0 + col < a.Q)
      a.part[(static_cast<long long>(which) * a.splits + blockIdx.x) * a.Q +
             q0 + col] = t;
  }
}

// v[u] (u < 8: the lane's 8 columns of one half of a 64-column block, each
// summed over the lane's two rows) summed over the 8 lanes g that share t4,
// a reduce-scatter in a fixed order: lane g ends with column u = g.
__device__ __forceinline__ double rowsum(double (&v)[8], int lane) {
#pragma unroll
  for (int level = 0; level < 3; ++level) {
    const int half = 4 >> level, mask = 16 >> level;
    const bool up = (lane & mask) != 0;
#pragma unroll
    for (int u = 0; u < half; ++u) {
      const double send = up ? v[u] : v[u + half];
      const double keep = up ? v[u + half] : v[u];
      v[u] = keep + __shfl_xor_sync(0xFFFFFFFFu, send, mask);
    }
  }
  return v[0];
}

// Block (blockIdx.x: run of pixel tiles, blockIdx.y: QC = 64 NB output
// channels from q0) of the forward (DX false: out = a w^T, a x with bn's
// prologue) or of dx (DX true: da = dY w, dY formed over dy; with bn the
// epilogue's mask and scale). Warpgroup 2 produces: one thread, with few
// registers, issues every TMA copy into a ring of `stages` stages, each
// the A chunk (T rows x 64 channels of x, or of dy and y) and, unless the
// block's weight slice is resident (RES), its 64 x QC weight chunk; dx
// with bn also has the x tile of its output columns copied for the
// epilogue. Warpgroups 0 and 1 consume, 64 rows each: each transforms its
// own rows of the A chunk in place, once, and runs wgmma with both
// operands from shared memory (w K-major in the forward, MN-major in dx,
// whose contracted index is w's row). The output tile leaves, 64 columns
// at a time, rounded to bf16 through a swizzled staging tile and a TMA
// store; the column sums are taken in double over each warp's rows (the
// forward's from the staged tile, as stored; dx's by rowsum) and run on in
// registers over the block's tiles. amap: x
// (forward) or dy (dx) as (M, R); ymap: dx's y (M, N); wmap: w (N, K) in
// boxes of 64 x QC (forward) or 64 x 64 (dx); xmap: dx's x (M, K); omap: y
// (M, N) or dx (M, K); the activations' boxes T rows.
template <bool DX, int NB, bool RES>
__device__ __forceinline__ void rows_body(const RowArgs& a,
                                          const CUtensorMap* amap,
                                          const CUtensorMap* ymap,
                                          const CUtensorMap* wmap,
                                          const CUtensorMap* xmap,
                                          const CUtensorMap* omap) {
  using namespace sm90;
  constexpr int QC = 64 * NB;
  constexpr uint32_t BC = QC * ROW;  // one 64-deep chunk of the weight slice
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sw = base;  // the resident weight slice
  const uint32_t ring = sw + (RES ? a.nch * BC : 0);
  const uint32_t sx = ring + a.stages * a.stage_bytes;
  // dx runs bn's epilogue at most 128 wide (row_plan), so the 256-wide
  // instance keeps its registers for the accumulators.
  constexpr bool BN_OK = !DX || NB <= 2;
  const bool bn = BN_OK && a.prologue != bntc::NONE;
  const bool relu = a.prologue == bntc::AFFINE_RELU;
  const bool xtile = DX && bn;  // dx's epilogue reads x
  const uint32_t sout = sx + (xtile ? a.xslots * NB * TB : 0);
  const uint32_t sconst = sout + a.oslots * TB;
  const uint32_t sbar = sconst + (DX ? NCONST * QC * 4 : 0);
  auto full = [&](int s) { return sbar + 8 * s; };
  auto empty = [&](int s) { return sbar + 8 * (MAX_STAGES + s); };
  const uint32_t wbar = sbar + 16 * MAX_STAGES;
  auto xfull = [&](int i) { return wbar + 8 + 8 * i; };
  auto xempty = [&](int i) { return wbar + 24 + 8 * i; };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, q0 = blockIdx.y * QC;
  const long long tiles = (a.M + T - 1) / T;
  const long long tb = static_cast<long long>(split) * a.per;
  const long long te = tb + a.per < tiles ? tb + a.per : tiles;
  const int ntiles = te > tb ? static_cast<int>(te - tb) : 0;
  const int steps = ntiles * a.nch;

  if (tid == 0) {
    prefetch_tensormap(amap);
    prefetch_tensormap(wmap);
    prefetch_tensormap(omap);
    if (DX) prefetch_tensormap(ymap);
    if (xtile) prefetch_tensormap(xmap);
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);  // one arrival a consumer warpgroup
    }
    mbar_init(wbar, 1);
    for (int i = 0; i < 2; ++i) {
      mbar_init(xfull(i), 1);
      mbar_init(xempty(i), 1);
    }
    fence_mbar_init();
  }
  // dx's epilogue constants of the block's output columns.
  if (xtile) {
    float* c = reinterpret_cast<float*>(smem_raw + (sconst - raw));
    for (int i = tid; i < QC; i += TC_THREADS) {
      const int k = q0 + i;
      const bool ok = k < a.Q;
      c[i] = ok ? a.mu[k] : 0.f;
      c[QC + i] = ok ? a.inv[k] : 0.f;
      c[2 * QC + i] = ok ? a.gamma[k] : 0.f;
      c[3 * QC + i] = ok ? a.beta[k] : 0.f;
      c[4 * QC + i] = ok ? __fmul_rn(a.gamma[k], a.inv[k]) : 0.f;
    }
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid != CONSUMERS || steps == 0) return;
    auto load_w = [&](uint32_t dst, int c, uint32_t bar) {
      if (DX)  // boxes of 64 output (k) x 64 contracted (n) channels
        for (int nb = 0; nb < NB; ++nb)
          tma_load_2d(dst + nb * 64 * ROW, wmap, q0 + 64 * nb, 64 * c, bar);
      else     // one box of 64 contracted (k) x QC output (n) channels
        tma_load_2d(dst, wmap, 64 * c, q0, bar);
    };
    if (RES) {
      mbar_expect_tx(wbar, a.nch * BC);
      for (int c = 0; c < a.nch; ++c) load_w(sw + c * BC, c, wbar);
    }
    for (int q = 0; q < steps; ++q) {
      const int s = q % a.stages, use = q / a.stages;
      const int it = q / a.nch, c = q - it * a.nch;
      const int p0 = static_cast<int>((tb + it) * T);
      if (xtile && c == 0) {
        const int xs = it % a.xslots, xuse = it / a.xslots;
        if (xuse > 0) mbar_wait(xempty(xs), (xuse - 1) & 1);
        mbar_expect_tx(xfull(xs), NB * TB);
        for (int nb = 0; nb < NB; ++nb)
          tma_load_2d(sx + (xs * NB + nb) * TB, xmap, q0 + 64 * nb, p0,
                      xfull(xs));
      }
      if (use > 0) mbar_wait(empty(s), (use - 1) & 1);
      const uint32_t st = ring + s * a.stage_bytes;
      mbar_expect_tx(full(s), a.stage_bytes);
      tma_load_2d(st, amap, 64 * c, p0, full(s));
      if (DX) tma_load_2d(st + TB, ymap, 64 * c, p0, full(s));
      if (!RES) load_w(st + (DX ? 2 : 1) * TB, c, full(s));
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  // The consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of a tile;
  // thread (g, t4) of warp wq of it holds rows r0 and r0 + 8 (sm90.cuh's
  // accumulator layout).
  const int wg = tid >> 7, wt = tid & 127, wq = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = wg * 64 + wq * 16 + g;
  const uint32_t arow = wg * 64 * ROW;
  const bool sums = !DX || bn;
  float acc[NB * 32];  // column block nb (64 wide): registers 32 nb on
  double tot[2][NB][2];
#pragma unroll
  for (int w = 0; w < 2; ++w)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) tot[w][nb][0] = tot[w][nb][1] = 0.0;
  bntc::Affine af;
  bntc::DyTerms dyt;
  int q = 0, k_out = 0;
  for (int it = 0; it < ntiles; ++it) {
    const long long p0 = (tb + it) * T;
    const int valid =
        (a.M - p0 < T ? static_cast<int>(a.M - p0) : T) - wg * 64;
#pragma unroll
    for (int i = 0; i < NB * 32; ++i) acc[i] = 0.f;
    fence_regs(acc);
    for (int c = 0; c < a.nch; ++c, ++q) {
      const int s = q % a.stages;
      const uint32_t st = ring + s * a.stage_bytes;
      // The chunk's constants load while its data lands.
      if (a.nch > 1 || q == 0) {
        if (DX)
          dyt.load(a.ds, a.dss, 64 * c + 8 * (wt & 7), a.R);
        else if (bn)
          af.load(a.mu, a.inv, a.gamma, a.beta, 64 * c + 8 * (wt & 7), a.R);
      }
      mbar_wait(full(s), (q / a.stages) & 1);
      if (RES && q == 0) mbar_wait(wbar, 0);
      // The warpgroup's rows of the A chunk, in place, once: dY over dy,
      // or bn's prologue over x; zero past M. Thread wt takes 16-byte
      // chunk wt % 8 of rows wt / 8 + 16 i, all loads first.
      if (DX || bn) {
        uint4 v[4];
        uint32_t off[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          off[i] = st + arow + swz((wt >> 3) + 16 * i, wt & 7);
          v[i] = lds128(off[i]);
        }
        if (DX) {
          uint4 yv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) yv[i] = lds128(off[i] + TB);
#pragma unroll
          for (int i = 0; i < 4; ++i) v[i] = dyt.apply(v[i], yv[i]);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) v[i] = af.apply(v[i], relu);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          sts128(off[i], (wt >> 3) + 16 * i < valid
                             ? v[i]
                             : make_uint4(0u, 0u, 0u, 0u));
        fence_async_shared();
        bar_sync(2 + wg, 128);
      }
      const uint32_t bw = RES ? sw + c * BC : st + (DX ? 2 : 1) * TB;
      // One instruction as wide as the block's output (A read once).
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = desc_k<64>(st + arow, kk);
        const uint64_t db = DX ? (NB == 1 ? desc_mn<64>(bw, kk, 0)
                                          : desc_mn_wide<64>(bw, kk))
                               : desc_k<64>(bw, kk);
        if constexpr (NB == 1)
          mma_ss<DX ? 1 : 0>(acc, da, db, 1);
        else if constexpr (NB == 2)
          mma_ss_n128<DX ? 1 : 0>(acc, da, db, 1);
        else
          mma_ss_n256<DX ? 1 : 0>(acc, da, db, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();  // chunk c - 1 is done: its stage may be refilled
      if (c > 0 && wt == 0) mbar_arrive(empty((q - 1) % a.stages));
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (wt == 0) mbar_arrive(empty((q - 1) % a.stages));

    // Epilogue, 64 columns at a time.
    uint32_t xt = 0;
    if (xtile) {
      const int xs = it % a.xslots;
      xt = sx + xs * NB * TB;
      mbar_wait(xfull(xs), (it / a.xslots) & 1);
    }
    const float* cst =  // dx's epilogue constants
        reinterpret_cast<const float*>(smem_raw + (sconst - raw));
#pragma unroll
    for (int nb = 0; nb < NB; ++nb, ++k_out) {
      const uint32_t stg = sout + (k_out % a.oslots) * TB;
      if (a.oslots == 1) {  // the previous store has read the one slot
        if (tid == 0) bulk_wait_read<0>();
        bar_sync(1, CONSUMERS);
      }
      if (!DX) {  // y rounded to bf16
#pragma unroll
        for (int i = 0; i < 32; i += 2)
          sts32(stg + swz(r0 + 8 * ((i >> 1) & 1), i >> 2) + 4 * t4,
                pack_bf16(acc[32 * nb + i], acc[32 * nb + i + 1]));
      } else {  // dx = da, or dz (gamma inv) with bn, and dz's sums
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          double vs[8], vq[8];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int j = 4 * h + jj;  // the 8-column group
            const int col = nb * 64 + 8 * j + 2 * t4;
            float2 mu2{}, inv2{}, ga2{}, be2{}, gi2{};
            if (bn) {
              mu2 = *reinterpret_cast<const float2*>(cst + col);
              inv2 = *reinterpret_cast<const float2*>(cst + QC + col);
              ga2 = *reinterpret_cast<const float2*>(cst + 2 * QC + col);
              be2 = *reinterpret_cast<const float2*>(cst + 3 * QC + col);
              gi2 = *reinterpret_cast<const float2*>(cst + 4 * QC + col);
            }
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int i = 4 * j + 2 * hr;
              const uint32_t off = swz(r0 + 8 * hr, j) + 4 * t4;
              float o0 = acc[32 * nb + i], o1 = acc[32 * nb + i + 1];
              if (bn) {
                const uint32_t xr = lds32(xt + nb * TB + off);
                const float2 xv = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(&xr));
                const float xh0 = __fmul_rn(__fsub_rn(xv.x, mu2.x), inv2.x);
                const float xh1 = __fmul_rn(__fsub_rn(xv.y, mu2.y), inv2.y);
                if (relu) {
                  o0 = __fadd_rn(__fmul_rn(xh0, ga2.x), be2.x) > 0.f ? o0
                                                                     : 0.f;
                  o1 = __fadd_rn(__fmul_rn(xh1, ga2.y), be2.y) > 0.f ? o1
                                                                     : 0.f;
                }
                const double d0 = o0, d1 = o1;  // dz
                const double e0 = xh0, e1 = xh1;
                vs[2 * jj] = hr ? vs[2 * jj] + d0 : d0;
                vs[2 * jj + 1] = hr ? vs[2 * jj + 1] + d1 : d1;
                vq[2 * jj] = hr ? __fma_rn(d0, e0, vq[2 * jj]) : d0 * e0;
                vq[2 * jj + 1] =
                    hr ? __fma_rn(d1, e1, vq[2 * jj + 1]) : d1 * e1;
                o0 = __fmul_rn(o0, gi2.x);
                o1 = __fmul_rn(o1, gi2.y);
              }
              sts32(stg + off, pack_bf16(o0, o1));
            }
          }
          if (bn) {
            tot[0][nb][h] += rowsum(vs, lane);
            tot[1][nb][h] += rowsum(vq, lane);
          }
        }
      }
      // The slot is written; with two slots the other one's store has read
      // it, so the next block may take it.
      fence_async_shared();
      if (tid == 0) bulk_wait_read<0>();
      bar_sync(1, CONSUMERS);
      if (tid == 0) {
        tma_store_2d(omap, stg, q0 + 64 * nb, static_cast<int>(p0));
        bulk_commit();
      }
      if (!DX) {
        // sum(y) and sum(y^2) over y as stored, from the slot: warp w's
        // rows w + 8 k in order, lane's columns 2 lane and 2 lane + 1
        // (rows past M hold 0: their a was zeroed or arrived as 0).
        double sy0 = 0.0, sy1 = 0.0, sq0 = 0.0, sq1 = 0.0;
#pragma unroll
        for (int k = 0; k < T / 8; ++k) {
          const uint32_t v = lds32(stg + swz(warp + 8 * k, lane >> 2) +
                                   4 * (lane & 3));
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&v));
          const double d0 = f.x, d1 = f.y;
          sy0 += d0;
          sy1 += d1;
          sq0 = __fma_rn(d0, d0, sq0);
          sq1 = __fma_rn(d1, d1, sq1);
        }
        tot[0][nb][0] += sy0;
        tot[0][nb][1] += sy1;
        tot[1][nb][0] += sq0;
        tot[1][nb][1] += sq1;
      }
    }
    // Every read of the x tile is behind the last barrier.
    if (xtile && tid == 0) mbar_arrive(xempty(it % a.xslots));
  }
  if (tid == 0) bulk_wait<0>();
  // The ring is idle now: every copy into it has landed and been read.
  if (sums)
    write_sums<DX, NB>(a, tot,
                       reinterpret_cast<double*>(smem_raw + (ring - raw)), q0);
}

template <int NB, bool RES>
__global__ void __launch_bounds__(TC_THREADS, 1)
flbn_fwd_tc_kernel(const RowArgs a, const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap,
                   const __grid_constant__ CUtensorMap ymap) {
  rows_body<false, NB, RES>(a, &xmap, nullptr, &wmap, nullptr, &ymap);
}

template <int NB, bool RES>
__global__ void __launch_bounds__(TC_THREADS, 1)
flbn_bwd_dx_tc_kernel(const RowArgs a,
                      const __grid_constant__ CUtensorMap dymap,
                      const __grid_constant__ CUtensorMap ymap,
                      const __grid_constant__ CUtensorMap wmap,
                      const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap dxmap) {
  rows_body<true, NB, RES>(a, &dymap, &ymap, &wmap, &xmap, &dxmap);
}

// The tile of a shape (R contracted, Q output channels): as wide as Q up
// to 256 columns (64 where Q is 64, so no zeros are multiplied; 128 in dx
// with bn, whose x tiles take shared memory), the weight slice resident
// where it fits in RES_MAX, and as many stages as shared memory then
// holds, with two staging tiles and, in dx with bn, two x tiles where
// three stages still fit.
struct RowPlan {
  int nb, nch, stages, stage_bytes, xslots, oslots, smem;
  bool res;
};

inline RowPlan row_plan(int R, int Q, bool dx, bool bn) {
  RowPlan p;
  p.nb = Q <= 64 ? 1 : (Q <= 128 || (dx && bn)) ? 2 : 4;
  const int bc = 64 * p.nb * ROW;
  p.nch = static_cast<int>(cdiv(R, 64));
  p.res = static_cast<long long>(p.nch) * bc <= RES_MAX;
  p.stage_bytes = TB * (dx ? 2 : 1) + (p.res ? 0 : bc);
  const int xb = dx && bn ? p.nb * static_cast<int>(TB) : 0;
  for (p.oslots = 2;; --p.oslots) {
    const int fixed = 1024 + (p.res ? p.nch * bc : 0) + p.oslots * TB +
                      (dx ? NCONST * 64 * p.nb * 4 : 0) + NBAR * 8;
    p.xslots = xb && fixed + 2 * xb + 3 * p.stage_bytes <= SMEM_LIMIT ? 2 : 1;
    const int left = SMEM_LIMIT - fixed - (xb ? p.xslots * xb : 0);
    p.stages = left / p.stage_bytes;
    if (p.stages > MAX_STAGES) p.stages = MAX_STAGES;
    p.smem = SMEM_LIMIT - left + p.stages * p.stage_bytes;
    if (p.stages >= 3 || p.oslots == 1) break;
  }
  return p;
}

// Pixels in one block's run: one block an SM over the output's column
// blocks.
inline long long run_rows(long long M, int R, int Q, bool dx, bool bn) {
  const RowPlan p = row_plan(R, Q, dx, bn);
  const long long tiles = cdiv(M, T);
  if (tiles == 0) return T;
  return bntc::tc_per(tiles, cdiv(Q, 64 * p.nb)) * T;
}

template <bool DX, int NB, bool RES>
int launch_inst(const RowArgs& a, const CUtensorMap (&maps)[5], int smem,
                dim3 grid, cudaStream_t s) {
  if constexpr (DX) {
    auto kernel = flbn_bwd_dx_tc_kernel<NB, RES>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, TC_THREADS, smem, s>>>(a, maps[0], maps[1], maps[2],
                                          maps[3], maps[4]);
  } else {
    auto kernel = flbn_fwd_tc_kernel<NB, RES>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, TC_THREADS, smem, s>>>(a, maps[0], maps[1], maps[2]);
  }
  return cudaGetLastError();
}

template <bool DX>
int launch(const RowArgs& a, const RowPlan& p, const CUtensorMap (&maps)[5],
           cudaStream_t s) {
  const dim3 grid(a.splits, static_cast<unsigned>(cdiv(a.Q, 64 * p.nb)));
  if (p.res)
    return p.nb == 1   ? launch_inst<DX, 1, true>(a, maps, p.smem, grid, s)
           : p.nb == 2 ? launch_inst<DX, 2, true>(a, maps, p.smem, grid, s)
                       : launch_inst<DX, 4, true>(a, maps, p.smem, grid, s);
  return p.nb == 1   ? launch_inst<DX, 1, false>(a, maps, p.smem, grid, s)
         : p.nb == 2 ? launch_inst<DX, 2, false>(a, maps, p.smem, grid, s)
                     : launch_inst<DX, 4, false>(a, maps, p.smem, grid, s);
}

inline RowArgs make_args(const float* mu, const float* inv,
                         const float* gamma, const float* beta,
                         const float* ds, const float* dss, double* part,
                         long long M, int R, int Q, bool relu, bool bn,
                         int splits, const RowPlan& p) {
  RowArgs a;
  a.mu = mu;
  a.inv = inv;
  a.gamma = gamma;
  a.beta = beta;
  a.ds = ds;
  a.dss = dss;
  a.part = part;
  a.M = M;
  a.R = R;
  a.Q = Q;
  a.per = static_cast<int>(cdiv(cdiv(M, T), splits));
  a.splits = splits;
  a.prologue = !bn ? bntc::NONE : relu ? bntc::AFFINE_RELU : bntc::AFFINE;
  a.nch = p.nch;
  a.stages = p.stages;
  a.stage_bytes = p.stage_bytes;
  a.xslots = p.xslots;
  a.oslots = p.oslots;
  return a;
}

}  // namespace rowtc

int launch_fwd_tc(const void* x, const void* w, const float* mu,
                  const float* inv, const float* gamma, const float* beta,
                  void* y, double* part, float* sum, float* sumsq,
                  long long M, int K, int N, bool relu, bool bn, int splits,
                  cudaStream_t s) {
  using namespace rowtc;
  if (M > 0x7FFFFFFFLL) return cudaErrorInvalidValue;  // TMA row coordinate
  if (M > 0) {
    const RowPlan p = row_plan(K, N, false, bn);
    const RowArgs a = make_args(mu, inv, gamma, beta, nullptr, nullptr, part,
                                M, K, N, relu, bn, splits, p);
    CUtensorMap maps[5];  // x, w, y
    int err = bntc::rows_map(&maps[0], x, M, K, T);
    if (err == cudaSuccess) err = bntc::rows_map(&maps[1], w, N, K, 64 * p.nb);
    if (err == cudaSuccess) err = bntc::rows_map(&maps[2], y, M, N, T);
    if (err == cudaSuccess) err = launch<false>(a, p, maps, s);
    if (err != cudaSuccess) return err;
  }
  return column_finish(part, sum, sumsq, N, M > 0 ? splits : 0, s);
}

int launch_bwd_dx_tc(const void* dy, const void* y, const float* ds,
                     const float* dss, const void* w, const void* x,
                     const float* mu, const float* inv, const float* gamma,
                     const float* beta, void* dx, double* part, float* dbeta,
                     float* dgamma, long long M, int K, int N, bool relu,
                     bool bn, int splits, cudaStream_t s) {
  using namespace rowtc;
  if (M > 0x7FFFFFFFLL) return cudaErrorInvalidValue;  // TMA row coordinate
  if (M > 0) {
    const RowPlan p = row_plan(N, K, true, bn);
    const RowArgs a = make_args(mu, inv, gamma, beta, ds, dss, part, M, N, K,
                                relu, bn, splits, p);
    CUtensorMap maps[5];  // dy, y, w, x, dx
    int err = bntc::rows_map(&maps[0], dy, M, N, T);
    if (err == cudaSuccess) err = bntc::rows_map(&maps[1], y, M, N, T);
    if (err == cudaSuccess) err = bntc::rows_map(&maps[2], w, N, K, 64);
    if (err == cudaSuccess) err = bntc::rows_map(&maps[3], x, M, K, T);
    if (err == cudaSuccess) err = bntc::rows_map(&maps[4], dx, M, K, T);
    if (err == cudaSuccess) err = launch<true>(a, p, maps, s);
    if (err != cudaSuccess) return err;
  }
  if (!bn) return cudaSuccess;
  return column_finish(part, dbeta, dgamma, K, M > 0 ? splits : 0, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Every entry point launches on
// ``stream`` without synchronising and returns the CUDA error of its
// launches (0 on success). With bn = 0 the vectors mu, inv, gamma, beta
// are not read and may be null.

// Pixels in one block's run of flbn_fwd (dx = 0, output Q = N) or
// flbn_bwd_dx (dx = 1, Q = K): the wrapper passes splits = cdiv(M, run)
// and sizes the (2, splits, Q) double workspace with it; block s sums its
// columns over pixels [s * run, (s + 1) * run). bf16 follows the card's SM
// count.
extern "C" long long flbn_run_rows(long long M, int K, int N, int dtype,
                                   int dx, int bn) {
  const int Q = dx ? K : N;
  if (dtype == 0)
    return M == 0 ? TILE : cdiv(cdiv(M, TILE), row_splits(M, Q)) * TILE;
  return dx ? rowtc::run_rows(M, N, K, true, bn != 0)
            : rowtc::run_rows(M, K, N, false, false);
}

// Contracted chunks of flbn_bwd_dw: its (splits, N, K) f32 workspace.
extern "C" int flbn_dw_splits(long long M, int K, int N, int dtype) {
  if (dtype == 0) return dw_splits(M, N, K, F32Engine::BR);
  return dwtc::dw_splits_tc(M, K, N);
}

extern "C" int flbn_fwd(const void* x, const void* w, const void* mu,
                        const void* inv, const void* gamma, const void* beta,
                        void* y, void* work, void* sum, void* sumsq,
                        long long M, int K, int N, int dtype, int relu,
                        int bn, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mu);
  const float* i = static_cast<const float*>(inv);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  double* part = static_cast<double*>(work);
  float* s0 = static_cast<float*>(sum);
  float* s1 = static_cast<float*>(sumsq);
  return dtype == 0
             ? launch_fwd<F32Engine>(x, w, m, i, g, b, y, part, s0, s1, M, K,
                                     N, relu != 0, bn != 0, splits, s)
             : launch_fwd_tc(x, w, m, i, g, b, y, part, s0, s1, M, K, N,
                             relu != 0, bn != 0, splits, s);
}

// dbeta, dgamma and work are not written with bn = 0 and may be null.
extern "C" int flbn_bwd_dx(const void* dy, const void* y, const void* ds,
                           const void* dss, const void* w, const void* x,
                           const void* mu, const void* inv,
                           const void* gamma, const void* beta, void* dx,
                           void* work, void* dbeta, void* dgamma, long long M,
                           int K, int N, int dtype, int relu, int bn,
                           int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* d0 = static_cast<const float*>(ds);
  const float* d1 = static_cast<const float*>(dss);
  const float* m = static_cast<const float*>(mu);
  const float* i = static_cast<const float*>(inv);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  double* part = static_cast<double*>(work);
  float* db = static_cast<float*>(dbeta);
  float* dg = static_cast<float*>(dgamma);
  return dtype == 0
             ? launch_bwd_dx<F32Engine>(dy, y, d0, d1, w, x, m, i, g, b, dx,
                                        part, db, dg, M, K, N, relu != 0,
                                        bn != 0, splits, s)
             : launch_bwd_dx_tc(dy, y, d0, d1, w, x, m, i, g, b, dx, part,
                                db, dg, M, K, N, relu != 0, bn != 0, splits,
                                s);
}

extern "C" int flbn_bwd_dw(const void* x, const void* mu, const void* inv,
                           const void* gamma, const void* beta,
                           const void* dy, const void* y, const void* ds,
                           const void* dss, void* work, void* dw, long long M,
                           int K, int N, int dtype, int relu, int bn,
                           int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mu);
  const float* i = static_cast<const float*>(inv);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  const float* d0 = static_cast<const float*>(ds);
  const float* d1 = static_cast<const float*>(dss);
  float* part = static_cast<float*>(work);
  return dtype == 0
             ? launch_bwd_dw<F32Engine>(x, m, i, g, b, dy, y, d0, d1, part,
                                        dw, M, K, N, relu != 0, bn != 0,
                                        splits, s)
             : launch_bwd_dw_tc(x, m, i, g, b, dy, y, d0, d1, part, dw, M,
                                K, N, relu != 0, bn != 0, splits, s);
}

extern "C" const char* flbn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
