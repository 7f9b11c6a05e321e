// 3x3 convolution (stride 1, pad 1) with a BatchNorm prologue and a
// statistics epilogue for Hopper (sm_90a), written by hand: the spatial
// convolution of a ResNet bottleneck, fed the raw conv1 output.
//
// Layouts: x (B, H, W, Cin) and y (B, H, W, Cout), channels-last and
// contiguous, so pixel m = (b * H + h) * W + w is a row of M = B*H*W; the
// weight w (Cout, 3, 3, Cin) (the port's (Cout, Cin, 3, 3) weight in
// channels_last memory); per-channel f32 vectors mu, inv (= rsqrt(var +
// eps)), gamma, beta of length Cin and ds, dss of length Cout. Three
// kernels:
//
// - fcbn_fwd:    replaces distributeddeeplearning_tpu/ops/fused_conv_bn.py:
//                _fwd_kernel. a = relu((x - mu) * (inv * gamma) + beta)
//                rounded to x's type (a = x with bn off), 0 outside the
//                image (SAME padding of the normalised activations); y =
//                conv3x3(a, w) rounded to x's type; the columns' sum(y) and
//                sum(y^2) over y as stored.
// - fcbn_bwd_dx: replaces _bwd_dx_kernel. dY = dy + ds + 2 y dss rounded to
//                the type, 0 outside the image; da = conv3x3(dY, flip(w)^T);
//                with bn, xh = (x - mu) * inv, the ReLU mask z = xh * gamma
//                + beta > 0, dx = dz * (gamma * inv) and the columns' dbeta
//                = sum(dz), dgamma = sum(dz * xh); without, dx = da.
// - fcbn_bwd_dw: replaces _bwd_dw_kernel. dw = patches(a)^T @ dY in w's
//                (Cout, 3, 3, Cin) layout, a and dY recomputed from x and y.
//
// What bounds them on the card: each does 2 * M * 9 * Cin * Cout flops
// against its bytes (each activation, the weight and the vectors once). At
// each of ResNet-50's 13 stride-1 3x3s (batch 512) that is 118 GFLOP a
// kernel. At stage 1 (56 x 56, 64 channels) the forward moves 0.41 GB in
// bf16, 288 flops a byte, at the tensor cores' balance point (295), and dx
// and dw, which read three activations (dx also writes one: 0.82 GB), are
// bound by their bytes; at the wider stages the bytes shrink (0.06 GB at 7
// x 7, 512 channels) and the tensor cores bound all three.
//
// bf16: wgmma on the tensor cores (conv3x3_tc.cuh, on sm90.cuh and
// bn_tc.cuh), fcbn_fwd_tc_kernel, fcbn_bwd_dx_tc_kernel and
// fcbn_bwd_dw_tc_kernel.
// - A halo slab per pixel tile. A persistent block walks a fixed run of
//   tiles of T pixels (256 in the forward, 128 in dx and dw). For each
//   64-channel chunk it copies the rows the tile's nine taps read (2 W + T
//   + 2 from p0 - W - 1, or three runs of T + 2 for an image wider than the
//   tile) into shared memory by TMA, 128-byte-swizzled, and transforms
//   them once, in place, rounded to bf16: bn1's prologue over x (forward,
//   dw), dY = dy + ds + 2 y dss over dy from the y slab beside it (dx). A
//   tap (ty, tx) is then the slab shifted by ty * W + tx rows: the nine
//   taps read each element from shared memory, none from device memory
//   again, and none repeats the transform. Out-of-image taps are masked per
//   pixel (nine bits from its (h, w), computed once per tile with a
//   multiply-high division), since prologue(0) != 0 and dY(0) = ds != 0
//   make zero-filled rows no padding.
// - The shifted operand is the register one. A wgmma descriptor cannot
//   start mid swizzle atom, and a tap's shift is any number of rows, so
//   the slab side of every product is taken by ldmatrix (any row address)
//   into the A registers and masked there; the other side is read through
//   a descriptor that no tap moves. Forward: A = the slab (pixels x
//   channels), B = the tap's weight tile (Cout block x 64 channels,
//   K-major). dx: the forward's product with dY for a and flip(w)^T for w:
//   A = the dY slab, B = w[n][8 - tap][c] over a chunk of 64 n, which is
//   one TMA box of the (Cout, 9, Cin) weight at tap 8 - tap, read MN-major
//   (its rows are the contracted n), so no flipped copy is made. dw: A =
//   the slab transposed by ldmatrix.trans (channels x pixels, the mask on
//   half-registers since the pixel is the contracted index), B = the
//   tile's dY (pixels x Cout block, MN-major), formed once in place of dy.
// - No zero half, no repeated work. The forward's N is Cout in blocks of 64
//   (two a block above 64 channels), dx's N is Cin the same way; dw's
//   block owns 64 input x 64 output channels and all nine taps, one row of
//   taps per warpgroup, so each tile's x, dy and y are read and transformed
//   once per block.
// - Loads and pipelines. One warp issues the TMA copies and an mbarrier per
//   stage reports them: two slab stages (the next chunk's loads in flight
//   while this one's products run); the forward and dx keep all nine
//   weight tiles resident when Cin and Cout are 64 or less (stage 1: 72 KB)
//   and otherwise stream them three taps ahead through a ring of four. The
//   products run as a software pipeline: the next batch's fragments load
//   while this batch's wgmmas run, two register buffers taking turns.
// - The forward's epilogue stages each 64-column block of y, rounded to
//   bf16, in the free slab stage, writes it by one TMA store, and sums its
//   columns (y and y^2, over y as stored) in double from the same tile.
//   dx's is the 1x1 dx's (#9, bn_tc.cuh's dx_block): x's tile of the
//   block's columns arrives by TMA during the products, the constants sit
//   in shared memory, dz = da masked by z > 0 is scaled by gamma inv,
//   rounded to bf16 into the free stage (block nb in its slab nb) and
//   stored by TMA, which clips rows past M (their taps are all masked, so
//   they add nothing to the sums); dbeta and dgamma are summed in double by
//   a fixed shuffle reduce-scatter over each warp's rows and run on in
//   registers over the block's tiles.
// - dx's shared memory. dx needs y beside dy and x's tile for the
//   epilogue, so it takes tiles of 128 pixels (the forward 256, whose two
//   48 KB slab stages and 72 KB of weights leave no room for a y slab and
//   x's tile): a stage is a dy and a y slab (2 W + 130 rows, rounded to
//   64), 32 KB each at stage 1, 24 KB at the other stages. Stage 1 (64 ->
//   64, resident weights): 72 + 2 x 64 + 16 (x) + 1.3 (constants) = 218
//   KB; stages 2-4 (two 64-column blocks, streamed weights): 64 + 2 x 48 +
//   32 + 2.5 = 196 KB. A wider image falls back to streamed weights, one
//   column block, then one stage (dx_plan), down to 194 KB at three runs
//   of 192 rows. Neither the other layouts considered (y in one stage of
//   its own, x's tile in the free stage) was needed to fit, nor timed.
// - What bounds dx as built: its steps are serial within a tile (the dY
//   transform, the products, then the epilogue), with only the loads in
//   flight beside them. On an H100 (700 W) at stage 1 it takes 0.53 ms,
//   2.2x its byte bound, and copies with one step removed take 0.30 ms
//   without the epilogue, 0.32 without the products and 0.46 without dY:
//   the three add up to the whole. The epilogue (double sums and shuffles
//   over 8 warps) reads all its shared memory first and has bn and the
//   ReLU fixed at compile time; with runtime branches and interleaved
//   reads and writes the kernel took 0.62 ms. The wider stages sit at
//   3.1-3.5x their operation bound (m64n64k16 from registers, a block
//   barrier per streamed weight tile).
// - Budgets (ptxas, -Xptxas -v). Forward: 256 threads, up to 255 registers;
//   32 MT NB accumulator registers (MT: 64-pixel blocks a warpgroup, 2 at
//   T = 256) and two fragment buffers of 4 MT KSB; 166 registers at stage
//   1's <MT 2, NB 1, resident>, 241 at <2, 2, streamed>, no spills. dw: 384
//   threads, 168 registers (the cap) = 96 accumulators + 24 fragment + 40
//   per-channel constants + addressing, and ptxas spills 52 bytes. dx: 256
//   threads, 32 NB accumulators, 4 NB doubles of running sums, 16 dY
//   constants; 184 registers at stage 1's <NB 1, resident>, 194 at <1,
//   streamed>, 239 at <2, streamed>, no spills. Shared memory: fwd_smem,
//   dx_smem and dw_smem; at
//   ResNet-50's four shapes the forward takes 177 KB (stage 1) or 153 KB,
//   dw 130 KB (stage 1) or 114 KB.
//
// f32: the first design, on the FMA tile product of bn_gemm.cuh.
//
// - Implicit GEMM. Each product runs over the (M, 9 * C) im2col matrix
//   without materialising it: a source fetches 16 bytes of column k = tap *
//   C + c (tap = 3 * dy + dx) of row m from pixel (h + dy - 1, w + dx - 1)
//   of m's own image, so a tap that leaves the image (column -1 of a row,
//   row -1 of an image) reads nothing and stores 0, after the prologue, as
//   the reference's zeroed halo does. C % 8 == 0, so a 16-byte vector never
//   straddles two taps. Neighbouring rows of a tile are neighbouring
//   pixels, so the nine taps of a tile reread the same lines through L1/L2.
// - dx reads flip(w)^T in place: element (k = tap * Cout + n, c) of the
//   contracted weight is w[n][8 - tap][c].
//
// Reductions without atomics, in every instance: the forward and dx give
// each block a fixed run of pixel tiles (fcbn_fwd_run_rows,
// fcbn_bwd_dx_run_rows) and sum its columns in double into a (splits, C)
// partial that a second kernel sums in a fixed order; dw cuts M into fixed
// chunks whose f32 partials a second kernel sums in order. The results
// repeat bit for bit from run to run on one card (the bf16 kernels size
// their grids by its SM count).
//
// M < 2^31 (the wrapper checks); Cin and Cout multiples of 8; operands
// 16-byte aligned.

#include "bn_gemm.cuh"
#include "conv3x3_tc.cuh"

namespace {

// The implicit im2col matrix of a 3x3, stride-1, pad-1 convolution of a
// (B, H, W, C) source: rows = M pixels, cols = 9 * C. The values are
// transformed as Source's (KIND, per channel c) and are 0 where the tap
// leaves the image.
template <typename T, int KIND>
struct ConvSource : Source<T, KIND> {
  using Base = Source<T, KIND>;
  using typename Base::Frag;
  using typename Base::Raw;
  int H, W, C;

  __device__ __forceinline__ void fetch(long long row, int col,
                                        Frag& f) const {
    const int tap = col / C;
    const int c = col - tap * C;
    f.col = c;
    f.ok = false;
    if (row >= this->rows || tap >= 9) return;
    const int dy = tap / 3 - 1, dx = tap - 3 * (tap / 3) - 1;
    const int m = static_cast<int>(row);
    const int rem = m % (H * W);
    const int h = rem / W + dy, w = rem % W + dx;
    if (h < 0 || h >= H || w < 0 || w >= W) return;
    f.ok = true;
    const long long off = static_cast<long long>(m + dy * W + dx) * C + c;
    f.a = *reinterpret_cast<const Raw*>(this->a + off);
    if constexpr (KIND == DY)
      f.y = *reinterpret_cast<const Raw*>(this->y + off);
  }
};

// flip(w)^T of a (Cout, 3, 3, Cin) weight as the (9 * Cout, Cin) matrix
// the dx product contracts: row k = tap * Cout + n, column c holds
// w[n][8 - tap][c].
template <typename T>
struct FlipSource : Source<T, IDENT> {
  using Base = Source<T, IDENT>;
  using typename Base::Frag;
  using typename Base::Raw;
  int Cout;

  __device__ __forceinline__ void fetch(long long row, int col,
                                        Frag& f) const {
    f.col = col;
    f.ok = row < this->rows && col < this->cols;
    if (!f.ok) return;
    const int k = static_cast<int>(row);
    const int tap = k / Cout, n = k - tap * Cout;
    const long long off =
        (static_cast<long long>(n) * 9 + 8 - tap) * this->cols + col;
    f.a = *reinterpret_cast<const Raw*>(this->a + off);
  }
};

template <class E, int AK>
__global__ void __launch_bounds__(THREADS, E::MIN_BLOCKS)
fcbn_fwd_kernel(const typename E::T* __restrict__ x,
                const typename E::T* __restrict__ w,
                const float* __restrict__ mu, const float* __restrict__ inv,
                const float* __restrict__ gamma,
                const float* __restrict__ beta, typename E::T* __restrict__ y,
                double* __restrict__ part, long long M, int H, int W,
                int Cin, int Cout, int splits) {
  using T = typename E::T;
  __shared__ __align__(16) unsigned char smem[smem_bytes<E>()];
  const ConvSource<T, AK> A{{x, nullptr, mu, inv, gamma, beta, M, 9 * Cin},
                            H, W, Cin};
  const Source<T, IDENT> B{w, nullptr, nullptr, nullptr, nullptr, nullptr,
                           Cout, 9 * Cin};
  fwd_body<E>(A, B, y, part, M, 9 * Cin, Cout, splits, smem);
}

template <class E, bool BN, bool RELU>
__global__ void __launch_bounds__(THREADS, E::MIN_BLOCKS)
fcbn_bwd_dx_kernel(const typename E::T* __restrict__ dy,
                   const typename E::T* __restrict__ yv,
                   const float* __restrict__ ds, const float* __restrict__ dss,
                   const typename E::T* __restrict__ w,
                   const typename E::T* __restrict__ x,
                   const float* __restrict__ mu,
                   const float* __restrict__ inv,
                   const float* __restrict__ gamma,
                   const float* __restrict__ beta,
                   typename E::T* __restrict__ dx, double* __restrict__ part,
                   long long M, int H, int W, int Cin, int Cout,
                   int splits) {
  using T = typename E::T;
  __shared__ __align__(16) unsigned char smem[smem_bytes<E>()];
  const ConvSource<T, DY> A{{dy, yv, ds, dss, nullptr, nullptr, M, 9 * Cout},
                            H, W, Cout};
  // Read across its rows: the tile's rows are c.
  const FlipSource<T> B{{w, nullptr, nullptr, nullptr, nullptr, nullptr,
                         9 * Cout, Cin}, Cout};
  bwd_dx_body<E, BN, RELU>(A, B, x, mu, inv, gamma, beta, dx, part, M, Cin,
                           9 * Cout, splits, smem);
}

template <class E, int XK>
__global__ void __launch_bounds__(THREADS, E::MIN_BLOCKS)
fcbn_bwd_dw_kernel(const typename E::T* __restrict__ x,
                   const float* __restrict__ mu,
                   const float* __restrict__ inv,
                   const float* __restrict__ gamma,
                   const float* __restrict__ beta,
                   const typename E::T* __restrict__ dy,
                   const typename E::T* __restrict__ yv,
                   const float* __restrict__ ds,
                   const float* __restrict__ dss, float* __restrict__ work,
                   long long M, int H, int W, int Cin, int Cout, int splits) {
  using T = typename E::T;
  __shared__ __align__(16) unsigned char smem[E::SMEM];
  // Both read across their rows (the contracted index is M): the A tile's
  // rows are n, the B tile's k = tap * Cin + c.
  const Source<T, DY> A{dy, yv, ds, dss, nullptr, nullptr, M, Cout};
  const ConvSource<T, XK> B{{x, nullptr, mu, inv, gamma, beta, M, 9 * Cin},
                            H, W, Cin};
  bwd_dw_body<E>(A, B, work, M, Cout, 9 * Cin, splits, smem);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fcbn_dw_finish_kernel(const float* __restrict__ work, T* __restrict__ dw,
                      long long NK, int splits) {
  dw_finish_body(work, dw, NK, splits);
}

__global__ void __launch_bounds__(FIN_X * FIN_Y)
fcbn_column_finish_kernel(const double* __restrict__ part,
                          float* __restrict__ out0, float* __restrict__ out1,
                          int C, int splits) {
  column_finish_body(part, out0, out1, C, splits);
}

int column_finish(const double* part, float* out0, float* out1, int C,
                  int splits, cudaStream_t s) {
  fcbn_column_finish_kernel<<<(C + FIN_X - 1) / FIN_X, dim3(FIN_X, FIN_Y), 0,
                              s>>>(part, out0, out1, C, splits);
  return cudaGetLastError();
}

template <class E>
int launch_fwd(const void* x, const void* w, const float* mu,
               const float* inv, const float* gamma, const float* beta,
               void* y, double* part, float* sum, float* sumsq, long long M,
               int H, int W, int Cin, int Cout, bool relu, bool bn,
               int splits, cudaStream_t s) {
  using T = typename E::T;
  const dim3 grid(cdiv(Cout, TILE), splits);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* yp = static_cast<T*>(y);
  if (!bn)
    fcbn_fwd_kernel<E, IDENT><<<grid, THREADS, 0, s>>>(
        xp, wp, mu, inv, gamma, beta, yp, part, M, H, W, Cin, Cout, splits);
  else if (relu)
    fcbn_fwd_kernel<E, AFFINE_RELU><<<grid, THREADS, 0, s>>>(
        xp, wp, mu, inv, gamma, beta, yp, part, M, H, W, Cin, Cout, splits);
  else
    fcbn_fwd_kernel<E, AFFINE><<<grid, THREADS, 0, s>>>(
        xp, wp, mu, inv, gamma, beta, yp, part, M, H, W, Cin, Cout, splits);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return column_finish(part, sum, sumsq, Cout, splits, s);
}

template <class E>
int launch_bwd_dx(const void* dy, const void* y, const float* ds,
                  const float* dss, const void* w, const void* x,
                  const float* mu, const float* inv, const float* gamma,
                  const float* beta, void* dx, double* part, float* dbeta,
                  float* dgamma, long long M, int H, int W, int Cin, int Cout,
                  bool relu, bool bn, int splits, cudaStream_t s) {
  using T = typename E::T;
  const dim3 grid(cdiv(Cin, TILE), splits);
  const T* dyp = static_cast<const T*>(dy);
  const T* yp = static_cast<const T*>(y);
  const T* wp = static_cast<const T*>(w);
  const T* xp = static_cast<const T*>(x);
  T* dxp = static_cast<T*>(dx);
  if (!bn)
    fcbn_bwd_dx_kernel<E, false, false><<<grid, THREADS, 0, s>>>(
        dyp, yp, ds, dss, wp, xp, mu, inv, gamma, beta, dxp, part, M, H, W,
        Cin, Cout, splits);
  else if (relu)
    fcbn_bwd_dx_kernel<E, true, true><<<grid, THREADS, 0, s>>>(
        dyp, yp, ds, dss, wp, xp, mu, inv, gamma, beta, dxp, part, M, H, W,
        Cin, Cout, splits);
  else
    fcbn_bwd_dx_kernel<E, true, false><<<grid, THREADS, 0, s>>>(
        dyp, yp, ds, dss, wp, xp, mu, inv, gamma, beta, dxp, part, M, H, W,
        Cin, Cout, splits);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !bn) return err;
  return column_finish(part, dbeta, dgamma, Cin, splits, s);
}

template <class E>
int launch_bwd_dw(const void* x, const float* mu, const float* inv,
                  const float* gamma, const float* beta, const void* dy,
                  const void* y, const float* ds, const float* dss,
                  float* work, void* dw, long long M, int H, int W, int Cin,
                  int Cout, bool relu, bool bn, int splits, cudaStream_t s) {
  using T = typename E::T;
  const dim3 grid(cdiv(9 * Cin, TILE), cdiv(Cout, TILE), splits);
  const T* xp = static_cast<const T*>(x);
  const T* dyp = static_cast<const T*>(dy);
  const T* yp = static_cast<const T*>(y);
  if (!bn)
    fcbn_bwd_dw_kernel<E, IDENT><<<grid, THREADS, 0, s>>>(
        xp, mu, inv, gamma, beta, dyp, yp, ds, dss, work, M, H, W, Cin, Cout,
        splits);
  else if (relu)
    fcbn_bwd_dw_kernel<E, AFFINE_RELU><<<grid, THREADS, 0, s>>>(
        xp, mu, inv, gamma, beta, dyp, yp, ds, dss, work, M, H, W, Cin, Cout,
        splits);
  else
    fcbn_bwd_dw_kernel<E, AFFINE><<<grid, THREADS, 0, s>>>(
        xp, mu, inv, gamma, beta, dyp, yp, ds, dss, work, M, H, W, Cin, Cout,
        splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long nk = 9LL * Cin * Cout;
  long long blocks = cdiv(nk, THREADS);
  if (blocks > 4096) blocks = 4096;
  fcbn_dw_finish_kernel<T><<<static_cast<int>(blocks), THREADS, 0, s>>>(
      work, static_cast<T*>(dw), nk, splits);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (conv3x3_tc.cuh)
// ---------------------------------------------------------------------------

using bntc::rows_map;
using bntc::tc_per;
using bntc::tensor_map;

// The forward's instance for a shape: NB blocks of 64 output channels a
// block (2 above 64), the nine weight tiles resident when Cin and Cout fit
// one 64-wide tile, and tiles of 256 pixels unless the slab of a wide
// image then overflows shared memory.
struct FwdPlan {
  int mt, nb, T, slab_bytes, smem;
  bool res;
  conv3::Slab slab;
};

FwdPlan fwd_plan(int W, int Cin, int Cout) {
  FwdPlan p;
  p.nb = Cout <= 64 ? 1 : 2;
  p.res = p.nb == 1 && Cin <= 64;
  for (p.mt = 2; p.mt >= 1; --p.mt) {
    p.T = 128 * p.mt;
    p.slab = conv3::make_slab(p.T, W);
    p.slab_bytes = conv3::fwd_slab_bytes(p.slab);
    p.smem = conv3::fwd_smem(p.nb, p.res, p.slab_bytes);
    if (p.smem <= conv3::SMEM_LIMIT || p.mt == 1) break;
  }
  return p;
}

template <int MT, int NB, bool RES>
int launch_fwd_tc_inst(const conv3::FwdArgs& a, const CUtensorMap (&maps)[3],
                       int smem, dim3 grid, cudaStream_t s) {
  auto kernel = conv3::fcbn_fwd_tc_kernel<MT, NB, RES>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, conv3::FWD_THREADS, smem, s>>>(a, maps[0], maps[1],
                                                  maps[2]);
  return cudaGetLastError();
}

int launch_fwd_tc(const void* x, const void* w, const float* mu,
                  const float* inv, const float* gamma, const float* beta,
                  void* y, double* part, float* sum, float* sumsq,
                  long long M, int H, int W, int Cin, int Cout, bool relu,
                  bool bn, int splits, cudaStream_t s) {
  const FwdPlan p = fwd_plan(W, Cin, Cout);
  conv3::FwdArgs a;
  a.x = static_cast<const conv3::bf16*>(x);
  a.w = static_cast<const conv3::bf16*>(w);
  a.mu = mu;
  a.inv = inv;
  a.gamma = gamma;
  a.beta = beta;
  a.y = static_cast<conv3::bf16*>(y);
  a.part = part;
  a.M = M;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.Cout = Cout;
  a.divH = conv3::make_div(H);
  a.divW = conv3::make_div(W);
  a.nc = static_cast<int>(cdiv(Cin, 64));
  a.per = static_cast<int>(cdiv(cdiv(M, p.T), splits));
  a.splits = splits;
  a.prologue = !bn ? conv3::NONE : relu ? conv3::AFFINE_RELU : conv3::AFFINE;
  a.slab = p.slab;
  a.slab_bytes = p.slab_bytes;
  CUtensorMap maps[3];  // x, w, y
  int err = rows_map(&maps[0], x, M, Cin, conv3::BOXR);
  if (err == cudaSuccess) err = rows_map(&maps[2], y, M, Cout, p.T);
  if (err != cudaSuccess) return err;
  // w (Cout, 9, Cin): boxes of 64 channels of one tap of NB * 64 rows.
  const cuuint64_t wdims[3] = {static_cast<cuuint64_t>(Cin), 9,
                               static_cast<cuuint64_t>(Cout)};
  const cuuint64_t wstrides[2] = {static_cast<cuuint64_t>(Cin) * 2,
                                  static_cast<cuuint64_t>(Cin) * 18};
  const cuuint32_t wbox[3] = {64, 1, static_cast<cuuint32_t>(64 * p.nb)};
  err = tensor_map(&maps[1], w, 3, wdims, wstrides, wbox);
  if (err != cudaSuccess) return err;
  const dim3 grid(splits, static_cast<unsigned>(cdiv(Cout, 64 * p.nb)));
  if (p.res)
    err = p.mt == 2 ? launch_fwd_tc_inst<2, 1, true>(a, maps, p.smem, grid, s)
                    : launch_fwd_tc_inst<1, 1, true>(a, maps, p.smem, grid, s);
  else if (p.nb == 1)
    err = p.mt == 2 ? launch_fwd_tc_inst<2, 1, false>(a, maps, p.smem, grid, s)
                    : launch_fwd_tc_inst<1, 1, false>(a, maps, p.smem, grid,
                                                      s);
  else
    err = p.mt == 2 ? launch_fwd_tc_inst<2, 2, false>(a, maps, p.smem, grid, s)
                    : launch_fwd_tc_inst<1, 2, false>(a, maps, p.smem, grid,
                                                      s);
  if (err != cudaSuccess) return err;
  return column_finish(part, sum, sumsq, Cout, splits, s);
}

// dx's instance for a shape: NB blocks of 64 input channels a block (2
// above 64), the nine weight tiles resident when Cin and Cout fit one
// 64-wide tile, two slab stages; where that overflows shared memory (an
// image wide enough for a long slab), in this order of preference:
// streamed weights, one column block, then one stage.
struct DxPlan {
  int nb, stages, slab_bytes, smem;
  bool res;
  conv3::Slab slab;
};

DxPlan dx_plan(int W, int Cin, int Cout) {
  DxPlan p;
  p.slab = conv3::make_slab(conv3::DX_T, W);
  p.slab_bytes = conv3::round_up(p.slab.rows * conv3::ROW, 1024);
  const int nb = Cin <= 64 ? 1 : 2;
  const int res = nb == 1 && Cout <= 64;
  // (NB, RES, stages); the last one always fits (a slab of at most three
  // runs of 192 rows: 194 KB).
  const int order[6][3] = {{nb, res, 2}, {nb, 0, 2}, {1, 0, 2},
                           {nb, res, 1}, {nb, 0, 1}, {1, 0, 1}};
  for (const auto& o : order) {
    p.nb = o[0];
    p.res = o[1] != 0;
    p.stages = o[2];
    p.smem = conv3::dx_smem(p.nb, p.res, p.stages, p.slab_bytes);
    if (p.smem <= conv3::SMEM_LIMIT) break;
  }
  return p;
}

template <int NB, bool RES>
int launch_dx_tc_inst(const conv3::DxArgs& a, const CUtensorMap (&maps)[5],
                      int smem, dim3 grid, cudaStream_t s) {
  auto kernel = conv3::fcbn_bwd_dx_tc_kernel<NB, RES>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, conv3::FWD_THREADS, smem, s>>>(a, maps[0], maps[1], maps[2],
                                                  maps[3], maps[4]);
  return cudaGetLastError();
}

int launch_bwd_dx_tc(const void* dy, const void* y, const float* ds,
                     const float* dss, const void* w, const void* x,
                     const float* mu, const float* inv, const float* gamma,
                     const float* beta, void* dx, double* part, float* dbeta,
                     float* dgamma, long long M, int H, int W, int Cin,
                     int Cout, bool relu, bool bn, int splits,
                     cudaStream_t s) {
  if (M > 0) {
    const DxPlan p = dx_plan(W, Cin, Cout);
    conv3::DxArgs a;
    a.mu = mu;
    a.inv = inv;
    a.gamma = gamma;
    a.beta = beta;
    a.ds = ds;
    a.dss = dss;
    a.part = part;
    a.M = M;
    a.H = H;
    a.W = W;
    a.Cin = Cin;
    a.Cout = Cout;
    a.divH = conv3::make_div(H);
    a.divW = conv3::make_div(W);
    a.nc = static_cast<int>(cdiv(Cout, 64));
    a.per = static_cast<int>(cdiv(cdiv(M, conv3::DX_T), splits));
    a.splits = splits;
    a.bn = bn;
    a.relu = relu;
    a.stages = p.stages;
    a.slab = p.slab;
    a.slab_bytes = p.slab_bytes;
    CUtensorMap maps[5];  // dy, y, w, x, dx
    int err = rows_map(&maps[0], dy, M, Cout, conv3::BOXR);
    if (err == cudaSuccess) err = rows_map(&maps[1], y, M, Cout, conv3::BOXR);
    if (err == cudaSuccess) {
      // w (Cout, 9, Cin): boxes of 64 input channels of one tap of 64
      // output channels (the contracted index).
      const cuuint64_t wdims[3] = {static_cast<cuuint64_t>(Cin), 9,
                                   static_cast<cuuint64_t>(Cout)};
      const cuuint64_t wstrides[2] = {static_cast<cuuint64_t>(Cin) * 2,
                                      static_cast<cuuint64_t>(Cin) * 18};
      const cuuint32_t wbox[3] = {64, 1, 64};
      err = tensor_map(&maps[2], w, 3, wdims, wstrides, wbox);
    }
    if (err == cudaSuccess)
      err = rows_map(&maps[3], x, M, Cin, conv3::DX_T);
    if (err == cudaSuccess)
      err = rows_map(&maps[4], dx, M, Cin, conv3::DX_T);
    if (err != cudaSuccess) return err;
    const dim3 grid(splits, static_cast<unsigned>(cdiv(Cin, 64 * p.nb)));
    err = p.res       ? launch_dx_tc_inst<1, true>(a, maps, p.smem, grid, s)
          : p.nb == 1 ? launch_dx_tc_inst<1, false>(a, maps, p.smem, grid, s)
                      : launch_dx_tc_inst<2, false>(a, maps, p.smem, grid, s);
    if (err != cudaSuccess) return err;
  }
  if (!bn) return cudaSuccess;
  return column_finish(part, dbeta, dgamma, Cin, M > 0 ? splits : 0, s);
}

long long dw_tc_per(long long M, int Cin, int Cout) {
  return tc_per(cdiv(M, conv3::DW_T), cdiv(Cin, 64) * cdiv(Cout, 64));
}

int launch_bwd_dw_tc(const void* x, const float* mu, const float* inv,
                     const float* gamma, const float* beta, const void* dy,
                     const void* y, const float* ds, const float* dss,
                     float* work, void* dw, long long M, int H, int W,
                     int Cin, int Cout, bool relu, bool bn, int splits,
                     cudaStream_t s) {
  conv3::DwArgs a;
  a.x = static_cast<const conv3::bf16*>(x);
  a.mu = mu;
  a.inv = inv;
  a.gamma = gamma;
  a.beta = beta;
  a.dy = static_cast<const conv3::bf16*>(dy);
  a.y = static_cast<const conv3::bf16*>(y);
  a.ds = ds;
  a.dss = dss;
  a.work = work;
  a.M = M;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.Cout = Cout;
  a.divH = conv3::make_div(H);
  a.divW = conv3::make_div(W);
  a.per = static_cast<int>(cdiv(cdiv(M, conv3::DW_T), splits));
  a.prologue = !bn ? conv3::NONE : relu ? conv3::AFFINE_RELU : conv3::AFFINE;
  a.slab = conv3::make_slab(conv3::DW_T, W);
  a.slab_bytes = conv3::round_up(a.slab.rows * conv3::ROW, 1024);
  const int smem = conv3::dw_smem(a.slab_bytes);
  CUtensorMap xmap, dymap, ymap;
  int map_err = rows_map(&xmap, x, M, Cin, conv3::BOXR);
  if (map_err == cudaSuccess)
    map_err = rows_map(&dymap, dy, M, Cout, conv3::DW_T);
  if (map_err == cudaSuccess)
    map_err = rows_map(&ymap, y, M, Cout, conv3::DW_T);
  if (map_err != cudaSuccess) return map_err;
  cudaError_t err = cudaFuncSetAttribute(
      conv3::fcbn_bwd_dw_tc_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(splits, static_cast<unsigned>(cdiv(Cin, 64)),
                  static_cast<unsigned>(cdiv(Cout, 64)));
  conv3::fcbn_bwd_dw_tc_kernel<<<grid, conv3::DW_THREADS, smem, s>>>(
      a, xmap, dymap, ymap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long nk = 9LL * Cin * Cout;
  long long blocks = cdiv(nk, THREADS);
  if (blocks > 4096) blocks = 4096;
  fcbn_dw_finish_kernel<conv3::bf16>
      <<<static_cast<int>(blocks), THREADS, 0, s>>>(
          work, static_cast<conv3::bf16*>(dw), nk, splits);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. M = B * H * W. Every entry point
// launches on ``stream`` without synchronising and returns the CUDA error
// of its launches (0 on success). With bn = 0 the vectors mu, inv, gamma,
// beta are not read and may be null.

// Pixels in one block's run of fcbn_fwd: the wrapper passes splits =
// cdiv(M, run) and sizes the (2, splits, Cout) double workspace with it;
// block s sums its columns over pixels [s * run, (s + 1) * run).
extern "C" long long fcbn_fwd_run_rows(long long M, int W, int Cin, int Cout,
                                       int dtype) {
  if (dtype == 0) return cdiv(cdiv(M, TILE), row_splits(M, Cout)) * TILE;
  const FwdPlan p = fwd_plan(W, Cin, Cout);
  return tc_per(cdiv(M, p.T), cdiv(Cout, 64 * p.nb)) * p.T;
}

// Pixels in one block's run of fcbn_bwd_dx, as fcbn_fwd_run_rows: block s
// sums dbeta and dgamma over pixels [s * run, (s + 1) * run) into row s of
// the (2, splits, Cin) double workspace.
extern "C" long long fcbn_bwd_dx_run_rows(long long M, int W, int Cin,
                                          int Cout, int dtype) {
  if (dtype == 0) return cdiv(cdiv(M, TILE), row_splits(M, Cin)) * TILE;
  const long long tiles = cdiv(M, conv3::DX_T);
  if (tiles == 0) return conv3::DX_T;
  const DxPlan p = dx_plan(W, Cin, Cout);
  return tc_per(tiles, cdiv(Cin, 64 * p.nb)) * conv3::DX_T;
}

// Contracted chunks of fcbn_bwd_dw: its (splits, Cout, 9 * Cin) f32
// workspace.
extern "C" int fcbn_dw_splits(long long M, int Cin, int Cout, int dtype) {
  if (dtype == 0) return dw_splits(M, Cout, 9 * Cin, F32Engine::BR);
  const long long tiles = cdiv(M, conv3::DW_T);
  return static_cast<int>(cdiv(tiles, dw_tc_per(M, Cin, Cout)));
}

extern "C" int fcbn_fwd(const void* x, const void* w, const void* mu,
                        const void* inv, const void* gamma, const void* beta,
                        void* y, void* work, void* sum, void* sumsq,
                        long long M, int H, int W, int Cin, int Cout,
                        int dtype, int relu, int bn, int splits,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mu);
  const float* i = static_cast<const float*>(inv);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  double* part = static_cast<double*>(work);
  float* s0 = static_cast<float*>(sum);
  float* s1 = static_cast<float*>(sumsq);
  return dtype == 0
             ? launch_fwd<F32Engine>(x, w, m, i, g, b, y, part, s0, s1, M, H,
                                     W, Cin, Cout, relu != 0, bn != 0, splits,
                                     s)
             : launch_fwd_tc(x, w, m, i, g, b, y, part, s0, s1, M, H, W,
                             Cin, Cout, relu != 0, bn != 0, splits, s);
}

// dbeta, dgamma and work are not written with bn = 0 and may be null.
extern "C" int fcbn_bwd_dx(const void* dy, const void* y, const void* ds,
                           const void* dss, const void* w, const void* x,
                           const void* mu, const void* inv,
                           const void* gamma, const void* beta, void* dx,
                           void* work, void* dbeta, void* dgamma, long long M,
                           int H, int W, int Cin, int Cout, int dtype,
                           int relu, int bn, int splits, void* stream) {
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
                                        part, db, dg, M, H, W, Cin, Cout,
                                        relu != 0, bn != 0, splits, s)
             : launch_bwd_dx_tc(dy, y, d0, d1, w, x, m, i, g, b, dx, part,
                                db, dg, M, H, W, Cin, Cout, relu != 0,
                                bn != 0, splits, s);
}

extern "C" int fcbn_bwd_dw(const void* x, const void* mu, const void* inv,
                           const void* gamma, const void* beta,
                           const void* dy, const void* y, const void* ds,
                           const void* dss, void* work, void* dw, long long M,
                           int H, int W, int Cin, int Cout, int dtype,
                           int relu, int bn, int splits, void* stream) {
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
                                        dw, M, H, W, Cin, Cout, relu != 0,
                                        bn != 0, splits, s)
             : launch_bwd_dw_tc(x, m, i, g, b, dy, y, d0, d1, part, dw, M,
                                H, W, Cin, Cout, relu != 0, bn != 0, splits,
                                s);
}

extern "C" const char* fcbn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
