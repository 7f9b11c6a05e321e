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
// - One generic tile product: a 128 x 128 output tile of 256 threads over
//   a contracted axis cut in BR-deep steps. Each operand tile is loaded
//   from a row-major source with 16-byte loads, either along its rows
//   (x, w in the forward; dy in dx) or across them (w in dx; dy and x in
//   dw, whose contracted axis is M), transformed elementwise on the way
//   (the BatchNorm prologue, or dY), rounded to the storage type and
//   stored in shared memory. The next step's loads are issued before the
//   current step's products.
//   The tile product and the three kernels' bodies live in bn_gemm.cuh,
//   shared with the 3x3 kernels of fused_conv_bn.cu.
// - bf16: tensor cores by mma.sync.m16n8k16 with f32 accumulators, 8 warps
//   of 64 x 32, two blocks an SM. f32: FMA on the CUDA cores (no TF32),
//   8 x 8 outputs a thread.
// - Reductions over M without atomics. The forward and dx kernels give
//   each block a fixed run of row tiles; after each tile it sums its
//   columns over each thread's rows in registers, then over its 16 thread
//   row groups in shared memory in a fixed order, into one running total a
//   column; it writes a (splits, C) partial that a second kernel sums in a
//   fixed order. These column sums (sum(y), sum(y^2), dbeta, dgamma) run in
//   double and round to f32 once: each term (an f32, or the product of
//   two) is exact in double, so the sums are about as good as f32 can hold.
//   In f32 their error carried through E[y^2] - mean^2 into the gradients:
//   an f32 ResNet-50 step was 2.7x as far from its f64 step as the unfused
//   one in the 2-norm, and with exact sums it is as far. dw cuts M into
//   fixed chunks, each block writes its (N, K) f32 partial, and a second
//   kernel sums them in order and rounds. The results repeat bit for bit
//   from run to run on one card.
// - M is any size (bounds checks, zero fill); K and N are multiples of 8,
//   the operands 16-byte aligned (the wrapper checks).
//
// The prologue and epilogue formulas use the _rn intrinsics in the
// reference's order of operations, so no multiply-add is contracted there
// and they round as the plain PyTorch versions do.

#include "bn_gemm.cuh"

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Every entry point launches on
// ``stream`` without synchronising and returns the CUDA error of its
// launches (0 on success). With bn = 0 the vectors mu, inv, gamma, beta
// are not read and may be null.

// Row-tile runs of flbn_fwd (Q = N) and flbn_bwd_dx (Q = K): the wrapper
// sizes their (2, splits, Q) double workspace with it.
extern "C" int flbn_row_splits(long long M, int Q) { return row_splits(M, Q); }

// Contracted chunks of flbn_bwd_dw: its (splits, N, K) f32 workspace.
extern "C" int flbn_dw_splits(long long M, int K, int N, int dtype) {
  return dw_splits(M, N, K, dtype == 0 ? F32Engine::BR : Bf16Engine::BR);
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
             : launch_fwd<Bf16Engine>(x, w, m, i, g, b, y, part, s0, s1, M,
                                      K, N, relu != 0, bn != 0, splits, s);
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
             : launch_bwd_dx<Bf16Engine>(dy, y, d0, d1, w, x, m, i, g, b, dx,
                                         part, db, dg, M, K, N, relu != 0,
                                         bn != 0, splits, s);
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
             : launch_bwd_dw<Bf16Engine>(x, m, i, g, b, dy, y, d0, d1, part,
                                         dw, M, K, N, relu != 0, bn != 0,
                                         splits, s);
}

extern "C" const char* flbn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
