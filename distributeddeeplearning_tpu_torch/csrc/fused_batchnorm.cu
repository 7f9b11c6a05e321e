// Fused BatchNorm(+residual)+ReLU for Hopper (sm_90a), written by hand.
//
// Four kernels on row-major (M, C) activations, M = N*H*W rows of C
// channels (the channels_last view of a convolution's output):
//
// - bn_stats:      replaces distributeddeeplearning_tpu/ops/
//                  fused_batchnorm.py:_stats_kernel (bn_stats). Per-channel
//                  sum(x) and sum(x^2) in f32 in one pass, then mean and the
//                  biased var = max(E[x^2] - mean^2, 0).
// - bn_apply:      replaces _apply_kernel (bn_apply). y = [relu]((x - mean)
//                  * (inv * gamma) + beta [+ res]) in f32, stored in x's type.
// - bn_bwd_reduce: replaces _bwd_reduce_kernel (bn_bwd_reduce). dz = relu ?
//                  dy * 1[y > 0] : dy; dbeta = sum(dz), dgamma = sum(dz * xh)
//                  with xh = (x - mean) * inv. y is read only with relu.
// - bn_bwd_dx:     replaces _bwd_dx_kernel (bn_bwd_dx). dx = gamma * inv *
//                  (dz - dbeta / M - xh * dgamma / M) and, when asked, the
//                  residual's cotangent dres = dz, both in x's type.
//
// What bounds them on the card: all four are memory-bound. Each reads its
// (M, C) operands once and writes its (M, C) outputs once, and does a few
// flops per element, far below the 295 flops per byte where an H100's
// arithmetic would start to limit. So their bound is those bytes over
// 3.35 TB/s, and the design is about streaming them at full width:
//
// - 16-byte loads and stores (8 bf16 or 4 f32 values), with neighbouring
//   threads on neighbouring channels of one row, so a warp reads whole
//   128-byte lines. The wrapper checks that C is a multiple of 8 and that
//   every operand is row-major and 16-byte aligned. Offsets are 64-bit.
// - The elementwise kernels (apply, bwd_dx) walk the rows in a grid-stride
//   loop whose stride is a whole number of rows, so each thread keeps one
//   group of channels: it reads its per-channel vectors once.
// - The reductions (stats, bwd_reduce) are column sums across blocks. The
//   Pallas grid summed over M in order in VMEM scratch; a GPU grid runs in
//   no order and one column tile (C = 64 at the stem) would fill one SM. So
//   M is split into up to 1024 row chunks (``splits``), each block sums its
//   chunk in f32 registers and then over its thread rows in shared memory
//   in a fixed order, and writes a (splits, C) partial. A second kernel sums
//   the partials in a fixed order. No atomics: the results repeat bit for
//   bit from run to run on one card.
//
// Arithmetic is f32 throughout, with the one-pass E[x^2] - mean^2 of the
// reference. The elementwise formulas use the _rn intrinsics in the
// reference's order of operations, so no multiply-add is contracted and
// the kernels round as the plain PyTorch versions do.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;     // threads per block of the main kernels
constexpr int MAX_SPLITS = 1024; // row chunks of a reduction
constexpr int MIN_PASSES = 8;    // rows each thread of a chunk sums at least
constexpr int FIN_X = 32;        // finish kernel: channels per block
constexpr int FIN_Y = 32;        //                split groups per block

// 16 bytes of one row.
template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ void load(const float* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}

__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// Block shape of a reduction: L lanes across channels (each V channels
// wide), R thread rows, L * R <= THREADS; ``tiles`` blocks cover C.
struct ReduceLayout {
  int lanes, rows, tiles;
};

ReduceLayout reduce_layout(int C, int V) {
  const int vecs = C / V;
  ReduceLayout l;
  l.lanes = vecs < 32 ? vecs : 32;
  l.rows = THREADS / l.lanes;
  l.tiles = (vecs + l.lanes - 1) / l.lanes;
  return l;
}

// Row chunks of a reduction: enough blocks to fill the card (about
// MAX_SPLITS in all), while each thread still sums MIN_PASSES rows or more.
int reduce_splits(long long M, int C, int V) {
  const ReduceLayout l = reduce_layout(C, V);
  long long want = (MAX_SPLITS + l.tiles - 1) / l.tiles;
  long long cap = M / (static_cast<long long>(l.rows) * MIN_PASSES);
  if (cap < 1) cap = 1;
  const long long s = want < cap ? want : cap;
  const long long per = (M + s - 1) / s;
  return static_cast<int>((M + per - 1) / per);
}

// Sums each thread's V columns of acc over the block's thread rows in a
// fixed order and writes them to out[c0 .. c0 + V) (thread row 0 only).
template <int V>
__device__ __forceinline__ void block_column_sum(const float (&acc)[V],
                                                 float* sh, float* out,
                                                 bool active) {
  const int width = blockDim.x * V;
  float* mine = sh + threadIdx.y * width + threadIdx.x * V;
#pragma unroll
  for (int j = 0; j < V; ++j) mine[j] = acc[j];
  __syncthreads();
  if (threadIdx.y == 0 && active) {
    float s[V];
#pragma unroll
    for (int j = 0; j < V; ++j) s[j] = 0.f;
    for (int r = 0; r < blockDim.y; ++r) {
      const float* row = sh + r * width + threadIdx.x * V;
#pragma unroll
      for (int j = 0; j < V; ++j) s[j] = __fadd_rn(s[j], row[j]);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = s[j];
  }
  __syncthreads();
}

// Partial sums of x and x^2 over rows [split * per, ...) of the block's
// column tile: part[0][split][c], part[1][split][c].
template <typename T>
__global__ void __launch_bounds__(THREADS)
bn_stats_partial_kernel(const T* __restrict__ x, float* __restrict__ part,
                        long long M, int C, long long per, int splits) {
  constexpr int V = Vec<T>::N;
  __shared__ float sh[THREADS * V];
  const int vec = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = vec * V < C;
  const long long c0 = static_cast<long long>(vec) * V;
  float s[V], q[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s[j] = q[j] = 0.f;
  const long long begin = blockIdx.y * per;
  const long long end = begin + per < M ? begin + per : M;
  if (active) {
    for (long long r = begin + threadIdx.y; r < end; r += blockDim.y) {
      float v[V];
      load(x + r * C + c0, v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s[j] = __fadd_rn(s[j], v[j]);
        q[j] = __fadd_rn(q[j], __fmul_rn(v[j], v[j]));
      }
    }
  }
  const long long at = static_cast<long long>(blockIdx.y) * C + c0;
  block_column_sum<V>(s, sh, part + at, active);
  block_column_sum<V>(q, sh, part + static_cast<long long>(splits) * C + at,
                      active);
}

// Partial sums of dz and dz * xh; y is read only with RELU.
template <typename T, bool RELU>
__global__ void __launch_bounds__(THREADS)
bn_bwd_reduce_partial_kernel(const T* __restrict__ dy,
                             const T* __restrict__ y,
                             const T* __restrict__ x,
                             const float* __restrict__ mean,
                             const float* __restrict__ inv,
                             float* __restrict__ part, long long M, int C,
                             long long per, int splits) {
  constexpr int V = Vec<T>::N;
  __shared__ float sh[THREADS * V];
  const int vec = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = vec * V < C;
  const long long c0 = static_cast<long long>(vec) * V;
  float db[V], dg[V], mu[V], iv[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    db[j] = dg[j] = 0.f;
    mu[j] = active ? mean[c0 + j] : 0.f;
    iv[j] = active ? inv[c0 + j] : 0.f;
  }
  const long long begin = blockIdx.y * per;
  const long long end = begin + per < M ? begin + per : M;
  if (active) {
    for (long long r = begin + threadIdx.y; r < end; r += blockDim.y) {
      const long long off = r * C + c0;
      float g[V], xv[V];
      load(dy + off, g);
      load(x + off, xv);
      if (RELU) {
        float yv[V];
        load(y + off, yv);
#pragma unroll
        for (int j = 0; j < V; ++j) g[j] = yv[j] > 0.f ? g[j] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xh = __fmul_rn(__fsub_rn(xv[j], mu[j]), iv[j]);
        db[j] = __fadd_rn(db[j], g[j]);
        dg[j] = __fadd_rn(dg[j], __fmul_rn(g[j], xh));
      }
    }
  }
  const long long at = static_cast<long long>(blockIdx.y) * C + c0;
  block_column_sum<V>(db, sh, part + at, active);
  block_column_sum<V>(dg, sh, part + static_cast<long long>(splits) * C + at,
                      active);
}

// Sums the (2, splits, C) partials over splits in a fixed order. STATS:
// out0 = mean = sum / M, out1 = max(sumsq / M - mean^2, 0); else out0 and
// out1 are the two sums.
template <bool STATS>
__global__ void __launch_bounds__(FIN_X * FIN_Y)
bn_finish_kernel(const float* __restrict__ part, float* __restrict__ out0,
                 float* __restrict__ out1, long long M, int C, int splits) {
  __shared__ float sh[2][FIN_Y][FIN_X + 1];
  const int c = blockIdx.x * FIN_X + threadIdx.x;
  float a = 0.f, b = 0.f;
  if (c < C) {
    const float* p0 = part + c;
    const float* p1 = part + static_cast<long long>(splits) * C + c;
    for (int s = threadIdx.y; s < splits; s += FIN_Y) {
      a = __fadd_rn(a, p0[static_cast<long long>(s) * C]);
      b = __fadd_rn(b, p1[static_cast<long long>(s) * C]);
    }
  }
  sh[0][threadIdx.y][threadIdx.x] = a;
  sh[1][threadIdx.y][threadIdx.x] = b;
  __syncthreads();
  if (threadIdx.y != 0 || c >= C) return;
  a = b = 0.f;
  for (int r = 0; r < FIN_Y; ++r) {
    a = __fadd_rn(a, sh[0][r][threadIdx.x]);
    b = __fadd_rn(b, sh[1][r][threadIdx.x]);
  }
  if (STATS) {
    const float m = static_cast<float>(M);
    const float mean = __fdiv_rn(a, m);
    out0[c] = mean;
    out1[c] = fmaxf(__fsub_rn(__fdiv_rn(b, m), __fmul_rn(mean, mean)), 0.f);
  } else {
    out0[c] = a;
    out1[c] = b;
  }
}

// The rows of one grid-stride pass: a whole number of rows, so each thread
// keeps the V channels of lane g % lanes. Threads past the last whole row
// of a pass have nothing to do.
struct RowWalk {
  long long row, step;
  long long c0;
  bool active;
};

template <int V>
__device__ __forceinline__ RowWalk row_walk(int C) {
  const int lanes = C / V;
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long threads = static_cast<long long>(gridDim.x) * blockDim.x;
  RowWalk w;
  w.step = threads / lanes;
  w.row = g / lanes;
  w.c0 = static_cast<long long>(g % lanes) * V;
  w.active = w.row < w.step;
  return w;
}

template <typename T, bool RELU, bool RES>
__global__ void __launch_bounds__(THREADS)
bn_apply_kernel(const T* __restrict__ x, const T* __restrict__ res,
                const float* __restrict__ mean, const float* __restrict__ inv,
                const float* __restrict__ gamma,
                const float* __restrict__ beta, T* __restrict__ y,
                long long M, int C) {
  constexpr int V = Vec<T>::N;
  const RowWalk w = row_walk<V>(C);
  if (!w.active) return;
  float mu[V], a[V], b[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    mu[j] = mean[w.c0 + j];
    a[j] = __fmul_rn(inv[w.c0 + j], gamma[w.c0 + j]);
    b[j] = beta[w.c0 + j];
  }
  for (long long r = w.row; r < M; r += w.step) {
    const long long off = r * C + w.c0;
    float v[V];
    load(x + off, v);
    float rv[V];
    if (RES) load(res + off, rv);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float t = __fadd_rn(__fmul_rn(__fsub_rn(v[j], mu[j]), a[j]), b[j]);
      if (RES) t = __fadd_rn(t, rv[j]);
      if (RELU) t = fmaxf(t, 0.f);
      v[j] = t;
    }
    store(y + off, v);
  }
}

template <typename T, bool RELU, bool DRES>
__global__ void __launch_bounds__(THREADS)
bn_bwd_dx_kernel(const T* __restrict__ dy, const T* __restrict__ y,
                 const T* __restrict__ x, const float* __restrict__ mean,
                 const float* __restrict__ inv,
                 const float* __restrict__ gamma,
                 const float* __restrict__ dbeta,
                 const float* __restrict__ dgamma, T* __restrict__ dx,
                 T* __restrict__ dres, long long M, int C) {
  constexpr int V = Vec<T>::N;
  const RowWalk w = row_walk<V>(C);
  if (!w.active) return;
  const float m = static_cast<float>(M);
  float mu[V], iv[V], c1[V], c2[V], c3[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const long long c = w.c0 + j;
    mu[j] = mean[c];
    iv[j] = inv[c];
    c1[j] = __fmul_rn(gamma[c], inv[c]);
    c2[j] = __fdiv_rn(dbeta[c], m);
    c3[j] = __fdiv_rn(dgamma[c], m);
  }
  for (long long r = w.row; r < M; r += w.step) {
    const long long off = r * C + w.c0;
    float g[V], xv[V];
    load(dy + off, g);
    load(x + off, xv);
    if (RELU) {
      float yv[V];
      load(y + off, yv);
#pragma unroll
      for (int j = 0; j < V; ++j) g[j] = yv[j] > 0.f ? g[j] : 0.f;
    }
    if (DRES) store(dres + off, g);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float xh = __fmul_rn(__fsub_rn(xv[j], mu[j]), iv[j]);
      xv[j] = __fmul_rn(c1[j], __fsub_rn(__fsub_rn(g[j], c2[j]),
                                         __fmul_rn(xh, c3[j])));
    }
    store(dx + off, xv);
  }
}

int vec_of(int dtype) { return dtype == 0 ? Vec<float>::N
                                          : Vec<__nv_bfloat16>::N; }

template <typename T>
int launch_stats(const void* x, float* part, float* mean, float* var,
                 long long M, int C, int splits, cudaStream_t s) {
  const ReduceLayout l = reduce_layout(C, Vec<T>::N);
  const long long per = (M + splits - 1) / splits;
  bn_stats_partial_kernel<T><<<dim3(l.tiles, splits),
                               dim3(l.lanes, l.rows), 0, s>>>(
      static_cast<const T*>(x), part, M, C, per, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_finish_kernel<true><<<(C + FIN_X - 1) / FIN_X, dim3(FIN_X, FIN_Y), 0,
                           s>>>(part, mean, var, M, C, splits);
  return cudaGetLastError();
}

template <typename T>
int launch_bwd_reduce(const void* dy, const void* y, const void* x,
                      const float* mean, const float* inv, float* part,
                      float* dbeta, float* dgamma, long long M, int C,
                      bool relu, int splits, cudaStream_t s) {
  const ReduceLayout l = reduce_layout(C, Vec<T>::N);
  const long long per = (M + splits - 1) / splits;
  const dim3 grid(l.tiles, splits), block(l.lanes, l.rows);
  const T* dyp = static_cast<const T*>(dy);
  const T* yp = static_cast<const T*>(y);
  const T* xp = static_cast<const T*>(x);
  if (relu)
    bn_bwd_reduce_partial_kernel<T, true><<<grid, block, 0, s>>>(
        dyp, yp, xp, mean, inv, part, M, C, per, splits);
  else
    bn_bwd_reduce_partial_kernel<T, false><<<grid, block, 0, s>>>(
        dyp, yp, xp, mean, inv, part, M, C, per, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_finish_kernel<false><<<(C + FIN_X - 1) / FIN_X, dim3(FIN_X, FIN_Y), 0,
                            s>>>(part, dbeta, dgamma, M, C, splits);
  return cudaGetLastError();
}

template <typename T, bool RELU>
void apply_res(bool res, int blocks, cudaStream_t s, const T* x, const T* r,
               const float* mean, const float* inv, const float* gamma,
               const float* beta, T* y, long long M, int C) {
  if (res)
    bn_apply_kernel<T, RELU, true><<<blocks, THREADS, 0, s>>>(
        x, r, mean, inv, gamma, beta, y, M, C);
  else
    bn_apply_kernel<T, RELU, false><<<blocks, THREADS, 0, s>>>(
        x, r, mean, inv, gamma, beta, y, M, C);
}

template <typename T>
int launch_apply(const void* x, const void* res, const float* mean,
                 const float* inv, const float* gamma, const float* beta,
                 void* y, long long M, int C, bool relu, int blocks,
                 cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const T* rp = static_cast<const T*>(res);
  T* yp = static_cast<T*>(y);
  if (relu)
    apply_res<T, true>(rp != nullptr, blocks, s, xp, rp, mean, inv, gamma,
                       beta, yp, M, C);
  else
    apply_res<T, false>(rp != nullptr, blocks, s, xp, rp, mean, inv, gamma,
                        beta, yp, M, C);
  return cudaGetLastError();
}

template <typename T, bool RELU>
void dx_dres(bool want_dres, int blocks, cudaStream_t s, const T* dy,
             const T* y, const T* x, const float* mean, const float* inv,
             const float* gamma, const float* dbeta, const float* dgamma,
             T* dx, T* dres, long long M, int C) {
  if (want_dres)
    bn_bwd_dx_kernel<T, RELU, true><<<blocks, THREADS, 0, s>>>(
        dy, y, x, mean, inv, gamma, dbeta, dgamma, dx, dres, M, C);
  else
    bn_bwd_dx_kernel<T, RELU, false><<<blocks, THREADS, 0, s>>>(
        dy, y, x, mean, inv, gamma, dbeta, dgamma, dx, dres, M, C);
}

template <typename T>
int launch_bwd_dx(const void* dy, const void* y, const void* x,
                  const float* mean, const float* inv, const float* gamma,
                  const float* dbeta, const float* dgamma, void* dx,
                  void* dres, long long M, int C, bool relu, int blocks,
                  cudaStream_t s) {
  const T* dyp = static_cast<const T*>(dy);
  const T* yp = static_cast<const T*>(y);
  const T* xp = static_cast<const T*>(x);
  T* dxp = static_cast<T*>(dx);
  T* drp = static_cast<T*>(dres);
  if (relu)
    dx_dres<T, true>(drp != nullptr, blocks, s, dyp, yp, xp, mean, inv,
                     gamma, dbeta, dgamma, dxp, drp, M, C);
  else
    dx_dres<T, false>(drp != nullptr, blocks, s, dyp, yp, xp, mean, inv,
                      gamma, dbeta, dgamma, dxp, drp, M, C);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Every entry point launches on
// ``stream`` without synchronising and returns the CUDA error of its
// launches (0 on success).

// Row chunks that bn_stats and bn_bwd_reduce split M into: the wrapper
// sizes their (2, splits, C) f32 workspace with it.
extern "C" int fused_bn_splits(long long M, int C, int dtype) {
  return reduce_splits(M, C, vec_of(dtype));
}

extern "C" int fused_bn_stats(const void* x, void* work, void* mean,
                              void* var, long long M, int C, int dtype,
                              int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(work);
  float* m = static_cast<float*>(mean);
  float* v = static_cast<float*>(var);
  return dtype == 0
             ? launch_stats<float>(x, part, m, v, M, C, splits, s)
             : launch_stats<__nv_bfloat16>(x, part, m, v, M, C, splits, s);
}

// res may be null (no residual).
extern "C" int fused_bn_apply(const void* x, const void* res,
                              const void* mean, const void* inv,
                              const void* gamma, const void* beta, void* y,
                              long long M, int C, int dtype, int relu,
                              int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* i = static_cast<const float*>(inv);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  return dtype == 0
             ? launch_apply<float>(x, res, m, i, g, b, y, M, C, relu != 0,
                                   blocks, s)
             : launch_apply<__nv_bfloat16>(x, res, m, i, g, b, y, M, C,
                                           relu != 0, blocks, s);
}

// y may be null when relu is 0.
extern "C" int fused_bn_bwd_reduce(const void* dy, const void* y,
                                   const void* x, const void* mean,
                                   const void* inv, void* work, void* dbeta,
                                   void* dgamma, long long M, int C,
                                   int dtype, int relu, int splits,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* i = static_cast<const float*>(inv);
  float* part = static_cast<float*>(work);
  float* db = static_cast<float*>(dbeta);
  float* dg = static_cast<float*>(dgamma);
  return dtype == 0
             ? launch_bwd_reduce<float>(dy, y, x, m, i, part, db, dg, M, C,
                                        relu != 0, splits, s)
             : launch_bwd_reduce<__nv_bfloat16>(dy, y, x, m, i, part, db, dg,
                                                M, C, relu != 0, splits, s);
}

// y may be null when relu is 0; dres null means no residual cotangent.
extern "C" int fused_bn_bwd_dx(const void* dy, const void* y, const void* x,
                               const void* mean, const void* inv,
                               const void* gamma, const void* dbeta,
                               const void* dgamma, void* dx, void* dres,
                               long long M, int C, int dtype, int relu,
                               int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* i = static_cast<const float*>(inv);
  const float* g = static_cast<const float*>(gamma);
  const float* db = static_cast<const float*>(dbeta);
  const float* dg = static_cast<const float*>(dgamma);
  return dtype == 0
             ? launch_bwd_dx<float>(dy, y, x, m, i, g, db, dg, dx, dres, M,
                                    C, relu != 0, blocks, s)
             : launch_bwd_dx<__nv_bfloat16>(dy, y, x, m, i, g, db, dg, dx,
                                            dres, M, C, relu != 0, blocks,
                                            s);
}

extern "C" const char* fused_bn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
