// The f32 tile product shared by the port's BatchNorm-carrying GEMMs for
// Hopper (sm_90a): the f32 instances of the matmul kernels of
// fused_linear_bn.cu (a bottleneck's 1x1 convolutions, #8-#10) and of the
// implicit-GEMM 3x3 kernels of fused_conv_bn.cu (#11-#13). Every bf16
// instance runs on wgmma instead (bn_tc.cuh, conv3x3_tc.cuh, sm90.cuh);
// nothing here serves bf16 but dw_finish_body's rounding of the tensor-core
// dw kernels' f32 partials, and column_finish_body.
//
// An operand is a *source*: a struct with Source's interface (a Frag of
// registers, fetch(row, col, frag) issuing one vector's global load,
// apply(frag, out) transforming it). Source reads a row-major (rows, cols)
// matrix; fused_conv_bn.cu adds sources that read the implicit im2col
// matrix of a 3x3 convolution. The engine (F32Engine) loads a source's
// tiles into shared memory (along or across its rows), runs the product on
// the CUDA cores (FMA) and hands each output pair to an epilogue. The
// *_body functions below are the three kernels' bodies over any sources;
// each .cu builds its sources and calls them from its own __global__
// kernels, which keep their names in a profile. See fused_linear_bn.cu's
// note for the design and its reasons.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 128;           // output tile: TILE x TILE
constexpr int GROUPS = 16;          // thread row groups sharing a column
constexpr int TARGET_BLOCKS = 1024; // blocks a reduction over M aims for
constexpr int MIN_STEPS = 8;        // dw: contracted steps a chunk at least
constexpr int RED_BYTES = 2 * GROUPS * TILE * 8;
constexpr int FIN_X = 32;           // column finish: channels per block
constexpr int FIN_Y = 32;           //                split groups per block
static_assert(THREADS == 2 * TILE, "two threads a column in column_accumulate");

// Source operand kinds: how an element is transformed on its way to
// shared memory.
enum Kind { IDENT = 0, AFFINE = 1, AFFINE_RELU = 2, DY = 3 };

template <typename T> struct Vec;
template <> struct Vec<float> {
  using Raw = float4;
  static constexpr int N = 4;
};

__device__ __forceinline__ void unpack(const float4& r, float (&v)[4]) {
  v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
}

template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) {
  return v;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void load2(const float* p, float (&v)[2]) {
  const float2 f = *reinterpret_cast<const float2*>(p);
  v[0] = f.x; v[1] = f.y;
}

__device__ __forceinline__ void from_float(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// A row-major (rows, cols) source of an operand tile and its transform.
// The per-channel vectors are indexed by the source's column: AFFINE(_RELU)
// v0..v3 = mu, inv, gamma, beta; DY v0, v1 = ds, dss and y the second
// (rows, cols) input.
template <typename T, int KIND>
struct Source {
  using Raw = typename Vec<T>::Raw;
  static constexpr int V = Vec<T>::N;
  const T* a;
  const T* y;
  const float* v0;
  const float* v1;
  const float* v2;
  const float* v3;
  long long rows;
  int cols;

  struct Frag {
    Raw a, y;
    int col;
    bool ok;
  };

  // V elements of one row from column ``col`` (a multiple of V; cols is a
  // multiple of 8, so a vector is in or out whole).
  __device__ __forceinline__ void fetch(long long row, int col,
                                        Frag& f) const {
    f.col = col;
    f.ok = row < rows && col < cols;
    if (f.ok) {
      const long long off = row * cols + col;
      f.a = *reinterpret_cast<const Raw*>(a + off);
      if constexpr (KIND == DY) f.y = *reinterpret_cast<const Raw*>(y + off);
    }
  }

  // The transformed values, rounded to T; 0 outside the source.
  __device__ __forceinline__ void apply(const Frag& f, float (&out)[V]) const {
    if (!f.ok) {
#pragma unroll
      for (int j = 0; j < V; ++j) out[j] = 0.f;
      return;
    }
    unpack(f.a, out);
    if constexpr (KIND == DY) {
      float yv[V];
      unpack(f.y, yv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int c = f.col + j;
        const float twice_y_dss = __fmul_rn(__fmul_rn(2.f, yv[j]), v1[c]);
        out[j] = round_to<T>(__fadd_rn(__fadd_rn(out[j], v0[c]), twice_y_dss));
      }
    } else if constexpr (KIND != IDENT) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int c = f.col + j;
        float t = __fadd_rn(__fmul_rn(__fsub_rn(out[j], v0[c]),
                                      __fmul_rn(v1[c], v2[c])),
                            v3[c]);
        if constexpr (KIND == AFFINE_RELU) t = fmaxf(t, 0.f);
        out[j] = round_to<T>(t);
      }
    }
  }
};

// f32 tile product on the CUDA cores. Tiles are stored [BR][PITCH] with the
// output index contiguous; a thread owns rows ty*4 + {0..3}, 64 + ty*4 +
// {0..3} and the same of columns by tx.
struct F32Engine {
  using T = float;
  static constexpr int BR = 16;
  static constexpr int PITCH = TILE + 4;
  static constexpr int TILE_ELEMS = BR * PITCH;
  static constexpr int SMEM = 2 * TILE_ELEMS * 4;
  static constexpr int SLOTS = 4;
  static constexpr int MIN_BLOCKS = 1;

  float acc[8][8];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  template <class Src, bool TRANS>
  struct Loader {
    typename Src::Frag f[2];

    __device__ __forceinline__ void fetch(const Src& s, long long r0,
                                          long long k0) {
      const int tid = threadIdx.x;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (!TRANS)
          s.fetch(r0 + tid / 4 + 64 * i,
                  static_cast<int>(k0) + (tid % 4) * 4, f[i]);
        else
          s.fetch(k0 + tid / 32 + 8 * i,
                  static_cast<int>(r0) + (tid % 32) * 4, f[i]);
      }
    }

    __device__ __forceinline__ void commit(const Src& s, T* tile) const {
      const int tid = threadIdx.x;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float v[4];
        s.apply(f[i], v);
        if (!TRANS) {
          const int r = tid / 4 + 64 * i, k = (tid % 4) * 4;
#pragma unroll
          for (int j = 0; j < 4; ++j) tile[(k + j) * PITCH + r] = v[j];
        } else {
          *reinterpret_cast<float4*>(tile + (tid / 32 + 8 * i) * PITCH +
                                     (tid % 32) * 4) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
      }
    }
  };

  __device__ __forceinline__ void compute(const T* sa, const T* sb) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int k = 0; k < BR; ++k) {
      const float* ra = sa + k * PITCH + ty * 4;
      const float* rb = sb + k * PITCH + tx * 4;
      const float4 a0 = *reinterpret_cast<const float4*>(ra);
      const float4 a1 = *reinterpret_cast<const float4*>(ra + 64);
      const float4 b0 = *reinterpret_cast<const float4*>(rb);
      const float4 b1 = *reinterpret_cast<const float4*>(rb + 64);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  template <class F>
  __device__ __forceinline__ void for_pairs(F&& f) const {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int s = 0; s < SLOTS; ++s)
        f((i < 4 ? 0 : 64) + ty * 4 + (i & 3), slot_col_of(tx, s), s,
          acc[i][2 * s], acc[i][2 * s + 1]);
  }

  static __device__ __forceinline__ int slot_col_of(int tx, int slot) {
    return (slot < 2 ? 0 : 64) + tx * 4 + 2 * (slot & 1);
  }

  static __device__ __forceinline__ int slot_col(int slot) {
    return slot_col_of(threadIdx.x % 16, slot);
  }

  static __device__ __forceinline__ int group() { return threadIdx.x / 16; }
};

// acc += A @ B^T over the contracted range [r_begin, r_end) in BR steps:
// A's tile rows from a0, B's from b0. The next step's global loads are in
// flight while the current step's products run.
template <bool TA, bool TB, class E, class SA, class SB>
__device__ __forceinline__ void gemm(E& e, const SA& a, long long a0,
                                     const SB& b, long long b0,
                                     long long r_begin, long long r_end,
                                     typename E::T* sa, typename E::T* sb) {
  typename E::template Loader<SA, TA> la;
  typename E::template Loader<SB, TB> lb;
  if (r_begin < r_end) {
    la.fetch(a, a0, r_begin);
    lb.fetch(b, b0, r_begin);
  }
  for (long long r = r_begin; r < r_end; r += E::BR) {
    la.commit(a, sa);
    lb.commit(b, sb);
    __syncthreads();
    if (r + E::BR < r_end) {
      la.fetch(a, a0, r + E::BR);
      lb.fetch(b, b0, r + E::BR);
    }
    e.compute(sa, sb);
    __syncthreads();
  }
}

// Adds one tile's two column sums (c0, c1: per owned column pair, over the
// thread's rows) over the 16 thread row groups, in a fixed order, to
// ``total`` of thread (which, q) = (tid / TILE, tid % TILE): column q's sum
// c0 (which 0) or c1 (which 1). Only this tile's sums are live in
// registers, so the GEMM's main loop keeps its registers. Shared memory is
// free for reuse on return.
template <class E>
__device__ __forceinline__ void column_accumulate(
    const double (&c0)[E::SLOTS][2], const double (&c1)[E::SLOTS][2],
    double* red, double& total) {
  const int grp = E::group();
#pragma unroll
  for (int s = 0; s < E::SLOTS; ++s) {
    const int q = E::slot_col(s);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      red[grp * TILE + q + c] = c0[s][c];
      red[(GROUPS + grp) * TILE + q + c] = c1[s][c];
    }
  }
  __syncthreads();
  const int which = threadIdx.x / TILE, q = threadIdx.x % TILE;
  for (int g = 0; g < GROUPS; ++g)
    total += red[(which * GROUPS + g) * TILE + q];
  __syncthreads();
}

// The block's column sums: thread (which, q)'s total to
// part[which][split][q0 + q].
__device__ __forceinline__ void column_write(double total, double* part,
                                             int splits, int split, int q0,
                                             int Q) {
  const int which = threadIdx.x / TILE, q = threadIdx.x % TILE;
  if (q0 + q < Q)
    part[(static_cast<long long>(which) * splits + split) * Q + q0 + q] =
        total;
}

// The run of row tiles of block ``split``: [begin, end).
__device__ __forceinline__ void tile_run(long long M, int splits, int split,
                                         long long& begin, long long& end) {
  const long long tiles = (M + TILE - 1) / TILE;
  const long long per = (tiles + splits - 1) / splits;
  begin = split * per;
  end = begin + per < tiles ? begin + per : tiles;
}

template <class E>
__host__ __device__ constexpr int smem_bytes() {
  return E::SMEM > RED_BYTES ? E::SMEM : RED_BYTES;
}

// Forward body: y (M, N) = A (M, R) @ B (N, R)^T rounded to T, and the
// columns' sum(y) and sum(y^2) over y as stored, in double, as block
// (blockIdx.x: column tile, blockIdx.y: split)'s row of part[2][splits][N].
template <class E, class SA, class SB>
__device__ __forceinline__ void fwd_body(const SA& A, const SB& B,
                                         typename E::T* __restrict__ y,
                                         double* __restrict__ part,
                                         long long M, int R, int N,
                                         int splits, unsigned char* smem) {
  using T = typename E::T;
  T* sa = reinterpret_cast<T*>(smem);
  T* sb = sa + E::TILE_ELEMS;
  const int q0 = blockIdx.x * TILE, split = blockIdx.y;
  long long begin, end;
  tile_run(M, splits, split, begin, end);
  double total = 0.0;
  for (long long tile = begin; tile < end; ++tile) {
    const long long p0 = tile * TILE;
    E e;
    e.zero();
    gemm<false, false>(e, A, p0, B, q0, 0, R, sa, sb);
    double s[E::SLOTS][2] = {}, ss[E::SLOTS][2] = {};
    e.for_pairs([&](int p, int q, int slot, float v0, float v1) {
      const long long m = p0 + p;
      const int n = q0 + q;
      if (m >= M || n >= N) return;
      const float y0 = round_to<T>(v0), y1 = round_to<T>(v1);
      store2(y + m * N + n, y0, y1);
      s[slot][0] += y0;
      s[slot][1] += y1;
      ss[slot][0] += static_cast<double>(y0) * y0;
      ss[slot][1] += static_cast<double>(y1) * y1;
    });
    column_accumulate<E>(s, ss, reinterpret_cast<double*>(smem), total);
  }
  column_write(total, part, splits, split, q0, N);
}

// dx body: da (M, K) = A (M, R) @ B^T with B read across its rows (B's
// source rows are the contracted index, its columns k). With BN, the
// epilogue takes xh = (x - mu) * inv of x (M, K), the ReLU mask z = xh *
// gamma + beta > 0 (RELU), dx = dz * (gamma * inv), and the columns'
// dbeta = sum(dz), dgamma = sum(dz * xh) in double into part[2][splits][K];
// without, dx = da.
template <class E, bool BN, bool RELU, class SA, class SB>
__device__ __forceinline__ void bwd_dx_body(
    const SA& A, const SB& B, const typename E::T* __restrict__ x,
    const float* __restrict__ mu, const float* __restrict__ inv,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    typename E::T* __restrict__ dx, double* __restrict__ part, long long M,
    int K, int R, int splits, unsigned char* smem) {
  using T = typename E::T;
  T* sa = reinterpret_cast<T*>(smem);
  T* sb = sa + E::TILE_ELEMS;
  const int q0 = blockIdx.x * TILE, split = blockIdx.y;
  long long begin, end;
  tile_run(M, splits, split, begin, end);
  double total = 0.0;
  for (long long tile = begin; tile < end; ++tile) {
    const long long p0 = tile * TILE;
    E e;
    e.zero();
    gemm<false, true>(e, A, p0, B, q0, 0, R, sa, sb);
    double db[E::SLOTS][2] = {}, dg[E::SLOTS][2] = {};
    e.for_pairs([&](int p, int q, int slot, float v0, float v1) {
      const long long m = p0 + p;
      const int k = q0 + q;
      if (m >= M || k >= K) return;
      float o[2] = {v0, v1};
      if (BN) {
        float xv[2];
        load2(x + m * K + k, xv);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kc = k + c;
          const float xh = __fmul_rn(__fsub_rn(xv[c], mu[kc]), inv[kc]);
          float dz = o[c];
          if (RELU) {
            const float z = __fadd_rn(__fmul_rn(xh, gamma[kc]), beta[kc]);
            dz = z > 0.f ? dz : 0.f;
          }
          o[c] = __fmul_rn(dz, __fmul_rn(gamma[kc], inv[kc]));
          db[slot][c] += dz;
          dg[slot][c] += static_cast<double>(dz) * xh;
        }
      }
      store2(dx + m * K + k, o[0], o[1]);
    });
    if (BN)
      column_accumulate<E>(db, dg, reinterpret_cast<double*>(smem), total);
  }
  if (BN) column_write(total, part, splits, split, q0, K);
}

// dw body: block (blockIdx.x: k tile, blockIdx.y: n tile, blockIdx.z:
// chunk of M) writes its f32 partial of A^T @ B over its chunk of the
// contracted rows, both sources read across their rows (A's columns n,
// B's k), to work[split] (N, K).
template <class E, class SA, class SB>
__device__ __forceinline__ void bwd_dw_body(const SA& A, const SB& B,
                                            float* __restrict__ work,
                                            long long M, int N, int K,
                                            int splits, unsigned char* smem) {
  using T = typename E::T;
  T* sa = reinterpret_cast<T*>(smem);
  T* sb = sa + E::TILE_ELEMS;
  const int q0 = blockIdx.x * TILE, p0 = blockIdx.y * TILE;
  const int split = blockIdx.z;
  const long long steps = (M + E::BR - 1) / E::BR;
  const long long per = (steps + splits - 1) / splits;
  const long long r_begin = split * per * E::BR;
  const long long r_end = r_begin + per * E::BR < M ? r_begin + per * E::BR : M;
  E e;
  e.zero();
  gemm<true, true>(e, A, p0, B, q0, r_begin, r_end, sa, sb);
  float* out = work + static_cast<long long>(split) * N * K;
  e.for_pairs([&](int p, int q, int, float v0, float v1) {
    const int n = p0 + p, k = q0 + q;
    if (n < N && k < K)
      store2(out + static_cast<long long>(n) * K + k, v0, v1);
  });
}

// dw = the (splits, NK) partials summed in order, rounded to T.
template <typename T>
__device__ __forceinline__ void dw_finish_body(const float* __restrict__ work,
                                               T* __restrict__ dw,
                                               long long NK, int splits) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < NK; i += step) {
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s = __fadd_rn(s, work[sp * NK + i]);
    from_float(dw + i, s);
  }
}

// out0[c] = sum over splits of part[0][s][c], out1 of part[1][s][c], in a
// fixed order in double, rounded to f32 once. Block (FIN_X, FIN_Y).
__device__ __forceinline__ void column_finish_body(
    const double* __restrict__ part, float* __restrict__ out0,
    float* __restrict__ out1, int C, int splits) {
  __shared__ double sh[2][FIN_Y][FIN_X + 1];
  const int c = blockIdx.x * FIN_X + threadIdx.x;
  double a = 0.0, b = 0.0;
  if (c < C) {
    const double* p0 = part + c;
    const double* p1 = part + static_cast<long long>(splits) * C + c;
    for (int s = threadIdx.y; s < splits; s += FIN_Y) {
      a += p0[static_cast<long long>(s) * C];
      b += p1[static_cast<long long>(s) * C];
    }
  }
  sh[0][threadIdx.y][threadIdx.x] = a;
  sh[1][threadIdx.y][threadIdx.x] = b;
  __syncthreads();
  if (threadIdx.y != 0 || c >= C) return;
  a = b = 0.0;
  for (int r = 0; r < FIN_Y; ++r) {
    a += sh[0][r][threadIdx.x];
    b += sh[1][r][threadIdx.x];
  }
  out0[c] = static_cast<float>(a);
  out1[c] = static_cast<float>(b);
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// Row-tile runs of the forward and dx kernels over M rows with Q output
// columns: about TARGET_BLOCKS blocks, at most one a row tile.
int row_splits(long long M, int Q) {
  const long long tiles = cdiv(M, TILE);
  long long s = cdiv(TARGET_BLOCKS, cdiv(Q, TILE));
  if (s > tiles) s = tiles;
  if (s < 1) s = 1;
  return static_cast<int>(cdiv(tiles, cdiv(tiles, s)));
}

// Contracted chunks of a dw over M rows into (N, K): about TARGET_BLOCKS
// blocks, each chunk at least MIN_STEPS steps of br rows deep.
int dw_splits(long long M, int N, int K, int br) {
  const long long steps = cdiv(M, br);
  long long s = cdiv(TARGET_BLOCKS, cdiv(N, TILE) * cdiv(K, TILE));
  long long cap = steps / MIN_STEPS;
  if (cap < 1) cap = 1;
  if (s > cap) s = cap;
  return static_cast<int>(cdiv(steps, cdiv(steps, s)));
}

}  // namespace
