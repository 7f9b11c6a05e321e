// Flash-attention backward for Hopper (sm_90a), written by hand: two
// kernels, dq and dk/dv.
//
// Replace the Pallas TPU kernels distributeddeeplearning_tpu/ops/
// flash_attention.py:_dq_kernel and _dkv_kernel (launched by _bwd). They
// compute the same functions from the forward's saved row logsumexp (the
// flash recurrence), with delta = sum(do * o) per row computed by the
// wrapper:
//
//   p  = exp(s - lse),  s = q.k^T * scale, masked to -1e30
//   dp = do.v^T, masked and scaled by the regenerated dropout keep-mask
//   ds = p * (dp - delta) * scale, rounded to the operands' dtype
//   dq = ds.k;  dk = ds^T.q;  dv = p_drop^T.do, p_drop rounded to do's dtype
//
// as the TPU kernels round them (:246, :299, :306). Dropout regenerates the
// forward's exact mask from global (batch*head, query, key) coordinates
// (flash_common.cuh). Tiles wholly above the causal diagonal are skipped
// (:251, :311). A fully masked row has lse 0 and delta 0, so its p is 0 and
// it contributes nothing.
//
// Grid order: the TPU grid carries dq over a sequential key axis and dk/dv
// over a sequential query axis in VMEM scratch. Here that axis is a loop
// inside one block, and the sums live in registers: one block per (query
// tile, batch*head) walks its key tiles for dq, one block per (key tile,
// batch*head) walks its query tiles for dk/dv. Every output element is
// summed by one thread in a fixed order, with no atomics, so the gradients
// are the same from run to run.
//
// What bounds them on the card: the S^2 * D products (3 per live (q, k)
// pair for dq, 4 for dk/dv) at training shapes. They run as f32 FMAs on the
// CUDA cores with f32 accumulation, like the forward kernel; tensor-core
// products (mma/wgmma) and TMA loads are the next step. Shared memory holds
// f32 tiles with odd row strides, so the transposed reads of the second
// product are free of bank conflicts.
//
// Layout: q, k, v, do, dq, dk, dv are (B, S, H, D) read and written through
// their strides (head dim contiguous); mask is int32 (B, S); lse and delta
// are contiguous f32 (B, H, S).

#include <type_traits>

#include "flash_common.cuh"

namespace {

using flash::BQ;
using flash::Dropout;
using flash::GROUP;
using flash::NEG;
using flash::ROW_GROUPS;
using flash::Strides3;
using flash::THREADS;
using flash::round_as;
using flash::store;
using flash::to_float;

struct Strides {
  Strides3 q, k, v, dout, g0, g1;  // g0/g1: dq, or dk and dv
};

// Keys per tile of the dq kernel, as the forward's.
constexpr int dq_block_k(int d) { return d == 128 ? 32 : 64; }
// Keys per block and queries per streamed tile of the dk/dv kernel: at
// D=128 the two f32 accumulators of 64 keys would take 256 registers a
// thread, so the block holds 32 keys and streams 32 queries (67 KB of
// shared memory); at D=64, 64 and 64 (100 KB).
constexpr int dkv_block_k(int d) { return d == 128 ? 32 : 64; }
constexpr int dkv_block_q(int d) { return d == 128 ? 32 : 64; }

template <typename T, int D>
__device__ __forceinline__ void load_transposed(float* dst, int stride,
                                                const T* src, long long s_s,
                                                int row0, int rows, int S) {
  // dst[d * stride + r] = src[(row0 + r) * s_s + d], 0 past S.
  for (int e = threadIdx.x; e < rows * D; e += THREADS) {
    const int r = e / D, d = e % D;
    const int i = row0 + r;
    dst[d * stride + r] = i < S ? to_float(src[i * s_s + d]) : 0.f;
  }
}

template <typename T, int D, int BK, bool DROP>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const int* __restrict__ mask,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int S,
                int H, Strides st, int causal, float scale, Dropout dr) {
  constexpr int ROWS = BQ / ROW_GROUPS;  // query rows per thread
  constexpr int QT = BQ + 1;
  constexpr int KT = BK + 1;
  constexpr int COLS = BK / GROUP;  // key columns per thread
  constexpr int DC = D / GROUP;     // dq columns per thread
  extern __shared__ float smem[];
  float* qt = smem;                // [D][QT]  Q tile, transposed
  float* dot = qt + D * QT;        // [D][QT]  dO tile, transposed
  float* kt = dot + D * QT;        // [D][KT]  K tile, transposed
  float* vt = kt + D * KT;         // [D][KT]  V tile, transposed
  float* dss = vt + D * KT;        // [BK][QT] ds, transposed
  int* kvalid = reinterpret_cast<int*>(dss + BK * QT);  // [BK]

  const int tid = threadIdx.x;
  const int rg = tid / GROUP;
  const int cg = tid % GROUP;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const T* kb = k + b * st.k.b + h * st.k.h;
  const T* vb = v + b * st.v.b + h * st.v.h;
  const int* mb = mask + (long long)b * S;
  const uint32_t bh_c = DROP ? flash::bh_term(dr, b, h) : 0u;

  load_transposed<T, D>(qt, QT, q + b * st.q.b + h * st.q.h, st.q.s, q0, BQ,
                        S);
  load_transposed<T, D>(dot, QT, dout + b * st.dout.b + h * st.dout.h,
                        st.dout.s, q0, BQ, S);
  float lse_r[ROWS], delta_r[ROWS], acc[ROWS][DC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qi = q0 + rg * ROWS + i;
    lse_r[i] = qi < S ? lse[(long long)bh * S + qi] : 0.f;
    delta_r[i] = qi < S ? delta[(long long)bh * S + qi] : 0.f;
#pragma unroll
    for (int e = 0; e < DC; ++e) acc[i][e] = 0.f;
  }

  const int k_end = causal ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    load_transposed<T, D>(kt, KT, kb, st.k.s, k0, BK, S);
    load_transposed<T, D>(vt, KT, vb, st.v.s, k0, BK, S);
    for (int c = tid; c < BK; c += THREADS) {
      const int kj = k0 + c;
      kvalid[c] = kj < S && mb[kj] != 0;
    }
    __syncthreads();

    float s[ROWS][COLS], dp[ROWS][COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[ROWS], ov[ROWS], kv[COLS], vv[COLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        qv[i] = qt[d * QT + rg * ROWS + i];
        ov[i] = dot[d * QT + rg * ROWS + i];
      }
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        kv[j] = kt[d * KT + cg + GROUP * j];
        vv[j] = vt[d * KT + cg + GROUP * j];
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qi = q0 + rg * ROWS + i;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int c = cg + GROUP * j;
        const bool ok = qi < S && kvalid[c] && (!causal || k0 + c <= qi);
        const float p = expf((ok ? s[i][j] * scale : NEG) - lse_r[i]);
        float dpv = dp[i][j];
        if (DROP)
          dpv = flash::keep(dr, bh_c, qi, k0 + c) ? dpv * dr.inv_keep : 0.f;
        dss[c * QT + rg * ROWS + i] =
            round_as(p * (dpv - delta_r[i]) * scale, T());
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dv_[ROWS], kv[DC];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) dv_[i] = dss[c * QT + rg * ROWS + i];
#pragma unroll
      for (int e = 0; e < DC; ++e) kv[e] = kt[(cg + GROUP * e) * KT + c];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int e = 0; e < DC; ++e) acc[i][e] = fmaf(dv_[i], kv[e], acc[i][e]);
    }
  }

  T* gb = dq + b * st.g0.b + h * st.g0.h;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qi = q0 + rg * ROWS + i;
    if (qi >= S) continue;
#pragma unroll
    for (int e = 0; e < DC; ++e)
      store(&gb[qi * st.g0.s + cg + GROUP * e], acc[i][e]);
  }
}

template <typename T, int D, int BKV, int BQT, bool DROP>
__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ mask,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int S, int H, Strides st, int causal,
                 float scale, Dropout dr) {
  constexpr int ROWS = BKV / ROW_GROUPS;  // key rows per thread
  constexpr int KT = BKV + 1;
  constexpr int QT = BQT + 1;
  constexpr int COLS = BQT / GROUP;  // query columns per thread
  constexpr int DC = D / GROUP;      // dk/dv columns per thread
  extern __shared__ float smem[];
  float* kt = smem;                // [D][KT]   K block, transposed
  float* vt = kt + D * KT;         // [D][KT]   V block, transposed
  float* qt = vt + D * KT;         // [D][QT]   Q tile, transposed
  float* dot = qt + D * QT;        // [D][QT]   dO tile, transposed
  float* pds = dot + D * QT;       // [BQT][KT] p_drop, transposed
  float* dss = pds + BQT * KT;     // [BQT][KT] ds, transposed
  float* lse_s = dss + BQT * KT;   // [BQT]
  float* delta_s = lse_s + BQT;    // [BQT]

  const int tid = threadIdx.x;
  const int rg = tid / GROUP;
  const int cg = tid % GROUP;
  const int k0 = blockIdx.x * BKV;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const T* qb = q + b * st.q.b + h * st.q.h;
  const T* ob = dout + b * st.dout.b + h * st.dout.h;
  const int* mb = mask + (long long)b * S;
  const uint32_t bh_c = DROP ? flash::bh_term(dr, b, h) : 0u;

  load_transposed<T, D>(kt, KT, k + b * st.k.b + h * st.k.h, st.k.s, k0, BKV,
                        S);
  load_transposed<T, D>(vt, KT, v + b * st.v.b + h * st.v.h, st.v.s, k0, BKV,
                        S);
  bool kval[ROWS];
  float acc_k[ROWS][DC], acc_v[ROWS][DC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int kj = k0 + rg * ROWS + i;
    kval[i] = kj < S && mb[kj] != 0;
#pragma unroll
    for (int e = 0; e < DC; ++e) acc_k[i][e] = acc_v[i][e] = 0.f;
  }

  // Causal: query tiles wholly above the diagonal (all rows < k0) are
  // skipped.
  const int q_begin = causal ? (k0 / BQT) * BQT : 0;
  for (int q0 = q_begin; q0 < S; q0 += BQT) {
    __syncthreads();  // the previous tile's readers are done
    load_transposed<T, D>(qt, QT, qb, st.q.s, q0, BQT, S);
    load_transposed<T, D>(dot, QT, ob, st.dout.s, q0, BQT, S);
    for (int c = tid; c < BQT; c += THREADS) {
      const int qi = q0 + c;
      lse_s[c] = qi < S ? lse[(long long)bh * S + qi] : 0.f;
      delta_s[c] = qi < S ? delta[(long long)bh * S + qi] : 0.f;
    }
    __syncthreads();

    float s[ROWS][COLS], dp[ROWS][COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[ROWS], vv[ROWS], qv[COLS], ov[COLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        kv[i] = kt[d * KT + rg * ROWS + i];
        vv[i] = vt[d * KT + rg * ROWS + i];
      }
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        qv[j] = qt[d * QT + cg + GROUP * j];
        ov[j] = dot[d * QT + cg + GROUP * j];
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int r = rg * ROWS + i;
      const int kj = k0 + r;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int c = cg + GROUP * j;
        const int qi = q0 + c;
        const bool ok = qi < S && kval[i] && (!causal || kj <= qi);
        const float p = expf((ok ? s[i][j] * scale : NEG) - lse_s[c]);
        float pd = p, dpv = dp[i][j];
        if (DROP) {
          const bool kp = flash::keep(dr, bh_c, qi, kj);
          pd = kp ? p * dr.inv_keep : 0.f;
          dpv = kp ? dpv * dr.inv_keep : 0.f;
        }
        pds[c * KT + r] = round_as(pd, T());
        dss[c * KT + r] = round_as(p * (dpv - delta_s[c]) * scale, T());
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BQT; ++c) {
      float pr[ROWS], dr_[ROWS], qv[DC], ov[DC];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        pr[i] = pds[c * KT + rg * ROWS + i];
        dr_[i] = dss[c * KT + rg * ROWS + i];
      }
#pragma unroll
      for (int e = 0; e < DC; ++e) {
        qv[e] = qt[(cg + GROUP * e) * QT + c];
        ov[e] = dot[(cg + GROUP * e) * QT + c];
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int e = 0; e < DC; ++e) {
          acc_v[i][e] = fmaf(pr[i], ov[e], acc_v[i][e]);
          acc_k[i][e] = fmaf(dr_[i], qv[e], acc_k[i][e]);
        }
    }
  }

  T* kout = dk + b * st.g0.b + h * st.g0.h;
  T* vout = dv + b * st.g1.b + h * st.g1.h;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int kj = k0 + rg * ROWS + i;
    if (kj >= S) continue;
#pragma unroll
    for (int e = 0; e < DC; ++e) {
      store(&kout[kj * st.g0.s + cg + GROUP * e], acc_k[i][e]);
      store(&vout[kj * st.g1.s + cg + GROUP * e], acc_v[i][e]);
    }
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int D, bool DROP>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* mask, const void* dout, const void* lse,
                      const void* delta, void* dq, const Strides& st, int B,
                      int S, int H, int causal, float scale,
                      const Dropout& dr, cudaStream_t stream) {
  constexpr int BK = dq_block_k(D);
  const size_t smem = sizeof(float) * (2 * D * (BQ + 1) + 2 * D * (BK + 1) +
                                       BK * (BQ + 1)) +
                      sizeof(int) * BK;
  auto kernel = flash_dq_kernel<T, D, BK, DROP>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(mask),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), S, H, st,
      causal, scale, dr);
  return cudaGetLastError();
}

template <typename T, int D, bool DROP>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* mask, const void* dout, const void* lse,
                       const void* delta, void* dk, void* dv,
                       const Strides& st, int B, int S, int H, int causal,
                       float scale, const Dropout& dr, cudaStream_t stream) {
  constexpr int BKV = dkv_block_k(D);
  constexpr int BQT = dkv_block_q(D);
  const size_t smem = sizeof(float) * (2 * D * (BKV + 1) +
                                       2 * D * (BQT + 1) +
                                       2 * BQT * (BKV + 1) + 2 * BQT);
  auto kernel = flash_dkv_kernel<T, D, BKV, BQT, DROP>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BKV - 1) / BKV, B * H);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(mask),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), S, H, st, causal, scale, dr);
  return cudaGetLastError();
}

Strides read_strides(const void* strides) {
  const long long* s = static_cast<const long long*>(strides);
  return Strides{{s[0], s[1], s[2]},    {s[3], s[4], s[5]},
                 {s[6], s[7], s[8]},    {s[9], s[10], s[11]},
                 {s[12], s[13], s[14]}, {s[15], s[16], s[17]}};
}

// Calls f(T{}, D, DROP) with the template arguments that the runtime
// arguments name, or returns cudaErrorInvalidValue.
template <typename F>
int dispatch(int dtype, int D, bool drop, F&& f) {
  using std::integral_constant;
  auto by_drop = [&](auto t, auto d) {
    return static_cast<int>(drop ? f(t, d, std::true_type{})
                                 : f(t, d, std::false_type{}));
  };
  auto by_dim = [&](auto t) {
    if (D == 64) return by_drop(t, integral_constant<int, 64>{});
    if (D == 128) return by_drop(t, integral_constant<int, 128>{});
    return static_cast<int>(cudaErrorInvalidValue);
  };
  if (dtype == 0) return by_dim(float{});
  if (dtype == 1) return by_dim(__nv_bfloat16{});
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for q, k, v, do and the gradients
// alike. strides: 18 int64 element strides on the host, (batch, seq, head)
// for q, k, v, do, dq in turn (and one unused triple). Dropout is on when
// rate > 0, with the forward's seed and offsets (see flash_attention_fwd).
// Returns the CUDA error code of the launch (0 on success); the wrapper
// validates shapes.
extern "C" int flash_attention_dq(const void* q, const void* k, const void* v,
                                  const void* mask, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dq, const void* strides, int B,
                                  int S, int H, int D, int dtype, int causal,
                                  float scale, float rate, float inv_keep,
                                  unsigned int seed, int b_start,
                                  int h_start, int h_total, void* stream) {
  const Strides st = read_strides(strides);
  const Dropout dr{rate, inv_keep, seed, b_start, h_start, h_total};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, D, rate > 0.f, [&](auto t, auto d, auto drop) {
    return launch_dq<decltype(t), decltype(d)::value, decltype(drop)::value>(
        q, k, v, mask, dout, lse, delta, dq, st, B, S, H, causal, scale, dr,
        cs);
  });
}

// As flash_attention_dq; strides: (batch, seq, head) for q, k, v, do, dk,
// dv in turn.
extern "C" int flash_attention_dkv(const void* q, const void* k,
                                   const void* v, const void* mask,
                                   const void* dout, const void* lse,
                                   const void* delta, void* dk, void* dv,
                                   const void* strides, int B, int S, int H,
                                   int D, int dtype, int causal, float scale,
                                   float rate, float inv_keep,
                                   unsigned int seed, int b_start,
                                   int h_start, int h_total, void* stream) {
  const Strides st = read_strides(strides);
  const Dropout dr{rate, inv_keep, seed, b_start, h_start, h_total};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, D, rate > 0.f, [&](auto t, auto d, auto drop) {
    return launch_dkv<decltype(t), decltype(d)::value, decltype(drop)::value>(
        q, k, v, mask, dout, lse, delta, dk, dv, st, B, S, H, causal, scale,
        dr, cs);
  });
}

// Each kernel library exports its own copy, under the same name.
extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
