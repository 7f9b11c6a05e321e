// Flash-attention forward for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel distributeddeeplearning_tpu/ops/
// flash_attention.py:_fwd_kernel (launched by _fwd). It computes the same
// function: online-softmax attention with a key-padding mask and an optional
// causal triangle and attention-probability dropout, writing o in q's dtype
// and the row logsumexp in f32. A fully masked row gives o = 0 and lse = 0.
//
// Dropout (flash_attention.py:136-141): l accumulates the undropped p, and
// only the P.V product sees keep ? p / (1 - rate) : 0, with keep the
// counter-based hash of the global (batch*head, query, key) coordinates
// (flash_common.cuh, the same function as ops/hash_dropout.py). The
// backward kernels regenerate the same mask. Rate 0 is a separate template
// instance with no hash in it, so the serving path runs the code it ran
// before dropout existed.
//
// Layout: q, k, v are read in the models' (B, S, H, D) layout through their
// strides (the head dim must be contiguous), which skips the (B*H, S, D)
// transposes of the TPU wrapper. mask is int32 (B, S), o is (B, S, H, D)
// through its strides, lse is contiguous (B, H, S).
//
// What bounds it on the card: at decode-sized S (a few hundred keys) the
// work is small and its bound is bytes (q, k, v read once, o written once);
// there the kernel is held by latency instead, as a few blocks of 4 warps
// per SM each walk their key tiles in order. At long S the S^2 * D products
// dominate and it is bound by operations. The design answers both simply:
// one block per (query tile, batch*head) reads its Q tile once and streams
// K/V tiles through shared memory, so device memory sees each K/V tile once
// per query tile and the (S, S) scores never leave the SM; for causal
// attention key tiles wholly above the diagonal are never loaded. The
// products run as f32 FMAs on the CUDA cores with f32 accumulation (exact
// for bf16 inputs). Tensor-core products (mma/wgmma) and TMA loads are the
// next step for the operation-bound regime.
//
// Thread layout: 128 threads own a 64 x BK score tile as 16 row groups of
// 8 lanes; each thread holds 4 query rows x BK/8 key columns of scores and
// the same 4 rows x D/8 columns of the output accumulator, so the online-softmax
// state (m, l) of a row lives in the registers of its 8 lanes and its
// reductions are three warp shuffles.

#include "flash_common.cuh"

namespace {

using flash::BQ;
using flash::Dropout;
using flash::GROUP;
using flash::NEG;
using flash::THREADS;
using flash::round_as;
using flash::store;
using flash::to_float;

constexpr int ROWS = 4;       // query rows per thread

// Keys per streamed tile. Shared memory holds f32 Q, K, V and P tiles: at
// D=128 a 64-key tile takes 116 KB, so one block fits on an SM; a 32-key
// tile takes 74 KB and holds half the scores in registers, and the kernel
// ran about twice as fast on an H100 at chip_smoke.py's D=128 shapes
// (S = 160 to 4096; PERF.md). At D=64 a 64-key tile takes 66 KB.
constexpr int block_k(int d) { return d == 128 ? 32 : 64; }

static_assert(THREADS / GROUP * ROWS == BQ, "row groups must cover BQ");

struct Strides {
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h;
};

template <typename T, int D, int BK, bool DROP>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ mask,
                 T* __restrict__ o, float* __restrict__ lse, int S, int H,
                 Strides st, int causal, float scale, Dropout dr) {
  constexpr int QT = BQ + 1;  // padded strides keep the transposed
  constexpr int KT = BK + 1;  // tiles' stores off a single bank
  constexpr int COLS = BK / GROUP;  // key columns per thread
  constexpr int DC = D / GROUP;     // output columns per thread
  extern __shared__ float smem[];
  float* qt = smem;                // [D][QT]  Q tile, transposed
  float* kt = qt + D * QT;         // [D][KT]  K tile, transposed
  float* vs = kt + D * KT;         // [BK][D]
  float* ps = vs + BK * D;         // [BK][QT] probabilities, transposed
  int* kvalid = reinterpret_cast<int*>(ps + BK * QT);  // [BK]

  const int tid = threadIdx.x;
  const int rg = tid / GROUP;
  const int cg = tid % GROUP;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const T* qb = q + b * st.q_b + h * st.q_h;
  const T* kb = k + b * st.k_b + h * st.k_h;
  const T* vb = v + b * st.v_b + h * st.v_h;
  const int* mb = mask + (long long)b * S;
  const uint32_t bh_c = DROP ? flash::bh_term(dr, b, h) : 0u;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D;
    const int qi = q0 + r;
    qt[d * QT + r] = qi < S ? to_float(qb[qi * st.q_s + d]) : 0.f;
  }

  float m[ROWS], l[ROWS], acc[ROWS][DC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // Causal: keys past the tile's last query row are skipped entirely.
  const int k_end = causal ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BK * D; e += THREADS) {
      const int c = e / D, d = e % D;
      const int kj = k0 + c;
      float kx = 0.f, vx = 0.f;
      if (kj < S) {
        kx = to_float(kb[kj * st.k_s + d]);
        vx = to_float(vb[kj * st.v_s + d]);
      }
      kt[d * KT + c] = kx;
      vs[c * D + d] = vx;
    }
    for (int c = tid; c < BK; c += THREADS) {
      const int kj = k0 + c;
      kvalid[c] = kj < S && mb[kj] != 0;
    }
    __syncthreads();

    float s[ROWS][COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[ROWS], kv[COLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) qv[i] = qt[d * QT + rg * ROWS + i];
#pragma unroll
      for (int j = 0; j < COLS; ++j) kv[j] = kt[d * KT + cg + GROUP * j];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < COLS; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qi = q0 + rg * ROWS + i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int c = cg + GROUP * j;
        const bool ok = kvalid[c] && (!causal || k0 + c <= qi);
        s[i][j] = ok ? s[i][j] * scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 1; w < GROUP; w <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int c = cg + GROUP * j;
        const bool ok = kvalid[c] && (!causal || k0 + c <= qi);
        const float p = ok ? expf(s[i][j] - m_new) : 0.f;
        sum += p;  // l accumulates the unrounded, undropped p, as on the TPU
        float pv = p;
        if (DROP)
          pv = flash::keep(dr, bh_c, qi, k0 + c) ? p * dr.inv_keep : 0.f;
        ps[c * QT + rg * ROWS + i] = round_as(pv, T());
      }
#pragma unroll
      for (int w = 1; w < GROUP; w <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[ROWS], vv[DC];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) pv[i] = ps[c * QT + rg * ROWS + i];
#pragma unroll
      for (int e = 0; e < DC; ++e) vv[e] = vs[c * D + cg + GROUP * e];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int e = 0; e < DC; ++e) acc[i][e] = fmaf(pv[i], vv[e], acc[i][e]);
    }
  }

  T* ob = o + b * st.o_b + h * st.o_h;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qi = q0 + rg * ROWS + i;
    if (qi >= S) continue;
    const float safe_l = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < DC; ++e)
      store(&ob[qi * st.o_s + cg + GROUP * e], acc[i][e] / safe_l);
    if (cg == 0)
      lse[(long long)bh * S + qi] = l[i] > 0.f ? m[i] + logf(safe_l) : 0.f;
  }
}

template <typename T, int D, bool DROP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* mask, void* o, void* lse, const Strides& st,
                   int B, int S, int H, int causal, float scale,
                   const Dropout& dr, cudaStream_t stream) {
  constexpr int BK = block_k(D);
  const size_t smem =
      sizeof(float) * (D * (BQ + 1) + D * (BK + 1) + BK * D + BK * (BQ + 1)) +
      sizeof(int) * BK;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, BK, DROP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D, BK, DROP><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(mask),
      static_cast<T*>(o), static_cast<float*>(lse), S, H, st, causal, scale,
      dr);
  return cudaGetLastError();
}

template <bool DROP>
int dispatch(const void* q, const void* k, const void* v, const void* mask,
             void* o, void* lse, const Strides& st, int B, int S, int H,
             int D, int dtype, int causal, float scale, const Dropout& dr,
             cudaStream_t cs) {
  if (dtype == 0 && D == 64)
    return launch<float, 64, DROP>(q, k, v, mask, o, lse, st, B, S, H,
                                   causal, scale, dr, cs);
  if (dtype == 0 && D == 128)
    return launch<float, 128, DROP>(q, k, v, mask, o, lse, st, B, S, H,
                                    causal, scale, dr, cs);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64, DROP>(q, k, v, mask, o, lse, st, B, S,
                                           H, causal, scale, dr, cs);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128, DROP>(q, k, v, mask, o, lse, st, B, S,
                                            H, causal, scale, dr, cs);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: 12 int64 element strides on
// the host, (batch, seq, head) for q, k, v and o in turn. Dropout is on when
// rate > 0: inv_keep = 1 / (1 - rate) rounded to f32, seed the int32 seed's
// bits, (b_start, h_start, h_total) the global (batch, head) placement.
// Returns the CUDA error code of the launch (0 on success); the wrapper
// validates shapes.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const void* mask, void* o,
                                   void* lse, const void* strides, int B,
                                   int S, int H, int D, int dtype, int causal,
                                   float scale, float rate, float inv_keep,
                                   unsigned int seed, int b_start,
                                   int h_start, int h_total, void* stream) {
  const long long* s = static_cast<const long long*>(strides);
  const Strides st{s[0], s[1], s[2], s[3], s[4],  s[5],
                   s[6], s[7], s[8], s[9], s[10], s[11]};
  const Dropout dr{flash::keep_threshold(rate), inv_keep, seed, b_start,
                   h_start, h_total};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  return rate > 0.f ? dispatch<true>(q, k, v, mask, o, lse, st, B, S, H, D,
                                     dtype, causal, scale, dr, cs)
                    : dispatch<false>(q, k, v, mask, o, lse, st, B, S, H, D,
                                      dtype, causal, scale, dr, cs);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
