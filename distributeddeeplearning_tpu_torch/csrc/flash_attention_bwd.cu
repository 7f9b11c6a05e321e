// Flash-attention backward for Hopper (sm_90a), written by hand: two
// kernels, dq and dk/dv, each in a bf16 instance on the tensor cores and an
// f32 instance on the CUDA cores.
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
// as the TPU kernels round them (:246, :299, :306); every product sums in
// f32. Dropout regenerates the forward's exact mask from global
// (batch*head, query, key) coordinates (flash_common.cuh). Tiles wholly
// above the causal diagonal are skipped (:251, :311). A fully masked row
// has lse 0 and delta 0, so its p is 0 and it contributes nothing.
//
// Grid order: the TPU grid carries dq over a sequential key axis and dk/dv
// over a sequential query axis in VMEM scratch. Here that axis is a loop
// inside one block, and the sums live in registers: one block per (query
// tile, batch*head) walks its key tiles for dq, one block per (key tile,
// batch*head) walks its query tiles for dk/dv. Every output element is
// summed by one thread (or one wgmma accumulator lane) in a fixed order,
// with no atomics, so the gradients repeat bit for bit from run to run.
//
// What bounds them on the card: the S^2 * D products, 3 per live (q, k)
// pair for dq and 4 for dk/dv, at 989 bf16 TFLOP/s on the tensor cores
// (H100 SXM); at GPT-2's training shape they are far above the byte bound.
// The bf16 design (flash_dq_tc_kernel, flash_dkv_tc_kernel):
// - Products on the tensor cores: one warpgroup of 128 threads owns 64 rows
//   and issues wgmma m64n64k16 with f32 accumulators. The score products
//   (s and dp; their transposes for dk/dv) read both operands from shared
//   memory; the second products take ds and p_drop, rounded to bf16 where
//   the TPU kernels round them, straight from the score accumulators'
//   registers as the A fragment, and read q, do or k as an MN-major B from
//   the same shared tile, so nothing is transposed by hand.
// - Tiles stay bf16 in 128-byte-swizzled shared memory (sm90.cuh) and are
//   copied by cp.async, 16 bytes a thread, into a ring of two stages: the
//   next K/V (dq) or Q/dO (dk/dv) tile loads while the current one
//   computes. 64-row tiles at both head dims: 50 KB of shared memory at
//   D=64, 98 KB at D=128.
// - Causal order: blocks run heaviest first. dq's query tiles are numbered
//   from the last (which walks every key tile) down, dk/dv's key tiles from
//   the first up, and the tile index is the grid's slow dimension, so the
//   grid ends on its lightest blocks instead of a tail of heavy ones.
// - The elementwise work beside the products: while s and dp are computed,
//   each thread folds key padding, ragged S and the causal triangle into
//   one bit per pair, and hashes the dropout mask of the tile (only tiles
//   with live pairs are visited) down to one bit per pair with an integer
//   compare; p = exp2(s * scale * log2(e) - lse * log2(e)). dk/dv issues
//   dv += p_drop^T.dO before it forms ds.
// The f32 instance (flash_dq_kernel, flash_dkv_kernel) keeps f32 tiles in
// shared memory with odd row strides and sums f32 FMAs on the CUDA cores:
// tensor-core TF32 would not hold f32 gradients to 1e-4.
//
// Layout: q, k, v, do, dq, dk, dv are (B, S, H, D) read and written through
// their strides (head dim contiguous; for bf16 every row 16-byte aligned);
// mask is int32 (B, S); lse and delta are contiguous f32 (B, H, S).

#include <climits>
#include <type_traits>

#include "flash_common.cuh"
#include "sm90.cuh"

namespace {

using flash::BQ;
using flash::Dropout;
using flash::GROUP;
using flash::NEG;
using flash::ROW_GROUPS;
using flash::Strides3;
using flash::THREADS;
using bf16 = __nv_bfloat16;

struct Strides {
  Strides3 q, k, v, dout, g0, g1;  // g0/g1: dq, or dk and dv
};

// ---------------------------------------------------------------------------
// f32: FMA on the CUDA cores.
// ---------------------------------------------------------------------------

// Keys per tile of the dq kernel, as the forward's.
constexpr int dq_block_k(int d) { return d == 128 ? 32 : 64; }
// Keys per block and queries per streamed tile of the dk/dv kernel: at
// D=128 the two f32 accumulators of 64 keys would take 256 registers a
// thread, so the block holds 32 keys and streams 32 queries (67 KB of
// shared memory); at D=64, 64 and 64 (100 KB).
constexpr int dkv_block_k(int d) { return d == 128 ? 32 : 64; }
constexpr int dkv_block_q(int d) { return d == 128 ? 32 : 64; }

template <int D>
__device__ __forceinline__ void load_transposed(float* dst, int stride,
                                                const float* src,
                                                long long s_s, int row0,
                                                int rows, int S) {
  // dst[d * stride + r] = src[(row0 + r) * s_s + d], 0 past S.
  for (int e = threadIdx.x; e < rows * D; e += THREADS) {
    const int r = e / D, d = e % D;
    const int i = row0 + r;
    dst[d * stride + r] = i < S ? src[i * s_s + d] : 0.f;
  }
}

template <int D, int BK, bool DROP>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const int* __restrict__ mask,
                const float* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dq,
                int S, int H, Strides st, int causal, float scale,
                Dropout dr) {
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
  const float* kb = k + b * st.k.b + h * st.k.h;
  const float* vb = v + b * st.v.b + h * st.v.h;
  const int* mb = mask + (long long)b * S;
  const uint32_t bh_c = DROP ? flash::bh_term(dr, b, h) : 0u;

  load_transposed<D>(qt, QT, q + b * st.q.b + h * st.q.h, st.q.s, q0, BQ, S);
  load_transposed<D>(dot, QT, dout + b * st.dout.b + h * st.dout.h,
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
    load_transposed<D>(kt, KT, kb, st.k.s, k0, BK, S);
    load_transposed<D>(vt, KT, vb, st.v.s, k0, BK, S);
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
        dss[c * QT + rg * ROWS + i] = p * (dpv - delta_r[i]) * scale;
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

  float* gb = dq + b * st.g0.b + h * st.g0.h;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qi = q0 + rg * ROWS + i;
    if (qi >= S) continue;
#pragma unroll
    for (int e = 0; e < DC; ++e) gb[qi * st.g0.s + cg + GROUP * e] = acc[i][e];
  }
}

template <int D, int BKV, int BQT, bool DROP>
__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ mask,
                 const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk,
                 float* __restrict__ dv, int S, int H, Strides st,
                 int causal, float scale, Dropout dr) {
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
  const float* qb = q + b * st.q.b + h * st.q.h;
  const float* ob = dout + b * st.dout.b + h * st.dout.h;
  const int* mb = mask + (long long)b * S;
  const uint32_t bh_c = DROP ? flash::bh_term(dr, b, h) : 0u;

  load_transposed<D>(kt, KT, k + b * st.k.b + h * st.k.h, st.k.s, k0, BKV,
                     S);
  load_transposed<D>(vt, KT, v + b * st.v.b + h * st.v.h, st.v.s, k0, BKV,
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
    load_transposed<D>(qt, QT, qb, st.q.s, q0, BQT, S);
    load_transposed<D>(dot, QT, ob, st.dout.s, q0, BQT, S);
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
        pds[c * KT + r] = pd;
        dss[c * KT + r] = p * (dpv - delta_s[c]) * scale;
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

  float* kout = dk + b * st.g0.b + h * st.g0.h;
  float* vout = dv + b * st.g1.b + h * st.g1.h;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int kj = k0 + rg * ROWS + i;
    if (kj >= S) continue;
#pragma unroll
    for (int e = 0; e < DC; ++e) {
      kout[kj * st.g0.s + cg + GROUP * e] = acc_k[i][e];
      vout[kj * st.g1.s + cg + GROUP * e] = acc_v[i][e];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma on the tensor cores.
// ---------------------------------------------------------------------------

constexpr int TR = 64;            // rows of every tile: wgmma's M, and N
constexpr int TC_THREADS = 128;   // one warpgroup
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
__host__ __device__ constexpr uint32_t tile_bytes() { return TR * D * 2; }
// Shared memory of either kernel: six bf16 tiles (dq: Q, dO and two stages
// of K and V; dk/dv: K, V and two stages of Q and dO), two stages of 64
// words (dq: the key mask; dk/dv: lse and delta, twice that), and slack to
// align the tiles to 1024 bytes.
template <int D>
constexpr size_t tc_smem() { return 6 * tile_bytes<D>() + 1024 + 1024; }

__device__ __forceinline__ uint32_t align1024(uint32_t a) {
  return (a + 1023u) & ~1023u;
}

// The thread's two accumulator rows (r0, r0 + 8) and its first column in
// each 8-column block of a 64 x 64 wgmma tile.
struct Lane {
  int r0, c0;
  __device__ Lane()
      : r0((threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2)),
        c0((threadIdx.x & 3) * 2) {}
};

// Stores a 64 x D f32 accumulator (D / 64 blocks) as bf16 rows of `out`
// (row stride `s`), rows at or past S skipped.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 64][32],
                                           bf16* out, long long s, int row0,
                                           int S, const Lane& ln) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + ln.r0 + 8 * half;
    if (row >= S) continue;
#pragma unroll
    for (int nb = 0; nb < D / 64; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = nb * 64 + 8 * j + ln.c0;
        *reinterpret_cast<__nv_bfloat162*>(&out[row * s + col]) =
            __floats2bfloat162_rn(acc[nb][4 * j + 2 * half],
                                  acc[nb][4 * j + 2 * half + 1]);
      }
  }
}

// dq for one 64-row query tile of one (batch, head): walks the key tiles
// below its diagonal with K, V and the key mask in a two-stage cp.async
// ring. Per key tile: s = Q.K^T and dp = dO.V^T (wgmma, both operands in
// shared memory), ds in registers, then dq += ds.K (wgmma, ds as the A
// fragment, K read MN-major).
template <int D, bool DROP>
__global__ void __launch_bounds__(TC_THREADS)
flash_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const int* __restrict__ mask,
                   const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq,
                   int S, int H, Strides st, int causal, float scale,
                   Dropout dr) {
  using namespace sm90;
  constexpr uint32_t T = tile_bytes<D>();
  constexpr int KSTEPS = D / 16;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = align1024(raw);
  const uint32_t sq = base, sdo = base + T, sk = base + 2 * T,
                 sv = base + 4 * T, smask = base + 6 * T;
  const int* kmask = reinterpret_cast<const int*>(smem_raw + (smask - raw));

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  // Heaviest first: the last query tile walks every key tile.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TR;
  const bf16* kb = k + b * st.k.b + h * st.k.h;
  const bf16* vb = v + b * st.v.b + h * st.v.h;
  const int* mb = mask + (long long)b * S;

  auto load_kv = [&](int tile, int stage) {
    const int k0 = tile * TR;
    load_tile<TR, D, TC_THREADS>(sk + stage * T, kb, st.k.s, k0, S);
    load_tile<TR, D, TC_THREADS>(sv + stage * T, vb, st.v.s, k0, S);
    if (threadIdx.x < TR) {
      const int kj = k0 + threadIdx.x;
      cp_async4(smask + (stage * TR + threadIdx.x) * 4, mb + (kj < S ? kj : 0),
                kj < S);
    }
  };
  load_tile<TR, D, TC_THREADS>(sq, q + b * st.q.b + h * st.q.h, st.q.s, q0,
                               S);
  load_tile<TR, D, TC_THREADS>(sdo, dout + b * st.dout.b + h * st.dout.h,
                               st.dout.s, q0, S);
  const int k_end = causal ? min(S, q0 + TR) : S;
  const int n_tiles = (k_end + TR - 1) / TR;
  load_kv(0, 0);

  const Lane ln;
  const uint32_t bh_c = DROP ? flash::bh_term(dr, b, h) : 0u;
  const float scale2 = scale * LOG2E;
  int qi[2], qlim[2];
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qi[i] = q0 + ln.r0 + 8 * i;
    const bool in = qi[i] < S;
    lse2[i] = in ? lse[(long long)bh * S + qi[i]] * LOG2E : 0.f;
    dlt[i] = in ? delta[(long long)bh * S + qi[i]] : 0.f;
    qlim[i] = causal ? qi[i] : INT_MAX;  // keys kj <= qlim are live
  }
  float acc[D / 64][32];
#pragma unroll
  for (int nb = 0; nb < D / 64; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    cp_async_wait_all();
    fence_async_shared();
    __syncthreads();  // tile t landed; every reader of stage ^ 1 is done
    if (t + 1 < n_tiles) load_kv(t + 1, stage ^ 1);

    const uint32_t ks = sk + stage * T, vs = sv + stage * T;
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      mma_ss<0>(s, desc_k<TR>(sq, kk), desc_k<TR>(ks, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      mma_ss<0>(dp, desc_k<TR>(sdo, kk), desc_k<TR>(vs, kk), kk);
    wgmma_commit();
    fence_regs(s);
    fence_regs(dp);

    // While the products run: which of the thread's 32 pairs are live (bit
    // i for accumulator element i), and which the dropout mask keeps.
    const int k0 = t * TR;
    const int* km = kmask + stage * TR;
    uint32_t live = 0, kept = 0;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int half = (i >> 1) & 1;
      const int kj = k0 + 8 * (i >> 2) + ln.c0 + (i & 1);
      live |= static_cast<uint32_t>(km[kj - k0] != 0 && kj <= qlim[half])
              << i;
      if (DROP)
        kept |= static_cast<uint32_t>(flash::keep(dr, bh_c, qi[half], kj))
                << i;
    }
    wgmma_wait<1>();  // s landed; dp may still run
    fence_regs(s);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      s[i] = live >> i & 1 ? exp2f(s[i] * scale2 - lse2[(i >> 1) & 1]) : 0.f;
    wgmma_wait<0>();
    fence_regs(dp);
    uint32_t frag[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      float ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float dpv = dp[i + e];
        if (DROP) dpv = kept >> (i + e) & 1 ? dpv * dr.inv_keep : 0.f;
        ds[e] = s[i + e] * (dpv - dlt[(i >> 1) & 1]) * scale;
      }
      frag[i >> 1] = pack_bf16(ds[0], ds[1]);
    }
    fence_regs(frag);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < D / 64; ++nb)
        mma_rs<1>(acc[nb], frag[4 * kk], frag[4 * kk + 1], frag[4 * kk + 2],
                  frag[4 * kk + 3], desc_mn<TR>(ks, kk, nb), 1);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < D / 64; ++nb) fence_regs(acc[nb]);
  }

  store_rows<D>(acc, dq + b * st.g0.b + h * st.g0.h, st.g0.s, q0, S, ln);
}

// dk and dv for one 64-row key tile of one (batch, head): walks the query
// tiles on and below its diagonal with Q, dO, lse and delta in a two-stage
// cp.async ring. Per query tile: s^T = K.Q^T and dp^T = V.dO^T (wgmma),
// p_drop^T and ds^T in registers, then dv += p_drop^T.dO and dk += ds^T.Q
// (wgmma, the fragments as A, dO and Q read MN-major).
template <int D, bool DROP>
__global__ void __launch_bounds__(TC_THREADS)
flash_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ mask,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int S, int H, Strides st,
                    int causal, float scale, Dropout dr) {
  using namespace sm90;
  constexpr uint32_t T = tile_bytes<D>();
  constexpr int KSTEPS = D / 16;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = align1024(raw);
  const uint32_t sk = base, sv = base + T, sq = base + 2 * T,
                 sdo = base + 4 * T, svec = base + 6 * T;
  // [stage][lse, delta][TR] f32
  const float* vec = reinterpret_cast<const float*>(smem_raw + (svec - raw));

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  // Heaviest first: the first key tile meets every query tile.
  const int k0 = blockIdx.y * TR;
  const bf16* qb = q + b * st.q.b + h * st.q.h;
  const bf16* ob = dout + b * st.dout.b + h * st.dout.h;
  const long long row_bh = (long long)bh * S;

  auto load_q = [&](int tile, int stage) {
    const int q0 = tile * TR;
    load_tile<TR, D, TC_THREADS>(sq + stage * T, qb, st.q.s, q0, S);
    load_tile<TR, D, TC_THREADS>(sdo + stage * T, ob, st.dout.s, q0, S);
    const int c = threadIdx.x & (TR - 1);
    const int which = threadIdx.x / TR;  // 0: lse, 1: delta
    const int qi = q0 + c;
    cp_async4(svec + ((stage * 2 + which) * TR + c) * 4,
              (which ? delta : lse) + row_bh + (qi < S ? qi : 0), qi < S);
  };
  load_tile<TR, D, TC_THREADS>(sk, k + b * st.k.b + h * st.k.h, st.k.s, k0,
                               S);
  load_tile<TR, D, TC_THREADS>(sv, v + b * st.v.b + h * st.v.h, st.v.s, k0,
                               S);
  // Causal: query tiles wholly above the diagonal (all rows < k0) are
  // skipped; tiles of queries and keys are both TR rows.
  const int t_begin = causal ? blockIdx.y : 0;
  const int t_end = (S + TR - 1) / TR;
  load_q(t_begin, 0);

  const Lane ln;
  const int* mb = mask + (long long)b * S;
  const uint32_t bh_c = DROP ? flash::bh_term(dr, b, h) : 0u;
  const float scale2 = scale * LOG2E;
  int kj[2], qmin[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    kj[i] = k0 + ln.r0 + 8 * i;
    const bool live = kj[i] < S && mb[kj[i]] != 0;
    qmin[i] = !live ? INT_MAX : causal ? kj[i] : 0;  // queries qi >= qmin
  }
  float acc_k[D / 64][32], acc_v[D / 64][32];
#pragma unroll
  for (int nb = 0; nb < D / 64; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_k[nb][i] = acc_v[nb][i] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) & 1;
    cp_async_wait_all();
    fence_async_shared();
    __syncthreads();  // tile t landed; every reader of stage ^ 1 is done
    if (t + 1 < t_end) load_q(t + 1, stage ^ 1);

    const uint32_t qs = sq + stage * T, os = sdo + stage * T;
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      mma_ss<0>(s, desc_k<TR>(sk, kk), desc_k<TR>(qs, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      mma_ss<0>(dp, desc_k<TR>(sv, kk), desc_k<TR>(os, kk), kk);
    wgmma_commit();
    fence_regs(s);
    fence_regs(dp);

    // While the products run: which of the thread's 32 pairs are live (bit
    // i for accumulator element i), and which the dropout mask keeps.
    const int q0 = t * TR;
    const float* lse_t = vec + stage * 2 * TR;
    const float* delta_t = lse_t + TR;
    uint32_t live = 0, kept = 0;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int half = (i >> 1) & 1;
      const int qi = q0 + 8 * (i >> 2) + ln.c0 + (i & 1);
      live |= static_cast<uint32_t>(qi >= qmin[half] && qi < S) << i;
      if (DROP)
        kept |= static_cast<uint32_t>(flash::keep(dr, bh_c, qi, kj[half]))
                << i;
    }
    wgmma_wait<1>();  // s^T landed; dp^T may still run
    fence_regs(s);
    uint32_t fp[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      float pd[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * ((i + e) >> 2) + ln.c0 + e;
        const float p =
            live >> (i + e) & 1 ? exp2f(s[i + e] * scale2 - lse_t[c] * LOG2E)
                                : 0.f;
        s[i + e] = p;
        pd[e] = p;
        if (DROP) pd[e] = kept >> (i + e) & 1 ? p * dr.inv_keep : 0.f;
      }
      fp[i >> 1] = pack_bf16(pd[0], pd[1]);
    }
    // dv += p_drop^T.dO runs while ds is formed.
    fence_regs(fp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < D / 64; ++nb)
        mma_rs<1>(acc_v[nb], fp[4 * kk], fp[4 * kk + 1], fp[4 * kk + 2],
                  fp[4 * kk + 3], desc_mn<TR>(os, kk, nb), 1);
    wgmma_commit();
#pragma unroll
    for (int nb = 0; nb < D / 64; ++nb) fence_regs(acc_v[nb]);
    wgmma_wait<1>();  // dp^T landed; dv may still run
    fence_regs(dp);
    uint32_t fds[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      float ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * ((i + e) >> 2) + ln.c0 + e;
        float dpv = dp[i + e];
        if (DROP) dpv = kept >> (i + e) & 1 ? dpv * dr.inv_keep : 0.f;
        ds[e] = s[i + e] * (dpv - delta_t[c]) * scale;
      }
      fds[i >> 1] = pack_bf16(ds[0], ds[1]);
    }
    fence_regs(fds);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < D / 64; ++nb)
        mma_rs<1>(acc_k[nb], fds[4 * kk], fds[4 * kk + 1], fds[4 * kk + 2],
                  fds[4 * kk + 3], desc_mn<TR>(qs, kk, nb), 1);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < D / 64; ++nb) {
      fence_regs(acc_k[nb]);
      fence_regs(acc_v[nb]);
    }
  }

  store_rows<D>(acc_k, dk + b * st.g0.b + h * st.g0.h, st.g0.s, k0, S, ln);
  store_rows<D>(acc_v, dv + b * st.g1.b + h * st.g1.h, st.g1.s, k0, S, ln);
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The pointers of one call, in the C entry points' order; g0/g1: dq, or dk
// and dv.
struct Args {
  const void *q, *k, *v, *mask, *dout, *lse, *delta;
  void *g0, *g1;
  Strides st;
  int B, S, H, causal;
  float scale;
  Dropout dr;
  cudaStream_t stream;
};

template <int D, bool DROP>
cudaError_t launch_dq_f32(const Args& a) {
  constexpr int BK = dq_block_k(D);
  const size_t smem = sizeof(float) * (2 * D * (BQ + 1) + 2 * D * (BK + 1) +
                                       BK * (BQ + 1)) +
                      sizeof(int) * BK;
  auto kernel = flash_dq_kernel<D, BK, DROP>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + BQ - 1) / BQ, a.B * a.H);
  kernel<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const int*>(a.mask),
      static_cast<const float*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<float*>(a.g0), a.S,
      a.H, a.st, a.causal, a.scale, a.dr);
  return cudaGetLastError();
}

template <int D, bool DROP>
cudaError_t launch_dkv_f32(const Args& a) {
  constexpr int BKV = dkv_block_k(D);
  constexpr int BQT = dkv_block_q(D);
  const size_t smem = sizeof(float) * (2 * D * (BKV + 1) +
                                       2 * D * (BQT + 1) +
                                       2 * BQT * (BKV + 1) + 2 * BQT);
  auto kernel = flash_dkv_kernel<D, BKV, BQT, DROP>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + BKV - 1) / BKV, a.B * a.H);
  kernel<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const int*>(a.mask),
      static_cast<const float*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<float*>(a.g0),
      static_cast<float*>(a.g1), a.S, a.H, a.st, a.causal, a.scale, a.dr);
  return cudaGetLastError();
}

// The tensor-core kernels' grid: (batch*head, tile), the tile the slow
// dimension so that the heaviest tiles of every head start first.
inline cudaError_t tc_grid(const Args& a, dim3* grid) {
  const int tiles = (a.S + TR - 1) / TR;
  if (tiles > 65535) return cudaErrorInvalidValue;
  *grid = dim3(a.B * a.H, tiles);
  return cudaSuccess;
}

template <int D, bool DROP>
cudaError_t launch_dq_bf16(const Args& a) {
  constexpr size_t smem = tc_smem<D>();
  auto kernel = flash_dq_tc_kernel<D, DROP>;
  dim3 grid;
  cudaError_t err = tc_grid(a, &grid);
  if (err == cudaSuccess) err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, TC_THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const int*>(a.mask),
      static_cast<const bf16*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<bf16*>(a.g0), a.S,
      a.H, a.st, a.causal, a.scale, a.dr);
  return cudaGetLastError();
}

template <int D, bool DROP>
cudaError_t launch_dkv_bf16(const Args& a) {
  constexpr size_t smem = tc_smem<D>();
  auto kernel = flash_dkv_tc_kernel<D, DROP>;
  dim3 grid;
  cudaError_t err = tc_grid(a, &grid);
  if (err == cudaSuccess) err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, TC_THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const int*>(a.mask),
      static_cast<const bf16*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<bf16*>(a.g0),
      static_cast<bf16*>(a.g1), a.S, a.H, a.st, a.causal, a.scale, a.dr);
  return cudaGetLastError();
}

Strides read_strides(const void* strides) {
  const long long* s = static_cast<const long long*>(strides);
  return Strides{{s[0], s[1], s[2]},    {s[3], s[4], s[5]},
                 {s[6], s[7], s[8]},    {s[9], s[10], s[11]},
                 {s[12], s[13], s[14]}, {s[15], s[16], s[17]}};
}

// Calls f(dtype tag, D, DROP) with the template arguments that the runtime
// arguments name (dtype 0: float, 1: bf16), or returns
// cudaErrorInvalidValue.
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
  if (dtype == 0) return by_dim(integral_constant<int, 0>{});
  if (dtype == 1) return by_dim(integral_constant<int, 1>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for q, k, v, do and the gradients
// alike. strides: 18 int64 element strides on the host, (batch, seq, head)
// for q, k, v, do, dq in turn (and one unused triple). Dropout is on when
// rate > 0, with the forward's seed and offsets (see flash_attention_fwd).
// Returns the CUDA error code of the launch (0 on success); the wrapper
// validates shapes, and for bf16 the 16-byte alignment of every row.
extern "C" int flash_attention_dq(const void* q, const void* k, const void* v,
                                  const void* mask, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dq, const void* strides, int B,
                                  int S, int H, int D, int dtype, int causal,
                                  float scale, float rate, float inv_keep,
                                  unsigned int seed, int b_start,
                                  int h_start, int h_total, void* stream) {
  const Args a{q, k, v, mask, dout, lse, delta, dq, nullptr,
               read_strides(strides), B, S, H, causal, scale,
               Dropout{flash::keep_threshold(rate), inv_keep, seed, b_start,
                       h_start, h_total},
               static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, D, rate > 0.f, [&](auto t, auto d, auto drop) {
    constexpr int Dv = decltype(d)::value;
    constexpr bool DROP = decltype(drop)::value;
    if constexpr (decltype(t)::value) return launch_dq_bf16<Dv, DROP>(a);
    else return launch_dq_f32<Dv, DROP>(a);
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
  const Args a{q, k, v, mask, dout, lse, delta, dk, dv,
               read_strides(strides), B, S, H, causal, scale,
               Dropout{flash::keep_threshold(rate), inv_keep, seed, b_start,
                       h_start, h_total},
               static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, D, rate > 0.f, [&](auto t, auto d, auto drop) {
    constexpr int Dv = decltype(d)::value;
    constexpr bool DROP = decltype(drop)::value;
    if constexpr (decltype(t)::value) return launch_dkv_bf16<Dv, DROP>(a);
    else return launch_dkv_f32<Dv, DROP>(a);
  });
}

// Each kernel library exports its own copy, under the same name.
extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
