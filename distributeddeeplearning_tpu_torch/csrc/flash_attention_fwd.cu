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
// there the kernel is held by latency instead. At long S the S^2 * D
// products dominate and it is bound by operations: 2 products of 2 D flops
// per live (query, key) pair, at 989 bf16 TFLOP/s on the tensor cores (H100
// SXM). In both instances one block per (query tile, batch*head) reads its
// Q tile once and streams K/V tiles through shared memory, so device memory
// sees each K/V tile once per query tile and the (S, S) scores never leave
// the SM; for causal attention key tiles wholly above the diagonal are
// never loaded.
//
// bf16 (flash_fwd_tc_kernel), on the tensor cores, as the backward's dq
// kernel (flash_attention_bwd.cu) without its dp product:
// - One warpgroup of 128 threads owns a 64-row query tile at D = 64 and 128
//   and issues wgmma m64n64k16 with f32 accumulators (sm90.cuh). s = Q.K^T
//   reads both operands K-major from shared memory; o += p_drop.V takes
//   p_drop, rounded to bf16, straight from the score accumulators'
//   registers as the A fragment and reads V as an MN-major B from the tile
//   as stored, so nothing is transposed by hand.
// - Q is copied once into 128-byte-swizzled shared memory; K, V and the
//   key mask stream through a cp.async ring (16 bytes a thread), the next
//   key tile loading while the current one computes. At D=64 the ring has
//   three stages (56 KB of shared memory), so a tile's product with V is
//   waited for only after the next tile's s = Q.K^T is issued and its mask
//   bits formed; at D=128 two (80 KB, two blocks an SM).
// - The online softmax runs on the accumulator registers: each thread
//   holds 2 rows x 16 keys of a tile, a row's max takes two quad shuffles,
//   p = exp2(s * scale * log2(e) - m), and each thread keeps its share of
//   l, summed over the quad once at the end.
// - While s is computed, each thread folds key padding, ragged S and the
//   causal triangle into one bit per pair, and hashes the tile's dropout
//   mask down to one bit per pair with an integer compare.
// - Causal order: the grid's slow dimension numbers the query tiles from
//   the last (which walks every key tile) down, so the grid ends on its
//   lightest blocks.
// Every row of q, k, v must start on 16 bytes (the wrapper checks).
//
// f32 (flash_fwd_kernel) keeps f32 tiles in shared memory and sums f32
// FMAs on the CUDA cores (exact products, f32 accumulation): the sampling
// path computes in f32, and TF32 would not hold it to 1e-4.
// Thread layout: 128 threads own a 64 x BK score tile as 16 row groups of
// 8 lanes; each thread holds 4 query rows x BK/8 key columns of scores and
// the same 4 rows x D/8 columns of the output accumulator, so the online-softmax
// state (m, l) of a row lives in the registers of its 8 lanes and its
// reductions are three warp shuffles.

#include <climits>

#include "flash_common.cuh"
#include "sm90.cuh"

namespace {

using flash::BQ;
using flash::Dropout;
using flash::GROUP;
using flash::NEG;
using flash::THREADS;

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

template <int D, int BK, bool DROP>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ mask,
                 float* __restrict__ o, float* __restrict__ lse, int S, int H,
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
  const float* qb = q + b * st.q_b + h * st.q_h;
  const float* kb = k + b * st.k_b + h * st.k_h;
  const float* vb = v + b * st.v_b + h * st.v_h;
  const int* mb = mask + (long long)b * S;
  const uint32_t bh_c = DROP ? flash::bh_term(dr, b, h) : 0u;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D;
    const int qi = q0 + r;
    qt[d * QT + r] = qi < S ? qb[qi * st.q_s + d] : 0.f;
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
        kx = kb[kj * st.k_s + d];
        vx = vb[kj * st.v_s + d];
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
        ps[c * QT + rg * ROWS + i] = pv;
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

  float* ob = o + b * st.o_b + h * st.o_h;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qi = q0 + rg * ROWS + i;
    if (qi >= S) continue;
    const float safe_l = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < DC; ++e)
      ob[qi * st.o_s + cg + GROUP * e] = acc[i][e] / safe_l;
    if (cg == 0)
      lse[(long long)bh * S + qi] = l[i] > 0.f ? m[i] + logf(safe_l) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma on the tensor cores.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int TR = 64;            // rows of every tile: wgmma's M, and N
constexpr int TC_THREADS = 128;   // one warpgroup
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
__host__ __device__ constexpr uint32_t tile_bytes() { return TR * D * 2; }
// Stages of the K/V ring: three at D=64, where o += p_drop.V of one key
// tile runs on while the next tile's s = Q.K^T and mask bits are formed
// (the third stage holds the tile being loaded); two at D=128, where three
// would leave room for one block an SM.
template <int D>
__host__ __device__ constexpr int kv_stages() { return D == 64 ? 3 : 2; }
// Shared memory: the bf16 tiles (Q, K and V of each stage), each stage's
// 64-word key mask, and slack to align the tiles to 1024.
template <int D>
constexpr size_t tc_smem() {
  return (1 + 2 * kv_stages<D>()) * tile_bytes<D>() + kv_stages<D>() * 256 +
         1024;
}

// o and lse for one 64-row query tile of one (batch, head): walks the key
// tiles below its diagonal with K, V and the key mask in a cp.async ring,
// the next tile loading while this one computes. Per key tile: s = Q.K^T
// (wgmma, both operands in shared memory), the online softmax in
// registers, then o += p_drop.V (wgmma, p_drop as the A fragment, V read
// MN-major), which at three stages is waited for only once the next
// tile's s has been issued and its mask bits formed.
template <int D, bool DROP>
__global__ void __launch_bounds__(TC_THREADS)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ mask,
                    bf16* __restrict__ o, float* __restrict__ lse, int S,
                    int H, Strides st, int causal, float scale, Dropout dr) {
  using namespace sm90;
  constexpr uint32_t T = tile_bytes<D>();
  constexpr int KSTEPS = D / 16;
  constexpr int NS = kv_stages<D>();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sq = base, sk = base + T, sv = base + (1 + NS) * T,
                 smask = base + (1 + 2 * NS) * T;
  const int* kmask = reinterpret_cast<const int*>(smem_raw + (smask - raw));

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  // Heaviest first: the last query tile walks every key tile.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TR;
  const bf16* kb = k + b * st.k_b + h * st.k_h;
  const bf16* vb = v + b * st.v_b + h * st.v_h;
  const int* mb = mask + (long long)b * S;

  auto load_kv = [&](int tile, int stage) {
    const int k0 = tile * TR;
    load_tile<TR, D, TC_THREADS>(sk + stage * T, kb, st.k_s, k0, S);
    load_tile<TR, D, TC_THREADS>(sv + stage * T, vb, st.v_s, k0, S);
    if (threadIdx.x < TR) {
      const int kj = k0 + threadIdx.x;
      cp_async4(smask + (stage * TR + threadIdx.x) * 4, mb + (kj < S ? kj : 0),
                kj < S);
    }
  };
  load_tile<TR, D, TC_THREADS>(sq, q + b * st.q_b + h * st.q_h, st.q_s, q0,
                               S);
  const int k_end = causal ? min(S, q0 + TR) : S;
  const int n_tiles = (k_end + TR - 1) / TR;
  load_kv(0, 0);

  // The thread's two accumulator rows (r0, r0 + 8) and its first column in
  // each 8-column block of a 64 x 64 tile.
  const int r0 = (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
  const int c0 = (threadIdx.x & 3) * 2;
  const uint32_t bh_c = DROP ? flash::bh_term(dr, b, h) : 0u;
  const float scale2 = scale * LOG2E;
  int qi[2], qlim[2];
  // Row state in log2 units: m the running max of s * scale * log2(e), l
  // this thread's share of the sum of p = exp2(that - m), undropped.
  float m[2], l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qi[i] = q0 + r0 + 8 * i;
    qlim[i] = causal ? qi[i] : INT_MAX;  // keys kj <= qlim are live
    m[i] = NEG;
    l[i] = 0.f;
  }
  float acc[D / 64][32];
#pragma unroll
  for (int nb = 0; nb < D / 64; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;
  // p_drop of the last key tile: pinned until its product is done.
  uint32_t frag[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) frag[i] = 0u;

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t % NS;
    cp_async_wait_all();
    fence_async_shared();
    // Tile t landed; every reader of tile t + 1 - NS's stage is done (at
    // three stages, tile t - 1's product with V may still run).
    __syncthreads();
    if (t + 1 < n_tiles) load_kv(t + 1, (t + 1) % NS);

    const uint32_t ks = sk + stage * T, vs = sv + stage * T;
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      mma_ss<0>(s, desc_k<TR>(sq, kk), desc_k<TR>(ks, kk), kk);
    wgmma_commit();
    fence_regs(s);

    // While the product runs: which of the thread's 32 pairs are live (bit
    // i for accumulator element i), and which the dropout mask keeps.
    const int k0 = t * TR;
    const int* km = kmask + stage * TR;
    uint32_t live = 0, kept = 0;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int half = (i >> 1) & 1;
      const int kj = k0 + 8 * (i >> 2) + c0 + (i & 1);
      live |= static_cast<uint32_t>(km[kj - k0] != 0 && kj <= qlim[half])
              << i;
      if (DROP)
        kept |= static_cast<uint32_t>(flash::keep(dr, bh_c, qi[half], kj))
                << i;
    }
    wgmma_wait<0>();  // s, and tile t - 1's product with V
    fence_regs(s);
    fence_regs(frag);
#pragma unroll
    for (int nb = 0; nb < D / 64; ++nb) fence_regs(acc[nb]);

    // The online softmax: masked scores are NEG, as on the TPU.
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = live >> i & 1 ? s[i] * scale2 : NEG;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i >> 1) & 1;
      float pd[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = live >> (i + e) & 1 ? exp2f(s[i + e] - m[r]) : 0.f;
        l[r] += p;  // the unrounded, undropped p, as on the TPU
        pd[e] = p;
        if (DROP) pd[e] = kept >> (i + e) & 1 ? p * dr.inv_keep : 0.f;
      }
      frag[i >> 1] = pack_bf16(pd[0], pd[1]);
    }
#pragma unroll
    for (int nb = 0; nb < D / 64; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[nb][i] *= corr[(i >> 1) & 1];
    fence_regs(frag);
#pragma unroll
    for (int nb = 0; nb < D / 64; ++nb) fence_regs(acc[nb]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < D / 64; ++nb)
        mma_rs<1>(acc[nb], frag[4 * kk], frag[4 * kk + 1], frag[4 * kk + 2],
                  frag[4 * kk + 3], desc_mn<TR>(vs, kk, nb), 1);
    wgmma_commit();
    if (NS == 2) wgmma_wait<0>();  // its V stage is refilled next
#pragma unroll
    for (int nb = 0; nb < D / 64; ++nb) fence_regs(acc[nb]);
    fence_regs(frag);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int nb = 0; nb < D / 64; ++nb) fence_regs(acc[nb]);
  fence_regs(frag);

  bf16* ob = o + b * st.o_b + h * st.o_h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (qi[r] >= S) continue;
    const float safe_l = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int nb = 0; nb < D / 64; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(
            &ob[qi[r] * st.o_s + nb * 64 + 8 * j + c0]) =
            __floats2bfloat162_rn(acc[nb][4 * j + 2 * r] / safe_l,
                                  acc[nb][4 * j + 2 * r + 1] / safe_l);
    if ((threadIdx.x & 3) == 0)
      lse[(long long)bh * S + qi[r]] =
          l[r] > 0.f ? m[r] * LN2 + logf(safe_l) : 0.f;
  }
}

template <int D, bool DROP>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* mask, void* o, void* lse, const Strides& st,
                      int B, int S, int H, int causal, float scale,
                      const Dropout& dr, cudaStream_t stream) {
  constexpr size_t smem = tc_smem<D>();
  const int tiles = (S + TR - 1) / TR;
  if (tiles > 65535) return cudaErrorInvalidValue;
  auto kernel = flash_fwd_tc_kernel<D, DROP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // (batch*head, query tile): the tile the slow dimension, so that the
  // heaviest tiles of every head start first.
  const dim3 grid(B * H, tiles);
  kernel<<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(mask),
      static_cast<bf16*>(o), static_cast<float*>(lse), S, H, st, causal,
      scale, dr);
  return cudaGetLastError();
}

template <int D, bool DROP>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* mask, void* o, void* lse,
                       const Strides& st, int B, int S, int H, int causal,
                       float scale, const Dropout& dr, cudaStream_t stream) {
  constexpr int BK = block_k(D);
  const size_t smem =
      sizeof(float) * (D * (BQ + 1) + D * (BK + 1) + BK * D + BK * (BQ + 1)) +
      sizeof(int) * BK;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, BK, DROP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<D, BK, DROP><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(mask),
      static_cast<float*>(o), static_cast<float*>(lse), S, H, st, causal,
      scale, dr);
  return cudaGetLastError();
}

template <bool DROP>
int dispatch(const void* q, const void* k, const void* v, const void* mask,
             void* o, void* lse, const Strides& st, int B, int S, int H,
             int D, int dtype, int causal, float scale, const Dropout& dr,
             cudaStream_t cs) {
  if (dtype == 0 && D == 64)
    return launch_f32<64, DROP>(q, k, v, mask, o, lse, st, B, S, H, causal,
                                scale, dr, cs);
  if (dtype == 0 && D == 128)
    return launch_f32<128, DROP>(q, k, v, mask, o, lse, st, B, S, H, causal,
                                 scale, dr, cs);
  if (dtype == 1 && D == 64)
    return launch_tc<64, DROP>(q, k, v, mask, o, lse, st, B, S, H, causal,
                               scale, dr, cs);
  if (dtype == 1 && D == 128)
    return launch_tc<128, DROP>(q, k, v, mask, o, lse, st, B, S, H, causal,
                                scale, dr, cs);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: 12 int64 element strides on
// the host, (batch, seq, head) for q, k, v and o in turn. Dropout is on when
// rate > 0: inv_keep = 1 / (1 - rate) rounded to f32, seed the int32 seed's
// bits, (b_start, h_start, h_total) the global (batch, head) placement.
// Returns the CUDA error code of the launch (0 on success); the wrapper
// validates shapes, and for bf16 the 16-byte alignment of every row.
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
