// Pieces shared by the port's tensor-core BatchNorm products for Hopper
// (sm_90a): the bf16 3x3 forward and dw of conv3x3_tc.cuh (#11, #13) and
// the bf16 1x1 forward, dx and dw of fused_linear_bn.cu (#8-#10). On the
// device: the layout of a 64-channel row of a TMA box, bn's prologue and
// dY = dy + ds + 2 y dss for the 8 channels of one 16-byte chunk, in place
// in shared memory.
// On the host: the TMA tensor maps of row-major (M, C) activations and the
// split of a persistent grid over the card's SMs.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

namespace bntc {

constexpr int ROW = 128;  // bytes of a tile row: 64 channels of bf16

enum Prologue { NONE = 0, AFFINE = 1, AFFINE_RELU = 2 };

// Byte offset of 16-byte chunk c (of 8) of row r in a 128-byte-swizzled
// run of rows: the layout of sm90.cuh's tiles, one column block wide, and
// of a TMA box of 64 channels with CU_TENSOR_MAP_SWIZZLE_128B.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * ROW + (((c ^ r) & 7) << 4));
}

__host__ inline int round_up(int v, int to) { return (v + to - 1) / to * to; }

// The 8 floats of p[c .. c + 7] by two 16-byte loads (c a multiple of 8,
// p 16-byte aligned), or zeros where c is past C (a multiple of 8, so a
// chunk is in or out whole).
__device__ __forceinline__ void load8(const float* p, int c, int C,
                                      float (&v)[8]) {
  float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
  if (c < C) {
    lo = __ldg(reinterpret_cast<const float4*>(p + c));
    hi = __ldg(reinterpret_cast<const float4*>(p + c + 4));
  }
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = lo.z;
  v[3] = lo.w;
  v[4] = hi.x;
  v[5] = hi.y;
  v[6] = hi.z;
  v[7] = hi.w;
}

// bn's prologue for the 8 channels of one 16-byte chunk, in the order of
// bn_gemm.cuh's Source::apply: (x - mu) * (inv * gamma) + beta, ReLU,
// rounded to bf16. Channels past C take mu = scale = beta = 0, so a
// zero-filled chunk stays 0. c and C are multiples of 8, the vectors
// 16-byte aligned (the wrappers check).
struct Affine {
  float mu[8], scale[8], beta[8];

  __device__ __forceinline__ void load(const float* mu_, const float* inv,
                                       const float* gamma, const float* beta_,
                                       int c, int C) {
    float g[8];
    load8(mu_, c, C, mu);
    load8(inv, c, C, scale);
    load8(gamma, c, C, g);
    load8(beta_, c, C, beta);
#pragma unroll
    for (int j = 0; j < 8; ++j) scale[j] = __fmul_rn(scale[j], g[j]);
  }

  __device__ __forceinline__ uint4 apply(uint4 v, bool relu) const {
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = __bfloat1622float2(h[q]);
      float t0 = __fadd_rn(__fmul_rn(__fsub_rn(f.x, mu[2 * q]),
                                     scale[2 * q]), beta[2 * q]);
      float t1 = __fadd_rn(__fmul_rn(__fsub_rn(f.y, mu[2 * q + 1]),
                                     scale[2 * q + 1]), beta[2 * q + 1]);
      if (relu) {
        t0 = fmaxf(t0, 0.f);
        t1 = fmaxf(t1, 0.f);
      }
      h[q] = __floats2bfloat162_rn(t0, t1);
    }
    return v;
  }
};

// Applies the prologue in place to the `rows` rows of a 64-channel run, by
// nthreads threads (a multiple of 8): thread t always takes chunk t % 8,
// whose channels `af` holds.
__device__ __forceinline__ void apply_prologue(uint32_t slab, int rows,
                                               const Affine& af, bool relu,
                                               int tid, int nthreads) {
  const int c = tid & 7;
  for (int r = tid >> 3; r < rows; r += nthreads >> 3) {
    const uint32_t p = slab + swz(r, c);
    sm90::sts128(p, af.apply(sm90::lds128(p), relu));
  }
}

// dY = dy + ds + 2 y dss for the 8 output channels of one 16-byte chunk,
// in the order of bn_gemm.cuh's Source::apply (DY), rounded to bf16.
// Channels past N take ds = dss = 0, so a zero-filled chunk stays 0 (n and
// N multiples of 8, as Affine's).
struct DyTerms {
  float ds[8], dss[8];

  __device__ __forceinline__ void load(const float* ds_, const float* dss_,
                                       int n, int N) {
    load8(ds_, n, N, ds);
    load8(dss_, n, N, dss);
  }

  __device__ __forceinline__ uint4 apply(uint4 d, const uint4& yv) const {
    __nv_bfloat162* dh = reinterpret_cast<__nv_bfloat162*>(&d);
    const __nv_bfloat162* yh = reinterpret_cast<const __nv_bfloat162*>(&yv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 fd = __bfloat1622float2(dh[j]);
      const float2 fy = __bfloat1622float2(yh[j]);
      const float v0 = __fadd_rn(__fadd_rn(fd.x, ds[2 * j]),
                                 __fmul_rn(__fmul_rn(2.f, fy.x), dss[2 * j]));
      const float v1 = __fadd_rn(
          __fadd_rn(fd.y, ds[2 * j + 1]),
          __fmul_rn(__fmul_rn(2.f, fy.y), dss[2 * j + 1]));
      dh[j] = __floats2bfloat162_rn(v0, v1);
    }
    return d;
  }
};

// dY = dy + ds + 2 y dss in place of dy over the `rows` rows of a
// 64-channel run (y's run at sy), as apply_prologue shares it out; rows at
// or past `valid` are set to 0 (dy and y arrive as 0 there, ds does not
// vanish).
__device__ __forceinline__ void apply_dy(uint32_t sdy, uint32_t sy, int rows,
                                         const DyTerms& dyt, int tid,
                                         int nthreads,
                                         int valid = 0x7FFFFFFF) {
  const int c = tid & 7;
  for (int r = tid >> 3; r < rows; r += nthreads >> 3) {
    const uint32_t off = swz(r, c);
    sm90::sts128(sdy + off, r < valid ? dyt.apply(sm90::lds128(sdy + off),
                                                  sm90::lds128(sy + off))
                                      : make_uint4(0u, 0u, 0u, 0u));
  }
}

// ---------------------------------------------------------------------------
// Host
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query (so a library links nothing beyond the runtime).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a row-major bf16 tensor of dims (innermost first) and
// the row strides of the outer dims (bytes), read in boxes of `box`,
// 128-byte-swizzled, out-of-bounds elements zero. Returns a CUDA error.
inline int tensor_map(CUtensorMap* map, const void* base, int rank,
                      const cuuint64_t* dims, const cuuint64_t* strides,
                      const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// (M, C) channels-last activations in boxes of 64 channels x `rows`.
inline int rows_map(CUtensorMap* map, const void* base, long long M, int C,
                    int rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(M)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(C) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(rows)};
  return tensor_map(map, base, 2, dims, strides, box);
}

inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

// Tiles a block of a persistent grid: one block an SM over `units`
// independent column blocks, each walking a run of `tiles`; normalised so
// that cdiv(tiles, cdiv(tiles, per)) == per.
inline long long tc_per(long long tiles, long long units) {
  auto cdiv = [](long long a, long long b) { return (a + b - 1) / b; };
  const long long sms = sm_count();
  long long s = units >= sms ? 1 : sms / units;
  if (s > tiles) s = tiles;
  if (s < 1) s = 1;
  const long long per = cdiv(tiles, s);
  return cdiv(tiles, cdiv(tiles, per));
}

}  // namespace bntc
