// Pieces shared by the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu): the FMA kernels' tiling, strides, and the
// counter-based dropout hash.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace flash {

constexpr int BQ = 64;         // query rows per block (fwd, dq)
constexpr int THREADS = 128;
constexpr int GROUP = 8;       // lanes sharing a row group
constexpr int ROW_GROUPS = THREADS / GROUP;
constexpr float NEG = -1e30f;  // the TPU kernels' masked-score value

// (batch, seq, head) element strides of one (B, S, H, D) operand; the head
// dim is contiguous.
struct Strides3 {
  long long b, s, h;
};

// Attention-probability dropout: keep_threshold(rate), 1 / (1 - rate)
// rounded to f32 as the TPU kernels multiply by it, the seed's bits as
// uint32, and the offsets that place this call's (batch, head) range in
// global coordinates.
struct Dropout {
  uint32_t keep_from;
  float inv_keep;
  uint32_t seed;
  int b_start, h_start, h_total;
};

// The global batch*head coordinate of grid row (b, h) of a call with H
// local heads, premultiplied by the hash's batch*head constant.
__device__ __forceinline__ uint32_t bh_term(const Dropout& dr, int b, int h) {
  const uint32_t bh = static_cast<uint32_t>((dr.b_start + b) * dr.h_total +
                                            dr.h_start + h);
  return bh * 0xC2B2AE35u;
}

// keep(bh, row, col): ops/hash_dropout.py's keep_mask, bit for bit. The
// murmur3 finalizer over a linear combine of the global coordinates; the
// uniform float32(h) * 2^-32 is kept iff >= float32(rate), which is
// h >= dr.keep_from.
__device__ __forceinline__ bool keep(const Dropout& dr, uint32_t bh_c,
                                     uint32_t row, uint32_t col) {
  uint32_t h = (row * 0x9E3779B9u) ^ (col * 0x85EBCA6Bu) ^ bh_c;
  h ^= dr.seed;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h >= dr.keep_from;
}

// The least h whose uniform float32(h) * 2^-32 is >= rate: rounding to
// float32 is monotone, so keep() needs one integer compare. Host code;
// rate in [0, 1).
inline uint32_t keep_threshold(float rate) {
  uint64_t lo = 0, hi = 0xFFFFFFFFull;  // float32(2^32 - 1) * 2^-32 = 1
  while (lo < hi) {
    const uint64_t mid = (lo + hi) / 2;
    if (static_cast<float>(static_cast<uint32_t>(mid)) * 0x1p-32f >= rate)
      hi = mid;
    else
      lo = mid + 1;
  }
  return static_cast<uint32_t>(lo);
}

}  // namespace flash
