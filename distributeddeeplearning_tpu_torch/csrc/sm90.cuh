// Hopper (sm_90a) building blocks for the port's tensor-core kernels,
// written by hand in PTX: cp.async copies into 128-byte-swizzled shared
// memory tiles, TMA copies completing on mbarriers, ldmatrix fragment
// loads, the wgmma shared-memory descriptor of such a tile, and the bf16
// warpgroup product m64n64k16 with f32 accumulators in registers.
//
// Tile layout. A tile holds R rows of a row-major bf16 matrix whose rows
// are D elements (D a multiple of 64). It is stored as D / 64 column
// blocks of R rows x 128 bytes, one after another; inside a block, the
// 16-byte chunk c of row r sits at r * 128 + ((c ^ (r & 7)) << 4). This is
// the 128-byte swizzle that wgmma reads (layout type 1): eight rows form a
// 1024-byte atom, and the XOR spreads a column's eight rows over the 32
// banks. Tiles start on 1024 bytes.
//
// The same tile serves as an operand two ways:
// - K-major (the contracted dimension is the row's D elements): an A of
//   64 rows or a B of 64 columns, for s = q.k^T. Step kk of 16 elements
//   starts kk * 32 bytes into its column block.
// - MN-major (the contracted dimension runs over the rows): a B whose 64
//   columns are one column block, for dq = ds.k. Step kk of 16 rows starts
//   kk * 2048 bytes in.
// Both read 8-row groups 1024 bytes apart.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory without passing through
// registers; valid = false writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// As cp_async16, for one 4-byte word.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Waits until all of this thread's copies have landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Four 8x8 bf16 matrices from shared memory, one register each, in the
// layout of an mma A fragment: lane l gives the address of row l % 8 of
// matrix l / 8 (16 bytes, any 16-byte aligned address). The .trans form
// hands out the matrices transposed.
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// mbarriers in shared memory, for copies by the tensor memory accelerator
// (TMA): one thread arms a barrier with the bytes it expects and issues the
// copies; every waiter spins on the barrier's phase parity.
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// A TMA copy of one box of a 2-D or 3-D tensor map (coordinates innermost
// first, in elements; out-of-bounds elements arrive as zeros) to shared
// memory at dst, completing its bytes on the mbarrier at bar. `map` is the
// generic address of a __grid_constant__ CUtensorMap parameter.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map,
                                            int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// A TMA copy of one box from shared memory at src to a 2-D tensor map
// (elements past the tensor's bounds are not written), in this thread's
// bulk group; wait_read<N> waits until at most N groups still read shared
// memory, wait<N> until at most N are still writing.
__device__ __forceinline__ void tma_store_2d(const void* map, uint32_t src,
                                             int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Fetches a __grid_constant__ tensor map into the descriptor cache.
__device__ __forceinline__ void prefetch_tensormap(const void* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// Plain shared-memory loads and stores at a shared address.
__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}
__device__ __forceinline__ void sts128(uint32_t addr, const uint4& v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}
__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// Orders this thread's writes to shared memory (cp.async, st.shared)
// before later reads by the async proxy, which wgmma reads through.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of 16-byte chunk c (of D / 8) of row r in an R-row tile.
template <int R>
__device__ __forceinline__ uint32_t tile_offset(int r, int c) {
  return static_cast<uint32_t>((c >> 3) * R * 128 + r * 128 +
                               (((c & 7) ^ (r & 7)) << 4));
}

// Issues the copies of rows [row0, row0 + R) of a (rows, D) bf16 matrix
// with row stride `stride` (elements; 16-byte aligned, as `src` is) into
// the tile at shared address `dst`, by THREADS threads; rows at or past
// `rows` are zero.
template <int R, int D, int THREADS>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int row0,
                                          int rows) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  static_assert(R * CHUNKS % THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int e = 0; e < R * CHUNKS / THREADS; ++e) {
    const int i = e * THREADS + threadIdx.x;
    const int r = i / CHUNKS, c = i % CHUNKS;  // powers of two: shifts
    const int row = row0 + r;
    const bool valid = row < rows;
    cp_async16(dst + tile_offset<R>(r, c),
               src + (valid ? row : 0) * stride + c * 8, valid);
  }
}

// The wgmma descriptor of a 128-byte-swizzled operand starting at shared
// address `addr`: 8-row groups 1024 bytes apart (the stride byte offset).
// The leading byte offset is unused by the shapes here (a K-major step
// stays inside one 128-byte row, an MN-major operand is one column block
// wide); K-major operands carry 16 bytes, as CUTLASS writes it, MN-major
// ones 1024.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lead) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lead >> 4) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | 1ull << 62;
}

// K-major step kk (16 elements) of an R-row tile at `tile`.
template <int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return desc(tile + (kk >> 2) * R * 128 + (kk & 3) * 32, 16);
}

// MN-major step kk (16 rows) of column block nb of an R-row tile.
template <int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk, int nb) {
  return desc(tile + nb * R * 128 + kk * 2048, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers in place around a wgmma's issue and wait, so the compiler
// neither reads an accumulator before the product lands nor moves a write
// of a fragment past the product that reads it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Two floats rounded to bf16 and packed, the first in the low half: one
// register of a wgmma A fragment.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

#define SM90_ACC32(d)                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])
#define SM90_REGS32                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}"

// d (64 x 64, f32) = a (64 x 16) . b (16 x 64) + (accumulate ? d : 0), by
// the 128 threads of a warpgroup; a and b from shared memory through their
// descriptors, a K-major, b K-major (TRANS_B 0) or MN-major (1).
// Accumulator register i of thread t holds row 16 (t / 32) + (t % 32) / 4
// + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (t % 4) + i % 2.
template <int TRANS_B>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a,
                                       uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_REGS32
      ", %32, %33, p, 1, 1, 0, %35;\n}\n"
      : SM90_ACC32(d)
      : "l"(a), "l"(b), "r"(accumulate), "n"(TRANS_B));
}

// As mma_ss with a from registers: the A fragment of a 64 x 16 bf16 tile,
// a[0] rows r, a[1] rows r + 8 of columns 2 (t % 4) and + 1, a[2] and
// a[3] the same rows at columns 8 further (r = 16 (t / 32) + (t % 32) / 4):
// the layout of two neighbouring 8-column blocks of an accumulator.
template <int TRANS_B>
__device__ __forceinline__ void mma_rs(float (&d)[32], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : SM90_ACC32(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(accumulate),
        "n"(TRANS_B));
}

#undef SM90_REGS32
#undef SM90_ACC32

}  // namespace sm90
