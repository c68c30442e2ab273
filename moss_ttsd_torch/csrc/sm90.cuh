// Hopper (sm_90a) building blocks for the tensor-core attention kernels:
// cp.async copies, the 128-byte shared-memory swizzle, wgmma shared-memory
// descriptors and the two m64n64k16 bf16 wgmma forms the kernels issue.
//
// Shared-memory layout (CUTLASS's SW128 atom): a bf16 tile of R rows by 64
// columns is R rows of 128 bytes; the 16-byte chunk c of row r is stored at
// chunk c ^ (r % 8). Eight rows (1024 bytes) form one swizzle atom, so every
// tile starts 1024-byte aligned. A row wider than 64 bf16 is cut into 64-wide
// panels of R x 128 bytes each, stored one after the other.
//
// The same bytes serve both operand orders:
//   * K-major (the contraction dim is the row): Q and K for S = Q K^T; the
//     descriptor of k-step kk starts (kk % 4) * 32 bytes into panel kk / 4;
//   * MN-major (the contraction dim runs down the rows): V for O += P V
//     (rows are keys, columns are head dims), read with the transpose flag;
//     k-step kk (16 keys) starts kk * 2048 bytes into a 64-column panel.
// Each descriptor covers one 64-column panel, so the offset between 8-row
// groups (1024 bytes) is the only stride the hardware walks; it is written
// into both offset fields, which makes the descriptor the same whichever of
// the two fields a layout reads for it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- cp.async
// 16-byte global -> shared copy; pred false writes 16 zero bytes and reads
// nothing (src-size 0), so a ragged tile edge is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                   "r"(smem_u32(dst)), "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
// 4-byte copy (through L1: cp.async takes less than 16 bytes only as .ca);
// pred false writes 4 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::
                   "r"(smem_u32(dst)), "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Make this thread's generic-proxy shared-memory writes (cp.async included)
// visible to the async proxy that wgmma reads through; follow with a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------------- swizzle
// Byte offset of 16-byte chunk c (0..7) of row r inside one SW128 panel.
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

// wgmma shared-memory descriptor: start address, both offsets 1024 bytes
// (see above), 128-byte swizzle (layout type 1 in bits 62-63).
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1024 >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// ---------------------------------------------------------------- wgmma
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
// Pin accumulator registers after a wait, so no read of them is scheduled
// before the asynchronous product has landed.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define MOSS_WGMMA_D32                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define MOSS_WGMMA_OUT32(d)                                                  \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])

// D(64x64 fp32) (+)= A(64x16 bf16, shared, K-major) * B(16x64 bf16, shared,
// K-major). scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MOSS_WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : MOSS_WGMMA_OUT32(d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D(64x64 fp32) (+)= A(64x16 bf16, registers) * B(16x64 bf16, shared,
// MN-major: the transpose flag is set).
__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float (&d)[32],
                                                      const uint32_t (&a)[4],
                                                      uint64_t desc_b,
                                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MOSS_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : MOSS_WGMMA_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

#undef MOSS_WGMMA_OUT32
#undef MOSS_WGMMA_D32

// Two floats -> one bf16x2 register (lo in the low half), the A-fragment
// element order of wgmma.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace sm90
