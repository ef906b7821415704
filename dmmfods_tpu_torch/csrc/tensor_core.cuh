// Warp-level tensor-core and asynchronous-copy primitives for sm_90a, shared
// by the bf16 bodies of K2 (csrc/dense_layer_mma.cuh), K3
// (csrc/phase_head.cu) and K6 (csrc/stem_pool.cu):
//
//   cp.async of 16 or 8 bytes global -> shared (zero-filled when `valid` is
//   false),
//   ldmatrix of four 8x8 bf16 matrices (plain or transposed) or of two
//   (transposed),
//   mma.sync m16n8k16, bf16 inputs, f32 accumulation.
//
// Fragment layouts are PTX's for mma.m16n8k16 .row.col. With `lane` the
// thread's lane:
//   * A (16 x 16, row-major in shared memory): ldsm_x4 with the lane's row
//     address at row (lane % 16), column (lane / 16) * 8 of the tile;
//   * B (16 x 16 as k x n, n contiguous in shared memory): ldsm_x4_trans with
//     the lane's address at row k = lane % 16, column n = (lane / 16) * 8;
//     b[0..1] are the first n8 tile's fragment, b[2..3] the second's; or one
//     n8 tile by ldsm_x2_trans, lanes 0-15 addressing rows k = lane % 16;
//   * C (16 x 8): c[0], c[1] at row lane / 4, columns 2 (lane % 4) and + 1;
//     c[2], c[3] the same columns at row lane / 4 + 8.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to dst (both 16-byte aligned); zeros where !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 8 bytes from src to dst (both 8-byte aligned); zeros where !valid
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// d += a @ b: one m16n8k16 product, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// threadIdx.x, read by an instruction the compiler may not move: a caller
// that loops over tiles cannot hoist what a body derives from it (K2's 3x3
// rows and staging offsets, K6's im2col rows) out of its loop and hold it
// across the accumulators.
__device__ __forceinline__ int thread_index() {
  int tid;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tid));
  return tid;
}

// a 16-byte vector as its four bf16 pairs
__device__ __forceinline__ __nv_bfloat162* pairs(uint4& v) {
  return reinterpret_cast<__nv_bfloat162*>(&v);
}

}  // namespace
