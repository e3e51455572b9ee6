// Device helpers shared by the port's kernels: cp.async copies, mma.sync
// m16n8k16 (bf16 x bf16 -> fp32) and ldmatrix for the mma.sync kernel
// (vae_upsample.cu), bf16 packing, the softmax constants and the mask of
// flash_pallas._mask_block. The wgmma kernels take some of these too
// (flash_fwd.cu and flash_bwd.cu the mask, the constants and the packing,
// vae_conv.cu ldmatrix and the packing); their own helpers are in
// hopper_common.cuh.
//
// Fragment layout of mma.sync m16n8k16 (lane = 4 * g + t):
//   A (16x16, row-major): a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..2t+1],
//                         a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9]
//   B (16x8, "col"):      b0 = B[2t..2t+1][g],   b1 = B[2t+8..2t+9][g]
//   C (16x8, fp32):       c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1]
// So the C fragments of two neighbouring n-tiles, packed to bf16, are the A
// fragment of the next product over those 16 columns (P never leaves
// registers), and a row-major tile in shared memory gives B fragments of
// its transpose with plain 32-bit loads, or of itself through
// ldmatrix.trans.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace omni {

typedef __nv_bfloat16 bf16;

// The LSE of a row with no valid key, finite as flash_pallas.py's NEG_INF
// (the forward keeps its own running max at -inf and never subtracts two
// infinities; the backward applies the mask before the exponential).
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; valid = false zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// D[16x8] += A[16x16] * B[16x8], bf16 inputs, fp32 accumulate.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8 (16 contiguous bytes each, any rows).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Four transposed 8x8 b16 matrices from shared memory.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

// flash_pallas._mask_block on one (query row, key col) pair, given
// k_valid = min(k_lens[b], Lk) and diag = q_off + (Lk - Lq) - k_off, so
// that col - row - diag = kg - qg in global coordinates.
struct Mask {
  int k_valid, diag, causal, left, right;
  bool idx;   // any index mask (causal or window) at all

  __device__ __forceinline__ bool operator()(int row, int col) const {
    bool ok = col < k_valid;
    if (idx) {
      const int rel = col - row - diag;
      if (causal) ok = ok && rel <= 0;
      if (left >= 0) ok = ok && -rel <= left;
      if (right >= 0) ok = ok && rel <= right;
    }
    return ok;
  }
};

}  // namespace omni
