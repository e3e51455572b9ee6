// Device helpers shared by the port's kernels: ldmatrix, bf16 packing,
// the softmax constants and the mask of flash_pallas._mask_block
// (flash_fwd.cu and flash_bwd.cu take the mask, the constants and the
// packing; vae_conv.cu and vae_upsample.cu ldmatrix, which gathers their
// register-A fragments from the swizzled halo, and the packing). The
// Hopper helpers (wgmma, TMA, mbarriers) are in hopper_common.cuh.

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

// Four 8x8 b16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8 (16 contiguous bytes each, any rows).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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
