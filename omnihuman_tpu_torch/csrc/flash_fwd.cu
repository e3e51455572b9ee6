// Flash-attention forward for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces the TPU Pallas kernels omnihuman_tpu/ops/flash_pallas.py
// `_fwd_kernel` (Lk <= block_k, DiT cross-attention) and `_fwd_kernel_u2`
// (Lk > block_k, DiT self-attention) with ONE kernel: the unroll-by-2 of the
// TPU version is a VLIW schedule and has no counterpart here.
//
// What it computes, per (batch b, head h):
//   O = softmax(scale * Q K^T + mask) V
// on the native [B, L, N, D] layout, with online softmax (fp32 m / l / acc).
// Mask: key index < k_lens[b] (clamped to Lk by the caller), plus optional
// causal / (left, right) window masks evaluated in global coordinates
// shifted by (q_off, k_off) and Lk - Lq (flash_pallas._mask_block). Rows
// with no valid key are written as exactly 0. Ragged Lq / Lk are masked
// here: out-of-range rows are zero-filled on load and never stored.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s):
//   self-attention B=2, L=32768, N=12, D=128: 4*B*N*L^2*D = 1.32e13 FLOP
//   -> 13.3 ms; its bytes (q, k, v, o = 805 MB) take 0.24 ms. Compute-bound.
//   cross-attention Lq=32768, Lk<=512: 2.1e11 FLOP -> 0.21 ms, while its
//   Q and O bytes alone take 0.12 ms. Near the ridge / bandwidth-bound.
//
// What the design does about it (deliberately simple, FA2-style):
//   - both products run on the tensor cores through mma.sync m16n8k16
//     (bf16 x bf16 -> fp32); a scalar-FMA kernel would be ~15x slower;
//   - one 256-thread block per (b, h, 128-row Q tile): each of 8 warps owns
//     16 query rows, keeps its Q fragments and its O accumulator in
//     registers, and P never leaves registers (the S accumulator layout of
//     mma.sync is re-packed as the A operand of P.V);
//   - K/V tiles of 64 keys stream through shared memory with cp.async; the
//     next K tile loads while softmax and P.V run, the next V tile while the
//     next Q.K^T runs;
//   - tiles past k_len (and, with causal / window masks, tiles masked for
//     every row of the block) are skipped, so a cross-attention to a
//     37-token prompt reads one K/V tile, not 512 keys;
//   - wgmma, TMA, warp specialisation and a persistent schedule are left
//     to a later change.
//
// C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 128;             // query rows per block
constexpr int kBlockN = 64;              // keys per K/V tile
constexpr int kWarps = kBlockM / 16;     // one warp per 16 query rows
constexpr int kThreads = kWarps * 32;
// Must stay FINITE: exp2(kNegInf - kNegInf) = 1 keeps alpha finite on rows
// that have not met a valid key yet (flash_pallas.py NEG_INF note).
constexpr float kNegInf = -1e30f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
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

// Four transposed 8x8 b16 matrices from shared memory (B operands of P.V).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [row0, row0 + nrows) of one head into shared memory (row pitch
// D + 8 halves: conflict-free fragment loads); rows >= valid_end are zeros.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int row0, int valid_end,
                                          size_t row_stride, int nrows) {
  constexpr int kChunks = D / 8;       // 16-byte chunks per row
  constexpr int kLd = D + 8;
  for (int i = threadIdx.x; i < nrows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const int row = row0 + r;
    const bool ok = row < valid_end;
    const bf16* g = src + (size_t)(ok ? row : 0) * row_stride + c * 8;
    cp_async16(dst + r * kLd + c * 8, g, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 const int* __restrict__ k_lens, int Lq, int Lk, int N,
                 float scale_log2, int causal, int win_left, int win_right,
                 int q_off, int k_off) {
  constexpr int kLd = D + 8;
  constexpr int kKSteps = D / 16;        // k-steps of Q.K^T
  constexpr int kDTiles = D / 8;         // n-tiles of P.V
  constexpr int kNTiles = kBlockN / 8;   // n-tiles of Q.K^T

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kBlockM * kLd;
  bf16* sV = sK + kBlockN * kLd;

  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;   // mma fragment row / column pair

  const size_t row_stride = (size_t)N * D;
  const bf16* qb = q + (size_t)b * Lq * row_stride + (size_t)h * D;
  const bf16* kb = k + (size_t)b * Lk * row_stride + (size_t)h * D;
  const bf16* vb = v + (size_t)b * Lk * row_stride + (size_t)h * D;
  bf16* ob = o + (size_t)b * Lq * row_stride + (size_t)h * D;

  // Keys this block can see. kg - qg = k_idx - q_idx - diag in global
  // coordinates (flash_pallas._mask_block).
  const int k_valid = min(max(k_lens[b], 0), Lk);
  const bool idx_mask = causal || win_left >= 0 || win_right >= 0;
  const int diag = q_off + (Lk - Lq) - k_off;
  int kv_begin = 0, kv_end = k_valid;
  if (idx_mask) {
    const int q_last = min(q0 + kBlockM, Lq) - 1;
    if (causal) kv_end = min(kv_end, q_last + diag + 1);
    if (win_right >= 0) kv_end = min(kv_end, q_last + diag + win_right + 1);
    if (win_left >= 0) kv_begin = max(0, q0 + diag - win_left);
    kv_begin = (kv_begin / kBlockN) * kBlockN;
  }
  const int n_tiles =
      kv_end > kv_begin ? (kv_end - kv_begin + kBlockN - 1) / kBlockN : 0;

  // group 0: Q and K_0; group 1: V_0
  load_rows<D>(sQ, qb, q0, Lq, row_stride, kBlockM);
  if (n_tiles > 0) load_rows<D>(sK, kb, kv_begin, kv_end, row_stride, kBlockN);
  cp_async_commit();
  if (n_tiles > 0) load_rows<D>(sV, vb, kv_begin, kv_end, row_stride, kBlockN);
  cp_async_commit();
  cp_async_wait_one();
  __syncthreads();

  uint32_t qf[kKSteps][4];
  {
    const bf16* qw = sQ + (warp * 16 + g) * kLd + 2 * t;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      qf[ks][0] = ld_u32(qw + ks * 16);
      qf[ks][1] = ld_u32(qw + 8 * kLd + ks * 16);
      qf[ks][2] = ld_u32(qw + ks * 16 + 8);
      qf[ks][3] = ld_u32(qw + 8 * kLd + ks * 16 + 8);
    }
  }

  float acc[kDTiles][4];
#pragma unroll
  for (int i = 0; i < kDTiles; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};            // per-thread partial row sums
  const int row_a = q0 + warp * 16 + g;   // rows of c0,c1 / c2,c3
  const int rows[2] = {row_a, row_a + 8};

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = kv_begin + j * kBlockN;
    if (j > 0) {                           // K_j has landed
      cp_async_wait_one();
      __syncthreads();
    }

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[kNTiles][4];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const bf16* kr = sK + (nt * 8 + g) * kLd + 2 * t;
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks)
        mma_16816(s[nt], qf[ks], ld_u32(kr + ks * 16), ld_u32(kr + ks * 16 + 8));
    }
    __syncthreads();                       // every warp is done with sK
    const bool more = j + 1 < n_tiles;
    if (more)
      load_rows<D>(sK, kb, k0 + kBlockN, kv_end, row_stride, kBlockN);
    cp_async_commit();

    // mask, scale into the log2 domain, online softmax
    float tmax[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        const int row = rows[e >> 1];
        bool ok = col < k_valid;
        if (idx_mask) {
          const int rel = col - row - diag;          // kg - qg
          if (causal) ok = ok && rel <= 0;
          if (win_left >= 0) ok = ok && -rel <= win_left;
          if (win_right >= 0) ok = ok && rel <= win_right;
        }
        s[nt][e] = ok ? s[nt][e] * scale_log2 : kNegInf;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], s[nt][e]);
      }
    }
    float alpha[2], m_new[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      m_new[r] = fmaxf(m_run[r], tmax[r]);
      alpha[r] = exp2f(m_run[r] - m_new[r]);
      m_run[r] = m_new[r];
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[nt][e];
        const float p = x > 0.5f * kNegInf ? exp2f(x - m_new[e >> 1]) : 0.f;
        s[nt][e] = p;
        psum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + psum[r];
#pragma unroll
    for (int i = 0; i < kDTiles; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }

    cp_async_wait_one();                   // V_j has landed
    __syncthreads();

    // O += P V: the S accumulators of n-tiles 2kk, 2kk+1 are the A operand
    const int mat = lane >> 3, r8 = lane & 7;
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const bf16* vrow = sV + (kk * 16 + (mat & 1) * 8 + r8) * kLd + (mat >> 1) * 8;
#pragma unroll
      for (int dt = 0; dt < kDTiles; dt += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vrow + dt * 8);
        mma_16816(acc[dt], pa, vf[0], vf[1]);
        mma_16816(acc[dt + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();                       // every warp is done with sV
    if (more)
      load_rows<D>(sV, vb, k0 + kBlockN, kv_end, row_stride, kBlockN);
    cp_async_commit();
  }

  // finalize: rows that never met a valid key are exactly 0
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const bool valid = m_run[r] > 0.5f * kNegInf;
    inv[r] = valid ? 1.f / (l == 0.f ? 1.f : l) : 0.f;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= Lq) continue;
    bf16* orow = ob + (size_t)rows[r] * row_stride + 2 * t;
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8) =
          pack_bf16(acc[dt][2 * r] * inv[r], acc[dt][2 * r + 1] * inv[r]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const int* k_lens, int B, int Lq, int Lk, int N, float scale_log2,
           int causal, int win_left, int win_right, int q_off, int k_off,
           cudaStream_t stream) {
  constexpr int kSmem = (kBlockM + 2 * kBlockN) * (D + 8) * 2;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((Lq + kBlockM - 1) / kBlockM, N, B);
  flash_fwd_kernel<D><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), k_lens, Lq, Lk, N,
      scale_log2, causal, win_left, win_right, q_off, k_off);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* omni_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int omni_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                   void* o, const void* k_lens, int B, int Lq,
                                   int Lk, int N, int D, float scale,
                                   int causal, int win_left, int win_right,
                                   int q_off, int k_off, void* stream) {
  if (B <= 0 || Lq <= 0 || N <= 0) return (int)cudaSuccess;
  const float scale_log2 = scale * 1.4426950408889634f;
  const int* kl = static_cast<const int*>(k_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, o, kl, B, Lq, Lk, N, scale_log2, causal,
                        win_left, win_right, q_off, k_off, s);
    case 128:
      return launch<128>(q, k, v, o, kl, B, Lq, Lk, N, scale_log2, causal,
                         win_left, win_right, q_off, k_off, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
