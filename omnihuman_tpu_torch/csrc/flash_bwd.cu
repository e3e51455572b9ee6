// Flash-attention backward for Hopper (sm_90a): bf16 q/k/v/dO in, bf16
// dq/dk/dv out, fp32 LSE / delta / accumulators.
//
// Replaces the TPU Pallas kernels of omnihuman_tpu/ops/flash_pallas.py
// with two kernels that keep the TPU split, so neither needs atomics and
// the gradients are deterministic:
//   flash_bwd_dkdv_kernel <- `_bwd_dkdv_kernel` (:387): one block per
//     (b, head, 128-key tile); the K/V tile stays in shared memory and the
//     block loops over 32-query tiles, accumulating
//       dV += P^T dO,  dK += dS^T Q;
//   flash_bwd_dq_kernel   <- `_bwd_dq_kernel` (:437): one block per
//     (b, head, 128-query tile); the Q/dO tile stays in shared memory and
//     the block loops over 64-key tiles, accumulating  dQ += dS K.
// Both recompute, per tile,
//   S = scale * Q K^T,  P = where(mask, exp(S - lse), 0),  dP = dO V^T,
//   dS = P * (dP - delta) * scale,
// with lse from the forward (flash_fwd.cu, natural log; -1e30 on a row with
// no valid key: the mask is applied BEFORE the exponential, exp(s + 1e30)
// would be inf) and delta = rowsum(dO * O) computed in fp32 by the caller
// from the stored bf16 O. P and dS are rounded to bf16 before their products,
// as the Pallas kernels do (`p.astype(do.dtype)`, `ds.astype(q.dtype)`).
// The mask is the forward's (flash_pallas._mask_block): key < k_lens[b],
// causal and (left, right) window in global coordinates shifted by
// (q_off, k_off) and Lk - Lq. Keys at or past k_len get dK = dV = 0. Ragged
// Lq / Lk tails are zero-filled on load, masked, and never stored.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s), for
// B=1, N=12, D=128, L=32768 self-attention:
//   dkdv: four products (S, dP, dV, dK) = 8*N*Lq*Lk*D = 1.32e13 FLOP -> 13.3 ms
//   dq:   three products (S, dP, dQ)   = 6*N*Lq*Lk*D = 9.9e12 FLOP  -> 10.0 ms
// Both are compute-bound (their bytes take ~0.1 ms). The gradient itself
// needs five products (16.7 ms); the TPU split recomputes S and dP in both
// kernels, so the pair can reach at most 71% of that bound.
//
// What the design does about it (deliberately simple, FA2-style, no wgmma
// or TMA yet): every product runs on the tensor cores through mma.sync
// m16n8k16; each of 8 warps owns 16 rows of the resident tile (keys in
// dkdv, queries in dq) and keeps its fp32 accumulators in registers; S and
// dP stay in registers and their C fragments are re-packed as the A operand
// of the next product; the streamed tiles are double-buffered in shared
// memory with cp.async. Register budget (the risk here): dkdv holds two fp32
// [16, D] accumulators per warp (128 registers a thread at D=128), so its
// streamed query tile is only 32 rows (S^T and dP^T: 16 registers each);
// dq holds one (64) and streams 64 keys. Tiles that the k_len / causal /
// window mask empties are skipped.
//
// C interface for ctypes; each entry returns cudaGetLastError() after the
// launch.

#include "flash_common.cuh"

namespace {

using namespace omni;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kDkdvBlockK = kWarps * 16;   // resident keys per dkdv block
constexpr int kDkdvBlockQ = 32;            // streamed queries per step
constexpr int kDqBlockQ = kWarps * 16;     // resident queries per dq block
constexpr int kDqBlockK = 64;              // streamed keys per step

template <int D>
constexpr int dkdv_smem_bytes() {
  return (2 * kDkdvBlockK + 4 * kDkdvBlockQ) * (D + 8) * 2 +
         4 * kDkdvBlockQ * 4;
}

template <int D>
constexpr int dq_smem_bytes() {
  return (2 * kDqBlockQ + 4 * kDqBlockK) * (D + 8) * 2;
}

// Zero rows [row0, row_end) of one head of a [B, L, N, D] bf16 tensor.
template <int D>
__device__ __forceinline__ void zero_rows(bf16* dst, int row0, int row_end,
                                          size_t row_stride) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < (row_end - row0) * kChunks; i += kThreads) {
    const int r = row0 + i / kChunks, c = i % kChunks;
    *reinterpret_cast<uint4*>(dst + (size_t)r * row_stride + c * 8) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// One warp's [16, D] fp32 accumulator (C fragments of D/8 n-tiles) as bf16
// rows row0 + g and row0 + g + 8; rows >= row_end are not stored.
template <int D>
__device__ __forceinline__ void store_acc(bf16* dst, const float (&acc)[D / 8][4],
                                          int row0, int row_end,
                                          size_t row_stride, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= row_end) continue;
    bf16* out = dst + (size_t)row * row_stride + 2 * t;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(out + dt * 8) =
          pack_bf16(acc[dt][2 * r], acc[dt][2 * r + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int* __restrict__ k_lens, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int Lq, int Lk, int N,
                      float scale, int causal, int win_left, int win_right,
                      int q_off, int k_off) {
  constexpr int kLd = D + 8;
  constexpr int kKSteps = D / 16;           // k-steps of K.Q^T and V.dO^T
  constexpr int kDTiles = D / 8;            // n-tiles of dV and dK
  constexpr int kNTiles = kDkdvBlockQ / 8;  // n-tiles of S^T and dP^T

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kDkdvBlockK * kLd;
  bf16* sQ = sV + kDkdvBlockK * kLd;              // [2][kDkdvBlockQ][kLd]
  bf16* sdO = sQ + 2 * kDkdvBlockQ * kLd;         // [2][kDkdvBlockQ][kLd]
  float* sL = reinterpret_cast<float*>(sdO + 2 * kDkdvBlockQ * kLd);
  float* sDelta = sL + 2 * kDkdvBlockQ;           // [2][kDkdvBlockQ]

  const int k0 = blockIdx.x * kDkdvBlockK;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  const size_t row_stride = (size_t)N * D;
  const size_t q_base = (size_t)b * Lq * row_stride + (size_t)h * D;
  const size_t k_base = (size_t)b * Lk * row_stride + (size_t)h * D;
  const float* lse_b = lse + ((size_t)b * N + h) * Lq;
  const float* delta_b = delta + ((size_t)b * N + h) * Lq;
  const int k_end = min(k0 + kDkdvBlockK, Lk);

  Mask mask;
  mask.k_valid = min(max(k_lens[b], 0), Lk);
  mask.diag = q_off + (Lk - Lq) - k_off;
  mask.causal = causal;
  mask.left = win_left;
  mask.right = win_right;
  mask.idx = causal || win_left >= 0 || win_right >= 0;

  // Queries that can see a key of this tile (kg - qg = key - q - diag).
  int q_begin = 0, q_end = Lq;
  const int k_hi = min(k_end, mask.k_valid);   // past the tile's last valid key
  if (k0 >= k_hi) q_end = 0;
  if (mask.idx && q_end > 0) {
    if (causal) q_begin = max(q_begin, k0 - mask.diag);
    if (win_right >= 0) q_begin = max(q_begin, k0 - mask.diag - win_right);
    if (win_left >= 0) q_end = min(q_end, k_hi - 1 + win_left - mask.diag + 1);
    q_begin = (max(q_begin, 0) / kDkdvBlockQ) * kDkdvBlockQ;
  }
  const int n_qt =
      q_end > q_begin ? (q_end - q_begin + kDkdvBlockQ - 1) / kDkdvBlockQ : 0;
  if (n_qt == 0) {                  // no query sees these keys: zero grads
    zero_rows<D>(dk + k_base, k0, k_end, row_stride);
    zero_rows<D>(dv + k_base, k0, k_end, row_stride);
    return;
  }

  auto load_q_tile = [&](int j, int stage) {
    const int qt = q_begin + j * kDkdvBlockQ;
    load_rows<D, kThreads>(sQ + stage * kDkdvBlockQ * kLd, q + q_base, qt, Lq,
                           row_stride, kDkdvBlockQ);
    load_rows<D, kThreads>(sdO + stage * kDkdvBlockQ * kLd, dout + q_base, qt,
                           Lq, row_stride, kDkdvBlockQ);
    if (threadIdx.x < kDkdvBlockQ) {
      const int row = qt + threadIdx.x;
      const bool ok = row < Lq;
      sL[stage * kDkdvBlockQ + threadIdx.x] = ok ? lse_b[row] * kLog2e : 0.f;
      sDelta[stage * kDkdvBlockQ + threadIdx.x] = ok ? delta_b[row] : 0.f;
    }
  };

  // group 0: the resident K / V tile and query tile 0
  load_rows<D, kThreads>(sK, k + k_base, k0, Lk, row_stride, kDkdvBlockK);
  load_rows<D, kThreads>(sV, v + k_base, k0, Lk, row_stride, kDkdvBlockK);
  load_q_tile(0, 0);
  cp_async_commit();

  float acc_dk[kDTiles][4], acc_dv[kDTiles][4];
#pragma unroll
  for (int i = 0; i < kDTiles; ++i) {
    acc_dk[i][0] = acc_dk[i][1] = acc_dk[i][2] = acc_dk[i][3] = 0.f;
    acc_dv[i][0] = acc_dv[i][1] = acc_dv[i][2] = acc_dv[i][3] = 0.f;
  }
  const float scale_log2 = scale * kLog2e;
  const int key_row = k0 + warp * 16 + g;     // keys of c0,c1 / c2,c3: +0, +8
  const bf16* kw = sK + warp * 16 * kLd;
  const bf16* vw = sV + warp * 16 * kLd;
  const int mat = lane >> 3, r8 = lane & 7;   // ldmatrix.x4 addressing

  for (int j = 0; j < n_qt; ++j) {
    const int stage = j & 1;
    const int qt = q_begin + j * kDkdvBlockQ;
    // stage^1 was last read in step j-1, which ended with __syncthreads()
    if (j + 1 < n_qt) load_q_tile(j + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait_one();                      // step j's tile has landed
    __syncthreads();
    const bf16* qs = sQ + stage * kDkdvBlockQ * kLd;
    const bf16* dos = sdO + stage * kDkdvBlockQ * kLd;
    const float* ls = sL + stage * kDkdvBlockQ;
    const float* des = sDelta + stage * kDkdvBlockQ;

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x 32 queries
    float s[kNTiles][4], dp[kNTiles][4];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      uint32_t ka[4], va[4];
      load_a_frag(ka, kw + ks * 16, kLd, g, t);
      load_a_frag(va, vw + ks * 16, kLd, g, t);
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        const bf16* qr = qs + (nt * 8 + g) * kLd + ks * 16 + 2 * t;
        const bf16* dr = dos + (nt * 8 + g) * kLd + ks * 16 + 2 * t;
        mma_16816(s[nt], ka, ld_u32(qr), ld_u32(qr + 8));
        mma_16816(dp[nt], va, ld_u32(dr), ld_u32(dr + 8));
      }
    }

    // P^T = where(mask, exp(S^T - lse), 0); dS^T = P^T (dP^T - delta) scale
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * t + (e & 1);   // query within the tile
        const int row = qt + c;
        const int key = key_row + 8 * (e >> 1);
        const bool ok = row < Lq && mask(row, key);
        const float p = ok ? exp2f(s[nt][e] * scale_log2 - ls[c]) : 0.f;
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - des[c]) * scale;
      }
    }

    // dV += P^T dO and dK += dS^T Q over the tile's 32 queries
#pragma unroll
    for (int kk = 0; kk < kDkdvBlockQ / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const uint32_t da[4] = {
          pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
          pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
          pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
          pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
      const int off = (kk * 16 + (mat & 1) * 8 + r8) * kLd + (mat >> 1) * 8;
#pragma unroll
      for (int dt = 0; dt < kDTiles; dt += 2) {
        uint32_t f[4];
        ldmatrix_x4_trans(f, dos + off + dt * 8);
        mma_16816(acc_dv[dt], pa, f[0], f[1]);
        mma_16816(acc_dv[dt + 1], pa, f[2], f[3]);
        ldmatrix_x4_trans(f, qs + off + dt * 8);
        mma_16816(acc_dk[dt], da, f[0], f[1]);
        mma_16816(acc_dk[dt + 1], da, f[2], f[3]);
      }
    }
    __syncthreads();                 // every warp is done with this stage
  }

  // keys past k_len never passed the mask: their rows hold exact zeros
  store_acc<D>(dk + k_base, acc_dk, k0 + warp * 16, k_end, row_stride, g, t);
  store_acc<D>(dv + k_base, acc_dv, k0 + warp * 16, k_end, row_stride, g, t);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ k_lens, bf16* __restrict__ dq,
                    int Lq, int Lk, int N, float scale, int causal,
                    int win_left, int win_right, int q_off, int k_off) {
  constexpr int kLd = D + 8;
  constexpr int kKSteps = D / 16;          // k-steps of Q.K^T and dO.V^T
  constexpr int kDTiles = D / 8;           // n-tiles of dQ
  constexpr int kNTiles = kDqBlockK / 8;   // n-tiles of S and dP

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + kDqBlockQ * kLd;
  bf16* sK = sdO + kDqBlockQ * kLd;              // [2][kDqBlockK][kLd]
  bf16* sV = sK + 2 * kDqBlockK * kLd;           // [2][kDqBlockK][kLd]

  const int q0 = blockIdx.x * kDqBlockQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  const size_t row_stride = (size_t)N * D;
  const size_t q_base = (size_t)b * Lq * row_stride + (size_t)h * D;
  const size_t k_base = (size_t)b * Lk * row_stride + (size_t)h * D;

  Mask mask;
  mask.k_valid = min(max(k_lens[b], 0), Lk);
  mask.diag = q_off + (Lk - Lq) - k_off;
  mask.causal = causal;
  mask.left = win_left;
  mask.right = win_right;
  mask.idx = causal || win_left >= 0 || win_right >= 0;

  // keys this block can see (as in the forward)
  int kv_begin = 0, kv_end = mask.k_valid;
  if (mask.idx) {
    const int q_last = min(q0 + kDqBlockQ, Lq) - 1;
    if (causal) kv_end = min(kv_end, q_last + mask.diag + 1);
    if (win_right >= 0) kv_end = min(kv_end, q_last + mask.diag + win_right + 1);
    if (win_left >= 0) kv_begin = max(0, q0 + mask.diag - win_left);
    kv_begin = (kv_begin / kDqBlockK) * kDqBlockK;
  }
  const int n_kt =
      kv_end > kv_begin ? (kv_end - kv_begin + kDqBlockK - 1) / kDqBlockK : 0;

  auto load_kv_tile = [&](int j, int stage) {
    const int kt = kv_begin + j * kDqBlockK;
    load_rows<D, kThreads>(sK + stage * kDqBlockK * kLd, k + k_base, kt,
                           kv_end, row_stride, kDqBlockK);
    load_rows<D, kThreads>(sV + stage * kDqBlockK * kLd, v + k_base, kt,
                           kv_end, row_stride, kDqBlockK);
  };

  // group 0: the resident Q / dO tile and key tile 0
  load_rows<D, kThreads>(sQ, q + q_base, q0, Lq, row_stride, kDqBlockQ);
  load_rows<D, kThreads>(sdO, dout + q_base, q0, Lq, row_stride, kDqBlockQ);
  if (n_kt > 0) load_kv_tile(0, 0);
  cp_async_commit();

  // this thread's two rows: lse (log2 domain) and delta
  const int row_a = q0 + warp * 16 + g;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    const bool ok = row < Lq;
    const size_t i = ((size_t)b * N + h) * Lq + (ok ? row : 0);
    lse2[r] = ok ? lse[i] * kLog2e : 0.f;
    dl[r] = ok ? delta[i] : 0.f;
  }

  float acc[kDTiles][4];
#pragma unroll
  for (int i = 0; i < kDTiles; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const float scale_log2 = scale * kLog2e;
  const bf16* qw = sQ + warp * 16 * kLd;
  const bf16* dw = sdO + warp * 16 * kLd;
  const int mat = lane >> 3, r8 = lane & 7;

  for (int j = 0; j < n_kt; ++j) {
    const int stage = j & 1;
    const int kt = kv_begin + j * kDqBlockK;
    if (j + 1 < n_kt) load_kv_tile(j + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const bf16* ks_ = sK + stage * kDqBlockK * kLd;
    const bf16* vs = sV + stage * kDqBlockK * kLd;

    // S = Q K^T and dP = dO V^T for this warp's 16 queries x 64 keys
    float s[kNTiles][4], dp[kNTiles][4];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      uint32_t qa[4], da[4];
      load_a_frag(qa, qw + ks * 16, kLd, g, t);
      load_a_frag(da, dw + ks * 16, kLd, g, t);
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        const bf16* kr = ks_ + (nt * 8 + g) * kLd + ks * 16 + 2 * t;
        const bf16* vr = vs + (nt * 8 + g) * kLd + ks * 16 + 2 * t;
        mma_16816(s[nt], qa, ld_u32(kr), ld_u32(kr + 8));
        mma_16816(dp[nt], da, ld_u32(vr), ld_u32(vr + 8));
      }
    }

    // P = where(mask, exp(S - lse), 0); dS = P (dP - delta) scale
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int key = kt + nt * 8 + 2 * t + (e & 1);
        const bool ok = mask(row_a + 8 * r, key);
        const float p = ok ? exp2f(s[nt][e] * scale_log2 - lse2[r]) : 0.f;
        dp[nt][e] = p * (dp[nt][e] - dl[r]) * scale;
      }
    }

    // dQ += dS K over the tile's 64 keys
#pragma unroll
    for (int kk = 0; kk < kDqBlockK / 16; ++kk) {
      const uint32_t da[4] = {
          pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
          pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
          pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
          pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
      const int off = (kk * 16 + (mat & 1) * 8 + r8) * kLd + (mat >> 1) * 8;
#pragma unroll
      for (int dt = 0; dt < kDTiles; dt += 2) {
        uint32_t f[4];
        ldmatrix_x4_trans(f, ks_ + off + dt * 8);
        mma_16816(acc[dt], da, f[0], f[1]);
        mma_16816(acc[dt + 1], da, f[2], f[3]);
      }
    }
    __syncthreads();
  }

  // rows with no valid key (n_kt == 0, or all masked) hold exact zeros
  store_acc<D>(dq + q_base, acc, q0 + warp * 16, Lq, row_stride, g, t);
}

struct Args {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *delta;
  const int* k_lens;
  int B, Lq, Lk, N;
  float scale;
  int causal, win_left, win_right, q_off, k_off;
  cudaStream_t stream;
};

template <int D>
int launch_dkdv(const Args& a, bf16* dk, bf16* dv) {
  constexpr int kSmem = dkdv_smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((a.Lk + kDkdvBlockK - 1) / kDkdvBlockK, a.N, a.B);
  flash_bwd_dkdv_kernel<D><<<grid, kThreads, kSmem, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.k_lens, dk, dv, a.Lq, a.Lk,
      a.N, a.scale, a.causal, a.win_left, a.win_right, a.q_off, a.k_off);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const Args& a, bf16* dq) {
  constexpr int kSmem = dq_smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((a.Lq + kDqBlockQ - 1) / kDqBlockQ, a.N, a.B);
  flash_bwd_dq_kernel<D><<<grid, kThreads, kSmem, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.k_lens, dq, a.Lq, a.Lk, a.N,
      a.scale, a.causal, a.win_left, a.win_right, a.q_off, a.k_off);
  return (int)cudaGetLastError();
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const void* k_lens, int B,
               int Lq, int Lk, int N, float scale, int causal, int win_left,
               int win_right, int q_off, int k_off, void* stream) {
  return Args{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
              static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
              static_cast<const float*>(lse), static_cast<const float*>(delta),
              static_cast<const int*>(k_lens), B, Lq, Lk, N, scale, causal,
              win_left, win_right, q_off, k_off,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

extern "C" const char* omni_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, dout: [B, Lq, N, D] bf16; k, v, dk, dv: [B, Lk, N, D] bf16;
// lse, delta: [B, N, Lq] fp32; k_lens: [B] int32.
extern "C" int omni_flash_bwd_dkdv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* k_lens, void* dk,
    void* dv, int B, int Lq, int Lk, int N, int D, float scale, int causal,
    int win_left, int win_right, int q_off, int k_off, void* stream) {
  if (B <= 0 || Lk <= 0 || N <= 0) return (int)cudaSuccess;
  const Args a = make_args(q, k, v, dout, lse, delta, k_lens, B, Lq, Lk, N,
                           scale, causal, win_left, win_right, q_off, k_off,
                           stream);
  switch (D) {
    case 64:
      return launch_dkdv<64>(a, static_cast<bf16*>(dk), static_cast<bf16*>(dv));
    case 128:
      return launch_dkdv<128>(a, static_cast<bf16*>(dk),
                              static_cast<bf16*>(dv));
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// dq: [B, Lq, N, D] bf16; the other arguments as above.
extern "C" int omni_flash_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* k_lens, void* dq, int B,
    int Lq, int Lk, int N, int D, float scale, int causal, int win_left,
    int win_right, int q_off, int k_off, void* stream) {
  if (B <= 0 || Lq <= 0 || N <= 0) return (int)cudaSuccess;
  const Args a = make_args(q, k, v, dout, lse, delta, k_lens, B, Lq, Lk, N,
                           scale, causal, win_left, win_right, q_off, k_off,
                           stream);
  switch (D) {
    case 64:
      return launch_dq<64>(a, static_cast<bf16*>(dq));
    case 128:
      return launch_dq<128>(a, static_cast<bf16*>(dq));
    default:
      return (int)cudaErrorInvalidValue;
  }
}
