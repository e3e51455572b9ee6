// Flash-attention backward for Hopper (sm_90a): bf16 q/k/v/dO in, bf16
// dk/dv and an fp32 dq accumulator out, fp32 LSE / delta.
//
// Replaces the two TPU Pallas kernels of omnihuman_tpu/ops/flash_pallas.py,
// `_bwd_dkdv_kernel` (:387) and `_bwd_dq_kernel` (:437), with ONE kernel:
// one block per (b, head, 128-key tile); the K / V tile stays in shared
// memory and the block walks the query tiles that can see its keys. Per
// (key tile, query tile) it computes S and dP once,
//   S^T = scale K Q^T,  P^T = where(mask, exp(S^T - lse), 0),  dP^T = V dO^T,
//   dS^T = P^T (dP^T - delta) scale,
// and all three gradients from them:
//   dV += P^T dO,  dK += dS^T Q  (in registers, stored once at the end),
//   dQ_partial = dS K            (added into an fp32 dq accumulator).
// lse comes from the forward (flash_fwd.cu, natural log; -1e30 on a row
// with no valid key: the mask is applied BEFORE the exponential,
// exp(s + 1e30) would be inf) and delta = rowsum(dO * O) computed in fp32
// by the caller from the stored bf16 O. P and dS are rounded to bf16
// before their products, as the Pallas kernels do. The mask is the
// forward's (flash_pallas._mask_block): key < k_lens[b], causal and
// (left, right) window in global coordinates shifted by (q_off, k_off) and
// Lk - Lq. Keys at or past k_len get dK = dV = 0. Ragged Lq / Lk tails are
// zero-filled on load, masked, and never stored.
//
// Determinism: dK and dV are bitwise deterministic (each block owns its
// keys). dQ is not: the key tiles' fp32 partial sums reach the accumulator
// (TMA reduce-add at L2) in an order that varies from run to run. The
// caller zero-fills the accumulator and casts it to bf16.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): the
// five products, 10*N*Lq*Lk*D FLOP; for B=1, N=12, D=128, L=32768
// self-attention 1.65e13 FLOP -> 16.7 ms, compute-bound (the bytes take
// ~0.2 ms). The TPU split recomputes S and dP in its dq kernel (seven
// products, 23.3 ms); this kernel does not. Beside the products, the dQ
// partials move 4*N*Lq*D bytes per key tile through L2's adders (52 GB at
// the shape above).
//
// What the design does about it: every product is a warpgroup MMA (wgmma,
// m64nNk16, fp32 accumulators in registers). Two consumer warpgroups each
// own 64 keys of the tile; a step takes 64 queries:
//   S^T, dP^T  m64n64   A = K / V rows (shared, K-major),
//                       B = Q / dO tile (shared, K-major)
//   dV, dK     m64nD    A = P^T / dS^T packed to bf16 from the S^T / dP^T
//                       accumulators (registers),
//                       B = dO / Q tile (shared, MN-major: transpose bit)
//   dQ         m64n64   A = dS^T written once to shared memory as bf16
//                       (MN-major: transpose bit), B = K (MN-major); at
//                       D=128 each warpgroup takes 64 of D's columns over
//                       all 128 keys, at D=64 its own 64 keys over all of D
// A producer warpgroup (one working warp) loads K / V once and Q / dO into
// a 2-stage ring with TMA (4-D tensor maps over [B, L, N, D], 128-byte
// swizzle: rows past L arrive as zeros) and stages lse / delta; mbarriers
// hand the stages over. setmaxnreg gives the producer 24 registers and the
// consumers 240 (dK and dV 128, S^T and dP^T 64); the block's launch
// allocation, 384 x 168, is all it can redistribute. The P^T exponentials
// overlap the dP^T products and the dQ products overlap dV / dK; each
// warpgroup stages its fp32 dQ partial in shared memory (swizzled) and
// adds it to the accumulator with TMA reduce-adds: two bulk operations a
// step in place of 16 vector atomics a thread. Tiles that the k_len /
// causal / window mask empties are skipped, and tiles it does not cut
// skip the mask. Each block starts its walk at a query tile staggered by
// its key-tile index, so the blocks of one head do not add into the same
// dq rows at the same time.
//
// C interface for ctypes; the entry returns cudaGetLastError() after the
// launch (and cudaErrorInvalidValue if a tensor map cannot be made).

#include <cuda.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace omni;

constexpr int kConsumers = 2;              // warpgroups, 64 keys each
// + a producer warpgroup: setmaxnreg moves registers only within the
// block's launch allocation (384 x 168 = 128 x 24 + 256 x 240)
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kBlockK = kConsumers * 64;   // resident keys per block
constexpr int kBlockQ = 64;                // streamed queries per step
constexpr int kRow = 128;                  // bytes of a swizzled tile row
constexpr int kStages = 2;                 // ring of query tiles

// Byte offsets of the shared-memory tiles (each 1024-byte aligned).
template <int D>
struct Smem {
  static constexpr int kK = 0;
  static constexpr int kV = kK + kBlockK * D * 2;
  static constexpr int kQ = kV + kBlockK * D * 2;             // [kStages]
  static constexpr int kdO = kQ + kStages * kBlockQ * D * 2;  // [kStages]
  // dS^T: [2][kBlockK][kBlockQ]
  static constexpr int kdS = kdO + kStages * kBlockQ * D * 2;
  // dQ partial, fp32: [kConsumers][2 boxes][kBlockQ][32]
  static constexpr int kdQ = kdS + 2 * kBlockK * kBlockQ * 2;
  static constexpr int kL = kdQ + kConsumers * kBlockQ * 64 * 4;  // [kStages]
  static constexpr int kDelta = kL + kStages * kBlockQ * 4;   // [kStages]
  static constexpr int kBar = kDelta + kStages * kBlockQ * 4;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

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

// One warp's rows of a warpgroup's [64, D] fp32 accumulator as bf16 rows
// row0 + g and row0 + g + 8; rows >= row_end are not stored.
template <int D>
__device__ __forceinline__ void store_acc(bf16* dst, const float (&acc)[D / 2],
                                          int row0, int row_end,
                                          size_t row_stride, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= row_end) continue;
    bf16* out = dst + (size_t)row * row_stride + 2 * t;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<uint32_t*>(out + i * 8) =
          pack_bf16(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
  }
}

// 2^x; P is rounded to bf16 right after, and a masked x (up to +1e30)
// gives inf that the mask then replaces.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// dV += P^T dO or dK += dS^T Q for one 16-query k-step.
template <int D>
__device__ __forceinline__ void wgmma_rs(float (&acc)[D / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 128)
    wgmma_m64n128k16_rs<1>(acc, a, b, 1);
  else
    wgmma_m64n64k16_rs<1>(acc, a, b, 1);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 const __grid_constant__ CUtensorMap map_do,
                 const __grid_constant__ CUtensorMap map_dq,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const int* __restrict__ k_lens, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, int Lq, int Lk,
                 int N, float scale, int causal, int win_left, int win_right,
                 int q_off, int k_off) {
  using S = Smem<D>;
  constexpr int kKSteps = D / 16;          // k-steps of S^T and dP^T
  constexpr bool kSplitDq = D == 128;      // dQ: columns per warpgroup
  constexpr int kDqSteps = kSplitDq ? kBlockK / 16 : 64 / 16;
  constexpr int kKvBlock = kBlockK * kRow;   // column-block stride of K, V
  constexpr int kQBlock = kBlockQ * kRow;    // ... of a Q / dO stage
  constexpr int kQBytes = kBlockQ * D * 2;   // one Q (or dO) stage
  constexpr int kDsBytes = kBlockK * kBlockQ * 2;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  float* sL = reinterpret_cast<float*>(smem + S::kL);
  float* sDelta = reinterpret_cast<float*>(smem + S::kDelta);
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(smem + S::kBar);
  uint64_t* full = bar_kv + 1;             // [kStages]: a query tile landed
  uint64_t* empty = full + kStages;        // [kStages]: consumers are done

  const int k0 = blockIdx.x * kBlockK;
  const int h = blockIdx.y, b = blockIdx.z;
  const int wg = threadIdx.x / 128;    // 0, 1: consumers (64 keys); 2: loads
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  const size_t row_stride = (size_t)N * D;
  const size_t k_base = (size_t)b * Lk * row_stride + (size_t)h * D;
  const int k_end = min(k0 + kBlockK, Lk);

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
    q_begin = (max(q_begin, 0) / kBlockQ) * kBlockQ;
  }
  const int n_qt =
      q_end > q_begin ? (q_end - q_begin + kBlockQ - 1) / kBlockQ : 0;
  if (n_qt == 0) {                  // no query sees these keys: zero grads
    zero_rows<D>(dk + k_base, k0, k_end, row_stride);
    zero_rows<D>(dv + k_base, k0, k_end, row_stride);
    return;
  }
  const int j0 = blockIdx.x % n_qt;   // staggered first query tile
  auto tile_of = [&](int j) {
    const int jj = j + j0;
    return q_begin + (jj < n_qt ? jj : jj - n_qt) * kBlockQ;
  };

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 32);                 // the producer warp's lanes
      mbar_init(empty + s, kConsumers * 4);    // every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one warp issues the TMA loads and stages lse / delta
    setmaxnreg_dec<24>();
    if (warp != 0) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_kv, 2 * kBlockK * D * 2);
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(smem + S::kK + c * kKvBlock, &map_k, bar_kv, c * 64, h,
                    k0, b);
        tma_load_4d(smem + S::kV + c * kKvBlock, &map_v, bar_kv, c * 64, h,
                    k0, b);
      }
    }
    const float* lse_b = lse + ((size_t)b * N + h) * Lq;
    const float* delta_b = delta + ((size_t)b * N + h) * Lq;
    for (int j = 0; j < n_qt; ++j) {
      const int stage = j % kStages;
      if (j >= kStages) mbar_wait(empty + stage, (j / kStages - 1) & 1);
      const int qt = tile_of(j);
      for (int r = lane; r < kBlockQ; r += 32) {
        const int row = qt + r;
        const bool ok = row < Lq;
        sL[stage * kBlockQ + r] = ok ? lse_b[row] * kLog2e : 0.f;
        sDelta[stage * kBlockQ + r] = ok ? delta_b[row] : 0.f;
      }
      if (lane == 0) {     // rows past Lq arrive as zeros
        mbar_arrive_expect_tx(full + stage, 2 * kQBytes);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(smem + S::kQ + stage * kQBytes + c * kQBlock, &map_q,
                      full + stage, c * 64, h, qt, b);
          tma_load_4d(smem + S::kdO + stage * kQBytes + c * kQBlock, &map_do,
                      full + stage, c * 64, h, qt, b);
        }
      } else {
        mbar_arrive(full + stage);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns keys k0 + 64 wg .. + 63
  setmaxnreg_inc<240>();

  // Does the mask cut the tile of queries [qt, qt + kBlockQ)?
  const bool keys_cut = k0 + kBlockK > mask.k_valid;
  auto tile_is_cut = [&](int qt) {
    if (keys_cut || qt + kBlockQ > Lq) return true;
    if (!mask.idx) return false;
    const int rel_hi = k0 + kBlockK - 1 - qt - mask.diag;   // key - q - diag
    const int rel_lo = k0 - (qt + kBlockQ - 1) - mask.diag;
    return (causal && rel_hi > 0) || (win_right >= 0 && rel_hi > win_right) ||
           (win_left >= 0 && -rel_lo > win_left);
  };

  // this warpgroup's K / V rows as the K-major A of S^T and dP^T
  const uint64_t desc_k = wgmma_desc(smem + S::kK + wg * 64 * kRow, 16, 1024);
  const uint64_t desc_v = wgmma_desc(smem + S::kV + wg * 64 * kRow, 16, 1024);
  // dS^T (MN-major A, two buffers) and K (MN-major B) of dQ
  const int dq_row0 = kSplitDq ? 0 : wg * 64;
  const uint64_t desc_ds = wgmma_desc(smem + S::kdS + dq_row0 * kRow, kQBlock,
                                      1024);
  const uint64_t desc_kt = wgmma_desc(
      smem + S::kK + (kSplitDq ? wg * kKvBlock : dq_row0 * kRow), kKvBlock,
      1024);
  const int dq_col0 = kSplitDq ? wg * 64 : 0;

  float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
  const float scale_log2 = scale * kLog2e;
  const int key_row = k0 + wg * 64 + warp * 16 + g;   // d[4i+2r+c]: +8r
  const int ds_row = wg * 64 + warp * 16 + g;         // row % 8 == g
  unsigned char* sdq = smem + S::kdQ + wg * kBlockQ * 64 * 4;
  mbar_wait(bar_kv, 0);

  for (int j = 0; j < n_qt; ++j) {
    const int stage = j % kStages;
    const int qt = tile_of(j);
    const int buf = j & 1;              // dS^T buffer of this step
    unsigned char* sq = smem + S::kQ + stage * kQBytes;
    unsigned char* sdo = smem + S::kdO + stage * kQBytes;
    const float* ls = sL + stage * kBlockQ;
    const float* des = sDelta + stage * kBlockQ;
    unsigned char* sdS = smem + S::kdS + buf * kDsBytes;
    const uint64_t desc_q = wgmma_desc(sq, 16, 1024);         // K-major
    const uint64_t desc_do = wgmma_desc(sdo, 16, 1024);
    const uint64_t desc_qt = wgmma_desc(sq, kQBlock, 1024);   // MN-major
    const uint64_t desc_dot = wgmma_desc(sdo, kQBlock, 1024);
    const bool cut = tile_is_cut(qt);
    mbar_wait(full + stage, (j / kStages) & 1);

    // S^T = K Q^T and dP^T = V dO^T: this warpgroup's 64 keys x 64 queries
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk)
      wgmma_m64n64k16_ss<0, 0>(
          s, desc_k + (((kk / 4) * kKvBlock + (kk % 4) * 32) >> 4),
          desc_q + (((kk / 4) * kQBlock + (kk % 4) * 32) >> 4), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk)
      wgmma_m64n64k16_ss<0, 0>(
          dp, desc_v + (((kk / 4) * kKvBlock + (kk % 4) * 32) >> 4),
          desc_do + (((kk / 4) * kQBlock + (kk % 4) * 32) >> 4), kk > 0);
    wgmma_commit();

    // P^T = where(mask, exp(S^T - lse), 0), while dP^T is in flight
    wgmma_wait<1>();
    fence_operands(s);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * i + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p =
            exp2_approx(s[4 * i + e] * scale_log2 - ((e & 1) ? l2.y : l2.x));
        if (cut) {
          const int row = qt + 8 * i + 2 * t + (e & 1);
          const int key = key_row + 8 * (e >> 1);
          p = (row < Lq && mask(row, key)) ? p : 0.f;
        }
        s[4 * i + e] = p;
      }
    }
    // dS^T = P^T (dP^T - delta) scale
    wgmma_wait<0>();
    fence_operands(dp);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 d2 = *reinterpret_cast<const float2*>(des + 8 * i + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * i + e] = s[4 * i + e] *
                        (dp[4 * i + e] - ((e & 1) ? d2.y : d2.x)) * scale;
    }

    // P^T and dS^T as bf16 A fragments, one per 16-query k-step; dS^T also
    // to shared memory (rows: keys, 128 bytes of queries, swizzled)
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pa[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
        da[kk][e] = pack_bf16(dp[8 * kk + 2 * e], dp[8 * kk + 2 * e + 1]);
        const int i = 2 * kk + (e >> 1), row = ds_row + 8 * (e & 1);
        *reinterpret_cast<uint32_t*>(sdS + row * kRow + ((i ^ g) << 4) +
                                     4 * t) = da[kk][e];
      }

    // dV += P^T dO and dK += dS^T Q over the tile's 64 queries
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(acc_dv, pa[kk], desc_dot + ((kk * 16 * kRow) >> 4));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(acc_dk, da[kk], desc_qt + ((kk * 16 * kRow) >> 4));
    wgmma_commit();

    // dS^T from both warpgroups, visible to wgmma. The other buffer's last
    // readers (step j-1's dQ) finished before their warpgroup got here, and
    // so did step j-1's reduce-add of the dQ staging tile.
    if (threadIdx.x % 128 == 0) bulk_wait_read();
    fence_proxy_async();
    named_barrier(1, kConsumers * 128);

    // dQ_partial = dS K (64 queries x 64 columns a warpgroup)
    float dq[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDqSteps; ++kk)
      wgmma_m64n64k16_ss<1, 1>(
          dq, desc_ds + ((buf * kDsBytes + kk * 16 * kRow) >> 4),
          desc_kt + ((kk * 16 * kRow) >> 4), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(dq);
    fence_operands(acc_dv);
    fence_operands(acc_dk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {   // the A registers stay live until here
      fence_operands(pa[kk]);
      fence_operands(da[kk]);
    }
    if (lane == 0) mbar_arrive(empty + stage);   // this warp is done with it

    // dQ_partial to this warpgroup's staging tile (two 32-column boxes in
    // the 128-byte swizzle), then one TMA reduce-add per box into dq_acc
    // (rows past Lq are not written)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = warp * 16 + g + 8 * r;        // row % 8 == g
        const int chunk = 2 * (i % 4) + t / 2;        // 16 bytes: 4 floats
        *reinterpret_cast<float2*>(sdq + (i / 4) * kBlockQ * kRow +
                                   row * kRow + ((chunk ^ g) << 4) +
                                   (t % 2) * 8) =
            make_float2(dq[4 * i + 2 * r], dq[4 * i + 2 * r + 1]);
      }
    fence_proxy_async();
    named_barrier(2 + wg, 128);
    if (threadIdx.x % 128 == 0) {
      tma_reduce_add_4d(&map_dq, sdq, dq_col0, h, qt, b);
      tma_reduce_add_4d(&map_dq, sdq + kBlockQ * kRow, dq_col0 + 32, h, qt,
                        b);
      bulk_commit();
    }
  }
  if (threadIdx.x % 128 == 0) bulk_wait();

  // keys past k_len never passed the mask: their rows hold exact zeros
  store_acc<D>(dk + k_base, acc_dk, k0 + wg * 64 + warp * 16, k_end,
               row_stride, g, t);
  store_acc<D>(dv + k_base, acc_dv, k0 + wg * 64 + warp * 16, k_end,
               row_stride, g, t);
}

// cuTensorMapEncodeTiled (a CUDA driver API call), looked up through the
// runtime: the library links only the runtime.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &status) == cudaSuccess &&
        status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// One head's rows of a [B, L, N, D] tensor (bf16, or fp32 when `fp32`) as
// boxes of `rows` x 128 bytes in the 128-byte swizzle; rows past L read as
// zeros and are not written.
bool make_map(CUtensorMap* map, const void* base, int B, int L, int N, int D,
              int rows, bool fp32 = false) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t es = fp32 ? 4 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)N, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {D * es, N * D * es, L * N * D * es};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / es), 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map,
                fp32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                4, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
           const float* lse, const float* delta, const int* k_lens,
           float* dq_acc, bf16* dk, bf16* dv, int B, int Lq, int Lk, int N,
           float scale, int causal, int win_left, int win_right, int q_off,
           int k_off, cudaStream_t stream) {
  constexpr int kSmem = Smem<D>::kBytes;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  CUtensorMap map_q, map_k, map_v, map_do, map_dq;
  if (!make_map(&map_q, q, B, Lq, N, D, kBlockQ) ||
      !make_map(&map_do, dout, B, Lq, N, D, kBlockQ) ||
      !make_map(&map_k, k, B, Lk, N, D, kBlockK) ||
      !make_map(&map_v, v, B, Lk, N, D, kBlockK) ||
      !make_map(&map_dq, dq_acc, B, Lq, N, D, kBlockQ, true))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Lk + kBlockK - 1) / kBlockK, N, B);
  flash_bwd_kernel<D><<<grid, kThreads, kSmem, stream>>>(
      map_q, map_k, map_v, map_do, map_dq, lse, delta, k_lens, dk, dv, Lq, Lk,
      N, scale, causal, win_left, win_right, q_off, k_off);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* omni_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, dout: [B, Lq, N, D] bf16; k, v, dk, dv: [B, Lk, N, D] bf16;
// dq_acc: [B, Lq, N, D] fp32, zero-filled by the caller (added into);
// lse, delta: [B, N, Lq] fp32; k_lens: [B] int32.
extern "C" int omni_flash_bwd_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* k_lens, void* dq_acc,
    void* dk, void* dv, int B, int Lq, int Lk, int N, int D, float scale,
    int causal, int win_left, int win_right, int q_off, int k_off,
    void* stream) {
  // (the caller zeroes dk and dv itself when Lq = 0: a tensor map needs a
  // nonempty tensor)
  if (B <= 0 || Lq <= 0 || Lk <= 0 || N <= 0) return (int)cudaSuccess;
  auto run = [&](auto launch_d) {
    return launch_d(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<const int*>(k_lens), static_cast<float*>(dq_acc),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, Lq, Lk, N, scale,
        causal, win_left, win_right, q_off, k_off,
        static_cast<cudaStream_t>(stream));
  };
  switch (D) {
    case 64:
      return run(launch<64>);
    case 128:
      return run(launch<128>);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
