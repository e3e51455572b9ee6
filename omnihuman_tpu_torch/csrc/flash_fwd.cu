// Flash-attention forward for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces the TPU Pallas kernels omnihuman_tpu/ops/flash_pallas.py
// `_fwd_kernel` (Lk <= block_k, DiT cross-attention) and `_fwd_kernel_u2`
// (Lk > block_k, DiT self-attention) with ONE kernel: the unroll-by-2 of the
// TPU version is a VLIW schedule and has no counterpart here.
//
// What it computes, per (batch b, head h):
//   O = softmax(scale * Q K^T + mask) V
// on the native [B, L, N, D] layout, with online softmax (fp32 m / l / acc;
// P rounded to bf16 before P.V). Mask: key index < k_lens[b] (clamped to Lk
// by the caller), plus optional causal / (left, right) window masks
// evaluated in global coordinates shifted by (q_off, k_off) and Lk - Lq
// (flash_pallas._mask_block). Rows with no valid key are written as exactly
// 0. Ragged Lq / Lk: rows past L arrive as zeros and are never stored.
//
// LSE output (training; flash_pallas `with_lse`, `:287-290`): with a
// non-null `lse`, each row's natural-log sum exp, log(sum_k exp(scale *
// q.k)) over its valid keys, is written to lse[b, h, row] in fp32 ([B, N,
// Lq]); a row with no valid key gets kNegInf (-1e30). The backward kernel
// (flash_bwd.cu) recomputes P from it. A null pointer writes nothing and
// leaves the serving path as it was.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s):
//   self-attention B=2, L=32768, N=12, D=128: 4*B*N*L^2*D = 1.32e13 FLOP
//   -> 13.3 ms; its bytes (q, k, v, o = 805 MB) take 0.24 ms. Compute-bound,
//   and beside the products every score takes an exponential: 16 per clock
//   an SM against 4,096 FLOP of products, half the products' time at D=128.
//   cross-attention Lq=32768, Lk<=512: 2.1e11 FLOP -> 0.21 ms, while its
//   Q and O bytes alone take 0.12 ms. Near the ridge / bandwidth-bound.
//
// What the design does about it (FA3's shape):
//   - a block is two consumer warpgroups, each owning 64 query rows of a
//     128-row tile, and a producer warpgroup whose one working thread
//     issues every load by TMA (4-D tensor maps over [B, L, N, D], 128-byte
//     swizzle): Q once per tile, K and V tiles of BN keys through a 2-stage
//     ring with full / empty mbarriers of their own, so a K tile is freed as
//     soon as S = Q K^T has read it; setmaxnreg gives the producer 24
//     registers and the consumers 240 of the launch allocation (384 x 168);
//   - both products are warpgroup MMAs: S = Q K^T m64nBN with Q and K
//     K-major in shared memory; O += P V m64nD with P packed to bf16 from
//     the S accumulator in registers and V MN-major (the transpose bit);
//   - within a warpgroup, S of tile j is issued before P V of tile j-1,
//     and the softmax of tile j runs while P V of tile j-1 is in flight;
//     across the two warpgroups, named barriers hand the tensor cores over
//     in turn (ping-pong), so one warpgroup's softmax runs under the
//     other's products;
//   - softmax in the log2 domain with the scale folded into one FFMA and
//     ex2.approx; row max and sum over the quad of lanes that share a row;
//     the mask is evaluated only on tiles that it cuts (for self-attention
//     at k_len 32,760, the last). Masked scores are -inf, and a row whose
//     running max is still -inf takes 0 as its offset, so a fully masked
//     tile gives exp2(-inf) = 0 and never exp2(0) = 1;
//   - tiles past k_len (and, with causal / window masks, tiles masked for
//     every row of the block) are never loaded: a cross-attention to a
//     37-token prompt reads one K/V tile;
//   - blocks are persistent, one per SM, walking the (b, h, Q tile) work
//     items in order; where two Q buffers fit, the producer loads the next
//     item's Q and K/V while the consumers finish the current one, which
//     is what hides the loads of the short, bandwidth-bound cross-attention;
//   - the epilogue scales O by 1/l in fp32, writes it as bf16 into the
//     warpgroup's rows of the Q buffer (swizzled) and stores it with TMA,
//     which clips rows past Lq; each warpgroup writes the LSE of its rows.
// No atomics: two runs give bit-equal O and LSE.
//
// C interface for ctypes; returns cudaGetLastError() after the launch (and
// cudaErrorInvalidValue if a tensor map cannot be made).

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace omni;

constexpr int kConsumers = 2;              // warpgroups, 64 query rows each
// + a producer warpgroup: setmaxnreg moves registers only within the
// block's launch allocation (384 x 168 = 128 x 24 + 256 x 240)
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kBlockM = kConsumers * 64;   // query rows per work item
constexpr int kRow = 128;                  // bytes of a swizzled tile row
constexpr int kKvStages = 2;               // ring of K / V tiles
constexpr int kMaxSmem = 232448;           // a block's shared memory, bytes
constexpr bool kPingPong = true;           // warpgroups take turns at wgmma
constexpr int kBarTurn = 1;                // named barriers 1, 2: the turns
constexpr int kBarStore = 3;               // 3, 4: each warpgroup's epilogue

// Byte offsets of the shared-memory tiles (each 1024-byte aligned). Two Q
// buffers where they fit beside the ring, else one.
template <int D, int BN>
struct Smem {
  static constexpr int kQTile = kBlockM * D * 2;
  static constexpr int kKvTile = BN * D * 2;
  static constexpr int kRing = 2 * kKvStages * kKvTile;   // K and V
  static constexpr int kQStages =
      2 * kQTile + kRing + 2048 <= kMaxSmem ? 2 : 1;
  static constexpr int kQ = 0;                              // [kQStages]
  static constexpr int kK = kQ + kQStages * kQTile;         // [kKvStages]
  static constexpr int kV = kK + kKvStages * kKvTile;       // [kKvStages]
  static constexpr int kBar = kV + kKvStages * kKvTile;
  static constexpr int kBytes = kBar + 8 * (2 * kQStages + 4 * kKvStages) +
                                1024;
  static_assert(kBytes <= kMaxSmem, "shared memory");
};

// S (+)= Q K^T over one 16-column k-step: A = Q rows, B = K rows, both
// K-major in shared memory.
template <int BN>
__device__ __forceinline__ void wgmma_qk(float (&s)[BN / 2], uint64_t a,
                                         uint64_t b, int accumulate) {
  if constexpr (BN == 64)
    wgmma_m64n64k16_ss<0, 0>(s, a, b, accumulate);
  else if constexpr (BN == 128)
    wgmma_m64n128k16_ss<0, 0>(s, a, b, accumulate);
  else
    wgmma_m64n176k16_ss<0, 0>(s, a, b, accumulate);
}

// O += P V over one 16-key k-step: A = P (registers), B = V (MN-major).
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 128)
    wgmma_m64n128k16_rs<1>(o, a, b, 1);
  else
    wgmma_m64n64k16_rs<1>(o, a, b, 1);
}

// The warpgroups' turns at the tensor cores: warpgroup w waits on barrier
// kBarTurn + w, then hands the turn to the other. Both take one turn per
// K/V tile, so the hand-overs stay paired.
__device__ __forceinline__ void turn_wait(int wg) {
  if constexpr (kPingPong) named_barrier(kBarTurn + wg, 2 * 128);
}

__device__ __forceinline__ void turn_pass(int wg) {
  if constexpr (kPingPong)
    named_barrier_arrive(kBarTurn + (kConsumers - 1 - wg), 2 * 128);
}

// One work item: batch b, head h, query rows [q0, q0 + kBlockM); the keys
// it can see are [kv_begin, kv_end), in n_tiles tiles of BN from kv_begin.
struct Work {
  int b, h, q0, kv_begin, n_tiles;
};

template <int BN>
__device__ __forceinline__ Work work_item(int w, int nq, int N,
                                          const Mask& mask, int Lq) {
  Work it;
  const int qt = w % nq, bh = w / nq;
  it.h = bh % N;
  it.b = bh / N;
  it.q0 = qt * kBlockM;
  it.kv_begin = 0;
  int kv_end = mask.k_valid;        // (the caller sets k_valid for it.b)
  if (mask.idx) {                   // kg - qg = key - q - diag
    const int q_last = min(it.q0 + kBlockM, Lq) - 1;
    if (mask.causal) kv_end = min(kv_end, q_last + mask.diag + 1);
    if (mask.right >= 0)
      kv_end = min(kv_end, q_last + mask.diag + mask.right + 1);
    if (mask.left >= 0) it.kv_begin = max(0, it.q0 + mask.diag - mask.left);
    it.kv_begin = (it.kv_begin / BN) * BN;
  }
  it.n_tiles =
      kv_end > it.kv_begin ? (kv_end - it.kv_begin + BN - 1) / BN : 0;
  return it;
}

template <int D, int BN>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 const __grid_constant__ CUtensorMap map_o,
                 float* __restrict__ lse, const int* __restrict__ k_lens,
                 int B, int Lq, int Lk, int N, float scale_log2, int causal,
                 int win_left, int win_right, int q_off, int k_off) {
  using S = Smem<D, BN>;
  constexpr int kQStages = S::kQStages;
  constexpr int kKSteps = D / 16;          // k-steps of S = Q K^T
  constexpr int kPSteps = BN / 16;         // k-steps of O += P V
  constexpr int kQBlock = kBlockM * kRow;  // column-block stride of Q
  constexpr int kKvBlock = BN * kRow;      // ... of a K / V tile

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::kBar);
  uint64_t* q_empty = q_full + kQStages;
  uint64_t* k_full = q_empty + kQStages;
  uint64_t* k_empty = k_full + kKvStages;
  uint64_t* v_full = k_empty + kKvStages;
  uint64_t* v_empty = v_full + kKvStages;

  const int wg = threadIdx.x / 128;    // 0, 1: consumers; 2: loads
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int nq = (Lq + kBlockM - 1) / kBlockM;
  const int n_work = B * N * nq;

  Mask mask;
  mask.diag = q_off + (Lk - Lq) - k_off;
  mask.causal = causal;
  mask.left = win_left;
  mask.right = win_right;
  mask.idx = causal || win_left >= 0 || win_right >= 0;
  auto item = [&](int w) {
    mask.k_valid = min(max(k_lens[(w / nq) / N], 0), Lk);
    return work_item<BN>(w, nq, N, mask, Lq);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kQStages; ++s) {
      mbar_init(q_full + s, 1);
      mbar_init(q_empty + s, kConsumers);      // each warpgroup's store
    }
    for (int s = 0; s < kKvStages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, kConsumers * 4);  // every consumer warp
      mbar_init(v_empty + s, kConsumers * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread issues every TMA load
    setmaxnreg_dec<24>();
    if (warp != 0 || lane != 0) return;
    int c = 0;                       // K/V tiles loaded so far
    for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
      const Work it = item(w);
      const int i = (w - blockIdx.x) / gridDim.x;   // this block's i-th item
      const int qs = i % kQStages;
      if (i >= kQStages) mbar_wait(q_empty + qs, (i / kQStages - 1) & 1);
      mbar_arrive_expect_tx(q_full + qs, kBlockM * D * 2);
      for (int cb = 0; cb < D / 64; ++cb)   // rows past Lq arrive as zeros
        tma_load_4d(smem + S::kQ + qs * S::kQTile + cb * kQBlock, &map_q,
                    q_full + qs, cb * 64, it.h, it.q0, it.b);
      for (int j = 0; j < it.n_tiles; ++j, ++c) {
        const int s = c % kKvStages, k0 = it.kv_begin + j * BN;
        if (c >= kKvStages) mbar_wait(k_empty + s, (c / kKvStages - 1) & 1);
        mbar_arrive_expect_tx(k_full + s, BN * D * 2);
        for (int cb = 0; cb < D / 64; ++cb)
          tma_load_4d(smem + S::kK + s * S::kKvTile + cb * kKvBlock, &map_k,
                      k_full + s, cb * 64, it.h, k0, it.b);
        if (c >= kKvStages) mbar_wait(v_empty + s, (c / kKvStages - 1) & 1);
        mbar_arrive_expect_tx(v_full + s, BN * D * 2);
        for (int cb = 0; cb < D / 64; ++cb)
          tma_load_4d(smem + S::kV + s * S::kKvTile + cb * kKvBlock, &map_v,
                      v_full + s, cb * 64, it.h, k0, it.b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows q0 + 64 wg .. + 63 of an item
  setmaxnreg_inc<240>();
  const int g = lane >> 2, t = lane & 3;
  const int row_in = wg * 64 + warp * 16 + g;   // d[4i+2r+c]: row_in + 8r
  if (kPingPong && wg == 0) named_barrier_arrive(kBarTurn, 2 * 128);

  float o[D / 2], s[BN / 2];
  uint32_t p[kPSteps][4];
  int c = 0;                         // K/V tiles consumed so far
  for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
    const Work it = item(w);
    // this block's i-th item (recomputed: a counter kept live across the
    // loop is what ptxas spilled)
    const int i = (w - blockIdx.x) / gridDim.x;
    const int qs = i % kQStages;
    unsigned char* sq = smem + S::kQ + qs * S::kQTile;
    const uint64_t desc_q = wgmma_desc(sq + wg * 64 * kRow, 16, 1024);
    const int row_lo = it.q0 + wg * 64;        // this warpgroup's rows
    // Does the mask cut the key tile [k0, k0 + BN) for these rows?
    auto tile_is_cut = [&](int k0) {
      if (k0 + BN > mask.k_valid) return true;
      if (!mask.idx) return false;
      const int rel_hi = k0 + BN - 1 - row_lo - mask.diag;   // key - q - diag
      const int rel_lo = k0 - (row_lo + 63) - mask.diag;
      return (causal && rel_hi > 0) || (win_right >= 0 && rel_hi > win_right) ||
             (win_left >= 0 && -rel_lo > win_left);
    };

#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};   // raw score max per row
    float l_run[2] = {0.f, 0.f};               // this thread's partial sums
    mbar_wait(q_full + qs, (i / kQStages) & 1);
    // S = Q K^T of the tile in stage st, committed as one group
    auto issue_qk = [&](int st) {
      const uint64_t desc_k =
          wgmma_desc(smem + S::kK + st * S::kKvTile, 16, 1024);
      fence_operands(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
        wgmma_qk<BN>(s, desc_q + (((kk / 4) * kQBlock + (kk % 4) * 32) >> 4),
                     desc_k + (((kk / 4) * kKvBlock + (kk % 4) * 32) >> 4),
                     kk > 0);
      wgmma_commit();
      fence_operands(s);
    };
    // O += P V of the tile in stage st (counter cv), committed as one group
    auto issue_pv = [&](int st, int cv) {
      const uint64_t desc_v =
          wgmma_desc(smem + S::kV + st * S::kKvTile, kKvBlock, 1024);
      mbar_wait(v_full + st, (cv / kKvStages) & 1);
      fence_operands(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kPSteps; ++kk)
        wgmma_pv<D>(o, p[kk], desc_v + ((kk * 16 * kRow) >> 4));
      wgmma_commit();
      fence_operands(o);
    };
    auto pv_done = [&](int st) {
      fence_operands(o);
#pragma unroll
      for (int kk = 0; kk < kPSteps; ++kk) fence_operands(p[kk]);
      if (lane == 0) mbar_arrive(v_empty + st);
    };
    // The online softmax of S (tile at key k0) into P (fp32, in s); returns
    // O's rescale to the new row max in alpha.
    float alpha[2];
    auto softmax = [&](int k0) {
      if (tile_is_cut(k0)) {
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) {
          const int col = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
          if (!mask(it.q0 + row_in + 8 * ((e >> 1) & 1), col))
            s[e] = -INFINITY;
        }
      }
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int e = 0; e < BN / 2; ++e)
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
      float off[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // a row with no valid key so far keeps offset 0: exp2(-inf) = 0
        off[r] = mx[r] == -INFINITY ? 0.f : mx[r] * scale_log2;
        alpha[r] = exp2_approx(m_run[r] * scale_log2 - off[r]);
        m_run[r] = mx[r];
      }
      float psum[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) {
        const int r = (e >> 1) & 1;
        s[e] = exp2_approx(fmaf(s[e], scale_log2, -off[r]));
        psum[r] += s[e];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + psum[r];
    };
    // P as the bf16 A fragments of its k-steps
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < kPSteps; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
    };

    // The first tile apart, so that every wgmma wait below has one shape
    // that ptxas can follow (a wait chosen by a branch makes it serialize).
    if (it.n_tiles > 0) {
      int st = c % kKvStages;
      mbar_wait(k_full + st, (c / kKvStages) & 1);
      turn_wait(wg);
      issue_qk(st);
      turn_pass(wg);
      wgmma_wait<0>();
      fence_operands(s);
      if (lane == 0) mbar_arrive(k_empty + st);
      softmax(it.kv_begin);
      pack_p();
      ++c;
      for (int j = 1; j < it.n_tiles; ++j, ++c) {
        const int sp = st;                  // tile j - 1's stage
        st = c % kKvStages;
        mbar_wait(k_full + st, (c / kKvStages) & 1);
        turn_wait(wg);
        issue_qk(st);
        issue_pv(sp, c - 1);                // P_{j-1} V_{j-1} under S_j
        turn_pass(wg);
        wgmma_wait<1>();                    // S_j; P V runs on
        fence_operands(s);
        if (lane == 0) mbar_arrive(k_empty + st);
        softmax(it.kv_begin + j * BN);
        wgmma_wait<0>();
        pv_done(sp);
        // O to tile j's max with no product in flight (a rescale while
        // S_j is in flight makes ptxas serialize the wgmmas: C7514)
#pragma unroll
        for (int e = 0; e < D / 2; ++e) o[e] *= alpha[(e >> 1) & 1];
        pack_p();
      }
      issue_pv(st, c - 1);                  // the last tile's P V
      wgmma_wait<0>();
      pv_done(st);
    }

    // epilogue: rows that never met a valid key are exactly 0
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      // l >= 1 on a valid row (its max scores exp2(0) = 1): the fast
      // reciprocal and log2 are exact to a few fp32 ulps there, and keep
      // the IEEE division's slow path (and its spill) out of the epilogue
      const bool valid = m_run[r] != -INFINITY;
      const float denom = l == 0.f ? 1.f : l;
      inv[r] = valid ? __fdividef(1.f, denom) : 0.f;
      const int row = it.q0 + row_in + 8 * r;
      if (lse != nullptr && t == 0 && row < Lq)
        lse[((size_t)it.b * N + it.h) * Lq + row] =
            valid ? (m_run[r] * scale_log2 + __log2f(denom)) * kLn2 : kNegInf;
    }
    // O as bf16 into this warpgroup's rows of the Q buffer (its products
    // are done with them), 128-byte swizzle: chunk i of row r at i ^ (r % 8)
#pragma unroll
    for (int i8 = 0; i8 < D / 8; ++i8)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(
            sq + (i8 / 8) * kQBlock + (row_in + 8 * r) * kRow +
            (((i8 % 8) ^ g) << 4) + 4 * t) =
            pack_bf16(o[4 * i8 + 2 * r] * inv[r],
                      o[4 * i8 + 2 * r + 1] * inv[r]);
    fence_proxy_async();
    named_barrier(kBarStore + wg, 128);
    if (threadIdx.x % 128 == 0) {   // rows past Lq are not written
      for (int cb = 0; cb < D / 64; ++cb)
        tma_store_4d(&map_o, sq + cb * kQBlock + wg * 64 * kRow, cb * 64,
                     it.h, row_lo, it.b);
      bulk_commit();
      bulk_wait_read();
      mbar_arrive(q_empty + qs);    // the producer may refill the buffer
    }
  }
  if (threadIdx.x % 128 == 0) bulk_wait();
}

template <int D, int BN>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const int* k_lens, int B, int Lq, int Lk, int N, float scale_log2,
           int causal, int win_left, int win_right, int q_off, int k_off,
           cudaStream_t stream) {
  constexpr int kSmem = Smem<D, BN>::kBytes;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<D, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  // K / V maps only where there are keys (with Lk = 0 no tile is loaded)
  CUtensorMap map_q, map_k = {}, map_v = {}, map_o;
  if (!make_head_map(&map_q, q, B, Lq, N, D, kBlockM) ||
      !make_head_map(&map_o, o, B, Lq, N, D, 64) ||
      (Lk > 0 && (!make_head_map(&map_k, k, B, Lk, N, D, BN) ||
                  !make_head_map(&map_v, v, B, Lk, N, D, BN))))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int n_work = B * N * ((Lq + kBlockM - 1) / kBlockM);
  const dim3 grid(min(n_work, max(sms, 1)));
  flash_fwd_kernel<D, BN><<<grid, kThreads, kSmem, stream>>>(
      map_q, map_k, map_v, map_o, lse, k_lens, B, Lq, Lk, N, scale_log2,
      causal, win_left, win_right, q_off, k_off);
  return (int)cudaGetLastError();
}

// K1's tile configuration per head dim and key length: f is called with a
// Cfg<D, BN> (BN keys a K/V tile); -1 for a head dim the kernel lacks.
// BN = 128 measured best at both head dims and at every key length of the
// main path, cross-attention included: there the persistent blocks and
// the second Q buffer are what count (scripts/flash_fwd_variants.py).
template <int D_, int BN_>
struct Cfg {
  static constexpr int D = D_, BN = BN_;
};

template <typename F>
int with_config(int D, int Lk, F f) {
  switch (D) {
    case 64:
      return f(Cfg<64, 128>{});
    case 128:
      return f(Cfg<128, 128>{});
    default:
      return -1;
  }
}

}  // namespace

extern "C" const char* omni_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q: [B, Lq, N, D], k, v: [B, Lk, N, D], o: [B, Lq, N, D] bf16; lse: null,
// or [B, N, Lq] fp32 (natural log; see the note at the top); k_lens: [B]
// int32.
extern "C" int omni_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                   void* o, void* lse, const void* k_lens,
                                   int B, int Lq, int Lk, int N, int D,
                                   float scale, int causal, int win_left,
                                   int win_right, int q_off, int k_off,
                                   void* stream) {
  if (B <= 0 || Lq <= 0 || N <= 0) return (int)cudaSuccess;
  const int err = with_config(D, Lk, [&](auto cfg) {
    using C = decltype(cfg);
    return launch<C::D, C::BN>(
        q, k, v, o, static_cast<float*>(lse),
        static_cast<const int*>(k_lens), B, Lq, Lk, N, scale * kLog2e, causal,
        win_left, win_right, q_off, k_off, static_cast<cudaStream_t>(stream));
  });
  return err < 0 ? (int)cudaErrorInvalidValue : err;
}

// The dynamic shared memory of a block of the configuration that a launch
// at this head dim and key length takes (bytes; -1 for an unknown D).
extern "C" int omni_flash_fwd_smem_bytes(int D, int Lk) {
  return with_config(D, Lk, [](auto cfg) {
    using C = decltype(cfg);
    return Smem<C::D, C::BN>::kBytes;
  });
}
