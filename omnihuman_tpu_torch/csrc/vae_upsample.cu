// K4: nearest-2x upsample + SAME 3x3 conv (+ bias) of the VAE decoder's
// Resample, for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces the TPU Pallas kernel omnihuman_tpu/ops/vae_pallas.py
// `_up_kernel` (entry `fused_upsample_conv2d`). A nearest-2x upsampled
// 3x3 window holds only 2x2 distinct low-res pixels, so the conv is four
// 2x2 convs on the low-res grid, one per output parity (a, b), with the
// tap sums folded into the weights (`pack_upsample_weights`, w4
// [2, 2, 4 * Cin, Cout], rows (p, q, ci)):
//   y[2i + a, 2j + b, co] = bias[co] + sum over (p, q, ci) of
//       x[i - 1 + a + p, j - 1 + b + q, ci] * w4[a][b][(p, q, ci), co]
// on channels-last [B, T, h, w, C] memory, pixels outside the frame 0,
// fp32 sums, the bias added in fp32. The kernel reads the weights as the
// K-major copy wk [2, 2, 4, Cout, Cin] (`upsample_weights_kmajor`):
// wk[a][b][(p, q)][co][ci] = w4[a][b][(p, q, ci), co].
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): the
// products. Its largest call in the VAE (T=4, 240x416 -> 480x832,
// 192 -> 96) is 4 * 2 * 4 * 192 * 96 * 4e5 = 2.36e11 FLOP (0.24 ms) against
// 0.46 GB of input and output (0.14 ms), two thirds of it the store.
//
// Design (vae_conv.cu's implicit GEMM with 4 taps and no prologue):
//   - a work item is (N-block of BN = 96 channels, frame, tile of kTH
//     low-res rows x 16 columns, row parity a). Consumer warpgroup w owns
//     the m64 tile of rows 4w .. 4w + 3 (warp k of it one row of 16
//     positions) and computes both column parities b of its row parity:
//     two m64n96 accumulators (96 fp32 registers a thread), which share
//     every A fragment of the halo and differ in the tap shift and the
//     weights. Together they are 32 adjacent high-res pixels of one row;
//   - K is walked as (Cin chunk of KC = 32 channels, p) steps. TMA brings
//     the low-res halo of a chunk, (kTH + 1) x 18 pixels x KC channels of
//     the rows and columns the item's taps read, as a box of a 4-D tensor
//     map over [B * T, h, w, Cin] (the SAME zeros are TMA's fill of
//     coordinates outside h x w, and of channels past Cin), and the
//     weights of a (chunk, p) step, both b x both q x BN rows x KC
//     channels of wk, as two boxes of a 3-D map over [16, Cout, Cin]
//     (rows past Cout arrive as zeros); both in the 64-byte swizzle. 32
//     channels, not 64, so that shared memory holds the output staging
//     beside the halo ring and 4 weight stages;
//   - one producer warp (of a producer warpgroup, setmaxnreg 24) keeps a
//     2-slot halo ring and a ring of up to 4 weight stages in flight on
//     mbarriers. Each consumer warp gathers its A fragments (its row's 16
//     positions at the tap's column shift dx = b + q, 0..2) with
//     ldmatrix.x4 from the swizzled halo (im2col without a copy) and
//     issues wgmma m64n96k16 with B (the weights) from shared memory; the
//     shift dx = 1 feeds both accumulators, so a step gathers 3 shifts
//     for 4 taps. Two small A register sets alternate, so one group's
//     products run while the next group's fragments are gathered;
//   - persistent blocks (one per SM) walk the items in order, the row
//     parity fastest and the N-block slowest, so the producer loads the
//     next item while the consumers finish this one. kTH = 12 (three
//     consumer warpgroups, setmaxnreg 160), or 8 (two, 240) where 12-row
//     items leave the grid's last wave mostly empty (the 60x104 calls);
//   - epilogue: + bias in fp32, bf16. Each warp writes its row's 32
//     high-res pixels x 96 channels into its own staging buffer (three
//     boxes of 32 channels in the 64-byte swizzle, so the lanes' 4-byte
//     stores meet at most two to a bank) and one lane stores the boxes
//     by TMA: whole rows, asynchronously, so the store to HBM runs under
//     the next item's products; the buffer is reused once that store has
//     read it. TMA writes nothing outside y (pixels past w, rows past h,
//     channels past Cout).
// Bitwise deterministic: every output element is one thread's sums in a
// fixed order; no atomics.
//
// C interface for ctypes; the entry returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue on an unsupported shape or a refused
// tensor map).

#include <type_traits>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace omni;

constexpr int kMaxWStages = 4;      // weight ring (fewer if smem is short)
constexpr int kHStages = 2;         // halo ring
constexpr int kProducerRegs = 24;
constexpr int kTileW = 16;          // low-res columns of an item
constexpr int kSmemMax = 232448;    // dynamic shared memory a block may use
constexpr int kKC = 32;             // channels of a K step
constexpr int kASets = 2;           // A register sets, alternating by group
constexpr bool kTmaStore = true;    // the output staged and stored by TMA

// BN output channels an item; NB column parities an item (2: both, the
// kernel's; 1: one, with BN = 192, which the variants script times); KC
// channels a K step; NC consumer warpgroups.
template <int BN, int NB, int KC, int NC>
struct Up {
  static constexpr int kThreads = (NC + 1) * 128;
  // setmaxnreg moves registers within the launch allocation (65,536 / the
  // block's threads, a multiple of 8): the producer keeps 24 a thread,
  // the consumers share the rest
  static constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
  static constexpr int kConsumerRegs =
      (kLaunchRegs * (NC + 1) - kProducerRegs) / NC / 8 * 8;
  static constexpr int kTH = 4 * NC;        // low-res rows of an item
  static constexpr int kPar = 4 / NB;       // parities the items walk
  static constexpr int kRB = KC * 2;  // bytes of a halo pixel / weight row
  static constexpr int kHaloW = kTileW + 2, kHaloH = kTH + 1;
  static constexpr int kHaloBytes = kRB * kHaloW * kHaloH;
  static constexpr int kHaloSlot = (kHaloBytes + 1023) / 1024 * 1024;
  static constexpr int kWBox = 2 * BN * kRB;        // 2 q taps x BN x KC
  static constexpr int kWBytes = NB * kWBox;
  static constexpr int kWSlot = (kWBytes + 1023) / 1024 * 1024;
  // a consumer warp's output row, 32 high-res pixels x BN channels,
  // staged for its TMA stores as BN / 32 boxes of 32 pixels x 32 channels
  // in the 64-byte swizzle (both column parities an item only)
  static constexpr bool kStaged = NB == 2 && kTmaStore;
  static constexpr int kStageBox = 32 * 64;
  static constexpr int kStageWarp = BN / 32 * kStageBox;
  static constexpr int kStageBytes = kStaged ? NC * 4 * kStageWarp : 0;
  static constexpr int kFixed = 1024 + 256;         // alignment + barriers
  static constexpr int kWFit =
      (kSmemMax - kFixed - kHStages * kHaloSlot - kStageBytes) / kWSlot;
  static constexpr int kWStages = kWFit < kMaxWStages ? kWFit : kMaxWStages;
  static constexpr int kW = kHStages * kHaloSlot;   // offset of the weights
  static constexpr int kStage = kW + kWStages * kWSlot;
  static constexpr int kBar = kStage + kStageBytes;
  static constexpr int kBytes = kBar + kFixed;
  static_assert(kWStages >= 2, "shared memory holds two weight stages");
  static_assert(BN % 32 == 0 && (NB == 1 || NB == 2), "tile");
};

// 16-byte chunk j of row `row` of a swizzled tile with kRB-byte rows.
template <int kRB>
__device__ __forceinline__ int swizzled(int row, int j) {
  return kRB == 128 ? (j ^ (row & 7)) : (j ^ ((row >> 1) & 3));
}

template <int BN>
__device__ __forceinline__ void wgmma_acc(float (&d)[BN / 2],
                                          const uint32_t (&a)[4], uint64_t b) {
  if constexpr (BN == 192)
    wgmma_m64n192k16_rs<0>(d, a, b, 1);
  else
    wgmma_m64n96k16_rs<0>(d, a, b, 1);
}

struct Item {
  int bt, y0, x0, n0, a, b;
};

// Item ti: parities fastest (a, then b when an item holds one), then
// columns, rows, frames, N-blocks.
template <int kPar>
__device__ __forceinline__ Item item_of(int ti, int tiles_w, int tiles_h,
                                        int frames, int th, int bn) {
  Item it;
  const int par = ti % kPar;
  ti /= kPar;
  it.a = par & 1;
  it.b = par >> 1;
  it.x0 = (ti % tiles_w) * kTileW;
  ti /= tiles_w;
  it.y0 = (ti % tiles_h) * th;
  ti /= tiles_h;
  it.bt = ti % frames;
  it.n0 = (ti / frames) * bn;
  return it;
}

template <int BN, int NB, int KC, int NC>
__global__ void __launch_bounds__(Up<BN, NB, KC, NC>::kThreads, 1)
vae_upsample_kernel(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_w,
                    const __grid_constant__ CUtensorMap map_y,
                    const float* __restrict__ bias, bf16* __restrict__ y,
                    int H, int W, int Cin, int Cout, int tiles_w,
                    int tiles_h, int frames, int n_items) {
  using S = Up<BN, NB, KC, NC>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* h_full = reinterpret_cast<uint64_t*>(smem + S::kBar);
  uint64_t* h_empty = h_full + kHStages;
  uint64_t* w_full = h_empty + kHStages;
  uint64_t* w_empty = w_full + S::kWStages;

  const int wg = threadIdx.x / 128;   // < NC: consumers; NC: loads
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int n_chunks = (Cin + KC - 1) / KC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kHStages; ++s) {
      mbar_init(h_full + s, 1);
      mbar_init(h_empty + s, NC * 4);   // every consumer warp
    }
    for (int s = 0; s < S::kWStages; ++s) {
      mbar_init(w_full + s, 1);
      mbar_init(w_empty + s, NC * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == NC) {
    // ---- producer: one thread issues every TMA load
    setmaxnreg_dec<kProducerRegs>();
    if (warp != 0 || lane != 0) return;
    int hs = 0, ws = 0;   // halo / weight steps issued so far
    for (int ti = blockIdx.x; ti < n_items; ti += gridDim.x) {
      const Item it = item_of<S::kPar>(ti, tiles_w, tiles_h, frames, S::kTH,
                                       BN);
      for (int c = 0; c < n_chunks; ++c) {
        const int hslot = hs % kHStages;
        if (hs >= kHStages)
          mbar_wait(h_empty + hslot, (hs / kHStages - 1) & 1);
        // low-res rows y0 - 1 + a .. y0 + kTH - 1 + a, columns x0 - 1 ..
        mbar_arrive_expect_tx(h_full + hslot, S::kHaloBytes);
        tma_load_4d(smem + hslot * S::kHaloSlot, &map_x, h_full + hslot,
                    c * KC, it.x0 - 1, it.y0 - 1 + it.a, it.bt);
        ++hs;
        for (int p = 0; p < 2; ++p) {
          const int wslot = ws % S::kWStages;
          if (ws >= S::kWStages)
            mbar_wait(w_empty + wslot, (ws / S::kWStages - 1) & 1);
          mbar_arrive_expect_tx(w_full + wslot, S::kWBytes);
          unsigned char* dst = smem + S::kW + wslot * S::kWSlot;
          // box j: taps (p, 0), (p, 1) of parity (a, b), BN x KC each
          for (int j = 0; j < NB; ++j)
            tma_load_3d(dst + j * S::kWBox, &map_w, w_full + wslot, c * KC,
                        it.n0, it.a * 8 + (NB == 2 ? j : it.b) * 4 + p * 2);
          ++ws;
        }
      }
    }
    return;
  }

  // ---- consumers: warp k of warpgroup wg computes tile row 4 wg + k
  setmaxnreg_inc<S::kConsumerRegs>();
  const int ri = 4 * wg + warp;
  const int g = lane >> 2, tq = lane & 3;
  const int col = lane & 15, jhi = lane >> 4;   // this lane's ldmatrix row
  int hs = 0, ws = 0;
  float acc[NB][BN / 2];
  for (int ti = blockIdx.x; ti < n_items; ti += gridDim.x) {
    const Item it = item_of<S::kPar>(ti, tiles_w, tiles_h, frames, S::kTH,
                                     BN);
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) acc[j][e] = 0.f;

    // K steps (chunk, p), in the producer's order, each issued as groups
    // of two k16 products of one column shift s: at NB = 2, dx = s and
    // the accumulators j with tap q = s - j in {0, 1}; at NB = 1,
    // dx = b + s, q = s. A group's products run while the next group
    // gathers its A fragments: two register sets of 8, alternating by
    // group. A weight slot is released once the first group of the next
    // step has been issued and the group before it has finished; the
    // halo slot once its last fragments were consumed by an issue.
    constexpr int kPairs = KC / 32;          // k16 pairs of a chunk
    constexpr int kShifts = NB + 1;
    constexpr int kGroups = kShifts * kPairs;
    int w_prev = -1;
    auto group = [&](uint32_t(&a)[2][4], uint32_t(&a_prev)[2][4], int p,
                     int s, int kk0, const unsigned char* halo,
                     const unsigned char* wt) {
      // halo pixel (row + p, col + dx)
      const int px = (ri + p) * S::kHaloW + col + (NB == 2 ? s : it.b + s);
#pragma unroll
      for (int q2 = 0; q2 < 2; ++q2)
        ldmatrix_x4(a[q2], halo + px * S::kRB +
                               (swizzled<S::kRB>(px, 2 * (kk0 + q2) + jhi)
                                << 4));
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const int q = NB == 2 ? s - j : s;
        if (q < 0 || q > 1) continue;
#pragma unroll
        for (int q2 = 0; q2 < 2; ++q2)
          wgmma_acc<BN>(acc[j], a[q2],
                        wgmma_desc<S::kRB>(wt + (j * 2 + q) * BN * S::kRB +
                                               (kk0 + q2) * 32,
                                           16, 8 * S::kRB));
      }
      wgmma_commit();
      wgmma_wait<kASets - 1>();   // the group before this one has finished
#pragma unroll
      for (int j = 0; j < NB; ++j) fence_operands(acc[j]);
#pragma unroll
      for (int q2 = 0; q2 < 2; ++q2) fence_operands(a_prev[q2]);
    };
    uint32_t a0[2][4], a1[2][4];
    // step p of a chunk; its first group uses register set `first`
    auto step = [&](int p, auto first) {
      const int hslot = hs % kHStages, wslot = ws % S::kWStages;
      const unsigned char* halo = smem + hslot * S::kHaloSlot;
      const unsigned char* wt = smem + S::kW + wslot * S::kWSlot;
      if (p == 0) mbar_wait(h_full + hslot, (hs / kHStages) & 1);
      mbar_wait(w_full + wslot, (ws / S::kWStages) & 1);
#pragma unroll
      for (int u = 0; u < kGroups; ++u) {
        const int s = u / kPairs, kk0 = u % kPairs * 2;
        if (kASets == 1 || (u + decltype(first)::value) % 2 == 0)
          group(a0, kASets == 1 ? a0 : a1, p, s, kk0, halo, wt);
        else
          group(a1, a0, p, s, kk0, halo, wt);
        // the previous step's last group has finished: its weight slot
        // is free
        if (u == 0 && w_prev >= 0 && lane == 0)
          mbar_arrive(w_empty + w_prev);
      }
      if (p == 1) {                  // the issues above consumed the halo
        if (lane == 0) mbar_arrive(h_empty + hslot);
        ++hs;
      }
      w_prev = wslot;
      ++ws;
    };
#pragma unroll 1
    for (int c = 0; c < n_chunks; ++c) {
      step(0, std::integral_constant<int, 0>());
      step(1, std::integral_constant<int, kGroups % 2>());
    }
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < NB; ++j) fence_operands(acc[j]);
#pragma unroll
    for (int q2 = 0; q2 < 2; ++q2) {
      fence_operands(a0[q2]);
      fence_operands(a1[q2]);
    }
    if (lane == 0) mbar_arrive(w_empty + w_prev);

    // epilogue: + bias in fp32, bf16, high-res row 2 yy + a; accumulator
    // element 4i + 2r + c is position g + 8r of the row, channel
    // 8i + 2 tq + c
    const int yy = it.y0 + ri;
    if (yy >= H) continue;                        // warp-uniform
    if constexpr (S::kStaged) {
      // the warp's 32 pixels x BN channels into its staging buffer, then
      // one TMA store a box of 32 channels (pixels and channels outside y
      // are not written). Element 4i + 2r + c of parity b is pixel
      // px = 2 (g + 8r) + b, channel 8i + 2 tq + c: box i / 4, row px,
      // 16-byte chunk (i % 4) ^ ((px / 2) % 4), word tq
      unsigned char* stage =
          smem + S::kStage + (wg * 4 + warp) * S::kStageWarp;
      if (lane == 0) bulk_wait_read();   // its last store has read it
      __syncwarp();
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int n = it.n0 + 8 * i + 2 * tq;
        if (it.n0 + 8 * i >= Cout) break;         // warp-uniform
        const float b0 = bias[n], b1 = bias[n + 1];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            *reinterpret_cast<uint32_t*>(
                stage + (i / 4) * S::kStageBox +
                (2 * (g + 8 * r) + j) * 64 + (((i % 4) ^ (g & 3)) << 4) +
                4 * tq) = pack_bf16(acc[j][4 * i + 2 * r] + b0,
                                    acc[j][4 * i + 2 * r + 1] + b1);
      }
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < BN / 32; ++k)
          if (it.n0 + 32 * k < Cout)
            tma_store_4d(&map_y, stage + k * S::kStageBox, it.n0 + 32 * k,
                         2 * it.x0, 2 * yy + it.a, it.bt);
        bulk_commit();
      }
    } else {
      // each lane's channel pairs straight to y
      const long long row =
          ((long long)it.bt * 2 * H + 2 * yy + it.a) * (2LL * W);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const int b = NB == 2 ? j : it.b;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int xx = it.x0 + g + 8 * r;
          if (xx >= W) continue;
#pragma unroll
          for (int i = 0; i < BN / 8; ++i) {
            const int n = it.n0 + 8 * i + 2 * tq;
            if (n >= Cout) continue;
            *reinterpret_cast<uint32_t*>(
                y + (row + 2LL * xx + b) * Cout + n) =
                pack_bf16(acc[j][4 * i + 2 * r] + bias[n],
                          acc[j][4 * i + 2 * r + 1] + bias[n + 1]);
          }
        }
      }
    }
  }
  if (S::kStaged && lane == 0) bulk_wait();
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 0;
  }
  return n;
}

template <int BN, int NB, int KC, int NC>
int launch_up(const bf16* x, const bf16* wk, const float* bias, bf16* y,
              int B, int T, int H, int W, int Cin, int Cout,
              cudaStream_t stream) {
  using S = Up<BN, NB, KC, NC>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        vae_upsample_kernel<BN, NB, KC, NC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
    if (e != cudaSuccess) return (int)e;
    // the consumers' setmaxnreg.inc needs the whole launch allocation (a
    // smaller build would wait forever)
    cudaFuncAttributes fa;
    const cudaError_t ea =
        cudaFuncGetAttributes(&fa, vae_upsample_kernel<BN, NB, KC, NC>);
    if (ea != cudaSuccess) return (int)ea;
    if (fa.numRegs < S::kLaunchRegs) return (int)cudaErrorInvalidConfiguration;
    configured = true;
  }
  const CUtensorMapSwizzle swz =
      KC == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const cuuint64_t es = 2;
  // x [B * T, h, w, Cin]: boxes of an item's halo for one chunk
  const cuuint64_t xd[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H,
                            (cuuint64_t)B * T};
  const cuuint64_t xs[3] = {Cin * es, W * Cin * es,
                            (cuuint64_t)H * W * Cin * es};
  const cuuint32_t xb[4] = {KC, S::kHaloW, S::kHaloH, 1};
  // wk [16 = (a, b, p, q), Cout, Cin]: boxes of 2 q taps x BN rows x KC
  const cuuint64_t wd[3] = {(cuuint64_t)Cin, (cuuint64_t)Cout, 16};
  const cuuint64_t wstr[2] = {Cin * es, Cout * Cin * es};
  const cuuint32_t wb[3] = {KC, BN, 2};
  // y [B * T, 2h, 2w, Cout]: boxes of 32 channels of a warp's 32 pixels
  const cuuint64_t yd[4] = {(cuuint64_t)Cout, 2ULL * W, 2ULL * H,
                            (cuuint64_t)B * T};
  const cuuint64_t ys[3] = {Cout * es, 2ULL * W * Cout * es,
                            4ULL * H * W * Cout * es};
  const cuuint32_t yb[4] = {32, 32, 1, 1};
  CUtensorMap map_x, map_w, map_y;
  if (!make_tensor_map(&map_x, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, xd,
                       xs, xb, swz) ||
      !make_tensor_map(&map_w, wk, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, wd,
                       wstr, wb, swz) ||
      !make_tensor_map(&map_y, y, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, yd,
                       ys, yb, CU_TENSOR_MAP_SWIZZLE_64B))
    return (int)cudaErrorInvalidValue;
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tiles_h = (H + S::kTH - 1) / S::kTH;
  const int frames = B * T;
  const long long n_items = (long long)((Cout + BN - 1) / BN) * frames *
                            tiles_h * tiles_w * S::kPar;
  if (n_items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidValue;
  const int grid = n_items < sms ? (int)n_items : sms;
  vae_upsample_kernel<BN, NB, KC, NC><<<grid, S::kThreads, S::kBytes,
                                        stream>>>(
      map_x, map_w, map_y, bias, y, H, W, Cin, Cout, tiles_w, tiles_h, frames,
      (int)n_items);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* omni_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x [B, T, h, w, Cin] and y [B, T, 2h, 2w, Cout]: bf16, channels-last;
// wk [2, 2, 4, Cout, Cin] bf16 (the K-major copy of the parity weights);
// bias [Cout] fp32. Needs Cin % 16 == 0 and Cout % 8 == 0.
extern "C" int omni_vae_upsample_bf16(const void* x, const void* wk,
                                      const void* bias, void* y, int B, int T,
                                      int H, int W, int Cin, int Cout,
                                      void* stream) {
  if (Cin <= 0 || Cout <= 0 || Cin % 16 != 0 || Cout % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || T <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  auto run = [&](auto launch) {
    return launch(static_cast<const bf16*>(x), static_cast<const bf16*>(wk),
                  static_cast<const float*>(bias), static_cast<bf16*>(y), B,
                  T, H, W, Cin, Cout, static_cast<cudaStream_t>(stream));
  };
  // K steps of 32 channels (64-byte swizzle) at every Cin: shared memory
  // then holds the halo ring, 4 weight stages and the output staging.
  // Items of 12 low-res rows (three consumer warpgroups) where the grid's
  // last wave is nearly full, else of 8 (two) where that costs less: an
  // 8-row item does its rows about 10% slower, so compare rounds x rows
  // x 10 with rounds x rows x 11 (at 60x104 the 12-row items of one
  // frame are 140 on 132 SMs)
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidValue;
  auto rounds = [&](int th) {
    const long long items = (long long)((Cout + 95) / 96) * B * T *
                            ((H + th - 1) / th) * ((W + kTileW - 1) / kTileW) *
                            2;
    return (items + sms - 1) / sms;
  };
  if (rounds(8) * 8 * 11 < rounds(12) * 12 * 10)
    return run(launch_up<96, 2, kKC, 2>);
  return run(launch_up<96, 2, kKC, 3>);
}
