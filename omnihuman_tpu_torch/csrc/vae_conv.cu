// K3: fused RMS-norm -> SiLU -> causal 3x3x3 conv (+ bias, + residual) of a
// VAE residual block, for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces the TPU Pallas kernel omnihuman_tpu/ops/vae_pallas.py `_kernel`
// (entry `fused_act_causal_conv3d`). What it computes, on channels-last
// [B, T, H, W, C] memory (the port's [B, C, T, H, W] in channels_last_3d):
//   a   = bf16(silu(bf16(x * (sqrt(Cin) / max(|x|, 1e-12)) * gamma)))
//         (norm over the channels of each pixel, fp32 math);
//   xin = [cache (2 activated frames), a (T frames)] along time;
//   y   = sum over (dt, dy, dx, ci) of xin[t + dt, h + dy - 1, w + dx - 1, ci]
//         * w[(dt, dy, dx), co, ci] + bias[co] (+ residual), fp32 sums;
//   new cache = xin[T], xin[T + 1] (the last two activated frames).
// Pixels outside the frame are zero after activation, as the TPU kernel's
// zero-padded input gives (the norm of 0 is 0).
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): the
// products. Its largest call in the VAE (T=4, 480x832, 96 -> 96) is
// 2 * 27 * 96 * 96 * 1.6e6 = 7.95e11 FLOP (0.80 ms) against about 1.2 GB of
// inputs and outputs (0.37 ms); every VAE shape is compute-bound.
//
// Design:
//   - a memory-bound pre-pass (act_cache_kernel) reads x once and writes
//     a, the activated frames ([B, T, H, W, Cin] bf16), and the new cache
//     apart (the last two frames of [cache, a]). The RMS norm needs a
//     pixel's whole channel vector; the pass spreads 16-byte loads over
//     pixels x channel groups (every lane busy at any Cin), holds them in
//     registers, keeps one partial sum of squares per 16-byte group in
//     shared memory and adds a pixel's partials in a fixed order. The
//     conv then reads only activated bf16: frames 0, 1 of xin from the
//     cache, frames 2.. from a (the cache is not copied);
//   - the conv is an implicit GEMM: M = output positions of a tile of
//     kTH rows x 16 columns of one frame, N = BN output channels, K = 27
//     taps x Cin, walked as (dt, Cin chunk of KC channels, dy) steps. TMA
//     brings the halo of a (dt, chunk), (kTH + 2) x 18 pixels x KC
//     channels of frame t + dt of xin, as a box of a 4-D tensor map over
//     the cache or over a [B * frames, H, W, Cin] (the
//     SAME padding arrives as zeros: TMA fills coordinates outside H x W,
//     and channels past Cin), and the weights of a (dt, dy, chunk), the
//     three dx taps x BN rows x KC channels of the K-major copy
//     [27, Cout, Cin], as a box of a 3-D map; both in the swizzle whose
//     rows are KC * 2 bytes. KC = 64 (128-byte swizzle) where Cin % 64 ==
//     0, else 32 (64-byte swizzle: at Cin = 96 a 64-channel chunk would
//     spend a third of the products on zeros);
//   - one producer warp (of a producer warpgroup, setmaxnreg 24) keeps a
//     2-slot halo ring and a weight ring of up to 4 slots in flight on
//     mbarriers; three consumer warpgroups (setmaxnreg 160) own kTH / 3
//     rows each as MT m64 tiles. For each dx tap, m64 tile and 32 channels
//     of a step, each warp gathers its A fragments (one output row of 16
//     positions, the tap's shift of the halo) with ldmatrix.x4 from the
//     swizzled halo (im2col without a copy: the register-A layout of
//     wgmma is ldmatrix's), then issues wgmma m64nBNk16 with B (the
//     weights) from shared memory through a descriptor. Two small A
//     register sets alternate, so one group's products run while the next
//     group's fragments are gathered (larger sets left ptxas short of
//     registers, and it then serialized the wgmmas);
//   - N per shape: BN = 192 with M = 192 (kTH = 12) when Cout is a
//     multiple of 192 (one N-block at 192, two at 384), else BN = 96 with
//     M = 384 (kTH = 24); 96 accumulator registers a thread either way. A
//     block pulls 27 * Cin * BN * 2 bytes of weights from L2 per tile, so
//     the weight traffic per FLOP falls as 1 / M;
//   - persistent blocks (one per SM) walk the tiles in order, N-block
//     slowest, so the producer loads the next tile while the consumers
//     store this one. Epilogue: + bias (+ residual) in fp32, bf16 stores,
//     positions and channels outside the output not stored.
// Bitwise deterministic: every output element is one thread's sums in a
// fixed order; no atomics.
//
// C interface for ctypes; the entries return cudaGetLastError() after the
// launches (cudaErrorInvalidValue on an unsupported shape or a refused
// tensor map).

#include <type_traits>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace omni;

constexpr int kMaxWStages = 4;      // weight ring (fewer if smem is short)
constexpr int kHStages = 2;         // halo ring
constexpr int kConsumers = 3;       // warpgroups
constexpr int kThreads = (kConsumers + 1) * 128;
// setmaxnreg moves registers within the launch allocation (65,536 / the
// block's threads, a multiple of 8): the producer keeps 24 a thread, the
// consumers share the rest
constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs =
    (kLaunchRegs * (kConsumers + 1) - kProducerRegs) / kConsumers / 8 * 8;
constexpr int kTileW = 16;          // output columns of a tile
constexpr int kSmemMax = 232448;    // dynamic shared memory a block may use

template <int BN, int MT, int KC>
struct Conv {
  static constexpr int kTH = kConsumers * MT * 4;   // output rows of a tile
  static constexpr int kRB = KC * 2;      // bytes of a halo pixel / weight row
  static constexpr int kHaloW = kTileW + 2, kHaloH = kTH + 2;
  static constexpr int kHaloBytes = kRB * kHaloW * kHaloH;
  static constexpr int kHaloSlot = (kHaloBytes + 1023) / 1024 * 1024;
  static constexpr int kWBytes = 3 * BN * kRB;      // 3 taps x BN x KC
  static constexpr int kWSlot = (kWBytes + 1023) / 1024 * 1024;
  static constexpr int kFixed = 1024 + 256;         // alignment + barriers
  static constexpr int kWFit =
      (kSmemMax - kFixed - kHStages * kHaloSlot) / kWSlot;
  static constexpr int kWStages = kWFit < kMaxWStages ? kWFit : kMaxWStages;
  static constexpr int kW = kHStages * kHaloSlot;   // offset of the weights
  static constexpr int kBar = kW + kWStages * kWSlot;
  static constexpr int kBytes = kBar + kFixed;
  static constexpr int kKSteps = KC / 16;
  static_assert(kWStages >= 2, "shared memory holds two weight stages");
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

struct Tile {
  int b, t, y0, x0, n0;
};

// Tile ti: columns fastest, then rows, frames, N-blocks.
__device__ __forceinline__ Tile tile_of(int ti, int tiles_w, int tiles_h,
                                        int frames, int T, int th, int bn) {
  Tile tl;
  tl.x0 = (ti % tiles_w) * kTileW;
  ti /= tiles_w;
  tl.y0 = (ti % tiles_h) * th;
  ti /= tiles_h;
  const int bt = ti % frames;
  tl.n0 = (ti / frames) * bn;
  tl.b = bt / T;
  tl.t = bt % T;
  return tl;
}

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }

// bf16(silu(bf16(x * inv * gamma))), the sigmoid in fp32 (fast exp and
// divide: within an fp32 ulp or two, far below the bf16 rounding after)
__device__ __forceinline__ float activate(float x, float inv, float gamma) {
  const float y = __bfloat162float(__float2bfloat16((x * inv) * gamma));
  return __fdividef(y, 1.f + __expf(-y));
}

// 8 channels (16 bytes) of one pixel, activated and packed as bf16
__device__ __forceinline__ uint4 activate8(uint4 raw, float inv,
                                           const float* gamma) {
  const bf16* e = reinterpret_cast<const bf16*>(&raw);
  const float4 g0 = *reinterpret_cast<const float4*>(gamma);
  const float4 g1 = *reinterpret_cast<const float4*>(gamma + 4);
  const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
  uint4 out;
  uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    o[k] = pack_bf16(activate(bf2f(e[2 * k]), inv, g[2 * k]),
                     activate(bf2f(e[2 * k + 1]), inv, g[2 * k + 1]));
  return out;
}

constexpr int kPreThreads = 256;
constexpr int kPreGroups = 16;      // 16-byte groups a thread holds
constexpr int kPreChunks = kPreThreads * kPreGroups;   // ... a block

// The pre-pass over B * T * HW pixels of x (activated into a; its last
// two frames, or its one, also into the new cache) and, at T = 1, B * HW
// pixels of cache frame 1 (copied to new-cache frame 0), `px` (<= 256) a
// block. Each pixel's rows are located once, in shared memory; thread i
// takes 16-byte groups i + 256 k (k < 16) of the block's pixels (group g:
// pixel g / (C / 8), channels 8 (g % (C / 8)) ..: neighbouring lanes on
// neighbouring addresses), loads them all at once into registers, adds
// each one's squares into a partial sum in shared memory, and after the
// pixels' norms activates and stores them.
__global__ void __launch_bounds__(kPreThreads)
act_cache_kernel(const bf16* __restrict__ x, const bf16* __restrict__ cache,
                 const float* __restrict__ gamma, bf16* __restrict__ a,
                 bf16* __restrict__ new_cache, int B, int T, int HW, int C,
                 int n_pix, int px) {
  __shared__ float part[kPreChunks];
  __shared__ float inv[kPreThreads];
  __shared__ long long src[kPreThreads];   // the pixel's row in x or cache
  __shared__ long long dst_a[kPreThreads];  // ... in a, or -1 (a copy)
  __shared__ long long dst_c[kPreThreads];  // ... in new_cache, or -1
  const int c8 = C / 8;
  const int p0 = blockIdx.x * px;
  const int n_px = min(px, n_pix - p0);
  const int n = n_px * c8;
  const int n_act = B * T * HW;            // pixels of x; the rest copy
  for (int p = threadIdx.x; p < n_px; p += kPreThreads) {
    const int q = p0 + p;
    if (q < n_act) {
      const int b = q / (T * HW), t = q / HW % T, s = q % HW;
      src[p] = dst_a[p] = (long long)q * C;
      dst_c[p] = t >= T - 2 ? ((long long)(b * 2 + t + 2 - T) * HW + s) * C
                            : -1;
    } else {                               // T = 1: cache frame 1 -> 0
      const int b = (q - n_act) / HW, s = (q - n_act) % HW;
      src[p] = ((long long)(b * 2 + 1) * HW + s) * C;
      dst_a[p] = -1;
      dst_c[p] = ((long long)b * 2 * HW + s) * C;
    }
  }
  __syncthreads();
  uint4 raw[kPreGroups];
#pragma unroll
  for (int k = 0; k < kPreGroups; ++k) {
    const int i = threadIdx.x + k * kPreThreads;
    if (i < n) {
      const int p = i / c8;
      raw[k] = *reinterpret_cast<const uint4*>(
          (dst_a[p] >= 0 ? x : cache) + src[p] + (i - p * c8) * 8);
    }
  }
  // sum of squares of each 16-byte group
#pragma unroll
  for (int k = 0; k < kPreGroups; ++k) {
    const int i = threadIdx.x + k * kPreThreads;
    if (i < n) {
      const bf16* e = reinterpret_cast<const bf16*>(&raw[k]);
      float ss = 0.f;
#pragma unroll
      for (int m = 0; m < 8; ++m) ss += bf2f(e[m]) * bf2f(e[m]);
      part[i] = ss;
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < n_px; p += kPreThreads) {
    float ss = 0.f;
    for (int j = 0; j < c8; ++j) ss += part[p * c8 + j];
    inv[p] = sqrtf((float)C) / fmaxf(sqrtf(ss), 1e-12f);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPreGroups; ++k) {
    const int i = threadIdx.x + k * kPreThreads;
    if (i < n) {
      const int p = i / c8, c = (i - p * c8) * 8;
      const bool act = dst_a[p] >= 0;
      const uint4 v = act ? activate8(raw[k], inv[p], gamma + c) : raw[k];
      if (act) *reinterpret_cast<uint4*>(a + dst_a[p] + c) = v;
      if (dst_c[p] >= 0)
        *reinterpret_cast<uint4*>(new_cache + dst_c[p] + c) = v;
    }
  }
}

template <int BN, int MT, int KC>
__global__ void __launch_bounds__(kThreads, 1)
vae_conv_kernel(const __grid_constant__ CUtensorMap map_c,
                const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_w,
                const float* __restrict__ bias,
                const bf16* __restrict__ residual, bf16* __restrict__ y,
                int T, int H, int W, int Cin, int Cout, int tiles_w,
                int tiles_h, int frames, int n_tiles) {
  using S = Conv<BN, MT, KC>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* h_full = reinterpret_cast<uint64_t*>(smem + S::kBar);
  uint64_t* h_empty = h_full + kHStages;
  uint64_t* w_full = h_empty + kHStages;
  uint64_t* w_empty = w_full + S::kWStages;

  const int wg = threadIdx.x / 128;   // < kConsumers: consumers; last: loads
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int n_chunks = (Cin + KC - 1) / KC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kHStages; ++s) {
      mbar_init(h_full + s, 1);
      mbar_init(h_empty + s, kConsumers * 4);   // every consumer warp
    }
    for (int s = 0; s < S::kWStages; ++s) {
      mbar_init(w_full + s, 1);
      mbar_init(w_empty + s, kConsumers * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread issues every TMA load
    setmaxnreg_dec<kProducerRegs>();
    if (warp != 0 || lane != 0) return;
    int hs = 0, ws = 0;   // halo / weight steps issued so far
    for (int ti = blockIdx.x; ti < n_tiles; ti += gridDim.x) {
      const Tile tl = tile_of(ti, tiles_w, tiles_h, frames, T, S::kTH, BN);
      for (int dt = 0; dt < 3; ++dt)
        for (int c = 0; c < n_chunks; ++c) {
          const int hslot = hs % kHStages;
          if (hs >= kHStages)
            mbar_wait(h_empty + hslot, (hs / kHStages - 1) & 1);
          // frame t + dt of xin = [cache, a]
          const int fr = tl.t + dt;
          mbar_arrive_expect_tx(h_full + hslot, S::kHaloBytes);
          tma_load_4d(smem + hslot * S::kHaloSlot, fr < 2 ? &map_c : &map_a,
                      h_full + hslot, c * KC, tl.x0 - 1, tl.y0 - 1,
                      fr < 2 ? tl.b * 2 + fr : tl.b * T + fr - 2);
          ++hs;
          for (int dy = 0; dy < 3; ++dy) {
            const int wslot = ws % S::kWStages;
            if (ws >= S::kWStages)
              mbar_wait(w_empty + wslot, (ws / S::kWStages - 1) & 1);
            mbar_arrive_expect_tx(w_full + wslot, S::kWBytes);
            tma_load_3d(smem + S::kW + wslot * S::kWSlot, &map_w,
                        w_full + wslot, c * KC, tl.n0, dt * 9 + dy * 3);
            ++ws;
          }
        }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns tile rows wg * 4 MT .. + 4 MT - 1;
  // warp w of m64 tile i computes the 16 positions of row
  // row0 + 4 i = 4 (wg MT + i) + w
  setmaxnreg_inc<kConsumerRegs>();
  const int row0 = 4 * MT * wg + warp;
  const int g = lane >> 2, tq = lane & 3;
  const int col = lane & 15, jhi = lane >> 4;   // this lane's ldmatrix row
  int hs = 0, ws = 0;
  float acc[MT][BN / 2];
  for (int ti = blockIdx.x; ti < n_tiles; ti += gridDim.x) {
    const Tile tl = tile_of(ti, tiles_w, tiles_h, frames, T, S::kTH, BN);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) acc[i][e] = 0.f;

    // K steps k = (dt, chunk, dy), in the producer's order, each issued
    // as groups of at most two k16 products: (dx, m64 tile i, 32 of the
    // chunk's channels). A group's products run while the next group
    // gathers its A fragments: two register sets of 8, alternating by
    // group (small, so that 96 accumulators fit beside them in the
    // consumers' registers). A weight slot is released once the first
    // group of the next step has been issued and the group before it has
    // finished; the halo slot once its last fragments were consumed by an
    // issue.
    constexpr int kGroupK = S::kKSteps < 2 ? S::kKSteps : 2;
    constexpr int kGroupsPerTap = MT * (S::kKSteps / kGroupK);
    constexpr int kGroups = 3 * kGroupsPerTap;     // a step's groups
    int w_prev = -1;
    auto group = [&](uint32_t(&a)[kGroupK][4],
                     uint32_t(&a_prev)[kGroupK][4], int dy, int dx, int i,
                     int kk0, const unsigned char* halo,
                     const unsigned char* wt) {
      // halo pixel (row + dy, col + dx)
      const int p = (row0 + 4 * i + dy) * S::kHaloW + col + dx;
#pragma unroll
      for (int q = 0; q < kGroupK; ++q)
        ldmatrix_x4(a[q], halo + p * S::kRB +
                              (swizzled<S::kRB>(p, 2 * (kk0 + q) + jhi) << 4));
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < kGroupK; ++q)
        wgmma_acc<BN>(acc[i], a[q],
                      wgmma_desc<S::kRB>(wt + dx * BN * S::kRB + (kk0 + q) * 32,
                                         16, 8 * S::kRB));
      wgmma_commit();
      wgmma_wait<1>();   // the group before this one has finished
#pragma unroll
      for (int m = 0; m < MT; ++m) fence_operands(acc[m]);
#pragma unroll
      for (int q = 0; q < kGroupK; ++q) fence_operands(a_prev[q]);
    };
    uint32_t a0[kGroupK][4], a1[kGroupK][4];
    // step k; its first group uses register set `first` (0 or 1)
    auto step = [&](int k, auto first) {
      const int dy = k % 3;
      const int hslot = hs % kHStages, wslot = ws % S::kWStages;
      const unsigned char* halo = smem + hslot * S::kHaloSlot;
      const unsigned char* wt = smem + S::kW + wslot * S::kWSlot;
      if (dy == 0) mbar_wait(h_full + hslot, (hs / kHStages) & 1);
      mbar_wait(w_full + wslot, (ws / S::kWStages) & 1);
#pragma unroll
      for (int u = 0; u < kGroups; ++u) {
        const int dx = u / kGroupsPerTap, i = u / (S::kKSteps / kGroupK) % MT;
        const int kk0 = u % (S::kKSteps / kGroupK) * kGroupK;
        if ((u + decltype(first)::value) % 2 == 0)
          group(a0, a1, dy, dx, i, kk0, halo, wt);
        else
          group(a1, a0, dy, dx, i, kk0, halo, wt);
        // step k - 1's last group has finished: its weight slot is free
        if (u == 0 && w_prev >= 0 && lane == 0)
          mbar_arrive(w_empty + w_prev);
      }
      if (dy == 2) {                 // the issues above consumed the halo
        if (lane == 0) mbar_arrive(h_empty + hslot);
        ++hs;
      }
      w_prev = wslot;
      ++ws;
    };
    const int n_steps = 9 * n_chunks;
#pragma unroll 1
    for (int k = 0; k < n_steps; k += 2) {
      step(k, std::integral_constant<int, 0>());
      if (k + 1 < n_steps)
        step(k + 1, std::integral_constant<int, kGroups % 2>());
    }
    wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < MT; ++m) fence_operands(acc[m]);
#pragma unroll
    for (int q = 0; q < kGroupK; ++q) {
      fence_operands(a0[q]);
      fence_operands(a1[q]);
    }
    if (lane == 0) mbar_arrive(w_empty + w_prev);

    // epilogue: + bias (+ residual) in fp32, bf16 stores; accumulator
    // element 4j + 2r + c is position g + 8r, channel 8j + 2 tq + c
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int yy = tl.y0 + row0 + 4 * i;
      if (yy >= H) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int xx = tl.x0 + g + 8 * r;
        if (xx >= W) continue;
        const long long o =
            ((((long long)tl.b * T + tl.t) * H + yy) * W + xx) * Cout;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int n = tl.n0 + 8 * j + 2 * tq;
          if (n >= Cout) continue;
          float v0 = acc[i][4 * j + 2 * r] + bias[n];
          float v1 = acc[i][4 * j + 2 * r + 1] + bias[n + 1];
          if (residual != nullptr) {
            const __nv_bfloat162 rr =
                *reinterpret_cast<const __nv_bfloat162*>(residual + o + n);
            v0 += __bfloat162float(rr.x);
            v1 += __bfloat162float(rr.y);
          }
          *reinterpret_cast<uint32_t*>(y + o + n) = pack_bf16(v0, v1);
        }
      }
    }
  }
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

int launch_act_cache(const bf16* x, const bf16* cache, const float* gamma,
                     bf16* a, bf16* new_cache, int B, int T, int H, int W,
                     int C, cudaStream_t stream) {
  const int px = kPreChunks / (C / 8) < kPreThreads ? kPreChunks / (C / 8)
                                                    : kPreThreads;
  const long long n_pix = (long long)B * (T + (T == 1 ? 1 : 0)) * H * W;
  if (px <= 0 || n_pix > 0x7fffffff) return (int)cudaErrorInvalidValue;
  act_cache_kernel<<<(unsigned)((n_pix + px - 1) / px), kPreThreads, 0,
                     stream>>>(x, cache, gamma, a, new_cache, B, T, H * W, C,
                               (int)n_pix, px);
  return (int)cudaGetLastError();
}

template <int BN, int MT, int KC>
int launch_conv(const bf16* cache, const bf16* a, const bf16* wk,
                const float* bias,
                const bf16* residual, bf16* y, int B, int T, int H, int W,
                int Cin, int Cout, cudaStream_t stream) {
  using S = Conv<BN, MT, KC>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        vae_conv_kernel<BN, MT, KC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
    if (e != cudaSuccess) return (int)e;
    // the consumers' setmaxnreg.inc needs the whole launch allocation (a
    // smaller build would wait forever)
    cudaFuncAttributes fa;
    const cudaError_t ea =
        cudaFuncGetAttributes(&fa, vae_conv_kernel<BN, MT, KC>);
    if (ea != cudaSuccess) return (int)ea;
    if (fa.numRegs < kLaunchRegs) return (int)cudaErrorInvalidConfiguration;
    configured = true;
  }
  const CUtensorMapSwizzle swz =
      KC == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const cuuint64_t es = 2;
  // cache [B * 2, H, W, Cin] and a [B * T, H, W, Cin]: boxes of the halo
  // of one frame
  const cuuint64_t cd[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H,
                            (cuuint64_t)B * 2};
  const cuuint64_t ad[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H,
                            (cuuint64_t)B * T};
  const cuuint64_t xs[3] = {Cin * es, W * Cin * es, (cuuint64_t)H * W * Cin * es};
  const cuuint32_t xb[4] = {KC, S::kHaloW, S::kHaloH, 1};
  // wk [27, Cout, Cin]: boxes of 3 taps x BN rows x KC channels
  const cuuint64_t wd[3] = {(cuuint64_t)Cin, (cuuint64_t)Cout, 27};
  const cuuint64_t wstr[2] = {Cin * es, Cout * Cin * es};
  const cuuint32_t wb[3] = {KC, BN, 3};
  CUtensorMap map_c, map_a, map_w;
  if (!make_tensor_map(&map_c, cache, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, cd,
                       xs, xb, swz) ||
      !make_tensor_map(&map_a, a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, ad,
                       xs, xb, swz) ||
      !make_tensor_map(&map_w, wk, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, wd,
                       wstr, wb, swz))
    return (int)cudaErrorInvalidValue;
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tiles_h = (H + S::kTH - 1) / S::kTH;
  const int frames = B * T;
  const int n_tiles = (Cout + BN - 1) / BN * frames * tiles_h * tiles_w;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidValue;
  const int grid = n_tiles < sms ? n_tiles : sms;
  vae_conv_kernel<BN, MT, KC><<<grid, kThreads, S::kBytes, stream>>>(
      map_c, map_a, map_w, bias, residual, y, T, H, W, Cin, Cout, tiles_w,
      tiles_h, frames, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* omni_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The pre-pass alone (the conv entry below runs it too): x and a
// [B, T, H, W, C], cache and new_cache [B, 2, H, W, C], bf16
// channels-last; gamma [C] fp32. Needs C % 8 == 0.
extern "C" int omni_vae_act_cache_bf16(const void* x, const void* cache,
                                       const void* gamma, void* a,
                                       void* new_cache, int B, int T, int H,
                                       int W, int C, void* stream) {
  if (C <= 0 || C % 8 != 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || T <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  return launch_act_cache(
      static_cast<const bf16*>(x), static_cast<const bf16*>(cache),
      static_cast<const float*>(gamma), static_cast<bf16*>(a),
      static_cast<bf16*>(new_cache), B, T, H, W, C,
      static_cast<cudaStream_t>(stream));
}

// x [B, T, H, W, Cin], cache [B, 2, H, W, Cin], residual (or null) and y
// [B, T, H, W, Cout], new_cache [B, 2, H, W, Cin], a (scratch, the
// activated x, [B, T, H, W, Cin]): bf16, channels-last; gamma [Cin], bias [Cout]:
// fp32; wk [27, Cout, Cin] bf16 (the K-major copy of the packed weights).
// Needs Cin % 16 == 0 and Cout % 8 == 0.
extern "C" int omni_vae_conv_bf16(const void* x, const void* cache,
                                  const void* gamma, const void* wk,
                                  const void* bias, const void* residual,
                                  void* y, void* new_cache, void* a, int B,
                                  int T, int H, int W, int Cin, int Cout,
                                  void* stream) {
  if (Cin <= 0 || Cout <= 0 || Cin % 16 != 0 || Cout % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || T <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int e = launch_act_cache(
      static_cast<const bf16*>(x), static_cast<const bf16*>(cache),
      static_cast<const float*>(gamma), static_cast<bf16*>(a),
      static_cast<bf16*>(new_cache), B, T, H, W, Cin, s);
  if (e != 0) return e;
  auto run = [&](auto launch) {
    return launch(static_cast<const bf16*>(cache),
                  static_cast<const bf16*>(a), static_cast<const bf16*>(wk),
                  static_cast<const float*>(bias),
                  static_cast<const bf16*>(residual), static_cast<bf16*>(y),
                  B, T, H, W, Cin, Cout, s);
  };
  // K steps of 64 channels (128-byte swizzle) where Cin allows, else 32
  // (64-byte swizzle; Cin = 96 would waste a third on a zero half chunk)
  const bool wide = Cin % 64 == 0;
  if (Cout % 192 == 0)
    return wide ? run(launch_conv<192, 1, 64>) : run(launch_conv<192, 1, 32>);
  return wide ? run(launch_conv<96, 2, 64>) : run(launch_conv<96, 2, 32>);
}
