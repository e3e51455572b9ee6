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
//         * w2[(dt, dy, dx, ci), co] + bias[co] (+ residual), fp32 sums;
//   new cache = xin[T], xin[T + 1] (the last two activated frames).
// Pixels outside the frame are zero after activation, as the TPU kernel's
// zero-padded input gives (the norm of 0 is 0).
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): the
// products. Its largest call in the VAE (T=4, 480x832, 96 -> 96) is
// 2 * 27 * 96 * 96 * 1.6e6 = 7.95e11 FLOP (0.80 ms) against about 1.2 GB of
// inputs and outputs (0.37 ms); every VAE shape is compute-bound.
//
// Design (simple, mma.sync; wgmma and TMA are for a later change):
//   - the RMS norm needs a pixel's whole channel vector before any channel
//     of it can be activated, and a useful halo tile at Cin=384 does not fit
//     in shared memory. So a first, memory-bound kernel computes one fp32
//     inverse norm per pixel of x (one warp per pixel) and writes the new
//     cache; the conv kernel then activates each Cin chunk of its halo as
//     it loads it;
//   - the conv is an implicit GEMM: M = 256 output positions (one frame,
//     16 rows x 16 columns), N = 64 output channels, K = 27 * Cin, walked
//     as Cin chunks of 16 channels. For each chunk the block stages the
//     activated halo (3 frames x 18 x 18 pixels x 16 channels) and the 27
//     taps' weight rows (27 x 16 x 64, cp.async) in shared memory; each tap
//     is one m16n8k16 step whose A fragments are ldmatrix rows gathered at
//     the tap's shift of the halo (im2col without a copy);
//   - 8 warps as 4 (M) x 2 (N), each 64 positions (4 rows) x 32 channels;
//     109 KB of shared memory, two blocks per SM. The weight rows of a
//     chunk are the block's main traffic (55 KB from L2 per chunk), so the
//     256-position tile does half the reloads of a 128-position one
//     (PERF.md has the times of both);
//   - ragged tiles (H, W not multiples of 16, Cout not a multiple of
//     64) load zeros and store nothing outside the frame.
//
// C interface for ctypes; returns cudaGetLastError() after the launches.

#include "flash_common.cuh"

namespace {

using namespace omni;

constexpr int kTileH = 16, kTileW = 16;     // output positions of a block
constexpr int kMT = kTileH / 4;             // m16 tiles (tile rows) a warp
constexpr int kBN = 64;                     // output channels of a block
constexpr int kKC = 16;                     // input channels of a chunk
constexpr int kTaps = 27;
constexpr int kHaloH = kTileH + 2, kHaloW = kTileW + 2;
constexpr int kHaloPx = 3 * kHaloH * kHaloW;
constexpr int kLdA = kKC + 8;               // halves: conflict-free ldmatrix
constexpr int kLdB = kBN + 8;
constexpr int kThreads = 256;
constexpr int kSmem = (kHaloPx * kLdA + kTaps * kKC * kLdB) * 2;

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }

// bf16(silu(bf16(x * inv * gamma))), the sigmoid in fp32
__device__ __forceinline__ float activate(float x, float inv, float gamma) {
  const float y = __bfloat162float(__float2bfloat16((x * inv) * gamma));
  return y * (1.f / (1.f + expf(-y)));
}

// 8 channels (16 bytes) of one pixel, activated and packed as bf16
__device__ __forceinline__ uint4 activate8(uint4 raw, float inv,
                                           const float* gamma) {
  const bf16* e = reinterpret_cast<const bf16*>(&raw);
  uint4 out;
  uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    o[k] = pack_bf16(activate(bf2f(e[2 * k]), inv, gamma[2 * k]),
                     activate(bf2f(e[2 * k + 1]), inv, gamma[2 * k + 1]));
  return out;
}

// One warp per pixel of x [B, T, HW, C]: inv[pixel] = sqrt(C) /
// max(|x|, 1e-12); the frames of xin = [cache0, cache1, a_0 .. a_{T-1}]
// that become the new cache (xin[T], xin[T + 1]) are written activated.
__global__ void __launch_bounds__(kThreads)
norm_cache_kernel(const bf16* __restrict__ x, const bf16* __restrict__ cache,
                  const float* __restrict__ gamma, float* __restrict__ inv,
                  bf16* __restrict__ new_cache, int B, int T, int HW, int C) {
  const long long pix = ((long long)blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (pix >= (long long)B * T * HW) return;
  const int b = (int)(pix / ((long long)T * HW));
  const int t = (int)(pix / HW % T);
  const long long s = pix % HW;
  const bf16* xp = x + pix * C;
  float ss = 0.f;
  for (int c = lane * 8; c < C; c += 256) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xp + c);
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int k = 0; k < 8; ++k) ss += bf2f(e[k]) * bf2f(e[k]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float iv = sqrtf((float)C) / fmaxf(sqrtf(ss), 1e-12f);
  if (lane == 0) inv[pix] = iv;
  const int slot = t + 2 - T;          // xin frame t + 2 in the new cache
  if (slot >= 0) {
    bf16* dst = new_cache + (((long long)b * 2 + slot) * HW + s) * C;
    for (int c = lane * 8; c < C; c += 256)
      *reinterpret_cast<uint4*>(dst + c) =
          activate8(*reinterpret_cast<const uint4*>(xp + c), iv, gamma + c);
  }
  if (T == 1) {                        // new cache frame 0 = old frame 1
    const bf16* src = cache + (((long long)b * 2 + 1) * HW + s) * C;
    bf16* dst = new_cache + ((long long)b * 2 * HW + s) * C;
    for (int c = lane * 8; c < C; c += 256)
      *reinterpret_cast<uint4*>(dst + c) =
          *reinterpret_cast<const uint4*>(src + c);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
vae_conv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ cache,
                const float* __restrict__ inv, const float* __restrict__ gamma,
                const bf16* __restrict__ w2, const float* __restrict__ bias,
                const bf16* __restrict__ residual, bf16* __restrict__ y,
                int T, int H, int W, int Cin, int Cout, int tiles_w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sA = reinterpret_cast<bf16*>(smem_raw);   // [kHaloPx][kLdA]
  bf16* sB = sA + kHaloPx * kLdA;                 // [27][kKC][kLdB]

  const int y0 = (blockIdx.x / tiles_w) * kTileH;
  const int x0 = (blockIdx.x % tiles_w) * kTileW;
  const int n0 = blockIdx.y * kBN;
  const int b = blockIdx.z / T, t = blockIdx.z % T;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % 4, wn = warp / 4;
  const int g = lane >> 2, tq = lane & 3;
  const int n_warp = n0 + wn * 32;     // first output channel of this warp
  const long long HW = (long long)H * W;

  float acc[kMT][4][4];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      acc[mi][nt][0] = acc[mi][nt][1] = acc[mi][nt][2] = acc[mi][nt][3] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += kKC) {
    // the 27 taps' weight rows of this chunk, async (zeros past Cout)
    for (int i = threadIdx.x; i < kTaps * kKC * (kBN / 8); i += kThreads) {
      const int col8 = i % (kBN / 8), r = i / (kBN / 8) % kKC;
      const int tap = i / (kBN / 8 * kKC);
      const int n = n0 + col8 * 8;
      const bool ok = n < Cout;
      const bf16* src = w2 + ((long long)tap * Cin + c0 + r) * Cout + (ok ? n : 0);
      cp_async16(sB + (tap * kKC + r) * kLdB + col8 * 8, src, ok);
    }
    cp_async_commit();
    // the halo of this chunk, activated on the load
    for (int i = threadIdx.x; i < kHaloPx * 2; i += kThreads) {
      const int p = i >> 1, half = i & 1;
      const int f = p / (kHaloH * kHaloW), rem = p % (kHaloH * kHaloW);
      const int yy = y0 - 1 + rem / kHaloW, xx = x0 - 1 + rem % kHaloW;
      const int fr = t + f;            // frame of xin
      const int ch = c0 + half * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
        const long long s = (long long)yy * W + xx;
        if (fr < 2) {
          v = *reinterpret_cast<const uint4*>(
              cache + (((long long)b * 2 + fr) * HW + s) * Cin + ch);
        } else {
          const long long pix = ((long long)b * T + fr - 2) * HW + s;
          v = activate8(*reinterpret_cast<const uint4*>(x + pix * Cin + ch),
                        inv[pix], gamma + ch);
        }
      }
      *reinterpret_cast<uint4*>(sA + p * kLdA + half * 8) = v;
    }
    cp_async_wait_all();
    __syncthreads();

    const int mat = lane >> 3, r8 = lane & 7;
#pragma unroll 1
    for (int tap = 0; tap < kTaps; ++tap) {
      if (n_warp >= Cout) break;            // warp-uniform: no channels
      const int dt = tap / 9, dy = tap / 3 % 3, dx = tap % 3;
      const bf16* bt = sB + tap * kKC * kLdB + ((mat & 1) * 8 + r8) * kLdB +
                       wn * 32 + (mat >> 1) * 8;
      const bool pair1 = n_warp + 16 < Cout;   // second 16 channels exist
      uint32_t bf[2][4];
      ldmatrix_x4_trans(bf[0], bt);
      if (pair1) ldmatrix_x4_trans(bf[1], bt + 16);
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) {
        // ldmatrix row of this lane: output position (kMT wm + mi, lane % 16)
        const int p = (dt * kHaloH + kMT * wm + mi + dy) * kHaloW +
                      (lane & 15) + dx;
        uint32_t af[4];
        ldmatrix_x4(af, sA + p * kLdA + (lane >> 4) * 8);
        mma_16816(acc[mi][0], af, bf[0][0], bf[0][1]);
        mma_16816(acc[mi][1], af, bf[0][2], bf[0][3]);
        if (pair1) {
          mma_16816(acc[mi][2], af, bf[1][0], bf[1][1]);
          mma_16816(acc[mi][3], af, bf[1][2], bf[1][3]);
        }
      }
    }
    __syncthreads();                   // every warp is done with sA, sB
  }

  // epilogue: + bias (+ residual) in fp32, bf16 store
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int n = n_warp + nt * 8 + 2 * tq;
    if (n >= Cout) continue;
    const float b0 = bias[n], b1 = bias[n + 1];
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) {
      const int yy = y0 + kMT * wm + mi;
      if (yy >= H) continue;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int xx = x0 + g + 8 * hf;
        if (xx >= W) continue;
        const long long o = (((long long)b * T + t) * HW + (long long)yy * W + xx)
                            * Cout + n;
        float v0 = acc[mi][nt][2 * hf] + b0, v1 = acc[mi][nt][2 * hf + 1] + b1;
        if (residual != nullptr) {
          const __nv_bfloat162 r =
              *reinterpret_cast<const __nv_bfloat162*>(residual + o);
          v0 += __bfloat162float(r.x);
          v1 += __bfloat162float(r.y);
        }
        *reinterpret_cast<uint32_t*>(y + o) = pack_bf16(v0, v1);
      }
    }
  }
}

}  // namespace

extern "C" const char* omni_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x [B, T, H, W, Cin], cache [B, 2, H, W, Cin], residual (or null) and y
// [B, T, H, W, Cout], new_cache [B, 2, H, W, Cin]: bf16, channels-last;
// gamma [Cin], bias [Cout], inv (scratch, [B, T, H, W]): fp32; w2
// [27 * Cin, Cout] bf16. Needs Cin % 16 == 0 and Cout % 8 == 0.
extern "C" int omni_vae_conv_bf16(const void* x, const void* cache,
                                  const void* gamma, const void* w2,
                                  const void* bias, const void* residual,
                                  void* y, void* new_cache, void* inv, int B,
                                  int T, int H, int W, int Cin, int Cout,
                                  void* stream) {
  if (Cin % kKC != 0 || Cout % 8 != 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || T <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        vae_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long pixels = (long long)B * T * H * W;
  norm_cache_kernel<<<(unsigned)((pixels + kThreads / 32 - 1) / (kThreads / 32)),
                      kThreads, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(cache),
      static_cast<const float*>(gamma), static_cast<float*>(inv),
      static_cast<bf16*>(new_cache), B, T, H * W, Cin);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tiles_h = (H + kTileH - 1) / kTileH;
  const dim3 grid(tiles_w * tiles_h, (Cout + kBN - 1) / kBN, B * T);
  vae_conv_kernel<<<grid, kThreads, kSmem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(cache),
      static_cast<const float*>(inv), static_cast<const float*>(gamma),
      static_cast<const bf16*>(w2), static_cast<const float*>(bias),
      static_cast<const bf16*>(residual), static_cast<bf16*>(y), T, H, W, Cin,
      Cout, tiles_w);
  return (int)cudaGetLastError();
}
