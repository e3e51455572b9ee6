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
// fp32 sums; the parities are interleaved on the store.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): the
// products. Its largest call in the VAE (T=4, 240x416 -> 480x832,
// 192 -> 96) is 4 * 2 * 4 * 192 * 96 * 4e5 = 2.36e11 FLOP (0.24 ms) against
// 0.38 GB of input and output (0.11 ms).
//
// Design: vae_conv.cu's implicit GEMM with 4 taps and no prologue. A block
// computes one parity of 8 x 16 low-res positions of one frame and 64
// output channels; per chunk of 16 input channels it stages the 10 x 18
// halo and the 4 taps' weight rows with cp.async, and each tap is one
// m16n8k16 step on ldmatrix rows gathered at the tap's shift. The parity
// is a grid dimension, so the halo is read four times from L2 rather than
// holding four accumulators.
//
// C interface for ctypes; returns cudaGetLastError() after the launch.

#include "flash_common.cuh"

namespace {

using namespace omni;

constexpr int kTileH = 8, kTileW = 16;      // low-res positions of a block
constexpr int kBN = 64;
constexpr int kKC = 16;
constexpr int kTaps = 4;
constexpr int kHaloH = kTileH + 2, kHaloW = kTileW + 2;
constexpr int kHaloPx = kHaloH * kHaloW;
constexpr int kLdA = kKC + 8;
constexpr int kLdB = kBN + 8;
constexpr int kThreads = 256;
constexpr int kSmem = (kHaloPx * kLdA + kTaps * kKC * kLdB) * 2;

__global__ void __launch_bounds__(kThreads, 2)
vae_upsample_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w4,
                    const float* __restrict__ bias, bf16* __restrict__ y,
                    int T, int H, int W, int Cin, int Cout, int tiles_w) {
  __shared__ __align__(16) bf16 sA[kHaloPx * kLdA];
  __shared__ __align__(16) bf16 sB[kTaps * kKC * kLdB];

  const int y0 = (blockIdx.x / tiles_w) * kTileH;
  const int x0 = (blockIdx.x % tiles_w) * kTileW;
  const int n0 = blockIdx.y * kBN;
  const int pa = blockIdx.z & 1, pb = (blockIdx.z >> 1) & 1;
  const int bt = blockIdx.z >> 2;      // b * T + t
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % 4, wn = warp / 4;
  const int g = lane >> 2, tq = lane & 3;
  const int n_warp = n0 + wn * 32;
  const long long HW = (long long)H * W;
  const bf16* xf = x + (long long)bt * HW * Cin;
  const bf16* wp = w4 + (long long)(pa * 2 + pb) * 4 * Cin * Cout;

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      acc[mi][nt][0] = acc[mi][nt][1] = acc[mi][nt][2] = acc[mi][nt][3] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += kKC) {
    for (int i = threadIdx.x; i < kTaps * kKC * (kBN / 8); i += kThreads) {
      const int col8 = i % (kBN / 8), r = i / (kBN / 8) % kKC;
      const int tap = i / (kBN / 8 * kKC);
      const int n = n0 + col8 * 8;
      const bool ok = n < Cout;
      const bf16* src = wp + ((long long)tap * Cin + c0 + r) * Cout + (ok ? n : 0);
      cp_async16(sB + (tap * kKC + r) * kLdB + col8 * 8, src, ok);
    }
    for (int i = threadIdx.x; i < kHaloPx * 2; i += kThreads) {
      const int p = i >> 1, half = i & 1;
      const int yy = y0 - 1 + p / kHaloW, xx = x0 - 1 + p % kHaloW;
      const bool ok = yy >= 0 && yy < H && xx >= 0 && xx < W;
      const bf16* src =
          xf + (ok ? ((long long)yy * W + xx) * Cin + c0 + half * 8 : 0);
      cp_async16(sA + p * kLdA + half * 8, src, ok);
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    const int mat = lane >> 3, r8 = lane & 7;
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap) {
      const int dy = pa + (tap >> 1), dx = pb + (tap & 1);
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int p = (2 * wm + mi + dy) * kHaloW + (lane & 15) + dx;
        ldmatrix_x4(af[mi], sA + p * kLdA + (lane >> 4) * 8);
      }
      const bf16* bt_ = sB + tap * kKC * kLdB + ((mat & 1) * 8 + r8) * kLdB +
                        wn * 32 + (mat >> 1) * 8;
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        if (n_warp + np * 16 >= Cout) break;   // warp-uniform
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, bt_ + np * 16);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_16816(acc[mi][2 * np], af[mi], bf[0], bf[1]);
          mma_16816(acc[mi][2 * np + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
    __syncthreads();
  }

  // epilogue: + bias, bf16 store at the high-res position of the parity
  const long long W2 = 2LL * W;
  bf16* yf = y + (long long)bt * 4 * HW * Cout;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int n = n_warp + nt * 8 + 2 * tq;
    if (n >= Cout) continue;
    const float b0 = bias[n], b1 = bias[n + 1];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int yy = y0 + 2 * wm + mi;
      if (yy >= H) continue;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int xx = x0 + g + 8 * hf;
        if (xx >= W) continue;
        const long long o = ((2LL * yy + pa) * W2 + 2LL * xx + pb) * Cout + n;
        *reinterpret_cast<uint32_t*>(yf + o) =
            pack_bf16(acc[mi][nt][2 * hf] + b0, acc[mi][nt][2 * hf + 1] + b1);
      }
    }
  }
}

}  // namespace

extern "C" const char* omni_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x [B, T, h, w, Cin] and y [B, T, 2h, 2w, Cout]: bf16, channels-last;
// w4 [2, 2, 4 * Cin, Cout] bf16; bias [Cout] fp32. Needs Cin % 16 == 0 and
// Cout % 8 == 0.
extern "C" int omni_vae_upsample_bf16(const void* x, const void* w4,
                                      const void* bias, void* y, int B, int T,
                                      int H, int W, int Cin, int Cout,
                                      void* stream) {
  if (Cin % kKC != 0 || Cout % 8 != 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || T <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tiles_h = (H + kTileH - 1) / kTileH;
  const dim3 grid(tiles_w * tiles_h, (Cout + kBN - 1) / kBN, B * T * 4);
  vae_upsample_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w4),
      static_cast<const float*>(bias), static_cast<bf16*>(y), T, H, W, Cin,
      Cout, tiles_w);
  return (int)cudaGetLastError();
}
