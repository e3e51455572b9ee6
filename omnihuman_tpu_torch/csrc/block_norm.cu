// The DiT block's residual sites in one pass: an optional gated residual
// add, then an optional LayerNorm with an affine or an AdaLN modulation,
// for Hopper (sm_90a). No tensor cores.
//
// Replaces no TPU kernel: the JAX package leaves this elementwise work
// (omnihuman_tpu/models/wan_dit.py `_block_forward`) to XLA, which fuses
// it. Eager PyTorch runs it as about twenty broadcast kernels a site, most
// over fp32 copies of the [B, L, dim] rows; this kernel reads and writes
// each row once. What it computes, per row of x [B, L, dim] (fp32 math,
// every product and sum rounded where the eager chain rounds it):
//   with y:  t  = y * gate            (gate [B, 1, dim] or a scalar; none: y)
//            t  = rd(t)               (when round_inner; rd = x's dtype)
//            x' = rd(x + t)           (written to x_out)
//   with h:  n  = (x' - mean) * 1 / sqrt(var + eps)   (two-pass statistics
//            over x' as rounded; x when there is no y)
//            n  = n * w + b           (affine, either or both)
//            n  = n * (1 + scale) + shift             (AdaLN modulation)
//            h  = n in h's dtype      (written to h_out)
// The products and sums of the row are __fmul_rn / __fadd_rn, which nvcc
// never contracts into an FMA, so x' is bit-equal to the eager chain and h
// differs from it only by the order of the two row sums.
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes. A site after an
// attention at dim 1536, 65,536 rows, reads x and y and writes x' and h in
// bf16: 805 MB, 0.24 ms; the AdaLN vectors are kilobytes and stay in L1 / L2.
// Timed back to back at 65,536 rows it reads 79-88% of that bound (dim 1536
// and 5120, every site form); a persistent grid prefetching the next row,
// 2 to 6 warps a row at dim 1536 and other block sizes timed no faster.
//
// Design:
//   - one row lives in registers from its load to its last store, in its
//     own dtype (x' in bf16 is exact in bf16; unpacked to fp32 at each of
//     the three passes over it): chunks of 8 elements, one 16-byte load or
//     store a chunk in bf16 (two in fp32), neighbouring threads on
//     neighbouring chunks (a bf16 row held in fp32 took up to 168
//     registers; packed, 72 at dim 1536 and 5120);
//   - the rows, read once, are read past L1 (ld.global.nc.L1::no_allocate)
//     and L1 is left to the vectors (gate, shift, scale, w, b) that every
//     row of a batch reads through the read-only path;
//   - the threads of a row come from dim: one warp up to dim 1536 (four
//     rows a block), a 4-warp block above it, up to dim 6144 (one row a
//     block, 40 elements a thread at 5120); each thread holds up to 6
//     chunks (dim 1536: 6 a lane; 5120: 5 of 6 a thread): 16 instances of
//     the template, covering the DiT's widths (64 to 5120);
//   - mean, then the centred variance, each by a butterfly of warp
//     shuffles (every lane ends with the same sum: fp32 addition
//     commutes) and, with 4 warps, a fixed-order sum of the warps' partials
//     in shared memory: deterministic, run to run;
//   - x' and h are new tensors: callers keep references to the old x.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

struct Params {
  const void* x;
  long long x_bs;           // elements between batches of x
  const void* y;            // null: no residual add
  long long y_bs;
  const float* gate;        // null: no gate
  long long gate_bs;
  int gate_scalar;          // one value for every element of the batch
  const float* shift;       // null: no modulation (then scale is null too)
  long long shift_bs;
  const float* scale;
  long long scale_bs;
  const void* w;            // [dim] or null
  const void* b;            // [dim] or null
  int wb_bf16;              // w and b are bf16 (else fp32)
  void* x_out;              // [rows, dim] in x's dtype; null without y
  void* h_out;              // [rows, dim] in h's dtype; null: no norm
  int round_inner;
  int rows_per_batch;       // L
  int rows;                 // B * L
  int dim;
  float eps;
};

// 16 bytes of a row that is read once: not kept in L1, which the AdaLN
// vectors and norm weights, read for every row, keep to themselves
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

__device__ __forceinline__ void unpack(const uint4& u, float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// 8 elements of a row in T, as 16-byte words: a row is held in its own
// dtype between passes (x' in bf16 is exact in bf16), which halves the
// registers a bf16 row takes
template <typename T>
struct Chunk;

template <>
struct Chunk<bf16> {
  uint4 w;
  __device__ __forceinline__ void load(const bf16* p) { w = ld_stream(p); }
  __device__ __forceinline__ void store(bf16* p) const {
    *reinterpret_cast<uint4*>(p) = w;
  }
  __device__ __forceinline__ void get(float (&v)[8]) const { unpack(w, v); }
  __device__ __forceinline__ void set(const float (&v)[8]) {
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&w);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  }
};

template <>
struct Chunk<float> {
  uint4 w[2];
  __device__ __forceinline__ void load(const float* p) {
    w[0] = ld_stream(p);
    w[1] = ld_stream(p + 4);
  }
  __device__ __forceinline__ void store(float* p) const {
    reinterpret_cast<uint4*>(p)[0] = w[0];
    reinterpret_cast<uint4*>(p)[1] = w[1];
  }
  __device__ __forceinline__ void get(float (&v)[8]) const {
    const float* f = reinterpret_cast<const float*>(w);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = f[i];
  }
  __device__ __forceinline__ void set(const float (&v)[8]) {
    float* f = reinterpret_cast<float*>(w);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = v[i];
  }
};

// 8 values of a small vector through the read-only path
__device__ __forceinline__ void ldg8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 c = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = c.x; v[5] = c.y; v[6] = c.z; v[7] = c.w;
}

__device__ __forceinline__ void ldg8(const bf16* p, float (&v)[8]) {
  unpack(__ldg(reinterpret_cast<const uint4*>(p)), v);
}

__device__ __forceinline__ void ldg8_param(const void* p, int is_bf16,
                                           int off, float (&v)[8]) {
  if (is_bf16)
    ldg8(static_cast<const bf16*>(p) + off, v);
  else
    ldg8(static_cast<const float*>(p) + off, v);
}

// v rounded to T and back (round to nearest even, as PyTorch casts)
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Rows a block of THREADS threads a row holds (blocks of 128 threads, or of
// THREADS where a row takes more)
template <int THREADS>
__host__ __device__ constexpr int rows_a_block() {
  return THREADS >= 128 ? 1 : 128 / THREADS;
}

// The sum of s over the THREADS threads of a row, the same in every one:
// a butterfly over the warp, then the row's warps' partials in a fixed
// order, after a barrier of the row's threads alone (named barrier 1 + the
// row's index in the block; a block's last rows may have left early).
template <int THREADS>
__device__ __forceinline__ float row_sum(float s, float* partial) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if constexpr (THREADS == 32) {
    return s;
  } else {
    constexpr int WARPS = THREADS / 32;
    const int warp = threadIdx.x >> 5;
    const int first = warp - warp % WARPS;
    if ((threadIdx.x & 31) == 0) partial[warp] = s;
    asm volatile("bar.sync %0, %1;" ::"r"(1 + warp / WARPS), "r"(THREADS)
                 : "memory");
    float sum = partial[first];
#pragma unroll
    for (int i = 1; i < WARPS; ++i) sum += partial[first + i];
    return sum;
  }
}

template <typename TX, typename TY, typename TH, int THREADS, int CH>
__global__ void __launch_bounds__(THREADS * rows_a_block<THREADS>())
    block_norm_kernel(const Params p) {
  static_assert(THREADS % 32 == 0 && THREADS <= 256, "whole warps a row");
  constexpr int ROWS = rows_a_block<THREADS>();
  __shared__ float partial[2][8];
  const int t = threadIdx.x % THREADS;
  const int row = blockIdx.x * ROWS + threadIdx.x / THREADS;
  if (row >= p.rows) return;
  const int bi = row / p.rows_per_batch;
  const long long li = row - (long long)bi * p.rows_per_batch;
  const int nch = p.dim >> 3;
  const long long out_off = (long long)row * p.dim;

  Chunk<TX> xc[CH];
  const TX* xr = static_cast<const TX*>(p.x) + bi * p.x_bs + li * p.dim;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int k = c * THREADS + t;
    if (k < nch) xc[c].load(xr + k * 8);
  }

  if (p.y != nullptr) {
    Chunk<TY> yc[CH];
    const TY* yr = static_cast<const TY*>(p.y) + bi * p.y_bs + li * p.dim;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int k = c * THREADS + t;
      if (k < nch) yc[c].load(yr + k * 8);
    }
    TX* xo = static_cast<TX*>(p.x_out) + out_off;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int k = c * THREADS + t;
      if (k >= nch) continue;
      float v[8], u[8], g[8];
      xc[c].get(v);
      yc[c].get(u);
      if (p.gate != nullptr) {
        const float* gp = p.gate + bi * p.gate_bs;
        if (p.gate_scalar) {
          const float g0 = __ldg(gp);
#pragma unroll
          for (int i = 0; i < 8; ++i) g[i] = g0;
        } else {
          ldg8(gp + k * 8, g);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float a = p.gate != nullptr ? __fmul_rn(u[i], g[i]) : u[i];
        if (p.round_inner) a = round_to<TX>(a);
        v[i] = round_to<TX>(__fadd_rn(v[i], a));
      }
      xc[c].set(v);
      xc[c].store(xo + k * 8);
    }
  }
  if (p.h_out == nullptr) return;

  float s = 0.f;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    if (c * THREADS + t < nch) {
      float v[8];
      xc[c].get(v);
#pragma unroll
      for (int i = 0; i < 8; ++i) s += v[i];
    }
  }
  const float inv_dim = 1.0f / (float)p.dim;
  const float mean = __fmul_rn(row_sum<THREADS>(s, partial[0]), inv_dim);
  float q = 0.f;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    if (c * THREADS + t < nch) {
      float v[8];
      xc[c].get(v);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float d = __fsub_rn(v[i], mean);
        q = __fadd_rn(q, __fmul_rn(d, d));
      }
    }
  }
  const float var = __fmul_rn(row_sum<THREADS>(q, partial[1]), inv_dim);
  const float rstd = __frcp_rn(__fsqrt_rn(__fadd_rn(var, p.eps)));

  TH* ho = static_cast<TH*>(p.h_out) + out_off;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int k = c * THREADS + t;
    if (k >= nch) continue;
    float n[8];
    xc[c].get(n);
#pragma unroll
    for (int i = 0; i < 8; ++i) n[i] = __fmul_rn(__fsub_rn(n[i], mean), rstd);
    if (p.w != nullptr) {
      float w[8];
      ldg8_param(p.w, p.wb_bf16, k * 8, w);
#pragma unroll
      for (int i = 0; i < 8; ++i) n[i] = __fmul_rn(n[i], w[i]);
    }
    if (p.b != nullptr) {
      float b[8];
      ldg8_param(p.b, p.wb_bf16, k * 8, b);
#pragma unroll
      for (int i = 0; i < 8; ++i) n[i] = __fadd_rn(n[i], b[i]);
    }
    if (p.scale != nullptr) {
      float sc[8], sh[8];
      ldg8(p.scale + bi * p.scale_bs + k * 8, sc);
      ldg8(p.shift + bi * p.shift_bs + k * 8, sh);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        n[i] = __fadd_rn(__fmul_rn(n[i], __fadd_rn(1.0f, sc[i])), sh[i]);
    }
    Chunk<TH> hc;
    hc.set(n);
    hc.store(ho + k * 8);
  }
}

template <typename TX, typename TY, typename TH, int THREADS, int CH>
int launch(const Params& p, cudaStream_t s) {
  constexpr int ROWS = rows_a_block<THREADS>();
  const int grid = (p.rows + ROWS - 1) / ROWS;
  block_norm_kernel<TX, TY, TH, THREADS, CH><<<grid, THREADS * ROWS, 0, s>>>(p);
  return (int)cudaGetLastError();
}

// The threads of a row and the chunks each holds, from dim alone.
template <typename TX, typename TY, typename TH>
int launch_dim(const Params& p, cudaStream_t s) {
  if (p.dim <= 32 * 6 * 8) return launch<TX, TY, TH, 32, 6>(p, s);
  return launch<TX, TY, TH, 128, 6>(p, s);
}

template <typename TX, typename TY>
int launch_h(const Params& p, int h_bf16, cudaStream_t s) {
  return h_bf16 ? launch_dim<TX, TY, bf16>(p, s)
                : launch_dim<TX, TY, float>(p, s);
}

template <typename TX>
int launch_y(const Params& p, int y_bf16, int h_bf16, cudaStream_t s) {
  return y_bf16 ? launch_h<TX, bf16>(p, h_bf16, s)
                : launch_h<TX, float>(p, h_bf16, s);
}

}  // namespace

extern "C" const char* omni_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x [B, L, dim] with rows packed in each batch (x_bs elements between
// batches), y likewise (or null); gate / shift / scale fp32, [dim] at
// batch stride *_bs (gate_scalar: one value a batch; null: none); w, b
// [dim] (bf16 when wb_bf16, else fp32; null: none); x_out [B, L, dim]
// in x's dtype (null without y); h_out [B, L, dim] in h's dtype (null:
// no norm). Every pointer 16-byte aligned; dim % 8 == 0, dim <= 6144.
// *_bf16: the tensor is bf16, else fp32.
extern "C" int omni_block_norm(
    const void* x, long long x_bs, const void* y, long long y_bs,
    const void* gate, long long gate_bs, int gate_scalar, const void* shift,
    long long shift_bs, const void* scale, long long scale_bs, const void* w,
    const void* b, int wb_bf16, void* x_out, void* h_out, int round_inner,
    int rows_per_batch, int rows, int dim, float eps, int x_bf16, int y_bf16,
    int h_bf16, void* stream) {
  if (dim <= 0 || dim % 8 != 0 || dim > 6144 || rows_per_batch <= 0)
    return (int)cudaErrorInvalidValue;
  if ((y == nullptr) != (x_out == nullptr) || (shift == nullptr) != (scale == nullptr))
    return (int)cudaErrorInvalidValue;
  if (rows <= 0 || (y == nullptr && h_out == nullptr)) return (int)cudaSuccess;
  Params p;
  p.x = x;
  p.x_bs = x_bs;
  p.y = y;
  p.y_bs = y_bs;
  p.gate = static_cast<const float*>(gate);
  p.gate_bs = gate_bs;
  p.gate_scalar = gate_scalar;
  p.shift = static_cast<const float*>(shift);
  p.shift_bs = shift_bs;
  p.scale = static_cast<const float*>(scale);
  p.scale_bs = scale_bs;
  p.w = w;
  p.b = b;
  p.wb_bf16 = wb_bf16;
  p.x_out = x_out;
  p.h_out = h_out;
  p.round_inner = round_inner;
  p.rows_per_batch = rows_per_batch;
  p.rows = rows;
  p.dim = dim;
  p.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_y<bf16>(p, y_bf16, h_bf16, s)
                : launch_y<float>(p, y_bf16, h_bf16, s);
}
