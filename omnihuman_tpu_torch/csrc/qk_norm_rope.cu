// The DiT attention's q / k RMSNorm and 3D RoPE rotation in one pass, for
// Hopper (sm_90a). No tensor cores.
//
// Replaces no TPU kernel: the JAX package leaves this elementwise work
// (omnihuman_tpu/models/wan_dit.py `_self_attention`, `_cross_attention`)
// to XLA, which fuses it. Eager PyTorch runs `rms_norm` (ops/norms.py) and
// `apply_rope` (ops/rope.py) as about twenty kernels over fp32 copies of
// q and of k, several of them strided; this kernel reads and writes each
// row once. What it computes, per row x of q [B, Lq, dim] and of k
// [B, Lk, dim] (fp32 math, every product and sum rounded where the eager
// chain rounds it; rd = the row's dtype):
//   r  = 1 / sqrt(sum(x * x) / dim + eps)     (over the whole row)
//   y  = rd(x * r * w)                        (w: norm_q or norm_k)
//   with tables sin / cos [Lq, head_dim / 2] (row l of each batch):
//   out[2j]     = rd(y[2j] * c - y[2j+1] * s)  (c, s: the row's entry at
//   out[2j + 1] = rd(y[2j+1] * c + y[2j] * s)   j mod head_dim / 2)
//   else out = y.
// The products and sums are __fmul_rn / __fadd_rn, which nvcc never
// contracts into an FMA, so the result differs from the eager chain only
// by the order of the row's sum of squares: y within one step of its dtype,
// and the rotation of a y exactly the eager one's. Padded rows carry the
// identity rotation (s = 0, c = 1) and pass through it unchanged.
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes. A t2v-1.3B
// self-attention (B = 2, 32,768 rows, dim 1536, bf16) reads q and k and
// writes them once, 805 MB, and reads 16.8 MB of tables: 0.245 ms.
//
// Design:
//   - one row lives in registers from its load to its store, in its own
//     dtype: chunks of 8 elements (4 rotation pairs, never split across a
//     head: head_dim % 8 == 0), one 16-byte load or store a chunk in bf16,
//     two in fp32, neighbouring threads on neighbouring chunks; the rows,
//     read once, are read past L1 (ld.global.nc.L1::no_allocate);
//   - with k of q's shape (the self-attention), the rows are taken in
//     turn, q row i then k row i, so the two read one table row at once
//     and the second read comes from L1 / L2; without tables and at other
//     lengths (a cross-attention: q against a short context), every q row,
//     then every k row;
//   - head_dim divides 256 (128 in every Wan model), and so a row's 256 or
//     2048 elements a pass of its threads: every chunk of a thread sits at
//     the same place in its head, and the thread loads its 4 pairs' sin and
//     cos once a row, before the row's sum (a load a chunk held the
//     self-attention form at 74% of its bound at dim 1536);
//   - the threads of a row come from dim: one warp up to dim 1536 (four
//     rows a 128-thread block, 6 chunks a lane), an 8-warp block above it,
//     up to dim 6144 (3 chunks a thread; at 5120 a 4-warp block with 5
//     chunks a thread read 64.5% of the self-attention form's bound, 8
//     warps 81.3%; 2 warps a row at 1536 read 63%; a register cap of 64
//     or 40 (launch bounds) spilled and ran slower);
//   - the sum of squares by a butterfly of warp shuffles and, with several
//     warps, a fixed-order sum of the warps' partials in shared memory:
//     deterministic, run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

struct Params {
  const void* q;            // [B, Lq, dim], rows packed in each batch
  long long q_bs;           // elements between batches of q
  const void* k;            // [B, Lk, dim] or null
  long long k_bs;
  const void* wq;           // [dim]
  const void* wk;           // [dim] (null without k)
  int wq_bf16, wk_bf16;     // the weights are bf16 (else fp32)
  const float* sin;         // [Lq, head_dim / 2] or null: no rotation
  const float* cos;
  void* q_out;              // [B, Lq, dim], q's dtype
  void* k_out;              // [B, Lk, dim] (null without k)
  int lq, lk;               // rows a batch
  int q_rows, k_rows;       // B * Lq, B * Lk
  int interleave;           // q row i, then k row i (k of q's shape)
  int dim;
  int head_dim;
  float eps;
};

// 16 bytes of a row that is read once: not kept in L1
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

// 8 elements of a row in T, as 16-byte words
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

// 8 values of a norm weight (bf16 or fp32) through the read-only path
__device__ __forceinline__ void ldg8_weight(const void* p, int is_bf16,
                                            int off, float (&v)[8]) {
  if (is_bf16) {
    unpack(__ldg(reinterpret_cast<const uint4*>(
               static_cast<const bf16*>(p) + off)), v);
  } else {
    const float4* f = reinterpret_cast<const float4*>(
        static_cast<const float*>(p) + off);
    const float4 a = __ldg(f), c = __ldg(f + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = c.x; v[5] = c.y; v[6] = c.z; v[7] = c.w;
  }
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

template <typename T, int THREADS, int CH>
__global__ void __launch_bounds__(THREADS * rows_a_block<THREADS>())
    qk_norm_rope_kernel(const Params p) {
  static_assert(THREADS % 32 == 0 && THREADS <= 256, "whole warps a row");
  constexpr int ROWS = rows_a_block<THREADS>();
  __shared__ float partial[8];
  const int t = threadIdx.x % THREADS;
  const int item = blockIdx.x * ROWS + threadIdx.x / THREADS;

  // which tensor and which of its rows this item is
  int is_k, row;
  if (p.interleave) {
    is_k = item & 1;
    row = item >> 1;
  } else {
    is_k = item >= p.q_rows;
    row = is_k ? item - p.q_rows : item;
  }
  if (row >= (is_k ? p.k_rows : p.q_rows)) return;
  const int l = is_k ? p.lk : p.lq;
  const int bi = row / l;
  const int li = row - bi * l;
  const T* src = static_cast<const T*>(is_k ? p.k : p.q) +
                 bi * (is_k ? p.k_bs : p.q_bs) + (long long)li * p.dim;
  T* dst = static_cast<T*>(is_k ? p.k_out : p.q_out) +
           (long long)row * p.dim;
  const void* w = is_k ? p.wk : p.wq;
  const int w_bf16 = is_k ? p.wk_bf16 : p.wq_bf16;
  const int nch = p.dim >> 3;

  Chunk<T> xc[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int k = c * THREADS + t;
    if (k < nch) xc[c].load(src + k * 8);
  }

  // the tables: head_dim divides 256, so every chunk of a thread sits at
  // the same place in its head and rotates by the same 4 pairs: one load of
  // their sin and cos a row, issued before the row's sum
  const bool rotate = p.sin != nullptr;
  float4 sn = make_float4(0.f, 0.f, 0.f, 0.f), cs = sn;
  if (rotate) {
    const long long at = (long long)li * (p.head_dim >> 1) +
                         (((t * 8) % p.head_dim) >> 1);
    sn = __ldg(reinterpret_cast<const float4*>(p.sin + at));
    cs = __ldg(reinterpret_cast<const float4*>(p.cos + at));
  }
  const float sv[4] = {sn.x, sn.y, sn.z, sn.w};
  const float cv[4] = {cs.x, cs.y, cs.z, cs.w};

  float s = 0.f;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    if (c * THREADS + t < nch) {
      float v[8];
      xc[c].get(v);
#pragma unroll
      for (int i = 0; i < 8; ++i) s = __fadd_rn(s, __fmul_rn(v[i], v[i]));
    }
  }
  const float ms = __fmul_rn(row_sum<THREADS>(s, partial),
                             1.0f / (float)p.dim);
  const float r = __frcp_rn(__fsqrt_rn(__fadd_rn(ms, p.eps)));

#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int k = c * THREADS + t;
    if (k >= nch) continue;
    float v[8], wv[8];
    xc[c].get(v);
    ldg8_weight(w, w_bf16, k * 8, wv);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = round_to<T>(__fmul_rn(__fmul_rn(v[i], r), wv[i]));
    if (rotate) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = v[2 * i], b = v[2 * i + 1];
        v[2 * i] = round_to<T>(
            __fsub_rn(__fmul_rn(a, cv[i]), __fmul_rn(b, sv[i])));
        v[2 * i + 1] = round_to<T>(
            __fadd_rn(__fmul_rn(b, cv[i]), __fmul_rn(a, sv[i])));
      }
    }
    xc[c].set(v);
    xc[c].store(dst + k * 8);
  }
}

template <typename T, int THREADS, int CH>
int launch(const Params& p, cudaStream_t s) {
  constexpr int ROWS = rows_a_block<THREADS>();
  const long long items = (long long)p.q_rows + p.k_rows;
  const long long grid = (items + ROWS - 1) / ROWS;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  qk_norm_rope_kernel<T, THREADS, CH><<<(unsigned)grid, THREADS * ROWS, 0, s>>>(p);
  return (int)cudaGetLastError();
}

// The threads of a row and the chunks each holds, from dim alone.
template <typename T>
int launch_dim(const Params& p, cudaStream_t s) {
  if (p.dim <= 32 * 6 * 8) return launch<T, 32, 6>(p, s);
  return launch<T, 256, 3>(p, s);
}

}  // namespace

extern "C" const char* omni_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q [B, lq, dim] with rows packed in each batch (q_bs elements between
// batches), k [B, lk, dim] likewise or null; wq, wk [dim] (bf16 when
// *_bf16, else fp32; wk null without k); sin, cos fp32 [lq, head_dim / 2]
// packed, or both null; q_out, k_out [B, l, dim] packed, in the rows'
// dtype (bf16 when rows_bf16, else fp32). Every pointer 16-byte aligned;
// dim % 8 == 0, dim <= 6144; with tables head_dim a multiple of 8 that
// divides 256 and dim, and, with k, lk == lq.
extern "C" int omni_qk_norm_rope(
    const void* q, long long q_bs, const void* k, long long k_bs,
    const void* wq, const void* wk, int wq_bf16, int wk_bf16,
    const void* sin, const void* cos, void* q_out, void* k_out, int batch,
    int lq, int lk, int dim, int head_dim, float eps, int rows_bf16,
    void* stream) {
  if (dim <= 0 || dim % 8 != 0 || dim > 6144 || batch < 0 || lq < 0 ||
      lk < 0)
    return (int)cudaErrorInvalidValue;
  if ((k == nullptr) != (k_out == nullptr) ||
      (k != nullptr) != (wk != nullptr) || (sin == nullptr) != (cos == nullptr))
    return (int)cudaErrorInvalidValue;
  if (sin != nullptr && (head_dim <= 0 || head_dim % 8 != 0 ||
                         256 % head_dim != 0 || dim % head_dim != 0 ||
                         (k != nullptr && lk != lq)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.q_bs = q_bs;
  p.k = k;
  p.k_bs = k_bs;
  p.wq = wq;
  p.wk = wk;
  p.wq_bf16 = wq_bf16;
  p.wk_bf16 = wk_bf16;
  p.sin = static_cast<const float*>(sin);
  p.cos = static_cast<const float*>(cos);
  p.q_out = q_out;
  p.k_out = k_out;
  p.lq = lq;
  p.lk = k != nullptr ? lk : 0;
  p.q_rows = batch * lq;
  p.k_rows = batch * p.lk;
  p.interleave = k != nullptr && lk == lq;
  p.dim = dim;
  p.head_dim = sin != nullptr ? head_dim : 8;
  p.eps = eps;
  if (p.q_rows + p.k_rows == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return rows_bf16 ? launch_dim<bf16>(p, s) : launch_dim<float>(p, s);
}
