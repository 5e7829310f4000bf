// Block int8 quantization kernels for Hopper (sm_90a), the hot ops of the
// int8 all-reduce codecs.
//
// Replaces the Pallas kernels of autodist_tpu/ops/pallas/quantize.py:
//   quantize_int8 <- quantize_int8 (pallas_call at :41, kernel _quant_kernel)
//   dequant_sum   <- dequant_sum   (pallas_call at :65, kernel _dequant_sum_kernel)
//   equarx_hop    <- equarx_hop    (pallas_call at :98, kernel _equarx_hop_kernel)
//
// Over blocks of 256 f32 elements, each with one f32 scale:
//   quantize:  s = absmax / 127 (0 -> 1),  q = clip(round(x / s), -127, 127)
//   dequant_sum over D peers:  out = sum_{d = 0..D-1} q[d] * s[d]       (f32)
//   equarx_hop:  quantize(dequant_sum(q, s) / n_dev), in one pass
//
// The results are held bitwise against the plain PyTorch versions in
// autodist_tpu_torch/ops/quantize.py, so the arithmetic is pinned:
//   - both divisions are IEEE divisions (__fdiv_rn; no fast math), where
//     a multiply by the reciprocal could differ in the last bit;
//   - round is rintf, half to even as jnp.round and torch.round (roundf
//     rounds half away from zero);
//   - the peer sum runs in order d = 0..D-1 with separate __fmul_rn and
//     __fadd_rn, so nvcc cannot contract it into an FMA;
//   - the abs-max propagates NaN as jnp.max does (fmaxf would drop it):
//     it is taken over the bit patterns of |x|, which order as the values
//     do for x >= 0 and put every NaN above +inf.  A NaN block's scale is
//     NaN and its q is 0 (the value a NaN converts to).
//
// Bound on an H100 SXM: memory.  Per element the kernels move
//   quantize_int8: 4 + 1 + 4/256 bytes,
//   dequant_sum:   D * (1 + 4/256) + 4 bytes,
//   equarx_hop:    (D + 1) * (1 + 4/256) bytes,
// against a handful of f32 operations, so the bound is bytes / 3.35 TB/s
// (GPT-2 small's first gradient bucket, 286,110 blocks: 0.110 ms for
// quantize_int8 and for dequant_sum at D = 1, 0.044 ms for equarx_hop).
//
// Design.  The TPU kernels walk a grid of 128-row tiles (ROWS), so the
// caller pads to a multiple of 128 blocks.  Here one warp owns one block
// of 256 elements and a CUDA block holds kWarps warps, so any number of
// blocks N >= 1 runs.  Lane l owns elements 4l..4l+3 and 128+4l..128+4l+3:
// f32 moves as 16-byte vectors and int8 as 4-byte words, each warp access
// a contiguous 512 or 128 bytes.  The abs-max is one warp reduction
// (__reduce_max_sync on the bit patterns); nothing goes through shared
// memory and no block waits on another.
//
// Launch: one C entry point per kernel, on the caller's stream; returns
// cudaGetLastError() (0 = success).  The caller allocates the outputs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;   // elements per scale (BLOCK)
constexpr int kWarps = 8;     // quantization blocks per CUDA block, one warp each
constexpr int kThreads = 32 * kWarps;

// |v| as its bit pattern: for non-negative floats the unsigned order is the
// value order, and NaN patterns lie above +inf, so max() propagates NaN.
__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

__device__ __forceinline__ unsigned max8(const float (&v)[8]) {
  unsigned m = abs_bits(v[0]);
#pragma unroll
  for (int i = 1; i < 8; ++i) m = max(m, abs_bits(v[i]));
  return m;
}

// The block's scale from each lane's abs-max: absmax / 127, a zero scale
// becoming 1 (an all-zero block quantizes to 0 with scale 1).
__device__ __forceinline__ float block_scale(unsigned lane_max) {
  const unsigned m = __reduce_max_sync(0xffffffffu, lane_max);
  const float s = __fdiv_rn(__uint_as_float(m), 127.0f);
  return s == 0.0f ? 1.0f : s;
}

__device__ __forceinline__ unsigned quantize4(const float* v, float s) {
  unsigned word = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float t = __fdiv_rn(v[i], s);
    int q = 0;
    if (t == t) q = __float2int_rn(fminf(fmaxf(rintf(t), -127.0f), 127.0f));
    word |= (static_cast<unsigned>(q) & 0xffu) << (8 * i);
  }
  return word;
}

__device__ __forceinline__ void store_q(int8_t* q, long long row, int lane,
                                        const float (&v)[8], float s) {
  unsigned* qr = reinterpret_cast<unsigned*>(q + row * kBlock);
  qr[lane] = quantize4(v, s);
  qr[32 + lane] = quantize4(v + 4, s);
}

// byte i of a word as a signed value
__device__ __forceinline__ float byte_f32(unsigned word, int i) {
  return static_cast<float>(static_cast<int>(word << (24 - 8 * i)) >> 24);
}

// acc = sum over d of q[d, row] * s[d, row], d in order, no FMA
__device__ __forceinline__ void peer_sum(const int8_t* __restrict__ q,
                                         const float* __restrict__ s, int D,
                                         long long n, long long row, int lane,
                                         float (&acc)[8]) {
  for (int d = 0; d < D; ++d) {
    const long long r = static_cast<long long>(d) * n + row;
    const unsigned* qr = reinterpret_cast<const unsigned*>(q + r * kBlock);
    const unsigned lo = qr[lane], hi = qr[32 + lane];
    const float sc = s[r];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = __fmul_rn(byte_f32(lo, i), sc);
      const float b = __fmul_rn(byte_f32(hi, i), sc);
      acc[i] = d == 0 ? a : __fadd_rn(acc[i], a);
      acc[4 + i] = d == 0 ? b : __fadd_rn(acc[4 + i], b);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ s, long long n) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;   // the whole warp leaves together
  const float4* xr = reinterpret_cast<const float4*>(x + row * kBlock);
  const float4 a = xr[lane], b = xr[32 + lane];
  const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const float sc = block_scale(max8(v));
  store_q(q, row, lane, v, sc);
  if (lane == 0) s[row] = sc;
}

__global__ void __launch_bounds__(kThreads)
dequant_sum_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                   float* __restrict__ out, int D, long long n) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;
  float acc[8] = {};
  peer_sum(q, s, D, n, row, lane, acc);
  float4* o = reinterpret_cast<float4*>(out + row * kBlock);
  o[lane] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  o[32 + lane] = make_float4(acc[4], acc[5], acc[6], acc[7]);
}

__global__ void __launch_bounds__(kThreads)
equarx_hop_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                  int8_t* __restrict__ qo, float* __restrict__ so, int D,
                  long long n, float n_dev) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;
  float acc[8] = {};
  peer_sum(q, s, D, n, row, lane, acc);
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = __fdiv_rn(acc[i], n_dev);   // the peer mean
  const float sc = block_scale(max8(acc));
  store_q(qo, row, lane, acc, sc);
  if (lane == 0) so[row] = sc;
}

unsigned grid_for(long long n) {
  return static_cast<unsigned>((n + kWarps - 1) / kWarps);
}

}  // namespace

// x (n, 256) f32 -> q (n, 256) int8, s (n,) f32.
extern "C" int quantize_int8(const float* x, int8_t* q, float* s, long long n,
                             void* stream) {
  quantize_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, q, s, n);
  return static_cast<int>(cudaGetLastError());
}

// q (D, n, 256) int8, s (D, n) f32 -> out (n, 256) f32.
extern "C" int dequant_sum(const int8_t* q, const float* s, float* out, int D,
                           long long n, void* stream) {
  dequant_sum_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, s, out, D, n);
  return static_cast<int>(cudaGetLastError());
}

// q (D, n, 256) int8, s (D, n) f32 -> qo (n, 256) int8, so (n,) f32.
extern "C" int equarx_hop(const int8_t* q, const float* s, int8_t* qo, float* so,
                          int D, long long n, float n_dev, void* stream) {
  equarx_hop_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, s, qo, so, D, n, n_dev);
  return static_cast<int>(cudaGetLastError());
}
