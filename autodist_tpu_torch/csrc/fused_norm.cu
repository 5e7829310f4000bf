// Fused batch norm and group norm forward for Hopper (sm_90a).
//
// Replaces the Pallas kernels of autodist_tpu/ops/pallas/fused_norm.py:
//   bn_fwd  <- _bn_forward (pallas_call at :112, kernel _bn_fwd_kernel)
//   gn_fwd  <- _gn_forward (pallas_call at :262, kernel _gn_fwd_kernel)
//
// Both compute, over a channels-last activation x viewed as (S, rows, C)
// and statistics groups of C/G adjacent channels per sample,
//   mean = sum(x) / n,  var = max(sum(x^2) / n - mean^2, 0)   (f32),
//   y    = (x - mean) * (rsqrt(var + eps) * scale[c]) + bias[c]
//          (+ residual) (relu), rounded once to x's type,
// with n = rows * C/G.  Batch norm is the instance S = 1, G = C (one group
// per channel, statistics over every row); group norm is S = batch.
//
// Bound on an H100 SXM: memory.  The least traffic is one read of x (and
// of the residual) and one write of y; the arithmetic is ~6 f32 operations
// per element, far below the 67 TFLOP/s f32 rate, so the bound is
// bytes / 3.35 TB/s (ResNet-50 stem site, bf16 (256, 112, 112, 64):
// 822 MB, 0.245 ms).
//
// Design.  The TPU kernel holds a whole (rows, 128) slab in VMEM, reads it
// once and needs MAX_FUSED_ROWS to bound the slab.  A Hopper block has at
// most 227 KB of shared memory, and blocks run in parallel in no order, so
// the reduction is split over row chunks and finished in a second pass:
//   1. norm_partial_kernel: grid (row chunk, channel block, sample).  Each
//      thread owns VEC adjacent channels (16-byte loads: 8 bf16 or 4 f32;
//      adjacent threads on adjacent channels) and strides over the chunk's
//      rows, summing x and x^2 in f32; the block combines its rows through
//      shared memory in a fixed order and writes one f32 partial per
//      (sample, chunk, channel).
//   2. norm_stats_kernel: one block per (sample, group); its threads split
//      the group's (chunk, channel) partials, add them in double and combine
//      them in a fixed-shape tree, then write mean, var and
//      inv = rsqrt(var + eps).  A whole block per group, because one thread
//      walking all of a batch-norm channel's chunks (1056 at the stem) is
//      latency-bound: it took longer than passes 1 and 3 together.
//   3. norm_apply_kernel: the grid of pass 1 again; each thread keeps its
//      channels' mean, inv * scale and bias in registers and writes y.
// No atomics anywhere, so two runs give the same bits.  Any rows and any C
// run (the ragged channel block is masked; a C or pointer that does not
// allow 16-byte vectors takes VEC = 1); there is no row limit.  The cost:
// x is read twice (passes 1 and 3), so the design moves 1.5x the bound's
// bytes for bf16 without a residual.
//
// Launch: one C entry point per kernel, on the caller's stream; returns the
// first cudaGetLastError() of its three launches (0 = success).  The caller
// allocates y, mean, var, inv and the partials (2 * S * chunks * C f32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype(bfloat16)
}

// VEC adjacent elements, loaded and stored as one 16-byte (or narrower) access
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// Pass 1: per-(sample, chunk, channel) f32 partial sums of x and x^2.
// Block (TX, TY): TX threads across channel vectors, TY across rows.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
norm_partial_kernel(const T* __restrict__ x, float* __restrict__ psum,
                    float* __restrict__ psq, long long rows, int C, int chunks,
                    long long rows_per_chunk) {
  __shared__ float red_sum[kThreads * VEC];
  __shared__ float red_sq[kThreads * VEC];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int TX = blockDim.x, TY = blockDim.y;
  const int chunk = blockIdx.x, s = blockIdx.z;
  const int nvec = C / VEC;
  const int v = blockIdx.y * TX + tx;
  const long long r0 = (long long)chunk * rows_per_chunk;
  const long long r1 = min(rows, r0 + rows_per_chunk);

  float sum[VEC], sq[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) sum[j] = sq[j] = 0.f;
  if (v < nvec) {
    const T* base = x + (long long)s * rows * C + (long long)v * VEC;
    for (long long r = r0 + ty; r < r1; r += TY) {
      const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(base + r * C);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float f = to_f32(p.v[j]);
        sum[j] += f;
        sq[j] = fmaf(f, f, sq[j]);
      }
    }
  }
  const int width = TX * VEC;  // channels of this block, <= kThreads
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    red_sum[ty * width + tx * VEC + j] = sum[j];
    red_sq[ty * width + tx * VEC + j] = sq[j];
  }
  __syncthreads();
  const int t = ty * TX + tx;
  if (t < width) {
    float a = 0.f, b = 0.f;
    for (int yy = 0; yy < TY; ++yy) {  // fixed order: same bits every run
      a += red_sum[yy * width + t];
      b += red_sq[yy * width + t];
    }
    const int c = blockIdx.y * width + t;
    if (c < C) {
      const size_t o = ((size_t)s * chunks + chunk) * C + c;
      psum[o] = a;
      psq[o] = b;
    }
  }
}

// Pass 2: one block per (sample, group): mean, var, inv.
__global__ void __launch_bounds__(kThreads)
norm_stats_kernel(const float* __restrict__ psum, const float* __restrict__ psq,
                  float* __restrict__ mean, float* __restrict__ var,
                  float* __restrict__ inv, int C, int G, int chunks, float n,
                  float eps) {
  __shared__ double red_a[kThreads];
  __shared__ double red_b[kThreads];
  const int i = blockIdx.x, tid = threadIdx.x;
  const int s = i / G, g = i % G, cpg = C / G;
  double a = 0.0, b = 0.0;
  for (int t = tid; t < chunks * cpg; t += kThreads) {
    const size_t o = ((size_t)s * chunks + t / cpg) * C + (size_t)g * cpg + t % cpg;
    a += psum[o];
    b += psq[o];
  }
  red_a[tid] = a;
  red_b[tid] = b;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {  // fixed shape: same bits every run
    if (tid < w) {
      red_a[tid] += red_a[tid + w];
      red_b[tid] += red_b[tid + w];
    }
    __syncthreads();
  }
  if (tid == 0) {
    const float m = (float)red_a[0] / n;
    const float v = fmaxf((float)red_b[0] / n - m * m, 0.f);
    mean[i] = m;
    var[i] = v;
    inv[i] = rsqrtf(v + eps);
  }
}

// Pass 3: y = (x - mean) * (inv * scale) + bias (+ residual) (relu).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
norm_apply_kernel(const T* __restrict__ x, const T* __restrict__ res,
                  T* __restrict__ y, const float* __restrict__ mean,
                  const float* __restrict__ inv, const float* __restrict__ scale,
                  const float* __restrict__ bias, long long rows, int C, int G,
                  long long rows_per_chunk, int relu) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int TX = blockDim.x, TY = blockDim.y;
  const int chunk = blockIdx.x, s = blockIdx.z;
  const int v = blockIdx.y * TX + tx;
  if (v >= C / VEC) return;
  const int cpg = C / G;
  float m[VEC], a[VEC], b[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int c = v * VEC + j;
    const int st = s * G + c / cpg;
    m[j] = mean[st];
    a[j] = inv[st] * scale[c];
    b[j] = bias[c];
  }
  const long long r0 = (long long)chunk * rows_per_chunk;
  const long long r1 = min(rows, r0 + rows_per_chunk);
  const long long off = (long long)s * rows * C + (long long)v * VEC;
  for (long long r = r0 + ty; r < r1; r += TY) {
    const long long o = off + r * C;
    const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(x + o);
    Pack<T, VEC> q;
    if (res != nullptr) q = *reinterpret_cast<const Pack<T, VEC>*>(res + o);
    Pack<T, VEC> out;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float f = (to_f32(p.v[j]) - m[j]) * a[j] + b[j];
      if (res != nullptr) f += to_f32(q.v[j]);
      if (relu) f = fmaxf(f, 0.f);
      out.v[j] = from_f32<T>(f);
    }
    *reinterpret_cast<Pack<T, VEC>*>(y + o) = out;
  }
}

template <typename T, int VEC>
int launch_norm(const void* x, const float* scale, const float* bias,
                const void* res, void* y, float* partial, float* mean, float* var,
                float* inv, int S, long long rows, int C, int G, int chunks,
                float eps, int relu, cudaStream_t stream) {
  const int nvec = C / VEC;
  int tx = 1;
  while (tx < nvec && tx < 32) tx <<= 1;
  const dim3 block(tx, kThreads / tx);
  const dim3 grid(chunks, (nvec + tx - 1) / tx, S);
  const long long rpc = (rows + chunks - 1) / chunks;
  float* psum = partial;
  float* psq = partial + (size_t)S * chunks * C;
  norm_partial_kernel<T, VEC><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), psum, psq, rows, C, chunks, rpc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  norm_stats_kernel<<<S * G, kThreads, 0, stream>>>(
      psum, psq, mean, var, inv, C, G, chunks, (float)((double)rows * (C / G)), eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  norm_apply_kernel<T, VEC><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), static_cast<T*>(y),
      mean, inv, scale, bias, rows, C, G, rpc, relu);
  return (int)cudaGetLastError();
}

int norm_fwd(const void* x, const float* scale, const float* bias, const void* res,
             void* y, float* partial, float* mean, float* var, float* inv, int S,
             long long rows, int C, int G, int chunks, float eps, int relu,
             int is_bf16, void* stream) {
  const uintptr_t addr = (uintptr_t)x | (uintptr_t)y | (uintptr_t)res;
  const bool aligned = addr % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (aligned && C % 8 == 0)
      return launch_norm<__nv_bfloat16, 8>(x, scale, bias, res, y, partial, mean,
                                           var, inv, S, rows, C, G, chunks, eps,
                                           relu, st);
    return launch_norm<__nv_bfloat16, 1>(x, scale, bias, res, y, partial, mean, var,
                                         inv, S, rows, C, G, chunks, eps, relu, st);
  }
  if (aligned && C % 4 == 0)
    return launch_norm<float, 4>(x, scale, bias, res, y, partial, mean, var, inv, S,
                                 rows, C, G, chunks, eps, relu, st);
  return launch_norm<float, 1>(x, scale, bias, res, y, partial, mean, var, inv, S,
                               rows, C, G, chunks, eps, relu, st);
}

}  // namespace

// Training batch norm over x (rows, C): y, and mean/var (C,) f32.
extern "C" int bn_fwd(const void* x, const float* scale, const float* bias,
                      const void* res, void* y, float* partial, float* mean,
                      float* var, float* inv, long long rows, int C, int chunks,
                      float eps, int relu, int is_bf16, void* stream) {
  return norm_fwd(x, scale, bias, res, y, partial, mean, var, inv, 1, rows, C, C,
                  chunks, eps, relu, is_bf16, stream);
}

// Group norm over x (S, rows, C) with G groups; mean/var/inv are (S, G)
// scratch.
extern "C" int gn_fwd(const void* x, const float* scale, const float* bias,
                      const void* res, void* y, float* partial, float* mean,
                      float* var, float* inv, int S, long long rows, int C, int G,
                      int chunks, float eps, int relu, int is_bf16, void* stream) {
  return norm_fwd(x, scale, bias, res, y, partial, mean, var, inv, S, rows, C, G,
                  chunks, eps, relu, is_bf16, stream);
}
