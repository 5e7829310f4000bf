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
//   - both divisions give the IEEE quotient (no fast math), where a
//     multiply by a rounded reciprocal could differ in the last bit;
//   - round is half to even, as jnp.round and torch.round (roundf rounds
//     half away from zero);
//   - the peer sum runs in order d = 0..D-1 with separate __fmul_rn and
//     __fadd_rn, so nvcc cannot contract it into an FMA;
//   - the abs-max propagates NaN as jnp.max does (fmaxf would drop it).
//     A NaN block's scale is NaN and its q is 0 (the value a NaN converts to).
//
// Bound on an H100 SXM: memory.  Per element the kernels move
//   quantize_int8: 4 + 1 + 4/256 bytes,
//   dequant_sum:   D * (1 + 4/256) + 4 bytes,
//   equarx_hop:    (D + 1) * (1 + 4/256) bytes,
// against a handful of f32 operations, so the bound is bytes / 3.35 TB/s
// (GPT-2 small's first gradient bucket, 286,110 blocks: 0.110 ms for
// quantize_int8 and for dequant_sum at D = 1, 0.044 ms for equarx_hop).
//
// quantize_int8 and dequant_sum.  The TPU kernels walk a grid of 128-row
// tiles (ROWS), so the caller pads to a multiple of 128 blocks.  Here one
// warp owns one block of 256 elements and a CUDA block holds kWarps warps,
// so any number of blocks N >= 1 runs.  Lane l owns elements 4l..4l+3 and
// 128+4l..128+4l+3: f32 moves as 16-byte vectors and int8 as 4-byte words,
// each warp access a contiguous 512 or 128 bytes.  The abs-max is one warp
// reduction (__reduce_max_sync on the bit patterns of |x|, which order as
// the values do and put every NaN above +inf); nothing goes through shared
// memory and no block waits on another.  Both reach 84-90 % of the memory
// rate.
//
// equarx_hop.  Its bytes are int8 on both sides, ~2 bytes an element at
// D = 1, so the shape above missed its bound by 3.7x (0.1655 ms against
// 0.0444 on one H100 80GB HBM3 at 700 W): a warp loaded 256 bytes, then
// spent ~30 instructions an element (two IEEE divisions, each a div.rn
// sequence with a range check, and three conversions, int8 -> f32,
// rintf and f32 -> int, on the conversion pipe: 16 results a clock an SM
// against 128 f32 adds) before its next load.  Neither enough bytes were
// in flight nor enough instructions issued to move 2 bytes an element at
// 3.35 TB/s.  So:
//   - a persistent grid (as many CTAs as fit on the SMs) walks pairs of
//     blocks with a grid stride; a half-warp owns a block, a lane 16
//     elements as one 16-byte load a peer, and the next pair's loads are
//     issued before this pair's arithmetic (kPeers = 1, 2, 4, 8 peers
//     unrolled; other peer counts loop without the prefetch);
//   - int8 -> f32 without a conversion: the byte, offset by 128, becomes
//     the low mantissa byte of 2^23 (__byte_perm), and 2^23 + 128 is
//     subtracted, exactly;
//   - the peer mean: n_dev = 1 skips it; n_dev = 2^k multiplies by 2^-k,
//     the same correctly rounded value of the same real number as the
//     division, subnormals included; any other n_dev divides (__fdiv_rn).
//     The caller picks the mode (mean_mode, mean_arg) from n_dev;
//   - the requantize: x / s over a block has one divisor, so y = 1/s is
//     taken once a block, correctly rounded (__frcp_rn), and each element
//     costs t = x*y and one FMA remainder correction, t' = fma(fma(-t, s,
//     x), y, t).  With y correctly rounded, that correction lands on the
//     correctly rounded x / s as long as nothing underflows or overflows
//     (Markstein's theorem); tests/test_torch_quantize.py holds the
//     sequence, with an exact FMA, to IEEE division on quotients 2^-47
//     from a rounding midpoint.  A half-warp takes this path only if
//     2^-96 <= s < inf (s from a finite block): every x whose quotient can
//     round to a nonzero q is then >= 2^-97, its remainder a multiple of
//     2^-143, far above the subnormals' spacing of 2^-149, and |x / s| <=
//     127 (1 + 2^-23);
//   - so that path needs no clamp and no NaN test, and rounds with the
//     1.5 * 2^23 shifter: t' + 1.5 * 2^23 rounds half to even to an
//     integer whose low byte is q;
//   - a block with a subnormal, tiny, infinite or NaN scale (from an inf
//     or NaN in the block) divides with __fdiv_rn, clamps, and sets a
//     NaN's q to 0, as before.  Both paths run in one kernel, chosen by
//     the data, and give the same bits (Markstein: the same quotient).
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

// ------------------------------------------------------------ equarx_hop --

constexpr int kHopThreads = 256;          // 8 warps, each a pair of blocks at a time
constexpr int kHopWarps = kHopThreads / 32;
constexpr float kByteBias = 8388736.0f;   // 2^23 + 128
constexpr float kShifter = 12582912.0f;   // 1.5 * 2^23: x + it rounds x to an integer
constexpr float kMinFastScale = 0x1p-96f; // below it (and at inf or NaN) the quotient divides
constexpr float kMaxFinite = 3.40282347e+38f;

// max(m, |v|), a NaN in either giving NaN (fmaxf would drop it)
__device__ __forceinline__ float max_abs_nan(float m, float v) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(m), "f"(fabsf(v)));
  return r;
}

// acc (+)= the 16 int8 of w times sc, with no conversion instruction: byte
// b + 128 as the low mantissa byte of 2^23 is 2^23 + b + 128, exactly.
__device__ __forceinline__ void accumulate16(const uint4& w, float sc, bool first,
                                             float (&acc)[16]) {
  const unsigned words[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u, w.z ^ 0x80808080u,
                             w.w ^ 0x80808080u};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float v = __fsub_rn(__uint_as_float(__byte_perm(words[k], 0x4b000000u, 0x7440 + i)),
                                kByteBias);
      const float a = __fmul_rn(v, sc);
      acc[4 * k + i] = first ? a : __fadd_rn(acc[4 * k + i], a);
    }
  }
}

// The peer mean: mode 0 (n_dev = 1) none, 1 (n_dev = 2^k) times arg = 2^-k,
// 2 divided by arg = n_dev.
__device__ __forceinline__ void take_mean(float (&acc)[16], int mode, float arg) {
  if (mode == 1) {
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = __fmul_rn(acc[i], arg);
  } else if (mode == 2) {
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = __fdiv_rn(acc[i], arg);
  }
}

// Requantize a half-warp's block (this lane's 16 elements of it) and store
// q and, from the first lane, the scale; row < n or nothing is stored.
__device__ __forceinline__ void requantize16(const float (&acc)[16], int8_t* __restrict__ qo,
                                             float* __restrict__ so, long long row, long long n,
                                             int part) {
  float m = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i) m = max_abs_nan(m, acc[i]);
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)   // within each half-warp
    m = max_abs_nan(m, __shfl_xor_sync(0xffffffffu, m, off));
  float sc = __fdiv_rn(m, 127.0f);
  sc = sc == 0.0f ? 1.0f : sc;
  unsigned b[16];
  if (sc >= kMinFastScale && sc <= kMaxFinite) {
    const float y = __frcp_rn(sc);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float t = __fmul_rn(acc[i], y);
      const float t1 = __fmaf_rn(__fmaf_rn(-t, sc, acc[i]), y, t);   // = acc / sc, IEEE
      b[i] = __float_as_uint(__fadd_rn(t1, kShifter));                // low byte = rint(t1)
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float t = __fdiv_rn(acc[i], sc);
      int v = 0;
      if (t == t) v = __float2int_rn(fminf(fmaxf(rintf(t), -127.0f), 127.0f));
      b[i] = static_cast<unsigned>(v);
    }
  }
  unsigned o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)   // the low bytes of b[4k..4k+3], in order
    o[k] = __byte_perm(__byte_perm(b[4 * k], b[4 * k + 1], 0x0040),
                       __byte_perm(b[4 * k + 2], b[4 * k + 3], 0x0040), 0x5410);
  if (row < n) {
    reinterpret_cast<uint4*>(qo + row * kBlock)[part] = make_uint4(o[0], o[1], o[2], o[3]);
    if (part == 0) so[row] = sc;
  }
}

// Pair p's 16-byte word of each of K peers for this lane, and the scales
// (a row past n, the second half of an odd n's last pair, reads row n - 1).
template <int K>
__device__ __forceinline__ void load_pair(const int8_t* __restrict__ q,
                                          const float* __restrict__ s, long long n,
                                          long long p, int half, int part, uint4 (&w)[K],
                                          float (&sc)[K]) {
  const long long row = min(2 * p + half, n - 1);
#pragma unroll
  for (int d = 0; d < K; ++d) {
    const long long r = d * n + row;
    w[d] = reinterpret_cast<const uint4*>(q + r * kBlock)[part];
    sc[d] = s[r];
  }
}

// kPeers = D peers unrolled, the next pair's loads in flight during this
// pair's arithmetic; kPeers = 0 takes any D in a loop.
template <int kPeers>
__global__ void __launch_bounds__(kHopThreads)
equarx_hop_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                  int8_t* __restrict__ qo, float* __restrict__ so, int D, long long n,
                  int mean_mode, float mean_arg) {
  constexpr int K = kPeers > 0 ? kPeers : 1;
  const int lane = threadIdx.x & 31, half = lane >> 4, part = lane & 15;
  const long long pairs = (n + 1) / 2;
  const long long stride = static_cast<long long>(gridDim.x) * kHopWarps;
  long long p = static_cast<long long>(blockIdx.x) * kHopWarps + (threadIdx.x >> 5);
  if (p >= pairs) return;   // the whole warp leaves together
  uint4 w[K];
  float sc[K];
  if constexpr (kPeers > 0) load_pair<K>(q, s, n, p, half, part, w, sc);
  while (true) {
    const long long next = p + stride;
    uint4 wn[K];
    float scn[K];
    if constexpr (kPeers > 0) {
      if (next < pairs) load_pair<K>(q, s, n, next, half, part, wn, scn);
    }
    float acc[16];
    if constexpr (kPeers > 0) {
#pragma unroll
      for (int d = 0; d < K; ++d) accumulate16(w[d], sc[d], d == 0, acc);
    } else {
      const long long row = min(2 * p + half, n - 1);
      for (int d = 0; d < D; ++d) {
        const long long r = d * n + row;
        accumulate16(reinterpret_cast<const uint4*>(q + r * kBlock)[part], s[r], d == 0, acc);
      }
    }
    take_mean(acc, mean_mode, mean_arg);
    requantize16(acc, qo, so, 2 * p + half, n, part);
    if (next >= pairs) break;
    p = next;
    if constexpr (kPeers > 0) {
#pragma unroll
      for (int d = 0; d < K; ++d) {
        w[d] = wn[d];
        sc[d] = scn[d];
      }
    }
  }
}

// A persistent grid: as many CTAs as fit on the SMs at once, or fewer.
template <int kPeers>
int launch_hop(const int8_t* q, const float* s, int8_t* qo, float* so, int D, long long n,
               int mean_mode, float mean_arg, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, equarx_hop_kernel<kPeers>,
                                                        kHopThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long need = ((n + 1) / 2 + kHopWarps - 1) / kHopWarps;
  const long long fit = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = static_cast<unsigned>(need < fit ? need : fit);
  equarx_hop_kernel<kPeers><<<grid, kHopThreads, 0, stream>>>(q, s, qo, so, D, n, mean_mode,
                                                              mean_arg);
  return static_cast<int>(cudaGetLastError());
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

// q (D, n, 256) int8 (16-byte aligned), s (D, n) f32 -> qo (n, 256) int8,
// so (n,) f32.  mean_mode: 0 for n_dev = 1, 1 for n_dev = 2^k (mean_arg =
// 2^-k), 2 otherwise (mean_arg = n_dev).
extern "C" int equarx_hop(const int8_t* q, const float* s, int8_t* qo, float* so,
                          int D, long long n, int mean_mode, float mean_arg, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 1: return launch_hop<1>(q, s, qo, so, D, n, mean_mode, mean_arg, st);
    case 2: return launch_hop<2>(q, s, qo, so, D, n, mean_mode, mean_arg, st);
    case 4: return launch_hop<4>(q, s, qo, so, D, n, mean_mode, mean_arg, st);
    case 8: return launch_hop<8>(q, s, qo, so, D, n, mean_mode, mean_arg, st);
    default: return launch_hop<0>(q, s, qo, so, D, n, mean_mode, mean_arg, st);
  }
}
