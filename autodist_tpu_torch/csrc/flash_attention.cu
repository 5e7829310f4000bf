// Flash attention for Hopper (sm_90a): forward, ring block update, dq and
// dkdv kernels.
//
// Replaces the Pallas TPU kernels of autodist_tpu/ops/pallas/flash_attention.py:
//   forward       <- _flash_fwd         (pallas_call at :198, body _fwd_kernel :140)
//   block update  <- flash_block_update (pallas_call at :494, body _block_update_kernel :403)
//   dq            <- _dq_call           (pallas_call at :328, body _dq_kernel :264)
//   dkdv          <- _dkdv_call         (pallas_call at :367, body _dkdv_kernel :226)
// Each comes in two designs: bf16 inputs (the model's path) run on the
// tensor cores (mma_*_kernel), f32 inputs on f32 FMAs (fma_*_kernel), so
// that f32 keeps f32 products.
//
// Semantics kept from the TPU kernels:
//   s = q.k^T * scale + bias[key]; causal keeps rows >= cols, aligned top-left
//   with global indices from 0.  Masked scores are the finite -1e30 and the
//   running max starts at the floor -1e20, so a fully masked row gives exactly
//   0 out, lse = m + log(1), and p = 0 in the backward.  K-tiles that lie
//   wholly above the diagonal are skipped.  The backward recomputes
//   p = exp(s - lse) and ds = p * (dp - delta) * scale, delta = rowsum(dO*O)
//   coming from the caller.  GQA: q head hq reads kv head hq / group (the
//   _kv_index rule), never a materialised repeat; dkdv runs one block per
//   (q head, k-tile) so no two blocks write the same rows, and with group > 1
//   it writes f32 per-q-head partials that the caller sums over each group.
//   Any S and any D <= 128: the ragged last tile is masked in the kernel.
//
// Ring attention (parallel/ring_attention.py) places each block at its
// global position: the block update, dq and dkdv take q_off and k_off, and
// causal keeps q_off + row >= k_off + col.  A block wholly in the future
// (k_off > q_off + Sq - 1) computes nothing: the update passes the carry
// through (m clamped at the floor), dq and dkdv write zeros, which the
// ring adds.  The block update is the forward kernel with other ends
// (template flag kUpdate): it loads the unnormalised (m, l, o) carry where
// the forward starts from (floor, 0, 0), takes no bias row, and stores the
// carry where the forward normalises and writes lse.
//
// Bound on an H100 SXM at the GPT-2-small shape (B=8, H=12, S=1024, D=64,
// causal, bf16), from the S(S+1)/2 unmasked (row, key) pairs per head, at
// 989 TFLOP/s (bf16 dense) and 3.35 TB/s:
//   forward: 2 products of 2*D flops per pair  = 12.9 GFLOP -> 13.0 us;
//            q, k, v, out (4 x 12.6 MB) + lse     = 50.7 MB   -> 15.1 us (bytes)
//   dq:      3 products (s, dp, dq)              = 19.3 GFLOP -> 19.6 us (ops);
//            q, k, v, dO, dq + lse, delta        = 63.7 MB   -> 19.0 us
//   dkdv:    4 products (s, dp, dv, dk)          = 25.8 GFLOP -> 26.1 us (ops);
//            q, k, v, dO, dk, dv + lse, delta    = 76.3 MB   -> 22.8 us
//   update:  as the forward, 12.9 GFLOP -> 13.0 us; q, k, v (37.7 MB) and
//            the f32 carry read and written (m, l 1.6 MB, o 50.3 MB)
//                                                = 89.6 MB   -> 26.8 us (bytes)
//
// The bf16 design (FlashAttention-2's register layout on mma.sync): a block
// of 4 warps takes a 64-row tile, each warp 16 rows; tiles of 64 keys are
// staged in shared memory as bf16 (rows padded by 8 elements, so fragment
// reads are free of bank conflicts).  Both products of each step run as
// mma.sync.m16n8k16 (bf16 in, f32 accumulate); the score fragments stay in
// registers, where the masking, the online softmax and the backward's
// p and ds are computed in f32 and repacked as the bf16 A operand of the
// second product (p and ds round to bf16 there, as a TPU's default-precision
// f32 matmul rounds its operands).  It does not reach the bound: tiles load
// synchronously (no cp.async/TMA pipeline), mma.sync runs at a fraction of
// wgmma's rate, and K/V are re-read from L2 by every q-tile.  wgmma with a
// TMA-fed ring of tiles is the next step.
//
// The f32 design stages 64x64 tiles in shared memory as f32 and multiplies
// with FMAs on the CUDA cores: 256 threads, each owning a 4x4 patch of the
// score tile and a 4 x D/16 patch of the output, odd row strides.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu
// Every entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;     // f32 design: 16 x 16 threads (ty, tx)
constexpr int kMmaThreads = 128;  // bf16 design: 4 warps of 16 rows
constexpr int kMaxD = 128;
constexpr int kPld = kBlockK + 1;  // row stride of the score tile in smem
constexpr float kNegInf = -1e30f;
constexpr float kMFloor = -1e20f;

__device__ __forceinline__ float row_max(float x) {
  // the 16 threads of one score row share a half-warp (lanes 0-15 or 16-31)
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows [row0, row0 + 64) of a row-major (rows, D) matrix into a (64, ld) f32
// tile; rows past the end are zero so that 0 * tile never makes a NaN.
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* __restrict__ src,
                                          int row0, int rows, int D) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx - r * D;
    const int g = row0 + r;
    dst[r * ld + c] = g < rows ? src[(size_t)g * D + c] : 0.f;
  }
}

// 4x4 patch of A.B^T for rows ty + 16i of A and rows tx + 16j of B.
__device__ __forceinline__ void tile_abt(float (&acc)[4][4], const float* A, const float* B,
                                         int ld, int D, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * ld + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * ld + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Masked, scaled score for row r and key c of the block (the Pallas
// _scores); shift = q_off - k_off, so causal keeps q_off + r >= k_off + c.
// kBias false (the block update) adds no bias row.  The flag is a template
// argument: a runtime test of the pointer in the unrolled score loops made
// dq 37 % slower (chip_smoke.py, one H100 80GB HBM3 at 700 W).
template <bool kBias>
__device__ __forceinline__ float masked_score(float dot, int r, int c, int Sk, float scale,
                                              const float* __restrict__ bias_row, int causal,
                                              int shift) {
  if (c >= Sk) return kNegInf;
  if (causal && r + shift < c) return kNegInf;
  return kBias ? dot * scale + bias_row[c] : dot * scale;
}

// Key tiles a q-tile can see (exclusive end): the causal block skip.  0 when
// the block lies wholly in the tile's future.
__device__ __forceinline__ int key_tiles(int q0, int Sq, int Sk, int causal, int shift) {
  int nk = (Sk + kBlockK - 1) / kBlockK;
  if (causal) {
    const int last_key = min(q0 + kBlockQ, Sq) - 1 + shift;  // the last row's last key
    nk = last_key < 0 ? 0 : min(nk, last_key / kBlockK + 1);
  }
  return nk;
}

// First q-tile that sees key k0 (the first key of a k-tile): its last row
// must reach k0 - shift.  At or past the last tile when no row sees it.
__device__ __forceinline__ int first_query_tile(int k0, int causal, int shift) {
  if (!causal) return 0;
  const int need = k0 - shift - (kBlockQ - 1);
  return need <= 0 ? 0 : (need + kBlockQ - 1) / kBlockQ;
}

// The (m, l, o) carry of the ring block update, (BH, Sq) and (BH, Sq, D)
// f32: read at entry, written at exit.  Unused (null) by the forward.
struct Carry {
  const float* m_in;
  const float* l_in;
  const float* o_in;
  float* m_out;
  float* l_out;
  float* o_out;
};

// ------------------------------------------------------------------ forward --
// One block per (q head fold bh, q-tile); loops over k-tiles with the running
// max m, denominator l and output accumulator in registers.  kUpdate: the
// ring block update (the carry in and out, no bias, offsets).
template <int DC, bool kUpdate>
__global__ void __launch_bounds__(kThreads)
fma_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ bias,
               float* __restrict__ out, float* __restrict__ lse, Carry carry, int H, int group,
               int Sq, int Sk, int D, float scale, int causal, int shift) {
  extern __shared__ float smem[];
  const int ld = D | 1;
  float* Qs = smem;
  float* Ks = Qs + kBlockQ * ld;
  float* Vs = Ks + kBlockK * ld;
  float* Ps = Vs + kBlockK * ld;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;  // last (heaviest) q-tiles first
  const int b = bh / H;
  const int kvh = b * (H / group) + (bh % H) / group;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* kp = k + (size_t)kvh * Sk * D;
  const float* vp = v + (size_t)kvh * Sk * D;
  const float* bias_row = kUpdate ? nullptr : bias + (size_t)b * Sk;

  load_tile(Qs, ld, q + (size_t)bh * Sq * D, q0, Sq, D);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    const bool carried = kUpdate && r < Sq;
    const size_t row = (size_t)bh * Sq + r;
    // the carry's m is clamped at the floor: an m of -inf cannot NaN
    m[i] = carried ? fmaxf(carry.m_in[row], kMFloor) : kMFloor;
    l[i] = carried ? carry.l_in[row] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      acc[i][c] = carried && d < D ? carry.o_in[row * D + d] : 0.f;
    }
  }

  const int nk = key_tiles(q0, Sq, Sk, causal, shift);
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kBlockK;
    __syncthreads();
    load_tile(Ks, ld, kp, k0, Sk, D);
    load_tile(Vs, ld, vp, k0, Sk, D);
    __syncthreads();

    float s[4][4];
    tile_abt(s, Qs, Ks, ld, D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        s[i][jj] = masked_score<!kUpdate>(s[i][jj], r, k0 + tx + 16 * jj, Sk, scale, bias_row,
                                          causal, shift);
        mx = fmaxf(mx, s[i][jj]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(s[i][jj] - m_new);
        rs += p;
        Ps[(ty + 16 * i) * kPld + tx + 16 * jj] = p;
      }
      l[i] = l[i] * corr + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    for (int c = 0; c < kBlockK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * kPld + c];
#pragma unroll
      for (int dc = 0; dc < DC; ++dc) {
        const int d = tx + 16 * dc;
        if (d < D) {
          const float vv = Vs[c * ld + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][dc] = fmaf(p[i], vv, acc[i][dc]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    if (kUpdate) {   // the unnormalised carry
      const size_t row = (size_t)bh * Sq + r;
#pragma unroll
      for (int dc = 0; dc < DC; ++dc) {
        const int d = tx + 16 * dc;
        if (d < D) carry.o_out[row * D + d] = acc[i][dc];
      }
      if (tx == 0) {
        carry.m_out[row] = m[i];
        carry.l_out[row] = l[i];
      }
      continue;
    }
    const float denom = l[i] == 0.f ? 1.f : l[i];  // fully masked row -> 0
    float* orow = out + ((size_t)bh * Sq + r) * D;
#pragma unroll
    for (int dc = 0; dc < DC; ++dc) {
      const int d = tx + 16 * dc;
      if (d < D) orow[d] = acc[i][dc] / denom;
    }
    if (tx == 0) lse[(size_t)bh * Sq + r] = m[i] + logf(denom);
  }
}

// ---------------------------------------------------------------------- dq --
// One block per (bh, q-tile); loops over k-tiles: dq += ds . k.
template <int DC>
__global__ void __launch_bounds__(kThreads)
fma_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ bias,
              const float* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, float* __restrict__ dq, int H, int group,
              int Sq, int Sk, int D, float scale, int causal, int shift) {
  extern __shared__ float smem[];
  const int ld = D | 1;
  float* Qs = smem;
  float* Os = Qs + kBlockQ * ld;  // dO tile
  float* Ks = Os + kBlockQ * ld;
  float* Vs = Ks + kBlockK * ld;
  float* Ps = Vs + kBlockK * ld;  // ds tile

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;  // last (heaviest) q-tiles first
  const int b = bh / H;
  const int kvh = b * (H / group) + (bh % H) / group;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* kp = k + (size_t)kvh * Sk * D;
  const float* vp = v + (size_t)kvh * Sk * D;
  const float* bias_row = bias + (size_t)b * Sk;

  load_tile(Qs, ld, q + (size_t)bh * Sq * D, q0, Sq, D);
  load_tile(Os, ld, dout + (size_t)bh * Sq * D, q0, Sq, D);
  float row_lse[4], row_delta[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    row_lse[i] = r < Sq ? lse[(size_t)bh * Sq + r] : 0.f;
    row_delta[i] = r < Sq ? delta[(size_t)bh * Sq + r] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int nk = key_tiles(q0, Sq, Sk, causal, shift);  // 0: the rows get zeros
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kBlockK;
    __syncthreads();
    load_tile(Ks, ld, kp, k0, Sk, D);
    load_tile(Vs, ld, vp, k0, Sk, D);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_abt(s, Qs, Ks, ld, D, ty, tx);
    tile_abt(dp, Os, Vs, ld, D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float x =
            masked_score<true>(s[i][jj], r, k0 + tx + 16 * jj, Sk, scale, bias_row, causal, shift);
        const float p = r < Sq ? expf(x - row_lse[i]) : 0.f;
        Ps[(ty + 16 * i) * kPld + tx + 16 * jj] = p * (dp[i][jj] - row_delta[i]) * scale;
      }
    }
    __syncthreads();

    for (int c = 0; c < kBlockK; ++c) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = Ps[(ty + 16 * i) * kPld + c];
#pragma unroll
      for (int dc = 0; dc < DC; ++dc) {
        const int d = tx + 16 * dc;
        if (d < D) {
          const float kk = Ks[c * ld + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][dc] = fmaf(ds[i], kk, acc[i][dc]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    float* row = dq + ((size_t)bh * Sq + r) * D;
#pragma unroll
    for (int dc = 0; dc < DC; ++dc) {
      const int d = tx + 16 * dc;
      if (d < D) row[d] = acc[i][dc];
    }
  }
}

// -------------------------------------------------------------------- dkdv --
// One block per (q head fold bh, k-tile); loops over q-tiles:
// dv += p^T . dO and dk += ds^T . q.  Output rows belong to q head bh, so
// blocks never alias.
template <int DC>
__global__ void __launch_bounds__(kThreads)
fma_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ bias,
                const float* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv, int H, int group, int Sq, int Sk, int D, float scale,
                int causal, int shift) {
  extern __shared__ float smem[];
  const int ld = D | 1;
  float* Ks = smem;
  float* Vs = Ks + kBlockK * ld;
  float* Qs = Vs + kBlockK * ld;
  float* Os = Qs + kBlockQ * ld;   // dO tile
  float* Ps = Os + kBlockQ * ld;   // p tile (q rows x k cols)
  float* Ds = Ps + kBlockQ * kPld;  // ds tile
  float* Ls = Ds + kBlockQ * kPld;  // lse of the q-tile
  float* Es = Ls + kBlockQ;         // delta of the q-tile

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBlockK;
  const int b = bh / H;
  const int kvh = b * (H / group) + (bh % H) / group;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* qp = q + (size_t)bh * Sq * D;
  const float* op = dout + (size_t)bh * Sq * D;
  const float* bias_row = bias + (size_t)b * Sk;

  load_tile(Ks, ld, k + (size_t)kvh * Sk * D, k0, Sk, D);
  load_tile(Vs, ld, v + (size_t)kvh * Sk * D, k0, Sk, D);

  float acc_k[4][DC], acc_v[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  const int nq = (Sq + kBlockQ - 1) / kBlockQ;
  // causal: q-tiles whose last row lies before this k-tile see none of it;
  // when no tile sees it the loop is empty and the rows get zeros
  const int i0 = first_query_tile(k0, causal, shift);
  for (int it = i0; it < nq; ++it) {
    const int q0 = it * kBlockQ;
    __syncthreads();
    load_tile(Qs, ld, qp, q0, Sq, D);
    load_tile(Os, ld, op, q0, Sq, D);
    if (threadIdx.x < kBlockQ) {
      const int r = q0 + threadIdx.x;
      Ls[threadIdx.x] = r < Sq ? lse[(size_t)bh * Sq + r] : 0.f;
      Es[threadIdx.x] = r < Sq ? delta[(size_t)bh * Sq + r] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_abt(s, Qs, Ks, ld, D, ty, tx);   // rows: q, cols: k
    tile_abt(dp, Os, Vs, ld, D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = ty + 16 * i;
      const int r = q0 + rl;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int cl = tx + 16 * jj;
        const float x =
            masked_score<true>(s[i][jj], r, k0 + cl, Sk, scale, bias_row, causal, shift);
        const float p = r < Sq ? expf(x - Ls[rl]) : 0.f;
        Ps[rl * kPld + cl] = p;
        Ds[rl * kPld + cl] = p * (dp[i][jj] - Es[rl]) * scale;
      }
    }
    __syncthreads();

    for (int r = 0; r < kBlockQ; ++r) {
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = Ps[r * kPld + ty + 16 * i];
        ds[i] = Ds[r * kPld + ty + 16 * i];
      }
#pragma unroll
      for (int dc = 0; dc < DC; ++dc) {
        const int d = tx + 16 * dc;
        if (d < D) {
          const float o = Os[r * ld + d];
          const float qq = Qs[r * ld + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc_v[i][dc] = fmaf(p[i], o, acc_v[i][dc]);
            acc_k[i][dc] = fmaf(ds[i], qq, acc_k[i][dc]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c >= Sk) continue;
    float* krow = dk + ((size_t)bh * Sk + c) * D;
    float* vrow = dv + ((size_t)bh * Sk + c) * D;
#pragma unroll
    for (int dc = 0; dc < DC; ++dc) {
      const int d = tx + 16 * dc;
      if (d < D) {
        krow[d] = acc_k[i][dc];
        vrow[d] = acc_v[i][dc];
      }
    }
  }
}

// ------------------------------------------------------ bf16: tensor cores --
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16, row-major): a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   B (16x8, k x n):      b0 (k 2t..2t+1, n g)  b1 (k 2t+8..2t+9, n g)
//   C (16x8, f32):        c0, c1 (g, 2t..2t+1)  c2, c3 (g+8, 2t..2t+1)
// Two adjacent C tiles are exactly the A fragment of a 16x16 operand, which
// is how p and ds feed the second product without leaving registers.

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_pair(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of the row-major smem tile X (row stride L) at (r0, k0).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint16_t* X, int L, int r0, int k0,
                                       int g, int t) {
  a[0] = ld_pair(X + (r0 + g) * L + k0 + 2 * t);
  a[1] = ld_pair(X + (r0 + g + 8) * L + k0 + 2 * t);
  a[2] = ld_pair(X + (r0 + g) * L + k0 + 8 + 2 * t);
  a[3] = ld_pair(X + (r0 + g + 8) * L + k0 + 8 + 2 * t);
}

// B fragment with B[k][n] = Y[n0 + n][k0 + k]: Y's rows are the n index.
__device__ __forceinline__ void load_b_rows(uint32_t& b0, uint32_t& b1, const uint16_t* Y, int L,
                                            int n0, int k0, int g, int t) {
  b0 = ld_pair(Y + (n0 + g) * L + k0 + 2 * t);
  b1 = ld_pair(Y + (n0 + g) * L + k0 + 8 + 2 * t);
}

// B fragment with B[k][n] = Y[k0 + k][n0 + n]: Y's rows are the k index.
__device__ __forceinline__ void load_b_cols(uint32_t& b0, uint32_t& b1, const uint16_t* Y, int L,
                                            int k0, int n0, int g, int t) {
  const uint16_t* p = Y + (k0 + 2 * t) * L + n0 + g;
  b0 = (uint32_t)p[0] | ((uint32_t)p[L] << 16);
  b1 = (uint32_t)p[8 * L] | ((uint32_t)p[9 * L] << 16);
}

// Accumulator tiles c0 (columns 0-7) and c1 (8-15) as a bf16 A fragment.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// the 4 lanes of one fragment row (same g) reduce over t
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint16_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16(x));
}

// Rows [row0, row0 + 64) of a row-major (rows, D) bf16 matrix into a
// (64, DP + 8) smem tile, zero past the ends.  vec: D % 8 == 0 and the
// source is 16-byte aligned, so each thread moves 8 elements at once.
template <int DP>
__device__ __forceinline__ void load_tile_bf16(uint16_t* dst, const uint16_t* __restrict__ src,
                                               int row0, int rows, int D, int vec) {
  constexpr int L = DP + 8, CH = DP / 8;
  for (int idx = threadIdx.x; idx < 64 * CH; idx += kMmaThreads) {
    const int r = idx / CH;
    const int c = (idx - r * CH) * 8;
    const int gr = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < rows && c < D) {
      const uint16_t* sp = src + (size_t)gr * D + c;
      if (vec) {
        val = *reinterpret_cast<const uint4*>(sp);
      } else {
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t lo = c + 2 * e < D ? sp[2 * e] : 0u;
          const uint32_t hi = c + 2 * e + 1 < D ? sp[2 * e + 1] : 0u;
          w[e] = lo | (hi << 16);
        }
        val = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * L + c) = val;
  }
}

// kUpdate: the ring block update, as in fma_fwd_kernel.
template <int DP, bool kUpdate>
__global__ void __launch_bounds__(kMmaThreads)
mma_fwd_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
               const uint16_t* __restrict__ v, const float* __restrict__ bias,
               uint16_t* __restrict__ out, float* __restrict__ lse, Carry carry, int H,
               int group, int Sq, int Sk, int D, float scale, int causal, int shift, int vec) {
  constexpr int L = DP + 8, KD = DP / 16, ND = DP / 8, NK = kBlockK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* Qs = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* Ks = Qs + kBlockQ * L;
  uint16_t* Vs = Ks + kBlockK * L;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;  // last (heaviest) q-tiles first
  const int b = bh / H;
  const int kvh = b * (H / group) + (bh % H) / group;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = (threadIdx.x / 32) * 16;
  const uint16_t* kp = k + (size_t)kvh * Sk * D;
  const uint16_t* vp = v + (size_t)kvh * Sk * D;
  const float* bias_row = kUpdate ? nullptr : bias + (size_t)b * Sk;
  const int row[2] = {q0 + r0 + g, q0 + r0 + g + 8};

  load_tile_bf16<DP>(Qs, q + (size_t)bh * Sq * D, q0, Sq, D, vec);
  __syncthreads();
  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) load_a(qa[kk], Qs, L, r0, kk * 16, g, t);

  // the carry in the accumulator's fragment layout (m clamped at the floor)
  float m[2], l[2], acc[ND][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool carried = kUpdate && row[h] < Sq;
    m[h] = carried ? fmaxf(carry.m_in[(size_t)bh * Sq + row[h]], kMFloor) : kMFloor;
    l[h] = carried ? carry.l_in[(size_t)bh * Sq + row[h]] : 0.f;
  }
#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, col = dn * 8 + 2 * t + (e & 1);
      acc[dn][e] = kUpdate && row[h] < Sq && col < D
                       ? carry.o_in[((size_t)bh * Sq + row[h]) * D + col]
                       : 0.f;
    }

  const int nk = key_tiles(q0, Sq, Sk, causal, shift);
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kBlockK;
    __syncthreads();
    load_tile_bf16<DP>(Ks, kp, k0, Sk, D, vec);
    load_tile_bf16<DP>(Vs, vp, k0, Sk, D, vec);
    __syncthreads();

    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        uint32_t b0, b1;
        load_b_rows(b0, b1, Ks, L, n * 8, kk * 16, g, t);
        mma16816(s[n], qa[kk], b0, b1);
      }

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        s[n][e] = masked_score<!kUpdate>(s[n][e], row[e >> 1], col, Sk, scale, bias_row, causal,
                                         shift);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(mx[h]));
      corr[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        rs[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + quad_sum(rs[h]);
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dn][e] *= corr[e >> 1];

#pragma unroll
    for (int kc = 0; kc < NK / 2; ++kc) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int dn = 0; dn < ND; ++dn) {
        uint32_t b0, b1;
        load_b_cols(b0, b1, Vs, L, kc * 16, dn * 8, g, t);
        mma16816(acc[dn], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= Sq) continue;
    if (kUpdate) {   // the unnormalised carry
      const size_t r = (size_t)bh * Sq + row[h];
#pragma unroll
      for (int dn = 0; dn < ND; ++dn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = dn * 8 + 2 * t + e;
          if (col < D) carry.o_out[r * D + col] = acc[dn][2 * h + e];
        }
      if (t == 0) {
        carry.m_out[r] = m[h];
        carry.l_out[r] = l[h];
      }
      continue;
    }
    const float denom = l[h] == 0.f ? 1.f : l[h];  // fully masked row -> 0
    uint16_t* orow = out + ((size_t)bh * Sq + row[h]) * D;
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = dn * 8 + 2 * t + e;
        if (col < D) orow[col] = bf16_bits(acc[dn][2 * h + e] / denom);
      }
    if (t == 0) lse[(size_t)bh * Sq + row[h]] = m[h] + logf(denom);
  }
}

template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
mma_dq_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
              const uint16_t* __restrict__ v, const float* __restrict__ bias,
              const uint16_t* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, uint16_t* __restrict__ dq, int H, int group,
              int Sq, int Sk, int D, float scale, int causal, int shift, int vec) {
  constexpr int L = DP + 8, KD = DP / 16, ND = DP / 8, NK = kBlockK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* Qs = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* Os = Qs + kBlockQ * L;  // dO tile
  uint16_t* Ks = Os + kBlockQ * L;
  uint16_t* Vs = Ks + kBlockK * L;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;  // last (heaviest) q-tiles first
  const int b = bh / H;
  const int kvh = b * (H / group) + (bh % H) / group;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = (threadIdx.x / 32) * 16;
  const uint16_t* kp = k + (size_t)kvh * Sk * D;
  const uint16_t* vp = v + (size_t)kvh * Sk * D;
  const float* bias_row = bias + (size_t)b * Sk;
  const int row[2] = {q0 + r0 + g, q0 + r0 + g + 8};

  load_tile_bf16<DP>(Qs, q + (size_t)bh * Sq * D, q0, Sq, D, vec);
  load_tile_bf16<DP>(Os, dout + (size_t)bh * Sq * D, q0, Sq, D, vec);
  __syncthreads();
  uint32_t qa[KD][4], oa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    load_a(qa[kk], Qs, L, r0, kk * 16, g, t);
    load_a(oa[kk], Os, L, r0, kk * 16, g, t);
  }
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row_lse[h] = row[h] < Sq ? lse[(size_t)bh * Sq + row[h]] : 0.f;
    row_delta[h] = row[h] < Sq ? delta[(size_t)bh * Sq + row[h]] : 0.f;
  }
  float acc[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;

  const int nk = key_tiles(q0, Sq, Sk, causal, shift);  // 0: the rows get zeros
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kBlockK;
    __syncthreads();
    load_tile_bf16<DP>(Ks, kp, k0, Sk, D, vec);
    load_tile_bf16<DP>(Vs, vp, k0, Sk, D, vec);
    __syncthreads();

    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        uint32_t b0, b1;
        load_b_rows(b0, b1, Ks, L, n * 8, kk * 16, g, t);
        mma16816(s[n], qa[kk], b0, b1);
        load_b_rows(b0, b1, Vs, L, n * 8, kk * 16, g, t);
        mma16816(dp[n], oa[kk], b0, b1);
      }
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        const float x =
            masked_score<true>(s[n][e], row[h], col, Sk, scale, bias_row, causal, shift);
        const float p = row[h] < Sq ? expf(x - row_lse[h]) : 0.f;
        s[n][e] = p * (dp[n][e] - row_delta[h]) * scale;  // ds
      }
#pragma unroll
    for (int kc = 0; kc < NK / 2; ++kc) {
      uint32_t da[4];
      acc_to_a(da, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int dn = 0; dn < ND; ++dn) {
        uint32_t b0, b1;
        load_b_cols(b0, b1, Ks, L, kc * 16, dn * 8, g, t);
        mma16816(acc[dn], da, b0, b1);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= Sq) continue;
    uint16_t* drow = dq + ((size_t)bh * Sq + row[h]) * D;
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = dn * 8 + 2 * t + e;
        if (col < D) drow[col] = bf16_bits(acc[dn][2 * h + e]);
      }
  }
}

__device__ __forceinline__ void store_out(uint16_t* p, float x) { *p = bf16_bits(x); }
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }

// One block per (q head fold bh, k-tile), each warp 16 keys; loops over
// q-tiles with the transposed products s^T = k.q^T and dp^T = v.dO^T, then
// dv += p^T.dO and dk += ds^T.q.  TO = float for the GQA partials.
template <int DP, typename TO>
__global__ void __launch_bounds__(kMmaThreads)
mma_dkdv_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                const uint16_t* __restrict__ v, const float* __restrict__ bias,
                const uint16_t* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, TO* __restrict__ dk, TO* __restrict__ dv, int H,
                int group, int Sq, int Sk, int D, float scale, int causal, int shift, int vec) {
  constexpr int L = DP + 8, KD = DP / 16, ND = DP / 8, NQ = kBlockQ / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* Ks = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* Vs = Ks + kBlockK * L;
  uint16_t* Qs = Vs + kBlockK * L;
  uint16_t* Os = Qs + kBlockQ * L;  // dO tile
  float* Ls = reinterpret_cast<float*>(Os + kBlockQ * L);  // lse of the q-tile
  float* Es = Ls + kBlockQ;                                 // delta of the q-tile

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBlockK;
  const int b = bh / H;
  const int kvh = b * (H / group) + (bh % H) / group;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = (threadIdx.x / 32) * 16;
  const uint16_t* qp = q + (size_t)bh * Sq * D;
  const uint16_t* op = dout + (size_t)bh * Sq * D;
  const float* bias_row = bias + (size_t)b * Sk;
  const int key[2] = {k0 + r0 + g, k0 + r0 + g + 8};

  load_tile_bf16<DP>(Ks, k + (size_t)kvh * Sk * D, k0, Sk, D, vec);
  load_tile_bf16<DP>(Vs, v + (size_t)kvh * Sk * D, k0, Sk, D, vec);
  __syncthreads();
  uint32_t ka[KD][4], va[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    load_a(ka[kk], Ks, L, r0, kk * 16, g, t);
    load_a(va[kk], Vs, L, r0, kk * 16, g, t);
  }
  float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[dn][e] = acc_v[dn][e] = 0.f;

  const int nq = (Sq + kBlockQ - 1) / kBlockQ;
  // causal: q-tiles whose last row lies before this k-tile see none of it;
  // when no tile sees it the loop is empty and the rows get zeros
  const int i0 = first_query_tile(k0, causal, shift);
  for (int it = i0; it < nq; ++it) {
    const int q0 = it * kBlockQ;
    __syncthreads();
    load_tile_bf16<DP>(Qs, qp, q0, Sq, D, vec);
    load_tile_bf16<DP>(Os, op, q0, Sq, D, vec);
    if (threadIdx.x < kBlockQ) {
      const int r = q0 + threadIdx.x;
      Ls[threadIdx.x] = r < Sq ? lse[(size_t)bh * Sq + r] : 0.f;
      Es[threadIdx.x] = r < Sq ? delta[(size_t)bh * Sq + r] : 0.f;
    }
    __syncthreads();

    float s[NQ][4], dp[NQ][4];  // rows: this warp's keys, cols: queries
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        uint32_t b0, b1;
        load_b_rows(b0, b1, Qs, L, n * 8, kk * 16, g, t);
        mma16816(s[n], ka[kk], b0, b1);
        load_b_rows(b0, b1, Os, L, n * 8, kk * 16, g, t);
        mma16816(dp[n], va[kk], b0, b1);
      }
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = n * 8 + 2 * t + (e & 1);
        const int query = q0 + ql;
        const float x =
            masked_score<true>(s[n][e], query, key[e >> 1], Sk, scale, bias_row, causal, shift);
        const float p = query < Sq ? expf(x - Ls[ql]) : 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - Es[ql]) * scale;  // ds
      }
#pragma unroll
    for (int kc = 0; kc < NQ / 2; ++kc) {
      uint32_t pa[4], da[4];
      acc_to_a(pa, s[2 * kc], s[2 * kc + 1]);
      acc_to_a(da, dp[2 * kc], dp[2 * kc + 1]);
#pragma unroll
      for (int dn = 0; dn < ND; ++dn) {
        uint32_t b0, b1;
        load_b_cols(b0, b1, Os, L, kc * 16, dn * 8, g, t);
        mma16816(acc_v[dn], pa, b0, b1);
        load_b_cols(b0, b1, Qs, L, kc * 16, dn * 8, g, t);
        mma16816(acc_k[dn], da, b0, b1);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= Sk) continue;
    TO* krow = dk + ((size_t)bh * Sk + key[h]) * D;
    TO* vrow = dv + ((size_t)bh * Sk + key[h]) * D;
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = dn * 8 + 2 * t + e;
        if (col < D) {
          store_out(krow + col, acc_k[dn][2 * h + e]);
          store_out(vrow + col, acc_v[dn][2 * h + e]);
        }
      }
  }
}

// ------------------------------------------------------------- launchers --

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream,
                   Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// f32 design: tiles of (64, D | 1) floats plus the (64, 65) score tile(s)
size_t fma_smem(int D, int tiles, int score_tiles, int rows) {
  return (size_t)(tiles * 64 * (D | 1) + score_tiles * kBlockQ * kPld + rows) * sizeof(float);
}

// bf16 design: tiles of (64, DP + 8) bf16 plus f32 rows
size_t mma_smem(int DP, int tiles, int rows) {
  return (size_t)tiles * 64 * (DP + 8) * sizeof(uint16_t) + (size_t)rows * sizeof(float);
}

// D -> columns per thread of the f32 design (16 each): 1, 2, 4 or 8.
int column_chunks(int D) { return D <= 16 ? 1 : D <= 32 ? 2 : D <= 64 ? 4 : 8; }

// D -> the bf16 design's padded width: 16, 32, 64 or 128.
int padded_width(int D) { return 16 * column_chunks(D); }

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

bool bad_shape(int BH, int H, int group, int Sq, int Sk, int D) {
  return BH <= 0 || H <= 0 || group <= 0 || H % group || BH % H || Sq <= 0 || Sk <= 0 ||
         D <= 0 || D > kMaxD || (Sq + kBlockQ - 1) / kBlockQ > 65535 ||
         (Sk + kBlockK - 1) / kBlockK > 65535;
}

// The forward kernels, as the forward (kUpdate false: bias, out, lse) or as
// the ring block update (kUpdate true: the carry, offsets).
template <bool kUpdate>
cudaError_t launch_forward(const void* q, const void* k, const void* v, const float* bias,
                           void* out, float* lse, Carry carry, int BH, int H, int group,
                           int Sq, int Sk, int D, float scale, int causal, int shift,
                           int is_bf16, cudaStream_t s) {
  const dim3 grid(BH, (Sq + kBlockQ - 1) / kBlockQ);
  if (is_bf16) {
    using P = const uint16_t*;
    const int vec = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
    const int DP = padded_width(D);
    const size_t smem = mma_smem(DP, 3, 0);
#define FWD_ARGS grid, kMmaThreads, smem, s, (P)q, (P)k, (P)v, bias, (uint16_t*)out, lse, carry, \
                 H, group, Sq, Sk, D, scale, causal, shift, vec
    switch (DP) {
      case 16: return launch(mma_fwd_kernel<16, kUpdate>, FWD_ARGS);
      case 32: return launch(mma_fwd_kernel<32, kUpdate>, FWD_ARGS);
      case 64: return launch(mma_fwd_kernel<64, kUpdate>, FWD_ARGS);
      default: return launch(mma_fwd_kernel<128, kUpdate>, FWD_ARGS);
    }
#undef FWD_ARGS
  }
  using P = const float*;
  const size_t smem = fma_smem(D, 3, 1, 0);
#define FWD_ARGS grid, kThreads, smem, s, (P)q, (P)k, (P)v, bias, (float*)out, lse, carry, H, \
                 group, Sq, Sk, D, scale, causal, shift
  switch (column_chunks(D)) {
    case 1: return launch(fma_fwd_kernel<1, kUpdate>, FWD_ARGS);
    case 2: return launch(fma_fwd_kernel<2, kUpdate>, FWD_ARGS);
    case 4: return launch(fma_fwd_kernel<4, kUpdate>, FWD_ARGS);
    default: return launch(fma_fwd_kernel<8, kUpdate>, FWD_ARGS);
  }
#undef FWD_ARGS
}

}  // namespace

extern "C" {

// q (BH, Sq, D); k, v (BH / group, Sk, D); bias (BH / H, Sk) f32;
// out like q; lse (BH, Sq) f32.  is_bf16 selects bf16 (1) or f32 (0) q/k/v/out.
int flash_fwd(const void* q, const void* k, const void* v, const void* bias, void* out,
              void* lse, int BH, int H, int group, int Sq, int Sk, int D, float scale,
              int causal, int is_bf16, void* stream) {
  if (bad_shape(BH, H, group, Sq, Sk, D)) return (int)cudaErrorInvalidValue;
  return (int)launch_forward<false>(q, k, v, (const float*)bias, out, (float*)lse, Carry{}, BH,
                                    H, group, Sq, Sk, D, scale, causal, 0, is_bf16,
                                    (cudaStream_t)stream);
}

// The ring step: fold the block k, v (BH, Sk, D) into the carry of q (BH, Sq,
// D) at global offsets q_off, k_off.  m_in, l_in (BH, Sq) and o_in (BH, Sq,
// D) f32 in; m_out, l_out, o_out out (they may alias the inputs: each row is
// read and written by the same threads).
int flash_block_update(const void* q, const void* k, const void* v, const void* m_in,
                       const void* l_in, const void* o_in, void* m_out, void* l_out,
                       void* o_out, int BH, int Sq, int Sk, int D, float scale, int causal,
                       int q_off, int k_off, int is_bf16, void* stream) {
  if (bad_shape(BH, 1, 1, Sq, Sk, D)) return (int)cudaErrorInvalidValue;
  const Carry carry{(const float*)m_in, (const float*)l_in, (const float*)o_in,
                    (float*)m_out,      (float*)l_out,      (float*)o_out};
  return (int)launch_forward<true>(q, k, v, nullptr, nullptr, nullptr, carry, BH, 1, 1, Sq, Sk,
                                   D, scale, causal, q_off - k_off, is_bf16,
                                   (cudaStream_t)stream);
}

// dout like q; lse, delta (BH, Sq) f32; dq like q.  q_off, k_off: the global
// positions of the q and k blocks (0, 0 outside the ring).
int flash_dq(const void* q, const void* k, const void* v, const void* bias, const void* dout,
             const void* lse, const void* delta, void* dq, int BH, int H, int group, int Sq,
             int Sk, int D, float scale, int causal, int q_off, int k_off, int is_bf16,
             void* stream) {
  if (bad_shape(BH, H, group, Sq, Sk, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int shift = q_off - k_off;
  const dim3 grid(BH, (Sq + kBlockQ - 1) / kBlockQ);
  const float* bs = (const float*)bias;
  const float* ls = (const float*)lse;
  const float* ds = (const float*)delta;
  if (is_bf16) {
    using P = const uint16_t*;
    const int vec = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
                    aligned16(dout);
    const int DP = padded_width(D);
    const size_t smem = mma_smem(DP, 4, 0);
#define DQ_ARGS grid, kMmaThreads, smem, s, (P)q, (P)k, (P)v, bs, (P)dout, ls, ds, \
                (uint16_t*)dq, H, group, Sq, Sk, D, scale, causal, shift, vec
    switch (DP) {
      case 16: return (int)launch(mma_dq_kernel<16>, DQ_ARGS);
      case 32: return (int)launch(mma_dq_kernel<32>, DQ_ARGS);
      case 64: return (int)launch(mma_dq_kernel<64>, DQ_ARGS);
      default: return (int)launch(mma_dq_kernel<128>, DQ_ARGS);
    }
#undef DQ_ARGS
  }
  using P = const float*;
  const size_t smem = fma_smem(D, 4, 1, 0);
#define DQ_ARGS grid, kThreads, smem, s, (P)q, (P)k, (P)v, bs, (P)dout, ls, ds, (float*)dq, H, \
                group, Sq, Sk, D, scale, causal, shift
  switch (column_chunks(D)) {
    case 1: return (int)launch(fma_dq_kernel<1>, DQ_ARGS);
    case 2: return (int)launch(fma_dq_kernel<2>, DQ_ARGS);
    case 4: return (int)launch(fma_dq_kernel<4>, DQ_ARGS);
    default: return (int)launch(fma_dq_kernel<8>, DQ_ARGS);
  }
#undef DQ_ARGS
}

// dk, dv (BH, Sk, D) per q head: like k when group == 1, f32 partials when
// group > 1 (the caller sums each group of q heads).  Offsets as flash_dq.
int flash_dkdv(const void* q, const void* k, const void* v, const void* bias, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int BH, int H, int group,
               int Sq, int Sk, int D, float scale, int causal, int q_off, int k_off,
               int is_bf16, void* stream) {
  if (bad_shape(BH, H, group, Sq, Sk, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int shift = q_off - k_off;
  const dim3 grid(BH, (Sk + kBlockK - 1) / kBlockK);
  const float* bs = (const float*)bias;
  const float* ls = (const float*)lse;
  const float* ds = (const float*)delta;
  if (is_bf16) {
    using P = const uint16_t*;
    const int vec = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
                    aligned16(dout);
    const int DP = padded_width(D);
    const size_t smem = mma_smem(DP, 4, 2 * kBlockQ);
#define DKDV_ARGS(TO) grid, kMmaThreads, smem, s, (P)q, (P)k, (P)v, bs, (P)dout, ls, ds, \
                      (TO*)dk, (TO*)dv, H, group, Sq, Sk, D, scale, causal, shift, vec
    if (group > 1) {
      switch (DP) {
        case 16: return (int)launch(mma_dkdv_kernel<16, float>, DKDV_ARGS(float));
        case 32: return (int)launch(mma_dkdv_kernel<32, float>, DKDV_ARGS(float));
        case 64: return (int)launch(mma_dkdv_kernel<64, float>, DKDV_ARGS(float));
        default: return (int)launch(mma_dkdv_kernel<128, float>, DKDV_ARGS(float));
      }
    }
    switch (DP) {
      case 16: return (int)launch(mma_dkdv_kernel<16, uint16_t>, DKDV_ARGS(uint16_t));
      case 32: return (int)launch(mma_dkdv_kernel<32, uint16_t>, DKDV_ARGS(uint16_t));
      case 64: return (int)launch(mma_dkdv_kernel<64, uint16_t>, DKDV_ARGS(uint16_t));
      default: return (int)launch(mma_dkdv_kernel<128, uint16_t>, DKDV_ARGS(uint16_t));
    }
#undef DKDV_ARGS
  }
  using P = const float*;
  const size_t smem = fma_smem(D, 4, 2, 2 * kBlockQ);
#define DKDV_ARGS grid, kThreads, smem, s, (P)q, (P)k, (P)v, bs, (P)dout, ls, ds, (float*)dk, \
                  (float*)dv, H, group, Sq, Sk, D, scale, causal, shift
  switch (column_chunks(D)) {
    case 1: return (int)launch(fma_dkdv_kernel<1>, DKDV_ARGS);
    case 2: return (int)launch(fma_dkdv_kernel<2>, DKDV_ARGS);
    case 4: return (int)launch(fma_dkdv_kernel<4>, DKDV_ARGS);
    default: return (int)launch(fma_dkdv_kernel<8>, DKDV_ARGS);
  }
#undef DKDV_ARGS
}

}  // extern "C"
