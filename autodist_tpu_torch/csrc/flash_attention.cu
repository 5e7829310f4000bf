// Flash attention for Hopper (sm_90a): forward, ring block update, dq and
// dkdv kernels.
//
// Replaces the Pallas TPU kernels of autodist_tpu/ops/pallas/flash_attention.py:
//   forward       <- _flash_fwd         (pallas_call at :198, body _fwd_kernel :140)
//   block update  <- flash_block_update (pallas_call at :494, body _block_update_kernel :403)
//   dq            <- _dq_call           (pallas_call at :328, body _dq_kernel :264)
//   dkdv          <- _dkdv_call         (pallas_call at :367, body _dkdv_kernel :226)
// Each comes in two designs: bf16 inputs (the model's path) run on the
// tensor cores, f32 inputs on f32 FMAs (fma_*_kernel), so that f32 keeps f32
// products.  The bf16 forward and block update are one Hopper kernel
// (wgmma_fwd_kernel: wgmma fed by a TMA ring); the bf16 dq and dkdv run
// mma.sync (mma_dq_kernel, mma_dkdv_kernel).
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
// The bf16 forward (wgmma_fwd_kernel, sm_90a) works on tiles of 128 query
// rows of one head; a block of 384 threads per SM walks the tiles, the
// heaviest causal ones first.  Warpgroup 0 is the producer: after giving
// up registers (setmaxnreg) one thread issues TMA loads
// (cp.async.bulk.tensor) of each tile's Q and then of its 128-key K and V
// tiles into a ring of three stages in shared memory, K and V each with a
// "full" mbarrier and the stage with an "empty" one; it loads the next
// tile's Q once the last S of the current tile has read Q.  Warpgroups 1
// and 2 are the consumers, 64 rows each (the wgmma M).  Per key tile:
// S = Q.K^T as wgmma m64n128k16, both operands in shared memory (K-major);
// the online softmax on the S accumulator in registers; O += P.V as wgmma
// m64n64k16 with P the register A operand (bf16, rounded from the f32
// scores, as a TPU's default-precision matmul rounds) and V read MN-major
// through wgmma's transpose flag.  S of key tile j is issued with the P.V
// of tile j - 1, and the softmax of tile j runs while that P.V is in
// flight.  At the end of a tile each warpgroup writes its 64 rows into
// shared memory and one TMA store takes them to out (or to the carry's o,
// which a TMA load brought in at the start).  Tiles are read and written
// through 3-D tensor maps (D, rows, heads) with 128-byte swizzle, in boxes
// of 128 bytes a row (D = 128: two boxes a tile); TMA zero-fills past the
// end of the rows and of D and writes nothing there, so the ragged last
// tile and any D < 64 need no code.  Scores are kept in base 2: scale *
// log2(e) is folded into one multiply and the exponentials are ex2; m and
// lse are converted back to natural log at the end (the carry and the
// backward read natural log); out = o * (1 / l), the reciprocal correctly
// rounded, as the ring normalises its carry, so that a ring of one gives
// the forward's bits.  The causal and ragged masks run only on tiles that
// cross the diagonal or the end of the keys; the bias row only when there
// is one (kBias).  Without one, the row max is taken on the raw dots and
// the exponent is one FFMA, s * scale * log2(e) - m, which needs scale > 0.
// D must be a multiple of 8 with 16-byte-aligned rows (TMA's stride rule):
// the wrapper pads other D with zero columns, and turns a scale <= 0 into
// a positive one.  At D = 128 key tiles are 64 wide (the consumers'
// registers).  Measured alternatives (PERF.md, "Findings"): 64-key
// tiles at D = 64 and a block per tile in place of a block per SM were
// slower; turns between the consumer warpgroups (FlashAttention-3's
// ping-pong) gained nothing and were taken out.
//
// The bf16 backward (FlashAttention-2's register layout on mma.sync): a
// block of 4 warps takes a 64-row tile, each warp 16 rows; tiles of 64 keys
// are staged in shared memory as bf16 (rows padded by 8 elements, so
// fragment reads are free of bank conflicts).  Both products of each step
// run as mma.sync.m16n8k16 (bf16 in, f32 accumulate); the score fragments
// stay in registers, where the masking and the backward's p and ds are
// computed in f32 and repacked as the bf16 A operand of the second product.
// It does not reach the bound: tiles load synchronously, mma.sync runs at a
// fraction of wgmma's rate, and K/V are re-read from L2 by every q-tile.
//
// The f32 design stages 64x64 tiles in shared memory as f32 and multiplies
// with FMAs on the CUDA cores: 256 threads, each owning a 4x4 patch of the
// score tile and a 4 x D/16 patch of the output, odd row strides.
//
// Build (plain C interface, loaded with ctypes; sm_90a for wgmma and
// setmaxnreg; no -lcuda: the tensor-map encoder comes from the driver
// through cudaGetDriverEntryPoint):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu
// Every entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda.h>  // CUtensorMap and its enums (types only: nothing links libcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;     // f32 design: 16 x 16 threads (ty, tx)
constexpr int kMmaThreads = 128;  // bf16 design: 4 warps of 16 rows
constexpr int kMaxD = 128;
constexpr int kPld = kBlockK + 1;  // row stride of the score tile in smem
constexpr float kNegInf = -1e30f;
constexpr float kMFloor = -1e20f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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
// kBias false (no key mask, and the block update) reads no bias row.  The
// flag is a template argument: a runtime test of the pointer in the
// unrolled score loops made dq 37 % slower (chip_smoke.py, one H100 80GB
// HBM3 at 700 W).
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
template <int BQ = kBlockQ, int BK = kBlockK>
__device__ __forceinline__ int key_tiles(int q0, int Sq, int Sk, int causal, int shift) {
  int nk = (Sk + BK - 1) / BK;
  if (causal) {
    const int last_key = min(q0 + BQ, Sq) - 1 + shift;  // the last row's last key
    nk = last_key < 0 ? 0 : min(nk, last_key / BK + 1);
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
template <int DC, bool kUpdate, bool kBias>
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
  const float* bias_row = kBias ? bias + (size_t)b * Sk : nullptr;

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
        s[i][jj] = masked_score<kBias>(s[i][jj], r, k0 + tx + 16 * jj, Sk, scale, bias_row,
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
template <int DC, bool kBias>
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
  const float* bias_row = kBias ? bias + (size_t)b * Sk : nullptr;

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
            masked_score<kBias>(s[i][jj], r, k0 + tx + 16 * jj, Sk, scale, bias_row, causal, shift);
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
template <int DC, bool kBias>
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
  const float* bias_row = kBias ? bias + (size_t)b * Sk : nullptr;

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
            masked_score<kBias>(s[i][jj], r, k0 + cl, Sk, scale, bias_row, causal, shift);
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

template <int DP, bool kBias>
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
  const float* bias_row = kBias ? bias + (size_t)b * Sk : nullptr;
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
            masked_score<kBias>(s[n][e], row[h], col, Sk, scale, bias_row, causal, shift);
        // rows past Sq get exp(-1e30) = 0: a select, as in mma_dkdv_kernel
        const float p = expf(row[h] < Sq ? x - row_lse[h] : kNegInf);
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
template <int DP, typename TO, bool kBias>
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
  const float* bias_row = kBias ? bias + (size_t)b * Sk : nullptr;
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
            masked_score<kBias>(s[n][e], query, key[e >> 1], Sk, scale, bias_row, causal, shift);
        // rows past Sq get exp(-1e30) = 0: a select on the argument, not a
        // branch around expf, which ptxas made one branch region an element
        // in the no-bias copy, the exponentials one after another (dq and
        // dkdv 14 % and 19 % slower, PERF.md)
        const float p = expf(query < Sq ? x - Ls[ql] : kNegInf);
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

// ------------------------------------------------------ bf16 forward: wgmma --
// Hopper pieces, in inline PTX (sm_90a): mbarriers, TMA tile loads, wgmma
// and its shared-memory descriptors, setmaxnreg.

constexpr int kFwdBlockQ = 128;   // rows per block: two consumer warpgroups of 64
constexpr int kFwdStages = 3;     // the K/V ring
constexpr int kFwdThreads = 384;  // producer warpgroup + two consumer warpgroups
// registers a thread: 65536 / 384 at entry (what setmaxnreg trades), then
// the producer gives up 128 x (168 - 40) and the consumers take 256 x (232 - 168)
constexpr int kFwdEntryRegs = 168;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kBox = 64;          // TMA box width: 64 bf16 = the 128-byte swizzle span
constexpr long long kSpinCycles = 1ll << 34;  // ~10 s: a lost arrival traps, not hangs

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > kSpinCycles) {
      __trap();
    }
  }
}

// Box (c0, c1, c2) of a 3-D tensor map into shared memory at dst; the bytes
// count against bar's transaction count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Box (c0, c1, c2) of a 3-D tensor map from shared memory at src (the
// calling thread's bulk group; parts past the tensor's ends are not written).
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Wait until this thread's bulk stores have read their shared memory.
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// Order this thread's shared-memory writes before later TMA (async proxy) reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// wgmma descriptor of a tile as TMA writes it under 128-byte swizzle: rows
// of 128 bytes in groups of 8 rows (1024 bytes, the stride offset), start
// address and offsets in 16-byte units, layout 1 (128B swizzle) in bits 62-63.
// Both offsets are 1024: a K-major operand reads only the stride offset (its
// 16-deep k-step lies inside one 128-byte row), and every MN-major operand
// here is one 64-column box wide, so its leading offset is never reached.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N committed groups are still in flight (they finish in order).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Pin registers that an asynchronous wgmma reads or writes, so that the
// compiler moves no access to them across the fence or the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define WG_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_F16(i) WG_F4(i), WG_F4(i + 4), WG_F4(i + 8), WG_F4(i + 12)

// d (64 x N, f32) (+)= A (64 x 16) . B (16 x N): A and B bf16 in shared
// memory, both K-major; scale_d 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_F16(0), WG_F16(16)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_F16(0), WG_F16(16), WG_F16(32), WG_F16(48)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64, f32) += A (64 x 16, bf16 in registers: the mma.sync A
// fragment of each warp's 16 rows) . B (16 x 64), B MN-major in shared
// memory (the transpose flag).
__device__ __forceinline__ void wgmma_rs_tn64(float (&d)[32], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_F16(0), WG_F16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef WG_F16
#undef WG_F4

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}

// Named barrier `id` (0 is __syncthreads's) across `threads` threads.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Shared memory of the forward: Q (128 rows), then the ring's K and V
// stages, each tile DP / 64 boxes of (rows x 64) bf16 one after another;
// then each consumer warpgroup's output tile, staged for a TMA store (and
// for the block update first its o carry, loaded by TMA), in boxes of 64
// rows x 128 bytes (64 bf16 out columns, or 32 f32 carry columns); then the
// mbarriers.  Every box is 1024-byte aligned, as the 128-byte swizzle needs.
template <int DP, int BK, bool kUpdate>
struct FwdSmem {
  static constexpr int kQBytes = kFwdBlockQ * DP * 2;
  static constexpr int kTileBytes = BK * DP * 2;  // one K or one V tile
  static constexpr int kOutBoxes = DP * (kUpdate ? 4 : 2) / 128;
  static constexpr int kOutBytes = kOutBoxes * 64 * 128;  // a warpgroup's
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kFwdStages * kTileBytes;
  static constexpr int kOut = kV + kFwdStages * kTileBytes;
  // q_full, q_empty, o_full[2] (a warpgroup's carry), then k_full[],
  // v_full[], empty[] for each stage
  static constexpr int kBar = kOut + 2 * kOutBytes;
  static constexpr int kBytes = kBar + 8 * (4 + 3 * kFwdStages) + 1024;  // + alignment
};

// Byte offset of row r, columns (c, c + 1) in a warpgroup's staged output
// (elements of `bytes` bytes), swizzled as CU_TENSOR_MAP_SWIZZLE_128B lays
// out a box: the 16-byte chunk j of row r sits at chunk j ^ (r % 8), so
// the 8 rows of a fragment write 8 different banks.
__device__ __forceinline__ uint32_t staged_offset(int r, int c, int bytes) {
  const int per_box = 128 / bytes;
  const int b = (c % per_box) * bytes;
  return (c / per_box) * 64 * 128 + r * 128 + ((((b >> 4) ^ r) & 7) << 4) + (b & 15);
}

// The S accumulator as base-2 scores, s * scale * log2(e) (+ bias * log2(e)),
// and each row's max over them: s[i] is row row[(i >> 1) & 1] and key
// c0 + 8 (i / 4) + (i & 1).  kEdge: the tile crosses the diagonal or the
// end of the keys, so the causal and ragged masks apply.  kRaw (no bias, a
// positive scale): the dots stay unscaled and so does the max, which the
// scale's sign leaves where it is; the caller scales once a row.
template <bool kBias, bool kEdge, bool kRaw, int N>
__device__ __forceinline__ void scores2(float (&s)[N], float (&mx)[2], const int (&row)[2], int c0,
                                        int Sk, float scale_log2,
                                        const float* __restrict__ bias_row, int causal,
                                        int shift) {
  float part[2][4];   // four running maxima a row: short dependency chains
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int a = 0; a < 4; ++a) part[h][a] = kNegInf;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int h = (i >> 1) & 1, c = c0 + (i / 4) * 8 + (i & 1);
    if (kEdge && (c >= Sk || (causal && row[h] + shift < c)))
      s[i] = kNegInf;
    else if (!kRaw)
      s[i] = kBias ? fmaf(s[i], scale_log2, bias_row[c] * kLog2e) : s[i] * scale_log2;
    float& m = part[h][(i & 1) | ((i >> 1) & 2)];
    m = fmaxf(m, s[i]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    mx[h] = fmaxf(fmaxf(part[h][0], part[h][1]), fmaxf(part[h][2], part[h][3]));
}

// One step of the online softmax on the S accumulator of key tile k0:
// the new running max m2 (base 2), the factor corr that rescales what was
// summed before, the per-thread row sums lt, and p = exp2(s - m2) as bf16
// pairs, for key step c p[4c .. 4c + 3] being the A fragment of P.V.
// Without a bias row the exponent is one FFMA, s * scale * log2(e) - m2,
// on the raw dots (kRaw of scores2; the scale is positive).
template <bool kBias, int BK>
__device__ __forceinline__ void softmax_step(float (&s)[BK / 2], uint32_t (&p)[BK / 4],
                                             float (&m2)[2], float (&lt)[2], float (&corr)[2],
                                             const int (&row)[2], int wrow0, int k0, int t,
                                             int Sk, float scale_log2,
                                             const float* __restrict__ bias_row, int causal,
                                             int shift) {
  constexpr bool kRaw = !kBias;
  float mx[2];
  if (k0 + BK > Sk || (causal && k0 + BK - 1 > wrow0 + shift))
    scores2<kBias, true, kRaw>(s, mx, row, k0 + 2 * t, Sk, scale_log2, bias_row, causal, shift);
  else
    scores2<kBias, false, kRaw>(s, mx, row, k0 + 2 * t, Sk, scale_log2, bias_row, causal, shift);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float row_max = quad_max(mx[h]);
    const float m_new = fmaxf(m2[h], kRaw ? row_max * scale_log2 : row_max);
    corr[h] = ex2(m2[h] - m_new);
    m2[h] = m_new;
  }
  float rs[2][4] = {};   // four partial row sums a row, as the maxima
#pragma unroll
  for (int n = 0; n < BK / 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float p0 = kRaw ? ex2(fmaf(s[4 * n + 2 * h], scale_log2, -m2[h]))
                            : ex2(s[4 * n + 2 * h] - m2[h]);
      const float p1 = kRaw ? ex2(fmaf(s[4 * n + 2 * h + 1], scale_log2, -m2[h]))
                            : ex2(s[4 * n + 2 * h + 1] - m2[h]);
      rs[h][2 * (n & 1)] += p0;
      rs[h][2 * (n & 1) + 1] += p1;
      p[2 * n + h] = pack_bf16(p0, p1);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    lt[h] = lt[h] * corr[h] + ((rs[h][0] + rs[h][1]) + (rs[h][2] + rs[h][3]));
}

// The bf16 forward (kUpdate false: bias or none, out, lse) or ring block
// update (kUpdate true: the carry in and out, no bias), over tiles of 128
// query rows of one q head fold bh, the heaviest causal q-tiles first.  A
// block walks the tiles blockIdx.x, then in snake order one round of
// gridDim.x further each (one tile a block when there are fewer tiles than
// SMs).  Warpgroup 0 loads, warpgroups 1 and 2 compute; see the header.
template <int DP, int BK, bool kUpdate, bool kBias>
__global__ void __launch_bounds__(kFwdThreads, 1)
wgmma_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_o_in,
                 const __grid_constant__ CUtensorMap tm_out, const float* __restrict__ bias,
                 float* __restrict__ lse, Carry carry, int BH, int H, int group, int Sq, int Sk,
                 int D, float scale_log2, int causal, int shift) {
  using L = FwdSmem<DP, BK, kUpdate>;
  constexpr int kBoxes = DP / kBox;
  constexpr int S = kFwdStages;
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  const uint32_t base = (smem_addr(fwd_smem) + 1023u) & ~1023u;  // the swizzle's alignment
  unsigned char* const smem = fwd_smem + (base - smem_addr(fwd_smem));
  const uint32_t q_full = base + L::kBar, q_empty = q_full + 8, o_full = q_empty + 8;
  const uint32_t k_full = o_full + 16, v_full = k_full + 8 * S, empty = v_full + 8 * S;

  const int nq = (Sq + kFwdBlockQ - 1) / kFwdBlockQ;
  const int tiles = BH * nq;
  // the r-th tile of this block, or -1 past the end
  auto tile_at = [&](int r) {
    const int t = r * gridDim.x + (r % 2 ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
    return t < tiles ? t : -1;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kFwdThreads - 128);  // every consumer thread
    mbar_init(o_full, 1);
    mbar_init(o_full + 8, 1);
    for (int st = 0; st < S; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(empty + 8 * st, kFwdThreads - 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread keeps Q and the K/V ring full
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0, qn = 0;  // k-tiles and Q tiles loaded so far
      for (int r = 0, tile; (tile = tile_at(r)) >= 0; ++r) {
        const int bh = tile % BH, q0 = (nq - 1 - tile / BH) * kFwdBlockQ;
        const int nk = key_tiles<kFwdBlockQ, BK>(q0, Sq, Sk, causal, shift);
        if (nk == 0) continue;   // nothing to read: the carry passes through
        const int kvh = (bh / H) * (H / group) + (bh % H) / group;
        if (qn > 0) mbar_wait(q_empty, (qn - 1) & 1);
        mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
        for (int x = 0; x < kBoxes; ++x)
          tma_load(base + x * kFwdBlockQ * 128, &tm_q, q_full, x * kBox, q0, bh);
        ++qn;
        for (int j = 0; j < nk; ++j, ++it) {
          const int st = it % S;
          if (it >= S) mbar_wait(empty + 8 * st, (it / S - 1) & 1);
          const uint32_t k_dst = base + L::kK + st * L::kTileBytes;
          const uint32_t v_dst = base + L::kV + st * L::kTileBytes;
          mbar_expect_tx(k_full + 8 * st, L::kTileBytes);
#pragma unroll
          for (int x = 0; x < kBoxes; ++x)
            tma_load(k_dst + x * BK * 128, &tm_k, k_full + 8 * st, x * kBox, j * BK, kvh);
          mbar_expect_tx(v_full + 8 * st, L::kTileBytes);
#pragma unroll
          for (int x = 0; x < kBoxes; ++x)
            tma_load(v_dst + x * BK * 128, &tm_v, v_full + 8 * st, x * kBox, j * BK, kvh);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw takes rows [q0 + 64 cw, q0 + 64 cw + 64).
    // Key tile j's S = Q.K^T is issued before tile j-1's O += P.V, and
    // tile j's softmax runs while that product is in flight.
    setmaxnreg_inc<kConsumerRegs>();
    const int tid = threadIdx.x - 128;
    const int cw = tid / 128;
    const int warp = (tid % 128) / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const uint32_t q_addr = base + cw * 64 * 128;
    const uint32_t staged = base + L::kOut + cw * L::kOutBytes;
    const bool leader = tid % 128 == 0;   // issues the warpgroup's TMA loads and stores
    const int wbar = 1 + cw;              // the warpgroup's own named barrier
    constexpr int kOutElem = kUpdate ? 4 : 2;
    int it = 0, qn = 0;
    for (int r = 0, tile; (tile = tile_at(r)) >= 0; ++r) {
      const int bh = tile % BH, q0 = (nq - 1 - tile / BH) * kFwdBlockQ;
      const int nk = key_tiles<kFwdBlockQ, BK>(q0, Sq, Sk, causal, shift);
      const int wrow0 = q0 + cw * 64;
      const int lrow[2] = {warp * 16 + g, warp * 16 + g + 8};   // in the warpgroup's 64
      const int row[2] = {wrow0 + lrow[0], wrow0 + lrow[1]};
      const float* bias_row = kBias ? bias + (size_t)(bh / H) * Sk : nullptr;
      if (kUpdate && leader) {   // the o carry into the staging tile, once it is free
        tma_store_wait_read();
        mbar_expect_tx(o_full + 8 * cw, L::kOutBytes);
#pragma unroll
        for (int x = 0; x < L::kOutBoxes; ++x)
          tma_load(staged + x * 64 * 128, &tm_o_in, o_full + 8 * cw, x * 32, wrow0, bh);
      }

      // The carry (or the forward's start) in the accumulator's layout: for
      // 8-column chunk n of box x, o[x][4n + e] is row row[e >> 1], column
      // 64 x + 8 n + 2 t + (e & 1).  m is clamped at the floor and kept in
      // base 2; l is summed per thread (each holds a quarter of a row's
      // columns) and over the row's four threads at the end.
      float m2[2], m2_start[2], m_start[2], lt[2], corr[2];
      float o[kBoxes][32];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool carried = kUpdate && row[h] < Sq;
        const size_t rr = (size_t)bh * Sq + row[h];
        m_start[h] = carried ? fmaxf(carry.m_in[rr], kMFloor) : kMFloor;
        m2_start[h] = m2[h] = m_start[h] * kLog2e;
        lt[h] = carried && t == 0 ? carry.l_in[rr] : 0.f;
      }
      if (kUpdate) mbar_wait(o_full + 8 * cw, r & 1);
#pragma unroll
      for (int x = 0; x < kBoxes; ++x)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float2 v2 = make_float2(0.f, 0.f);
            if (kUpdate)
              v2 = *reinterpret_cast<const float2*>(
                  smem + (staged - base) + staged_offset(lrow[h], x * kBox + n * 8 + 2 * t, 4));
            o[x][4 * n + 2 * h] = v2.x;
            o[x][4 * n + 2 * h + 1] = v2.y;
          }

      if (nk > 0) {
        float s[BK / 2];
        uint32_t p[BK / 4];
        // S = Q.K^T of the key tile at ring position `at` into s (async)
        auto issue_qk = [&](int at) {
          const uint32_t k_addr = base + L::kK + (at % S) * L::kTileBytes;
#pragma unroll
          for (int kk = 0; kk < DP / 16; ++kk) {
            const int x = kk / 4, in = (kk % 4) * 32;  // box, byte offset in its 128-byte row
            wgmma_ss<BK>(s, sw128_desc(q_addr + x * kFwdBlockQ * 128 + in),
                         sw128_desc(k_addr + x * BK * 128 + in), kk);
          }
          wgmma_commit();
        };
        // O += P.V of the key tile at ring position `at` (async)
        auto issue_pv = [&](int at) {
          const uint32_t v_addr = base + L::kV + (at % S) * L::kTileBytes;
#pragma unroll
          for (int c = 0; c < BK / 16; ++c)
#pragma unroll
            for (int x = 0; x < kBoxes; ++x)
              wgmma_rs_tn64(o[x], p + 4 * c, sw128_desc(v_addr + x * BK * 128 + c * 16 * 128));
          wgmma_commit();
        };
        auto rescale = [&] {
#pragma unroll
          for (int x = 0; x < kBoxes; ++x)
#pragma unroll
            for (int i = 0; i < 32; ++i) o[x][i] *= corr[(i >> 1) & 1];
        };

        mbar_wait(q_full, qn & 1);
        mbar_wait(k_full + 8 * (it % S), (it / S) & 1);
        wgmma_fence();
        issue_qk(it);
        wgmma_wait<0>();
        fence_regs(s);
        if (nk == 1) mbar_arrive(q_empty);   // Q read for the last time
        softmax_step<kBias, BK>(s, p, m2, lt, corr, row, wrow0, 0, t, Sk, scale_log2, bias_row,
                                causal, shift);
        rescale();
        for (int j = 1; j < nk; ++j) {
          const int prev = it++;   // the tile whose P.V is pending
          mbar_wait(k_full + 8 * (it % S), (it / S) & 1);
#pragma unroll
          for (int x = 0; x < kBoxes; ++x) fence_regs(o[x]);
          fence_regs(p);
          mbar_wait(v_full + 8 * (prev % S), (prev / S) & 1);
          wgmma_fence();
          issue_qk(it);
          issue_pv(prev);
          wgmma_wait<1>();   // S of tile j (the older group) is ready
          fence_regs(s);
          if (j == nk - 1) mbar_arrive(q_empty);
          uint32_t p_next[BK / 4];
          softmax_step<kBias, BK>(s, p_next, m2, lt, corr, row, wrow0, j * BK, t, Sk, scale_log2,
                                  bias_row, causal, shift);
          wgmma_wait<0>();   // P.V of tile j - 1 is done: its stage is free
#pragma unroll
          for (int x = 0; x < kBoxes; ++x) fence_regs(o[x]);
          fence_regs(p);
          mbar_arrive(empty + 8 * (prev % S));
          rescale();
#pragma unroll
          for (int i = 0; i < BK / 4; ++i) p[i] = p_next[i];
        }
#pragma unroll
        for (int x = 0; x < kBoxes; ++x) fence_regs(o[x]);
        fence_regs(p);
        mbar_wait(v_full + 8 * (it % S), (it / S) & 1);
        wgmma_fence();
        issue_pv(it);
        wgmma_wait<0>();
#pragma unroll
        for (int x = 0; x < kBoxes; ++x) fence_regs(o[x]);
        mbar_arrive(empty + 8 * (it % S));
        ++it;
        ++qn;
      }

      // The tile's end: out = o / l (or the unnormalised carry o) through
      // the staging tile and one TMA store; lse (or m and l) stored direct.
      if (leader) tma_store_wait_read();   // the last tile's store has read it
      named_sync(wbar, 128);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float l = quad_sum(lt[h]);
        const float denom = l == 0.f ? 1.f : l;  // fully masked row -> 0
        // the reciprocal, correctly rounded, then a product: the ring's
        // o * (1 / l) of this kernel's carry, to the bit
        const float inv = kUpdate ? 1.f : __frcp_rn(denom);
#pragma unroll
        for (int x = 0; x < kBoxes; ++x)
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const float a = o[x][4 * n + 2 * h], b = o[x][4 * n + 2 * h + 1];
            unsigned char* dst =
                smem + (staged - base) + staged_offset(lrow[h], x * kBox + n * 8 + 2 * t, kOutElem);
            if (kUpdate)
              *reinterpret_cast<float2*>(dst) = make_float2(a, b);
            else
              *reinterpret_cast<uint32_t*>(dst) = pack_bf16(__fmul_rn(a, inv), __fmul_rn(b, inv));
          }
        if (row[h] >= Sq || t != 0) continue;
        const size_t rr = (size_t)bh * Sq + row[h];
        // m unchanged since entry: the entering value, bit for bit
        const float m = m2[h] == m2_start[h] ? m_start[h] : m2[h] * kLn2;
        if (kUpdate) {
          carry.m_out[rr] = m;
          carry.l_out[rr] = l;
        } else {
          lse[rr] = m + logf(denom);
        }
      }
      fence_async_smem();
      named_sync(wbar, 128);
      if (leader)
#pragma unroll
        for (int x = 0; x < L::kOutBoxes; ++x)
          tma_store(&tm_out, staged + x * 64 * 128, x * (128 / kOutElem), wrow0, bh);
    }
    if (leader) tma_store_wait_read();   // shared memory outlives the last store's reads
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

// cuTensorMapEncodeTiled from the driver, through the runtime: the library
// needs no -lcuda.  Null when the driver has none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? (EncodeTiled)p : nullptr;
  }();
  return fn;
}

// The tensor map of `heads` row-major (rows, D) matrices at ptr, bf16 or
// f32, in boxes of 128 bytes of a row (64 bf16, 32 f32) x box_rows rows
// with 128-byte swizzle; the parts of a box past the rows or past D read
// as zeros and are not written.
bool rows_map(CUtensorMap* map, const void* ptr, bool f32, int D, int rows, int heads,
              int box_rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t elem = f32 ? 4 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {D * elem, rows * D * elem};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / elem), (cuuint32_t)box_rows, 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  return encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// SMs of the current device (the persistent grid's size).
int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 1;
  return n;
}

// The bf16 forward on wgmma (see wgmma_fwd_kernel).  D % 8 == 0 and
// 16-byte-aligned q, k, v, out (or o_in, o_out): TMA's rule for the row
// stride and the base.
// Keys per tile: 128 at D <= 64; 64 at D = 128, where the accumulators of
// two 128-key tiles would not fit the consumers' registers.
template <int DP, bool kUpdate, bool kBias>
cudaError_t launch_wgmma_fwd(const void* q, const void* k, const void* v, const float* bias,
                             void* out, float* lse, Carry carry, int BH, int H, int group,
                             int Sq, int Sk, int D, float scale, int causal, int shift,
                             cudaStream_t s) {
  constexpr int BK = DP == 64 ? 128 : 64;
  const auto kernel = wgmma_fwd_kernel<DP, BK, kUpdate, kBias>;
  // setmaxnreg trades registers within a pool of 384 x kFwdEntryRegs: a
  // build that allocated fewer at entry could stall the consumers for ever
  static const int entry_regs = [] {
    cudaFuncAttributes attr;
    return cudaFuncGetAttributes(&attr, wgmma_fwd_kernel<DP, BK, kUpdate, kBias>) == cudaSuccess
               ? attr.numRegs
               : -1;
  }();
  if (entry_regs != kFwdEntryRegs) return cudaErrorInvalidKernelImage;
  // out (or the carry's o) in boxes of a warpgroup's 64 rows
  CUtensorMap tm_q, tm_k, tm_v, tm_o_in, tm_out;
  if (!rows_map(&tm_q, q, false, D, Sq, BH, kFwdBlockQ) ||
      !rows_map(&tm_k, k, false, D, Sk, BH / group, BK) ||
      !rows_map(&tm_v, v, false, D, Sk, BH / group, BK) ||
      !rows_map(&tm_out, kUpdate ? (const void*)carry.o_out : out, kUpdate, D, Sq, BH, 64) ||
      !rows_map(&tm_o_in, kUpdate ? (const void*)carry.o_in : out, kUpdate, D, Sq, BH, 64))
    return cudaErrorInvalidValue;
  const int tiles = BH * ((Sq + kFwdBlockQ - 1) / kFwdBlockQ);
  static const int sms = sm_count();
  const dim3 grid(std::min(tiles, sms));
  return launch(kernel, grid, kFwdThreads, FwdSmem<DP, BK, kUpdate>::kBytes, s, tm_q, tm_k, tm_v,
                tm_o_in, tm_out, bias, lse, carry, BH, H, group, Sq, Sk, D, scale * kLog2e,
                causal, shift);
}

// The forward kernels, as the forward (kUpdate false: bias or none, out,
// lse) or as the ring block update (kUpdate true: the carry, offsets).
template <bool kUpdate, bool kBias>
cudaError_t launch_forward(const void* q, const void* k, const void* v, const float* bias,
                           void* out, float* lse, Carry carry, int BH, int H, int group,
                           int Sq, int Sk, int D, float scale, int causal, int shift,
                           int is_bf16, cudaStream_t s) {
  if (is_bf16) {
    const bool aligned = aligned16(q) && aligned16(k) && aligned16(v) &&
                         (kUpdate ? aligned16(carry.o_in) && aligned16(carry.o_out)
                                  : aligned16(out));
    if (D % 8 || !aligned || !(scale > 0.f)) return cudaErrorInvalidValue;
#define FWD_ARGS q, k, v, bias, out, lse, carry, BH, H, group, Sq, Sk, D, scale, causal, shift, s
    return D <= 64 ? launch_wgmma_fwd<64, kUpdate, kBias>(FWD_ARGS)
                   : launch_wgmma_fwd<128, kUpdate, kBias>(FWD_ARGS);
#undef FWD_ARGS
  }
  using P = const float*;
  const dim3 grid(BH, (Sq + kBlockQ - 1) / kBlockQ);
  const size_t smem = fma_smem(D, 3, 1, 0);
#define FWD_ARGS grid, kThreads, smem, s, (P)q, (P)k, (P)v, bias, (float*)out, lse, carry, H, \
                 group, Sq, Sk, D, scale, causal, shift
  switch (column_chunks(D)) {
    case 1: return launch(fma_fwd_kernel<1, kUpdate, kBias>, FWD_ARGS);
    case 2: return launch(fma_fwd_kernel<2, kUpdate, kBias>, FWD_ARGS);
    case 4: return launch(fma_fwd_kernel<4, kUpdate, kBias>, FWD_ARGS);
    default: return launch(fma_fwd_kernel<8, kUpdate, kBias>, FWD_ARGS);
  }
#undef FWD_ARGS
}

template <bool kBias>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const float* bias,
                      const void* dout, const float* lse, const float* delta, void* dq, int BH,
                      int H, int group, int Sq, int Sk, int D, float scale, int causal,
                      int shift, int is_bf16, cudaStream_t s) {
  const dim3 grid(BH, (Sq + kBlockQ - 1) / kBlockQ);
  if (is_bf16) {
    using P = const uint16_t*;
    const int vec = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
                    aligned16(dout);
    const int DP = padded_width(D);
    const size_t smem = mma_smem(DP, 4, 0);
#define DQ_ARGS grid, kMmaThreads, smem, s, (P)q, (P)k, (P)v, bias, (P)dout, lse, delta, \
                (uint16_t*)dq, H, group, Sq, Sk, D, scale, causal, shift, vec
    switch (DP) {
      case 16: return launch(mma_dq_kernel<16, kBias>, DQ_ARGS);
      case 32: return launch(mma_dq_kernel<32, kBias>, DQ_ARGS);
      case 64: return launch(mma_dq_kernel<64, kBias>, DQ_ARGS);
      default: return launch(mma_dq_kernel<128, kBias>, DQ_ARGS);
    }
#undef DQ_ARGS
  }
  using P = const float*;
  const size_t smem = fma_smem(D, 4, 1, 0);
#define DQ_ARGS grid, kThreads, smem, s, (P)q, (P)k, (P)v, bias, (P)dout, lse, delta, \
                (float*)dq, H, group, Sq, Sk, D, scale, causal, shift
  switch (column_chunks(D)) {
    case 1: return launch(fma_dq_kernel<1, kBias>, DQ_ARGS);
    case 2: return launch(fma_dq_kernel<2, kBias>, DQ_ARGS);
    case 4: return launch(fma_dq_kernel<4, kBias>, DQ_ARGS);
    default: return launch(fma_dq_kernel<8, kBias>, DQ_ARGS);
  }
#undef DQ_ARGS
}

template <bool kBias>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v, const float* bias,
                        const void* dout, const float* lse, const float* delta, void* dk,
                        void* dv, int BH, int H, int group, int Sq, int Sk, int D, float scale,
                        int causal, int shift, int is_bf16, cudaStream_t s) {
  const dim3 grid(BH, (Sk + kBlockK - 1) / kBlockK);
  if (is_bf16) {
    using P = const uint16_t*;
    const int vec = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
                    aligned16(dout);
    const int DP = padded_width(D);
    const size_t smem = mma_smem(DP, 4, 2 * kBlockQ);
#define DKDV_ARGS(TO) grid, kMmaThreads, smem, s, (P)q, (P)k, (P)v, bias, (P)dout, lse, delta, \
                      (TO*)dk, (TO*)dv, H, group, Sq, Sk, D, scale, causal, shift, vec
    if (group > 1) {
      switch (DP) {
        case 16: return launch(mma_dkdv_kernel<16, float, kBias>, DKDV_ARGS(float));
        case 32: return launch(mma_dkdv_kernel<32, float, kBias>, DKDV_ARGS(float));
        case 64: return launch(mma_dkdv_kernel<64, float, kBias>, DKDV_ARGS(float));
        default: return launch(mma_dkdv_kernel<128, float, kBias>, DKDV_ARGS(float));
      }
    }
    switch (DP) {
      case 16: return launch(mma_dkdv_kernel<16, uint16_t, kBias>, DKDV_ARGS(uint16_t));
      case 32: return launch(mma_dkdv_kernel<32, uint16_t, kBias>, DKDV_ARGS(uint16_t));
      case 64: return launch(mma_dkdv_kernel<64, uint16_t, kBias>, DKDV_ARGS(uint16_t));
      default: return launch(mma_dkdv_kernel<128, uint16_t, kBias>, DKDV_ARGS(uint16_t));
    }
#undef DKDV_ARGS
  }
  using P = const float*;
  const size_t smem = fma_smem(D, 4, 2, 2 * kBlockQ);
#define DKDV_ARGS grid, kThreads, smem, s, (P)q, (P)k, (P)v, bias, (P)dout, lse, delta, \
                  (float*)dk, (float*)dv, H, group, Sq, Sk, D, scale, causal, shift
  switch (column_chunks(D)) {
    case 1: return launch(fma_dkdv_kernel<1, kBias>, DKDV_ARGS);
    case 2: return launch(fma_dkdv_kernel<2, kBias>, DKDV_ARGS);
    case 4: return launch(fma_dkdv_kernel<4, kBias>, DKDV_ARGS);
    default: return launch(fma_dkdv_kernel<8, kBias>, DKDV_ARGS);
  }
#undef DKDV_ARGS
}

}  // namespace

extern "C" {

// q (BH, Sq, D); k, v (BH / group, Sk, D); bias (BH / H, Sk) f32, or null
// for no key mask; out like q; lse (BH, Sq) f32.  is_bf16 selects bf16 (1)
// or f32 (0) q/k/v/out; bf16 takes D % 8 == 0, 16-byte-aligned q, k, v,
// out and a positive scale.
int flash_fwd(const void* q, const void* k, const void* v, const void* bias, void* out,
              void* lse, int BH, int H, int group, int Sq, int Sk, int D, float scale,
              int causal, int is_bf16, void* stream) {
  if (bad_shape(BH, H, group, Sq, Sk, D)) return (int)cudaErrorInvalidValue;
#define FWD_ARGS q, k, v, (const float*)bias, out, (float*)lse, Carry{}, BH, H, group, Sq, Sk, D, \
                 scale, causal, 0, is_bf16, (cudaStream_t)stream
  return (int)(bias ? launch_forward<false, true>(FWD_ARGS)
                    : launch_forward<false, false>(FWD_ARGS));
#undef FWD_ARGS
}

// The ring step: fold the block k, v (BH, Sk, D) into the carry of q (BH, Sq,
// D) at global offsets q_off, k_off.  m_in, l_in (BH, Sq) and o_in (BH, Sq,
// D) f32 in; m_out, l_out, o_out out (they may alias the inputs: each row is
// read and written by the same threads).  bf16 as flash_fwd.
int flash_block_update(const void* q, const void* k, const void* v, const void* m_in,
                       const void* l_in, const void* o_in, void* m_out, void* l_out,
                       void* o_out, int BH, int Sq, int Sk, int D, float scale, int causal,
                       int q_off, int k_off, int is_bf16, void* stream) {
  if (bad_shape(BH, 1, 1, Sq, Sk, D)) return (int)cudaErrorInvalidValue;
  const Carry carry{(const float*)m_in, (const float*)l_in, (const float*)o_in,
                    (float*)m_out,      (float*)l_out,      (float*)o_out};
  return (int)launch_forward<true, false>(q, k, v, nullptr, nullptr, nullptr, carry, BH, 1, 1,
                                          Sq, Sk, D, scale, causal, q_off - k_off, is_bf16,
                                          (cudaStream_t)stream);
}

// dout like q; lse, delta (BH, Sq) f32; dq like q; bias as flash_fwd.
// q_off, k_off: the global positions of the q and k blocks (0, 0 outside
// the ring).
int flash_dq(const void* q, const void* k, const void* v, const void* bias, const void* dout,
             const void* lse, const void* delta, void* dq, int BH, int H, int group, int Sq,
             int Sk, int D, float scale, int causal, int q_off, int k_off, int is_bf16,
             void* stream) {
  if (bad_shape(BH, H, group, Sq, Sk, D)) return (int)cudaErrorInvalidValue;
#define DQ_ARGS q, k, v, (const float*)bias, dout, (const float*)lse, (const float*)delta, dq, \
                BH, H, group, Sq, Sk, D, scale, causal, q_off - k_off, is_bf16, \
                (cudaStream_t)stream
  return (int)(bias ? launch_dq<true>(DQ_ARGS) : launch_dq<false>(DQ_ARGS));
#undef DQ_ARGS
}

// dk, dv (BH, Sk, D) per q head: like k when group == 1, f32 partials when
// group > 1 (the caller sums each group of q heads).  Bias and offsets as
// flash_dq.
int flash_dkdv(const void* q, const void* k, const void* v, const void* bias, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int BH, int H, int group,
               int Sq, int Sk, int D, float scale, int causal, int q_off, int k_off,
               int is_bf16, void* stream) {
  if (bad_shape(BH, H, group, Sq, Sk, D)) return (int)cudaErrorInvalidValue;
#define DKDV_ARGS q, k, v, (const float*)bias, dout, (const float*)lse, (const float*)delta, dk, \
                  dv, BH, H, group, Sq, Sk, D, scale, causal, q_off - k_off, is_bf16, \
                  (cudaStream_t)stream
  return (int)(bias ? launch_dkdv<true>(DKDV_ARGS) : launch_dkdv<false>(DKDV_ARGS));
#undef DKDV_ARGS
}

}  // extern "C"
