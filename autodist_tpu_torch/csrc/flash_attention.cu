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
// products.  In bf16 all three are Hopper kernels, wgmma fed by TMA rings:
// the forward and block update one (wgmma_fwd_kernel), dq
// (wgmma_dq_kernel) and dkdv (wgmma_dkdv_kernel).
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
// The bf16 backward, dq (replaces _dq_kernel) and dkdv (replaces
// _dkdv_kernel), is bound by operations: 3 and 4 products of 2 D flops a
// pair (19.6 and 26.1 us above) against 19.0 and 22.8 us of bytes.  Both
// take the forward's shape (FlashAttention-3's for the backward): a
// persistent block of 384 threads per SM walks work items heaviest first
// in snake order; warpgroup 0 gives up registers and one thread keeps TMA
// loads in flight into a 3-stage ring under full and empty mbarriers;
// warpgroups 1 and 2 run every product as wgmma, 64 rows each.  p and ds
// are recomputed in f32 registers in base 2: one FFMA, s * scale * log2(e)
// - lse * log2(e) (+ bias * log2(e)), and ex2; there is no max, so any
// sign of the scale is taken as it is.  A masked score's exponent, and
// that of a query past Sq, is -1e30 by a select, never a branch around
// ex2 (a branch made ptxas issue each exponential alone, PERF.md).  p and
// ds are packed to bf16 register A operands as the forward packs P.  The
// next tile's scores are issued with this tile's accumulating products,
// and its p and ds are computed while those run.  Tiles are read and the
// outputs written through the forward's 128-byte-swizzled tensor maps and
// staging tiles; no two blocks write the same rows, so there are no
// atomics and the results repeat bit for bit.
//   dq: an item is 128 query rows of one q head (two warpgroups of 64);
//   the producer loads Q and dO once an item and K and V tiles (128 keys
//   at D <= 64, 64 at D = 128) into the ring.  Per key tile S = Q.K^T and
//   dP = dO.V^T (both operands in shared memory, K-major), ds from the
//   row's lse and delta held in registers, dQ += dS.K with K read MN-major
//   through wgmma's transpose flag (as the forward reads V).
//   dkdv: an item is 128 keys of one q head (64 a warpgroup); the producer
//   loads K and V once an item and, from the first q-tile that sees the
//   keys, each q-tile's Q, dO (64 rows at D <= 64, 32 at D = 128, where dK
//   and dV hold 128 registers a thread) and its lse and delta rows (a 1-D
//   tensor map) into the ring.  Per q-tile the transposed products S^T =
//   K.Q^T and dP^T = V.dO^T (K, V the A operands, Q, dO the B operands),
//   p and ds with lse and delta of each column from shared memory, dV +=
//   P^T.dO and dK += dS^T.Q with dO and Q read MN-major.  Under GQA the
//   outputs are f32 partials of each q head.  K and V are released after
//   the item's last S^T and dP^T, so the next item's load overlaps the
//   last products and the epilogue; dV and dK leave through one staging
//   tile a warpgroup, one after the other.

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

// First q-tile (of BQ rows) that sees key k0 (the first key of a k-tile):
// its last row must reach k0 - shift.  At or past the last tile when no
// row sees it.
template <int BQ = kBlockQ>
__device__ __forceinline__ int first_query_tile(int k0, int causal, int shift) {
  if (!causal) return 0;
  const int need = k0 - shift - (BQ - 1);
  return need <= 0 ? 0 : (need + BQ - 1) / BQ;
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
// A warpgroup's wgmma accumulator (64 x N, f32) is four warps' mma.sync
// C fragments side by side: in warp w (g = lane / 4, t = lane % 4) element
// i is row 16 w + g + 8 ((i >> 1) & 1), column 8 (i / 4) + 2 t + (i & 1).
// The A operand that wgmma reads from registers (64 x 16 bf16) is the
// mma.sync A fragment of each warp's 16 rows: for the k-step of columns
// [16 c, 16 c + 16), registers 4 c .. 4 c + 3 hold the accumulator's bf16
// pairs (i, i + 1) at i = 8 c, 8 c + 2, 8 c + 4, 8 c + 6.  So scores
// computed in f32 feed the next product without leaving registers.

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) is the low half
  return *reinterpret_cast<uint32_t*>(&v);
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

// Box of c0.. of a 1-D tensor map (f32 rows: lse, delta) into shared memory.
__device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0)
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
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : WG_F16(0)
      : "l"(a), "l"(b), "r"(scale_d));
}

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

// ------------------------------------------------------ bf16 backward: wgmma --
// Both backward kernels have the forward's shape: a persistent block of 384
// threads per SM walks work items heaviest first, warpgroup 0 loads through
// TMA into rings under mbarriers, warpgroups 1 and 2 each own 64 rows of
// the wgmma M.  See the header.

constexpr int kBwdStages = 3;   // the ring of q-tiles (dkdv) or of K/V tiles (dq)
constexpr int kBwdKeys = 128;   // dkdv: keys a work item, 64 for each consumer warpgroup

// A warpgroup's 64 x DP f32 accumulator (DP / 64 arrays of 32 registers, in
// the layout of wgmma_fwd_kernel's o) through its staging tile as TO (bf16,
// or the f32 GQA partials) and one TMA store to rows [row0, row0 + 64) of
// head `head` of `map`.  The leader first waits until the warpgroup's last
// store has read the tile.
template <int DP, typename TO>
__device__ __forceinline__ void store_rows(const float (&acc)[DP / kBox][32], unsigned char* tile,
                                           uint32_t tile_addr, const CUtensorMap* map, int row0,
                                           int head, int warp, int g, int t, bool leader,
                                           int wbar) {
  constexpr int kElem = sizeof(TO);
  if (leader) tma_store_wait_read();
  named_sync(wbar, 128);
#pragma unroll
  for (int x = 0; x < DP / kBox; ++x)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float a = acc[x][4 * n + 2 * h], b = acc[x][4 * n + 2 * h + 1];
        unsigned char* dst =
            tile + staged_offset(warp * 16 + g + 8 * h, x * kBox + n * 8 + 2 * t, kElem);
        if constexpr (kElem == 4)
          *reinterpret_cast<float2*>(dst) = make_float2(a, b);
        else
          *reinterpret_cast<uint32_t*>(dst) = pack_bf16(a, b);
      }
  fence_async_smem();
  named_sync(wbar, 128);
  if (leader)
#pragma unroll
    for (int x = 0; x < DP * kElem / 128; ++x)
      tma_store(map, tile_addr + x * 64 * 128, x * (128 / kElem), row0, head);
}

// dq of one key tile: on the S = Q.K^T and dP = dO.V^T accumulators (row
// row[(i >> 1) & 1], key c0 + 8 (i / 4) + (i & 1) at element i), ds = p *
// (dp - delta) * scale into dp, p = exp2(s * scale * log2(e) (+ bias *
// log2(e)) - lse * log2(e)): one FFMA and ex2, so any sign of the scale.
// nl is -lse * log2(e) of each row, -1e30 past Sq.  kEdge: the tile crosses
// the diagonal or the end of the keys; a masked score's exponent becomes
// -1e30 by a select (a branch around ex2 costs, PERF.md).
template <bool kBias, bool kEdge, int N>
__device__ __forceinline__ void dq_grads(const float (&s)[N], float (&dp)[N], const int (&row)[2],
                                         int c0, int Sk, const float (&nl)[2],
                                         const float (&de)[2], float scale_log2, float scale,
                                         const float* __restrict__ bias_row, int causal,
                                         int shift) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int h = (i >> 1) & 1, c = c0 + (i / 4) * 8 + (i & 1);
    float arg;
    if (kBias) {
      const float b = !kEdge || c < Sk ? bias_row[c] : 0.f;
      arg = fmaf(s[i], scale_log2, fmaf(b, kLog2e, nl[h]));
    } else {
      arg = fmaf(s[i], scale_log2, nl[h]);
    }
    if (kEdge && (c >= Sk || (causal && row[h] + shift < c))) arg = kNegInf;
    dp[i] = ex2(arg) * (dp[i] - de[h]) * scale;
  }
}

// dkdv of one q-tile, transposed: on the S^T = K.Q^T and dP^T = V.dO^T
// accumulators (key key[(i >> 1) & 1], query q0 + 8 (i / 4) + 2 t + (i &
// 1) at element i), p into s and ds into dp, as dq_grads.  lse and delta
// of the tile's BQ queries lie in shared memory; a query past Sq takes
// -1e30 for -lse * log2(e), so p = 0 there whatever the box read.  kEdge:
// the tile crosses the causal diagonal.
template <bool kBias, bool kEdge, int BQ>
__device__ __forceinline__ void dkdv_grads(float (&s)[BQ / 2], float (&dp)[BQ / 2],
                                           const float* lse, const float* delta, int q0, int t,
                                           int Sq, const int (&key)[2], const float (&bias2)[2],
                                           float scale_log2, float scale, int shift) {
#pragma unroll
  for (int n = 0; n < BQ / 8; ++n) {
    const int c = 8 * n + 2 * t;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q = q0 + c + e;
      const float nl = q < Sq ? -lse[c + e] * kLog2e : kNegInf;
      const float de = delta[c + e];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * n + 2 * h + e;
        float arg = fmaf(s[i], scale_log2, kBias ? nl + bias2[h] : nl);
        if (kEdge && q + shift < key[h]) arg = kNegInf;
        const float p = ex2(arg);
        s[i] = p;
        dp[i] = p * (dp[i] - de) * scale;
      }
    }
  }
}

// The accumulator x (64 x N f32) as bf16 register A fragments, 4 a k-step.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 2], const float (&x)[N]) {
#pragma unroll
  for (int n = 0; n < N / 4; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) a[2 * n + h] = pack_bf16(x[4 * n + 2 * h], x[4 * n + 2 * h + 1]);
}

// The r-th work item of this block, or -1 past the end: blockIdx.x, then in
// snake order one round of gridDim.x further each (the forward's walk).
__device__ __forceinline__ int item_at(int r, int items) {
  const int i = r * gridDim.x + (r % 2 ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
  return i < items ? i : -1;
}

// Shared memory of dq: Q and dO (128 rows each), the ring's K and V stages
// (BK rows each), each in DP / 64 boxes of 128 bytes a row; each consumer
// warpgroup's dq tile, staged for a TMA store; the mbarriers.
template <int DP, int BK>
struct DqSmem {
  static constexpr int kQBytes = kFwdBlockQ * DP * 2;   // Q, or dO
  static constexpr int kTileBytes = BK * DP * 2;        // a K or a V tile
  static constexpr int kDo = kQBytes;
  static constexpr int kK = 2 * kQBytes;
  static constexpr int kV = kK + kBwdStages * kTileBytes;
  static constexpr int kOutBytes = 64 * DP * 2;         // a warpgroup's dq
  static constexpr int kOut = kV + kBwdStages * kTileBytes;
  // q_full, q_empty, then full[] (K and V) and empty[] of each stage
  static constexpr int kBar = kOut + 2 * kOutBytes;
  static constexpr int kBytes = kBar + 8 * (2 + 2 * kBwdStages) + 1024;  // + alignment
};

// The bf16 dq over tiles of 128 query rows of one q head fold bh, the
// heaviest causal tiles first; the forward's shape with other products.
// Warpgroup 0 loads Q and dO once a tile and K and V tiles into a ring;
// warpgroups 1 and 2 take 64 rows each.  Per key tile: S = Q.K^T and dP =
// dO.V^T (wgmma, both operands in shared memory), ds in registers, dQ +=
// dS.K (dS the register A operand, K read MN-major through the transpose
// flag); S and dP of key tile j are issued with the dQ product of tile
// j - 1, and tile j's ds is computed while that product runs.
template <int DP, int BK, bool kBias>
__global__ void __launch_bounds__(kFwdThreads, 1)
wgmma_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_do,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_dq, const float* __restrict__ bias,
                const float* __restrict__ lse, const float* __restrict__ delta, int BH, int H,
                int group, int Sq, int Sk, float scale_log2, float scale, int causal,
                int shift) {
  using L = DqSmem<DP, BK>;
  constexpr int kBoxes = DP / kBox;
  constexpr int S = kBwdStages;
  extern __shared__ __align__(16) unsigned char dq_smem[];
  const uint32_t base = (smem_addr(dq_smem) + 1023u) & ~1023u;  // the swizzle's alignment
  unsigned char* const smem = dq_smem + (base - smem_addr(dq_smem));
  const uint32_t q_full = base + L::kBar, q_empty = q_full + 8;
  const uint32_t full = q_empty + 8, empty = full + 8 * S;
  const int nq = (Sq + kFwdBlockQ - 1) / kFwdBlockQ;
  const int tiles = BH * nq;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kFwdThreads - 128);
    for (int st = 0; st < S; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, kFwdThreads - 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread loads each tile's Q and dO, and the K/V ring
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0, qn = 0;
      for (int r = 0, tile; (tile = item_at(r, tiles)) >= 0; ++r) {
        const int bh = tile % BH, q0 = (nq - 1 - tile / BH) * kFwdBlockQ;
        const int nk = key_tiles<kFwdBlockQ, BK>(q0, Sq, Sk, causal, shift);
        if (nk == 0) continue;   // nothing to read: the rows get zeros
        const int kvh = (bh / H) * (H / group) + (bh % H) / group;
        if (qn > 0) mbar_wait(q_empty, (qn - 1) & 1);
        mbar_expect_tx(q_full, 2 * L::kQBytes);
#pragma unroll
        for (int x = 0; x < kBoxes; ++x) {
          tma_load(base + x * kFwdBlockQ * 128, &tm_q, q_full, x * kBox, q0, bh);
          tma_load(base + L::kDo + x * kFwdBlockQ * 128, &tm_do, q_full, x * kBox, q0, bh);
        }
        ++qn;
        for (int j = 0; j < nk; ++j, ++it) {
          const int st = it % S;
          if (it >= S) mbar_wait(empty + 8 * st, (it / S - 1) & 1);
          const uint32_t bar = full + 8 * st;
          mbar_expect_tx(bar, 2 * L::kTileBytes);
#pragma unroll
          for (int x = 0; x < kBoxes; ++x) {
            tma_load(base + L::kK + st * L::kTileBytes + x * BK * 128, &tm_k, bar, x * kBox,
                     j * BK, kvh);
            tma_load(base + L::kV + st * L::kTileBytes + x * BK * 128, &tm_v, bar, x * kBox,
                     j * BK, kvh);
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw takes rows [q0 + 64 cw, q0 + 64 cw + 64)
    setmaxnreg_inc<kConsumerRegs>();
    const int tid = threadIdx.x - 128;
    const int cw = tid / 128;
    const int warp = (tid % 128) / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const uint32_t q_addr = base + cw * 64 * 128, do_addr = base + L::kDo + cw * 64 * 128;
    const uint32_t staged = base + L::kOut + cw * L::kOutBytes;
    const bool leader = tid % 128 == 0;
    const int wbar = 1 + cw;
    int it = 0, qn = 0;
    for (int r = 0, tile; (tile = item_at(r, tiles)) >= 0; ++r) {
      const int bh = tile % BH, q0 = (nq - 1 - tile / BH) * kFwdBlockQ;
      const int nk = key_tiles<kFwdBlockQ, BK>(q0, Sq, Sk, causal, shift);
      const int wrow0 = q0 + cw * 64;
      const int row[2] = {wrow0 + warp * 16 + g, wrow0 + warp * 16 + g + 8};
      const float* bias_row = kBias ? bias + (size_t)(bh / H) * Sk : nullptr;
      float nl[2], de[2];   // -lse * log2(e) (-1e30 past Sq: p = 0) and delta
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool in = row[h] < Sq;
        const size_t rr = (size_t)bh * Sq + row[h];
        nl[h] = in ? -lse[rr] * kLog2e : kNegInf;
        de[h] = in ? delta[rr] : 0.f;
      }
      float dq[kBoxes][32];
#pragma unroll
      for (int x = 0; x < kBoxes; ++x)
#pragma unroll
        for (int i = 0; i < 32; ++i) dq[x][i] = 0.f;

      if (nk > 0) {
        float s[BK / 2], dp[BK / 2];
        uint32_t da[BK / 4];
        // S = Q.K^T and dP = dO.V^T of the key tile at ring position `at`
        auto issue_sdp = [&](int at) {
          const uint32_t k_addr = base + L::kK + (at % S) * L::kTileBytes;
          const uint32_t v_addr = base + L::kV + (at % S) * L::kTileBytes;
#pragma unroll
          for (int kk = 0; kk < DP / 16; ++kk) {
            const int x = kk / 4, in = (kk % 4) * 32;  // box, byte offset in its 128-byte row
            wgmma_ss<BK>(s, sw128_desc(q_addr + x * kFwdBlockQ * 128 + in),
                         sw128_desc(k_addr + x * BK * 128 + in), kk);
          }
#pragma unroll
          for (int kk = 0; kk < DP / 16; ++kk) {
            const int x = kk / 4, in = (kk % 4) * 32;
            wgmma_ss<BK>(dp, sw128_desc(do_addr + x * kFwdBlockQ * 128 + in),
                         sw128_desc(v_addr + x * BK * 128 + in), kk);
          }
          wgmma_commit();
        };
        // dQ += dS.K of the key tile at `at` (K MN-major: the transpose flag)
        auto issue_dq = [&](int at) {
          const uint32_t k_addr = base + L::kK + (at % S) * L::kTileBytes;
#pragma unroll
          for (int c = 0; c < BK / 16; ++c)
#pragma unroll
            for (int x = 0; x < kBoxes; ++x)
              wgmma_rs_tn64(dq[x], da + 4 * c, sw128_desc(k_addr + x * BK * 128 + c * 16 * 128));
          wgmma_commit();
        };
        auto grads = [&](int j) {   // ds of key tile j into dp
          const int k0 = j * BK;
          if (k0 + BK > Sk || (causal && k0 + BK - 1 > wrow0 + shift))
            dq_grads<kBias, true>(s, dp, row, k0 + 2 * t, Sk, nl, de, scale_log2, scale,
                                  bias_row, causal, shift);
          else
            dq_grads<kBias, false>(s, dp, row, k0 + 2 * t, Sk, nl, de, scale_log2, scale,
                                   bias_row, causal, shift);
        };
        auto fence_dq = [&] {
#pragma unroll
          for (int x = 0; x < kBoxes; ++x) fence_regs(dq[x]);
          fence_regs(da);
        };

        mbar_wait(q_full, qn & 1);
        mbar_wait(full + 8 * (it % S), (it / S) & 1);
        wgmma_fence();
        issue_sdp(it);
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        if (nk == 1) mbar_arrive(q_empty);   // Q and dO read for the last time
        grads(0);
        pack_a(da, dp);
        for (int j = 1; j < nk; ++j) {
          const int prev = it++;   // the tile whose dQ product is pending
          mbar_wait(full + 8 * (it % S), (it / S) & 1);
          fence_dq();
          wgmma_fence();
          issue_sdp(it);
          issue_dq(prev);
          wgmma_wait<1>();   // S and dP of tile j (the older group) are ready
          fence_regs(s);
          fence_regs(dp);
          if (j == nk - 1) mbar_arrive(q_empty);
          grads(j);
          wgmma_wait<0>();   // dQ of tile j - 1 is done: its stage is free
          fence_dq();
          mbar_arrive(empty + 8 * (prev % S));
          pack_a(da, dp);
        }
        fence_dq();
        wgmma_fence();
        issue_dq(it);
        wgmma_wait<0>();
        fence_dq();
        mbar_arrive(empty + 8 * (it % S));
        ++it;
        ++qn;
      }
      store_rows<DP, uint16_t>(dq, smem + (staged - base), staged, &tm_dq, wrow0, bh, warp, g,
                               t, leader, wbar);
    }
    if (leader) tma_store_wait_read();   // shared memory outlives the last store's reads
  }
}

// Shared memory of dkdv: the item's K and V (128 rows each), the ring's
// stages (each a q-tile's Q and dO, BQ rows, then its lse and its delta
// boxes), each consumer warpgroup's staging tile for dK and dV in turn,
// the mbarriers.  A row box holds BQ + 4 f32 from the 16-byte boundary at
// or before the tile's first row (TMA reads a 1-D box from a 16-byte-
// aligned address); the tile's rows start (bh * Sq + q0) % 4 into it.
template <int DP, int BQ, typename TO>
struct DkdvSmem {
  static constexpr int kKVBytes = kBwdKeys * DP * 2;   // K, or V
  static constexpr int kQBytes = BQ * DP * 2;          // a q-tile's Q, or dO
  static constexpr int kRowBox = BQ + 4;               // f32 a row box
  static constexpr int kRowBytes = (kRowBox * 4 + 127) / 128 * 128;
  static constexpr int kRows = 2 * kQBytes;            // lse, then delta, in a stage
  static constexpr int kStageBytes = (2 * kQBytes + 2 * kRowBytes + 1023) / 1024 * 1024;
  static constexpr int kV = kKVBytes;
  static constexpr int kStages = 2 * kKVBytes;
  static constexpr int kOutBytes = 64 * DP * (int)sizeof(TO);   // a warpgroup's dK or dV
  static constexpr int kOut = kStages + kBwdStages * kStageBytes;
  // kv_full, kv_empty, then full[] and empty[] of each stage
  static constexpr int kBar = kOut + 2 * kOutBytes;
  static constexpr int kBytes = kBar + 8 * (2 + 2 * kBwdStages) + 1024;  // + alignment
};

// The bf16 dkdv over items of 128 keys of one q head fold bh (keys that no
// query sees first: the causal heaviest), dK and dV per q head (TO =
// float: the GQA partials).  Warpgroup 0 loads the item's K and V once and
// a ring of q-tiles (Q, dO, lse, delta); warpgroups 1 and 2 take 64 keys
// each.  Per q-tile: S^T = K.Q^T and dP^T = V.dO^T (wgmma, K and V the A
// operands, Q and dO the B operands, all K-major in shared memory), p and
// ds in registers, dV += P^T.dO and dK += dS^T.Q (register A operands, dO
// and Q read MN-major through the transpose flag); S^T and dP^T of q-tile
// j are issued with the dV and dK products of tile j - 1, and tile j's p
// and ds are computed while those run.
template <int DP, int BQ, typename TO, bool kBias>
__global__ void __launch_bounds__(kFwdThreads, 1)
wgmma_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_do,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_lse,
                  const __grid_constant__ CUtensorMap tm_delta,
                  const __grid_constant__ CUtensorMap tm_dk,
                  const __grid_constant__ CUtensorMap tm_dv, const float* __restrict__ bias,
                  int BH, int H, int group, int Sq, int Sk, float scale_log2, float scale,
                  int causal, int shift) {
  using L = DkdvSmem<DP, BQ, TO>;
  constexpr int kBoxes = DP / kBox;
  constexpr int S = kBwdStages;
  extern __shared__ __align__(16) unsigned char dkdv_smem[];
  const uint32_t base = (smem_addr(dkdv_smem) + 1023u) & ~1023u;  // the swizzle's alignment
  unsigned char* const smem = dkdv_smem + (base - smem_addr(dkdv_smem));
  const uint32_t kv_full = base + L::kBar, kv_empty = kv_full + 8;
  const uint32_t full = kv_empty + 8, empty = full + 8 * S;
  const int nkt = (Sk + kBwdKeys - 1) / kBwdKeys;
  const int nq = (Sq + BQ - 1) / BQ;
  const int items = BH * nkt;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, kFwdThreads - 128);
    for (int st = 0; st < S; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, kFwdThreads - 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread loads each item's K and V, and the q-tile ring
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0, kvn = 0;
      for (int r = 0, item; (item = item_at(r, items)) >= 0; ++r) {
        const int bh = item % BH, k0 = item / BH * kBwdKeys;
        const int i0 = first_query_tile<BQ>(k0, causal, shift);
        if (i0 >= nq) continue;   // no query sees these keys: they get zeros
        const int kvh = (bh / H) * (H / group) + (bh % H) / group;
        if (kvn > 0) mbar_wait(kv_empty, (kvn - 1) & 1);
        mbar_expect_tx(kv_full, 2 * L::kKVBytes);
#pragma unroll
        for (int x = 0; x < kBoxes; ++x) {
          tma_load(base + x * kBwdKeys * 128, &tm_k, kv_full, x * kBox, k0, kvh);
          tma_load(base + L::kV + x * kBwdKeys * 128, &tm_v, kv_full, x * kBox, k0, kvh);
        }
        ++kvn;
        for (int i = i0; i < nq; ++i, ++it) {
          const int st = it % S;
          if (it >= S) mbar_wait(empty + 8 * st, (it / S - 1) & 1);
          const uint32_t dst = base + L::kStages + st * L::kStageBytes;
          const uint32_t bar = full + 8 * st;
          mbar_expect_tx(bar, 2 * L::kQBytes + 2 * L::kRowBox * 4);
#pragma unroll
          for (int x = 0; x < kBoxes; ++x) {
            tma_load(dst + x * BQ * 128, &tm_q, bar, x * kBox, i * BQ, bh);
            tma_load(dst + L::kQBytes + x * BQ * 128, &tm_do, bar, x * kBox, i * BQ, bh);
          }
          // rows past Sq read the next head's (or zeros): their p is 0
          const int row0 = (bh * Sq + i * BQ) & ~3;
          tma_load_1d(dst + L::kRows, &tm_lse, bar, row0);
          tma_load_1d(dst + L::kRows + L::kRowBytes, &tm_delta, bar, row0);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw takes keys [k0 + 64 cw, k0 + 64 cw + 64)
    setmaxnreg_inc<kConsumerRegs>();
    const int tid = threadIdx.x - 128;
    const int cw = tid / 128;
    const int warp = (tid % 128) / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const uint32_t k_addr = base + cw * 64 * 128, v_addr = base + L::kV + cw * 64 * 128;
    const uint32_t staged = base + L::kOut + cw * L::kOutBytes;
    const bool leader = tid % 128 == 0;
    const int wbar = 1 + cw;
    int it = 0, kvn = 0;
    for (int r = 0, item; (item = item_at(r, items)) >= 0; ++r) {
      const int bh = item % BH, k0 = item / BH * kBwdKeys, kw0 = k0 + cw * 64;
      const int i0 = first_query_tile<BQ>(k0, causal, shift);
      const int key[2] = {kw0 + warp * 16 + g, kw0 + warp * 16 + g + 8};
      float bias2[2];   // bias * log2(e) of the thread's keys (rows past Sk: 0)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        bias2[h] = kBias && key[h] < Sk ? bias[(size_t)(bh / H) * Sk + key[h]] * kLog2e : 0.f;
      float dv[kBoxes][32], dk[kBoxes][32];
#pragma unroll
      for (int x = 0; x < kBoxes; ++x)
#pragma unroll
        for (int i = 0; i < 32; ++i) dv[x][i] = dk[x][i] = 0.f;

      if (i0 < nq) {
        const int n = nq - i0;
        float s[BQ / 2], dp[BQ / 2];
        uint32_t pa[BQ / 4], da[BQ / 4];
        auto stage = [&](int at) { return base + L::kStages + (at % S) * L::kStageBytes; };
        // S^T = K.Q^T and dP^T = V.dO^T of the q-tile at ring position `at`
        auto issue_sdp = [&](int at) {
          const uint32_t q_addr = stage(at), do_addr = q_addr + L::kQBytes;
#pragma unroll
          for (int kk = 0; kk < DP / 16; ++kk) {
            const int x = kk / 4, in = (kk % 4) * 32;  // box, byte offset in its 128-byte row
            wgmma_ss<BQ>(s, sw128_desc(k_addr + x * kBwdKeys * 128 + in),
                         sw128_desc(q_addr + x * BQ * 128 + in), kk);
          }
#pragma unroll
          for (int kk = 0; kk < DP / 16; ++kk) {
            const int x = kk / 4, in = (kk % 4) * 32;
            wgmma_ss<BQ>(dp, sw128_desc(v_addr + x * kBwdKeys * 128 + in),
                         sw128_desc(do_addr + x * BQ * 128 + in), kk);
          }
          wgmma_commit();
        };
        // dV += P^T.dO and dK += dS^T.Q of the q-tile at `at` (dO and Q
        // MN-major: the transpose flag)
        auto issue_dkdv = [&](int at) {
          const uint32_t q_addr = stage(at), do_addr = q_addr + L::kQBytes;
#pragma unroll
          for (int c = 0; c < BQ / 16; ++c)
#pragma unroll
            for (int x = 0; x < kBoxes; ++x) {
              wgmma_rs_tn64(dv[x], pa + 4 * c, sw128_desc(do_addr + x * BQ * 128 + c * 16 * 128));
              wgmma_rs_tn64(dk[x], da + 4 * c, sw128_desc(q_addr + x * BQ * 128 + c * 16 * 128));
            }
          wgmma_commit();
        };
        auto grads = [&](int at, int i) {   // p into s, ds into dp, of q-tile i at `at`
          const int q0 = i * BQ;
          const float* lse = reinterpret_cast<const float*>(smem + (stage(at) - base) + L::kRows) +
                             (bh * Sq + q0) % 4;
          const float* delta = lse + L::kRowBytes / 4;
          if (causal && q0 + shift < kw0 + 63)
            dkdv_grads<kBias, true, BQ>(s, dp, lse, delta, q0, t, Sq, key, bias2, scale_log2,
                                        scale, shift);
          else
            dkdv_grads<kBias, false, BQ>(s, dp, lse, delta, q0, t, Sq, key, bias2, scale_log2,
                                         scale, shift);
        };
        auto fence_dkdv = [&] {
#pragma unroll
          for (int x = 0; x < kBoxes; ++x) {
            fence_regs(dv[x]);
            fence_regs(dk[x]);
          }
          fence_regs(pa);
          fence_regs(da);
        };

        mbar_wait(kv_full, kvn & 1);
        mbar_wait(full + 8 * (it % S), (it / S) & 1);
        wgmma_fence();
        issue_sdp(it);
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        if (n == 1) mbar_arrive(kv_empty);   // K and V read for the last time
        grads(it, i0);
        pack_a(pa, s);
        pack_a(da, dp);
        for (int j = 1; j < n; ++j) {
          const int prev = it++;   // the q-tile whose dV and dK products are pending
          mbar_wait(full + 8 * (it % S), (it / S) & 1);
          fence_dkdv();
          wgmma_fence();
          issue_sdp(it);
          issue_dkdv(prev);
          wgmma_wait<1>();   // S^T and dP^T of q-tile j (the older group) are ready
          fence_regs(s);
          fence_regs(dp);
          if (j == n - 1) mbar_arrive(kv_empty);
          grads(it, i0 + j);
          wgmma_wait<0>();   // dV and dK of q-tile j - 1 are done: its stage is free
          fence_dkdv();
          mbar_arrive(empty + 8 * (prev % S));
          pack_a(pa, s);
          pack_a(da, dp);
        }
        fence_dkdv();
        wgmma_fence();
        issue_dkdv(it);
        wgmma_wait<0>();
        fence_dkdv();
        mbar_arrive(empty + 8 * (it % S));
        ++it;
        ++kvn;
      }
      unsigned char* const tile = smem + (staged - base);
      store_rows<DP, TO>(dv, tile, staged, &tm_dv, kw0, bh, warp, g, t, leader, wbar);
      store_rows<DP, TO>(dk, tile, staged, &tm_dk, kw0, bh, warp, g, t, leader, wbar);
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

// D -> columns per thread of the f32 design (16 each): 1, 2, 4 or 8.
int column_chunks(int D) { return D <= 16 ? 1 : D <= 32 ? 2 : D <= 64 ? 4 : 8; }

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

// The 1-D tensor map of n f32 at ptr (the (BH, Sq) lse and delta rows as
// one run), in boxes of `box`, each loaded from a 16-byte-aligned
// coordinate; a box past the end reads as zeros.
bool vec_map(CUtensorMap* map, const float* ptr, long long n, int box) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)n * 4};   // rank 1 reads none
  const cuuint32_t boxes[1] = {(cuuint32_t)box};
  const cuuint32_t steps[1] = {1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(ptr), dims, strides,
                boxes, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
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

// Registers a thread at entry of a kernel, -1 if unknown: setmaxnreg
// trades registers within a pool of 384 x kFwdEntryRegs, and a build that
// allocated fewer at entry could stall the consumers for ever.
template <typename Kernel>
int entry_registers(Kernel kernel) {
  cudaFuncAttributes attr;
  return cudaFuncGetAttributes(&attr, kernel) == cudaSuccess ? attr.numRegs : -1;
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
  static const int entry_regs = entry_registers(kernel);
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

// The bf16 dq on wgmma (see wgmma_dq_kernel).  D % 8 == 0 and 16-byte-
// aligned q, k, v, dout, dq (TMA's rule).  Keys per tile: 128 at D <= 64,
// 64 at D = 128 (the consumers' registers), as the forward.
template <int DP, bool kBias>
cudaError_t launch_wgmma_dq(const void* q, const void* k, const void* v, const float* bias,
                            const void* dout, const float* lse, const float* delta, void* dq,
                            int BH, int H, int group, int Sq, int Sk, int D, float scale,
                            int causal, int shift, cudaStream_t s) {
  constexpr int BK = DP == 64 ? 128 : 64;
  const auto kernel = wgmma_dq_kernel<DP, BK, kBias>;
  static const int entry_regs = entry_registers(kernel);
  if (entry_regs != kFwdEntryRegs) return cudaErrorInvalidKernelImage;
  CUtensorMap tm_q, tm_do, tm_k, tm_v, tm_dq;
  if (!rows_map(&tm_q, q, false, D, Sq, BH, kFwdBlockQ) ||
      !rows_map(&tm_do, dout, false, D, Sq, BH, kFwdBlockQ) ||
      !rows_map(&tm_k, k, false, D, Sk, BH / group, BK) ||
      !rows_map(&tm_v, v, false, D, Sk, BH / group, BK) ||
      !rows_map(&tm_dq, dq, false, D, Sq, BH, 64))
    return cudaErrorInvalidValue;
  const int tiles = BH * ((Sq + kFwdBlockQ - 1) / kFwdBlockQ);
  static const int sms = sm_count();
  return launch(kernel, dim3(std::min(tiles, sms)), kFwdThreads, DqSmem<DP, BK>::kBytes, s,
                tm_q, tm_do, tm_k, tm_v, tm_dq, bias, lse, delta, BH, H, group, Sq, Sk,
                scale * kLog2e, scale, causal, shift);
}

// The bf16 dkdv on wgmma (see wgmma_dkdv_kernel), TO = float for the GQA
// partials.  Alignment as launch_wgmma_dq, and lse, delta 16-byte-aligned
// (TMA reads them too).  q-tiles of 64 rows at D <= 64, 32 at D = 128,
// where dK and dV take 128 of the consumers' registers.
template <int DP, typename TO, bool kBias>
cudaError_t launch_wgmma_dkdv(const void* q, const void* k, const void* v, const float* bias,
                              const void* dout, const float* lse, const float* delta, void* dk,
                              void* dv, int BH, int H, int group, int Sq, int Sk, int D,
                              float scale, int causal, int shift, cudaStream_t s) {
  constexpr int BQ = DP == 64 ? 64 : 32;
  constexpr bool kF32 = sizeof(TO) == 4;
  const auto kernel = wgmma_dkdv_kernel<DP, BQ, TO, kBias>;
  static const int entry_regs = entry_registers(kernel);
  if (entry_regs != kFwdEntryRegs) return cudaErrorInvalidKernelImage;
  CUtensorMap tm_q, tm_do, tm_k, tm_v, tm_lse, tm_delta, tm_dk, tm_dv;
  if (!rows_map(&tm_q, q, false, D, Sq, BH, BQ) || !rows_map(&tm_do, dout, false, D, Sq, BH, BQ) ||
      !rows_map(&tm_k, k, false, D, Sk, BH / group, kBwdKeys) ||
      !rows_map(&tm_v, v, false, D, Sk, BH / group, kBwdKeys) ||
      !vec_map(&tm_lse, lse, (long long)BH * Sq, DkdvSmem<DP, BQ, TO>::kRowBox) ||
      !vec_map(&tm_delta, delta, (long long)BH * Sq, DkdvSmem<DP, BQ, TO>::kRowBox) ||
      !rows_map(&tm_dk, dk, kF32, D, Sk, BH, 64) || !rows_map(&tm_dv, dv, kF32, D, Sk, BH, 64))
    return cudaErrorInvalidValue;
  const int items = BH * ((Sk + kBwdKeys - 1) / kBwdKeys);
  static const int sms = sm_count();
  return launch(kernel, dim3(std::min(items, sms)), kFwdThreads, DkdvSmem<DP, BQ, TO>::kBytes, s,
                tm_q, tm_do, tm_k, tm_v, tm_lse, tm_delta, tm_dk, tm_dv, bias, BH, H, group, Sq,
                Sk, scale * kLog2e, scale, causal, shift);
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
  if (is_bf16) {
    const bool aligned =
        aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout) && aligned16(dq);
    if (D % 8 || !aligned) return cudaErrorInvalidValue;
#define DQ_ARGS q, k, v, bias, dout, lse, delta, dq, BH, H, group, Sq, Sk, D, scale, causal, \
                shift, s
    return D <= 64 ? launch_wgmma_dq<64, kBias>(DQ_ARGS) : launch_wgmma_dq<128, kBias>(DQ_ARGS);
#undef DQ_ARGS
  }
  const dim3 grid(BH, (Sq + kBlockQ - 1) / kBlockQ);
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
  if (is_bf16) {
    const bool aligned = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout) &&
                         aligned16(lse) && aligned16(delta) && aligned16(dk) && aligned16(dv);
    if (D % 8 || !aligned) return cudaErrorInvalidValue;
#define DKDV_ARGS q, k, v, bias, dout, lse, delta, dk, dv, BH, H, group, Sq, Sk, D, scale, \
                  causal, shift, s
    if (group > 1)   // f32 per-q-head partials
      return D <= 64 ? launch_wgmma_dkdv<64, float, kBias>(DKDV_ARGS)
                     : launch_wgmma_dkdv<128, float, kBias>(DKDV_ARGS);
    return D <= 64 ? launch_wgmma_dkdv<64, uint16_t, kBias>(DKDV_ARGS)
                   : launch_wgmma_dkdv<128, uint16_t, kBias>(DKDV_ARGS);
#undef DKDV_ARGS
  }
  const dim3 grid(BH, (Sk + kBlockK - 1) / kBlockK);
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
// the ring).  bf16 takes D % 8 == 0 and 16-byte-aligned q, k, v, dout, dq
// and any scale.
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
// group > 1 (the caller sums each group of q heads).  Bias, offsets and
// bf16 as flash_dq, and 16-byte-aligned lse, delta, dk, dv.
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
