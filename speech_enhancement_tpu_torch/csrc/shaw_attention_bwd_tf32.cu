// Fused Shaw relative-position attention backward (K2, with K3 folded in),
// fp32 on tensor cores in 3xTF32, for Hopper (head dims 16 and 32).
//
// Replaces the TPU kernels of speech_enhancement_tpu/ops/pallas_attention.py
// _attn_bwd_kernel (pallas_calls of _bwd_kernel_call at :564 and :654, with
// _recompute_softmax_ds) and _attn_bwd_drel_kernel (:616) for fp32
// operands.  With s = (q k^T + q.E[clip(i - j)]) * scale, P = softmax(s),
// G = dL/dout:
//
//   dV = P^T G   dP = G V^T   dS = P o (dP - Delta)   dp = dS * scale
//   dQ = dp K + sum_j dp[i, j] E[clip(i - j)]      dK = dp^T Q
//   dtable[clip(i - j) + max_pos] += sum_{b, h} q_i dp[i, j]
//
// at fp32 with no rounding of P or dp (the TPU kernel's fp32 numerics),
// P from the fp32 K1's row log-sum-exp (natural-log units, see
// shaw_attention_tf32.cu), Delta = rowsum(dO o O), dtable summed in fp32.
// Held to rtol 1e-4 / atol 1e-5 on dq, dk, dv and relative RMS 1e-5 on
// dtable against the plain version; tests/test_torch_attention_bwd_tf32.py
// holds a PyTorch copy of this arithmetic to the same bounds on the CPU and
// shows that one TF32 product per fp32 product would not hold them.  bf16 at
// head dims 16 and 32 is shaw_attention_bwd_mma.cu, head dims 4 and 8 are
// shaw_attention_bwd.cu; the wrapper (ops/fused_attention.py,
// kernel_instance) picks the instance.
//
// What bounds it on an H100: at the training shape B' = 808, n = 161,
// h = 4, d = 16 the eight n x n x d contractions the algorithm needs (s,
// the bias, dP, dV, dK, dQ, dQ's bias term, dtable) are 21.45 GFLOP.  Each
// fp32 product here is three TF32 products, so at the 495 TFLOP/s TF32
// rate they take at least 0.130 ms; q, k, v, out, g, lse in and dq, dk, dv
// out are 268 MB (0.080 ms at 3.35 TB/s).  The operations bound it.  The
// two passes recompute s, the bias and dP (11 contractions in all).
//
// Design: the bf16 instance's two passes and tiling (blocks of 4 warps x 16
// rows, 64-wide tiles through double-buffered cp.async, table rows in a
// 256-row ring indexed by clipped offset), taken to mma.sync.m16n8k8 TF32
// with the fp32 K1's operand handling:
// * every product is 3xTF32: each operand split into hi = tf32(x) and lo =
//   tf32(x - hi) (mma.cuh's integer rounding) where its fragment is loaded
//   (or used, see registers below), lo*hi + hi*lo + hi*hi of one k-step
//   summed by three mma into a fresh fragment and added to the running sum
//   by an fp32 add (the tensor core truncates its sums);
// * ldmatrix does not transpose 32-bit values, so every fragment is plain
//   4-byte (or 8-byte) loads from rows staged at a pitch of d + 4 floats;
// * a product whose A operand is an accumulator (P or dp) takes the keys
//   (or queries) of each k-step in the accumulator's order: lane (g, t)
//   holds columns 2t and 2t + 1 of its n8 tile, so column 2t is A column t
//   and 2t + 1 column t + 4, the C fragment is the A fragment (a0 = c0,
//   a1 = c2, a2 = c1, a3 = c3) and the B operand reads rows 2t and 2t + 1.
// * registers (ptxas reports no spills; probes/kernel_variants.py has the
//   alternatives that spilled): the operands a warp holds for a whole
//   sequence or block (Q, dO and Q^T in pass A, K and V in pass B) stay
//   unsplit, one register a value, and are split each tile where they are
//   used, behind per_tile() so that the compiler does not hoist the
//   loop-invariant splits out of the tile loop.  At d = 32 pass A takes key
//   tiles of 16 (not 64 or 32), and pass B produces dk and dv kCD = 16
//   channels at a time, one sweep over the queries each (two, each
//   recomputing S^T, its bias and dP^T), so that it holds the accumulators
//   of 16 channels.
// * Pass A, query-major (Delta, dq, dtable).  Each warp keeps its 16
//   queries' Q and dO as A fragments and Q as B fragments of dE (queries
//   along k), all loaded once per sequence.  Per key tile (the numbers
//   below are for 64 keys; at d = 32, 16 keys, 32 band rows, D' pitch 56):
//   the Shaw bias as the fp32 K1 builds it (R'[r][i] = E_band[r] . q_i for
//   the warp's 80 band rows, by mma, into the warp's shared scratch at
//   pitch 20, read at bias[i][j] = R'[63 + i - j][i]); S = Q K^T; per n8
//   tile of keys dP = dO V^T and dp = P o (dP - Delta) * scale in place of
//   S; dq += dp K.  The bias terms run the skew backwards: the warp
//   scatters its fp32 dp tile into an offset band D'[i][r], r = 63 + i - j,
//   over the scratch R' used (16 rows at pitch kDP = 88 floats, 5,632 of its
//   6,400 bytes); the 16 cells of each row that no key reaches are zeroed.
//   Then
//   dq_i += sum_r D'[i][r] E_band[r] (10 k8-steps over the band rows, rows
//   8 kb + 2t and 2t + 1 as columns t and t + 4 so that A is two 8-byte
//   loads) and dE_band = D'^T Q (5 m16 tiles of band rows, 2 k8-steps over
//   the queries), folded onto the block's band of clipped table rows as the
//   bf16 instance folds it: five lockstep steps, plain adds for unclipped
//   offsets, shared atomics only for rows 0 and 2P, one global fp32
//   atomicAdd per band entry per block at the flush.
// * Pass B, key-major (dk, dv).  A block owns 64 keys (16 per warp, K and V
//   A fragments in registers) and streams query tiles of 64 with their Q,
//   dO, lse and Delta.  It works on the transposed tile: the
//   block's bias R'_blk[r][i] = E_band[r] . q_i for its 128 band rows x 64
//   queries (each warp 32 rows) at pitch kRB = 67 floats, read at
//   bias^T[j][i] = R'_blk[63 + i - j][i]; S^T = K Q^T; P^T in place; dv +=
//   P^T dO; per n8 tile of queries dP^T = V dO^T and dp^T in place of P^T;
//   dk += dp^T Q.
// Shared-memory banks (32 of 4 bytes): staged rows at pitch d + 4 (4 mod 8)
// are read as B[k = d][n = row g] at bank g (d + 4) + t (8 distinct
// multiples of 4, + t: 32 banks) and as B[k = row 2t (+ 1)][n = column g]
// at 8t + g (+ 20 or + 4): 32 banks.  D' at pitch 88 or 56 (24 mod 32) is
// read as A rows g with columns 2t, 2t + 1 in 8-byte loads, a half-warp at
// a time: 24 g mod 32 = 0, 24, 16, 8 for g = 0..3 (and 4..7), each 8 banks
// wide, so conflict-free; and transposed, D'[8 ki + t (+ 4)][16 mt + g
// (+ 8)], at bank 24 t + g: 32 banks.  The scatter into D' (32 stores a lane per tile) has
// at most 2-way conflicts.  R'_blk's transposed read is at bank 8 t - 3 g:
// 32 banks (see shaw_attention_bwd_mma.cu).
// Shared memory at d = 16: pass A 66,560 bytes plus the table band (224
// rows x 64 bytes = 14,336 at n = 161; 65,600 at n >= 961 unclipped), 2
// blocks or 8 warps per SM at n = 161; pass B 76,288 bytes.  d = 32 doubles
// the staged rows: pass A 99,328 plus the band (n = 1281 unclipped: 230,528
// in all, one block), pass B 109,056.
// No loop here descends with min/max bounds (the nvcc 12.9 fault PERF.md
// records).
//
// The C entry points return cudaGetLastError() (or the error of an
// attribute call) after their launches or query.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 16 * kWarps;   // queries per pass-A block, per pass-B tile
constexpr int kBN = 64;            // keys per pass-A tile, per pass-B block
constexpr int kBand = kBM + kBN;   // band rows of a tile (127 used)
constexpr int kRing = 256;         // table rows kept in the ring
constexpr int kWarpBand = 80;      // pass A: 16 + 64 - 1 = 79 rows, 5 m16 tiles
constexpr int kRP = 20;            // pass A: R' row pitch in floats (as K1)
constexpr int kDP = 88;            // pass A: D' row pitch in floats
constexpr int kRB = 67;            // pass B: R'_blk row pitch in floats
constexpr int kCD = 16;            // output channels per sweep (dq, dtable; dk, dv)
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSmem = 232448;   // shared memory a block may use on an H100

template <int D>
struct Layout {
  static constexpr int kPitch = D + 4;             // floats per staged row
  static constexpr int kStage = 2 * kBN * kPitch;  // two 64-row tiles, floats
  static constexpr int kTiles = (2 * kStage + kRing * kPitch) * 4;  // bytes
  // pass A: per-warp R', later D'; the band follows
  static constexpr int kWarpScratch = kWarpBand * kRP * 4;
  static constexpr int kBytesA = kTiles + kWarps * kWarpScratch;
  // pass B: R'_blk and two stages of (lse, Delta) for 64 queries
  static constexpr int kBytesB = kTiles + kBand * kRB * 4 + 2 * 2 * kBM * 4;
  static_assert(16 * kDP * 4 <= kWarpScratch, "D' must fit in R'");
};

__device__ __forceinline__ int clip_offset(int o, int max_pos) {
  return min(max(o, -max_pos), max_pos);
}

// x, made opaque to the compiler inside a loop: a split of it there is not
// hoisted out of the loop as loop-invariant, which would keep hi and lo,
// two registers, live across the whole loop in place of x, one (at d = 32
// that spilled)
__device__ __forceinline__ float per_tile(float x) {
  asm volatile("" : "+f"(x));
  return x;
}

// the four values of an A fragment taken from an accumulator fragment c in
// its own column order (column 2t as A column t, 2t + 1 as t + 4), split
__device__ __forceinline__ void split_acc(const float (&c)[4], uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
  split_tf32(c[0], hi[0], lo[0]);
  split_tf32(c[2], hi[1], lo[1]);
  split_tf32(c[1], hi[2], lo[2]);
  split_tf32(c[3], hi[3], lo[3]);
}

// c += A B for the B fragment {row[0], row[pitch]} (rows 2t and 2t + 1 of
// a staged tile, one column), split
__device__ __forceinline__ void mma_rows(float (&c)[4], const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4], const float* row,
                                         int pitch) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(row[0], bh0, bl0);
  split_tf32(row[pitch], bh1, bl1);
  mma_3xtf32(c, ah, al, bh0, bh1, bl0, bl1);
}

// c += A B for the B fragment {row[0], row[4]} (one staged row g, columns t
// and t + 4), split
__device__ __forceinline__ void mma_cols(float (&c)[4], const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4], const float* row) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(row[0], bh0, bl0);
  split_tf32(row[4], bh1, bl1);
  mma_3xtf32(c, ah, al, bh0, bh1, bl0, bl1);
}

// Pass A: Delta, dq and the table gradient.  Block: (head, query tile of
// 64) x a group of sequences (grid-stride over the batch).
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    bwd_query_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ table,
                          const float* __restrict__ out, const float* __restrict__ g,
                          const float* __restrict__ lse, float* __restrict__ delta,
                          float* __restrict__ dq, float* __restrict__ dtable, int batch,
                          int n, int h, int q_tiles, long long q_sb, long long q_sn,
                          long long k_sb, long long k_sn, long long v_sb, long long v_sn,
                          int max_pos, float scale, float scale_log2) {
  using L = Layout<D>;
  constexpr int KS = D / 8;  // k8 steps over d
  constexpr int CH = D / 4;  // 16-byte chunks per staged row
  // keys per tile: 64, or 16 at d = 32, where 64 and 32 held more values
  // than a thread's 255 registers; the warp's band of table rows, 16 +
  // BN - 1 (WB, a whole number of m16 tiles); the D' pitch, at least WB
  // and 24 mod 32 (conflict-free reads, see the header)
  constexpr int BN = D == 32 ? 16 : kBN;
  constexpr int NT = BN / 8;  // n8 tiles of keys
  constexpr int WB = 16 + BN;
  constexpr int DP = D == 32 ? 56 : kDP;
  static_assert(WB <= kWarpBand && 16 * DP <= kWarpBand * kRP, "R' and D' fit the scratch");
  constexpr int DT = D / 8;  // n8 tiles over d
  extern __shared__ __align__(16) unsigned char smem[];
  float* stages = reinterpret_cast<float*>(smem);
  float* ring = stages + 2 * L::kStage;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  float* rs = reinterpret_cast<float*>(smem + L::kTiles + warp * L::kWarpScratch);
  float* dps = rs;  // D' over R'
  float* band = reinterpret_cast<float*>(smem + L::kBytesA);

  const int hh = blockIdx.x / q_tiles;
  const int i0 = (blockIdx.x - hh * q_tiles) * kBM;
  const int iw = i0 + 16 * warp;
  const int r0 = iw + gq, r1 = r0 + 8;
  // offsets i - j of this block run from o_lo to o_hi; their clipped rows
  // from r_lo on
  const int o_lo = i0 - (n - 1);
  const int o_hi = min(i0 + kBM, n) - 1;
  const int r_lo = clip_offset(o_lo, max_pos) + max_pos;
  const int band_rows = clip_offset(o_hi, max_pos) + max_pos - r_lo + 1;
  for (int e = threadIdx.x; e < band_rows * D; e += kThreads) band[e] = 0.f;
  const long long row_stride = static_cast<long long>(h) * D;  // out, g, dq
  auto clip = [&](int o) { return clip_offset(o, max_pos); };

  for (int b = blockIdx.y; b < batch; b += gridDim.y) {
    const float* qb = q + b * q_sb + hh * D;
    const float* kb = k + b * k_sb + hh * D;
    const float* vb = v + b * v_sb + hh * D;
    const long long ob = static_cast<long long>(b) * n * row_stride + hh * D;

    // Q and dO as A fragments, split where used (each tile), so that they
    // hold one register a value; Delta of rows r0, r1 from dO and O
    float qa[KS][4], ga[KS][4];
    float dl[2] = {0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = (e & 1) ? r1 : r0;
        const int c = 8 * ks + t + (e >> 1) * 4;
        float qv = 0.f, gv = 0.f;
        if (r < n) {
          qv = qb[r * q_sn + c];
          gv = g[ob + r * row_stride + c];
          dl[e & 1] = fmaf(gv, out[ob + r * row_stride + c], dl[e & 1]);
        }
        qa[ks][e] = qv;
        ga[ks][e] = gv;
      }
    }
    float neg_lse[2];  // -lse in log2 units; -inf for rows past n (P = 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 1);
      dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 2);
      const int row = r ? r1 : r0;
      const long long stat = (static_cast<long long>(b) * h + hh) * n + row;
      neg_lse[r] = row < n ? -lse[stat] * kLog2e : -INFINITY;
      if (row < n && t == 0) delta[stat] = dl[r];
    }

    auto load_tile = [&](int stage, int tile) {
      const int j0 = tile * BN;
      float* ks_ = stages + stage * L::kStage;
      float* vs_ = ks_ + BN * L::kPitch;
      for (int c = threadIdx.x; c < BN * CH; c += kThreads) {
        const int r = c / CH, ch = c - r * CH;
        const bool ok = j0 + r < n;
        const int j = ok ? j0 + r : 0;
        cp_async16(smem_addr(ks_ + r * L::kPitch + ch * 4), kb + j * k_sn + ch * 4, ok);
        cp_async16(smem_addr(vs_ + r * L::kPitch + ch * 4), vb + j * v_sn + ch * 4, ok);
      }
      // the band holds offsets o_l .. o_l + kBM + BN - 2; the ring already
      // has every clipped offset >= clip(o_l + BN) from the tile before
      const int o_l = i0 - j0 - (BN - 1);
      const int lo = clip(o_l);
      const int hi = tile == 0 ? clip(o_l + (kBM + BN) - 1) + 1 : clip(o_l + BN);
      for (int c = threadIdx.x; c < (hi - lo) * CH; c += kThreads) {
        const int r = c / CH, ch = c - r * CH;
        const int rel = lo + r + max_pos;
        cp_async16(smem_addr(ring + (rel & (kRing - 1)) * L::kPitch + ch * 4),
                   table + rel * D + ch * 4);
      }
      cp_async_commit();
    };

    // Q as the B operand of dE_band = D'^T Q (k = the warp's 16 queries,
    // n = channels): {Q[8 ki + t][c], Q[8 ki + t + 4][c]}, c = 8 dt + g,
    // split where used
    float qtb[2][DT][2];
#pragma unroll
    for (int ki = 0; ki < 2; ++ki)
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = iw + 8 * ki + t + 4 * half;
          qtb[ki][dt][half] = i < n ? qb[i * q_sn + 8 * dt + gq] : 0.f;
        }
    float dqa[DT][4];
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) dqa[dt][0] = dqa[dt][1] = dqa[dt][2] = dqa[dt][3] = 0.f;

    const int ntiles = (n + BN - 1) / BN;
    load_tile(0, 0);
    for (int tile = 0; tile < ntiles; ++tile) {
      const int j0 = tile * BN;
      if (tile + 1 < ntiles) {
        load_tile((tile + 1) & 1, tile + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* ks_ = stages + (tile & 1) * L::kStage;
      const float* vs_ = ks_ + BN * L::kPitch;
      const int o_w0 = iw - j0 - (BN - 1);  // offset of the warp's band row 0
      // the ring row of the warp's band row r
      auto band_row = [&](int r) {
        return ring + ((clip(o_w0 + r) + max_pos) & (kRing - 1)) * L::kPitch;
      };

      // R'[r][i] = E_band[r] . q_i over the warp's WB band rows (as K1): A =
      // band rows, B = the Q fragments (queries 0-7: {[0], [2]}, 8-15:
      // {[1], [3]})
      uint32_t qh[KS][4], ql[KS][4];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(per_tile(qa[ks][e]), qh[ks][e], ql[ks][e]);
#pragma unroll
      for (int mt = 0; mt < WB / 16; ++mt) {
        const float* e0 = band_row(16 * mt + gq);
        const float* e1 = band_row(16 * mt + gq + 8);
        float acc[2][4] = {};
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t eh[4], el[4];
          split_tf32(e0[8 * ks + t], eh[0], el[0]);
          split_tf32(e1[8 * ks + t], eh[1], el[1]);
          split_tf32(e0[8 * ks + t + 4], eh[2], el[2]);
          split_tf32(e1[8 * ks + t + 4], eh[3], el[3]);
          mma_3xtf32(acc[0], eh, el, qh[ks][0], qh[ks][2], ql[ks][0], ql[ks][2]);
          mma_3xtf32(acc[1], eh, el, qh[ks][1], qh[ks][3], ql[ks][1], ql[ks][3]);
        }
#pragma unroll
        for (int nq = 0; nq < 2; ++nq) {
          float* w = rs + (16 * mt + gq) * kRP + 8 * nq + 2 * t;
          *reinterpret_cast<float2*>(w) = make_float2(acc[nq][0], acc[nq][1]);
          *reinterpret_cast<float2*>(w + 8 * kRP) = make_float2(acc[nq][2], acc[nq][3]);
        }
      }

      // S = Q K^T: 8 n8 tiles of keys; B = K^T, {K[8 nt + g][8 ks + t], + 4}
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        const float* kr = ks_ + (8 * nt + gq) * L::kPitch + t;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) mma_cols(s[nt], qh[ks], ql[ks], kr + 8 * ks);
      }
      __syncwarp();  // R' written by the whole warp

      // per n8 tile of keys: P from the row log-sum-exp, dP = dO V^T, and
      // dp = P o (dP - Delta) * scale in place of S
      uint32_t gh[KS][4], gl[KS][4];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(per_tile(ga[ks][e]), gh[ks][e], gl[ks][e]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float dpv[4] = {0.f, 0.f, 0.f, 0.f};
        const float* vr = vs_ + (8 * nt + gq) * L::kPitch + t;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) mma_cols(dpv, gh[ks], gl[ks], vr + 8 * ks);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int il = gq + (e >> 1) * 8;
          const int jl = 8 * nt + 2 * t + (e & 1);
          const float x = s[nt][e] + rs[(BN - 1 + il - jl) * kRP + il];
          const float p = j0 + jl < n ? fast_exp2(fmaf(x, scale_log2, neg_lse[e >> 1])) : 0.f;
          s[nt][e] = p * (dpv[e] - dl[e >> 1]) * scale;
        }
      }

      // dq += dp K, 8 keys per k-step in dp's accumulator order: B =
      // {K[8 kk + 2t][8 dt + g], K[8 kk + 2t + 1][8 dt + g]}
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        uint32_t ah[4], al[4];
        split_acc(s[kk], ah, al);
        const float* kr = ks_ + (8 * kk + 2 * t) * L::kPitch + gq;
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) mma_rows(dqa[dt], ah, al, kr + 8 * dt, L::kPitch);
      }
      __syncwarp();  // every lane has read its bias from R'

      // D'[i][BN - 1 + i - j] = dp[i][j]; the 16 cells of row i no j
      // reaches (r < i and r > i + BN - 1) are zeroed
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int il = gq + (e >> 1) * 8;
          const int jl = 8 * nt + 2 * t + (e & 1);
          dps[il * DP + BN - 1 + il - jl] = s[nt][e];
        }
      }
      {
        const int il = lane & 15;
        float* row = dps + il * DP;
#pragma unroll
        for (int z = (lane >> 4) * 8; z < (lane >> 4) * 8 + 8; ++z)
          row[z < il ? z : BN + z] = 0.f;
      }
      __syncwarp();

      // dq_i += sum_r D'[i][r] E_band[r]: WB / 8 k8-steps over the band rows,
      // rows 8 kb + 2t and 2t + 1 as A columns t and t + 4
#pragma unroll 2
      for (int kb = 0; kb < WB / 8; ++kb) {
        const float2 d0 = *reinterpret_cast<const float2*>(dps + gq * DP + 8 * kb + 2 * t);
        const float2 d1 =
            *reinterpret_cast<const float2*>(dps + (gq + 8) * DP + 8 * kb + 2 * t);
        uint32_t ah[4], al[4];
        split_tf32(d0.x, ah[0], al[0]);
        split_tf32(d1.x, ah[1], al[1]);
        split_tf32(d0.y, ah[2], al[2]);
        split_tf32(d1.y, ah[3], al[3]);
        const float* e0 = band_row(8 * kb + 2 * t) + gq;
        const float* e1 = band_row(8 * kb + 2 * t + 1) + gq;
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(e0[8 * dt], bh0, bl0);
          split_tf32(e1[8 * dt], bh1, bl1);
          mma_3xtf32(dqa[dt], ah, al, bh0, bh1, bl0, bl1);
        }
      }

      // dE_band = D'^T Q, one m16 tile of band rows at a time, folded onto
      // the block's clipped rows in lockstep (as the bf16 instance): in
      // step mt warp w adds the offsets of block band rows 16 (w + mt) ..
      // + 15, which no other warp adds in that step, so an offset |o| <
      // max_pos (one table row each) takes a plain add; the two clipped end
      // rows take shared atomics, after a warp reduction when the whole m16
      // tile clips to one row.  In a tile whose whole warp band is valid and
      // unclipped (the interior tiles), band row o + max_pos - r_lo is
      // affine in the lane's row.
      const bool interior = o_w0 >= max(o_lo, 1 - max_pos) &&
                            o_w0 + WB - 1 <= min(o_hi, max_pos - 1);
      uint32_t qth[2][DT][2], qtl[2][DT][2];
#pragma unroll
      for (int ki = 0; ki < 2; ++ki)
#pragma unroll
        for (int dt = 0; dt < DT; ++dt)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            split_tf32(per_tile(qtb[ki][dt][half]), qth[ki][dt][half], qtl[ki][dt][half]);
#pragma unroll
      for (int mt = 0; mt < WB / 16; ++mt) {
        const int o_m = o_w0 + 16 * mt;
        if (interior || (o_m + 15 >= o_lo && o_m <= o_hi)) {  // some valid (i, j) there
          // A = D'^T: {D'[8 ki + t][16 mt + g], [.][+ 8], D'[8 ki + t + 4][..], [..]}
          float acc[DT][4];
#pragma unroll
          for (int dt = 0; dt < DT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
#pragma unroll
          for (int ki = 0; ki < 2; ++ki) {
            const float* d0 = dps + (8 * ki + t) * DP + 16 * mt + gq;
            uint32_t ah[4], al[4];
            split_tf32(d0[0], ah[0], al[0]);
            split_tf32(d0[8], ah[1], al[1]);
            split_tf32(d0[4 * DP], ah[2], al[2]);
            split_tf32(d0[4 * DP + 8], ah[3], al[3]);
#pragma unroll
            for (int dt = 0; dt < DT; ++dt)
              mma_3xtf32(acc[dt], ah, al, qth[ki][dt][0], qth[ki][dt][1], qtl[ki][dt][0],
                         qtl[ki][dt][1]);
          }
          if (interior) {
            float* row = band + (o_m + gq + max_pos - r_lo) * D + 2 * t;
#pragma unroll
            for (int dt = 0; dt < DT; ++dt) {
#pragma unroll
              for (int h2 = 0; h2 < 2; ++h2) {  // rows g and g + 8
                float2* cell = reinterpret_cast<float2*>(row + h2 * 8 * D + 8 * dt);
                float2 c2 = *cell;
                c2.x += acc[dt][2 * h2];
                c2.y += acc[dt][2 * h2 + 1];
                *cell = c2;
              }
            }
          } else {
            const bool one_row = o_m >= max_pos || o_m + 15 <= -max_pos;
#pragma unroll
            for (int dt = 0; dt < DT; ++dt) {
              float* col = band + 8 * dt + 2 * t;
              if (one_row) {  // rows g and g + 8 of every lane group: one table row
                float pair[2] = {acc[dt][0] + acc[dt][2], acc[dt][1] + acc[dt][3]};
#pragma unroll
                for (int c = 0; c < 2; ++c)
#pragma unroll
                  for (int m = 4; m < 32; m <<= 1)
                    pair[c] += __shfl_xor_sync(0xffffffffu, pair[c], m);
                if (gq == 0) {
                  float* row = col + (clip(o_m) + max_pos - r_lo) * D;
                  atomicAdd(row, pair[0]);
                  atomicAdd(row + 1, pair[1]);
                }
              } else {
#pragma unroll
                for (int h2 = 0; h2 < 2; ++h2) {  // rows g and g + 8, two columns each
                  const int o = o_m + gq + h2 * 8;
                  if (o >= o_lo && o <= o_hi) {
                    float* cell = col + (clip(o) + max_pos - r_lo) * D;
                    if (o > -max_pos && o < max_pos) {
                      float2 c2 = *reinterpret_cast<float2*>(cell);
                      c2.x += acc[dt][2 * h2];
                      c2.y += acc[dt][2 * h2 + 1];
                      *reinterpret_cast<float2*>(cell) = c2;
                    } else {
                      atomicAdd(cell, acc[dt][2 * h2]);
                      atomicAdd(cell + 1, acc[dt][2 * h2 + 1]);
                    }
                  }
                }
              }
            }
          }
        }
        __syncthreads();  // step mt is folded before any warp's step mt + 1
      }
    }

    float* dqb = dq + ob;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int c = 8 * dt + 2 * t;
      if (r0 < n)
        *reinterpret_cast<float2*>(dqb + r0 * row_stride + c) =
            make_float2(dqa[dt][0], dqa[dt][1]);
      if (r1 < n)
        *reinterpret_cast<float2*>(dqb + r1 * row_stride + c) =
            make_float2(dqa[dt][2], dqa[dt][3]);
    }
  }

  __syncthreads();  // every warp has folded
  for (int e = threadIdx.x; e < band_rows * D; e += kThreads)
    atomicAdd(dtable + static_cast<long long>(r_lo) * D + e, band[e]);
}

// Pass B: dk and dv.  Block: (sequence, head, key tile of 64); query
// tiles of 64 streamed.  Each warp holds 16 keys as the rows of S^T.
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    bwd_key_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ table,
                        const float* __restrict__ g, const float* __restrict__ lse,
                        const float* __restrict__ delta, float* __restrict__ dk,
                        float* __restrict__ dv, int n, int h, int k_tiles, long long q_sb,
                        long long q_sn, long long k_sb, long long k_sn, long long v_sb,
                        long long v_sn, int max_pos, float scale, float scale_log2) {
  using L = Layout<D>;
  constexpr int KS = D / 8;
  constexpr int CH = D / 4;
  constexpr int DT = kCD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* stages = reinterpret_cast<float*>(smem);
  float* ring = stages + 2 * L::kStage;
  float* rb = reinterpret_cast<float*>(smem + L::kTiles);  // R'_blk [128][kRB]
  float* stats = rb + kBand * kRB;  // per stage: lse [64], Delta [64]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;

  const int bh = blockIdx.x / k_tiles;
  const int b = bh / h, hh = bh - b * h;
  const int j0 = (blockIdx.x - bh * k_tiles) * kBN;
  const int jw = j0 + 16 * warp;
  const int c0 = jw + gq, c1 = c0 + 8;  // this lane's two keys
  const long long row_stride = static_cast<long long>(h) * D;  // g, dk, dv
  const long long ob = static_cast<long long>(b) * n * row_stride + hh * D;
  const float* qb = q + b * q_sb + hh * D;
  const float* gb = g + ob;
  const float* lb = lse + (static_cast<long long>(b) * h + hh) * n;
  const float* db = delta + (static_cast<long long>(b) * h + hh) * n;
  auto clip = [&](int o) { return clip_offset(o, max_pos); };

  // K and V of the warp's 16 keys as A fragments (rows = keys), split
  // where used (each tile), so that they hold one register a value
  float ka[KS][4], va[KS][4];
  {
    const float* kb = k + b * k_sb + hh * D;
    const float* vb = v + b * v_sb + hh * D;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = (e & 1) ? c1 : c0;
        const int c = 8 * ks + t + (e >> 1) * 4;
        ka[ks][e] = j < n ? kb[j * k_sn + c] : 0.f;
        va[ks][e] = j < n ? vb[j * v_sn + c] : 0.f;
      }
    }
  }

  // one query tile, as one cp.async group: Q and dO rows i0 .. i0 + 63, their
  // lse and Delta, and the table rows of its band that the ring lacks
  auto load_tile = [&](int stage, int tile) {
    const int i0 = tile * kBM;
    float* qs_ = stages + stage * L::kStage;
    float* gs_ = qs_ + kBM * L::kPitch;
    for (int c = threadIdx.x; c < kBM * CH; c += kThreads) {
      const int r = c / CH, ch = c - r * CH;
      const bool ok = i0 + r < n;
      const int i = ok ? i0 + r : 0;
      cp_async16(smem_addr(qs_ + r * L::kPitch + ch * 4), qb + i * q_sn + ch * 4, ok);
      cp_async16(smem_addr(gs_ + r * L::kPitch + ch * 4), gb + i * row_stride + ch * 4, ok);
    }
    float* st = stats + stage * 2 * kBM;
    for (int r = threadIdx.x; r < kBM; r += kThreads) {
      if (i0 + r < n) {
        cp_async4(smem_addr(st + r), lb + i0 + r);
        cp_async4(smem_addr(st + kBM + r), db + i0 + r);
      } else {
        st[r] = INFINITY;  // P = 0 for queries past n
        st[kBM + r] = 0.f;
      }
    }
    // the band holds offsets o_l .. o_l + 127 (rising with the tile); the
    // ring already has every clipped offset <= clip(o_l + 63)
    const int o_l = i0 - j0 - (kBN - 1);
    const int lo = tile == 0 ? clip(o_l) : clip(o_l + kBM - 1) + 1;
    const int hi = clip(o_l + kBand - 1) + 1;
    for (int c = threadIdx.x; c < (hi - lo) * CH; c += kThreads) {
      const int r = c / CH, ch = c - r * CH;
      const int rel = lo + r + max_pos;
      cp_async16(smem_addr(ring + (rel & (kRing - 1)) * L::kPitch + ch * 4),
                 table + rel * D + ch * 4);
    }
    cp_async_commit();
  };

  // one sweep over the queries per kCD output channels oc .. oc + kCD - 1
#pragma unroll 1
  for (int oc = 0; oc < D; oc += kCD) {
    float dka[DT][4], dva[DT][4];
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[dt][e] = dva[dt][e] = 0.f;

    const int ntiles = (n + kBM - 1) / kBM;
    load_tile(0, 0);
    for (int tile = 0; tile < ntiles; ++tile) {
      const int i0 = tile * kBM;
      if (tile + 1 < ntiles) {
        load_tile((tile + 1) & 1, tile + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* qs_ = stages + (tile & 1) * L::kStage;
      const float* gs_ = qs_ + kBM * L::kPitch;
      const float* st = stats + (tile & 1) * 2 * kBM;
      const int o_l = i0 - j0 - (kBN - 1);

      // R'_blk[r][i] = E_band[r] . q_i: this warp's 32 band rows x 64
      // queries; A = band rows (split once per tile), B = Q^T,
      // {Q[8 nt + g][8 ks + t], + 4}
      {
        uint32_t eh[2][KS][4], el[2][KS][4];
#pragma unroll
        for (int m2 = 0; m2 < 2; ++m2) {
          const int r = 16 * (2 * warp + m2) + gq;
          const float* e0 = ring + ((clip(o_l + r) + max_pos) & (kRing - 1)) * L::kPitch + t;
          const float* e1 = ring + ((clip(o_l + r + 8) + max_pos) & (kRing - 1)) * L::kPitch + t;
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            split_tf32(e0[8 * ks], eh[m2][ks][0], el[m2][ks][0]);
            split_tf32(e1[8 * ks], eh[m2][ks][1], el[m2][ks][1]);
            split_tf32(e0[8 * ks + 4], eh[m2][ks][2], el[m2][ks][2]);
            split_tf32(e1[8 * ks + 4], eh[m2][ks][3], el[m2][ks][3]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float* qr = qs_ + (8 * nt + gq) * L::kPitch + t;
          float acc[2][4] = {};
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(qr[8 * ks], bh0, bl0);
            split_tf32(qr[8 * ks + 4], bh1, bl1);
            mma_3xtf32(acc[0], eh[0][ks], el[0][ks], bh0, bh1, bl0, bl1);
            mma_3xtf32(acc[1], eh[1][ks], el[1][ks], bh0, bh1, bl0, bl1);
          }
#pragma unroll
          for (int m2 = 0; m2 < 2; ++m2)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              rb[(16 * (2 * warp + m2) + gq + (e >> 1) * 8) * kRB + 8 * nt + 2 * t + (e & 1)] =
                  acc[m2][e];
        }
      }

      // S^T = K Q^T: rows = the warp's keys, 8 n8 tiles of queries
      float s[8][4];
      {
        uint32_t kh[KS][4], kl[KS][4];
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(per_tile(ka[ks][e]), kh[ks][e], kl[ks][e]);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
          const float* qr = qs_ + (8 * nt + gq) * L::kPitch + t;
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) mma_cols(s[nt], kh[ks], kl[ks], qr + 8 * ks);
        }
      }
      __syncthreads();  // R'_blk written by every warp

      // P^T in place of S^T
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jl = 16 * warp + gq + (e >> 1) * 8;
          const int il = 8 * nt + 2 * t + (e & 1);
          const float x = s[nt][e] + rb[(kBN - 1 + il - jl) * kRB + il];
          s[nt][e] = j0 + jl < n ? fast_exp2(fmaf(x, scale_log2, -st[il] * kLog2e)) : 0.f;
        }
      }

      // dv += P^T dO, 8 queries per k-step in P^T's accumulator order: B =
      // {dO[8 kk + 2t][8 dt + g], dO[8 kk + 2t + 1][8 dt + g]}
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        uint32_t ah[4], al[4];
        split_acc(s[kk], ah, al);
        const float* gr = gs_ + (8 * kk + 2 * t) * L::kPitch + oc + gq;
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) mma_rows(dva[dt], ah, al, gr + 8 * dt, L::kPitch);
      }

      // per n8 tile of queries: dP^T = V dO^T and dp^T = P^T o (dP^T - Delta)
      // * scale in place of P^T
      uint32_t vh[KS][4], vl[KS][4];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(per_tile(va[ks][e]), vh[ks][e], vl[ks][e]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        float dpv[4] = {0.f, 0.f, 0.f, 0.f};
        const float* gr = gs_ + (8 * nt + gq) * L::kPitch + t;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) mma_cols(dpv, vh[ks], vl[ks], gr + 8 * ks);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int il = 8 * nt + 2 * t + (e & 1);
          s[nt][e] *= (dpv[e] - st[kBM + il]) * scale;
        }
      }

      // dk += dp^T Q, as dv
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        uint32_t ah[4], al[4];
        split_acc(s[kk], ah, al);
        const float* qr = qs_ + (8 * kk + 2 * t) * L::kPitch + oc + gq;
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) mma_rows(dka[dt], ah, al, qr + 8 * dt, L::kPitch);
      }
      __syncthreads();  // this stage and R'_blk are consumed
    }

    float* dkb = dk + ob;
    float* dvb = dv + ob;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int c = oc + 8 * dt + 2 * t;
      if (c0 < n) {
        *reinterpret_cast<float2*>(dkb + c0 * row_stride + c) = make_float2(dka[dt][0], dka[dt][1]);
        *reinterpret_cast<float2*>(dvb + c0 * row_stride + c) = make_float2(dva[dt][0], dva[dt][1]);
      }
      if (c1 < n) {
        *reinterpret_cast<float2*>(dkb + c1 * row_stride + c) = make_float2(dka[dt][2], dka[dt][3]);
        *reinterpret_cast<float2*>(dvb + c1 * row_stride + c) = make_float2(dva[dt][2], dva[dt][3]);
      }
    }
  }
}

template <int D>
int prepare() {
  static bool done = false;  // the attributes are per function; set them once
  if (done) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_query_tf32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bwd_key_tf32_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<D>::kBytesB);
  done = err == cudaSuccess;
  return static_cast<int>(err);
}

template <int D>
size_t bytes_a(int band_rows) {
  return Layout<D>::kBytesA + static_cast<size_t>(band_rows) * D * 4;
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* table,
           const float* out, const float* g, const float* lse, float* delta, float* dq,
           float* dk, float* dv, float* dtable, int batch, int n, int h, long long q_sb,
           long long q_sn, long long k_sb, long long k_sn, long long v_sb, long long v_sn,
           int max_pos, float scale, int groups, int band_rows, cudaStream_t stream) {
  // the band of clipped table rows must fit beside pass A's tiles
  const size_t smem_a = bytes_a<D>(band_rows);
  if (smem_a > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  const int err = prepare<D>();
  if (err) return err;
  const float scale_log2 = scale * kLog2e;
  const int q_tiles = (n + kBM - 1) / kBM;
  bwd_query_tf32_kernel<D><<<dim3(h * q_tiles, groups), kThreads, smem_a, stream>>>(
      q, k, v, table, out, g, lse, delta, dq, dtable, batch, n, h, q_tiles, q_sb, q_sn, k_sb,
      k_sn, v_sb, v_sn, max_pos, scale, scale_log2);
  const cudaError_t err_a = cudaGetLastError();
  if (err_a != cudaSuccess) return static_cast<int>(err_a);
  const int k_tiles = (n + kBN - 1) / kBN;
  bwd_key_tf32_kernel<D><<<batch * h * k_tiles, kThreads, Layout<D>::kBytesB, stream>>>(
      q, k, v, table, g, lse, delta, dk, dv, n, h, k_tiles, q_sb, q_sn, k_sb, k_sn, v_sb,
      v_sn, max_pos, scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int occupancy(int band_rows, int* blocks_a, int* blocks_b) {
  const size_t smem_a = bytes_a<D>(band_rows);
  if (smem_a > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  int err = prepare<D>();
  if (!err)
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_a, bwd_query_tf32_kernel<D>, kThreads, smem_a));
  if (!err)
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_b, bwd_key_tf32_kernel<D>, kThreads, Layout<D>::kBytesB));
  return err;
}

}  // namespace

// fp32 q, k, v: [batch, n, h, d] with unit stride over d and stride d over
// h; the batch and sequence strides (in elements) are multiples of 4 and
// every base pointer is 16-byte aligned.  table: [2 * max_pos + 1, d]
// contiguous fp32.  out (the forward's output), g (its gradient), dq, dk,
// dv: contiguous [batch, n, h, d] fp32, 16-byte aligned.  lse (from the
// forward) and delta (scratch): [batch, h, n] fp32.  dtable: [2 * max_pos
// + 1, d] fp32, zeroed by the caller.  groups: pass A's grid-stride over
// the batch; band_rows: the largest block band, min(64 + n - 1,
// 2 * max_pos + 1); a band whose rows do not fit in pass A's shared memory
// returns cudaErrorInvalidValue before any launch.  d is 16 or 32.
extern "C" int se_shaw_attention_bwd_tf32(
    const void* q, const void* k, const void* v, const void* table,
    const void* out, const void* g, const void* lse, void* delta, void* dq,
    void* dk, void* dv, void* dtable, int batch, int n, int h, int d,
    long long q_sb, long long q_sn, long long k_sb, long long k_sn,
    long long v_sb, long long v_sn, int max_pos, float scale, int groups,
    int band_rows, void* stream) {
  using F = const float*;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 16)
    return launch<16>(static_cast<F>(q), static_cast<F>(k), static_cast<F>(v),
                      static_cast<F>(table), static_cast<F>(out), static_cast<F>(g),
                      static_cast<F>(lse), static_cast<float*>(delta), static_cast<float*>(dq),
                      static_cast<float*>(dk), static_cast<float*>(dv),
                      static_cast<float*>(dtable), batch, n, h, q_sb, q_sn, k_sb, k_sn, v_sb,
                      v_sn, max_pos, scale, groups, band_rows, st);
  if (d == 32)
    return launch<32>(static_cast<F>(q), static_cast<F>(k), static_cast<F>(v),
                      static_cast<F>(table), static_cast<F>(out), static_cast<F>(g),
                      static_cast<F>(lse), static_cast<float*>(delta), static_cast<float*>(dq),
                      static_cast<float*>(dk), static_cast<float*>(dv),
                      static_cast<float*>(dtable), batch, n, h, q_sb, q_sn, k_sb, k_sn, v_sb,
                      v_sn, max_pos, scale, groups, band_rows, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Resident blocks of 4 warps per SM of pass A (at a block band of
// band_rows table rows) and of pass B, for head dim d, as built.
extern "C" int se_shaw_attention_bwd_tf32_occupancy(int d, int band_rows, int* blocks_a,
                                                    int* blocks_b) {
  if (d == 16) return occupancy<16>(band_rows, blocks_a, blocks_b);
  if (d == 32) return occupancy<32>(band_rows, blocks_a, blocks_b);
  return static_cast<int>(cudaErrorInvalidValue);
}
