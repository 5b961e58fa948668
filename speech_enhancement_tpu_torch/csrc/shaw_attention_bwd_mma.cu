// Fused Shaw relative-position attention backward (K2, with K3 folded in),
// bf16 on tensor cores, for Hopper (head dims 16 and 32).
//
// Replaces the TPU kernels of speech_enhancement_tpu/ops/pallas_attention.py
// _attn_bwd_kernel (pallas_calls of _bwd_kernel_call at :564 and :654) and
// _attn_bwd_drel_kernel (:616) for bf16 operands.  The formulas and the
// numerics are those of shaw_attention_bwd.cu (the CUDA-core instance,
// which keeps fp32 and bf16 at d 4 and 8):
//
//   dV = P^T G (P rounded to bf16)   dP = G V^T   dS = P o (dP - Delta)
//   dp = dS * scale, rounded to bf16
//   dQ = dp K + sum_j dp[i, j] E[clip(i - j)]      dK = dp^T Q
//   dtable[clip(i - j) + max_pos] += sum_{b, h} q_i dp[i, j]
//
// with P from K1's row log-sum-exp (exp2 of s * scale * log2(e) - lse *
// log2(e)), Delta = rowsum(dO o O), fp32 accumulators, all products on
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate).
//
// What bounds it on an H100: at B' = 3232 n = 321 h = 4 d = 16 its ten
// n x n x d contractions (s, the bias, dP in each pass; dV, dK, dQ and its
// bias term, dtable) are 0.34 TFLOP (0.35 ms at 989 TFLOP/s); the two
// passes' 2 n^2 B h exponentials (2.7 G) take about 0.6 ms on the
// special-function units; q, k, v, out, g in and dq, dk, dv out are 0.9
// GB (0.27 ms).  So, as K1, the exp unit and the mma issue rate bound it.
//
// Design: two passes in FlashAttention-2's layout, no atomics on dq, dk,
// dv; K1's tiling (blocks of 4 warps x 16 rows, 64-wide tiles through
// double-buffered cp.async, table rows in a 256-row ring indexed by
// clipped offset, see shaw_attention_mma.cu).
// * Pass A, query-major (Delta, dq, dtable).  Per key tile a warp builds
//   its Shaw bias as K1 does (R' = E_band Q^T by mma into shared memory,
//   read at bias[i][j] = R'[63 + i - j][i]), then S = Q K^T, P,
//   dP = dO V^T, dS and dp (bf16, straight into A fragments), and
//   dq += dp K (K through ldmatrix.trans).  The bias terms run the skew
//   backwards: the warp scatters its dp tile (16 queries x 64 keys) into an
//   offset band D'[i][r], r = 63 + i - j, bf16, pitch kDP = 88 (rows 16-byte
//   aligned for ldmatrix; the scattered 2-byte writes have at most 2-way
//   bank conflicts), over the shared memory R' used.  For a fixed i each j
//   is a distinct r, so nothing collides; the 16 cells of each row that no
//   j reaches are zeroed.  Then dq_i += sum_r D'[i][r] E_band[r] (m16 x
//   k80 x n d; E_band through ldmatrix.trans from the ring) and
//   dE_band = D'^T Q (m80 x k16 x n d; D' through ldmatrix.trans, Q as B
//   fragments loaded once per sequence).  dE_band is folded onto the
//   block's band of clipped table rows in five lockstep steps (in step mt
//   warp w owns block band rows 16 (w + mt) .. + 15), with plain adds for
//   unclipped offsets and shared atomics only for the two clipped rows 0
//   and 2P, which collect many offsets; a block loops over a group of
//   sequences before it flushes its band with one fp32 atomicAdd per
//   entry into dtable, as the CUDA-core instance does.
// * Pass B, key-major (dk, dv).  A block owns 64 keys (16 per warp) and
//   streams query tiles of 64 with their Q, dO, lse and Delta.  It works
//   on the transposed tile (keys as rows): S^T = K Q^T and dP^T = V dO^T
//   with K, V fragments held in registers, so P^T and dp^T come out of
//   the accumulators in the A layout of dv += P^T dO and dk += dp^T Q
//   (dO, Q through ldmatrix.trans).  The bias of the transposed tile needs
//   q_i along the columns, so the block builds R'_blk[r][i] = E_band[r] q_i
//   for its 128 band rows x 64 queries (each warp 32 rows, 16 mma at d 16)
//   and reads bias^T[j][i] = R'_blk[63 + i - j][i]; its pitch kRB = 67
//   floats makes that read conflict-free (bank 8 t - 3 g).
//
// The C entry points return cudaGetLastError() (or the error of an
// attribute call) after their launches or query.

#include <cuda_bf16.h>
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
constexpr int kDP = 88;            // pass A: D' row pitch in bf16
constexpr int kRB = 67;            // pass B: R'_blk row pitch in floats
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSmem = 232448;   // shared memory a block may use on an H100

template <int D>
struct Layout {
  static constexpr int kPitch = D + 8;             // bf16 per staged row
  static constexpr int kStage = 2 * kBN * kPitch;  // two 64-row tiles
  static constexpr int kTiles = (2 * kStage + kRing * kPitch) * 2;  // bytes
  // pass A: per-warp R' (fp32), later D' (bf16); the band follows
  static constexpr int kWarpScratch = kWarpBand * kRP * 4;
  static constexpr int kBytesA = kTiles + kWarps * kWarpScratch;
  // pass B: R'_blk and two stages of (lse, Delta) for 64 queries
  static constexpr int kBytesB = kTiles + kBand * kRB * 4 + 2 * 2 * kBM * 4;
  static_assert(16 * kDP * 2 <= kWarpScratch, "D' must fit in R'");
};

__device__ __forceinline__ int clip_offset(int o, int max_pos) {
  return min(max(o, -max_pos), max_pos);
}

// the bf16 element at row i, column c of a [rows, n, h, D] tensor, or 0
__device__ __forceinline__ uint16_t load_bits(const __nv_bfloat16* p, bool ok) {
  return ok ? *reinterpret_cast<const uint16_t*>(p) : uint16_t(0);
}

__device__ __forceinline__ uint32_t pair_bits(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// Pass A: Delta, dq and the table gradient.  Block: (head, query tile of
// 64) x a group of sequences (grid-stride over the batch).
template <int D>
__global__ void __launch_bounds__(kThreads, D == 16 ? 3 : 2)
    bwd_query_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ table,
                         const __nv_bfloat16* __restrict__ out,
                         const __nv_bfloat16* __restrict__ g,
                         const float* __restrict__ lse, float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, float* __restrict__ dtable,
                         int batch, int n, int h, int q_tiles, long long q_sb,
                         long long q_sn, long long k_sb, long long k_sn,
                         long long v_sb, long long v_sn, int max_pos, float scale,
                         float scale_log2) {
  using L = Layout<D>;
  constexpr int KS = D / 16;  // k16 steps over d
  constexpr int CH = D / 8;   // 16-byte chunks per staged row
  constexpr int DT = D / 8;   // n8 tiles over d
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ring = stages + 2 * L::kStage;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  float* rs = reinterpret_cast<float*>(smem + L::kTiles + warp * L::kWarpScratch);
  __nv_bfloat16* dpb = reinterpret_cast<__nv_bfloat16*>(rs);  // D' over R'
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
    const __nv_bfloat16* qb = q + b * q_sb + hh * D;
    const __nv_bfloat16* kb = k + b * k_sb + hh * D;
    const __nv_bfloat16* vb = v + b * v_sb + hh * D;
    const long long ob = static_cast<long long>(b) * n * row_stride + hh * D;

    // Q and dO as A fragments; Delta of rows r0, r1 from dO and O
    uint32_t qa[KS][4], ga[KS][4];
    float dl[2] = {0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int c = 16 * ks + 2 * t;
      qa[ks][0] = r0 < n ? load_pair(qb + r0 * q_sn + c) : 0u;
      qa[ks][1] = r1 < n ? load_pair(qb + r1 * q_sn + c) : 0u;
      qa[ks][2] = r0 < n ? load_pair(qb + r0 * q_sn + c + 8) : 0u;
      qa[ks][3] = r1 < n ? load_pair(qb + r1 * q_sn + c + 8) : 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = (e & 1) ? r1 : r0;
        const int cc = c + (e >> 1) * 8;
        ga[ks][e] = 0u;
        if (r < n) {
          ga[ks][e] = load_pair(g + ob + r * row_stride + cc);
          const float2 gv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ga[ks][e]));
          const float2 ov = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(out + ob + r * row_stride + cc));
          dl[e & 1] = fmaf(gv.x, ov.x, fmaf(gv.y, ov.y, dl[e & 1]));
        }
      }
    }
    // Q as the B operand of dE_band = D'^T Q (k = the warp's 16 queries,
    // n = channels): {Q[2t][c], Q[2t + 1][c]} and {Q[2t + 8][c], Q[2t + 9][c]}
    uint32_t qt[DT][2];
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int c = 8 * dt + gq;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = iw + 2 * t + 8 * half;
        qt[dt][half] = pair_bits(load_bits(qb + i * q_sn + c, i < n),
                                 load_bits(qb + (i + 1) * q_sn + c, i + 1 < n));
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
      const int j0 = tile * kBN;
      __nv_bfloat16* ks_ = stages + stage * L::kStage;
      __nv_bfloat16* vs_ = ks_ + kBN * L::kPitch;
      for (int c = threadIdx.x; c < kBN * CH; c += kThreads) {
        const int r = c / CH, ch = c - r * CH;
        const bool ok = j0 + r < n;
        const int j = ok ? j0 + r : 0;
        cp_async16(smem_addr(ks_ + r * L::kPitch + ch * 8), kb + j * k_sn + ch * 8, ok);
        cp_async16(smem_addr(vs_ + r * L::kPitch + ch * 8), vb + j * v_sn + ch * 8, ok);
      }
      // the band holds offsets o_l .. o_l + 127; the ring already has
      // every clipped offset >= clip(o_l + 64) from the tile before
      const int o_l = i0 - j0 - (kBN - 1);
      const int lo = clip(o_l);
      const int hi = tile == 0 ? clip(o_l + kBand - 1) + 1 : clip(o_l + kBN);
      for (int c = threadIdx.x; c < (hi - lo) * CH; c += kThreads) {
        const int r = c / CH, ch = c - r * CH;
        const int rel = lo + r + max_pos;
        cp_async16(smem_addr(ring + (rel & (kRing - 1)) * L::kPitch + ch * 8),
                   table + rel * D + ch * 8);
      }
      cp_async_commit();
    };

    float dqa[DT][4];
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) dqa[dt][0] = dqa[dt][1] = dqa[dt][2] = dqa[dt][3] = 0.f;

    const int ntiles = (n + kBN - 1) / kBN;
    load_tile(0, 0);
    for (int tile = 0; tile < ntiles; ++tile) {
      const int j0 = tile * kBN;
      if (tile + 1 < ntiles) {
        load_tile((tile + 1) & 1, tile + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const __nv_bfloat16* ks_ = stages + (tile & 1) * L::kStage;
      const __nv_bfloat16* vs_ = ks_ + kBN * L::kPitch;
      const int o_w0 = iw - j0 - (kBN - 1);  // offset of the warp's band row 0
      // this lane's ldmatrix row within an m16 (or k16) tile
      const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;

      // R'[r][i] = E_band[r] . q_i over the warp's 80 band rows (as K1)
#pragma unroll
      for (int mt = 0; mt < kWarpBand / 16; ++mt) {
        float acc[2][4] = {};
        const int slot = (clip(o_w0 + 16 * mt + lrow) + max_pos) & (kRing - 1);
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t ea[4];
          ldmatrix_x4(ea, smem_addr(ring + slot * L::kPitch + 16 * ks + (lane >> 4) * 8));
          mma(acc[0], ea, qa[ks][0], qa[ks][2]);
          mma(acc[1], ea, qa[ks][1], qa[ks][3]);
        }
#pragma unroll
        for (int nq = 0; nq < 2; ++nq) {
          float* w = rs + (16 * mt + gq) * kRP + 8 * nq + 2 * t;
          *reinterpret_cast<float2*>(w) = make_float2(acc[nq][0], acc[nq][1]);
          *reinterpret_cast<float2*>(w + 8 * kRP) = make_float2(acc[nq][2], acc[nq][3]);
        }
      }

      // S = Q K^T and dP = dO V^T: 8 n8 tiles of keys each
      float s[8][4], dpv[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dpv[nt][e] = 0.f;
#pragma unroll
      for (int kp = 0; kp < 4; ++kp) {
        const int row = 16 * kp + (lane & 7) + (lane >> 4) * 8;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const int col = 16 * ks + ((lane >> 3) & 1) * 8;
          uint32_t kf[4], vf[4];
          ldmatrix_x4(kf, smem_addr(ks_ + row * L::kPitch + col));
          ldmatrix_x4(vf, smem_addr(vs_ + row * L::kPitch + col));
          mma(s[2 * kp], qa[ks], kf[0], kf[1]);
          mma(s[2 * kp + 1], qa[ks], kf[2], kf[3]);
          mma(dpv[2 * kp], ga[ks], vf[0], vf[1]);
          mma(dpv[2 * kp + 1], ga[ks], vf[2], vf[3]);
        }
      }
      __syncwarp();  // R' written by the whole warp

      // P from the row log-sum-exp, dS, dp = dS * scale in bf16 A fragments
      uint32_t dpa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float dpf[8];
#pragma unroll
        for (int e8 = 0; e8 < 8; ++e8) {
          const int nt = 2 * kk + (e8 >> 2), e = e8 & 3;
          const int il = gq + (e >> 1) * 8;
          const int jl = 8 * nt + 2 * t + (e & 1);
          const float x = s[nt][e] + rs[(kBN - 1 + il - jl) * kRP + il];
          const float p = j0 + jl < n ? fast_exp2(fmaf(x, scale_log2, neg_lse[e >> 1])) : 0.f;
          dpf[e8] = p * (dpv[nt][e] - dl[e >> 1]) * scale;
        }
        dpa[kk][0] = pack_bf16(dpf[0], dpf[1]);
        dpa[kk][1] = pack_bf16(dpf[2], dpf[3]);
        dpa[kk][2] = pack_bf16(dpf[4], dpf[5]);
        dpa[kk][3] = pack_bf16(dpf[6], dpf[7]);
      }

      // dq += dp K, 16 keys per k-step; K through ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t kf[4];
          ldmatrix_x4_trans(kf, smem_addr(ks_ + (16 * kk + lrow) * L::kPitch + 16 * dp +
                                          (lane >> 4) * 8));
          mma(dqa[2 * dp], dpa[kk], kf[0], kf[1]);
          mma(dqa[2 * dp + 1], dpa[kk], kf[2], kf[3]);
        }
      }
      __syncwarp();  // every lane has read its bias from R'

      // D'[i][63 + i - j] = dp[i][j]; the 16 cells of row i no j reaches
      // (r < i and r > i + 63) are zeroed
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int reg = 0; reg < 4; ++reg) {
          const int il = gq + (reg & 1) * 8;
          const int jl = 8 * (2 * kk + (reg >> 1)) + 2 * t;
          const uint32_t pr = dpa[kk][reg];
          uint16_t* row = reinterpret_cast<uint16_t*>(dpb + il * kDP + kBN - 1 + il - jl);
          row[0] = static_cast<uint16_t>(pr & 0xffffu);  // key jl
          row[-1] = static_cast<uint16_t>(pr >> 16);     // key jl + 1
        }
      }
      {
        const int il = lane & 15;
        uint16_t* row = reinterpret_cast<uint16_t*>(dpb + il * kDP);
#pragma unroll
        for (int z = (lane >> 4) * 8; z < (lane >> 4) * 8 + 8; ++z)
          row[z < il ? z : kBN + z] = 0;
      }
      __syncwarp();

      // dq_i += sum_r D'[i][r] E_band[r]: 5 k-steps over the band rows
#pragma unroll
      for (int kb5 = 0; kb5 < kWarpBand / 16; ++kb5) {
        uint32_t da[4];
        ldmatrix_x4(da, smem_addr(dpb + lrow * kDP + 16 * kb5 + (lane >> 4) * 8));
        const int slot = (clip(o_w0 + 16 * kb5 + lrow) + max_pos) & (kRing - 1);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t ef[4];
          ldmatrix_x4_trans(ef, smem_addr(ring + slot * L::kPitch + 16 * dp + (lane >> 4) * 8));
          mma(dqa[2 * dp], da, ef[0], ef[1]);
          mma(dqa[2 * dp + 1], da, ef[2], ef[3]);
        }
      }

      // dE_band = D'^T Q, one m16 tile of band rows at a time, folded onto
      // the block's clipped rows in lockstep: in step mt warp w adds the
      // offsets of block band rows 16 (w + mt) .. + 15, which no other
      // warp adds in that step, so an offset |o| < max_pos (one table row
      // each) takes a plain add; the two clipped end rows take shared
      // atomics, after a warp reduction when the whole m16 tile clips to
      // one row.  (Float atomics on shared memory are compare-and-swap
      // loops: one per element made them the larger part of pass A.)  In
      // a tile whose whole warp band is valid and unclipped (the interior
      // tiles), band row o + max_pos - r_lo is affine in the lane's row.
      const bool interior = o_w0 >= max(o_lo, 1 - max_pos) &&
                            o_w0 + kWarpBand - 1 <= min(o_hi, max_pos - 1);
#pragma unroll
      for (int mt = 0; mt < kWarpBand / 16; ++mt) {
        const int o_m = o_w0 + 16 * mt;
        if (interior) {
          uint32_t da[4];
          ldmatrix_x4_trans(da, smem_addr(dpb + ((lane & 7) + (lane >> 4) * 8) * kDP +
                                          16 * mt + ((lane >> 3) & 1) * 8));
          float* row = band + (o_m + gq + max_pos - r_lo) * D + 2 * t;
#pragma unroll
          for (int dt = 0; dt < DT; ++dt) {
            float acc[4] = {0.f, 0.f, 0.f, 0.f};
            mma(acc, da, qt[dt][0], qt[dt][1]);
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {  // rows g and g + 8
              float2* cell = reinterpret_cast<float2*>(row + h2 * 8 * D + 8 * dt);
              float2 c2 = *cell;
              c2.x += acc[2 * h2];
              c2.y += acc[2 * h2 + 1];
              *cell = c2;
            }
          }
        } else if (o_m + 15 >= o_lo && o_m <= o_hi) {  // some valid (i, j) there
          uint32_t da[4];
          ldmatrix_x4_trans(da, smem_addr(dpb + ((lane & 7) + (lane >> 4) * 8) * kDP +
                                          16 * mt + ((lane >> 3) & 1) * 8));
          const bool one_row = o_m >= max_pos || o_m + 15 <= -max_pos;
#pragma unroll
          for (int dt = 0; dt < DT; ++dt) {
            float acc[4] = {0.f, 0.f, 0.f, 0.f};
            mma(acc, da, qt[dt][0], qt[dt][1]);
            float* col = band + 8 * dt + 2 * t;
            if (one_row) {  // rows g and g + 8 of every lane group: one table row
              float pair[2] = {acc[0] + acc[2], acc[1] + acc[3]};
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
                    c2.x += acc[2 * h2];
                    c2.y += acc[2 * h2 + 1];
                    *reinterpret_cast<float2*>(cell) = c2;
                  } else {
                    atomicAdd(cell, acc[2 * h2]);
                    atomicAdd(cell + 1, acc[2 * h2 + 1]);
                  }
                }
              }
            }
          }
        }
        __syncthreads();  // step mt is folded before any warp's step mt + 1
      }
    }

    __nv_bfloat16* dqb = dq + ob;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int c = 8 * dt + 2 * t;
      if (r0 < n)
        *reinterpret_cast<uint32_t*>(dqb + r0 * row_stride + c) = pack_bf16(dqa[dt][0], dqa[dt][1]);
      if (r1 < n)
        *reinterpret_cast<uint32_t*>(dqb + r1 * row_stride + c) = pack_bf16(dqa[dt][2], dqa[dt][3]);
    }
  }

  __syncthreads();  // every warp has folded
  for (int e = threadIdx.x; e < band_rows * D; e += kThreads)
    atomicAdd(dtable + static_cast<long long>(r_lo) * D + e, band[e]);
}

// Pass B: dk and dv.  Block: (sequence, head, key tile of 64); query
// tiles of 64 streamed.  Each warp holds 16 keys as the rows of S^T.
template <int D>
__global__ void __launch_bounds__(kThreads, D == 16 ? 3 : 2)
    bwd_key_mma_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ table,
                       const __nv_bfloat16* __restrict__ g,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                       int n, int h, int k_tiles, long long q_sb, long long q_sn,
                       long long k_sb, long long k_sn, long long v_sb, long long v_sn,
                       int max_pos, float scale, float scale_log2) {
  using L = Layout<D>;
  constexpr int KS = D / 16;
  constexpr int CH = D / 8;
  constexpr int DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ring = stages + 2 * L::kStage;
  float* rb = reinterpret_cast<float*>(smem + L::kTiles);  // R'_blk [128][kRB]
  float* stats = rb + kBand * kRB;  // per stage: lse (log2 units) [64], Delta [64]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;

  const int bh = blockIdx.x / k_tiles;
  const int b = bh / h, hh = bh - b * h;
  const int j0 = (blockIdx.x - bh * k_tiles) * kBN;
  const int jw = j0 + 16 * warp;
  const int c0 = jw + gq, c1 = c0 + 8;  // this lane's two keys
  const long long row_stride = static_cast<long long>(h) * D;  // g, dk, dv
  const long long ob = static_cast<long long>(b) * n * row_stride + hh * D;
  const __nv_bfloat16* qb = q + b * q_sb + hh * D;
  const __nv_bfloat16* gb = g + ob;
  const float* lb = lse + (static_cast<long long>(b) * h + hh) * n;
  const float* db = delta + (static_cast<long long>(b) * h + hh) * n;
  auto clip = [&](int o) { return clip_offset(o, max_pos); };

  // K and V of the warp's 16 keys as A fragments (rows = keys)
  uint32_t ka[KS][4], va[KS][4];
  {
    const __nv_bfloat16* kb = k + b * k_sb + hh * D;
    const __nv_bfloat16* vb = v + b * v_sb + hh * D;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = (e & 1) ? c1 : c0;
        const int c = 16 * ks + 2 * t + (e >> 1) * 8;
        ka[ks][e] = j < n ? load_pair(kb + j * k_sn + c) : 0u;
        va[ks][e] = j < n ? load_pair(vb + j * v_sn + c) : 0u;
      }
    }
  }

  // one query tile, as one cp.async group: Q and dO rows i0 .. i0 + 63, their
  // lse and Delta, and the table rows of its band that the ring lacks
  auto load_tile = [&](int stage, int tile) {
    const int i0 = tile * kBM;
    __nv_bfloat16* qs_ = stages + stage * L::kStage;
    __nv_bfloat16* gs_ = qs_ + kBM * L::kPitch;
    for (int c = threadIdx.x; c < kBM * CH; c += kThreads) {
      const int r = c / CH, ch = c - r * CH;
      const bool ok = i0 + r < n;
      const int i = ok ? i0 + r : 0;
      cp_async16(smem_addr(qs_ + r * L::kPitch + ch * 8), qb + i * q_sn + ch * 8, ok);
      cp_async16(smem_addr(gs_ + r * L::kPitch + ch * 8), gb + i * row_stride + ch * 8, ok);
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
      cp_async16(smem_addr(ring + (rel & (kRing - 1)) * L::kPitch + ch * 8),
                 table + rel * D + ch * 8);
    }
    cp_async_commit();
  };

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[dt][e] = dva[dt][e] = 0.f;

  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
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
    const __nv_bfloat16* qs_ = stages + (tile & 1) * L::kStage;
    const __nv_bfloat16* gs_ = qs_ + kBM * L::kPitch;
    const float* st = stats + (tile & 1) * 2 * kBM;
    const int o_l = i0 - j0 - (kBN - 1);

    // Q as the B operand of R'_blk = E_band Q^T and S^T = K Q^T (n = queries)
    uint32_t qf[4][KS][4];
#pragma unroll
    for (int kp = 0; kp < 4; ++kp)
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldmatrix_x4(qf[kp][ks], smem_addr(qs_ + (16 * kp + (lane & 7) + (lane >> 4) * 8) *
                                          L::kPitch + 16 * ks + ((lane >> 3) & 1) * 8));

    // R'_blk[r][i] = E_band[r] . q_i: this warp's 32 band rows x 64 queries
#pragma unroll
    for (int m2 = 0; m2 < 2; ++m2) {
      const int mt = 2 * warp + m2;
      const int slot = (clip(o_l + 16 * mt + lrow) + max_pos) & (kRing - 1);
      float acc[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ea[4];
        ldmatrix_x4(ea, smem_addr(ring + slot * L::kPitch + 16 * ks + (lane >> 4) * 8));
#pragma unroll
        for (int kp = 0; kp < 4; ++kp) {
          mma(acc[2 * kp], ea, qf[kp][ks][0], qf[kp][ks][1]);
          mma(acc[2 * kp + 1], ea, qf[kp][ks][2], qf[kp][ks][3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          rb[(16 * mt + gq + (e >> 1) * 8) * kRB + 8 * nt + 2 * t + (e & 1)] = acc[nt][e];
    }

    // S^T = K Q^T and dP^T = V dO^T: rows = the warp's keys, 8 n8 tiles of queries
    float s[8][4], dpv[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dpv[nt][e] = 0.f;
#pragma unroll
    for (int kp = 0; kp < 4; ++kp) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t gf[4];
        ldmatrix_x4(gf, smem_addr(gs_ + (16 * kp + (lane & 7) + (lane >> 4) * 8) * L::kPitch +
                                  16 * ks + ((lane >> 3) & 1) * 8));
        mma(s[2 * kp], ka[ks], qf[kp][ks][0], qf[kp][ks][1]);
        mma(s[2 * kp + 1], ka[ks], qf[kp][ks][2], qf[kp][ks][3]);
        mma(dpv[2 * kp], va[ks], gf[0], gf[1]);
        mma(dpv[2 * kp + 1], va[ks], gf[2], gf[3]);
      }
    }
    __syncthreads();  // R'_blk written by every warp

    // P^T and dp^T, straight into A fragments (k = queries)
    uint32_t pa[4][4], dpa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float pf[8], dpf[8];
#pragma unroll
      for (int e8 = 0; e8 < 8; ++e8) {
        const int nt = 2 * kk + (e8 >> 2), e = e8 & 3;
        const int jl = 16 * warp + gq + (e >> 1) * 8;
        const int il = 8 * nt + 2 * t + (e & 1);
        const float x = s[nt][e] + rb[(kBN - 1 + il - jl) * kRB + il];
        const float p = j0 + jl < n
                            ? fast_exp2(fmaf(x, scale_log2, -st[il] * kLog2e)) : 0.f;
        pf[e8] = p;
        dpf[e8] = p * (dpv[nt][e] - st[kBM + il]) * scale;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kk][r] = pack_bf16(pf[2 * r], pf[2 * r + 1]);
        dpa[kk][r] = pack_bf16(dpf[2 * r], dpf[2 * r + 1]);
      }
    }

    // dv += P^T dO and dk += dp^T Q, 16 queries per k-step; dO and Q
    // through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        const int off = (16 * kk + lrow) * L::kPitch + 16 * dp + (lane >> 4) * 8;
        uint32_t gf[4], qt[4];
        ldmatrix_x4_trans(gf, smem_addr(gs_ + off));
        ldmatrix_x4_trans(qt, smem_addr(qs_ + off));
        mma(dva[2 * dp], pa[kk], gf[0], gf[1]);
        mma(dva[2 * dp + 1], pa[kk], gf[2], gf[3]);
        mma(dka[2 * dp], dpa[kk], qt[0], qt[1]);
        mma(dka[2 * dp + 1], dpa[kk], qt[2], qt[3]);
      }
    }
    __syncthreads();  // this stage and R'_blk are consumed
  }

  __nv_bfloat16* dkb = dk + ob;
  __nv_bfloat16* dvb = dv + ob;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int c = 8 * dt + 2 * t;
    if (c0 < n) {
      *reinterpret_cast<uint32_t*>(dkb + c0 * row_stride + c) = pack_bf16(dka[dt][0], dka[dt][1]);
      *reinterpret_cast<uint32_t*>(dvb + c0 * row_stride + c) = pack_bf16(dva[dt][0], dva[dt][1]);
    }
    if (c1 < n) {
      *reinterpret_cast<uint32_t*>(dkb + c1 * row_stride + c) = pack_bf16(dka[dt][2], dka[dt][3]);
      *reinterpret_cast<uint32_t*>(dvb + c1 * row_stride + c) = pack_bf16(dva[dt][2], dva[dt][3]);
    }
  }
}

template <int D>
int prepare() {
  static bool done = false;  // the attributes are per function; set them once
  if (done) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_query_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bwd_key_mma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<D>::kBytesB);
  done = err == cudaSuccess;
  return static_cast<int>(err);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* table,
           const void* out, const void* g, const float* lse, float* delta,
           void* dq, void* dk, void* dv, float* dtable, int batch, int n, int h,
           long long q_sb, long long q_sn, long long k_sb, long long k_sn,
           long long v_sb, long long v_sn, int max_pos, float scale, int groups,
           int band_rows, cudaStream_t stream) {
  const size_t bytes_a = Layout<D>::kBytesA + static_cast<size_t>(band_rows) * D * 4;
  if (bytes_a > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  const int err = prepare<D>();
  if (err) return err;
  using B = __nv_bfloat16;
  const float scale_log2 = scale * kLog2e;
  const int q_tiles = (n + kBM - 1) / kBM;
  bwd_query_mma_kernel<D><<<dim3(h * q_tiles, groups), kThreads, bytes_a, stream>>>(
      static_cast<const B*>(q), static_cast<const B*>(k), static_cast<const B*>(v),
      static_cast<const B*>(table), static_cast<const B*>(out), static_cast<const B*>(g),
      lse, delta, static_cast<B*>(dq), dtable, batch, n, h, q_tiles, q_sb, q_sn, k_sb,
      k_sn, v_sb, v_sn, max_pos, scale, scale_log2);
  const cudaError_t err_a = cudaGetLastError();
  if (err_a != cudaSuccess) return static_cast<int>(err_a);
  const int k_tiles = (n + kBN - 1) / kBN;
  bwd_key_mma_kernel<D><<<batch * h * k_tiles, kThreads, Layout<D>::kBytesB, stream>>>(
      static_cast<const B*>(q), static_cast<const B*>(k), static_cast<const B*>(v),
      static_cast<const B*>(table), static_cast<const B*>(g), lse, delta,
      static_cast<B*>(dk), static_cast<B*>(dv), n, h, k_tiles, q_sb, q_sn, k_sb, k_sn,
      v_sb, v_sn, max_pos, scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int occupancy(int band_rows, int* blocks_a, int* blocks_b) {
  int err = prepare<D>();
  if (!err)
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_a, bwd_query_mma_kernel<D>, kThreads,
        Layout<D>::kBytesA + static_cast<size_t>(band_rows) * D * 4));
  if (!err)
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_b, bwd_key_mma_kernel<D>, kThreads, Layout<D>::kBytesB));
  return err;
}

}  // namespace

// bf16 q, k, v: [batch, n, h, d] with unit stride over d and stride d over
// h; the batch and sequence strides (in elements) are multiples of 8 and
// every base pointer is 16-byte aligned.  table: [2 * max_pos + 1, d]
// contiguous bf16.  out (the forward's output), g (its gradient), dq, dk,
// dv: contiguous [batch, n, h, d] bf16, 16-byte aligned.  lse (from the
// forward) and delta (scratch): [batch, h, n] fp32.  dtable: [2 * max_pos
// + 1, d] fp32, zeroed by the caller.  groups: pass A's grid-stride over
// the batch; band_rows: the largest block band, min(64 + n - 1,
// 2 * max_pos + 1).  d is 16 or 32.
extern "C" int se_shaw_attention_bwd_mma(
    const void* q, const void* k, const void* v, const void* table,
    const void* out, const void* g, const void* lse, void* delta, void* dq,
    void* dk, void* dv, void* dtable, int batch, int n, int h, int d,
    long long q_sb, long long q_sn, long long k_sb, long long k_sn,
    long long v_sb, long long v_sn, int max_pos, float scale, int groups,
    int band_rows, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* dt = static_cast<float*>(dtable);
  if (d == 16)
    return launch<16>(q, k, v, table, out, g, l, dl, dq, dk, dv, dt, batch, n, h, q_sb,
                      q_sn, k_sb, k_sn, v_sb, v_sn, max_pos, scale, groups, band_rows, st);
  if (d == 32)
    return launch<32>(q, k, v, table, out, g, l, dl, dq, dk, dv, dt, batch, n, h, q_sb,
                      q_sn, k_sb, k_sn, v_sb, v_sn, max_pos, scale, groups, band_rows, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Resident blocks of 4 warps per SM of pass A (at a block band of
// band_rows table rows) and of pass B, for head dim d, as built.
extern "C" int se_shaw_attention_bwd_mma_occupancy(int d, int band_rows, int* blocks_a,
                                                   int* blocks_b) {
  if (d == 16) return occupancy<16>(band_rows, blocks_a, blocks_b);
  if (d == 32) return occupancy<32>(band_rows, blocks_a, blocks_b);
  return static_cast<int>(cudaErrorInvalidValue);
}
