// Fused Shaw relative-position attention forward (K1), fp32 on tensor cores
// in 3xTF32, for Hopper (head dims 16 and 32).
//
// Replaces the TPU kernel speech_enhancement_tpu/ops/pallas_attention.py
// (_attn_kernel, driven by _kernel_call and fused_shaw_attention) for fp32
// operands:
//
//   out[b, i, h] = softmax_j((q_i . k_j + q_i . E[clip(i - j, +-P) + P]) * scale) . v_j
//
// with the TPU kernel's fp32 numerics: fp32 logits, softmax and P (no
// rounding of P before P.V), fp32 accumulation, held to rtol 1e-4 / atol
// 1e-5 against the plain version.  bf16 at head dims 16 and 32 is the bf16
// instance (shaw_attention_mma.cu), head dims 4 and 8 the CUDA-core one
// (shaw_attention.cu); the wrapper (ops/fused_attention.py,
// kernel_instance) picks the instance.
//
// What bounds it on an H100: at the serving shape (B = 3232 sequences,
// n = 321, h = 4, d = 16) the three n x n x d contractions are 128 GFLOP.
// A 3xTF32 product is three TF32 products, so at the 495 TFLOP/s TF32 rate
// they take at least 3 x 128 / 495 = 0.775 ms; q, k, v, out are 1.06 GB
// (0.317 ms at 3.35 TB/s).  The operations bound it.  Three TF32 products
// of each split operand keep about fp32's accuracy where one (a 10-bit
// mantissa) would not hold rtol 1e-4; tests/test_torch_attention_tf32.py
// shows both on a PyTorch copy of this arithmetic.
//
// Design: the bf16 instance's tiling, taken to mma.sync.m16n8k8 TF32.
// * a block of 4 warps takes 64 query rows of one (sequence, head), 16 per
//   warp; each warp loads its Q fragments once and splits them into
//   hi = tf32(x) and lo = tf32(x - hi);
// * keys and values stream in tiles of 64 through double-buffered shared
//   memory by 16-byte cp.async (zero-filled past n); k and v may be strided
//   views (the two halves of the to_kv output);
// * every product is 3xTF32: lo*hi + hi*lo + hi*hi of one k-step summed by
//   three mma into a fresh fragment, added to the running sum by an fp32
//   add (the tensor core truncates its sums; see csrc/stft.cu);
// * logits: S = Q K^T, 8 n8 tiles of keys per warp and tile, d / 8 k-steps;
// * the Shaw bias as the bf16 instance builds it: table rows live in a ring
//   of 256 rows indexed by clipped offset, each tile's cp.async group
//   bringing only the rows the ring lacks; the warp computes
//   R'[r][i] = E_band[r] . q_i for its 80 band rows by mma (A = band rows;
//   B = the Q fragments already in registers: a0 = Q[g][t] and a2 =
//   Q[g][t + 4] are the B fragment of Q^T for queries 0-7, a1 and a3 for
//   8-15), writes R' to shared memory in fp32 at pitch 20 (conflict-free
//   reads, see shaw_attention_mma.cu), and reads bias[i][j] =
//   R'[63 + i - j][i];
// * online softmax on the accumulator fragments in log2 units (one FMA and
//   one ex2 per logit); P stays fp32 and is split like any operand;
// * O += P V with the keys of each k-step taken in the order the S
//   fragment holds them: lane (g, t) holds keys 2t and 2t + 1 of its n8
//   tile, so key 2t is A column t and key 2t + 1 column t + 4.  The C
//   fragment is then the A fragment (a0 = c0, a1 = c2, a2 = c1, a3 = c3) with
//   no shuffle, and V's B fragment reads rows 2t and 2t + 1;
// * epilogue: O / l in fp32; where asked, lse = m + ln(l) in natural-log
//   units of the scaled logits, which the fp32 backward (K2,
//   shaw_attention_bwd.cu) reads.
// Shared memory rows (K, V, table) are fp32 at a pitch of d + 4 floats:
// ldmatrix does not transpose 32-bit values, so the fragments are plain
// 4-byte loads.  K reads K[key g][d t] at bank (g (d + 4) + t) mod 32 and
// table reads E[row g][d t] likewise (consecutive ring slots, or one slot
// when clipped: a broadcast): (d + 4) = 20 or 36 is 4 mod 8, so g (d + 4)
// mod 32 takes 8 distinct multiples of 4 and the 32 lanes 32 banks.  V
// reads V[key 2t (+ 1)][d g] at bank (2t (d + 4) + g) mod 32 = 8t + g (+ 4
// at d = 32, + 20 at d = 16 for row 2t + 1): again 32 distinct banks.
// Shared memory: 66,560 bytes at d = 16 (3 blocks, 12 warps per SM),
// 99,328 at d = 32 (2 blocks).
//
// The C entry points return cudaGetLastError() (or the error of an
// attribute call) after their launch or query.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 16 * kWarps;   // query rows per block
constexpr int kBN = 64;            // keys per tile
constexpr int kBand = kBM + kBN;   // band rows a key tile reads (127 used)
constexpr int kRing = 256;         // table rows kept in the ring
constexpr int kWarpBand = 80;      // 16 + 64 - 1 = 79 rows, 5 m16 tiles
constexpr int kRP = 20;            // row pitch of R' in floats

template <int D>
struct Layout {
  static constexpr int kPitch = D + 4;             // floats per staged row
  static constexpr int kStage = 2 * kBN * kPitch;  // K and V of one key tile
  static constexpr int kBytes =
      (2 * kStage + kRing * kPitch + kWarps * kWarpBand * kRP) * 4;
};

template <int D>
__global__ void __launch_bounds__(kThreads, D == 16 ? 3 : 2)
    shaw_attention_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ table,
                               float* __restrict__ out, float* __restrict__ lse, int n,
                               int h, int q_tiles, long long q_sb, long long q_sn,
                               long long k_sb, long long k_sn, long long v_sb,
                               long long v_sn, int max_pos, float scale_log2) {
  using L = Layout<D>;
  constexpr int KS = D / 8;  // k8 steps over d
  constexpr int CH = D / 4;  // 16-byte chunks per staged row
  constexpr int DT = D / 8;  // n8 tiles of the output over d
  extern __shared__ __align__(16) float smem[];
  float* stages = smem;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* ring = stages + 2 * L::kStage;
  float* rs = ring + kRing * L::kPitch + warp * kWarpBand * kRP;

  const int bh = blockIdx.x / q_tiles;
  const int b = bh / h, hh = bh - b * h;
  const int i0 = (blockIdx.x - bh * q_tiles) * kBM;  // the block's first query
  const int iw = i0 + 16 * warp;                     // the warp's first query
  const int r0 = iw + g, r1 = r0 + 8;                // this lane's two rows
  const float* kb = k + b * k_sb + hh * D;
  const float* vb = v + b * v_sb + hh * D;

  // Q fragments, split: the A operand of S = Q K^T, and the B operand of
  // R' = E Q^T (queries 0-7: {[.][0], [.][2]}, 8-15: {[1], [3]})
  uint32_t qh[KS][4], ql[KS][4];
  {
    const float* qb = q + b * q_sb + hh * D;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int c = 8 * ks + t;
      split_tf32(r0 < n ? qb[r0 * q_sn + c] : 0.f, qh[ks][0], ql[ks][0]);
      split_tf32(r1 < n ? qb[r1 * q_sn + c] : 0.f, qh[ks][1], ql[ks][1]);
      split_tf32(r0 < n ? qb[r0 * q_sn + c + 4] : 0.f, qh[ks][2], ql[ks][2]);
      split_tf32(r1 < n ? qb[r1 * q_sn + c + 4] : 0.f, qh[ks][3], ql[ks][3]);
    }
  }

  // one key tile, as one cp.async group: K and V rows j0 .. j0 + 63 into
  // a stage, and the table rows of its band that the ring lacks
  auto clip = [&](int o) { return min(max(o, -max_pos), max_pos); };
  auto load_tile = [&](int stage, int tile) {
    const int j0 = tile * kBN;
    float* ks_ = stages + stage * L::kStage;
    float* vs_ = ks_ + kBN * L::kPitch;
    for (int c = threadIdx.x; c < kBN * CH; c += kThreads) {
      const int r = c / CH, ch = c - r * CH;
      const bool ok = j0 + r < n;
      const int j = ok ? j0 + r : 0;
      cp_async16(smem_addr(ks_ + r * L::kPitch + ch * 4), kb + j * k_sn + ch * 4, ok);
      cp_async16(smem_addr(vs_ + r * L::kPitch + ch * 4), vb + j * v_sn + ch * 4, ok);
    }
    // the band holds offsets o_lo .. o_lo + 127; the ring already has
    // every clipped offset >= clip(o_lo + 64) from earlier tiles
    const int o_lo = i0 - j0 - (kBN - 1);
    const int lo = clip(o_lo);
    const int hi = tile == 0 ? clip(o_lo + kBand - 1) + 1 : clip(o_lo + kBN);
    for (int c = threadIdx.x; c < (hi - lo) * CH; c += kThreads) {
      const int r = c / CH, ch = c - r * CH;
      const int rel = lo + r + max_pos;
      cp_async16(smem_addr(ring + (rel & (kRing - 1)) * L::kPitch + ch * 4),
                 table + rel * D + ch * 4, true);
    }
    cp_async_commit();
  };

  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows r0, r1; log2 units
  float l_run[2] = {0.f, 0.f};              // this lane's share of the row sums

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
    const float* ks_ = stages + (tile & 1) * L::kStage;
    const float* vs_ = ks_ + kBN * L::kPitch;
    // the offset of this lane's band row g of m-tile 0; row g + 8 is + 8,
    // m-tile mt + 16 mt
    const int o_w = i0 - j0 - (kBN - 1) + 16 * warp + g;

    // R'[r][i] = E_band[r] . q_i over the warp's 80 band rows
#pragma unroll
    for (int mt = 0; mt < kWarpBand / 16; ++mt) {
      const float* e0 = ring + ((clip(o_w + 16 * mt) + max_pos) & (kRing - 1)) * L::kPitch;
      const float* e1 = ring + ((clip(o_w + 16 * mt + 8) + max_pos) & (kRing - 1)) * L::kPitch;
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
        float* w = rs + (16 * mt + g) * kRP + 8 * nq + 2 * t;
        *reinterpret_cast<float2*>(w) = make_float2(acc[nq][0], acc[nq][1]);
        *reinterpret_cast<float2*>(w + 8 * kRP) = make_float2(acc[nq][2], acc[nq][3]);
      }
    }

    // S = Q K^T: 8 n8 tiles of keys; B = K^T, b0 = K[8 nt + g][8 ks + t],
    // b1 = K[8 nt + g][8 ks + t + 4]
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float* kr = ks_ + (8 * nt + g) * L::kPitch;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t kh0, kl0, kh1, kl1;
        split_tf32(kr[8 * ks + t], kh0, kl0);
        split_tf32(kr[8 * ks + t + 4], kh1, kl1);
        mma_3xtf32(s[nt], qh[ks], ql[ks], kh0, kh1, kl0, kl1);
      }
    }
    __syncwarp();  // R' written by the whole warp

    // logits x = S + bias, unscaled (the scale is positive, so the row
    // maximum of x gives that of the scaled logits); keys past n masked
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int il = g + (e >> 1) * 8;
        const int jl = 8 * nt + 2 * t + (e & 1);
        s[nt][e] += rs[(kBN - 1 + il - jl) * kRP + il];
      }
    }
    if (j0 + kBN > n) {  // the last, ragged tile
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j0 + 8 * nt + 2 * t + (e & 1) >= n) s[nt][e] = -INFINITY;
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      tmax[0] = fmaxf(tmax[0], fmaxf(s[nt][0], s[nt][1]));
      tmax[1] = fmaxf(tmax[1], fmaxf(s[nt][2], s[nt][3]));
    }
    // running maxima in log2 units of the scaled logits, x * scale * log2(e);
    // every tile holds a valid key, so the new maxima are finite
    float neg_m[2];  // -m, the bias of p = exp2(x * c - m)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      const float m_new = fmaxf(m_run[r], tmax[r] * scale_log2);
      const float corr = fast_exp2(m_run[r] - m_new);
      m_run[r] = m_new;
      neg_m[r] = -m_new;
      l_run[r] *= corr;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        o[dt][2 * r] *= corr;
        o[dt][2 * r + 1] *= corr;
      }
    }

    // O += P V, 8 keys per k-step, in the S fragment's key order (see the
    // header): A = {p(g, 2t), p(g + 8, 2t), p(g, 2t + 1), p(g + 8, 2t + 1)},
    // B = {V[2t][8 dt + g], V[2t + 1][8 dt + g]}
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = fast_exp2(fmaf(s[kk][e], scale_log2, neg_m[e >> 1]));
      l_run[0] += p[0] + p[1];
      l_run[1] += p[2] + p[3];
      uint32_t ph[4], pl[4];
      split_tf32(p[0], ph[0], pl[0]);
      split_tf32(p[2], ph[1], pl[1]);
      split_tf32(p[1], ph[2], pl[2]);
      split_tf32(p[3], ph[3], pl[3]);
      const float* v0 = vs_ + (8 * kk + 2 * t) * L::kPitch;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        uint32_t vh0, vl0, vh1, vl1;
        split_tf32(v0[8 * dt + g], vh0, vl0);
        split_tf32(v0[L::kPitch + 8 * dt + g], vh1, vl1);
        mma_3xtf32(o[dt], ph, pl, vh0, vh1, vl0, vl1);
      }
    }
    __syncthreads();  // this stage and R' are consumed
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const float inv0 = 1.f / l_run[0], inv1 = 1.f / l_run[1];
  const long long row_stride = static_cast<long long>(h) * D;
  float* ob = out + static_cast<long long>(b) * n * row_stride + hh * D;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int c = 8 * dt + 2 * t;
    if (r0 < n)
      *reinterpret_cast<float2*>(ob + r0 * row_stride + c) =
          make_float2(o[dt][0] * inv0, o[dt][1] * inv0);
    if (r1 < n)
      *reinterpret_cast<float2*>(ob + r1 * row_stride + c) =
          make_float2(o[dt][2] * inv1, o[dt][3] * inv1);
  }
  if (lse != nullptr && t == 0) {
    constexpr float kLn2 = 0.69314718055994531f;
    float* lb = lse + (static_cast<long long>(b) * h + hh) * n;
    if (r0 < n) lb[r0] = (m_run[0] + log2f(l_run[0])) * kLn2;
    if (r1 < n) lb[r1] = (m_run[1] + log2f(l_run[1])) * kLn2;
  }
}

template <int D>
int prepare() {
  static bool done = false;  // the attribute is per function; set it once
  if (done) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      shaw_attention_tf32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Layout<D>::kBytes);
  done = err == cudaSuccess;
  return static_cast<int>(err);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* table,
           void* out, float* lse, int batch, int n, int h, long long q_sb,
           long long q_sn, long long k_sb, long long k_sn, long long v_sb,
           long long v_sn, int max_pos, float scale_log2, cudaStream_t stream) {
  const int err = prepare<D>();
  if (err) return err;
  const int q_tiles = (n + kBM - 1) / kBM;
  shaw_attention_tf32_kernel<D><<<batch * h * q_tiles, kThreads, Layout<D>::kBytes,
                                  stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(table),
      static_cast<float*>(out), lse, n, h, q_tiles, q_sb, q_sn, k_sb, k_sn, v_sb,
      v_sn, max_pos, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// fp32 q, k, v: [batch, n, h, d] with unit stride over d and stride d over
// h; the batch and sequence strides (in elements) are multiples of 4 and
// every base pointer is 16-byte aligned.  table: [2 * max_pos + 1, d]
// contiguous fp32.  out: contiguous [batch, n, h, d] fp32.  lse: null, or
// [batch, h, n] fp32.  d is 16 or 32; batch * h * ceil(n / 64) < 2^31.
// scale_log2 is the softmax scale times log2(e).
extern "C" int se_shaw_attention_tf32(const void* q, const void* k, const void* v,
                                      const void* table, void* out, void* lse,
                                      int batch, int n, int h, int d, long long q_sb,
                                      long long q_sn, long long k_sb, long long k_sn,
                                      long long v_sb, long long v_sn, int max_pos,
                                      float scale_log2, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  if (d == 16)
    return launch<16>(q, k, v, table, out, lse_f, batch, n, h, q_sb, q_sn, k_sb,
                      k_sn, v_sb, v_sn, max_pos, scale_log2, st);
  if (d == 32)
    return launch<32>(q, k, v, table, out, lse_f, batch, n, h, q_sb, q_sn, k_sb,
                      k_sn, v_sb, v_sn, max_pos, scale_log2, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Resident blocks of 4 warps per SM for head dim d (its shared memory and
// registers as built), into *blocks.
extern "C" int se_shaw_attention_tf32_occupancy(int d, int* blocks) {
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (d == 16) {
    err = prepare<16>();
    if (!err)
      err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, shaw_attention_tf32_kernel<16>, kThreads, Layout<16>::kBytes));
  } else if (d == 32) {
    err = prepare<32>();
    if (!err)
      err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, shaw_attention_tf32_kernel<32>, kThreads, Layout<32>::kBytes));
  }
  return err;
}
