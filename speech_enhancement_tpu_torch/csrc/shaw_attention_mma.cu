// Fused Shaw relative-position attention forward (K1), bf16 on tensor cores,
// for Hopper (head dims 16 and 32).
//
// Replaces the TPU kernel speech_enhancement_tpu/ops/pallas_attention.py
// (_attn_kernel, driven by _kernel_call and fused_shaw_attention) for bf16
// operands:
//
//   out[b, i, h] = softmax_j((q_i . k_j + q_i . E[clip(i - j, +-P) + P]) * scale) . v_j
//
// with the TPU kernel's numerics: bf16 operands, fp32 logits and softmax,
// P rounded to bf16 before P.V, fp32 accumulation.  Those map onto
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate) exactly.  fp32 operands at
// d = 16 or 32 take the 3xTF32 instance (shaw_attention_tf32.cu), d = 4 or 8
// of either dtype the CUDA-core kernel (shaw_attention.cu); the wrapper
// (ops/fused_attention.py, kernel_instance) picks the instance.
//
// What bounds it on an H100: at the serving shape (B = 3232 sequences,
// n = 321, h = 4, d = 16) the three n x n x d contractions are 128 GFLOP
// (0.13 ms at the 989 TFLOP/s bf16 rate) and q, k, v, out are 531 MB
// (0.16 ms at 3.35 TB/s); the n^2 B h exponentials (1.3 G, 1.9 G with
// this kernel's 64-key tiles at n = 321) take about 0.4-0.5 ms on the
// SM's special-function units.  So the exp unit and memory bound it, not
// the matrix rate: d = 16 is one k-step of the mma.
//
// Design:
// * a block of 4 warps takes 64 query rows of one (sequence, head), 16
//   per warp; each warp loads its Q fragments once from device memory;
// * keys and values stream in tiles of 64 through double-buffered shared
//   memory, with 16-byte cp.async (zero-filled past n); k and v may be
//   strided views (the two halves of the to_kv output);
// * logits: S = Q K^T, 8 m16n8k16 per warp per key tile (times d / 16);
// * the Shaw bias is a skew: for its 16 queries x 64 keys a warp needs
//   the 16 + 64 - 1 = 79 table rows E[clip(i - j)]; the block's 4 warps
//   need a band of 127 offsets per key tile, 64 of them new at each tile.
//   Table rows live in a ring of 256 rows indexed by clipped offset, and
//   each tile's cp.async group brings only the distinct rows the ring
//   lacks (64 per tile, none once the band is clipped), where staging the
//   band whole would copy 127 rows per tile, most of them the one clipped
//   table row once n > 2 P.  The tile being read and the rows being
//   loaded span at most 192 consecutive offsets, so they never share a
//   slot; ldmatrix takes each lane's row address, so clipping costs
//   nothing there, and any n works.  The warp
//   computes R'[r][i] = E_band[r] . q_i for its 80 band rows by 10 mma
//   (A = band rows, B = the Q fragments already in registers, which are
//   the B layout of Q^T) and writes R' to shared memory in fp32.  Then
//   bias[i][j] = R'[63 + i - j][i]: the Music-Transformer skew done as an
//   address pattern, with no [n, n, d] gather;
// * R' has a row pitch of kRP = 20 floats.  In the accumulator-fragment
//   pattern lane (g, t) reads R' at (63 + g - 8c - 2t) * 20 + g (+ const):
//   g * 21 takes 8 distinct values mod 8 and -40 t the values 0, 8, 16, 24
//   mod 32, so the 32 lanes hit 32 distinct banks (conflict-free reads);
//   the float2 writes of the mma results have at most 2-way conflicts;
// * online softmax on the accumulator fragments: row max and sum by quad
//   shuffles on the unscaled logits, then exp2(x * scale * log2(e) - m) as
//   one FMA and one ex2; P goes to
//   bf16 straight into A fragments (the C layout of two n8 tiles is the A
//   layout of one k16 step) and O += P V takes V through ldmatrix.trans;
// * epilogue: O / l in bf16; where asked, lse = m + ln(l) in natural-log
//   units of the scaled logits, which the backward (K2,
//   shaw_attention_bwd.cu) reads.
// Staged rows have a pitch of d + 8 bf16 (48 or 80 bytes), so the 8 rows
// of each ldmatrix phase fall in distinct banks.  Shared memory: 50,176
// bytes at d = 16, 66,560 at d = 32 (dynamic).
//
// The C entry points return cudaGetLastError() (or the error of an
// attribute call) after their launch or query.

#include <cuda_bf16.h>
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
constexpr int kRing = 256;         // table rows kept in the ring (see above)
constexpr int kWarpBand = 80;      // 16 + 64 - 1 = 79 rows, 5 m16 tiles
constexpr int kRP = 20;            // row pitch of R' in floats (see above)

template <int D>
struct Layout {
  static constexpr int kPitch = D + 8;  // bf16 elements per staged row
  static constexpr int kStage = 2 * kBN * kPitch;  // K and V of one key tile
  static constexpr int kBytes = (2 * kStage + kRing * kPitch) * 2 +
                                kWarps * kWarpBand * kRP * 4;
};

template <int D>
__global__ void __launch_bounds__(kThreads, D == 16 ? 4 : 3)
    shaw_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ table,
                              __nv_bfloat16* __restrict__ out,
                              float* __restrict__ lse, int n, int h,
                              int q_tiles, long long q_sb, long long q_sn,
                              long long k_sb, long long k_sn, long long v_sb,
                              long long v_sn, int max_pos, float scale_log2) {
  using L = Layout<D>;
  constexpr int KS = D / 16;  // k16 steps over d
  constexpr int CH = D / 8;   // 16-byte chunks per staged row
  constexpr int DT = D / 8;   // n8 tiles of the output over d
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  __nv_bfloat16* ring = stages + 2 * L::kStage;
  float* rs = reinterpret_cast<float*>(smem + (2 * L::kStage + kRing * L::kPitch) * 2) +
              warp * kWarpBand * kRP;

  const int bh = blockIdx.x / q_tiles;
  const int b = bh / h, hh = bh - b * h;
  const int i0 = (blockIdx.x - bh * q_tiles) * kBM;  // the block's first query
  const int iw = i0 + 16 * warp;                     // the warp's first query
  const int r0 = iw + g, r1 = r0 + 8;                // this lane's two rows
  const __nv_bfloat16* kb = k + b * k_sb + hh * D;
  const __nv_bfloat16* vb = v + b * v_sb + hh * D;

  // Q fragments: the A operand of S = Q K^T, and the B operand of
  // R' = E Q^T (queries 0-7: {qa[.][0], qa[.][2]}, 8-15: {[1], [3]})
  uint32_t qa[KS][4];
  {
    const __nv_bfloat16* qb = q + b * q_sb + hh * D;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int c = 16 * ks + 2 * t;
      qa[ks][0] = r0 < n ? load_pair(qb + r0 * q_sn + c) : 0u;
      qa[ks][1] = r1 < n ? load_pair(qb + r1 * q_sn + c) : 0u;
      qa[ks][2] = r0 < n ? load_pair(qb + r0 * q_sn + c + 8) : 0u;
      qa[ks][3] = r1 < n ? load_pair(qb + r1 * q_sn + c + 8) : 0u;
    }
  }

  // one key tile, as one cp.async group: K and V rows j0 .. j0 + 63 into
  // a stage, and the table rows of its band that the ring lacks
  auto clip = [&](int o) { return min(max(o, -max_pos), max_pos); };
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
    // the band holds offsets o_lo .. o_lo + 127; the ring already has
    // every clipped offset >= clip(o_lo + 64) from earlier tiles
    const int o_lo = i0 - j0 - (kBN - 1);
    const int lo = clip(o_lo);
    const int hi = tile == 0 ? clip(o_lo + kBand - 1) + 1 : clip(o_lo + kBN);
    for (int c = threadIdx.x; c < (hi - lo) * CH; c += kThreads) {
      const int r = c / CH, ch = c - r * CH;
      const int rel = lo + r + max_pos;
      cp_async16(smem_addr(ring + (rel & (kRing - 1)) * L::kPitch + ch * 8),
                 table + rel * D + ch * 8, true);
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
    const __nv_bfloat16* ks_ = stages + (tile & 1) * L::kStage;
    const __nv_bfloat16* vs_ = ks_ + kBN * L::kPitch;
    // this lane's ldmatrix row of band m-tile 0: offset o_w, then o_w + 16 mt
    const int o_w = i0 - j0 - (kBN - 1) + 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8;

    // R'[r][i] = E_band[r] . q_i over the warp's 80 band rows
#pragma unroll
    for (int mt = 0; mt < kWarpBand / 16; ++mt) {
      float acc[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ea[4];
        const int slot = (clip(o_w + 16 * mt) + max_pos) & (kRing - 1);
        ldmatrix_x4(ea, smem_addr(ring + slot * L::kPitch + 16 * ks + (lane >> 4) * 8));
        mma(acc[0], ea, qa[ks][0], qa[ks][2]);
        mma(acc[1], ea, qa[ks][1], qa[ks][3]);
      }
#pragma unroll
      for (int nq = 0; nq < 2; ++nq) {
        float* w = rs + (16 * mt + g) * kRP + 8 * nq + 2 * t;
        *reinterpret_cast<float2*>(w) = make_float2(acc[nq][0], acc[nq][1]);
        *reinterpret_cast<float2*>(w + 8 * kRP) = make_float2(acc[nq][2], acc[nq][3]);
      }
    }

    // S = Q K^T: 8 n8 tiles of keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kp = 0; kp < 4; ++kp) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t kf[4];
        const int row = 16 * kp + (lane & 7) + (lane >> 4) * 8;
        ldmatrix_x4(kf, smem_addr(ks_ + row * L::kPitch + 16 * ks + ((lane >> 3) & 1) * 8));
        mma(s[2 * kp], qa[ks], kf[0], kf[1]);
        mma(s[2 * kp + 1], qa[ks], kf[2], kf[3]);
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

    // O += P V, 16 keys per k-step; P in bf16 straight into A fragments
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float p[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = fast_exp2(fmaf(s[2 * kk][e], scale_log2, neg_m[e >> 1]));
        p[4 + e] = fast_exp2(fmaf(s[2 * kk + 1][e], scale_log2, neg_m[e >> 1]));
      }
      l_run[0] += (p[0] + p[1]) + (p[4] + p[5]);
      l_run[1] += (p[2] + p[3]) + (p[6] + p[7]);
      const uint32_t pa[4] = {pack_bf16(p[0], p[1]), pack_bf16(p[2], p[3]),
                              pack_bf16(p[4], p[5]), pack_bf16(p[6], p[7])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];
        const int row = 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(vf, smem_addr(vs_ + row * L::kPitch + 16 * dp + (lane >> 4) * 8));
        mma(o[2 * dp], pa, vf[0], vf[1]);
        mma(o[2 * dp + 1], pa, vf[2], vf[3]);
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
  __nv_bfloat16* ob = out + static_cast<long long>(b) * n * row_stride + hh * D;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int c = 8 * dt + 2 * t;
    if (r0 < n)
      *reinterpret_cast<uint32_t*>(ob + r0 * row_stride + c) =
          pack_bf16(o[dt][0] * inv0, o[dt][1] * inv0);
    if (r1 < n)
      *reinterpret_cast<uint32_t*>(ob + r1 * row_stride + c) =
          pack_bf16(o[dt][2] * inv1, o[dt][3] * inv1);
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
      shaw_attention_mma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<D>::kBytes);
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
  shaw_attention_mma_kernel<D><<<batch * h * q_tiles, kThreads,
                                 Layout<D>::kBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(table),
      static_cast<__nv_bfloat16*>(out), lse, n, h, q_tiles, q_sb, q_sn, k_sb,
      k_sn, v_sb, v_sn, max_pos, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q, k, v: [batch, n, h, d] with unit stride over d and stride d over
// h; the batch and sequence strides (in elements) are multiples of 8 and
// every base pointer is 16-byte aligned.  table: [2 * max_pos + 1, d]
// contiguous bf16.  out: contiguous [batch, n, h, d] bf16.  lse: null, or
// [batch, h, n] fp32.  d is 16 or 32; batch * h * ceil(n / 64) < 2^31.
// scale_log2 is the softmax scale times log2(e).
extern "C" int se_shaw_attention_mma(const void* q, const void* k,
                                     const void* v, const void* table,
                                     void* out, void* lse, int batch, int n,
                                     int h, int d, long long q_sb,
                                     long long q_sn, long long k_sb,
                                     long long k_sn, long long v_sb,
                                     long long v_sn, int max_pos,
                                     float scale_log2, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  if (d == 16)
    return launch<16>(q, k, v, table, out, lse_f, batch, n, h, q_sb, q_sn,
                      k_sb, k_sn, v_sb, v_sn, max_pos, scale_log2, st);
  if (d == 32)
    return launch<32>(q, k, v, table, out, lse_f, batch, n, h, q_sb, q_sn,
                      k_sb, k_sn, v_sb, v_sn, max_pos, scale_log2, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Resident blocks of 4 warps per SM for head dim d (its shared memory and
// registers as built), into *blocks.
extern "C" int se_shaw_attention_mma_occupancy(int d, int* blocks) {
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (d == 16) {
    err = prepare<16>();
    if (!err)
      err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, shaw_attention_mma_kernel<16>, kThreads, Layout<16>::kBytes));
  } else if (d == 32) {
    err = prepare<32>();
    if (!err)
      err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, shaw_attention_mma_kernel<32>, kThreads, Layout<32>::kBytes));
  }
  return err;
}
