// Fused Shaw relative-position attention backward (K2, with K3 folded in)
// for Hopper.
//
// Replaces the TPU kernels of speech_enhancement_tpu/ops/pallas_attention.py:
// _attn_bwd_kernel (pallas_calls of _bwd_kernel_call at :564 and :654) and
// the drel-only long-sequence pass _attn_bwd_drel_kernel (:616).  With
// s = (q k^T + q.E[clip(i - j)]) * scale, P = softmax(s), G = dL/dout:
//
//   dV = P^T G            (P rounded to the operand dtype, as attn_c)
//   dP = G V^T
//   dS = P o (dP - Delta)  Delta_i = rowsum(P o dP)_i
//   dp = dS * scale, rounded to the operand dtype
//   dQ = dp K + sum_j dp[i, j] E[clip(i - j)]        dK = dp^T Q
//   dtable[clip(i - j) + max_pos] += sum_{b, h} q_i dp[i, j]
//
// with fp32 logits, softmax and accumulators, dq/dk/dv in the operand
// dtype and dtable in fp32 (the caller casts it to the table's dtype).
//
// Design choices:
// * P from the forward's log-sum-exp.  K1 writes lse = m + log(l) per row
//   ([B, h, n] fp32), so P_ij = exp(s_ij - lse_i) here with no row max or
//   sum pass (the TPU kernel recomputes both, _recompute_softmax_ds).
// * Delta = rowsum(dO o O), from the forward's output, not rowsum(P o dP).
//   In fp32 the two are equal up to summation order (O = P V); in bf16 O
//   was rounded to bf16, which moves Delta by about one bf16 step of
//   |dO||O| -- inside the stated bf16 bound, and it saves a third sweep
//   over the keys.
// * Two passes, no atomics on dq/dk/dv (FlashAttention-2 layout):
//   pass A is query-major (one thread per query row, keys streamed in
//   tiles): it writes Delta, dq, and the table gradient; pass B is
//   key-major (one thread per key row, queries streamed in tiles): dk and
//   dv.  Each recomputes s and P.  The alternative, one pass with fp32
//   atomicAdd into dq, makes dq order-dependent and costs a global atomic
//   per (pair, channel) band.
// * dtable.  For a fixed key, the 32 lanes of a warp touch 32 distinct
//   offsets i - j, so each warp adds q_i dp_ij into its own band of
//   unclipped offsets in shared memory with plain adds (a __syncwarp
//   between keys keeps the lanes in step).  After each key tile a warp
//   folds its band into the block's band of clipped table rows with
//   shared-memory atomics (the clipped rows 0 and 2P collect many
//   offsets).  A block loops over a group of sequences (grid-stride over
//   the batch) before it flushes its band to the fp32 table gradient with
//   one global atomicAdd per entry, so the global atomics scale with the
//   number of blocks, not with B.  The block band spans at most
//   min(BM + n - 1, 2P + 1) rows, so any n runs in bounded shared memory
//   (n = 1281, where the JAX package switched to K3, included).  With
//   atomics the table gradient is not bit-deterministic from run to run.
//
// What bounds it on an H100: like K1, fp32 multiply-adds on CUDA cores
// (about 5 d FMAs per (query, key, head) in each pass) and shared-memory
// bandwidth; no tensor cores yet.  No loop here descends with min/max
// bounds (the nvcc 12.9 fault recorded for K5 in PERF.md).
//
// This is the CUDA-core instance: fp32 and bf16 at head dims 4 and 8.
// Head dims 16 and 32 are the tensor-core instances
// (csrc/shaw_attention_bwd_mma.cu for bf16, shaw_attention_bwd_tf32.cu for
// fp32), and the entry point here refuses them.
//
// The C entry point launches pass A then pass B on the caller's stream and
// returns cudaGetLastError() after them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "cvt.cuh"

namespace {

constexpr int kWarp = 32;

__device__ __forceinline__ int clip_offset(int o, int max_pos) {
  return o < -max_pos ? -max_pos : (o > max_pos ? max_pos : o);
}

// Pass A: Delta, dq and the table gradient.  Block: (head, query tile of
// BM rows) x a group of sequences; one thread per query row.
template <typename T, int D, int BM, int BN>
__global__ void __launch_bounds__(BM)
    shaw_bwd_query_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ table,
                          const T* __restrict__ out, const T* __restrict__ g,
                          const float* __restrict__ lse,
                          float* __restrict__ delta, T* __restrict__ dq,
                          float* __restrict__ dtable, int batch, int n, int h,
                          long long q_sb, long long q_sn, long long k_sb,
                          long long k_sn, long long v_sb, long long v_sn,
                          int max_pos, float scale) {
  constexpr int DP = (D == 4) ? 4 : D + 4;  // bias-row pitch, as K1
  constexpr int D4 = D / 4;
  constexpr int NW = BM / kWarp;
  constexpr int WR = kWarp + BN - 1;  // offsets one warp touches per tile
  constexpr int WP = D + 1;           // warp-band pitch: lanes hit distinct banks
  __shared__ __align__(16) float ks[BN * D];
  __shared__ __align__(16) float vs[BN * D];
  __shared__ __align__(16) float es[(BM + BN - 1) * DP];
  __shared__ float wband[NW * WR * WP];
  extern __shared__ float band[];  // [band_rows, D], clipped table rows

  const int n_it = (n + BM - 1) / BM;
  const int hh = blockIdx.x / n_it;
  const int i0 = (blockIdx.x - hh * n_it) * BM;
  const int li = threadIdx.x;
  const int lane = li % kWarp;
  const int w = li / kWarp;
  const bool row_ok = i0 + li < n;
  const int i = row_ok ? i0 + li : n - 1;  // rows past n load row n - 1
  const int i_end = (i0 + BM < n ? i0 + BM : n) - 1;
  // offsets i - j of this block run from o_lo to o_hi; their clipped table
  // rows from r_lo to r_hi
  const int o_lo = i0 - (n - 1);
  const int o_hi = i_end;
  const int r_lo = clip_offset(o_lo, max_pos) + max_pos;
  const int band_rows = clip_offset(o_hi, max_pos) + max_pos - r_lo + 1;

  for (int e = li; e < band_rows * D; e += BM) band[e] = 0.f;
  float* wb = wband + w * WR * WP;
  for (int e = lane; e < WR * WP; e += kWarp) wb[e] = 0.f;

  for (int b = blockIdx.y; b < batch; b += gridDim.y) {
    const long long row = (static_cast<long long>(b) * n + i) * h + hh;
    const T* qp = q + b * q_sb + i * q_sn + hh * D;
    const T* gp = g + row * D;
    const T* op = out + row * D;
    float qr[D], gr[D], acc[D];
    float dl = 0.f;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      qr[c] = Cvt<T>::to(qp[c]);
      gr[c] = Cvt<T>::to(gp[c]);
      dl = fmaf(gr[c], Cvt<T>::to(op[c]), dl);
      acc[c] = 0.f;
    }
    const long long stat = (static_cast<long long>(b) * h + hh) * n + i;
    const float lse_i = lse[stat];
    if (row_ok) delta[stat] = dl;

    const T* kb = k + b * k_sb + hh * D;
    const T* vb = v + b * v_sb + hh * D;
    for (int j0 = 0; j0 < n; j0 += BN) {
      __syncthreads();  // the previous tile is consumed
      for (int e = li; e < BN * D; e += BM) {
        const int lj = e / D, c = e - (e / D) * D;
        const int j = j0 + lj;
        const bool ok = j < n;
        ks[e] = ok ? Cvt<T>::to(kb[j * k_sn + c]) : 0.f;
        vs[e] = ok ? Cvt<T>::to(vb[j * v_sn + c]) : 0.f;
      }
      const int rbase = i0 - j0 - (BN - 1);
      for (int e = li; e < (BM + BN - 1) * D; e += BM) {
        const int rr = e / D, c = e - (e / D) * D;
        const int rel = clip_offset(rbase + rr, max_pos) + max_pos;
        es[rr * DP + c] = Cvt<T>::to(table[rel * D + c]);
      }
      __syncthreads();

      for (int lj = 0; lj < BN; ++lj) {
        const float4* kr = reinterpret_cast<const float4*>(ks + lj * D);
        const float4* vr = reinterpret_cast<const float4*>(vs + lj * D);
        const float4* er =
            reinterpret_cast<const float4*>(es + (li - lj + BN - 1) * DP);
        float dot = 0.f, bias = 0.f, dpv = 0.f;
#pragma unroll
        for (int c = 0; c < D4; ++c) {
          const float4 kk = kr[c];
          const float4 ee = er[c];
          const float4 vv = vr[c];
          dot = fmaf(qr[4 * c + 0], kk.x, dot);
          dot = fmaf(qr[4 * c + 1], kk.y, dot);
          dot = fmaf(qr[4 * c + 2], kk.z, dot);
          dot = fmaf(qr[4 * c + 3], kk.w, dot);
          bias = fmaf(qr[4 * c + 0], ee.x, bias);
          bias = fmaf(qr[4 * c + 1], ee.y, bias);
          bias = fmaf(qr[4 * c + 2], ee.z, bias);
          bias = fmaf(qr[4 * c + 3], ee.w, bias);
          dpv = fmaf(gr[4 * c + 0], vv.x, dpv);
          dpv = fmaf(gr[4 * c + 1], vv.y, dpv);
          dpv = fmaf(gr[4 * c + 2], vv.z, dpv);
          dpv = fmaf(gr[4 * c + 3], vv.w, dpv);
        }
        const float s = (dot + bias) * scale;
        const bool ok = row_ok && (j0 + lj < n);
        const float p = ok ? expf(s - lse_i) : 0.f;
        const float dp = round_to<T>(p * (dpv - dl) * scale);
        float* wr = wb + (lane - lj + BN - 1) * WP;
#pragma unroll
        for (int c = 0; c < D4; ++c) {
          const float4 kk = kr[c];
          const float4 ee = er[c];
          acc[4 * c + 0] = fmaf(dp, kk.x, fmaf(dp, ee.x, acc[4 * c + 0]));
          acc[4 * c + 1] = fmaf(dp, kk.y, fmaf(dp, ee.y, acc[4 * c + 1]));
          acc[4 * c + 2] = fmaf(dp, kk.z, fmaf(dp, ee.z, acc[4 * c + 2]));
          acc[4 * c + 3] = fmaf(dp, kk.w, fmaf(dp, ee.w, acc[4 * c + 3]));
        }
#pragma unroll
        for (int c = 0; c < D; ++c) wr[c] = fmaf(qr[c], dp, wr[c]);
        __syncwarp();  // lanes of the next key add to rows this one read
      }

      // fold this warp's band into the block band: warp row rr is offset
      // i0 + 32 w - j0 - (BN - 1) + rr
      const int obase = i0 + w * kWarp - j0 - (BN - 1);
      for (int e = lane; e < WR * D; e += kWarp) {
        const int rr = e / D, c = e - (e / D) * D;
        const int o = obase + rr;
        float* src = wb + rr * WP + c;
        if (o >= o_lo && o <= o_hi) {
          atomicAdd(band + (clip_offset(o, max_pos) + max_pos - r_lo) * D + c,
                    *src);
        }
        *src = 0.f;
      }
      __syncwarp();
    }

    if (row_ok) {
      T* dqp = dq + row * D;
#pragma unroll
      for (int c = 0; c < D; ++c) dqp[c] = Cvt<T>::from(acc[c]);
    }
  }

  __syncthreads();  // every warp has folded
  for (int e = li; e < band_rows * D; e += BM)
    atomicAdd(dtable + static_cast<long long>(r_lo) * D + e, band[e]);
}

// Pass B: dk and dv.  Block: (sequence, head, key tile of BN rows); one
// thread per key row; queries streamed in tiles of BM.
template <typename T, int D, int BM, int BN>
__global__ void __launch_bounds__(BN)
    shaw_bwd_key_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ table,
                        const T* __restrict__ g, const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dk,
                        T* __restrict__ dv, int n, int h, long long q_sb,
                        long long q_sn, long long k_sb, long long k_sn,
                        long long v_sb, long long v_sn, int max_pos,
                        float scale) {
  constexpr int DP = (D == 4) ? 4 : D + 4;
  constexpr int D4 = D / 4;
  __shared__ __align__(16) float qs[BM * D];
  __shared__ __align__(16) float gs[BM * D];
  __shared__ __align__(16) float es[(BM + BN - 1) * DP];
  __shared__ float lses[BM];
  __shared__ float dls[BM];

  const int b = blockIdx.x / h;
  const int hh = blockIdx.x - b * h;
  const int j0 = blockIdx.y * BN;
  const int lj = threadIdx.x;
  const bool col_ok = j0 + lj < n;
  const int j = col_ok ? j0 + lj : n - 1;

  const T* kp = k + b * k_sb + j * k_sn + hh * D;
  const T* vp = v + b * v_sb + j * v_sn + hh * D;
  float kr[D], vr[D], dka[D], dva[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    kr[c] = Cvt<T>::to(kp[c]);
    vr[c] = Cvt<T>::to(vp[c]);
    dka[c] = 0.f;
    dva[c] = 0.f;
  }
  const T* qb = q + b * q_sb + hh * D;
  const long long gb = static_cast<long long>(b) * n * h + hh;  // row (b, 0, hh)
  const long long sb = (static_cast<long long>(b) * h + hh) * n;

  for (int i0 = 0; i0 < n; i0 += BM) {
    __syncthreads();
    for (int e = lj; e < BM * D; e += BN) {
      const int li = e / D, c = e - (e / D) * D;
      const int i = i0 + li;
      const bool ok = i < n;
      qs[e] = ok ? Cvt<T>::to(qb[i * q_sn + c]) : 0.f;
      gs[e] = ok ? Cvt<T>::to(g[(gb + static_cast<long long>(i) * h) * D + c])
                 : 0.f;
    }
    for (int li = lj; li < BM; li += BN) {
      const bool ok = i0 + li < n;
      lses[li] = ok ? lse[sb + i0 + li] : 0.f;
      dls[li] = ok ? delta[sb + i0 + li] : 0.f;
    }
    // offsets i - j of this tile run from i0 - j0 - (BN - 1) upwards
    const int rbase = i0 - j0 - (BN - 1);
    for (int e = lj; e < (BM + BN - 1) * D; e += BN) {
      const int rr = e / D, c = e - (e / D) * D;
      const int rel = clip_offset(rbase + rr, max_pos) + max_pos;
      es[rr * DP + c] = Cvt<T>::to(table[rel * D + c]);
    }
    __syncthreads();

    for (int li = 0; li < BM; ++li) {
      const float4* qr = reinterpret_cast<const float4*>(qs + li * D);
      const float4* gr = reinterpret_cast<const float4*>(gs + li * D);
      const float4* er =
          reinterpret_cast<const float4*>(es + (li - lj + BN - 1) * DP);
      float dot = 0.f, bias = 0.f, dpv = 0.f;
#pragma unroll
      for (int c = 0; c < D4; ++c) {
        const float4 qq = qr[c];
        const float4 ee = er[c];
        const float4 gg = gr[c];
        dot = fmaf(qq.x, kr[4 * c + 0], dot);
        dot = fmaf(qq.y, kr[4 * c + 1], dot);
        dot = fmaf(qq.z, kr[4 * c + 2], dot);
        dot = fmaf(qq.w, kr[4 * c + 3], dot);
        bias = fmaf(qq.x, ee.x, bias);
        bias = fmaf(qq.y, ee.y, bias);
        bias = fmaf(qq.z, ee.z, bias);
        bias = fmaf(qq.w, ee.w, bias);
        dpv = fmaf(gg.x, vr[4 * c + 0], dpv);
        dpv = fmaf(gg.y, vr[4 * c + 1], dpv);
        dpv = fmaf(gg.z, vr[4 * c + 2], dpv);
        dpv = fmaf(gg.w, vr[4 * c + 3], dpv);
      }
      const float s = (dot + bias) * scale;
      const bool ok = col_ok && (i0 + li < n);
      const float p = ok ? expf(s - lses[li]) : 0.f;
      const float pc = round_to<T>(p);  // attn_c: P in the operand dtype
      const float dp = round_to<T>(p * (dpv - dls[li]) * scale);
#pragma unroll
      for (int c = 0; c < D4; ++c) {
        const float4 qq = qr[c];
        const float4 gg = gr[c];
        dva[4 * c + 0] = fmaf(pc, gg.x, dva[4 * c + 0]);
        dva[4 * c + 1] = fmaf(pc, gg.y, dva[4 * c + 1]);
        dva[4 * c + 2] = fmaf(pc, gg.z, dva[4 * c + 2]);
        dva[4 * c + 3] = fmaf(pc, gg.w, dva[4 * c + 3]);
        dka[4 * c + 0] = fmaf(dp, qq.x, dka[4 * c + 0]);
        dka[4 * c + 1] = fmaf(dp, qq.y, dka[4 * c + 1]);
        dka[4 * c + 2] = fmaf(dp, qq.z, dka[4 * c + 2]);
        dka[4 * c + 3] = fmaf(dp, qq.w, dka[4 * c + 3]);
      }
    }
  }

  if (col_ok) {
    const long long row = (static_cast<long long>(b) * n + j) * h + hh;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      dk[row * D + c] = Cvt<T>::from(dka[c]);
      dv[row * D + c] = Cvt<T>::from(dva[c]);
    }
  }
}

constexpr int kBM = 64;  // query rows per pass-A block, query tile of pass B
constexpr int kBN = 64;  // key rows per pass-B block, key tile of pass A

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* table,
           const void* out, const void* g, const float* lse, float* delta,
           void* dq, void* dk, void* dv, float* dtable, int batch, int n,
           int h, long long q_sb, long long q_sn, long long k_sb,
           long long k_sn, long long v_sb, long long v_sn, int max_pos,
           float scale, int groups, int band_rows, cudaStream_t stream) {
  const size_t band_bytes = static_cast<size_t>(band_rows) * D * sizeof(float);
  auto* qk = shaw_bwd_query_kernel<T, D, kBM, kBN>;
  cudaError_t err = cudaFuncSetAttribute(
      qk, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(band_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_a(h * ((n + kBM - 1) / kBM), groups);
  qk<<<grid_a, kBM, band_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(table),
      static_cast<const T*>(out), static_cast<const T*>(g), lse, delta,
      static_cast<T*>(dq), dtable, batch, n, h, q_sb, q_sn, k_sb, k_sn, v_sb,
      v_sn, max_pos, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_b(batch * h, (n + kBN - 1) / kBN);
  shaw_bwd_key_kernel<T, D, kBM, kBN><<<grid_b, kBN, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(table),
      static_cast<const T*>(g), lse, delta, static_cast<T*>(dk),
      static_cast<T*>(dv), n, h, q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, max_pos,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v,
               const void* table, const void* out, const void* g,
               const float* lse, float* delta, void* dq, void* dk, void* dv,
               float* dtable, int batch, int n, int h, long long q_sb,
               long long q_sn, long long k_sb, long long k_sn, long long v_sb,
               long long v_sn, int max_pos, float scale, int groups,
               int band_rows, cudaStream_t stream) {
  switch (d) {
    case 4:
      return launch<T, 4>(q, k, v, table, out, g, lse, delta, dq, dk, dv,
                          dtable, batch, n, h, q_sb, q_sn, k_sb, k_sn, v_sb,
                          v_sn, max_pos, scale, groups, band_rows, stream);
    case 8:
      return launch<T, 8>(q, k, v, table, out, g, lse, delta, dq, dk, dv,
                          dtable, batch, n, h, q_sb, q_sn, k_sb, k_sn, v_sb,
                          v_sn, max_pos, scale, groups, band_rows, stream);
  }
  // d 16 and 32: the tensor-core instances'
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k, v: [batch, n, h, d] with unit stride over d and stride d over h;
// the batch and sequence strides (in elements) are given.  table:
// [2 * max_pos + 1, d] contiguous in the dtype of q.  out (the forward's
// output), g (its gradient), dq, dk, dv: contiguous [batch, n, h, d] in the
// dtype of q.  lse (from the forward) and delta (scratch): [batch, h, n]
// fp32.  dtable: [2 * max_pos + 1, d] fp32, zeroed by the caller.  groups:
// pass A's grid-stride over the batch; band_rows: the largest block band,
// min(64 + n - 1, 2 * max_pos + 1).  is_bf16 selects bfloat16 over fp32.
// d is 4 or 8; d 16 or 32 returns cudaErrorInvalidValue
// (shaw_attention_bwd_mma.cu and shaw_attention_bwd_tf32.cu take them).
extern "C" int se_shaw_attention_bwd(
    const void* q, const void* k, const void* v, const void* table,
    const void* out, const void* g, const void* lse, void* delta, void* dq,
    void* dk, void* dv, void* dtable, int is_bf16, int batch, int n, int h,
    int d, long long q_sb, long long q_sn, long long k_sb, long long k_sn,
    long long v_sb, long long v_sn, int max_pos, float scale, int groups,
    int band_rows, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* dt = static_cast<float*>(dtable);
  if (is_bf16)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, table, out, g, l, dl, dq, dk,
                                     dv, dt, batch, n, h, q_sb, q_sn, k_sb,
                                     k_sn, v_sb, v_sn, max_pos, scale, groups,
                                     band_rows, st);
  return dispatch_d<float>(d, q, k, v, table, out, g, l, dl, dq, dk, dv, dt,
                           batch, n, h, q_sb, q_sn, k_sb, k_sn, v_sb, v_sn,
                           max_pos, scale, groups, band_rows, st);
}
