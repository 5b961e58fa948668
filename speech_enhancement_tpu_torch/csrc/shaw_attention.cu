// Fused Shaw relative-position attention forward (K1) for Hopper.
//
// Replaces the TPU kernel speech_enhancement_tpu/ops/pallas_attention.py
// (_attn_kernel, driven by _kernel_call and fused_shaw_attention):
//
//   out[b, i, h] = softmax_j((q_i . k_j + q_i . E[clip(i - j, +-P) + P]) * scale) . v_j
//
// for all heads, with q, k, v read as [B, n, h*d] rows (the layout the
// projection Linear writes), logits and softmax in fp32, P rounded to the
// operand dtype before P.V, and an fp32 accumulator.  When the caller
// passes an ``lse`` buffer ([B, h, n] fp32), each row's log-sum-exp of the
// scaled logits is written there, so that the backward (K2,
// csrc/shaw_attention_bwd.cu) rebuilds P = exp(s - lse) without a second
// softmax pass; serving passes none and writes nothing.
//
// This is the CUDA-core instance, for the head dims below one mma k-step:
// fp32 and bf16 at 4 and 8.  Head dims 16 and 32 are the tensor-core
// instances' (csrc/shaw_attention_mma.cu for bf16,
// csrc/shaw_attention_tf32.cu for fp32 in 3xTF32), and the entry point here
// refuses them, so each (dtype, head dim) has one forward kernel.
//
// What bounds it on an H100: the three n x n x d contractions (~32 GFLOP
// at B = 3232 sequences, n = 321, h = 4, d = 4), and the fp32 logits the
// plain version materializes (5.3 GB there).  This kernel never writes
// logits: it is bound by the instruction throughput and shared-memory
// bandwidth of its fp32 multiply-adds.
//
// Design:
// * one block of BM threads per (sequence, head, BM queries); each thread
//   owns one query row, holding q_i, its output accumulator and its
//   running max and sum in registers;
// * keys stream through shared memory in tiles of BN with an online
//   softmax, so shared memory is bounded for any n;
// * the Shaw bias is computed from the table rows E[clip(i - j)] for the
//   BM + BN - 1 distinct offsets of the tile, staged in shared memory with
//   a row pitch that makes the per-thread float4 reads conflict-free; the
//   [n, n, d] gather the plain version builds never exists;
// * k and v may be strided views (the two halves of the to_kv output), so
//   the caller needs no copy or head transpose.
//
// The C entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "cvt.cuh"

namespace {

template <typename T, int D, int BM, int BN>
__global__ void __launch_bounds__(BM)
    shaw_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ table,
                          T* __restrict__ out, float* __restrict__ lse,
                          int n, int h, long long q_sb,
                          long long q_sn, long long k_sb, long long k_sn,
                          long long v_sb, long long v_sn, int max_pos,
                          float scale) {
  // row pitch of the bias rows: 8 threads of a float4 phase hit 8 distinct
  // 4-bank groups
  constexpr int DP = (D == 4) ? 4 : D + 4;
  constexpr int D4 = D / 4;
  __shared__ __align__(16) float ks[BN * D];
  __shared__ __align__(16) float vs[BN * D];
  __shared__ __align__(16) float es[(BM + BN - 1) * DP];

  const int b = blockIdx.x / h;
  const int hh = blockIdx.x - b * h;
  const int i0 = blockIdx.y * BM;
  const int li = threadIdx.x;
  // rows past n compute row n - 1 and store nothing
  const int i = min(i0 + li, n - 1);

  const T* kb = k + b * k_sb + hh * D;
  const T* vb = v + b * v_sb + hh * D;
  const T* qp = q + b * q_sb + i * q_sn + hh * D;

  float qr[D], o[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    qr[c] = Cvt<T>::to(qp[c]);
    o[c] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int j0 = 0; j0 < n; j0 += BN) {
    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < BN * D; e += BM) {
      const int lj = e / D, c = e - (e / D) * D;
      const int j = j0 + lj;
      const bool ok = j < n;
      ks[e] = ok ? Cvt<T>::to(kb[j * k_sn + c]) : 0.f;
      vs[e] = ok ? Cvt<T>::to(vb[j * v_sn + c]) : 0.f;
    }
    // offsets i - j of this tile run from i0 - j0 - (BN - 1) upwards
    const int rbase = i0 - j0 - (BN - 1);
    for (int e = threadIdx.x; e < (BM + BN - 1) * D; e += BM) {
      const int rr = e / D, c = e - (e / D) * D;
      const int rel = min(max(rbase + rr, -max_pos), max_pos) + max_pos;
      es[rr * DP + c] = Cvt<T>::to(table[rel * D + c]);
    }
    __syncthreads();

    float s[BN];
    float tile_max = -INFINITY;
#pragma unroll
    for (int lj = 0; lj < BN; ++lj) {
      const float4* kr = reinterpret_cast<const float4*>(ks + lj * D);
      const float4* er =
          reinterpret_cast<const float4*>(es + (li - lj + BN - 1) * DP);
      float dot = 0.f, bias = 0.f;
#pragma unroll
      for (int c = 0; c < D4; ++c) {
        const float4 kk = kr[c];
        const float4 ee = er[c];
        dot = fmaf(qr[4 * c + 0], kk.x, dot);
        dot = fmaf(qr[4 * c + 1], kk.y, dot);
        dot = fmaf(qr[4 * c + 2], kk.z, dot);
        dot = fmaf(qr[4 * c + 3], kk.w, dot);
        bias = fmaf(qr[4 * c + 0], ee.x, bias);
        bias = fmaf(qr[4 * c + 1], ee.y, bias);
        bias = fmaf(qr[4 * c + 2], ee.z, bias);
        bias = fmaf(qr[4 * c + 3], ee.w, bias);
      }
      const float sc = (j0 + lj < n) ? (dot + bias) * scale : -INFINITY;
      s[lj] = sc;
      tile_max = fmaxf(tile_max, sc);
    }
    // every tile holds at least one valid key, so m_new is finite
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int c = 0; c < D; ++c) o[c] *= corr;
#pragma unroll
    for (int lj = 0; lj < BN; ++lj) {
      const float p = expf(s[lj] - m_new);
      l += p;
      const float pv = round_to<T>(p);  // P in the v dtype
      const float4* vr = reinterpret_cast<const float4*>(vs + lj * D);
#pragma unroll
      for (int c = 0; c < D4; ++c) {
        const float4 vv = vr[c];
        o[4 * c + 0] = fmaf(pv, vv.x, o[4 * c + 0]);
        o[4 * c + 1] = fmaf(pv, vv.y, o[4 * c + 1]);
        o[4 * c + 2] = fmaf(pv, vv.z, o[4 * c + 2]);
        o[4 * c + 3] = fmaf(pv, vv.w, o[4 * c + 3]);
      }
    }
    m = m_new;
  }

  if (i0 + li < n) {
    T* op = out + ((static_cast<long long>(b) * n + i0 + li) * h + hh) * D;
    const float inv = 1.f / l;
#pragma unroll
    for (int c = 0; c < D; ++c) op[c] = Cvt<T>::from(o[c] * inv);
    if (lse != nullptr)
      lse[(static_cast<long long>(b) * h + hh) * n + i0 + li] = m + logf(l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* table,
           void* out, float* lse, int batch, int n, int h, long long q_sb,
           long long q_sn, long long k_sb, long long k_sn, long long v_sb,
           long long v_sn, int max_pos, float scale, cudaStream_t stream) {
  constexpr int BM = 64, BN = 64;
  const dim3 grid(batch * h, (n + BM - 1) / BM);
  shaw_attention_kernel<T, D, BM, BN><<<grid, BM, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(table),
      static_cast<T*>(out), lse, n, h, q_sb, q_sn, k_sb, k_sn, v_sb, v_sn,
      max_pos, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v,
               const void* table, void* out, float* lse, int batch, int n,
               int h, long long q_sb, long long q_sn, long long k_sb,
               long long k_sn, long long v_sb, long long v_sn, int max_pos,
               float scale, cudaStream_t stream) {
  switch (d) {
    case 4:
      return launch<T, 4>(q, k, v, table, out, lse, batch, n, h, q_sb, q_sn,
                          k_sb, k_sn, v_sb, v_sn, max_pos, scale, stream);
    case 8:
      return launch<T, 8>(q, k, v, table, out, lse, batch, n, h, q_sb, q_sn,
                          k_sb, k_sn, v_sb, v_sn, max_pos, scale, stream);
  }
  // d 16 and 32: the tensor-core instances'
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k, v: [batch, n, h, d] with unit stride over d and stride d over h;
// the batch and sequence strides (in elements) are given.  table:
// [2 * max_pos + 1, d] contiguous, in the dtype of q.  out: contiguous
// [batch, n, h, d] in the dtype of q.  lse: null, or [batch, h, n] fp32.
// is_bf16 selects bfloat16 over fp32.  d is 4 or 8; 16 and 32 return
// cudaErrorInvalidValue (shaw_attention_mma.cu and shaw_attention_tf32.cu
// take them).
extern "C" int se_shaw_attention(const void* q, const void* k, const void* v,
                                 const void* table, void* out, void* lse,
                                 int is_bf16, int batch, int n, int h, int d,
                                 long long q_sb, long long q_sn,
                                 long long k_sb, long long k_sn,
                                 long long v_sb, long long v_sn, int max_pos,
                                 float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, table, out,
                                     static_cast<float*>(lse), batch, n, h,
                                     q_sb, q_sn, k_sb, k_sn, v_sb, v_sn,
                                     max_pos, scale, st);
  return dispatch_d<float>(d, q, k, v, table, out, static_cast<float*>(lse),
                           batch, n, h, q_sb, q_sn, k_sb, k_sn, v_sb, v_sn,
                           max_pos, scale, st);
}
