// The middle of the conformers' conv module, for Hopper, in the inference
// forward (speech_enhancement_tpu_torch/models/conformer.py, ConvModule):
//
//   g = GLU(u) = u[:, :C] * sigmoid(u[:, C:])     u: [B, 2C, N], the first
//                                                 pointwise conv's output
//   d = depthwise conv of g, odd k <= 31, zero padding k / 2 on each side,
//       plus its bias
//   z = d * scale + shift                         eval BatchNorm: scale =
//                                                 w / sqrt(var + eps), shift
//                                                 = b - mean * scale
//   out = z * sigmoid(z)                          Swish; [B, C, N],
//                                                 channels-major contiguous
//
// fp32, or bf16 with fp32 arithmetic: g, d, z, sigmoid(z) and out are
// rounded to the storage type where aten's GLU, depthwise conv, BatchNorm,
// sigmoid and mul store them.  Both sigmoids are 1 / (1 + expf(-x)), as
// aten's; the taps are summed in aten's order (bias first, then tap 0 to
// k - 1, one fma each).
//
// Replaces no TPU kernel: XLA fuses this chain on the TPU.  On the card it
// replaces seven eager kernels (GLU, the pad's fill and copy, aten's
// conv_depthwise2d_forward, cuDNN's BatchNorm, sigmoid, mul; ten where a
// tensor needs 64-bit indexing), which write and read the 128-channel
// tensor between every two of them.
//
// What bounds it on an H100: device-memory bandwidth in principle.  It
// reads u once and writes out once, 3C elements a frame: at the 8 s
// serving bucket ([3232, 256, 1281] in, fp32) 6.36 GB, 1.90 ms at 3.35
// TB/s.  In practice instruction issue comes close: 31 fmas an output, and
// two sigmoids of about 16 instructions each (expf and an IEEE reciprocal),
// keep it near 70% of the bytes' bound at that shape, and bf16 no faster
// than fp32.  So the design spends registers on resident warps.
//
// Design (256 threads, a block per 32 channels x 128 output frames of one
// sequence, four blocks an SM: at most 64 registers a thread):
// * the block stages g for its 32 channels over its 128 frames and 15
//   frames of halo each side in shared memory, fp32, at a pitch of 159
//   (odd: a warp whose lanes are 32 channels reads 32 banks).  Frames
//   outside [0, N) stage as 0: that is the zero padding, and no padded
//   copy exists.  u is read coalesced in either layout: channels-major (a
//   warp along 32 frames of one channel) or rows, [B, N, 2C] contiguous as
//   cuDNN leaves a channels-last product (a warp along 32 channels of one
//   frame).  Each thread stages 20 values, issuing all 40 loads before its
//   first sigmoid;
// * the taps (centred in 31, zeros around a shorter kernel) are staged
//   once per block, contiguous in memory, then held in registers: each
//   lane owns one channel, each warp 16 output frames, computed 8 at a
//   time (4 with u in rows) tap by tap, so that 8 sums and a sliding
//   window of 8 staged values are live besides the taps (runs wholly past
//   N are skipped: the frequency conformers' N is 101);
// * each output goes to a second tile (pitch 129) as it is computed, and
//   the tile is stored along N, coalesced, into the channels-major output.
// The halo is re-read by the neighbouring tile (158 frames staged for 128
// written, from L2 where the neighbours run together).
//
// The C entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "cvt.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 32;                  // channels a block: one a lane
constexpr int kTaps = 31;                   // the longest kernel taken
constexpr int kHalo = kTaps / 2;            // frames staged beyond each edge
constexpr int kTile = 128;                  // output frames a block
constexpr int kStaged = kTile + 2 * kHalo;  // 158
constexpr int kPitch = kStaged + 1;         // floats a staged channel (odd)
constexpr int kOutPitch = kTile + 1;        // floats a channel of outputs (odd)
constexpr int kPerWarp = kTile / kWarps;    // output frames a warp
constexpr int kPasses = 4;                  // staging passes
constexpr int kPerPass = 5;                 // values a thread stages a pass
constexpr int kSmemFloats = kGroup * (kPitch + kOutPitch + kTaps);

static_assert(kPasses * kPerPass * kThreads >= kGroup * kStaged, "staging covers the tile");
static_assert(kPasses * kWarps == kGroup && kPerPass * 32 >= kStaged,
              "channels-major staging: a warp a channel a pass, 32 frames a step");
static_assert(kPerWarp % 8 == 0, "a warp's frames are whole runs");

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

template <typename T, bool kRows>
__global__ void __launch_bounds__(kThreads, 4)
    glu_conv_swish_kernel(const T* __restrict__ u, const T* __restrict__ w,
                          const T* __restrict__ wb, const T* __restrict__ gamma,
                          const T* __restrict__ beta, const T* __restrict__ mean,
                          const T* __restrict__ var, T* __restrict__ out, int channels,
                          int seq, int taps, int tiles, int groups, float eps) {
  extern __shared__ float smem[];
  float* tile_g = smem;                       // [kGroup][kPitch]: g staged
  float* tile_o = tile_g + kGroup * kPitch;   // [kGroup][kOutPitch]: outputs
  float* tile_w = tile_o + kGroup * kOutPitch;  // [kGroup][kTaps]: taps
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int tile = blockIdx.x % tiles;
  const int rest = blockIdx.x / tiles;
  const int c0 = (rest % groups) * kGroup;
  const long long b = rest / groups;
  const int n0 = tile * kTile;
  const int m0 = n0 - kHalo;  // the frame of staged slot 0

  const int lead = kHalo - taps / 2;  // zero taps before the kernel's first
  for (int i = tid; i < kGroup * kTaps; i += kThreads) {
    const int c = i / kTaps, j = i - c * kTaps - lead;
    tile_w[i] = (c0 + c < channels && j >= 0 && j < taps)
                    ? Cvt<T>::to(w[static_cast<long long>(c0 + c) * taps + j])
                    : 0.0f;
  }

  // g = a * sigmoid(gate), 0 outside [0, seq) and past the last channel.
  // Slot (pass p, step i): channels-major, channel warp + 8p and frame
  // slot lane + 32i; rows, channel lane and frame slot warp + 8(5p + i).
  // Every load of the thread is issued before the first sigmoid.
  // Offsets inside one sequence fit in 32 bits (the entry point checks).
  const int step = kRows ? kWarps : 32;
  const T* u_b = u + b * 2 * channels * seq;  // this sequence's [2C, N] or [N, 2C]
  const int stride = kRows ? 2 * channels : 1;
  const int gate = kRows ? channels : channels * seq;
  float va[kPasses * kPerPass], vb[kPasses * kPerPass];
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int c = kRows ? lane : warp + kWarps * p;
    const int s0 = kRows ? warp + kWarps * kPerPass * p : lane;
    const int at = kRows ? c0 + c : (c0 + c) * seq;
#pragma unroll
    for (int i = 0; i < kPerPass; ++i) {
      const int m = m0 + s0 + i * step;
      float a = 0.0f, g = 0.0f;  // 0 * sigmoid(0): the padding
      if (c0 + c < channels && m >= 0 && m < seq && s0 + i * step < kStaged) {
        const int q = at + m * stride;
        a = Cvt<T>::to(u_b[q]);
        g = Cvt<T>::to(u_b[q + gate]);
      }
      va[p * kPerPass + i] = a;
      vb[p * kPerPass + i] = g;
    }
  }
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int c = kRows ? lane : warp + kWarps * p;
    const int s0 = kRows ? warp + kWarps * kPerPass * p : lane;
#pragma unroll
    for (int i = 0; i < kPerPass; ++i) {
      const int s = s0 + i * step;
      if (s < kStaged)
        tile_g[c * kPitch + s] =
            round_to<T>(va[p * kPerPass + i] * sigmoid(vb[p * kPerPass + i]));
    }
  }
  __syncthreads();

  // each lane: one channel; each warp: kPerWarp frames, kRun at a time,
  // tap by tap (bias first, then taps 0 to 30: aten's order for each output)
  const int ch = c0 + lane;
  float wk[kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) wk[k] = tile_w[lane * kTaps + k];
  float bias = 0.0f, scale = 1.0f, shift = 0.0f;
  if (ch < channels) {
    bias = Cvt<T>::to(wb[ch]);
    scale = Cvt<T>::to(gamma[ch]) / sqrtf(Cvt<T>::to(var[ch]) + eps);
    shift = Cvt<T>::to(beta[ch]) - Cvt<T>::to(mean[ch]) * scale;
  }
  const float* row_g = tile_g + lane * kPitch + warp * kPerWarp;
  float* row_o = tile_o + lane * kOutPitch + warp * kPerWarp;
  // outputs summed together: 4 where the rows layout's 32-bit offsets take
  // the registers 8 would need (ptxas spills at 64 a thread)
  constexpr int kRun = kRows ? 4 : 8;
#pragma unroll 1
  for (int r = 0; r < kPerWarp; r += kRun) {
    if (n0 + warp * kPerWarp + r >= seq) break;  // the same for the whole warp
    float acc[kRun];
#pragma unroll
    for (int j = 0; j < kRun; ++j) acc[j] = bias;
#pragma unroll
    for (int k = 0; k < kTaps; ++k)
#pragma unroll
      for (int j = 0; j < kRun; ++j) acc[j] = fmaf(wk[k], row_g[r + j + k], acc[j]);
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const float z = round_to<T>(fmaf(round_to<T>(acc[j]), scale, shift));
      row_o[r + j] = round_to<T>(z * round_to<T>(sigmoid(z)));
    }
  }
  __syncthreads();

  // a warp a channel, 32 frames a step: coalesced along N
#pragma unroll 1
  for (int c = warp; c < kGroup && c0 + c < channels; c += kWarps) {
    T* dst = out + (b * channels + c0 + c) * seq + n0;
    const float* src = tile_o + c * kOutPitch;
#pragma unroll
    for (int j = lane; j < kTile; j += 32)
      if (n0 + j < seq) dst[j] = Cvt<T>::from(src[j]);
  }
}

template <typename T>
int launch(const void* u, const void* w, const void* wb, const void* gamma, const void* beta,
           const void* mean, const void* var, void* out, long long batch, int channels,
           int seq, int taps, bool rows, float eps, cudaStream_t stream) {
  const int tiles = (seq + kTile - 1) / kTile;
  const int groups = (channels + kGroup - 1) / kGroup;
  const long long blocks = batch * groups * tiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = rows ? glu_conv_swish_kernel<T, true> : glu_conv_swish_kernel<T, false>;
  constexpr int bytes = kSmemFloats * sizeof(float);
  static const cudaError_t set = [] {  // once per instance pair, at its first launch
    cudaError_t err = cudaFuncSetAttribute(glu_conv_swish_kernel<T, true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(glu_conv_swish_kernel<T, false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    return err;
  }();
  if (set != cudaSuccess) return static_cast<int>(set);
  kernel<<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(w), static_cast<const T*>(wb),
      static_cast<const T*>(gamma), static_cast<const T*>(beta), static_cast<const T*>(mean),
      static_cast<const T*>(var), static_cast<T*>(out), channels, seq, taps, tiles, groups,
      eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// u: [batch, 2 channels, seq], channels-major contiguous (rows 0) or as a
// contiguous [batch, seq, 2 channels] (rows 1); w: [channels, taps]
// contiguous; wb: the conv's bias; gamma, beta: BatchNorm's affine; mean,
// var: its running statistics; out: [batch, channels, seq] contiguous.
// All of one type: elem_bytes 4 fp32, 2 bf16.  taps odd, at most 31;
// batch, channels, seq > 0; 2 channels x seq < 2^31.
extern "C" int se_glu_conv_swish(const void* u, const void* w, const void* wb,
                                 const void* gamma, const void* beta, const void* mean,
                                 const void* var, void* out, long long batch, int channels,
                                 int seq, int taps, int rows, int elem_bytes, float eps,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || channels <= 0 || seq <= 0 || taps < 1 || taps > kTaps || taps % 2 == 0 ||
      (rows != 0 && rows != 1) || 2LL * channels * seq > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (elem_bytes == 4)
    return launch<float>(u, w, wb, gamma, beta, mean, var, out, batch, channels, seq, taps,
                         rows == 1, eps, st);
  if (elem_bytes == 2)
    return launch<__nv_bfloat16>(u, w, wb, gamma, beta, mean, var, out, batch, channels, seq,
                                 taps, rows == 1, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
