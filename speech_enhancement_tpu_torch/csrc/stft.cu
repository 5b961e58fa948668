// Fused STFT -> power-compress (K4) and uncompress -> iSTFT (K5) for Hopper.
//
// Replaces the TPU kernels speech_enhancement_tpu/ops/pallas_stft.py
// (_stft_kernel via pallas_stft, _istft_kernel via pallas_istft).
//
// What bounds them on an H100: both are tiny in arithmetic (the serving
// shape [32, 32000] needs ~1.6 G multiply-adds each way) and read and
// write a few MB, so they are bound by shared-memory traffic and launch
// latency, not by the tensor cores or HBM.  The TPU kernels were built
// around the MXU (hop-block matmuls against a window-folded basis held in
// VMEM); here the DFT is a plain sum with exact twiddles.
//
// Design:
// * twiddles cos/sin(2*pi*k/n_fft), k < n_fft, are computed once per block
//   in double precision into shared memory, and the angle index
//   (n*f) mod n_fft is advanced incrementally, so every basis value is the
//   correctly rounded float of the exact angle;
// * the periodic Hamming window (computed the same way) is folded into
//   the twiddle at each step;
// * K4: one block per (utterance, tile of kFrames frames).  The block
//   stages its reflect-padded signal segment in shared memory; each thread
//   owns one frequency bin and accumulates all kFrames frames, so one
//   twiddle load serves kFrames multiply-adds and the signal reads are
//   warp-wide broadcasts;
// * K5: one block per (utterance, kHopBlocks output hop blocks).  The block
//   inverts the frames that cover its samples into shared memory (the
//   r - 1 frames overlapping the neighbouring block are recomputed there),
//   then every output sample gathers its r frames.  No atomics, so the
//   result is deterministic; the window-sum-square division, the center
//   trim and the cut to `length` happen in the same pass.
//
// Each C entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kFrames = 16;      // K4: frames per block
constexpr int kStftThreads = 256;
constexpr int kHopBlocks = 8;    // K5: output hop blocks per block
constexpr int kMaxR = 8;         // K5: largest n_fft / hop supported
constexpr int kMaxFrames = kHopBlocks + kMaxR;

// cos/sin(2*pi*k/n) for k < n, and the periodic Hamming window
// 0.54 - 0.46*cos(2*pi*k/n), all rounded once from double precision.
__device__ void fill_tables(float* cos_t, float* sin_t, float* win, int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    double s, c;
    sincospi(2.0 * k / n, &s, &c);
    cos_t[k] = static_cast<float>(c);
    sin_t[k] = static_cast<float>(s);
    win[k] = static_cast<float>(0.54 - 0.46 * c);
  }
}

__global__ void stft_kernel(const float* __restrict__ x, float2* __restrict__ out,
                            int L, int T, int F, int n_fft, int hop,
                            int compress) {
  extern __shared__ float smem[];
  float* cos_t = smem;
  float* sin_t = cos_t + n_fft;
  float* win = sin_t + n_fft;
  float* seg = win + n_fft;  // (kFrames - 1) * hop + n_fft samples

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kFrames;
  const int pad = n_fft / 2;
  const int seg_len = (kFrames - 1) * hop + n_fft;
  const float* xb = x + static_cast<size_t>(b) * L;

  fill_tables(cos_t, sin_t, win, n_fft);
  for (int k = threadIdx.x; k < seg_len; k += blockDim.x) {
    int p = t0 * hop + k - pad;  // index into the unpadded signal
    if (p < 0) p = -p;                      // reflect (torch 'reflect')
    if (p >= L) p = 2 * (L - 1) - p;
    // only frames past the end of the signal read outside [0, L)
    seg[k] = (p >= 0 && p < L) ? xb[p] : 0.f;
  }
  __syncthreads();

  const int nt = min(kFrames, T - t0);
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    float re[kFrames], im[kFrames];
#pragma unroll
    for (int t = 0; t < kFrames; ++t) re[t] = im[t] = 0.f;
    int idx = 0;  // (n * f) mod n_fft
    for (int n = 0; n < n_fft; ++n) {
      const float c = win[n] * cos_t[idx];
      const float s = win[n] * sin_t[idx];
#pragma unroll
      for (int t = 0; t < kFrames; ++t) {
        const float v = seg[t * hop + n];
        re[t] = fmaf(v, c, re[t]);
        im[t] = fmaf(-v, s, im[t]);
      }
      idx += f;
      if (idx >= n_fft) idx -= n_fft;
    }
#pragma unroll
    for (int t = 0; t < kFrames; ++t) {
      if (t < nt) {
        float scale = 1.f;
        if (compress) {  // |X|^0.3 as X * (|X|^2)^-0.35, 0 at empty bins
          const float mag2 = re[t] * re[t] + im[t] * im[t];
          scale = mag2 > 1e-24f ? powf(mag2, -0.35f) : 0.f;
        }
        out[(static_cast<size_t>(b) * T + t0 + t) * F + f] =
            make_float2(re[t] * scale, im[t] * scale);
      }
    }
  }
}

__global__ void istft_kernel(const float2* __restrict__ spec,
                             float* __restrict__ out, int T, int F, int n_fft,
                             int hop, int out_len, int frames_cap,
                             int compress) {
  extern __shared__ float smem[];
  float* cos_t = smem;
  float* sin_t = cos_t + n_fft;
  float* win = sin_t + n_fft;
  float2* coef = reinterpret_cast<float2*>(win + n_fft);        // [frames_cap][F]
  float* frames = reinterpret_cast<float*>(coef + frames_cap * F);  // [frames_cap][n_fft]

  const int b = blockIdx.y;
  const int pad = n_fft / 2;
  const int r = n_fft / hop;
  const int o0 = blockIdx.x * kHopBlocks * hop;  // first output sample
  const int p0 = o0 + pad;                       // same, before the trim
  const int k_first = p0 / hop;
  const int k_last = (p0 + kHopBlocks * hop - 1) / hop;
  const int t_first = max(0, k_first - r + 1);
  const int t_last = min(T - 1, k_last);
  const int nfr = t_last - t_first + 1;  // <= frames_cap

  fill_tables(cos_t, sin_t, win, n_fft);
  // uncompressed one-sided spectrum, DC and Nyquist weighted 1, the rest 2
  const float expo = static_cast<float>((1.0 / 0.3 - 1.0) / 2.0);
  for (int e = threadIdx.x; e < nfr * F; e += blockDim.x) {
    const int i = e / F, f = e - (e / F) * F;
    float2 z = spec[(static_cast<size_t>(b) * T + t_first + i) * F + f];
    if (compress) {
      const float mag2 = z.x * z.x + z.y * z.y;
      const float scale = mag2 > 1e-24f ? powf(mag2, expo) : 0.f;
      z.x *= scale;
      z.y *= scale;
    }
    const float w = (f == 0 || 2 * f == n_fft) ? 1.f : 2.f;
    coef[i * F + f] = make_float2(z.x * w, z.y * w);
  }
  __syncthreads();

  // windowed inverse real DFT of every frame this block needs
  for (int n = threadIdx.x; n < n_fft; n += blockDim.x) {
    float acc[kMaxFrames];
#pragma unroll
    for (int i = 0; i < kMaxFrames; ++i) acc[i] = 0.f;
    int idx = 0;  // (f * n) mod n_fft
    for (int f = 0; f < F; ++f) {
      const float c = cos_t[idx];
      const float s = sin_t[idx];
#pragma unroll
      for (int i = 0; i < kMaxFrames; ++i) {
        if (i < nfr) {
          const float2 z = coef[i * F + f];
          acc[i] = fmaf(z.x, c, fmaf(-z.y, s, acc[i]));
        }
      }
      idx += n;
      if (idx >= n_fft) idx -= n_fft;
    }
    const float scale = win[n] / static_cast<float>(n_fft);
#pragma unroll
    for (int i = 0; i < kMaxFrames; ++i)
      if (i < nfr) frames[i * n_fft + n] = acc[i] * scale;
  }
  __syncthreads();

  // overlap-add as a gather, window-sum-square envelope, trim
  for (int j = threadIdx.x; j < kHopBlocks * hop; j += blockDim.x) {
    const int o = o0 + j;
    if (o >= out_len) break;
    const int p = o + pad;
    const int k = p / hop;       // the last frame that covers p
    const int n0 = p - k * hop;  // p's offset in frame k
    float sig = 0.f, env = 0.f;
    // written as q = 0..r-1 with an explicit range test: nvcc 12.9 for
    // sm_90a miscompiles `for (t = min(T - 1, k); t >= max(0, k - r + 1); --t)`
    // (it ran 21 iterations where 3 were due)
    for (int q = 0; q < r; ++q) {  // frame k - q holds p at n0 + q * hop
      const int t = k - q;
      if (t >= 0 && t < T) {
        const int n = n0 + q * hop;
        sig += frames[(t - t_first) * n_fft + n];
        env += win[n] * win[n];
      }
    }
    out[static_cast<size_t>(b) * out_len + o] = sig / (env > 1e-11f ? env : 1.f);
  }
}

}  // namespace

extern "C" int se_stft(const void* x, void* out, int batch, int L, int T,
                       int n_fft, int hop, int compress, void* stream) {
  const int F = n_fft / 2 + 1;
  const size_t smem =
      sizeof(float) * (3 * n_fft + (kFrames - 1) * hop + n_fft);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(stft_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  const dim3 grid((T + kFrames - 1) / kFrames, batch);
  stft_kernel<<<grid, kStftThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float2*>(out), L, T, F, n_fft,
      hop, compress);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int se_istft(const void* spec, void* out, int batch, int T,
                        int n_fft, int hop, int out_len, int compress,
                        void* stream) {
  const int F = n_fft / 2 + 1;
  const int frames_cap = kHopBlocks + n_fft / hop;
  if (n_fft / hop > kMaxR) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * 3 * n_fft +
                      sizeof(float2) * frames_cap * F +
                      sizeof(float) * frames_cap * n_fft;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(istft_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  const int rounded = ((n_fft + 31) / 32) * 32;
  const int threads = rounded < 512 ? rounded : 512;
  const dim3 grid((out_len + kHopBlocks * hop - 1) / (kHopBlocks * hop), batch);
  istft_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(spec), static_cast<float*>(out), T, F, n_fft,
      hop, out_len, frames_cap, compress);
  return static_cast<int>(cudaGetLastError());
}
