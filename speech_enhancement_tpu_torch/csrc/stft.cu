// Fused STFT -> power-compress (K4) and uncompress -> iSTFT (K5) for Hopper.
//
// Replaces the TPU kernels speech_enhancement_tpu/ops/pallas_stft.py
// (_stft_kernel via pallas_stft, _istft_kernel via pallas_istft).
//
// What bounds them on an H100: an FFT-based STFT of the serving shape
// [32, 32000] needs 0.11 GFLOP and moves 20.6 MB (0.0062 ms at 3.35
// TB/s), so the bytes bound both.  A direct DFT needs 3.3 GFLOP each way,
// which CUDA cores run at ~14 TFLOP/s and tensor cores far faster.
//
// K4 design: the STFT as a GEMM on tensor cores, in 3xTF32, folded by the
// DFT's symmetry.  The periodic window and the twiddles are even about
// n = N/2 (w[N - n] = w[n], cos even, sin odd), so with the frame's even
// and odd parts a[k] = x[k] + x[N - k], b[k] = x[k] - x[N - k] (the partner
// of k = 0 is itself) the N-tap DFT becomes two (N/2 + 1)-tap products:
//   Re X[f] = sum_{k <= N/2} c_k w[k] cos(2 pi k f / N) a[k]
//   Im X[f] = -sum_{k <= N/2} c_k w[k] sin(2 pi k f / N) b[k]
// with c_0 = c_{N/2} = 1/2 (there a = 2 x).  That halves the products and
// the basis bytes of the plain frames x basis GEMM.
// * The basis (cos and sin halves, [k_pad, bins]) is built once per
//   (n_fft, device) by the wrapper in float64, rounded once to fp32, K
//   padded to a multiple of 8 and the bins to whole tiles with zeros, and
//   stored in the order the B fragments read it: per bin tile and k-step
//   of 8, [cos, sin][kBins columns][4 t][2], the pair being rows (t, t + 4),
//   so a lane's two B values are one 8-byte load and a warp's loads are
//   256 contiguous bytes (conflict-free).
// * One block per (tile of kBM = 64 frames, tile of kBins = 104 bins,
//   utterance), 4 warps of 16 frames: 2 x 6 x 32 = 384 blocks at the
//   serving shape, 2 resident per SM (216 registers a thread).  Each warp
//   holds a re and an im n8 tile for each 8 bins, so re and im of one bin
//   sit in one thread and the compression and the complex64 store happen
//   in registers.
// * The block stages its reflect-padded segment, (kBM - 1) hop + n_fft
//   floats, in shared memory (cp.async for the samples that need no
//   reflection, plain loads at the two ends); frames are never
//   materialised: the A fragments add and subtract seg[row hop + k] and
//   seg[row hop + N - k].  At hop 100 the row stride is 4 banks, so lane
//   (g, t) hits bank 4 g + t (and 4 g - t for the partner): conflict-free.
// * The basis streams in chunks of 2 k-steps through a double-buffered
//   cp.async ring; every block reads its bin tile of the basis (173 KB at
//   n_fft 400, 66 MB over the grid) from L2.
// * 3xTF32: each operand is split in registers into hi = tf32(x) and
//   lo = tf32(x - hi) (cvt.rna), and lo*hi + hi*lo + hi*hi of each k-step
//   is summed by mma.sync.m16n8k8 into a fresh fp32 fragment, which an fp32
//   add (round to nearest) takes into the running sum: about fp32
//   accuracy, where one TF32 product (10-bit mantissa) would not hold rtol
//   1e-4.  The tensor core truncates its fp32 sums; accumulated across all
//   k-steps in one fragment, that bias added up and broke the bound at
//   near-empty bins of [32, 32000].
// * Epilogue: |X|^0.3 as X * (|X|^2)^-0.35, 0 where |X|^2 <= 1e-24, and
//   one float2 store per bin and frame.
//
// K5 (the iSTFT) is a direct inverse DFT on CUDA cores:
// * twiddles cos/sin(2*pi*k/n_fft), k < n_fft, are computed once per block
//   in double precision into shared memory, and the angle index
//   (f*n) mod n_fft is advanced incrementally, so every basis value is the
//   correctly rounded float of the exact angle;
// * one block per (utterance, kHopBlocks output hop blocks).  The block
//   inverts the frames that cover its samples into shared memory (the
//   r - 1 frames overlapping the neighbouring block are recomputed there),
//   then every output sample gathers its r frames.  No atomics, so the
//   result is deterministic; the window-sum-square division, the center
//   trim and the cut to `length` happen in the same pass.
//
// Each C entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kWarps = 4;              // K4: warps per block, 16 frames each
constexpr int kStftThreads = 32 * kWarps;
constexpr int kBM = 16 * kWarps;       // K4: frames per block
constexpr int kNT = 13;                // K4: n8 tiles of bins per block, each of re and im
constexpr int kBins = 8 * kNT;         // K4: bins per block
constexpr int kSteps = 2;              // K4: k-steps of 8 basis rows per cp.async chunk
constexpr int kChunk = kSteps * 2 * kBins * 8;  // K4: floats per chunk (cos and sin)
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

// x rounded to TF32 (round to nearest, ties away), as the b32 an mma takes
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// x = hi + lo to about 2^-22 relative, both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c += A B for one m16n8k8 tile: TF32 operands, fp32 accumulator
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// basis: [n_tiles][k_pad / 8][2][kBins][4][2] (see the header); seg_cap:
// the staged segment's floats, (kBM - 1) * hop + n_fft rounded up to 4
__global__ void __launch_bounds__(kStftThreads, 2)
    stft_kernel(const float* __restrict__ x, const float* __restrict__ basis,
                float2* __restrict__ out, int L, int T, int F, int n_fft,
                int hop, int k_pad, int seg_cap, int compress) {
  extern __shared__ __align__(16) float smem[];
  float* seg = smem;
  float* ring = smem + seg_cap;  // 2 stages of kChunk floats

  const int t0 = blockIdx.x * kBM;
  const int nt = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int pad = n_fft / 2;
  const float* xb = x + static_cast<size_t>(b) * L;
  const int ksteps = k_pad / 8;
  const float* wb = basis + static_cast<size_t>(nt) * ksteps * 2 * kBins * 8;

  // the reflect-padded segment: samples inside [0, L) by cp.async, the
  // reflected ends and frames past the end of the signal by plain loads
  for (int k = threadIdx.x; k < seg_cap; k += kStftThreads) {
    const int p0 = t0 * hop + k - pad;  // index into the unpadded signal
    if (p0 >= 0 && p0 < L) {
      cp_async4(smem_addr(seg + k), xb + p0);
    } else {
      int p = p0 < 0 ? -p0 : 2 * (L - 1) - p0;  // reflect (torch 'reflect')
      seg[k] = (p >= 0 && p < L) ? xb[p] : 0.f;
    }
  }
  auto load_chunk = [&](int stage, int chunk) {
    const int steps = min(kSteps, ksteps - chunk * kSteps);
    const float* src = wb + static_cast<size_t>(chunk) * kChunk;
    float* dst = ring + stage * kChunk;
    for (int c = threadIdx.x; c < steps * 2 * kBins * 2; c += kStftThreads)
      cp_async16(smem_addr(dst + 4 * c), src + 4 * c);
    cp_async_commit();  // the first group also holds the segment
  };

  float re[kNT][4], im[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) re[j][e] = im[j][e] = 0.f;

  const int nchunks = (ksteps + kSteps - 1) / kSteps;
  const float* frame0 = seg + (16 * warp + g) * hop;  // frame row g; row g + 8 at + 8 hop
  load_chunk(0, 0);
  for (int chunk = 0; chunk < nchunks; ++chunk) {
    if (chunk + 1 < nchunks) {
      load_chunk((chunk + 1) & 1, chunk + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float2* bs = reinterpret_cast<const float2*>(ring + (chunk & 1) * kChunk);
    const int steps = min(kSteps, ksteps - chunk * kSteps);
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      if (s < steps) {
        // A fragments of the even and odd parts: a = x[k] + x[N - k],
        // b = x[k] - x[N - k] (the partner of k = 0 is itself), at
        // (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
        uint32_t ah[4], al[4], bh[4], bl[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = (chunk * kSteps + s) * 8 + t + (e >> 1) * 4;
          const int row = (e & 1) * 8 * hop;
          const float u = frame0[row + k], w = frame0[row + (k ? n_fft - k : 0)];
          split_tf32(u + w, ah[e], al[e]);
          split_tf32(u - w, bh[e], bl[e]);
        }
        const float2* cs = bs + s * 2 * kBins * 4;  // cos rows of this k-step
        const float2* sn = cs + kBins * 4;          // sin rows
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          // rows t, t + 4 of bin column 8 j + g
          const float2 cv = cs[8 * j * 4 + lane], sv = sn[8 * j * 4 + lane];
          uint32_t ch0, cl0, ch1, cl1, sh0, sl0, sh1, sl1;
          split_tf32(cv.x, ch0, cl0);
          split_tf32(cv.y, ch1, cl1);
          split_tf32(sv.x, sh0, sl0);
          split_tf32(sv.y, sh1, sl1);
          float pr[4] = {0.f, 0.f, 0.f, 0.f}, pi[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(pr, al, ch0, ch1);
          mma_tf32(pr, ah, cl0, cl1);
          mma_tf32(pr, ah, ch0, ch1);
          mma_tf32(pi, bl, sh0, sh1);
          mma_tf32(pi, bh, sl0, sl1);
          mma_tf32(pi, bh, sh0, sh1);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            re[j][e] += pr[e];
            im[j][e] += pi[e];
          }
        }
      }
    }
    __syncthreads();  // this stage is consumed
  }

  // element e of n8 tile j: bin nt * kBins + 8 j + 2 t + (e & 1) at frame
  // row g + 8 (e >> 1); re and im of one bin sit in one thread
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int f = nt * kBins + 8 * j + 2 * t + (e & 1);
      const int frame = t0 + 16 * warp + g + (e >> 1) * 8;
      if (f < F && frame < T) {
        float scale = 1.f;
        if (compress) {  // |X|^0.3 as X * (|X|^2)^-0.35, 0 at empty bins
          const float mag2 = re[j][e] * re[j][e] + im[j][e] * im[j][e];
          scale = mag2 > 1e-24f ? powf(mag2, -0.35f) : 0.f;
        }
        out[(static_cast<size_t>(b) * T + frame) * F + f] =
            make_float2(re[j][e] * scale, im[j][e] * scale);
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

// x: [batch, L] fp32; basis: the wrapper's [n_tiles][k_pad / 8][2][104][4][2]
// fp32 (16-byte aligned), k_pad a multiple of 8 in [n_fft / 2 + 1, n_fft]
// and n_tiles * 104 >= n_fft / 2 + 1; out: [batch, T, n_fft / 2 + 1]
// complex64.
extern "C" int se_stft(const void* x, const void* basis, void* out, int batch,
                       int L, int T, int n_fft, int hop, int k_pad,
                       int n_tiles, int compress, void* stream) {
  const int F = n_fft / 2 + 1;
  if (k_pad % 8 || k_pad < F || k_pad > n_fft || n_tiles * kBins < F)
    return static_cast<int>(cudaErrorInvalidValue);
  const int seg_cap = ((kBM - 1) * hop + n_fft + 3) / 4 * 4;
  const size_t smem = sizeof(float) * (seg_cap + 2 * kChunk);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((T + kBM - 1) / kBM, n_tiles, batch);
  stft_kernel<<<grid, kStftThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(basis),
      static_cast<float2*>(out), L, T, F, n_fft, hop, k_pad, seg_cap, compress);
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
