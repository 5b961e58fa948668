// Fused STFT -> power-compress (K4) and uncompress -> iSTFT (K5) for Hopper,
// both as folded 3xTF32 GEMMs on tensor cores.
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
//   serving shape, 2 resident per SM (220 registers a thread).  Each warp
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
//   lo = tf32(x - hi) (round to nearest, ties away: mma.cuh's to_tf32),
//   and lo*hi + hi*lo + hi*hi of each k-step is summed by
//   mma.sync.m16n8k8 into a fresh fp32 fragment, which an fp32
//   add (round to nearest) takes into the running sum: about fp32
//   accuracy, where one TF32 product (10-bit mantissa) would not hold rtol
//   1e-4.  The tensor core truncates its fp32 sums; accumulated across all
//   k-steps in one fragment, that bias added up and broke the bound at
//   near-empty bins of [32, 32000].
// * Epilogue: |X|^0.3 as X * (|X|^2)^-0.35, 0 where |X|^2 <= 1e-24, and
//   one float2 store per bin and frame.
//
// K5 design: uncompression + iSTFT as the same folded GEMM, backwards.
// Frame t's sample n is y[n] = win[n]/N sum_f w_f (R_f cos(2 pi f n / N)
// - I_f sin(2 pi f n / N)), w_f = 1 at DC and Nyquist, else 2.  The window
// and cos are even about N/2 and sin is odd, so for n <= N/2, with
//   C[n] = sum_f R_f Bc[f][n],  S[n] = sum_f I_f Bs[f][n]
// (Bc, Bs = w_f win[n]/N cos, sin), y[n] = C - S and y[N - n] = C + S: two
// [frames, K = bins -> k_pad] x [k_pad, n <= N/2 -> whole tiles of 104]
// products, half those of the plain [frames, 2 F] x [2 F, N] one.
// * The basis is built once per (n_fft, device) by the wrapper in float64,
//   rounded once to fp32 and stored in K4's fragment order (n in the
//   columns), so K4's B-fragment reads carry over: one 8-byte load a lane,
//   256 contiguous bytes a warp.
// * One block per (run of kBM = 16 m_tiles frames, utterance): it finishes
//   the kBM - r + 1 hop blocks all of whose r frames it holds, and
//   recomputes the r - 1 frames it shares with its neighbour.  m_tiles is
//   4 (64 frames, 61 hop blocks at r = 4: 6 x 32 = 192 blocks at [32, 321])
//   unless the shared memory of a large n_fft asks for fewer.
// * 2 m_tiles warps: warp w takes frame tile w % m_tiles and, of each pair
//   of n chunks (104 n each), chunk w / m_tiles, so one warp holds C and S
//   of 16 frames x 104 n (104 accumulators a thread, 238 registers) and
//   n_fft 400 (201 n, 2 chunks) is one pass.  At one block per SM (190 KB
//   of shared memory at n_fft 400) that keeps 8 warps resident; 192 blocks
//   make 1.45 waves on 132 SMs, and 48-frame blocks (256, two even waves)
//   were no faster on an H100 (probes/kernel_variants.py, variant k5_48).
//   The 64 windowed frames themselves (102 KB at n_fft 400) are never
//   staged: see the overlap-add below.
// * The spectrum of the block's frames is staged once, uncompressed as it
//   is staged (|z|^(1/0.3 - 1) where |z|^2 > 1e-24, else 0), zero past the
//   bins and for frames outside [0, T), as float2 rows (re, im) of pitch
//   P = k_pad + 4 float2: the 8-byte A-fragment load of lane (g, t), row g
//   column t, is word g P + t, and with P = 4 or 12 mod 16 the 16 lanes of
//   each half warp take 16 distinct bank pairs.  The basis streams through
//   a double-buffered cp.async ring, 2 k-steps of both chunks of a pair at
//   a time.
// * 3xTF32 as K4 (a fresh fragment per k-step): one TF32 product misses
//   rtol 1e-4 / atol 1e-4 (tests/test_torch_istft_tf32.py shows it).
// * Overlap-add, deterministic without atomics: C - S and C + S go from
//   the accumulator fragments into a shared-memory signal of the block's
//   frames in r passes; pass q adds the frames i = q mod r, which are n_fft
//   apart and never write one address twice.  Then every output sample of
//   the block's hop blocks divides by the window-sum-square envelope
//   (where > 1e-11) of the frames that exist, after the center trim and the
//   cut to `length`.
//
// Each C entry point returns cudaGetLastError() (or the error of an
// attribute call) after its launch or query.

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
constexpr int kMaxR = 8;         // K5: largest n_fft / hop supported
constexpr int kMaxTiles = 4;     // K5: m16 tiles of frames per block, at most
constexpr int kIThreads = 2 * 32 * kMaxTiles;  // K5: two warp groups
constexpr int kPiece = 2 * kBins * 8;  // K5: basis floats of one (n chunk, k-step)
constexpr int kIChunk = kSteps * 2 * kPiece;  // K5: floats per stage, both chunks
constexpr int kMaxSmem = 232448;  // shared memory a block may use on an H100

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
          mma_3xtf32(re[j], ah, al, ch0, ch1, cl0, cl1);
          mma_3xtf32(im[j], bh, bl, sh0, sh1, sl0, sl1);
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

// basis: [n_chunks][k_pad / 8][2][kBins][4][2] (K4's fragment order, n in
// the columns); the block's shared memory, in floats: the ring (2 kIChunk),
// the staged spectrum (kbm rows of k_pad + 4 float2), the overlap-add
// signal ((kbm - 1) hop + n_fft) and the squared window (n_fft)
__global__ void __launch_bounds__(kIThreads, 1)
    istft_kernel(const float2* __restrict__ spec, const float* __restrict__ basis,
                 float* __restrict__ out, int T, int F, int n_fft, int hop,
                 int out_len, int k_pad, int n_chunks, int m_tiles, int hops,
                 int compress) {
  extern __shared__ __align__(16) float smem[];
  const int kbm = 16 * m_tiles;  // frames per block
  const int pitch = k_pad + 4;   // float2 per staged spectrum row
  float* ring = smem;
  float2* sp = reinterpret_cast<float2*>(smem + 2 * kIChunk);
  float* ola = reinterpret_cast<float*>(sp + kbm * pitch);
  float* wsq = ola + (kbm - 1) * hop + n_fft;

  const int threads = 64 * m_tiles;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int grp = warp / m_tiles, mt = warp - grp * m_tiles;
  const int b = blockIdx.y;
  const int r = n_fft / hop, half = n_fft / 2;
  const int kb0 = half / hop + blockIdx.x * hops;  // first hop block, padded coordinates
  const int t0 = kb0 - r + 1;                       // the frame of staged row 0
  const int ksteps = k_pad / 8;
  const int kchunks = (ksteps + kSteps - 1) / kSteps;
  const int nstages = (n_chunks + 1) / 2 * kchunks;

  // stage c = (pair of n chunks, k-chunk): [k-step][chunk of the pair][kPiece]
  auto load_stage = [&](int c) {
    const int pair = c / kchunks, kc = c - pair * kchunks;
    const int steps = min(kSteps, ksteps - kc * kSteps);
    const int chunks = min(2, n_chunks - 2 * pair);
    float* dst = ring + (c & 1) * kIChunk;
    for (int v = threadIdx.x; v < steps * chunks * (kPiece / 4); v += threads) {
      const int piece = v / (kPiece / 4), w = 4 * (v - piece * (kPiece / 4));
      const int s = piece / chunks, h = piece - s * chunks;
      const float* src =
          basis + (static_cast<size_t>(2 * pair + h) * ksteps + kc * kSteps + s) * kPiece;
      cp_async16(smem_addr(dst + (2 * s + h) * kPiece + w), src + w);
    }
    cp_async_commit();
  };
  load_stage(0);

  // the block's frames, uncompressed once as they are staged
  const float expo = static_cast<float>((1.0 / 0.3 - 1.0) / 2.0);
  for (int i = warp; i < kbm; i += 2 * m_tiles) {
    const int fr = t0 + i;
    const bool live = fr >= 0 && fr < T;
    const float2* row = spec + (static_cast<size_t>(b) * T + (live ? fr : 0)) * F;
    for (int f = lane; f < k_pad; f += 32) {
      float2 z = make_float2(0.f, 0.f);
      if (live && f < F) {
        z = row[f];
        if (compress) {
          const float mag2 = z.x * z.x + z.y * z.y;
          const float scale = mag2 > 1e-24f ? powf(mag2, expo) : 0.f;
          z.x *= scale;
          z.y *= scale;
        }
      }
      sp[i * pitch + f] = z;
    }
  }
  for (int n = threadIdx.x; n < n_fft; n += threads) {
    const float w = static_cast<float>(0.54 - 0.46 * cospi(2.0 * n / n_fft));
    wsq[n] = w * w;
  }
  for (int p = threadIdx.x; p < (kbm - 1) * hop + n_fft; p += threads) ola[p] = 0.f;

  // this lane's two frame rows, and the pass of the overlap-add each adds in
  const int i0 = 16 * mt + g, i1 = i0 + 8;
  const int q0 = i0 % r, q1 = i1 % r;
  const float2* arow = sp + i0 * pitch;  // row i1 at + 8 pitch
  int c = 0;
  for (int chunk0 = 0; chunk0 < n_chunks; chunk0 += 2) {
    const int chunk = chunk0 + grp;
    const bool active = chunk < n_chunks;
    float cacc[kNT][4], sacc[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) cacc[j][e] = sacc[j][e] = 0.f;

    for (int kc = 0; kc < kchunks; ++kc, ++c) {
      if (c + 1 < nstages) {
        load_stage(c + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // the stage, and at c = 0 the staged spectrum
      if (active) {
        const float2* bs = reinterpret_cast<const float2*>(ring + (c & 1) * kIChunk);
        const int steps = min(kSteps, ksteps - kc * kSteps);
#pragma unroll
        for (int s = 0; s < kSteps; ++s) {
          if (s < steps) {
            // A fragments of R and I at (g, k), (g + 8, k), (g, k + 4),
            // (g + 8, k + 4)
            const int k = (kc * kSteps + s) * 8 + t;
            const float2 z[4] = {arow[k], arow[8 * pitch + k], arow[k + 4],
                                 arow[8 * pitch + k + 4]};
            uint32_t ah[4], al[4], bh[4], bl[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              split_tf32(z[e].x, ah[e], al[e]);
              split_tf32(z[e].y, bh[e], bl[e]);
            }
            const float2* cs = bs + (2 * s + grp) * (kPiece / 2);  // Bc rows of this k-step
            const float2* sn = cs + kBins * 4;                      // Bs rows
#pragma unroll
            for (int j = 0; j < kNT; ++j) {
              // rows t, t + 4 of n column 8 j + g
              const float2 cv = cs[8 * j * 4 + lane], sv = sn[8 * j * 4 + lane];
              uint32_t ch0, cl0, ch1, cl1, sh0, sl0, sh1, sl1;
              split_tf32(cv.x, ch0, cl0);
              split_tf32(cv.y, ch1, cl1);
              split_tf32(sv.x, sh0, sl0);
              split_tf32(sv.y, sh1, sl1);
              mma_3xtf32(cacc[j], ah, al, ch0, ch1, cl0, cl1);
              mma_3xtf32(sacc[j], bh, bl, sh0, sh1, sl0, sl1);
            }
          }
        }
      }
      __syncthreads();  // this stage is consumed
    }

    // overlap-add: element e of n8 tile j is n = 104 chunk + 8 j + 2 t +
    // (e & 1) of frame row i0 (e < 2) or i1; pass q adds the rows = q mod r
    for (int q = 0; q < r; ++q) {
      if (active && (q0 == q || q1 == q)) {
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if ((e < 2 ? q0 : q1) == q) {
              const int n = chunk * kBins + 8 * j + 2 * t + (e & 1);
              float* frame = ola + (e < 2 ? i0 : i1) * hop;
              if (n <= half) frame[n] += cacc[j][e] - sacc[j][e];
              if (n > 0 && n < half) frame[n_fft - n] += cacc[j][e] + sacc[j][e];
            }
          }
        }
      }
      __syncthreads();
    }
  }

  // the block's hop blocks [kb0, kb0 + hops): padded position p is output
  // sample p - half, at ola[p - t0 hop]; the envelope sums the squared
  // window over the frames k - q (k = p / hop) that exist.  Written as q =
  // 0..r-1 with a range test: nvcc 12.9 for sm_90a miscompiled a descending
  // loop bounded by min/max here.
  for (int j = threadIdx.x; j < hops * hop; j += threads) {
    const int p = kb0 * hop + j, o = p - half;
    if (o < 0) continue;
    if (o >= out_len) break;
    const int k = p / hop, n0 = p - k * hop;
    float env = 0.f;
    for (int q = 0; q < r; ++q)
      if (k - q >= 0 && k - q < T) env += wsq[n0 + q * hop];
    out[static_cast<size_t>(b) * out_len + o] =
        ola[j + (r - 1) * hop] / (env > 1e-11f ? env : 1.f);
  }
}

// Shared memory of a K5 block of m_tiles frame tiles, in bytes.
size_t istft_smem(int m_tiles, int k_pad, int hop, int n_fft) {
  const int kbm = 16 * m_tiles;
  return sizeof(float) * (2 * kIChunk + 2 * kbm * (k_pad + 4) + (kbm - 1) * hop + 2 * n_fft);
}

// The K5 block of a geometry: the most frame tiles whose shared memory fits
// (into *m_tiles, with its bytes into *smem), and the kernel's dynamic
// shared-memory limit raised to it.  cudaErrorInvalidValue if no block fits.
cudaError_t istft_block(int n_fft, int hop, int k_pad, int* m_tiles, size_t* smem) {
  int m = kMaxTiles;
  while (m > 0 && istft_smem(m, k_pad, hop, n_fft) > kMaxSmem) --m;
  if (m == 0) return cudaErrorInvalidValue;
  *m_tiles = m;
  *smem = istft_smem(m, k_pad, hop, n_fft);
  if (*smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(istft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
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

// spec: [batch, T, n_fft / 2 + 1] complex64; basis: the wrapper's
// [n_chunks][k_pad / 8][2][104][4][2] fp32 (16-byte aligned), k_pad a
// multiple of 8 >= n_fft / 2 + 1 and n_chunks * 104 >= n_fft / 2 + 1; out:
// [batch, out_len] fp32, out_len <= hop * (T - 1).  n_fft even, a multiple
// of hop, n_fft / hop <= 8; anything else, or a geometry whose block does
// not fit in shared memory, returns cudaErrorInvalidValue before launch.
extern "C" int se_istft(const void* spec, const void* basis, void* out, int batch,
                        int T, int n_fft, int hop, int out_len, int k_pad,
                        int n_chunks, int compress, void* stream) {
  const int F = n_fft / 2 + 1;
  if (n_fft % 2 || hop <= 0 || n_fft % hop || n_fft / hop > kMaxR || k_pad % 8 ||
      k_pad < F || n_chunks * kBins < F || out_len < 1 || out_len > hop * (T - 1))
    return static_cast<int>(cudaErrorInvalidValue);
  int m_tiles;
  size_t smem;
  const cudaError_t err = istft_block(n_fft, hop, k_pad, &m_tiles, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int hops = 16 * m_tiles - n_fft / hop + 1;  // hop blocks a block finishes
  const int first = (n_fft / 2) / hop, last = (n_fft / 2 + out_len - 1) / hop;
  const dim3 grid((last - first + hops) / hops, batch);
  istft_kernel<<<grid, 64 * m_tiles, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(spec), static_cast<const float*>(basis),
      static_cast<float*>(out), T, F, n_fft, hop, out_len, k_pad, n_chunks, m_tiles,
      hops, compress);
  return static_cast<int>(cudaGetLastError());
}

// The block K5 launches for a geometry: its frame tiles (16 frames each),
// shared memory in bytes, and resident blocks per SM, into the pointers.
extern "C" int se_istft_occupancy(int n_fft, int hop, int k_pad, int* m_tiles,
                                  int* smem_bytes, int* blocks) {
  size_t smem;
  cudaError_t err = istft_block(n_fft, hop, k_pad, m_tiles, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem_bytes = static_cast<int>(smem);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, istft_kernel, 64 * *m_tiles, smem);
  return static_cast<int>(err);
}
