// Residual add and LayerNorm over rows of C channels, for Hopper: the
// conformers' norm path in the inference forward
// (speech_enhancement_tpu_torch/models/conformer.py, ConformerBlock).
//
//   r = x + s * y          (y optional; s is 0.5 after a feed-forward, else 1)
//   n = LayerNorm(r; w, b, eps) [+ skip]
//
// r is written only where the next sub-module's residual needs it; n is
// always written.  fp32, or bf16 with fp32 statistics: r is rounded to the
// storage type before its statistics are taken, and n before skip is
// added, as aten's add, LayerNorm and add round them.
//
// Replaces no TPU kernel: XLA fuses these adds and LayerNorms on the TPU.
// On the card it replaces aten's LayerNorm (vectorized_layer_norm_kernel)
// and the elementwise mul and add kernels around it: 12 kernels and 29
// row-passes a conformer block become 5 launches and 18 row-passes.
//
// What bounds it on an H100: device-memory bandwidth.  Each call reads x,
// y and skip once and writes r and n once, 256 B a row and tensor at C = 64
// fp32 (weights left out): a call that reads x and y and writes r and n at
// the 8 s serving bucket (32 x 101 x 1281 rows) moves 4.24 GB, 1.27 ms at
// 3.35 TB/s.  aten's LayerNorm gives every row of 64 floats a block of its
// own, so block scheduling and in-block reductions set its pace, not the
// bytes.
//
// Design at C = 64 (16-byte aligned rows):
// * a row is 16 lanes with one 16-byte load each (8 bytes in bf16), two
//   rows a warp; mean and variance are two passes over the registers, each
//   four __shfl_xor_sync steps inside the half-warp; weight and bias stay
//   in registers;
// * a block of 256 threads walks over tiles of 64 rows in a grid-stride
//   loop, with as many blocks as are resident on the card (at least two an
//   SM: the bound keeps ptxas from spilling); each thread issues the loads
//   of its 4 rows of a tile before any reduction;
// * y laid out channels-major ([B, C, N], the conv module's output seen
//   through a transpose) is staged a tile at a time in shared memory:
//   each warp reads 32 consecutive rows of one channel (coalesced along N)
//   and stores float4s at a pitch of 68 floats (16-byte aligned, no bank
//   conflicts), and each row is then read from the tile.
// Other C, or unaligned rows, take a warp-per-row kernel that reads its
// row from global memory in three passes (sum, squared deviations,
// output).
//
// The C entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kC = 64;                         // the fast path's channels
constexpr int kLanes = kC / 4;                 // lanes a row, 4 channels each
constexpr int kSlots = kThreads / kLanes;      // rows a block holds at once
constexpr int kTileRows = 64;                  // rows a block takes a step
constexpr int kPerSlot = kTileRows / kSlots;   // rows a thread takes a step
constexpr int kPitch = kC + 4;                 // floats a staged row
constexpr int kStagers = kThreads / kTileRows; // threads staging one row

enum Mode { kNoY = 0, kRowsY = 1, kColsY = 2 };

struct Vec4 {
  float v[4];
};

// Element access by storage type: float, or bf16 kept as its 16 bits
// (round to nearest even on the way in, exact on the way out).
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kAlign = 16;
  __device__ __forceinline__ static float get(const float* p, long long i) { return p[i]; }
  __device__ __forceinline__ static float round(float v) { return v; }
  __device__ __forceinline__ static void put(float* p, long long i, float v) { p[i] = v; }
  __device__ __forceinline__ static Vec4 load4(const float* p) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    return {{q.x, q.y, q.z, q.w}};
  }
  __device__ __forceinline__ static void store4(float* p, const Vec4& a) {
    *reinterpret_cast<float4*>(p) = make_float4(a.v[0], a.v[1], a.v[2], a.v[3]);
  }
};

template <>
struct Elem<uint16_t> {
  static constexpr int kAlign = 8;
  __device__ __forceinline__ static float widen(uint32_t bits) { return __uint_as_float(bits << 16); }
  __device__ __forceinline__ static uint32_t bits(float v) {
    return __bfloat16_as_ushort(__float2bfloat16(v));
  }
  __device__ __forceinline__ static float get(const uint16_t* p, long long i) { return widen(p[i]); }
  __device__ __forceinline__ static float round(float v) { return widen(bits(v)); }
  __device__ __forceinline__ static void put(uint16_t* p, long long i, float v) {
    p[i] = static_cast<uint16_t>(bits(v));
  }
  __device__ __forceinline__ static Vec4 load4(const uint16_t* p) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    return {{widen(q.x & 0xffffu), widen(q.x >> 16), widen(q.y & 0xffffu),
             widen(q.y >> 16)}};
  }
  __device__ __forceinline__ static void store4(uint16_t* p, const Vec4& a) {
    uint2 q;
    q.x = bits(a.v[0]) | (bits(a.v[1]) << 16);
    q.y = bits(a.v[2]) | (bits(a.v[3]) << 16);
    *reinterpret_cast<uint2*>(p) = q;
  }
};

// the sum over the 16 lanes of a half-warp (mask: that half's lanes)
__device__ __forceinline__ float half_warp_sum(float v, unsigned mask) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off /= 2) v += __shfl_xor_sync(mask, v, off);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads, 2)
    add_layer_norm_c64_kernel(const T* __restrict__ x, const T* __restrict__ y,
                              const T* __restrict__ skip, const T* __restrict__ w,
                              const T* __restrict__ b, T* __restrict__ r,
                              T* __restrict__ n, long long rows, int seq, float s,
                              float eps) {
  using E = Elem<T>;
  __shared__ __align__(16) float tile[kMode == kColsY ? kTileRows * kPitch : 4];
  const int lane = threadIdx.x % kLanes;
  const int slot = threadIdx.x / kLanes;
  const unsigned mask = 0xffffu << (16 * (slot % 2));
  const int c0 = 4 * lane;
  const Vec4 wv = E::load4(w + c0);
  const Vec4 bv = E::load4(b + c0);
  const long long step = static_cast<long long>(gridDim.x) * kTileRows;
  for (long long base = static_cast<long long>(blockIdx.x) * kTileRows; base < rows;
       base += step) {
    Vec4 xv[kPerSlot], yv[kPerSlot], sv[kPerSlot];
#pragma unroll
    for (int i = 0; i < kPerSlot; ++i) {
      const long long row = base + slot + i * kSlots;
      if (row < rows) {
        xv[i] = E::load4(x + row * kC + c0);
        if (kMode == kRowsY) yv[i] = E::load4(y + row * kC + c0);
        if (skip != nullptr) sv[i] = E::load4(skip + row * kC + c0);
      }
    }
    if (kMode == kColsY) {
      // y[bi, c, ni] for the tile's rows, row = bi * seq + ni: thread t
      // stages row t % 64, channel quads t / 64 + 4k
      const int trow = threadIdx.x % kTileRows;
      const int q0 = threadIdx.x / kTileRows;
      const long long row = base + trow;
      float staged[kC / kStagers];
      if (row < rows) {
        const long long bi = row / seq;
        const T* src = y + bi * kC * seq + (row - bi * seq);
#pragma unroll
        for (int k = 0; k < kC / 4 / kStagers; ++k)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            staged[4 * k + j] =
                E::get(src, static_cast<long long>(4 * (q0 + kStagers * k) + j) * seq);
      }
      __syncthreads();  // every row of the last tile has been read
      if (row < rows) {
#pragma unroll
        for (int k = 0; k < kC / 4 / kStagers; ++k)
          *reinterpret_cast<float4*>(&tile[trow * kPitch + 4 * (q0 + kStagers * k)]) =
              make_float4(staged[4 * k], staged[4 * k + 1], staged[4 * k + 2],
                          staged[4 * k + 3]);
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kPerSlot; ++i) {
        const float4 q =
            *reinterpret_cast<const float4*>(&tile[(slot + i * kSlots) * kPitch + c0]);
        yv[i] = {{q.x, q.y, q.z, q.w}};
      }
    }
#pragma unroll
    for (int i = 0; i < kPerSlot; ++i) {
      const long long row = base + slot + i * kSlots;
      if (row >= rows) continue;  // the same for the whole half-warp
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = kMode == kNoY ? xv[i].v[j] : E::round(fmaf(s, yv[i].v[j], xv[i].v[j]));
      const float mean = half_warp_sum(v[0] + v[1] + v[2] + v[3], mask) * (1.0f / kC);
      float d[4], sq = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        d[j] = v[j] - mean;
        sq = fmaf(d[j], d[j], sq);
      }
      const float rstd = rsqrtf(half_warp_sum(sq, mask) * (1.0f / kC) + eps);
      if (r != nullptr) E::store4(r + row * kC + c0, {{v[0], v[1], v[2], v[3]}});
      Vec4 o;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o.v[j] = E::round(fmaf(d[j] * rstd, wv.v[j], bv.v[j]));
        if (skip != nullptr) o.v[j] += sv[i].v[j];
      }
      E::store4(n + row * kC + c0, o);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    add_layer_norm_any_kernel(const T* __restrict__ x, const T* __restrict__ y,
                              const T* __restrict__ skip, const T* __restrict__ w,
                              const T* __restrict__ b, T* __restrict__ r,
                              T* __restrict__ n, long long rows, int channels, int seq,
                              int mode, float s, float eps) {
  using E = Elem<T>;
  const int lane = threadIdx.x % 32;
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  for (long long row = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32;
       row < rows; row += warps) {
    const long long xo = row * channels;
    long long yo = xo, ys = 1;
    if (mode == kColsY) {
      const long long bi = row / seq;
      yo = bi * channels * seq + (row - bi * seq);
      ys = seq;
    }
    // r's value at channel c, rounded to the storage type
    auto sum_at = [&](int c) {
      const float xc = E::get(x, xo + c);
      return mode == kNoY ? xc : E::round(fmaf(s, E::get(y, yo + c * ys), xc));
    };
    float acc = 0.0f;
    for (int c = lane; c < channels; c += 32) acc += sum_at(c);
    const float mean = warp_sum(acc) / channels;
    acc = 0.0f;
    for (int c = lane; c < channels; c += 32) {
      const float d = sum_at(c) - mean;
      acc = fmaf(d, d, acc);
    }
    const float rstd = rsqrtf(warp_sum(acc) / channels + eps);
    for (int c = lane; c < channels; c += 32) {
      const float v = sum_at(c);
      if (r != nullptr) E::put(r, xo + c, v);
      float o = E::round(fmaf((v - mean) * rstd, E::get(w, c), E::get(b, c)));
      if (skip != nullptr) o += E::get(skip, xo + c);
      E::put(n, xo + c, o);
    }
  }
}

// blocks of `kernel` resident on the whole card (the first card a process
// launches on sets it: one card type per process)
template <typename K>
int resident_blocks(K kernel) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return sms * (per_sm > 0 ? per_sm : 1);
}

long long blocks_for(long long items, int per_block, int resident) {
  const long long need = (items + per_block - 1) / per_block;
  return need < resident ? need : resident;
}

template <typename T, int kMode>
int launch_c64(const void* x, const void* y, const void* skip, const void* w,
               const void* b, void* r, void* n, long long rows, int seq, float s,
               float eps, cudaStream_t stream) {
  static const int resident = resident_blocks(add_layer_norm_c64_kernel<T, kMode>);
  const long long blocks = blocks_for(rows, kTileRows, resident);
  add_layer_norm_c64_kernel<T, kMode><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const T*>(skip),
      static_cast<const T*>(w), static_cast<const T*>(b), static_cast<T*>(r),
      static_cast<T*>(n), rows, seq, s, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* y, const void* skip, const void* w, const void* b,
           void* r, void* n, long long rows, int channels, int seq, int mode, float s,
           float eps, cudaStream_t stream) {
  const uintptr_t a = Elem<T>::kAlign - 1;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(skip) |
        reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(b) |
        reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(n) |
        (mode == kRowsY ? reinterpret_cast<uintptr_t>(y) : 0)) & a) == 0;
  if (channels == kC && aligned) {
    switch (mode) {
      case kNoY: return launch_c64<T, kNoY>(x, y, skip, w, b, r, n, rows, seq, s, eps, stream);
      case kRowsY: return launch_c64<T, kRowsY>(x, y, skip, w, b, r, n, rows, seq, s, eps, stream);
      case kColsY: return launch_c64<T, kColsY>(x, y, skip, w, b, r, n, rows, seq, s, eps, stream);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  static const int resident = resident_blocks(add_layer_norm_any_kernel<T>);
  const long long blocks = blocks_for(rows, kThreads / 32, resident);
  add_layer_norm_any_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const T*>(skip),
      static_cast<const T*>(w), static_cast<const T*>(b), static_cast<T*>(r),
      static_cast<T*>(n), rows, channels, seq, mode, s, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, skip, r, n: contiguous [rows, channels]; w, b: [channels]; y by mode:
// 0 none (r is then not written: pass null), 1 contiguous [rows, channels],
// 2 contiguous [rows / seq, channels, seq] (channels-major).  skip and r
// may be null.  elem_bytes 4 is fp32, 2 bf16.  rows > 0.
extern "C" int se_add_layer_norm(const void* x, const void* y, const void* skip,
                                 const void* w, const void* b, void* r, void* n,
                                 long long rows, int channels, int seq, int mode,
                                 int elem_bytes, float s, float eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || channels <= 0 || mode < kNoY || mode > kColsY ||
      (mode == kColsY && (seq <= 0 || rows % seq != 0)) || (mode == kNoY && r != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (elem_bytes == 4)
    return launch<float>(x, y, skip, w, b, r, n, rows, channels, seq, mode, s, eps, st);
  if (elem_bytes == 2)
    return launch<uint16_t>(x, y, skip, w, b, r, n, rows, channels, seq, mode, s, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
