// Axis swap [B, A1, A2, C] -> [B, A2, A1, C] (K6) for Hopper.
//
// Replaces the TPU kernel speech_enhancement_tpu/ops/pallas_relayout.py
// (_swap_kernel via _swap_call, behind swap_seq_axes): the TSCB fold
// between the time conformer ([B*F, T, C]) and the freq conformer
// ([B*T, F, C]).  The channel axis C stays minor, so the swap moves whole
// rows of C elements (128 B in bf16, 256 B in fp32 at C = 64).  Its
// backward is the same kernel with the two axes swapped back.
//
// What bounds it on an H100: a pure copy, so device-memory bandwidth (one
// read and one write of every byte: 2 x 16.65 MB at the training shape
// [8, 101, 161, 64] bf16, 2 x 132.8 MB at the serving shape
// [32, 101, 321, 64] bf16).
//
// Design (rows a multiple of 16 bytes, U = row_bytes / 16 a power of two
// <= 32, both buffers 16-byte aligned):
// * the grid is (tile of A1, tile of A2, b), so every thread finds its
//   rows from blockIdx and threadIdx once, and then only adds strides
//   (the first version divided by a1 and a2 for every 16-byte unit);
// * a block of 256 threads takes a tile of kA1 x kA2 rows (16 x 8 at
//   U = 8, bf16; 16 x 4 at U = 16, fp32): U threads share one row, a warp
//   takes rows at consecutive i1 and one i2, so each warp's loads are
//   whole input rows and its stores one contiguous run of output rows;
// * each thread issues its 4 independent 16-byte loads (4 rows along A2)
//   before any store, so a block keeps 16 KB in flight;
// * loads are ld.global.nc.L1::no_allocate: the input is read once, and
//   the output stays cacheable in L2 for the next layer, which reads it.
// Other row widths or alignments take an element-wise grid-stride copy.
//
// The C entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;  // independent 16-byte loads per thread

__device__ __forceinline__ uint4 load_once(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

template <int U>
struct RowTile {
  static constexpr int kSlots = kThreads / U;  // rows a block holds at once
  static constexpr int kA1 = kSlots < 16 ? kSlots : 16;
  static constexpr int kS2 = kSlots / kA1;  // slots along A2
  static constexpr int kA2 = kS2 * kItems;
};

template <int U>
__global__ void __launch_bounds__(kThreads)
    swap_rows_kernel(const uint4* __restrict__ x, uint4* __restrict__ y,
                     int a1, int a2) {
  using Tile = RowTile<U>;
  const int u = threadIdx.x % U;
  const int slot = threadIdx.x / U;
  const int i1 = blockIdx.x * Tile::kA1 + slot % Tile::kA1;
  const int i2 = blockIdx.y * Tile::kA2 + slot / Tile::kA1;
  if (i1 >= a1) return;
  const long long b = blockIdx.z;
  const uint4* src = x + ((b * a1 + i1) * a2 + i2) * U + u;
  uint4* dst = y + ((b * a2 + i2) * a1 + i1) * U + u;
  const long long src_step = static_cast<long long>(Tile::kS2) * U;
  const long long dst_step = static_cast<long long>(Tile::kS2) * a1 * U;
  uint4 v[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    if (i2 + k * Tile::kS2 < a2) v[k] = load_once(src + k * src_step);
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    if (i2 + k * Tile::kS2 < a2) dst[k * dst_step] = v[k];
}

template <int U>
int launch_rows(const void* x, void* y, int batch, int a1, int a2,
                cudaStream_t stream) {
  using Tile = RowTile<U>;
  const dim3 grid((a1 + Tile::kA1 - 1) / Tile::kA1,
                  (a2 + Tile::kA2 - 1) / Tile::kA2, batch);
  if (grid.y > 65535u || grid.z > 65535u)
    return static_cast<int>(cudaErrorInvalidValue);
  swap_rows_kernel<U><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(y), a1, a2);
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
__global__ void swap_elems_kernel(const E* __restrict__ x, E* __restrict__ y,
                                  unsigned a1, unsigned a2, unsigned units,
                                  unsigned total) {
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned e = blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const unsigned r = e / units;  // output row (b, i2, i1)
    const unsigned c = e - r * units;
    const unsigned i1 = r % a1;
    const unsigned t = r / a1;
    const unsigned i2 = t % a2;
    const unsigned b = t / a2;
    y[e] = x[((b * a1 + i1) * a2 + i2) * units + c];
  }
}

template <typename E>
int launch_elems(const void* x, void* y, unsigned a1, unsigned a2,
                 unsigned units, unsigned total, cudaStream_t stream) {
  unsigned blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132u * 32u) blocks = 132u * 32u;  // 32 blocks per H100 SM
  swap_elems_kernel<E><<<blocks, kThreads, 0, stream>>>(
      static_cast<const E*>(x), static_cast<E*>(y), a1, a2, units, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: contiguous [batch, a1, a2, row_bytes / elem_bytes]; y: contiguous
// [batch, a2, a1, same].  elem_bytes is 2 or 4.  The caller guarantees
// that batch * a1 * a2 * row_bytes / elem_bytes < 2^31.
extern "C" int se_swap_axes(const void* x, void* y, int batch, int a1, int a2,
                            int row_bytes, int elem_bytes, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = row_bytes % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (aligned) {
    switch (row_bytes / 16) {
      case 1: return launch_rows<1>(x, y, batch, a1, a2, st);
      case 2: return launch_rows<2>(x, y, batch, a1, a2, st);
      case 4: return launch_rows<4>(x, y, batch, a1, a2, st);
      case 8: return launch_rows<8>(x, y, batch, a1, a2, st);
      case 16: return launch_rows<16>(x, y, batch, a1, a2, st);
      case 32: return launch_rows<32>(x, y, batch, a1, a2, st);
      default: break;
    }
  }
  const unsigned rows = static_cast<unsigned>(batch) * a1 * a2;
  const unsigned units = row_bytes / elem_bytes;
  if (elem_bytes == 2)
    return launch_elems<uint16_t>(x, y, a1, a2, units, rows * units, st);
  if (elem_bytes == 4)
    return launch_elems<uint32_t>(x, y, a1, a2, units, rows * units, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
