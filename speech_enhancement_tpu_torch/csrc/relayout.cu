// Axis swap [B, A1, A2, C] -> [B, A2, A1, C] (K6) for Hopper.
//
// Replaces the TPU kernel speech_enhancement_tpu/ops/pallas_relayout.py
// (_swap_kernel via _swap_call, behind swap_seq_axes): the TSCB fold
// between the time conformer ([B*F, T, C]) and the freq conformer
// ([B*T, F, C]).  The channel axis C stays minor, so the swap moves whole
// rows of C elements (128 B in bf16, 256 B in fp32 at C = 64).  Its
// backward is the same kernel with the two axes swapped back.
//
// What bounds it on an H100: a pure copy, so device-memory bandwidth
// (one read and one write of every byte).  Each thread moves one 16-byte
// unit of an output row when the row is a multiple of 16 bytes and both
// buffers are 16-byte aligned (else one element): consecutive threads
// write consecutive units of consecutive output rows and read whole
// input rows, so every warp's loads and stores are full 32-byte sectors.
// Ragged A1 and A2 need no masking: each output unit computes its own
// source, and the grid-stride loop stops at the exact element count (the
// TPU kernel relied on out-of-bounds block masking instead).
//
// The C entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename U>
__global__ void swap_axes_kernel(const U* __restrict__ x, U* __restrict__ y,
                                 unsigned a1, unsigned a2, unsigned units,
                                 unsigned total) {
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned u = blockIdx.x * blockDim.x + threadIdx.x; u < total;
       u += stride) {
    const unsigned r = u / units;  // output row (b, i2, i1)
    const unsigned c = u - r * units;
    const unsigned i1 = r % a1;
    const unsigned t = r / a1;
    const unsigned i2 = t % a2;
    const unsigned b = t / a2;
    y[u] = x[((b * a1 + i1) * a2 + i2) * units + c];
  }
}

template <typename U>
int launch(const void* x, void* y, unsigned a1, unsigned a2, unsigned units,
           unsigned total, cudaStream_t stream) {
  constexpr unsigned kThreads = 256;
  unsigned blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132u * 32u) blocks = 132u * 32u;  // 32 blocks per H100 SM
  swap_axes_kernel<U><<<blocks, kThreads, 0, stream>>>(
      static_cast<const U*>(x), static_cast<U*>(y), a1, a2, units, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: contiguous [batch, a1, a2, row_bytes / elem_bytes]; y: contiguous
// [batch, a2, a1, same].  elem_bytes is 2 or 4.  The caller guarantees
// that batch * a1 * a2 * row_bytes / elem_bytes < 2^31.
extern "C" int se_swap_axes(const void* x, void* y, int batch, int a1, int a2,
                            int row_bytes, int elem_bytes, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned rows = static_cast<unsigned>(batch) * a1 * a2;
  const bool vec = row_bytes % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (vec) {
    const unsigned units = row_bytes / 16;
    return launch<uint4>(x, y, a1, a2, units, rows * units, st);
  }
  const unsigned units = row_bytes / elem_bytes;
  if (elem_bytes == 2)
    return launch<uint16_t>(x, y, a1, a2, units, rows * units, st);
  if (elem_bytes == 4)
    return launch<uint32_t>(x, y, a1, a2, units, rows * units, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
