// Shared constants and launch helpers of the port's filter-stage kernels.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace lt {

// Output tile of every stencil kernel: 32x32 pixels, one 32x8 block.
constexpr int kTileW = 32;
constexpr int kTileH = 32;
// Dynamic shared memory a kernel may take without opting in.
constexpr int kSmemDefault = 48 * 1024;

// Opt a kernel in to `bytes` of dynamic shared memory when it needs more
// than the default.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= (size_t)kSmemDefault) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

inline dim3 tile_grid(int T, int H, int W) {
  return dim3((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, T);
}

}  // namespace lt
