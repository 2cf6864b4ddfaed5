// Shared constants, device functions and launch helpers of the port's
// filter-stage kernels (filter_stage.cu, tophat_staged.cu, dual_tophat.cu,
// adaptive_mean.cu, channel_stage.cu).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace lt {

// Output tile of every stencil kernel: 32x32 pixels, one 32x8 block.
constexpr int kTileW = 32;
constexpr int kTileH = 32;
// Dynamic shared memory a kernel may take without opting in.
constexpr int kSmemDefault = 48 * 1024;
// Rows of a structuring element (one horizontal run each) a kernel takes.
constexpr int kMaxRuns = 64;

// One horizontal run [lo, hi] per SE row dy, passed by value.
struct SeRuns {
  int n;
  int max_run;
  int dy[kMaxRuns];
  int lo[kMaxRuns];
  int hi[kMaxRuns];
};

// Opt a kernel in to `bytes` of dynamic shared memory when it needs more
// than the default.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= (size_t)kSmemDefault) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// cudaGetLastError() after a launch, counting the launch in
// lt_filter_stage_launches if it was taken (filter_stage.cu; the launchers
// of filter_stage.cu, tophat_staged.cu, dual_tophat.cu, adaptive_mean.cu
// and the shift chains call it).
cudaError_t filter_stage_launched();

// Whether a kernel may move whole groups of n bytes (16: a u8 quad): W a
// multiple of n and both images n-byte aligned.
inline bool aligned(const void* a, const void* b, int W, int n = 16) {
  const uintptr_t bits =
      reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b);
  return W % n == 0 && bits % n == 0;
}

inline dim3 tile_grid(int T, int H, int W) {
  return dim3((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, T);
}

// SE runs from a host table of n rows of int32 (dy, lo, hi); -1 if the
// table is empty, too long or holds an empty run.
inline int load_runs(const int* table, int n, SeRuns* runs) {
  if (n < 1 || n > kMaxRuns) return -1;
  runs->n = n;
  runs->max_run = 1;
  for (int q = 0; q < n; ++q) {
    runs->dy[q] = table[3 * q];
    runs->lo[q] = table[3 * q + 1];
    runs->hi[q] = table[3 * q + 2];
    const int len = runs->hi[q] - runs->lo[q] + 1;
    if (len < 1) return -1;
    if (len > runs->max_run) runs->max_run = len;
  }
  return 0;
}

// Min (erode, kMax = false) or max (dilate, kMax = true) of two pixels.
template <bool kMax>
__device__ __forceinline__ uint8_t op(uint8_t a, uint8_t b) {
  return kMax ? (a > b ? a : b) : (a < b ? a : b);
}

// The bilateral cross threshold's test (mode 'floor') at one pixel of
// value x, from int32 exclusive prefix sums that read 0 outside the image:
// h[m] is the sum of the row's pixels left of column c - k + m (c the
// pixel's column), so h[k + 1] - h[k] is the pixel; v[m * vstride] the
// same down the pixel's column.  Hit iff both k-pixel horizontal arms sum
// to less than k*x - C*k, or both vertical ones do.
__device__ __forceinline__ bool cross_hit(const int* h, const int* v,
                                          int vstride, int k, int x, int C) {
  const int left = h[k] - h[0];
  const int right = h[2 * k + 1] - h[k + 1];
  const int up = v[k * vstride] - v[0];
  const int down = v[(2 * k + 1) * vstride] - v[(k + 1) * vstride];
  const int t = k * x - C * k;
  return (left < t && right < t) || (up < t && down < t);
}

}  // namespace lt
