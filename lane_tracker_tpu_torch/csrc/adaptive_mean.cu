// Hand-written Hopper (sm_90a) kernel for the second attempt's adaptive
// mean threshold.
//
// Replaces the Pallas TPU kernel adaptive_mean_pallas2 (kernel
// _adaptive_mean_kernel) in lane_tracker_tpu/kernels/filter_stage2.py:
// cv2.adaptiveThreshold(img, 255, ADAPTIVE_THRESH_MEAN_C, THRESH_BINARY, k,
// C) with OpenCV's replicate border and an odd k.  The output is 255 iff
// x - round_half_even(box mean) > -idelta, idelta = C.  Because k is odd
// the window area A = k*k is odd, the mean is never a tie, and the compare
// needs no division:
//     mean < x + idelta  <=>  2 * boxsum + A < 2 * A * (x + idelta).
// Sums are at most 35^2 * 255 = 312,375 on the path, so int32 holds them.
// Bit-exact with the plain twin ops/threshold.adaptive_mean_threshold,
// which rounds the mean in integer math instead.
//
// Plain C interface, loaded with ctypes (as filter_stage.cu): launches on
// the stream it is given, allocates nothing, returns cudaGetLastError().
//
// What bounds it on the H100: shared-memory traffic, not HBM bytes.  Each
// 32x32 output tile reads its (32 + k - 1)^2 u8 inputs once from device
// memory (clamped coordinates give the replicate border) into an int32
// integral image in shared memory, built by row scans then column scans
// (the pitch is odd, so the row scans are free of bank conflicts).  Every
// box sum is then four shared reads at any k, where a direct window would
// read k*k.  The TPU kernel's bf16 hi/lo byte split and band matmuls are
// MXU devices and are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using lt::allow_smem;
using lt::kTileH;
using lt::kTileW;
using lt::tile_grid;

static_assert(kTileW == kTileH, "the integral image is square");

// Grid: (ceil(W/32), ceil(H/32), T); block 32x8.  Shared memory: the
// integral image, side x side int32 with side = 32 + k (a zero row and
// column, then the 32 + k - 1 staged rows and columns).
__global__ void adaptive_mean_kernel(const uint8_t* __restrict__ in,
                                     uint8_t* __restrict__ out, int H, int W,
                                     int k, int idelta) {
  extern __shared__ int integ[];
  const int r = k / 2;
  const int side = kTileW + k;  // odd, since k is odd
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const size_t frame = (size_t)blockIdx.z * H * W;
  const uint8_t* src = in + frame;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;

  // integ[j][i] (j, i >= 1) holds the staged pixel at global row
  // y0 - r + j - 1, column x0 - r + i - 1, clamped into the image.
  for (int i = tid; i < side * side; i += nthr) {
    const int ly = i / side;
    const int lx = i - ly * side;
    int v = 0;
    if (ly > 0 && lx > 0) {
      const int gy = min(max(y0 - r + ly - 1, 0), H - 1);
      const int gx = min(max(x0 - r + lx - 1, 0), W - 1);
      v = src[(size_t)gy * W + gx];
    }
    integ[i] = v;
  }
  __syncthreads();
  for (int y = tid; y < side; y += nthr) {
    int* row = integ + y * side;
    int s = 0;
    for (int x = 0; x < side; ++x) {
      s += row[x];
      row[x] = s;
    }
  }
  __syncthreads();
  for (int x = tid; x < side; x += nthr) {
    int s = 0;
    for (int y = 0; y < side; ++y) {
      s += integ[y * side + x];
      integ[y * side + x] = s;
    }
  }
  __syncthreads();
  // Output (ly, lx) has its window on staged rows ly..ly+k-1 and columns
  // lx..lx+k-1: integral rows and columns ly..ly+k, lx..lx+k.
  const int area = k * k;
  for (int i = tid; i < kTileW * kTileH; i += nthr) {
    const int ly = i / kTileW;
    const int lx = i - ly * kTileW;
    const int gy = y0 + ly;
    const int gx = x0 + lx;
    if (gy >= H || gx >= W) continue;
    const int* top = integ + ly * side;
    const int* bot = integ + (ly + k) * side;
    const int box = bot[lx + k] - bot[lx] - top[lx + k] + top[lx];
    const size_t o = (size_t)gy * W + gx;
    const int x = src[o];
    out[frame + o] = (2 * box + area < 2 * area * (x + idelta)) ? 255 : 0;
  }
}

}  // namespace

extern "C" {

// out = cv2.adaptiveThreshold(img, 255, MEAN_C, BINARY, ksize, C) of a
// (T, H, W) uint8 batch; ksize odd.
int lt_adaptive_mean(const void* img, void* out, int T, int H, int W,
                     int ksize, int C, void* stream) {
  if (ksize < 1 || ksize % 2 == 0 || T < 1 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  const int side = kTileW + ksize;
  const size_t smem = sizeof(int) * (size_t)side * side;
  cudaError_t err = allow_smem(adaptive_mean_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  adaptive_mean_kernel<<<tile_grid(T, H, W), dim3(32, 8), smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), static_cast<uint8_t*>(out), H, W,
      ksize, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
