// Hand-written Hopper (sm_90a) kernel for pass 2 of the banded warp.
//
// Replaces the Pallas TPU kernel _pass2_call (scripts/resample_mxu2.py:296,
// kernel _pass2_kernel at :259):
//   lt_banded_pass2 <- _pass2_call
// Every output pixel (n, z, w) of a plane n = t * C + c is the lerp of its
// two pass-1 taps, clip(rint(fma(t1[x0 + 1], w1, t1[x0] * w0)), 0, 255),
// with x0, w0 and w1 read from the packed tiles wpack (Ho, n_tiles, 4, 128)
// f32 (rows [x0, w0, w1, 0]; x0 is exact in f32).  The fma order is the one
// the reference's f32 dot over its 640-wide band forms on the CPU (acc =
// t1[x0] * w0 rounded, then fma with the second tap); the plain twin in
// lane_tracker_tpu_torch/kernels/resample_mxu2.py uses the same order.
//
// The TPU kernel DMAs a LANE-aligned (T, 640) band of t1 per output row and
// multiplies it by a mostly-zero (640, 128) weight tile on the MXU: 640
// multiply-adds for two non-zero taps.  That is a TPU layout, not the
// function, and it is not carried over: here each pixel reads its two taps.
// t1 stays (T, C, Ho, Ws), so the reference's transposes of t1 and of the
// output go too.
//
// What bounds it on the H100: bytes.  At T = 64, C = 2 and the full
// geometry (Ho = 1100, Ws = 1280, Wo = 1080) it reads t1 once, 721 MB of
// f32, and the 20 MB of tiles, and writes 152 MB of u8: about 0.27 ms at
// 3.35 TB/s, against 6 f32 operations per output, 0.91 G, 14 us at
// 67 TFLOP/s.  The design: one thread per output column of one row z; it
// loads its tap and weights once and loops over the T * C planes, so a
// warp's 32 neighbouring columns read neighbouring t1 words (x0 rises with
// w) and write 32 neighbouring bytes.  Staging rows in shared memory, or
// vector loads, is later work.
//
// Plain C interface, loaded with ctypes: the entry launches on the stream it
// is given, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLane = 128;
constexpr int kThreads = 128;

// Grid (ceil(Wo / kThreads), Ho); thread = output column w of row z.
__global__ void banded_pass2_kernel(const float* __restrict__ t1,
                                    const float* __restrict__ wpack,
                                    uint8_t* __restrict__ out, int n_planes,
                                    int Ho, int Ws, int Wo, int n_tiles) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y;
  if (w >= Wo) return;
  const float* wp =
      wpack + ((size_t)z * n_tiles + w / kLane) * 4 * kLane + w % kLane;
  const int x0 = (int)wp[0];
  const float w0 = wp[kLane];
  const float w1 = wp[2 * kLane];
  for (int n = 0; n < n_planes; ++n) {
    const float* row = t1 + ((size_t)n * Ho + z) * Ws;
    const float acc = __fmaf_rn(row[x0 + 1], w1, __fmul_rn(row[x0], w0));
    const float v = fminf(fmaxf(rintf(acc), 0.0f), 255.0f);
    out[((size_t)n * Ho + z) * Wo + w] = (uint8_t)v;
  }
}

}  // namespace

extern "C" {

// out (n_planes, Ho, Wo) u8 = pass 2 of the (n_planes, Ho, Ws) f32 planes
// t1 through the packed tiles wpack (Ho, n_tiles, 4, 128) f32.
int lt_banded_pass2(const void* t1, const void* wpack, void* out,
                    int n_planes, int Ho, int Ws, int Wo, int n_tiles,
                    void* stream) {
  if (n_planes < 1 || Ho < 1 || Ws < 2 || Wo < 1 || Wo > n_tiles * kLane)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Wo + kThreads - 1) / kThreads, Ho);
  banded_pass2_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(t1), static_cast<const float*>(wpack),
      static_cast<uint8_t*>(out), n_planes, Ho, Ws, Wo, n_tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
