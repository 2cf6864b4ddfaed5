// Hand-written Hopper (sm_90a) kernel for the in-tile gather probe: a chain
// of `reps` tile-local gathers over an (H, W) int32 array cut into (8, 128)
// tiles, in one launch.
//
// It replaces the Pallas TPU kernel of scripts/mosaic_probe11.py, `timed`'s
// `call` (:44/:49, pallas_call at :50), which asks what a dynamic gather
// inside one (8, 128) vreg costs.  For every tile, with prev = 0 at the
// start, `reps` times
//   prev = op(s + prev, li, si) & 0x7F
// where op is, at tile-local row r and column c:
//   B0  v[r, c]                       (the plain add)
//   G1  v[r, li[r, c]]                (lane gather, li < 128)
//   G2  v[si[r, c], c]                (sublane gather, si < 8)
//   G3  G2 of G1: v[si[r, c], li[si[r, c], c]]
// Indices are read modulo the tile (li & 127, si & 7), so no index reads
// outside its tile.  Integer and bit-exact: the add wraps as int32.
//
// Plain C interface, loaded with ctypes: the entry launches on the stream it
// is given, allocates nothing and returns cudaGetLastError().
//
// What bounds it on the H100: one read of s, li and si and one write of the
// output (2.6 MB at (128, 1280), under a microsecond), against 2-4 int32
// operations per element and rep; a call is far below a launch's cost.  The
// design is the TPU's: one CTA per tile (160 at the probe's size, all
// resident at once), each thread keeping its elements, indices and prev in
// registers for every rep, v = s + prev staged in shared memory so the
// gather is one shared load at a computed address, with a barrier between
// the write and the reads (G3 stages its first gather too).  The plain add
// needs no shared memory at all.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 8;
constexpr int kTileW = 128;
constexpr int kTile = kTileH * kTileW;
constexpr int kThreads = 256;
constexpr int kEpt = kTile / kThreads;  // elements a thread keeps
constexpr int kMask = 0x7F;
enum Op { kB0 = 0, kG1 = 1, kG2 = 2, kG3 = 3 };

// Grid (W / 128, H / 8), block kThreads: CTA (bx, by) is the tile of rows
// [8 by, 8 by + 8) and columns [128 bx, 128 bx + 128); its element e sits
// at tile row e / 128, column e % 128.
template <int kOp>
__global__ void __launch_bounds__(kThreads)
    tile_gather_kernel(const int* __restrict__ src, const int* __restrict__ li,
                       const int* __restrict__ si, int* __restrict__ out,
                       int W, int reps) {
  __shared__ int v[kTile];
  __shared__ int u[kTile];
  const int tid = threadIdx.x;
  size_t g[kEpt];
  int s[kEpt], lane_src[kEpt], row_src[kEpt], prev[kEpt];
#pragma unroll
  for (int j = 0; j < kEpt; ++j) {
    const int e = tid + j * kThreads;
    const int r = e / kTileW;
    const int c = e % kTileW;
    g[j] = (size_t)(blockIdx.y * kTileH + r) * W + blockIdx.x * kTileW + c;
    s[j] = src[g[j]];
    // Shared slots the gathers read: (r, li[r, c]) and (si[r, c], c).
    lane_src[j] = r * kTileW + (li[g[j]] & (kTileW - 1));
    row_src[j] = (si[g[j]] & (kTileH - 1)) * kTileW + c;
    prev[j] = 0;
  }
  for (int rep = 0; rep < reps; ++rep) {
    int x[kEpt];
#pragma unroll
    for (int j = 0; j < kEpt; ++j)
      x[j] = (int)((unsigned int)s[j] + (unsigned int)prev[j]);
    if constexpr (kOp != kB0) {
#pragma unroll
      for (int j = 0; j < kEpt; ++j) v[tid + j * kThreads] = x[j];
      __syncthreads();
      if constexpr (kOp == kG1) {
#pragma unroll
        for (int j = 0; j < kEpt; ++j) x[j] = v[lane_src[j]];
      } else if constexpr (kOp == kG2) {
#pragma unroll
        for (int j = 0; j < kEpt; ++j) x[j] = v[row_src[j]];
      } else {
#pragma unroll
        for (int j = 0; j < kEpt; ++j) u[tid + j * kThreads] = v[lane_src[j]];
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kEpt; ++j) x[j] = u[row_src[j]];
      }
      // Every read of this rep before the next rep's writes.
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < kEpt; ++j) prev[j] = x[j] & kMask;
  }
#pragma unroll
  for (int j = 0; j < kEpt; ++j) out[g[j]] = prev[j];
}

}  // namespace

extern "C" {

// out (H, W) int32 = the chain of `reps` reps of op (0 B0, 1 G1, 2 G2,
// 3 G3) over src, with the tile-local indices li and si, all (H, W) int32;
// H a multiple of 8, W of 128.
int lt_tile_gather(const void* src, const void* li, const void* si,
                   void* out, int H, int W, int op, int reps, void* stream) {
  if (H < kTileH || H % kTileH || W < kTileW || W % kTileW || reps < 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(W / kTileW, H / kTileH);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kernel = tile_gather_kernel<kB0>;
  switch (op) {
    case kB0: break;
    case kG1: kernel = tile_gather_kernel<kG1>; break;
    case kG2: kernel = tile_gather_kernel<kG2>; break;
    case kG3: kernel = tile_gather_kernel<kG3>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const int*>(src), static_cast<const int*>(li),
      static_cast<const int*>(si), static_cast<int*>(out), W, reps);
  return (int)cudaGetLastError();
}

}  // extern "C"
