// Hand-written Hopper (sm_90a) kernels for the filter stage's morphology,
// cross thresholds and merges.
//
// They replace these Pallas TPU kernels, all in
// lane_tracker_tpu/kernels/filter_stage2.py:
//   lt_tophat          <- tophat_pallas2         (white tophat, OpenCV ellipse SE)
//   lt_cross_threshold <- the riders of tophat_riders_pallas2, and
//                         bilateral_threshold_pallas2 (bilateral cross
//                         threshold, optional noise keep-mask)
//   lt_thr_merge_open  <- thr_merge_open_pallas2 (B threshold, merge with R
//                         and keep, 5x5 elliptical open, packed row prefixes)
//   lt_merge_open      <- merge_open_pallas2     ((r | b) & keep, the same
//                         open and prefixes; the second attempt's last stage)
// Two entries answer the morphology probes' questions with the same tiles:
//   lt_tophat_staged   <- tophat_bf16 of scripts/mosaic_probe5.py (the tophat
//                         with bf16 or f32 compute scratch): morph_kernel
//                         staged in bf16 or f32 instead of uint8
//   lt_dual_tophat     <- build_dual of scripts/mosaic_probe10.py (two
//                         independent tophats, k=29 on R and k=55 on LAB-B,
//                         in one kernel): one erode and one dilate launch
//                         whose CTAs split between the two problems, where
//                         two lt_tophat calls take four launches
// The open + prefix tail is one host-side launcher (launch_open_prefix)
// that both merge entries call.  The second attempt's adaptive mean
// threshold is in adaptive_mean.cu.
// Everything is integer, so each entry is bit-exact with its plain PyTorch
// twin in lane_tracker_tpu_torch/kernels/filter_stage.py.
//
// Plain C interface, loaded with ctypes: each entry launches on the stream it
// is given, allocates nothing (the caller passes outputs and scratch) and
// returns cudaGetLastError().  Images are (T, H, W) uint8, row-major,
// contiguous.
//
// What bounds them on the H100: shared-memory reads, not HBM bytes.  Each
// pass reads its u8 inputs from device memory once and writes once, while
// a naive stencil would read every pixel up to k*k times from shared
// memory.
//   * Morphology: a k x k ellipse is up to k*k taps.  Each block stages a
//     32x32 tile plus a k/2 halo in shared memory (255 outside the image
//     for erode, 0 for dilate) and builds a pow2 pyramid of horizontal
//     window min/max in place, so each SE row costs two shared reads: 2k
//     reads per pixel instead of ~k*k (110 instead of ~2400 at k=55).
//   * Cross threshold: the four k-pixel arms come from int32 exclusive
//     prefix sums of a horizontal and a vertical strip through the tile
//     (zero outside the image): four reads per pixel at any k.
//   * Row prefixes: one warp per image row, shuffle scans of 32 columns.
//   * The merge of lt_merge_open is a grid-stride elementwise pass: HBM
//     bound, three u8 reads and one write per pixel.
// Erode and dilate are two launches (the dilate needs the eroded halo);
// fusing them, fusing the merge into the erode's staging, and fusing the
// riders into the tophat, is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

using lt::allow_smem;
using lt::cross_hit;
using lt::kTileH;
using lt::kTileW;
using lt::load_runs;
using lt::op;
using lt::SeRuns;
using lt::tile_grid;

// The type a morphology tile stages its pixels and builds its pyramid in:
// uint8 (the production kernels), bf16 or f32 (scripts/mosaic_probe5.py's
// question).  Pixels are 0..255, exact in all three, so the staging type
// does not change the result.
template <typename S>
__device__ __forceinline__ S to_stage(uint8_t v) {
  if constexpr (std::is_same_v<S, __nv_bfloat16>)
    return __float2bfloat16_rn((float)v);
  else return (S)v;
}
template <typename S>
__device__ __forceinline__ uint8_t from_stage(S v) {
  if constexpr (std::is_same_v<S, __nv_bfloat16>)
    return (uint8_t)__bfloat162float(v);
  else return (uint8_t)v;
}
template <bool kMax, typename S>
__device__ __forceinline__ S stage_op(S a, S b) {
  if constexpr (std::is_same_v<S, __nv_bfloat16>)
    return kMax ? __hmax(a, b) : __hmin(a, b);
  else if constexpr (std::is_same_v<S, float>)
    return kMax ? fmaxf(a, b) : fminf(a, b);
  else return op<kMax>(a, b);
}

// Erode (kMax=false, fill 255) or dilate (kMax=true, fill 0) by the SE
// runs, one 32x32 output tile of frame z, staged in S.  With kSubtract the
// output is sub_src - result (the tophat epilogue).  lev: the dynamic
// shared memory, nlev planes of (32 + 2r)^2 S.
template <typename S, bool kMax, bool kSubtract>
__device__ __forceinline__ void morph_tile(const uint8_t* __restrict__ in,
                                           const uint8_t* __restrict__ sub_src,
                                           uint8_t* __restrict__ out, int H,
                                           int W, const SeRuns& runs, int r,
                                           int nlev, int z, S* lev) {
  const int rows = kTileH + 2 * r;
  const int cols = kTileW + 2 * r;
  const int plane = rows * cols;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const size_t frame = (size_t)z * H * W;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;
  const S fill = to_stage<S>(kMax ? 0 : 255);

  for (int i = tid; i < plane; i += nthr) {
    const int ly = i / cols;
    const int lx = i - ly * cols;
    const int gy = y0 - r + ly;
    const int gx = x0 - r + lx;
    lev[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                 ? to_stage<S>(in[frame + (size_t)gy * W + gx])
                 : fill;
  }
  __syncthreads();
  // Level j holds op over columns [c, c + 2^j) of its row.  Entries whose
  // window runs off the tile are never read.
  for (int j = 0; j + 1 < nlev; ++j) {
    const S* a = lev + j * plane;
    S* b = lev + (j + 1) * plane;
    const int s = 1 << j;
    for (int i = tid; i < plane; i += nthr) {
      const int lx = i % cols;
      b[i] = (lx + s < cols) ? stage_op<kMax>(a[i], a[i + s]) : a[i];
    }
    __syncthreads();
  }
  for (int i = tid; i < kTileW * kTileH; i += nthr) {
    const int ly = i / kTileW;
    const int lx = i - ly * kTileW;
    const int gy = y0 + ly;
    const int gx = x0 + lx;
    if (gy >= H || gx >= W) continue;
    S acc = fill;
    for (int q = 0; q < runs.n; ++q) {
      const int lo = runs.lo[q];
      const int hi = runs.hi[q];
      const int k = 31 - __clz(hi - lo + 1);
      const S* row =
          lev + k * plane + (ly + r + runs.dy[q]) * cols + (lx + r);
      acc = stage_op<kMax>(acc, stage_op<kMax>(row[lo], row[hi - (1 << k) + 1]));
    }
    const size_t o = frame + (size_t)gy * W + gx;
    const uint8_t res = from_stage(acc);
    out[o] = kSubtract ? (uint8_t)(sub_src[o] - res) : res;
  }
}

// One tile per CTA.  Grid: (ceil(W/32), ceil(H/32), T); block 32x8.
template <typename S, bool kMax, bool kSubtract>
__global__ void morph_kernel(const uint8_t* __restrict__ in,
                             const uint8_t* __restrict__ sub_src,
                             uint8_t* __restrict__ out, int H, int W,
                             SeRuns runs, int r, int nlev) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  morph_tile<S, kMax, kSubtract>(in, sub_src, out, H, W, runs, r, nlev,
                                 blockIdx.z, reinterpret_cast<S*>(smem_raw));
}

// Two independent problems of one frame shape in one launch
// (scripts/mosaic_probe10.py's dual tophat): CTAs with blockIdx.z < T take
// problem a (its frames, runs, halo and output), the rest problem b.  The
// dynamic shared memory is sized for the larger.  Grid: (ceil(W/32),
// ceil(H/32), 2T).
template <bool kMax, bool kSubtract>
__global__ void dual_morph_kernel(const uint8_t* __restrict__ in_a,
                                  const uint8_t* __restrict__ in_b,
                                  const uint8_t* __restrict__ sub_a,
                                  const uint8_t* __restrict__ sub_b,
                                  uint8_t* __restrict__ out_a,
                                  uint8_t* __restrict__ out_b, int T, int H,
                                  int W, SeRuns runs_a, SeRuns runs_b,
                                  int r_a, int r_b, int nlev_a, int nlev_b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int z = blockIdx.z;
  if (z < T)
    morph_tile<uint8_t, kMax, kSubtract>(in_a, sub_a, out_a, H, W, runs_a, r_a,
                                         nlev_a, z, smem_raw);
  else
    morph_tile<uint8_t, kMax, kSubtract>(in_b, sub_b, out_b, H, W, runs_b, r_b,
                                         nlev_b, z - T, smem_raw);
}

// Bilateral cross threshold, mode 'floor': hit iff both horizontal k-arm
// sums < k*x - C*k or both vertical ones are; arms exclude the pixel and
// read 0 outside the image.  noise_thresh >= 0 gives the keep-mask
// (x < noise_thresh) | hit.  Non-null merge_r / keep give the merge
// epilogue ((merge_r | hit) & keep).  Output 0/255.
__global__ void cross_threshold_kernel(const uint8_t* __restrict__ in,
                                       const uint8_t* __restrict__ merge_r,
                                       const uint8_t* __restrict__ keep,
                                       uint8_t* __restrict__ out, int H, int W,
                                       int k, int C, int noise_thresh) {
  extern __shared__ int strips[];
  const int hw = kTileW + 2 * k + 1;  // odd: conflict-free row scans
  const int vh = kTileH + 2 * k + 1;
  int* hs = strips;                // kTileH rows x hw: row prefixes
  int* vs = strips + kTileH * hw;  // vh rows x kTileW: column prefixes
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const size_t frame = (size_t)blockIdx.z * H * W;
  const uint8_t* src = in + frame;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;

  // Slot 0 of each strip is the leading zero of the exclusive prefix;
  // slot 1 + j holds the pixel k columns (rows) before the tile plus j.
  for (int i = tid; i < kTileH * hw; i += nthr) {
    const int ly = i / hw;
    const int j = i - ly * hw;
    const int gy = y0 + ly;
    const int gx = x0 - k + j - 1;
    hs[i] = (j > 0 && gy < H && gx >= 0 && gx < W) ? src[(size_t)gy * W + gx]
                                                   : 0;
  }
  for (int i = tid; i < vh * kTileW; i += nthr) {
    const int j = i / kTileW;
    const int lx = i - j * kTileW;
    const int gy = y0 - k + j - 1;
    const int gx = x0 + lx;
    vs[i] = (j > 0 && gy >= 0 && gy < H && gx < W) ? src[(size_t)gy * W + gx]
                                                   : 0;
  }
  __syncthreads();
  if (tid < kTileH) {
    int* row = hs + tid * hw;
    int s = 0;
    for (int j = 0; j < hw; ++j) {
      s += row[j];
      row[j] = s;
    }
  } else if (tid >= 32 && tid < 32 + kTileW) {
    const int lx = tid - 32;
    int s = 0;
    for (int j = 0; j < vh; ++j) {
      s += vs[j * kTileW + lx];
      vs[j * kTileW + lx] = s;
    }
  }
  __syncthreads();
  for (int i = tid; i < kTileW * kTileH; i += nthr) {
    const int ly = i / kTileW;
    const int lx = i - ly * kTileW;
    const int gy = y0 + ly;
    const int gx = x0 + lx;
    if (gy >= H || gx >= W) continue;
    const int* h = hs + ly * hw + lx;
    const int x = h[k + 1] - h[k];
    bool hit = cross_hit(h, vs + ly * kTileW + lx, kTileW, k, x, C);
    if (noise_thresh >= 0) hit = hit || x < noise_thresh;
    const size_t o = frame + (size_t)gy * W + gx;
    if (merge_r != nullptr) hit = hit || merge_r[o] != 0;
    if (keep != nullptr) hit = hit && keep[o] != 0;
    out[o] = hit ? 255 : 0;
  }
}

// Packed exclusive row prefixes: pref[row][X] = (xsum << shift) | count
// over the nonzero pixels with column < X, X = 0..W.  One warp per row.
__global__ void row_prefix_kernel(const uint8_t* __restrict__ bin,
                                  int32_t* __restrict__ pref, int n_rows,
                                  int W, int shift) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const uint8_t* b = bin + (size_t)row * W;
  int32_t* p = pref + (size_t)row * (W + 1);
  if (lane == 0) p[0] = 0;
  int carry = 0;
  for (int base = 0; base < W; base += 32) {
    const int x = base + lane;
    int v = (x < W && b[x] != 0) ? ((x << shift) | 1) : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v += n;
    }
    if (x < W) p[x + 1] = carry + v;
    carry += __shfl_sync(0xffffffffu, v, 31);
  }
}

// merged = ((r | b) & keep) as 0/255, elementwise; keep may be null.
__global__ void merge_kernel(const uint8_t* __restrict__ r,
                             const uint8_t* __restrict__ b,
                             const uint8_t* __restrict__ keep,
                             uint8_t* __restrict__ merged, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    bool hit = r[i] != 0 || b[i] != 0;
    if (keep != nullptr) hit = hit && keep[i] != 0;
    merged[i] = hit ? 255 : 0;
  }
}

// Pyramid levels a morphology tile needs for the SE's longest run.
int pyramid_levels(const SeRuns& runs) {
  int nlev = 1;
  while ((1 << nlev) <= runs.max_run) ++nlev;
  return nlev;
}

size_t morph_smem(const SeRuns& runs, int ksize, size_t elem) {
  const int r = ksize / 2;
  return elem * pyramid_levels(runs) * (kTileH + 2 * r) * (kTileW + 2 * r);
}

template <bool kMax, bool kSubtract, typename S = uint8_t>
cudaError_t launch_morph(const uint8_t* in, const uint8_t* sub_src,
                         uint8_t* out, const SeRuns& runs, int ksize, int T,
                         int H, int W, cudaStream_t stream) {
  const size_t smem = morph_smem(runs, ksize, sizeof(S));
  cudaError_t err = allow_smem(morph_kernel<S, kMax, kSubtract>, smem);
  if (err != cudaSuccess) return err;
  morph_kernel<S, kMax, kSubtract><<<tile_grid(T, H, W), dim3(32, 8), smem,
                                     stream>>>(
      in, sub_src, out, H, W, runs, ksize / 2, pyramid_levels(runs));
  return cudaGetLastError();
}

// out = img - open(img), staged in S: an erode launch and a dilate launch.
template <typename S>
cudaError_t launch_tophat(const uint8_t* x, uint8_t* eroded, uint8_t* out,
                          const SeRuns& se, int ksize, int T, int H, int W,
                          cudaStream_t s) {
  cudaError_t err =
      launch_morph<false, false, S>(x, nullptr, eroded, se, ksize, T, H, W, s);
  if (err != cudaSuccess) return err;
  return launch_morph<true, true, S>(eroded, x, out, se, ksize, T, H, W, s);
}

template <bool kMax, bool kSubtract>
cudaError_t launch_dual_morph(const uint8_t* in_a, const uint8_t* in_b,
                              const uint8_t* sub_a, const uint8_t* sub_b,
                              uint8_t* out_a, uint8_t* out_b,
                              const SeRuns& se_a, const SeRuns& se_b, int ka,
                              int kb, int T, int H, int W, cudaStream_t s) {
  const size_t sa = morph_smem(se_a, ka, 1);
  const size_t sb = morph_smem(se_b, kb, 1);
  const size_t smem = sa > sb ? sa : sb;
  cudaError_t err = allow_smem(dual_morph_kernel<kMax, kSubtract>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid = tile_grid(2 * T, H, W);
  dual_morph_kernel<kMax, kSubtract><<<grid, dim3(32, 8), smem, s>>>(
      in_a, in_b, sub_a, sub_b, out_a, out_b, T, H, W, se_a, se_b, ka / 2,
      kb / 2, pyramid_levels(se_a), pyramid_levels(se_b));
  return cudaGetLastError();
}

cudaError_t launch_threshold(const uint8_t* in, const uint8_t* merge_r,
                             const uint8_t* keep, uint8_t* out, int T, int H,
                             int W, int k, int C, int noise_thresh,
                             cudaStream_t stream) {
  const size_t smem = sizeof(int) * ((size_t)kTileH * (kTileW + 2 * k + 1) +
                                     (size_t)(kTileH + 2 * k + 1) * kTileW);
  cudaError_t err = allow_smem(cross_threshold_kernel, smem);
  if (err != cudaSuccess) return err;
  cross_threshold_kernel<<<tile_grid(T, H, W), dim3(32, 8), smem, stream>>>(
      in, merge_r, keep, out, H, W, k, C, noise_thresh);
  return cudaGetLastError();
}

// The tail both merge entries share: binary = open(merged) with the
// ellipse runs (erode into `eroded`, dilate into `bin`; the erode's 255
// fill outside the image is the reference's pad of the merged input), then
// the packed row prefixes of binary into pref.
cudaError_t launch_open_prefix(const uint8_t* merged, uint8_t* eroded,
                               uint8_t* bin, int32_t* pref, const SeRuns& se,
                               int open_k, int T, int H, int W, int shift,
                               cudaStream_t s) {
  cudaError_t err =
      launch_morph<false, false>(merged, nullptr, eroded, se, open_k, T, H, W,
                                 s);
  if (err != cudaSuccess) return err;
  err = launch_morph<true, false>(eroded, nullptr, bin, se, open_k, T, H, W,
                                  s);
  if (err != cudaSuccess) return err;
  const int n_rows = T * H;
  const int threads = 256;
  const int blocks = (n_rows * 32 + threads - 1) / threads;
  row_prefix_kernel<<<blocks, threads, 0, s>>>(bin, pref, n_rows, W, shift);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out = img - open(img) with the ellipse SE whose runs are in `runs`
// (n rows of int32 (dy, lo, hi), a host array).  scratch holds the
// eroded image.
int lt_tophat(const void* img, void* out, void* scratch, const void* runs,
              int n_runs, int ksize, int T, int H, int W, void* stream) {
  SeRuns se;
  if (load_runs(static_cast<const int*>(runs), n_runs, &se) != 0 ||
      ksize < 1 || T < 1 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* x = static_cast<const uint8_t*>(img);
  uint8_t* e = static_cast<uint8_t*>(scratch);
  cudaError_t err =
      launch_morph<false, false>(x, nullptr, e, se, ksize, T, H, W, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_morph<true, true>(e, x, static_cast<uint8_t*>(out), se,
                                       ksize, T, H, W, s);
}

// lt_tophat with the tiles staged, and their pyramids built, in another
// type than uint8: stage 1 bf16, 2 f32.
int lt_tophat_staged(const void* img, void* out, void* scratch,
                     const void* runs, int n_runs, int ksize, int T, int H,
                     int W, int stage, void* stream) {
  SeRuns se;
  if (load_runs(static_cast<const int*>(runs), n_runs, &se) != 0 ||
      ksize < 1 || T < 1 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* x = static_cast<const uint8_t*>(img);
  uint8_t* e = static_cast<uint8_t*>(scratch);
  uint8_t* o = static_cast<uint8_t*>(out);
  switch (stage) {
    case 1:
      return (int)launch_tophat<__nv_bfloat16>(x, e, o, se, ksize, T, H, W, s);
    case 2: return (int)launch_tophat<float>(x, e, o, se, ksize, T, H, W, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Two tophats of one frame shape, a with ka and b with kb, in one erode
// launch and one dilate launch.  scratch_a / scratch_b hold the eroded
// images.
int lt_dual_tophat(const void* a, const void* b, void* out_a, void* out_b,
                   void* scratch_a, void* scratch_b, const void* runs_a,
                   int n_runs_a, int ka, const void* runs_b, int n_runs_b,
                   int kb, int T, int H, int W, void* stream) {
  SeRuns se_a, se_b;
  if (load_runs(static_cast<const int*>(runs_a), n_runs_a, &se_a) != 0 ||
      load_runs(static_cast<const int*>(runs_b), n_runs_b, &se_b) != 0 ||
      ka < 1 || kb < 1 || T < 1 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* xa = static_cast<const uint8_t*>(a);
  const uint8_t* xb = static_cast<const uint8_t*>(b);
  uint8_t* ea = static_cast<uint8_t*>(scratch_a);
  uint8_t* eb = static_cast<uint8_t*>(scratch_b);
  cudaError_t err = launch_dual_morph<false, false>(
      xa, xb, nullptr, nullptr, ea, eb, se_a, se_b, ka, kb, T, H, W, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_dual_morph<true, true>(
      ea, eb, xa, xb, static_cast<uint8_t*>(out_a),
      static_cast<uint8_t*>(out_b), se_a, se_b, ka, kb, T, H, W, s);
}

// Bilateral cross threshold (optionally the noise keep-mask) of img.
int lt_cross_threshold(const void* img, void* out, int T, int H, int W,
                       int ksize, int C, int noise_thresh, void* stream) {
  if (ksize < 1 || T < 1 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  return (int)launch_threshold(static_cast<const uint8_t*>(img), nullptr,
                               nullptr, static_cast<uint8_t*>(out), T, H, W,
                               ksize, C, noise_thresh,
                               static_cast<cudaStream_t>(stream));
}

// binary = open(((r_th | thr(b_feat, kb, Cb)) & keep) as 0/255, ellipse
// open_k); pref = packed exclusive row prefixes of binary, (T, H, W+1).
// keep may be null.  scratch0 / scratch1 hold the merged and the eroded
// images.
int lt_thr_merge_open(const void* r_th, const void* b_feat, const void* keep,
                      void* out, void* pref, void* scratch0, void* scratch1,
                      const void* runs, int n_runs, int open_k, int T, int H,
                      int W, int kb, int Cb, int shift, void* stream) {
  SeRuns se;
  if (load_runs(static_cast<const int*>(runs), n_runs, &se) != 0 ||
      open_k < 1 || kb < 1 || T < 1 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* merged = static_cast<uint8_t*>(scratch0);
  cudaError_t err = launch_threshold(
      static_cast<const uint8_t*>(b_feat), static_cast<const uint8_t*>(r_th),
      static_cast<const uint8_t*>(keep), merged, T, H, W, kb, Cb, -1, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_open_prefix(merged, static_cast<uint8_t*>(scratch1),
                                 static_cast<uint8_t*>(out),
                                 static_cast<int32_t*>(pref), se, open_k, T,
                                 H, W, shift, s);
}

// binary = open(((r_th | b_th) & keep) as 0/255, ellipse open_k); pref as
// in lt_thr_merge_open.  keep may be null.  scratch0 / scratch1 hold the
// merged and the eroded images.
int lt_merge_open(const void* r_th, const void* b_th, const void* keep,
                  void* out, void* pref, void* scratch0, void* scratch1,
                  const void* runs, int n_runs, int open_k, int T, int H,
                  int W, int shift, void* stream) {
  SeRuns se;
  if (load_runs(static_cast<const int*>(runs), n_runs, &se) != 0 ||
      open_k < 1 || T < 1 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* merged = static_cast<uint8_t*>(scratch0);
  const size_t n = (size_t)T * H * W;
  const int threads = 256;
  const size_t want = (n + threads - 1) / threads;
  const int blocks = (int)(want < 4096 ? want : 4096);
  merge_kernel<<<blocks, threads, 0, s>>>(
      static_cast<const uint8_t*>(r_th), static_cast<const uint8_t*>(b_th),
      static_cast<const uint8_t*>(keep), merged, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_open_prefix(merged, static_cast<uint8_t*>(scratch1),
                                 static_cast<uint8_t*>(out),
                                 static_cast<int32_t*>(pref), se, open_k, T,
                                 H, W, shift, s);
}

}  // extern "C"
