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
// Two entries answer the morphology probes' questions with pow2-pyramid
// tiles (morph_kernel):
//   lt_tophat_staged   <- tophat_bf16 of scripts/mosaic_probe5.py (the tophat
//                         with bf16 or f32 compute scratch): morph_kernel
//                         staged in bf16 or f32 instead of uint8
//   lt_dual_tophat     <- build_dual of scripts/mosaic_probe10.py (two
//                         independent tophats, k=29 on R and k=55 on LAB-B,
//                         in one kernel): one erode and one dilate launch
//                         whose CTAs split between the two problems
// The merge + open + prefix tail is one kernel (open_tail_kernel) that both
// merge entries launch, lt_merge_open with the merge in its load;
// lt_open_prefix launches it alone.  The second attempt's adaptive mean
// threshold is in adaptive_mean.cu.
// Everything is integer, so each entry is bit-exact with its plain PyTorch
// twin in lane_tracker_tpu_torch/kernels/filter_stage.py.
//
// Plain C interface, loaded with ctypes: each entry launches on the stream it
// is given, allocates nothing (the caller passes outputs and scratch) and
// returns cudaGetLastError().  Images are (T, H, W) uint8, row-major,
// contiguous.  lt_filter_stage_launches counts the kernels launched.
//
// What bounds them on the H100: shared-memory traffic and issue slots for
// the stencils, HBM bytes for the tail.  Each kernel reads its u8 inputs
// from device memory once and writes once, while a naive stencil would
// read every pixel up to k*k times from shared memory.
//   * The tophat (tophat_kernel): four pixels a word, one plane of
//     horizontal window min/max widened in place through the ellipse's
//     distinct half-widths, erode and dilate in one launch; see its notes.
//   * The cross threshold (threshold_kernel): running arm sums, row walkers
//     and column walkers over a tall staged tile; see its notes.
//   * The merge + open + prefix tail (open_tail_kernel): 32 binary pixels a
//     word, the open as ANDs and ORs of funnel-shifted words, the prefixes
//     from popcounts; see its notes.
//   * The probes' pow2-pyramid tiles (morph_kernel): a 32x32 tile plus a
//     k/2 halo (255 outside the image for erode, 0 for dilate), two shared
//     reads per SE row; erode and dilate are two launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "tophat.cuh"

namespace {

using lt::allow_smem;
using lt::held_quads;
using lt::kTopGuard;
using lt::kTopThreads;
using lt::load_quad;
using lt::morph_pass;
using lt::quad_word;
using lt::TophatPlan;
using lt::tophat_steps;
using lt::zero_outside;
using lt::kTileH;
using lt::kMaxRuns;
using lt::kTileW;
using lt::load_runs;
using lt::op;
using lt::SeRuns;
using lt::tile_grid;

long long g_launches = 0;  // lt_filter_stage_launches

// cudaGetLastError() after a launch, counting the launch if it was taken.
cudaError_t launched() {
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++g_launches;
  return err;
}

// Whether a kernel may move whole 16-byte quads: W a multiple of 16 and
// both images 16-byte aligned.
bool aligned16(const void* a, const void* b, int W) {
  const uintptr_t bits =
      reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b);
  return W % 16 == 0 && bits % 16 == 0;
}

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

// ---- The tophat (lt_tophat): one launch, the eroded tile in shared memory
//
// What bounds it: shared-memory traffic and issue slots.  The design:
//   * Four pixels a 32-bit word in memory; min/max with Hopper's DPX
//     three-way __vimin3_u16x2 / __vimax3_u16x2 on two pixels a word (see
//     op3_hi), shifted words from __funnelshift_r, quads of 16 bytes for
//     every shared and global load and store.
//   * The ellipse's rows are symmetric: rows +-d share the half-width
//     w(d), and w falls as d grows.  So one plane H of horizontal window
//     min/max, widened in place from half-width 0 to w(0) (a step from h
//     to h + s is op(H << s, H, H >> s), exact while s <= 2h + 1), serves
//     every row: after the step that reaches w(d) each output quad folds
//     in the plane at rows +-d, two aligned quad reads.  k=55 takes 19
//     steps (its 17 half-widths and two strides on the way), 2r + 1 plane
//     reads an output quad, where a pyramid of pow2 windows needs two
//     unaligned reads per SE row.
//     A step only widens the rows a later gather reads.
//   * Erode and dilate in one launch: the erode runs over the tile plus an
//     r halo (input staged with a 2r halo, 255 outside the image), its
//     result stays in shared memory (0 outside the image: the opening's
//     dilate pad), the dilate runs from there and the epilogue writes
//     img - open(img).  The eroded image never goes to HBM.
//   * Tiles sized for the halo: 64 to 256 columns by up to 256 rows, the
//     tallest that fits two CTAs an SM, chosen by the host (tophat_plan)
//     for the frame.
// Two shared buffers, each the staged tile: the plane is widened from one
// into the other, one barrier a step.  Reads that run off a row or off
// the buffer (into a guard) only feed values whose window runs off the
// staged region, which no output reads.

constexpr int kTopMaxQuads = 6;    // accumulator quads a thread holds
constexpr size_t kTopSmemTwo = 110 * 1024;  // two CTAs an SM

// Bytes of the tophat's two buffers (each the staged tile, 2r rows and
// 2 rq quads of halo a side, plus guards) for a tile of tq quads x th rows.
size_t tophat_smem(int tq, int th, int r, int rq) {
  return 2 * 16 * ((size_t)(th + 4 * r) * (tq + 4 * rq) + 2 * kTopGuard);
}

// Grid: (ceil(W / 16 tq), ceil(H / th), T); kTopThreads threads.
__global__ void __launch_bounds__(kTopThreads, 2)
    tophat_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                  int H, int W, bool vec, TophatPlan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int r = p.r, rq = p.rq, tq = p.tq, th = p.th;
  const int nqx = tq + 4 * rq, nrx = th + 4 * r;  // staged input
  const int nqe = tq + 2 * rq, nre = th + 2 * r;  // eroded region
  uint4* buf0 = reinterpret_cast<uint4*>(smem_raw) + kTopGuard;
  uint4* buf1 = buf0 + (size_t)nrx * nqx + 2 * kTopGuard;
  const int x0 = blockIdx.x * tq * 16;
  const int y0 = blockIdx.y * th;
  const size_t frame = (size_t)blockIdx.z * H * W;

  for (int i = threadIdx.x; i < nrx * nqx; i += kTopThreads) {
    const int row = i / nqx;
    buf0[i] = load_quad(in + frame, H, W, y0 - 2 * r + row,
                        x0 - 32 * rq + 16 * (i - row * nqx), 255u, vec);
  }
  __syncthreads();
  int off[kTopMaxQuads];
  uint4 acc[kTopMaxQuads];
  int nq = held_quads(nre * nqe, nqe, nqx, r, rq, off);
  morph_pass<false>(buf0, buf1, p, nqx, nre, off, acc, nq);
  __syncthreads();
  // The eroded region into buf0, rows of nqe quads, 0 outside the image.
#pragma unroll
  for (int j = 0; j < kTopMaxQuads; ++j) {
    if (j >= nq) break;
    const int m = threadIdx.x + j * kTopThreads;
    const int row = m / nqe;
    const int gy = y0 - r + row;
    buf0[m] = zero_outside(acc[j], H, W, gy,
                           x0 - 16 * rq + 16 * (m - row * nqe));
  }
  __syncthreads();
  nq = held_quads(th * tq, tq, nqe, r, rq, off);
  morph_pass<true>(buf0, buf1, p, nqe, th, off, acc, nq);
  // out = img - open(img): bytewise with no borrow, as open <= img.
#pragma unroll
  for (int j = 0; j < kTopMaxQuads; ++j) {
    if (j >= nq) break;
    const int m = threadIdx.x + j * kTopThreads;
    const int row = m / tq;
    const int gy = y0 + row;
    const int gx = x0 + 16 * (m - row * tq);
    if (gy >= H || gx >= W) continue;
    const uint4 x = load_quad(in + frame, H, W, gy, gx, 0u, vec);
    const uint4& d = acc[j];
    const uint4 o = make_uint4(x.x - d.x, x.y - d.y, x.z - d.z, x.w - d.w);
    uint8_t* dst = out + frame + (size_t)gy * W + gx;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = o;
    } else {
      for (int b = 0; b < 16 && gx + b < W; ++b)
        dst[b] = (uint8_t)(quad_word(o, b / 4) >> (8 * (b % 4)));
    }
  }
}

// ---- The cross threshold (lt_cross_threshold, lt_thr_merge_open) ----
//
// Bilateral cross threshold, mode 'floor': hit iff both horizontal k-arm
// sums < k*x - C*k or both vertical ones are; arms exclude the pixel and
// read 0 outside the image.  noise_thresh >= 0 gives the keep-mask
// (x < noise_thresh) | hit.  Output 0/255.
//
// What bounds it: shared-memory reads and issue slots (its HBM traffic is
// one read of the input and one write).  The design: a CTA stages a
// 128 x 128 tile with a k-row and kx-column halo (kx = k rounded up to 16)
// as bytes, zero outside the image, with 16-byte global loads; a tall tile
// reads the vertical halo once for 128 rows.  Then every thread walks:
//   * row walkers, two a row (64 columns each), keep the left and right
//     arm sums, adding the entering pixel and subtracting the leaving one,
//     and leave the horizontal hits as bits;
//   * column walkers, two a column (64 rows each), do the same with the up
//     and down arms, or in the row's bit, and write the output.
// Three shared byte reads a pixel in each walk (2k more to start a walk),
// all 256 threads busy; rows are an odd number of words apart, so the row
// walkers' reads meet no bank twice.

constexpr int kThrTW = 128;
constexpr int kThrTH = 128;
constexpr int kThrThreads = 256;
constexpr int kThrSeg = 64;         // pixels a walker covers
constexpr int kThrBitsPitch = 5;    // words a row of horizontal hits (odd)
static_assert(kThrTH * (kThrTW / kThrSeg) == kThrThreads, "row walkers");
static_assert(kThrTW * (kThrTH / kThrSeg) == kThrThreads, "column walkers");

// Strip bytes: (kThrTH + 2k) rows of pitch bytes, pitch an odd number of
// words; then the hit bits.
__host__ __device__ inline int thr_pitch(int k) {
  return 4 * ((kThrTW + 2 * ((k + 15) / 16 * 16)) / 4 + 1);
}

inline size_t thr_smem(int k) {
  return (size_t)(kThrTH + 2 * k) * thr_pitch(k) +
         4 * kThrTH * kThrBitsPitch;
}

// Grid: (ceil(W / 128), ceil(H / 128), T); kThrThreads threads.
__global__ void __launch_bounds__(kThrThreads)
    threshold_kernel(const uint8_t* __restrict__ in,
                     uint8_t* __restrict__ out, int H, int W, int k, int C,
                     int noise_thresh, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kx = (k + 15) / 16 * 16;
  const int pb = thr_pitch(k);
  const int nrs = kThrTH + 2 * k;
  const int nq = (kThrTW + 2 * kx) / 16;  // quads a strip row
  uint32_t* s32 = reinterpret_cast<uint32_t*>(smem_raw);
  uint32_t* hbits = s32 + (size_t)nrs * pb / 4;
  const int x0 = blockIdx.x * kThrTW;
  const int y0 = blockIdx.y * kThrTH;
  const size_t frame = (size_t)blockIdx.z * H * W;
  const int tid = threadIdx.x;

  for (int i = tid; i < nrs * nq; i += kThrThreads) {
    const int row = i / nq;
    const int q = i - row * nq;
    const uint4 v =
        load_quad(in + frame, H, W, y0 - k + row, x0 - kx + 16 * q, 0u, vec);
    uint32_t* dst = s32 + row * (pb / 4) + 4 * q;
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
  __syncthreads();
  const int t_off = C * k;
  {
    // Row walker: tile row `row`, columns [xs, xs + kThrSeg).
    const int row = tid % kThrTH;
    const int xs = tid / kThrTH * kThrSeg;
    const uint8_t* rp = smem_raw + (size_t)(k + row) * pb + kx;
    int left = 0, right = 0;
#pragma unroll 4
    for (int j = 1; j <= k; ++j) {
      left += rp[xs - j];
      right += rp[xs + j];
    }
    uint32_t bits = 0;
#pragma unroll 8
    for (int x = xs; x < xs + kThrSeg; ++x) {
      const int v = rp[x];
      const int t = k * v - t_off;
      bits |= (uint32_t)(left < t && right < t) << (x & 31);
      if ((x & 31) == 31) {
        hbits[row * kThrBitsPitch + (x >> 5)] = bits;
        bits = 0;
      }
      // The last slide reads at most the row's pad word: not used.
      left += v - rp[x - k];
      right += rp[x + k + 1] - rp[x + 1];
    }
  }
  __syncthreads();
  {
    // Column walker: tile column c, rows [ys, ys + kThrSeg).
    const int c = tid % kThrTW;
    const int ys = tid / kThrTW * kThrSeg;
    const uint8_t* cp = smem_raw + kx + c;  // cp[y * pb]: strip row y
    int up = 0, down = 0;
#pragma unroll 4
    for (int j = 1; j <= k; ++j) {
      up += cp[(size_t)(k + ys - j) * pb];
      down += cp[(size_t)(k + ys + j) * pb];
    }
    const int gx = x0 + c;
#pragma unroll 8
    for (int y = ys; y < ys + kThrSeg; ++y) {
      const int v = cp[(size_t)(k + y) * pb];
      const int t = k * v - t_off;
      bool hit = (up < t && down < t) ||
                 ((hbits[y * kThrBitsPitch + (c >> 5)] >> (c & 31)) & 1u);
      if (noise_thresh >= 0) hit = hit || v < noise_thresh;
      const int gy = y0 + y;
      if (gy < H && gx < W) {
        const size_t o = frame + (size_t)gy * W + gx;
        out[o] = hit ? 255 : 0;
      }
      // The last slide reads at most one row past the strip (the hit
      // bits): not used.
      up += v - cp[(size_t)y * pb];
      down += cp[(size_t)(2 * k + y + 1) * pb] - cp[(size_t)(k + y + 1) * pb];
    }
  }
}

// ---- The merge + open + prefix tail (lt_thr_merge_open's second launch,
// lt_merge_open, lt_open_prefix): open_tail_kernel
//
// binary = open((a | b) & keep) as 0/255 with the ellipse runs, and its
// packed exclusive row prefixes pref[row][X] = (xsum << shift) + count over
// the set pixels with column < X, X = 0..W (uint32 arithmetic: int32's
// wrap, as torch.cumsum's).  b and keep may be null.
//
// What bounds it: HBM bytes (the input read, binary written and the int32
// prefixes, four bytes a pixel, written).  The input of the open is binary,
// so the design keeps 32 pixels a 32-bit word (bit b of word i is column
// 32 i + b) and the open becomes bitwise:
//   * A CTA takes a band of kBandRows output rows across the full width of
//     a frame and packs its input rows, with 2r halo rows for the erode and
//     2r more for the dilate, from 16-, 4- or 1-byte loads (byte compares
//     by a carry trick, four at a time).  A row's words have a pad word on
//     each side.
//   * Erode (dilate): per output word and SE row, the AND (OR) of the
//     source word shifted by every offset in the run, from the 96-bit
//     window of the word and its neighbours (funnel shifts; a doubling
//     window, log2 of the run's length steps), folded over the SE rows.
//     The erode's outside (rows, pad words and the bits past W) is 1, the
//     reference's 255 pad; the eroded rows outside the image, the pads and
//     the bits past W are 0 for the dilate, its pad.  Half-widths up to 31
//     (one neighbour word): odd k up to 63.
//   * Prefixes: each dilated word's packed total from popcounts (the
//     count, and the column sum from the popcounts of five bit-plane
//     masks), an exclusive scan over a row's words, then a warp a row
//     writes X = 32 j + lane from word j's bits below the lane: coalesced
//     int32 stores.  The binary bytes are written from the bits, as 16, 4
//     or 1 bytes a thread.

constexpr int kOpenThreads = 256;
constexpr int kOpenWarps = kOpenThreads / 32;
constexpr int kBandRows = 32;
constexpr int kOpenMaxR = 31;  // half-widths a neighbour word covers

// Shared memory of a band: the packed input rows and the eroded rows (each
// with a pad word a side), the dilated rows (plus a zero word) and their
// exclusive word prefixes (plus the row's total).
size_t open_smem(int r, int W) {
  const int nw = (W + 31) / 32;
  return 4 * ((size_t)(kBandRows + 4 * r + kBandRows + 2 * r) * (nw + 2) +
              2 * (size_t)kBandRows * (nw + 1));
}

// Four bytes' nonzero flags as four bits.
__device__ __forceinline__ uint32_t nz4(uint32_t v) {
  const uint32_t hi = (((v & 0x7f7f7f7fu) + 0x7f7f7f7fu) | v) & 0x80808080u;
  return (((hi >> 7) * 0x00204081u) >> 21) & 0xfu;
}

// Four bits as four bytes of 0 or 255.
__device__ __forceinline__ uint32_t bytes4(uint32_t nib) {
  return ((nib * 0x00204081u) & 0x01010101u) * 0xffu;
}

// The nonzero flags of V bytes at p (V = 16, 4 or 1, p aligned to V).
template <int V>
__device__ __forceinline__ uint32_t chunk_bits(const uint8_t* p) {
  if constexpr (V == 16) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    return nz4(q.x) | nz4(q.y) << 4 | nz4(q.z) << 8 | nz4(q.w) << 12;
  } else if constexpr (V == 4) {
    return nz4(*reinterpret_cast<const uint32_t*>(p));
  } else {
    return p[0] != 0;
  }
}

// The band's input word of columns [x0, x0 + 32) of a row: the bits of
// (a | b) & keep, 1 past W.  W % V == 0, so a chunk is wholly in or out.
template <int V>
__device__ __forceinline__ uint32_t load_word(const uint8_t* a,
                                              const uint8_t* b,
                                              const uint8_t* keep, int x0,
                                              int W) {
  uint32_t w = 0;
#pragma unroll
  for (int c = 0; c < 32 / V; ++c) {
    const int x = x0 + c * V;
    uint32_t bits = (1u << V) - 1;
    if (x < W) {
      uint32_t m = chunk_bits<V>(a + x);
      if (b != nullptr) m |= chunk_bits<V>(b + x);
      if (keep != nullptr) m &= chunk_bits<V>(keep + x);
      bits = m;
    }
    w |= bits << (c * V);
  }
  return w;
}

// Bit j of the result: op over bits j + lo .. j + hi of the 96-bit row
// segment (l, c, r) around c (bit j of c is bit 32 + j of the segment);
// -32 < lo <= hi < 32.  a[x] holds op over [x, x + len), doubled while
// 2 len <= n, then widened to n; the bits past 95 only reach windows no
// output reads.
template <bool kOr>
__device__ __forceinline__ uint32_t window(uint32_t l, uint32_t c, uint32_t r,
                                           int lo, int hi) {
  const int n = hi - lo + 1;
  uint32_t a0 = l, a1 = c, a2 = r;
  int len = 1;
  while (len < n) {
    const int s = 2 * len <= n ? len : n - len;
    const uint32_t b0 = __funnelshift_r(a0, a1, s);
    const uint32_t b1 = __funnelshift_r(a1, a2, s);
    const uint32_t b2 = a2 >> s;
    a0 = kOr ? a0 | b0 : a0 & b0;
    a1 = kOr ? a1 | b1 : a1 & b1;
    a2 = kOr ? a2 | b2 : a2 & b2;
    len += s;
  }
  return lo <= 0 ? __funnelshift_l(a0, a1, -lo) : __funnelshift_r(a1, a2, lo);
}

// The op of the runs over rows of `src` (pitch words, a pad word a side):
// output word i of the row whose SE row dy reads src row `row0 + dy`.
template <bool kOr>
__device__ __forceinline__ uint32_t morph_word(const uint32_t* src, int pitch,
                                               int row0, int i,
                                               const SeRuns& runs) {
  uint32_t acc = kOr ? 0u : 0xffffffffu;
  for (int q = 0; q < runs.n; ++q) {
    const uint32_t* p = src + (row0 + runs.dy[q]) * pitch + 1 + i;
    const uint32_t v = window<kOr>(p[-1], p[0], p[1], runs.lo[q], runs.hi[q]);
    acc = kOr ? acc | v : acc & v;
  }
  return acc;
}

// Sum of the set bit positions of m.
__device__ __forceinline__ uint32_t bit_positions(uint32_t m) {
  return __popc(m & 0xaaaaaaaau) + 2 * __popc(m & 0xccccccccu) +
         4 * __popc(m & 0xf0f0f0f0u) + 8 * __popc(m & 0xff00ff00u) +
         16 * __popc(m & 0xffff0000u);
}

// Packed prefix contribution of the set bits of m in word j.
__device__ __forceinline__ uint32_t packed_bits(uint32_t m, int j,
                                                int shift) {
  const uint32_t n = __popc(m);
  return ((n * 32u * j + bit_positions(m)) << shift) + n;
}

// Grid (ceil(H / kBandRows), T); kOpenThreads threads.
template <int V>
__global__ void __launch_bounds__(kOpenThreads)
    open_tail_kernel(const uint8_t* __restrict__ a,
                     const uint8_t* __restrict__ b,
                     const uint8_t* __restrict__ keep,
                     uint8_t* __restrict__ out, int32_t* __restrict__ pref,
                     int H, int W, int shift, SeRuns runs, int r) {
  extern __shared__ __align__(16) uint32_t words[];
  const int nw = (W + 31) / 32;
  const int pitch = nw + 2;
  const int n_in = kBandRows + 4 * r;   // input rows y0 - 2r ..
  const int n_ero = kBandRows + 2 * r;  // eroded rows y0 - r ..
  uint32_t* in_bits = words;
  uint32_t* ero = in_bits + n_in * pitch;
  uint32_t* dil = ero + n_ero * pitch;         // kBandRows x (nw + 1)
  uint32_t* wpre = dil + kBandRows * (nw + 1);  // kBandRows x (nw + 1)
  const int y0 = blockIdx.x * kBandRows;
  const size_t frame = (size_t)blockIdx.y * H * W;
  const int tid = threadIdx.x;
  const uint32_t tail = W % 32 ? (1u << (W % 32)) - 1 : 0xffffffffu;

  // Pack: 1 outside the image (the erode's pad).
  for (int i = tid; i < n_in * pitch; i += kOpenThreads) {
    const int row = i / pitch;
    const int j = i - row * pitch - 1;
    const int gy = y0 - 2 * r + row;
    uint32_t v = 0xffffffffu;
    if (j >= 0 && j < nw && gy >= 0 && gy < H) {
      const size_t o = frame + (size_t)gy * W;
      v = load_word<V>(a + o, b == nullptr ? nullptr : b + o,
                       keep == nullptr ? nullptr : keep + o, 32 * j, W);
    }
    in_bits[i] = v;
  }
  __syncthreads();
  // Erode: 0 outside the image (the dilate's pad).
  for (int i = tid; i < n_ero * pitch; i += kOpenThreads) {
    const int row = i / pitch;
    const int j = i - row * pitch - 1;
    const int gy = y0 - r + row;
    uint32_t v = 0;
    if (j >= 0 && j < nw && gy >= 0 && gy < H) {
      v = morph_word<false>(in_bits, pitch, row + r, j, runs);
      if (j == nw - 1) v &= tail;
    }
    ero[i] = v;
  }
  __syncthreads();
  // Dilate, and each word's packed total.
  for (int i = tid; i < kBandRows * (nw + 1); i += kOpenThreads) {
    const int row = i / (nw + 1);
    const int j = i - row * (nw + 1);
    uint32_t v = 0;
    if (j < nw && y0 + row < H) {
      v = morph_word<true>(ero, pitch, row + r, j, runs);
      if (j == nw - 1) v &= tail;
    }
    dil[i] = v;
    wpre[i] = packed_bits(v, j, shift);
  }
  __syncthreads();
  // Exclusive scan of each row's word totals.
  if (tid < kBandRows) {
    uint32_t* p = wpre + tid * (nw + 1);
    uint32_t run = 0;
    for (int j = 0; j <= nw; ++j) {
      const uint32_t v = p[j];
      p[j] = run;
      run += v;
    }
  }
  __syncthreads();
  // A warp a row: the binary bytes and the prefixes.
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const uint32_t below = (1u << lane) - 1;  // lane 0: none
  for (int row = warp; row < kBandRows && y0 + row < H; row += kOpenWarps) {
    const uint32_t* d = dil + row * (nw + 1);
    const uint32_t* wp = wpre + row * (nw + 1);
    const size_t o = frame + (size_t)(y0 + row) * W;
    for (int x = V * lane; x < W; x += 32 * V) {
      const uint32_t bits = d[x >> 5] >> (x & 31);
      uint8_t* dst = out + o + x;
      if constexpr (V == 16) {
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(bytes4(bits & 0xf), bytes4((bits >> 4) & 0xf),
                       bytes4((bits >> 8) & 0xf), bytes4((bits >> 12) & 0xf));
      } else if constexpr (V == 4) {
        *reinterpret_cast<uint32_t*>(dst) = bytes4(bits & 0xf);
      } else {
        *dst = (bits & 1) ? 255 : 0;
      }
    }
    int32_t* p = pref + (frame / W + y0 + row) * (size_t)(W + 1);
    for (int X = lane; X <= W; X += 32) {
      const int j = X >> 5;
      p[X] = (int32_t)(wp[j] + packed_bits(d[j] & below, j, shift));
    }
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

template <bool kMax, bool kSubtract, typename S>
cudaError_t launch_morph(const uint8_t* in, const uint8_t* sub_src,
                         uint8_t* out, const SeRuns& runs, int ksize, int T,
                         int H, int W, cudaStream_t stream) {
  const size_t smem = morph_smem(runs, ksize, sizeof(S));
  cudaError_t err = allow_smem(morph_kernel<S, kMax, kSubtract>, smem);
  if (err != cudaSuccess) return err;
  morph_kernel<S, kMax, kSubtract><<<tile_grid(T, H, W), dim3(32, 8), smem,
                                     stream>>>(
      in, sub_src, out, H, W, runs, ksize / 2, pyramid_levels(runs));
  return launched();
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
  return launched();
}

cudaError_t launch_threshold(const uint8_t* in, uint8_t* out, int T, int H,
                             int W, int k, int C, int noise_thresh,
                             cudaStream_t stream) {
  const size_t smem = thr_smem(k);
  cudaError_t err = allow_smem(threshold_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + kThrTW - 1) / kThrTW, (H + kThrTH - 1) / kThrTH, T);
  threshold_kernel<<<grid, kThrThreads, smem, stream>>>(
      in, out, H, W, k, C, noise_thresh,
      aligned16(in, out, W));
  return launched();
}

// The tophat's plan for an odd ksize whose runs are symmetric (tophat_steps
// in tophat.cuh), and its tiles for an H x W frame; -1 if the runs are not
// so or the plan does not fit.
int tophat_plan(const SeRuns& se, int ksize, int H, int W, TophatPlan* p) {
  if (tophat_steps(se, ksize, p) != 0) return -1;
  const int r = p->r;
  const int n = p->nsteps;
  // Tiles: of 64, 128, 192 or 256 columns, each with the tallest height
  // (a multiple of 8, at most 256 and the frame's) whose buffers fit two
  // CTAs an SM and whose quads the threads can hold (for every odd k up
  // to 63 some height does); the one whose frame costs the fewest
  // shared-memory quad accesses (an estimate of the widening steps' and
  // the gathers').
  long long best = -1;
  const int hmax = (H + 7) / 8 * 8 < 256 ? (H + 7) / 8 * 8 : 256;
  for (int tq = 4; tq <= 16; tq += 4) {
    const long long nqx = tq + 4 * p->rq, nqe = tq + 2 * p->rq;
    int th = 0;
    for (int h = 8; h <= hmax; h += 8) {
      if (tophat_smem(tq, h, r, p->rq) <= kTopSmemTwo &&
          (h + 2 * r) * nqe <= kTopMaxQuads * kTopThreads &&
          h * tq <= kTopMaxQuads * kTopThreads)
        th = h;
    }
    if (th == 0) continue;
    const long long rows_x = th + 4 * r, rows_e = th + 2 * r;
    const long long tile = 6LL * n * (rows_x * nqx + rows_e * nqe) +
                           2LL * (2 * r + 1) * (rows_e * nqe + th * tq) +
                           rows_x * nqx;
    const long long cost =
        tile * ((H + th - 1) / th) * ((W + 16 * tq - 1) / (16 * tq));
    if (best < 0 || cost < best) {
      best = cost;
      p->tq = tq;
      p->th = th;
    }
  }
  return best < 0 ? -1 : 0;
}

// img - open(img): one launch of tophat_kernel.
cudaError_t launch_tophat_fused(const uint8_t* in, uint8_t* out,
                                const SeRuns& se, int ksize, int T, int H,
                                int W, cudaStream_t stream) {
  TophatPlan p;
  if (tophat_plan(se, ksize, H, W, &p) != 0) return cudaErrorInvalidValue;
  const size_t smem = tophat_smem(p.tq, p.th, p.r, p.rq);
  cudaError_t err = allow_smem(tophat_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + 16 * p.tq - 1) / (16 * p.tq), (H + p.th - 1) / p.th,
                  T);
  tophat_kernel<<<grid, kTopThreads, smem, stream>>>(
      in, out, H, W, aligned16(in, out, W), p);
  return launched();
}

template <int V>
cudaError_t launch_open_tail_v(const uint8_t* a, const uint8_t* b,
                               const uint8_t* keep, uint8_t* bin,
                               int32_t* pref, const SeRuns& se, int r, int T,
                               int H, int W, int shift, size_t smem,
                               cudaStream_t s) {
  cudaError_t err = allow_smem(open_tail_kernel<V>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((H + kBandRows - 1) / kBandRows, T);
  open_tail_kernel<V><<<grid, kOpenThreads, smem, s>>>(a, b, keep, bin, pref,
                                                       H, W, shift, se, r);
  return launched();
}

// The tail every merge entry ends with, one launch of open_tail_kernel:
// binary = open((a | b) & keep) with the ellipse runs (b, keep may be
// null), and its packed row prefixes.  The runs must lie within
// [-kOpenMaxR, kOpenMaxR] both ways.
cudaError_t launch_open_tail(const uint8_t* a, const uint8_t* b,
                             const uint8_t* keep, uint8_t* bin, int32_t* pref,
                             const SeRuns& se, int open_k, int T, int H,
                             int W, int shift, cudaStream_t s) {
  const int r = open_k / 2;
  if (r > kOpenMaxR) return cudaErrorInvalidValue;
  for (int q = 0; q < se.n; ++q) {
    if (se.dy[q] < -r || se.dy[q] > r || se.lo[q] < -kOpenMaxR ||
        se.hi[q] > kOpenMaxR)
      return cudaErrorInvalidValue;
  }
  const size_t smem = open_smem(r, W);
  if (smem > (size_t)227 * 1024) return cudaErrorInvalidValue;
  const uintptr_t bits =
      reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
      reinterpret_cast<uintptr_t>(keep) | reinterpret_cast<uintptr_t>(bin);
  if (W % 16 == 0 && bits % 16 == 0)
    return launch_open_tail_v<16>(a, b, keep, bin, pref, se, r, T, H, W,
                                  shift, smem, s);
  if (W % 4 == 0 && bits % 4 == 0)
    return launch_open_tail_v<4>(a, b, keep, bin, pref, se, r, T, H, W,
                                 shift, smem, s);
  return launch_open_tail_v<1>(a, b, keep, bin, pref, se, r, T, H, W, shift,
                               smem, s);
}

}  // namespace

extern "C" {

// Kernel launches the entries below have made since the library was
// loaded (each launcher adds one per kernel it launches): a caller reads it
// before and after a call to count that call's launches.
long long lt_filter_stage_launches(void) { return g_launches; }

// out = img - open(img) with the ellipse SE whose runs are in `runs`
// (n rows of int32 (dy, lo, hi), a host array): one launch of
// tophat_kernel.  ksize odd, the runs symmetric (OpenCV's ellipse), at most
// kMaxRuns rows.  scratch is not used (the eroded image stays in shared
// memory); the argument keeps the entry's interface.
int lt_tophat(const void* img, void* out, void* scratch, const void* runs,
              int n_runs, int ksize, int T, int H, int W, void* stream) {
  (void)scratch;
  SeRuns se;
  if (load_runs(static_cast<const int*>(runs), n_runs, &se) != 0 ||
      ksize < 1 || T < 1 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  return (int)launch_tophat_fused(static_cast<const uint8_t*>(img),
                                  static_cast<uint8_t*>(out), se, ksize, T, H,
                                  W, static_cast<cudaStream_t>(stream));
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
  return (int)launch_threshold(static_cast<const uint8_t*>(img),
                               static_cast<uint8_t*>(out), T, H, W, ksize, C,
                               noise_thresh,
                               static_cast<cudaStream_t>(stream));
}

// binary = open(((r_th | thr(b_feat, kb, Cb)) & keep) as 0/255, ellipse
// open_k); pref = packed exclusive row prefixes of binary, (T, H, W+1).
// keep may be null.  b_th holds the threshold: two launches, the merge in
// the tail's load (as lt_merge_open's).
int lt_thr_merge_open(const void* r_th, const void* b_feat, const void* keep,
                      void* out, void* pref, void* b_th, const void* runs,
                      int n_runs, int open_k, int T, int H, int W, int kb,
                      int Cb, int shift, void* stream) {
  SeRuns se;
  if (load_runs(static_cast<const int*>(runs), n_runs, &se) != 0 ||
      open_k < 1 || kb < 1 || T < 1 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* bt = static_cast<uint8_t*>(b_th);
  cudaError_t err = launch_threshold(static_cast<const uint8_t*>(b_feat), bt,
                                     T, H, W, kb, Cb, -1, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_open_tail(
      static_cast<const uint8_t*>(r_th), bt, static_cast<const uint8_t*>(keep),
      static_cast<uint8_t*>(out), static_cast<int32_t*>(pref), se, open_k, T,
      H, W, shift, s);
}

// binary = open(((r_th | b_th) & keep) as 0/255, ellipse open_k); pref as
// in lt_thr_merge_open.  keep may be null.  One launch: the merge is the
// tail's load.
int lt_merge_open(const void* r_th, const void* b_th, const void* keep,
                  void* out, void* pref, const void* runs, int n_runs,
                  int open_k, int T, int H, int W, int shift, void* stream) {
  SeRuns se;
  if (load_runs(static_cast<const int*>(runs), n_runs, &se) != 0 ||
      open_k < 1 || T < 1 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  return (int)launch_open_tail(
      static_cast<const uint8_t*>(r_th), static_cast<const uint8_t*>(b_th),
      static_cast<const uint8_t*>(keep), static_cast<uint8_t*>(out),
      static_cast<int32_t*>(pref), se, open_k, T, H, W, shift,
      static_cast<cudaStream_t>(stream));
}

// binary = open(merged) as 0/255 and its prefixes: the tail alone, one
// launch.
int lt_open_prefix(const void* merged, void* out, void* pref,
                   const void* runs, int n_runs, int open_k, int T, int H,
                   int W, int shift, void* stream) {
  SeRuns se;
  if (load_runs(static_cast<const int*>(runs), n_runs, &se) != 0 ||
      open_k < 1 || T < 1 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  return (int)launch_open_tail(
      static_cast<const uint8_t*>(merged), nullptr, nullptr,
      static_cast<uint8_t*>(out), static_cast<int32_t*>(pref), se, open_k, T,
      H, W, shift, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
