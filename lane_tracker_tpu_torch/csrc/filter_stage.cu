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
// The morphology probes' two tophats run the same tile (tophat_tile,
// tophat.cuh) in sources of their own: tophat_staged.cu (lt_tophat_staged)
// and dual_tophat.cu (lt_dual_tophat).  lt_tophat_plan gives the tile plan
// of all three.
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
// contiguous.  lt_filter_stage_launches counts the kernels launched, those
// of tophat_staged.cu, dual_tophat.cu, adaptive_mean.cu and the shift
// chains too.
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

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "tophat.cuh"

namespace {
long long g_launches = 0;  // lt_filter_stage_launches
}  // namespace

cudaError_t lt::filter_stage_launched() {
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++g_launches;
  return err;
}

namespace {

using lt::aligned;
using lt::allow_smem;
using lt::filter_stage_launched;
using lt::kTopMaxQuads;
using lt::kTopThreads;
using lt::load_quad;
using lt::load_runs;
using lt::plane_guard;
using lt::SeRuns;
using lt::tophat_plan;
using lt::tophat_smem;
using lt::tophat_tile;
using lt::TophatPlan;
using lt::U8Lanes;

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
// The tile is tophat_tile (tophat.cuh), which the probes' staged and dual
// kernels (tophat_staged.cu, dual_tophat.cu) run too; the host's plan is
// tophat_plan, beside it.
// Two shared buffers, each the staged tile: the plane is widened from one
// into the other, one barrier a step.  Reads that run off a row or off
// the buffer (into a guard) only feed values whose window runs off the
// staged region, which no output reads.

// Grid: (ceil(W / 16 tq), ceil(H / th), T); kTopThreads threads.
__global__ void __launch_bounds__(kTopThreads, 2)
    tophat_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                  int H, int W, bool vec, TophatPlan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  tophat_tile<U8Lanes, kTopMaxQuads>(in, out, H, W, vec, p, blockIdx.x,
                                     blockIdx.y, blockIdx.z, smem_raw);
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

cudaError_t launch_threshold(const uint8_t* in, uint8_t* out, int T, int H,
                             int W, int k, int C, int noise_thresh,
                             cudaStream_t stream) {
  const size_t smem = thr_smem(k);
  cudaError_t err = allow_smem(threshold_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + kThrTW - 1) / kThrTW, (H + kThrTH - 1) / kThrTH, T);
  threshold_kernel<<<grid, kThrThreads, smem, stream>>>(
      in, out, H, W, k, C, noise_thresh,
      aligned(in, out, W));
  return filter_stage_launched();
}

// img - open(img): one launch of tophat_kernel.
cudaError_t launch_tophat_fused(const uint8_t* in, uint8_t* out,
                                const SeRuns& se, int ksize, int T, int H,
                                int W, cudaStream_t stream) {
  TophatPlan p;
  int shape;
  if (tophat_plan(se, ksize, 1, H, W, &p, &shape) != 0)
    return cudaErrorInvalidValue;
  const size_t smem = tophat_smem(p.tq, p.th, p.r, p.rq);
  cudaError_t err = allow_smem(tophat_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + 16 * p.tq - 1) / (16 * p.tq), (H + p.th - 1) / p.th,
                  T);
  tophat_kernel<<<grid, kTopThreads, smem, stream>>>(
      in, out, H, W, aligned(in, out, W), p);
  return filter_stage_launched();
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
  return filter_stage_launched();
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

// The tophat's tile plan for an H x W frame with its planes at elem bytes
// a pixel (1: lt_tophat and lt_dual_tophat; 2, 4: lt_tophat_staged): out
// gets 6 int32 (tile columns, tile rows, tq, rq, the shape: 0 two CTAs an
// SM, 1 one; shared bytes a CTA).
int lt_tophat_plan(const void* runs, int n_runs, int ksize, int elem, int H,
                   int W, void* out) {
  SeRuns se;
  TophatPlan p;
  int shape;
  if (load_runs(static_cast<const int*>(runs), n_runs, &se) != 0 ||
      H < 1 || W < 1 || tophat_plan(se, ksize, elem, H, W, &p, &shape) != 0)
    return (int)cudaErrorInvalidValue;
  int* o = static_cast<int*>(out);
  o[0] = 16 / elem * p.tq;
  o[1] = p.th;
  o[2] = p.tq;
  o[3] = p.rq;
  o[4] = shape;
  o[5] = (int)tophat_smem(p.tq, p.th, p.r, p.rq, plane_guard(elem));
  return 0;
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
