// Hand-written Hopper (sm_90a) kernel for the fused channel stage: one
// channel's white tophat and its bilateral cross threshold in one kernel,
// and optionally the noise keep-mask of the raw channel.
//
// Replaces these Pallas TPU kernels, both in
// scripts/channel_fused_postmortem.py:
//   lt_channel_stage <- channel_stage_pallas2     (:379; band-matmul window
//                       sums, row blocks, optional noise keep-mask)
//                    <- channel_stage_pyr_pallas2 (:264; the same function
//                       without the noise mask, pyramid window sums,
//                       full-height blocks); served by the same kernel
// Output: th = cross_threshold(tophat(x, kt), kb, C) as 0/255 and, with
// keep non-null, keep = (x < nthr) | cross_threshold(x, kn, Cn), exactly
// the unfused chain lt_tophat -> lt_cross_threshold (filter_stage.cu); all
// integer, bit-exact with the plain twin in
// lane_tracker_tpu_torch/kernels/channel_fused.py.
//
// What the fusion keeps out of device memory, as the TPU kernels do: the
// tophat image (and the eroded one) never goes to HBM.  One CTA owns a
// tile of `block` output rows by 32 columns and stages the raw tile plus a
// halo of h = max(kb + 1 + 2*(kt/2), kn + 1) rows and columns on each side
// (the TPU kernel's halo; 90 for B with kt = 55, kb = 35 and the noise
// arms kn = 65, 44 for R with kt = 29, kb = 15), 255 outside the image.
// In shared memory it then takes, in order:
//   1. the erode over the threshold's read reach widened by kt/2 (pow2
//      window-min pyramid of the staged plane, built level by level in two
//      ping-pong planes, two reads per SE row of each level's runs);
//   2. the erode's pixels outside the image set to 0 (the dilate's pad);
//   3. the dilate over the threshold's read reach (the same pyramid of the
//      eroded plane) and the tophat x - opened there, 0 outside the image
//      (the threshold's zero border);
//   4. int32 exclusive prefix sums of the tophat's row strip and column
//      strip through the tile, four reads per pixel for the arm sums
//      (lt::cross_hit, common.cuh);
//   5. with keep: the same prefix strips of the raw plane read with zero
//      borders, at the noise arm length.
// Three borders meet in one kernel (255 for the erode, 0 for the dilate, 0
// for both thresholds); each is applied from the pixel's global position,
// so ragged tiles at the image edge take them as the unfused kernels do.
//
// What bounds it on the H100: shared-memory traffic from the halo.  The
// function's own bound is small: one u8 read and one or two u8 writes per
// pixel (142 MB for B with the noise mask at (64, 1100, 672)), and about
// 2*(2*kt + levels) + 1 integer operations per pixel for the tophat plus
// 16 per threshold and 2 for the noise fold (265 for B, 12.5 G, 0.37 ms
// at half the 67 TFLOP/s f32 rate; chip_smoke.py's count).  But every
// tile recomputes the tophat over its halo: with block = 64 the erode
// covers (64 + 2*(kb + rt)) x (32 + 2*(kb + rt)) pixels for 64 x 32
// outputs, 14x for B, and each erode or dilate pixel costs two shared
// reads per SE row.  The design makes `block` a launch parameter, so
// taller tiles trade shared memory (one 512-thread CTA per SM for B) for
// less halo; the 32-column width, the square (not cross-shaped) tophat
// region and the serial prefix scans are kept simple, and cutting them is
// later work.
//
// Plain C interface, loaded with ctypes: the entry launches on the stream it
// is given, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using lt::cross_hit;
using lt::kMaxRuns;
using lt::load_runs;
using lt::op;
using lt::SeRuns;

constexpr int kTW = 32;        // output columns of a tile
constexpr int kThreads = 512;  // one CTA
constexpr int kMaxLev = 8;     // pyramid levels: runs up to 255 pixels
constexpr int kAlign = 16;

// SE runs grouped by pyramid level: runs of level j (2^j <= run length <
// 2^(j+1)) are [start[j], start[j + 1]); each reads level j at lo and at
// hi2 = hi - 2^j + 1.
struct LevelRuns {
  int nlev;
  int start[kMaxLev + 1];
  int dy[kMaxRuns];
  int lo[kMaxRuns];
  int hi2[kMaxRuns];
};

struct Args {
  int H, W;
  int kb, C;      // threshold of the tophat
  int kn, Cn;     // noise keep-mask (kn = 0: none)
  int nthr;
  int block, h;   // output rows of a tile, staged halo
  int rt;         // kt / 2
};

// Shared-memory layout of one CTA, offsets in bytes: the staged plane S
// at 0, the tophat plane D, then a pool that holds the two pyramid planes
// and the erode plane E, and later the prefix strips.
struct Layout {
  int SH, SW;  // staged raw plane (tile + halo)
  int DH, DW;  // threshold's read reach: the tophat plane
  int EH, EW;  // erode plane
  size_t d_off, pool_off, buf1_off, e_off, bytes;
};

size_t align_up(size_t v) { return (v + kAlign - 1) / kAlign * kAlign; }

Layout layout(int kt, int kb, int kn, int block) {
  const int rt = kt / 2;
  const int h = (kb + 1 + 2 * rt) > (kn + 1) ? (kb + 1 + 2 * rt) : (kn + 1);
  Layout L;
  L.SH = block + 2 * h;
  L.SW = kTW + 2 * h;
  L.DH = block + 2 * kb;
  L.DW = kTW + 2 * kb;
  L.EH = L.DH + 2 * rt;
  L.EW = L.DW + 2 * rt;
  const size_t s = (size_t)L.SH * L.SW;
  // The prefix strips of the threshold, then of the noise mask, take the
  // pool in turn once the morphology is done.
  const size_t morph = 2 * align_up(s) + (size_t)L.EH * L.EW;
  const size_t strips_t =
      sizeof(int) * ((size_t)block * (L.DW + 1) + (size_t)(L.DH + 1) * kTW);
  const size_t strips_n =
      kn > 0 ? sizeof(int) * ((size_t)block * (kTW + 2 * kn + 1) +
                              (size_t)(block + 2 * kn + 1) * kTW)
             : 0;
  size_t pool = morph > strips_t ? morph : strips_t;
  pool = pool > strips_n ? pool : strips_n;
  L.d_off = align_up(s);
  L.pool_off = L.d_off + align_up((size_t)L.DH * L.DW);
  L.buf1_off = L.pool_off + align_up(s);
  L.e_off = L.buf1_off + align_up(s);
  L.bytes = L.pool_off + pool;
  return L;
}

int level_runs(const SeRuns& se, LevelRuns* out) {
  int nlev = 1;
  while ((1 << nlev) <= se.max_run) ++nlev;
  if (nlev > kMaxLev) return -1;
  out->nlev = nlev;
  int q = 0;
  for (int j = 0; j < nlev; ++j) {
    out->start[j] = q;
    for (int r = 0; r < se.n; ++r) {
      const int len = se.hi[r] - se.lo[r] + 1;
      if (31 - __builtin_clz(len) != j) continue;
      out->dy[q] = se.dy[r];
      out->lo[q] = se.lo[r];
      out->hi2[q] = se.hi[r] - (1 << j) + 1;
      ++q;
    }
  }
  out->start[nlev] = q;
  return 0;
}

// acc (acc_rows x acc_cols) = erode (kMax = false) or dilate (kMax = true)
// of the plane src (rows x cols) by the SE, where acc pixel (ay, ax) is src
// pixel (ay + off, ax + off).  Level j of the window pyramid (op over
// columns [c, c + 2^j) of a row) is built from level j - 1 into buf0 / buf1
// in turn; level 0 is src itself.  Entries whose window runs off the row
// are never read.  Ends with a barrier.
template <bool kMax>
__device__ void morph_plane(const uint8_t* src, int rows, int cols,
                            uint8_t* buf0, uint8_t* buf1, uint8_t* acc,
                            int acc_rows, int acc_cols, int off,
                            const LevelRuns& se) {
  const int tid = threadIdx.x;
  const int n_acc = acc_rows * acc_cols;
  const int plane = rows * cols;
  for (int i = tid; i < n_acc; i += kThreads) acc[i] = kMax ? 0 : 255;
  const uint8_t* lev = src;
  for (int j = 0; j < se.nlev; ++j) {
    if (j > 0) {
      uint8_t* next = (j & 1) ? buf0 : buf1;
      const int s = 1 << (j - 1);
      for (int i = tid; i < plane; i += kThreads) {
        const int lx = i % cols;
        next[i] = lx + s < cols ? op<kMax>(lev[i], lev[i + s]) : lev[i];
      }
      __syncthreads();
      lev = next;
    }
    const int q0 = se.start[j];
    const int q1 = se.start[j + 1];
    if (q0 == q1) continue;
    for (int i = tid; i < n_acc; i += kThreads) {
      const int ay = i / acc_cols;
      const int ax = i - ay * acc_cols;
      const uint8_t* base = lev + (ay + off) * cols + (ax + off);
      uint8_t v = acc[i];
      for (int q = q0; q < q1; ++q) {
        const uint8_t* row = base + se.dy[q] * cols;
        v = op<kMax>(v, op<kMax>(row[se.lo[q]], row[se.hi2[q]]));
      }
      acc[i] = v;
    }
  }
  __syncthreads();
}

// Exclusive prefix strips for the cross threshold of a tile of `block`
// rows x kTW columns, from a plane read through `at(row, col)` in tile
// coordinates (the tile's first pixel at (0, 0)): hs[r][j], j in [0, kTW +
// 2k], sums the row r pixels at columns [-k, j - k); vs[j][c], j in [0,
// block + 2k], the column c pixels at rows [-k, j - k).  One thread per
// row or column, serial.  Ends with a barrier.
template <typename At>
__device__ void prefix_strips(At at, int block, int k, int* hs, int* vs) {
  const int hw = kTW + 2 * k + 1;
  for (int task = threadIdx.x; task < block + kTW; task += kThreads) {
    int s = 0;
    if (task < block) {
      int* row = hs + task * hw;
      row[0] = 0;
      for (int j = 0; j < hw - 1; ++j) {
        s += at(task, j - k);
        row[j + 1] = s;
      }
    } else {
      const int c = task - block;
      vs[c] = 0;
      for (int j = 0; j < block + 2 * k; ++j) {
        s += at(j - k, c);
        vs[(j + 1) * kTW + c] = s;
      }
    }
  }
  __syncthreads();
}

// Grid (ceil(W / kTW), ceil(H / block), T); kThreads threads.
__global__ void __launch_bounds__(kThreads)
    channel_stage_kernel(const uint8_t* __restrict__ in,
                         uint8_t* __restrict__ th, uint8_t* __restrict__ keep,
                         Args a, LevelRuns se, Layout L) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* S = smem;
  uint8_t* D = smem + L.d_off;
  uint8_t* buf0 = smem + L.pool_off;
  uint8_t* buf1 = smem + L.buf1_off;
  uint8_t* E = smem + L.e_off;
  int* hs = reinterpret_cast<int*>(smem + L.pool_off);

  const int H = a.H, W = a.W, h = a.h, kb = a.kb, block = a.block;
  const int y0 = blockIdx.y * block;
  const int x0 = blockIdx.x * kTW;
  const size_t frame = (size_t)blockIdx.z * H * W;
  const int tid = threadIdx.x;
  // Global row / column of staged row sy / column sx.
  auto in_img = [&](int sy, int sx) {
    const int gy = y0 - h + sy;
    const int gx = x0 - h + sx;
    return gy >= 0 && gy < H && gx >= 0 && gx < W;
  };

  // 1. Stage the raw tile and halo, 255 (the erode's pad) outside.
  for (int i = tid; i < L.SH * L.SW; i += kThreads) {
    const int sy = i / L.SW;
    const int sx = i - sy * L.SW;
    S[i] = in_img(sy, sx)
               ? in[frame + (size_t)(y0 - h + sy) * W + (x0 - h + sx)]
               : 255;
  }
  __syncthreads();

  // 2. Erode over the tophat plane widened by rt; staged pixel of erode
  // pixel (ey, ex) is (ey + eo, ex + eo).
  const int eo = h - kb - a.rt;
  morph_plane<false>(S, L.SH, L.SW, buf0, buf1, E, L.EH, L.EW, eo, se);
  for (int i = tid; i < L.EH * L.EW; i += kThreads) {
    const int ey = i / L.EW;
    const int ex = i - ey * L.EW;
    if (!in_img(ey + eo, ex + eo)) E[i] = 0;
  }
  __syncthreads();

  // 3. Dilate into D, then D := tophat, 0 outside the image; staged pixel
  // of tophat pixel (dy, dx) is (dy + h - kb, dx + h - kb).
  morph_plane<true>(E, L.EH, L.EW, buf0, buf1, D, L.DH, L.DW, a.rt, se);
  const int dofs = h - kb;
  for (int i = tid; i < L.DH * L.DW; i += kThreads) {
    const int dy = i / L.DW;
    const int dx = i - dy * L.DW;
    const int sy = dy + dofs;
    const int sx = dx + dofs;
    D[i] = in_img(sy, sx) ? (uint8_t)(S[sy * L.SW + sx] - D[i]) : 0;
  }
  __syncthreads();

  // 4. Cross threshold of the tophat at the tile's pixels.
  {
    int* vs = hs + block * (L.DW + 1);
    prefix_strips(
        [&](int r, int c) { return (int)D[(r + kb) * L.DW + c + kb]; },
        block, kb, hs, vs);
    for (int i = tid; i < block * kTW; i += kThreads) {
      const int r = i / kTW;
      const int c = i - r * kTW;
      const int gy = y0 + r;
      const int gx = x0 + c;
      if (gy >= H || gx >= W) continue;
      const int x = D[(r + kb) * L.DW + c + kb];
      const bool hit =
          cross_hit(hs + r * (L.DW + 1) + c, vs + r * kTW + c, kTW, kb, x, a.C);
      th[frame + (size_t)gy * W + gx] = hit ? 255 : 0;
    }
  }
  if (keep == nullptr) return;
  __syncthreads();

  // 5. Noise keep-mask: cross threshold of the raw plane, zero borders.
  const int kn = a.kn;
  int* vs = hs + block * (kTW + 2 * kn + 1);
  prefix_strips(
      [&](int r, int c) {
        const int sy = r + h;
        const int sx = c + h;
        return in_img(sy, sx) ? (int)S[sy * L.SW + sx] : 0;
      },
      block, kn, hs, vs);
  for (int i = tid; i < block * kTW; i += kThreads) {
    const int r = i / kTW;
    const int c = i - r * kTW;
    const int gy = y0 + r;
    const int gx = x0 + c;
    if (gy >= H || gx >= W) continue;
    const int x = S[(r + h) * L.SW + c + h];
    const bool hit = x < a.nthr || cross_hit(hs + r * (kTW + 2 * kn + 1) + c,
                                             vs + r * kTW + c, kTW, kn, x,
                                             a.Cn);
    keep[frame + (size_t)gy * W + gx] = hit ? 255 : 0;
  }
}

size_t max_smem() {
  int dev = 0;
  int bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return (size_t)bytes;
}

}  // namespace

extern "C" {

// The tallest tile (output rows) whose shared memory fits a CTA on this
// device, for the tophat kt, threshold kb and noise arms kn (0: no noise);
// 0 if none does.
int lt_channel_stage_max_block(int kt, int kb, int kn) {
  const size_t limit = max_smem();
  int best = 0;
  for (int b = 1; b <= 4096 && layout(kt, kb, kn, b).bytes <= limit; ++b)
    best = b;
  return best;
}

// th = cross_threshold(tophat(img, kt), kb, C) as 0/255; with keep
// non-null also keep = (img < nthr) | cross_threshold(img, kn, Cn).  runs:
// the kt ellipse's n rows of int32 (dy, lo, hi), a host array.  block:
// output rows of one CTA's tile.
int lt_channel_stage(const void* img, void* th, void* keep, const void* runs,
                     int n_runs, int kt, int kb, int C, int kn, int Cn,
                     int nthr, int block, int T, int H, int W, void* stream) {
  SeRuns se;
  LevelRuns lev;
  if (load_runs(static_cast<const int*>(runs), n_runs, &se) != 0 ||
      level_runs(se, &lev) != 0 || kt < 1 || kb < 1 || block < 1 || T < 1 ||
      H < 1 || W < 1 || (keep != nullptr && kn < 1))
    return (int)cudaErrorInvalidValue;
  if (keep == nullptr) kn = 0;
  const Layout L = layout(kt, kb, kn, block);
  if (L.bytes > max_smem()) return (int)cudaErrorInvalidValue;
  Args a;
  a.H = H;
  a.W = W;
  a.kb = kb;
  a.C = C;
  a.kn = kn;
  a.Cn = Cn;
  a.nthr = nthr;
  a.block = block;
  a.rt = kt / 2;
  a.h = (L.SW - kTW) / 2;
  cudaError_t err = lt::allow_smem(channel_stage_kernel, L.bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kTW - 1) / kTW, (H + block - 1) / block, T);
  channel_stage_kernel<<<grid, kThreads, L.bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), static_cast<uint8_t*>(th),
      static_cast<uint8_t*>(keep), a, lev, L);
  return (int)cudaGetLastError();
}

}  // extern "C"
