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
// tophat image (and the eroded one) never goes to HBM.  What bounds it on
// the H100 is the halo: the threshold reads the tophat kb pixels around
// each output, and the tophat of those pixels reads kt - 1 more, so a CTA
// recomputes the tophat of its tile's halo.  The function's own bound is
// one u8 read and one or two u8 writes a pixel.
//
// The design (choice (a) of the two: wide, tall tiles planned on the host;
// not column strips streaming down the frame, whose ring buffers would need
// the widening plane's rows re-made as each row enters):
//   * The tophat is lt_tophat's (tophat.cuh): u8x4 words, DPX
//     __vimin3_u16x2 / __vimax3_u16x2 min/max, one plane of horizontal
//     window min/max widened through the ellipse's half-widths, erode and
//     dilate in one CTA with the eroded tile in shared memory.  Here it
//     runs over the threshold's read region, the tile plus kb rows and
//     round16(kb) columns a side, and its result stays in shared memory
//     too (0 outside the image: the threshold's border).
//   * The region is the square around the tile, not the cross the arms
//     read: the erode under a cross covers the square but for corners of
//     (kb - r) pixels, and the widening steps run over whole rows, so a
//     cross saves only the dilate's gathers at the corners (18% of them at
//     B's kb = 35 and 100 x 128 tiles, about 7% of the gathers in all).
//   * The threshold is lt_cross_threshold's: row walkers (32 columns each,
//     a word of hit bits) keep the left and right arm sums, column walkers
//     the up and down ones and write the output.  The tophat plane's pitch
//     is an odd number of words, so the row walkers meet no bank twice.
//   * The noise keep-mask reads the raw pixels with the threshold's zero
//     border: staged with 0 outside the image, copied as they are staged
//     into a plane of odd-word pitch for its walkers, then refilled with
//     255 outside (the erode's border) before the erode.  The staged halo
//     is max(kb + 2 r, kn) rows and max(kbq + 2 rq, knq) quads a side.
//   * Tiles: 64 to 256 columns by as many rows as fit, in one of two
//     shapes: one 512-thread CTA an SM holding 8 quads a thread in up to
//     227 KB, or two CTAs an SM holding 6 (64 registers) in 110 KB each,
//     as lt_tophat runs.  The host (cs_plan) takes the tile of the fewest
//     estimated shared-memory accesses over the resident CTAs.
// Staged pixels per output (the halo's cost) at (64, 1100, 672): B with
// the noise mask 244 x 212 staged for 64 x 32 outputs, 25.3x, in the first
// design (32-column tiles, h = 90), 278 x 352 for 100 x 128 now, 7.6x; R
// 152 x 120 for 64 x 32, 8.9x, against 186 x 288 for 100 x 192 (two CTAs
// an SM), 2.8x (tests/torch_filter_models.py cs_plan).  The three borders
// (255 for the erode, 0 for the dilate, 0 for both thresholds) are applied
// from global positions.
//
// Plain C interface, loaded with ctypes: the entry launches on the stream it
// is given, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "tophat.cuh"

namespace {

using lt::held_quads;
using lt::kTopGuard;
using lt::kTopThreads;
using lt::load_quad;
using lt::load_runs;
using lt::morph_pass;
using lt::SeRuns;
using lt::TophatPlan;
using lt::zero_outside;

constexpr int kCsThreads = kTopThreads;  // 512
constexpr int kCsSeg = 32;               // columns a row walker covers
constexpr int kCsMaxRows = 1024;         // the tallest tile planned
// The kernel's two shapes: one CTA an SM holding 8 accumulator quads a
// thread in up to the block's opt-in shared memory, or two CTAs an SM
// holding 6 (64 registers) in 110 KB each, as lt_tophat runs.  Two CTAs
// overlap each other's barriers, so the planner counts their accesses at
// 10/13: a weight fitted on the H100 to tiles of both shapes for R and
// for B's tophat under a 1-pixel threshold (PERF.md section 6).
struct CsShape {
  int quads, ctas, gain10;
};
constexpr CsShape kCsShapes[2] = {{8, 1, 10}, {6, 2, 13}};
constexpr size_t kCsSmemTwo = 110 * 1024;

struct CsPlan {
  TophatPlan t;    // widening steps of kt (t.r, t.rq)
  int tq, th;      // output tile: quads, rows
  int kb, C;       // threshold of the tophat
  int kn, Cn, nthr;  // noise keep-mask (kn = 0: none)
  int kbq;         // the tophat region's column halo in quads
  int hy, hq;      // staged halo: rows, quads
  int nrx, nqx;    // staged plane: rows, quads a row
  int pd;          // tophat plane pitch in bytes (an odd number of words)
  int pn;          // noise plane pitch in bytes (an odd number of words)
  int hbp;         // hit-bit words a row (odd)
  int shape;       // index into kCsShapes
  size_t bufs;     // bytes of the two widening buffers and their guards
  size_t smem;
};

// Shared memory and walker sizes of a tile of tq quads x th rows.
void cs_size(CsPlan* p, int tq, int th) {
  const int r = p->t.r, rq = p->t.rq;
  const int knq = (p->kn + 15) / 16;
  p->tq = tq;
  p->th = th;
  p->kbq = (p->kb + 15) / 16;
  p->hy = p->kb + 2 * r > p->kn ? p->kb + 2 * r : p->kn;
  p->hq = p->kbq + 2 * rq > knq ? p->kbq + 2 * rq : knq;
  p->nrx = th + 2 * p->hy;
  p->nqx = tq + 2 * p->hq;
  p->pd = 16 * (tq + 2 * p->kbq) + 4;
  p->pn = 16 * (tq + 2 * knq) + 4;
  p->hbp = 16 * tq / kCsSeg + 1;
  p->bufs = 2 * 16 * ((size_t)p->nrx * p->nqx + 2 * kTopGuard);
  p->smem = p->bufs + 4 * (size_t)th * p->hbp;
}

// Whether a tile of tq quads x th rows fits a shape: its CTA's shared
// memory, the quads its threads hold in the erode (the tophat region plus
// r a side) and the dilate, the tophat plane (plus a spare row) in the
// buffers, and the noise plane (plus a spare row) in the second.
bool cs_fits(CsPlan p, int tq, int th, size_t limit, const CsShape& shape) {
  cs_size(&p, tq, th);
  const long long thd = th + 2 * p.kb, tqd = tq + 2 * p.kbq;
  const long long cap = (long long)shape.quads * kCsThreads;
  const size_t buf = 16 * (size_t)p.nrx * p.nqx;
  return p.smem <= limit && (thd + 2 * p.t.r) * (tqd + 2 * p.t.rq) <= cap &&
         thd * tqd <= cap && (size_t)(thd + 1) * p.pd <= p.bufs &&
         (p.kn == 0 || (size_t)(th + 2 * p.kn + 1) * p.pn <= buf);
}

// Shared-memory accesses of a frame's tiles, estimated: the widening
// steps' (five quad reads and a write a quad of each row they widen) and
// the gathers' (two a SE row a held quad) in both passes, the staging, and
// the walkers' byte reads (three an output a walk, 2k to start a walk).
long long cs_cost(CsPlan p, int tq, int th, int H, int W) {
  cs_size(&p, tq, th);
  const long long r = p.t.r, rq = p.t.rq, n = p.t.nsteps;
  const long long thd = th + 2 * p.kb, tqd = tq + 2 * p.kbq;
  const long long rows_e = thd + 2 * r, nqe = tqd + 2 * rq;
  const long long tw = 16 * tq;
  const long long nsy = (kCsThreads + tw - 1) / tw;
  auto walks = [&](long long k) {
    return 6 * th * tw + 2 * k * (th * (tw / kCsSeg) + tw * nsy);
  };
  long long tile = 6 * n * ((thd + 4 * r) * p.nqx + rows_e * nqe) +
                   2 * (2 * r + 1) * (rows_e * nqe + thd * tqd) +
                   (long long)p.nrx * p.nqx + walks(p.kb);
  if (p.kn > 0) tile += walks(p.kn);
  return tile * ((H + th - 1) / th) * ((W + tw - 1) / tw);
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

// The plan for kt (its runs se), kb, kn on an H x W frame: for each shape
// and width, block 0 the fewest rows of tiles that fit, as even as they
// go, block > 0 that many rows clamped to H and to what fits; of those the
// tile of the fewest estimated accesses, weighted by the shape's gain10.
// -1 if kt's runs are not a symmetric ellipse's or no tile fits.
int cs_plan(const SeRuns& se, int kt, int kb, int kn, int H, int W,
            int block, size_t limit, CsPlan* p) {
  if (lt::tophat_steps(se, kt, &p->t) != 0 || kb < 1 || kn < 0 || H < 1 ||
      W < 1 || block < 0)
    return -1;
  p->kb = kb;
  p->kn = kn;
  long long best = -1;
  int btq = 0, bth = 0, bshape = 0;
  for (int sh = 0; sh < 2; ++sh) {
    const CsShape& shape = kCsShapes[sh];
    const size_t lim = shape.ctas == 1 || limit < kCsSmemTwo ? limit
                                                             : kCsSmemTwo;
    for (int tq = 4; tq <= 16; tq += 4) {
      int fit = 0;
      for (int h = 1; h <= kCsMaxRows && cs_fits(*p, tq, h, lim, shape); ++h)
        fit = h;
      if (fit == 0) continue;
      int th;
      if (block > 0) {
        th = block < H ? block : H;
        th = th < fit ? th : fit;
      } else {
        const int n = (H + fit - 1) / fit;
        th = (H + n - 1) / n;
      }
      const long long cost = cs_cost(*p, tq, th, H, W) * 10 / shape.gain10;
      if (best < 0 || cost < best) {
        best = cost;
        btq = tq;
        bth = th;
        bshape = sh;
      }
    }
  }
  if (best < 0) return -1;
  cs_size(p, btq, bth);
  p->shape = bshape;
  return 0;
}

// Cross-threshold walkers over a plane in shared memory whose pixel
// (cy + y, cx + c) is the tile's (y, c), zero outside the image: out =
// 255 iff both horizontal k-arm sums or both vertical ones are < k*x -
// C*k (or x < nthr, nthr >= 0), at the tile's pixels inside the frame.
// Row walkers leave the horizontal hits in hbits (hbp words a row); the
// column walkers write the output.  Ends with a barrier.
__device__ void cross_walk(const uint8_t* plane, int pitch, int cy, int cx,
                           int th, int tw, int k, int C, int nthr,
                           uint32_t* hbits, int hbp, uint8_t* out, int H,
                           int W, int y0, int x0) {
  const int tid = threadIdx.x;
  const int t_off = C * k;
  const int nsx = tw / kCsSeg;
  for (int task = tid; task < th * nsx; task += kCsThreads) {
    const int row = task % th;
    const int xs = task / th * kCsSeg;
    const uint8_t* rp = plane + (size_t)(cy + row) * pitch + cx;
    int left = 0, right = 0;
    for (int j = 1; j <= k; ++j) {
      left += rp[xs - j];
      right += rp[xs + j];
    }
    uint32_t bits = 0;
#pragma unroll 8
    for (int x = 0; x < kCsSeg; ++x) {
      const int v = rp[xs + x];
      const int t = k * v - t_off;
      bits |= (uint32_t)(left < t && right < t) << x;
      left += v - rp[xs + x - k];
      right += rp[xs + x + k + 1] - rp[xs + x + 1];
    }
    hbits[row * hbp + xs / kCsSeg] = bits;
  }
  __syncthreads();
  const int nsy = (kCsThreads + tw - 1) / tw;
  const int segh = (th + nsy - 1) / nsy;
  for (int task = tid; task < tw * nsy; task += kCsThreads) {
    const int c = task % tw;
    const int ys = task / tw * segh;
    const int ye = ys + segh < th ? ys + segh : th;
    const int gx = x0 + c;
    if (ys >= ye || gx >= W) continue;
    const uint8_t* cp = plane + cx + c;  // row y of the tile at cy + y
    int up = 0, down = 0;
    for (int j = 1; j <= k; ++j) {
      up += cp[(size_t)(cy + ys - j) * pitch];
      down += cp[(size_t)(cy + ys + j) * pitch];
    }
    for (int y = ys; y < ye; ++y) {
      const int v = cp[(size_t)(cy + y) * pitch];
      const int t = k * v - t_off;
      const bool hit = (up < t && down < t) ||
                       ((hbits[y * hbp + c / kCsSeg] >> (c % kCsSeg)) & 1u) ||
                       v < nthr;
      const int gy = y0 + y;
      if (gy < H) out[(size_t)gy * W + gx] = hit ? 255 : 0;
      // The last slide reads at most one row past the plane's last: a
      // spare row or a guard, not used.
      up += v - cp[(size_t)(cy + y - k) * pitch];
      down += cp[(size_t)(cy + y + k + 1) * pitch] -
              cp[(size_t)(cy + y + 1) * pitch];
    }
  }
  __syncthreads();
}

// Grid (ceil(W / 16 tq), ceil(H / th), T); kCsThreads threads, NQ
// accumulator quads a thread, MINB CTAs an SM.
template <int NQ, int MINB>
__global__ void __launch_bounds__(kCsThreads, MINB)
    channel_stage_kernel(const uint8_t* __restrict__ in,
                         uint8_t* __restrict__ th_out,
                         uint8_t* __restrict__ keep, int H, int W, bool vec,
                         CsPlan p) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint4* buf0 = reinterpret_cast<uint4*>(smem) + kTopGuard;
  uint4* buf1 = buf0 + (size_t)p.nrx * p.nqx + 2 * kTopGuard;
  uint32_t* hbits = reinterpret_cast<uint32_t*>(smem + p.bufs);
  const TophatPlan& t = p.t;
  const int r = t.r, rq = t.rq, tq = p.tq, th = p.th, kb = p.kb;
  const int tw = 16 * tq;
  const int x0 = blockIdx.x * tw;
  const int y0 = blockIdx.y * th;
  const size_t frame = (size_t)blockIdx.z * H * W;
  const uint8_t* src = in + frame;
  const int tid = threadIdx.x;
  const int sy0 = y0 - p.hy, sx0 = x0 - 16 * p.hq;  // staged (0, 0)
  const bool noise = keep != nullptr;

  // 1. Stage: 0 outside the image with the noise mask (its threshold's
  // border, refilled below), else 255 (the erode's).  With the noise mask
  // the quads its arms reach also go to a plane in buf1 whose pitch is an
  // odd number of words (the staged plane's, a multiple of four, would put
  // 32 row walkers on four banks).
  const int knq = (p.kn + 15) / 16;
  uint8_t* N = reinterpret_cast<uint8_t*>(buf1);
  for (int i = tid; i < p.nrx * p.nqx; i += kCsThreads) {
    const int row = i / p.nqx;
    const int q = i - row * p.nqx;
    const uint4 v = load_quad(src, H, W, sy0 + row, sx0 + 16 * q,
                              noise ? 0u : 255u, vec);
    buf0[i] = v;
    const int nr = row - (p.hy - p.kn), nq = q - (p.hq - knq);
    if (noise && nr >= 0 && nr < th + 2 * p.kn && nq >= 0 &&
        nq < tq + 2 * knq) {
      uint32_t* dst =
          reinterpret_cast<uint32_t*>(N + (size_t)nr * p.pn + 16 * nq);
      dst[0] = v.x;
      dst[1] = v.y;
      dst[2] = v.z;
      dst[3] = v.w;
    }
  }
  __syncthreads();

  // 2. The noise keep-mask from its plane, then 255 outside the staged
  // plane's image pixels.
  if (noise) {
    cross_walk(N, p.pn, p.kn, 16 * knq, th, tw, p.kn, p.Cn, p.nthr, hbits,
               p.hbp, keep + frame, H, W, y0, x0);
    const uint4 ones = make_uint4(~0u, ~0u, ~0u, ~0u);
    for (int i = tid; i < p.nrx * p.nqx; i += kCsThreads) {
      const int row = i / p.nqx;
      const int gy = sy0 + row, gx = sx0 + 16 * (i - row * p.nqx);
      const uint4 m = zero_outside(ones, H, W, gy, gx);
      if ((m.x & m.y & m.z & m.w) == ~0u) continue;
      const uint4 v = buf0[i];
      buf0[i] = make_uint4(v.x | ~m.x, v.y | ~m.y, v.z | ~m.z, v.w | ~m.w);
    }
    __syncthreads();
  }

  // 3. Erode over the tophat region (th + 2 kb rows, tq + 2 kbq quads)
  // plus r a side; its row 0 is staged row hy - kb - r, so the plane the
  // erode reads starts r rows and rq quads before it.
  const int thd = th + 2 * kb, tqd = tq + 2 * p.kbq;
  const int nre = thd + 2 * r, nqe = tqd + 2 * rq;
  const size_t base = (size_t)(p.hy - kb - 2 * r) * p.nqx +
                      (p.hq - p.kbq - 2 * rq);
  int off[NQ];
  uint4 acc[NQ];
  int nq = held_quads(nre * nqe, nqe, p.nqx, r, rq, off);
  morph_pass<false>(buf0 + base, buf1 + base, t, p.nqx, nre, off, acc, nq);
  __syncthreads();
  // The eroded region into buf0, rows of nqe quads, 0 outside the image
  // (the dilate's pad).
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    if (j >= nq) break;
    const int m = tid + j * kCsThreads;
    const int row = m / nqe;
    buf0[m] = zero_outside(acc[j], H, W, y0 - kb - r + row,
                           x0 - 16 * (p.kbq + rq) + 16 * (m - row * nqe));
  }
  __syncthreads();

  // 4. Dilate over the tophat region; the tophat x - open into a byte
  // plane over the buffers (pitch pd, an odd number of words), 0 outside
  // the image (the threshold's border).  Inside, open <= x, so the bytes
  // subtract with no borrow; outside both are 0.
  nq = held_quads(thd * tqd, tqd, nqe, r, rq, off);
  morph_pass<true>(buf0, buf1, t, nqe, thd, off, acc, nq);
  __syncthreads();
  const uint4 ones = make_uint4(~0u, ~0u, ~0u, ~0u);
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    if (j >= nq) break;
    const int m = tid + j * kCsThreads;
    const int row = m / tqd;
    const int col = m - row * tqd;
    const int gy = y0 - kb + row, gx = x0 - 16 * p.kbq + 16 * col;
    const uint4 x = load_quad(src, H, W, gy, gx, 0u, vec);
    const uint4 in_img = zero_outside(ones, H, W, gy, gx);
    const uint4& d = acc[j];
    uint32_t* dst = reinterpret_cast<uint32_t*>(smem + (size_t)row * p.pd +
                                                16 * col);
    dst[0] = x.x - (d.x & in_img.x);
    dst[1] = x.y - (d.y & in_img.y);
    dst[2] = x.z - (d.z & in_img.z);
    dst[3] = x.w - (d.w & in_img.w);
  }
  __syncthreads();

  // 5. The cross threshold of the tophat.
  cross_walk(smem, p.pd, kb, 16 * p.kbq, th, tw, kb, p.C, -1, hbits, p.hbp,
             th_out + frame, H, W, y0, x0);
}

template <int NQ, int MINB>
cudaError_t launch(dim3 grid, const CsPlan& p, const void* img, void* th,
                   void* keep, int H, int W, bool vec, void* stream) {
  static_assert(NQ == kCsShapes[MINB - 1].quads, "a shape of kCsShapes");
  cudaError_t err = lt::allow_smem(channel_stage_kernel<NQ, MINB>, p.smem);
  if (err != cudaSuccess) return err;
  channel_stage_kernel<NQ, MINB><<<grid, kCsThreads, p.smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), static_cast<uint8_t*>(th),
      static_cast<uint8_t*>(keep), H, W, vec, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The tile lt_channel_stage takes for kt (runs: n rows of int32 (dy, lo,
// hi), a host array), kb and kn (0: no noise mask) on an H x W frame, as
// (columns << 16) | rows: block 0 the planned tile, block > 0 that many
// rows clamped to H and to what fits.  Negative if none fits.
int lt_channel_stage_plan(const void* runs, int n_runs, int kt, int kb,
                          int kn, int H, int W, int block) {
  SeRuns se;
  CsPlan p;
  if (load_runs(static_cast<const int*>(runs), n_runs, &se) != 0 ||
      cs_plan(se, kt, kb, kn, H, W, block, max_smem(), &p) != 0)
    return -1;
  return (16 * p.tq) << 16 | p.th;
}

// th = cross_threshold(tophat(img, kt), kb, C) as 0/255; with keep
// non-null also keep = (img < nthr) | cross_threshold(img, kn, Cn).  runs:
// the kt ellipse's n rows of int32 (dy, lo, hi), a host array.  block:
// output rows of one CTA's tile (0: planned).
int lt_channel_stage(const void* img, void* th, void* keep, const void* runs,
                     int n_runs, int kt, int kb, int C, int kn, int Cn,
                     int nthr, int block, int T, int H, int W, void* stream) {
  SeRuns se;
  CsPlan p;
  if (keep == nullptr) kn = 0;
  if (load_runs(static_cast<const int*>(runs), n_runs, &se) != 0 || T < 1 ||
      (keep != nullptr && kn < 1) ||
      cs_plan(se, kt, kb, kn, H, W, block, max_smem(), &p) != 0)
    return (int)cudaErrorInvalidValue;
  p.C = C;
  p.Cn = Cn;
  p.nthr = keep != nullptr ? nthr : -1;
  const bool vec =
      W % 16 == 0 && reinterpret_cast<uintptr_t>(img) % 16 == 0;
  const dim3 grid((W + 16 * p.tq - 1) / (16 * p.tq), (H + p.th - 1) / p.th,
                  T);
  if (kCsShapes[p.shape].ctas == 2)
    return (int)launch<6, 2>(grid, p, img, th, keep, H, W, vec, stream);
  return (int)launch<8, 1>(grid, p, img, th, keep, H, W, vec, stream);
}

}  // extern "C"
