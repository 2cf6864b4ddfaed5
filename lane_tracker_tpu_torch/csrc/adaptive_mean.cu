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
// Bit-exact with the plain twin ops/threshold.adaptive_mean_threshold,
// which rounds the mean in integer math instead.  The TPU kernel's bf16
// hi/lo byte split and band matmuls are MXU devices and are not carried
// over.
//
// Plain C interface, loaded with ctypes (as filter_stage.cu): launches on
// the stream it is given, allocates nothing, returns cudaGetLastError() and
// counts the launch in lt_filter_stage_launches.
//
// What bounds it on the H100: HBM bytes (one u8 read and one u8 write a
// pixel, 0.0283 ms at (64, 1100, 672)); the design's job is to keep the
// box sums off the critical path.  Box sums are separable, so:
//   * Tiles of 128 columns by TH rows (TH = 128, 64, 32 or 16: the tallest
//     whose grid still gives every SM a CTA, so a T=1 frame fills the card
//     too; the host plans it).  A CTA stages its tile plus r rows and
//     round16(r) columns of halo, replicate-clamped, as 16-byte loads
//     wherever a quad lies inside the image (per-byte clamped loads only
//     for quads across or past the left and right edges); TH + 2r rows of
//     TH are staged, 1.27x the outputs at k=35, TH=128 (the 32x32 tiles of
//     the first design staged 4.4x, then built an integral image with one
//     serial thread a row and a column).
//   * Row walkers, one a staged row, keep the horizontal k-sum of the 128
//     columns as a running sum (one add and one subtract a pixel, the
//     entering and leaving bytes four at a time from funnel-shifted words)
//     and store it as uint16 (k * 255 fits up to k = kAdaptiveMaxK).
//   * Column walkers, one a column pair and quarter of the tile's height,
//     keep the vertical sums of those in int32 (two adds a pixel), compare
//     in the epilogue, and write 0/255 in place over the staged centre
//     pixel they have just read.
//   * The tile's outputs then leave in 16-byte stores.
//   * Latency, not issue slots, bounds a CTA (eight warps, three CTAs an
//     SM): each thread loads four staged quads before storing any, and the
//     column walk is unrolled four rows deep (10-12% a launch on the H100).
// Shared memory: (TH + 2r) rows of staged bytes and of uint16 row sums,
// 74.8 KB at k=35, TH=128: three CTAs an SM.  The pitches are an odd number
// of words (staged rows) and 33 double words (row sums), so the row
// walkers, each on its own row, meet no bank twice.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using lt::allow_smem;

constexpr int kAmTW = 128;      // output columns of a tile
constexpr int kAmThreads = 256;
constexpr int kAmPairs = kAmTW / 2;           // column walkers a segment row
constexpr int kAmSegs = kAmThreads / kAmPairs;  // column segments a tile
constexpr int kAmGuard = 16;    // bytes before the staged plane
// The largest k: a row sum of k pixels, k * 255, fits a uint16 (and an
// int16) lane up to k = 128; odd k only.
constexpr int kAdaptiveMaxK = 127;
// Row sums: uint16, 128 a row, pitch 264 bytes (33 double words, so the
// row walkers' 8-byte stores on 32 rows fall on distinct banks).
constexpr int kAmSumPitch = 2 * kAmTW + 8;

struct AmPlan {
  int r, kx;   // radius; the column halo, r rounded up to 16
  int th;      // output rows of a tile
  int ps;      // staged row pitch in bytes (an odd number of words)
  int mul, off;  // hit iff 2 * boxsum < mul * x + off
};

__host__ __device__ inline int am_rows(const AmPlan& p) {
  return p.th + 2 * p.r;
}

// The guard, the staged rows, the row sums and a spare row of them.
size_t am_smem(const AmPlan& p) {
  return kAmGuard + (size_t)am_rows(p) * (p.ps + kAmSumPitch) + kAmSumPitch;
}

// Byte j (0..3) of w, zero-extended.
__device__ __forceinline__ int byte_of(uint32_t w, int j) {
  return (int)((w >> (8 * j)) & 0xffu);
}

// Grid (ceil(W / 128), ceil(H / th), T); kAmThreads threads.
__global__ void __launch_bounds__(kAmThreads)
    adaptive_mean_kernel(const uint8_t* __restrict__ in,
                         uint8_t* __restrict__ out, int H, int W, bool vec,
                         AmPlan p) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* S = smem + kAmGuard;  // staged plane
  const int rows = am_rows(p);
  uint8_t* hs = S + (size_t)rows * p.ps;  // uint16 row sums
  const int r = p.r, kx = p.kx, ps = p.ps, th = p.th;
  const int x0 = blockIdx.x * kAmTW;
  const int y0 = blockIdx.y * th;
  const size_t frame = (size_t)blockIdx.z * H * W;
  const uint8_t* src = in + frame;
  const int tid = threadIdx.x;

  // 1. Stage rows y0 - r .. and columns x0 - kx .., replicate-clamped,
  // four quads a thread loaded before any is stored.
  const int nq = (kAmTW + 2 * kx) / 16;
  for (int i0 = tid; i0 < rows * nq; i0 += 4 * kAmThreads) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kAmThreads;
      if (i >= rows * nq) break;
      const int row = i / nq;
      const int gy = min(max(y0 - r + row, 0), H - 1);
      const int gx = x0 - kx + 16 * (i - row * nq);
      const uint8_t* line = src + (size_t)gy * W;
      if (vec && gx >= 0 && gx + 16 <= W) {
        v[u] = *reinterpret_cast<const uint4*>(line + gx);
      } else {
        uint32_t w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          w[j] = 0;
#pragma unroll
          for (int b = 0; b < 4; ++b)
            w[j] |= (uint32_t)line[min(max(gx + 4 * j + b, 0), W - 1)]
                    << (8 * b);
        }
        v[u] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kAmThreads;
      if (i >= rows * nq) break;
      const int row = i / nq;
      uint32_t* dst = reinterpret_cast<uint32_t*>(
          S + (size_t)row * ps + 16 * (i - row * nq));
      dst[0] = v[u].x;
      dst[1] = v[u].y;
      dst[2] = v[u].z;
      dst[3] = v[u].w;
    }
  }
  __syncthreads();

  // 2. Row walkers: hs[row][c] = sum of staged bytes kx + c - r .. kx + c
  // + r.  The sum starts as the window of c = -1; output c adds byte
  // kx + c + r and drops byte kx + c - 1 - r, four outputs a step from
  // the words at those offsets (the leaving byte of c = 0 may lie in the
  // guard or the row before: it was added to the start and cancels).
  for (int row = tid; row < rows; row += kAmThreads) {
    const uint8_t* rp = S + (size_t)row * ps;
    const uint32_t* rw = reinterpret_cast<const uint32_t*>(rp);
    int s = 0;
    for (int j = -r - 1; j <= r - 1; ++j) s += rp[kx + j];
    const int e0 = kx + r;      // entering byte of c = 0
    const int l0 = kx - 1 - r;  // leaving byte of c = 0 (>= -1)
    const int ei = e0 >> 2, es = 8 * (e0 & 3);
    const int li = (l0 + 4) / 4 - 1, ls = 8 * (l0 - 4 * li);
    uint32_t ea = rw[ei], la = rw[li];
    uint32_t* hrow = reinterpret_cast<uint32_t*>(hs + (size_t)row * kAmSumPitch);
#pragma unroll 4
    for (int m = 0; m < kAmTW / 4; ++m) {
      const uint32_t eb = rw[ei + m + 1], lb = rw[li + m + 1];
      const uint32_t e = __funnelshift_r(ea, eb, es);
      const uint32_t l = __funnelshift_r(la, lb, ls);
      ea = eb;
      la = lb;
      const int s0 = s + byte_of(e, 0) - byte_of(l, 0);
      const int s1 = s0 + byte_of(e, 1) - byte_of(l, 1);
      const int s2 = s1 + byte_of(e, 2) - byte_of(l, 2);
      s = s2 + byte_of(e, 3) - byte_of(l, 3);
      *reinterpret_cast<uint2*>(hrow + 2 * m) =
          make_uint2((uint32_t)s0 | (uint32_t)s1 << 16,
                     (uint32_t)s2 | (uint32_t)s << 16);
    }
  }
  __syncthreads();

  // 3. Column walkers: column pair cp, output rows [ys, ye); the vertical
  // sum of row sums ys .. ys + 2r, then add the entering row and drop the
  // leaving one.  The outputs overwrite the staged centre pixels.
  {
    const int cp = tid % kAmPairs;
    const int seg = th / kAmSegs;
    const int ys = tid / kAmPairs * seg;
    const uint32_t* hcol =
        reinterpret_cast<const uint32_t*>(hs) + cp;  // row y at y * pitch/4
    const int hp = kAmSumPitch / 4;
    int v0 = 0, v1 = 0;
    for (int y = ys; y <= ys + 2 * r; ++y) {
      const uint32_t w = hcol[y * hp];
      v0 += (int)(w & 0xffffu);
      v1 += (int)(w >> 16);
    }
    uint8_t* xp = S + (size_t)(r + ys) * ps + kx + 2 * cp;
    // The last slide reads the spare row past the row sums: not used.
#pragma unroll 4
    for (int y = ys; y < ys + seg; ++y, xp += ps) {
      const uint32_t xw = *reinterpret_cast<const uint16_t*>(xp);
      const int xa = (int)(xw & 0xffu), xb = (int)(xw >> 8);
      const uint32_t o = (2 * v0 < p.mul * xa + p.off ? 0x00ffu : 0u) |
                         (2 * v1 < p.mul * xb + p.off ? 0xff00u : 0u);
      *reinterpret_cast<uint16_t*>(xp) = (uint16_t)o;
      const uint32_t e = hcol[(y + 2 * r + 1) * hp];
      const uint32_t l = hcol[y * hp];
      v0 += (int)(e & 0xffffu) - (int)(l & 0xffffu);
      v1 += (int)(e >> 16) - (int)(l >> 16);
    }
  }
  __syncthreads();

  // 4. The tile's outputs, 16 bytes a thread.
  for (int i = tid; i < th * (kAmTW / 16); i += kAmThreads) {
    const int y = i / (kAmTW / 16);
    const int q = i - y * (kAmTW / 16);
    const int gy = y0 + y;
    const int gx = x0 + 16 * q;
    if (gy >= H || gx >= W) continue;
    const uint32_t* sw =
        reinterpret_cast<const uint32_t*>(S + (size_t)(r + y) * ps + kx + 16 * q);
    const uint4 v = make_uint4(sw[0], sw[1], sw[2], sw[3]);
    uint8_t* dst = out + frame + (size_t)gy * W + gx;
    if (vec && gx + 16 <= W) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
      for (int b = 0; b < 16 && gx + b < W; ++b)
        dst[b] = (uint8_t)(w[b / 4] >> (8 * (b % 4)));
    }
  }
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

}  // namespace

extern "C" {

// out = cv2.adaptiveThreshold(img, 255, MEAN_C, BINARY, ksize, C) of a
// (T, H, W) uint8 batch; ksize odd, at most kAdaptiveMaxK.
int lt_adaptive_mean(const void* img, void* out, int T, int H, int W,
                     int ksize, int C, void* stream) {
  if (ksize < 1 || ksize % 2 == 0 || ksize > kAdaptiveMaxK || T < 1 ||
      H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  AmPlan p;
  p.r = ksize / 2;
  p.kx = (p.r + 15) / 16 * 16;
  p.ps = kAmTW + 2 * p.kx + 4;  // an odd number of words
  // round(mean) and x lie in [0, 255], so an idelta past +-256 decides
  // every pixel as +-256 does; clamped, 2 * A * (x + idelta) fits int32.
  const int idelta = C < -256 ? -256 : (C > 256 ? 256 : C);
  const int area = ksize * ksize;
  p.mul = 2 * area;
  p.off = 2 * area * idelta - area;
  // The tallest tile whose grid gives every SM a CTA, else the shortest.
  const int sms = sm_count();
  const long long cols = (W + kAmTW - 1) / kAmTW;
  p.th = 16;
  for (int th = 128; th >= 16; th /= 2) {
    if ((long long)T * cols * ((H + th - 1) / th) >= sms) {
      p.th = th;
      break;
    }
  }
  const size_t smem = am_smem(p);
  cudaError_t err = allow_smem(adaptive_mean_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(img) |
                         reinterpret_cast<uintptr_t>(out);
  const bool vec = W % 16 == 0 && bits % 16 == 0;
  const dim3 grid((W + kAmTW - 1) / kAmTW, (H + p.th - 1) / p.th, T);
  adaptive_mean_kernel<<<grid, kAmThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), static_cast<uint8_t*>(out), H, W,
      vec, p);
  return (int)lt::filter_stage_launched();
}

}  // extern "C"
