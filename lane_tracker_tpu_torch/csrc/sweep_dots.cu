// Hand-written Hopper (sm_90a) kernel for the tensor-core overlap probe:
// bf16 min/add sweeps over a frame and three bf16 products of row blocks of
// the swept frame by a matrix, in one launch.
//
// It replaces the Pallas TPU kernel of scripts/mosaic_probe6.py, `make(kind)`
// (:35, pallas_call at :63), which asks whether the matrix unit runs beside
// the vector unit inside one kernel.  Per frame t of x (T, R, C) bf16 the
// scratch `scr` starts as x[t]; then
//   kind & 1 (sweeps): `sweeps` times, d = i % 7 + 1,
//        scr[0:R-8] = bf16(f32(min(scr[0:R-8], scr[d:d+R-8])) + 1)
//        (the whole right side formed before the write; rows R-8.. never
//        change);
//   kind & 2 (dots):   s = sum_j sum(scr[8j:8j+block, col0:col0+KP] @ tri),
//        j = 0, 1, 2, bf16 products with f32 accumulation;
//   out[t] = s + sum(scr[0:8, 0:128]) in f32 (s = 0 without dots).
// `swept` receives scr: the raw frame where kind has no sweeps.
//
// Plain C interface, loaded with ctypes: the entry launches on the stream it
// is given, allocates nothing and returns cudaGetLastError().
//
// What bounds it on the H100: the dots, 93.8 GFLOP a 32-frame call at the
// full size, on the tensor cores (989 TFLOP/s dense bf16) against 98 MB of
// device memory read and written (x in, swept out); the sweeps' 1.5 G bf16
// min/add are a tenth of that.  The design keeps every sweep in shared
// memory and feeds the products from there: the sweeps shift along rows
// only, so columns are independent, and one CTA takes a full-height strip
// of 32 columns of one frame (2 x R rows of 40 bf16 ping-pong, 96 KB at
// R = 600: rows padded from 64 to 80 bytes, so the 8 rows a fragment load
// reads at once fall in distinct banks; unpadded they met 4 to a bank),
// runs all the sweeps, writes its strip of `swept`, and then multiplies its
// own columns of the three row blocks by the matching 32 rows of tri:
// sum(A @ tri) splits exactly over A's columns (split-K).  So a frame spreads
// over C / 32 CTAs (1280 at the full size) with no barrier between CTAs, and
// one CTA's products can run on an SM beside another's sweeps.  The products
// are nvcuda::wmma 16x16x16 bf16 fragments with f32 accumulators (HMMA on
// sm_90a): A from the strip in shared memory, B from tri through L1/L2.  A
// warp accumulates all its (column tile, row block, row tile) products in
// two accumulator fragments, since only their sum is wanted.  Reduction is
// deterministic: fixed-order sums inside a thread, a shuffle tree per warp,
// the warps in order, one partial per CTA, and the last CTA of a frame (an
// integer atomic counter) adds the frame's partials in strip order.  No
// float atomics: two calls give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;
namespace wmma = nvcuda::wmma;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kStrip = 32;      // columns of a CTA's strip
constexpr int kLd = kStrip + 8; // its row stride in shared memory
constexpr int kAlign = 16;      // elements: a fragment load's 32 bytes
constexpr int kFrag = 16;       // the wmma tile: 16 x 16 x 16
constexpr int kChunks = kStrip / kFrag;
constexpr int kUnswept = 8;     // rows R-8.. no sweep writes
constexpr int kCornerRows = 8;  // the sum(scr[0:8, 0:128]) term
constexpr int kCornerCols = 128;
constexpr int kBlocks = 3;      // row blocks at rows 0, 8, 16
constexpr int kBlockStep = 8;
constexpr int kMaxShift = 7;    // d = i % 7 + 1
enum Kind { kSweeps = 1, kDots = 2 };  // bits: both = 3

using FragA = wmma::fragment<wmma::matrix_a, kFrag, kFrag, kFrag, bf16,
                             wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, kFrag, kFrag, kFrag, bf16,
                             wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, kFrag, kFrag, kFrag, float>;

// One ping-pong buffer: R rows of kLd, rounded up so that the second
// buffer starts 32-byte aligned, as a fragment load needs.
__host__ __device__ __forceinline__ size_t plane_elems(int R) {
  return ((size_t)R * kLd + kAlign - 1) / kAlign * kAlign;
}

__device__ __forceinline__ float frag_sum(const FragC& f) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < f.num_elements; ++i) s += f.x[i];
  return s;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Grid (ceil(C / 32), T), block kThreads.  Strip s of frame t: columns
// [32 s, 32 s + w) of x[t], w = min(32, C - 32 s), held at shared slot
// r * kLd + c (columns w..31 read as 0 and are never stored; 32..39 are
// padding).  Loops run over q = r * 32 + c, one row of the strip a warp.
__global__ void __launch_bounds__(kThreads, 2)
    sweep_dots_kernel(const bf16* __restrict__ x, const bf16* __restrict__ tri,
                      float* __restrict__ out, bf16* __restrict__ swept,
                      float* partials, unsigned int* count, int R, int C,
                      int block, int col0, int KP, int NP, int sweeps,
                      int kind) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ float warp_dot[kWarps];
  __shared__ float warp_corner[kWarps];
  bf16* buf0 = reinterpret_cast<bf16*>(smem_raw);
  bf16* buf1 = buf0 + plane_elems(R);
  const int t = blockIdx.y;
  const int s = blockIdx.x;
  const int n_strips = gridDim.x;
  const int c0 = s * kStrip;
  const int w = min(kStrip, C - c0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t frame = (size_t)t * R * C + c0;
  const int n = R * kStrip;  // the strip's elements

  // The copy into the scratch, into both buffers: the unswept rows are read
  // from whichever buffer the last sweep wrote.
  for (int q = tid; q < n; q += kThreads) {
    const int r = q / kStrip;
    const int c = q % kStrip;
    const bf16 v =
        c < w ? x[frame + (size_t)r * C + c] : __float2bfloat16(0.f);
    buf0[r * kLd + c] = v;
    buf1[r * kLd + c] = v;
  }
  __syncthreads();

  // The sweeps, two columns a thread (bf16x2): the min of each pair, each
  // add in f32, rounded once.
  bf16* scr = buf0;
  if ((kind & kSweeps) && R > kUnswept) {
    constexpr int kPairs = kStrip / 2;
    constexpr int kLd2 = kLd / 2;
    const int m = (R - kUnswept) * kPairs;
    bf16* dst = buf1;
    for (int i = 0; i < sweeps; ++i) {
      const int d = (i % kMaxShift + 1) * kLd2;
      const bf162* src2 = reinterpret_cast<const bf162*>(scr);
      bf162* dst2 = reinterpret_cast<bf162*>(dst);
      for (int q = tid; q < m; q += kThreads) {
        const int e = (q / kPairs) * kLd2 + q % kPairs;
        const float2 a = __bfloat1622float2(__hmin2(src2[e], src2[e + d]));
        dst2[e] = __floats2bfloat162_rn(a.x + 1.0f, a.y + 1.0f);
      }
      __syncthreads();
      bf16* done = dst;
      dst = scr;
      scr = done;
    }
  }
  for (int q = tid; q < n; q += kThreads) {
    const int r = q / kStrip;
    const int c = q % kStrip;
    if (c < w) swept[frame + (size_t)r * C + c] = scr[r * kLd + c];
  }

  float corner = 0.f;
  for (int q = tid; q < kCornerRows * kStrip; q += kThreads) {
    const int c = q % kStrip;
    if (c < w && c0 + c < kCornerCols)
      corner += __bfloat162float(scr[(q / kStrip) * kLd + c]);
  }

  // This strip's share of the three products: its 16-column chunks inside
  // [col0, col0 + KP) times the matching rows of tri.
  float dot = 0.f;
  if (kind & kDots) {
    bool use[kChunks];
    bool any = false;
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      const int c = c0 + q * kFrag;
      use[q] = c >= col0 && c + kFrag <= col0 + KP;
      any = any || use[q];
    }
    if (any) {
      FragC acc0, acc1;
      wmma::fill_fragment(acc0, 0.f);
      wmma::fill_fragment(acc1, 0.f);
      FragA a;
      FragB b[kChunks];
      const int n_tiles = NP / kFrag;
      const int m_tiles = block / kFrag;
      for (int item = warp; item < n_tiles * kBlocks; item += kWarps) {
        const int nt = item / kBlocks;
        const int j = item % kBlocks;
#pragma unroll
        for (int q = 0; q < kChunks; ++q)
          if (use[q])
            wmma::load_matrix_sync(
                b[q], tri + (size_t)(c0 + q * kFrag - col0) * NP + nt * kFrag,
                NP);
        const bf16* a0 = scr + (size_t)(kBlockStep * j) * kLd;
        auto step = [&](FragC& acc, int mt) {
#pragma unroll
          for (int q = 0; q < kChunks; ++q) {
            if (use[q]) {
              wmma::load_matrix_sync(
                  a, a0 + (size_t)mt * kFrag * kLd + q * kFrag, kLd);
              wmma::mma_sync(acc, a, b[q], acc);
            }
          }
        };
        int mt = 0;
        for (; mt + 1 < m_tiles; mt += 2) {
          step(acc0, mt);
          step(acc1, mt + 1);
        }
        if (mt < m_tiles) step(acc0, mt);
      }
      dot = frag_sum(acc0) + frag_sum(acc1);
    }
  }

  dot = warp_sum(dot);
  corner = warp_sum(corner);
  if (lane == 0) {
    warp_dot[warp] = dot;
    warp_corner[warp] = corner;
  }
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
    for (int i = 0; i < kWarps; ++i) total += warp_dot[i];
    for (int i = 0; i < kWarps; ++i) total += warp_corner[i];
    partials[(size_t)t * n_strips + s] = total;
    __threadfence();
    if (atomicAdd(count + t, 1u) == (unsigned int)(n_strips - 1)) {
      // The frame's last CTA: every other partial is visible.
      __threadfence();
      total = 0.f;
      for (int i = 0; i < n_strips; ++i)
        total += __ldcg(partials + (size_t)t * n_strips + i);
      out[t] = total;
    }
  }
}

}  // namespace

extern "C" {

// out (T) f32 and swept (T, R, C) bf16 of the probe kernel on x (T, R, C)
// bf16 and tri (KP, NP) bf16 (32-byte aligned), kind 1 sweeps, 2 dots, 3
// both.  partials: T * ceil(C / 32) f32 scratch; count: T uint32 scratch
// (zeroed here).  block, KP, NP and col0 multiples of 16; 16 + block <= R,
// col0 + KP <= C; 2 * R * 40 bf16 must fit one CTA's shared memory.
int lt_sweep_dots(const void* x, const void* tri, void* out, void* swept,
                  void* partials, void* count, int T, int R, int C, int block,
                  int col0, int KP, int NP, int sweeps, int kind,
                  void* stream) {
  if (T < 1 || C < 1 || block < kFrag || block % kFrag || KP < kFrag ||
      KP % kFrag || NP < kFrag || NP % kFrag || col0 < 0 || col0 % kFrag ||
      R < (kBlocks - 1) * kBlockStep + block || C < col0 + KP || sweeps < 0 ||
      kind < 1 || kind > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = 2 * plane_elems(R) * sizeof(bf16);
  cudaError_t err = lt::allow_smem(sweep_dots_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(count, 0, (size_t)T * sizeof(unsigned int), st);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((C + kStrip - 1) / kStrip, T);
  sweep_dots_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(tri),
      static_cast<float*>(out), static_cast<bf16*>(swept),
      static_cast<float*>(partials), static_cast<unsigned int*>(count), R, C,
      block, col0, KP, NP, sweeps, kind);
  return (int)cudaGetLastError();
}

}  // extern "C"
