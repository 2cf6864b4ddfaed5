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
// min/add are a tenth of that.  The design:
//   * One CTA per 32-column strip of a frame (columns are independent under
//     the sweeps, which shift along rows), 256 threads: two warpgroups.
//     sum(A @ tri) splits exactly over A's columns (split-K), so a strip
//     multiplies its own columns of the three row blocks by the matching 32
//     rows of tri, and a frame spreads over C / 32 CTAs with no barrier
//     between them.  112 KB of shared memory a CTA: two CTAs an SM, so one
//     CTA's asynchronous products run beside another's sweeps.
//   * The strip lives in shared memory as four planes, one per 8-column
//     chunk, each a column of 16-byte rows: the layout wgmma reads with no
//     swizzle (core matrices of 8 rows x 16 bytes, 128 contiguous bytes).
//     The strip arrives by cp.async 16-byte copies.  Planes are PS rows
//     apart, PS = 2 mod 8, so the 16-byte stores of a row's four chunks
//     fall in distinct banks.
//   * The sweeps run in registers, not shared memory: a warp takes two
//     bf16x2 columns, a lane 19 consecutive rows of each (a warp covers 608
//     rows); a sweep by d takes the d rows past a lane's last from the next
//     lane (__shfl_down_sync) and is __hmin2 + __hadd2 (one rounding of the
//     exact sum: the f32 add and round of the reference).  The planes are
//     read once before and written once after the sweeps.
//   * The products are wgmma.mma_async (m64nNTk16, bf16 in, f32
//     accumulators), both operands in shared memory, as the transposed
//     problem: tri^T (64-column tiles of tri, M-major) times strip^T (the
//     strip's rows, K-major), so M = NP in tiles of 64 and N = block in
//     tiles of NT (184 for the probe's 368, else 8), exactly, with no row
//     outside a block.  tri's 32 rows of the strip are staged into core
//     matrices by cp.async 16-byte copies, issued after the strip's so they
//     land while the sweeps run (a TMA box writes rows in order, not core
//     matrices).
//     Every (m tile, K step, block, n tile) product accumulates into one
//     register fragment, since only the sum is wanted; warpgroup g takes m
//     tiles g, g + 2, ...; the CTA writes its strip of `swept` while the
//     products run.
// Reduction is deterministic: fixed-order sums inside a thread, a shuffle
// tree per warp, the warps in order, one partial per CTA, and the last CTA
// of a frame (an integer atomic counter) adds the frame's partials in strip
// order.  No float atomics: two calls give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int kThreads = 256;   // two warpgroups
constexpr int kWarps = kThreads / 32;
constexpr int kStrip = 32;      // columns of a CTA's strip
constexpr int kChunk = 8;       // columns of a plane: one 16-byte row
constexpr int kPlanes = kStrip / kChunk;
constexpr int kLaneRows = 19;   // sweep rows a lane holds
constexpr int kMaxRows = 32 * kLaneRows;
constexpr int kPairsPerWarp = kStrip / 2 / kWarps;
constexpr int kK = 16;          // wgmma depth (bf16)
constexpr int kM = 64;          // wgmma rows: columns of tri
constexpr int kSteps = kStrip / kK;
constexpr int kCore = 128;      // bytes of a core matrix: 8 rows x 16 bytes
constexpr int kUnswept = 8;     // rows R-8.. no sweep writes
constexpr int kCornerRows = 8;  // the sum(scr[0:8, 0:128]) term
constexpr int kCornerCols = 128;
constexpr int kBlocks = 3;      // row blocks at rows 0, 8, 16
constexpr int kBlockStep = 8;
constexpr int kMaxShift = 7;    // d = i % 7 + 1
enum Kind { kSweeps = 1, kDots = 2 };  // bits: both = 3

// Rows between planes: at least R, 2 mod 8 (16-byte rows).
__host__ __device__ __forceinline__ int plane_pitch(int R) {
  return R + ((10 - R % 8) % 8);
}

__host__ __device__ __forceinline__ size_t strip_bytes(int R) {
  return (size_t)kPlanes * plane_pitch(R) * 16;
}

// tri's 32 rows of a strip as core matrices: K group g (8 rows), M group h
// (8 columns) at g * NP * 16 + h * 128 bytes, row k of it 16 bytes further
// per k.
__host__ __device__ __forceinline__ size_t tri_bytes(int NP) {
  return (size_t)kStrip * NP * 2;
}

// ---- wgmma (sm_90a) ----

// A shared-memory matrix descriptor with no swizzle: start address, the
// byte offsets between core matrices adjacent in K (lbo) and in M or N
// (sbo), all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// D (64 x 8) += A (64 x 16, M-major) * B (16 x 8, K-major): 4 f32 a thread.
__device__ __forceinline__ void wgmma(float (&d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}"
      ", %4, %5, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(1));
}

// D (64 x 184) += A (64 x 16, M-major) * B (16 x 184, K-major): 92 f32 a
// thread.
__device__ __forceinline__ void wgmma(float (&d)[92], uint64_t a,
                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %94, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n184k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91}"
      ", %92, %93, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// ---- the sweeps ----

// One sweep by D of a lane's rows r0 .. r0 + 18 of one bf16x2 column: rows
// below lim take min(row, row + D) + 1; the D rows past the lane's last
// come from the next lane, read before any row changes.
template <int D>
__device__ __forceinline__ void sweep_step(bf162 (&v)[kLaneRows], int r0,
                                           int lim) {
  bf162 next[D];
#pragma unroll
  for (int q = 0; q < D; ++q) next[q] = __shfl_down_sync(0xffffffffu, v[q], 1);
  const bf162 one = __float2bfloat162_rn(1.f);
#pragma unroll
  for (int q = 0; q < kLaneRows; ++q) {
    constexpr int kLast = kLaneRows - 1;
    const bf162 src = q + D <= kLast ? v[q + D <= kLast ? q + D : kLast]
                                     : next[q + D > kLast ? q + D - kLaneRows
                                                          : 0];
    if (r0 + q < lim) v[q] = __hadd2(__hmin2(v[q], src), one);
  }
}

__device__ __forceinline__ void sweep(bf162 (&v)[kLaneRows], int d, int r0,
                                      int lim) {
  switch (d) {
    case 1: sweep_step<1>(v, r0, lim); break;
    case 2: sweep_step<2>(v, r0, lim); break;
    case 3: sweep_step<3>(v, r0, lim); break;
    case 4: sweep_step<4>(v, r0, lim); break;
    case 5: sweep_step<5>(v, r0, lim); break;
    case 6: sweep_step<6>(v, r0, lim); break;
    case 7: sweep_step<7>(v, r0, lim); break;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Grid (ceil(C / 32), T), kThreads threads.  Strip s of frame t: columns
// [32 s, 32 s + w) of x[t], w = min(32, C - 32 s); plane c holds columns
// 8c .. 8c + 7, row r at 16-byte row c * PS + r (columns w..31 read as 0
// and are never stored).  vec: C % 8 == 0 and x, swept 16-byte aligned.
template <int NT>
__global__ void __launch_bounds__(kThreads, 2)
    sweep_dots_kernel(const bf16* __restrict__ x, const bf16* __restrict__ tri,
                      float* __restrict__ out, bf16* __restrict__ swept,
                      float* partials, unsigned int* count, int R, int C,
                      int block, int col0, int KP, int NP, int sweeps,
                      int kind, bool vec) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ float warp_dot[kWarps];
  __shared__ float warp_corner[kWarps];
  const int PS = plane_pitch(R);
  uint4* planes = reinterpret_cast<uint4*>(smem_raw);
  unsigned char* tri_s = smem_raw + strip_bytes(R);
  const int t = blockIdx.y;
  const int s = blockIdx.x;
  const int n_strips = gridDim.x;
  const int c0 = s * kStrip;
  const int w = min(kStrip, C - c0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t frame = (size_t)t * R * C + c0;

  // The K steps (16-column chunks of the strip) inside [col0, col0 + KP).
  bool use[kSteps];
  bool any = false;
#pragma unroll
  for (int q = 0; q < kSteps; ++q) {
    const int c = c0 + q * kK;
    use[q] = (kind & kDots) && c >= col0 && c + kK <= col0 + KP;
    any = any || use[q];
  }

  // The strip into the planes, by cp.async where whole 16-byte chunks
  // lie in the frame (a row's four chunks are neighbouring threads: 64
  // contiguous bytes of x), else element by element, zero past the
  // frame's last column.
  for (int i = tid; i < R * kPlanes; i += kThreads) {
    const int r = i / kPlanes;
    const int c = i % kPlanes;
    const int col = c * kChunk;
    const bf16* src = x + frame + (size_t)r * C + col;
    if (vec && col < w) {
      cp_async16(planes + c * PS + r, src);
      continue;
    }
    union {
      uint4 u;
      bf16 e[kChunk];
    } v;
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      v.e[j] = col + j < w ? src[j] : __float2bfloat16(0.f);
    planes[c * PS + r] = v.u;
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // tri's rows of the used steps into core matrices, in flight while the
  // strip is swept.
  if (any) {
    const int n_items = 2 * NP;  // 16 rows x NP / 8 chunks a step
#pragma unroll
    for (int q = 0; q < kSteps; ++q) {
      if (!use[q]) continue;
      const int k0 = c0 + q * kK - col0;
      for (int i = tid; i < n_items; i += kThreads) {
        const int k8 = i % 8;
        const int h = (i / 8) % (NP / 8);
        const int g = i / NP;  // K group of the step: 0 or 1
        cp_async16(tri_s + (size_t)(2 * q + g) * NP * 16 + h * kCore + k8 * 16,
                   tri + (size_t)(k0 + 8 * g + k8) * NP + 8 * h);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // the strip
  } else {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
  __syncthreads();

  // The sweeps in registers: warp `warp` takes bf16x2 columns warp + 8 p,
  // lane its rows 19 lane .. 19 lane + 18.
  if ((kind & kSweeps) && R > kUnswept) {
    bf162 v[kPairsPerWarp][kLaneRows];
    bf162* col[kPairsPerWarp];
    const int r0 = lane * kLaneRows;
#pragma unroll
    for (int p = 0; p < kPairsPerWarp; ++p) {
      const int pair = warp + kWarps * p;
      col[p] = reinterpret_cast<bf162*>(planes + (pair / 4) * PS) + pair % 4;
#pragma unroll
      for (int q = 0; q < kLaneRows; ++q)
        v[p][q] = r0 + q < R ? col[p][(r0 + q) * 4]
                             : __float2bfloat162_rn(0.f);
    }
    for (int i = 0; i < sweeps; ++i) {
      const int d = i % kMaxShift + 1;
#pragma unroll
      for (int p = 0; p < kPairsPerWarp; ++p) sweep(v[p], d, r0, R - kUnswept);
    }
#pragma unroll
    for (int p = 0; p < kPairsPerWarp; ++p)
#pragma unroll
      for (int q = 0; q < kLaneRows; ++q)
        if (r0 + q < R) col[p][(r0 + q) * 4] = v[p][q];
  }
  if (any) asm volatile("cp.async.wait_all;\n" ::: "memory");
  // The planes and tri's core matrices are read by the tensor cores (the
  // async proxy) next.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // The products, issued without waiting: warpgroup g takes m tiles g, g +
  // 2, ...; every tile accumulates into acc.
  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) {
    acc[i] = 0.f;
    fence_operand(acc[i]);
  }
  if (any) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    // The warpgroup index through a shuffle, so the compiler sees it
    // uniform across the warp: a loop bound it takes for divergent makes
    // ptxas serialize the wgmma instructions.
    const int wg = __shfl_sync(0xffffffffu, warp / 4, 0);
    const uint32_t lbo_a = NP * 16;
    const uint32_t lbo_b = PS * 16;
    for (int mt = wg; mt < NP / kM; mt += 2) {
#pragma unroll
      for (int q = 0; q < kSteps; ++q) {
        if (!use[q]) continue;
        const uint64_t a = smem_desc(
            tri_s + (size_t)2 * q * NP * 16 + (size_t)mt * (kM / 8) * kCore,
            lbo_a, kCore);
        for (int j = 0; j < kBlocks; ++j) {
          for (int n0 = 0; n0 < block; n0 += NT) {
            const uint64_t b = smem_desc(
                planes + 2 * q * PS + kBlockStep * j + n0, lbo_b, kCore);
            wgmma(acc, a, b);
          }
        }
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  }

  // The strip of swept, and the corner, while the products run.
  for (int i = tid; i < R * kPlanes; i += kThreads) {
    const int r = i / kPlanes;
    const int c = i % kPlanes;
    const int col = c * kChunk;
    if (col >= w) continue;
    const uint4 v = planes[c * PS + r];
    bf16* dst = swept + frame + (size_t)r * C + col;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const bf16* e = reinterpret_cast<const bf16*>(&v);
      for (int j = 0; j < kChunk && col + j < w; ++j) dst[j] = e[j];
    }
  }
  float corner = 0.f;
  for (int q = tid; q < kCornerRows * kStrip; q += kThreads) {
    const int r = q / kStrip;
    const int c = q % kStrip;
    if (c < w && c0 + c < kCornerCols)
      corner += __bfloat162float(reinterpret_cast<const bf16*>(
          planes + (c / kChunk) * PS + r)[c % kChunk]);
  }

  float dot = 0.f;
  if (any) {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) {
      fence_operand(acc[i]);
      dot += acc[i];
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

template <int NT>
cudaError_t launch(const bf16* x, const bf16* tri, float* out, bf16* swept,
                   float* partials, unsigned int* count, int T, int R, int C,
                   int block, int col0, int KP, int NP, int sweeps, int kind,
                   cudaStream_t st) {
  const size_t smem = strip_bytes(R) + tri_bytes(NP);
  cudaError_t err = lt::allow_smem(sweep_dots_kernel<NT>, smem);
  if (err != cudaSuccess) return err;
  const bool vec = C % kChunk == 0 &&
                   (reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(swept)) % 16 == 0;
  const dim3 grid((C + kStrip - 1) / kStrip, T);
  sweep_dots_kernel<NT><<<grid, kThreads, smem, st>>>(
      x, tri, out, swept, partials, count, R, C, block, col0, KP, NP, sweeps,
      kind, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out (T) f32 and swept (T, R, C) bf16 of the probe kernel on x (T, R, C)
// bf16 and tri (KP, NP) bf16 (16-byte aligned), kind 1 sweeps, 2 dots, 3
// both.  partials: T * ceil(C / 32) f32 scratch; count: T uint32 scratch
// (zeroed here).  block, KP and col0 multiples of 16, NP of 64; 16 + block
// <= R <= 608, col0 + KP <= C; the strip and 32 rows of tri must fit one
// CTA's shared memory.
int lt_sweep_dots(const void* x, const void* tri, void* out, void* swept,
                  void* partials, void* count, int T, int R, int C, int block,
                  int col0, int KP, int NP, int sweeps, int kind,
                  void* stream) {
  if (T < 1 || C < 1 || block < kK || block % kK || KP < kK || KP % kK ||
      NP < kM || NP % kM || col0 < 0 || col0 % kK ||
      R < (kBlocks - 1) * kBlockStep + block || R > kMaxRows ||
      C < col0 + KP || sweeps < 0 || kind < 1 || kind > 3 ||
      strip_bytes(R) + tri_bytes(NP) > (size_t)227 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(count, 0, (size_t)T * sizeof(unsigned int), st);
  if (err != cudaSuccess) return (int)err;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* tb = static_cast<const bf16*>(tri);
  float* o = static_cast<float*>(out);
  bf16* sw = static_cast<bf16*>(swept);
  float* pa = static_cast<float*>(partials);
  unsigned int* cn = static_cast<unsigned int*>(count);
  if (block % 184 == 0)
    err = launch<184>(xb, tb, o, sw, pa, cn, T, R, C, block, col0, KP, NP,
                      sweeps, kind, st);
  else
    err = launch<8>(xb, tb, o, sw, pa, cn, T, R, C, block, col0, KP, NP,
                    sweeps, kind, st);
  return (int)err;
}

}  // extern "C"
