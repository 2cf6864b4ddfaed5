// Hand-written Hopper (sm_90a) kernels for the morphology probes' shift
// chains: K chained passes x = body(x, shift(x)) over one (H, W) block.
//
// They replace the Pallas TPU kernels of scripts/mosaic_probe.py
// (run_variant, :32), mosaic_probe2.py (run, :31; slice_op, :143),
// mosaic_probe3.py (pingpong, :37; plain, :120) and mosaic_probe4.py
// (pingpong, :36):
//   lt_shift_chain    <- every single-axis variant: a roll (circular) or a
//                        zero/255-margin slice (fill) along the lanes or
//                        the sublanes, combined by add, min or max, the
//                        packed-u16 pair shift, the roll-min-mul-max mix,
//                        and the elementwise-only bodies (no shift)
//   lt_shift_chain_2d <- bf16_morph_chain8 (mosaic_probe2.py:190), whose
//                        every step rolls along both axes
//
// Plain C interface, loaded with ctypes: each entry launches on the stream it
// is given, allocates nothing and returns cudaGetLastError().  Arrays are
// (H, W), row-major, contiguous, of one element type: uint8, int8, int16,
// int32, bfloat16 or float32.
//
// Arithmetic is that of the reference's dtype, op by op: integer adds and
// left shifts are done in uint32 and truncated to the type (the wrap JAX
// gives; signed overflow would be undefined here), right shifts of int32
// are arithmetic, and bf16 rounds after every op (__hadd, __hmin, __hmul,
// ...; a sum or product of two bf16 values is exact in f32, so one rounding
// equals PyTorch's f32-then-round).
//
// What bounds them on the H100: one read and one write of the block
// against K = 64 passes of 1-5 ops per element; the two terms come out
// within a few microseconds of each other, bytes for the one-op 32-bit
// bodies, operations for the rest (chip_smoke.py computes each; PERF.md).
// What the design pays instead is shared memory: each pass reads every
// element and its neighbour and writes it back.  The TPU kernels keep the
// whole block in VMEM;
// here a single-axis chain splits exactly into independent lines along its
// shift axis, so one CTA keeps whole lines in shared memory for all K
// passes and touches device memory once each way: whole rows for a lane
// shift, full-height column strips for a sublane shift.  Each pass reads
// into registers, synchronises, and writes back in place (one buffer; the
// fill margins are made on read from the index).  The elementwise bodies
// keep their elements in registers.  The 2-D chain needs the whole array
// between sub-steps: one cooperative launch whose CTAs meet at a grid
// barrier between the 4 x K/4 sub-steps, with the ping-pong buffers in
// global memory, where the 50 MB L2 holds them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// The bodies and boundaries; the codes are kernels/shift_chain.py's.
enum Body {
  kAdd = 0,        // x + a
  kMin = 1,        // min(x, a)
  kMax = 2,        // max(x, a)
  kAddSelf = 3,    // x + x
  kMinadd = 4,     // min(x + c1, x)
  kAddshift = 5,   // x + (x >> 1) + c1 (int32)
  kWhereAdd = 6,   // x > c1 ? x : x + c2
  kPacked = 7,     // x + ((x >> 16) | (b << 16)) + a (int32; a, b = shifts 1, 2)
  kMinMulMax = 8,  // max(min(x, a), x * c1)
};
enum Bound { kNone = 0, kCircular = 1, kFill = 2 };
enum Dtype { kU8 = 0, kI8 = 1, kI16 = 2, kI32 = 3, kBf16 = 4, kF32 = 5 };

constexpr int kThreads = 512;
constexpr int kEpt = 16;  // elements a thread keeps in registers
constexpr int kMaxCta = kThreads * kEpt;

// ---- the dtype's arithmetic ------------------------------------------------

template <typename T>
__device__ __forceinline__ T t_add(T a, T b) {
  if constexpr (std::is_same_v<T, bf16>) return __hadd(a, b);
  else if constexpr (std::is_same_v<T, float>) return __fadd_rn(a, b);
  else return (T)((uint32_t)a + (uint32_t)b);
}
template <typename T>
__device__ __forceinline__ T t_sub(T a, T b) {
  if constexpr (std::is_same_v<T, bf16>) return __hsub(a, b);
  else if constexpr (std::is_same_v<T, float>) return __fsub_rn(a, b);
  else return (T)((uint32_t)a - (uint32_t)b);
}
template <typename T>
__device__ __forceinline__ T t_mul(T a, T b) {
  if constexpr (std::is_same_v<T, bf16>) return __hmul(a, b);
  else if constexpr (std::is_same_v<T, float>) return __fmul_rn(a, b);
  else return (T)((uint32_t)a * (uint32_t)b);
}
template <typename T>
__device__ __forceinline__ T t_min(T a, T b) {
  if constexpr (std::is_same_v<T, bf16>) return __hmin(a, b);
  else return b < a ? b : a;
}
template <typename T>
__device__ __forceinline__ T t_max(T a, T b) {
  if constexpr (std::is_same_v<T, bf16>) return __hmax(a, b);
  else return a < b ? b : a;
}
template <typename T>
__device__ __forceinline__ bool t_gt(T a, T b) {
  if constexpr (std::is_same_v<T, bf16>) return __hgt(a, b);
  else return a > b;
}

// One pass of a body at one element: x the element, a and b its first and
// second shifted values (unused by the bodies without them).
template <typename T, int kBody>
__device__ __forceinline__ T apply_body(T x, T a, T b, T c1, T c2) {
  if constexpr (kBody == kAdd) {
    return t_add(x, a);
  } else if constexpr (kBody == kMin) {
    return t_min(x, a);
  } else if constexpr (kBody == kMax) {
    return t_max(x, a);
  } else if constexpr (kBody == kAddSelf) {
    return t_add(x, x);
  } else if constexpr (kBody == kMinadd) {
    return t_min(t_add(x, c1), x);
  } else if constexpr (kBody == kAddshift) {
    return t_add(t_add(x, (T)(x >> 1)), c1);
  } else if constexpr (kBody == kWhereAdd) {
    return t_gt(x, c1) ? x : t_add(x, c2);
  } else if constexpr (kBody == kPacked) {
    const int32_t odd = (x >> 16) | (int32_t)((uint32_t)b << 16);
    return t_add(t_add(x, odd), a);
  } else {
    static_assert(kBody == kMinMulMax, "unknown body");
    return t_max(t_min(x, a), t_mul(x, c1));
  }
}

// ---- lt_shift_chain ----------------------------------------------------------

// Grid: one CTA per `lines` lines along the shift axis (kAxis 1: rows of
// W elements; kAxis 0: column strips of H elements); block kThreads.  The
// CTA's element e sits at shared slot e: for rows, line e / W at position
// e % W; for a strip of C columns, column e % C at row e / C.  So a
// neighbour d positions along the line is d (rows) or d * C (strips) slots
// away, and the copy in and out is a plain index map.
template <typename T, int kBody, int kBound, int kAxis>
__global__ void __launch_bounds__(kThreads)
    shift_chain_kernel(const T* __restrict__ in, T* __restrict__ out, int H,
                       int W, int lines, int passes, int s1, int s2, T fill,
                       T c1, T c2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int L = kAxis == 1 ? W : H;
  const int n_lines = kAxis == 1 ? H : W;
  const int line0 = blockIdx.x * lines;
  const int C = min(lines, n_lines - line0);
  const int n = C * L;
  const int tid = threadIdx.x;
  auto global = [&](int e) -> size_t {
    if (kAxis == 1) return (size_t)line0 * W + e;
    const int p = e / C;
    return (size_t)p * W + line0 + (e - p * C);
  };
  T v[kEpt];

  if constexpr (kBound == kNone) {
#pragma unroll
    for (int j = 0; j < kEpt; ++j) {
      const int e = tid + j * kThreads;
      if (e < n) v[j] = in[global(e)];
    }
    for (int it = 0; it < passes; ++it) {
#pragma unroll
      for (int j = 0; j < kEpt; ++j) v[j] = apply_body<T, kBody>(v[j], v[j], v[j], c1, c2);
    }
#pragma unroll
    for (int j = 0; j < kEpt; ++j) {
      const int e = tid + j * kThreads;
      if (e < n) out[global(e)] = v[j];
    }
    return;
  } else {
    const int stride = kAxis == 1 ? 1 : C;
    // Slot of each element's shifted neighbours, -1 where a fill margin is
    // read: a roll reads position p - s (mod L), a slice p + s.
    int nb1[kEpt], nb2[kEpt];
#pragma unroll
    for (int j = 0; j < kEpt; ++j) {
      const int e = tid + j * kThreads;
      const int p = kAxis == 1 ? e % L : e / max(C, 1);
      auto slot = [&](int d) -> int {
        if (kBound == kCircular) {
          const int q = p - d < 0 ? p - d + L : p - d;
          return e + (q - p) * stride;
        }
        return d < L - p ? e + d * stride : -1;
      };
      nb1[j] = slot(s1);
      nb2[j] = kBody == kPacked ? slot(s2) : nb1[j];
    }
    for (int e = tid; e < n; e += kThreads) s[e] = in[global(e)];
    __syncthreads();
    for (int it = 0; it < passes; ++it) {
#pragma unroll
      for (int j = 0; j < kEpt; ++j) {
        const int e = tid + j * kThreads;
        if (e < n) {
          const T a = nb1[j] < 0 ? fill : s[nb1[j]];
          const T b = nb2[j] < 0 ? fill : s[nb2[j]];
          v[j] = apply_body<T, kBody>(s[e], a, b, c1, c2);
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kEpt; ++j) {
        const int e = tid + j * kThreads;
        if (e < n) s[e] = v[j];
      }
      __syncthreads();
    }
    for (int e = tid; e < n; e += kThreads) out[global(e)] = s[e];
  }
}

struct ChainArgs {
  const void* in;
  void* out;
  int H, W, axis, passes, s1, s2;
  double fill, c1, c2;
  cudaStream_t stream;
};

template <typename T>
T from_double(double v) {
  if constexpr (std::is_same_v<T, bf16>) return __float2bfloat16_rn((float)v);
  else return (T)v;
}

template <typename T, int kBody, int kBound, int kAxis>
cudaError_t launch_chain(const ChainArgs& a) {
  const int L = kAxis == 1 ? a.W : a.H;
  const int n_lines = kAxis == 1 ? a.H : a.W;
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // As many lines as fit the CTA's registers, but no fewer CTAs than SMs.
  int lines = kMaxCta / L;
  if (lines < 1) return cudaErrorInvalidValue;
  const int spread = (n_lines + sms - 1) / sms;
  if (lines > spread) lines = spread;
  if (lines < 1) lines = 1;
  const size_t smem =
      kBound == kNone ? 0 : (size_t)lines * L * sizeof(T);
  auto kernel = shift_chain_kernel<T, kBody, kBound, kAxis>;
  cudaError_t err = lt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int grid = (n_lines + lines - 1) / lines;
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.in), static_cast<T*>(a.out), a.H, a.W, lines,
      a.passes, a.s1, a.s2, from_double<T>(a.fill), from_double<T>(a.c1),
      from_double<T>(a.c2));
  return cudaGetLastError();
}

template <typename T>
constexpr int dtype_code() {
  if constexpr (std::is_same_v<T, uint8_t>) return kU8;
  else if constexpr (std::is_same_v<T, int8_t>) return kI8;
  else if constexpr (std::is_same_v<T, int16_t>) return kI16;
  else if constexpr (std::is_same_v<T, int32_t>) return kI32;
  else if constexpr (std::is_same_v<T, bf16>) return kBf16;
  else return kF32;
}

// The (type, body, boundary, axis) cases that kernels/shift_chain.py's
// VARIANTS name, one kernel instance each (an elementwise body takes axis
// 1); tests/test_torch_mosaic_probes.py holds this list to the table.  Any
// other case is cudaErrorInvalidValue.
cudaError_t dispatch(const ChainArgs& a, int dtype, int body, int bound) {
#define CASE(T, B, BD, AX)                                                  \
  if (dtype == dtype_code<T>() && body == B && bound == BD && a.axis == AX) \
    return launch_chain<T, B, BD, AX>(a);
  CASE(uint8_t, kAdd, kFill, 1)
  CASE(uint8_t, kMin, kCircular, 1)
  CASE(uint8_t, kMin, kCircular, 0)
  CASE(uint8_t, kMin, kFill, 1)
  CASE(uint8_t, kMin, kFill, 0)
  CASE(uint8_t, kMinadd, kNone, 1)
  CASE(int8_t, kMin, kCircular, 1)
  CASE(int16_t, kAdd, kCircular, 1)
  CASE(int16_t, kAdd, kCircular, 0)
  CASE(int16_t, kAdd, kFill, 1)
  CASE(int16_t, kAdd, kFill, 0)
  CASE(int16_t, kMin, kCircular, 1)
  CASE(int16_t, kMin, kFill, 1)
  CASE(int16_t, kMin, kFill, 0)
  CASE(int16_t, kAddSelf, kNone, 1)
  CASE(int16_t, kMinadd, kNone, 1)
  CASE(int16_t, kWhereAdd, kNone, 1)
  CASE(int32_t, kAdd, kCircular, 1)
  CASE(int32_t, kAdd, kCircular, 0)
  CASE(int32_t, kAdd, kFill, 1)
  CASE(int32_t, kAdd, kFill, 0)
  CASE(int32_t, kMin, kFill, 1)
  CASE(int32_t, kMin, kFill, 0)
  CASE(int32_t, kAddSelf, kNone, 1)
  CASE(int32_t, kAddshift, kNone, 1)
  CASE(int32_t, kPacked, kCircular, 1)
  CASE(bf16, kAdd, kFill, 1)
  CASE(bf16, kMin, kCircular, 1)
  CASE(bf16, kMin, kCircular, 0)
  CASE(bf16, kMin, kFill, 1)
  CASE(bf16, kMin, kFill, 0)
  CASE(bf16, kMax, kCircular, 1)
  CASE(bf16, kMax, kFill, 1)
  CASE(bf16, kMax, kFill, 0)
  CASE(bf16, kWhereAdd, kNone, 1)
  CASE(bf16, kMinMulMax, kCircular, 0)
  CASE(float, kMin, kCircular, 1)
  CASE(float, kMin, kCircular, 0)
  CASE(float, kMin, kFill, 1)
  CASE(float, kMin, kFill, 0)
#undef CASE
  return cudaErrorInvalidValue;
}

// ---- lt_shift_chain_2d -------------------------------------------------------

// A grid-wide barrier for a cooperative launch (every CTA resident): bar[0]
// counts arrivals, bar[1] is the generation the last arrival advances.
__device__ __forceinline__ void grid_barrier(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// Loads that bypass L1: other CTAs wrote these buffers since the last
// barrier, and L1 is not coherent across SMs.
__device__ __forceinline__ bf16 ld(const bf16* p) {
  return __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p)));
}

// bf16_morph_chain8: `outer` times
//   p = min(x, roll(x, a1, lanes)); q = min(p, roll(p, a2, lanes));
//   p = max(q, roll(q, b1, rows));  x = x - max(p, roll(p, b2, rows))
// with a grid barrier after each sub-step.  x (the output) holds the input
// at the start; the last sub-step updates it in place (each element reads
// only its own x).
__global__ void shift_chain_2d_kernel(bf16* x, bf16* p, bf16* q, int H, int W,
                                      int outer, int a1, int a2, int b1,
                                      int b2, unsigned int* bar) {
  const size_t n = (size_t)H * W;
  const size_t i0 = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t step = (size_t)gridDim.x * blockDim.x;
  auto lane_src = [&](size_t i, int d) {
    const int r = (int)(i / W);
    const int c = (int)(i - (size_t)r * W);
    const int cc = c - d < 0 ? c - d + W : c - d;
    return (size_t)r * W + cc;
  };
  auto row_src = [&](size_t i, int d) {
    const int r = (int)(i / W);
    const int rr = r - d < 0 ? r - d + H : r - d;
    return i + (size_t)(rr - r) * W;
  };
  for (int it = 0; it < outer; ++it) {
    for (size_t i = i0; i < n; i += step)
      p[i] = __hmin(ld(x + i), ld(x + lane_src(i, a1)));
    grid_barrier(bar);
    for (size_t i = i0; i < n; i += step)
      q[i] = __hmin(ld(p + i), ld(p + lane_src(i, a2)));
    grid_barrier(bar);
    for (size_t i = i0; i < n; i += step)
      p[i] = __hmax(ld(q + i), ld(q + row_src(i, b1)));
    grid_barrier(bar);
    for (size_t i = i0; i < n; i += step)
      x[i] = __hsub(ld(x + i), __hmax(ld(p + i), ld(p + row_src(i, b2))));
    grid_barrier(bar);
  }
}

}  // namespace

extern "C" {

// out = the chain of `passes` passes of `body` over in, (H, W) of dtype
// code `dtype`.  boundary: 0 none (elementwise bodies), 1 circular (a roll
// by s1, s2 positions towards higher indices, each in [0, L)), 2 fill (a
// slice reading s1 positions ahead, `fill` past the end).  axis: 1 lanes
// (along a row), 0 sublanes (down a column).  c1, c2: the body's constants,
// rounded to the dtype.
int lt_shift_chain(const void* in, void* out, int H, int W, int dtype,
                   int body, int boundary, int axis, int s1, int s2,
                   int passes, double fill, double c1, double c2,
                   void* stream) {
  if (H < 1 || W < 1 || passes < 0 || s1 < 0 || s2 < 0 ||
      (axis != 0 && axis != 1))
    return (int)cudaErrorInvalidValue;
  const ChainArgs a{in, out, H, W, axis, passes, s1, s2, fill, c1, c2,
                    static_cast<cudaStream_t>(stream)};
  return (int)dispatch(a, dtype, body, boundary);
}

// out = bf16_morph_chain8 of in, `outer` outer steps (K / 4), lane shifts
// a1, a2 and row shifts b1, b2 (each reduced to [0, W) or [0, H)).  p, q:
// (H, W) bf16 scratch; bar: two zeroed uint32.  One cooperative launch,
// sized so that every CTA is resident.
int lt_shift_chain_2d(const void* in, void* out, void* p, void* q, void* bar,
                      int H, int W, int outer, int a1, int a2, int b1, int b2,
                      void* stream) {
  if (H < 1 || W < 1 || outer < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t n = (size_t)H * W;
  cudaError_t err =
      cudaMemcpyAsync(out, in, n * sizeof(bf16), cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  int dev = 0, sms = 1, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, shift_chain_2d_kernel, threads, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const size_t need = (n + threads - 1) / threads;
  const size_t fit = (size_t)per_sm * sms;
  const int blocks = (int)(need < fit ? need : fit);
  bf16* xo = static_cast<bf16*>(out);
  bf16* pp = static_cast<bf16*>(p);
  bf16* qq = static_cast<bf16*>(q);
  unsigned int* bb = static_cast<unsigned int*>(bar);
  void* args[] = {&xo, &pp, &qq, &H, &W, &outer, &a1, &a2, &b1, &b2, &bb};
  err = cudaLaunchCooperativeKernel((const void*)shift_chain_2d_kernel,
                                    dim3(blocks), dim3(threads), args, 0, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
