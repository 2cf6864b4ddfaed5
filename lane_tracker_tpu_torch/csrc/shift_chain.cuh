// The single-axis shift chains of csrc/shift_chain.cu (lt_shift_chain):
// the kernels, their plan and their launchers.  Each shift_chain_*.cu
// source instantiates the cases of its element types (its CASE list), so
// that nvcc builds them in parallel; shift_chain.cu dispatches to them.
// See shift_chain.cu for the design.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "common.cuh"

namespace lt_chain {

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
  kMorphChain8 = 9,  // lt_shift_chain_2d's chain (lt_shift_chain_plan only)
};
enum Bound { kNone = 0, kCircular = 1, kFill = 2 };
enum Dtype { kU8 = 0, kI8 = 1, kI16 = 2, kI32 = 3, kBf16 = 4, kF32 = 5 };

// Slots (32-bit words) a lane holds in registers, and the most warps a
// CTA holds.  A line takes at most kMaxLine elements.
constexpr int kRegs = 40;
constexpr int kMaxCtaWarps = 16;
constexpr int kMaxLine = 8192;
// The probes' packed-u16 pair reads p - kPairS1 and p - kPairS1 - 1.
constexpr int kPairS1 = 8;
// How a CTA runs its lines: orbit slots in registers within one warp
// (shuffles only), or plain order through shared buffers, across warps
// (one barrier a pass) or within one (its offsets known to the compiler).
enum Mode { kOrbitWarp = 0, kPlain = 1, kPlainWarp = 2 };

// ---- the dtype's arithmetic, one element --------------------------------

template <typename T>
__device__ __forceinline__ T t_add(T a, T b) {
  if constexpr (std::is_same_v<T, bf16>) return __hadd(a, b);
  else if constexpr (std::is_same_v<T, float>) return __fadd_rn(a, b);
  else return (T)((uint32_t)a + (uint32_t)b);
}
template <typename T>
__device__ __forceinline__ T t_min(T a, T b) {
  if constexpr (std::is_same_v<T, bf16>) return __hmin(a, b);
  else return b < a ? b : a;
}
template <typename T>
__device__ __forceinline__ bool t_gt(T a, T b) {
  if constexpr (std::is_same_v<T, bf16>) return __hgt(a, b);
  else return a > b;
}

// One pass of an elementwise body at one element (the elementwise kernel's
// ragged tail).
template <typename T, int kBody>
__device__ __forceinline__ T elem_body(T x, T c1, T c2) {
  if constexpr (kBody == kAddSelf) {
    return t_add(x, x);
  } else if constexpr (kBody == kMinadd) {
    return t_min(t_add(x, c1), x);
  } else if constexpr (kBody == kAddshift) {
    return t_add(t_add(x, (T)(x >> 1)), c1);
  } else {
    static_assert(kBody == kWhereAdd, "not an elementwise body");
    return t_gt(x, c1) ? x : t_add(x, c2);
  }
}

// ---- packed words --------------------------------------------------------

// kP elements of T in one 32-bit word, element i in bits [i * 32 / kP, ...),
// with the type's arithmetic on all of them at once.
template <typename T>
struct Lanes {
  static constexpr int kP = 4 / (int)sizeof(T);
  static constexpr int kBits = 8 * (int)sizeof(T);

  static __device__ __forceinline__ __nv_bfloat162 h2(uint32_t w) {
    __nv_bfloat162 h;
    memcpy(&h, &w, 4);
    return h;
  }
  static __device__ __forceinline__ uint32_t w2(__nv_bfloat162 h) {
    uint32_t w;
    memcpy(&w, &h, 4);
    return w;
  }
  static __device__ __forceinline__ float f(uint32_t w) {
    return __uint_as_float(w);
  }

  static __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
    if constexpr (kP == 4) return __vadd4(a, b);
    else if constexpr (std::is_same_v<T, int16_t>) return __vadd2(a, b);
    else if constexpr (std::is_same_v<T, bf16>) return w2(__hadd2(h2(a), h2(b)));
    else if constexpr (std::is_same_v<T, float>)
      return __float_as_uint(__fadd_rn(f(a), f(b)));
    else return a + b;
  }
  static __device__ __forceinline__ uint32_t min(uint32_t a, uint32_t b) {
    if constexpr (std::is_same_v<T, uint8_t>) return __vminu4(a, b);
    else if constexpr (std::is_same_v<T, int8_t>) return __vmins4(a, b);
    else if constexpr (std::is_same_v<T, int16_t>) return __vmins2(a, b);
    else if constexpr (std::is_same_v<T, bf16>) return w2(__hmin2(h2(a), h2(b)));
    else if constexpr (std::is_same_v<T, float>)
      return f(b) < f(a) ? b : a;
    else return (int32_t)b < (int32_t)a ? b : a;
  }
  static __device__ __forceinline__ uint32_t max(uint32_t a, uint32_t b) {
    if constexpr (std::is_same_v<T, uint8_t>) return __vmaxu4(a, b);
    else if constexpr (std::is_same_v<T, int8_t>) return __vmaxs4(a, b);
    else if constexpr (std::is_same_v<T, int16_t>) return __vmaxs2(a, b);
    else if constexpr (std::is_same_v<T, bf16>) return w2(__hmax2(h2(a), h2(b)));
    else if constexpr (std::is_same_v<T, float>)
      return f(a) < f(b) ? b : a;
    else return (int32_t)a < (int32_t)b ? b : a;
  }
  static __device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) {
    static_assert(std::is_same_v<T, bf16>, "only bf16 multiplies");
    return w2(__hmul2(h2(a), h2(b)));
  }
  // x > c ? x : x + d, each element.
  static __device__ __forceinline__ uint32_t where_add(uint32_t x, uint32_t c,
                                                       uint32_t d) {
    if constexpr (std::is_same_v<T, int16_t>) {
      const uint32_t m = __vcmpgts2(x, c);
      return (x & m) | (__vadd2(x, d) & ~m);
    } else {
      static_assert(std::is_same_v<T, bf16>, "where_add: int16 or bf16");
      const __nv_bfloat162 hx = h2(x), hc = h2(c);
      const __nv_bfloat162 s = __hadd2(hx, h2(d));
      const bf16 lo = __hgt(hx.x, hc.x) ? hx.x : s.x;
      const bf16 hi = __hgt(hx.y, hc.y) ? hx.y : s.y;
      return w2(__halves2bfloat162(lo, hi));
    }
  }
};

template <typename T>
__host__ __device__ __forceinline__ uint32_t raw_bits(T v) {
  if constexpr (sizeof(T) == 1) {
    uint8_t b;
    memcpy(&b, &v, 1);
    return b;
  } else if constexpr (sizeof(T) == 2) {
    uint16_t b;
    memcpy(&b, &v, 2);
    return b;
  } else {
    uint32_t b;
    memcpy(&b, &v, 4);
    return b;
  }
}

// One value in every element of a word.
template <typename T>
uint32_t splat(T v) {
  const uint32_t b = raw_bits(v);
  if constexpr (sizeof(T) == 1) return b * 0x01010101u;
  else if constexpr (sizeof(T) == 2) return b | (b << 16);
  else return b;
}

// One pass of a shift body on a word: x the slot, a its (first) neighbour.
template <typename T, int kBody>
__device__ __forceinline__ uint32_t shift_body(uint32_t x, uint32_t a,
                                               uint32_t c1) {
  using Ln = Lanes<T>;
  if constexpr (kBody == kAdd) return Ln::add(x, a);
  else if constexpr (kBody == kMin) return Ln::min(x, a);
  else if constexpr (kBody == kMax) return Ln::max(x, a);
  else {
    static_assert(kBody == kMinMulMax, "not a one-shift body");
    return Ln::max(Ln::min(x, a), Ln::mul(x, c1));
  }
}

// The packed-u16 pair body on int32: a, b the values at p - s1, p - s2.
__device__ __forceinline__ uint32_t packed_body(uint32_t x, uint32_t a,
                                                uint32_t b) {
  const uint32_t odd = (uint32_t)((int32_t)x >> 16) | (b << 16);
  return x + odd + a;
}

// An 8-bit word's halves: bytes 0 and 2, and bytes 1 and 3, each byte in a
// 16-bit lane (int8 sign-extended); __byte_perm(lo, hi, 0x6240) joins them.
template <typename T>
struct Halves {
  static __device__ __forceinline__ uint32_t lo(uint32_t w) {
    return __byte_perm(w, 0, std::is_signed_v<T> ? 0xA280 : 0x4240);
  }
  static __device__ __forceinline__ uint32_t hi(uint32_t w) {
    return __byte_perm(w, 0, std::is_signed_v<T> ? 0xB391 : 0x4341);
  }
};

// One pass of a shift body on a half: two 8-bit values in 16-bit lanes.
template <typename T, int kBody>
__device__ __forceinline__ uint32_t half_body(uint32_t x, uint32_t a) {
  constexpr bool kSigned = std::is_signed_v<T>;
  if constexpr (kBody == kMin) {
    return kSigned ? __vmins2(x, a) : __vminu2(x, a);
  } else if constexpr (kBody == kMax) {
    return kSigned ? __vmaxs2(x, a) : __vmaxu2(x, a);
  } else {
    static_assert(kBody == kAdd, "an 8-bit body: add, min or max");
    // The sum's low byte in each lane (sign-extended for int8).
    const uint32_t sum = (x + a) & 0x00ff00ffu;
    return kSigned ? __byte_perm(sum, 0, 0xA280) : sum;
  }
}

template <typename T, int kBody>
__device__ __forceinline__ uint32_t word_body(uint32_t x, uint32_t c1,
                                              uint32_t c2) {
  using Ln = Lanes<T>;
  if constexpr (kBody == kAddSelf) {
    // x + x per element: a left shift with each element's carry dropped.
    if constexpr (Ln::kP == 2) return (x << 1) & 0xfffefffeu;
    else return Ln::add(x, x);
  } else if constexpr (kBody == kMinadd) {
    return Ln::min(Ln::add(x, c1), x);
  } else if constexpr (kBody == kAddshift) {
    return x + (uint32_t)((int32_t)x >> 1) + c1;
  } else {
    static_assert(kBody == kWhereAdd, "not an elementwise body");
    return Ln::where_add(x, c1, c2);
  }
}

// ---- the orbit plan of one line -------------------------------------------

__host__ __device__ inline int gcd_int(int a, int b) {
  while (b != 0) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// A line of L elements under a constant shift s.  Roll (s in [0, L)): the
// gcd(s, L) cycles of n = L / gcd elements, cycle c listed c, c - s,
// c - 2s, ... (mod L), each on lpc lanes of its own from register 0 (the
// rest of its last lane is padding).  Slice: the residue classes mod
// s' = min(s, L), class o listed o, o + s', ..., one after another with no
// padding; the first L % s' classes hold L / s' + 1 slots, the rest L / s'.
// A slice by 0 reads the element itself, as a roll by 0 does.
struct Orbits {
  int L, s, roll, periodic;
  int n, lpc;  // roll: cycle length, lanes a cycle
  int a, b;    // slice: L / s', L % s'
  int lanes;
};

__host__ __device__ inline Orbits make_orbits(int L, int s, bool roll,
                                              int passes) {
  Orbits o{};
  o.L = L;
  if (roll || s == 0) {
    o.roll = 1;
    o.s = s;
    o.n = L / gcd_int(s, L);
    const int g = L / o.n;
    o.lpc = (o.n + kRegs - 1) / kRegs;
    // Periodic where the cycles, each on as many lanes as one warp gives
    // them, hold at least `passes` padding slots.
    const int wide = 32 / g;
    if (o.lpc * kRegs - o.n >= passes) {
      o.periodic = 1;
    } else if (wide * kRegs - o.n >= passes && wide >= o.lpc) {
      o.lpc = wide;
      o.periodic = 1;
    }
    o.lanes = g * o.lpc;
  } else {
    o.roll = 0;
    o.s = s < L ? s : L;
    o.a = L / o.s;
    o.b = L % o.s;
    o.lanes = (L + kRegs - 1) / kRegs;
  }
  return o;
}

// A lane's slots in order: next() gives the line position of slot r = 0,
// 1, ... (-1 for padding) and whether the slot is its orbit's last (it
// reads the fill, or its cycle's first slot, instead of the next slot).
// One division for the lane's first slot, then steps.
// With `extend` (a roll), a cycle's padding slots continue the cycle
// (slot j holds element j mod n) and no slot is an end.
struct OrbitCursor {
  int L, s, n, j, p, orb, len, a, b;
  bool roll, live, extend;

  __device__ __forceinline__ OrbitCursor(const Orbits& o, int lane,
                                         bool extend_ = false)
      : L(o.L), s(o.s), roll(o.roll != 0), live(lane < o.lanes),
        extend(extend_) {
    if (!live) return;
    if (roll) {
      const int c = lane / o.lpc;
      n = o.n;
      j = (lane - c * o.lpc) * kRegs;
      const int q = (j * s) % L;  // j, s < 8192: no overflow
      p = c - q < 0 ? c - q + L : c - q;
    } else {
      a = o.a;
      b = o.b;
      j = lane * kRegs;  // slot index of the line, then the orbit's
      if (j >= L) {
        live = false;
        return;
      }
      const int head = b * (a + 1);
      if (j < head) {
        orb = j / (a + 1);
        j -= orb * (a + 1);
      } else {
        orb = b + (j - head) / a;
        j -= head + (orb - b) * a;
      }
      len = orb < b ? a + 1 : a;
      p = orb + j * s;
    }
  }

  __device__ __forceinline__ int next(bool* end) {
    *end = false;
    if (!live) return -1;
    const int pos = p;
    if (roll) {
      if (j >= n && !extend) return -1;
      *end = !extend && j == n - 1;
      ++j;
      p = p - s < 0 ? p - s + L : p - s;
      return pos;
    }
    if (orb >= s) return -1;  // past the line's last slot
    *end = j == len - 1;
    if (*end) {
      ++orb;
      j = 0;
      len = orb < b ? a + 1 : a;
      p = orb;
    } else {
      ++j;
      p += s;
    }
    return pos;
  }
};

// The lane whose register 0 a lane's last register reads: the next lane,
// or for a cycle's last lane its first (the wrap).
__device__ __forceinline__ int orbit_src(const Orbits& o, int lane) {
  if (lane >= o.lanes) return lane;
  if (o.roll) {
    const int c = lane / o.lpc;
    return lane - c * o.lpc == o.lpc - 1 ? c * o.lpc : lane + 1;
  }
  return lane + 1 < o.lanes ? lane + 1 : lane;
}

// ---- lt_shift_chain: the shift bodies ---------------------------------------

struct LineArgs {
  int H, W, passes, s1, s2;
  int pl_log;  // a CTA holds 1 << pl_log packed lines
  int nw;      // warps a packed line spans
  uint32_t fill, c1;
};

__host__ __device__ __forceinline__ int align4(int n) { return (n + 3) & ~3; }

// Words a row of a sublane strip takes in shared memory: odd, so that the
// lanes' reads of rows kRegs * s apart fall in different banks.
__host__ __device__ __forceinline__ int strip_pitch(int pl) {
  return pl == 1 ? 1 : pl + 1;
}

// A sublane strip's word i sits at shared word skew(i): one spare word
// every 32, so that the lanes' orbit-order reads and writes, kRegs * s rows
// apart, spread over the banks.
__host__ __device__ __forceinline__ int skew(int i) { return i + (i >> 5); }

// Shared words of the staged lines (see shift_chain_kernel).
__host__ __device__ __forceinline__ int tile_words(int axis, int L, int pl) {
  return align4(axis == 1 ? pl * L : skew(L * strip_pitch(pl) - 1) + 1);
}

// dst(i) = src(i) for i in [tid, n) by nthreads, kU loads in flight a
// thread (a CTA of one or a few warps would otherwise wait out one
// device-memory latency a word).  A row of the probes' block staged as
// 16-byte words takes 10 a thread, a sublane strip 9 (four words a row)
// or 35 words.
constexpr int kStageVec = 10;
constexpr int kStageWords = 18;
template <int kU, typename Ld, typename St>
__device__ __forceinline__ void copy_batched(int n, int tid, int nthreads,
                                             Ld ld, St st) {
  for (int base = tid; base < n; base += kU * nthreads) {
    decltype(ld(0)) t[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = base + u * nthreads;
      if (i < n) t[u] = ld(i);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = base + u * nthreads;
      if (i < n) st(i, t[u]);
    }
  }
}

// Grid: one CTA per 1 << pl_log packed lines of kP lines each (kAxis 1: rows
// of W elements; kAxis 0: columns of H elements); block (1 << pl_log) * nw
// warps, warp w on packed line w / nw.  Shared memory: the CTA's lines
// staged (kAxis 1: line i at element i * L; kAxis 0: a strip, row p at
// word p * strip_pitch, word i at skew(i)), then the plain order's
// buffers (kPlain: 2 x (kRegs words a lane and L) a packed line;
// kPlainWarp: 2 x kRegs words a lane), from a 16-byte boundary.
// A CTA of the one-warp modes holds at most 8 lines (256 threads), so
// their registers may go to 255; a line across warps may take 16 warps.
template <typename T, int kBody, int kBound, int kAxis, int kMode>
__global__ void __launch_bounds__(kMode == kOrbitWarp || kMode == kPlainWarp
                                      ? 256
                                      : 512)
    shift_chain_kernel(const T* __restrict__ in, T* __restrict__ out,
                       LineArgs a) {
  constexpr int kP = Lanes<T>::kP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = kAxis == 1 ? a.W : a.H;
  const int n_lines = kAxis == 1 ? a.H : a.W;
  const int pl = 1 << a.pl_log;
  const int NL = pl * kP;
  const int line0 = blockIdx.x * NL;
  const int nvalid = min(NL, n_lines - line0);
  const int tp = strip_pitch(pl);  // kAxis 0: words a staged row
  uint32_t* tile_w = reinterpret_cast<uint32_t*>(smem_raw);
  T* tile = reinterpret_cast<T*>(smem_raw);
  uint32_t* extra = tile_w + tile_words(kAxis, L, pl);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  // Stage the lines in: 16-byte words where aligned (kAxis 1), 4-byte
  // words (kAxis 0), else elements.
  if constexpr (kAxis == 1) {
    const int n = nvalid * L;
    const T* src = in + (size_t)line0 * L;
    if ((n * sizeof(T)) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(src) % 16 == 0) {
      const uint4* s4 = reinterpret_cast<const uint4*>(src);
      uint4* t4 = reinterpret_cast<uint4*>(tile);
      copy_batched<kStageVec>(n * (int)sizeof(T) / 16, tid, nthreads,
                      [&](int i) { return s4[i]; },
                      [&](int i, uint4 x) { t4[i] = x; });
    } else {
      copy_batched<8>(n, tid, nthreads, [&](int i) { return src[i]; },
                      [&](int i, T x) { tile[i] = x; });
    }
  } else {
    if (nvalid == NL && pl >= 4 && (a.W * sizeof(T)) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(in) % 16 == 0) {
      // A strip row's words by 16 bytes.
      const uint4* s = reinterpret_cast<const uint4*>(in);
      const int pitch = a.W * (int)sizeof(T) / 16;
      const int col = line0 * (int)sizeof(T) / 16;
      const int q_log = a.pl_log - 2;  // 16-byte words a row, as a shift
      copy_batched<kStageVec>(
          L << q_log, tid, nthreads,
          [&](int e) {
            const int p = e >> q_log;
            return s[(size_t)p * pitch + col + (e - (p << q_log))];
          },
          [&](int e, uint4 x) {
            const int p = e >> q_log;
            const int w = p * tp + 4 * (e - (p << q_log));
            tile_w[skew(w)] = x.x;
            tile_w[skew(w + 1)] = x.y;
            tile_w[skew(w + 2)] = x.z;
            tile_w[skew(w + 3)] = x.w;
          });
    } else if (nvalid == NL && (a.W * sizeof(T)) % 4 == 0 &&
               reinterpret_cast<uintptr_t>(in) % 4 == 0) {
      const uint32_t* s = reinterpret_cast<const uint32_t*>(in);
      const int pitch = a.W * (int)sizeof(T) / 4;
      const int col = line0 * (int)sizeof(T) / 4;
      copy_batched<kStageWords>(
          L << a.pl_log, tid, nthreads,
          [&](int e) {
            const int p = e >> a.pl_log;
            return s[(size_t)p * pitch + col + (e - (p << a.pl_log))];
          },
          [&](int e, uint32_t x) {
            const int p = e >> a.pl_log;
            tile_w[skew(p * tp + (e - (p << a.pl_log)))] = x;
          });
    } else {
      T zero;
      memset(&zero, 0, sizeof(T));
      copy_batched<8>(
          L * NL, tid, nthreads,
          [&](int e) {
            const int p = e / NL;
            const int li = e - p * NL;
            return li < nvalid ? in[(size_t)p * a.W + line0 + li] : zero;
          },
          [&](int e, T x) {
            const int p = e / NL;
            const int b = (p * tp * kP + e - p * NL) * (int)sizeof(T);
            *reinterpret_cast<T*>(smem_raw + 4 * skew(b >> 2) + (b & 3)) = x;
          });
    }
  }
  __syncthreads();

  const int warp = tid >> 5;
  const int k = warp / a.nw;  // packed line of the CTA
  const int lane = (warp - k * a.nw) * 32 + (tid & 31);  // lane of the line
  const int line_lanes = a.nw * 32;
  auto load = [&](int p) -> uint32_t {
    if constexpr (kAxis == 0) {
      return tile_w[skew(p * tp + k)];
    } else {
      uint32_t w = 0;
#pragma unroll
      for (int i = 0; i < kP; ++i)
        w |= raw_bits(tile[(k * kP + i) * L + p]) << (i * Lanes<T>::kBits);
      return w;
    }
  };
  auto store = [&](int p, uint32_t w) {
    if constexpr (kAxis == 0) {
      tile_w[skew(p * tp + k)] = w;
    } else {
#pragma unroll
      for (int i = 0; i < kP; ++i) {
        const uint32_t b = w >> (i * Lanes<T>::kBits);
        T v;
        memcpy(&v, &b, sizeof(T));
        tile[(k * kP + i) * L + p] = v;
      }
    }
  };

  uint32_t v[kRegs];
  // Plain order in one warp: slot r of lane l is position q = 32 r + l.
  // Each pass writes the line to one of two buffers, meets the warp's
  // barrier, and reads each neighbour back, eight slots' loads issued
  // before their use; a roll's index wraps by one add.
  auto plain_warp = [&]() {
    constexpr int kGroup = 8;
    const int sf = a.s1 < L ? a.s1 : L;
#pragma unroll
    for (int r = 0; r < kRegs; ++r) {
      const int q = r * 32 + lane;
      v[r] = q < L ? load(q) : 0u;
    }
    uint32_t* bufs = extra + (size_t)k * 2 * 32 * kRegs;
    for (int it = 0; it < a.passes; ++it) {
      uint32_t* b = bufs + (it & 1) * 32 * kRegs;
#pragma unroll
      for (int r = 0; r < kRegs; ++r) b[r * 32 + lane] = v[r];
      __syncwarp();
#pragma unroll
      for (int g = 0; g < kRegs; g += kGroup) {
        uint32_t n1[kGroup], n2[kGroup];
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          const int q = (g + j) * 32 + lane;
          if constexpr (kBound == kCircular) {
            const int i1 = q - a.s1;
            n1[j] = b[i1 < 0 ? i1 + L : i1];
            if constexpr (kBody == kPacked) {
              const int i2 = q - a.s2;
              n2[j] = b[i2 < 0 ? i2 + L : i2];
            }
          } else {
            n1[j] = q + sf < L ? b[q + sf] : a.fill;
          }
        }
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          if constexpr (kBody == kPacked)
            v[g + j] = packed_body(v[g + j], n1[j], n2[j]);
          else
            v[g + j] = shift_body<T, kBody>(v[g + j], n1[j], a.c1);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRegs; ++r) {
      const int q = r * 32 + lane;
      if (q < L) store(q, v[r]);
    }
  };
  if constexpr (kMode == kPlainWarp && kBody == kPacked) {
    if (a.s1 == kPairS1 && a.s2 == kPairS1 + 1 && L == 32 * kRegs) {
      // The probes' pair (p - 8, p - 9) on a line of 32 runs: lane l
      // holds positions 40 l .. 40 l + 39, both neighbours in its own
      // registers but for the first nine, which the previous lane's last
      // nine bring by shuffles (lane 0's from lane 31: the roll).
#pragma unroll
      for (int r = 0; r < kRegs; ++r) v[r] = load(lane * kRegs + r);
      const int prev = (lane + 31) & 31;
      for (int it = 0; it < a.passes; ++it) {
        uint32_t u[kPairS1 + 1];
#pragma unroll
        for (int i = 0; i <= kPairS1; ++i)
          u[i] = __shfl_sync(0xffffffffu, v[kRegs - kPairS1 - 1 + i], prev);
#pragma unroll
        for (int r = kRegs - 1; r >= 0; --r) {
          const uint32_t n1 = r >= kPairS1 ? v[r - kPairS1] : u[r + 1];
          const uint32_t n2 = r > kPairS1 ? v[r - kPairS1 - 1] : u[r];
          v[r] = packed_body(v[r], n1, n2);
        }
      }
#pragma unroll
      for (int r = 0; r < kRegs; ++r) store(lane * kRegs + r, v[r]);
    } else {
      plain_warp();
    }
  } else if constexpr (kMode == kPlainWarp) {
    plain_warp();
  } else if constexpr (kMode == kPlain) {
    // Plain order, interleaved: slot r of lane l is position
    // q = r * line_lanes + l, so a warp's shared accesses are consecutive
    // words.  Each pass writes the line to one of two buffers, meets one
    // barrier, and reads each neighbour back at a fixed offset, with no test: a roll's buffer
    // holds the line twice (q at q and q + L), so p - s is q + L - s, and
    // the slots past the line hold it again (position q mod L), so that
    // their writes agree; a slice's buffer holds the fill past the line,
    // so p + s is q + min(s, L), and the slots past the line write past
    // the fill.
    const int span = line_lanes * kRegs + L;  // words a buffer
    const int sf = a.s1 < L ? a.s1 : L;
#pragma unroll
    for (int r = 0; r < kRegs; ++r) {
      const int q = r * line_lanes + lane;
      v[r] = kBound == kCircular ? load(q % L) : (q < L ? load(q) : 0u);
    }
    uint32_t* bufs = extra + (size_t)k * 2 * span;
    if constexpr (kBound == kFill) {
      for (int i = lane; i < sf; i += line_lanes) {
        bufs[L + i] = a.fill;
        bufs[span + L + i] = a.fill;
      }
    }
    for (int it = 0; it < a.passes; ++it) {
      uint32_t* b = bufs + (it & 1) * span;
#pragma unroll
      for (int r = 0; r < kRegs; ++r) {
        const int q = r * line_lanes + lane;
        if constexpr (kBound == kCircular) {
          b[q] = v[r];
          b[q + L] = v[r];
        } else {
          b[q < L ? q : q + sf] = v[r];
        }
      }
      __syncthreads();
      if constexpr (kBody == kPacked) {
        const uint32_t* n1 = b + lane + L - a.s1;
        const uint32_t* n2 = b + lane + L - a.s2;
#pragma unroll
        for (int r = 0; r < kRegs; ++r)
          v[r] = packed_body(v[r], n1[r * line_lanes], n2[r * line_lanes]);
      } else {
        const uint32_t* n1 =
            b + lane + (kBound == kCircular ? L - a.s1 : sf);
#pragma unroll
        for (int r = 0; r < kRegs; ++r)
          v[r] = shift_body<T, kBody>(v[r], n1[r * line_lanes], a.c1);
      }
    }
#pragma unroll
    for (int r = 0; r < kRegs; ++r) {
      const int q = r * line_lanes + lane;
      if (q < L) store(q, v[r]);
    }
  } else if constexpr (kBody != kPacked) {
    // Orbit order: every slot reads the next one (register r + 1, the next
    // lane's register 0 for the last), an orbit's end the wrap value (a
    // roll's: its cycle's register 0, fetched by the same shuffle) or the
    // fill.  The plan leaves at most one end a lane (rend; -1 for none).
    // A roll whose cycles' padding slots are at least as many as the
    // passes needs no end at all: the padding continues each cycle, the
    // wrong value its last slot reads (the cycle's first) travels back one
    // slot a pass and reaches no slot of the cycle proper.
    const Orbits o = make_orbits(L, a.s1, kBound == kCircular, a.passes);
    int rend = -1;
    OrbitCursor cur(o, lane, o.periodic != 0);
#pragma unroll
    for (int r = 0; r < kRegs; ++r) {
      bool e;
      const int p = cur.next(&e);
      v[r] = p >= 0 ? load(p) : 0u;
      if (e) rend = r;
    }
    // The next lane's register 0 (for a roll's cycle end: its first lane's).
    const int src = orbit_src(o, lane);
    const bool last_end = rend == kRegs - 1;
    const bool no_select = __all_sync(0xffffffffu, rend < 0 || last_end);
    // All passes on one array of words: body(x, neighbour), the fill in
    // the words' form.
    auto run = [&](uint32_t(&vv)[kRegs], auto body, uint32_t fill) {
      if (no_select) {
        // No end before the last register in the warp: no selects.
        for (int it = 0; it < a.passes; ++it) {
          const uint32_t sh = __shfl_sync(0xffffffffu, vv[0], src);
          const uint32_t w = kBound == kCircular ? sh : fill;
#pragma unroll
          for (int r = 0; r < kRegs - 1; ++r) vv[r] = body(vv[r], vv[r + 1]);
          vv[kRegs - 1] = body(vv[kRegs - 1], last_end ? w : sh);
        }
      } else {
        for (int it = 0; it < a.passes; ++it) {
          const uint32_t sh = __shfl_sync(0xffffffffu, vv[0], src);
          const uint32_t w = kBound == kCircular ? sh : fill;
#pragma unroll
          for (int r = 0; r < kRegs - 1; ++r)
            vv[r] = body(vv[r], r == rend ? w : vv[r + 1]);
          vv[kRegs - 1] = body(vv[kRegs - 1], last_end ? w : sh);
        }
      }
    };
    if constexpr (sizeof(T) == 1) {
      // 8-bit lines in two halves of 16-bit lanes (bytes 0 and 2, bytes 1
      // and 3), where min and max are single instructions; each half runs
      // all passes on its own.
      uint32_t hi[kRegs];
#pragma unroll
      for (int r = 0; r < kRegs; ++r) {
        hi[r] = Halves<T>::hi(v[r]);
        v[r] = Halves<T>::lo(v[r]);
      }
      auto body = [](uint32_t x, uint32_t n) {
        return half_body<T, kBody>(x, n);
      };
      run(v, body, Halves<T>::lo(a.fill));
      run(hi, body, Halves<T>::hi(a.fill));
#pragma unroll
      for (int r = 0; r < kRegs; ++r) v[r] = __byte_perm(v[r], hi[r], 0x6240);
    } else {
      run(v, [&](uint32_t x, uint32_t n) {
        return shift_body<T, kBody>(x, n, a.c1);
      }, a.fill);
    }
    OrbitCursor out_cur(o, lane);
#pragma unroll
    for (int r = 0; r < kRegs; ++r) {
      bool e;
      const int p = out_cur.next(&e);
      if (p >= 0) store(p, v[r]);
    }
  }
  __syncthreads();

  // Stage the lines out, as they came in.
  if constexpr (kAxis == 1) {
    const int n = nvalid * L;
    T* dst = out + (size_t)line0 * L;
    if ((n * sizeof(T)) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
      const uint4* t4 = reinterpret_cast<const uint4*>(tile);
      uint4* d4 = reinterpret_cast<uint4*>(dst);
      copy_batched<kStageVec>(n * (int)sizeof(T) / 16, tid, nthreads,
                      [&](int i) { return t4[i]; },
                      [&](int i, uint4 x) { d4[i] = x; });
    } else {
      copy_batched<8>(n, tid, nthreads, [&](int i) { return tile[i]; },
                      [&](int i, T x) { dst[i] = x; });
    }
  } else {
    if (nvalid == NL && pl >= 4 && (a.W * sizeof(T)) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(out) % 16 == 0) {
      uint4* d = reinterpret_cast<uint4*>(out);
      const int pitch = a.W * (int)sizeof(T) / 16;
      const int col = line0 * (int)sizeof(T) / 16;
      const int q_log = a.pl_log - 2;
      copy_batched<kStageVec>(
          L << q_log, tid, nthreads,
          [&](int e) {
            const int p = e >> q_log;
            const int w = p * tp + 4 * (e - (p << q_log));
            return make_uint4(tile_w[skew(w)], tile_w[skew(w + 1)],
                              tile_w[skew(w + 2)], tile_w[skew(w + 3)]);
          },
          [&](int e, uint4 x) {
            const int p = e >> q_log;
            d[(size_t)p * pitch + col + (e - (p << q_log))] = x;
          });
    } else if (nvalid == NL && (a.W * sizeof(T)) % 4 == 0 &&
               reinterpret_cast<uintptr_t>(out) % 4 == 0) {
      uint32_t* d = reinterpret_cast<uint32_t*>(out);
      const int pitch = a.W * (int)sizeof(T) / 4;
      const int col = line0 * (int)sizeof(T) / 4;
      copy_batched<kStageWords>(
          L << a.pl_log, tid, nthreads,
          [&](int e) {
            const int p = e >> a.pl_log;
            return tile_w[skew(p * tp + (e - (p << a.pl_log)))];
          },
          [&](int e, uint32_t x) {
            const int p = e >> a.pl_log;
            d[(size_t)p * pitch + col + (e - (p << a.pl_log))] = x;
          });
    } else {
      for (int e = tid; e < L * NL; e += nthreads) {
        const int p = e / NL;
        const int li = e - p * NL;
        const int b = (p * tp * kP + li) * (int)sizeof(T);
        if (li < nvalid)
          out[(size_t)p * a.W + line0 + li] = *reinterpret_cast<const T*>(
              smem_raw + 4 * skew(b >> 2) + (b & 3));
      }
    }
  }
}

// ---- lt_shift_chain: the elementwise bodies ----------------------------------

constexpr int kEwThreads = 128;
constexpr int kEwVec = 2;  // 16-byte words a thread

// Each thread keeps kEwVec 16-byte words (8 packed words) of the block in
// registers for all passes; the elements past the last whole 16-byte word
// (all of them where in or out is not 16-byte aligned) take the scalar
// body, a grid-stride loop.
template <typename T, int kBody>
__global__ void __launch_bounds__(kEwThreads)
    elementwise_kernel(const T* __restrict__ in, T* __restrict__ out,
                       long long n, long long nvec, int passes, uint32_t c1w,
                       uint32_t c2w, T c1, T c2) {
  const long long base =
      (long long)blockIdx.x * kEwVec * kEwThreads + threadIdx.x;
  const uint4* in4 = reinterpret_cast<const uint4*>(in);
  uint4* out4 = reinterpret_cast<uint4*>(out);
  uint4 v[kEwVec];
#pragma unroll
  for (int j = 0; j < kEwVec; ++j) {
    const long long i = base + j * kEwThreads;
    v[j] = i < nvec ? in4[i] : make_uint4(0, 0, 0, 0);
  }
  for (int it = 0; it < passes; ++it) {
#pragma unroll
    for (int j = 0; j < kEwVec; ++j) {
      v[j].x = word_body<T, kBody>(v[j].x, c1w, c2w);
      v[j].y = word_body<T, kBody>(v[j].y, c1w, c2w);
      v[j].z = word_body<T, kBody>(v[j].z, c1w, c2w);
      v[j].w = word_body<T, kBody>(v[j].w, c1w, c2w);
    }
  }
#pragma unroll
  for (int j = 0; j < kEwVec; ++j) {
    const long long i = base + j * kEwThreads;
    if (i < nvec) out4[i] = v[j];
  }
  const long long stride = (long long)gridDim.x * kEwThreads;
  for (long long e = nvec * (16 / (long long)sizeof(T)) +
                     (long long)blockIdx.x * kEwThreads + threadIdx.x;
       e < n; e += stride) {
    T x = in[e];
    for (int it = 0; it < passes; ++it) x = elem_body<T, kBody>(x, c1, c2);
    out[e] = x;
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

inline int sm_count() {
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

template <typename T, int kBody>
cudaError_t launch_elementwise(const ChainArgs& a) {
  const long long n = (long long)a.H * a.W;
  const bool vec = reinterpret_cast<uintptr_t>(a.in) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.out) % 16 == 0;
  const long long nvec = vec ? n * (long long)sizeof(T) / 16 : 0;
  const long long tail = n - nvec * (16 / (long long)sizeof(T));
  const long long per_block = (long long)kEwVec * kEwThreads;
  long long blocks = (nvec + per_block - 1) / per_block;
  const long long tail_blocks = (tail + kEwThreads - 1) / kEwThreads;
  if (tail_blocks > blocks) blocks = tail_blocks < 65535 ? tail_blocks : 65535;
  if (blocks < 1) blocks = 1;
  const T c1 = from_double<T>(a.c1), c2 = from_double<T>(a.c2);
  elementwise_kernel<T, kBody><<<(unsigned)blocks, kEwThreads, 0, a.stream>>>(
      static_cast<const T*>(a.in), static_cast<T*>(a.out), n, nvec, a.passes,
      splat(c1), splat(c2), c1, c2);
  return lt::filter_stage_launched();
}

// The CTA shape of a shift chain: the mode, the lanes and warps a line
// spans, and the packed lines a CTA holds (as many as keep two CTAs an SM
// at least, up to 8, within kMaxCtaWarps and the shared memory a CTA may
// take).
struct LinePlan {
  int mode, lanes, nw, pl_log;
  size_t smem;
  int grid;
};

inline size_t line_smem(int mode, int axis, int L, int nw, int pl) {
  size_t words = (size_t)tile_words(axis, L, pl);
  if (mode == kPlain) words += (size_t)pl * 2 * (nw * 32 * kRegs + L);
  if (mode == kPlainWarp) words += (size_t)pl * 2 * 32 * kRegs;
  return words * 4;
}

// Orbit order where the line's orbits fit one warp's lanes, leave at most
// one orbit end a lane and waste less than half the slots; else plain
// order: the packed-u16 body, slices whose orbits are shorter than a
// lane's run, lines whose orbits need more than 32 lanes, and rolls whose
// cycles need twice the plain order's lanes.
inline LinePlan line_plan(int body, int bound, int axis, int L, int elem,
                          int s1, int passes, int n_lines, int sms) {
  const int kp = 4 / elem;
  LinePlan p{};
  const Orbits o = make_orbits(L, s1, bound == kCircular, passes);
  const int plain_lanes = (L + kRegs - 1) / kRegs;
  p.lanes = o.lanes;
  p.mode = kOrbitWarp;
  if (body == kPacked || (!o.roll && o.a < kRegs) || p.lanes > 32 ||
      p.lanes > 2 * plain_lanes) {
    p.lanes = plain_lanes;
    p.mode = p.lanes > 32 ? kPlain : kPlainWarp;
  }
  p.nw = (p.lanes + 31) / 32;
  const int n_pl = (n_lines + kp - 1) / kp;
  p.pl_log = 0;
  for (int lg = 3; lg > 0; --lg) {
    const int pl = 1 << lg;
    if ((n_pl + pl - 1) / pl >= 2 * sms && p.nw * pl <= kMaxCtaWarps &&
        line_smem(p.mode, axis, L, p.nw, pl) <= 227 * 1024) {
      p.pl_log = lg;
      break;
    }
  }
  p.smem = line_smem(p.mode, axis, L, p.nw, 1 << p.pl_log);
  p.grid = (n_pl + (1 << p.pl_log) - 1) >> p.pl_log;
  return p;
}

template <typename T, int kBody, int kBound, int kAxis, int kMode>
cudaError_t run_line(const ChainArgs& a, const LinePlan& p,
                     const LineArgs& la) {
  auto kernel = shift_chain_kernel<T, kBody, kBound, kAxis, kMode>;
  const cudaError_t err = lt::allow_smem(kernel, p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<p.grid, (32 * p.nw) << p.pl_log, p.smem, a.stream>>>(
      static_cast<const T*>(a.in), static_cast<T*>(a.out), la);
  return lt::filter_stage_launched();
}

template <typename T, int kBody, int kBound, int kAxis>
cudaError_t launch_chain(const ChainArgs& a) {
  if constexpr (kBound == kNone) {
    return launch_elementwise<T, kBody>(a);
  } else {
    const int L = kAxis == 1 ? a.W : a.H;
    const int n_lines = kAxis == 1 ? a.H : a.W;
    if (L > kMaxLine) return cudaErrorInvalidValue;
    const LinePlan p =
        line_plan(kBody, kBound, kAxis, L, (int)sizeof(T), a.s1, a.passes,
                  n_lines, sm_count());
    uint32_t c1 = 0;
    if constexpr (kBody == kMinMulMax) c1 = splat(from_double<T>(a.c1));
    const LineArgs la{a.H,      a.W,  a.passes,
                      a.s1,     a.s2, p.pl_log,
                      p.nw,     splat(from_double<T>(a.fill)), c1};
    if constexpr (kBody == kPacked) {
      if (p.mode == kPlainWarp)
        return run_line<T, kBody, kBound, kAxis, kPlainWarp>(a, p, la);
      return run_line<T, kBody, kBound, kAxis, kPlain>(a, p, la);
    } else {
      if (p.mode == kPlainWarp)
        return run_line<T, kBody, kBound, kAxis, kPlainWarp>(a, p, la);
      if (p.mode == kOrbitWarp)
        return run_line<T, kBody, kBound, kAxis, kOrbitWarp>(a, p, la);
      return run_line<T, kBody, kBound, kAxis, kPlain>(a, p, la);
    }
  }
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

// The (type, body, boundary, axis) cases of each source, one kernel
// instance each (an elementwise body takes axis 1; a shift body one
// instance a mode it may take); cudaErrorInvalidValue for any other case.
cudaError_t dispatch_8bit(const ChainArgs& a, int dtype, int body, int bound);
cudaError_t dispatch_i16(const ChainArgs& a, int dtype, int body, int bound);
cudaError_t dispatch_32bit(const ChainArgs& a, int dtype, int body, int bound);
cudaError_t dispatch_bf16(const ChainArgs& a, int dtype, int body, int bound);

}  // namespace lt_chain

#define CASE(T, B, BD, AX)                                                  \
  if (dtype == dtype_code<T>() && body == B && bound == BD && a.axis == AX) \
    return launch_chain<T, B, BD, AX>(a);
