// The white tophat's building blocks on Hopper, shared by lt_tophat
// (tophat_kernel, filter_stage.cu), the probes' lt_tophat_staged and
// lt_dual_tophat (tophat_staged.cu, dual_tophat.cu) and the fused channel
// stage (channel_stage_kernel, channel_stage.cu): quads
// of 16 bytes, DPX min/max on the pixels of a 32-bit word, one plane of
// horizontal window min/max widened through the ellipse's distinct
// half-widths, the gathers of each SE row pair into the quads a thread
// holds, the whole tile (tophat_tile) and the host's tile plan
// (tophat_plan).  The plane's pixels are u8 (16 a quad) or, for
// lt_tophat_staged, bf16 or f32 bit patterns (8 or 4 a quad): see the
// lane formats below.  The design notes are tophat_kernel's, in
// filter_stage.cu.  NQ is the number of quads a thread holds, kTopThreads
// the threads of a CTA.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace lt {

constexpr int kTopThreads = 512;   // threads of a CTA that runs the widening
constexpr int kTopMaxSteps = 40;   // widening steps of an odd k <= 63
constexpr int kTopGuard = 3;       // guard quads before and after a buffer

struct TophatPlan {
  int r;    // radius, k / 2
  int rq;   // the radius rounded up to quads (16 / elem pixels)
  int tq;   // tile width in quads
  int th;   // tile height in rows
  int nsteps;
  int shift[kTopMaxSteps];  // widening of step j (0 for step 0)
  int dlo[kTopMaxSteps];    // rows at distances [dlo, dhi] gathered after it
  int dhi[kTopMaxSteps];
  int dneed[kTopMaxSteps];  // the largest distance gathered from step j on
};

// The widening steps of an odd ksize whose runs are symmetric (rows +-d
// span [-w(d), w(d)], w falling as d grows) into p (all but tq and th);
// -1 if the runs are not so or the steps do not fit.  The steps widen the
// plane from half-width 0 through every w(d) in turn, by at most 2h + 1
// from half-width h; tests/torch_filter_models.py's tophat_steps is the
// same plan.  elem: the plane's bytes a pixel (1, 2 or 4), which set rq.
inline int tophat_steps(const SeRuns& se, int ksize, TophatPlan* p,
                        int elem = 1) {
  const int r = ksize / 2;
  if (ksize % 2 == 0 || se.n != ksize) return -1;
  int w[kMaxRuns];
  for (int q = 0; q < se.n; ++q) {
    if (se.dy[q] != q - r || se.lo[q] != -se.hi[q] ||
        se.hi[q] != se.hi[se.n - 1 - q] || se.hi[q] < 0 || se.hi[q] > r)
      return -1;
  }
  for (int d = 0; d <= r; ++d) {
    w[d] = se.hi[r + d];
    if (d > 0 && w[d] > w[d - 1]) return -1;
  }
  p->r = r;
  p->rq = (r + 16 / elem - 1) / (16 / elem);
  int n = 0;
  auto add = [&](int s, int u) {
    p->shift[n] = s;
    p->dlo[n] = 1;
    p->dhi[n] = 0;
    for (int d = 0; d <= r; ++d) {
      if (w[d] != u) continue;
      if (p->dlo[n] > p->dhi[n]) p->dlo[n] = d;
      p->dhi[n] = d;
    }
    ++n;
  };
  add(0, 0);
  int cur = 0;
  for (int u = 1; u <= r; ++u) {
    bool present = false;
    for (int d = 0; d <= r; ++d) present = present || w[d] == u;
    while (present && cur < u) {
      if (n >= kTopMaxSteps) return -1;
      const int s = u - cur < 2 * cur + 1 ? u - cur : 2 * cur + 1;
      cur += s;
      add(s, cur == u ? u : -1);
    }
  }
  p->nsteps = n;
  int need = -1;
  for (int j = n - 1; j >= 0; --j) {
    if (p->dlo[j] <= p->dhi[j] && p->dhi[j] > need) need = p->dhi[j];
    p->dneed[j] = need;
  }
  return 0;
}

// ---- Lane formats of the plane ----
//
// A plane keeps its pixels in kBytes-byte lanes of 32-bit words, 16 /
// kBytes pixels a quad, little-endian.  U8Lanes is lt_tophat's: u8x4
// words, the pixels taken in pairs into the high bytes of 16-bit lanes for
// DPX (op3_hi).  The staged planes (lt_tophat_staged) hold each pixel's
// bf16 or f32 bit pattern: pixels 0..255 are exact in both, and the bit
// pattern of a non-negative finite float orders as an unsigned integer, so
// DPX's unsigned three-way min/max on the patterns (__vimin3_u16x2 on two
// bf16 a word, __vimin3_u32 on one f32) is the float min/max in one
// instruction, with no lo/hi split.  plane_reach: the quads either side of a quad that a shift of
// up to 31 pixels (32 for U8Lanes' lo form) reaches; plane_guard: the
// guard quads before and after each buffer, at least the reach.  k255:
// 255 in every lane.
__host__ __device__ constexpr int plane_reach(int elem) { return 2 * elem; }
__host__ __device__ constexpr int plane_guard(int elem) {
  return elem == 1 ? kTopGuard : plane_reach(elem);
}

struct U8Lanes {
  static constexpr int kBytes = 1;
  static constexpr uint32_t k255 = 0xffffffffu;
};

struct Bf16Lanes {
  static constexpr int kBytes = 2;
  static constexpr uint32_t k255 = 0x437f437fu;
  template <bool kMax>
  static __device__ __forceinline__ uint32_t op3(uint32_t a, uint32_t b,
                                                 uint32_t c) {
    return kMax ? __vimax3_u16x2(a, b, c) : __vimin3_u16x2(a, b, c);
  }
  // The bf16 pattern of pixel v: the top half of its f32 pattern (exact:
  // v has at most 8 significant bits).
  static __device__ __forceinline__ uint32_t encode(uint32_t v) {
    return __float_as_uint((float)v) >> 16;
  }
  // The pixel in lane `lane` of word w.
  static __device__ __forceinline__ uint32_t decode(uint32_t w, int lane) {
    return __float2uint_rz(
        __uint_as_float(lane == 0 ? w << 16 : w & 0xffff0000u));
  }
};

struct F32Lanes {
  static constexpr int kBytes = 4;
  static constexpr uint32_t k255 = 0x437f0000u;
  template <bool kMax>
  static __device__ __forceinline__ uint32_t op3(uint32_t a, uint32_t b,
                                                 uint32_t c) {
    return kMax ? __vimax3_u32(a, b, c) : __vimin3_u32(a, b, c);
  }
  static __device__ __forceinline__ uint32_t encode(uint32_t v) {
    return __float_as_uint((float)v);
  }
  static __device__ __forceinline__ uint32_t decode(uint32_t w, int) {
    return __float2uint_rz(__uint_as_float(w));
  }
};

// ---- Quads: 16 bytes, four 32-bit words, little-endian ----

// The quad of frame row gy at columns [gx, gx + 16), fill outside the
// image.  vec: W and the frame are 16-byte aligned and gx is a multiple of
// 16, so a quad lies wholly inside or outside a row: one 16-byte load.
__device__ __forceinline__ uint4 load_quad(const uint8_t* __restrict__ src,
                                           int H, int W, int gy, int gx,
                                           uint32_t fill, bool vec) {
  const uint32_t f = fill * 0x01010101u;
  if (gy < 0 || gy >= H || gx >= W || gx + 16 <= 0)
    return make_uint4(f, f, f, f);
  const uint8_t* row = src + (size_t)gy * W;
  if (vec) return *reinterpret_cast<const uint4*>(row + gx);
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    w[j] = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int x = gx + 4 * j + b;
      const uint32_t v = (x >= 0 && x < W) ? row[x] : fill;
      w[j] |= v << (8 * b);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint32_t quad_word(const uint4& q, int j) {
  return j == 0 ? q.x : j == 1 ? q.y : j == 2 ? q.z : q.w;
}

// Per-pixel min (erode) or max (dilate) of three words whose pixels ride
// in the high byte of each 16-bit lane, one DPX instruction
// (__vimin3_u16x2 / __vimax3_u16x2): the high byte of a lane's min or max
// is the min or max of the high bytes, whatever the low bytes hold.  A
// u8x4 word w holds pixels 1 and 3 so ("hi form"); w << 8 holds pixels 0
// and 2 so ("lo form"), and merge_lanes puts the two results back in
// order.  On sm_90a a three-way min of u8x4 words with __vminu4 takes two
// six-instruction emulations; this takes one DPX instruction for each
// half, a shift for each lo form and one byte permute.
template <bool kMax>
__device__ __forceinline__ uint32_t op3_hi(uint32_t a, uint32_t b, uint32_t c) {
  return kMax ? __vimax3_u16x2(a, b, c) : __vimin3_u16x2(a, b, c);
}

__device__ __forceinline__ uint32_t merge_lanes(uint32_t lo, uint32_t hi) {
  return __byte_perm(lo, hi, 0x7351);  // lo.1, hi.1, lo.3, hi.3
}

// Word j of the centre quad of w (the quads i - R .. i + R as N = 4 (2R +
// 1) words) shifted by T pixels of E bytes: the bytes starting T E after
// its own, from two neighbouring words by one funnel shift (one word where
// the shift is whole words, E > 1).  For E = 1, R = 2: -8 <= floor(T / 4)
// <= 7.
template <int T, int E, int N>
__device__ __forceinline__ uint32_t shifted(const uint32_t (&w)[N], int j) {
  constexpr int C = N / 2 - 2;  // the centre quad's first word
  constexpr int TB = T * E;
  constexpr int Q = (TB >= 0 ? TB : TB - 3) / 4;  // floor(TB / 4)
  constexpr int B = 8 * (TB - 4 * Q);
  if constexpr (E > 1 && B == 0) {
    return w[C + j + Q];
  } else {
    return __funnelshift_r(w[C + j + Q], w[C + j + Q + 1], B);
  }
}

// Widen rows of quads [q0, q1): dst = op(src shifted by -S, src, src
// shifted by +S pixels).  The words of quads i - R .. i + R are loaded
// (the compiler drops those S does not reach); S is a template argument
// so every word index and funnel shift is a constant.  U8Lanes: a shift
// by t pixels gives the hi form of the shifted word, a shift by t - 1 its
// lo form; the wider lanes take one DPX op a word.
template <int S, bool kMax, class L = U8Lanes>
__device__ __forceinline__ void widen_quads(const uint4* __restrict__ src,
                                            uint4* __restrict__ dst, int q0,
                                            int q1) {
  constexpr int R = plane_reach(L::kBytes);
  for (int i = q0 + threadIdx.x; i < q1; i += kTopThreads) {
    uint32_t w[4 * (2 * R + 1)];
#pragma unroll
    for (int a = 0; a < 2 * R + 1; ++a) {
      const uint4 v = src[i - R + a];
      w[4 * a] = v.x;
      w[4 * a + 1] = v.y;
      w[4 * a + 2] = v.z;
      w[4 * a + 3] = v.w;
    }
    uint32_t o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (L::kBytes == 1) {
        const uint32_t hi = op3_hi<kMax>(w[4 * R + j], shifted<S, 1>(w, j),
                                         shifted<-S, 1>(w, j));
        const uint32_t lo =
            op3_hi<kMax>(w[4 * R + j] << 8, shifted<S - 1, 1>(w, j),
                         shifted<-S - 1, 1>(w, j));
        o[j] = merge_lanes(lo, hi);
      } else {
        o[j] = L::template op3<kMax>(w[4 * R + j],
                                     shifted<S, L::kBytes>(w, j),
                                     shifted<-S, L::kBytes>(w, j));
      }
    }
    dst[i] = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

template <bool kMax, class L = U8Lanes>
__device__ __forceinline__ void widen(int s, const uint4* src, uint4* dst,
                                      int q0, int q1) {
  switch (s) {
#define LT_WIDEN(S) \
  case S:           \
    widen_quads<S, kMax, L>(src, dst, q0, q1); \
    break;
    LT_WIDEN(1) LT_WIDEN(2) LT_WIDEN(3) LT_WIDEN(4) LT_WIDEN(5) LT_WIDEN(6)
    LT_WIDEN(7) LT_WIDEN(8) LT_WIDEN(9) LT_WIDEN(10) LT_WIDEN(11)
    LT_WIDEN(12) LT_WIDEN(13) LT_WIDEN(14) LT_WIDEN(15) LT_WIDEN(16)
    LT_WIDEN(17) LT_WIDEN(18) LT_WIDEN(19) LT_WIDEN(20) LT_WIDEN(21)
    LT_WIDEN(22) LT_WIDEN(23) LT_WIDEN(24) LT_WIDEN(25) LT_WIDEN(26)
    LT_WIDEN(27) LT_WIDEN(28) LT_WIDEN(29) LT_WIDEN(30) LT_WIDEN(31)
#undef LT_WIDEN
  }
}

// Fold the plane at rows +-d, d in [dlo, dhi], into each held quad; off[n]
// is the quad's own row and column in the plane, pitch its row in quads.
// U8Lanes: a quad's accumulator is split into lo and hi forms for the
// step.
template <bool kMax, int NQ, class L = U8Lanes>
__device__ __forceinline__ void gather(const uint4* src, int pitch, int dlo,
                                       int dhi, const int (&off)[NQ],
                                       uint4 (&acc)[NQ], int nq) {
  if (dlo > dhi) return;
#pragma unroll
  for (int n = 0; n < NQ; ++n) {
    if (n >= nq) break;
    uint32_t hi[4] = {acc[n].x, acc[n].y, acc[n].z, acc[n].w};
    [[maybe_unused]] uint32_t lo[4];
    if constexpr (L::kBytes == 1) {
#pragma unroll
      for (int j = 0; j < 4; ++j) lo[j] = hi[j] << 8;
    }
    for (int d = dlo; d <= dhi; ++d) {
      const uint4 a = src[off[n] - d * pitch];
      const uint4 b = src[off[n] + d * pitch];
      const uint32_t aw[4] = {a.x, a.y, a.z, a.w};
      const uint32_t bw[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (L::kBytes == 1) {
          hi[j] = op3_hi<kMax>(hi[j], aw[j], bw[j]);
          lo[j] = op3_hi<kMax>(lo[j], aw[j] << 8, bw[j] << 8);
        } else {
          hi[j] = L::template op3<kMax>(hi[j], aw[j], bw[j]);
        }
      }
    }
    if constexpr (L::kBytes == 1) {
      acc[n] = make_uint4(merge_lanes(lo[0], hi[0]), merge_lanes(lo[1], hi[1]),
                          merge_lanes(lo[2], hi[2]), merge_lanes(lo[3], hi[3]));
    } else {
      acc[n] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    }
  }
}

// One morphology pass over the plane in buf0 (nrows_out + 2r rows of
// `pitch` quads): the held quads' results in acc.  buf1 is scratch; both
// buffers are overwritten.
template <bool kMax, int NQ, class L = U8Lanes>
__device__ __forceinline__ void morph_pass(uint4* buf0, uint4* buf1,
                                           const TophatPlan& p, int pitch,
                                           int nrows_out,
                                           const int (&off)[NQ],
                                           uint4 (&acc)[NQ],
                                           int nq) {
  const uint32_t init = kMax ? 0u : L::k255;
#pragma unroll
  for (int n = 0; n < NQ; ++n)
    acc[n] = make_uint4(init, init, init, init);
  gather<kMax, NQ, L>(buf0, pitch, p.dlo[0], p.dhi[0], off, acc, nq);
  uint4* src = buf0;
  uint4* dst = buf1;
  for (int j = 1; j < p.nsteps; ++j) {
    const int need = p.dneed[j];
    widen<kMax, L>(p.shift[j], src, dst, (p.r - need) * pitch,
                   (nrows_out + p.r + need) * pitch);
    __syncthreads();
    gather<kMax, NQ, L>(dst, pitch, p.dlo[j], p.dhi[j], off, acc, nq);
    uint4* t = src;
    src = dst;
    dst = t;
  }
}

// This thread's quads of a region of `cols` quads a row and `n` quads in
// all (m = thread + n * threads, row-major), as offsets into a plane of
// `pitch` quads a row whose row r, quad rq is the region's first.
template <int NQ>
__device__ __forceinline__ int held_quads(int n, int cols, int pitch, int r,
                                          int rq,
                                          int (&off)[NQ]) {
  int nq = 0;
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    const int m = threadIdx.x + j * kTopThreads;
    const int row = m / cols;
    off[j] = (row + r) * pitch + (m - row * cols) + rq;
    if (m < n) nq = j + 1;
  }
  return nq;
}


// Quad q of frame row gy from column gx (16 / kBytes pixels) with its
// lanes outside the image set to 0.
template <class L = U8Lanes>
__device__ __forceinline__ uint4 zero_outside(uint4 q, int H, int W, int gy,
                                              int gx) {
  constexpr int E = L::kBytes;
  constexpr int P = 16 / E;
  constexpr uint32_t kLane = E == 4 ? 0xffffffffu : E == 2 ? 0xffffu : 0xffu;
  if (gy < 0 || gy >= H || gx >= W || gx + P <= 0)
    return make_uint4(0, 0, 0, 0);
  if (gx >= 0 && gx + P <= W) return q;
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    w[j] = quad_word(q, j);
#pragma unroll
    for (int b = 0; b < 4 / E; ++b) {
      const int x = gx + 4 / E * j + b;
      if (x < 0 || x >= W) w[j] &= ~(kLane << (8 * E * b));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The u8 pixels of frame row gy at columns [gx, gx + n), n = 4 V, as V
// words, fill outside the image.  vec: W and the frame are aligned to n
// bytes and gx is a multiple of n, so the pixels lie wholly inside or
// outside a row: one n-byte load.
template <int V>
__device__ __forceinline__ void load_words(const uint8_t* __restrict__ src,
                                           int H, int W, int gy, int gx,
                                           uint32_t fill, bool vec,
                                           uint32_t (&w)[V]) {
  const uint32_t f = fill * 0x01010101u;
  if (gy < 0 || gy >= H || gx >= W || gx + 4 * V <= 0) {
#pragma unroll
    for (int j = 0; j < V; ++j) w[j] = f;
    return;
  }
  const uint8_t* row = src + (size_t)gy * W;
  if (vec) {
    if constexpr (V == 2) {
      const uint2 v = *reinterpret_cast<const uint2*>(row + gx);
      w[0] = v.x;
      w[1] = v.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(row + gx);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    w[j] = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int x = gx + 4 * j + b;
      const uint32_t v = (x >= 0 && x < W) ? row[x] : fill;
      w[j] |= v << (8 * b);
    }
  }
}

// The quad of frame row gy from column gx in the plane's lanes, fill
// outside the image: U8Lanes load_quad's 16 pixels; the staged lanes 8
// (bf16) or 4 (f32) pixels from one 8- or 4-byte load (vec: aligned to
// those bytes), each converted to its bit pattern.
template <class L>
__device__ __forceinline__ uint4 stage_quad(const uint8_t* __restrict__ src,
                                            int H, int W, int gy, int gx,
                                            uint32_t fill, bool vec) {
  if constexpr (L::kBytes == 1) {
    return load_quad(src, H, W, gy, gx, fill, vec);
  } else {
    constexpr int V = 4 / L::kBytes;  // u8 words of a quad's pixels
    uint32_t px[V];
    load_words<V>(src, H, W, gy, gx, fill, vec, px);
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t b = px[j * V / 4] >> (8 * (j * 4 / L::kBytes % 4));
      if constexpr (L::kBytes == 2) {
        w[j] = L::encode(b & 0xff) | L::encode((b >> 8) & 0xff) << 16;
      } else {
        w[j] = L::encode(b & 0xff);
      }
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// One output tile of the white tophat img - open(img): tile (bx, by) of
// frame z, the plan's tq quads x th rows, in a plane of L's lanes; smem
// the two buffers and their guards (tophat_smem, below).  vec:
// the images and W are aligned to the bytes of a quad's pixels (16 / L's
// kBytes).  The design notes are tophat_kernel's, in filter_stage.cu.
// All of a CTA's kTopThreads threads call it.
template <class L, int NQ>
__device__ __forceinline__ void tophat_tile(const uint8_t* __restrict__ in,
                                            uint8_t* __restrict__ out, int H,
                                            int W, bool vec,
                                            const TophatPlan& p,
                                            unsigned bx, unsigned by,
                                            unsigned z, unsigned char* smem) {
  constexpr int P = 16 / L::kBytes;  // pixels a quad
  constexpr int G = plane_guard(L::kBytes);
  const int r = p.r, rq = p.rq, tq = p.tq, th = p.th;
  const int nqx = tq + 4 * rq, nrx = th + 4 * r;  // staged input
  const int nqe = tq + 2 * rq, nre = th + 2 * r;  // eroded region
  uint4* buf0 = reinterpret_cast<uint4*>(smem) + G;
  uint4* buf1 = buf0 + (size_t)nrx * nqx + 2 * G;
  const int x0 = bx * tq * P;
  const int y0 = by * th;
  const size_t frame = (size_t)z * H * W;

  for (int i = threadIdx.x; i < nrx * nqx; i += kTopThreads) {
    const int row = i / nqx;
    buf0[i] = stage_quad<L>(in + frame, H, W, y0 - 2 * r + row,
                            x0 - 2 * P * rq + P * (i - row * nqx), 255u,
                            vec);
  }
  __syncthreads();
  int off[NQ];
  uint4 acc[NQ];
  int nq = held_quads(nre * nqe, nqe, nqx, r, rq, off);
  morph_pass<false, NQ, L>(buf0, buf1, p, nqx, nre, off, acc, nq);
  __syncthreads();
  // The eroded region into buf0, rows of nqe quads, 0 outside the image.
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    if (j >= nq) break;
    const int m = threadIdx.x + j * kTopThreads;
    const int row = m / nqe;
    const int gy = y0 - r + row;
    buf0[m] = zero_outside<L>(acc[j], H, W, gy,
                              x0 - P * rq + P * (m - row * nqe));
  }
  __syncthreads();
  nq = held_quads(th * tq, tq, nqe, r, rq, off);
  morph_pass<true, NQ, L>(buf0, buf1, p, nqe, th, off, acc, nq);
  // out = img - open(img): bytewise with no borrow, as open <= img.
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    if (j >= nq) break;
    const int m = threadIdx.x + j * kTopThreads;
    const int row = m / tq;
    const int gy = y0 + row;
    const int gx = x0 + P * (m - row * tq);
    if (gy >= H || gx >= W) continue;
    uint8_t* dst = out + frame + (size_t)gy * W + gx;
    const uint4& d = acc[j];
    if constexpr (L::kBytes == 1) {
      const uint4 x = load_quad(in + frame, H, W, gy, gx, 0u, vec);
      const uint4 o = make_uint4(x.x - d.x, x.y - d.y, x.z - d.z, x.w - d.w);
      if (vec) {
        *reinterpret_cast<uint4*>(dst) = o;
      } else {
        for (int b = 0; b < 16 && gx + b < W; ++b)
          dst[b] = (uint8_t)(quad_word(o, b / 4) >> (8 * (b % 4)));
      }
    } else {
      // The open back to u8 words; V is also the lanes a word, so pixel i
      // is lane i % V of word i / V.
      constexpr int V = 4 / L::kBytes;
      uint32_t x[V];
      load_words<V>(in + frame, H, W, gy, gx, 0u, vec, x);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        uint32_t open = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int i = 4 * v + b;
          open |= L::decode(quad_word(d, i / V), i % V) << (8 * b);
        }
        x[v] -= open;
      }
      if (vec) {
        if constexpr (V == 2) {
          *reinterpret_cast<uint2*>(dst) = make_uint2(x[0], x[1]);
        } else {
          *reinterpret_cast<uint32_t*>(dst) = x[0];
        }
      } else {
        for (int b = 0; b < P && gx + b < W; ++b)
          dst[b] = (uint8_t)(x[b / 4] >> (8 * (b % 4)));
      }
    }
  }
}

// ---- The host's plan: the tile of an H x W frame and the CTA shape
// (tophat_kernel's design notes in filter_stage.cu) ----

constexpr int kTopMaxQuads = 6;    // accumulator quads a thread holds
constexpr size_t kTopSmemTwo = 110 * 1024;  // two CTAs an SM

// The tophat's CTA shapes: two CTAs an SM, each holding kTopMaxQuads
// accumulator quads a thread (64 registers) in 110 KB, as lt_tophat and
// lt_dual_tophat run; or one CTA an SM holding 10 (117 registers) in up to
// the 227 KB a block can opt in to, which the staged planes may take: their
// tiles are bound by the quads the threads hold as much as by the shared
// memory.  Two CTAs overlap each other's barriers, so the planner counts
// their accesses at 10/13, channel_stage.cu's weight for the same widening
// (PERF.md section 6).
struct TopShape {
  int quads, gain10;
  size_t smem;
};
constexpr TopShape kTopShapes[2] = {{kTopMaxQuads, 13, kTopSmemTwo},
                                    {10, 10, 227 * 1024}};

// Bytes of the tophat's two buffers (each the staged tile, 2r rows and
// 2 rq quads of halo a side, plus guards of `guard` quads) for a tile of
// tq quads x th rows.
inline size_t tophat_smem(int tq, int th, int r, int rq,
                          int guard = kTopGuard) {
  return 2 * 16 * ((size_t)(th + 4 * r) * (tq + 4 * rq) + 2 * guard);
}

// The tophat's plan for an odd ksize whose runs are symmetric
// (tophat_steps), and its tiles for an H x W frame in a plane of elem
// bytes a pixel (1, 2 or 4); *shape the index into kTopShapes.  -1 if the
// runs are not so or the plan does not fit.
inline int tophat_plan(const SeRuns& se, int ksize, int elem, int H, int W,
                       TophatPlan* p, int* shape) {
  if ((elem != 1 && elem != 2 && elem != 4) ||
      tophat_steps(se, ksize, p, elem) != 0)
    return -1;
  const int r = p->r;
  const int n = p->nsteps;
  const int guard = plane_guard(elem);
  // Tiles: of 4 to 16 elem quads (u8: 64, 128, 192 or 256 columns), each
  // with the tallest height (a multiple of 8, at most 256 and the frame's)
  // whose buffers fit the shape's CTAs an SM and whose quads the threads
  // can hold (for every odd k up to 63 some height does); the one whose
  // frame costs the fewest shared-memory quad accesses (an estimate of the
  // widening steps' and the gathers'), weighted by the shape.  The u8
  // plane takes the two-CTA shape only, as lt_tophat always has.
  long long best = -1;
  int best_gain = 1;
  const int hmax = (H + 7) / 8 * 8 < 256 ? (H + 7) / 8 * 8 : 256;
  for (int sh = 0; sh < (elem == 1 ? 1 : 2); ++sh) {
    const TopShape& s = kTopShapes[sh];
    const long long cap = (long long)s.quads * kTopThreads;
    for (int tq = 4; tq <= 16 * elem; tq += 4) {
      const long long nqx = tq + 4 * p->rq, nqe = tq + 2 * p->rq;
      int th = 0;
      for (int h = 8; h <= hmax; h += 8) {
        if (tophat_smem(tq, h, r, p->rq, guard) <= s.smem &&
            (h + 2 * r) * nqe <= cap && h * tq <= cap)
          th = h;
      }
      if (th == 0) continue;
      const long long rows_x = th + 4 * r, rows_e = th + 2 * r;
      const long long tile = 6LL * n * (rows_x * nqx + rows_e * nqe) +
                             2LL * (2 * r + 1) * (rows_e * nqe + th * tq) +
                             rows_x * nqx;
      const long long cost = tile * ((H + th - 1) / th) *
                             ((W + 16 / elem * tq - 1) / (16 / elem * tq));
      // cost / s.gain10 < best / best_gain, exactly.
      if (best < 0 || cost * best_gain < best * s.gain10) {
        best = cost;
        best_gain = s.gain10;
        p->tq = tq;
        p->th = th;
        *shape = sh;
      }
    }
  }
  return best < 0 ? -1 : 0;
}

}  // namespace lt
