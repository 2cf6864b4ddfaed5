// The white tophat's building blocks on Hopper, shared by lt_tophat
// (tophat_kernel, filter_stage.cu) and the fused channel stage
// (channel_stage_kernel, channel_stage.cu): 16-pixel quads of u8x4 words,
// DPX min/max on two pixels a word, one plane of horizontal window min/max
// widened through the ellipse's distinct half-widths, and the gathers of
// each SE row pair into the quads a thread holds.  The design notes are
// tophat_kernel's, in filter_stage.cu.  NQ is the number of quads a
// thread holds, kTopThreads the threads of a CTA.

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
  int rq;   // the radius rounded up to quads (16 pixels)
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
// same plan.
inline int tophat_steps(const SeRuns& se, int ksize, TophatPlan* p) {
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
  p->rq = (r + 15) / 16;
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

// ---- Quads: 16 pixels, four u8x4 words, little-endian ----

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

// Word j of quad 2 of w (quads i - 2 .. i + 2 as 20 words) shifted by T
// pixels: the four pixels starting T after its own, from two neighbouring
// words by one funnel shift (-8 <= floor(T / 4) <= 7).
template <int T>
__device__ __forceinline__ uint32_t shifted(const uint32_t (&w)[20], int j) {
  constexpr int Q = (T >= 0 ? T : T - 3) / 4;  // floor(T / 4)
  constexpr int B = 8 * (T - 4 * Q);
  return __funnelshift_r(w[8 + j + Q], w[9 + j + Q], B);
}

// Widen rows of quads [q0, q1): dst = op(src shifted by -S, src, src
// shifted by +S pixels).  The words of quads i - 2 .. i + 2 are loaded
// (the compiler drops those S does not reach); S is a template argument
// so every word index and funnel shift is a constant.  A shift by t pixels
// gives the hi form of the shifted word, a shift by t - 1 its lo form.
template <int S, bool kMax>
__device__ __forceinline__ void widen_quads(const uint4* __restrict__ src,
                                            uint4* __restrict__ dst, int q0,
                                            int q1) {
  for (int i = q0 + threadIdx.x; i < q1; i += kTopThreads) {
    uint32_t w[20];
#pragma unroll
    for (int a = 0; a < 5; ++a) {
      const uint4 v = src[i - 2 + a];
      w[4 * a] = v.x;
      w[4 * a + 1] = v.y;
      w[4 * a + 2] = v.z;
      w[4 * a + 3] = v.w;
    }
    uint32_t o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t hi = op3_hi<kMax>(w[8 + j], shifted<S>(w, j),
                                       shifted<-S>(w, j));
      const uint32_t lo = op3_hi<kMax>(w[8 + j] << 8, shifted<S - 1>(w, j),
                                       shifted<-S - 1>(w, j));
      o[j] = merge_lanes(lo, hi);
    }
    dst[i] = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

template <bool kMax>
__device__ __forceinline__ void widen(int s, const uint4* src, uint4* dst,
                                      int q0, int q1) {
  switch (s) {
#define LT_WIDEN(S) \
  case S:           \
    widen_quads<S, kMax>(src, dst, q0, q1); \
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
// A quad's accumulator is split into lo and hi forms for the step.
template <bool kMax, int NQ>
__device__ __forceinline__ void gather(const uint4* src, int pitch, int dlo,
                                       int dhi, const int (&off)[NQ],
                                       uint4 (&acc)[NQ], int nq) {
  if (dlo > dhi) return;
#pragma unroll
  for (int n = 0; n < NQ; ++n) {
    if (n >= nq) break;
    uint32_t hi[4] = {acc[n].x, acc[n].y, acc[n].z, acc[n].w};
    uint32_t lo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) lo[j] = hi[j] << 8;
    for (int d = dlo; d <= dhi; ++d) {
      const uint4 a = src[off[n] - d * pitch];
      const uint4 b = src[off[n] + d * pitch];
      const uint32_t aw[4] = {a.x, a.y, a.z, a.w};
      const uint32_t bw[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        hi[j] = op3_hi<kMax>(hi[j], aw[j], bw[j]);
        lo[j] = op3_hi<kMax>(lo[j], aw[j] << 8, bw[j] << 8);
      }
    }
    acc[n] = make_uint4(merge_lanes(lo[0], hi[0]), merge_lanes(lo[1], hi[1]),
                        merge_lanes(lo[2], hi[2]), merge_lanes(lo[3], hi[3]));
  }
}

// One morphology pass over the plane in buf0 (nrows_out + 2r rows of
// `pitch` quads): the held quads' results in acc.  buf1 is scratch; both
// buffers are overwritten.
template <bool kMax, int NQ>
__device__ __forceinline__ void morph_pass(uint4* buf0, uint4* buf1,
                                           const TophatPlan& p, int pitch,
                                           int nrows_out,
                                           const int (&off)[NQ],
                                           uint4 (&acc)[NQ],
                                           int nq) {
  const uint32_t init = kMax ? 0u : 0xffffffffu;
#pragma unroll
  for (int n = 0; n < NQ; ++n)
    acc[n] = make_uint4(init, init, init, init);
  gather<kMax, NQ>(buf0, pitch, p.dlo[0], p.dhi[0], off, acc, nq);
  uint4* src = buf0;
  uint4* dst = buf1;
  for (int j = 1; j < p.nsteps; ++j) {
    const int need = p.dneed[j];
    widen<kMax>(p.shift[j], src, dst, (p.r - need) * pitch,
                (nrows_out + p.r + need) * pitch);
    __syncthreads();
    gather<kMax, NQ>(dst, pitch, p.dlo[j], p.dhi[j], off, acc, nq);
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


// Quad q of frame row gy at columns [gx, gx + 16) with its bytes outside
// the image set to 0.
__device__ __forceinline__ uint4 zero_outside(uint4 q, int H, int W, int gy,
                                              int gx) {
  if (gy < 0 || gy >= H || gx >= W || gx + 16 <= 0)
    return make_uint4(0, 0, 0, 0);
  if (gx >= 0 && gx + 16 <= W) return q;
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    w[j] = quad_word(q, j);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int x = gx + 4 * j + b;
      if (x < 0 || x >= W) w[j] &= ~(0xffu << (8 * b));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

}  // namespace lt
