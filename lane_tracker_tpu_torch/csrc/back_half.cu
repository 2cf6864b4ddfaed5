// Hand-written Hopper (sm_90a) kernel for the tracker's back half: one
// launch scans the T frames of a chunk for S streams, one thread block a
// stream, with the tracker state kept in shared memory from frame to frame.
//
// It replaces no Pallas kernel.  The JAX package runs the back half as a
// `lax.scan` of `back_half` (lane_tracker_tpu/parallel/pipeline.py:42-50),
// which XLA compiles into one loop on the device; the port ran that scan as
// a Python loop of small PyTorch operators, about 1,155 launches a frame
// offline, and the card idled through most of a chunk while the host
// launched them.  This kernel is that scan (tracker/step.py's `back_half`,
// `_run_attempt` and `_update`; ops/search.py's `band_intervals`,
// ops/integrals.py's `interval_moments`, ops/polyfit.py's `fit_poly_rows`,
// `_solve3`, `poly_points_meta`, `check_validity`, `curve_radius_m` and
// `eccentricity_m`) in one launch.  Its plain twins are the per-frame loops
// `parallel.pipeline.scan_back_half_plain` and
// `parallel.streams.scan_streams_plain`.
//
// What bounds it on the H100: latency.  A frame reads about 37 KB an
// attempt (two prefix words a row and side, the blind interval's ends and
// flag), some 11 ns at 3.35 TB/s, and each frame's search starts from the fit the frame
// before it kept, so the frames run one after another.  A frame's time is
// the chain of its dependent steps: the prefix gathers, the block
// reductions and the few scalar steps between them.  The design keeps that
// chain short:
//
// * one block a stream walks its frames in order; nothing leaves the chip
//   between frames but the outputs, which nothing in the scan reads back;
// * both attempts (given the hoisted attempt-2 artifacts) and both sides
//   run in the same passes, so a frame has four block reductions (the
//   integer moments, the float moments, the validity counts, the render
//   geometry's count and first sample) whatever the attempts;
// * the per-row counts and x-sums stay in shared memory between the
//   reductions; each 3x3 solve is one thread, the four solves side by side;
// * a reduction is a warp butterfly, then one thread a value over the
//   warps' partials: two barriers.
//
// Arithmetic.  Every elementwise step is the plain path's, in float32 and
// in its order: this source is built with -fmad=false (kernels/build.py),
// so no multiply and add contract into a fused multiply-add, and division
// and square root are IEEE-rounded (nvcc's defaults without fast math).
// floorf, ceilf and truncf stand where the plain path floors, ceils and
// truncates, with its saturation to +-2^30 before each float-to-int cast.
// The sums of integer-valued terms (the counts, the x-sums, n * y and the
// float32 products n * y^2) are accumulated exactly in 64-bit integers and
// rounded to float32 once; the float sums of the fit (S1..S4, P0..P2)
// round in the block's order, which differs from PyTorch's reductions:
// that is the one difference from the twins.  The pivot rule is
// `_solve3`'s: the first maximal |pivot| (a NaN counts as the largest).
// powf is the CUDA library's, as PyTorch's `** 1.5` on the card.
//
// Plain C interface, loaded with ctypes: `lt_back_half` takes a host table
// of device pointers, one of ints and one of floats (their order is
// kernels/back_half.py's), launches on the stream it is given, allocates
// nothing, counts the launch in lt_back_half_launches and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
// Threads a block (a stream), a row loop over the warped rows.
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / kWarp;
constexpr unsigned kFull = 0xFFFFFFFFu;
// The longest history ring (n_average) the block keeps.
constexpr int kMaxAvg = 32;
// Integer moments a frame: (count, n*y, n*y^2, x-sum) for each of the four
// (attempt, side) fits, then the corridor violations of each attempt.
constexpr int kIntSums = 18;
// Float moments a frame: (S1, S2, S3, S4, P0, P1, P2) for each fit.
constexpr int kFloatSums = 28;
constexpr float kSat = 1073741824.0f;  // 2^30

// The pointer table: for each attempt its packed prefixes and its blind
// intervals' ten fields, then the two sample grids, the state in, the
// state out, the StepOutput fields and the RenderMeta fields.
enum IvField {
  kLeftLo, kLeftHi, kLeftValid, kRightLo, kRightHi, kRightValid,
  kLeftReadLo, kLeftReadHi, kRightReadLo, kRightReadHi, kIvFields
};
enum StateField {
  kLastDetection, kHistLeft, kHistRight, kHistValid, kLastLeft, kLastRight,
  kAvgLeft, kAvgRight, kHasAvg, kRfitxLeft, kRfitxRight, kRnLeft, kRnRight,
  kRfirstLeft, kRfirstRight, kRadii, kAvgRadius, kEcc, kCounter, kSuccess,
  kStateFields
};
enum OutField {
  kRenderMode, kValid, kDetected, kSearchMode, kNAttempts, kRadius, kEccOut,
  kLeftCoeffs, kRightCoeffs, kNPointsLeft, kNPointsRight, kA1Detected,
  kA1Valid, kA1LeftCoeffs, kA1RightCoeffs, kA1NLeft, kA1NRight, kCorridorOk,
  kOutFields
};
enum MetaField {
  kFitxLeft, kFitxRight, kCoeffsLeft, kCoeffsRight, kNLeft, kNRight,
  kFirstLeft, kFirstRight, kDraw, kMetaFields
};
constexpr int kAttemptPtrs = 1 + kIvFields;
constexpr int kPtrs = 2 * kAttemptPtrs + 2 + 2 * kStateFields + kOutFields +
                      kMetaFields;
// The int and float tables' entries, in order.
enum IntParam {
  kS, kT, kH, kW, kShift, kNAvg, kNRender, kNReset, kNFail, kAttempts,
  kBase, kColRoi, kX0, kX1, kL0, kL1, kTopCut0, kTopCut1, kRowEnd0,
  kRowEnd1, kIntParams
};
enum FloatParam {
  kBw0, kBw1, kMin1, kMax1, kMin2, kMax2, kMin3, kMax3, kTangent, kC035,
  kC075, kMppv, kMpph, kMppv2, kFloatParams
};

struct Args {
  const int32_t* pref[2];
  const void* iv[2][kIvFields];
  const float* ploty_v;  // the validity samples, (H,)
  const float* ploty_r;  // the render samples, (n_render,)
  const void* st_in[kStateFields];
  void* st_out[kStateFields];
  void* out[kOutFields];
  void* meta[kMetaFields];
  int p[kIntParams];
  float f[kFloatParams];
};

struct State {
  int last_detection;
  float hist[2][kMaxAvg][3];
  int hist_valid[kMaxAvg];
  float last[2][3];
  float avg[2][3];
  int has_avg;
  int rn[2];
  int rfirst[2];
  float radii[kMaxAvg];
  float avg_radius;
  float ecc;
  int counter;
  int success;
};

// One frame's decisions, from thread 0 to the block.
struct Frame {
  int valid;
  float avg_new[2][3];  // the smoothed fit of the pushed history
};

// Every thread's K partials summed (the last M: their minimum) over
// the block, into total[0..K) in shared memory: a warp butterfly, the
// warps' partials to `part`, then one thread a value over them in warp
// order.  Two barriers; `part` and `total` are free again after it.
template <typename V, int K, int M = 0>
__device__ __forceinline__ void block_reduce(V (&v)[K], V* part, V* total) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const bool is_min = k >= K - M;
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const V o = __shfl_xor_sync(kFull, v[k], off);
      v[k] = is_min ? (o < v[k] ? o : v[k]) : v[k] + o;
    }
  }
  const int warp = threadIdx.x / kWarp;
  if (threadIdx.x % kWarp == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) part[warp * K + k] = v[k];
  }
  __syncthreads();
  const int k = threadIdx.x;
  if (k < K) {
    const bool is_min = k >= K - M;
    V acc = part[k];
    for (int w = 1; w < kWarps; ++w) {
      const V o = part[w * K + k];
      acc = is_min ? (o < acc ? o : acc) : acc + o;
    }
    total[k] = acc;
  }
  __syncthreads();
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// float -> int32 after the clamp to [-2^30, 2^30], as the plain path's
// `.clamp(-2.0**30, 2.0**30).to(torch.int32)` (NaN stays NaN and converts
// to 0, as on the card).
__device__ __forceinline__ int sat_int(float x) {
  x = x < -kSat ? -kSat : (x > kSat ? kSat : x);
  return (int)x;
}

// c[0] y^2 + c[1] y + c[2] in the plain path's order:
// ((c0 * y) * y + c1 * y) + c2 (no FMA in this source).
__device__ __forceinline__ float poly(const float* c, float y) {
  return c[0] * y * y + c[1] * y + c[2];
}

// The fit's scalars of one (attempt, side) from the integer moments.
struct Moments {
  float n, my, sy, mx;
};

__device__ __forceinline__ Moments moments(const long long* tot, int c) {
  Moments m;
  m.n = __ll2float_rn(tot[4 * c]);
  const float n_safe = fmaxf(m.n, 1.0f);
  m.my = __ll2float_rn(tot[4 * c + 1]) / n_safe;
  const float vy = __ll2float_rn(tot[4 * c + 2]) / n_safe - m.my * m.my;
  m.sy = sqrtf(fmaxf(vy, 1e-12f));
  m.mx = __ll2float_rn(tot[4 * c + 3]) / n_safe;
  return m;
}

// `fit_poly_rows`' solve and back-transform of one fit: the normal
// equations from the float moments fs[0..7) (S1, S2, S3, S4, P0, P1, P2),
// `_solve3` with its pivot rule, then A, B, C.
__device__ void solve_fit(const Moments& m, const float* fs, float W,
                          float* out) {
  float A[3][4] = {{fs[3], fs[2], fs[1], fs[6]},
                   {fs[2], fs[1], fs[0], fs[5]},
                   {fs[1], fs[0], m.n, fs[4]}};
  if (m.n < 3.0f) {
    for (int r = 0; r < 3; ++r)
      for (int j = 0; j < 4; ++j) A[r][j] = (r == j) ? 1.0f : 0.0f;
  }
  for (int col = 0; col < 3; ++col) {
    int piv = col;
    for (int r = col + 1; r < 3; ++r) {
      const float best = fabsf(A[piv][col]);
      const float cand = fabsf(A[r][col]);
      if (!isnan(best) && (isnan(cand) || cand > best)) piv = r;
    }
    if (piv != col) {
      for (int j = 0; j < 4; ++j) {
        const float x = A[col][j];
        A[col][j] = A[piv][j];
        A[piv][j] = x;
      }
    }
    for (int r = col + 1; r < 3; ++r) {
      const float f = A[r][col] / A[col][col];
      for (int j = 0; j < 4; ++j) A[r][j] = A[r][j] - f * A[col][j];
    }
  }
  const float x2 = A[2][3] / A[2][2];
  const float x1 = (A[1][3] - A[1][2] * x2) / A[1][1];
  const float x0 = (A[0][3] - A[0][1] * x1 - A[0][2] * x2) / A[0][0];
  const float a = x0, bb = x1, c = x2;
  const float sy2 = m.sy * m.sy;
  out[0] = W * a / sy2;
  out[1] = W * (bb / m.sy - 2.0f * a * m.my / sy2);
  out[2] = W * (a * m.my * m.my / sy2 - bb * m.my / m.sy + c) + m.mx;
}

// `check_validity` of one candidate pair.
__device__ __forceinline__ bool validity(const Args& a, const float* lc, const float* rc,
                         int n_left, int n_right) {
  const int base = a.p[kBase];
  const float y1 = (float)(base - 1);
  const float nmin = (float)(n_left < n_right ? n_left : n_right);
  const float y2 = (float)base - truncf(nmin * a.f[kC035]);
  const float y3 = (float)base - truncf(nmin * a.f[kC075]);
  const float x1 = fabsf(poly(lc, y1) - poly(rc, y1));
  const float x2 = fabsf(poly(lc, y2) - poly(rc, y2));
  const float x3 = fabsf(poly(lc, y3) - poly(rc, y3));
  const bool dist_ok = x1 >= a.f[kMin1] && x1 <= a.f[kMax1] &&
                       x2 >= a.f[kMin2] && x2 <= a.f[kMax2] &&
                       x3 >= a.f[kMin3] && x3 <= a.f[kMax3];
  const float n1 = fabsf((2.0f * lc[0] * y1 + lc[1]) -
                         (2.0f * rc[0] * y1 + rc[1]));
  const float n2 = fabsf((2.0f * lc[0] * y3 + lc[1]) -
                         (2.0f * rc[0] * y3 + rc[1]));
  return dist_ok && n1 < a.f[kTangent] && n2 < a.f[kTangent];
}

// `curve_radius_m` of one fit.
__device__ __forceinline__ float curve_radius(const Args& a, const float* c) {
  const float m0 = c[0] * a.f[kMpph] / a.f[kMppv2];
  const float m1 = c[1] * a.f[kMpph] / a.f[kMppv];
  const float y_eval = (float)a.p[kH];
  const float slope = 2.0f * m0 * y_eval * a.f[kMppv] + m1;
  const float r = powf(1.0f + slope * slope, 1.5f) / fabsf(2.0f * m0);
  return truncf(r);
}

template <typename V>
__device__ __forceinline__ V* field(void* const* ptrs, int k) {
  return static_cast<V*>(ptrs[k]);
}
template <typename V>
__device__ __forceinline__ const V* field(const void* const* ptrs, int k) {
  return static_cast<const V*>(ptrs[k]);
}

__global__ void __launch_bounds__(kThreads)
    back_half_scan_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char dyn[];
  const int T = a.p[kT], H = a.p[kH], W = a.p[kW];
  const int NA = a.p[kNAvg], NR = a.p[kNRender];
  const int attempts = a.p[kAttempts];
  const int fits = 2 * attempts;
  const int32_t mask = (1 << a.p[kShift]) - 1;
  const float Wf = (float)W, Wm1 = (float)(W - 1);
  // Per (attempt, side) fit c = 2 * attempt + side: each row's count and
  // x-sum; then the two render graphs.
  int32_t* row_n = reinterpret_cast<int32_t*>(dyn);
  int32_t* row_sx = row_n + 4 * H;
  float* rfitx = reinterpret_cast<float*>(row_sx + 4 * H);

  __shared__ State st;
  __shared__ Frame fr;
  __shared__ long long part_i[kWarps * kIntSums];
  __shared__ long long tot_i[kIntSums];
  __shared__ float part_f[kWarps * kFloatSums];
  __shared__ float tot_f[kFloatSums];
  __shared__ int part_c[kWarps * 4];
  __shared__ int tot_c[4];
  __shared__ float coef[4][3];

  const int s = blockIdx.x, tid = threadIdx.x, nt = kThreads;

  // ---- The state in ----
  for (int i = tid; i < H; i += nt) {
    rfitx[i] = field<float>(a.st_in, kRfitxLeft)[(long long)s * H + i];
    rfitx[H + i] = field<float>(a.st_in, kRfitxRight)[(long long)s * H + i];
  }
  if (tid == 0) {
    st.last_detection = field<int32_t>(a.st_in, kLastDetection)[s];
    for (int i = 0; i < NA; ++i) {
      for (int j = 0; j < 3; ++j) {
        st.hist[0][i][j] = field<float>(a.st_in, kHistLeft)[(s * NA + i) * 3 + j];
        st.hist[1][i][j] = field<float>(a.st_in, kHistRight)[(s * NA + i) * 3 + j];
      }
      st.hist_valid[i] = field<uint8_t>(a.st_in, kHistValid)[s * NA + i] != 0;
      st.radii[i] = field<float>(a.st_in, kRadii)[s * NA + i];
    }
    for (int j = 0; j < 3; ++j) {
      st.last[0][j] = field<float>(a.st_in, kLastLeft)[s * 3 + j];
      st.last[1][j] = field<float>(a.st_in, kLastRight)[s * 3 + j];
      st.avg[0][j] = field<float>(a.st_in, kAvgLeft)[s * 3 + j];
      st.avg[1][j] = field<float>(a.st_in, kAvgRight)[s * 3 + j];
    }
    st.has_avg = field<uint8_t>(a.st_in, kHasAvg)[s] != 0;
    st.rn[0] = field<int32_t>(a.st_in, kRnLeft)[s];
    st.rn[1] = field<int32_t>(a.st_in, kRnRight)[s];
    st.rfirst[0] = field<int32_t>(a.st_in, kRfirstLeft)[s];
    st.rfirst[1] = field<int32_t>(a.st_in, kRfirstRight)[s];
    st.avg_radius = field<float>(a.st_in, kAvgRadius)[s];
    st.ecc = field<float>(a.st_in, kEcc)[s];
    st.counter = field<int32_t>(a.st_in, kCounter)[s];
    st.success = field<int32_t>(a.st_in, kSuccess)[s];
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const long long ft = (long long)s * T + t;
    const bool use_band = st.last_detection <= a.p[kNReset];

    // ---- Search intervals and interval moments (band_intervals selected
    // against the blind intervals, interval_moments), the integer sums
    // and the corridor certificate's violations ----
    long long acc[kIntSums];
#pragma unroll
    for (int k = 0; k < kIntSums; ++k) acc[k] = 0;
    for (int y = tid; y < H; y += nt) {
      const float yf = (float)y;
#pragma unroll
      for (int at = 0; at < 2; ++at) {
        if (at >= attempts) continue;
        const int32_t* pref = a.pref[at] + (ft * H + y) * (W + 1);
#pragma unroll
        for (int side = 0; side < 2; ++side) {
          int lo, hi;
          bool valid;
          if (use_band) {
            const float px = poly(st.last[side], yf);
            lo = clampi(sat_int(floorf(px - a.f[kBw0 + at])) + 1, 0, W);
            hi = clampi(sat_int(ceilf(px + a.f[kBw0 + at])), 0, W);
            valid = y >= a.p[kTopCut0 + at] && y < a.p[kRowEnd0 + at];
          } else {
            const int k0 = side ? kRightLo : kLeftLo;
            lo = field<int32_t>(a.iv[at], k0)[ft * H + y];
            hi = field<int32_t>(a.iv[at], k0 + 1)[ft * H + y];
            valid = field<uint8_t>(a.iv[at], k0 + 2)[ft * H + y] != 0;
          }
          if (a.p[kColRoi] && valid && lo < hi &&
              !(lo >= a.p[kX0] && hi <= a.p[kX1]))
            acc[16 + at] += 1;
          const int lo_c = clampi(lo, 0, W);
          const int hi_c = max(clampi(hi, 0, W), lo_c);
          const int32_t diff = pref[hi_c] - pref[lo_c];
          const int32_t n = valid ? (diff & mask) : 0;
          const int32_t sx = valid ? (diff >> a.p[kShift]) : 0;
          const int c = 2 * at + side;
          row_n[c * H + y] = n;
          row_sx[c * H + y] = sx;
          const float nf = (float)n;
          acc[4 * c] += n;
          acc[4 * c + 1] += (long long)(nf * yf);
          acc[4 * c + 2] += (long long)(nf * (yf * yf));
          acc[4 * c + 3] += (long long)(float)sx;
        }
      }
    }
    if (a.p[kColRoi] && !use_band) {
      // The blind search's per-level reads (a band reads none).
#pragma unroll
      for (int at = 0; at < 2; ++at) {
        if (at >= attempts) continue;
        const int L = a.p[kL0 + at];
        for (int l = tid; l < L; l += nt) {
          for (int side = 0; side < 2; ++side) {
            const int k0 = side ? kRightReadLo : kLeftReadLo;
            const int lo = field<int32_t>(a.iv[at], k0)[ft * L + l];
            const int hi = field<int32_t>(a.iv[at], k0 + 1)[ft * L + l];
            if (lo < hi && !(lo >= a.p[kX0] && hi <= a.p[kX1]))
              acc[16 + at] += 1;
          }
        }
      }
    }
    block_reduce<long long, kIntSums>(acc, part_i, tot_i);

    // ---- The fit's float moments (fit_poly_rows) ----
    float fs[kFloatSums];
#pragma unroll
    for (int k = 0; k < kFloatSums; ++k) fs[k] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c >= fits) continue;
      const Moments m = moments(tot_i, c);
      float* f = fs + 7 * c;
      for (int y = tid; y < H; y += nt) {
        const float nf = (float)row_n[c * H + y];
        const float t1 = ((float)y - m.my) / m.sy;
        const float u = ((float)row_sx[c * H + y] - nf * m.mx) / Wf;
        const float t2 = t1 * t1;
        f[0] += nf * t1;
        f[1] += nf * t2;
        f[2] += nf * (t2 * t1);
        f[3] += nf * (t2 * t2);
        f[4] += u;
        f[5] += u * t1;
        f[6] += u * t2;
      }
    }
    block_reduce<float, kFloatSums>(fs, part_f, tot_f);

    // ---- The solves, one thread a fit ----
    if (tid < fits) {
      solve_fit(moments(tot_i, tid), tot_f + 7 * tid, Wf, coef[tid]);
    }
    __syncthreads();

    // ---- Samples in the image at the validity grid (poly_points_meta) ----
    {
      int cnt[4] = {0, 0, 0, 0};
      for (int i = tid; i < H; i += nt) {
        const float py = a.ploty_v[i];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (c >= fits) continue;
          const float x = poly(coef[c], py);
          cnt[c] += (x <= Wm1 && x >= 0.0f) ? 1 : 0;
        }
      }
      block_reduce<int, 4>(cnt, part_c, tot_c);
    }

    // ---- Validity, the attempt taken, the history, the smoothed fit and
    // the radius (check_validity, back_half's selection, _update) ----
    if (tid == 0) {
      bool det[2], val[2], roi[2];
      for (int at = 0; at < attempts; ++at) {
        det[at] = tot_i[4 * (2 * at)] > 0 && tot_i[4 * (2 * at + 1)] > 0;
        val[at] = det[at] && validity(a, coef[2 * at], coef[2 * at + 1],
                                      tot_c[2 * at], tot_c[2 * at + 1]);
        roi[at] = tot_i[16 + at] == 0;
      }
      const int sel = (attempts == 2 && !val[0]) ? 1 : 0;
      const bool valid = val[sel];
      const float* lc = coef[2 * sel];
      const float* rc = coef[2 * sel + 1];

      for (int k = 0; k < 2; ++k) {
        for (int i = 0; i + 1 < NA; ++i)
          for (int j = 0; j < 3; ++j) st.hist[k][i][j] = st.hist[k][i + 1][j];
        for (int j = 0; j < 3; ++j) {
          const float x = valid ? coef[2 * sel + k][j] : 0.0f;
          st.hist[k][NA - 1][j] = x;
          if (valid) st.last[k][j] = x;
        }
      }
      for (int i = 0; i + 1 < NA; ++i) st.hist_valid[i] = st.hist_valid[i + 1];
      st.hist_valid[NA - 1] = valid;
      st.last_detection = valid ? 0 : st.last_detection + 1;

      float denom = 0.0f;
      for (int i = 0; i < NA; ++i) denom += (float)st.hist_valid[i];
      denom = fmaxf(denom, 1.0f);
      for (int k = 0; k < 2; ++k) {
        for (int j = 0; j < 3; ++j) {
          float sum = 0.0f;
          for (int i = 0; i < NA; ++i)
            sum += (float)st.hist_valid[i] * st.hist[k][i][j];
          fr.avg_new[k][j] = sum / denom;
          if (valid) st.avg[k][j] = fr.avg_new[k][j];
        }
      }
      const bool draw =
          valid || (st.has_avg && st.last_detection <= a.p[kNFail]);
      st.has_avg = st.has_avg || valid;

      const float frame_radius =
          truncf(0.5f * (curve_radius(a, lc) + curve_radius(a, rc)));
      for (int i = 0; i + 1 < NA; ++i) st.radii[i] = st.radii[i + 1];
      st.radii[NA - 1] = valid ? frame_radius : -1.0f;
      int n_pos = 0;
      float rsum = 0.0f;
      for (int i = 0; i < NA; ++i) {
        const bool pos = st.radii[i] > 0.0f;
        n_pos += pos;
        rsum += pos ? st.radii[i] : 0.0f;
      }
      if (valid) st.avg_radius = truncf(rsum / (float)(n_pos > 1 ? n_pos : 1));
      st.counter += 1;
      st.success += valid;

      int32_t* o_i;
      uint8_t* o_b;
      float* o_f;
      o_i = field<int32_t>(a.out, kRenderMode); o_i[ft] = draw ? 0 : 1;
      o_b = field<uint8_t>(a.out, kValid); o_b[ft] = valid;
      o_b = field<uint8_t>(a.out, kDetected); o_b[ft] = det[sel];
      o_i = field<int32_t>(a.out, kSearchMode); o_i[ft] = use_band;
      o_i = field<int32_t>(a.out, kNAttempts);
      o_i[ft] = (attempts == 2 && !val[0]) ? 2 : 1;
      o_i = field<int32_t>(a.out, kNPointsLeft); o_i[ft] = tot_c[2 * sel];
      o_i = field<int32_t>(a.out, kNPointsRight); o_i[ft] = tot_c[2 * sel + 1];
      o_b = field<uint8_t>(a.out, kA1Detected); o_b[ft] = det[0];
      o_b = field<uint8_t>(a.out, kA1Valid); o_b[ft] = val[0];
      o_i = field<int32_t>(a.out, kA1NLeft); o_i[ft] = tot_c[0];
      o_i = field<int32_t>(a.out, kA1NRight); o_i[ft] = tot_c[1];
      o_b = field<uint8_t>(a.out, kCorridorOk); o_b[ft] = roi[0] && roi[sel];
      for (int j = 0; j < 3; ++j) {
        field<float>(a.out, kLeftCoeffs)[ft * 3 + j] = lc[j];
        field<float>(a.out, kRightCoeffs)[ft * 3 + j] = rc[j];
        field<float>(a.out, kA1LeftCoeffs)[ft * 3 + j] = coef[0][j];
        field<float>(a.out, kA1RightCoeffs)[ft * 3 + j] = coef[1][j];
        o_f = field<float>(a.meta, kCoeffsLeft); o_f[ft * 3 + j] = st.avg[0][j];
        o_f = field<float>(a.meta, kCoeffsRight); o_f[ft * 3 + j] = st.avg[1][j];
      }
      field<uint8_t>(a.meta, kDraw)[ft] = draw;
      fr.valid = valid;
    }
    __syncthreads();

    // ---- The render geometry of the smoothed fit (a valid frame only) ----
    if (fr.valid) {
      int g[4] = {0, 0, NR, NR};  // count left, right; first left, right
      for (int i = tid; i < H; i += nt) {
        const float py = i < NR ? a.ploty_r[i] : 0.0f;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          float x = 0.0f;
          if (i < NR) {
            x = poly(fr.avg_new[k], py);
            if (x <= Wm1 && x >= 0.0f) {
              g[k] += 1;
              g[2 + k] = min(g[2 + k], i);
            }
          }
          rfitx[k * H + i] = x;
        }
      }
      block_reduce<int, 4, 2>(g, part_c, tot_c);
      if (tid == 0) {
        // eccentricity_m from the bottom-most samples of the graphs
        float bx[2];
        for (int k = 0; k < 2; ++k) {
          st.rn[k] = tot_c[k];
          st.rfirst[k] = tot_c[2 + k];
          const int bottom = clampi(tot_c[2 + k] + tot_c[k] - 1, 0, NR - 1);
          bx[k] = truncf(rfitx[k * H + bottom]);
        }
        const float mid = (float)(W / 2);
        st.ecc = ((mid - bx[0]) - (bx[1] - mid)) / 2.0f * a.f[kMpph];
      }
      __syncthreads();
    }

    // ---- This frame's remaining outputs ----
    for (int i = tid; i < H; i += nt) {
      field<float>(a.meta, kFitxLeft)[ft * H + i] = rfitx[i];
      field<float>(a.meta, kFitxRight)[ft * H + i] = rfitx[H + i];
    }
    if (tid == 0) {
      field<float>(a.out, kRadius)[ft] = st.avg_radius;
      field<float>(a.out, kEccOut)[ft] = st.ecc;
      field<int32_t>(a.meta, kNLeft)[ft] = st.rn[0];
      field<int32_t>(a.meta, kNRight)[ft] = st.rn[1];
      field<int32_t>(a.meta, kFirstLeft)[ft] = st.rfirst[0];
      field<int32_t>(a.meta, kFirstRight)[ft] = st.rfirst[1];
    }
    __syncthreads();
  }

  // ---- The state out ----
  for (int i = tid; i < H; i += nt) {
    field<float>(a.st_out, kRfitxLeft)[(long long)s * H + i] = rfitx[i];
    field<float>(a.st_out, kRfitxRight)[(long long)s * H + i] = rfitx[H + i];
  }
  if (tid == 0) {
    field<int32_t>(a.st_out, kLastDetection)[s] = st.last_detection;
    for (int i = 0; i < NA; ++i) {
      for (int j = 0; j < 3; ++j) {
        field<float>(a.st_out, kHistLeft)[(s * NA + i) * 3 + j] = st.hist[0][i][j];
        field<float>(a.st_out, kHistRight)[(s * NA + i) * 3 + j] = st.hist[1][i][j];
      }
      field<uint8_t>(a.st_out, kHistValid)[s * NA + i] = st.hist_valid[i];
      field<float>(a.st_out, kRadii)[s * NA + i] = st.radii[i];
    }
    for (int j = 0; j < 3; ++j) {
      field<float>(a.st_out, kLastLeft)[s * 3 + j] = st.last[0][j];
      field<float>(a.st_out, kLastRight)[s * 3 + j] = st.last[1][j];
      field<float>(a.st_out, kAvgLeft)[s * 3 + j] = st.avg[0][j];
      field<float>(a.st_out, kAvgRight)[s * 3 + j] = st.avg[1][j];
    }
    field<uint8_t>(a.st_out, kHasAvg)[s] = st.has_avg;
    field<int32_t>(a.st_out, kRnLeft)[s] = st.rn[0];
    field<int32_t>(a.st_out, kRnRight)[s] = st.rn[1];
    field<int32_t>(a.st_out, kRfirstLeft)[s] = st.rfirst[0];
    field<int32_t>(a.st_out, kRfirstRight)[s] = st.rfirst[1];
    field<float>(a.st_out, kAvgRadius)[s] = st.avg_radius;
    field<float>(a.st_out, kEcc)[s] = st.ecc;
    field<int32_t>(a.st_out, kCounter)[s] = st.counter;
    field<int32_t>(a.st_out, kSuccess)[s] = st.success;
  }
}

long long g_launches = 0;  // lt_back_half_launches

}  // namespace

extern "C" {

// ptrs: kPtrs device pointers (0 for an attempt the scan does not run);
// ip: kIntParams ints; fp: kFloatParams floats.  Returns a CUDA error code
// (cudaErrorInvalidValue for tables or sizes the kernel does not take).
int lt_back_half(const void* ptrs, int n_ptrs, const void* ip, int n_ip,
                 const void* fp, int n_fp, void* stream) {
  if (n_ptrs != kPtrs || n_ip != kIntParams || n_fp != kFloatParams)
    return cudaErrorInvalidValue;
  const long long* pt = static_cast<const long long*>(ptrs);
  Args args;
  int k = 0;
  for (int at = 0; at < 2; ++at) {
    args.pref[at] = reinterpret_cast<const int32_t*>(pt[k++]);
    for (int f = 0; f < kIvFields; ++f)
      args.iv[at][f] = reinterpret_cast<const void*>(pt[k++]);
  }
  args.ploty_v = reinterpret_cast<const float*>(pt[k++]);
  args.ploty_r = reinterpret_cast<const float*>(pt[k++]);
  for (int f = 0; f < kStateFields; ++f)
    args.st_in[f] = reinterpret_cast<const void*>(pt[k++]);
  for (int f = 0; f < kStateFields; ++f)
    args.st_out[f] = reinterpret_cast<void*>(pt[k++]);
  for (int f = 0; f < kOutFields; ++f)
    args.out[f] = reinterpret_cast<void*>(pt[k++]);
  for (int f = 0; f < kMetaFields; ++f)
    args.meta[f] = reinterpret_cast<void*>(pt[k++]);
  const int* ints = static_cast<const int*>(ip);
  const float* floats = static_cast<const float*>(fp);
  for (int i = 0; i < kIntParams; ++i) args.p[i] = ints[i];
  for (int i = 0; i < kFloatParams; ++i) args.f[i] = floats[i];
  const int H = args.p[kH], attempts = args.p[kAttempts];
  if (args.p[kS] < 1 || args.p[kT] < 1 || H < 1 || args.p[kW] < 1 ||
      args.p[kNAvg] < 1 || args.p[kNAvg] > kMaxAvg ||
      args.p[kNRender] < 1 || args.p[kNRender] > H ||
      (attempts != 1 && attempts != 2))
    return cudaErrorInvalidValue;
  // Per row: the four fits' counts and x-sums, the two graphs.
  const size_t smem = (size_t)H * (8 * sizeof(int32_t) + 2 * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      back_half_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  back_half_scan_kernel<<<args.p[kS], kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(args);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++g_launches;
  return err;
}

long long lt_back_half_launches(void) { return g_launches; }

}  // extern "C"
