// Hand-written Hopper (sm_90a) kernels for the front half's warp + LAB-B:
// the fixed-point undistort, the float bird's-eye warp and LAB-B, from the
// raw rows of T frames to the uint8 R and LAB-B planes, in two launches.
//
// They replace no Pallas kernel.  The JAX package leaves this stage to XLA
// (lane_tracker_tpu/tracker/step.py `_warp_channels`: the gathers of
// kernels/resample.py and the LAB-B of ops/color.py), which fuses the
// gathers, the multiply-adds and the colour arithmetic into a few passes.
// The port ran it as a chain of PyTorch operators: four `index_select`s a
// stage, the warp's multiply-adds in float64 with an `index_copy` of the
// corrected pixels, some 30 elementwise passes of LAB-B, each writing its
// float64 or int32 intermediate of the whole batch to device memory (24
// bytes a channel of each warped pixel).  It took most of the card's time
// a frame in every configuration, some 850 times its roofline.  These two
// kernels compute the same values, bit for bit, and keep every
// intermediate of a frame out of device memory but the undistorted band.
//
// What bounds them on the H100.  The image bytes are few: a 'fast' frame
// reads 0.92 MB of raw rows (240 rows of 1280 RGB pixels) and writes two
// 1.19 MB planes (1100 x 1080), some 1 us at 3.35 TB/s.  The grids are
// twenty times larger (40 bytes a warped pixel as the port's ResampleGrid
// holds them: an int64 base and four float64 weights; 24 bytes an
// undistorted pixel), and the work is a gather: 12 byte loads an
// undistorted pixel, 12 a warped pixel, then 5 table reads of LAB-B.  So
// the kernels are bound by their load instructions and their latency, and
// the grids must not be read again for every frame.  The design:
//
// * Each grid is read once a launch.  A thread owns its pixels for the
//   whole batch: it loads their grid entries into registers once, then
//   walks the launch's T frames (a slice of 36 offline, the fleet's whole
//   device batch), so a grid entry is read once for T frames.  The grids
//   are read in place, as the params hold them for the twin: a copy in
//   int32 and float32 would halve bytes read once a call, and add 30 MB
//   to the card's params and to every cell's peak memory.
// * Two launches.  `undistort_kernel` writes the undistorted image, uint8
//   (T, rows, Wc, 3): one thread an undistorted pixel, four raw taps of
//   three channels a frame.  `warp_lab_kernel` reads it back through the
//   L2 (a frame's band is 0.91 MB, a slice's 33 MB) and writes the R and
//   LAB-B planes: one thread four consecutive warped pixels (its two
//   planes one 4-byte store each a frame).  The other design, recomputing
//   each undistorted tap inside the warp, would undistort every pixel of
//   the band about 15 times over ('fast' warps 1.19 M pixels from 0.30 M
//   undistorted ones, four taps each): more load instructions than the
//   band's one write and read cost.
// * LAB-B from tables in shared memory: `gamma_tab` (256 int32) and
//   `cbrt_tab` (3072 int32) of ops/color.py's `_tables()`, loaded by each
//   block once.  The reference's degree-12 gamma polynomial rounds to
//   `gamma_tab` on all 256 inputs (tests/test_torch_warp_lab.py), so the
//   table gives its values, and the card's `cbrtf` never enters.
//
// Arithmetic, the twin's (tracker/step.py `warp_rows_plain`) bit for bit:
// the undistort's 2^15 int32 weights, `(acc + 2^14) >> 15`, clipped; the
// warp's float32 chain `fma(p11, w11, fma(p10, w10, fma(p00, w00,
// p01 * w01)))` with `__fmul_rn` and `__fmaf_rn`, each rounding once as the
// twin's float64 sums and `fma_f32` do, then round half to even (`rintf`)
// and clip; LAB-B's int32 rows and descales of `rgb2lab_b_fast`.  Every
// tap lies inside its image (`slot_remap` clips each window; a tap off the
// image carries weight 0), so no load is masked.
//
// Plain C interface, loaded with ctypes: `lt_warp_lab` launches both
// kernels on the stream it is given, allocates nothing (the wrapper,
// kernels/warp_lab.py, passes the band and the planes), counts each launch
// taken in lt_warp_lab_launches and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// Warped pixels a thread of warp_lab_kernel.
constexpr int kQuad = 4;
constexpr int kGammaTab = 256;
constexpr int kCbrtTab = 3072;
constexpr int kLabShift = 12;
constexpr int kLabShift2 = 15;
constexpr int kCoefBits = 15;

long long g_launches = 0;  // lt_warp_lab_launches

// Rows 1 and 2 (Y and Z) of LAB's fixed-point XYZ matrix.
struct LabRows {
  int y0, y1, y2, z0, z1, z2;
};

__device__ __forceinline__ uint8_t clip_u8(int v) {
  return (uint8_t)min(max(v, 0), 255);
}

// The float warp's one channel: the f32 fma chain, rounded half to even
// and clipped.
__device__ __forceinline__ uint8_t warp_channel(float p00, float p01,
                                                float p10, float p11,
                                                float4 w) {
  float acc = __fmul_rn(p01, w.y);
  acc = __fmaf_rn(p00, w.x, acc);
  acc = __fmaf_rn(p10, w.z, acc);
  acc = __fmaf_rn(p11, w.w, acc);
  return (uint8_t)fminf(fmaxf(rintf(acc), 0.0f), 255.0f);
}

// OpenCV's fixed-point LAB-B of one uint8 RGB pixel (ops/color.py
// `rgb2lab_b_fast`, `rgb2lab_b_u8`).
__device__ __forceinline__ uint8_t lab_b(int R, int G, int B,
                                         const int* gamma_s,
                                         const int* cbrt_s,
                                         const LabRows& c) {
  const int r = gamma_s[R], g = gamma_s[G], b = gamma_s[B];
  const int half = 1 << (kLabShift - 1);
  const int iy = min(max((r * c.y0 + g * c.y1 + b * c.y2 + half) >> kLabShift,
                         0), kCbrtTab - 1);
  const int iz = min(max((r * c.z0 + g * c.z1 + b * c.z2 + half) >> kLabShift,
                         0), kCbrtTab - 1);
  const int v = (200 * (cbrt_s[iy] - cbrt_s[iz]) + (128 << kLabShift2) +
                 (1 << (kLabShift2 - 1))) >> kLabShift2;
  return clip_u8(v);
}

// The grids as the port's ResampleGrid holds them: an int64 base a pixel
// (the flattened source pixel of its window's top-left tap) and four
// weight planes, int32 2^15 weights for the undistort, float64 holding
// float32 values for the warp.
template <typename W>
struct Grid {
  const long long* base;
  const W* w00;
  const W* w01;
  const W* w10;
  const W* w11;
};

// One thread an undistorted pixel p of the M a frame: its base and its
// four weights read once, then its three channels for each of the T
// frames.
__global__ void __launch_bounds__(kThreads)
undistort_kernel(const uint8_t* __restrict__ raw, long long raw_frame,
                 int raw_width, Grid<int> grid, int M,
                 uint8_t* __restrict__ band, int T) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= M) return;
  const int w00 = grid.w00[p], w01 = grid.w01[p];
  const int w10 = grid.w10[p], w11 = grid.w11[p];
  const uint8_t* src = raw + 3 * grid.base[p];
  const long long down = 3ll * raw_width;
  uint8_t* dst = band + 3ll * p;
  const long long band_frame = 3ll * M;
  for (int t = 0; t < T; ++t) {
    const uint8_t* s = src + t * raw_frame;
    uint8_t* d = dst + t * band_frame;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int acc = s[c] * w00 + s[3 + c] * w01 + s[down + c] * w10 +
                      s[down + 3 + c] * w11;
      d[c] = clip_u8((acc + (1 << (kCoefBits - 1))) >> kCoefBits);
    }
  }
}

// One thread four consecutive warped pixels of the N a frame: their bases
// and weights read once (a pixel past N reads base 0 and weight 0, and is
// not stored), then for each of the T frames their four taps of the band,
// the warped RGB, R and LAB-B.
__global__ void __launch_bounds__(kThreads)
warp_lab_kernel(const uint8_t* __restrict__ band, int band_width, int M,
                Grid<double> grid, int N, const int* __restrict__ gamma_tab,
                const int* __restrict__ cbrt_tab, LabRows rows,
                uint8_t* __restrict__ r_out, uint8_t* __restrict__ b_out,
                int T, int vec) {
  __shared__ int gamma_s[kGammaTab];
  __shared__ int cbrt_s[kCbrtTab];
  for (int i = threadIdx.x; i < kGammaTab; i += kThreads)
    gamma_s[i] = gamma_tab[i];
  for (int i = threadIdx.x; i < kCbrtTab; i += kThreads)
    cbrt_s[i] = cbrt_tab[i];
  __syncthreads();
  const int p0 = kQuad * (blockIdx.x * kThreads + threadIdx.x);
  if (p0 >= N) return;
  long long base[kQuad];
  float4 w[kQuad];
#pragma unroll
  for (int k = 0; k < kQuad; ++k) {
    const int p = p0 + k;
    const bool in = p < N;
    base[k] = in ? grid.base[p] : 0;
    // Each weight is a float32 value: the cast is exact.
    w[k] = in ? make_float4((float)grid.w00[p], (float)grid.w01[p],
                            (float)grid.w10[p], (float)grid.w11[p])
              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  const long long down = 3ll * band_width;
  const long long band_frame = 3ll * M;
  for (int t = 0; t < T; ++t) {
    const uint8_t* src = band + t * band_frame;
    uint8_t r[kQuad], b[kQuad];
#pragma unroll
    for (int k = 0; k < kQuad; ++k) {
      const uint8_t* s = src + 3 * base[k];
      uint8_t rgb[3];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        rgb[c] = warp_channel(s[c], s[3 + c], s[down + c], s[down + 3 + c],
                              w[k]);
      r[k] = rgb[0];
      b[k] = lab_b(rgb[0], rgb[1], rgb[2], gamma_s, cbrt_s, rows);
    }
    const long long at = (long long)t * N + p0;
    if (vec) {
      *reinterpret_cast<uchar4*>(r_out + at) =
          make_uchar4(r[0], r[1], r[2], r[3]);
      *reinterpret_cast<uchar4*>(b_out + at) =
          make_uchar4(b[0], b[1], b[2], b[3]);
    } else {
#pragma unroll
      for (int k = 0; k < kQuad; ++k) {
        if (p0 + k < N) {
          r_out[at + k] = r[k];
          b_out[at + k] = b[k];
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// raw: the first of T frames' raw rows, uint8 RGB, a frame every
// raw_frame bytes, rows of raw_width pixels.  und_*: the undistort grid
// over its M = rows x band_width pixels (int64 bases, int32 weights).
// band: T x M x 3 bytes of scratch.  warp_*: the warp grid over its N
// pixels (int64 bases into the band, float64 weights holding float32
// values).  gamma_tab, cbrt_tab: ops/color.py's tables on the device;
// c_*: LAB's Y and Z rows.  r_out, b_out: T x N bytes each.  Returns a
// CUDA error code (cudaErrorInvalidValue for sizes the kernels do not
// take).
int lt_warp_lab(const void* raw, int raw_frame, int raw_width,
                const void* und_base, const void* und_w00,
                const void* und_w01, const void* und_w10,
                const void* und_w11, int M, int band_width, void* band,
                const void* warp_base, const void* warp_w00,
                const void* warp_w01, const void* warp_w10,
                const void* warp_w11, int N, const void* gamma_tab,
                const void* cbrt_tab, int c_y0, int c_y1, int c_y2, int c_z0,
                int c_z1, int c_z2, void* r_out, void* b_out, int T,
                void* stream) {
  if (T < 1 || M < 1 || N < 1 || raw_width < 2 || band_width < 2 ||
      raw_frame < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Grid<int> und{static_cast<const long long*>(und_base),
                      static_cast<const int*>(und_w00),
                      static_cast<const int*>(und_w01),
                      static_cast<const int*>(und_w10),
                      static_cast<const int*>(und_w11)};
  undistort_kernel<<<(M + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const uint8_t*>(raw), raw_frame, raw_width, und, M,
      static_cast<uint8_t*>(band), T);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++g_launches;
  const Grid<double> warp{static_cast<const long long*>(warp_base),
                          static_cast<const double*>(warp_w00),
                          static_cast<const double*>(warp_w01),
                          static_cast<const double*>(warp_w10),
                          static_cast<const double*>(warp_w11)};
  const int vec = N % kQuad == 0 &&
                  reinterpret_cast<uintptr_t>(r_out) % kQuad == 0 &&
                  reinterpret_cast<uintptr_t>(b_out) % kQuad == 0;
  const LabRows rows{c_y0, c_y1, c_y2, c_z0, c_z1, c_z2};
  const int quads = (N + kQuad - 1) / kQuad;
  warp_lab_kernel<<<(quads + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const uint8_t*>(band), band_width, M, warp, N,
      static_cast<const int*>(gamma_tab), static_cast<const int*>(cbrt_tab),
      rows, static_cast<uint8_t*>(r_out), static_cast<uint8_t*>(b_out), T,
      vec);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++g_launches;
  return err;
}

long long lt_warp_lab_launches(void) { return g_launches; }

}  // extern "C"
