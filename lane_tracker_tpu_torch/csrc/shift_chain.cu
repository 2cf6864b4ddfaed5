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
// left shifts wrap in the type (the wrap JAX gives; the SIMD forms __vadd4
// and __vadd2 wrap each lane), right shifts of int32 are arithmetic, and
// bf16 rounds after every op (__hadd2, __hmin2, __hmul2, ... round each
// element; a sum or product of two bf16 values is exact in f32, so one
// rounding equals PyTorch's f32-then-round).
//
// What bounds them on the H100: one read and one write of the block against
// K = 64 passes of 1-5 ops per element (chip_smoke.py's chain_work).  The
// design keeps every pass in registers (shift_chain.cuh):
//   * A single-axis chain splits into independent lines along its shift
//     axis, and a line into the orbits of its shift: a roll by s reads
//     p - s, so its orbits are the gcd(s, L) cycles p, p - s, p - 2s, ...;
//     a slice reads p + s, so its orbits are the residue classes mod s,
//     each ending at the fill.  Listed in orbit order, every element reads
//     the next one, so a pass is a shift by one slot: a lane holds kRegs
//     consecutive slots in registers, reads its neighbour from the next
//     register, the next lane's first register by one __shfl_sync, and an
//     orbit's end reads the fill or, for a roll, its cycle's first slot,
//     which a cycle keeps at register 0 of a lane of its own.  A line
//     whose orbits take more than one warp's 32 lanes takes the plain
//     order below.  Where one warp's
//     lanes give a roll's cycles at least as many padding slots as
//     passes, the padding continues each cycle and no slot is an end (no
//     select in the pass).  The plan is make_orbits / OrbitCursor,
//     mirrored in tests/torch_filter_models.py.  Narrow types are packed:
//     a 32-bit word holds four uint8/int8 or two int16/bf16 lines at the
//     same slot (8-bit lines pass in two halves of 16-bit lanes, where min
//     and max are single instructions), combined by __vmins2, __vminu2,
//     __hmin2, ...  A CTA stages its lines through shared memory once each
//     way: whole rows for a lane shift, a strip of word columns for a
//     sublane shift.
//   * The packed-u16 body (two shifts, p - 8 and p - 9, on two orbits)
//     keeps plain order, a lane's run of 40 positions in registers and
//     the previous lane's last nine by shuffles; other pairs, slices whose
//     orbits are shorter than a run, rolls that would leave half their
//     slots padding and lines longer than a warp's slots pass in plain
//     order through shared buffers, one barrier a pass (a warp's when the
//     line fits one).
//   * The elementwise bodies run on 16-byte words, 8 packed words a thread.
//   * The 2-D chain's outer step reads 9 rows and 9 columns below each
//     output (rolls by a1 + a2 and b1 + b2, wrapping), so a tile of outputs
//     runs m outer steps in shared memory from its inputs over a halo of
//     m * 9 rows and m * 10 columns (indices wrap modulo the block, so
//     blocks smaller than the halo are exact), recomputing the halo; the
//     outer / m launches (m = k2dSteps) pass the block through global
//     memory.  No grid barrier.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "common.cuh"
#include "shift_chain.cuh"

namespace {

using lt_chain::bf16;
using lt_chain::ChainArgs;
using lt_chain::sm_count;

cudaError_t dispatch(const ChainArgs& a, int dtype, int body, int bound) {
  using Group = cudaError_t (*)(const ChainArgs&, int, int, int);
  const Group groups[] = {lt_chain::dispatch_8bit, lt_chain::dispatch_i16,
                          lt_chain::dispatch_32bit, lt_chain::dispatch_bf16};
  for (const Group group : groups) {
    const cudaError_t err = group(a, dtype, body, bound);
    if (err != cudaErrorInvalidValue) return err;
  }
  return cudaErrorInvalidValue;
}

// ---- lt_shift_chain_2d ---------------------------------------------------------

// bf16_morph_chain8, one outer step:
//   p = min(x, roll(x, a1, lanes)); q = min(p, roll(p, a2, lanes));
//   p = max(q, roll(q, b1, rows));  x = x - max(p, roll(p, b2, rows)).
// A roll reads towards lower indices, so output (r, c) of one step reads x
// over rows [r - b1 - b2, r] and columns [c - a1 - a2, c].  A CTA takes a
// tile of th x tw outputs and stages its input region, its rows and
// columns extended below by the halo m steps read, each index modulo the
// block; two bf16 columns a 32-bit word, so a column roll by an odd count
// joins two words (__byte_perm).  Each sub-step updates the part of the
// region whose inputs are still exact, from word columns chain2d_col0
// gives; after m steps the tile's outputs are exact.  Three region
// buffers: x, p, q.
constexpr int k2dTx = 32;
constexpr int k2dTy = 16;
// Outer steps a launch of lt_shift_chain_2d takes: 4 measured fastest on
// the H100 of 1, 2, 4, 8 and 16 (PERF.md).
constexpr int k2dSteps = 4;

// First word column that is exact after sub-step `sub` (0-3) of step t,
// the columns exact from an even column (a word's two columns both exact).
__host__ __device__ inline int chain2d_col0(int t, int sub, int a1, int a2) {
  int c = 0;
  for (int i = 0; i <= t; ++i) {
    c = (c + a1 + 1) & ~1;
    if (i == t && sub == 0) return c;
    c = (c + a2 + 1) & ~1;
  }
  return c;
}

struct Chain2dArgs {
  int H, W, steps, a1, a2, b1, b2;
  int th, tw;   // output tile
  int rh, rww;  // region rows and 32-bit words a row
  int col0;     // region column of the tile's first output
};

__device__ __forceinline__ __nv_bfloat162 as_h2(uint32_t w) {
  return lt_chain::Lanes<bf16>::h2(w);
}
__device__ __forceinline__ uint32_t as_w(__nv_bfloat162 h) {
  return lt_chain::Lanes<bf16>::w2(h);
}

// Stage a tile's region: region row i, column j from block row
// (r0 - steps * (b1 + b2) + i) mod H, column (c0 - col0 + j) mod W.
__device__ __forceinline__ void stage_region(const bf16* __restrict__ src,
                                             uint32_t* X, const Chain2dArgs& a,
                                             int r0, int c0) {
  const int gr0 = r0 - a.steps * (a.b1 + a.b2);
  const int gc0 = c0 - a.col0;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const unsigned short* s16 = reinterpret_cast<const unsigned short*>(src);
  int gcx = (gc0 + 2 * tx) % a.W;
  if (gcx < 0) gcx += a.W;
  for (int r = ty; r < a.rh; r += k2dTy) {
    int gr = (gr0 + r) % a.H;
    if (gr < 0) gr += a.H;
    const unsigned short* row = s16 + (size_t)gr * a.W;
    int gc = gcx;
    for (int w = tx; w < a.rww; w += k2dTx) {
      const int gc1 = gc + 1 == a.W ? 0 : gc + 1;
      X[r * a.rww + w] = row[gc] | ((uint32_t)row[gc1] << 16);
      gc += 2 * k2dTx;
      gc = a.W >= 2 * k2dTx ? (gc >= a.W ? gc - a.W : gc) : gc % a.W;
    }
  }
}

// Write a tile's outputs: region rows from steps * (b1 + b2), columns
// from col0.
__device__ __forceinline__ void write_tile(const uint32_t* X,
                                           bf16* __restrict__ dst,
                                           const Chain2dArgs& a, int r0,
                                           int c0) {
  const unsigned short* x16 = reinterpret_cast<const unsigned short*>(X);
  unsigned short* d16 = reinterpret_cast<unsigned short*>(dst);
  const int rows = min(a.th, a.H - r0), cols = min(a.tw, a.W - c0);
  const int row0 = a.steps * (a.b1 + a.b2);
  for (int i = threadIdx.y; i < rows; i += k2dTy) {
    const unsigned short* xr = x16 + (size_t)(row0 + i) * 2 * a.rww;
    for (int j = threadIdx.x; j < cols; j += k2dTx)
      d16[(size_t)(r0 + i) * a.W + c0 + j] = xr[a.col0 + j];
  }
}

__global__ void __launch_bounds__(k2dTx * k2dTy)
    chain2d_kernel(const bf16* __restrict__ src, bf16* __restrict__ dst,
                   Chain2dArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.rh * a.rww;
  uint32_t* X = reinterpret_cast<uint32_t*>(smem_raw);
  uint32_t* Pb = X + n;
  uint32_t* Q = Pb + n;
  const int db = a.b1 + a.b2;
  const int r0 = blockIdx.y * a.th;
  const int c0 = blockIdx.x * a.tw;
  const int tx = threadIdx.x, ty = threadIdx.y;
  stage_region(src, X, a, r0, c0);
  __syncthreads();

  // The column neighbour s columns back of word w of buffer row B.
  auto colnb = [](const uint32_t* B, int w, int s) -> uint32_t {
    if ((s & 1) == 0) return B[w - (s >> 1)];
    return __byte_perm(B[w - ((s + 1) >> 1)], B[w - ((s - 1) >> 1)], 0x5432);
  };
  int cw = 0;  // first exact column at the step's start (even)
  for (int t = 0; t < a.steps; ++t) {
    const int rv = t * db;
    const int c1 = (cw + a.a1 + 1) & ~1;
    const int c2 = (c1 + a.a2 + 1) & ~1;
    for (int r = rv + ty; r < a.rh; r += k2dTy) {
      const uint32_t* xr = X + r * a.rww;
      uint32_t* pr = Pb + r * a.rww;
      for (int w = (c1 >> 1) + tx; w < a.rww; w += k2dTx)
        pr[w] = as_w(__hmin2(as_h2(xr[w]), as_h2(colnb(xr, w, a.a1))));
    }
    __syncthreads();
    for (int r = rv + ty; r < a.rh; r += k2dTy) {
      const uint32_t* pr = Pb + r * a.rww;
      uint32_t* qr = Q + r * a.rww;
      for (int w = (c2 >> 1) + tx; w < a.rww; w += k2dTx)
        qr[w] = as_w(__hmin2(as_h2(pr[w]), as_h2(colnb(pr, w, a.a2))));
    }
    __syncthreads();
    for (int r = rv + a.b1 + ty; r < a.rh; r += k2dTy) {
      const uint32_t* qr = Q + r * a.rww;
      const uint32_t* qs = qr - a.b1 * a.rww;
      uint32_t* pr = Pb + r * a.rww;
      for (int w = (c2 >> 1) + tx; w < a.rww; w += k2dTx)
        pr[w] = as_w(__hmax2(as_h2(qr[w]), as_h2(qs[w])));
    }
    __syncthreads();
    for (int r = rv + db + ty; r < a.rh; r += k2dTy) {
      const uint32_t* pr = Pb + r * a.rww;
      const uint32_t* ps = pr - a.b2 * a.rww;
      uint32_t* xr = X + r * a.rww;
      for (int w = (c2 >> 1) + tx; w < a.rww; w += k2dTx)
        xr[w] = as_w(__hsub2(as_h2(xr[w]),
                             __hmax2(as_h2(pr[w]), as_h2(ps[w]))));
    }
    __syncthreads();
    cw = c2;
  }
  write_tile(X, dst, a, r0, c0);
}

// The probes' shifts, rolls by 3 then 6 along each axis (every block
// wider and taller than 6), run in registers: a thread takes a run of
// k2dRunW words of a row for the two column rolls, then a run of k2dRunH
// rows of a word column for the two row rolls, each from its run and the
// halo below it in shared memory (x, then q: two region buffers), the
// intermediate p held in registers and recomputed over the halo.
constexpr int k2dRunW = 8;
constexpr int k2dRunH = 16;
constexpr int k2dThreads = k2dTx * k2dTy;

__global__ void __launch_bounds__(k2dThreads)
    chain2d_fast_kernel(const bf16* __restrict__ src, bf16* __restrict__ dst,
                        Chain2dArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.rh * a.rww;
  uint32_t* X = reinterpret_cast<uint32_t*>(smem_raw);
  uint32_t* Q = X + n;
  const int tid = threadIdx.y * k2dTx + threadIdx.x;
  const int r0 = blockIdx.y * a.th;
  const int c0 = blockIdx.x * a.tw;
  stage_region(src, X, a, r0, c0);
  __syncthreads();

  const int runs_w = (a.rww + k2dRunW - 1) / k2dRunW;
  const int runs_h = (a.rh + k2dRunH - 1) / k2dRunH;
  for (int t = 0; t < a.steps; ++t) {
    // q = min(p, p rolled by 6 columns), p = min(x, x rolled by 3): words
    // from 5 (t + 1), rows from 9 t; a run reads x 5 words below it.
    const int w_lo = 5 * (t + 1), r_lo = 9 * t;
    const int wr0 = w_lo / k2dRunW;
    const int items_c = (a.rh - r_lo) * (runs_w - wr0);
    for (int i = tid; i < items_c; i += k2dThreads) {
      const int rr = i / (runs_w - wr0);
      const int r = r_lo + rr;
      const int wb = (wr0 + i - rr * (runs_w - wr0)) * k2dRunW;
      const int w0 = max(wb, w_lo);
      const int wend = min(wb + k2dRunW, a.rww);
      const uint32_t* xr = X + r * a.rww;
      uint32_t xs[k2dRunW + 5], ps[k2dRunW + 3];
#pragma unroll
      for (int j = 0; j < k2dRunW + 5; ++j) {
        const int w = w0 - 5 + j;
        xs[j] = w < a.rww ? xr[w] : 0u;
      }
#pragma unroll
      for (int j = 0; j < k2dRunW + 3; ++j)
        ps[j] = as_w(__hmin2(as_h2(xs[j + 2]),
                             as_h2(__byte_perm(xs[j], xs[j + 1], 0x5432))));
      uint32_t* qr = Q + r * a.rww;
#pragma unroll
      for (int j = 0; j < k2dRunW; ++j)
        if (w0 + j < wend)
          qr[w0 + j] = as_w(__hmin2(as_h2(ps[j + 3]), as_h2(ps[j])));
    }
    __syncthreads();
    // x = x - max(p2, p2 rolled by 6 rows), p2 = max(q, q rolled by 3):
    // rows from 9 (t + 1), words from 5 (t + 1); a run reads q 9 rows up.
    const int r_lo2 = 9 * (t + 1);
    const int hr0 = r_lo2 / k2dRunH;
    const int items_r = (a.rww - w_lo) * (runs_h - hr0);
    for (int i = tid; i < items_r; i += k2dThreads) {
      const int hh = i / (a.rww - w_lo);
      const int w = w_lo + (i - hh * (a.rww - w_lo));
      const int rb = (hr0 + hh) * k2dRunH;
      const int rs = max(rb, r_lo2);
      const int rend = min(rb + k2dRunH, a.rh);
      uint32_t qs[k2dRunH + 9], p2[k2dRunH + 6];
#pragma unroll
      for (int j = 0; j < k2dRunH + 9; ++j) {
        const int r = rs - 9 + j;
        qs[j] = r < a.rh ? Q[r * a.rww + w] : 0u;
      }
#pragma unroll
      for (int j = 0; j < k2dRunH + 6; ++j)
        p2[j] = as_w(__hmax2(as_h2(qs[j + 3]), as_h2(qs[j])));
#pragma unroll
      for (int j = 0; j < k2dRunH; ++j) {
        const int r = rs + j;
        if (r < rend) {
          uint32_t* xp = X + r * a.rww + w;
          *xp = as_w(__hsub2(as_h2(*xp),
                             __hmax2(as_h2(p2[j + 6]), as_h2(p2[j]))));
        }
      }
    }
    __syncthreads();
  }
  write_tile(X, dst, a, r0, c0);
}

// The tiles of one launch of m steps: of the grids of ny x nx tiles (each
// side up to k2dMaxSplit), the one whose busiest SM holds the least region
// area, within the shared memory a CTA may take; the probes' shifts (3
// and 6 on both axes) take two region buffers (chain2d_fast_kernel), any
// other three.
constexpr int k2dMaxSplit = 48;

struct Chain2dPlan {
  Chain2dArgs args;
  dim3 grid;
  size_t smem;
  bool fast;
};

inline bool chain2d_fast(int a1, int a2, int b1, int b2) {
  return a1 == 3 && a2 == 6 && b1 == 3 && b2 == 6;
}

inline bool chain2d_plan(int H, int W, int m, int a1, int a2, int b1, int b2,
                         int sms, Chain2dPlan* out) {
  const bool fast = chain2d_fast(a1, a2, b1, b2);
  const int bufs = fast ? 2 : 3;
  const int col0 = chain2d_col0(m - 1, 1, a1, a2);
  long long best = -1;
  for (int ny = 1; ny <= k2dMaxSplit && ny <= H; ++ny) {
    const int th = (H + ny - 1) / ny;
    if (ny > 1 && (H + th - 1) / th != ny) continue;
    for (int nx = 1; nx <= k2dMaxSplit && nx <= W; ++nx) {
      const int tw = (W + nx - 1) / nx;
      if (nx > 1 && (W + tw - 1) / tw != nx) continue;
      Chain2dArgs c{H, W, m, a1, a2, b1, b2, th, tw, 0, 0, col0};
      c.rh = th + m * (b1 + b2);
      c.rww = (col0 + tw + 1) / 2;
      const size_t smem = (size_t)bufs * c.rh * c.rww * 4;
      if (smem > 227 * 1024) continue;
      const long long tiles = (long long)ny * nx;
      const long long cost = (tiles + sms - 1) / sms * c.rh * c.rww;
      if (best < 0 || cost < best) {
        best = cost;
        out->args = c;
        out->grid = dim3(nx, ny);
        out->smem = smem;
        out->fast = fast;
      }
    }
  }
  return best >= 0;
}

// `outer` steps from in to out in launches of at most k2dSteps steps,
// through the scratch p between launches (the last launch writes out).
cudaError_t chain2d(const bf16* in, bf16* out, bf16* p, int H, int W,
                    int outer, int a1, int a2, int b1, int b2,
                    cudaStream_t stream) {
  if (outer == 0) {
    const cudaError_t err = cudaMemcpyAsync(
        out, in, (size_t)H * W * sizeof(bf16), cudaMemcpyDeviceToDevice,
        stream);
    return err;
  }
  const int m = k2dSteps;
  const int sms = sm_count();
  const int launches = (outer + m - 1) / m;
  const bf16* from = in;
  for (int i = 0; i < launches; ++i) {
    const int steps = i < launches - 1 ? m : outer - m * (launches - 1);
    Chain2dPlan plan;
    if (!chain2d_plan(H, W, steps, a1, a2, b1, b2, sms, &plan))
      return cudaErrorInvalidValue;
    auto kernel = plan.fast ? chain2d_fast_kernel : chain2d_kernel;
    cudaError_t err = lt::allow_smem(kernel, plan.smem);
    if (err != cudaSuccess) return err;
    bf16* to = (launches - 1 - i) % 2 == 0 ? out : p;
    kernel<<<plan.grid, dim3(k2dTx, k2dTy), plan.smem, stream>>>(from, to,
                                                                 plan.args);
    err = lt::filter_stage_launched();
    if (err != cudaSuccess) return err;
    from = to;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// out = the chain of `passes` passes of `body` over in, (H, W) of dtype
// code `dtype`.  boundary: 0 none (elementwise bodies), 1 circular (a roll
// by s1, s2 positions towards higher indices, each in [0, L)), 2 fill (a
// slice reading s1 positions ahead, `fill` past the end).  axis: 1 lanes
// (along a row), 0 sublanes (down a column); a line is at most 8192
// elements.  c1, c2: the body's constants, rounded to the dtype.
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
// a1, a2 and row shifts b1, b2 (each reduced to [0, W) or [0, H)), in
// launches of k2dSteps steps; the library's launch count
// (lt_filter_stage_launches) counts each.  p: (H, W) bf16 scratch between
// launches.  q and bar are unused (the signature of the earlier
// cooperative kernel).
int lt_shift_chain_2d(const void* in, void* out, void* p, void* q, void* bar,
                      int H, int W, int outer, int a1, int a2, int b1, int b2,
                      void* stream) {
  (void)q;
  (void)bar;
  if (H < 1 || W < 1 || outer < 0) return (int)cudaErrorInvalidValue;
  return (int)chain2d(static_cast<const bf16*>(in), static_cast<bf16*>(out),
                      static_cast<bf16*>(p), H, W, outer, a1, a2, b1, b2,
                      static_cast<cudaStream_t>(stream));
}

// The plans the two entries make on this card for an (H, W) block of
// elem-byte elements, their arguments as above.  body 0-8, a single-axis
// chain: out gets 7 int32, the mode (0 orbit order in one warp, 1 plain
// order across warps, 2 plain order in one warp), the lanes and warps a
// line spans, the packed lines a CTA holds, the CTAs, a CTA's shared bytes
// and the slots a lane holds.  body 9, lt_shift_chain_2d (s1, s2 the lane
// shifts a1, a2, s3, s4 the row shifts b1, b2, passes the outer steps):
// the kernel launches a call, then the first launch's tile rows and
// columns, region rows and 32-bit words a row, the region column of the
// tile's first output, the tiles, a CTA's shared bytes, whether it takes
// chain2d_fast_kernel and that kernel's register runs (words of a row,
// rows of a word column).
int lt_shift_chain_plan(int H, int W, int elem, int body, int boundary,
                        int axis, int s1, int s2, int s3, int s4, int passes,
                        void* out) {
  int* o = static_cast<int*>(out);
  if (H < 1 || W < 1 || passes < 1) return (int)cudaErrorInvalidValue;
  if (body == lt_chain::kMorphChain8) {
    Chain2dPlan plan;
    const int steps = passes < k2dSteps ? passes : k2dSteps;
    if (!chain2d_plan(H, W, steps, s1, s2, s3, s4, sm_count(), &plan))
      return (int)cudaErrorInvalidValue;
    const int v[] = {(passes + k2dSteps - 1) / k2dSteps, plan.args.th,
                     plan.args.tw, plan.args.rh, plan.args.rww,
                     plan.args.col0, (int)(plan.grid.x * plan.grid.y),
                     (int)plan.smem, plan.fast ? 1 : 0, k2dRunW, k2dRunH};
    memcpy(o, v, sizeof(v));
    return 0;
  }
  const int L = axis == 1 ? W : H;
  if (body < 0 || body > lt_chain::kMinMulMax || boundary < 1 ||
      boundary > 2 || (axis != 0 && axis != 1) || L > lt_chain::kMaxLine ||
      (elem != 1 && elem != 2 && elem != 4))
    return (int)cudaErrorInvalidValue;
  const lt_chain::LinePlan p = lt_chain::line_plan(
      body, boundary, axis, L, elem, s1, passes, axis == 1 ? H : W,
      sm_count());
  const int v[] = {p.mode, p.lanes, p.nw, 1 << p.pl_log, p.grid,
                   (int)p.smem, lt_chain::kRegs};
  memcpy(o, v, sizeof(v));
  return 0;
}

}  // extern "C"
