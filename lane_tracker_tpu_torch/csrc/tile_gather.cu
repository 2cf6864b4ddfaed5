// Hand-written Hopper (sm_90a) kernel for the in-tile gather probe: a chain
// of `reps` tile-local gathers over an (H, W) int32 array cut into (8, 128)
// tiles, in one launch.
//
// It replaces the Pallas TPU kernel of scripts/mosaic_probe11.py, `timed`'s
// `call` (:44/:49, pallas_call at :50), which asks what a dynamic gather
// inside one (8, 128) vreg costs.  For every tile, with prev = 0 at the
// start, `reps` times
//   prev = op(s + prev, li, si) & 0x7F
// where op is, at tile-local row r and column c:
//   B0  v[r, c]                       (the plain add)
//   G1  v[r, li[r, c]]                (lane gather, li < 128)
//   G2  v[si[r, c], c]                (sublane gather, si < 8)
//   G3  G2 of G1: v[si[r, c], li[si[r, c], c]]
// Indices are read modulo the tile (li & 127, si & 7), so no index reads
// outside its tile.  Integer and bit-exact: the add wraps as int32.
//
// Plain C interface, loaded with ctypes: the entry launches on the stream it
// is given, allocates nothing and returns cudaGetLastError().
//
// What bounds it on the H100: one read of s, li and si and one write of the
// output (2.6 MB at (128, 1280), under a microsecond) against the gathers.
// Each rep depends on the one before, and the probe's 160 tiles are about
// one a streaming multiprocessor, so a call is bound by the latency of one
// rep of one tile, not by the card's throughput.  The first design (the
// TPU's layout: one 256-thread CTA a tile, v staged in shared memory, a
// CTA barrier on each side of every gather, two more for G3) paid a store,
// a barrier, a shared load at a random address and a second barrier a rep.
// This design:
//
// * Bytes.  Only the low 7 bits of a gathered value reach the output, and
//   (s + prev) & 0x7F == ((s & 0x7F) + prev) & 0x7F, so s & 0x7F is formed
//   once, before the loop, and a rep works on four elements a 32-bit word:
//   v = (s7 + prev) & 0x7F7F7F7F (no byte carries into the next: both
//   bytes are below 128).  Every rep still gathers every element with that
//   rep's values; no index map is composed across reps and no gather leaves
//   the loop.
// * B0 and G2: a thread holds one column of a tile, its 8 rows in two words
//   (rows 0-3, rows 4-7).  The sublane gather of four rows is then one
//   __byte_perm of the two words, its selector the four si's nibbles,
//   formed before the loop.  A warp a 32-column strip of a tile: 640
//   one-warp CTAs at the probe's size, no barrier, no shared memory.
// * G1: a warp holds one row of a tile, lane l the columns l, l + 32,
//   l + 64 and l + 96 as the four bytes of one word.  v[r, li] is byte
//   li >> 5 of lane (li & 31)'s word: four __shfl_sync a word, and three
//   __byte_perm put the four bytes in place.  1280 one-warp CTAs, about ten
//   warps an SM, no barrier, no shared memory.
// * G3: G1 needs a whole row in a warp and G2 a whole column, so a tile
//   held in one warp would need no barrier; but then one warp issues the
//   tile's 32 shuffles and about 65 integer instructions (adds, masks, the
//   gathers' __byte_perm and a byte transpose back to rows) a lane and rep,
//   at a sub-partition's 16 integer lanes a clock: 118 ns a rep in
//   probes/filter_redesign.py's study, against the first design's 208.
//   So G3 takes a CTA of 8 warps a tile, G1's layout a row a warp, and one
//   CTA barrier a rep between the lane gather and the sublane gather
//   (tile_chain): the 8 warps issue on all four sub-partitions.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 8;
constexpr int kTileW = 128;
constexpr int kWarp = 32;
constexpr int kSlots = kTileW / kWarp;  // columns of a row a lane holds
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr unsigned kLow7 = 0x7F7F7F7Fu;
enum Op { kB0 = 0, kG1 = 1, kG2 = 2, kG3 = 3 };

// Byte j of `word` as an int.
__device__ __forceinline__ int byte_of(unsigned word, int j) {
  return (int)((word >> (8 * j)) & 0xFFu);
}

// Four gathered bytes in place: byte (a & 3) of x0, (a >> 4 & 3) of x1,
// (b & 3) of x2, (b >> 4 & 3) of x3, with a = byte0 | (4 + byte1) << 4 as
// the selectors `pair_sel` forms.
__device__ __forceinline__ unsigned gather4(unsigned x0, unsigned x1,
                                            unsigned x2, unsigned x3,
                                            unsigned a, unsigned b) {
  return __byte_perm(__byte_perm(x0, x1, a), __byte_perm(x2, x3, b), 0x5410);
}

// __byte_perm selector taking byte b0 of its first word and b1 of its
// second into bytes 0 and 1.
__device__ __forceinline__ unsigned pair_sel(int b0, int b1) {
  return (unsigned)b0 | (unsigned)(4 + b1) << 4;
}

// B0 and G2.  Grid (W / 32, H / 8), one warp a CTA: thread x of strip
// blockIdx.x holds column 32 blockIdx.x + x of the tile rows
// [8 blockIdx.y, 8 blockIdx.y + 8), rows 0-3 in lo, 4-7 in hi.
template <int kOp>
__device__ __forceinline__ void column_chain(
    const int* __restrict__ src, const int* __restrict__ si,
    int* __restrict__ out, int W, int reps) {
  const size_t col = (size_t)blockIdx.x * kWarp + threadIdx.x;
  const size_t row0 = (size_t)blockIdx.y * kTileH;
  unsigned s[2] = {0, 0}, sel[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < kTileH; ++r) {
    const size_t g = (row0 + r) * W + col;
    s[r >> 2] |= (unsigned)(src[g] & 0x7F) << (8 * (r & 3));
    if constexpr (kOp == kG2)
      sel[r >> 2] |= (unsigned)(si[g] & (kTileH - 1)) << (4 * (r & 3));
  }
  unsigned p[2] = {0, 0};
  for (int rep = 0; rep < reps; ++rep) {
    const unsigned lo = (s[0] + p[0]) & kLow7;
    const unsigned hi = (s[1] + p[1]) & kLow7;
    if constexpr (kOp == kG2) {
      p[0] = __byte_perm(lo, hi, sel[0]);
      p[1] = __byte_perm(lo, hi, sel[1]);
    } else {
      p[0] = lo;
      p[1] = hi;
    }
  }
#pragma unroll
  for (int r = 0; r < kTileH; ++r)
    out[(row0 + r) * W + col] = byte_of(p[r >> 2], r & 3);
}

// A row of a tile in G1's layout, lane l's columns l + 32 j as byte j:
// its s & 0x7F and its lane gather's source lanes and byte selectors.
struct Row {
  unsigned s7, a, b;
  int from[kSlots];
};

// The row whose lane l's first column is element `base`.
__device__ __forceinline__ Row load_row(const int* __restrict__ src,
                                        const int* __restrict__ li,
                                        size_t base) {
  Row row;
  row.s7 = 0;
  int pick[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const size_t g = base + kWarp * j;
    row.s7 |= (unsigned)(src[g] & 0x7F) << (8 * j);
    const int c = li[g] & (kTileW - 1);
    row.from[j] = c & (kWarp - 1);
    pick[j] = c >> 5;
  }
  row.a = pair_sel(pick[0], pick[1]);
  row.b = pair_sel(pick[2], pick[3]);
  return row;
}

// One rep's lane gather of the row: v[r, li] of v = (s7 + p) & 0x7F, four
// shuffles and three __byte_perm.
__device__ __forceinline__ unsigned lane_gather(const Row& row, unsigned p) {
  const unsigned v = (row.s7 + p) & kLow7;
  return gather4(__shfl_sync(kFull, v, row.from[0]),
                 __shfl_sync(kFull, v, row.from[1]),
                 __shfl_sync(kFull, v, row.from[2]),
                 __shfl_sync(kFull, v, row.from[3]), row.a, row.b);
}

// G1.  Grid (H, W / 128), one warp a CTA: the warp holds row blockIdx.x of
// tile column blockIdx.y.
__device__ __forceinline__ void row_chain(
    const int* __restrict__ src, const int* __restrict__ li,
    int* __restrict__ out, int W, int reps) {
  const size_t base = (size_t)blockIdx.x * W + (size_t)blockIdx.y * kTileW
                      + threadIdx.x;
  const Row row = load_row(src, li, base);
  unsigned p = 0;
  for (int rep = 0; rep < reps; ++rep) p = lane_gather(row, p);
#pragma unroll
  for (int j = 0; j < kSlots; ++j) out[base + kWarp * j] = byte_of(p, j);
}

// G3.  Grid (W / 128, H / 8), kTileH warps a CTA: warp r holds row r of
// the tile of rows [8 blockIdx.y, +8) and columns [128 blockIdx.x, +128)
// and gathers it as G1 does; the rows go to a shared copy, byte
// 4 (32 r + l) + j holding column l + 32 j of row r, so that lane l's
// columns all sit in bank l; one CTA barrier; then G2 reads byte
// (si, its column) of that copy, with no bank conflict.  Two copies, a rep
// in each: a warp writes a copy again only after the next rep's barrier,
// which every warp reaches after its reads of the copy.
__device__ __forceinline__ void tile_chain(
    const int* __restrict__ src, const int* __restrict__ li,
    const int* __restrict__ si, int* __restrict__ out, int W, int reps) {
  __shared__ unsigned rows[2][kTileH * kWarp];
  const int lane = threadIdx.x % kWarp;
  const int r = threadIdx.x / kWarp;
  const size_t base = ((size_t)blockIdx.y * kTileH + r) * W
                      + (size_t)blockIdx.x * kTileW + lane;
  const Row row = load_row(src, li, base);
  int at[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j)
    at[j] = ((si[base + kWarp * j] & (kTileH - 1)) * kWarp + lane) * 4 + j;
  unsigned p = 0;
  // Not unrolled: the loop's one barrier is one BAR.SYNC in the SASS.
#pragma unroll 1
  for (int rep = 0; rep < reps; ++rep) {
    unsigned* copy = rows[rep & 1];
    copy[r * kWarp + lane] = lane_gather(row, p);
    __syncthreads();
    const unsigned char* bytes = reinterpret_cast<const unsigned char*>(copy);
    p = (unsigned)bytes[at[0]] | (unsigned)bytes[at[1]] << 8
        | (unsigned)bytes[at[2]] << 16 | (unsigned)bytes[at[3]] << 24;
  }
#pragma unroll
  for (int j = 0; j < kSlots; ++j) out[base + kWarp * j] = byte_of(p, j);
}

// One instance an op, so that each op's SASS stands apart.
template <int kOp>
__global__ void __launch_bounds__(kOp == kG3 ? kTileH * kWarp : kWarp)
    tile_gather_kernel(const int* __restrict__ src, const int* __restrict__ li,
                       const int* __restrict__ si, int* __restrict__ out,
                       int W, int reps) {
  if constexpr (kOp == kB0 || kOp == kG2)
    column_chain<kOp>(src, si, out, W, reps);
  else if constexpr (kOp == kG1)
    row_chain(src, li, out, W, reps);
  else
    tile_chain(src, li, si, out, W, reps);
}

}  // namespace

extern "C" {

// out (H, W) int32 = the chain of `reps` reps of op (0 B0, 1 G1, 2 G2,
// 3 G3) over src, with the tile-local indices li and si, all (H, W) int32;
// H a multiple of 8, W of 128.
int lt_tile_gather(const void* src, const void* li, const void* si,
                   void* out, int H, int W, int op, int reps, void* stream) {
  if (H < kTileH || H % kTileH || W < kTileW || W % kTileW || reps < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* s = static_cast<const int*>(src);
  const int* l = static_cast<const int*>(li);
  const int* r = static_cast<const int*>(si);
  int* o = static_cast<int*>(out);
  switch (op) {
    case kB0:
      tile_gather_kernel<kB0><<<dim3(W / kWarp, H / kTileH), kWarp, 0, st>>>(
          s, l, r, o, W, reps);
      break;
    case kG1:
      tile_gather_kernel<kG1><<<dim3(H, W / kTileW), kWarp, 0, st>>>(
          s, l, r, o, W, reps);
      break;
    case kG2:
      tile_gather_kernel<kG2><<<dim3(W / kWarp, H / kTileH), kWarp, 0, st>>>(
          s, l, r, o, W, reps);
      break;
    case kG3:
      tile_gather_kernel<kG3>
          <<<dim3(W / kTileW, H / kTileH), kTileH * kWarp, 0, st>>>(
              s, l, r, o, W, reps);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
