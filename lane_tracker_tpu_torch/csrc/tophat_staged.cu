// The staged tophat on Hopper (sm_90a): lt_tophat's tile with its planes
// in bf16 or f32 instead of uint8.
//
// It replaces tophat_bf16 of scripts/mosaic_probe5.py (the tophat with bf16
// or f32 compute scratch), which asks whether a wider staging type pays;
// the tracker does not run it.  Pixels 0..255 are exact in both types, so
// the output is the u8 tophat, bit-exact with tophat_ellipse's plain twin
// in lane_tracker_tpu_torch/kernels/filter_stage.py.
//
// The tile is tophat_tile (tophat.cuh), as lt_tophat's (filter_stage.cu,
// where the design notes are).  The staged input, the widening buffers and
// the eroded region hold each pixel's bf16 or f32 bit pattern, 8 or 4
// pixels a quad: converted as the tile is staged (one 8- or 4-byte load a
// quad), back to u8 in the epilogue.  Min/max are one DPX instruction a
// word on the patterns (the lane formats in tophat.cuh), shifts of whole
// words need no funnel shift.  What the wider lanes cost: 2 or 4 shared
// bytes a staged pixel where u8 takes 1, and the tiles that fit 110 KB are
// smaller, so the host (tophat_plan) also weighs one CTA an SM.
//
// A source of its own so that nvcc builds its four instantiations beside
// filter_stage.cu's kernels, not after them.  Plain C interface, loaded
// with ctypes; its launches count in filter_stage.cu's
// lt_filter_stage_launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "tophat.cuh"

namespace {

using lt::aligned;
using lt::allow_smem;
using lt::Bf16Lanes;
using lt::F32Lanes;
using lt::filter_stage_launched;
using lt::kTopShapes;
using lt::kTopThreads;
using lt::load_runs;
using lt::plane_guard;
using lt::SeRuns;
using lt::tophat_plan;
using lt::tophat_smem;
using lt::tophat_tile;
using lt::TophatPlan;

// Grid: (ceil(W / P tq), ceil(H / th), T), P = 16 / L::kBytes pixels a
// quad; kTopThreads threads, NQ accumulator quads a thread, MINB CTAs an
// SM.
template <class L, int NQ, int MINB>
__global__ void __launch_bounds__(kTopThreads, MINB)
    staged_tophat_kernel(const uint8_t* __restrict__ in,
                         uint8_t* __restrict__ out, int H, int W, bool vec,
                         TophatPlan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  tophat_tile<L, NQ>(in, out, H, W, vec, p, blockIdx.x, blockIdx.y,
                     blockIdx.z, smem_raw);
}

template <class L, int NQ, int MINB>
cudaError_t launch_staged_shape(const uint8_t* in, uint8_t* out,
                                const TophatPlan& p, int T, int H, int W,
                                size_t smem, cudaStream_t s) {
  cudaError_t err = allow_smem(staged_tophat_kernel<L, NQ, MINB>, smem);
  if (err != cudaSuccess) return err;
  const int tw = 16 / L::kBytes * p.tq;
  const dim3 grid((W + tw - 1) / tw, (H + p.th - 1) / p.th, T);
  staged_tophat_kernel<L, NQ, MINB><<<grid, kTopThreads, smem, s>>>(
      in, out, H, W, aligned(in, out, W, 16 / L::kBytes), p);
  return filter_stage_launched();
}

// img - open(img) with the planes in L's lanes: one launch of
// staged_tophat_kernel in the planned shape.
template <class L>
cudaError_t launch_staged(const uint8_t* in, uint8_t* out, const SeRuns& se,
                          int ksize, int T, int H, int W, cudaStream_t s) {
  TophatPlan p;
  int shape;
  if (tophat_plan(se, ksize, L::kBytes, H, W, &p, &shape) != 0)
    return cudaErrorInvalidValue;
  const size_t smem =
      tophat_smem(p.tq, p.th, p.r, p.rq, plane_guard(L::kBytes));
  if (shape == 0)
    return launch_staged_shape<L, kTopShapes[0].quads, 2>(in, out, p, T, H, W,
                                                          smem, s);
  return launch_staged_shape<L, kTopShapes[1].quads, 1>(in, out, p, T, H, W,
                                                        smem, s);
}

}  // namespace

extern "C" {

// lt_tophat with its planes in another type than uint8: stage 1 bf16, 2
// f32 (DPX min/max on the bit patterns).  One launch.  scratch is not
// used; the argument keeps the entry's interface.
int lt_tophat_staged(const void* img, void* out, void* scratch,
                     const void* runs, int n_runs, int ksize, int T, int H,
                     int W, int stage, void* stream) {
  (void)scratch;
  SeRuns se;
  if (load_runs(static_cast<const int*>(runs), n_runs, &se) != 0 ||
      ksize < 1 || T < 1 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* x = static_cast<const uint8_t*>(img);
  uint8_t* o = static_cast<uint8_t*>(out);
  switch (stage) {
    case 1: return (int)launch_staged<Bf16Lanes>(x, o, se, ksize, T, H, W, s);
    case 2: return (int)launch_staged<F32Lanes>(x, o, se, ksize, T, H, W, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
