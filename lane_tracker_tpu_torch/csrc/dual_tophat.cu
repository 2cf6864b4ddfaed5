// The dual tophat on Hopper (sm_90a): two independent white tophats of one
// frame shape in one launch.
//
// It replaces build_dual's run of scripts/mosaic_probe10.py (k=29 on R and
// k=55 on LAB-B in one kernel), which asks whether two tophats gain from
// sharing a kernel; the tracker does not run it.  Each output is bit-exact
// with tophat_ellipse's plain twin in
// lane_tracker_tpu_torch/kernels/filter_stage.py, and with lt_tophat's.
//
// The tile is lt_tophat's (tophat_tile, tophat.cuh; the design notes are
// tophat_kernel's, in filter_stage.cu), at the plan lt_tophat takes for
// each k.  A source of its own so that nvcc builds it beside filter_stage.cu
// and tophat_staged.cu, not after them.  Plain C interface, loaded with
// ctypes; its launches count in filter_stage.cu's lt_filter_stage_launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "tophat.cuh"

namespace {

using lt::aligned;
using lt::allow_smem;
using lt::filter_stage_launched;
using lt::kTopMaxQuads;
using lt::kTopSmemTwo;
using lt::kTopThreads;
using lt::load_runs;
using lt::SeRuns;
using lt::tophat_plan;
using lt::tophat_smem;
using lt::tophat_tile;
using lt::TophatPlan;
using lt::U8Lanes;

// A 1-D grid lists the tiles of both problems, each at its own plan (the
// tiles lt_tophat takes for its k): problem 0's first, then problem 1's.
// The host puts the heavier problem (the larger k) first, so the light
// tiles fill the tail.  Each CTA decodes its (problem, frame, tile row,
// tile column) from blockIdx.x and runs tophat_kernel's tile; the dynamic
// shared memory is the larger plan's.  The tile is inlined once per
// problem, so each reads its plan from the kernel's parameters.
__device__ __forceinline__ void tile_of(unsigned t, const TophatPlan& p,
                                        int H, int W, unsigned* bx,
                                        unsigned* by, unsigned* z) {
  const unsigned gx = (W + 16 * p.tq - 1) / (16 * p.tq);
  const unsigned per = gx * ((H + p.th - 1) / p.th);
  *z = t / per;
  t -= *z * per;
  *by = t / gx;
  *bx = t - *by * gx;
}

// Grid: (n0 + problem 1's tiles); kTopThreads threads.
__global__ void __launch_bounds__(kTopThreads, 2)
    dual_tophat_kernel(const uint8_t* __restrict__ in0,
                       uint8_t* __restrict__ out0, bool vec0, TophatPlan p0,
                       int n0, const uint8_t* __restrict__ in1,
                       uint8_t* __restrict__ out1, bool vec1, TophatPlan p1,
                       int H, int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned bx, by, z;
  if (blockIdx.x < (unsigned)n0) {
    tile_of(blockIdx.x, p0, H, W, &bx, &by, &z);
    tophat_tile<U8Lanes, kTopMaxQuads>(in0, out0, H, W, vec0, p0, bx, by, z,
                                       smem_raw);
  } else {
    tile_of(blockIdx.x - n0, p1, H, W, &bx, &by, &z);
    tophat_tile<U8Lanes, kTopMaxQuads>(in1, out1, H, W, vec1, p1, bx, by, z,
                                       smem_raw);
  }
}

// Two tophats of one frame shape in one launch of dual_tophat_kernel, the
// larger k's tiles first.
cudaError_t launch_dual(const uint8_t* a, const uint8_t* b, uint8_t* out_a,
                        uint8_t* out_b, const SeRuns& se_a,
                        const SeRuns& se_b, int ka, int kb, int T, int H,
                        int W, cudaStream_t s) {
  TophatPlan pa, pb;
  int shape;
  if (tophat_plan(se_a, ka, 1, H, W, &pa, &shape) != 0 ||
      tophat_plan(se_b, kb, 1, H, W, &pb, &shape) != 0)
    return cudaErrorInvalidValue;
  const size_t sa = tophat_smem(pa.tq, pa.th, pa.r, pa.rq);
  const size_t sb = tophat_smem(pb.tq, pb.th, pb.r, pb.rq);
  if (sa > kTopSmemTwo || sb > kTopSmemTwo) return cudaErrorInvalidValue;
  const size_t smem = sa > sb ? sa : sb;
  cudaError_t err = allow_smem(dual_tophat_kernel, smem);
  if (err != cudaSuccess) return err;
  auto tiles = [&](const TophatPlan& p) {
    return (long long)T * ((H + p.th - 1) / p.th) *
           ((W + 16 * p.tq - 1) / (16 * p.tq));
  };
  const long long na = tiles(pa), nb = tiles(pb);
  if (na + nb > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool va = aligned(a, out_a, W), vb = aligned(b, out_b, W);
  if (kb > ka)
    dual_tophat_kernel<<<(unsigned)(na + nb), kTopThreads, smem, s>>>(
        b, out_b, vb, pb, (int)nb, a, out_a, va, pa, H, W);
  else
    dual_tophat_kernel<<<(unsigned)(na + nb), kTopThreads, smem, s>>>(
        a, out_a, va, pa, (int)na, b, out_b, vb, pb, H, W);
  return filter_stage_launched();
}

}  // namespace

extern "C" {

// Two tophats of one frame shape, a with ka and b with kb, in one launch.
// scratch_a and scratch_b are not used; the arguments keep the entry's
// interface.
int lt_dual_tophat(const void* a, const void* b, void* out_a, void* out_b,
                   void* scratch_a, void* scratch_b, const void* runs_a,
                   int n_runs_a, int ka, const void* runs_b, int n_runs_b,
                   int kb, int T, int H, int W, void* stream) {
  (void)scratch_a;
  (void)scratch_b;
  SeRuns se_a, se_b;
  if (load_runs(static_cast<const int*>(runs_a), n_runs_a, &se_a) != 0 ||
      load_runs(static_cast<const int*>(runs_b), n_runs_b, &se_b) != 0 ||
      ka < 1 || kb < 1 || T < 1 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  return (int)launch_dual(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
      static_cast<uint8_t*>(out_a), static_cast<uint8_t*>(out_b), se_a, se_b,
      ka, kb, T, H, W, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
