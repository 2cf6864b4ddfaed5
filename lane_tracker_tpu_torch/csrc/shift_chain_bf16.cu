// lt_shift_chain's bfloat16 cases (see shift_chain.cu and
// shift_chain.cuh): the (type, body, boundary, axis) cases that
// kernels/shift_chain.py's VARIANTS name for these types;
// tests/test_torch_mosaic_probes.py holds the CASE lists of all
// shift_chain*.cu sources to the table.

#include "shift_chain.cuh"

namespace lt_chain {

cudaError_t dispatch_bf16(const ChainArgs& a, int dtype, int body, int bound) {
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
  return cudaErrorInvalidValue;
}

}  // namespace lt_chain
