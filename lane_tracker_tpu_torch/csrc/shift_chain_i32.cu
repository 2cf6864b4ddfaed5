// lt_shift_chain's int32 and float32 cases (see shift_chain.cu and
// shift_chain.cuh): the (type, body, boundary, axis) cases that
// kernels/shift_chain.py's VARIANTS name for these types;
// tests/test_torch_mosaic_probes.py holds the CASE lists of all
// shift_chain*.cu sources to the table.

#include "shift_chain.cuh"

namespace lt_chain {

cudaError_t dispatch_32bit(const ChainArgs& a, int dtype, int body, int bound) {
  CASE(int32_t, kAdd, kCircular, 1)
  CASE(int32_t, kAdd, kCircular, 0)
  CASE(int32_t, kAdd, kFill, 1)
  CASE(int32_t, kAdd, kFill, 0)
  CASE(int32_t, kMin, kFill, 1)
  CASE(int32_t, kMin, kFill, 0)
  CASE(int32_t, kAddSelf, kNone, 1)
  CASE(int32_t, kAddshift, kNone, 1)
  CASE(int32_t, kPacked, kCircular, 1)
  CASE(float, kMin, kCircular, 1)
  CASE(float, kMin, kCircular, 0)
  CASE(float, kMin, kFill, 1)
  CASE(float, kMin, kFill, 0)
  return cudaErrorInvalidValue;
}

}  // namespace lt_chain
