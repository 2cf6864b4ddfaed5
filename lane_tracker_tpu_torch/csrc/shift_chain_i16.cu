// lt_shift_chain's int16 cases (see shift_chain.cu and
// shift_chain.cuh): the (type, body, boundary, axis) cases that
// kernels/shift_chain.py's VARIANTS name for these types;
// tests/test_torch_mosaic_probes.py holds the CASE lists of all
// shift_chain*.cu sources to the table.

#include "shift_chain.cuh"

namespace lt_chain {

cudaError_t dispatch_i16(const ChainArgs& a, int dtype, int body, int bound) {
  CASE(int16_t, kAdd, kCircular, 1)
  CASE(int16_t, kAdd, kCircular, 0)
  CASE(int16_t, kAdd, kFill, 1)
  CASE(int16_t, kAdd, kFill, 0)
  CASE(int16_t, kMin, kCircular, 1)
  CASE(int16_t, kMin, kFill, 1)
  CASE(int16_t, kMin, kFill, 0)
  CASE(int16_t, kAddSelf, kNone, 1)
  CASE(int16_t, kMinadd, kNone, 1)
  CASE(int16_t, kWhereAdd, kNone, 1)
  return cudaErrorInvalidValue;
}

}  // namespace lt_chain
