// lt_shift_chain's uint8 and int8 cases (see shift_chain.cu and
// shift_chain.cuh): the (type, body, boundary, axis) cases that
// kernels/shift_chain.py's VARIANTS name for these types;
// tests/test_torch_mosaic_probes.py holds the CASE lists of all
// shift_chain*.cu sources to the table.

#include "shift_chain.cuh"

namespace lt_chain {

cudaError_t dispatch_8bit(const ChainArgs& a, int dtype, int body, int bound) {
  CASE(uint8_t, kAdd, kFill, 1)
  CASE(uint8_t, kMin, kCircular, 1)
  CASE(uint8_t, kMin, kCircular, 0)
  CASE(uint8_t, kMin, kFill, 1)
  CASE(uint8_t, kMin, kFill, 0)
  CASE(uint8_t, kMinadd, kNone, 1)
  CASE(int8_t, kMin, kCircular, 1)
  return cudaErrorInvalidValue;
}

}  // namespace lt_chain
