// The LOG2 activation code of one float32 (QeiHaN paper Eqs. 2-4, Fig. 5
// comparator): one definition for the standalone quantizer
// (log2quant/csrc/log2quant.cu) and the GEMM that quantizes in its
// prologue (bitplane_matmul/csrc/bitplane_matmul.cu).
//   exp  = IEEE exponent field - 127 + (mantissa field >= 3474676), clipped
//          to [sentinel, emax]; exponent field 0 (zero, subnormal) and NaN
//          -> the sentinel; +-Inf -> emax
//   sign = -1 iff x < 0 (so -0.0 and NaN give +1)
#pragma once

#include <stdint.h>

namespace qh {

constexpr int kSqrt2Mantissa = 3474676;  // first f32 mantissa >= sqrt(2)

__device__ __forceinline__ void log2_code(uint32_t bits, int sentinel,
                                          int emax, int& e_out, int& s_out) {
  const int exp_field = (bits >> 23) & 0xFF;
  const int man_field = bits & 0x7FFFFF;
  const bool is_nan = exp_field == 0xFF && man_field != 0;
  int e = exp_field - 127 + (man_field >= kSqrt2Mantissa ? 1 : 0);
  e = min(max(e, sentinel), emax);
  if (exp_field == 0 || is_nan) {
    e = sentinel;
  } else if (exp_field == 0xFF) {
    e = emax;
  }
  // x < 0 in IEEE terms: sign bit set, not NaN, not -0.0
  const bool negative = (bits >> 31) != 0 && !is_nan &&
                        (bits & 0x7FFFFFFFu) != 0;
  e_out = e;
  s_out = negative ? -1 : 1;
}

}  // namespace qh
