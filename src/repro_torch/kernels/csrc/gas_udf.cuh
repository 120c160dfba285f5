// Helpers of the scatter-UDF expressions that kernels/udf_codegen.py
// emits (GAS_SCATTER_EXPR): each computes what the torch op of the same
// name computes on float32 / int32 tensors (torch's vectorized CPU
// kernels where torch's own paths differ). The float arithmetic itself
// is __fadd_rn / __fsub_rn / __fmul_rn / __fdiv_rn, one rounding each.
//
// Device code under nvcc; a plain host C++ compiler takes the same
// definitions once the four CUDA intrinsics are defined as plain float
// operations (as the port's tests do, to hold the expression to torch).
#pragma once

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define GAS_UDF_FN __device__ __forceinline__
#else
#define GAS_UDF_FN inline
#endif

GAS_UDF_FN float gas_bits_float(uint32_t u) {
  float f;
  memcpy(&f, &u, sizeof f);
  return f;
}
GAS_UDF_FN float gas_inf() { return gas_bits_float(0x7f800000u); }
GAS_UDF_FN float gas_nan() { return gas_bits_float(0x7fc00000u); }

// a NaN operand gives NaN (torch.minimum), else a < b ? a : b
GAS_UDF_FN float gas_minimum(float a, float b) {
  return (a != a || b != b) ? __fadd_rn(a, b) : (a < b ? a : b);
}
GAS_UDF_FN float gas_maximum(float a, float b) {
  return (a != a || b != b) ? __fadd_rn(a, b) : (a > b ? a : b);
}
GAS_UDF_FN int gas_minimum(int a, int b) { return a < b ? a : b; }
GAS_UDF_FN int gas_maximum(int a, int b) { return a > b ? a : b; }

// torch.clamp(x, min=lo) / (x, max=hi): a NaN x stays NaN
GAS_UDF_FN float gas_clamp_min(float x, float lo) { return lo > x ? lo : x; }
GAS_UDF_FN float gas_clamp_max(float x, float hi) { return hi < x ? hi : x; }
GAS_UDF_FN int gas_clamp_min(int x, int lo) { return lo > x ? lo : x; }
GAS_UDF_FN int gas_clamp_max(int x, int hi) { return hi < x ? hi : x; }

GAS_UDF_FN float gas_abs(float x) {
  uint32_t u;
  memcpy(&u, &x, sizeof u);
  return gas_bits_float(u & 0x7fffffffu);
}

// int32 arithmetic wraps in two's complement, as torch's
GAS_UDF_FN int gas_iadd(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
GAS_UDF_FN int gas_isub(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}
GAS_UDF_FN int gas_imul(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}
GAS_UDF_FN int gas_abs(int x) { return x < 0 ? gas_isub(0, x) : x; }

// shifts by a count outside [0, 32): 0 for <<, the sign for >>
GAS_UDF_FN int gas_shl(int a, int b) {
  return (b < 0 || b >= 32)
             ? 0
             : static_cast<int>(static_cast<uint32_t>(a) << b);
}
GAS_UDF_FN int gas_shr(int a, int b) {
  return (b < 0 || b >= 32) ? (a >> 31) : (a >> b);
}
