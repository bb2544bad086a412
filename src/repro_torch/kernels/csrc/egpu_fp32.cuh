// eGPU datapath arithmetic on 32-bit words, shared by the kernels.
//
// Bit for bit the statements of kernels/ref.py: FP32 with denormals read
// and written as signed zeros (the reference's execution mode), the x86
// NaN rule (first NaN operand made quiet, else the default NaN
// 0xFFC00000), one rounding per ADD/SUB/MUL (the __f*_rn intrinsics are
// never contracted into an FMA), tininess detected after rounding (a MUL
// whose exact product lies below 2^-126 - 2^-151 is flushed where IEEE
// rounds it up to 2^-126), and a correctly rounded INVSQR.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace egpu {

constexpr uint32_t kDefaultNaN = 0xFFC00000u;
constexpr uint32_t kMinNormal = 0x00800000u;             // 2^-126
constexpr double kTinyProduct = 0x1.ffffffp-127;         // 2^-126 - 2^-151

__device__ __forceinline__ uint32_t flush(uint32_t x) {
  return (x & 0x7F800000u) ? x : (x & 0x80000000u);
}

__device__ __forceinline__ bool is_nan(uint32_t x) {
  return (x & 0x7FFFFFFFu) > 0x7F800000u;
}

__device__ __forceinline__ uint32_t nan_rule(uint32_t a, uint32_t b,
                                             uint32_t r) {
  if (is_nan(a)) return a | 0x00400000u;
  if (is_nan(b)) return b | 0x00400000u;
  if (is_nan(r)) return kDefaultNaN;
  return r;
}

// op: 1 = ADD, 2 = SUB, anything else = MUL
__device__ __forceinline__ uint32_t fp_binop(int op, uint32_t a, uint32_t b) {
  a = flush(a);
  b = flush(b);
  const float fa = __uint_as_float(a), fb = __uint_as_float(b);
  const float r = op == 1 ? __fadd_rn(fa, fb)
                : op == 2 ? __fsub_rn(fa, fb) : __fmul_rn(fa, fb);
  uint32_t w = __float_as_uint(r);
  // x86 detects tininess after rounding; the product of two float32
  // values is exact in float64
  if (op != 1 && op != 2 && (w & 0x7FFFFFFFu) == kMinNormal &&
      fabs(__dmul_rn(static_cast<double>(fa), static_cast<double>(fb)))
          < kTinyProduct)
    w &= 0x80000000u;
  return nan_rule(a, b, flush(w));
}

__device__ __forceinline__ uint32_t fp_add(uint32_t a, uint32_t b) {
  return fp_binop(1, a, b);
}

__device__ __forceinline__ uint32_t sext16(uint32_t x) {
  return static_cast<uint32_t>(static_cast<int32_t>(static_cast<int16_t>(x & 0xFFFFu)));
}

// eGPU SIMT ALU (ops 1..9; typ 0 INT32, 1 UINT32, 2 FP32)
__device__ __forceinline__ uint32_t alu(int op, int typ, uint32_t a,
                                        uint32_t b) {
  if (typ == 2 && op >= 1 && op <= 3) return fp_binop(op, a, b);
  switch (op) {
    case 1: return a + b;
    case 2: return a - b;
    case 3: return typ == 1 ? (a & 0xFFFFu) * (b & 0xFFFFu)
                            : sext16(a) * sext16(b);
    case 4: return a & b;
    case 5: return a | b;
    case 6: return a ^ b;
    case 7: return ~a;
    case 8: return a << (b & 31u);
    default: return a >> (b & 31u);        // logical shift right
  }
}

// SETP: cond 0 EQ, 1 NE, 2 LT, 3 LE, 4 GT, anything else GE
__device__ __forceinline__ bool setp(int cond, int typ, uint32_t a,
                                     uint32_t b) {
  bool eq, lt, le, gt, ge;
  if (typ == 2) {
    const float x = __uint_as_float(flush(a)), y = __uint_as_float(flush(b));
    eq = x == y; lt = x < y; le = x <= y; gt = x > y; ge = x >= y;
  } else if (typ == 0) {
    const int32_t x = static_cast<int32_t>(a), y = static_cast<int32_t>(b);
    eq = x == y; lt = x < y; le = x <= y; gt = x > y; ge = x >= y;
  } else {
    eq = a == b; lt = a < b; le = a <= b; gt = a > b; ge = a >= b;
  }
  switch (cond) {
    case 0: return eq;
    case 1: return !eq;
    case 2: return lt;
    case 3: return le;
    case 4: return gt;
    default: return ge;
  }
}

// Sign of x*m*m - 1, exact in float64 (x a float32 value, m a 25-bit
// midpoint of two float32 neighbours): negative means 1/sqrt(x) > m.
__device__ __forceinline__ double rsqrt_vs(double x, double m) {
  const double p = __dmul_rn(x, m);                   // exact: 24 + 25 bits
  const double c = __dmul_rn(p, 134217729.0);         // Veltkamp split
  const double ph = __dsub_rn(c, __dsub_rn(c, p));
  const double pl = __dsub_rn(p, ph);
  return __dadd_rn(__dsub_rn(__dmul_rn(ph, m), 1.0), __dmul_rn(pl, m));
}

// INVSQR: correctly rounded 1/sqrt(x). __frsqrt_rn gives the estimate and
// the exact midpoint test makes the rounding independent of its error.
__device__ __forceinline__ uint32_t invsqr(uint32_t x) {
  x = flush(x);
  if (is_nan(x)) return x | 0x00400000u;
  if ((x & 0x7FFFFFFFu) == 0u) return (x & 0x80000000u) | 0x7F800000u;
  if (x & 0x80000000u) return kDefaultNaN;
  if (x == 0x7F800000u) return 0u;
  const double xd = static_cast<double>(__uint_as_float(x));
  float y = __frsqrt_rn(__uint_as_float(x));
  const float up = nextafterf(y, __uint_as_float(0x7F800000u));
  const float dn = nextafterf(y, 0.0f);
  const double yd = y;
  if (rsqrt_vs(xd, 0.5 * (yd + static_cast<double>(up))) < 0.0) {
    y = up;
  } else if (rsqrt_vs(xd, 0.5 * (static_cast<double>(dn) + yd)) > 0.0) {
    y = dn;
  }
  return __float_as_uint(y);
}

}  // namespace egpu
