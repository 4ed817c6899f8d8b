// The semiring's (x) for the kernels that take it as an op code (K4 scatter
// and K4p scatter in planar_spmv.cu; K1, K4 fused and their predicated
// forms in router_spmv.cu), numbered as the wrappers pass it
// (semiring.OpType): one definition of each product, above all of the
// tropical engine's exact int32 encoding.
#pragma once

#include <type_traits>

#include <cuda_runtime.h>

namespace glt {

enum class Op { kMulAdd = 0, kAndOr = 1, kAddMin = 2 };

constexpr float kFloatInf = 999999999.0f;     // semiring.FLOAT_INF (1e9f)
constexpr int kInfBits = 0x4E6E6B28;          // its bits, semiring.INF_BITS

// What a product is kept as: float, or the int32 encoding for ADDMIN.
template <Op kOp>
using Stored = typename std::conditional<kOp == Op::kAddMin, int,
                                         float>::type;

// ADDMIN's product is stored as the exact int32 encoding of
// router_pallas.py:_tropical_encode (semiring.tropical_encode),
// E = INF_BITS - bits(min(v + x, FLOAT_INF)), order-reversing on
// non-negative floats with E(FLOAT_INF) = 0, the identity of max. A
// negative sum's bits are taken as unsigned and the difference wraps as
// torch's int32 subtraction does, so the kernels and the plain versions
// agree bit for bit on any input.
template <Op kOp>
__device__ __forceinline__ Stored<kOp> product(float v, float xv) {
  if constexpr (kOp == Op::kAndOr) {
    return (v != 0.f && xv != 0.f) ? 1.f : 0.f;
  } else if constexpr (kOp == Op::kAddMin) {
    // one rounding, as XLA's add; no fast-math anywhere in the build
    const float p = fminf(__fadd_rn(v, xv), kFloatInf);
    return static_cast<int>(static_cast<unsigned>(kInfBits)
                            - __float_as_uint(p));
  } else {
    return __fmul_rn(v, xv);   // one rounding, never fused with an add
  }
}

}  // namespace glt
